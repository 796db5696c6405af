"""Columnar chunks: the unit of table data, as torch planes on a device.

Port of the JAX package's `chunks/columnar.py` (`next_pow2`, `pad_capacity`,
`Column`, `ColumnarChunk`, `from_rows`, `from_arrays`, `to_rows`):

  * A chunk is a struct-of-arrays: one fixed-width plane per column plus a
    validity plane, padded to a static capacity (a power of two times 128).
    `row_count` may be smaller than capacity; rows beyond it are masked out
    by `row_valid`.
  * Strings are order-preserving dictionary-encoded per chunk: the plane
    holds int32 ranks into a host-side sorted vocabulary, so comparisons,
    grouping and sorting on strings are integer work on the device.
  * uint64 planes hold int64 bit patterns (see schema.py).

Left out of this slice: the invariants hook, hunks, stats and sketches,
`concat_chunks`, `any` and vector columns.

`chunk_from_numpy` / `ColumnarChunk.to_numpy` carry a chunk across as plain
numpy arrays, so a caller can hand the port the exact bytes another
implementation computed over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.schema import EValueType, TableSchema, device_dtype

LANE = 128  # capacities are multiples of this


def next_pow2(n: int, floor: int = 1) -> int:
    """Smallest power-of-two multiple of `floor` that is >= n (floor itself
    for n <= floor)."""
    cap = max(floor, 1)
    while cap < n:
        cap *= 2
    return cap


def pad_capacity(n: int) -> int:
    """Round a row count up to its static capacity bucket."""
    return next_pow2(n, floor=LANE)


def _np_plane_dtype(ty: EValueType) -> np.dtype:
    """Host dtype of a plane as it crosses to torch (uint64 as int64)."""
    return np.dtype({torch.int64: np.int64, torch.float64: np.float64,
                     torch.bool: np.bool_, torch.int32: np.int32,
                     torch.int8: np.int8}[device_dtype(ty)])


def _encode_strings(values: Sequence[Optional[bytes]]
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Order-preserving dictionary encode. Returns (codes, valid, vocab)."""
    valid = np.array([v is not None for v in values], dtype=bool)
    if not valid.any():
        return (np.zeros(len(values), dtype=np.int32), valid,
                np.array([], dtype=object))
    packed = np.empty(len(values), dtype=object)
    packed[:] = [v if v is not None else b"" for v in values]
    vocab, codes = np.unique(packed, return_inverse=True)
    codes = codes.astype(np.int32)
    # b"" padding for nulls may introduce a phantom vocab entry; keep it
    # only if a valid row actually holds the empty string.
    if len(vocab) and vocab[0] == b"" and not (valid & (codes == 0)).any():
        vocab = vocab[1:]
        codes = np.maximum(codes - 1, 0)
    return codes, valid, np.asarray(vocab, dtype=object)


def _to_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode("utf-8")
    raise YtError(f"Expected string value, got {type(v).__name__}")


def _int64_bits(value) -> int:
    """A uint64 or int64 value as the int64 with the same bit pattern."""
    value = int(value) % (1 << 64)
    return value - (1 << 64) if value >= (1 << 63) else value


@dataclass(frozen=True)
class Column:
    """One column: data plane + validity plane + optional host vocabulary."""

    type: EValueType
    data: torch.Tensor                   # (capacity,) device_dtype(type)
    valid: torch.Tensor                  # (capacity,) bool
    dictionary: Optional[np.ndarray] = None   # host vocab for string columns

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def decode(self, row_count: int) -> list:
        """Materialize host values for the first `row_count` rows."""
        data = self.data[:row_count].cpu().numpy()
        valid = self.valid[:row_count].cpu().numpy()
        if self.type is EValueType.uint64:
            data = data.view(np.uint64)
        out: list = []
        for i in range(row_count):
            if not valid[i]:
                out.append(None)
            elif self.type is EValueType.string:
                out.append(bytes(self.dictionary[int(data[i])]))
            elif self.type is EValueType.boolean:
                out.append(bool(data[i]))
            elif self.type is EValueType.double:
                out.append(float(data[i]))
            elif self.type is EValueType.null:
                out.append(None)
            else:
                out.append(int(data[i]))
        return out


@dataclass(frozen=True)
class ColumnarChunk:
    """An immutable columnar rowset with static capacity on one device."""

    schema: TableSchema
    row_count: int
    columns: dict[str, Column]
    # Column names whose ascending, null-first order the rows are already
    # in (a prefix guarantee). Carried for parity with the JAX package;
    # this slice's lowering does not read it.
    sorted_by: tuple = ()

    @property
    def capacity(self) -> int:
        if not self.columns:
            return pad_capacity(max(self.row_count, 1))
        return next(iter(self.columns.values())).capacity

    @property
    def device(self) -> torch.device:
        if not self.columns:
            return torch.device("cpu")
        return next(iter(self.columns.values())).data.device

    @property
    def row_valid(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.row_count

    @property
    def nbytes(self) -> int:
        """Resident bytes of the column planes (capacity-padded)."""
        return sum(c.data.nbytes + c.valid.nbytes
                   for c in self.columns.values())

    def column(self, name: str) -> Column:
        col = self.columns.get(name)
        if col is None:
            raise YtError(f"No such column {name!r} in chunk",
                          code=EErrorCode.QueryTypeError)
        return col

    # --- construction ---------------------------------------------------------

    @staticmethod
    def from_rows(schema: TableSchema,
                  rows: Sequence[Mapping[str, Any] | Sequence[Any]],
                  device: "str | torch.device" = DEFAULT_DEVICE
                  ) -> "ColumnarChunk":
        dev = resolve_device(device)
        n = len(rows)
        cap = pad_capacity(max(n, 1))
        names = schema.column_names
        name_set = set(names)
        per_col: dict[str, list] = {name: [] for name in names}
        for row in rows:
            if isinstance(row, Mapping):
                if schema.strict:
                    unknown = set(row) - name_set
                    if unknown:
                        raise YtError(
                            f"Unknown columns {sorted(unknown)} for strict "
                            "schema", code=EErrorCode.QueryTypeError)
                for name in names:
                    per_col[name].append(row.get(name))
            else:
                if len(row) != len(names):
                    raise YtError(
                        f"Row width {len(row)} != schema width {len(names)}")
                for name, v in zip(names, row):
                    per_col[name].append(v)
        columns: dict[str, Column] = {}
        for col_schema in schema:
            name = col_schema.name
            values = per_col[name]
            if col_schema.required:
                for i, v in enumerate(values):
                    if v is None:
                        raise YtError(
                            f"Required column {name!r} is null in row {i}",
                            code=EErrorCode.QueryTypeError)
            columns[name] = _build_column(col_schema.type, values, cap, dev)
        return ColumnarChunk(schema=schema, row_count=n, columns=columns)

    @staticmethod
    def from_arrays(schema: TableSchema, arrays: Mapping[str, np.ndarray],
                    dictionaries: Optional[Mapping[str, np.ndarray]] = None,
                    device: "str | torch.device" = DEFAULT_DEVICE
                    ) -> "ColumnarChunk":
        """Build from numpy arrays, one per column, every row valid (no
        per-value loop). String columns arrive as int32 codes into their
        sorted vocabulary in `dictionaries`."""
        dev = resolve_device(device)
        n = len(next(iter(arrays.values())))
        cap = pad_capacity(max(n, 1))
        dictionaries = dict(dictionaries or {})
        columns: dict[str, Column] = {}
        for col_schema in schema:
            name = col_schema.name
            ty = col_schema.type
            if not isinstance(ty, EValueType) or ty is EValueType.any:
                raise YtError(f"from_arrays does not support {ty.value!r} "
                              "columns in this port",
                              code=EErrorCode.QueryUnsupported)
            arr = np.asarray(arrays[name])
            if len(arr) != n:
                raise YtError(f"Column {name!r} length {len(arr)} != {n}")
            vocab = None
            if ty is EValueType.string:
                if name not in dictionaries:
                    raise YtError(f"String column {name!r} needs its "
                                  "dictionary")
                vocab = np.asarray(dictionaries[name], dtype=object)
            if ty is EValueType.uint64:
                arr = arr.astype(np.uint64).view(np.int64)
            data = np.zeros(cap, dtype=_np_plane_dtype(ty))
            data[:n] = arr.astype(data.dtype)
            valid = np.zeros(cap, dtype=bool)
            valid[:n] = True
            columns[name] = Column(
                type=ty, data=torch.from_numpy(data).to(dev),
                valid=torch.from_numpy(valid).to(dev), dictionary=vocab)
        return ColumnarChunk(schema=schema, row_count=n, columns=columns)

    # --- materialization ------------------------------------------------------

    def to_rows(self) -> list[dict[str, Any]]:
        decoded = {name: col.decode(self.row_count)
                   for name, col in self.columns.items()}
        names = self.schema.column_names
        return [{name: decoded[name][i] for name in names}
                for i in range(self.row_count)]

    def to_numpy(self) -> dict:
        """The chunk as numpy arrays, in `chunk_from_numpy`'s arguments:
        schema_spec, row_count, planes {name: (data, valid)} at full
        capacity (uint64 data as np.uint64), dictionaries, sorted_by."""
        planes = {}
        dictionaries = {}
        for col_schema in self.schema:
            col = self.columns[col_schema.name]
            data = col.data.cpu().numpy()
            if col.type is EValueType.uint64:
                data = data.view(np.uint64)
            planes[col_schema.name] = (data, col.valid.cpu().numpy())
            if col.dictionary is not None:
                dictionaries[col_schema.name] = col.dictionary
        return {"schema_spec": _schema_spec(self.schema),
                "row_count": self.row_count, "planes": planes,
                "dictionaries": dictionaries, "sorted_by": self.sorted_by}


def _schema_spec(schema: TableSchema) -> list[tuple]:
    return [(c.name, c.type.value) + ((c.sort_order.value,)
                                      if c.sort_order is not None else ())
            for c in schema]


def chunk_from_numpy(schema_spec: Sequence[tuple], row_count: int,
                     planes: Mapping[str, tuple[np.ndarray, np.ndarray]],
                     dictionaries: Optional[Mapping[str, np.ndarray]] = None,
                     sorted_by: Sequence[str] = (),
                     device: "str | torch.device" = DEFAULT_DEVICE
                     ) -> ColumnarChunk:
    """A chunk from numpy arrays only: each column's full-capacity
    (data, valid) planes, the string vocabularies, and the schema as
    (name, type[, sort_order]) tuples. The planes are taken bit for bit."""
    dev = resolve_device(device)
    schema = TableSchema.make(schema_spec)
    dictionaries = dict(dictionaries or {})
    columns: dict[str, Column] = {}
    cap = None
    for col_schema in schema:
        name = col_schema.name
        data, valid = planes[name]
        data = np.asarray(data)
        valid = np.asarray(valid, dtype=bool)
        if cap is None:
            cap = len(data)
        if len(data) != cap or len(valid) != cap:
            raise YtError(f"Column {name!r} planes do not share the "
                          f"capacity {cap}")
        if cap < row_count:
            raise YtError(f"Capacity {cap} < row count {row_count}")
        dt = _np_plane_dtype(col_schema.type)
        if col_schema.type is EValueType.uint64:
            data = data.astype(np.uint64).view(np.int64)
        vocab = dictionaries.get(name)
        if col_schema.type is EValueType.string and vocab is None:
            raise YtError(f"String column {name!r} needs its vocabulary")
        columns[name] = Column(
            type=col_schema.type,
            data=torch.from_numpy(np.array(data, dtype=dt)).to(dev),
            valid=torch.from_numpy(np.array(valid)).to(dev),
            dictionary=None if vocab is None
            else np.asarray(vocab, dtype=object))
    return ColumnarChunk(schema=schema, row_count=row_count, columns=columns,
                         sorted_by=tuple(sorted_by))


def _build_column(ty: EValueType, values: Sequence[Any], cap: int,
                  device: torch.device) -> Column:
    if not isinstance(ty, EValueType) or ty is EValueType.any:
        raise YtError(f"Columns of type {ty.value!r} are not yet ported",
                      code=EErrorCode.QueryUnsupported)
    n = len(values)
    valid_np = np.zeros(cap, dtype=bool)
    data_np = np.zeros(cap, dtype=_np_plane_dtype(ty))
    vocab = None
    if ty is EValueType.string:
        encoded = [None if v is None else _to_bytes(v) for v in values]
        codes, valid, vocab = _encode_strings(encoded)
        data_np[:n] = codes
        valid_np[:n] = valid
    elif ty is not EValueType.null:
        for i, v in enumerate(values):
            if v is None:
                continue
            valid_np[i] = True
            if ty is EValueType.boolean:
                data_np[i] = bool(v)
            elif ty is EValueType.double:
                data_np[i] = float(v)
            elif ty is EValueType.uint64:
                data_np[i] = _int64_bits(np.uint64(v))
            else:
                data_np[i] = np.int64(v)
    return Column(type=ty, data=torch.from_numpy(data_np).to(device),
                  valid=torch.from_numpy(valid_np).to(device),
                  dictionary=vocab)
