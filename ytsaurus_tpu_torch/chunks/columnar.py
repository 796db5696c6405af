"""Columnar chunks: the unit of table data, as torch planes on a device.

Port of the JAX package's `chunks/columnar.py` (`next_pow2`, `pad_capacity`,
`Column`, `ColumnarChunk`, `from_rows`, `from_arrays`, `to_rows`,
`to_tuples`, `with_capacity`, `slice_rows`, `unify_dictionaries`,
`concat_chunks`, and the column statistics the join
planner and the chunk meta read: `chunk_column_stats` (one column's
entry: `column_stats`), `column_ndv_sketch`, `ndv_estimate`,
`merge_column_stats`, `vector_column_stats`):

  * A chunk is a struct-of-arrays: one fixed-width plane per column plus a
    validity plane, padded to a static capacity (a power of two times 128).
    `row_count` may be smaller than capacity; rows beyond it are masked out
    by `row_valid`.
  * Strings are order-preserving dictionary-encoded per chunk: the plane
    holds int32 ranks into a host-side sorted vocabulary, so comparisons,
    grouping and sorting on strings are integer work on the device.
  * uint64 planes hold int64 bit patterns (see schema.py).
  * A vector column (`vector<float, N>`) is one contiguous `(capacity, N)`
    float32 plane beside the `(capacity,)` validity plane; invalid rows
    carry zeros. Ragged, wrong-dim and non-finite vectors are refused at
    write time.
  * `any`-typed payloads stay host-side (`Column.host_values`, a list of
    YSON values padded with None to the capacity) beside an int8
    placeholder plane and the validity plane; they ride along through
    slicing, concatenation, the wire format, sorts and joins but are
    opaque to device compute.

The statistics are host (numpy) code, as in the reference, over the planes
read back from the device. Left out: the invariants hook and hunks.

`chunk_from_numpy` / `ColumnarChunk.to_numpy` carry a chunk across as plain
numpy arrays, so a caller can hand the port the exact bytes another
implementation computed over.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.schema import (
    EValueType,
    TableSchema,
    VectorType,
    device_dtype,
)

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


def _plane_dtype(ty: EValueType) -> torch.dtype:
    """Torch dtype of a column's plane: `any` columns carry host payloads
    and an int8 placeholder plane."""
    if ty is EValueType.any:
        return torch.int8
    return device_dtype(ty)


def _np_plane_dtype(ty: EValueType) -> np.dtype:
    """Host dtype of a plane as it crosses to torch (uint64 as int64)."""
    return np.dtype({torch.int64: np.int64, torch.float64: np.float64,
                     torch.bool: np.bool_, torch.int32: np.int32,
                     torch.int8: np.int8,
                     torch.float32: np.float32}[_plane_dtype(ty)])


def _plane_shape(ty, capacity: int) -> tuple:
    """(capacity,) for scalar columns, (capacity, dim) for vectors."""
    return (capacity, ty.dim) if isinstance(ty, VectorType) else (capacity,)


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
    data: torch.Tensor                   # (capacity,) or (capacity, dim)
    valid: torch.Tensor                  # (capacity,) bool
    dictionary: Optional[np.ndarray] = None   # host vocab for string columns
    host_values: Optional[list] = None        # payloads for `any` columns

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def decode(self, row_count: int) -> list:
        """Materialize host values for the first `row_count` rows (None
        where invalid): one copy of the planes, then whole-array
        conversions."""
        data = self.data[:row_count].cpu().numpy()
        valid = self.valid[:row_count].cpu().numpy()
        if self.type is EValueType.uint64:
            data = data.view(np.uint64)
        if self.type is EValueType.null:
            return [None] * row_count
        if self.type is EValueType.any:
            out = list(self.host_values[:row_count])
        elif self.type is EValueType.string:
            if self.dictionary is None or not len(self.dictionary):
                return [None] * row_count     # every row is null
            vocab = [bytes(v) for v in self.dictionary]
            out = [vocab[c] for c in np.where(valid, data, 0).tolist()]
        elif self.type is EValueType.boolean:
            out = data.astype(bool).tolist()
        elif isinstance(self.type, VectorType) or \
                self.type is EValueType.double:
            out = data.astype(np.float64).tolist()
        else:
            out = data.tolist()
        if not valid.all():
            for i in np.flatnonzero(~valid).tolist():
                out[i] = None
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
        return ColumnarChunk.from_columns(schema, per_col, len(rows),
                                          device=device)

    @staticmethod
    def from_columns(schema: TableSchema, values: Mapping[str, list],
                     row_count: int,
                     device: "str | torch.device" = DEFAULT_DEVICE
                     ) -> "ColumnarChunk":
        """from_rows with the rows given column-wise: one list of
        `row_count` Python values per schema column."""
        dev = resolve_device(device)
        n = row_count
        cap = pad_capacity(max(n, 1))
        columns: dict[str, Column] = {}
        for col_schema in schema:
            name = col_schema.name
            values_of = values[name]
            if len(values_of) != n:
                raise YtError(f"Column {name!r} has {len(values_of)} values, "
                              f"the first column {n}")
            if col_schema.required:
                for i, v in enumerate(values_of):
                    if v is None:
                        raise YtError(
                            f"Required column {name!r} is null in row {i}",
                            code=EErrorCode.QueryTypeError)
            columns[name] = _build_column(col_schema.type, values_of, cap,
                                          dev, name)
        return ColumnarChunk(schema=schema, row_count=n, columns=columns)

    @staticmethod
    def from_arrays(schema: TableSchema, arrays: Mapping[str, np.ndarray],
                    row_count: Optional[int] = None,
                    valids: Optional[Mapping[str, np.ndarray]] = None,
                    dictionaries: Optional[Mapping[str, np.ndarray]] = None,
                    capacity: Optional[int] = None, *,
                    device: "str | torch.device" = DEFAULT_DEVICE
                    ) -> "ColumnarChunk":
        """Build from numpy arrays, one per column (no per-value loop).
        `valids` marks null rows (every row valid by default). A string
        column arrives either as int32 codes into its sorted vocabulary in
        `dictionaries`, or raw (`S`, `U` or object arrays, None as null),
        which one `np.unique` dictionary-encodes."""
        dev = resolve_device(device)
        n = row_count if row_count is not None else \
            len(next(iter(arrays.values())))
        cap = capacity or pad_capacity(max(n, 1))
        dictionaries = dict(dictionaries or {})
        valids = dict(valids or {})
        columns: dict[str, Column] = {}
        for col_schema in schema:
            name = col_schema.name
            ty = col_schema.type
            if ty is EValueType.any:
                raise YtError("from_arrays does not support `any` columns; "
                              "use from_rows", code=EErrorCode.QueryUnsupported)
            arr = np.asarray(arrays[name])
            if len(arr) != n:
                raise YtError(f"Column {name!r} length {len(arr)} != {n}")
            if isinstance(ty, VectorType):
                col = _vector_column_from_array(ty, name, arr, cap, dev)
                if name in valids:
                    col.valid[:n] = torch.from_numpy(
                        np.asarray(valids[name], dtype=bool)).to(dev)
                columns[name] = col
                continue
            vocab = None
            if ty is EValueType.string:
                if name in dictionaries:
                    vocab = np.asarray(dictionaries[name], dtype=object)
                else:
                    arr, vocab, nulls = _encode_raw_strings(name, arr)
                    if nulls is not None and name not in valids:
                        valids[name] = ~nulls
            if ty is EValueType.uint64:
                arr = arr.astype(np.uint64).view(np.int64)
            data = np.zeros(cap, dtype=_np_plane_dtype(ty))
            data[:n] = arr.astype(data.dtype)
            valid = np.zeros(cap, dtype=bool)
            valid[:n] = np.asarray(valids[name], dtype=bool) \
                if name in valids else True
            columns[name] = Column(
                type=ty, data=torch.from_numpy(data).to(dev),
                valid=torch.from_numpy(valid).to(dev), dictionary=vocab)
        return ColumnarChunk(schema=schema, row_count=n, columns=columns)

    # --- materialization ------------------------------------------------------

    def to_rows(self) -> list[dict[str, Any]]:
        names = self.schema.column_names
        decoded = [self.columns[name].decode(self.row_count)
                   for name in names]
        if not names:
            return [{} for _ in range(self.row_count)]
        return [dict(zip(names, values)) for values in zip(*decoded)]

    def to_tuples(self) -> list[tuple]:
        decoded = [self.columns[name].decode(self.row_count)
                   for name in self.schema.column_names]
        return [tuple(col[i] for col in decoded)
                for i in range(self.row_count)]

    # --- transforms -----------------------------------------------------------

    def with_capacity(self, capacity: int) -> "ColumnarChunk":
        """Repad all planes to a new (>= row_count) capacity."""
        if capacity == self.capacity:
            return self
        if capacity < self.row_count:
            raise YtError("Cannot shrink chunk below its row count")
        m = min(capacity, self.capacity)
        columns = {name: _repadded(col, 0, m, capacity)
                   for name, col in self.columns.items()}
        return ColumnarChunk(schema=self.schema, row_count=self.row_count,
                             columns=columns, sorted_by=self.sorted_by)

    def slice_rows(self, start: int, end: int) -> "ColumnarChunk":
        start = max(0, start)
        end = min(self.row_count, end)
        n = max(0, end - start)
        cap = pad_capacity(max(n, 1))
        columns = {}
        for name, col in self.columns.items():
            col = _repadded(col, start, n, cap)
            if col.host_values is not None:
                col = replace(col, host_values=col.host_values[start:end])
            columns[name] = col
        return ColumnarChunk(schema=self.schema, row_count=n, columns=columns,
                             sorted_by=self.sorted_by)

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


def _encode_raw_strings(name: str, arr: np.ndarray
                        ) -> "tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]":
    """A raw string array as (int32 codes, sorted bytes vocabulary, null
    mask or None), through one `np.unique`. `S` and `U` arrays are
    fixed-width already; object arrays compare losslessly over arbitrary
    bytes, with None as null (encoded as b"" and masked)."""
    raw = arr
    if raw.dtype.kind == "U":
        raw = np.char.encode(raw, "utf-8")
    nulls = None
    if raw.dtype.kind == "O":
        nulls = np.array([v is None for v in raw], dtype=bool)
        if nulls.any():
            raw = raw.copy()
            raw[nulls] = b""
        else:
            nulls = None
    if raw.dtype.kind not in ("S", "O"):
        raise YtError(f"String column {name!r} needs a dictionary or a "
                      "string-typed array")
    vocab_s, codes = np.unique(raw, return_inverse=True)
    vocab = np.empty(len(vocab_s), dtype=object)
    vocab[:] = [bytes(v) for v in vocab_s]
    return codes.astype(np.int32), vocab, nulls


def _repadded(col: Column, start: int, n: int, capacity: int) -> Column:
    """Rows [start, start + n) of a column at the front of new planes of
    `capacity` rows (zero data, invalid beyond them)."""
    data = torch.zeros((capacity,) + tuple(col.data.shape[1:]),
                       dtype=col.data.dtype, device=col.data.device)
    valid = torch.zeros(capacity, dtype=torch.bool, device=col.valid.device)
    data[:n] = col.data[start:start + n]
    valid[:n] = col.valid[start:start + n]
    return replace(col, data=data, valid=valid)


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
        if data.shape[1:] != _plane_shape(col_schema.type, cap)[1:]:
            raise YtError(f"Column {name!r} plane has shape {data.shape}, "
                          f"its type {col_schema.type.value!r} needs "
                          f"{_plane_shape(col_schema.type, cap)}")
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


def _vector_column_from_array(ty: VectorType, name: str, arr: np.ndarray,
                              cap: int, device: torch.device) -> Column:
    """A (rows, dim) array as a vector column, every row valid."""
    if arr.ndim != 2 or arr.shape[1] != ty.dim:
        raise YtError(f"Vector column {name!r} needs a (rows, {ty.dim}) "
                      f"array, got shape {arr.shape}",
                      code=EErrorCode.QueryTypeError)
    if not np.isfinite(arr).all():
        raise YtError(f"Non-finite component in vector column {name!r}",
                      code=EErrorCode.QueryTypeError)
    n = len(arr)
    data = torch.zeros((cap, ty.dim), dtype=torch.float32, device=device)
    data[:n] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    valid = torch.zeros(cap, dtype=torch.bool, device=device)
    valid[:n] = True
    return Column(type=ty, data=data, valid=valid)


def _build_vector_plane(ty: VectorType, values: Sequence[Any], cap: int,
                        name: str = "") -> tuple[np.ndarray, np.ndarray]:
    """Host rows → a (cap, dim) float32 plane and its validity. Ragged
    rows, wrong-dim rows and non-finite components are refused here: a NaN
    in a stored plane would poison every distance it enters."""
    dim = ty.dim
    data_np = np.zeros((cap, dim), dtype=np.float32)
    valid_np = np.zeros(cap, dtype=bool)
    label = f" in column {name!r}" if name else ""
    for i, v in enumerate(values):
        if v is None:
            continue
        try:
            arr = np.asarray(v, dtype=np.float32)
        except (TypeError, ValueError) as e:
            raise YtError(f"Bad vector value{label} at row {i}: {e}",
                          code=EErrorCode.QueryTypeError)
        if arr.ndim != 1:
            raise YtError(
                f"Ragged vector value{label} at row {i}: expected a flat "
                f"{dim}-component vector, got shape {arr.shape}",
                code=EErrorCode.QueryTypeError)
        if arr.shape[0] != dim:
            raise YtError(
                f"Vector dim mismatch{label} at row {i}: expected {dim} "
                f"components, got {arr.shape[0]}",
                code=EErrorCode.QueryTypeError)
        if not np.isfinite(arr).all():
            raise YtError(f"Non-finite vector component{label} at row {i}",
                          code=EErrorCode.QueryTypeError)
        data_np[i] = arr
        valid_np[i] = True
    return data_np, valid_np


# The Python type whose values fill a plane of these types directly.
_PLAIN_TYPES = {EValueType.int64: int, EValueType.double: float}


def _build_column(ty: EValueType, values: Sequence[Any], cap: int,
                  device: torch.device, name: str = "") -> Column:
    if isinstance(ty, VectorType):
        data_np, valid_np = _build_vector_plane(ty, values, cap, name)
        return Column(type=ty, data=torch.from_numpy(data_np).to(device),
                      valid=torch.from_numpy(valid_np).to(device))
    n = len(values)
    valid_np = np.zeros(cap, dtype=bool)
    data_np = np.zeros(cap, dtype=_np_plane_dtype(ty))
    vocab = None
    host_values = None
    if ty is EValueType.any:
        host_values = list(values) + [None] * (cap - n)
        valid_np[:n] = [v is not None for v in values]
    elif ty is EValueType.string:
        encoded = [None if v is None else _to_bytes(v) for v in values]
        codes, valid, vocab = _encode_strings(encoded)
        data_np[:n] = codes
        valid_np[:n] = valid
    elif _PLAIN_TYPES.get(ty) is not None and \
            set(map(type, values)) <= {_PLAIN_TYPES[ty]}:
        # Every value a plain int (float): one array conversion, the same
        # numbers as the loop below.
        data_np[:n] = values
        valid_np[:n] = True
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
                  dictionary=vocab, host_values=host_values)


# --- dictionary unification and concatenation ------------------------------


def unified_vocabulary(columns: Sequence[Column]) -> np.ndarray:
    """The shared sorted vocabulary `unify_dictionaries` moves string
    columns onto: their one vocabulary object if they share one, else the
    sorted union. Reads only the host vocabularies."""
    string_cols = [c for c in columns if c.type is EValueType.string]
    if string_cols and all(c.dictionary is not None for c in string_cols):
        first = string_cols[0].dictionary
        if all(c.dictionary is first for c in string_cols[1:]):
            return np.asarray(first, dtype=object)
    vocabs = [c.dictionary for c in columns if c.dictionary is not None]
    if vocabs:
        merged = np.unique(np.concatenate(
            [np.asarray(v, dtype=object) for v in vocabs]))
    else:
        merged = np.array([], dtype=object)
    return np.asarray(merged, dtype=object)


def remap_dictionary(col: Column, merged: np.ndarray) -> Column:
    """A string column re-encoded onto `merged`, a sorted superset of its
    vocabulary; other columns, and a column already on `merged` (the same
    object), come back untouched."""
    if col.type is not EValueType.string or col.dictionary is merged:
        return col
    old_vocab = col.dictionary if col.dictionary is not None \
        else np.array([], dtype=object)
    remap_np = np.searchsorted(
        merged, np.asarray(old_vocab, dtype=object)).astype(np.int32) \
        if len(old_vocab) else np.zeros(1, dtype=np.int32)
    remap = torch.from_numpy(remap_np).to(col.data.device)
    new_codes = remap[col.data.to(torch.int64).clamp(0, len(remap_np) - 1)]
    return replace(col, data=new_codes.to(torch.int32), dictionary=merged)


def unify_dictionaries(columns: Sequence[Column]
                       ) -> tuple[list[Column], np.ndarray]:
    """Re-encode string columns onto a shared sorted vocabulary: the
    remapped columns and the unified vocab. Columns that already share one
    vocabulary object come back untouched."""
    merged = unified_vocabulary(columns)
    return [remap_dictionary(col, merged) for col in columns], merged


def concat_chunks(chunks: Sequence[ColumnarChunk]) -> ColumnarChunk:
    """Concatenate chunks of identical schema into one, on their device,
    padded to the capacity of the total row count; string columns move to
    the union of their vocabularies."""
    if not chunks:
        raise YtError("concat_chunks: empty input")
    if len(chunks) == 1:
        return chunks[0]
    schema = chunks[0].schema
    for c in chunks[1:]:
        if c.schema != schema:
            raise YtError("concat_chunks: schema mismatch",
                          code=EErrorCode.ChunkFormatError)
    device = chunks[0].device
    total = sum(c.row_count for c in chunks)
    cap = pad_capacity(max(total, 1))
    columns: dict[str, Column] = {}
    for col_schema in schema:
        name = col_schema.name
        cols = [c.column(name) for c in chunks]
        vocab = None
        if col_schema.type is EValueType.string:
            cols, vocab = unify_dictionaries(cols)
        data = torch.zeros(_plane_shape(col_schema.type, cap),
                           dtype=_plane_dtype(col_schema.type), device=device)
        valid = torch.zeros(cap, dtype=torch.bool, device=device)
        data[:total] = torch.cat([col.data[:chunk.row_count].to(data.dtype)
                                  for chunk, col in zip(chunks, cols)])
        valid[:total] = torch.cat([col.valid[:chunk.row_count]
                                   for chunk, col in zip(chunks, cols)])
        host_values = None
        if col_schema.type is EValueType.any:
            host_values = []
            for chunk, col in zip(chunks, cols):
                host_values.extend((col.host_values or [])[:chunk.row_count])
            host_values += [None] * (cap - total)
        columns[name] = Column(type=col_schema.type, data=data, valid=valid,
                               dictionary=vocab, host_values=host_values)
    return ColumnarChunk(schema=schema, row_count=total, columns=columns)


# --- column statistics ------------------------------------------------------
#
# A fixed 64-register hash-max sketch (the HLL register layout) per column
# beside min/max/has_null: the cost-based join planner (query/planner.py)
# reads NDV off it, and sketches merge across chunks by register max.

# Bound on string min/max stat values.
_STAT_STRING_CAP = 64
NDV_SKETCH_SLOTS = 64
_NDV_SLOT_BITS = 6
_NDV_MAX_RANK = 58              # 64 - slot bits: ranks fit one byte


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 over a uint64 array (wrapping arithmetic)."""
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _ndv_sketch_from_hashes(hashes: np.ndarray) -> bytes:
    """Fold uniform uint64 hashes into the 64-register sketch: low bits
    pick the register, the rank is 1 + trailing-zero count of the rest."""
    regs = np.zeros(NDV_SKETCH_SLOTS, dtype=np.uint8)
    if len(hashes):
        h = hashes.astype(np.uint64)
        slots = (h & np.uint64(NDV_SKETCH_SLOTS - 1)).astype(np.int64)
        rest = h >> np.uint64(_NDV_SLOT_BITS)
        with np.errstate(over="ignore"):
            lsb = rest & (~rest + np.uint64(1))
        # log2 of an exact power of two is exact in float64 up to 2^58.
        rank = np.where(rest == 0, _NDV_MAX_RANK,
                        1 + np.log2(np.maximum(lsb, 1).astype(np.float64))
                        ).astype(np.uint8)
        np.maximum.at(regs, slots, rank)
    return regs.tobytes()


def _hash_string_vocab(vocab: np.ndarray) -> np.ndarray:
    """Deterministic uint64 content hash per vocab entry: a wrapping
    polynomial fold per entry over one concatenated byte buffer, the
    length folded in, then splitmix."""
    n = len(vocab)
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    entries = [bytes(v) for v in vocab]
    lengths = np.fromiter((len(e) for e in entries), count=n,
                          dtype=np.int64)
    # A leading sentinel byte per entry keeps every reduceat segment
    # non-empty and distinguishes b"" from absent.
    data = np.frombuffer(b"\x01" + b"\x01".join(entries),
                         dtype=np.uint8).astype(np.uint64)
    seg_lengths = lengths + 1
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(seg_lengths[:-1], out=starts[1:])
    p = np.uint64(0x9E3779B97F4A7C15 | 1)
    with np.errstate(over="ignore"):
        powers = np.empty(int(seg_lengths.max()), dtype=np.uint64)
        powers[0] = 1
        np.cumprod(np.full(len(powers) - 1, p, dtype=np.uint64),
                   out=powers[1:])
        pos = np.arange(len(data), dtype=np.int64) - \
            np.repeat(starts, seg_lengths)
        h = np.add.reduceat(data * powers[pos], starts)
        h = h ^ (lengths.astype(np.uint64) *
                 np.uint64(0xBF58476D1CE4E5B9))
    return _splitmix64(h)


def _host_planes(col: Column, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The first n rows of a column as numpy (uint64 data as np.uint64)."""
    data = col.data[:n].cpu().numpy()
    if col.type is EValueType.uint64:
        data = data.view(np.uint64)
    return data, col.valid[:n].cpu().numpy()


def column_ndv_sketch(col: Column, row_count: int) -> "bytes | None":
    """The column's distinct-count sketch over its valid values, or None
    for types with no meaningful NDV (any/null)."""
    if col.type in (EValueType.any, EValueType.null):
        return None
    n = row_count
    if not n:
        return _ndv_sketch_from_hashes(np.zeros(0, dtype=np.uint64))
    data, valid = _host_planes(col, n)
    if not valid.any():
        return _ndv_sketch_from_hashes(np.zeros(0, dtype=np.uint64))
    data = data[valid]
    if col.type is EValueType.string:
        vocab = col.dictionary if col.dictionary is not None \
            else np.array([], dtype=object)
        entry_hashes = _hash_string_vocab(vocab)
        if len(entry_hashes) == 0:
            hashes = np.zeros(0, dtype=np.uint64)
        else:
            hashes = entry_hashes[
                np.clip(data.astype(np.int64), 0, len(entry_hashes) - 1)]
    elif col.type is EValueType.double:
        canon = np.where(data == 0.0, 0.0, data)   # -0.0 == +0.0
        hashes = _splitmix64(canon.view(np.uint64))
    else:
        hashes = _splitmix64(data.astype(np.int64).view(np.uint64)
                             if col.type is not EValueType.uint64
                             else data.astype(np.uint64))
    return _ndv_sketch_from_hashes(hashes)


def _sketch_regs(sketch) -> "np.ndarray | None":
    """Registers from a sketch payload (bytes, or the same bytes spelled
    as a utf-8 str)."""
    if sketch is None:
        return None
    if isinstance(sketch, str):
        sketch = sketch.encode("utf-8")
    regs = np.frombuffer(bytes(sketch), dtype=np.uint8)
    if len(regs) != NDV_SKETCH_SLOTS:
        return None                    # corrupt payload: unusable, not fatal
    return regs


def merge_ndv_sketches(sketches) -> "bytes | None":
    """Elementwise register max: the sketch of the UNION of the inputs."""
    merged = None
    for s in sketches:
        regs = _sketch_regs(s)
        if regs is None:
            continue
        merged = regs.copy() if merged is None else np.maximum(merged, regs)
    return None if merged is None else merged.tobytes()


def ndv_estimate(sketch: "bytes | None") -> int:
    """Distinct-count estimate off the registers (HLL harmonic mean with
    the linear-counting small-range correction); >= 1 for a non-empty
    sketch, 0 for no data."""
    regs = _sketch_regs(sketch)
    if regs is None:
        return 0
    regs = regs.astype(np.float64)
    if not regs.any():
        return 0
    m = float(NDV_SKETCH_SLOTS)
    est = 0.709 * m * m / np.sum(np.exp2(-regs))
    zeros = int((regs == 0).sum())
    if est <= 2.5 * m and zeros:
        est = m * np.log(m / zeros)
    return max(int(round(est)), 1)


def merge_column_stats(stats_list: "Sequence[dict]") -> dict:
    """Fold per-chunk column stats into table-level stats: min of mins,
    max of maxes (None = unbounded wins), has_null ORs, `$row_count`
    sums, sketches merge."""
    def bound(v):
        return v.encode("utf-8") if isinstance(v, str) else v

    out: dict = {"$row_count": 0}
    for stats in stats_list:
        for name, entry in stats.items():
            if name == "$row_count":
                out["$row_count"] += int(entry)
                continue
            if not isinstance(entry, dict):
                continue
            if "vector_dim" in entry:
                _merge_vector_stats(out, name, entry)
                continue
            entry = {**entry, "min": bound(entry.get("min")),
                     "max": bound(entry.get("max"))}
            cur = out.get(name)
            if cur is None:
                out[name] = {"min": entry.get("min"), "max": entry.get("max"),
                             "has_null": bool(entry.get("has_null")),
                             "ndv_sketch": entry.get("ndv_sketch"),
                             "_empty": entry.get("min") is None
                             and entry.get("max") is None}
                continue
            # A chunk with no valid rows (min AND max None) contributes
            # nothing to the bounds; a lone None bound is unbounded and
            # wins the merge.
            entry_empty = entry.get("min") is None and \
                entry.get("max") is None
            if not entry_empty:
                if cur.pop("_empty", False):
                    cur["min"], cur["max"] = entry.get("min"), \
                        entry.get("max")
                else:
                    for key, pick in (("min", min), ("max", max)):
                        a, b = cur.get(key), entry.get(key)
                        cur[key] = None if a is None or b is None \
                            else pick(a, b)
                cur["_empty"] = False
            cur["has_null"] = cur["has_null"] or bool(entry.get("has_null"))
            cur["ndv_sketch"] = merge_ndv_sketches(
                [cur.get("ndv_sketch"), entry.get("ndv_sketch")])
    for entry in out.values():
        if isinstance(entry, dict):
            entry.pop("_empty", None)
    return out


def _merge_vector_stats(out: dict, name: str, entry: dict) -> None:
    """Vector columns fold exactly: counts and centroid sums add, norm
    bounds take min/max (None = no valid rows, the other side wins),
    has_null ORs."""
    cur = out.get(name)
    if cur is None:
        out[name] = {**entry,
                     "centroid_sum": list(entry.get("centroid_sum") or [])}
        return
    cur["has_null"] = bool(cur.get("has_null")) or \
        bool(entry.get("has_null"))
    cur["count"] = int(cur.get("count", 0)) + int(entry.get("count", 0))
    a = cur.get("centroid_sum") or []
    b = entry.get("centroid_sum") or []
    cur["centroid_sum"] = [float(x) + float(y) for x, y in zip(a, b)] \
        if a and b else list(a or b)
    for key, pick in (("norm_min", min), ("norm_max", max)):
        x, y = cur.get(key), entry.get(key)
        cur[key] = y if x is None else (x if y is None else pick(x, y))


def vector_column_stats(col: Column, row_count: int) -> dict:
    """Centroid and L2-norm statistics of a vector column: `centroid_sum`
    is the sum over valid rows (not the mean), so the merge across chunks
    is an exact addition; `norm_min` / `norm_max` bracket the valid rows'
    norms."""
    n = row_count
    valid = col.valid[:n].cpu().numpy() if n else np.zeros(0, dtype=bool)
    dim = int(col.type.dim)
    entry: dict = {"has_null": bool((~valid).any()) if n else True,
                   "vector_dim": dim, "count": 0,
                   "centroid_sum": [0.0] * dim,
                   "norm_min": None, "norm_max": None, "ndv_sketch": None}
    if n and valid.any():
        data = col.data[:n].cpu().numpy()[valid].astype(np.float64)
        norms = np.sqrt((data * data).sum(axis=1))
        entry["count"] = int(valid.sum())
        entry["centroid_sum"] = [float(x) for x in data.sum(axis=0)]
        entry["norm_min"] = float(norms.min())
        entry["norm_max"] = float(norms.max())
    return entry


def _string_stat_upper(value: bytes) -> "bytes | None":
    """An upper bound for `value` no longer than the cap: the value itself
    when short, else the successor of its cap-length prefix; None when no
    bounded successor exists."""
    if len(value) <= _STAT_STRING_CAP:
        return value
    prefix = value[:_STAT_STRING_CAP].rstrip(b"\xff")
    if not prefix:
        return None
    return prefix[:-1] + bytes([prefix[-1] + 1])


def chunk_column_stats(chunk: ColumnarChunk) -> dict:
    """Per-column min/max/has_null/ndv_sketch statistics, plus
    `$row_count`."""
    out: dict[str, dict] = {}
    n = chunk.row_count
    for name, col in chunk.columns.items():
        entry = column_stats(col, n)
        if entry is not None:
            out[name] = entry
    out["$row_count"] = n
    return out


def column_stats(col: Column, n: int) -> "dict | None":
    """One column's entry of `chunk_column_stats` over its first n rows
    (None for `any` and `null` columns, which have none)."""
    if col.type in (EValueType.any, EValueType.null):
        return None
    if isinstance(col.type, VectorType):
        return vector_column_stats(col, n)
    data, valid = _host_planes(col, n)
    entry: dict = {"has_null": bool((~valid).any()) if n else True,
                   "min": None, "max": None}
    if n and valid.any():
        data = data[valid]
        if col.type is EValueType.string:
            entry["min"] = bytes(
                col.dictionary[int(data.min())])[:_STAT_STRING_CAP]
            entry["max"] = _string_stat_upper(
                bytes(col.dictionary[int(data.max())]))
        elif col.type is EValueType.boolean:
            entry["min"] = bool(data.min())
            entry["max"] = bool(data.max())
        elif col.type is EValueType.double:
            entry["min"] = float(data.min())
            entry["max"] = float(data.max())
        else:
            entry["min"] = int(data.min())
            entry["max"] = int(data.max())
    entry["ndv_sketch"] = column_ndv_sketch(col, n)
    return entry
