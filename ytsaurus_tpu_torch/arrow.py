"""Arrow interop: columnar chunks ↔ Arrow IPC streams.

Port of the JAX package's `arrow.py` (`chunk_to_arrow`,
`chunks_to_arrow_ipc`, `arrow_ipc_to_rows`,
`arrow_schema_to_table_schema`): vector columns as `FixedSizeList`, string
columns as dictionary arrays over the host vocabulary, `any` columns as
YSON text. For the same chunk the table equals the reference's.

Ref mapping (yt/yt/client/arrow):
  arrow_row_stream_encoder.h   → chunk_to_arrow / chunks_to_arrow_ipc
  arrow_row_stream_decoder     → arrow_ipc_to_rows

pyarrow is imported lazily (`_pa()`); without it every entry point raises
the reference's YtError. A chunk's planes on the card cross to the host
with one `.cpu()` each; a CPU plane is handed over without a copy where
it has no nulls. uint64 planes (int64 bit patterns in the port) are
viewed as uint64.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ytsaurus_tpu_torch import yson
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.schema import EValueType, TableSchema, VectorType

_ARROW_TYPES = {
    EValueType.int64: "int64",
    EValueType.uint64: "uint64",
    EValueType.double: "float64",
    EValueType.boolean: "bool_",
}


def _pa():
    try:
        import pyarrow
        return pyarrow
    except ImportError as err:        # pragma: no cover - baked into image
        raise YtError("pyarrow is not available",
                      code=EErrorCode.QueryUnsupported) from err


def chunk_to_arrow(chunk) -> "pyarrow.Table":
    """One ColumnarChunk → pa.Table (numeric planes zero-copy via numpy;
    string columns as dictionary arrays over the host vocabulary)."""
    pa = _pa()
    n = chunk.row_count
    arrays, fields = [], []
    for col_schema in chunk.schema:
        name = col_schema.name
        col = chunk.columns[name]
        valid = col.valid[:n].cpu().numpy()
        mask = ~valid
        if isinstance(col_schema.type, VectorType):
            # (rows, dim) float32 plane → FixedSizeListArray(float32, dim):
            # the flat child buffer IS the plane, row-major.
            dim = col_schema.type.dim
            plane = np.ascontiguousarray(col.data[:n].cpu().numpy(),
                                         dtype=np.float32)
            arr = pa.FixedSizeListArray.from_arrays(
                pa.array(plane.reshape(-1), type=pa.float32()), dim)
            if mask.any():
                # from_arrays carries no validity — rebuild with nulls.
                arr = pa.array(
                    [None if mask[i] else [float(x) for x in plane[i]]
                     for i in range(n)],
                    type=pa.list_(pa.float32(), dim))
        elif col_schema.type in _ARROW_TYPES:
            data = col.data[:n].cpu().numpy()
            if col_schema.type is EValueType.uint64:
                data = data.view(np.uint64)
            arr = pa.array(data, mask=mask,
                           type=getattr(pa, _ARROW_TYPES[col_schema.type])())
        elif col_schema.type is EValueType.string:
            codes = col.data[:n].cpu().numpy().astype(np.int32)
            vocab = [bytes(v) for v in (col.dictionary if col.dictionary
                                        is not None else [])]
            # Null slots must carry a valid index for DictionaryArray.
            safe = np.where(mask, 0, codes) if len(vocab) else codes
            arr = pa.DictionaryArray.from_arrays(
                pa.array(safe, mask=mask, type=pa.int32()),
                pa.array(vocab, type=pa.binary()))
        elif col_schema.type is EValueType.any:
            values = [None if not valid[i] else (col.host_values or [])[i]
                      for i in range(n)]
            arr = pa.array([None if v is None else _any_to_arrow(v)
                            for v in values], type=pa.string())
        elif col_schema.type is EValueType.null:
            arr = pa.nulls(n)
        else:
            raise YtError(f"Cannot encode {col_schema.type} as arrow",
                          code=EErrorCode.QueryUnsupported)
        arrays.append(arr)
        fields.append(pa.field(name, arr.type))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def _any_to_arrow(value) -> str:
    return yson.dumps(value).decode("utf-8", "replace")


def chunks_to_arrow_ipc(chunks: Sequence) -> bytes:
    """Arrow IPC stream bytes (the read_table format='arrow' payload)."""
    pa = _pa()
    tables = [chunk_to_arrow(c) for c in chunks]
    table = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    return sink.getvalue().to_pybytes()


def arrow_ipc_to_rows(blob: bytes) -> list[dict]:
    """Arrow IPC stream → host rows (the write_table format='arrow' path).
    Binary/string columns come back as bytes, matching chunk decode."""
    pa = _pa()
    with pa.ipc.open_stream(blob) as reader:
        table = reader.read_all()
    rows: list[dict] = [dict() for _ in range(table.num_rows)]
    for name in table.column_names:
        column = table.column(name)
        for i, value in enumerate(column.to_pylist()):
            if isinstance(value, str):
                value = value.encode()
            rows[i][name] = value
    return rows


def arrow_schema_to_table_schema(arrow_schema) -> TableSchema:
    pa = _pa()
    cols = []
    for field in arrow_schema:
        t = field.type
        if pa.types.is_dictionary(t):
            t = t.value_type
        if pa.types.is_fixed_size_list(t) and \
                pa.types.is_floating(t.value_type):
            cols.append((field.name, f"vector<float, {t.list_size}>"))
            continue
        if pa.types.is_integer(t):
            ty = "uint64" if pa.types.is_unsigned_integer(t) else "int64"
        elif pa.types.is_floating(t):
            ty = "double"
        elif pa.types.is_boolean(t):
            ty = "boolean"
        elif pa.types.is_binary(t) or pa.types.is_string(t) or \
                pa.types.is_large_binary(t) or pa.types.is_large_string(t):
            ty = "string"
        else:
            raise YtError(f"Unsupported arrow type {t} for {field.name!r}",
                          code=EErrorCode.QueryUnsupported)
        cols.append((field.name, ty))
    return TableSchema.make(cols, strict=True)
