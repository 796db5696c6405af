"""Row formats: serialize/parse rowsets as yson / json / dsv / schemaful_dsv
and skiff.

Port of the JAX package's `formats.py` (`dumps_rows` / `loads_rows` for the
four text formats with the DSV escaping helpers, `dumps_skiff` /
`loads_skiff` with required columns and truncation errors). For the same
rows the bytes written are the reference's, and parsing gives the
reference's rows and errors.

Ref: yt/yt/client/formats + library/formats — format objects convert between
wire bytes and rows for table IO and job IO.

One difference of means: the DSV splitting and unescaping helpers take
`str.split` / `str.partition` when the text holds no backslash, where the
reference walks it character by character (the same result: without a
backslash there is no escape).
"""

from __future__ import annotations

import json
import struct as _struct
from typing import Optional, Sequence

from ytsaurus_tpu_torch import yson
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.schema import EValueType as _EVT


def _to_jsonable(value):
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    if isinstance(value, dict):
        return {k: _to_jsonable(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_to_jsonable(v) for v in value]
    return value


def _dsv_escape(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\t", "\\t") \
        .replace("\n", "\\n").replace("=", "\\=")


def _dsv_unescape(text: str) -> str:
    if "\\" not in text:
        return text
    out = []
    i = 0
    while i < len(text):
        c = text[i]
        if c == "\\" and i + 1 < len(text):
            nxt = text[i + 1]
            out.append({"t": "\t", "n": "\n", "\\": "\\", "=": "="}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _dsv_split(text: str, sep: str) -> list[str]:
    """Split on unescaped separators (backslash escapes survive)."""
    if "\\" not in text:
        return text.split(sep)
    parts = []
    buf = []
    i = 0
    while i < len(text):
        c = text[i]
        if c == "\\" and i + 1 < len(text):
            buf.append(text[i:i + 2])
            i += 2
        elif c == sep:
            parts.append("".join(buf))
            buf = []
            i += 1
        else:
            buf.append(c)
            i += 1
    parts.append("".join(buf))
    return parts


def _dsv_split_kv(field: str) -> tuple[str, str]:
    """Split key=value on the first UNESCAPED '='."""
    if "\\" not in field:
        key, _, value = field.partition("=")
        return key, value
    i = 0
    while i < len(field):
        if field[i] == "\\":
            i += 2
        elif field[i] == "=":
            return field[:i], field[i + 1:]
        else:
            i += 1
    return field, ""


def _value_to_text(value) -> str:
    if value is None:
        return ""
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    if isinstance(value, bool):
        return "true" if value else "false"
    return str(value)


def dumps_rows(rows: Sequence[dict], format: str = "yson",
               columns: Optional[Sequence[str]] = None) -> bytes:
    """Serialize rows in the named format (list fragment semantics)."""
    if format == "yson":
        return b";".join(yson.dumps(row) for row in rows) + \
            (b";" if rows else b"")
    if format == "json":
        return b"\n".join(
            json.dumps(_to_jsonable(row), sort_keys=True).encode()
            for row in rows) + (b"\n" if rows else b"")
    if format == "dsv":
        lines = []
        for row in rows:
            fields = [f"{_dsv_escape(k)}={_dsv_escape(_value_to_text(v))}"
                      for k, v in row.items() if v is not None]
            lines.append("\t".join(fields))
        return ("\n".join(lines) + ("\n" if rows else "")).encode()
    if format == "schemaful_dsv":
        if not columns:
            raise YtError("schemaful_dsv requires a column list",
                          code=EErrorCode.QueryUnsupported)
        lines = []
        for row in rows:
            lines.append("\t".join(
                _dsv_escape(_value_to_text(row.get(c))) for c in columns))
        return ("\n".join(lines) + ("\n" if rows else "")).encode()
    raise YtError(f"Unknown format {format!r}",
                  code=EErrorCode.QueryUnsupported)


def loads_rows(data: bytes, format: str = "yson",
               columns: Optional[Sequence[str]] = None) -> list[dict]:
    """Parse rows from the named format."""
    if format == "yson":
        values = yson.loads(data, yson_type="list_fragment")
        for v in values:
            if not isinstance(v, dict):
                raise YtError(f"Expected map rows, got {type(v).__name__}")
        return values
    if format == "json":
        rows = []
        for line in data.splitlines():
            if line.strip():
                rows.append(json.loads(line))
        return rows
    if format == "dsv":
        rows = []
        for line in data.decode().splitlines():
            row = {}
            if line:
                for field in _dsv_split(line, "\t"):
                    if not field:
                        continue
                    key, value = _dsv_split_kv(field)
                    row[_dsv_unescape(key)] = _dsv_unescape(value)
            rows.append(row)
        return rows
    if format == "schemaful_dsv":
        if not columns:
            raise YtError("schemaful_dsv requires a column list",
                          code=EErrorCode.QueryUnsupported)
        rows = []
        for line in data.decode().splitlines():
            parts = line.split("\t")
            if len(parts) != len(columns):
                raise YtError(f"schemaful_dsv row width {len(parts)} != "
                              f"{len(columns)}")
            rows.append({c: _dsv_unescape(p)
                         for c, p in zip(columns, parts)})
        return rows
    raise YtError(f"Unknown format {format!r}",
                  code=EErrorCode.QueryUnsupported)


# --------------------------------------------------------------------- skiff
#
# Skiff (ref client/formats skiff + library/skiff): schema-driven binary row
# format — no per-value tags, so parsing is branch-light and rows are dense.
# Wire per row: uint16 table index, then each schema column in order:
#   optional columns: variant8 tag (0 = null, 1 = value) then the payload
#   int64/uint64:     8-byte LE
#   double:           8-byte LE IEEE
#   boolean:          1 byte
#   string:           uint32 LE length + bytes    ("string32")
#   any:              uint32 LE length + binary YSON ("yson32")


def _skiff_required(col) -> bool:
    return bool(col.required)


def dumps_skiff(rows: Sequence[dict], schema) -> bytes:
    out = bytearray()
    for row in rows:
        out += _struct.pack("<H", 0)             # table index
        for col in schema:
            value = row.get(col.name)
            if not _skiff_required(col):
                if value is None:
                    out.append(0)
                    continue
                out.append(1)
            elif value is None:
                raise YtError(f"Required column {col.name!r} is null",
                              code=EErrorCode.QueryTypeError)
            ty = col.type
            if ty in (_EVT.int64, _EVT.uint64):
                out += _struct.pack("<q" if ty is _EVT.int64 else "<Q",
                                    int(value))
            elif ty is _EVT.double:
                out += _struct.pack("<d", float(value))
            elif ty is _EVT.boolean:
                out.append(1 if value else 0)
            elif ty is _EVT.string:
                data = value.encode() if isinstance(value, str) else \
                    bytes(value)
                out += _struct.pack("<I", len(data)) + data
            elif ty is _EVT.any:
                blob = yson.dumps(value, binary=True)
                out += _struct.pack("<I", len(blob)) + blob
            else:
                raise YtError(f"Skiff cannot encode type {ty.value!r}",
                              code=EErrorCode.QueryUnsupported)
    return bytes(out)


def loads_skiff(data: bytes, schema) -> list[dict]:
    rows: list[dict] = []
    pos = 0
    n = len(data)
    def need(at: int, count: int, what: str) -> None:
        if at + count > n:
            raise YtError(f"Truncated skiff {what} at offset {at}",
                          code=EErrorCode.ChunkFormatError)

    while pos < n:
        need(pos, 2, "row header")
        (_table_index,) = _struct.unpack_from("<H", data, pos)
        pos += 2
        row: dict = {}
        for col in schema:
            if not _skiff_required(col):
                need(pos, 1, f"variant tag of {col.name!r}")
                tag = data[pos]
                pos += 1
                if tag == 0:
                    row[col.name] = None
                    continue
                if tag != 1:
                    raise YtError(f"Bad skiff variant tag {tag}",
                                  code=EErrorCode.ChunkFormatError)
            ty = col.type
            if ty in (_EVT.int64, _EVT.uint64):
                need(pos, 8, col.name)
                (row[col.name],) = _struct.unpack_from(
                    "<q" if ty is _EVT.int64 else "<Q", data, pos)
                pos += 8
            elif ty is _EVT.double:
                need(pos, 8, col.name)
                (row[col.name],) = _struct.unpack_from("<d", data, pos)
                pos += 8
            elif ty is _EVT.boolean:
                need(pos, 1, col.name)
                row[col.name] = bool(data[pos])
                pos += 1
            elif ty in (_EVT.string, _EVT.any):
                need(pos, 4, f"length of {col.name!r}")
                (length,) = _struct.unpack_from("<I", data, pos)
                pos += 4
                need(pos, length, f"payload of {col.name!r}")
                payload = bytes(data[pos:pos + length])
                pos += length
                row[col.name] = payload if ty is _EVT.string \
                    else yson.loads(payload)
            else:
                raise YtError(f"Skiff cannot decode type {ty.value!r}",
                              code=EErrorCode.QueryUnsupported)
        rows.append(row)
    return rows
