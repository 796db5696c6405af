"""YSON writer: text and binary formats.

Ref: yt/yt/core/yson/writer.h.  Binary markers: 0x01 string (varint byte
length), 0x02 int64 (zigzag varint), 0x03 double (8 LE bytes), 0x04 false,
0x05 true, 0x06 uint64 (varint).

Own copy of the JAX package's writer; a text string is checked for the
bare form and escaped by regular expressions where the reference walks it
byte by byte: the same bytes.
"""

from __future__ import annotations

import math
import re
import struct

from ytsaurus_tpu_torch.yson.types import (
    YsonBoolean,
    YsonEntity,
    YsonUint64,
    get_attributes,
)

_STRING_MARKER = b"\x01"
_INT64_MARKER = b"\x02"
_DOUBLE_MARKER = b"\x03"
_FALSE_MARKER = b"\x04"
_TRUE_MARKER = b"\x05"
_UINT64_MARKER = b"\x06"

_BARE_OK = set(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-%./")
_BARE_STRING = re.compile(b"[" + re.escape(bytes(sorted(_BARE_OK))) + b"]+")
# The escape of each byte a quoted string cannot hold as it is.
_ESCAPES = {b: (b"\\" + bytes([b]) if b in b'"\\' else
                {10: b"\\n", 9: b"\\t", 13: b"\\r"}.get(b, b"\\x%02x" % b))
            for b in range(256) if b in b'"\\' or not 32 <= b < 127}
_NEEDS_ESCAPE = re.compile(b"[" + re.escape(bytes(sorted(_ESCAPES))) + b"]")


from ytsaurus_tpu_torch.utils.varint import write_varint_u as _write_varint  # noqa: E402


def zigzag_encode(value: int) -> int:
    return (value << 1) if value >= 0 else ((-value) << 1) - 1


def zigzag_decode(value: int) -> int:
    return (value >> 1) if (value & 1) == 0 else -((value + 1) >> 1)


class _Writer:
    def __init__(self, binary: bool, indent: int | None = None):
        self.binary = binary
        self.out = bytearray()
        self.indent = indent

    # -- scalars ---------------------------------------------------------------

    def write(self, value):
        attrs = get_attributes(value)
        if attrs:
            self.out += b"<"
            self._write_map_body(attrs)
            self.out += b">"
        if value is None or isinstance(value, YsonEntity):
            self.out += b"#"
        elif isinstance(value, (bool, YsonBoolean)):
            if self.binary:
                self.out += _TRUE_MARKER if value else _FALSE_MARKER
            else:
                self.out += b"%true" if value else b"%false"
        elif isinstance(value, YsonUint64):
            if self.binary:
                self.out += _UINT64_MARKER
                _write_varint(self.out, int(value))
            else:
                self.out += str(int(value)).encode() + b"u"
        elif isinstance(value, int):
            if not (-(2**63) <= value < 2**64):
                raise ValueError(f"Integer out of YSON range: {value}")
            if value >= 2**63:
                self.write(YsonUint64(value))
            elif self.binary:
                self.out += _INT64_MARKER
                _write_varint(self.out, zigzag_encode(value))
            else:
                self.out += str(value).encode()
        elif isinstance(value, float):
            if self.binary:
                self.out += _DOUBLE_MARKER + struct.pack("<d", value)
            elif math.isnan(value):
                self.out += b"%nan"
            elif math.isinf(value):
                self.out += b"%inf" if value > 0 else b"%-inf"
            else:
                text = repr(value).encode()
                if b"." not in text and b"e" not in text and b"E" not in text \
                        and b"n" not in text:
                    text += b"."
                self.out += text
        elif isinstance(value, (bytes, str)):
            self._write_string(value)
        elif isinstance(value, dict):
            self.out += b"{"
            self._write_map_body(value)
            self.out += b"}"
        elif isinstance(value, (list, tuple)):
            self.out += b"["
            for i, item in enumerate(value):
                if i:
                    self.out += b";"
                self.write(item)
            self.out += b"]"
        else:
            raise TypeError(f"Cannot serialize {type(value).__name__} to YSON")

    def _write_string(self, value) -> None:
        raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        if self.binary:
            self.out += _STRING_MARKER
            _write_varint(self.out, len(raw))
            self.out += raw
        elif raw and _BARE_STRING.fullmatch(raw) and \
                not raw[0:1].isdigit() and raw not in (b"%true", b"%false") \
                and not raw.startswith(b"%") and not raw.startswith(b"-"):
            self.out += raw
        else:
            self.out += b'"'
            self.out += _NEEDS_ESCAPE.sub(lambda m: _ESCAPES[m.group()[0]],
                                          raw)
            self.out += b'"'

    def _write_map_body(self, mapping: dict) -> None:
        first = True
        for key, item in mapping.items():
            if not first:
                self.out += b";"
            first = False
            self._write_string(key)
            self.out += b"="
            self.write(item)


def dumps(value, binary: bool = False) -> bytes:
    writer = _Writer(binary=binary)
    writer.write(value)
    return bytes(writer.out)
