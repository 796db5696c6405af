"""YSON parser: text and binary, one-pass recursive descent.

Ref: yt/yt/core/yson/parser.h / pull_parser.h.

Own copy of the JAX package's parser. The text format's bare strings,
quoted-string runs and numbers are matched as whole runs by regular
expressions where the reference walks them byte by byte; the values and
the errors are the reference's.
"""

from __future__ import annotations

import re
import struct

from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.utils.varint import read_varint_u
from ytsaurus_tpu_torch.yson.types import YsonUint64, to_yson_type
from ytsaurus_tpu_torch.yson.writer import zigzag_decode

_BARE = set(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-%./")
# Runs the character loops below would walk byte by byte, matched whole:
# a bare string, the bytes of a quoted string up to its next quote or
# escape, and a number (the bytes `chr(b).isdigit()` accepts, which
# include a few superscripts above 127, and [.eE] with an optional sign).
_BARE_RUN = re.compile(b"[" + re.escape(bytes(sorted(_BARE))) + b"]*")
_QUOTED_RUN = re.compile(rb'[^"\\]*')
_NUMBER_START = frozenset(
    [b for b in range(256) if chr(b).isdigit()] + [ord("-"), ord("+")])
_NUMBER = re.compile(
    b"[+-]?(?:[" + re.escape(bytes(b for b in range(256)
                                     if chr(b).isdigit()))
    + rb"]|[.eE][+-]?)*")


class _Parser:
    def __init__(self, data: bytes, encoding: str | None = "utf-8"):
        self.data = data
        self.pos = 0
        self.encoding = encoding

    def error(self, message: str) -> YtError:
        ctx = self.data[max(0, self.pos - 15): self.pos + 15]
        return YtError(f"YSON parse error: {message} at byte {self.pos} "
                       f"(context {ctx!r})")

    # -- low level -------------------------------------------------------------

    def peek(self) -> int:
        self.skip_ws()
        if self.pos >= len(self.data):
            raise self.error("unexpected end of input")
        return self.data[self.pos]

    def skip_ws(self) -> None:
        data, pos = self.data, self.pos
        while pos < len(data) and data[pos] in b" \t\r\n":
            pos += 1
        self.pos = pos

    def expect(self, char: bytes) -> None:
        if self.peek() != char[0]:
            raise self.error(f"expected {char!r}")
        self.pos += 1

    def try_consume(self, char: bytes) -> bool:
        self.skip_ws()
        if self.pos < len(self.data) and self.data[self.pos] == char[0]:
            self.pos += 1
            return True
        return False

    def read_varint(self) -> int:
        try:
            value, self.pos = read_varint_u(self.data, self.pos)
        except ValueError:
            raise self.error("truncated varint")
        return value

    # -- values ----------------------------------------------------------------

    def parse_value(self):
        attributes = None
        c = self.peek()
        if c == 0x3C:                                       # '<'
            self.pos += 1
            attributes = self._parse_map_body(b">")
            c = self.peek()
        value = None
        # Binary markers.
        if c == 0x01:
            self.pos += 1
            length = self.read_varint()
            raw = self.data[self.pos:self.pos + length]
            if len(raw) != length:
                raise self.error("truncated binary string")
            self.pos += length
            value = self._decode_string(raw)
        elif c == 0x02:
            self.pos += 1
            value = zigzag_decode(self.read_varint())
        elif c == 0x03:
            self.pos += 1
            value = struct.unpack("<d", self.data[self.pos:self.pos + 8])[0]
            self.pos += 8
        elif c == 0x04:
            self.pos += 1
            value = False
        elif c == 0x05:
            self.pos += 1
            value = True
        elif c == 0x06:
            self.pos += 1
            value = YsonUint64(self.read_varint())
        elif c == 0x23:                                     # '#'
            self.pos += 1
            value = None
        elif c == 0x7B:                                     # '{'
            self.pos += 1
            value = self._parse_map_body(b"}")
        elif c == 0x5B:                                     # '['
            self.pos += 1
            value = self._parse_list_body()
        elif c == 0x22:                                     # '"'
            value = self._parse_quoted_string()
        elif c == 0x25:                                     # '%'
            value = self._parse_special()
        elif c in _NUMBER_START:
            value = self._parse_number()
        elif c in _BARE:
            value = self._parse_bare_string()
        else:
            raise self.error(f"unexpected byte {bytes([c])!r}")
        if attributes is not None:
            return to_yson_type(value, attributes)
        return value

    def _decode_string(self, raw: bytes):
        if self.encoding is None:
            return raw
        try:
            return raw.decode(self.encoding)
        except UnicodeDecodeError:
            return raw

    def _parse_map_body(self, closing: bytes) -> dict:
        result: dict = {}
        while not self.try_consume(closing):
            key = self.parse_value()
            if isinstance(key, bytes):
                key = key.decode("utf-8", "surrogateescape")
            if not isinstance(key, str):
                raise self.error(f"map key must be a string, got {key!r}")
            self.expect(b"=")
            result[key] = self.parse_value()
            if not self.try_consume(b";"):
                self.expect(closing)
                return result
        return result

    def _parse_list_body(self) -> list:
        result = []
        while not self.try_consume(b"]"):
            result.append(self.parse_value())
            if not self.try_consume(b";"):
                self.expect(b"]")
                return result
        return result

    def _parse_quoted_string(self):
        self.expect(b'"')
        out = bytearray()
        while True:
            run = _QUOTED_RUN.match(self.data, self.pos)
            out += run.group()
            self.pos = run.end()
            if self.pos >= len(self.data):
                raise self.error("unterminated string")
            b = self.data[self.pos]
            self.pos += 1
            if b == ord('"'):
                break
            if b == ord("\\"):
                esc = self.data[self.pos]
                self.pos += 1
                mapping = {ord("n"): 10, ord("t"): 9, ord("r"): 13,
                           ord("\\"): 92, ord('"'): 34, ord("0"): 0}
                if esc in mapping:
                    out.append(mapping[esc])
                elif esc == ord("x"):
                    out.append(int(self.data[self.pos:self.pos + 2], 16))
                    self.pos += 2
                else:
                    out.append(esc)
            else:
                out.append(b)
        return self._decode_string(bytes(out))

    def _parse_bare_string(self):
        start = self.pos
        self.pos = _BARE_RUN.match(self.data, start).end()
        return self._decode_string(self.data[start:self.pos])

    def _parse_special(self):
        for literal, value in ((b"%true", True), (b"%false", False),
                               (b"%nan", float("nan")), (b"%-inf", float("-inf")),
                               (b"%inf", float("inf"))):
            if self.data.startswith(literal, self.pos):
                self.pos += len(literal)
                return value
        raise self.error("unknown % literal")

    def _parse_number(self):
        start = self.pos
        self.pos = _NUMBER.match(self.data, start).end()
        text = self.data[start:self.pos]
        is_double = b"." in text or b"e" in text or b"E" in text
        if self.pos < len(self.data) and self.data[self.pos] in b"uU":
            self.pos += 1
            return YsonUint64(int(text))
        if is_double:
            return float(text)
        return int(text)


def loads(data: bytes | str, encoding: str | None = "utf-8",
          yson_type: str = "node"):
    """Parse one YSON value (or a list of values for yson_type='list_fragment')."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    parser = _Parser(data, encoding=encoding)
    try:
        if yson_type == "list_fragment":
            values = []
            parser.skip_ws()
            while parser.pos < len(parser.data):
                values.append(parser.parse_value())
                parser.try_consume(b";")
                parser.skip_ws()
            return values
        value = parser.parse_value()
        parser.skip_ws()
        if parser.pos != len(parser.data):
            raise parser.error("trailing data")
        return value
    except YtError:
        raise
    except (IndexError, ValueError, struct.error, OverflowError) as e:
        # Malformed input must surface as a parse error, not a raw exception.
        raise parser.error(f"malformed input ({type(e).__name__}: {e})")
