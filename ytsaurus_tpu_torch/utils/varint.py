"""Unsigned-LEB128 varint helpers for YSON and chunk metas.

Own copy of the JAX package's `utils/varint.py`; the native library
(`native/`) has its own vectorized zigzag codec for column planes."""

from __future__ import annotations


def write_varint_u(out: bytearray, value: int) -> None:
    if value < 0:
        raise ValueError("varint_u requires a non-negative value")
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return


def encode_varint_u(value: int) -> bytes:
    out = bytearray()
    write_varint_u(out, value)
    return bytes(out)


def read_varint_u(data: bytes, pos: int) -> tuple[int, int]:
    """Returns (value, new_pos); raises ValueError on truncation."""
    result = 0
    shift = 0
    n = len(data)
    while True:
        if pos >= n:
            raise ValueError("truncated varint")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long (more than 64 bits)")
