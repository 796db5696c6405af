"""Framed multipart packet codec.

Wire layout (all little-endian), after the reference's multipart-with-
checksums idea (core/bus/tcp/packet.h:9) but a fresh, minimal format:

    u32 magic          0x59545042 ("YTPB")
    u32 part_count     (< 65536)
    u64 x part_count   part lengths
    u64 x part_count   part CRC-64s (native codec, utils CRC fallback)
    bytes              parts, concatenated

Part 0 is the envelope (binary YSON), part 1 the body (binary YSON),
parts 2+ raw attachments.  Corruption anywhere fails the whole packet.

Own copy of the JAX package's `rpc/packet.py`: with the host codec library
loaded in both packages (`native.lib()`), a packet is the reference's byte
for byte. The numpy fallback's checksum carries a tag bit, so a packet
from a fallback peer fails the other side's check instead of passing.
"""

from __future__ import annotations

import asyncio
import struct

from ytsaurus_tpu_torch.native import checksum

MAGIC = 0x59545042
MAX_PARTS = 65536
MAX_PART_SIZE = 1 << 33        # 8 GiB hard cap per part

_HEAD = struct.Struct("<II")


class PacketError(Exception):
    """Malformed or corrupted packet — the connection must be dropped."""


def encode_packet(parts: list[bytes]) -> bytes:
    if len(parts) >= MAX_PARTS:
        raise PacketError(f"too many parts ({len(parts)})")
    out = bytearray(_HEAD.pack(MAGIC, len(parts)))
    for p in parts:
        out += struct.pack("<Q", len(p))
    for p in parts:
        out += struct.pack("<Q", checksum(bytes(p)))
    for p in parts:
        out += p
    return bytes(out)


async def write_packet(writer: asyncio.StreamWriter,
                       parts: list[bytes]) -> None:
    writer.write(encode_packet(parts))
    await writer.drain()


async def read_packet(reader: asyncio.StreamReader) -> list[bytes]:
    head = await reader.readexactly(_HEAD.size)
    magic, count = _HEAD.unpack(head)
    if magic != MAGIC:
        raise PacketError(f"bad magic {magic:#x}")
    if count >= MAX_PARTS:
        raise PacketError(f"bad part count {count}")
    meta = await reader.readexactly(16 * count)
    lengths = struct.unpack(f"<{count}Q", meta[: 8 * count])
    crcs = struct.unpack(f"<{count}Q", meta[8 * count:])
    for ln in lengths:
        if ln > MAX_PART_SIZE:
            raise PacketError(f"part too large ({ln})")
    parts = []
    for ln, crc in zip(lengths, crcs):
        data = await reader.readexactly(ln)
        if checksum(data) != crc:
            raise PacketError("part checksum mismatch")
        parts.append(data)
    return parts
