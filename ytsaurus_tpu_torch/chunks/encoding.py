"""Chunk wire format: columnar serialization with per-block checksums.

Port of the JAX package's `chunks/encoding.py`. The port writes the
reference's format, byte for byte for the same chunk and codec, and reads
the reference's blobs:

  MAGIC 'YTC1' | varint meta_len | meta (binary YSON) | block bytes...

Meta: schema, row_count, codec name, per-column block descriptors
(offset/compressed size/raw size/checksum), the column statistics sealed
at write time, and the hunk chunk ids. Encodings by logical type:
  int64/uint64  delta + zigzag varint (uint64 planes are int64 bit
                patterns on both sides, so the blocks match)
  double        raw 8-byte LE planes
  boolean       bit-packed
  string        int32 codes as delta varint + vocabulary block (tagged
                entries: inline bytes or hunk ref)
  vector        raw float32 LE (n, dim) plane
  validity      bit-packed bitmap per column
Checksums are CRC-64 through the native library (`native/`).

Differences from the reference: a plane is read to the host with one
device → host copy per plane; `deserialize_chunk(..., device=)` decodes
each column into a padded numpy plane, then makes one host → device copy
per plane onto `device` (default "cuda"; without a card it raises),
timed to the copies' end on the device. The host seconds of the two
steps are summed apart in the `chunks/decode` sensors (`decode_seconds`,
`copy_seconds`, `bytes_copied`, `chunks`) and, given a query's
statistics, in its `decode_time`, `copy_time` and `bytes_staged`.
The columns are encoded (statistics, varints, compression, checksums) and
decoded on a small shared thread pool, one task per column: zlib, numpy
and the codec library release the interpreter lock, so a chunk of many
millions of rows takes a fraction of the sequential host time. The
blocks are laid out in schema order, so the bytes do not change.
An `any` column writes an empty data block and its payloads as one
binary YSON list in the aux block, as the reference does.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ytsaurus_tpu_torch import native, yson
from ytsaurus_tpu_torch.chunks.columnar import (
    Column,
    ColumnarChunk,
    _np_plane_dtype,
    column_stats,
    pad_capacity,
)
from ytsaurus_tpu_torch.chunks.compression import get_codec
from ytsaurus_tpu_torch.chunks.hunks import HunkRef, hunkify_vocab, resolve_vocab
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.schema import EValueType, TableSchema, VectorType
from ytsaurus_tpu_torch.utils.profiling import Profiler
from ytsaurus_tpu_torch.utils.tracing import stage
from ytsaurus_tpu_torch.utils.varint import (
    encode_varint_u as _encode_varint_u,
    read_varint_u as _decode_varint_u,
)

MAGIC = b"YTC1"
DEFAULT_CODEC = "zlib_6"

_decode_profiler = Profiler("chunks/decode")
_DECODE_SECONDS = _decode_profiler.counter("decode_seconds")
_COPY_SECONDS = _decode_profiler.counter("copy_seconds")
_BYTES_COPIED = _decode_profiler.counter("bytes_copied")
_CHUNKS = _decode_profiler.counter("chunks")


_pool_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None


def _map(fn, items) -> list:
    """fn over items on the codec thread pool (created at first use), in
    order; the first task's exception is raised here."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                       thread_name_prefix="chunk-codec")
    return list(_pool.map(fn, items))


def decode_totals() -> dict:
    """Process totals of `deserialize_chunk`: host seconds decoding blocks
    into padded numpy planes, host seconds copying them onto the device,
    the bytes copied, and the chunks decoded."""
    return {"decode_seconds": _DECODE_SECONDS.get(),
            "copy_seconds": _COPY_SECONDS.get(),
            "bytes_copied": int(_BYTES_COPIED.get()),
            "chunks": int(_CHUNKS.get())}


def _encode_column(col: Column, ty, n: int) -> tuple[bytes, bytes]:
    """Returns (data_block, aux_block) raw bytes; aux = vocab payload."""
    data = col.data[:n].cpu().numpy()
    aux = b""
    if isinstance(ty, VectorType):
        # Contiguous raw float32 LE (n, dim) plane — already fixed
        # width, so no per-row framing; dim rides in the schema.
        block = data.astype("<f4").tobytes()
    elif ty in (EValueType.int64, EValueType.uint64):
        block = native.varint_encode(
            native.delta_encode(data.astype(np.int64)))
    elif ty is EValueType.double:
        block = data.astype("<f8").tobytes()
    elif ty is EValueType.boolean:
        block = native.bitmap_pack(data.astype(np.uint8))
    elif ty is EValueType.string:
        block = native.varint_encode(
            native.delta_encode(data.astype(np.int64)))
        vocab = col.dictionary if col.dictionary is not None else \
            np.array([], dtype=object)
        # Tagged entries: 0 = inline bytes, 1 = hunk ref (id, length).
        parts = [_encode_varint_u(len(vocab))]
        for v in vocab:
            if isinstance(v, HunkRef):
                hid = v.hunk_id.encode()
                parts.append(b"\x01")
                parts.append(_encode_varint_u(len(hid)))
                parts.append(hid)
                parts.append(_encode_varint_u(v.length))
            else:
                parts.append(b"\x00")
                parts.append(_encode_varint_u(len(v)))
                parts.append(bytes(v))
        aux = b"".join(parts)
    elif ty is EValueType.any:
        block = b""
        values = (col.host_values or [])[:n]
        aux = yson.dumps([None if v is None else v for v in values],
                         binary=True)
    elif ty is EValueType.null:
        block = b""
    else:
        raise YtError(f"Cannot encode column type {ty.value}",
                      code=EErrorCode.ChunkFormatError)
    return block, aux


def _decode_column(ty, data_block: bytes, aux_block: bytes, n: int,
                   format_version: int = 2
                   ) -> tuple[np.ndarray, Optional[np.ndarray],
                              Optional[list]]:
    """The column's first n values as a host plane, its vocabulary, and
    the payloads of an `any` column."""
    dictionary = None
    host_values = None
    if isinstance(ty, VectorType):
        flat = np.frombuffer(data_block, dtype="<f4", count=n * ty.dim)
        plane = flat.reshape(n, ty.dim)
    elif ty in (EValueType.int64, EValueType.uint64):
        # uint64 planes are int64 bit patterns in the port.
        plane = native.delta_decode(native.varint_decode(data_block, n))
    elif ty is EValueType.double:
        plane = np.frombuffer(data_block, dtype="<f8", count=n)
    elif ty is EValueType.boolean:
        plane = native.bitmap_unpack(data_block, n)
    elif ty is EValueType.string:
        values = native.delta_decode(native.varint_decode(data_block, n))
        plane = values.astype(np.int32)
        count, pos = _decode_varint_u(aux_block, 0)
        vocab = []
        for _ in range(count):
            if format_version >= 2:
                tag = aux_block[pos]
                pos += 1
            else:
                tag = 0                     # v1: untagged inline entries
            if tag == 0:
                length, pos = _decode_varint_u(aux_block, pos)
                vocab.append(aux_block[pos:pos + length])
                pos += length
            elif tag == 1:
                id_len, pos = _decode_varint_u(aux_block, pos)
                hid = aux_block[pos:pos + id_len].decode()
                pos += id_len
                length, pos = _decode_varint_u(aux_block, pos)
                vocab.append(HunkRef(hunk_id=hid, length=length))
            else:
                raise YtError(f"Bad vocab entry tag {tag}",
                              code=EErrorCode.ChunkFormatError)
        dictionary = np.empty(count, dtype=object)
        dictionary[:] = vocab
    elif ty is EValueType.any:
        # utf-8 decode so str payloads round-trip as str (bytes that are
        # not valid utf-8 stay bytes — the YSON wire format cannot
        # distinguish).
        host_values = list(yson.loads(aux_block)) if aux_block else []
        plane = np.zeros(n, dtype=_np_plane_dtype(ty))
    elif ty is EValueType.null:
        plane = np.zeros(n, dtype=_np_plane_dtype(ty))
    else:
        raise YtError(f"Cannot decode column type {ty.value}",
                      code=EErrorCode.ChunkFormatError)
    return plane, dictionary, host_values


def serialize_chunk(chunk: ColumnarChunk, codec: str = DEFAULT_CODEC,
                    hunk_store=None) -> bytes:
    """hunk_store: when given, string-column vocab entries whose column
    schema sets max_inline_hunk_size move out-of-row into content-addressed
    hunk blobs (ref hunks.h); their ids land in meta["hunk_chunk_ids"]."""
    compress, _ = get_codec(codec)
    n = chunk.row_count

    def encode(col_schema) -> tuple:
        """(hunk ids, [(compressed, raw size, checksum)] for the data, aux
        and valid blocks, the column's statistics)."""
        col = chunk.columns[col_schema.name]
        stats = column_stats(col, n)
        ids: list = []
        if hunk_store is not None and \
                col_schema.max_inline_hunk_size is not None and \
                col.dictionary is not None:
            vocab, ids = hunkify_vocab(hunk_store, col.dictionary,
                                       col_schema.max_inline_hunk_size)
            col = replace(col, dictionary=vocab)
        data_block, aux_block = _encode_column(col, col_schema.type, n)
        valid_block = native.bitmap_pack(
            col.valid[:n].cpu().numpy().astype(np.uint8))
        return ids, [(compress(raw), len(raw), native.checksum(raw))
                     for raw in (data_block, aux_block, valid_block)], stats

    encoded = _map(encode, list(chunk.schema))
    blocks: list[bytes] = []
    columns_meta = []
    hunk_chunk_ids: set[str] = set()
    stats_by_name: dict = {}
    offset = 0
    for col_schema, (ids, packed, stats) in zip(chunk.schema, encoded):
        hunk_chunk_ids.update(ids)
        stats_by_name[col_schema.name] = stats
        descs = []
        for compressed, raw_size, checksum in packed:
            blocks.append(compressed)
            descs.append({
                "offset": offset,
                "size": len(compressed),
                "raw_size": raw_size,
                "checksum": yson.YsonUint64(checksum),
            })
            offset += len(compressed)
        columns_meta.append({"name": col_schema.name, "data": descs[0],
                             "aux": descs[1], "valid": descs[2]})
    # The statistics in the order of the chunk's columns, as
    # chunk_column_stats gives them.
    column_stats_meta: dict = {}
    for name, col in chunk.columns.items():
        entry = stats_by_name[name] if name in stats_by_name \
            else column_stats(col, n)
        if entry is not None:
            column_stats_meta[name] = entry
    column_stats_meta["$row_count"] = n

    meta = {
        # v2: tagged string-vocab entries (inline | hunk ref); v1 readable.
        "format_version": 2,
        "codec": codec,
        "row_count": n,
        "schema": chunk.schema.to_dict(),
        "columns": columns_meta,
        # Per-column min/max/has_null computed ONCE at seal time; scan
        # pruning and tablet snapshot-cache keying read them from the
        # meta header (no block decompress, no host recompute).
        "column_stats": column_stats_meta,
    }
    if hunk_chunk_ids:
        meta["hunk_chunk_ids"] = sorted(hunk_chunk_ids)
    meta_blob = yson.dumps(meta, binary=True)
    return b"".join([MAGIC, _encode_varint_u(len(meta_blob)), meta_blob]
                    + blocks)


def read_chunk_meta(blob: bytes) -> dict:
    if blob[:4] != MAGIC:
        raise YtError("Bad chunk magic", code=EErrorCode.ChunkFormatError)
    meta_len, pos = _decode_varint_u(blob, 4)
    meta = yson.loads(blob[pos:pos + meta_len])
    meta["_data_start"] = pos + meta_len
    return meta


def _decode_host(blob: bytes, capacity: Optional[int], hunk_store
                 ) -> tuple:
    """(schema, row count, [(name, type, padded plane, padded validity,
    vocabulary, `any` payloads)] in the blob's column order): every block
    inflated, checked and decoded on the codec pool."""
    meta = read_chunk_meta(blob)
    _, decompress = get_codec(meta["codec"])
    start = meta["_data_start"]
    n = meta["row_count"]
    cap = capacity or pad_capacity(max(n, 1))
    schema = TableSchema.from_dict(meta["schema"])

    def read_block(desc: dict) -> bytes:
        lo = start + desc["offset"]
        try:
            raw = decompress(bytes(blob[lo:lo + desc["size"]]))
        except Exception as e:
            raise YtError(f"Chunk block decompression failed: {e}",
                          code=EErrorCode.ChunkFormatError)
        if len(raw) != desc["raw_size"]:
            raise YtError("Chunk block size mismatch",
                          code=EErrorCode.ChunkFormatError)
        if native.checksum(raw) != int(desc["checksum"]):
            raise YtError("Chunk block checksum mismatch",
                          code=EErrorCode.ChunkFormatError)
        return raw

    has_hunks = bool(meta.get("hunk_chunk_ids"))
    format_version = int(meta.get("format_version", 1))

    def decode(col_meta: dict) -> tuple:
        """(name, type, padded plane, padded validity, vocabulary, `any`
        payloads)."""
        name = col_meta["name"]
        ty = schema.get(name).type
        valid = native.bitmap_unpack(read_block(col_meta["valid"]), n)
        plane, dictionary, host_values = _decode_column(
            ty, read_block(col_meta["data"]), read_block(col_meta["aux"]),
            n, format_version=format_version)
        if isinstance(ty, VectorType) and n and \
                not np.isfinite(plane[valid[:n]]).all():
            raise YtError("Non-finite vector component in chunk block",
                          code=EErrorCode.ChunkFormatError)
        if has_hunks and dictionary is not None and \
                any(isinstance(v, HunkRef) for v in dictionary):
            dictionary = resolve_vocab(hunk_store, dictionary)
        full = np.zeros((cap,) + plane.shape[1:], dtype=_np_plane_dtype(ty))
        full[:n] = plane
        full_valid = np.zeros(cap, dtype=bool)
        full_valid[:n] = valid
        if host_values is not None:
            host_values += [None] * (cap - n)
        return name, ty, full, full_valid, dictionary, host_values

    try:
        return schema, n, _map(decode, list(meta["columns"]))
    except (ValueError, IndexError, KeyError) as e:
        raise YtError(f"Chunk decode failed: {e}",
                      code=EErrorCode.ChunkFormatError)


def deserialize_chunk(blob: bytes,
                      capacity: Optional[int] = None,
                      hunk_store=None,
                      device: "str | torch.device" = DEFAULT_DEVICE,
                      stats=None) -> ColumnarChunk:
    """The blob's chunk on `device`: decoded into host planes (the
    `chunk.decode` span and profiler range), then copied plane by plane
    (`chunk.copy`), the copy timed to its end on the device. `stats` (a
    QueryStatistics) gets the two phases' seconds and the bytes copied."""
    dev = resolve_device(device)
    with stage(None, None, "chunk.decode"):
        t0 = time.perf_counter()
        schema, n, host = _decode_host(blob, capacity, hunk_store)
        t1 = time.perf_counter()
    with stage(None, None, "chunk.copy"):
        columns: dict[str, Column] = {}
        copied = 0
        for name, ty, full, full_valid, dictionary, host_values in host:
            columns[name] = Column(
                type=ty, data=torch.from_numpy(full).to(dev),
                valid=torch.from_numpy(full_valid).to(dev),
                dictionary=dictionary, host_values=host_values)
            copied += full.nbytes + full_valid.nbytes
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        t2 = time.perf_counter()
    _DECODE_SECONDS.increment(t1 - t0)
    _COPY_SECONDS.increment(t2 - t1)
    _BYTES_COPIED.increment(copied)
    _CHUNKS.increment()
    if stats is not None:
        stats.add_miss_path(decode_time=t1 - t0, copy_time=t2 - t1,
                            bytes_staged=copied)
    return ColumnarChunk(schema=schema, row_count=n, columns=columns)
