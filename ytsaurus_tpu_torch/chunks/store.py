"""Chunk store: chunk files on a filesystem + a cache of decoded chunks.

Port of the JAX package's `chunks/store.py` (`FsChunkStore`: atomic write,
read, meta, `read_stats` with the sketch backfill, verify, quarantine,
remove, list; `ChunkCache`: byte budget, pin, unpin, invalidate), with
the same failpoint sites (`chunks.store.read`, `.write`, `.decode`,
`.remove`, `chunks.erasure.part_read`).

Ref mapping: data node chunk storage (server/node/data_node/blob_chunk.h,
chunk_store.h) collapses to a host-side store whose unit is the whole
columnar chunk; the cache holds decoded chunks, the analog of the tablet
node's in-memory mode (tablet_node/in_memory_manager.h) at `uncompressed`
level. A chunk written with `erasure=` is stored as the codec's part files
plus a binary YSON meta file `{"codec", "size"}` (`chunks/erasure.py`),
byte for byte the reference's layout, so each package reads the other's.
A read takes the data parts only; on damage it reads parity, decodes
under the `chunk.erasure_repair` span and rewrites the lost parts
(repair on read); the `chunks/erasure_repair` sensors sum the repairs,
their decode and re-encode seconds and the parts rewritten
(`repair_totals()`).

Differences from the reference: reads decode onto an explicit device
(`read_chunk(..., device=)`; a `ChunkCache` decodes onto its own device,
default "cuda", which raises without a card). A cached chunk's bytes are
`numel() * element_size()` of its planes. When a read of an erasure chunk
finds exactly one data part lost and the codec has a locality group for
it (LRC), it reads only that group's local parity and XOR-repairs the
part; the reference reads every parity part there. It rebuilds the
other parity parts whose files are gone (found by a stat, not a read),
so the files after the read are the reference's; a parity part that
exists but cannot be read stays until a read needs it. The repair
rewrites only the lost parts (`ErasureCodec.encode_parts`) where the
reference re-encodes all of them and writes the lost ones: the same
bytes on disk.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import OrderedDict
from typing import Optional

import torch

from ytsaurus_tpu_torch import yson
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk, chunk_column_stats
from ytsaurus_tpu_torch.chunks.encoding import (
    DEFAULT_CODEC,
    deserialize_chunk,
    read_chunk_meta,
    serialize_chunk,
)
from ytsaurus_tpu_torch.chunks.erasure import get_erasure_codec
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.utils import failpoints, sanitizers
from ytsaurus_tpu_torch.utils.profiling import Profiler
from ytsaurus_tpu_torch.utils.tracing import child_span

# Fault sites on every disk boundary: disk-shaped failures are OSErrors
# so the read ladders above this layer treat injected faults exactly like
# a dying location.
_FP_READ = failpoints.register_site(
    "chunks.store.read",
    error=lambda s: OSError(f"injected read failure at {s}"))
_FP_WRITE = failpoints.register_site(
    "chunks.store.write",
    error=lambda s: OSError(f"injected write failure at {s}"))
_FP_DECODE = failpoints.register_site(
    "chunks.store.decode",
    error=lambda s: YtError(f"injected decode failure at {s}",
                            code=EErrorCode.ChunkFormatError))
_FP_PART_READ = failpoints.register_site(
    "chunks.erasure.part_read",
    error=lambda s: OSError(f"injected part loss at {s}"))
_FP_REMOVE = failpoints.register_site(
    "chunks.store.remove",
    error=lambda s: OSError(f"injected remove failure at {s}"))


_repair_profiler = Profiler("chunks/erasure_repair")
_REPAIRS = _repair_profiler.counter("repairs")
_REPAIR_DECODE_SECONDS = _repair_profiler.counter("decode_seconds")
_REPAIR_ENCODE_SECONDS = _repair_profiler.counter("encode_seconds")
_PARTS_REWRITTEN = _repair_profiler.counter("parts_rewritten")


def repair_totals() -> dict:
    """Process totals of erasure repair on read: the reads that repaired,
    host seconds rebuilding the data (XOR or GF decode) and re-encoding
    the lost parts, and the parts rewritten."""
    return {"repairs": int(_REPAIRS.get()),
            "decode_seconds": _REPAIR_DECODE_SECONDS.get(),
            "encode_seconds": _REPAIR_ENCODE_SECONDS.get(),
            "parts_rewritten": int(_PARTS_REWRITTEN.get())}


def _stats_missing_sketch(stats: dict) -> bool:
    """True when a sealed column_stats payload predates the NDV sketch
    (read_stats then decode-backfills it like the pre-stats path)."""
    return any(isinstance(entry, dict) and "ndv_sketch" not in entry
               for name, entry in stats.items() if name != "$row_count")


def _codec_name(name) -> str:
    """A codec name read back from a meta file may be bytes."""
    return name.decode() if isinstance(name, bytes) else name


def _tag_repair(span, lost: list, parts_read: int, local: bool) -> None:
    span.add_tag("lost_parts", len(lost))
    span.add_tag("parts_read", parts_read)
    span.add_tag("local", local)


def _count_repair(t0: float, t1: float, parts: int) -> None:
    """Sensors of one repair: decoded over [t0, t1), re-encoded since."""
    _REPAIRS.increment()
    _REPAIR_DECODE_SECONDS.increment(t1 - t0)
    _REPAIR_ENCODE_SECONDS.increment(time.perf_counter() - t1)
    _PARTS_REWRITTEN.increment(parts)


def new_chunk_id() -> str:
    return uuid.uuid4().hex


class FsChunkStore:
    """Chunks as files under root/<id[:2]>/<id>.chunk."""

    # Bounded FIFO memo of per-chunk column stats: chunks are immutable,
    # so an entry never goes stale; removal just leaves a dead key that
    # ages out.
    _STATS_MEMO_LIMIT = 4096

    def __init__(self, root: str, codec: str = DEFAULT_CODEC):
        self.root = root
        self.codec = codec
        os.makedirs(root, exist_ok=True)
        # guards: _stats_memo
        self._lock = sanitizers.register_lock("chunks.FsChunkStore._lock")
        self._stats_memo: "OrderedDict[str, dict]" = OrderedDict()

    def _path(self, chunk_id: str) -> str:
        return os.path.join(self.root, chunk_id[:2], f"{chunk_id}.chunk")

    def _part_path(self, chunk_id: str, index: int) -> str:
        return os.path.join(self.root, chunk_id[:2],
                            f"{chunk_id}.part{index}")

    def _erasure_meta_path(self, chunk_id: str) -> str:
        return os.path.join(self.root, chunk_id[:2], f"{chunk_id}.erasure")

    def write_chunk(self, chunk: ColumnarChunk,
                    chunk_id: Optional[str] = None,
                    codec: Optional[str] = None,
                    erasure: Optional[str] = None) -> str:
        chunk_id = chunk_id or new_chunk_id()
        blob = serialize_chunk(chunk, codec or self.codec, hunk_store=self)
        return self.put_blob(chunk_id, blob, erasure=erasure)

    def _atomic_write(self, path: str, blob: bytes) -> None:
        # torn-write injection truncates the payload AND fails the write
        # after the torn bytes hit the tmp file: the rename below never
        # runs, so readers can only ever see the previous complete state
        # — the atomicity this staging protocol exists to provide.
        blob, torn = _FP_WRITE.write_hit(blob)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        if torn:
            raise OSError(f"injected torn write: {path} "
                          "(torn tmp left unpublished)")
        os.replace(tmp, path)      # atomic publish

    def _write_erasure(self, chunk_id: str, blob: bytes,
                       erasure: str) -> str:
        """Erasure-coded layout: k+m part files + a small meta file (ref:
        striped erasure writer, ytlib/chunk_client/striped_erasure_writer.h)."""
        parts = get_erasure_codec(erasure).encode(blob)
        os.makedirs(os.path.dirname(self._path(chunk_id)), exist_ok=True)
        for i, part in enumerate(parts):
            self._atomic_write(self._part_path(chunk_id, i), part)
        self._atomic_write(self._erasure_meta_path(chunk_id), yson.dumps(
            {"codec": erasure, "size": len(blob)}, binary=True))
        return chunk_id

    def put_blob(self, chunk_id: str, blob: bytes,
                 erasure: Optional[str] = None) -> str:
        """Store an already-serialized chunk blob (whole, or as the parts of
        the erasure codec named)."""
        if erasure is not None:
            return self._write_erasure(chunk_id, blob, erasure)
        path = self._path(chunk_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._atomic_write(path, blob)
        return chunk_id

    def get_blob(self, chunk_id: str) -> bytes:
        return self._read_blob(chunk_id)

    def read_chunk(self, chunk_id: str,
                   device: "str | torch.device" = DEFAULT_DEVICE
                   ) -> ColumnarChunk:
        with child_span("chunk.read", chunk_id=chunk_id,
                        location=self.root):
            _FP_DECODE.hit()
            return deserialize_chunk(self._read_blob(chunk_id),
                                     hunk_store=self, device=device)

    def read_meta(self, chunk_id: str) -> dict:
        return read_chunk_meta(self._read_blob(chunk_id))

    def read_stats(self, chunk_id: str,
                   backfill_sketch: bool = False) -> dict:
        """Per-column min/max/has_null (+ NDV sketch) pruning stats.

        Written-at-seal chunks carry them in the meta header (one blob
        read, no block decompress). BACKFILL: chunks persisted before
        stats existed decode once (on the host), compute host-side, and
        memoize. Chunks sealed WITH stats but before the NDV sketch joined
        them decode-backfill the same way only when `backfill_sketch`
        asks for it: metadata-only consumers ($timestamp reads, bounds
        pruning) never pay a full chunk decode for a sketch they do not
        read."""
        with self._lock:
            stats = self._stats_memo.get(chunk_id)
            if stats is not None and not (backfill_sketch
                                          and _stats_missing_sketch(stats)):
                return stats
        stats = self.read_meta(chunk_id).get("column_stats")
        if stats is None or (backfill_sketch
                             and _stats_missing_sketch(stats)):
            stats = chunk_column_stats(self.read_chunk(chunk_id,
                                                       device="cpu"))
        with self._lock:
            self._stats_memo[chunk_id] = stats
            while len(self._stats_memo) > self._STATS_MEMO_LIMIT:
                self._stats_memo.popitem(last=False)
        return stats

    def _read_blob(self, chunk_id: str) -> bytes:
        _FP_READ.hit()
        path = self._path(chunk_id)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            pass
        blob = self._read_erasure_blob(chunk_id)
        if blob is None:
            raise YtError(f"No such chunk {chunk_id}",
                          code=EErrorCode.NoSuchChunk)
        return blob

    def _erasure_meta(self, chunk_id: str) -> Optional[dict]:
        try:
            with open(self._erasure_meta_path(chunk_id), "rb") as f:
                return yson.loads(f.read())
        except FileNotFoundError:
            return None

    def _read_part(self, chunk_id: str, index: int) -> Optional[bytes]:
        try:
            _FP_PART_READ.hit()
            with open(self._part_path(chunk_id, index), "rb") as f:
                return f.read()
        except OSError:
            return None            # erased / lost part → repair below

    def _read_erasure_blob(self, chunk_id: str) -> Optional[bytes]:
        meta = self._erasure_meta(chunk_id)
        if meta is None:
            return None
        codec = get_erasure_codec(_codec_name(meta["codec"]))
        size = meta["size"]
        k = codec.data_parts
        # Fast path: data parts only; parity reads happen only on damage.
        parts = [self._read_part(chunk_id, i) for i in range(k)]
        parts += [None] * codec.parity_parts
        lost = [i for i in range(k) if parts[i] is None]
        if not lost:
            return codec.decode(parts, size)
        with child_span("chunk.erasure_repair", chunk_id=chunk_id) as span:
            attempted = set(range(k))
            group = codec.locality_group(lost[0]) if len(lost) == 1 \
                else None
            if group is not None:
                # One lost data part of a locality group: its other data
                # members are in hand, so only the group's local parity
                # is read, and the part is their XOR.
                for i in group:
                    if i >= k:
                        parts[i] = self._read_part(chunk_id, i)
                        attempted.add(i)
                if all(parts[i] is not None for i in group):
                    t0 = time.perf_counter()
                    parts[lost[0]] = codec.repair_part(parts, lost[0])
                    blob = codec.decode(parts, size)
                    t1 = time.perf_counter()
                    # The parity parts not read are rebuilt too where
                    # their files are gone, as a read of every part
                    # would find them lost.
                    gone = [i for i in range(k, codec.total_parts)
                            if i not in attempted and not os.path.exists(
                                self._part_path(chunk_id, i))]
                    fresh = dict(zip(gone, codec.encode_parts(blob, gone)))
                    _count_repair(t0, t1, len(gone) + 1)
                    fresh[lost[0]] = parts[lost[0]]
                    self._rewrite_parts(chunk_id, lost + gone, fresh)
                    _tag_repair(span, lost + gone, len(attempted),
                                local=True)
                    return blob
            for i in range(k, codec.total_parts):
                if i not in attempted:
                    parts[i] = self._read_part(chunk_id, i)
                    attempted.add(i)
            lost = [i for i, part in enumerate(parts) if part is None]
            _tag_repair(span, lost, len(attempted), local=False)
            t0 = time.perf_counter()
            blob = codec.decode(parts, size)
            t1 = time.perf_counter()
            # Repair-on-read (ref chunk_replicator.h Repair jobs invoked
            # from the read ladder): the decode just proved the chunk
            # reconstructs, so rebuild the lost parts now instead of
            # paying parity reads on every future access.
            fresh = dict(zip(lost, codec.encode_parts(blob, lost)))
            _count_repair(t0, t1, len(lost))
            self._rewrite_parts(chunk_id, lost, fresh)
            return blob

    def _rewrite_parts(self, chunk_id: str, lost: list, parts) -> None:
        """Best effort: the read already succeeded."""
        try:
            for i in lost:
                self._atomic_write(self._part_path(chunk_id, i), parts[i])
        except OSError:
            pass

    def exists(self, chunk_id: str) -> bool:
        return os.path.exists(self._path(chunk_id)) or \
            os.path.exists(self._erasure_meta_path(chunk_id))

    def verify_chunk(self, chunk_id: str) -> bool:
        """Deep-verify one chunk: decode the blob (on the host), which
        re-checks every block's CRC-64. False = the stored bytes cannot
        produce a valid chunk — scrub material."""
        try:
            deserialize_chunk(self._read_blob(chunk_id), hunk_store=self,
                              device="cpu")
            return True
        except Exception:   # noqa: BLE001 — corruption surfaces as
            # anything (CRC YtError, varint ValueError, meta KeyError):
            # every decode failure means the stored bytes are bad.
            return False

    def _chunk_paths(self, chunk_id: str) -> "list[str]":
        """Every file that can belong to this chunk (blob, erasure meta
        + parts): the one enumeration shared by remove and quarantine, so
        a layout change cannot desync them."""
        paths = [self._path(chunk_id)]
        meta_path = self._erasure_meta_path(chunk_id)
        if os.path.exists(meta_path):
            try:
                total = get_erasure_codec(_codec_name(
                    self._erasure_meta(chunk_id)["codec"])).total_parts
            except Exception:   # noqa: BLE001 — damaged meta: sweep wide
                total = 32
            paths.append(meta_path)
            paths.extend(self._part_path(chunk_id, i)
                         for i in range(total))
        return paths

    def quarantine_chunk(self, chunk_id: str) -> None:
        """Move a corrupt chunk's files aside (`.quarantine` suffix) so
        the store stops advertising it while the bytes stay on disk for
        post-mortem."""
        for path in self._chunk_paths(chunk_id):
            try:
                os.replace(path, path + ".quarantine")
            except FileNotFoundError:
                continue            # raced with remove/another scrub

    def erasure_codec_of(self, chunk_id: str) -> Optional[str]:
        """Codec name when the chunk is stored erasure-coded, else None
        (lets a replicator preserve the encoding on the target)."""
        meta = self._erasure_meta(chunk_id)
        return None if meta is None else _codec_name(meta.get("codec"))

    def remove_chunk(self, chunk_id: str) -> None:
        """Dispose a chunk's files. Removal is ADVISORY GC: flush and
        compaction call this on their success path, so a disk error here
        must never fail the operation that already committed — a failed
        unlink leaves a garbage file for the next sweep (the
        `chunks.store.remove` failpoint injects exactly that)."""
        try:
            _FP_REMOVE.hit()
        except OSError:
            return
        for path in self._chunk_paths(chunk_id):
            try:
                os.unlink(path)
            except OSError:
                continue    # gone already, or a garbage file for the next GC

    def list_chunks(self) -> list[str]:
        out = set()
        for sub in os.listdir(self.root):
            subdir = os.path.join(self.root, sub)
            if not os.path.isdir(subdir):
                continue
            for name in os.listdir(subdir):
                if name.endswith(".chunk"):
                    out.add(name[:-len(".chunk")])
                elif name.endswith(".erasure"):
                    out.add(name[:-len(".erasure")])
        return sorted(out)


class ChunkCache:
    """LRU cache of DECODED chunks (device-resident planes), byte-budgeted.

    Holding a decoded chunk pins its planes on the device, so the budget
    bounds the device memory spent on cached table data. Every chunk is
    decoded onto the cache's device."""

    def __init__(self, store: FsChunkStore, capacity_bytes: int = 2 << 30,
                 device: "str | torch.device" = DEFAULT_DEVICE):
        self.store = store
        self.capacity_bytes = capacity_bytes
        self.device = resolve_device(device)
        self._entries: OrderedDict[str, tuple[ColumnarChunk, int]] = \
            OrderedDict()
        self._pinned: set[str] = set()
        self._used = 0
        # guards: _entries, _pinned, _used, hits, misses
        self._lock = sanitizers.register_lock("chunks.ChunkCache._lock")
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _chunk_bytes(chunk: ColumnarChunk) -> int:
        total = 0
        for col in chunk.columns.values():
            total += col.data.numel() * col.data.element_size()
            total += col.valid.numel()
        return total

    def get(self, chunk_id: str) -> ColumnarChunk:
        with self._lock:
            entry = self._entries.get(chunk_id)
            if entry is not None:
                self._entries.move_to_end(chunk_id)
                self.hits += 1
                return entry[0]
        chunk = self.store.read_chunk(chunk_id, device=self.device)
        size = self._chunk_bytes(chunk)
        with self._lock:
            self.misses += 1
            if chunk_id not in self._entries:
                self._entries[chunk_id] = (chunk, size)
                self._used += size
                self._evict_locked()
        return chunk

    def _evict_locked(self) -> None:
        # Pinned entries (in-memory mode tables) never evict.  The newest
        # entry (just inserted, still being returned to a caller) survives,
        # so the cache may overshoot by exactly one chunk's working set.
        evictable = [cid for cid in self._entries if cid not in self._pinned]
        i = 0
        while self._used > self.capacity_bytes and i < len(evictable) - 1:
            victim = evictable[i]
            i += 1
            _, size = self._entries.pop(victim)
            self._used -= size

    def pin(self, chunk_id: str) -> None:
        """Keep this chunk's decoded planes resident (ref in_memory_manager
        preload, tablet_node/in_memory_manager.h:62).  Entry insertion and
        pin-marking happen under ONE lock acquisition, or a concurrent
        eviction could drop the chunk between them."""
        with self._lock:
            if chunk_id in self._entries:
                self._pinned.add(chunk_id)
                self._entries.move_to_end(chunk_id)
                return
        chunk = self.store.read_chunk(chunk_id, device=self.device)
        size = self._chunk_bytes(chunk)
        with self._lock:
            if chunk_id not in self._entries:
                self._entries[chunk_id] = (chunk, size)
                self._used += size
            self._pinned.add(chunk_id)
            self._evict_locked()

    def unpin(self, chunk_id: str) -> None:
        with self._lock:
            self._pinned.discard(chunk_id)

    def invalidate(self, chunk_id: str) -> None:
        with self._lock:
            self._pinned.discard(chunk_id)
            entry = self._entries.pop(chunk_id, None)
            if entry is not None:
                self._used -= entry[1]

    @property
    def used_bytes(self) -> int:
        return self._used
