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
level.

Differences from the reference: reads decode onto an explicit device
(`read_chunk(..., device=)`; a `ChunkCache` decodes onto its own device,
default "cuda", which raises without a card). A cached chunk's bytes are
`numel() * element_size()` of its planes. The erasure layout
(`chunks/erasure.py`) is not ported yet: `write_chunk(erasure=...)` and
`put_blob(erasure=...)` raise, and so does a read of a chunk stored as
erasure parts.
"""

from __future__ import annotations

import os
import threading
import uuid
from collections import OrderedDict
from typing import Optional

import torch

from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk, chunk_column_stats
from ytsaurus_tpu_torch.chunks.encoding import (
    DEFAULT_CODEC,
    deserialize_chunk,
    read_chunk_meta,
    serialize_chunk,
)
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.utils import failpoints, sanitizers
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


def _stats_missing_sketch(stats: dict) -> bool:
    """True when a sealed column_stats payload predates the NDV sketch
    (read_stats then decode-backfills it like the pre-stats path)."""
    return any(isinstance(entry, dict) and "ndv_sketch" not in entry
               for name, entry in stats.items() if name != "$row_count")


def _erasure_not_ported() -> YtError:
    return YtError("Erasure-coded chunks (chunks/erasure.py) are not yet "
                   "ported", code=EErrorCode.QueryUnsupported)


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

    def _erasure_meta_path(self, chunk_id: str) -> str:
        return os.path.join(self.root, chunk_id[:2], f"{chunk_id}.erasure")

    def write_chunk(self, chunk: ColumnarChunk,
                    chunk_id: Optional[str] = None,
                    codec: Optional[str] = None,
                    erasure: Optional[str] = None) -> str:
        if erasure is not None:
            raise _erasure_not_ported()
        chunk_id = chunk_id or new_chunk_id()
        blob = serialize_chunk(chunk, codec or self.codec, hunk_store=self)
        return self.put_blob(chunk_id, blob)

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

    def put_blob(self, chunk_id: str, blob: bytes,
                 erasure: Optional[str] = None) -> str:
        """Store an already-serialized chunk blob."""
        if erasure is not None:
            raise _erasure_not_ported()
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
        if os.path.exists(self._erasure_meta_path(chunk_id)):
            raise _erasure_not_ported()
        raise YtError(f"No such chunk {chunk_id}",
                      code=EErrorCode.NoSuchChunk)

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

    def quarantine_chunk(self, chunk_id: str) -> None:
        """Move a corrupt chunk's files aside (`.quarantine` suffix) so
        the store stops advertising it while the bytes stay on disk for
        post-mortem."""
        path = self._path(chunk_id)
        try:
            os.replace(path, path + ".quarantine")
        except FileNotFoundError:
            pass                    # raced with remove/another scrub

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
        try:
            os.unlink(self._path(chunk_id))
        except OSError:
            pass            # gone already, or a garbage file for the next GC

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
