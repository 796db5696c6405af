"""Replicated chunk store: N locations, read fallback, write-back repair.

Port of the JAX package's `chunks/replicated.py` (`ReplicatedChunkStore`:
the location blacklist, rendezvous placement by sha256, the read ladder
under the `chunk_read` retry policy and the `chunk.replicated_read` span,
the aggregate read error, repair-on-read that counts copies on any
location, and the rest of the `FsChunkStore` surface). The placement is
the reference's order, so each package reads the other's layout.

Ref: the data-node/master replication pair (server/master/chunk_server/
chunk_replicator.h issuing Replicate/Repair jobs; replication_reader.cpp
falling back across replicas), collapsed to one process: a chunk writes
to `replication_factor` locations; reads try locations in order and,
after a successful read, re-replicate to locations that lost their copy
(the repair-on-read analog of the replicator's background jobs).
Erasure-coded writes pass through to a single location (parity already
provides redundancy).

Differences from the reference: `read_chunk(..., device=)` decodes onto
that device. A replicated write serializes the chunk once and stores the
same bytes at each location (the reference serializes once per
location: the same files), unless a column moves its strings into hunk
blobs, which belong to each location's own store. A repair re-serializes
the chunk it read, from its planes read back to the host, as the
reference re-serializes its decoded chunk.
"""

from __future__ import annotations

import hashlib
import logging as _logging
import os
import threading
import time
from typing import Optional

import torch

from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.chunks.encoding import DEFAULT_CODEC, serialize_chunk
from ytsaurus_tpu_torch.chunks.store import FsChunkStore, new_chunk_id
from ytsaurus_tpu_torch.config import retry_policy
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.utils.logging import get_logger, log_event
from ytsaurus_tpu_torch.utils.tracing import child_span


def _is_missing(err: Exception) -> bool:
    """A clean 'this location has no such chunk' — NOT a dying disk."""
    return isinstance(err, YtError) and err.code == EErrorCode.NoSuchChunk


class ReplicatedChunkStore:
    """Drop-in FsChunkStore replacement spanning several directories."""

    def __init__(self, roots: list[str], replication_factor: int = 2,
                 codec: str = DEFAULT_CODEC,
                 blacklist_ttl: float = 15.0):
        if not roots:
            raise YtError("ReplicatedChunkStore needs at least one location")
        self.locations = [FsChunkStore(root, codec=codec) for root in roots]
        self.replication_factor = min(replication_factor, len(self.locations))
        self.codec = codec
        self.blacklist_ttl = blacklist_ttl
        # Location root → monotonic deadline until which reads skip it (a
        # location that just threw a disk-shaped error is probably still
        # broken; probing it on every read serializes the ladder on its
        # failure latency). Ref: replication_reader.cpp banned peers.
        self._banned_until: dict[str, float] = {}
        self._ban_lock = threading.Lock()
        self._log = get_logger("ChunkReplicator")

    # -- location blacklist ----------------------------------------------------

    def _ban(self, store: FsChunkStore) -> None:
        if self.blacklist_ttl <= 0:
            return
        with self._ban_lock:
            self._banned_until[store.root] = \
                time.monotonic() + self.blacklist_ttl

    def _usable(self, stores: "list[FsChunkStore]") -> "list[FsChunkStore]":
        """Non-blacklisted locations — ALL of them when every location is
        banned (a desperation round beats a guaranteed failure)."""
        with self._ban_lock:
            now = time.monotonic()
            for root, until in list(self._banned_until.items()):
                if until <= now:
                    del self._banned_until[root]
            usable = [s for s in stores
                      if s.root not in self._banned_until]
        return usable or list(stores)

    # -- placement -------------------------------------------------------------

    def _placement(self, chunk_id: str) -> list[FsChunkStore]:
        """Deterministic location order per chunk (rendezvous hashing with a
        process-independent hash — python's hash() is salted per process and
        would make replicas drift across restarts)."""
        def rank(i: int) -> bytes:
            return hashlib.sha256(f"{chunk_id}:{i}".encode()).digest()
        ranked = sorted(range(len(self.locations)), key=rank)
        return [self.locations[i] for i in ranked]

    # -- FsChunkStore surface --------------------------------------------------

    def write_chunk(self, chunk: ColumnarChunk,
                    chunk_id: Optional[str] = None,
                    codec: Optional[str] = None,
                    erasure: Optional[str] = None) -> str:
        chunk_id = chunk_id or new_chunk_id()
        placement = self._placement(chunk_id)
        if erasure is not None:
            placement[0].write_chunk(chunk, chunk_id=chunk_id, codec=codec,
                                     erasure=erasure)
            return chunk_id
        blob = None
        if all(c.max_inline_hunk_size is None for c in chunk.schema):
            blob = serialize_chunk(chunk, codec or self.codec)
        written = 0
        errors = []
        for store in placement:
            if written >= self.replication_factor:
                break
            try:
                if blob is None:
                    store.write_chunk(chunk, chunk_id=chunk_id, codec=codec)
                else:
                    store.put_blob(chunk_id, blob)
                written += 1
            except OSError as e:          # location down/full
                errors.append(e)
                log_event(self._log, _logging.WARNING, "replica_write_failed",
                          chunk_id=chunk_id, location=store.root,
                          error=str(e))
        if written == 0:
            raise YtError(f"All locations failed writing chunk {chunk_id}",
                          code=EErrorCode.ChunkFormatError,
                          attributes={"errors": [str(e) for e in errors]})
        if written < self.replication_factor:
            log_event(self._log, _logging.WARNING, "chunk_under_replicated",
                      chunk_id=chunk_id, replicas=written,
                      target=self.replication_factor)
        return chunk_id

    def _read_with_ladder(self, chunk_id: str, probe):
        """Read ladder (ref replication_reader.cpp): rotate across the
        placement, blacklist locations that threw disk-shaped errors,
        and retry whole rounds with jittered exponential backoff — a
        transient fault (node restarting, injected failpoint) must not
        fail a read that ANY replica can still serve. Per-location
        errors aggregate into the final YtError instead of only the last
        one surviving. Returns (serving store, probe result, placement)
        — placement rides along so hot-path callers don't re-run the
        rendezvous hash."""
        policy = retry_policy("chunk_read")
        placement = self._placement(chunk_id)
        errors: dict[str, Exception] = {}
        with child_span("chunk.replicated_read",
                        chunk_id=chunk_id) as span:
            for attempt in range(policy.attempts):
                # The blacklist steers the FIRST round (skip known-bad
                # locations, serve from a healthy replica fast). Later
                # rounds re-probe everything: when the only holder was
                # the banned location, honoring its ban would starve the
                # retry into a guaranteed failure.
                stores = self._usable(placement) if attempt == 0 \
                    else list(placement)
                for store in stores:
                    try:
                        result = probe(store)
                        span.add_tag("location", store.root)
                        span.add_tag("round", attempt)
                        span.add_tag("probes_failed", len(errors))
                        return store, result, placement
                    except (YtError, OSError) as e:   # missing OR dying
                        errors[store.root] = e
                        if not _is_missing(e):
                            self._ban(store)
                        continue
                if len(errors) == len(placement) and \
                        all(_is_missing(e) for e in errors.values()):
                    break   # cleanly absent everywhere: waiting cannot help
                if attempt + 1 < policy.attempts:
                    time.sleep(policy.delay(attempt))
            raise self._aggregate_read_error(chunk_id, placement, errors)

    def read_chunk(self, chunk_id: str,
                   device: "str | torch.device" = DEFAULT_DEVICE
                   ) -> ColumnarChunk:
        store, chunk, placement = self._read_with_ladder(
            chunk_id, lambda s: s.read_chunk(chunk_id, device=device))
        if not os.path.exists(store._erasure_meta_path(chunk_id)):
            # Erasure chunks carry their own redundancy; replicating
            # them in full would defeat the coding's storage savings.
            self._maybe_repair(chunk_id, chunk, placement)
        return chunk

    def _aggregate_read_error(self, chunk_id: str, placement,
                              errors: "dict[str, Exception]") -> YtError:
        inner = []
        for store in placement:
            err = errors.get(store.root)
            if err is None:
                continue
            if isinstance(err, YtError):
                err.attributes.setdefault("location", store.root)
                inner.append(err)
            else:
                inner.append(YtError(
                    f"location {store.root}: {err}",
                    code=EErrorCode.ChunkFormatError,
                    attributes={"location": store.root}))
        all_missing = bool(inner) and all(
            e.code == EErrorCode.NoSuchChunk for e in inner)
        code = EErrorCode.NoSuchChunk if all_missing or not inner \
            else next(e.code for e in inner
                      if e.code != EErrorCode.NoSuchChunk)
        return YtError(
            f"No location could serve chunk {chunk_id} "
            f"({len(inner)}/{len(placement)} failed)",
            code=code, inner_errors=inner)

    def _maybe_repair(self, chunk_id: str, chunk: ColumnarChunk,
                      placement: list[FsChunkStore]) -> None:
        """Top up to replication_factor TOTAL copies (counting copies on any
        location — a write that spilled past a failed location must not be
        re-replicated into over-replication when it recovers)."""
        holders = [s for s in placement if s.exists(chunk_id)]
        missing = self.replication_factor - len(holders)
        if missing <= 0:
            return
        for store in placement:
            if missing <= 0:
                break
            if store in holders:
                continue
            try:
                store.write_chunk(chunk, chunk_id=chunk_id)
                missing -= 1
                log_event(self._log, _logging.INFO, "replica_repaired",
                          chunk_id=chunk_id, location=store.root)
            except OSError:
                continue

    def read_meta(self, chunk_id: str) -> dict:
        # Same ladder as read_chunk: without the round-2 full-placement
        # re-probe, a ban on the sole holder would make meta reads
        # report an existing chunk as absent for the whole ban TTL.
        _, meta, _ = self._read_with_ladder(
            chunk_id, lambda s: s.read_meta(chunk_id))
        return meta

    def read_stats(self, chunk_id: str,
                   backfill_sketch: bool = False) -> dict:
        """Seal-time column stats through the replica read ladder (each
        location's FsChunkStore memoizes, incl. the pre-stats decode
        backfill)."""
        _, stats, _ = self._read_with_ladder(
            chunk_id,
            lambda s: s.read_stats(chunk_id,
                                   backfill_sketch=backfill_sketch))
        return stats

    def exists(self, chunk_id: str) -> bool:
        return any(store.exists(chunk_id) for store in self.locations)

    def remove_chunk(self, chunk_id: str) -> None:
        for store in self.locations:
            store.remove_chunk(chunk_id)

    def list_chunks(self) -> list[str]:
        out: set[str] = set()
        for store in self.locations:
            out.update(store.list_chunks())
        return sorted(out)
