"""Tablet: one shard of a dynamic table — stores, snapshots, MVCC reads.

Port of the JAX package's `tablet/tablet.py`: `Tablet` (the write path,
`rotate_store`, `flush`, `compact`, `read_snapshot` with its snapshot
cache and sensors, `read_snapshot_bounded`, `read_snapshot_reference`,
`lookup_rows` with its row cache and batched chunk probe), the Python
merge helpers (`_mvcc_select`, `_drop_superseded`, `_merge_versions`,
...) and `versioned_schema`.

Ref mapping (server/node/tablet_node):
  TTablet (tablet.h)                  → Tablet
  store_manager write path            → Tablet.write_rows/delete_rows (locks
                                        via the transaction manager)
  store_flusher / rotation            → Tablet.rotate_store + flush()
  store_compactor                     → Tablet.compact()
  tablet_snapshot_store lock-free     → versioned snapshot chunks built per
  reads                                 flush generation, merged on read at
                                        the requested timestamp
Both merges are here: the columnar one (tablet/mvcc.py, on the device,
its version sort through the radix kernels) and the Python one, picked by
`TabletConfig.vectorized_scan_min_rows` as in the reference.

Differences from the reference:
  * `Tablet(..., device=)` (default "cuda"; raises without a card): its
    chunk cache decodes onto that device, store planes are built there,
    and the MVCC programs run there. A chunk cache handed in must decode
    onto the same device.
  * Host planes for lookups are explicit `.cpu()` copies (uint64 planes
    viewed as np.uint64), once per chunk, in the same LRU.
  * Finding keys' versions in a chunk (`lookup_rows`, and the newest
    committed timestamp that the transaction manager's conflict check
    reads) has one routine, `_chunk_keys_indices`: a batched search of a
    per-chunk host index (the first key column's valid values in stable
    sorted order, built once beside the host planes), the other key
    columns checked on the candidates. It returns, per key, the rows the
    reference's per-key mask returns, in row order. The reference's
    full-plane `np.isin` probe (`_chunk_batch_key_rows`) and its
    power-of-two needle padding (`Tablet.probe_bucket_min`,
    `_pad_needles`, which bounds compiled shapes under JAX) are not
    ported.
  * torch.profiler ranges name the device stages: `tablet.flush`,
    `tablet.read` (the uncached merge), `tablet.compact`, and inside
    flush and compact, `tablet.write` (serialize and write the chunk).
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ytsaurus_tpu_torch.chunks.columnar import (
    Column,
    ColumnarChunk,
    _plane_shape,
    concat_chunks,
)
from ytsaurus_tpu_torch.chunks.store import ChunkCache, FsChunkStore
from ytsaurus_tpu_torch.config import tablet_config
from ytsaurus_tpu_torch.device import (
    DEFAULT_DEVICE,
    resolve_device,
    same_device,
)
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.schema import (
    EValueType,
    TableSchema,
    VectorType,
    device_dtype,
)
from ytsaurus_tpu_torch.tablet import mvcc
from ytsaurus_tpu_torch.tablet.dynamic_store import SortedDynamicStore
from ytsaurus_tpu_torch.tablet.timestamp import MAX_TIMESTAMP
from ytsaurus_tpu_torch.utils import invariants, sanitizers
from ytsaurus_tpu_torch.utils.invariants import check as _invariant_check
from ytsaurus_tpu_torch.utils.profiling import PoolSensorCache, Profiler
from ytsaurus_tpu_torch.utils.tracing import child_span

# Process-wide snapshot-cache sensors.
_snap_profiler = Profiler("tablet/snapshot_cache")
_SNAP_HITS = _snap_profiler.counter("hits")
_SNAP_MISSES = _snap_profiler.counter("misses")
_SNAP_EVICTIONS = _snap_profiler.counter("evictions")
_SNAP_BYTES = _snap_profiler.gauge("bytes_pinned")

# Per-pool tablet read counters: the admitted cohort's pool reaches the
# tablet read, so accounting sees tablet-level consumption per tenant.
_lookup_counters = PoolSensorCache("tablet/lookup", ("reads", "keys"))
# guards: _snap_bytes_pinned
_snap_lock = sanitizers.register_lock("tablet._snap_lock")
_snap_bytes_pinned = 0

# Key of the first-key-column search index in a chunk's host-plane entry
# (never a column name).
_KEY_INDEX = object()
_NO_ROWS = np.zeros(0, dtype=np.int64)


def _snap_bytes_add(delta: int) -> None:
    global _snap_bytes_pinned
    with _snap_lock:
        _snap_bytes_pinned += delta
        _SNAP_BYTES.set(_snap_bytes_pinned)


def snapshot_cache_stats() -> dict:
    """Live snapshot-cache counters."""
    return {
        "hits": int(_SNAP_HITS.get()),
        "misses": int(_SNAP_MISSES.get()),
        "evictions": int(_SNAP_EVICTIONS.get()),
        "bytes_pinned": _snap_bytes_pinned,
    }


def _chunk_nbytes(chunk: ColumnarChunk) -> int:
    total = 0
    for col in chunk.columns.values():
        total += col.data.numel() * col.data.element_size()
        total += col.valid.numel()
    return total


def versioned_schema(schema: TableSchema) -> TableSchema:
    """Schema of versioned snapshot chunks: keys + $timestamp/$tombstone +
    per value column (value plane, $w: written-flag plane).  The written
    planes are the per-column timestamp dimension of TVersionedRow
    (client/table_client/versioned_row.h:90-141): a version only carries
    the columns it wrote, so partial writes merge per column on read.
    Keys keep their sort order; versions sort within key by descending
    timestamp at flush time."""
    cols: list = []
    for c in schema:
        if c.sort_order is not None:
            cols.append((c.name, c.type.value, c.sort_order.value))
    cols.append(("$timestamp", "int64"))
    cols.append(("$tombstone", "boolean"))
    for c in schema:
        if c.sort_order is None:
            # Keep hunk thresholds so flushes store big values out-of-row.
            cols.append(dataclasses.replace(c, sort_order=None,
                                            expression=None, aggregate=None,
                                            required=False))
            cols.append((f"$w:{c.name}", "boolean"))
    return TableSchema.make(cols)


class Tablet:
    def __init__(self, schema: TableSchema, chunk_store: FsChunkStore,
                 tablet_id: str = "0", pivot_key: Optional[tuple] = None,
                 chunk_cache: Optional[ChunkCache] = None,
                 device: "str | torch.device" = DEFAULT_DEVICE):
        if not schema.is_sorted:
            raise YtError("Dynamic tables require a sorted schema",
                          code=EErrorCode.TabletNotMounted)
        self.device = resolve_device(device)
        if chunk_cache is not None and \
                not same_device(chunk_cache.device, self.device):
            raise YtError(f"The chunk cache decodes onto "
                          f"{chunk_cache.device}, the tablet runs on "
                          f"{self.device}", code=EErrorCode.InvalidConfig)
        self.schema = schema
        # Cached: schema.key_columns is a rebuilding property, and
        # normalize_key sits on the per-key serving hot path.
        self._key_columns = schema.key_columns
        # `_normalize_value` per column as one function each: the write
        # and lookup paths normalize every row and key several times.
        self._normalizers = {c.name: _normalizer(c.type) for c in schema}
        self._key_normalizers = [_normalizer(c.type)
                                 for c in self._key_columns]
        self.tablet_id = tablet_id
        self.pivot_key = pivot_key
        self.chunk_store = chunk_store
        self.chunk_cache = chunk_cache or ChunkCache(chunk_store,
                                                     device=self.device)
        self.active_store = SortedDynamicStore(schema)
        self.passive_stores: list[SortedDynamicStore] = []
        self.chunk_ids: list[str] = []      # versioned snapshot chunks
        self.mounted = True
        self.in_memory = False          # pin chunks in the cache when True
        self.flush_generation = 0
        # guards: active_store, passive_stores, chunk_ids, flush_generation, _snapshot_cache, _host_planes, _row_cache, _row_cache_gen
        self._lock = sanitizers.register_rlock("tablet.Tablet._lock",
                                               hot=False)
        # Host numpy views of chunk planes: a real LRU (promote on hit,
        # capacity from TabletConfig.host_plane_cache_capacity).
        self._host_planes: "OrderedDict[str, dict]" = OrderedDict()
        self._versioned_schema = versioned_schema(schema)
        # Snapshot cache: (generation, visible chunk, built_at) for
        # latest-class reads; invalidated by any write/flush/compact via
        # the generation key.  built_at (monotonic) is what bounded-
        # staleness reads check the staleness bound against.
        self._snapshot_cache: \
            "Optional[tuple[tuple, ColumnarChunk, float]]" = None
        # Max committed version timestamp of the sealed chunks, memoized
        # per flush generation (read from chunk meta stats).
        self._chunk_max_ts = 0
        self._chunk_max_ts_gen = -1
        # Lookup row cache (ref tablet_node/row_cache.h): key → merged row,
        # valid for one (write, flush) generation only.
        self._row_cache: "OrderedDict[tuple, Optional[dict]]" = OrderedDict()
        self._row_cache_gen: tuple = ()
        self.row_cache_capacity = 4096
        self.row_cache_hits = 0
        self.row_cache_misses = 0

    # -- write path (called under the transaction manager) ---------------------

    def normalize_row(self, row: dict) -> dict:
        """Canonical host forms per column type (strings as bytes, matching
        what chunk decode produces)."""
        normalizers = self._normalizers
        out = {}
        for name, value in row.items():
            normalize = normalizers.get(name)
            if normalize is None:
                raise YtError(f"Unknown column {name!r}",
                              code=EErrorCode.QueryTypeError)
            out[name] = normalize(value)
        return out

    def normalize_key(self, key: tuple) -> tuple:
        normalizers = self._key_normalizers
        if len(key) != len(normalizers):
            raise YtError(f"Key width {len(key)} != {len(normalizers)}")
        if len(key) == 1:
            return (normalizers[0](key[0]),)
        return tuple(f(v) for f, v in zip(normalizers, key))

    def validate_required(self, normalized_row: dict,
                          partial: bool = False) -> None:
        """THE required-column check (single source: used by tablets,
        transactions, and columnar construction paths must agree).
        partial=True (update-mode writes): only columns the row STATES are
        checked — unstated required columns keep their old values."""
        for c in self.schema:
            if not c.required:
                continue
            if partial and c.name not in normalized_row:
                continue
            if normalized_row.get(c.name) is None:
                raise YtError(f"Required column {c.name!r} is null",
                              code=EErrorCode.QueryTypeError)

    def write_row(self, row: dict, timestamp: int,
                  update: bool = False) -> None:
        row = self.normalize_row(row)
        self.validate_required(row, partial=update)
        with self._lock:       # a concurrent flush() must not drop the write
            self._check_mounted()
            self.active_store.write_row(row, timestamp, update=update)

    def delete_row(self, key: tuple, timestamp: int) -> None:
        key = self.normalize_key(key)
        with self._lock:
            self._check_mounted()
            self.active_store.delete_row(key, timestamp)

    def last_committed_timestamp(self, key: tuple) -> Optional[int]:
        """Newest committed write/delete ts for conflict detection."""
        return self.last_committed_timestamps([key])[0]

    def last_committed_timestamps(self, keys: "Sequence[tuple]"
                                  ) -> "list[Optional[int]]":
        """`last_committed_timestamp` of each (normalized) key, with one
        index search per chunk for the whole batch."""
        with self._lock:
            stores = [self.active_store] + self.passive_stores
            out: list = []
            for key in keys:
                best = None
                for store in stores:
                    ts = store.last_committed_timestamp(key)
                    if ts is not None and (best is None or ts > best):
                        best = ts
                out.append(best)
            for cid in self.chunk_ids:
                found = _chunk_last_timestamps(
                    self._decode(cid), self.schema, keys,
                    self._chunk_host_planes_locked(cid))
                for i, ts in enumerate(found):
                    if ts is not None and (out[i] is None or ts > out[i]):
                        out[i] = ts
            return out

    def set_in_memory(self, enabled: bool) -> None:
        """Preload+pin (or release) this tablet's chunks in the cache."""
        with self._lock:
            self.in_memory = enabled
            for cid in self.chunk_ids:
                if enabled:
                    self.chunk_cache.pin(cid)
                else:
                    self.chunk_cache.unpin(cid)

    def _check_mounted(self):
        if not self.mounted:
            raise YtError(f"Tablet {self.tablet_id} is not mounted",
                          code=EErrorCode.TabletNotMounted)

    # -- rotation / flush / compaction -----------------------------------------

    def rotate_store(self) -> None:
        """Freeze the active store (ref store_rotator)."""
        with self._lock:
            if self.active_store.key_count == 0:
                return
            self.passive_stores.append(self.active_store)
            self.active_store = SortedDynamicStore(self.schema)

    def _vectorize(self, version_count: int) -> bool:
        """Columnar-pipeline dispatch: per-program overhead dominates
        tiny stores, so small version counts keep the Python merge
        (TabletConfig.vectorized_scan_min_rows; 0 forces columnar)."""
        return mvcc.supports(self.schema) and \
            version_count >= tablet_config().vectorized_scan_min_rows

    def flush(self) -> Optional[str]:
        """Rotate + write all passive stores into one versioned chunk.
        The merge sort runs as one device program over concatenated
        store planes (tablet/mvcc.py); tiny stores keep the host sort."""
        with self._lock, record_function("tablet.flush"):
            self.rotate_store()
            if not self.passive_stores:
                return None
            total = sum(s.store_row_count for s in self.passive_stores)
            if self._vectorize(total):
                parts = [s.to_versioned_chunk(self._versioned_schema,
                                              self.device)
                         for s in self.passive_stores
                         if s.store_row_count]
                chunk = mvcc.sorted_versioned_chunk(
                    concat_chunks(parts), self.schema, device=self.device)
                if invariants.enabled():
                    _invariant_check(
                        "versioned_rows",
                        (self.schema.key_column_names, chunk.to_rows()))
            else:
                rows: list[dict] = []
                for store in self.passive_stores:
                    rows.extend(store.versioned_rows())
                rows.sort(key=_versioned_sort_key(self.schema))
                _invariant_check("versioned_rows",
                                 (self.schema.key_column_names, rows))
                chunk = ColumnarChunk.from_rows(self._versioned_schema,
                                                rows, device=self.device)
            with record_function("tablet.write"):
                chunk_id = self.chunk_store.write_chunk(chunk)
            self.chunk_ids.append(chunk_id)
            if self.in_memory:
                self.chunk_cache.pin(chunk_id)
            self.passive_stores.clear()
            self.flush_generation += 1
            _invariant_check("tablet", self)
            return chunk_id

    def compact(self, retention_timestamp: int = 0) -> Optional[str]:
        """Merge all snapshot chunks into one, dropping versions that are
        superseded as of `retention_timestamp` (ref store_compactor +
        lsm heuristics, majorly simplified: full major compaction)."""
        with self._lock, record_function("tablet.compact"):
            if len(self.chunk_ids) <= 0:
                return None
            chunks = [self._decode(cid) for cid in self.chunk_ids]
            total = sum(c.row_count for c in chunks)
            chunk: Optional[ColumnarChunk] = None
            if self._vectorize(total):
                merged = concat_chunks(
                    [self._normalize_versioned(c) for c in chunks])
                out = mvcc.retained_chunk(merged, self.schema,
                                          retention_timestamp,
                                          device=self.device)
                if out.row_count:
                    chunk = out
                if invariants.enabled() and chunk is not None:
                    _invariant_check(
                        "versioned_rows",
                        (self.schema.key_column_names, chunk.to_rows()))
            else:
                rows: list[dict] = []
                value_names = [c.name for c in self.schema
                               if c.sort_order is None]
                for c in chunks:
                    for row in c.to_rows():
                        for name in value_names:
                            row[f"$w:{name}"] = _written(row, name)
                        rows.append(row)
                rows.sort(key=_versioned_sort_key(self.schema))
                rows = _drop_superseded(rows, self.schema,
                                        retention_timestamp)
                _invariant_check("versioned_rows",
                                 (self.schema.key_column_names, rows))
                if rows:
                    chunk = ColumnarChunk.from_rows(self._versioned_schema,
                                                    rows, device=self.device)
            old_ids = list(self.chunk_ids)
            if chunk is not None:
                with record_function("tablet.write"):
                    new_id = self.chunk_store.write_chunk(chunk)
                self.chunk_ids = [new_id]
                if self.in_memory:
                    self.chunk_cache.pin(new_id)
            else:
                new_id = None
                self.chunk_ids = []
            for cid in old_ids:
                self.chunk_store.remove_chunk(cid)
                self.chunk_cache.invalidate(cid)
                self._host_planes.pop(cid, None)
            self.flush_generation += 1
            _invariant_check("tablet", self)
            return new_id

    # -- read path -------------------------------------------------------------

    def _decode(self, chunk_id: str) -> ColumnarChunk:
        return self.chunk_cache.get(chunk_id)

    def _chunk_host_planes_locked(self, chunk_id: str) -> dict:
        """numpy copies of a chunk's planes (device->host once per chunk).
        LRU: hits promote (a hot chunk probed by every lookup batch must
        not be evicted because it was decoded first), capacity from
        TabletConfig.host_plane_cache_capacity."""
        planes = self._host_planes.get(chunk_id)
        if planes is None:
            chunk = self._decode(chunk_id)
            n = chunk.row_count
            planes = {}
            for name, col in chunk.columns.items():
                data = col.data[:n].cpu().numpy()
                if col.type is EValueType.uint64:
                    data = data.view(np.uint64)
                planes[name] = (data, col.valid[:n].cpu().numpy())
            self._host_planes[chunk_id] = planes
            capacity = tablet_config().host_plane_cache_capacity
            while len(self._host_planes) > capacity:
                self._host_planes.popitem(last=False)
        else:
            self._host_planes.move_to_end(chunk_id)
        return planes

    def _decoded_chunks(self) -> list[ColumnarChunk]:
        return [self._decode(cid) for cid in self.chunk_ids]

    def versioned_rows_snapshot(self) -> list[dict]:
        """All versions from every store (host rows; newest-first per key)."""
        with self._lock:
            rows: list[dict] = []
            for chunk in self._decoded_chunks():
                rows.extend(chunk.to_rows())
            for store in self.passive_stores + [self.active_store]:
                rows.extend(store.versioned_rows())
            rows.sort(key=_versioned_sort_key(self.schema))
            return rows

    def _generation(self) -> tuple:
        """Identity of the tablet's visible state: any write, rotation,
        flush or compaction changes it.  Keys the row cache AND the
        snapshot cache."""
        return (self.active_store.store_row_count,
                len(self.passive_stores), self.flush_generation)

    def _chunk_max_timestamp(self, chunk_id: str) -> int:
        """Newest version timestamp in a sealed chunk — from the chunk
        meta stats when present (one header parse), else from the host
        planes (pre-stats chunks)."""
        try:
            stats = self.chunk_store.read_stats(chunk_id)
            entry = (stats or {}).get("$timestamp") or {}
            if entry.get("max") is not None:
                return int(entry["max"])
        except (YtError, OSError):
            pass
        data, valid = self._chunk_host_planes_locked(chunk_id)["$timestamp"]
        return int(data[valid].max()) if valid.any() else 0

    def _latest_ts_floor(self) -> int:
        """Smallest timestamp that reads "latest": any read at/above the
        newest committed version sees the same visible state, so it can
        share the cached snapshot (the timestamp-class in the cache
        key)."""
        if self._chunk_max_ts_gen != self.flush_generation:
            best = 0
            for cid in self.chunk_ids:
                best = max(best, self._chunk_max_timestamp(cid))
            self._chunk_max_ts = best
            self._chunk_max_ts_gen = self.flush_generation
        floor = self._chunk_max_ts
        for store in [self.active_store] + self.passive_stores:
            floor = max(floor, store.max_timestamp)
        return floor

    def _normalize_versioned(self, chunk: ColumnarChunk) -> ColumnarChunk:
        """Adapt a persisted versioned chunk to THE versioned schema so
        chunk planes concatenate: chunks from before the per-column $w:
        layout gain explicit written=True planes (whole-row semantics,
        matching `_written`), missing value columns read as stated
        nulls."""
        vschema = self._versioned_schema
        if chunk.schema == vschema:
            return chunk
        cap = chunk.capacity
        n = chunk.row_count
        dev = chunk.device
        row_valid = torch.arange(cap, device=dev) < n
        columns: dict[str, Column] = {}
        for c in vschema:
            col = chunk.columns.get(c.name)
            if col is not None:
                columns[c.name] = col
            elif c.name.startswith("$w:"):
                columns[c.name] = Column(
                    type=c.type, data=torch.ones(cap, dtype=torch.bool,
                                                 device=dev),
                    valid=row_valid)
            else:
                columns[c.name] = Column(
                    type=c.type,
                    data=torch.zeros(_plane_shape(c.type, cap),
                                     dtype=device_dtype(c.type), device=dev),
                    valid=torch.zeros(cap, dtype=torch.bool, device=dev))
        return ColumnarChunk(schema=vschema, row_count=n, columns=columns)

    def read_snapshot(self, timestamp: int = MAX_TIMESTAMP) -> ColumnarChunk:
        """Materialize the tablet contents as of `timestamp` into a plain
        columnar chunk (the select_rows input).

        Columnar MVCC pipeline (tablet/mvcc.py): versioned chunk planes
        and store-ingested planes concatenate on the device, one packed
        (key, -ts) sort, visibility as segmented scans — no to_rows().
        Latest-class reads (timestamp at/above the newest committed
        version) memoize the materialized chunk per generation, so
        repeated selects skip the merge entirely until the next
        write/flush/compact."""
        with child_span("tablet.read_snapshot") as span, self._lock:
            generation = self._generation()
            latest = timestamp >= self._latest_ts_floor()
            if latest:
                cached = self._snapshot_cache
                if cached is not None and cached[0] == generation:
                    _SNAP_HITS.increment()
                    span.add_tag("snapshot_cache", "hit")
                    span.add_tag("rows", cached[1].row_count)
                    return cached[1]
                _SNAP_MISSES.increment()
            span.add_tag("snapshot_cache",
                         "miss" if latest else "bypass")
            with record_function("tablet.read"):
                chunk = self._read_snapshot_uncached(timestamp)
            span.add_tag("rows", chunk.row_count)
            if latest and tablet_config().snapshot_cache_enabled:
                if self._snapshot_cache is not None:
                    _SNAP_EVICTIONS.increment()
                    _snap_bytes_add(-_chunk_nbytes(self._snapshot_cache[1]))
                self._snapshot_cache = (generation, chunk,
                                        time.monotonic())
                _snap_bytes_add(_chunk_nbytes(chunk))
            return chunk

    def read_snapshot_bounded(self, timestamp: int = MAX_TIMESTAMP,
                              max_staleness: float = 0.0) \
            -> "tuple[ColumnarChunk, float]":
        """Bounded-staleness read: serve the cached snapshot EVEN IF
        writes advanced the generation, as long as it was built within
        `max_staleness` seconds.  Returns (chunk, staleness seconds
        actually served); falls back to a full `read_snapshot`
        (staleness 0) when the cache is cold, too old, or the caller
        asked for a historical timestamp the cache cannot answer."""
        if max_staleness and max_staleness > 0:
            with self._lock:
                cached = self._snapshot_cache
                if cached is not None and \
                        timestamp >= self._latest_ts_floor():
                    age = time.monotonic() - cached[2]
                    if age <= max_staleness:
                        _SNAP_HITS.increment()
                        return cached[1], age
        return self.read_snapshot(timestamp), 0.0

    def _read_snapshot_uncached(self, timestamp: int) -> ColumnarChunk:
        total = sum(s.store_row_count for s in
                    [self.active_store] + self.passive_stores)
        for cid in self.chunk_ids:
            total += self._decode(cid).row_count
        if not self._vectorize(total):
            with child_span("tablet.mvcc_merge", vectorized=False,
                            versions=total):
                return self.read_snapshot_reference(timestamp)
        with child_span("tablet.mvcc_merge", vectorized=True,
                        versions=total):
            sources = [self._normalize_versioned(self._decode(cid))
                       for cid in self.chunk_ids]
            sources += [s.to_versioned_chunk(self._versioned_schema,
                                             self.device)
                        for s in self.passive_stores + [self.active_store]
                        if s.store_row_count]
            if not sources:
                return dataclasses.replace(
                    ColumnarChunk.from_rows(self.schema.to_unsorted(), [],
                                            device=self.device),
                    sorted_by=tuple(self.schema.key_column_names))
            return mvcc.visible_chunk(concat_chunks(sources), self.schema,
                                      timestamp, device=self.device)

    def read_snapshot_reference(self,
                                timestamp: int = MAX_TIMESTAMP
                                ) -> ColumnarChunk:
        """The retained Python MVCC merge (pre-columnar read path):
        the property-test oracle and the small-store fast path."""
        with self._lock:
            rows = self.versioned_rows_snapshot()
            visible = _mvcc_select(rows, self.schema, timestamp)
            chunk = ColumnarChunk.from_rows(self.schema.to_unsorted(),
                                            visible, device=self.device)
            # Same key-order seal as the vectorized merge.
            return dataclasses.replace(
                chunk, sorted_by=tuple(self.schema.key_column_names))

    def lookup_rows(self, keys: Sequence[tuple],
                    timestamp: int = MAX_TIMESTAMP,
                    column_names: Optional[Sequence[str]] = None,
                    normalized: bool = False,
                    pool: Optional[str] = None) -> list[Optional[dict]]:
        """Point reads at a timestamp (ref tablet_node/lookup.cpp).

        normalized=True: the caller already holds canonical keys
        (normalize_key output).

        `pool` is the admitted cohort's identity: reads tick per-pool
        tablet sensors (`tablet/lookup/reads{pool=}`).

        Batched chunk probe: keys missing the row cache are searched in
        each versioned chunk's key index together (`_chunk_keys_indices`),
        and only their matched rows are decoded."""
        counters = _lookup_counters.counters(pool)
        counters["reads"].increment()
        counters["keys"].increment(len(keys))
        with child_span("tablet.lookup", keys=len(keys),
                        chunks=len(self.chunk_ids)), self._lock:
            key_names = self.schema.key_column_names
            out: list[Optional[dict]] = []
            if not normalized:
                keys = [self.normalize_key(tuple(k)) for k in keys]
            # The cache only serves latest-timestamp reads and resets when
            # any store or chunk set changes.
            generation = self._generation()
            cacheable = timestamp == MAX_TIMESTAMP
            if self._row_cache_gen != generation:
                self._row_cache.clear()
                self._row_cache_gen = generation
            misses = dict.fromkeys(
                k for k in keys
                if not (cacheable and k in self._row_cache))
            chunk_rows: "Optional[dict[tuple, list[dict]]]" = None
            if misses and self.chunk_ids:
                chunk_rows = {}
                miss_list = list(misses)
                for cid in self.chunk_ids:
                    chunk = self._decode(cid)
                    planes = self._chunk_host_planes_locked(cid)
                    for key, idx in zip(miss_list, _chunk_keys_indices(
                            chunk, self.schema, miss_list, planes)):
                        if len(idx):
                            chunk_rows.setdefault(key, []).extend(
                                _decode_chunk_rows(chunk, planes, idx))
            for key in keys:
                if cacheable and key in self._row_cache:
                    self.row_cache_hits += 1
                    self._row_cache.move_to_end(key)
                    cached = self._row_cache[key]
                    row = dict(cached) if cached is not None else None
                else:
                    if cacheable:       # bypassing reads skew no metric
                        self.row_cache_misses += 1
                    versions: list[tuple[int, Optional[dict]]] = []
                    for store in [self.active_store] + self.passive_stores:
                        versions.extend(store.lookup_versions(key))
                    if chunk_rows is not None and key in misses:
                        # The batch probe is authoritative ONLY for the
                        # keys it covered: a key that was a cache HIT at
                        # call start can be evicted by THIS loop's own
                        # insertions and reach here unprobed.
                        versions.extend(_versions_from_chunk_rows(
                            chunk_rows.get(key, ()), self.schema))
                    else:
                        for cid in self.chunk_ids:
                            versions.extend(_chunk_lookup_versions(
                                self._decode(cid), self.schema, key,
                                self._chunk_host_planes_locked(cid)))
                    merged = _merge_versions(versions, timestamp)
                    if merged is None:
                        row = None
                    else:
                        row = dict(zip(key_names, key))
                        # Columns no surviving version wrote read as null.
                        for c in self.schema:
                            if c.sort_order is None:
                                row[c.name] = None
                        row.update(merged)
                    if cacheable:
                        self._row_cache[key] = \
                            dict(row) if row is not None else None
                        while len(self._row_cache) > self.row_cache_capacity:
                            self._row_cache.popitem(last=False)
                if row is not None and column_names is not None:
                    row = {name: row.get(name) for name in column_names}
                out.append(row)
            return out


def _normalizer(ty):
    """`_normalize_value` for one column type, as one function."""
    if ty in (EValueType.int64, EValueType.uint64):
        return lambda v: None if v is None else int(v)
    if ty is EValueType.double:
        return lambda v: None if v is None else float(v)
    return lambda v: _normalize_value(v, ty)


def _normalize_value(value, ty):
    if value is None:
        return None
    if ty is EValueType.string:
        return value.encode("utf-8") if isinstance(value, str) else bytes(value)
    if ty is EValueType.boolean:
        return bool(value)
    if ty is EValueType.double:
        return float(value)
    if ty in (EValueType.int64, EValueType.uint64):
        return int(value)
    return value


# -- versioned row helpers -----------------------------------------------------

def _written(row: dict, name: str) -> bool:
    """Did this version state column `name`?  Chunks persisted before the
    per-column layout carry no $w: planes — or carry them as nulls after a
    re-encode — and mean whole-row writes, so ABSENT and None both read as
    written (only an explicit False means unwritten)."""
    flag = row.get(f"$w:{name}")
    return True if flag is None else bool(flag)


def _versioned_sort_key(schema: TableSchema):
    key_names = schema.key_column_names

    def sort_key(row: dict):
        key_part = tuple((row[name] is not None,
                          row[name] if row[name] is not None else 0)
                         for name in key_names)
        return key_part + (-row["$timestamp"],)
    return sort_key


def _mvcc_select(versioned_rows: list[dict], schema: TableSchema,
                 timestamp: int) -> list[dict]:
    """Per-column MVCC merge at `timestamp` (versioned_row_merger.h
    semantics): the newest delete <= ts bounds the merge; each column takes
    its newest write after that bound that STATES the column.  Input must
    be sorted by (key, -ts)."""
    key_names = schema.key_column_names
    value_names = [c.name for c in schema if c.sort_order is None]
    out = []
    prev_key: object = object()
    visible: Optional[dict] = None
    filled: set = set()
    deleted = False

    def emit():
        if visible is not None:
            for name in value_names:
                visible.setdefault(name, None)
            out.append(visible)

    for row in versioned_rows:
        key = tuple(row[name] for name in key_names)
        if key != prev_key:
            emit()
            prev_key = key
            visible = None
            filled = set()
            deleted = False
        if deleted or row["$timestamp"] > timestamp:
            continue
        if row["$tombstone"]:
            deleted = True          # older versions are invisible
            continue
        if visible is None:
            visible = {name: row[name] for name in key_names}
        for name in value_names:
            if name not in filled and _written(row, name):
                visible[name] = row.get(name)
                filled.add(name)
    emit()
    return out


def _drop_superseded(versioned_rows: list[dict], schema: TableSchema,
                     retention_timestamp: int) -> list[dict]:
    """Major-compaction retention: keep every version newer than
    `retention_timestamp`; versions at/below it collapse into ONE
    consolidated base version holding the per-column merged visible state
    at the retention timestamp (the merger's "merge partial writes"
    compaction mode) — or nothing if that state is a delete.  Input sorted
    by (key, -ts); output preserves that order."""
    key_names = schema.key_column_names
    value_names = [c.name for c in schema if c.sort_order is None]
    out = []
    i = 0
    n = len(versioned_rows)
    while i < n:
        key = tuple(versioned_rows[i][name] for name in key_names)
        group = []
        while i < n and tuple(versioned_rows[i][name]
                              for name in key_names) == key:
            group.append(versioned_rows[i])
            i += 1
        base_rows = []
        for row in group:
            if row["$timestamp"] > retention_timestamp:
                out.append(row)
            else:
                base_rows.append(row)
        if not base_rows:
            continue
        # Per-column merge of the <= retention versions.
        merged: Optional[dict] = None
        filled: set = set()
        base_ts = None
        for row in base_rows:           # newest first
            if row["$tombstone"]:
                break                   # older versions invisible
            if merged is None:
                merged = {name: row[name] for name in key_names}
                base_ts = row["$timestamp"]
            for name in value_names:
                if name not in filled and _written(row, name):
                    merged[name] = row.get(name)
                    filled.add(name)
        if merged is not None:
            merged["$timestamp"] = base_ts
            merged["$tombstone"] = False
            for name in value_names:
                merged.setdefault(name, None)
                merged[f"$w:{name}"] = True     # consolidated: states all
            out.append(merged)
    return out


def _merge_versions(versions: list[tuple[int, Optional[dict]]],
                    timestamp: int) -> Optional[dict]:
    """Per-column merge from (ts, written-columns-dict-or-None) pairs:
    the newest delete <= ts bounds the merge; each column takes its newest
    stated value after the bound (TVersionedRow lookup merge)."""
    live = sorted((v for v in versions if v[0] <= timestamp),
                  key=lambda v: -v[0])
    merged: Optional[dict] = None
    filled: set = set()
    for ts, state in live:
        if state is None:
            break                       # delete: older versions invisible
        if merged is None:
            merged = {}
        for name, value in state.items():
            if name not in filled:
                merged[name] = value
                filled.add(name)
    return merged


def _versions_from_chunk_rows(rows, schema: TableSchema
                              ) -> list[tuple[int, Optional[dict]]]:
    """Versioned chunk rows of one key → (timestamp, state) pairs."""
    out = []
    value_names = [c.name for c in schema if c.sort_order is None]
    for row in rows:
        if row["$tombstone"]:
            out.append((row["$timestamp"], None))
        else:
            # Only columns the version wrote ($w: flags; chunks from before
            # the per-column layout carry none → whole-row semantics).
            out.append((row["$timestamp"],
                        {name: row.get(name) for name in value_names
                         if _written(row, name)}))
    return out


def _chunk_lookup_versions(chunk: ColumnarChunk, schema: TableSchema,
                           key: tuple, host_planes: dict
                           ) -> list[tuple[int, Optional[dict]]]:
    return _versions_from_chunk_rows(
        _chunk_key_rows(chunk, schema, key, host_planes), schema)


def _string_code(col: Column, value) -> Optional[int]:
    """The chunk-local code of a string key value, None when absent."""
    if col.dictionary is None or not len(col.dictionary):
        return None
    target = value if isinstance(value, bytes) else str(value).encode()
    idx = np.searchsorted(col.dictionary, target)
    if idx < len(col.dictionary) and col.dictionary[idx] == target:
        return int(idx)
    return None


_INT_BOUNDS = {np.dtype(t): (int(np.iinfo(t).min), int(np.iinfo(t).max))
               for t in (np.int32, np.int64, np.uint64)}


def _fits(value, dtype: np.dtype) -> bool:
    """Whether a (non-null) key value can equal some element of a plane of
    `dtype`, and converts to it exactly."""
    bounds = _INT_BOUNDS.get(dtype)
    if bounds is not None:
        if isinstance(value, float):
            return value.is_integer() and _fits(int(value), dtype)
        return bounds[0] <= value <= bounds[1]
    if dtype.kind == "f":
        return value == value           # NaN equals nothing
    return True


def _key_index(chunk: ColumnarChunk, schema: TableSchema,
               host_planes: dict) -> tuple:
    """(valid rows of the first key column in stable order of their
    values, those values, the null rows), built once per chunk beside its
    host planes."""
    index = host_planes.get(_KEY_INDEX)
    if index is None:
        data, valid = host_planes[schema.key_column_names[0]]
        usable = valid & (data == data) if data.dtype.kind == "f" else valid
        rows = np.flatnonzero(usable)
        order = rows[np.argsort(data[rows], kind="stable")]
        index = (order, data[order], np.flatnonzero(~valid))
        host_planes[_KEY_INDEX] = index
    return index


def _chunk_keys_indices(chunk: ColumnarChunk, schema: TableSchema,
                        keys: "Sequence[tuple]", host_planes: dict
                        ) -> "list[np.ndarray]":
    """Row indices (ascending) of a versioned chunk whose key equals each
    of `keys`, under the reference's per-column rule: a null matches
    invalid rows, a string matches its chunk-local code, any other value
    `data == value` over valid rows. The first key column of the whole
    batch is searched in the chunk's key index at once; the other columns
    are checked on each key's candidates."""
    out = [_NO_ROWS] * len(keys)
    if chunk.row_count == 0 or not keys:
        return out
    order, values, null_rows = _key_index(chunk, schema, host_planes)
    first = chunk.columns[schema.key_column_names[0]]
    at, needles = [], []
    for i, key in enumerate(keys):
        value = key[0]
        if value is None:
            out[i] = _rest_of_key(chunk, schema, key, host_planes, null_rows)
            continue
        if first.type is EValueType.string:
            value = _string_code(first, value)
            if value is None:
                continue
        if _fits(value, values.dtype):
            at.append(i)
            needles.append(value)
    if at:
        needles = np.asarray(needles, dtype=values.dtype)
        los = np.searchsorted(values, needles, "left").tolist()
        his = np.searchsorted(values, needles, "right").tolist()
        for i, lo, hi in zip(at, los, his):
            if hi > lo:
                out[i] = _rest_of_key(chunk, schema, keys[i], host_planes,
                                      order[lo:hi])
    return out


def _rest_of_key(chunk: ColumnarChunk, schema: TableSchema, key: tuple,
                 host_planes: dict, rows: np.ndarray) -> np.ndarray:
    """The candidate `rows` whose key columns after the first equal
    `key`'s."""
    for name, value in zip(schema.key_column_names[1:], key[1:]):
        if not len(rows):
            break
        col = chunk.columns[name]
        data, valid = host_planes[name]
        if value is None:
            rows = rows[~valid[rows]]
        elif col.type is EValueType.string:
            code = _string_code(col, value)
            if code is None:
                return _NO_ROWS
            rows = rows[valid[rows] & (data[rows] == code)]
        else:
            rows = rows[valid[rows] & (data[rows] == value)]
    return rows


def _chunk_last_timestamps(chunk: ColumnarChunk, schema: TableSchema,
                           keys: "Sequence[tuple]", host_planes: dict
                           ) -> "list[Optional[int]]":
    """The newest version timestamp of each key in a versioned chunk (None
    where the key has none)."""
    ts = host_planes["$timestamp"][0] if chunk.row_count else None
    return [int(ts[rows].max()) if len(rows) else None
            for rows in _chunk_keys_indices(chunk, schema, keys,
                                            host_planes)]


def _chunk_key_rows(chunk: ColumnarChunk, schema: TableSchema,
                    key: tuple, host_planes: dict) -> list[dict]:
    """Rows matching `key` in a versioned chunk: searched in the cached
    host key index, then decode ONLY the matched rows."""
    return _decode_chunk_rows(
        chunk, host_planes,
        _chunk_keys_indices(chunk, schema, [key], host_planes)[0])


def _decode_chunk_rows(chunk: ColumnarChunk, host_planes: dict,
                       idx) -> list[dict]:
    """Decode only the rows at `idx` (usually tiny vs the chunk)."""
    n = chunk.row_count
    rows = []
    cols = {name: chunk.columns[name] for name in chunk.schema.column_names}
    host = host_planes
    for i in idx:
        row = {}
        for name, col in cols.items():
            data, valid = host[name]
            if not valid[i]:
                row[name] = None
            elif col.type is EValueType.string:
                row[name] = bytes(col.dictionary[int(data[i])])
            elif col.type is EValueType.any:
                row[name] = (col.host_values or [None] * n)[i]
            elif isinstance(col.type, VectorType):
                row[name] = [float(x) for x in data[i]]
            elif col.type is EValueType.boolean:
                row[name] = bool(data[i])
            elif col.type is EValueType.double:
                row[name] = float(data[i])
            elif col.type is EValueType.null:
                row[name] = None
            else:
                row[name] = int(data[i])
        rows.append(row)
    return rows
