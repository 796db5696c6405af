"""Ordered tablets: append-only row logs (queue tables).

Port of the JAX package's `tablet/ordered.py` (`ordered_chunk_schema`,
`OrderedTablet`: `append_rows`, `flush`, `set_in_memory`, `row_count`,
`read_rows`, `trim_rows`, `snapshot`).

Ref: tablet_node/ordered_dynamic_store.h + queue_client consumer model
(client/queue_client/consumer_client.h). Rows have an implicit global
$row_index (append order) and $timestamp; reads are offset-based; trim
drops a prefix. Flushing writes index-stamped columnar chunks so the
on-disk form is queryable like any static chunk.

The answers are the reference's: the same rows, in the same order, with
the same values, and a flushed chunk's blob is byte for byte the
reference's for the same rows. The means differ where the reference loops
over rows:
  * the tablet holds a `ChunkCache` on its device (`device=`, default
    "cuda", which raises without a card);
  * `flush` builds the chunk's planes from the store's columns, not
    through a dict per row;
  * a flushed chunk's rows lie in $row_index order, so `read_rows` slices
    only the rows of each chunk that overlap the range (by
    `chunk_ranges`) and converts only those;
  * `snapshot` concatenates the live chunks' planes with the store's rows
    on the device and drops the trimmed rows and those above the
    timestamp there. Its string columns carry the union of the chunks'
    vocabularies, so their codes differ from the reference's, which
    rebuilds the chunk from rows; `to_rows` gives the same rows.
"""

from __future__ import annotations

import threading
from dataclasses import replace
from typing import Optional, Sequence

import numpy as np
import torch

from ytsaurus_tpu_torch.chunks.columnar import (
    Column,
    ColumnarChunk,
    _build_column,
    concat_chunks,
    pad_capacity,
)
from ytsaurus_tpu_torch.chunks.store import ChunkCache, FsChunkStore
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.schema import EValueType, TableSchema
from ytsaurus_tpu_torch.tablet.dynamic_store import OrderedDynamicStore
from ytsaurus_tpu_torch.tablet.tablet import _normalize_value


def ordered_chunk_schema(schema: TableSchema) -> TableSchema:
    cols = [("$row_index", "int64", "ascending"), ("$timestamp", "int64")]
    cols += [(c.name, c.type.value) for c in schema]
    return TableSchema.make(cols)


def _normalizer(ty):
    """`_normalize_value` for one column type, as one function."""
    if ty in (EValueType.int64, EValueType.uint64):
        return lambda v: None if v is None else int(v)
    if ty is EValueType.double:
        return lambda v: None if v is None else float(v)
    return lambda v: _normalize_value(v, ty)


class OrderedTablet:
    def __init__(self, schema: TableSchema, chunk_store: FsChunkStore,
                 tablet_id: str = "0",
                 chunk_cache: Optional[ChunkCache] = None,
                 device: "str | torch.device" = DEFAULT_DEVICE):
        if schema.is_sorted:
            raise YtError("Ordered tablets require an unsorted schema",
                          code=EErrorCode.TabletNotMounted)
        self.schema = schema
        self.tablet_id = tablet_id
        self.chunk_store = chunk_store
        self.device = resolve_device(device)
        self.chunk_cache = chunk_cache or ChunkCache(chunk_store,
                                                     device=self.device)
        self.store = OrderedDynamicStore(schema)
        self.chunk_ids: list[str] = []
        self.chunk_ranges: list[tuple[int, int]] = []   # [start, end) per chunk
        self.base_index = 0          # first index still in the active store
        self.trimmed_count = 0
        self.mounted = True
        self.in_memory = False
        self._lock = threading.RLock()
        self._chunk_schema = ordered_chunk_schema(schema)
        self._names = {c.name for c in schema}
        self._normalizers = [(c.name, _normalizer(c.type)) for c in schema]

    # -- writes ----------------------------------------------------------------

    def append_rows(self, rows: Sequence[dict], timestamp: int) -> int:
        """Returns the $row_index of the first appended row."""
        with self._lock:
            if not self.mounted:
                raise YtError(f"Tablet {self.tablet_id} is not mounted",
                              code=EErrorCode.TabletNotMounted)
            first = self.base_index + self.store.row_count
            normalized = []
            try:
                for row in rows:
                    if self.schema.strict:
                        unknown = set(row) - self._names
                        if unknown:
                            raise YtError(
                                f"Unknown columns {sorted(unknown)}",
                                code=EErrorCode.QueryTypeError)
                    normalized.append({name: normalize(row.get(name))
                                       for name, normalize
                                       in self._normalizers})
            finally:
                # The rows before a refused one stay appended, as the
                # reference appends row by row.
                self.store.append_rows(normalized, timestamp)
            return first

    # -- flush -----------------------------------------------------------------

    def _store_chunk(self) -> ColumnarChunk:
        """The store's rows as a chunk of the flushed layout ($row_index,
        $timestamp, then the columns) on the tablet's device."""
        stamps, values = self.store.columns([c.name for c in self.schema])
        n = len(stamps)
        cap = pad_capacity(max(n, 1))
        planes = {"$row_index": np.arange(self.base_index,
                                          self.base_index + n,
                                          dtype=np.int64),
                  "$timestamp": np.asarray(stamps, dtype=np.int64)}
        columns: dict[str, Column] = {}
        for name, plane in planes.items():
            data = np.zeros(cap, dtype=np.int64)
            data[:n] = plane
            valid = np.zeros(cap, dtype=bool)
            valid[:n] = True
            columns[name] = Column(
                type=EValueType.int64,
                data=torch.from_numpy(data).to(self.device),
                valid=torch.from_numpy(valid).to(self.device))
        for col in self.schema:
            columns[col.name] = _build_column(
                self._chunk_schema.get(col.name).type, values[col.name],
                cap, self.device, col.name)
        return ColumnarChunk(schema=self._chunk_schema, row_count=n,
                             columns=columns)

    def flush(self) -> Optional[str]:
        with self._lock:
            n = self.store.row_count
            if n == 0:
                return None
            chunk_id = self.chunk_store.write_chunk(self._store_chunk())
            self.chunk_ids.append(chunk_id)
            if self.in_memory:
                self.chunk_cache.pin(chunk_id)
            self.chunk_ranges.append((self.base_index, self.base_index + n))
            self.base_index += n
            self.store = OrderedDynamicStore(self.schema)
            return chunk_id

    def set_in_memory(self, enabled: bool) -> None:
        with self._lock:
            self.in_memory = enabled
            for cid in self.chunk_ids:
                if enabled:
                    self.chunk_cache.pin(cid)
                else:
                    self.chunk_cache.unpin(cid)

    # -- reads -----------------------------------------------------------------

    @property
    def row_count(self) -> int:
        with self._lock:
            return self.base_index + self.store.row_count

    def read_rows(self, start_index: int = 0,
                  limit: Optional[int] = None) -> list[dict]:
        """Rows with $row_index ≥ start_index (post-trim), up to limit."""
        with self._lock:
            start_index = max(start_index, self.trimmed_count)
            end = self.row_count if limit is None else start_index + limit
            out: list[dict] = []
            for chunk_id, (lo, hi) in zip(self.chunk_ids, self.chunk_ranges):
                if hi <= start_index or lo >= end:
                    continue
                chunk = self.chunk_cache.get(chunk_id)
                out += chunk.slice_rows(max(start_index, lo) - lo,
                                        min(end, hi) - lo).to_rows()
            if end > self.base_index:
                first = max(0, start_index - self.base_index)
                for row in self.store.read(first, end - self.base_index
                                           - first):
                    row["$row_index"] += self.base_index
                    out.append(row)
            return out

    def trim_rows(self, trimmed_count: int) -> None:
        """Logically drop rows below `trimmed_count`; physically drop chunks
        that are entirely trimmed (ref store_trimmer)."""
        with self._lock:
            if trimmed_count > self.row_count:
                raise YtError("Cannot trim beyond the last row")
            self.trimmed_count = max(self.trimmed_count, trimmed_count)
            keep_ids, keep_ranges = [], []
            for chunk_id, (lo, hi) in zip(self.chunk_ids, self.chunk_ranges):
                if hi <= self.trimmed_count:
                    self.chunk_store.remove_chunk(chunk_id)
                    self.chunk_cache.invalidate(chunk_id)
                else:
                    keep_ids.append(chunk_id)
                    keep_ranges.append((lo, hi))
            self.chunk_ids = keep_ids
            self.chunk_ranges = keep_ranges

    def snapshot(self, timestamp: "Optional[int]" = None) -> ColumnarChunk:
        """All live rows (incl. $row_index/$timestamp) as one chunk for
        queries. With `timestamp`, only rows whose commit $timestamp is
        ≤ it — the consistent-cut form deferred multi-tablet scans pin
        to, so every shard of an ordered table reads the SAME moment no
        matter when its snapshot supplier actually runs."""
        with self._lock:
            parts = [self.chunk_cache.get(cid) for cid in self.chunk_ids]
            if self.store.row_count or not parts:
                parts.append(self._store_chunk())
            trimmed = self.trimmed_count
        chunk = concat_chunks(parts)
        keep = chunk.column("$row_index").data >= trimmed
        if timestamp is not None:
            keep &= chunk.column("$timestamp").data <= timestamp
        keep &= chunk.row_valid
        return _take_rows(chunk, keep, self._chunk_schema.to_unsorted())


def _take_rows(chunk: ColumnarChunk, keep: torch.Tensor,
               schema: TableSchema) -> ColumnarChunk:
    """The rows of `chunk` where `keep` holds, in order, as a chunk of
    `schema` (one host read: the count)."""
    idx = torch.nonzero(keep).flatten()
    n = int(idx.numel())
    if n == chunk.row_count:
        return ColumnarChunk(schema=schema, row_count=n,
                             columns=chunk.columns)
    cap = pad_capacity(max(n, 1))
    host_idx = None
    columns: dict[str, Column] = {}
    for name, col in chunk.columns.items():
        data = torch.zeros((cap,) + tuple(col.data.shape[1:]),
                           dtype=col.data.dtype, device=col.data.device)
        valid = torch.zeros(cap, dtype=torch.bool, device=col.valid.device)
        data[:n] = col.data[idx]
        valid[:n] = col.valid[idx]
        host_values = None
        if col.host_values is not None:
            if host_idx is None:
                host_idx = idx.cpu().tolist()
            host_values = [col.host_values[i] for i in host_idx] + \
                [None] * (cap - n)
        columns[name] = replace(col, data=data, valid=valid,
                                host_values=host_values)
    return ColumnarChunk(schema=schema, row_count=n, columns=columns)
