"""Chunk merger: background compaction of small static-table chunks.

Ref: server/master/chunk_server/chunk_merger.h:136 — masters walk
tables accumulating many small chunks (append-heavy write patterns) and
merge runs of them into fewer, larger chunks, so reads stop paying
per-chunk overhead and the chunk count stays bounded.

Own copy of the JAX package's `server/chunk_merger.py`. The merge itself
is one device concat over the columnar planes (`concat_chunks`,
vocabulary unification included) on the primary's device, where the
cluster's chunk cache decodes the chunks, not a row-by-row rewriting
job.  The swap is a compare-and-set under
the master mutation lock: the expensive read+concat runs OUTSIDE the
lock against a snapshot of @chunk_ids, and the table only adopts the
merged chunk if its chunk list is still exactly that snapshot —
concurrent writers win, the merger retries next scan.  Old chunks are
NOT deleted here: copied tables share chunk ids, so reclamation stays
with the reference-counting GC (client.collect_garbage).
"""

from __future__ import annotations

import threading
from typing import Optional

from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("chunk_merger")

DEFAULT_MIN_CHUNK_ROWS = 1 << 20        # below this a chunk is "small"
DEFAULT_MAX_MERGE_CHUNKS = 16           # cap per merged output


class ChunkMerger:
    """Scans the metadata tree for mergeable static tables."""

    def __init__(self, client, min_chunk_rows: int = DEFAULT_MIN_CHUNK_ROWS,
                 max_merge_chunks: int = DEFAULT_MAX_MERGE_CHUNKS,
                 interval: float = 30.0):
        self.client = client
        self.min_chunk_rows = min_chunk_rows
        self.max_merge_chunks = max_merge_chunks
        self.interval = interval
        self.stats = {"scans": 0, "tables_merged": 0,
                      "chunks_merged_away": 0, "cas_races_lost": 0}
        # path → (chunk-id tuple, row counts): an unchanged table whose
        # stats predate $row_count is decoded at most once per process.
        self._row_count_memo: \
            "dict[str, tuple[tuple, list[int]]]" = {}
        self._stop = threading.Event()
        self._thread: "Optional[threading.Thread]" = None

    _MEMO_LIMIT = 512          # stats-less tables memoized at once

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "ChunkMerger":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="chunk-merger")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.scan_once()
            except Exception:   # noqa: BLE001 — background scan survives
                logger.exception("chunk merger scan failed")

    # -- scanning --------------------------------------------------------------

    def _table_paths(self) -> "list[str]":
        """Static tables with a chunk list, discovered from the tree
        (runs in the primary; the merger is a master-side service)."""
        master = self.client.cluster.master
        out: list[str] = []
        with master.mutation_lock:
            stack = [("/", master.tree.root)]
            while stack:
                path, node = stack.pop()
                for name, child in list(node.children.items()):
                    child_path = f"//{name}" if path == "/" else \
                        f"{path}/{name}"
                    if child.type == "table" and \
                            not child.attributes.get("dynamic") and \
                            child.attributes.get("chunk_ids"):
                        out.append(child_path)
                    stack.append((child_path, child))
        return out

    def scan_once(self) -> int:
        """One pass over every static table; returns tables merged."""
        self.stats["scans"] += 1
        merged = 0
        for path in self._table_paths():
            try:
                if self._merge_table(path):
                    merged += 1
            except YtError as exc:
                logger.warning("merge of %s failed: %s", path, exc)
        return merged

    def _merge_plan(self, chunk_ids: "list[str]",
                    row_counts: "list[int]") -> "list[tuple[int, int]]":
        """[start, end) runs of ADJACENT small chunks worth merging —
        adjacency preserves both static row order and sorted-table key
        order (neighbor ranges abut)."""
        runs: list[tuple[int, int]] = []
        i = 0
        n = len(chunk_ids)
        while i < n:
            if row_counts[i] >= self.min_chunk_rows:
                i += 1
                continue
            j = i
            total = 0
            while j < n and row_counts[j] < self.min_chunk_rows and \
                    j - i < self.max_merge_chunks and \
                    total + row_counts[j] < 2 * self.min_chunk_rows:
                total += row_counts[j]
                j += 1
            if j - i >= 2:
                runs.append((i, j))
            i = max(j, i + 1)
        return runs

    def _row_counts(self, path: str, node,
                    snapshot_ids: "list[str]") -> "list[int]":
        """Per-chunk row counts from METADATA when available ($row_count
        in the aligned @chunk_stats); decoding every chunk of every
        table each scan would thrash the cache proportionally to total
        data size.  Old tables without the key decode once and memoize."""
        old_stats = list(node.attributes.get("chunk_stats") or [])
        if len(old_stats) == len(snapshot_ids) and \
                all(isinstance(s, dict) and "$row_count" in s
                    for s in old_stats):
            return [int(s["$row_count"]) for s in old_stats]
        ids = tuple(snapshot_ids)
        cached = self._row_count_memo.get(path)
        if cached is None or cached[0] != ids:
            counts = [self.client.cluster.chunk_cache.get(cid).row_count
                      for cid in snapshot_ids]
            # Keyed PER PATH (one entry per table, replaced when its
            # chunk list changes): a scan over many stats-less tables
            # must not evict each other's memo every table, or every
            # scan re-decodes every chunk of every such table.  Bounded
            # FIFO so deleted/renamed tables cannot leak entries in a
            # long-lived master process.
            while len(self._row_count_memo) >= self._MEMO_LIMIT:
                self._row_count_memo.pop(
                    next(iter(self._row_count_memo)))
            self._row_count_memo[path] = (ids, counts)
            return counts
        return cached[1]

    def _merge_table(self, path: str) -> bool:
        from ytsaurus_tpu_torch.chunks.columnar import concat_chunks

        client = self.client
        master = client.cluster.master
        node = master.tree.try_resolve(path)
        if node is None or node.attributes.get("dynamic"):
            return False
        snapshot_ids = list(node.attributes.get("chunk_ids") or [])
        if len(snapshot_ids) < 2:
            return False
        runs = self._merge_plan(snapshot_ids,
                                self._row_counts(path, node,
                                                 snapshot_ids))
        if not runs:
            return False
        # Expensive device work OUTSIDE the mutation lock — only the
        # chunks in merge runs are fetched.  New chunks are registered
        # as protected BEFORE they hit the store: a concurrent GC sweep
        # in the write→CAS window must not reclaim them.
        protected = client.cluster.protected_chunk_ids
        replacements = []               # (start, end, new_id, new_stats)
        try:
            for start, end in runs:
                merged = concat_chunks(
                    [client.cluster.chunk_cache.get(cid)
                     for cid in snapshot_ids[start:end]])
                new_id = client.cluster.chunk_store.write_chunk(merged)
                protected.add(new_id)
                # Stats were computed inside the serialize pass (chunk
                # meta); read_stats is a meta parse, so the unprotected
                # window stays write→add sized.
                stats = client.cluster.chunk_store.read_stats(new_id)
                replacements.append((start, end, new_id, stats))
        except BaseException:
            protected.difference_update(
                r[2] for r in replacements)
            raise
        new_ids: list[str] = []
        new_stats: list = []
        old_stats = list(node.attributes.get("chunk_stats") or [])
        stats_aligned = len(old_stats) == len(snapshot_ids)
        cursor = 0
        for start, end, new_id, stats in replacements:
            new_ids.extend(snapshot_ids[cursor:start])
            if stats_aligned:
                new_stats.extend(old_stats[cursor:start])
            new_ids.append(new_id)
            new_stats.append(stats)
            cursor = end
        new_ids.extend(snapshot_ids[cursor:])
        if stats_aligned:
            new_stats.extend(old_stats[cursor:])
        try:
            with master.mutation_lock:
                live = master.tree.try_resolve(path)
                current = list(live.attributes.get("chunk_ids") or []) \
                    if live is not None else None
                if current != snapshot_ids:
                    # A writer won the race; the freshly written merged
                    # chunks are unreferenced and fall to GC.
                    self.stats["cas_races_lost"] += 1
                    return False
                client.set(path + "/@chunk_ids", new_ids)
                if stats_aligned:
                    client.set(path + "/@chunk_stats", new_stats)
                elif self.client.exists(path + "/@chunk_stats"):
                    client.remove(path + "/@chunk_stats", force=True)
        finally:
            # Published (tree-referenced) or lost (garbage): either way
            # the protection window is over.
            protected.difference_update(r[2] for r in replacements)
        self.stats["tables_merged"] += 1
        self.stats["chunks_merged_away"] += \
            len(snapshot_ids) - len(new_ids)
        logger.info("merged %s: %d -> %d chunks", path,
                    len(snapshot_ids), len(new_ids))
        return True
