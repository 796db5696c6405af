"""Query statistics.

Own copy of the JAX package's `query/statistics.py` (ref
client/query_client/query_statistics.h TQueryStatistics): the reference's
fields, so that the structured Query log, EXPLAIN ANALYZE and the serving
counters read the same keys in both packages. Nothing here is compiled,
so the compile fields mean what the port does instead:

  compile_time    seconds binding each plan to its chunk
                  (query/engine/lowering.py::prepare: expression binding,
                  vocabularies, capacity), the host work that stands where
                  the reference builds its device programs
  compile_count,  0: there is no program cache to miss or hit, and the
  cache_hits,     miss causes, capacity buckets and the artifact tiers
  compile_*       stay empty
  execution_tier  "eager" (PyTorch runs each staged program eagerly)
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields


@dataclass
class QueryStatistics:
    rows_read: int = 0
    rows_written: int = 0
    bytes_read: int = 0              # resident bytes of scanned planes
    execute_time: float = 0.0        # seconds, wall, incl. device sync
    compile_time: float = 0.0        # seconds building device programs
    compile_count: int = 0           # programs compiled (cache misses)
    cache_hits: int = 0
    # Compile-miss cause split: compile_count partitions into
    # never-seen plan shapes, known shapes meeting a new capacity/
    # binding shape (shape-spectrum growth), and LRU re-misses — so a
    # slow-query log entry answers "why did this recompile" directly.
    compile_new_fingerprint: int = 0
    compile_new_shape: int = 0
    compile_evicted: int = 0
    # Memory misses served by the persistent artifact tier:
    # deserialized ready executables, no fresh compile burn.  Fresh
    # compiles for a query = compile_count - compile_disk_hit.
    compile_disk_hit: int = 0
    shards_total: int = 0
    shards_pruned: int = 0
    shards_skipped: int = 0          # LIMIT early-exit left these unread
    shards_staged: int = 0           # shards actually fetched/decoded
    retries: int = 0                 # transient per-shard retry attempts
    joins_executed: int = 0
    # Whole-plan SPMD execution: 1 when the query was served
    # by the fused one-program rung (parallel/whole_plan.py); retries
    # count exchange-quota overflow re-runs (each a fresh pow2 rung of
    # the compile-once ladder, not a host sync).
    whole_plan: int = 0
    whole_plan_retries: int = 0
    # The pow2 capacity buckets this query's programs ran against
    #: per-query bucket churn is a shape-spectrum
    # leak EXPLAIN ANALYZE must surface.  A set, serialized sorted.
    capacity_buckets: set = field(default_factory=set)
    # Cost-based join plan: one entry per join stage in
    # EXECUTION order — chosen side strategy plus estimated-vs-actual
    # cardinality, so a bad plan is diagnosable from the slow log
    # without re-running.  Actuals/estimates ACCUMULATE across shard
    # programs (the host-coordinated cascade runs the stage per shard).
    join_plan: list = field(default_factory=list)
    # Brown-out ladder: non-zero when this response was
    # served DEGRADED — rung 1 reads the tablet snapshot cache within
    # the pool's staleness bound; degraded_staleness is the max
    # staleness (seconds) actually served.  Every degraded response is
    # tagged here, in the root span, and in the per-pool counters.
    degraded_rung: int = 0
    degraded_staleness: float = 0.0
    # Memory misses served by the CLUSTER artifact store (fetch-on-miss
    # from the chunk-backed tier): a replica joining mid-storm serves
    # its first queries with these instead of fresh compiles.
    compile_cluster_hit: int = 0
    # Which execution tier served the (last) dispatch of this query
    # "compiled", "interpreted" (the no-compile numpy
    # tier), or "promoted-midstream" (first compiled serve after a
    # background promotion swapped the program in mid-traffic).  A
    # string — the serving counters skip it (only numerics fold).
    execution_tier: str = "eager"
    # Which kernel-execution mode the string predicates ran in
    # "encoded" (dict-code compares, the shipping default)
    # or "decoded" (at least one predicate fell back to the merged-
    # vocab remap-table path).  Same string/fold discipline as
    # execution_tier.
    execution_encoding: str = "encoded"
    # Mesh execution telemetry: the versioned per-program
    # blocks the fused SPMD path returns stacked with its result (and
    # the stitched rungs assemble from host values they already read).
    # The list holds full blocks (EXPLAIN ANALYZE renders them); the
    # numeric roll-ups below auto-fold into /serving/query_stats.
    mesh_blocks: list = field(default_factory=list)
    mesh_skew_max: float = 0.0
    mesh_exchange_bytes: int = 0
    mesh_quota_headroom: float = 0.0
    mesh_memory_watermark_bytes: int = 0

    def note_mesh_block(self, block: dict) -> None:
        """Fold one mesh telemetry block (whole_plan._mesh_block shape)
        into this query's statistics."""
        self.mesh_blocks.append(block)
        self.mesh_skew_max = max(self.mesh_skew_max,
                                 float(block.get("skew", 0.0)))
        self.mesh_exchange_bytes += int(block.get("exchange_bytes", 0))
        self.mesh_quota_headroom = max(
            self.mesh_quota_headroom,
            max([float(e.get("headroom", 0.0))
                 for e in block.get("exchanges", ())] or [0.0]))
        watermark = int(block.get("memory_watermark_bytes") or 0)
        self.mesh_memory_watermark_bytes = max(
            self.mesh_memory_watermark_bytes, watermark)

    def note_join_stage(self, position: int, table: str, strategy: str,
                        est_rows: int = 0, actual_rows=None) -> None:
        while len(self.join_plan) <= position:
            self.join_plan.append(None)
        entry = self.join_plan[position]
        if entry is None:
            entry = {"table": table, "strategy": strategy,
                     "est_rows": 0, "actual_rows": 0}
            self.join_plan[position] = entry
        entry["est_rows"] += int(est_rows)
        if actual_rows is not None:
            entry["actual_rows"] += int(actual_rows)

    def to_dict(self) -> dict:
        out = {}
        for f in fields(self):
            value = getattr(self, f.name)
            out[f.name] = sorted(value) if isinstance(value, set) \
                else value
        return out
