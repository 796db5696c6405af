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
  capacity_buckets  empty: there are no compiled program shapes
  execution_tier  "eager" (PyTorch runs each staged program eagerly)

The port adds the split of a query's wall time where the work happens
(STAGE_FIELDS, seconds): each is the self time of one stage
(utils/tracing.py::stage), so each second of the wall counts in at most
one of them, and what none covers is left over. `host_cpu_time` is the
CPU seconds of the query's own thread, less those spent waiting on the
device: a counter beside the wall, not a part of it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, fields

# The self-time fields, in the order a query meets them.
STAGE_FIELDS = ("admission_wait", "parse_time", "stage_time", "compile_time",
                "join_time", "dispatch_time", "device_wait", "to_rows_time")


@dataclass
class QueryStatistics:
    rows_read: int = 0
    rows_written: int = 0
    bytes_read: int = 0              # resident bytes of scanned planes
    # From the query's first shard dispatch (Evaluator.run_plan_async) to
    # its last row-count read, less the compile_time inside that span:
    # disjoint from compile_time and never above the wall.
    execute_time: float = 0.0
    compile_time: float = 0.0        # seconds in lowering.prepare
    admission_wait: float = 0.0      # QueryGateway: admission.admit
    parse_time: float = 0.0          # build_query to semi-join pushdown
    stage_time: float = 0.0          # fetching (or waiting for) shards
    join_time: float = 0.0           # execute_join
    dispatch_time: float = 0.0       # issuing each plan's kernels
    device_wait: float = 0.0         # blocked on the row-count reads
    to_rows_time: float = 0.0        # the result chunk to rows
    host_cpu_time: float = 0.0       # the query thread's CPU seconds
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

    # Not fields (no reader): the seconds that closed stages cover, for
    # each stage's self time, and where the execute span opened.
    staged_seconds = 0.0
    _execute_from = None
    _execute_compile0 = 0.0

    def open_execute(self) -> None:
        """A shard dispatch: the first opens the execute span."""
        if self._execute_from is None:
            self._execute_from = time.perf_counter()
            self._execute_compile0 = self.compile_time

    def close_execute(self) -> None:
        """A row-count read: the execute span runs to here."""
        if self._execute_from is not None:
            self.execute_time = (time.perf_counter() - self._execute_from -
                                 (self.compile_time - self._execute_compile0))

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
