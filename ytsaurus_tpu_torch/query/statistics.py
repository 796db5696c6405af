"""Query statistics.

Own copy of the JAX package's `query/statistics.py` (ref
client/query_client/query_statistics.h TQueryStatistics), with the fields
the port's coordinator, degradation ladder and whole-plan rung write:
rows and bytes read and written, shard counts, retries, the whole-plan
flags, the join plan, and the mesh telemetry blocks with their roll-ups.
The reference's compile, tier, encoding and brown-out fields have no
counterpart: nothing here is compiled or served through a gateway.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class QueryStatistics:
    rows_read: int = 0
    rows_written: int = 0
    bytes_read: int = 0              # resident bytes of scanned planes
    shards_total: int = 0
    shards_skipped: int = 0          # LIMIT early exit left these unread
    shards_staged: int = 0           # lazy shards actually staged
    retries: int = 0                 # transient per-shard retry attempts
    # 1 when the whole-plan rung served the query; retries count its
    # exchange-quota overflow re-runs.
    whole_plan: int = 0
    whole_plan_retries: int = 0
    # One entry per join stage in execution order: the side strategy and
    # the estimated and actual rows.
    join_plan: list = field(default_factory=list)
    # Mesh telemetry blocks (parallel/mesh_observatory.py::mesh_block) and
    # their roll-ups.
    mesh_blocks: list = field(default_factory=list)
    mesh_skew_max: float = 0.0
    mesh_exchange_bytes: int = 0
    mesh_quota_headroom: float = 0.0
    mesh_memory_watermark_bytes: int = 0

    def note_mesh_block(self, block: dict) -> None:
        """Fold one mesh telemetry block into this query's statistics."""
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
