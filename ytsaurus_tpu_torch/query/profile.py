"""Per-query execution profiles + the bounded flight recorder.

Ref shape: the reference folds per-subquery TQueryStatistics up the
coordinator tree and exposes them with the query response
(client/query_client/query_statistics.h); slow queries additionally land
in a structured query log.  Here the finished trace spans of one query
fold into an `ExecutionProfile` — the EXPLAIN ANALYZE answer: wall /
compile / execute split (the first question any profile of a compiled
engine must answer — "An Empirical Analysis of Just-in-Time Compilation
in Modern Databases", PAPERS.md), rows scanned vs returned, retry
counters, and the span tree — returned on the opt-in
`explain_analyze=` flag of `select_rows` and retained in the
FlightRecorder's bounded slow-query log (threshold + sampling from
config.TracingConfig).

Own copy of the JAX package's `query/profile.py`.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Optional

from ytsaurus_tpu_torch.utils import tracing


class ExecutionProfile:
    """One query's structured profile (EXPLAIN ANALYZE payload)."""

    __slots__ = ("query", "trace_id", "pool", "user", "started_at",
                 "wall_time", "admission_wait", "compile_time",
                 "execute_time", "statistics", "rows")

    def __init__(self, query: str, trace_id: Optional[str], pool: str,
                 started_at: float, wall_time: float,
                 admission_wait: float, compile_time: float,
                 execute_time: float, statistics: dict,
                 rows: Optional[list] = None,
                 user: Optional[str] = None):
        self.query = query
        self.trace_id = trace_id
        self.pool = pool
        self.user = user or "root"
        self.started_at = started_at
        self.wall_time = wall_time
        self.admission_wait = admission_wait
        self.compile_time = compile_time
        self.execute_time = execute_time
        self.statistics = statistics
        self.rows = rows

    @classmethod
    def capture(cls, root_span, query: str, statistics: Optional[dict],
                wall_time: float,
                pool: Optional[str] = None,
                user: Optional[str] = None) -> "ExecutionProfile":
        """Fold one finished query into a profile. `statistics` is the
        query's `QueryStatistics.to_dict()`, admission wait included, so
        an unsampled query (`root_span` the NULL span) carries it too,
        just no trace id / span tree.  `user` defaults to the ambient
        authenticated principal, so per-tenant accounting attributes the
        query even on proxy paths that never pass identity
        explicitly."""
        statistics = statistics or {}
        trace_id = getattr(root_span, "trace_id", None)
        if user is None:
            from ytsaurus_tpu_torch.cypress.security import current_user
            user = current_user()
        return cls(query=query[:500], trace_id=trace_id,
                   pool=pool or "default", user=user,
                   started_at=time.time(), wall_time=wall_time,
                   admission_wait=float(
                       statistics.get("admission_wait", 0.0)),
                   compile_time=float(statistics.get("compile_time", 0.0)),
                   execute_time=float(statistics.get("execute_time", 0.0)),
                   statistics=statistics)

    def span_tree(self) -> list[dict]:
        if self.trace_id is None:
            return []
        return tracing.span_tree(self.trace_id)

    def without_rows(self) -> "ExecutionProfile":
        """Shallow copy with the result rows dropped — what the flight
        recorder retains (profiles are bounded; result sets are not)."""
        if self.rows is None:
            return self
        clone = ExecutionProfile.__new__(ExecutionProfile)
        for slot in self.__slots__:
            setattr(clone, slot, getattr(self, slot))
        clone.rows = None
        return clone

    def to_dict(self, include_rows: bool = True) -> dict:
        out = {k: getattr(self, k) for k in self.__slots__ if k != "rows"}
        out["span_tree"] = self.span_tree()
        if include_rows and self.rows is not None:
            out["rows"] = self.rows
        return out

    def format(self) -> str:
        """Pretty text rendering (the CLI's EXPLAIN ANALYZE output)."""
        return format_profile_dict(self.to_dict(include_rows=False))


def _ms(seconds: float) -> str:
    return f"{seconds * 1e3:.2f}ms"


def format_profile_dict(p: dict) -> str:
    """THE EXPLAIN ANALYZE renderer, over the profile's dict form — one
    implementation for the in-process client (via ExecutionProfile.
    format) and the remote/HTTP CLI path (which only has the dict)."""
    stats = p.get("statistics") or {}
    lines = [
        f"query: {p.get('query')}",
        f"trace_id: {p.get('trace_id') or '<unsampled>'}  "
        f"pool: {p.get('pool')}  user: {p.get('user', 'root')}",
        f"wall {_ms(p.get('wall_time', 0.0))}  "
        f"(admission {_ms(p.get('admission_wait', 0.0))}, "
        f"compile {_ms(p.get('compile_time', 0.0))}, "
        f"execute {_ms(p.get('execute_time', 0.0))})",
        f"rows read {stats.get('rows_read', 0)} -> returned "
        f"{stats.get('rows_written', 0)}; shards "
        f"{stats.get('shards_total', 0)} "
        f"(pruned {stats.get('shards_pruned', 0)}, skipped "
        f"{stats.get('shards_skipped', 0)})",
        # which execution tier served the query — the first
        # question a cold-shape latency investigation asks.
        f"execution tier: {stats.get('execution_tier', 'compiled')}",
        # whether string predicates ran on dict codes or fell
        # back to the decoded remap-table path.
        f"execution: {stats.get('execution_encoding', 'encoded')}",
    ]
    # which pow2 capacity buckets the programs ran against — per-query
    # bucket churn is a shape-spectrum leak.
    buckets = stats.get("capacity_buckets") or []
    if buckets:
        lines.append(f"capacity buckets {[int(b) for b in buckets]}")
    # which distributed lowering served the query — the fused
    # whole-plan program (one host sync) or the stitched ladder.
    if stats.get("whole_plan"):
        lines.append(
            f"distributed: whole-plan fused SPMD (overflow retries "
            f"{stats.get('whole_plan_retries', 0)})")
    # the cost-based join plan — execution order, per-side
    # broadcast/partition choice, estimated vs actual cardinality per
    # stage.  A bad plan (estimate orders of magnitude off the actual)
    # is diagnosable from the slow log without re-running the query.
    join_stages = [e for e in (stats.get("join_plan") or []) if e]
    if join_stages:
        from ytsaurus_tpu_torch.query.planner import est_drift
        lines.append("join plan:")
        for i, entry in enumerate(join_stages):
            drift = est_drift(entry.get("est_rows", 0),
                              entry.get("actual_rows", 0))
            lines.append(
                f"  {i + 1}. {entry.get('table')} "
                f"[{entry.get('strategy')}] est rows "
                f"{entry.get('est_rows', 0)} -> actual "
                f"{entry.get('actual_rows', 0)} (drift {drift})")
    # the mesh telemetry block(s) each SPMD program returned
    # stacked with its result — per-shard row spread (the skew answer),
    # exchange traffic with quota headroom, and the compile-time memory
    # watermark.  Zero extra host syncs bought all of this.
    mesh_blocks = [b for b in (stats.get("mesh_blocks") or []) if b]
    if mesh_blocks:
        lines.append("mesh telemetry:")
        for i, blk in enumerate(mesh_blocks):
            out_rows = sorted(int(r) for r in blk.get("out_rows") or ())
            if out_rows:
                spread = (f"rows/shard min {out_rows[0]} / median "
                          f"{out_rows[len(out_rows) // 2]} / max "
                          f"{out_rows[-1]}")
            else:
                spread = "rows/shard n/a"
            lines.append(
                f"  {i + 1}. {blk.get('path', 'fused')} shards "
                f"{blk.get('shards', 0)}  {spread}  skew "
                f"{blk.get('skew', 1.0)}")
            for ex in blk.get("exchanges") or ():
                lines.append(
                    f"     exchange {ex.get('stage')}: "
                    f"{ex.get('rows', 0)} rows / {ex.get('bytes', 0)} "
                    f"bytes; quota {ex.get('quota', 0)} granted / "
                    f"{ex.get('demand', 0)} demanded (headroom "
                    f"{ex.get('headroom', 0.0)})")
            watermark = blk.get("memory_watermark_bytes")
            if watermark:
                lines.append(
                    f"     memory watermark {int(watermark)} bytes")
    tree = p.get("span_tree") or []
    if tree:
        lines.append("spans:")
        lines.extend(format_span_tree(tree))
    return "\n".join(lines)


def format_span_tree(nodes: list[dict], indent: int = 0) -> list[str]:
    """Indented one-line-per-span rendering of a span_tree() forest."""
    lines = []
    for node in nodes:
        tags = {k: v for k, v in (node.get("tags") or {}).items()}
        tag_str = "  " + " ".join(f"{k}={v}" for k, v in
                                  sorted(tags.items())) if tags else ""
        lines.append(f"{'  ' * indent}- {node['name']} "
                     f"{_ms(node.get('duration', 0.0))}{tag_str}")
        lines.extend(format_span_tree(node.get("children") or [],
                                      indent + 1))
    return lines


class FlightRecorder:
    """Bounded per-process retention of finished query profiles.

    Queries at/above TracingConfig.slow_query_threshold ALWAYS land in
    the slow log; the rest are sampled at `sample_rate` into the recent
    log.  Both logs are bounded deques — memory stays constant no matter
    the query rate."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slow: "deque[ExecutionProfile]" = deque(maxlen=128)
        self._recent: "deque[ExecutionProfile]" = deque(maxlen=128)

    def _apply_config(self, cfg) -> None:
        if self._slow.maxlen != cfg.slow_log_capacity:
            with self._lock:
                self._slow = deque(self._slow,
                                   maxlen=cfg.slow_log_capacity)
        if self._recent.maxlen != cfg.recent_log_capacity:
            with self._lock:
                self._recent = deque(self._recent,
                                     maxlen=cfg.recent_log_capacity)

    def observe(self, profile: ExecutionProfile) -> None:
        from ytsaurus_tpu_torch.config import tracing_config
        cfg = tracing_config()
        if not cfg.enabled:
            return
        self._apply_config(cfg)
        # Never retain result rows: the logs bound PROFILES, a pinned
        # explain_analyze result set would not be bounded by anything.
        profile = profile.without_rows()
        with self._lock:
            if profile.wall_time >= cfg.slow_query_threshold:
                self._slow.append(profile)
            elif cfg.sample_rate >= 1.0 or \
                    random.random() < cfg.sample_rate:
                self._recent.append(profile)

    def slow_queries(self) -> list[ExecutionProfile]:
        with self._lock:
            return list(self._slow)

    def recent(self) -> list[ExecutionProfile]:
        with self._lock:
            return list(self._recent)

    def clear(self) -> None:
        with self._lock:
            self._slow.clear()
            self._recent.clear()

    def snapshot(self) -> dict:
        """Monitoring view (profiles without result rows)."""
        return {
            "slow_queries": [p.to_dict(include_rows=False)
                             for p in self.slow_queries()],
            "recent": [p.to_dict(include_rows=False)
                       for p in self.recent()],
        }


_recorder = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _recorder
