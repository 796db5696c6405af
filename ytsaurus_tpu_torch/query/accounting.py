"""Per-tenant resource accounting.

Ref shape: the reference meters every request against its (user, pool)
principal — operation pool trees account CPU/memory per pool, query
agents fold per-query statistics into per-user usage counters the
scheduler's fair-share and the admin `yt top`-style views read.  Here
the serving plane already threads an admitted query's identity
(CancellationToken pool + the authenticated-user contextvar) through
`coordinator.coordinate_and_execute`, the evaluator, and the tablet
read path; this module is where finished work FOLDS into cumulative
usage:

  select_rows      ExecutionProfile counters (rows read/returned, bytes
                   scanned, compile/execute seconds, admission wait,
                   retries) fold per (pool, user) in
                   `client.select_rows`.
  lookups          each batched flush folds its key/row counts under
                   the cohort's pool (query/serving.LookupBatcher).
  admission        rejects fold as `throttled` (AdmissionController).
  operations/jobs  each finished operation folds wall seconds + job
                   counts under its spec pool (operations/scheduler).
  views            each committed materialized-view micro-batch folds
                   rows + wall seconds under the view's pool
                   (query/views.ViewRefresher), so continuous-query
                   daemon load shows up in `yt top` like any tenant.

Cumulative per-POOL sensors mirror the fold into the profiler registry
(`accounting_usage_*{pool=}` on /metrics — bounded tag cardinality:
pools are config, users are not), so the history rings retain usage
trends; the full (pool, user) matrix serves through monitoring
`/accounting`, orchid `/accounting`, and the `yt top` CLI.  This is the
usage signal fair-share serving (ROADMAP 3) weighs pools by.

Own copy of the JAX package's `query/accounting.py`.
"""

from __future__ import annotations

from typing import Optional

from ytsaurus_tpu_torch.utils.profiling import PoolSensorCache, ProfilerRegistry
from ytsaurus_tpu_torch.utils import sanitizers

# The usage schema: one cumulative float per field per (pool, user).
USAGE_FIELDS = (
    "queries", "lookups", "rows_read", "rows_written", "bytes_read",
    "compile_seconds", "execute_seconds", "admission_wait_seconds",
    "wall_seconds", "retries",
    "throttled", "lookup_keys", "lookup_rows_found", "lookup_batches",
    "operations", "jobs", "view_batches", "view_rows",
    "nearest_queries", "nearest_batches", "nearest_rows_scanned",
)


class UsageRecord:
    """Cumulative usage of one (pool, user) principal."""

    __slots__ = USAGE_FIELDS

    def __init__(self):
        for field in USAGE_FIELDS:
            setattr(self, field, 0.0)

    def to_dict(self) -> dict:
        return {field: getattr(self, field) for field in USAGE_FIELDS}


class ResourceAccountant:
    """Cumulative per-(pool, user) usage, with per-pool sensor mirrors.

    Folds are a handful of float adds under one small lock — the
    per-query/per-flush cost the `telemetry_overhead` bench bounds."""

    def __init__(self, registry: Optional[ProfilerRegistry] = None):
        # guards: _usage
        self._lock = sanitizers.register_lock(
            "accounting.ResourceAccountant._lock")
        self._usage: dict[tuple[str, str], UsageRecord] = {}
        self._pool_sensors = PoolSensorCache(
            "/accounting/usage", USAGE_FIELDS, registry=registry)

    def fold(self, pool: Optional[str], user: Optional[str],
             **deltas) -> None:
        pool = pool or "default"
        user = user or "root"
        with self._lock:
            record = self._usage.get((pool, user))
            if record is None:
                record = self._usage[(pool, user)] = UsageRecord()
            counters = self._pool_sensors.counters(pool)
            for field, value in deltas.items():
                if value:
                    setattr(record, field,
                            getattr(record, field) + value)
                    counters[field].increment(value)

    # -- fold sites ------------------------------------------------------------

    def observe_query(self, profile, user: Optional[str] = None) -> None:
        """One finished select's ExecutionProfile → usage."""
        stats = profile.statistics or {}
        self.fold(
            profile.pool, user or getattr(profile, "user", None),
            queries=1,
            rows_read=stats.get("rows_read", 0),
            rows_written=stats.get("rows_written", 0),
            bytes_read=stats.get("bytes_read", 0),
            compile_seconds=profile.compile_time,
            execute_seconds=profile.execute_time,
            admission_wait_seconds=profile.admission_wait,
            wall_seconds=profile.wall_time,
            retries=stats.get("retries", 0))

    def observe_lookup(self, pool: Optional[str], user: Optional[str],
                       keys: int, rows_found: int) -> None:
        """One member REQUEST of a batched flush: keys/rows charge the
        requesting user."""
        self.fold(pool, user, lookups=1, lookup_keys=keys,
                  lookup_rows_found=rows_found)

    def observe_lookup_batch(self, pool: Optional[str],
                             user: Optional[str]) -> None:
        """One admitted flush (1:1 with the admission slot it held —
        the per-pool reconciliation unit), charged to the cohort
        opener like the slot itself."""
        self.fold(pool, user, lookup_batches=1)

    def observe_nearest(self, pool: Optional[str], user: Optional[str],
                        rows_scanned: int = 0) -> None:
        """One member NEAREST query of a batched cohort flush: the
        exhaustive-scan row count charges the requesting user (the
        vector analog of observe_lookup)."""
        self.fold(pool, user, nearest_queries=1,
                  nearest_rows_scanned=rows_scanned)

    def observe_nearest_batch(self, pool: Optional[str],
                              user: Optional[str]) -> None:
        """One admitted NEAREST cohort flush (one batched matmul, one
        admission slot), charged to the cohort opener."""
        self.fold(pool, user, nearest_batches=1)

    def observe_throttle(self, pool: Optional[str],
                         user: Optional[str] = None) -> None:
        self.fold(pool, user, throttled=1)

    def observe_view_batch(self, pool: Optional[str],
                           rows_read: int = 0, rows_written: int = 0,
                           wall_seconds: float = 0.0,
                           user: str = "view-daemon") -> None:
        """One committed materialized-view micro-batch: the
        refresh work lands under the VIEW's pool in the same rows/wall
        fields selects use, so `yt top` ranks a pool by its continuous-
        query load alongside its interactive traffic."""
        self.fold(pool, user, view_batches=1, view_rows=rows_read,
                  rows_read=rows_read, rows_written=rows_written,
                  wall_seconds=wall_seconds)

    def observe_operation(self, pool: Optional[str],
                          user: Optional[str], wall_seconds: float,
                          jobs: int = 0) -> None:
        """A terminal operation's wall time lands in the SAME
        wall_seconds field selects use — `yt top`'s default sort must
        rank a pool that only runs operations by what it consumed."""
        self.fold(pool, user, operations=1, jobs=jobs,
                  wall_seconds=wall_seconds)

    # -- views -----------------------------------------------------------------

    def totals(self) -> dict:
        """Plane-wide totals (the conservation invariant: these equal
        the sum over every per-pool and per-user roll-up)."""
        out = {field: 0.0 for field in USAGE_FIELDS}
        with self._lock:
            for record in self._usage.values():
                for field in USAGE_FIELDS:
                    out[field] += getattr(record, field)
        return out

    def snapshot(self) -> dict:
        with self._lock:
            records = [{"pool": pool, "user": user, **rec.to_dict()}
                       for (pool, user), rec in
                       sorted(self._usage.items())]
        by_pool: dict[str, dict] = {}
        by_user: dict[str, dict] = {}
        # Totals derive from the SAME copy as the roll-ups: a fold that
        # lands after the lock released must not make one snapshot's
        # totals disagree with the sum of its own records.
        totals = {field: 0.0 for field in USAGE_FIELDS}
        for record in records:
            for field in USAGE_FIELDS:
                totals[field] += record[field]
            for roll, key in ((by_pool, record["pool"]),
                              (by_user, record["user"])):
                agg = roll.setdefault(
                    key, {field: 0.0 for field in USAGE_FIELDS})
                for field in USAGE_FIELDS:
                    agg[field] += record[field]
        return {"records": records, "by_pool": by_pool,
                "by_user": by_user, "totals": totals}


_global_accountant: Optional[ResourceAccountant] = None
# guards: _global_accountant
_lock = sanitizers.register_lock("accounting._lock", hot=False)


def get_accountant() -> ResourceAccountant:
    global _global_accountant
    if _global_accountant is None:
        with _lock:
            if _global_accountant is None:
                _global_accountant = ResourceAccountant()
    return _global_accountant
