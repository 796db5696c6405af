"""Cost-based join order over chunk column statistics.

Port of the JAX package's `query/planner.py` (`stats_for_chunk`,
`plan_joins`, `apply_order`, `plan_for_chunks`, `reorder_for_chunks`),
so that a multi-way join runs in the same order in both packages (which
decides the row order of a LIMIT without ORDER BY):

  join order       inner joins reorder most-selective-first, by the
                   estimated output cardinality |R ⋈ S| = |R|·|S| /
                   max(ndv_R(k), ndv_S(k)), constrained by column
                   dependencies (a join whose key reads an earlier
                   join's pulled column cannot move before it) and by
                   LEFT-join barriers (outer joins keep their position).
  side strategy    broadcast vs partition, by the foreign row count
                   against `CompileConfig.broadcast_join_rows` (the
                   whole-plan rung's strategy; the single-device
                   evaluator runs every join the same way).
  semi-join ranges the [min, max] of a selective INNER side's key, pushed
                   toward the scan (recorded for parity as well).

The broadcast threshold is `CompileConfig.broadcast_join_rows` (the
port's `config.py`), at the reference's default. The reference's
`cost_join_planner` switch has no counterpart: the planner is always on.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, replace as dc_replace
from typing import Mapping, Optional

from ytsaurus_tpu_torch.chunks.columnar import chunk_column_stats, ndv_estimate
from ytsaurus_tpu_torch.config import compile_config
from ytsaurus_tpu_torch.query import ir

# Per-chunk stats memo, keyed by object identity with a liveness check.
_stats_lock = threading.Lock()
_stats_memo: dict = {}
_STATS_MEMO_LIMIT = 512


def stats_for_chunk(chunk) -> dict:
    """chunk_column_stats(chunk), memoized per chunk identity."""
    key = id(chunk)
    with _stats_lock:
        entry = _stats_memo.get(key)
        if entry is not None and entry[0]() is chunk:
            return entry[1]
    stats = chunk_column_stats(chunk)
    with _stats_lock:
        _stats_memo[key] = (weakref.ref(chunk), stats)
        while len(_stats_memo) > _STATS_MEMO_LIMIT:
            _stats_memo.pop(next(iter(_stats_memo)))
    return stats


def _stat_entry(stats: Optional[dict], name: str) -> Optional[dict]:
    if not stats:
        return None
    entry = stats.get(name)
    return entry if isinstance(entry, dict) else None


def _key_ndv(stats: Optional[dict], expr: ir.TExpr, rows: int) -> int:
    """NDV of a join-key expression: the sketch estimate for a bare
    column reference, else the conservative bound (row count)."""
    if isinstance(expr, ir.TReference):
        entry = _stat_entry(stats, expr.name)
        if entry is not None and entry.get("ndv_sketch") is not None:
            est = ndv_estimate(entry.get("ndv_sketch"))
            if est > 0:
                return min(est, max(rows, 1))
    return max(rows, 1)


@dataclass(frozen=True)
class JoinDecision:
    """One join's planned execution."""
    index: int              # position in the ORIGINAL plan.joins tuple
    strategy: str           # "broadcast" | "partition"
    est_in: int             # estimated rows entering the join
    est_out: int            # estimated rows leaving it
    foreign_rows: int
    pushdown: tuple = ()    # ((self_column, lo, hi), ...)


@dataclass(frozen=True)
class JoinPlan:
    """The planner's answer for one query's join set, in execution
    order."""
    decisions: tuple

    @property
    def order(self) -> tuple:
        return tuple(d.index for d in self.decisions)

    def pushdown_ranges(self) -> tuple:
        """Flat ((self_column, lo, hi), ...) across every decision."""
        out = []
        for d in self.decisions:
            out.extend(d.pushdown)
        return tuple(out)


def _base_columns(plan: ir.Query) -> set:
    """Self-table columns (plan.schema minus join-contributed names)."""
    joined = set()
    for join in plan.joins:
        joined |= _join_outputs(join)
    return {c.name for c in plan.schema if c.name not in joined}


def _join_outputs(join: ir.JoinClause) -> set:
    return {f"{join.alias}.{f}" if join.alias else f
            for f in join.foreign_columns}


def _join_inputs(join: ir.JoinClause) -> set:
    refs: set = set()
    for eq in join.self_equations:
        refs.update(ir.expr_references(eq))
    return refs


def _pushdown_for(join: ir.JoinClause, f_stats: Optional[dict],
                  base_columns: set) -> tuple:
    """Semi-join scan ranges a selective INNER side implies: bare column =
    bare column equations with bounded foreign stats only."""
    if join.is_left or not f_stats:
        return ()
    out = []
    for self_eq, f_eq in zip(join.self_equations, join.foreign_equations):
        if not (isinstance(self_eq, ir.TReference)
                and isinstance(f_eq, ir.TReference)):
            continue
        if self_eq.name not in base_columns:
            continue
        entry = _stat_entry(f_stats, f_eq.name)
        if entry is None:
            continue
        lo, hi = entry.get("min"), entry.get("max")
        if lo is None or hi is None:
            continue
        out.append((self_eq.name, lo, hi))
    return tuple(out)


def plan_joins(plan: ir.Query, self_rows: int,
               foreign_stats: Mapping[str, Optional[dict]],
               self_stats: Optional[dict] = None) -> Optional[JoinPlan]:
    """Plan `plan.joins` (None when there is nothing to plan).
    `foreign_stats` maps foreign table path → column
    stats; missing entries degrade that side to neutral estimates."""
    if not plan.joins:
        return None
    broadcast_cap = compile_config().broadcast_join_rows
    base = _base_columns(plan)

    # LEFT joins are barriers: blocks of consecutive INNER joins reorder
    # internally; everything else keeps declared order.
    blocks: list = []
    for i, join in enumerate(plan.joins):
        if join.is_left:
            blocks.append([i])
        elif blocks and not plan.joins[blocks[-1][0]].is_left \
                and not plan.joins[blocks[-1][-1]].is_left:
            blocks[-1].append(i)
        else:
            blocks.append([i])

    def f_rows_of(join) -> Optional[int]:
        stats = foreign_stats.get(join.foreign_table)
        if stats and "$row_count" in stats:
            return int(stats["$row_count"])
        return None                 # unknown, not the same as empty

    def est_factor(join, est_in: int) -> float:
        """|out| / |in| = |S| / max(ndv_R(k), ndv_S(k)), taking the most
        selective single key column of a multi-column key."""
        stats = foreign_stats.get(join.foreign_table)
        f_rows = f_rows_of(join)
        if f_rows is None:
            return 1.0
        if f_rows == 0:
            return 0.0 if not join.is_left else 1.0
        factor = float(f_rows)
        best = None
        for self_eq, f_eq in zip(join.self_equations,
                                 join.foreign_equations):
            ndv_f = _key_ndv(stats, f_eq, f_rows)
            ndv_s = _key_ndv(self_stats, self_eq, max(est_in, 1)) \
                if self_stats is not None else ndv_f
            cand = float(f_rows) / float(max(ndv_f, ndv_s, 1))
            best = cand if best is None else min(best, cand)
        if best is not None:
            factor = best
        if join.is_left:
            factor = max(factor, 1.0)
        return factor

    decisions: list = []
    est = max(self_rows, 1)
    for block in blocks:
        remaining = list(block)
        placed_outputs: set = set(base)
        for d in decisions:
            placed_outputs |= _join_outputs(plan.joins[d.index])
        while remaining:
            ready = [i for i in remaining
                     if _join_inputs(plan.joins[i]) <= placed_outputs]
            if not ready:
                # A key reads a column a LATER block pulls: declared order.
                ready = [remaining[0]]
            pick = min(ready,
                       key=lambda i: (est_factor(plan.joins[i], est), i))
            remaining.remove(pick)
            join = plan.joins[pick]
            f_rows = f_rows_of(join)
            est_out = max(int(est * est_factor(join, est)), 1)
            if join.is_left:
                est_out = max(est_out, est)
            strategy = "broadcast" if f_rows is not None \
                and 0 < f_rows <= broadcast_cap else "partition"
            decisions.append(JoinDecision(
                index=pick, strategy=strategy, est_in=est, est_out=est_out,
                foreign_rows=f_rows if f_rows is not None else 0,
                pushdown=_pushdown_for(
                    join, foreign_stats.get(join.foreign_table), base)))
            placed_outputs |= _join_outputs(join)
            est = est_out
    return JoinPlan(decisions=tuple(decisions))


def apply_order(plan: ir.Query, jplan: Optional[JoinPlan]) -> ir.Query:
    """The plan with joins permuted into execution order."""
    if jplan is None:
        return plan
    order = jplan.order
    if order == tuple(range(len(plan.joins))):
        return plan
    return dc_replace(plan, joins=tuple(plan.joins[i] for i in order))


def plan_for_chunks(plan: ir.Query, self_rows: int,
                    foreign_chunks: Optional[Mapping] = None,
                    foreign_stats: Optional[Mapping] = None
                    ) -> Optional[JoinPlan]:
    """plan_joins with stats from the materialized foreign chunks
    (memoized per chunk) unless stats are supplied."""
    if not plan.joins:
        return None
    stats: dict = dict(foreign_stats or {})
    for join in plan.joins:
        if join.foreign_table in stats:
            continue
        chunk = (foreign_chunks or {}).get(join.foreign_table)
        stats[join.foreign_table] = \
            stats_for_chunk(chunk) if chunk is not None else None
    return plan_joins(plan, self_rows, stats)


def est_drift(est_rows, actual_rows) -> float:
    """Relative estimate error |actual - est| / max(actual, 1); 0.0 when
    no estimate was recorded (est <= 0)."""
    est = int(est_rows or 0)
    actual = int(actual_rows or 0)
    if est <= 0:
        return 0.0
    return round(abs(actual - est) / float(max(actual, 1)), 4)


def reorder_for_chunks(plan: ir.Query, self_rows: int,
                       foreign_chunks: Optional[Mapping] = None
                       ) -> "tuple[ir.Query, Optional[JoinPlan]]":
    """(execution-ordered plan, JoinPlan): the one call the evaluator's
    join cascade makes."""
    jplan = plan_for_chunks(plan, self_rows, foreign_chunks)
    return apply_order(plan, jplan), jplan
