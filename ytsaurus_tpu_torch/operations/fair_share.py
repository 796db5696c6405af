"""Fair-share scheduling math over a pool tree.

Ref shape: library/vector_hdrf/fair_share_update.h (multi-resource
dominant-fairness with piecewise-linear water filling) and the scheduler
strategy (server/scheduler/strategy) — pools carry weight + min-share
guarantees; operations map to pools; the scheduler serves the pool whose
usage is furthest below its fair share.

Redesign: the local job plane has ONE resource (worker slots), so vector
HDRF collapses to scalar progressive filling: min-share guarantees first,
then weight-proportional water filling of the remainder, capped by
demand.  Pool definitions live in Cypress (//sys/pools/<name>/@weight,
@min_share_ratio, @max_running_jobs) like the reference's pool trees.

Own copy of the JAX package's `operations/fair_share.py`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PoolState:
    name: str
    weight: float = 1.0
    min_share_ratio: float = 0.0
    max_running_jobs: int | None = None
    # live
    running: int = 0
    pending: int = 0
    fair_share: float = 0.0
    usage: float = 0.0

    @property
    def demand(self) -> int:
        return self.running + self.pending


def compute_fair_shares(pools: "list[PoolState]", total_slots: int) -> None:
    """Progressive filling: guarantee min(min_share, demand), then water-
    fill the remainder proportionally to weight, never past demand.
    Writes .fair_share / .usage on each pool (shares of total_slots)."""
    if total_slots <= 0:
        for p in pools:
            p.fair_share = p.usage = 0.0
        return
    demand = {p.name: min(p.demand / total_slots, 1.0) for p in pools}
    share = {p.name: min(p.min_share_ratio, demand[p.name]) for p in pools}
    budget = 1.0 - sum(share.values())
    # Water filling: raise unsatisfied pools proportionally to weight until
    # the budget is spent or every demand is met.
    for _ in range(32):                       # converges in <= |pools| steps
        unsat = [p for p in pools if share[p.name] < demand[p.name] - 1e-12]
        if not unsat or budget <= 1e-12:
            break
        weights = {p.name: max(p.weight, 0.0) for p in unsat}
        total_weight = sum(weights.values())
        if total_weight <= 0.0:
            # All-zero weights (user-configurable): split the remainder
            # evenly rather than dividing by zero.
            weights = {p.name: 1.0 for p in unsat}
            total_weight = float(len(unsat))
        step = budget / total_weight
        spent = 0.0
        for p in unsat:
            raise_by = min(step * weights[p.name],
                           demand[p.name] - share[p.name])
            share[p.name] += raise_by
            spent += raise_by
        budget -= spent
        if spent <= 1e-12:
            break
    for p in pools:
        p.fair_share = share[p.name]
        p.usage = p.running / total_slots


def pick_pool(pools: "list[PoolState]") -> "PoolState | None":
    """The pool to serve next: lowest usage-to-fair-share ratio among
    pools with pending demand and headroom."""
    best = None
    best_ratio = None
    for p in pools:
        if p.pending <= 0 or p.fair_share <= 0:
            continue
        if p.max_running_jobs is not None and \
                p.running >= p.max_running_jobs:
            continue
        ratio = p.usage / p.fair_share
        if best is None or ratio < best_ratio or \
                (ratio == best_ratio and p.name < best.name):
            best, best_ratio = p, ratio
    return best


def find_preemptable(pools: "list[PoolState]") -> "PoolState | None":
    """A pool running ABOVE fair share while some pool with pending work
    sits below its own (starvation) — its newest job may be preempted.
    Returns the most-over-share pool, or None when fairness holds."""
    starving = any(p.pending > 0 and
                   p.usage < p.fair_share - 1e-9 for p in pools)
    if not starving:
        return None
    over = [p for p in pools if p.running > 0 and
            p.usage > p.fair_share + 1e-9]
    if not over:
        return None
    return max(over, key=lambda p: p.usage - p.fair_share)
