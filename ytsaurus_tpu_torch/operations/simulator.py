"""Scheduler simulator: replay a synthetic workload through the
fair-share strategy in virtual time.

Ref: yt/yt/tools/scheduler_simulator (+ the scheduler_simulator
integration suite, yt/yt/tests/integration/scheduler_simulator): feed a
trace of operations (arrival time, job count, per-job duration, pool)
into the scheduling strategy with N virtual slots and measure per-pool
usage integrals, completion times, wait times, and preemptions —
without spawning a single real job.  Pool-tree changes and strategy
regressions are evaluated here before touching a cluster.

The simulated strategy IS the production one: PoolState +
compute_fair_shares + pick_pool + find_preemptable from
operations/fair_share.py drive both the live scheduler and this
event loop, so the simulator cannot drift from the shipped math.

Own copy of the JAX package's `operations/simulator.py`, over the
port's `operations/fair_share.py`. It runs on the host only.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Optional

from ytsaurus_tpu_torch.operations.fair_share import (
    PoolState,
    compute_fair_shares,
    find_preemptable,
    pick_pool,
)


@dataclass(frozen=True)
class SimPool:
    name: str
    weight: float = 1.0
    min_share_ratio: float = 0.0
    max_running_jobs: "Optional[int]" = None


@dataclass(frozen=True)
class SimOperation:
    id: str
    pool: str
    arrival: float              # virtual seconds
    n_jobs: int
    job_duration: float         # virtual seconds per job


@dataclass
class SimResult:
    makespan: float
    completions: dict           # op id → completion time
    wait_times: dict            # op id → first-job start − arrival
    pool_usage_integral: dict   # pool → slot·seconds actually used
    preemptions: int
    samples: list = field(default_factory=list)   # (t, {pool: running})

    def usage_ratio(self, a: str, b: str) -> float:
        return self.pool_usage_integral[a] / \
            max(self.pool_usage_integral[b], 1e-12)


def simulate(pools: "list[SimPool]", operations: "list[SimOperation]",
             total_slots: int, preemption: bool = True,
             max_virtual_time: float = 1e9) -> SimResult:
    """Event-driven loop: virtual time advances to the next arrival or
    job completion; every event triggers a scheduling pass that fills
    free slots via pick_pool and (optionally) preempts one over-share
    job per pass when a pool starves below fair share — the strategy's
    own preemption rule."""
    states = {p.name: PoolState(
        name=p.name, weight=p.weight, min_share_ratio=p.min_share_ratio,
        max_running_jobs=p.max_running_jobs) for p in pools}
    for op in operations:
        if op.pool not in states:
            raise ValueError(f"operation {op.id} names unknown pool "
                             f"{op.pool!r}")
    arrivals = sorted(operations, key=lambda o: (o.arrival, o.id))
    queued: dict[str, int] = {}          # op id → jobs waiting
    unfinished: dict[str, int] = {}      # op id → jobs not yet completed
    op_index = {op.id: op for op in operations}
    first_start: dict[str, float] = {}
    completions: dict[str, float] = {}
    usage_integral = {p.name: 0.0 for p in pools}
    samples: list = []
    # Running jobs: (finish_time, seq, op_id, start_time).  seq breaks
    # ties deterministically; the NEWEST job of a pool is its preemption
    # victim (speculative work lost is minimized), matching the live
    # scheduler's victim choice.
    running: list = []
    seq = 0
    slots_free = total_slots
    preemptions_total = 0
    t = 0.0
    i = 0

    def pool_running(name: str) -> int:
        return sum(1 for _, _, oid, _ in running
                   if op_index[oid].pool == name)

    def refresh_states() -> None:
        for name, state in states.items():
            state.running = pool_running(name)
            state.pending = sum(
                n for oid, n in queued.items()
                if n > 0 and op_index[oid].pool == name)
        compute_fair_shares(list(states.values()), total_slots)

    def start_one(pool_name: str) -> None:
        nonlocal seq, slots_free
        # FIFO among the pool's arrived operations.
        candidates = [oid for oid, n in queued.items()
                      if n > 0 and op_index[oid].pool == pool_name]
        oid = min(candidates,
                  key=lambda o: (op_index[o].arrival, o))
        queued[oid] -= 1
        first_start.setdefault(oid, t)
        seq += 1
        heapq.heappush(running,
                       (t + op_index[oid].job_duration, seq, oid, t))
        slots_free -= 1

    while t <= max_virtual_time:
        next_arrival = arrivals[i].arrival if i < len(arrivals) \
            else float("inf")
        next_finish = running[0][0] if running else float("inf")
        t_next = min(next_arrival, next_finish)
        if t_next == float("inf"):
            break
        for name in usage_integral:
            usage_integral[name] += pool_running(name) * (t_next - t)
        t = t_next
        while i < len(arrivals) and arrivals[i].arrival <= t:
            op = arrivals[i]
            queued[op.id] = queued.get(op.id, 0) + op.n_jobs
            unfinished[op.id] = unfinished.get(op.id, 0) + op.n_jobs
            i += 1
        while running and running[0][0] <= t:
            _, _, oid, _ = heapq.heappop(running)
            slots_free += 1
            unfinished[oid] -= 1
            if unfinished[oid] == 0 and queued.get(oid, 0) == 0:
                completions[oid] = t
        # Scheduling pass.
        preempted_this_pass = 0
        while True:
            refresh_states()
            if slots_free > 0:
                chosen = pick_pool(list(states.values()))
                if chosen is None:
                    break
                start_one(chosen.name)
                continue
            if not preemption or preempted_this_pass >= total_slots:
                break
            victim_pool = find_preemptable(list(states.values()))
            if victim_pool is None:
                break
            # Evict the victim pool's newest job; its work is requeued
            # whole (the live scheduler reschedules preempted jobs at
            # attempt+1 — lost progress is the cost of fairness).
            victims = [entry for entry in running
                       if op_index[entry[2]].pool == victim_pool.name]
            entry = max(victims, key=lambda e: (e[3], e[1]))
            running.remove(entry)
            heapq.heapify(running)
            queued[entry[2]] += 1
            slots_free += 1
            preempted_this_pass += 1
        samples.append((t, {name: pool_running(name)
                            for name in states}))
        preemptions_total += preempted_this_pass
    wait_times = {oid: first_start.get(oid, float("inf")) -
                  op_index[oid].arrival for oid in op_index}
    return SimResult(
        makespan=t, completions=completions, wait_times=wait_times,
        pool_usage_integral=usage_integral,
        preemptions=preemptions_total, samples=samples)
