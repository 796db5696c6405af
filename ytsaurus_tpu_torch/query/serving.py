"""Query serving plane: admission control, deadline propagation, and
continuous micro-batching for lookups and selects.

Ref shape: the reference serves interactive reads through a dedicated
query service with bounded in-flight windows and lookup sessions
(yt/yt/server/node/query_agent/query_service.cpp — TQueryService's
in-flight budget, TLookupSession batching concurrent reads against one
tablet).  On the XLA backbone the same idea doubles as inference-style
continuous batching: concurrent point lookups against one table coalesce
inside a flush window into one batched, order-preserving tablet read,
and the batched chunk probe buckets its key (needle) arrays to powers
of two, so gather shapes stay a bounded spectrum instead of one per
batch size — the bounded-shape discipline that keeps a JIT engine's
program cache from exploding (selects get the same guarantee from the
evaluator's capacity-bucketed compile cache) ("An Empirical Analysis of
Just-in-Time Compilation in Modern Databases", PAPERS.md).

Three pieces, one facade (`QueryGateway`, one per YtCluster):

  AdmissionController   per-pool weighted concurrency slots over a
                        bounded wait queue; overflow raises
                        `errors.ThrottledError` carrying a `retry_after`
                        hint derived from the observed slot drain rate.
  CancellationToken     deadline + cooperative cancellation, checked in
                        `coordinator.coordinate_and_execute`'s staging/
                        execution loop and in the evaluator, so a
                        timed-out query stops consuming device time
                        mid-plan instead of running to completion.
  LookupBatcher         continuous micro-batching of `lookup_rows`:
                        requests enqueue and a dedicated flusher thread
                        accumulates each arriving cohort (growth-stable
                        poll bounded by `flush_window_ms`), then runs
                        ONE batched read per (table, timestamp) with
                        parallel per-tablet fan-out, scattering rows
                        back in each caller's request order.

Serving metrics (queue depth, admitted/rejected/expired, batch size and
latency histograms) publish through `utils/profiling` under `/serving`,
so every daemon's monitoring `/metrics` endpoint exports them; the
`/serving` endpoint serves a structured snapshot.

Failpoint sites: `serving.admit` (admission decision; error mode injects
a ThrottledError) and `serving.batch_flush` (batched read execution).
"""

from __future__ import annotations

import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

from ytsaurus_tpu_torch.config import ServingConfig
from ytsaurus_tpu_torch.cypress.security import current_user
from ytsaurus_tpu_torch.errors import EErrorCode, ThrottledError, YtError
from ytsaurus_tpu_torch.operations.fair_share import (
    PoolState as FairPoolState,
    compute_fair_shares,
)
from ytsaurus_tpu_torch.query.accounting import get_accountant
from ytsaurus_tpu_torch.utils import failpoints
from ytsaurus_tpu_torch.utils.profiling import Profiler
from ytsaurus_tpu_torch.utils.tracing import (
    NULL_SPAN,
    child_span,
    current_trace,
    stage,
)
from ytsaurus_tpu_torch.utils import sanitizers

_FP_ADMIT = failpoints.register_site(
    "serving.admit",
    error=lambda s: ThrottledError(
        f"injected admission rejection at {s}", retry_after=0.05))
_FP_BATCH_FLUSH = failpoints.register_site(
    "serving.batch_flush",
    error=lambda s: YtError(f"injected batch flush failure at {s}",
                            code=EErrorCode.TransportError))
_FP_BROWNOUT = failpoints.register_site(
    "serving.brownout",
    error=lambda s: YtError(f"injected brown-out degradation failure "
                            f"at {s}", code=EErrorCode.TransportError))

# Sub-millisecond latency buckets: point lookups sit well under the
# profiling default's 1ms floor.
_LATENCY_BOUNDS = (0.0002, 0.0005, 0.001, 0.002, 0.005, 0.01, 0.025,
                   0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0)
_BATCH_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)


class CancellationToken:
    """Deadline + cooperative cancellation, threaded through execution.

    `check()` is the probe the coordinator/evaluator call between units
    of work; it raises `DeadlineExceeded` (terminal — never retried) or
    `Canceled`.  Tokens are cheap and thread-safe; `None` everywhere
    means "no deadline" so non-gateway callers pay nothing.

    The token also carries the admitted request's IDENTITY — (pool,
    user) — down through `coordinator.coordinate_and_execute`, the
    evaluator, and the tablet read path, so per-tenant resource
    accounting (query/accounting.py) can attribute what each layer
    consumed without a side channel."""

    __slots__ = ("deadline", "pool", "user", "_cancelled", "_reason",
                 "staleness_bound", "rung", "stale_served")

    def __init__(self, deadline: Optional[float] = None,
                 pool: Optional[str] = None,
                 user: Optional[str] = None):
        self.deadline = deadline          # time.monotonic() timestamp
        self.pool = pool
        self.user = user
        self._cancelled = False
        self._reason: Optional[str] = None
        # Brown-out ladder: when the gateway admits this
        # request under rung 1, `staleness_bound` carries the pool's
        # declared bound down to the tablet read path, and the read path
        # writes back the ACTUAL staleness it served (`stale_served`) so
        # every degraded response is tagged with what it got.
        self.staleness_bound: Optional[float] = None
        self.rung = 0
        self.stale_served = 0.0

    @classmethod
    def with_timeout(cls, timeout: Optional[float],
                     pool: Optional[str] = None,
                     user: Optional[str] = None) -> "CancellationToken":
        deadline = time.monotonic() + timeout \
            if timeout is not None and timeout > 0 else None
        return cls(deadline, pool=pool, user=user)

    def cancel(self, reason: str = "query cancelled") -> None:
        self._reason = reason
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def expired(self) -> bool:
        return self.deadline is not None and \
            time.monotonic() >= self.deadline

    def remaining(self) -> Optional[float]:
        """Seconds until the deadline (>= 0), or None without one."""
        if self.deadline is None:
            return None
        return max(self.deadline - time.monotonic(), 0.0)

    def check(self) -> None:
        if self._cancelled:
            raise YtError(self._reason or "query cancelled",
                          code=EErrorCode.Canceled,
                          attributes={"pool": self.pool}
                          if self.pool else {})
        if self.expired:
            raise YtError(
                "query deadline exceeded",
                code=EErrorCode.DeadlineExceeded,
                attributes={"pool": self.pool} if self.pool else {})


class _PoolState:
    # Plain-int tallies back the per-gateway snapshot (the profiler
    # counters are PROCESS-wide: every gateway shares one registry
    # sensor per (name, pool) tag, which is right for /metrics but
    # wrong for one gateway's view).
    __slots__ = ("name", "weight", "min_share", "limit",
                 "staleness_bound", "fair_share", "in_flight", "waiting",
                 "admitted_n", "rejected_n", "expired_n", "yielded_n",
                 "degraded_n", "admitted", "rejected", "expired",
                 "queue_gauge", "in_flight_gauge", "fair_gauge",
                 "wait_hist", "cond")

    def __init__(self, name: str, config: ServingConfig,
                 profiler: Profiler, serving_profiler: Profiler):
        self.name = name
        self.in_flight = 0
        self.waiting = 0
        self.fair_share = 0.0        # share of config.slots in [0, 1]
        self.admitted_n = 0
        self.rejected_n = 0
        self.expired_n = 0
        self.yielded_n = 0           # admissions that yielded to a
        self.degraded_n = 0          # starving pool before running
        self.reconfigure(config)
        prof = profiler.with_tags(pool=name)
        self.admitted = prof.counter("admitted")
        self.rejected = prof.counter("rejected")
        self.expired = prof.counter("expired")
        self.in_flight_gauge = prof.gauge("in_flight")
        # Fair-share allocation in SLOTS (`serving_admission_fair_slots
        # {pool=}`): what `yt top --by pool` and the SLO bench read to
        # see a storming tenant squeezed back to its share.
        self.fair_gauge = prof.gauge("fair_slots")
        self.wait_hist = prof.histogram("admission_wait_seconds",
                                        bounds=_LATENCY_BOUNDS)
        # the per-pool backlog as a REAL routing
        # signal at the serving root (`serving_queue_depth{pool=}`) —
        # load-aware replica routing (ROADMAP 3) reads it off /metrics
        # instead of reaching into gateway internals.
        self.queue_gauge = serving_profiler.with_tags(
            pool=name).gauge("queue_depth")

    def reconfigure(self, config: ServingConfig) -> None:
        """Pull this pool's spec out of a (possibly freshly merged)
        ServingConfig — the dynamic-resize entry point."""
        pools = config.pools or {}
        self.weight = float(pools.get(self.name, 1.0))
        self.min_share = float(
            (config.min_shares or {}).get(self.name, 0.0))
        self.limit = (config.pool_limits or {}).get(self.name)
        bound = (config.staleness_bounds or {}).get(
            self.name, config.default_staleness_seconds)
        self.staleness_bound = float(bound) if bound else 0.0


# Bounded ring of brown-out rung transitions kept for /serving.
_MAX_TRANSITIONS = 64


class AdmissionController:
    """Fair-share admission over one shared slot budget.

    The static per-pool slot table collapsed into scalar progressive
    filling (operations/fair_share.py): every pool carries weight +
    min-share guarantees, `compute_fair_shares` water-fills the live
    demand (in-flight = running, queued waiters = pending), and a freed
    slot goes to the waiting pool FURTHEST below its fair share — a
    waiter of an over-share pool yields (is preempted in the queue) as
    long as an under-share pool starves.  Pools are DYNAMIC: created on
    first config mention, resized live via `apply_config` (the
    DynamicConfigManager subscription), so thousands of tenants can get
    weighted guarantees without a restart.

    A request whose pool already has `max_queue` waiters is rejected
    immediately with a `retry_after` hint estimated from the EWMA slot
    hold time and the backlog ahead of it.

    The controller also owns the BROWN-OUT ladder: the overload signal
    is estimated queue drain time (total waiters x hold EWMA / slots);
    rung 1 degrades reads to bounded-staleness snapshot-cache serves,
    rung 2 sheds new requests with retry_after.  Rungs escalate
    immediately and de-escalate one step at a time behind hysteresis +
    a minimum dwell, so the ladder cannot flap at a threshold."""

    def __init__(self, config: ServingConfig):
        self.config = config
        # One lock, MANY conditions: every pool parks its waiters on its
        # own condition (built over this same lock) so a release can
        # wake exactly the pool the freed slot belongs to instead of
        # broadcasting to every queued request in the process.
        self._lock = threading.RLock()
        # guards: _pools, _hold_ewma, _in_flight_total, _waiting_total, _shares_dirty, _rung, _rung_since, _transitions_log, config
        self._cond = sanitizers.register_condition(
            "serving.AdmissionController._cond",
            threading.Condition(self._lock))
        serving_profiler = Profiler("/serving")
        profiler = serving_profiler.with_prefix("/admission")
        self._profiler = profiler
        self._serving_profiler = serving_profiler
        self._pools: dict[str, _PoolState] = {}
        self._in_flight_total = 0
        self._waiting_total = 0
        self._shares_dirty = True
        for name in (config.pools or {config.default_pool: 1.0}):
            self._ensure_pool_locked(name)
        # EWMA of slot hold time, seeded pessimistically; feeds the
        # retry_after hint so clients back off proportionally to the
        # actual drain rate instead of a blind constant.  Exported as
        # `serving_hold_ewma_seconds`: the routing
        # signal was private to this object, and load-aware replica
        # routing needs it from /metrics.
        self._hold_ewma = 0.05
        self._hold_gauge = serving_profiler.gauge("hold_ewma_seconds")
        self._hold_gauge.set(self._hold_ewma)
        # Brown-out ladder state + sensors (/serving/brownout/*).
        bprof = serving_profiler.with_prefix("/brownout")
        self._rung = 0
        self._rung_since = time.monotonic()
        self._transitions_n = 0
        self._engaged_n = 0
        self._shed_n = 0
        self._transitions_log: list[dict] = []
        self._rung_gauge = bprof.gauge("rung")
        self._transitions_c = bprof.counter("transitions")
        self._degraded_c = bprof.counter("degraded_reads")
        self._shed_c = bprof.counter("shed")
        self._rung_gauge.set(0)

    # -- pools -----------------------------------------------------------------

    def _ensure_pool_locked(self, name: str) -> _PoolState:
        state = self._pools.get(name)
        if state is None:
            state = self._pools[name] = _PoolState(
                name, self.config, self._profiler,
                self._serving_profiler)
            # The pool's private wait queue shares the admission lock
            # (and the lock's sanitizer identity — it IS the same lock).
            state.cond = sanitizers.register_condition(
                "serving.AdmissionController._cond",
                threading.Condition(self._lock))
            self._shares_dirty = True
        return state

    def apply_config(self, config: ServingConfig) -> None:
        """Adopt a new ServingConfig live (DynamicConfigManager
        subscriber): resize the slot budget, re-weight existing pools,
        create newly declared ones.  Pools that vanished from the patch
        keep serving with default weight until their traffic drains —
        deleting live accounting identities mid-flight would orphan
        their in-flight releases."""
        with self._cond:
            self.config = config
            for name in (config.pools or {}):
                self._ensure_pool_locked(name)
            for state in self._pools.values():
                state.reconfigure(config)
            self._shares_dirty = True
            self._update_rung_locked()
            # Waiters re-evaluate against the new shares immediately —
            # a widened budget must not wait for the next release.
            # Config changes move shares arbitrarily, so this is the
            # one place a full broadcast is the right tool.
            for state in self._pools.values():
                state.cond.notify_all()

    def _resolve(self, pool: Optional[str]) -> _PoolState:
        return self._pools.get(pool or self.config.default_pool) or \
            self._pools[self.config.default_pool]

    # -- fair share ------------------------------------------------------------

    def _recompute_locked(self) -> None:
        slots = self.config.slots
        fair = [FairPoolState(name=s.name, weight=s.weight,
                              min_share_ratio=s.min_share,
                              max_running_jobs=s.limit,
                              running=s.in_flight, pending=s.waiting)
                for s in self._pools.values()]
        compute_fair_shares(fair, slots)
        for fp in fair:
            state = self._pools[fp.name]
            state.fair_share = fp.fair_share
            state.fair_gauge.set(fp.fair_share * slots)
        self._shares_dirty = False

    def _pick_locked(self) -> Optional[_PoolState]:
        """The waiting pool to serve next: lowest usage-to-fair-share
        ratio among pools with waiters and headroom (pick_pool
        semantics over the live admission counters)."""
        best = None
        best_ratio = None
        slots = self.config.slots
        for s in self._pools.values():
            if s.waiting <= 0 or s.fair_share <= 0:
                continue
            if s.limit is not None and s.in_flight >= s.limit:
                continue
            ratio = s.in_flight / (s.fair_share * slots)
            if best is None or ratio < best_ratio or \
                    (ratio == best_ratio and s.name < best.name):
                best, best_ratio = s, ratio
        return best

    def _may_run_locked(self, state: _PoolState) -> bool:
        if self._shares_dirty:
            self._recompute_locked()
        slots = self.config.slots
        if self._in_flight_total >= slots:
            return False
        if state.limit is not None and state.in_flight >= state.limit:
            return False
        if state.in_flight + 1 <= state.fair_share * slots + 1e-9:
            return True
        # Running would take the pool OVER its fair share: the slot
        # belongs to the starving pool furthest below its own — this
        # waiter yields (queue preemption).  When no pool is pickable
        # (all fair shares zero — degenerate configs) fall back to
        # first-come service so nobody livelocks.
        best = self._pick_locked()
        return best is None or best is state

    def _notify_waiters_locked(self) -> None:
        """Wake exactly the waiters the free capacity belongs to.

        A single shared condition made every release a thundering herd:
        O(total waiters) threads woke, re-ran the fair-share check, and
        re-slept.  A greedy tenant's thousand-deep queue turned that
        churn into CPU and GIL pressure the innocent neighbor pools
        felt as p99 — the herd itself was a noisy-neighbor channel.
        Each pool now parks on its own condition (over the one
        admission lock) and a freed slot wakes only the picked pool:
        O(pools) per release.  A woken waiter that can no longer run
        (shares shifted under it) re-aims the baton before re-sleeping,
        so a wakeup is never lost while a slot sits free."""
        if self._waiting_total <= 0:
            return
        if self._shares_dirty:
            self._recompute_locked()
        free = self.config.slots - self._in_flight_total
        if free <= 0:
            return
        best = self._pick_locked()
        if best is not None:
            best.cond.notify(min(free, best.waiting))
            return
        # Degenerate configs (every fair share zero): _may_run_locked
        # falls back to first-come service — wake one waiter per pool.
        for s in self._pools.values():
            if s.waiting > 0:
                s.cond.notify(1)

    # -- brown-out ladder ------------------------------------------------------

    def _pressure_locked(self) -> float:
        """Estimated seconds to drain the global backlog: waiters x
        EWMA hold / slots — queue depth and drain rate in one signal."""
        return self._waiting_total * self._hold_ewma / \
            max(self.config.slots, 1)

    def _update_rung_locked(self) -> None:
        cfg = self.config
        now = time.monotonic()
        if not cfg.brownout_enabled:
            self._set_rung_locked(0, now)
            return
        pressure = self._pressure_locked()
        target = 2 if pressure >= cfg.brownout_rung2_seconds else \
            1 if pressure >= cfg.brownout_rung1_seconds else 0
        if target > self._rung:
            self._set_rung_locked(target, now)      # escalate NOW
        elif self._rung > 0:
            threshold = (cfg.brownout_rung2_seconds if self._rung == 2
                         else cfg.brownout_rung1_seconds)
            if pressure < threshold * cfg.brownout_hysteresis and \
                    now - self._rung_since >= \
                    cfg.brownout_min_dwell_seconds:
                self._set_rung_locked(self._rung - 1, now)  # one step
        self._rung_gauge.set(self._rung)

    def _set_rung_locked(self, rung: int, now: float) -> None:
        if rung == self._rung:
            return
        if self._rung == 0 and rung > 0:
            self._engaged_n += 1
        self._transitions_n += 1
        self._transitions_c.increment()
        self._transitions_log.append({
            "at": time.time(), "from": self._rung, "to": rung,
            "pressure": round(self._pressure_locked(), 4)})
        del self._transitions_log[:-_MAX_TRANSITIONS]
        self._rung, self._rung_since = rung, now
        self._rung_gauge.set(rung)

    @property
    def rung(self) -> int:
        with self._cond:
            return self._rung

    def degradation(self, state: _PoolState) -> tuple[int,
                                                      Optional[float]]:
        """The degradation this ADMITTED request must apply: (active
        rung, the pool's staleness bound when rung >= 1 and the pool
        opted in).  Hits the `serving.brownout` failpoint whenever a
        degraded decision is being made."""
        with self._cond:
            rung = self._rung
            bound = state.staleness_bound
        if rung >= 1:
            _FP_BROWNOUT.hit()
            if bound and bound > 0:
                return rung, bound
        return rung, None

    def observe_degraded(self, state: _PoolState,
                         staleness: float) -> None:
        """Tally one response actually served degraded (tagged)."""
        with self._cond:
            state.degraded_n += 1
        self._degraded_c.increment()

    # -- admission -------------------------------------------------------------

    def _retry_after(self, state: _PoolState) -> float:
        backlog = state.waiting + state.in_flight
        fair_slots = max(state.fair_share * self.config.slots, 1.0)
        hint = self._hold_ewma * max(backlog, 1) / fair_slots
        return round(min(max(hint, 0.01), 5.0), 4)

    def admit(self, token: CancellationToken,
              pool: Optional[str] = None) -> _PoolState:
        _FP_ADMIT.hit()
        t0 = time.monotonic()
        with self._cond:
            state = self._resolve(pool)
            self._update_rung_locked()
            if self._rung >= 2:
                # Rung 2: the ladder's last step sheds NEW load at the
                # door so queued + in-flight work can drain.
                self._shed_n += 1
                self._shed_c.increment()
                state.rejected_n += 1
                state.rejected.increment()
                get_accountant().observe_throttle(state.name, token.user)
                raise ThrottledError(
                    f"serving brown-out rung 2: shedding load "
                    f"(pool {state.name!r})",
                    retry_after=self._retry_after(state),
                    attributes={"pool": state.name, "brownout_rung": 2})
            state.waiting += 1
            self._waiting_total += 1
            self._shares_dirty = True
            state.queue_gauge.set(state.waiting)
            yielded = False
            try:
                if not self._may_run_locked(state) and \
                        state.waiting > self.config.max_queue:
                    state.rejected_n += 1
                    state.rejected.increment()
                    get_accountant().observe_throttle(state.name,
                                                      token.user)
                    raise ThrottledError(
                        f"serving pool {state.name!r} is saturated "
                        f"(fair share "
                        f"{state.fair_share * self.config.slots:.1f} "
                        f"slots, {state.waiting - 1} queued)",
                        retry_after=self._retry_after(state),
                        attributes={"pool": state.name})
                while not self._may_run_locked(state):
                    if self._in_flight_total < self.config.slots and \
                            (state.limit is None or
                             state.in_flight < state.limit):
                        # A slot is FREE but belongs to a starving
                        # pool: this waiter is being queue-preempted.
                        # Pass the baton to that pool before sleeping —
                        # if this thread consumed the release's wakeup,
                        # the rightful waiter must not sleep through
                        # its free slot.
                        yielded = True
                        self._notify_waiters_locked()
                    if not state.cond.wait(timeout=token.remaining()):
                        # Deadline lapsed while queued: the request
                        # expires without ever consuming a slot.  Any
                        # wakeup racing the timeout is re-aimed so it
                        # doesn't die with this waiter.
                        state.expired_n += 1
                        state.expired.increment()
                        self._notify_waiters_locked()
                        raise YtError(
                            f"deadline exceeded while queued in serving "
                            f"pool {state.name!r}",
                            code=EErrorCode.DeadlineExceeded,
                            attributes={"pool": state.name})
                state.in_flight += 1
                self._in_flight_total += 1
                self._shares_dirty = True
                if self._in_flight_total < self.config.slots:
                    # Still free capacity after this admission (a grown
                    # budget, or a release that freed several at once):
                    # forward the baton — the release-time notify only
                    # aimed at ONE pool's waiters.
                    self._notify_waiters_locked()
            finally:
                state.waiting -= 1
                self._waiting_total -= 1
                self._shares_dirty = True
                state.queue_gauge.set(state.waiting)
            if yielded:
                state.yielded_n += 1
            state.admitted_n += 1
            state.admitted.increment()
            state.in_flight_gauge.set(state.in_flight)
        state.wait_hist.record(time.monotonic() - t0)
        return state

    def release(self, state: _PoolState, held_seconds: float) -> None:
        with self._cond:
            state.in_flight -= 1
            self._in_flight_total -= 1
            self._shares_dirty = True
            state.in_flight_gauge.set(state.in_flight)
            self._hold_ewma += 0.2 * (held_seconds - self._hold_ewma)
            self._hold_gauge.set(self._hold_ewma)
            self._update_rung_locked()
            # Targeted, NOT notify_all: wake only the pool the freed
            # slot belongs to (waiters of other pools stay parked on
            # their own conditions).
            self._notify_waiters_locked()

    def snapshot(self) -> dict:
        with self._cond:
            if self._shares_dirty:
                self._recompute_locked()
            # Rung re-evaluation on read: a gateway whose storm just
            # drained must DISENGAGE even if no new request arrives to
            # drive admit()/release() — monitoring scrapes are the
            # heartbeat that walks the ladder back down.
            self._update_rung_locked()
            slots = self.config.slots
            return {
                "slots": slots,
                "hold_ewma": round(self._hold_ewma, 6),
                "brownout": {
                    "rung": self._rung,
                    "pressure": round(self._pressure_locked(), 4),
                    "engaged": self._engaged_n,
                    "transitions": self._transitions_n,
                    "shed": self._shed_n,
                    "log": list(self._transitions_log),
                },
                "pools": {
                    name: {"weight": s.weight,
                           "min_share": s.min_share,
                           "limit": s.limit,
                           "fair_share": round(s.fair_share, 4),
                           "fair_slots": round(s.fair_share * slots, 2),
                           "staleness_bound": s.staleness_bound,
                           "in_flight": s.in_flight,
                           "waiting": s.waiting,
                           "demand": s.in_flight + s.waiting,
                           "admitted": s.admitted_n,
                           "rejected": s.rejected_n,
                           "expired": s.expired_n,
                           "yielded": s.yielded_n,
                           "degraded": s.degraded_n}
                    for name, s in sorted(self._pools.items())},
            }


class _PathContext:
    """Cached lookup context for one mounted table: tablet list, key
    normalization types, and normalized routing pivots — the per-request
    tree resolve + per-call pivot renormalization of the generic path
    (client._route_rows) is pure overhead at point-lookup rates.
    Freshness is an identity check: a remount replaces the cluster's
    tablet list object, which invalidates the context."""

    __slots__ = ("node_id", "tablets", "schema", "normalize",
                 "safe_pivots", "has_computed")

    def __init__(self, node_id, tablets, schema):
        from ytsaurus_tpu_torch.tablet.dynamic_store import _null_safe
        self.node_id = node_id
        self.tablets = tablets
        self.schema = schema
        # THE key canonicalizer — one implementation (the tablet's,
        # which caches its key columns) so batched and direct lookups
        # can never disagree on result-map keys.
        self.normalize = tablets[0].normalize_key
        self.has_computed = any(c.expression for c in schema.key_columns)
        self.safe_pivots = [
            _null_safe(self.normalize(tuple(t.pivot_key)))
            for t in tablets[1:]]

    def route(self, nkeys) -> "dict[int, list]":
        """Normalized keys → owning tablet index (pivot bisect)."""
        import bisect

        from ytsaurus_tpu_torch.tablet.dynamic_store import _null_safe
        if not self.safe_pivots:
            return {0: list(nkeys)}
        out: dict[int, list] = {}
        for nk in nkeys:
            idx = bisect.bisect_right(self.safe_pivots, _null_safe(nk))
            out.setdefault(idx, []).append(nk)
        return out


class _Batch:
    """One micro-batch: the key lists of every joined request plus the
    shared completion state.  Waiters block on `done` and scatter from
    `results` through their OWN normalized-key order, so one event wakes
    the whole cohort at once (per-entry futures would wake them one by
    one).

    `deadline` is the COHORT maximum (None once any member has no
    deadline): the flush runs on behalf of every member, so one
    short-deadline caller must not fail co-batched callers with budget
    left — members whose own deadline lapses time out individually in
    `lookup()`.  `pool` is the first member's pool (admission is one
    slot per flush; mixed-pool cohorts charge the pool that opened the
    batch).  `trace` captures the OPENING member's trace context so the
    flusher thread (which has no ambient context of its own) can parent
    its batch-flush span into that caller's trace."""

    __slots__ = ("key_lists", "users", "deadline", "pool", "user",
                 "client", "created", "done", "results", "error",
                 "trace")

    def __init__(self, token: CancellationToken, client):
        self.key_lists: list = []       # list[list[nkey]] per request
        self.users: list = []           # requesting user, per request
        self.deadline = token.deadline
        self.pool = token.pool
        self.user = token.user
        self.client = client
        self.created = time.monotonic()
        self.done = threading.Event()
        self.results: dict = {}
        self.error: Optional[BaseException] = None
        self.trace = current_trace()

    def join(self, token: CancellationToken) -> None:
        if self.deadline is not None:
            self.deadline = None if token.deadline is None \
                else max(self.deadline, token.deadline)

    def flush_token(self) -> CancellationToken:
        return CancellationToken(self.deadline, pool=self.pool,
                                 user=self.user)


class LookupBatcher:
    """Continuous micro-batching of point lookups (lookup sessions).

    Requests enqueue their normalized keys into the pending batch for
    their (table, timestamp) and block on the batch's completion event;
    a dedicated FLUSHER thread per gateway drains pending batches in a
    loop: it waits for work, lets the arriving cohort accumulate until
    the batch stops growing across one poll (bounded by
    `flush_window_ms`), then takes every pending batch and executes
    each as ONE admitted, batched read — keys deduplicated, padded to a
    power-of-two bucket, fanned out per tablet in parallel — and wakes
    the whole cohort with one event.  The explicit accumulation matters
    under the GIL: compute-bound requests barely overlap on their own,
    so without it every request would flush alone and amortize nothing.
    `max_batch_size` caps the keys per tablet read (bigger unions are
    read in slices inside the same flush).

    Responses are never lost, duplicated, or misordered regardless of
    how requests interleave: a batch resolves exactly once (rows or the
    flush's error) and each caller scatters from the shared result map
    through its OWN request-order key list."""

    # Growth-stability poll while a cohort accumulates; the sleep is
    # the yield that lets cohort threads actually enqueue.
    _POLL_SECONDS = 0.0002

    def __init__(self, config: ServingConfig, admission:
                 AdmissionController, executor: ThreadPoolExecutor):
        self.config = config
        self.admission = admission
        self._executor = executor
        # Flushes run on their own small pool, SEPARATE from the
        # per-tablet read executor: flushes submit reads to `executor`
        # and wait, so sharing one pool could fill every worker with
        # flushes waiting on reads that can never start.
        self._flush_executor = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="serving-flush")
        # guards: _batches, _contexts, _flusher, requests_n, batches_n, batched_keys_n
        self._cond = sanitizers.register_condition(
            "serving.LookupBatcher._cond")
        self._batches: "dict[tuple, _Batch]" = {}
        self._contexts: dict[str, _PathContext] = {}
        self._flusher: Optional[threading.Thread] = None
        # Instance tallies for snapshot(); profiler counters mirror
        # them process-wide for /metrics.
        self.requests_n = 0
        self.batches_n = 0
        self.batched_keys_n = 0
        prof = Profiler("/serving/lookup")
        self.requests = prof.counter("requests")
        self.batches = prof.counter("batches")
        self.batched_keys = prof.counter("batched_keys")
        self.batch_size_hist = prof.histogram("batch_size",
                                              bounds=_BATCH_BOUNDS)
        self.latency_hist = prof.histogram("latency_seconds",
                                           bounds=_LATENCY_BOUNDS)

    def _context(self, client, path: str) -> _PathContext:
        # The memo is shared by caller threads and the flusher: reads
        # and writes both go under the cond (the lock pass flagged the
        # bare-dict mutation; a clear() racing a get could hand a
        # half-installed context to a flush).
        with self._cond:
            ctx = self._contexts.get(path)
        if ctx is not None and \
                client.cluster.tablets.get(ctx.node_id) is ctx.tablets:
            return ctx
        tablets = client._mounted_tablets(path)
        client._require_sorted(tablets[0], path)
        node = client._table_node(path)
        ctx = _PathContext(node.id, tablets, tablets[0].schema)
        for tablet in tablets:
            # Shape-bucketing floor for the tablets' batched chunk
            # probes (tablet._pad_needles pow2 buckets).
            tablet.probe_bucket_min = self.config.min_bucket
        with self._cond:
            if len(self._contexts) > 256:
                self._contexts.clear()
            self._contexts[path] = ctx
        return ctx

    def lookup(self, client, path: str, keys: Sequence[tuple],
               timestamp: int, column_names, token: CancellationToken,
               pool: Optional[str] = None):
        with child_span("serving.lookup", table=path, keys=len(keys)):
            return self._lookup_traced(client, path, keys, timestamp,
                                       column_names, token, pool)

    def _lookup_traced(self, client, path: str, keys: Sequence[tuple],
                       timestamp: int, column_names,
                       token: CancellationToken,
                       pool: Optional[str] = None):
        t0 = time.monotonic()
        ctx = self._context(client, path)
        if ctx.has_computed:
            keys = client._fill_computed_keys(
                ctx.schema, [tuple(k) for k in keys])
        nkeys = [ctx.normalize(tuple(k)) for k in keys]
        bkey = (path, timestamp)
        with self._cond:
            # Tally under the cond with the enqueue (the lock pass
            # flagged the bare `+= 1`: two racing requests could lose
            # an increment and snapshot() would under-report).  The
            # profiler mirror increments HERE too, so the /metrics
            # sensor and snapshot() count the same events — a request
            # that fails context resolution above counts in neither.
            self.requests_n += 1
            batch = self._batches.get(bkey)
            if batch is None:
                batch = self._batches[bkey] = _Batch(token, client)
            else:
                batch.join(token)
            batch.key_lists.append(nkeys)
            batch.users.append(token.user)
            self.requests.increment()
            if self._flusher is None or not self._flusher.is_alive():
                self._flusher = threading.Thread(
                    target=self._flusher_loop, daemon=True,
                    name="serving-flusher")
                self._flusher.start()
            self._cond.notify()
        if not batch.done.wait(timeout=token.remaining()):
            raise YtError(
                "deadline exceeded waiting for the lookup batch",
                code=EErrorCode.DeadlineExceeded,
                attributes={"table": path})
        if batch.error is not None:
            raise batch.error
        results = batch.results
        out = []
        for nk in nkeys:
            row = results.get(nk)
            if row is not None:
                # Copy per caller: one merged row may serve several
                # concurrent requests, and callers may mutate.
                row = {name: row.get(name) for name in column_names} \
                    if column_names is not None else dict(row)
            out.append(row)
        self.latency_hist.record(time.monotonic() - t0)
        return out

    # -- the flusher thread ----------------------------------------------------

    # Idle flusher threads exit (lookup() restarts them on demand) so
    # processes juggling many short-lived clusters don't accumulate
    # parked threads.
    _IDLE_EXIT_SECONDS = 30.0

    def _flusher_loop(self) -> None:
        while True:
            with self._cond:
                while not self._batches:
                    if not self._cond.wait(
                            timeout=self._IDLE_EXIT_SECONDS) \
                            and not self._batches:
                        self._flusher = None
                        return
            self._accumulate()
            with self._cond:
                taken, self._batches = self._batches, {}
            for (path, timestamp), batch in taken.items():
                # Dispatch, don't run inline: a flush can park inside
                # admission when its pool is saturated, and an inline
                # flush would head-of-line-block every other table's
                # batches behind it.  (_flush relays any failure —
                # including InjectedCrash — to its cohort itself.)
                self._flush_executor.submit(self._flush, path,
                                            timestamp, batch)

    def _accumulate(self) -> None:
        """Let the arriving cohort join: poll until no pending batch
        grew across one interval, capped by flush_window_ms (and cut
        short once any batch holds max_batch_size keys)."""
        window = self.config.flush_window_ms / 1000.0
        if window <= 0:
            return
        deadline = time.monotonic() + window
        prev = -1
        while time.monotonic() < deadline:
            with self._cond:
                n = sum(len(b.key_lists) for b in self._batches.values())
                full = any(
                    sum(len(ks) for ks in b.key_lists) >=
                    self.config.max_batch_size
                    for b in self._batches.values())
            if n == prev or full:
                return
            prev = n
            time.sleep(self._POLL_SECONDS)

    # -- batch execution -------------------------------------------------------

    def _flush(self, path, timestamp, batch: _Batch) -> None:
        token = batch.flush_token()      # cohort-max deadline
        # Parent the flush span into the OPENING caller's trace (the
        # flusher thread has no ambient context): the cohort members see
        # one shared batch-flush child under the first joiner.
        parent = batch.trace
        span = parent.create_child("serving.batch_flush") \
            if parent is not None and parent.sampled else NULL_SPAN
        span.add_tag("table", path)
        span.add_tag("cohort", len(batch.key_lists))
        with span:
            try:
                with child_span("serving.admission", pool=batch.pool):
                    state = self.admission.admit(token, batch.pool)
            except BaseException as exc:
                self._fail(batch, exc)
                return
            t0 = time.monotonic()
            try:
                self._flush_admitted(path, timestamp, batch, token, span)
            except BaseException as exc:  # noqa: BLE001 — relayed to
                # waiters
                self._fail(batch, exc)
                if not isinstance(exc, Exception):
                    raise      # InjectedCrash still pierces this flush
            finally:
                self.admission.release(state, time.monotonic() - t0)

    def _flush_admitted(self, path, timestamp, batch: _Batch, token,
                        span) -> None:
        _FP_BATCH_FLUSH.hit()
        token.check()
        client = batch.client
        ctx = self._context(client, path)
        # Union of the batch's keys, deduplicated (two callers
        # asking for the same row share one read); normalized keys
        # ARE canonical keys, so they feed the tablets directly.
        union = dict.fromkeys(
            nk for ks in batch.key_lists for nk in ks)
        span.add_tag("keys", len(union))
        with self._cond:
            # Concurrent flushes race these tallies (4-worker flush
            # pool); the profiler counters already lock internally.
            self.batches_n += 1
            self.batched_keys_n += len(union)
        self.batches.increment()
        self.batched_keys.increment(len(union))
        self.batch_size_hist.record(len(union))
        results: dict[tuple, Optional[dict]] = {}
        pool = batch.pool or self.config.default_pool
        items = list(ctx.route(union).items())
        if len(items) > 1 and len(union) >= 32:
            # Parallel per-tablet fan-out (the sequential per-tablet
            # loop was the pre-gateway bottleneck, client.py:1136);
            # small batches stay inline — dispatch overhead would
            # exceed the read.  Each future carries an explicit
            # contextvars copy: executor threads have no ambient trace,
            # and the tablet-read spans must link under this flush.
            import contextvars as _cv
            futures = [
                self._executor.submit(_cv.copy_context().run,
                                      self._read_tablet,
                                      ctx.tablets, idx, part,
                                      timestamp, pool)
                for idx, part in items]
            for fut in futures:
                results.update(fut.result())
        else:
            for idx, part in items:
                results.update(self._read_tablet(
                    ctx.tablets, idx, part, timestamp, pool))
        # Fold into per-tenant accounting before waking the waiters:
        # the FLUSH is one `lookup_batches` unit under the cohort
        # opener's identity (it maps 1:1 onto the admission slot the
        # flush held — the per-pool reconciliation unit), while each
        # member request's keys/rows charge ITS OWN user, so a cohort
        # of mixed tenants doesn't bill everything to whoever opened
        # the batch window.
        accountant = get_accountant()
        accountant.observe_lookup_batch(pool, batch.user)
        for nkeys, user in zip(batch.key_lists, batch.users):
            distinct = dict.fromkeys(nkeys)
            accountant.observe_lookup(
                pool, user, keys=len(distinct),
                rows_found=sum(1 for nk in distinct
                               if results.get(nk) is not None))
        batch.results = results
        batch.done.set()

    def _read_tablet(self, tablets, idx: int, part: list,
                     timestamp: int, pool: Optional[str] = None) -> dict:
        """One tablet's slice of the batch, capped at max_batch_size
        keys per read; the tablet's batched chunk probe buckets its
        needle shapes to powers of two (min_bucket)."""
        out: dict = {}
        cap = self.config.max_batch_size
        for lo in range(0, len(part), cap):
            piece = part[lo:lo + cap]
            rows = tablets[idx].lookup_rows(piece, timestamp=timestamp,
                                            normalized=True, pool=pool)
            out.update(zip(piece, rows))
        return out

    @staticmethod
    def _fail(batch: _Batch, exc: BaseException) -> None:
        batch.error = exc
        batch.done.set()

    def snapshot(self) -> dict:
        return {"requests": self.requests_n,
                "batches": self.batches_n,
                "batched_keys": self.batched_keys_n}

# Live gateways of this process (the monitoring /serving endpoint).
_GATEWAYS: "weakref.WeakSet" = weakref.WeakSet()


class QueryGateway:
    """The serving-plane facade every query entry point routes through.

    `run_select(fn)` admits, mints a CancellationToken, calls
    `fn(token)`, and releases; `lookup_rows(...)` goes through the
    micro-batcher (which admits per batch flush).  One gateway per
    YtCluster so concurrent clients of one cluster share slots and
    coalesce lookups."""

    def __init__(self, config: Optional[ServingConfig] = None):
        self.config = config or ServingConfig()
        self.admission = AdmissionController(self.config)
        self._executor = ThreadPoolExecutor(
            max_workers=max(self.config.max_tablet_fanout, 1),
            thread_name_prefix="serving")
        self.batcher = LookupBatcher(self.config, self.admission,
                                     self._executor)
        from ytsaurus_tpu_torch.query.vector import NearestBatcher
        self.nearest_batcher = NearestBatcher(self.config, self.admission)
        prof = Profiler("/serving")
        self.select_latency = prof.histogram("select_latency_seconds",
                                             bounds=_LATENCY_BOUNDS)
        self._stat_profiler = Profiler("/serving/query_stats")
        self._cache_gauge = prof.gauge("evaluator_cache_size")
        _GATEWAYS.add(self)

    @property
    def enabled(self) -> bool:
        return bool(self.config.enabled)

    def resolve_pool(self, pool: Optional[str]) -> str:
        """The admission-resolved pool name (None/unknown pools land on
        the default pool's slots) — the ONE identity admission counters,
        per-pool sensors, and accounting must share, or per-pool
        reconciliation splits between a requested and an admitted name."""
        return self.admission._resolve(pool).name

    def make_token(self, timeout: Optional[float],
                   pool: Optional[str] = None) -> CancellationToken:
        if timeout is None:
            timeout = self.config.default_timeout or None
        # Identity rides the token: the ADMISSION-RESOLVED pool plus the
        # ambient authenticated principal (RPC/HTTP entry points restore
        # it per request — cypress/security.authenticated_user).
        return CancellationToken.with_timeout(
            timeout, pool=self.resolve_pool(pool),
            user=current_user())

    # -- selects ---------------------------------------------------------------

    def run_select(self, fn: Callable[[Optional[CancellationToken]],
                                      object],
                   pool: Optional[str] = None,
                   timeout: Optional[float] = None, stats=None):
        """Admit, call `fn(token)`, release. The admission wait is its
        own stage: `stats.admission_wait` (query/statistics.py), sampled
        or not, and the `serving.admission` span."""
        if not self.enabled:
            return fn(None)
        token = self.make_token(timeout, pool)
        with stage(stats, "admission_wait", "serving.admission",
                   pool=pool or self.config.default_pool):
            state = self.admission.admit(token, pool)
        root = current_trace()
        # Brown-out rung 1: the pool's declared staleness
        # bound rides the token down to the tablet read path, which
        # serves the snapshot cache within the bound and writes back
        # what it actually served.  A failure INSIDE the degradation
        # decision (the `serving.brownout` failpoint's injection) falls
        # back to full-fidelity execution: broken brown-out machinery
        # must never take down a query that already holds a slot.
        try:
            rung, bound = self.admission.degradation(state)
        except YtError:
            rung, bound = 0, None
        if rung >= 1 and bound is not None:
            token.rung = rung
            token.staleness_bound = bound
        t0 = time.monotonic()
        try:
            return fn(token)
        finally:
            held = time.monotonic() - t0
            self.admission.release(state, held)
            self.select_latency.record(held)
            if token.rung >= 1:
                # Tag the degraded response where observability reads
                # it: the root span and the per-pool degraded tally.
                self.admission.observe_degraded(state, token.stale_served)
                if root is not None:
                    root.add_tag("brownout_rung", token.rung)
                    root.add_tag("stale_served_s",
                                 round(token.stale_served, 4))

    # -- lookups ---------------------------------------------------------------

    def lookup_rows(self, client, path: str, keys: Sequence[tuple],
                    timestamp: int, column_names=None,
                    pool: Optional[str] = None,
                    timeout: Optional[float] = None):
        token = self.make_token(timeout, pool)
        # Workload recorder fold: each admitted lookup is one
        # compact record (table + key tuples + outcome + wall) in the
        # bounded workload log — the replay harness re-runs them.
        from ytsaurus_tpu_torch.query.workload import (
            get_workload_log,
            outcome_of,
        )
        t0 = time.monotonic()
        try:
            out = self.batcher.lookup(client, path, keys, timestamp,
                                      column_names, token, pool=pool)
        except YtError as err:
            get_workload_log().observe_lookup(
                path, keys, outcome=outcome_of(err),
                wall_time=time.monotonic() - t0, pool=token.pool,
                user=token.user)
            raise
        get_workload_log().observe_lookup(
            path, keys, outcome="ok", wall_time=time.monotonic() - t0,
            pool=token.pool, user=token.user)
        return out

    # -- vector search ---------------------------------------------------------

    def nearest_rows(self, client, path: str, column: str,
                     query_vector, k: int, metric: str = "l2",
                     timestamp: Optional[int] = None,
                     pool: Optional[str] = None,
                     timeout: Optional[float] = None):
        """Serve one NEAREST query through the vector micro-batcher:
        co-admitted queries on (path, column, metric, timestamp)
        coalesce into ONE batched distance matmul (query/vector.py)."""
        token = self.make_token(timeout, pool)
        if timestamp is None:
            from ytsaurus_tpu_torch.tablet.timestamp import MAX_TIMESTAMP
            timestamp = MAX_TIMESTAMP
        return self.nearest_batcher.nearest(
            client, path, column, query_vector, k, metric, timestamp,
            token)

    # -- observability ---------------------------------------------------------

    def record_statistics(self, stats: dict,
                          cache_size: Optional[int] = None) -> None:
        """Fold one query's TQueryStatistics, as its `to_dict()`, into
        the cumulative serving counters (`serving_query_stats_* ` on
        /metrics).  Only numeric fields fold — capacity_buckets is a
        per-query set, not a counter."""
        for field, value in stats.items():
            if isinstance(value, (int, float)) \
                    and not isinstance(value, bool) and value:
                self._stat_profiler.counter(field).increment(value)
        if cache_size is not None:
            self._cache_gauge.set(cache_size)

    def apply_config(self, config: ServingConfig) -> None:
        """Adopt a merged ServingConfig live: resize/re-weight admission
        pools, and let the batchers pick up the new windows (they read
        `self.config` per flush)."""
        self.config = config
        self.batcher.config = config
        self.nearest_batcher.config = config
        self.admission.apply_config(config)

    def attach_dynamic_config(self, manager) -> None:
        """Subscribe this gateway to a config.DynamicConfigManager whose
        merged config is (or carries) a ServingConfig: the live pool
        create / resize path."""
        def _on_update(cfg):
            serving = getattr(cfg, "serving", cfg)
            if isinstance(serving, ServingConfig):
                self.apply_config(serving)
        manager.subscribe(_on_update)

    def snapshot(self) -> dict:
        admission = self.admission.snapshot()
        return {"enabled": self.enabled,
                "admission": admission,
                "pools": admission["pools"],
                "lookup": self.batcher.snapshot(),
                "nearest": self.nearest_batcher.snapshot()}


def serving_snapshot() -> list:
    """Snapshots of every live gateway in this process (monitoring)."""
    return [g.snapshot() for g in list(_GATEWAYS)]
