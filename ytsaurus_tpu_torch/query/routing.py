"""Load-aware replica routing for the serving plane.

Ref shape: the reference's replica-aware channel picks peers by
tracked load/health rather than blind hedging (hedging duplicates
work; under overload it DOUBLES the storm).  `ReplicaRouter` scrapes
each serving replica's monitoring `/serving` endpoint — the queue
depth, hold-EWMA, and brown-out rung the admission controller already
exports — and routes every request to the replica with the lowest
estimated drain time, blending in the client-observed latency EWMA.

The router is transport-agnostic: a replica is (name, rpc address,
monitoring address); `pick()` returns the replica to use and
`report()` feeds back what the client actually observed (latency or a
hard error, which quarantines the replica for `penalty_seconds`).
`RoutedYtClient` composes it with one RemoteYtClient per replica.

Failpoint site `serving.route_scrape` fires per scrape attempt: error
mode simulates an unreachable monitoring endpoint (the routing-scrape
timeout chaos leg), which must degrade the router to its last-known
loads, never fail a query.

Sensors (`/serving/routing/*`): scrapes, scrape_errors, picks{replica=},
failovers.

Own copy of the JAX package's `query/routing.py`.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Optional, Sequence

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.utils import failpoints
from ytsaurus_tpu_torch.utils.logging import get_logger
from ytsaurus_tpu_torch.utils.profiling import Profiler
from ytsaurus_tpu_torch.utils import sanitizers

logger = get_logger("ReplicaRouter")

_FP_ROUTE_SCRAPE = failpoints.register_site(
    "serving.route_scrape",
    error=lambda s: YtError(f"injected routing scrape failure at {s}",
                            code=EErrorCode.TransportError))

# A replica whose scrape failed scores as if this many seconds of
# backlog were queued — routed to only when every peer looks worse.
_UNKNOWN_PENALTY = 30.0


class Replica:
    """One serving replica: identity plus the router's live view."""

    __slots__ = ("name", "address", "monitor_address", "queue_depth",
                 "in_flight", "hold_ewma", "rung", "latency_ewma",
                 "pools", "pool_latency", "scraped_at", "scrape_ok",
                 "penalized_until", "picks_n", "errors_n")

    def __init__(self, name: str, address: str, monitor_address: str):
        self.name = name
        self.address = address
        self.monitor_address = monitor_address
        self.queue_depth = 0
        self.in_flight = 0
        self.hold_ewma = 0.05
        self.rung = 0
        self.latency_ewma = 0.0
        # Per-pool scraped view: pool -> (waiting, in_flight,
        # fair_slots) — fair-share admission means MY wait prospects
        # depend on MY pool's backlog against MY pool's slots, not on
        # how deep some other tenant's queue happens to be.
        self.pools: dict = {}
        self.pool_latency: dict = {}       # pool -> latency EWMA
        self.scraped_at: Optional[float] = None
        self.scrape_ok = False
        self.penalized_until = 0.0
        self.picks_n = 0
        self.errors_n = 0

    def view(self) -> dict:
        return {"name": self.name, "address": self.address,
                "monitor_address": self.monitor_address,
                "queue_depth": self.queue_depth,
                "in_flight": self.in_flight,
                "hold_ewma": round(self.hold_ewma, 6),
                "rung": self.rung,
                "latency_ewma": round(self.latency_ewma, 6),
                "pools": {name: {"waiting": w, "in_flight": f,
                                 "fair_slots": round(s, 2)}
                          for name, (w, f, s) in self.pools.items()},
                "scrape_ok": self.scrape_ok,
                "picks": self.picks_n,
                "errors": self.errors_n}


class ReplicaRouter:
    """Routes requests to the least-loaded serving replica by REPORTED
    load (scraped from `/serving`), not by blind hedging."""

    def __init__(self, replicas: Sequence[tuple],
                 scrape_period: float = 0.5,
                 scrape_timeout: float = 1.0,
                 penalty_seconds: float = 2.0,
                 latency_alpha: float = 0.3):
        # guards: _replicas, _rr
        self._lock = sanitizers.register_lock(
            "routing.ReplicaRouter._lock", hot=False)
        self._replicas: list[Replica] = []
        for spec in replicas:
            name, address, monitor = self._spec(spec)
            self._replicas.append(Replica(name, address, monitor))
        self.scrape_period = scrape_period
        self.scrape_timeout = scrape_timeout
        self.penalty_seconds = penalty_seconds
        self.latency_alpha = latency_alpha
        self._rr = 0                      # tie-break rotation
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        prof = Profiler("/serving/routing")
        self._prof = prof
        self._scrapes = prof.counter("scrapes")
        self._scrape_errors = prof.counter("scrape_errors")
        self._failovers = prof.counter("failovers")
        self.scrapes_n = 0
        self.scrape_errors_n = 0
        self.failovers_n = 0

    @staticmethod
    def _spec(spec) -> tuple:
        if isinstance(spec, Replica):
            return spec.name, spec.address, spec.monitor_address
        if len(spec) == 2:
            address, monitor = spec
            return address, address, monitor
        return tuple(spec)

    # -- membership ------------------------------------------------------------

    def add_replica(self, spec) -> Replica:
        """Register a replica joining live (the mid-storm scale-out
        arm); it starts un-scraped and picks up load on the next
        scrape."""
        name, address, monitor = self._spec(spec)
        replica = Replica(name, address, monitor)
        with self._lock:
            self._replicas.append(replica)
        return replica

    def remove_replica(self, name: str) -> None:
        with self._lock:
            self._replicas = [r for r in self._replicas
                              if r.name != name]

    def replicas(self) -> list[Replica]:
        with self._lock:
            return list(self._replicas)

    # -- scraping --------------------------------------------------------------

    def scrape_once(self) -> int:
        """Scrape every replica's /serving; returns how many succeeded.
        A failed scrape marks the replica UNKNOWN (penalized in scoring)
        but never raises — routing degrades to last-known loads."""
        ok = 0
        for replica in self.replicas():
            try:
                _FP_ROUTE_SCRAPE.hit()
                with urllib.request.urlopen(
                        f"http://{replica.monitor_address}/serving",
                        timeout=self.scrape_timeout) as resp:
                    payload = json.loads(resp.read().decode())
                self._absorb(replica, payload)
                ok += 1
            except Exception as exc:   # noqa: BLE001 — the scrape is
                # best-effort: an unreachable monitoring endpoint must
                # degrade routing, never fail it.
                with self._lock:
                    replica.scrape_ok = False
                    replica.scraped_at = time.monotonic()
                self.scrape_errors_n += 1
                self._scrape_errors.increment()
                logger.debug("scrape of %s failed: %r",
                             replica.monitor_address, exc)
        self.scrapes_n += 1
        self._scrapes.increment()
        return ok

    def _absorb(self, replica: Replica, payload: dict) -> None:
        queue = in_flight = rung = 0
        hold = 0.05
        pools: dict = {}
        for gw in payload.get("gateways", []):
            admission = gw.get("admission") or {}
            hold = max(hold, float(admission.get("hold_ewma", 0.05)))
            rung = max(rung, int((admission.get("brownout") or {})
                                 .get("rung", 0)))
            for name, pool in (admission.get("pools") or
                               gw.get("pools") or {}).items():
                w = int(pool.get("waiting", 0))
                f = int(pool.get("in_flight", 0))
                s = float(pool.get("fair_slots", 0.0))
                queue += w
                in_flight += f
                pw, pf, ps = pools.get(name, (0, 0, 0.0))
                pools[name] = (pw + w, pf + f, ps + s)
        with self._lock:
            replica.queue_depth = queue
            replica.in_flight = in_flight
            replica.hold_ewma = hold
            replica.rung = rung
            replica.pools = pools
            replica.scrape_ok = True
            replica.scraped_at = time.monotonic()

    def start(self) -> "ReplicaRouter":
        self.scrape_once()                 # seed before first pick
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="replica-router")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.scrape_period):
            self.scrape_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- routing ---------------------------------------------------------------

    def _score(self, replica: Replica, now: float,
               pool: Optional[str] = None) -> float:
        """Estimated seconds until this replica would serve a new
        request: its backlog drain estimate plus the client-observed
        latency EWMA, with brown-out rungs and quarantine as explicit
        step penalties (a rung-2 replica is actively shedding — route
        around it while ANY alternative exists).

        Pool-aware (fair-share-aware) when the request names a pool the
        scrape knows: under fair-share admission this request's wait
        prospects are ITS pool's backlog against ITS pool's fair slots.
        Scoring by the global queue would let one greedy tenant's
        thousand-deep backlog blind the router for every OTHER tenant —
        both replicas look identically terrible, picks degrade to
        round-robin, and the innocent pool's p99 pays for the collisions.
        The latency EWMA is per-pool for the same reason: the greedy
        pool's multi-second queue waits must not poison the estimate
        for a pool that is not queued at all."""
        if now < replica.penalized_until:
            return _UNKNOWN_PENALTY * 10.0
        stats = replica.pools.get(pool) if pool else None
        if stats is not None:
            waiting, in_flight, fair_slots = stats
            backlog = (waiting + in_flight) * replica.hold_ewma / \
                max(fair_slots, 1.0)
            latency = replica.pool_latency.get(pool, 0.0)
        else:
            backlog = (replica.queue_depth + replica.in_flight) * \
                replica.hold_ewma
            latency = replica.latency_ewma
        if not replica.scrape_ok:
            backlog += _UNKNOWN_PENALTY
        return backlog + latency + replica.rung * _UNKNOWN_PENALTY

    def pick(self, pool: Optional[str] = None) -> Replica:
        now = time.monotonic()
        with self._lock:
            if not self._replicas:
                raise YtError("ReplicaRouter has no replicas",
                              code=EErrorCode.PeerUnavailable)
            self._rr += 1
            candidates = self._replicas[self._rr % len(self._replicas):] \
                + self._replicas[:self._rr % len(self._replicas)]
            best = min(candidates,
                       key=lambda r: self._score(r, now, pool))
            best.picks_n += 1
        self._prof.with_tags(replica=best.name).counter(
            "picks").increment()
        return best

    def report(self, replica: Replica, latency: Optional[float] = None,
               error: bool = False,
               pool: Optional[str] = None) -> None:
        """Client-observed outcome feedback: latency folds into the
        replica's EWMA (the named pool's, when given); a hard error
        quarantines it for `penalty_seconds` (the next picks fail over)
        until a successful scrape or call clears the view."""
        with self._lock:
            if error:
                replica.errors_n += 1
                replica.penalized_until = time.monotonic() + \
                    self.penalty_seconds
                self.failovers_n += 1
            else:
                replica.penalized_until = 0.0
                if latency is not None:
                    prev = replica.latency_ewma
                    replica.latency_ewma = prev + self.latency_alpha * \
                        (latency - prev)
                    if pool is not None:
                        prev = replica.pool_latency.get(pool, 0.0)
                        replica.pool_latency[pool] = prev + \
                            self.latency_alpha * (latency - prev)
        if error:
            self._failovers.increment()

    def snapshot(self) -> dict:
        with self._lock:
            return {"replicas": [r.view() for r in self._replicas],
                    "scrapes": self.scrapes_n,
                    "scrape_errors": self.scrape_errors_n,
                    "failovers": self.failovers_n}


class RoutedYtClient:
    """A thin multi-replica facade: every read routes through the
    ReplicaRouter to the least-loaded replica's client; a hard
    transport failure reports the replica (quarantine) and fails over
    to the next pick, ONCE — the per-replica channels already retry
    transport blips, and unbounded failover is its own storm."""

    def __init__(self, router: ReplicaRouter, clients: dict):
        self.router = router
        self._clients = dict(clients)      # replica name -> client

    def add_replica(self, spec, client) -> None:
        replica = self.router.add_replica(spec)
        self._clients[replica.name] = client

    def _call(self, method: str, *args, **kwargs):
        last_err = None
        pool = kwargs.get("pool")
        for _attempt in range(2):
            replica = self.router.pick(pool=pool)
            client = self._clients[replica.name]
            t0 = time.monotonic()
            try:
                out = getattr(client, method)(*args, **kwargs)
            except YtError as err:
                if err.code in (EErrorCode.TransportError,
                                EErrorCode.RpcTimeout,
                                EErrorCode.PeerUnavailable):
                    self.router.report(replica, error=True)
                    last_err = err
                    continue
                raise
            self.router.report(replica,
                               latency=time.monotonic() - t0,
                               pool=pool)
            return out
        raise last_err

    def lookup_rows(self, *args, **kwargs):
        return self._call("lookup_rows", *args, **kwargs)

    def select_rows(self, *args, **kwargs):
        return self._call("select_rows", *args, **kwargs)

    def nearest_rows(self, *args, **kwargs):
        return self._call("nearest_rows", *args, **kwargs)

    def snapshot(self) -> dict:
        return self.router.snapshot()
