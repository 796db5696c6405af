"""Runtime concurrency sanitizer: the dynamic complement of the static
lock analysis (`tools/analyze`'s guards pass).

Own copy of the JAX package's `utils/sanitizers.py`. An opt-in
instrumented lock layer over the port's registered locks records, live:

  * per-thread held-lock sets and the acquisition-order edges they
    imply (every held lock -> the lock being acquired),
  * lock-order INVERSIONS: acquiring B while holding A after some
    thread acquired A while holding B (the two-thread deadlock shape),
    with both acquisition stacks attached,
  * hold-time budget violations (a hot lock held longer than
    `hold_budget_seconds` serializes the serving plane),
  * host syncs and blocking I/O UNDER a registered hot lock: the
    failpoint I/O sites (`utils/failpoints.py`) and the device-to-host
    reads (`evaluator.finish` / `finish_all`, `whole_plan._read_counts`,
    the mesh's count reads) call `note_blocking(...)`, and the sanitizer
    flags any that run while a hot lock is held.

The observed edge set exports via `edge_snapshot()`; `reconcile` checks
that it is a subgraph of a static reconciliation graph, such as
`tools/analyze`'s `guard_inference.reconciliation_graph` built over
`load_files(root, package="ytsaurus_tpu_torch")`.

Gating: `YT_TPU_SANITIZE=1` or `config.SanitizerConfig.enabled` via
`configure()`. Disabled is the default and costs nothing:
`register_lock()` returns the plain `threading.Lock` unwrapped. Locks
created before enablement stay plain; enable before constructing the
daemons you want watched.

Registration names are stable SITE ids (`profiling.Counter._lock`):
every instance of a class shares its site's name, matching the static
graph's node granularity.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Optional

_ENV = "YT_TPU_SANITIZE"

# Bounded-report defaults (events beyond the cap still COUNT, they just
# stop accumulating stacks — the report must never grow unbounded under
# a pathological workload).
DEFAULT_HOLD_BUDGET = 0.25          # seconds a hot lock may be held
MAX_EDGES = 4096
MAX_EVENTS = 64
_STACK_LIMIT = 12
_PACKAGE = "ytsaurus_tpu_torch/"


def enabled() -> bool:
    if os.environ.get(_ENV, "") not in ("", "0"):
        return True
    return _config_enabled


_config_enabled = False


def _short_stack() -> "list[str]":
    """A compact acquisition stack: repo frames preferred, innermost
    last; falls back to the raw innermost frames when the acquisition
    came entirely from user code outside the tree (a report with no
    stack is undebuggable)."""
    frames = traceback.extract_stack(limit=_STACK_LIMIT + 8)[:-3]
    out = []
    for frame in frames:
        name = frame.filename.replace(os.sep, "/")
        if _PACKAGE in name or "/tests/" in name or "/tools/" in name:
            short = name.split(_PACKAGE)[-1] \
                if _PACKAGE in name else name.rsplit("/", 2)[-1]
            out.append(f"{short}:{frame.lineno} in {frame.name}")
    if not out:
        out = [f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} "
               f"in {f.name}" for f in frames[-4:]]
    return out[-_STACK_LIMIT:]


class _Held:
    """One per-thread held-lock frame."""

    __slots__ = ("name", "t0", "hot")

    def __init__(self, name: str, t0: float, hot: bool):
        self.name = name
        self.t0 = t0
        self.hot = hot


class LockSanitizer:
    """The event collector.  One process-global instance backs the
    registered locks; unit tests construct their own so deliberate
    inversions don't pollute the tier-1 reconciliation gate."""

    def __init__(self, hold_budget: float = DEFAULT_HOLD_BUDGET,
                 max_edges: int = MAX_EDGES,
                 max_events: int = MAX_EVENTS):
        self.hold_budget = hold_budget
        self.max_edges = max_edges
        self.max_events = max_events
        self._tl = threading.local()
        # Internal metadata lock: a LEAF by construction (never acquires
        # anything) and deliberately NOT registered with itself.
        self._meta = threading.Lock()
        self.edges: dict[tuple, dict] = {}     # (a, b) -> first sighting
        self.inversions: list[dict] = []
        self.hold_violations: list[dict] = []
        self.sync_under_lock: list[dict] = []
        # Tallies keep counting past the bounded report caps.  They are
        # DELIBERATELY lock-free int bumps: the sanitizer must not add a
        # global lock acquisition to every instrumented acquire, and an
        # occasionally-lost increment in telemetry is an acceptable
        # trade (the bounded event lists, which feed the reconciliation
        # gate, DO ride _meta).
        self.inversions_n = 0
        self.hold_violations_n = 0
        self.sync_under_lock_n = 0
        self.acquires_n = 0

    # -- per-thread stack ------------------------------------------------------

    def _stack(self) -> "list[_Held]":
        stack = getattr(self._tl, "stack", None)
        if stack is None:
            stack = self._tl.stack = []
        return stack

    def held_names(self) -> "list[str]":
        return [h.name for h in self._stack()]

    # -- events ----------------------------------------------------------------

    def on_acquire(self, name: str, hot: bool) -> None:
        stack = self._stack()
        self.acquires_n += 1
        t0 = time.monotonic()
        if stack:
            new_edges = []
            inversions = []
            for held in stack:
                if held.name == name:
                    continue        # re-entrant / sibling instance
                pair = (held.name, name)
                if pair not in self.edges:
                    new_edges.append(pair)
                if (name, held.name) in self.edges:
                    inversions.append(pair)
            if new_edges or inversions:
                frames = _short_stack()
                self.inversions_n += len(inversions)
                with self._meta:
                    for pair in new_edges:
                        if len(self.edges) < self.max_edges and \
                                pair not in self.edges:
                            self.edges[pair] = {
                                "thread": threading.current_thread().name,
                                "stack": frames,
                            }
                    for pair in inversions:
                        if len(self.inversions) < self.max_events:
                            prior = self.edges.get((pair[1], pair[0]))
                            self.inversions.append({
                                "acquiring": pair[1],
                                "holding": pair[0],
                                "stack": frames,
                                "prior_order_stack":
                                    (prior or {}).get("stack"),
                            })
        stack.append(_Held(name, t0, hot))

    def on_release(self, name: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].name == name:
                held = stack.pop(i)
                break
        else:
            return
        elapsed = time.monotonic() - held.t0
        if held.hot and elapsed > self.hold_budget:
            self.hold_violations_n += 1
            # analyze: allow(guard-read): approximate lock-free cap probe by design — the append below re-rides _meta
            if len(self.hold_violations) < self.max_events:
                with self._meta:
                    self.hold_violations.append({
                        "lock": name,
                        "held_seconds": round(elapsed, 4),
                        "budget_seconds": self.hold_budget,
                        "thread": threading.current_thread().name,
                        "stack": _short_stack(),
                    })

    def note_blocking(self, kind: str, detail: str) -> None:
        """A blocking operation (failpoint I/O site, host sync) is about
        to run on this thread; flag it if a registered HOT lock is
        held."""
        hot = [h.name for h in self._stack() if h.hot]
        if not hot:
            return
        self.sync_under_lock_n += 1
        # analyze: allow(guard-read): approximate lock-free cap probe by design — the append below re-rides _meta
        if len(self.sync_under_lock) < self.max_events:
            with self._meta:
                self.sync_under_lock.append({
                    "kind": kind,
                    "detail": detail,
                    "locks_held": hot,
                    "thread": threading.current_thread().name,
                    "stack": _short_stack(),
                })

    # -- reporting -------------------------------------------------------------

    def edge_snapshot(self) -> "dict[tuple, dict]":
        with self._meta:
            return dict(self.edges)

    def counters(self) -> dict:
        return {
            "inversions": self.inversions_n,
            "hold_violations": self.hold_violations_n,
            "sync_under_lock": self.sync_under_lock_n,
            "edges_observed": len(self.edges),
            "acquires": self.acquires_n,
        }

    def snapshot(self) -> dict:
        """The bounded report (monitoring /sanitizer + orchid)."""
        with self._meta:
            edges = sorted(f"{a} -> {b}" for a, b in self.edges)
            report = {
                "enabled": True,
                "hold_budget_seconds": self.hold_budget,
                "counters": self.counters(),
                "edges": edges,
                "inversions": list(self.inversions),
                "hold_violations": list(self.hold_violations),
                "sync_under_lock": list(self.sync_under_lock),
                "registered_sites": sorted(_registered),
            }
        _publish_sensors(self)
        return report

    def reset(self) -> None:
        with self._meta:
            self.edges.clear()
            self.inversions.clear()
            self.hold_violations.clear()
            self.sync_under_lock.clear()
        # Lock-free like their bumps (see __init__) — zeroing them under
        # _meta would manufacture guard evidence the hot path never has.
        self.inversions_n = 0
        self.hold_violations_n = 0
        self.sync_under_lock_n = 0
        self.acquires_n = 0


# -- instrumented lock types ---------------------------------------------------


class InstrumentedLock:
    """`threading.Lock` + sanitizer events.  Only constructed when the
    sanitizer is enabled; the disabled path hands out plain locks."""

    __slots__ = ("_lock", "_name", "_san", "_hot")

    def __init__(self, san: LockSanitizer, name: str,
                 lock=None, hot: bool = True):
        self._san = san
        self._name = name
        self._lock = lock if lock is not None else threading.Lock()
        self._hot = hot

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._san.on_acquire(self._name, self._hot)
        return got

    def release(self) -> None:
        self._san.on_release(self._name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class InstrumentedRLock:
    """Re-entrant variant: only the OUTERMOST acquire/release emit
    sanitizer events (nested re-acquisition is not an ordering edge)."""

    __slots__ = ("_lock", "_name", "_san", "_hot", "_depth")

    def __init__(self, san: LockSanitizer, name: str,
                 lock=None, hot: bool = True):
        self._san = san
        self._name = name
        self._lock = lock if lock is not None else threading.RLock()
        self._hot = hot
        self._depth = threading.local()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            depth = getattr(self._depth, "n", 0)
            if depth == 0:
                self._san.on_acquire(self._name, self._hot)
            self._depth.n = depth + 1
        return got

    def release(self) -> None:
        depth = getattr(self._depth, "n", 1) - 1
        self._depth.n = depth
        if depth == 0:
            self._san.on_release(self._name)
        self._lock.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class InstrumentedCondition:
    """`threading.Condition` + sanitizer events.  `wait()` RELEASES the
    underlying lock until wakeup — the held-set bookkeeping mirrors
    that, so hold budgets exclude the wait and edges observed by a woken
    thread attribute correctly."""

    __slots__ = ("_cond", "_name", "_san", "_hot")

    def __init__(self, san: LockSanitizer, name: str,
                 cond=None, hot: bool = True):
        self._san = san
        self._name = name
        self._cond = cond if cond is not None else threading.Condition()
        self._hot = hot

    def acquire(self, *args, **kwargs) -> bool:
        got = self._cond.acquire(*args, **kwargs)
        if got:
            self._san.on_acquire(self._name, self._hot)
        return got

    def release(self) -> None:
        self._san.on_release(self._name)
        self._cond.release()

    def __enter__(self) -> bool:
        got = self._cond.__enter__()
        self._san.on_acquire(self._name, self._hot)
        return got

    def __exit__(self, *exc) -> None:
        self._san.on_release(self._name)
        return self._cond.__exit__(*exc)

    def wait(self, timeout: Optional[float] = None):
        self._san.on_release(self._name)
        try:
            return self._cond.wait(timeout)
        finally:
            self._san.on_acquire(self._name, self._hot)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._san.on_release(self._name)
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            self._san.on_acquire(self._name, self._hot)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


# -- registration (the one helper the ~30 hot-lock sites call) -----------------

_global: Optional[LockSanitizer] = None
_global_lock = threading.Lock()
_registered: "dict[str, int]" = {}      # site name -> instance count


def get_sanitizer() -> Optional[LockSanitizer]:
    """The process-global sanitizer, or None when disabled."""
    return _global


def _get_or_create() -> LockSanitizer:
    global _global
    if _global is None:
        with _global_lock:
            if _global is None:
                _global = LockSanitizer()
    return _global


def _register(name: str):
    with _global_lock:
        _registered[name] = _registered.get(name, 0) + 1


def register_lock(name: str, lock=None, *, hot: bool = True):
    """The registration helper every hot-lock site calls:

        self._lock = sanitizers.register_lock("serving.Batcher._lock")

    Disabled (the default): returns the plain `threading.Lock` (or the
    one passed in) — no wrapper, no overhead.  Enabled: returns an
    InstrumentedLock feeding the global sanitizer.  `hot=False`
    registers for ordering/edges but exempts the lock from the
    hold-budget and sync-under-lock rules (locks that intentionally
    cover I/O, e.g. the AOT disk tier's)."""
    if not enabled():
        return lock if lock is not None else threading.Lock()
    _register(name)
    return InstrumentedLock(_get_or_create(), name, lock, hot=hot)


def register_rlock(name: str, lock=None, *, hot: bool = True):
    if not enabled():
        return lock if lock is not None else threading.RLock()
    _register(name)
    return InstrumentedRLock(_get_or_create(), name, lock, hot=hot)


def register_condition(name: str, cond=None, *, hot: bool = True):
    if not enabled():
        return cond if cond is not None else threading.Condition()
    _register(name)
    return InstrumentedCondition(_get_or_create(), name, cond, hot=hot)


def registered_sites() -> "list[str]":
    return sorted(_registered)


# -- blocking-operation probes (failpoints + device-to-host reads call these) --


def note_blocking(kind: str, detail: str) -> None:
    """Called at the statically-known blocking boundaries: failpoint
    I/O sites (`FailpointSite.hit`/`write_hit`) and the device-to-host
    reads.  A no-op (one global read) when the sanitizer is off."""
    san = _global
    if san is not None:
        san.note_blocking(kind, detail)


def note_host_sync(detail: str) -> None:
    note_blocking("host-sync", detail)


# -- config + reporting surfaces -----------------------------------------------


def configure(config) -> None:
    """Apply a `config.SanitizerConfig`: enablement for locks created
    AFTER this call, plus budgets on the live sanitizer."""
    global _config_enabled
    _config_enabled = bool(getattr(config, "enabled", False))
    san = _get_or_create() if _config_enabled else _global
    if san is not None:
        budget = getattr(config, "hold_budget_seconds", None)
        if budget is not None:
            # 0.0 is a legal (maximally strict) budget — config
            # validates ge=0, so apply whatever it accepted.
            san.hold_budget = float(budget)


def snapshot() -> dict:
    """Monitoring /sanitizer + orchid producer (bounded)."""
    san = _global
    if san is None:
        return {"enabled": False, "registered_sites": sorted(_registered)}
    return san.snapshot()


def edge_snapshot() -> "dict[tuple, dict]":
    san = _global
    return san.edge_snapshot() if san is not None else {}


def counters() -> dict:
    san = _global
    if san is None:
        return {"inversions": 0, "hold_violations": 0,
                "sync_under_lock": 0, "edges_observed": 0, "acquires": 0}
    return san.counters()


def _publish_sensors(san: LockSanitizer) -> None:
    """Mirror the counters onto /metrics (pull-time, never in the
    per-acquire path)."""
    from ytsaurus_tpu_torch.utils.profiling import Profiler
    prof = Profiler("/sanitizer")
    stats = san.counters()
    prof.gauge("inversions").set(stats["inversions"])
    prof.gauge("hold_violations").set(stats["hold_violations"])
    prof.gauge("sync_under_lock").set(stats["sync_under_lock"])
    prof.gauge("edges_observed").set(stats["edges_observed"])


# -- reconciliation against the static graph -----------------------------------


def reconcile(static_edges, site_map, observed=None) -> "list[str]":
    """Dynamic ⊆ static: every OBSERVED acquisition edge between two
    registered sites must exist in the static reconciliation graph.

    `static_edges`: [a_node, b_node, site] triples (guard_inference.
    reconciliation_graph()["edges"]); `site_map`: registration name →
    static node id (same snapshot's "site_map").  Returns one violation
    string per missing edge, acquisition stacks attached — empty means
    the static analysis models runtime reality."""
    observed = observed if observed is not None else edge_snapshot()
    static = {(a, b) for a, b, _site in static_edges}
    violations = []
    for (a, b), info in sorted(observed.items()):
        node_a = site_map.get(a)
        node_b = site_map.get(b)
        if node_a is None or node_b is None:
            continue        # unregistered site: not part of the gate
        if node_a == node_b:
            continue        # sibling instances of one site
        if (node_a, node_b) in static:
            continue
        stack = "\n    ".join(info.get("stack") or ["<no stack>"])
        violations.append(
            f"dynamic lock-order edge {a} -> {b} "
            f"({node_a} -> {node_b}) is MISSING from the static "
            f"graph — teach tools/analyze (accessor/index resolution) "
            f"or restructure the locking; observed on thread "
            f"{info.get('thread')} at:\n    {stack}")
    return violations
