"""SLO tracking: burn-rate alerting over the metrics-history rings.

Own copy of the JAX package's `utils/slo.py`. Ref shape: SRE
multi-window multi-burn-rate alerting (the policy the reference's
monitoring system implements over Solomon series): an SLO
declares an objective (fraction of good events) and the alert condition
is on the BURN RATE — how fast the error budget is being consumed —
measured over two windows at once.  The fast window (default 5min)
catches a regression within minutes; the slow window (default 1h) keeps
a single blip from paging; the alert fires only when BOTH exceed the
threshold and resolves once the fast window recovers.

SLIs come from the history rings, not from per-request logs: counter
deltas for availability/ratio objectives, histogram bucket deltas for
latency objectives ("99% of selects under 50ms" needs only the bucket
rings).  Declaration lives in `config.TelemetryConfig.slos`; evaluation
runs after every telemetry sample (utils/profiling.TelemetrySampler)
and on demand from the monitoring `/slo` endpoint.
"""

from __future__ import annotations

import bisect
import time
from collections import deque
from typing import Optional

from ytsaurus_tpu_torch.utils.profiling import MetricsHistory, get_history
from ytsaurus_tpu_torch.utils import sanitizers


class SloTracker:
    """Evaluates every declared SLO over the history rings and keeps the
    active/resolved alert state (bounded).  Thread-safe; one global
    instance per process plus private ones in tests."""

    RESOLVED_CAPACITY = 64

    def __init__(self, config=None,
                 history: Optional[MetricsHistory] = None):
        self._config = config
        self._history = history
        # guards: _active, _resolved, _last_eval
        self._lock = sanitizers.register_lock("slo.SloTracker._lock")
        self._active: dict[str, dict] = {}
        self._resolved: deque = deque(maxlen=self.RESOLVED_CAPACITY)
        self._last_eval: dict[str, dict] = {}

    @property
    def config(self):
        if self._config is not None:
            return self._config
        from ytsaurus_tpu_torch.config import telemetry_config
        return telemetry_config()

    @property
    def history(self) -> MetricsHistory:
        return self._history if self._history is not None \
            else get_history()

    # -- SLI math --------------------------------------------------------------

    def _error_rate(self, slo, window: float,
                    now: Optional[float]) -> tuple[float, float]:
        """(error_rate, total_events) over the trailing window."""
        if slo.kind == "latency":
            delta = self.history.window_delta(slo.sensor, slo.tags,
                                              window, now)
            if delta is None or not isinstance(delta, tuple) \
                    or len(delta) < 4:
                return 0.0, 0.0
            d_count, _d_sum, d_buckets, bounds = delta
            if d_count <= 0 or bounds is None:
                return 0.0, 0.0
            # Good events: buckets whose UPPER bound fits the latency
            # bound (bisect_right: a bound exactly equal is still good).
            bound_s = slo.bound_ms / 1e3
            good_buckets = bisect.bisect_right(list(bounds), bound_s)
            good = sum(d_buckets[:good_buckets])
            return max(d_count - good, 0) / d_count, float(d_count)
        good = self.history.window_delta(slo.good_sensor, slo.tags,
                                         window, now) or 0.0
        bad = self.history.window_delta(slo.bad_sensor, slo.tags,
                                        window, now) or 0.0
        total = good + bad
        if total <= 0:
            return 0.0, 0.0
        return bad / total, float(total)

    def _burn(self, slo, window: float,
              now: Optional[float]) -> tuple[float, float, float]:
        rate, total = self._error_rate(slo, window, now)
        budget = max(1.0 - slo.objective, 1e-9)
        return rate / budget, rate, total

    # -- evaluation ------------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One evaluation pass over every declared SLO; updates alert
        state and returns the full snapshot."""
        wall = time.time() if now is None else now
        slos = dict(self.config.slos or {})
        results: dict[str, dict] = {}
        for name, slo in slos.items():
            burn_fast, rate_fast, n_fast = self._burn(
                slo, slo.fast_window, now)
            burn_slow, rate_slow, n_slow = self._burn(
                slo, slo.slow_window, now)
            firing = burn_fast > slo.burn_threshold and \
                burn_slow > slo.burn_threshold
            results[name] = {
                "slo": name, "kind": slo.kind,
                "objective": slo.objective,
                "burn_threshold": slo.burn_threshold,
                "burn_fast": round(burn_fast, 4),
                "burn_slow": round(burn_slow, 4),
                "error_rate_fast": round(rate_fast, 6),
                "error_rate_slow": round(rate_slow, 6),
                "events_fast": n_fast, "events_slow": n_slow,
                "firing": firing,
            }
        with self._lock:
            self._last_eval = results
            for name, result in results.items():
                active = self._active.get(name)
                if result["firing"]:
                    if active is None:
                        self._active[name] = {**result, "state": "firing",
                                              "since": wall}
                    else:
                        active.update(result)
                elif active is not None and \
                        results[name]["burn_fast"] <= \
                        slos[name].burn_threshold:
                    # Resolve on FAST-window recovery: the slow window
                    # lags by design and must not pin a healed alert.
                    self._active.pop(name)
                    self._resolved.append({**active, **result,
                                           "state": "resolved",
                                           "resolved_at": wall})
            # Drop alerts whose SLO was undeclared (dynamic config).
            for stale in [n for n in self._active if n not in slos]:
                self._active.pop(stale)
        return self.snapshot()

    # -- views -----------------------------------------------------------------

    def active_alerts(self) -> list[dict]:
        with self._lock:
            return [dict(a) for _n, a in sorted(self._active.items())]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "slos": {name: dict(r)
                         for name, r in sorted(self._last_eval.items())},
                "active_alerts": [dict(a) for _n, a in
                                  sorted(self._active.items())],
                "resolved_alerts": [dict(a) for a in self._resolved],
            }


_global_tracker: Optional[SloTracker] = None
# guards: _global_tracker
_tracker_lock = sanitizers.register_lock("slo._tracker_lock",
                                         hot=False)


def get_slo_tracker() -> SloTracker:
    global _global_tracker
    if _global_tracker is None:
        with _tracker_lock:
            if _global_tracker is None:
                _global_tracker = SloTracker()
    return _global_tracker


def configure(cfg) -> None:
    """Rebind the global tracker to a new telemetry config (called by
    config.set_telemetry_config; None restores lazy defaults)."""
    global _global_tracker
    with _tracker_lock:
        _global_tracker = None if cfg is None else SloTracker(cfg)
