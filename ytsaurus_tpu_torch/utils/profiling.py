"""Typed sensors on a tag tree + Prometheus-format export.

Own copy of the JAX package's `utils/profiling.py` (ref library/profiling
TProfiler: counters, gauges, summaries and histograms under a tag tree,
library/profiling/solomon/exporter.h:25 for the pull endpoint): one
process-wide `ProfilerRegistry`, a `Profiler` as a (prefix, tags) view
onto it, `Timer`, `PoolSensorCache` (per-pool counter sets), the
Prometheus text rendering that the daemons' monitoring servers serve,
and the bounded metrics-history rings (`MetricsHistory`) with the
sampler thread that fills them and runs the SLO evaluation
(`TelemetrySampler`, `start_telemetry`).
"""

from __future__ import annotations

import bisect
import random
import threading
import time
from collections import deque
from typing import Optional

from ytsaurus_tpu_torch.utils import sanitizers


def _escape_label_value(value) -> str:
    """Prometheus exposition escaping for label values: backslash,
    double quote, and newline must be escaped or the scrape line is
    grammatically invalid (the exposition-validator test enforces it)."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _format_tags(tags: dict[str, str]) -> str:
    if not tags:
        return ""
    inner = ",".join(
        f'{_sanitize(str(k))}="{_escape_label_value(v)}"'
        for k, v in sorted(tags.items()))
    return "{" + inner + "}"


def _sanitize(name: str) -> str:
    return name.strip("/").replace("/", "_").replace("-", "_").replace(".", "_")


class Counter:
    """Monotone counter."""

    kind = "counter"

    def __init__(self):
        # guards: _value
        self._lock = sanitizers.register_lock("profiling.Counter._lock")
        self._value = 0.0

    def increment(self, delta: float = 1.0) -> None:
        with self._lock:
            self._value += delta

    def get(self) -> float:
        return self._value

    def samples(self):
        yield "counter", "", self._value

    def history_sample(self):
        return self._value


class Gauge:
    """Last-set value."""

    kind = "gauge"

    def __init__(self):
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def get(self) -> float:
        return self._value

    def samples(self):
        yield "gauge", "", self._value

    def history_sample(self):
        return self._value


class Summary:
    """Count/sum/min/max/last of observed values, plus a BOUNDED
    quantile reservoir.

    The reservoir is Vitter's algorithm R: a fixed-size uniform sample
    of every observation so far, so a month-long daemon's sensor memory
    stays O(RESERVOIR_CAPACITY) no matter how many values it records
    (an unbounded per-sensor value list would
    grow without bound at serving rates).  `quantile()` reads it for
    p50/p99-style estimates."""

    kind = "summary"
    RESERVOIR_CAPACITY = 512

    def __init__(self):
        # guards: count, sum, min, max, last, _reservoir
        self._lock = sanitizers.register_lock("profiling.Summary._lock")
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.last = 0.0
        self._reservoir: list[float] = []

    def record(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += value
            self.min = min(self.min, value)
            self.max = max(self.max, value)
            self.last = value
            if len(self._reservoir) < self.RESERVOIR_CAPACITY:
                self._reservoir.append(value)
            else:
                j = random.randrange(self.count)
                if j < self.RESERVOIR_CAPACITY:
                    self._reservoir[j] = value

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1) from the bounded reservoir."""
        with self._lock:
            if not self._reservoir:
                return 0.0
            ordered = sorted(self._reservoir)
        idx = min(int(q * len(ordered)), len(ordered) - 1)
        return ordered[idx]

    def samples(self):
        yield "summary", ".sum", self.sum
        yield "summary", ".count", self.count
        if self.count:
            yield "summary", ".min", self.min
            yield "summary", ".max", self.max

    def history_sample(self):
        return (self.count, self.sum)


class Histogram:
    """Fixed-bucket histogram (upper bounds; +Inf implicit)."""

    kind = "histogram"
    DEFAULT_BOUNDS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                      30.0, 60.0)

    def __init__(self, bounds=None):
        self.bounds = tuple(bounds or self.DEFAULT_BOUNDS)
        # guards: buckets, count, sum
        self._lock = sanitizers.register_lock(
            "profiling.Histogram._lock")
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def record(self, value: float) -> None:
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.buckets[idx] += 1
            self.count += 1
            self.sum += value

    def samples(self):
        cumulative = 0
        for bound, n in zip(self.bounds, self.buckets):
            cumulative += n
            yield "histogram", f'.bucket{{le="{bound}"}}', cumulative
        yield "histogram", '.bucket{le="+Inf"}', self.count
        yield "histogram", ".sum", self.sum
        yield "histogram", ".count", self.count

    def history_sample(self):
        # Raw per-bucket counts (NOT cumulative): window deltas then
        # subtract elementwise and quantile math cumsums the result.
        return (self.count, self.sum, tuple(self.buckets))


class Timer:
    """Context manager recording elapsed seconds into a Summary/Histogram."""

    def __init__(self, sensor):
        self._sensor = sensor

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sensor.record(time.perf_counter() - self._t0)
        return False


class ProfilerRegistry:
    """All sensors of one process, keyed by (name, frozen tags)."""

    def __init__(self):
        # guards: _sensors
        self._lock = sanitizers.register_lock(
            "profiling.ProfilerRegistry._lock")
        self._sensors: dict[tuple, object] = {}

    def _get(self, name: str, tags: dict, factory):
        key = (name, tuple(sorted(tags.items())))
        with self._lock:
            sensor = self._sensors.get(key)
            if sensor is None:
                sensor = self._sensors[key] = factory()
            return sensor

    def render_prometheus(self) -> str:
        """Text exposition format, stable ordering."""
        lines = []
        with self._lock:
            items = sorted(self._sensors.items(),
                           key=lambda kv: (kv[0][0], kv[0][1]))
        for (name, tags), sensor in items:
            metric = _sanitize(name)
            tag_str = _format_tags(dict(tags))
            for _kind, suffix, value in sensor.samples():
                if suffix.startswith(".bucket"):
                    # merge histogram le-tag with sensor tags
                    le = suffix[len(".bucket"):]
                    base = tag_str[:-1] + "," + le[1:] if tag_str \
                        else le
                    lines.append(f"{metric}_bucket{base} {value}")
                else:
                    lines.append(
                        f"{metric}{suffix.replace('.', '_')}{tag_str} "
                        f"{value}")
        return "\n".join(lines) + ("\n" if lines else "")

    def collect(self) -> dict:
        """Live snapshot as a plain dict (Orchid's data source)."""
        out = {}
        with self._lock:
            items = list(self._sensors.items())
        for (name, tags), sensor in items:
            entry = {suffix or "value": value
                     for _k, suffix, value in sensor.samples()
                     if not suffix.startswith(".bucket")}
            key = name + _format_tags(dict(tags))
            out[key] = entry if len(entry) > 1 else next(iter(entry.values()))
        return out


_global_registry = ProfilerRegistry()


def get_registry() -> ProfilerRegistry:
    return _global_registry


# ---------------------------------------------------------------------------
# Metrics history: bounded in-process time-series rings.
#
# Ref shape: Solomon-style metrics history — the reference's monitoring
# system keeps per-sensor time series the dashboards and alerts read;
# here each process keeps its own bounded rings (a sampler thread
# snapshots every registered sensor at TelemetryConfig.sample_period)
# served via /metrics/history and orchid /telemetry/history, and the
# primary's /cluster roll-up scrapes every daemon's rings for the fleet
# view.  Two tiers bound memory while keeping both resolutions: fine
# (sample_period x fine_capacity, default 10s x 360 = 1h) and coarse
# (every coarse_every-th sample, default 5min x 288 = 24h).
# ---------------------------------------------------------------------------


class _SeriesRing:
    """One sensor's bounded history: (timestamp, history_sample) points
    in two fixed-size deques.  Counter/gauge points carry a float;
    summaries (count, sum); histograms (count, sum, raw buckets)."""

    __slots__ = ("kind", "bounds", "fine", "coarse")

    def __init__(self, kind: str, bounds, fine_capacity: int,
                 coarse_capacity: int):
        self.kind = kind
        self.bounds = bounds            # histogram upper bounds, else None
        self.fine: deque = deque(maxlen=fine_capacity)
        self.coarse: deque = deque(maxlen=coarse_capacity)

    def points(self, tier: str) -> list:
        return list(self.coarse if tier == "coarse" else self.fine)

    def at_or_before(self, ts: float):
        """Newest point with timestamp <= ts, preferring fine resolution
        and falling back to the coarse tier for older horizons."""
        for tier in (self.fine, self.coarse):
            best = None
            for point in tier:
                if point[0] <= ts:
                    best = point
                else:
                    break
            if best is not None:
                return best
        # Nothing old enough: the oldest point we still hold (best
        # effort — a window larger than retention reads what's left).
        if self.coarse:
            return self.coarse[0]
        return self.fine[0] if self.fine else None

    def latest(self):
        if self.fine:
            return self.fine[-1]
        return self.coarse[-1] if self.coarse else None


class MetricsHistory:
    """Bounded history of every sensor in one registry.

    `sample_once(now)` snapshots all sensors (tests drive it with a
    synthetic timeline; daemons run a TelemetrySampler thread).  Memory
    is bounded by construction: one _SeriesRing of fixed-size deques per
    live sensor, no per-event storage."""

    def __init__(self, registry: Optional[ProfilerRegistry] = None,
                 fine_capacity: int = 360, coarse_every: int = 30,
                 coarse_capacity: int = 288,
                 sample_period: float = 10.0):
        self.registry = registry or _global_registry
        self.fine_capacity = fine_capacity
        self.coarse_every = max(coarse_every, 1)
        self.coarse_capacity = coarse_capacity
        self.sample_period = sample_period
        # guards: _series, samples_taken
        self._lock = sanitizers.register_lock(
            "profiling.MetricsHistory._lock")
        self._series: dict[tuple, _SeriesRing] = {}
        self.samples_taken = 0

    @classmethod
    def from_config(cls, cfg,
                    registry: Optional[ProfilerRegistry] = None
                    ) -> "MetricsHistory":
        return cls(registry=registry, fine_capacity=cfg.fine_capacity,
                   coarse_every=cfg.coarse_every,
                   coarse_capacity=cfg.coarse_capacity,
                   sample_period=cfg.sample_period)

    def sample_once(self, now: Optional[float] = None) -> float:
        now = time.time() if now is None else now
        with self.registry._lock:
            items = list(self.registry._sensors.items())
        with self._lock:
            self.samples_taken += 1
            fold = self.samples_taken % self.coarse_every == 0
            for key, sensor in items:
                ring = self._series.get(key)
                if ring is None:
                    ring = self._series[key] = _SeriesRing(
                        getattr(sensor, "kind", "gauge"),
                        getattr(sensor, "bounds", None),
                        self.fine_capacity, self.coarse_capacity)
                point = (now, sensor.history_sample())
                ring.fine.append(point)
                if fold:
                    ring.coarse.append(point)
        return now

    # -- queries ---------------------------------------------------------------

    def _matching(self, name: Optional[str], tags: Optional[dict]):
        with self._lock:
            items = list(self._series.items())
        for (sname, stags), ring in items:
            if name is not None and sname != name:
                continue
            if tags:
                stag_dict = dict(stags)
                if any(stag_dict.get(k) != v for k, v in tags.items()):
                    continue
            yield (sname, stags), ring

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted({name for name, _tags in self._series})

    def query(self, name: Optional[str] = None,
              tags: Optional[dict] = None,
              since: Optional[float] = None,
              tier: str = "fine") -> list[dict]:
        """Matching series as JSON-shaped dicts (the /metrics/history
        payload).  `tags` is a subset filter; `since` drops points at or
        before that timestamp; `tier` picks fine or coarse."""
        out = []
        for (sname, stags), ring in self._matching(name, tags):
            points = ring.points(tier)
            if since is not None:
                points = [p for p in points if p[0] > since]
            out.append({
                "name": sname, "tags": dict(stags), "kind": ring.kind,
                "tier": tier,
                "points": [[ts, value] for ts, value in points],
            })
        out.sort(key=lambda s: (s["name"], sorted(s["tags"].items())))
        return out

    def window_delta(self, name: str, tags: Optional[dict] = None,
                     window: float = 300.0,
                     now: Optional[float] = None):
        """Cumulative-series change over the trailing window, summed
        across matching series: counters return a float; summaries
        (d_count, d_sum); histograms (d_count, d_sum, [d_buckets],
        bounds).  None when no matching series holds two points yet.
        Gauges return the latest value (deltas are meaningless)."""
        total = None
        for _key, ring in self._matching(name, tags):
            latest = ring.latest()
            if latest is None:
                continue
            t_latest = latest[0]
            horizon = (now if now is not None else t_latest) - window
            base = ring.at_or_before(horizon)
            if base is None or base[0] >= t_latest:
                continue
            if ring.kind == "gauge":
                delta = latest[1]
            elif ring.kind == "counter":
                delta = latest[1] - base[1]
            elif ring.kind == "summary":
                delta = (latest[1][0] - base[1][0],
                         latest[1][1] - base[1][1])
            else:                                   # histogram
                delta = (latest[1][0] - base[1][0],
                         latest[1][1] - base[1][1],
                         [a - b for a, b in zip(latest[1][2],
                                                base[1][2])],
                         ring.bounds)
            total = delta if total is None else _merge_delta(total, delta)
        return total

    def dump(self) -> dict:
        """Orchid /telemetry/history producer: every series keyed the
        same way registry.collect keys sensors."""
        series = {}
        for (sname, stags), ring in self._matching(None, None):
            series[sname + _format_tags(dict(stags))] = {
                "kind": ring.kind,
                "fine": [[ts, value] for ts, value in ring.points("fine")],
                "coarse": [[ts, value]
                           for ts, value in ring.points("coarse")],
            }
        return {"samples_taken": self.samples_taken,
                "sample_period": self.sample_period,
                "series": series}


def _merge_delta(a, b):
    if isinstance(a, tuple) and isinstance(b, tuple):
        if len(a) >= 3:            # histogram: merge buckets elementwise
            return (a[0] + b[0], a[1] + b[1],
                    [x + y for x, y in zip(a[2], b[2])], a[3])
        return tuple(x + y for x, y in zip(a, b))
    return a + b


class TelemetrySampler:
    """The sampler thread: snapshots the registry into a MetricsHistory
    at a fixed cadence, then runs the follow-up hooks (SLO evaluation)."""

    def __init__(self, history: MetricsHistory,
                 period: Optional[float] = None, hooks=()):
        self.history = history
        self.period = history.sample_period if period is None else period
        self.hooks = list(hooks)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TelemetrySampler":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="telemetry-sampler")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self.tick()

    def tick(self) -> None:
        now = self.history.sample_once()
        for hook in self.hooks:
            try:
                hook(now)
            except Exception:   # noqa: BLE001 — one bad SLO config must
                # not kill the sampling cadence for every other series.
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


_global_history: Optional[MetricsHistory] = None
_global_sampler: Optional[TelemetrySampler] = None
# guards: _global_history, _global_sampler
_history_lock = sanitizers.register_lock("profiling._history_lock",
                                         hot=False)


def get_history() -> MetricsHistory:
    """The process-wide history rings (lazily built from
    config.telemetry_config)."""
    global _global_history
    if _global_history is None:
        with _history_lock:
            if _global_history is None:
                from ytsaurus_tpu_torch.config import telemetry_config
                _global_history = MetricsHistory.from_config(
                    telemetry_config())
    return _global_history


def configure_telemetry(cfg) -> None:
    """Rebuild the global history to a new config's ring shape (called
    by config.set_telemetry_config; None restores lazy defaults).  A
    RUNNING sampler is restarted against the new rings + SLO tracker —
    otherwise a live daemon's reconfigure would leave the old thread
    sampling orphaned rings forever (set_telemetry_config rebinds the
    SLO tracker BEFORE calling here, so the restart hooks the new one)."""
    global _global_history, _global_sampler
    with _history_lock:
        _global_history = None if cfg is None \
            else MetricsHistory.from_config(cfg)
        sampler = _global_sampler
        _global_sampler = None
    if sampler is not None:
        sampler.stop()
        start_telemetry(cfg)


def start_telemetry(config=None) -> Optional[TelemetrySampler]:
    """Start (once) the process-wide sampler + SLO evaluation — the
    daemon entry point's one-call telemetry bring-up.  Returns the
    sampler, or None when sampling is disabled."""
    global _global_sampler
    if config is None:
        from ytsaurus_tpu_torch.config import telemetry_config
        config = telemetry_config()
    if not config.enabled or config.sample_period <= 0:
        return None
    with _history_lock:
        if _global_sampler is not None:
            return _global_sampler
    from ytsaurus_tpu_torch.utils.slo import get_slo_tracker
    tracker = get_slo_tracker()
    sampler = TelemetrySampler(get_history(), config.sample_period,
                               hooks=[tracker.evaluate])
    with _history_lock:
        if _global_sampler is None:
            _global_sampler = sampler.start()
    return _global_sampler


class Profiler:
    """A (prefix, tags) view: `Profiler('/query', {'pool': 'prod'})`.

    Ref TProfiler semantics: `.with_tags()` refines, sensor getters
    create-or-fetch.
    """

    def __init__(self, prefix: str = "", tags: Optional[dict] = None,
                 registry: Optional[ProfilerRegistry] = None):
        self.prefix = prefix
        self.tags = dict(tags or {})
        self.registry = registry or _global_registry

    def with_prefix(self, prefix: str) -> "Profiler":
        return Profiler(self.prefix + prefix, self.tags, self.registry)

    def with_tags(self, **tags) -> "Profiler":
        return Profiler(self.prefix, {**self.tags, **tags}, self.registry)

    def _name(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    def counter(self, name: str) -> Counter:
        return self.registry._get(self._name(name), self.tags, Counter)

    def gauge(self, name: str) -> Gauge:
        return self.registry._get(self._name(name), self.tags, Gauge)

    def summary(self, name: str) -> Summary:
        return self.registry._get(self._name(name), self.tags, Summary)

    def histogram(self, name: str, bounds=None) -> Histogram:
        return self.registry._get(self._name(name), self.tags,
                                  lambda: Histogram(bounds))

    def timer(self, name: str) -> Timer:
        return Timer(self.summary(name))


class PoolSensorCache:
    """Memoized per-pool counter sets: `counters(pool)` returns
    {name: Counter} tagged `pool=` (the untagged parent sensors when
    pool is None/empty).  The one shared shape behind the evaluator's
    compile-cache counters, the tablet's lookup counters, and the
    accountant's usage mirrors — hot paths pay a dict probe, not a
    registry lock, after the first use of a pool.

    `tools/check_sensor_catalog.py` resolves these constructors
    statically: keep `prefix` (and `names`, where the set is fixed) as
    literals at the construction site."""

    __slots__ = ("_profiler", "names", "_cache")

    def __init__(self, prefix: str, names,
                 registry: Optional[ProfilerRegistry] = None):
        self._profiler = Profiler(prefix, registry=registry)
        self.names = tuple(names)
        self._cache: dict = {}

    def counters(self, pool) -> dict:
        entry = self._cache.get(pool)
        if entry is None:
            prof = self._profiler.with_tags(pool=pool) if pool \
                else self._profiler
            entry = self._cache[pool] = {name: prof.counter(name)
                                         for name in self.names}
        return entry
