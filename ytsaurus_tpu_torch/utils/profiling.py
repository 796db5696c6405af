"""Typed sensors on a tag tree + Prometheus-format export.

Own copy of the JAX package's `utils/profiling.py` (ref library/profiling
TProfiler: counters, gauges, summaries and histograms under a tag tree):
one process-wide
`ProfilerRegistry`, a `Profiler` as a (prefix, tags) view onto it,
`Timer`, and `PoolSensorCache` (per-pool counter sets). The reference's
Prometheus rendering, metrics-history rings and their sampler thread are
not ported: no daemon of the port serves them.
"""

from __future__ import annotations

import bisect
import random
import time
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


class Summary:
    """Count/sum/min/max/last of observed values, plus a BOUNDED
    quantile reservoir.

    The reservoir is Vitter's algorithm R: a fixed-size uniform sample
    of every observation so far, so a month-long daemon's sensor memory
    stays O(RESERVOIR_CAPACITY) no matter how many values it records
    (the an unbounded per-sensor value list would
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
