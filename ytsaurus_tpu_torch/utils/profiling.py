"""Sensors: counters and gauges in a process-wide registry.

Own copy of the JAX package's `utils/profiling.py` as far as the mesh
observatory and the tablet read it: `Profiler` (a prefix and tags) with
its `counter` and `gauge`, the registry that keys sensors by (name,
tags), and `PoolSensorCache` (per-pool counter sets). The
reference's summaries, histograms, Prometheus rendering and history rings
are not ported.
"""

from __future__ import annotations

from typing import Optional

from ytsaurus_tpu_torch.utils import sanitizers


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


class Gauge:
    """Last-set value."""

    kind = "gauge"

    def __init__(self):
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def get(self) -> float:
        return self._value


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
        """name{tags} -> value of every sensor."""
        with self._lock:
            items = list(self._sensors.items())
        out = {}
        for (name, tags), sensor in items:
            suffix = "{" + ",".join(f"{k}={v}" for k, v in tags) + "}" \
                if tags else ""
            out[name + suffix] = sensor.get()
        return out


_global_registry = ProfilerRegistry()


def get_registry() -> ProfilerRegistry:
    return _global_registry


class Profiler:
    """A (prefix, tags) view: `Profiler('/query/mesh')`. `with_tags()`
    refines; the sensor getters create or fetch."""

    def __init__(self, prefix: str = "", tags: Optional[dict] = None,
                 registry: Optional[ProfilerRegistry] = None):
        self.prefix = prefix
        self.tags = dict(tags or {})
        self.registry = registry or _global_registry

    def with_tags(self, **tags) -> "Profiler":
        return Profiler(self.prefix, {**self.tags, **tags}, self.registry)

    def _name(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    def counter(self, name: str) -> Counter:
        return self.registry._get(self._name(name), self.tags, Counter)

    def gauge(self, name: str) -> Gauge:
        return self.registry._get(self._name(name), self.tags, Gauge)


class PoolSensorCache:
    """Memoized per-pool counter sets: `counters(pool)` returns
    {name: Counter} tagged `pool=` (the untagged parent sensors when
    pool is None or empty)."""

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
