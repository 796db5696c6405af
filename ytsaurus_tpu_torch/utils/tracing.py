"""Distributed trace contexts with sampling, baggage, and a flight
recorder.

Own copy of the JAX package's `utils/tracing.py` (ref
core/tracing/trace_context.h:75): a `contextvars`-based ambient context,
finished sampled spans in a bounded ring with a drain cursor, and the
reference's wire encoding (`to_wire` / `from_wire`): a plain dict that the
RPC envelope carries.

Span-site discipline (what keeps an untraced hot path ~free):

  start_span(name)        child of the ambient context, or a SAMPLED
                          fresh root (rate from config.TracingConfig).
  child_span(name)        INTERIOR site: child of the ambient context,
                          NULL when there is none (or it is unsampled):
                          one contextvar read + a singleton return.
  start_query_span(name)  ENTRY point (gateway select/lookup, scheduler
                          operation): continues the ambient trace when
                          one exists, else roots a new trace subject to
                          `enabled` + `sample_rate`; `force=True`
                          (explain_analyze) always samples.
  stage(stats, field, name)
                          a STAGE of a query: its self time always adds
                          to a QueryStatistics field, sampled or not;
                          a child span under a sampled trace; and a
                          torch.profiler range of the same name while a
                          profiler session is live, so that the device
                          trace shows which stage the host was in.

`span_tree(trace_id)` nests one trace's spans, `trace_summaries()` lists
the retained traces.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import random
import time
from typing import Any, Optional

from torch.autograd import profiler as _autograd_profiler

from ytsaurus_tpu_torch.utils import sanitizers

# Id generation: a per-process random prefix + an atomic counter (the
# `itertools.count` step is GIL-atomic).  uuid4 costs ~16µs per call in
# entropy-starved containers — two per span would dwarf every other cost
# on the sampled path; ids only need uniqueness, not unpredictability.
_ID_PREFIX = int.from_bytes(os.urandom(8), "big")
_ID_COUNTER = itertools.count(int.from_bytes(os.urandom(6), "big"))
_ID_MASK = (1 << 64) - 1


def _new_trace_id() -> str:
    return f"{_ID_PREFIX:016x}{next(_ID_COUNTER) & _ID_MASK:016x}"


def _new_span_id() -> str:
    # Mixed with the process prefix so two processes sharing one trace
    # cannot collide span ids at similar counter values.
    return f"{(_ID_PREFIX ^ (next(_ID_COUNTER) * 0x9E3779B97F4A7C15)) & _ID_MASK:016x}"

_current: contextvars.ContextVar[Optional["TraceContext"]] = \
    contextvars.ContextVar("trace_context", default=None)

# Fast-path mirrors of config.TracingConfig (one module-global read per
# span site, same discipline as utils/failpoints._STATE).
_ENABLED = True
_SAMPLE_RATE = 1.0


def configure(config) -> None:
    """Apply a config.TracingConfig process-wide (None → defaults)."""
    global _ENABLED, _SAMPLE_RATE
    if config is None:
        _ENABLED, _SAMPLE_RATE = True, 1.0
        _collector.set_capacity(4096)
        return
    _ENABLED = bool(config.enabled)
    _SAMPLE_RATE = float(config.sample_rate)
    _collector.set_capacity(int(config.ring_capacity))


def tracing_enabled() -> bool:
    return _ENABLED


class SpanRecord:
    """One finished span (exporter unit)."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "name", "start",
                 "duration", "tags", "baggage", "seq")

    def __init__(self, ctx: "TraceContext", duration: float):
        self.trace_id = ctx.trace_id
        self.span_id = ctx.span_id
        self.parent_span_id = ctx.parent_span_id
        self.name = ctx.name
        self.start = ctx.start_time
        self.duration = duration
        self.tags = dict(ctx.tags)
        self.baggage = dict(ctx.baggage)
        self.seq = 0                    # stamped by the collector

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__ if k != "seq"}


class SpanCollector:
    """Bounded ring of finished sampled spans with a drain cursor.

    `drain()` hands each span to the exporter exactly once; the ring
    RETAINS everything up to `capacity` so `/traces` and `find()` keep
    serving after an export cycle (the pre-flight-recorder destructive
    drain made a daemon's trace views go empty between scrapes)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        # guards: _spans, _seq, _drained, _hists, capacity
        self._lock = sanitizers.register_lock(
            "tracing.SpanCollector._lock")
        self._spans: list[SpanRecord] = []
        self._seq = 0                  # spans ever added
        self._drained = 0              # seq consumed by drain()
        self._hists: dict[str, Any] = {}

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self.capacity = max(int(capacity), 1)
            if len(self._spans) > self.capacity:
                del self._spans[:len(self._spans) - self.capacity]

    def add(self, span: SpanRecord) -> None:
        with self._lock:
            self._seq += 1
            span.seq = self._seq
            self._spans.append(span)
            if len(self._spans) > self.capacity:
                del self._spans[:len(self._spans) - self.capacity]
        self._record_duration(span)

    def _record_duration(self, span: SpanRecord) -> None:
        # Span-duration histograms on /metrics (tracing_span_seconds
        # {name=...}); per-name sensor cached — the registry lookup is
        # a lock + dict probe we don't want per span.
        hist = self._hists.get(span.name)
        if hist is None:
            from ytsaurus_tpu_torch.utils.profiling import Profiler
            hist = Profiler("/tracing").with_tags(
                name=span.name).histogram(
                    "span_seconds",
                    bounds=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05,
                            0.1, 0.5, 1.0, 5.0, 30.0))
            # Install under the lock (the lock pass flagged the bare
            # dict write): setdefault keeps the winner if two threads
            # race the first span of a name — the registry already
            # dedups the sensor, so both hists ARE the same object.
            with self._lock:
                hist = self._hists.setdefault(span.name, hist)
        hist.record(span.duration)

    def drain(self) -> list[SpanRecord]:
        """Spans added since the previous drain (cursor advance)."""
        with self._lock:
            fresh = [s for s in self._spans if s.seq > self._drained]
            self._drained = self._seq
            return fresh

    def snapshot(self) -> list[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def find(self, trace_id: str) -> list[SpanRecord]:
        return [s for s in self.snapshot() if s.trace_id == trace_id]


_collector = SpanCollector()


def get_collector() -> SpanCollector:
    return _collector


class TraceContext:
    """One span; use as a context manager to time + activate it."""

    def __init__(self, name: str, *, trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None, sampled: bool = True,
                 baggage: Optional[dict] = None):
        self.name = name
        self.trace_id = trace_id or _new_trace_id()
        self.span_id = _new_span_id()
        self.parent_span_id = parent_span_id
        self.sampled = sampled
        self.baggage: dict[str, Any] = dict(baggage or {})
        self.tags: dict[str, Any] = {}
        self.start_time = 0.0
        self._token = None

    # -- structure -------------------------------------------------------------

    def create_child(self, name: str) -> "TraceContext":
        return TraceContext(name, trace_id=self.trace_id,
                            parent_span_id=self.span_id,
                            sampled=self.sampled, baggage=self.baggage)

    def add_tag(self, key: str, value: Any) -> None:
        self.tags[key] = value

    def set_baggage(self, key: str, value: Any) -> None:
        self.baggage[key] = value

    # -- activation ------------------------------------------------------------

    def __enter__(self) -> "TraceContext":
        self.start_time = time.time()
        self._t0 = time.perf_counter()
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _current.reset(self._token)
        if self.sampled:
            if exc is not None and "error" not in self.tags:
                self.tags["error"] = repr(exc)[:200]
            _collector.add(SpanRecord(self, time.perf_counter() - self._t0))
        return False

    # -- wire ------------------------------------------------------------------

    def to_wire(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "sampled": self.sampled, "baggage": self.baggage}

    @classmethod
    def from_wire(cls, wire: Optional[dict], name: str) -> "TraceContext":
        if not wire:
            return cls(name)
        def _text(v):
            return v.decode() if isinstance(v, bytes) else v
        wire = {(_text(k)): v for k, v in wire.items()}
        return cls(name, trace_id=_text(wire.get("trace_id")),
                   parent_span_id=_text(wire.get("span_id")),
                   sampled=bool(wire.get("sampled", True)),
                   baggage={_text(k): (_text(v) if isinstance(v, bytes)
                                       else v)
                            for k, v in (wire.get("baggage") or {}).items()})


class _NullSpan:
    """The no-op span: what an untraced (or sampled-out) site gets.
    Activation touches NOTHING — not even the contextvar — so nesting
    under it still sees the real ambient context (or None)."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_span_id = None
    name = "<null>"
    sampled = False
    tags: dict = {}
    baggage: dict = {}

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add_tag(self, key, value) -> None:
        pass

    def set_baggage(self, key, value) -> None:
        pass

    def create_child(self, name) -> "_NullSpan":
        return self

    def to_wire(self) -> None:
        return None


NULL_SPAN = _NullSpan()


def current_trace() -> Optional[TraceContext]:
    return _current.get()


def start_span(name: str, **tags) -> "TraceContext | _NullSpan":
    """Child of the ambient context, or a (sampled) fresh root."""
    parent = _current.get()
    if parent is not None:
        if not parent.sampled:
            return NULL_SPAN
        ctx = parent.create_child(name)
        ctx.tags.update(tags)
        return ctx
    if not _ENABLED or (_SAMPLE_RATE < 1.0 and
                        random.random() >= _SAMPLE_RATE):
        return NULL_SPAN
    ctx = TraceContext(name)
    ctx.tags.update(tags)
    return ctx


def child_span(name: str, **tags) -> "TraceContext | _NullSpan":
    """INTERIOR span site: records only under a live sampled trace.
    The no-trace fast path is one contextvar read + a singleton return."""
    parent = _current.get()
    if parent is None or not parent.sampled:
        return NULL_SPAN
    ctx = parent.create_child(name)
    if tags:
        ctx.tags.update(tags)
    return ctx


def start_query_span(name: str, force: bool = False,
                     trace_id: Optional[str] = None,
                     **tags) -> "TraceContext | _NullSpan":
    """ENTRY-point span: continue the ambient trace when one exists
    (an RPC handler running under the caller's propagated context),
    else root a new trace subject to `enabled` + `sample_rate`.
    `force=True` (explain_analyze, explicit X-YT-Trace-Id) always
    samples; `trace_id` pins the root's trace id."""
    parent = _current.get()
    if parent is not None:
        if not (parent.sampled or force):
            return NULL_SPAN
        ctx = TraceContext(name, trace_id=parent.trace_id,
                           parent_span_id=parent.span_id,
                           sampled=True, baggage=parent.baggage)
        ctx.tags.update(tags)
        return ctx
    if not force and (not _ENABLED or (_SAMPLE_RATE < 1.0 and
                                       random.random() >= _SAMPLE_RATE)):
        return NULL_SPAN
    ctx = TraceContext(name, trace_id=trace_id)
    ctx.tags.update(tags)
    return ctx


# -- flight-recorder views -----------------------------------------------------


def trace_summaries(limit: int = 64) -> list[dict]:
    """Recent traces, newest first: one row per trace id with its root
    span name, start time, total span count, and root duration (the
    monitoring `/traces` listing)."""
    spans = _collector.snapshot()
    by_trace: dict[str, list[SpanRecord]] = {}
    for span in spans:
        by_trace.setdefault(span.trace_id, []).append(span)
    out = []
    for trace_id, group in by_trace.items():
        span_ids = {s.span_id for s in group}
        roots = [s for s in group
                 if s.parent_span_id is None or
                 s.parent_span_id not in span_ids]
        root = max(roots, key=lambda s: s.duration) if roots else group[0]
        out.append({"trace_id": trace_id, "root": root.name,
                    "start": root.start, "duration": root.duration,
                    "spans": len(group),
                    "last_seq": max(s.seq for s in group)})
    out.sort(key=lambda r: r["last_seq"], reverse=True)
    for row in out:
        del row["last_seq"]
    return out[:limit]


def _build_tree(spans: "list[SpanRecord]") -> list[dict]:
    nodes = {s.span_id: {**s.to_dict(), "children": []} for s in spans}
    roots = []
    for span in spans:
        node = nodes[span.span_id]
        parent = nodes.get(span.parent_span_id) \
            if span.parent_span_id else None
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    def _sort(items):
        items.sort(key=lambda n: n["start"])
        for item in items:
            _sort(item["children"])
    _sort(roots)
    return roots


def span_tree(trace_id: str) -> list[dict]:
    """Nested span tree of one trace (children under `children`, sorted
    by start time); [] when the trace is unknown/evicted."""
    spans = _collector.find(trace_id)
    return _build_tree(spans) if spans else []


def all_span_trees() -> dict:
    """{trace_id: span tree} for every trace retained in the ring, built
    in one snapshot pass (the orchid `/tracing/traces` producer)."""
    by_trace: dict[str, list[SpanRecord]] = {}
    for span in _collector.snapshot():
        by_trace.setdefault(span.trace_id, []).append(span)
    return {tid: _build_tree(group) for tid, group in by_trace.items()}


# -- query stages --------------------------------------------------------------


def _profiler_live() -> bool:
    """True while a torch.profiler session records, read from any thread:
    the process-wide flag that the session's start raises (also one
    started without the profiler's context manager). One attribute read,
    so an untraced run opens no range. (torch._C._autograd.
    _profiler_enabled() is per thread: False on the threads of a query
    when the session records every thread.)"""
    return _autograd_profiler._is_profiler_enabled


class stage:
    """`with stage(stats, "parse_time", "query.parse"):` times one stage
    of a query on the query's own thread.

    On exit the stage's SELF time (its seconds less those of the stages
    nested in it with the same `stats`) adds to `stats.<field>`, so each
    second of a query counts in at most one field. `stats=None` times
    nothing; `name=None` opens no span and no range. Under a sampled
    trace the stage is a child span named `name`, carrying `tags`; while
    a profiler session is live it is also a profiler range of that name.
    `__enter__` returns the span (NULL_SPAN when unsampled)."""

    __slots__ = ("_stats", "_field", "_span", "_range", "_t0", "_inner0")

    def __init__(self, stats, field: Optional[str],
                 name: Optional[str] = None, **tags):
        self._stats = stats
        self._field = field
        self._span = NULL_SPAN if name is None else child_span(name, **tags)
        self._range = None
        if name is not None and _profiler_live():
            from torch.profiler import record_function
            self._range = record_function(name)

    def __enter__(self):
        span = self._span.__enter__()
        if self._range is not None:
            self._range.__enter__()
        if self._stats is not None:
            self._inner0 = self._stats.staged_seconds
        self._t0 = time.perf_counter()
        return span

    def __exit__(self, exc_type, exc, tb) -> bool:
        elapsed = time.perf_counter() - self._t0
        stats = self._stats
        if stats is not None:
            inner = stats.staged_seconds - self._inner0
            setattr(stats, self._field,
                    getattr(stats, self._field) + elapsed - inner)
            stats.staged_seconds = self._inner0 + elapsed
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        self._span.__exit__(exc_type, exc, tb)
        return False
