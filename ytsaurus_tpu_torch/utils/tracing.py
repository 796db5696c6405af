"""Trace spans with an ambient context and a bounded collector.

Own copy of the JAX package's `utils/tracing.py` as far as the
coordinator, the degradation ladder and the mesh telemetry call it:

  start_span(name)   child of the ambient span, or a fresh sampled root
  child_span(name)   interior site: child of the ambient span, NULL_SPAN
                     when there is none (one contextvar read)
  current_trace()    the ambient span, or None

A span is a context manager; on exit a sampled span goes to the collector
(`get_collector().find(trace_id)`), tagged `error` when it ends by an
exception. The reference's wire encoding, sampling configuration, query
entry spans, span histograms and flight-recorder views are not ported.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import time
from typing import Any, Optional

from ytsaurus_tpu_torch.utils import sanitizers

_ID_PREFIX = int.from_bytes(os.urandom(8), "big")
_ID_COUNTER = itertools.count(int.from_bytes(os.urandom(6), "big"))
_ID_MASK = (1 << 64) - 1


def _new_trace_id() -> str:
    return f"{_ID_PREFIX:016x}{next(_ID_COUNTER) & _ID_MASK:016x}"


def _new_span_id() -> str:
    return f"{(_ID_PREFIX ^ (next(_ID_COUNTER) * 0x9E3779B97F4A7C15)) & _ID_MASK:016x}"


_current: contextvars.ContextVar[Optional["TraceContext"]] = \
    contextvars.ContextVar("trace_context", default=None)


class SpanRecord:
    """One finished span."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "name", "start",
                 "duration", "tags")

    def __init__(self, ctx: "TraceContext", duration: float):
        self.trace_id = ctx.trace_id
        self.span_id = ctx.span_id
        self.parent_span_id = ctx.parent_span_id
        self.name = ctx.name
        self.start = ctx.start_time
        self.duration = duration
        self.tags = dict(ctx.tags)


class SpanCollector:
    """Bounded ring of finished sampled spans."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        # guards: _spans
        self._lock = sanitizers.register_lock("tracing.SpanCollector._lock")
        self._spans: list[SpanRecord] = []

    def add(self, span: SpanRecord) -> None:
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self.capacity:
                del self._spans[:len(self._spans) - self.capacity]

    def snapshot(self) -> list[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def find(self, trace_id: str) -> list[SpanRecord]:
        return [s for s in self.snapshot() if s.trace_id == trace_id]


_collector = SpanCollector()


def get_collector() -> SpanCollector:
    return _collector


class TraceContext:
    """One span; use as a context manager to time and activate it."""

    def __init__(self, name: str, *, trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None, sampled: bool = True):
        self.name = name
        self.trace_id = trace_id or _new_trace_id()
        self.span_id = _new_span_id()
        self.parent_span_id = parent_span_id
        self.sampled = sampled
        self.tags: dict[str, Any] = {}
        self.start_time = 0.0
        self._token = None

    def create_child(self, name: str) -> "TraceContext":
        return TraceContext(name, trace_id=self.trace_id,
                            parent_span_id=self.span_id,
                            sampled=self.sampled)

    def add_tag(self, key: str, value: Any) -> None:
        self.tags[key] = value

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


class _NullSpan:
    """The no-op span of an untraced site. Activation touches nothing, so
    nesting under it still sees the real ambient context (or None)."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_span_id = None
    name = "<null>"
    sampled = False
    tags: dict = {}

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add_tag(self, key, value) -> None:
        pass

    def create_child(self, name) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


def current_trace() -> Optional[TraceContext]:
    return _current.get()


def start_span(name: str, **tags) -> "TraceContext | _NullSpan":
    """Child of the ambient span, or a sampled fresh root."""
    parent = _current.get()
    if parent is not None:
        if not parent.sampled:
            return NULL_SPAN
        ctx = parent.create_child(name)
    else:
        ctx = TraceContext(name)
    ctx.tags.update(tags)
    return ctx


def child_span(name: str, **tags) -> "TraceContext | _NullSpan":
    """Interior span site: records only under a live sampled trace."""
    parent = _current.get()
    if parent is None or not parent.sampled:
        return NULL_SPAN
    ctx = parent.create_child(name)
    if tags:
        ctx.tags.update(tags)
    return ctx
