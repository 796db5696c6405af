"""Continuous sampling CPU profiler + trace export.

Own copy of the JAX package's `utils/profiler.py`. One difference: the
sampler's table keeps its bound. Past `max_entries - 1` distinct stacks
every new stack lands in the one entry `"(other)"`, which the last slot
is kept for, so `distinct_stacks` never exceeds `max_entries` (the
reference lets `"(other)"` become entry `max_entries + 1`). The sampler
walks host frames only: it opens no CUDA context and syncs no device.

Ref mapping:
  continuous profiler  → SamplingProfiler
    (library/ytprof/cpu_profiler.h — the reference samples stacks on a
     timer signal into pprof profiles; here the sampler walks
     sys._current_frames() on a daemon thread, the cross-platform
     Python analog of the SIGPROF stack walker)
  Jaeger trace export  → TraceExporter
    (library/tracing/jaeger/tracer.h:91 — the reference batches
     finished spans and flushes them to a Jaeger agent; here batches
     drain the span collector to a pluggable sink on a flush interval —
     a JSONL file sink stands in for the agent socket)

Both are always-on-capable: sampling costs one frame walk per interval
across all threads (~tens of µs), and the aggregated profile is served
live through Orchid as collapsed stacks (the flamegraph input format),
so an operator can pull a profile from a running daemon without
restarting anything.
"""

from __future__ import annotations

import json
import sys
import threading
from typing import Callable, Optional

from ytsaurus_tpu_torch.utils.tracing import get_collector


class SamplingProfiler:
    """Statistical CPU profiler over sys._current_frames()."""

    def __init__(self, interval: float = 0.01, max_depth: int = 24,
                 max_entries: int = 4096):
        self.interval = interval
        self.max_depth = max_depth
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._samples: "dict[str, int]" = {}     # collapsed stack → hits
        self._total = 0
        self._idle = 0                           # blocked-wait samples
        self._stop = threading.Event()
        self._thread: "Optional[threading.Thread]" = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "SamplingProfiler":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cpu-profiler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.interval):
            self.sample_once(exclude_thread=me)

    # -- sampling --------------------------------------------------------------

    # Leaves parked in these stdlib files are blocking waits, not CPU:
    # a daemon's many idle threads (RPC workers, background loops) would
    # otherwise dominate every profile with Event.wait frames.  The
    # reference's SIGPROF sampler gets this for free (it only fires on
    # CPU time); this is the frame-walker's approximation.
    _WAIT_FILES = ("threading.py", "selectors.py", "socket.py", "ssl.py",
                   "queue.py", "socketserver.py")

    def sample_once(self, exclude_thread: "Optional[int]" = None) -> None:
        frames = sys._current_frames()
        stacks = []
        idle = 0
        for thread_id, frame in frames.items():
            if thread_id == exclude_thread:
                continue
            leaf = frame.f_code
            leaf_file = leaf.co_filename.rsplit("/", 1)[-1]
            if leaf_file in self._WAIT_FILES or leaf.co_name == "sleep":
                idle += 1
                continue
            parts = []
            depth = 0
            while frame is not None and depth < self.max_depth:
                code = frame.f_code
                parts.append(f"{code.co_name} "
                             f"({code.co_filename.rsplit('/', 1)[-1]}:"
                             f"{frame.f_lineno})")
                frame = frame.f_back
                depth += 1
            stacks.append(";".join(reversed(parts)))
        # The last slot is kept for "(other)": the table never holds
        # more than max_entries stacks.
        room = max(self.max_entries - 1, 0)
        with self._lock:
            self._idle += idle
            for stack in stacks:
                if stack in self._samples or len(self._samples) < room:
                    self._samples[stack] = \
                        self._samples.get(stack, 0) + 1
                else:
                    # Past the entry cap every sample still lands
                    # SOMEWHERE, or hotspot shares would dilute over
                    # time (hits/total with silently dropped hits).
                    self._samples["(other)"] = \
                        self._samples.get("(other)", 0) + 1
            self._total += len(stacks)

    # -- reporting -------------------------------------------------------------

    def collapsed(self, top: int = 50) -> "list[str]":
        """Collapsed-stack lines `stack count` — flamegraph.pl input."""
        with self._lock:
            items = sorted(self._samples.items(), key=lambda kv: -kv[1])
        return [f"{stack} {count}" for stack, count in items[:top]]

    def hotspots(self, top: int = 15) -> "list[dict]":
        """Per-FRAME aggregation: where do samples actually land."""
        leaf_hits: "dict[str, int]" = {}
        with self._lock:
            total = max(self._total, 1)
            for stack, count in self._samples.items():
                leaf = stack.rsplit(";", 1)[-1]
                leaf_hits[leaf] = leaf_hits.get(leaf, 0) + count
        out = sorted(leaf_hits.items(), key=lambda kv: -kv[1])[:top]
        return [{"frame": frame, "samples": hits,
                 "share": round(hits / total, 4)}
                for frame, hits in out]

    def state(self) -> dict:
        with self._lock:
            return {"total_samples": self._total,
                    "idle_samples": self._idle,
                    "distinct_stacks": len(self._samples),
                    "interval": self.interval}

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._total = 0
            self._idle = 0


class TraceExporter:
    """Flushes finished spans from the collector to a sink in batches
    (the Jaeger-agent flush loop, ref jaeger/tracer.h:91)."""

    def __init__(self, sink: "Callable[[list[dict]], None]",
                 flush_interval: float = 2.0, collector=None,
                 recent_capacity: int = 64):
        from collections import deque
        self.sink = sink
        self.flush_interval = flush_interval
        self.collector = collector or get_collector()
        self.stats = {"batches": 0, "spans": 0}
        # Draining the shared collector would starve live-inspection
        # endpoints (/tracing/recent_spans): the exporter keeps its own
        # recent tail so those can serve from HERE when export is on.
        self.recent: "deque[dict]" = deque(maxlen=recent_capacity)
        self._flush_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: "Optional[threading.Thread]" = None

    def start(self) -> "TraceExporter":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="trace-exporter")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.flush_once()                   # drain the tail

    def _loop(self) -> None:
        while not self._stop.wait(self.flush_interval):
            try:
                self.flush_once()
            except Exception:   # noqa: BLE001 — export must not crash
                pass

    def flush_once(self) -> int:
        # stop() flushes the tail on the CALLER's thread while the loop
        # may be mid-flush: serialize, or stats/sink writes interleave.
        with self._flush_lock:
            spans = self.collector.drain()
            if not spans:
                return 0
            batch = [s.to_dict() for s in spans]
            self.sink(batch)
            self.recent.extend(batch)
            self.stats["batches"] += 1
            self.stats["spans"] += len(batch)
            return len(batch)


def jsonl_sink(path: str,
               max_bytes: int = 64 << 20) -> "Callable[[list[dict]], None]":
    """File sink: one JSON span per line (the agent-socket stand-in;
    ingestable by anything that reads OTLP/Jaeger-style JSON).  Rotates
    to `<path>.1` past max_bytes — an always-on exporter must not fill
    the daemon's volume."""
    import os
    lock = threading.Lock()

    def sink(batch: "list[dict]") -> None:
        with lock:
            try:
                if os.path.getsize(path) > max_bytes:
                    os.replace(path, path + ".1")
            except OSError:
                pass
            with open(path, "a") as f:
                for span in batch:
                    f.write(json.dumps(span, default=repr) + "\n")
    return sink
