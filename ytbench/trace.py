"""The device trace of a measured window, and what it reduces to.

The arithmetic is chip_smoke.py's `_profile`, copied: torch.profiler over
the CPU and the card, busy time as the union of the device events'
spans, and the idle share as 1 - busy / window. The profiler drops
device events that its clock places outside the session, and the host's
and the device's clocks part by 100-200 ms in a long session, so a pad
kernel (`torch.cuda._sleep`) opens the session and one closes it; a
short marker kernel, run alone just before the window, marks where the
window starts on the device's own clock, and the closing pad where it
ends. The host ranges that name an idle gap are read at the gap's
middle, moved onto the host's clock by the closing pad's lag behind its
launch.
"""

from __future__ import annotations

import heapq
from contextlib import nullcontext

MARK_KERNEL = "spin_kernel"      # torch.cuda._sleep's kernel
MARK_CYCLES = 1_000
PAD_MS = 20.0
CLOSING_PAD_MS = 250.0
PAD_CYCLES_PER_MS = 1_980_000    # the H100 SXM's top SM clock: a pad lasts
                                 # at least its ms at any clock
# Host ranges that name an idle gap: the benchmark's own around each call,
# and the program's join, MVCC and mesh ranges.
RANGE_PREFIXES = ("ytbench.", "join.", "mvcc.", "mesh.")
CLOSE_RANGE = "ytbench_trace.close"     # around the closing pad's launch
WINDOW_CLOSE = "ytbench_trace.window_close"  # where the window closes
TOP = 10
NAME_CHARS = 160                 # a kernel's name as the breakdown keeps it


def host_range(name: str, enabled: bool):
    """A profiler range on the host, or nothing where the run is untraced."""
    if not enabled:
        return nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def _busy(spans: list) -> tuple:
    """(microseconds covered by the union of the spans, the union's
    intervals in order)."""
    busy, merged = 0.0, []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                busy += end - merged[-1][1]
                merged[-1][1] = end
        else:
            busy += end - start
            merged.append([start, end])
    return busy, merged


class DeviceTrace:
    """`with DeviceTrace(): <window>`, then `summary()`."""

    def __enter__(self):
        import torch
        from torch.autograd import profiler
        try:
            config = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except TypeError:            # a torch without it: the main thread's
            config = None            # ranges only
        torch.cuda.synchronize()
        # The autograd profiler's session without its __exit__, which
        # builds a Python event for every op of the window (a minute for
        # 30 s of three streams); the raw trace is all `summary` reads.
        self._prof = profiler.profile(use_device="cuda", use_kineto=True,
                                      experimental_config=config)
        self._prof._prepare_trace()
        self._prof._start_trace()
        torch.cuda._sleep(int(PAD_MS * PAD_CYCLES_PER_MS))
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        return self

    def mark_close(self) -> None:
        """The window closes here: the trace is cut at this point on the
        host's clock, moved onto the device's by the measured lag."""
        from torch.profiler import record_function
        with record_function(WINDOW_CLOSE):
            pass

    def __exit__(self, *exc):
        import torch
        from torch.autograd import profiler
        from torch.profiler import record_function
        torch.cuda.synchronize()
        with record_function(CLOSE_RANGE):
            torch.cuda._sleep(int(CLOSING_PAD_MS * PAD_CYCLES_PER_MS))
        torch.cuda.synchronize()
        self._results = profiler._disable_profiler()
        return False

    def _rows(self) -> list:
        """(name, on the device?, user annotation?, start us, end us) of
        every event of the raw trace."""
        from torch.autograd import DeviceType
        rows = []
        for e in self._results.events():
            if getattr(e, "is_hidden_event", lambda: False)():
                continue
            rows.append((e.name(), e.device_type() == DeviceType.CUDA,
                         getattr(e, "is_user_annotation", lambda: False)(),
                         e.start_ns() / 1e3, e.end_ns() / 1e3))
        return rows

    def summary(self, named: tuple = ()) -> dict:
        """busy_s, window_s, device_ops and idle_gaps of the window, and
        named_ops: for each of `named`, the window's kernels whose name
        holds it, as [count, device seconds]."""
        rows = self._rows()
        spins = [(t0, t1) for name, dev, _, t0, t1 in rows
                 if dev and MARK_KERNEL in name]
        short = [(t0, t1) for t0, t1 in spins if t1 - t0 < PAD_MS * 500]
        long_ = [(t0, t1) for t0, t1 in spins if t1 - t0 >= PAD_MS * 500]
        kernels = [(name, t0, t1) for name, dev, annotation, t0, t1 in rows
                   if dev and not annotation and MARK_KERNEL not in name]
        start = max(t1 for _, t1 in short) if short else \
            min((t0 for _, t0, _ in kernels), default=0.0)
        closing = [t0 for t0, _ in long_ if t0 > start]
        end = min(closing) if closing else \
            max((t1 for _, _, t1 in kernels), default=start)
        # The closing pad's device start less its launch's host time: how
        # far the device's clock lags the host's.
        close = [t0 for name, dev, _, t0, _t1 in rows
                 if not dev and name == CLOSE_RANGE]
        launch = min((t0 for name, dev, _, t0, _t1 in rows if not dev and
                      name.startswith("cudaLaunch") and close and
                      t0 >= close[0]), default=None)
        lag = min(closing) - launch if closing and launch else 0.0
        window_close = [t0 for name, dev, _, t0, _t1 in rows
                        if not dev and name == WINDOW_CLOSE]
        if window_close:
            end = min(end, window_close[0] + lag)
        kernels = [(name, t0, min(t1, end)) for name, t0, t1 in kernels
                   if t0 >= start and t0 < end]
        busy_us, merged = _busy([(t0, t1) for _, t0, t1 in kernels])
        by_name: dict = {}
        named_ops = {key: [0, 0.0] for key in named}
        for name, t0, t1 in kernels:
            by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
            for key in named:
                if key in name:
                    named_ops[key][0] += 1
                    named_ops[key][1] += (t1 - t0) / 1e6
        ranges = sorted((t0, t1, name) for name, dev, _, t0, t1 in rows
                        if not dev and name.startswith(RANGE_PREFIXES))
        edges = [start] + [x for iv in merged for x in iv] + [end]
        gaps = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2])
                if g1 > g0]
        return {
            "busy_s": busy_us / 1e6,
            "window_s": (end - start) / 1e6,
            "device_ops": sorted(((name[:NAME_CHARS], s) for name, s in
                                  by_name.items()), key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": _name_gaps(gaps, ranges, lag),
            "named_ops": named_ops,
            "clock_lag_us": lag,
            "marker": bool(short),
            "closing_pad": bool(closing),
        }


def _name_gaps(gaps: list, ranges: list, lag: float) -> list:
    """Idle seconds by the host range open at each gap's middle (on the
    host's clock): the innermost of the program's ranges, else the
    latest-opened of the benchmark's. One sweep over both, in time order."""
    totals: dict = {}
    active: list = []                 # heap of (end, start, name)
    i = 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) / 2 - lag
        while i < len(ranges) and ranges[i][0] <= mid:
            heapq.heappush(active, (ranges[i][1], ranges[i][0], ranges[i][2]))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        program = [(t0, name) for _, t0, name in active
                   if not name.startswith("ytbench.")]
        open_ = program or [(t0, name) for _, t0, name in active]
        name = max(open_)[1] if open_ else "no range open"
        totals[name] = totals.get(name, 0.0) + (g1 - g0) / 1e6
    return sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
