"""Seconds copying missed chunks' planes onto the device per query, in
ms: Σ copy_time / ok queries. copy_time is the host's time in the
`chunk.copy` span, from the first plane's copy until the thread's
stream has drained, summed over every thread that staged chunks for the
query. The stream is shared, so the span also holds the copies and
kernels that other threads queued ahead: this is the time the staging
threads spend in the copy, not the time the host link is busy.

The window's queries are the last `attempted` select records of the
program's workload log, as `ytbench/miss_path.py` reads them. None where
the log holds fewer or its records carry no miss-path fields."""

from ytbench.miss_path import window_stages


def read(run):
    stages = window_stages(run, ("copy_time",))
    if stages is None:
        return None
    return sum(s["copy_time"] for s in stages) / len(stages) * 1e3
