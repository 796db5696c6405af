"""CPU seconds of the streams' query threads over their seconds off the
device and out of admission, in %: Σ host_cpu_time / Σ (wall_time -
device_wait - admission_wait) over the queries whose outcome is ok
(QueryStatistics; host_cpu_time is `time.thread_time()` over the query,
less the CPU inside the device waits). Under 100 the threads wait, for
the interpreter's lock, a lock of the program's or the launch queue;
near 100 the Python itself is the work.

The window's queries are the last `attempted` select records of the
program's workload log (`ytsaurus_tpu_torch.query.workload`): after the
window closes no other `select_rows` runs in the process. None where the
log holds fewer (sampled or disabled) or its records carry no stage
split."""

FIELDS = ("host_cpu_time", "wall_time", "device_wait", "admission_wait")


def read(run):
    from ytsaurus_tpu_torch.query.workload import get_workload_log
    selects = [r for r in get_workload_log().records() if r.kind == "select"]
    if run.attempted <= 0 or len(selects) < run.attempted:
        return None
    stages = [getattr(r, "stages", None) or {}
              for r in selects[-run.attempted:] if r.outcome == "ok"]
    if not stages or not all(f in s for s in stages for f in FIELDS):
        return None
    off_device = sum(s["wall_time"] - s["device_wait"] - s["admission_wait"]
                     for s in stages)
    if off_device <= 0:
        return None
    return sum(s["host_cpu_time"] for s in stages) / off_device * 100
