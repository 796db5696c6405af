"""Seconds the query's thread blocked on the device per query, in ms: the
row-count reads, `evaluator.device_wait` (QueryStatistics.device_wait).

The window's queries are the last `attempted` select records of the
program's workload log (`ytsaurus_tpu_torch.query.workload`): after the
window closes no other `select_rows` runs in the process. None where the
log holds fewer (sampled or disabled) or its records carry no stage
split; the mean over the queries whose outcome is ok."""


def read(run):
    from ytsaurus_tpu_torch.query.workload import get_workload_log
    selects = [r for r in get_workload_log().records() if r.kind == "select"]
    if run.attempted <= 0 or len(selects) < run.attempted:
        return None
    stages = [getattr(r, "stages", None) or {}
              for r in selects[-run.attempted:] if r.outcome == "ok"]
    if not stages or not all("device_wait" in s for s in stages):
        return None
    return sum(s["device_wait"] for s in stages) / len(stages) * 1e3
