"""Seconds fetching shards per query, in ms: `query.stage` (the source's
and each foreign table's chunks through the chunk cache) and the waits
for lazily staged shards (QueryStatistics.stage_time).

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
    if not stages or not all("stage_time" in s for s in stages):
        return None
    return sum(s["stage_time"] for s in stages) / len(stages) * 1e3
