"""Seconds in `query.parse` per query, in ms: the lexer, parser, builder
and planner (`build_query`), the read permissions, the pruning intervals
and the semi-join pushdown (QueryStatistics.parse_time). The binding
that follows, `lowering.prepare`, is `bind_ms_per_query`'s.

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
    if not stages or not all("parse_time" in s for s in stages):
        return None
    return sum(s["parse_time"] for s in stages) / len(stages) * 1e3
