"""The window's select records, as the readers of the chunk cache's miss
path (`metrics/{decode,copy}_ms_per_query.py`) take them.

The window's queries are the last `attempted` select records of the
program's workload log (`ytsaurus_tpu_torch.query.workload`): after the
window closes no other `select_rows` runs in the process."""


def window_stages(run, fields: tuple):
    """The `stages` of the window's queries whose outcome is ok, or None
    where the log holds fewer records than the window sent, none is ok,
    or one lacks any of `fields` (a program without the miss-path
    fields)."""
    from ytsaurus_tpu_torch.query.workload import get_workload_log
    selects = [r for r in get_workload_log().records() if r.kind == "select"]
    if run.attempted <= 0 or len(selects) < run.attempted:
        return None
    stages = [getattr(r, "stages", None) or {}
              for r in selects[-run.attempted:] if r.outcome == "ok"]
    if not stages or not all(f in s for s in stages for f in fields):
        return None
    return stages
