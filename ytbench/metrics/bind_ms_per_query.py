"""Sum of QueryStatistics.compile_time (host seconds in
`lowering.prepare`, counted per shard) over the queries sent in the
window (a traced run's window: its first 15 s), per query."""


def read(run):
    done = [a for a in run.sent() if a.error is None]
    if not done:
        return None
    return sum(a.compile_s for a in done) / len(done) * 1e3
