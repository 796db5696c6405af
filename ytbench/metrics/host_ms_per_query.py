"""The median, over the queries sent in the window (a traced run's
window: its first 15 s), of the stream's wall time less
the query's `execute_time + compile_time` (QueryStatistics): the time in
the client, the gateway and the coordinator outside the evaluator."""

import numpy as np


def read(run):
    done = [a for a in run.sent() if a.error is None]
    if not done:
        return None
    return float(np.median([(a.done - a.sent - a.execute_s - a.compile_s)
                            * 1e3 for a in done]))
