"""The 90th percentile of the latencies of every query sent in the
window, each timed from when its stream sent it to when its answer came
back: those in flight at the close too, which the run waits for."""

import numpy as np


def read(run):
    sent = run.sent()
    if not sent:
        return None
    return float(np.percentile([(a.done - a.sent) * 1e3 for a in sent], 90))
