"""1 - (union of the device events' spans) / the traced window, in %."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return (1 - run.trace["busy_s"] / run.trace["window_s"]) * 100
