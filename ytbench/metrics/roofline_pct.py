"""The bytes the traced window's queries must read (each query file's
columns at 8 B a value, per table; a query in flight at the close by
the share of its time inside the window), at the card's published HBM
rate (`ytbench/peaks.json`), as a share of the device's busy time in
the window."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent.parent
                    / "peaks.json").read_text())


def read(run):
    peak = PEAKS.get(run.device_kind)
    if run.trace is None or peak is None or run.trace["busy_s"] <= 0:
        return None
    done = sum(run.bytes_read[a.query] for a in run.answers
               if a.error is None)
    partial = sum(run.bytes_read[a.query] * (run.closed - a.sent) /
                  (a.done - a.sent) for a in run.late
                  if a.error is None and a.done > a.sent)
    return (done + partial) / peak["hbm_bytes_per_s"] / \
        run.trace["busy_s"] * 100
