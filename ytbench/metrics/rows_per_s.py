"""Input rows of every table that the window's queries read, over the
window's seconds. A query in flight at the close counts the share of its
rows that its time inside the window is of its whole time, so the rate
covers all the work of the window and does not jump by a whole query
with the phase of the streams at the close."""


def read(run):
    done = sum(run.rows_read[a.query] for a in run.answers
               if a.error is None)
    partial = sum(run.rows_read[a.query] * (run.closed - a.sent) /
                  (a.done - a.sent) for a in run.late
                  if a.error is None and a.done > a.sent)
    return (done + partial) / run.window_s
