"""Q1's plain reference and comparison.

The answer for each DELTA: the rows of the four (l_returnflag,
l_linestatus) groups, in that order. Each sum is taken per (group,
l_shipdate) first, over the few thousand lines of one group's day, then
over the days on or before the cut, as numpy's pairwise sum: in float64
both steps are exact to a few units of the last place. The control sums
in float32 throughout (`arith.segment_sum`).
"""

import numpy as np

from ytbench import tpch
from ytbench.arith import rel_err, segment_sum

_DAYS = 4096          # > the span of l_shipdate
FLOATS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
          "avg_qty", "avg_price", "avg_disc")


def answers(tables: dict, substitutions: list, dtype) -> list:
    li = tables["lineitem"]
    day = li["l_shipdate"] - tpch.STARTDATE
    if day.min() < 0 or day.max() >= _DAYS:
        raise ValueError("l_shipdate lies outside the reference's span")
    groups = len(tpch.VOCABULARIES["l_returnflag"]) * \
        len(tpch.VOCABULARIES["l_linestatus"])
    key = (li["l_returnflag"] * 2 + li["l_linestatus"]) * _DAYS + day
    price = li["l_extendedprice"].astype(dtype)
    disc = li["l_discount"].astype(dtype)
    disc_price = price * (dtype(1) - disc)
    columns = {"qty": li["l_quantity"].astype(dtype), "price": price,
               "disc_price": disc_price,
               "charge": disc_price * (dtype(1) + li["l_tax"].astype(dtype)),
               "disc": disc}
    per_day = {name: segment_sum(key, x, groups * _DAYS, dtype
                                 ).reshape(groups, _DAYS)
               for name, x in columns.items()}
    lines = np.bincount(key, minlength=groups * _DAYS).reshape(groups, _DAYS)
    flags = tpch.VOCABULARIES["l_returnflag"]
    statuses = tpch.VOCABULARIES["l_linestatus"]
    out = []
    for values in substitutions:
        cut = tpch.Q1_BASE_DATE - values["DELTA"] - tpch.STARTDATE + 1
        rows = []
        for g in range(groups):
            n = int(lines[g, :cut].sum())
            if n == 0:
                continue
            s = {name: x[g, :cut].sum(dtype=dtype)
                 for name, x in per_day.items()}
            rows.append({
                "l_returnflag": flags[g // 2], "l_linestatus": statuses[g % 2],
                "sum_qty": float(s["qty"]), "sum_base_price": float(s["price"]),
                "sum_disc_price": float(s["disc_price"]),
                "sum_charge": float(s["charge"]),
                "avg_qty": float(s["qty"] / dtype(n)),
                "avg_price": float(s["price"] / dtype(n)),
                "avg_disc": float(s["disc"] / dtype(n)),
                "count_order": n})
        out.append(rows)
    return out


def as_rows(answer: list) -> list:
    """The answer as the program's rows."""
    return answer


def compare(rows: list, answer: list) -> tuple:
    """(1 if the groups, their order or a count differ, else 0; the
    largest relative error of a sum or an average)."""
    def keys(rs):
        return [(r["l_returnflag"], r["l_linestatus"], r["count_order"])
                for r in rs]
    wrong = int(keys(rows) != keys(answer))
    err = max((rel_err(got[name], want[name]) for got, want in
               zip(rows, answer) for name in FLOATS), default=0.0)
    return wrong, err
