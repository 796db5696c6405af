"""Q18's plain reference and comparison: quantity sums and line counts
per order (whole numbers, exact in float32 and float64 alike), the orders
above QUANTITY, the top 100 by (sum descending, l_orderkey)."""

import numpy as np

from ytbench.arith import rel_err, segment_sum

LIMIT = 100


def answers(tables: dict, substitutions: list, dtype) -> list:
    li, od = tables["lineitem"], tables["orders"]
    n_orders = len(od["o_orderkey"])
    index = li["l_order_index"]
    sums = segment_sum(index, li["l_quantity"], n_orders, dtype)
    count = np.bincount(index, minlength=n_orders)
    out = []
    for values in substitutions:
        hit = np.flatnonzero((count > 0) & (sums > values["QUANTITY"]))
        top = hit[np.lexsort((od["o_orderkey"][hit], -sums[hit]))[:LIMIT]]
        out.append([(int(od["o_orderkey"][i]), float(sums[i]), int(count[i]))
                    for i in top])
    return out


def as_rows(answer: list) -> list:
    """The answer as the program's rows."""
    return [{"l_orderkey": k, "sum_qty": s, "n_lines": n}
            for k, s, n in answer]


def compare(rows: list, answer: list) -> tuple:
    """(1 if the orders, their order or a line count differ, else 0; the
    largest relative error of a quantity sum)."""
    got = [(r["l_orderkey"], r["n_lines"]) for r in rows]
    wrong = int(got != [(k, n) for k, _, n in answer])
    err = max((rel_err(r["sum_qty"], s) for r, (_, s, _) in
               zip(rows, answer)), default=0.0)
    return wrong, err
