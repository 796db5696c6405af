"""Q3's plain reference and comparison.

For each (SEGMENT, DATE): the orders of the segment's customers dated
before DATE keep their lines shipped after it; revenue sums per order in
`dtype`. The answer keeps every order's revenue, so that a row the
program returns is judged by its own order, and the top 10 by (revenue
descending, o_orderdate, l_orderkey), so that its ranks are judged too:
orders that tie on revenue and date may come in either order.
"""

import numpy as np

from ytbench import tpch
from ytbench.arith import rel_err, segment_sum

LIMIT = 10


def answers(tables: dict, substitutions: list, dtype) -> list:
    li, od, cu = tables["lineitem"], tables["orders"], tables["customer"]
    n_orders = len(od["o_orderkey"])
    line_revenue = (li["l_extendedprice"].astype(dtype)
                    * (dtype(1) - li["l_discount"].astype(dtype)))
    segments = list(tpch.VOCABULARIES["c_mktsegment"])
    out = []
    for values in substitutions:
        date = values["DATE"]
        segment_ok = cu["c_mktsegment"] == segments.index(
            values["SEGMENT"].encode())
        order_ok = segment_ok[od["o_custkey"] - 1] & (od["o_orderdate"] < date)
        line_ok = order_ok[li["l_order_index"]] & (li["l_shipdate"] > date)
        index = li["l_order_index"][line_ok]
        revenue = segment_sum(index, line_revenue[line_ok], n_orders, dtype)
        count = np.bincount(index, minlength=n_orders)
        hit = np.flatnonzero(count)
        top = hit[np.lexsort((od["o_orderkey"][hit], od["o_orderdate"][hit],
                              -revenue[hit]))[:LIMIT]]
        out.append({"revenue": revenue, "count": count,
                    "orderdate": od["o_orderdate"],
                    "shippriority": od["o_shippriority"],
                    "orderkey": od["o_orderkey"], "top": top,
                    "top_revenue": [float(revenue[i]) for i in top]})
    return out


def as_rows(answer: dict) -> list:
    """The answer's top orders as the program's rows."""
    return [{"l_orderkey": int(answer["orderkey"][i]),
             "revenue": float(answer["revenue"][i]),
             "o_orderdate": int(answer["orderdate"][i]),
             "o_shippriority": int(answer["shippriority"][i])}
            for i in answer["top"]]


def compare(rows: list, answer: dict) -> tuple:
    """(1 if the row count differs, or a row is no group of the answer, is
    repeated, or carries another date or priority, else 0; the largest
    relative error of a row's revenue against its own order's and against
    the answer's at that rank)."""
    n_orders = len(answer["count"])
    wrong = int(len(rows) != len(answer["top_revenue"]))
    seen = set()
    err = 0.0
    for rank, row in enumerate(rows):
        key = row["l_orderkey"]
        i = int(tpch.index_of_orderkey(np.int64(key))) if key >= 1 else -1
        if key in seen or (key - 1) % 32 >= 8 or not 0 <= i < n_orders or \
                answer["count"][i] == 0 or \
                row["o_orderdate"] != answer["orderdate"][i] or \
                row["o_shippriority"] != answer["shippriority"][i]:
            wrong = 1
            continue
        seen.add(key)
        err = max(err, rel_err(row["revenue"], answer["revenue"][i]))
        if rank < len(answer["top_revenue"]):
            err = max(err, rel_err(row["revenue"],
                                   answer["top_revenue"][rank]))
    return wrong, err
