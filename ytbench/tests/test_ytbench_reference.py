"""The queries' plain references agree with a row-by-row evaluation in
Python, and their float32 form (the control) fails every cell's limits."""

import math
from collections import defaultdict

import numpy as np
import pytest

from ytbench import control, harness, spec, tpch
from ytbench.tests.conftest import TINY


@pytest.fixture(scope="module")
def data():
    p = harness.plan("tpch_sf1.mix", 987654321123, config_overrides=TINY)
    tables = harness.merged_tables(harness.generate(p))
    return p, tables


def _rows(arrays):
    names = list(arrays)
    return [dict(zip(names, values)) for values in
            zip(*(arrays[n].tolist() for n in names))]


def _close(a, b):
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)


def test_q1_row_by_row(data):
    p, tables = data
    flags, statuses = (tpch.VOCABULARIES[c] for c in
                       ("l_returnflag", "l_linestatus"))
    module = p.queries["q1"]["module"]
    want = module.answers(tables, p.substitutions["q1"], np.float64)
    for values, answer in zip(p.substitutions["q1"], want):
        cut = 10561 - values["DELTA"]
        acc = defaultdict(lambda: defaultdict(float))
        for r in _rows(tables["lineitem"]):
            if r["l_shipdate"] > cut:
                continue
            g = acc[(flags[r["l_returnflag"]], statuses[r["l_linestatus"]])]
            disc_price = r["l_extendedprice"] * (1 - r["l_discount"])
            g["sum_qty"] += r["l_quantity"]
            g["sum_base_price"] += r["l_extendedprice"]
            g["sum_disc_price"] += disc_price
            g["sum_charge"] += disc_price * (1 + r["l_tax"])
            g["disc"] += r["l_discount"]
            g["n"] += 1
        assert [(r["l_returnflag"], r["l_linestatus"]) for r in answer] == \
            sorted(acc)
        for row in answer:
            g = acc[(row["l_returnflag"], row["l_linestatus"])]
            assert row["count_order"] == g["n"]
            for name in ("sum_qty", "sum_base_price", "sum_disc_price",
                         "sum_charge"):
                assert _close(row[name], g[name])
            assert _close(row["avg_qty"], g["sum_qty"] / g["n"])
            assert _close(row["avg_price"], g["sum_base_price"] / g["n"])
            assert _close(row["avg_disc"], g["disc"] / g["n"])
        assert module.compare(module.as_rows(answer), answer) == (0, 0.0)


def test_q3_row_by_row(data):
    p, tables = data
    module = p.queries["q3"]["module"]
    segments = tpch.VOCABULARIES["c_mktsegment"]
    segment_of = {c["c_custkey"]: segments[c["c_mktsegment"]]
                  for c in _rows(tables["customer"])}
    orders = {o["o_orderkey"]: o for o in _rows(tables["orders"])}
    want = module.answers(tables, p.substitutions["q3"], np.float64)
    for values, answer in zip(p.substitutions["q3"], want):
        date = values["DATE"]
        revenue = defaultdict(float)
        for r in _rows(tables["lineitem"]):
            o = orders[r["l_orderkey"]]
            if segment_of[o["o_custkey"]] == values["SEGMENT"].encode() and \
                    o["o_orderdate"] < date and r["l_shipdate"] > date:
                revenue[r["l_orderkey"]] += r["l_extendedprice"] * \
                    (1 - r["l_discount"])
        top = sorted(revenue, key=lambda k: (-revenue[k],
                                             orders[k]["o_orderdate"], k))[:10]
        rows = module.as_rows(answer)
        assert [r["l_orderkey"] for r in rows] == top
        for r in rows:
            assert _close(r["revenue"], revenue[r["l_orderkey"]])
            assert r["o_orderdate"] == orders[r["l_orderkey"]]["o_orderdate"]
            assert r["o_shippriority"] == 0
        wrong, err = module.compare(rows, answer)
        assert wrong == 0 and err == 0.0


def test_q18_row_by_row(data):
    p, tables = data
    module = p.queries["q18"]["module"]
    sums, counts = defaultdict(float), defaultdict(int)
    for r in _rows(tables["lineitem"]):
        sums[r["l_orderkey"]] += r["l_quantity"]
        counts[r["l_orderkey"]] += 1
    # a threshold low enough that the tiny tables have orders above it
    subs = p.substitutions["q18"] + [{"QUANTITY": 250}]
    for values, answer in zip(subs, module.answers(tables, subs, np.float64)):
        hit = sorted((k for k in sums if sums[k] > values["QUANTITY"]),
                     key=lambda k: (-sums[k], k))[:100]
        assert module.as_rows(answer) == [
            {"l_orderkey": k, "sum_qty": sums[k], "n_lines": counts[k]}
            for k in hit]
    assert len(hit) > 0


def test_comparisons_catch_altered_rows(data):
    p, tables = data
    for name, q in p.queries.items():
        module = q["module"]
        answer = module.answers(tables, p.substitutions[name][:1],
                                np.float64)[0]
        if name == "q18":
            answer = module.answers(tables, [{"QUANTITY": 250}],
                                    np.float64)[0]
        rows = module.as_rows(answer)
        value = next(k for k, v in rows[0].items() if isinstance(v, float))
        nudged = [dict(r) for r in rows]
        nudged[0][value] *= 1 + 1e-6
        assert module.compare(nudged, answer)[1] >= 1e-7
        assert module.compare(rows[1:], answer)[0] == 1


@pytest.mark.parametrize("cell", ["tpch_sf10.q1", "tpch_sf1.mix",
                                  "tpch_sf10.q3_q18"])
def test_the_control_fails_the_limits(cell):
    """The reference in float32 in the program's place, at a tiny size:
    the cell's limits refuse it."""
    p = harness.plan(cell, 4242424242, config_overrides=TINY)
    limits = spec.cell(cell)["limits"]
    compared = harness.checks(control.readings(p, harness.generate(p)),
                              limits)
    assert not all(harness.passes(c) for c in compared.values()), compared
