"""The generator keeps TPC-H's rules (spec v3, cl. 4.2.3) at a tiny scale."""

import numpy as np
import pytest

from ytbench import harness, tpch


@pytest.fixture(scope="module")
def tables():
    config = {"scale_factor": 0.004, "tables": {"lineitem": {"chunks": 3}}}
    return tpch.generate(config, harness.seed_sequence(2**31 + 7))


def test_sizes_and_chunks(tables):
    (orders,), (customer,) = tables["orders"], tables["customer"]
    assert len(orders["o_orderkey"]) == 6000
    assert len(customer["c_custkey"]) == 600
    assert len(tables["lineitem"]) == 3
    keys = np.concatenate([p["l_orderkey"] for p in tables["lineitem"]])
    assert np.all(np.diff(keys) >= 0)          # order-key order
    # each chunk holds whole orders
    for a, b in zip(tables["lineitem"], tables["lineitem"][1:]):
        assert a["l_orderkey"][-1] < b["l_orderkey"][0]


def test_orders(tables):
    (orders,) = tables["orders"]
    keys = orders["o_orderkey"]
    assert np.all(np.diff(keys) > 0) and keys[0] == 1
    assert np.all((keys - 1) % 32 < 8)          # sparse keys
    cust = orders["o_custkey"]
    assert cust.min() >= 1 and cust.max() <= 600 and np.all(cust % 3 != 0)
    dates = orders["o_orderdate"]
    assert dates.min() >= tpch.STARTDATE
    assert dates.max() <= tpch.ENDDATE - 151
    assert np.all(orders["o_shippriority"] == 0)


def test_lineitem(tables):
    (orders,) = tables["orders"]
    li = harness.merged_tables({"l": tables["lineitem"]})["l"]
    per_order = np.bincount(li["l_order_index"],
                            minlength=len(orders["o_orderkey"]))
    assert per_order.min() == 1 and per_order.max() == 7
    assert np.array_equal(li["l_orderkey"],
                          orders["o_orderkey"][li["l_order_index"]])
    qty = li["l_quantity"]
    assert set(np.unique(qty)) <= set(range(1, 51)) and qty.max() == 50
    assert np.allclose(li["l_discount"] * 100, np.round(li["l_discount"] * 100))
    assert set(np.round(li["l_discount"] * 100).astype(int)) == set(range(11))
    assert set(np.round(li["l_tax"] * 100).astype(int)) == set(range(9))
    unit_cents = np.round(li["l_extendedprice"] * 100 / qty)
    assert np.allclose(li["l_extendedprice"] * 100, unit_cents * qty)
    assert unit_cents.min() >= 90_000 and unit_cents.max() <= 209_899
    lag = li["l_shipdate"] - orders["o_orderdate"][li["l_order_index"]]
    assert lag.min() == 1 and lag.max() == 121
    flags = tpch.VOCABULARIES["l_returnflag"][li["l_returnflag"]]
    status = tpch.VOCABULARIES["l_linestatus"][li["l_linestatus"]]
    shipped_late = li["l_shipdate"] > tpch.CURRENTDATE
    assert np.all((status == b"O") == shipped_late)
    # receipt is 1-30 days after shipping: N past CURRENTDATE, R or A before
    assert np.all(flags[shipped_late] == b"N")
    early = li["l_shipdate"] + 30 <= tpch.CURRENTDATE
    assert set(flags[early]) == {b"R", b"A"}


def test_customer(tables):
    (customer,) = tables["customer"]
    assert np.array_equal(customer["c_custkey"], np.arange(1, 601))
    assert set(customer["c_mktsegment"]) == set(range(5))


def test_seed_fixes_the_tables():
    config = {"scale_factor": 0.001, "tables": {"lineitem": {"chunks": 2}}}
    a, b, c = (tpch.generate(config, harness.seed_sequence(s))
               for s in (2**33 + 1, 2**33 + 1, -(2**33 + 1)))
    for x, y in zip(a["lineitem"], b["lineitem"]):
        for name in x:
            assert np.array_equal(x[name], y[name])
    assert not np.array_equal(a["lineitem"][0]["l_quantity"][:100],
                              c["lineitem"][0]["l_quantity"][:100])


def test_substitutions_keep_their_ranges():
    p = harness.plan("tpch_sf1.mix", 12345678901)
    assert all(60 <= v["DELTA"] <= 120 for v in p.substitutions["q1"])
    assert all(312 <= v["QUANTITY"] <= 315 for v in p.substitutions["q18"])
    for v in p.substitutions["q3"]:
        assert 9190 <= v["DATE"] <= 9220
        assert v["SEGMENT"] in ("AUTOMOBILE", "BUILDING", "FURNITURE",
                                "HOUSEHOLD", "MACHINERY")
    assert all(len(s) == 4 for s in p.substitutions.values())
    # the streams start at different points of the cycle
    assert p.cycles[0] != p.cycles[1]
    assert sorted(p.cycles[0]) == sorted(p.cycles[1]) == ["q1", "q18", "q3"]
