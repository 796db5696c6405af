"""Parity of the port's joins (`ytsaurus_tpu_torch`) with the JAX package on
the CPU: the same tables, carried across with `chunk_from_numpy`, go through
the JAX `select_rows` (with YT_TPU_SORT_ENGINE=pallas, so its sorts take the
Pallas counting kernel in interpret mode) and the port's
`select_rows(..., device="cpu")`, whose kernels run as their plain versions.

Row order, integers, strings and group sets must match exactly under the
canon of tests/harness.py; doubles agree to rtol=1e-9. Where a case carries
its expected rows, the port matches those as well.
"""

import numpy as np
import pytest
import torch

from tests.harness import _canon_row
from tests.test_multiway_join import CORPUS as MULTIWAY_CORPUS
from tests.test_multiway_join import DIM, DUP, FACT, SDIM
from tests.test_ql_corpus import JOINS
from tests.test_ql_evaluate import JOIN_TABLES
from tests.test_torch_query import _assert_rows, _to_port
from ytsaurus_tpu.chunks import ColumnarChunk as RefChunk
from ytsaurus_tpu.models import tpch as ref_tpch
from ytsaurus_tpu.query import planner as ref_planner
from ytsaurus_tpu.query.builder import build_query as ref_build_query
from ytsaurus_tpu.query.engine import joins as ref_joins
from ytsaurus_tpu.query.engine.evaluator import select_rows as ref_select
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch.chunks.columnar import chunk_column_stats
from ytsaurus_tpu_torch.models import tpch
from ytsaurus_tpu_torch.query import planner, select_rows
from ytsaurus_tpu_torch.query.builder import build_query
from ytsaurus_tpu_torch.query.engine import joins

# The tier-1 suite runs several workers side by side: torch's default of
# one (spinning) thread per core would crowd out their timing tests.
torch.set_num_threads(1)

T = "//t"


def _ref_chunks(tables: dict) -> dict:
    out = {}
    for path, spec in tables.items():
        if isinstance(spec, RefChunk):
            out[path] = spec
        else:
            cols, rows = spec
            out[path] = RefChunk.from_rows(RefSchema.make(cols), rows)
    return out


def _run_both(query: str, tables: dict, monkeypatch, expected=None,
              ordered: bool = True) -> list:
    """The port's rows, after checking them against the JAX package's (in
    order unless `ordered` is False) and against `expected`."""
    monkeypatch.setenv("YT_TPU_SORT_ENGINE", "pallas")
    chunks = _ref_chunks(tables)
    want = ref_select(query, chunks).to_rows()
    got = select_rows(query, {p: _to_port(c) for p, c in chunks.items()},
                      device="cpu").to_rows()
    _assert_rows(got, want, ordered)
    if expected is not None:
        got_c = [_canon_row(r) for r in got]
        want_c = [_canon_row(r) for r in expected]
        assert sorted(got_c) == sorted(want_c), (query, got, expected)
    return got


# --- tests/test_ql_corpus.py::JOINS, every case ------------------------------


@pytest.mark.parametrize("query,tables,expected", [c[1:] for c in JOINS],
                         ids=[c[0] for c in JOINS])
def test_join_corpus(query, tables, expected, monkeypatch):
    _run_both(query, tables, monkeypatch, expected)


# --- tests/test_ql_evaluate.py's join tests ------------------------------------

_MULTI_KEY_TABLES = {
    T: ([("a", "int64", "ascending"), ("b", "int64"), ("x", "int64")],
        [(1, 2, 10), (2, 1, 20), (1, 1, 30), (2, 2, 40), (3, 0, 50)]),
    "//d": ([("a", "int64", "ascending"), ("b", "int64"), ("y", "int64")],
            [(1, 1, 100), (1, 2, 200), (2, 1, 300), (2, 2, 400),
             (3, 0, 500)]),
}

_DUP_TABLES = {
    T: ([("k", "int64", "ascending"), ("g", "int64")], [(1, 7)]),
    "//d": ([("g", "int64", "ascending"), ("x", "int64")],
            [(7, 1), (7, 2)]),
}

EVALUATE_JOINS = [
    ("inner_join_using", f"k, name FROM [{T}] JOIN [//d] USING g",
     JOIN_TABLES, [{"k": 1, "name": "alpha"}, {"k": 2, "name": "beta"},
                   {"k": 3, "name": "alpha"}]),
    ("left_join_using", f"k, name FROM [{T}] LEFT JOIN [//d] USING g",
     JOIN_TABLES, [{"k": 1, "name": "alpha"}, {"k": 2, "name": "beta"},
                   {"k": 3, "name": "alpha"}, {"k": 4, "name": None}]),
    ("join_on_expressions",
     f"k, d.name AS n FROM [{T}] JOIN [//d] AS d ON g = d.g", JOIN_TABLES,
     [{"k": 1, "n": "alpha"}, {"k": 2, "n": "beta"},
      {"k": 3, "n": "alpha"}]),
    ("join_then_group",
     f"name, count(*) AS c FROM [{T}] JOIN [//d] USING g GROUP BY name",
     JOIN_TABLES, [{"name": "alpha", "c": 2}, {"name": "beta", "c": 1}]),
    ("join_duplicate_foreign_rows", f"k, x FROM [{T}] JOIN [//d] USING g",
     _DUP_TABLES, [{"k": 1, "x": 1}, {"k": 1, "x": 2}]),
    ("multi_key_join", f"x, y FROM [{T}] JOIN [//d] USING a, b",
     _MULTI_KEY_TABLES,
     [{"x": 10, "y": 200}, {"x": 20, "y": 300}, {"x": 30, "y": 100},
      {"x": 40, "y": 400}, {"x": 50, "y": 500}]),
]


@pytest.mark.parametrize("query,tables,expected",
                         [c[1:] for c in EVALUATE_JOINS],
                         ids=[c[0] for c in EVALUATE_JOINS])
def test_evaluate_joins(query, tables, expected, monkeypatch):
    _run_both(query, tables, monkeypatch, expected)


# --- TPC-H Q3 -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_q3(seed, monkeypatch):
    """4096 lines over 1024 orders: every line joins one order, about half
    pass the date filter, and the top 10 orders by revenue come back in
    order, from both packages and from the numpy oracle."""
    lineitem = ref_tpch.generate_lineitem(4096, seed=seed, n_orders=1024)
    orders = ref_tpch.generate_orders(1024, seed=seed)
    tables = {"//tpch/lineitem": lineitem, "//tpch/orders": orders}
    rows = _run_both(tpch.Q3, tables, monkeypatch)
    assert len(rows) == 10
    want = tpch.q3_oracle(tpch.lineitem_arrays(4096, seed, 1024),
                          tpch.orders_arrays(1024, seed))
    assert [r["l_orderkey"] for r in rows] == \
        [r["l_orderkey"] for r in want]
    for got, exp in zip(rows, want):
        assert got["revenue"] == pytest.approx(exp["revenue"], rel=1e-9)


def test_port_orders_generator_matches_the_reference():
    ref_chunk = ref_tpch.generate_orders(3000, seed=4)
    chunk = tpch.orders_chunk(tpch.orders_arrays(3000, seed=4), device="cpu")
    assert chunk.schema == _to_port(ref_chunk).schema
    for name, col in chunk.columns.items():
        np.testing.assert_array_equal(
            col.data.numpy(), np.asarray(ref_chunk.columns[name].data))
        np.testing.assert_array_equal(
            col.valid.numpy(), np.asarray(ref_chunk.columns[name].valid))


# --- LEFT joins and multi-way joins in the planner's order ---------------------


def _fanout_tables() -> dict:
    """A self table and three foreign tables whose keys fan out 3, 2 and 1
    times: the planner runs the most selective join first."""
    rng = np.random.default_rng(7)
    rows = [(i, int(rng.integers(0, 6)), int(rng.integers(0, 5)),
             None if i % 9 == 0 else int(rng.integers(0, 4)))
            for i in range(40)]
    return {
        T: ([("k", "int64", "ascending"), ("a", "int64"), ("b", "int64"),
             ("c", "int64")], rows),
        "//d1": ([("a1", "int64"), ("p1", "int64")],
                 [(a, 10 * a + j) for a in range(5) for j in range(3)]),
        "//d2": ([("b2", "int64"), ("p2", "int64")],
                 [(b, 100 * b + j) for b in range(4) for j in range(2)]),
        "//d3": ([("c3", "int64"), ("p3", "int64")],
                 [(c, 1000 * c) for c in range(3)]),
    }


MULTIWAY = [
    ("inner_three_way_reordered",
     f"k, p1, p2, p3 FROM [{T}] JOIN [//d1] ON a = a1 JOIN [//d2] ON b = b2 "
     "JOIN [//d3] ON c = c3 LIMIT 25", (2, 1, 0)),
    ("inner_two_way_reordered",
     f"k, p1, p2 FROM [{T}] JOIN [//d1] ON a = a1 JOIN [//d2] ON b = b2 "
     "LIMIT 30", (1, 0)),
    ("left_barrier",
     f"k, p1, p2, p3 FROM [{T}] JOIN [//d1] ON a = a1 LEFT JOIN [//d3] "
     "ON c = c3 JOIN [//d2] ON b = b2 LIMIT 40", (0, 1, 2)),
    ("left_then_inner_pair",
     f"k, p1, p2, p3 FROM [{T}] LEFT JOIN [//d3] ON c = c3 JOIN [//d1] "
     "ON a = a1 JOIN [//d2] ON b = b2 LIMIT 40", (0, 2, 1)),
    ("left_join_fanout", f"k, p1 FROM [{T}] LEFT JOIN [//d1] ON a = a1",
     (0,)),
    ("dependent_key",
     f"k, p1, p3 FROM [{T}] JOIN [//d1] ON a = a1 JOIN [//d3] "
     "ON p1 % 3 = c3 LIMIT 30", (0, 1)),
]


@pytest.mark.parametrize("query,order", [c[1:] for c in MULTIWAY],
                         ids=[c[0] for c in MULTIWAY])
def test_multiway_join_in_planner_order(query, order, monkeypatch):
    tables = _fanout_tables()
    rows = _run_both(query, tables, monkeypatch)
    assert rows
    ref_chunks = _ref_chunks(tables)
    ref_plan = ref_build_query(query, {p: c.schema
                                       for p, c in ref_chunks.items()})
    _, ref_jplan = ref_planner.reorder_for_chunks(
        ref_plan, ref_chunks[T].row_count,
        {p: c for p, c in ref_chunks.items() if p != T})
    port_chunks = {p: _to_port(c) for p, c in ref_chunks.items()}
    plan = build_query(query, {p: c.schema for p, c in port_chunks.items()})
    _, jplan = planner.reorder_for_chunks(
        plan, port_chunks[T].row_count,
        {p: c for p, c in port_chunks.items() if p != T})
    assert jplan.order == ref_jplan.order == order
    assert [(d.strategy, d.est_in, d.est_out, d.foreign_rows, d.pushdown)
            for d in jplan.decisions] == \
        [(d.strategy, d.est_in, d.est_out, d.foreign_rows, d.pushdown)
         for d in ref_jplan.decisions]


def test_column_stats_match_the_reference():
    """min/max/has_null/ndv_sketch and $row_count of every column type."""
    rng = np.random.default_rng(8)
    words = [b"x", b"yy", b"", b"z" * 80, b"\xff" * 70]
    rows = [(i, None if i % 5 == 0 else int(rng.integers(-9, 9)),
             float(rng.normal()) if i % 7 else -0.0,
             words[int(rng.integers(0, 5))] if i % 3 else None,
             int(rng.integers(0, 1 << 64, dtype=np.uint64)),
             bool(i % 2)) for i in range(300)]
    ref_chunk = RefChunk.from_rows(RefSchema.make(
        [("k", "int64"), ("v", "int64"), ("d", "double"), ("s", "string"),
         ("u", "uint64"), ("b", "boolean")]), rows)
    from ytsaurus_tpu.chunks.columnar import (
        chunk_column_stats as ref_stats, merge_column_stats as ref_merge,
        ndv_estimate as ref_ndv)
    from ytsaurus_tpu_torch.chunks.columnar import (
        merge_column_stats, ndv_estimate)
    got = chunk_column_stats(_to_port(ref_chunk))
    want = ref_stats(ref_chunk)
    assert got == want
    assert {k: ndv_estimate(v["ndv_sketch"]) for k, v in got.items()
            if isinstance(v, dict)} == \
        {k: ref_ndv(v["ndv_sketch"]) for k, v in want.items()
         if isinstance(v, dict)}
    assert merge_column_stats([got, got]) == ref_merge([want, want])


# --- join keys: doubles with -0.0, +0.0, NaN; uint64; strings; mixed types --


def _key_tables(kind: str) -> dict:
    rng = np.random.default_rng(9)
    if kind == "double":
        pool = [0.0, -0.0, float("nan"), 1.5, -2.0, float("inf"), None]
        ty = "double"
    elif kind == "uint64":
        pool = [0, 1, (1 << 63), (1 << 64) - 1, (1 << 63) + 5, None]
        ty = "uint64"
    else:
        pool = [b"", b"a", b"b", b"zz", b"a\x00", None]
        ty = "string"
    self_rows = [(i, pool[int(rng.integers(0, len(pool)))])
                 for i in range(30)]
    # The foreign side holds each value several times, in shuffled row
    # order, so the order of equal foreign keys decides the output order.
    f_rows = [(pool[int(rng.integers(0, len(pool)))], j) for j in range(24)]
    return {T: ([("k", "int64"), ("x", ty)], self_rows),
            "//d": ([("y", ty), ("p", "int64")], f_rows)}


@pytest.mark.parametrize("left", [False, True], ids=["inner", "left"])
@pytest.mark.parametrize("kind", ["double", "uint64", "string"])
def test_join_key_order(kind, left, monkeypatch):
    """Equal foreign keys come out in the order the foreign sort leaves
    them (for doubles: -0.0 equal to +0.0, NaN matching nothing)."""
    join = "LEFT JOIN" if left else "JOIN"
    query = f"k, x, p FROM [{T}] {join} [//d] ON x = y"
    rows = _run_both(query, _key_tables(kind), monkeypatch)
    assert rows


@pytest.mark.parametrize("query", [
    f"k, p FROM [{T}] JOIN [//d] ON k = y",
    f"k, p FROM [{T}] LEFT JOIN [//d] ON k = y",
    f"k, p FROM [{T}] JOIN [//d] ON x = double(y)",
])
def test_join_mixed_key_types(query, monkeypatch):
    """An int64 key against a double key and a uint64 key against an int64
    key compare as the reference promotes them."""
    tables = _key_tables("double")
    tables[T] = ([("k", "int64"), ("x", "double")],
                 [(k, float(k % 4) if k % 6 else -0.0)
                  for k in range(-3, 12)])
    tables["//d"] = ([("y", "double"), ("p", "int64")],
                     [(float(j % 5) - 1.0, j) for j in range(15)])
    _run_both(query, tables, monkeypatch)


def test_join_uint64_against_int64(monkeypatch):
    tables = {
        T: ([("k", "int64"), ("x", "int64")],
            [(i, v) for i, v in enumerate([-1, 0, 3, 7, -5, 3])]),
        "//d": ([("y", "uint64"), ("p", "int64")],
                [((1 << 64) - 1, 0), (3, 1), (0, 2), (7, 3), (1 << 63, 4)]),
    }
    _run_both(f"k, p FROM [{T}] JOIN [//d] ON x = y", tables, monkeypatch)


# --- the join primitives against their JAX functions -----------------------


def test_sort_foreign_keys_and_probe_match_the_reference():
    """sort_foreign_keys (jnp.lexsort's order, masked rows last) and the
    replicated probe, on double keys with -0.0, NaN and nulls."""
    import jax.numpy as jnp
    rng = np.random.default_rng(10)
    cap, n = 256, 200
    pool = np.array([0.0, -0.0, np.nan, 1.0, -1.0, np.inf, 2.5])
    fd = pool[rng.integers(0, len(pool), cap)]
    fv = (rng.random(cap) > 0.1).astype(np.int8)
    fd = np.where(fv == 1, fd, 0.0)
    f_valid = np.arange(cap) < n
    want_order, want_sorted = ref_joins.sort_foreign_keys(
        [(jnp.asarray(fv), jnp.asarray(fd))], jnp.asarray(f_valid))
    got_order, got_sorted = joins.sort_foreign_keys(
        [(torch.from_numpy(fv), torch.from_numpy(fd))],
        torch.from_numpy(f_valid))
    np.testing.assert_array_equal(got_order.numpy(), np.asarray(want_order))
    sd = pool[rng.integers(0, len(pool), cap)]
    sv = (rng.random(cap) > 0.1).astype(np.int8)
    mask = rng.random(cap) > 0.2
    payload = rng.integers(0, 100, cap)
    for is_left in (False, True):
        sl_ref = [want_sorted[0][0], want_sorted[0][1],
                  jnp.asarray(payload)[want_order],
                  jnp.asarray(f_valid)[want_order], jnp.asarray(n)]
        want = ref_joins.probe_replicated(
            sl_ref, 1, cap, [(jnp.asarray(sv), jnp.asarray(sd))],
            jnp.asarray(mask), is_left)
        sl = [got_sorted[0][0], got_sorted[0][1],
              torch.from_numpy(payload)[got_order],
              torch.from_numpy(f_valid)[got_order], torch.tensor(n)]
        got = joins.probe_replicated(
            sl, 1, cap, [(torch.from_numpy(sv), torch.from_numpy(sd))],
            torch.from_numpy(mask), is_left)
        for (gd, gv), (wd, wv) in zip(got[0], want[0]):
            np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# --- tests/test_multiway_join.py: the corpus on one chunk, the planner --------


def _multiway_tables() -> dict:
    """tests/test_multiway_join.py's tables, its eight fact shards
    concatenated into one chunk (the local side of its dual check)."""
    from ytsaurus_tpu.chunks.columnar import concat_chunks
    rng = np.random.default_rng(37)
    words = [f"w{i:02d}" for i in range(13)]
    chunks = []
    for sh in range(8):
        rows = [(sh * 10_000 + i,
                 int(rng.integers(0, 50)) if rng.uniform() > 0.1 else None,
                 int(rng.integers(0, 40)), words[int(rng.integers(0, 13))],
                 int(rng.integers(0, 100))) for i in range(120 + sh * 9)]
        chunks.append(RefChunk.from_rows(FACT, rows))
    dim = RefChunk.from_arrays(DIM, {"d_ok": np.arange(50),
                                     "d_w": np.arange(50) * 3 % 7})
    dup = RefChunk.from_rows(DUP, [(key, f"t{key % 5}") for key in range(40)
                                   for _ in range(int(rng.integers(0, 4)))])
    sdim = RefChunk.from_rows(SDIM, [(w, i * 10)
                                     for i, w in enumerate(words[:9])])
    return {"//l": concat_chunks(chunks), "//d": dim, "//u": dup,
            "//m": sdim}


@pytest.mark.parametrize("query", MULTIWAY_CORPUS,
                         ids=[f"q{i}" for i in range(len(MULTIWAY_CORPUS))])
def test_multiway_corpus(query, monkeypatch):
    """Broadcast- and partition-shaped joins, string keys, null keys, LEFT
    joins, a window and a cardinality after the join."""
    _run_both(query, _multiway_tables(), monkeypatch)


def test_planner_order_dependencies_and_barriers():
    """tests/test_multiway_join.py's planner case: the most selective join
    first, a join whose key reads a pulled column after the join that
    pulls it, LEFT joins as barriers; the reference's order in each."""
    fact = [("ok", "int64"), ("sk", "int64"), ("v", "int64")]
    specs = {"//o": ([("o_ok", "int64"), ("o_ck", "int64")],
                     {"o_ok": np.arange(10_000),
                      "o_ck": np.arange(10_000) % 500}),
             "//c": ([("c_ck", "int64"), ("c_n", "int64")],
                     {"c_ck": np.arange(500), "c_n": np.arange(500) % 7}),
             "//s": ([("s_sk", "int64"), ("s_n", "int64")],
                     {"s_sk": np.arange(40), "s_n": np.arange(40) % 7})}
    ref_chunks = {p: RefChunk.from_arrays(RefSchema.make(cols), arrays)
                  for p, (cols, arrays) in specs.items()}
    port_chunks = {p: _to_port(c) for p, c in ref_chunks.items()}
    ref_schemas = {p: c.schema for p, c in ref_chunks.items()}
    ref_schemas["//l"] = RefSchema.make(fact)
    schemas = {p: c.schema for p, c in port_chunks.items()}
    schemas["//l"] = _to_port(RefChunk.from_rows(ref_schemas["//l"],
                                                 [])).schema
    for query, want in [
            ("c_n, s_n, sum(v) AS sv FROM [//l] JOIN [//o] ON ok = o_ok "
             "JOIN [//c] ON o_ck = c_ck JOIN [//s] ON sk = s_sk "
             "GROUP BY c_n, s_n", (2, 0, 1)),
            ("c_n, s_n, v FROM [//l] JOIN [//o] ON ok = o_ok "
             "LEFT JOIN [//c] ON o_ck = c_ck JOIN [//s] ON sk = s_sk",
             (0, 1, 2))]:
        ref_jp = ref_planner.plan_for_chunks(
            ref_build_query(query, ref_schemas), 100_000, ref_chunks)
        jp = planner.plan_for_chunks(build_query(query, schemas), 100_000,
                                     port_chunks)
        assert jp.order == ref_jp.order == want
        assert [(d.strategy, d.est_in, d.est_out, d.pushdown)
                for d in jp.decisions] == \
            [(d.strategy, d.est_in, d.est_out, d.pushdown)
             for d in ref_jp.decisions]
