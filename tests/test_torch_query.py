"""End-to-end parity of the port (`ytsaurus_tpu_torch`) with the JAX package
on the CPU: the same chunk bytes, carried across with `chunk_from_numpy`,
go through the JAX `Evaluator().run_plan` (with YT_TPU_SORT_ENGINE=pallas,
so its sorts take the Pallas counting kernel in interpret mode) and the
port's `select_rows(..., device="cpu")`.

Row order (for ORDER BY queries), integers, strings and group sets must
match exactly under the canon of tests/harness.py; doubles agree to
rtol=1e-9, since the two engines sum in different orders.
"""

import math
import os
import subprocess
import sys
import textwrap
from dataclasses import replace

import numpy as np
import pytest
import torch

from tests.harness import _canon
from ytsaurus_tpu.chunks import ColumnarChunk as RefChunk
from ytsaurus_tpu.models import tpch as ref_tpch
from ytsaurus_tpu.query.builder import build_query as ref_build_query
from ytsaurus_tpu.query.engine.evaluator import Evaluator as RefEvaluator
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch.chunks.columnar import chunk_from_numpy
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.models import tpch
from ytsaurus_tpu_torch.query import select_rows

# The tier-1 suite runs several workers side by side: torch's default of
# one (spinning) thread per core would crowd out their timing tests.
torch.set_num_threads(1)

LINEITEM = "//tpch/lineitem"
T = "//t"


def _to_port(chunk: RefChunk):
    spec = [(c.name, c.type.value)
            + ((c.sort_order.value,) if c.sort_order is not None else ())
            for c in chunk.schema]
    planes = {c.name: (np.asarray(chunk.columns[c.name].data),
                       np.asarray(chunk.columns[c.name].valid))
              for c in chunk.schema}
    vocabs = {name: col.dictionary for name, col in chunk.columns.items()
              if col.dictionary is not None}
    port = chunk_from_numpy(spec, chunk.row_count, planes, vocabs,
                            sorted_by=chunk.sorted_by, device="cpu")
    for name, col in chunk.columns.items():
        if col.host_values is not None:       # `any` payloads
            port.columns[name] = replace(port.columns[name],
                                         host_values=list(col.host_values))
    return port


def _split(row: dict):
    """(canon of the exact columns, the double columns)."""
    exact = tuple((k, _canon(v)) for k, v in sorted(row.items())
                  if not isinstance(v, float))
    doubles = tuple((k, v) for k, v in sorted(row.items())
                    if isinstance(v, float))
    return exact, doubles


def _assert_rows(got: list, want: list, ordered: bool):
    got = [_split(r) for r in got]
    want = [_split(r) for r in want]
    if not ordered:
        got, want = sorted(got, key=lambda r: r[0]), \
            sorted(want, key=lambda r: r[0])
    assert [r[0] for r in got] == [r[0] for r in want]
    for (_, g), (_, w) in zip(got, want):
        assert [k for k, _ in g] == [k for k, _ in w]
        for (name, gv), (_, wv) in zip(g, w):
            if math.isnan(wv):
                assert math.isnan(gv), name
            else:
                assert gv == pytest.approx(wv, rel=1e-9, abs=0.0), name


def _run_both(query: str, ref_chunk: RefChunk, monkeypatch, path: str = T,
              ordered: bool = False) -> list:
    monkeypatch.setenv("YT_TPU_SORT_ENGINE", "pallas")
    plan = ref_build_query(query, {path: ref_chunk.schema})
    want = RefEvaluator().run_plan(plan, ref_chunk).to_rows()
    got = select_rows(query, {path: _to_port(ref_chunk)},
                      device="cpu").to_rows()
    _assert_rows(got, want, ordered)
    return got


# --- the slice: TPC-H Q1 and the Q18 aggregation ---------------------------


def test_q1(monkeypatch):
    rows = _run_both(tpch.Q1, ref_tpch.generate_lineitem(4096, seed=1),
                     monkeypatch, path=LINEITEM)
    assert len(rows) == 6


def test_q18_agg_dense_path_at_threshold_300(monkeypatch):
    """256 orders over 4096 lines: the key range is small, so GROUP BY takes
    the dense path, and ~16 lines per order clear the threshold of 300."""
    chunk = ref_tpch.generate_lineitem(4096, seed=2, n_orders=256)
    rows = _run_both(tpch.Q18_AGG, chunk, monkeypatch, path=LINEITEM,
                     ordered=True)
    assert len(rows) == tpch.Q18_LIMIT


def test_q18_agg_general_path(monkeypatch):
    """2^17 orders over 4096 lines: the key range passes 65536, so GROUP BY
    takes the general path (the radix sort over the exact key encoding).
    Few orders reach 300 at this size, so the HAVING threshold is lowered
    to 60 to keep rows in the result."""
    chunk = ref_tpch.generate_lineitem(4096, seed=3, n_orders=1 << 17)
    keys = np.asarray(chunk.columns["l_orderkey"].data[:4096])
    assert keys.max() - keys.min() + 1 > 65536
    rows = _run_both(tpch.q18_agg_query(60), chunk, monkeypatch,
                     path=LINEITEM, ordered=True)
    assert 0 < len(rows) <= tpch.Q18_LIMIT


def test_port_generator_and_oracles_match_the_reference():
    n, seed = 4096, 4
    ref_chunk = ref_tpch.generate_lineitem(n, seed=seed, n_orders=256)
    arrays = tpch.lineitem_arrays(n, seed=seed, n_orders=256)
    chunk = tpch.lineitem_chunk(arrays, device="cpu")
    for name, col in chunk.columns.items():
        np.testing.assert_array_equal(
            col.data.numpy(), np.asarray(ref_chunk.columns[name].data))
        np.testing.assert_array_equal(
            col.valid.numpy(), np.asarray(ref_chunk.columns[name].valid))
    assert tpch.q1_reference_numpy(chunk) == \
        ref_tpch.q1_reference_numpy(ref_chunk)
    got = select_rows(tpch.Q18_AGG, {LINEITEM: chunk}, device="cpu")
    assert got.to_rows() == tpch.q18_agg_oracle(arrays)
    q1 = {(r["l_returnflag"], r["l_linestatus"]): r
          for r in select_rows(tpch.Q1, {LINEITEM: chunk},
                               device="cpu").to_rows()}
    oracle = tpch.q1_oracle(arrays)
    assert set(q1) == set(oracle)
    for key, want in oracle.items():
        assert q1[key]["count_order"] == want["count_order"]
        for name, value in want.items():
            assert q1[key][name] == pytest.approx(value, rel=1e-9), name


# --- ORDER BY ... LIMIT: the top-k candidate path, with ties ----------------


def _tie_table(n: int = 500) -> RefChunk:
    rng = np.random.default_rng(5)
    rows = []
    for i in range(n):
        v = int(rng.integers(0, 6))
        d = float(rng.integers(0, 4)) * (-1.0 if rng.random() < 0.5 else 1.0)
        rows.append({"k": i, "v": None if rng.random() < 0.1 else v,
                     "d": None if rng.random() < 0.1 else d})
    schema = RefSchema.make([("k", "int64"), ("v", "int64"),
                             ("d", "double")])
    return RefChunk.from_rows(schema, rows)


@pytest.mark.parametrize("query", [
    f"k, v FROM [{T}] ORDER BY v DESC LIMIT 10",
    f"k, v FROM [{T}] ORDER BY v LIMIT 10",
    f"k, v FROM [{T}] ORDER BY v DESC OFFSET 7 LIMIT 20",
    f"k, d FROM [{T}] ORDER BY d DESC LIMIT 15",
    f"k, d FROM [{T}] WHERE k > 100 ORDER BY d LIMIT 12",
])
def test_order_by_limit_with_ties(query, monkeypatch):
    rows = _run_both(query, _tie_table(), monkeypatch, ordered=True)
    assert rows


# --- WHERE / IN / BETWEEN / string compares / casts --------------------------


def _mixed_table() -> RefChunk:
    rng = np.random.default_rng(6)
    words = [b"apple", b"banana", b"cherry", b"date", b"fig"]
    rows = []
    for i in range(300):
        rows.append({
            "k": i,
            "v": None if rng.random() < 0.1 else int(rng.integers(-20, 20)),
            "d": None if rng.random() < 0.1 else float(rng.normal() * 5),
            "s": None if rng.random() < 0.1 else words[rng.integers(0, 5)],
            "t": words[rng.integers(1, 4)],
            "u": int(rng.integers(0, 1 << 63)) + (
                (1 << 63) if rng.random() < 0.5 else 0),
            "b": bool(rng.random() < 0.5),
        })
    schema = RefSchema.make([("k", "int64", "ascending"), ("v", "int64"),
                             ("d", "double"), ("s", "string"),
                             ("t", "string"), ("u", "uint64"),
                             ("b", "boolean")])
    return RefChunk.from_rows(schema, rows)


@pytest.mark.parametrize("query", [
    f"k, v FROM [{T}] WHERE v > 3 AND (d < 0 OR b)",
    f"k FROM [{T}] WHERE NOT b OR v = 0",
    f"k, v FROM [{T}] WHERE v IN (1, 2, 3, -5)",
    f"k FROM [{T}] WHERE (v, s) IN ((1, 'apple'), (2, 'fig'), (3, 'kiwi'))",
    f"k FROM [{T}] WHERE v BETWEEN -3 AND 4",
    f"k FROM [{T}] WHERE s BETWEEN 'b' AND 'd'",
    f"k FROM [{T}] WHERE s = 'cherry'",
    f"k FROM [{T}] WHERE s != 'cherry'",
    f"k FROM [{T}] WHERE s > 'banana'",
    f"k FROM [{T}] WHERE 'c' <= s",
    f"k FROM [{T}] WHERE s = t",
    f"k FROM [{T}] WHERE s < t",
    f"k FROM [{T}] WHERE u > 9223372036854775808",
    f"k FROM [{T}] WHERE is_null(v) OR is_null(s)",
    f"k, v / 3 AS q, v % 3 AS r, v * 2 - 1 AS w FROM [{T}] WHERE k < 40",
    f"k, 10 / v AS q FROM [{T}] WHERE k < 40",
    f"k, double(v) + d AS x, int64(d) AS i FROM [{T}] WHERE k < 60",
    f"k, double(u) AS x, uint64(v) AS y, boolean(v) AS z FROM [{T}] "
    "WHERE k < 60",
    f"k, if(b, v, -v) AS x, if(v > 0, s, t) AS y FROM [{T}] WHERE k < 80",
    f"k, -v AS n, ~v AS c, v << 2 AS l FROM [{T}] WHERE k < 30",
])
def test_expressions(query, monkeypatch):
    _run_both(query, _mixed_table(), monkeypatch)


@pytest.mark.parametrize("query", [
    f"s, sum(v) AS sv, count(*) AS n, min(d) AS lo, max(d) AS hi, "
    f"avg(v) AS av FROM [{T}] GROUP BY s",
    f"s, sum(v) AS sv FROM [{T}] GROUP BY s HAVING sum(v) > 0",
    f"v, min(u) AS lo, max(u) AS hi, count(*) AS n FROM [{T}] GROUP BY v",
    f"k % 7 AS g, sum(d) AS sd, min(s) AS ms FROM [{T}] GROUP BY k % 7 "
    "ORDER BY sum(d) DESC LIMIT 5",
    f"u, count(*) AS n FROM [{T}] GROUP BY u ORDER BY u LIMIT 20",
    f"d, count(*) AS n FROM [{T}] GROUP BY d ORDER BY d DESC, count(*) LIMIT 30",
    f"b, s, avg(d) AS a FROM [{T}] GROUP BY b, s",
])
def test_group_by(query, monkeypatch):
    _run_both(query, _mixed_table(), monkeypatch,
              ordered="ORDER BY" in query)


@pytest.mark.parametrize("query", [
    f"lower(s) AS x FROM [{T}]",
    f"k FROM [{T}] WHERE s LIKE 'a%'",
    f"transform(v, (1, 2), (10, 20)) AS x FROM [{T}]",
])
def test_not_yet_ported_expressions_raise(query, monkeypatch):
    """Expressions that once raised "not yet ported" on the port: each
    now runs and gives the JAX package's rows."""
    _run_both(query, _mixed_table(), monkeypatch)


def test_row_list_tables(monkeypatch):
    """Row lists build through the port's own from_rows (strings encoded,
    nulls, uint64 past 2^63) and give the reference's rows."""
    monkeypatch.setenv("YT_TPU_SORT_ENGINE", "pallas")
    spec = [("k", "int64"), ("s", "string"), ("u", "uint64"),
            ("d", "double"), ("b", "boolean")]
    rows = [(3, b"x", (1 << 64) - 1, 1.5, True), (1, None, 5, None, False),
            (2, b"a", 1 << 63, -0.0, None), (4, b"x", None, 2.25, True)]
    query = f"k, s, u, d, b FROM [{T}] WHERE k > 1 ORDER BY u DESC, k LIMIT 10"
    schema = RefSchema.make(spec)
    from ytsaurus_tpu.query.engine.evaluator import select_rows as ref_select
    want = ref_select(query, {T: rows}, schemas={T: schema}).to_rows()
    from ytsaurus_tpu_torch.schema import TableSchema
    got = select_rows(query, {T: rows}, schemas={T: TableSchema.make(spec)},
                      device="cpu").to_rows()
    assert got == want and len(got) == 3


def test_chunk_round_trip_through_numpy():
    """chunk_from_numpy takes the reference's planes bit for bit, to_numpy
    gives them back, and both packages decode the same rows."""
    ref_chunk = _mixed_table()
    chunk = _to_port(ref_chunk)
    back = chunk.to_numpy()
    assert back["row_count"] == ref_chunk.row_count
    assert back["schema_spec"][0] == ("k", "int64", "ascending")
    for name, (data, valid) in back["planes"].items():
        ref_col = ref_chunk.columns[name]
        np.testing.assert_array_equal(data, np.asarray(ref_col.data))
        assert data.dtype == np.asarray(ref_col.data).dtype
        np.testing.assert_array_equal(valid, np.asarray(ref_col.valid))
    assert list(back["dictionaries"]) == ["s", "t"]
    assert chunk.to_rows() == ref_chunk.to_rows()


# --- device rules -------------------------------------------------------------


def test_asking_for_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    schema = RefSchema.make([("k", "int64")])
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.schema import TableSchema
    with pytest.raises(YtError, match="no CUDA device"):
        ColumnarChunk.from_rows(TableSchema.make([("k", "int64")]), [(1,)])
    with pytest.raises(YtError, match="no CUDA device"):
        tpch.generate_lineitem(256)
    cpu_chunk = _to_port(RefChunk.from_rows(schema, [(1,)]))
    with pytest.raises(YtError, match="no CUDA device"):
        select_rows(f"k FROM [{T}]", {T: cpu_chunk})


def test_port_runs_with_jax_and_the_jax_package_blocked():
    """The port imports neither jax nor the JAX package: with both blocked
    in sys.modules, CPU queries (an aggregation, the Q3 join and the
    window query) run end to end in a fresh interpreter, through the
    join, window and planner modules; so do a `sort_chunk`, an
    `external_sort` that partitions, an MVCC `visible_chunk`, the FUNCS
    query, the STRINGS query with LIKE and a regex, a NEAREST query and
    `batched_nearest`; the mesh modules, the whole-plan rung, the mesh
    observatory, the config and the utilities import, `split_plan` splits
    Q1 and `coordinate_and_execute` runs it over two lazy shards
    (tests/test_torch_distributed.py runs the mesh and the ladder on ranks
    with both blocked); the storage path (YSON, the chunk wire format, the
    chunk store, `Tablet` and `TransactionManager`) writes a table through
    a transaction, flushes, compacts and reads it back; and the client
    (`connect`, with Cypress, the gateway and the scheduler under it)
    writes a static table, selects from it, sorts, reduces, map-reduces
    it through shell commands and runs a vanilla command; the front doors
    answer (a REST select through `HttpProxy`, a driver call over RPC
    through `TcpProxy` and a `RetryingChannel`, an `engine="sql"` query in
    the query tracker); the replication, chaos, secondary-index,
    queue-agent, view and view-daemon modules import; and so do the quorum,
    election, Hive, portal, Sequoia, clock and RPC chunk-store modules,
    with one `QuorumWal` append acknowledged by port `DataNodeService`s."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["ytsaurus_tpu"] = None
        from ytsaurus_tpu_torch.models import tpch
        from ytsaurus_tpu_torch.query import select_rows
        arrays = tpch.lineitem_arrays(2048, seed=9, n_orders=128)
        chunk = tpch.lineitem_chunk(arrays, device="cpu")
        rows = select_rows(tpch.Q18_AGG, {"//tpch/lineitem": chunk},
                           device="cpu").to_rows()
        assert rows == tpch.q18_agg_oracle(arrays), rows
        from ytsaurus_tpu_torch.query import planner  # noqa: F401
        from ytsaurus_tpu_torch.query.engine import joins, window  # noqa: F401
        orders = tpch.orders_arrays(128, seed=9)
        q3 = select_rows(tpch.Q3, {
            "//tpch/lineitem": chunk,
            "//tpch/orders": tpch.orders_chunk(orders, device="cpu")},
            device="cpu").to_rows()
        assert [r["l_orderkey"] for r in q3] == \
            [r["l_orderkey"] for r in tpch.q3_oracle(arrays, orders)], q3
        w_arrays = tpch.window_arrays(4096, seed=9)
        w = select_rows(tpch.WINDOW, {"//t": tpch.window_chunk(
            w_arrays, device="cpu")}, device="cpu").to_numpy()["planes"]
        s, r = tpch.window_oracle(w_arrays)
        assert (w["s"][0][:4096] == s).all() and (w["r"][0][:4096] == r).all()
        import numpy as np
        from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
        from ytsaurus_tpu_torch.operations.sort_op import sort_chunk
        from ytsaurus_tpu_torch.ops.bigsort import external_sort
        from ytsaurus_tpu_torch.schema import TableSchema
        from ytsaurus_tpu_torch.tablet import mvcc
        from ytsaurus_tpu_torch.tablet.tablet import versioned_schema
        from ytsaurus_tpu_torch.tablet.timestamp import MAX_TIMESTAMP
        keys = np.random.default_rng(9).integers(0, 1 << 40, 3000)
        schema = TableSchema.make([("k", "int64"), ("p", "double")])
        blocks = [ColumnarChunk.from_arrays(
            schema, {"k": keys[lo:lo + 1000], "p": np.arange(1000.0)},
            device="cpu") for lo in range(0, 3000, 1000)]
        srt = sort_chunk(blocks[0], ["k"], device="cpu").to_numpy()
        assert (srt["planes"]["k"][0][:1000] == np.sort(keys[:1000])).all()
        out = list(external_sort(blocks, ["k"], budget_bytes=400 * 36,
                                 device="cpu"))
        assert len(out) > 1 and (np.concatenate(
            [c.to_numpy()["planes"]["k"][0][:c.row_count] for c in out])
            == np.sort(keys)).all()
        table = TableSchema.make([("k", "int64", "ascending"),
                                  ("v", "int64")])
        versions = ColumnarChunk.from_rows(versioned_schema(table), [
            (1, 10, False, 5, True), (1, 20, False, 6, True),
            (2, 10, False, 7, True), (2, 30, True, None, False)],
            device="cpu")
        seen = mvcc.visible_chunk(versions, table, MAX_TIMESTAMP,
                                  device="cpu").to_rows()
        assert seen == [{"k": 1, "v": 6}], seen
        funcs = select_rows(tpch.FUNCS, {"//tpch/lineitem": chunk},
                            device="cpu").to_rows()
        want = tpch.funcs_oracle(arrays)
        assert {(r["month"], r["bucket"]): r["c"] for r in funcs} == \
            {key: g["c"] for key, g in want.items()}, funcs
        from ytsaurus_tpu_torch.models import synthetic
        s_arrays = synthetic.strings_arrays(20_000, seed=9)
        strs = select_rows(synthetic.STRINGS_FUNCS, {
            "//t": synthetic.strings_chunk(s_arrays, device="cpu")},
            device="cpu").to_rows()
        assert {r["u"]: (r["n"], r["t"]) for r in strs} == \
            synthetic.strings_funcs_oracle(s_arrays), strs
        plane = np.random.default_rng(9).standard_normal(
            (3000, 16), dtype=np.float32)
        q = plane[17] + 0.001
        near = select_rows(synthetic.VECTOR_QUERIES["nearest_l2"], {
            "//v": synthetic.vector_table(plane, device="cpu")},
            params=[q.tolist()], device="cpu").to_rows()
        assert near[0]["k"] == 17 and len(near) == 8, near
        from ytsaurus_tpu_torch.query.vector import batched_nearest
        hits = batched_nearest(synthetic.vector_table(plane, device="cpu"),
                               "emb", [q.tolist()], 8, device="cpu")
        assert [r for r, _ in hits[0]] == [r["k"] for r in near], hits
        from ytsaurus_tpu_torch.parallel import distributed, mesh  # noqa: F401
        from ytsaurus_tpu_torch.parallel import shuffle  # noqa: F401
        from ytsaurus_tpu_torch.query import build_query, coordinator
        bottom, front = coordinator.split_plan(build_query(
            tpch.Q1, {"//tpch/lineitem": chunk.schema}))
        assert front.group is not None and bottom.order is None
        from ytsaurus_tpu_torch import config  # noqa: F401
        from ytsaurus_tpu_torch.parallel import mesh_observatory  # noqa: F401
        from ytsaurus_tpu_torch.parallel import whole_plan  # noqa: F401
        from ytsaurus_tpu_torch.query import parameterize, serving  # noqa: F401
        from ytsaurus_tpu_torch.query import statistics  # noqa: F401
        from ytsaurus_tpu_torch.utils import (  # noqa: F401
            failpoints, logging, profiling, sanitizers, tracing)
        from ytsaurus_tpu_torch.query.engine.evaluator import Evaluator
        halves = [tpch.lineitem_chunk(
            tpch.lineitem_arrays(1024, seed=s, n_orders=128), device="cpu")
            for s in (9, 10)]
        multi = coordinator.coordinate_and_execute(
            build_query(tpch.Q1, {"//tpch/lineitem": chunk.schema}),
            [(lambda c=c: c) for c in halves], evaluator=Evaluator("cpu"))
        from ytsaurus_tpu_torch.chunks.columnar import concat_chunks
        single = select_rows(tpch.Q1, {"//tpch/lineitem": concat_chunks(
            halves)}, device="cpu")
        assert sorted(r["count_order"] for r in multi.to_rows()) == \
            sorted(r["count_order"] for r in single.to_rows())
        import tempfile
        from ytsaurus_tpu_torch import native, yson
        from ytsaurus_tpu_torch.chunks.encoding import (
            deserialize_chunk, serialize_chunk)
        from ytsaurus_tpu_torch.chunks.store import FsChunkStore
        from ytsaurus_tpu_torch.tablet.tablet import Tablet
        from ytsaurus_tpu_torch.tablet.transactions import TransactionManager
        assert yson.loads(yson.dumps({"a": [1, 2.5]}, binary=True)) == \
            {"a": [1, 2.5]}
        assert native.status()["path"] in ("native", "numpy")
        back = deserialize_chunk(serialize_chunk(halves[0]), device="cpu")
        assert back.to_rows() == halves[0].to_rows()
        dyn = TableSchema.make([("k", "int64", "ascending"), ("v", "int64")])
        with tempfile.TemporaryDirectory() as root:
            tab = Tablet(dyn, FsChunkStore(root), device="cpu")
            txm = TransactionManager()
            tx = txm.start()
            txm.write_rows(tx, tab, [{"k": i, "v": i * i} for i in range(50)])
            txm.commit(tx)
            tab.flush()
            tx = txm.start()
            txm.delete_rows(tx, tab, [(3,)])
            txm.commit(tx)
            tab.flush()
            tab.compact(retention_timestamp=txm.timestamps.generate())
            assert tab.lookup_rows([(2,), (3,)]) == [{"k": 2, "v": 4}, None]
            assert tab.read_snapshot().row_count == 49
        from ytsaurus_tpu_torch.client import connect
        from ytsaurus_tpu_torch.query import (  # noqa: F401
            accounting, profile, pruning, workload)
        with tempfile.TemporaryDirectory() as root:
            client = connect(root, device="cpu")
            client.write_table("//t", [{"k": 5 - i, "g": i % 2}
                                       for i in range(5)])
            got = client.select_rows("g, count(*) AS c FROM [//t] GROUP BY g")
            assert sorted((r["g"], r["c"]) for r in got) == [(0, 3), (1, 2)]
            op = client.run_sort("//t", "//s", sort_by="k")
            assert op.state == "completed", op.error
            assert [r["k"] for r in client.read_table("//s")] == [1, 2, 3, 4, 5]
            op = client.run_reduce(
                lambda key, rs: [{"k": key["k"], "c": len(rs)}], "//s",
                "//red", reduce_by="k")
            assert op.state == "completed", op.error
            op = client.run_map_reduce("cat", "cat", "//t", "//mr",
                                       reduce_by="g", format="json")
            assert len(client.read_table("//mr")) == 5, op.error
            op = client.run_vanilla({"t": {"job_count": 1,
                                           "command": "true"}})
            assert op.state == "completed", op.error
            import json, urllib.request
            from ytsaurus_tpu_torch import driver, rpc  # noqa: F401
            from ytsaurus_tpu_torch.ecosystem import sql  # noqa: F401
            from ytsaurus_tpu_torch.server.http_proxy import HttpProxy
            from ytsaurus_tpu_torch.server.query_tracker import QueryTracker
            from ytsaurus_tpu_torch.server.services import DriverService
            from ytsaurus_tpu_torch.server.tcp_proxy import TcpProxy
            proxy = HttpProxy(lambda user: client)
            proxy.start()
            req = urllib.request.Request(
                f"http://{proxy.address}/api/v4/select_rows",
                data=json.dumps({"query": "g, count(*) AS c FROM [//t] "
                                          "GROUP BY g"}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                rest = json.loads(resp.read())["value"]
            proxy.stop()
            assert sorted((r["g"], r["c"]) for r in rest) == [(0, 3), (1, 2)]
            server = rpc.RpcServer([DriverService(client)])
            server.start()
            tcp = TcpProxy([server.address]).start()
            channel = rpc.RetryingChannel(rpc.Channel(tcp.address, timeout=60))
            body, _ = channel.call("driver", "execute", {
                "command": "select_rows",
                "parameters": {"query": "sum(k) AS s FROM [//t] "
                                        "GROUP BY 1 AS o"}})
            channel.close()
            tcp.stop()
            server.stop()
            assert body["result"] == [{"s": 15}], body
            qid = client.query_tracker.start_query(
                "SELECT g, sum(k) AS s FROM `//t` GROUP BY g", engine="sql")
            assert client.query_tracker.wait(qid)["state"] == "completed"
            assert sorted((r["g"], r["s"]) for r in
                          client.query_tracker.read_query_result(qid)) == \
                [(0, 9), (1, 6)]
            assert isinstance(client.query_tracker, QueryTracker)
        from ytsaurus_tpu_torch.operations import (  # noqa: F401
            job_environment, reduce_op)
        from ytsaurus_tpu_torch.tablet import (  # noqa: F401
            chaos, replication, secondary_index)
        from ytsaurus_tpu_torch.server import (  # noqa: F401
            queue_agent, view_daemon)
        from ytsaurus_tpu_torch.query import views  # noqa: F401
        from ytsaurus_tpu_torch.cypress import (  # noqa: F401
            election, hive, multicell, quorum, sequoia)
        from ytsaurus_tpu_torch.server import remote_store  # noqa: F401
        from ytsaurus_tpu_torch.server.services import DataNodeService
        from ytsaurus_tpu_torch.tablet import clock  # noqa: F401
        with tempfile.TemporaryDirectory() as root:
            nodes = [rpc.RpcServer([DataNodeService(
                FsChunkStore(f"{root}/loc{i}"), f"{root}/j{i}")])
                for i in range(2)]
            for node in nodes:
                node.start()
            wal = quorum.QuorumWal(
                f"{root}/wal.log", "master_wal",
                [rpc.Channel(n.address, timeout=60) for n in nodes],
                quorum=2, count_local_ack=False, bootstrap_from_local=True)
            assert wal.recover() == []
            wal.append({"op": "create", "args": {"path": "//x"}})
            counts = [rpc.Channel(n.address).call(
                "data_node", "journal_count", {"journal": "master_wal"})[0]
                for n in nodes]
            assert [c["count"] for c in counts] == [1, 1], counts
            wal.close()
            for node in nodes:
                node.stop()
        assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items()
                             if v is not None}
        print("ok", len(rows))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")
