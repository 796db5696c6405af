"""Tests of the port that need a CUDA card; without one they skip.

This file imports neither jax nor the JAX package, so that it also runs on
a machine without them: `python -m pytest --noconftest tests/test_torch_cuda.py`.
Each CUDA kernel is held against its plain PyTorch version, exactly.
"""

import numpy as np
import pytest
import torch

from ytsaurus_tpu_torch.ops import hist_rank as hr
from ytsaurus_tpu_torch.ops import radix as rx
from ytsaurus_tpu_torch.ops.radix import radix_argsort_u32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", ["equal", "max", "random"])
@pytest.mark.parametrize("bits", [1, 6, 8])
def test_hist_rank_kernel_matches_plain_version(cuda_device, bits, kind):
    n = 1 << 16
    if kind == "equal":
        d = np.zeros(n, dtype=np.int32)
    elif kind == "max":
        d = np.full(n, (1 << bits) - 1, dtype=np.int32)
    else:
        d = np.random.default_rng(bits).integers(0, 1 << bits, n,
                                                 dtype=np.int32)
    d = torch.from_numpy(d).to(cuda_device)
    before = hr.launches
    counts, rank = hr.hist_rank(d, bits=bits)
    want_counts, want_rank = hr.hist_rank_plain(d, bits=bits)
    torch.cuda.synchronize()
    assert hr.launches == before + 1
    assert torch.equal(counts, want_counts) and torch.equal(rank, want_rank)


def test_radix_argsort_on_the_card_matches_the_cpu(cuda_device):
    keys = np.random.default_rng(3).integers(0, 1 << 32, 100_000)
    keys[:20_000] &= 0xF                                 # ties
    got = radix_argsort_u32([torch.from_numpy(keys).to(cuda_device)])
    want = radix_argsort_u32([torch.from_numpy(keys)])
    assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(want.numpy(), np.argsort(keys,
                                                           kind="stable"))


def test_cuda_tensor_always_launches_the_kernel(
        cuda_device):
    """A CUDA tensor never takes the plain version: the launch count rises."""
    before = hr.launches
    hr.hist_rank(torch.zeros(2048, dtype=torch.int32, device=cuda_device))
    assert hr.launches == before + 1


def _words(kind: str, n: int) -> np.ndarray:
    if kind == "equal":
        return np.full(n, 0x5A5A5A5A, dtype=np.int64)
    if kind == "max":
        return np.full(n, 0xFFFFFFFF, dtype=np.int64)
    return np.random.default_rng(n).integers(0, 1 << 32, n)


@pytest.mark.parametrize("kind", ["equal", "max", "random"])
@pytest.mark.parametrize("n", [2048, 10_000, 1 << 20])
def test_radix_upsweep_kernel_matches_plain_version(cuda_device, n, kind):
    word = torch.from_numpy(_words(kind, n)).to(cuda_device)
    perm = torch.randperm(n).to(torch.int32).to(cuda_device)
    for p in (None, perm):
        before = rx.launches["radix_upsweep"]
        key, hist = rx.radix_upsweep(word, p, 4)
        want_key, want_hist = rx.radix_upsweep_plain(word, p, 4)
        torch.cuda.synchronize()
        assert rx.launches["radix_upsweep"] == before + 1
        assert torch.equal(key, want_key) and torch.equal(hist, want_hist)


@pytest.mark.parametrize("items", rx.LAYOUTS)
@pytest.mark.parametrize("kind", ["equal", "max", "random"])
@pytest.mark.parametrize("n", [2048, 10_000, 1 << 20])
def test_radix_onesweep_kernel_matches_plain_version(cuda_device, n, kind,
                                                     items):
    word = torch.from_numpy(_words(kind, n)).to(cuda_device)
    key, hist = rx.radix_upsweep(word, None, 4)
    bin_start = torch.cumsum(hist, 1, dtype=torch.int32) - hist
    val = torch.randperm(n).to(torch.int32).to(cuda_device)
    for pos in range(4):
        before = rx.launches["radix_onesweep"]
        got = rx.radix_onesweep(key, val, 8 * pos, bin_start[pos], items)
        want = rx.radix_onesweep_plain(key, val, 8 * pos)
        torch.cuda.synchronize()
        assert rx.launches["radix_onesweep"] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_radix_argsort_skips_constant_digits_on_the_card(cuda_device):
    """Two words of an int64 key below 2^40: the high word's digits 1-3
    are zero everywhere, so 5 of the 8 passes run."""
    keys = np.random.default_rng(8).integers(0, 1 << 40, 300_000)
    words = [torch.from_numpy(w).to(cuda_device)
             for w in (keys >> 32, keys & 0xFFFFFFFF)]
    rx.reset_launches()
    got = radix_argsort_u32(words)
    torch.cuda.synchronize()
    assert rx.launches == {"radix_upsweep": 2, "radix_onesweep": 5}
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.argsort(keys, kind="stable"))


# --- the join, window and totals paths on the card ----------------------------


def _run_on(device, query: str, tables: dict):
    from ytsaurus_tpu_torch.chunks.columnar import chunk_from_numpy
    from ytsaurus_tpu_torch.query import select_rows
    moved = {path: chunk_from_numpy(**{**spec, "device": device})
             for path, spec in tables.items()}
    return select_rows(query, moved, device=device)


def _q3_tables() -> dict:
    from ytsaurus_tpu_torch.models import tpch
    lineitem = tpch.lineitem_chunk(tpch.lineitem_arrays(50_000, seed=4),
                                   device="cpu").to_numpy()
    orders = tpch.orders_chunk(tpch.orders_arrays(12_500, seed=1),
                               device="cpu").to_numpy()
    return {"//tpch/lineitem": lineitem, "//tpch/orders": orders}


def _spec(chunk_numpy: dict) -> dict:
    return {k: chunk_numpy[k] for k in ("schema_spec", "row_count", "planes",
                                        "dictionaries", "sorted_by")}


@pytest.mark.parametrize("query", [
    "__Q3__",
    "l_orderkey, o_orderdate FROM [//tpch/lineitem] LEFT JOIN "
    "[//tpch/orders] ON l_orderkey = o_orderkey * 2 LIMIT 5000",
    "l_returnflag, count(*) AS n, sum(l_quantity) AS q FROM "
    "[//tpch/lineitem] JOIN [//tpch/orders] ON l_orderkey = o_orderkey "
    "WHERE o_orderdate < 9000 GROUP BY l_returnflag WITH TOTALS",
])
def test_join_on_the_card_matches_the_cpu(cuda_device, query):
    """Rows in the same order, launched through the radix kernels; the
    doubles to rtol 1e-9 (atomic float sums)."""
    from ytsaurus_tpu_torch.models import tpch
    if query == "__Q3__":
        query = tpch.Q3
    tables = {p: _spec(c) for p, c in _q3_tables().items()}
    rx.reset_launches()
    got = _run_on(cuda_device, query, tables).to_rows()
    torch.cuda.synchronize()
    assert rx.launches["radix_upsweep"] > 0
    want = _run_on("cpu", query, tables).to_rows()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name, value in w.items():
            if isinstance(value, float):
                assert g[name] == pytest.approx(value, rel=1e-9), name
            else:
                assert g[name] == value, name


def test_window_on_the_card_matches_the_cpu(cuda_device):
    from ytsaurus_tpu_torch.models import tpch
    arrays = tpch.window_arrays(300_000, seed=5)
    spec = _spec(tpch.window_chunk(arrays, device="cpu").to_numpy())
    query = ("k, sum(v) OVER (PARTITION BY g ORDER BY k) AS s, "
             "dense_rank() OVER (PARTITION BY g ORDER BY k) AS r, "
             "lag(v, 2, -1) OVER (PARTITION BY g ORDER BY k) AS l, "
             "min(v) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN 3 "
             "PRECEDING AND 2 FOLLOWING) AS m, "
             "avg(v) OVER (PARTITION BY g) AS a FROM [//t]")
    rx.reset_launches()
    got = _run_on(cuda_device, query, {"//t": spec}).to_numpy()["planes"]
    torch.cuda.synchronize()
    assert rx.launches["radix_onesweep"] > 0
    want = _run_on("cpu", query, {"//t": spec}).to_numpy()["planes"]
    for name in ("k", "s", "r", "l", "m"):
        np.testing.assert_array_equal(got[name][0], want[name][0])
        np.testing.assert_array_equal(got[name][1], want[name][1])
    np.testing.assert_allclose(got["a"][0], want["a"][0], rtol=1e-9)
    s, _ = tpch.window_oracle(arrays)
    np.testing.assert_array_equal(got["s"][0][:300_000], s)


def test_segment_scans_on_the_card_match_the_cpu(cuda_device):
    from ytsaurus_tpu_torch.ops import segments as seg
    rng = np.random.default_rng(6)
    n = 1 << 20
    starts = rng.random(n) < 0.001
    starts[0] = True
    x = rng.integers(-1000, 1000, n)
    f = rng.normal(size=n)
    for fn in ("segment_start_index", "segment_end_index",
               "segment_position"):
        got = getattr(seg, fn)(torch.from_numpy(starts).to(cuda_device))
        want = getattr(seg, fn)(torch.from_numpy(starts))
        assert torch.equal(got.cpu(), want), fn
    for name in ("sum", "min", "max"):
        for data in (x, f):
            got = seg.segment_scan(name, torch.from_numpy(data).to(
                cuda_device), torch.from_numpy(starts).to(cuda_device))
            want = seg.segment_scan(name, torch.from_numpy(data),
                                    torch.from_numpy(starts))
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       rtol=1e-12)


def _planes_on(chunk) -> dict:
    return {name: (d.view(np.uint8) if d.dtype.kind == "f" else d, v)
            for name, (d, v) in chunk.to_numpy()["planes"].items()}


def _same_chunk(got, want) -> None:
    assert got.row_count == want.row_count
    assert got.capacity == want.capacity
    g, w = _planes_on(got), _planes_on(want)
    assert g.keys() == w.keys()
    for name in w:
        np.testing.assert_array_equal(g[name][0], w[name][0], name)
        np.testing.assert_array_equal(g[name][1], w[name][1], name)


def test_sort_chunk_on_the_card_matches_the_cpu(cuda_device):
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.operations.sort_op import sort_chunk
    from ytsaurus_tpu_torch.schema import TableSchema
    rng = np.random.default_rng(8)
    n = 1_000_000
    schema = TableSchema.make([("k", "int64"), ("u", "uint64"),
                               ("p", "double")])
    arrays = {"k": rng.integers(0, 1 << 20, n),
              "u": rng.integers(0, 1 << 64, n, dtype=np.uint64),
              "p": rng.random(n)}
    for keys in (["k"], ["u", "k"], ["p"]):
        rx.reset_launches()
        got = sort_chunk(ColumnarChunk.from_arrays(schema, arrays,
                                                   device=cuda_device),
                         keys, device=cuda_device)
        torch.cuda.synchronize()
        assert rx.launches["radix_upsweep"] > 0
        assert rx.launches["radix_onesweep"] > 0
        want = sort_chunk(ColumnarChunk.from_arrays(schema, arrays,
                                                    device="cpu"),
                          keys, device="cpu")
        _same_chunk(got, want)
    order = np.argsort(arrays["p"], kind="stable")
    np.testing.assert_array_equal(got.to_numpy()["planes"]["k"][0][:n],
                                  arrays["k"][order])


def test_external_sort_on_the_card_matches_the_cpu(cuda_device):
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.ops.bigsort import SpillStats, external_sort
    from ytsaurus_tpu_torch.schema import TableSchema
    rng = np.random.default_rng(9)
    schema = TableSchema.make([("k", "int64"), ("p", "double")])
    n, block = 2_000_000, 250_000
    keys = rng.integers(0, 1 << 60, n)
    pay = rng.random(n)

    def blocks(device):
        return [ColumnarChunk.from_arrays(
            schema, {"k": keys[lo:lo + block], "p": pay[lo:lo + block]},
            device=device) for lo in range(0, n, block)]

    budget = 300_000 * 18 * 2
    rx.reset_launches()
    got_stats, want_stats = SpillStats(), SpillStats()
    got = list(external_sort(blocks(cuda_device), ["k"], budget,
                             stats=got_stats, device=cuda_device))
    torch.cuda.synchronize()
    assert rx.launches["radix_upsweep"] > 0
    want = list(external_sort(blocks("cpu"), ["k"], budget,
                              stats=want_stats, device="cpu"))
    assert got_stats == want_stats and got_stats.ranges > 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_chunk(g, w)
    flat = np.concatenate([c.to_numpy()["planes"]["k"][0][:c.row_count]
                           for c in got])
    np.testing.assert_array_equal(flat, np.sort(keys))


def test_mvcc_on_the_card_matches_the_cpu(cuda_device):
    from ytsaurus_tpu_torch.chunks.columnar import chunk_from_numpy
    from ytsaurus_tpu_torch.schema import TableSchema
    from ytsaurus_tpu_torch.tablet import mvcc
    from ytsaurus_tpu_torch.tablet.tablet import versioned_schema
    rng = np.random.default_rng(10)
    table = TableSchema.make([("k", "int64", "ascending"), ("g", "int64"),
                              ("v", "int64")])
    vschema = versioned_schema(table)
    n_keys, n_later = 200_000, 100_000
    n = n_keys + n_later
    k = np.concatenate([np.arange(n_keys), rng.integers(0, n_keys, n_later)])
    ts = np.arange(1, n + 1)
    tomb = np.concatenate([np.zeros(n_keys, bool), rng.random(n_later) < .05])
    wg = np.concatenate([np.ones(n_keys, bool), np.zeros(n_later, bool)])
    wv = ~tomb
    perm = rng.permutation(n)
    cap = 1 << 19
    planes = {}
    for name, data, valid in (
            ("k", k, np.ones(n, bool)), ("$timestamp", ts, np.ones(n, bool)),
            ("$tombstone", tomb, np.ones(n, bool)),
            ("g", rng.integers(0, 100, n), wg), ("$w:g", wg, np.ones(n, bool)),
            ("v", rng.integers(0, 1000, n), wv),
            ("$w:v", wv, np.ones(n, bool))):
        d = np.zeros(cap, dtype=data.dtype)
        m = np.zeros(cap, dtype=bool)
        d[:n], m[:n] = data[perm], valid[perm]
        planes[name] = (d, m)
    spec = [(c.name, c.type.value) + ((c.sort_order.value,)
            if c.sort_order is not None else ()) for c in vschema]
    on_card = chunk_from_numpy(spec, n, planes, device=cuda_device)
    on_cpu = chunk_from_numpy(spec, n, planes, device="cpu")
    for read_ts in (n_keys + n_later // 2, 1 << 62):
        rx.reset_launches()
        got = mvcc.visible_chunk(on_card, table, read_ts, device=cuda_device)
        torch.cuda.synchronize()
        assert rx.launches["radix_onesweep"] > 0
        _same_chunk(got, mvcc.visible_chunk(on_cpu, table, read_ts,
                                            device="cpu"))
    _same_chunk(mvcc.sorted_versioned_chunk(on_card, table,
                                            device=cuda_device),
                mvcc.sorted_versioned_chunk(on_cpu, table, device="cpu"))
    _same_chunk(mvcc.retained_chunk(on_card, table, n_keys,
                                    device=cuda_device),
                mvcc.retained_chunk(on_cpu, table, n_keys, device="cpu"))


# --- the expression functions and vector search on the card -------------------


def _rows_match(got: list, want: list, rel: float = 1e-9) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name, value in w.items():
            if isinstance(value, float):
                assert g[name] == pytest.approx(value, rel=rel), name
            else:
                assert g[name] == value, name


def test_funcs_on_the_card_matches_the_cpu(cuda_device):
    """The FUNCS query (calendar floor, farm_hash with an unsigned modulo,
    the numeric functions, LIKE) over 200,000 lineitem rows: the card's
    groups are the CPU's and the oracle's, through the radix kernels."""
    from ytsaurus_tpu_torch.models import tpch
    arrays = tpch.lineitem_arrays(200_000, seed=6)
    spec = _spec(tpch.lineitem_chunk(arrays, device="cpu").to_numpy())
    rx.reset_launches()
    got = _run_on(cuda_device, tpch.FUNCS,
                  {"//tpch/lineitem": spec}).to_rows()
    torch.cuda.synchronize()
    assert rx.launches["radix_upsweep"] > 0
    assert rx.launches["radix_onesweep"] > 0
    want = _run_on("cpu", tpch.FUNCS, {"//tpch/lineitem": spec}).to_rows()

    def key(r):
        return r["month"], r["bucket"]
    _rows_match(sorted(got, key=key), sorted(want, key=key))
    oracle = tpch.funcs_oracle(arrays)
    assert {(r["month"], r["bucket"]): r["c"] for r in got} == \
        {key: g["c"] for key, g in oracle.items()}


@pytest.mark.parametrize("which", ["STRINGS_GROUP", "STRINGS_FUNCS"])
def test_strings_on_the_card_matches_the_cpu(cuda_device, which):
    from ytsaurus_tpu_torch.models import synthetic
    arrays = synthetic.strings_arrays(300_000, seed=7)
    spec = _spec(synthetic.strings_chunk(arrays, device="cpu").to_numpy())
    query = getattr(synthetic, which)
    got = _run_on(cuda_device, query, {"//t": spec}).to_rows()
    want = _run_on("cpu", query, {"//t": spec}).to_rows()
    key = list(want[0])[0]
    _rows_match(sorted(got, key=lambda r: r[key]),
                sorted(want, key=lambda r: r[key]))


@pytest.mark.parametrize("name", ["nearest_l2", "nearest_cosine_where",
                                  "order_by_dot"])
def test_nearest_on_the_card_matches_the_cpu(cuda_device, name):
    """NEAREST over 100,000 × 64 normal vectors: the card's rows hold the
    float64 oracle's recall rule, as the CPU's do, with distances to rtol
    1e-4; the vector plane comes out of the compaction intact."""
    from ytsaurus_tpu_torch.models import synthetic
    plane = np.random.default_rng(8).standard_normal((100_000, 64),
                                                     dtype=np.float32)
    q = np.random.default_rng(9).standard_normal(64, dtype=np.float32)
    spec = _spec(synthetic.vector_table(plane, device="cpu").to_numpy())
    query = synthetic.VECTOR_QUERIES[name]
    metric = {"nearest_l2": "l2", "nearest_cosine_where": "cosine",
              "order_by_dot": "dot"}[name]
    rows = np.arange(100_000)
    if name == "nearest_cosine_where":
        rows = rows[rows % 5 == 2]
    measures = synthetic.vector_measures(plane, q, metric, rows)[0]
    for device in (cuda_device, "cpu"):
        from ytsaurus_tpu_torch.chunks.columnar import chunk_from_numpy
        from ytsaurus_tpu_torch.query import select_rows
        chunk = chunk_from_numpy(**{**spec, "device": device})
        out = select_rows(query, {"//v": chunk}, params=[q.tolist()],
                          device=device).to_rows()
        hits = [(r["k"], synthetic.vector_measures(
            plane, q, metric, np.array([r["k"]]))[0, 0]) for r in out]
        synthetic.check_hits(hits, measures, rows, metric, 8)
        if "emb" in out[0]:
            for r in out:
                assert r["emb"] == plane[r["k"]].tolist()


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_batched_nearest_on_the_card_matches_the_cpu(cuda_device, metric):
    from ytsaurus_tpu_torch.chunks.columnar import chunk_from_numpy
    from ytsaurus_tpu_torch.models import synthetic
    from ytsaurus_tpu_torch.query.vector import batched_nearest
    plane = np.random.default_rng(10).standard_normal((50_000, 32),
                                                      dtype=np.float32)
    queries = np.random.default_rng(11).standard_normal((5, 32),
                                                        dtype=np.float32)
    spec = _spec(synthetic.vector_table(plane, device="cpu").to_numpy())
    rows = np.arange(50_000)
    for device in (cuda_device, "cpu"):
        chunk = chunk_from_numpy(**{**spec, "device": device})
        out = batched_nearest(chunk, "emb", queries.tolist(), 16, metric,
                              device=device)
        assert len(out) == 5
        measures = synthetic.vector_measures(plane, queries, metric)
        for m, hits in zip(measures, out):
            synthetic.check_hits(hits, m, rows, metric, 16)


# --- casts and the mesh paths on the card -------------------------------------


def test_casts_of_doubles_saturate_on_the_card(cuda_device):
    """int64(d) and uint64(d) clamp before they convert, so the card gives
    the CPU's saturated values: NaN 0, out of range the bound, uint64 of a
    negative 0."""
    from ytsaurus_tpu_torch.query.engine.expr import cast_plane
    from ytsaurus_tpu_torch.schema import EValueType
    edges = torch.tensor([float("nan"), float("inf"), float("-inf"), 1e308,
                          -1e308, -2.5, -0.5, 2.0 ** 63, 2.0 ** 64,
                          2.0 ** 63 - 1024.0, 2.0 ** 64 - 2048.0,
                          -(2.0 ** 63), 1.8e19, 12.7, -12.7, 0.0],
                         dtype=torch.float64)
    for dst in (EValueType.int64, EValueType.uint64):
        got = cast_plane(edges.to(cuda_device), EValueType.double, dst)
        want = cast_plane(edges, EValueType.double, dst)
        assert torch.equal(got.cpu(), want), dst


@pytest.fixture(scope="module")
def nccl_mesh():
    """A mesh of one rank over NCCL on the card, for this module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL has no CPU mode")
    from ytsaurus_tpu_torch.parallel.mesh import destroy_mesh, make_mesh
    mesh = make_mesh("cuda")
    yield mesh
    destroy_mesh()


@pytest.mark.parametrize("path", ["q1", "q18_shuffle", "q3", "q3_partitioned"])
def test_mesh_paths_over_nccl_match_the_cpu(nccl_mesh, path):
    """The gather merge, the shuffled GROUP BY and the broadcast and
    partitioned joins at world size 1 over NCCL, against the same query
    through the CPU port's evaluator; the sorting paths through the radix
    kernels."""
    from ytsaurus_tpu_torch.chunks.columnar import chunk_from_numpy
    from ytsaurus_tpu_torch.models import tpch
    from ytsaurus_tpu_torch.parallel.distributed import (
        DistributedEvaluator,
        ShardedTable,
    )
    from ytsaurus_tpu_torch.query.builder import build_query
    query, kwargs = {"q1": (tpch.Q1, {}),
                     "q18_shuffle": (tpch.Q18_AGG, {"shuffle": True}),
                     "q3": (tpch.Q3, {}),
                     "q3_partitioned": (tpch.Q3, {"shuffle": True})}[path]
    tables = {p: _spec(c) for p, c in _q3_tables().items()}
    lineitem = chunk_from_numpy(**tables["//tpch/lineitem"], device="cpu")
    orders = chunk_from_numpy(**tables["//tpch/orders"],
                              device=nccl_mesh.device)
    table = ShardedTable.from_chunks(nccl_mesh, [lineitem])
    plan = build_query(query, {"//tpch/lineitem": lineitem.schema,
                               "//tpch/orders": orders.schema})
    rx.reset_launches()
    got = DistributedEvaluator(nccl_mesh).run(
        plan, table, {"//tpch/orders": orders}, **kwargs).to_rows()
    torch.cuda.synchronize()
    if path != "q1":
        assert rx.launches["radix_upsweep"] > 0
    want = _run_on("cpu", query, tables).to_rows()
    if path == "q1":
        def key(r):
            return r["l_returnflag"], r["l_linestatus"]
        got, want = sorted(got, key=key), sorted(want, key=key)
    _rows_match(got, want)


def test_sort_table_over_nccl_matches_the_cpu(nccl_mesh):
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.operations.sort_op import sort_chunk
    from ytsaurus_tpu_torch.parallel.distributed import ShardedTable
    from ytsaurus_tpu_torch.parallel.shuffle import sort_table
    from ytsaurus_tpu_torch.schema import TableSchema
    rng = np.random.default_rng(5)
    schema = TableSchema.make([("k", "int64"), ("p", "double")])
    arrays = {"k": rng.integers(0, 1 << 40, 300_000),
              "p": rng.random(300_000)}
    chunk = ColumnarChunk.from_arrays(schema, arrays, device="cpu")
    rx.reset_launches()
    out = sort_table(ShardedTable.from_chunks(nccl_mesh, [chunk]), ["k"])
    torch.cuda.synchronize()
    assert rx.launches["radix_onesweep"] > 0
    want = sort_chunk(chunk, ["k"], device="cpu")
    assert out.row_counts == [300_000]
    assert out.local_chunk().to_rows() == want.to_rows()


SELECT_QUERY = ("g, sum(v) AS s, count(*) AS c FROM [//t] WHERE v < 900 "
                "GROUP BY g")


def _select_arrays(n_chunks: int = 8, rows: int = 20_000) -> list:
    """SELECT_8's columns at a small size: k arange, g in [0, 10000), v in
    [0, 1000), per chunk."""
    rng = np.random.default_rng(8)
    return [{"k": np.arange(rows) + i * rows,
             "g": rng.integers(0, 10_000, rows),
             "v": rng.integers(0, 1000, rows)} for i in range(n_chunks)]


def _select_chunks(device) -> list:
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.schema import TableSchema
    schema = TableSchema.make([("k", "int64", "ascending"), ("g", "int64"),
                               ("v", "int64")])
    return [ColumnarChunk.from_arrays(schema, a, device=device)
            for a in _select_arrays()]


def test_multi_chunk_select_on_the_card_matches_the_cpu(cuda_device):
    """SELECT_8's query over 8 chunks through coordinate_and_execute: the
    card's groups are the CPU's, the counts read once for all shards."""
    from ytsaurus_tpu_torch.query.builder import build_query
    from ytsaurus_tpu_torch.query.coordinator import coordinate_and_execute
    from ytsaurus_tpu_torch.query.engine import evaluator as ev
    cpu_chunks = _select_chunks("cpu")
    plan = build_query(SELECT_QUERY, {"//t": cpu_chunks[0].schema})
    rx.reset_launches()
    before = ev.count_reads()
    got = coordinate_and_execute(plan, _select_chunks(cuda_device),
                                 evaluator=ev.Evaluator(cuda_device))
    torch.cuda.synchronize()
    assert ev.count_reads() - before == 2
    assert rx.launches["radix_upsweep"] > 0
    want = coordinate_and_execute(plan, cpu_chunks,
                                  evaluator=ev.Evaluator("cpu"))

    def key(r):
        return r["g"]
    _rows_match(sorted(got.to_rows(), key=key),
                sorted(want.to_rows(), key=key))


def test_prefetch_stages_onto_the_evaluators_device(cuda_device):
    """A lazy shard that stages onto "cuda" lands on the evaluator's card
    (the last one, when there are several), not on cuda:0: the prefetch
    thread names the device."""
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.query.builder import build_query
    from ytsaurus_tpu_torch.query.coordinator import coordinate_and_execute
    from ytsaurus_tpu_torch.query.engine.evaluator import Evaluator
    from ytsaurus_tpu_torch.schema import TableSchema
    device = torch.device("cuda", torch.cuda.device_count() - 1)
    schema = TableSchema.make([("k", "int64", "ascending"), ("g", "int64"),
                               ("v", "int64")])
    seen = []

    def stage(arrays):
        seen.append(torch.cuda.current_device())
        return ColumnarChunk.from_arrays(schema, arrays, device="cuda")

    plan = build_query(SELECT_QUERY, {"//t": schema})
    got = coordinate_and_execute(
        plan, [(lambda a=a: stage(a)) for a in _select_arrays(4, 5000)],
        evaluator=Evaluator(device))
    assert seen == [device.index] * 4
    assert sum(r["c"] for r in got.to_rows()) > 0


def test_whole_plan_q18_over_nccl_matches_the_cpu(nccl_mesh):
    """WP_Q18 at a small size: Q18_AGG through coordinate_distributed at
    world size 1 over NCCL, served by the whole-plan rung (exchange-states)
    at one host read, equal to the CPU port's local evaluator."""
    from ytsaurus_tpu_torch.chunks.columnar import chunk_from_numpy
    from ytsaurus_tpu_torch.models import tpch
    from ytsaurus_tpu_torch.parallel.distributed import (
        DistributedEvaluator,
        coordinate_distributed,
        host_sync_count,
    )
    from ytsaurus_tpu_torch.query.builder import build_query
    from ytsaurus_tpu_torch.query.statistics import QueryStatistics
    tables = {p: _spec(c) for p, c in _q3_tables().items()}
    lineitem = chunk_from_numpy(**tables["//tpch/lineitem"], device="cpu")
    plan = build_query(tpch.Q18_AGG, {"//tpch/lineitem": lineitem.schema})
    de = DistributedEvaluator(nccl_mesh)
    want = _run_on("cpu", tpch.Q18_AGG, {
        "//tpch/lineitem": tables["//tpch/lineitem"]}).to_rows()
    for _ in range(2):
        stats = QueryStatistics()
        before = host_sync_count()
        rx.reset_launches()
        got = coordinate_distributed(plan, nccl_mesh, [lineitem],
                                     evaluator=de, stats=stats).to_rows()
        torch.cuda.synchronize()
        assert stats.whole_plan == 1
        assert host_sync_count() - before == 1 + stats.whole_plan_retries
        assert rx.launches["radix_onesweep"] > 0
        _rows_match(got, want)
    assert stats.whole_plan_retries == 0


class _CountingTimestamps:
    """Timestamps 1, 2, 3, ...: two runs of one history get the same."""

    def __init__(self):
        self._last = 0

    def generate(self) -> int:
        self._last += 1
        return self._last

    def last(self) -> int:
        return self._last


def _dyn_history(device, root):
    """A small dynamic table driven through transactions, two flushes,
    a compaction and more writes, on `device`; returns the tablet."""
    import random

    from ytsaurus_tpu_torch.chunks.store import FsChunkStore
    from ytsaurus_tpu_torch.schema import TableSchema
    from ytsaurus_tpu_torch.tablet.tablet import Tablet
    from ytsaurus_tpu_torch.tablet.transactions import TransactionManager
    schema = TableSchema.make([("k", "int64", "ascending"), ("g", "int64"),
                               ("s", "string"), ("v", "uint64")])
    tablet = Tablet(schema, FsChunkStore(root), device=device)
    txm = TransactionManager(_CountingTimestamps())
    rng = random.Random(4)
    for step in range(6):
        tx = txm.start()
        keys = rng.sample(range(4000), 1500)
        txm.write_rows(tx, tablet, [
            {"k": k, "g": k % 7, "s": f"s{k % 13}", "v": 2**63 + k}
            for k in keys[:1000]])
        txm.write_rows(tx, tablet, [{"k": k, "v": step} for k in
                                    keys[1000:1400]], update=True)
        txm.delete_rows(tx, tablet, [(k,) for k in keys[1400:]])
        txm.commit(tx)
        if step in (1, 3):
            tablet.flush()
        if step == 4:
            tablet.compact(retention_timestamp=txm.timestamps.last() - 1)
    return tablet


def test_tablet_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """Flush, compaction and snapshot reads of a tablet on the card (its
    sorts through the radix kernels) equal the same tablet on the CPU."""
    from ytsaurus_tpu_torch.config import TabletConfig, set_tablet_config
    set_tablet_config(TabletConfig(vectorized_scan_min_rows=0))
    try:
        rx.reset_launches()
        gpu = _dyn_history(cuda_device, str(tmp_path / "gpu"))
        torch.cuda.synchronize()
        assert rx.launches["radix_upsweep"] > 0 and \
            rx.launches["radix_onesweep"] > 0
        cpu = _dyn_history("cpu", str(tmp_path / "cpu"))
        for a, b in zip(gpu.chunk_ids, cpu.chunk_ids):
            assert gpu.chunk_store.get_blob(a) == cpu.chunk_store.get_blob(b)
        got = gpu.read_snapshot()
        assert got.device.type == cuda_device.type
        assert got.to_rows() == cpu.read_snapshot().to_rows()
        keys = [(k,) for k in range(0, 4000, 7)]
        assert gpu.lookup_rows(keys) == cpu.lookup_rows(keys)
    finally:
        set_tablet_config(None)


def test_deserialize_chunk_onto_the_card_matches_the_cpu(cuda_device):
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.chunks.encoding import (
        deserialize_chunk,
        serialize_chunk,
    )
    from ytsaurus_tpu_torch.schema import TableSchema
    schema = TableSchema.make([("k", "int64"), ("u", "uint64"),
                               ("d", "double"), ("b", "boolean"),
                               ("s", "string"),
                               ("e", "vector<float, 3>")])
    rows = [{"k": i, "u": 2**64 - 1 - i, "d": [float("nan"), -0.0, i][i % 3],
             "b": i % 2 == 0, "s": None if i % 5 == 0 else f"x{i % 9}",
             "e": [i, -i, 0.5]} for i in range(3000)]
    blob = serialize_chunk(ColumnarChunk.from_rows(schema, rows,
                                                   device="cpu"))
    cpu = deserialize_chunk(blob, device="cpu")
    gpu = deserialize_chunk(blob, device=cuda_device)
    assert gpu.device.type == cuda_device.type and \
        gpu.capacity == cpu.capacity
    for name, col in cpu.columns.items():
        other = gpu.columns[name]
        assert torch.equal(other.valid.cpu(), col.valid), name
        a, b = other.data.cpu(), col.data
        if a.is_floating_point():
            a, b = a.view(torch.int32 if a.dtype == torch.float32
                          else torch.int64), \
                b.view(torch.int32 if b.dtype == torch.float32
                       else torch.int64)
        assert torch.equal(a, b), name
    assert serialize_chunk(gpu) == blob


def test_erasure_and_replicated_reads_onto_the_card(cuda_device, tmp_path):
    """An erasure chunk repaired on read and a replicated chunk
    re-replicated from the card's planes give the CPU's rows and the same
    bytes on disk."""
    import os
    import shutil

    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.chunks.replicated import ReplicatedChunkStore
    from ytsaurus_tpu_torch.chunks.store import FsChunkStore
    from ytsaurus_tpu_torch.schema import TableSchema
    schema = TableSchema.make([("k", "int64"), ("s", "string"),
                               ("a", "any")])
    rows = [{"k": i, "s": f"s{i % 11}", "a": [i] if i % 3 else None}
            for i in range(5000)]
    chunk = ColumnarChunk.from_rows(schema, rows, device=cuda_device)
    store = FsChunkStore(str(tmp_path / "lrc"))
    cid = store.write_chunk(chunk, erasure="lrc_12_2_2")
    part = store._part_path(cid, 5)
    with open(part, "rb") as f:
        original = f.read()
    os.unlink(part)
    got = store.read_chunk(cid, device=cuda_device)
    assert got.device.type == cuda_device.type
    assert got.to_rows() == store.read_chunk(cid, device="cpu").to_rows() \
        == chunk.to_rows()
    with open(part, "rb") as f:
        assert f.read() == original
    rs = ReplicatedChunkStore([str(tmp_path / f"loc{i}") for i in range(4)],
                              replication_factor=3)
    cid = rs.write_chunk(chunk)
    holder = next(s for s in rs._placement(cid) if s.exists(cid))
    blob = holder.get_blob(cid)
    shutil.rmtree(holder.root)
    os.makedirs(holder.root)
    assert rs.read_chunk(cid, device=cuda_device).to_rows() == \
        chunk.to_rows()
    assert holder.get_blob(cid) == blob


def test_ordered_tablet_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    from ytsaurus_tpu_torch.chunks.store import FsChunkStore
    from ytsaurus_tpu_torch.query import select_rows
    from ytsaurus_tpu_torch.schema import TableSchema
    from ytsaurus_tpu_torch.tablet.ordered import OrderedTablet
    schema = TableSchema.make([("p", "int64"), ("v", "double"),
                               ("s", "string")])
    tablets = [OrderedTablet(schema, FsChunkStore(str(tmp_path / str(d))),
                             device=d) for d in (cuda_device, "cpu")]
    rng = np.random.default_rng(4)
    for b in range(30):
        rows = [{"p": int(rng.integers(0, 9)), "v": float(rng.normal()),
                 "s": f"m{int(rng.integers(0, 40))}"} for _ in range(200)]
        for t in tablets:
            t.append_rows(rows, b + 1)
            if b % 8 == 7:
                t.flush()
    for t in tablets:
        t.trim_rows(1500)
    gpu, cpu = tablets
    assert gpu.read_rows(1000, 3000) == cpu.read_rows(1000, 3000)
    for ts in (None, 17):
        snap = gpu.snapshot(ts)
        assert snap.device.type == cuda_device.type
        assert snap.to_rows() == cpu.snapshot(ts).to_rows()
        query = "p, s FROM [//q] ORDER BY v DESC LIMIT 25"
        assert select_rows(query, {"//q": snap},
                           device=cuda_device).to_rows() == \
            select_rows(query, {"//q": cpu.snapshot(ts)},
                        device="cpu").to_rows()
