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


def test_client_without_a_card_raises(tmp_path):
    """`connect` runs on the card unless asked for the CPU: without one it
    raises, it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from ytsaurus_tpu_torch.client import connect
    from ytsaurus_tpu_torch.errors import YtError
    with pytest.raises(YtError, match="no CUDA device"):
        connect(str(tmp_path))
    assert connect(str(tmp_path), device="cpu").cluster.device.type == "cpu"


def _client_script(client):
    from ytsaurus_tpu_torch.schema import TableSchema
    rng = np.random.default_rng(5)
    rows = [{"k": int(k), "g": int(g), "v": int(v)} for k, g, v in zip(
        rng.permutation(3000), rng.integers(0, 50, 3000),
        rng.integers(0, 1000, 3000))]
    for lo in range(0, 3000, 1000):
        client.write_table("//t", rows[lo:lo + 1000], append=lo > 0)
    client.write_table("//dim", [{"g": g, "name": f"n{g % 7}"}
                                 for g in range(50)])
    out = {"group": client.select_rows(
        "g, sum(v) AS s, count(*) AS c FROM [//t] WHERE v < 900 GROUP BY g "
        "ORDER BY g LIMIT 100"),
        "join": client.select_rows(
            "name, sum(v) AS s FROM [//t] JOIN [//dim] USING g "
            "GROUP BY name ORDER BY name LIMIT 10"),
        "range": client.select_rows("k, v FROM [//t] WHERE k >= 1000 AND "
                                    "k < 1010 ORDER BY k LIMIT 10"),
        "pruned": client.last_query_statistics.shards_pruned}
    op = client.run_sort("//t", "//s", sort_by=["g", "k"])
    out["sort"] = (op.state, client.read_table("//s"),
                   client.get("//s/@sorted_by"))
    schema = TableSchema.make([("k", "int64", "ascending"), ("v", "int64"),
                               ("e", "vector<float, 4>")], unique_keys=True)
    client.create("table", "//d", attributes={"schema": schema,
                                              "dynamic": True})
    client.mount_table("//d")
    client.insert_rows("//d", [{"k": i, "v": i * 3,
                                "e": [float(i % 5), 1.0, -1.0, float(i)]}
                               for i in range(200)])
    out["lookup"] = client.lookup_rows("//d", [(4,), (500,), (7,)])
    out["nearest"] = [(r["k"], r["$distance"]) for r in client.nearest_rows(
        "//d", "e", [1.0, 1.0, -1.0, 10.0], 4)]
    client.unmount_table("//d")
    client.mount_table("//d")
    out["after_flush"] = client.select_rows(
        "sum(v) AS s FROM [//d] GROUP BY 1 AS one")
    return out


def test_client_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """`connect()` with no device puts the cluster on the card; its
    selects, join, sort, lookups and NEAREST answer as the CPU's."""
    from ytsaurus_tpu_torch.client import connect
    gpu = connect(str(tmp_path / "gpu"))
    assert gpu.cluster.device.type == "cuda"
    assert gpu.cluster.evaluator.device.type == "cuda"
    assert gpu.cluster.chunk_cache.device.type == "cuda"
    before = dict(rx.launches)
    got = _client_script(gpu)
    assert rx.launches["radix_upsweep"] > before["radix_upsweep"]
    want = _client_script(connect(str(tmp_path / "cpu"), device="cpu"))
    assert got.keys() == want.keys()
    for key in got:
        if key == "nearest":
            assert [k for k, _ in got[key]] == [k for k, _ in want[key]]
            np.testing.assert_allclose([d for _, d in got[key]],
                                       [d for _, d in want[key]],
                                       rtol=1e-5)
        else:
            assert got[key] == want[key], key


def _ops_derived_script(client, root2):
    """Reduce, map-reduce and a command map; a replicated table with an
    async replica on a second root; an index; a view over a queue."""
    from ytsaurus_tpu_torch.schema import TableSchema
    rng = np.random.default_rng(11)
    rows = [{"k": int(k), "g": int(g) * 2654435761 % (1 << 40),
             "v": int(v)} for k, g, v in zip(
        rng.permutation(4000), rng.integers(0, 300, 4000),
        rng.integers(0, 1000, 4000))]
    client.write_table("//in", rows)
    client.run_sort("//in", "//sorted", sort_by=["g", "k"])
    out = {}
    op = client.run_reduce(
        lambda key, rs: [{"g": key["g"], "s": sum(r["v"] for r in rs),
                          "c": len(rs)}],
        "//sorted", "//red", reduce_by="g", job_count=5)
    out["reduce"] = (op.result, sorted(client.read_table("//red"),
                                       key=lambda r: r["g"]))
    op = client.run_map_reduce(
        lambda rs: [{"g": r["g"], "v2": 2 * r["v"]} for r in rs],
        lambda key, rs: [{"g": key["g"], "s": sum(r["v2"] for r in rs)}],
        "//in", "//mr", reduce_by="g", partition_count=4)
    out["map_reduce"] = (op.result, sorted(client.read_table("//mr"),
                                           key=lambda r: r["g"]))
    op = client.run_map("cat", "//in", "//cat", format="json")
    out["map_cmd"] = sorted(r["k"] for r in client.read_table("//cat"))
    schema = TableSchema.make([("k", "int64", "ascending"), ("v", "int64")],
                              unique_keys=True)
    down = client.table_replicator.replica_client(root2)
    for c, path in ((client, "//t"), (down, "//r")):
        c.create("table", path, attributes={"schema": schema,
                                            "dynamic": True})
        c.mount_table(path)
    client.create_table_replica("//t", "//r", cluster_root=root2,
                                mode="async")
    client.insert_rows("//t", [{"k": r["k"], "v": r["v"]}
                               for r in rows[:500]])
    out["replicated"] = client.table_replicator.replicate_step("//t")
    client.create_secondary_index("//t", "//t_by_v", ["v"])
    out["index"] = sorted(r["k"] for r in client.select_rows(
        f"k FROM [//t] WHERE v = {rows[0]['v']}"))
    qs = TableSchema.make([("g", "int64"), ("v", "int64")])
    client.create("table", "//q", attributes={"schema": qs,
                                              "dynamic": True})
    client.mount_table("//q")
    client.create_materialized_view(
        "m", "g, sum(v) AS s, count(*) AS c FROM [//q] GROUP BY g",
        batch_rows=700)
    for lo in range(0, 4000, 1000):
        client.push_queue("//q", [{"g": r["g"], "v": r["v"]}
                                  for r in rows[lo:lo + 1000]])
        client.refresh_view("m")
    view = client.get_view("m")
    out["view"] = sorted((r["g"], r["s"], r["c"]) for r in
                         client.select_rows(f"g, s, c FROM "
                                            f"[{view['target']}]"))
    return out


def test_operations_and_derived_tables_on_the_card_match_the_cpu(
        cuda_device, tmp_path):
    """Reduce, map-reduce, a command map, replication, a secondary index
    and a view through `connect()` on the card answer as on the CPU, and
    the sorts under them launch the radix kernels."""
    from ytsaurus_tpu_torch.client import connect
    before = dict(rx.launches)
    got = _ops_derived_script(connect(str(tmp_path / "gpu")),
                              str(tmp_path / "gpu2"))
    assert rx.launches["radix_onesweep"] > before["radix_onesweep"]
    want = _ops_derived_script(connect(str(tmp_path / "cpu"), device="cpu"),
                               str(tmp_path / "cpu2"))
    assert got == want


def _front_script(client):
    """One REST select through HttpProxy, one driver call over RPC through
    TcpProxy, and one `engine="sql"` query with a FROM-subquery."""
    import json
    import urllib.request

    from ytsaurus_tpu_torch import rpc
    from ytsaurus_tpu_torch.server.http_proxy import HttpProxy
    from ytsaurus_tpu_torch.server.services import DriverService
    from ytsaurus_tpu_torch.server.tcp_proxy import TcpProxy
    rng = np.random.default_rng(6)
    client.write_table("//t", [{"k": i, "g": int(g), "v": int(v)}
                               for i, g, v in zip(range(4000),
                                                  rng.integers(0, 300, 4000),
                                                  rng.integers(0, 1000, 4000))])
    client.write_table("//dim", [{"g": g, "name": f"n{g % 11}"}
                                 for g in range(300)])
    proxy = HttpProxy(lambda user: client)
    proxy.start()
    try:
        req = urllib.request.Request(
            f"http://{proxy.address}/api/v4/select_rows",
            data=json.dumps({"query": "name, sum(v) AS s FROM [//t] JOIN "
                                      "[//dim] USING g GROUP BY name"}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            rest = sorted((r["name"], r["s"])
                          for r in json.loads(resp.read())["value"])
    finally:
        proxy.stop()
    server = rpc.RpcServer([DriverService(client)])
    server.start()
    tcp = TcpProxy([server.address]).start()
    channel = rpc.RetryingChannel(rpc.Channel(tcp.address, timeout=120))
    try:
        body, _ = channel.call("driver", "execute", {
            "command": "select_rows", "parameters": {
                "query": "k, v FROM [//t] WHERE k >= 100 AND k < 140"}})
        wire = sorted((r["k"], r["v"]) for r in body["result"])
    finally:
        channel.close()
        tcp.stop()
        server.stop()
    qt = client.query_tracker
    qid = qt.start_query(
        "SELECT g, total FROM (SELECT g, sum(v) AS total FROM `//t` "
        "GROUP BY g) ORDER BY total DESC LIMIT 7", engine="sql")
    assert qt.wait(qid, timeout=120)["state"] == "completed"
    return {"rest": rest, "wire": wire,
            "sql": qt.read_query_result(qid)}


def test_front_doors_on_the_card_match_the_cpu(cuda_device, tmp_path):
    """The REST select, the driver call over RPC and the SQL query answer
    on the card as on the CPU; the SQL subquery's chunk lies on the
    card."""
    from ytsaurus_tpu_torch.client import connect
    from ytsaurus_tpu_torch.ops import radix
    gpu = connect(str(tmp_path / "gpu"))
    cpu = connect(str(tmp_path / "cpu"), device="cpu")
    radix.reset_launches()
    got = _front_script(gpu)
    assert radix.launches["radix_onesweep"] > 0
    assert got == _front_script(cpu)


def test_cells_on_the_card_match_the_cpu(cuda_device, tmp_path):
    """A cluster on the card whose chunks live on data nodes reads them
    over RPC onto the card; a portal's cell opens on the primary's
    device; its select and a Sequoia resolve answer as on the CPU."""
    from ytsaurus_tpu_torch.chunks.store import FsChunkStore
    from ytsaurus_tpu_torch.client import YtClient, YtCluster, connect
    from ytsaurus_tpu_torch.cypress import multicell
    from ytsaurus_tpu_torch.cypress.sequoia import SequoiaResolver
    from ytsaurus_tpu_torch.rpc import RpcServer
    from ytsaurus_tpu_torch.server.remote_store import RpcChunkStore
    from ytsaurus_tpu_torch.server.services import DataNodeService

    nodes = [RpcServer([DataNodeService(
        FsChunkStore(str(tmp_path / f"loc{i}")), str(tmp_path / f"j{i}"))])
        for i in range(3)]
    for node in nodes:
        node.start()
    try:
        store = RpcChunkStore(lambda: [n.address for n in nodes])
        rows = [{"k": i, "g": i % 7, "v": i * 3} for i in range(5000)]

        def script(client) -> list:
            client.write_table("//t", rows)
            (cid,) = client.get("//t/@chunk_ids")
            planes_on = client.cluster.chunk_cache.get(cid).device.type
            cell_root = str(tmp_path / f"cell-{planes_on}")
            client.create("portal_entrance", "//cell",
                          attributes={"cell_root": cell_root})
            client.write_table("//cell/t", rows)
            cell = multicell.cell_client(client, cell_root)
            with multicell.as_cell_principal():
                got = multicell.delegate_for(client, "//cell/t", "read") \
                    .select_rows("g, sum(v) AS s FROM [//cell/t] GROUP BY g "
                                 "ORDER BY sum(v) DESC LIMIT 3")
            seq = SequoiaResolver(client).enable()
            return [planes_on, cell.cluster.device.type,
                    client.select_rows("g, sum(v) AS s FROM [//t] GROUP BY g"
                                       " ORDER BY g LIMIT 10"), got,
                    seq.resolve("//cell")["node_type"], seq.verify()]

        gpu = YtClient(YtCluster(str(tmp_path / "gpu"), chunk_store=store))
        got = script(gpu)
        want = script(connect(str(tmp_path / "cpu"), device="cpu"))
        assert got[:2] == ["cuda", "cuda"]
        assert got[2:] == want[2:]
        assert store.read_chunk(gpu.get("//t/@chunk_ids")[0]).device.type \
            == "cuda"
    finally:
        for node in nodes:
            node.stop()


def test_local_cluster_primary_runs_on_the_card(cuda_device, tmp_path):
    """A LocalCluster(device="cuda") primary daemon holds the card: its
    /query/device names it, and its GROUP BY (general path: keys past
    65,536) launches both radix kernels there, every launch held by the
    primary's device trace; this process's remote run_sort launches them
    here. Both answer as a CPU cluster does."""
    from ytsaurus_tpu_torch.environment import LocalCluster
    from ytsaurus_tpu_torch.remote_client import connect_remote
    rng = np.random.default_rng(11)
    rows = [{"k": int(k), "g": int(g), "v": int(v)} for k, g, v in zip(
        rng.permutation(4000), rng.integers(0, 1 << 40, 4000) % 97 << 20,
        rng.integers(0, 1000, 4000))]
    query = "g, sum(v) AS s, count(*) AS c FROM [//t] GROUP BY g"
    results = {}
    for device in ("cuda", "cpu"):
        with LocalCluster(str(tmp_path / device), n_nodes=1,
                          replication_factor=1, device=device) as cluster:
            client = connect_remote(cluster.primary_address, device=device)
            client.write_table("//t", rows)
            before = dict(rx.launches)
            op = client.run_sort("//t", "//s", sort_by=["g", "k"])
            sorted_rows = client.read_table("//s")
            local = {k: rx.launches[k] - before[k] for k in before}
            if device == "cuda":
                first = client.get_orchid("/query/device")["launches"]
                client.get_orchid("/query/device/trace/start")
            got = sorted(client.select_rows(query), key=lambda r: r["g"])
            if device == "cuda":
                trace = client.get_orchid("/query/device/trace/stop")
            state = client.get_orchid("/query/device")
            client.close()
        results[device] = (op.state, sorted_rows, got)
        if device == "cuda":
            assert state["device"].startswith("cuda")
            assert state["name"] == torch.cuda.get_device_name(0)
            assert min(state["launches"].values()) > 0, state
            assert min(local.values()) > 0, local
            # The select's launches, held by the primary's own trace.
            assert trace["traced"] == {
                k: n - first[k] for k, n in state["launches"].items()}, \
                (trace, first, state)
            assert trace["device_busy_ms"] > 0 and \
                0 <= trace["idle_share"] < 1, trace
    assert results["cuda"] == results["cpu"]


def test_primary_without_the_card_exits_and_start_raises(cuda_device,
                                                         tmp_path,
                                                         monkeypatch):
    """With the card hidden (CUDA_VISIBLE_DEVICES=""), a --device cuda
    primary exits non-zero before it binds a port, and start() raises
    with the tail of its daemon.log: it never serves from the CPU."""
    from ytsaurus_tpu_torch.environment import LocalCluster
    from ytsaurus_tpu_torch.errors import YtError
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    cluster = LocalCluster(str(tmp_path / "c"), n_nodes=1,
                           replication_factor=1, device="cuda")
    with pytest.raises(YtError) as info:
        cluster.start(timeout=120)
    text = str(info.value)
    assert "exited rc=1" in text and "no CUDA device" in text, text
    assert not (tmp_path / "c" / "primary" / "primary.port").exists()
