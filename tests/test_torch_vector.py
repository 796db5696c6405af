"""Parity of the port's vector search (`ytsaurus_tpu_torch`) with the JAX
package on the CPU: vector columns (round trip with nulls, write-path
rejections, statistics, `concat_chunks`), the distance functions,
`Evaluator.run_plan` with NEAREST and the batched `batched_nearest`.

Integer-component vectors make float32 distance arithmetic exact, so there
the two packages must agree exactly: the same rows in the same order and the
same distances, with one exception, a sanctioned divergence pinned by
`test_dot_ties_between_signed_zeros_go_to_the_lowest_row`: where the dot
metric ties +0.0 against -0.0 (XLA's product gives -1 * 0.0 = -0.0 and
`lax.top_k` ranks +0.0 above it; torch's product gives +0.0 for both),
the port takes the lowest tied row. On random normal vectors the port's float32 sums run in
another order than XLA's, so distances agree to rtol 1e-5, and the rows are
held by tests/test_vector.py's recall rule (exactly min(k, matching)
distinct rows, each at or better than the float64 oracle's k-th measure,
with the same relative slack of 1e-5 on that cut).

The local cases of tests/test_vector.py also run on the port, through the
reference test functions with their module's names pointed at the port's.
Left out, with the module each waits for: the wire and arrow round trips
and the `read_stats` backfill (chunks/encoding.py, formats.py), the SPMD
cases (the mesh paths) and the NearestBatcher and client cases (the
control plane).
"""

import numpy as np
import pytest
import torch

import tests.test_vector as ref_tests
from tests.test_torch_query import _to_port
from ytsaurus_tpu.chunks.columnar import ColumnarChunk as RefChunk
from ytsaurus_tpu.chunks.columnar import chunk_column_stats as ref_stats
from ytsaurus_tpu.chunks.columnar import concat_chunks as ref_concat
from ytsaurus_tpu.query import vector as ref_vector
from ytsaurus_tpu.query.builder import build_query as ref_build_query
from ytsaurus_tpu.query.engine.evaluator import Evaluator as RefEvaluator
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch import schema as port_schema
from ytsaurus_tpu_torch.chunks.columnar import (
    ColumnarChunk,
    chunk_column_stats,
    concat_chunks,
    merge_column_stats,
)
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.query.builder import build_query
from ytsaurus_tpu_torch.query.engine.evaluator import Evaluator
from ytsaurus_tpu_torch.query.vector import batched_nearest

torch.set_num_threads(1)

DIM = ref_tests.DIM
SPEC = [(c.name, c.type.value)
        + ((c.sort_order.value,) if c.sort_order is not None else ())
        for c in ref_tests.SCHEMA]
SCHEMA = port_schema.TableSchema.make(SPEC)
T = "//t"
RTOL = 1e-5

# --- the local cases of tests/test_vector.py ---------------------------------

LOCAL_CASES = [
    "test_vector_type_parses_and_interns",
    "test_vector_schema_survives_rebuild",
    "test_vector_key_column_rejected",
    "test_write_path_rejects_loudly",
    "test_storage_round_trip_with_nulls",
    "test_vector_stats_sealed_and_exact",
    "test_vector_stats_merge_is_exact_fold",
    "test_nearest_recall_unfiltered",
    "test_nearest_recall_filtered",
    "test_nearest_k_exceeds_matching_rows",
    "test_nearest_ties_admit_any_tied_row",
    "test_nearest_order_by_distance_equivalent",
    "test_params_arity_mismatch_is_loud",
    "test_nearest_surface_validation",
    "test_vector_column_guards",
]


class _PortChunk:
    @staticmethod
    def from_rows(schema, rows):
        return ColumnarChunk.from_rows(schema, rows, device="cpu")


@pytest.fixture
def _port_names(monkeypatch):
    for name, value in {
            "ColumnarChunk": _PortChunk, "SCHEMA": SCHEMA,
            "Evaluator": lambda: Evaluator("cpu"),
            "build_query": build_query, "YtError": YtError,
            "TableSchema": port_schema.TableSchema,
            "VectorType": port_schema.VectorType,
            "parse_type": port_schema.parse_type,
            "chunk_column_stats": chunk_column_stats,
            "concat_chunks": concat_chunks,
            "merge_column_stats": merge_column_stats}.items():
        monkeypatch.setattr(ref_tests, name, value)


def _local_params():
    params = []
    for name in LOCAL_CASES:
        fn = getattr(ref_tests, name)
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        grid = [{}]
        for mark in reversed(marks):
            names = [a.strip() for a in mark.args[0].split(",")]
            grid = [{**g, **dict(zip(names, v if len(names) > 1 else (v,)))}
                    for v in mark.args[1] for g in grid]
        for i, kwargs in enumerate(grid):
            params.append(pytest.param(name, kwargs, id=f"{name}[{i}]"
                                       if len(grid) > 1 else name))
    return params


@pytest.mark.parametrize("name,kwargs", _local_params())
def test_reference_local_case(name, kwargs, _port_names):
    getattr(ref_tests, name)(**kwargs)


# --- vector columns against the JAX package ----------------------------------


def _rows(n=40, seed=0, null_every=7, integer=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if null_every and i % null_every == 0:
            emb = None
        elif integer:
            emb = [float(x) for x in rng.integers(-6, 7, DIM)]
        else:
            emb = [float(x) for x in rng.standard_normal(DIM)]
        out.append({"k": i, "g": i % 5, "emb": emb,
                    "v": int(rng.integers(0, 100))})
    return out


def _both(rows):
    return (RefChunk.from_rows(ref_tests.SCHEMA, rows),
            ColumnarChunk.from_rows(SCHEMA, rows, device="cpu"))


def test_vector_planes_match_the_reference():
    """from_rows builds the reference's planes bit for bit, the planes
    cross through chunk_from_numpy / to_numpy, and every transform keeps
    the (capacity, dim) plane."""
    ref_chunk, chunk = _both(_rows(200, seed=1))
    np.testing.assert_array_equal(chunk.columns["emb"].data.numpy(),
                                  np.asarray(ref_chunk.columns["emb"].data))
    np.testing.assert_array_equal(chunk.columns["emb"].valid.numpy(),
                                  np.asarray(ref_chunk.columns["emb"].valid))
    assert chunk.to_rows() == ref_chunk.to_rows()
    carried = _to_port(ref_chunk)
    assert carried.to_rows() == ref_chunk.to_rows()
    back = chunk.to_numpy()["planes"]["emb"][0]
    assert back.shape == (chunk.capacity, DIM) and back.dtype == np.float32
    assert chunk.with_capacity(512).to_rows() == chunk.to_rows()
    assert chunk.slice_rows(30, 90).to_rows() == \
        ref_chunk.slice_rows(30, 90).to_rows()


def test_vector_from_arrays_and_bad_planes():
    arr = np.random.default_rng(2).standard_normal((50, DIM),
                                                   dtype=np.float32)
    schema = port_schema.TableSchema.make([("k", "int64"),
                                           ("emb", f"vector<float,{DIM}>")])
    chunk = ColumnarChunk.from_arrays(schema, {"k": np.arange(50),
                                               "emb": arr}, device="cpu")
    ref_chunk = RefChunk.from_arrays(
        RefSchema.make([("k", "int64"), ("emb", f"vector<float,{DIM}>")]),
        {"k": np.arange(50), "emb": arr})
    assert chunk.to_rows() == ref_chunk.to_rows()
    bad = arr.copy()
    bad[3, 2] = np.inf
    with pytest.raises(YtError, match="Non-finite"):
        ColumnarChunk.from_arrays(schema, {"k": np.arange(50), "emb": bad},
                                  device="cpu")
    with pytest.raises(YtError, match="needs a"):
        ColumnarChunk.from_arrays(schema, {"k": np.arange(50),
                                           "emb": arr[:, :3]}, device="cpu")


def test_vector_stats_and_concat_match_the_reference():
    rows = _rows(90, seed=3, null_every=11, integer=False)
    parts = [rows[i::3] for i in range(3)]
    ref_parts = [RefChunk.from_rows(ref_tests.SCHEMA, p) for p in parts]
    port_parts = [ColumnarChunk.from_rows(SCHEMA, p, device="cpu")
                  for p in parts]
    for ref_chunk, chunk in zip(ref_parts, port_parts):
        want, got = ref_stats(ref_chunk)["emb"], chunk_column_stats(chunk)["emb"]
        assert got == want
    whole_ref = ref_concat(ref_parts)
    whole = concat_chunks(port_parts)
    assert whole.to_rows() == whole_ref.to_rows()
    assert chunk_column_stats(whole)["emb"] == ref_stats(whole_ref)["emb"]
    merged = merge_column_stats([chunk_column_stats(c) for c in port_parts])
    assert merged["emb"]["count"] == ref_stats(whole_ref)["emb"]["count"]


# --- distances, NEAREST and batched_nearest against the JAX package -----------

QUERY = [1.0, -2.0, 3.0, 0.0, 5.0, -1.0, 2.0, 4.0]


def _run_both(query, rows, params):
    ref_chunk, chunk = _both(rows)
    want = RefEvaluator().run_plan(
        ref_build_query(query, {T: ref_tests.SCHEMA}, params=params),
        ref_chunk).to_rows()
    got = Evaluator("cpu").run_plan(
        build_query(query, {T: SCHEMA}, params=params), chunk).to_rows()
    return got, want


@pytest.mark.parametrize("fn", ["l2_distance", "distance", "cosine_distance",
                                "dot_product"])
def test_distance_functions_exact_on_integer_vectors(fn):
    query = (f"k, {fn}(emb, ?) AS d, {fn}(emb, emb) AS s FROM [{T}] "
             "WHERE k < 30")
    got, want = _run_both(query, _rows(60, seed=4), [QUERY])
    assert got == want


@pytest.mark.parametrize("fn", ["l2_distance", "cosine_distance",
                                "dot_product"])
def test_distance_functions_on_normal_vectors(fn):
    rows = _rows(60, seed=5, integer=False)
    q = [float(x) for x in np.random.default_rng(6).standard_normal(DIM)]
    got, want = _run_both(f"k, {fn}(emb, ?) AS d FROM [{T}]", rows, [q])
    assert [r["k"] for r in got] == [r["k"] for r in want]
    for g, w in zip(got, want):
        if w["d"] is None:
            assert g["d"] is None
        else:
            assert g["d"] == pytest.approx(w["d"], rel=RTOL, abs=1e-6)


@pytest.mark.parametrize("query", [
    f"k, g, emb FROM [{T}] NEAREST(emb, ?, 8)",
    f"k FROM [{T}] WHERE g = 2 NEAREST(emb, ?, 8, 'cosine')",
    f"k FROM [{T}] ORDER BY dot_product(emb, ?) DESC LIMIT 8",
    f"k, l2_distance(emb, ?) AS d FROM [{T}] WHERE v < 50 "
    "ORDER BY l2_distance(emb, ?) OFFSET 2 LIMIT 5",
])
def test_nearest_queries_exact_on_integer_vectors(query):
    """Integer vectors tie often: both packages take the tied rows of
    lowest index, in the same order, with the vector plane carried
    through the top-k, the order and the compaction."""
    params = [QUERY] * query.count("?")
    got, want = _run_both(query, _rows(300, seed=7, null_every=9), params)
    assert got == want and len(got) > 0


def _oracle_cut(plane, valid, q, metric, k):
    """The float64 oracle: every valid row's measure and the k-th best."""
    x = plane[valid].astype(np.float64)
    qq = np.asarray(q, dtype=np.float64)
    if metric == "dot":
        m = x @ qq
    elif metric == "cosine":
        denom = np.linalg.norm(x, axis=1) * np.linalg.norm(qq)
        m = np.where(denom > 0, 1.0 - (x @ qq) / np.where(denom > 0, denom,
                                                            1.0), 1.0)
    else:
        m = np.sqrt(((x - qq) ** 2).sum(axis=1))
    rows = np.nonzero(valid)[0]
    measures = dict(zip(rows.tolist(), m.tolist()))
    ranked = sorted(m, reverse=(metric == "dot"))
    take = min(k, len(ranked))
    return measures, (ranked[take - 1] if take else None), take


def _assert_hits(hits, plane, valid, q, metric, k):
    measures, cut, take = _oracle_cut(plane, valid, q, metric, k)
    rows = [r for r, _ in hits]
    assert len(rows) == take and len(set(rows)) == take
    slack = RTOL * abs(cut) if cut is not None else 0.0
    for row, measure in hits:
        want = measures[row]
        assert measure == pytest.approx(want, rel=1e-4, abs=1e-5)
        if metric == "dot":
            assert want >= cut - slack
        else:
            assert want <= cut + slack


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("k,batch", [(1, 1), (8, 3), (64, 5)])
def test_batched_nearest_exact_on_integer_vectors(metric, k, batch):
    rows = _rows(500, seed=8, null_every=13)
    ref_chunk, chunk = _both(rows)
    queries = [[float(x) for x in r] for r in
               np.random.default_rng(9).integers(-6, 7, (batch, DIM))]
    want = ref_vector.batched_nearest(ref_chunk, "emb", queries, k, metric)
    got = batched_nearest(chunk, "emb", queries, k, metric, device="cpu")
    assert got == want


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_batched_nearest_on_normal_vectors(metric):
    n, dim, k = 2000, 64, 16
    rng = np.random.default_rng(10)
    plane = rng.standard_normal((n, dim), dtype=np.float32)
    schema = port_schema.TableSchema.make([("emb", f"vector<float,{dim}>")])
    chunk = ColumnarChunk.from_arrays(schema, {"emb": plane}, device="cpu")
    ref_chunk = RefChunk.from_arrays(
        RefSchema.make([("emb", f"vector<float,{dim}>")]), {"emb": plane})
    queries = rng.standard_normal((4, dim), dtype=np.float32).tolist()
    got = batched_nearest(chunk, "emb", queries, k, metric, device="cpu")
    want = ref_vector.batched_nearest(ref_chunk, "emb", queries, k, metric)
    valid = np.ones(n, dtype=bool)
    for q, g, w in zip(queries, got, want):
        _assert_hits(g, plane, valid, q, metric, k)
        _assert_hits(w, plane, valid, q, metric, k)


def test_batched_nearest_k_above_matching_rows_and_errors():
    rows = _rows(20, seed=11, null_every=2)
    ref_chunk, chunk = _both(rows)
    got = batched_nearest(chunk, "emb", [QUERY], 50, device="cpu")
    assert got == ref_vector.batched_nearest(ref_chunk, "emb", [QUERY], 50)
    assert len(got[0]) == 10
    assert batched_nearest(chunk, "emb", [], 4, device="cpu") == []
    with pytest.raises(YtError, match="metric"):
        batched_nearest(chunk, "emb", [QUERY], 4, "hamming", device="cpu")
    with pytest.raises(YtError, match="not a vector"):
        batched_nearest(chunk, "v", [QUERY], 4, device="cpu")
    with pytest.raises(YtError, match="shape"):
        batched_nearest(chunk, "emb", [QUERY[:3]], 4, device="cpu")
    with pytest.raises(YtError, match="Non-finite"):
        batched_nearest(chunk, "emb", [[float("nan")] * DIM], 4,
                        device="cpu")


@pytest.mark.parametrize("shape,k,high", [((1000,), 7, 5), ((4, 3000), 16, 3),
                                          ((3, 500), 8, 1000),
                                          ((2, 64), 64, 2)])
def test_topk_lowest_index_is_lax_top_k_set(shape, k, high):
    """The rows `topk_lowest_index` takes are the ones `lax.top_k` takes,
    ties toward the lowest index, with few ties and with many."""
    import jax
    import jax.numpy as jnp
    from ytsaurus_tpu_torch.query.engine.lowering import topk_lowest_index
    ranked = np.random.default_rng(k).integers(0, high, shape)
    want = np.sort(np.asarray(jax.lax.top_k(jnp.asarray(ranked), k)[1]),
                   axis=-1)
    got = topk_lowest_index(torch.from_numpy(ranked), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_dot_ties_between_signed_zeros_go_to_the_lowest_row():
    """A sanctioned divergence. Smallest input: a vector<float,1> column
    with rows [0.0] and [-0.0], query [-1.0], k 1, dot. Both dot products
    are zero; the port ranks them equal and takes row 0, the lowest tied
    row, in `batched_nearest` and in ORDER BY dot_product DESC LIMIT 1.
    The JAX package's product gives -0.0 for row 0, and its top-k ranks
    row 1's +0.0 above it."""
    spec = [("k", "int64"), ("emb", "vector<float,1>")]
    rows = [(0, [0.0]), (1, [-0.0])]
    ref_chunk = RefChunk.from_rows(RefSchema.make(spec), rows)
    chunk = _to_port(ref_chunk)
    assert batched_nearest(chunk, "emb", [[-1.0]], 1, "dot",
                           device="cpu") == [[(0, 0.0)]]
    assert ref_vector.batched_nearest(ref_chunk, "emb", [[-1.0]], 1,
                                      "dot") == [[(1, 0.0)]]
    query = f"k FROM [{T}] ORDER BY dot_product(emb, ?) DESC LIMIT 1"
    schema = port_schema.TableSchema.make(spec)
    got = Evaluator("cpu").run_plan(
        build_query(query, {T: schema}, params=[[-1.0]]), chunk).to_rows()
    want = RefEvaluator().run_plan(
        ref_build_query(query, {T: RefSchema.make(spec)}, params=[[-1.0]]),
        ref_chunk).to_rows()
    assert got == [{"k": 0}] and want == [{"k": 1}]
