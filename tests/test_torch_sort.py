"""Parity of the port's Sort operation (`ytsaurus_tpu_torch`) with the JAX
package on the CPU: `sort_chunk` / `sort_chunks` against
`ytsaurus_tpu.operations.sort_op`, the partition pass (`_sample_keys`,
`quantile_pivots`, `_partition_block` over `_partition_ids`) against
`ytsaurus_tpu.ops.bigsort` / `ytsaurus_tpu.parallel.shuffle`, and
`external_sort` against `ytsaurus_tpu.ops.bigsort.external_sort` on the
cases of tests/test_bigsort.py and on uint64, double and bool keys.

The same chunk bytes go to both packages (carried across with
`chunk_from_numpy`); every output plane must match bit for bit, padding
included, and so must every `SpillStats` field. The port runs with
`device="cpu"`, where its radix kernels run as their plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_query import _to_port
from ytsaurus_tpu.chunks import ColumnarChunk as RefChunk
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.operations import sort_op as ref_sort_op
from ytsaurus_tpu.ops import bigsort as ref_bigsort
from ytsaurus_tpu.parallel import shuffle as ref_shuffle
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.operations import sort_op
from ytsaurus_tpu_torch.ops import bigsort
from ytsaurus_tpu_torch.ops import radix as rx
from ytsaurus_tpu_torch.parallel import shuffle

# The tier-1 suite runs several workers side by side: torch's default of
# one (spinning) thread per core would crowd out their timing tests.
torch.set_num_threads(1)

CPU = "cpu"


def _planes_equal(got, want) -> None:
    """A port chunk against a JAX chunk: schema, row count, dictionaries
    and every plane bit for bit (doubles by their bits, so NaN and -0.0
    count)."""
    spec = [(c.name, c.type.value, c.sort_order.value
             if c.sort_order is not None else None) for c in want.schema]
    assert [(c.name, c.type.value, c.sort_order.value
             if c.sort_order is not None else None)
            for c in got.schema] == spec
    assert got.row_count == want.row_count
    assert got.capacity == want.capacity
    planes = got.to_numpy()["planes"]
    for name, col in want.columns.items():
        data, valid = planes[name]
        ref_data = np.asarray(col.data)
        assert data.dtype.itemsize == ref_data.dtype.itemsize, name
        np.testing.assert_array_equal(valid, np.asarray(col.valid), name)
        np.testing.assert_array_equal(
            data.view(f"u{data.dtype.itemsize}"),
            ref_data.view(f"u{ref_data.dtype.itemsize}"), name)
        want_vocab = col.dictionary
        got_vocab = got.columns[name].dictionary
        if want_vocab is None:
            assert got_vocab is None, name
        else:
            assert list(got_vocab) == list(want_vocab), name


def _ref_chunk(cols, rows) -> RefChunk:
    return RefChunk.from_rows(RefSchema.make(cols), rows)


# --- sort_chunk / sort_chunks ------------------------------------------------

_DOUBLES = [float("nan"), -float("nan"), 0.0, -0.0, float("inf"),
            -float("inf"), 1.5, -2.25, 1e300, -1e-300]


def _rows(kind: str, n: int, seed: int) -> tuple[list, list]:
    rng = np.random.default_rng(seed)

    def maybe(v):
        return None if rng.random() < 0.15 else v

    if kind == "int64":
        cols = [("k", "int64"), ("p", "double")]
        rows = [(maybe(int(rng.integers(-5, 6)) * (1 << 60)
                       + int(rng.integers(0, 3))), float(i))
                for i in range(n)]
    elif kind == "uint64":
        cols = [("k", "uint64"), ("p", "int64")]
        pool = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 5, (1 << 64) - 1]
        rows = [(maybe(pool[int(rng.integers(0, len(pool)))]), i)
                for i in range(n)]
    elif kind == "double":
        cols = [("k", "double"), ("p", "int64")]
        rows = [(maybe(_DOUBLES[int(rng.integers(0, len(_DOUBLES)))]), i)
                for i in range(n)]
    elif kind == "bool":
        cols = [("k", "boolean"), ("p", "int64")]
        rows = [(maybe(bool(rng.integers(0, 2))), i) for i in range(n)]
    elif kind == "string":
        words = ["", "a", "ab", "b", "zz", "édgé"]
        cols = [("k", "string"), ("p", "int64")]
        rows = [(maybe(words[int(rng.integers(0, len(words)))]), i)
                for i in range(n)]
    else:
        raise AssertionError(kind)
    return cols, rows


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("kind", ["int64", "uint64", "double", "bool",
                                  "string"])
def test_sort_chunk_matches_the_reference(kind, descending):
    cols, rows = _rows(kind, 700, seed=len(kind))
    ref = _ref_chunk(cols, rows)
    want = ref_sort_op.sort_chunk(ref, ["k"], descending=descending)
    got = sort_op.sort_chunk(_to_port(ref), ["k"], descending=descending,
                             device=CPU)
    _planes_equal(got, want)
    if kind != "double":                 # NaN rows never compare equal
        assert got.to_rows() == want.to_rows()


def test_sort_chunk_two_keys_payload_first_in_schema():
    rng = np.random.default_rng(5)
    cols = [("v", "double"), ("a", "int64"), ("b", "string")]
    rows = [(float(rng.random()),
             None if rng.random() < 0.1 else int(rng.integers(0, 4)),
             None if rng.random() < 0.1 else "xyz"[int(rng.integers(0, 3))])
            for _ in range(900)]
    ref = _ref_chunk(cols, rows)
    for descending in (False, True):
        want = ref_sort_op.sort_chunk(ref, ["b", "a"], descending=descending)
        got = sort_op.sort_chunk(_to_port(ref), ["b", "a"],
                                 descending=descending, device=CPU)
        _planes_equal(got, want)
        assert got.to_tuples() == want.to_tuples()


def test_sort_chunks_unifies_dictionaries():
    rng = np.random.default_rng(8)
    cols = [("s", "string"), ("n", "int64")]
    parts = []
    for j, words in enumerate((["m", "a", "q"], ["b", "z"], ["a", "zz", ""])):
        rows = [(None if rng.random() < 0.1 else
                 words[int(rng.integers(0, len(words)))], j * 1000 + i)
                for i in range(300 + 50 * j)]
        parts.append(_ref_chunk(cols, rows))
    want = ref_sort_op.sort_chunks(parts, ["s", "n"])
    got = sort_op.sort_chunks([_to_port(p) for p in parts], ["s", "n"],
                              device=CPU)
    _planes_equal(got, want)
    assert got.to_rows() == want.to_rows()


def test_sort_chunk_descending_with_nulls_and_strings():
    """The twin of test_bigkey_paths.py's case, on the port."""
    rng = np.random.default_rng(11)
    n = 5000
    words = [b"w%04d" % i for i in range(200)]
    s = [words[int(rng.integers(0, 200))] if rng.random() > 0.1 else None
         for _ in range(n)]
    ref = _ref_chunk([("s", "string"), ("v", "int64")],
                     [(si, i) for i, si in enumerate(s)])
    got = sort_op.sort_chunk(_to_port(ref), ["s"], descending=True,
                             device=CPU)
    want = sorted(s, key=lambda x: (x is None, () if x is None else
                                    tuple(-b for b in x)))
    assert [r["s"] for r in got.to_rows()] == want
    _planes_equal(got, ref_sort_op.sort_chunk(ref, ["s"], descending=True))


def test_sort_chunk_checks_its_input():
    ref = _ref_chunk([("k", "int64")], [(3,), (1,), (2,)])
    chunk = _to_port(ref)
    with pytest.raises(YtError, match="No such sort column"):
        sort_op.sort_chunk(chunk, ["x"], device=CPU)
    with pytest.raises(YtError, match="Unsupported device"):
        sort_op.sort_chunk(chunk, ["k"], device="meta")
    assert [r["k"] for r in sort_op.sort_chunk(
        chunk, ["k"], device=CPU).to_rows()] == [1, 2, 3]


def test_sort_chunk_refuses_more_rows_than_the_permutation_holds(
        monkeypatch):
    """The int32 permutation bounds the sort: above it, a clear error,
    never a wrapped index."""
    ref = _ref_chunk([("k", "int64")], [(i,) for i in range(300)])
    monkeypatch.setattr(sort_op, "MAX_N", 255)
    with pytest.raises(YtError, match="at most 255 rows"):
        sort_op.sort_chunk(_to_port(ref), ["k"], device=CPU)


def test_chunk_transforms_match_the_reference():
    """`slice_rows`, `with_capacity` and `to_tuples`, which the Sort and
    MVCC paths use, against the JAX chunk's."""
    cols, rows = _rows("string", 300, seed=4)
    ref = _ref_chunk(cols, rows)
    chunk = _to_port(ref)
    for start, end in ((0, 300), (10, 150), (299, 400), (-5, 3), (200, 100)):
        _planes_equal(chunk.slice_rows(start, end),
                      ref.slice_rows(start, end))
    for capacity in (512, 384, 300):
        _planes_equal(chunk.with_capacity(capacity),
                      ref.with_capacity(capacity))
    assert chunk.with_capacity(chunk.capacity) is chunk
    with pytest.raises(YtError, match="below its row count"):
        chunk.with_capacity(128)
    assert chunk.to_tuples() == ref.to_tuples()


# --- the partition pass -----------------------------------------------------


def _keys_chunk(kind: str, n: int, seed: int) -> RefChunk:
    rng = np.random.default_rng(seed)
    if kind == "uint64":
        # Both sides of 2^63, each a double exactly: the reference's
        # pivot planes pass through float64 (see ops/bigsort.py).
        pool = [0, 7, 1 << 62, (1 << 63) - 1024, 1 << 63, (1 << 63) + 2048,
                (1 << 64) - 2048]
        keys = [pool[i] for i in rng.integers(0, len(pool), n)]
        cols = [("k", "uint64"), ("v", "int64")]
    elif kind == "double":
        keys = [_DOUBLES[i] for i in rng.integers(0, len(_DOUBLES), n)]
        cols = [("k", "double"), ("v", "int64")]
    elif kind == "bool":
        keys = [bool(b) for b in rng.integers(0, 2, n)]
        cols = [("k", "boolean"), ("v", "int64")]
    else:
        keys = [int(x) for x in rng.integers(-50, 50, n)]
        cols = [("k", "int64"), ("v", "int64")]
    rows = [(None if rng.random() < 0.1 else k, i)
            for i, k in enumerate(keys)]
    return _ref_chunk(cols, rows)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("kind", ["int64", "uint64", "double", "bool"])
def test_partition_pass_matches_the_reference(kind, descending):
    """Samples, pivots (unsigned order for uint64, the reference's `sorted`
    for NaN) and the routed ranges, row for row."""
    ref = _keys_chunk(kind, 1500, seed=3)
    ref_planes = ref_bigsort._host_planes(ref)
    planes = bigsort._host_planes(_to_port(ref))
    for name in ("k", "v"):
        np.testing.assert_array_equal(planes[name][1], ref_planes[name][1])
        assert planes[name][0].dtype == ref_planes[name][0].dtype
    samples = bigsort._sample_keys(planes, ["k"], 97)
    ref_samples = ref_bigsort._sample_keys(ref_planes, ["k"], 97)
    assert repr(samples) == repr(ref_samples)
    for n_ranges in (2, 5, 9):
        pivots = shuffle.quantile_pivots(samples, n_ranges, 1)
        assert repr(pivots) == repr(
            ref_shuffle.quantile_pivots(ref_samples, n_ranges, 1))
        got = bigsort._partition_block(planes, ["k"], pivots, n_ranges,
                                       descending, torch.device(CPU))
        want = ref_bigsort._partition_block(ref_planes, ["k"], pivots,
                                            n_ranges, descending)
        assert len(got) == len(want) == n_ranges
        for g, w in zip(got, want):
            for name in ("k", "v"):
                assert g[name][0].dtype == w[name][0].dtype
                np.testing.assert_array_equal(
                    g[name][0].view(f"u{g[name][0].dtype.itemsize}"),
                    w[name][0].view(f"u{w[name][0].dtype.itemsize}"))
                np.testing.assert_array_equal(g[name][1], w[name][1])


def test_uint64_pivots_above_two_to_the_63_order_unsigned():
    """Keys on both sides of 2^63: the pivots and the ranges follow
    unsigned order (signed order would put 2^63 first)."""
    samples = [((True, v),) for v in
               (5, (1 << 63) + 1, 1 << 63, (1 << 64) - 1, 3, (1 << 63) - 1)]
    pivots = shuffle.quantile_pivots(samples, 3, 1)
    assert pivots == ref_shuffle.quantile_pivots(samples, 3, 1) == \
        [((True, (1 << 63) - 1),), ((True, (1 << 63) + 1),)]
    keys = np.array([0, (1 << 63) - 1, 1 << 63, (1 << 63) + 1,
                     (1 << 64) - 1], dtype=np.uint64)
    valid = np.ones(len(keys), dtype=bool)
    data = torch.from_numpy(keys.view(np.int64))
    rows = [shuffle._encode_key_plane(data, torch.from_numpy(valid),
                                      unsigned=True)]
    piv = [(torch.ones(2, dtype=torch.int8), shuffle.pivot_value_plane(
        np.array([(1 << 63) - 1, (1 << 63) + 1], dtype=np.uint64),
        torch.device(CPU)))]
    assert shuffle._partition_ids(rows, piv, 2).tolist() == [0, 1, 1, 2, 2]


def test_uint64_pivots_that_are_not_doubles_stay_exact():
    """uint64 pivots that no double holds (2^63 + 9, 2^64 - 2): each range
    holds exactly the keys between its two pivots, in unsigned order. The
    reference rounds such pivots through float64 (see ops/bigsort.py)."""
    rng = np.random.default_rng(13)
    pool = np.array([1, 5, (1 << 63) - 1, (1 << 63) + 9, (1 << 63) + 11,
                     (1 << 64) - 2, (1 << 64) - 1], dtype=np.uint64)
    keys = pool[rng.integers(0, len(pool), 3000)]
    planes = {"k": (keys, np.ones(len(keys), dtype=bool))}
    samples = bigsort._sample_keys(planes, ["k"], 512)
    pivots = shuffle.quantile_pivots(samples, 4, 1)
    bounds = [p[0][1] for p in pivots]
    assert bounds == sorted(bounds) and max(bounds) > (1 << 63)
    routed = bigsort._partition_block(planes, ["k"], pivots, 4, False,
                                      torch.device(CPU))
    edges = [0] + bounds + [1 << 64]
    for r, part in enumerate(routed):
        got = [int(k) for k in part["k"][0]] if part else []
        assert all(edges[r] <= k < edges[r + 1] for k in got), r
        assert len(got) == int(((keys >= np.uint64(edges[r])) & (
            keys.astype(object) < edges[r + 1])).sum())
    blocks = [_to_port(RefChunk.from_arrays(
        RefSchema.make([("k", "uint64")]), {"k": keys[lo:lo + 1000]}))
        for lo in range(0, 3000, 1000)]
    out = list(bigsort.external_sort(blocks, ["k"], budget_bytes=500 * 9 * 2,
                                     device=CPU))
    assert len(out) > 1
    got = np.concatenate([c.to_numpy()["planes"]["k"][0][:c.row_count]
                          for c in out])
    np.testing.assert_array_equal(got, np.sort(keys))


def test_partition_ids_against_the_reference_with_two_keys():
    import jax.numpy as jnp
    rng = np.random.default_rng(12)
    n = 600
    a = rng.integers(0, 4, n)
    b = rng.choice(np.array(_DOUBLES), n)
    va = rng.random(n) > 0.1
    vb = rng.random(n) > 0.1
    pivots = [((True, 1), (True, float("nan"))), ((True, 2), (False, 0.0)),
              ((True, 2), (True, -0.0)), ((True, 3), (True, 0.0))]
    ref_rows = [ref_shuffle._encode_key_plane(jnp.asarray(a),
                                              jnp.asarray(va)),
                ref_shuffle._encode_key_plane(jnp.asarray(b),
                                              jnp.asarray(vb))]
    rows = [shuffle._encode_key_plane(torch.from_numpy(a),
                                      torch.from_numpy(va)),
            shuffle._encode_key_plane(torch.from_numpy(b),
                                      torch.from_numpy(vb))]
    ref_piv, piv = [], []
    for ki, dtype in ((0, np.int64), (1, np.float64)):
        vals = np.array([p[ki][1] for p in pivots]).astype(dtype)
        ranks = np.array([int(p[ki][0]) for p in pivots], dtype=np.int8)
        ref_piv.append((jnp.asarray(ranks), jnp.asarray(vals)))
        piv.append((torch.from_numpy(ranks),
                    shuffle.pivot_value_plane(vals, torch.device(CPU))))
    want = np.asarray(ref_shuffle._partition_ids(ref_rows, ref_piv, 4))
    got = shuffle._partition_ids(rows, piv, 4).numpy()
    np.testing.assert_array_equal(got, want)


# --- external_sort: the cases of tests/test_bigsort.py -----------------------

SCHEMA_SPEC = [("k", "int64"), ("v", "double")]


def _blocks(keys: np.ndarray, block_rows: int = 5000,
            schema_spec=SCHEMA_SPEC) -> list:
    rng = np.random.default_rng(7)
    schema = RefSchema.make(schema_spec)
    out = []
    for lo in range(0, len(keys), block_rows):
        k = keys[lo: lo + block_rows]
        out.append(RefChunk.from_arrays(
            schema, {"k": k, "v": rng.random(len(k))}))
    return out


def _both(blocks: list, key_columns, **kwargs) -> tuple:
    """external_sort of the same blocks in both packages: every yielded
    chunk and every SpillStats field must agree. Returns the port's
    chunks and stats."""
    ref_stats = ref_bigsort.SpillStats()
    want = list(ref_bigsort.external_sort(blocks, key_columns,
                                          stats=ref_stats, **kwargs))
    stats = bigsort.SpillStats()
    got = list(bigsort.external_sort([_to_port(b) for b in blocks],
                                     key_columns, stats=stats, device=CPU,
                                     **kwargs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _planes_equal(g, w)
    assert [f.name for f in dataclasses.fields(stats)] == \
        [f.name for f in dataclasses.fields(ref_stats)]
    assert dataclasses.asdict(stats) == dataclasses.asdict(ref_stats)
    return got, stats


def _sorted_keys(chunks) -> np.ndarray:
    return np.concatenate([c.to_numpy()["planes"]["k"][0][: c.row_count]
                           for c in chunks])


def test_external_sort_uniform_keys_budget_respected():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 40, size=30_000)
    out, stats = _both(_blocks(keys), ["k"], budget_bytes=2000 * 18 * 2)
    assert (_sorted_keys(out) == np.sort(keys)).all()
    assert stats.ranges > 1
    assert stats.peak_range_rows <= stats.budget_rows
    assert max(c.row_count for c in out) <= stats.budget_rows


def test_external_sort_skewed_keys_resplit():
    rng = np.random.default_rng(1)
    keys = np.where(rng.random(30_000) < 0.9,
                    rng.integers(0, 10, 30_000),
                    rng.integers(0, 1 << 40, 30_000))
    out, stats = _both(_blocks(keys), ["k"], budget_bytes=2000 * 18 * 2)
    assert (_sorted_keys(out) == np.sort(keys)).all()
    assert stats.resplits > 0


def test_external_sort_descending_and_small_input():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1000, size=3_000)
    out, _ = _both(_blocks(keys, 1000), ["k"], budget_bytes=1 << 30,
                   descending=True)
    assert len(out) == 1
    assert (_sorted_keys(out) == np.sort(keys)[::-1]).all()


def test_external_sort_nulls_first_and_stats():
    rows = [{"k": None if i % 7 == 0 else int(i * 13 % 997),
             "v": float(i)} for i in range(3000)]
    schema = RefSchema.make(SCHEMA_SPEC)
    blocks = [RefChunk.from_rows(schema, rows[i * 1000:(i + 1) * 1000])
              for i in range(3)]
    out, stats = _both(blocks, ["k"], budget_bytes=500 * 18 * 2)
    flat = [r["k"] for c in out for r in c.to_rows()]
    n_null = sum(1 for r in rows if r["k"] is None)
    assert all(x is None for x in flat[:n_null])
    vals = [x for x in flat if x is not None]
    assert vals == sorted(vals)
    assert stats.spilled_rows == 3000
    assert sum(stats.range_rows) == 3000


def test_external_sort_multi_key():
    rng = np.random.default_rng(3)
    schema = RefSchema.make([("a", "int64"), ("b", "int64")])
    a = rng.integers(0, 8, size=20_000)
    b = rng.integers(0, 1 << 30, size=20_000)
    blocks = [RefChunk.from_arrays(
        schema, {"a": a[lo: lo + 4000], "b": b[lo: lo + 4000]})
        for lo in range(0, 20_000, 4000)]
    out, _ = _both(blocks, ["a", "b"], budget_bytes=3000 * 18 * 2)
    got = [(r["a"], r["b"]) for c in out for r in c.to_rows()]
    assert got == sorted(zip(a.tolist(), b.tolist()))


def test_external_sort_rejects_string_keys():
    schema = RefSchema.make([("s", "string")])
    chunk = RefChunk.from_rows(schema, [{"s": "x"}, {"s": "a"}])
    with pytest.raises(RefYtError):
        list(ref_bigsort.external_sort([chunk], ["s"], budget_bytes=100))
    with pytest.raises(YtError, match="numeric columns only"):
        list(bigsort.external_sort([_to_port(chunk)], ["s"],
                                   budget_bytes=100, device=CPU))


def test_external_sort_callable_suppliers():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1 << 40, size=10_000)
    blocks = _blocks(keys, 2500)
    ported = [_to_port(b) for b in blocks]
    calls = []
    suppliers = [lambda c=c, i=i: calls.append(i) or c
                 for i, c in enumerate(ported)]
    out = list(bigsort.external_sort(suppliers, ["k"],
                                     budget_bytes=2000 * 18 * 2, device=CPU))
    assert calls == [0, 1, 2, 3]
    assert (_sorted_keys(out) == np.sort(keys)).all()
    want = list(ref_bigsort.external_sort(
        [lambda c=c: c for c in blocks], ["k"], budget_bytes=2000 * 18 * 2))
    for g, w in zip(out, want):
        _planes_equal(g, w)


# --- external_sort: key types of the partition pass --------------------------


@pytest.mark.parametrize("kind,descending", [
    ("uint64", False), ("uint64", True), ("double", False),
    ("double", True), ("bool", False)])
def test_external_sort_key_types_match_the_reference(kind, descending):
    """uint64 keys on both sides of 2^63, doubles with NaN, ±0.0 and ±inf
    (the partition pass compares by value, the range sort by bits), and
    bool keys with nulls, under a budget that forces the partition pass.
    Which range each row lands in and the order inside it must match."""
    ref = _keys_chunk(kind, 4000, seed=21)
    blocks = [ref.slice_rows(lo, lo + 1000) for lo in range(0, 4000, 1000)]
    out, stats = _both(blocks, ["k"], budget_bytes=400 * 18 * 2,
                       descending=descending)
    assert stats.ranges + stats.resplits > 1
    assert sum(c.row_count for c in out) == 4000


def test_external_sort_raises_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    blocks = [_to_port(b) for b in _blocks(np.arange(10), 10)]
    with pytest.raises(YtError, match="no CUDA device"):
        bigsort.external_sort(blocks, ["k"])
    with pytest.raises(YtError, match="no CUDA device"):
        sort_op.sort_chunk(blocks[0], ["k"])


def test_external_sort_range_ids_take_the_radix_path(monkeypatch):
    """The stable argsort of the range ids is the port's radix sort, over
    a word as wide as the largest id."""
    seen = []
    real = bigsort.stable_argsort_u32

    def spy(words, word_bits=None):
        seen.append(list(word_bits))
        return real(words, word_bits)

    monkeypatch.setattr(bigsort, "stable_argsort_u32", spy)
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 1 << 40, size=6000)
    out = list(bigsort.external_sort([_to_port(b) for b in _blocks(keys)],
                                     ["k"], budget_bytes=1000 * 18 * 2,
                                     device=CPU))
    assert (_sorted_keys(out) == np.sort(keys)).all()
    n_ranges = 2 * -(-6000 // 1000)
    assert seen == [[n_ranges.bit_length()]] * 2
    assert rx.launches == {"radix_upsweep": 0, "radix_onesweep": 0}
