"""Parity of the port's sort and segment primitives with the JAX package's
`ops/segments.py`, on the CPU: the same numpy planes (with nulls, NaN, ±0.0,
±inf and the int64 extremes) go through both. Integers, row orders and
group sets must match exactly; doubles agree to rtol=1e-9, since the two
sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ytsaurus_tpu.ops import segments as ref
from ytsaurus_tpu.schema import EValueType as RefType
from ytsaurus_tpu_torch.ops import segments as port
from ytsaurus_tpu_torch.schema import EValueType

# The tier-1 suite runs several workers side by side: torch's default of
# one (spinning) thread per core would crowd out their timing tests.
torch.set_num_threads(1)

N = 1000
_I64 = np.iinfo(np.int64)


def _valid(seed: int, n: int = N) -> np.ndarray:
    return np.random.default_rng(seed).random(n) > 0.2


def _plane(kind: str, seed: int, n: int = N) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "bool":
        return rng.random(n) > 0.5
    if kind == "int32":
        return rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(
            np.int32)
    if kind == "int64":
        x = rng.integers(-50, 50, n).astype(np.int64)
        x[rng.integers(0, n, 30)] = _I64.min
        x[rng.integers(0, n, 30)] = _I64.max
        x[rng.integers(0, n, 30)] = -1
        return x
    if kind == "uint64":
        x = rng.integers(0, 1 << 63, n, dtype=np.uint64)
        x[rng.integers(0, n, 200)] += np.uint64(1 << 63)
        x[rng.integers(0, n, 30)] = np.uint64((1 << 64) - 1)
        x[rng.integers(0, n, 30)] = 0
        return x
    if kind == "float64":
        x = rng.normal(size=n) * 10.0
        x[rng.integers(0, n, 40)] = np.round(x[rng.integers(0, n, 40)])
        specials = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf,
                    np.finfo(np.float64).max, -np.finfo(np.float64).max,
                    np.finfo(np.float64).tiny]
        for v in specials:
            x[rng.integers(0, n, 15)] = v
        return x
    if kind == "float32":
        with np.errstate(over="ignore"):
            return _plane("float64", seed, n).astype(np.float32)
    raise ValueError(kind)


def _t(x: np.ndarray) -> torch.Tensor:
    if x.dtype == np.uint64:
        x = x.view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_words(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w).astype(np.int64))


@pytest.mark.parametrize("kind", ["bool", "int32", "int64", "uint64",
                                  "float64", "float32"])
def test_monotone_u32_words(kind):
    data, valid = _plane(kind, 1), _valid(2)
    want = ref.monotone_u32_words(jnp.asarray(data), jnp.asarray(valid))
    got = port.monotone_u32_words(_t(data), _t(valid),
                                  unsigned=kind == "uint64")
    _assert_words(got, want)


@pytest.mark.parametrize("descending", [False, True])
def test_pack_key_planes_bits(descending):
    codes = np.random.default_rng(3).integers(0, 6, N).astype(np.int32)
    specs = [(codes, _valid(4), descending, 3),
             (_plane("bool", 5), _valid(6), not descending, 1),
             (_plane("int64", 7), _valid(8), descending, 64),
             (_plane("float64", 9), _valid(10), not descending, 64),
             (_plane("uint64", 11), _valid(12), descending, 64)]
    want_words, want_bits = ref.pack_key_planes_bits(
        [(jnp.asarray(d), jnp.asarray(v), desc, b)
         for d, v, desc, b in specs])
    got_words, got_bits = port.pack_key_planes_bits(
        [(_t(d), _t(v), desc, b, d.dtype == np.uint64)
         for d, v, desc, b in specs])
    assert got_bits == want_bits
    _assert_words(got_words, want_words)
    want_order = np.asarray(ref.packed_sort_indices(
        [(jnp.asarray(d), jnp.asarray(v), desc, b)
         for d, v, desc, b in specs]))
    got_order = port.packed_sort_indices(
        [(_t(d), _t(v), desc, b, d.dtype == np.uint64)
         for d, v, desc, b in specs])
    np.testing.assert_array_equal(got_order.numpy(), want_order)


@pytest.mark.parametrize("kinds", [("int64",), ("float64", "bool"),
                                   ("uint64", "int32")])
def test_hash_group_order(kinds):
    # Few distinct values per key, so that groups have many rows.
    planes = []
    for i, kind in enumerate(kinds):
        data = _plane(kind, 20 + i)
        if kind != "bool":
            data = data[np.random.default_rng(30 + i).integers(0, 12, N)]
        planes.append((data, _valid(40 + i)))
    mask = _valid(50)
    want = np.asarray(ref.hash_group_order(
        [(jnp.asarray(d), jnp.asarray(v)) for d, v in planes],
        jnp.asarray(mask)))
    got = port.hash_group_order(
        [(_t(d), _t(v), d.dtype == np.uint64) for d, v in planes], _t(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def _segments(num_segments: int, seed: int) -> np.ndarray:
    """Nondecreasing segment ids; a tail of rows past the last segment,
    as the general GROUP BY path parks its masked rows."""
    ids = np.sort(np.random.default_rng(seed).integers(0, num_segments, N))
    ids[-25:] = num_segments
    return ids.astype(np.int64)


_AGG_CASES = [(fn, kind) for fn in ("sum", "count", "first", "min", "max")
              for kind in ("int64", "float64")] + \
    [("min", "uint64"), ("max", "uint64"), ("min", "bool"), ("max", "bool"),
     ("first", "uint64")]


@pytest.mark.parametrize("num_segments", [7, 300])
@pytest.mark.parametrize("fn,kind", _AGG_CASES)
def test_segment_aggregate(fn, kind, num_segments):
    data, valid = _plane(kind, 60), _valid(61)
    seg = _segments(num_segments, 62)
    ref_type = {"int64": RefType.int64, "float64": RefType.double,
                "uint64": RefType.uint64, "bool": RefType.boolean}[kind]
    want, want_v = ref.segment_aggregate(
        fn, jnp.asarray(data), jnp.asarray(valid), jnp.asarray(seg),
        num_segments, ref_type, assume_sorted=True)
    got, got_v = port.segment_aggregate(
        fn, _t(data), _t(valid), _t(seg), num_segments,
        EValueType(ref_type.value))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    got, want = got.numpy(), np.asarray(want)
    live = np.asarray(want_v)
    if kind == "uint64":
        got = got.view(np.uint64)
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got[live], want[live], rtol=1e-9,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(got[live], want[live])


@pytest.mark.parametrize("by_kind", ["int64", "float64", "uint64"])
@pytest.mark.parametrize("take_max", [False, True])
def test_segment_arg_by(by_kind, take_max):
    value, value_valid = _plane("int64", 70), _valid(71)
    by = _plane(by_kind, 72)
    by = by[np.random.default_rng(73).integers(0, 20, N)]   # ties
    by_valid = _valid(74)
    seg = _segments(40, 75)
    want, want_v = ref.segment_arg_by(
        jnp.asarray(value), jnp.asarray(value_valid), jnp.asarray(by),
        jnp.asarray(by_valid), jnp.asarray(seg), 40, take_max=take_max,
        assume_sorted=True)
    got, got_v = port.segment_arg_by(
        _t(value), _t(value_valid), _t(by), _t(by_valid), _t(seg), 40,
        take_max=take_max, by_unsigned=by_kind == "uint64")
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    live = np.asarray(want_v)
    np.testing.assert_array_equal(got.numpy()[live], np.asarray(want)[live])


@pytest.mark.parametrize("kind", ["int64", "float64", "bool"])
def test_segment_distinct_count(kind):
    data = _plane(kind, 80)
    if kind != "bool":
        data = data[np.random.default_rng(81).integers(0, 40, N)]
    valid = _valid(82)
    seg = _segments(30, 83)
    want, _ = ref.segment_distinct_count(jnp.asarray(data),
                                         jnp.asarray(valid),
                                         jnp.asarray(seg), 30)
    got, got_v = port.segment_distinct_count(_t(data), _t(valid), _t(seg),
                                             30)
    assert bool(got_v.all())
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_compact_mask(density):
    mask = np.random.default_rng(90).random(N) < density
    want_order, want_total = ref.compact_mask(jnp.asarray(mask))
    got_order, got_total = port.compact_mask(_t(mask))
    np.testing.assert_array_equal(got_order.numpy(),
                                  np.asarray(want_order).astype(np.int64))
    assert int(got_total) == int(want_total)


def test_segment_boundaries():
    keys = np.sort(np.random.default_rng(95).integers(0, 50, N))
    key_valid = _valid(96)
    mask = np.ones(N, dtype=bool)
    mask[-40:] = False
    want_seg, want_n = ref.segment_boundaries(
        [(jnp.asarray(keys), jnp.asarray(key_valid))], jnp.asarray(mask))
    got_seg, got_n = port.segment_boundaries([(_t(keys), _t(key_valid))],
                                             _t(mask))
    np.testing.assert_array_equal(got_seg.numpy(), np.asarray(want_seg))
    assert int(got_n) == int(want_n)
