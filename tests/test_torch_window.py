"""Parity of the port's window functions and WITH TOTALS with the JAX
package on the CPU, and of its segment scans with the JAX package's
`ops/segments.py`: the same tables go through the JAX `select_rows` (with
YT_TPU_SORT_ENGINE=pallas, its sorts in interpret mode) and the port's
`select_rows(..., device="cpu")`.

Row order, integers, strings and group sets must match exactly under the
canon of tests/harness.py; doubles agree to rtol=1e-9. Where a case carries
its expected rows, the port matches those as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ql_corpus import AGG
from tests.test_ql_corpus3 import TOTALS
from tests.test_ql_window import ERRORS, FRAMED, OFFSET, RANKING, SQL_DIALECT, WT
from tests.test_torch_joins import _run_both
from tests.test_torch_query import _to_port
from ytsaurus_tpu.chunks import ColumnarChunk as RefChunk
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.ops import segments as ref
from ytsaurus_tpu.query.engine.evaluator import select_rows as ref_select
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.models import tpch
from ytsaurus_tpu_torch.ops import segments as port
from ytsaurus_tpu_torch.query import select_rows

# The tier-1 suite runs several workers side by side: torch's default of
# one (spinning) thread per core would crowd out their timing tests.
torch.set_num_threads(1)

T = "//t"


# --- tests/test_ql_window.py: RANKING, OFFSET, FRAMED, SQL_DIALECT -----------

WINDOW_CASES = [(c[0], c[1], c[2], WT) for c in RANKING + OFFSET] + \
    [(c[0], c[1], c[2], c[3] if len(c) > 3 else WT) for c in FRAMED]


@pytest.mark.parametrize("query,expected,tables",
                         [c[1:] for c in WINDOW_CASES],
                         ids=[c[0] for c in WINDOW_CASES])
def test_window_corpus(query, expected, tables, monkeypatch):
    _run_both(query, tables, monkeypatch, expected)


@pytest.mark.parametrize("sql,expected", [c[1:] for c in SQL_DIALECT],
                         ids=[c[0] for c in SQL_DIALECT])
def test_sql_dialect_windows(sql, expected, monkeypatch):
    from ytsaurus_tpu.ecosystem.sql import translate_sql
    _run_both(translate_sql(sql), WT, monkeypatch, expected)


@pytest.mark.parametrize("query", [c[1] for c in ERRORS],
                         ids=[c[0] for c in ERRORS])
def test_window_errors(query):
    """Each invalid window query raises a YtError in both packages, with
    the same error code."""
    cols, rows = WT[T]
    ref_chunk = RefChunk.from_rows(RefSchema.make(cols), rows)
    with pytest.raises(RefYtError) as want:
        ref_select(query, {T: ref_chunk})
    with pytest.raises(YtError) as got:
        select_rows(query, {T: _to_port(ref_chunk)}, device="cpu")
    assert got.value.code == want.value.code


# --- WITH TOTALS ----------------------------------------------------------------

TOTALS_CASES = list(TOTALS) + [c for c in AGG if c[0] == "with_totals_row"]


@pytest.mark.parametrize("query,tables,expected",
                         [c[1:] for c in TOTALS_CASES],
                         ids=[c[0] for c in TOTALS_CASES])
def test_totals(query, tables, expected, monkeypatch):
    _run_both(query, tables, monkeypatch, expected)


def test_totals_row_comes_last_with_string_keys(monkeypatch):
    """The totals row (null keys) follows the groups, whose string keys
    move onto the union vocabulary."""
    tables = {T: ([("k", "int64"), ("s", "string"), ("v", "double")],
                  [(i, [b"p", b"q", None][i % 3], i * 0.5)
                   for i in range(12)])}
    rows = _run_both(f"s, sum(v) AS t, count(*) AS n FROM [{T}] GROUP BY s "
                     "WITH TOTALS", tables, monkeypatch)
    assert rows[-1] == {"s": None, "t": 33.0, "n": 12}


# --- the repo's window benchmark query ---------------------------------------


def test_bench_window_query(monkeypatch):
    """bench.py's window query at 65,536 rows in 1000 partitions, against
    the JAX package (in order) and the numpy oracle (exact)."""
    arrays = tpch.window_arrays(65536, seed=3)
    chunk = tpch.window_chunk(arrays, device="cpu")
    got = select_rows(tpch.WINDOW, {"//t": chunk}, device="cpu")
    s, r = tpch.window_oracle(arrays)
    planes = got.to_numpy()["planes"]
    assert got.row_count == 65536
    np.testing.assert_array_equal(planes["k"][0][:65536], arrays["k"])
    np.testing.assert_array_equal(planes["s"][0][:65536], s)
    np.testing.assert_array_equal(planes["r"][0][:65536], r)
    monkeypatch.setenv("YT_TPU_SORT_ENGINE", "pallas")
    ref_chunk = RefChunk.from_arrays(
        RefSchema.make([("k", "int64", "ascending"), ("g", "int64"),
                        ("v", "int64")]), arrays)
    want = ref_select(tpch.WINDOW, {"//t": ref_chunk})
    for name in ("k", "s", "r"):
        np.testing.assert_array_equal(planes[name][0],
                                      np.asarray(want.columns[name].data))


def test_float_running_sum_resets_at_segment_starts(monkeypatch):
    """A partition of values near 1e15 sorts before a partition of values
    near 1: a cumsum over the whole plane minus the sum before the
    partition would lose the small partition's digits; the segmented scan
    keeps them."""
    rng = np.random.default_rng(12)
    big = [(i, 0, 1e15 + float(rng.integers(0, 1000)) + 0.125)
           for i in range(200)]
    small = [(200 + i, 1, 1.0 + float(rng.random())) for i in range(50)]
    tables = {T: ([("k", "int64"), ("g", "int64"), ("x", "double")],
                  big + small)}
    rows = _run_both(f"k, sum(x) OVER (PARTITION BY g ORDER BY k) AS s "
                     f"FROM [{T}]", tables, monkeypatch)
    running = np.cumsum([x for _, _, x in small])
    got = np.array([r["s"] for r in rows if r["k"] >= 200])
    np.testing.assert_allclose(got, running, rtol=1e-12)


# --- the segment scans against their JAX functions ---------------------------


def _starts(seed: int, n: int = 777) -> np.ndarray:
    starts = np.random.default_rng(seed).random(n) < 0.06
    starts[0] = True
    return starts


def _values(kind: str, seed: int, n: int = 777) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "int64":
        x = rng.integers(-1000, 1000, n)
        x[rng.integers(0, n, 5)] = np.iinfo(np.int64).max   # wraps
        return x
    x = rng.normal(size=n) * 1e3
    x[rng.integers(0, n, 5)] = -0.0
    return x


@pytest.mark.parametrize("kind", ["int64", "float64"])
@pytest.mark.parametrize("fn", ["sum", "min", "max"])
@pytest.mark.parametrize("suffix", [False, True], ids=["prefix", "suffix"])
def test_segment_scan(fn, kind, suffix):
    data, starts = _values(kind, 20), _starts(21)
    f_ref = ref.segment_suffix_scan if suffix else ref.segment_scan
    f_port = port.segment_suffix_scan if suffix else port.segment_scan
    want = np.asarray(f_ref(fn, jnp.asarray(data), jnp.asarray(starts)))
    got = f_port(fn, torch.from_numpy(data), torch.from_numpy(starts))
    if kind == "int64":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)


@pytest.mark.parametrize("fn", ["segment_start_index", "segment_end_index",
                                "segment_position"])
def test_segment_index_scans(fn):
    starts = _starts(22)
    want = np.asarray(getattr(ref, fn)(jnp.asarray(starts)))
    got = getattr(port, fn)(torch.from_numpy(starts))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shift", [-4, -1, 0, 1, 3])
def test_segment_shift(shift):
    data, starts = _values("int64", 23), _starts(24)
    valid = np.random.default_rng(25).random(len(data)) > 0.2
    want = ref.segment_shift(jnp.asarray(data), jnp.asarray(valid),
                             jnp.asarray(starts), shift)
    got = port.segment_shift(torch.from_numpy(data), torch.from_numpy(valid),
                             torch.from_numpy(starts), shift)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["int64", "float64"])
@pytest.mark.parametrize("fn", ["min", "max"])
@pytest.mark.parametrize("frame", [(-1, 1), (-6, 2), (-20, -3), (0, 37)])
def test_segment_range_extreme(fn, kind, frame):
    data, starts = _values(kind, 26), _starts(27)
    valid = np.random.default_rng(28).random(len(data)) > 0.2
    n = len(data)
    lo0 = np.asarray(ref.segment_start_index(jnp.asarray(starts)))
    hi0 = np.asarray(ref.segment_end_index(jnp.asarray(starts)))
    iota = np.arange(n)
    lo = np.clip(np.maximum(lo0, iota + frame[0]), 0, n - 1)
    hi = np.maximum(np.clip(np.minimum(hi0, iota + frame[1]), 0, n - 1), lo)
    width = frame[1] - frame[0] + 1
    want = np.asarray(ref.segment_range_extreme(
        fn, jnp.asarray(data), jnp.asarray(valid), jnp.asarray(lo),
        jnp.asarray(hi), width))
    got = port.segment_range_extreme(
        fn, torch.from_numpy(data), torch.from_numpy(valid),
        torch.from_numpy(lo), torch.from_numpy(hi), width)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kinds", [("float64",), ("int8", "float64", "int8"),
                                   ("uint64", "int32"), ("bool", "int64")])
def test_lexsort_indices(kinds):
    """jnp.lexsort's order: -0.0 equal to +0.0, every NaN equal and last,
    uint64 unsigned, the last plane major."""
    rng = np.random.default_rng(29)
    n = 600
    planes = []
    for kind in kinds:
        if kind == "float64":
            pool = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf,
                             1.0, -1.0])
            planes.append(pool[rng.integers(0, len(pool), n)])
        elif kind == "uint64":
            x = rng.integers(0, 1 << 63, 8, dtype=np.uint64)
            x[:3] += np.uint64(1 << 63)
            planes.append(x[rng.integers(0, 8, n)])
        elif kind == "bool":
            planes.append(rng.random(n) > 0.5)
        else:
            info = np.iinfo(kind)
            pool = rng.integers(info.min, info.max, 6, dtype=kind)
            planes.append(pool[rng.integers(0, 6, n)])
    want = np.asarray(jnp.lexsort([jnp.asarray(p) for p in planes]))
    got = port.lexsort_indices(
        [(torch.from_numpy(p.view(np.int64)), True) if p.dtype == np.uint64
         else torch.from_numpy(p) for p in planes])
    np.testing.assert_array_equal(got.numpy(), want)
