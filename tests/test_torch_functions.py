"""Parity of the port's expression functions (`ytsaurus_tpu_torch`) with the
JAX package on the CPU: each function family of query/engine/expr.py over
the same table, carried across with `chunk_from_numpy`, through the JAX
`select_rows` and the port's `select_rows(..., device="cpu")`. Integers,
strings, hashes and group sets match exactly; doubles to rtol 1e-9.

Also here: the FUNCS query of the card's paths at 4,096 rows and the
STRINGS queries at 40,960 rows (4,096 distinct strings), against both the
JAX package and their numpy oracles, the `u` suffix of
uint64 literals, timestamps before 1970, the uint64 extremes of the
unsigned `/`, `%`, `>>`, `min_of` and `max_of`, and the string hash table
of farm_hash and bigb_hash against the JAX package's per-entry hash.
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_query import _assert_rows, _to_port
from ytsaurus_tpu.chunks import ColumnarChunk as RefChunk
from ytsaurus_tpu.models import tpch as ref_tpch
from ytsaurus_tpu.query.engine import expr as ref_expr
from ytsaurus_tpu.query.engine.evaluator import select_rows as ref_select
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.models import synthetic, tpch
from ytsaurus_tpu_torch.query import select_rows
from ytsaurus_tpu_torch.query.engine import expr

torch.set_num_threads(1)

T = "//t"
BIG = (1 << 63) + 5
U64_MAX = (1 << 64) - 1


def _run_both(query, tables, monkeypatch, ordered=False):
    monkeypatch.setenv("YT_TPU_SORT_ENGINE", "pallas")
    want = ref_select(query, tables).to_rows()
    got = select_rows(query, {p: _to_port(c) for p, c in tables.items()},
                      device="cpu").to_rows()
    _assert_rows(got, want, ordered)
    return got


@functools.lru_cache(maxsize=1)
def _mixed() -> RefChunk:
    rng = np.random.default_rng(12)
    words = [b"apple", b"Banana", b"cherry", b"date pie", b"", b"x_y%z",
             b"u00007", b"u01099", b"12", b"-7", b" 40 ", b"9" * 25]
    rows = []
    for i in range(400):
        rows.append({
            "k": i,
            "v": None if rng.random() < 0.1 else int(rng.integers(-50, 50)),
            "d": None if rng.random() < 0.1 else float(
                rng.choice([rng.normal() * 40, np.nan, np.inf, -np.inf,
                            -0.0, 0.5], p=[0.8, 0.05, 0.05, 0.04, 0.03,
                                           0.03])),
            "s": None if rng.random() < 0.1 else words[rng.integers(0, 12)],
            "u": [0, 1, 5, 16, BIG, U64_MAX, 1 << 63, (1 << 63) - 1,
                  int(rng.integers(0, 1 << 62))][rng.integers(0, 9)],
            "w": [0, 1, 2, 3, 7, 16, 63, 64, 70, BIG,
                  U64_MAX][rng.integers(0, 11)],
            # Seconds from 1962 to 2030: before and after the epoch.
            "t": int(rng.integers(-250_000_000, 1_900_000_000)),
            "b": None if rng.random() < 0.1 else bool(rng.random() < 0.5),
        })
    schema = RefSchema.make([("k", "int64", "ascending"), ("v", "int64"),
                             ("d", "double"), ("s", "string"),
                             ("u", "uint64"), ("w", "uint64"),
                             ("t", "int64"), ("b", "boolean")])
    return RefChunk.from_rows(schema, rows)


FAMILIES = {
    "numeric": [
        f"k, abs(v) AS a, abs(d) AS b, abs(u) AS c FROM [{T}]",
        f"k, floor(d) AS f, ceil(d) AS c, sqrt(d) AS s, floor(v) AS g, "
        f"sqrt(u) AS h FROM [{T}]",
        f"k, is_finite(d) AS f, is_nan(d) AS n FROM [{T}] WHERE k < 200",
        f"k FROM [{T}] WHERE is_nan(d) OR NOT is_finite(d)",
        f"k, if_null(v, -1) AS a, if_null(d, 0.5) AS b, if_null(s, 'none') "
        f"AS c, if_null(b, true) AS e FROM [{T}]",
        f"k, if_null(v, d) AS a FROM [{T}]",
        f"k, min_of(v, 3) AS a, max_of(v, k, 10) AS b, min_of(d, v) AS c, "
        f"max_of(d, 0.0) AS e FROM [{T}]",
    ],
    "calendar": [
        f"k, t, timestamp_floor_hour(t) AS h, timestamp_floor_day(t) AS d, "
        f"timestamp_floor_week(t) AS w, timestamp_floor_month(t) AS m, "
        f"timestamp_floor_year(t) AS y FROM [{T}]",
        f"timestamp_floor_year(t) AS y, count(*) AS c FROM [{T}] "
        f"GROUP BY timestamp_floor_year(t)",
        f"k, timestamp_floor_month(u) AS m FROM [{T}] WHERE u < 100000",
    ],
    "uint64": [
        f"k, u / w AS q, u % w AS r, u >> w AS s, u << 3 AS l FROM [{T}]",
        f"k, u / uint64(16) AS q, u % uint64(3) AS r, u >> uint64(60) AS s "
        f"FROM [{T}]",
        f"k, min_of(u, w) AS a, max_of(u, w) AS b FROM [{T}]",
        f"u % uint64(7) AS g, count(*) AS c FROM [{T}] "
        f"GROUP BY u % uint64(7)",
    ],
    "hashes": [
        f"k, farm_hash(v) AS a, farm_hash(d) AS b, farm_hash(s) AS c, "
        f"farm_hash(b) AS e, farm_hash(u) AS f FROM [{T}]",
        f"k, farm_hash(v, s, d, b) AS h, bigb_hash(s) AS g FROM [{T}]",
        f"farm_hash(k) % uint64(8) AS g, count(*) AS c FROM [{T}] "
        f"GROUP BY farm_hash(k) % uint64(8)",
    ],
    "dictionary": [
        f"k, lower(s) AS a, upper(s) AS b, length(s) AS c FROM [{T}]",
        f"k, concat(s, '!') AS a, concat('<', s) AS b FROM [{T}]",
        f"k, substr(s, 1, 3) AS a, substr(s, 2) AS b FROM [{T}]",
        f"k, regex_full_match('[a-z]+', s) AS a, "
        f"regex_partial_match('an', s) AS b FROM [{T}]",
        f"k, regex_replace_first('a', s, 'A') AS a, "
        f"regex_replace_all('[aeiou]', s, '_') AS b, "
        f"regex_escape(s) AS c FROM [{T}]",
        f"k, sha256(s) AS a, parse_int64(s) AS b FROM [{T}]",
        f"upper(s) AS u, length(concat(s, 'x')) AS n, count(*) AS c "
        f"FROM [{T}] GROUP BY upper(s), length(concat(s, 'x'))",
    ],
    "predicates": [
        f"k FROM [{T}] WHERE s LIKE '%a%'",
        f"k FROM [{T}] WHERE s ILIKE 'b%'",
        f"k FROM [{T}] WHERE s NOT LIKE '_____'",
        f"k FROM [{T}] WHERE s LIKE 'x\\\\_y\\\\%z'",
        f"k FROM [{T}] WHERE is_prefix('u0', s) OR is_substr('rr', s)",
        f"k FROM [{T}] WHERE s REGEXP '[0-9]+'",
        f"k FROM [{T}] WHERE s LIKE 'u0000%7' OR "
        f"regex_partial_match('99$', s)",
    ],
    "transform": [
        f"k, transform(v, (1, 2, -3), (10, 20, 30)) AS a FROM [{T}]",
        f"k, transform(v, (1, 2), (10, 20), -1) AS a FROM [{T}]",
        f"k, transform(s, ('apple', 'cherry'), ('A', 'C'), s) AS a "
        f"FROM [{T}]",
        f"k, transform((v, b), ((1, true), (2, false)), (1.5, 2.5)) AS a "
        f"FROM [{T}]",
        f"k, transform(u, (5, 16), (1, {(1 << 63) - 1})) AS a FROM [{T}]",
    ],
}


@pytest.mark.parametrize("query", [q for qs in FAMILIES.values()
                                   for q in qs],
                         ids=[f"{fam}-{i}" for fam, qs in FAMILIES.items()
                              for i in range(len(qs))])
def test_function_family(query, monkeypatch):
    _run_both(query, {T: _mixed()}, monkeypatch)


def test_u_suffix_is_uint64(monkeypatch):
    """`16u` lexes as the uint64 16 on the port, and gives the rows the
    JAX package gives for `uint64(16)` (its lexer stops before the
    suffix)."""
    chunk = ref_tpch.generate_lineitem(4096, seed=4)
    query = ("farm_hash(l_orderkey) % {} AS b, count(*) AS c "
             "FROM [//tpch/lineitem] GROUP BY farm_hash(l_orderkey) % {}")
    from ytsaurus_tpu.errors import YtError as RefYtError
    with pytest.raises(RefYtError, match="trailing token"):
        ref_select(query.format("16u", "16u"), {"//tpch/lineitem": chunk})
    want = ref_select(query.format("uint64(16)", "uint64(16)"),
                      {"//tpch/lineitem": chunk}).to_rows()
    got = select_rows(query.format("16u", "16u"),
                      {"//tpch/lineitem": _to_port(chunk)},
                      device="cpu").to_rows()
    _assert_rows(got, want, ordered=False)
    assert len(got) == 16


def test_timestamp_floor_before_the_epoch():
    """Floors toward minus infinity, against Python's calendar, from 1901
    to 2100, on both sides of every boundary."""
    import datetime as dt
    epoch = dt.datetime(1970, 1, 1)
    stamps = []
    for year in (1901, 1939, 1968, 1969, 1970, 1971, 2000, 2024, 2100):
        for month in (1, 2, 3, 12):
            base = int((dt.datetime(year, month, 1) - epoch).total_seconds())
            stamps += [base - 1, base, base + 1, base + 86399]
    spec = [("k", "int64"), ("t", "int64")]
    from ytsaurus_tpu_torch.schema import TableSchema
    rows = list(enumerate(stamps))
    got = select_rows(
        f"t, timestamp_floor_day(t) AS d, timestamp_floor_week(t) AS w, "
        f"timestamp_floor_month(t) AS m, timestamp_floor_year(t) AS y "
        f"FROM [{T}]", {T: rows}, schemas={T: TableSchema.make(spec)},
        device="cpu").to_rows()
    for row in got:
        when = epoch + dt.timedelta(seconds=row["t"])
        day = dt.datetime(when.year, when.month, when.day)
        monday = day - dt.timedelta(days=day.weekday())
        for name, want in (("d", day), ("w", monday),
                           ("m", dt.datetime(when.year, when.month, 1)),
                           ("y", dt.datetime(when.year, 1, 1))):
            assert row[name] == int((want - epoch).total_seconds()), \
                (row, name)


@pytest.mark.parametrize("a,b", [
    (0, 1), (BIG, 16), (BIG, 3), (U64_MAX, 1), (U64_MAX, 2), (U64_MAX, 7),
    (U64_MAX, U64_MAX), (U64_MAX, BIG), (BIG, U64_MAX), (BIG, BIG),
    (1 << 63, (1 << 63) - 1), ((1 << 63) - 1, 1 << 63), (12345, 0),
    (U64_MAX, (1 << 32) + 1), (BIG * 1 % (1 << 64), 1 << 40),
])
def test_unsigned_division_at_the_extremes(a, b):
    """`_udivmod` and `_ushr` on int64 bit patterns against Python's
    unbounded integers."""
    ta = torch.tensor([expr._i64(a)])
    tb = torch.tensor([expr._i64(b) if b else 1])
    q, r = expr._udivmod(ta, tb)
    bb = b or 1
    assert int(q) % (1 << 64) == a // bb and int(r) % (1 << 64) == a % bb
    for s in (0, 1, 33, 63, 64, 65, -1):
        got = int(expr._ushr(ta, torch.tensor([s]))) % (1 << 64)
        assert got == (a >> s if 0 <= s < 64 else 0), s


def test_uint64_min_max_and_compare_at_the_extremes(monkeypatch):
    spec = [("k", "int64", "ascending"), ("u", "uint64"), ("w", "uint64")]
    rows = [(0, 0, U64_MAX), (1, BIG, 5), (2, U64_MAX, BIG), (3, None, 7),
            (4, 1 << 63, (1 << 63) - 1)]
    chunk = RefChunk.from_rows(RefSchema.make(spec), rows)
    got = _run_both(f"k, min_of(u, w) AS a, max_of(u, w) AS b, u / w AS q, "
                    f"u % w AS r, u >> uint64(1) AS s FROM [{T}] "
                    f"WHERE u >= uint64(0)",
                    {T: chunk}, monkeypatch)
    assert {r["k"]: r["b"] for r in got} == {0: U64_MAX, 1: BIG,
                                              2: U64_MAX, 4: 1 << 63}


def test_string_hash_table_matches_the_per_entry_hash():
    vocab = [b"", b"a", b"u00001234", b"\xff\x00\x01", b"x" * 300,
             "ü".encode()] + [b"u%08d" % i for i in range(50)]
    got = expr._bytes_hash_table(vocab)
    want = np.array([ref_expr._bytes_hash(v) for v in vocab],
                    dtype=np.uint64)
    np.testing.assert_array_equal(got, want)
    assert len(expr._bytes_hash_table([])) == 0


def test_function_errors_match_the_reference():
    chunk = _to_port(_mixed())
    for query, match in (
            (f"k FROM [{T}] WHERE s LIKE 'a\\\\q'", "invalid escape"),
            (f"regex_full_match('(', s) AS a FROM [{T}]", "invalid regex"),
            (f"substr(s, k) AS a FROM [{T}]", "literal integer"),
            (f"regex_full_match(s, s) AS a FROM [{T}]", "literal string"),
            (f"k FROM [{T}] WHERE is_prefix(s, s)", "literal pattern")):
        with pytest.raises(YtError, match=match):
            select_rows(query, {T: chunk}, device="cpu")


# --- the card's FUNCS and STRINGS paths, small -------------------------------


def _funcs_rows_of(rows):
    return {(r["month"], r["bucket"]): r for r in rows}


def test_funcs_path(monkeypatch):
    """FUNCS on 4,096 lineitem rows: the JAX package's rows, and the
    oracle's groups and counts exactly (rev exactly, doubles to 1e-9)."""
    n = 4096
    rows = _run_both(tpch.FUNCS, {"//tpch/lineitem":
                                  ref_tpch.generate_lineitem(n, seed=5)},
                     monkeypatch)
    oracle = tpch.funcs_oracle(tpch.lineitem_arrays(n, seed=5))
    got = _funcs_rows_of(rows)
    assert set(got) == set(oracle) and len(got) > 500
    for key, want in oracle.items():
        row = got[key]
        assert row["c"] == want["c"] and row["rev"] == want["rev"]
        assert row["mq"] == want["mq"]
        assert row["dd"] == pytest.approx(want["dd"], rel=1e-9)


def test_strings_paths(monkeypatch):
    """STRINGS at 40,960 rows (4,096 distinct strings): both queries give
    the JAX package's rows and their oracles'."""
    arrays = synthetic.strings_arrays(40_960, seed=6)
    vocab = synthetic.strings_vocab(4096)
    ref_chunk = RefChunk.from_arrays(
        RefSchema.make([("k", "int64", "ascending"), ("s", "string"),
                        ("v", "int64")]), arrays, dictionaries={"s": vocab})
    tables = {T: ref_chunk}
    rows = _run_both(synthetic.STRINGS_GROUP, tables, monkeypatch)
    assert {r["s"]: r["t"] for r in rows} == \
        synthetic.strings_group_oracle(arrays)
    rows = _run_both(synthetic.STRINGS_FUNCS, tables, monkeypatch)
    assert {r["u"]: (r["n"], r["t"]) for r in rows} == \
        synthetic.strings_funcs_oracle(arrays)
    port = synthetic.strings_chunk(arrays, device="cpu")
    assert port.to_rows() == ref_chunk.to_rows()


def test_concat_bound_is_above_the_reference():
    """A vocabulary of 70,000 strings concatenated with a literal: the JAX
    package refuses the 70,000-pair product (its bound is 2^16), the port
    computes it (its bound is 2^24 pairs)."""
    arrays = synthetic.strings_arrays(700_000, seed=7)
    chunk = synthetic.strings_chunk(arrays, device="cpu")
    rows = select_rows(f"length(concat(s, 'x')) AS n, count(*) AS c "
                       f"FROM [{T}] GROUP BY length(concat(s, 'x'))",
                       {T: chunk}, device="cpu").to_rows()
    assert rows == [{"n": 10, "c": 700_000}]


# Doubles at every edge of the casts to int64 and uint64: NaN, the
# infinities, values far out of range, a negative fraction, 2^63, 2^64
# and the largest doubles inside each range.
CAST_EDGES = [float("nan"), float("inf"), float("-inf"), 1e308, -1e308,
              -2.5, -0.5, 2.0 ** 63, 2.0 ** 64, 2.0 ** 63 - 1024.0,
              2.0 ** 64 - 2048.0, -(2.0 ** 63), 1.8e19, 12.7, -12.7, 0.0]


def test_casts_of_doubles_saturate_as_the_reference(monkeypatch):
    """int64(d) and uint64(d) saturate as the JAX package's `astype`: NaN
    gives 0, out-of-range values give the type's bound, and uint64 of a
    negative double gives 0 (uint64(-2.5) used to give 2^64 - 2)."""
    schema = RefSchema.make([("k", "int64"), ("d", "double")])
    chunk = RefChunk.from_rows(schema, list(enumerate(CAST_EDGES)))
    rows = _run_both(f"k, int64(d) AS i, uint64(d) AS u FROM [{T}]",
                     {T: chunk}, monkeypatch)
    got = {r["k"]: (r["i"], r["u"]) for r in rows}
    assert got[0] == (0, 0)                              # NaN
    assert got[1] == ((1 << 63) - 1, U64_MAX)            # +inf
    assert got[2] == (-(1 << 63), 0)                     # -inf
    assert got[5] == (-2, 0)                             # -2.5
    assert got[8] == ((1 << 63) - 1, U64_MAX)            # 2^64


def test_cast_plane_saturates_without_the_engine():
    """The same edges straight through `cast_plane`, against numbers
    written out by hand."""
    d = torch.tensor(CAST_EDGES, dtype=torch.float64)
    ints = expr.cast_plane(d, expr.EValueType.double, expr.EValueType.int64)
    uints = expr.cast_plane(d, expr.EValueType.double,
                            expr.EValueType.uint64).numpy().view(np.uint64)
    top, low = (1 << 63) - 1, -(1 << 63)
    assert ints.tolist() == [0, top, low, top, low, -2, 0, top, top,
                             (1 << 63) - 1024, top, low, top, 12, -12, 0]
    assert uints.tolist() == [0, U64_MAX, 0, U64_MAX, 0, 0, 0, 1 << 63,
                              U64_MAX, (1 << 63) - 1024, U64_MAX - 2047, 0,
                              18_000_000_000_000_000_000, 12, 0, 0]


def test_subnormal_doubles_keep_their_sign():
    """A sanctioned divergence: the port keeps subnormal doubles, as IEEE
    and the C++ reference do; the JAX package's XLA on the CPU flushes
    them to zero. Smallest input: d = -1e-308, where `d < 0.0` holds on
    the port and not in the JAX package."""
    schema = RefSchema.make([("k", "int64"), ("d", "double")])
    chunk = RefChunk.from_rows(schema, [(0, -1e-308), (1, 1e-308),
                                        (2, -0.0)])
    query = f"k FROM [{T}] WHERE d < 0.0"
    want = [{"k": 0}]                          # IEEE: -1e-308 < 0
    assert np.float64(-1e-308) < 0.0
    assert select_rows(query, {T: _to_port(chunk)},
                       device="cpu").to_rows() == want
    assert ref_select(query, {T: chunk}).to_rows() == []
