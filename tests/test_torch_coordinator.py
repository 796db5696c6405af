"""Parity of the port's host coordinator
(`ytsaurus_tpu_torch.query.coordinator.coordinate_and_execute`) with the
JAX package's on the CPU.

Twins of tests/test_coordinator.py (`:46-325`): each test makes its shards
with the JAX package (numpy seeds where the reference uses them), runs the
JAX `coordinate_and_execute` on them and the port's on the same planes
(device="cpu"), and holds the port's rows and statistics against the
reference's. Integers, codes, group sets and orders exactly; doubles to
rtol 1e-9, since partial sums merged at the front add in another order
than a single pass. Unordered results compare as sets, ORDER BY results
as sequences. Beyond the twins: lazy shards, coalescing
(`merge_shards_below`), the wave early exit, `shards_skipped` and
`shards_staged`, the per-shard retry under an injected
`query.shard_execute` fault, and a token past its deadline.

Not a twin: `test_order_by_early_exit_via_dynamic_table`, which needs the
client and dynamic tables (not ported yet: ROADMAP queue 1).
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from tests.test_torch_query import _assert_rows, _to_port
from ytsaurus_tpu.chunks import ColumnarChunk as RefChunk
from ytsaurus_tpu.query.builder import build_query as ref_build_query
from ytsaurus_tpu.query.coordinator import (
    coordinate_and_execute as ref_coordinate,
)
from ytsaurus_tpu.query.coordinator import split_plan as ref_split_plan
from ytsaurus_tpu.query.engine.evaluator import Evaluator as RefEvaluator
from ytsaurus_tpu.query.statistics import QueryStatistics as RefStats
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu.utils import failpoints as ref_failpoints
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.query import ir
from ytsaurus_tpu_torch.query.builder import build_query
from ytsaurus_tpu_torch.query.coordinator import (
    coordinate_and_execute,
    split_plan,
)
from ytsaurus_tpu_torch.query.engine import evaluator as port_evaluator
from ytsaurus_tpu_torch.query.engine.evaluator import Evaluator
from ytsaurus_tpu_torch.query.serving import CancellationToken
from ytsaurus_tpu_torch.query.statistics import QueryStatistics
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.utils import failpoints

SPEC = [("k", "int64", "ascending"), ("g", "int64"), ("v", "int64")]
T = "//t"
STAT_FIELDS = ("shards_total", "shards_skipped", "shards_staged",
               "rows_read", "rows_written", "retries")


def _schema(spec):
    return RefSchema.make(spec), TableSchema.make(spec)


def _ref_shards(spec, rows_per_shard):
    ref_schema, _ = _schema(spec)
    return [RefChunk.from_rows(ref_schema, rows) for rows in rows_per_shard]


SHARDS = [
    [(0, 0, 1), (1, 1, 2), (2, 0, 3)],
    [(3, 1, 4), (4, 0, 5)],
    [(5, 2, 6)],
]


def _run(query, shards, schemas=None, ordered=False, foreign=None,
         lazy=False, **kwargs):
    """The reference's and the port's coordinate_and_execute on the same
    shards: the port's rows and statistics held against the reference's.
    Returns (port rows, port stats)."""
    schemas = schemas or {T: shards[0].schema}
    ref_plan = ref_build_query(query, schemas)
    ref_stats = RefStats()
    ref_foreign = foreign
    ref_in = [(lambda c=c: c) for c in shards] if lazy else shards
    want = ref_coordinate(ref_plan, ref_in, ref_foreign,
                          evaluator=RefEvaluator(), stats=ref_stats,
                          **kwargs).to_rows()
    port_schemas = {p: TableSchema.make(
        [(c.name, c.type.value) + ((c.sort_order.value,)
                                   if c.sort_order is not None else ())
         for c in s]) for p, s in schemas.items()}
    plan = build_query(query, port_schemas)
    port_shards = [_to_port(c) for c in shards]
    port_in = [(lambda c=c: c) for c in port_shards] if lazy \
        else port_shards
    port_foreign = {p: _to_port(c) for p, c in (foreign or {}).items()}
    stats = QueryStatistics()
    got = coordinate_and_execute(plan, port_in, port_foreign or None,
                                 evaluator=Evaluator("cpu"), stats=stats,
                                 **kwargs).to_rows()
    _assert_rows(got, want, ordered)
    for name in STAT_FIELDS:
        assert getattr(stats, name) == getattr(ref_stats, name), name
    return got, stats


# --- tests/test_coordinator.py ------------------------------------------------


def test_distributed_filter_project():
    rows, _ = _run(f"k, v FROM [{T}] WHERE v >= 3",
                   _ref_shards(SPEC, SHARDS))
    assert sorted(r["k"] for r in rows) == [2, 3, 4, 5]


def test_distributed_group_by_sum_count():
    rows, _ = _run(f"g, sum(v) AS s, count(*) AS c FROM [{T}] GROUP BY g",
                   _ref_shards(SPEC, SHARDS))
    assert sorted((r["g"], r["s"], r["c"]) for r in rows) == \
        [(0, 9, 3), (1, 6, 2), (2, 6, 1)]


def test_distributed_avg_is_exact():
    rows, _ = _run(f"g, avg(v) AS a FROM [{T}] GROUP BY g",
                   _ref_shards(SPEC, SHARDS))
    assert sorted((r["g"], r["a"]) for r in rows) == \
        [(0, 3.0), (1, 3.0), (2, 6.0)]


def test_distributed_min_max_first_merge():
    _run(f"g, min(v) AS lo, max(v) AS hi FROM [{T}] GROUP BY g",
         _ref_shards(SPEC, SHARDS))


def test_distributed_having_applies_at_front():
    rows, _ = _run(f"g, sum(v) AS s FROM [{T}] GROUP BY g "
                   "HAVING sum(v) > 8", _ref_shards(SPEC, SHARDS))
    assert rows == [{"g": 0, "s": 9}]


def test_distributed_order_by_limit():
    rows, _ = _run(f"k FROM [{T}] ORDER BY v DESC LIMIT 3",
                   _ref_shards(SPEC, SHARDS), ordered=True)
    assert [r["k"] for r in rows] == [5, 4, 3]


def test_distributed_offset_limit():
    rows, _ = _run(f"k FROM [{T}] ORDER BY k OFFSET 2 LIMIT 2",
                   _ref_shards(SPEC, SHARDS), ordered=True)
    assert [r["k"] for r in rows] == [2, 3]


def test_distributed_avg_in_having_and_order():
    _run(f"g, avg(v) AS a FROM [{T}] GROUP BY g HAVING avg(v) > 2.5 "
         f"ORDER BY avg(v) DESC, g LIMIT 10", _ref_shards(SPEC, SHARDS),
         ordered=True)


def test_distributed_join():
    dim_spec = [("g", "int64", "ascending"), ("name", "string")]
    dim_ref, _ = _schema(dim_spec)
    dim = RefChunk.from_rows(dim_ref, [(0, "zero"), (1, "one"),
                                       (2, "two")])
    shards = _ref_shards(SPEC, SHARDS)
    rows, _ = _run(f"name, sum(v) AS s FROM [{T}] JOIN [//dim] USING g "
                   "GROUP BY name", shards,
                   schemas={T: shards[0].schema, "//dim": dim_ref},
                   foreign={"//dim": dim})
    assert sorted((r["name"], r["s"]) for r in rows) == \
        [(b"one", 6), (b"two", 6), (b"zero", 9)]


def test_split_plan_shapes():
    """The port's split of a plan has the reference's bottom and front
    fingerprints (the port's `ir.fingerprint` is a copy)."""
    from ytsaurus_tpu.query import ir as ref_ir
    query = f"g, avg(v) AS a FROM [{T}] GROUP BY g HAVING avg(v) > 0"
    ref_schema, schema = _schema(SPEC)
    ref_bottom, ref_front = ref_split_plan(
        ref_build_query(query, {T: ref_schema}))
    bottom, front = split_plan(build_query(query, {T: schema}))
    assert ir.fingerprint(bottom) == ref_ir.fingerprint(ref_bottom)
    assert ir.fingerprint(front) == ref_ir.fingerprint(ref_front)
    assert bottom.having is None and bottom.project is None
    assert [a.name[-3:] for a in bottom.group.aggregate_items] == \
        ["__s", "__c"]
    assert front.having is not None
    assert [a.function for a in front.group.aggregate_items] == \
        ["sum", "sum"]


def test_string_group_keys_across_shards():
    spec = [("k", "int64", "ascending"), ("s", "string")]
    rows, _ = _run(f"s, count(*) AS c FROM [{T}] GROUP BY s",
                   _ref_shards(spec, [[(1, "x"), (2, "y")],
                                      [(3, "y"), (4, "z")]]))
    assert sorted((r["s"], r["c"]) for r in rows) == \
        [(b"x", 1), (b"y", 2), (b"z", 1)]


def test_distributed_cardinality_exact():
    rows, _ = _run(f"g, cardinality(v) AS d FROM [{T}] GROUP BY g",
                   _ref_shards(SPEC, [[(1, 0, 5), (2, 0, 7)],
                                      [(3, 0, 5), (4, 1, 1)],
                                      [(5, 1, 1), (6, 1, 2)]]))
    assert sorted((r["g"], r["d"]) for r in rows) == [(0, 2), (1, 2)]


def test_distributed_with_totals():
    rows, _ = _run(f"g, sum(v) AS s FROM [{T}] GROUP BY g WITH TOTALS",
                   _ref_shards(SPEC, SHARDS))
    assert [r for r in rows if r["g"] is None] == [{"g": None, "s": 21}]


def test_distributed_argmax_merges_across_shards():
    spec = [("k", "int64", "ascending"), ("g", "int64"),
            ("name", "string"), ("score", "int64")]
    rows, _ = _run(f"g, argmax(name, score) AS top FROM [{T}] GROUP BY g",
                   _ref_shards(spec, [[(1, 0, "a", 10), (2, 0, "b", 30)],
                                      [(3, 0, "c", 20), (4, 1, "d", 5)],
                                      [(5, 1, "e", 50)]]))
    assert sorted((r["g"], r["top"]) for r in rows) == \
        [(0, b"b"), (1, b"e")]


def test_distributed_mixed_aggregate_order_stable():
    spec = [("k", "int64", "ascending"), ("g", "int64"), ("s", "string"),
            ("v", "int64")]
    rows = [(1, 0, "a", 3), (2, 0, "b", 9), (3, 1, "c", 4)]
    query = ("g, sum(v) AS s1, argmax(s, v) AS am, avg(v) AS a FROM [//t] "
             "GROUP BY g")
    single, _ = _run(query, _ref_shards(spec, [rows]))
    multi, _ = _run(query, _ref_shards(spec, [rows[:2], rows[2:]]))
    assert [list(r) for r in single] == [list(r) for r in multi]
    _assert_rows(multi, single, ordered=False)


def _key_shards():
    spec = [("k", "int64", "ascending"), ("v", "int64")]
    return _ref_shards(spec, [[(i * 100 + j, j) for j in range(10)]
                              for i in range(6)])


@pytest.mark.parametrize("query,ordered_by,skipped", [
    ("k FROM [//t] ORDER BY k LIMIT 5", ["k"], 5),
    ("k FROM [//t] ORDER BY k DESC LIMIT 3", ["k"], 5),
    ("k FROM [//t] WHERE v >= 8 ORDER BY k LIMIT 4", ["k"], 4),
    ("k FROM [//t] ORDER BY k OFFSET 12 LIMIT 3", ["k"], 4),
    ("k FROM [//t] ORDER BY v LIMIT 3", ["k"], 0),
    ("k FROM [//t] ORDER BY k, v DESC LIMIT 3", ["k", "v"], 0),
    ("k FROM [//t] ORDER BY k LIMIT 5", None, 0),
])
def test_order_by_key_prefix_early_exit(query, ordered_by, skipped):
    _, stats = _run(query, _key_shards(), ordered=True,
                    range_ordered_by=ordered_by)
    assert stats.shards_skipped == skipped


def _limit_shards():
    return _ref_shards([("k", "int64")],
                       [[(i * 100 + j,) for j in range(10)]
                        for i in range(6)])


@pytest.mark.parametrize("query,skipped", [
    ("k FROM [//t] LIMIT 15", 4),
    ("k FROM [//t] ORDER BY k DESC LIMIT 3", 0),
    ("k FROM [//t] WHERE k >= 500 LIMIT 5", 0),
])
def test_limit_early_exit_skips_shards(query, skipped):
    rows, stats = _run(query, _limit_shards(), ordered=True)
    assert stats.shards_skipped == skipped
    assert len(rows) in (3, 5, 15)


# --- beyond the twins ---------------------------------------------------------


def _random_shards(n_shards=8, rows=200, seed=3):
    rng = np.random.default_rng(seed)
    ref_schema, _ = _schema(SPEC)
    return [RefChunk.from_arrays(ref_schema, {
        "k": np.arange(rows) + s * rows,
        "g": rng.integers(0, 50, rows),
        "v": rng.integers(0, 1000, rows)}) for s in range(n_shards)]


GROUP_QUERY = (f"g, sum(v) AS s, count(*) AS c FROM [{T}] WHERE v < 900 "
               "GROUP BY g")


@pytest.mark.parametrize("query,ordered,kwargs", [
    (GROUP_QUERY, False, {}),
    (f"k, v FROM [{T}] WHERE v > 900 LIMIT 20", True, {}),
    (f"k, v FROM [{T}] ORDER BY k DESC LIMIT 7", True,
     {"range_ordered_by": ["k"]}),
    (f"k, v FROM [{T}] ORDER BY k LIMIT 250", True,
     {"range_ordered_by": ["k"]}),
])
def test_lazy_shards_stage_only_what_the_scan_reads(query, ordered, kwargs):
    """Lazy shards (callables) through the prefetcher: the same rows and
    the same shards_total / shards_skipped / shards_staged / rows_read
    as the reference's scan."""
    _, stats = _run(query, _random_shards(), ordered=ordered, lazy=True,
                    **kwargs)
    assert stats.shards_staged >= 8 - stats.shards_skipped


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("query,ordered,kwargs,programs", [
    (GROUP_QUERY, False, {"merge_shards_below": 500}, 2),
    (GROUP_QUERY, False, {"merge_shards_below": 10_000}, 1),
    (f"k, v FROM [{T}] ORDER BY k LIMIT 250", True,
     {"merge_shards_below": 1000, "range_ordered_by": ["k"]}, 4),
])
def test_coalescing_merges_small_shards(query, ordered, kwargs, programs,
                                        lazy):
    """merge_shards_below: eager shards coalesce before dispatch, lazy ones
    after staging; an ordered exit caps a group at the scan budget. The
    port runs as many shard programs as the reference."""
    _, stats = _run(query, _random_shards(), ordered=ordered, lazy=lazy,
                    **kwargs)
    if not lazy:
        assert stats.shards_total == programs


def test_wave_early_exit_reads_counts_per_wave():
    """A bare LIMIT that the first shards satisfy: the counts cross per
    wave (one stacked read for a wave of several results), and the scan
    stops with the reference's shards_skipped."""
    shards = _random_shards(n_shards=8, rows=200, seed=5)
    before = port_evaluator.count_reads()
    _, stats = _run(f"k FROM [{T}] WHERE v > 500 LIMIT 250", shards,
                    ordered=True)
    reads = port_evaluator.count_reads() - before
    # At most one read per shard run, plus the front's count.
    assert stats.shards_skipped > 0
    assert reads <= 8 - stats.shards_skipped + 1


def test_full_scan_reads_the_counts_once():
    """With no early exit, every shard program runs without a read and the
    counts cross in one stacked transfer, then the front's count."""
    before = port_evaluator.count_reads()
    _run(GROUP_QUERY, _random_shards())
    assert port_evaluator.count_reads() - before == 2


def test_per_shard_retry_under_injected_faults():
    """query.shard_execute=error:times=2: two transient faults, each
    retried; the rows are the fault-free ones and stats.retries == 2, as
    in the reference under the same schedule."""
    shards = _random_shards()
    ref_schema = shards[0].schema
    ref_plan = ref_build_query(GROUP_QUERY, {T: ref_schema})
    ref_stats = RefStats()
    with ref_failpoints.active("query.shard_execute=error:times=2",
                               seed=1):
        want = ref_coordinate(ref_plan, shards, evaluator=RefEvaluator(),
                              stats=ref_stats).to_rows()
    plan = build_query(GROUP_QUERY, {T: TableSchema.make(SPEC)})
    stats = QueryStatistics()
    with failpoints.active("query.shard_execute=error:times=2", seed=1):
        got = coordinate_and_execute(plan, [_to_port(c) for c in shards],
                                     evaluator=Evaluator("cpu"),
                                     stats=stats).to_rows()
    _assert_rows(got, want, ordered=False)
    assert stats.retries == ref_stats.retries == 2
    # Three faults exhaust the query_shard policy's three attempts.
    with failpoints.active("query.shard_execute=error:times=3", seed=1):
        with pytest.raises(YtError, match="injected shard execution"):
            coordinate_and_execute(plan, [_to_port(c) for c in shards],
                                   evaluator=Evaluator("cpu"))


def test_lazy_staging_retries_its_own_faults():
    shards = [_to_port(c) for c in _random_shards()]
    plan = build_query(GROUP_QUERY, {T: TableSchema.make(SPEC)})
    want = coordinate_and_execute(plan, shards,
                                  evaluator=Evaluator("cpu")).to_rows()
    stats = QueryStatistics()
    with failpoints.active("query.shard_materialize=error:times=1", seed=2):
        got = coordinate_and_execute(
            plan, [(lambda c=c: c) for c in shards],
            evaluator=Evaluator("cpu"), stats=stats).to_rows()
    _assert_rows(got, want, ordered=False)
    assert stats.retries == 1 and stats.shards_staged == 8


def test_token_past_its_deadline_stops_the_scan():
    """An expired token raises DeadlineExceeded before any shard runs, and
    a lazy shard past the deadline is never staged."""
    plan = build_query(GROUP_QUERY, {T: TableSchema.make(SPEC)})
    shards = [_to_port(c) for c in _random_shards()]
    token = CancellationToken.with_timeout(0.001)
    time.sleep(0.01)
    with pytest.raises(YtError) as err:
        coordinate_and_execute(plan, shards, evaluator=Evaluator("cpu"),
                               token=token)
    assert err.value.code == EErrorCode.DeadlineExceeded
    staged = []
    token = CancellationToken.with_timeout(0.2)

    def slow(c):
        staged.append(1)
        time.sleep(0.12)
        return c

    with pytest.raises(YtError) as err:
        coordinate_and_execute(plan, [(lambda c=c: slow(c)) for c in shards],
                               evaluator=Evaluator("cpu"), token=token)
    assert err.value.code == EErrorCode.DeadlineExceeded
    assert len(staged) < len(shards)
