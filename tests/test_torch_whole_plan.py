"""Parity of the port's whole-plan rung and degradation ladder
(`ytsaurus_tpu_torch.parallel.whole_plan`, `distributed.coordinate_distributed`)
with the JAX package, on 8 gloo ranks on the CPU.

The ranks are spawned once for the module (tests/test_torch_distributed.py's
`_spawn_ranks`: jax and the JAX package blocked, one torch thread, a
`file://` store). Every rank runs every job's steps in one go and returns
their rows, host reads and statistics; each test asserts that all 8 ranks
agree, then holds rank 0's rows against the JAX package's local
`Evaluator` over the concatenated shards (the oracle of the reference's
own SPMD tests) or against a numpy oracle. Integers, codes, group sets and
orders exactly; doubles to rtol 1e-9, since partial states merged across
ranks add in another order. Unordered results compare as sets, ORDER BY
results as sequences.

Twins of tests/test_whole_plan.py: the 10-query `CORPUS` over `table8`
(seed 21) with one host read per query, the unfusable-plan ladder, the
failpoint ladder, overflow escalation with the quota memo, the partition
rule registry, the telemetry block against its numpy oracle, disarmed
telemetry, and the stitched rungs' block. Of tests/test_multiway_join.py:
the dual-check corpus, the join ladder, the join quota overflow and memo,
and the stats-drift strategy flip. Of tests/test_vector.py: the SPMD
NEAREST for l2, cosine and dot.

Not applicable (the port compiles nothing): the compile-cache, AOT disk
tier and cross-process restart tests (`test_repeat_query_compiles_nothing`'s
`fresh_compiles`, `test_stitched_spmd_caches_ride_the_disk_tier`,
`test_cross_process_spmd_restart`, `test_mesh_resize_is_a_cache_fill`,
`test_fused_join_cross_process_aot_restart`). The EXPLAIN ANALYZE
renderings wait for the port's `query/profile.py` (ROADMAP queue 1).

This module imports nothing of jax or the JAX package at its top: the
ranks import it.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from tests.test_torch_distributed import (
    _numpy_chunk,
    _port_chunk,
    _spawn_ranks,
)

T = "//t"
WORLD = 8
SPEC = [("k", "int64", "ascending"), ("g", "int64"), ("s", "string"),
        ("v", "int64"), ("d", "double")]

CORPUS = [
    "g, sum(v) AS sv, count(*) AS c, avg(d) AS a, min(v) AS mn, "
    "max(v) AS mx FROM [//t] GROUP BY g",
    "g, sum(v) AS sv FROM [//t] WHERE v > 100 GROUP BY g "
    "HAVING count(*) > 2 ORDER BY g LIMIT 500",
    "s, sum(v) AS sv, count(*) AS c FROM [//t] GROUP BY s "
    "ORDER BY s LIMIT 100",
    "g, argmax(k, d) AS am, argmin(k, d) AS an FROM [//t] GROUP BY g "
    "ORDER BY g LIMIT 500",
    "g, avg(d) AS a FROM [//t] GROUP BY g ORDER BY avg(d) DESC LIMIT 5",
    "g + 1 AS gg, sum(v * 2) AS sv FROM [//t] WHERE d < 8.0 "
    "GROUP BY g + 1 ORDER BY g + 1 LIMIT 100",
    "g, cardinality(s) AS cd, count(*) AS c FROM [//t] GROUP BY g "
    "ORDER BY g LIMIT 500",
    "k, v, sum(v) OVER (PARTITION BY g ORDER BY k) AS rs, "
    "rank() OVER (PARTITION BY g ORDER BY k) AS rk FROM [//t] "
    "ORDER BY k LIMIT 200",
    "k, d FROM [//t] ORDER BY d DESC LIMIT 9",
    "k, v FROM [//t] WHERE v > 900",
]

MW_SPECS = {
    "//l": [("k", "int64", "ascending"), ("ok", "int64"), ("sk", "int64"),
            ("s", "string"), ("v", "int64")],
    "//d": [("d_ok", "int64"), ("d_w", "int64")],
    "//u": [("u_sk", "int64"), ("u_t", "string")],
    "//m": [("m_s", "string"), ("m_w", "int64")],
}
MW_CORPUS = [
    "d_w, sum(v) AS sv, count(*) AS c FROM [//l] JOIN [//d] ON ok = d_ok "
    "GROUP BY d_w ORDER BY d_w LIMIT 500",
    "u_t, sum(v) AS sv FROM [//l] JOIN [//u] ON sk = u_sk "
    "GROUP BY u_t ORDER BY u_t LIMIT 500",
    "m_w, count(*) AS c, sum(v) AS sv FROM [//l] "
    "JOIN [//u] ON sk = u_sk JOIN [//m] ON s = m_s "
    "GROUP BY m_w ORDER BY m_w LIMIT 100",
    "d_w, m_w, sum(v) AS sv FROM [//l] JOIN [//d] ON ok = d_ok "
    "JOIN [//u] ON sk = u_sk JOIN [//m] ON s = m_s "
    "GROUP BY d_w, m_w ORDER BY d_w, m_w LIMIT 500",
    "k, m_w, v FROM [//l] LEFT JOIN [//m] ON s = m_s WHERE v > 50",
    "k, u_t FROM [//l] LEFT JOIN [//u] ON sk = u_sk WHERE v > 90",
    "k, d_w, sum(v) OVER (PARTITION BY d_w ORDER BY k) AS rs "
    "FROM [//l] JOIN [//d] ON ok = d_ok ORDER BY k LIMIT 300",
    "d_w, cardinality(s) AS cd FROM [//l] JOIN [//d] ON ok = d_ok "
    "GROUP BY d_w ORDER BY d_w LIMIT 100",
]

BOTH_DEAD = ("parallel.all_to_all=error:times=4;"
             "parallel.gather=error:times=4")


# --- the ranks ----------------------------------------------------------------


def _worker(rank, world, store, inpath, outpath) -> None:
    from tests.test_torch_distributed import _worker as worker
    worker(rank, world, store, inpath, outpath, run_job=_run_job)


def _run_job(mesh, job: dict) -> dict:
    """Run a job's steps on this rank with one DistributedEvaluator; each
    step's rows (or error), host reads, statistics and the rung that
    served it."""
    from ytsaurus_tpu_torch import config
    from ytsaurus_tpu_torch.parallel.distributed import (
        DistributedEvaluator,
        ShardedTable,
        coordinate_distributed,
        host_sync_count,
    )
    from ytsaurus_tpu_torch.parallel.whole_plan import (
        DEFAULT_PARTITION_RULES,
        SHARDED,
        run_whole_plan,
    )
    from ytsaurus_tpu_torch.query.builder import build_query
    from ytsaurus_tpu_torch.query.statistics import QueryStatistics
    from ytsaurus_tpu_torch.schema import TableSchema
    from ytsaurus_tpu_torch.utils import failpoints, tracing

    shards = [_port_chunk(d) for d in job["shards"]]
    table = ShardedTable.from_chunks(mesh, shards)
    de = DistributedEvaluator(mesh)
    schemas = {p: TableSchema.make(spec) for p, spec in job["specs"].items()}
    foreigns = {name: {p: _port_chunk(d) for p, d in f.items()}
                for name, f in job.get("foreigns", {}).items()}
    steps = []
    for step in job["steps"]:
        plan = build_query(step["query"], schemas,
                           params=step.get("params"))
        foreign = foreigns.get(step.get("foreign")) or None
        config.set_compile_config(config.CompileConfig(
            **step.get("compile", {})))
        config.set_telemetry_config(config.TelemetryConfig(
            **step.get("telemetry", {})))
        stats = QueryStatistics()
        before = host_sync_count()
        root = tracing.start_span("test.step")
        try:
            with root, failpoints.active(step.get("fp", ""), seed=3):
                if step["action"] == "whole":
                    rules = ((r"^front$", SHARDED),) + \
                        DEFAULT_PARTITION_RULES if step.get("bad_rules") \
                        else None
                    out = run_whole_plan(de, plan, table, stats=stats,
                                         rules=rules, foreign_chunks=foreign)
                elif step["action"] == "ladder":
                    out = coordinate_distributed(plan, mesh, shards, foreign,
                                                 evaluator=de, stats=stats)
                else:
                    out = de.run(plan, table, foreign, shuffle=True,
                                 stats=stats)
            result = {"rows": out.to_rows()}
        except Exception as err:  # noqa: BLE001 — reported by the test
            result = {"error": f"{type(err).__name__}: {err}"}
        finally:
            config.set_compile_config(None)
            config.set_telemetry_config(None)
        served = [s.name for s in tracing.get_collector().find(root.trace_id)
                  if s.name.startswith("distributed.")
                  and "error" not in s.tags]
        result.update(
            syncs=host_sync_count() - before, whole_plan=stats.whole_plan,
            retries=stats.whole_plan_retries, blocks=stats.mesh_blocks,
            join_plan=stats.join_plan, served=served,
            memo=sorted(repr(k) for k in de._quota_memo))
        steps.append(result)
    return {"steps": steps}


# --- jobs, built from the JAX package's chunks -------------------------------


def _ref():
    from types import SimpleNamespace

    from ytsaurus_tpu.chunks import ColumnarChunk
    from ytsaurus_tpu.chunks.columnar import concat_chunks
    from ytsaurus_tpu.query.builder import build_query
    from ytsaurus_tpu.query.engine.evaluator import Evaluator
    from ytsaurus_tpu.schema import TableSchema
    return SimpleNamespace(ColumnarChunk=ColumnarChunk, TableSchema=TableSchema,
                           concat_chunks=concat_chunks,
                           build_query=build_query, Evaluator=Evaluator)


@functools.lru_cache(maxsize=None)
def _table8():
    """tests/test_whole_plan.py's table8 (seed 21)."""
    r = _ref()
    schema = r.TableSchema.make(SPEC)
    rng = np.random.default_rng(21)
    words = [f"w{i:02d}" for i in range(13)]
    chunks = []
    for sh in range(WORLD):
        n = 150 + sh * 11
        rows = [(sh * 10_000 + i, int(rng.integers(0, 40)),
                 words[int(rng.integers(0, 13))],
                 int(rng.integers(0, 1000)), float(rng.uniform(0, 10)))
                for i in range(n)]
        chunks.append(r.ColumnarChunk.from_rows(schema, rows))
    return chunks


@functools.lru_cache(maxsize=None)
def _dim():
    r = _ref()
    return r.ColumnarChunk.from_arrays(
        r.TableSchema.make([("dk", "int64", "ascending"), ("name", "int64")]),
        {"dk": np.arange(0, 80, 2), "name": np.arange(40) * 10})


@functools.lru_cache(maxsize=None)
def _skewed():
    """tests/test_whole_plan.py's overflow table (seed 5): ~90% of the
    rows share one partition key."""
    r = _ref()
    schema = r.TableSchema.make([("k", "int64", "ascending"),
                                 ("g", "int64"), ("v", "int64")])
    rng = np.random.default_rng(5)
    chunks = []
    for sh in range(WORLD):
        n = 256
        g = np.where(rng.uniform(size=n) < 0.9, 7, rng.integers(0, 32, n))
        chunks.append(r.ColumnarChunk.from_arrays(schema, {
            "k": np.arange(n) + sh * n, "g": g,
            "v": rng.integers(0, 100, n)}))
    return chunks


@functools.lru_cache(maxsize=None)
def _telemetry_table():
    """tests/test_whole_plan.py's telemetry table (seed 11) and its g / v
    columns."""
    r = _ref()
    schema = r.TableSchema.make([("k", "int64", "ascending"),
                                 ("g", "int64"), ("v", "int64")])
    rng = np.random.default_rng(11)
    sizes = [40 + 9 * sh for sh in range(WORLD)]
    g_cols, v_cols, chunks = [], [], []
    for sh, rows in enumerate(sizes):
        g = rng.integers(0, 12, rows)
        v = rng.integers(0, 1000, rows)
        g_cols.append(g)
        v_cols.append(v)
        chunks.append(r.ColumnarChunk.from_arrays(schema, {
            "k": np.arange(rows) + sh * 10_000, "g": g, "v": v}))
    return chunks, sizes, g_cols, v_cols


@functools.lru_cache(maxsize=None)
def _mw_tables():
    """tests/test_multiway_join.py's mw_tables (seed 37)."""
    r = _ref()
    schemas = {p: r.TableSchema.make(s) for p, s in MW_SPECS.items()}
    rng = np.random.default_rng(37)
    words = [f"w{i:02d}" for i in range(13)]
    chunks = []
    for sh in range(WORLD):
        n = 120 + sh * 9
        rows = []
        for i in range(n):
            rows.append((
                sh * 10_000 + i,
                int(rng.integers(0, 50)) if rng.uniform() > 0.1 else None,
                int(rng.integers(0, 40)),
                words[int(rng.integers(0, 13))],
                int(rng.integers(0, 100))))
        chunks.append(r.ColumnarChunk.from_rows(schemas["//l"], rows))
    dim = r.ColumnarChunk.from_arrays(schemas["//d"], {
        "d_ok": np.arange(50), "d_w": np.arange(50) * 3 % 7})
    dup_rows = [(key, f"t{key % 5}")
                for key in range(40) for _ in range(int(rng.integers(0, 4)))]
    dup = r.ColumnarChunk.from_rows(schemas["//u"], dup_rows)
    sdim = r.ColumnarChunk.from_rows(
        schemas["//m"], [(w, i * 10) for i, w in enumerate(words[:9])])
    return chunks, {"//d": dim, "//u": dup, "//m": sdim}


@functools.lru_cache(maxsize=None)
def _skewed_join():
    """tests/test_multiway_join.py's quota overflow tables (seed 11)."""
    r = _ref()
    fact = r.TableSchema.make([("k", "int64", "ascending"),
                               ("ok", "int64"), ("v", "int64")])
    dup = r.TableSchema.make([("d_ok", "int64"), ("d_t", "int64")])
    rng = np.random.default_rng(11)
    per = 256
    chunks = []
    for sh in range(WORLD):
        ok = np.where(rng.uniform(size=per) < 0.9, 7,
                      rng.integers(0, 64, per))
        chunks.append(r.ColumnarChunk.from_arrays(fact, {
            "k": np.arange(per) + sh * per, "ok": ok,
            "v": rng.integers(0, 100, per)}))
    dup_chunk = r.ColumnarChunk.from_rows(
        dup, [(k, k * 10 + j) for k in range(64) for j in range(3)])
    return chunks, {"//d": dup_chunk}


@functools.lru_cache(maxsize=None)
def _drift_tables():
    """tests/test_multiway_join.py's stats-drift tables (seed 23)."""
    r = _ref()
    fact = r.TableSchema.make([("k", "int64", "ascending"),
                               ("ok", "int64"), ("v", "int64")])
    dim = r.TableSchema.make([("d_ok", "int64"), ("d_w", "int64")])
    rng = np.random.default_rng(23)
    per = 128
    chunks = [r.ColumnarChunk.from_arrays(fact, {
        "k": np.arange(per) + s * per, "ok": rng.integers(0, 64, per),
        "v": rng.integers(0, 100, per)}) for s in range(WORLD)]
    small = r.ColumnarChunk.from_arrays(dim, {
        "d_ok": np.arange(64), "d_w": np.arange(64)})
    grown = r.ColumnarChunk.from_arrays(dim, {
        "d_ok": np.arange(64).repeat(4), "d_w": np.arange(256) % 64})
    return chunks, {"small": {"//d": small}, "grown": {"//d": grown}}


VEC_DIM = 8
VEC_SPEC = [("k", "int64", "ascending"), ("g", "int64"),
            ("emb", f"vector<float, {VEC_DIM}>"), ("v", "int64")]
QUERY_VECTOR = [1.0, -2.0, 3.0, 0.0, 5.0, -1.0, 2.0, 4.0]


@functools.lru_cache(maxsize=None)
def _vtable8():
    """tests/test_vector.py's vtable8 (its _corpus, seeds 20 + shard)."""
    import tests.test_vector as ref_tests
    r = _ref()
    schema = r.TableSchema.make(VEC_SPEC)
    chunks = []
    for sh in range(WORLD):
        rows = ref_tests._corpus(40 + sh * 7, seed=20 + sh,
                                 null_every=13 if sh % 2 else 0)
        for row in rows:
            row["k"] += sh * 10_000
        chunks.append(r.ColumnarChunk.from_rows(schema, rows))
    return chunks


def _step(query, action="whole", **kw) -> dict:
    return {"query": query, "action": action, **kw}


JOBS = {
    "corpus": (_table8, {T: SPEC}, None,
               [_step(q) for q in CORPUS]),
    "unfusable": (_table8, {T: SPEC, "//d": [("dk", "int64", "ascending"),
                                              ("name", "int64")]},
                  lambda: {"dim": {"//d": _dim()}},
                  [_step("g, name, sum(v) AS sv FROM [//t] JOIN [//d] "
                         "ON g = dk GROUP BY g, name"),
                   _step("g, name, sum(v) AS sv FROM [//t] JOIN [//d] "
                         "ON g = dk GROUP BY g, name", "ladder",
                         foreign="dim")]),
    "failpoint": (_table8, {T: SPEC}, None,
                  [_step(CORPUS[0], "ladder"),
                   _step(CORPUS[0], "ladder",
                         fp="parallel.all_to_all=error:times=1"),
                   _step(CORPUS[0], "ladder", fp=BOTH_DEAD)]),
    "overflow": (_skewed, {T: [("k", "int64", "ascending"), ("g", "int64"),
                               ("v", "int64")]}, None,
                 [_step("k, sum(v) OVER (PARTITION BY g) AS s FROM [//t] "
                        "ORDER BY k LIMIT 100")] * 2),
    "rules": (_table8, {T: SPEC}, None,
              [_step(CORPUS[0], bad_rules=True)]),
    "telemetry": (lambda: _telemetry_table()[0],
                  {T: [("k", "int64", "ascending"), ("g", "int64"),
                       ("v", "int64")]}, None,
                  [_step("k, v FROM [//t] WHERE v > 500"),
                   _step("k, v, sum(v) OVER (PARTITION BY g ORDER BY k) "
                         "AS rs FROM [//t] ORDER BY k LIMIT 64")]),
    "disarm": (_table8, {T: SPEC}, None,
               [_step(CORPUS[0]),
                _step(CORPUS[0], telemetry={"mesh_telemetry": False})]),
    "stitched": (_table8, {T: SPEC}, None,
                 [_step("g, sum(v) AS sv FROM [//t] GROUP BY g",
                        "stitched")]),
    "mw": (lambda: _mw_tables()[0], MW_SPECS,
           lambda: {"mw": _mw_tables()[1]},
           [_step(q, foreign="mw") for q in MW_CORPUS for _ in range(2)]),
    "mw_ladder": (lambda: _mw_tables()[0], MW_SPECS,
                  lambda: {"mw": _mw_tables()[1]},
                  [_step(MW_CORPUS[1], "ladder", foreign="mw"),
                   _step(MW_CORPUS[1], "ladder", foreign="mw",
                         fp="parallel.all_to_all=error:times=1"),
                   _step(MW_CORPUS[1], "ladder", foreign="mw",
                         fp=BOTH_DEAD)]),
    "mw_overflow": (lambda: _skewed_join()[0],
                    {"//l": [("k", "int64", "ascending"), ("ok", "int64"),
                             ("v", "int64")],
                     "//d": [("d_ok", "int64"), ("d_t", "int64")]},
                    lambda: {"dup": _skewed_join()[1]},
                    [_step("d_t, count(*) AS c FROM [//l] JOIN [//d] "
                           "ON ok = d_ok GROUP BY d_t ORDER BY d_t LIMIT 500",
                           foreign="dup")] * 2),
    "drift": (lambda: _drift_tables()[0],
              {"//l": [("k", "int64", "ascending"), ("ok", "int64"),
                       ("v", "int64")],
               "//d": [("d_ok", "int64"), ("d_w", "int64")]},
              lambda: _drift_tables()[1],
              [_step("d_w, sum(v) AS sv FROM [//l] JOIN [//d] ON ok = d_ok "
                     "GROUP BY d_w ORDER BY d_w LIMIT 500", foreign=which,
                     compile={"broadcast_join_rows": 100})
               for which in ("small", "small", "grown")]),
    "nearest": (_vtable8, {T: VEC_SPEC}, None,
                [_step(f"SELECT k FROM [{T}] NEAREST(emb, ?, 9, '{metric}')",
                       params=[QUERY_VECTOR])
                 for metric in ("l2", "cosine", "dot")]),
}


def _job(name: str) -> dict:
    shards_fn, specs, foreigns_fn, steps = JOBS[name]
    foreigns = foreigns_fn() if foreigns_fn is not None else {}
    return {"name": name, "shards": [_numpy_chunk(c) for c in shards_fn()],
            "specs": specs,
            "foreigns": {k: {p: _numpy_chunk(c) for p, c in f.items()}
                         for k, f in foreigns.items()},
            "steps": steps}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _spawn_ranks([_job(name) for name in JOBS],
                        str(tmp_path_factory.mktemp("whole8")),
                        module="tests.test_torch_whole_plan")


def _steps(ranks: list, name: str) -> list:
    """The job's step results, once all ranks are seen to agree."""
    first = ranks[0][name]
    assert "error" not in first, first["error"]
    for rank, result in enumerate(ranks[1:], 1):
        assert result[name] == first, f"rank {rank} disagrees with rank 0"
    return first["steps"]


def _ok(step: dict) -> dict:
    assert "error" not in step, step["error"]
    return step


def _oracle(name: str, step_index: int) -> list:
    """The JAX package's local evaluator over the concatenated shards."""
    step = JOBS[name][3][step_index]
    return _oracle_rows(name, step["query"], step.get("foreign"),
                        tuple(map(tuple, step.get("params") or ())))


@functools.lru_cache(maxsize=None)
def _oracle_rows(name: str, query: str, foreign_name, params) -> list:
    r = _ref()
    shards_fn, specs, foreigns_fn, _ = JOBS[name]
    foreigns = foreigns_fn() if foreigns_fn is not None else {}
    schemas = {p: r.TableSchema.make(s) for p, s in specs.items()}
    plan = r.build_query(query, schemas,
                         params=[list(p) for p in params] or None)
    return r.Evaluator().run_plan(plan, r.concat_chunks(list(shards_fn())),
                                  foreigns.get(foreign_name) or None
                                  ).to_rows()


def _check(ranks, name: str, step_index: int, ordered=None) -> dict:
    from tests.test_torch_query import _assert_rows
    step = _ok(_steps(ranks, name)[step_index])
    if ordered is None:
        ordered = "ORDER BY" in JOBS[name][3][step_index]["query"]
    _assert_rows(step["rows"], _oracle(name, step_index), ordered)
    return step


# --- tests/test_whole_plan.py -------------------------------------------------


@pytest.mark.parametrize("index", range(len(CORPUS)))
def test_dual_check_corpus(ranks, index):
    """Each corpus query on the whole-plan rung equals the local
    evaluator, at exactly one host read."""
    step = _check(ranks, "corpus", index)
    assert step["whole_plan"] == 1 and step["syncs"] == 1
    [block] = step["blocks"]
    assert block["path"] == "fused" and block["shards"] == WORLD


def test_unfusable_plans_fall_to_stitched_ladder(ranks):
    """A join plan with no foreign data raises on the rung; with it, the
    ladder serves it on the whole-plan rung. WITH TOTALS is gated."""
    from ytsaurus_tpu_torch.parallel.whole_plan import can_fuse
    from ytsaurus_tpu_torch.query.builder import build_query
    from ytsaurus_tpu_torch.schema import TableSchema
    from dataclasses import replace as dc_replace
    no_foreign, ladder = _steps(ranks, "unfusable")
    assert "No data provided for join table" in no_foreign["error"]
    _check(ranks, "unfusable", 1)
    assert ladder["whole_plan"] == 1
    assert ladder["served"] == ["distributed.whole_plan"]
    plan = build_query("g, sum(v) AS sv FROM [//t] GROUP BY g",
                       {T: TableSchema.make(SPEC)})
    assert can_fuse(plan) is None
    totals = dc_replace(plan, group=dc_replace(plan.group, totals=True))
    assert "TOTALS" in can_fuse(totals)


def test_failpoint_fault_lands_on_stitched_ladder(ranks):
    """parallel.all_to_all=error:times=1 knocks out the whole-plan rung:
    the stitched shuffle serves the same rows; with every collective dead
    the host coordinator answers."""
    base, knocked, dead = _steps(ranks, "failpoint")
    _check(ranks, "failpoint", 0)
    assert base["whole_plan"] == 1
    assert base["served"] == ["distributed.whole_plan"]
    from tests.test_torch_query import _assert_rows
    _assert_rows(_ok(knocked)["rows"], base["rows"], ordered=False)
    assert knocked["whole_plan"] == 0
    assert knocked["served"] == ["distributed.shuffle"]
    assert knocked["blocks"][0]["path"] == "stitched"
    _assert_rows(_ok(dead)["rows"], base["rows"], ordered=False)
    assert dead["served"] == ["distributed.host_coordinate"]


def test_overflow_escalation_and_quota_memo(ranks):
    """Skewed PARTITION BY keys overflow the first quota: the query re-runs
    at the demanded rung with the right rows, the quota memoizes, and the
    next query runs clean."""
    first = _check(ranks, "overflow", 0)
    second = _check(ranks, "overflow", 1)
    assert first["retries"] >= 1 and first["memo"]
    assert second["retries"] == 0 and second["syncs"] == 1
    assert first["rows"] == second["rows"]


def test_partition_rule_registry(ranks):
    from ytsaurus_tpu_torch.errors import YtError
    from ytsaurus_tpu_torch.parallel.whole_plan import (
        DEFAULT_PARTITION_RULES,
        REPLICATED,
        SHARDED,
        match_partition_rules,
        rules_fingerprint,
    )
    rules = DEFAULT_PARTITION_RULES
    assert match_partition_rules(rules, "scan/k") == SHARDED
    assert match_partition_rules(rules, "shuffle/group") == SHARDED
    assert match_partition_rules(rules, "front") == REPLICATED
    with pytest.raises(YtError):
        match_partition_rules(rules, "nonsense-stage")
    bad = ((r"^front$", SHARDED),) + rules
    assert rules_fingerprint(bad) != rules_fingerprint(rules)
    [step] = _steps(ranks, "rules")
    assert "partition rules place stage" in step["error"]


def _oracle_pids(values, n: int):
    """Destination rank per row by the reference's canonical hash, from
    the JAX package's own helpers over the raw numpy column."""
    import jax.numpy as jnp

    from ytsaurus_tpu.parallel.distributed import _canonical_hash_plane
    from ytsaurus_tpu.query.engine.expr import _combine_u64, _mix_u64
    acc = jnp.full(len(values), np.uint64(0x9E3779B97F4A7C15),
                   dtype=jnp.uint64)
    acc = _combine_u64(acc, _mix_u64(_canonical_hash_plane(
        jnp.asarray(values, dtype=jnp.int64))))
    return np.asarray(acc % np.uint64(n)).astype(int)


def test_mesh_telemetry_block_matches_numpy_oracle(ranks):
    from ytsaurus_tpu_torch.parallel.whole_plan import MESH_TELEMETRY_VERSION
    _, sizes, g_cols, v_cols = _telemetry_table()
    gather, window = _steps(ranks, "telemetry")
    _check(ranks, "telemetry", 0)
    _check(ranks, "telemetry", 1)
    assert gather["syncs"] == 1 and window["syncs"] == 1
    [block] = gather["blocks"]
    want_out = [int((v > 500).sum()) for v in v_cols]
    assert block["version"] == MESH_TELEMETRY_VERSION
    assert block["path"] == "fused" and block["shards"] == WORLD
    assert block["in_rows"] == sizes and block["out_rows"] == want_out
    assert block["skew"] == round(max(want_out) / (sum(want_out) / 8), 4)
    assert block["exchanges"] == [] and block["exchange_bytes"] == 0
    assert window["retries"] == 0
    [blockw] = window["blocks"]
    matrix = np.zeros((WORLD, WORLD), dtype=int)
    for sh in range(WORLD):
        matrix[sh] = np.bincount(_oracle_pids(g_cols[sh], WORLD),
                                 minlength=WORLD)
    [entry] = blockw["exchanges"]
    assert entry["stage"] == "shuffle/exchange-rows"
    assert entry["matrix"] == matrix.reshape(-1).tolist()
    assert entry["rows"] == int(matrix.sum())
    assert entry["demand"] == int(matrix.max())
    assert entry["quota"] >= entry["demand"]
    assert entry["headroom"] == round(matrix.max() / entry["quota"], 4)
    assert entry["bytes"] == int(matrix.sum()) * 27
    assert blockw["exchange_bytes"] == entry["bytes"]
    assert blockw["in_rows"] == sizes
    assert blockw["out_rows"] == matrix.sum(axis=0).tolist()


def test_mesh_telemetry_disarm_is_free_and_bit_identical(ranks):
    armed, plain = _steps(ranks, "disarm")
    _check(ranks, "disarm", 0)
    assert armed["syncs"] == 1 and plain["syncs"] == 1
    assert len(armed["blocks"]) == 1 and plain["blocks"] == []
    assert armed["blocks"][0]["exchange_bytes"] > 0
    assert _ok(plain)["rows"] == armed["rows"]


def test_stitched_rungs_report_the_same_block_shape(ranks):
    from ytsaurus_tpu_torch.parallel.whole_plan import MESH_TELEMETRY_VERSION
    [step] = _steps(ranks, "stitched")
    _check(ranks, "stitched", 0)
    block = step["blocks"][0]
    assert block["version"] == MESH_TELEMETRY_VERSION
    assert block["path"] == "stitched" and block["shards"] == WORLD
    assert block["in_rows"] == [c.row_count for c in _table8()]
    [entry] = block["exchanges"]
    assert entry["stage"] == "shuffle/stitched"
    assert sum(entry["matrix"]) == entry["rows"] > 0
    assert entry["quota"] >= entry["demand"] == max(entry["matrix"])


# --- tests/test_multiway_join.py ----------------------------------------------


@pytest.mark.parametrize("index", range(len(MW_CORPUS)))
def test_multiway_dual_check_corpus(ranks, index):
    """Each multi-way join plan on the whole-plan rung equals the local
    evaluator; its steady-state run reads the host once."""
    first = _check(ranks, "mw", 2 * index)
    second = _check(ranks, "mw", 2 * index + 1)
    assert first["whole_plan"] == 1 and second["syncs"] == 1
    assert first["rows"] == second["rows"]


def test_join_ladder_serves_fused_and_degrades(ranks):
    base, knocked, dead = _steps(ranks, "mw_ladder")
    _check(ranks, "mw_ladder", 0)
    assert base["whole_plan"] == 1
    assert base["join_plan"][0]["strategy"] == "partition"
    from tests.test_torch_query import _assert_rows
    _assert_rows(_ok(knocked)["rows"], base["rows"], ordered=True)
    assert knocked["whole_plan"] == 0
    assert knocked["served"] == ["distributed.gather_merge"]
    _assert_rows(_ok(dead)["rows"], base["rows"], ordered=True)
    assert dead["served"] == ["distributed.host_coordinate"]


def test_quota_overflow_escalation_and_memo(ranks):
    first = _check(ranks, "mw_overflow", 0)
    second = _check(ranks, "mw_overflow", 1)
    assert first["retries"] >= 1 and second["retries"] == 0
    assert second["syncs"] == 1 and first["rows"] == second["rows"]


def test_stats_drift_flips_strategy_new_program(ranks):
    """A foreign side growing past the broadcast threshold (and losing
    its unique keys) flips the strategy to partition, under a new memo
    key, with the right rows."""
    small, again, grown = _steps(ranks, "drift")
    for i in range(3):
        _check(ranks, "drift", i)
    assert small["join_plan"][0]["strategy"] == "broadcast"
    assert again["join_plan"][0]["strategy"] == "broadcast"
    assert small["memo"] == [] and again["syncs"] == 1
    assert grown["join_plan"][0]["strategy"] == "partition"
    assert any("partition" in key for key in grown["memo"])


# --- tests/test_vector.py -----------------------------------------------------


@pytest.mark.parametrize("index,metric", enumerate(["l2", "cosine", "dot"]))
def test_nearest_spmd_bit_identical_one_sync(ranks, index, metric):
    step = _check(ranks, "nearest", index, ordered=True)
    assert step["syncs"] == 1 and step["whole_plan"] == 1
    assert len(step["rows"]) == 9
