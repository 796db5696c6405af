"""Parity of the port's mesh paths (`ytsaurus_tpu_torch.parallel`) with the
JAX package on the CPU, over 8 gloo ranks.

The ranks are 8 processes spawned once per module, each with jax and the
JAX package blocked in `sys.modules` (so the port's mesh modules also run
and import without them), one torch thread, and a `file://` store under
the test's temporary directory. Every rank runs every case in one go and
returns its rows; each test asserts that all 8 ranks agree, then holds
rank 0's rows against the JAX package's local `Evaluator` (its
`select_rows`) over the concatenated shards, the oracle the reference's
own SPMD tests hold themselves to. The JAX `DistributedEvaluator` is not
run: its 8-device compiles are why the reference marks its mesh test
files slow.

The cases are twins of the reference's, with the same seeds and shapes:
the 12 tests of tests/test_distributed.py and steps 1-4 of
`__graft_entry__.dryrun_multichip` at its size (the QL corpus and window
twins are in tests/test_torch_distributed_ql.py, the sort's in
tests/test_torch_shuffle_sort.py, both on this module's ranks). Their chunks are made by
the JAX package and carried to the ranks as numpy planes. Integers, codes,
group sets and orders match exactly (tests/harness.py's canon), doubles to
rtol 1e-9, since partial sums merged across ranks add in another order
than the local evaluator's; unordered results compare as sets, ORDER BY
results as sequences.

This module imports nothing of jax or the JAX package at its top: the
ranks import it to run `_worker`.
"""

from __future__ import annotations

import datetime
import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
# Seconds a collective may wait before its rank gives up, and the whole
# spawn before the test does.
COLLECTIVE_TIMEOUT_S = 120
SPAWN_TIMEOUT_S = 300
T = "//t"

torch.set_num_threads(1)


# --- the ranks ----------------------------------------------------------------

_WORKER = (
    "import os, sys\n"
    "os.nice(5)\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['ytsaurus_tpu'] = None\n"
    f"sys.path.insert(0, {ROOT!r})\n"
    "from {module} import _worker\n"
    "_worker(*sys.argv[1:])\n")


def _spawn_ranks(jobs: list, tmp_dir, world: int = WORLD,
                 module: str = "tests.test_torch_distributed") -> list:
    """Run `jobs` on `world` fresh gloo ranks, each through `_worker` of
    `module`; each rank's results by job name, in rank order. The ranks
    run at a lower CPU priority (nice 5), so that their eight processes
    yield to the test processes beside them, the CPU-timed ones among
    them."""
    inpath = os.path.join(tmp_dir, "jobs.pkl")
    with open(inpath, "wb") as f:
        pickle.dump(jobs, f)
    store = os.path.join(tmp_dir, "store")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER.format(module=module), str(rank),
         str(world), store, inpath,
         os.path.join(tmp_dir, f"out{rank}.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, proc in enumerate(procs):
        assert proc.returncode == 0, f"rank {rank}:\n{logs[rank][-4000:]}"
    results = []
    for rank in range(world):
        with open(os.path.join(tmp_dir, f"out{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _worker(rank, world, store, inpath, outpath, run_job=None) -> None:
    """One rank: runs every job through `run_job` (default `_run_job`)."""
    from ytsaurus_tpu_torch.parallel.mesh import destroy_mesh, make_mesh
    run_job = run_job or _run_job
    mesh = make_mesh("cpu", init_method=f"file://{store}", rank=int(rank),
                     world_size=int(world),
                     timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    with open(inpath, "rb") as f:
        jobs = pickle.load(f)
    results = {}
    for job in jobs:
        try:
            results[job["name"]] = run_job(mesh, job)
        except Exception as err:  # noqa: BLE001 — reported by the test
            results[job["name"]] = {"error": f"{type(err).__name__}: {err}"}
    with open(outpath, "wb") as f:
        pickle.dump(results, f)
    destroy_mesh()


def _port_chunk(d: dict):
    from ytsaurus_tpu_torch.chunks.columnar import chunk_from_numpy
    return chunk_from_numpy(d["spec"], d["row_count"], d["planes"],
                            d["vocabs"], d["sorted_by"], device="cpu")


def _run_job(mesh, job: dict) -> dict:
    import torch.distributed as dist

    from ytsaurus_tpu_torch.parallel.distributed import (
        DistributedEvaluator,
        ShardedTable,
        coordinate_distributed,
        host_sync_count,
    )
    from ytsaurus_tpu_torch.parallel.mesh import Mesh
    from ytsaurus_tpu_torch.parallel.shuffle import sort_table
    from ytsaurus_tpu_torch.query.builder import build_query
    from ytsaurus_tpu_torch.query.statistics import QueryStatistics
    from ytsaurus_tpu_torch.schema import TableSchema

    if len(job["shards"]) == 1 and mesh.size > 1:
        # A mesh of one: every rank runs the job on a group of its own.
        groups = [dist.new_group([r]) for r in range(mesh.size)]
        mesh = Mesh(group=groups[mesh.rank], rank=0, size=1,
                    device=mesh.device, backend=mesh.backend)
    shards = [_port_chunk(d) for d in job["shards"]]
    table = ShardedTable.from_chunks(mesh, shards)
    if job["kind"] == "sort":
        out = sort_table(table, job["keys"], job.get("descending", False))
        return {"rows": out.local_chunk().to_rows(),
                "row_counts": out.row_counts,
                "keys": out.schema.key_column_names}
    ev = DistributedEvaluator(mesh)
    runs = []
    for run in job["runs"]:
        schemas = {p: TableSchema.make(spec)
                   for p, spec in run["schemas"].items()}
        foreign = {p: _port_chunk(d) for p, d in run["foreign"].items()}
        plan = build_query(run["query"], schemas)
        before = host_sync_count()
        stats = QueryStatistics()
        if run.get("ladder"):
            rows = coordinate_distributed(plan, mesh, shards, foreign or None,
                                          evaluator=ev, stats=stats).to_rows()
        else:
            rows = ev.run(plan, table, foreign or None,
                          **run["kwargs"]).to_rows()
        runs.append({"rows": rows, "syncs": host_sync_count() - before,
                     "whole_plan": stats.whole_plan})
    return {"runs": runs}


# --- jobs, built from the JAX package's chunks -------------------------------


def _numpy_chunk(chunk) -> dict:
    """A JAX-package chunk as the numpy arguments of `chunk_from_numpy`."""
    return {
        "spec": [(c.name, c.type.value)
                 + ((c.sort_order.value,) if c.sort_order is not None else ())
                 for c in chunk.schema],
        "row_count": chunk.row_count,
        "planes": {c.name: (np.asarray(chunk.columns[c.name].data),
                            np.asarray(chunk.columns[c.name].valid))
                   for c in chunk.schema},
        "vocabs": {name: col.dictionary for name, col in chunk.columns.items()
                   if col.dictionary is not None},
        "sorted_by": tuple(chunk.sorted_by)}


def _spec(schema) -> list:
    return [(c.name, c.type.value)
            + ((c.sort_order.value,) if c.sort_order is not None else ())
            for c in schema]


_CASE_MAKERS: dict = {}


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """(shards, runs) of one case, as JAX-package chunks; each run is
    (query, schemas, foreign chunks, run() keyword arguments). Cases are
    made by the makers of this module and of the modules that import
    it."""
    return _CASE_MAKERS[name]()


def _job(name: str) -> dict:
    shards, runs = _case(name)
    return {"name": name, "kind": "query",
            "shards": [_numpy_chunk(c) for c in shards],
            "runs": [{"query": q, "schemas": {p: _spec(s) for p, s in
                                              schemas.items()},
                      "foreign": {p: _numpy_chunk(c) for p, c in
                                  foreign.items()},
                      "kwargs": kwargs}
                     for q, schemas, foreign, kwargs in runs]}


def _ref():
    """The JAX package's pieces the oracles and cases need."""
    from types import SimpleNamespace

    from ytsaurus_tpu.chunks import ColumnarChunk
    from ytsaurus_tpu.chunks.columnar import concat_chunks
    from ytsaurus_tpu.query.engine.evaluator import select_rows
    from ytsaurus_tpu.schema import TableSchema
    return SimpleNamespace(ColumnarChunk=ColumnarChunk, TableSchema=TableSchema,
                           concat_chunks=concat_chunks,
                           select_rows=select_rows)


# tests/test_distributed.py, seed for seed.

DIST_SPEC = [("k", "int64", "ascending"), ("g", "int64"), ("v", "double")]


def _table8():
    r = _ref()
    schema = r.TableSchema.make(DIST_SPEC)
    rng = np.random.default_rng(42)
    chunks = []
    for s in range(8):
        n = 100 + s * 13
        chunks.append(r.ColumnarChunk.from_arrays(
            schema, {"k": np.arange(n) + s * 10_000,
                     "g": rng.integers(0, 5, n),
                     "v": rng.uniform(0, 10, n)}))
    return chunks, schema


def _runs(schemas, *queries, foreign=None, kwargs=({},)):
    return [(q, schemas, foreign or {}, kw) for q in queries for kw in kwargs]


def _case_group_by():
    chunks, schema = _table8()
    return chunks, _runs({T: schema}, f"g, sum(v) AS s, count(*) AS c, "
                         f"avg(v) AS a FROM [{T}] GROUP BY g")


def _case_filter_scan():
    chunks, schema = _table8()
    return chunks, _runs({T: schema}, f"k FROM [{T}] WHERE v > 9.0")


def _case_top_k():
    chunks, schema = _table8()
    return chunks, _runs({T: schema},
                         f"k, v FROM [{T}] ORDER BY v DESC LIMIT 5")


def _case_string_group_keys():
    r = _ref()
    schema = r.TableSchema.make([("k", "int64", "ascending"),
                                 ("s", "string")])
    names = ["ant", "bee", "cat", "dog"]
    chunks = [r.ColumnarChunk.from_rows(
        schema, [(d * 100 + i, names[(d + i) % 4]) for i in range(10)])
        for d in range(8)]
    return chunks, _runs({T: schema},
                         f"s, count(*) AS c FROM [{T}] GROUP BY s")


def _case_shuffled_group_by():
    r = _ref()
    rng = np.random.default_rng(5)
    schema = r.TableSchema.make(DIST_SPEC)
    chunks = []
    for s in range(8):
        n = 400
        chunks.append(r.ColumnarChunk.from_arrays(
            schema, {"k": np.arange(n) + s * n,
                     "g": rng.integers(0, 500, n),
                     "v": rng.uniform(0, 1, n)}))
    return chunks, _runs({T: schema},
                         "g, sum(v) AS s, count(*) AS c FROM [//t] GROUP BY "
                         "g ORDER BY g LIMIT 1000",
                         kwargs=({"shuffle": True}, {"shuffle": False}))


def _case_shuffled_having_strings():
    r = _ref()
    schema = r.TableSchema.make([("k", "int64", "ascending"), ("s", "string"),
                                 ("v", "int64")])
    words = [f"w{i:03d}" for i in range(60)]
    chunks = [r.ColumnarChunk.from_rows(schema, [
        (d * 100 + i, words[(d * 13 + i) % 60], i) for i in range(50)])
        for d in range(8)]
    return chunks, _runs({T: schema},
                         "s, sum(v) AS t FROM [//t] GROUP BY s HAVING "
                         "sum(v) > 150 ORDER BY s LIMIT 100",
                         kwargs=({"shuffle": True}, {"shuffle": False}))


def _case_join_q3_shape():
    r = _ref()
    rng = np.random.default_rng(9)
    li = r.TableSchema.make([("l_orderkey", "int64"),
                             ("l_extendedprice", "double")])
    od = r.TableSchema.make([("o_orderkey", "int64", "ascending"),
                             ("o_custkey", "int64")])
    n_orders = 400
    orders = r.ColumnarChunk.from_arrays(od, {
        "o_orderkey": np.arange(n_orders) * 3,
        "o_custkey": rng.integers(0, 20, n_orders)})
    chunks = []
    for s in range(8):
        n = 150 + 11 * s
        chunks.append(r.ColumnarChunk.from_arrays(li, {
            "l_orderkey": rng.integers(0, n_orders * 3, n),
            "l_extendedprice": rng.uniform(1, 100, n)}))
    return chunks, _runs(
        {"//li": li, "//ord": od},
        "o_custkey, sum(l_extendedprice) AS rev, count(*) AS c FROM [//li] "
        "JOIN [//ord] ON l_orderkey = o_orderkey GROUP BY o_custkey",
        foreign={"//ord": orders})


def _case_left_join():
    r = _ref()
    left = r.TableSchema.make([("k", "int64"), ("v", "int64")])
    dim_schema = r.TableSchema.make([("dk", "int64", "ascending"),
                                     ("name", "int64")])
    dim = r.ColumnarChunk.from_arrays(dim_schema, {
        "dk": np.array([0, 2, 4]), "name": np.array([100, 102, 104])})
    chunks = [r.ColumnarChunk.from_arrays(left, {
        "k": np.arange(6) + s, "v": np.full(6, s)}) for s in range(8)]
    return chunks, _runs({"//l": left, "//d": dim_schema},
                         "k, name FROM [//l] LEFT JOIN [//d] ON k = dk",
                         foreign={"//d": dim})


def _case_join_duplicate_keys():
    r = _ref()
    left = r.TableSchema.make([("k", "int64"), ("v", "int64")])
    dim_schema = r.TableSchema.make([("dk", "int64", "ascending"),
                                     ("x", "int64")])
    dim = r.ColumnarChunk.from_rows(dim_schema.to_unsorted(),
                                    [(1, 10), (1, 11), (2, 20)])
    chunks = [r.ColumnarChunk.from_arrays(left, {
        "k": np.arange(4), "v": np.arange(4)}) for _ in range(8)]
    return chunks, _runs({"//l": left, "//d": dim_schema},
                         "k, x FROM [//l] JOIN [//d] ON k = dk",
                         foreign={"//d": dim})


def _case_fact_to_fact():
    r = _ref()
    rng = np.random.default_rng(17)
    a_schema = r.TableSchema.make([("ak", "int64"), ("av", "double")])
    b_schema = r.TableSchema.make([("bk", "int64"), ("bv", "int64")])
    n_b = 700
    fact_b = r.ColumnarChunk.from_arrays(b_schema, {
        "bk": rng.integers(0, 50, n_b), "bv": rng.integers(0, 1000, n_b)})
    chunks = []
    for s in range(8):
        n = 120 + 9 * s
        chunks.append(r.ColumnarChunk.from_arrays(a_schema, {
            "ak": rng.integers(0, 80, n), "av": rng.uniform(0, 10, n)}))
    return chunks, _runs({"//a": a_schema, "//b": b_schema},
                         "ak, sum(av) AS s, count(*) AS c FROM [//a] JOIN "
                         "[//b] ON ak = bk GROUP BY ak",
                         foreign={"//b": fact_b},
                         kwargs=({}, {"shuffle": True}))


def _case_left_join_dup_nulls():
    r = _ref()
    left = r.TableSchema.make([("k", "int64"), ("v", "int64")])
    dim_schema = r.TableSchema.make([("dk", "int64"), ("x", "int64")])
    dim = r.ColumnarChunk.from_rows(dim_schema,
                                    [(0, 100), (0, 101), (2, 102)])
    chunks = [r.ColumnarChunk.from_rows(left, [(0, s), (1, s), (None, s)])
              for s in range(8)]
    return chunks, _runs({"//l": left, "//d": dim_schema},
                         "k, v, x FROM [//l] LEFT JOIN [//d] ON k = dk",
                         foreign={"//d": dim})


def _case_string_key_join():
    r = _ref()
    left = r.TableSchema.make([("name", "string"), ("v", "int64")])
    dim_schema = r.TableSchema.make([("dname", "string"), ("x", "int64")])
    dim_u = r.ColumnarChunk.from_rows(dim_schema, [
        ("alpha", 1), ("beta", 2), ("gamma", 3)])
    dim_d = r.ColumnarChunk.from_rows(dim_schema, [
        ("alpha", 1), ("alpha", 2), ("delta", 9)])
    names = ["alpha", "beta", "delta", "zeta"]
    chunks = [r.ColumnarChunk.from_rows(left, [
        (names[(s + i) % 4], i) for i in range(5)]) for s in range(8)]
    query = "name, v, x FROM [//l] JOIN [//d] ON name = dname"
    schemas = {"//l": left, "//d": dim_schema}
    return chunks, (_runs(schemas, query, foreign={"//d": dim_u})
                    + _runs(schemas, query, foreign={"//d": dim_d}))


# __graft_entry__.dryrun_multichip, steps 1-4, at its size.

LINEITEM = "//tpch/lineitem"
ORDERS = "//tpch/orders"


def _tpch_schemas():
    from ytsaurus_tpu.models import tpch
    return {LINEITEM: tpch.LINEITEM_SCHEMA, ORDERS: tpch.ORDERS_SCHEMA}


def _case_dryrun_q1():
    from ytsaurus_tpu.models import tpch
    shards = [tpch.generate_lineitem(256, seed=s) for s in range(WORLD)]
    return shards, _runs(_tpch_schemas(), tpch.Q1)


def _case_dryrun_q3():
    from ytsaurus_tpu.models import tpch
    orders = tpch.generate_orders(64)
    shards = [tpch.generate_lineitem(192, n_orders=64, seed=100 + s)
              for s in range(WORLD)]
    return shards, _runs(_tpch_schemas(), tpch.Q3, foreign={ORDERS: orders})


def _case_dryrun_partitioned():
    r = _ref()
    rng = np.random.default_rng(5)
    b_schema = r.TableSchema.make([("bk", "int64"), ("bv", "int64")])
    fact_b = r.ColumnarChunk.from_arrays(b_schema, {
        "bk": rng.integers(0, 24, 300), "bv": rng.integers(0, 100, 300)})
    a_schema = r.TableSchema.make([("ak", "int64"), ("av", "double")])
    shards = [r.ColumnarChunk.from_arrays(a_schema, {
        "ak": rng.integers(0, 40, 96), "av": rng.uniform(0, 10, 96)})
        for _ in range(WORLD)]
    return shards, _runs({"//a": a_schema, "//b": b_schema},
                         "ak, sum(av) AS s, count(*) AS c FROM [//a] JOIN "
                         "[//b] ON ak = bk GROUP BY ak",
                         foreign={"//b": fact_b})


CASES = {
    "group_by": _case_group_by,
    "filter_scan": _case_filter_scan,
    "top_k": _case_top_k,
    "string_group_keys": _case_string_group_keys,
    "shuffled_group_by": _case_shuffled_group_by,
    "shuffled_having_strings": _case_shuffled_having_strings,
    "join_q3_shape": _case_join_q3_shape,
    "left_join": _case_left_join,
    "join_duplicate_keys": _case_join_duplicate_keys,
    "fact_to_fact": _case_fact_to_fact,
    "left_join_dup_nulls": _case_left_join_dup_nulls,
    "string_key_join": _case_string_key_join,
    "dryrun_q1": _case_dryrun_q1,
    "dryrun_q3": _case_dryrun_q3,
    "dryrun_partitioned": _case_dryrun_partitioned,
}
_CASE_MAKERS.update(CASES)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results on each of the 8 ranks, by case name."""
    jobs = [_job(name) for name in CASES]
    jobs.append(_dryrun_sort_job())
    return _spawn_ranks(jobs, str(tmp_path_factory.mktemp("mesh8")))


def _agreed(ranks: list, name: str) -> dict:
    """The case's result, once all ranks are seen to agree on it."""
    first = ranks[0][name]
    assert "error" not in first, first["error"]
    for rank, result in enumerate(ranks[1:], 1):
        assert result[name] == first, f"rank {rank} disagrees with rank 0"
    return first


def _canon_rows(rows: list) -> list:
    from tests.harness import _canon_row
    return [_canon_row(r) for r in rows]


def _oracle(name: str, run_index: int) -> list:
    """The JAX package's local evaluator over the concatenated shards."""
    r = _ref()
    shards, runs = _case(name)
    query, schemas, foreign, _ = runs[run_index]
    source = next(p for p in schemas if p not in foreign)
    tables = {source: r.concat_chunks(shards), **foreign}
    return r.select_rows(query, tables).to_rows()


def _check(ranks: list, name: str, ordered: bool) -> list:
    """Every run of the case against its oracle; the runs' results."""
    from tests.test_torch_query import _assert_rows
    runs = _agreed(ranks, name)["runs"]
    for i, run in enumerate(runs):
        _assert_rows(run["rows"], _oracle(name, i), ordered)
    return runs


# --- tests/test_distributed.py ------------------------------------------------


def test_spmd_group_by_matches_host(ranks):
    (run,) = _check(ranks, "group_by", ordered=False)
    chunks, _ = _case("group_by")
    want = {}
    for c in chunks:
        for r in c.to_rows():
            e = want.setdefault(r["g"], [0.0, 0])
            e[0] += r["v"]
            e[1] += 1
    assert len(run["rows"]) == len(want)
    for r in run["rows"]:
        s, c = want[r["g"]]
        assert abs(r["s"] - s) < 1e-6 and r["c"] == c
        assert abs(r["a"] - s / c) < 1e-9


def test_spmd_filter_scan(ranks):
    _check(ranks, "filter_scan", ordered=False)


def test_spmd_top_k(ranks):
    (run,) = _check(ranks, "top_k", ordered=True)
    assert len(run["rows"]) == 5


def test_spmd_string_group_keys(ranks):
    (run,) = _check(ranks, "string_group_keys", ordered=False)
    assert sorted((r["s"], r["c"]) for r in run["rows"]) == \
        [(b"ant", 20), (b"bee", 20), (b"cat", 20), (b"dog", 20)]


def test_spmd_shuffled_group_by_matches_gather(ranks):
    shuffled, gathered = _check(ranks, "shuffled_group_by", ordered=True)
    assert [r["g"] for r in shuffled["rows"]] == \
        [r["g"] for r in gathered["rows"]]
    assert [r["c"] for r in shuffled["rows"]] == \
        [r["c"] for r in gathered["rows"]]


def test_spmd_shuffled_having_and_strings(ranks):
    shuffled, gathered = _check(ranks, "shuffled_having_strings",
                                ordered=True)
    assert shuffled["rows"] == gathered["rows"] and shuffled["rows"]


def test_spmd_join_group_matches_host_q3_shape(ranks):
    _check(ranks, "join_q3_shape", ordered=False)


def test_spmd_left_join(ranks):
    _check(ranks, "left_join", ordered=False)


def test_spmd_join_duplicate_foreign_keys_partitioned(ranks):
    (run,) = _check(ranks, "join_duplicate_keys", ordered=False)
    assert len(run["rows"]) == 8 * (2 + 1)


def test_spmd_fact_to_fact_join_matches_host(ranks):
    _check(ranks, "fact_to_fact", ordered=False)


def test_spmd_left_join_duplicates_and_nulls(ranks):
    _check(ranks, "left_join_dup_nulls", ordered=False)


def test_spmd_string_key_join(ranks):
    for run in _check(ranks, "string_key_join", ordered=False):
        assert run["rows"]


# --- __graft_entry__.dryrun_multichip -----------------------------------------


def test_dryrun_q1(ranks):
    from ytsaurus_tpu.models import tpch
    (run,) = _check(ranks, "dryrun_q1", ordered=False)
    shards, _ = _case("dryrun_q1")
    assert 1 <= len(run["rows"]) <= 6
    want = sum(c for s in shards
               for (_, c) in tpch.q1_reference_numpy(s).values())
    assert sum(r["count_order"] for r in run["rows"]) == want


def test_dryrun_q3_broadcast_join(ranks):
    (run,) = _check(ranks, "dryrun_q3", ordered=True)
    assert len(run["rows"]) <= 10


def test_dryrun_partitioned_join(ranks):
    _check(ranks, "dryrun_partitioned", ordered=False)


def _dryrun_sort_job() -> dict:
    shards, _ = _case("dryrun_q1")
    return {"name": "dryrun_sort", "kind": "sort", "keys": ["l_orderkey"],
            "shards": [_numpy_chunk(c) for c in shards]}


def test_dryrun_sort(ranks):
    """Step 4: the lineitem shards sorted by l_orderkey across the ranks,
    every row kept, in the order of a stable sort of the concatenation."""
    result = _agreed_sort(ranks, "dryrun_sort")
    shards, _ = _case("dryrun_q1")
    rows = [r for c in shards for r in c.to_rows()]
    assert _canon_rows(result) == _canon_rows(
        sorted(rows, key=lambda r: r["l_orderkey"]))


def _agreed_sort(ranks: list, name: str) -> list:
    """A sort case's rows, shard-major, once the ranks agree on the row
    counts and the key order, and each rank holds its count. On a mesh of
    one (a group per rank), every rank holds the whole result, the same."""
    first = ranks[0][name]
    assert "error" not in first, first["error"]
    if len(first["row_counts"]) == 1:
        for rank, results in enumerate(ranks[1:], 1):
            assert results[name] == first, f"rank {rank} disagrees"
        return first["rows"]
    rows = []
    for rank, results in enumerate(ranks):
        result = results[name]
        assert "error" not in result, result["error"]
        assert result["row_counts"] == first["row_counts"]
        assert result["keys"] == first["keys"]
        assert len(result["rows"]) == first["row_counts"][rank]
        rows.extend(result["rows"])
    return rows


# --- host reads --------------------------------------------------------------


def test_gather_merge_costs_one_host_read(ranks):
    """The gather merge reads the device once per query (the result's row
    count), as the reference counts it."""
    for name in ("group_by", "filter_scan", "top_k", "dryrun_q1"):
        assert [run["syncs"] for run in _agreed(ranks, name)["runs"]] == [1]


def test_shuffled_group_by_costs_two_host_reads(ranks):
    """A shuffled GROUP BY reads the transfer matrix and the result's row
    count (the reference: its count pass and the result); its gather twin
    one."""
    assert [run["syncs"] for run in
            _agreed(ranks, "shuffled_group_by")["runs"]] == [2, 1]


def test_join_host_reads(ranks):
    """A broadcast join adds its foreign keys' uniqueness check (read once
    per foreign chunk; the reference reads it too but does not count it):
    Q3's shape costs two. A partitioned join costs two reads per join (its
    transfer matrices, then its output totals), as the reference's; the
    fact-to-fact join reads the uniqueness check first (then gathers: 1 +
    2 + 1), and under shuffle=True goes straight to the exchange and
    finishes shuffled (2 + 2)."""
    assert [run["syncs"] for run in
            _agreed(ranks, "join_q3_shape")["runs"]] == [2]
    assert [run["syncs"] for run in
            _agreed(ranks, "fact_to_fact")["runs"]] == [4, 4]


# --- the port's own checks ----------------------------------------------------


def test_mesh_of_two_runs_with_jax_blocked(tmp_path):
    """Two fresh ranks (jax and the JAX package blocked) import the mesh
    modules and the coordinator and run a Q18 aggregation over the port's
    own TPC-H generator, once through the stitched shuffle and once
    through `coordinate_distributed` (served by the whole-plan rung with
    one host read), each rank with the same rows as the port's local
    evaluator over the concatenation."""
    from ytsaurus_tpu_torch.chunks.columnar import concat_chunks
    from ytsaurus_tpu_torch.models import tpch
    from ytsaurus_tpu_torch.query import select_rows
    arrays = [tpch.lineitem_arrays(1500 + 77 * s, seed=s, n_orders=128)
              for s in range(2)]
    chunks = [tpch.lineitem_chunk(a, device="cpu") for a in arrays]
    job = {"name": "q18", "kind": "query",
           "shards": [_port_numpy(c) for c in chunks],
           "runs": [{"query": tpch.Q18_AGG, "kwargs": {"shuffle": True},
                     "schemas": {LINEITEM: _spec(chunks[0].schema)},
                     "foreign": {}},
                    {"query": tpch.Q18_AGG, "kwargs": {}, "ladder": True,
                     "schemas": {LINEITEM: _spec(chunks[0].schema)},
                     "foreign": {}}]}
    results = _spawn_ranks([job], str(tmp_path), world=2)
    want = select_rows(tpch.Q18_AGG, {LINEITEM: concat_chunks(chunks)},
                       device="cpu").to_rows()
    for result in results:
        assert "error" not in result["q18"], result["q18"]
        stitched, ladder = result["q18"]["runs"]
        assert stitched["rows"] == want
        assert ladder["rows"] == want
        assert ladder["whole_plan"] == 1 and ladder["syncs"] == 1


def _port_numpy(chunk) -> dict:
    d = chunk.to_numpy()
    return {"spec": d["schema_spec"], "row_count": d["row_count"],
            "planes": d["planes"], "vocabs": d["dictionaries"],
            "sorted_by": d["sorted_by"]}


def test_prepare_over_a_rep_chunk_takes_the_general_path():
    """A rep chunk carries no planes: GROUP BY an int64 column binds the
    general path (output capacity = input capacity), as the reference's
    `prepare` does, instead of reading a min/max it does not have."""
    from ytsaurus_tpu.parallel.distributed import _RepChunk as RefRepChunk
    from ytsaurus_tpu.parallel.distributed import _RepColumn as RefRepColumn
    from ytsaurus_tpu.query.builder import build_query as ref_build
    from ytsaurus_tpu.query.engine.lowering import prepare as ref_prepare
    from ytsaurus_tpu_torch.parallel.distributed import _RepChunk, _RepColumn
    from ytsaurus_tpu_torch.query.builder import build_query
    from ytsaurus_tpu_torch.query.engine.lowering import prepare
    from ytsaurus_tpu_torch.schema import EValueType, TableSchema

    r = _ref()
    query = f"g, count(*) AS c FROM [{T}] GROUP BY g"
    cap = 1024
    ref_prepared = ref_prepare(
        ref_build(query, {T: r.TableSchema.make(DIST_SPEC)}),
        RefRepChunk(capacity=cap, columns={
            c.name: RefRepColumn(type=c.type, dictionary=None)
            for c in r.TableSchema.make(DIST_SPEC)}))
    assert ref_prepared.out_capacity == cap
    schema = TableSchema.make(DIST_SPEC)
    prepared = prepare(build_query(query, {T: schema}), _RepChunk(
        capacity=cap, columns={c.name: _RepColumn(type=c.type,
                                                  dictionary=None)
                               for c in schema},
        device=torch.device("cpu")))
    g = torch.arange(cap) % 3
    planes, count = prepared.run(
        {"g": (g, torch.ones(cap, dtype=torch.bool))},
        torch.arange(cap) < 600)
    assert planes[0][0].shape[0] == cap and int(count) == 3
    assert prepared.output[0].type is EValueType.int64


def test_make_mesh_refuses_what_it_cannot_run():
    from ytsaurus_tpu_torch.errors import YtError
    from ytsaurus_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(YtError, match="needs a CUDA device"):
        make_mesh("cpu", backend="nccl")
    with pytest.raises(YtError, match="needs an init_method"):
        make_mesh("cpu", world_size=2, rank=0)
    with pytest.raises(YtError, match="Unsupported mesh backend"):
        make_mesh("cpu", backend="mpi")
    if not torch.cuda.is_available():
        with pytest.raises(YtError, match="no CUDA device"):
            make_mesh()
