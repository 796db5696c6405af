"""The port's reduce and map-reduce against the JAX package's: the slicing
and grouping functions of operations/reduce_op.py on the same seeded numpy
inputs, the device change points against the host scan, the partition
sort of a map-reduce (both branches), and the reduce and map-reduce
controllers driven alike through both clients. The port runs with
device="cpu".

Twins, run on the port through `port_twin`: every case of
tests/test_reduce.py (19) and of tests/test_revival.py (8).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_client import (
    _both,
    _rows_equal,
    call_twin,
    port_twin,
    twin_cases,
)
from ytsaurus_tpu.chunks.columnar import ColumnarChunk as RefChunk
from ytsaurus_tpu.operations import reduce_op as ref_reduce
from ytsaurus_tpu.operations import scheduler as ref_scheduler
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.operations import reduce_op
from ytsaurus_tpu_torch.operations import scheduler as port_scheduler
from ytsaurus_tpu_torch.schema import TableSchema

torch.set_num_threads(1)

# --- the reference's tests, on the port -------------------------------------

_REDUCE_TWIN = port_twin("test_reduce")
_REDUCE_CASES = twin_cases(_REDUCE_TWIN)
_REVIVAL_TWIN = port_twin("test_revival")
_REVIVAL_CASES = twin_cases(_REVIVAL_TWIN)


def test_twin_lists_are_whole():
    assert len(_REDUCE_CASES) == 19
    assert len(_REVIVAL_CASES) == 8


@pytest.mark.parametrize("name", _REDUCE_CASES)
def test_reference_reduce_case_on_the_port(name, tmp_path):
    call_twin(_REDUCE_TWIN, name, {
        "client": lambda: _REDUCE_TWIN.connect(str(tmp_path)),
        "tmp_path": tmp_path})


@pytest.mark.parametrize("name", _REVIVAL_CASES)
def test_reference_revival_case_on_the_port(name, tmp_path):
    call_twin(_REVIVAL_TWIN, name, {"tmp_path": tmp_path})


def test_waiters_wake_after_the_observer():
    """A job's waiters wake only once its on_done observer has run: the
    revival snapshot's record is in place before a controller can publish
    and clear it (a late record used to bring the snapshot back). 64 jobs
    on 16 slots, each observer slow, under a short switch interval."""
    import sys
    import time

    from ytsaurus_tpu_torch.operations.jobs import Job, JobManager
    recorded = set()

    def observe(job):
        time.sleep(0.005)
        recorded.add(job.index)

    manager = JobManager(slots=16)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        jobs = [Job(op_id="op", index=i, run=lambda job: [job.index],
                    on_done=observe) for i in range(64)]
        manager.submit(jobs)
        for job in jobs:
            manager.wait([job], timeout=60)
            assert job.index in recorded, job.index
    finally:
        sys.setswitchinterval(interval)
    assert [job.state for job in jobs] == ["completed"] * 64
    assert all(job._settled and job._done.is_set() for job in jobs)


# --- reduce_op against the reference, on seeded inputs ----------------------

_SPEC = [("a", "int64"), ("b", "string"), ("x", "double"),
         ("u", "uint64"), ("t", "boolean")]


def _key_table(seed: int, n: int) -> dict:
    """Columns sorted by (a, b) with runs, nulls, -0.0 / 0.0 and NaN."""
    rng = np.random.default_rng(seed)
    a = np.sort(rng.integers(-3, 4, n))
    b = np.array([b"p", b"q", b"r"], dtype=object)[rng.integers(0, 3, n)]
    x = rng.choice([0.0, -0.0, 1.5, np.nan], n)
    u = rng.choice(np.array([0, 1, 2**63, 2**64 - 1], dtype=np.uint64), n)
    t = rng.integers(0, 2, n).astype(bool)
    valid = rng.random(n) > 0.15
    return {"a": a, "b": b, "x": x, "u": u, "t": t, "valid": valid}


def _chunks(d: dict):
    names = [n for n, _ in _SPEC]
    arrays = {n: d[n] for n in names}
    valids = {n: d["valid"] for n in ("b", "x", "t")}
    ref = RefChunk.from_arrays(RefSchema.make(_SPEC), arrays, valids=valids)
    port = ColumnarChunk.from_arrays(TableSchema.make(_SPEC), arrays,
                                     valids=valids, device="cpu")
    return ref, port


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("keys", [["a"], ["a", "b"], ["x"], ["u", "t"],
                                  ["b", "x", "t"]])
def test_change_points_and_ranges_match_the_reference(seed, keys):
    """decode_keys, key_change_points and key_aligned_ranges exactly the
    reference's; the device change points the same as the host scan."""
    ref_chunk, port_chunk = _chunks(_key_table(seed, 300))
    ref_keys = ref_reduce.decode_keys(ref_chunk, keys)
    port_keys = reduce_op.decode_keys(port_chunk, keys)
    assert repr(port_keys) == repr(ref_keys)
    points = reduce_op.key_change_points(port_keys)
    assert points == ref_reduce.key_change_points(ref_keys)
    assert reduce_op.chunk_key_change_points(port_chunk, keys) == points
    for rows_per_job in (1, 7, 64, 1000):
        want = ref_reduce.key_aligned_ranges(ref_keys, rows_per_job)
        assert reduce_op.key_aligned_ranges(port_keys, rows_per_job) == want
        assert reduce_op.ranges_from_change_points(
            points, len(port_keys), rows_per_job) == want


def test_change_points_of_tiny_and_unknown_keys():
    _, chunk = _chunks(_key_table(3, 1))
    assert reduce_op.chunk_key_change_points(chunk, ["a"]) == []
    with pytest.raises(Exception, match="No such reduce column"):
        reduce_op.chunk_key_change_points(chunk, ["nope"])


def _mixed_rows(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    pool = [None, True, False, 0, 1, -1, 2**40, 1.0, 0.5, -0.0,
            b"a", b"b", "a", "z", 7.0]
    return [{"k": pool[int(i)], "j": int(j)}
            for i, j in zip(rng.integers(0, len(pool), n),
                            rng.integers(0, 5, n))]


@pytest.mark.parametrize("seed", [0, 1])
def test_stable_key_hash_and_partitions_match_the_reference(seed):
    """The CRC32 partition hash bit for bit (a revived operation
    re-partitions in a new process), and the partitions it gives."""
    rows = _mixed_rows(seed, 400)
    for row in rows:
        key = (row["k"], row["j"])
        assert reduce_op.stable_key_hash(key) == \
            ref_reduce.stable_key_hash(key)
    for count in (1, 3, 8):
        assert reduce_op.partition_rows(rows, ["k", "j"], count) == \
            ref_reduce.partition_rows(rows, ["k", "j"], count)
    groups = [(k, len(g)) for k, g in reduce_op.iter_groups(rows, ["j"])]
    assert groups == [(k, len(g))
                      for k, g in ref_reduce.iter_groups(rows, ["j"])]


def _uniform_rows(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [{"k": int(k), "s": f"s{int(s)}".encode(), "v": float(v)}
            for k, s, v in zip(rng.integers(-5, 5, n),
                               rng.integers(0, 4, n), rng.normal(size=n))]


@pytest.mark.parametrize("rows_fn", [_uniform_rows, _mixed_rows],
                         ids=["device", "ragged"])
def test_partition_sort_matches_the_reference(rows_fn):
    """`_sort_rows_for_reduce`: schema-uniform rows through the device
    sort, ragged rows through the host fallback; both in the reference's
    order."""
    rows = rows_fn(5, 300)
    for sort_by in (["k"], ["k", "s"] if "s" in rows[0] else ["k", "j"]):
        want = ref_scheduler._sort_rows_for_reduce(rows, sort_by)
        got = port_scheduler._sort_rows_for_reduce(rows, sort_by, "cpu")
        assert repr(got) == repr(want)


def test_partition_sort_never_hides_a_device_failure(monkeypatch):
    """Only the columnar build may fall back: a failing sort raises."""
    from ytsaurus_tpu_torch.operations import sort_op

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(sort_op, "sort_chunk", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port_scheduler._sort_rows_for_reduce(_uniform_rows(1, 10), ["k"],
                                             "cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_stripe_matches_the_reference(seed):
    """`split_stripe` halves the same stripes into the same slices, and
    the halves materialize the same rows."""
    from ytsaurus_tpu.operations import chunk_pools as ref_pools
    from ytsaurus_tpu_torch.operations import chunk_pools as port_pools
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 40, 4).tolist()
    spec = [("x", "int64")]
    ref_chunks = [RefChunk.from_rows(RefSchema.make(spec),
                                     [{"x": i} for i in range(n)])
                  for n in sizes]
    port_chunks = [ColumnarChunk.from_rows(TableSchema.make(spec),
                                           [{"x": i} for i in range(n)],
                                           device="cpu") for n in sizes]

    def halves(pools, chunks):
        stripe = pools.Stripe()
        for chunk, n in zip(chunks, sizes):
            stripe.add(chunk, int(n > 3), n)
        size_of = {id(c): n for c, n in zip(chunks, sizes)}
        return [([(size_of[id(c)], a, b) for c, a, b in h.slices],
                 h.row_count, h.materialize().to_rows())
                for h in pools.split_stripe(stripe)]

    assert halves(port_pools, port_chunks) == halves(ref_pools, ref_chunks)


# --- the controllers through both clients -----------------------------------


def _ops_script(c, Schema, Error) -> dict:
    rng = np.random.default_rng(21)
    n = 600
    rows = [{"k": int(k), "g": int(g), "v": int(v)}
            for k, g, v in zip(rng.permutation(n), rng.integers(0, 37, n),
                               rng.integers(0, 1000, n))]
    c.write_table("//r/in", rows[:300])
    c.write_table("//r/in", rows[300:], append=True)
    c.run_sort("//r/in", "//r/sorted", sort_by=["g", "k"])

    def reducer(key, group):
        yield {"g": key["g"], "s": sum(r["v"] for r in group),
               "c": len(group), "first": group[0]["k"]}

    out = {}
    for job_count in (1, 5, 16):
        op = c.run_reduce(reducer, "//r/sorted", f"//r/red{job_count}",
                          reduce_by="g", job_count=job_count)
        out[f"reduce{job_count}"] = (op.state, op.result,
                                     c.read_table(f"//r/red{job_count}"))
    op = c.run_reduce("cat", "//r/sorted", "//r/cat", reduce_by="g",
                      sort_by=["g", "k"], format="json", rows_per_job=50)
    out["reduce_cmd"] = (op.state, op.result, c.read_table("//r/cat"))

    def mapper(rs):
        return [{"g": r["g"], "v2": r["v"] * 2} for r in rs]

    def sum_reducer(key, group):
        yield {"g": key["g"], "s": sum(r["v2"] for r in group)}

    op = c.run_map_reduce(mapper, sum_reducer, "//r/in", "//r/mr",
                          reduce_by="g", partition_count=8)
    out["map_reduce"] = (op.state, op.result,
                         sorted(c.read_table("//r/mr"), key=lambda r: r["g"]))
    op = c.run_map_reduce(None, sum_reducer, "//r/in", "//r/bad",
                          reduce_by="g", partition_count=3,
                          raise_on_failure=False)
    out["map_reduce_failed"] = (op.state, op.error["code"])
    return out


def test_reduce_and_map_reduce_match(tmp_path):
    ref, port = _both(_ops_script, tmp_path)
    for key in ref:
        if key == "map_reduce_failed":
            assert port[key] == ref[key]
            continue
        r_state, r_result, r_rows = ref[key]
        p_state, p_result, p_rows = port[key]
        assert (p_state, p_result) == (r_state, r_result), key
        _rows_equal(p_rows, r_rows)
