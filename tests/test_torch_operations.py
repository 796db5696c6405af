"""The port's operations plane against the JAX package's: chunk pools, fair
share and the job manager (the reference's tests/test_jobs.py run on the
port, every case, the user-command jobs included), and the sort, merge,
erase and map operations driven alike through both clients, compared by
rows, table attributes, operation results, states and error codes. The
port runs with device="cpu"."""

import numpy as np
import pytest
import torch

from tests.test_torch_client import (
    _attrs,
    _both,
    _code,
    _rows_equal,
    call_twin,
    port_twin,
    twin_cases,
)
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.operations.jobs import Job, JobManager

torch.set_num_threads(1)

_TWIN = port_twin("test_jobs")
_CASES = twin_cases(_TWIN)


@pytest.mark.parametrize("name", _CASES)
def test_reference_jobs_case_on_the_port(name, tmp_path):
    call_twin(_TWIN, name, {
        "client": lambda: _TWIN.YtClient(_TWIN.YtCluster(
            str(tmp_path / "cluster"))),
        "tmp_path": tmp_path})


def test_job_retries_inside_its_failure_budget():
    manager = JobManager(slots=2)
    attempts = {"n": 0}

    def flaky(job):
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise YtError("transient", code=EErrorCode.OperationFailed)
        return "ok"

    [job] = [Job(op_id="op", index=0, run=flaky, max_failures=2)]
    assert manager.run_all([job]) == ["ok"]
    assert job.failures == 1 and job.state == "completed"


def test_jobs_run_on_slots_under_fair_share_pools():
    manager = JobManager(slots=2)
    jobs = [Job(op_id=f"op{p}", index=i, pool=p, run=lambda j, i=i: i)
            for p in ("a", "b") for i in range(6)]
    assert manager.run_all(jobs) == [i for _ in range(2) for i in range(6)]
    assert {j.state for j in jobs} == {"completed"}


def _table(n, seed):
    rng = np.random.default_rng(seed)
    return [{"k": int(k), "g": int(g), "x": float(x),
             "s": f"w{int(w)}", "n": None if i % 13 == 0 else int(i)}
            for i, (k, g, x, w) in enumerate(zip(
                rng.integers(-50, 50, n), rng.integers(0, 4, n),
                rng.normal(size=n), rng.integers(0, 9, n)))]


def _sort_script(c, Schema, Error) -> dict:
    out = {}
    rows = _table(500, seed=21)
    for i in range(0, 500, 125):
        c.write_table("//s/in", rows[i:i + 125], append=i > 0)
    for name, kwargs in (
            ("k", dict(sort_by="k")),
            ("g_s_x", dict(sort_by=["g", "s", "x"])),
            ("s_desc", dict(sort_by=["s"], descending=True)),
            ("n_nulls", dict(sort_by=["n", "k"]))):
        op = c.run_sort("//s/in", f"//s/{name}", **kwargs)
        out[name] = (op.state, op.result, c.read_table(f"//s/{name}"),
                     _attrs(c, f"//s/{name}"))
    # A numeric table over a budget below twice its weight: the
    # external sort, one output chunk per range.
    for i in range(0, 500, 250):
        c.write_table("//s/num", [{"k": r["k"], "x": r["x"], "n": r["n"]}
                                  for r in rows[i:i + 250]], append=i > 0)
    op = c.run_sort("//s/num", "//s/external", sort_by=["k", "x"],
                    hbm_budget=4096)
    out["external"] = (op.state, op.result, c.read_table("//s/external"),
                       _attrs(c, "//s/external"))
    c.write_table("//s/empty", [], schema=Schema.make([("k", "int64")]))
    op = c.run_sort("//s/empty", "//s/empty_sorted", sort_by="k")
    out["empty"] = (op.state, op.result, c.read_table("//s/empty_sorted"),
                    _attrs(c, "//s/empty_sorted"))
    out["bad_key"] = _code(
        lambda: c.run_sort("//s/in", "//s/bad", sort_by="nope"), Error)
    op = c.run_sort("//s/in", "//s/bad2", sort_by="nope",
                    raise_on_failure=False)
    out["bad_key_op"] = (op.state, op.error["code"],
                         c.get(f"//sys/operations/{op.id}/@state"))
    return out


def test_sorts_match(tmp_path):
    ref, port = _both(_sort_script, tmp_path)
    for key in ("k", "g_s_x", "s_desc", "n_nulls", "external", "empty"):
        r_state, r_result, r_rows, r_attrs = ref[key]
        p_state, p_result, p_rows, p_attrs = port[key]
        assert (p_state, p_result, p_attrs) == \
            (r_state, r_result, r_attrs), key
        _rows_equal(p_rows, r_rows)
    assert port["external"][1]["spill_ranges"] >= 1
    assert port["bad_key"] == ref["bad_key"]
    assert port["bad_key_op"] == ref["bad_key_op"]


def _merge_map_erase_script(c, Schema, Error) -> dict:
    out = {}
    rows = _table(300, seed=22)
    c.write_table("//m/a", rows[:100])
    c.write_table("//m/b", rows[100:250])
    c.write_table("//m/c", rows[250:])
    for name in ("a", "b", "c"):
        c.run_sort(f"//m/{name}", f"//m/{name}s", sort_by=["k", "x"])
    op = c.run_merge(["//m/as", "//m/bs", "//m/cs"], "//m/sorted",
                     mode="sorted", merge_by=["k", "x"])
    out["sorted"] = (op.state, op.result, c.read_table("//m/sorted"),
                     _attrs(c, "//m/sorted"))
    op = c.run_merge(["//m/a", "//m/b", "//m/c"], "//m/unordered")
    out["unordered"] = (op.state, op.result, c.read_table("//m/unordered"),
                        _attrs(c, "//m/unordered"))
    c.write_table("//m/other", [{"z": 1}])
    out["mismatch"] = _code(lambda: c.run_merge(["//m/a", "//m/other"],
                                                "//m/x"), Error)
    op = c.run_map(lambda rs: [{"k": r["k"], "s": r["s"], "y": r["x"] * 2}
                               for r in rs if r["g"] < 2],
                   "//m/unordered", "//m/mapped", job_count=4)
    out["map"] = (op.state, op.result,
                  sorted(c.read_table("//m/mapped"),
                         key=lambda r: (r["k"], r["y"])))
    op = c.run_map(lambda rs: [], "//m/a", "//m/nothing")
    out["map_empty"] = (op.state, op.result, c.read_table("//m/nothing"))
    op = c.run_erase("//m/sorted")
    out["erase"] = (op.state, op.result, c.read_table("//m/sorted"),
                    _attrs(c, "//m/sorted"))
    out["records"] = sorted(
        (c.get(f"//sys/operations/{i}/@operation_type"),
         c.get(f"//sys/operations/{i}/@state"))
        for i in c.list("//sys/operations"))
    return out


def test_merge_map_and_erase_match(tmp_path):
    ref, port = _both(_merge_map_erase_script, tmp_path)
    for key in ("sorted", "unordered", "erase"):
        r_state, r_result, r_rows, r_attrs = ref[key]
        p_state, p_result, p_rows, p_attrs = port[key]
        assert (p_state, p_result, p_attrs) == \
            (r_state, r_result, r_attrs), key
        _rows_equal(p_rows, r_rows)
    assert port["map"][:2] == ref["map"][:2]
    _rows_equal(port["map"][2], ref["map"][2])
    for key in ("mismatch", "map_empty", "records"):
        assert port[key] == ref[key], key


def test_async_operation_abort_is_terminal(tmp_path):
    import threading
    from ytsaurus_tpu_torch.client import connect
    client = connect(str(tmp_path), device="cpu")
    client.write_table("//in", [{"k": i} for i in range(100)])
    release = threading.Event()

    def slow(rows):
        release.wait(10)
        return rows

    op = client.scheduler.start_operation("map", {
        "mapper": slow, "input_table_path": "//in",
        "output_table_path": "//out", "raise_on_failure": False},
        sync=False)
    client.abort_operation(op.id)
    release.set()
    for _ in range(200):
        if client.get(f"//sys/operations/{op.id}/@state") == "aborted":
            break
        release.wait(0.01)
    assert op.state == "aborted"
    assert op.error["code"] == int(EErrorCode.Canceled)
