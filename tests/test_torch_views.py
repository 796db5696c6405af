"""The port's materialized views, view daemon and queue consumers against
the JAX package's: one script of queue appends, views (GROUP BY with
sum / count / avg / argmin, DISTINCT, a plain filtered view), refreshes,
consumer pulls and advances, driven alike through both clients and
compared by the views' targets (doubles by tests/harness.py's canon),
`get_view`'s counters, offsets and the queue status. The port runs with
device="cpu".

Twins, run on the port through `port_twin`, and what each leaves out:

- tests/test_queue_agent.py (5): every case.
- tests/test_views.py (27 functions, 30 cases with the parametrized
  crash schedules): all but
  `test_view_dual_checked_against_mesh_oracle` (it takes the JAX
  package's 8-device CPU mesh fixture; the port's mesh is
  torch.distributed, held by tests/test_torch_distributed*.py),
  `test_steady_state_refresh_is_compile_free` (it reads the JAX compile
  observatory; the port compiles nothing, see
  `test_refresh_runs_on_the_evaluator_device` below),
  `test_view_daemon_tails_pauses_and_resumes` (it drives
  `config.DynamicConfigManager`, which waits for the YsonStruct layer;
  `test_daemon_pauses_by_config_and_resumes` below drives the same
  daemon through `apply_config`), `test_view_lag_slo_burn_rate_alert`
  (utils/slo.py is not ported) and
  `test_views_monitoring_endpoint_and_orchid` (the monitoring server is
  not ported).
"""

import time

import numpy as np
import pytest
import torch

from tests.harness import _canon_row
from tests.test_torch_client import _both, call_twin, port_twin, twin_cases
from ytsaurus_tpu_torch import config as port_config
from ytsaurus_tpu_torch.client import connect
from ytsaurus_tpu_torch.server.view_daemon import ViewDaemon, views_snapshot

torch.set_num_threads(1)

_QA_TWIN = port_twin("test_queue_agent")
_QA_CASES = twin_cases(_QA_TWIN)
_VIEWS_TWIN = port_twin("test_views")
_VIEWS_EXCLUDED = {
    "test_view_dual_checked_against_mesh_oracle",
    "test_steady_state_refresh_is_compile_free",
    "test_view_daemon_tails_pauses_and_resumes",
    "test_view_lag_slo_burn_rate_alert",
    "test_views_monitoring_endpoint_and_orchid"}
_VIEWS_FUNCS = twin_cases(_VIEWS_TWIN)


def _twin_params(module, name) -> list:
    """The keyword sets a twin's `pytest.mark.parametrize` marks give (one
    empty set for an unparametrized case), in the marks' product."""
    sets = [{}]
    for mark in getattr(getattr(module, name), "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in mark.args[0].split(",")]
        values = [v if len(names) > 1 else (v,) for v in mark.args[1]]
        sets = [{**s, **dict(zip(names, v))} for s in sets for v in values]
    return sets


_VIEWS_CASES = [
    (name, params) for name in twin_cases(_VIEWS_TWIN,
                                          exclude=_VIEWS_EXCLUDED)
    for params in _twin_params(_VIEWS_TWIN, name)]


def test_twin_lists_hold_every_runnable_case():
    assert len(_QA_CASES) == 5
    assert len(_VIEWS_FUNCS) == 27
    assert len(_VIEWS_CASES) == 27 - 5 + 3     # 2 x 2 crash schedules


@pytest.fixture(autouse=True)
def _fresh_views_config():
    yield
    port_config.set_views_config(None)


@pytest.mark.parametrize("name", _QA_CASES)
def test_reference_queue_agent_case_on_the_port(name, tmp_path):
    call_twin(_QA_TWIN, name, {
        "client": lambda: _QA_TWIN.connect(str(tmp_path))})


@pytest.mark.parametrize("name,params", _VIEWS_CASES,
                         ids=[n + "".join(f"-{v}" for v in p.values())
                              for n, p in _VIEWS_CASES])
def test_reference_views_case_on_the_port(name, params, tmp_path, capsys):
    from ytsaurus_tpu_torch.utils import failpoints
    failpoints.deactivate()
    try:
        call_twin(_VIEWS_TWIN, name, {
            "client": lambda: _VIEWS_TWIN.connect(str(tmp_path)),
            "capsys": capsys, **params})
    finally:
        failpoints.deactivate()


# --- one script through both clients ----------------------------------------


def _views_script(c, Schema, Error) -> dict:
    schema = Schema.make([("k", "int64"), ("g", "int64"), ("v", "double"),
                          ("w", "int64"), ("s", "string")])
    c.create("table", "//q", recursive=True,
             attributes={"schema": schema, "dynamic": True})
    c.mount_table("//q")
    specs = {
        "agg": ("g, sum(v) AS sv, count(*) AS c, avg(v) AS a, "
                "min(w) AS lo, max(s) AS hi FROM [//q] GROUP BY g", 50),
        "arg": ("g, argmin(s, w) AS first_s FROM [//q] GROUP BY g", 64),
        "distinct": ("s FROM [//q] GROUP BY s", 33),
        "plain": ("k, v FROM [//q] WHERE w > 500", 40),
    }
    for name, (query, batch) in specs.items():
        c.create_materialized_view(name, query, batch_rows=batch)
    c.register_queue_consumer("//q", "//consumer")
    rng = np.random.default_rng(3)
    out: dict = {"refresh": [], "pulls": []}
    k = 0
    for batch in range(4):
        n = int(rng.integers(60, 140))
        c.push_queue("//q", [
            {"k": k + i, "g": int(g), "v": float(v), "w": int(w),
             "s": f"s{int(t)}"}
            for i, (g, v, w, t) in enumerate(zip(
                rng.integers(0, 9, n), rng.normal(size=n).round(3),
                rng.integers(0, 1000, n), rng.integers(0, 12, n)))])
        k += n
        for name in specs:
            out["refresh"].append(c.refresh_view(name))
        rows, nxt = c.pull_consumer("//consumer", "//q", limit=45)
        out["pulls"].append(([r["k"] for r in rows], nxt))
        c.advance_consumer("//consumer", "//q", nxt)
    columns = {"agg": "g, sv, c, a, lo, hi", "arg": "g, first_s",
               "distinct": "s", "plain": "k, v"}
    for name in specs:
        view = c.get_view(name)
        out[name] = c.select_rows(f"{columns[name]} FROM [{view['target']}]")
        out[f"{name}_status"] = {key: view[key] for key in (
            "offset", "lag_rows", "source_row_count", "batch_rows",
            "state")}
        out[f"{name}_full"] = c.select_rows(specs[name][0])
    out["views"] = c.list_views()
    c.pause_view("agg")
    out["paused"] = c.get_view("agg")["state"]
    c.remove_view("distinct")
    out["views_after_remove"] = c.list_views()
    return out


def _rows(rows) -> list:
    return sorted((_canon_row(r) for r in rows), key=repr)


def test_views_and_consumers_match(tmp_path):
    ref, port = _both(_views_script, tmp_path)
    for key in ("refresh", "pulls", "views", "paused",
                "views_after_remove"):
        assert port[key] == ref[key], key
    for name in ("agg", "arg", "distinct", "plain"):
        assert port[f"{name}_status"] == ref[f"{name}_status"], name
        assert _rows(port[name]) == _rows(ref[name]), name
        # The view's target equals the full query over the queue.
        assert _rows(port[name]) == _rows(port[f"{name}_full"]), name


def test_refresh_runs_on_the_evaluator_device(tmp_path):
    """A refresh builds its batch and merge chunks on the evaluator's
    device; the port pads no batch (nothing is compiled)."""
    client = connect(str(tmp_path), device="cpu")
    client.create("table", "//q", recursive=True, attributes={
        "schema": [{"name": "g", "type": "int64"},
                   {"name": "v", "type": "int64"}], "dynamic": True})
    client.mount_table("//q")
    client.create_materialized_view(
        "m", "g, sum(v) AS s FROM [//q] GROUP BY g", batch_rows=7)
    seen = []
    evaluator = client.cluster.evaluator
    run_plan = evaluator.run_plan

    def spy(plan, chunk, *args, **kwargs):
        seen.append((chunk.device, chunk.row_count, chunk.capacity))
        return run_plan(plan, chunk, *args, **kwargs)

    evaluator.run_plan = spy
    client.push_queue("//q", [{"g": i % 3, "v": i} for i in range(20)])
    result = client.refresh_view("m")
    assert result["rows_in"] == 20 and result["batches"] == 3
    assert {d for d, _, _ in seen} == {torch.device("cpu")}
    assert [n for _, n, _ in seen][:2] == [7, 3]


def _wait(predicate, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def test_daemon_pauses_by_config_and_resumes(tmp_path):
    """The daemon tails a view, skips it while `ViewsConfig.paused` names
    it and everything while `enable` is off, and catches up after."""
    client = connect(str(tmp_path), device="cpu")
    client.create("table", "//q", recursive=True, attributes={
        "schema": [{"name": "g", "type": "int64"},
                   {"name": "v", "type": "int64"}], "dynamic": True})
    client.mount_table("//q")
    client.create_materialized_view(
        "d", "g, sum(v) AS s FROM [//q] GROUP BY g", batch_rows=8)
    client.push_queue("//q", [{"g": i % 2, "v": i} for i in range(10)])
    daemon = ViewDaemon(client, config=port_config.ViewsConfig(
        poll_interval=0.01)).start()
    try:
        assert _wait(lambda: client.get_view("d")["lag_rows"] == 0)
        for config in (port_config.ViewsConfig(paused=["d"],
                                               poll_interval=0.01),
                       port_config.ViewsConfig(enable=False,
                                               poll_interval=0.01)):
            daemon.apply_config(config)
            # Two whole passes under the new config: one in flight when
            # it landed may still run with the old one.
            start = daemon.passes
            assert _wait(lambda: daemon.passes >= start + 2)
            client.push_queue("//q", [{"g": 1, "v": 100}])
            start = daemon.passes
            assert _wait(lambda: daemon.passes >= start + 2)
            assert client.get_view("d")["lag_rows"] == 1
            daemon.apply_config(port_config.ViewsConfig(poll_interval=0.01))
            assert _wait(lambda: client.get_view("d")["lag_rows"] == 0)
        assert any("d" in snap["views"] for snap in views_snapshot())
    finally:
        daemon.stop()
    target = client.get_view("d")["target"]
    rows = client.select_rows(f"g, s FROM [{target}]")
    assert sorted((r["g"], r["s"]) for r in rows) == [(0, 20), (1, 225)]
    del daemon
