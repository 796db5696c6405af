"""The port's client against the JAX package's: `connect` → Cypress, static
and dynamic tables, queues, select / lookup, computed columns and the
operations, on fresh temp dirs with the same script and the same seeded
numpy data. The port runs with device="cpu".

Two kinds of case:

- the reference's own client tests (tests/test_client.py), run against
  the port through `port_twin`: their source with `ytsaurus_tpu` pointed
  at `ytsaurus_tpu_torch` and `connect` / `YtCluster` on the CPU. Left
  out: the statistics test, whose compile counters the port twins below;
- parity scripts that drive both clients alike and compare rows exactly
  (doubles by tests/harness.py's canon), the Cypress state with ids
  masked, `@row_count`, `@sorted_by`, `@chunk_stats`, operation results
  and states, and error codes.
"""

import functools
import inspect
import logging
import os
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_query import _assert_rows
from ytsaurus_tpu import client as ref_client
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch import chunks as port_chunks
from ytsaurus_tpu_torch import client as port_client
from ytsaurus_tpu_torch import environment as port_environment
from ytsaurus_tpu_torch import remote_client as port_remote
from ytsaurus_tpu_torch.chunks import columnar as port_columnar
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.query.engine import evaluator as port_evaluator
from ytsaurus_tpu_torch.tablet import tablet as port_tablet
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.schema import TableSchema

torch.set_num_threads(1)

_HERE = Path(__file__).parent
_ID = re.compile(r"^[0-9a-f]{32}(-\d+)?$")


class _CpuCluster(port_client.YtCluster):
    def __init__(self, root_dir, chunk_store=None, master=None,
                 device="cpu"):
        super().__init__(root_dir, chunk_store, master, device=device)


class _CpuLocalCluster(port_environment.LocalCluster):
    """LocalCluster whose primary and scheduler daemons run on the CPU,
    each daemon with one intra-op thread (they run beside the test
    workers)."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)

    def _spawn(self, name, root, args):
        old = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            super()._spawn(name, root, args)
        finally:
            if old is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = old


class _CpuRemoteClient(port_remote.RemoteYtClient):
    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


class _CpuChunk(ColumnarChunk):
    """ColumnarChunk whose builders default to the CPU."""

    from_rows = staticmethod(functools.partial(ColumnarChunk.from_rows,
                                               device="cpu"))
    from_arrays = staticmethod(functools.partial(ColumnarChunk.from_arrays,
                                                 device="cpu"))


def _cpu_module(name: str, source, **overrides) -> str:
    """A copy of a port module whose device defaults are the CPU,
    registered under `name` for the twins' imports."""
    module = types.ModuleType(name)
    module.__dict__.update({k: v for k, v in vars(source).items()
                            if not k.startswith("__")})
    module.__dict__.update(overrides)
    sys.modules[name] = module
    return name


_SHIMS = {
    "ytsaurus_tpu.client": _cpu_module(
        "_port_cpu_client", port_client, YtCluster=_CpuCluster,
        connect=functools.partial(port_client.connect, device="cpu")),
    "ytsaurus_tpu.chunks": _cpu_module(
        "_port_cpu_chunks", port_chunks, ColumnarChunk=_CpuChunk),
    "ytsaurus_tpu.chunks.columnar": _cpu_module(
        "_port_cpu_columnar", port_columnar, ColumnarChunk=_CpuChunk),
    "ytsaurus_tpu.tablet.tablet": _cpu_module(
        "_port_cpu_tablet", port_tablet,
        Tablet=functools.partial(port_tablet.Tablet, device="cpu")),
    "ytsaurus_tpu.environment": _cpu_module(
        "_port_cpu_environment", port_environment,
        LocalCluster=_CpuLocalCluster),
    "ytsaurus_tpu.remote_client": _cpu_module(
        "_port_cpu_remote_client", port_remote,
        RemoteYtClient=_CpuRemoteClient,
        connect_remote=functools.partial(port_remote.connect_remote,
                                         device="cpu"),
        routed_client=functools.partial(port_remote.routed_client,
                                        device="cpu")),
    "ytsaurus_tpu.query.engine.evaluator": _cpu_module(
        "_port_cpu_evaluator", port_evaluator,
        Evaluator=functools.partial(port_evaluator.Evaluator,
                                    device="cpu")),
}


def port_twin(name: str, edits=None, **extra) -> types.ModuleType:
    """The reference test module `tests/<name>.py` with every
    `ytsaurus_tpu` import pointed at the port, its `connect`,
    `YtCluster` and chunk builders on the CPU. `edits` maps source text
    to its replacement (an import of what the port leaves out); `extra`
    replaces module globals."""
    path = _HERE / f"{name}.py"
    source = path.read_text()
    for old, new in (edits or {}).items():
        assert old in source, old
        source = source.replace(old, new)
    for ref_name, shim in _SHIMS.items():
        source = re.sub(rf"\b{re.escape(ref_name)}\b(?!\.)", shim, source)
    source = re.sub(r"\bytsaurus_tpu\b", "ytsaurus_tpu_torch", source)
    module = types.ModuleType(f"port_twin_{name}")
    module.__file__ = str(path)
    exec(compile(source, str(path), "exec"), module.__dict__)
    for key, value in extra.items():
        setattr(module, key, value)
    return module


def twin_cases(module, exclude=()) -> list:
    return sorted(n for n, f in vars(module).items()
                  if n.startswith("test_") and inspect.isfunction(f)
                  and n not in exclude)


def call_twin(module, name: str, fixtures: dict):
    """Run one twin test with the fixtures its signature names."""
    fn = getattr(module, name)
    kwargs = {}
    for param in inspect.signature(fn).parameters:
        value = fixtures[param]
        kwargs[param] = value() if callable(value) and \
            param in ("client",) else value
    return fn(**kwargs)


# --- the reference's client tests, on the port ------------------------------

_CLIENT_TWIN = port_twin("test_client")
_CLIENT_CASES = twin_cases(_CLIENT_TWIN, exclude={
    "test_query_statistics_and_logging"})


@pytest.mark.parametrize("name", _CLIENT_CASES)
def test_reference_client_case_on_the_port(name, tmp_path, capsys):
    call_twin(_CLIENT_TWIN, name, {
        "client": lambda: _CLIENT_TWIN.connect(str(tmp_path)),
        "tmp_path": tmp_path, "capsys": capsys})


def test_query_statistics_and_logging_on_the_port(tmp_path, capsys):
    """The reference's statistics test, with the port's compile fields:
    nothing is compiled, so there are no compile-cache counters;
    `compile_time` is the binding's seconds, and the stage split of the
    wall is filled."""
    client = port_client.connect(str(tmp_path), device="cpu")
    from ytsaurus_tpu_torch.utils.logging import get_logger
    logger = get_logger("Query")
    old_level = logger.level
    logger.setLevel(logging.INFO)
    try:
        for base in (0, 100):
            client.write_table("//t/stats",
                               [{"k": base + i} for i in range(50)],
                               append=base > 0)
        for _ in range(2):
            client.select_rows("count(*) AS c FROM [//t/stats] "
                               "WHERE k >= 100 GROUP BY 1 AS o")
            stats = client.last_query_statistics
            assert stats.shards_pruned == 1
            assert stats.rows_read == 50
            assert stats.rows_written == 1
            assert stats.execute_time > 0
            assert stats.compile_time > 0
            assert stats.parse_time > 0 and stats.dispatch_time > 0
            assert stats.device_wait > 0 and stats.to_rows_time > 0
            assert not hasattr(stats, "compile_count")
            assert not hasattr(stats, "cache_hits")
            assert stats.execution_tier == "eager"
        err = capsys.readouterr().err
        assert '"category": "ytsaurus_tpu_torch.Query"' in err
        assert '"message": "select_rows"' in err
        assert '"shards_pruned": 1' in err
    finally:
        logger.setLevel(old_level)


def test_the_driver_is_not_ported():
    """The port's driver is its own copy, not the reference's module: the
    same registry, invoking the port's client."""
    from ytsaurus_tpu import driver as ref_driver
    from ytsaurus_tpu_torch import driver
    assert driver.Driver is not ref_driver.Driver
    assert list(driver.COMMANDS) == list(ref_driver.COMMANDS)
    assert driver.COMMANDS["select_rows"].invoke.__module__ == \
        "ytsaurus_tpu_torch.driver"


# --- parity scripts ----------------------------------------------------------


def _mask(value):
    """Ids (node, chunk, transaction, operation: uuid4 hex, tablet ids
    `<node id>-<i>`) become "<id>"; maps keyed by ids list their entries
    sorted."""
    if isinstance(value, str) and _ID.match(value):
        return "<id>"
    if isinstance(value, dict):
        items = [(_mask(k), _mask(v)) for k, v in value.items()
                 if k != "id"]
        return sorted(items, key=repr)
    if isinstance(value, (list, tuple)):
        return [_mask(v) for v in value]
    return value


def _cypress(client) -> list:
    return _mask(client.cluster.master.tree.serialize())


def _attrs(client, path: str) -> dict:
    out = {}
    for name in ("row_count", "sorted_by", "chunk_stats", "schema",
                 "dynamic", "tablet_state"):
        if client.exists(f"{path}/@{name}"):
            out[name] = client.get(f"{path}/@{name}")
    return out


def _code(fn, error_type):
    try:
        fn()
    except error_type as err:
        return int(err.code)
    return None


def _connect(pkg, root):
    if pkg is port_client:
        return pkg.connect(str(root), device="cpu")
    return pkg.connect(str(root))


def _both(script, tmp_path) -> tuple:
    """(reference outcome, port outcome) of one script on fresh roots."""
    ref = script(_connect(ref_client, tmp_path / "ref"), RefSchema,
                 RefYtError)
    port = script(_connect(port_client, tmp_path / "port"), TableSchema,
                  YtError)
    return ref, port


def _rows_equal(got, want, ordered=True):
    assert len(got) == len(want)
    _assert_rows(got, want, ordered)


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return [{"k": int(k), "g": int(g), "v": float(v),
             "s": f"s{int(s)}"}
            for k, g, v, s in zip(rng.permutation(n), rng.integers(0, 7, n),
                                  rng.normal(size=n), rng.integers(0, 5, n))]


def _static_script(c, Schema, Error) -> dict:
    out = {}
    c.create("map_node", "//home/u", recursive=True)
    c.set("//home/u/@owner", "tester")
    c.create("document", "//home/u/doc")
    c.set("//home/u/doc", {"a": [1, 2], "b": {"c": "d"}})
    rows = _data(300, seed=5)
    c.write_table("//home/u/t", rows[:200])
    c.write_table("//home/u/t", rows[200:], append=True)
    out["read"] = c.read_table("//home/u/t")
    out["yson"] = c.read_table("//home/u/t", format="yson")
    out["json"] = c.read_table("//home/u/t", format="json")
    out["select"] = c.select_rows(
        "k, v, s FROM [//home/u/t] WHERE k >= 250 ORDER BY k LIMIT 20")
    out["pruned"] = c.last_query_statistics.shards_pruned
    out["group"] = c.select_rows(
        "g, sum(v) AS sv, count(*) AS c FROM [//home/u/t] GROUP BY g "
        "ORDER BY g LIMIT 10")
    out["params"] = c.select_rows(
        "k FROM [//home/u/t] WHERE k < ? AND s = ? ORDER BY k LIMIT 100",
        params=[40, "s3"])
    c.write_table("//home/u/dim", [{"g": g, "name": f"n{g}"}
                                   for g in range(7)])
    out["join"] = c.select_rows(
        "name, count(*) AS c FROM [//home/u/t] JOIN [//home/u/dim] "
        "USING g GROUP BY name ORDER BY name LIMIT 10")
    c.copy("//home/u/t", "//home/u/t_copy")
    c.move("//home/u/doc", "//home/u/doc2")
    c.link("//home/u/t", "//home/u/t_link")
    out["list"] = c.list("//home/u")
    out["link_read"] = len(c.read_table("//home/u/t_link"))
    out["attrs"] = {p: _attrs(c, p) for p in ("//home/u/t",
                                              "//home/u/t_copy")}
    out["errors"] = {
        "get_missing": _code(lambda: c.get("//nope"), Error),
        "create_twice": _code(lambda: c.create("map_node", "//home/u"),
                              Error),
        "remove_missing": _code(lambda: c.remove("//nope"), Error),
        "select_missing": _code(
            lambda: c.select_rows("k FROM [//nope]"), Error),
        "lookup_static": _code(
            lambda: c.lookup_rows("//home/u/t", [(1,)]), Error),
        "bad_query": _code(
            lambda: c.select_rows("k FROM [//home/u/t] WHERE"), Error),
    }
    c.remove("//home/u/t_copy")
    out["gc"] = c.collect_garbage()
    out["cypress"] = _cypress(c)
    return out


def test_static_tables_and_cypress_match(tmp_path):
    ref, port = _both(_static_script, tmp_path)
    for key in ("read", "select", "group", "params", "join"):
        _rows_equal(port[key], ref[key])
    for key in ("yson", "json", "pruned", "list", "link_read", "attrs",
                "errors", "gc", "cypress"):
        assert port[key] == ref[key], key


def _untimed(rows: list) -> list:
    assert all("$timestamp" in r for r in rows)
    return [{k: v for k, v in r.items() if k != "$timestamp"} for r in rows]


def _dynamic_script(c, Schema, Error) -> dict:
    out = {}
    schema = Schema.make([("k", "int64", "ascending"), ("v", "int64"),
                          ("s", "string")], unique_keys=True)
    c.create("table", "//dyn/t", recursive=True,
             attributes={"schema": schema, "dynamic": True,
                         "pivot_keys": [[40], [80]]})
    c.mount_table("//dyn/t")
    rng = np.random.default_rng(11)
    keys = rng.permutation(120)
    c.insert_rows("//dyn/t", [{"k": int(k), "v": int(k) * 3,
                               "s": f"x{int(k) % 4}"} for k in keys])
    tx = c.start_transaction()
    c.insert_rows("//dyn/t", [{"k": 5, "v": -1, "s": "tx"}], tx=tx)
    c.delete_rows("//dyn/t", [(6,), (7,)], tx=tx)
    c.commit_transaction(tx)
    tx = c.start_transaction()
    c.insert_rows("//dyn/t", [{"k": 8, "v": -2, "s": "aborted"}], tx=tx)
    c.abort_transaction(tx)
    c.insert_rows("//dyn/t", [{"k": 9, "v": 99}], update=True)
    out["lookup"] = c.lookup_rows("//dyn/t", [(5,), (6,), (8,), (9,),
                                              (500,)])
    out["lookup_cols"] = c.lookup_rows("//dyn/t", [(1,), (2,)],
                                       column_names=["v"])
    out["select"] = c.select_rows(
        "k, v, s FROM [//dyn/t] WHERE k < 20 ORDER BY k LIMIT 20")
    out["group"] = c.select_rows(
        "s, sum(v) AS sv, count(*) AS c FROM [//dyn/t] GROUP BY s "
        "ORDER BY s LIMIT 10")
    c.freeze_table("//dyn/t")
    c.compact_table("//dyn/t")
    c.unmount_table("//dyn/t")
    out["unmounted"] = _code(lambda: c.lookup_rows("//dyn/t", [(1,)]),
                             Error)
    c.reshard_table("//dyn/t", [(60,)])
    c.mount_table("//dyn/t")
    out["after_reshard"] = c.select_rows(
        "k, v FROM [//dyn/t] ORDER BY k LIMIT 200")
    out["attrs"] = _attrs(c, "//dyn/t")
    out["tablet_count"] = c.get("//dyn/t/@tablet_count")
    # Queues (ordered dynamic tables).
    qschema = Schema.make([("msg", "string"), ("n", "int64")])
    c.create("table", "//dyn/q", recursive=True,
             attributes={"schema": qschema, "dynamic": True})
    c.mount_table("//dyn/q")
    out["push"] = c.push_queue("//dyn/q", [{"msg": f"m{i}", "n": i}
                                           for i in range(10)])
    # $timestamp is the wall clock's: compared as present, not by value.
    out["pull"] = _untimed(c.pull_queue("//dyn/q", offset=3, limit=4))
    c.trim_rows("//dyn/q", 2)
    out["pull_trimmed"] = _untimed(c.pull_queue("//dyn/q"))
    out["queue_select"] = c.select_rows(
        "$row_index, msg, n FROM [//dyn/q] WHERE n >= 5")
    c.create("table", "//dyn/one", recursive=True,
             attributes={"schema": schema, "dynamic": True})
    c.mount_table("//dyn/one")
    out["errors"] = {
        "reshard_mounted": _code(
            lambda: c.reshard_table("//dyn/t", [(10,)]), Error),
        "push_sorted": _code(lambda: c.push_queue("//dyn/one", [{"k": 1}]),
                             Error),
        "write_table_dynamic": _code(
            lambda: c.write_table("//dyn/t", [{"k": 1}]), Error),
        "move_mounted": _code(lambda: c.move("//dyn/t", "//dyn/t2"),
                              Error),
    }
    for path in ("//dyn/t", "//dyn/q", "//dyn/one"):
        c.unmount_table(path)
    out["cypress"] = _cypress(c)
    return out


def test_dynamic_tables_and_queues_match(tmp_path):
    ref, port = _both(_dynamic_script, tmp_path)
    for key in ("select", "group", "after_reshard", "pull", "pull_trimmed",
                "queue_select"):
        _rows_equal(port[key], ref[key], ordered=key != "queue_select")
    for key in ("lookup", "lookup_cols", "unmounted", "attrs",
                "tablet_count", "push", "errors", "cypress"):
        assert port[key] == ref[key], key


def _computed_script(c, Schema, Error) -> dict:
    out = {}
    schema = Schema.make([
        {"name": "h", "type": "int64", "sort_order": "ascending",
         "expression": "k % 4"},
        {"name": "k", "type": "int64", "sort_order": "ascending"},
        {"name": "v", "type": "int64"},
        {"name": "w", "type": "int64", "expression": "v * 2 + 1"}])
    c.create("table", "//c/t", recursive=True,
             attributes={"schema": schema, "dynamic": True})
    c.mount_table("//c/t")
    c.insert_rows("//c/t", [{"k": i, "v": i * 10} for i in range(20)])
    out["lookup_natural"] = c.lookup_rows("//c/t", [(3,), (17,)])
    out["lookup_full"] = c.lookup_rows("//c/t", [(1, 5)])
    c.delete_rows("//c/t", [(4,)])
    out["select"] = c.select_rows("h, k, v, w FROM [//c/t] ORDER BY k "
                                  "LIMIT 100")
    out["errors"] = {
        "write_computed": _code(
            lambda: c.insert_rows("//c/t", [{"k": 1, "v": 1, "w": 3}]),
            Error),
        "bad_width": _code(lambda: c.lookup_rows("//c/t", [(1, 2, 3)]),
                           Error),
    }
    return out


def test_computed_columns_match(tmp_path):
    ref, port = _both(_computed_script, tmp_path)
    _rows_equal(port["select"], ref["select"])
    for key in ("lookup_natural", "lookup_full", "errors"):
        assert port[key] == ref[key], key


def _operations_script(c, Schema, Error) -> dict:
    out = {}
    rows = _data(400, seed=9)
    c.write_table("//ops/in", rows[:250])
    c.write_table("//ops/in", rows[250:], append=True)
    op = c.run_sort("//ops/in", "//ops/sorted", sort_by=["g", "k"])
    out["sort"] = (op.state, op.result, c.read_table("//ops/sorted"),
                   _attrs(c, "//ops/sorted"))
    op = c.run_sort("//ops/in", "//ops/desc", sort_by="k", descending=True)
    out["sort_desc"] = (op.state, op.result,
                        [r["k"] for r in c.read_table("//ops/desc")])
    c.write_table("//ops/a", [{"k": 1}, {"k": 3}])
    c.write_table("//ops/b", [{"k": 2}, {"k": 4}])
    op = c.run_merge(["//ops/a", "//ops/b"], "//ops/m", mode="sorted",
                     merge_by=["k"])
    out["merge_sorted"] = (op.state, op.result, c.read_table("//ops/m"),
                           _attrs(c, "//ops/m"))
    op = c.run_merge(["//ops/a", "//ops/b"], "//ops/u")
    out["merge"] = (op.state, op.result, c.read_table("//ops/u"),
                    _attrs(c, "//ops/u"))
    op = c.run_map(lambda rs: [{"k": r["k"], "v2": r["v"] * 2}
                               for r in rs if r["g"] != 3],
                   "//ops/in", "//ops/mapped", rows_per_job=64)
    out["map"] = (op.state, op.result,
                  sorted(c.read_table("//ops/mapped"), key=lambda r: r["k"]))
    op = c.run_erase("//ops/m")
    out["erase"] = (op.state, op.result, c.read_table("//ops/m"),
                    _attrs(c, "//ops/m"))

    def boom(rs):
        raise Error("mapper failed")

    op = c.run_map(boom, "//ops/in", "//ops/fail", raise_on_failure=False)
    out["failed"] = (op.state, op.error["code"])
    out["unported_or_error"] = _code(
        lambda: c.run_sort("//ops/missing", "//ops/x", sort_by="k"), Error)
    out["abort_done"] = c.abort_operation(op.id).state
    out["ops"] = sorted((o.type, o.state) for o in
                        c.scheduler.list_operations())
    out["cypress"] = _cypress(c)
    return out


def test_operations_match(tmp_path):
    ref, port = _both(_operations_script, tmp_path)
    for key in ("sort", "merge_sorted", "merge", "erase"):
        r_state, r_result, r_rows, r_attrs = ref[key]
        p_state, p_result, p_rows, p_attrs = port[key]
        assert (p_state, p_result, p_attrs) == (r_state, r_result, r_attrs)
        _rows_equal(p_rows, r_rows)
    assert port["sort_desc"] == ref["sort_desc"]
    assert port["map"][:2] == ref["map"][:2]
    _rows_equal(port["map"][2], ref["map"][2])
    for key in ("failed", "unported_or_error", "abort_done", "ops",
                "cypress"):
        assert port[key] == ref[key], key


def test_unported_methods_name_their_module(tmp_path):
    """No client method is left unported. Exec-node dispatch and remote
    copy came with the daemons: in local mode the client has no exec
    nodes (command jobs run in-process), and a remote copy from a
    cluster that does not answer fails its operation with the transport
    error, not a "not ported" one. Their cluster cases are in
    tests/test_torch_local_cluster.py and
    tests/test_torch_job_environment.py; portals, the query tracker and
    the replica, index, view, consumer, backup and operation methods
    have their parity cases in tests/test_torch_{cells,query_tracker,
    reduce,job_environment,replication,views,derived}.py."""
    client = port_client.connect(str(tmp_path), device="cpu")
    client.write_table("//t", [{"k": 1}])
    assert client.exec_node_addresses() == {}
    op = client.run_remote_copy("127.0.0.1:1", "//t", "//o",
                                raise_on_failure=False)
    assert op.state == "failed"
    assert "not ported" not in op.error["message"]
    assert "127.0.0.1:1" in str(op.error)
    assert {o.state for o in client.scheduler.list_operations()} == \
        {"failed"}


def test_write_then_read_keeps_planes_on_the_cluster_device(tmp_path):
    client = port_client.connect(str(tmp_path), device="cpu")
    assert client.cluster.device == torch.device("cpu")
    client.write_table("//t", [{"k": i, "v": float(i)} for i in range(10)])
    (cid,) = client.get("//t/@chunk_ids")
    chunk = client.cluster.chunk_cache.get(cid)
    assert chunk.device == torch.device("cpu")
    usage = client.get("//t/@resource_usage")
    assert usage == {"disk_space": chunk.nbytes, "chunk_count": 1}
    # Every attribute written into Cypress is a host value.
    for stats in client.get("//t/@chunk_stats"):
        for entry in stats.values():
            assert not isinstance(entry, torch.Tensor)
