"""The port's `yt` command line (ytsaurus_tpu_torch/cli.py) against a port
`LocalCluster` on the CPU (`--device cpu`, as `YT_CLI_PLATFORM=cpu`):

- the reference's end-to-end case (tests/test_proxy_cli.py::
  test_cli_end_to_end) through `port_twin` (its jax pinning taken out);
- every subcommand of `build_parser` at least once over the wire:
  Cypress, tables, queries and traces, dynamic tables, the operations,
  transactions and locks, security, orchid (with the primary's profiler
  mounts), workload capture and replay from the primary's log, views,
  `yt analyze` over the port's tree, and the refusals of `prewarm` and
  `compile-cache top`;
- the device: `--device cuda` on a machine without a card exits 1 naming
  the device before it connects.
The parity of the reference's in-process CLI cases is in
tests/test_torch_{workload,views,profile}.py."""

import io
import json
import sys

import numpy as np
import pytest

from tests.test_torch_client import port_twin
from ytsaurus_tpu_torch import cli

_TWIN = port_twin("test_proxy_cli", edits={
    """import jax

jax.config.update("jax_platforms", "cpu")

""": ""})


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_cluster"))
    with _TWIN.LocalCluster(root, n_nodes=1, replication_factor=1,
                            http_proxy=True) as lc:
        yield lc


@pytest.fixture(autouse=True)
def _cpu_cli(monkeypatch):
    monkeypatch.setenv("YT_CLI_PLATFORM", "cpu")


def test_reference_cli_end_to_end_on_the_port(cluster):
    _TWIN.test_cli_end_to_end(cluster)


def _yt(cluster, *argv, stdin: bytes = b"", proxy=True):
    """(rc, stdout bytes, stderr text) of one in-process `yt` run."""
    old = sys.stdout, sys.stdin, sys.stderr
    sys.stdout = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
    sys.stdin = io.TextIOWrapper(io.BytesIO(stdin), encoding="utf-8")
    sys.stderr = io.StringIO()
    try:
        args = ["--proxy", cluster.primary_address] if proxy else []
        rc = cli.run([*args, *argv])
        sys.stdout.flush()
        out = sys.stdout.buffer.getvalue()
        err = sys.stderr.getvalue()
    finally:
        sys.stdout, sys.stdin, sys.stderr = old
    return rc, out, err


def _ok(cluster, *argv, stdin: bytes = b""):
    rc, out, err = _yt(cluster, *argv, stdin=stdin)
    assert rc == 0, (argv, err)
    return out


def _json(cluster, *argv, stdin: bytes = b""):
    return json.loads(_ok(cluster, *argv, stdin=stdin))


def test_cypress_verbs(cluster):
    _ok(cluster, "create", "map_node", "//c/a/b", "-r")
    _ok(cluster, "create", "document", "//c/doc",
        "--attributes", '{"owner": "me"}')
    _ok(cluster, "create", "map_node", "//c/a", "-i")
    _ok(cluster, "set", "//c/doc", '{"x": [1, 2]}')
    assert _json(cluster, "get", "//c/doc") == {"x": [1, 2]}
    assert _json(cluster, "get", "//c/doc/@owner") == "me"
    _ok(cluster, "copy", "//c/doc", "//c/doc2")
    _ok(cluster, "move", "//c/doc2", "//c/a/doc3")
    _ok(cluster, "link", "//c/a/doc3", "//c/ln")
    assert _json(cluster, "get", "//c/ln") == {"x": [1, 2]}
    assert sorted(_json(cluster, "list", "//c/a")) == ["b", "doc3"]
    _ok(cluster, "copy", "//c/a", "//c/a2", "-r")
    _ok(cluster, "move", "//c/a2", "//c/a3", "-r")
    _ok(cluster, "remove", "//c/a3/b")
    _ok(cluster, "remove", "//c/missing", "-f")
    assert _json(cluster, "exists", "//c/a3/b") is False
    assert _json(cluster, "exists", "//c/a3/doc3") is True
    rc, _, err = _yt(cluster, "remove", "//c/missing")
    assert rc == 1 and json.loads(err)["code"]


def test_table_and_query_verbs(cluster):
    rows = [{"k": i, "g": i % 4, "v": i * 10} for i in range(40)]
    blob = "".join(json.dumps(r) + "\n" for r in rows).encode()
    _ok(cluster, "write-table", "//q/t", stdin=blob)
    _ok(cluster, "write-table", "//q/t", "--append",
        "--rows", json.dumps({"k": 40, "g": 0, "v": 400}))
    out = _ok(cluster, "read-table", "//q/t", "--format", "dsv")
    assert out.count(b"\n") == 41 and b"k=40" in out
    got = _json(cluster, "select-rows",
                "g, sum(v) AS s FROM [//q/t] WHERE k > ? GROUP BY g",
                "--param", "3")
    want = {g: sum(r["v"] for r in rows + [{"k": 40, "g": 0, "v": 400}]
                   if r["g"] == g and r["k"] > 3) for g in range(4)}
    assert {r["g"]: r["s"] for r in got} == want
    out = _ok(cluster, "select-rows", "--explain-analyze",
              "count(*) AS c FROM [//q/t] GROUP BY 1")
    text = out.decode()
    assert "spans:" in text and "query.select" in text
    trace_id = text.split("trace_id: ")[1].split()[0]
    assert _ok(cluster, "trace", trace_id).decode().startswith(
        f"trace {trace_id}")
    tree = _json(cluster, "trace", trace_id, "--json")
    assert tree[0]["name"] == "query.select"
    out = _ok(cluster, "top", "--by", "user")
    assert b"TOTAL" in out and b"queries" in out
    assert "by_pool" in _json(cluster, "top", "--json")
    assert b"totals:" in _ok(cluster, "mesh", "top")
    assert "programs" in _json(cluster, "mesh", "top", "--json")


def test_dynamic_table_verbs(cluster):
    _ok(cluster, "create", "table", "//d/t", "-r", "--attributes", json.dumps(
        {"dynamic": True, "schema": [
            {"name": "k", "type": "int64", "sort_order": "ascending"},
            {"name": "emb", "type": "vector<float, 4>"}]}))
    _ok(cluster, "mount-table", "//d/t")
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(16, 4)).astype(np.float32)
    _ok(cluster, "insert-rows", "//d/t", "--rows", json.dumps(
        [{"k": i, "emb": vecs[i].tolist()} for i in range(16)]))
    got = _json(cluster, "lookup-rows", "//d/t", "--keys", "[[3], [99]]")
    assert [r and r["k"] for r in got] == [3, None]
    near = _json(cluster, "nearest-rows", "//d/t", "emb",
                 json.dumps(vecs[7].tolist()), "3", "--metric", "l2")
    assert near[0]["k"] == 7 and len(near) == 3
    _ok(cluster, "unmount-table", "//d/t")


def test_operation_verbs(cluster):
    rows = "".join(json.dumps({"k": k, "v": v}) + "\n"
                   for k, v in [(3, 1), (1, 2), (3, 4), (2, 8)]).encode()
    _ok(cluster, "write-table", "//o/in", stdin=rows)
    _ok(cluster, "write-table", "//o/in2", stdin=rows)
    op = _json(cluster, "sort", "--src", "//o/in", "--dst", "//o/s",
               "--sort-by", "k,v")
    assert op["state"] == "completed"
    op = _json(cluster, "merge", "--src", "//o/in,//o/in2", "--dst",
               "//o/m")
    assert op["state"] == "completed"
    assert _json(cluster, "get", "//o/m/@row_count") == 8
    op = _json(cluster, "map", "cat", "--src", "//o/in", "--dst", "//o/mp",
               "--job-count", "2")
    assert op["state"] == "completed"
    op = _json(cluster, "reduce", "cat", "--src", "//o/s", "--dst",
               "//o/r", "--reduce-by", "k", "--sort-by", "k,v")
    assert op["state"] == "completed"
    op = _json(cluster, "map-reduce", "cat", "--mapper-command", "cat",
               "--src", "//o/in", "--dst", "//o/mr", "--reduce-by", "k",
               "--partition-count", "2")
    assert op["state"] == "completed"
    assert _json(cluster, "get", "//o/mr/@row_count") == 4
    op = _json(cluster, "erase", "//o/in2")
    assert op["state"] == "completed"
    assert _json(cluster, "get", "//o/in2/@row_count") == 0
    op = _json(cluster, "vanilla", "--tasks",
               '{"t": {"job_count": 1, "command": "true"}}',
               "--max-gang-restarts", "0")
    assert op["state"] == "completed"
    op = _json(cluster, "remote-copy", "--cluster", cluster.primary_address,
               "--src", "//o/s", "--dst", "//o/copy")
    assert op["state"] == "completed"
    assert _json(cluster, "get", "//o/copy/@row_count") == 4
    # The thin client runs its operations' controllers in its own
    # process: the primary's scheduler knows none of them, and says so.
    for verb in ("get-operation", "abort-op"):
        rc, out, err = _yt(cluster, verb, op["operation_id"])
        assert rc == 1 and out == b""
        assert json.loads(err)["message"] == \
            f"No such operation {op['operation_id']}"


def test_transaction_and_security_verbs(cluster):
    _ok(cluster, "create", "map_node", "//x/locked", "-r")
    tx = _json(cluster, "start-tx")
    _ok(cluster, "lock", "//x/locked", "--tx", tx, "--mode", "shared")
    _ok(cluster, "commit-tx", tx)
    tx = _json(cluster, "start-tx")
    _ok(cluster, "abort-tx", tx)
    _ok(cluster, "create-user", "alice")
    _ok(cluster, "create-account", "team")
    got = _json(cluster, "check-permission", "alice", "read", "//x")
    assert got["action"] in ("allow", "deny")


def test_orchid_serves_the_primary_profiler(cluster):
    tree = _json(cluster, "orchid", "/profiler")
    assert tree["total_samples"] >= 0 and tree["interval"] == 0.05
    assert tree["distinct_stacks"] <= 4096
    assert isinstance(_json(cluster, "orchid", "/profiler/collapsed"),
                      list)
    assert "spans" in _json(cluster, "orchid", "/tracing/export")
    assert isinstance(_json(cluster, "orchid", "/tracing/recent_spans"),
                      list)
    assert "profiler" in _json(cluster, "orchid")


def test_workload_capture_and_replay_from_the_primary(cluster, tmp_path):
    _ok(cluster, "write-table", "//w/t", stdin=b"".join(
        json.dumps({"g": i % 3, "v": i}).encode() + b"\n"
        for i in range(30)))
    for lit in (5, 10, 20):
        _ok(cluster, "select-rows",
            f"g, sum(v) AS s FROM [//w/t] WHERE v < {lit} GROUP BY g")
    cap = str(tmp_path / "cap.json")
    written = _json(cluster, "workload", "capture", "--out", cap)
    assert written["written"] >= 3
    shown = _ok(cluster, "workload", "show", "--limit", "3")
    assert b"fingerprint" in shown
    assert "fingerprints" in _json(cluster, "workload", "show", "--json")
    # The primary's log holds the module's earlier traffic too (some of
    # it against tables since unmounted): replay this test's selects.
    from ytsaurus_tpu_torch.query import workload as wl
    mine = [r for r in wl.load_capture(cap) if "//w/t" in r.query]
    assert len(mine) >= 3
    wl.write_capture(cap, mine)
    report = _json(cluster, "replay", "--capture", cap, "--rate", "100",
                   "--workers", "4", "--json")
    assert report["queries"] == len(mine) == report["ok"]
    assert all(entry["trace_id"] for entry in report["slowest"])
    assert report["compile_cache"]["hit_rate"] is None
    out = _ok(cluster, "replay", "--capture", cap, "--limit", "2")
    assert b"replayed 2 queries" in out and b"trace=" in out
    local = str(tmp_path / "local.json")
    _json(cluster, "workload", "export", "--out", local)
    assert _json(cluster, "workload", "import", "--file", cap)[
        "imported"] == len(mine)


def test_view_verbs(cluster):
    _ok(cluster, "create", "table", "//v/q", "-r", "--attributes",
        json.dumps({"dynamic": True, "schema": [
            {"name": "g", "type": "int64"}, {"name": "v", "type": "int64"}]}))
    _ok(cluster, "mount-table", "//v/q")
    _ok(cluster, "insert-rows", "//v/q", "--rows", json.dumps(
        [{"g": i % 2, "v": i} for i in range(10)]))
    spec = _json(cluster, "view", "create", "sums", "--query",
                 "g, sum(v) AS s FROM [//v/q] GROUP BY g",
                 "--batch-rows", "4")
    assert spec["state"] == "running"
    assert b"sums" in _ok(cluster, "view", "list")
    report = _json(cluster, "view", "refresh", "sums")
    assert report["rows_in"] == 10
    assert _json(cluster, "view", "show", "sums")["lag_rows"] == 0
    assert _json(cluster, "view", "pause", "sums")["state"] == "paused"
    assert _json(cluster, "view", "resume", "sums")["state"] == "running"
    assert [s["name"] for s in _json(cluster, "view", "list", "--json")] \
        == ["sums"]
    assert _json(cluster, "view", "remove", "sums", "--drop-target") == \
        {"removed": "sums"}


def test_analyze_reads_the_port_tree(cluster):
    rc, out, err = _yt(cluster, "analyze", "--pass", "errors", "--json",
                       proxy=False)
    payload = json.loads(out)
    assert payload["package"] == "ytsaurus_tpu_torch"
    assert rc == (1 if payload["violations"] else 0)
    assert all(f["path"].startswith("ytsaurus_tpu_torch/")
               for f in payload["findings"])
    rc, _, err = _yt(cluster, "analyze", "--pass", "nope", proxy=False)
    assert rc == 2 and "unknown pass" in err


@pytest.mark.parametrize("argv", [
    ["compile-cache", "top"], ["prewarm", "--capture", "x.json"]])
def test_compile_verbs_are_refused_over_the_wire(cluster, argv):
    rc, out, err = _yt(cluster, *argv)
    assert rc == 1 and out == b""
    assert "not applicable in the port" in json.loads(err)["message"]


def test_the_card_is_required_by_default(cluster, monkeypatch):
    """Without a card the CLI exits 1 naming the device, before it
    connects; the CPU is only what the caller asks for."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.delenv("YT_CLI_PLATFORM")
    rc, out, err = _yt(cluster, "list", "/")
    assert rc == 1 and out == b"" and "device 'cuda'" in err
    rc, _, err = _yt(cluster, "--device", "cuda:0", "list", "/")
    assert rc == 1 and "device 'cuda:0'" in err
    assert _yt(cluster, "--device", "cpu", "list", "/")[0] == 0
    rc, _, err = _yt(cluster, "--device", "tpu", "list", "/")
    assert rc == 1 and "tpu" in err
