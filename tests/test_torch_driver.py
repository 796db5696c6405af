"""The port's front doors against the JAX package's: the driver's command
registry (`driver.py`), one script of driver commands through both
clients, `DriverService` over `RpcServer` with the wire transactions and
their lease, and the HTTP and TCP proxies answering the same REST and RPC
scripts. Both clients run on the CPU (the port's with device="cpu"), each
on a fresh root; results are compared with ids, addresses and times
masked, doubles by tests/harness.py's canon.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.harness import _canon_row
from tests.test_torch_client import _connect, _mask
from ytsaurus_tpu import client as ref_client
from ytsaurus_tpu import driver as ref_driver
from ytsaurus_tpu import rpc as ref_rpc
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.server import http_proxy as ref_http
from ytsaurus_tpu.server import services as ref_services
from ytsaurus_tpu.server import tcp_proxy as ref_tcp
from ytsaurus_tpu_torch import client as port_client
from ytsaurus_tpu_torch import driver, rpc
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.server import http_proxy, services, tcp_proxy

torch.set_num_threads(1)

_PKGS = {
    "reference": dict(client=ref_client, driver=ref_driver, rpc=ref_rpc,
                      services=ref_services, http=ref_http, tcp=ref_tcp,
                      Error=RefYtError),
    "port": dict(client=port_client, driver=driver, rpc=rpc,
                 services=services, http=http_proxy, tcp=tcp_proxy,
                 Error=YtError),
}


def _both(script, tmp_path) -> tuple:
    """(reference outcome, port outcome) of script(client, pkg)."""
    return tuple(script(_connect(_PKGS[name]["client"], tmp_path / name),
                        _PKGS[name]) for name in ("reference", "port"))


def _canon(rows) -> list:
    return sorted(_canon_row(r) for r in rows)


def _no_ts(rows) -> list:
    """Queue rows without their commit timestamps (each client's clock)."""
    return [{k: v for k, v in r.items() if k != "$timestamp"} for r in rows]


def _error(fn, Error):
    try:
        fn()
    except Error as err:
        return int(err.code), re.sub(r"[0-9a-f]{32}", "<id>", err.message)
    return None


# --- the registry -------------------------------------------------------------


def test_command_registry_is_the_references():
    assert list(driver.COMMANDS) == list(ref_driver.COMMANDS)
    for name, ref in ref_driver.COMMANDS.items():
        port = driver.COMMANDS[name]
        assert (port.name, port.required, port.optional, port.is_mutating) \
            == (ref.name, ref.required, ref.optional, ref.is_mutating), name


def test_unknown_missing_and_extra_parameters_fail_alike(tmp_path):
    def script(c, pkg):
        d = pkg["driver"].Driver(c)
        E = pkg["Error"]
        return [_error(lambda: d.execute("frobnicate"), E),
                _error(lambda: d.execute("get", {}), E),
                _error(lambda: d.execute("get", {"path": "//", "x": 1}), E),
                _error(lambda: d.execute("get", {"path": "//nope"}), E),
                _error(lambda: d.execute("select_rows",
                                         {"query": "k FROM [//nope]"}), E)]
    ref, port = _both(script, tmp_path)
    assert port == ref
    assert all(entry is not None for entry in port)


# --- one script of driver commands through both clients -----------------------

_DYN_SCHEMA = [{"name": "k", "type": "int64", "sort_order": "ascending"},
               {"name": "v", "type": "int64"}, {"name": "s", "type": "string"}]
_QUEUE_SCHEMA = [{"name": "k", "type": "int64"}, {"name": "g", "type": "int64"},
                 {"name": "v", "type": "double"}]


def _driver_script(c, pkg) -> dict:
    d = pkg["driver"].Driver(c)
    x = d.execute
    out = {}
    rng = np.random.default_rng(8)
    rows = [{"k": int(k), "g": int(g), "v": float(v)} for k, g, v in zip(
        rng.permutation(300), rng.integers(0, 6, 300), rng.normal(size=300))]
    # Cypress, master transactions, security.
    out["create"] = x("create", {"type": "map_node", "path": "//drv",
                                 "recursive": True})
    x("set", {"path": "//drv/@owner", "value": "tester"})
    out["get"] = x("get", {"path": "//drv/@owner"})
    tx = x("start_tx", {})
    x("create", {"type": "document", "path": "//drv/doc", "tx": tx})
    x("set", {"path": "//drv/doc", "value": {"a": [1, 2]}, "tx": tx})
    x("commit_tx", {"tx": tx})
    out["doc"] = x("get", {"path": "//drv/doc"})
    x("create_user", {"name": "alice"})
    out["perm"] = x("check_permission", {"user": "alice",
                                         "permission": "write",
                                         "path": "//drv"})
    # Static tables and the operations.
    x("write_table", {"path": "//drv/t", "rows": rows[:200]})
    x("write_table", {"path": "//drv/t", "rows": rows[200:],
                      "append": True})
    out["read"] = x("read_table", {"path": "//drv/t"})
    out["read_json"] = x("read_table", {"path": "//drv/t", "format": "json"})
    op_id = x("sort", {"input_table_path": "//drv/t",
                       "output_table_path": "//drv/sorted",
                       "sort_by": ["g", "k"]})
    out["sort_op"] = x("get_operation", {"operation_id": op_id})
    out["sorted"] = x("read_table", {"path": "//drv/sorted"})
    op_id = x("merge", {"input_table_paths": ["//drv/t", "//drv/t"],
                        "output_table_path": "//drv/merged"})
    out["merge_op"] = x("get_operation", {"operation_id": op_id})
    out["merged"] = len(x("read_table", {"path": "//drv/merged"}))
    op_id = x("erase", {"table_path": "//drv/merged"})
    out["erased"] = x("read_table", {"path": "//drv/merged"})
    x("copy", {"source_path": "//drv/t", "destination_path": "//drv/t2"})
    x("move", {"source_path": "//drv/t2", "destination_path": "//drv/t3"})
    x("link", {"target_path": "//drv/t", "link_path": "//drv/tl"})
    out["list"] = sorted(x("list", {"path": "//drv"}))
    out["exists"] = [x("exists", {"path": p})
                     for p in ("//drv/t3", "//drv/t2", "//drv/tl")]
    # Selects, with and without EXPLAIN ANALYZE.
    group = "g, sum(v) AS s, count(*) AS c FROM [//drv/t] GROUP BY g"
    out["select"] = x("select_rows", {"query": group})
    out["ordered"] = x("select_rows", {
        "query": "k, v FROM [//drv/sorted] WHERE k < ? ORDER BY k LIMIT 9",
        "params": [40]})
    profile = x("select_rows", {"query": group, "explain_analyze": True})
    out["profile"] = (sorted(profile), profile["rows"], profile["query"],
                      profile["statistics"]["rows_read"],
                      profile["span_tree"][0]["name"])
    json.dumps(profile)       # plain values only
    # Dynamic tables.
    x("create", {"type": "table", "path": "//drv/dyn",
                 "attributes": {"schema": _DYN_SCHEMA, "dynamic": True}})
    x("mount_table", {"path": "//drv/dyn"})
    x("insert_rows", {"path": "//drv/dyn", "rows": [
        {"k": i, "v": i * i, "s": f"s{i}"} for i in range(40)]})
    x("delete_rows", {"path": "//drv/dyn", "keys": [[3], [5]]})
    out["lookup"] = x("lookup_rows", {"path": "//drv/dyn",
                                      "keys": [[1], [3], [39], [77]]})
    out["lookup_cols"] = x("lookup_rows", {"path": "//drv/dyn",
                                           "keys": [[2]],
                                           "column_names": ["v"]})
    out["dyn_select"] = x("select_rows", {
        "query": "sum(v) AS t, count(*) AS c FROM [//drv/dyn] "
                 "GROUP BY 1 AS o"})
    # Queues, consumers and views.
    x("create", {"type": "table", "path": "//drv/q",
                 "attributes": {"schema": _QUEUE_SCHEMA, "dynamic": True}})
    x("mount_table", {"path": "//drv/q"})
    x("push_queue", {"path": "//drv/q", "rows": [
        {"k": k, "g": k % 5, "v": float((k * 7) % 23)} for k in range(12)]})
    out["pull"] = _no_ts(x("pull_queue", {"path": "//drv/q", "offset": 2,
                                          "limit": 4}))
    x("register_queue_consumer", {"queue_path": "//drv/q",
                                  "consumer_path": "//drv/consumer"})
    x("advance_consumer", {"consumer_path": "//drv/consumer",
                           "queue_path": "//drv/q", "new_offset": 5})
    pulled = x("pull_consumer", {"consumer_path": "//drv/consumer",
                                 "queue_path": "//drv/q", "limit": 3})
    out["consumer"] = (_no_ts(pulled["rows"]), pulled["next_offset"])
    spec = x("create_materialized_view", {
        "name": "agg", "query": "g, sum(v) AS s, count(*) AS c "
                                "FROM [//drv/q] GROUP BY g",
        "batch_rows": 5})
    out["view_spec"] = {k: spec[k] for k in ("state", "target", "source")}
    out["views"] = x("list_views", {})
    out["refresh"] = {k: v for k, v in x("refresh_view",
                                         {"name": "agg"}).items()
                      if "second" not in k and "time" not in k}
    out["view"] = {k: v for k, v in x("get_view", {"name": "agg"}).items()
                   if k in ("state", "offset", "lag_rows", "rows_in")}
    out["view_rows"] = x("select_rows", {
        "query": f"g, s, c FROM [{spec['target']}]"})
    out["paused"] = x("pause_view", {"name": "agg"})["state"]
    out["resumed"] = x("resume_view", {"name": "agg"})["state"]
    x("remove_view", {"name": "agg", "drop_target": True})
    out["views_after"] = x("list_views", {})
    x("trim_rows", {"path": "//drv/q", "trimmed_row_count": 4})
    out["trimmed"] = _no_ts(x("pull_queue", {"path": "//drv/q",
                                             "offset": 0, "limit": 2}))
    # The query tracker's verbs.
    qid = x("start_query", {"query": "k FROM [//drv/t] WHERE k < 3"})
    c.query_tracker.wait(qid)
    record = x("get_query", {"query_id": qid})
    out["query"] = (record["state"], record["engine"], record["query"])
    out["query_rows"] = x("read_query_result", {"query_id": qid})
    out["queries"] = [q["state"] for q in x("list_queries", {})]
    x("remove", {"path": "//drv/t3"})
    out["gc"] = x("collect_garbage", {})
    return {k: v if k in _ROW_KEYS else _mask(v) for k, v in out.items()}


_ROW_KEYS = {"read", "sorted", "select", "ordered", "dyn_select", "pull",
             "view_rows", "query_rows", "read_json", "profile"}


def test_driver_script_matches(tmp_path):
    ref, port = _both(_driver_script, tmp_path)
    assert sorted(port) == sorted(ref)
    for key in _ROW_KEYS - {"read_json", "profile"}:
        assert _canon(port[key]) == _canon(ref[key]), key
    assert port["sorted"] == ref["sorted"] and port["ordered"] == \
        ref["ordered"]
    assert port["read_json"] == ref["read_json"]
    for key in set(ref) - _ROW_KEYS:
        assert port[key] == ref[key], key
    names, rows, query, read, root = port["profile"]
    ref_names, ref_rows, ref_query, ref_read, ref_root = ref["profile"]
    assert (names, query, read, root) == (ref_names, ref_query, ref_read,
                                          ref_root)
    assert _canon(rows) == _canon(ref_rows)


# --- DriverService over RpcServer ----------------------------------------------


def _wire_script(c, pkg, lease_seconds=None) -> dict:
    """Driver commands and wire transactions through a DriverService on
    an RpcServer, called by a RetryingChannel."""
    svc = pkg["services"].DriverService(c)
    server = pkg["rpc"].RpcServer([svc])
    server.start()
    channel = pkg["rpc"].RetryingChannel(
        pkg["rpc"].Channel(server.address, timeout=30))
    out: dict = {}

    def call(method, body, attachments=()):
        try:
            return channel.call("driver", method, body, attachments)
        except (YtError, RefYtError) as err:
            return ("err", int(err.code))

    try:
        ex = lambda command, **p: call("execute", {"command": command,  # noqa: E731
                                                   "parameters": p})
        out["ping"] = call("ping", {})
        ex("create", type="table", path="//w/dyn", recursive=True,
           attributes={"schema": _DYN_SCHEMA, "dynamic": True})
        ex("mount_table", path="//w/dyn")
        committed = []
        for t in range(3):
            body, _ = call("start_transaction", {})
            tx_id = body["tx_id"]
            rows = [{"k": t * 10 + i, "v": i, "s": f"t{t}"}
                    for i in range(10)]
            call("insert_rows_tx", {"tx_id": tx_id, "path": "//w/dyn",
                                    "rows": rows})
            if t == 1:
                out["delete"] = call("delete_rows_tx", {
                    "tx_id": tx_id, "path": "//w/dyn", "keys": [[12]]})
                out["abort"] = call("abort_transaction", {"tx_id": tx_id})
                continue
            body, _ = call("commit_transaction", {"tx_id": tx_id})
            out.setdefault("commit_ts_positive", []).append(
                body["commit_timestamp"] > 0)
            committed += rows
        out["unknown_tx"] = call("commit_transaction", {"tx_id": "nope"})
        got, _ = ex("select_rows", query="k, v, s FROM [//w/dyn]")
        out["rows"] = _canon(got["result"])
        out["acknowledged"] = _canon(got["result"]) == _canon(committed)
        out["lookup"], _ = ex("lookup_rows", path="//w/dyn",
                              keys=[[0], [12], [25]])
        blob, attachments = call("execute", {
            "command": "write_table",
            "parameters": {"path": "//w/static", "format": "json"}},
            [b'{"x": 1}\n{"x": 2}\n'])
        out["write_blob"] = blob
        out["read_blob"] = ex("read_table", path="//w/static",
                              format="json")
        out["user"] = call("execute", {"command": "check_permission",
                                       "parameters": {
                                           "user": "nobody",
                                           "permission": "read",
                                           "path": "//w"},
                                       "user": "root"})
        if lease_seconds is not None:
            # Short leases only now, so that a loaded host cannot expire
            # the transactions above.
            svc.TX_LEASE_SECONDS = lease_seconds
            body, _ = call("start_transaction", {})
            tx_id = body["tx_id"]
            call("insert_rows_tx", {"tx_id": tx_id, "path": "//w/dyn",
                                    "rows": [{"k": 99, "v": 1, "s": "x"}]})
            time.sleep(lease_seconds * 3)
            # Any use of the table of transactions sweeps the lapsed one.
            call("start_transaction", {})
            out["expired"] = call("commit_transaction", {"tx_id": tx_id})
            got, _ = ex("lookup_rows", path="//w/dyn", keys=[[99]])
            out["expired_rows"] = got["result"]
    finally:
        channel.close()
        server.stop()
    return {k: _mask(v) for k, v in out.items()}


def test_driver_service_over_rpc_matches(tmp_path):
    ref, port = _both(_wire_script, tmp_path)
    assert port == ref
    assert port["acknowledged"] is True
    assert port["unknown_tx"] == ["err", int(EErrorCode.NoSuchTransaction)]
    assert port["commit_ts_positive"] == [True, True]


def test_expired_transaction_lease_is_swept(tmp_path):
    ref, port = _both(lambda c, pkg: _wire_script(c, pkg, 0.3), tmp_path)
    assert port == ref
    assert port["expired"] == ["err", int(EErrorCode.NoSuchTransaction)]
    assert port["expired_rows"] == [None]


@pytest.mark.parametrize("server_pkg,channel_pkg",
                         [("reference", "port"), ("port", "reference")])
def test_driver_service_answers_the_other_packages_channel(
        tmp_path, server_pkg, channel_pkg):
    c = _connect(_PKGS[server_pkg]["client"], tmp_path)
    c.write_table("//x", [{"k": i, "g": i % 3} for i in range(30)])
    server = _PKGS[server_pkg]["rpc"].RpcServer(
        [_PKGS[server_pkg]["services"].DriverService(c)])
    server.start()
    channel = _PKGS[channel_pkg]["rpc"].Channel(server.address, timeout=30)
    try:
        body, _ = channel.call("driver", "execute", {
            "command": "select_rows",
            "parameters": {"query": "g, count(*) AS n FROM [//x] GROUP BY g"}})
        assert sorted((r["g"], r["n"]) for r in body["result"]) == \
            [(0, 10), (1, 10), (2, 10)]
        with pytest.raises((YtError, RefYtError)) as err:
            channel.call("driver", "execute", {"command": "get",
                                               "parameters": {}})
        assert int(err.value.code) == int(EErrorCode.Generic)
    finally:
        channel.close()
        server.stop()


# --- the HTTP proxy --------------------------------------------------------------


def _http(address, method, path, body=None, headers=None):
    req = urllib.request.Request(f"http://{address}{path}", data=body,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def _rest_script(c, pkg) -> list:
    proxy = pkg["http"].HttpProxy(lambda user: c)
    proxy.start()
    a = proxy.address
    out = []

    def post(command, params, **headers):
        return _http(a, "POST", f"/api/v4/{command}",
                     json.dumps(params).encode(),
                     {"Content-Type": "application/json", **headers})

    def record(name, answer, body=lambda b: json.loads(b)):
        status, headers, raw = answer
        out.append((name, status, headers.get("Content-Type"),
                    headers.get("Retry-After"), body(raw) if raw else raw))

    try:
        record("ping", _http(a, "GET", "/ping"), body=bytes)
        record("api", _http(a, "GET", "/api/v4"))
        record("hosts", _http(a, "GET", "/hosts"),
               body=lambda b: [h == a for h in json.loads(b)])
        record("create", post("create", {"type": "map_node",
                                         "path": "//rest",
                                         "recursive": True}))
        record("set", post("set", {"path": "//rest/@tag", "value": 42}))
        record("get", _http(a, "GET", '/api/v4/get?path=%22//rest/@tag%22'))
        record("exists", post("exists", {"path": "//rest"}))
        record("create_t", post("create", {
            "type": "table", "path": "//rest/t", "attributes": {
                "schema": [{"name": "k", "type": "int64",
                            "sort_order": "ascending"},
                           {"name": "g", "type": "int64"},
                           {"name": "v", "type": "double"},
                           {"name": "s", "type": "string"}]}}))
        rows = "".join(json.dumps({"k": i, "g": i % 4, "v": i / 8,
                                   "s": f"s{i % 3}"}) + "\n"
                       for i in range(64))
        record("write", _http(a, "PUT", "/api/v4/write_table",
                              rows.encode(), {"X-YT-Parameters": json.dumps(
                                  {"path": "//rest/t", "format": "json"})}))
        record("read", _http(a, "GET", '/api/v4/read_table?path=%22//rest/t'
                                        '%22&format=%22json%22'),
               body=lambda b: [json.loads(line) for line in b.splitlines()])
        record("read_yson", _http(a, "GET", '/api/v4/read_table?path=%22'
                                            '//rest/t%22&format=%22yson%22'),
               body=bytes)
        record("select", post("select_rows", {
            "query": "g, sum(v) AS s, count(*) AS c FROM [//rest/t] "
                     "GROUP BY g ORDER BY g LIMIT 10"}))
        record("select_params", _http(
            a, "POST", "/api/v4/select_rows", json.dumps(
                {"params": [10]}).encode(),
            {"Content-Type": "application/json", "X-YT-Timeout": "30",
             "X-YT-Parameters": json.dumps({
                 "query": "k, s FROM [//rest/t] WHERE k < ? "
                          "ORDER BY k LIMIT 100"})}))
        record("join_rows", post("write_table", {
            "path": "//rest/dim", "rows": [{"g": g, "name": f"n{g}"}
                                           for g in range(4)]}))
        record("join", post("select_rows", {
            "query": "name, sum(v) AS s FROM [//rest/t] JOIN [//rest/dim] "
                     "USING g GROUP BY name ORDER BY name LIMIT 10"}))
        trace_id = "ab" * 16
        status, headers, raw = post(
            "select_rows", {"query": "sum(v) AS s FROM [//rest/t] "
                                     "GROUP BY 1 AS o",
                            "explain_analyze": True},
            **{"X-YT-Trace-Id": trace_id})
        profile = json.loads(raw)["value"]
        out.append(("explain", status,
                    headers.get("X-YT-Trace-Id") == trace_id,
                    profile["trace_id"] == trace_id, profile["rows"],
                    profile["statistics"]["rows_read"],
                    sorted(profile)))
        record("error", post("get", {"path": "//no/such"}))
        record("unknown", post("frobnicate", {}))
        record("missing", post("get", {}))
        record("not_found", _http(a, "GET", "/nowhere"), body=bytes)
    finally:
        proxy.stop()
    return _mask(out)


def test_http_proxies_answer_alike(tmp_path):
    ref, port = _both(_rest_script, tmp_path)
    assert [entry[:2] for entry in port] == [entry[:2] for entry in ref]
    for p, r in zip(port, ref):
        assert p == r, p[0]
    by_name = {entry[0]: entry for entry in port}
    assert by_name["ping"][1] == 200 and by_name["unknown"][1] == 404
    assert by_name["error"][1] == 400 and by_name["not_found"][1] == 404
    assert by_name["explain"][2] is True and by_name["explain"][3] is True


def test_http_proxy_refuses_a_leaked_tensor(tmp_path):
    c = port_client.connect(str(tmp_path), device="cpu")
    proxy = http_proxy.HttpProxy(lambda user: c)
    proxy._execute = lambda *args: [{"x": torch.ones(1)}]
    proxy.start()
    try:
        status, _, raw = _http(proxy.address, "POST", "/api/v4/get",
                               json.dumps({"path": "//"}).encode(),
                               {"Content-Type": "application/json"})
    finally:
        proxy.stop()
    assert status == 400 and b"leaked into a reply" in raw


# --- the TCP proxy ----------------------------------------------------------------


def _tcp_script(c, pkg) -> dict:
    c.write_table("//tcp/t", [{"k": i, "g": i % 5} for i in range(100)])
    server = pkg["rpc"].RpcServer([pkg["services"].DriverService(c)])
    server.start()
    proxy = pkg["tcp"].TcpProxy([server.address]).start()
    out = {}
    try:
        results = [None] * 8

        def work(i):
            channel = pkg["rpc"].RetryingChannel(
                pkg["rpc"].Channel(proxy.address, timeout=30))
            try:
                body, _ = channel.call("driver", "execute", {
                    "command": "select_rows", "parameters": {
                        "query": f"k FROM [//tcp/t] WHERE k >= {i * 10} "
                                 f"AND k < {i * 10 + 5}"}})
                results[i] = sorted(r["k"] for r in body["result"])
            finally:
                channel.close()

        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["results"] = results
        out["connections"] = proxy.stats["connections"]
        out["routed"] = list(proxy.stats["routed_to"].values())
        out["picked"] = proxy.pick_backend() == server.address
    finally:
        proxy.stop()
        server.stop()
    return out


def test_tcp_proxies_route_alike(tmp_path):
    ref, port = _both(_tcp_script, tmp_path)
    assert port == ref
    assert port["results"] == [list(range(i * 10, i * 10 + 5))
                               for i in range(8)]
    assert port["connections"] == 8


def test_port_tcp_proxy_counts_bytes_before_a_reference_server(tmp_path):
    c = ref_client.connect(str(tmp_path))
    server = ref_rpc.RpcServer([ref_services.DriverService(c)])
    server.start()
    proxy = tcp_proxy.TcpProxy([server.address]).start()
    channel = rpc.Channel(proxy.address, timeout=30)
    try:
        body, _ = channel.call("driver", "ping", {})
        assert body == {"ok": True}
        deadline = time.monotonic() + 5
        while proxy.stats["bytes_out"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert proxy.stats["bytes_in"] > 0 and proxy.stats["bytes_out"] > 0
    finally:
        channel.close()
        proxy.stop()
        server.stop()
