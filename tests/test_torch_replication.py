"""The port's replicated and chaos tables against the JAX package's: one
script of writes, replicas (sync, async, on the same root and on a second
root), replication, tracker passes, a chaos era switch and replica
fallback reads, driven alike through both clients and compared by rows,
events (their timestamps by rank: two clusters' clocks differ), replica
descriptors and the replication card. The port runs with device="cpu".

Twins, run on the port through `port_twin`: every case of
tests/test_replication.py (9) and of tests/test_chaos.py (3).
"""

import time

import numpy as np
import pytest
import torch

from tests.test_torch_client import (
    _both,
    _code,
    call_twin,
    port_twin,
    twin_cases,
)

torch.set_num_threads(1)

_REPL_TWIN = port_twin("test_replication")
_REPL_CASES = twin_cases(_REPL_TWIN)
_CHAOS_TWIN = port_twin("test_chaos")
_CHAOS_CASES = twin_cases(_CHAOS_TWIN)


def test_twin_lists_are_whole():
    assert len(_REPL_CASES) == 9
    assert len(_CHAOS_CASES) == 3


def _fixtures(twin, tmp_path, monkeypatch) -> dict:
    return {"upstream": twin.connect(str(tmp_path / "up")),
            "downstream_root": str(tmp_path / "down"),
            "monkeypatch": monkeypatch, "tmp_path": tmp_path}


@pytest.mark.parametrize("name", _REPL_CASES)
def test_reference_replication_case_on_the_port(name, tmp_path,
                                                monkeypatch):
    call_twin(_REPL_TWIN, name, _fixtures(_REPL_TWIN, tmp_path,
                                          monkeypatch))


@pytest.mark.parametrize("name", _CHAOS_CASES)
def test_reference_chaos_case_on_the_port(name, tmp_path, monkeypatch):
    call_twin(_CHAOS_TWIN, name, _fixtures(_CHAOS_TWIN, tmp_path,
                                           monkeypatch))


# --- one script through both clients ----------------------------------------


def _ranked(events) -> list:
    """Events with each timestamp replaced by its rank among them."""
    order = {ts: i for i, ts in enumerate(sorted({e[0] for e in events}))}
    return [(order[ts], op, payload) for ts, op, payload in events]


def _descriptors(replicas: dict) -> dict:
    return {rid: {k: (v > 0 if k == "last_replicated_ts" else v)
                  for k, v in info.items() if k != "cluster_root"}
            for rid, info in replicas.items()}


def _card(card) -> dict:
    return {"era": card["era"],
            "history": [{k: v for k, v in h.items() if k != "ts"}
                        for h in card["history"]]}


def _next_second() -> None:
    """Wait for the wall clock's next second. Both packages fold a
    replicated timestamp into the process-wide provider, not into the
    replica cluster's own, so a replica on a second root reads at its own
    clock: in the second of the upstream's commits it can read below
    them (ROADMAP queue 3). The reference's tests wait the same way."""
    time.sleep(1.02 - time.time() % 1)


def _replication_script(c, Schema, Error, down_root) -> dict:
    pkg = type(c).__module__.split(".")[0]
    repl = __import__(f"{pkg}.tablet.replication", fromlist=["x"])
    chaos = __import__(f"{pkg}.tablet.chaos", fromlist=["x"])
    down = c.table_replicator.replica_client(down_root)
    schema = Schema.make([("k", "int64", "ascending"), ("v", "int64"),
                          ("s", "string")], unique_keys=True)
    for client, path in ((c, "//t"), (c, "//r_sync"), (down, "//r_async"),
                         (down, "//r_chaos")):
        client.create("table", path, recursive=True, attributes={
            "schema": schema, "dynamic": True})
        if path == "//t":
            client.reshard_table(path, [(500,)])
        client.mount_table(path)
    out = {}
    r_sync = c.create_table_replica("//t", "//r_sync", mode="sync")
    r_async = c.create_table_replica("//t", "//r_async",
                                     cluster_root=down_root, mode="async")
    rng = np.random.default_rng(17)
    keys = rng.permutation(1000)[:600]
    for lo in range(0, 600, 100):
        tx = c.start_transaction()
        c.insert_rows("//t", [{"k": int(k), "v": int(k) * 3,
                               "s": f"s{int(k) % 7}"}
                              for k in keys[lo:lo + 100]], tx=tx)
        c.commit_transaction(tx)
    c.insert_rows("//t", [{"k": int(keys[0]), "v": -1}], update=True)
    c.delete_rows("//t", [(int(k),) for k in keys[:20]])
    out["events"] = _ranked(repl.events_since(c, "//t", 0))
    out["lag"] = c.table_replicator.lag("//t", r_async)
    out["step"] = c.table_replicator.replicate_step("//t")
    out["step_again"] = c.table_replicator.replicate_step("//t")
    probe = [(int(k),) for k in keys[:40]] + [(5000,)]
    _next_second()
    out["lookups"] = [client.lookup_rows(path, probe) for client, path in
                      ((c, "//t"), (c, "//r_sync"), (down, "//r_async"))]
    out["selects"] = [client.select_rows(f"k, v, s FROM [{path}] "
                                         "ORDER BY k LIMIT 1000")
                      for client, path in ((c, "//t"), (c, "//r_sync"),
                                           (down, "//r_async"))]
    c.alter_table_replica("//t", r_async, enabled=False)
    c.insert_rows("//t", [{"k": 2000, "v": 1, "s": "late"}])
    out["disabled_step"] = c.table_replicator.replicate_step("//t")
    c.alter_table_replica("//t", r_async, enabled=True)
    out["enabled_step"] = c.table_replicator.replicate_step("//t")
    out["caught_up"] = down.lookup_rows("//r_async", [(2000,)])
    out["bad_mode"] = _code(lambda: c.alter_table_replica(
        "//t", r_async, mode="eventual"), Error)
    # One chaos era switch: a new sync replica joins, then writes span it.
    r_chaos = c.create_table_replica("//t", "//r_chaos",
                                     cluster_root=down_root, mode="async")
    coord = chaos.ChaosCoordinator(c)
    c.insert_rows("//t", [{"k": 3000, "v": 30, "s": "pre"}])
    out["era"] = coord.switch_sync("//t", r_chaos)
    c.insert_rows("//t", [{"k": 3001, "v": 31, "s": "post"}])
    c.table_replicator.replicate_step("//t")
    _next_second()
    out["chaos_rows"] = [client.lookup_rows(path, [(3000,), (3001,)])
                         for client, path in ((c, "//r_sync"),
                                              (down, "//r_async"),
                                              (down, "//r_chaos"))]
    out["card"] = _card(chaos.get_card(c, "//t"))
    out["replicas"] = _descriptors(c.get_table_replicas("//t"))
    c.unmount_table("//t")
    out["fallback"] = c.lookup_rows("//t", probe[15:25],
                                    replica_fallback=True)
    out["no_fallback"] = _code(lambda: c.lookup_rows("//t", probe[15:25]),
                               Error)
    return out


def test_replication_and_chaos_match(tmp_path):
    down = {"ref": str(tmp_path / "ref_down"),
            "port": str(tmp_path / "port_down")}
    ref, port = _both(
        lambda c, S, E: _replication_script(
            c, S, E, down["port" if "torch" in type(c).__module__
                          else "ref"]), tmp_path)
    for key in ("events", "lag", "step", "step_again", "disabled_step",
                "enabled_step", "bad_mode", "era", "card", "replicas",
                "no_fallback"):
        assert port[key] == ref[key], key
    for key in ("lookups", "selects", "chaos_rows"):
        for got, want in zip(port[key], ref[key]):
            assert got == want, key
    assert port["caught_up"] == ref["caught_up"]
    assert port["fallback"] == ref["fallback"]
    # probe[15:20] were deleted upstream and replicated as deletes.
    assert [row is None for row in port["fallback"]] == [True] * 5 + \
        [False] * 5
