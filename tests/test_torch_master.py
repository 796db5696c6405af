"""The port's master against the JAX package's: recovery from the
changelog, the torn-tail truncation, snapshots, and cluster directories
written by one package and opened by the other, both ways (a static
table, a dynamic table after unmount, nested master transactions). The
port runs with device="cpu"."""

import os
import time

import numpy as np
import pytest
import torch

from tests.test_torch_client import _cypress, _rows_equal
from ytsaurus_tpu import client as ref_client
from ytsaurus_tpu.cypress.master import Changelog as RefChangelog
from ytsaurus_tpu.cypress.master import Master as RefMaster
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch import client as port_client
from ytsaurus_tpu_torch.cypress.master import Changelog, Master
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.schema import TableSchema

torch.set_num_threads(1)


def _open(pkg, root, fresh=True):
    if pkg is port_client:
        return pkg.connect(str(root), fresh=fresh, device="cpu")
    return pkg.connect(str(root), fresh=fresh)


def _mutations(master):
    master.commit_mutation("create", path="//a", type="map_node",
                           attributes={"x": 1})
    master.commit_mutation("set", path="//a/@y", value=[1, "two", 3.5])
    tx = master.commit_mutation("tx_start")
    master.commit_mutation("create", path="//a/b", type="document",
                           tx=tx)
    master.commit_mutation("set", path="//a/b", value={"k": "v"}, tx=tx)
    master.commit_mutation("lock", tx_id=tx, path="//a", mode="shared")
    master.commit_mutation("batch", ops=[
        {"op": "create", "args": {"path": "//c", "type": "map_node"}},
        {"op": "set", "args": {"path": "//c/@z", "value": True}}])
    return tx


@pytest.mark.parametrize("snapshot", [False, True])
def test_changelog_and_snapshot_bytes_match_the_reference(tmp_path,
                                                          snapshot):
    """The same mutations give the same changelog records and, once
    snapshotted, the same snapshot tree in both packages."""
    ref, port = RefMaster(str(tmp_path / "ref")), \
        Master(str(tmp_path / "port"))
    for m in (ref, port):
        _mutations(m)
        if snapshot:
            m.build_snapshot()
            m.commit_mutation("set", path="//c/@after", value=1)
    ref_records, ref_valid = RefChangelog.read_all(
        str(tmp_path / "ref" / "changelog.log"))
    port_records, port_valid = Changelog.read_all(
        str(tmp_path / "port" / "changelog.log"))
    assert ref_valid == port_valid
    mask = _cypress
    assert [r["op"] for r in port_records] == [r["op"] for r in ref_records]
    assert mask(_MasterOnly(port)) == mask(_MasterOnly(ref))
    for m, pkg_master in ((ref, RefMaster), (port, Master)):
        reopened = pkg_master(m.root_dir)
        assert reopened.tree.get("//a/@y") == [1, "two", 3.5]
        assert reopened.tree.get("//c/@z") is True
        assert len(reopened.tx_manager.transactions) == 1


class _MasterOnly:
    """What `_cypress` reads of a client: its master."""

    def __init__(self, master):
        self.cluster = type("C", (), {"master": master})()


def test_torn_changelog_tail_is_truncated_like_the_reference(tmp_path):
    for pkg_master, root in ((RefMaster, tmp_path / "ref"),
                             (Master, tmp_path / "port")):
        m = pkg_master(str(root))
        m.commit_mutation("create", path="//t", type="map_node")
        m.commit_mutation("set", path="//t/@v", value=1)
        m.wal.close()
        path = os.path.join(str(root), "changelog.log")
        good = os.path.getsize(path)
        with open(path, "ab") as f:
            f.write(b"\x40partial")            # a torn record
        reopened = pkg_master(str(root))
        assert reopened.tree.get("//t/@v") == 1
        assert os.path.getsize(path) == good
        reopened.commit_mutation("set", path="//t/@v", value=2)
        assert pkg_master(str(root)).tree.get("//t/@v") == 2
    assert open(tmp_path / "ref" / "changelog.log", "rb").read() == \
        open(tmp_path / "port" / "changelog.log", "rb").read()


def test_poisoned_master_goes_read_only(tmp_path):
    m = Master(str(tmp_path))

    def fail(record):
        raise YtError("disk gone")

    m.wal.append = fail
    with pytest.raises(YtError):
        m.commit_mutation("create", path="//x", type="map_node")
    with pytest.raises(YtError, match="read-only"):
        m.commit_mutation("create", path="//y", type="map_node")


def _write_cluster(pkg, Schema, root):
    client = _open(pkg, root, fresh=True)
    rng = np.random.default_rng(4)
    rows = [{"k": int(k), "v": float(v), "s": f"s{int(k) % 3}"}
            for k, v in zip(rng.permutation(200), rng.normal(size=200))]
    client.write_table("//st/t", rows[:120])
    client.write_table("//st/t", rows[120:], append=True)
    client.run_sort("//st/t", "//st/sorted", sort_by=["s", "k"])
    schema = Schema.make([("k", "int64", "ascending"), ("v", "double"),
                          ("s", "string")], unique_keys=True)
    client.create("table", "//dy/t", recursive=True,
                  attributes={"schema": schema, "dynamic": True,
                              "pivot_keys": [[100]]})
    client.mount_table("//dy/t")
    client.insert_rows("//dy/t", rows)
    client.delete_rows("//dy/t", [(1,), (150,)])
    client.compact_table("//dy/t")
    client.insert_rows("//dy/t", [{"k": 500, "v": 1.5, "s": "late"}])
    client.unmount_table("//dy/t")
    qschema = Schema.make([("m", "string")])
    client.create("table", "//dy/q", recursive=True,
                  attributes={"schema": qschema, "dynamic": True})
    client.mount_table("//dy/q")
    client.push_queue("//dy/q", [{"m": f"m{i}"} for i in range(7)])
    client.trim_rows("//dy/q", 2)
    client.unmount_table("//dy/q")
    tx = client.start_tx()
    client.create("map_node", "//open/tx", recursive=True, tx=tx)
    client.cluster.master.build_snapshot()
    client.set("//st/@after_snapshot", "yes")
    # A reopened cluster's hybrid clock restarts from the wall clock's
    # second (both packages): reading in the second of the last commit
    # could pin a timestamp below it, which no real restart does.
    second = int(time.time())
    while int(time.time()) == second:
        time.sleep(0.01)
    return tx


def _read_cluster(pkg, root, tx) -> dict:
    client = _open(pkg, root, fresh=True)
    client.mount_table("//dy/t")
    client.mount_table("//dy/q")
    out = {
        "static": client.read_table("//st/t"),
        "sorted": client.read_table("//st/sorted"),
        "sorted_by": client.get("//st/sorted/@sorted_by"),
        "select": client.select_rows(
            "s, count(*) AS c, sum(v) AS sv FROM [//st/t] GROUP BY s "
            "ORDER BY s LIMIT 10"),
        "dynamic": client.select_rows(
            "k, v, s FROM [//dy/t] ORDER BY k LIMIT 1000"),
        "lookup": client.lookup_rows("//dy/t", [(1,), (2,), (500,)]),
        "queue": [r["m"] for r in client.pull_queue("//dy/q")],
        "after_snapshot": client.get("//st/@after_snapshot"),
        "tx_open": client.exists("//open/tx"),
    }
    client.abort_tx(tx)
    out["tx_aborted"] = client.exists("//open/tx")
    client.unmount_table("//dy/t")
    client.unmount_table("//dy/q")
    return out


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_cluster_directory_opens_in_the_other_package(tmp_path, writer):
    """A directory written by one package (changelog, snapshot, chunk
    files, attributes) opens in the other, with the rows it wrote."""
    pkgs = {"reference": (ref_client, RefSchema),
            "port": (port_client, TableSchema)}
    reader = "port" if writer == "reference" else "reference"
    root = tmp_path / "cluster"
    tx = _write_cluster(pkgs[writer][0], pkgs[writer][1], root)
    got = _read_cluster(pkgs[reader][0], root, tx)
    for key in ("static", "sorted", "select", "dynamic"):
        assert len(got[key]) > 0, key
    assert len(got["dynamic"]) == 199
    assert got["lookup"][0] is None and got["lookup"][2]["s"] == b"late"
    assert got["queue"] == [b"m2", b"m3", b"m4", b"m5", b"m6"]
    assert got["sorted_by"] == ["s", "k"]
    assert got["after_snapshot"] == "yes"
    assert got["tx_open"] and not got["tx_aborted"]


def test_both_readers_agree_on_a_directory(tmp_path):
    """The same directory, read by each package: the same rows, exactly."""
    import shutil
    root = tmp_path / "written"
    tx = _write_cluster(port_client, TableSchema, root)
    copy = tmp_path / "copy"
    shutil.copytree(root, copy)
    port = _read_cluster(port_client, root, tx)
    ref = _read_cluster(ref_client, copy, tx)
    for key in ("static", "sorted", "select", "dynamic"):
        _rows_equal(port[key], ref[key])
    for key in ("lookup", "queue", "sorted_by", "after_snapshot",
                "tx_open", "tx_aborted"):
        assert port[key] == ref[key], key
