"""The port's quorum WAL, leader election, clock quorum, data-node
services and RPC chunk store against the JAX package's.

Three kinds of case:

- the reference's own tests, run on the port through
  `tests/test_torch_client.py::port_twin`: `test_quorum_wal.py` whole,
  `test_election.py` and `test_clock.py` less the cases that start a
  `LocalCluster` (the daemons, `environment/local.py`, are not ported),
  and `test_invariants.py` whole;
- cross-package quorum runs over 127.0.0.1, both ways round: a port
  `QuorumWal` over three reference `DataNodeService`s and a reference
  `QuorumWal` over three port ones. One seeded script of appends,
  fencing, a lost node and recovery gives the same recovered records,
  epochs and error codes as the same package on both sides;
- `RpcChunkStore` on the CPU: a chunk published through either
  package's store reads back through the other's with equal planes.
"""

import contextlib
import inspect
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_client import call_twin, port_twin, twin_cases
from ytsaurus_tpu import rpc as ref_rpc
from ytsaurus_tpu.chunks.columnar import ColumnarChunk as RefChunk
from ytsaurus_tpu.chunks.store import FsChunkStore as RefFsChunkStore
from ytsaurus_tpu.cypress import quorum as ref_quorum
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu.server import remote_store as ref_remote_store
from ytsaurus_tpu.server import services as ref_services
from ytsaurus_tpu_torch import rpc
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.chunks.store import FsChunkStore
from ytsaurus_tpu_torch.cypress import quorum
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.server import remote_store
from ytsaurus_tpu_torch.server import services

torch.set_num_threads(1)


# --- the reference's tests, on the port --------------------------------------

_QUORUM_TWIN = port_twin("test_quorum_wal")
sys.modules["_port_twin_test_quorum_wal"] = _QUORUM_TWIN
_QUORUM_CASES = twin_cases(_QUORUM_TWIN)


@pytest.mark.parametrize("name", _QUORUM_CASES)
def test_reference_quorum_wal_case_on_the_port(name, tmp_path):
    fixtures = {"tmp_path": tmp_path}
    if "wal3" in inspect.signature(getattr(_QUORUM_TWIN, name)).parameters:
        fixtures["wal3"] = _QUORUM_TWIN.wal3.__wrapped__(tmp_path)
    call_twin(_QUORUM_TWIN, name, fixtures)


# The fake journal channel of the port's twin raises the port's YtError.
_ELECTION_TWIN = port_twin("test_election", edits={
    "from tests.test_quorum_wal import FakeJournalChannel":
        "from _port_twin_test_quorum_wal import FakeJournalChannel"})
# Left out: test_leader_failover_no_acked_write_loss starts a LocalCluster
# of master daemons (environment/local.py is not ported).
_ELECTION_CASES = twin_cases(_ELECTION_TWIN, exclude={
    "test_leader_failover_no_acked_write_loss"})


@pytest.mark.parametrize("name", _ELECTION_CASES)
def test_reference_election_case_on_the_port(name, tmp_path):
    call_twin(_ELECTION_TWIN, name, {"tmp_path": tmp_path})


_CLOCK_TWIN = port_twin("test_clock")
# Left out: the two cases that start a LocalCluster of clock and master
# daemons (environment/local.py and server/daemon.py are not ported).
_CLOCK_CASES = twin_cases(_CLOCK_TWIN, exclude={
    "test_clock_leader_failover_stays_monotone",
    "test_tablet_commits_use_quorum_with_primary_down"})


@pytest.mark.parametrize("name", _CLOCK_CASES)
def test_reference_clock_case_on_the_port(name):
    fixture = _CLOCK_TWIN.fake_clock_server.__wrapped__()
    value = next(fixture)
    try:
        call_twin(_CLOCK_TWIN, name, {"fake_clock_server": value})
    finally:
        with contextlib.suppress(StopIteration):
            next(fixture)


_INVARIANTS_TWIN = port_twin("test_invariants")
_INVARIANTS_CASES = twin_cases(_INVARIANTS_TWIN)


@pytest.mark.parametrize("name", _INVARIANTS_CASES)
def test_reference_invariants_case_on_the_port(name, tmp_path, monkeypatch):
    call_twin(_INVARIANTS_TWIN, name, {"tmp_path": tmp_path,
                                       "monkeypatch": monkeypatch})


def test_twin_case_counts():
    assert (len(_QUORUM_CASES), len(_ELECTION_CASES), len(_CLOCK_CASES),
            len(_INVARIANTS_CASES)) == (25, 3, 3, 7)


# --- the quorum across packages ----------------------------------------------

PACKAGES = {
    "port": {"services": services, "rpc": rpc, "quorum": quorum,
             "store": FsChunkStore, "error": YtError},
    "ref": {"services": ref_services, "rpc": ref_rpc, "quorum": ref_quorum,
            "store": RefFsChunkStore, "error": RefYtError},
}


def _records(seed: int, n: int, tag: str) -> list:
    """Seeded mutation records: ints at both ends of int64, bytes that are
    not UTF-8, text, doubles, nested dicts and lists."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({
            "op": f"{tag}-{i}",
            "args": {"n": int(rng.integers(-2**63, 2**63 - 1)),
                     "blob": bytes(rng.integers(0, 256, 5, dtype=np.uint8)),
                     "x": float(rng.standard_normal()),
                     "path": f"//t/{tag}/{i}",
                     "nested": {"list": [int(v) for v in
                                         rng.integers(0, 9, 3)],
                                "flag": bool(i % 2)}},
        })
    return out


class _Nodes:
    """Three data nodes of one package on 127.0.0.1, each with a chunk
    location and a journal directory of its own."""

    def __init__(self, package: str, root):
        self.pkg = PACKAGES[package]
        self.root = root
        self.servers = [None, None, None]
        self.services = [None, None, None]
        self.last_addresses = [None, None, None]
        for i in range(3):
            self.start(i)

    def start(self, i: int) -> None:
        svc = self.pkg["services"].DataNodeService(
            self.pkg["store"](str(self.root / f"loc{i}")),
            str(self.root / f"journal{i}"))
        server = self.pkg["rpc"].RpcServer([svc], port=0)
        server.start()
        self.servers[i], self.services[i] = server, svc
        self.last_addresses[i] = server.address

    def stop(self, i: int) -> None:
        if self.servers[i] is not None:
            self.servers[i].stop()
            self.servers[i] = None

    def addresses(self) -> list:
        """Each node's address; a stopped node keeps its last one."""
        return list(self.last_addresses)

    def close(self) -> None:
        for i in range(3):
            self.stop(i)


def _wal(writer: str, local_path, addresses, **kw):
    pkg = PACKAGES[writer]
    rpc = pkg["rpc"]
    channels = [rpc.RetryingChannel(rpc.Channel(a, timeout=10), attempts=2,
                                    backoff=0.05) for a in addresses]
    return pkg["quorum"].QuorumWal(str(local_path), "master_wal", channels,
                                   quorum=2, count_local_ack=False, **kw)


def _code(writer: str, fn) -> int:
    try:
        fn()
    except PACKAGES[writer]["error"] as err:
        return int(err.code)
    raise AssertionError("no error raised")


def _quorum_script(writer: str, nodes_pkg: str, root) -> dict:
    """Appends, a fencing takeover, a lost node, a quorum loss and a
    recovery on fresh local paths; everything observable is returned."""
    nodes = _Nodes(nodes_pkg, root)
    out = {}
    try:
        a = _wal(writer, root / "a.log", nodes.addresses(),
                 bootstrap_from_local=True)
        out["a_recovered"] = a.recover()
        out["a_epoch"] = a.epoch
        for record in _records(1, 12, "a"):
            a.append(record)
        b = _wal(writer, root / "b.log", nodes.addresses())
        out["b_recovered"] = b.recover()
        out["b_epoch"] = b.epoch
        for record in _records(2, 8, "b"):
            b.append(record)
        # The takeover has written: the old writer is fenced for good (a
        # bare fence with no records would be an orphan it re-acquires).
        out["fenced"] = _code(writer, lambda: a.append({"op": "late"}))
        b.store_snapshot(7, b"snapshot-\x00\xff")
        nodes.stop(2)
        for record in _records(3, 8, "c"):
            b.append(record)
        nodes.stop(1)
        out["below_quorum"] = _code(
            writer, lambda: b.append({"op": "unacked", "$qe": b.epoch}))
        b.close()
        a.close()
        nodes.start(1)
        nodes.start(2)
        c = _wal(writer, root / "c.log", nodes.addresses())
        out["c_recovered"] = c.recover()
        out["c_epoch"] = c.epoch
        out["snapshot"] = c.fetch_snapshot()
        rpc = PACKAGES[writer]["rpc"]
        out["counts"] = [
            rpc.Channel(addr, timeout=10).call(
                "data_node", "journal_count", {"journal": "master_wal"})[0]
            for addr in nodes.addresses()]
        c.close()
    finally:
        nodes.close()
    return out


@pytest.mark.parametrize("writer,nodes_pkg", [("port", "ref"),
                                              ("ref", "port")])
def test_quorum_across_packages_recovers_the_same_log(writer, nodes_pkg,
                                                      tmp_path):
    """A WAL of one package over the data nodes of the other recovers the
    records, epochs and error codes the same package gives on both sides,
    both ways round."""
    got = _quorum_script(writer, nodes_pkg, tmp_path / "mixed")
    same = _quorum_script(writer, writer, tmp_path / "same")
    assert got == same
    from ytsaurus_tpu_torch.errors import EErrorCode
    assert got["fenced"] == EErrorCode.JournalEpochFenced
    assert got["below_quorum"] == EErrorCode.PeerUnavailable
    assert (got["a_epoch"], got["b_epoch"]) == (1, 2)
    assert got["c_epoch"] == 3
    expected = _records(1, 12, "a") + _records(2, 8, "b") + \
        _records(3, 8, "c")
    recovered = got["c_recovered"]
    # Every acknowledged record, epoch-tagged, then the unacknowledged
    # tail of the newest epoch that the one surviving voter held.
    assert [{k: v for k, v in r.items() if k != quorum.EPOCH_KEY}
            for r in recovered[:28]] == expected
    assert [quorum.record_epoch(r) for r in recovered] == \
        [1] * 12 + [2] * 17
    assert recovered[28]["op"] == "unacked"
    assert got["snapshot"] == (7, b"snapshot-\x00\xff")
    assert [c["count"] for c in got["counts"]] == [29, 29, 29]


def test_quorum_across_packages_port_and_reference_agree(tmp_path):
    """The port's writer over the port's nodes gives what the reference's
    writer gives over the reference's."""
    assert _quorum_script("port", "port", tmp_path / "p") == \
        _quorum_script("ref", "ref", tmp_path / "r")


# --- the RPC chunk store across packages -------------------------------------

SPEC = [("k", "int64", "ascending"), ("g", "string"), ("v", "double"),
        ("u", "uint64"), ("b", "boolean")]


def _rows(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        rows.append((i, None if i % 7 == 0 else f"g{rng.integers(0, 5)}",
                     float(rng.standard_normal()),
                     int(rng.integers(0, 2**63)) * 2 + 1, bool(i % 3)))
    return rows


@pytest.mark.parametrize("nodes_pkg", ["port", "ref"])
def test_rpc_chunk_store_reads_across_packages(nodes_pkg, tmp_path):
    from tests.test_torch_sort import _planes_equal

    nodes = _Nodes(nodes_pkg, tmp_path)
    try:
        port_store = remote_store.RpcChunkStore(nodes.addresses,
                                                replication_factor=2)
        ref_store = ref_remote_store.RpcChunkStore(nodes.addresses,
                                                   replication_factor=2)
        rows = _rows(4, 300)
        ref_chunk = RefChunk.from_rows(RefSchema.make(SPEC), rows)
        port_chunk = ColumnarChunk.from_rows(TableSchema.make(SPEC), rows,
                                             device="cpu")
        port_id = port_store.write_chunk(port_chunk)
        ref_id = ref_store.write_chunk(ref_chunk)
        # Placement is the same rendezvous hash in both packages.
        assert remote_store.placement_rank(port_id, nodes.addresses()) == \
            ref_remote_store.placement_rank(port_id, nodes.addresses())
        holders = [i for i, svc in enumerate(nodes.services)
                   if svc.store.exists(port_id)]
        assert len(holders) == 2
        # Each package's chunk read back through the other's store.
        got = port_store.read_chunk(ref_id, device="cpu")
        assert got.device == torch.device("cpu")
        _planes_equal(got, ref_store.read_chunk(ref_id))
        _planes_equal(port_store.read_chunk(port_id, device="cpu"),
                      ref_store.read_chunk(port_id))
        assert port_store.get_blob(port_id) == ref_store.get_blob(port_id)
        assert port_store.read_stats(port_id) == \
            ref_store.read_stats(port_id)
        assert sorted(port_store.list_chunks()) == \
            sorted(ref_store.list_chunks()) == sorted([port_id, ref_id])
        # A lost holder: the read falls back to the other replica.
        nodes.stop(holders[0])
        port_store._nodes_cache = None
        _planes_equal(port_store.read_chunk(port_id, device="cpu"),
                      ref_chunk)
        port_store.remove_chunk(ref_id)
        assert not ref_store.exists(ref_id)
        port_store.close()
        ref_store.close()
    finally:
        nodes.close()


# --- the data node's services across packages --------------------------------

def _plain(value):
    """Wire answers with text as str and lease clocks dropped."""
    if isinstance(value, bytes):
        return value.decode()
    if isinstance(value, dict):
        return {_plain(k): _plain(v) for k, v in value.items()
                if k != "remaining"}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


def _data_node_script(nodes_pkg: str, root) -> list:
    """Journals (acquisition, leases, membership, position, divergence and
    fencing errors, reset, snapshots), chunks (put, get, list, scrub of a
    damaged copy, replication to a peer, remove), the master's role probe
    and the node tracker, called over RPC through the port's channel."""
    pkg = PACKAGES[nodes_pkg]
    nodes = _Nodes(nodes_pkg, root)
    tracker = pkg["services"].NodeTracker()
    role = {"value": "leader"}
    extra = pkg["rpc"].RpcServer([pkg["services"].NodeTrackerService(
        tracker), pkg["services"].MasterService(role)], port=0)
    extra.start()
    out = []
    try:
        a, b = (rpc.Channel(addr, timeout=10)
                for addr in nodes.addresses()[:2])

        def call(channel, method, body, attachments=(), service="data_node"):
            try:
                got, parts = channel.call(service, method, body,
                                          list(attachments))
                out.append((method, _plain(got), list(parts)))
            except YtError as err:
                out.append((method, "error", int(err.code)))

        j = {"journal": "j"}
        call(a, "journal_acquire", {**j, "epoch": 1, "writer": "w1",
                                    "lease_ttl": 30.0})
        call(a, "journal_acquire", {**j, "epoch": 2, "writer": "w2"})
        call(a, "journal_lease", j)
        call(a, "journal_lease_renew", {**j, "epoch": 1, "writer": "w1",
                                        "ttl": 30.0})
        call(a, "journal_lease_renew", {**j, "epoch": 3, "writer": "w3",
                                        "ttl": 30.0})
        call(a, "journal_membership_put", {**j, "epoch": 1, "writer": "w1",
                                           "member_ids": ["n0", "n1"]})
        call(a, "journal_membership_get", j)
        call(a, "journal_read", j)
        recs = [{"op": "a", "$qe": 1}, {"op": "b", "$qe": 1}]
        call(a, "journal_append", {**j, "records": recs, "position": 0,
                                   "prev_epoch": 0, "epoch": 1,
                                   "writer": "w1"})
        call(a, "journal_append", {**j, "records": recs, "position": 5,
                                   "prev_epoch": 1, "epoch": 1,
                                   "writer": "w1"})
        call(a, "journal_append", {**j, "records": recs, "position": 2,
                                   "prev_epoch": 7, "epoch": 1,
                                   "writer": "w1"})
        call(a, "journal_append", {**j, "records": recs, "position": 2,
                                   "prev_epoch": 1, "epoch": 1,
                                   "writer": "intruder"})
        call(a, "journal_count", j)
        call(a, "journal_epoch", j)
        call(a, "journal_read", j)
        call(a, "journal_reset", {**j, "epoch": 0, "writer": "old"})
        call(a, "snapshot_put", {"name": "j", "seq": 4, "epoch": 1,
                                 "writer": "w1"}, [b"snap\x00"])
        call(a, "snapshot_get", {"name": "j"})
        call(a, "journal_reset", {**j, "epoch": 1, "writer": "w1"})
        call(a, "journal_count", j)
        call(a, "journal_acquire", {**j, "epoch": 0, "writer": "w0"})
        call(a, "journal_read", {"journal": "../x"})
        # The same chunk bytes in both runs: the reference's writer.
        src = RefFsChunkStore(str(root / "src"))
        blobs = []
        for seed in (1, 2):
            chunk = RefChunk.from_rows(RefSchema.make(SPEC), _rows(seed, 50))
            cid = src.write_chunk(chunk, chunk_id=f"{seed:032x}")
            blobs.append((cid, src.get_blob(cid)))
        for cid, blob in blobs:
            call(a, "put_chunk", {"chunk_id": cid}, [blob])
        call(a, "has_chunk", {"chunk_id": blobs[0][0]})
        call(a, "list_chunks", {})
        call(a, "get_chunk", {"chunk_id": blobs[1][0]})
        damaged = nodes.services[0].store._path(blobs[1][0])
        with open(damaged, "r+b") as f:
            f.truncate(len(blobs[1][1]) // 2)
        call(a, "scrub_chunks", {})
        call(a, "list_chunks", {})
        call(a, "replicate_chunk", {"chunk_id": blobs[0][0],
                                    "target": nodes.addresses()[1]})
        call(b, "has_chunk", {"chunk_id": blobs[0][0]})
        call(a, "remove_chunk", {"chunk_id": blobs[0][0]})
        call(a, "has_chunk", {"chunk_id": blobs[0][0]})
        call(a, "get_chunk", {"chunk_id": "f" * 32})
        ctl = rpc.Channel(extra.address, timeout=10)
        call(ctl, "get_role", {}, service="master")
        call(ctl, "heartbeat", {"id": "n0", "address": "h:1"},
             service="node_tracker")
        call(ctl, "heartbeat", {"address": "h:2"}, service="node_tracker")
        call(ctl, "list_nodes", {}, service="node_tracker")
        for channel in (a, b, ctl):
            channel.close()
    finally:
        extra.stop()
        nodes.close()
    return out


def test_data_node_services_answer_as_the_reference(tmp_path):
    port = _data_node_script("port", tmp_path / "port")
    ref = _data_node_script("ref", tmp_path / "ref")
    assert port == ref
    codes = [entry[2] for entry in port if entry[1] == "error"]
    from ytsaurus_tpu_torch.errors import EErrorCode
    assert EErrorCode.JournalPositionMismatch in codes
    assert EErrorCode.JournalDivergence in codes
    assert EErrorCode.JournalEpochFenced in codes
    (scrub,) = [entry for entry in port if entry[0] == "scrub_chunks"]
    assert scrub == ("scrub_chunks", {"checked": 2, "corrupt": [
        "0" * 31 + "2"]}, []), scrub


# --- the clock quorum as a cluster's clock -----------------------------------

def test_a_cluster_on_the_clock_quorum_reads_its_commits_after_a_restart(
        tmp_path):
    """The hybrid clock's restart fault (a reopened cluster's in-process
    clock restarts from the wall clock's second) does not show on a
    cluster whose timestamps come from the clock quorum: reopened in the
    same second, with the clock leader killed in between, it reads every
    committed row, and every timestamp rises."""
    from ytsaurus_tpu_torch.client import connect
    from ytsaurus_tpu_torch.tablet.clock import (
        ClockServer,
        ClockService,
        QuorumTimestampProvider,
    )

    nodes = _Nodes("port", tmp_path / "nodes")
    peers, servers = [], []
    try:
        for i in range(2):
            peer = ClockServer(str(tmp_path / f"clock{i}"),
                               [rpc.Channel(a, timeout=10)
                                for a in nodes.addresses()],
                               index=i, lease_ttl=1.0).start()
            server = rpc.RpcServer([ClockService(peer)], port=0)
            server.start()
            peers.append(peer)
            servers.append(server)
        provider = QuorumTimestampProvider([s.address for s in servers],
                                           failover_deadline=30.0)
        schema = TableSchema.make([("k", "int64", "ascending"),
                                   ("v", "int64")], unique_keys=True)
        root = str(tmp_path / "cluster")
        client = connect(root, device="cpu")
        client.cluster.transactions.timestamps = provider
        client.create("table", "//t", attributes={"schema": schema,
                                                  "dynamic": True})
        client.mount_table("//t")
        commits = []
        for lo in range(0, 60, 20):
            tx = client.start_transaction()
            client.insert_rows("//t", [{"k": k, "v": k * k}
                                       for k in range(lo, lo + 20)], tx=tx)
            commits.append(client.commit_transaction(tx))
        client.unmount_table("//t")
        leader = next(i for i, p in enumerate(peers) if p.is_leader)
        servers.pop(leader).stop()
        peers.pop(leader).stop()
        reopened = connect(root, fresh=True, device="cpu")
        reopened.cluster.transactions.timestamps = provider
        reopened.mount_table("//t")
        rows = reopened.select_rows("k, v FROM [//t] ORDER BY k LIMIT 1000")
        assert [(r["k"], r["v"]) for r in rows] == \
            [(k, k * k) for k in range(60)]
        tx = reopened.start_transaction()
        assert tx.start_timestamp > commits[-1]
        assert commits == sorted(set(commits))
        provider.close()
    finally:
        for peer, server in zip(peers, servers):
            server.stop()
            peer.stop()
        nodes.close()


def test_publish_writes_chunks_concurrently_through_the_rpc_store(tmp_path):
    """publish_table_chunks writes a table's chunks from several threads:
    under a short switch interval every chunk lands on 2 nodes in the
    table's order, and the store keeps one channel per node."""
    from ytsaurus_tpu_torch.client import (
        YtClient,
        YtCluster,
        publish_table_chunks,
    )

    nodes = _Nodes("port", tmp_path / "nodes")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        store = remote_store.RpcChunkStore(nodes.addresses)
        client = YtClient(YtCluster(str(tmp_path / "c"), chunk_store=store,
                                    device="cpu"))
        schema = TableSchema.make(SPEC)
        parts = [_rows(seed, 40) for seed in range(12)]
        chunks = [ColumnarChunk.from_rows(schema, rows, device="cpu")
                  for rows in parts]
        client.create("table", "//t", attributes={"schema": schema})
        publish_table_chunks(client, store, "//t", chunks, schema=schema)
        ids = client.get("//t/@chunk_ids")
        assert len(ids) == len(set(ids)) == 12
        assert [sum(svc.store.exists(cid) for svc in nodes.services)
                for cid in ids] == [2] * 12
        assert sorted(store._channels) == sorted(nodes.addresses())
        assert [tuple(_plain(v) for v in r.values())
                for r in client.read_table("//t")] == \
            [row for rows in parts for row in rows]
        assert client.get("//t/@row_count") == 480
        store.close()
    finally:
        sys.setswitchinterval(interval)
        nodes.close()
