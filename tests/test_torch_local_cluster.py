"""The port's multi-process cluster on the CPU: `LocalCluster(root,
device="cpu")` spawns the port's daemons (`python -m
ytsaurus_tpu_torch.server.daemon`), and `connect_remote(address,
device="cpu")` talks to them. The reference's own tests run on it
through `port_twin` (whose shims give `LocalCluster`, `RemoteYtClient`
and `connect_remote` the CPU), each keeping the reference's `slow` mark
where it has one:

- tests/test_multiprocess.py (13): the ten cases on the module's
  cluster, the node-failure read, and the two slow restart cases;
- tests/test_exec_plane.py (2) and test_tcp_proxy.py (2), whole
  (tcp_proxy's `jax.config.update` lines taken out), and the two
  cluster cases of test_chunk_repair.py.

Besides: the JAX package's `RemoteYtClient` and the port's
`connect_remote` read each other's tables, sorts and selects over the
port's cluster (integers exact, doubles under tests/harness.py's
canon); a `--device cuda` primary on a machine without a card exits, so
that `start()` raises with its log's tail; and a primary's `--kafka`
serves and its profiler runs (`test_daemon_refuses_unported_flags`,
whose name is kept from when both were refused).

The scheduler daemon, the election, clock and Sequoia cases and the
daemons without jax are in tests/test_torch_local_cluster_failover.py:
two files keep each under a minute on one worker.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests.harness import _canon_row
from tests.test_torch_client import (
    _CpuLocalCluster,
    call_twin,
    port_twin,
    twin_cases,
)
from ytsaurus_tpu_torch.remote_client import connect_remote

_MP_TWIN = port_twin("test_multiprocess")
_EXEC_TWIN = port_twin("test_exec_plane")
_REPAIR_TWIN = port_twin("test_chunk_repair")
_TCP_TWIN = port_twin("test_tcp_proxy", edits={
    'import jax\n\njax.config.update("jax_platforms", "cpu")\n\n': ""})

# Cases on a module-scoped cluster (the reference's `cluster` fixture).
_MP_SHARED = twin_cases(_MP_TWIN, exclude={
    "test_node_failure_read_fallback",
    "test_primary_restart_recovers_metadata",
    "test_quorum_wal_survives_primary_disk_loss"})


def slow_marked(module, name) -> bool:
    return any(m.name == "slow"
               for m in getattr(getattr(module, name), "pytestmark", []))


def own_cluster_params(picked) -> list:
    """pytest params of (twin module, case) for cases that start their
    own cluster, each with the reference's slow mark."""
    return [pytest.param(module, name,
                         id=f"{module.__name__[len('port_twin_'):]}."
                            f"{name}",
                         marks=[pytest.mark.slow]
                         if slow_marked(module, name) else [])
            for module, name in picked]


_OWN_CASES = own_cluster_params([
    (_MP_TWIN, "test_node_failure_read_fallback"),
    (_MP_TWIN, "test_primary_restart_recovers_metadata"),
    (_MP_TWIN, "test_quorum_wal_survives_primary_disk_loss"),
    *((_EXEC_TWIN, n) for n in twin_cases(_EXEC_TWIN)),
    (_REPAIR_TWIN, "test_dead_node_chunks_re_replicate_without_reads"),
    (_REPAIR_TWIN, "test_scrub_quarantines_and_replicator_heals"),
    *((_TCP_TWIN, n) for n in twin_cases(_TCP_TWIN)),
])


def test_twin_lists_hold_every_reference_cluster_case():
    assert len(_MP_SHARED) == 13 - 3
    assert len(_OWN_CASES) == 3 + 2 + 2 + 2
    assert len([p for p in _OWN_CASES if p.marks]) == 5


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    with _CpuLocalCluster(str(tmp_path_factory.mktemp("mpcluster")),
                          n_nodes=2) as c:
        yield c


@pytest.fixture()
def client(cluster):
    cl = connect_remote(cluster.primary_address, device="cpu")
    yield cl
    cl.close()


@pytest.mark.parametrize("name", _MP_SHARED)
def test_reference_multiprocess_case_on_the_port(name, cluster, client):
    call_twin(_MP_TWIN, name, {"cluster": cluster, "client": client})


@pytest.mark.parametrize("module,name", _OWN_CASES)
def test_reference_cluster_case_on_the_port(module, name, tmp_path):
    call_twin(module, name, {"tmp_path": tmp_path})


# --- across packages -----------------------------------------------------------


def _table(seed: int) -> list:
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(300):
        rows.append({"k": int(rng.integers(-50, 50)), "g": i % 7,
                     "d": None if i % 11 == 0 else float(rng.normal()),
                     "s": f"s{int(rng.integers(0, 20))}",
                     "u": int(rng.integers(0, 1 << 62))})
    return rows


_SELECTS = [
    "k, g, d, s, u FROM [{t}] WHERE k > 0 ORDER BY k, u LIMIT 50",
    "g, sum(k) AS sk, count(*) AS c, max(u) AS mu, sum(d) AS sd "
    "FROM [{t}] GROUP BY g",
    "s, min(d) AS md FROM [{t}] WHERE d > 0.0 GROUP BY s",
]


def _canon(rows: list, ordered: bool = True) -> list:
    out = [_canon_row(r) for r in rows]
    return out if ordered else sorted(out)


def test_reference_and_port_clients_read_each_others_tables(cluster):
    """A table written by the JAX package's RemoteYtClient reads back
    equal through the port's connect_remote, and the other way round:
    rows, remote sorts (each client sorts in its own process) and
    server-side selects."""
    from ytsaurus_tpu.remote_client import connect_remote as ref_connect
    ref = ref_connect(cluster.primary_address)
    port = connect_remote(cluster.primary_address, device="cpu")
    try:
        for writer, reader, path in ((ref, port, "//x/by_ref"),
                                     (port, ref, "//x/by_port")):
            rows = _table(len(path))
            writer.write_table(path, rows)
            assert _canon(reader.read_table(path)) == \
                _canon(writer.read_table(path))
            reader.run_sort(path, path + "_sorted", ["k", "u"])
            writer.run_sort(path, path + "_sorted2", ["k", "u"])
            assert reader.read_table(path + "_sorted") == \
                writer.read_table(path + "_sorted2")
            assert [(r["k"], r["u"]) for r in
                    writer.read_table(path + "_sorted")] == \
                sorted((r["k"], r["u"]) for r in rows)
            for query in _SELECTS:
                q = query.format(t=path + "_sorted")
                ordered = "ORDER BY" in q
                assert _canon(reader.select_rows(q), ordered) == \
                    _canon(writer.select_rows(q), ordered), q
    finally:
        ref.close()
        port.close()


def test_primary_monitoring_rolls_up_the_fleet(cluster):
    """The primary's monitoring server (port in primary.monitoring.port)
    serves /cluster over every daemon registered in discovery's /daemons
    group (the nodes join on their 2 s heartbeat) and /orchid over the
    primary's tree, /query/device included; its device trace refuses on
    the CPU."""
    import json
    import time
    import urllib.request
    with open(os.path.join(cluster.root_dir, "primary",
                           "primary.monitoring.port")) as f:
        base = f"http://127.0.0.1:{int(f.read())}"
    deadline = time.monotonic() + 30
    while True:
        with urllib.request.urlopen(base + "/cluster", timeout=10) as resp:
            fleet = json.loads(resp.read())
        reachable = [m for m in fleet["members"].values() if m["reachable"]]
        roles = sorted(m.get("attributes", {}).get("role", "")
                       for m in reachable)
        if roles.count("node") == 2 or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    assert roles.count("node") == 2 and "primary" in roles, fleet
    with urllib.request.urlopen(base + "/orchid/query/device",
                                timeout=10) as resp:
        assert json.loads(resp.read())["device"] == "cpu"
    # A CPU primary has no device time to trace: both actions refuse.
    from ytsaurus_tpu_torch.errors import EErrorCode, YtError
    client = connect_remote(cluster.primary_address, device="cpu")
    for action in ("start", "stop"):
        with pytest.raises(YtError, match="needs a CUDA device") as info:
            client.get_orchid(f"/query/device/trace/{action}")
        assert info.value.contains(EErrorCode.InvalidConfig)
    client.close()
    with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
        assert resp.read() == b"ok"


def test_cuda_primary_without_a_card_exits_and_start_raises(tmp_path):
    """No fallback: where torch sees no card, a LocalCluster(device="cuda")
    primary exits non-zero before it binds a port, and start() raises
    with the tail of its daemon.log (tests/test_torch_cuda.py hides the
    card to check the same on a machine that has one)."""
    import torch

    from ytsaurus_tpu_torch.environment import LocalCluster
    from ytsaurus_tpu_torch.errors import YtError
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cluster = LocalCluster(str(tmp_path / "c"), n_nodes=0, device="cuda")
    with pytest.raises(YtError) as info:
        cluster.start(timeout=120)
    text = str(info.value)
    assert "exited rc=1" in text and "no CUDA device" in text, text
    assert not (tmp_path / "c" / "primary" / "primary.port").exists()


def test_daemon_refuses_unported_flags(tmp_path, monkeypatch):
    """The flags this test once found refused now work: a primary
    started with `--kafka` serves the Kafka protocol on the port it
    writes to `<root>/kafka.port`, and its continuous profiler runs at
    YT_TPU_PROFILER_INTERVAL (0 turns it off: no /profiler mount);
    `--device` on a role that holds no card is still a usage error."""
    import json
    import socket
    import struct
    import time

    from ytsaurus_tpu_torch.server import kafka_proxy as kp
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(*args, env=None):
        return subprocess.run(
            [sys.executable, "-m", "ytsaurus_tpu_torch.server.daemon",
             *args], capture_output=True, text=True, cwd=repo, timeout=120,
            env={**os.environ, **(env or {})})

    def start(root, env=None):
        proc = subprocess.Popen(
            [sys.executable, "-m", "ytsaurus_tpu_torch.server.daemon",
             "--role", "primary", "--root", root, "--device", "cpu",
             "--journal-nodes", "0", "--kafka"],
            cwd=repo, env={**os.environ, "OMP_NUM_THREADS": "1",
                           **(env or {})},
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 90
        path = os.path.join(root, "kafka.port")
        while not os.path.exists(path):
            assert proc.poll() is None, "the primary exited"
            assert time.monotonic() < deadline, "no kafka.port"
            time.sleep(0.1)
        with open(os.path.join(root, "primary.port")) as f:
            primary = f"127.0.0.1:{f.read().strip()}"
        with open(path) as f:
            return proc, primary, int(f.read().strip())

    for interval, profiled in (("0.05", True), ("0", False)):
        root = str(tmp_path / f"k{interval}")
        proc, primary, kafka_port = start(
            root, {"YT_TPU_PROFILER_INTERVAL": interval})
        try:
            payload = kp.i16(kp.API_VERSIONS) + kp.i16(0) + kp.i32(5) + \
                kp.string("t")
            with socket.create_connection(("127.0.0.1", kafka_port),
                                          timeout=30) as sock:
                sock.sendall(struct.pack(">i", len(payload)) + payload)
                (length,) = struct.unpack(">i", sock.recv(4))
                body = b""
                while len(body) < length:
                    body += sock.recv(length - len(body))
            r = kp.Reader(body)
            assert r.i32() == 5 and r.i16() == 0
            client = connect_remote(primary, device="cpu")
            try:
                mounts = client.get_orchid("/")
                if profiled:
                    time.sleep(0.3)
                    state = client.get_orchid("/profiler")
                    assert state["interval"] == 0.05
                    assert state["total_samples"] > 0
                    assert state["distinct_stacks"] <= 4096
                    assert "spans" in client.get_orchid("/tracing/export")
                else:
                    assert "profiler" not in json.dumps(mounts)
            finally:
                client.close()
        finally:
            proc.kill()
            proc.wait(timeout=30)
    out = run("--role", "node", "--root", str(tmp_path / "n"),
              "--primary", "127.0.0.1:1", "--device", "cuda")
    assert out.returncode == 2 and "--device applies" in out.stderr
