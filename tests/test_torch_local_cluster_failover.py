"""The port's multi-process cluster on the CPU, part two (part one,
with the module docstring on `LocalCluster(device="cpu")` and the
shims, is tests/test_torch_local_cluster.py): the operation daemon, the
failover cases and every daemon role with jax blocked. Twins, each
keeping the reference's `slow` mark where it has one:

- tests/test_scheduler_daemon.py (5), whole, on a module-scoped cluster
  with the scheduler daemon (its kill -9 case revives the operation in
  a restarted daemon);
- `test_election.py::test_leader_failover_no_acked_write_loss` (slow),
  the two `LocalCluster` cases of test_clock.py and
  `test_sequoia.py::test_multiprocess_randomized_workload_stays_consistent`.

Besides: every daemon role serves with `jax` and `ytsaurus_tpu` blocked
in its interpreter.
"""

import os
import subprocess
import sys
import time
import urllib.request

import pytest

from tests.test_torch_client import (
    _CpuLocalCluster,
    call_twin,
    port_twin,
    twin_cases,
)
from tests.test_torch_local_cluster import own_cluster_params, slow_marked
from ytsaurus_tpu_torch.remote_client import connect_remote
from ytsaurus_tpu_torch.rpc import Channel
from ytsaurus_tpu_torch.server.scheduler_daemon import SchedulerClient

_SCHED_TWIN = port_twin("test_scheduler_daemon")
_SCHED_CASES = twin_cases(_SCHED_TWIN)
_ELECTION_TWIN = port_twin("test_election")
_CLOCK_TWIN = port_twin("test_clock")
_SEQUOIA_TWIN = port_twin("test_sequoia")

_OWN_CASES = own_cluster_params([
    (_ELECTION_TWIN, "test_leader_failover_no_acked_write_loss"),
    (_CLOCK_TWIN, "test_clock_leader_failover_stays_monotone"),
    (_CLOCK_TWIN, "test_tablet_commits_use_quorum_with_primary_down"),
    (_SEQUOIA_TWIN,
     "test_multiprocess_randomized_workload_stays_consistent"),
])


def test_twin_lists_hold_every_reference_cluster_case():
    assert len(_SCHED_CASES) == 5
    assert len(_OWN_CASES) == 1 + 2 + 1
    assert len([p for p in _OWN_CASES if p.marks]) == 2


@pytest.fixture(scope="module")
def sched_cluster(tmp_path_factory):
    with _CpuLocalCluster(str(tmp_path_factory.mktemp("sched")),
                          n_nodes=2, scheduler=True) as c:
        yield c


@pytest.fixture()
def clients(sched_cluster):
    data = connect_remote(sched_cluster.primary_address, device="cpu")
    ops = SchedulerClient(sched_cluster.scheduler_address)
    yield data, ops
    ops.close()
    data.close()


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=[pytest.mark.slow]
                 if slow_marked(_SCHED_TWIN, n) else [])
    for n in _SCHED_CASES])
def test_reference_scheduler_daemon_case_on_the_port(name, sched_cluster,
                                                     clients):
    call_twin(_SCHED_TWIN, name, {"cluster": sched_cluster,
                                  "clients": clients})


@pytest.mark.parametrize("module,name", _OWN_CASES)
def test_reference_cluster_case_on_the_port(module, name, tmp_path,
                                            monkeypatch):
    call_twin(module, name, {"tmp_path": tmp_path,
                             "monkeypatch": monkeypatch})


# --- the daemons without jax ---------------------------------------------------


_BLOCKER = """\
import sys
sys.modules["jax"] = None
sys.modules["ytsaurus_tpu"] = None
"""


def _spawn_role(root, role: str, primary: str, env: dict):
    os.makedirs(root, exist_ok=True)
    log = open(os.path.join(root, "daemon.log"), "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ytsaurus_tpu_torch.server.daemon",
         "--role", role, "--root", str(root), "--primary", primary],
        stdout=log, stderr=subprocess.STDOUT, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    log.close()
    path = os.path.join(root, f"{role}.port")
    deadline = time.monotonic() + 60
    while not os.path.exists(path):
        assert proc.poll() is None, open(
            os.path.join(root, "daemon.log")).read()[-3000:]
        assert time.monotonic() < deadline, role
        time.sleep(0.1)
    with open(path) as f:
        return proc, f"127.0.0.1:{int(f.read())}"


def test_daemons_serve_with_jax_and_the_jax_package_blocked(tmp_path,
                                                            monkeypatch):
    """Every role of the port's daemon runs in an interpreter where
    `import jax` and `import ytsaurus_tpu` fail (a sitecustomize blocks
    both): primary, node, clock, scheduler and the HTTP proxy through
    LocalCluster, the TCP proxy and the master cache spawned here; each
    answers a request."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCKER)
    path = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", f"{site}:{path}" if path else str(site))
    extra = []
    with _CpuLocalCluster(str(tmp_path / "c"), n_nodes=1,
                          replication_factor=1, n_clocks=1,
                          scheduler=True, http_proxy=True) as cluster:
        try:
            client = connect_remote(cluster.primary_address, device="cpu")
            client.write_table("//b/t", [{"k": i} for i in range(20)])
            assert client.select_rows(
                "sum(k) AS s FROM [//b/t] GROUP BY 1 AS o") == \
                [{"s": 190}]
            device = client.get_orchid("/query/device")
            assert device["device"] == "cpu"
            ops = SchedulerClient(cluster.scheduler_address)
            op = ops.wait_operation(ops.run_map("cat", "//b/t", "//b/m"),
                                    timeout=120)
            assert op["state"] == "completed"
            ops.close()
            from ytsaurus_tpu_torch.tablet.clock import (
                QuorumTimestampProvider,
            )
            provider = QuorumTimestampProvider(cluster.clock_addresses,
                                               failover_deadline=60.0)
            stamps = provider.generate_batch(10)
            assert stamps == sorted(set(stamps))
            provider.close()
            with urllib.request.urlopen(
                    f"http://{cluster.http_proxy_address}/api/v4/get"
                    f"?path=//b/t/@row_count", timeout=30) as resp:
                assert b"20" in resp.read()
            env = dict(os.environ)
            tcp, tcp_address = _spawn_role(tmp_path / "tcp", "tcp_proxy",
                                           cluster.primary_address, env)
            extra.append(tcp)
            via = connect_remote(tcp_address, device="cpu")
            assert via.get("//b/t/@row_count") == 20
            via.close()
            cache, cache_address = _spawn_role(
                tmp_path / "cache", "master_cache",
                cluster.primary_address, env)
            extra.append(cache)
            channel = Channel(cache_address, timeout=30)
            body, _ = channel.call("driver", "execute", {
                "command": "get", "parameters": {"path": "//b/t/@row_count"},
                "user": "root"})
            channel.close()
            assert body["result"] == 20
            client.close()
        finally:
            for proc in extra:
                proc.kill()
                proc.wait(timeout=10)
    for log in (tmp_path / "c").rglob("daemon.log"):
        text = log.read_text()
        assert "ImportError" not in text and "Traceback" not in text, text
