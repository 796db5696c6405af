"""LocalCluster: spin a REAL multi-process cluster on this machine.

The YTInstance pattern (ref yt/python/yt/environment/yt_env.py:179): spawn
actual daemon processes (1 primary + N data nodes) with generated state
dirs, wait for readiness (port files + driver ping + registered node
count), hand out client addresses, tear everything down.

Own copy of the JAX package's `environment/local.py`. It spawns
`python -m ytsaurus_tpu_torch.server.daemon` and passes `device` to the
primary and scheduler roles (`--device`, default cuda): those hold the
card, while the data nodes, clocks and proxies do not. The reference pins
its daemons to the CPU; here nothing is pinned, and a daemon that dies
at start makes `start()` raise with the tail of its `daemon.log`.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.rpc import Channel, RetryingChannel


def _free_port() -> int:
    """A port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class LocalCluster:
    def __init__(self, root_dir: str, n_nodes: int = 2,
                 replication_factor: int = 2, http_proxy: bool = False,
                 n_masters: int = 1, lease_ttl: float = 4.0,
                 kafka_proxy: bool = False, n_clocks: int = 0,
                 scheduler: bool = False, device: str = "cuda"):
        self.root_dir = root_dir
        self.device = str(device)
        self.n_nodes = n_nodes
        self.n_masters = n_masters
        self.n_clocks = n_clocks
        self.with_scheduler = scheduler
        self.scheduler_address: "str | None" = None
        self.lease_ttl = lease_ttl
        self.replication_factor = replication_factor
        self.http_proxy = http_proxy
        if kafka_proxy and n_masters > 1:
            # The kafka listener lives inside master 0; after a failover
            # it would point at a dead process.  Until the proxy follows
            # the leader, refuse the combination rather than serve a
            # port that silently dies.
            raise ValueError("kafka_proxy requires n_masters == 1")
        self.kafka_proxy = kafka_proxy
        self.primary_address: str | None = None
        self.master_addresses: list[str] = []
        self.http_proxy_address: str | None = None
        self.kafka_address: str | None = None
        self.node_addresses: list[str] = []
        self.clock_addresses: list[str] = []
        self._procs: list[subprocess.Popen] = []
        self._logs: dict[int, str] = {}       # pid -> its daemon.log
        # Daemons killed on purpose (fault injection): no startup fault.
        self._killed: set[int] = set()

    # -- lifecycle -------------------------------------------------------------

    def start(self, timeout: float = 120.0) -> "LocalCluster":
        os.makedirs(self.root_dir, exist_ok=True)
        deadline = time.monotonic() + timeout
        election = self.n_masters > 1
        try:
            # Clock peers spawn FIRST and bind port 0 themselves (their
            # RPC surface answers NotClockLeader until the journal plane
            # exists): masters need the clock ADDRESSES at spawn, while
            # the clocks learn the (later) node addresses by polling a
            # journals file — no pre-allocated ports, no bind race.
            clock_procs = self._pending_clock_procs = []
            journals_path = os.path.join(self.root_dir, "journals.txt")
            for c in range(self.n_clocks):
                clock_root = os.path.join(self.root_dir, f"clock{c}")
                self._spawn(f"clock{c}", clock_root, [
                    "--role", "clock", "--root", clock_root,
                    "--journals-file", journals_path,
                    "--master-index", str(c),
                    "--lease-ttl", str(self.lease_ttl)])
                clock_procs.append(self._procs.pop())
            for c in range(self.n_clocks):
                clock_root = os.path.join(self.root_dir, f"clock{c}")
                port = self._wait_port(clock_root, "clock", deadline)
                self.clock_addresses.append(f"127.0.0.1:{port}")
            self._master_args: list[list[str]] = []
            for m in range(self.n_masters):
                name = "primary" if m == 0 else f"primary{m}"
                primary_root = os.path.join(self.root_dir, name)
                args = ["--role", "primary", "--root", primary_root,
                        "--device", self.device,
                        "--replication-factor",
                        str(self.replication_factor),
                        "--journal-nodes", str(min(3, self.n_nodes))]
                if election:
                    args += ["--election", "--master-index", str(m),
                             "--lease-ttl", str(self.lease_ttl)]
                if self.n_clocks:
                    args += ["--clocks", ",".join(self.clock_addresses)]
                if self.kafka_proxy and m == 0:
                    args += ["--kafka"]
                self._master_args.append(args)
                # The master's port is chosen here, so that the nodes
                # start beside it (each daemon spends seconds importing
                # torch) instead of after it; the nodes' heartbeats retry
                # until it serves.
                port = _free_port()
                self._spawn(name, primary_root, args + ["--port", str(port)])
                self.master_addresses.append(f"127.0.0.1:{port}")
            self.primary_address = self.master_addresses[0]
            primaries = ",".join(self.master_addresses)
            for i in range(self.n_nodes):
                node_root = os.path.join(self.root_dir, f"node{i}")
                self._spawn(f"node{i}", node_root,
                            ["--role", "node", "--root", node_root,
                             "--primary", primaries])
            for m in range(self.n_masters):
                name = "primary" if m == 0 else f"primary{m}"
                primary_root = os.path.join(self.root_dir, name)
                port = self._wait_port(primary_root, "primary", deadline)
                if self.master_addresses[m] != f"127.0.0.1:{port}":
                    raise YtError(f"{name} bound port {port}, not the one "
                                  f"it was given ({self.master_addresses[m]})")
            for i in range(self.n_nodes):
                node_root = os.path.join(self.root_dir, f"node{i}")
                port = self._wait_port(node_root, "node", deadline)
                self.node_addresses.append(f"127.0.0.1:{port}")
            if self.kafka_proxy:
                # The kafka listener comes up AFTER the primary's WAL
                # bootstrap, which itself waits for journal NODES to
                # register — so this wait must sit after the node spawn
                # loop, or startup deadlocks until the primary's
                # bootstrap timeout expires (~60s) and it falls back to
                # a local-only WAL.
                primary_root = os.path.join(self.root_dir, "primary")
                port = self._wait_port(primary_root, "kafka", deadline)
                self.kafka_address = f"127.0.0.1:{port}"
            if self.n_clocks:
                # Journal plane is up: hand its addresses to the waiting
                # clock daemons (atomic publish), and restore the
                # masters→nodes→clocks order the index helpers assume.
                tmp = journals_path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(",".join(self.node_addresses))
                os.replace(tmp, journals_path)
                self._procs.extend(clock_procs)
                self._pending_clock_procs = []
            if self.with_scheduler:
                # The operation daemon (scheduler + controller agent
                # split out of the master process).
                sched_root = os.path.join(self.root_dir, "scheduler")
                self._spawn("scheduler", sched_root,
                            self._scheduler_args(sched_root))
                port = self._wait_port(sched_root, "scheduler", deadline)
                self.scheduler_address = f"127.0.0.1:{port}"
            self._wait_ready(deadline)
            if self.http_proxy:
                proxy_root = os.path.join(self.root_dir, "proxy")
                self._spawn("proxy", proxy_root,
                            ["--role", "proxy", "--root", proxy_root,
                             "--primary", self.primary_address])
                port = self._wait_port(proxy_root, "proxy", deadline)
                self.http_proxy_address = f"127.0.0.1:{port}"
        except BaseException:
            # A failed start must not leak daemon processes.
            self.stop()
            raise
        return self

    def _spawn(self, name: str, root: str, args: list[str]) -> None:
        os.makedirs(root, exist_ok=True)
        # Drop stale port files: a restart on the same root must not hand
        # out the previous incarnation's ports.
        for stale in ("primary.port", "node.port", "proxy.port",
                      "clock.port", "scheduler.port"):
            try:
                os.unlink(os.path.join(root, stale))
            except FileNotFoundError:
                pass
        log_path = os.path.join(root, "daemon.log")
        with open(log_path, "ab") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ytsaurus_tpu_torch.server.daemon",
                 *args],
                stdout=log, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__)))))
        self._logs[proc.pid] = log_path
        self._procs.append(proc)

    def _scheduler_args(self, sched_root: str) -> list[str]:
        return ["--role", "scheduler", "--root", sched_root,
                "--device", self.device,
                "--primary", ",".join(self.master_addresses)]

    def _log_tail(self, proc: subprocess.Popen, limit: int = 4000) -> str:
        path = self._logs.get(proc.pid)
        try:
            with open(path, "rb") as f:
                f.seek(max(os.path.getsize(path) - limit, 0))
                return f.read().decode("utf-8", "replace")
        except (OSError, TypeError):
            return ""

    def _wait_port(self, root: str, role: str, deadline: float) -> int:
        path = os.path.join(root, f"{role}.port")
        while time.monotonic() < deadline:
            if os.path.exists(path):
                with open(path) as f:
                    return int(f.read().strip())
            self._check_daemons()
            time.sleep(0.1)
        raise YtError(f"{role} daemon did not bind a port "
                      f"(see {root}/daemon.log)")

    def _wait_ready(self, deadline: float) -> None:
        """Ready = some master is LEADER with every node registered and
        the driver answering (under election the leader may be any
        master)."""
        channels = {addr: RetryingChannel(Channel(addr, timeout=10),
                                          attempts=3, backoff=0.2)
                    for addr in (self.master_addresses or
                                 [self.primary_address])}
        try:
            while time.monotonic() < deadline:
                self._check_daemons()
                for addr, channel in channels.items():
                    try:
                        body, _ = channel.call("node_tracker",
                                               "list_nodes", {})
                        alive = body.get("alive", [])
                        if len(alive) < self._live_node_count():
                            continue
                        # Driver comes up after WAL recovery (on the
                        # leader only); ready means BOTH planes answer.
                        channel.call("driver", "ping", {})
                        return
                    except YtError:
                        continue
                time.sleep(0.2)
            raise YtError(
                f"cluster not ready: {self.n_nodes} nodes expected")
        finally:
            for channel in channels.values():
                channel.close()

    def _live_node_count(self) -> int:
        nodes = self._procs[self.n_masters:self.n_masters + self.n_nodes]
        return self.n_nodes - sum(p.pid in self._killed for p in nodes)

    def _kill(self, proc: subprocess.Popen) -> None:
        proc.kill()
        proc.wait(timeout=10)
        self._killed.add(proc.pid)

    def _check_daemons(self) -> None:
        for proc in self._procs:
            if proc.pid in self._killed:
                continue
            rc = proc.poll()
            if rc is not None:
                raise YtError(
                    f"daemon pid {proc.pid} exited rc={rc} during startup; "
                    f"the tail of {self._logs.get(proc.pid)}:\n"
                    f"{self._log_tail(proc)}")

    def stop(self) -> None:
        # Clock procs not yet folded into _procs (startup failed before
        # the journal plane came up) must not leak.
        doomed = self._procs + list(getattr(self, "_pending_clock_procs",
                                            []) or [])
        for proc in doomed:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in doomed:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        self._procs.clear()
        self._pending_clock_procs = []

    def restart_primary(self, timeout: float = 120.0,
                        index: int = 0) -> None:
        """Stop a master and bring it back on the same state root with
        the SAME flags (recovery-path fault injection: quorum WAL replay
        + snapshot load; under election it rejoins as a candidate).
        The address may change; read `primary_address` afterwards."""
        proc = self._procs[index]
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        self._procs.pop(index)
        deadline = time.monotonic() + timeout
        name = "primary" if index == 0 else f"primary{index}"
        primary_root = os.path.join(self.root_dir, name)
        # Rebind the SAME port: data nodes heartbeat a fixed primary
        # address (stable daemon addresses, as in real deployments).
        old_port = (self.master_addresses[index] if self.master_addresses
                    else self.primary_address).rsplit(":", 1)[1]
        self._spawn(name, primary_root,
                    self._master_args[index] + ["--port", old_port])
        # _spawn appends; keep masters before nodes (kill_node contract).
        self._procs.insert(index, self._procs.pop())
        port = self._wait_port(primary_root, "primary", deadline)
        if self.master_addresses:
            self.master_addresses[index] = f"127.0.0.1:{port}"
        if index == 0:
            self.primary_address = f"127.0.0.1:{port}"
        self._wait_ready(deadline)

    def kill_node(self, index: int) -> None:
        """Hard-kill one data node (fault injection for replica fallback)."""
        # procs[0..n_masters-1] are masters; nodes follow in order.
        self._kill(self._procs[self.n_masters + index])

    def restart_node(self, index: int, timeout: float = 120.0,
                     wait: bool = True) -> None:
        """Bring a data node back on its state root and its port (killing
        it first if it still runs); its chunks and journals come back
        with it, and it re-registers with the primaries. With
        `wait=False` it returns once spawned: a `restart_primary()` right
        after waits for it with the rest (both start at once)."""
        at = self.n_masters + index
        proc = self._procs[at]
        if proc.poll() is None:
            self._kill(proc)
        node_root = os.path.join(self.root_dir, f"node{index}")
        port = self.node_addresses[index].rsplit(":", 1)[1]
        self._spawn(f"node{index}", node_root,
                    ["--role", "node", "--root", node_root,
                     "--primary", ",".join(self.master_addresses),
                     "--port", port])
        self._procs[at] = self._procs.pop()
        if not wait:
            return
        deadline = time.monotonic() + timeout
        self._wait_port(node_root, "node", deadline)
        self._wait_ready(deadline)

    # -- multi-master helpers --------------------------------------------------

    def _poll_leader(self, addresses, proc_offset: int, service: str,
                     method: str, is_leader, timeout: float,
                     what: str) -> int:
        """Shared leader poll for any role: index of the first peer whose
        `service.method` response satisfies is_leader(body)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for i, addr in enumerate(addresses):
                if self._procs[proc_offset + i].poll() is not None:
                    continue
                channel = Channel(addr, timeout=5)
                try:
                    body, _ = channel.call(service, method, {})
                    if is_leader(body):
                        return i
                except YtError:
                    continue
                finally:
                    channel.close()
            time.sleep(0.3)
        raise YtError(f"no {what} reported leadership in time")

    def leader_index(self, timeout: float = 30.0) -> int:
        """Index of the master currently reporting role=leader."""
        def is_leader(body):
            role = body.get("role")
            role = role.decode() if isinstance(role, bytes) else role
            return role == "leader"
        return self._poll_leader(self.master_addresses, 0, "master",
                                 "get_role", is_leader, timeout,
                                 "master")

    def kill_leader(self) -> int:
        """Hard-kill the current leader master; returns its index."""
        m = self.leader_index()
        self._kill(self._procs[m])
        return m

    # -- operation-daemon helpers ----------------------------------------------

    def _scheduler_proc_index(self) -> int:
        if not self.with_scheduler:
            raise YtError("cluster started without scheduler=True")
        return self.n_masters + self.n_nodes + self.n_clocks

    def kill_scheduler(self) -> None:
        """Hard-kill the operation daemon (kill -9 fault injection)."""
        self._kill(self._procs[self._scheduler_proc_index()])

    def restart_scheduler(self, timeout: float = 120.0) -> None:
        """Bring the operation daemon back on the same root: it revives
        orphaned operations from their Cypress records + snapshots."""
        index = self._scheduler_proc_index()
        self._procs.pop(index)
        sched_root = os.path.join(self.root_dir, "scheduler")
        self._spawn("scheduler", sched_root,
                    self._scheduler_args(sched_root))
        self._procs.insert(index, self._procs.pop())
        deadline = time.monotonic() + timeout
        port = self._wait_port(sched_root, "scheduler", deadline)
        self.scheduler_address = f"127.0.0.1:{port}"

    # -- clock-quorum helpers --------------------------------------------------

    def clock_leader_index(self, timeout: float = 30.0) -> int:
        """Index of the clock peer currently leading the quorum."""
        return self._poll_leader(
            self.clock_addresses, self.n_masters + self.n_nodes,
            "clock", "clock_state", lambda body: bool(body.get("leader")),
            timeout, "clock peer")

    def kill_clock_leader(self) -> int:
        """Hard-kill the current clock leader; returns its index."""
        c = self.clock_leader_index()
        self._kill(self._procs[self.n_masters + self.n_nodes + c])
        return c

    def __enter__(self) -> "LocalCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
