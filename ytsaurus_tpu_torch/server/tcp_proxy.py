"""TCP proxy: a leader-following byte router for the native RPC plane.

Ref: yt/yt/server/tcp_proxy — a dumb-but-availability-critical process
that terminates client TCP and splices it to the right backend, so
clients hold ONE stable address while masters fail over behind it.
Routing is per-connection: at accept time the proxy asks each master
for its role (MasterService.get_role) and splices to the current
leader; an established connection pins its backend (mid-stream
re-routing would corrupt request framing), and a failover surfaces as a
reconnect — exactly the contract FailoverChannel/RetryingChannel
already handle client-side.

Own copy of the JAX package's `server/tcp_proxy.py`, which also counts the
bytes it splices each way (`stats["bytes_in"]`: client to backend,
`stats["bytes_out"]`: backend to client).
"""

from __future__ import annotations

import socket
import socketserver
import threading
from typing import Sequence

from ytsaurus_tpu_torch.rpc import Channel
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("tcp_proxy")


class TcpProxy:
    # analyze: allow(failpoint): backend connect failures already count as probe_failures and rotate; tcp-proxy routing tests cover it
    def __init__(self, backends: "Sequence[str]", host: str = "127.0.0.1",
                 port: int = 0, probe_timeout: float = 5.0):
        self.backends = list(backends)
        self.probe_timeout = probe_timeout
        self.stats = {"connections": 0, "routed_to": {}, "probe_failures": 0,
                      "bytes_in": 0, "bytes_out": 0}
        self._stats_lock = threading.Lock()
        proxy = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                upstream = None
                for attempt in range(2):
                    backend = proxy.pick_backend()
                    if backend is None:
                        return          # no live leader: drop, client retries
                    host, bport = backend.rsplit(":", 1)
                    try:
                        upstream = socket.create_connection(
                            (host, int(bport)),
                            timeout=proxy.probe_timeout)
                        break
                    except OSError:
                        # Cached leader died: invalidate and re-probe once.
                        proxy.invalidate_leader()
                        upstream = None
                if upstream is None:
                    return
                # The connect timeout must NOT survive onto the spliced
                # stream: an idle-but-healthy client connection would be
                # torn down at the first recv timeout.
                upstream.settimeout(None)
                proxy.stats["connections"] += 1
                proxy.stats["routed_to"][backend] = \
                    proxy.stats["routed_to"].get(backend, 0) + 1
                _splice(self.request, upstream, proxy._count)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._leader_lock = threading.Lock()
        self._cached_leader: "str | None" = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _count(self, key: str, n: int) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def invalidate_leader(self) -> None:
        with self._leader_lock:
            self._cached_leader = None

    def pick_backend(self) -> "str | None":
        """The current leader among the backends, cached until a connect
        or probe against it fails (per-connection re-probing would stall
        every accept behind a hung master and multiply probe load).  A
        lone backend is assumed leader."""
        if len(self.backends) == 1:
            return self.backends[0]
        with self._leader_lock:
            if self._cached_leader is not None:
                return self._cached_leader
        follower = None
        for address in self.backends:
            ch = Channel(address, timeout=self.probe_timeout)
            try:
                body, _ = ch.call("master", "get_role", {})
                role = body.get("role")
                role = role.decode() if isinstance(role, bytes) else role
                if role == "leader":
                    with self._leader_lock:
                        self._cached_leader = address
                    return address
                follower = follower or address
            except Exception:       # noqa: BLE001 — probe next backend
                self.stats["probe_failures"] += 1
            finally:
                ch.close()
        return follower             # degraded: serve reads off a follower

    def start(self) -> "TcpProxy":
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="tcp-proxy").start()
        logger.info("tcp proxy on %s -> %s", self.address, self.backends)
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def _splice(a: socket.socket, b: socket.socket, count=None) -> None:
    """Bidirectional byte pump until either side closes; `count(key, n)`
    hears of every chunk ("bytes_in": a to b, "bytes_out": b to a)."""
    def pump(src: socket.socket, dst: socket.socket, key: str) -> None:
        try:
            while True:
                data = src.recv(1 << 16)
                if not data:
                    break
                dst.sendall(data)
                if count is not None:
                    count(key, len(data))
        except OSError:
            pass
        finally:
            for sock in (src, dst):
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    t = threading.Thread(target=pump, args=(b, a, "bytes_out"), daemon=True)
    t.start()
    pump(a, b, "bytes_in")
    t.join()
    b.close()
