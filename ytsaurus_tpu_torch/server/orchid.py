"""Orchid: a virtual tree of live daemon state.

Ref shape: library/orchid/orchid_service.h — every daemon exposes a YTree
of live internals (config, sensors, connections, tablet state) served over
RPC and mounted into Cypress so operators browse it with normal tree reads.

Redesign: producers are callables registered at slash-paths; a read walks
the static registry to the deepest matching producer, invokes it ONCE, then
descends into the returned plain dict.  Served two ways: the `orchid` RPC
service (thin client: `client.get_orchid(path)`) and the monitoring HTTP
endpoint (`server/monitoring.py`).

Own copy of the JAX package's `server/orchid.py`. The reference's
`/compile` mount (its compilation observatory) has no counterpart: the
port compiles nothing. A primary daemon mounts `/query/device` instead:
its device and the launch counts of the port's kernels there.
"""

from __future__ import annotations

from typing import Callable

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.rpc.server import Service, rpc_method


def _split(path: str) -> list[str]:
    return [t for t in path.split("/") if t]


class OrchidTree:
    """Registry of live-state producers."""

    def __init__(self):
        self._producers: dict[tuple, Callable[[], object]] = {}

    def register(self, path: str, producer: Callable[[], object]) -> None:
        """Mount a producer at `/a/b`; it returns a plain dict/value each
        read (never cached — Orchid is live state by definition)."""
        self._producers[tuple(_split(path))] = producer

    def register_value(self, path: str, value) -> None:
        self.register(path, lambda: value)

    # -- reads -----------------------------------------------------------------

    def get(self, path: str = "/"):
        tokens = tuple(_split(path))
        # Deepest registered producer that prefixes the path.
        for depth in range(len(tokens), -1, -1):
            producer = self._producers.get(tokens[:depth])
            if producer is not None:
                return _descend(producer(), tokens[depth:], path)
        # No direct producer: synthesize the directory level.
        children = self._level(tokens)
        if children is None:
            raise YtError(f"Orchid has no node {path!r}",
                          code=EErrorCode.ResolveError)
        return {name: "..." for name in children}

    def list(self, path: str = "/") -> list[str]:
        """Child names: structural sub-mounts plus keys of the produced
        value when a producer covers the path."""
        tokens = tuple(_split(path))
        names: set[str] = set()
        structural = False
        for key in self._producers:
            if len(key) > len(tokens) and key[:len(tokens)] == tokens:
                names.add(key[len(tokens)])
                structural = True
        if any(key == tokens[:len(key)] for key in self._producers
               if len(key) <= len(tokens)):
            value = self.get(path)
            if isinstance(value, dict):
                names.update(k.decode() if isinstance(k, bytes) else str(k)
                             for k in value)
            elif not structural:
                raise YtError(f"Orchid node {path!r} is not a map",
                              code=EErrorCode.ResolveError)
        elif not structural and tokens:
            raise YtError(f"Orchid has no node {path!r}",
                          code=EErrorCode.ResolveError)
        return sorted(names)

    def _level(self, tokens: tuple) -> set | None:
        """Child names at a purely-structural level, None if absent."""
        children = set()
        found = False
        for key in self._producers:
            if len(key) > len(tokens) and key[:len(tokens)] == tokens:
                children.add(key[len(tokens)])
                found = True
            elif key == tokens:
                found = True
        return children if found or not tokens else None


def _descend(value, tokens, path: str):
    for token in tokens:
        if isinstance(value, dict):
            if token in value:
                value = value[token]
                continue
            if token.encode() in value:
                value = value[token.encode()]
                continue
        if isinstance(value, (list, tuple)) and token.isdigit() \
                and int(token) < len(value):
            value = value[int(token)]
            continue
        raise YtError(f"Orchid has no node {path!r} (at {token!r})",
                      code=EErrorCode.ResolveError)
    return value


class OrchidService(Service):
    """RPC surface over an OrchidTree."""

    name = "orchid"

    def __init__(self, tree: OrchidTree):
        self.tree = tree

    @rpc_method()
    def get(self, body, attachments):
        return {"value": self.tree.get(body.get("path", "/"))}

    @rpc_method()
    def list(self, body, attachments):
        return {"names": self.tree.list(body.get("path", "/"))}


def default_orchid(config=None) -> OrchidTree:
    """Standard daemon mounts: /config, /monitoring/sensors, /tracing,
    /telemetry (history rings + SLO state), /accounting."""
    from ytsaurus_tpu_torch.utils.profiling import get_registry
    from ytsaurus_tpu_torch.utils.tracing import get_collector

    tree = OrchidTree()
    if config is not None:
        tree.register("/config", lambda: config.to_dict())
    tree.register("/monitoring/sensors", get_registry().collect)
    tree.register("/tracing/recent_spans",
                  lambda: [s.to_dict() for s in
                           get_collector().snapshot()[-64:]])
    # Flight-recorder views: span trees by trace id (what `yt trace`
    # reads over the RPC orchid) + the bounded slow-query log.
    tree.register("/tracing/traces", _traces_producer)
    tree.register("/tracing/slow_queries", _slow_queries_producer)
    # Telemetry plane: the bounded metrics-history rings, the
    # SLO burn-rate state, and per-tenant resource accounting — the RPC
    # twins of the monitoring /metrics/history, /slo, and /accounting
    # endpoints (`yt top` reads /accounting through this orchid).
    tree.register("/telemetry/history", _history_producer)
    tree.register("/telemetry/slo", _slo_producer)
    tree.register("/accounting", _accounting_producer)
    # Workload recorder: the RPC twin of the monitoring /workload
    # endpoint (`yt workload capture` reads it remotely).
    tree.register("/workload", _workload_producer)
    # Mesh execution observatory: the RPC twin of the
    # monitoring /mesh endpoint (`yt mesh top` reads this remotely).
    tree.register("/mesh", _mesh_producer)
    # Continuous queries: live view-daemon state — the RPC
    # twin of the monitoring /views endpoint (`yt view list` could read
    # this remotely when no driver is reachable).
    tree.register("/views", _views_producer)
    # Concurrency sanitizer: the RPC twin of the monitoring
    # /sanitizer endpoint — observed lock-order edges + violation
    # report of the instrumented-lock layer.
    tree.register("/sanitizer", _sanitizer_producer)
    # Serving plane: the RPC twin of the monitoring /serving
    # endpoint — per-gateway fair-share admission + brown-out state
    # (`yt top --by pool` reads the share/use/demand overlay remotely).
    tree.register("/serving", _serving_producer)
    return tree


def _traces_producer() -> dict:
    from ytsaurus_tpu_torch.utils.tracing import all_span_trees
    return all_span_trees()


def _slow_queries_producer() -> list:
    from ytsaurus_tpu_torch.query.profile import get_flight_recorder
    return [p.to_dict(include_rows=False)
            for p in get_flight_recorder().slow_queries()]


def _history_producer() -> dict:
    from ytsaurus_tpu_torch.utils.profiling import get_history
    return get_history().dump()


def _slo_producer() -> dict:
    from ytsaurus_tpu_torch.utils.slo import get_slo_tracker
    return get_slo_tracker().snapshot()


def _accounting_producer() -> dict:
    from ytsaurus_tpu_torch.query.accounting import get_accountant
    return get_accountant().snapshot()


def _workload_producer() -> dict:
    from ytsaurus_tpu_torch.query.workload import get_workload_log
    # limit=0 serves EVERY retained record (the log is bounded by
    # WorkloadConfig.capacity anyway): remote `yt workload capture`
    # reads through here and must not silently truncate the capture.
    return get_workload_log().snapshot(limit=0)


def _mesh_producer() -> dict:
    from ytsaurus_tpu_torch.parallel.mesh_observatory import (
        get_mesh_observatory,
    )
    return get_mesh_observatory().snapshot()


def _views_producer() -> dict:
    from ytsaurus_tpu_torch.server.view_daemon import views_snapshot
    return {"daemons": views_snapshot()}


def _sanitizer_producer() -> dict:
    from ytsaurus_tpu_torch.utils import sanitizers
    return sanitizers.snapshot()


def _serving_producer() -> dict:
    from ytsaurus_tpu_torch.query.serving import serving_snapshot
    return {"gateways": serving_snapshot()}
