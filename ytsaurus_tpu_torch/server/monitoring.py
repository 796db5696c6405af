"""Monitoring HTTP endpoint: /metrics (Prometheus), /metrics/history
(bounded time-series rings), /accounting (per-tenant usage), /slo
(burn-rate alerts), /cluster (fleet roll-up), /orchid/..., /healthz,
/traces (query flight recorder).

Ref shape: library/profiling/solomon/exporter.h:25 — every daemon hosts a
pull endpoint the monitoring system scrapes; Orchid doubles as the
human-readable live-state browser.  stdlib http.server on a daemon thread
is plenty: scrape traffic is tiny and the handlers only read in-process
state.  The one outbound path is `/cluster`: the PRIMARY's monitoring
server scrapes every DiscoveryTracker-registered daemon's `/telemetry`
endpoint and serves the fleet view (member telemetry + merged alerts +
summed accounting).

Own copy of the JAX package's `server/monitoring.py`. Its `/compile`
(compilation observatory) and `/tiers` (the tier ladder) endpoints have
no counterpart, as the port compiles nothing; they answer 404 like any
unknown path.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.server.orchid import OrchidTree
from ytsaurus_tpu_torch.utils.profiling import (
    MetricsHistory,
    ProfilerRegistry,
    get_history,
    get_registry,
)


class MonitoringServer:
    # Per-member scrape budget for the /cluster roll-up.
    CLUSTER_SCRAPE_TIMEOUT = 2.0

    def __init__(self, orchid: Optional[OrchidTree] = None,
                 registry: Optional[ProfilerRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 history: Optional[MetricsHistory] = None,
                 slo_tracker=None, accountant=None,
                 cluster_members: Optional[Callable[[], list]] = None):
        self.orchid = orchid or OrchidTree()
        self.registry = registry or get_registry()
        self._history = history
        self._slo_tracker = slo_tracker
        self._accountant = accountant
        # Fleet membership provider (primary only): () -> [{"id",
        # "address", "attributes"}] of every /daemons-registered member;
        # None serves /cluster over this process alone.
        self.cluster_members = cluster_members
        # Per-replica /serving scope: when several serving
        # replicas share one process (bench/test harnesses), each
        # replica's endpoint must report ITS gateway only or the
        # ReplicaRouter would see every replica's load on every scrape.
        # None keeps the default: every live gateway in the process.
        self.serving_gateways: Optional[list] = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):      # silence stderr chatter
                pass

            def do_GET(self):
                try:
                    outer._handle(self)
                except (ConnectionError, BrokenPipeError):
                    pass
                except Exception as exc:   # noqa: BLE001 — one bad orchid
                    # producer must yield a diagnosable 500, not a dropped
                    # connection.
                    try:
                        outer._reply(self, 500, repr(exc).encode(),
                                     "text/plain")
                    except (ConnectionError, BrokenPipeError):
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.host = host
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="monitoring-http")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- telemetry-plane data sources (overridable per server in tests) --------

    @property
    def history(self) -> MetricsHistory:
        return self._history if self._history is not None \
            else get_history()

    @property
    def slo_tracker(self):
        if self._slo_tracker is not None:
            return self._slo_tracker
        from ytsaurus_tpu_torch.utils.slo import get_slo_tracker
        return get_slo_tracker()

    @property
    def accountant(self):
        if self._accountant is not None:
            return self._accountant
        from ytsaurus_tpu_torch.query.accounting import get_accountant
        return get_accountant()

    # -- request handling ------------------------------------------------------

    def _handle(self, request) -> None:
        path, _, query_string = request.path.partition("?")
        params = {k: v[-1] for k, v in
                  urllib.parse.parse_qs(query_string).items()}
        if path == "/healthz":
            self._reply(request, 200, b"ok", "text/plain")
        elif path == "/failpoints":
            # Fault-injection observability (utils/failpoints.py): the
            # active schedule + cumulative per-site hit/trigger counters
            # (triggers also mirror into /metrics as failpoints_*).
            from ytsaurus_tpu_torch.utils import failpoints
            body = json.dumps({
                "active_spec": failpoints.active_spec(),
                "schedule": failpoints.schedule_snapshot(),
                "sites": failpoints.counters(),
            }, indent=2).encode()
            self._reply(request, 200, body, "application/json")
        elif path == "/sanitizer":
            # Concurrency sanitizer: the bounded live report
            # of the instrumented-lock layer — observed acquisition
            # edges, lock-order inversions, hold-budget violations, and
            # blocking ops under hot locks (counters mirror on /metrics
            # as sanitizer_*).  {"enabled": false} when the sanitizer
            # is off (the production default).
            from ytsaurus_tpu_torch.utils import sanitizers
            body = json.dumps(sanitizers.snapshot(), indent=2,
                              default=_json_default).encode()
            self._reply(request, 200, body, "application/json")
        elif path == "/serving":
            # Query serving plane (query/serving.py): per-pool admission
            # state + lookup batching counters of every live gateway in
            # this process (histograms export via /metrics serving_*).
            from ytsaurus_tpu_torch.query.serving import serving_snapshot
            if self.serving_gateways is not None:
                gateways = [g.snapshot() for g in self.serving_gateways]
            else:
                gateways = serving_snapshot()
            body = json.dumps({"gateways": gateways},
                              indent=2).encode()
            self._reply(request, 200, body, "application/json")
        elif path == "/views":
            # Continuous-query plane: every live view
            # daemon's registry walk — per-view cursor offset, lag,
            # freshness, pause state, and daemon roll-ups (the raw
            # sensors also render on /metrics as views_*).
            from ytsaurus_tpu_torch.server.view_daemon import views_snapshot
            body = json.dumps({"daemons": views_snapshot()},
                              indent=2, default=_json_default).encode()
            self._reply(request, 200, body, "application/json")
        elif path == "/tablet":
            # Tablet read-path caches (tablet/tablet.py): process-wide
            # snapshot-cache hit/miss/evict counters + bytes pinned
            # (the raw sensors also render on /metrics as
            # tablet_snapshot_cache_*).
            from ytsaurus_tpu_torch.tablet.tablet import snapshot_cache_stats
            body = json.dumps({"snapshot_cache": snapshot_cache_stats()},
                              indent=2).encode()
            self._reply(request, 200, body, "application/json")
        elif path == "/traces" or path.startswith("/traces/"):
            # Query flight recorder: the listing serves recent
            # trace summaries + the bounded slow-query/recent profile
            # logs; /traces/<trace_id> renders that trace's span tree.
            from ytsaurus_tpu_torch.query.profile import get_flight_recorder
            from ytsaurus_tpu_torch.utils.tracing import span_tree, trace_summaries
            if path == "/traces":
                body = json.dumps({
                    "recent_traces": trace_summaries(),
                    **get_flight_recorder().snapshot(),
                }, indent=2, default=_json_default).encode()
                self._reply(request, 200, body, "application/json")
            else:
                trace_id = path[len("/traces/"):]
                tree = span_tree(trace_id)
                if not tree:
                    self._reply(request, 404, json.dumps(
                        {"error": f"no such trace {trace_id!r} "
                                  "(unsampled or evicted)"}).encode(),
                        "application/json")
                    return
                body = json.dumps({"trace_id": trace_id, "spans": tree},
                                  indent=2,
                                  default=_json_default).encode()
                self._reply(request, 200, body, "application/json")
        elif path == "/workload":
            # Workload recorder: the bounded log of admitted
            # queries (normalized text, hoisted literals, outcome,
            # wall/compile/execute split) + per-fingerprint roll-up —
            # what `yt workload capture` pulls and `yt replay` re-runs.
            from ytsaurus_tpu_torch.query.workload import get_workload_log
            limit = int(params.get("limit", 128))
            body = json.dumps(get_workload_log().snapshot(limit=limit),
                              indent=2, default=_json_default).encode()
            self._reply(request, 200, body, "application/json")
        elif path == "/mesh":
            # Mesh execution observatory: per-fingerprint
            # roll-up of the in-program SPMD telemetry blocks (shard
            # skew, exchange bytes, quota headroom, memory watermark)
            # plus the skew SLO spec — `yt mesh top`'s data source.
            from ytsaurus_tpu_torch.parallel.mesh_observatory import (
                get_mesh_observatory,
            )
            top = int(params.get("top", 50))
            body = json.dumps(get_mesh_observatory().snapshot(top=top),
                              indent=2, default=_json_default).encode()
            self._reply(request, 200, body, "application/json")
        elif path == "/metrics/history":
            # Telemetry plane: bounded time-series rings the
            # sampler thread fills from every registered sensor.
            # ?name=/serving/select_latency_seconds&tags=pool=prod
            # &since=<unix ts>&tier=fine|coarse
            tags = None
            if params.get("tags"):
                tags = dict(kv.split("=", 1)
                            for kv in params["tags"].split(",") if "=" in kv)
            since = float(params["since"]) if "since" in params else None
            body = json.dumps({
                "sample_period": self.history.sample_period,
                "samples_taken": self.history.samples_taken,
                "series": self.history.query(
                    name=params.get("name"), tags=tags, since=since,
                    tier=params.get("tier", "fine")),
            }, indent=2, default=_json_default).encode()
            self._reply(request, 200, body, "application/json")
        elif path == "/accounting":
            # Per-tenant resource accounting: the full (pool, user)
            # usage matrix plus per-pool / per-user roll-ups and the
            # plane totals (`yt top`'s data source).
            body = json.dumps(self.accountant.snapshot(), indent=2,
                              default=_json_default).encode()
            self._reply(request, 200, body, "application/json")
        elif path == "/slo":
            # SLO burn-rate state: a fresh evaluation pass (so operators
            # always read current burn rates, not the last sampler tick)
            # plus active/resolved alerts.
            body = json.dumps(self.slo_tracker.evaluate(), indent=2,
                              default=_json_default).encode()
            self._reply(request, 200, body, "application/json")
        elif path == "/telemetry":
            # Compact single-daemon telemetry summary — what the
            # primary's /cluster roll-up scrapes from every member.
            body = json.dumps(self._telemetry_summary(), indent=2,
                              default=_json_default).encode()
            self._reply(request, 200, body, "application/json")
        elif path == "/cluster":
            body = json.dumps(self._cluster_rollup(), indent=2,
                              default=_json_default).encode()
            self._reply(request, 200, body, "application/json")
        elif path in ("/metrics", "/solomon"):
            body = self.registry.render_prometheus().encode()
            self._reply(request, 200, body, "text/plain; version=0.0.4")
        elif path == "/orchid" or path.startswith("/orchid/"):
            sub = path[len("/orchid"):] or "/"
            try:
                value = self.orchid.get(sub)
            except YtError as err:
                self._reply(request, 404,
                            json.dumps(err.to_dict()).encode(),
                            "application/json")
                return
            body = json.dumps(value, default=_json_default,
                              indent=2).encode()
            self._reply(request, 200, body, "application/json")
        else:
            self._reply(request, 404, b"not found", "text/plain")

    # -- fleet roll-up ---------------------------------------------------------

    def _telemetry_summary(self) -> dict:
        """One daemon's telemetry in scrapeable form: SLO state,
        accounting roll-ups, and history metadata (series list, not the
        full rings — /metrics/history serves points on demand)."""
        history = self.history
        return {
            "address": self.address,
            "slo": self.slo_tracker.snapshot(),
            "accounting": self.accountant.snapshot(),
            "history": {
                "sample_period": history.sample_period,
                "samples_taken": history.samples_taken,
                "series_names": history.series_names(),
            },
        }

    def _scrape_member(self, address):
        if address == self.address:
            return self._telemetry_summary()
        with urllib.request.urlopen(
                f"http://{address}/telemetry",
                timeout=self.CLUSTER_SCRAPE_TIMEOUT) as resp:
            return json.loads(resp.read())

    def _cluster_rollup(self) -> dict:
        """The fleet view (primary): scrape every discovery-registered
        daemon's /telemetry and aggregate — per-member summaries, every
        member's active alerts merged (tagged by member), and the
        accounting totals summed cluster-wide.  Scrapes fan out on a
        pool so the wall time of a fleet with dead members is ONE
        scrape timeout, not their sum."""
        from concurrent.futures import ThreadPoolExecutor
        members = list(self.cluster_members()) \
            if self.cluster_members is not None else []
        if not any(m.get("address") == self.address for m in members):
            members.insert(0, {"id": "self", "address": self.address})
        out_members: dict = {}
        alerts: list = []
        totals: dict = {}
        errors: dict = {}
        with ThreadPoolExecutor(
                max_workers=min(8, max(len(members), 1)),
                thread_name_prefix="cluster-scrape") as pool:
            futures = [(m, pool.submit(self._scrape_member,
                                       m.get("address")))
                       for m in members]
        for member, future in futures:
            member_id = member.get("id") or member.get("address")
            address = member.get("address")
            try:
                summary = future.result()
            except Exception as exc:  # noqa: BLE001 — one dead member
                # must not take down the fleet view.
                errors[member_id] = repr(exc)
                out_members[member_id] = {"address": address,
                                          "reachable": False}
                continue
            out_members[member_id] = {
                "address": address, "reachable": True,
                "attributes": dict(member.get("attributes") or {}),
                **summary,
            }
            for alert in (summary.get("slo") or {}).get(
                    "active_alerts") or []:
                alerts.append({"member": member_id, **alert})
            for field, value in ((summary.get("accounting") or {})
                                 .get("totals") or {}).items():
                totals[field] = totals.get(field, 0.0) + value
        return {"members": out_members, "active_alerts": alerts,
                "accounting_totals": totals, "errors": errors}

    @staticmethod
    def _reply(request, status: int, body: bytes, ctype: str) -> None:
        request.send_response(status)
        request.send_header("Content-Type", ctype)
        request.send_header("Content-Length", str(len(body)))
        request.end_headers()
        request.wfile.write(body)


def _json_default(value):
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    return str(value)
