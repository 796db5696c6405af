"""The port's daemon-side modules against the JAX package's, in one
process, on the CPU: the declarative configs, replica routing, P2P chunk
seeding, the chunk replicator and the erasure repair, and the JSON that
the orchid and the monitoring server serve.

Twins (the reference's own tests run on the port through `port_twin`):

- tests/test_config.py (16 cases), whole;
- tests/test_routing.py (9), whole;
- tests/test_p2p.py (5), whole, over port `DataNodeService`s behind
  port `RpcServer`s (the `trio` fixture below is the reference's);
- tests/test_chunk_repair.py: the two cases that start no cluster
  (`test_replicator_scan_unit`, and the erasure repair with the store
  decoding on the CPU). Its cluster cases are in
  tests/test_torch_local_cluster.py.

Parity: an OrchidTree of each package over the same producers answers
the same `get` / `list` (and the same errors); a MonitoringServer of
each package over registries, history rings, an SLO tracker, an
accountant and a gateway fed the same events serves the same JSON on
/healthz, /metrics, /metrics/history, /accounting, /slo, /telemetry,
/cluster, /failpoints, /sanitizer, /serving and /orchid, timestamps and
addresses masked; and `view_lag_slo` and `DaemonConfig` agree.
"""

import dataclasses
import json
import time
import urllib.error
import urllib.request

import pytest
import torch

from tests.test_torch_client import _cpu_module, call_twin, port_twin, twin_cases
from ytsaurus_tpu import config as ref_config
from ytsaurus_tpu.errors import YtError as RefYtError
from ytsaurus_tpu_torch import config
from ytsaurus_tpu_torch.chunks import store as port_store
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.rpc import RpcServer
from ytsaurus_tpu_torch.server.services import DataNodeService

torch.set_num_threads(1)


class _CpuFsChunkStore(port_store.FsChunkStore):
    """FsChunkStore whose reads decode onto the CPU by default."""

    def read_chunk(self, chunk_id, device="cpu"):
        return super().read_chunk(chunk_id, device=device)


_cpu_module("_port_cpu_store", port_store, FsChunkStore=_CpuFsChunkStore)

_CONFIG_TWIN = port_twin("test_config")
_CONFIG_CASES = twin_cases(_CONFIG_TWIN)
_ROUTING_TWIN = port_twin("test_routing")
_ROUTING_CASES = twin_cases(_ROUTING_TWIN)
_P2P_TWIN = port_twin("test_p2p")
_P2P_CASES = twin_cases(_P2P_TWIN)
_REPAIR_TWIN = port_twin("test_chunk_repair", edits={
    "from ytsaurus_tpu.chunks.store import FsChunkStore":
        "from _port_cpu_store import FsChunkStore"})
_REPAIR_CASES = twin_cases(_REPAIR_TWIN, exclude={
    # They start a LocalCluster: tests/test_torch_local_cluster.py.
    "test_dead_node_chunks_re_replicate_without_reads",
    "test_scrub_quarantines_and_replicator_heals"})


def test_twin_lists_hold_every_runnable_case():
    assert len(_CONFIG_CASES) == 11 and len(_CONFIG_PARAMS) == 16
    assert len(_ROUTING_CASES) == 9
    assert len(_P2P_CASES) == 5
    assert len(_REPAIR_CASES) == 4 - 2


def _config_params() -> list:
    """(case, argument index or None): the reference's parametrized case
    counts once per argument, as it does there."""
    out = []
    for name in _CONFIG_CASES:
        marks = [m for m in getattr(getattr(_CONFIG_TWIN, name),
                                    "pytestmark", [])
                 if m.name == "parametrize"]
        out += [(name, i) for i in range(len(marks[0].args[1]))] \
            if marks else [(name, None)]
    return out


_CONFIG_PARAMS = _config_params()


@pytest.mark.parametrize("name,index", _CONFIG_PARAMS)
def test_reference_config_case_on_the_port(name, index):
    fn = getattr(_CONFIG_TWIN, name)
    if index is None:
        fn()
        return
    (mark,) = [m for m in fn.pytestmark if m.name == "parametrize"]
    fn(mark.args[1][index])


@pytest.mark.parametrize("name", _ROUTING_CASES)
def test_reference_routing_case_on_the_port(name):
    call_twin(_ROUTING_TWIN, name, {})


@pytest.fixture
def trio(tmp_path):
    """Three in-process port data nodes with real RPC between them."""
    nodes = []
    for i in range(3):
        store = port_store.FsChunkStore(str(tmp_path / f"n{i}" / "chunks"))
        service = DataNodeService(store, str(tmp_path / f"n{i}" / "j"))
        server = RpcServer([service], port=0)
        server.start()
        nodes.append({"store": store, "service": service,
                      "server": server,
                      "address": f"127.0.0.1:{server.port}"})
    yield nodes
    for n in nodes:
        try:
            n["server"].stop()
        except Exception:       # noqa: BLE001 — a case may have stopped it
            pass


@pytest.mark.parametrize("name", _P2P_CASES)
def test_reference_p2p_case_on_the_port(name, trio):
    call_twin(_P2P_TWIN, name, {"trio": trio})


@pytest.mark.parametrize("name", _REPAIR_CASES)
def test_reference_chunk_repair_case_on_the_port(name, tmp_path):
    call_twin(_REPAIR_TWIN, name, {"tmp_path": tmp_path})


# --- configs -----------------------------------------------------------------


def test_daemon_config_matches_the_reference_shape():
    patch = {"role": "node", "rpc": {"port": 9013, "max_workers": 4},
             "chunk_store": {"replication_factor": 3},
             "master": {"journal_nodes": 3},
             "scheduler": {"max_running_jobs": 2},
             "serving": {"slots": 4, "pools": {"a": 2.0, "default": 1.0}},
             "tracing": {"sample_rate": 0.5}}
    port = config.DaemonConfig.from_dict(patch).to_dict()
    ref = ref_config.DaemonConfig.from_dict(patch).to_dict()
    for key in ("role", "root", "rpc", "chunk_store", "master",
                "scheduler", "serving", "tracing", "tablet"):
        assert port[key] == ref[key], key
    # The workload config lacks only the compile observatory's knobs.
    assert port["workload"] == {k: v for k, v in ref["workload"].items()
                                if k in port["workload"]}
    assert port["device"] == "cuda"
    # Plain sub-configs refuse what the reference's structs refuse.
    for bad in ({"serving": {"slots": 0}}, {"serving": {"nope": 1}},
                {"rpc": {"port": 70000}}, {"role": "gateway"}):
        with pytest.raises(YtError) as port_err:
            config.DaemonConfig.from_dict(bad)
        with pytest.raises(RefYtError) as ref_err:
            ref_config.DaemonConfig.from_dict(bad)
        assert int(port_err.value.code) == int(ref_err.value.code)


def test_dynamic_config_drives_the_gateway():
    from ytsaurus_tpu_torch.query.serving import QueryGateway
    gateway = QueryGateway(config.ServingConfig(slots=2))
    patches = [None]
    manager = config.DynamicConfigManager(
        lambda: patches[0], config.DaemonConfig(), period=1000)
    gateway.attach_dynamic_config(manager)
    patches[0] = {"serving": {"slots": 6, "pools": {"default": 1.0,
                                                    "gold": 3.0}}}
    assert manager.poll_once() and manager.update_count == 1
    assert gateway.config.slots == 6
    assert gateway.config.pools == {"default": 1.0, "gold": 3.0}
    patches[0] = {"serving": {"slots": 0}}         # refused: last good kept
    assert not manager.poll_once()
    assert gateway.config.slots == 6 and manager.last_error is not None


@pytest.mark.parametrize("view", [None, "v1"])
def test_view_lag_slo_matches_the_reference(view):
    port = dataclasses.asdict(config.view_lag_slo(view, objective=0.95))
    ref = ref_config.view_lag_slo(view, objective=0.95).to_dict()
    assert port == ref


# --- orchid and monitoring parity ---------------------------------------------


def _producers():
    return {
        "/a/b": lambda: {"x": 1, "y": {"z": [1, 2, 3]}},
        "/a/c": lambda: 7,
        "/list": lambda: [{"k": 1}, {"k": 2}],
        "/bytes": lambda: {b"raw": 1, "text": "t"},
    }


def _orchid_answers(orchid_module, error_type):
    tree = orchid_module.OrchidTree()
    for path, producer in _producers().items():
        tree.register(path, producer)
    tree.register_value("/const", {"v": 5})
    out = []
    for path in ("/", "/a", "/a/b", "/a/b/y/z/1", "/a/c", "/list/1/k",
                 "/bytes/raw", "/const", "/missing", "/a/b/nope",
                 "/list/9"):
        for method in ("get", "list"):
            try:
                out.append((path, method, getattr(tree, method)(path)))
            except error_type as err:
                out.append((path, method, "error", int(err.code)))
    return out


def test_orchid_tree_matches_the_reference():
    from ytsaurus_tpu.server import orchid as ref_orchid
    from ytsaurus_tpu_torch.server import orchid as port_orchid
    assert _orchid_answers(port_orchid, YtError) == \
        _orchid_answers(ref_orchid, RefYtError)


_SLOS = {
    "lat": {"kind": "latency", "sensor": "/serving/latency",
            "bound_ms": 100.0, "objective": 0.9, "burn_threshold": 1.0},
    "avail": {"kind": "availability", "good_sensor": "/serving/ok",
              "bad_sensor": "/serving/bad", "objective": 0.99,
              "burn_threshold": 2.0, "tags": {"pool": "gold"}},
}


class _Plane:
    """One package's monitoring server over state fed the same events."""

    def __init__(self, pkg: str):
        def mod(name):
            return __import__(f"{pkg}.{name}", fromlist=["_"])
        profiling, slo = mod("utils.profiling"), mod("utils.slo")
        cfg, accounting = mod("config"), mod("query.accounting")
        serving, failpoints = mod("query.serving"), mod("utils.failpoints")
        self.failpoints = failpoints
        self.registry = profiling.ProfilerRegistry()
        prof = profiling.Profiler("/serving", registry=self.registry)
        gold = prof.with_tags(pool="gold")
        now = time.time()
        self.history = profiling.MetricsHistory(registry=self.registry,
                                                sample_period=10.0)
        lat = prof.histogram("latency", bounds=[0.01, 0.1, 1.0])
        for step in range(3):
            gold.counter("ok").increment(10 + step)
            gold.counter("bad").increment(step)
            prof.gauge("depth").set(step * 2)
            prof.summary("hold").record(0.5 * step)
            for value in (0.005, 0.05, 0.5, 2.0)[: step + 2]:
                lat.record(value)
            self.history.sample_once(now - 30 + 10 * step)
        telemetry = cfg.TelemetryConfig.from_dict({"slos": _SLOS}) \
            if hasattr(cfg.TelemetryConfig, "from_dict") \
            else cfg.TelemetryConfig(slos=_SLOS)
        self.tracker = slo.SloTracker(telemetry, self.history)
        self.tracker.evaluate(now=now)
        self.accountant = accounting.ResourceAccountant(
            registry=profiling.ProfilerRegistry())
        self.accountant.observe_lookup("gold", "alice", keys=5,
                                       rows_found=3)
        self.accountant.observe_lookup_batch("gold", "alice")
        self.accountant.observe_throttle("bronze", "bob")
        self.accountant.observe_operation("gold", "alice", 1.5, jobs=3)
        self.gateway = serving.QueryGateway(serving.ServingConfig(
            slots=3, pools={"default": 1.0, "gold": 2.0}))
        orchid_mod = mod("server.orchid")
        tree = orchid_mod.OrchidTree()
        for path, producer in _producers().items():
            tree.register(path, producer)
        monitoring = mod("server.monitoring")
        self.server = monitoring.MonitoringServer(
            tree, registry=self.registry, history=self.history,
            slo_tracker=self.tracker, accountant=self.accountant)
        self.server.serving_gateways = [self.gateway]
        self.site = failpoints.register_site("daemons.parity.site")
        self.server.start()

    def get(self, path: str):
        url = f"http://{self.server.address}{path}"
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                status, body = resp.status, resp.read()
        except urllib.error.HTTPError as err:
            status, body = err.code, err.read()
        try:
            return status, json.loads(body)
        except ValueError:
            return status, body.decode()

    def close(self):
        self.server.stop()


def _mask(value, addresses):
    """Timestamps (floats past 1e9) and the servers' own addresses
    become placeholders."""
    if isinstance(value, dict):
        return {_mask(k, addresses): _mask(v, addresses)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_mask(v, addresses) for v in value]
    if isinstance(value, float) and value > 1e9:
        return "<t>"
    if isinstance(value, str):
        for address in addresses:
            value = value.replace(address, "<addr>")
    return value


@pytest.fixture(scope="module")
def planes():
    port, ref = _Plane("ytsaurus_tpu_torch"), _Plane("ytsaurus_tpu")
    yield port, ref
    port.close()
    ref.close()


_ENDPOINTS = ["/healthz", "/metrics", "/solomon",
              "/metrics/history", "/metrics/history?name=/serving/ok",
              "/metrics/history?name=/serving/latency&tier=coarse",
              "/metrics/history?tags=pool=gold",
              "/accounting", "/slo", "/telemetry", "/cluster", "/serving",
              "/orchid", "/orchid/a/b", "/orchid/a/b/y/z/2",
              "/orchid/missing", "/nope"]


@pytest.mark.parametrize("path", _ENDPOINTS)
def test_monitoring_endpoint_matches_the_reference(planes, path):
    port, ref = planes
    addresses = [port.server.address, ref.server.address]
    got = _mask(port.get(path), addresses)
    want = _mask(ref.get(path), addresses)
    assert got == want


def test_failpoints_endpoint_matches_the_reference(planes):
    """The same schedule armed in both packages: the active spec, the
    rule's live state and the site's counters agree, and both mirror the
    triggers into /metrics as failpoints_*."""
    port, ref = planes
    spec = "daemons.parity.site=error:times=2"
    docs = []
    for plane in planes:
        fp = plane.failpoints
        fp.reset_counters()
        with fp.active(spec, seed=3):
            for _ in range(3):
                try:
                    plane.site.hit()
                except Exception:   # noqa: BLE001 — the injected error
                    pass
            status, doc = plane.get("/failpoints")
        assert status == 200
        docs.append((doc["active_spec"], doc["schedule"],
                     doc["sites"]["daemons.parity.site"]))
    assert docs[0] == docs[1]
    assert docs[0][2] == {"hits": 3, "triggers": 2}
    from ytsaurus_tpu_torch.utils.profiling import get_registry
    metrics = get_registry().render_prometheus()
    assert 'failpoints_triggers{site="daemons.parity.site"}' in metrics


def test_sanitizer_endpoint_reports_off_like_the_reference(planes):
    """Both sanitizers are on (tests/conftest.py arms YT_TPU_SANITIZE for
    the session) and /sanitizer serves the same report shape from each:
    the same keys and counters, the same hold budget, lock-order edges
    as "a -> b" strings between registered sites, and the counters
    mirrored into the process registry's /metrics as sanitizer_*. The
    counts themselves are each package's own locks' and differ."""
    (_, port_doc), (_, ref_doc) = (p.get("/sanitizer") for p in planes)
    assert port_doc["enabled"] is True and ref_doc["enabled"] is True
    assert set(port_doc) == set(ref_doc) == {
        "enabled", "hold_budget_seconds", "counters", "edges",
        "inversions", "hold_violations", "sync_under_lock",
        "registered_sites"}
    assert port_doc["hold_budget_seconds"] == ref_doc["hold_budget_seconds"]
    assert set(port_doc["counters"]) == set(ref_doc["counters"])
    for doc in (port_doc, ref_doc):
        assert doc["counters"]["acquires"] > 0
        assert doc["counters"]["edges_observed"] == len(doc["edges"])
        sites = set(doc["registered_sites"])
        assert "profiling.MetricsHistory._lock" in sites
        for edge in doc["edges"]:
            a, b = edge.split(" -> ")
            assert a in sites and b in sites, edge
    from ytsaurus_tpu.utils.profiling import get_registry as ref_registry
    from ytsaurus_tpu_torch.utils.profiling import get_registry
    for registry in (get_registry, ref_registry):
        assert "sanitizer_edges_observed" in \
            registry().render_prometheus()
