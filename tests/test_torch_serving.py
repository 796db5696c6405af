"""The port's serving gateway against the JAX package's: admission
(weighted slots, the bounded queue, throttling with `retry_after`, the
brown-out ladder), deadlines, lookup coalescing across threads and the
NEAREST cohorts of `NearestBatcher`. The reference's own tests
(tests/test_serving.py) run on the port, and the coalescing cases drive
both gateways alike from threads. The port runs with device="cpu".

The throttle-aware RPC channels and the HTTP proxy's error mapping run
through the port's `rpc/channel.py` and `server/http_proxy.py`. Left out
of the twins: the exec node and the monitoring endpoint
(`server/exec_service.py` and `server/monitoring.py`, which wait for the
daemons), `test_pad_needles_pow2_buckets` (the port pads no needles: it
compiles no shapes), and the slow soak (its quick sibling runs)."""

import threading

import numpy as np
import pytest
import torch

from tests.test_torch_client import call_twin, port_twin, twin_cases
from ytsaurus_tpu import client as ref_client
from ytsaurus_tpu.config import ServingConfig as RefServingConfig
from ytsaurus_tpu.errors import ThrottledError as RefThrottledError
from ytsaurus_tpu.query.serving import QueryGateway as RefGateway
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch import client as port_client
from ytsaurus_tpu_torch.config import ServingConfig
from ytsaurus_tpu_torch.errors import EErrorCode, ThrottledError, YtError
from ytsaurus_tpu_torch.query.serving import QueryGateway, serving_snapshot
from ytsaurus_tpu_torch.query.vector import batched_nearest
from ytsaurus_tpu_torch.schema import TableSchema

torch.set_num_threads(1)

_TWIN = port_twin("test_serving")
_CASES = twin_cases(_TWIN, exclude={
    "test_pad_needles_pow2_buckets", "test_exec_node_throttles_full_queue",
    "test_serving_metrics_move_under_load",
    "test_serving_soak_under_failpoints"})


@pytest.fixture(scope="module")
def serve_client(tmp_path_factory):
    """The reference module's `client` fixture, on the port."""
    c = _TWIN.connect(str(tmp_path_factory.mktemp("serving") / "cluster"))
    schema = TableSchema.make(
        [("k", "int64", "ascending"), ("v", "int64"), ("s", "string")],
        unique_keys=True)
    c.create("table", "//serve",
             attributes={"schema": schema, "dynamic": True,
                         "pivot_keys": [[80], [160]]}, recursive=True)
    c.mount_table("//serve")
    c.insert_rows("//serve", [{"k": i, "v": i * 7, "s": f"s{i}"}
                              for i in range(_TWIN.N_ROWS)])
    return c


@pytest.mark.parametrize("name", _CASES)
def test_reference_serving_case_on_the_port(name, serve_client, tmp_path):
    call_twin(_TWIN, name, {"client": serve_client, "tmp_path": tmp_path})


# --- the same scripts through both gateways ---------------------------------


def _held(gateway):
    hold, entered = threading.Event(), threading.Event()

    def busy(token):
        entered.set()
        hold.wait(5.0)

    thread = threading.Thread(target=lambda: gateway.run_select(busy),
                              daemon=True)
    thread.start()
    assert entered.wait(5.0)
    return hold, thread


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_admission_snapshots_match(pkg):
    Gateway, Config, Throttled = {
        "reference": (RefGateway, RefServingConfig, RefThrottledError),
        "port": (QueryGateway, ServingConfig, ThrottledError)}[pkg]
    gateway = Gateway(Config(slots=1, max_queue=0,
                             pools={"default": 1.0, "heavy": 3.0}))
    hold, thread = _held(gateway)
    try:
        with pytest.raises(Throttled) as err:
            gateway.run_select(lambda token: None)
        assert err.value.retry_after > 0
        assert err.value.code == int(EErrorCode.RequestThrottled)
    finally:
        hold.set()
        thread.join(5)
    pools = gateway.snapshot()["pools"]
    assert (pools["default"]["admitted"], pools["default"]["rejected"],
            pools["heavy"]["weight"]) == (1, 1, 3.0)


def test_admission_snapshot_keys_are_the_references():
    ref = RefGateway(RefServingConfig(pools={"default": 1.0, "b": 2.0}))
    port = QueryGateway(ServingConfig(pools={"default": 1.0, "b": 2.0}))
    for gateway in (ref, port):
        gateway.run_select(lambda token: None, pool="b")
    r, p = ref.snapshot(), port.snapshot()
    assert sorted(p) == sorted(r)
    assert sorted(p["admission"]) == sorted(r["admission"])
    for name in ("default", "b"):
        assert sorted(p["pools"][name]) == sorted(r["pools"][name])
        for key in ("admitted", "rejected", "expired", "weight",
                    "in_flight", "waiting"):
            assert p["pools"][name][key] == r["pools"][name][key], key
    assert any(s is not None for s in serving_snapshot())


@pytest.mark.parametrize("bad", [
    dict(pools={"default": -1.0}), dict(pools={"a": 1.0},
                                        default_pool="b"),
    dict(min_shares={"default": 0.7, "x": 0.6}),
    dict(pool_limits={"default": 0}), dict(slots=0),
    dict(brownout_rung1_seconds=3.0, brownout_rung2_seconds=1.0)])
def test_serving_config_rejects_what_the_reference_rejects(bad):
    with pytest.raises(Exception):
        RefServingConfig(**bad)
    with pytest.raises(YtError) as err:
        ServingConfig(**bad)
    assert err.value.code == int(EErrorCode.InvalidConfig)


def _lookup_table(c, Schema, n=200):
    schema = Schema.make([("k", "int64", "ascending"), ("v", "int64")],
                         unique_keys=True)
    c.create("table", "//co/t", recursive=True,
             attributes={"schema": schema, "dynamic": True,
                         "pivot_keys": [[n // 2]]})
    c.mount_table("//co/t")
    c.insert_rows("//co/t", [{"k": i, "v": i * 3} for i in range(n)])


def _gate_accumulate(batcher, members: int):
    """Hold the batcher's accumulation until `members` requests are
    pending in one cohort (the callers' threads enqueue concurrently),
    so the cohort's size does not hang on the flush window's timing."""
    original = batcher._accumulate
    ready = threading.Event()

    def gated():
        for _ in range(2000):
            with batcher._cond:
                pending = sum(len(getattr(b, "key_lists", None) or
                                  getattr(b, "queries", ()))
                              for b in batcher._batches.values())
            if pending >= members:
                ready.set()
                break
            threading.Event().wait(0.005)
        original()

    batcher._accumulate = gated
    return ready


def _run_threads(n, fn) -> list:
    results = [None] * n
    barrier = threading.Barrier(n)

    def work(i):
        barrier.wait()
        results[i] = fn(i)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return results


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_lookups_from_threads_coalesce_into_one_batch(tmp_path, pkg):
    client_mod, Schema = {"reference": (ref_client, RefSchema),
                          "port": (port_client, TableSchema)}[pkg]
    c = client_mod.connect(str(tmp_path), **(
        {"device": "cpu"} if pkg == "port" else {}))
    _lookup_table(c, Schema)
    c.lookup_rows("//co/t", [(0,)])                # the path's context
    batcher = c.cluster.gateway.batcher
    before = batcher.snapshot()
    n = 8
    ready = _gate_accumulate(batcher, n)
    rng = np.random.default_rng(3)
    asks = [[(int(k),) for k in rng.integers(0, 260, 9)] for _ in range(n)]
    results = _run_threads(n, lambda i: c.lookup_rows("//co/t", asks[i]))
    assert ready.is_set()
    after = batcher.snapshot()
    assert after["requests"] - before["requests"] == n
    assert after["batches"] - before["batches"] == 1
    assert after["batched_keys"] - before["batched_keys"] == \
        len({k for ask in asks for k in ask})
    for ask, rows in zip(asks, results):
        assert [None if r is None else (r["k"], r["v"]) for r in rows] == \
            [(k, k * 3) if k < 200 else None for (k,) in ask]


_DIM = 8


def _vec_table(c, Schema, n=96):
    schema = Schema.make([("k", "int64", "ascending"),
                          ("emb", f"vector<float, {_DIM}>")],
                         unique_keys=True)
    c.create("table", "//co/v", recursive=True,
             attributes={"schema": schema, "dynamic": True})
    c.mount_table("//co/v")
    rng = np.random.default_rng(30)
    vectors = rng.integers(-6, 7, (n, _DIM)).astype(float)
    c.insert_rows("//co/v", [{"k": i, "emb": list(map(float, e))}
                             for i, e in enumerate(vectors)])


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_nearest_cohort_runs_as_one_batch(tmp_path, pkg):
    """NEAREST callers from threads form one cohort; each gets its own k
    of the cohort's one batched ranking, and the port's answers equal
    the reference's."""
    client_mod, Schema = {"reference": (ref_client, RefSchema),
                          "port": (port_client, TableSchema)}[pkg]
    c = client_mod.connect(str(tmp_path), **(
        {"device": "cpu"} if pkg == "port" else {}))
    _vec_table(c, Schema)
    batcher = c.cluster.gateway.nearest_batcher
    n = 6
    rng = np.random.default_rng(31)
    queries = [list(map(float, rng.integers(-6, 7, _DIM)))
               for _ in range(n)]
    ks = [1, 3, 7, 2, 5, 4]
    before = batcher.snapshot()
    ready = _gate_accumulate(batcher, n)
    results = _run_threads(n, lambda i: c.nearest_rows(
        "//co/v", "emb", queries[i], ks[i]))
    assert ready.is_set()
    after = batcher.snapshot()
    assert after["batches"] - before["batches"] == 1
    assert after["batched_queries"] - before["batched_queries"] == n
    for k, rows in zip(ks, results):
        assert len(rows) == k
        ds = [r["$distance"] for r in rows]
        assert ds == sorted(ds)
    if pkg == "port":
        (tablet,) = c._mounted_tablets("//co/v")
        snap = tablet.read_snapshot(2 ** 62 - 1)
        ranked = batched_nearest(snap, "emb", queries, max(ks),
                                 device="cpu")
        keys = snap.to_numpy()["planes"]["k"][0]
        for k, rows, want in zip(ks, results, ranked):
            assert [r["k"] for r in rows] == \
                [int(keys[j]) for j, _ in want[:k]]
            assert [r["$distance"] for r in rows] == \
                [m for _, m in want[:k]]


def test_nearest_answers_match_the_reference(tmp_path):
    ref = ref_client.connect(str(tmp_path / "ref"))
    port = port_client.connect(str(tmp_path / "port"), device="cpu")
    _vec_table(ref, RefSchema)
    _vec_table(port, TableSchema)
    q = [1.0, -2.0, 0.5, 3.0, 0.0, -1.0, 2.0, 1.0]
    for metric in ("l2", "cosine", "dot"):
        want = ref.nearest_rows("//co/v", "emb", q, 5, metric=metric)
        got = port.nearest_rows("//co/v", "emb", q, 5, metric=metric)
        assert [r["k"] for r in got] == [r["k"] for r in want]
        assert [r["emb"] for r in got] == [r["emb"] for r in want]
        np.testing.assert_allclose([r["$distance"] for r in got],
                                   [r["$distance"] for r in want],
                                   rtol=1e-6)
    for bad in (dict(metric="manhattan"), dict(k=0)):
        args = dict(dict(metric="l2", k=3), **bad)
        with pytest.raises(YtError):
            port.nearest_rows("//co/v", "emb", q, args["k"],
                              metric=args["metric"])


def test_nearest_without_the_gateway_takes_the_direct_path(tmp_path):
    port = port_client.connect(str(tmp_path), device="cpu")
    port.cluster.serving_config = ServingConfig(enabled=False)
    _vec_table(port, TableSchema)
    rows = port.nearest_rows("//co/v", "emb", [0.0] * _DIM, 3)
    assert len(rows) == 3
    assert port.cluster.gateway.nearest_batcher.snapshot()["batches"] == 0
