"""The port's runtime concurrency sanitizer (ytsaurus_tpu_torch/utils/
sanitizers.py) against the JAX package's: the reference's own tests
(tests/test_sanitizer.py) run on the port through `port_twin`, every
case. Two edits: the host-sync case materializes a torch computation
where the reference's materializes a jitted one, and the reconciliation
cases build the static graph with the repo's unmodified `tools/analyze`
over the port's own tree (`load_files(repo, package=
"ytsaurus_tpu_torch")`). tests/conftest.py arms YT_TPU_SANITIZE for the
whole suite, so the port's registered locks here are instrumented.

Beside the twins: the port's client driven through its hot paths leaves
only edges that the port's static graph holds, and both sanitizers give
the same edges, inversions, hold violations and blocking events for the
same lock script."""

import functools
import os
import sys
import threading
import time

import pytest

from tests.test_torch_client import call_twin, port_twin, twin_cases
from ytsaurus_tpu.utils import sanitizers as ref_sanitizers
from ytsaurus_tpu_torch.utils import sanitizers

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TWIN = port_twin("test_sanitizer", edits={
    """    import jax
    import jax.numpy as jnp

    a = make(san, "evaluator.fake._lock")
    fn = jax.jit(lambda x: (x * 2).sum())
    with a:
        value = fn(jnp.arange(8))""": """    import torch

    a = make(san, "evaluator.fake._lock")
    fn = lambda x: (x * 2).sum()  # noqa: E731
    with a:
        value = fn(torch.arange(8))""",
    "guard_inference.reconciliation_graph(load_files(repo))":
        "guard_inference.reconciliation_graph(\n"
        "        load_files(repo, package=\"ytsaurus_tpu_torch\"))"})
_CASES = twin_cases(_TWIN)


def test_the_twin_holds_every_case():
    assert len(_CASES) == 24


@pytest.mark.parametrize("name", _CASES)
def test_reference_sanitizer_case_on_the_port(name, monkeypatch):
    call_twin(_TWIN, name, {"san": _TWIN.LockSanitizer(hold_budget=0.02),
                            "monkeypatch": monkeypatch})


@functools.lru_cache(maxsize=1)
def _port_graph():
    if _REPO not in sys.path:
        sys.path.insert(0, _REPO)
    from tools.analyze import guard_inference, load_files
    return guard_inference.reconciliation_graph(
        load_files(_REPO, package="ytsaurus_tpu_torch"))


def test_the_port_client_leaves_only_static_edges(tmp_path):
    """Selects, lookups, transactions and a flush through the port's
    client (its gateway, tablets, chunk store and sensors) under the
    process-global sanitizer: no inversion, no blocking under a hot lock
    and no hold over budget, every observed edge between registered
    sites is in the port's static graph, and every registered site of
    the port resolves to a static node."""
    from ytsaurus_tpu_torch.client import connect
    from ytsaurus_tpu_torch.schema import TableSchema
    assert sanitizers.enabled(), "conftest arms YT_TPU_SANITIZE"
    holds_before = sanitizers.counters()["hold_violations"]
    client = connect(str(tmp_path), device="cpu")
    schema = TableSchema.make([("k", "int64", "ascending"),
                               ("v", "int64")], unique_keys=True)
    client.create("table", "//s/t", recursive=True,
                  attributes={"schema": schema, "dynamic": True})
    client.mount_table("//s/t")
    tx = client.start_transaction()
    client.insert_rows("//s/t", [{"k": i, "v": i * 3} for i in range(64)],
                       tx=tx)
    client.commit_transaction(tx)
    assert len(client.select_rows("k, v FROM [//s/t] WHERE v > 30")) == 53
    assert client.lookup_rows("//s/t", [(5,)]) == [{"k": 5, "v": 15}]
    client.freeze_table("//s/t")
    client.write_table("//s/static", [{"a": i} for i in range(10)])
    assert client.select_rows("sum(a) AS s FROM [//s/static] GROUP BY 1"
                              ) == [{"s": 45}]
    san = sanitizers.get_sanitizer()
    assert san is not None and san.counters()["acquires"] > 0
    # The process-global sanitizer has seen every port test this process
    # ran so far: no lock-order inversion and no host sync or failpoint
    # I/O under a hot lock anywhere, and no hot lock held past its
    # budget during this drive.
    report = san.snapshot()
    assert report["counters"]["inversions"] == 0, report["inversions"]
    assert report["counters"]["sync_under_lock"] == 0, \
        report["sync_under_lock"]
    assert report["counters"]["hold_violations"] == holds_before, \
        report["hold_violations"]
    graph = _port_graph()
    violations = sanitizers.reconcile(graph["edges"], graph["site_map"])
    assert violations == [], "\n".join(violations)
    missing = [site for site in sanitizers.registered_sites()
               if site not in graph["site_map"]
               and not site.startswith("test.")]
    assert missing == [], missing


def _script(module):
    """One lock script on a private sanitizer of `module`: nested
    acquisitions, an inversion on a second thread, a hold over budget,
    blocking under a hot lock, a condition wait and a re-entrant lock."""
    san = module.LockSanitizer(hold_budget=0.02)
    a = module.InstrumentedLock(san, "A")
    b = module.InstrumentedLock(san, "B")
    cold = module.InstrumentedLock(san, "C", hot=False)
    r = module.InstrumentedRLock(san, "R")
    cond = module.InstrumentedCondition(san, "K")
    with a:
        with b:
            san.note_blocking("io", "site.one")
    with cold:
        san.note_blocking("io", "site.cold")
    with r:
        with r:
            with a:
                pass

    def inverted():
        with b:
            with a:
                pass
    t = threading.Thread(target=inverted, name="inverted")
    t.start()
    t.join()
    with a:
        time.sleep(0.05)
    with cond:
        cond.wait(timeout=0.01)
        with b:
            pass
    counters = san.counters()
    counters.pop("acquires")
    return (sorted(san.edges), counters,
            [(i["holding"], i["acquiring"]) for i in san.inversions],
            [v["lock"] for v in san.hold_violations],
            [(e["kind"], e["detail"], e["locks_held"])
             for e in san.sync_under_lock])


def test_the_same_lock_script_gives_the_same_report():
    assert _script(sanitizers) == _script(ref_sanitizers)


def test_stacks_name_the_port_files():
    san = sanitizers.LockSanitizer()
    a = sanitizers.InstrumentedLock(san, "A")
    b = sanitizers.InstrumentedLock(san, "B")
    with a:
        with b:
            pass
    stack = san.edges[("A", "B")]["stack"]
    assert any("test_torch_sanitizer.py" in frame for frame in stack)
