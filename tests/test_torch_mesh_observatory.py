"""Parity of the port's mesh observatory
(`ytsaurus_tpu_torch.parallel.mesh_observatory`) with the JAX package's.

Twins of the host-only tests of tests/test_mesh_observatory.py (`:50`,
`:77`, `:96`): the same telemetry blocks are folded into the reference's
`MeshObservatory` and the port's, and the roll-ups (`totals`, `top` by
every field, `snapshot`) must be equal, exactly. The monitoring-endpoint
and CLI tests wait for the port's server; the memory-analysis test is not
applicable (an eager program has no compile-time memory analysis, so the
port's `memory_for` answers None and `totals()["compiled"]` stays 0).
"""

from __future__ import annotations

import pytest

from ytsaurus_tpu import config as ref_config
from ytsaurus_tpu.parallel.mesh_observatory import (
    MESH_SKEW_SLO as REF_MESH_SKEW_SLO,
)
from ytsaurus_tpu.parallel.mesh_observatory import (
    MeshObservatory as RefMeshObservatory,
)
from ytsaurus_tpu_torch import config
from ytsaurus_tpu_torch.parallel.mesh_observatory import (
    MESH_SKEW_SLO,
    MeshObservatory,
    get_mesh_observatory,
)
from ytsaurus_tpu_torch.utils.profiling import get_registry


def _block(skew=1.0, xbytes=0, headroom=0.0, watermark=None, drift=0.0,
           shards=8, path="fused"):
    """A telemetry block of the mesh_observatory.mesh_block shape."""
    block = {"version": 1, "path": path, "shards": shards,
             "in_rows": [10] * shards, "out_rows": [10] * shards,
             "skew": skew, "exchange_bytes": xbytes,
             "exchanges": []}
    if xbytes:
        block["exchanges"] = [{
            "stage": "shuffle/group", "rows": 10 * shards,
            "bytes": xbytes, "demand": 10, "quota": 16,
            "headroom": headroom}]
    if watermark is not None:
        block["memory_watermark_bytes"] = watermark
    if drift:
        block["stages"] = [{"stage": 0, "table": "//d",
                            "strategy": "partition", "est_rows": 100,
                            "actual_rows": 125, "drift": drift}]
    return block


def _both(records):
    """Fold (fingerprint, block) records into a fresh reference and port
    observatory each; the pair."""
    ref, port = RefMeshObservatory(), MeshObservatory()
    for fp, block in records:
        ref.record_execution(fp, dict(block))
        port.record_execution(fp, dict(block))
    return ref, port


def _same_views(ref, port) -> None:
    assert port.totals() == ref.totals()
    for by in ("skew", "bytes", "memory", "executions", "drift"):
        assert port.top(by=by) == ref.top(by=by), by
    assert port.snapshot() == ref.snapshot()


def test_rollup_classification_and_top_views():
    ref, port = _both([
        ("fp-a", _block(skew=1.2, xbytes=100)),
        ("fp-a", _block(skew=6.0, xbytes=50, headroom=0.8)),
        ("fp-b", _block(skew=2.0, watermark=4096, drift=0.25,
                        path="stitched"))])
    _same_views(ref, port)
    assert port.totals() == {"executions": 3, "balanced": 2, "skewed": 1,
                             "programs": 2, "compiled": 0}
    top = port.top(by="skew")
    assert [r["fingerprint"] for r in top] == ["fp-a", "fp-b"]
    assert top[0]["skew_max"] == 6.0 and top[0]["exchange_bytes"] == 150
    assert top[0]["quota_headroom"] == 0.8
    assert port.top(by="memory")[0]["fingerprint"] == "fp-b"
    snap = port.snapshot()
    assert snap["slo"] == MESH_SKEW_SLO == REF_MESH_SKEW_SLO
    assert all("last_block" not in r for r in snap["programs"])


def test_skew_classification_follows_config_threshold():
    """mesh_max_imbalance is the boundary; a 1-shard mesh or an empty
    output never counts as skewed."""
    empty = _block(skew=3.0)
    empty["out_rows"] = [0] * 8
    records = [("fp", _block(skew=3.0)), ("fp", _block(skew=1.5)),
               ("fp", _block(skew=3.0, shards=1)), ("fp", empty)]
    try:
        ref_config.set_telemetry_config(
            ref_config.TelemetryConfig(mesh_max_imbalance=2.0))
        config.set_telemetry_config(
            config.TelemetryConfig(mesh_max_imbalance=2.0))
        ref, port = _both(records)
    finally:
        ref_config.set_telemetry_config(None)
        config.set_telemetry_config(None)
    _same_views(ref, port)
    assert port.totals()["skewed"] == 1 and port.totals()["balanced"] == 3


def test_rollups_are_bounded():
    cap = MeshObservatory.PROGRAM_CAP
    assert cap == RefMeshObservatory.PROGRAM_CAP
    assert MeshObservatory.COMPILED_CAP == RefMeshObservatory.COMPILED_CAP
    ref, port = _both([(f"fp{i:04d}", _block()) for i in range(cap + 10)])
    _same_views(ref, port)
    assert port.totals()["programs"] == cap
    kept = {r["fingerprint"] for r in port.top(n=0)}
    assert "fp0000" not in kept and f"fp{cap + 9:04d}" in kept
    assert port.memory_for(("k", 0)) is None


def test_the_global_observatory_feeds_the_mesh_sensors():
    obs = get_mesh_observatory()
    before = get_registry().collect()
    obs.record_execution("fp-sensor", _block(skew=9.0, xbytes=64))
    after = get_registry().collect()
    assert after["/query/mesh/skew_max"] == 9.0
    assert after["/query/mesh/exchange_bytes"] == \
        before.get("/query/mesh/exchange_bytes", 0.0) + 64
    assert after["/query/mesh/skewed"] == \
        before.get("/query/mesh/skewed", 0.0) + 1


def test_config_bounds_are_the_reference_ones():
    from ytsaurus_tpu_torch.errors import YtError
    assert config.TelemetryConfig().mesh_max_imbalance == \
        ref_config.TelemetryConfig().mesh_max_imbalance
    assert config.CompileConfig().whole_plan_headroom == \
        ref_config.CompileConfig().whole_plan_headroom
    with pytest.raises(YtError):
        config.TelemetryConfig(mesh_max_imbalance=0.5)
    with pytest.raises(YtError):
        config.CompileConfig(whole_plan_headroom=0.9)
    ref_policy = ref_config.retry_policy("query_shard")
    policy = config.retry_policy("query_shard")
    for name in ("attempts", "backoff", "backoff_cap", "jitter"):
        assert getattr(policy, name) == getattr(ref_policy, name)
    import random
    assert policy.delay(2, rng=random.Random(4)) == \
        ref_policy.delay(2, rng=random.Random(4))
