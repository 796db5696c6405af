"""The port's trace spans, EXPLAIN ANALYZE profiles and flight recorder
against the JAX package's: the reference's own tests
(tests/test_flight_recorder.py) run on the port, `format_profile_dict`
renders the same dict to the same text in both packages, and EXPLAIN
ANALYZE of the same select renders alike with the times masked.

The port compiles nothing: its profile's compile time is the binding's
seconds (lowering.prepare), it has no compile-cache counters, its
execution tier is "eager", and no `evaluator.compile` span is opened.
It adds the spans of its query stages (`query.parse`, `query.stage`,
`evaluator.device_wait`). Those are masked; every other line and span
name is the reference's.

The RPC server and channel cases run on the port's `rpc/`, and the CLI
case (`yt select-rows --explain-analyze`, `yt trace`) on the port's
`cli.py`. Left out of the twins: the `/traces` endpoint and orchid
views and the multi-hop remote driver (their daemon-side twins are in
tests/test_torch_daemons.py), the distributed select, and the
compile-cache case, which the port twins below."""

import re
import time

import pytest
import torch

from tests.test_torch_client import call_twin, port_twin, twin_cases
from ytsaurus_tpu import client as ref_client
from ytsaurus_tpu.query.profile import format_profile_dict as ref_format
from ytsaurus_tpu.schema import TableSchema as RefSchema
from ytsaurus_tpu_torch import client as port_client
from ytsaurus_tpu_torch import config as port_config
from ytsaurus_tpu_torch.query.profile import (
    ExecutionProfile,
    format_profile_dict,
    format_span_tree,
    get_flight_recorder,
)
from ytsaurus_tpu_torch.schema import TableSchema

torch.set_num_threads(1)

_TWIN = port_twin("test_flight_recorder")
_CASES = twin_cases(_TWIN, exclude={
    "test_traces_endpoint_round_trip", "test_orchid_flight_recorder_views",
    "test_multihop_remote_driver_trace",
    "test_explain_analyze_distributed_select",
    "test_explain_analyze_compile_vs_cache_hit"})


@pytest.fixture
def tracing_defaults():
    yield port_config.set_tracing_config
    port_config.set_tracing_config(None)
    get_flight_recorder().clear()


def _flight(client, Schema):
    schema = Schema.make(
        [("k", "int64", "ascending"), ("g", "int64"), ("v", "int64")],
        unique_keys=True)
    client.create("table", "//fr/t",
                  attributes={"schema": schema, "dynamic": True,
                              "pivot_keys": [[100], [200]]},
                  recursive=True)
    client.mount_table("//fr/t")
    client.insert_rows("//fr/t", [{"k": i, "g": i % 5, "v": i}
                                  for i in range(300)])
    return client


@pytest.fixture(scope="module")
def flight_cluster(tmp_path_factory):
    return _flight(port_client.connect(
        str(tmp_path_factory.mktemp("flight")), device="cpu"), TableSchema)


@pytest.mark.parametrize("name", _CASES)
def test_reference_flight_recorder_case_on_the_port(name, request):
    fixtures = {}
    for param in ("tracing_defaults", "flight_cluster", "capsys"):
        fixtures[param] = request.getfixturevalue(param) \
            if param in _fixture_names(name) else None
    call_twin(_TWIN, name, fixtures)


def _fixture_names(name):
    import inspect
    return set(inspect.signature(getattr(_TWIN, name)).parameters)


def _walk(nodes):
    for node in nodes:
        yield node
        yield from _walk(node.get("children") or [])


def test_explain_analyze_span_tree_on_the_port(flight_cluster):
    """The reference's distributed EXPLAIN ANALYZE case, less its
    `/traces` endpoint: one trace from admission through the shards and
    the evaluator to the tablet reads, every parent in the trace."""
    profile = flight_cluster.select_rows(
        "g, sum(v) AS s FROM [//fr/t] GROUP BY g", explain_analyze=True)
    assert sorted(r["g"] for r in profile.rows) == list(range(5))
    assert profile.compile_time > 0.0 and profile.execute_time > 0.0
    assert profile.wall_time >= profile.compile_time
    (root,) = profile.span_tree()
    assert root["name"] == "query.select"
    by_name: dict = {}
    for node in _walk([root]):
        by_name.setdefault(node["name"], []).append(node)
    assert "serving.admission" in by_name
    shards = by_name["coordinator.shard"]
    assert all(isinstance(n["tags"]["shard"], int) for n in shards)
    assert all(n["tags"]["attempt"] == 0 for n in shards)
    evals = by_name["evaluator.run_plan"]
    assert all(set(n["tags"]) == {"rows"} for n in evals)
    for name in ("query.parse", "query.stage", "evaluator.device_wait"):
        assert name in by_name, name
    assert all(n["tags"]["snapshot_cache"] in ("hit", "miss", "bypass")
               for n in by_name["tablet.read_snapshot"])
    assert "evaluator.compile" not in by_name
    ids = {n["span_id"] for n in _walk([root])}
    for node in _walk([root]):
        if node is not root:
            assert node["parent_span_id"] in ids
        assert node["trace_id"] == profile.trace_id


def test_explain_analyze_compile_fields_on_the_port(flight_cluster):
    """The reference's compile-vs-cache-hit case, with the port's compile
    fields: no program is compiled or cached, so there are no cache
    counters; every run binds, and its binding is one of its stages."""
    query = "g, count(*) AS c FROM [//fr/t] WHERE v < 250 GROUP BY g"
    for _ in range(2):
        profile = flight_cluster.select_rows(query, explain_analyze=True)
        assert "compile_count" not in profile.statistics
        assert "cache_hits" not in profile.statistics
        assert profile.statistics["execution_tier"] == "eager"
        assert profile.compile_time > 0.0
        assert profile.compile_time == profile.statistics["compile_time"]
        assert profile.execute_time + profile.compile_time <= \
            profile.wall_time


_FULL_PROFILE = {
    "query": "g, sum(v) FROM [//t] JOIN [//d] USING g GROUP BY g",
    "trace_id": "ab" * 16, "pool": "prod", "user": "alice",
    "wall_time": 0.25, "admission_wait": 0.0125, "compile_time": 0.005,
    "execute_time": 0.1875,
    "statistics": {
        "rows_read": 1000, "rows_written": 7, "shards_total": 4,
        "shards_pruned": 1, "shards_skipped": 2, "cache_hits": 3,
        "compile_count": 1, "execution_tier": "eager",
        "execution_encoding": "encoded", "compile_new_shape": 1,
        "capacity_buckets": [1024, 4096], "whole_plan": 1,
        "whole_plan_retries": 2,
        "join_plan": [{"table": "//d", "strategy": "broadcast",
                       "est_rows": 100, "actual_rows": 250}, None],
        "mesh_blocks": [{"path": "fused", "shards": 4,
                         "out_rows": [1, 5, 2, 9], "skew": 2.4,
                         "exchanges": [{"stage": "group", "rows": 17,
                                        "bytes": 136, "quota": 32,
                                        "demand": 20,
                                        "headroom": 1.6}],
                         "memory_watermark_bytes": 4096}]},
    "span_tree": [{"name": "query.select", "duration": 0.25,
                   "tags": {"pool": "prod"},
                   "children": [{"name": "serving.admission",
                                 "duration": 0.0125, "tags": {},
                                 "children": []}]}],
}


def _without_compile_cache(text: str) -> str:
    """The reference's EXPLAIN ANALYZE text less what the port has no
    counters for: the compile cache's hits and misses and the miss
    causes; the capacity buckets stay where there are any."""
    text = re.sub(r"; compile cache \d+ hits / \d+ misses", "", text)
    text = re.sub(r"compile misses: .*; (capacity buckets \[.+\])",
                  r"\1", text)
    return re.sub(r"compile misses: .*; capacity buckets \[\]\n", "",
                  text)


@pytest.mark.parametrize("drop", [None, "statistics", "span_tree",
                                  "trace_id"])
def test_format_profile_dict_renders_as_the_reference(drop):
    profile = dict(_FULL_PROFILE)
    if drop is not None:
        profile.pop(drop)
    assert format_profile_dict(profile) == \
        _without_compile_cache(ref_format(profile))


def test_format_span_tree_indents_as_the_reference():
    from ytsaurus_tpu.query.profile import format_span_tree as ref_tree
    tree = _FULL_PROFILE["span_tree"]
    assert format_span_tree(tree) == ref_tree(tree)
    assert format_span_tree(tree)[1].startswith("  - serving.admission")


_MS = re.compile(r"\d+\.\d+ms")
_HEX = re.compile(r"[0-9a-f]{32}")
# Spans one package has and the other has not.
_UNSHARED_SPANS = {"evaluator.compile", "query.parse", "query.stage",
                   "evaluator.device_wait"}


def _masked(text: str) -> list:
    """EXPLAIN ANALYZE text with times, trace ids, the compile tier lines
    and the compile cache's counts masked; the span lines keep their
    names only."""
    out = []
    for line in text.split("\n"):
        if line.startswith(("execution tier:", "compile misses:")):
            continue
        line = _MS.sub("<ms>", _HEX.sub("<trace>", line))
        line = re.sub(r"; compile cache \d+ hits / \d+ misses", "", line)
        out.append(line)
    head, _, spans = "\n".join(out).partition("spans:")
    names = sorted({m.group(1) for m in
                    re.finditer(r"- ([a-z_.]+) <ms>", spans)})
    return head.split("\n") + [n for n in names if n not in _UNSHARED_SPANS]


@pytest.mark.parametrize("query", [
    "g, sum(v) AS s FROM [//fr/t] GROUP BY g",
    "k, v FROM [//fr/t] WHERE k > 250 ORDER BY k LIMIT 5"])
def test_explain_analyze_renders_as_the_reference(tmp_path, query):
    ref = _flight(ref_client.connect(str(tmp_path / "ref")), RefSchema)
    port = _flight(port_client.connect(str(tmp_path / "port"),
                                       device="cpu"), TableSchema)
    want = ref.select_rows(query, explain_analyze=True)
    got = port.select_rows(query, explain_analyze=True)
    assert sorted(map(repr, got.rows)) == sorted(map(repr, want.rows))
    assert _masked(got.format()) == _masked(want.format())
    assert "spans:" in got.format()


def test_flight_recorder_keeps_profiles_without_rows(tracing_defaults):
    tracing_defaults(port_config.TracingConfig(slow_query_threshold=0.0))
    rec = get_flight_recorder()
    rec.clear()
    profile = ExecutionProfile(
        query="q", trace_id=None, pool="default", started_at=time.time(),
        wall_time=0.5, admission_wait=0.0, compile_time=0.0,
        execute_time=0.5, statistics={}, rows=[{"a": 1}])
    rec.observe(profile)
    (kept,) = rec.slow_queries()
    assert kept.rows is None and profile.rows == [{"a": 1}]
    assert rec.snapshot()["slow_queries"][0]["query"] == "q"
