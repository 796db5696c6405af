"""The port's per-query stage split (query/statistics.py STAGE_FIELDS,
utils/tracing.py::stage): each field is the self time of one stage, so the
fields sum to at most the query's wall; `execute_time` runs from the first
shard dispatch to the last count read, less the binding inside, so it
stays under the wall at 8 shard programs; the fields are filled with
tracing off and sampled out; and under torch.profiler each stage is a
range of its own name inside the query's interval."""

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ytsaurus_tpu_torch import client as port_client
from ytsaurus_tpu_torch import config as port_config
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.config import ServingConfig, TracingConfig
from ytsaurus_tpu_torch.query.builder import build_query
from ytsaurus_tpu_torch.query.coordinator import coordinate_and_execute
from ytsaurus_tpu_torch.query.engine.evaluator import Evaluator
from ytsaurus_tpu_torch.query.statistics import (
    MISS_FIELDS,
    STAGE_FIELDS,
    QueryStatistics,
)
from ytsaurus_tpu_torch.query.workload import get_workload_log
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.utils import tracing

torch.set_num_threads(1)

_SCHEMA = TableSchema.make([("k", "int64"), ("g", "int64"), ("v", "double")])
_ROWS = 2000
_QUERIES = [
    "g, sum(v) AS s, count(*) AS c FROM [//st/t] GROUP BY g",
    "g, sum(v) AS s FROM [//st/t] WHERE k % 3 = 0 GROUP BY g WITH TOTALS",
    "k, v FROM [//st/t] WHERE v < 1.0 LIMIT 500",
    "g, sum(w) AS w FROM [//st/t] JOIN [//st/d] USING g GROUP BY g",
]
_STAGE_RANGES = ("query.parse", "query.stage", "evaluator.run_plan",
                 "evaluator.device_wait")


def _rows(part: int) -> list:
    return [{"k": part * _ROWS + i, "g": i % 7, "v": float(i % 100)}
            for i in range(_ROWS)]


@pytest.fixture(scope="module")
def stage_client(tmp_path_factory):
    """A table of 8 chunks and a small dimension table, on the CPU."""
    c = port_client.connect(str(tmp_path_factory.mktemp("stages")),
                            device="cpu")
    for part in range(8):
        c.write_table("//st/t", _rows(part), append=part > 0)
    c.write_table("//st/d", [{"g": g, "w": g * 1.5} for g in range(7)])
    assert len(c.get("//st/t/@chunk_ids")) == 8
    return c


@pytest.fixture
def tracing_defaults():
    yield port_config.set_tracing_config
    port_config.set_tracing_config(None)


def _stages(stats) -> dict:
    return {f: getattr(stats, f) for f in STAGE_FIELDS}


@pytest.mark.parametrize("query", [
    "g, sum(v) AS s, count(*) AS c FROM [//t] GROUP BY g",
    "k, v FROM [//t] WHERE v < 3.0",
    "g, max(v) AS m FROM [//t] WHERE k > 100 GROUP BY g ORDER BY g LIMIT 3"])
def test_execute_time_stays_under_the_wall_at_eight_shards(query):
    """The deferred fan-out: 8 shard programs dispatched, their counts
    read in one transfer. Summing each shard's dispatch-to-read interval
    counted the overlaps several times over and exceeded the wall."""
    chunks = [ColumnarChunk.from_rows(_SCHEMA, _rows(p), device="cpu")
              for p in range(8)]
    plan = build_query(query, {"//t": _SCHEMA})
    evaluator = Evaluator("cpu")
    stats = QueryStatistics()
    t0 = time.perf_counter()
    coordinate_and_execute(plan, chunks, evaluator=evaluator,
                           merge_shards_below=0, stats=stats)
    wall = time.perf_counter() - t0
    assert stats.shards_total == 8
    assert 0 < stats.execute_time <= wall
    assert wall - stats.execute_time - stats.compile_time >= 0
    assert stats.dispatch_time > 0 and stats.device_wait > 0
    assert sum(_stages(stats).values()) <= wall


@pytest.mark.parametrize("query", _QUERIES)
def test_stage_fields_split_the_wall(stage_client, query):
    profile = stage_client.select_rows(query, explain_analyze=True)
    stats = profile.statistics
    split = {f: stats[f] for f in STAGE_FIELDS}
    assert all(seconds >= 0 for seconds in split.values()), split
    assert sum(split.values()) <= profile.wall_time
    assert split["parse_time"] > 0 and split["dispatch_time"] > 0
    assert split["compile_time"] > 0 and split["to_rows_time"] > 0
    assert 0 < stats["execute_time"] <= profile.wall_time
    assert profile.wall_time - stats["execute_time"] - \
        stats["compile_time"] >= 0
    assert 0 <= stats["host_cpu_time"]
    assert (stats["join_time"] > 0) == ("JOIN" in query)
    record = get_workload_log().records()[-1]
    assert record.stages == {**split, "host_cpu_time": stats["host_cpu_time"],
                             **{f: stats[f] for f in MISS_FIELDS},
                             "wall_time": profile.wall_time}


def test_stages_are_timed_with_tracing_off(stage_client, tracing_defaults):
    tracing_defaults(TracingConfig(enabled=False))
    spans = tracing.get_collector().snapshot()
    stage_client.select_rows(_QUERIES[3])
    stats = stage_client.last_query_statistics
    assert tracing.get_collector().snapshot() == spans
    for field in STAGE_FIELDS:
        assert getattr(stats, field) > 0, field
    assert get_workload_log().records()[-1].stages["dispatch_time"] == \
        stats.dispatch_time


@pytest.mark.parametrize("own_thread", [False, True])
def test_stages_are_profiler_ranges_inside_the_query(stage_client,
                                                     own_thread):
    """Under a session on the query's thread, and under one that records
    every thread while the query runs on a thread of its own (as the
    benchmark's streams do)."""
    def query():
        with record_function("test.query"):
            stage_client.select_rows(_QUERIES[0])

    config = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=own_thread)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=config) as prof:
        if own_thread:
            worker = threading.Thread(target=query)
            worker.start()
            worker.join(60)
            assert not worker.is_alive()
        else:
            query()
    ranges = [e for e in prof.events() if e.is_user_annotation]
    (outer,) = [e for e in ranges if e.name == "test.query"]
    for name in _STAGE_RANGES:
        inside = [e for e in ranges if e.name == name]
        assert inside, name
        assert all(outer.time_range.start <= e.time_range.start and
                   e.time_range.end <= outer.time_range.end
                   for e in inside), name


def test_a_stage_opens_no_range_without_a_profiler():
    assert not tracing._profiler_live()
    assert tracing.stage(None, None, "query.parse")._range is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.stage(None, None, "query.parse")._range is not None
        assert tracing.stage(None, None)._range is None


def test_a_stage_counts_its_self_time():
    """A nested stage's seconds leave its parent's field; a stage without
    statistics is transparent."""
    stats = QueryStatistics()
    t0 = time.perf_counter()
    with tracing.stage(stats, "dispatch_time"):
        time.sleep(0.02)
        with tracing.stage(stats, "device_wait"):
            time.sleep(0.03)
        with tracing.stage(None, None, "coordinator.shard"):
            time.sleep(0.01)
    wall = time.perf_counter() - t0
    assert stats.device_wait >= 0.03 and stats.dispatch_time >= 0.03
    assert stats.dispatch_time + stats.device_wait <= wall
    assert stats.staged_seconds == pytest.approx(
        stats.dispatch_time + stats.device_wait)


def test_admission_wait_is_recorded_unsampled(tmp_path, tracing_defaults):
    tracing_defaults(TracingConfig(sample_rate=0.0))
    c = port_client.connect(str(tmp_path), device="cpu")
    c.cluster.serving_config = ServingConfig(slots=1)
    c.write_table("//st/a", [{"k": i} for i in range(10)])
    held, release = threading.Event(), threading.Event()

    def hold(token):
        held.set()
        release.wait(10)

    holder = threading.Thread(target=c.cluster.gateway.run_select,
                              args=(hold,))
    holder.start()
    assert held.wait(10)
    threading.Timer(0.1, release.set).start()
    rows = c.select_rows("k FROM [//st/a]")
    holder.join(10)
    assert not holder.is_alive()
    assert len(rows) == 10
    stats = c.last_query_statistics
    assert stats.admission_wait >= 0.05
    record = get_workload_log().records()[-1]
    assert record.trace_id is None
    assert record.stages["admission_wait"] == stats.admission_wait
