"""The two readers of the chunk cache's miss path read the window's
select records only (the last `attempted` of the workload log), sum over
those whose outcome is ok, and give None where the records carry no
miss-path fields, as a program without them writes its records."""

import pytest

from ytbench import spec
from ytbench.harness import Run
from ytsaurus_tpu_torch.config import WorkloadConfig
from ytsaurus_tpu_torch.query import workload

READERS = ("decode_ms_per_query", "copy_ms_per_query")


def _stages(scale: float, misses: bool = True) -> dict:
    out = {"stage_time": 0.5 * scale, "wall_time": 2.0 * scale}
    if misses:
        out.update(chunk_misses=4.0, duplicate_misses=1.0,
                   chunk_read_time=0.02 * scale, decode_time=1.5 * scale,
                   copy_time=0.1 * scale, bytes_staged=2.0e9 * scale)
    return out


def _record(stages: dict, outcome: str = "ok", kind: str = "select"):
    return workload.WorkloadRecord(kind=kind, query="q", outcome=outcome,
                                   stages=stages)


WARM_UP = [_record(_stages(1000.0)) for _ in range(3)]
# The window: two queries done, one that failed, one in flight at the
# close (recorded last, as it finished last).
WINDOW = [_record(_stages(1.0)), _record(_stages(3.0)),
          _record(_stages(50.0), outcome="error"), _record(_stages(2.0))]
# Over the ok queries: decode 1.5 * 6 s, copy 0.1 * 6 s.
EXPECTED = {"decode_ms_per_query": 1.5 * 6 / 3 * 1e3,
            "copy_ms_per_query": 0.1 * 6 / 3 * 1e3}


def _run(attempted: int) -> Run:
    return Run(setup_s=1.0, window_s=15.0, answers=[], late=[],
               rows_read={}, bytes_read={}, cache_misses=0,
               memory_peak_bytes=0, attempted=attempted,
               device_kind="NVIDIA H100 80GB HBM3")


@pytest.fixture
def log(monkeypatch):
    """A private workload log in place of the process's own."""
    private = workload.WorkloadLog(WorkloadConfig())
    monkeypatch.setattr(workload, "get_workload_log", lambda: private)
    return private


def _fill(log, records) -> None:
    for record in records:
        log.observe(record, presampled=True)


@pytest.mark.parametrize("name", READERS)
def test_reads_the_window_only(log, name):
    _fill(log, [*WARM_UP, _record({}, kind="lookup"), *WINDOW])
    got = spec.metric_reader(name)(_run(len(WINDOW)))
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_miss_path_fields(log, name):
    """Records of a program that has the stage split but not the miss
    path's fields."""
    _fill(log, [*WARM_UP, *[_record(_stages(1.0, misses=False))
                            for _ in WINDOW]])
    assert spec.metric_reader(name)(_run(len(WINDOW))) is None


@pytest.mark.parametrize("name", READERS)
def test_none_when_the_log_holds_fewer_records(log, name):
    _fill(log, WINDOW[1:])
    assert spec.metric_reader(name)(_run(len(WINDOW))) is None
    assert spec.metric_reader(name)(_run(0)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_when_no_query_of_the_window_is_ok(log, name):
    _fill(log, [*WARM_UP, *[_record(_stages(1.0), outcome="error")
                            for _ in WINDOW]])
    assert spec.metric_reader(name)(_run(len(WINDOW))) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_is_a_per_layer_metric_of_the_cold_cell_only(name):
    bench = spec.benchmark()
    (metric,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert metric["workloads"] == ["tpch_sf10.cold"]
    assert metric["layer"] == "chunk cache, miss path"
    assert metric["moves"] == "rows_per_s"
    for cell in bench["workloads"]:
        assert (metric in spec.per_layer(bench, cell["name"])) == \
            (cell["name"] == "tpch_sf10.cold")
