"""The six readers of the program's per-query stage split read the
window's select records only (the last `attempted` of the workload log,
after the warm-up's), average over those whose outcome is ok, and give
None where the log holds fewer records or the records carry no split."""

import pytest

from ytbench import spec
from ytbench.harness import Run
from ytsaurus_tpu_torch.config import WorkloadConfig
from ytsaurus_tpu_torch.query import workload

FIELD = {"parse_ms_per_query": "parse_time",
         "stage_ms_per_query": "stage_time",
         "join_ms_per_query": "join_time",
         "dispatch_ms_per_query": "dispatch_time",
         "device_wait_ms_per_query": "device_wait"}
READERS = [*FIELD, "host_cpu_pct"]


def _stages(scale: float) -> dict:
    return {"admission_wait": 0.001 * scale, "parse_time": 0.002 * scale,
            "stage_time": 0.003 * scale, "compile_time": 0.004 * scale,
            "join_time": 0.005 * scale, "dispatch_time": 0.006 * scale,
            "device_wait": 0.007 * scale, "to_rows_time": 0.008 * scale,
            "host_cpu_time": 0.009 * scale, "wall_time": 0.05 * scale}


def _record(stages: dict, outcome: str = "ok", kind: str = "select"):
    return workload.WorkloadRecord(kind=kind, query="q", outcome=outcome,
                                   stages=stages)


WARM_UP = [_record(_stages(1000.0)) for _ in range(4)]
# The window: two queries done, one that failed, one in flight at the
# close (recorded last, as it finished last).
WINDOW = [_record(_stages(1.0)), _record(_stages(3.0)),
          _record(_stages(50.0), outcome="error"), _record(_stages(2.0))]


def _expected(name: str) -> float:
    ok = [r.stages for r in WINDOW if r.outcome == "ok"]
    if name == "host_cpu_pct":
        return sum(s["host_cpu_time"] for s in ok) / sum(
            s["wall_time"] - s["device_wait"] - s["admission_wait"]
            for s in ok) * 100
    return sum(s[FIELD[name]] for s in ok) / len(ok) * 1e3


def _run(attempted: int) -> Run:
    return Run(setup_s=1.0, window_s=15.0, answers=[], late=[],
               rows_read={}, bytes_read={}, cache_misses=0,
               memory_peak_bytes=0, attempted=attempted)


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
    assert got == pytest.approx(_expected(name), rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_none_when_the_log_holds_fewer_records(log, name):
    _fill(log, WINDOW[1:])
    assert spec.metric_reader(name)(_run(len(WINDOW))) is None
    assert spec.metric_reader(name)(_run(0)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_stage_split(log, name):
    """Records without the split, as a program without it writes them."""
    _fill(log, [*WARM_UP, *[_record({}) for _ in WINDOW]])
    assert spec.metric_reader(name)(_run(len(WINDOW))) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_is_a_per_layer_metric_of_every_cell(name):
    bench = spec.benchmark()
    (metric,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert "workloads" not in metric and metric["moves"] == "rows_per_s"
    for cell in bench["workloads"]:
        assert metric in spec.per_layer(bench, cell["name"])
