"""Every cell, configuration, traffic, query and metric that
BENCHMARK.json names loads by its name, and the names agree."""

import re

import pytest

from ytbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ytbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs_load(entry):
    config = spec.config(entry["name"])
    assert entry["file"] == f"ytbench/configs/{entry['name']}.json"
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    assert set(entry["reduced"]) == set(config["reduced"])
    spec.data_module(config)
    assert config["streams"] >= 1 and config["chunk_cache_bytes"] > 0
    from ytsaurus_tpu_torch.chunks.compression import codec_names
    assert config["codec"] in codec_names()
    assert "codec" in config["assumed"]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cells_load(entry):
    assert NAME.match(entry["name"]) and len(entry["why"]) <= 200
    config = spec.config(entry["config"])
    traffic = spec.traffic(entry["traffic"])
    for name in traffic["cycle"]:
        query = spec.query(name)
        assert set(query["reads"]) <= set(config["tables"])
        for hook in ("answers", "compare", "as_rows"):
            assert callable(getattr(query["module"], hook))
    assert set(traffic) == {"cycle", "why"}
    limits = spec.cell(entry["name"])["limits"]
    assert {"answers", "failed", "wrong_answers", "max_rel_err"} <= set(limits)
    assert spec.end_to_end(BENCH, entry["name"])
    assert spec.per_layer(BENCH, entry["name"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics_load(metric):
    assert NAME.match(metric["name"])
    assert callable(spec.metric_reader(metric["name"]))
    assert metric["better"] in ("lower", "higher")
    if "workloads" in metric:
        names = {w["name"] for w in BENCH["workloads"]}
        assert set(metric["workloads"]) <= names


def test_unique_names():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def _answer(query, sent, done):
    from ytbench.harness import Answer
    return Answer(query, 0, sent, done, [], None, 0.001, 0.0)


@pytest.mark.parametrize("name,want", [("latency_p50_ms", 2000.0),
                                       ("latency_p90_ms", 6200.0)])
def test_latencies_count_the_queries_in_flight_at_the_close(name, want):
    """A query sent inside the window and done after its close is one of
    the window's latencies, timed to when it finished."""
    from ytbench.harness import Run
    answers = [_answer("q1", 0.0, 1.0), _answer("q1", 1.0, 3.0),
               _answer("q1", 3.0, 5.0)]
    late = [_answer("q3", 4.0, 12.0)]
    run = Run(setup_s=1.0, window_s=10.0, answers=answers, late=late,
              rows_read={"q1": 1, "q3": 1}, bytes_read={"q1": 8, "q3": 8},
              cache_misses=0, memory_peak_bytes=0, closed=10.0)
    assert spec.metric_reader(name)(run) == pytest.approx(want)
    assert len(run.sent()) == 4
