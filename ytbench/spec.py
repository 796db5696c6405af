"""Finds the benchmark's parts by name.

`BENCHMARK.json`, at the root of the checkout, names the cells
(`workloads`), their configurations and traffic, and the metrics. Every
name leads to files of its own under `ytbench/`:

- `configs/<config>.json`: the deployment (scale, chunks, cache, streams);
  its `data` names the generator module `ytbench/<data>.py`;
- `traffic/<traffic>.json`: the mix of queries the streams send, each
  stream in a closed loop of `select_rows`;
- `queries/<query>.json` (text, substitution slots, columns read) and
  `queries/<query>.py` (its plain reference and comparison);
- `cells/<cell>.json`: the limits `correct` holds the cell's readings to;
- `metrics/<metric>.py`: the reader of one per-layer metric.

A later cell, configuration, query or metric is new files and new
entries in `BENCHMARK.json`; nothing here changes. Traffic of another
kind than closed-loop `select_rows` streams needs a change to the
harness's stream loop.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path):
    name = f"ytbench._by_name.{path.parent.name}.{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    return _json(CHECKOUT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def data_module(cfg: dict):
    return importlib.import_module(f"ytbench.{cfg['data']}")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def cell(name: str) -> dict:
    return _json(HERE / "cells" / f"{name}.json")


def query(name: str) -> dict:
    """The query's file, with its reference module under "module"."""
    q = _json(HERE / "queries" / f"{name}.json")
    q["module"] = _module(HERE / "queries" / f"{name}.py")
    return q


def metric_reader(name: str):
    return _module(HERE / "metrics" / f"{name}.py").read


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list:
    return [m for m in bench["end_to_end"] if _applies(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list:
    """Per-layer metrics that a traced run of the cell reports: those that
    list the cell, and those without a list whose `moves` the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
