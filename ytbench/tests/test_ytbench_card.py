"""On the card, at a tiny size: a traced run of every cell is correct, its
trace holds device time inside the window, and every per-layer metric it
reports is in range. Run there with: python3 -m pytest ytbench/tests -m card"""

import pytest

from ytbench.tests.conftest import TINY
from ytbench import harness, run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_on_the_card(cell, card):
    bench = spec.benchmark()
    r = harness.run_cell(cell, 2**31 + 5, 2.0, True, 0.0, device="cuda",
                         config_overrides=TINY, bench=bench)
    out = run.result(r, bench, cell, True, 1)
    assert out["correct"], out["checks"]
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"]
    metrics = out["metrics"]
    assert 0 <= metrics["device_idle_pct"]["value"] < 100
    assert 0 < metrics["roofline_pct"]["value"] <= 100
    assert metrics["chunk_cache_misses"]["value"] == 0
