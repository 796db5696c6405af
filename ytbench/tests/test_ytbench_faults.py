"""A run on the CPU at a tiny size, past the look for a card: sound, it is
correct; with the timed path broken underneath, `correct` comes out
false, once for each fault a query cell can have."""

import pytest

import ytsaurus_tpu_torch.client as client_module
from ytbench.tests.conftest import TINY
from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytbench import harness, run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _correct(cell: str) -> tuple:
    bench = spec.benchmark()
    r = harness.run_cell(cell, 2**32 + 99, 1.0, False, 0.0, device="cpu",
                         config_overrides=TINY, bench=bench)
    out = run.result(r, bench, cell, False, 1)
    assert out["attempted"] > 0
    return out["correct"], out["checks"]


def _half_the_shards(monkeypatch):
    """The coordinator sees half of the source chunks; the other half's
    rows are left out of every answer."""
    real = client_module.coordinate_and_execute

    def half(plan, chunks, foreign, **kwargs):
        return real(plan, chunks[:max(1, len(chunks) // 2)], foreign, **kwargs)
    monkeypatch.setattr(client_module, "coordinate_and_execute", half)


def _altered_value(monkeypatch):
    """A double of each answer's first row is off by one part in a million
    where the rows are produced."""
    real = ColumnarChunk.to_rows

    def altered(self):
        rows = real(self)
        for name, value in (rows[0].items() if rows else ()):
            if isinstance(value, float):
                rows[0][name] = value * (1 + 1e-6)
                break
        return rows
    monkeypatch.setattr(ColumnarChunk, "to_rows", altered)


def _altered_key(monkeypatch):
    """The first row's first integer, a group key, is off by one."""
    real = ColumnarChunk.to_rows

    def altered(self):
        rows = real(self)
        for name, value in (rows[0].items() if rows else ()):
            if isinstance(value, (int, bytes)) and not isinstance(value, bool):
                rows[0][name] = value + 1 if isinstance(value, int) else b"Z"
                break
        return rows
    monkeypatch.setattr(ColumnarChunk, "to_rows", altered)


def _every_other_query_raises(monkeypatch):
    """Once the window opens, every other query dies inside the
    coordinator: its answer never comes."""
    real = client_module.coordinate_and_execute
    real_window = harness.window
    calls = []

    def flaky(plan, chunks, foreign, **kwargs):
        if calls:
            calls.append(1)
            if len(calls) % 2 == 0:
                raise RuntimeError("a shard program died")
        return real(plan, chunks, foreign, **kwargs)

    def window(*args, **kwargs):
        calls.append(1)
        return real_window(*args, **kwargs)
    monkeypatch.setattr(client_module, "coordinate_and_execute", flaky)
    monkeypatch.setattr(harness, "window", window)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    correct, checks = _correct(cell)
    assert correct, checks


@pytest.mark.parametrize("fault", [_half_the_shards, _altered_value,
                                   _altered_key, _every_other_query_raises])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    correct, checks = _correct(cell)
    assert not correct, checks
