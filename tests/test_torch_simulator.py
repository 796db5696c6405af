"""The port's scheduler simulator (ytsaurus_tpu_torch/operations/
simulator.py, over the port's operations/fair_share.py) against the JAX
package's: the reference's own tests (tests/test_scheduler_sim.py) run on
the port through `port_twin`, all eight, and the same pools and
operations through both packages' `simulate` give equal `SimResult`s."""

import dataclasses
import random

import pytest

from tests.test_torch_client import port_twin, twin_cases
from ytsaurus_tpu.operations import simulator as ref_sim
from ytsaurus_tpu_torch.operations import simulator as sim

_TWIN = port_twin("test_scheduler_sim")
_CASES = twin_cases(_TWIN)


def test_the_twin_holds_every_case():
    assert len(_CASES) == 8


@pytest.mark.parametrize("name", _CASES)
def test_reference_simulator_case_on_the_port(name):
    getattr(_TWIN, name)()


def _workload(module, seed: int):
    rng = random.Random(seed)
    pools = [module.SimPool("prod", weight=3.0, min_share_ratio=0.25),
             module.SimPool("adhoc", weight=1.0),
             module.SimPool("batch", weight=2.0, max_running_jobs=5),
             module.SimPool("tiny", weight=0.5, min_share_ratio=0.1)]
    ops = [module.SimOperation(
        id=f"op{i:03d}", pool=rng.choice([p.name for p in pools]),
        arrival=round(rng.uniform(0, 40), 3),
        n_jobs=rng.randint(1, 60),
        job_duration=round(rng.uniform(0.1, 5.0), 3))
        for i in range(40)]
    return pools, ops


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("preemption", [True, False])
def test_the_same_workload_gives_the_same_result(seed, preemption):
    got = sim.simulate(*_workload(sim, seed), total_slots=12,
                       preemption=preemption)
    want = ref_sim.simulate(*_workload(ref_sim, seed), total_slots=12,
                            preemption=preemption)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.usage_ratio("prod", "adhoc") == \
        want.usage_ratio("prod", "adhoc")


def test_an_unknown_pool_is_refused_alike():
    ops = [sim.SimOperation("x", "nowhere", 0.0, 1, 1.0)]
    with pytest.raises(ValueError) as got:
        sim.simulate([sim.SimPool("a")], ops, total_slots=1)
    ref_ops = [ref_sim.SimOperation("x", "nowhere", 0.0, 1, 1.0)]
    with pytest.raises(ValueError) as want:
        ref_sim.simulate([ref_sim.SimPool("a")], ref_ops, total_slots=1)
    assert str(got.value) == str(want.value)
