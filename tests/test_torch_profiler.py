"""The port's continuous sampling profiler and span exporter
(ytsaurus_tpu_torch/utils/profiler.py) against the JAX package's: the
reference's own tests (tests/test_profiler.py) run on the port through
`port_twin`, all four, including `test_sampler_reset_and_bounds`, whose
bound the reference breaks (its `"(other)"` entry becomes entry
`max_entries + 1`); and both profilers fed the same stacks keep the same
hit counts wherever the port's bound lets a stack in."""

import sys
import threading
import time

import pytest

from tests.test_torch_client import port_twin, twin_cases
from ytsaurus_tpu.utils import profiler as ref_profiler
from ytsaurus_tpu_torch.utils import profiler

_TWIN = port_twin("test_profiler")
_CASES = twin_cases(_TWIN)


def test_the_twin_holds_every_case():
    assert len(_CASES) == 4


@pytest.mark.parametrize("name", _CASES)
def test_reference_profiler_case_on_the_port(name, tmp_path):
    fn = getattr(_TWIN, name)
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path)
    else:
        fn()


class _Flag:
    done = False

    def set(self):
        self.done = True


def _parked_threads(n: int):
    """n threads, each spinning in a frame of its own (a distinct stack
    that is not an idle wait), and the flag that releases them."""
    release = _Flag()
    started = threading.Barrier(n + 1)
    threads = []
    for i in range(n):
        # Each thread spins in its own code object, with no call into
        # threading.py in its loop (a leaf there counts as idle).
        code = compile(f"def spin_{i}(release, started):\n"
                       f"    started.wait()\n"
                       f"    while not release.done:\n"
                       f"        sum(range(50))\n", f"<spin_{i}>", "exec")
        ns: dict = {}
        exec(code, ns)
        t = threading.Thread(target=ns[f"spin_{i}"],
                             args=(release, started), daemon=True)
        t.start()
        threads.append(t)
    started.wait()
    # Out of the barrier's wait (a leaf in threading.py) and spinning.
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not all(
            sys._current_frames()[t.ident].f_code.co_name.startswith("spin_")
            for t in threads):
        time.sleep(0.001)
    return release, threads


@pytest.mark.parametrize("max_entries", [1, 2, 3, 8])
def test_distinct_stacks_never_exceed_the_bound(max_entries):
    release, threads = _parked_threads(6)
    try:
        port = profiler.SamplingProfiler(max_entries=max_entries)
        for _ in range(20):
            port.sample_once()
        state = port.state()
        assert state["distinct_stacks"] <= max_entries
        # Every sample lands somewhere: the hits add up to the total.
        hits = sum(int(line.rsplit(" ", 1)[1])
                   for line in port.collapsed(top=10_000))
        assert hits == state["total_samples"] > 0
        if max_entries < 6:
            # Six spinning threads are six stacks at least: the ones past
            # the bound land in "(other)".
            assert state["distinct_stacks"] == max_entries
            assert any(line.startswith("(other) ")
                       for line in port.collapsed(top=10_000))
    finally:
        release.set()
        for t in threads:
            t.join(timeout=5)


def test_the_same_stacks_give_the_same_counts_under_the_bound():
    """With room for every stack, the two profilers sampling the same
    frames keep the same table; the port's differs only in holding its
    last slot for "(other)"."""
    release, threads = _parked_threads(3)
    try:
        ref = ref_profiler.SamplingProfiler(max_entries=4096)
        port = profiler.SamplingProfiler(max_entries=4096)
        me = threading.get_ident()
        for _ in range(5):
            # The spinning threads' line numbers move between samples:
            # compare the frames that the samples land in.
            ref.sample_once(exclude_thread=me)
            port.sample_once(exclude_thread=me)
        assert ref.state()["total_samples"] == \
            port.state()["total_samples"]
        assert ref.state()["idle_samples"] == port.state()["idle_samples"]

        def leaves(p):
            return sorted({h["frame"].split(" (")[0] for h in p.hotspots(50)
                           if h["frame"].startswith("spin_")})
        assert leaves(ref) == leaves(port) == ["spin_0", "spin_1", "spin_2"]
    finally:
        release.set()
        for t in threads:
            t.join(timeout=5)
