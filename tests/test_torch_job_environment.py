"""The port's user-job processes, vanilla operations and failpoints
against the JAX package's: the job environment's limits and failure
classification on the same inputs, and the reference's own tests run on
the port through `port_twin`. The port runs with device="cpu".

Twins and what each leaves out:

- tests/test_job_environment.py (6): all, the exec-node case on a CPU
  `LocalCluster` of the port's daemons (its `jax.config.update` lines
  taken out).
- tests/test_vanilla.py (9): all but
  `test_vanilla_gang_restart_on_any_failure`, which is unsteady in both
  packages: the gang abort can kill the steady job before it writes its
  line, and under a full parallel test run it does.
  `test_gang_restart_is_deterministic` below holds the same guarantee
  with the steady job's write ordered before the flaky job's failure.
  The two remote-copy cases run against a CPU `LocalCluster`.
- tests/test_failpoints.py (14): all, the monitoring case against the
  port's `MonitoringServer`.
"""

import signal

import pytest
import torch

from tests.test_torch_client import call_twin, port_twin, twin_cases
from ytsaurus_tpu.operations import job_environment as ref_env
from ytsaurus_tpu_torch.client import connect
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.operations import job_environment as port_env
from ytsaurus_tpu_torch.utils import failpoints

torch.set_num_threads(1)

_ENV_TWIN = port_twin("test_job_environment", edits={
    '    import jax\n    jax.config.update("jax_platforms", "cpu")\n': ""})
_ENV_CASES = twin_cases(_ENV_TWIN)
_VANILLA_TWIN = port_twin("test_vanilla")
_VANILLA_CASES = twin_cases(_VANILLA_TWIN, exclude={
    # Unsteady: the gang abort races the steady job's write (above).
    "test_vanilla_gang_restart_on_any_failure"})
_FP_TWIN = port_twin("test_failpoints")
_FP_CASES = twin_cases(_FP_TWIN)


def test_twin_lists_hold_every_runnable_case():
    assert len(_ENV_CASES) == 6
    assert len(_VANILLA_CASES) == 9 - 1
    assert len(_FP_CASES) == 14


@pytest.mark.parametrize("name", _ENV_CASES)
def test_reference_job_environment_case_on_the_port(name, tmp_path):
    call_twin(_ENV_TWIN, name, {
        "client": lambda: _ENV_TWIN.connect(str(tmp_path)),
        "tmp_path": tmp_path})


@pytest.mark.parametrize("name", _VANILLA_CASES)
def test_reference_vanilla_case_on_the_port(name, tmp_path):
    call_twin(_VANILLA_TWIN, name, {
        "client": lambda: _VANILLA_TWIN.connect(str(tmp_path)),
        "tmp_path": tmp_path})


@pytest.mark.parametrize("name", _FP_CASES)
def test_reference_failpoints_case_on_the_port(name, tmp_path):
    failpoints.deactivate()
    try:
        call_twin(_FP_TWIN, name, {"tmp_path": tmp_path})
    finally:
        failpoints.deactivate()


# --- parity and the port's own cases ----------------------------------------


_SPECS = [{}, {"memory_limit": 1 << 30}, {"cpu_limit": 2, "nice": 5},
          {"max_open_files": 64, "memory_limit": None, "other": 1}]


@pytest.mark.parametrize("spec", _SPECS)
def test_limits_from_spec_matches_the_reference(spec):
    assert port_env.limits_from_spec(spec) == ref_env.limits_from_spec(spec)


@pytest.mark.parametrize("returncode", [0, 1, -signal.SIGXCPU,
                                        -signal.SIGKILL, -signal.SIGSEGV])
@pytest.mark.parametrize("stderr", [b"", b"MemoryError\n", b"Killed"])
@pytest.mark.parametrize("limits", [None, {"cpu_limit": 1},
                                    {"memory_limit": 1 << 26},
                                    {"cpu_limit": 1, "memory_limit": 1}])
def test_classify_failure_matches_the_reference(returncode, stderr, limits):
    assert port_env.classify_failure(returncode, stderr, limits) == \
        ref_env.classify_failure(returncode, stderr, limits)


def test_gang_restart_is_deterministic(tmp_path):
    """One flaky job's failure restarts the whole gang: the steady task
    runs again. The flaky job fails only after the steady job wrote its
    line, so the gang abort cannot kill the steady job first."""
    client = connect(str(tmp_path / "c"), device="cpu")
    flag, wrote, count = (tmp_path / n for n in ("flag", "wrote", "count"))
    op = client.run_vanilla({
        "flaky": {"job_count": 1,
                  "command": f"if [ ! -f {flag} ]; then i=0; "
                             f"while [ ! -f {wrote} ] && [ $i -lt 6000 ]; "
                             f"do sleep 0.01; i=$((i + 1)); done; "
                             f"touch {flag}; exit 1; fi"},
        "steady": {"job_count": 1,
                   "command": f"echo run >> {count}; touch {wrote}"},
    })
    assert op.state == "completed"
    assert op.result["gang_restarts"] == 1
    assert count.read_text().count("run") == 2


def test_memory_limit_failure_carries_its_probable_cause(tmp_path):
    client = connect(str(tmp_path / "c"), device="cpu")
    with pytest.raises(YtError) as info:
        client.run_vanilla({"hog": {
            "job_count": 1, "memory_limit": 64 << 20,
            "command": "python3 -c 'x = bytearray(1 << 30)'"}},
            max_gang_restarts=0)
    assert "memory limit exceeded" in str(info.value.to_dict())


def test_remote_copy_names_its_module(tmp_path):
    """Remote copy is ported (its cluster cases are the vanilla twins
    above): from a cluster that does not answer it raises the transport
    error naming the address, not a "not ported" error."""
    client = connect(str(tmp_path / "c"), device="cpu")
    with pytest.raises(YtError, match="127.0.0.1:1") as info:
        client.run_remote_copy("127.0.0.1:1", "//src", "//dst")
    assert "not ported" not in str(info.value)
