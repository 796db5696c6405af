"""No module of ytbench/ brings jax, jaxlib, flax or the JAX package
(ytsaurus_tpu) into sys.modules, top-level names compared whole; and the
run's own check tells the port's name from the JAX package's."""

import subprocess
import sys

from ytbench import run, spec

PROBE = """
import sys
from ytbench import control, harness, run, spec, tpch, trace, arith
bench = spec.benchmark()
for cell in bench["workloads"]:
    harness.plan(cell["name"], 1)
for metric in bench["end_to_end"] + bench["per_layer"]:
    spec.metric_reader(metric["name"])
import ytsaurus_tpu_torch.client
print(",".join(sorted({n.split(".")[0] for n in sys.modules})))
"""


def test_no_jax_is_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=spec.CHECKOUT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = set(out.stdout.strip().split(","))
    assert "ytsaurus_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "ytsaurus_tpu"}


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ytsaurus_tpu_torch_probe", sys)
    assert "ytsaurus_tpu_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ytsaurus_tpu.fake", sys)
    assert run.forbidden_modules() == ["ytsaurus_tpu.fake"]
