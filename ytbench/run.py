"""Run one cell of the benchmark and print its result.

    python3 -m ytbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With `--trace 0` the result's metrics are
the cell's end-to-end metrics; with `--trace 1` the window runs under
torch.profiler, for the first 15 s of `--seconds` at most, and they are
its per-layer metrics. The last line of
standard output is one JSON object (`correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and `checks` last);
the last lines of standard error are each number compared beside its
limit. Without as many CUDA cards as the cell asks for, it exits with 2
and prints no result; where `jax`, `jaxlib`, `flax` or `ytsaurus_tpu`
(the JAX package) is loaded once the window has closed, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from ytbench import spec  # noqa: E402
from ytbench.harness import checks, passes, run_cell  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ytsaurus_tpu")
# Every build and kernel cache at a fixed path inside the checkout: only a
# checkout's first run builds. The port builds its CUDA and host libraries
# into ytsaurus_tpu_torch/_build/ itself.
CACHE = spec.HERE / "_cache"
CACHE_ENV = {"TRITON_CACHE_DIR": CACHE / "triton",
             "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
             "PYTORCH_KERNEL_CACHE_PATH": CACHE / "torch_kernels"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (ytsaurus_tpu_torch is not ytsaurus_tpu)."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi failed: {err}"


def result(run, bench: dict, cell_name: str, traced: bool,
           chips: int) -> dict:
    wanted = spec.per_layer(bench, cell_name) if traced else \
        spec.end_to_end(bench, cell_name)
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = checks(run.readings, spec.cell(cell_name)["limits"])
    device = {"platform": "gpu", "kind": run.device_kind, "count": chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": all(passes(c) for c in compared.values()),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": [list(kv) for kv in
                                           run.trace["device_ops"]],
                            "idle_gaps": [list(kv) for kv in
                                          run.trace["idle_gaps"]]}
    out["checks"] = compared
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for name, path in CACHE_ENV.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[name] = str(path)

    bench = spec.benchmark()
    entry = spec.workload(bench, args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < entry["chips"]:
        print(f"ytbench: {args.workload} needs {entry['chips']} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    print(f"ytbench device: {torch.cuda.get_device_name(0)} x{found}, "
          f"using {entry['chips']}; nvidia-smi name, power.limit: "
          f"{power_limit()}", flush=True)

    run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   T_START, device="cuda", bench=bench)
    out = result(run, bench, args.workload, bool(args.trace), entry["chips"])
    loaded = forbidden_modules()
    if loaded:
        print(f"ytbench: the process loaded {loaded}", file=sys.stderr)
        return 3
    for error in run.errors:
        print(f"ytbench: a query failed: {error}", file=sys.stderr)
    for name, check in out["checks"].items():
        limit = " ".join(f"{k} {v}" for k, v in check.items() if k != "value")
        print(f"check {name}: {check['value']!r} ({limit})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
