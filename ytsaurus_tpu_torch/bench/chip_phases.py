"""Run some of chip_smoke's phases alone on one CUDA card.

    python3 -m ytsaurus_tpu_torch.bench.chip_phases durable queue

from the repo root (the directory that holds `chip_smoke.py`). It builds
the kernels, then calls `chip_smoke.phase_<name>(0, ...)` for each name
given (`dyntable`, `durable`, `queue`: the phases that take the seed and
the port's entry points), with the same checks and logs as a whole
chip_smoke run, and writes their records to `chiprun_out/phases.json`.
Any failure exits non-zero.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    names = sys.argv[1:] or ["durable", "queue"]
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from ytsaurus_tpu_torch import _build
    from ytsaurus_tpu_torch.ops import hist_rank as hr
    from ytsaurus_tpu_torch.ops import radix as rx
    print(cs._nvidia_smi(), flush=True)
    print(cs._host_memory()[0], flush=True)
    _build.load_all(list(cs.TRACE_NAMES))
    port = cs._port_entry_points()
    out = {}
    for name in names:
        t = time.perf_counter()
        out[name] = getattr(cs, f"phase_{name}")(0, hr, rx, port)
        print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "phases.json"), "w") as f:
        json.dump(out, f, default=str, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
