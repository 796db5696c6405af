"""Time design variants of the one-sweep radix pass on one CUDA card.

    python3 -m ytsaurus_tpu_torch.bench.onesweep_variants [--n 67108864]

Each variant is the committed `csrc/radix_onesweep.cu` (with
`csrc/tile_rank.cuh`) changed by one text substitution, built with nvcc
(one process each, all at once) and timed by CUDA events at every tile
layout, on random u32 keys and the 8-bit digit at shift 0:

  committed         the source as it is;
  release_acquire   the look-back's status words stored with st.release and
                    loaded with ld.acquire instead of relaxed accesses;
  two_barrier_rank  the rank step as hist_rank first had it: every peer
                    reads the warp's running count, a __syncwarp, the lowest
                    peer writes it, a __syncwarp (no atomic, no shuffle);
  regs_64, regs_128, regs_255
                    __launch_bounds__ allowing 4, 2 or 1 blocks per SM
                    (at most 64, 128 or 255 registers a thread) instead of 3;
  no_lookback       an ablation: every tile takes a zero prefix and waits
                    for no other tile. Its output is wrong; its time is the
                    pass without the look-back's waits.

Each variant's output is compared with the plain version's (exact). The
last line of standard output is one JSON object with every time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ytsaurus_tpu_torch import _build
from ytsaurus_tpu_torch.ops import radix as rx

_LB = "__launch_bounds__(kThreads, 3)"
_RANK_STEP = """        const int leader = __ffs(peers) - 1;
        int old = 0;
        if (lane == leader) {
            old = atomicAdd(&counts.warp[warp][d], __popc(peers));
        }
        ranks[s] = __shfl_sync(0xffffffffu, old, leader) + before;"""
_TWO_BARRIER_STEP = """        const int running = counts.warp[warp][d];
        __syncwarp();
        if (before == 0) {
            counts.warp[warp][d] = running + __popc(peers);
        }
        __syncwarp();
        ranks[s] = running + before;"""
# variant -> (substitutions in radix_onesweep.cu, in tile_rank.cuh)
VARIANTS = {
    "committed": ([], []),
    "release_acquire": ([("st.relaxed.gpu", "st.release.gpu"),
                         ("ld.relaxed.gpu", "ld.acquire.gpu")], []),
    "two_barrier_rank": ([], [(_RANK_STEP, _TWO_BARRIER_STEP)]),
    "regs_64": ([(_LB, "__launch_bounds__(kThreads, 4)")], []),
    "regs_128": ([(_LB, "__launch_bounds__(kThreads, 2)")], []),
    "regs_255": ([(_LB, "__launch_bounds__(kThreads)")], []),
    "no_lookback": ([("if (tile == 0) {", "if (true) {")], []),
}


def _substituted(text: str, subs: list) -> str:
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"variant substitution not found: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _build_all(workdir: Path) -> dict:
    """Every variant's shared library, built at once; the ptxas report of
    each (registers, spills, shared memory per layout) beside it."""
    one = (_build.CSRC / "radix_onesweep.cu").read_text()
    rank = (_build.CSRC / "tile_rank.cuh").read_text()
    procs = {}
    for name, (one_subs, rank_subs) in VARIANTS.items():
        d = workdir / name
        d.mkdir()
        (d / "radix_onesweep.cu").write_text(_substituted(one, one_subs))
        (d / "tile_rank.cuh").write_text(_substituted(rank, rank_subs))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "radix_onesweep.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        report = re.findall(r"kernelILi(\d+)E[^\n]*\n[^\n]*\n[^\n]*?(\d+) "
                            r"bytes spill stores[^\n]*\n[^\n]*?Used (\d+) "
                            r"registers[^\n]*?(\d+) bytes smem", log)
        fn = ctypes.CDLL(str(workdir / name / "lib.so")).radix_onesweep_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = (fn, {f"256x{i}": {"spill_bytes": int(s), "registers":
                                        int(r), "smem_bytes": int(m)}
                           for i, s, r, m in report})
    return libs


def _cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=1 << 26)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("onesweep_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    n = args.n
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = _build_all(Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        word = torch.randint(0, 1 << 32, (n,), dtype=torch.int64,
                             device="cuda", generator=gen)
        key, hist = rx.radix_upsweep(word, None, rx.MAX_POSITIONS)
        bin_start = (torch.cumsum(hist, 1, dtype=torch.int32) - hist)[0]
        val = torch.arange(n, dtype=torch.int32, device="cuda")
        want_key, want_val = rx.radix_onesweep_plain(key, val, 0)
        key_out = torch.empty_like(key)
        val_out = torch.empty_like(val)
        status = torch.zeros(-(-n // (rx.THREADS * min(rx.LAYOUTS)))
                             * rx.BINS + 1, dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        out = {"device": smi, "n": n, "variants": {}}
        for name, (fn, report) in libs.items():
            for items in rx.LAYOUTS:
                def run():
                    status.zero_()
                    err = fn(key.data_ptr(), val.data_ptr(),
                             key_out.data_ptr(), val_out.data_ptr(),
                             bin_start.data_ptr(), status.data_ptr(), n, 0,
                             items, stream)
                    if err:
                        raise SystemExit(f"{name} launch failed: {err}")
                run()
                torch.cuda.synchronize()
                exact = torch.equal(key_out, want_key) and \
                    torch.equal(val_out, want_val)
                ms = _cuda_ms(run)
                layout = f"256x{items}"
                out["variants"].setdefault(name, {})[layout] = {
                    "ms": ms, "exact": exact, **report.get(layout, {})}
                print(f"{name:17s} {layout:7s} {ms:.4f} ms exact={exact} "
                      f"{report.get(layout)}", flush=True)
        out["status_zero_ms"] = _cuda_ms(lambda: status.zero_())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
