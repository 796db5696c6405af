#!/usr/bin/env python3
"""Drive ytsaurus_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0] [--record PATH]

Phases (any failure exits non-zero and prints no result line):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: the hist_rank kernel from csrc/hist_rank.cu, with nvcc;
  3. kernel against its plain version on the card, exactly, at N = 2048,
     8192 and 67,108,864, bits 1, 6 and 8, digits all equal, all 2^bits - 1
     and random; and the kernel's radix argsort against torch.sort(stable)
     on the same keys;
  4. the slice: TPC-H lineitem at 64,000,000 rows (SF ~10.7) made from
     --seed, then select_rows(Q1) and select_rows(Q18_AGG) on the card,
     checked against numpy oracles (Q1: groups and counts exact, doubles to
     rtol=1e-9; Q18_AGG: keys, order, sums and line counts exact). Each
     query runs once with the kernel's launch count set to 0 before it and
     read after it, then REPS more times for its warm time, then once
     under torch.profiler for its device time by kernel and idle share;
  5. the `kernels` line: each kernel's time at the main path's shape, its
     plain version's time, its bound, and its launches on the main path.

The last line of standard output is {"ok": true, "device": {...}}. With
--record, a JSON record of the run is also written to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peak memory rate of one H100 SXM (NVIDIA's data sheet).
H100_BYTES_PER_S = 3.35e12
ROWS = 64_000_000            # lineitem rows: the repo's q1 bench size
MAIN_N = 67_108_864          # pad_capacity(ROWS): the main path's sort width
REPS = 5                     # warm runs per query; the median is reported


def _log(msg: str) -> None:
    print(msg, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of `fn`, by CUDA events around `iters`
    back-to-back calls after `warmup` calls."""
    import torch
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


def _digits(kind: str, n: int, bits: int, gen):
    import torch
    if kind == "equal":
        return torch.zeros(n, dtype=torch.int32, device="cuda")
    if kind == "max":
        return torch.full((n,), (1 << bits) - 1, dtype=torch.int32,
                          device="cuda")
    return torch.randint(0, 1 << bits, (n,), dtype=torch.int32,
                         device="cuda", generator=gen)


def phase_kernel(hr, radix_argsort_u32, seed: int) -> dict:
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0
    for n in (2048, 8192, MAIN_N):
        for bits in (1, 6, 8):
            for kind in ("equal", "max", "random"):
                d = _digits(kind, n, bits, gen)
                counts, rank = hr.hist_rank(d, bits)
                want_counts, want_rank = hr.hist_rank_plain(d, bits)
                torch.cuda.synchronize()
                err = max(int((counts - want_counts).abs().max()),
                          int((rank - want_rank).abs().max()))
                worst = max(worst, err)
                if err:
                    raise AssertionError(
                        f"hist_rank differs from its plain version at "
                        f"N={n} bits={bits} digits={kind}: {err}")
                del d, counts, rank, want_counts, want_rank
        _log(f"hist_rank == plain at N={n}, bits 1/6/8, "
             "digits equal/max/random")
    keys = torch.randint(0, 1 << 32, (MAIN_N,), dtype=torch.int64,
                         device="cuda", generator=gen)
    keys[: MAIN_N // 4] = keys[: MAIN_N // 4] & 0xFF    # many ties
    perm = radix_argsort_u32([keys])
    want = torch.sort(keys, stable=True).indices
    torch.cuda.synchronize()
    if not torch.equal(perm, want):
        raise AssertionError("radix argsort differs from torch.sort(stable)")
    radix_ms = _cuda_ms(lambda: radix_argsort_u32([keys]), iters=3)
    sort_ms = _cuda_ms(lambda: torch.sort(keys, stable=True), iters=3)
    _log(f"radix argsort == torch.sort(stable) on {MAIN_N} u32 keys; "
         f"radix_argsort_u32 {radix_ms:.3f} ms, torch.sort(stable) "
         f"{sort_ms:.3f} ms (yardstick only, not on the port's path)")
    return {"max_abs_err": worst, "argsort_ms": radix_ms,
            "torch_sort_stable_ms": sort_ms}


def _busy_us(spans: list) -> float:
    """Microseconds covered by the union of (start, end) spans, so that
    spans that overlap or repeat are counted once."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def _profile(run, hr) -> dict:
    """One run of `run` under torch.profiler: device time by kernel name
    and by the torch op that launched it, and the device's idle share of
    the wall time (both as seen under the profiler, which slows the host).
    Busy time is the union of the device events' spans; `listed_sum_ms`
    is their plain sum, so that the two show any overlap. Busy time and
    idle share read "not measured" when the trace is empty or lacks a
    hist_rank kernel that the run launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    hr.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    launched = hr.launches
    by_kernel: dict = {}
    spans = []
    traced_hist_rank = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time_total
            spans.append((e.time_range.start, e.time_range.end))
            traced_hist_rank += "hist_rank" in e.name
    listed_us = sum(by_kernel.values())
    busy_us = _busy_us(spans)
    complete = busy_us > 0 and traced_hist_rank == launched
    by_op = sorted(((e.key, e.self_device_time_total, e.count)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CPU
                    and e.self_device_time_total > 0),
                   key=lambda x: -x[1])[:8]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "wall_ms": wall_us / 1e3,
        "hist_rank_launched": launched,
        "hist_rank_traced": traced_hist_rank,
        "listed_sum_ms": listed_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if complete else "not measured",
        "idle_share": 1 - busy_us / wall_us if complete else "not measured",
        "top_kernels_ms": [[name[:90], us / 1e3] for name, us in top],
        "top_ops_self_device_ms": [[key, us / 1e3, count]
                                   for key, us, count in by_op],
    }


def _check_q1(rows: list, oracle: dict) -> None:
    got = {(r["l_returnflag"], r["l_linestatus"]): r for r in rows}
    if set(got) != set(oracle):
        raise AssertionError(f"Q1 groups {sorted(got)} != {sorted(oracle)}")
    for key, want in oracle.items():
        row = got[key]
        if row["count_order"] != want["count_order"]:
            raise AssertionError(f"Q1 {key} count {row['count_order']} != "
                                 f"{want['count_order']}")
        for name, value in want.items():
            if abs(row[name] - value) > 1e-9 * abs(value):
                raise AssertionError(f"Q1 {key} {name} {row[name]!r} != "
                                     f"{value!r} (rtol 1e-9)")


def _check_q18(rows: list, oracle: list) -> None:
    if rows != oracle:
        raise AssertionError(f"Q18_AGG rows differ from the oracle: "
                             f"{rows[:3]} vs {oracle[:3]}")


def phase_slice(seed: int, hr, tpch, select_rows) -> dict:
    import torch
    t0 = time.perf_counter()
    arrays = tpch.lineitem_arrays(ROWS, seed=seed)
    chunk = tpch.lineitem_chunk(arrays, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _log(f"lineitem: {ROWS} rows, capacity {chunk.capacity}, "
         f"{chunk.nbytes / 1e9:.3f} GB on the card, made in {setup_s:.1f} s "
         f"(seed {seed})")
    queries = {
        "q1": (tpch.Q1, _check_q1, tpch.q1_oracle(arrays)),
        "q18_agg": (tpch.Q18_AGG, _check_q18, tpch.q18_agg_oracle(arrays)),
    }
    tables = {"//tpch/lineitem": chunk}
    out = {}
    for name, (query, check, oracle) in queries.items():
        torch.cuda.reset_peak_memory_stats()
        hr.reset_launches()
        result = select_rows(query, tables, device="cuda")
        torch.cuda.synchronize()
        launches = hr.launches
        rows = result.to_rows()
        check(rows, oracle)
        if launches <= 0:
            raise AssertionError(f"{name}: the main path launched no "
                                 "hist_rank kernel")
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            select_rows(query, tables, device="cuda")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated()
        prof = _profile(lambda: select_rows(query, tables, device="cuda"),
                        hr)
        out[name] = {"rows_out": len(rows), "hist_rank_launches": launches,
                     "median_ms": ms, "ms_runs": times,
                     "rows_per_s": ROWS / (ms / 1e3),
                     "peak_bytes": peak, "profile": prof}
        _log(f"{name}: {len(rows)} rows match the oracle; hist_rank "
             f"launches {launches}; warm median {ms:.3f} ms over "
             f"{REPS} runs {[round(x, 3) for x in times]}; "
             f"{ROWS / (ms / 1e3):.0f} rows/s; peak memory "
             f"{peak / 1e9:.3f} GB")
        _log(f"{name} profile: {json.dumps(prof)}")
    del chunk, tables
    torch.cuda.empty_cache()
    return out


def phase_kernel_times(hr, seed: int) -> dict:
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    bits = hr.BITS
    d = _digits("random", MAIN_N, bits, gen)
    ms = _cuda_ms(lambda: hr.hist_rank(d, bits), iters=20)
    plain_ms = _cuda_ms(lambda: hr.hist_rank_plain(d, bits), iters=3)
    # Each digit read once, each rank written once, one counts row per tile.
    nbytes = MAIN_N * 4 + MAIN_N * 4 + (MAIN_N // hr.TILE) * (1 << bits) * 4
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bytes": nbytes}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--record", help="write a JSON record of the run "
                        "to this path")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ytsaurus_tpu_torch import _build
    from ytsaurus_tpu_torch.models import tpch
    from ytsaurus_tpu_torch.ops import hist_rank as hr
    from ytsaurus_tpu_torch.ops.radix import radix_argsort_u32
    from ytsaurus_tpu_torch.query import select_rows

    # 1. environment
    smi = _nvidia_smi()
    _log(smi)
    _log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
         f"{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    _build.load("hist_rank")
    info = _build.build_info["hist_rank"]
    _log(f"built hist_rank in {time.perf_counter() - t0:.2f} s "
         f"(nvcc {info['seconds']:.2f} s)")
    _log(info["log"].strip())

    # 3. kernel against its plain version
    kernel_check = phase_kernel(hr, radix_argsort_u32, args.seed)

    # 4. the slice
    slice_result = phase_slice(args.seed, hr, tpch, select_rows)

    # 5. the kernels line
    times = phase_kernel_times(hr, args.seed)
    launches = {name: q["hist_rank_launches"]
                for name, q in slice_result.items()}
    kernels = {"kernels": [{
        "name": "hist_rank",
        "route": "cuda",
        "source": "ytsaurus_tpu_torch/csrc/hist_rank.cu",
        "replaces": "ytsaurus_tpu/ops/pallas_radix.py:51",
        "launches": sum(launches.values()),
        "launches_per_query": launches,
        "max_abs_err": kernel_check["max_abs_err"],
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": f"N={MAIN_N}, bits={hr.BITS}",
    }]}
    record = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "rows": ROWS,
              "seed": args.seed, "kernel_check": kernel_check,
              "queries": slice_result, "kernels": kernels["kernels"]}
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(record, f, indent=1)
    _log(smi)
    _log(json.dumps(kernels))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
