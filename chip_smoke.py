#!/usr/bin/env python3
"""Drive ytsaurus_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0] [--record PATH]

Phases (any failure exits non-zero and prints no result line):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: every kernel source of the port (csrc/hist_rank.cu,
     csrc/radix_upsweep.cu, csrc/radix_onesweep.cu), one nvcc each, all
     started together;
  3. each kernel against its plain version on the card, exactly:
     hist_rank at N = 2048, 8192 and 67,108,864, bits 1, 6 and 8;
     radix_upsweep (with and without a permutation) and radix_onesweep
     (every tile layout, every digit position) at N = 2048, 10,000 and
     67,108,864; digits all equal, all 255 (all 2^bits - 1) and random.
     Then the radix argsort against torch.sort(stable=True) on 67,108,864
     single-word keys with ties and on 67,108,864 two-word keys (int64
     below 2^40, so three of eight digit passes are constant and skipped);
  4. the slice: TPC-H lineitem at 64,000,000 rows (SF ~10.7) made from
     --seed, then select_rows(Q1) and select_rows(Q18_AGG) on the card,
     checked against numpy oracles (Q1: groups and counts exact, doubles to
     rtol=1e-9; Q18_AGG: keys, order, sums and line counts exact); then
     TPC-H Q3, the lineitem chunk joined with 16,000,000 orders (seed 1):
     the 10 order keys and their order exact, revenue to rtol=1e-9 (two
     orders whose oracle revenues lie within that tolerance may swap);
     then the window query of the repo's window benchmark over 64,000,000
     rows in 1000 partitions made from --seed: the running sum and the rank
     exact, in the input's row order. Each query runs once with every
     kernel's launch count set to 0 before it and read after it (it fails
     unless radix_upsweep and radix_onesweep were launched), then REPS more
     times for its warm time, then once under torch.profiler for its device
     time by kernel and idle share (it fails unless the trace holds as many
     kernels of each port kernel as were launched); Q3's profile also gives
     the device time of the join's phases (foreign sort, binary search,
     materialization);
  5. the `kernels` line: each kernel's time at the main path's shape (the
     one-sweep pass at every tile layout), its plain version's time, its
     bound, a library call's time where one PyTorch call computes the same
     function, and its launches on the main path.

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
ORDERS = 16_000_000          # orders rows: Q3's n_orders at ROWS lines
ORDERS_SEED = 1              # the reference generator's default seed
WINDOW_ROWS = 64_000_000     # rows of the window query
MAIN_N = 67_108_864          # pad_capacity(ROWS): the main path's sort width
REPS = 5                     # warm runs per query; the median is reported
M32 = 0xFFFFFFFF
# Each port kernel by its wrapper's name, and the name of its CUDA kernel
# in a profiler trace.
TRACE_NAMES = {"hist_rank": "hist_rank_kernel",
               "radix_upsweep": "radix_upsweep_kernel",
               "radix_onesweep": "radix_onesweep_kernel"}
# The kernels that every query's sorts go through. hist_rank keeps the
# Pallas kernel's interface and is checked against its plain version, but
# the main path ranks its tiles inside radix_onesweep.
PATH_KERNELS = ("radix_upsweep", "radix_onesweep")
# Profiler ranges of a join's phases (query/engine/joins.py).
JOIN_RANGES = ("join.sort_foreign", "join.search", "join.materialize")


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


def _words(kind: str, n: int, gen):
    """u32 sort words (int64): every digit equal (0x5A), every digit 255,
    or random."""
    import torch
    if kind == "equal":
        return torch.full((n,), 0x5A5A5A5A, dtype=torch.int64, device="cuda")
    if kind == "max":
        return torch.full((n,), M32, dtype=torch.int64, device="cuda")
    return torch.randint(0, 1 << 32, (n,), dtype=torch.int64, device="cuda",
                         generator=gen)


def _launches(hr, rx) -> dict:
    return {"hist_rank": hr.launches, **rx.launches}


def _reset_launches(hr, rx) -> None:
    hr.reset_launches()
    rx.reset_launches()


def _exact(name: str, got, want) -> int:
    """0 when the tensors are equal; raises otherwise."""
    import torch
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        diff = "shape" if got.shape != want.shape else \
            int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        raise AssertionError(f"{name} differs from its plain version: {diff}")
    return 0


def phase_hist_rank(hr, gen) -> int:
    """The largest difference between hist_rank and its plain version (0,
    or this raises)."""
    worst = 0
    for n in (2048, 8192, MAIN_N):
        for bits in (1, 6, 8):
            for kind in ("equal", "max", "random"):
                d = _digits(kind, n, bits, gen)
                counts, rank = hr.hist_rank(d, bits)
                want_counts, want_rank = hr.hist_rank_plain(d, bits)
                where = f"hist_rank at N={n} bits={bits} digits={kind}"
                worst = max(worst, _exact(where, counts, want_counts),
                            _exact(where, rank, want_rank))
                del d, counts, rank, want_counts, want_rank
        _log(f"hist_rank == plain at N={n}, bits 1/6/8, "
             "digits equal/max/random")
    return worst


def phase_radix_kernels(rx, gen) -> dict:
    """The largest difference between each radix kernel and its plain
    version (0, or this raises)."""
    import torch
    worst = {"radix_upsweep": 0, "radix_onesweep": 0}
    for n in (2048, 10_000, MAIN_N):
        perm = torch.randperm(n, device="cuda", generator=gen
                              ).to(torch.int32)
        for kind in ("equal", "max", "random"):
            w = _words(kind, n, gen)
            for p in (None, perm):
                got = rx.radix_upsweep(w, p, rx.MAX_POSITIONS)
                want = rx.radix_upsweep_plain(w, p, rx.MAX_POSITIONS)
                where = (f"radix_upsweep at N={n} words={kind} "
                         f"perm={'none' if p is None else 'random'}")
                worst["radix_upsweep"] = max(worst["radix_upsweep"],
                                             _exact(where, got[0], want[0]),
                                             _exact(where, got[1], want[1]))
            key, hist = rx.radix_upsweep(w, None, rx.MAX_POSITIONS)
            bin_start = torch.cumsum(hist, 1, dtype=torch.int32) - hist
            for pos in range(rx.MAX_POSITIONS):
                shift = rx.DIGIT_BITS * pos
                want = rx.radix_onesweep_plain(key, perm, shift)
                for items in rx.LAYOUTS:
                    got = rx.radix_onesweep(key, perm, shift, bin_start[pos],
                                            items=items)
                    where = (f"radix_onesweep at N={n} digits={kind} "
                             f"shift={shift} items={items}")
                    worst["radix_onesweep"] = max(
                        worst["radix_onesweep"],
                        _exact(where, got[0], want[0]),
                        _exact(where, got[1], want[1]))
                del want, got
            del w, key, hist, bin_start
        _log(f"radix_upsweep == plain at N={n} (permutation none/random), "
             f"radix_onesweep == plain at N={n} (shifts 0/8/16/24, items "
             f"{'/'.join(map(str, rx.LAYOUTS))}); digits equal/max/random")
    return worst


def phase_argsort(rx, gen) -> dict:
    import torch
    keys = torch.randint(0, 1 << 32, (MAIN_N,), dtype=torch.int64,
                         device="cuda", generator=gen)
    keys[: MAIN_N // 4] &= 0xFF                          # many ties
    perm = rx.radix_argsort_u32([keys])
    want = torch.sort(keys, stable=True).indices
    torch.cuda.synchronize()
    if not torch.equal(perm, want):
        raise AssertionError("radix argsort differs from torch.sort(stable) "
                             "on one-word keys")
    # Two words of an int64 key below 2^40: the high word's digits 1-3 are
    # zero in every row, so three of the eight passes are skipped.
    wide = torch.randint(0, 1 << 40, (MAIN_N,), dtype=torch.int64,
                         device="cuda", generator=gen)
    rx.reset_launches()
    perm = rx.radix_argsort_u32([wide >> 32, wide & M32])
    torch.cuda.synchronize()
    passes = dict(rx.launches)
    want = torch.sort(wide, stable=True).indices
    torch.cuda.synchronize()
    if not torch.equal(perm, want):
        raise AssertionError("radix argsort differs from torch.sort(stable) "
                             "on two-word keys")
    if passes != {"radix_upsweep": 2, "radix_onesweep": 5}:
        raise AssertionError(f"two-word keys below 2^40 took {passes}, not "
                             "2 upsweeps and 5 one-sweep passes")
    del wide, perm, want
    radix_ms = _cuda_ms(lambda: rx.radix_argsort_u32([keys]), iters=5)
    sort_ms = _cuda_ms(lambda: torch.sort(keys, stable=True), iters=5)
    _log(f"radix argsort == torch.sort(stable) on {MAIN_N} one-word keys "
         f"and on {MAIN_N} two-word keys (3 constant passes skipped: "
         f"{passes}); radix_argsort_u32 {radix_ms:.4f} ms, "
         f"torch.sort(stable) {sort_ms:.4f} ms on the one-word keys")
    return {"argsort_ms": radix_ms, "torch_sort_stable_ms": sort_ms,
            "two_word_launches": passes}


def _profile(run, hr, rx, ranges=()) -> dict:
    """One run of `run` under torch.profiler: device time by kernel name
    and by the torch op that launched it, and the device's idle share of
    the wall time (both as seen under the profiler, which slows the host).
    Busy time is the union of the device events' spans; `listed_sum_ms` is
    their plain sum, so that the two show any overlap. Raises unless the
    trace holds as many kernels of each port kernel as the run launched.
    For each profiler range named in `ranges`, the device time of the
    kernels launched inside it and its share of the busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    _reset_launches(hr, rx)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    launched = _launches(hr, rx)
    by_kernel: dict = {}
    spans = []
    traced = dict.fromkeys(TRACE_NAMES, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time_total
            spans.append((e.time_range.start, e.time_range.end))
            for kernel, trace_name in TRACE_NAMES.items():
                traced[kernel] += trace_name in e.name
    if traced != launched:
        raise AssertionError(f"the trace holds {traced} port kernels, the "
                             f"run launched {launched}")
    listed_us = sum(by_kernel.values())
    busy_us = _busy_us(spans)
    if busy_us <= 0:
        raise AssertionError("the trace holds no device time")
    by_op = sorted(((e.key, e.self_device_time_total, e.count)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CPU
                    and e.self_device_time_total > 0),
                   key=lambda x: -x[1])[:8]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    port_ms = {kernel: sum(us for name, us in by_kernel.items()
                           if trace_name in name) / 1e3
               for kernel, trace_name in TRACE_NAMES.items()}
    in_range = {name: 0.0 for name in ranges}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in in_range:
            in_range[e.name] += e.device_time_total
    if ranges and not any(in_range.values()):
        raise AssertionError(f"the trace shows no device time in the "
                             f"ranges {list(ranges)}")
    return {
        "ranges_ms": {name: us / 1e3 for name, us in in_range.items()},
        "ranges_share": {name: us / busy_us
                         for name, us in in_range.items()},
        "wall_ms": wall_us / 1e3,
        "launched": launched,
        "traced": traced,
        "port_kernels_ms": port_ms,
        "listed_sum_ms": listed_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1 - busy_us / wall_us,
        "top_kernels_ms": [[name[:90], us / 1e3] for name, us in top],
        "top_ops_self_device_ms": [[key, us / 1e3, count]
                                   for key, us, count in by_op],
    }


def _busy_us(spans: list) -> float:
    """Microseconds covered by the union of (start, end) spans, so that
    spans that overlap or repeat are counted once."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def _check_q1(result, oracle: dict) -> int:
    rows = result.to_rows()
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
    return len(rows)


def _check_q18(result, oracle: list) -> int:
    rows = result.to_rows()
    if rows != oracle:
        raise AssertionError(f"Q18_AGG rows differ from the oracle: "
                             f"{rows[:3]} vs {oracle[:3]}")
    return len(rows)


def _check_q3(result, oracle: list) -> int:
    """The oracle lists more than the query's 10 rows, so that a row whose
    revenue ties the 10th within the tolerance can be told apart from a
    wrong one. Keys and order are exact where revenues differ by more
    than rtol=1e-9."""
    rows = result.to_rows()
    revenue = {r["l_orderkey"]: r["revenue"] for r in oracle}
    if not rows or len(rows) > len(oracle):
        raise AssertionError(f"Q3 gave {len(rows)} rows")
    for i, (row, want) in enumerate(zip(rows, oracle)):
        key = row["l_orderkey"]
        if key not in revenue or \
                abs(row["revenue"] - revenue[key]) > 1e-9 * revenue[key]:
            raise AssertionError(f"Q3 row {i} {row} does not match the "
                                 f"oracle's revenue {revenue.get(key)}")
        if key != want["l_orderkey"] and \
                abs(revenue[key] - want["revenue"]) > 1e-9 * want["revenue"]:
            raise AssertionError(f"Q3 row {i} is order {key}, the oracle's "
                                 f"is {want}")
    return len(rows)


def _check_window(result, oracle: tuple) -> int:
    """The running sum and the rank exactly, row for row in the input's
    order, read back as planes (to_rows would take minutes at this
    size)."""
    import numpy as np
    s, r = oracle
    n = len(s)
    planes = result.to_numpy()["planes"]
    if result.row_count != n:
        raise AssertionError(f"WINDOW gave {result.row_count} rows, not {n}")
    if not np.array_equal(planes["k"][0][:n], np.arange(n)):
        raise AssertionError("WINDOW rows are not in the input's order")
    for name, want in (("s", s), ("r", r)):
        data, valid = planes[name]
        if not valid[:n].all() or not np.array_equal(data[:n], want):
            bad = int(np.flatnonzero(data[:n] != want)[:1].sum())
            raise AssertionError(f"WINDOW {name} differs from the oracle "
                                 f"(first at row {bad})")
    return n


def _run_query(name: str, query: str, tables: dict, check, oracle,
               rows_in: int, hr, rx, select_rows, ranges=()) -> dict:
    """One query of the slice: a checked run whose launches are counted,
    REPS warm runs, and one run under the profiler."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_launches(hr, rx)
    result = select_rows(query, tables, device="cuda")
    torch.cuda.synchronize()
    launches = _launches(hr, rx)
    rows_out = check(result, oracle)
    del result
    for kernel in PATH_KERNELS:
        if launches[kernel] <= 0:
            raise AssertionError(f"{name}: the main path launched no "
                                 f"{kernel} kernel")
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
                    hr, rx, ranges)
    out = {"rows_in": rows_in, "rows_out": rows_out, "launches": launches,
           "median_ms": ms, "ms_runs": times,
           "rows_per_s": rows_in / (ms / 1e3), "peak_bytes": peak,
           "profile": prof}
    _log(f"{name}: {rows_out} rows match the oracle; launches {launches}; "
         f"warm median {ms:.3f} ms over {REPS} runs "
         f"{[round(x, 3) for x in times]}; {rows_in / (ms / 1e3):.0f} "
         f"rows/s; peak memory {peak / 1e9:.3f} GB")
    _log(f"{name} profile: {json.dumps(prof)}")
    return out


def phase_slice(seed: int, hr, rx, tpch, select_rows) -> dict:
    import torch
    t0 = time.perf_counter()
    arrays = tpch.lineitem_arrays(ROWS, seed=seed)
    chunk = tpch.lineitem_chunk(arrays, device="cuda")
    torch.cuda.synchronize()
    _log(f"lineitem: {ROWS} rows, capacity {chunk.capacity}, "
         f"{chunk.nbytes / 1e9:.3f} GB on the card, made in "
         f"{time.perf_counter() - t0:.1f} s (seed {seed})")
    tables = {"//tpch/lineitem": chunk}
    out = {
        "q1": _run_query("q1", tpch.Q1, tables, _check_q1,
                         tpch.q1_oracle(arrays), ROWS, hr, rx, select_rows),
        "q18_agg": _run_query("q18_agg", tpch.Q18_AGG, tables, _check_q18,
                              tpch.q18_agg_oracle(arrays), ROWS, hr, rx,
                              select_rows),
    }

    t0 = time.perf_counter()
    orders = tpch.orders_arrays(ORDERS, seed=ORDERS_SEED)
    tables["//tpch/orders"] = tpch.orders_chunk(orders, device="cuda")
    torch.cuda.synchronize()
    _log(f"orders: {ORDERS} rows, capacity "
         f"{tables['//tpch/orders'].capacity}, made in "
         f"{time.perf_counter() - t0:.1f} s (seed {ORDERS_SEED})")
    oracle = tpch.q3_oracle(arrays, orders, limit=2 * tpch.Q3_LIMIT)
    out["q3"] = _run_query("q3", tpch.Q3, tables, _check_q3, oracle, ROWS,
                           hr, rx, select_rows, ranges=JOIN_RANGES)
    del chunk, tables, arrays, orders
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    w_arrays = tpch.window_arrays(WINDOW_ROWS, seed=seed)
    w_chunk = tpch.window_chunk(w_arrays, device="cuda")
    torch.cuda.synchronize()
    _log(f"window table: {WINDOW_ROWS} rows in {tpch.WINDOW_PARTITIONS} "
         f"partitions, capacity {w_chunk.capacity}, made in "
         f"{time.perf_counter() - t0:.1f} s (seed {seed})")
    out["window"] = _run_query(
        "window", tpch.WINDOW, {"//t": w_chunk}, _check_window,
        tpch.window_oracle(w_arrays), WINDOW_ROWS, hr, rx, select_rows)
    del w_chunk, w_arrays
    torch.cuda.empty_cache()
    return out


def _bound_ms(nbytes: float) -> float:
    return nbytes / H100_BYTES_PER_S * 1e3


def phase_kernel_times(hr, rx, seed: int) -> dict:
    """Each kernel's time at the main path's width, by CUDA events, beside
    its plain version's, its bound and, where one PyTorch call computes the
    same function, that call's."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    out = {}
    bits = hr.BITS
    d = _digits("random", MAIN_N, bits, gen)
    out["hist_rank"] = {
        "ms": _cuda_ms(lambda: hr.hist_rank(d, bits), iters=20),
        "plain_ms": _cuda_ms(lambda: hr.hist_rank_plain(d, bits), iters=3),
        # Each digit read once, each rank written once, a counts row a tile.
        "bound_ms": _bound_ms(MAIN_N * 8 + (MAIN_N // hr.TILE)
                              * (1 << bits) * 4),
        "library_ms": None,
        "shape": f"N={MAIN_N}, bits={bits}"}
    del d

    word = _words("random", MAIN_N, gen)
    perm = torch.randperm(MAIN_N, device="cuda", generator=gen
                          ).to(torch.int32)
    pos = rx.MAX_POSITIONS
    hist_bytes = pos * rx.BINS * 4
    out["radix_upsweep"] = {
        "ms": _cuda_ms(lambda: rx.radix_upsweep(word, None, pos), iters=20),
        "plain_ms": _cuda_ms(lambda: rx.radix_upsweep_plain(word, None, pos),
                             iters=3),
        # First word: the word read (8 B), the key plane written (4 B).
        "bound_ms": _bound_ms(MAIN_N * 12 + hist_bytes),
        "library_ms": None,
        "gather_ms": _cuda_ms(lambda: rx.radix_upsweep(word, perm, pos),
                              iters=20),
        "gather_plain_ms": _cuda_ms(
            lambda: rx.radix_upsweep_plain(word, perm, pos), iters=3),
        # A later word: perm (4 B) and word (8 B) read, key (4 B) written.
        "gather_bound_ms": _bound_ms(MAIN_N * 16 + hist_bytes),
        "shape": f"N={MAIN_N}, {pos} digit positions; gather_*: through a "
                 "random permutation"}

    key, hist = rx.radix_upsweep(word, None, pos)
    bin_start = (torch.cumsum(hist, 1, dtype=torch.int32) - hist)[0]
    val = torch.arange(MAIN_N, dtype=torch.int32, device="cuda")
    digit = key & 0xFF
    layouts = {items: _cuda_ms(lambda: rx.radix_onesweep(
                   key, val, 0, bin_start, items=items), iters=20)
               for items in rx.LAYOUTS}
    out["radix_onesweep"] = {
        "ms": layouts[rx.ITEMS],
        "plain_ms": _cuda_ms(lambda: rx.radix_onesweep_plain(key, val, 0),
                             iters=3),
        # Keys and values read once and written once; the bin starts read.
        "bound_ms": _bound_ms(MAIN_N * 16 + rx.BINS * 4),
        # One call that computes the pass's stable order by the digit.
        "library_ms": _cuda_ms(lambda: torch.sort(digit, stable=True),
                               iters=20),
        "items": rx.ITEMS,
        "layouts_ms": {f"{rx.THREADS}x{items}": ms
                       for items, ms in layouts.items()},
        "shape": f"N={MAIN_N}, 8-bit digit, random keys"}
    _log(f"radix_onesweep by tile layout (threads x items): "
         f"{out['radix_onesweep']['layouts_ms']} ms")
    return out


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
    from ytsaurus_tpu_torch.ops import radix as rx
    from ytsaurus_tpu_torch.query import select_rows

    # 1. environment
    smi = _nvidia_smi()
    _log(smi)
    _log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
         f"{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    _build.load_all(list(TRACE_NAMES))
    _log(f"built {', '.join(TRACE_NAMES)} in "
         f"{time.perf_counter() - t0:.2f} s")
    for name in TRACE_NAMES:
        info = _build.build_info[name]
        _log(f"{name}: nvcc {info['seconds']:.2f} s")
        _log(info["log"].strip())

    # 3. kernels against their plain versions, and the argsort
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errors = {"hist_rank": phase_hist_rank(hr, gen),
              **phase_radix_kernels(rx, gen)}
    argsort = phase_argsort(rx, gen)

    # 4. the slice
    slice_result = phase_slice(args.seed, hr, rx, tpch, select_rows)

    # 5. the kernels line
    times = phase_kernel_times(hr, rx, args.seed)
    kernels = []
    for name in TRACE_NAMES:
        per_query = {q: r["launches"][name] for q, r in slice_result.items()}
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"ytsaurus_tpu_torch/csrc/{name}.cu",
            "replaces": "ytsaurus_tpu/ops/pallas_radix.py:50",
            "launches": sum(per_query.values()),
            "launches_per_query": per_query,
            "on_main_path": name in PATH_KERNELS,
            "max_abs_err": errors[name],
            "bound_by": "bytes",
        }
        entry.update(times[name])
        kernels.append(entry)
    kernels[-1]["argsort_ms"] = argsort["argsort_ms"]
    kernels[-1]["argsort_library_ms"] = argsort["torch_sort_stable_ms"]
    line = {"kernels": kernels}
    record = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "rows": ROWS, "orders": ORDERS,
              "window_rows": WINDOW_ROWS,
              "seed": args.seed, "argsort": argsort,
              "queries": slice_result, "kernels": kernels,
              "ptxas": {name: _build.build_info[name]["log"]
                        for name in TRACE_NAMES}}
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(record, f, indent=1)
    _log(smi)
    _log(json.dumps(line))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
