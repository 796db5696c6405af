#!/usr/bin/env python3
"""Drive ytsaurus_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0] [--record PATH]

Phases (any failure exits non-zero and prints no result line):
  1. environment: the card's name and power limit, torch and CUDA
     versions, the host's memory (`free -g`);
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
     FUNCS over the same chunk (a calendar floor, farm_hash with an
     unsigned modulo, the numeric functions and a LIKE on every row,
     GROUP BY month and hash bucket): groups, counts, rev and mq exact,
     dd to rtol 1e-9, with the host seconds of its binding; then
     TPC-H Q3, the lineitem chunk joined with 16,000,000 orders (seed 1):
     the 10 order keys and their order exact, revenue to rtol=1e-9 (two
     orders whose oracle revenues lie within that tolerance may swap);
     then the window query of the repo's window benchmark over 64,000,000
     rows in 1000 partitions made from --seed: the running sum and the rank
     exact, in the input's row order;
     STRINGS: bench.py --config strings at its device size (10,000,000
     rows over 1,000,000 distinct strings, from --seed): its GROUP BY s,
     and upper / concat / length grouped under a LIKE OR a regex, each
     with the host seconds of its binding, against integer oracles;
     VECTOR: bench.py --config vector at its device size (4,000,000
     vectors from np.random.default_rng(3), dim 64 then 256):
     batched_nearest over k 8/64 x batch 1/16/64 (l2), each point held
     to the float64 oracle's recall rule (relative slack 1e-5 on the k-th
     measure, distances to rtol 1e-4), timed on the card and as a wall
     time; at the headline (dim 256, k 8, batch 64) cosine and dot too,
     the product / epilogue / top-k split against its bound, one profiled
     run; then three QL queries (NEAREST l2 projecting the vectors,
     NEAREST cosine under a WHERE, ORDER BY dot_product DESC LIMIT 8) over
     the (k, g, emb) table. It fails unless TF32 is off and the float32
     matmul precision is "highest". Each query runs once with every
     kernel's launch count set to 0 before it and read after it (it fails
     unless radix_upsweep and radix_onesweep were launched), then REPS more
     times for its warm time, then twice under torch.profiler, the second
     run giving its device time by kernel and idle share (it fails unless
     the trace holds as many kernels of each port kernel as were
     launched); Q3's profile also gives the device time of the join's
     phases (foreign sort, binary search, materialization);
     then the Sort operation and the MVCC read, each checked against a
     numpy oracle, with its launches counted (it fails unless
     radix_upsweep and radix_onesweep ran), its peak memory and a
     profile that must hold every launch:
     SORT: bench.py --config sort's table (64,000,000 rows of k int64 in
     [0, 2^60) and p double in [0, 1), from --seed) through sort_chunk on
     k; k and p exactly in numpy's stable argsort order. REPS warm runs;
     TABLET: a sorted dynamic table (k key, g in [0, 10,000), v in
     [0, 1000)) as 64,000,000 versions laid out by versioned_schema,
     made from --seed: a base version per key 0..47,999,999, then
     16,000,000 versions on random keys (99% partial writes of v, 1%
     deletes), shuffled. visible_chunk at MAX_TIMESTAMP and at
     56,000,000, each then GROUP BY g through select_rows; the
     sorted_versioned_chunk of all versions; retained_chunk at
     56,000,000. The visible rows, the groups and np.lexsort((-ts, k))'s
     order exactly; the retained row count, and visible_chunk of the
     retained versions equal to that of the originals at both
     timestamps. REPS warm runs, with each operation's time;
     DYNTABLE: the same table through the storage path (the host codec
     library must load; it fails otherwise): a history of 24,000,000
     base versions (g and v) and 8,000,000 later versions on random keys
     (99% partial writes of v, 1% deletes), interleaved at random over
     timestamps 1..32,000,000 (each key's first version is its base), so
     the compaction cut supersedes versions; cut by timestamp into 4 chunks of
     8,000,000 versions, each sorted by (k, -ts) with numpy and written
     through FsChunkStore.write_chunk at zlib_6 into a temporary
     directory, then mounted in a Tablet on the card by their chunk ids;
     1,000,000 writes through TransactionManager in 1,000 transactions
     (90% partial writes of v to existing keys, 9% new keys writing g and
     v, 1% deletes; writes/s on the host); flush() once under the
     profiler (the store's device sort and the serialize + write apart);
     read_snapshot at MAX_TIMESTAMP cold (5 decodes: decode, host -> device
     copy and merge apart), then at 16,000,000 through the path runner,
     then a latest read that must hit the snapshot cache; GROUP BY g over
     both snapshots (REPS warm runs); lookup_rows of 4,096 keys (history
     only, rewritten, deleted, new, absent; REPS runs with the row cache
     cleared, one that hits it); compact(retention_timestamp=16,000,000)
     once under the profiler: one chunk of the oracle's retained row
     count, the old files gone, and both reads unchanged. Every result
     is held to a numpy oracle (the TABLET oracle over the history and
     the writes at their commit timestamps), exactly;
     DURABLE: SELECT_8's table (below) stored through the storage layer,
     each read a query through coordinate_and_execute over lazy shards
     that decode the chunks onto the card, held to SELECT_8's oracle. An
     FsChunkStore holds the 8 chunks erasure-coded as lrc_12_2_2 (12 data
     and 4 parity parts; every part's sha256 recorded); chunks 0-3 then
     lose one data part each (both locality groups), chunks 4-5 two data
     parts and one parity part; read 1 repairs (exactly the data parts
     and, for a single loss, only its group's local parity are read; the
     `chunks.erasure.part_read` site counts them) and every rewritten
     part must hash as before; read 2 reads data parts only and repairs
     nothing (profiled); verify_chunk holds for all 8; a ninth chunk that
     lost parts 0, 1, 2 and 12 raises ChunkFormatError. Then a
     ReplicatedChunkStore over 4 locations at replication factor 3: one
     location's directory is deleted, the query re-replicates (every
     chunk back at 3 copies, each the same bytes), a clean read
     (profiled), one replica with a flipped byte fails verify_chunk and
     is quarantined (the query still matches), `chunks.store.read` failing
     once moves the read ladder to the next location (the retries
     counted), and a chunk with no copy left raises NoSuchChunk. Host
     seconds of the writes (serialize and erasure encode apart), of the
     reads (decode, copy, and the repair's decode and re-encode apart),
     bytes on disk per store, launches and peak memory per read;
     QUEUE: an ordered (queue) tablet on the card, rows of producer in
     [0, 64), seq (the producer's own count), v double and payload over
     65,536 distinct 24-byte strings, from --seed + 11: 4,200,000 rows
     appended in batches of 1,000 at their own timestamps, flushed at
     every 1,000,000 rows (4 chunks; 200,000 rows stay in the store); 64
     read_rows of 10,000 rows (8 across a chunk boundary or the store's
     base), each against the oracle; trim_rows(1,500,000) removes the
     first chunk's file, reads below and above the trim point; snapshot
     at row 3,000,000's timestamp and the latest (host seconds, profiled
     device ms), each queried on the card by a GROUP BY producer under
     WHERE $row_index >= 2000000 (counts exact, sums to rtol 1e-9) and
     an ORDER BY seq DESC, producer LIMIT 100 (rows and order exact);
     the 640,000 consumed rows through dumps_rows / loads_rows in yson,
     json, dsv and schemaful_dsv and dumps_skiff / loads_skiff, each
     giving back the same rows (host seconds and bytes per format);
     SELECT (query/coordinator.py::coordinate_and_execute, the host rung
     behind select_rows, one evaluator on the card): SELECT_8 (bench.py's
     select over 8 chunks of 8,000,000 rows: k the row number, g uniform
     in [0, 10,000), v uniform in [0, 1000), from --seed + 7; "g, sum(v),
     count(*) WHERE v < 900 GROUP BY g"), SELECT_LAZY (the same, each shard
     a callable that stages its numpy planes onto the card through the
     prefetcher; one more run, on the host clock, times the staging
     threads against the evaluating thread, then the staging alone on two
     threads and on one), SELECT_LIMIT ("k, v WHERE v > 900 LIMIT 1000": 7 shards
     skipped), SELECT_ORDERED ("k, v ORDER BY k DESC LIMIT 100" over shards
     range-ordered by k: the last shard first, 7 skipped) and SELECT_Q1_64
     (Q1 over the 64M-row lineitem as 64 chunks of 1,000,000 rows,
     coalesced at merge_shards_below=4,000,000 into 16 programs), each
     against a numpy oracle, with its count reads per query and its
     statistics;
     MESH (parallel/, over torch.distributed), part (a): a mesh of one
     rank over NCCL in this process, at full size, over the tables and
     oracles of the phases above (kept on the host until here):
     MESH_Q1 (Q1 through DistributedEvaluator's gather merge), MESH_Q18
     (Q18_AGG through the key-hash GROUP BY exchange, shuffle=True),
     MESH_Q3 (Q3 through the broadcast join, the 16,000,000 orders as
     the foreign chunk), MESH_Q3P (the same Q3 through the partitioned
     join, shuffle=True) and MESH_SORT (sort_table of SORT's 64,000,000
     rows on k), each checked as its single-chunk twin is, with the same
     launches, REPS warm runs, profile and peak memory as every path, and
     its host reads per query (host_sync_count). Then WHOLE: the same
     tables through coordinate_distributed, the degradation ladder:
     WP_TOPK (the 10 largest l_extendedprice: the gather shape), WP_Q1
     and WP_Q18 (exchange-states), WP_Q3 (the planner's join
     strategy, recorded) and WP_WINDOW (exchange-rows, beside its
     stitched twin MESH_WINDOW over the window table), each held to its
     oracle and required to be served by the whole-plan rung on every run
     (statistics and the rung tag of its span) at one host read once
     warm, with its quota, demand, overflow re-runs and exchange bytes;
     then WP_Q18 under parallel.all_to_all=error:times=1, which the
     stitched shuffle rung must serve with the oracle's rows. Part (b): first a probe
     (two processes) of whether gloo takes CUDA tensors in
     all_to_all_single with uneven splits, all_gather and all_reduce; if
     it does, 4 gloo processes on the one card run MESH_Q1, MESH_Q18,
     MESH_Q3P and MESH_SORT over 4 shards of 4,000,000 rows each (and
     1,000,000 orders a shard for MESH_Q3P), then WP_Q1, WP_Q18 and WP_Q3
     through coordinate_distributed (whole-plan rung, one host read once
     warm) and WP_SKEW (a GROUP BY with cardinality over keys 90% on one
     value: the first run overflows its quota and re-runs, the second
     does not), each rank checked against the numpy oracle over all
     shards. These sizes are cut from part
     (a)'s 64M because gloo stages every exchange through the host; their
     times are a correctness run's and are logged, not headlined. If
     gloo does not take CUDA tensors, part (b) is left out and the log
     says why;
     EXTSORT: bench.py::_bench_sort_spill as written (BASELINE config 5):
     1,000,000,000 rows in 16,000,000-row blocks, each made lazily in
     its supplier by np.random.default_rng(1000 + i), through
     external_sort at the default 8 GiB budget (10 ranges, 9 pivots);
     one run (under the profiler), timed from the call to the last chunk
     yielded, with the suppliers' seconds, the output checks' seconds and
     each pass's host seconds. Every chunk sorted, each chunk's first key
     at least the previous chunk's last, the row total, and two
     order-independent wrapping sums, splitmix64(k) and
     splitmix64(k ^ bits(p)), equal between the input (numpy, in the
     suppliers) and the output (torch, on the card). If the host's
     available memory cannot hold the spill, the rows are halved until it
     can, and the line says so;
  5. the `kernels` line: each kernel's time at the main path's shape (the
     one-sweep pass at every tile layout), its plain version's time, its
     bound, a library call's time where one PyTorch call computes the same
     function, and its launches on each path of the slice.

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
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peak memory rate of one H100 SXM (NVIDIA's data sheet).
H100_BYTES_PER_S = 3.35e12
# Published peak float32 rate of one H100 SXM outside the tensor cores.
H100_FP32_FLOPS = 67e12
ROWS = 64_000_000            # lineitem rows: the repo's q1 bench size
ORDERS = 16_000_000          # orders rows: Q3's n_orders at ROWS lines
ORDERS_SEED = 1              # the reference generator's default seed
WINDOW_ROWS = 64_000_000     # rows of the window query
SORT_ROWS = 64_000_000       # rows of the sort table: bench.py's sort size
EXT_ROWS = 1_000_000_000     # rows of the spill sort (BASELINE config 5)
EXT_BLOCK = 16_000_000       # rows per input block, as bench.py makes them
TABLET_VERSIONS = 64_000_000  # versions of the dynamic table read by MVCC
TABLET_BASE = 48_000_000     # keys, each with one base version
TABLET_DELETE_SHARE = 0.01   # share of the later versions that delete
TABLET_GROUPS = 10_000       # g uniform in [0, TABLET_GROUPS)
TABLET_READ_TS = 56_000_000  # the historical read and compaction cut
TABLET_QUERY = "g, sum(v) AS s, count(*) AS c FROM [//t] GROUP BY g"
MAIN_N = 67_108_864          # pad_capacity(ROWS): the main path's sort width
STRINGS_ROWS = 10_000_000    # bench.py --config strings at its device size
VECTOR_ROWS = 4_000_000      # bench.py --config vector at its device size
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
# The profiler range around the profiled run.
RUN_RANGE = "chip_smoke.run"
# Profiler ranges of a join's phases (query/engine/joins.py).
JOIN_RANGES = ("join.sort_foreign", "join.search", "join.materialize")
# Profiler ranges of the external sort's passes (ops/bigsort.py).
EXT_RANGES = ("bigsort.sample", "bigsort.route", "bigsort.sort_range")
# Profiler ranges of the MVCC stages (tablet/mvcc.py).
MVCC_RANGES = ("mvcc.sort", "mvcc.scan", "mvcc.compact")


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


def _profile(run, hr, rx, ranges=(), runs: int = 2, first=None) -> dict:
    """The last of `runs` runs of `run` under torch.profiler (`first`, when
    given, runs in place of the runs before it: a stage that changes
    state runs once, after a small warm-up of the profiler): device time
    by kernel name and by the torch op that launched it, and the device's
    idle share of the wall time (both as seen under the profiler, which
    slows the host). Busy time is the union of the device events' spans;
    `listed_sum_ms` is their plain sum, so that the two show any overlap.
    Raises unless the trace holds as many kernels of each port kernel as
    the run launched. For each profiler range named in `ranges`, the
    device time of the kernels launched inside it and its share of the
    busy time. Only events inside the last run's range count: late in a
    long process the trace was seen to lose the first kernels of a
    profiler session (VECTOR, chip_smoke), and the earlier runs take
    that loss."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs - 1):
            (first or run)()
        torch.cuda.synchronize()
        _reset_launches(hr, rx)
        with record_function(RUN_RANGE):
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
    launched = _launches(hr, rx)
    run_start = min(e.time_range.start for e in prof.events()
                    if e.name == RUN_RANGE)
    by_kernel: dict = {}
    spans = []
    traced = dict.fromkeys(TRACE_NAMES, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                e.time_range.start >= run_start and \
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
    op_acc: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and \
                e.time_range.start >= run_start and \
                e.self_device_time_total > 0:
            acc = op_acc.setdefault(e.name, [0.0, 0])
            acc[0] += e.self_device_time_total
            acc[1] += 1
    by_op = sorted(((name, us, count) for name, (us, count) in
                    op_acc.items()), key=lambda x: -x[1])[:8]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    port_ms = {kernel: sum(us for name, us in by_kernel.items()
                           if trace_name in name) / 1e3
               for kernel, trace_name in TRACE_NAMES.items()}
    in_range = {name: 0.0 for name in ranges}
    host_range = {name: 0.0 for name in ranges}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in in_range and \
                e.time_range.start >= run_start:
            in_range[e.name] += e.device_time_total
            host_range[e.name] += e.time_range.end - e.time_range.start
    if ranges and not any(in_range.values()):
        raise AssertionError(f"the trace shows no device time in the "
                             f"ranges {list(ranges)}")
    return {
        "ranges_ms": {name: us / 1e3 for name, us in in_range.items()},
        "ranges_share": {name: us / busy_us
                         for name, us in in_range.items()},
        "ranges_host_ms": {name: us / 1e3 for name, us in host_range.items()},
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
    return _run_path(name, lambda: select_rows(query, tables, device="cuda"),
                     lambda result: check(result, oracle), rows_in, hr, rx,
                     ranges)


def _run_path(name: str, run, check, rows_in: int, hr, rx,
              ranges=()) -> dict:
    """One path of the port: a run whose launches are counted and whose
    result `check` holds against its oracle (it returns the rows out),
    REPS warm runs, and one run under the profiler."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_launches(hr, rx)
    result = run()
    torch.cuda.synchronize()
    launches = _launches(hr, rx)
    rows_out = check(result)
    del result
    for kernel in PATH_KERNELS:
        if launches[kernel] <= 0:
            raise AssertionError(f"{name}: the main path launched no "
                                 f"{kernel} kernel")
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    prof = _profile(run, hr, rx, ranges)
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


def phase_slice(seed: int, hr, rx, tpch, select_rows, keep: dict) -> dict:
    """Q1, Q18_AGG, FUNCS, Q3 and WINDOW. The lineitem and orders arrays
    and the Q1, Q18_AGG and Q3 oracles go into `keep` for the mesh phase."""
    import torch
    t0 = time.perf_counter()
    arrays = tpch.lineitem_arrays(ROWS, seed=seed)
    chunk = tpch.lineitem_chunk(arrays, device="cuda")
    torch.cuda.synchronize()
    _log(f"lineitem: {ROWS} rows, capacity {chunk.capacity}, "
         f"{chunk.nbytes / 1e9:.3f} GB on the card, made in "
         f"{time.perf_counter() - t0:.1f} s (seed {seed})")
    tables = {"//tpch/lineitem": chunk}
    keep.update(lineitem=arrays, q1=tpch.q1_oracle(arrays),
                q18_agg=tpch.q18_agg_oracle(arrays))
    out = {
        "q1": _run_query("q1", tpch.Q1, tables, _check_q1, keep["q1"], ROWS,
                         hr, rx, select_rows),
        "q18_agg": _run_query("q18_agg", tpch.Q18_AGG, tables, _check_q18,
                              keep["q18_agg"], ROWS, hr, rx, select_rows),
    }
    t0 = time.perf_counter()
    funcs_oracle = tpch.funcs_oracle(arrays)
    _log(f"funcs oracle: {len(funcs_oracle)} groups in "
         f"{time.perf_counter() - t0:.1f} s")
    funcs_bind = _bind_seconds(tpch.FUNCS, tables)
    out["funcs"] = _run_query("funcs", tpch.FUNCS, tables, _check_funcs,
                              funcs_oracle, ROWS, hr, rx, select_rows)
    out["funcs"]["bind_host_s"] = funcs_bind
    _log(f"funcs: binding on the host {funcs_bind:.4f} s")

    t0 = time.perf_counter()
    orders = tpch.orders_arrays(ORDERS, seed=ORDERS_SEED)
    tables["//tpch/orders"] = tpch.orders_chunk(orders, device="cuda")
    torch.cuda.synchronize()
    _log(f"orders: {ORDERS} rows, capacity "
         f"{tables['//tpch/orders'].capacity}, made in "
         f"{time.perf_counter() - t0:.1f} s (seed {ORDERS_SEED})")
    oracle = tpch.q3_oracle(arrays, orders, limit=2 * tpch.Q3_LIMIT)
    keep.update(orders=orders, q3=oracle)
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


def _check_funcs(result, oracle: dict) -> int:
    """FUNCS's groups and counts, rev and mq exactly (rev sums whole
    numbers below 2^53), dd to rtol 1e-9."""
    rows = result.to_rows()
    got = {(r["month"], r["bucket"]): r for r in rows}
    if set(got) != set(oracle):
        raise AssertionError(f"FUNCS groups: {len(got)} against the "
                             f"oracle's {len(oracle)}")
    for key, want in oracle.items():
        row = got[key]
        for name in ("c", "rev", "mq"):
            if row[name] != want[name]:
                raise AssertionError(f"FUNCS {key} {name} {row[name]!r} != "
                                     f"{want[name]!r}")
        if abs(row["dd"] - want["dd"]) > 1e-9 * abs(want["dd"]):
            raise AssertionError(f"FUNCS {key} dd {row['dd']!r} != "
                                 f"{want['dd']!r} (rtol 1e-9)")
    return len(rows)


def _bind_seconds(query: str, tables: dict, reps: int = 3) -> float:
    """Median host seconds of binding `query` to its chunk (`build_query`
    and `prepare`: vocabulary tables, literal codes), apart from the run."""
    from ytsaurus_tpu_torch.query.builder import build_query
    from ytsaurus_tpu_torch.query.engine.lowering import prepare
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        plan = build_query(query, {p: c.schema for p, c in tables.items()})
        prepare(plan, tables[plan.source])
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def _check_strings_group(result, oracle: dict) -> int:
    """STRINGS_GROUP's {s: t} exactly, read back as planes."""
    planes = result.to_numpy()
    n = result.row_count
    codes, valid = planes["planes"]["s"]
    sums = planes["planes"]["t"][0][:n]
    vocab = planes["dictionaries"]["s"]
    if n != len(oracle) or not valid[:n].all():
        raise AssertionError(f"STRINGS_GROUP gave {n} groups, the oracle "
                             f"{len(oracle)}")
    for code, t in zip(codes[:n].tolist(), sums.tolist()):
        if oracle.get(bytes(vocab[code])) != t:
            raise AssertionError(f"STRINGS_GROUP {vocab[code]!r}: {t} != "
                                 f"{oracle.get(bytes(vocab[code]))}")
    return n


def _check_strings_funcs(result, oracle: dict) -> int:
    rows = result.to_rows()
    got = {r["u"]: (r["n"], r["t"]) for r in rows}
    if got != oracle or len(rows) != len(oracle):
        raise AssertionError(f"STRINGS_FUNCS: {len(rows)} rows against the "
                             f"oracle's {len(oracle)}")
    return len(rows)


def phase_strings(seed: int, hr, rx, synthetic, select_rows) -> dict:
    """STRINGS: bench.py --config strings at its accelerator size, its
    GROUP BY and the LIKE / regex / dictionary-function query, each with
    the host seconds of its binding apart."""
    import torch
    t0 = time.perf_counter()
    arrays = synthetic.strings_arrays(STRINGS_ROWS, seed=seed)
    chunk = synthetic.strings_chunk(arrays, device="cuda")
    torch.cuda.synchronize()
    tables = {"//t": chunk}
    _log(f"strings table: {STRINGS_ROWS} rows, "
         f"{len(chunk.columns['s'].dictionary)} distinct strings, capacity "
         f"{chunk.capacity}, made in {time.perf_counter() - t0:.1f} s "
         f"(seed {seed})")
    out = {}
    for name, query, check, oracle in (
            ("strings_group", synthetic.STRINGS_GROUP, _check_strings_group,
             synthetic.strings_group_oracle(arrays)),
            ("strings_funcs", synthetic.STRINGS_FUNCS, _check_strings_funcs,
             synthetic.strings_funcs_oracle(arrays))):
        bind_s = _bind_seconds(query, tables)
        out[name] = _run_query(name, query, tables, check, oracle,
                               STRINGS_ROWS, hr, rx, select_rows)
        out[name]["bind_host_s"] = bind_s
        _log(f"{name}: binding on the host {bind_s:.3f} s of the warm "
             f"median {out[name]['median_ms'] / 1e3:.3f} s; device busy "
             f"{out[name]['profile']['device_busy_ms']:.3f} ms, idle "
             f"{out[name]['profile']['idle_share']:.4f}")
    del chunk, tables, arrays
    torch.cuda.empty_cache()
    return out


def _vector_bound_ms(rows: int, batch: int, dim: int) -> tuple:
    """The headline's bound: the larger of the product's operations at the
    float32 peak outside the tensor cores and the plane, queries and
    scores moved once. (ms, 'operations' or 'bytes')."""
    ops_ms = 2.0 * batch * rows * dim / H100_FP32_FLOPS * 1e3
    bytes_ms = _bound_ms(4.0 * (rows * dim + batch * dim + batch * rows))
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def phase_vector(hr, rx, synthetic, vector, select_rows) -> dict:
    """VECTOR: bench.py --config vector at its accelerator size. For dim 64
    and 256: batched_nearest over the sweep (k 8/64 × batch 1/16/64, l2),
    each point checked against the float64 oracle (every query at the
    headline, dim 256 k 8 batch 64, where cosine and dot run too; the
    first four elsewhere), timed on the card (the scores and the top-k, by
    CUDA events) and as the entry point's wall time. At dim 256 also the
    three QL queries over the (k, g, emb) table, as paths."""
    import numpy as np
    import torch
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    _log(f"vector: torch.backends.cuda.matmul.allow_tf32={tf32}, "
         f"float32 matmul precision {precision!r}")
    if tf32 or precision != "highest":
        raise AssertionError("the vector product must run in full float32")
    out = {"sweep": [], "paths": {}, "tf32": tf32, "precision": precision}
    rows_all = np.arange(VECTOR_ROWS)
    for dim, plane, queries in synthetic.vector_sweep(VECTOR_ROWS):
        t0 = time.perf_counter()
        chunk = synthetic.vector_table(plane, device="cuda")
        torch.cuda.synchronize()
        _log(f"vector table dim {dim}: {VECTOR_ROWS} rows, capacity "
             f"{chunk.capacity}, {chunk.nbytes / 1e9:.3f} GB on the card, "
             f"made in {time.perf_counter() - t0:.1f} s (seed "
             f"{synthetic.VECTOR_SEED})")
        col = chunk.columns["emb"]
        valid = col.valid & (torch.arange(col.capacity, device="cuda")
                             < chunk.row_count)
        checked = {pt: q if pt == (8, 64) and dim == 256 else q[:4]
                   for pt, q in queries.items()}
        t0 = time.perf_counter()
        stacked = np.concatenate(list(checked.values()))
        measures = synthetic.vector_measures(plane, stacked, "l2")
        _log(f"vector oracle dim {dim}: {len(stacked)} queries in float64 "
             f"in {time.perf_counter() - t0:.1f} s")
        at = 0
        for (k, batch), q in queries.items():
            torch.cuda.reset_peak_memory_stats()
            q_dev = torch.from_numpy(q).to("cuda")
            hits = vector.batched_nearest(chunk, "emb", q.tolist(), k, "l2",
                                          device="cuda")
            for i in range(len(checked[(k, batch)])):
                synthetic.check_hits(hits[i], measures[at + i], rows_all,
                                     "l2", k)
            at += len(checked[(k, batch)])
            kernel_ms = _cuda_ms(lambda: vector.top_rows(
                vector.nearest_scores(col.data, valid, q_dev, "l2"), k),
                iters=REPS)
            walls = []
            for _ in range(REPS):
                t = time.perf_counter()
                vector.batched_nearest(chunk, "emb", q.tolist(), k, "l2",
                                       device="cuda")
                walls.append((time.perf_counter() - t) * 1e3)
            point = {"dim": dim, "k": k, "batch": batch,
                     "kernel_ms": kernel_ms,
                     "wall_ms": statistics.median(walls),
                     "queries_per_s": batch / (kernel_ms / 1e3),
                     "vectors_scanned_per_s":
                         VECTOR_ROWS * batch / (kernel_ms / 1e3),
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "checked_queries": len(checked[(k, batch)])}
            out["sweep"].append(point)
            _log(f"vector dim={dim} k={k} batch={batch}: scores + top-k "
                 f"{kernel_ms:.3f} ms on the card "
                 f"({point['queries_per_s']:,.0f}"
                 f" queries/s, {point['vectors_scanned_per_s']:,.0f} "
                 f"vectors-scanned/s); batched_nearest wall "
                 f"{point['wall_ms']:.3f} ms; {point['checked_queries']} "
                 f"queries match the oracle")
        del measures
        if dim == 256:
            out["headline"] = _vector_headline(
                chunk, col, valid, plane, queries[(8, 64)], hr, rx,
                synthetic, vector)
            out["paths"] = _vector_paths(chunk, plane, queries[(8, 64)][0],
                                         hr, rx, synthetic, select_rows)
        del chunk, col, valid, plane, queries
        torch.cuda.empty_cache()
    return out


def _vector_headline(chunk, col, valid, plane, q, hr, rx, synthetic,
                     vector) -> dict:
    """The headline point (dim 256, k 8, batch 64): cosine and dot against
    the oracle too, the device time split into the product, the epilogue
    and the top-k, its bound, and one run under the profiler."""
    import numpy as np
    import torch
    rows_all = np.arange(VECTOR_ROWS)
    k, batch, dim = 8, len(q), plane.shape[1]
    q_dev = torch.from_numpy(q).to("cuda")
    for metric in ("cosine", "dot"):
        measures = synthetic.vector_measures(plane, q, metric)
        hits = vector.batched_nearest(chunk, "emb", q.tolist(), k, metric,
                                      device="cuda")
        for i in range(batch):
            synthetic.check_hits(hits[i], measures[i], rows_all, metric, k)
        _log(f"vector headline {metric}: {batch} queries match the oracle")
    x = col.data
    torch.cuda.reset_peak_memory_stats()
    split = {"matmul_ms": _cuda_ms(lambda: q_dev @ x.T, iters=REPS)}
    split["scores_ms"] = _cuda_ms(
        lambda: vector.nearest_scores(x, valid, q_dev, "l2"), iters=REPS)
    split["epilogue_ms"] = split["scores_ms"] - split["matmul_ms"]
    score = vector.nearest_scores(x, valid, q_dev, "l2")
    split["topk_ms"] = _cuda_ms(lambda: vector.top_rows(score, k),
                                iters=REPS)
    split["library_topk_ms"] = _cuda_ms(lambda: torch.topk(score, k, dim=1),
                                        iters=REPS)
    for metric in ("cosine", "dot"):
        split[f"{metric}_ms"] = _cuda_ms(lambda: vector.top_rows(
            vector.nearest_scores(x, valid, q_dev, metric), k), iters=REPS)
    del score
    split["peak_bytes"] = torch.cuda.max_memory_allocated()
    split["bound_ms"], split["bound_by"] = _vector_bound_ms(
        chunk.capacity, batch, dim)
    split["profile"] = _profile(lambda: vector.batched_nearest(
        chunk, "emb", q.tolist(), k, "l2", device="cuda"), hr, rx)
    _log(f"vector headline split (dim {dim}, k {k}, batch {batch}): "
         f"{json.dumps({n: v for n, v in split.items() if n != 'profile'})}")
    _log(f"vector headline profile: {json.dumps(split['profile'])}")
    return split


def _vector_paths(chunk, plane, q, hr, rx, synthetic, select_rows) -> dict:
    """The three QL queries over the (k, g, emb) table, as paths: recall
    against the float64 oracle, the vector plane through the compaction
    intact."""
    import numpy as np
    metrics = {"nearest_l2": "l2", "nearest_cosine_where": "cosine",
               "order_by_dot": "dot"}
    out = {}
    for name, query in synthetic.VECTOR_QUERIES.items():
        metric = metrics[name]
        rows = np.arange(VECTOR_ROWS)
        if "WHERE g = 2" in query:
            rows = rows[rows % synthetic.VECTOR_GROUPS == 2]
        measures = synthetic.vector_measures(plane, q, metric, rows)[0]

        def check(result, rows=rows, measures=measures, metric=metric):
            got = result.to_rows()
            ks = np.array([r["k"] for r in got], dtype=np.int64)
            own = synthetic.vector_measures(plane, q, metric, ks)[0]
            synthetic.check_hits(list(zip(ks.tolist(), own.tolist())),
                                 measures, rows, metric, 8)
            for r in got:
                if "emb" in r and r["emb"] != plane[r["k"]].tolist():
                    raise AssertionError(f"row {r['k']}: emb differs from "
                                         "its plane row")
            return len(got)

        out[f"vector_{name}"] = _run_path(
            f"vector_{name}", lambda query=query: select_rows(
                query, {"//v": chunk}, params=[q.tolist()], device="cuda"),
            check, VECTOR_ROWS, hr, rx)
    return out


def _splitmix64_np(x):
    """splitmix64 over a uint64 array, wrapping, in place on a copy."""
    import numpy as np
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x += np.uint64(0x9E3779B97F4A7C15)
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def _splitmix64_torch(x):
    """splitmix64 over an int64 tensor of uint64 bit patterns: wrapping
    adds and multiplies, logical shifts by a mask."""
    def lsr(v, s):
        return (v >> s) & ((1 << (64 - s)) - 1)

    def c(value):
        return value - (1 << 64) if value >= 1 << 63 else value

    x = x + c(0x9E3779B97F4A7C15)
    x = (x ^ lsr(x, 30)) * c(0xBF58476D1CE4E5B9)
    x = (x ^ lsr(x, 27)) * c(0x94D049BB133111EB)
    return x ^ lsr(x, 31)


def _hash_sums_np(k, p) -> tuple:
    """The two order-independent sums of a block: splitmix64(k) and
    splitmix64(k ^ bits(p)), each wrapping mod 2^64."""
    import numpy as np
    ku = k.view(np.uint64)
    h1 = int(_splitmix64_np(ku).sum(dtype=np.uint64))
    h2 = int(_splitmix64_np(ku ^ p.view(np.uint64)).sum(dtype=np.uint64))
    return h1, h2


def _port_entry_points():
    """The port's entry points that the Sort and MVCC phases drive."""
    from types import SimpleNamespace

    from ytsaurus_tpu_torch.chunks.columnar import (
        ColumnarChunk,
        chunk_from_numpy,
        pad_capacity,
    )
    from ytsaurus_tpu_torch.operations.sort_op import sort_chunk
    from ytsaurus_tpu_torch.ops.bigsort import SpillStats, external_sort
    from ytsaurus_tpu_torch.query import select_rows
    from ytsaurus_tpu_torch.schema import TableSchema
    from ytsaurus_tpu_torch.tablet.mvcc import (
        retained_chunk,
        sorted_versioned_chunk,
        visible_chunk,
    )
    from ytsaurus_tpu_torch.tablet.tablet import versioned_schema
    from ytsaurus_tpu_torch.tablet.timestamp import MAX_TIMESTAMP
    return SimpleNamespace(
        ColumnarChunk=ColumnarChunk, chunk_from_numpy=chunk_from_numpy,
        pad_capacity=pad_capacity, sort_chunk=sort_chunk,
        SpillStats=SpillStats, external_sort=external_sort,
        select_rows=select_rows, TableSchema=TableSchema,
        visible_chunk=visible_chunk,
        sorted_versioned_chunk=sorted_versioned_chunk,
        retained_chunk=retained_chunk, versioned_schema=versioned_schema,
        MAX_TIMESTAMP=MAX_TIMESTAMP)


def phase_sort(seed: int, hr, rx, port, keep: dict) -> dict:
    """SORT: bench.py --config sort at its accelerator size, through
    sort_chunk; k and p exactly as numpy's stable argsort orders them. The
    table's arrays and the check go into `keep` for the mesh phase."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 60, size=SORT_ROWS, dtype=np.int64)
    p = rng.random(SORT_ROWS)
    schema = port.TableSchema.make([("k", "int64"), ("p", "double")])
    chunk = port.ColumnarChunk.from_arrays(schema, {"k": k, "p": p},
                                           device="cuda")
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    order = np.argsort(k, kind="stable")
    want_k, want_p = k[order], p[order]
    del order
    _log(f"sort table: {SORT_ROWS} rows, capacity {chunk.capacity}, made "
         f"in {made_s:.1f} s (seed {seed}); oracle (numpy stable argsort) "
         f"{time.perf_counter() - t0:.1f} s")

    def check(out) -> int:
        return _check_sorted("SORT", out, want_k, want_p)

    keep.update(sort_k=k, sort_p=p, sort_check=check)
    out = _run_path("sort", lambda: port.sort_chunk(chunk, ["k"],
                                                    device="cuda"),
                    check, SORT_ROWS, hr, rx)
    del chunk
    torch.cuda.empty_cache()
    return out


def _check_sorted(name: str, out, want_k, want_p) -> int:
    """k and p of a sorted chunk exactly as the oracle orders them."""
    import numpy as np
    planes = out.to_numpy()["planes"]
    n = len(want_k)
    if out.row_count != n:
        raise AssertionError(f"{name} gave {out.row_count} rows, not {n}")
    for col, want in (("k", want_k), ("p", want_p)):
        data, valid = planes[col]
        if not valid[:n].all() or not np.array_equal(
                data[:n].view(np.int64), want.view(np.int64)):
            raise AssertionError(f"{name} {col} differs from numpy's "
                                 "stable argsort order")
    return n


def _tablet_data(seed: int) -> dict:
    """TABLET's versions, in a shuffled order: one base version per key
    (writing g and v), then later versions on random keys (99% partial
    writes of v, 1% deletes). Arrays of TABLET_VERSIONS rows."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n, base = TABLET_VERSIONS, TABLET_BASE
    k = np.empty(n, dtype=np.int64)
    k[:base] = np.arange(base)
    k[base:] = rng.integers(0, base, n - base)
    ts = np.arange(1, n + 1, dtype=np.int64)
    tomb = np.zeros(n, dtype=bool)
    tomb[base:] = rng.random(n - base) < TABLET_DELETE_SHARE
    wg = np.zeros(n, dtype=bool)
    wg[:base] = True
    wv = ~tomb
    g = np.zeros(n, dtype=np.int64)
    g[:base] = rng.integers(0, TABLET_GROUPS, base)
    v = np.where(wv, rng.integers(0, 1000, n), 0)
    perm = rng.permutation(n)
    return {name: a[perm] for name, a in (
        ("k", k), ("$timestamp", ts), ("$tombstone", tomb), ("g", g),
        ("$w:g", wg), ("v", v), ("$w:v", wv))}


def _tablet_oracle(d: dict, read_points) -> dict:
    """numpy MVCC: versions in np.lexsort((-ts, k)) order; per read
    timestamp, the newest tombstone at or below it bounds each key's
    versions, each column takes its newest written value after it; the
    GROUP BY of those rows; the rows a compaction at each timestamp
    keeps."""
    import numpy as np
    n = len(d["k"])
    order = np.lexsort((-d["$timestamp"], d["k"]))
    s = {name: a[order] for name, a in d.items()}
    starts = np.ones(n, dtype=bool)
    starts[1:] = s["k"][1:] != s["k"][:-1]
    seg_start = np.flatnonzero(starts)
    seg_id = np.cumsum(starts) - 1
    idx = np.arange(n, dtype=np.int64)
    out = {"order": order, "read": {}}
    for ts in read_points:
        elig = s["$timestamp"] <= ts
        bound = np.minimum.reduceat(
            np.where(elig & s["$tombstone"], idx, n), seg_start)
        live = elig & (idx < bound[seg_id])
        emit = np.logical_or.reduceat(live, seg_start)
        cols = {"k": (s["k"][seg_start][emit], np.ones(int(emit.sum()), bool))}
        for name in ("g", "v"):
            first = np.minimum.reduceat(
                np.where(live & s["$w:" + name], idx, n), seg_start)[emit]
            has = first < n
            value = s[name][np.minimum(first, n - 1)]
            cols[name] = (np.where(has, value, 0), has)
        g, g_valid = cols["g"]
        v, v_valid = cols["v"]
        if not v_valid.all():
            raise AssertionError("TABLET oracle: a visible row lacks v")
        sums = np.bincount(g[g_valid], weights=v[g_valid],
                           minlength=TABLET_GROUPS)
        counts = np.bincount(g[g_valid], minlength=TABLET_GROUPS)
        groups = {int(i): (int(sums[i]), int(counts[i]))
                  for i in np.flatnonzero(counts)}
        if (~g_valid).any():
            groups[None] = (int(v[~g_valid].sum()), int((~g_valid).sum()))
        retained = int((~elig).sum()) + int(emit.sum())
        out["read"][ts] = {"cols": cols, "groups": groups,
                           "retained": retained}
    return out


def _check_visible(name: str, vis, want: dict) -> int:
    """A visible chunk's rows equal the oracle's columns (data where
    valid, and validity) exactly; returns the row count."""
    import numpy as np
    got = vis.to_numpy()["planes"]
    m = len(want["cols"]["k"][0])
    if vis.row_count != m:
        raise AssertionError(f"{name}: {vis.row_count} rows, not {m}")
    for col, (w_data, w_valid) in want["cols"].items():
        data, valid = got[col]
        if not np.array_equal(valid[:m], w_valid) or \
                not np.array_equal(np.where(w_valid, data[:m], 0), w_data):
            raise AssertionError(f"{name}: column {col} differs from the "
                                 "oracle")
    return m


def _check_groups(name: str, result, want: dict) -> int:
    """TABLET_QUERY's groups equal the oracle's exactly."""
    groups = {r["g"]: (r["s"], r["c"]) for r in result.to_rows()}
    if groups != want["groups"]:
        raise AssertionError(f"{name} differs from the oracle")
    return len(groups)


def _same_visible(a, b) -> bool:
    """Two visible chunks (on the card) agree: row count, validity, and
    data where valid."""
    import torch
    if a.row_count != b.row_count:
        return False
    n = a.row_count
    for name, col in a.columns.items():
        other = b.columns[name]
        va, vb = col.valid[:n], other.valid[:n]
        if not torch.equal(va, vb) or not torch.equal(
                torch.where(va, col.data[:n], 0),
                torch.where(vb, other.data[:n], 0)):
            return False
    return True


def phase_tablet(seed: int, hr, rx, port) -> dict:
    """TABLET: a sorted dynamic table read through MVCC, then GROUP BY."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    versions = _tablet_data(seed)
    table = port.TableSchema.make([("k", "int64", "ascending"),
                                   ("g", "int64"), ("v", "int64")])
    vschema = port.versioned_schema(table)
    n = TABLET_VERSIONS
    cap = port.pad_capacity(n)
    planes = {}
    for c in vschema:
        values = np.zeros(cap, dtype=versions[c.name].dtype)
        values[:n] = versions[c.name]
        valid = np.zeros(cap, dtype=bool)
        valid[:n] = versions["$w:" + c.name] if c.name in ("g", "v") else True
        planes[c.name] = (values, valid)
    spec = [(c.name, c.type.value) + ((c.sort_order.value,)
            if c.sort_order is not None else ()) for c in vschema]
    chunk = port.chunk_from_numpy(spec, n, planes, device="cuda")
    del planes
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    read_points = (port.MAX_TIMESTAMP, TABLET_READ_TS)
    oracle = _tablet_oracle(versions, read_points)
    _log(f"tablet: {n} versions of {TABLET_BASE} keys ({n - TABLET_BASE} "
         f"later: {1 - TABLET_DELETE_SHARE:.0%} partial writes of v, "
         f"{TABLET_DELETE_SHARE:.0%} deletes), capacity {chunk.capacity}, "
         f"{chunk.nbytes / 1e9:.3f} GB on the card, made in {made_s:.1f} s "
         f"(seed {seed}); oracle (numpy) {time.perf_counter() - t0:.1f} s")
    op_ms: list = []

    def label(what: str, ts: int) -> str:
        return f"{what}@{'max' if ts == port.MAX_TIMESTAMP else ts}"

    def run() -> dict:
        ms: dict = {}
        out: dict = {}

        def timed(label, fn):
            t = time.perf_counter()
            out[label] = fn()
            torch.cuda.synchronize()
            ms[label] = (time.perf_counter() - t) * 1e3

        for ts in read_points:
            timed(label("visible", ts), lambda ts=ts: port.visible_chunk(
                chunk, table, ts, device="cuda"))
            timed(label("group_by", ts), lambda ts=ts: port.select_rows(
                TABLET_QUERY, {"//t": out[label("visible", ts)]},
                device="cuda"))
        timed("sorted", lambda: port.sorted_versioned_chunk(
            chunk, table, device="cuda"))
        timed(label("retained", TABLET_READ_TS), lambda: port.retained_chunk(
            chunk, table, TABLET_READ_TS, device="cuda"))
        op_ms.append(ms)
        return out

    def check(out: dict) -> int:
        rows = 0
        for ts in read_points:
            want = oracle["read"][ts]
            rows += _check_visible(f"TABLET visible@{ts}",
                                   out[label("visible", ts)], want)
            rows += _check_groups(f"TABLET GROUP BY @{ts}",
                                  out[label("group_by", ts)], want)
        srt = out["sorted"].to_numpy()["planes"]
        order = oracle["order"]
        if out["sorted"].row_count != n:
            raise AssertionError("TABLET sorted: wrong row count")
        for name, values in versions.items():
            valid = versions["$w:" + name] if name in ("g", "v") else \
                np.ones(n, dtype=bool)
            if not np.array_equal(srt[name][0][:n], values[order]) or \
                    not np.array_equal(srt[name][1][:n], valid[order]):
                raise AssertionError(f"TABLET sorted: {name} is not in "
                                     "np.lexsort((-ts, k)) order")
        retained = out[label("retained", TABLET_READ_TS)]
        want_rows = oracle["read"][TABLET_READ_TS]["retained"]
        if retained.row_count != want_rows:
            raise AssertionError(f"TABLET retained: {retained.row_count} "
                                 f"rows, not {want_rows}")
        for ts in read_points:
            again = port.visible_chunk(retained, table, ts, device="cuda")
            if not _same_visible(again, out[label("visible", ts)]):
                raise AssertionError(f"TABLET: the retained versions read "
                                     f"differently at {ts}")
        return rows + n + retained.row_count

    out = _run_path("tablet", run, check, n, hr, rx, MVCC_RANGES)
    out["op_ms_runs"] = op_ms[1:1 + REPS]
    out["op_median_ms"] = {label: statistics.median(r[label]
                                                    for r in op_ms[1:1 + REPS])
                           for label in op_ms[0]}
    _log(f"tablet by operation (warm median ms): "
         f"{json.dumps(out['op_median_ms'])}")
    del chunk
    torch.cuda.empty_cache()
    return out


# --- DYNTABLE: the dynamic-table storage path -------------------------------

DYN_KEYS = 24_000_000        # keys, each with one base version (g and v)
DYN_LATER = 8_000_000        # later versions on random keys
DYN_CHUNK = 8_000_000        # versions per mounted chunk, cut by timestamp
DYN_WRITES = 1_000_000       # max_dynamic_store_row_count's default
DYN_TX_ROWS = 1_000          # rows per transaction
DYN_NEW_SHARE = 0.09         # writes that add a key (g and v)
DYN_WRITE_DELETES = 0.01     # writes that delete a key; the rest write v
DYN_READ_TS = 16_000_000     # the historical read and the compaction cut
DYN_LOOKUPS = 4_096
DYN_RANGES = ("tablet.flush", "tablet.read", "tablet.compact",
              "tablet.write") + MVCC_RANGES


def _dyntable_history(seed: int) -> dict:
    """The mounted history in timestamp order, at timestamps 1..n: a base
    version (g and v) per key and DYN_LATER later versions on random keys
    (99% partial writes of v, 1% deletes), interleaved at random in time,
    so each key's first version in time is its base and versions at or
    below the compaction cut supersede one another."""
    import numpy as np
    rng = np.random.default_rng(seed + 11)
    nk, n = DYN_KEYS, DYN_KEYS + DYN_LATER
    k = np.concatenate([np.arange(nk, dtype=np.int64),
                        rng.integers(0, nk, DYN_LATER)])[rng.permutation(n)]
    first = np.full(nk, n, dtype=np.int64)
    np.minimum.at(first, k, np.arange(n, dtype=np.int64))
    base = np.zeros(n, dtype=bool)
    base[first] = True
    tomb = ~base & (rng.random(n) < TABLET_DELETE_SHARE)
    g = np.where(base, rng.integers(0, TABLET_GROUPS, n), 0)
    v = np.where(~tomb, rng.integers(0, 1000, n), 0)
    return {"k": k, "$timestamp": np.arange(1, n + 1, dtype=np.int64),
            "$tombstone": tomb, "g": g, "$w:g": base, "v": v, "$w:v": ~tomb}


def _dyntable_writes(seed: int) -> dict:
    """The store's writes, DYN_TX_ROWS a transaction: distinct existing
    keys get partial writes of v or deletes, new keys (from DYN_KEYS up)
    write g and v. Also the lookup keys of each kind."""
    import numpy as np
    rng = np.random.default_rng(seed + 12)
    n_tx = DYN_WRITES // DYN_TX_ROWS
    per_new = int(DYN_TX_ROWS * DYN_NEW_SHARE)
    per_del = int(DYN_TX_ROWS * DYN_WRITE_DELETES)
    per_part = DYN_TX_ROWS - per_new - per_del
    perm = rng.permutation(DYN_KEYS)
    n_part, n_del = per_part * n_tx, per_del * n_tx
    part = perm[:n_part]
    dels = perm[n_part:n_part + n_del]
    new = DYN_KEYS + np.arange(per_new * n_tx, dtype=np.int64)
    lookups = np.concatenate([
        perm[n_part + n_del:n_part + n_del + 1024],     # history only
        part[:1024], dels[:512], new[:1024],
        new[-1] + 1 + np.arange(512)])                  # absent
    return {"n_tx": n_tx, "per": (per_part, per_new, per_del),
            "part": part, "part_v": rng.integers(0, 1000, n_part),
            "dels": dels, "new": new,
            "new_g": rng.integers(0, TABLET_GROUPS, len(new)),
            "new_v": rng.integers(0, 1000, len(new)),
            "lookups": rng.permutation(lookups)}


def _dyntable_oracle_versions(hist: dict, w: dict, commit_ts) -> dict:
    """The history and the written versions as one set of arrays."""
    import numpy as np
    per_part, per_new, per_del = w["per"]
    ts = np.asarray(commit_ts, dtype=np.int64)
    nb = len(w["part"]) + len(w["new"]) + len(w["dels"])
    k = np.concatenate([w["part"], w["new"], w["dels"]])
    wts = np.concatenate([np.repeat(ts, per_part), np.repeat(ts, per_new),
                          np.repeat(ts, per_del)])
    tomb = np.zeros(nb, dtype=bool)
    tomb[len(w["part"]) + len(w["new"]):] = True
    wg = np.zeros(nb, dtype=bool)
    wg[len(w["part"]):len(w["part"]) + len(w["new"])] = True
    g = np.zeros(nb, dtype=np.int64)
    g[wg] = w["new_g"]
    v = np.concatenate([w["part_v"], w["new_v"],
                        np.zeros(len(w["dels"]), dtype=np.int64)])
    written = {"k": k, "$timestamp": wts, "$tombstone": tomb, "g": g,
               "$w:g": wg, "v": v, "$w:v": ~tomb}
    return {name: np.concatenate([hist[name], written[name]])
            for name in hist}


def _dyntable_stage(name: str, run, hr, rx, extra=None) -> tuple:
    """One state-changing stage, run once under the profiler (after a
    small radix argsort that warms the profiler session up): its result,
    and its record (launches, wall and device ms, idle share, the
    tablet.* and mvcc.* ranges, peak device memory)."""
    import torch
    box = {}
    primer = torch.arange(4096, dtype=torch.int64, device="cuda")

    def once():
        box["out"] = run()

    torch.cuda.reset_peak_memory_stats()
    prof = _profile(once, hr, rx, DYN_RANGES,
                    first=lambda: rx.radix_argsort_u32([primer]))
    rec = {"launches": prof["launched"], "wall_ms": prof["wall_ms"],
           "device_busy_ms": prof["device_busy_ms"],
           "idle_share": prof["idle_share"],
           "ranges_ms": prof["ranges_ms"],
           "ranges_host_ms": prof["ranges_host_ms"],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "profile": prof, **(extra or {})}
    for kernel in PATH_KERNELS:
        if rec["launches"][kernel] <= 0:
            raise AssertionError(f"{name}: no {kernel} kernel was launched")
    return box["out"], rec


def _dyntable_disk(tablet) -> int:
    return sum(os.path.getsize(tablet.chunk_store._path(cid))
               for cid in tablet.chunk_ids)


def _dyntable_log(name: str, rec: dict) -> None:
    _log(f"{name}: {json.dumps({k: v for k, v in rec.items() if k != 'profile'})}")


def phase_dyntable(seed: int, hr, rx, port) -> dict:
    """DYNTABLE: a sorted dynamic table through the port's storage path:
    the history written as chunks and mounted, writes through
    transactions, flush, reads, GROUP BY, lookups and a compaction, each
    held to a numpy oracle."""
    import numpy as np
    import torch
    from ytsaurus_tpu_torch import native
    from ytsaurus_tpu_torch.chunks.encoding import decode_totals
    from ytsaurus_tpu_torch.chunks.store import FsChunkStore
    from ytsaurus_tpu_torch.tablet.tablet import Tablet, snapshot_cache_stats
    from ytsaurus_tpu_torch.tablet.transactions import TransactionManager
    t_phase = time.perf_counter()
    status = native.status()
    _log(f"dyntable: host codec library {json.dumps(status)}")
    if status["path"] != "native":
        raise AssertionError("the native codec library did not load")
    table = port.TableSchema.make([("k", "int64", "ascending"),
                                   ("g", "int64"), ("v", "int64")])
    vschema = port.versioned_schema(table)
    spec = [(c.name, c.type.value) + ((c.sort_order.value,)
            if c.sort_order is not None else ()) for c in vschema]
    out: dict = {"paths": {}}
    stages = out["stages"] = {}
    with tempfile.TemporaryDirectory() as root:
        store = FsChunkStore(root)
        stages["store"] = {"codec": store.codec, "native": status}
        # 1. The history, cut by timestamp into mounted chunks.
        t0 = time.perf_counter()
        hist = _dyntable_history(seed)
        made_s = time.perf_counter() - t0
        ids, write_s, sort_s = [], 0.0, 0.0
        n = DYN_KEYS + DYN_LATER
        cap = port.pad_capacity(DYN_CHUNK)
        for lo in range(0, n, DYN_CHUNK):
            t = time.perf_counter()
            part = {name: a[lo:lo + DYN_CHUNK] for name, a in hist.items()}
            order = np.lexsort((-part["$timestamp"], part["k"]))
            planes = {}
            for c in vschema:
                data = np.zeros(cap, dtype=part[c.name].dtype)
                data[:DYN_CHUNK] = part[c.name][order]
                valid = np.zeros(cap, dtype=bool)
                valid[:DYN_CHUNK] = part["$w:" + c.name][order] \
                    if c.name in ("g", "v") else True
                planes[c.name] = (data, valid)
            chunk = port.chunk_from_numpy(spec, DYN_CHUNK, planes,
                                          device="cuda")
            torch.cuda.synchronize()
            sort_s += time.perf_counter() - t
            t = time.perf_counter()
            ids.append(store.write_chunk(chunk))
            write_s += time.perf_counter() - t
            del chunk, planes
        tablet = Tablet(table, store, device="cuda")
        tablet.chunk_ids = list(ids)
        stages["history"] = {
            "versions": n, "chunks": len(ids), "made_s": made_s,
            "sort_and_stage_s": sort_s, "write_s": write_s,
            "bytes_on_disk": _dyntable_disk(tablet)}
        _dyntable_log("dyntable history", stages["history"])
        # 2. Writes through transactions.
        w = _dyntable_writes(seed)
        txm = TransactionManager()
        per_part, per_new, per_del = w["per"]
        commit_ts = []
        misses0 = tablet.chunk_cache.misses
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first_s = None
        for i in range(w["n_tx"]):
            part = w["part"][i * per_part:(i + 1) * per_part].tolist()
            part_v = w["part_v"][i * per_part:(i + 1) * per_part].tolist()
            new = w["new"][i * per_new:(i + 1) * per_new].tolist()
            new_g = w["new_g"][i * per_new:(i + 1) * per_new].tolist()
            new_v = w["new_v"][i * per_new:(i + 1) * per_new].tolist()
            dels = w["dels"][i * per_del:(i + 1) * per_del].tolist()
            tx = txm.start()
            txm.write_rows(tx, tablet, [{"k": k, "v": v}
                                        for k, v in zip(part, part_v)],
                           update=True)
            txm.write_rows(tx, tablet, [{"k": k, "g": g, "v": v}
                                        for k, g, v in zip(new, new_g,
                                                           new_v)])
            txm.delete_rows(tx, tablet, [(k,) for k in dels])
            commit_ts.append(txm.commit(tx))
            if first_s is None:
                first_s = time.perf_counter() - t0
        writes_s = time.perf_counter() - t0
        if min(commit_ts) <= n:
            raise AssertionError("DYNTABLE: a commit timestamp is not above "
                                 "the history's")
        stages["writes"] = {
            "rows": DYN_WRITES, "transactions": w["n_tx"],
            "host_s": writes_s, "writes_per_s": DYN_WRITES / writes_s,
            "first_transaction_s": first_s,
            "decodes": tablet.chunk_cache.misses - misses0,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "store_rows": tablet.active_store.store_row_count}
        _dyntable_log("dyntable writes", stages["writes"])
        # 3. Flush.
        t0 = time.perf_counter()
        flushed, rec = _dyntable_stage("dyntable flush", tablet.flush, hr,
                                       rx)
        rec["host_s"] = time.perf_counter() - t0
        meta = store.read_meta(flushed)
        if meta["row_count"] != DYN_WRITES or len(tablet.chunk_ids) != 5:
            raise AssertionError(f"DYNTABLE flush wrote {meta['row_count']} "
                                 f"rows, {len(tablet.chunk_ids)} chunks")
        rec.update(versions=DYN_WRITES, chunks=len(tablet.chunk_ids),
                   bytes_on_disk=_dyntable_disk(tablet),
                   flushed_bytes=os.path.getsize(store._path(flushed)))
        stages["flush"] = rec
        out["paths"]["dyntable_flush"] = rec
        _dyntable_log("dyntable flush", rec)
        # 4. The oracle.
        t0 = time.perf_counter()
        versions = _dyntable_oracle_versions(hist, w, commit_ts)
        del hist
        read_points = (port.MAX_TIMESTAMP, DYN_READ_TS)
        oracle = _tablet_oracle(versions, read_points)
        total = len(versions["k"])
        del versions
        _log(f"dyntable oracle (numpy): {total} versions, "
             f"{time.perf_counter() - t0:.1f} s")
        # 5. Reads: cold at MAX_TIMESTAMP, warm at DYN_READ_TS, a hit.
        for cid in tablet.chunk_ids:
            tablet.chunk_cache.invalidate(cid)
        misses0 = tablet.chunk_cache.misses
        dec0 = decode_totals()
        t0 = time.perf_counter()
        vis_max, rec = _dyntable_stage(
            "dyntable cold read", lambda: tablet.read_snapshot(), hr, rx)
        rec["host_s"] = time.perf_counter() - t0
        dec1 = decode_totals()
        rec.update(versions=total, chunks=len(tablet.chunk_ids),
                   bytes_on_disk=_dyntable_disk(tablet),
                   decodes=tablet.chunk_cache.misses - misses0,
                   decode_s=dec1["decode_seconds"] - dec0["decode_seconds"],
                   copy_s=dec1["copy_seconds"] - dec0["copy_seconds"],
                   bytes_copied=dec1["bytes_copied"] - dec0["bytes_copied"],
                   cache_bytes=tablet.chunk_cache.used_bytes,
                   rows_out=_check_visible("DYNTABLE read@max", vis_max,
                                           oracle["read"][read_points[0]]))
        stages["read_cold"] = rec
        out["paths"]["dyntable_read_cold"] = rec
        _dyntable_log("dyntable cold read", rec)
        misses0 = tablet.chunk_cache.misses
        keep_16 = {}

        def read_16():
            keep_16["chunk"] = tablet.read_snapshot(DYN_READ_TS)
            return keep_16["chunk"]

        name = f"dyntable_read@{DYN_READ_TS}"
        path = _run_path(
            name, read_16,
            lambda vis: _check_visible(name, vis,
                                       oracle["read"][DYN_READ_TS]),
            total, hr, rx, DYN_RANGES)
        path["decodes_per_read"] = (tablet.chunk_cache.misses - misses0) / \
            (REPS + 3)
        out["paths"][name] = path
        vis_16 = keep_16["chunk"]
        hits0 = snapshot_cache_stats()["hits"]
        if tablet.read_snapshot() is not vis_max or \
                snapshot_cache_stats()["hits"] != hits0 + 1:
            raise AssertionError("DYNTABLE: the latest read was not a "
                                 "snapshot cache hit")
        # 6. GROUP BY over both snapshots.
        for ts, vis in ((read_points[0], vis_max), (DYN_READ_TS, vis_16)):
            label = "max" if ts == port.MAX_TIMESTAMP else str(ts)
            _reset_launches(hr, rx)
            res = port.select_rows(TABLET_QUERY, {"//t": vis}, device="cuda")
            torch.cuda.synchronize()
            launches = _launches(hr, rx)
            groups = _check_groups(f"DYNTABLE GROUP BY @{label}", res,
                                   oracle["read"][ts])
            times = []
            for _ in range(REPS):
                t = time.perf_counter()
                port.select_rows(TABLET_QUERY, {"//t": vis}, device="cuda")
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            rec = {"rows_in": vis.row_count, "rows_out": groups,
                   "launches": launches,
                   "median_ms": statistics.median(times), "ms_runs": times}
            out["paths"][f"dyntable_group_by@{label}"] = rec
            _dyntable_log(f"dyntable GROUP BY @{label}", rec)
        # 7. Lookups.
        want_k = oracle["read"][read_points[0]]["cols"]["k"][0]
        want_g, want_gv = oracle["read"][read_points[0]]["cols"]["g"]
        want_v = oracle["read"][read_points[0]]["cols"]["v"][0]
        keys = [(int(k),) for k in w["lookups"]]
        pos = np.minimum(np.searchsorted(want_k, w["lookups"]),
                         len(want_k) - 1)
        found = want_k[pos] == w["lookups"]
        expect = [{"k": int(k), "g": int(want_g[p]) if want_gv[p] else None,
                   "v": int(want_v[p])} if f else None
                  for k, p, f in zip(w["lookups"], pos, found)]
        t = time.perf_counter()
        if tablet.lookup_rows(keys) != expect:
            raise AssertionError("DYNTABLE lookup_rows differs from the "
                                 "oracle")
        first_ms = (time.perf_counter() - t) * 1e3
        times = []
        for _ in range(REPS):
            tablet._row_cache.clear()
            t = time.perf_counter()
            tablet.lookup_rows(keys)
            times.append((time.perf_counter() - t) * 1e3)
        hits0 = tablet.row_cache_hits
        t = time.perf_counter()
        if tablet.lookup_rows(keys) != expect:
            raise AssertionError("DYNTABLE row-cache lookups differ")
        hit_ms = (time.perf_counter() - t) * 1e3
        if tablet.row_cache_hits - hits0 != len(keys):
            raise AssertionError("DYNTABLE: the repeated lookups missed the "
                                 "row cache")
        stages["lookup"] = {
            "keys": len(keys), "found": int(found.sum()),
            "first_ms": first_ms, "median_ms": statistics.median(times),
            "ms_runs": times, "row_cache_hit_ms": hit_ms}
        _dyntable_log("dyntable lookup", stages["lookup"])
        # 8. Compaction.
        old_ids = list(tablet.chunk_ids)
        want_rows = oracle["read"][DYN_READ_TS]["retained"]
        if want_rows >= total:
            raise AssertionError("DYNTABLE: the compaction cut supersedes "
                                 "no version")
        t0 = time.perf_counter()
        new_id, rec = _dyntable_stage(
            "dyntable compact",
            lambda: tablet.compact(retention_timestamp=DYN_READ_TS), hr, rx)
        rec["host_s"] = time.perf_counter() - t0
        rows = store.read_meta(new_id)["row_count"]
        if tablet.chunk_ids != [new_id] or rows != want_rows:
            raise AssertionError(f"DYNTABLE compaction left "
                                 f"{tablet.chunk_ids} with {rows} rows, not "
                                 f"one chunk of {want_rows}")
        if any(store.exists(cid) for cid in old_ids) or \
                store.list_chunks() != [new_id]:
            raise AssertionError("DYNTABLE: compaction left old chunk files")
        rec.update(versions_in=total, versions_out=rows, chunks=1,
                   bytes_on_disk=_dyntable_disk(tablet))
        stages["compact"] = rec
        out["paths"]["dyntable_compact"] = rec
        _dyntable_log("dyntable compact", rec)
        misses0 = tablet.chunk_cache.misses
        t0 = time.perf_counter()
        for ts, before in ((read_points[0], vis_max),
                           (DYN_READ_TS, vis_16)):
            if not _same_visible(tablet.read_snapshot(ts), before):
                raise AssertionError(f"DYNTABLE: the compacted table reads "
                                     f"differently at {ts}")
        torch.cuda.synchronize()
        stages["reads_after_compaction"] = {
            "host_s": time.perf_counter() - t0,
            "decodes": tablet.chunk_cache.misses - misses0}
        _dyntable_log("dyntable reads after compaction",
                      stages["reads_after_compaction"])
        del vis_max, vis_16, keep_16, tablet
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    _log(f"dyntable: {out['seconds']:.1f} s in all")
    return out


# --- DURABLE: the select table stored erasure-coded and replicated ----------

DURABLE_CODEC = "lrc_12_2_2"   # YTsaurus's usual erasure codec for tables
DURABLE_LOCATIONS = 4          # location roots of the replicated store
DURABLE_RF = 3                 # YTsaurus's default replication_factor
# Parts each LRC chunk loses before the first read: chunks 0-3 one data
# part each (both locality groups hit), chunks 4-5 two data parts and one
# parity part, chunks 6-7 none.
DURABLE_LOST = [(1,), (4,), (7,), (10,), (0, 6, 14), (3, 11, 12), (), ()]
# Three data parts of one group and its local parity: the reference
# refuses this pattern (tests/test_erasure.py).
DURABLE_UNRECOVERABLE = (0, 1, 2, 12)


def _sha256(path: str) -> str:
    import hashlib
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _tree_bytes(root: str) -> int:
    total = 0
    for dirpath, _, names in os.walk(root):
        total += sum(os.path.getsize(os.path.join(dirpath, n))
                     for n in names)
    return total


def _durable_read(name: str, co, ev, plan, shards, check, hr, rx,
                  expect_parts=None, profile: bool = True) -> dict:
    """One query over lazily read chunks: a counted run held to the oracle
    (with its part reads, repairs and host seconds), then, with `profile`,
    two more runs under the profiler (the second gives device ms and the
    idle share)."""
    import torch
    from ytsaurus_tpu_torch.chunks.encoding import decode_totals
    from ytsaurus_tpu_torch.chunks.store import repair_totals
    from ytsaurus_tpu_torch.utils import failpoints
    site = failpoints._SITES["chunks.erasure.part_read"]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_launches(hr, rx)
    dec0, rep0 = decode_totals(), repair_totals()
    # A zero delay on the part-read site counts every part read.
    with failpoints.active("chunks.erasure.part_read=delay:ms=0"):
        hits0 = site.hits
        t = time.perf_counter()
        result = co.coordinate_and_execute(plan, shards(), evaluator=ev)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t
        parts_read = site.hits - hits0
    launches = _launches(hr, rx)
    dec1, rep1 = decode_totals(), repair_totals()
    rec = {"host_s": host_s, "rows_out": check(result),
           "launches": launches, "part_reads": parts_read,
           "decodes": dec1["chunks"] - dec0["chunks"],
           "decode_s": dec1["decode_seconds"] - dec0["decode_seconds"],
           "copy_s": dec1["copy_seconds"] - dec0["copy_seconds"],
           **{f"repair_{k}": rep1[k] - rep0[k] for k in rep1},
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del result
    if expect_parts is not None and parts_read != expect_parts:
        raise AssertionError(f"{name}: {parts_read} part reads, not "
                             f"{expect_parts}")
    for kernel in PATH_KERNELS:
        if launches[kernel] <= 0:
            raise AssertionError(f"{name}: the main path launched no "
                                 f"{kernel} kernel")
    if profile:
        prof = _profile(lambda: co.coordinate_and_execute(
            plan, shards(), evaluator=ev), hr, rx)
        rec.update(device_busy_ms=prof["device_busy_ms"],
                   idle_share=prof["idle_share"], wall_ms=prof["wall_ms"],
                   profile=prof)
    _dyntable_log(name, rec)
    return rec


def phase_durable(seed: int, hr, rx, port) -> dict:
    """DURABLE: the select table (64M rows as 8 chunks of 8M) stored
    erasure-coded (lrc_12_2_2) and then replicated (4 locations, factor
    3), damaged, and read back through coordinate_and_execute with lazy
    shards that decode onto the card, each read held to SELECT_8's
    oracle."""
    import shutil

    import torch
    from ytsaurus_tpu_torch.chunks.encoding import serialize_chunk
    from ytsaurus_tpu_torch.chunks.erasure import get_erasure_codec
    from ytsaurus_tpu_torch.chunks.replicated import ReplicatedChunkStore
    from ytsaurus_tpu_torch.chunks.store import FsChunkStore
    from ytsaurus_tpu_torch.errors import EErrorCode, YtError
    from ytsaurus_tpu_torch.utils import failpoints
    t_phase = time.perf_counter()
    co = _coordinator_entry_points()
    ev = co.Evaluator("cuda")
    codec = get_erasure_codec(DURABLE_CODEC)
    arrays = _select_arrays(seed)
    check = _select_group_check(arrays, "DURABLE")
    schema = port.TableSchema.make([("k", "int64", "ascending"),
                                    ("g", "int64"), ("v", "int64")])
    plan = co.build_query(SELECT_QUERY, {"//t": schema})
    out: dict = {"paths": {}, "lrc": {}, "replicated": {}}
    with tempfile.TemporaryDirectory() as root:
        # 1. The LRC store: serialize each chunk once, then its parts.
        lrc = out["lrc"]
        store = FsChunkStore(os.path.join(root, "lrc"))
        ids, blobs = [], []
        ser_s = enc_s = put_s = 0.0
        for i, a in enumerate(arrays):
            chunk = port.ColumnarChunk.from_arrays(schema, a, device="cuda")
            t = time.perf_counter()
            blob = serialize_chunk(chunk, store.codec)
            ser_s += time.perf_counter() - t
            t = time.perf_counter()
            codec.encode(blob)
            enc_s += time.perf_counter() - t
            cid = "%032x" % (0xD0 + i)
            t = time.perf_counter()
            store.put_blob(cid, blob, erasure=DURABLE_CODEC)
            put_s += time.perf_counter() - t
            ids.append(cid)
            blobs.append(len(blob))
            del chunk
        sha = {(cid, i): _sha256(store._part_path(cid, i))
               for cid in ids for i in range(codec.total_parts)}
        lrc["write"] = {"chunks": len(ids), "blob_bytes": blobs,
                        "serialize_s": ser_s, "encode_s": enc_s,
                        "encode_and_write_s": put_s,
                        "bytes_on_disk": _tree_bytes(store.root)}
        _dyntable_log("durable lrc write", lrc["write"])
        for cid, lost in zip(ids, DURABLE_LOST):
            for i in lost:
                os.unlink(store._part_path(cid, i))

        def lrc_shards():
            return [(lambda cid=cid: store.read_chunk(cid, device="cuda"))
                    for cid in ids]

        # Read 1 repairs: 12 data-part reads a chunk, one local parity
        # for each single loss, all four parities where data parts of
        # both groups are gone.
        want_parts = len(ids) * codec.data_parts + sum(
            1 if len(lost) == 1 else codec.parity_parts
            for lost in DURABLE_LOST if lost)
        rec = _durable_read("durable lrc read 1 (repair)", co, ev, plan,
                            lrc_shards, check, hr, rx,
                            expect_parts=want_parts, profile=False)
        damaged = sum(1 for lost in DURABLE_LOST if lost)
        if rec["repair_repairs"] != damaged or rec["repair_parts_rewritten"] \
                != sum(len(lost) for lost in DURABLE_LOST):
            raise AssertionError(f"DURABLE: {rec['repair_repairs']} repairs "
                                 f"rewrote {rec['repair_parts_rewritten']} "
                                 "parts")
        bad = [key for key, digest in sha.items()
               if _sha256(store._part_path(*key)) != digest]
        if bad:
            raise AssertionError(f"DURABLE: repaired parts differ: {bad}")
        lrc["read_repair"] = rec
        out["paths"]["durable_lrc_repair"] = rec
        # Read 2: data parts only, no repair.
        rec = _durable_read("durable lrc read 2", co, ev, plan, lrc_shards,
                            check, hr, rx,
                            expect_parts=len(ids) * codec.data_parts)
        if rec["repair_repairs"]:
            raise AssertionError("DURABLE: the clean read repaired")
        lrc["read_clean"] = rec
        out["paths"]["durable_lrc_read"] = rec
        t = time.perf_counter()
        if not all(store.verify_chunk(cid) for cid in ids):
            raise AssertionError("DURABLE: verify_chunk failed after repair")
        lrc["verify_s"] = time.perf_counter() - t
        small = port.ColumnarChunk.from_arrays(
            schema, {k: a[:1000] for k, a in arrays[0].items()},
            device="cuda")
        lost_cid = store.write_chunk(small, erasure=DURABLE_CODEC)
        for i in DURABLE_UNRECOVERABLE:
            os.unlink(store._part_path(lost_cid, i))
        try:
            store.read_chunk(lost_cid, device="cuda")
        except YtError as e:
            if e.code != EErrorCode.ChunkFormatError:
                raise
            lrc["unrecoverable_code"] = e.code
        else:
            raise AssertionError("DURABLE: parts 0, 1, 2 and 12 lost, the "
                                 "read did not raise")
        store.remove_chunk(lost_cid)
        lrc["bytes_on_disk"] = _tree_bytes(store.root)
        _dyntable_log("durable lrc", {k: v for k, v in lrc.items()
                                      if k.startswith(("verify", "unrec",
                                                       "bytes"))})
        shutil.rmtree(store.root)

        # 2. The replicated store.
        rep = out["replicated"]
        roots = [os.path.join(root, f"loc{i}")
                 for i in range(DURABLE_LOCATIONS)]
        rs = ReplicatedChunkStore(roots, replication_factor=DURABLE_RF)
        t = time.perf_counter()
        for cid, a in zip(ids, arrays):
            rs.write_chunk(port.ColumnarChunk.from_arrays(schema, a,
                                                          device="cuda"),
                           chunk_id=cid)
        rep["write"] = {"host_s": time.perf_counter() - t,
                        "bytes_on_disk": sum(_tree_bytes(r) for r in roots)}
        _dyntable_log("durable replicated write", rep["write"])

        def copies(cid):
            return [s for s in rs.locations if s.exists(cid)]

        def rs_shards():
            return [(lambda cid=cid: rs.read_chunk(cid, device="cuda"))
                    for cid in ids]

        dead = rs.locations[1]
        lost_copies = sum(1 for cid in ids if dead.exists(cid))
        shutil.rmtree(dead.root)
        os.makedirs(dead.root)
        t = time.perf_counter()
        rec = _durable_read("durable replicated read (dead disk)", co, ev,
                            plan, rs_shards, check, hr, rx, profile=False)
        for cid in ids:
            holders = copies(cid)
            digests = {_sha256(s._path(cid)) for s in holders}
            if len(holders) != DURABLE_RF or len(digests) != 1:
                raise AssertionError(f"DURABLE: chunk {cid} has "
                                     f"{len(holders)} copies, "
                                     f"{len(digests)} distinct")
        rec["copies_lost"] = lost_copies
        rec["copies_restored"] = sum(1 for cid in ids if dead.exists(cid))
        rep["read_dead_disk"] = rec
        out["paths"]["durable_replicated_repair"] = rec
        rec = _durable_read("durable replicated read", co, ev, plan,
                            rs_shards, check, hr, rx)
        rep["read_clean"] = rec
        out["paths"]["durable_replicated_read"] = rec
        # A flipped byte: that replica fails verification and is moved
        # aside; the query is still served.
        holder = rs._placement(ids[0])[0]
        path = holder._path(ids[0])
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x5A]))
        if holder.verify_chunk(ids[0]):
            raise AssertionError("DURABLE: a flipped byte passed verify")
        holder.quarantine_chunk(ids[0])
        if holder.exists(ids[0]) or \
                not os.path.exists(path + ".quarantine"):
            raise AssertionError("DURABLE: quarantine left the replica")
        rep["flip"] = _durable_read("durable replicated read (quarantined)",
                                    co, ev, plan, rs_shards, check, hr, rx,
                                    profile=False)
        # The read ladder: one location's read fails, the next serves.
        rs._banned_until.clear()
        with failpoints.active("chunks.store.read=error:times=1"):
            site = failpoints._SITES["chunks.store.read"]
            hits0 = site.hits
            check(co.coordinate_and_execute(plan, rs_shards(), evaluator=ev))
            probes = site.hits - hits0
            failed = failpoints._STATE.rules["chunks.store.read"].triggered
        rep["ladder"] = {"probes": probes, "failed": failed,
                         "retries": probes - len(ids),
                         "banned": len(rs._banned_until)}
        if failed != 1 or probes != len(ids) + 1:
            raise AssertionError(f"DURABLE ladder: {rep['ladder']}")
        _dyntable_log("durable replicated ladder", rep["ladder"])
        gone = rs.write_chunk(small)
        for s in rs.locations:
            s.remove_chunk(gone)
        try:
            rs.read_chunk(gone, device="cuda")
        except YtError as e:
            if e.code != EErrorCode.NoSuchChunk:
                raise
            rep["no_copy_code"] = e.code
        else:
            raise AssertionError("DURABLE: a chunk with no copy was read")
        rep["bytes_on_disk"] = sum(_tree_bytes(r) for r in roots)
        _dyntable_log("durable replicated", {
            "no_copy_code": rep["no_copy_code"],
            "bytes_on_disk": rep["bytes_on_disk"]})
    del arrays
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    _log(f"durable: {out['seconds']:.1f} s in all")
    return out


# --- QUEUE: an ordered (queue) tablet ----------------------------------------

QUEUE_ROWS = 4_000_000         # rows flushed into chunks
QUEUE_TAIL = 200_000           # rows left in the dynamic store
QUEUE_BATCH = 1_000            # rows per append, each at its own timestamp
QUEUE_FLUSH = 1_000_000        # max_dynamic_store_row_count's default
QUEUE_PRODUCERS = 64
QUEUE_PAYLOADS = 65_536        # distinct 24-byte payloads
QUEUE_CONSUMERS = 64
QUEUE_READ = 10_000            # rows per consumer read
QUEUE_TRIM = 1_500_000
QUEUE_SNAPSHOT_ROW = 3_000_000  # snapshot(ts) at this row's timestamp
QUEUE_GROUP_FROM = 2_000_000   # the GROUP BY's least $row_index
QUEUE_GROUP = ("producer, count(*) AS c, sum(v) AS s FROM [//q] "
               f"WHERE $row_index >= {QUEUE_GROUP_FROM} GROUP BY producer")
QUEUE_TOP = 100
QUEUE_ORDER = (f"producer, seq, $row_index FROM [//q] "
               f"ORDER BY seq DESC, producer LIMIT {QUEUE_TOP}")
QUEUE_COLUMNS = ["$row_index", "$timestamp", "producer", "seq", "v",
                 "payload"]


def _queue_data(seed: int) -> dict:
    """The queue's rows as numpy columns: producer uniform in [0, 64),
    seq each producer's own count, v uniform in [0, 1), payload one of
    65,536 distinct 24-byte values."""
    import numpy as np
    rng = np.random.default_rng(seed + 11)
    n = QUEUE_ROWS + QUEUE_TAIL
    producer = rng.integers(0, QUEUE_PRODUCERS, n)
    order = np.argsort(producer, kind="stable")
    first = np.searchsorted(producer[order], np.arange(QUEUE_PRODUCERS))
    seq = np.empty(n, dtype=np.int64)
    seq[order] = np.arange(n) - np.repeat(first, np.bincount(
        producer, minlength=QUEUE_PRODUCERS))
    salt = rng.integers(0, 1 << 62, QUEUE_PAYLOADS)
    vocab = [b"%08x%016x" % (i, s) for i, s in enumerate(salt.tolist())]
    return {"producer": producer, "seq": seq, "v": rng.uniform(0, 1, n),
            "payload": rng.integers(0, QUEUE_PAYLOADS, n), "vocab": vocab,
            "timestamp": np.arange(n) // QUEUE_BATCH + 1}


def _queue_expect(d: dict, lo: int, hi: int) -> dict:
    """The oracle's columns of rows [lo, hi)."""
    vocab = d["vocab"]
    return {"$row_index": list(range(lo, hi)),
            "$timestamp": d["timestamp"][lo:hi].tolist(),
            "producer": d["producer"][lo:hi].tolist(),
            "seq": d["seq"][lo:hi].tolist(),
            "v": d["v"][lo:hi].tolist(),
            "payload": [vocab[i] for i in d["payload"][lo:hi].tolist()]}


def _check_queue_rows(name: str, rows: list, d: dict, lo: int,
                      hi: int) -> None:
    want = _queue_expect(d, lo, hi)
    if len(rows) != hi - lo:
        raise AssertionError(f"{name}: {len(rows)} rows, not {hi - lo}")
    for col, values in want.items():
        if [r[col] for r in rows] != values:
            raise AssertionError(f"{name}: column {col} differs from the "
                                 "oracle")


def _format_text(value):
    """A value as the DSV formats write it, parsed back."""
    if isinstance(value, bytes):
        return value.decode()
    if isinstance(value, bool):
        return "true" if value else "false"
    return str(value)


def _queue_formats(rows: list, port) -> dict:
    """The consumers' rows through every row format and back: each must
    give back the same rows (YSON and JSON carry bytes back as text, the
    DSV formats carry every value as text, skiff is exact)."""
    from ytsaurus_tpu_torch import formats
    out = {}
    schema = port.TableSchema.make([
        ("$row_index", "int64"), ("$timestamp", "int64"),
        ("producer", "int64"), ("seq", "int64"), ("v", "double"),
        ("payload", "string")])
    as_text = [{k: v.decode() if isinstance(v, bytes) else v
                for k, v in r.items()} for r in rows]
    for fmt in ("yson", "json", "dsv", "schemaful_dsv", "skiff"):
        t = time.perf_counter()
        if fmt == "skiff":
            blob = formats.dumps_skiff(rows, schema)
        else:
            blob = formats.dumps_rows(rows, fmt, columns=QUEUE_COLUMNS)
        dump_s = time.perf_counter() - t
        t = time.perf_counter()
        if fmt == "skiff":
            back, want = formats.loads_skiff(blob, schema), rows
        else:
            back = formats.loads_rows(blob, fmt, columns=QUEUE_COLUMNS)
            want = as_text if fmt in ("yson", "json") else \
                [{k: _format_text(v) for k, v in r.items()} for r in rows]
        load_s = time.perf_counter() - t
        if back != want:
            raise AssertionError(f"QUEUE: {fmt} did not give back the rows")
        out[fmt] = {"bytes": len(blob), "dumps_s": dump_s,
                    "loads_s": load_s}
        del blob, back
    return out


def phase_queue(seed: int, hr, rx, port) -> dict:
    """QUEUE: an ordered tablet on the card. 4,200,000 message rows
    appended in batches of 1,000 (each at its own timestamp), flushed at
    every 1,000,000 rows (4 chunks, 200,000 rows left in the store); 64
    consumer reads of 10,000 rows; a trim; snapshots at a timestamp and
    at the latest, each queried on the card (GROUP BY and ORDER BY ...
    LIMIT); the consumers' rows through every row format. Everything is
    held to a numpy oracle."""
    import numpy as np
    import torch
    from ytsaurus_tpu_torch.chunks.store import FsChunkStore
    from ytsaurus_tpu_torch.tablet.ordered import OrderedTablet
    t_phase = time.perf_counter()
    d = _queue_data(seed)
    n = QUEUE_ROWS + QUEUE_TAIL
    made_s = time.perf_counter() - t_phase
    schema = port.TableSchema.make([("producer", "int64"), ("seq", "int64"),
                                    ("v", "double"), ("payload", "string")])
    out: dict = {"paths": {}, "rows": n}
    with tempfile.TemporaryDirectory() as root:
        tablet = OrderedTablet(schema, FsChunkStore(root), device="cuda")
        append_s, flush_s = 0.0, []
        producer, seq = d["producer"].tolist(), d["seq"].tolist()
        v, vocab = d["v"].tolist(), d["vocab"]
        payload = d["payload"].tolist()
        for b in range(n // QUEUE_BATCH):
            lo = b * QUEUE_BATCH
            rows = [{"producer": p, "seq": s, "v": x, "payload": vocab[q]}
                    for p, s, x, q in zip(
                        producer[lo:lo + QUEUE_BATCH],
                        seq[lo:lo + QUEUE_BATCH], v[lo:lo + QUEUE_BATCH],
                        payload[lo:lo + QUEUE_BATCH])]
            t = time.perf_counter()
            if tablet.append_rows(rows, b + 1) != lo:
                raise AssertionError("QUEUE: an append got the wrong index")
            append_s += time.perf_counter() - t
            if (lo + QUEUE_BATCH) % QUEUE_FLUSH == 0 and \
                    lo + QUEUE_BATCH <= QUEUE_ROWS:
                t = time.perf_counter()
                tablet.flush()
                torch.cuda.synchronize()
                flush_s.append(time.perf_counter() - t)
        del producer, seq, v, payload
        if tablet.row_count != n or len(tablet.chunk_ids) != \
                QUEUE_ROWS // QUEUE_FLUSH or tablet.base_index != QUEUE_ROWS:
            raise AssertionError(f"QUEUE: {tablet.row_count} rows, "
                                 f"{len(tablet.chunk_ids)} chunks")
        store = tablet.chunk_store
        out["write"] = {
            "made_s": made_s, "append_s": append_s,
            "appends_per_s": n / append_s, "flush_s": flush_s,
            "chunk_bytes": [os.path.getsize(store._path(c))
                            for c in tablet.chunk_ids],
            "bytes_on_disk": _tree_bytes(root)}
        _dyntable_log("queue write", out["write"])
        # Consumers: offsets spread over the log, 8 across the chunk
        # boundaries and the store's base.
        edges = [b * QUEUE_FLUSH + d_ for b in range(1, 5)
                 for d_ in (-QUEUE_READ // 2, -1)]
        spread = np.linspace(0, n - QUEUE_READ, QUEUE_CONSUMERS
                             - len(edges)).astype(np.int64).tolist()
        offsets = sorted(spread + edges)
        consumed, times = [], []
        for off in offsets:
            t = time.perf_counter()
            rows = tablet.read_rows(off, QUEUE_READ)
            times.append((time.perf_counter() - t) * 1e3)
            _check_queue_rows(f"QUEUE read@{off}", rows, d, off,
                              off + QUEUE_READ)
            consumed += rows
        out["consumers"] = {"reads": len(offsets), "rows": len(consumed),
                            "median_ms": statistics.median(times),
                            "ms_max": max(times),
                            "decodes": tablet.chunk_cache.misses}
        _dyntable_log("queue consumers", out["consumers"])
        # Trim: the first chunk goes from disk; reads below the trim
        # point start at it.
        first = tablet.chunk_ids[0]
        tablet.trim_rows(QUEUE_TRIM)
        if store.exists(first) or len(tablet.chunk_ids) != 3:
            raise AssertionError("QUEUE: the trim left the first chunk")
        above = QUEUE_TRIM + QUEUE_FLUSH // 10
        for off, lo in ((0, QUEUE_TRIM),
                        (QUEUE_TRIM - QUEUE_READ // 2, QUEUE_TRIM),
                        (above, above)):
            _check_queue_rows(f"QUEUE read@{off} after the trim",
                              tablet.read_rows(off, QUEUE_READ), d, lo,
                              lo + QUEUE_READ)
        # Snapshots, then queries on the card.
        ts = int(d["timestamp"][QUEUE_SNAPSHOT_ROW])
        hi_ts = int(np.searchsorted(d["timestamp"], ts, side="right"))
        snaps = {}
        for label, at, hi in ((f"ts{ts}", ts, hi_ts), ("latest", None, n)):
            t = time.perf_counter()
            snap = tablet.snapshot(at)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t
            planes = snap.to_numpy()["planes"]
            got_index = planes["$row_index"][0][:snap.row_count]
            if snap.row_count != hi - QUEUE_TRIM or not np.array_equal(
                    got_index, np.arange(QUEUE_TRIM, hi)) or \
                    not np.array_equal(planes["v"][0][:snap.row_count],
                                       d["v"][QUEUE_TRIM:hi]):
                raise AssertionError(f"QUEUE snapshot {label} differs")
            prof = _profile(lambda at=at: tablet.snapshot(at), hr, rx)
            rec = {"rows": snap.row_count, "host_s": host_s,
                   "device_busy_ms": prof["device_busy_ms"],
                   "idle_share": prof["idle_share"],
                   "wall_ms": prof["wall_ms"],
                   "launches": prof["launched"], "profile": prof}
            out["paths"][f"queue_snapshot_{label}"] = rec
            _dyntable_log(f"queue snapshot {label}", rec)
            snaps[label] = (snap, hi)
        for label, (snap, hi) in snaps.items():
            lo = max(QUEUE_TRIM, QUEUE_GROUP_FROM)
            p, vv = d["producer"][lo:hi], d["v"][lo:hi]
            want_c = np.bincount(p, minlength=QUEUE_PRODUCERS)
            want_s = np.bincount(p, weights=vv, minlength=QUEUE_PRODUCERS)

            def check_group(result, want_c=want_c, want_s=want_s) -> int:
                got = {r["producer"]: r for r in result.to_rows()}
                if sorted(got) != np.flatnonzero(want_c).tolist():
                    raise AssertionError("QUEUE GROUP BY groups differ")
                for g, r in got.items():
                    if r["c"] != want_c[g] or not np.isclose(
                            r["s"], want_s[g], rtol=1e-9, atol=0):
                        raise AssertionError(f"QUEUE GROUP BY {g} differs")
                return len(got)

            live = np.arange(QUEUE_TRIM, hi)
            top = live[np.lexsort((d["producer"][live],
                                   -d["seq"][live]))][:QUEUE_TOP]

            def check_order(result, top=top) -> int:
                rows = result.to_rows()
                if [r["$row_index"] for r in rows] != top.tolist() or \
                        [r["seq"] for r in rows] != d["seq"][top].tolist():
                    raise AssertionError("QUEUE ORDER BY rows differ")
                return len(rows)

            for qname, query, check in (("group", QUEUE_GROUP, check_group),
                                        ("order", QUEUE_ORDER, check_order)):
                name = f"queue_{qname}_{label}"
                out["paths"][name] = _run_path(
                    name, lambda query=query, snap=snap: port.select_rows(
                        query, {"//q": snap}, device="cuda"),
                    check, snap.row_count, hr, rx)
        del snaps, snap
        # The consumers' rows through the row formats.
        out["formats"] = _queue_formats(consumed, port)
        _dyntable_log("queue formats", out["formats"])
        del consumed, tablet
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    _log(f"queue: {out['seconds']:.1f} s in all")
    return out


# --- SELECT: multi-chunk selects through the host coordinator ---------------

SELECT_ROWS = 64_000_000     # bench.py's select table at the q1 bench size
SELECT_CHUNKS = 8            # bench.py:292's shard count
SELECT_GROUPS = 10_000       # g uniform in [0, SELECT_GROUPS)
SELECT_Q1_CHUNKS = 64        # the lineitem as 1M-row chunks
SELECT_MERGE_BELOW = 4_000_000   # client.py's merge_shards_below
SELECT_QUERY = ("g, sum(v) AS s, count(*) AS c FROM [//t] WHERE v < 900 "
                "GROUP BY g")
SELECT_LIMIT = "k, v FROM [//t] WHERE v > 900 LIMIT 1000"
SELECT_ORDERED = "k, v FROM [//t] ORDER BY k DESC LIMIT 100"


def _select_arrays(seed: int) -> list:
    """SELECT_8's table as SELECT_CHUNKS numpy chunks: k the row number, g
    uniform in [0, SELECT_GROUPS), v uniform in [0, 1000)."""
    import numpy as np
    rng = np.random.default_rng(seed + 7)
    per = SELECT_ROWS // SELECT_CHUNKS
    return [{"k": np.arange(i * per, (i + 1) * per, dtype=np.int64),
             "g": rng.integers(0, SELECT_GROUPS, per),
             "v": rng.integers(0, 1000, per)}
            for i in range(SELECT_CHUNKS)]


def _select_group_check(arrays: list, name: str):
    """SELECT_QUERY's numpy oracle over the select table's chunks: a check
    that a result holds exactly its groups, sums and counts (it returns
    the rows out)."""
    import numpy as np
    g = np.concatenate([a["g"] for a in arrays])
    v = np.concatenate([a["v"] for a in arrays])
    sel = v < 900
    want_s = np.bincount(g[sel], weights=v[sel], minlength=SELECT_GROUPS)
    want_c = np.bincount(g[sel], minlength=SELECT_GROUPS)
    del g, v, sel

    def check(result) -> int:
        planes = result.to_numpy()["planes"]
        n = result.row_count
        got_g = planes["g"][0][:n]
        if n != int((want_c > 0).sum()) or \
                not np.array_equal(planes["s"][0][:n].astype(np.float64),
                                   want_s[got_g]) or \
                not np.array_equal(planes["c"][0][:n], want_c[got_g]) or \
                len(np.unique(got_g)) != n:
            raise AssertionError(f"{name} groups differ from the oracle")
        return n
    return check


def _coordinator_entry_points():
    from types import SimpleNamespace

    from ytsaurus_tpu_torch.query import builder
    from ytsaurus_tpu_torch.query.coordinator import coordinate_and_execute
    from ytsaurus_tpu_torch.query.engine import evaluator
    from ytsaurus_tpu_torch.query.statistics import QueryStatistics
    return SimpleNamespace(
        build_query=builder.build_query, Evaluator=evaluator.Evaluator,
        count_reads=evaluator.count_reads,
        coordinate_and_execute=coordinate_and_execute,
        QueryStatistics=QueryStatistics)


def phase_select(seed: int, hr, rx, tpch, port, keep: dict) -> dict:
    """SELECT: `coordinate_and_execute` (the host rung behind select_rows)
    over many chunks on the card, each path against a numpy oracle:
    SELECT_8 (bench.py:292's query over 8 chunks of 8M rows), SELECT_Q1_64
    (Q1 over the 64M-row lineitem as 64 chunks of 1M rows, coalesced at
    merge_shards_below=4,000,000 into 16 programs), SELECT_LAZY (SELECT_8
    with each shard a callable that stages its numpy planes onto the card
    through the prefetcher), SELECT_LIMIT (a bare LIMIT that the first
    shard satisfies: 7 shards skipped) and SELECT_ORDERED (ORDER BY k DESC
    LIMIT 100 over shards range-ordered by k: the last shard first, 7
    skipped). Each path as every other (launches, REPS warm runs, profile,
    peak), with the count reads per query and the statistics."""
    import numpy as np
    import torch
    co = _coordinator_entry_points()
    ev = co.Evaluator("cuda")
    t0 = time.perf_counter()
    arrays = _select_arrays(seed)
    schema = port.TableSchema.make([("k", "int64", "ascending"),
                                    ("g", "int64"), ("v", "int64")])
    chunks = [port.ColumnarChunk.from_arrays(schema, a, device="cuda")
              for a in arrays]
    torch.cuda.synchronize()
    check_select = _select_group_check(arrays, "SELECT_8")
    v = np.concatenate([a["v"] for a in arrays])
    per = SELECT_ROWS // SELECT_CHUNKS
    _log(f"select table: {SELECT_ROWS} rows as {SELECT_CHUNKS} chunks of "
         f"{per}, made in {time.perf_counter() - t0:.1f} s (seed {seed + 7})")

    want_limit_k = np.flatnonzero(v > 900)[:1000]

    def check_limit(result) -> int:
        rows = result.to_rows()
        ks = sorted(r["k"] for r in rows)
        if ks != want_limit_k.tolist() or \
                any(r["v"] != int(v[r["k"]]) for r in rows):
            raise AssertionError("SELECT_LIMIT rows differ from the "
                                 "first 1000 matching rows in scan order")
        return len(rows)

    want_top = list(range(SELECT_ROWS - 1, SELECT_ROWS - 101, -1))

    def check_ordered(result) -> int:
        rows = result.to_rows()
        if [r["k"] for r in rows] != want_top or \
                any(r["v"] != int(v[r["k"]]) for r in rows):
            raise AssertionError("SELECT_ORDERED rows differ from the "
                                 "oracle")
        return len(rows)

    def lazy_shards():
        return [(lambda a=a: port.ColumnarChunk.from_arrays(
            schema, a, device="cuda")) for a in arrays]

    cases = {
        "select_8": (SELECT_QUERY, lambda: chunks, {}, check_select,
                     SELECT_ROWS),
        "select_lazy": (SELECT_QUERY, lazy_shards, {}, check_select,
                        SELECT_ROWS),
        "select_limit": (SELECT_LIMIT, lambda: chunks, {}, check_limit, per),
        "select_ordered": (SELECT_ORDERED, lambda: chunks,
                           {"range_ordered_by": ["k"]}, check_ordered, per),
    }
    out = {}
    for name, (query, shards, kwargs, check, rows_in) in cases.items():
        plan = co.build_query(query, {"//t": schema})
        out[name] = _select_path(name, co, ev, plan, shards, kwargs, check,
                                 rows_in, hr, rx)
    out["select_lazy"]["staging"] = _staging_overlap(
        co, ev, co.build_query(SELECT_QUERY, {"//t": schema}), lazy_shards)
    for name in ("select_limit", "select_ordered"):
        skipped = out[name]["stats"]["shards_skipped"]
        if skipped != SELECT_CHUNKS - 1:
            raise AssertionError(f"{name} skipped {skipped} shards, not "
                                 f"{SELECT_CHUNKS - 1}")
    del chunks, arrays, v
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    li = keep["lineitem"]
    step = ROWS // SELECT_Q1_CHUNKS
    q1_chunks = [tpch.lineitem_chunk({name: a[i * step:(i + 1) * step]
                                      for name, a in li.items()},
                                     device="cuda")
                 for i in range(SELECT_Q1_CHUNKS)]
    torch.cuda.synchronize()
    _log(f"lineitem as {SELECT_Q1_CHUNKS} chunks of {step} rows on the "
         f"card in {time.perf_counter() - t0:.1f} s")
    plan = co.build_query(tpch.Q1, {"//tpch/lineitem":
                                    q1_chunks[0].schema})
    out["select_q1_64"] = _select_path(
        "select_q1_64", co, ev, plan, lambda: q1_chunks,
        {"merge_shards_below": SELECT_MERGE_BELOW},
        lambda result: _check_q1(result, keep["q1"]), ROWS, hr, rx)
    programs = out["select_q1_64"]["stats"]["shards_total"]
    if programs != ROWS // SELECT_MERGE_BELOW:
        raise AssertionError(f"SELECT_Q1_64 ran {programs} programs, not "
                             f"{ROWS // SELECT_MERGE_BELOW}")
    del q1_chunks
    torch.cuda.empty_cache()
    return out


def _union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out: list = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _span(intervals) -> float:
    return sum(hi - lo for lo, hi in intervals)


def _intersect(xs, ys) -> list:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if lo < hi:
            out.append([lo, hi])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _staging_overlap(co, ev, plan, make_shards) -> dict:
    """Whether SELECT_LAZY's staging overlapped its evaluation, on the
    host clock. One run records each lazy shard's staging interval (on
    the prefetch threads) and each wait of the evaluating thread in the
    prefetcher's `get`; the evaluating thread is busy whenever it does not
    wait. Then the staging alone: the 8 shards on two threads, as the
    prefetcher stages them, and on one."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from ytsaurus_tpu_torch.query import coordinator
    staged: list = []
    waits: list = []

    def timed(shard):
        def stage():
            t = time.perf_counter()
            chunk = shard()
            staged.append((t, time.perf_counter()))
            return chunk
        return stage

    get = coordinator._PrefetchScanner.get

    def timed_get(scanner, i):
        t = time.perf_counter()
        try:
            return get(scanner, i)
        finally:
            waits.append((t, time.perf_counter()))

    coordinator._PrefetchScanner.get = timed_get
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = co.coordinate_and_execute(
            plan, [timed(s) for s in make_shards()], evaluator=ev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        coordinator._PrefetchScanner.get = get
    del result
    stage_union = _union(staged)
    wait_union = _union(waits)
    busy, cursor = [], t0
    for lo, hi in wait_union:
        if lo > cursor:
            busy.append([cursor, lo])
        cursor = max(cursor, hi)
    if cursor < t1:
        busy.append([cursor, t1])
    alone = {}
    for threads in (2, 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with ThreadPoolExecutor(max_workers=threads) as pool:
            chunks = list(pool.map(lambda shard: shard(), make_shards()))
        torch.cuda.synchronize()
        alone[threads] = (time.perf_counter() - t) * 1e3
        del chunks
    out = {"wall_ms": (t1 - t0) * 1e3,
           "staging_sum_ms": sum(hi - lo for lo, hi in staged) * 1e3,
           "staging_union_ms": _span(stage_union) * 1e3,
           "evaluator_wait_ms": _span(wait_union) * 1e3,
           "evaluator_busy_ms": _span(busy) * 1e3,
           "overlap_ms": _span(_intersect(stage_union, busy)) * 1e3,
           "staging_alone_2_threads_ms": alone[2],
           "staging_alone_1_thread_ms": alone[1]}
    _log("select_lazy staging vs evaluation (host clock, ms): "
         + json.dumps({k: round(x, 3) for k, x in out.items()}))
    return out


def _select_path(name, co, ev, plan, shards, kwargs, check, rows_in, hr,
                 rx) -> dict:
    """One SELECT path through `_run_path`, with each run's count reads
    (the stacked `finish_all` transfers and the front's count) and the
    first run's statistics."""
    reads: list = []
    stats_runs: list = []

    def run():
        stats = co.QueryStatistics()
        before = co.count_reads()
        result = co.coordinate_and_execute(plan, shards(), evaluator=ev,
                                           stats=stats, **kwargs)
        reads.append(co.count_reads() - before)
        stats_runs.append(stats)
        return result

    out = _run_path(name, run, check, rows_in, hr, rx)
    stats = stats_runs[0]
    out["count_reads"] = reads
    out["stats"] = {k: getattr(stats, k) for k in (
        "shards_total", "shards_skipped", "shards_staged", "rows_read",
        "bytes_read", "rows_written", "retries")}
    _log(f"{name}: count reads per query {reads}; statistics "
         f"{json.dumps(out['stats'])}")
    return out


def _mesh_entry_points():
    """The port's mesh entry points that the MESH and WHOLE phases drive."""
    from types import SimpleNamespace

    from ytsaurus_tpu_torch.parallel.distributed import (
        DistributedEvaluator,
        ShardedTable,
        coordinate_distributed,
        host_sync_count,
    )
    from ytsaurus_tpu_torch.parallel.mesh import destroy_mesh, make_mesh
    from ytsaurus_tpu_torch.parallel.shuffle import sort_table
    from ytsaurus_tpu_torch.query.builder import build_query
    from ytsaurus_tpu_torch.query.statistics import QueryStatistics
    from ytsaurus_tpu_torch.utils import failpoints, tracing
    return SimpleNamespace(
        DistributedEvaluator=DistributedEvaluator, ShardedTable=ShardedTable,
        host_sync_count=host_sync_count, make_mesh=make_mesh,
        destroy_mesh=destroy_mesh, sort_table=sort_table,
        build_query=build_query, coordinate_distributed=coordinate_distributed,
        QueryStatistics=QueryStatistics, failpoints=failpoints,
        tracing=tracing)


TOPK_LIMIT = 10
TOPK_QUERY = ("l_extendedprice FROM [//tpch/lineitem] ORDER BY "
              f"l_extendedprice DESC LIMIT {TOPK_LIMIT}")


def _check_topk(result, oracle) -> int:
    """WP_TOPK: the TOPK_LIMIT largest prices, in order, exactly."""
    got = [r["l_extendedprice"] for r in result.to_rows()]
    if got != oracle.tolist():
        raise AssertionError(f"WP_TOPK {got} != {oracle.tolist()}")
    return len(got)


def _ladder_run(mesh_api, plan, mesh, chunks, foreign, de, record: list):
    """One query through coordinate_distributed under a root span: its
    result, with (host reads, statistics, the rungs that served it) added
    to `record`."""
    stats = mesh_api.QueryStatistics()
    before = mesh_api.host_sync_count()
    with mesh_api.tracing.start_span("chip_smoke.query") as root:
        result = mesh_api.coordinate_distributed(plan, mesh, chunks, foreign,
                                                 evaluator=de, stats=stats)
    served = [span.tags.get("rung") for span in
              mesh_api.tracing.get_collector().find(root.trace_id)
              if span.name.startswith("distributed.")
              and "error" not in span.tags]
    record.append((mesh_api.host_sync_count() - before, stats, served))
    return result


def _whole_summary(name: str, record: list) -> dict:
    """Checks that every run of a WHOLE path was served by the whole-plan
    rung (statistics and span), at one host read once warm; its reads,
    quotas, demands, overflow re-runs and exchange bytes."""
    summary = {"host_syncs": [], "retries": [], "quota": [], "demand": [],
               "exchange_bytes": [], "join_plan": None}
    for i, (syncs, stats, served) in enumerate(record):
        if stats.whole_plan != 1 or served != [0]:
            raise AssertionError(f"{name} run {i} was served by rungs "
                                 f"{served} (whole_plan {stats.whole_plan})")
        if i > 0 and (syncs != 1 or stats.whole_plan_retries != 0):
            raise AssertionError(f"{name} warm run {i}: {syncs} host reads, "
                                 f"{stats.whole_plan_retries} re-runs")
        block = stats.mesh_blocks[-1]
        summary["host_syncs"].append(syncs)
        summary["retries"].append(stats.whole_plan_retries)
        summary["quota"].append([e["quota"] for e in block["exchanges"]])
        summary["demand"].append([e["demand"] for e in block["exchanges"]])
        summary["exchange_bytes"].append(block["exchange_bytes"])
        summary["join_plan"] = stats.join_plan or None
    _log(f"{name}: served by the whole-plan rung every run; host reads "
         f"{summary['host_syncs']}; overflow re-runs {summary['retries']}; "
         f"quota {summary['quota'][0]} / demand {summary['demand'][0]} "
         f"first, {summary['quota'][-1]} / {summary['demand'][-1]} warm; "
         f"exchange bytes {summary['exchange_bytes'][-1]}; join plan "
         f"{summary['join_plan']}")
    return summary


def _mesh_queries(tpch) -> dict:
    """name -> (query, run() keyword arguments, profiler ranges)."""
    return {
        "mesh_q1": (tpch.Q1, {}, ("mesh.gather",)),
        "mesh_q18": (tpch.Q18_AGG, {"shuffle": True},
                     ("mesh.count", "mesh.route", "mesh.gather")),
        "mesh_q3": (tpch.Q3, {}, ("mesh.probe", "mesh.gather")),
        "mesh_q3p": (tpch.Q3, {"shuffle": True},
                     ("mesh.count", "mesh.route", "mesh.join",
                      "mesh.gather")),
    }


def phase_mesh(hr, rx, tpch, keep: dict) -> dict:
    """MESH, part (a): the mesh paths at world size 1 over NCCL in this
    process, at full size, over the tables and oracles the earlier phases
    made and checked: Q1 through the gather merge, Q18_AGG through the
    shuffled GROUP BY, Q3 through the broadcast join and through the
    partitioned join (shuffle=True), and sort_table of SORT's table. Each
    path as every other: launches, REPS warm runs, two profiled runs, peak
    memory, and its host reads per query (host_sync_count)."""
    import numpy as np
    import torch
    mesh_api = _mesh_entry_points()
    mesh = mesh_api.make_mesh("cuda")
    if mesh.backend != "nccl" or mesh.size != 1:
        raise AssertionError(f"the mesh is {mesh.backend} x {mesh.size}, "
                             "not NCCL x 1")
    t0 = time.perf_counter()
    lineitem = tpch.lineitem_chunk(keep["lineitem"], device="cuda")
    orders = tpch.orders_chunk(keep["orders"], device="cuda")
    table = mesh_api.ShardedTable.from_chunks(mesh, [lineitem])
    del lineitem
    torch.cuda.synchronize()
    _log(f"mesh: NCCL, world size 1, {mesh.device}; lineitem ({ROWS} rows) "
         f"and orders ({ORDERS} rows) on the card again in "
         f"{time.perf_counter() - t0:.1f} s")
    ev = mesh_api.DistributedEvaluator(mesh)
    foreign = {"//tpch/orders": orders}
    schemas = {"//tpch/lineitem": table.schema,
               "//tpch/orders": orders.schema}
    checks = {"mesh_q1": (_check_q1, keep["q1"]),
              "mesh_q18": (_check_q18, keep["q18_agg"]),
              "mesh_q3": (_check_q3, keep["q3"]),
              "mesh_q3p": (_check_q3, keep["q3"])}
    out = {}
    for name, (query, kwargs, ranges) in _mesh_queries(tpch).items():
        plan = mesh_api.build_query(query, schemas)
        syncs: list = []

        def run(plan=plan, kwargs=kwargs, syncs=syncs):
            before = mesh_api.host_sync_count()
            result = ev.run(plan, table, foreign, **kwargs)
            syncs.append(mesh_api.host_sync_count() - before)
            return result

        check, oracle = checks[name]
        out[name] = _run_path(name, run,
                              lambda result, c=check, o=oracle: c(result, o),
                              ROWS, hr, rx, ranges)
        out[name]["host_syncs"] = syncs
        _log(f"{name}: host reads per query {syncs}")
    del ev

    # WHOLE, part (a): the same queries through coordinate_distributed,
    # served by the whole-plan rung; then a fault on the exchange.
    de = mesh_api.DistributedEvaluator(mesh)
    chunks = [table.local_chunk()]
    prices = keep["lineitem"]["l_extendedprice"]
    checks["wp_topk"] = (_check_topk, -np.sort(-prices[
        np.argpartition(-prices, TOPK_LIMIT)[:TOPK_LIMIT]]))
    whole = {"wp_topk": (TOPK_QUERY, "wp_topk", ("mesh.gather",
                                                  "mesh.read")),
             "wp_q1": (tpch.Q1, "mesh_q1", ("mesh.gather", "mesh.read")),
             "wp_q18": (tpch.Q18_AGG, "mesh_q18",
                        ("mesh.count", "mesh.route", "mesh.gather",
                         "mesh.read")),
             "wp_q3": (tpch.Q3, "mesh_q3",
                       ("mesh.count", "mesh.route", "mesh.join",
                        "mesh.gather", "mesh.read"))}
    for name, (query, twin, ranges) in whole.items():
        plan = mesh_api.build_query(query, schemas)
        record: list = []
        check, oracle = checks[twin]
        out[name] = _run_path(
            name, lambda plan=plan, record=record: _ladder_run(
                mesh_api, plan, mesh, chunks, foreign, de, record),
            lambda result, c=check, o=oracle: c(result, o), ROWS, hr, rx,
            ranges)
        out[name].update(_whole_summary(name, record))
    plan = mesh_api.build_query(tpch.Q18_AGG, schemas)
    record = []
    with mesh_api.failpoints.active("parallel.all_to_all=error:times=1"):
        result = _ladder_run(mesh_api, plan, mesh, chunks, foreign, de,
                             record)
    rows = _check_q18(result, keep["q18_agg"])
    syncs, stats, served = record[0]
    if stats.whole_plan != 0 or served != [1]:
        raise AssertionError(f"the faulted WP_Q18 was served by rungs "
                             f"{served} (whole_plan {stats.whole_plan})")
    out["wp_q18"]["failpoint"] = {"served_rungs": served, "rows": rows,
                                  "host_syncs": syncs}
    _log(f"wp_q18 under parallel.all_to_all=error:times=1: served by the "
         f"stitched shuffle rung (rung {served}), {rows} rows match the "
         f"oracle, {syncs} host reads")
    del table, orders, foreign, chunks, result
    torch.cuda.empty_cache()

    # WP_WINDOW and its stitched twin MESH_WINDOW over the window table.
    t0 = time.perf_counter()
    w_arrays = tpch.window_arrays(WINDOW_ROWS, seed=keep["seed"])
    w_oracle = tpch.window_oracle(w_arrays)
    w_table = mesh_api.ShardedTable.from_chunks(
        mesh, [tpch.window_chunk(w_arrays, device="cuda")])
    del w_arrays
    torch.cuda.synchronize()
    _log(f"mesh: the window table ({WINDOW_ROWS} rows) on the card again in "
         f"{time.perf_counter() - t0:.1f} s")
    w_plan = mesh_api.build_query(tpch.WINDOW, {"//t": w_table.schema})
    w_ranges = ("mesh.count", "mesh.route", "mesh.gather")
    w_syncs: list = []

    def w_stitched():
        before = mesh_api.host_sync_count()
        result = de.run(w_plan, w_table)
        w_syncs.append(mesh_api.host_sync_count() - before)
        return result

    out["mesh_window"] = _run_path(
        "mesh_window", w_stitched, lambda r: _check_window(r, w_oracle),
        WINDOW_ROWS, hr, rx, w_ranges)
    out["mesh_window"]["host_syncs"] = w_syncs
    record = []
    w_chunks = [w_table.local_chunk()]
    out["wp_window"] = _run_path(
        "wp_window", lambda: _ladder_run(mesh_api, w_plan, mesh, w_chunks,
                                         None, de, record),
        lambda r: _check_window(r, w_oracle), WINDOW_ROWS, hr, rx,
        w_ranges + ("mesh.read",))
    out["wp_window"].update(_whole_summary("wp_window", record))
    del w_table, w_chunks, de
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.schema import TableSchema
    chunk = ColumnarChunk.from_arrays(
        TableSchema.make([("k", "int64"), ("p", "double")]),
        {"k": keep["sort_k"], "p": keep["sort_p"]}, device="cuda")
    table = mesh_api.ShardedTable.from_chunks(mesh, [chunk])
    del chunk
    torch.cuda.synchronize()
    _log(f"mesh: SORT's table ({SORT_ROWS} rows) on the card again in "
         f"{time.perf_counter() - t0:.1f} s")
    out["mesh_sort"] = _run_path(
        "mesh_sort", lambda: mesh_api.sort_table(table, ["k"]),
        lambda result: keep["sort_check"](result.local_chunk()),
        SORT_ROWS, hr, rx, ("sort.local",))
    del table
    torch.cuda.empty_cache()
    mesh_api.destroy_mesh()
    return out


# --- MESH, part (b): several gloo ranks on the one card ----------------------

MESH_WORLD = 4               # gloo ranks on the one card in part (b)
MESH_SHARD_ROWS = 4_000_000  # lineitem and sort-table rows per rank
MESH_SHARD_ORDERS = 1_000_000  # orders per rank (the foreign chunk's share)
MESH_B_REPS = 3              # warm runs per path and rank in part (b)


def _spawn_self(args: list, n: int, timeout: float) -> list:
    """Run this script `n` times at once with `args` + [rank]; each run's
    (exit code, standard output, standard error)."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                              + args + [str(rank)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(n)]
    outs = []
    try:
        for proc in procs:
            so, se = proc.communicate(timeout=timeout)
            outs.append((proc.returncode, so, se))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def _gloo_cuda_probe_rank(store: str, rank: str) -> int:
    """One rank of the probe: gloo on a world of 2, CUDA tensors on
    cuda:0, each collective the mesh uses, checked. Prints one JSON line."""
    import datetime

    import torch
    import torch.distributed as dist
    rank = int(rank)
    report = {"rank": rank, "torch": torch.__version__}
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=60))
        dev = torch.device("cuda", 0)
        x = torch.arange(5, dtype=torch.int64, device=dev) + 10 * rank
        send = [2, 3] if rank == 0 else [4, 1]
        recv = [[2, 4], [3, 1]][rank]
        out = torch.empty(sum(recv), dtype=torch.int64, device=dev)
        dist.all_to_all_single(out, x, output_split_sizes=recv,
                               input_split_sizes=send)
        want = {0: [0, 1, 10, 11, 12, 13], 1: [2, 3, 4, 14]}[rank]
        if out.cpu().tolist() != want:
            raise AssertionError(f"all_to_all_single gave {out.tolist()}")
        gathered = torch.empty(4, dtype=torch.int64, device=dev)
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(gathered, x[:2])
        if gathered.cpu().tolist() != [0, 1, 10, 11]:
            raise AssertionError(f"all_gather gave {gathered.tolist()}")
        total = torch.full((3,), rank + 1, dtype=torch.int64, device=dev)
        dist.all_reduce(total)
        if total.cpu().tolist() != [3, 3, 3]:
            raise AssertionError(f"all_reduce gave {total.tolist()}")
        report["ok"] = True
    except Exception as err:  # noqa: BLE001 — the probe reports it
        report.update(ok=False, error=f"{type(err).__name__}: {err}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(report), flush=True)
    return 0


def _mesh_b_data(seed: int, tpch):
    """Part (b)'s data, the same on every rank: MESH_WORLD lineitem shards
    (seed + s), the orders (ORDERS_SEED) and the sort table's shards."""
    import numpy as np
    n_orders = MESH_WORLD * MESH_SHARD_ORDERS
    shards = [tpch.lineitem_arrays(MESH_SHARD_ROWS, seed=seed + s,
                                   n_orders=n_orders)
              for s in range(MESH_WORLD)]
    orders = tpch.orders_arrays(n_orders, seed=ORDERS_SEED)
    sort_shards = []
    for s in range(MESH_WORLD):
        rng = np.random.default_rng(seed + 100 + s)
        sort_shards.append((rng.integers(0, 1 << 60, size=MESH_SHARD_ROWS,
                                         dtype=np.int64),
                            rng.random(MESH_SHARD_ROWS)))
    return shards, orders, sort_shards


def _mesh_rank(seed: str, store: str, rank: str) -> int:
    """One rank of part (b): gloo on cuda:0, MESH_WORLD ranks. Runs
    MESH_Q1, MESH_Q18, MESH_Q3P and MESH_SORT over its shard, checks each
    against its numpy oracle over all shards, prints one JSON line and
    raises on any failure."""
    import datetime

    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.models import tpch
    from ytsaurus_tpu_torch.ops import radix as rx
    from ytsaurus_tpu_torch.schema import TableSchema
    seed, rank = int(seed), int(rank)
    mesh_api = _mesh_entry_points()
    mesh = mesh_api.make_mesh("cuda", backend="gloo",
                              init_method=f"file://{store}", rank=rank,
                              world_size=MESH_WORLD,
                              timeout=datetime.timedelta(seconds=300))
    shards, orders_arrays, sort_shards = _mesh_b_data(seed, tpch)
    merged = {name: np.concatenate([a[name] for a in shards])
              for name in shards[0]}
    table = mesh_api.ShardedTable.from_chunks(
        mesh, [tpch.lineitem_chunk(a, device="cpu") for a in shards])
    orders = tpch.orders_chunk(orders_arrays, device=mesh.device)
    foreign = {"//tpch/orders": orders}
    schemas = {"//tpch/lineitem": table.schema,
               "//tpch/orders": orders.schema}
    ev = mesh_api.DistributedEvaluator(mesh)
    oracles = {"mesh_q1": (_check_q1, tpch.q1_oracle(merged)),
               "mesh_q18": (_check_q18, tpch.q18_agg_oracle(merged)),
               "mesh_q3p": (_check_q3, tpch.q3_oracle(
                   merged, orders_arrays, limit=2 * tpch.Q3_LIMIT))}
    report = {"rank": rank, "paths": {}}

    def timed(name, run, check):
        rx.reset_launches()
        before = mesh_api.host_sync_count()
        result = run()
        torch.cuda.synchronize()
        syncs = mesh_api.host_sync_count() - before
        launches = dict(rx.launches)
        rows_out = check(result)
        times = []
        for _ in range(MESH_B_REPS):
            torch.distributed.barrier()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        report["paths"][name] = {"rows_out": rows_out, "launches": launches,
                                 "host_syncs": syncs, "ms_runs": times,
                                 "median_ms": statistics.median(times)}

    queries = _mesh_queries(tpch)
    for name in ("mesh_q1", "mesh_q18", "mesh_q3p"):
        query, kwargs, _ = queries[name]
        plan = mesh_api.build_query(query, schemas)
        check, oracle = oracles[name]
        timed(name, lambda plan=plan, kwargs=kwargs: ev.run(
            plan, table, foreign, **kwargs),
            lambda result, c=check, o=oracle: c(result, o))
    # WHOLE, part (b): the ladder over the same shards, on every rank.
    de = mesh_api.DistributedEvaluator(mesh)
    chunks = [tpch.lineitem_chunk(a, device="cpu") for a in shards]
    for name, twin in (("wp_q1", "mesh_q1"), ("wp_q18", "mesh_q18"),
                       ("wp_q3", "mesh_q3p")):
        query = queries[twin][0]
        plan = mesh_api.build_query(query, schemas)
        check, oracle = oracles[twin]
        record: list = []
        timed(name, lambda plan=plan, record=record: _ladder_run(
            mesh_api, plan, mesh, chunks, foreign, de, record),
            lambda result, c=check, o=oracle: c(result, o))
        report["paths"][name].update(_whole_summary(name, record))
    report["paths"]["wp_skew"] = _skewed_group(mesh_api, mesh, seed, rank,
                                               de)
    del table, orders, foreign, chunks
    schema = TableSchema.make([("k", "int64"), ("p", "double")])
    s_table = mesh_api.ShardedTable.from_chunks(mesh, [
        ColumnarChunk.from_arrays(schema, {"k": k, "p": p}, device="cpu")
        for k, p in sort_shards])
    all_k = np.concatenate([k for k, _ in sort_shards])
    all_p = np.concatenate([p for _, p in sort_shards])
    order = np.argsort(all_k, kind="stable")

    def check_sort(out) -> int:
        lo = sum(out.row_counts[:rank])
        hi = lo + out.row_counts[rank]
        if sum(out.row_counts) != len(all_k):
            raise AssertionError(f"MESH_SORT kept {sum(out.row_counts)} "
                                 f"rows of {len(all_k)}")
        return _check_sorted("MESH_SORT", out.local_chunk(),
                             all_k[order[lo:hi]], all_p[order[lo:hi]])

    timed("mesh_sort", lambda: mesh_api.sort_table(s_table, ["k"]),
          check_sort)
    for name, r in report["paths"].items():
        if name not in ("mesh_q1", "wp_q1", "wp_skew") and \
                min(r["launches"].values()) <= 0:
            raise AssertionError(f"{name} (rank {rank}) launched "
                                 f"{r['launches']}")
    mesh_api.destroy_mesh()
    print(json.dumps(report), flush=True)
    return 0


SKEW_HOT_SHARE = 0.9         # share of the skewed table's rows on key 7
SKEW_QUERY = ("g, cardinality(v) AS d, count(*) AS c FROM [//t] "
              "GROUP BY g")


def _skewed_group(mesh_api, mesh, seed: int, rank: int, de) -> dict:
    """A GROUP BY whose keys are skewed (SKEW_HOT_SHARE of each shard's
    rows on one key) through coordinate_distributed: cardinality routes
    the rows (exchange-rows), so the hot key's cell overflows the first
    quota; the query re-runs at the demand, and the second run, with the
    settled quota, does not. Both against a numpy oracle."""
    import numpy as np
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.schema import TableSchema
    schema = TableSchema.make([("k", "int64", "ascending"), ("g", "int64"),
                               ("v", "int64")])
    arrays = []
    for s in range(MESH_WORLD):
        rng = np.random.default_rng(seed + 200 + s)
        g = np.where(rng.uniform(size=MESH_SHARD_ROWS) < SKEW_HOT_SHARE, 7,
                     rng.integers(0, 1024, MESH_SHARD_ROWS))
        arrays.append({"k": np.arange(MESH_SHARD_ROWS) + s * MESH_SHARD_ROWS,
                       "g": g, "v": rng.integers(0, 1000, MESH_SHARD_ROWS)})
    g = np.concatenate([a["g"] for a in arrays])
    v = np.concatenate([a["v"] for a in arrays])
    want_c = np.bincount(g, minlength=1024)
    want_d = np.bincount(np.unique(g * 1000 + v) // 1000, minlength=1024)
    chunks = [ColumnarChunk.from_arrays(schema, a, device="cpu")
              for a in arrays]
    plan = mesh_api.build_query(SKEW_QUERY, {"//t": schema})
    record: list = []
    rows = []
    times = []
    for _ in range(2):
        t = time.perf_counter()
        result = _ladder_run(mesh_api, plan, mesh, chunks, None, de, record)
        times.append((time.perf_counter() - t) * 1e3)
        got = {r["g"]: (r["d"], r["c"]) for r in result.to_rows()}
        if got != {int(key): (int(want_d[key]), int(want_c[key]))
                   for key in np.flatnonzero(want_c)}:
            raise AssertionError(f"WP_SKEW (rank {rank}) differs from the "
                                 "oracle")
        rows.append(len(got))
    (syncs0, stats0, served0), (syncs1, stats1, served1) = record
    if stats0.whole_plan_retries < 1 or stats1.whole_plan_retries != 0 or \
            served0 != [0] or served1 != [0] or syncs1 != 1:
        raise AssertionError(
            f"WP_SKEW (rank {rank}): re-runs {stats0.whole_plan_retries} "
            f"then {stats1.whole_plan_retries}, rungs {served0} "
            f"{served1}, host reads {syncs0} then {syncs1}")
    entry0 = stats0.mesh_blocks[-1]["exchanges"][0]
    entry1 = stats1.mesh_blocks[-1]["exchanges"][0]
    return {"rows_out": rows[0], "launches": {}, "ms_runs": times,
            "median_ms": statistics.median(times),
            "host_syncs": [syncs0, syncs1],
            "retries": [stats0.whole_plan_retries,
                        stats1.whole_plan_retries],
            "quota": [entry0["quota"], entry1["quota"]],
            "demand": [entry0["demand"], entry1["demand"]],
            "skew": [stats0.mesh_blocks[-1]["skew"],
                     stats1.mesh_blocks[-1]["skew"]]}


def phase_mesh_ranks(seed: int, tmp: str) -> dict:
    """MESH, part (b): first the probe; then, if gloo takes CUDA tensors,
    MESH_WORLD gloo processes on the one card, each checked."""
    import torch
    t0 = time.perf_counter()
    outs = _spawn_self(["--gloo-cuda-probe", os.path.join(tmp, "probe")],
                       2, timeout=240)
    reports = []
    for code, so, se in outs:
        try:
            reports.append(json.loads(so.strip().splitlines()[-1]))
        except (ValueError, IndexError):
            raise AssertionError(f"the gloo probe gave no report (exit "
                                 f"{code}): {se[-2000:]}")
    ok = all(r["ok"] for r in reports)
    result = {"gloo_cuda": ok, "probe": reports, "torch": torch.__version__,
              "probe_s": time.perf_counter() - t0}
    _log(f"gloo on CUDA tensors (torch {torch.__version__}): "
         f"{'takes them' if ok else 'does not take them'}; {reports}")
    if not ok:
        _log("mesh (b) left out: gloo cannot take CUDA tensors here; "
             "multi-rank parity stays with the CPU tests")
        return result
    t0 = time.perf_counter()
    outs = _spawn_self(["--mesh-rank", str(seed),
                        os.path.join(tmp, "mesh")], MESH_WORLD, timeout=600)
    ranks = []
    for rank, (code, so, se) in enumerate(outs):
        if code != 0:
            raise AssertionError(f"mesh rank {rank} failed (exit {code}): "
                                 f"{se[-3000:]}")
        ranks.append(json.loads(so.strip().splitlines()[-1]))
    result.update(ranks=ranks, wall_s=time.perf_counter() - t0)
    for name in ranks[0]["paths"]:
        per_rank = [r["paths"][name]["median_ms"] for r in ranks]
        _log(f"{name} on {MESH_WORLD} gloo ranks (cut to "
             f"{MESH_SHARD_ROWS} rows a rank, {MESH_SHARD_ORDERS} orders a "
             f"rank for Q3P, because gloo stages every exchange through the "
             f"host; a correctness run, not the mesh's speed): every rank "
             f"matches the oracle; median ms by rank {per_rank}; host reads "
             f"{ranks[0]['paths'][name]['host_syncs']}")
    return result


def _host_memory() -> tuple:
    """(`free -g`'s output, bytes available) from /proc/meminfo."""
    try:
        text = subprocess.run(["free", "-g"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        text = "free: not available"
    avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    return text, avail


def phase_extsort(hr, rx, port) -> dict:
    """EXTSORT: bench.py::_bench_sort_spill as written (BASELINE config 5):
    blocks made lazily in their suppliers, external_sort at the default
    budget, one run, timed from the call to the last chunk yielded. The
    run is the one under the profiler: it holds few enough ops that the
    profiler's cost is small beside its seconds."""
    import numpy as np
    import torch
    _, avail = _host_memory()
    rows = EXT_ROWS
    cut = None
    # The host planes and the range buffers hold about 2x 18 B per row.
    while avail and rows * 18 * 2.5 > avail * 0.8:
        rows //= 2
        cut = (f"rows halved to {rows}: {avail / 2**30:.1f} GiB of host "
               f"memory available")
    schema = port.TableSchema.make([("k", "int64"), ("p", "double")])
    supplier_s = {"generate": 0.0, "hash": 0.0, "chunk": 0.0}
    in_sums = [0, 0]

    def supplier(i, n):
        def make():
            t0 = time.perf_counter()
            rng = np.random.default_rng(1000 + i)
            k = rng.integers(0, 1 << 60, size=n, dtype=np.int64)
            p = rng.random(n)
            t1 = time.perf_counter()
            h1, h2 = _hash_sums_np(k, p)
            in_sums[0] = (in_sums[0] + h1) % (1 << 64)
            in_sums[1] = (in_sums[1] + h2) % (1 << 64)
            t2 = time.perf_counter()
            chunk = port.ColumnarChunk.from_arrays(schema, {"k": k, "p": p},
                                                   device="cuda")
            torch.cuda.synchronize()
            supplier_s["generate"] += t1 - t0
            supplier_s["hash"] += t2 - t1
            supplier_s["chunk"] += time.perf_counter() - t2
            return chunk
        return make

    suppliers = []
    left, i = rows, 0
    while left > 0:
        n = min(EXT_BLOCK, left)
        suppliers.append(supplier(i, n))
        left -= n
        i += 1
    result: dict = {}

    def run() -> None:
        stats = port.SpillStats()
        t0 = time.perf_counter()
        total = 0
        prev_last = None
        out_sums = [0, 0]
        check_s = 0.0
        chunks = 0
        for out in port.external_sort(suppliers, ["k"], stats=stats,
                                      device="cuda"):
            tc = time.perf_counter()
            n = out.row_count
            k = out.columns["k"].data[:n]
            p = out.columns["p"].data[:n]
            valid = bool(out.columns["k"].valid[:n].all()) and \
                bool(out.columns["p"].valid[:n].all())
            ordered = bool((k[1:] >= k[:-1]).all())
            first, last = int(k[0]), int(k[-1])
            if not (valid and ordered):
                raise AssertionError(f"EXTSORT chunk {chunks} is not "
                                     "sorted (or has nulls)")
            if prev_last is not None and first < prev_last:
                raise AssertionError(f"EXTSORT chunk {chunks} starts below "
                                     "the previous chunk's last key")
            prev_last = last
            out_sums[0] += int(_splitmix64_torch(k).sum())
            out_sums[1] += int(_splitmix64_torch(
                k ^ p.view(torch.int64)).sum())
            total += n
            chunks += 1
            del out, k, p
            check_s += time.perf_counter() - tc
        wall_s = time.perf_counter() - t0
        result.update(stats=stats, wall_s=wall_s, total=total,
                      chunks=chunks, check_s=check_s,
                      out_sums=[x % (1 << 64) for x in out_sums])

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prof = _profile(run, hr, rx, EXT_RANGES, runs=1)
    peak = torch.cuda.max_memory_allocated()
    launches = prof["launched"]
    for kernel in PATH_KERNELS:
        if launches[kernel] <= 0:
            raise AssertionError(f"extsort: the main path launched no "
                                 f"{kernel} kernel")
    if result["total"] != rows:
        raise AssertionError(f"EXTSORT yielded {result['total']} rows, "
                             f"not {rows}")
    if result["out_sums"] != in_sums:
        raise AssertionError(f"EXTSORT hash sums {result['out_sums']} != "
                             f"the input's {in_sums}: a row was lost, "
                             "doubled or mispaired")
    stats = result["stats"]
    made_s = sum(supplier_s.values())
    net_s = result["wall_s"] - made_s - result["check_s"]
    passes_s = {name: ms / 1e3 for name, ms in
                prof["ranges_host_ms"].items()}
    out = {"rows_in": rows, "rows_out": result["total"], "cut": cut,
           "launches": launches, "wall_s": result["wall_s"],
           "rows_per_s": rows / result["wall_s"], "supplier_s": supplier_s,
           "check_s": result["check_s"], "net_s": net_s,
           "passes_host_s": passes_s, "chunks": result["chunks"],
           "stats": {"blocks": stats.blocks, "ranges": stats.ranges,
                     "resplits": stats.resplits,
                     "peak_range_rows": stats.peak_range_rows,
                     "budget_rows": stats.budget_rows,
                     "range_rows": stats.range_rows},
           "peak_bytes": peak, "profile": prof}
    _log(f"extsort: {rows} rows in {len(suppliers)} blocks"
         f"{' (' + cut + ')' if cut else ''}; every chunk sorted, in "
         f"order across chunks, hash sums match; launches {launches}; "
         f"one run {result['wall_s']:.3f} s ({rows / result['wall_s']:.0f} "
         f"rows/s) of which suppliers {made_s:.3f} s {supplier_s} and "
         f"output checks {result['check_s']:.3f} s, net {net_s:.3f} s; "
         f"passes (host s) {passes_s}; {stats.ranges} ranges, "
         f"{stats.resplits} resplits, budget {stats.budget_rows} rows; "
         f"peak memory {peak / 1e9:.3f} GB")
    _log(f"extsort profile: {json.dumps(prof)}")
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
    # The ranks of the mesh phase's part (b) run this script too.
    if sys.argv[1:2] == ["--gloo-cuda-probe"]:
        return _gloo_cuda_probe_rank(*sys.argv[2:])
    if sys.argv[1:2] == ["--mesh-rank"]:
        return _mesh_rank(*sys.argv[2:])
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
    from ytsaurus_tpu_torch.models import synthetic, tpch
    from ytsaurus_tpu_torch.ops import hist_rank as hr
    from ytsaurus_tpu_torch.ops import radix as rx
    from ytsaurus_tpu_torch.query import select_rows
    from ytsaurus_tpu_torch.query import vector

    # 1. environment
    smi = _nvidia_smi()
    _log(smi)
    _log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
         f"{torch.cuda.device_count()}")
    free_text, _ = _host_memory()
    _log(free_text)

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

    # 4. the slice: the queries, then the Sort operation and MVCC reads,
    # the mesh paths, and the spill sort
    keep: dict = {"seed": args.seed}
    paths = phase_slice(args.seed, hr, rx, tpch, select_rows, keep)
    paths.update(phase_strings(args.seed, hr, rx, synthetic, select_rows))
    vec = phase_vector(hr, rx, synthetic, vector, select_rows)
    paths.update(vec.pop("paths"))
    port = _port_entry_points()
    paths["sort"] = phase_sort(args.seed, hr, rx, port, keep)
    paths["tablet"] = phase_tablet(args.seed, hr, rx, port)
    dyntable = phase_dyntable(args.seed, hr, rx, port)
    paths.update(dyntable.pop("paths"))
    durable = phase_durable(args.seed, hr, rx, port)
    paths.update(durable.pop("paths"))
    queue = phase_queue(args.seed, hr, rx, port)
    paths.update(queue.pop("paths"))
    paths.update(phase_select(args.seed, hr, rx, tpch, port, keep))
    paths.update(phase_mesh(hr, rx, tpch, keep))
    keep.clear()
    with tempfile.TemporaryDirectory() as tmp:
        mesh_ranks = phase_mesh_ranks(args.seed, tmp)
    paths["extsort"] = phase_extsort(hr, rx, port)

    # 5. the kernels line
    times = phase_kernel_times(hr, rx, args.seed)
    kernels = []
    for name in TRACE_NAMES:
        per_path = {q: r["launches"][name] for q, r in paths.items()}
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"ytsaurus_tpu_torch/csrc/{name}.cu",
            "replaces": "ytsaurus_tpu/ops/pallas_radix.py:50",
            "launches": sum(per_path.values()),
            "launches_per_path": per_path,
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
              "window_rows": WINDOW_ROWS, "sort_rows": SORT_ROWS,
              "tablet_versions": TABLET_VERSIONS, "dyntable": dyntable,
              "durable": durable, "queue": queue,
              "extsort_rows": paths["extsort"]["rows_in"],
              "strings_rows": STRINGS_ROWS, "vector_rows": VECTOR_ROWS,
              "vector": vec, "mesh_ranks": mesh_ranks,
              "seed": args.seed, "argsort": argsort,
              "paths": paths, "kernels": kernels,
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
