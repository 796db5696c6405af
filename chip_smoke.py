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
     library must load; it fails otherwise): a history of 6,000,000
     base versions (g and v) and 2,000,000 later versions on random keys
     (99% partial writes of v, 1% deletes), interleaved at random over
     timestamps 1..8,000,000 (each key's first version is its base), so
     the compaction cut supersedes versions; cut by timestamp into 4
     chunks of 2,000,000 versions, each sorted by (k, -ts) with numpy and
     written
     through FsChunkStore.write_chunk at zlib_6 into a temporary
     directory, then mounted in a Tablet on the card by their chunk ids;
     250,000 writes through TransactionManager in 250 transactions
     (90% partial writes of v to existing keys, 9% new keys writing g and
     v, 1% deletes; writes/s on the host); flush() once under the
     profiler (the store's device sort and the serialize + write apart);
     read_snapshot at MAX_TIMESTAMP cold (5 decodes: decode, host -> device
     copy and merge apart), then at 4,000,000 through the path runner,
     then a latest read that must hit the snapshot cache; GROUP BY g over
     both snapshots (REPS warm runs); lookup_rows of 4,096 keys (history
     only, rewritten, deleted, new, absent; REPS runs with the row cache
     cleared, one that hits it); compact(retention_timestamp=4,000,000)
     once under the profiler: one chunk of the oracle's retained row
     count, the old files gone, and both reads unchanged. Every result
     is held to a numpy oracle (the TABLET oracle over the history and
     the writes at their commit timestamps), exactly;
     DURABLE: the first 5 of SELECT_8's 8 chunks (below; 40,000,000 rows,
     cut from all 8 to fit CELLS) stored through the storage layer,
     each read a query through coordinate_and_execute over lazy shards
     that decode the chunks onto the card, held to SELECT_8's oracle over
     those rows. An
     FsChunkStore holds the 5 chunks erasure-coded as lrc_12_2_2 (12 data
     and 4 parity parts; every part's sha256 recorded); chunks 0-1 then
     lose one data part each (both locality groups), chunks 2-3 two data
     parts and one parity part, chunk 4 none; read 1 repairs (exactly
     the data parts and, for a single loss, only its group's local
     parity are read; the
     `chunks.erasure.part_read` site counts them) and every rewritten
     part must hash as before; read 2 reads data parts only and repairs
     nothing (profiled); verify_chunk holds for all 5; a sixth chunk that
     lost parts 0, 1, 2 and 12 raises ChunkFormatError. Then a
     ReplicatedChunkStore over 4 locations at replication factor 3 (the
     chunks written by the client's write_table_chunks): one
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
     65,536 distinct 24-byte strings, from --seed + 11: 2,200,000 rows
     (cut from 4,200,000 to fit CELLS) appended in batches of 1,000 at
     their own timestamps, flushed at every 1,000,000 rows (2 chunks;
     200,000 rows stay in the store); 64 read_rows of 10,000 rows (4
     across a chunk boundary or the store's base), each against the
     oracle; trim_rows(1,500,000) removes the first chunk's file, reads
     below and above the trim point; snapshot at row 1,800,000's
     timestamp and the latest (host seconds, profiled device ms), each
     queried on the card by a GROUP BY producer under
     WHERE $row_index >= 1600000 (counts exact, sums to rtol 1e-9) and
     an ORDER BY seq DESC, producer LIMIT 100 (rows and order exact);
     the first 80,000 consumed rows through dumps_rows / loads_rows in yson,
     json, dsv and schemaful_dsv and dumps_skiff / loads_skiff, each
     giving back the same rows (host seconds and bytes per format);
     CLIENT: the slice through ytsaurus_tpu_torch.client.connect(tmp,
     device="cuda") and the client's methods alone: SELECT's table (below)
     published into Cypress as 8 chunks of 8,000,000 rows
     (publish_table_chunks) and a 10,000-row dimension table written from
     row dicts; select_rows of SELECT_8's query, of a k range that chunk
     statistics prune to one chunk (shards_pruned 7), of the join with the
     dimension grouped by name (both radix kernels must launch), and of
     SELECT_8's query with explain_analyze (its top spans and compile /
     execute split printed); run_sort of the 64,000,000 rows on (g, k) on
     the card (both radix kernels; the order exactly np's, the device
     branch under YT_TPU_HBM_BUDGET), an ORDER BY g, k LIMIT 1000 over the
     output; run_merge of the dimension with itself, sorted, and run_erase
     of the result; a master snapshot; a dynamic table (k key, g, v)
     mounted and written with 500,000 rows in 500 tablet transactions,
     4,096 lookups from 16 threads (fewer gateway batches than calls),
     a GROUP BY g, unmount; a restart (connect(..., fresh=True) in this
     process: the master recovers from its snapshot and changelog), then
     mount, the same lookups and selects, and every acknowledged write
     read back; 131,072 vectors at dim 256 written, flushed and remounted,
     then nearest_rows from 16 threads through the vector batcher (fewer
     batches than callers), each held to batched_nearest's. Each device
     stage runs once under the profiler, after 1,000 tiny kernels: host
     seconds, device ms, idle share, peak memory, the chunk cache's hits
     and misses, radix launches, and it must put work on the device; a
     host stage (no port kernel, no device work worth a trace) runs once
     on the host's clock between two synchronizes, with no profiler
     session, its launches read from the counters;
     FRONT: the front doors over CLIENT's cluster as CLIENT leaves it
     (its open client after the restart: the 64M-row table and the
     dimension, no second table), on 127.0.0.1:0: an HttpProxy over
     Driver(client), an RpcServer([DriverService(client)]) behind a
     TcpProxy, and the client's QueryTracker. REST: /ping, /api/v4,
     SELECT_8's query through POST /api/v4/select_rows (10,000 groups as
     JSON; one counted run, 5 warm), the join grouped by name and the
     join with explain_analyze (both radix kernels must launch), a PUT
     write_table of 131,072 rows as a JSON body and its read_table back
     in JSON. RPC through the TCP proxy: 16 threads x 16 driver
     select_rows calls of a pruned 100-row k range through
     RetryingChannels that know only the proxy's address; 100,000 rows into a dynamic table in
     100 wire transactions of 1,000 (start_transaction, insert_rows_tx,
     commit_transaction); 4,096 lookups from 16 threads; every
     acknowledged write read back. The query tracker: 8 asynchronous QL
     queries (the join grouped by name, whose launches are counted alone,
     then 7 at once), 4 engine="chyt" queries (a JOIN with GROUP BY and
     ORDER BY ... LIMIT, countIf / sumIf, a FROM-subquery whose inner
     GROUP BY's 10,000 groups are materialized into a chunk on the card
     (both radix kernels must launch), and toString, which must fail with
     its code), list_queries and abort_query of a running query. Every
     answer against numpy; each stage runs as CLIENT's do and also
     records its requests and bytes on the wire;
     OPS: the operations plane through connect(tmp, device="cuda") alone:
     a 4,194,304-row table from --seed + 23 (k unique, g over 65,536
     values spread below 2^40 as g0 * 2654435761 mod 2^40, v < 1000) in 4
     chunks, run_sort'ed by (g, k); run_reduce of a Python reducer (sum
     and count of v per g) in 16 key-aligned jobs: every group exact and
     reduced once; run_map_reduce of a Python mapper (g, 2v) and reducer
     over the first 1,048,576 rows, unsorted, in 8 partitions: every sum
     exact; over the first 131,072 rows in json, run_map of a python3
     filter command, run_reduce of a command reducer, and run_map_reduce
     of map and reduce commands under scheduler.publish=crash-once (at
     the output's publish): the operation's @state stays running, the
     live operation is forgotten and revive_operations completes it from
     its snapshot (revived_jobs > 0) with the oracle's output;
     run_vanilla of a gang of 2 tasks x 2 jobs, and of a task that its
     memory_limit kills, whose failure carries its probable_cause. The
     sorting stages must launch both radix kernels;
     DERIVED: replication and the derived tables through connect alone:
     a sorted dynamic table (k key, v, s) in 2 tablets with a sync
     replica on its root and an async one on a second root, 50,000 rows
     (from --seed + 29) in transactions of 1,000, replicated; a select
     and 4,096 lookups on each replica equal to the oracle; the async
     replica disabled, written past, enabled and caught up; one chaos era
     switch with rows committed on both sides of it, looked up on each
     replica; a secondary index on v serving 64 selects (each through
     fetch_via_index, each equal to the scan's oracle); a 262,144-row
     queue appended in 16 batches of 16,384 with a GROUP BY view
     refreshed after each (both radix kernels must launch), equal to the
     full GROUP BY, and a consumer's 64 pulls and advances; backup_table
     at a timestamp, 10,000 more rows, restore_table_backup equal to the
     table at that timestamp; the upstream unmounted and looked up through
     its replicas. Each stage of OPS and DERIVED runs as CLIENT's do;
     CELLS: the master's quorum and its cells in this process on
     127.0.0.1:0, as server/daemon.py composes them across processes:
     three data nodes (DataNodeService over a chunk location and a
     journal directory each, heartbeating into a NodeTracker over RPC),
     a Master on a QuorumWal over them (write quorum 2 of 3) elected by a
     LeaderElector, two ClockServer peers electing over the same nodes
     behind ClockServices, a QuorumTimestampProvider over both as the
     cluster's clock, and a YtCluster on the card over an RpcChunkStore
     (2 replicas). Bring-up (the clock's and the master's election
     seconds, the WAL's rate alone over 100 sets); 16,777,216 rows
     (k, g < 10,000, v < 1000, from --seed + 29) published as 2 chunks,
     each on 2 of the 3 nodes, SELECT_8's query cold (both blobs over
     RPC, decoded onto the card) and 5 times warm, the join with a
     10,000-row dimension grouped by name (both radix kernels); a portal
     //cell to a second root on the card, 1,048,576 rows written under it
     through the primary, GROUP BY g ORDER BY sum(v) DESC, g LIMIT 100
     through the primary's routed front door (multicell.delegate_for),
     and the portal's removal, whose exit Hive dismantles with exactly
     one message; 100,000 rows into a sorted dynamic table in 100
     transactions with the clock leader killed after the 50th (the
     standby takes over, every commit timestamp above the one before),
     4,096 lookups from 16 threads and the read-back; node 3 stopped and
     1,000 Cypress mutations each on 2 of 3 journals, the master closed,
     node 3 back, a new Master on a fresh path over the same nodes at
     epoch + 1 holding every acknowledged mutation (check_wal on the
     recovered log, node 3 caught up), a new YtCluster over it whose
     SELECT_8 and read-back agree without waiting for the next second;
     Sequoia over a 1,000-node namespace (maps and documents four levels
     deep) built through the quorum WAL: enable(), 4,096 resolves, 256
     read_list / read_get calls, 100 more mutations with an aborted
     transaction, verify() empty. Each stage runs as CLIENT's do and also
     records the RPC requests and bytes of every server;
     CLUSTER: the multi-process cluster (environment/local.py): a
     LocalCluster of a primary daemon on the card (--device cuda) and
     three data-node daemons (2 replicas), this process its client
     through connect_remote(..., device="cuda"); it fails if the card's
     compute mode is Exclusive_Process. Bring-up (spawn to ready);
     16,777,216 rows (k, g < 10,000, v < 1000, from --seed + 31)
     published from here as 2 chunks onto the nodes; SELECT_8's query
     served by the primary cold and 5 times warm; the join with a
     10,000-row dimension, after which the primary's orchid
     /query/device must name the card with both radix kernels launched
     there; node 3 killed, a remote run_sort of the table by (g, k) in
     this process (both radix kernels here, read from the surviving
     replicas) held to numpy's lexsort, then GROUP BY g ORDER BY sum(v)
     DESC, g LIMIT 100 over the sorted table through the primary; node 3
     and the primary restarted together (restart_node(..., wait=False),
     restart_primary()); a dynamic table over RPC (100,000 rows in 100
     transactions) and a command map ("cat") of 65,536 rows run by the
     nodes' exec service, while the new primary's tracer warms up; then
     SELECT_8 cold on the new primary process (its metadata from its WAL,
     the chunks decoded anew onto the card, both kernels launched there
     again); then the dynamic table's 4,096 lookups from 16 threads and
     its read-back select. The daemons start while this process makes
     the data and oracles. Each stage records host s; a stage whose
     kernels run in this process runs as CLIENT's device stages do (device
     ms, idle share, the trace holding every launch); a stage served by
     the primary records the primary's launches (the difference of its
     /query/device counts) and the primary's own device trace around it
     (/query/device/trace/start and /stop: device busy ms, idle share of
     the window, and the trace holding every launch of the primary);
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
     512,000,000 rows (cut from its 1,000,000,000) in 16,000,000-row
     blocks, each made lazily in
     its supplier by np.random.default_rng(1000 + i), through
     external_sort at the default 8 GiB budget (10 ranges at 1B rows);
     one run (under the profiler), timed from the call to the last chunk
     yielded, with the suppliers' seconds, the output checks' seconds and
     each pass's host seconds. Every chunk sorted, each chunk's first key
     at least the previous chunk's last, the row total, and two
     order-independent wrapping sums, splitmix64(k) and
     splitmix64(k ^ bits(p)), equal between the input (numpy on 8
     threads, in the suppliers) and the output (torch, on the card). The
     oracles of SORT, TABLET, DYNTABLE and VECTOR are numpy's orders and
     float64 measures, computed the faster ways of _stable_argsort,
     _newest_first_order and vector_measures' threads; SORT's and
     TABLET's tables and oracles are made on a thread (_Ahead) while the
     slice, STRINGS and VECTOR run on the card. If the host's
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
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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
EXT_ROWS = 512_000_000       # rows of the spill sort: BASELINE config 5's
                             # 1,000,000,000 cut to fit the new phases
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
HASH_THREADS = 8             # threads of EXTSORT's input hash (_hash_sums_np)
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
# torch.cuda._sleep's kernel. A short one (MARK_CYCLES), launched alone
# just before a profiled run, marks where the run starts on the device's
# clock. Long ones (pads) open and close each profiler session: the
# profiler drops every device event that its clock places outside the
# session's host-clock window, and the two clocks can part by a hundred
# milliseconds within one session (CLIENT's select_8_restarted), so a
# run's first or last kernels would be lost (_profile). The opening pad
# lasts PAD_MS; the closing one PAD_SHARE of the run's wall time, at
# least PAD_MS and 3x the largest lag of the device's clock seen so far,
# at most PAD_MAX_MS.
MARK_KERNEL = "spin_kernel"
MARK_CYCLES = 1_000
PAD_MS = 20.0
PAD_SHARE = 0.05
PAD_MAX_MS = 250.0
PAD_CYCLES_PER_MS = 1_980_000    # the H100 SXM's top SM clock: a pad lasts
                                 # at least its ms at any clock
_LAG = {"us": 0.0}               # the largest lag seen in this process
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


def _profile(run, hr, rx, ranges=(), runs: int = 2, first=None,
             detail: bool = True) -> dict:
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
    busy time. Only the last run counts. Its device events are told from
    the earlier runs' on the device's own clock: a marker kernel
    (MARK_KERNEL) runs alone between them, and the run's events are the
    ones that start after it ends. The host clock is not used for that:
    late in a long process, traces placed a run's first kernels before
    the run's host range (VECTOR, CLIENT's short stages), which gave them
    to the runs before it. `clock_lead_us` is the run range's host start
    less the marker's end (tens of microseconds, more where the host
    stalls between the two). The profiler drops device events that its
    clock places outside the session, so a pad kernel opens the session
    and one closes it (PAD_MS, PAD_SHARE; `closing_pad_ms`).
    `clock_skew_us` is the closing pad's device start less its launch's
    host time: how far the device's clock lags the host's (leads where
    negative), give or take the few microseconds a launch takes. Where
    the trace dropped the marker, the run starts at the run range's host
    start plus that skew (`device_clock` is false), and the count check
    still holds. A run that put no work on the device raises (a host
    stage runs without a session: `_client_stage`'s `host_only`).
    Without `detail` (the stages of CLIENT and the phases after it) the
    rows come from the raw trace (`_trace_rows`): no ranges, and
    `top_ops_self_device_ms` is None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(PAD_MS * PAD_CYCLES_PER_MS))
        for _ in range(runs - 1):
            (first or run)()
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        _reset_launches(hr, rx)
        with record_function(RUN_RANGE):
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        pad_ms = min(PAD_MAX_MS, max(PAD_MS, PAD_SHARE * wall_us / 1e3,
                                     3e-3 * _LAG["us"]))
        torch.cuda._sleep(int(pad_ms * PAD_CYCLES_PER_MS))
        torch.cuda.synchronize()
    launched = _launches(hr, rx)
    # (name, device type, user annotation?, start us, end us) per event.
    events = [(e.name, e.device_type, getattr(e, "is_user_annotation",
                                              False),
               e.time_range.start, e.time_range.end)
              for e in prof.events()] if detail else _trace_rows(prof)
    run_cpu = [(t0, t1) for name, dev, _, t0, t1 in events
               if name == RUN_RANGE and dev == DeviceType.CPU]
    run_start = min(r[0] for r in run_cpu)
    run_end = max(r[1] for r in run_cpu)
    spins = [(t0, t1) for name, dev, _, t0, t1 in events
             if dev == DeviceType.CUDA and MARK_KERNEL in name]
    marks = [t1 for t0, t1 in spins if t1 - t0 < PAD_MS * 500]
    closing = [t0 for t0, t1 in spins if t1 - t0 >= PAD_MS * 500
               and t0 > (max(marks) if marks else run_start)]
    pad_launch = min((t0 for name, dev, _, t0, _t1 in events
                      if dev == DeviceType.CPU and
                      name.startswith("cudaLaunch") and t0 >= run_end),
                     default=run_end)
    skew_us = max(closing) - pad_launch if closing else None
    _LAG["us"] = max(_LAG["us"], skew_us if closing else pad_ms * 1e3)
    device_start = max(marks) if marks else run_start + (skew_us or 0.0)
    by_kernel: dict = {}
    spans = []
    traced = dict.fromkeys(TRACE_NAMES, 0)
    anywhere = dict.fromkeys(TRACE_NAMES, 0)
    for name, dev, annotation, t0, t1 in events:
        if dev != DeviceType.CUDA or annotation or MARK_KERNEL in name:
            continue
        for kernel, trace_name in TRACE_NAMES.items():
            anywhere[kernel] += trace_name in name
        if t0 < device_start:
            continue
        by_kernel[name] = by_kernel.get(name, 0.0) + (t1 - t0)
        spans.append((t0, t1))
        for kernel, trace_name in TRACE_NAMES.items():
            traced[kernel] += trace_name in name
    if traced != launched:
        raise AssertionError(
            f"the trace holds {traced} port kernels, the run launched "
            f"{launched} (in the whole session, with the runs before it: "
            f"{anywhere}; marker {'found' if marks else 'dropped'}, "
            f"closing pad {'found' if closing else 'dropped'}, clock skew "
            f"{skew_us} us, closing pad {pad_ms} ms, "
            f"{len(spans)} device events in the run)")
    listed_us = sum(by_kernel.values())
    busy_us = _busy_us(spans)
    if busy_us <= 0:
        raise AssertionError("the trace holds no device time")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    port_ms = {kernel: sum(us for name, us in by_kernel.items()
                           if trace_name in name) / 1e3
               for kernel, trace_name in TRACE_NAMES.items()}
    by_op = None
    in_range = {name: 0.0 for name in ranges}
    host_range = {name: 0.0 for name in ranges}
    if detail:
        op_acc: dict = {}
        for e in prof.events():
            if e.device_type != DeviceType.CPU or \
                    not run_start <= e.time_range.start <= run_end:
                continue
            if e.self_device_time_total > 0:
                acc = op_acc.setdefault(e.name, [0.0, 0])
                acc[0] += e.self_device_time_total
                acc[1] += 1
            if e.name in in_range:
                in_range[e.name] += e.device_time_total
                host_range[e.name] += e.time_range.end - e.time_range.start
        by_op = [[key, us / 1e3, count] for key, (us, count) in sorted(
            op_acc.items(), key=lambda kv: -kv[1][0])[:8]]
    if ranges and not any(in_range.values()):
        raise AssertionError(f"the trace shows no device time in the "
                             f"ranges {list(ranges)}")
    return {
        "ranges_ms": {name: us / 1e3 for name, us in in_range.items()},
        "ranges_share": {name: us / busy_us if busy_us else 0.0
                         for name, us in in_range.items()},
        "ranges_host_ms": {name: us / 1e3 for name, us in host_range.items()},
        "wall_ms": wall_us / 1e3,
        "device_clock": bool(marks),
        "clock_lead_us": run_start - device_start,
        "clock_skew_us": skew_us,
        "closing_pad_ms": pad_ms,
        "launched": launched,
        "traced": traced,
        "port_kernels_ms": port_ms,
        "listed_sum_ms": listed_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1 - busy_us / wall_us,
        "top_kernels_ms": [[name[:90], us / 1e3] for name, us in top],
        "top_ops_self_device_ms": by_op,
    }


def _warm_profiler() -> None:
    """An empty profiler session (CPU and CUDA activity): the tracer's
    one-time start-up, paid off the timed paths."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass


def _trace_rows(prof) -> list:
    """`_profile`'s event rows straight from the profiler's raw trace,
    without the event tree torch builds for `prof.events()` (seconds for
    a stage of many small ops; the rows need none of it)."""
    rows = []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        rows.append((e.name(), e.device_type(),
                     getattr(e, "is_user_annotation", lambda: False)(),
                     e.start_ns() / 1e3, e.end_ns() / 1e3))
    return rows


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
    splitmix64(k ^ bits(p)), each wrapping mod 2^64; over HASH_THREADS
    slices of the block on threads (numpy's ufuncs release the GIL)."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    ku, pu = k.view(np.uint64), p.view(np.uint64)
    step = max(1, -(-len(ku) // HASH_THREADS))

    def part(lo):
        x = ku[lo:lo + step]
        return (int(_splitmix64_np(x).sum(dtype=np.uint64)),
                int(_splitmix64_np(x ^ pu[lo:lo + step]).sum(dtype=np.uint64)))

    with ThreadPoolExecutor(HASH_THREADS) as pool:
        parts = list(pool.map(part, range(0, len(ku), step)))
    return tuple(sum(h[i] for h in parts) % (1 << 64) for i in (0, 1))


def _stable_argsort(keys):
    """np.argsort(keys, kind="stable"), in a fraction of its time on
    random 64-bit keys: an unstable argsort, then each run of equal keys
    put back in index order, which gives the same permutation."""
    import numpy as np
    order = np.argsort(keys)
    ordered = keys[order]
    tie = np.flatnonzero(ordered[1:] == ordered[:-1])
    if len(tie) > 4096:
        return np.argsort(keys, kind="stable")
    if len(tie):
        first = np.r_[True, tie[1:] != tie[:-1] + 1]
        last = np.r_[tie[1:] != tie[:-1] + 1, True]
        for lo, hi in zip(tie[first], tie[last] + 2):
            order[lo:hi].sort()
    return order


def _newest_first_order(k, ts):
    """np.lexsort((-ts, k)): by key, then newest version first, ties in
    index order. When k fits in 37 bits and ts in 26, the stable argsort
    of one packed key, which is the same order and several times faster
    at 64M versions."""
    import numpy as np
    if len(k) and k.min() >= 0 and k.max() < 1 << 37 and \
            ts.min() >= 0 and ts.max() < 1 << 26:
        return _stable_argsort((k << 26) | ((1 << 26) - 1 - ts))
    return np.lexsort((-ts, k))


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


class _Ahead:
    """Host work of a later phase (its table and numpy oracle), done on a
    thread while the phases before it run on the card; `after` makes it
    wait for another _Ahead first, so that one such thread runs at a
    time. `result()` gives (value, seconds of the work, seconds the
    caller waited for it)."""

    def __init__(self, fn, *args, after=None):
        self._box: dict = {}
        self._thread = threading.Thread(target=self._run,
                                        args=(fn, args, after), daemon=True,
                                        name=f"ahead-{fn.__name__}")
        self._thread.start()

    def _run(self, fn, args, after) -> None:
        if after is not None:
            after._thread.join()
        t = time.perf_counter()
        try:
            self._box["value"] = fn(*args)
        except BaseException as exc:   # noqa: BLE001 — raised by result()
            self._box["error"] = exc
        self._box["s"] = time.perf_counter() - t

    def result(self) -> tuple:
        t = time.perf_counter()
        self._thread.join()
        if "error" in self._box:
            raise self._box["error"]
        return self._box.pop("value"), self._box["s"], \
            time.perf_counter() - t


def _sort_oracle(seed: int) -> dict:
    """SORT's table from --seed and its oracle: k and p in numpy's stable
    argsort order by k."""
    import numpy as np
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 60, size=SORT_ROWS, dtype=np.int64)
    p = rng.random(SORT_ROWS)
    order = _stable_argsort(k)
    return {"k": k, "p": p, "want_k": k[order], "want_p": p[order]}


def phase_sort(seed: int, hr, rx, port, keep: dict, ahead: _Ahead) -> dict:
    """SORT: bench.py --config sort at its accelerator size, through
    sort_chunk; k and p exactly as numpy's stable argsort orders them
    (`ahead`: `_sort_oracle` on a thread during the earlier phases). The
    table's arrays and the check go into `keep` for the mesh phase."""
    import torch
    data, oracle_s, waited_s = ahead.result()
    k, p, want_k, want_p = data["k"], data["p"], data["want_k"], \
        data["want_p"]
    del data
    t0 = time.perf_counter()
    schema = port.TableSchema.make([("k", "int64"), ("p", "double")])
    chunk = port.ColumnarChunk.from_arrays(schema, {"k": k, "p": p},
                                           device="cuda")
    torch.cuda.synchronize()
    _log(f"sort table: {SORT_ROWS} rows, capacity {chunk.capacity}, onto "
         f"the card in {time.perf_counter() - t0:.1f} s (seed {seed}); "
         f"table and oracle (numpy stable argsort) {oracle_s:.1f} s on a "
         f"thread during the earlier phases, {waited_s:.1f} s waited")

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


def _gather(arrays: dict, idx) -> dict:
    """{name: a[idx]} with the gathers on HASH_THREADS threads (numpy
    releases the GIL in them): the same arrays in a third of the time
    for TABLET's seven 64M-row columns."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(HASH_THREADS) as pool:
        return dict(zip(arrays, pool.map(lambda a: a[idx],
                                         arrays.values())))


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
    return _gather({"k": k, "$timestamp": ts, "$tombstone": tomb, "g": g,
                    "$w:g": wg, "v": v, "$w:v": wv}, perm)


def _tablet_oracle(d: dict, read_points) -> dict:
    """numpy MVCC: versions in np.lexsort((-ts, k)) order; per read
    timestamp, the newest tombstone at or below it bounds each key's
    versions, each column takes its newest written value after it; the
    GROUP BY of those rows; the rows a compaction at each timestamp
    keeps."""
    import numpy as np
    n = len(d["k"])
    order = _newest_first_order(d["k"], d["$timestamp"])
    s = _gather(d, order)
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


def _tablet_ahead(seed: int) -> tuple:
    """TABLET's versions from --seed and their oracle at its two read
    timestamps."""
    from ytsaurus_tpu_torch.tablet.timestamp import MAX_TIMESTAMP
    versions = _tablet_data(seed)
    return versions, _tablet_oracle(versions, (MAX_TIMESTAMP,
                                               TABLET_READ_TS))


def phase_tablet(seed: int, hr, rx, port, ahead: _Ahead) -> dict:
    """TABLET: a sorted dynamic table read through MVCC, then GROUP BY
    (`ahead`: `_tablet_ahead`, the versions and their oracle, on a thread
    during the earlier phases)."""
    import numpy as np
    import torch
    (versions, oracle), oracle_s, waited_s = ahead.result()
    t0 = time.perf_counter()
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
    read_points = (port.MAX_TIMESTAMP, TABLET_READ_TS)
    _log(f"tablet: {n} versions of {TABLET_BASE} keys ({n - TABLET_BASE} "
         f"later: {1 - TABLET_DELETE_SHARE:.0%} partial writes of v, "
         f"{TABLET_DELETE_SHARE:.0%} deletes), capacity {chunk.capacity}, "
         f"{chunk.nbytes / 1e9:.3f} GB on the card, onto the card in "
         f"{made_s:.1f} s (seed {seed}); versions and oracle (numpy) "
         f"{oracle_s:.1f} s on a thread during the earlier phases, "
         f"{waited_s:.1f} s waited")
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

# The history, cut from 24,000,000 keys and 8,000,000 later versions to
# fit CELLS in the check's time (PERF.md §4).
DYN_KEYS = 6_000_000         # keys, each with one base version (g and v)
DYN_LATER = 2_000_000        # later versions on random keys
DYN_CHUNK = 2_000_000        # versions per mounted chunk, cut by timestamp
# Writes into the store: a quarter of max_dynamic_store_row_count's
# default (1,000,000), cut to fit FRONT, then CELLS, in the check's time
# (as CLIENT's were).
DYN_WRITES = 250_000
DYN_TX_ROWS = 1_000          # rows per transaction
DYN_NEW_SHARE = 0.09         # writes that add a key (g and v)
DYN_WRITE_DELETES = 0.01     # writes that delete a key; the rest write v
DYN_READ_TS = 4_000_000      # the historical read and the compaction cut
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
            order = _newest_first_order(part["k"], part["$timestamp"])
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
        if meta["row_count"] != DYN_WRITES or \
                len(tablet.chunk_ids) != n // DYN_CHUNK + 1:
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
# SELECT's first chunks stored (cut from all 8 to fit CELLS, PERF.md §4).
DURABLE_CHUNKS = 5
# Parts each LRC chunk loses before the first read: chunks 0-1 one data
# part each (both locality groups hit), chunks 2-3 two data parts and one
# parity part (a global parity, then a local one), chunk 4 none.
DURABLE_LOST = [(1,), (7,), (0, 6, 14), (3, 11, 12), ()]
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
    """DURABLE: the select table's first 5 chunks (40M rows) stored
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
    from ytsaurus_tpu_torch.client import write_table_chunks
    from ytsaurus_tpu_torch.errors import EErrorCode, YtError
    from ytsaurus_tpu_torch.utils import failpoints
    t_phase = time.perf_counter()
    co = _coordinator_entry_points()
    ev = co.Evaluator("cuda")
    codec = get_erasure_codec(DURABLE_CODEC)
    arrays = _select_arrays(seed)[:DURABLE_CHUNKS]
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

        chunks = [port.ColumnarChunk.from_arrays(schema, a, device="cuda")
                  for a in arrays]
        t = time.perf_counter()
        # Written as a client's publish writes a table's chunks.
        ids, _ = write_table_chunks(rs, chunks)
        rep["write"] = {"host_s": time.perf_counter() - t,
                        "bytes_on_disk": sum(_tree_bytes(r) for r in roots)}
        del chunks
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

QUEUE_ROWS = 2_000_000         # rows flushed into chunks (cut from
                               # 4,000,000 to fit CELLS, PERF.md §4)
QUEUE_TAIL = 200_000           # rows left in the dynamic store
QUEUE_BATCH = 1_000            # rows per append, each at its own timestamp
QUEUE_FLUSH = 1_000_000        # max_dynamic_store_row_count's default
QUEUE_PRODUCERS = 64
QUEUE_PAYLOADS = 65_536        # distinct 24-byte payloads
QUEUE_CONSUMERS = 64
QUEUE_READ = 10_000            # rows per consumer read
QUEUE_FORMAT_ROWS = 80_000     # consumed rows through the formats (cut from
                               # all 640,000 to 320,000, then to 160,000 and
                               # 80,000, to fit the new phases)
QUEUE_TRIM = 1_500_000
QUEUE_SNAPSHOT_ROW = 1_800_000  # snapshot(ts) at this row's timestamp
QUEUE_GROUP_FROM = 1_600_000   # the GROUP BY's least $row_index
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
    """QUEUE: an ordered tablet on the card. 2,200,000 message rows
    appended in batches of 1,000 (each at its own timestamp), flushed at
    every 1,000,000 rows (2 chunks, 200,000 rows left in the store); 64
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
        # Consumers: offsets spread over the log, 2 across each chunk
        # boundary and the store's base.
        edges = [b * QUEUE_FLUSH + d_
                 for b in range(1, QUEUE_ROWS // QUEUE_FLUSH + 1)
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
        if store.exists(first) or \
                len(tablet.chunk_ids) != QUEUE_ROWS // QUEUE_FLUSH - 1:
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
        out["formats"] = _queue_formats(consumed[:QUEUE_FORMAT_ROWS], port)
        _dyntable_log("queue formats", out["formats"])
        del consumed, tablet
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    _log(f"queue: {out['seconds']:.1f} s in all")
    return out


# --- CLIENT: the port's own client over every plane below it ---------------

CLIENT_DIM_ROWS = 10_000       # the dimension table, written as row dicts
CLIENT_NAMES = 100             # distinct names in the dimension table
CLIENT_RANGE = (24_000_000, 24_001_000)   # k range inside SELECT's chunk 3
# Rows written into the dynamic table: half of max_dynamic_store_row_count's
# default (1,000,000), cut because CLIENT took 187 s on the card at the
# full store, above the 180 s it may take.
CLIENT_DYN_ROWS = 500_000
CLIENT_DYN_TX_ROWS = 1_000     # rows per tablet transaction
CLIENT_DYN_KEYS = 4_000_000    # keys drawn without repeats from [0, this)
CLIENT_LOOKUPS = 4_096
CLIENT_THREADS = 16            # lookup and NEAREST caller threads
CLIENT_LOOKUP_BATCH = 16       # keys per lookup_rows call
CLIENT_VEC_ROWS = 131_072      # 128 MB of float32 vectors at dim 256 (cut
                               # from 262,144 to fit the new phases)
CLIENT_VEC_DIM = 256           # VECTOR's headline width
CLIENT_VEC_TX_ROWS = 16_384
CLIENT_VEC_K = 8
CLIENT_T = "//bench/t"
CLIENT_QUERY = ("g, sum(v) AS s, count(*) AS c FROM [//bench/t] "
                "WHERE v < 900 GROUP BY g")
CLIENT_JOIN = ("name, sum(v) AS s, count(*) AS c FROM [//bench/t] "
               "JOIN [//bench/dim] USING g GROUP BY name")
CLIENT_ACC_GROUP = "g, sum(v) AS s, count(*) AS c FROM [//bench/acc] GROUP BY g"


def _client_warmup(kernels: int = 1_000) -> None:
    """The device work a CLIENT stage's profiler session starts with, none
    of it a port kernel: `kernels` one-element adds, so that the session
    holds device activity before its marker and its stage (a stage that
    launches few kernels of its own lost them to the start of a session
    late in a long process), then the peak memory reset, so that a
    stage's peak is its own."""
    import torch
    x = torch.zeros(1, device="cuda")
    for _ in range(kernels):
        x.add_(1.0)
    del x
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _client_stage(name: str, run, hr, rx, cache, radix: bool = False,
                  host_only: bool = False, extra=None) -> tuple:
    """One stage of the CLIENT phase (and of FRONT, OPS, DERIVED, CELLS
    and CLUSTER): its result and its record (host seconds, peak device
    memory, the chunk cache's hits and misses during the stage (`cache()`
    gives the live client's cache, or None), the port kernels' launches
    from their counters, and `overhead_s`, the stage's seconds outside
    its run). A device stage runs once under the profiler, after
    `_client_warmup` in the same session: its record adds device busy ms
    and idle share, the trace must hold every launch one for one, and
    `overhead_s` is the warm-up, pads, profiler start, stop and analysis;
    it fails if the stage put no work on the device. A `host_only` stage
    (it launches no port kernel and no device work worth a trace) runs
    once on the host's clock, between two `torch.cuda.synchronize()`,
    with no profiler session: its device fields are None. With `radix`,
    it fails unless both radix kernels were launched."""
    import torch
    box = {}

    def once():
        box["out"] = run()

    def counts():
        c = cache()
        return (c.hits, c.misses) if c is not None else (0, 0)

    t = time.perf_counter()
    hits, misses = counts()
    if host_only:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(hr, rx)
        t_run = time.perf_counter()
        once()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t_run
        prof = {"launched": _launches(hr, rx), "traced": None}
        rec = {"host_s": host_s, "device_busy_ms": None,
               "idle_share": None, "traced": False}
    else:
        prof = _profile(once, hr, rx, runs=2, first=_client_warmup,
                        detail=False)
        host_s = prof["wall_ms"] / 1e3
        rec = {"host_s": host_s,
               "device_busy_ms": prof["device_busy_ms"],
               "idle_share": prof["idle_share"], "traced": True,
               "clock_lead_us": prof["clock_lead_us"],
               "clock_skew_us": prof["clock_skew_us"]}
    rec.update({"peak_bytes": torch.cuda.max_memory_allocated(),
                "cache_hits": counts()[0] - hits,
                "cache_misses": counts()[1] - misses,
                "launches": prof["launched"],
                "overhead_s": time.perf_counter() - t - host_s,
                **(extra or {})})
    if radix:
        for kernel in PATH_KERNELS:
            if rec["launches"][kernel] <= 0:
                raise AssertionError(f"{name}: no {kernel} kernel was "
                                     "launched")
    _log(f"{name}: {json.dumps(rec)}")
    rec["profile"] = prof
    return box["out"], rec


def _client_check_groups(name: str, rows: list, keys, sums, counts) -> int:
    """GROUP BY rows ({key, s, c}) exactly against numpy bincounts."""
    import numpy as np
    want = {int(g): (int(sums[g]), int(counts[g]))
            for g in np.flatnonzero(counts)}
    got = {r[keys]: (int(r["s"]), int(r["c"])) for r in rows}
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()))[:3]
        raise AssertionError(f"{name}: groups differ from the oracle: {bad}")
    return len(rows)


def _client_data(seed: int) -> dict:
    """The dimension table, the dynamic table's rows and lookup keys, and
    the vectors, from --seed."""
    import numpy as np
    rng = np.random.default_rng(seed + 13)
    acc_k = rng.permutation(CLIENT_DYN_KEYS)[:CLIENT_DYN_ROWS]
    acc_g = rng.integers(0, 1000, CLIENT_DYN_ROWS)
    acc_v = rng.integers(0, 1000, CLIENT_DYN_ROWS)
    present = rng.choice(CLIENT_DYN_ROWS, CLIENT_LOOKUPS * 3 // 4,
                         replace=False)
    absent = CLIENT_DYN_KEYS + rng.choice(CLIENT_DYN_KEYS,
                                          CLIENT_LOOKUPS // 4, replace=False)
    keys = np.concatenate([acc_k[present], absent])
    rng.shuffle(keys)
    vrng = np.random.default_rng(seed + 17)
    return {"acc_k": acc_k, "acc_g": acc_g, "acc_v": acc_v,
            "lookup_keys": keys.tolist(),
            "vectors": vrng.standard_normal(
                (CLIENT_VEC_ROWS, CLIENT_VEC_DIM), dtype=np.float32),
            "queries": vrng.standard_normal(
                (CLIENT_THREADS, CLIENT_VEC_DIM), dtype=np.float32)}


def _client_threads(fn, n: int) -> list:
    """fn(i) on n threads released together; their results in order. A
    failure on any thread is raised here."""
    import threading
    results, errors = [None] * n, []
    barrier = threading.Barrier(n)

    def work(i):
        try:
            barrier.wait()
            results[i] = fn(i)
        except BaseException as exc:   # noqa: BLE001 — raised below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _client_lookups(client, d: dict) -> int:
    """CLIENT_LOOKUPS keys from CLIENT_THREADS threads in calls of
    CLIENT_LOOKUP_BATCH keys, each row against the oracle."""
    oracle = {int(k): (int(g), int(v)) for k, g, v in
              zip(d["acc_k"], d["acc_g"], d["acc_v"])}
    keys = d["lookup_keys"]
    per = len(keys) // CLIENT_THREADS

    def run(i):
        mine = keys[i * per:(i + 1) * per]
        for lo in range(0, per, CLIENT_LOOKUP_BATCH):
            part = mine[lo:lo + CLIENT_LOOKUP_BATCH]
            rows = client.lookup_rows("//bench/acc", [(k,) for k in part])
            for k, row in zip(part, rows):
                want = oracle.get(k)
                got = None if row is None else (row["g"], row["v"])
                if got != want or (row is not None and row["k"] != k):
                    raise AssertionError(f"CLIENT lookup of {k}: {row} != "
                                         f"{want}")
        return per

    return sum(_client_threads(run, CLIENT_THREADS))


def phase_client(seed: int, hr, rx, port, front: bool = False) -> dict:
    """CLIENT: the slice through `ytsaurus_tpu_torch.client.connect` and
    the client's methods alone: SELECT's 64M-row table published into
    Cypress as 8 chunks, a dimension table written from row dicts, four
    selects (SELECT_8's query, a pruned range, a join with a GROUP BY,
    EXPLAIN ANALYZE), run_sort of the 64M rows on (g, k), run_merge and
    run_erase, a dynamic table written through 500 tablet transactions,
    looked up from 16 threads and grouped, a restart that recovers the
    master from its snapshot and changelog, and nearest_rows from 16
    threads through the vector batcher. Every answer is held to numpy.
    With `front`, FRONT then runs over the open client (its record under
    "front", its seconds not CLIENT's)."""
    import numpy as np
    import torch
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.client import connect, publish_table_chunks
    from ytsaurus_tpu_torch.query.vector import batched_nearest
    t_phase = time.perf_counter()
    arrays = _select_arrays(seed)
    d = _client_data(seed)
    out: dict = {"paths": {}, "stages": {}}
    holder: dict = {}

    def cache():
        client = holder.get("client")
        return client.cluster.chunk_cache if client is not None else None

    def stage(name, run, radix=False, host_only=False, extra=None):
        result, rec = _client_stage(f"client {name}", run, hr, rx, cache,
                                    radix=radix, host_only=host_only,
                                    extra=extra)
        out["paths"][f"client_{name}"] = rec
        return result

    k_all = np.concatenate([a["k"] for a in arrays])
    g_all = np.concatenate([a["g"] for a in arrays])
    v_all = np.concatenate([a["v"] for a in arrays])
    sel = v_all < 900
    select_oracle = (np.bincount(g_all[sel], weights=v_all[sel],
                                 minlength=SELECT_GROUPS),
                     np.bincount(g_all[sel], minlength=SELECT_GROUPS))
    del sel
    dim_name = [f"name{g % CLIENT_NAMES:02d}".encode()
                for g in range(CLIENT_DIM_ROWS)]
    name_of_g = np.arange(SELECT_GROUPS) % CLIENT_NAMES
    join_oracle = (np.bincount(name_of_g[g_all], weights=v_all,
                               minlength=CLIENT_NAMES),
                   np.bincount(name_of_g[g_all], minlength=CLIENT_NAMES))

    def check_select(name, rows):
        return _client_check_groups(name, rows, "g", *select_oracle)

    def check_join(rows):
        named = [{"name": int(r["name"][4:]), "s": r["s"], "c": r["c"]}
                 for r in rows]
        return _client_check_groups("CLIENT join", named, "name",
                                    *join_oracle)

    with tempfile.TemporaryDirectory() as root:
        client = connect(root, device="cuda")
        holder["client"] = client
        if client.cluster.device.type != "cuda":
            raise AssertionError("CLIENT: the cluster is not on the card")
        schema = port.TableSchema.make([("k", "int64"), ("g", "int64"),
                                        ("v", "int64")])

        def publish():
            client.create("table", CLIENT_T, recursive=True,
                          attributes={"schema": schema})
            chunks = [ColumnarChunk.from_arrays(schema, a, device="cuda")
                      for a in arrays]
            publish_table_chunks(client, client.cluster.chunk_store,
                                 CLIENT_T, chunks, schema=schema)
        stage("publish", publish)
        if client.get(CLIENT_T + "/@row_count") != SELECT_ROWS or \
                len(client.get(CLIENT_T + "/@chunk_ids")) != SELECT_CHUNKS:
            raise AssertionError("CLIENT: the published table's attributes "
                                 "differ")
        dim_rows = [{"g": g, "name": dim_name[g]}
                    for g in range(CLIENT_DIM_ROWS)]
        stage("write_dim", lambda: client.write_table("//bench/dim",
                                                       dim_rows),
              host_only=True)
        if client.read_table("//bench/dim") != dim_rows:
            raise AssertionError("CLIENT: //bench/dim reads back differently")

        # Selects through the gateway, each held to numpy.
        rows = stage("select_8", lambda: client.select_rows(CLIENT_QUERY))
        out["stages"]["select_8_groups"] = check_select("CLIENT SELECT_8",
                                                        rows)
        warm = []
        for _ in range(3):
            t = time.perf_counter()
            client.select_rows(CLIENT_QUERY)
            warm.append(time.perf_counter() - t)
        out["stages"]["select_8_warm_s"] = warm
        lo, hi = CLIENT_RANGE
        rows = stage("select_range", lambda: client.select_rows(
            f"k, g, v FROM [{CLIENT_T}] WHERE k >= {lo} AND k < {hi}"))
        pruned = client.last_query_statistics.shards_pruned
        if pruned != SELECT_CHUNKS - 1 or sorted(
                (r["k"], r["g"], r["v"]) for r in rows) != list(zip(
                    k_all[lo:hi].tolist(), g_all[lo:hi].tolist(),
                    v_all[lo:hi].tolist())):
            raise AssertionError(f"CLIENT range: {len(rows)} rows, "
                                 f"{pruned} shards pruned")
        out["stages"]["range_shards_pruned"] = pruned
        rows = stage("join", lambda: client.select_rows(CLIENT_JOIN),
                     radix=True)
        out["stages"]["join_groups"] = check_join(rows)
        profile = stage("explain", lambda: client.select_rows(
            CLIENT_QUERY, explain_analyze=True))
        check_select("CLIENT EXPLAIN ANALYZE", profile.rows)
        (top,) = profile.span_tree()
        explain = {"root": top["name"], "wall_s": profile.wall_time,
                   "compile_s": profile.compile_time,
                   "execute_s": profile.execute_time,
                   "children": [[c["name"], c["duration"]]
                                for c in top["children"]]}
        if top["name"] != "query.select" or profile.execute_time <= 0:
            raise AssertionError(f"CLIENT EXPLAIN ANALYZE: {explain}")
        out["stages"]["explain"] = explain
        _log(f"client explain split: {json.dumps(explain)}")
        _log(profile.format().split("spans:")[0].rstrip())

        # Operations.
        op = stage("sort", lambda: client.run_sort(
            CLIENT_T, "//bench/t_sorted", sort_by=["g", "k"]), radix=True)
        branch = "external_sort" if "spill_ranges" in op.result \
            else "sort_chunks"
        if op.state != "completed" or op.result["rows"] != SELECT_ROWS or \
                branch != "sort_chunks":
            raise AssertionError(f"CLIENT run_sort: {op.state} {op.result}")
        _log(f"client sort branch: {op.result} through {branch} (2 x "
             f"{SELECT_ROWS * 24} bytes against YT_TPU_HBM_BUDGET)")
        out["stages"]["sort_branch"] = branch
        (cid,) = client.get("//bench/t_sorted/@chunk_ids")
        planes = client.cluster.chunk_cache.get(cid).to_numpy()["planes"]
        # k is the row number, so the (g, k) order is the stable order by
        # g (g < 2^15: numpy's stable sort of int16 is a radix sort).
        if not np.array_equal(k_all, np.arange(SELECT_ROWS)):
            raise AssertionError("CLIENT: k is not the row number")
        order = np.argsort(g_all.astype(np.int16), kind="stable")
        for name, col in (("g", g_all), ("k", k_all), ("v", v_all)):
            if not np.array_equal(planes[name][0][:SELECT_ROWS], col[order]):
                raise AssertionError(f"CLIENT run_sort: {name} is not in "
                                     "np.lexsort's order")
        del planes
        if client.get("//bench/t_sorted/@sorted_by") != ["g", "k"]:
            raise AssertionError("CLIENT run_sort: @sorted_by differs")
        rows = stage("select_sorted", lambda: client.select_rows(
            "k, g, v FROM [//bench/t_sorted] ORDER BY g, k LIMIT 1000"))
        top_k = order[:1000]
        if [(r["g"], r["k"], r["v"]) for r in rows] != list(zip(
                g_all[top_k].tolist(), k_all[top_k].tolist(),
                v_all[top_k].tolist())):
            raise AssertionError("CLIENT ORDER BY g, k LIMIT 1000 differs")
        del order, top_k
        # The 64M-row sorted chunk and the 8 input chunks together exceed
        # the chunk cache's 2 GiB (the reference's budget, kept): this
        # select's misses show what the sort evicted.
        rows = stage("select_8_after_sort",
                     lambda: client.select_rows(CLIENT_QUERY))
        check_select("CLIENT SELECT_8 after the sort", rows)
        out["stages"]["cache_after_sort"] = {
            "used_bytes": client.cluster.chunk_cache.used_bytes,
            "capacity_bytes": client.cluster.chunk_cache.capacity_bytes}
        op = stage("merge", lambda: client.run_merge(
            ["//bench/dim", "//bench/dim"], "//bench/dim2", mode="sorted",
            merge_by=["g"]))
        merged = client.read_table("//bench/dim2")
        if op.state != "completed" or [r["g"] for r in merged] != \
                sorted(list(range(CLIENT_DIM_ROWS)) * 2):
            raise AssertionError(f"CLIENT run_merge: {op.state}")
        op = stage("erase", lambda: client.run_erase("//bench/dim2"),
                   host_only=True)
        if op.state != "completed" or client.read_table("//bench/dim2") \
                or client.get("//bench/dim2/@row_count") != 0:
            raise AssertionError("CLIENT run_erase left rows")
        # The static tables are in a snapshot; the dynamic table's
        # mutations stay in the changelog for the restart to replay.
        client.cluster.master.build_snapshot()

        # A dynamic table through tablet transactions.
        acc_schema = port.TableSchema.make(
            [("k", "int64", "ascending"), ("g", "int64"), ("v", "int64")],
            unique_keys=True)
        client.create("table", "//bench/acc", attributes={
            "schema": acc_schema, "dynamic": True})
        client.mount_table("//bench/acc")
        acc_rows = [{"k": k, "g": g, "v": v} for k, g, v in zip(
            d["acc_k"].tolist(), d["acc_g"].tolist(), d["acc_v"].tolist())]

        def insert():
            for lo in range(0, CLIENT_DYN_ROWS, CLIENT_DYN_TX_ROWS):
                tx = client.start_transaction()
                client.insert_rows("//bench/acc",
                                   acc_rows[lo:lo + CLIENT_DYN_TX_ROWS],
                                   tx=tx)
                client.commit_transaction(tx)
        stage("insert", insert, host_only=True)
        rec = out["paths"]["client_insert"]
        rec["rows_per_s"] = CLIENT_DYN_ROWS / rec["host_s"]
        _log(f"client insert: {rec['rows_per_s']:.0f} rows/s in "
             f"{CLIENT_DYN_ROWS // CLIENT_DYN_TX_ROWS} transactions")
        gateway = client.cluster.gateway
        before = dict(gateway.snapshot()["lookup"])
        stage("lookup", lambda: _client_lookups(client, d), host_only=True)
        after = gateway.snapshot()["lookup"]
        coalesced = {k: after[k] - before.get(k, 0) for k in after}
        out["stages"]["lookup_gateway"] = coalesced
        _log(f"client gateway lookup: {json.dumps(coalesced)}")
        if coalesced["requests"] != CLIENT_LOOKUPS // CLIENT_LOOKUP_BATCH or \
                not 0 < coalesced["batches"] < coalesced["requests"]:
            raise AssertionError(f"CLIENT: the gateway did not coalesce the "
                                 f"lookups: {coalesced}")
        acc_oracle = (np.bincount(d["acc_g"], weights=d["acc_v"],
                                  minlength=1000),
                      np.bincount(d["acc_g"], minlength=1000))
        rows = stage("select_acc", lambda: client.select_rows(
            CLIENT_ACC_GROUP))
        _client_check_groups("CLIENT select_acc", rows, "g", *acc_oracle)
        stage("unmount", lambda: client.unmount_table("//bench/acc"))
        if client.get("//bench/acc/@tablet_state") != "unmounted":
            raise AssertionError("CLIENT: //bench/acc is still mounted")

        # Restart: a new cluster object recovers the master from the
        # snapshot and the changelog.
        del client, holder["client"]

        def restart():
            c = connect(root, fresh=True, device="cuda")
            holder["client"] = c
            c.mount_table("//bench/acc")
            return c
        client = stage("restart", restart, host_only=True)
        for path, want in ((CLIENT_T, SELECT_ROWS),
                           ("//bench/t_sorted", SELECT_ROWS),
                           ("//bench/dim", CLIENT_DIM_ROWS),
                           ("//bench/dim2", 0)):
            if client.get(path + "/@row_count") != want:
                raise AssertionError(f"CLIENT restart: {path} lost rows")
        stage("lookup_restarted", lambda: _client_lookups(client, d))
        rows = stage("select_8_restarted",
                     lambda: client.select_rows(CLIENT_QUERY))
        check_select("CLIENT SELECT_8 after the restart", rows)
        rows = stage("select_acc_restarted", lambda: client.select_rows(
            CLIENT_ACC_GROUP))
        _client_check_groups("CLIENT select_acc after the restart", rows,
                             "g", *acc_oracle)
        rows = stage("readback", lambda: client.select_rows(
            "k, g, v FROM [//bench/acc]"))
        got = sorted((r["k"], r["g"], r["v"]) for r in rows)
        if got != sorted(zip(d["acc_k"].tolist(), d["acc_g"].tolist(),
                             d["acc_v"].tolist())):
            raise AssertionError("CLIENT: an acknowledged write was not "
                                 "read back after the restart")
        out["stages"]["readback_rows"] = len(got)
        del got, rows, acc_rows

        # nearest_rows through the vector batcher.
        vec_schema = port.TableSchema.make(
            [("k", "int64", "ascending"),
             ("emb", f"vector<float, {CLIENT_VEC_DIM}>")], unique_keys=True)
        client.create("table", "//bench/vec", attributes={
            "schema": vec_schema, "dynamic": True})
        client.mount_table("//bench/vec")
        vectors = d["vectors"]

        def write_vectors():
            for lo in range(0, CLIENT_VEC_ROWS, CLIENT_VEC_TX_ROWS):
                part = vectors[lo:lo + CLIENT_VEC_TX_ROWS].tolist()
                tx = client.start_transaction()
                client.insert_rows("//bench/vec", [
                    {"k": lo + i, "emb": e} for i, e in enumerate(part)],
                    tx=tx)
                client.commit_transaction(tx)
            client.unmount_table("//bench/vec")
            client.mount_table("//bench/vec")
        stage("write_vectors", write_vectors)
        queries = d["queries"].tolist()
        hits = stage("nearest", lambda: _client_threads(
            lambda i: client.nearest_rows("//bench/vec", "emb", queries[i],
                                          CLIENT_VEC_K), CLIENT_THREADS))
        batcher = client.cluster.gateway.snapshot()["nearest"]
        out["stages"]["nearest_batcher"] = batcher
        _log(f"client nearest batcher: {json.dumps(batcher)}")
        if batcher["requests"] != CLIENT_THREADS or \
                not 0 < batcher["batches"] < batcher["requests"]:
            raise AssertionError(f"CLIENT: the vector batcher did not "
                                 f"coalesce the NEAREST callers: {batcher}")
        snap = client._mounted_tablets("//bench/vec")[0].read_snapshot(
            port.MAX_TIMESTAMP)
        ref = batched_nearest(snap, "emb", queries, CLIENT_VEC_K,
                              device="cuda")
        keys = snap.to_numpy()["planes"]["k"][0]
        for i, (got_rows, want) in enumerate(zip(hits, ref)):
            if [r["k"] for r in got_rows] != [int(keys[j]) for j, _ in want] \
                    or not np.allclose([r["$distance"] for r in got_rows],
                                       [m for _, m in want], rtol=1e-5,
                                       atol=0):
                raise AssertionError(f"CLIENT nearest_rows {i} differs from "
                                     "batched_nearest")
        del snap, ref, hits, vectors
        front_s = 0.0
        if front:
            out["front"] = phase_front(seed, hr, rx, port, client=client,
                                       arrays=arrays)
            front_s = out["front"]["seconds"]
        holder.clear()
        del client
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase - front_s
    _log(f"client: {out['seconds']:.1f} s in all")
    return out


# --- FRONT: the front doors over CLIENT's cluster ---------------------------

FRONT_WARM = 5                 # warm REST runs of SELECT_8 after the counted one
FRONT_WRITE_ROWS = 131_072     # rows of the REST write_table, as a JSON body
FRONT_THREADS = 16             # RPC caller threads
FRONT_CALLS = 16               # select_rows calls per RPC thread
# Rows per RPC select: at CLIENT's 1,000-row range the 256 calls took
# 14.1 s on an H100's host (chip_phases front), most of it the wire's
# YSON (pure Python; every reply decoded on the one client loop thread);
# 100 rows keep the calls' count and their pruning.
FRONT_RANGE_ROWS = 100
FRONT_DYN_ROWS = 100_000       # rows written through the wire transactions
FRONT_TX_ROWS = 1_000          # rows per wire transaction
FRONT_DYN_KEYS = 1_000_000     # keys drawn without repeats from [0, this)
FRONT_LOOKUPS = 4_096
FRONT_LOOKUP_BATCH = 16        # keys per lookup_rows call
FRONT_T = "//bench/t"          # CLIENT's tables, served as CLIENT left them
FRONT_DIM = "//bench/dim"


class _Wire:
    """Requests and bytes on the wire of one FRONT stage: HTTP bodies
    counted at the caller, RPC bytes as the TCP proxy spliced them."""

    def __init__(self, tcp=None):
        import threading
        self.tcp = tcp
        self.lock = threading.Lock()
        self.requests = 0
        self.http_bytes = 0
        self.tcp0 = self._tcp_bytes()

    def _tcp_bytes(self) -> int:
        if self.tcp is None:
            return 0
        return self.tcp.stats["bytes_in"] + self.tcp.stats["bytes_out"]

    def add(self, requests: int, nbytes: int = 0) -> None:
        with self.lock:
            self.requests += requests
            self.http_bytes += nbytes

    def record(self) -> dict:
        return {"requests": self.requests,
                "wire_bytes": self.http_bytes + self._tcp_bytes() - self.tcp0}


def _front_http(wire, address: str, method: str, path: str, body=None,
                headers=None) -> tuple:
    """One HTTP request to the proxy: (status, headers, body bytes); the
    request and reply bodies are counted on `wire`."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://{address}{path}", data=body,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            out = (resp.status, dict(resp.headers), resp.read())
    except urllib.error.HTTPError as err:
        out = (err.code, dict(err.headers), err.read())
    wire.add(1, len(body or b"") + len(out[2]))
    return out


def _front_post(wire, address: str, command: str, params: dict):
    """POST /api/v4/<command> with a JSON body; the reply's value."""
    status, _, raw = _front_http(
        wire, address, "POST", f"/api/v4/{command}",
        json.dumps(params).encode(), {"Content-Type": "application/json"})
    if status != 200:
        raise AssertionError(f"FRONT REST {command}: {status} {raw[:300]!r}")
    return json.loads(raw)["value"]


def _front_context(arrays: list, seed: int) -> dict:
    """FRONT's oracles over CLIENT's table and its dimension, and the
    rows and keys of its own writes, from --seed."""
    import numpy as np
    k_all = np.concatenate([a["k"] for a in arrays])
    g_all = np.concatenate([a["g"] for a in arrays])
    v_all = np.concatenate([a["v"] for a in arrays])
    if not np.array_equal(k_all, np.arange(SELECT_ROWS)):
        raise AssertionError("FRONT: k is not the row number")
    sel = v_all < 900
    name_of_g = np.arange(SELECT_GROUPS) % CLIENT_NAMES
    rng = np.random.default_rng(seed + 31)
    dyn_k = rng.permutation(FRONT_DYN_KEYS)[:FRONT_DYN_ROWS]
    present = rng.choice(FRONT_DYN_ROWS, FRONT_LOOKUPS * 3 // 4,
                         replace=False)
    absent = FRONT_DYN_KEYS + rng.choice(FRONT_DYN_KEYS, FRONT_LOOKUPS // 4,
                                         replace=False)
    keys = np.concatenate([dyn_k[present], absent])
    rng.shuffle(keys)
    return {
        "g_all": g_all, "v_all": v_all,
        "select": (np.bincount(g_all[sel], weights=v_all[sel],
                               minlength=SELECT_GROUPS),
                   np.bincount(g_all[sel], minlength=SELECT_GROUPS)),
        "join": (np.bincount(name_of_g[g_all], weights=v_all,
                             minlength=CLIENT_NAMES),
                 np.bincount(name_of_g[g_all], minlength=CLIENT_NAMES)),
        "totals": np.bincount(g_all, weights=v_all, minlength=SELECT_GROUPS),
        "ranges": rng.integers(0, SELECT_ROWS - 1000,
                               FRONT_THREADS * FRONT_CALLS),
        "dyn": {"k": dyn_k, "g": rng.integers(0, 1000, FRONT_DYN_ROWS),
                "v": rng.integers(0, 1000, FRONT_DYN_ROWS)},
        "lookup_keys": keys.tolist(),
        "write": {"k": np.arange(FRONT_WRITE_ROWS),
                  "g": rng.integers(0, 1 << 40, FRONT_WRITE_ROWS),
                  "x": rng.standard_normal(FRONT_WRITE_ROWS),
                  "s": rng.integers(0, 997, FRONT_WRITE_ROWS)},
    }


def _front_named(rows: list) -> list:
    """The join's rows with the name as its number (name07 -> 7)."""
    return [{"name": int(r["name"][4:]), "s": r["s"], "c": r["c"]}
            for r in rows]


def _front_text(value) -> str:
    return value.decode() if isinstance(value, bytes) else value


def phase_front(seed: int, hr, rx, port, client=None, arrays=None) -> dict:
    """FRONT: the front doors over CLIENT's cluster as CLIENT leaves it
    (the 64M-row table in 8 chunks and its 10,000-row dimension; called
    with CLIENT's open client after its restart, or, alone, on a cluster
    that publishes the same two tables). On 127.0.0.1:0 it starts an
    HttpProxy over Driver(client), an RpcServer([DriverService(client)])
    with a TcpProxy in front of it, and uses the client's QueryTracker.
    REST: /ping, /api/v4, SELECT_8's GROUP BY through POST select_rows
    (10,000 groups back as JSON; one counted run, FRONT_WARM warm), the
    join with the dimension grouped by name and the same join with
    explain_analyze (one stage; both radix kernels must launch), a PUT
    write_table of 131,072 JSON rows and its read_table back in JSON. RPC
    through the TCP proxy: 16 threads x 16 driver select_rows calls of a
    pruned k range of FRONT_RANGE_ROWS rows through RetryingChannels that
    know only the proxy's address;
    100,000 rows into a dynamic table through the wire transactions (100
    transactions of 1,000); 4,096 lookups; every acknowledged write read
    back. Query tracker: 8 asynchronous QL queries (the join grouped by
    name first, alone, then 7 at once), each waited for and its result
    held to numpy; 4 engine="chyt" queries (a JOIN with GROUP BY and
    ORDER BY ... LIMIT, sumIf / countIf, a FROM-subquery whose inner
    GROUP BY's 10,000 groups are materialized on the card, which must
    launch both radix kernels, and a query that must fail with its
    code); list_queries and abort_query of a running query. Every stage
    runs as CLIENT's do and also records its requests and bytes on the
    wire. Doubles to rtol 1e-9, the rest exact."""
    import threading

    import numpy as np
    import torch
    from ytsaurus_tpu_torch import rpc
    from ytsaurus_tpu_torch.driver import COMMANDS
    from ytsaurus_tpu_torch.errors import EErrorCode, YtError
    from ytsaurus_tpu_torch.server.http_proxy import HttpProxy
    from ytsaurus_tpu_torch.server.query_tracker import register_engine
    from ytsaurus_tpu_torch.server.services import DriverService
    from ytsaurus_tpu_torch.server.tcp_proxy import TcpProxy
    t_phase = time.perf_counter()
    if client is None:
        with tempfile.TemporaryDirectory() as root:
            return _front_alone(seed, hr, rx, port, root)
    if client.cluster.device.type != "cuda":
        raise AssertionError("FRONT: the cluster is not on the card")
    ctx = _front_context(arrays, seed)
    out: dict = {"paths": {}, "stages": {}}

    def stage(name, run, wire, radix=False, host_only=False):
        result, rec = _client_stage(
            f"front {name}", run, hr, rx,
            lambda: client.cluster.chunk_cache, radix=radix,
            host_only=host_only, extra=None)
        rec.update(wire.record())
        _log(f"front {name} wire: {json.dumps(wire.record())}")
        out["paths"][f"front_{name}"] = rec
        return result

    def check_select(name, rows):
        return _client_check_groups(name, rows, "g", *ctx["select"])

    def check_join(name, rows):
        return _client_check_groups(name, _front_named(rows), "name",
                                    *ctx["join"])

    http = HttpProxy(lambda user: client)
    http.start()
    server = rpc.RpcServer([DriverService(client)])
    server.start()
    tcp = TcpProxy([server.address]).start()
    try:
        # --- REST -----------------------------------------------------------
        a = http.address
        wire = _Wire()
        status, _, _ = _front_http(wire, a, "GET", "/ping")
        _, _, raw = _front_http(wire, a, "GET", "/api/v4")
        if status != 200 or json.loads(raw) != sorted(COMMANDS):
            raise AssertionError("FRONT REST: /ping or /api/v4 differ")
        rows = stage("rest_select_8", lambda: _front_post(
            wire, a, "select_rows", {"query": CLIENT_QUERY}), wire)
        out["stages"]["rest_select_8_groups"] = check_select(
            "FRONT REST SELECT_8", rows)
        warm = []
        for _ in range(FRONT_WARM):
            t = time.perf_counter()
            check_select("FRONT REST SELECT_8 warm", _front_post(
                wire, a, "select_rows", {"query": CLIENT_QUERY}))
            warm.append(time.perf_counter() - t)
        out["stages"]["rest_select_8_warm_s"] = warm
        _log(f"front rest SELECT_8 warm: {[round(w, 4) for w in warm]} s")
        wire = _Wire()
        rows, profile = stage("rest_join", lambda: (_front_post(
            wire, a, "select_rows", {"query": CLIENT_JOIN}), _front_post(
            wire, a, "select_rows", {"query": CLIENT_JOIN,
                                     "explain_analyze": True})), wire,
            radix=True)
        out["stages"]["rest_join_groups"] = check_join("FRONT REST join",
                                                       rows)
        check_join("FRONT REST EXPLAIN ANALYZE", profile["rows"])
        (top,) = profile["span_tree"]
        if top["name"] != "query.select" or profile["execute_time"] <= 0:
            raise AssertionError("FRONT REST EXPLAIN ANALYZE: no profile")
        out["stages"]["rest_explain"] = {
            k: profile[k] for k in ("wall_time", "compile_time",
                                    "execute_time")}
        w = ctx["write"]
        body = "".join(
            f'{{"k": {k}, "g": {g}, "x": {x!r}, "s": "s{s}"}}\n'
            for k, g, x, s in zip(w["k"].tolist(), w["g"].tolist(),
                                  w["x"].tolist(), w["s"].tolist())).encode()
        wire = _Wire()

        def write_read():
            status, _, raw = _front_http(
                wire, a, "PUT", "/api/v4/write_table", body,
                {"X-YT-Parameters": json.dumps({"path": "//front/w",
                                                "format": "json"})})
            if status != 200:
                raise AssertionError(f"FRONT REST write_table: {raw[:300]}")
            status, _, raw = _front_http(
                wire, a, "GET", '/api/v4/read_table?path=%22//front/w%22'
                                '&format=%22json%22')
            if status != 200:
                raise AssertionError(f"FRONT REST read_table: {raw[:300]}")
            return raw
        client.create("map_node", "//front", ignore_existing=True)
        raw = stage("rest_write_read", write_read, wire)
        back = [json.loads(line) for line in raw.splitlines()]
        if [(r["k"], r["g"], r["x"], r["s"]) for r in back] != list(zip(
                w["k"].tolist(), w["g"].tolist(), w["x"].tolist(),
                [f"s{s}" for s in w["s"].tolist()])):
            raise AssertionError("FRONT REST: read_table gives back other "
                                 "rows than write_table took")
        out["stages"]["rest_rows_written"] = len(back)
        del back, raw, body

        # --- RPC through the TCP proxy ---------------------------------------
        def channel():
            return rpc.RetryingChannel(rpc.Channel(tcp.address, timeout=300))

        def execute(ch, command, params, idempotent=True):
            body, _ = ch.call("driver", "execute", {
                "command": command, "parameters": params},
                idempotent=idempotent)
            return body["result"]

        wire = _Wire(tcp)
        ranges = ctx["ranges"].tolist()

        def selects(i):
            ch = channel()
            try:
                for j in range(FRONT_CALLS):
                    lo = ranges[i * FRONT_CALLS + j]
                    hi = lo + FRONT_RANGE_ROWS
                    got = execute(ch, "select_rows", {
                        "query": f"k, g, v FROM [{FRONT_T}] WHERE k >= {lo} "
                                 f"AND k < {hi}"})
                    got = sorted((r["k"], r["g"], r["v"]) for r in got)
                    if got != list(zip(range(lo, hi),
                                       ctx["g_all"][lo:hi].tolist(),
                                       ctx["v_all"][lo:hi].tolist())):
                        raise AssertionError(f"FRONT RPC range {lo}")
                wire.add(FRONT_CALLS)
                return FRONT_CALLS
            finally:
                ch.close()
        calls = sum(stage("rpc_selects", lambda: _client_threads(
            selects, FRONT_THREADS), wire))
        out["stages"]["rpc_select_calls"] = calls
        out["stages"]["tcp_connections"] = tcp.stats["connections"]

        d = ctx["dyn"]
        ch = channel()
        execute(ch, "create", {
            "type": "table", "path": "//front/acc", "attributes": {
                "schema": [{"name": "k", "type": "int64",
                            "sort_order": "ascending"},
                           {"name": "g", "type": "int64"},
                           {"name": "v", "type": "int64"}],
                "dynamic": True}}, idempotent=False)
        execute(ch, "mount_table", {"path": "//front/acc"})
        dyn_rows = [{"k": k, "g": g, "v": v} for k, g, v in zip(
            d["k"].tolist(), d["g"].tolist(), d["v"].tolist())]
        acknowledged = []
        wire = _Wire(tcp)

        def write():
            for lo in range(0, FRONT_DYN_ROWS, FRONT_TX_ROWS):
                part = dyn_rows[lo:lo + FRONT_TX_ROWS]
                body, _ = ch.call("driver", "start_transaction", {},
                                  idempotent=False)
                tx_id = body["tx_id"]
                ch.call("driver", "insert_rows_tx", {
                    "tx_id": tx_id, "path": "//front/acc", "rows": part})
                body, _ = ch.call("driver", "commit_transaction",
                                  {"tx_id": tx_id}, idempotent=False)
                if body["commit_timestamp"] <= 0:
                    raise AssertionError("FRONT RPC: no commit timestamp")
                acknowledged.extend(part)
                wire.add(3)
        stage("rpc_writes", write, wire, host_only=True)
        rec = out["paths"]["front_rpc_writes"]
        rec["rows_per_s"] = FRONT_DYN_ROWS / rec["host_s"]
        _log(f"front rpc writes: {rec['rows_per_s']:.0f} rows/s in "
             f"{FRONT_DYN_ROWS // FRONT_TX_ROWS} wire transactions")
        oracle = {r["k"]: (r["g"], r["v"]) for r in acknowledged}
        keys = ctx["lookup_keys"]
        per = len(keys) // FRONT_THREADS
        wire = _Wire(tcp)

        def lookups(i):
            lch = channel()
            try:
                mine = keys[i * per:(i + 1) * per]
                for lo in range(0, per, FRONT_LOOKUP_BATCH):
                    part = mine[lo:lo + FRONT_LOOKUP_BATCH]
                    got = execute(lch, "lookup_rows", {
                        "path": "//front/acc", "keys": [[k] for k in part]})
                    wire.add(1)
                    for k, row in zip(part, got):
                        want = oracle.get(k)
                        have = None if row is None else (row["g"], row["v"])
                        if have != want:
                            raise AssertionError(f"FRONT RPC lookup {k}: "
                                                 f"{row} != {want}")
                return per
            finally:
                lch.close()

        def reads():
            found = sum(_client_threads(lookups, FRONT_THREADS))
            rows = execute(ch, "select_rows",
                           {"query": "k, g, v FROM [//front/acc]"})
            wire.add(1)
            return found, rows
        found, rows = stage("rpc_reads", reads, wire)
        got = sorted((r["k"], r["g"], r["v"]) for r in rows)
        if got != sorted((r["k"], r["g"], r["v"]) for r in acknowledged):
            raise AssertionError("FRONT RPC: an acknowledged write was not "
                                 "read back")
        out["stages"]["rpc_lookups"] = found
        out["stages"]["rpc_readback_rows"] = len(got)
        ch.close()
        del got, rows, dyn_rows

        # --- the query tracker ------------------------------------------------
        qt = client.query_tracker
        g_all, v_all = ctx["g_all"], ctx["v_all"]
        lo = int(ctx["ranges"][0])
        acc_g = np.bincount(d["g"], weights=d["v"], minlength=1000)
        acc_c = np.bincount(d["g"], minlength=1000)
        low = g_all < 100
        max100 = np.full(100, -1)
        np.maximum.at(max100, g_all[low], v_all[low])
        del low
        seven = g_all == 7
        order7 = np.lexsort((np.flatnonzero(seven), -v_all[seven]))[:100]
        ql = [
            (f"k, g, v FROM [{FRONT_T}] WHERE k >= {lo} AND k < {lo + 500}",
             lambda rows: sorted((r["k"], r["g"], r["v"]) for r in rows)
             == list(zip(range(lo, lo + 500), g_all[lo:lo + 500].tolist(),
                         v_all[lo:lo + 500].tolist()))),
            (CLIENT_QUERY, lambda rows: check_select(
                "FRONT QL SELECT_8", rows) == SELECT_GROUPS),
            (f"count(*) AS c, sum(v) AS s FROM [{FRONT_T}] WHERE v < 100 "
             "GROUP BY 1 AS one",
             lambda rows: [(r["c"], r["s"]) for r in rows] == [(
                 int((v_all < 100).sum()), int(v_all[v_all < 100].sum()))]),
            (f"g, max(v) AS m FROM [{FRONT_T}] WHERE g < 100 GROUP BY g",
             lambda rows: {r["g"]: r["m"] for r in rows} == dict(
                 enumerate(max100.tolist()))),
            (f"k, v FROM [{FRONT_T}] WHERE g = 7 ORDER BY v DESC, k "
             "LIMIT 100",
             lambda rows: [(r["k"], r["v"]) for r in rows] == list(zip(
                 np.flatnonzero(seven)[order7].tolist(),
                 v_all[seven][order7].tolist()))),
            ("g, sum(v) AS s, count(*) AS c FROM [//front/acc] GROUP BY g",
             lambda rows: {r["g"]: (r["s"], r["c"]) for r in rows} == {
                 g: (int(acc_g[g]), int(acc_c[g]))
                 for g in np.flatnonzero(acc_c)}),
            (f"name, count(*) AS c FROM [{FRONT_DIM}] GROUP BY name",
             lambda rows: {_front_text(r["name"]): r["c"] for r in rows} ==
             {f"name{n:02d}": SELECT_GROUPS // CLIENT_NAMES
              for n in range(CLIENT_NAMES)}),
        ]
        wire = _Wire()
        launched: dict = {}

        def tracker_ql():
            before = dict(rx.launches)
            qid = qt.start_query(CLIENT_JOIN)
            record = qt.wait(qid, timeout=600)
            launched["join"] = {k: rx.launches[k] - before[k]
                                for k in before}
            check_join("FRONT QL join", qt.read_query_result(qid))
            ids = [qt.start_query(query) for query, _ in ql]
            states = [record["state"]]
            for qid, (query, check) in zip(ids, ql):
                record = qt.wait(qid, timeout=600)
                states.append(record["state"])
                if record["state"] != "completed" or record["truncated"] or \
                        not check(qt.read_query_result(qid)):
                    raise AssertionError(f"FRONT QL {query!r}: {record}")
            wire.add(1 + len(ids))
            return states
        states = stage("tracker_ql", tracker_ql, wire, radix=True)
        if states != ["completed"] * (1 + len(ql)):
            raise AssertionError(f"FRONT QL states: {states}")
        for kernel in PATH_KERNELS:
            if launched["join"][kernel] <= 0:
                raise AssertionError(f"FRONT QL join: no {kernel}")
        out["stages"]["tracker_ql_join_launches"] = launched["join"]

        s_join, c_join = ctx["join"]
        top10 = np.lexsort((np.arange(CLIENT_NAMES), -s_join))[:10]
        totals = ctx["totals"]
        top_g = np.lexsort((np.arange(SELECT_GROUPS), -totals))[:100]
        chyt = [
            ("join", f'SELECT name, sum(v) AS s, count(*) AS c FROM '
                     f'"{FRONT_T}" JOIN "{FRONT_DIM}" USING g GROUP BY name '
                     f'ORDER BY sum(v) DESC, name LIMIT 10',
             lambda rows: [(int(_front_text(r["name"])[4:]), r["s"], r["c"])
                           for r in rows] == [
                 (int(n), int(s_join[n]), int(c_join[n])) for n in top10]),
            ("if", f"SELECT countIf(v < 100) AS lo, sumIf(v, g < 5000) AS s "
                   f"FROM `{FRONT_T}` GROUP BY 1 AS one",
             lambda rows: [(r["lo"], r["s"]) for r in rows] == [(
                 int((v_all < 100).sum()),
                 int(v_all[g_all < 5000].sum()))]),
            ("subquery", f"SELECT g, total FROM (SELECT g, sum(v) AS total "
                         f"FROM `{FRONT_T}` GROUP BY g) AS per_g ORDER BY "
                         f"total DESC, g LIMIT 100",
             lambda rows: [(r["g"], r["total"]) for r in rows] == [
                 (int(g), int(totals[g])) for g in top_g]),
        ]
        wire = _Wire()

        def tracker_chyt():
            per_query = {}
            for name, query, check in chyt:
                before = dict(rx.launches)
                qid = qt.start_query(query, engine="chyt")
                record = qt.wait(qid, timeout=600)
                per_query[name] = {k: rx.launches[k] - before[k]
                                   for k in before}
                if record["state"] != "completed" or \
                        not check(qt.read_query_result(qid)):
                    raise AssertionError(f"FRONT chyt {name}: {record}")
            qid = qt.start_query(f"SELECT toString(v) FROM `{FRONT_T}`",
                                 engine="chyt")
            record = qt.wait(qid, timeout=600)
            code = int(EErrorCode.QueryUnsupported)
            if record["state"] != "failed" or \
                    not record["error"].startswith(f"[{code}]"):
                raise AssertionError(f"FRONT chyt failure: {record}")
            try:
                qt.read_query_result(qid)
            except YtError as err:
                if err.code != EErrorCode.OperationFailed:
                    raise
            else:
                raise AssertionError("FRONT chyt: a failed query's result "
                                     "was read")
            wire.add(len(chyt) + 2)
            return per_query
        per_query = stage("tracker_chyt", tracker_chyt, wire, radix=True)
        for kernel in PATH_KERNELS:
            if per_query["subquery"][kernel] <= 0:
                raise AssertionError(f"FRONT chyt subquery: no {kernel}")
        out["stages"]["tracker_chyt_launches"] = per_query

        hold, entered = threading.Event(), threading.Event()

        def held_engine(cl, query):
            entered.set()
            hold.wait(120)
            return cl.select_rows(query)
        register_engine("front_hold", held_engine)
        wire = _Wire()

        def admin():
            qid = qt.start_query(CLIENT_QUERY, engine="front_hold")
            if not entered.wait(60) or \
                    qt.get_query(qid)["state"] != "running":
                raise AssertionError("FRONT: the held query is not running")
            qt.abort_query(qid)
            hold.set()
            record = qt.wait(qid, timeout=600)
            listed = qt.list_queries()
            wire.add(4)
            return record, listed
        record, listed = stage("tracker_admin", admin, wire)
        by_state: dict = {}
        for q in listed:
            by_state[q["state"]] = by_state.get(q["state"], 0) + 1
        want = {"completed": 1 + len(ql) + len(chyt), "failed": 1,
                "aborted": 1}
        if record["state"] != "aborted" or by_state != want:
            raise AssertionError(f"FRONT list_queries: {by_state} != {want}")
        out["stages"]["queries"] = by_state
    finally:
        tcp.stop()
        server.stop()
        http.stop()
    out["stages"]["tcp_stats"] = {k: tcp.stats[k] for k in (
        "connections", "bytes_in", "bytes_out")}
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t_phase
    _log(f"front: {out['seconds']:.1f} s in all")
    return out


def _front_alone(seed: int, hr, rx, port, root: str) -> dict:
    """FRONT on a cluster of its own: CLIENT's two tables published as
    CLIENT publishes them, then the phase."""
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.client import connect, publish_table_chunks
    arrays = _select_arrays(seed)
    client = connect(root, device="cuda")
    schema = port.TableSchema.make([("k", "int64"), ("g", "int64"),
                                    ("v", "int64")])
    client.create("table", CLIENT_T, recursive=True,
                  attributes={"schema": schema})
    publish_table_chunks(client, client.cluster.chunk_store, CLIENT_T,
                         [ColumnarChunk.from_arrays(schema, a, device="cuda")
                          for a in arrays], schema=schema)
    client.write_table(FRONT_DIM, [
        {"g": g, "name": f"name{g % CLIENT_NAMES:02d}".encode()}
        for g in range(CLIENT_DIM_ROWS)])
    return phase_front(seed, hr, rx, port, client=client, arrays=arrays)


# --- OPS: reduce, map-reduce, command and vanilla operations ----------------

OPS_ROWS = 4_194_304          # the operations' input table
OPS_CHUNKS = 4
OPS_GROUPS = 65_536           # distinct g, spread below 2^40
OPS_SPREAD = 2_654_435_761    # g = g0 * OPS_SPREAD mod 2^40 (odd: a bijection)
OPS_REDUCE_JOBS = 16
OPS_MR_ROWS = 1_048_576       # run_map_reduce's input: the first rows, unsorted
OPS_MR_PARTITIONS = 8
OPS_CMD_ROWS = 131_072        # rows of the command jobs, in json
OPS_CMD_ROWS_PER_JOB = 32_768
OPS_CMD_PARTITIONS = 4
OPS_MEMORY_LIMIT = 64 << 20   # the vanilla task that its limit kills
OPS_T = "//ops/in"

# stdin -> stdout filters of the command jobs (python3, json lines): the
# map keeps even v and adds 1 to it; the reduce sums v and counts the rows
# of each run of equal g (key-contiguous input, the streaming-reduce
# contract).
OPS_MAP_CMD = ("python3 -c 'import sys, json\n"
               "for line in sys.stdin:\n"
               "    r = json.loads(line)\n"
               "    if r[\"v\"] % 2 == 0:\n"
               "        print(json.dumps({\"g\": r[\"g\"], \"v\": r[\"v\"] + 1}))'")
OPS_REDUCE_CMD = ("python3 -c 'import sys, json\n"
                  "key = None\n"
                  "for line in sys.stdin:\n"
                  "    r = json.loads(line)\n"
                  "    if r[\"g\"] != key:\n"
                  "        if key is not None:\n"
                  "            print(json.dumps({\"g\": key, \"s\": s, \"c\": c}))\n"
                  "        key, s, c = r[\"g\"], 0, 0\n"
                  "    s += r[\"v\"]\n"
                  "    c += 1\n"
                  "if key is not None:\n"
                  "    print(json.dumps({\"g\": key, \"s\": s, \"c\": c}))'")
OPS_IDENTITY_CMD = "cat"


def _ops_data(seed: int) -> dict:
    """OPS's table from --seed: k a permutation, g0 uniform below
    OPS_GROUPS, g = g0 spread below 2^40 (so GROUP BY and the reduce key
    leave the dense path), v uniform below 1000."""
    import numpy as np
    rng = np.random.default_rng(seed + 23)
    g0 = rng.integers(0, OPS_GROUPS, OPS_ROWS)
    return {"k": rng.permutation(OPS_ROWS).astype(np.int64),
            "g0": g0, "g": (g0 * OPS_SPREAD) % (1 << 40),
            "v": rng.integers(0, 1000, OPS_ROWS)}


def _ops_groups(g0, v) -> dict:
    """{g: (sum of v, rows)} by numpy bincounts over g0."""
    import numpy as np
    sums = np.bincount(g0, weights=v, minlength=OPS_GROUPS)
    counts = np.bincount(g0, minlength=OPS_GROUPS)
    present = np.flatnonzero(counts)
    g = (present * OPS_SPREAD) % (1 << 40)
    return dict(zip(g.tolist(), zip(sums[present].astype(np.int64).tolist(),
                                    counts[present].tolist())))


def _ops_check(name: str, rows: list, want: dict, count: bool = True) -> int:
    """Reduced rows ({g, s[, c]}) against the oracle exactly; each g once
    (the key guarantee: no group was split across jobs)."""
    got = {}
    for r in rows:
        if r["g"] in got:
            raise AssertionError(f"{name}: g={r['g']} was reduced twice")
        got[r["g"]] = (r["s"], r["c"]) if count else r["s"]
    if not count:
        want = {g: s for g, (s, _) in want.items()}
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()))[:3]
        raise AssertionError(f"{name}: groups differ from the oracle: {bad}")
    return len(rows)


def phase_ops(seed: int, hr, rx, port) -> dict:
    """OPS: the operations plane through `connect(tmp, device="cuda")`
    alone. A 4,194,304-row table (k unique, g over 65,536 values spread
    below 2^40, v < 1000; 4 chunks) run_sort'ed by (g, k); run_reduce of
    a Python reducer (sum and count of v per g) in 16 key-aligned jobs;
    run_map_reduce of a Python mapper and reducer over the first 1,048,576
    rows, unsorted, in 8 partitions (each sorted on the card); over
    131,072 rows in json, run_map of a python3 filter command, run_reduce
    of a command reducer, and run_map_reduce of map and reduce commands
    under `scheduler.publish=crash-once`, then revived; run_vanilla of a
    gang (2 tasks x 2 jobs) and of a task that its memory_limit kills.
    Every answer is held to numpy; the sorting stages must launch both
    radix kernels."""
    import numpy as np
    import torch
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.client import connect, publish_table_chunks
    from ytsaurus_tpu_torch.utils import failpoints
    t_phase = time.perf_counter()
    d = _ops_data(seed)
    out: dict = {"paths": {}, "stages": {}}
    holder: dict = {}

    def cache():
        client = holder.get("client")
        return client.cluster.chunk_cache if client is not None else None

    def stage(name, run, radix=False, host_only=False, extra=None):
        result, rec = _client_stage(f"ops {name}", run, hr, rx, cache,
                                    radix=radix, host_only=host_only,
                                    extra=extra)
        out["paths"][f"ops_{name}"] = rec
        return result

    def publish(client, path, n, chunks):
        schema = port.TableSchema.make([("k", "int64"), ("g", "int64"),
                                        ("v", "int64")])
        client.create("table", path, recursive=True,
                      attributes={"schema": schema})
        per = n // chunks
        parts = [ColumnarChunk.from_arrays(
            schema, {c: d[c][i * per:(i + 1) * per] for c in "kgv"},
            device="cuda") for i in range(chunks)]
        publish_table_chunks(client, client.cluster.chunk_store, path,
                             parts, schema=schema)

    all_groups = _ops_groups(d["g0"], d["v"])
    with tempfile.TemporaryDirectory() as root:
        client = connect(root, device="cuda")
        holder["client"] = client
        if client.cluster.device.type != "cuda":
            raise AssertionError("OPS: the cluster is not on the card")
        stage("publish", lambda: publish(client, OPS_T, OPS_ROWS,
                                         OPS_CHUNKS))
        op = stage("sort", lambda: client.run_sort(
            OPS_T, "//ops/sorted", sort_by=["g", "k"]), radix=True)
        if op.state != "completed" or op.result["rows"] != OPS_ROWS:
            raise AssertionError(f"OPS run_sort: {op.state} {op.result}")

        def reducer(key, group):
            yield {"g": key["g"], "s": sum(r["v"] for r in group),
                   "c": len(group)}

        op = stage("reduce", lambda: client.run_reduce(
            reducer, "//ops/sorted", "//ops/reduced", reduce_by="g",
            job_count=OPS_REDUCE_JOBS), radix=True)
        if op.state != "completed":
            raise AssertionError(f"OPS run_reduce: {op.state} {op.error}")
        out["stages"]["reduce"] = dict(op.result)
        out["stages"]["reduce_groups"] = _ops_check(
            "OPS run_reduce", client.read_table("//ops/reduced"), all_groups)
        if not 1 < op.result["jobs"] <= OPS_REDUCE_JOBS:
            raise AssertionError(f"OPS run_reduce ran {op.result['jobs']} "
                                 "jobs")

        stage("publish_mr", lambda: publish(client, "//ops/mr_in",
                                            OPS_MR_ROWS, 1))

        def mapper(rows):
            return [{"g": r["g"], "v2": r["v"] * 2} for r in rows]

        def sum_reducer(key, group):
            yield {"g": key["g"], "s": sum(r["v2"] for r in group)}

        op = stage("map_reduce", lambda: client.run_map_reduce(
            mapper, sum_reducer, "//ops/mr_in", "//ops/mr_out",
            reduce_by="g", partition_count=OPS_MR_PARTITIONS), radix=True)
        if op.state != "completed" or \
                op.result["partitions"] != OPS_MR_PARTITIONS:
            raise AssertionError(f"OPS run_map_reduce: {op.state} "
                                 f"{op.result} {op.error}")
        out["stages"]["map_reduce"] = dict(op.result)
        mr_groups = _ops_groups(d["g0"][:OPS_MR_ROWS],
                                2 * d["v"][:OPS_MR_ROWS])
        out["stages"]["map_reduce_groups"] = _ops_check(
            "OPS run_map_reduce", client.read_table("//ops/mr_out"),
            mr_groups, count=False)

        # Command jobs over the first OPS_CMD_ROWS rows, in json.
        n = OPS_CMD_ROWS
        stage("publish_cmd", lambda: publish(client, "//ops/cmd_in", n, 1))
        op = stage("map_cmd", lambda: client.run_map(
            OPS_MAP_CMD, "//ops/cmd_in", "//ops/cmd_mapped", format="json",
            rows_per_job=OPS_CMD_ROWS_PER_JOB), host_only=True)
        even = d["v"][:n] % 2 == 0
        want = sorted(zip(d["g"][:n][even].tolist(),
                          (d["v"][:n][even] + 1).tolist()))
        got = sorted((r["g"], r["v"]) for r in
                     client.read_table("//ops/cmd_mapped"))
        if op.state != "completed" or got != want:
            raise AssertionError(f"OPS run_map (command): {op.state}, "
                                 f"{len(got)} rows, {len(want)} wanted")
        out["stages"]["map_cmd"] = dict(op.result)
        client.run_sort("//ops/cmd_in", "//ops/cmd_sorted", sort_by=["g"])
        cmd_groups = _ops_groups(d["g0"][:n], d["v"][:n])
        op = stage("reduce_cmd", lambda: client.run_reduce(
            OPS_REDUCE_CMD, "//ops/cmd_sorted", "//ops/cmd_reduced",
            reduce_by="g", format="json",
            rows_per_job=OPS_CMD_ROWS_PER_JOB), radix=True)
        if op.state != "completed":
            raise AssertionError(f"OPS run_reduce (command): {op.error}")
        out["stages"]["reduce_cmd"] = dict(op.result)
        _ops_check("OPS run_reduce (command)",
                   client.read_table("//ops/cmd_reduced"), cmd_groups)

        def crash():
            # The map phase passes `scheduler.publish` first (its own
            # fan-out of jobs, outside the snapshot): `after=1` crashes at
            # the second hit, once every partition's reduce is recorded
            # and before the output is published.
            try:
                with failpoints.active(
                        "scheduler.publish=crash-once:after=1"):
                    client.run_map_reduce(
                        OPS_IDENTITY_CMD, OPS_REDUCE_CMD, "//ops/cmd_in",
                        "//ops/cmd_mr", reduce_by="g", format="json",
                        partition_count=OPS_CMD_PARTITIONS)
            except failpoints.InjectedCrash:
                return True
            return False

        if not stage("map_reduce_cmd_crash", crash, radix=True):
            raise AssertionError("OPS: scheduler.publish=crash-once did not "
                                 "fire")
        running = [o for o in client.list("//sys/operations")
                   if client.get(f"//sys/operations/{o}/@state") ==
                   "running"]
        if len(running) != 1:
            raise AssertionError(f"OPS: {len(running)} operations left "
                                 "running by the crash")
        # Snapshot records land from the job threads' on_done observers,
        # which may still be running when the crash unwinds.
        doc = f"//sys/operations/{running[0]}/@snapshot"
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                client.exists(doc) and len(client.get(doc).get(
                    "completed") or {}) == OPS_CMD_PARTITIONS):
            time.sleep(0.05)
        client.scheduler._operations.clear()
        revived = stage("revive", client.scheduler.revive_operations,
                        host_only=True)
        if [o.id for o in revived] != running or \
                revived[0].state != "completed" or \
                not revived[0].result.get("revived_jobs", 0) > 0:
            raise AssertionError(f"OPS revival: {[(o.id, o.state, o.result) for o in revived]}")
        out["stages"]["revived"] = dict(revived[0].result)
        _ops_check("OPS revived run_map_reduce (commands)",
                   client.read_table("//ops/cmd_mr"), cmd_groups)

        # Vanilla: a gang, then a task that its memory limit kills.
        op = stage("vanilla", lambda: client.run_vanilla({
            "a": {"job_count": 2, "command": "true"},
            "b": {"job_count": 2, "command": "true"}}), host_only=True)
        if op.state != "completed" or op.result["jobs"] != 4:
            raise AssertionError(f"OPS run_vanilla: {op.state} {op.result}")
        op = stage("vanilla_limit", lambda: client.run_vanilla(
            {"hog": {"job_count": 1, "memory_limit": OPS_MEMORY_LIMIT,
                     "command": "python3 -c 'x = bytearray(1 << 30)'"}},
            max_gang_restarts=0, raise_on_failure=False), host_only=True)
        text = json.dumps(op.error, default=str)
        if op.state != "failed" or "probable_cause" not in text or \
                "memory limit exceeded" not in text:
            raise AssertionError(f"OPS: the memory limit's failure lacks "
                                 f"its probable cause: {text[:300]}")
        out["stages"]["vanilla_limit_failed"] = True
        holder.clear()
        del client
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    _log(f"ops: {out['seconds']:.1f} s in all")
    return out


# --- DERIVED: replicas, chaos, a secondary index, a view, a backup ----------

DER_ROWS = 50_000             # rows of the replicated table (cut from
                              # 100,000 to fit DERIVED in its 50 s)
DER_TX_ROWS = 1_000
DER_PIVOT = 1 << 29           # the table's 2 tablets split k here
DER_LOOKUPS = 4_096
DER_INDEX_SELECTS = 64
DER_QUEUE_ROWS = 262_144     # cut from 1,048,576 (16 batches of 65,536)
DER_QUEUE_BATCH = 16_384
DER_PULLS = 64
DER_BACKUP_LATE = 10_000
DER_VIEW = "g, sum(v) AS s, count(*) AS c FROM [//der/q] GROUP BY g"


def _der_rows(rng, n: int, key_base: int) -> dict:
    """n rows of the replicated table: distinct k (a random sample below
    2^30, offset by key_base), v below 1000, s over 16 strings."""
    import numpy as np
    k = key_base + rng.choice(1 << 30, n, replace=False)
    return {"k": k.astype(np.int64), "v": rng.integers(0, 1000, n),
            "s": rng.integers(0, 16, n)}


def _der_dicts(part: dict, lo: int, hi: int) -> list:
    return [{"k": k, "v": v, "s": f"s{s:02d}"} for k, v, s in zip(
        part["k"][lo:hi].tolist(), part["v"][lo:hi].tolist(),
        part["s"][lo:hi].tolist())]


def _der_state(parts: list) -> dict:
    """{k: (v, s)} of every row written so far."""
    out: dict = {}
    for part in parts:
        out.update(zip(part["k"].tolist(), zip(
            part["v"].tolist(), (f"s{s:02d}".encode()
                                 for s in part["s"].tolist()))))
    return out


def _der_check(name: str, rows: list, state: dict) -> int:
    got = {r["k"]: (r["v"], r["s"]) for r in rows}
    if len(got) != len(rows) or got != state:
        raise AssertionError(f"{name}: {len(rows)} rows, {len(state)} "
                             "wanted, or values differ")
    return len(rows)


def _next_second() -> None:
    """Wait for the wall clock's next second: a replica on a second root
    reads at its own cluster's clock, and a replicated timestamp is folded
    into the process-wide provider only (both packages), so in the second
    of the upstream's commits it can read below them."""
    time.sleep(1.02 - time.time() % 1)


def phase_derived(seed: int, hr, rx, port) -> dict:
    """DERIVED: replication and the derived tables through `connect(tmp,
    device="cuda")` alone. A sorted dynamic table (k key, v, s) in 2
    tablets with a sync replica on its root and an async one on a second
    root (connect(tmp2, device="cuda")): 50,000 rows in transactions of
    1,000, replicated; a select and 4,096 lookups on each replica equal
    the upstream's; the async replica disabled, written past, enabled and
    caught up; one chaos era switch (the async replica becomes the sync
    one) with rows committed across it read back from each replica; a
    secondary index on v serving 64 selects (fetch_via_index must run;
    each equal to the scan's oracle); a 262,144-row queue appended in 16
    batches of 16,384 with a GROUP BY view refreshed after each (both
    radix kernels must launch) and equal to the full GROUP BY, and a
    consumer's 64 pulls and advances; backup_table at a timestamp, 10,000
    more rows, restore_table_backup equal to the table at that timestamp;
    the upstream unmounted and looked up through its replicas. Every
    answer is held to numpy."""
    import numpy as np
    import torch
    from ytsaurus_tpu_torch.client import connect
    from ytsaurus_tpu_torch.tablet import chaos, secondary_index
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 29)
    base = _der_rows(rng, DER_ROWS, 0)
    out: dict = {"paths": {}, "stages": {}}
    holder: dict = {}

    def cache():
        client = holder.get("client")
        return client.cluster.chunk_cache if client is not None else None

    def stage(name, run, radix=False, host_only=False, extra=None):
        result, rec = _client_stage(f"derived {name}", run, hr, rx, cache,
                                    radix=radix, host_only=host_only,
                                    extra=extra)
        out["paths"][f"derived_{name}"] = rec
        return result

    def write(client, part, lo, hi):
        for a in range(lo, hi, DER_TX_ROWS):
            tx = client.start_transaction()
            client.insert_rows("//der/t", _der_dicts(part, a, a + DER_TX_ROWS),
                               tx=tx)
            client.commit_transaction(tx)

    with tempfile.TemporaryDirectory() as root, \
            tempfile.TemporaryDirectory() as root2:
        client = connect(root, device="cuda")
        holder["client"] = client
        down = client.table_replicator.replica_client(root2)
        if {client.cluster.device.type, down.cluster.device.type} != \
                {"cuda"}:
            raise AssertionError("DERIVED: a cluster is not on the card")
        schema = port.TableSchema.make(
            [("k", "int64", "ascending"), ("v", "int64"), ("s", "string")],
            unique_keys=True)
        for c, path in ((client, "//der/t"), (client, "//der/r_sync"),
                        (down, "//der/r_async")):
            c.create("table", path, recursive=True,
                     attributes={"schema": schema, "dynamic": True})
            if path == "//der/t":
                c.reshard_table(path, [(DER_PIVOT,)])
            c.mount_table(path)
        r_sync = client.create_table_replica("//der/t", "//der/r_sync",
                                             mode="sync")
        r_async = client.create_table_replica(
            "//der/t", "//der/r_async", cluster_root=root2, mode="async")
        replicas = ((client, "//der/t"), (client, "//der/r_sync"),
                    (down, "//der/r_async"))

        stage("write", lambda: write(client, base, 0, DER_ROWS),
              host_only=True)
        rec = out["paths"]["derived_write"]
        rec["rows_per_s"] = DER_ROWS / rec["host_s"]
        applied = stage("replicate", lambda: client.table_replicator
                        .replicate_step("//der/t"), host_only=True)
        lag = client.table_replicator.lag("//der/t", r_async)
        if applied.get(r_async) != DER_ROWS or lag != 0:
            raise AssertionError(f"DERIVED replicate: {applied}, lag {lag}")
        out["stages"]["replicated_events"] = applied[r_async]
        state = _der_state([base])
        keys = [(k,) for k in rng.choice(base["k"], DER_LOOKUPS,
                                         replace=False).tolist()]
        want_lookup = [{"k": k, "v": state[k][0], "s": state[k][1]}
                       for (k,) in keys]
        _next_second()

        def read_replicas(label):
            for c, path in replicas:
                _der_check(f"DERIVED {label} select of {path}",
                           c.select_rows(f"k, v, s FROM [{path}]"), state)
                if c.lookup_rows(path, keys) != want_lookup:
                    raise AssertionError(f"DERIVED {label} lookup of {path} "
                                         "differs")
        stage("read_replicas", lambda: read_replicas("replicas"))

        # Disable the async replica, write past it, enable, catch up.
        late = _der_rows(rng, DER_TX_ROWS, 1 << 30)
        client.alter_table_replica("//der/t", r_async, enabled=False)
        write(client, late, 0, DER_TX_ROWS)
        skipped = client.table_replicator.replicate_step("//der/t")
        if client.table_replicator.lag("//der/t", r_async) != DER_TX_ROWS \
                or skipped.get(r_async):
            raise AssertionError(f"DERIVED: a disabled replica was written: "
                                 f"{skipped}")
        client.alter_table_replica("//der/t", r_async, enabled=True)
        caught = stage("catch_up", lambda: client.table_replicator
                       .replicate_step("//der/t"), host_only=True)
        if caught.get(r_async) != DER_TX_ROWS:
            raise AssertionError(f"DERIVED catch-up: {caught}")

        # One chaos era switch, rows committed on both sides of it.
        coord = chaos.ChaosCoordinator(client)
        pre, post = (_der_rows(rng, DER_TX_ROWS, (2 + i) << 30)
                     for i in range(2))
        write(client, pre, 0, DER_TX_ROWS)
        era0 = chaos.current_era(client, "//der/t")
        era = stage("chaos_switch", lambda: coord.switch_sync(
            "//der/t", r_async), host_only=True)
        write(client, post, 0, DER_TX_ROWS)
        client.table_replicator.replicate_step("//der/t")
        descr = client.get_table_replicas("//der/t")
        if era <= era0 or descr[r_async]["mode"] != "sync" or \
                descr[r_sync]["mode"] != "async":
            raise AssertionError(f"DERIVED chaos: era {era0} -> {era}, "
                                 f"{descr}")
        out["stages"]["era"] = [era0, era]
        state = _der_state([base, late, pre, post])
        since = [(k,) for part in (late, pre, post)
                 for k in part["k"].tolist()]
        want_since = [{"k": k, "v": state[k][0], "s": state[k][1]}
                      for (k,) in since]

        def read_since():
            # Lookups read at MAX_TIMESTAMP: no wait for the clock.
            for c, path in replicas:
                if c.lookup_rows(path, since) != want_since:
                    raise AssertionError(f"DERIVED: the rows written across "
                                         f"the switch differ on {path}")
        stage("read_after_switch", read_since, host_only=True)

        # A secondary index on v: 64 selects served through it.
        stage("index_create", lambda: client.create_secondary_index(
            "//der/t", "//der/t_by_v", ["v"]))
        fetch = secondary_index.fetch_via_index
        fetched = []

        def counted(*args, **kwargs):
            fetched.append(args[1])
            return fetch(*args, **kwargs)

        by_v: dict = {}
        for k, (v, s) in state.items():
            by_v.setdefault(v, []).append(k)
        values = rng.choice(1000, DER_INDEX_SELECTS, replace=False).tolist()

        def index_selects():
            n_rows = 0
            for x in values:
                rows = client.select_rows(
                    f"k, v FROM [//der/t] WHERE v = {x}")
                if sorted(r["k"] for r in rows) != sorted(by_v.get(x, [])) \
                        or any(r["v"] != x for r in rows):
                    raise AssertionError(f"DERIVED index select v = {x} "
                                         "differs from the scan's oracle")
                n_rows += len(rows)
            return n_rows

        secondary_index.fetch_via_index = counted
        try:
            out["stages"]["index_rows"] = stage("index_selects",
                                                index_selects)
        finally:
            secondary_index.fetch_via_index = fetch
        if len(fetched) != DER_INDEX_SELECTS:
            raise AssertionError(f"DERIVED: {len(fetched)} of "
                                 f"{DER_INDEX_SELECTS} selects went through "
                                 "the index")

        # A queue, its view refreshed per batch, and a consumer.
        q_schema = port.TableSchema.make([("g", "int64"), ("v", "int64")])
        client.create("table", "//der/q", recursive=True,
                      attributes={"schema": q_schema, "dynamic": True})
        client.mount_table("//der/q")
        client.create_materialized_view("agg", DER_VIEW,
                                        batch_rows=DER_QUEUE_BATCH)
        client.register_queue_consumer("//der/q", "//der/consumer")
        qrng = np.random.default_rng(seed + 31)
        g0 = qrng.integers(0, OPS_GROUPS, DER_QUEUE_ROWS)
        qg = ((g0 * OPS_SPREAD) % (1 << 40)).tolist()
        qv_np = qrng.integers(0, 1000, DER_QUEUE_ROWS)
        qv = qv_np.tolist()
        refreshes = []

        def queue_view():
            for lo in range(0, DER_QUEUE_ROWS, DER_QUEUE_BATCH):
                client.push_queue("//der/q", [
                    {"g": g, "v": v} for g, v in zip(
                        qg[lo:lo + DER_QUEUE_BATCH],
                        qv[lo:lo + DER_QUEUE_BATCH])])
                refreshes.append(client.refresh_view("agg"))
        stage("queue_view", queue_view, radix=True)
        if [r["rows_in"] for r in refreshes] != \
                [DER_QUEUE_BATCH] * (DER_QUEUE_ROWS // DER_QUEUE_BATCH) or \
                refreshes[-1]["lag_rows"] != 0:
            raise AssertionError(f"DERIVED view refreshes: {refreshes[-1]}")
        view = client.get_view("agg")
        rows = stage("view_read", lambda: client.select_rows(
            f"g, s, c FROM [{view['target']}]"))
        out["stages"]["view_groups"] = _ops_check(
            "DERIVED view", rows, _ops_groups(g0, qv_np))
        per = DER_QUEUE_ROWS // DER_PULLS

        def consume():
            offsets = []
            for i in range(DER_PULLS):
                got, nxt = client.pull_consumer("//der/consumer", "//der/q",
                                                limit=per)
                if [r["$row_index"] for r in got] != \
                        list(range(i * per, (i + 1) * per)) or \
                        [r["v"] for r in got] != qv[i * per:(i + 1) * per]:
                    raise AssertionError(f"DERIVED consumer pull {i} differs")
                client.advance_consumer("//der/consumer", "//der/q", nxt)
                offsets.append(nxt)
            return offsets
        offsets = stage("consume", consume, host_only=True)
        if offsets != [(i + 1) * per for i in range(DER_PULLS)]:
            raise AssertionError(f"DERIVED consumer offsets: {offsets[:4]}")

        # A backup at a timestamp, more rows, then the restore.
        cutoff = client.cluster.transactions.timestamps.generate()
        cut_state = dict(state)
        stage("backup", lambda: client.backup_table(
            "//der/t", "//der/backup", timestamp=cutoff), host_only=True)
        extra_rows = _der_rows(rng, DER_BACKUP_LATE, 5 << 30)
        write(client, extra_rows, 0, DER_BACKUP_LATE)
        state = _der_state([base, late, pre, post, extra_rows])

        def restore():
            client.restore_table_backup("//der/backup", "//der/restored")
            client.mount_table("//der/restored")
            return client.select_rows("k, v, s FROM [//der/restored]")
        rows = stage("restore", restore)
        out["stages"]["restored_rows"] = _der_check(
            "DERIVED restored backup", rows, cut_state)
        if len(cut_state) + DER_BACKUP_LATE != len(state):
            raise AssertionError("DERIVED: the later rows overlap the backup")

        # The upstream goes away; lookups fall back to its replicas.
        client.table_replicator.replicate_step("//der/t")
        client.unmount_table("//der/t")
        probe = [(k,) for k in rng.choice(list(state), DER_LOOKUPS,
                                          replace=False).tolist()]
        got = stage("fallback", lambda: client.lookup_rows(
            "//der/t", probe, replica_fallback=True), host_only=True)
        if got != [{"k": k, "v": state[k][0], "s": state[k][1]}
                   for (k,) in probe]:
            raise AssertionError("DERIVED replica fallback lookup differs")
        holder.clear()
        del client, down
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    _log(f"derived: {out['seconds']:.1f} s in all")
    return out


# --- CELLS: the master's quorum and its cells -------------------------------

CELLS_ROWS = 16_777_216        # SELECT's table at its full width, 2 chunks
CELLS_CHUNKS = 2               # of 8,388,608 rows, each on 2 of the 3 nodes
CELLS_NODES = 3                # data nodes (chunk locations and journals)
CELLS_RF = 2                   # RpcChunkStore's replication factor
CELLS_WAL_QUORUM = 2           # the master's write quorum over the 3 nodes
CELLS_LEASE_TTL = 2.0          # seconds of a master's or clock peer's lease
CELLS_WARM = 5                 # warm runs of SELECT_8 after the cold one
CELLS_RATE_MUTATIONS = 100     # Cypress sets that time the WAL alone
CELLS_CELL_ROWS = 1_048_576    # rows written under the portal
CELLS_TOP = 100
CELLS_DYN_ROWS = 100_000       # rows of the dynamic table, in
CELLS_TX_ROWS = 1_000          # transactions of this many rows
CELLS_DYN_KEYS = 1_000_000     # keys drawn without repeats from [0, this)
CELLS_LOOKUPS = 4_096
CELLS_LOOKUP_BATCH = 16
CELLS_THREADS = 16
CELLS_MUTATIONS = 1_000        # Cypress mutations with one node down
CELLS_NAMESPACE = 1_000        # Sequoia's namespace: maps and documents (cut
                               # from 10,000 to what fits 15 s at the WAL's
                               # rate, PERF.md §4)
CELLS_FANOUT = 10              # maps per map on the first three levels
CELLS_RESOLVES = 4_096
CELLS_READS = 256              # read_list / read_get calls
CELLS_LATE_MUTATIONS = 100     # mutations after Sequoia's sync
CELLS_T = "//cells/t"
CELLS_QUERY = ("g, sum(v) AS s, count(*) AS c FROM [//cells/t] "
               "WHERE v < 900 GROUP BY g")
CELLS_JOIN = ("name, sum(v) AS s, count(*) AS c FROM [//cells/t] "
              "JOIN [//cells/dim] USING g GROUP BY name")
CELLS_CELL_QUERY = (f"g, sum(v) AS s FROM [//cell/t] GROUP BY g "
                    f"ORDER BY sum(v) DESC, g LIMIT {CELLS_TOP}")
CELLS_DYN = "//cells/dyn"


class _CellsPlane:
    """CELLS's servers on 127.0.0.1:0: a NodeTracker behind a
    NodeTrackerService, and data nodes, each an RpcServer over a
    DataNodeService with a chunk location and a journal directory of its
    own, heartbeating into the tracker over RPC. A stopped node restarts
    on its port with its disk as it left it. `rpc()` sums the requests
    and bytes of every server the plane has run (clock peers join it)."""

    def __init__(self, root: str):
        from ytsaurus_tpu_torch import rpc
        from ytsaurus_tpu_torch.server.services import (
            NodeTracker,
            NodeTrackerService,
        )
        self.rpc_mod = rpc
        self.root = root
        self.tracker = NodeTracker()
        self.tracker_server = rpc.RpcServer([NodeTrackerService(
            self.tracker)])
        self.tracker_server.start()
        self.servers = [self.tracker_server]
        self.nodes: list = [None] * CELLS_NODES
        self.services: list = [None] * CELLS_NODES
        self.ports = [0] * CELLS_NODES
        self._beats: dict = {}
        for i in range(CELLS_NODES):
            self.start_node(i)

    def start_node(self, i: int) -> None:
        from ytsaurus_tpu_torch.chunks.store import FsChunkStore
        from ytsaurus_tpu_torch.server.services import DataNodeService
        base = os.path.join(self.root, f"node{i}")
        service = DataNodeService(FsChunkStore(os.path.join(base, "chunks")),
                                  os.path.join(base, "journals"))
        server = self.rpc_mod.RpcServer([service], port=self.ports[i])
        server.start()
        self.ports[i] = server.port
        self.nodes[i], self.services[i] = server, service
        self.servers.append(server)
        stop = threading.Event()
        channel = self.rpc_mod.Channel(self.tracker_server.address,
                                       timeout=10)
        body = {"id": f"node{i}", "address": server.address}
        channel.call("node_tracker", "heartbeat", body)

        def loop():
            while not stop.wait(1.0):
                try:
                    channel.call("node_tracker", "heartbeat", body)
                except Exception:   # noqa: BLE001 — the next beat retries
                    pass
            channel.close()
        thread = threading.Thread(target=loop, daemon=True,
                                  name=f"heartbeat-{i}")
        thread.start()
        self._beats[i] = (stop, thread)

    def stop_node(self, i: int) -> None:
        stop, thread = self._beats.pop(i)
        stop.set()
        thread.join()
        self.nodes[i].stop()
        self.nodes[i] = None

    def addresses(self) -> list:
        return [f"127.0.0.1:{p}" for p in self.ports]

    def channels(self) -> list:
        """One plain channel per node: a stopped node refuses at once (a
        retrying channel would back off on every append)."""
        return [self.rpc_mod.Channel(a, timeout=30)
                for a in self.addresses()]

    def rpc(self) -> dict:
        return {key: sum(s.stats[key] for s in self.servers)
                for key in ("requests", "bytes_in", "bytes_out")}

    def journal_counts(self, journal: str = "master_wal") -> list:
        """Each node's record count of `journal` (None while it is down)."""
        out = []
        for address, node in zip(self.addresses(), self.nodes):
            if node is None:
                out.append(None)
                continue
            channel = self.rpc_mod.Channel(address, timeout=30)
            body, _ = channel.call("data_node", "journal_count",
                                   {"journal": journal})
            channel.close()
            out.append(int(body["count"]))
        return out

    def close(self) -> None:
        for i in list(self._beats):
            self.stop_node(i)
        self.tracker_server.stop()


class _CellsClock:
    """The clock quorum: ClockServer peers over the plane's journal nodes
    (journal "clock_wal"), each behind an RpcServer([ClockService])."""

    def __init__(self, plane: _CellsPlane, root: str, peers: int = 2):
        from ytsaurus_tpu_torch.tablet.clock import ClockServer, ClockService
        self.peers = []
        self.servers = []
        for i in range(peers):
            peer = ClockServer(os.path.join(root, f"clock{i}"),
                               plane.channels(), index=i,
                               lease_ttl=CELLS_LEASE_TTL).start()
            server = plane.rpc_mod.RpcServer([ClockService(peer)])
            server.start()
            plane.servers.append(server)
            self.peers.append(peer)
            self.servers.append(server)

    def addresses(self) -> list:
        return [s.address for s in self.servers]

    def wait_leader(self, timeout: float = 60.0) -> int:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            leaders = [i for i, p in enumerate(self.peers)
                       if p is not None and p.is_leader]
            if leaders:
                return leaders[0]
            time.sleep(0.01)
        raise AssertionError("CELLS: no clock leader was elected")

    def kill(self, i: int) -> None:
        """The peer's process goes away: its server stops answering and
        its lease is no longer renewed."""
        self.servers[i].stop()
        self.peers[i].stop()
        self.peers[i] = None

    def close(self) -> None:
        for i, peer in enumerate(self.peers):
            if peer is not None:
                self.kill(i)


def _cells_master(plane, master_dir: str, fresh: bool, lost: dict):
    """A Master over a QuorumWal on the plane's nodes (write quorum 2 of
    3, remote-only: a successor recovers with a fresh local path), elected
    by a LeaderElector. Returns (master, wal, elector, seconds to elect
    and recover)."""
    from ytsaurus_tpu_torch.cypress.election import LeaderElector
    from ytsaurus_tpu_torch.cypress.master import Master
    from ytsaurus_tpu_torch.cypress.quorum import QuorumWal
    t = time.perf_counter()
    os.makedirs(master_dir, exist_ok=True)
    wal = QuorumWal(os.path.join(master_dir, Master.CHANGELOG),
                    "master_wal", plane.channels(), quorum=CELLS_WAL_QUORUM,
                    count_local_ack=False, bootstrap_from_local=fresh,
                    lease_ttl=CELLS_LEASE_TTL)
    elector = LeaderElector("master_wal",
                            lambda: [r.channel for r in wal.replicas],
                            wal.writer_id, lease_ttl=CELLS_LEASE_TTL)
    if not elector.wait_until_electable(timeout=60.0):
        raise AssertionError("CELLS: the master never became electable")
    master = Master(master_dir, wal=wal)
    elector.start_renewing(lambda: wal.epoch,
                           lambda: lost.__setitem__("master", True))
    return master, wal, elector, time.perf_counter() - t


def _cells_data(seed: int) -> dict:
    """The select table's chunks, the cell's rows and the dynamic table's
    rows and lookup keys, from --seed."""
    import numpy as np
    rng = np.random.default_rng(seed + 29)
    per = CELLS_ROWS // CELLS_CHUNKS
    chunks = [{"k": np.arange(i * per, (i + 1) * per, dtype=np.int64),
               "g": rng.integers(0, SELECT_GROUPS, per),
               "v": rng.integers(0, 1000, per)}
              for i in range(CELLS_CHUNKS)]
    cell = {"k": np.arange(CELLS_CELL_ROWS, dtype=np.int64),
            "g": rng.integers(0, SELECT_GROUPS, CELLS_CELL_ROWS),
            "v": rng.integers(0, 1000, CELLS_CELL_ROWS)}
    dyn_k = rng.permutation(CELLS_DYN_KEYS)[:CELLS_DYN_ROWS]
    dyn_g = rng.integers(0, 1000, CELLS_DYN_ROWS)
    dyn_v = rng.integers(0, 1000, CELLS_DYN_ROWS)
    present = rng.choice(CELLS_DYN_ROWS, CELLS_LOOKUPS * 3 // 4,
                         replace=False)
    absent = CELLS_DYN_KEYS + rng.choice(CELLS_DYN_KEYS, CELLS_LOOKUPS // 4,
                                         replace=False)
    keys = np.concatenate([dyn_k[present], absent])
    rng.shuffle(keys)
    return {"chunks": chunks, "cell": cell, "dyn_k": dyn_k, "dyn_g": dyn_g,
            "dyn_v": dyn_v, "lookup_keys": keys.tolist(),
            "probe": rng.integers(0, 1 << 31, CELLS_RESOLVES).tolist()}


def _cells_lookups(client, d: dict) -> int:
    """CELLS_LOOKUPS keys of the dynamic table from CELLS_THREADS threads
    in calls of CELLS_LOOKUP_BATCH keys, each row against the oracle."""
    oracle = {int(k): (int(g), int(v)) for k, g, v in
              zip(d["dyn_k"], d["dyn_g"], d["dyn_v"])}
    keys = d["lookup_keys"]
    per = len(keys) // CELLS_THREADS

    def run(i):
        mine = keys[i * per:(i + 1) * per]
        for lo in range(0, per, CELLS_LOOKUP_BATCH):
            part = mine[lo:lo + CELLS_LOOKUP_BATCH]
            rows = client.lookup_rows(CELLS_DYN, [(k,) for k in part])
            for k, row in zip(part, rows):
                want = oracle.get(k)
                got = None if row is None else (row["g"], row["v"])
                if got != want or (row is not None and row["k"] != k):
                    raise AssertionError(f"CELLS lookup of {k}: {row} != "
                                         f"{want}")
        return per

    return sum(_client_threads(run, CELLS_THREADS))


def _cells_readback(client, d: dict) -> int:
    rows = client.select_rows(f"k, g, v FROM [{CELLS_DYN}]")
    got = sorted((r["k"], r["g"], r["v"]) for r in rows)
    if got != sorted(zip(d["dyn_k"].tolist(), d["dyn_g"].tolist(),
                         d["dyn_v"].tolist())):
        raise AssertionError("CELLS: an acknowledged write of the dynamic "
                             "table was not read back")
    return len(got)


def _cells_namespace(n: int) -> list:
    """(path, type, value) of n Cypress nodes four levels deep under
    //seq: maps on the first three levels (CELLS_FANOUT each), documents
    under the third-level maps, in creation order (parents first)."""
    maps = []
    for a in range(CELLS_FANOUT):
        maps.append(f"//seq/m{a}")
        for b in range(CELLS_FANOUT):
            maps.append(f"//seq/m{a}/m{b}")
            for c in range(CELLS_FANOUT):
                maps.append(f"//seq/m{a}/m{b}/m{c}")
    maps.sort(key=lambda p: p.count("/"))
    maps = maps[:n // 2]
    leaves = [p for p in maps if p.count("/") == maps[-1].count("/")]
    nodes = [(p, "map_node", None) for p in maps]
    i = 0
    while len(nodes) < n:
        parent = leaves[i % len(leaves)]
        nodes.append((f"{parent}/d{i}", "document", {"i": i, "p": parent}))
        i += 1
    return nodes


def phase_cells(seed: int, hr, rx, port) -> dict:
    """CELLS: the master's quorum and its cells in one process on
    127.0.0.1:0, as `server/daemon.py` composes them across processes:
    three data nodes (DataNodeService over an FsChunkStore and a journal
    directory each, heartbeating into a NodeTracker), a Master on a
    QuorumWal over them (write quorum 2 of 3) elected by a
    LeaderElector, two ClockServer peers electing over the same nodes
    under "clock_wal", a QuorumTimestampProvider over both as the
    cluster's clock, and a YtCluster on the card whose chunks live on the
    data nodes (RpcChunkStore, 2 replicas). Six stages, each held to
    numpy: bring-up (the election and recovery seconds, and the WAL's
    mutation rate alone); 16,777,216 rows published as 2 chunks, SELECT_8
    cold (blobs over RPC, decoded onto the card) and 5 times warm, and the
    join with a 10,000-row dimension (both radix kernels); a portal
    //cell on a second root on the card, 1,048,576 rows written under it
    through the primary, GROUP BY ... ORDER BY ... LIMIT 100 through the
    primary's routed front door (`multicell.delegate_for`), and the
    portal's removal, whose exit Hive dismantles exactly once; 100,000
    rows into a dynamic table in 100 transactions with the clock leader
    killed after the 50th (strictly rising commit timestamps, then
    lookups and a read-back); a master failover (1,000 mutations with
    node 3 down, a new Master on a fresh path over the same nodes at
    epoch + 1, the WAL invariant, node 3 caught up, SELECT_8 and the
    read-back on a new cluster without waiting for the next second); and
    Sequoia over a namespace built through the quorum WAL (resolves,
    read_list / read_get, more mutations with an aborted transaction, and
    verify()). Each stage records host s, device ms, idle share,
    launches and the RPC requests and bytes of every server."""
    import numpy as np
    import torch
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.client import (
        YtClient,
        YtCluster,
        publish_table_chunks,
    )
    from ytsaurus_tpu_torch.cypress import multicell
    from ytsaurus_tpu_torch.cypress.sequoia import SequoiaResolver
    from ytsaurus_tpu_torch.server.remote_store import RpcChunkStore
    from ytsaurus_tpu_torch.tablet.clock import QuorumTimestampProvider
    from ytsaurus_tpu_torch.utils.invariants import check_wal
    t_phase = time.perf_counter()
    d = _cells_data(seed)
    out: dict = {"paths": {}, "stages": {}}
    holder: dict = {}
    lost: dict = {}

    def cache():
        client = holder.get("client")
        return client.cluster.chunk_cache if client is not None else None

    def stage(name, run, plane, radix=False, host_only=False):
        before = plane.rpc()
        result, rec = _client_stage(f"cells {name}", run, hr, rx, cache,
                                    radix=radix, host_only=host_only)
        after = plane.rpc()
        wire = {f"rpc_{k}": after[k] - before[k] for k in after}
        rec.update(wire)
        _log(f"cells {name} rpc: {json.dumps(wire)}")
        out["paths"][f"cells_{name}"] = rec
        return result

    g_all = np.concatenate([c["g"] for c in d["chunks"]])
    v_all = np.concatenate([c["v"] for c in d["chunks"]])
    sel = v_all < 900
    select_oracle = (np.bincount(g_all[sel], weights=v_all[sel],
                                 minlength=SELECT_GROUPS),
                     np.bincount(g_all[sel], minlength=SELECT_GROUPS))
    name_of_g = np.arange(SELECT_GROUPS) % CLIENT_NAMES
    join_oracle = (np.bincount(name_of_g[g_all], weights=v_all,
                               minlength=CLIENT_NAMES),
                   np.bincount(name_of_g[g_all], minlength=CLIENT_NAMES))
    del g_all, v_all, sel
    cell_sums = np.bincount(d["cell"]["g"], weights=d["cell"]["v"],
                            minlength=SELECT_GROUPS).astype(np.int64)
    cell_groups = np.flatnonzero(np.bincount(d["cell"]["g"],
                                             minlength=SELECT_GROUPS))
    cell_top = sorted(((-int(cell_sums[g]), int(g)) for g in cell_groups)
                      )[:CELLS_TOP]

    def check_select(name, rows):
        return _client_check_groups(name, rows, "g", *select_oracle)

    def check_join(name, rows):
        named = [{"name": int(r["name"][4:]), "s": r["s"], "c": r["c"]}
                 for r in rows]
        return _client_check_groups(name, named, "name", *join_oracle)

    with tempfile.TemporaryDirectory() as root:
        plane = _CellsPlane(os.path.join(root, "nodes"))
        clock = None
        try:
            # --- 1. bring-up ------------------------------------------------
            def bring_up():
                t = time.perf_counter()
                c = _CellsClock(plane, os.path.join(root, "clocks"))
                leader = c.wait_leader()
                clock_s = time.perf_counter() - t
                master, wal, elector, master_s = _cells_master(
                    plane, os.path.join(root, "master"), True, lost)
                provider = QuorumTimestampProvider(c.addresses(),
                                                   failover_deadline=60.0)
                store = RpcChunkStore(plane.tracker.alive_nodes,
                                      replication_factor=CELLS_RF)
                cluster = YtCluster(os.path.join(root, "cluster"),
                                    chunk_store=store, master=master,
                                    device="cuda")
                cluster.transactions.timestamps = provider
                return (c, leader, clock_s, master, wal, elector, master_s,
                        provider, store, YtClient(cluster))
            (clock, leader, clock_s, master, wal, elector, master_s,
             provider, store, client) = stage("bring_up", bring_up, plane,
                                              host_only=True)
            holder["client"] = client
            if client.cluster.device.type != "cuda" or wal.epoch != 1 or \
                    plane.journal_counts() != [len(wal._records)] * \
                    CELLS_NODES:
                raise AssertionError("CELLS bring-up: the cluster is not on "
                                     "the card or a node lacks a record")
            out["stages"]["bring_up"] = {
                "clock_elect_s": clock_s, "clock_leader": leader,
                "master_elect_s": master_s, "epoch": wal.epoch}
            _log(f"cells bring-up: {json.dumps(out['stages']['bring_up'])}")
            client.create("document", "//cells/rate", recursive=True,
                          attributes={"value": 0})

            def rate():
                for i in range(CELLS_RATE_MUTATIONS):
                    client.set("//cells/rate", i)
            stage("wal_rate", rate, plane, host_only=True)
            rec = out["paths"]["cells_wal_rate"]
            rec["mutations_per_s"] = CELLS_RATE_MUTATIONS / rec["host_s"]
            _log(f"cells WAL rate alone: {rec['mutations_per_s']:.1f} "
                 "mutations/s")
            if client.get("//cells/rate") != CELLS_RATE_MUTATIONS - 1:
                raise AssertionError("CELLS: a WAL-rate mutation was lost")

            # --- 2. chunks on data nodes ------------------------------------
            schema = port.TableSchema.make([("k", "int64"), ("g", "int64"),
                                            ("v", "int64")])

            def publish():
                client.create("table", CELLS_T, recursive=True,
                              attributes={"schema": schema})
                chunks = [ColumnarChunk.from_arrays(schema, a, device="cuda")
                          for a in d["chunks"]]
                publish_table_chunks(client, store, CELLS_T, chunks,
                                     schema=schema)
            stage("publish", publish, plane)
            cids = client.get(CELLS_T + "/@chunk_ids")
            held = [[i for i, svc in enumerate(plane.services)
                     if svc.store.exists(cid)] for cid in cids]
            if client.get(CELLS_T + "/@row_count") != CELLS_ROWS or \
                    [len(h) for h in held] != [CELLS_RF] * CELLS_CHUNKS:
                raise AssertionError(f"CELLS: the published chunks are "
                                     f"placed on {held}")
            out["stages"]["chunk_nodes"] = held
            rows = stage("select_8_cold",
                         lambda: client.select_rows(CELLS_QUERY), plane)
            if out["paths"]["cells_select_8_cold"]["cache_misses"] != \
                    CELLS_CHUNKS:
                raise AssertionError("CELLS: the cold select did not fetch "
                                     "every chunk from the data nodes")
            out["stages"]["select_8_groups"] = check_select(
                "CELLS SELECT_8 cold", rows)
            if {client.cluster.chunk_cache.get(c).device.type
                    for c in cids} != {"cuda"}:
                raise AssertionError("CELLS: a chunk read over RPC is not "
                                     "on the card")
            warm = []
            for _ in range(CELLS_WARM):
                t = time.perf_counter()
                check_select("CELLS SELECT_8 warm",
                             client.select_rows(CELLS_QUERY))
                warm.append(time.perf_counter() - t)
            out["stages"]["select_8_warm_s"] = warm
            _log(f"cells SELECT_8 warm: {[round(w, 4) for w in warm]} s")
            dim_rows = [{"g": g, "name": f"name{g % CLIENT_NAMES:02d}"}
                        for g in range(CLIENT_DIM_ROWS)]
            client.write_table("//cells/dim", dim_rows)
            rows = stage("join", lambda: client.select_rows(CELLS_JOIN),
                         plane, radix=True)
            out["stages"]["join_groups"] = check_join("CELLS join", rows)

            # --- 3. cells ---------------------------------------------------
            cell_root = os.path.join(root, "cell")
            client.create("portal_entrance", "//cell", attributes={
                "cell_root": cell_root, "cell_tag": 2})
            cell = multicell.cell_client(client, cell_root)
            if cell.cluster.device != client.cluster.device:
                raise AssertionError("CELLS: the cell is not on the "
                                     "primary's device")
            cell_rows = [{"k": k, "g": g, "v": v} for k, g, v in zip(
                d["cell"]["k"].tolist(), d["cell"]["g"].tolist(),
                d["cell"]["v"].tolist())]
            stage("cell_write", lambda: client.write_table("//cell/t",
                                                           cell_rows), plane)
            del cell_rows
            if client.get("//cell/t/@row_count") != CELLS_CELL_ROWS or \
                    cell.get("//cell/t/@row_count") != CELLS_CELL_ROWS or \
                    client.cluster.master.tree.try_resolve("//cell/t") \
                    is not None:
                raise AssertionError("CELLS: //cell/t is not on the cell")

            def cell_select():
                delegate = multicell.delegate_for(client, "//cell/t",
                                                  "read")
                if delegate is not cell:
                    raise AssertionError("CELLS: //cell/t is not routed "
                                         "to the cell")
                with multicell.as_cell_principal():
                    return delegate.select_rows(CELLS_CELL_QUERY)
            rows = stage("cell_select", cell_select, plane)
            if [(-r["s"], r["g"]) for r in rows] != cell_top:
                raise AssertionError("CELLS: the cell's ORDER BY ... LIMIT "
                                     "differs from numpy")
            hive = multicell.hive_of(client)
            cell_hive = multicell.hive_of(cell)
            before = cell_hive.last_applied(hive.cell_id)
            stage("portal_remove", lambda: client.remove(
                "//cell", recursive=True), plane, host_only=True)
            applied = cell_hive.last_applied(hive.cell_id) - before
            if client.exists("//cell") or cell.exists("//cell") or \
                    applied != 1 or hive.pending(cell_hive.cell_id):
                raise AssertionError(f"CELLS: the portal's exit was not "
                                     f"dismantled exactly once ({applied} "
                                     "messages applied)")
            out["stages"]["hive_applied"] = applied

            # --- 4. the clock quorum ---------------------------------------
            dyn_schema = port.TableSchema.make(
                [("k", "int64", "ascending"), ("g", "int64"),
                 ("v", "int64")], unique_keys=True)
            client.create("table", CELLS_DYN, attributes={
                "schema": dyn_schema, "dynamic": True})
            client.mount_table(CELLS_DYN)
            dyn_rows = [{"k": k, "g": g, "v": v} for k, g, v in zip(
                d["dyn_k"].tolist(), d["dyn_g"].tolist(),
                d["dyn_v"].tolist())]
            commits: list = []
            failover: dict = {}

            def insert():
                for n, lo in enumerate(range(0, CELLS_DYN_ROWS,
                                             CELLS_TX_ROWS)):
                    if n == CELLS_DYN_ROWS // CELLS_TX_ROWS // 2:
                        failover["killed"] = clock.wait_leader()
                        clock.kill(failover["killed"])
                        t_kill = time.perf_counter()
                    tx = client.start_transaction()
                    client.insert_rows(CELLS_DYN,
                                       dyn_rows[lo:lo + CELLS_TX_ROWS],
                                       tx=tx)
                    commits.append(client.commit_transaction(tx))
                    if "killed" in failover and "s" not in failover:
                        failover["s"] = time.perf_counter() - t_kill
            stage("clock_insert", insert, plane, host_only=True)
            failover["leader"] = clock.wait_leader()
            if failover["leader"] == failover["killed"] or \
                    len(commits) != CELLS_DYN_ROWS // CELLS_TX_ROWS or \
                    any(b <= a for a, b in zip(commits, commits[1:])):
                raise AssertionError(f"CELLS: the clock did not fail over "
                                     f"or a commit timestamp did not rise "
                                     f"({failover})")
            out["stages"]["clock_failover"] = failover
            _log(f"cells clock failover: {json.dumps(failover)}")
            rec = out["paths"]["cells_clock_insert"]
            rec["rows_per_s"] = CELLS_DYN_ROWS / rec["host_s"]
            out["stages"]["readback_rows"] = stage(
                "lookup_readback", lambda: (_cells_lookups(client, d),
                                            _cells_readback(client, d))[1],
                plane)

            # --- 5. master failover ----------------------------------------
            client.unmount_table(CELLS_DYN)
            client.create("map_node", "//cells/m")
            plane.stop_node(CELLS_NODES - 1)

            def mutations():
                for i in range(CELLS_MUTATIONS):
                    client.set(f"//cells/m/d{i}", i)
            # Every append warns that the stopped node refused its catch-up.
            quorum_log = logging.getLogger("ytsaurus_tpu_torch.quorum")
            level = quorum_log.level
            quorum_log.setLevel(logging.ERROR)
            try:
                stage("mutations", mutations, plane, host_only=True)
            finally:
                quorum_log.setLevel(level)
            rec = out["paths"]["cells_mutations"]
            rec["mutations_per_s"] = CELLS_MUTATIONS / rec["host_s"]
            acked = len(wal._records)
            if lost or plane.journal_counts()[:CELLS_NODES - 1] != \
                    [acked] * (CELLS_NODES - 1):
                raise AssertionError("CELLS: a mutation with one node down "
                                     "was not acknowledged by 2 of 3")
            epoch = wal.epoch
            t_fail = time.perf_counter()
            elector.stop()
            wal.close()
            holder.clear()
            del client, master
            plane.start_node(CELLS_NODES - 1)

            def recover():
                m, w, e, _ = _cells_master(
                    plane, os.path.join(root, "master2"), False, lost)
                recovered = list(w._records)
                cl = YtCluster(os.path.join(root, "cluster"),
                               chunk_store=store, master=m, device="cuda")
                cl.transactions.timestamps = provider
                c = YtClient(cl)
                holder["client"] = c
                return m, w, e, c, recovered
            master, wal, elector, client, recovered = stage(
                "recover", recover, plane, host_only=True)
            failover_s = time.perf_counter() - t_fail
            counts = plane.journal_counts()
            check_wal(recovered)
            values = [client.get(f"//cells/m/d{i}")
                      for i in range(CELLS_MUTATIONS)]
            if wal.epoch != epoch + 1 or len(recovered) != acked or \
                    counts != [len(wal._records)] * CELLS_NODES or \
                    values != list(range(CELLS_MUTATIONS)):
                raise AssertionError(f"CELLS: the recovered master differs "
                                     f"(epoch {wal.epoch}, {len(recovered)} "
                                     f"records recovered, {counts} on the "
                                     f"nodes, {acked} acknowledged, "
                                     f"documents {values[:3]}...)")
            out["stages"]["master_failover"] = {
                "seconds": failover_s, "epoch": wal.epoch,
                "records": acked, "journal_counts": counts}
            _log(f"cells master failover: "
                 f"{json.dumps(out['stages']['master_failover'])}")
            client.mount_table(CELLS_DYN)
            rows = stage("reads_recovered", lambda: (
                client.select_rows(CELLS_QUERY),
                _cells_readback(client, d))[0], plane)
            check_select("CELLS SELECT_8 after the failover", rows)

            # --- 6. Sequoia ------------------------------------------------
            nodes = _cells_namespace(CELLS_NAMESPACE)

            def build():
                for path, kind, value in nodes:
                    if kind == "map_node":
                        client.create(kind, path, recursive=True)
                    else:
                        client.set(path, value)
            stage("namespace", build, plane, host_only=True)
            rec = out["paths"]["cells_namespace"]
            rec["mutations_per_s"] = len(nodes) / rec["host_s"]
            seq = stage("sequoia_enable",
                        lambda: SequoiaResolver(client).enable(), plane,
                        host_only=True)
            tree = client.cluster.master.tree
            paths = [p for p, _, _ in nodes]
            probe = [paths[i % len(paths)] if i % 8 else
                     f"//seq/missing{i}" for i in d["probe"]]

            maps = [p for p, kind, _ in nodes if kind == "map_node"]
            docs = [p for p, kind, _ in nodes if kind == "document"]
            # read_get of a map assembles its subtree from the tables: the
            # deepest maps, whose children are documents.
            leaf_maps = [p for p in maps
                         if p.count("/") == maps[-1].count("/")]
            reads = []
            for i in range(CELLS_READS):
                pick = (i * 7919) % 1_000_003
                reads.append(("list", maps[pick % len(maps)]) if i % 2 else
                             ("get", leaf_maps[pick % len(leaf_maps)])
                             if i % 4 == 2 else ("get", docs[pick % len(docs)]))

            def read():
                return ([seq.resolve(path) for path in probe],
                        [seq.read_list(p) if kind == "list" else
                         seq.read_get(p) for kind, p in reads])
            resolved, got = stage("sequoia_reads", read, plane)
            for path, res in zip(probe, resolved):
                node = tree.try_resolve(path, follow_links=False)
                want = None if node is None else {"node_id": node.id,
                                                  "node_type": node.type}
                if res != want:
                    raise AssertionError(f"CELLS resolve {path}: {res} != "
                                         f"{want}")
            for (kind, path), res in zip(reads, got):
                want = sorted(client.list(path)) if kind == "list" else \
                    client.get(path)
                if (sorted(res) if kind == "list" else res) != want:
                    raise AssertionError(f"CELLS read_{kind} {path}: "
                                         f"{res} != {want}")

            def late():
                for i in range(CELLS_LATE_MUTATIONS - 3):
                    path = docs[(i * 131) % len(docs)]
                    if i % 3 == 0:
                        client.set(path, {"late": i})
                    elif i % 3 == 1:
                        client.create("document", f"//seq/late/d{i}",
                                      recursive=True,
                                      attributes={"value": i})
                    else:
                        client.set(path + "/@tag", f"t{i}")
                client.remove(docs[0])
                tx = client.start_tx()
                client.create("map_node", "//seq/aborted/x",
                              recursive=True, tx=tx)
                client.abort_tx(tx)
                return seq.verify()
            divergent = stage("sequoia_late", late, plane)
            if divergent or seq.resolve("//seq/aborted") is not None or \
                    seq.resolve(docs[0]) is not None or \
                    seq.read_get(docs[1]) != client.get(docs[1]):
                raise AssertionError(f"CELLS: Sequoia's tables diverge from "
                                     f"the tree: {divergent[:5]}")
            out["stages"]["sequoia"] = {"nodes": len(nodes),
                                        "resolves": len(probe),
                                        "reads": len(reads)}
            if lost:
                raise AssertionError("CELLS: the master lost its lease")
            elector.stop()
            wal.close()
            provider.close()
            store.close()
            holder.clear()
            del client, seq, tree
        finally:
            if clock is not None:
                clock.close()
            plane.close()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    _log(f"cells: {out['seconds']:.1f} s in all")
    return out


# --- CLUSTER: the multi-process cluster -------------------------------------

CLUSTER_ROWS = 16_777_216      # SELECT's table at its full width, 2 chunks
CLUSTER_CHUNKS = 2             # of 8,388,608 rows, each on 2 of the 3 nodes
CLUSTER_NODES = 3              # data-node daemons
CLUSTER_RF = 2                 # replicas of a chunk
CLUSTER_WARM = 5               # warm runs of SELECT_8 after the cold one
CLUSTER_TOP = 100
CLUSTER_DYN_ROWS = 100_000     # rows of the dynamic table, in
CLUSTER_TX_ROWS = 1_000        # transactions of this many rows
CLUSTER_DYN_KEYS = 1_000_000   # keys drawn without repeats from [0, this)
CLUSTER_LOOKUPS = 4_096
CLUSTER_LOOKUP_BATCH = 16
CLUSTER_THREADS = 16
CLUSTER_MAP_ROWS = 65_536      # the command map's input
CLUSTER_MAP_ROWS_PER_JOB = 16_384
CLUSTER_T = "//cluster/t"
CLUSTER_SORTED = "//cluster/sorted"
CLUSTER_DIM = "//cluster/dim"
CLUSTER_DYN = "//cluster/dyn"
CLUSTER_QUERY = ("g, sum(v) AS s, count(*) AS c FROM [//cluster/t] "
                 "WHERE v < 900 GROUP BY g")
CLUSTER_JOIN = ("name, sum(v) AS s, count(*) AS c FROM [//cluster/t] "
                "JOIN [//cluster/dim] USING g GROUP BY name")
CLUSTER_TOP_QUERY = (f"g, sum(v) AS s FROM [{CLUSTER_SORTED}] GROUP BY g "
                     f"ORDER BY sum(v) DESC, g LIMIT {CLUSTER_TOP}")


def _cluster_data(seed: int) -> dict:
    """The select table's chunks, the dynamic table's rows and lookup
    keys, and the command map's input, from --seed."""
    import numpy as np
    rng = np.random.default_rng(seed + 31)
    per = CLUSTER_ROWS // CLUSTER_CHUNKS
    chunks = [{"k": np.arange(i * per, (i + 1) * per, dtype=np.int64),
               "g": rng.integers(0, SELECT_GROUPS, per),
               "v": rng.integers(0, 1000, per)}
              for i in range(CLUSTER_CHUNKS)]
    dyn_k = rng.permutation(CLUSTER_DYN_KEYS)[:CLUSTER_DYN_ROWS]
    dyn_g = rng.integers(0, 1000, CLUSTER_DYN_ROWS)
    dyn_v = rng.integers(0, 1000, CLUSTER_DYN_ROWS)
    present = rng.choice(CLUSTER_DYN_ROWS, CLUSTER_LOOKUPS * 3 // 4,
                         replace=False)
    absent = CLUSTER_DYN_KEYS + rng.choice(
        CLUSTER_DYN_KEYS, CLUSTER_LOOKUPS // 4, replace=False)
    keys = np.concatenate([dyn_k[present], absent])
    rng.shuffle(keys)
    return {"chunks": chunks, "dyn_k": dyn_k, "dyn_g": dyn_g,
            "dyn_v": dyn_v, "lookup_keys": keys.tolist(),
            "map": {"a": np.arange(CLUSTER_MAP_ROWS, dtype=np.int64),
                    "b": rng.integers(0, 1 << 40, CLUSTER_MAP_ROWS)}}


def _compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _node_call(address: str, method: str, body: dict) -> dict:
    from ytsaurus_tpu_torch.rpc import Channel
    channel = Channel(address, timeout=60)
    try:
        return channel.call("data_node" if method != "exec_stats"
                            else "exec_node", method, body)[0]
    finally:
        channel.close()


def _cluster_lookups(client, d: dict) -> int:
    """CLUSTER_LOOKUPS keys of the dynamic table from CLUSTER_THREADS
    threads in calls of CLUSTER_LOOKUP_BATCH keys over RPC, each row
    against the oracle."""
    oracle = {int(k): (int(g), int(v)) for k, g, v in
              zip(d["dyn_k"], d["dyn_g"], d["dyn_v"])}
    keys = d["lookup_keys"]
    per = len(keys) // CLUSTER_THREADS

    def run(i):
        mine = keys[i * per:(i + 1) * per]
        for lo in range(0, per, CLUSTER_LOOKUP_BATCH):
            part = mine[lo:lo + CLUSTER_LOOKUP_BATCH]
            rows = client.lookup_rows(CLUSTER_DYN, [(k,) for k in part])
            for k, row in zip(part, rows):
                want = oracle.get(k)
                got = None if row is None else (row["g"], row["v"])
                if got != want or (row is not None and row["k"] != k):
                    raise AssertionError(f"CLUSTER lookup of {k}: {row} != "
                                         f"{want}")
        return per

    return sum(_client_threads(run, CLUSTER_THREADS))


def phase_cluster(seed: int, hr, rx, port) -> dict:
    """CLUSTER: the port's multi-process cluster. A LocalCluster of a
    primary daemon on the card and CLUSTER_NODES data-node daemons
    (CLUSTER_RF replicas), this process its client through
    connect_remote(..., device="cuda"). Eight stages, each held to numpy
    (the module docstring lists them). A stage whose kernels run in this
    process is profiled as CLIENT's device stages are; a stage served by
    the primary runs on the host's clock here, inside a device trace of
    the primary (its orchid /query/device/trace/start and /stop), and
    records the primary's launches, the difference of its /query/device
    counts around the stage, which its trace must hold one for one. The
    daemons start on a thread while this process makes the data and the
    oracles; the bring-up stage is their spawn-to-ready seconds."""
    import torch
    from ytsaurus_tpu_torch.environment import LocalCluster
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    mode = _compute_mode()
    _log(f"cluster: card memory free {free / 2**30:.2f} of "
         f"{total / 2**30:.2f} GiB, compute mode {mode}")
    if mode.replace(" ", "_").lower() == "exclusive_process":
        raise AssertionError("CLUSTER: the card's compute mode is "
                             "Exclusive_Process; the primary daemon and "
                             "this process must share it")
    # The daemons start while this process makes the data and oracles.
    root = tempfile.mkdtemp(prefix="cluster-")
    cluster = LocalCluster(os.path.join(root, "c"), n_nodes=CLUSTER_NODES,
                           replication_factor=CLUSTER_RF, device="cuda")
    spawn: dict = {}

    def start():
        t = time.perf_counter()
        try:
            cluster.start()
        except BaseException as exc:   # noqa: BLE001 — raised below
            spawn["error"] = exc
        spawn["s"] = time.perf_counter() - t

    starter = threading.Thread(target=start, name="cluster-start")
    starter.start()
    try:
        return _cluster_stages(seed, hr, rx, port, cluster, starter, spawn,
                               {"card_free_bytes": free,
                                "card_total_bytes": total,
                                "compute_mode": mode}, t_phase)
    finally:
        starter.join()
        cluster.stop()
        shutil.rmtree(root, ignore_errors=True)


def _cluster_stages(seed, hr, rx, port, cluster, starter, spawn, card,
                    t_phase) -> dict:
    """phase_cluster's stages, once its daemons are spawning."""
    import numpy as np
    import torch
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.client import publish_table_chunks
    from ytsaurus_tpu_torch.remote_client import connect_remote
    d = _cluster_data(seed)
    out: dict = {"paths": {}, "stages": {}, **card}
    holder: dict = {}

    def device_state() -> dict:
        return holder["client"].get_orchid("/query/device")

    def stage(name, run, radix=False, host_only=False, primary=False):
        if primary:
            before = device_state()["launches"]
            t = time.perf_counter()
            holder["client"].get_orchid("/query/device/trace/start")
            trace_start_s = time.perf_counter() - t
        result, rec = _client_stage(f"cluster {name}", run, hr, rx,
                                    lambda: None, radix=radix and not primary,
                                    host_only=host_only or primary)
        if primary:
            t = time.perf_counter()
            trace = holder["client"].get_orchid("/query/device/trace/stop")
            trace.update(start_s=trace_start_s,
                         stop_s=time.perf_counter() - t)
            after = device_state()["launches"]
            served = {k: int(after[k]) - int(before[k]) for k in after}
            rec["launches_here"] = rec["launches"]
            rec["launches_primary"] = served
            rec["launches"] = {k: v + served.get(k, 0)
                               for k, v in rec["launches"].items()}
            rec["primary_trace"] = trace
            _log(f"cluster {name} primary launches: {json.dumps(served)}, "
                 f"trace: {json.dumps(trace)}")
            if radix and min(served[k] for k in PATH_KERNELS) <= 0:
                raise AssertionError(f"CLUSTER {name}: the primary launched "
                                     f"{served}, not both radix kernels")
            if {k: int(v) for k, v in trace["traced"].items()} != \
                    {k: served[k] for k in trace["traced"]}:
                raise AssertionError(f"CLUSTER {name}: the primary's trace "
                                     f"holds {trace['traced']}, it launched "
                                     f"{served}")
        out["paths"][f"cluster_{name}"] = rec
        return result

    g_all = np.concatenate([c["g"] for c in d["chunks"]])
    v_all = np.concatenate([c["v"] for c in d["chunks"]])
    k_all = np.concatenate([c["k"] for c in d["chunks"]])
    sel = v_all < 900
    select_oracle = (np.bincount(g_all[sel], weights=v_all[sel],
                                 minlength=SELECT_GROUPS),
                     np.bincount(g_all[sel], minlength=SELECT_GROUPS))
    name_of_g = np.arange(SELECT_GROUPS) % CLIENT_NAMES
    join_oracle = (np.bincount(name_of_g[g_all], weights=v_all,
                               minlength=CLIENT_NAMES),
                   np.bincount(name_of_g[g_all], minlength=CLIENT_NAMES))
    sums = np.bincount(g_all, weights=v_all,
                       minlength=SELECT_GROUPS).astype(np.int64)
    present = np.flatnonzero(np.bincount(g_all, minlength=SELECT_GROUPS))
    top = sorted((-int(sums[g]), int(g)) for g in present)[:CLUSTER_TOP]
    del sel

    def check_select(name, rows):
        return _client_check_groups(name, rows, "g", *select_oracle)

    def check_join(name, rows):
        named = [{"name": int(r["name"][4:]), "s": r["s"], "c": r["c"]}
                 for r in rows]
        return _client_check_groups(name, named, "name", *join_oracle)

    def check_device(when: str) -> dict:
        state = device_state()
        if not str(state["device"]).startswith("cuda") or \
                state["name"] != torch.cuda.get_device_name(0) or \
                min(int(state["launches"][k]) for k in PATH_KERNELS) <= 0:
            raise AssertionError(f"CLUSTER {when}: the primary's "
                                 f"/query/device reads {state}")
        _log(f"cluster primary /query/device {when}: {json.dumps(state)}")
        return state

    # --- 1. bring-up: spawn to ready, beside the data and oracles --------
    starter.join()
    if "error" in spawn:
        raise spawn["error"]
    rec = {"host_s": spawn["s"], "device_busy_ms": None, "idle_share": None,
           "traced": False, "peak_bytes": torch.cuda.max_memory_allocated(),
           "cache_hits": 0, "cache_misses": 0,
           "launches": dict.fromkeys(TRACE_NAMES, 0), "overhead_s": 0.0}
    _log(f"cluster bring_up: {json.dumps(rec)}")
    out["paths"]["cluster_bring_up"] = rec
    out["stages"]["bring_up_s"] = rec["host_s"]
    holder["client"] = client = connect_remote(cluster.primary_address,
                                               device="cuda")

    # --- 2. SELECT's data on the nodes -----------------------------
    schema = port.TableSchema.make([("k", "int64"), ("g", "int64"),
                                    ("v", "int64")])

    def publish():
        client.create("table", CLUSTER_T, recursive=True,
                      attributes={"schema": schema})
        chunks = [ColumnarChunk.from_arrays(schema, a, device="cuda")
                  for a in d["chunks"]]
        publish_table_chunks(client, client.chunk_store, CLUSTER_T,
                             chunks, schema=schema)
    stage("publish", publish)
    cids = client.get(CLUSTER_T + "/@chunk_ids")
    held = [[i for i, a in enumerate(cluster.node_addresses)
             if _node_call(a, "has_chunk", {"chunk_id": c})
             .get("exists")] for c in cids]
    if client.get(CLUSTER_T + "/@row_count") != CLUSTER_ROWS or \
            [len(h) for h in held] != [CLUSTER_RF] * CLUSTER_CHUNKS:
        raise AssertionError(f"CLUSTER: the published chunks are "
                             f"placed on {held}")
    out["stages"]["chunk_nodes"] = held

    # --- 3. GROUP BY served by the primary ------------------------
    rows = stage("select_8_cold",
                 lambda: client.select_rows(CLUSTER_QUERY),
                 primary=True)
    out["stages"]["select_8_groups"] = check_select(
        "CLUSTER SELECT_8 cold", rows)
    warm = []
    for _ in range(CLUSTER_WARM):
        t = time.perf_counter()
        check_select("CLUSTER SELECT_8 warm",
                     client.select_rows(CLUSTER_QUERY))
        warm.append(time.perf_counter() - t)
    out["stages"]["select_8_warm_s"] = warm
    _log(f"cluster SELECT_8 warm: {[round(w, 4) for w in warm]} s")

    # --- 4. the join; the primary's kernels -----------------------
    client.write_table(CLUSTER_DIM, [
        {"g": g, "name": f"name{g % CLIENT_NAMES:02d}"}
        for g in range(CLIENT_DIM_ROWS)])
    rows = stage("join", lambda: client.select_rows(CLUSTER_JOIN),
                 radix=True, primary=True)
    out["stages"]["join_groups"] = check_join("CLUSTER join", rows)
    out["stages"]["primary_device"] = check_device("after the join")

    # --- 5. node 3 down: a remote sort here, a top-k there --------
    cluster.kill_node(CLUSTER_NODES - 1)
    op = stage("run_sort", lambda: client.run_sort(
        CLUSTER_T, CLUSTER_SORTED, sort_by=["g", "k"]), radix=True)
    if op.state != "completed" or \
            op.result["rows"] != CLUSTER_ROWS:
        raise AssertionError(f"CLUSTER run_sort: {op.state} "
                             f"{op.result}")
    t_check = time.perf_counter()
    order = np.argsort(g_all.astype(np.int16), kind="stable")
    at = 0
    for cid in client.get(CLUSTER_SORTED + "/@chunk_ids"):
        chunk = client.chunk_store.read_chunk(cid, device="cuda")
        planes = chunk.to_numpy()["planes"]
        n = chunk.row_count
        for name, col in (("g", g_all), ("k", k_all),
                          ("v", v_all)):
            if not np.array_equal(planes[name][0][:n],
                                  col[order[at:at + n]]):
                raise AssertionError(f"CLUSTER run_sort: {name} is "
                                     "not in np.lexsort's order")
        at += n
        del chunk, planes
    if at != CLUSTER_ROWS or client.get(
            CLUSTER_SORTED + "/@sorted_by") != ["g", "k"]:
        raise AssertionError("CLUSTER run_sort: rows or @sorted_by "
                             "differ")
    del order
    out["stages"]["sort_check_s"] = time.perf_counter() - t_check
    rows = stage("top_limit",
                 lambda: client.select_rows(CLUSTER_TOP_QUERY),
                 primary=True)
    if [(-r["s"], r["g"]) for r in rows] != top:
        raise AssertionError("CLUSTER ORDER BY ... LIMIT differs "
                             "from numpy")

    # --- 6. node 3 back, the primary restarted --------------------
    def restart():
        # Node 3 and the primary start together; the primary's
        # journal membership waits for all three nodes.
        cluster.restart_node(CLUSTER_NODES - 1, wait=False)
        cluster.restart_primary()
    stage("restart", restart, host_only=True)
    client.close()
    holder["client"] = client = connect_remote(
        cluster.primary_address, device="cuda")
    if client.get(CLUSTER_T + "/@row_count") != CLUSTER_ROWS:
        raise AssertionError("CLUSTER: the restarted primary lost "
                             "the table's metadata")
    # The new primary's tracer warms up on a thread of its own
    # (server/daemon.py::DeviceTrace) for ≈ 10 s after it starts:
    # the stages that need no trace of the primary run first (7's
    # writes, 8), then the cold SELECT_8 (nothing reads
    # //cluster/t's chunks before it), then 7's reads.

    # --- 7. a dynamic table over RPC: the writes ------------------
    dyn_schema = port.TableSchema.make(
        [("k", "int64", "ascending"), ("g", "int64"),
         ("v", "int64")], unique_keys=True)
    client.create("table", CLUSTER_DYN, recursive=True,
                  attributes={"schema": dyn_schema,
                              "dynamic": True})
    client.mount_table(CLUSTER_DYN)
    dyn_rows = [{"k": k, "g": g, "v": v} for k, g, v in zip(
        d["dyn_k"].tolist(), d["dyn_g"].tolist(),
        d["dyn_v"].tolist())]
    commits: list = []

    def insert():
        for lo in range(0, CLUSTER_DYN_ROWS, CLUSTER_TX_ROWS):
            tx = client.start_transaction()
            client.insert_rows(CLUSTER_DYN,
                               dyn_rows[lo:lo + CLUSTER_TX_ROWS],
                               tx=tx)
            commits.append(client.commit_transaction(tx))
    stage("dyn_insert", insert, host_only=True)
    if len(commits) != CLUSTER_DYN_ROWS // CLUSTER_TX_ROWS or \
            any(b <= a for a, b in zip(commits, commits[1:])):
        raise AssertionError("CLUSTER: commit timestamps are not "
                             "strictly rising")
    del dyn_rows

    # --- 8. a command map on the nodes' exec slots ----------------
    map_schema = port.TableSchema.make([("a", "int64"),
                                        ("b", "int64")])
    client.create("table", "//cluster/map_in", recursive=True,
                  attributes={"schema": map_schema})
    publish_table_chunks(
        client, client.chunk_store, "//cluster/map_in",
        [ColumnarChunk.from_arrays(map_schema, d["map"],
                                   device="cuda")],
        schema=map_schema)
    started = sum(_node_call(a, "exec_stats", {})["started_total"]
                  for a in cluster.node_addresses)
    op = stage("map", lambda: client.run_map(
        "cat", "//cluster/map_in", "//cluster/map_out",
        rows_per_job=CLUSTER_MAP_ROWS_PER_JOB), host_only=True)
    ran = sum(_node_call(a, "exec_stats", {})["started_total"]
              for a in cluster.node_addresses) - started
    jobs = CLUSTER_MAP_ROWS // CLUSTER_MAP_ROWS_PER_JOB
    pairs = []
    for cid in client.get("//cluster/map_out/@chunk_ids"):
        chunk = client.chunk_store.read_chunk(cid, device="cpu")
        planes = chunk.to_numpy()["planes"]
        pairs.append(np.stack([planes[c][0][:chunk.row_count]
                               for c in ("a", "b")]))
    got = np.concatenate(pairs, axis=1)
    got = got[:, np.argsort(got[0], kind="stable")]
    if op.result["rows"] != CLUSTER_MAP_ROWS or ran < jobs or \
            not np.array_equal(got, np.stack([d["map"]["a"],
                                              d["map"]["b"]])):
        raise AssertionError(f"CLUSTER map: {op.result}, {ran} jobs "
                             "on the nodes, or rows differ")

    # --- 6, continued: SELECT_8 cold on the new primary -----------
    rows = stage("select_8_restarted",
                 lambda: client.select_rows(CLUSTER_QUERY),
                 radix=True, primary=True)
    out["stages"]["select_8_restarted_groups"] = check_select(
        "CLUSTER SELECT_8 after the restart", rows)
    out["stages"]["primary_device_restarted"] = check_device(
        "after the restart")

    # --- 7, continued: the dynamic table's reads ------------------
    stage("dyn_lookup", lambda: _cluster_lookups(client, d),
          primary=True)
    rows = stage("dyn_select", lambda: client.select_rows(
        f"k, g, v FROM [{CLUSTER_DYN}]"), primary=True)
    if sorted((r["k"], r["g"], r["v"]) for r in rows) != sorted(
            zip(d["dyn_k"].tolist(), d["dyn_g"].tolist(),
                d["dyn_v"].tolist())):
        raise AssertionError("CLUSTER: an acknowledged write of the "
                             "dynamic table was not read back")
    del rows
    out["stages"]["map_jobs_on_nodes"] = ran
    client.close()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    _log(f"cluster: {out['seconds']:.1f} s in all")
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
    order = _stable_argsort(all_k)

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
                        "to this path (default: chiprun_out/chip_smoke.json "
                        "beside this script)",
                        default=os.path.join(HERE, "chiprun_out",
                                             "chip_smoke.json"))
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

    # 2. build. Meanwhile a thread opens and closes an empty profiler
    # session: a process's first session spends seconds initializing the
    # tracer (8.1–11.6 s on the H100's host), which then overlap the build
    # and the kernel checks instead of the first profiled path.
    warm = threading.Thread(target=_warm_profiler, name="profiler-warm-up")
    warm.start()
    t0 = time.perf_counter()
    _build.load_all(list(TRACE_NAMES))
    _log(f"built {', '.join(TRACE_NAMES)} in "
         f"{time.perf_counter() - t0:.2f} s")
    for name in TRACE_NAMES:
        info = _build.build_info[name]
        _log(f"{name}: nvcc {info['seconds']:.2f} s")
        _log(info["log"].strip())

    # 3. kernels against their plain versions, and the argsort
    phase_s: dict = {}

    def timed(name, fn, *fn_args):
        """fn(*fn_args), its host seconds logged and recorded: the phases'
        share of chip_smoke's time limit."""
        t = time.perf_counter()
        result = fn(*fn_args)
        phase_s[name] = time.perf_counter() - t
        _log(f"phase {name}: {phase_s[name]:.1f} s")
        return result

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errors = {"hist_rank": timed("hist_rank", phase_hist_rank, hr, gen),
              **timed("radix_kernels", phase_radix_kernels, rx, gen)}
    argsort = timed("argsort", phase_argsort, rx, gen)

    # 4. the slice: the queries, then the Sort operation and MVCC reads,
    # the mesh paths, and the spill sort
    keep: dict = {"seed": args.seed}
    # SORT's and TABLET's tables and numpy oracles (≈ 60 s of host time on
    # a slow host) are made on a thread, one after the other, while the
    # slice, STRINGS and VECTOR run on the card.
    sort_ahead = _Ahead(_sort_oracle, args.seed)
    tablet_ahead = _Ahead(_tablet_ahead, args.seed, after=sort_ahead)
    t_warm = time.perf_counter()
    warm.join()
    _log(f"profiler warm-up joined after {time.perf_counter() - t_warm:.2f} s")
    paths = timed("slice", phase_slice, args.seed, hr, rx, tpch, select_rows,
                  keep)
    paths.update(timed("strings", phase_strings, args.seed, hr, rx,
                       synthetic, select_rows))
    vec = timed("vector", phase_vector, hr, rx, synthetic, vector,
                select_rows)
    paths.update(vec.pop("paths"))
    port = _port_entry_points()
    paths["sort"] = timed("sort", phase_sort, args.seed, hr, rx, port, keep,
                          sort_ahead)
    paths["tablet"] = timed("tablet", phase_tablet, args.seed, hr, rx, port,
                            tablet_ahead)
    dyntable = timed("dyntable", phase_dyntable, args.seed, hr, rx, port)
    paths.update(dyntable.pop("paths"))
    durable = timed("durable", phase_durable, args.seed, hr, rx, port)
    paths.update(durable.pop("paths"))
    queue = timed("queue", phase_queue, args.seed, hr, rx, port)
    paths.update(queue.pop("paths"))
    client = timed("client", phase_client, args.seed, hr, rx, port, True)
    paths.update(client.pop("paths"))
    front = client.pop("front")
    paths.update(front.pop("paths"))
    phase_s["front"] = front["seconds"]
    phase_s["client"] -= front["seconds"]
    _log(f"phase front: {phase_s['front']:.1f} s (inside CLIENT's "
         f"cluster; client without it {phase_s['client']:.1f} s)")
    ops = timed("ops", phase_ops, args.seed, hr, rx, port)
    paths.update(ops.pop("paths"))
    derived = timed("derived", phase_derived, args.seed, hr, rx, port)
    paths.update(derived.pop("paths"))
    cells = timed("cells", phase_cells, args.seed, hr, rx, port)
    paths.update(cells.pop("paths"))
    cluster = timed("cluster", phase_cluster, args.seed, hr, rx, port)
    paths.update(cluster.pop("paths"))
    paths.update(timed("select", phase_select, args.seed, hr, rx, tpch, port,
                       keep))
    paths.update(timed("mesh", phase_mesh, hr, rx, tpch, keep))
    keep.clear()
    with tempfile.TemporaryDirectory() as tmp:
        mesh_ranks = timed("mesh_ranks", phase_mesh_ranks, args.seed, tmp)
    paths["extsort"] = timed("extsort", phase_extsort, hr, rx, port)

    # 5. the kernels line
    times = timed("kernel_times", phase_kernel_times, hr, rx, args.seed)
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
              "durable": durable, "queue": queue, "client": client,
              "front": front,
              "ops": ops, "derived": derived, "cells": cells,
              "cluster": cluster,
              "extsort_rows": paths["extsort"]["rows_in"],
              "strings_rows": STRINGS_ROWS, "vector_rows": VECTOR_ROWS,
              "vector": vec, "mesh_ranks": mesh_ranks,
              "seed": args.seed, "argsort": argsort,
              "phase_seconds": phase_s,
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
