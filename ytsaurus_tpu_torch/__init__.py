"""ytsaurus_tpu_torch — the QL query engine on PyTorch and CUDA.

Port of the JAX package beside it to PyTorch on an NVIDIA H100.
It mirrors the JAX package's layout and module names; each module's
docstring names the file it ports. It imports torch and numpy only:
nothing of JAX and nothing of the JAX package, whose `__init__` would load
jax and switch the whole process to 64-bit mode.

It runs QL queries over columnar chunks on one device:
  - query front end (lexer, parser, builder → typed IR), copied;
  - query/planner.py — the cost-based order of multi-way joins;
  - chunks/columnar.py — torch planes on an explicit device, chunk
    concatenation and the column statistics the planner reads;
  - ops/radix.py + csrc/radix_upsweep.cu, csrc/radix_onesweep.cu — the
    stable radix argsort, one-sweep passes written for Hopper;
  - ops/hist_rank.py + csrc/hist_rank.cu — the Pallas counting kernel's
    interface, sharing its tile ranking (csrc/tile_rank.cuh);
  - ops/segments.py — the segment primitives and scans;
  - bench/onesweep_variants.py — design variants of the one-sweep pass,
    timed on the card;
  - query/engine — expression binding, plan lowering, joins, window
    functions, the evaluator (with WITH TOTALS);
  - models/tpch.py — lineitem and orders, Q1, Q3, the Q18 aggregation
    and the window workload;
  - query/coordinator.py — selects over many chunks
    (`coordinate_and_execute`);
  - parallel/ — the mesh over torch.distributed, the stitched paths, the
    whole-plan rung, the degradation ladder (`coordinate_distributed`)
    and the mesh observatory;
  - the storage path of a sorted dynamic table: tablet/tablet.py
    (`Tablet`: writes, flush, compaction, snapshot reads, lookups),
    tablet/dynamic_store.py, tablet/transactions.py (2PC over tablets),
    tablet/timestamp.py, chunks/encoding.py (the reference's wire format,
    byte for byte), chunks/store.py (`FsChunkStore`, `ChunkCache`),
    chunks/compression.py, chunks/hunks.py, yson/, and native/ (the host
    codec library, built with g++ at first use);
  - the rest of the storage layer: chunks/erasure.py (Reed–Solomon and
    LRC over GF(2^8); `FsChunkStore` stores parts and repairs them on
    read), chunks/replicated.py (`ReplicatedChunkStore`), `any` columns,
    tablet/ordered.py (`OrderedTablet`, queue tables), formats.py (yson,
    json, dsv, schemaful_dsv, skiff) and arrow.py;
  - client.py — `connect(root, device=)`: a local-mode cluster in one
    process over all of the above (the Cypress master of cypress/, the
    serving gateway of query/serving.py, EXPLAIN ANALYZE of
    query/profile.py, the operation scheduler of operations/), with
    query/{pruning,accounting,workload}.py;
  - the operations plane: operations/reduce_op.py, job_environment.py,
    the reduce, map-reduce and vanilla controllers of scheduler.py and
    command jobs (jobs.py::run_command_job), with revival after a crash;
  - replication and the derived tables: tablet/replication.py,
    tablet/chaos.py, tablet/secondary_index.py, query/views.py,
    server/queue_agent.py, server/view_daemon.py and the client's
    backups;
  - the front doors: driver.py (the command registry), rpc/ (packets,
    `RpcServer`, the retrying, hedging and failover channels),
    server/services.py (`DriverService` with wire transactions),
    server/http_proxy.py and server/tcp_proxy.py, server/query_tracker.py
    with ecosystem/sql.py (the ClickHouse dialect);
  - bench/chip_phases.py — chip_smoke's storage, client, operations,
    derived-table and front-door phases alone on the card;
  - config.py, utils/ — the knobs, failpoints, trace spans, sensors,
    invariant checks and varints those read.

Every entry point takes `device=`, which defaults to "cuda" and raises
when no card is present (see device.py).
"""

__version__ = "0.1.0"

from ytsaurus_tpu_torch.errors import YtError, YtResponseError  # noqa: F401
from ytsaurus_tpu_torch.schema import (  # noqa: F401
    ColumnSchema,
    EValueType,
    SortOrder,
    TableSchema,
)
