"""Operations: the scheduler and the sort, merge, erase, map, reduce,
map-reduce and vanilla controllers.

Own copy of the JAX package's `operations/scheduler.py` (ref
server/scheduler/scheduler.cpp StartOperation, the controller agent's
prepare / materialize / commit lifecycle, operation records under
//sys/operations/<id>):

  OperationScheduler   start (sync or on its own thread), get, list and
                       abort operations; their records, the per-stripe
                       @snapshot and `revive_operations`.
  _sort_controller     the device sort (operations/sort_op.py::
                       sort_chunks over the radix kernels) on the
                       cluster's device, or ops/bigsort.py::external_sort
                       when twice the input's weight exceeds
                       YT_TPU_HBM_BUDGET (8 GiB by default).
  _merge_controller    unordered concatenation or a sorted merge.
  _erase_controller    empties a table.
  _map_controller      a Python `mapper` or a shell `command` over
                       sliced stripes on the shared JobManager
                       (operations/jobs.py); command jobs run in their
                       own process, get speculative twins and split
                       when they straggle.
  _reduce_controller   sorted reduce: one device sort of the inputs
                       (sort_chunks), jobs cut at the reduce key's
                       change points (found on the device), a Python
                       `reducer` per key group or a command over the
                       sorted rows.
  _map_reduce_controller  map jobs hash-route their output by reduce
                       key (a CRC32 stable across processes), each
                       partition is sorted on the device, then reduced.
  _vanilla_controller  gangs of tasks × jobs with no input; any failure
                       restarts the whole gang.

A controller that fails records `op.error` and the state `failed`; a
failed device sort never turns into a completed operation: only ragged
rows that the columnar planes refuse fall back to a host sort, never a
kernel that fails to build or launch. Command operations whose input has
a stable chunk list record a per-job @snapshot, so
`revive_operations` resumes them after a crash. Command maps dispatch to
the exec nodes of a multi-process cluster when it has any
(`client.exec_node_addresses()`), and `_remote_copy_controller` pulls a
table from another cluster through `remote_client.connect_remote`, onto
this client's device.
"""

from __future__ import annotations

import threading
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.utils import failpoints
from ytsaurus_tpu_torch.utils.tracing import (
    child_span,
    current_trace,
    start_query_span,
)

# Crash-once at `scheduler.publish` simulates a controller dying between
# the last snapshot record and the output publish — the revival window
# the snapshot subsystem exists for (tests/test_revival.py).
_FP_SNAPSHOT_RECORD = failpoints.register_site("scheduler.snapshot_record")
_FP_PUBLISH = failpoints.register_site("scheduler.publish")


@dataclass
class Operation:
    id: str
    type: str                      # map | merge | sort | erase
    spec: dict
    state: str = "pending"         # pending|running|completed|failed|aborted
    error: Optional[dict] = None
    result: dict = field(default_factory=dict)
    progress: dict = field(default_factory=dict)   # jobs total/completed


class OperationScheduler:
    def __init__(self, client, slots: int = 4):
        from ytsaurus_tpu_torch.operations.jobs import JobManager
        self.client = client
        self._operations: dict[str, Operation] = {}
        self._lock = threading.Lock()
        self._pool_cache: dict[str, tuple[float, dict]] = {}
        self.job_manager = JobManager(slots=slots,
                                      pool_config=self._pool_config)

    _POOL_CONFIG_TTL = 5.0

    def _pool_config(self, name: str) -> dict:
        """Pool definitions from Cypress (//sys/pools/<name>/@...), the
        reference's pool-tree objects (scheduler_pool_server).  Cached
        with a short TTL: this runs per scheduling decision under the
        JobManager lock, and against a remote cluster each lookup is an
        RPC."""
        import time as _time
        cached = self._pool_cache.get(name)
        now = _time.monotonic()
        if cached is not None and now - cached[0] < self._POOL_CONFIG_TTL:
            return cached[1]
        path = f"//sys/pools/{name}"
        out: dict = {}
        try:
            if self.client.exists(path):
                for key in ("weight", "min_share_ratio",
                            "max_running_jobs"):
                    if self.client.exists(f"{path}/@{key}"):
                        out[key] = self.client.get(f"{path}/@{key}")
        except Exception:     # noqa: BLE001 — config lookup must not fail jobs
            pass
        self._pool_cache[name] = (now, out)
        return out

    # -- public API ------------------------------------------------------------

    def start_operation(self, op_type: str, spec: dict,
                        sync: bool = True) -> Operation:
        op = Operation(id=uuid.uuid4().hex, type=op_type, spec=dict(spec))
        with self._lock:
            self._operations[op.id] = op
        self._record(op)
        if sync:
            self._run(op)
        else:
            thread = threading.Thread(target=self._run, args=(op,),
                                      daemon=True)
            thread.start()
        return op

    def get_operation(self, op_id: str) -> Operation:
        op = self._operations.get(op_id)
        if op is None:
            raise YtError(f"No such operation {op_id}",
                          code=EErrorCode.NoSuchOperation)
        return op

    def list_operations(self) -> list[Operation]:
        return list(self._operations.values())

    def abort_operation(self, op_id: str) -> Operation:
        """Abort a running operation: kill its jobs, mark it aborted (ref
        scheduler.cpp AbortOperation).  The aborted state is terminal —
        the controller thread must not overwrite it with completed."""
        op = self.get_operation(op_id)
        with self._lock:
            if op.state in ("completed", "failed", "aborted"):
                return op
            op.state = "aborted"
            op.error = YtError("operation aborted",
                               code=EErrorCode.Canceled).to_dict()
        self.job_manager.abort_operation(op_id)
        self._record(op)
        return op

    def revive_operations(self) -> list[Operation]:
        """Re-run operations a dead controller left pending/running (ref
        revival from snapshots, snapshot_downloader.cpp).  Command-job map
        operations resume from their @snapshot (completed stripes skipped);
        other types re-run deterministically from the recorded spec.
        Python-callable mappers cannot revive — the callable is not
        serializable — and fail with the normal spec error."""
        revived = []
        if not self.client.exists("//sys/operations"):
            return revived
        for op_id in self.client.list("//sys/operations"):
            doc = f"//sys/operations/{op_id}"
            with self._lock:
                if op_id in self._operations:
                    continue     # live in THIS controller; not orphaned
            try:
                if self.client.get(doc + "/@state") not in (
                        "pending", "running"):
                    continue
                op = Operation(
                    id=op_id,
                    type=self.client.get(doc + "/@operation_type"),
                    spec=dict(self.client.get(doc + "/@spec")))
            except YtError:
                continue
            with self._lock:
                self._operations[op.id] = op
            try:
                self._run(op)
            except YtError:
                pass        # state recorded on the op; caller inspects
            revived.append(op)
        return revived

    # -- lifecycle -------------------------------------------------------------

    def _run(self, op: Operation) -> None:
        import time as _time

        # State transitions race with abort_operation (async ops): every
        # transition takes the lock, and aborted is terminal.
        with self._lock:
            if op.state == "aborted":
                return                      # aborted before the thread ran
            op.state = "running"
        self._record(op)
        t0 = _time.monotonic()
        try:
            controller = _CONTROLLERS.get(op.type)
            if controller is None:
                raise YtError(f"Unknown operation type {op.type!r}",
                              code=EErrorCode.OperationFailed)
            # Operation ROOT span (the operations-plane trace entry):
            # controller phases and per-job spans nest under it.
            with start_query_span("operation.run", type=op.type,
                                  operation_id=op.id):
                result = controller(self.client, op.spec, op=op,
                                    job_manager=self.job_manager)
            with self._lock:
                if op.state != "aborted":
                    op.result = result or {}
                    op.state = "completed"
        except YtError as e:
            with self._lock:
                if op.state != "aborted":
                    op.state = "failed"
                    op.error = e.to_dict()
        except Exception as e:                      # noqa: BLE001
            with self._lock:
                if op.state != "aborted":
                    op.state = "failed"
                    op.error = YtError(
                        f"Operation crashed: {e}",
                        code=EErrorCode.OperationFailed,
                        attributes={
                            "traceback":
                                traceback.format_exc()}).to_dict()
        # Per-tenant accounting: a terminal operation folds
        # its wall seconds + completed-job count under its spec pool —
        # the operations plane shares the usage ledger with the query
        # plane, so `yt top --by pool` sees both.  Failed/aborted runs
        # fold too: the slots they held were consumed either way.
        try:
            from ytsaurus_tpu_torch.query.accounting import get_accountant
            get_accountant().observe_operation(
                op.spec.get("pool", "default"), op.spec.get("user"),
                wall_seconds=_time.monotonic() - t0,
                jobs=int(op.progress.get("completed", 0) or 0))
        except Exception:   # noqa: BLE001 — accounting must never fail
            pass            # an operation's state transition
        self._record(op)
        if op.state == "failed" and op.spec.get("raise_on_failure", True):
            raise YtError.from_dict(op.error)

    def _record(self, op: Operation) -> None:
        # Each client.set is one fsync'd WAL mutation; write immutable fields
        # once at registration and only the state transition afterwards.
        path = f"//sys/operations/{op.id}"
        client = self.client
        if not client.exists(path):
            client.create("document", path, recursive=True,
                          ignore_existing=True)
            client.set(path + "/@operation_type", op.type)
            client.set(path + "/@spec", _clean_spec(op.spec))
        client.set(path + "/@state", op.state)
        if op.error is not None:
            client.set(path + "/@error", op.error)


def _clean_spec(spec: dict) -> dict:
    """Strip Python callables (any nesting depth) before persisting the
    spec to Cypress — vanilla specs nest them under tasks.<name>."""
    out = {}
    for k, v in spec.items():
        if callable(v):
            continue
        out[k] = _clean_spec(v) if isinstance(v, dict) else v
    return out


class _Snapshot:
    """Operation progress snapshot (ref controller snapshots via
    fork+Phoenix, controller_agent/snapshot_builder.cpp:177 — redesigned:
    no fork; per-stripe outputs persist as ordinary chunks and the
    completed-set lives under //sys/operations/<id>/@snapshot, so revival
    is a plan-match + skip, not a process-image restore)."""

    def __init__(self, client, op_id: str, plan: dict):
        self.client = client
        self.doc = f"//sys/operations/{op_id}"
        self.path = self.doc + "/@snapshot"
        self.plan = plan
        self._lock = threading.Lock()

    def load(self) -> "dict[int, str]":
        """Completed stripe index → output chunk id, iff the recorded plan
        matches the deterministic re-plan (inputs unchanged)."""
        if not self.client.exists(self.doc) or \
                not self.client.exists(self.path):
            return {}
        snap = self.client.get(self.path)
        if snap.get("plan") != self.plan:
            return {}
        return {int(k): v for k, v in (snap.get("completed") or {}).items()}

    def record(self, index: int, rows: list) -> None:
        from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
        from ytsaurus_tpu_torch.client import infer_schema
        _FP_SNAPSHOT_RECORD.hit()
        chunk_id = ""
        if rows:
            chunk = ColumnarChunk.from_rows(
                infer_schema(rows), rows,
                device=self.client.cluster.device)
            chunk_id = self.client.cluster.chunk_store.write_chunk(chunk)
        with self._lock:
            snap = self.client.get(self.path) \
                if self.client.exists(self.path) else {}
            if snap.get("plan") != self.plan:
                snap = {"plan": self.plan, "completed": {}}
            snap.setdefault("completed", {})[str(index)] = chunk_id
            self.client.set(self.path, snap)

    def read_output(self, chunk_id: str) -> list:
        if not chunk_id:
            return []
        return self.client.cluster.chunk_store.read_chunk(
            chunk_id, device=self.client.cluster.device).to_rows()

    def clear(self) -> None:
        """Drop the snapshot + its chunks once the output is published.
        Snapshot state is system-owned (like the records themselves)."""
        from ytsaurus_tpu_torch.cypress.security import (
            ROOT_USER,
            authenticated_user,
        )
        # Serialize against record(): a straggler job thread (speculative
        # or respawned after an injected worker death) can still be
        # folding its stripe into the live snapshot dict while the
        # controller publishes — iterating it unlocked crashed the
        # operation with "dictionary changed size during iteration".
        with self._lock:
            if not self.client.exists(self.path):
                return
            snap = self.client.get(self.path)
            chunk_ids = list((snap.get("completed") or {}).values())
        for chunk_id in chunk_ids:
            if chunk_id:
                try:
                    self.client.cluster.chunk_store.remove_chunk(chunk_id)
                except YtError:
                    pass
        with authenticated_user(ROOT_USER):
            self.client.remove(self.path, force=True)


# -- controllers ---------------------------------------------------------------


def _sort_controller(client, spec: dict, op=None, job_manager=None) -> dict:
    """Ref: sort_controller.cpp — read input chunks, device sort (or mesh
    shuffle when a mesh is attached), write output.  Inputs whose device
    footprint exceeds the HBM budget go through the external sort
    (ops/bigsort: range partition + host spill + per-range sorts — the
    partition-tree analog of sort_controller.cpp:459), producing one
    sorted output chunk per range instead of one giant resident table."""
    import os as _os

    from ytsaurus_tpu_torch.operations.chunk_pools import chunk_data_weight
    from ytsaurus_tpu_torch.operations.sort_op import sort_chunks

    input_path = _one(spec, "input_table_path")
    output_path = _one(spec, "output_table_path")
    sort_by = spec["sort_by"]
    if isinstance(sort_by, str):
        sort_by = [sort_by]
    descending = spec.get("descending", False)
    chunks = client._read_table_chunks(input_path)
    if not chunks:
        client._write_table_chunks(output_path, [], sorted_by=sort_by)
        return {"rows": 0}
    budget = int(spec.get("hbm_budget") or
                 _os.environ.get("YT_TPU_HBM_BUDGET", 8 << 30))
    total_weight = sum(chunk_data_weight(c) for c in chunks)
    numeric_only = all(
        col.dictionary is None and col.host_values is None
        for c in chunks for col in c.columns.values())
    if total_weight * 2 > budget and numeric_only:
        from ytsaurus_tpu_torch.ops.bigsort import SpillStats, external_sort
        stats = SpillStats()
        with child_span("sort.external", chunks=len(chunks),
                        bytes=total_weight):
            outs = list(external_sort(chunks, sort_by,
                                      budget_bytes=budget,
                                      descending=descending, stats=stats,
                                      device=client.device))
        client._write_table_chunks(
            output_path, outs, sorted_by=sort_by,
            schema=outs[0].schema if outs else None)
        return {"rows": sum(c.row_count for c in outs),
                "spill_ranges": stats.ranges,
                "resplits": stats.resplits}
    with child_span("sort.device_sort", chunks=len(chunks),
                    bytes=total_weight):
        out = sort_chunks(chunks, sort_by, descending=descending,
                          device=client.device)
    client._write_table_chunks(output_path, [out], sorted_by=sort_by,
                               schema=out.schema)
    return {"rows": out.row_count}


def _merge_controller(client, spec: dict, op=None, job_manager=None) -> dict:
    """Ref: ordered/sorted merge (ordered_controller.cpp,
    sorted_controller.cpp)."""
    from ytsaurus_tpu_torch.chunks.columnar import concat_chunks
    from ytsaurus_tpu_torch.operations.sort_op import sort_chunks

    input_paths = spec["input_table_paths"]
    output_path = _one(spec, "output_table_path")
    mode = spec.get("mode", "unordered")
    chunks = []
    for path in input_paths:
        chunks.extend(client._read_table_chunks(path))
    if not chunks:
        client._write_table_chunks(output_path, [])
        return {"rows": 0}
    chunks = _align_schemas(chunks)
    if mode == "sorted":
        key_names = spec.get("merge_by") or \
            chunks[0].schema.key_column_names
        if not key_names:
            raise YtError("sorted merge requires merge_by or sorted input")
        out = sort_chunks(chunks, key_names, device=client.device)
        client._write_table_chunks(output_path, [out], sorted_by=key_names,
                                   schema=out.schema)
    else:
        out = concat_chunks(chunks) if len(chunks) > 1 else chunks[0]
        client._write_table_chunks(output_path, [out], schema=out.schema)
    return {"rows": out.row_count}


def _map_controller(client, spec: dict, op=None, job_manager=None) -> dict:
    """Ref: unordered_controller.cpp + the user-process map job
    (job_proxy/user_job.cpp).

    Two user-code shapes:
      spec["mapper"]  — a Python callable rows→rows, run in-slot;
      spec["command"] — a shell command; rows stream through a job-proxy
                        subprocess on stdin/stdout in spec["format"]
                        (default json lines), stderr tail kept on errors.
    Input slices into stripes via the chunk pool, jobs run concurrently
    on the shared JobManager under spec["pool"] fair share; stragglers
    get speculative twins and are split in halves (command jobs). Command
    jobs dispatch to the exec nodes of the data-node daemons
    (server/exec_service.py) whenever the cluster has any, and run in
    this process's job slots otherwise."""
    from ytsaurus_tpu_torch.formats import dumps_rows, loads_rows
    from ytsaurus_tpu_torch.operations.chunk_pools import build_stripes, split_stripe
    from ytsaurus_tpu_torch.operations.jobs import (
        Job,
        run_command_job,
        run_remote_command_job,
    )

    mapper: Optional[Callable] = spec.get("mapper")
    command: Optional[str] = spec.get("command")
    if (mapper is None) == (command is None):
        raise YtError("map spec requires exactly one of mapper/command")
    input_path = _one(spec, "input_table_path")
    output_path = _one(spec, "output_table_path")
    fmt = spec.get("format", "json")
    pool = spec.get("pool", "default")
    chunks = client._read_table_chunks(input_path)

    def attr(name, default):
        try:
            return client.get(f"{input_path}/@{name}")
        except YtError:
            return default

    input_chunk_ids = list(attr("chunk_ids", []))
    # Snapshots are plan-keyed by the input chunk list; dynamic tables
    # have no stable chunk list, so their operations restart from scratch
    # on revival rather than risk stale per-stripe outputs.  Remote thin
    # clients have no direct chunk store either: local controllers only.
    snapshot_ok = not attr("dynamic", False) and hasattr(client, "cluster")
    rows_per_job = spec.get("rows_per_job")
    if rows_per_job is None and spec.get("job_count"):
        total = sum(c.row_count for c in chunks)
        rows_per_job = max(-(-total // max(int(spec["job_count"]), 1)), 1)
    stripes = build_stripes(
        chunks, ordered=bool(spec.get("ordered", False)),
        rows_per_job=rows_per_job or 4_000_000,
        max_job_count=spec.get("max_job_count"))
    if not stripes:
        client.write_table(output_path, [],
                           schema=spec.get("output_schema"))
        return {"rows": 0, "jobs": 0}

    op_id = op.id if op is not None else uuid.uuid4().hex

    # Distributed exec plane (ref server/node/exec_node/): command jobs
    # dispatch to job slots on data-node daemons whenever the cluster
    # has any, reading their input chunks LOCAL-FIRST on the node; the
    # in-process path remains for pure local mode and Python mappers.
    exec_nodes: dict = {}
    if command is not None and spec.get("remote_jobs", True):
        try:
            exec_nodes = dict(client.exec_node_addresses())
        except Exception:   # noqa: BLE001 — directory is advisory
            exec_nodes = {}
    chunk_to_id: dict[int, str] = {}
    if exec_nodes and len(input_chunk_ids) == len(chunks):
        chunk_to_id = {id(c): cid for c, cid in
                       zip(chunks, input_chunk_ids)}

    def make_run(stripe):
        if mapper is not None:
            def run_py(job):
                return list(mapper(stripe.materialize().to_rows()))
            return run_py, False

        if exec_nodes:
            def run_remote(job):
                from ytsaurus_tpu_torch.server.remote_store import placement_rank
                addrs = list(dict(exec_nodes).values())
                by_id = all(id(c) in chunk_to_id
                            for c, _, _ in stripe.slices)
                from ytsaurus_tpu_torch.operations.job_environment import (
                    limits_from_spec,
                )
                body = {"command": command, "format": fmt,
                        "op_id": op_id, "job_id": job.id,
                        "time_limit": spec.get("job_time_limit"),
                        "limits": limits_from_spec(spec),
                        "env": spec.get("environment") or {}}
                blob = None
                if by_id:
                    # Node-side materialization: rank by the first
                    # slice's chunk placement so a replica holder runs
                    # the job (local read); rotate within the replica
                    # set by index for spread, and past it on retries
                    # (node-death revival).
                    first = chunk_to_id[id(stripe.slices[0][0])]
                    ranked = placement_rank(first, addrs)
                    body["slices"] = [
                        {"chunk_id": chunk_to_id[id(c)],
                         "start": s, "end": e}
                        for c, s, e in stripe.slices]
                    body["peers"] = addrs
                    spread = min(2, len(ranked))
                    offset = (job.index + job.attempt) % spread \
                        if job.attempt == 0 else \
                        (job.index + job.attempt) % len(ranked)
                    order = ranked[offset:] + ranked[:offset]
                else:
                    # No stable chunk ids (e.g. dynamic input): ship the
                    # formatted rows with the spec.
                    blob = dumps_rows(stripe.materialize().to_rows(),
                                      fmt)
                    offset = (job.index + job.attempt) % len(addrs)
                    order = addrs[offset:] + addrs[:offset]
                time_limit = spec.get("job_time_limit")
                poll_timeout = time_limit + 60 if time_limit else None
                last: "YtError | None" = None
                for addr in order:
                    try:
                        out = run_remote_command_job(
                            job, addr, dict(body), input_blob=blob,
                            timeout=poll_timeout)
                        return loads_rows(out, fmt)
                    except YtError as err:
                        if err.code in (EErrorCode.TransportError,
                                        EErrorCode.PeerUnavailable,
                                        EErrorCode.RpcTimeout,
                                        EErrorCode.NoSuchOperation):
                            # Node died or restarted mid-job: revive the
                            # job on the next node.
                            last = err
                            continue
                        raise
                raise last or YtError("no exec node accepted the job",
                                      code=EErrorCode.PeerUnavailable)
            return run_remote, True

        def run_cmd(job):
            from ytsaurus_tpu_torch.operations.job_environment import (
                limits_from_spec,
            )
            blob = dumps_rows(stripe.materialize().to_rows(), fmt)
            out = run_command_job(job, command, blob,
                                  timeout=spec.get("job_time_limit"),
                                  limits=limits_from_spec(spec))
            return loads_rows(out, fmt)
        return run_cmd, True

    def make_splitter(stripe):
        """Straggler split (ref job_splitter.h): halve the stripe, same
        command, children settle the parent (command jobs only)."""
        def split(parent):
            halves = split_stripe(stripe)
            if len(halves) < 2:
                return []
            children = []
            for h, half in enumerate(halves):
                run, _ = make_run(half)
                children.append(Job(
                    op_id=op_id, index=parent.index, run=run, pool=pool,
                    preemptible=True, splitter=make_splitter(half)))
            return children
        return split

    # Controller snapshot (ref fork+Phoenix operation snapshots,
    # snapshot_builder.cpp): per-stripe outputs persist as chunks under
    # @snapshot so a revived operation skips completed work.  Valid only
    # while the deterministic stripe plan matches (input chunks + split).
    outputs, revived = _run_user_jobs(
        client, op, job_manager, spec, stripes, make_run,
        plan={"input_chunk_ids": input_chunk_ids,
              "stripe_count": len(stripes)},
        is_command=command is not None and snapshot_ok,
        make_splitter=make_splitter if command is not None else None,
        publish=lambda outs: client.write_table(
            output_path, [row for part in outs for row in part],
            schema=spec.get("output_schema")))
    return {"rows": sum(len(part) for part in outputs),
            "jobs": len(stripes) - revived, "revived_jobs": revived}


def _erase_controller(client, spec: dict, op=None, job_manager=None) -> dict:
    path = _one(spec, "table_path")
    client._write_table_chunks(path, [])
    return {"rows": 0}


def _spec_keys(spec: dict, name: str, default=None) -> list[str]:
    value = spec.get(name)
    if value is None:           # absent OR explicitly None → default
        value = default
    if value is None:
        raise YtError(f"Operation spec requires {name!r}")
    return [value] if isinstance(value, str) else list(value)


def _reduce_keys(spec: dict) -> "tuple[list[str], list[str]]":
    """(reduce_by, sort_by) with sort_by defaulting to reduce_by and
    required to extend it (ref reduce sort_by semantics)."""
    reduce_by = _spec_keys(spec, "reduce_by")
    sort_by = _spec_keys(spec, "sort_by", default=reduce_by)
    if sort_by[: len(reduce_by)] != reduce_by:
        raise YtError(f"sort_by {sort_by} must start with reduce_by "
                      f"{reduce_by}", code=EErrorCode.QueryTypeError)
    return reduce_by, sort_by


def _run_user_jobs(client, op, job_manager, spec, work_items, make_runner,
                   plan: dict, is_command: bool,
                   make_splitter=None,
                   publish=None) -> "tuple[list, int]":
    """Shared fan-out for the map/reduce/map_reduce user-job phases:
    one job per work item on the JobManager, with command-job snapshot
    revival (_Snapshot, plan-keyed) and optional straggler splitting.

    make_runner(item) -> (run, preemptible);
    make_splitter(item) -> Job.splitter (command jobs only);
    publish(outputs) runs BEFORE snapshot cleanup so a crash between
    output write and snapshot removal stays revivable.
    Returns (per-item outputs in item order, revived_count)."""
    _raise_if_aborted(op)      # an abort during an earlier phase stops here
    op_id = op.id if op is not None else uuid.uuid4().hex
    from ytsaurus_tpu_torch.operations.jobs import Job

    snapshot_ok = is_command and hasattr(client, "cluster")
    snap = _Snapshot(client, op_id, plan=plan) if snapshot_ok else None
    completed = snap.load() if snap is not None else {}
    pool = spec.get("pool", "default")
    total = len(work_items)
    if op is not None:
        op.progress = {"total": total, "completed": len(completed)}

    def on_done(job) -> None:
        if job.state != "completed":
            return
        if op is not None:
            op.progress["completed"] = op.progress.get("completed", 0) + 1
        if snap is not None:
            snap.record(job.index, job.result or [])

    # Per-job failure budget (ref max_failed_job_count): transient
    # failures requeue the job until the budget runs out.
    max_failures = max(int(spec.get("max_failed_job_count", 1)), 1)
    # Job runners execute on JobManager worker threads: under a sampled
    # trace each gets an EXPLICIT contextvars capture so its span links
    # operation → phase → job; untraced operations skip the wrap.
    trace = current_trace()
    traced = trace is not None and trace.sampled
    jobs = []
    phase_span = child_span("operation.phase", jobs=total,
                            revived=len(completed))
    with phase_span:
        for i, item in enumerate(work_items):
            if i in completed:
                continue
            run, preemptible = make_runner(item)
            if traced:
                run = _traced_job_run(run, i)
            jobs.append(Job(op_id=op_id, index=i, run=run, pool=pool,
                            preemptible=preemptible, on_done=on_done,
                            max_failures=max_failures,
                            splitter=make_splitter(item)
                            if make_splitter is not None else None))
        job_manager.submit(jobs)
        try:
            job_manager.wait(jobs)
        except YtError:
            job_manager.abort_operation(op_id)
            raise
        finally:
            job_manager.finish_operation(op_id)
    # An abort landing during the wait settles its jobs as 'aborted'
    # (empty results) without raising; publishing would then overwrite
    # the destination with partial rows and snap.clear() would destroy
    # the revival snapshot.  Stop BEFORE either.
    if any(job.state == "aborted" for job in jobs):
        raise YtError("operation aborted", code=EErrorCode.Canceled)
    _raise_if_aborted(op)
    by_index = {job.index: (job.result or []) for job in jobs}
    outputs = []
    for i in range(total):
        if i in by_index:
            outputs.append(by_index[i])
        else:
            outputs.append(snap.read_output(completed[i]))
    # crash-once HERE = controller death after every stripe recorded but
    # before the output exists: revival must replay purely from the
    # snapshot.  (The site sits before publish on purpose — after
    # publish the operation is observably complete.)
    _FP_PUBLISH.hit()
    if publish is not None:
        publish(outputs)
    if snap is not None:
        snap.clear()
    return outputs, len(completed)


def _traced_job_run(run, index: int):
    """Per-job span wrapper: captures the submitting thread's trace
    context EXPLICITLY (worker threads have empty contextvars) and
    re-parents each invocation under it.  A fresh child per call keeps
    speculative/requeued copies of one job distinguishable — and avoids
    contextvars.Context.run's no-concurrent-reentry restriction."""
    parent = current_trace()

    def wrapped(job):
        span = parent.create_child("operation.job")
        span.add_tag("index", index)
        with span:
            return run(job)

    return wrapped


def _raise_if_aborted(op) -> None:
    """Abort barrier between controller phases: a multi-phase controller
    (map_reduce) must not start its next phase — or publish — after the
    operation was aborted."""
    if op is not None and op.state == "aborted":
        raise YtError("operation aborted", code=EErrorCode.Canceled)


def _make_reduce_runner(reducer, command, reduce_by, fmt, spec):
    """Runner factory over a LAZY key-sorted row source (rows_fn runs on
    the job slot, not the controller thread).  Python reducers get
    yt.wrapper-style (key_dict, group_rows) per group; command reducers
    stream the sorted rows through job-proxy pipes (contiguous key groups
    on stdin — the classic streaming-reduce contract)."""
    from ytsaurus_tpu_torch.formats import dumps_rows, loads_rows
    from ytsaurus_tpu_torch.operations.jobs import run_command_job
    from ytsaurus_tpu_torch.operations.reduce_op import iter_groups

    def make(rows_fn):
        if reducer is not None:
            def run_py(job):
                out: list[dict] = []
                for key, group in iter_groups(rows_fn(), reduce_by):
                    out.extend(reducer(key, group))
                return out
            return run_py, False

        def run_cmd(job):
            from ytsaurus_tpu_torch.operations.job_environment import (
                limits_from_spec,
            )
            blob = dumps_rows(rows_fn(), fmt)
            out = run_command_job(job, command, blob,
                                  timeout=spec.get("job_time_limit"),
                                  limits=limits_from_spec(spec))
            return loads_rows(out, fmt)
        return run_cmd, True
    return make


def _sort_rows_for_reduce(rows: list, sort_by: list, device) -> list:
    """Sort intermediate rows by the reduce sort key.  A device sort on
    `device` when the rows are schema-uniform (the partition_sort_job
    analog); a host sort only for ragged user-job output that the
    columnar planes reject (`infer_schema` / `from_rows` raise YtError,
    TypeError, ValueError or OverflowError) — type-ranked so mixed-type columns still admit a total
    order.  The device sort stays outside the fallback: a kernel that
    fails to build or launch fails the job."""
    if not rows:
        return rows
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.client import infer_schema
    from ytsaurus_tpu_torch.operations.sort_op import sort_chunk
    try:
        chunk = ColumnarChunk.from_rows(infer_schema(rows), rows,
                                        device=device)
    except (YtError, TypeError, ValueError, OverflowError):
        return _host_sort_rows(rows, sort_by)
    return sort_chunk(chunk, sort_by, device=device).to_rows()


def _host_sort_rows(rows: list, sort_by: list) -> list:
    """Stable host sort of ragged rows: None first, then numbers, bytes,
    str, and anything else by repr."""
    def key(row):
        out = []
        for k in sort_by:
            v = row.get(k)
            if v is None:
                out.append((0, 0))
            elif isinstance(v, (bool, int, float)):
                out.append((1, v))
            elif isinstance(v, bytes):
                out.append((2, v))
            elif isinstance(v, str):
                out.append((3, v))
            else:
                out.append((4, repr(v)))
        return tuple(out)
    return sorted(rows, key=key)


def _reduce_controller(client, spec: dict, op=None, job_manager=None) -> dict:
    """Sorted Reduce (ref sorted_controller.cpp:1451
    CreateReduceController).

    The reference merges sorted chunk readers and slices jobs at key
    boundaries (the key guarantee).  Here the merge of already-sorted
    inputs is one device lexsort over the concatenated columnar planes,
    and stripes cut only where the reduce key changes — so every key
    group lands in exactly one job."""
    from ytsaurus_tpu_torch.operations.reduce_op import (
        chunk_key_change_points,
        ranges_from_change_points,
        validate_sorted_input,
    )
    from ytsaurus_tpu_torch.operations.sort_op import sort_chunks

    reducer = spec.get("reducer")
    command = spec.get("command")
    if (reducer is None) == (command is None):
        raise YtError("reduce spec requires exactly one of reducer/command")
    reduce_by, sort_by = _reduce_keys(spec)
    input_paths = spec.get("input_table_paths") or \
        [_one(spec, "input_table_path")]
    output_path = _one(spec, "output_table_path")
    fmt = spec.get("format", "json")

    chunks = []
    input_chunk_ids: list[str] = []
    plan_stable = True          # chunk ids readable → snapshot plan keyed
    for path in input_paths:
        validate_sorted_input(client, path, reduce_by)
        chunks.extend(client._read_table_chunks(path))
        try:
            input_chunk_ids.extend(client.get(path + "/@chunk_ids") or [])
        except YtError:
            plan_stable = False
    chunks = [c for c in chunks if c.row_count > 0]
    if not chunks:
        client.write_table(output_path, [],
                           schema=spec.get("output_schema"))
        return {"rows": 0, "jobs": 0}
    merged = sort_chunks(_align_schemas(chunks), sort_by,
                         device=client.device)
    n = merged.row_count
    rows_per_job = spec.get("rows_per_job") or 4_000_000
    if spec.get("job_count"):
        rows_per_job = max(-(-n // max(int(spec["job_count"]), 1)), 1)
    # The key change points on the device: the same ranges as the host
    # scan key_aligned_ranges(decode_keys(merged, reduce_by), ...).
    ranges = ranges_from_change_points(
        chunk_key_change_points(merged, reduce_by), n, rows_per_job)

    base = _make_reduce_runner(reducer, command, reduce_by, fmt, spec)

    def make(rng):
        start, end = rng
        # Slice the merged columnar chunk lazily: rows decode on the job
        # slot (the stripe.materialize() analog), not the controller.
        return base(lambda: merged.slice_rows(start, end).to_rows())

    outputs, revived = _run_user_jobs(
        client, op, job_manager, spec, ranges, make,
        plan={"kind": "reduce", "input_chunk_ids": input_chunk_ids,
              "ranges": [list(r) for r in ranges], "command": command},
        is_command=command is not None and plan_stable,
        publish=lambda outs: client.write_table(
            output_path, [row for part in outs for row in part],
            schema=spec.get("output_schema")))
    return {"rows": sum(len(part) for part in outputs),
            "jobs": len(ranges) - revived, "revived_jobs": revived}


def _map_reduce_controller(client, spec: dict, op=None,
                           job_manager=None) -> dict:
    """MapReduce (ref sort_controller.cpp:5029 CreateMapReduceController):
    map+partition jobs → hash shuffle by reduce key → per-partition
    sort + reduce jobs (partition_sort_job.cpp:43 semantics).

    Redesign: the reference streams partition chunks through a partition
    tree; here map jobs hash-route their output rows in-job (stable CRC,
    revival-safe) and each reduce job device-sorts its partition before
    grouping — the shuffle itself is row movement between job results,
    not a cluster data plane, because operation intermediates are
    operation-lifetime state."""
    from ytsaurus_tpu_torch.formats import dumps_rows, loads_rows
    from ytsaurus_tpu_torch.operations.chunk_pools import build_stripes
    from ytsaurus_tpu_torch.operations.jobs import run_command_job
    from ytsaurus_tpu_torch.operations.reduce_op import partition_rows

    mapper = spec.get("mapper")
    map_command = spec.get("map_command")
    reducer = spec.get("reducer")
    reduce_command = spec.get("reduce_command")
    if (reducer is None) == (reduce_command is None):
        raise YtError(
            "map_reduce spec requires exactly one of reducer/reduce_command")
    if mapper is not None and map_command is not None:
        raise YtError("map_reduce spec allows at most one of "
                      "mapper/map_command")
    reduce_by, sort_by = _reduce_keys(spec)
    input_path = _one(spec, "input_table_path")
    output_path = _one(spec, "output_table_path")
    fmt = spec.get("format", "json")
    chunks = client._read_table_chunks(input_path)
    chunks = [c for c in chunks if c.row_count > 0]
    if not chunks:
        client.write_table(output_path, [],
                           schema=spec.get("output_schema"))
        return {"rows": 0, "jobs": 0}
    total_rows = sum(c.row_count for c in chunks)
    rows_per_job = spec.get("rows_per_job") or 4_000_000
    partition_count = int(spec.get("partition_count") or
                          max(min(-(-total_rows // rows_per_job), 64), 1))
    stripes = build_stripes(chunks, rows_per_job=rows_per_job,
                            max_job_count=spec.get("max_job_count"))
    # Snapshot revival is valid only when the whole pipeline is free of
    # Python callables (commands re-run deterministically; closures don't
    # survive a controller restart).  Dynamic tables have no stable chunk
    # list (rows change while @chunk_ids stays fixed), so their snapshot
    # plans would silently go stale — no revival for them, as in map.
    def _attr(name, default):
        try:
            return client.get(f"{input_path}/@{name}")
        except YtError:
            return default

    input_chunk_ids = list(_attr("chunk_ids", []) or [])
    plan_stable = bool(input_chunk_ids) and not _attr("dynamic", False)
    is_command = mapper is None and reducer is None and plan_stable

    # -- phase 1: map + partition (each job hash-routes its own output) --------
    def make_map(stripe):
        def run_map(job):
            rows = stripe.materialize().to_rows()
            if mapper is not None:
                rows = list(mapper(rows))
            elif map_command is not None:
                from ytsaurus_tpu_torch.operations.job_environment import (
                    limits_from_spec,
                )
                blob = dumps_rows(rows, fmt)
                out = run_command_job(job, map_command, blob,
                                      timeout=spec.get("job_time_limit"),
                                      limits=limits_from_spec(spec))
                rows = loads_rows(out, fmt)
            return partition_rows(rows, reduce_by, partition_count)
        return run_map, map_command is not None

    plan = {"kind": "map_reduce", "input_chunk_ids": input_chunk_ids,
            "partition_count": partition_count,
            "map_command": map_command, "reduce_command": reduce_command}

    # Revival fast path: when every reduce partition is already recorded
    # in the snapshot, skip the (deterministic) map phase entirely.
    op_id = op.id if op is not None else uuid.uuid4().hex
    snap_ok = is_command and hasattr(client, "cluster")
    probe = _Snapshot(client, op_id, plan=plan) if snap_ok else None
    pre_completed = probe.load() if probe is not None else {}
    map_jobs_run = 0
    if len(pre_completed) == partition_count:
        partitions: "list[list[dict]]" = [[] for _ in range(partition_count)]
    else:
        buckets, _ = _run_user_jobs(
            client, op, job_manager, spec, stripes, make_map,
            plan={}, is_command=False)   # map phase re-runs on revival
        map_jobs_run = len(stripes)
        partitions = [[] for _ in range(partition_count)]
        for job_buckets in buckets:
            for p, rows in enumerate(job_buckets):
                partitions[p].extend(rows)

    # An abort that landed during the map phase must stop the reduce
    # phase from running (and publishing) at all.
    _raise_if_aborted(op)

    # -- phase 2: per-partition device sort + reduce ---------------------------
    make_reduce_base = _make_reduce_runner(
        reducer, reduce_command, reduce_by, fmt, spec)

    def make_reduce(rows):
        # Sort runs INSIDE the job via the lazy rows_fn (the
        # partition_sort_job analog): device lexsort on a job slot, not
        # the controller thread.
        return make_reduce_base(
            lambda: _sort_rows_for_reduce(rows, sort_by,
                                          client.device))

    outputs, revived = _run_user_jobs(
        client, op, job_manager, spec, partitions, make_reduce,
        plan=plan, is_command=is_command,
        publish=lambda outs: client.write_table(
            output_path, [row for part in outs for row in part],
            schema=spec.get("output_schema")))
    return {"rows": sum(len(part) for part in outputs),
            "jobs": map_jobs_run + partition_count - revived,
            "partitions": partition_count, "revived_jobs": revived}


def _vanilla_controller(client, spec: dict, op=None,
                        job_manager=None) -> dict:
    """Vanilla (gang) operations (ref vanilla_controller.cpp:130): named
    tasks × job_count jobs with NO input tables — the hosting primitive
    for CHYT cliques and everything strawberry-shaped.

    Gang semantics: the whole gang must fit the slot pool (all-or-nothing
    acquisition — a partial gang would deadlock the cluster), and ANY job
    failure restarts the ENTIRE gang (ref vanilla_controller.cpp gang
    rank restart), up to max_gang_restarts.  Long-lived commands (servers)
    run until the operation is aborted."""
    from ytsaurus_tpu_torch.formats import loads_rows
    from ytsaurus_tpu_torch.operations.jobs import Job, run_command_job

    tasks = spec.get("tasks")
    if not tasks or not isinstance(tasks, dict):
        raise YtError("vanilla spec requires tasks: {name: {...}}")
    gang = bool(spec.get("gang", True))
    max_restarts = int(spec.get("max_gang_restarts", 2))
    fmt = spec.get("format", "json")
    pool = spec.get("pool", "default")
    op_id = op.id if op is not None else uuid.uuid4().hex

    plans = []                       # (task_name, job_count, runner spec)
    total = 0
    for name in sorted(tasks):
        task = tasks[name]
        job_count = int(task.get("job_count", 1))
        if job_count < 1:
            raise YtError(f"vanilla task {name!r}: job_count must be >= 1")
        command = task.get("command")
        fn = task.get("callable")
        if (command is None) == (fn is None):
            raise YtError(f"vanilla task {name!r} requires exactly one "
                          "of command/callable")
        plans.append((name, job_count, command, fn, task))
        total += job_count
    if gang and total > job_manager.slots:
        raise YtError(
            f"vanilla gang of {total} jobs cannot acquire "
            f"{job_manager.slots} slots (all-or-nothing scheduling)",
            code=EErrorCode.OperationFailed)

    attempt = 0
    while True:
        jobs: list = []
        index = 0
        for name, job_count, command, fn, task in plans:
            for rank in range(job_count):
                if command is not None:
                    def run_cmd(job, _cmd=command, _name=name,
                                _rank=rank, _task=task):
                        from ytsaurus_tpu_torch.operations.job_environment \
                            import limits_from_spec
                        out = run_command_job(
                            job, _cmd, b"",
                            timeout=_task.get("job_time_limit") or
                            spec.get("job_time_limit"),
                            env={"YT_TASK_NAME": _name,
                                 "YT_JOB_COOKIE": str(_rank),
                                 **(_task.get("environment") or {})},
                            # Per-KEY merge: a task overriding one limit
                            # must not drop the operation-wide others.
                            limits={**(limits_from_spec(spec) or {}),
                                    **(limits_from_spec(_task) or {})}
                            or None)
                        return loads_rows(out, fmt) if out.strip() else []
                    run, preemptible = run_cmd, True
                else:
                    def run_py(job, _fn=fn, _name=name, _rank=rank):
                        return list(_fn(_name, _rank) or [])
                    run, preemptible = run_py, False
                jobs.append(Job(op_id=op_id, index=index, run=run,
                                pool=pool, preemptible=preemptible))
                index += 1
        if op is not None:
            op.progress = {"total": total, "completed": 0,
                           "gang_attempt": attempt}
        # Gang wait with FIRST-casualty short-circuit: a failing sibling
        # must condemn still-running (possibly long-lived) rank mates
        # immediately, not after they exit on their own.
        wake = threading.Event()
        for job in jobs:
            job.on_done = lambda _job: wake.set()
        job_manager.submit(jobs)
        try:
            while True:
                states = [j.state for j in jobs]
                if all(s == "completed" for s in states):
                    break
                if any(s in ("failed", "aborted") for s in states):
                    break
                if op is not None and op.state == "aborted":
                    break
                wake.wait(0.2)
                wake.clear()
        finally:
            job_manager.finish_operation(op_id)
        if all(j.state == "completed" for j in jobs):
            break
        # Gang discipline: one casualty condemns the whole rank set.
        job_manager.abort_operation(op_id)
        if op is not None and op.state == "aborted":
            raise YtError("operation aborted", code=EErrorCode.Canceled)
        attempt += 1
        first_error = next((j.error for j in jobs if j.error is not None),
                           None)
        if attempt > max_restarts:
            raise first_error or YtError(
                "vanilla gang failed", code=EErrorCode.OperationFailed)

    # Optional per-task output tables (ref vanilla output table specs).
    outputs: dict = {}
    cursor = 0
    for name, job_count, _command, _fn, task in plans:
        rows = [row for job in jobs[cursor: cursor + job_count]
                for row in (job.result or [])]
        cursor += job_count
        outputs[name] = len(rows)
        out_path = task.get("output_table_path")
        if out_path:
            client.write_table(out_path, rows,
                               schema=task.get("output_schema"))
    return {"jobs": total, "gang_restarts": attempt,
            "task_output_rows": outputs}


def _align_schemas(chunks):
    """Inputs from different tables may agree on columns but differ in order
    or sort annotations; align them onto one unsorted schema for merging."""
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.schema import TableSchema

    base = {c.name: c.type for c in chunks[0].schema}
    for chunk in chunks[1:]:
        other = {c.name: c.type for c in chunk.schema}
        if other != base:
            raise YtError(
                f"Merge inputs have incompatible schemas: {sorted(base)} vs "
                f"{sorted(other)}", code=EErrorCode.QueryTypeError)
    target = TableSchema.make(
        [(c.name, c.type.value) for c in chunks[0].schema])
    return [
        ColumnarChunk(schema=target, row_count=chunk.row_count,
                      columns={name: chunk.columns[name]
                               for name in target.column_names})
        for chunk in chunks
    ]


def _one(spec: dict, key: str) -> str:
    value = spec.get(key)
    if not value or not isinstance(value, str):
        raise YtError(f"Operation spec requires {key!r}")
    return value


def _remote_copy_controller(client, spec: dict, op=None,
                            job_manager=None) -> dict:
    """Remote copy (ref controllers/remote_copy_controller.cpp): pull a
    table from ANOTHER cluster into this one through the remote thin
    client — chunk-shaped reads on the source, ordinary chunk publishes
    on the destination, schema + sort order preserved."""
    from ytsaurus_tpu_torch.remote_client import connect_remote

    cluster_address = spec.get("cluster_address") or \
        spec.get("cluster_connection")
    if not cluster_address:
        raise YtError("remote_copy spec requires cluster_address")
    input_path = _one(spec, "input_table_path")
    output_path = _one(spec, "output_table_path")
    src = connect_remote(cluster_address, device=client.device)
    try:
        chunks = src._read_table_chunks(input_path)
        schema = None
        sorted_by = None
        try:
            schema_dict = src.get(input_path + "/@schema")
            if schema_dict:
                from ytsaurus_tpu_torch.schema import TableSchema
                schema = TableSchema.from_dict(schema_dict)
        except YtError:
            pass
        try:
            sorted_by = src.get(input_path + "/@sorted_by")
        except YtError:
            sorted_by = None
        chunks = [c for c in chunks if c.row_count > 0]
        client._write_table_chunks(output_path, chunks,
                                   sorted_by=sorted_by, schema=schema)
        # User attributes ride along (ref remote copy attribute keys).
        # They were requested EXPLICITLY: a missing one is an error, not
        # a silent drop.
        missing = []
        for key in spec.get("attribute_keys") or []:
            try:
                client.set(f"{output_path}/@{key}",
                           src.get(f"{input_path}/@{key}"))
            except YtError:
                missing.append(key)
        if missing:
            raise YtError(
                f"remote_copy: requested attribute_keys {missing} absent "
                f"on {input_path!r}", code=EErrorCode.ResolveError)
        return {"rows": sum(c.row_count for c in chunks),
                "chunks": len(chunks)}
    finally:
        src.close()


_CONTROLLERS = {
    "sort": _sort_controller,
    "merge": _merge_controller,
    "map": _map_controller,
    "erase": _erase_controller,
    "reduce": _reduce_controller,
    "map_reduce": _map_reduce_controller,
    "vanilla": _vanilla_controller,
    "remote_copy": _remote_copy_controller,
}
