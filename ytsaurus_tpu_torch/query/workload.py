"""Workload recorder, the recording half.

Own copy of the JAX package's `query/workload.py` as far as the client
records into it: every admitted query folds a COMPACT record into a
bounded workload log (ref: the structured query log that capacity
planning and regression hunting replay against staging clusters):

  normalized query text     literals hoisted out (`?` placeholders,
                            query/parameterize.py::hoist_literals), so
                            one plan SHAPE is one fingerprint;
  literal bindings          the hoisted values (typed), enough to
                            reconstruct and re-run the exact query;
  identity + outcome        pool/user, wall/compile/execute split,
                            ok/error/throttled/deadline, trace id;
  stages                    a select's wall split where the work
                            happened (query/statistics.py STAGE_FIELDS,
                            host_cpu_time, wall_time), in seconds.

The log is sampled and bounded in memory (`config.WorkloadConfig`) with
an optional rotated on-disk JSONL tier, and exported/imported as a
VERSIONED capture file (`write_capture` / `load_capture`, which fails
loudly on an incompatible schema). `replay` re-runs a capture open-loop
against a client, in-process (`connect`) or remote (`connect_remote`),
and `synthesize_mix` builds a parameterized mix without a capture.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time
from collections import deque
from typing import Optional, Sequence

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.query.parameterize import hoist_literals
from ytsaurus_tpu_torch.query.statistics import STAGE_FIELDS
from ytsaurus_tpu_torch.utils.profiling import Profiler
from ytsaurus_tpu_torch.utils import sanitizers

# Bump when the record shape changes incompatibly: `load_capture` (and
# the on-disk log reader) refuse mismatched captures LOUDLY instead of
# replaying garbage.  v2: records carry the
# planner-feedback ledger field `join_est_error` — the max
# est-vs-actual join cardinality drift of the query.
WORKLOAD_SCHEMA_VERSION = 2

# -- query normalization -------------------------------------------------------

# THE literal-hoisting implementation lives in query/parameterize.py
#: the workload recorder's text normalization and
# the evaluator's plan parameterization share it, so the two planes
# can never silently disagree about what "the same query shape" means.
normalize_query = hoist_literals


def render_literal(kind: str, value) -> str:
    """One hoisted literal back to QL surface syntax."""
    if kind == "string":
        s = str(value)
        escaped = s.replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n").replace("\t", "\\t") \
            .replace("\r", "\\r").replace("\0", "\\0")
        return f'"{escaped}"'
    if kind == "uint64":
        return f"{int(value)}u"
    if kind == "double":
        return repr(float(value))
    return repr(int(value))


def substitute_literals(normalized: str, literals: Sequence) -> str:
    """Reconstruct runnable query text: literals back into the `?`
    placeholders, in order.  Counts must match exactly — a corrupt or
    hand-edited capture fails here, loudly, before anything runs."""
    parts = normalized.split("?")
    if len(parts) != len(literals) + 1:
        raise YtError(
            f"workload record is corrupt: {len(parts) - 1} placeholders "
            f"vs {len(literals)} literals in {normalized[:120]!r}",
            code=EErrorCode.InvalidConfig)
    out = [parts[0]]
    for literal, tail in zip(literals, parts[1:]):
        kind, value = literal[0], literal[1]
        out.append(render_literal(kind, value))
        out.append(tail)
    return "".join(out)


def query_fingerprint(normalized: str) -> str:
    """The workload fingerprint: one per normalized TEXT shape (the
    engine's plan fingerprint — ir.fingerprint — still varies with
    literals until ROADMAP-1 auto-parameterization lands; this is the
    shape the fleet's operators reason about)."""
    return hashlib.sha256(normalized.encode()).hexdigest()[:16]


def outcome_of(err: YtError) -> str:
    """Classify a failed query's outcome for the record."""
    if err.find(EErrorCode.RequestThrottled):
        return "throttled"
    if err.find(EErrorCode.DeadlineExceeded):
        return "deadline"
    return "error"


# -- records -------------------------------------------------------------------

_RECORD_FIELDS = (
    "kind", "query", "literals", "fingerprint", "table", "keys",
    "pool", "user", "started_at", "outcome", "wall_time",
    "compile_time", "execute_time", "rows_read", "rows_returned",
    "capacity_buckets", "trace_id", "execution_tier",
    "join_est_error", "stages",
)


class WorkloadRecord:
    """One admitted query, compactly (the workload-log unit)."""

    __slots__ = _RECORD_FIELDS

    def __init__(self, kind="select", query="", literals=(),
                 fingerprint=None, table=None, keys=0, pool=None,
                 user=None, started_at=0.0, outcome="ok", wall_time=0.0,
                 compile_time=0.0, execute_time=0.0, rows_read=0,
                 rows_returned=0, capacity_buckets=(), trace_id=None,
                 execution_tier="compiled", join_est_error=0.0,
                 stages=None):
        self.kind = kind
        self.query = query
        self.literals = [list(lit) for lit in literals]
        self.fingerprint = fingerprint or query_fingerprint(
            f"{kind}|{table or ''}|{query}")
        self.table = table
        self.keys = int(keys)
        self.pool = pool
        self.user = user
        self.started_at = float(started_at)
        self.outcome = outcome
        self.wall_time = float(wall_time)
        self.compile_time = float(compile_time)
        self.execute_time = float(execute_time)
        self.rows_read = int(rows_read)
        self.rows_returned = int(rows_returned)
        self.capacity_buckets = sorted(int(b) for b in capacity_buckets)
        self.trace_id = trace_id
        # Which tier served the query: defaults keep old
        # captures loadable — a missing field reads as "compiled".
        self.execution_tier = execution_tier
        # Planner feedback ledger: the query's max
        # est-vs-actual join cardinality drift (planner.est_drift) —
        # the per-fingerprint roll-up of this is what tells an
        # operator WHICH workload shapes the planner misestimates.
        self.join_est_error = float(join_est_error)
        # {field: seconds}; empty for a lookup, and in records of
        # captures that predate it.
        self.stages = {_decode(k): float(v)
                       for k, v in (stages or {}).items()}

    def to_dict(self) -> dict:
        return {field: getattr(self, field) for field in _RECORD_FIELDS}

    @classmethod
    def from_dict(cls, data: dict) -> "WorkloadRecord":
        data = {(k.decode("utf-8") if isinstance(k, bytes) else k): v
                for k, v in (data or {}).items()}
        kwargs = {field: data[field] for field in _RECORD_FIELDS
                  if field in data and data[field] is not None}
        for key in ("kind", "query", "fingerprint", "table", "pool",
                    "user", "outcome", "trace_id", "execution_tier"):
            if isinstance(kwargs.get(key), bytes):
                kwargs[key] = kwargs[key].decode("utf-8", "replace")
        return cls(**kwargs)


# -- the bounded workload log --------------------------------------------------

class WorkloadLog:
    """Sampled, bounded retention of workload records plus an on-disk
    rotated tier (config.WorkloadConfig).  Thread-safe; one global
    instance per process plus private ones in tests."""

    LOG_NAME = "workload.jsonl"

    def __init__(self, config=None):
        self._config = config
        # guards: _records, _fingerprints, recorded_n, sampled_out_n, fingerprints_dropped_n
        self._lock = sanitizers.register_lock(
            "workload.WorkloadLog._lock")
        # Disk appends take their own lock: the in-memory fold must
        # never queue behind rotation/write I/O of the on-disk tier.
        self._io_lock = threading.Lock()
        self._records: "deque[WorkloadRecord]" = deque(maxlen=4096)
        self._fingerprints: dict[str, dict] = {}
        self.recorded_n = 0
        self.sampled_out_n = 0
        self.fingerprints_dropped_n = 0
        prof = Profiler("/workload")
        self._recorded = prof.counter("recorded")
        self._dropped = prof.counter("dropped")

    @property
    def config(self):
        if self._config is not None:
            return self._config
        from ytsaurus_tpu_torch.config import workload_config
        return workload_config()

    # -- recording -------------------------------------------------------------

    def _admit(self, cfg) -> bool:
        """The sampling draw (one per candidate record): callers that
        pre-sample pass presampled=True to observe() so a record is
        never drawn twice."""
        if cfg.sample_rate < 1.0 and random.random() >= cfg.sample_rate:
            # Callers draw OUTSIDE the record lock; the tally still
            # needs it (the lock pass flagged the bare increment —
            # concurrent sampled-out draws would lose counts).
            with self._lock:
                self.sampled_out_n += 1
            self._dropped.increment()
            return False
        return True

    def observe(self, record: WorkloadRecord,
                presampled: bool = False) -> bool:
        cfg = self.config
        if not cfg.enabled:
            return False
        if not presampled and not self._admit(cfg):
            return False
        with self._lock:
            if self._records.maxlen != cfg.capacity:
                self._records = deque(self._records, maxlen=cfg.capacity)
            self._records.append(record)
            self.recorded_n += 1
            self._fold_fingerprint_locked(record, cfg)
        self._recorded.increment()
        if cfg.log_dir:
            self._append_disk(record, cfg)
        return True

    def _fold_fingerprint_locked(self, record: WorkloadRecord, cfg) -> None:
        entry = self._fingerprints.get(record.fingerprint)
        if entry is None:
            if len(self._fingerprints) >= cfg.fingerprint_capacity:
                self.fingerprints_dropped_n += 1
                return
            entry = self._fingerprints[record.fingerprint] = {
                "kind": record.kind, "query": record.query,
                "table": record.table, "count": 0, "ok": 0, "errors": 0,
                "throttled": 0, "deadline": 0, "wall_seconds": 0.0,
                "compile_seconds": 0.0, "last_at": 0.0,
                # how often the interpreter tier served this
                # shape — next to count and compile_seconds, the
                # promotion-value signal (runs x compile cost x delta)
                # is readable straight off the roll-up.
                "interpreted": 0, "interpreted_seconds": 0.0,
                # the planner-feedback ledger — worst join
                # cardinality misestimate seen for this shape.
                "join_est_error_max": 0.0,
            }
        entry["count"] += 1
        entry["join_est_error_max"] = max(entry["join_est_error_max"],
                                          record.join_est_error)
        if record.execution_tier == "interpreted":
            entry["interpreted"] += 1
            entry["interpreted_seconds"] += record.execute_time
        bucket = record.outcome if record.outcome in (
            "ok", "throttled", "deadline") else "errors"
        entry[bucket] += 1
        entry["wall_seconds"] += record.wall_time
        entry["compile_seconds"] += record.compile_time
        entry["last_at"] = max(entry["last_at"], record.started_at)

    # The observe_* helpers are the fold sites the planes call; each is
    # one config read when the recorder is disabled.

    def observe_select(self, query: str, profile=None, stats=None,
                       outcome: str = "ok",
                       wall_time: Optional[float] = None,
                       pool: Optional[str] = None,
                       user: Optional[str] = None,
                       trace_id: Optional[str] = None) -> bool:
        cfg = self.config
        if not cfg.enabled:
            return False
        # Sample BEFORE normalizing: at sample_rate 0.01 the 99% of
        # selects that are drawn out must pay one RNG draw, not a full
        # lexer pass over the query text.
        if not self._admit(cfg):
            return False
        try:
            normalized, literals = normalize_query(query)
        except YtError:
            # Unlexable text (error-outcome records): keep it verbatim
            # so the failure is still visible in the workload.
            normalized, literals = query[:500], []
        stats_dict = {}
        if profile is not None:
            stats_dict = profile.statistics or {}
            wall_time = profile.wall_time
            pool = pool or profile.pool
            user = user or profile.user
            trace_id = trace_id or profile.trace_id
        elif stats is not None:
            stats_dict = stats.to_dict()
        from ytsaurus_tpu_torch.query.planner import est_drift
        join_est_error = max(
            [est_drift(e.get("est_rows", 0), e.get("actual_rows", 0))
             for e in (stats_dict.get("join_plan") or []) if e] or [0.0])
        record = WorkloadRecord(
            kind="select", query=normalized, literals=literals,
            fingerprint=query_fingerprint(normalized), pool=pool,
            user=user, started_at=time.time(), outcome=outcome,
            wall_time=wall_time or 0.0,
            compile_time=float(stats_dict.get("compile_time", 0.0)),
            execute_time=float(stats_dict.get("execute_time", 0.0)),
            rows_read=int(stats_dict.get("rows_read", 0)),
            rows_returned=int(stats_dict.get("rows_written", 0)),
            capacity_buckets=stats_dict.get("capacity_buckets") or (),
            trace_id=trace_id,
            execution_tier=stats_dict.get("execution_tier", "compiled"),
            join_est_error=join_est_error,
            stages={**{f: stats_dict[f] for f in
                       (*STAGE_FIELDS, "host_cpu_time") if f in stats_dict},
                    "wall_time": wall_time or 0.0})
        return self.observe(record, presampled=True)

    def observe_lookup(self, table: str, keys: Sequence[tuple],
                       outcome: str = "ok", wall_time: float = 0.0,
                       pool: Optional[str] = None,
                       user: Optional[str] = None,
                       trace_id: Optional[str] = None) -> bool:
        cfg = self.config
        if not cfg.enabled:
            return False
        if not self._admit(cfg):
            return False
        keys = [tuple(k) for k in keys]
        shape = ",".join(type(v).__name__ for v in keys[0]) if keys \
            else ""
        retained = [["key", list(k)] for k in
                    keys[:cfg.lookup_keys_per_record]]
        record = WorkloadRecord(
            kind="lookup", query=f"LOOKUP [{table}] ({shape})",
            literals=retained,
            fingerprint=query_fingerprint(f"lookup|{table}|{shape}"),
            table=table, keys=len(keys), pool=pool, user=user,
            started_at=time.time(), outcome=outcome,
            wall_time=wall_time)
        return self.observe(record, presampled=True)

    # -- the on-disk tier ------------------------------------------------------

    def _append_disk(self, record: WorkloadRecord, cfg) -> None:
        try:
            with self._io_lock:
                os.makedirs(cfg.log_dir, exist_ok=True)
                path = os.path.join(cfg.log_dir, self.LOG_NAME)
                if os.path.exists(path) and \
                        os.path.getsize(path) >= cfg.rotate_bytes:
                    self._rotate(path, cfg)
                fresh = not os.path.exists(path)
                with open(path, "a", encoding="utf-8") as f:
                    if fresh:
                        f.write(json.dumps(
                            {"workload_schema":
                             WORKLOAD_SCHEMA_VERSION}) + "\n")
                    f.write(json.dumps(record.to_dict(),
                                       default=_json_default) + "\n")
        except OSError:
            # Disk tier is best-effort observability; the in-memory log
            # stays authoritative.
            pass

    def _rotate(self, path: str, cfg) -> None:
        oldest = f"{path}.{cfg.max_files - 1}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(cfg.max_files - 2, 0, -1):
            src = f"{path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{path}.{i + 1}")
        os.replace(path, f"{path}.1")

    def read_disk_log(self,
                      log_dir: Optional[str] = None) -> list[WorkloadRecord]:
        """Every record in the rotated on-disk tier, oldest first; each
        file's header version is checked (mismatch raises)."""
        cfg = self.config
        log_dir = log_dir or cfg.log_dir
        if not log_dir:
            return []
        base = os.path.join(log_dir, self.LOG_NAME)
        paths = [f"{base}.{i}" for i in range(cfg.max_files - 1, 0, -1)]
        paths.append(base)
        out: list[WorkloadRecord] = []
        for path in paths:
            if not os.path.exists(path):
                continue
            with open(path, encoding="utf-8") as f:
                header = json.loads(f.readline() or "{}")
                _check_schema(header, path)
                for line in f:
                    if line.strip():
                        out.append(WorkloadRecord.from_dict(
                            json.loads(line)))
        return out

    # -- capture export/import -------------------------------------------------

    def export_capture(self, path: str,
                       limit: Optional[int] = None) -> int:
        """Write the retained records as a versioned capture file; the
        artifact `yt replay` and `bench.py --config replay` consume."""
        return write_capture(path, self.records(), limit=limit)

    def import_capture(self, path: str) -> int:
        records = load_capture(path)
        for record in records:
            # A deliberately imported capture keeps every record — the
            # sampling draw already happened when it was recorded.
            self.observe(record, presampled=True)
        return len(records)

    # -- views -----------------------------------------------------------------

    def records(self) -> list[WorkloadRecord]:
        with self._lock:
            return list(self._records)

    def fingerprints(self, top: int = 50) -> list[dict]:
        with self._lock:
            entries = [{"fingerprint": fp, **entry}
                       for fp, entry in self._fingerprints.items()]
        entries.sort(key=lambda e: (-e["count"], e["fingerprint"]))
        return entries[:top] if top else entries

    def snapshot(self, limit: int = 128) -> dict:
        """limit=0 serves every retained record (bounded by capacity)."""
        records = self.records()
        if limit:
            records = records[-limit:]
        return {
            "schema_version": WORKLOAD_SCHEMA_VERSION,
            "recorded": self.recorded_n,
            "sampled_out": self.sampled_out_n,
            "fingerprints_dropped": self.fingerprints_dropped_n,
            "records": [r.to_dict() for r in records],
            "fingerprints": self.fingerprints(),
        }

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._fingerprints.clear()
            self.recorded_n = 0
            self.sampled_out_n = 0
            self.fingerprints_dropped_n = 0


def _check_schema(header: dict, path: str) -> None:
    version = (header or {}).get("workload_schema")
    if version != WORKLOAD_SCHEMA_VERSION:
        raise YtError(
            f"incompatible workload capture {path!r}: schema version "
            f"{version!r}, this build speaks {WORKLOAD_SCHEMA_VERSION} "
            "— refusing to replay it",
            code=EErrorCode.InvalidConfig)


def write_capture(path: str, records: Sequence[WorkloadRecord],
                  limit: Optional[int] = None) -> int:
    """THE capture writer (WorkloadLog.export_capture and `yt workload
    capture|export` both route here): versioned header, atomic
    tmp-then-replace so a crash mid-write never leaves a truncated
    capture at the target path."""
    records = list(records)
    if limit:
        records = records[-limit:]
    payload = {
        "workload_schema": WORKLOAD_SCHEMA_VERSION,
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                     time.gmtime()),
        "records": [r.to_dict() for r in records],
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, default=_json_default)
    os.replace(tmp, path)
    return len(records)


def load_capture(path: str) -> list[WorkloadRecord]:
    """Read a capture file, FAILING LOUDLY on an incompatible schema
    (the versioned-workload-log check: `yt replay` must never replay a
    capture whose record shape it misreads)."""
    try:
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
    except (OSError, ValueError) as exc:
        raise YtError(f"cannot read workload capture {path!r}: {exc}",
                      code=EErrorCode.InvalidConfig)
    _check_schema(payload, path)
    return [WorkloadRecord.from_dict(r)
            for r in payload.get("records") or []]


def _json_default(value):
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    return str(value)


# -- synthetic mixes -----------------------------------------------------------

def synthesize_mix(shapes: Sequence[str], count: int = 100,
                   distinct: int = 16, seed: int = 0,
                   interval: float = 0.01,
                   pool: Optional[str] = None) -> list[WorkloadRecord]:
    """Build a parameterized-query mix without a capture: `shapes` are
    format strings with `{}` literal slots; each synthesized query draws
    its literals from a `distinct`-sized value set (Zipf-ish: low values
    dominate, like production key skew) so the mix exercises the
    repeated-shape, varied-literal traffic of a serving workload."""
    rng = random.Random(seed)
    records = []
    for i in range(count):
        shape = shapes[i % len(shapes)]
        n_slots = shape.count("{}")
        values = []
        for _ in range(n_slots):
            # Skewed draw: half the traffic hits the 4 hottest values.
            pick = rng.randrange(distinct) if rng.random() < 0.5 \
                else rng.randrange(max(distinct // 4, 1))
            values.append(pick)
        normalized, literals = normalize_query(shape.format(*values))
        records.append(WorkloadRecord(
            kind="select", query=normalized, literals=literals,
            fingerprint=query_fingerprint(normalized), pool=pool,
            started_at=i * interval, outcome="ok"))
    return records


# -- replay --------------------------------------------------------------------

def _decode(value):
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    if isinstance(value, dict):
        return {_decode(k): _decode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_decode(v) for v in value]
    return value


def _profile_trace_id(profile) -> Optional[str]:
    """The trace id of an ExecutionProfile object (in-process client) or
    of its dict form (remote client)."""
    if hasattr(profile, "trace_id"):
        return profile.trace_id
    if isinstance(profile, dict):
        return _decode(profile).get("trace_id")
    return None


def replay(client, records: Sequence[WorkloadRecord],
           speed: float = 1.0, rate: Optional[float] = None,
           max_workers: int = 16, pool: Optional[str] = None,
           timeout: Optional[float] = None,
           limit: Optional[int] = None,
           slowest: int = 5) -> dict:
    """Re-run a workload against a live client/gateway, open-loop.

    Pacing: each record dispatches at its scheduled offset — recorded
    inter-arrival spacing divided by `speed`, or a fixed `rate` (qps)
    when given (also the fallback when the capture carries no
    timestamps).  Dispatch does NOT wait for earlier queries: a slow
    server accumulates in-flight work exactly as production would
    (bounded by `max_workers` executing threads; the backlog past that
    is measured as latency, which is the point).

    Selects run with explain_analyze=True so every replayed query
    carries its compile/execute split and trace id; the slowest queries
    embed their trace ids for `/traces` follow-up. The report keeps the
    reference's shape less its `compile_cache` section: the port
    compiles nothing, so there are no hits or misses to count."""
    from concurrent.futures import ThreadPoolExecutor

    records = list(records)
    if limit:
        records = records[:limit]
    if not records:
        raise YtError("workload replay: no records to replay",
                      code=EErrorCode.InvalidConfig)
    # Scheduled offsets, seconds from replay start.
    if rate is not None and rate > 0:
        offsets = [i / rate for i in range(len(records))]
    else:
        base = records[0].started_at
        spread = records[-1].started_at - base
        if spread > 0:
            offsets = [(r.started_at - base) / max(speed, 1e-9)
                       for r in records]
        else:
            offsets = [0.0] * len(records)

    lock = threading.Lock()
    latencies: list[float] = []
    outcomes = {"ok": 0, "error": 0, "throttled": 0, "deadline": 0}
    slow_heap: list[tuple[float, dict]] = []

    def run_one(rec: WorkloadRecord) -> None:
        t0 = time.perf_counter()
        outcome = "ok"
        trace_id = None
        query_text = rec.query
        try:
            if rec.kind == "lookup":
                keys = [tuple(lit[1]) for lit in rec.literals
                        if lit and lit[0] == "key"]
                if keys:
                    client.lookup_rows(rec.table, keys,
                                       pool=pool or rec.pool,
                                       timeout=timeout)
            else:
                query_text = substitute_literals(rec.query, rec.literals)
                profile = client.select_rows(
                    query_text, pool=pool or rec.pool, timeout=timeout,
                    explain_analyze=True)
                trace_id = _profile_trace_id(profile)
        except YtError as err:
            outcome = outcome_of(err)
        except Exception:   # noqa: BLE001 — a replay worker must never
            # lose a query from the report: transport/driver surprises
            # count as errors, they don't silently vanish into an
            # unchecked future.
            outcome = "error"
        elapsed = time.perf_counter() - t0
        with lock:
            outcomes[outcome] += 1
            latencies.append(elapsed)
            slow_heap.append((elapsed, {
                "query": query_text[:200],
                "fingerprint": rec.fingerprint,
                "wall_ms": round(elapsed * 1e3, 3),
                "outcome": outcome,
                "trace_id": trace_id,
            }))
            if len(slow_heap) > max(slowest, 1) * 4:
                slow_heap.sort(key=lambda e: -e[0])
                del slow_heap[max(slowest, 1) * 4:]

    t_start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max_workers,
                            thread_name_prefix="replay") as executor:
        for rec, offset in zip(records, offsets):
            delay = t_start + offset - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            # Open loop: submit on schedule regardless of completions.
            executor.submit(run_one, rec)
    elapsed = time.perf_counter() - t_start

    latencies.sort()

    def pct(q: float) -> float:
        if not latencies:
            return 0.0
        idx = min(int(q * len(latencies)), len(latencies) - 1)
        return latencies[idx]

    slow_heap.sort(key=lambda e: -e[0])
    offered = (len(records) - 1) / offsets[-1] if offsets[-1] > 0 \
        else None
    return {
        "queries": len(records),
        **outcomes,
        "elapsed_seconds": round(elapsed, 6),
        "offered_rate": round(offered, 3) if offered else None,
        "achieved_rate": round(len(records) / elapsed, 3)
        if elapsed > 0 else None,
        "latency": {
            "p50_ms": round(pct(0.50) * 1e3, 3),
            "p99_ms": round(pct(0.99) * 1e3, 3),
            "p999_ms": round(pct(0.999) * 1e3, 3),
            "max_ms": round(latencies[-1] * 1e3, 3) if latencies
            else 0.0,
        },
        "slowest": [entry for _t, entry in slow_heap[:max(slowest, 1)]],
    }


# -- globals -------------------------------------------------------------------

_global_log: Optional[WorkloadLog] = None
# guards: _global_log
_log_lock = sanitizers.register_lock("workload._log_lock", hot=False)


def get_workload_log() -> WorkloadLog:
    global _global_log
    if _global_log is None:
        with _log_lock:
            if _global_log is None:
                _global_log = WorkloadLog()
    return _global_log


def configure(cfg) -> None:
    """Rebind the global log to a new workload config (called by
    config.set_workload_config; None restores lazy defaults)."""
    global _global_log
    with _log_lock:
        _global_log = None if cfg is None else WorkloadLog(cfg)
