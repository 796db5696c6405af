"""One run of one cell: set-up, the measured window, and the check.

Set-up generates the configuration's tables from the seed, builds their
chunks on the cluster's device, publishes them through
`ytsaurus_tpu_torch.client.publish_table_chunks` in the table codec the
configuration states, sizes the chunk cache and the gateway's admission
slots as it states, and warms
up every query of the traffic: each once alone (the first loads the
tables through the cache), then one round of every stream at once.

The window: each stream is a thread with its own `YtClient` over the one
cluster (`connect` on the same root shares it), in a closed loop: it sends
its next `select_rows` when the last one returns, until the window closes
(a traced run's after its first TRACE_SECONDS); a query in flight then
finishes, and is checked. It counts among the latencies whole, and in
the rates by its share of time inside the window.

The check: the queries' plain references (`ytbench/queries/<q>.py`) work
every answer out again from the generated arrays, on the host, after the
window has closed and the device's peak memory has been read, and judge
every answer the streams received.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ytbench import spec
from ytbench.trace import DeviceTrace, host_range

# A traced run's window is the first TRACE_SECONDS of --seconds: reading
# the trace of three streams takes about 2.6 s for each second traced on
# an H100's host, and a run has 360 s.
TRACE_SECONDS = 15.0

TABLE_ROOT = "//tpch"


@dataclass
class Answer:
    """One query a stream sent, as it came back."""
    query: str
    sub: int
    sent: float
    done: float
    rows: Optional[list]
    error: Optional[str]
    compile_s: float
    execute_s: float


@dataclass
class Run:
    """What a run measured, for the metric readers and the check."""
    setup_s: float
    window_s: float
    answers: list                 # completed inside the window
    late: list                    # sent inside it, done after it
    rows_read: dict               # query -> input rows one query reads
    bytes_read: dict              # query -> bytes one query must read
    cache_misses: int             # chunk cache misses inside the window
    memory_peak_bytes: int
    trace: Optional[dict] = None
    device_kind: str = ""
    closed: float = 0.0           # the window's close on the host's clock
    attempted: int = 0            # queries sent in the window
    failed: int = 0               # of those, queries that raised
    errors: list = field(default_factory=list)   # the first few errors
    readings: dict = field(default_factory=dict)

    def sent(self) -> list:
        """Every query sent in the window, done before its close or after."""
        return self.answers + self.late


def log(message: str) -> None:
    print(f"ytbench: {message}", file=sys.stderr, flush=True)


def seed_sequence(seed: int) -> np.random.SeedSequence:
    """Any whole number, negative or beyond 64 bits, names one sequence."""
    return np.random.SeedSequence(abs(int(seed)) * 2 + (int(seed) < 0))


def draw_substitutions(query: dict, rng: np.random.Generator,
                       count: int) -> list:
    """`count` sets of values for the query's slots, each slot drawn from
    its TPC-H range (`from`..`to` whole numbers, or `one_of`)."""
    out = []
    for _ in range(count):
        values = {}
        for slot, rule in query["slots"].items():
            if "one_of" in rule:
                values[slot] = rule["one_of"][int(rng.integers(
                    len(rule["one_of"])))]
            else:
                values[slot] = int(rng.integers(rule["from"], rule["to"] + 1))
        out.append(values)
    return out


def _publish(client, data, tables: dict, device) -> None:
    from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
    from ytsaurus_tpu_torch.client import publish_table_chunks
    from ytsaurus_tpu_torch.schema import TableSchema
    for name, parts in tables.items():
        types = data.COLUMN_TYPES[name]
        keys = data.SORT_KEYS[name] or []
        schema = TableSchema.make([(c, t, "ascending") if c in keys else
                                   (c, t) for c, t in types.items()])
        path = f"{TABLE_ROOT}/{name}"
        client.create("table", path, recursive=True,
                      attributes={"schema": schema})
        chunks = [ColumnarChunk.from_arrays(
            schema, {c: p[c] for c in types},
            dictionaries={c: data.VOCABULARIES[c] for c in types
                          if c in data.VOCABULARIES},
            device=device) for p in parts]
        publish_table_chunks(client, client.cluster.chunk_store, path,
                             chunks, sorted_by=keys or None, schema=schema)
        del chunks


def _stream_loop(index: int, client, cycle: list, texts: dict, n_subs: int,
                 barrier: threading.Barrier, stop_at: Callable[[], float],
                 traced: bool, out: list) -> None:
    """One closed-loop stream: send, wait for the answer, send the next.
    The k-th query of a kind that stream i sends takes substitution
    (i + k) mod n_subs. A query that raises is recorded with its error
    and counts as failed; the stream goes on."""
    barrier.wait()
    sent_of: dict = {}
    position = 0
    while True:
        sent = time.perf_counter()
        if sent >= stop_at():
            return
        name = cycle[position % len(cycle)]
        position += 1
        k = sent_of.get(name, 0)
        sent_of[name] = k + 1
        sub = (index + k) % n_subs
        rows, error = None, None
        with host_range(f"ytbench.{name}", traced):
            try:
                rows = client.select_rows(texts[name][sub])
            except Exception:           # the stream must keep sending
                error = traceback.format_exc(limit=4)
        done = time.perf_counter()
        stats = client.last_query_statistics
        out.append(Answer(name, sub, sent, done, rows, error,
                          stats.compile_time, stats.execute_time))


def _streams(clients, cycles, texts, n_subs, stop_at, traced) -> tuple:
    """Start every stream on its thread, to run until `stop_at()`; the
    threads, and each stream's list of answers."""
    barrier = threading.Barrier(len(clients))
    outs = [[] for _ in clients]
    threads = [threading.Thread(
        target=_stream_loop, name=f"ytbench-stream-{i}",
        args=(i, c, cycles[i], texts, n_subs, barrier, stop_at, traced,
              outs[i])) for i, c in enumerate(clients)]
    for thread in threads:
        thread.start()
    return threads, outs


@dataclass
class Plan:
    """What a cell's seed fixes before any table exists."""
    config: dict
    data: object                  # the generator module
    queries: dict                 # name -> query file, with "module"
    substitutions: dict           # name -> [values, ...]
    texts: dict                   # name -> [QL text, ...]
    cycles: list                  # per stream, its query sequence
    data_seq: np.random.SeedSequence


def plan(cell_name: str, seed: int, bench: Optional[dict] = None,
         config_overrides: Optional[dict] = None) -> Plan:
    bench = bench or spec.benchmark()
    entry = spec.workload(bench, cell_name)
    config = {**spec.config(entry["config"]), **(config_overrides or {})}
    traffic = spec.traffic(entry["traffic"])
    names = list(dict.fromkeys(traffic["cycle"]))
    queries = {name: spec.query(name) for name in names}
    data_seq, subs_seq, start_seq = seed_sequence(seed).spawn(3)
    subs_rng = np.random.default_rng(subs_seq)
    substitutions = {name: draw_substitutions(
        queries[name], subs_rng, config["substitutions_per_slot"])
        for name in names}
    paths = {t: f"{TABLE_ROOT}/{t}" for t in config["tables"]}
    texts = {name: [queries[name]["text"].format(**paths, **values)
                    for values in substitutions[name]] for name in names}
    cycle = traffic["cycle"]
    first = int(np.random.default_rng(start_seq).integers(len(cycle)))
    cycles = [cycle[(first + i) % len(cycle):] + cycle[:(first + i) %
                                                       len(cycle)]
              for i in range(config["streams"])]
    return Plan(config, spec.data_module(config), queries, substitutions,
                texts, cycles, data_seq)


def generate(p: Plan) -> dict:
    t = time.perf_counter()
    tables = p.data.generate(p.config, p.data_seq)
    log(f"generated the tables in {time.perf_counter() - t:.3f} s")
    return tables


def serve(p: Plan, tables: dict, root: str, device: str) -> list:
    """Set-up on a cluster at `root`: one client per stream, the cache and
    the admission slots sized as the configuration states, the tables
    published, every query warmed up. Returns the streams' clients."""
    import torch

    from ytsaurus_tpu_torch.client import connect
    from ytsaurus_tpu_torch.config import ServingConfig
    clients = [connect(root, device=device)
               for _ in range(p.config["streams"])]
    cluster = clients[0].cluster
    cluster.chunk_cache.capacity_bytes = p.config["chunk_cache_bytes"]
    cluster.chunk_store.codec = p.config["codec"]
    cluster.serving_config = ServingConfig(slots=p.config["admission_slots"])
    t = time.perf_counter()
    _publish(clients[0], p.data, tables, cluster.device)
    written = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, files in os.walk(root) for f in files)
    log(f"built and published the chunks in {time.perf_counter() - t:.3f} "
        f"s; {written} bytes on disk")
    for name in p.queries:
        t = time.perf_counter()
        clients[0].select_rows(p.texts[name][0])
        log(f"first {name} alone in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    warm = [threading.Thread(target=lambda c=c, cy=cy: [
        c.select_rows(p.texts[q][0]) for q in cy]) for c, cy in
        zip(clients, p.cycles)]
    for thread in warm:
        thread.start()
    for thread in warm:
        thread.join()
    if cluster.device.type == "cuda":
        torch.cuda.synchronize()
    log(f"one round of every stream at once in {time.perf_counter() - t:.3f} s")
    return clients


def window(clients: list, p: Plan, seconds: float, traced: bool) -> dict:
    """The measured window: every stream in its closed loop until it
    closes; traced, it closes after TRACE_SECONDS. A query in flight at
    the close finishes (under the profiler, which only then stops: a
    profiler stopped under running queries made them fail). Returns every
    answer, the window's edges on the host's clock, the cache's misses
    inside it and the trace, cut at the close."""
    from ytsaurus_tpu_torch.ops import radix
    cache = clients[0].cluster.chunk_cache
    tracer = DeviceTrace() if traced else None
    if tracer:
        tracer.__enter__()
    launched = dict(radix.launches)
    misses = cache.misses
    opened = time.perf_counter()
    closed = opened + (min(seconds, TRACE_SECONDS) if traced else seconds)
    threads, outs = _streams(clients, p.cycles, p.texts,
                             p.config["substitutions_per_slot"],
                             lambda: closed, traced)
    time.sleep(max(0.0, closed - time.perf_counter()))
    misses = cache.misses - misses
    if tracer:
        tracer.mark_close()
    for thread in threads:
        thread.join()
    launches = {k: radix.launches[k] - launched[k] for k in launched}
    trace = None
    if tracer:
        t = time.perf_counter()
        tracer.__exit__(None, None, None)
        trace = tracer.summary(named=tuple(launches))
        log(f"read the trace in {time.perf_counter() - t:.3f} s")
    return {"answers": [a for out in outs for a in out], "opened": opened,
            "closed": closed, "misses": misses, "trace": trace,
            "launches": launches}


def log_kernels(launches: dict, sent: int, trace: Optional[dict]) -> None:
    """The program's hand-written kernels that the window's queries
    launched (the program's own counters, over every query sent in the
    window) and, traced, their kernels and device seconds inside it."""
    for name, count in launches.items():
        line = f"{name}: {count} launches, {count / max(sent, 1):.2f} a query"
        if trace is not None:
            kernels, seconds = trace["named_ops"][name]
            line += (f"; in the traced window {kernels} kernels, "
                     f"{seconds!r} s on the device")
        log(line)


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool,
             t_start: float, device: str = "cuda",
             config_overrides: Optional[dict] = None,
             bench: Optional[dict] = None) -> Run:
    import torch

    p = plan(cell_name, seed, bench, config_overrides)
    tables = generate(p)
    n_rows = {t: sum(len(next(iter(part.values()))) for part in parts)
              for t, parts in tables.items()}
    reads = {name: q["reads"] for name, q in p.queries.items()}
    rows_read = {name: sum(n_rows[t] for t in r) for name, r in reads.items()}
    bytes_read = {name: sum(n_rows[t] * len(cols) *
                            p.queries[name]["bytes_per_value"]
                            for t, cols in r.items())
                  for name, r in reads.items()}
    root = tempfile.mkdtemp(prefix="ytbench-")
    try:
        clients = serve(p, tables, root, device)
        w = window(clients, p, seconds, traced)
        dev = clients[0].cluster.device
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        kind = torch.cuda.get_device_name(dev) \
            if dev.type == "cuda" else str(dev)
        del clients
    finally:
        shutil.rmtree(root, ignore_errors=True)
    answers, end = w["answers"], w["closed"]
    log_kernels(w["launches"], len(answers), w["trace"])
    run = Run(setup_s=w["opened"] - t_start, window_s=end - w["opened"],
              answers=[a for a in answers if a.done <= end],
              late=[a for a in answers if a.sent < end < a.done],
              rows_read=rows_read, bytes_read=bytes_read,
              cache_misses=w["misses"], memory_peak_bytes=peak,
              trace=w["trace"], device_kind=kind, closed=end,
              attempted=len(answers),
              failed=sum(a.error is not None for a in answers),
              errors=[a.error for a in answers if a.error][:3])
    t = time.perf_counter()
    run.readings = check(answers, p.queries, tables, p.substitutions,
                         np.float64)
    log(f"checked {len(answers)} answers in {time.perf_counter() - t:.3f} s")
    return run


def merged_tables(tables: dict) -> dict:
    """{table: one set of arrays}, each table's chunks concatenated."""
    return {t: parts[0] if len(parts) == 1 else
            {c: np.concatenate([x[c] for x in parts]) for c in parts[0]}
            for t, parts in tables.items()}


def checks(readings: dict, limits: dict) -> dict:
    """{name: {"value": reading, "max"|"min": limit}} for every limit; a
    reading that is not a finite number is given as text."""
    return {name: {"value": readings[name] if np.isfinite(readings[name])
                   else str(readings[name]), **rule}
            for name, rule in limits.items()}


def passes(check: dict) -> bool:
    value = check["value"]
    if isinstance(value, str):
        return False
    return ("max" not in check or value <= check["max"]) and \
        ("min" not in check or value >= check["min"])


def check(answers: list, queries: dict, tables: dict, substitutions: dict,
          dtype) -> dict:
    """The readings `correct` compares: answers checked, queries that
    failed, answers that differ from the reference where the comparison
    is exact, and the largest relative error of a sum or an average."""
    merged = merged_tables(tables)
    wanted = {}
    for name in queries:
        used = sorted({a.sub for a in answers if a.query == name})
        if used:
            got = queries[name]["module"].answers(
                merged, [substitutions[name][i] for i in used], dtype)
            wanted.update({(name, i): g for i, g in zip(used, got)})
    wrong, err, failed, checked = 0, 0.0, 0, 0
    for a in answers:
        if a.error is not None:
            failed += 1
            continue
        w, e = queries[a.query]["module"].compare(a.rows, wanted[(a.query,
                                                                 a.sub)])
        wrong += w
        err = max(err, e)
        checked += 1
    return {"answers": checked, "failed": failed, "wrong_answers": wrong,
            "max_rel_err": err}
