"""Exhaustive batched nearest-neighbour search over a vector column.

Port of the JAX package's `query/vector.py` (`METRICS`, `_kernel`,
`batched_nearest`). The query language's `NEAREST(col, ?, k)` needs none of
this: it is `ORDER BY <distance>(col, ?) LIMIT k` through the ordinary
select path (the distance functions of query/engine/expr.py). This module is
the batched form: many query vectors against one chunk in one
`(batch, dim) @ (dim, capacity)` product, then a top-k per query.

The product runs in full float32, as the reference computes it on the CPU:
the module never changes `torch.backends.cuda.matmul.allow_tf32` or the
float32 matmul precision, and the caller's settings (torch's defaults keep
TF32 off) decide. Ties at the k-th score go to the lowest row index, the
order `lax.top_k` gives (`topk_lowest_index`).

`NearestBatcher` is the serving gateway's fast path on top (the
reference's `NearestBatcher` and `_NearestBatch`): co-admitted NEAREST
requests on one (table, column, metric, timestamp) coalesce inside a
flush window and run as ONE `batched_nearest` call on the cluster's
device, then each caller takes its own rows. Sensors publish under
`/query/vector`; per-pool usage folds into query/accounting as
`nearest_*` fields. Not ported: `nearest_trace_count`, which counts JAX
traces (the port traces nothing).
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ytsaurus_tpu_torch.chunks.columnar import next_pow2
from ytsaurus_tpu_torch.config import ServingConfig
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_for
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.query.accounting import get_accountant
from ytsaurus_tpu_torch.query.engine.lowering import topk_lowest_index
from ytsaurus_tpu_torch.schema import VectorType
from ytsaurus_tpu_torch.utils import sanitizers
from ytsaurus_tpu_torch.utils.profiling import Profiler
from ytsaurus_tpu_torch.utils.tracing import child_span

#: Scores are "bigger is better" for every metric, so one top-k serves all
#: three; l2 and cosine negate back to distances on the way out.
METRICS = ("l2", "cosine", "dot")

_BATCH_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
_LATENCY_BOUNDS = (0.0002, 0.0005, 0.001, 0.002, 0.005, 0.01, 0.025,
                   0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0)


def nearest_scores(plane: torch.Tensor, valid: torch.Tensor,
                   queries: torch.Tensor, metric: str) -> torch.Tensor:
    """(cap, dim) plane × (B, dim) queries → (B, cap) scores, invalid rows
    at -inf. Every metric derives from the one `queries @ plane.T`
    product (L2 by the norm trick)."""
    q = queries.to(torch.float32)
    x = plane.to(torch.float32)
    dot = q @ x.T
    if metric == "dot":
        score = dot
    elif metric == "cosine":
        nq = torch.sqrt((q * q).sum(dim=1))[:, None]
        nx = torch.sqrt((x * x).sum(dim=1))[None, :]
        denom = nq * nx
        score = -torch.where(denom > 0.0, 1.0 - dot / denom,
                             torch.ones_like(dot))
    else:
        nq2 = (q * q).sum(dim=1)[:, None]
        nx2 = (x * x).sum(dim=1)[None, :]
        score = -torch.sqrt(torch.clamp(nq2 - 2.0 * dot + nx2, min=0.0))
    return torch.where(valid[None, :], score,
                       torch.full_like(score, float("-inf")))


def top_rows(score: torch.Tensor, k: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, cap) scores → the k best per row, best first, ties toward the
    lowest row index: (values, row indices), each (B, k)."""
    idx = topk_lowest_index(score, k)
    vals = score.gather(1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


def batched_nearest(chunk, column: str, queries: Sequence[Sequence[float]],
                    k: int, metric: str = "l2",
                    device: "str | torch.device" = DEFAULT_DEVICE) -> list:
    """Exhaustive nearest neighbours of each query vector in one chunk.

    Returns, per query, up to `k` (row_index, measure) pairs in rank
    order: the measure is the distance (l2, cosine; ascending) or the
    similarity (dot; descending). The batch pads to a power of two with
    zero vectors and k to a power of two, as the reference pads them;
    rows past the matches (score -inf) are dropped."""
    if metric not in METRICS:
        raise YtError(f"Unknown NEAREST metric {metric!r}",
                      code=EErrorCode.QueryTypeError)
    dev = resolve_for(chunk, device, "batched_nearest")
    col = chunk.columns.get(column)
    if col is None or not isinstance(col.type, VectorType):
        raise YtError(f"Column {column!r} is not a vector column",
                      code=EErrorCode.QueryTypeError)
    dim = col.type.dim
    b = len(queries)
    if b == 0:
        return []
    q_np = np.zeros((next_pow2(b, floor=1), dim), dtype=np.float32)
    for i, q in enumerate(queries):
        arr = np.asarray(q, dtype=np.float32)
        if arr.shape != (dim,):
            raise YtError(
                f"Query vector {i} has shape {arr.shape}, expected ({dim},)",
                code=EErrorCode.QueryTypeError)
        if not np.isfinite(arr).all():
            raise YtError(f"Non-finite component in query vector {i}",
                          code=EErrorCode.QueryTypeError)
        q_np[i] = arr
    valid = col.valid & (torch.arange(col.capacity, device=dev)
                         < chunk.row_count)
    k_static = min(next_pow2(max(k, 1), floor=1), col.capacity)
    score = nearest_scores(col.data, valid, torch.from_numpy(q_np).to(dev),
                           metric)
    vals, idx = top_rows(score, k_static)
    vals_np = vals.cpu().numpy()
    idx_np = idx.cpu().numpy()
    sign = 1.0 if metric == "dot" else -1.0
    out = []
    for i in range(b):
        hits = []
        for j in range(min(k, k_static)):
            if not np.isfinite(vals_np[i, j]):
                break                      # fewer than k valid rows
            hits.append((int(idx_np[i, j]), sign * float(vals_np[i, j])))
        out.append(hits)
    return out


def rows_at(chunk, indices) -> dict:
    """{row index: row dict} of the given rows of a chunk: only the hit
    rows cross to the host, never the whole table."""
    return {i: chunk.slice_rows(i, i + 1).to_rows()[0]
            for i in sorted(indices)}


class _NearestBatch:
    """One NEAREST cohort: member query vectors + shared completion
    state (the _Batch shape from serving.py: one event wakes the whole
    cohort; the deadline is the cohort max)."""

    __slots__ = ("queries", "ks", "users", "deadline", "pool", "user",
                 "client", "done", "results", "error")

    def __init__(self, token):
        self.queries: list = []
        self.ks: list[int] = []
        self.users: list = []
        self.deadline = token.deadline
        self.pool = token.pool
        self.user = token.user
        self.client = None
        self.done = threading.Event()
        self.results: "Optional[list]" = None
        self.error: Optional[BaseException] = None

    def join(self, token) -> None:
        if self.deadline is not None:
            self.deadline = None if token.deadline is None \
                else max(self.deadline, token.deadline)

    def flush_token(self):
        from ytsaurus_tpu_torch.query.serving import CancellationToken
        return CancellationToken(self.deadline, pool=self.pool,
                                 user=self.user)


class NearestBatcher:
    """Continuous micro-batching of NEAREST queries (the LookupBatcher
    pattern over the batch dimension of one distance matmul).

    Requests enqueue their query vector into the pending cohort for
    their (table, column, metric, timestamp) and block on the cohort's
    completion event; the flusher thread lets each arriving cohort
    accumulate (growth-stable poll bounded by `flush_window_ms`), then
    executes it as ONE admitted batched `(batch, dim) @ (dim, rows)`
    matmul + per-row top-k over the table snapshot, waking the whole
    cohort with one event.  k is the cohort max's pow2 bucket, so mixed
    k's share the kernel and each member slices its own prefix."""

    _POLL_SECONDS = 0.0002
    _IDLE_EXIT_SECONDS = 30.0

    def __init__(self, config: ServingConfig, admission):
        self.config = config
        self.admission = admission
        # guards: _batches, _flusher, requests_n, batches_n, batched_queries_n
        self._cond = sanitizers.register_condition(
            "vector.NearestBatcher._cond")
        self._batches: "dict[tuple, _NearestBatch]" = {}
        self._flusher: Optional[threading.Thread] = None
        self.requests_n = 0
        self.batches_n = 0
        self.batched_queries_n = 0
        prof = Profiler("/query/vector")
        self.requests = prof.counter("requests")
        self.batches = prof.counter("batches")
        self.batched_queries = prof.counter("batched_queries")
        self.batch_size_hist = prof.histogram("batch_size",
                                              bounds=_BATCH_BOUNDS)
        self.latency_hist = prof.histogram("latency_seconds",
                                           bounds=_LATENCY_BOUNDS)

    # -- request path ----------------------------------------------------------

    def nearest(self, client, path: str, column: str,
                query_vector: Sequence[float], k: int, metric: str,
                timestamp: int, token) -> list:
        """One caller's NEAREST: join the cohort, wait for its flush,
        scatter this member's ranked (row_index, measure) hits."""
        if metric not in METRICS:
            raise YtError(f"Unknown NEAREST metric {metric!r}",
                          code=EErrorCode.QueryTypeError)
        if k <= 0:
            raise YtError("NEAREST expects k >= 1",
                          code=EErrorCode.QueryTypeError)
        t0 = time.monotonic()
        bkey = (path, column, metric, timestamp)
        with self._cond:
            self.requests_n += 1
            self.requests.increment()
            batch = self._batches.get(bkey)
            if batch is None:
                batch = self._batches[bkey] = _NearestBatch(token)
                batch.client = client
            else:
                batch.join(token)
            member = len(batch.queries)
            batch.queries.append(list(query_vector))
            batch.ks.append(int(k))
            batch.users.append(token.user)
            if self._flusher is None or not self._flusher.is_alive():
                self._flusher = threading.Thread(
                    target=self._flusher_loop, daemon=True,
                    name="vector-flusher")
                self._flusher.start()
            self._cond.notify()
        if not batch.done.wait(timeout=token.remaining()):
            raise YtError(
                "deadline exceeded waiting for the NEAREST batch",
                code=EErrorCode.DeadlineExceeded,
                attributes={"table": path})
        if batch.error is not None:
            raise batch.error
        self.latency_hist.record(time.monotonic() - t0)
        return batch.results[member]

    # -- the flusher thread ----------------------------------------------------

    def _flusher_loop(self) -> None:
        while True:
            with self._cond:
                while not self._batches:
                    if not self._cond.wait(
                            timeout=self._IDLE_EXIT_SECONDS) \
                            and not self._batches:
                        self._flusher = None
                        return
            self._accumulate()
            with self._cond:
                taken, self._batches = self._batches, {}
            for (path, column, metric, timestamp), batch in taken.items():
                self._flush(path, column, metric, timestamp, batch)

    def _accumulate(self) -> None:
        window = self.config.flush_window_ms / 1000.0
        if window <= 0:
            return
        deadline = time.monotonic() + window
        prev = -1
        while time.monotonic() < deadline:
            with self._cond:
                n = sum(len(b.queries) for b in self._batches.values())
            if n == prev:
                return
            prev = n
            time.sleep(self._POLL_SECONDS)

    # -- batch execution -------------------------------------------------------

    def _flush(self, path, column, metric, timestamp,
               batch: _NearestBatch) -> None:
        token = batch.flush_token()
        try:
            state = self.admission.admit(token, batch.pool)
        except BaseException as exc:
            self._fail(batch, exc)
            return
        t0 = time.monotonic()
        try:
            with child_span("vector.batch_flush", table=path,
                            cohort=len(batch.queries)):
                self._flush_admitted(path, column, metric, timestamp,
                                     batch, token)
        except BaseException as exc:  # noqa: BLE001 — relayed to waiters
            self._fail(batch, exc)
            if not isinstance(exc, Exception):
                raise
        finally:
            self.admission.release(state, time.monotonic() - t0)

    def _flush_admitted(self, path, column, metric, timestamp,
                        batch: _NearestBatch, token) -> None:
        token.check()
        chunk = self._table_chunk(batch.client, path, timestamp)
        with self._cond:
            self.batches_n += 1
            self.batched_queries_n += len(batch.queries)
        self.batches.increment()
        self.batched_queries.increment(len(batch.queries))
        self.batch_size_hist.record(len(batch.queries))
        k_max = max(batch.ks)
        # ONE batched matmul for the whole cohort; each member slices
        # its own k prefix out of the shared k_max ranking.
        ranked = batched_nearest(chunk, column, batch.queries, k_max,
                                 metric=metric,
                                 device=batch.client.cluster.device)
        pool = batch.pool or self.config.default_pool
        accountant = get_accountant()
        accountant.observe_nearest_batch(pool, batch.user)
        for user in batch.users:
            accountant.observe_nearest(pool, user,
                                       rows_scanned=chunk.row_count)
        rows = rows_at(chunk, {row_idx for member, k in enumerate(batch.ks)
                               for row_idx, _ in ranked[member][:k]})
        results = []
        for member, k in enumerate(batch.ks):
            hits = []
            for row_idx, measure in ranked[member][:k]:
                row = dict(rows[row_idx])
                row["$distance"] = measure
                hits.append(row)
            results.append(hits)
        batch.results = results
        batch.done.set()

    @staticmethod
    def _table_chunk(client, path: str, timestamp: int):
        """The table's visible rowset: concat of per-tablet MVCC
        snapshots (tablets memoize these per flush generation, so
        steady-state flushes reuse device planes)."""
        from ytsaurus_tpu_torch.chunks.columnar import concat_chunks
        tablets = client._mounted_tablets(path)
        return concat_chunks([t.read_snapshot(timestamp)
                              for t in tablets])

    @staticmethod
    def _fail(batch: _NearestBatch, exc: BaseException) -> None:
        batch.error = exc
        batch.done.set()

    def snapshot(self) -> dict:
        return {"requests": self.requests_n,
                "batches": self.batches_n,
                "batched_queries": self.batched_queries_n}
