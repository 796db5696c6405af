"""Query coordination: the bottom/front split of a plan and the host
coordinator over many chunks.

Port of the JAX package's `query/coordinator.py`: `split_plan` and its
helpers (`_MERGE_FN`, `_to_double`, `_AvgSubstituter`, `_subst_order`,
`_subst_project`, `_default_project`), `_ordered_scan_direction`, and
`coordinate_and_execute` with `_retry_transient`, `_wrap_lazy_shard`,
`_PrefetchScanner` and `_coalesce_shards`. Analog of the reference's
coordinator algebra (library/query/engine_api/coordinator.h:
GetDistributedQueryPattern, CoordinateAndExecute): a plan is split into a
`bottom` query that runs unchanged on every shard and a `front` query that
merges the partial results. Partial aggregate states are re-aggregated
with merge functions (count merges by SUM, avg decomposes into sum and
count state columns), ORDER BY re-sorts the per-shard top-K, and OFFSET
and LIMIT apply only at the front.

`coordinate_and_execute` runs the bottom over each shard (a chunk, or a
callable that stages one) on one evaluator's device and the front over
the concatenated partials. Shard programs run without reading their row
counts; the counts cross to the host as one stacked transfer
(`evaluator.finish_all`) after the last shard, or per wave when a LIMIT
may stop the scan early. Lazy shards stage on two prefetch threads; a
thread names the evaluator's device explicitly (PyTorch's current CUDA
device is per thread), and a host → device copy there blocks that
thread, not the evaluator's.
"""

from __future__ import annotations

import contextvars
import time
from dataclasses import replace
from typing import Mapping, Optional, Sequence

import torch

from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk, concat_chunks
from ytsaurus_tpu_torch.config import retry_policy
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.query import ir
from ytsaurus_tpu_torch.query.engine.evaluator import Evaluator, finish_all
from ytsaurus_tpu_torch.schema import EValueType
from ytsaurus_tpu_torch.utils import failpoints
from ytsaurus_tpu_torch.utils.tracing import NULL_SPAN, stage

# How each aggregate's partial state is merged at the front.
_MERGE_FN = {"sum": "sum", "count": "sum", "min": "min", "max": "max",
             "first": "first"}

# Per-shard fault sites: materialize covers staging a lazy shard, execute
# the shard's bottom-query program.
_FP_MATERIALIZE = failpoints.register_site(
    "query.shard_materialize",
    error=lambda s: YtError(f"injected shard staging failure at {s}",
                            code=EErrorCode.TransportError))
_FP_EXECUTE = failpoints.register_site(
    "query.shard_execute",
    error=lambda s: YtError(f"injected shard execution failure at {s}",
                            code=EErrorCode.TransportError))

# Errors worth a per-shard retry: transport-shaped. Application errors
# (type, parse, execution) are deterministic and surface unchanged.
_TRANSIENT_CODES = frozenset({EErrorCode.TransportError,
                              EErrorCode.RpcTimeout,
                              EErrorCode.PeerUnavailable})


def _is_transient(err: Exception) -> bool:
    return isinstance(err, OSError) or (
        isinstance(err, YtError) and err.code in _TRANSIENT_CODES)


def _retry_transient(fn, site: "Optional[failpoints.FailpointSite]" = None,
                     token=None, span_name: Optional[str] = None,
                     stats=None, **span_tags):
    """Jittered exponential backoff retry of transient failures (policy
    `query_shard`) around one shard step. A token past its deadline stops
    the retries. `span_name` opens one stage per attempt (a child span
    tagged `attempt=`, and a profiler range while a profiler session is
    live; no statistics field); `stats.retries` counts the extra
    attempts."""
    policy = retry_policy("query_shard")
    for attempt in range(policy.attempts):
        try:
            with stage(None, None, span_name, attempt=attempt, **span_tags) \
                    if span_name is not None else NULL_SPAN:
                if token is not None:
                    token.check()
                if site is not None:
                    site.hit()
                return fn()
        except (OSError, YtError) as err:
            if not _is_transient(err) or attempt + 1 >= policy.attempts:
                raise
            if stats is not None:
                stats.retries += 1
            time.sleep(policy.delay(attempt))


def _wrap_lazy_shard(shard, token=None, index: Optional[int] = None,
                     stats=None):
    """Lazy shards retry their own staging. The caller's trace context is
    captured: staging runs on prefetch threads, whose context would be
    empty. Their `stage_time` is the query thread's wait for them
    (`_PrefetchScanner.get`), not the prefetch threads' seconds."""
    if not callable(shard):
        return shard
    captured = contextvars.copy_context()

    def staged():
        return _retry_transient(shard, site=_FP_MATERIALIZE, token=token,
                                span_name="coordinator.shard_stage",
                                stats=stats, shard=index)

    return lambda: captured.run(staged)


def split_plan(plan: ir.Query) -> tuple[ir.Query, ir.FrontQuery]:
    """Split into (bottom, front) — ref GetDistributedQueryPattern."""
    limit_for_bottom = None
    if plan.limit is not None:
        limit_for_bottom = plan.offset + plan.limit

    if plan.window is not None:
        # Window functions need COMPLETE partitions: per-shard windows
        # over arbitrary row placement would be wrong, so the bottom
        # only filters and the window stage runs at the front over the
        # merged rowset (the shuffled SPMD path instead co-partitions by
        # the PARTITION BY key — parallel/distributed.py).
        bottom = replace(plan, window=None, having=None, order=None,
                         project=None, offset=0, limit=None)
        front = ir.FrontQuery(
            schema=bottom.output_schema(), window=plan.window,
            order=plan.order, project=plan.project,
            offset=plan.offset, limit=plan.limit)
        return bottom, front

    if plan.group is not None and any(
            a.function == "cardinality" for a in plan.group.aggregate_items):
        # Distinct counts cannot merge from per-shard counts; ship the
        # filtered rows and run the whole group stage at the front.
        bottom = replace(plan, group=None, having=None, order=None,
                         project=None, offset=0, limit=None)
        front = ir.FrontQuery(
            schema=bottom.output_schema(), group=plan.group,
            having=plan.having, order=plan.order, project=plan.project,
            offset=plan.offset, limit=plan.limit)
        return bottom, front

    if plan.group is not None:
        bottom_aggs: list[ir.AggregateItem] = []
        avg_map: dict[str, tuple[str, str]] = {}
        argfn_front: dict[str, tuple[str, str]] = {}
        for agg in plan.group.aggregate_items:
            if agg.function in ("argmin", "argmax"):
                v_name, b_name = f"{agg.name}__v", f"{agg.name}__b"
                bottom_aggs.append(ir.AggregateItem(
                    name=v_name, function=agg.function,
                    argument=agg.argument, type=agg.type,
                    state_type=agg.state_type,
                    by_argument=agg.by_argument))
                bottom_aggs.append(ir.AggregateItem(
                    name=b_name,
                    function="min" if agg.function == "argmin" else "max",
                    argument=agg.by_argument, type=agg.by_argument.type,
                    state_type=agg.by_argument.type))
                argfn_front[agg.name] = (v_name, b_name)
                continue
            if agg.function == "avg":
                s_name, c_name = f"{agg.name}__s", f"{agg.name}__c"
                arg = agg.argument
                bottom_aggs.append(ir.AggregateItem(
                    name=s_name, function="sum",
                    argument=_to_double(arg), type=EValueType.double,
                    state_type=EValueType.double))
                bottom_aggs.append(ir.AggregateItem(
                    name=c_name, function="count", argument=arg,
                    type=EValueType.int64, state_type=EValueType.int64))
                avg_map[agg.name] = (s_name, c_name)
            else:
                bottom_aggs.append(agg)
        bottom = replace(plan, group=ir.GroupClause(
            group_items=plan.group.group_items,
            aggregate_items=tuple(bottom_aggs), totals=False),
            having=None, order=None, project=None, offset=0, limit=None)
        inter_schema = bottom.output_schema()

        front_group_items = tuple(
            ir.NamedExpr(name=item.name,
                         expr=ir.TReference(type=item.expr.type, name=item.name))
            for item in plan.group.group_items)
        # Keep the ORIGINAL declaration order: output schemas must match the
        # single-node plan regardless of how states were decomposed.
        by_name = {a.name: a for a in plan.group.aggregate_items}
        front_agg_list = []
        for agg in plan.group.aggregate_items:
            if agg.name in argfn_front:
                v_name, b_name = argfn_front[agg.name]
                front_agg_list.append(ir.AggregateItem(
                    name=agg.name, function=agg.function,
                    argument=ir.TReference(type=agg.type, name=v_name),
                    type=agg.type, state_type=agg.state_type,
                    by_argument=ir.TReference(
                        type=agg.by_argument.type, name=b_name)))
            elif agg.function == "avg":
                s_name, c_name = avg_map[agg.name]
                for state_name, state_fn, ty in (
                        (s_name, "sum", EValueType.double),
                        (c_name, "sum", EValueType.int64)):
                    front_agg_list.append(ir.AggregateItem(
                        name=state_name, function=state_fn,
                        argument=ir.TReference(type=ty, name=state_name),
                        type=ty, state_type=ty))
            else:
                front_agg_list.append(ir.AggregateItem(
                    name=agg.name, function=_MERGE_FN[agg.function],
                    argument=ir.TReference(type=agg.state_type, name=agg.name),
                    type=agg.type, state_type=agg.state_type))
        front_aggs = tuple(front_agg_list)

        subst = _AvgSubstituter(avg_map)
        front = ir.FrontQuery(
            schema=inter_schema,
            group=ir.GroupClause(group_items=front_group_items,
                                 aggregate_items=front_aggs,
                                 totals=plan.group.totals),
            having=subst(plan.having),
            order=_subst_order(plan.order, subst),
            project=_subst_project(plan.project, subst,
                                   plan) if plan.project else _default_project(plan, subst),
            offset=plan.offset, limit=plan.limit)
        return bottom, front

    if plan.order is not None:
        # Bottom keeps the full row set (identity projection) but can cut to
        # the per-shard top-(offset+limit); the front re-sorts and projects.
        bottom = replace(plan, having=None, project=None, offset=0,
                         limit=limit_for_bottom)
        front = ir.FrontQuery(
            schema=plan.schema, order=plan.order, project=plan.project,
            offset=plan.offset, limit=plan.limit)
        return bottom, front

    bottom = replace(plan, offset=0, limit=limit_for_bottom)
    front = ir.FrontQuery(schema=bottom.output_schema(), offset=plan.offset,
                          limit=plan.limit)
    return bottom, front


def _to_double(expr: ir.TExpr) -> ir.TExpr:
    if expr.type is EValueType.double:
        return expr
    return ir.TFunction(type=EValueType.double, name="double", args=(expr,))


class _AvgSubstituter:
    """Rewrites references to an avg slot into state_sum / state_count."""

    def __init__(self, avg_map: dict[str, tuple[str, str]]):
        self.avg_map = avg_map

    def __call__(self, expr: Optional[ir.TExpr]) -> Optional[ir.TExpr]:
        if expr is None or not self.avg_map:
            return expr
        return ir.map_expr(expr, self._leaf)

    def _leaf(self, e: ir.TExpr) -> ir.TExpr:
        if isinstance(e, ir.TReference) and e.name in self.avg_map:
            s_name, c_name = self.avg_map[e.name]
            s_ref = ir.TReference(type=EValueType.double, name=s_name)
            c_ref = ir.TReference(type=EValueType.int64, name=c_name)
            return ir.TBinary(type=EValueType.double, op="/", lhs=s_ref,
                              rhs=_to_double(c_ref))
        return e


def _subst_order(order: Optional[ir.OrderClause],
                 subst: _AvgSubstituter) -> Optional[ir.OrderClause]:
    if order is None:
        return None
    return ir.OrderClause(items=tuple(
        ir.OrderItem(expr=subst(i.expr), descending=i.descending)
        for i in order.items))


def _subst_project(project: ir.ProjectClause, subst: _AvgSubstituter,
                   plan: ir.Query) -> ir.ProjectClause:
    return ir.ProjectClause(items=tuple(
        ir.NamedExpr(name=i.name, expr=subst(i.expr)) for i in project.items))


def _default_project(plan: ir.Query, subst: _AvgSubstituter
                     ) -> Optional[ir.ProjectClause]:
    """SELECT * with GROUP BY: reconstruct keys + original aggregate values
    (avg must be divided back out of its state columns)."""
    if not subst.avg_map:
        return None
    items = []
    for item in plan.group.group_items:
        items.append(ir.NamedExpr(
            name=item.name,
            expr=ir.TReference(type=item.expr.type, name=item.name)))
    for agg in plan.group.aggregate_items:
        items.append(ir.NamedExpr(
            name=agg.name,
            expr=subst(ir.TReference(type=agg.type, name=agg.name))))
    return ir.ProjectClause(items=tuple(items))


def _ordered_scan_direction(plan: ir.Query,
                            range_ordered_by) -> Optional[str]:
    """'asc'/'desc' when ORDER BY + LIMIT can stop scanning range-ordered
    shards early: every order item is a bare reference, the referenced
    names form a prefix of the shard-range key, and the direction is
    uniform.  None otherwise."""
    if not range_ordered_by or plan.order is None or \
            plan.limit is None or plan.group is not None:
        return None
    items = plan.order.items
    if not items or not all(isinstance(it.expr, ir.TReference)
                            for it in items):
        return None
    if len({it.descending for it in items}) != 1:
        return None
    names = [it.expr.name for it in items]
    if names != list(range_ordered_by)[: len(names)]:
        return None
    return "desc" if items[0].descending else "asc"


class _PrefetchScanner:
    """Ordered prefetch (ref engine_api/coordinator.h:81-90, scanOrder +
    prefetch): while shard i evaluates, shards i+1..i+window stage on
    two background threads. An early-exit scan starts at window 1 and
    doubles it each time the scan continues, up to `max_window`.

    Each staging call runs with `device` as the thread's current CUDA
    device, so that a shard staged onto "cuda" lands on the evaluator's
    card and not on cuda:0."""

    def __init__(self, shards, window: int = 1, max_window: int = 4,
                 stats=None, count_rows: bool = False,
                 device: Optional[torch.device] = None):
        from concurrent.futures import ThreadPoolExecutor
        self.shards = list(shards)
        self.window = max(window, 1)
        self.max_window = max_window
        self.stats = stats
        self.count_rows = count_rows
        self.device = device
        self._futures: dict = {}
        self._executor = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="shard-prefetch")

    def _stage(self, shard):
        if self.device is not None and self.device.type == "cuda":
            with torch.cuda.device(self.device):
                return shard()
        return shard()

    def _submit(self, i: int) -> None:
        if 0 <= i < len(self.shards) and i not in self._futures:
            shard = self.shards[i]
            if callable(shard):
                # Counted at submit: a prefetched shard the exit then
                # skips was still staged.
                if self.stats is not None and self.count_rows:
                    self.stats.shards_staged += 1
                self._futures[i] = self._executor.submit(self._stage, shard)
            else:
                from concurrent.futures import Future
                fut: Future = Future()
                fut.set_result(shard)
                self._futures[i] = fut

    def get(self, i: int) -> ColumnarChunk:
        self._submit(i)
        for j in range(i + 1, i + 1 + self.window):
            self._submit(j)
        with stage(self.stats, "stage_time"):
            chunk = self._futures.pop(i).result()
        if self.stats is not None and self.count_rows:
            self.stats.rows_read += chunk.row_count
            self.stats.bytes_read += chunk.nbytes
        return chunk

    def feedback(self) -> None:
        """The scan continued past a shard: stage further ahead."""
        self.window = min(self.window * 2, self.max_window)

    def close(self) -> None:
        self._executor.shutdown(wait=False, cancel_futures=True)


def _materialize(shard) -> ColumnarChunk:
    return shard() if callable(shard) else shard


def coordinate_and_execute(
        plan: ir.Query,
        chunks: Sequence,
        foreign_chunks: Optional[Mapping[str, ColumnarChunk]] = None,
        evaluator: Optional[Evaluator] = None,
        merge_shards_below: int = 0,
        range_ordered_by: Optional[Sequence[str]] = None,
        stats=None, token=None) -> ColumnarChunk:
    """Host-coordinated fan-out: the bottom query per shard, the partial
    results concatenated, the front merge over them (ref
    CoordinateAndExecute, engine_api/coordinator.cpp).

    `chunks` are ColumnarChunks on the evaluator's device or zero-argument
    callables that stage one there (lazy shards, staged through the
    prefetcher, so that an ordered LIMIT stages only the shards it reads).

    `merge_shards_below` > 0 coalesces shards so that no program runs over
    fewer rows; 0 keeps one program per shard.

    `range_ordered_by`: key columns by which the shards are range-ordered.
    ORDER BY <key prefix> LIMIT then scans from the matching end and stops
    once offset + limit rows passed the filter.

    `token` (query/serving.CancellationToken) is checked before each
    shard's staging and execution. `evaluator` defaults to one on the
    card."""
    evaluator = evaluator or Evaluator()
    if not chunks:
        raise YtError("coordinate_and_execute: no input shards",
                      code=EErrorCode.QueryExecutionError)
    if token is not None:
        token.check()
    lazy = any(callable(c) for c in chunks)
    if lazy:
        chunks = [_wrap_lazy_shard(c, token=token, index=i, stats=stats)
                  for i, c in enumerate(chunks)]
    # The early-exit budget, decided before any coalescing. No early exit
    # for window plans: every row of a partition feeds the front's window.
    needed = None
    scan_direction = None
    if plan.limit is not None and plan.group is None and \
            plan.window is None:
        if plan.order is None:
            needed = plan.offset + plan.limit
        else:
            scan_direction = _ordered_scan_direction(plan,
                                                     range_ordered_by)
            if scan_direction is not None:
                needed = plan.offset + plan.limit
    if merge_shards_below > 0 and len(chunks) > 1 and not lazy:
        # An ordered exit only needs a group to hold the scan budget;
        # merging further would drag unwanted rows into the first program.
        chunks = _coalesce_shards(
            chunks, merge_shards_below if scan_direction is None
            else max(needed, 1))
    if stats is not None:
        stats.shards_total += len(chunks)
        if not lazy:
            stats.rows_read += sum(c.row_count for c in chunks)
            stats.bytes_read += sum(c.nbytes for c in chunks)
    if len(chunks) == 1:
        with stage(stats, "stage_time"):
            chunk = _materialize(chunks[0])
        if lazy and stats is not None:
            stats.shards_staged += 1
            stats.rows_read += chunk.row_count
            stats.bytes_read += chunk.nbytes
        result = _retry_transient(
            lambda: evaluator.run_plan(plan, chunk, foreign_chunks,
                                       stats=stats, token=token),
            site=_FP_EXECUTE, token=token,
            span_name="coordinator.shard", stats=stats, shard=0)
    else:
        bottom, front = split_plan(plan)
        # Ordered scan: shards range-ordered by the ORDER BY prefix are
        # walked from the matching end; once offset + limit rows passed
        # the filter, no unscanned shard holds a better-ranked row.
        scan_chunks = list(chunks)
        if scan_direction == "desc":
            scan_chunks.reverse()
        # Lazy shards coalesce after staging (their row counts are unknown
        # before); an early exit caps a group at the scan budget.
        group_threshold = 0
        if lazy and merge_shards_below > 0:
            group_threshold = max(needed, 1) if needed is not None \
                else merge_shards_below
        scanner = _PrefetchScanner(
            scan_chunks, window=1 if needed is not None else 2,
            stats=stats, count_rows=lazy,
            device=getattr(evaluator, "device", None))
        # Without an early exit the counts never gate control flow: every
        # shard program runs without a read, and the counts cross once,
        # after the last. An early-exit scan reads them per wave, one
        # stacked transfer a wave; the wave doubles (to 4) once two waves
        # declined to exit. Evaluators without run_plan_async keep the
        # per-shard read.
        deferred = hasattr(evaluator, "run_plan_async")
        early_async = deferred and needed is not None
        partials = []
        wave: list = []
        wave_budget = 1
        waves_done = 0
        try:
            collected = 0
            group: list = []
            group_rows = 0
            for i in range(len(scan_chunks)):
                if token is not None:
                    # An expired query stops here: unscanned shards are
                    # never staged and their programs never run.
                    token.check()
                chunk = scanner.get(i)
                if group_threshold > 0:
                    group.append(chunk)
                    group_rows += chunk.row_count
                    if group_rows < group_threshold and \
                            i + 1 < len(scan_chunks):
                        continue
                    chunk = concat_chunks(group) if len(group) > 1 \
                        else group[0]
                    group, group_rows = [], 0
                if deferred:
                    pending = _retry_transient(
                        lambda c=chunk: evaluator.run_plan_async(
                            bottom, c, foreign_chunks, stats=stats,
                            token=token),
                        site=_FP_EXECUTE, token=token,
                        span_name="coordinator.shard", stats=stats,
                        shard=i)
                if deferred and needed is None:
                    partials.append(pending)
                    scanner.feedback()
                    continue
                if early_async:
                    wave.append(pending)
                    if len(wave) < wave_budget and \
                            i + 1 < len(scan_chunks):
                        continue
                    finished = finish_all(wave)
                    wave = []
                    waves_done += 1
                    if waves_done >= 2:
                        wave_budget = min(wave_budget * 2, 4)
                    partials.extend(finished)
                    collected += sum(p.row_count for p in finished)
                    if collected >= needed:
                        if stats is not None:
                            stats.shards_skipped += \
                                len(scan_chunks) - (i + 1)
                        break
                    scanner.feedback()
                    continue
                partial = _retry_transient(
                    lambda c=chunk: evaluator.run_plan(
                        bottom, c, foreign_chunks, stats=stats,
                        token=token),
                    site=_FP_EXECUTE, token=token,
                    span_name="coordinator.shard", stats=stats, shard=i)
                partials.append(partial)
                collected += partial.row_count
                if needed is not None and collected >= needed:
                    if stats is not None:
                        stats.shards_skipped += len(scan_chunks) - (i + 1)
                    break
                scanner.feedback()
        finally:
            scanner.close()
        if deferred and needed is None:
            partials = finish_all(partials)
        # The merge's own seconds (the partials' concatenation) are
        # dispatch_time: device work issued from the host.
        with stage(stats, "dispatch_time", "coordinator.front_merge",
                   partials=len(partials)):
            merged = concat_chunks(
                [p.slice_rows(0, p.row_count) for p in partials])
            result = evaluator.run_plan(front, merged, stats=stats,
                                        token=token)
    if stats is not None:
        stats.rows_written += result.row_count
    return result


def _coalesce_shards(chunks: Sequence[ColumnarChunk],
                     min_rows: int) -> list[ColumnarChunk]:
    groups: list[list[ColumnarChunk]] = []
    current: list[ColumnarChunk] = []
    current_rows = 0
    for chunk in chunks:
        current.append(chunk)
        current_rows += chunk.row_count
        if current_rows >= min_rows:
            groups.append(current)
            current, current_rows = [], 0
    if current:
        if groups:
            groups[-1].extend(current)
        else:
            groups.append(current)
    return [concat_chunks(g) if len(g) > 1 else g[0] for g in groups]
