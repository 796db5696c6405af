"""The query evaluator: plan + chunk → result chunk, eagerly in torch.

Port of the JAX package's `query/engine/evaluator.py` (`Evaluator.run_plan`,
`run_plan_async`, `_PendingResult.finish`, `finish_all`, `_project_chunk`,
the join cascade with `_initial_namespace` / `_extend_namespace`, WITH
TOTALS with `_make_totals_plan`, `_typed_null` and `_zero_value`,
`select_rows`). PyTorch runs eagerly, so the JAX evaluator's compile
cache, AOT layers, tiering, compile observatory and buffer donation have
no counterpart here.

A run plan's output row count stays on the device until it is read:
`run_plan_async` returns the pending result without reading it, and
`finish_all` reads the counts of many pending results as one stacked
device → host transfer (the coordinator's shard fan-out). `count_reads()`
counts these reads: one per `finish` of a lone result, one per stacked
`finish_all`. The staged programs' own reads (a dense GROUP BY's key
range, the radix sort's digit check) are not among them.

Joins run first, in the planner's order (query/planner.py) when there are
several, each widening the namespace (query/engine/joins.py); the rest of
the plan runs over the joined chunk. A WITH TOTALS plan runs twice, the
second time as the grand-total plan, and the totals row comes last.
"""

from __future__ import annotations

import time
from dataclasses import replace as dc_replace
from typing import Mapping, Optional, Sequence

import torch

from ytsaurus_tpu_torch.chunks.columnar import Column, ColumnarChunk, concat_chunks
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_device, same_device
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.query import ir, planner
from ytsaurus_tpu_torch.query.builder import build_query
from ytsaurus_tpu_torch.query.engine.joins import execute_join
from ytsaurus_tpu_torch.query.engine.lowering import prepare
from ytsaurus_tpu_torch.query.parameterize import plan_fingerprint
from ytsaurus_tpu_torch.schema import EValueType, TableSchema
from ytsaurus_tpu_torch.utils import sanitizers
from ytsaurus_tpu_torch.utils.tracing import child_span


_count_reads_n = 0


def count_reads() -> int:
    """Row-count reads (device → host) of pending results so far."""
    return _count_reads_n


def _note_count_read() -> None:
    global _count_reads_n
    _count_reads_n += 1


class _PendingResult:
    """A run plan's output planes and its row count, still on the device.
    `finish()` reads the count (one device → host read) and wraps the
    chunk; given `host_count` (read by `finish_all`), it reads nothing."""

    __slots__ = ("planes", "count", "output", "_chunk", "stats", "_t0")

    def __init__(self, planes, count, output, stats=None, t0=None):
        self.planes = planes
        self.count = count
        self.output = output
        self._chunk: Optional[ColumnarChunk] = None
        self.stats = stats
        self._t0 = t0

    def finish(self, host_count: Optional[int] = None) -> ColumnarChunk:
        if self._chunk is None:
            if host_count is None:
                # The device -> host read: the sanitizer flags it when
                # it runs under a registered hot lock.
                sanitizers.note_host_sync("evaluator.finish")
                _note_count_read()
                n = int(self.count)
            else:
                n = int(host_count)
            out_columns: dict[str, Column] = {}
            out_schema_cols = []
            for out_col, (data, valid) in zip(self.output, self.planes):
                out_schema_cols.append((out_col.name, out_col.type.value))
                out_columns[out_col.name] = Column(
                    type=out_col.type, data=data, valid=valid,
                    dictionary=out_col.vocab)
            self._chunk = ColumnarChunk(
                schema=TableSchema.make(out_schema_cols), row_count=n,
                columns=out_columns)
            if self.stats is not None and self._t0 is not None:
                # Dispatch to the count read: the device sync included.
                self.stats.execute_time += time.perf_counter() - self._t0
        return self._chunk


class _ReadyResult:
    """An already materialized result (a WITH TOTALS plan reads its
    counts as it runs)."""

    __slots__ = ("_chunk",)

    def __init__(self, chunk: ColumnarChunk):
        self._chunk = chunk

    def finish(self, host_count: Optional[int] = None) -> ColumnarChunk:
        return self._chunk


def finish_all(pendings: Sequence) -> list[ColumnarChunk]:
    """Finish a batch of dispatched plans with ONE host transfer: the
    row counts of the open pending results cross as one stacked tensor
    instead of one blocking read each."""
    open_ = [p for p in pendings
             if isinstance(p, _PendingResult) and p._chunk is None]
    host: dict[int, int] = {}
    if len(open_) > 1:
        # The one stacked transfer; a single open result falls through to
        # finish(), which counts its own read.
        sanitizers.note_host_sync("evaluator.finish_all")
        _note_count_read()
        counts = torch.stack([p.count.reshape(()).to(torch.int64)
                              for p in open_]).cpu().tolist()
        host = {id(p): c for p, c in zip(open_, counts)}
    return [p.finish(host_count=host.get(id(p))) for p in pendings]


class Evaluator:
    """Runs plans over chunks on one device."""

    def __init__(self, device: "str | torch.device" = DEFAULT_DEVICE):
        self.device = resolve_device(device)

    def run_plan(self, plan: "ir.Query | ir.FrontQuery", chunk: ColumnarChunk,
                 foreign_chunks: Optional[Mapping[str, ColumnarChunk]] = None,
                 stats=None, token=None) -> ColumnarChunk:
        """Execute a plan over one input chunk (and the foreign chunks of
        its joins, by table path), all on this evaluator's device.
        `token` (query/serving.CancellationToken) is checked first;
        `stats` (query/statistics.QueryStatistics) gains the binding
        seconds as `compile_time` and the seconds from dispatch to the
        row count's read as `execute_time`."""
        return self.run_plan_async(plan, chunk, foreign_chunks, stats=stats,
                                   token=token).finish()

    def run_plan_async(self, plan: "ir.Query | ir.FrontQuery",
                       chunk: ColumnarChunk,
                       foreign_chunks: Optional[
                           Mapping[str, ColumnarChunk]] = None,
                       stats=None, token=None):
        """Run a plan without reading its row count: a pending result
        whose `finish()` (or `finish_all`) yields the chunk."""
        if token is not None:
            token.check()
        self._check_device(chunk)
        if isinstance(plan, ir.Query) and plan.joins:
            foreign_chunks = foreign_chunks or {}
            if len(plan.joins) > 1:
                plan, _ = planner.reorder_for_chunks(
                    plan, chunk.row_count, foreign_chunks)
            namespace = _initial_namespace(plan)
            current = _project_chunk(chunk, TableSchema.make(namespace))
            for join in plan.joins:
                foreign = foreign_chunks.get(join.foreign_table)
                if foreign is None:
                    raise YtError(
                        f"No data provided for join table "
                        f"{join.foreign_table!r}",
                        code=EErrorCode.QueryExecutionError)
                self._check_device(foreign)
                namespace = _extend_namespace(namespace, join)
                current = execute_join(current, TableSchema.make(namespace),
                                       join, foreign)
            chunk = current
        elif isinstance(plan, ir.Query):
            chunk = _project_chunk(chunk, plan.schema)
        # Span per plan execution, tagged with the plan's shape
        # fingerprint; an interior site, so untraced use stays on the
        # null fast path and never computes the fingerprint.
        span = child_span("evaluator.run_plan", rows=chunk.row_count)
        with span:
            if span.sampled:
                span.add_tag("fingerprint", plan_fingerprint(plan))
            bind0 = stats.compile_time if stats is not None else 0.0
            if plan.group is not None and plan.group.totals:
                result = self._execute(plan, chunk, stats).finish()
                totals = self._execute(_make_totals_plan(plan), chunk,
                                       stats).finish()
                pending = _ReadyResult(concat_chunks([result, totals]))
            else:
                pending = self._execute(plan, chunk, stats)
            if stats is not None:
                span.add_tag("compile_seconds",
                             round(stats.compile_time - bind0, 6))
            span.add_tag("execution_tier", "eager")
            return pending

    def _check_device(self, chunk: ColumnarChunk) -> None:
        if chunk.columns and not same_device(chunk.device, self.device):
            raise YtError(f"Chunk lies on {chunk.device}, the evaluator runs "
                          f"on {self.device}",
                          code=EErrorCode.QueryExecutionError)

    def cache_size(self) -> int:
        """Entries of the program cache: none, nothing is compiled."""
        return 0

    def _execute(self, plan, chunk: ColumnarChunk,
                 stats=None) -> _PendingResult:
        t0 = time.perf_counter()
        prepared = prepare(plan, chunk)
        t1 = time.perf_counter()
        if stats is not None:
            stats.compile_time += t1 - t0
        columns = {c.name: (chunk.columns[c.name].data,
                            chunk.columns[c.name].valid)
                   for c in plan.schema}
        planes, count = prepared.run(columns, chunk.row_valid)
        return _PendingResult(planes, count, prepared.output, stats, t1)


def _initial_namespace(plan: ir.Query) -> list[tuple[str, str]]:
    """Self-table columns = plan.schema minus columns contributed by joins."""
    joined = set()
    for join in plan.joins:
        for fname in join.foreign_columns:
            joined.add(f"{join.alias}.{fname}" if join.alias else fname)
    return [(c.name, c.type.value) for c in plan.schema
            if c.name not in joined]


def _extend_namespace(namespace: list[tuple[str, str]],
                      join: ir.JoinClause) -> list[tuple[str, str]]:
    out = list(namespace)
    for fname in join.foreign_columns:
        flat = f"{join.alias}.{fname}" if join.alias else fname
        out.append((flat, join.foreign_schema.get(fname).type.value))
    return out


def _project_chunk(chunk: ColumnarChunk, schema: TableSchema) -> ColumnarChunk:
    """View of `chunk` under `schema` (subset/reorder of columns)."""
    columns = {}
    for col_schema in schema:
        col = chunk.columns.get(col_schema.name)
        if col is None:
            raise YtError(f"Chunk is missing column {col_schema.name!r}",
                          code=EErrorCode.QueryExecutionError)
        columns[col_schema.name] = col
    sorted_by = []
    for name in chunk.sorted_by:
        if name not in columns:
            break
        sorted_by.append(name)
    return ColumnarChunk(schema=schema, row_count=chunk.row_count,
                         columns=columns, sorted_by=tuple(sorted_by))


def _typed_null(ty):
    """A null-valued expression carrying type `ty`: if(false, zero, null)."""
    return ir.TFunction(
        type=ty, name="if",
        args=(ir.TLiteral(type=EValueType.boolean, value=False),
              ir.TLiteral(type=ty, value=_zero_value(ty)),
              ir.TLiteral(type=EValueType.null, value=None)))


def _make_totals_plan(plan):
    """The grand-total plan: one constant group key, the same aggregates,
    the projection with group-key references nulled out, no HAVING
    (totals are taken before HAVING), no ORDER BY or LIMIT."""
    key_types = {item.name: item.expr.type for item in plan.group.group_items}

    def subst(e):
        return ir.map_expr(
            e, lambda node: _typed_null(node.type)
            if isinstance(node, ir.TReference) and node.name in key_types
            else node)

    const_key = ir.NamedExpr(
        name="__totals", expr=ir.TLiteral(type=EValueType.int64, value=0))
    group = ir.GroupClause(group_items=(const_key,),
                           aggregate_items=plan.group.aggregate_items,
                           totals=False)
    if plan.project is not None:
        project = ir.ProjectClause(items=tuple(
            ir.NamedExpr(name=i.name, expr=subst(i.expr))
            for i in plan.project.items))
    else:
        # Null keys + aggregate values: the main query's output schema.
        items = [ir.NamedExpr(name=item.name,
                              expr=_typed_null(item.expr.type))
                 for item in plan.group.group_items]
        items += [ir.NamedExpr(name=agg.name,
                               expr=ir.TReference(type=agg.type,
                                                  name=agg.name))
                  for agg in plan.group.aggregate_items]
        project = ir.ProjectClause(items=tuple(items))
    return dc_replace(plan, group=group, having=None, order=None,
                      project=project, offset=0, limit=None)


def _zero_value(ty):
    if ty is EValueType.string:
        return b""
    if ty is EValueType.boolean:
        return False
    if ty is EValueType.double:
        return 0.0
    return 0


def select_rows(query: str,
                tables: Mapping[str, "ColumnarChunk | Sequence"],
                schemas: Optional[Mapping[str, TableSchema]] = None,
                evaluator: Optional[Evaluator] = None,
                params: Optional[Sequence] = None,
                device: "str | torch.device" = DEFAULT_DEVICE
                ) -> ColumnarChunk:
    """One-shot: parse, plan, and execute a query over in-memory tables.

    `tables` maps table path → ColumnarChunk (which must lie on `device`)
    or a row list (which requires `schemas` to carry that table's schema
    and is built on `device`)."""
    dev = resolve_device(device)
    evaluator = evaluator or Evaluator(dev)
    if not same_device(evaluator.device, dev):
        raise YtError(f"The evaluator runs on {evaluator.device}, the query "
                      f"asked for {dev}", code=EErrorCode.QueryExecutionError)
    chunks: dict[str, ColumnarChunk] = {}
    schemas = dict(schemas or {})
    for path, data in tables.items():
        if isinstance(data, ColumnarChunk):
            chunks[path] = data
            schemas.setdefault(path, data.schema)
        else:
            if path not in schemas:
                raise YtError(f"Row-list table {path!r} requires a schema")
            chunks[path] = ColumnarChunk.from_rows(schemas[path], data,
                                                   device=dev)
    plan = build_query(query, schemas, params=params)
    foreign = {p: c for p, c in chunks.items() if p != plan.source}
    return evaluator.run_plan(plan, chunks[plan.source], foreign or None)
