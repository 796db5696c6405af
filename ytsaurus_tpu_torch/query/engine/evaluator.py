"""The query evaluator: plan + chunk → result chunk, eagerly in torch.

Port of the JAX package's `query/engine/evaluator.py` (`Evaluator.run_plan`,
`_PendingResult.finish`, `_project_chunk`, `select_rows`). PyTorch runs
eagerly, so the JAX evaluator's compile cache, AOT layers, tiering, compile
observatory and buffer donation have no counterpart here. Plans with joins
or `WITH TOTALS` raise until their slices.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch

from ytsaurus_tpu_torch.chunks.columnar import Column, ColumnarChunk
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_device, same_device
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.query import ir
from ytsaurus_tpu_torch.query.builder import build_query
from ytsaurus_tpu_torch.query.engine.expr import not_ported
from ytsaurus_tpu_torch.query.engine.lowering import prepare
from ytsaurus_tpu_torch.schema import TableSchema


class _PendingResult:
    """A run plan's output planes and its row count, still on the device.
    `finish()` reads the count (the one device → host sync) and wraps the
    chunk."""

    __slots__ = ("planes", "count", "output", "_chunk")

    def __init__(self, planes, count, output):
        self.planes = planes
        self.count = count
        self.output = output
        self._chunk: Optional[ColumnarChunk] = None

    def finish(self) -> ColumnarChunk:
        if self._chunk is None:
            n = int(self.count)
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
        return self._chunk


class Evaluator:
    """Runs plans over chunks on one device."""

    def __init__(self, device: "str | torch.device" = DEFAULT_DEVICE):
        self.device = resolve_device(device)

    def run_plan(self, plan: "ir.Query | ir.FrontQuery", chunk: ColumnarChunk,
                 foreign_chunks: Optional[Mapping[str, ColumnarChunk]] = None
                 ) -> ColumnarChunk:
        """Execute a plan over one input chunk, which must lie on this
        evaluator's device."""
        if isinstance(plan, ir.Query) and (plan.joins or foreign_chunks):
            raise not_ported("JOIN")
        if plan.group is not None and plan.group.totals:
            raise not_ported("GROUP BY ... WITH TOTALS")
        if chunk.columns and not same_device(chunk.device, self.device):
            raise YtError(f"Chunk lies on {chunk.device}, the evaluator runs "
                          f"on {self.device}",
                          code=EErrorCode.QueryExecutionError)
        if isinstance(plan, ir.Query):
            chunk = _project_chunk(chunk, plan.schema)
        prepared = prepare(plan, chunk)
        columns = {c.name: (chunk.columns[c.name].data,
                            chunk.columns[c.name].valid)
                   for c in plan.schema}
        planes, count = prepared.run(columns, chunk.row_valid)
        return _PendingResult(planes, count, prepared.output).finish()


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
