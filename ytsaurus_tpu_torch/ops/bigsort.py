"""External (spill-capable) sort: device-memory-budgeted range partition +
per-range device sorts.

Port of the JAX package's `ops/bigsort.py` (`SpillStats`,
`DEFAULT_HBM_BUDGET`, `_host_planes`, `_sample_keys`, `_partition_block`,
`_concat_range`, `_sort_range_planes`, `external_sort`), with its passes
as they are. Ref mapping: the Sort controller's partition tree
(controller_agent/controllers/sort_controller.cpp:459), samples_fetcher.h
key sampling, partition_job.cpp row routing. The whole pipeline runs on
one host + device pair:

  pass 1  sample keys from every input block (host)
  pass 2  per block: upload → device computes each row's range id against
          the pivots (lexicographic, null-aware) → device stable-permutes
          the block so ranges are contiguous → ONE download → host slices
          append to per-range spill buffers (host RAM is the spill tier)
  pass 3  per range: upload (≤ the device budget by construction) →
          device sort → yield a sorted ColumnarChunk

A range that outgrew the budget (skewed keys) is re-partitioned with
pivots from its own keys, up to `_MAX_SPLIT_DEPTH` levels.

Differences from the reference:
  * The stable argsort of the range ids is the port's radix sort
    (`stable_argsort_u32`, `radix_upsweep` + `radix_onesweep` on the
    card) over a key word as wide as the largest id; a stable argsort has
    one answer. The per-range counts are `torch.bincount`.
  * uint64 columns live in the host planes as np.uint64 (on the device as
    int64 bit patterns), so that the samples, the pivots and the range
    compares order them unsigned, as the reference's uint64 arrays do.
  * The pivots' values become an array of the key plane's dtype directly.
    The reference first lets numpy infer the array's dtype, which is
    float64 when uint64 pivots above 2^63 mix with smaller ones: such
    pivots round to the nearest double, and one within 2^10 of 2^64 casts
    out of range. The ranges it cuts stay in order (rounding is
    monotone), but their sizes differ from the port's wherever a pivot is
    not a double exactly; everywhere else the two agree row for row.
  * A re-split range is handed to the next level as a chunk of CPU
    tensors over its host planes, not uploaded first: the next level
    reads it back to host planes at once.
  * `external_sort` takes `device=` (the device its sorts run on; the
    input blocks may lie anywhere, since they are read to the host
    first) and resolves it when called, so "cuda" without a card raises
    at once. Each pass runs inside a profiler range (`bigsort.sample`,
    `bigsort.route`, `bigsort.sort_range`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ytsaurus_tpu_torch.chunks.columnar import Column, ColumnarChunk, pad_capacity
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.operations.sort_op import _with_key_order
from ytsaurus_tpu_torch.ops.segments import (
    packed_sort_indices,
    stable_argsort_u32,
)
from ytsaurus_tpu_torch.parallel.shuffle import (
    _encode_key_plane,
    _partition_ids,
    pivot_value_plane,
    quantile_pivots,
)
from ytsaurus_tpu_torch.schema import EValueType, SortOrder, TableSchema

DEFAULT_HBM_BUDGET = 8 << 30        # bytes of device memory a range may use
_MAX_SPLIT_DEPTH = 4                # partition-tree depth bound
_SAMPLES_PER_BLOCK = 512


@dataclass
class SpillStats:
    """Observability + test assertions for the external sort."""

    blocks: int = 0
    ranges: int = 0
    resplits: int = 0
    peak_range_rows: int = 0
    budget_rows: int = 0
    spilled_rows: int = 0
    range_rows: list = field(default_factory=list)


def _row_bytes(schema: TableSchema) -> int:
    # Device planes are 8-byte data + 1-byte valid per column.
    return sum(9 for _ in schema)


def _check_numeric_keys(schema: TableSchema, key_names: Sequence[str]):
    for name in key_names:
        if name not in schema:
            raise YtError(f"No such sort column {name!r}",
                          code=EErrorCode.QueryTypeError)


def _host_planes(chunk: ColumnarChunk) -> dict:
    """Download a chunk's planes once: name → (data, valid) numpy arrays
    trimmed to live rows (uint64 data as np.uint64)."""
    n = chunk.row_count
    out = {}
    for name, col in chunk.columns.items():
        if col.dictionary is not None or col.type is EValueType.any:
            raise YtError(
                f"external sort supports numeric columns only; {name!r} "
                f"is string/any (route those through the mesh shuffle "
                f"path or sort_chunks)", code=EErrorCode.QueryUnsupported)
        data = col.data[:n].cpu().numpy()
        if col.type is EValueType.uint64:
            data = data.view(np.uint64)
        out[name] = (data, col.valid[:n].cpu().numpy())
    return out


def _sample_keys(planes: dict, key_names: Sequence[str],
                 k: int) -> list[tuple]:
    """Evenly-spaced (valid, value) key tuples from one block's planes."""
    n = len(planes[key_names[0]][0])
    if n == 0:
        return []
    idx = np.linspace(0, n - 1, min(k, n), dtype=np.int64)
    rows = []
    for i in idx:
        rows.append(tuple(
            (bool(planes[name][1][i]), planes[name][0][i].item())
            for name in key_names))
    return rows


def _to_device(data: np.ndarray, valid: np.ndarray, cap: int,
               device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Host planes padded to `cap` rows on the device (uint64 as int64)."""
    if data.dtype == np.uint64:
        data = data.view(np.int64)
    n = len(data)
    d = torch.zeros(cap, dtype=torch.from_numpy(data[:0]).dtype,
                    device=device)
    v = torch.zeros(cap, dtype=torch.bool, device=device)
    if n:
        d[:n].copy_(torch.from_numpy(data))
        v[:n].copy_(torch.from_numpy(valid))
    return d, v


def _to_host(plane: torch.Tensor, like: np.ndarray) -> np.ndarray:
    out = plane.cpu().numpy()
    return out.view(np.uint64) if like.dtype == np.uint64 else out


def _partition_block(planes: dict, key_names: Sequence[str],
                     pivots: list[tuple], n_ranges: int,
                     descending: bool, device: torch.device) -> list[dict]:
    """Device pass: route one host block into per-range host buffers.

    Upload → range ids vs pivots → stable permute (device gather) →
    single download → host slicing.  Returns per-range {name: (data,
    valid)} numpy planes."""
    n = len(planes[key_names[0]][0])
    if n == 0:
        return [dict() for _ in range(n_ranges)]
    cap = pad_capacity(n)
    dev = {name: _to_device(data, valid, cap, device)
           for name, (data, valid) in planes.items()}
    live = torch.arange(cap, device=device) < n

    pivot_planes = []
    for ki, name in enumerate(key_names):
        vals = np.array([p[ki][1] for p in pivots],
                        dtype=planes[name][0].dtype)
        ranks = np.array([1 if p[ki][0] else 0 for p in pivots],
                         dtype=np.int8)
        pivot_planes.append((torch.from_numpy(ranks).to(device),
                             pivot_value_plane(vals, device)))
    row_planes = [_encode_key_plane(
        dev[name][0], dev[name][1],
        unsigned=planes[name][0].dtype == np.uint64) for name in key_names]
    pid = _partition_ids(row_planes, pivot_planes, n_ranges - 1)
    if descending:
        pid = (n_ranges - 1) - pid
    pid = torch.where(live, pid, n_ranges).to(torch.int64)  # padding → tail
    order = stable_argsort_u32([pid], word_bits=[n_ranges.bit_length()])
    counts = torch.bincount(pid, minlength=n_ranges + 1)[:n_ranges]
    counts = counts.cpu().numpy()
    out: list[dict] = []
    starts = np.concatenate([[0], np.cumsum(counts)])
    live_order = order[:n]
    permuted = {name: (_to_host(d[live_order], planes[name][0]),
                       v[live_order].cpu().numpy())
                for name, (d, v) in dev.items()}
    for r in range(n_ranges):
        lo, hi = int(starts[r]), int(starts[r + 1])
        out.append({name: (d[lo:hi].copy(), v[lo:hi].copy())
                    for name, (d, v) in permuted.items()})
    return out


def _concat_range(buffers: list[dict], names: Sequence[str]) -> dict:
    out = {}
    for name in names:
        datas = [b[name][0] for b in buffers if b and len(b[name][0])]
        valids = [b[name][1] for b in buffers if b and len(b[name][0])]
        if datas:
            out[name] = (np.concatenate(datas), np.concatenate(valids))
        else:
            out[name] = (np.zeros(0, dtype=np.int64),
                         np.zeros(0, dtype=bool))
    return out


def _sort_range_planes(planes: dict, schema: TableSchema,
                       key_names: Sequence[str], descending: bool,
                       device: torch.device) -> ColumnarChunk:
    """Per-range device sort of host planes → sorted ColumnarChunk."""
    n = len(planes[key_names[0]][0])
    cap = pad_capacity(max(n, 1))
    dev = {name: _to_device(data, valid, cap, device)
           for name, (data, valid) in planes.items()}
    live = torch.arange(cap, device=device) < n
    items = [((~live), torch.ones_like(live), False, 1)]
    for name in key_names:
        d, v = dev[name]
        items.append((d, v & live, descending, 64,
                      planes[name][0].dtype == np.uint64))
    order = packed_sort_indices(items)
    columns = {}
    for col_schema in schema:
        d, v = dev[col_schema.name]
        columns[col_schema.name] = Column(
            type=col_schema.type, data=d[order], valid=v[order])
    out_schema = _with_key_order(
        schema, list(key_names),
        SortOrder.descending if descending else SortOrder.ascending)
    return ColumnarChunk(schema=out_schema, row_count=n, columns=columns)


def _host_chunk(schema: TableSchema, planes: dict, n: int) -> ColumnarChunk:
    """A chunk of CPU tensors over host planes (no copy): the input of a
    re-split, which reads them straight back."""
    columns = {}
    for c in schema:
        data, valid = planes[c.name]
        if data.dtype == np.uint64:
            data = data.view(np.int64)
        columns[c.name] = Column(type=c.type, data=torch.from_numpy(data),
                                 valid=torch.from_numpy(valid))
    return ColumnarChunk(schema=schema, row_count=n, columns=columns)


def external_sort(blocks: "Sequence[ColumnarChunk | Callable[[], ColumnarChunk]]",
                  key_columns: Sequence[str],
                  budget_bytes: int = DEFAULT_HBM_BUDGET,
                  descending: bool = False,
                  stats: "SpillStats | None" = None,
                  device: "str | torch.device" = DEFAULT_DEVICE,
                  _depth: int = 0) -> Iterator[ColumnarChunk]:
    """Sort arbitrarily large input through bounded device memory.

    `blocks`: input chunks, or zero-arg callables producing them (so
    callers stream from the chunk store without holding every block).
    Yields sorted chunks, on `device`, whose concatenation is the
    globally sorted table; each yielded chunk's device footprint stays
    under `budget_bytes`."""
    dev = resolve_device(device)
    return _external_sort(blocks, list(key_columns), budget_bytes,
                          descending, stats, dev, _depth)


def _external_sort(blocks, key_names: list, budget_bytes: int,
                   descending: bool, stats: "SpillStats | None",
                   device: torch.device, _depth: int
                   ) -> Iterator[ColumnarChunk]:
    suppliers = [b if callable(b) else (lambda c=b: c) for b in blocks]
    if not suppliers:
        return

    # Pass 1: sample + size.  Blocks are materialized one at a time; the
    # host planes spill buffer is the only O(total) memory.
    with record_function("bigsort.sample"):
        first = suppliers[0]()
        schema = first.schema
        _check_numeric_keys(schema, key_names)
        row_bytes = _row_bytes(schema)
        budget_rows = max(budget_bytes // (row_bytes * 2), 1)  # 2x: scratch
        if stats is not None:
            stats.budget_rows = int(budget_rows)

        host_blocks: list[dict] = []
        samples: list[tuple] = []
        total_rows = 0
        current: "ColumnarChunk | None" = first
        for i, supplier in enumerate(suppliers):
            chunk = current if i == 0 else supplier()
            current = None
            planes = _host_planes(chunk)
            host_blocks.append(planes)
            samples.extend(_sample_keys(planes, key_names,
                                        _SAMPLES_PER_BLOCK))
            total_rows += chunk.row_count
            if stats is not None:
                stats.blocks += 1
                stats.spilled_rows += chunk.row_count
        del chunk, first

    names = [c.name for c in schema]
    if total_rows <= budget_rows:
        # Device-resident: one device sort, no partition pass.
        with record_function("bigsort.sort_range"):
            merged = _concat_range(host_blocks, names)
            del host_blocks
            if stats is not None:
                stats.ranges += 1
                stats.range_rows.append(total_rows)
                stats.peak_range_rows = max(stats.peak_range_rows,
                                            total_rows)
            out = _sort_range_planes(merged, schema, key_names, descending,
                                     device)
        yield out
        return

    n_ranges = int(min(max(-(-total_rows // budget_rows) * 2, 2), 512))
    pivots = quantile_pivots(samples, n_ranges, len(key_names))

    # Pass 2: device-route every block into per-range spill buffers,
    # releasing each unrouted block as it's consumed (host RAM stays at
    # ~1x the data plus one in-flight block).
    range_buffers: list[list[dict]] = [[] for _ in range(n_ranges)]
    with record_function("bigsort.route"):
        for i in range(len(host_blocks)):
            routed = _partition_block(host_blocks[i], key_names, pivots,
                                      n_ranges, descending, device)
            host_blocks[i] = None
            for r, part in enumerate(routed):
                if part and len(next(iter(part.values()))[0]):
                    range_buffers[r].append(part)
        del host_blocks

    # Pass 3: per-range device sort, in range order.
    for r in range(n_ranges):
        with record_function("bigsort.sort_range"):
            merged = _concat_range(range_buffers[r], names)
            range_buffers[r] = []            # release spill as we go
            n = len(merged[key_names[0]][0])
            out = None
            if n and not (n > budget_rows and _depth < _MAX_SPLIT_DEPTH):
                if stats is not None:
                    stats.ranges += 1
                    stats.range_rows.append(n)
                    stats.peak_range_rows = max(stats.peak_range_rows, n)
                out = _sort_range_planes(merged, schema, key_names,
                                         descending, device)
        if out is not None:
            yield out
        elif n:
            # Skew: this range outgrew the budget — re-split it with
            # pivots from its OWN keys (multi-level partition tree).
            if stats is not None:
                stats.resplits += 1
            sub = _host_chunk(schema, merged, n)
            del merged
            yield from _external_sort(
                [sub], key_names, budget_bytes, descending, stats, device,
                _depth + 1)
