"""Chunk pools: slice operation inputs into job-sized stripes.

Ref shape: server/lib/chunk_pools/chunk_pool.h:27-261 — controllers feed
input chunks into a pool; the pool hands back "joblets" (stripes of chunk
slices sized by data weight / row count), so inputs far larger than one
worker's memory stream through bounded jobs.

Redesign: chunks are columnar with static capacities; a stripe is a list
of (chunk, row_range) slices.  The unordered pool greedily bin-packs
whole chunks (splitting oversized ones); the ordered pool keeps input
order and only cuts on size boundaries (ordered map/merge semantics).

Own copy of the JAX package's `operations/chunk_pools.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk, concat_chunks

DEFAULT_DATA_WEIGHT_PER_JOB = 256 << 20      # bytes
DEFAULT_ROWS_PER_JOB = 4_000_000


def chunk_data_weight(chunk: ColumnarChunk) -> int:
    """Approximate payload bytes (plane bytes pro-rated to live rows).
    Uses .nbytes metadata only — never forces a device-to-host copy."""
    if chunk.capacity == 0:
        return 0
    total = sum(col.data.nbytes for col in chunk.columns.values())
    return int(total * (chunk.row_count / chunk.capacity))


@dataclass
class Stripe:
    """One job's input: chunk slices materialized lazily."""

    slices: list[tuple[ColumnarChunk, int, int]] = field(default_factory=list)
    row_count: int = 0
    data_weight: int = 0

    def add(self, chunk: ColumnarChunk, start: int, end: int,
            chunk_weight: "int | None" = None) -> None:
        self.slices.append((chunk, start, end))
        rows = end - start
        self.row_count += rows
        if chunk.row_count:
            if chunk_weight is None:
                chunk_weight = chunk_data_weight(chunk)
            self.data_weight += int(chunk_weight * rows / chunk.row_count)

    def materialize(self) -> ColumnarChunk:
        parts = []
        for chunk, start, end in self.slices:
            if start == 0 and end == chunk.row_count:
                parts.append(chunk)
            else:
                parts.append(chunk.slice_rows(start, end))
        return concat_chunks(parts) if len(parts) > 1 else parts[0]

def split_stripe(stripe: Stripe) -> "list[Stripe]":
    """Halve a stripe by rows (ref job_splitter.h: an interrupted long job
    hands its remaining input to smaller jobs).  Returns [stripe] when it
    cannot be split (single row)."""
    if stripe.row_count < 2:
        return [stripe]
    target = stripe.row_count // 2
    first, second = Stripe(), Stripe()
    taken = 0
    for chunk, start, end in stripe.slices:
        rows = end - start
        if taken >= target:
            second.add(chunk, start, end)
        elif taken + rows <= target:
            first.add(chunk, start, end)
            taken += rows
        else:
            cut = start + (target - taken)
            first.add(chunk, start, cut)
            second.add(chunk, cut, end)
            taken = target
    return [s for s in (first, second) if s.slices]


def _split_oversized(chunk: ColumnarChunk, max_rows: int):
    """Yield (start, end) ranges of at most max_rows."""
    start = 0
    while start < chunk.row_count:
        end = min(start + max_rows, chunk.row_count)
        yield start, end
        start = end


def build_stripes(chunks: Sequence[ColumnarChunk],
                  data_weight_per_job: int = DEFAULT_DATA_WEIGHT_PER_JOB,
                  rows_per_job: int = DEFAULT_ROWS_PER_JOB,
                  ordered: bool = False,
                  max_job_count: "int | None" = None) -> list[Stripe]:
    """Slice input chunks into job stripes bounded by rows AND bytes.

    ordered=True keeps rows in input order across stripes (ordered map /
    merge); unordered may pack any chunks together.  max_job_count caps
    the stripe count by scaling the per-job budgets up (the reference's
    job-size adjuster, chunk_pool.h job size constraints).
    """
    chunks = [c for c in chunks if c.row_count > 0]
    if not chunks:
        return []
    weights = {id(c): chunk_data_weight(c) for c in chunks}
    if max_job_count:
        total_rows = sum(c.row_count for c in chunks)
        total_weight = sum(weights.values())
        rows_per_job = max(rows_per_job,
                           -(-total_rows // max_job_count))
        data_weight_per_job = max(data_weight_per_job,
                                  -(-total_weight // max_job_count))

    stripes: list[Stripe] = []
    current = Stripe()

    def flush():
        nonlocal current
        if current.slices:
            stripes.append(current)
            current = Stripe()

    # Unordered: sort descending by weight for tighter packing.
    pending = list(chunks) if ordered else sorted(
        chunks, key=lambda c: weights[id(c)], reverse=True)
    for chunk in pending:
        weight = weights[id(chunk)]
        bytes_per_row = max(weight // max(chunk.row_count, 1), 1)
        max_rows_by_weight = max(data_weight_per_job // bytes_per_row, 1)
        max_rows = min(rows_per_job, max_rows_by_weight)
        for start, end in _split_oversized(chunk, max_rows):
            rows = end - start
            fits = (current.row_count + rows <= rows_per_job and
                    current.data_weight + rows * bytes_per_row
                    <= data_weight_per_job)
            if current.slices and not fits:
                flush()
            current.add(chunk, start, end, chunk_weight=weight)
            if current.row_count >= rows_per_job or \
                    current.data_weight >= data_weight_per_job:
                flush()
    flush()
    # max_job_count is a HARD cap: greedy packing can overshoot on
    # multi-chunk inputs, so fold the smallest stripes together (adjacent
    # ones when ordered, to preserve row order).
    while max_job_count and len(stripes) > max_job_count:
        if ordered:
            i = min(range(len(stripes) - 1),
                    key=lambda j: stripes[j].row_count +
                    stripes[j + 1].row_count)
            j = i + 1
        else:
            by_rows = sorted(range(len(stripes)),
                             key=lambda j: stripes[j].row_count)
            i, j = sorted(by_rows[:2])
        for args in stripes[j].slices:
            stripes[i].add(*args)
        del stripes[j]
    return stripes
