"""Sort operation kernels: single-device chunk sort.

Port of the JAX package's `operations/sort_op.py` (`sort_chunk`,
`sort_chunks`, `_with_key_order`): one device sort over the concatenated
columnar input (the simple_sort job analog). The keys are packed into u32
words (the mask bit, then each key column's null bit and value) and sorted
by the radix engine (`ops/radix.py`: `radix_upsweep` + `radix_onesweep` on
the card); the payload columns are then gathered by the permutation.

Differences from the reference:
  * uint64 key columns are int64 bit patterns; they sort unsigned.
  * The permutation is int32 inside the radix sort, so a chunk whose
    capacity exceeds `radix.MAX_N` rows raises instead of wrapping.
  * `any` columns' host payloads are gathered through the permutation,
    which is read back from the device once for all of them.
  * `sort_chunk` / `sort_chunks` take `device=` like every entry point of
    the port: the chunks must lie on it, and "cuda" without a card raises.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

import torch

from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk, concat_chunks
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_for
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.ops.radix import MAX_N
from ytsaurus_tpu_torch.ops.segments import packed_sort_indices
from ytsaurus_tpu_torch.schema import EValueType, SortOrder, TableSchema


def sort_chunk(chunk: ColumnarChunk, key_columns: Sequence[str],
               descending: bool = False,
               device: "str | torch.device" = DEFAULT_DEVICE
               ) -> ColumnarChunk:
    """Device sort of one chunk by the given key columns (stable)."""
    resolve_for(chunk, device, "the sort")
    for name in key_columns:
        if name not in chunk.schema:
            raise YtError(f"No such sort column {name!r}",
                          code=EErrorCode.QueryTypeError)
    if chunk.capacity > MAX_N:
        raise YtError(f"sort_chunk sorts at most {MAX_N} rows of capacity "
                      f"(an int32 permutation), got {chunk.capacity}",
                      code=EErrorCode.QueryUnsupported)
    mask = chunk.row_valid
    # Packed composite keys: the sort carries the fewest possible u32
    # words (mask bit + null/value fields); payload columns are gathered
    # by the permutation afterwards.
    items = [((~mask), torch.ones_like(mask), False, 1)]
    for name in key_columns:
        col = chunk.column(name)
        dictionary = col.dictionary
        bits = max(len(dictionary) - 1, 1).bit_length() \
            if dictionary is not None else 64
        items.append((col.data, col.valid, descending, bits,
                      col.type is EValueType.uint64))
    order = packed_sort_indices(items)
    idx_host = None
    columns = {}
    for name, col in chunk.columns.items():
        host_values = None
        if col.host_values is not None:
            if idx_host is None:
                # `any` payloads live on the host: the permutation
                # crosses once for all of them.
                idx_host = order[:chunk.row_count].cpu().tolist()
            host_values = [col.host_values[i] for i in idx_host]
            host_values += [None] * (chunk.capacity - len(host_values))
        columns[name] = replace(col, data=col.data[order],
                                valid=col.valid[order],
                                host_values=host_values)
    order_kind = SortOrder.descending if descending else SortOrder.ascending
    schema = _with_key_order(chunk.schema, list(key_columns), order_kind)
    return ColumnarChunk(schema=schema, row_count=chunk.row_count,
                         columns=columns)


def sort_chunks(chunks: Sequence[ColumnarChunk], key_columns: Sequence[str],
                descending: bool = False,
                device: "str | torch.device" = DEFAULT_DEVICE
                ) -> ColumnarChunk:
    for chunk in chunks:
        resolve_for(chunk, device, "the sort")
    merged = concat_chunks(list(chunks)) if len(chunks) > 1 else chunks[0]
    return sort_chunk(merged, key_columns, descending, device=device)


def _with_key_order(schema: TableSchema, key_names: list[str],
                    order: SortOrder) -> TableSchema:
    reordered = [schema.get(k) for k in key_names] + \
        [c for c in schema if c.name not in key_names]
    cols = []
    for i, col in enumerate(reordered):
        cols.append(col.with_sort_order(order if i < len(key_names) else None))
    return TableSchema(columns=tuple(cols))
