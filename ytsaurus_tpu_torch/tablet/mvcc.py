"""Vectorized MVCC: columnar version resolution on the device.

Port of the JAX package's `tablet/mvcc.py`. The reference resolves
visibility with a per-row k-way heap merge (versioned_row_merger.h); here
the versioned read is one pipeline over capacity-padded planes:

  1. Every source (versioned snapshot chunk, dynamic store planes)
     concatenates on the device (`concat_chunks`).
  2. One packed u32 sort orders versions by (key asc, timestamp desc):
     `pack_key_planes_bits` + the radix sort (`radix_upsweep` +
     `radix_onesweep` on the card).
  3. Visibility is segmented-scan algebra over the sorted planes:
     timestamp filtering is a compare, tombstone bounding is a segmented
     running OR, per-column newest-written fill is a segmented index-min
     + gather.  No Python touches a row.

Three entry points share the machinery:

  visible_chunk           read_snapshot: versions → the select-input chunk
  sorted_versioned_chunk  flush: stores → one (key, -ts)-ordered chunk
  retained_chunk          major compaction: versions ≤ retention collapse
                          to one consolidated per-column base version per
                          key

The reference compiles each program once per (versioned schema, capacity)
and caches it (`_program`, `_PROGRAMS`); eager torch has nothing to
compile, so the programs here are plain functions and there is no cache.

Differences from the reference: uint64 key columns are int64 bit patterns
and sort unsigned (`_version_order` takes their names); `jnp.roll` +
`.at[0].set(True)` is `torch.roll` + an assignment; every entry point
takes `device=` (the chunk must lie on it; "cuda" without a card raises).
Profiler ranges name the stages: `mvcc.sort` (the version sort and the
gathers into version order), `mvcc.scan` (the segmented scans of the
tombstone bound and of each column's newest write), `mvcc.compact`.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ytsaurus_tpu_torch.chunks.columnar import Column, ColumnarChunk, pad_capacity
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_for
from ytsaurus_tpu_torch.ops.segments import (
    compact_mask,
    pack_key_planes_bits,
    segment_end_index,
    segment_scan,
    stable_argsort_u32,
)
from ytsaurus_tpu_torch.schema import EValueType, TableSchema


def supports(schema: TableSchema) -> bool:
    """`any`-typed payloads live host-side (opaque to device compute);
    tablets carrying them keep the Python reference merge."""
    return not any(c.type is EValueType.any for c in schema)


def _comparable(data: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plane canonicalized for ordering/equality: invalid rows zeroed
    (null == null regardless of plane garbage) and -0.0 folded into +0.0
    so keys the host comparator calls equal land in one segment."""
    if data.dtype == torch.bool:
        data = data.to(torch.int8)
    if data.is_floating_point():
        data = data + 0.0
    return torch.where(valid, data, torch.zeros_like(data))


def _version_order(planes: dict, key_names: tuple, mask: torch.Tensor,
                   unsigned: frozenset = frozenset()) -> torch.Tensor:
    """Stable permutation sorting versions by (key asc — nulls first —
    then timestamp desc, as a signed 64-bit field), masked rows last.
    Stability preserves the source concatenation order among duplicate
    (key, ts) versions, which is exactly the tie-break the Python
    reference's stable list sort applies. `unsigned` names the uint64
    key columns."""
    items = [((~mask), torch.ones_like(mask), False, 1)]
    for name in key_names:
        data, valid = planes[name]
        items.append((_comparable(data, valid), valid & mask, False, 64,
                      name in unsigned))
    ts_data, ts_valid = planes["$timestamp"]
    items.append((ts_data, ts_valid & mask, True, 64))
    words, bits = pack_key_planes_bits(items)
    return stable_argsort_u32(words, word_bits=bits)


def _key_starts(sorted_key_planes, s_mask: torch.Tensor) -> torch.Tensor:
    """Segment-start flags: row 0, any key change, masked transition."""
    change = s_mask != torch.roll(s_mask, 1)
    for data, valid in sorted_key_planes:
        dz = _comparable(data, valid)
        change = change | (dz != torch.roll(dz, 1)) | \
            (valid != torch.roll(valid, 1))
    change[0] = True
    return change


def _written_plane(s: dict, name: str) -> torch.Tensor:
    """Did each version STATE this column?  Mirrors tablet._written:
    an absent/null $w: flag means a whole-row write (legacy layout),
    only an explicit False means unwritten."""
    w_data, w_valid = s["$w:" + name]
    return torch.where(w_valid, w_data, torch.ones_like(w_data))


def _newest_written(s: dict, name: str, eligible: torch.Tensor,
                    starts: torch.Tensor, seg_end: torch.Tensor,
                    iota: torch.Tensor):
    """Per row: (data, valid) of its key's newest eligible version that
    wrote `name` — a segmented index-min over candidate rows + gather.
    Rows of one segment all read the same answer."""
    cap = iota.shape[0]
    data, valid = s[name]
    cand = eligible & _written_plane(s, name)
    cand_idx = torch.where(cand, iota, torch.full_like(iota, cap))
    with record_function("mvcc.scan"):
        first_idx = segment_scan("min", cand_idx, starts)[seg_end]
    has = first_idx < cap
    idx = first_idx.clamp(0, cap - 1).to(torch.int64)
    return data[idx], has & valid[idx], has


def _sorted_versions(planes: dict, key_names: tuple, capacity: int,
                     row_count: int, unsigned: frozenset):
    """The planes in version order, the sorted row mask, the key segment
    starts and each row's segment end."""
    device = planes["$timestamp"][0].device
    with record_function("mvcc.sort"):
        iota = torch.arange(capacity, dtype=torch.int32, device=device)
        mask = iota < row_count
        perm = _version_order(planes, key_names, mask, unsigned)
        s = {name: (d[perm], v[perm]) for name, (d, v) in planes.items()}
        s_mask = mask[perm]
        starts = _key_starts([s[k] for k in key_names], s_mask)
        return s, s_mask, starts, segment_end_index(starts), iota


def _compact(out: dict, keep: torch.Tensor, capacity: int):
    """The kept rows of every plane moved to the front (stable), the rows
    past them invalid; plus the kept count."""
    with record_function("mvcc.compact"):
        order, count = compact_mask(keep)
        emitted = torch.arange(capacity, dtype=torch.int64,
                               device=keep.device) < count
        return {name: (d[order], v[order] & emitted)
                for name, (d, v) in out.items()}, count


def _build_visible(planes: dict, row_count: int, read_ts: int,
                   key_names: tuple, value_names: tuple, capacity: int,
                   unsigned: frozenset):
    """read_snapshot program: versioned planes → visible-row planes (in
    key order, compacted to the front) + row count."""
    s, s_mask, starts, seg_end, iota = _sorted_versions(
        planes, key_names, capacity, row_count, unsigned)
    ts_data, _ = s["$timestamp"]
    tomb_data, tomb_valid = s["$tombstone"]
    tomb = tomb_data & tomb_valid
    eligible = s_mask & (ts_data <= read_ts)
    # Newest tombstone ≤ read_ts bounds the merge: a segmented
    # running-OR marks every version at/after (older than) it dead.
    with record_function("mvcc.scan"):
        dead = segment_scan(
            "max", (eligible & tomb).to(torch.int8), starts) > 0
    in_merge = eligible & ~dead
    # One output row per key with surviving writes; its planes are
    # gathered at the key's NEWEST surviving write (the leader).
    seen = segment_scan("sum", in_merge.to(torch.int32), starts)
    leader = in_merge & (seen == 1)

    out = {name: s[name] for name in key_names}
    for name in value_names:
        data, valid, _ = _newest_written(s, name, in_merge, starts,
                                         seg_end, iota)
        out[name] = (data, valid)
    return _compact(out, leader, capacity)


def _build_sorted(planes: dict, row_count: int, key_names: tuple,
                  capacity: int, unsigned: frozenset):
    """flush program: one stable (key, -ts) sort, planes gathered."""
    device = planes["$timestamp"][0].device
    with record_function("mvcc.sort"):
        mask = torch.arange(capacity, device=device) < row_count
        perm = _version_order(planes, key_names, mask, unsigned)
        return {name: (d[perm], v[perm]) for name, (d, v) in planes.items()}


def _build_retained(planes: dict, row_count: int, retention_ts: int,
                    key_names: tuple, value_names: tuple, capacity: int,
                    unsigned: frozenset):
    """Major-compaction program (`_drop_superseded` semantics): versions
    newer than the retention timestamp pass through; versions at/below
    it collapse into ONE consolidated base version per key (per-column
    merged visible state at the retention cut), or nothing when that
    state is a delete."""
    s, s_mask, starts, seg_end, iota = _sorted_versions(
        planes, key_names, capacity, row_count, unsigned)
    ts_data, ts_valid = s["$timestamp"]
    tomb_data, tomb_valid = s["$tombstone"]
    tomb = tomb_data & tomb_valid
    is_base = s_mask & (ts_data <= retention_ts)
    kept = s_mask & ~is_base
    with record_function("mvcc.scan"):
        dead = segment_scan(
            "max", (is_base & tomb).to(torch.int8), starts) > 0
    in_base = is_base & ~dead
    # The base versions sort after every kept version of their key
    # (lower timestamps), so the leader row — the newest surviving
    # base write — is where the consolidated version lands, already
    # in (key, -ts) output order.
    seen = segment_scan("sum", in_base.to(torch.int32), starts)
    leader = in_base & (seen == 1)

    out = {name: s[name] for name in key_names}
    out["$timestamp"] = (ts_data, ts_valid)   # leader keeps base_ts
    out["$tombstone"] = (tomb_data & ~leader, tomb_valid | leader)
    for name in value_names:
        data, valid = s[name]
        base_d, base_v, _ = _newest_written(s, name, in_base, starts,
                                            seg_end, iota)
        out[name] = (torch.where(leader, base_d, data),
                     torch.where(leader, base_v, valid))
        w_data, w_valid = s["$w:" + name]
        # Consolidated versions STATE every column explicitly.
        out["$w:" + name] = (w_data | leader, w_valid | leader)
    return _compact(out, kept | leader, capacity)


def _planes(chunk: ColumnarChunk) -> dict:
    return {name: (col.data, col.valid)
            for name, col in chunk.columns.items()}


def _names(table_schema: TableSchema) -> tuple[tuple, tuple, frozenset]:
    """(key names, value names, names of the uint64 keys)."""
    keys = tuple(table_schema.key_column_names)
    values = tuple(c.name for c in table_schema if c.sort_order is None)
    unsigned = frozenset(c.name for c in table_schema.key_columns
                         if c.type is EValueType.uint64)
    return keys, values, unsigned


def _emit_chunk(schema: TableSchema, out_planes: dict, n: int,
                source: ColumnarChunk) -> ColumnarChunk:
    """Wrap program output planes into a chunk, shrunk to the tightest
    capacity bucket so that downstream work scales with the output, not
    with how many superseded versions fed the merge."""
    columns = {}
    for c in schema:
        data, valid = out_planes[c.name]
        columns[c.name] = Column(
            type=c.type, data=data, valid=valid,
            dictionary=source.columns[c.name].dictionary)
    chunk = ColumnarChunk(schema=schema, row_count=n, columns=columns)
    tight = pad_capacity(max(n, 1))
    if tight < chunk.capacity:
        chunk = chunk.with_capacity(tight)
    return chunk


def visible_chunk(merged: ColumnarChunk, table_schema: TableSchema,
                  timestamp: int,
                  device: "str | torch.device" = DEFAULT_DEVICE
                  ) -> ColumnarChunk:
    """MVCC merge at `timestamp` over a concatenated versioned chunk →
    the select-input ColumnarChunk (plain table schema, key order)."""
    resolve_for(merged, device, "the MVCC merge")
    key_names, value_names, unsigned = _names(table_schema)
    out, count = _build_visible(_planes(merged), merged.row_count,
                                int(timestamp), key_names, value_names,
                                merged.capacity, unsigned)
    chunk = _emit_chunk(table_schema.to_unsorted(), out, int(count), merged)
    # The merge emits key order — seal it so ORDER BY <key prefix> over a
    # tablet snapshot can skip the packed-key sort.
    return dataclasses.replace(chunk, sorted_by=key_names)


def sorted_versioned_chunk(merged: ColumnarChunk,
                           table_schema: TableSchema,
                           device: "str | torch.device" = DEFAULT_DEVICE
                           ) -> ColumnarChunk:
    """Stable (key asc, ts desc) ordering of a versioned chunk — the
    flush sort, without materializing rows."""
    resolve_for(merged, device, "the MVCC sort")
    key_names, _, unsigned = _names(table_schema)
    out = _build_sorted(_planes(merged), merged.row_count, key_names,
                        merged.capacity, unsigned)
    return _emit_chunk(merged.schema, out, merged.row_count, merged)


def retained_chunk(merged: ColumnarChunk, table_schema: TableSchema,
                   retention_timestamp: int,
                   device: "str | torch.device" = DEFAULT_DEVICE
                   ) -> ColumnarChunk:
    """Major compaction over a concatenated versioned chunk: row-exact
    `_drop_superseded` on the device.  row_count == 0 means every version
    was superseded by a delete — the caller drops the chunk."""
    resolve_for(merged, device, "the MVCC compaction")
    key_names, value_names, unsigned = _names(table_schema)
    out, count = _build_retained(_planes(merged), merged.row_count,
                                 int(retention_timestamp), key_names,
                                 value_names, merged.capacity, unsigned)
    return _emit_chunk(merged.schema, out, int(count), merged)
