"""Equi-join execution: a sort-merge join over columnar planes, in torch.

Port of the JAX package's `query/engine/joins.py` (`_bind_keys`,
`_emit_encoded_keys`, `_lex_less`, `_lex_searchsorted`, `sort_foreign_keys`,
`null_key_mask`, `probe_replicated`, `execute_join`; and
`parallel/distributed.py::_vocab_remap_slots` as `vocab_remap_slots`, which
this module's join and the mesh's joins share). The foreign side is
sorted by its join key once (`lexsort_indices`, which runs the radix
kernels on the card), each self row finds its match range by a vectorized
lexicographic binary search, and the (self, foreign) row pairs are
materialized into a chunk whose capacity comes from the match total, the
one device → host sync between the two phases. The phases run under
profiler ranges (`join.sort_foreign`, `join.search`, `join.materialize`),
so that a trace shows where a join's device time goes.

The output order is the reference's: self-row-major, then each self row's
foreign matches in the foreign sort order. A LEFT join emits max(matches,
1) rows per valid self row, its pulled columns invalid where nothing
matched.

Differences from the reference, forced by torch:
  * uint64 planes are int64 bit patterns, so the foreign sort is told
    which key planes are unsigned, and the binary search compares the
    pair representation `expr._comparable_pair` gives (uint64 against
    uint64 with the sign bit flipped, uint64 against another number as
    double), as the reference's comparisons promote.
  * There are no compiled phase programs to cache: both phases run
    eagerly.
  * `any` columns' host payloads ride the join as in the reference
    (`_gather_host`): each side's row index crosses to the host once.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch
from torch.profiler import record_function

from ytsaurus_tpu_torch.chunks.columnar import Column, ColumnarChunk, pad_capacity
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.ops.segments import lexsort_indices
from ytsaurus_tpu_torch.query import ir
from ytsaurus_tpu_torch.query.engine.expr import (
    BindContext,
    ColumnBinding,
    EmitContext,
    ExprBinder,
    _comparable_pair,
    _merge_vocabs,
    _pad_np,
    _remap_table,
    _vocab_bucket,
    bindings_to_device,
)
from ytsaurus_tpu_torch.schema import EValueType, TableSchema

_EMPTY_VOCAB = np.array([], dtype=object)


def _bind_keys(chunk: ColumnarChunk, schema: TableSchema,
               equations: tuple[ir.TExpr, ...], shared_bindings: list):
    """Host phase: bind join-key expressions against a chunk's
    vocabularies. Both sides' slots index into ONE shared bindings list."""
    bind_ctx = BindContext(columns={
        c.name: ColumnBinding(type=c.type,
                              vocab=chunk.columns[c.name].dictionary)
        for c in schema}, bindings=shared_bindings)
    binder = ExprBinder(bind_ctx)
    return [binder.bind(e) for e in equations]


def _emit_encoded_keys(bound, remap_slots, ctx: EmitContext):
    """Key planes as (null_rank int8, value) pairs, null values zeroed and
    string codes remapped onto the shared vocabulary."""
    out = []
    for b, slot in zip(bound, remap_slots):
        data, valid = b.emit(ctx)
        data = data.expand(ctx.capacity)
        valid = valid.expand(ctx.capacity)
        if slot is not None:
            table = ctx.bindings[slot]
            data = table[data.to(torch.int64).clamp(0, table.shape[0] - 1)]
        if data.dtype == torch.bool:
            data = data.to(torch.int8)
        data = torch.where(valid, data, torch.zeros_like(data))
        out.append((valid.to(torch.int8), data))
    return out


def _lex_less(a_planes, a_idx: torch.Tensor, b_planes,
              or_equal: bool) -> torch.Tensor:
    """Lexicographic a[a_idx] < b (or <= when or_equal) over encoded
    (null_rank, value) key plane pairs; null sorts before any value. The
    reference gathers b at an index too; its one caller passes the
    identity, so b here is taken as it is."""
    result = torch.full(a_idx.shape, or_equal, dtype=torch.bool,
                        device=a_idx.device)
    for (av, ad), (b_v, b_d) in reversed(list(zip(a_planes, b_planes))):
        a_v, a_d = av[a_idx], ad[a_idx]
        lt = (a_v < b_v) | ((a_v == b_v) & (a_d < b_d))
        eq = (a_v == b_v) & (a_d == b_d)
        result = lt | (eq & result)
    return result


def _lex_searchsorted(sorted_planes, n_sorted: int, max_n: int,
                      query_planes, side: str) -> torch.Tensor:
    """For each query row, binary-search the sorted key planes.
    side='left' → first index whose key >= query; 'right' → first > query.
    The iteration count follows the capacity bound `max_n`, as in the
    reference, not the live count `n_sorted`; lo and hi stay int64.
    `n_sorted` may be a 0-d device tensor (read nothing to the host)."""
    cap_q = query_planes[0][0].shape[0]
    device = query_planes[0][0].device
    lo = torch.zeros(cap_q, dtype=torch.int64, device=device)
    if torch.is_tensor(n_sorted):
        hi = n_sorted.to(torch.int64).expand(cap_q).clone()
    else:
        hi = torch.full((cap_q,), n_sorted, dtype=torch.int64,
                        device=device)
    iters = max(1, int(np.ceil(np.log2(max(max_n, 2)))) + 1)
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) // 2
        mid_c = mid.clamp(0, max(max_n - 1, 0))
        go_right = _lex_less(sorted_planes, mid_c, query_planes,
                             or_equal=(side == "right"))
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def sort_foreign_keys(f_keys, f_valid: torch.Tensor, unsigned=None):
    """Sort encoded foreign key planes (first key most significant, masked
    rows last) in `jnp.lexsort`'s order; returns (f_order, f_sorted).
    `unsigned[i]` marks key i's value plane as uint64 bit patterns."""
    unsigned = unsigned or [False] * len(f_keys)
    sort_keys = []
    for (v, d), u in reversed(list(zip(f_keys, unsigned))):
        sort_keys.extend([(d, u) if u else d, v])
    sort_keys.append((~f_valid).to(torch.int8))
    f_order = lexsort_indices(sort_keys)
    return f_order, [(v[f_order], d[f_order]) for v, d in f_keys]


def null_key_mask(self_keys) -> torch.Tensor:
    """Rows whose join key has ANY null component (they match nothing)."""
    cap = self_keys[0][0].shape[0]
    s_null = torch.zeros(cap, dtype=torch.bool,
                         device=self_keys[0][0].device)
    for v, _ in self_keys:
        s_null = s_null | (v == 0)
    return s_null


def probe_replicated(sl, n_keys: int, f_cap: int, self_keys, mask,
                     is_left: bool):
    """The broadcast-join probe body. `sl` is one join's replicated slice,
    laid out as [v_0, d_0, … v_{k-1}, d_{k-1}, pulled (data, valid)
    pairs …, n_foreign], its key planes sorted and comparable with
    `self_keys`: lex-search them for each self row, gather every pulled
    plane at the (unique-key) match row masked to matched, and narrow the
    row mask for INNER joins. Returns (pulled_planes, new_mask)."""
    f_sorted = [(sl[2 * i], sl[2 * i + 1]) for i in range(n_keys)]
    n_foreign = int(sl[-1])
    lo = _lex_searchsorted(f_sorted, n_foreign, f_cap, self_keys, "left")
    hi = _lex_searchsorted(f_sorted, n_foreign, f_cap, self_keys, "right")
    matched = mask & ~null_key_mask(self_keys) & (hi > lo)
    pos = lo.clamp(0, f_cap - 1)
    base = 2 * n_keys
    pulled = [(sl[base + 2 * i][pos], sl[base + 2 * i + 1][pos] & matched)
              for i in range((len(sl) - base - 1) // 2)]
    return pulled, (mask if is_left else matched)


def vocab_remap_slots(self_bound, f_bound, bindings: list):
    """String join keys: both sides' dictionary codes are remapped onto a
    merged vocabulary (host), so that equality compares one code space.
    Returns per-key binding slots of each side (None for a key without a
    vocabulary); the remap tables are appended to `bindings`."""
    self_slots: list = []
    foreign_slots: list = []
    for sb, fb in zip(self_bound, f_bound):
        if sb.vocab is None and fb.vocab is None:
            self_slots.append(None)
            foreign_slots.append(None)
            continue
        merged = _merge_vocabs(sb.vocab, fb.vocab)
        for vocab in (sb.vocab, fb.vocab):
            vocab = vocab if vocab is not None else _EMPTY_VOCAB
            table = _remap_table(vocab, merged)
            bindings.append(_pad_np(table, _vocab_bucket(len(table)), 0))
        self_slots.append(len(bindings) - 2)
        foreign_slots.append(len(bindings) - 1)
    return self_slots, foreign_slots


def _comparable_keys(self_keys, f_sorted, self_bound, f_bound):
    """The (null_rank, value) planes of both sides in one ordered
    representation per key, for the binary search."""
    s_out, f_out = [], []
    for (sv, sd), (fv, fd), sb, fb in zip(self_keys, f_sorted, self_bound,
                                          f_bound):
        fd, sd = _comparable_pair(fd, fb.type, sd, sb.type)
        s_out.append((sv, sd))
        f_out.append((fv, fd))
    return s_out, f_out


def execute_join(chunk: ColumnarChunk, combined_schema: TableSchema,
                 join: ir.JoinClause,
                 foreign_chunk: ColumnarChunk) -> ColumnarChunk:
    """Materialize `chunk ⋈ foreign_chunk` into a wider columnar chunk.
    `combined_schema` is the namespace *after* this join (flat names)."""
    device = chunk.device
    self_schema = chunk.schema
    all_bindings: list = []
    self_bound = _bind_keys(chunk, self_schema, join.self_equations,
                            all_bindings)
    f_bound = _bind_keys(foreign_chunk, join.foreign_schema,
                         join.foreign_equations, all_bindings)
    self_slots, foreign_slots = vocab_remap_slots(self_bound, f_bound,
                                                  all_bindings)
    bindings = bindings_to_device(all_bindings, device)

    self_cap = chunk.capacity
    foreign_cap = foreign_chunk.capacity
    n_foreign = foreign_chunk.row_count
    s_valid = chunk.row_valid
    f_valid = foreign_chunk.row_valid
    self_columns = {c.name: (chunk.columns[c.name].data,
                             chunk.columns[c.name].valid)
                    for c in self_schema}
    foreign_columns = {name: (foreign_chunk.columns[name].data,
                              foreign_chunk.columns[name].valid)
                       for name in set(list(join.foreign_columns) +
                                       list(join.foreign_schema.column_names))}

    # Phase 1: sort the foreign keys, find each self row's match range.
    s_ctx = EmitContext(columns=self_columns, bindings=bindings,
                        capacity=self_cap, device=device)
    f_ctx = EmitContext(columns=foreign_columns, bindings=bindings,
                        capacity=foreign_cap, device=device)
    with record_function("join.sort_foreign"):
        self_keys = _emit_encoded_keys(self_bound, self_slots, s_ctx)
        foreign_keys = _emit_encoded_keys(f_bound, foreign_slots, f_ctx)
        f_order, f_sorted = sort_foreign_keys(
            foreign_keys, f_valid,
            [b.type is EValueType.uint64 for b in f_bound])
        s_cmp, f_cmp = _comparable_keys(self_keys, f_sorted, self_bound,
                                        f_bound)
        del f_sorted, foreign_keys
    with record_function("join.search"):
        lo = _lex_searchsorted(f_cmp, n_foreign, foreign_cap, s_cmp, "left")
        hi = _lex_searchsorted(f_cmp, n_foreign, foreign_cap, s_cmp,
                               "right")
        del f_cmp, s_cmp
        s_null = null_key_mask(self_keys)
        counts = torch.where(s_valid & ~s_null, hi - lo,
                             torch.zeros_like(lo))
        del hi, self_keys, s_null
        if join.is_left:
            per_row = torch.where(s_valid, counts.clamp(min=1),
                                  torch.zeros_like(counts))
        else:
            per_row = counts
        offsets = torch.cumsum(per_row, 0)
    total = int(offsets[-1])                 # the one host sync
    out_cap = pad_capacity(max(total, 1))

    # Phase 2: materialize the (self, foreign) row pairs.
    with record_function("join.materialize"):
        return _materialize(chunk, foreign_chunk, join, combined_schema,
                            self_columns, per_row, offsets, total, out_cap,
                            lo, counts, f_order)


def _materialize(chunk, foreign_chunk, join, combined_schema, self_columns,
                 per_row, offsets, total, out_cap, lo, counts, f_order):
    """Phase 2: each output row's self row (by a search of the running
    match counts) and foreign row (its match range start plus its place
    in the range, through the foreign sort order), then the gathers."""
    device = chunk.device
    self_cap = chunk.capacity
    foreign_cap = foreign_chunk.capacity
    starts = offsets - per_row
    del per_row
    out_idx = torch.arange(out_cap, dtype=torch.int64, device=device)
    self_row = torch.searchsorted(offsets, out_idx, right=True)
    del offsets
    self_row = self_row.clamp(0, self_cap - 1)
    within = out_idx - starts[self_row]
    matched = counts[self_row] > 0
    foreign_pos = (lo[self_row] + within).clamp(0, foreign_cap - 1)
    del within, starts, lo, counts
    foreign_row = f_order[foreign_pos]
    del foreign_pos, f_order
    out_valid_row = out_idx < total
    del out_idx

    columns: dict[str, Column] = {}
    self_row_host = None
    for name, col in chunk.columns.items():
        data, valid = self_columns[name]
        host_values = None
        if col.host_values is not None:
            if self_row_host is None:
                # `any` payloads live on the host: the gather index
                # crosses once.
                self_row_host = self_row.cpu().tolist()
            host_values = _gather_host(col, self_row_host)
        columns[name] = replace(col, data=data[self_row],
                                valid=valid[self_row] & out_valid_row,
                                host_values=host_values)
    del self_row
    pulled_valid = out_valid_row & matched
    foreign_row_host = None
    for fname in join.foreign_columns:
        fcol = foreign_chunk.columns[fname]
        flat = f"{join.alias}.{fname}" if join.alias else fname
        host_values = None
        if fcol.host_values is not None:
            if foreign_row_host is None:
                foreign_row_host = foreign_row.cpu().tolist()
            host_values = _gather_host(fcol, foreign_row_host)
        columns[flat] = replace(fcol, data=fcol.data[foreign_row],
                                valid=fcol.valid[foreign_row] & pulled_valid,
                                host_values=host_values)
    out_columns = {}
    for col_schema in combined_schema:
        if col_schema.name not in columns:
            raise YtError(f"Join produced no column {col_schema.name!r}",
                          code=EErrorCode.QueryExecutionError)
        out_columns[col_schema.name] = columns[col_schema.name]
    return ColumnarChunk(schema=combined_schema, row_count=total,
                         columns=out_columns)


def _gather_host(col: Column, idx: list) -> list:
    """An `any` column's payloads at the gather index `idx`."""
    values = col.host_values
    return [values[i] if i < len(values) else None for i in idx]
