"""Plan lowering: typed IR → a staged torch program over columnar planes.

Port of the JAX package's `query/engine/lowering.py` (`prepare`, `run`).
Each clause becomes a batch transformation over static-capacity planes:

  filter   = predicate mask (no data movement)
  group    = dense segment ids by stride arithmetic for small key domains,
             else exact-key radix sort → segment boundaries → reductions
  having   = a mask over the group stage
  window   = one packed sort + segmented scans (window.py), scattered
             back to the input order: the stage adds columns, no rows move
  order    = packed-key radix sort (single-key ORDER BY ... LIMIT k first
             narrows the rows to top-k candidates) → gather
  project  = elementwise expression evaluation
  limit    = compaction (stable sort by ~mask) + offset/limit window

`prepare()` binds on the host; the returned `run` executes eagerly on the
chunk's device. There is no compile cache, so OFFSET and LIMIT are plain
values rather than bucketed bindings. Joins run before `prepare`, in the
evaluator (joins.py).

Ties in the top-k candidate pass are broken toward the lowest row index
explicitly (`topk_lowest_index`), the order `lax.top_k` gives and
`torch.topk` does not promise.

A vector column's plane is `(capacity, dim)`: the WHERE mask, the top-k and
order gathers and the compaction index its rows like any other plane's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ytsaurus_tpu_torch.chunks.columnar import pad_capacity
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.ops.segments import (
    compact_mask,
    hash_group_order,
    min_max_plane,
    min_max_result,
    packed_sort_indices,
    segment_aggregate,
    segment_arg_by,
    segment_boundaries,
    segment_distinct_count,
    segment_reduce_many,
    sort_key_planes,
)
from ytsaurus_tpu_torch.query import ir
from ytsaurus_tpu_torch.query.engine.expr import (
    BindContext,
    BoundExpr,
    ColumnBinding,
    EmitContext,
    ExprBinder,
    bindings_to_device,
    cast_plane,
    not_ported,
    order_key_bits,
)
from ytsaurus_tpu_torch.query.engine.window import WindowStage
from ytsaurus_tpu_torch.schema import EValueType, TableSchema

_SIGN64 = -(1 << 63)


@dataclass
class OutputColumn:
    name: str
    type: EValueType
    vocab: Optional[np.ndarray]


@dataclass
class PreparedQuery:
    """Host-bound execution plan for one chunk."""
    run: Callable                  # (columns, row_valid) -> (planes, count)
    output: list[OutputColumn]


def _column_min_max(col, ty: EValueType) -> tuple[int, int]:
    """Min/max of an integer column's valid values, in one stacked host
    read. uint64 planes are read in unsigned order. Not memoized: the
    evaluator is eager and reads its row count back on every run anyway."""
    data = col.data
    unsigned = ty is EValueType.uint64
    if unsigned:
        data = data ^ _SIGN64
    info = torch.iinfo(torch.int64)
    lo_hi = torch.stack([
        torch.where(col.valid, data, torch.full_like(data, info.max)).amin(),
        torch.where(col.valid, data, torch.full_like(data, info.min)).amax(),
    ]).cpu().numpy()
    lo, hi = int(lo_hi[0]), int(lo_hi[1])
    if hi < lo:               # no valid values at all
        return 0, 0
    if unsigned:
        lo, hi = lo + (1 << 63), hi + (1 << 63)
    return lo, hi


def _column_bindings(schema: TableSchema, chunk) -> dict[str, ColumnBinding]:
    out = {}
    for col_schema in schema:
        col = chunk.columns.get(col_schema.name)
        if col is None:
            raise YtError(f"Chunk is missing column {col_schema.name!r}",
                          code=EErrorCode.QueryExecutionError)
        out[col_schema.name] = ColumnBinding(type=col_schema.type,
                                             vocab=col.dictionary)
    return out


def topk_lowest_index(ranked: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim of `ranked`
    (one row of k per leading index), ties broken toward the lowest index
    (the set `lax.top_k` selects), in ascending index order.

    torch.topk's set is that set whenever it holds every entry equal to
    its k-th largest value; where it left some out, torch.topk chose among
    the ties, and the tied entries are taken in index order (their ranks
    are a cumulative sum over the row) until k are."""
    vals, idx = torch.topk(ranked, k, dim=-1, sorted=False)
    kth = vals.amin(dim=-1, keepdim=True)
    tied = ranked == kth
    if bool(((vals == kth).sum(dim=-1) < tied.sum(dim=-1)).any()):
        above = ranked > kth
        room = k - above.sum(dim=-1, keepdim=True)
        take = above | (tied & (torch.cumsum(tied, dim=-1) <= room))
        return torch.nonzero(take)[:, -1].reshape(ranked.shape[:-1] + (k,))
    return torch.sort(idx, dim=-1).values


def _ordered_int64(value: torch.Tensor, unsigned: bool) -> torch.Tensor:
    """An int64 plane whose signed order is the order of `value`: floats by
    their monotone bit encoding (NaN above +inf), uint64 with its sign bit
    flipped, other integers and booleans widened."""
    if value.is_floating_point():
        bits = value.to(torch.float64).view(torch.int64)
        return torch.where(bits < 0, bits ^ 0x7FFFFFFFFFFFFFFF, bits)
    value = value.to(torch.int64)
    return value ^ _SIGN64 if unsigned else value


def prepare(plan: "ir.Query | ir.FrontQuery", chunk) -> PreparedQuery:
    """Bind a plan against one chunk's vocabularies and capacity."""
    capacity = chunk.capacity
    device = chunk.device
    bind_ctx = BindContext(columns=_column_bindings(plan.schema, chunk))
    binder = ExprBinder(bind_ctx)

    where_b: Optional[BoundExpr] = None
    if isinstance(plan, ir.Query) and plan.where is not None:
        where_b = binder.bind(plan.where)

    group = plan.group
    group_key_b: list[tuple[str, BoundExpr]] = []
    agg_arg_b: list = []
    post_binder: Optional[ExprBinder] = None
    having_b = None
    if group is not None:
        for item in group.group_items:
            group_key_b.append((item.name, binder.bind(item.expr)))
        for agg in group.aggregate_items:
            arg = binder.bind(agg.argument) if agg.argument is not None \
                else None
            by_arg = binder.bind(agg.by_argument) \
                if agg.by_argument is not None else None
            agg_arg_b.append((agg, arg, by_arg))
        post_columns: dict[str, ColumnBinding] = {}
        for name, bound in group_key_b:
            post_columns[name] = ColumnBinding(type=bound.type,
                                               vocab=bound.vocab)
        for agg, arg, _ in agg_arg_b:
            vocab = arg.vocab if (arg is not None and
                                  agg.type is EValueType.string) else None
            post_columns[agg.name] = ColumnBinding(type=agg.type, vocab=vocab)
        post_binder = ExprBinder(BindContext(columns=post_columns,
                                             bindings=bind_ctx.bindings))
        if plan.having is not None:
            having_b = post_binder.bind(plan.having)
    final_binder = post_binder if post_binder is not None else binder

    # Window stage: binds partition/order/item expressions and registers
    # the slot columns so ORDER BY and the projection can reference them.
    window = plan.window
    win_stage = None
    if window is not None:
        if group is not None:
            raise YtError("Window functions cannot combine with GROUP BY",
                          code=EErrorCode.QueryUnsupported)
        win_stage = WindowStage(window, binder)
        bind_ctx.columns.update(win_stage.slot_bindings())

    order_b: list[tuple[BoundExpr, bool]] = []
    if plan.order is not None:
        for item in plan.order.items:
            order_b.append((final_binder.bind(item.expr), item.descending))

    project_b: list[tuple[str, BoundExpr]] = []
    if plan.project is not None:
        for item in plan.project.items:
            project_b.append((item.name, final_binder.bind(item.expr)))
    elif group is not None:
        for name, bound in group_key_b:
            project_b.append((name, _post_ref_t(name, bound.type,
                                                bound.vocab)))
        for agg, arg, _ in agg_arg_b:
            vocab = arg.vocab if (arg is not None and
                                  agg.type is EValueType.string) else None
            project_b.append((agg.name, _post_ref_t(agg.name, agg.type,
                                                    vocab)))
    else:
        for col_schema in plan.schema:
            project_b.append(
                (col_schema.name,
                 final_binder.bind(ir.TReference(type=col_schema.type,
                                                 name=col_schema.name))))
        if window is not None:
            # The identity projection carries the window slots.
            for item in window.items:
                project_b.append(
                    (item.name,
                     final_binder.bind(ir.TReference(type=item.type,
                                                     name=item.name))))

    output = [OutputColumn(name=name, type=b.type, vocab=b.vocab)
              for name, b in project_b]
    offset = plan.offset
    limit = plan.limit
    order_bits = [order_key_bits(bound) for bound, _desc in order_b]

    # --- dense GROUP BY -------------------------------------------------------
    # When every group key has a small known value domain (dictionary
    # codes, booleans, integer columns spanning at most 65536 values),
    # segment ids come from stride arithmetic: no sort.
    fast_group = None
    if group is not None:
        sizes_offsets: "list[tuple[int, int]] | None" = []
        for item, (_, bound) in zip(group.group_items, group_key_b):
            if bound.type is EValueType.string and bound.vocab is not None:
                sizes_offsets.append((len(bound.vocab), 0))
            elif bound.type is EValueType.boolean:
                sizes_offsets.append((2, 0))
            elif bound.type in (EValueType.int64, EValueType.uint64) and \
                    isinstance(item.expr, ir.TReference):
                col = chunk.columns.get(item.expr.name)
                if getattr(col, "data", None) is None:
                    # A rep chunk (the mesh's bind-only view) carries no
                    # planes to read a min/max from: the general path.
                    sizes_offsets = None
                    break
                lo, hi = _column_min_max(col, bound.type)
                if hi - lo + 1 > 65536:
                    sizes_offsets = None
                    break
                sizes_offsets.append((hi - lo + 1, lo))
            else:
                sizes_offsets = None
                break
        if sizes_offsets is not None:
            dims = 1
            for s, _ in sizes_offsets:
                dims *= s + 1          # +1 slot per key for NULL
            if 0 < dims <= 65536:
                strides = []
                acc = 1
                for s, _ in reversed(sizes_offsets):
                    strides.append(acc)
                    acc *= s + 1
                strides.reverse()
                fast_group = (tuple(sizes_offsets), tuple(strides), dims,
                              pad_capacity(dims + 1))

    # Single-key ORDER BY ... LIMIT k: select candidates by top-k and sort
    # only those.
    k_limit = (offset + limit) if limit is not None else None
    group_stage_cap = fast_group[3] if fast_group else capacity
    use_topk = (len(order_b) == 1 and k_limit is not None
                and 0 < k_limit <= 1024 and group_stage_cap > 4 * k_limit)
    bindings_host = bind_ctx.bindings

    def run(columns: dict, row_valid: torch.Tensor):
        bindings = bindings_to_device(bindings_host, device)

        def emit_ctx(cols, cap):
            return EmitContext(columns=cols, bindings=bindings, capacity=cap,
                               device=device)

        ctx = emit_ctx(columns, capacity)
        stage_cap = capacity
        mask = row_valid
        if where_b is not None:
            d, v = where_b.emit(ctx)
            mask = mask & v & d.to(torch.bool)

        if group is not None and fast_group is not None:
            mask, ctx, stage_cap = _dense_group(
                ctx, mask, fast_group, group_key_b, agg_arg_b, emit_ctx)
        elif group is not None:
            mask, ctx = _general_group(ctx, mask, capacity, group_key_b,
                                       agg_arg_b, emit_ctx)
        if having_b is not None:
            d, v = having_b.emit(ctx)
            mask = mask & v & d.to(torch.bool)

        if win_stage is not None:
            # Window columns join the namespace; no rows move.
            ctx = emit_ctx({**ctx.columns, **win_stage.emit(ctx, mask)},
                           stage_cap)

        if order_b:
            if use_topk:
                bound, descending = order_b[0]
                data, valid = bound.emit(ctx)
                value, _ = sort_key_planes(data, valid, descending)
                # Invert the value so the query's front is the top: valid
                # rows compete by value; null rows (all equal) by an
                # indicator pass; a third pass covers valid rows whose
                # inverted value aliases the exclusion sentinel.
                if value.is_floating_point():
                    inv = _ordered_int64(-value.to(torch.float64), False)
                else:
                    inv = ~_ordered_int64(
                        value, bound.type is EValueType.uint64)
                bottom = torch.iinfo(torch.int64).min
                include = mask & valid
                ranked = torch.where(include, inv, bottom)
                idx1 = topk_lowest_index(ranked, k_limit)
                idx2 = topk_lowest_index((mask & ~valid).to(torch.int64),
                                         k_limit)
                idx3 = topk_lowest_index(
                    (include & (inv == bottom)).to(torch.int64), k_limit)
                cand, _ = torch.sort(torch.cat([idx1, idx2, idx3]))
                dup = torch.cat([torch.zeros(1, dtype=torch.bool,
                                             device=device),
                                 cand[1:] == cand[:-1]])
                cand_cap = cand.shape[0]
                ctx = emit_ctx({name: (d[cand], v[cand])
                                for name, (d, v) in ctx.columns.items()},
                               cand_cap)
                mask = mask[cand] & ~dup
                stage_cap = cand_cap
            # Packed composite sort key: masked-last bit + every ORDER BY
            # item (null bit + order-preserving value bits).
            items = [((~mask), torch.ones_like(mask), False, 1)]
            for (bound, descending), bits in zip(order_b, order_bits):
                data, valid = bound.emit(ctx)
                items.append((data, valid, descending, bits,
                              bound.type is EValueType.uint64))
            order_idx = packed_sort_indices(items)
            ctx = emit_ctx({name: (d[order_idx], v[order_idx])
                            for name, (d, v) in ctx.columns.items()},
                           stage_cap)
            mask = mask[order_idx]

        planes = [bound.emit(ctx) for _, bound in project_b]

        # Compact valid rows to the front (stable: keeps the sort order).
        comp_idx, total = compact_mask(mask)
        off = min(offset, stage_cap)
        count = total - off
        if limit is not None:
            count = torch.clamp(count, max=min(limit, stage_cap))
        count = torch.clamp(count, min=0)
        iota = torch.arange(stage_cap, device=device)
        src = comp_idx[(iota + off).clamp(0, stage_cap - 1)]
        in_window = iota < count
        out_planes = [(_rows(d, stage_cap)[src], v.expand(stage_cap)[src]
                       & in_window) for d, v in planes]
        return out_planes, count

    return PreparedQuery(run=run, output=output)


def _rows(plane: torch.Tensor, capacity: int) -> torch.Tensor:
    """A plane spanning `capacity` rows: a scalar plane of fewer rows (a
    literal) is expanded; a (rows, dim) vector plane is taken as it is."""
    return plane.expand(capacity) if plane.ndim == 1 else plane


def _dense_group(ctx, mask, fast_group, group_key_b, agg_arg_b, emit_ctx):
    """GROUP BY over small key domains: segment id = sum of key code times
    stride; one garbage slot takes the masked-out rows."""
    sizes_offsets, strides, dims, seg_cap = fast_group
    nseg = dims + 1
    device = mask.device

    def _pad(plane):
        out = torch.zeros(seg_cap, dtype=plane.dtype, device=device)
        out[:nseg] = plane
        return out

    seg = torch.zeros(ctx.capacity, dtype=torch.int64, device=device)
    for (_, b), (size, key_offset), stride in zip(group_key_b, sizes_offsets,
                                                  strides):
        data, valid = b.emit(ctx)
        if data.is_floating_point() or data.dtype == torch.bool:
            shifted = data.to(torch.int64) - key_offset
        else:
            # Wrapping 64-bit subtraction: right for int64 offsets near the
            # type bounds and for uint64 keys at or above 2^63.
            off = key_offset % (1 << 64)
            off = off - (1 << 64) if off >= (1 << 63) else off
            shifted = data.to(torch.int64) - off
        code = torch.where(valid, shifted.to(torch.int32).to(torch.int64),
                           torch.full_like(shifted, size))
        seg = seg + code * stride
    seg = torch.where(mask, seg, torch.full_like(seg, dims))

    # Every count, sum, min and max of the stage (both halves of an avg)
    # reduces in one segment_reduce_many call, its planes already padded
    # to seg_cap with zeros; `finish` turns each result into the planes
    # segment_aggregate gives, padded.
    slot = torch.arange(seg_cap, dtype=torch.int64, device=device)
    in_range = slot < nseg
    specs = [("count", None, mask)]
    finish: dict = {}
    masked_valid: dict = {}           # id(arg's valid plane) -> valid & mask

    def collect(agg, arg):
        data, valid = arg.emit(ctx)
        if id(valid) not in masked_valid:
            masked_valid[id(valid)] = (valid, valid & mask)
        valid = masked_valid[id(valid)][1]
        first = len(specs)
        if agg.function == "avg":
            specs.append(("sum", cast_plane(data, arg.type,
                                            EValueType.double), valid))
            return lambda r: (r[first][0] / torch.clamp(r[first][1], min=1),
                              r[first][1] > 0)
        if agg.function == "count":
            specs.append(("count", None, valid))
            return lambda r: (r[first][0], in_range)
        if agg.function == "sum":
            specs.append(("sum", data, valid))
            return lambda r: (r[first][0], r[first][1] > 0)
        specs.append((agg.function, min_max_plane(data, agg.type), valid))
        if agg.type is EValueType.uint64:     # the flip leaves pads nonzero
            return lambda r: (torch.where(in_range, min_max_result(
                r[first][0], agg.type), 0), r[first][1] > 0)
        return lambda r: (min_max_result(r[first][0], agg.type),
                          r[first][1] > 0)

    for agg, arg, by_arg in agg_arg_b:
        if agg.function in ("avg", "count", "sum", "min", "max"):
            finish[agg.name] = collect(agg, arg)
    reduced = segment_reduce_many(specs, seg, nseg, width=seg_cap)
    present = (slot < dims) & (reduced[0][0] > 0)
    new_columns: dict = {}
    for (name, bound), (size, key_offset), stride in zip(
            group_key_b, sizes_offsets, strides):
        code = (slot // stride) % (size + 1)
        key_valid = code < size
        data = code.clamp(0, max(size - 1, 0))
        if bound.type is EValueType.boolean:
            data = data.to(torch.bool)
        elif bound.type in (EValueType.int64, EValueType.uint64):
            off = key_offset % (1 << 64)
            off = off - (1 << 64) if off >= (1 << 63) else off
            data = data + off
        else:
            data = data.to(torch.int32)
        new_columns[name] = (data, key_valid)
    for agg, arg, by_arg in agg_arg_b:
        new_columns[agg.name] = finish[agg.name](reduced) \
            if agg.name in finish else tuple(_pad(p) for p in _aggregate(
                ctx, agg, arg, by_arg, mask, None, seg, nseg))
    return present, emit_ctx(new_columns, seg_cap), seg_cap


def _general_group(ctx, mask, capacity, group_key_b, agg_arg_b, emit_ctx):
    """GROUP BY over any keys: the exact-key radix sort makes equal keys
    adjacent, masked rows last; segment ids follow from key changes."""
    device = mask.device
    key_planes = [b.emit(ctx) for _, b in group_key_b]
    order_idx = hash_group_order(
        [(d, v, b.type is EValueType.uint64)
         for (d, v), (_, b) in zip(key_planes, group_key_b)], mask)
    sorted_mask = mask[order_idx]
    sorted_keys = [(d.expand(capacity)[order_idx],
                    v.expand(capacity)[order_idx]) for d, v in key_planes]
    seg_ids, num_groups = segment_boundaries(sorted_keys, sorted_mask)
    new_columns: dict = {}
    for (name, _), (data, valid) in zip(group_key_b, sorted_keys):
        out_d, _ = segment_aggregate("first", data, sorted_mask, seg_ids,
                                     capacity, EValueType.null)
        out_v, _ = segment_aggregate("first", valid.to(torch.int8),
                                     sorted_mask, seg_ids, capacity,
                                     EValueType.null)
        new_columns[name] = (out_d, out_v.to(torch.bool))
    for agg, arg, by_arg in agg_arg_b:
        new_columns[agg.name] = _aggregate(ctx, agg, arg, by_arg, sorted_mask,
                                           order_idx, seg_ids, capacity)
    mask = torch.arange(capacity, device=device) < num_groups
    return mask, emit_ctx(new_columns, capacity)


def _aggregate(ctx, agg, arg, by_arg, gmask, order, seg, nseg):
    """One aggregate over segment ids `seg`; `order` (or None) is the row
    order the group stage applied, and gmask the row mask in that order."""
    def rows(plane):
        return plane if order is None else plane[order]

    if agg.function == "avg":
        data, valid = arg.emit(ctx)
        data = cast_plane(rows(data), arg.type, EValueType.double)
        valid = rows(valid) & gmask
        s, sv = segment_aggregate("sum", data, valid, seg, nseg,
                                  EValueType.double)
        c, _ = segment_aggregate("count", data, valid, seg, nseg,
                                 EValueType.int64)
        return s / torch.clamp(c, min=1), sv
    if agg.function == "cardinality":
        data, valid = arg.emit(ctx)
        return segment_distinct_count(rows(data), rows(valid) & gmask, seg,
                                      nseg)
    if agg.function in ("argmin", "argmax"):
        vd, vv = arg.emit(ctx)
        bd, bv = by_arg.emit(ctx)
        return segment_arg_by(rows(vd), rows(vv), rows(bd),
                              rows(bv) & gmask, seg, nseg,
                              take_max=(agg.function == "argmax"),
                              by_unsigned=by_arg.type is EValueType.uint64)
    if agg.function not in ("sum", "min", "max", "count", "first"):
        raise not_ported(f"Aggregate {agg.function!r}")
    data, valid = arg.emit(ctx)
    return segment_aggregate(agg.function, rows(data), rows(valid) & gmask,
                             seg, nseg, agg.type)


def _post_ref_t(name: str, ty: EValueType, vocab) -> BoundExpr:
    def emit(ctx: EmitContext):
        return ctx.columns[name]
    return BoundExpr(type=ty, vocab=vocab, emit=emit)
