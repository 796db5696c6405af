"""Window functions: segmented scans over partition-sorted planes.

Port of the JAX package's `query/engine/window.py` (`WindowStage`). One
packed radix sort (`packed_sort_indices`, the radix kernels on the card)
brings equal PARTITION BY keys together, ordered by the ORDER BY spec
inside each partition; then every window item is a segmented scan,
shifted gather or scan difference over the sorted planes:

  row_number        position within the segment
  rank              peer-boundary running max
  dense_rank        segmented cumsum of peer boundaries
  lag / lead        within-segment shifted gather
  first/last_value  gather at the frame boundary row
  sum/count/avg     inclusive segmented scan, ROWS frame = P[hi] - P[lo-1]
  min / max         prefix or suffix scans, or a sparse-table range query
                    for frames bounded on both sides

Results scatter back to the input row order through the inverse
permutation, so the stage ADDS columns without moving rows.

uint64 planes are int64 bit patterns here, so min and max over them flip
the sign bit around the scan; float sums use the log-step scan of
`ops/segments.py` and agree with the reference to a relative tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.ops.segments import (
    _reduce_neutral,
    packed_sort_indices,
    segment_end_index,
    segment_position,
    segment_range_extreme,
    segment_scan,
    segment_shift,
    segment_start_index,
    segment_suffix_scan,
)
from ytsaurus_tpu_torch.query import ir
from ytsaurus_tpu_torch.query.engine.expr import (
    ColumnBinding,
    EmitContext,
    ExprBinder,
    _gather_binding,
    _merge_vocabs,
    _pad_np,
    _remap_table,
    _vocab_bucket,
    cast_plane,
    order_key_bits,
)
from ytsaurus_tpu_torch.schema import EValueType

_SIGN64 = -(1 << 63)


class WindowStage:
    """Host-bound window stage for one chunk: binds partition, order and
    item expressions (appending vocabulary tables to the shared bindings),
    exposes the slot column bindings for downstream references, and emits
    the computation."""

    def __init__(self, window: ir.WindowClause, binder: ExprBinder):
        self.partition_b = [binder.bind(item.expr)
                            for item in window.partition_items]
        self.order_b = [(binder.bind(oi.expr), oi.descending)
                        for oi in window.order_items]
        self.items_b = []
        for item in window.items:
            arg = binder.bind(item.argument) \
                if item.argument is not None else None
            dflt = binder.bind(item.default) \
                if item.default is not None else None
            # String lag/lead with a string default: both planes must land
            # in ONE code space, through remap tables onto merged vocabs.
            vocab = None
            arg_gather = dflt_gather = None
            if item.type is EValueType.string:
                vocab = arg.vocab
                if dflt is not None and dflt.type is EValueType.string:
                    vocab = _merge_vocabs(arg.vocab, dflt.vocab)
                    for side in (arg, dflt):
                        side_vocab = side.vocab if side.vocab is not None \
                            else np.array([], dtype=object)
                        table = _remap_table(side_vocab, vocab)
                        slot = binder.ctx.add(_pad_np(
                            table, _vocab_bucket(max(len(side_vocab), 1)),
                            0))
                        if side is arg:
                            arg_gather = _gather_binding(slot)
                        else:
                            dflt_gather = _gather_binding(slot)
            self.items_b.append((item, arg, dflt, vocab,
                                 arg_gather, dflt_gather))

    def slot_bindings(self) -> dict[str, ColumnBinding]:
        return {item.name: ColumnBinding(type=item.type, vocab=vocab)
                for item, _, _, vocab, _, _ in self.items_b}

    def emit(self, ctx: EmitContext, mask: torch.Tensor
             ) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
        """Every window column, in the INPUT row order, validity already
        restricted to `mask`."""
        n = ctx.capacity
        device = mask.device
        iota = torch.arange(n, dtype=torch.int64, device=device)

        def full(plane):
            return plane.expand(n)

        # One packed sort: masked-last, then partition keys (ascending:
        # groups only need adjacency), then the ORDER BY spec.
        sort_items = [((~mask), torch.ones_like(mask), False, 1)]
        part_planes = [tuple(map(full, b.emit(ctx)))
                       for b in self.partition_b]
        for b, (d, v) in zip(self.partition_b, part_planes):
            sort_items.append((d, v, False, order_key_bits(b),
                               b.type is EValueType.uint64))
        order_planes = [tuple(map(full, b.emit(ctx)))
                        for b, _ in self.order_b]
        for (b, descending), (d, v) in zip(self.order_b, order_planes):
            sort_items.append((d, v, descending, order_key_bits(b),
                               b.type is EValueType.uint64))
        order_idx = packed_sort_indices(sort_items)
        inv = torch.empty(n, dtype=torch.int64, device=device)
        inv[order_idx] = iota

        s_mask = mask[order_idx]

        def changes(plane):
            return plane != torch.roll(plane, 1)

        # Segment starts: row 0, any partition-key change, and the
        # unmasked → masked transition (so the trailing masked rows never
        # extend a real partition's frame).
        starts = changes(s_mask)
        for d, v in part_planes:
            starts = starts | changes(d[order_idx]) | changes(v[order_idx])
        starts[0] = True
        # Peer boundaries: a new segment or any ORDER BY key change.
        peers = starts
        for d, v in order_planes:
            peers = peers | changes(d[order_idx]) | changes(v[order_idx])

        seg_lo = segment_start_index(starts)
        seg_hi = segment_end_index(starts)
        # Last row of each ORDER BY peer group: the default frame's end.
        peer_end = None
        if any(item.frame[2] == "peer" for item, *_ in self.items_b):
            peer_end = segment_end_index(peers)

        out: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        for item, arg, dflt, vocab, arg_gather, dflt_gather in self.items_b:
            data, valid = self._emit_item(
                ctx, item, arg, dflt, arg_gather, dflt_gather,
                order_idx, s_mask, starts, peers, seg_lo, seg_hi,
                peer_end, iota)
            out[item.name] = (data[inv], valid[inv] & mask)
        return out

    def _frame_range(self, item: ir.WindowItem, seg_lo, seg_hi, peer_end,
                     iota):
        lo_kind, lo_off, hi_kind, hi_off = item.frame
        lo = seg_lo if lo_kind == "unbounded" else \
            torch.maximum(seg_lo, iota + lo_off)
        if hi_kind == "unbounded":
            hi = seg_hi
        elif hi_kind == "peer":
            hi = peer_end
        else:
            hi = torch.minimum(seg_hi, iota + hi_off)
        return lo, hi, lo > hi

    def _emit_item(self, ctx, item, arg, dflt, arg_gather, dflt_gather,
                   order_idx, s_mask, starts, peers, seg_lo, seg_hi,
                   peer_end, iota):
        fn = item.function
        n = s_mask.shape[0]
        ones = torch.ones(n, dtype=torch.bool, device=s_mask.device)

        if fn == "row_number":
            return segment_position(starts) + 1, ones
        if fn == "rank":
            return segment_start_index(peers) - seg_lo + 1, ones
        if fn == "dense_rank":
            return segment_scan("sum", peers.to(torch.int64), starts), ones

        a_data, a_valid = arg.emit(ctx)
        a_data = a_data.expand(n)[order_idx]
        a_valid = a_valid.expand(n)[order_idx] & s_mask
        if arg_gather is not None:
            a_data = arg_gather(ctx, a_data)

        if fn in ("lag", "lead"):
            shift = item.offset if fn == "lag" else -item.offset
            sh_d, sh_v, in_seg = segment_shift(a_data, a_valid, starts,
                                               shift, seg_lo=seg_lo,
                                               seg_hi=seg_hi)
            if dflt is None:
                return sh_d, sh_v & in_seg
            d_data, d_valid = dflt.emit(ctx)
            d_data = d_data.expand(n)[order_idx]
            d_valid = d_valid.expand(n)[order_idx]
            if dflt_gather is not None:
                d_data = dflt_gather(ctx, d_data)
            if sh_d.dtype != d_data.dtype:
                common = torch.promote_types(sh_d.dtype, d_data.dtype)
                sh_d, d_data = sh_d.to(common), d_data.to(common)
            return torch.where(in_seg, sh_d, d_data), \
                torch.where(in_seg, sh_v, d_valid)

        lo, hi, empty = self._frame_range(item, seg_lo, seg_hi, peer_end,
                                          iota)
        lo_c = lo.clamp(0, n - 1)
        hi_c = hi.clamp(0, n - 1)

        if fn == "first_value":
            return a_data[lo_c], a_valid[lo_c] & ~empty
        if fn == "last_value":
            return a_data[hi_c], a_valid[hi_c] & ~empty

        def frame_total(prefix):
            """The frame's sum from the segment's inclusive prefix scan."""
            before = prefix[(lo - 1).clamp(0, n - 1)]
            return prefix[hi_c] - torch.where(lo > seg_lo, before,
                                              torch.zeros_like(before))

        # Framed aggregates: the count of contributing rows first (the
        # validity of every other aggregate, the result of count itself).
        cnt = frame_total(segment_scan("sum", a_valid.to(torch.int64),
                                       starts))
        cnt = torch.where(empty, torch.zeros_like(cnt), cnt)
        if fn == "count":
            return cnt, ones

        if fn in ("sum", "avg"):
            acc = EValueType.double if fn == "avg" else item.type
            contrib = cast_plane(a_data, arg.type, acc)
            contrib = torch.where(a_valid, contrib, torch.zeros_like(contrib))
            total = frame_total(segment_scan("sum", contrib, starts))
            if fn == "avg":
                total = total / cnt.clamp(min=1)
            return total, cnt > 0

        if fn in ("min", "max"):
            unsigned = arg.type is EValueType.uint64
            if a_data.dtype == torch.bool:
                a_data = a_data.to(torch.int8)
            if unsigned:
                a_data = a_data ^ _SIGN64
            lo_kind, lo_off, hi_kind, hi_off = item.frame
            if lo_kind == "unbounded" or hi_kind == "unbounded":
                neutral = torch.full_like(
                    a_data, _reduce_neutral(a_data.dtype, fn))
                base = torch.where(a_valid, a_data, neutral)
                if lo_kind == "unbounded" and hi_kind == "unbounded":
                    data = segment_scan(fn, base, starts)[seg_hi]
                elif lo_kind == "unbounded":
                    data = segment_scan(fn, base, starts)[hi_c]
                else:
                    data = segment_suffix_scan(fn, base, starts)[lo_c]
            else:
                data = segment_range_extreme(
                    fn, a_data, a_valid, lo_c, torch.maximum(hi_c, lo_c),
                    max_width=hi_off - lo_off + 1)
            if unsigned:
                data = data ^ _SIGN64
            if item.type is EValueType.boolean:
                data = data.to(torch.bool)
            return data, cnt > 0

        raise YtError(f"Window function {fn!r} has no lowering",
                      code=EErrorCode.QueryUnsupported)
