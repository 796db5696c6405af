"""Segmented reductions and sort-key helpers used by GROUP BY / ORDER BY.

Port of the JAX package's `ops/segments.py`: `sort_key_planes`,
`segment_boundaries`, the reduce dispatch, `segment_aggregate`,
`segment_arg_by`, `segment_distinct_count`, `compact_mask`,
`monotone_u32_words`, `pack_key_planes_bits`, `stable_argsort_u32`,
`packed_sort_indices`, `hash_group_order`, `lexsort_indices` and the
segment scans of the window stage (`segment_scan`, `segment_suffix_scan`,
`segment_start_index`, `segment_end_index`, `segment_position`,
`segment_shift`, `segment_range_extreme`).

Differences from the reference, all of them forced by torch:
  * u32 key words are int64 tensors holding values in [0, 2^32), since
    torch has no uint32 arithmetic on the CPU; argsorts return int64.
  * uint64 columns are int64 bit patterns, so the functions whose result
    depends on unsigned order take an explicit `unsigned` flag (the
    reference reads it off the dtype).
  * Reductions over at most 16 segments: on the CPU a masked full
    reduction per segment (`_dense_segment_reduce`). On the card the
    dense GROUP BY hands every reduction of its stage to
    `segment_reduce_many` at once, which launches the hand-written
    `csrc/dense_reduce.cu` (`ops/dense_reduce.py`): one pass over the
    rows for all the stage's planes and segments, then a fold in block
    order, two kernels a stage. It never falls back to the loop; its
    float sums add in a fixed order of its own, so they agree with the
    reference to a relative tolerance and are the same on every run.
  * Reductions over more than 16 segments use torch's scatter ops
    (`index_add_`, `scatter_reduce_`), the JAX package's CPU engine. On
    CUDA these add floats with atomics in no fixed order, so double sums
    agree with the reference to a relative tolerance, not bit for bit.
  * Every stable argsort is the radix engine (`ops/radix.py`): the
    `radix_upsweep` and `radix_onesweep` kernels on the card.
  * Segment ids past the last segment are dropped explicitly: torch
    raises on an out-of-range index where JAX drops or clamps.
  * `lexsort_indices` packs its planes into u32 words for the radix sort
    instead of calling a comparison sort; it keeps `jnp.lexsort`'s order.
  * Segmented scans: integer sums are a whole-plane `cumsum` minus the
    value before each segment's start (int64 wraps alike in both
    packages); float sums, min and max are a log-step segmented scan that
    resets at segment starts, so a large segment never cancels into a
    small one after it. The segment start and end indices come from a
    scatter into a table by segment number, not a running max. Float sums
    therefore agree with the reference's `associative_scan` to a relative
    tolerance, not bit for bit.
"""

from __future__ import annotations

import torch

from ytsaurus_tpu_torch.ops.dense_reduce import dense_reduce
from ytsaurus_tpu_torch.ops.radix import radix_argsort_u32
from ytsaurus_tpu_torch.schema import EValueType

_M32 = 0xFFFFFFFF
_SIGN32 = 1 << 31
_SIGN64 = -(1 << 63)          # the int64 with only the sign bit set


def sort_key_planes(data: torch.Tensor, valid: torch.Tensor,
                    descending: bool = False) -> list[torch.Tensor]:
    """Ascending-order planes encoding (null, value): [value, null_key].

    Null sorts before any value; for descending order the value plane is
    complemented (integers) or negated (floats) and nulls sort last."""
    if data.dtype == torch.bool:
        data = data.to(torch.int8)
    if descending:
        value = ~data if not data.is_floating_point() else -data
        null_key = (~valid).to(torch.int8)
    else:
        value = data
        null_key = valid.to(torch.int8)
    value = torch.where(valid, value, torch.zeros_like(value))
    return [value, null_key]


def segment_boundaries(sorted_keys: list[tuple[torch.Tensor, torch.Tensor]],
                       in_mask: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Given key (data, valid) planes in sorted order plus the row mask
    (sorted so that masked-out rows are at the end), return
    (segment_ids, num_segments). Masked-out rows get segment id
    num_segments."""
    cap = in_mask.shape[0]
    change = torch.zeros(cap, dtype=torch.bool, device=in_mask.device)
    for data, valid in sorted_keys:
        differs = (data != torch.roll(data, 1)) | (valid != torch.roll(valid, 1))
        change = change | differs
    change[0] = False
    boundary = change & in_mask
    seg = torch.cumsum(boundary.to(torch.int64), 0)
    num_segments = torch.where(in_mask.any(), seg[-1] + 1,
                               torch.zeros_like(seg[-1]))
    seg = torch.where(in_mask, seg, num_segments)
    return seg, num_segments


# Up to this many segments a reduce is a masked full reduction per segment
# (deterministic, no atomics); above it, one scatter pass.
_DENSE_SEGMENT_LIMIT = 16


def _reduce_neutral(dtype: torch.dtype, function: str):
    if dtype.is_floating_point:
        return float("inf") if function == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if function == "min" else info.min


def _dense_segment_reduce(function: str, data: torch.Tensor,
                          seg_ids: torch.Tensor, num_segments: int):
    if function == "sum":
        fill, reduce = 0, torch.sum
    elif function in ("min", "max"):
        fill = _reduce_neutral(data.dtype, function)
        reduce = torch.amin if function == "min" else torch.amax
    else:
        raise ValueError(function)
    if data.shape[0] == 0:            # torch.amin refuses an empty plane
        return torch.full((num_segments,), fill, dtype=data.dtype,
                          device=data.device)
    outs = [reduce(torch.where(seg_ids == s, data, fill)).to(data.dtype)
            for s in range(num_segments)]
    if not outs:
        return torch.zeros(0, dtype=data.dtype, device=data.device)
    return torch.stack(outs)


# Rows that contribute only the reduction's neutral value scatter into this
# many spare slots, by row index, instead of into their segment's slot.
_SPARE_SLOTS = 1 << 16


def _scatter_segment_reduce(function: str, data: torch.Tensor,
                            seg_ids: torch.Tensor, num_segments: int,
                            live: torch.Tensor):
    """One scatter pass into num_segments slots plus spare slots, which are
    dropped: out-of-range ids (masked rows parked past the last segment)
    take the first spare slot, and rows outside `live` (rows that add
    only the neutral value) spread over all of them. On the card a
    filtered group stage would otherwise send its whole masked tail to
    one slot, whose atomics run one after another."""
    iota = torch.arange(seg_ids.shape[0], dtype=torch.int64,
                        device=seg_ids.device)
    idx = torch.where(live, seg_ids.to(torch.int64).clamp(0, num_segments),
                      num_segments + (iota & (_SPARE_SLOTS - 1)))
    size = num_segments + _SPARE_SLOTS
    if function == "sum":
        out = torch.zeros(size, dtype=data.dtype, device=data.device)
        out.index_add_(0, idx, data)
        return out[:num_segments]
    if function not in ("min", "max"):
        raise ValueError(function)
    out = torch.full((size,), _reduce_neutral(data.dtype, function),
                     dtype=data.dtype, device=data.device)
    out.scatter_reduce_(0, idx, data, "amin" if function == "min" else "amax",
                        include_self=True)
    return out[:num_segments]


def _segment_reduce(function: str, data: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int, live: torch.Tensor):
    """`live` marks the rows whose value is not the reduction's neutral
    one; the result does not depend on it."""
    if num_segments <= _DENSE_SEGMENT_LIMIT:
        return _dense_segment_reduce(function, data, seg_ids, num_segments)
    return _scatter_segment_reduce(function, data, seg_ids, num_segments,
                                   live)


def segment_reduce_many(specs, seg_ids: torch.Tensor, num_segments: int,
                        width: "int | None" = None
                        ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Several reductions over one set of segment ids. A spec is
    (function, data, valid): "sum", "min" or "max" of `data` over the rows
    where `valid` is true, or "count" (data None) of those rows. Returns,
    per spec, (value, count): the per-segment value in `segment_aggregate`'s
    dtype (int64 for a sum of booleans; for "count" the count itself) and
    the per-segment count of valid rows, int64. A segment with no valid row
    holds the reduction's neutral value. Specs whose `valid` is the same
    tensor share one count. Each plane has `width` entries (num_segments
    by default), zero past the last segment.

    On a CUDA tensor with at most 16 segments this is one call of the
    `dense_reduce` kernels (one more for each further 64 reductions) and
    never the loop; otherwise the plain version, each reduction as
    `segment_aggregate` runs it."""
    width = num_segments if width is None else width
    if seg_ids.device.type == "cuda" and \
            num_segments <= _DENSE_SEGMENT_LIMIT:
        return _reduce_many_kernel(specs, seg_ids, num_segments, width)
    return _reduce_many_plain(specs, seg_ids, num_segments, width)


def _reduce_many_plain(specs, seg_ids, num_segments, width):
    """segment_reduce_many as `segment_aggregate` runs each reduction, on
    any device: the kernel's plain version."""
    def pad(plane):
        return torch.cat([plane, plane.new_zeros(width - num_segments)])

    counts: dict = {}
    out = []
    for function, data, valid in specs:
        if id(valid) not in counts:
            counts[id(valid)] = pad(_masked_reduce("count", None, valid,
                                                   seg_ids, num_segments))
        count = counts[id(valid)]
        value = count if function == "count" else pad(_masked_reduce(
            function, data, valid, seg_ids, num_segments))
        out.append((value, count))
    return out


def _masked_reduce(function: str, data, valid: torch.Tensor,
                   seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per segment, the "count" of the rows where `valid` is true (data
    unused) or the "sum", "min" or "max" of `data` over them; a segment
    with none holds the reduction's neutral value."""
    if function == "count":
        return _segment_reduce("sum", valid.to(torch.int64), seg_ids,
                               num_segments, valid)
    if function == "sum":
        fill = 0
    elif function in ("min", "max"):
        fill = _reduce_neutral(data.dtype, function)
    else:
        raise ValueError(function)
    return _segment_reduce(function, torch.where(valid, data, fill),
                           seg_ids, num_segments, valid)


def _reduce_many_kernel(specs, seg_ids, num_segments, width):
    """segment_reduce_many through `dense_reduce`: planes narrower than 64
    bits are widened for the kernel and its results cast back."""
    jobs: list = []
    count_job: dict = {}
    where = []                        # (value's job, count's job, dtype)
    for function, data, valid in specs:
        if id(valid) not in count_job:
            count_job[id(valid)] = len(jobs)
            jobs.append(("count", None, valid, 0))
        if function == "count":
            where.append((count_job[id(valid)], count_job[id(valid)],
                          torch.int64))
            continue
        if function not in ("sum", "min", "max"):
            raise ValueError(function)
        # The dtype of torch.where(valid, data, 0) for a sum.
        dtype = torch.int64 if function == "sum" and \
            data.dtype == torch.bool else data.dtype
        wide = torch.float64 if dtype.is_floating_point else torch.int64
        neutral = 0 if function == "sum" else _reduce_neutral(dtype,
                                                              function)
        where.append((len(jobs), count_job[id(valid)], dtype))
        jobs.append((function, data if data.dtype == wide else data.to(wide),
                     valid, neutral))
    res = dense_reduce(jobs, seg_ids, num_segments, width)
    out = []
    for value_job, count_of, dtype in where:
        value = res[value_job]
        if dtype.is_floating_point:
            value = value.view(torch.float64)
        if value.dtype != dtype:
            value = value.to(dtype)
        out.append((value, res[count_of]))
    return out


def min_max_plane(data: torch.Tensor, value_type: EValueType
                  ) -> torch.Tensor:
    """A plane as min / max reduce it: booleans as int8, uint64 bit
    patterns with the sign bit flipped (unsigned order as signed order)."""
    if data.dtype == torch.bool:
        data = data.to(torch.int8)
    if value_type is EValueType.uint64:
        data = data ^ _SIGN64
    return data


def min_max_result(out: torch.Tensor, value_type: EValueType
                   ) -> torch.Tensor:
    """The inverse of `min_max_plane` on the reduced values."""
    if value_type is EValueType.uint64:
        out = out ^ _SIGN64
    if value_type is EValueType.boolean:
        out = out.to(torch.bool)
    return out


def segment_aggregate(function: str, data: torch.Tensor, valid: torch.Tensor,
                      seg_ids: torch.Tensor, num_segments: int,
                      value_type: EValueType
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Aggregate `data` per segment, skipping nulls. Returns (out, out_valid)
    planes of length num_segments."""
    count = _masked_reduce("count", None, valid, seg_ids, num_segments)
    any_valid = count > 0
    if function == "count":
        return count, torch.ones_like(any_valid)
    if function == "sum":
        return _masked_reduce("sum", data, valid, seg_ids, num_segments), \
            any_valid
    if function in ("min", "max"):
        out = _masked_reduce(function, min_max_plane(data, value_type),
                             valid, seg_ids, num_segments)
        return min_max_result(out, value_type), any_valid
    if function == "first":
        first_idx = _segment_first_index(valid, seg_ids, num_segments)
        return data[first_idx], any_valid
    raise ValueError(f"Unknown segment aggregate {function!r}")


def _segment_first_index(eligible: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """First row index per segment among `eligible` rows (clipped sentinel
    when a segment has none; callers mask validity separately)."""
    cap = eligible.shape[0]
    iota = torch.arange(cap, dtype=torch.int64, device=eligible.device)
    idx = torch.where(eligible, iota, torch.full_like(iota, cap - 1))
    first = _segment_reduce("min", idx, seg_ids, num_segments, eligible)
    return first.clamp(0, cap - 1)


def segment_arg_by(value_data: torch.Tensor, value_valid: torch.Tensor,
                   by_data: torch.Tensor, by_valid: torch.Tensor,
                   seg_ids: torch.Tensor, num_segments: int, take_max: bool,
                   by_unsigned: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per segment: the value at the row whose `by` key is smallest/largest
    (rows with null or NaN `by` don't compete; ties take the first row).
    `by_unsigned` marks a uint64 `by` plane."""
    if by_data.dtype == torch.bool:
        by_data = by_data.to(torch.int8)
    if by_unsigned:
        by_data = by_data ^ _SIGN64
    competes = by_valid
    if by_data.is_floating_point():
        competes = competes & ~torch.isnan(by_data)
    fn = "max" if take_max else "min"
    masked_by = torch.where(competes, by_data, torch.full_like(
        by_data, _reduce_neutral(by_data.dtype, fn)))
    extreme = _segment_reduce(fn, masked_by, seg_ids, num_segments,
                              competes)
    # Rows parked past the last segment never compete; clamp their gather.
    winner = competes & (masked_by == extreme[
        seg_ids.clamp(0, max(num_segments - 1, 0))])
    first_idx = _segment_first_index(winner, seg_ids, num_segments)
    any_competes = _segment_reduce("sum", competes.to(torch.int64), seg_ids,
                                   num_segments, competes) > 0
    return value_data[first_idx], value_valid[first_idx] & any_competes


def segment_distinct_count(data: torch.Tensor, valid: torch.Tensor,
                           seg_ids: torch.Tensor, num_segments: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-segment distinct count of `data` (nulls don't count), by
    one sort on (segment, validity and NaN flags, value). Floats are
    canonicalized first: -0.0 becomes +0.0, NaN becomes +inf with a side
    flag so that every NaN is one value, distinct from +inf. The counts
    are int64 (the reference's uint64)."""
    if data.dtype == torch.bool:
        data = data.to(torch.int8)
    value = torch.where(valid, data, torch.zeros_like(data))
    nan_flag = torch.zeros(value.shape[0], dtype=torch.int8,
                           device=value.device)
    if value.is_floating_point():
        is_nan = torch.isnan(value)
        nan_flag = is_nan.to(torch.int8)
        value = torch.where(is_nan, torch.full_like(value, float("inf")),
                            value + 0.0)
    flags_word = (valid.to(torch.int64) << 1) | nan_flag.to(torch.int64)
    order = stable_argsort_u32(
        [seg_ids.to(torch.int64), flags_word,
         *monotone_u32_words(value, torch.ones_like(valid))])
    seg_s = seg_ids[order]
    val_s = value[order]
    valid_s = valid[order]
    nan_s = nan_flag[order]
    new_value = (seg_s != torch.roll(seg_s, 1)) | \
        (val_s != torch.roll(val_s, 1)) | \
        (valid_s != torch.roll(valid_s, 1)) | (nan_s != torch.roll(nan_s, 1))
    new_value[0] = True
    flags = (new_value & valid_s).to(torch.int64)
    counts = _segment_reduce("sum", flags, seg_s, num_segments, valid_s)
    return counts, torch.ones(num_segments, dtype=torch.bool,
                              device=data.device)


def compact_mask(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices that move in-mask rows to the front (stable); plus count.
    The key word is one bit wide, so the sort is one radix pass."""
    order = stable_argsort_u32([(~mask).to(torch.int64)], word_bits=[1])
    return order, mask.to(torch.int64).sum()


# --- packed sort keys ---------------------------------------------------------


def monotone_u32_words(data: torch.Tensor, valid: torch.Tensor,
                       unsigned: bool = False) -> list[torch.Tensor]:
    """Order-preserving encoding as u32 words (int64 tensors holding values
    in [0, 2^32)), major first. Null rows encode as zero words.
    `unsigned` marks an int64 plane that holds uint64 bit patterns."""
    dt = data.dtype
    if dt == torch.bool:
        words = [data.to(torch.int64)]
    elif dt == torch.float32:
        bits = data.view(torch.int32).to(torch.int64) & _M32
        sign = (bits >> 31).to(torch.bool)
        words = [torch.where(sign, ~bits & _M32, bits | _SIGN32)]
    elif dt == torch.float64:
        bits = data.view(torch.int64)
        hi = (bits >> 32) & _M32
        lo = bits & _M32
        sign = (hi >> 31).to(torch.bool)
        words = [torch.where(sign, ~hi & _M32, hi | _SIGN32),
                 torch.where(sign, ~lo & _M32, lo)]
    elif dt in (torch.int32, torch.int16, torch.int8):
        words = [data.to(torch.int64) + _SIGN32]
    elif dt == torch.uint8:
        words = [data.to(torch.int64)]
    elif dt == torch.int64:
        x = data if unsigned else data ^ _SIGN64
        words = [(x >> 32) & _M32, x & _M32]
    else:
        raise TypeError(f"monotone_u32_words: unsupported dtype {dt}")
    zero = torch.zeros((), dtype=torch.int64, device=data.device)
    return [torch.where(valid, w, zero) for w in words]


def _pack_fields(fields) -> tuple[list[torch.Tensor], list[int]]:
    """Pack (plane, width) bit fields, major first, into u32 words (int64
    tensors); a field never straddles two words. Returns (words,
    significant LOW bits per word): the last word is shifted down so its
    unused bits sit high and zero, letting the radix sort skip passes."""
    words: list[torch.Tensor] = []
    bits_left = 0
    for plane, width in fields:
        if width > bits_left:
            words.append(torch.zeros_like(plane))
            bits_left = 32
        bits_left -= width
        words[-1] = words[-1] | (plane << bits_left)
    sig = [32] * len(words)
    if words and bits_left:
        words[-1] = words[-1] >> bits_left
        sig[-1] = 32 - bits_left
    return words, sig


def pack_key_planes_bits(items) -> tuple[list[torch.Tensor], list[int]]:
    """items: (data, valid, descending, value_bits[, unsigned]) MAJOR key
    first.

    value_bits <= 31 asserts the encoded value fits [0, 2^bits) and leaves
    room for its null bit in one u32 word (dictionary codes, booleans,
    small ints); anything wider goes full-width via monotone_u32_words.
    Each field carries a null bit above its value (ascending: null sorts
    first; descending: null sorts last). Returns (u32 words major-first,
    significant LOW bits per word), as `_pack_fields`."""
    fields: list[tuple[torch.Tensor, int]] = []
    for item in items:
        data, valid, descending, value_bits = item[:4]
        unsigned = bool(item[4]) if len(item) > 4 else False
        null_plane = ((~valid) if descending else valid).to(torch.int64)
        if value_bits > 31:
            value_words = monotone_u32_words(data, valid, unsigned)
            if descending:
                value_words = [torch.where(valid, ~w & _M32,
                                           torch.zeros_like(w))
                               for w in value_words]
            fields.append((null_plane, 1))
            fields.extend((w, 32) for w in value_words)
        else:
            value_mask = (1 << value_bits) - 1
            enc = data.to(torch.int64) & _M32 & value_mask
            if descending:
                enc = value_mask - enc
            enc = torch.where(valid, enc, torch.zeros_like(enc))
            fields.append(((null_plane << value_bits) | enc, value_bits + 1))
    return _pack_fields(fields)


def _lexsort_fields(plane: torch.Tensor, unsigned: bool):
    """One lexsort plane as (value, width) bit fields, major first, in
    `jnp.lexsort`'s order: floats with -0.0 equal to +0.0 and every NaN
    equal to every other, after +inf; small integers biased into their
    own width so that they pack tightly."""
    dt = plane.dtype
    if dt == torch.bool or dt == torch.uint8:
        return [(plane.to(torch.int64), 1 if dt == torch.bool else 8)]
    if dt in (torch.int8, torch.int16):
        width = 8 if dt == torch.int8 else 16
        return [(plane.to(torch.int64) + (1 << (width - 1)), width)]
    if plane.is_floating_point():
        plane = torch.where(plane == 0, torch.zeros_like(plane), plane)
        plane = torch.where(torch.isnan(plane),
                            torch.full_like(plane, float("nan")).abs(),
                            plane)
    ones = torch.ones(plane.shape[0], dtype=torch.bool, device=plane.device)
    return [(w, 32) for w in monotone_u32_words(plane, ones, unsigned)]


def lexsort_indices(key_planes) -> torch.Tensor:
    """Stable ascending argsort over multiple key planes, major key LAST,
    with `jnp.lexsort`'s order (see `_lexsort_fields`). A plane is a
    tensor, or a (tensor, unsigned) pair for an int64 plane that holds
    uint64 bit patterns. The planes pack into as few u32 words as they
    fit, and the radix engine sorts them."""
    fields = []
    for plane in reversed(list(key_planes)):
        tensor, unsigned = plane if isinstance(plane, tuple) else \
            (plane, False)
        fields.extend(_lexsort_fields(tensor, unsigned))
    words, bits = _pack_fields(fields)
    return stable_argsort_u32(words, word_bits=bits)


def stable_argsort_u32(words: list[torch.Tensor],
                       word_bits: "list[int] | None" = None) -> torch.Tensor:
    """Stable ascending argsort over u32 key words (major first); int64
    indices. Always the radix engine: on a CUDA tensor its kernels
    (`radix_upsweep`, `radix_onesweep`), on a CPU tensor their plain
    versions. A stable argsort has one answer, so this agrees with every
    engine of the reference."""
    return radix_argsort_u32(words, word_bits)


def packed_sort_indices(items) -> torch.Tensor:
    """Stable ascending argsort over packed key fields (major first)."""
    words, bits = pack_key_planes_bits(items)
    return stable_argsort_u32(words, word_bits=bits)


def hash_group_order(key_planes, mask: torch.Tensor) -> torch.Tensor:
    """Row ordering that makes equal group keys adjacent, masked rows last,
    using the exact order-preserving key encoding.

    key_planes: (data, valid[, unsigned]) per key. Word 0 packs [masked-out
    bit (most significant) | one validity bit per key]; then each key adds
    its monotone u32 words. Invalid values encode as zero, so the validity
    bit alone tells NULL from a literal zero."""
    n = mask.shape[0]
    words: list[torch.Tensor] = []
    bits: list[int] = []
    flags = (~mask).to(torch.int64)
    nflag = 1
    for key in key_planes:
        valid = key[1]
        if nflag == 32:            # >31 keys: overflow into another word
            words.append(flags)
            bits.append(nflag)
            flags = torch.zeros(n, dtype=torch.int64, device=mask.device)
            nflag = 0
        flags = (flags << 1) | valid.to(torch.int64)
        nflag += 1
    words.append(flags)
    bits.append(nflag)
    for key in key_planes:
        data, valid = key[0], key[1]
        unsigned = bool(key[2]) if len(key) > 2 else False
        vw = monotone_u32_words(data, valid, unsigned)
        words.extend(vw)
        bits.extend([32] * len(vw))
    return stable_argsort_u32(words, word_bits=bits)


# --- segmented scans (window functions) ------------------------------------
#
# All operate on SEGMENT-SORTED planes (equal partition keys adjacent);
# `starts[i]` marks row i as the first of its segment (starts[0] must be
# True for a non-empty plane).


def _combine(function: str):
    if function == "sum":
        return torch.add
    if function == "min":
        return torch.minimum
    if function == "max":
        return torch.maximum
    raise ValueError(f"Unknown scan function {function!r}")


def _log_step_scan(combine, data: torch.Tensor,
                   starts: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive scan in ceil(log2 n) steps (Hillis-Steele): at
    step d every row takes the combine of the row d before it unless a
    segment start lies between them."""
    value = data
    flag = starts
    n = data.shape[0]
    d = 1
    while d < n:
        head_v, tail_v = value[:d], value[d:]
        head_f, tail_f = flag[:d], flag[d:]
        value = torch.cat([head_v, torch.where(
            tail_f, tail_v, combine(value[:-d], tail_v))])
        flag = torch.cat([head_f, tail_f | flag[:-d]])
        d *= 2
    return value


def segment_scan(function: str, data: torch.Tensor,
                 starts: torch.Tensor) -> torch.Tensor:
    """Segmented INCLUSIVE prefix scan (sum/min/max). Integer sums are the
    whole-plane cumsum minus the cumsum before each segment's start;
    float sums, min and max take the log-step scan."""
    combine = _combine(function)
    if data.shape[0] == 0:
        return data.clone()
    if function == "sum" and not data.is_floating_point():
        total = torch.cumsum(data, 0, dtype=data.dtype)
        lo = segment_start_index(starts)
        before = total[(lo - 1).clamp(min=0)]
        return total - torch.where(lo > 0, before, torch.zeros_like(before))
    return _log_step_scan(combine, data, starts)


def _ends(starts: torch.Tensor) -> torch.Tensor:
    """The segment-end flags of a starts plane."""
    return torch.cat([starts[1:], torch.ones(1, dtype=torch.bool,
                                             device=starts.device)])


def segment_suffix_scan(function: str, data: torch.Tensor,
                        starts: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive SUFFIX scan (combine toward segment ends):
    reverse the plane, rebuild start flags from the forward ends, scan,
    reverse back."""
    if data.shape[0] == 0:
        return data.clone()
    return torch.flip(segment_scan(function, torch.flip(data, [0]),
                                   torch.flip(_ends(starts), [0])), [0])


def _segment_table_index(starts: torch.Tensor,
                         marks: torch.Tensor) -> torch.Tensor:
    """Per row: the index of the marked row of its segment (each segment
    holds one marked row). Segment numbers are the running count of
    starts; each marked row scatters its index into its segment's slot
    (the other rows into a spare slot), and every row reads its slot.
    The same as a running max over indices, and linear: torch.cummax
    takes seconds at 64M rows on the card."""
    n = starts.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=starts.device)
    seg = torch.cumsum(starts.to(torch.int64), 0)
    table = torch.zeros(n + 2, dtype=torch.int64, device=starts.device)
    table.scatter_(0, torch.where(marks, seg, torch.full_like(seg, n + 1)),
                   iota)
    return table[seg]


def segment_start_index(starts: torch.Tensor) -> torch.Tensor:
    """Per row: index of its segment's FIRST row (int64); 0 for rows before
    the first start."""
    return _segment_table_index(starts, starts)


def segment_end_index(starts: torch.Tensor) -> torch.Tensor:
    """Per row: index of its segment's LAST row (int64)."""
    if starts.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=starts.device)
    return _segment_table_index(starts, _ends(starts))


def segment_position(starts: torch.Tensor) -> torch.Tensor:
    """0-based row position within its segment (row_number() - 1)."""
    iota = torch.arange(starts.shape[0], dtype=torch.int64,
                        device=starts.device)
    return iota - segment_start_index(starts)


def segment_shift(data: torch.Tensor, valid: torch.Tensor,
                  starts: torch.Tensor, shift: int,
                  seg_lo: "torch.Tensor | None" = None,
                  seg_hi: "torch.Tensor | None" = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Within-segment shifted gather: row i reads row i-shift (shift>0 =
    lag, shift<0 = lead). Returns (data, valid, in_segment); rows whose
    source falls outside their own segment get in_segment=False."""
    n = data.shape[0]
    src = torch.arange(n, dtype=torch.int64, device=data.device) - shift
    if seg_lo is None:
        seg_lo = segment_start_index(starts)
    if seg_hi is None:
        seg_hi = segment_end_index(starts)
    in_seg = (src >= seg_lo) & (src <= seg_hi)
    src = src.clamp(0, max(n - 1, 0))
    return data[src], valid[src], in_seg


def segment_range_extreme(function: str, data: torch.Tensor,
                          valid: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor, max_width: int) -> torch.Tensor:
    """Per-row min/max over rows [lo_i, hi_i] (lo_i <= hi_i, hi_i - lo_i
    + 1 <= max_width): the sparse-table range query, the combine of the
    two power-of-two runs that cover the range. The reference stacks every
    level of the table; here each level is built from the one before and
    read as it is made, so memory stays two planes whatever the width."""
    n = data.shape[0]
    if data.dtype == torch.bool:
        data = data.to(torch.int8)
    combine = _combine(function)
    neutral = _reduce_neutral(data.dtype, function)
    level = torch.where(valid, data, torch.full_like(data, neutral))
    n_levels = max(int(max_width).bit_length() - 1, 1)   # floor(log2(w))
    length = hi - lo + 1
    p = torch.zeros(n, dtype=torch.int64, device=data.device)
    for k in range(1, n_levels + 1):
        p = p + (length >= (1 << k)).to(torch.int64)
    left_idx = lo.clamp(0, max(n - 1, 0))
    right_idx = (hi - (1 << p) + 1).clamp(0, max(n - 1, 0))
    left = level[left_idx]
    right = level[right_idx]
    for k in range(1, n_levels + 1):
        half = 1 << (k - 1)
        shifted = torch.cat([level[half:], torch.full(
            (min(half, n),), neutral, dtype=level.dtype,
            device=level.device)])
        level = combine(level, shifted)
        at_k = p == k
        left = torch.where(at_k, level[left_idx], left)
        right = torch.where(at_k, level[right_idx], right)
    return combine(left, right)
