"""Segmented reductions and sort-key helpers used by GROUP BY / ORDER BY.

Port of the JAX package's `ops/segments.py`: `sort_key_planes`,
`segment_boundaries`, the reduce dispatch, `segment_aggregate`,
`segment_arg_by`, `segment_distinct_count`, `compact_mask`,
`monotone_u32_words`, `pack_key_planes_bits`, `stable_argsort_u32`,
`packed_sort_indices` and `hash_group_order`. The window scans wait for the
window slice.

Differences from the reference, all of them forced by torch:
  * u32 key words are int64 tensors holding values in [0, 2^32), since
    torch has no uint32 arithmetic on the CPU; argsorts return int64.
  * uint64 columns are int64 bit patterns, so the functions whose result
    depends on unsigned order take an explicit `unsigned` flag (the
    reference reads it off the dtype).
  * Reductions over more than 16 segments use torch's scatter ops
    (`index_add_`, `scatter_reduce_`), the JAX package's CPU engine. On
    CUDA these add floats with atomics in no fixed order, so double sums
    agree with the reference to a relative tolerance, not bit for bit.
  * Every stable argsort is the radix engine (`ops/radix.py`): the
    `radix_upsweep` and `radix_onesweep` kernels on the card.
  * Segment ids past the last segment are dropped explicitly: torch
    raises on an out-of-range index where JAX drops or clamps.
"""

from __future__ import annotations

import torch

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
    outs = [reduce(torch.where(seg_ids == s, data, fill)).to(data.dtype)
            for s in range(num_segments)]
    if not outs:
        return torch.zeros(0, dtype=data.dtype, device=data.device)
    return torch.stack(outs)


def _scatter_segment_reduce(function: str, data: torch.Tensor,
                            seg_ids: torch.Tensor, num_segments: int):
    """One scatter pass into num_segments + 1 slots; the last slot takes
    the out-of-range ids (masked rows) and is dropped."""
    idx = seg_ids.to(torch.int64).clamp(0, num_segments)
    if function == "sum":
        out = torch.zeros(num_segments + 1, dtype=data.dtype,
                          device=data.device)
        out.index_add_(0, idx, data)
        return out[:num_segments]
    if function not in ("min", "max"):
        raise ValueError(function)
    out = torch.full((num_segments + 1,),
                     _reduce_neutral(data.dtype, function), dtype=data.dtype,
                     device=data.device)
    out.scatter_reduce_(0, idx, data, "amin" if function == "min" else "amax",
                        include_self=True)
    return out[:num_segments]


def _segment_reduce(function: str, data: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int):
    if num_segments <= _DENSE_SEGMENT_LIMIT:
        return _dense_segment_reduce(function, data, seg_ids, num_segments)
    return _scatter_segment_reduce(function, data, seg_ids, num_segments)


def segment_aggregate(function: str, data: torch.Tensor, valid: torch.Tensor,
                      seg_ids: torch.Tensor, num_segments: int,
                      value_type: EValueType
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Aggregate `data` per segment, skipping nulls. Returns (out, out_valid)
    planes of length num_segments."""
    count = _segment_reduce("sum", valid.to(torch.int64), seg_ids,
                            num_segments)
    any_valid = count > 0
    if function == "count":
        return count, torch.ones_like(any_valid)
    if function == "sum":
        masked = torch.where(valid, data, 0)
        return _segment_reduce("sum", masked, seg_ids, num_segments), \
            any_valid
    if function in ("min", "max"):
        if data.dtype == torch.bool:
            data = data.to(torch.int8)
        unsigned = value_type is EValueType.uint64
        if unsigned:
            data = data ^ _SIGN64          # unsigned order as signed order
        masked = torch.where(valid, data,
                             _reduce_neutral(data.dtype, function))
        out = _segment_reduce(function, masked, seg_ids, num_segments)
        if unsigned:
            out = out ^ _SIGN64
        if value_type is EValueType.boolean:
            out = out.to(torch.bool)
        return out, any_valid
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
    first = _segment_reduce("min", idx, seg_ids, num_segments)
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
    extreme = _segment_reduce(fn, masked_by, seg_ids, num_segments)
    # Rows parked past the last segment never compete; clamp their gather.
    winner = competes & (masked_by == extreme[
        seg_ids.clamp(0, max(num_segments - 1, 0))])
    first_idx = _segment_first_index(winner, seg_ids, num_segments)
    any_competes = _segment_reduce("sum", competes.to(torch.int64), seg_ids,
                                   num_segments) > 0
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
    counts = _segment_reduce("sum", flags, seg_s, num_segments)
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


def pack_key_planes_bits(items) -> tuple[list[torch.Tensor], list[int]]:
    """items: (data, valid, descending, value_bits[, unsigned]) MAJOR key
    first.

    value_bits <= 31 asserts the encoded value fits [0, 2^bits) and leaves
    room for its null bit in one u32 word (dictionary codes, booleans,
    small ints); anything wider goes full-width via monotone_u32_words.
    Each field carries a null bit above its value (ascending: null sorts
    first; descending: null sorts last). Returns (u32 words major-first,
    significant LOW bits per word): the last word is shifted down so its
    unused bits sit high and zero, letting the radix sort skip passes."""
    words: list[torch.Tensor] = []
    bits_left = 0

    def push(plane: torch.Tensor, width: int) -> None:
        nonlocal bits_left
        if width > bits_left:
            words.append(torch.zeros_like(plane))
            bits_left = 32
        bits_left -= width
        words[-1] = words[-1] | (plane << bits_left)

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
            push(null_plane, 1)
            for w in value_words:
                push(w, 32)
        else:
            value_mask = (1 << value_bits) - 1
            enc = data.to(torch.int64) & _M32 & value_mask
            if descending:
                enc = value_mask - enc
            enc = torch.where(valid, enc, torch.zeros_like(enc))
            push((null_plane << value_bits) | enc, value_bits + 1)
    sig = [32] * len(words)
    if words and bits_left:
        words[-1] = words[-1] >> bits_left
        sig[-1] = 32 - bits_left
    return words, sig


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
