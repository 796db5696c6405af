"""Range partitioning against key pivots: the single-device half of the
distributed sort.

Port of the JAX package's `parallel/shuffle.py` as far as one device uses
it: `_encode_key_plane`, `_lex_less_const`, `_partition_ids` and
`quantile_pivots`, which the external sort (`ops/bigsort.py`) routes rows
with. `sort_table`, `route_rows` and `transfer_counts` exchange rows
between devices (all_to_all); they wait for the port's mesh slice.

uint64 key planes are int64 bit patterns in the port. `_encode_key_plane`
takes an `unsigned` flag and flips their sign bit, so that the signed
compares of `_lex_less_const` order them as the reference's uint64
compares do; `pivot_value_plane` encodes the pivots' values alike. Doubles
compare by value on both sides (NaN equal to nothing, -0.0 == +0.0), as
in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

_SIGN64 = -(1 << 63)          # the int64 with only the sign bit set


def _encode_key_plane(data: torch.Tensor, valid: torch.Tensor,
                      unsigned: bool = False):
    """(null_rank, value) encoding: null sorts before any value. Invalid
    values are zeroed; `unsigned` marks an int64 plane of uint64 bit
    patterns, whose sign bit is flipped after the zeroing."""
    if data.dtype == torch.bool:
        data = data.to(torch.int8)
    value = torch.where(valid, data, torch.zeros_like(data))
    if unsigned:
        value = value ^ _SIGN64
    return valid.to(torch.int8), value


def pivot_value_plane(values: np.ndarray, device: torch.device
                      ) -> torch.Tensor:
    """The pivots' values of one key column (a numpy array in the key
    plane's host dtype, np.uint64 for uint64) as a device plane that
    compares against `_encode_key_plane`'s value plane."""
    if values.dtype == np.uint64:
        return torch.from_numpy(values.view(np.int64) ^ np.int64(_SIGN64)
                                ).to(device)
    if values.dtype == np.bool_:
        values = values.astype(np.int8)
    return torch.from_numpy(np.ascontiguousarray(values)).to(device)


def _lex_less_const(row_planes, pivot_planes, pivot_idx, or_equal: bool):
    """Lexicographic row < pivots[pivot_idx] over encoded planes.

    row_planes: [(v, d)] each (cap,); pivot_planes: [(v, d)] each (n_piv,).
    """
    shape = row_planes[0][0].shape
    device = row_planes[0][0].device
    result = torch.full(shape, or_equal, dtype=torch.bool, device=device)
    for (rv, rd), (pv, pd) in reversed(list(zip(row_planes, pivot_planes))):
        p_v, p_d = pv[pivot_idx], pd[pivot_idx]
        lt = (rv < p_v) | ((rv == p_v) & (rd < p_d))
        eq = (rv == p_v) & (rd == p_d)
        result = lt | (eq & result)
    return result


def _partition_ids(row_planes, pivot_planes, n_pivots: int) -> torch.Tensor:
    """For each row, the number of pivots ≤ row (lexicographic) — i.e. its
    destination range in [0, n_pivots]. One pass over the rows per pivot
    (a Python loop, as in the reference)."""
    cap = row_planes[0][0].shape[0]
    pid = torch.zeros(cap, dtype=torch.int32, device=row_planes[0][0].device)
    for i in range(n_pivots):
        # row >= pivots[i]  ⇔  not (row < pivots[i])
        ge = ~_lex_less_const(row_planes, pivot_planes, i, or_equal=False)
        pid = pid + ge.to(torch.int32)
    return pid


def quantile_pivots(sample_rows: "list[tuple]", n: int,
                    key_arity: int) -> "list[tuple]":
    """n-1 quantile pivots from sampled (valid, value) key tuples; the
    shared samples→bounds step of every range-partition path (ref
    partitioning_parameters_evaluator.cpp). uint64 values are Python ints
    in [0, 2^64), as the reference's samples hold them, so that `sorted`
    orders them unsigned."""
    sample_rows = sorted(sample_rows)
    pivots = []
    for j in range(1, n):
        pivots.append(sample_rows[(j * len(sample_rows)) // n]
                      if sample_rows
                      else tuple((False, 0) for _ in range(key_arity)))
    return pivots
