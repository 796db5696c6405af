"""The radix sort's counting step: `hist_rank`, its plain version, and one
radix pass built on it.

Port of the JAX package's `ops/pallas_radix.py` (`hist_rank`,
`radix_pass_pallas`). For each tile of TILE digits, `hist_rank` gives the
2^bits-bin histogram and every element's stable rank among the equal digits
earlier in its tile: the two quantities that fix each element's place in a
stable counting sort,

    dest[i] = bin_start[d_i] + (digits d_i in earlier tiles) + rank[i].

On a CUDA tensor `hist_rank` launches the hand-written kernel
`csrc/hist_rank.cu`; on a CPU tensor it runs `hist_rank_plain`, written from
the definition above. There is no fallback from one to the other.

The port's sort does not run this kernel: `ops/radix.py` does each pass in
one launch of `radix_onesweep`, whose tiles are ranked by the same device
code (`csrc/tile_rank.cuh`). `hist_rank` keeps the Pallas kernel's interface,
so that the ranking is held against it there, and `radix_pass`, written on
`hist_rank_plain`, is the one-sweep pass's plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ytsaurus_tpu_torch.errors import EErrorCode, YtError

TILE = 2048
BITS = 6
_LOG_TILE = TILE.bit_length() - 1
MAX_BITS = 8

# Kernel launches since the last reset (a plain count, so that a run can
# show that its path went through the kernel).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _check(digits: torch.Tensor, bits: int) -> None:
    if digits.dtype != torch.int32 or digits.dim() != 1:
        raise YtError(f"hist_rank takes a 1-D int32 tensor, got "
                      f"{tuple(digits.shape)} {digits.dtype}",
                      code=EErrorCode.QueryExecutionError)
    if digits.shape[0] % TILE != 0:
        raise YtError(f"hist_rank needs a multiple of {TILE} digits, got "
                      f"{digits.shape[0]}", code=EErrorCode.QueryExecutionError)
    if not 1 <= bits <= MAX_BITS:
        raise YtError(f"hist_rank takes 1 <= bits <= {MAX_BITS}, got {bits}",
                      code=EErrorCode.QueryExecutionError)


def hist_rank(digits: torch.Tensor, bits: int = BITS
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """digits: (N,) int32 with N % TILE == 0 and values < 2^bits.
    Returns (counts (N/TILE, 2^bits) int32, rank (N,) int32)."""
    _check(digits, bits)
    if digits.device.type == "cpu":
        return hist_rank_plain(digits, bits)
    if digits.device.type != "cuda":
        raise YtError(f"hist_rank has no kernel for {digits.device}",
                      code=EErrorCode.QueryExecutionError)
    return _hist_rank_cuda(digits, bits)


def _kernel():
    from ytsaurus_tpu_torch import _build
    return _build.function(
        "hist_rank", "hist_rank_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def _hist_rank_cuda(digits: torch.Tensor, bits: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    digits = digits.contiguous()
    n = digits.shape[0]
    counts = torch.empty((n // TILE, 1 << bits), dtype=torch.int32,
                         device=digits.device)
    rank = torch.empty(n, dtype=torch.int32, device=digits.device)
    if n == 0:
        return counts, rank
    fn = _kernel()
    with torch.cuda.device(digits.device):
        stream = torch.cuda.current_stream(digits.device).cuda_stream
        err = fn(digits.data_ptr(), counts.data_ptr(), rank.data_ptr(),
                 n, bits, stream)
    if err != 0:
        raise YtError(f"hist_rank kernel launch failed (CUDA error {err})",
                      code=EErrorCode.QueryExecutionError)
    launches += 1
    return counts, rank


def hist_rank_plain(digits: torch.Tensor, bits: int = BITS
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """hist_rank from its definition, in plain torch: per tile, sort the
    unique composite keys `digit << log2(TILE) | position`; a digit's
    first place in the sorted tile (found by searchsorted) is how many
    smaller digits the tile holds, and an element's rank is its sorted
    place less that start. No (N, 2^bits) one-hot is built."""
    _check(digits, bits)
    n = digits.shape[0]
    nbins = 1 << bits
    nt = n // TILE
    dev = digits.device
    if n and (int(digits.min()) < 0 or int(digits.max()) >= nbins):
        raise YtError(f"hist_rank digits must lie in [0, 2^{bits})",
                      code=EErrorCode.QueryExecutionError)
    pos = torch.arange(TILE, dtype=torch.int64, device=dev)
    composite = (digits.view(nt, TILE).to(torch.int64) << _LOG_TILE) | pos
    composite, _ = torch.sort(composite, dim=1)
    d_sorted = composite >> _LOG_TILE
    src = composite & (TILE - 1)
    bins = torch.arange(nbins, dtype=torch.int64, device=dev)
    bins = bins.expand(nt, nbins).contiguous()
    start = torch.searchsorted(d_sorted, bins, side="left")
    end = torch.searchsorted(d_sorted, bins, side="right")
    rank_sorted = pos - torch.gather(start, 1, d_sorted)
    rank = torch.empty((nt, TILE), dtype=torch.int64, device=dev)
    rank.scatter_(1, src, rank_sorted)
    return (end - start).to(torch.int32), rank.view(n).to(torch.int32)


def radix_pass(digit: torch.Tensor, payload: torch.Tensor, bits: int = BITS
               ) -> torch.Tensor:
    """One stable partition of `payload` by `digit` (< 2^bits) in plain
    torch, on any device: the counting step (`hist_rank_plain`), the
    destination arithmetic, and a scatter (each destination is written
    once). digit and payload are (N,) with N % TILE == 0."""
    n = digit.shape[0]
    nt = n // TILE
    digit = digit.to(torch.int32)
    counts, rank = hist_rank_plain(digit, bits)
    # Tile t's run of digit b starts after every smaller digit in all tiles
    # and digit b in the tiles before t: one exclusive scan of the counts
    # in bin-major order. (torch's scan down the columns of the (tiles,
    # bins) table would parallelize over the bins only.)
    flat = counts.t().reshape(-1).to(torch.int64)
    run_start = torch.cumsum(flat, 0) - flat
    tiles = torch.arange(nt, dtype=torch.int64, device=digit.device)
    slot = digit.view(nt, TILE).to(torch.int64) * nt + tiles[:, None]
    dest = run_start[slot.view(-1)] + rank
    out = torch.empty_like(payload)
    out[dest] = payload
    return out
