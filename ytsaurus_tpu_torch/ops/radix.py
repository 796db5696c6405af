"""Tiled stable LSD radix argsort over u32 key words.

Port of the JAX package's `ops/radix.py::radix_argsort_u32` with its
`engine="pallas"` route: every digit pass is `ops/hist_rank.py::radix_pass`,
whose counting step is the `hist_rank` kernel on the card and its plain
version on the CPU. The `gather` and `scatter` engines are not ported.

torch has no uint32 arithmetic on the CPU, so key words are int64 tensors
holding values in [0, 2^32); the permutation is int64.
"""

from __future__ import annotations

import torch

from ytsaurus_tpu_torch.ops.hist_rank import BITS, TILE, radix_pass


def radix_argsort_u32(words: list[torch.Tensor],
                      word_bits: "list[int] | None" = None) -> torch.Tensor:
    """Stable ascending argsort over u32 key words (major word first) via
    LSD radix passes of BITS bits. `word_bits[k]` bounds the significant
    LOW bits of word k (higher bits must be zero); passes above the bound
    are skipped.

    Rows pad to a multiple of TILE with all-ones keys, which sort last;
    ties against real all-ones rows resolve to the real rows first by
    stability (pad indices come after every real index)."""
    n = words[0].shape[0]
    dev = words[0].device
    if n == 0:
        return torch.arange(0, dtype=torch.int64, device=dev)
    if word_bits is None:
        word_bits = [32] * len(words)
    padded = ((n + TILE - 1) // TILE) * TILE
    n_pad = padded - n
    perm = torch.arange(padded, dtype=torch.int64, device=dev)
    mask = (1 << BITS) - 1
    for word, bits in zip(reversed(words), reversed(word_bits)):
        if bits <= 0:
            continue
        fill = (1 << min(bits, 32)) - 1
        wpad = word.to(torch.int64)
        if n_pad:
            wpad = torch.cat([wpad, torch.full((n_pad,), fill,
                                               dtype=torch.int64, device=dev)])
        for shift in range(0, min(bits, 32), BITS):
            digit = (wpad[perm] >> shift) & mask
            perm = radix_pass(digit, perm, BITS)
    return perm[:n]
