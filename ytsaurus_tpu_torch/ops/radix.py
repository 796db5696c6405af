"""Stable LSD radix argsort over u32 key words, in one-sweep passes.

Port of the JAX package's `ops/radix.py::radix_argsort_u32` on its
`engine="pallas"` route (`ops/pallas_radix.py::radix_pass_pallas` and its
counting kernel), redesigned for Hopper. Per key word, least significant
word first:

1. `radix_upsweep` reads the word once, through the permutation so far, and
   writes its int32 key plane and the histogram of each of its 8-bit
   digits;
2. the histograms come to the host (one sync per word), and a pass whose
   digit is the same in every row is skipped: a stable pass over a
   constant digit is the identity;
3. `radix_onesweep` runs each remaining pass, moving the keys and the int32
   row indices together.

On a CUDA tensor each wrapper launches its hand-written kernel
(`csrc/radix_upsweep.cu`, `csrc/radix_onesweep.cu`) and raises if the launch
fails; on a CPU tensor it runs its plain version. There is no fallback from
one to the other. A stable argsort has exactly one answer, so the kernels,
the plain versions and every engine of the reference agree bit for bit.

torch has no uint32 arithmetic on the CPU, so key words are int64 tensors
holding values in [0, 2^32), key planes are int32 bit patterns, and the
permutation is int32 inside the sort and int64 when it is returned.
"""

from __future__ import annotations

import ctypes

import torch

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.ops.hist_rank import TILE, radix_pass

DIGIT_BITS = 8
BINS = 1 << DIGIT_BITS
MAX_POSITIONS = 32 // DIGIT_BITS
# The look-back packs a 30-bit count beside its 2-bit flag.
MAX_N = (1 << 30) - 1
THREADS = 256
# Digits each thread of radix_onesweep ranks (a tile is THREADS * ITEMS);
# the kernel is built for each of LAYOUTS.
LAYOUTS = (8, 12, 16, 20)
ITEMS = 20

_M32 = 0xFFFFFFFF

# Kernel launches since the last reset, per kernel (plain counts, so that a
# run can show that its path went through the kernels).
launches = {"radix_upsweep": 0, "radix_onesweep": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _fail(msg: str) -> YtError:
    """A fault of the radix kernels or their wrappers; the `kernel`
    attribute keeps the degradation ladder from hiding it."""
    return YtError(msg, code=EErrorCode.QueryExecutionError,
                   attributes={"kernel": "radix"})


def _int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 bit patterns."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_device(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise _fail(f"the radix kernels have no version for {dev}")
    for t in tensors[1:]:
        if t.device != dev:
            raise _fail(f"radix tensors on {dev} and {t.device}")


# --- radix_upsweep ------------------------------------------------------------


def _check_upsweep(word, perm, positions) -> None:
    if word.dtype != torch.int64 or word.dim() != 1:
        raise _fail(f"radix_upsweep takes a 1-D int64 word, got "
                    f"{tuple(word.shape)} {word.dtype}")
    if perm is not None and (perm.dtype != torch.int32
                             or perm.shape != word.shape):
        raise _fail(f"radix_upsweep takes an int32 permutation of the "
                    f"word's length, got {tuple(perm.shape)} {perm.dtype}")
    if not 1 <= positions <= MAX_POSITIONS:
        raise _fail(f"radix_upsweep counts 1 to {MAX_POSITIONS} digit "
                    f"positions, got {positions}")
    _check_device(word, *([] if perm is None else [perm]))


def radix_upsweep(word: torch.Tensor, perm: "torch.Tensor | None",
                  positions: int) -> tuple[torch.Tensor, torch.Tensor]:
    """word: (n,) int64 with values in [0, 2^32); perm: (n,) int32 row
    indices, or None for the identity. Returns (key (n,) int32, the bit
    patterns of word[perm]; hist (positions, 256) int32, hist[p, b] = how
    many keys have digit p, (key >> 8p) & 0xFF, equal to b)."""
    _check_upsweep(word, perm, positions)
    if word.device.type == "cpu":
        return radix_upsweep_plain(word, perm, positions)
    return _upsweep_cuda(word, perm, positions)


def radix_upsweep_plain(word: torch.Tensor, perm: "torch.Tensor | None",
                        positions: int) -> tuple[torch.Tensor, torch.Tensor]:
    """radix_upsweep in plain torch: a gather and a bincount per digit
    position."""
    _check_upsweep(word, perm, positions)
    w = word if perm is None else word[perm.to(torch.int64)]
    w = w & _M32
    hist = torch.stack([
        torch.bincount((w >> (DIGIT_BITS * p)) & (BINS - 1), minlength=BINS)
        for p in range(positions)])
    return _int32_bits(w), hist.to(torch.int32)


def _upsweep_cuda(word, perm, positions):
    from ytsaurus_tpu_torch import _build
    fn = _build.function(
        "radix_upsweep", "radix_upsweep_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    word = word.contiguous()
    perm = None if perm is None else perm.contiguous()
    n = word.shape[0]
    key = torch.empty(n, dtype=torch.int32, device=word.device)
    hist = torch.zeros((positions, BINS), dtype=torch.int32,
                       device=word.device)
    with torch.cuda.device(word.device):
        err = fn(word.data_ptr(), None if perm is None else perm.data_ptr(),
                 key.data_ptr(), hist.data_ptr(), n, positions,
                 _stream(word))
    if err != 0:
        raise _fail(f"radix_upsweep kernel launch failed (CUDA error {err})")
    launches["radix_upsweep"] += 1
    return key, hist


# --- radix_onesweep -----------------------------------------------------------


def _check_onesweep(key, val, shift, items) -> None:
    if key.dtype != torch.int32 or key.dim() != 1 or \
            val.dtype != torch.int32 or val.shape != key.shape:
        raise _fail(f"radix_onesweep takes 1-D int32 keys and values of one "
                    f"length, got {tuple(key.shape)} {key.dtype} and "
                    f"{tuple(val.shape)} {val.dtype}")
    if key.shape[0] > MAX_N:
        raise _fail(f"radix_onesweep takes at most {MAX_N} rows, got "
                    f"{key.shape[0]}")
    if shift not in range(0, 32, DIGIT_BITS):
        raise _fail(f"radix_onesweep shifts by a multiple of {DIGIT_BITS} "
                    f"below 32, got {shift}")
    if items not in LAYOUTS:
        raise _fail(f"radix_onesweep is built for items in {LAYOUTS}, got "
                    f"{items}")
    _check_device(key, val)


def radix_onesweep(key: torch.Tensor, val: torch.Tensor, shift: int,
                   bin_start: torch.Tensor, items: int = ITEMS
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One stable pass by the digit (key >> shift) & 0xFF (key read as
    u32). key, val: (n,) int32; bin_start: (256,) int32, the exclusive
    start of each digit's run (from radix_upsweep's histogram of this
    digit). Returns (key, val) reordered. `items` picks the kernel's tile
    (THREADS * items rows); the result does not depend on it."""
    _check_onesweep(key, val, shift, items)
    if key.device.type == "cpu":
        return radix_onesweep_plain(key, val, shift)
    if bin_start.dtype != torch.int32 or bin_start.shape != (BINS,):
        raise _fail(f"radix_onesweep takes (256,) int32 bin starts, got "
                    f"{tuple(bin_start.shape)} {bin_start.dtype}")
    _check_device(key, bin_start)
    return _onesweep_cuda(key, val, shift, bin_start, items)


def radix_onesweep_plain(key: torch.Tensor, val: torch.Tensor, shift: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """radix_onesweep in plain torch: `ops/hist_rank.py::radix_pass` over
    `hist_rank_plain` at 8 bits, with the rows padded to its tile by digit
    255 (the pads sort after every real row and are cut off). The key and
    the value travel as one int64 payload, key in the high half."""
    _check_onesweep(key, val, shift, ITEMS)
    n = key.shape[0]
    if n == 0:
        return key.clone(), val.clone()
    k64 = key.to(torch.int64)
    digit = ((k64 & _M32) >> shift) & (BINS - 1)
    payload = (k64 << 32) | val.to(torch.int64)
    pad = -n % TILE
    if pad:
        digit = torch.cat([digit, digit.new_full((pad,), BINS - 1)])
        payload = torch.cat([payload, payload.new_zeros(pad)])
    out = radix_pass(digit, payload, DIGIT_BITS)
    out = out[:n]
    return (out >> 32).to(torch.int32), (out & _M32).to(torch.int32)


def _onesweep_cuda(key, val, shift, bin_start, items):
    from ytsaurus_tpu_torch import _build
    fn = _build.function(
        "radix_onesweep", "radix_onesweep_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p])
    key = key.contiguous()
    val = val.contiguous()
    bin_start = bin_start.contiguous()
    n = key.shape[0]
    key_out = torch.empty_like(key)
    val_out = torch.empty_like(val)
    if n == 0:
        return key_out, val_out
    tiles = -(-n // (THREADS * items))
    # The look-back's status words and, last, the tile counter: zero.
    status = torch.zeros(tiles * BINS + 1, dtype=torch.int32,
                         device=key.device)
    with torch.cuda.device(key.device):
        err = fn(key.data_ptr(), val.data_ptr(), key_out.data_ptr(),
                 val_out.data_ptr(), bin_start.data_ptr(), status.data_ptr(),
                 n, shift, items, _stream(key))
    if err != 0:
        raise _fail(f"radix_onesweep kernel launch failed (CUDA error {err})")
    launches["radix_onesweep"] += 1
    return key_out, val_out


# --- the argsort --------------------------------------------------------------


def radix_argsort_u32(words: list[torch.Tensor],
                      word_bits: "list[int] | None" = None) -> torch.Tensor:
    """Stable ascending argsort over u32 key words (major word first), by
    8-bit LSD passes; int64 indices. `word_bits[k]` bounds the significant
    LOW bits of word k (higher bits must be zero): digit positions above
    the bound are not counted or sorted. A position whose digit is the same
    in every row is skipped as well."""
    n = words[0].shape[0]
    dev = words[0].device
    if n > MAX_N:
        raise _fail(f"radix_argsort_u32 sorts at most {MAX_N} rows (an int32 "
                    f"permutation and 30-bit look-back counts), got {n}")
    if word_bits is None:
        word_bits = [32] * len(words)
    perm = None
    for word, bits in zip(reversed(words), reversed(word_bits)):
        bits = min(bits, 32)
        if n == 0 or bits <= 0:
            continue
        positions = -(-bits // DIGIT_BITS)
        key, hist = radix_upsweep(word, perm, positions)
        bin_start = torch.cumsum(hist, 1, dtype=torch.int32) - hist
        constant = (hist.cpu() == n).any(dim=1).tolist()   # the one sync
        if all(constant):
            continue
        val = perm if perm is not None else \
            torch.arange(n, dtype=torch.int32, device=dev)
        for p in range(positions):
            if not constant[p]:
                key, val = radix_onesweep(key, val, DIGIT_BITS * p,
                                          bin_start[p])
        perm = val
    if perm is None:
        return torch.arange(n, dtype=torch.int64, device=dev)
    return perm.to(torch.int64)
