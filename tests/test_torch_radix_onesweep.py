"""Parity of the port's one-sweep radix route with the JAX package:
`ytsaurus_tpu_torch.ops.radix` (`radix_upsweep_plain`,
`radix_onesweep_plain`, the `radix_argsort_u32` sort, on the CPU) and
`ops/segments.py::stable_argsort_u32` against the JAX package's
`radix_argsort_u32` with engine="pallas" (its Pallas counting kernel in
interpret mode) and engine="gather", and against
`np.argsort(kind="stable")`. A stable argsort has exactly one answer, so
every result must be equal. The CUDA kernels themselves are held against
these plain versions in tests/test_torch_cuda.py, which skips without a
card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ytsaurus_tpu.ops.radix import radix_argsort_u32 as jax_radix_argsort
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.ops import radix as rx
from ytsaurus_tpu_torch.ops.segments import stable_argsort_u32

# The tier-1 suite runs several workers side by side: torch's default of
# one (spinning) thread per core would crowd out their timing tests.
torch.set_num_threads(1)

M32 = 0xFFFFFFFF


def _references(words: list, word_bits=None) -> list:
    """The three reference orders of u32 words (numpy, major first)."""
    jw = [jnp.asarray(w.astype(np.uint32)) for w in words]
    refs = [np.asarray(jax_radix_argsort(jw, word_bits, engine=engine)
                       ).astype(np.int64)
            for engine in ("pallas", "gather")]
    if words[0].shape[0] == 0:
        return refs + [np.zeros(0, dtype=np.int64)]
    return refs + [np.lexsort(words[::-1])]


def _port_orders(words: list, word_bits=None) -> list:
    tw = [torch.from_numpy(w.astype(np.int64)) for w in words]
    orders = [rx.radix_argsort_u32(tw, word_bits),
              stable_argsort_u32(tw, word_bits)]
    for order in orders:
        assert order.dtype == torch.int64
    return [o.numpy() for o in orders]


def _assert_all_equal(words: list, word_bits=None) -> None:
    refs = _references(words, word_bits)
    for got in _port_orders(words, word_bits):
        for want in refs:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 2048, 10_000])
def test_two_word_argsort_matches_every_reference(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    keys[: n // 3] &= np.uint64(0xFFFF)                      # ties
    _assert_all_equal([(keys >> np.uint64(32)).astype(np.int64),
                       (keys & np.uint64(M32)).astype(np.int64)])


def test_keys_with_the_int32_sign_bit_set():
    """Key planes are int32 bit patterns: words at and above 2^31 must sort
    above the smaller ones, not below them."""
    rng = np.random.default_rng(5)
    w = rng.integers(0, 1 << 32, 5000).astype(np.int64)
    w[::3] |= 1 << 31
    w[::7] = 1 << 31
    w[::11] = (1 << 31) - 1
    _assert_all_equal([w])


@pytest.mark.parametrize("value,word_bits", [
    (0, None), (M32, None), (0x5A5A5A5A, None),
    (0, [12]), ((1 << 12) - 1, [12]), ((1 << 20) - 1, [20])])
def test_all_equal_words_give_the_identity(value, word_bits):
    w = np.full(3000, value, dtype=np.int64)
    _assert_all_equal([w], word_bits)
    np.testing.assert_array_equal(_port_orders([w], word_bits)[0],
                                  np.arange(3000))


@pytest.mark.parametrize("word_bits", [None, [5, 32, 17]])
def test_three_word_keys(word_bits):
    rng = np.random.default_rng(9)
    bits = word_bits or [32, 32, 32]
    words = [rng.integers(0, 1 << b, 4000).astype(np.int64) for b in bits]
    words[0][:2000] = 3 & ((1 << bits[0]) - 1)             # ties on word 0
    _assert_all_equal(words, word_bits)


def _count_passes(monkeypatch) -> list:
    shifts = []
    onesweep = rx.radix_onesweep

    def counted(key, val, shift, bin_start, items=rx.ITEMS):
        shifts.append(shift)
        return onesweep(key, val, shift, bin_start, items)

    monkeypatch.setattr(rx, "radix_onesweep", counted)
    return shifts


def test_constant_digit_passes_are_skipped(monkeypatch):
    """Keys below 2^8 in the low word and a high word below 2^8: of the
    eight digit positions only the two low ones vary, so two passes run."""
    shifts = _count_passes(monkeypatch)
    rng = np.random.default_rng(2)
    hi = rng.integers(0, 256, 6000).astype(np.int64)
    lo = rng.integers(0, 256, 6000).astype(np.int64)
    _assert_all_equal([hi, lo])
    assert shifts == [0, 0] * 2          # two port orders, two passes each


def test_a_digit_that_varies_in_one_row_is_not_skipped(monkeypatch):
    """Every digit but the top one is constant, and the top one differs in
    one row only: that pass must run and move that row."""
    shifts = _count_passes(monkeypatch)
    w = np.full(5000, 0x00ABCDEF, dtype=np.int64)
    w[17] = 0x01ABCDEF
    w[4000] = 0x00ABCDEF - 0x10000      # digit 2 differs too
    _assert_all_equal([w])
    assert shifts == [16, 24] * 2


def test_plain_upsweep_is_a_gather_and_a_histogram():
    rng = np.random.default_rng(4)
    word = rng.integers(0, 1 << 32, 7000).astype(np.int64)
    perm = rng.permutation(7000).astype(np.int32)
    for p in (None, perm):
        key, hist = rx.radix_upsweep(
            torch.from_numpy(word), None if p is None else torch.from_numpy(p),
            4)
        want = word if p is None else word[p]
        assert key.dtype == torch.int32 and hist.dtype == torch.int32
        np.testing.assert_array_equal(key.numpy(),
                                      want.astype(np.uint32).view(np.int32))
        for pos in range(4):
            np.testing.assert_array_equal(
                hist[pos].numpy(),
                np.bincount((want >> (8 * pos)) & 255, minlength=256))
        # The key plane, read as u32, sorts as the word it came from.
        _assert_all_equal([key.numpy().astype(np.int64) & M32])


@pytest.mark.parametrize("n", [1, 2048, 10_000])
@pytest.mark.parametrize("shift", [0, 8, 24])
def test_plain_onesweep_is_one_stable_pass(n, shift):
    """One pass by digit (key >> shift) & 255 is the argsort of that digit
    alone: the JAX engines sort it with word_bits=[8]."""
    rng = np.random.default_rng(n + shift)
    word = rng.integers(0, 1 << 32, n).astype(np.int64)
    word[: n // 2] |= 0xFF << shift                         # many 255s
    key = torch.from_numpy(word.astype(np.uint32).view(np.int32))
    val = torch.from_numpy(rng.permutation(n).astype(np.int32))
    key_out, val_out = rx.radix_onesweep(key, val, shift,
                                         torch.zeros(256, dtype=torch.int32))
    digit = (word >> shift) & 255
    for order in _references([digit], [8]):
        np.testing.assert_array_equal(val_out.numpy(), val.numpy()[order])
        np.testing.assert_array_equal(key_out.numpy(), key.numpy()[order])


def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    rx.reset_launches()
    w = torch.from_numpy(np.random.default_rng(1).integers(0, 1 << 32, 3000))
    order = rx.radix_argsort_u32([w])
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(w.numpy(), kind="stable"))
    assert rx.launches == {"radix_upsweep": 0, "radix_onesweep": 0}


def test_more_rows_than_the_lookback_counts_hold_raise():
    """n must fit the int32 permutation and the 30-bit look-back counts.
    The words are expanded views: nothing of that size is allocated."""
    big = torch.zeros(1, dtype=torch.int64).expand(rx.MAX_N + 1)
    with pytest.raises(YtError):
        rx.radix_argsort_u32([big])
    with pytest.raises(YtError):
        stable_argsort_u32([big])
    key = torch.zeros(1, dtype=torch.int32).expand(rx.MAX_N + 1)
    with pytest.raises(YtError):
        rx.radix_onesweep(key, key, 0, torch.zeros(256, dtype=torch.int32))


@pytest.mark.parametrize("call", [
    lambda: rx.radix_upsweep(torch.zeros(8, dtype=torch.int32), None, 4),
    lambda: rx.radix_upsweep(torch.zeros(8, dtype=torch.int64), None, 5),
    lambda: rx.radix_upsweep(torch.zeros(8, dtype=torch.int64),
                             torch.zeros(7, dtype=torch.int32), 4),
    lambda: rx.radix_onesweep(torch.zeros(8, dtype=torch.int32),
                              torch.zeros(8, dtype=torch.int64), 0,
                              torch.zeros(256, dtype=torch.int32)),
    lambda: rx.radix_onesweep(torch.zeros(8, dtype=torch.int32),
                              torch.zeros(8, dtype=torch.int32), 4,
                              torch.zeros(256, dtype=torch.int32)),
    lambda: rx.radix_onesweep(torch.zeros(8, dtype=torch.int32),
                              torch.zeros(8, dtype=torch.int32), 0,
                              torch.zeros(256, dtype=torch.int32), items=10),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(YtError):
        call()
