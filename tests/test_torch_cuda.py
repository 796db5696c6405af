"""Tests of the port that need a CUDA card; without one they skip.

This file imports neither jax nor the JAX package, so that it also runs on
a machine without them: `python -m pytest --noconftest tests/test_torch_cuda.py`.
Each CUDA kernel is held against its plain PyTorch version, exactly.
"""

import numpy as np
import pytest
import torch

from ytsaurus_tpu_torch.ops import hist_rank as hr
from ytsaurus_tpu_torch.ops import radix as rx
from ytsaurus_tpu_torch.ops.radix import radix_argsort_u32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", ["equal", "max", "random"])
@pytest.mark.parametrize("bits", [1, 6, 8])
def test_hist_rank_kernel_matches_plain_version(cuda_device, bits, kind):
    n = 1 << 16
    if kind == "equal":
        d = np.zeros(n, dtype=np.int32)
    elif kind == "max":
        d = np.full(n, (1 << bits) - 1, dtype=np.int32)
    else:
        d = np.random.default_rng(bits).integers(0, 1 << bits, n,
                                                 dtype=np.int32)
    d = torch.from_numpy(d).to(cuda_device)
    before = hr.launches
    counts, rank = hr.hist_rank(d, bits=bits)
    want_counts, want_rank = hr.hist_rank_plain(d, bits=bits)
    torch.cuda.synchronize()
    assert hr.launches == before + 1
    assert torch.equal(counts, want_counts) and torch.equal(rank, want_rank)


def test_radix_argsort_on_the_card_matches_the_cpu(cuda_device):
    keys = np.random.default_rng(3).integers(0, 1 << 32, 100_000)
    keys[:20_000] &= 0xF                                 # ties
    got = radix_argsort_u32([torch.from_numpy(keys).to(cuda_device)])
    want = radix_argsort_u32([torch.from_numpy(keys)])
    assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(want.numpy(), np.argsort(keys,
                                                           kind="stable"))


def test_cuda_tensor_always_launches_the_kernel(
        cuda_device):
    """A CUDA tensor never takes the plain version: the launch count rises."""
    before = hr.launches
    hr.hist_rank(torch.zeros(2048, dtype=torch.int32, device=cuda_device))
    assert hr.launches == before + 1


def _words(kind: str, n: int) -> np.ndarray:
    if kind == "equal":
        return np.full(n, 0x5A5A5A5A, dtype=np.int64)
    if kind == "max":
        return np.full(n, 0xFFFFFFFF, dtype=np.int64)
    return np.random.default_rng(n).integers(0, 1 << 32, n)


@pytest.mark.parametrize("kind", ["equal", "max", "random"])
@pytest.mark.parametrize("n", [2048, 10_000, 1 << 20])
def test_radix_upsweep_kernel_matches_plain_version(cuda_device, n, kind):
    word = torch.from_numpy(_words(kind, n)).to(cuda_device)
    perm = torch.randperm(n).to(torch.int32).to(cuda_device)
    for p in (None, perm):
        before = rx.launches["radix_upsweep"]
        key, hist = rx.radix_upsweep(word, p, 4)
        want_key, want_hist = rx.radix_upsweep_plain(word, p, 4)
        torch.cuda.synchronize()
        assert rx.launches["radix_upsweep"] == before + 1
        assert torch.equal(key, want_key) and torch.equal(hist, want_hist)


@pytest.mark.parametrize("items", rx.LAYOUTS)
@pytest.mark.parametrize("kind", ["equal", "max", "random"])
@pytest.mark.parametrize("n", [2048, 10_000, 1 << 20])
def test_radix_onesweep_kernel_matches_plain_version(cuda_device, n, kind,
                                                     items):
    word = torch.from_numpy(_words(kind, n)).to(cuda_device)
    key, hist = rx.radix_upsweep(word, None, 4)
    bin_start = torch.cumsum(hist, 1, dtype=torch.int32) - hist
    val = torch.randperm(n).to(torch.int32).to(cuda_device)
    for pos in range(4):
        before = rx.launches["radix_onesweep"]
        got = rx.radix_onesweep(key, val, 8 * pos, bin_start[pos], items)
        want = rx.radix_onesweep_plain(key, val, 8 * pos)
        torch.cuda.synchronize()
        assert rx.launches["radix_onesweep"] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_radix_argsort_skips_constant_digits_on_the_card(cuda_device):
    """Two words of an int64 key below 2^40: the high word's digits 1-3
    are zero everywhere, so 5 of the 8 passes run."""
    keys = np.random.default_rng(8).integers(0, 1 << 40, 300_000)
    words = [torch.from_numpy(w).to(cuda_device)
             for w in (keys >> 32, keys & 0xFFFFFFFF)]
    rx.reset_launches()
    got = radix_argsort_u32(words)
    torch.cuda.synchronize()
    assert rx.launches == {"radix_upsweep": 2, "radix_onesweep": 5}
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.argsort(keys, kind="stable"))
