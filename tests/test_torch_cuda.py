"""Tests of the port that need a CUDA card; without one they skip.

This file imports neither jax nor the JAX package, so that it also runs on
a machine without them: `python -m pytest --noconftest tests/test_torch_cuda.py`.
Each CUDA kernel is held against its plain PyTorch version, exactly.
"""

import numpy as np
import pytest
import torch

from ytsaurus_tpu_torch.ops import hist_rank as hr
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
