"""Parity of the port's radix counting step and radix argsort with the JAX
package: `ytsaurus_tpu_torch.ops.hist_rank` (plain version, on the CPU)
against `ytsaurus_tpu.ops.pallas_radix.hist_rank` in interpret mode, and
the port's `radix_argsort_u32` against the JAX one with engine="pallas".
Results must be exactly equal. The CUDA kernel itself is checked against
the plain version in tests/test_torch_cuda.py, which skips without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ytsaurus_tpu.ops import pallas_radix
from ytsaurus_tpu.ops.radix import radix_argsort_u32 as jax_radix_argsort
from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.ops import hist_rank as port
from ytsaurus_tpu_torch.ops.radix import radix_argsort_u32

# The tier-1 suite runs several workers side by side: torch's default of
# one (spinning) thread per core would crowd out their timing tests.
torch.set_num_threads(1)


def _digits(kind: str, n: int, bits: int, seed: int) -> np.ndarray:
    if kind == "zeros":
        return np.zeros(n, dtype=np.int32)
    if kind == "max":
        return np.full(n, (1 << bits) - 1, dtype=np.int32)
    return np.random.default_rng(seed).integers(0, 1 << bits, n,
                                                dtype=np.int32)


@pytest.mark.parametrize("kind", ["random", "zeros", "max"])
@pytest.mark.parametrize("bits", [1, 6, 8])
@pytest.mark.parametrize("n", [2048, 8192, 10240])
def test_plain_hist_rank_matches_pallas_interpret(n, bits, kind):
    d = _digits(kind, n, bits, seed=n + bits)
    want_counts, want_rank = pallas_radix.hist_rank(jnp.asarray(d), bits=bits,
                                                    tile=2048)
    counts, rank = port.hist_rank(torch.from_numpy(d), bits=bits)
    assert counts.dtype == torch.int32 and rank.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want_rank))


def test_cpu_tensor_takes_the_plain_version_without_a_launch():
    port.reset_launches()
    d = torch.from_numpy(_digits("random", 4096, 6, seed=3))
    counts, rank = port.hist_rank(d)
    want_counts, want_rank = port.hist_rank_plain(d)
    assert torch.equal(counts, want_counts) and torch.equal(rank, want_rank)
    assert port.launches == 0


@pytest.mark.parametrize("bad", [
    torch.zeros(2048, dtype=torch.int64),          # not int32
    torch.zeros(3000, dtype=torch.int32),          # not a tile multiple
    torch.zeros((2, 2048), dtype=torch.int32),     # not 1-D
])
def test_hist_rank_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(YtError):
        port.hist_rank(bad)


@pytest.mark.parametrize("bits", [0, 9])
def test_hist_rank_rejects_bit_widths_outside_the_kernel(bits):
    with pytest.raises(YtError):
        port.hist_rank(torch.zeros(2048, dtype=torch.int32), bits=bits)


def test_plain_hist_rank_rejects_out_of_range_digits():
    with pytest.raises(YtError):
        port.hist_rank_plain(torch.full((2048,), 64, dtype=torch.int32),
                             bits=6)


@pytest.mark.parametrize("n", [0, 5, 2048, 10_000])
def test_radix_argsort_matches_pallas_engine(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    hi = (keys >> 32).astype(np.uint32)
    lo = keys.astype(np.uint32)
    want = np.asarray(jax_radix_argsort([jnp.asarray(hi), jnp.asarray(lo)],
                                        engine="pallas"))
    got = radix_argsort_u32([torch.from_numpy(hi.astype(np.int64)),
                             torch.from_numpy(lo.astype(np.int64))])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_radix_argsort_is_stable_with_all_ones_keys_and_word_bits():
    """Real all-ones keys tie with the padding's all-ones fill; stability
    keeps the real rows first, and word_bits skips passes above the
    bound without changing the answer."""
    rng = np.random.default_rng(7)
    w = rng.integers(0, 1 << 12, 3000).astype(np.int64)
    w[rng.integers(0, 3000, 400)] = (1 << 12) - 1
    got = radix_argsort_u32([torch.from_numpy(w)], word_bits=[12])
    np.testing.assert_array_equal(got.numpy(), np.argsort(w, kind="stable"))


def test_radix_pass_is_a_stable_partition():
    rng = np.random.default_rng(11)
    d = rng.integers(0, 64, 6144).astype(np.int64)
    payload = torch.arange(6144, dtype=torch.int64)
    out = port.radix_pass(torch.from_numpy(d), payload)
    np.testing.assert_array_equal(out.numpy(), np.argsort(d, kind="stable"))
