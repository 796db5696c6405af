import pytest

# A run at a size a CPU test holds: the published widths and rules, about
# 12,000 lineitem rows in two chunks.
TINY = {"scale_factor": 0.002,
        "tables": {"lineitem": {"chunks": 2}, "orders": {"chunks": 1},
                   "customer": {"chunks": 1}}}


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided here, when a
    test runs, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
