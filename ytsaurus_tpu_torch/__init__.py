"""ytsaurus_tpu_torch — the QL query engine on PyTorch and CUDA.

Port of the JAX package beside it to PyTorch on an NVIDIA H100.
It mirrors the JAX package's layout and module names; each module's
docstring names the file it ports. It imports torch and numpy only:
nothing of JAX and nothing of the JAX package, whose `__init__` would load
jax and switch the whole process to 64-bit mode.

Slice 1 runs one QL query over one columnar chunk on one device:
  - query front end (lexer, parser, builder → typed IR), copied;
  - chunks/columnar.py — torch planes on an explicit device;
  - ops/hist_rank.py + csrc/hist_rank.cu — the radix counting kernel;
  - ops/radix.py, ops/segments.py — the sort and segment primitives;
  - query/engine — expression binding, plan lowering, the evaluator;
  - models/tpch.py — lineitem, Q1 and the Q18 aggregation.

Every entry point takes `device=`, which defaults to "cuda" and raises
when no card is present (see device.py).
"""

__version__ = "0.1.0"

from ytsaurus_tpu_torch.errors import YtError, YtResponseError  # noqa: F401
from ytsaurus_tpu_torch.schema import (  # noqa: F401
    ColumnSchema,
    EValueType,
    SortOrder,
    TableSchema,
)
