"""Exhaustive batched nearest-neighbour search over a vector column.

Port of the JAX package's `query/vector.py` (`METRICS`, `_kernel`,
`batched_nearest`). The query language's `NEAREST(col, ?, k)` needs none of
this: it is `ORDER BY <distance>(col, ?) LIMIT k` through the ordinary
select path (the distance functions of query/engine/expr.py). This module is
the batched form: many query vectors against one chunk in one
`(batch, dim) @ (dim, capacity)` product, then a top-k per query.

The product runs in full float32, as the reference computes it on the CPU:
the module never changes `torch.backends.cuda.matmul.allow_tf32` or the
float32 matmul precision, and the caller's settings (torch's defaults keep
TF32 off) decide. Ties at the k-th score go to the lowest row index, the
order `lax.top_k` gives (`topk_lowest_index`).

Not ported here: `NearestBatcher` and `_NearestBatch`, which coalesce
requests of the serving gateway and wait for the control plane, and
`nearest_trace_count`, which counts JAX traces (the port traces nothing).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ytsaurus_tpu_torch.chunks.columnar import next_pow2
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_for
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.query.engine.lowering import topk_lowest_index
from ytsaurus_tpu_torch.schema import VectorType

#: Scores are "bigger is better" for every metric, so one top-k serves all
#: three; l2 and cosine negate back to distances on the way out.
METRICS = ("l2", "cosine", "dot")


def nearest_scores(plane: torch.Tensor, valid: torch.Tensor,
                   queries: torch.Tensor, metric: str) -> torch.Tensor:
    """(cap, dim) plane × (B, dim) queries → (B, cap) scores, invalid rows
    at -inf. Every metric derives from the one `queries @ plane.T`
    product (L2 by the norm trick)."""
    q = queries.to(torch.float32)
    x = plane.to(torch.float32)
    dot = q @ x.T
    if metric == "dot":
        score = dot
    elif metric == "cosine":
        nq = torch.sqrt((q * q).sum(dim=1))[:, None]
        nx = torch.sqrt((x * x).sum(dim=1))[None, :]
        denom = nq * nx
        score = -torch.where(denom > 0.0, 1.0 - dot / denom,
                             torch.ones_like(dot))
    else:
        nq2 = (q * q).sum(dim=1)[:, None]
        nx2 = (x * x).sum(dim=1)[None, :]
        score = -torch.sqrt(torch.clamp(nq2 - 2.0 * dot + nx2, min=0.0))
    return torch.where(valid[None, :], score,
                       torch.full_like(score, float("-inf")))


def top_rows(score: torch.Tensor, k: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, cap) scores → the k best per row, best first, ties toward the
    lowest row index: (values, row indices), each (B, k)."""
    idx = topk_lowest_index(score, k)
    vals = score.gather(1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


def batched_nearest(chunk, column: str, queries: Sequence[Sequence[float]],
                    k: int, metric: str = "l2",
                    device: "str | torch.device" = DEFAULT_DEVICE) -> list:
    """Exhaustive nearest neighbours of each query vector in one chunk.

    Returns, per query, up to `k` (row_index, measure) pairs in rank
    order: the measure is the distance (l2, cosine; ascending) or the
    similarity (dot; descending). The batch pads to a power of two with
    zero vectors and k to a power of two, as the reference pads them;
    rows past the matches (score -inf) are dropped."""
    if metric not in METRICS:
        raise YtError(f"Unknown NEAREST metric {metric!r}",
                      code=EErrorCode.QueryTypeError)
    dev = resolve_for(chunk, device, "batched_nearest")
    col = chunk.columns.get(column)
    if col is None or not isinstance(col.type, VectorType):
        raise YtError(f"Column {column!r} is not a vector column",
                      code=EErrorCode.QueryTypeError)
    dim = col.type.dim
    b = len(queries)
    if b == 0:
        return []
    q_np = np.zeros((next_pow2(b, floor=1), dim), dtype=np.float32)
    for i, q in enumerate(queries):
        arr = np.asarray(q, dtype=np.float32)
        if arr.shape != (dim,):
            raise YtError(
                f"Query vector {i} has shape {arr.shape}, expected ({dim},)",
                code=EErrorCode.QueryTypeError)
        if not np.isfinite(arr).all():
            raise YtError(f"Non-finite component in query vector {i}",
                          code=EErrorCode.QueryTypeError)
        q_np[i] = arr
    valid = col.valid & (torch.arange(col.capacity, device=dev)
                         < chunk.row_count)
    k_static = min(next_pow2(max(k, 1), floor=1), col.capacity)
    score = nearest_scores(col.data, valid, torch.from_numpy(q_np).to(dev),
                           metric)
    vals, idx = top_rows(score, k_static)
    vals_np = vals.cpu().numpy()
    idx_np = idx.cpu().numpy()
    sign = 1.0 if metric == "dot" else -1.0
    out = []
    for i in range(b):
        hits = []
        for j in range(min(k, k_static)):
            if not np.isfinite(vals_np[i, j]):
                break                      # fewer than k valid rows
            hits.append((int(idx_np[i, j]), sign * float(vals_np[i, j])))
        out.append(hits)
    return out
