"""Arithmetic the queries' plain references share: sums per group in a
stated precision, and the relative error a comparison reads."""

from __future__ import annotations

import math

import numpy as np


def segment_sum(index: np.ndarray, values: np.ndarray, size: int,
                dtype) -> np.ndarray:
    """Sum of `values` per `index` in [0, size), accumulated in `dtype`
    (np.bincount accumulates in float64 whatever it is given)."""
    if np.dtype(dtype) == np.float64:
        return np.bincount(index, weights=values, minlength=size)
    out = np.zeros(size, dtype=dtype)
    np.add.at(out, index, values.astype(dtype))
    return out


def rel_err(got, want) -> float:
    """|got - want| / |want| (|got| where want is 0); inf where got is not
    a finite number."""
    try:
        got = float(got)
    except (TypeError, ValueError):
        return math.inf
    if not math.isfinite(got):
        return math.inf
    want = float(want)
    return abs(got - want) / abs(want) if want else abs(got)
