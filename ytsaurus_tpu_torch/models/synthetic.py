"""The string and vector workloads of the repo's benchmark, with numpy
oracles.

STRINGS is `bench.py --config strings`'s table: rows (k, s, v) with k the
row number, s drawn uniformly from `n_rows // 10` distinct strings
`b"u%08d"`, and v uniform in [0, 1000). `STRINGS_GROUP` is that benchmark's
query; `STRINGS_FUNCS` puts LIKE, a regex and the dictionary functions
(upper, concat, length) on it.

VECTOR is `bench.py --config vector`'s corpus: `np.random.default_rng(3)`
draws the dim-64 plane, then each sweep point's queries, then the dim-256
plane and its queries, all standard normal float32, in that order
(`vector_sweep`). `VECTOR_QUERIES` run NEAREST and its ORDER BY spelling
over a (k, g, emb) table of such a plane, g = k % 5.

The generators draw with numpy only, so the same seed gives the same
tables wherever they run.
"""

from __future__ import annotations

import numpy as np
import torch

from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE
from ytsaurus_tpu_torch.schema import TableSchema

STRINGS_SCHEMA = TableSchema.make([("k", "int64", "ascending"),
                                   ("s", "string"), ("v", "int64")])
STRINGS_GROUP = "s, sum(v) AS t FROM [//t] GROUP BY s"
STRINGS_FUNCS = (
    "upper(s) AS u, length(concat(s, 'x')) AS n, sum(v) AS t FROM [//t] "
    "WHERE s LIKE 'u0000%7' OR regex_partial_match('99$', s) "
    "GROUP BY upper(s), length(concat(s, 'x'))"
)

VECTOR_SEED = 3
VECTOR_DIMS = (64, 256)
VECTOR_KS = (8, 64)
VECTOR_BATCHES = (1, 16, 64)
VECTOR_GROUPS = 5
VECTOR_QUERIES = {
    "nearest_l2": "k, g, emb FROM [//v] NEAREST(emb, ?, 8)",
    "nearest_cosine_where":
        "k FROM [//v] WHERE g = 2 NEAREST(emb, ?, 8, 'cosine')",
    "order_by_dot": "k FROM [//v] ORDER BY dot_product(emb, ?) DESC LIMIT 8",
}


def strings_vocab(n_distinct: int) -> np.ndarray:
    vocab = np.empty(n_distinct, dtype=object)
    vocab[:] = [b"u%08d" % c for c in range(n_distinct)]
    return vocab


def strings_arrays(n_rows: int, seed: int = 0) -> dict[str, np.ndarray]:
    """STRINGS's columns: s as codes into `strings_vocab(n_rows // 10)`."""
    rng = np.random.default_rng(seed)
    n_distinct = max(n_rows // 10, 1)
    return {"k": np.arange(n_rows, dtype=np.int64),
            "s": rng.integers(0, n_distinct, n_rows),
            "v": rng.integers(0, 1000, n_rows)}


def strings_chunk(arrays: dict[str, np.ndarray],
                  device: "str | torch.device" = DEFAULT_DEVICE
                  ) -> ColumnarChunk:
    vocab = strings_vocab(max(len(arrays["k"]) // 10, 1))
    return ColumnarChunk.from_arrays(STRINGS_SCHEMA, arrays,
                                     dictionaries={"s": vocab}, device=device)


def strings_group_oracle(arrays: dict[str, np.ndarray]) -> dict:
    """STRINGS_GROUP's rows as {s: t}."""
    n_distinct = max(len(arrays["k"]) // 10, 1)
    sums = np.bincount(arrays["s"], weights=arrays["v"], minlength=n_distinct)
    counts = np.bincount(arrays["s"], minlength=n_distinct)
    return {b"u%08d" % c: int(sums[c]) for c in np.flatnonzero(counts)}


def strings_funcs_oracle(arrays: dict[str, np.ndarray]) -> dict:
    """STRINGS_FUNCS's rows as {u: (n, t)}, by integer arithmetic on the
    codes: `u0000%7` is a code below 10^4 ending in 7, `99$` one ending in
    99; upper(s) is b"U%08d", and every concat(s, 'x') is 10 bytes."""
    codes = arrays["s"]
    hit = ((codes < 10_000) & (codes % 10 == 7)) | (codes % 100 == 99)
    sums = np.bincount(codes[hit], weights=arrays["v"][hit])
    counts = np.bincount(codes[hit])
    return {b"U%08d" % c: (10, int(sums[c])) for c in np.flatnonzero(counts)}


def vector_sweep(n_rows: int, seed: int = VECTOR_SEED):
    """Yields (dim, plane, {(k, batch): queries}) for dim 64 then 256,
    drawn in the benchmark's order."""
    rng = np.random.default_rng(seed)
    for dim in VECTOR_DIMS:
        plane = rng.standard_normal((n_rows, dim), dtype=np.float32)
        queries = {}
        for k in VECTOR_KS:
            for batch in VECTOR_BATCHES:
                queries[(k, batch)] = rng.standard_normal(
                    (batch, dim), dtype=np.float32)
        yield dim, plane, queries


def vector_table(plane: np.ndarray,
                 device: "str | torch.device" = DEFAULT_DEVICE
                 ) -> ColumnarChunk:
    """The (k, g, emb) table of the QL queries over `plane`."""
    n, dim = plane.shape
    schema = TableSchema.make([("k", "int64", "ascending"), ("g", "int64"),
                               ("emb", f"vector<float,{dim}>")])
    k = np.arange(n, dtype=np.int64)
    return ColumnarChunk.from_arrays(
        schema, {"k": k, "g": k % VECTOR_GROUPS, "emb": plane},
        device=device)


def vector_measures(plane: np.ndarray, queries: np.ndarray, metric: str,
                    rows: "np.ndarray | None" = None,
                    block: int = 1 << 17) -> np.ndarray:
    """Every row's measure against each query in float64, one pass over
    the rows in blocks, the blocks on threads (numpy releases the GIL in
    the conversion, the product and the epilogue): the l2 or cosine
    distance, or the dot product. `queries` is (B, dim); `rows` limits
    the rows (all when None). Returns (B, rows)."""
    from concurrent.futures import ThreadPoolExecutor
    q = np.atleast_2d(queries).astype(np.float64)
    q_norm2 = (q * q).sum(axis=1)
    n = plane.shape[0] if rows is None else len(rows)
    out = np.empty((len(q), n), dtype=np.float64)

    def fill(lo: int) -> None:
        hi = min(lo + block, n)
        x = (plane[lo:hi] if rows is None else plane[rows[lo:hi]]
             ).astype(np.float64)
        dot = q @ x.T
        x_norm2 = (x * x).sum(axis=1)[None, :]
        if metric == "dot":
            out[:, lo:hi] = dot
        elif metric == "cosine":
            denom = np.sqrt(x_norm2) * np.sqrt(q_norm2)[:, None]
            safe = np.where(denom > 0, denom, 1.0)
            out[:, lo:hi] = np.where(denom > 0, 1.0 - dot / safe, 1.0)
        else:
            out[:, lo:hi] = np.sqrt(np.maximum(
                q_norm2[:, None] - 2.0 * dot + x_norm2, 0.0))

    starts = range(0, n, block)
    with ThreadPoolExecutor(max(1, min(8, len(starts)))) as pool:
        list(pool.map(fill, starts))
    return out


def check_hits(hits: list, measures: np.ndarray, rows: np.ndarray,
               metric: str, k: int, slack: float = 1e-5,
               rtol: float = 1e-4) -> None:
    """Holds one query's (row, measure) hits to tests/test_vector.py's
    recall rule against the float64 `measures` of `rows` (ascending row
    indices): exactly
    min(k, len(rows)) distinct rows, each at or better than the k-th best
    measure (with a relative `slack` for the float32 product), and each
    returned measure within `rtol` of the oracle's. Raises AssertionError."""
    take = min(k, len(rows))
    if take == 0:
        if hits:
            raise AssertionError(f"{len(hits)} hits where none match")
        return
    if metric == "dot":
        at = len(measures) - take
        cut = np.partition(measures, at)[at]
    else:
        cut = np.partition(measures, take - 1)[take - 1]
    got = [r for r, _ in hits]
    if len(got) != take or len(set(got)) != take:
        raise AssertionError(f"{len(got)} hits ({len(set(got))} distinct), "
                             f"want {take}")
    tol = slack * abs(cut)
    for row, measure in hits:
        i = int(np.searchsorted(rows, row))
        if i >= len(rows) or rows[i] != row:
            raise AssertionError(f"row {row} is not a matching row")
        want = measures[i]
        if (metric == "dot" and want < cut - tol) or \
                (metric != "dot" and want > cut + tol):
            raise AssertionError(f"row {row} measure {want!r} is past the "
                                 f"k-th {cut!r}")
        if abs(measure - want) > rtol * abs(want) + 1e-6:
            raise AssertionError(f"row {row} measure {measure!r} != "
                                 f"{want!r} (rtol {rtol})")
