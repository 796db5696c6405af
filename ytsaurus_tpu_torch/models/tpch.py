"""TPC-H lineitem and orders, Q1, Q3 and the aggregation of Q18, and the
window workload, with numpy oracles.

Port of the JAX package's `models/tpch.py` (`LINEITEM_SCHEMA`,
`ORDERS_SCHEMA`, `Q1`, `Q3`, `generate_lineitem`, `q1_reference_numpy`;
`orders_arrays` draws as `generate_orders` does). The generators make the same
`np.random.default_rng(seed)` draws in the same order, so their planes
match the reference's bit for bit.

`Q18_AGG` is TPC-H Q18's inner aggregation (orders whose lines sum to a
quantity above 300) with its LIMIT 100. `WINDOW` is the window query of
the repo's window benchmark (a running sum and a rank over 1000
partitions), over `window_arrays`. `FUNCS` runs the scalar functions over
lineitem: a calendar floor, a hash with an unsigned modulo, the numeric
functions and a LIKE on every row, grouped by month and hash bucket.
"""

from __future__ import annotations

import numpy as np
import torch

from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE
from ytsaurus_tpu_torch.schema import TableSchema

LINEITEM_SCHEMA = TableSchema.make([
    ("l_orderkey", "int64"),
    ("l_quantity", "double"),
    ("l_extendedprice", "double"),
    ("l_discount", "double"),
    ("l_tax", "double"),
    ("l_returnflag", "string"),
    ("l_linestatus", "string"),
    ("l_shipdate", "int64"),          # days since epoch
])

ORDERS_SCHEMA = TableSchema.make([
    ("o_orderkey", "int64", "ascending"),
    ("o_custkey", "int64"),
    ("o_orderdate", "int64"),
    ("o_shippriority", "int64"),
])

WINDOW_SCHEMA = TableSchema.make([
    ("k", "int64", "ascending"),
    ("g", "int64"),
    ("v", "int64"),
])

RETURNFLAGS = np.array([b"A", b"N", b"R"], dtype=object)
LINESTATUSES = np.array([b"F", b"O"], dtype=object)

# TPC-H date constants expressed as days since 1970-01-01.
_DATE_1998_09_02 = 10471
_DATE_1995_03_15 = 9204

Q1 = (
    "l_returnflag, l_linestatus, "
    "sum(l_quantity) AS sum_qty, "
    "sum(l_extendedprice) AS sum_base_price, "
    "sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price, "
    "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge, "
    "avg(l_quantity) AS avg_qty, "
    "avg(l_extendedprice) AS avg_price, "
    "avg(l_discount) AS avg_disc, "
    "count(*) AS count_order "
    f"FROM [//tpch/lineitem] WHERE l_shipdate <= {_DATE_1998_09_02} "
    "GROUP BY l_returnflag, l_linestatus"
)

Q3 = (
    "l_orderkey, "
    "sum(l_extendedprice * (1 - l_discount)) AS revenue "
    "FROM [//tpch/lineitem] "
    "JOIN [//tpch/orders] ON l_orderkey = o_orderkey "
    f"WHERE o_orderdate < {_DATE_1995_03_15} "
    "GROUP BY l_orderkey "
    "ORDER BY sum(l_extendedprice * (1 - l_discount)) DESC, l_orderkey "
    "LIMIT 10"
)
Q3_LIMIT = 10

WINDOW = ("k, sum(v) OVER (PARTITION BY g ORDER BY k) AS s, "
          "rank() OVER (PARTITION BY g ORDER BY k) AS r FROM [//t]")
WINDOW_PARTITIONS = 1000

_Q1_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
               "l_returnflag", "l_linestatus", "l_shipdate")

Q18_THRESHOLD = 300
Q18_LIMIT = 100


def q18_agg_query(threshold: int = Q18_THRESHOLD) -> str:
    """Q18's inner aggregation with its HAVING threshold as a parameter."""
    return ("l_orderkey, sum(l_quantity) AS sum_qty, count(*) AS n_lines "
            "FROM [//tpch/lineitem] GROUP BY l_orderkey "
            f"HAVING sum(l_quantity) > {threshold} "
            "ORDER BY sum(l_quantity) DESC, l_orderkey "
            f"LIMIT {Q18_LIMIT}")


Q18_AGG = q18_agg_query()

FUNCS = (
    "timestamp_floor_month(l_shipdate * 86400) AS month, "
    "farm_hash(l_orderkey) % uint64(16) AS bucket, "
    "sum(floor(l_extendedprice * (1 - l_discount))) AS rev, "
    "max(max_of(l_quantity, l_tax * 100)) AS mq, "
    "sum(if_null(abs(l_discount - 0.05), 0.0)) AS dd, count(*) AS c "
    "FROM [//tpch/lineitem] "
    "WHERE is_finite(l_extendedprice) AND NOT (l_returnflag LIKE 'R') "
    "AND l_linestatus IN ('F', 'O') "
    "GROUP BY timestamp_floor_month(l_shipdate * 86400), "
    "farm_hash(l_orderkey) % uint64(16)"
)
FUNCS_BUCKETS = 16


def lineitem_arrays(n_rows: int, seed: int = 0,
                    n_orders: int | None = None) -> dict[str, np.ndarray]:
    """The lineitem columns as numpy arrays (dictionary codes for the two
    flag columns), drawn exactly as the reference's generate_lineitem."""
    rng = np.random.default_rng(seed)
    n_orders = n_orders or max(n_rows // 4, 1)
    return {
        "l_orderkey": rng.integers(0, n_orders, n_rows),
        "l_quantity": rng.integers(1, 51, n_rows).astype(np.float64),
        "l_extendedprice": rng.uniform(900.0, 105000.0, n_rows),
        "l_discount": rng.uniform(0.0, 0.10, n_rows),
        "l_tax": rng.uniform(0.0, 0.08, n_rows),
        "l_returnflag": rng.integers(0, 3, n_rows),
        "l_linestatus": rng.integers(0, 2, n_rows),
        "l_shipdate": rng.integers(8000, 10600, n_rows),
    }


def lineitem_chunk(arrays: dict[str, np.ndarray],
                   device: "str | torch.device" = DEFAULT_DEVICE
                   ) -> ColumnarChunk:
    return ColumnarChunk.from_arrays(
        LINEITEM_SCHEMA, arrays,
        dictionaries={"l_returnflag": RETURNFLAGS,
                      "l_linestatus": LINESTATUSES},
        device=device)


def generate_lineitem(n_rows: int, seed: int = 0,
                      n_orders: int | None = None,
                      device: "str | torch.device" = DEFAULT_DEVICE
                      ) -> ColumnarChunk:
    return lineitem_chunk(lineitem_arrays(n_rows, seed, n_orders), device)


def orders_arrays(n_orders: int, seed: int = 1) -> dict[str, np.ndarray]:
    """The orders columns as numpy arrays, drawn exactly as the
    reference's generate_orders."""
    rng = np.random.default_rng(seed)
    return {
        "o_orderkey": np.arange(n_orders),
        "o_custkey": rng.integers(0, max(n_orders // 10, 1), n_orders),
        "o_orderdate": rng.integers(8000, 10600, n_orders),
        "o_shippriority": rng.integers(0, 2, n_orders),
    }


def orders_chunk(arrays: dict[str, np.ndarray],
                 device: "str | torch.device" = DEFAULT_DEVICE
                 ) -> ColumnarChunk:
    return ColumnarChunk.from_arrays(ORDERS_SCHEMA, arrays, device=device)


def window_arrays(n_rows: int, seed: int = 0) -> dict[str, np.ndarray]:
    """The window workload: k the row number, g the partition (uniform in
    [0, 1000)), v the value (uniform in [0, 1000)), all int64."""
    rng = np.random.default_rng(seed)
    return {
        "k": np.arange(n_rows, dtype=np.int64),
        "g": rng.integers(0, WINDOW_PARTITIONS, n_rows, dtype=np.int64),
        "v": rng.integers(0, 1000, n_rows, dtype=np.int64),
    }


def window_chunk(arrays: dict[str, np.ndarray],
                 device: "str | torch.device" = DEFAULT_DEVICE
                 ) -> ColumnarChunk:
    return ColumnarChunk.from_arrays(WINDOW_SCHEMA, arrays, device=device)


def q1_reference_numpy(chunk: ColumnarChunk) -> dict:
    """The reference's Q1 oracle, {(flag code, status code): (sum_qty,
    count)} over all six code pairs, computed by `q1_oracle` from the
    planes read back from `chunk`."""
    n = chunk.row_count
    arrays = {name: chunk.column(name).data[:n].cpu().numpy()
              for name in _Q1_COLUMNS}
    groups = q1_oracle(arrays)
    out = {}
    for f in range(3):
        for s in range(2):
            g = groups.get((RETURNFLAGS[f], LINESTATUSES[s]))
            out[(f, s)] = (g["sum_qty"], g["count_order"]) if g else (0.0, 0)
    return out


def q1_oracle(arrays: dict[str, np.ndarray]) -> dict:
    """Every Q1 output column per (returnflag, linestatus) group, from the
    generator's arrays: {(flag bytes, status bytes): {column: value}}."""
    mask = arrays["l_shipdate"] <= _DATE_1998_09_02
    qty = arrays["l_quantity"]
    price = arrays["l_extendedprice"]
    disc = arrays["l_discount"]
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + arrays["l_tax"])
    out = {}
    for f in range(3):
        for s in range(2):
            sel = mask & (arrays["l_returnflag"] == f) & \
                (arrays["l_linestatus"] == s)
            n = int(sel.sum())
            if n == 0:
                continue
            sums = {name: float(np.where(sel, x, 0.0).sum())
                    for name, x in (("sum_qty", qty),
                                    ("sum_base_price", price),
                                    ("sum_disc_price", disc_price),
                                    ("sum_charge", charge),
                                    ("sum_disc", disc))}
            out[(RETURNFLAGS[f], LINESTATUSES[s])] = {
                "sum_qty": sums["sum_qty"],
                "sum_base_price": sums["sum_base_price"],
                "sum_disc_price": sums["sum_disc_price"],
                "sum_charge": sums["sum_charge"],
                "avg_qty": sums["sum_qty"] / n,
                "avg_price": sums["sum_base_price"] / n,
                "avg_disc": sums["sum_disc"] / n,
                "count_order": n,
            }
    return out


def q18_agg_oracle(arrays: dict[str, np.ndarray],
                   threshold: int = Q18_THRESHOLD) -> list[dict]:
    """Q18_AGG's rows in order, from the generator's arrays. Quantities are
    whole numbers, so the sums are exact."""
    keys = arrays["l_orderkey"]
    size = int(keys.max()) + 1 if len(keys) else 0
    sums = np.bincount(keys, weights=arrays["l_quantity"], minlength=size)
    counts = np.bincount(keys, minlength=size)
    hit = np.nonzero((counts > 0) & (sums > threshold))[0]
    order = np.lexsort((hit, -sums[hit]))[:Q18_LIMIT]
    return [{"l_orderkey": int(hit[i]), "sum_qty": float(sums[hit[i]]),
             "n_lines": int(counts[hit[i]])} for i in order]


def q3_oracle(lineitem: dict[str, np.ndarray],
              orders: dict[str, np.ndarray],
              limit: int = Q3_LIMIT) -> list[dict]:
    """Q3's rows in order, from the generators' arrays: lines join their
    order through o_orderkey == arange, orders dated before 1995-03-15
    keep their lines, revenue sums per order, and the top `limit` (the
    query's 10 by default) come by (revenue descending, orderkey)."""
    keys = lineitem["l_orderkey"]
    assert np.array_equal(orders["o_orderkey"],
                          np.arange(len(orders["o_orderkey"])))
    keep = orders["o_orderdate"][keys] < _DATE_1995_03_15
    revenue = lineitem["l_extendedprice"] * (1 - lineitem["l_discount"])
    size = len(orders["o_orderkey"])
    sums = np.bincount(keys[keep], weights=revenue[keep], minlength=size)
    counts = np.bincount(keys[keep], minlength=size)
    hit = np.nonzero(counts > 0)[0]
    order = np.lexsort((hit, -sums[hit]))[:limit]
    return [{"l_orderkey": int(hit[i]), "revenue": float(sums[hit[i]])}
            for i in order]


def farm_hash_int64_np(values: np.ndarray) -> np.ndarray:
    """farm_hash of one int64 argument in numpy uint64 arithmetic: the
    seed combined with the value's 64-bit finalizer."""
    seed = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        x = values.astype(np.int64).view(np.uint64)
        x = x ^ (x >> np.uint64(33))
        x = x * np.uint64(0xFF51AFD7ED558CCD)
        x = x ^ (x >> np.uint64(33))
        return (seed ^ x) * seed + (seed << np.uint64(6))


def _stable_argsort_small(key: np.ndarray) -> np.ndarray:
    """np.argsort(key, kind="stable"), the same order: keys in [0, 2^16)
    sort as uint16, which numpy's stable sort does by radix (several
    times faster on 64M rows than the int64 merge sort)."""
    if len(key) and 0 <= int(key.min()) and int(key.max()) < 1 << 16:
        return np.argsort(key.astype(np.uint16), kind="stable")
    return np.argsort(key, kind="stable")


def funcs_oracle(arrays: dict[str, np.ndarray]) -> dict:
    """FUNCS's groups from the generator's arrays, computed with numpy's
    calendar and uint64 arithmetic: {(month, bucket): {column: value}}.
    `rev` sums whole numbers below 2^53, so it is exact in any order."""
    flag_r = int(np.flatnonzero(RETURNFLAGS == b"R")[0])
    keep = arrays["l_returnflag"] != flag_r
    days = arrays["l_shipdate"][keep].astype("datetime64[D]")
    month_index = days.astype("datetime64[M]").astype(np.int64)
    bucket = (farm_hash_int64_np(arrays["l_orderkey"][keep])
              % np.uint64(FUNCS_BUCKETS)).astype(np.int64)
    lo = int(month_index.min()) if len(month_index) else 0
    key = ((month_index - lo) * FUNCS_BUCKETS + bucket).astype(np.int64)
    size = int(key.max()) + 1 if len(key) else 0
    price = arrays["l_extendedprice"][keep]
    disc = arrays["l_discount"][keep]
    rev = np.floor(price * (1 - disc))
    mq = np.maximum(arrays["l_quantity"][keep], arrays["l_tax"][keep] * 100)
    dd = np.abs(disc - 0.05)
    counts = np.bincount(key, minlength=size)
    rev_sum = np.bincount(key, weights=rev, minlength=size)
    dd_sum = np.bincount(key, weights=dd, minlength=size)
    order = _stable_argsort_small(key)
    present = np.flatnonzero(counts)
    starts = np.concatenate([[0], np.cumsum(counts[present])[:-1]])
    mq_max = np.maximum.reduceat(mq[order], starts) if len(order) else []
    out = {}
    for g, top in zip(present, mq_max):
        month = np.datetime64(int(g // FUNCS_BUCKETS + lo), "M")
        seconds = int(month.astype("datetime64[D]").astype(np.int64)) * 86400
        out[(seconds, int(g % FUNCS_BUCKETS))] = {
            "rev": float(rev_sum[g]), "mq": float(top),
            "dd": float(dd_sum[g]), "c": int(counts[g])}
    return out


def window_oracle(arrays: dict[str, np.ndarray]
                  ) -> tuple[np.ndarray, np.ndarray]:
    """WINDOW's (s, r) planes in the input row order: a stable sort by g
    (k is the row number, so it keeps k's order inside each partition),
    the running sum of v within each partition, and rank = position in
    the partition + 1 (k is unique, so no two rows tie)."""
    g = arrays["g"]
    order = _stable_argsort_small(g)
    g_sorted = g[order]
    total = np.cumsum(arrays["v"][order])
    starts = np.flatnonzero(np.r_[True, g_sorted[1:] != g_sorted[:-1]])
    lengths = np.diff(np.r_[starts, len(g)])
    first = np.repeat(starts, lengths)
    before = np.where(first > 0, total[np.maximum(first - 1, 0)], 0)
    s = np.empty_like(total)
    r = np.empty_like(total)
    s[order] = total - before
    r[order] = np.arange(len(g)) - first + 1
    return s, r
