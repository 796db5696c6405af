"""TPC-H lineitem, Q1 and the aggregation of Q18, with numpy oracles.

Port of the JAX package's `models/tpch.py` (`LINEITEM_SCHEMA`, `Q1`,
`generate_lineitem`, `q1_reference_numpy`). The generator makes the same
`np.random.default_rng(seed)` draws in the same order, so its planes match
the reference's bit for bit.

`Q18_AGG` is TPC-H Q18's inner aggregation (orders whose lines sum to a
quantity above 300) with its LIMIT 100; the join to orders waits for the
join slice.
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

RETURNFLAGS = np.array([b"A", b"N", b"R"], dtype=object)
LINESTATUSES = np.array([b"F", b"O"], dtype=object)

# TPC-H date constant expressed as days since 1970-01-01.
_DATE_1998_09_02 = 10471

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
