"""TPC-H tables from a seed, as the benchmark's queries read them.

The rules are those of TPC-H spec v3, clause 4.2.3, for every column a
query reads, and for the columns those are derived from:

- orders: O_ORDERKEY sparse (the first 8 of every 32 keys), O_CUSTKEY
  uniform over the customers whose key is not a multiple of 3,
  O_ORDERDATE uniform in [STARTDATE, ENDDATE - 151 days],
  O_SHIPPRIORITY 0;
- lineitem: 1 to 7 lines per order, in order-key order; L_QUANTITY
  uniform in [1, 50]; L_EXTENDEDPRICE = L_QUANTITY * P_RETAILPRICE of a
  part uniform in [1, SF * 200,000]; L_DISCOUNT in [0.00, 0.10] and
  L_TAX in [0.00, 0.08], in steps of 0.01; L_SHIPDATE = O_ORDERDATE +
  [1, 121] days; L_RECEIPTDATE = L_SHIPDATE + [1, 30] days;
  L_RETURNFLAG "R" or "A" at random where L_RECEIPTDATE <= CURRENTDATE,
  else "N"; L_LINESTATUS "O" where L_SHIPDATE > CURRENTDATE, else "F";
- customer: C_CUSTKEY 1 .. SF * 150,000, C_MKTSEGMENT uniform over its
  five values.

Dates are int64 days since 1970-01-01; string columns are int32 codes
into their sorted vocabularies (`VOCABULARIES`). Lineitem is drawn chunk
by chunk, each chunk holding whole orders, from its own child of the
seed's `SeedSequence`, on threads: the same seed gives the same tables
whatever the threads' timing.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

STARTDATE = 8035        # 1992-01-01
CURRENTDATE = 9298      # 1995-06-17
ENDDATE = 10591         # 1998-12-31
Q1_BASE_DATE = 10561    # 1998-12-01

ORDERS_PER_SF = 1_500_000
CUSTOMERS_PER_SF = 150_000
PARTS_PER_SF = 200_000

VOCABULARIES = {
    "l_returnflag": np.array([b"A", b"N", b"R"], dtype=object),
    "l_linestatus": np.array([b"F", b"O"], dtype=object),
    "c_mktsegment": np.array([b"AUTOMOBILE", b"BUILDING", b"FURNITURE",
                              b"HOUSEHOLD", b"MACHINERY"], dtype=object),
}
_FLAG_A, _FLAG_N, _FLAG_R = 0, 1, 2
_STATUS_F, _STATUS_O = 0, 1

# The type of each column the queries read, as the port's schema names it.
COLUMN_TYPES = {
    "lineitem": {"l_orderkey": "int64", "l_quantity": "double",
                 "l_extendedprice": "double", "l_discount": "double",
                 "l_tax": "double", "l_returnflag": "string",
                 "l_linestatus": "string", "l_shipdate": "int64"},
    "orders": {"o_orderkey": "int64", "o_custkey": "int64",
               "o_orderdate": "int64", "o_shippriority": "int64"},
    "customer": {"c_custkey": "int64", "c_mktsegment": "string"},
}
SORT_KEYS = {"lineitem": None, "orders": ["o_orderkey"],
             "customer": ["c_custkey"]}


def table_sizes(scale_factor: float) -> dict:
    return {"orders": int(round(ORDERS_PER_SF * scale_factor)),
            "customer": int(round(CUSTOMERS_PER_SF * scale_factor)),
            "part": int(round(PARTS_PER_SF * scale_factor))}


def orderkey_of_index(index: np.ndarray) -> np.ndarray:
    """O_ORDERKEY of the i-th order: the first 8 keys of every 32."""
    return (index // 8) * 32 + (index % 8) + 1


def index_of_orderkey(key: np.ndarray) -> np.ndarray:
    return ((key - 1) // 32) * 8 + (key - 1) % 32


def retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    """P_RETAILPRICE in cents (clause 4.2.3)."""
    return 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000)


def _orders(rng: np.random.Generator, n_orders: int, n_customers: int
            ) -> dict:
    eligible = n_customers - n_customers // 3
    draw = rng.integers(0, max(eligible, 1), n_orders)
    return {
        "o_orderkey": orderkey_of_index(np.arange(n_orders, dtype=np.int64)),
        "o_custkey": (draw // 2) * 3 + draw % 2 + 1,
        "o_orderdate": rng.integers(STARTDATE, ENDDATE - 151 + 1, n_orders),
        "o_shippriority": np.zeros(n_orders, dtype=np.int64),
    }


def _lineitem_part(child: np.random.SeedSequence, first: int,
                   orderdate: np.ndarray, n_parts: int) -> dict:
    """Lines of orders [first, first + len(orderdate)): counts, then every
    column, all from one child generator. `l_order_index` (the line's
    order's position) is kept for the reference."""
    rng = np.random.default_rng(child)
    n_orders = len(orderdate)
    counts = rng.integers(1, 8, n_orders, dtype=np.int8)
    order_index = np.repeat(np.arange(first, first + n_orders,
                                      dtype=np.int64), counts)
    n = len(order_index)
    quantity = rng.integers(1, 51, n, dtype=np.int8)
    partkey = rng.integers(1, n_parts + 1, n, dtype=np.int64)
    discount = rng.integers(0, 11, n, dtype=np.int8)
    tax = rng.integers(0, 9, n, dtype=np.int8)
    shipdate = np.repeat(orderdate, counts) + \
        rng.integers(1, 122, n, dtype=np.int16)
    receiptdate = shipdate + rng.integers(1, 31, n, dtype=np.int16)
    returned = rng.integers(0, 2, n, dtype=np.int8)
    returnflag = np.where(receiptdate <= CURRENTDATE,
                          np.where(returned == 1, _FLAG_R, _FLAG_A),
                          _FLAG_N).astype(np.int32)
    return {
        "l_orderkey": orderkey_of_index(order_index),
        "l_quantity": quantity.astype(np.float64),
        "l_extendedprice": quantity * retail_price_cents(partkey) / 100.0,
        "l_discount": discount / 100.0,
        "l_tax": tax / 100.0,
        "l_returnflag": returnflag,
        "l_linestatus": np.where(shipdate > CURRENTDATE, _STATUS_O,
                                 _STATUS_F).astype(np.int32),
        "l_shipdate": shipdate.astype(np.int64),
        "l_order_index": order_index,
    }


def generate(config: dict, seq: np.random.SeedSequence,
             threads: int = 8) -> dict:
    """{table: [chunk arrays, ...]} for lineitem, orders and customer, at
    the configuration's `scale_factor`. Orders and customer come as one
    chunk each; lineitem as `tables.lineitem.chunks` chunks of whole
    orders, in order-key order."""
    sizes = table_sizes(config["scale_factor"])
    lineitem_chunks = config["tables"]["lineitem"]["chunks"]
    orders_seq, customer_seq, lineitem_seq = seq.spawn(3)
    orders = _orders(np.random.default_rng(orders_seq), sizes["orders"],
                     sizes["customer"])
    customer_rng = np.random.default_rng(customer_seq)
    customer = {
        "c_custkey": np.arange(1, sizes["customer"] + 1, dtype=np.int64),
        "c_mktsegment": customer_rng.integers(
            0, len(VOCABULARIES["c_mktsegment"]), sizes["customer"]
        ).astype(np.int32),
    }
    bounds = np.linspace(0, sizes["orders"], lineitem_chunks + 1
                         ).astype(np.int64)
    children = lineitem_seq.spawn(lineitem_chunks)
    with ThreadPoolExecutor(max_workers=max(1, min(threads,
                                                   lineitem_chunks))) as pool:
        parts = list(pool.map(
            lambda j: _lineitem_part(children[j], int(bounds[j]),
                                     orders["o_orderdate"][
                                         bounds[j]:bounds[j + 1]],
                                     sizes["part"]),
            range(lineitem_chunks)))
    return {"lineitem": parts, "orders": [orders], "customer": [customer]}

