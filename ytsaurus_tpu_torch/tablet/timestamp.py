"""Hybrid logical clock timestamps: the bounds the MVCC reads use.

Port of the constants of the JAX package's `tablet/timestamp.py`. Cluster
timestamps are (unix_time << 30) | counter, totally ordered and monotone;
`MAX_TIMESTAMP` reads the newest version of every row. The timestamp
provider stays out of the port until the tablet does.
"""

COUNTER_BITS = 30
MIN_TIMESTAMP = 0
MAX_TIMESTAMP = (1 << 62) - 1
