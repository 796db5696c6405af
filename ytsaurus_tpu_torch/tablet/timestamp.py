"""Hybrid logical clock timestamps.

Own copy of the JAX package's `tablet/timestamp.py`.

Ref: yt/yt/server/timestamp_provider + client/transaction_client — cluster
timestamps are (unix_time << 30) | counter, totally ordered, monotone.
A single in-process provider stands in for the clock quorum; the interface
matches what a distributed quorum implementation would expose.
"""

from __future__ import annotations

import threading
import time

COUNTER_BITS = 30
MIN_TIMESTAMP = 0
MAX_TIMESTAMP = (1 << 62) - 1
# Sync-read sentinel (ref NTransactionClient::SyncLastCommittedTimestamp).
SYNC_LAST_COMMITTED = MAX_TIMESTAMP - 1
ASYNC_LAST_COMMITTED = MAX_TIMESTAMP - 2


class TimestampProvider:
    """Monotone hybrid timestamps; thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last = 0

    def generate(self) -> int:
        with self._lock:
            wall = int(time.time()) << COUNTER_BITS
            candidate = max(wall, self._last + 1)
            self._last = candidate
            return candidate

    def last(self) -> int:
        with self._lock:
            return self._last

    def observe(self, ts: int) -> None:
        """Fold an externally observed timestamp into the clock (hybrid
        logical clock advance: replicated commits keep local timestamps
        monotone across clusters/processes)."""
        with self._lock:
            if ts > self._last:
                self._last = ts


_global_provider = TimestampProvider()


def generate_timestamp() -> int:
    return _global_provider.generate()
