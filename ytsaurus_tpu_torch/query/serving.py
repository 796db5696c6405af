"""The cancellation token of a query.

Own copy of the JAX package's `query/serving.py::CancellationToken`: a
deadline and cooperative cancellation, checked by the coordinator before
each shard's staging and execution. The reference's gateway (admission
pools, batching, the brown-out ladder) is not ported; `rung` is kept for
its callers.
"""

from __future__ import annotations

import time
from typing import Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError


class CancellationToken:
    """`check()` raises DeadlineExceeded (terminal, never retried) or
    Canceled. None everywhere means no deadline."""

    __slots__ = ("deadline", "pool", "user", "_cancelled", "_reason",
                 "rung")

    def __init__(self, deadline: Optional[float] = None,
                 pool: Optional[str] = None,
                 user: Optional[str] = None):
        self.deadline = deadline          # time.monotonic() timestamp
        self.pool = pool
        self.user = user
        self._cancelled = False
        self._reason: Optional[str] = None
        self.rung = 0

    @classmethod
    def with_timeout(cls, timeout: Optional[float],
                     pool: Optional[str] = None,
                     user: Optional[str] = None) -> "CancellationToken":
        deadline = time.monotonic() + timeout \
            if timeout is not None and timeout > 0 else None
        return cls(deadline, pool=pool, user=user)

    def cancel(self, reason: str = "query cancelled") -> None:
        self._reason = reason
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def expired(self) -> bool:
        return self.deadline is not None and \
            time.monotonic() >= self.deadline

    def check(self) -> None:
        if self._cancelled:
            raise YtError(self._reason or "query cancelled",
                          code=EErrorCode.Canceled,
                          attributes={"pool": self.pool}
                          if self.pool else {})
        if self.expired:
            raise YtError(
                "query deadline exceeded",
                code=EErrorCode.DeadlineExceeded,
                attributes={"pool": self.pool} if self.pool else {})
