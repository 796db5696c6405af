"""Port of the JAX package's `errors.py`: a copy, with imports pointed at
this package (it imports nothing of the JAX package).

Structured errors with nested inner errors and stable codes.

TPU-native analog of the reference's TError (yt/yt/core/misc/error.h): an error
carries an integer code, a message, attributes, and a list of inner errors; the
whole tree serializes to/from plain dicts (and therefore YSON/JSON).
"""

from __future__ import annotations

import enum
from typing import Any, Iterable


class EErrorCode(enum.IntEnum):
    # Generic codes (ref: yt/yt/core/misc/public.h TErrorCode values).
    OK = 0
    Generic = 1
    Timeout = 3
    Canceled = 2

    # Query engine (ref: yt/yt/client/query_client/public.h).
    QueryParseError = 1000
    QueryTypeError = 1001
    QueryUnsupported = 1002
    QueryExecutionError = 1003

    # Chunk / storage.
    NoSuchChunk = 1100
    ChunkFormatError = 1101

    # Cypress / metadata.
    ResolveError = 500
    AlreadyExists = 501
    NoSuchNode = 502
    NoSuchTransaction = 503
    ConcurrentTransactionLockConflict = 402

    # Tablet / transactions.
    TransactionLockConflict = 1700
    NoSuchTablet = 1701
    TabletNotMounted = 1702
    RowIsBlocked = 1703
    TransactionAborted = 1704
    InvalidTransactionState = 1705

    # Scheduler / operations.
    NoSuchOperation = 1800
    OperationFailed = 1801

    # Table client (ref: yt/yt/client/table_client/public.h).
    SortOrderViolation = 301

    # Journals / quorum WAL.
    JournalPositionMismatch = 1850
    JournalEpochFenced = 1851
    JournalDivergence = 1852

    # Config (ref: yt/yt/core/ytree yson_struct validation).
    InvalidConfig = 216

    # Security (ref: yt/yt/client/security_client/public.h).
    AuthenticationError = 900
    AuthorizationError = 901
    AccountLimitExceeded = 902

    # RPC (ref: yt/yt/core/rpc/public.h EErrorCode).
    NoSuchMethod = 1900
    NoSuchService = 1901
    TransportError = 1902
    RpcTimeout = 1903
    PeerUnavailable = 1904

    # Query serving plane (ref: NRpc::EErrorCode::RequestQueueSizeLimit-
    # Exceeded + the request deadline propagated by TServiceContext).
    RequestThrottled = 1910
    DeadlineExceeded = 1911


class YtError(Exception):
    """An error with a code, attributes and nested inner errors."""

    def __init__(
        self,
        message: str,
        code: int = EErrorCode.Generic,
        attributes: dict[str, Any] | None = None,
        inner_errors: Iterable["YtError"] | None = None,
    ):
        super().__init__(message)
        self.message = message
        self.code = int(code)
        self.attributes = dict(attributes or {})
        self.inner_errors: list[YtError] = list(inner_errors or [])

    def find(self, code: int) -> "YtError | None":
        """Find an error with the given code anywhere in the tree."""
        if self.code == int(code):
            return self
        for inner in self.inner_errors:
            found = inner.find(code)
            if found is not None:
                return found
        return None

    def contains(self, code: int) -> bool:
        return self.find(code) is not None

    def to_dict(self) -> dict[str, Any]:
        return {
            "code": self.code,
            "message": self.message,
            "attributes": self.attributes,
            "inner_errors": [e.to_dict() for e in self.inner_errors],
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "YtError":
        return cls(
            message=d.get("message", ""),
            code=d.get("code", EErrorCode.Generic),
            attributes=d.get("attributes") or {},
            inner_errors=[cls.from_dict(e) for e in d.get("inner_errors", [])],
        )

    def __str__(self) -> str:
        parts = [f"[{self.code}] {self.message}"]
        if self.attributes:
            parts.append(f"attrs={self.attributes}")
        for inner in self.inner_errors:
            inner_str = "\n    ".join(str(inner).splitlines())
            parts.append(f"\n  <- {inner_str}")
        return " ".join(parts[:2]) + "".join(parts[2:])


class YtResponseError(YtError):
    """Error returned from a service call."""


class ThrottledError(YtError):
    """Admission rejection from the query serving plane (or any bounded
    queue): the request was NEVER executed, so resending it — even a
    mutation — is safe.  Carries a `retry_after` hint (seconds) computed
    from the rejecting queue's observed drain rate; retry wrappers honor
    it instead of their generic backoff curve."""

    def __init__(self, message: str = "request throttled",
                 retry_after: float = 0.1, **kwargs):
        attributes = dict(kwargs.pop("attributes", None) or {})
        attributes.setdefault("retry_after", float(retry_after))
        super().__init__(message, code=EErrorCode.RequestThrottled,
                         attributes=attributes, **kwargs)

    @property
    def retry_after(self) -> float:
        return float(self.attributes.get("retry_after", 0.0))


def retry_after_hint(err: YtError) -> "float | None":
    """The `retry_after` hint carried by a throttled error anywhere in
    the tree (wire round-trips reconstruct plain YtErrors, so the hint
    must be read from attributes, not the ThrottledError type)."""
    throttled = err.find(EErrorCode.RequestThrottled)
    if throttled is None:
        return None
    hint = throttled.attributes.get("retry_after")
    return float(hint) if hint is not None else None
