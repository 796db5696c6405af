"""Invariant checking: the debug-build sanitizer analog.

Own copy of the JAX package's `utils/invariants.py` without its `wal`
check (the port has no replicated log).

Ref: the reference leans on debug-build assertions (YT_VERIFY /
VERIFY_*), TSAN/ASAN builds, and stress suites to catch state
corruption early.  A Python framework has no TSAN, so this module
provides the piece that carries over: STRUCTURAL INVARIANT checks at
subsystem boundaries, enabled via YT_TPU_INVARIANTS=1 (tests/conftest
turns them on for the whole suite, so every integration scenario runs
"sanitized"; production leaves them off — some checks walk whole
stores).

Registered checks (grown alongside the subsystems):
  tablet   — per store: versioned rows key-ordered, no duplicate
             (key, timestamp) version
  chunks   — column planes share one capacity; row_count <= capacity

Usage: `check("tablet", tablet_obj)` at a boundary — a no-op unless
enabled; violations raise InvariantError with enough context to debug
the corruption at its SOURCE rather than at a distant read.
"""

from __future__ import annotations

import os

from ytsaurus_tpu_torch.errors import YtError


class InvariantError(YtError):
    pass


def enabled() -> bool:
    return os.environ.get("YT_TPU_INVARIANTS", "") not in ("", "0")


def _fail(domain: str, message: str) -> None:
    raise InvariantError(f"INVARIANT[{domain}]: {message}")


def check_chunk(chunk) -> None:
    cap = chunk.capacity
    if chunk.row_count > cap:
        _fail("chunks", f"row_count {chunk.row_count} > capacity {cap}")
    for name, col in chunk.columns.items():
        if col.data.shape[0] != cap or col.valid.shape[0] != cap:
            _fail("chunks",
                  f"column {name!r} planes {col.data.shape[0]}/"
                  f"{col.valid.shape[0]} != capacity {cap}")


def check_tablet(tablet) -> None:
    """Per-STORE structural checks (no whole-tablet materialization —
    flush/compact hooks must stay O(store), not O(table)):
    - versioned rows ordered by key (versions of one key adjacent),
    - no duplicate (key, timestamp) version within a store."""
    stores = [getattr(tablet, "active_store", None)] + \
        list(getattr(tablet, "passive_stores", ()) or ())
    key_names = tablet.schema.key_column_names
    for store in stores:
        if store is None or not hasattr(store, "versioned_rows"):
            continue
        prev_key = None
        seen_ts: set = set()
        for vrow in store.versioned_rows():
            key = tuple(_orderable(vrow[k]) for k in key_names)
            if prev_key is not None and key < prev_key:
                _fail("tablet", f"store keys out of order: {key} after "
                                f"{prev_key}")
            if key != prev_key:
                seen_ts = set()
            ts = vrow["$timestamp"]
            if ts in seen_ts:
                _fail("tablet", f"duplicate version timestamp {ts} for "
                                f"key {key}")
            seen_ts.add(ts)
            prev_key = key


def _orderable(value):
    """Null-safe, cross-type-safe ordering key (null sorts first)."""
    if value is None:
        return (0, 0)
    if isinstance(value, bool):
        return (1, int(value))
    if isinstance(value, (int, float)):
        return (2, value)
    if isinstance(value, bytes):
        return (3, value)
    if isinstance(value, str):
        return (3, value.encode())
    return (4, repr(value))


def check_versioned_rows(subject) -> None:
    """(key_names, rows) about to be PERSISTED by a flush/compaction:
    key-ordered, and no (key, timestamp) version recorded twice — the
    strongest place to check, because it sees the exact bytes headed
    for the chunk regardless of which store they came from."""
    key_names, rows = subject
    prev_key = None
    seen_ts: set = set()
    for i, row in enumerate(rows):
        key = tuple(_orderable(row[k]) for k in key_names)
        if prev_key is not None and key < prev_key:
            _fail("versioned_rows",
                  f"row {i}: key {key} out of order after {prev_key}")
        if key != prev_key:
            seen_ts = set()
        ts = row["$timestamp"]
        if ts in seen_ts:
            _fail("versioned_rows",
                  f"row {i}: duplicate version timestamp {ts} for key "
                  f"{key}")
        seen_ts.add(ts)
        prev_key = key


_CHECKS = {
    "chunks": check_chunk,
    "tablet": check_tablet,
    "versioned_rows": check_versioned_rows,
}


def check(domain: str, subject) -> None:
    """Boundary hook: no-op unless YT_TPU_INVARIANTS is set."""
    if not enabled():
        return
    checker = _CHECKS.get(domain)
    if checker is None:
        _fail(domain, "unknown invariant domain")
    checker(subject)
