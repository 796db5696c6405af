"""Tablet transactions: snapshot-isolated writes with 2PC across tablets.

Ref mapping:
  transaction start/commit/abort       → tablet_node/transaction_manager.h
  client-side row buffering per tablet → ytlib/api/native/transaction.cpp
                                         (ModifyRows batching)
  2PC prepare/commit                   → server/lib/transaction_supervisor
Conflict model (ref sorted_dynamic_store row locks): at prepare, a write to
key K conflicts if (a) another transaction holds a prepared lock on K, or
(b) a commit newer than our start timestamp already touched K.  Prepare
locks all keys on all participant tablets, then commit applies everywhere at
one commit timestamp — the single-process stand-in for coordinator+
participants exchanging Hive messages.

Port of the JAX package's `tablet/transactions.py`. Difference: the
prepare phase reads the newest committed timestamp of every touched key of
a tablet in one call (`Tablet.last_committed_timestamps`), then checks the
keys in the reference's order against those answers.
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from typing import Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.tablet.tablet import Tablet
from ytsaurus_tpu_torch.tablet.timestamp import TimestampProvider


@dataclass
class _Modification:
    kind: str                 # "write" | "delete"
    row: dict | tuple
    update: bool = False      # partial write (per-column merge)


@dataclass
class TabletTransaction:
    id: str
    start_timestamp: int
    modifications: dict[int, list[_Modification]] = field(default_factory=dict)
    state: str = "active"     # active | committed | aborted

    def _record(self, tablet_key: int, mod: _Modification):
        if self.state != "active":
            raise YtError(f"Transaction {self.id} is {self.state}",
                          code=EErrorCode.NoSuchTransaction)
        self.modifications.setdefault(tablet_key, []).append(mod)


class TransactionManager:
    """Coordinates transactions over a set of tablets (one per process —
    the analog of a tablet cell's transaction manager + supervisor)."""

    def __init__(self, timestamp_provider: Optional[TimestampProvider] = None):
        self.timestamps = timestamp_provider or TimestampProvider()
        self._tablets: dict[int, Tablet] = {}
        self._prepared_locks: dict[tuple[int, tuple], str] = {}
        self._lock = threading.Lock()
        self._transactions: dict[str, TabletTransaction] = {}

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> TabletTransaction:
        tx = TabletTransaction(id=uuid.uuid4().hex,
                               start_timestamp=self.timestamps.generate())
        self._transactions[tx.id] = tx
        return tx

    def write_rows(self, tx: TabletTransaction, tablet: Tablet,
                   rows: list[dict], update: bool = False) -> None:
        key = id(tablet)
        self._tablets[key] = tablet
        # Validate the WHOLE batch before recording anything: a mid-batch
        # failure must not leave earlier rows recorded in a live tx (and a
        # commit-phase failure would half-apply the transaction).
        for row in rows:
            tablet.validate_required(tablet.normalize_row(row),
                                     partial=update)
        for row in rows:
            tx._record(key, _Modification("write", dict(row), update))

    def delete_rows(self, tx: TabletTransaction, tablet: Tablet,
                    keys: list[tuple]) -> None:
        key = id(tablet)
        self._tablets[key] = tablet
        for k in keys:
            tx._record(key, _Modification("delete", tuple(k)))

    def abort(self, tx: TabletTransaction) -> None:
        with self._lock:
            if tx.state in ("committing", "committed"):
                # Aborting a committed tx must not mask its durable writes.
                raise YtError(f"Transaction {tx.id} is {tx.state}",
                              code=EErrorCode.InvalidTransactionState)
            self._release_locks(tx)
            tx.state = "aborted"

    # -- 2PC -------------------------------------------------------------------

    def commit(self, tx: TabletTransaction) -> int:
        """Prepare (lock + conflict check on every participant), then commit
        at a fresh timestamp.  Raises TransactionLockConflict and aborts on
        any conflict."""
        # Build the touched-key list BEFORE the state transition: key
        # normalization can raise on malformed client input, and that must
        # leave the tx abortable (still 'active'), not stuck 'committing'.
        if tx.state != "active":
            raise YtError(f"Transaction {tx.id} is {tx.state}",
                          code=EErrorCode.NoSuchTransaction)
        touched: list[tuple[int, tuple]] = []
        for tablet_key, mods in tx.modifications.items():
            tablet = self._tablets[tablet_key]
            for mod in mods:
                row_key = (tablet.active_store.key_of(mod.row)
                           if mod.kind == "write" else tuple(mod.row))
                touched.append((tablet_key, tablet.normalize_key(row_key)))
        with self._lock:
            # Exclusive 'committing' transition under the lock: a concurrent
            # commit/abort of the same tx must fail fast, not apply twice.
            if tx.state != "active":
                raise YtError(f"Transaction {tx.id} is {tx.state}",
                              code=EErrorCode.NoSuchTransaction)
            tx.state = "committing"
            # Phase 1: prepare — participants mounted, locks, conflicts.
            for tablet_key in tx.modifications:
                tablet = self._tablets[tablet_key]
                if not tablet.mounted:
                    tx.state = "aborted"
                    raise YtError(
                        f"Tablet {tablet.tablet_id} is not mounted",
                        code=EErrorCode.TabletNotMounted)
            acquired: list[tuple[int, tuple]] = []
            try:
                by_tablet: dict[int, list[tuple]] = {}
                for tablet_key, row_key in touched:
                    by_tablet.setdefault(tablet_key, []).append(row_key)
                last_committed: dict[tuple[int, tuple], Optional[int]] = {}
                for tablet_key, row_keys in by_tablet.items():
                    found = self._tablets[
                        tablet_key].last_committed_timestamps(row_keys)
                    last_committed.update(
                        ((tablet_key, k), ts)
                        for k, ts in zip(row_keys, found))
                for tablet_key, row_key in touched:
                    holder = self._prepared_locks.get((tablet_key, row_key))
                    if holder is not None and holder != tx.id:
                        raise YtError(
                            f"Row lock conflict on key {row_key}",
                            code=EErrorCode.TransactionLockConflict,
                            attributes={"winner": holder})
                    last = last_committed[(tablet_key, row_key)]
                    if last is not None and last > tx.start_timestamp:
                        raise YtError(
                            f"Write conflict on key {row_key}: committed at "
                            f"{last} > start {tx.start_timestamp}",
                            code=EErrorCode.TransactionLockConflict)
                    self._prepared_locks[(tablet_key, row_key)] = tx.id
                    acquired.append((tablet_key, row_key))
            except YtError:
                for lk in acquired:
                    self._prepared_locks.pop(lk, None)
                tx.state = "aborted"
                raise
            # Phase 2: commit at one timestamp on every participant.
            # Apply errors must still release locks or later transactions
            # deadlock on stale lock entries; record/prepare-time validation
            # (required columns, mounted participants) keeps this phase from
            # half-applying in the cases we can check upfront.
            commit_ts = self.timestamps.generate()
            try:
                for tablet_key, mods in tx.modifications.items():
                    tablet = self._tablets[tablet_key]
                    for mod in mods:
                        if mod.kind == "write":
                            tablet.write_row(mod.row, commit_ts,
                                             update=mod.update)
                        else:
                            tablet.delete_row(mod.row, commit_ts)
            except Exception:
                tx.state = "aborted"
                raise
            finally:
                self._release_locks(tx)
            tx.state = "committed"
            return commit_ts

    def _release_locks(self, tx: TabletTransaction) -> None:
        for lk in [k for k, holder in self._prepared_locks.items()
                   if holder == tx.id]:
            self._prepared_locks.pop(lk, None)
