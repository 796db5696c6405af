"""WAL backends for the master: local file or quorum-of-N locations.

Ref: Hydra quorum changelogs — mutations are acknowledged by a majority of
changelog replicas before apply (server/lib/hydra/changelog.h + journal
quorum semantics, server/master/journal_server/journal_node.h:19).

Protocol invariants (Viewstamped-Replication-style; ref Hydra changelog
acquisition + VR view change):

- Every record is tagged with the EPOCH of the writer that created it
  (like a Raft entry's term); tags never change when a later writer
  re-replicates the record.
- Remote appends are position-checked AND prev-epoch-checked (the data
  node rejects an append whose stated predecessor epoch differs from its
  own last record's epoch), so a location's log is always a prefix of
  the log of the writer that last appended to it; divergent forks left
  by fenced writers are detected and reset, never silently extended.
- Recovery reads an INTERSECTING set of voting locations (>= n-q+1, so
  it shares a member with every write quorum) and adopts the log with
  the highest (last-record epoch, length) — the VR "most up-to-date"
  rule.  A record acknowledged by any write quorum is therefore visible
  to recovery on at least one voter, and the newest-epoch rule makes
  that voter win against shorter or stale-fork logs.  An UNacknowledged
  tail from the newest epoch may be adopted (it becomes committed
  retroactively, which is sound — no conflicting record was ever
  acknowledged) or discarded if no voter holds it; what can never
  happen is loss of an acknowledged record.
- Recovery re-replicates the adopted log until >= quorum locations hold
  it before acknowledging recovery, so the adopted tail is as durable
  as any acked record by the time the master applies it.

Snapshots are replicated to the journal locations BEFORE the journals are
truncated (build_snapshot), so a total local-disk loss still recovers:
newest quorum snapshot + committed journal tail.

Own copy of the JAX package's `cypress/quorum.py`.
"""

from __future__ import annotations

import os
from typing import Optional

from ytsaurus_tpu_torch.cypress.master import Changelog
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.utils.invariants import check as _invariant_check
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("quorum")

# Key under which a record carries the epoch of the writer that created
# it.  Tagged in place (records are master-mutation dicts); records
# written before epoch tagging existed read as epoch 0.
EPOCH_KEY = "$qe"


def record_epoch(record) -> int:
    """Epoch the record was created under (0 for pre-tagging records)."""
    if isinstance(record, dict):
        return int(record.get(EPOCH_KEY, 0))
    return 0


class LocalWal:
    """Single-location WAL: today's fsync'd changelog file.

    A `.init` marker distinguishes "this location has legitimately empty
    history" from "this is a fresh disk that never saw the log" — a fresh
    disk must NOT vote a zero-length prefix in quorum recovery (it would
    truncate acknowledged records)."""

    def __init__(self, path: str):
        self.path = path
        self._log: Optional[Changelog] = None
        self._last_offset: Optional[int] = None
        self.was_initialized = os.path.exists(path + ".init") or \
            os.path.exists(path)

    def _mark_initialized(self) -> None:
        marker = self.path + ".init"
        if not os.path.exists(marker):
            os.makedirs(os.path.dirname(marker) or ".", exist_ok=True)
            with open(marker, "wb") as f:
                f.flush()
                os.fsync(f.fileno())

    def recover(self) -> list[dict]:
        records, valid = Changelog.read_all(self.path)
        self._mark_initialized()
        # Drop a torn tail so future appends stay recoverable.
        if os.path.exists(self.path) and \
                os.path.getsize(self.path) > valid:
            with open(self.path, "r+b") as f:
                f.truncate(valid)
                f.flush()
                os.fsync(f.fileno())
        self._log = Changelog(self.path)
        return records

    def append(self, record: dict) -> None:
        self._last_offset = self._log.append(record)

    def drop_last(self) -> None:
        """Remove exactly the most recent append — O(1), no rewrite.
        Valid only immediately after an append (the offset is not
        tracked across recover/reset)."""
        if self._last_offset is None:
            raise YtError("no append to drop")
        self._log.truncate_to(self._last_offset)
        self._last_offset = None

    def reset(self) -> None:
        """Truncate after a snapshot."""
        self._log.close()
        self._last_offset = None
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._log = Changelog(self.path)

    def close(self) -> None:
        if self._log is not None:
            self._log.close()

    # Snapshot replication is a no-op for a single-location WAL.
    def store_snapshot(self, seq: int, blob: bytes) -> None:
        pass

    def fetch_snapshot(self) -> "tuple[int, bytes] | None":
        return None


class _Replica:
    def __init__(self, channel):
        self.channel = channel
        self.synced_len: Optional[int] = None    # None = unknown/unsynced


class QuorumWal:
    """WAL over one local location + remote journal locations."""

    def __init__(self, local_path: str, journal_name: str,
                 remote_channels: list, quorum: int = 2,
                 bootstrap_from_local: bool = False,
                 lease_ttl: float = 0.0,
                 count_local_ack: bool = True):
        self.local = LocalWal(local_path)
        self.journal_name = journal_name
        self.replicas = [_Replica(ch) for ch in remote_channels]
        self.quorum = quorum
        # >0 under leader election: epoch acquisition also claims the
        # leader lease on each granting location (see LeaderElector).
        self.lease_ttl = lease_ttl
        # count_local_ack=False = REMOTE-ONLY quorum, required under
        # multi-master failover: a successor master recovers with a
        # FRESH local location, so a record acked against "local + k
        # remotes" may sit on only k remotes — the read and write
        # quorums must intersect over the SHARED (remote) locations
        # alone.  The local file still takes every append; it just earns
        # no quorum credit and no recovery vote (it accelerates
        # restart-in-place, like a Hydra follower's local changelog).
        self.count_local_ack = count_local_ack
        # True exactly when this quorum configuration is being adopted for
        # the first time over an existing single-location log: the local
        # history is authoritative and seeds the replicas.
        self.bootstrap_from_local = bootstrap_from_local
        if quorum > 1 + len(self.replicas):
            raise YtError(f"quorum {quorum} unreachable with "
                          f"{1 + len(self.replicas)} locations")
        self._records: list[dict] = []     # committed log (truncated w/ WAL)
        # Latched on the first failed local append: a local log that
        # skipped a record must take NO further appends, or it becomes a
        # holed non-prefix that recovery could adopt (losing the skipped
        # acked record) while still looking like a valid voter.  By
        # never appending past a failure the local log stays a true
        # prefix — shorter, but honest — and keeps its voting rights.
        # Cleared when _realign_local rewrites it whole.
        self._local_broken = False
        self.epoch: int = 0                # 0 = not yet acquired
        import uuid
        self.writer_id: str = uuid.uuid4().hex[:12]

    # -- epoch fencing ---------------------------------------------------------

    def _local_epoch_path(self) -> str:
        return self.local.path + ".epoch"

    def _local_stored_epoch(self) -> int:
        from ytsaurus_tpu_torch.utils.diskio import read_epoch_file
        return read_epoch_file(self._local_epoch_path())[0]

    def _store_local_epoch(self, epoch: int) -> None:
        from ytsaurus_tpu_torch.utils.diskio import write_epoch_file
        write_epoch_file(self._local_epoch_path(), epoch, self.writer_id)

    def _fence_body(self) -> dict:
        return {"epoch": self.epoch or None, "writer": self.writer_id}

    def acquire_epoch(self) -> int:
        """Claim write ownership: epoch = max(stored)+1, granted by a
        MAJORITY of locations (ref Hydra changelog acquisition).  Any
        previous writer's appends are rejected from then on — split-brain
        masters fence each other instead of interleaving one log."""
        observed = [self._local_stored_epoch()]
        for replica in self.replicas:
            try:
                body, _ = replica.channel.call(
                    "data_node", "journal_epoch",
                    {"journal": self.journal_name})
                observed.append(int(body.get("epoch", 0)))
            except YtError:
                pass
        candidate = max(observed) + 1
        self._store_local_epoch(candidate)
        if not self.replicas:
            # Single-location deployment: one process owns the file.
            self.epoch = candidate
            return candidate
        # Grants are counted over the SHARED remote locations only: two
        # candidate masters have disjoint local locations, so quorums
        # counting locals need not intersect.  A STRICT majority of the
        # remote locations must grant — for even remote counts that is
        # n/2+1 (2-of-2 for two journal nodes), so any two successful
        # acquisitions share a granting remote and the later epoch fences
        # the earlier writer there.  The cost is liveness: with two
        # remotes, one dead remote blocks acquisition.  That is the
        # trade the fencing guarantee requires (ceil(n/2) grants would
        # let two candidates win on disjoint halves and commit divergent
        # logs, each using own-local + its granted remote for appends).
        grants = 0
        acquire_body = {"journal": self.journal_name, "epoch": candidate,
                        "writer": self.writer_id}
        if self.lease_ttl > 0:
            acquire_body["lease_ttl"] = self.lease_ttl
        for replica in self.replicas:
            try:
                body, _ = replica.channel.call(
                    "data_node", "journal_acquire", dict(acquire_body),
                    idempotent=False)
                if body.get("granted"):
                    grants += 1
            except YtError:
                pass
        needed = len(self.replicas) // 2 + 1
        if grants < needed:
            raise YtError(
                f"epoch acquisition granted by {grants}/{needed} remote "
                "locations", code=EErrorCode.PeerUnavailable)
        self.epoch = candidate
        return candidate

    # -- replica sync ----------------------------------------------------------

    def _catch_up(self, replica: _Replica, _retry_ok: bool = True) -> bool:
        """Bring one replica to the full committed log; True on success."""
        try:
            if replica.synced_len is None:
                # Length + last-epoch probe; position- and prev-epoch-
                # checked appends guarantee that a location whose last
                # record's epoch matches ours at that position holds a
                # prefix of the committed log, so the pair decides
                # between catch-up and divergence reset.
                body, _ = replica.channel.call(
                    "data_node", "journal_count",
                    {"journal": self.journal_name})
                have = int(body.get("count", 0))
                if self._fork_visible(have, body.get("last_epoch")):
                    # Uncommitted tail or a stale writer's fork from a
                    # previous incarnation; discard and reseed.
                    replica.channel.call(
                        "data_node", "journal_reset",
                        {"journal": self.journal_name,
                         **self._fence_body()}, idempotent=False)
                    have = 0
                replica.synced_len = have
            if replica.synced_len < len(self._records):
                missing = self._records[replica.synced_len:]
                replica.channel.call(
                    "data_node", "journal_append",
                    {"journal": self.journal_name, "records": missing,
                     "position": replica.synced_len,
                     "prev_epoch": record_epoch(
                         self._records[replica.synced_len - 1])
                     if replica.synced_len else 0,
                     **self._fence_body()}, idempotent=False)
                replica.synced_len = len(self._records)
            return True
        except YtError as err:
            replica.synced_len = None
            if err.code == EErrorCode.JournalEpochFenced:
                if _retry_ok and self._maybe_reacquire():
                    return self._catch_up(replica, _retry_ok=False)
                raise self._fenced_error(err)
            if err.code == EErrorCode.JournalDivergence and _retry_ok:
                # The location's tail belongs to another writer's fork
                # (probe raced, or the location predates last-epoch
                # reporting): reset it and reseed in one more pass.
                try:
                    replica.channel.call(
                        "data_node", "journal_reset",
                        {"journal": self.journal_name,
                         **self._fence_body()}, idempotent=False)
                    replica.synced_len = 0
                    return self._catch_up(replica, _retry_ok=False)
                except YtError as reset_err:
                    logger.warning("journal divergence reset failed: %s",
                                   reset_err)
                    return False
            logger.warning("journal replica catch-up failed: %s", err)
            return False

    def _fork_visible(self, have: int, last_epoch) -> bool:
        """True when a location's (count, tail-epoch) probe reveals a log
        that is NOT a prefix of the committed log — a longer log, or an
        equal/shorter one whose tail record carries a different epoch.
        Shared by catch-up (reset + reseed) and orphaned-fence
        re-acquisition (refuse): the fencing argument needs both paths
        to agree on what counts as another writer's fork."""
        return have > len(self._records) or (
            last_epoch is not None and 0 < have and
            int(last_epoch) != record_epoch(self._records[have - 1]))

    # -- write path ------------------------------------------------------------

    def _maybe_reacquire(self) -> bool:
        """Recovery from an ORPHANED fence: a takeover that died between
        acquiring its epoch and reaching quorum leaves a higher epoch
        behind with NO records.  Re-acquire only on POSITIVE evidence: a
        strict majority of remote locations answered the probe and none
        holds records beyond our committed log.  An unreachable replica is
        inconclusive, not absolving — it may be the very location holding
        a new master's records, and a partitioned stale master that
        treated silence as absence would claim a higher epoch and resume
        writing.  Any longer log means a real new master: fail-stop."""
        probed = 0
        for replica in self.replicas:
            try:
                body, _ = replica.channel.call(
                    "data_node", "journal_count",
                    {"journal": self.journal_name})
                probed += 1
                if self._fork_visible(int(body.get("count", 0)),
                                      body.get("last_epoch")):
                    return False        # another writer's fork is visible
            except YtError:
                continue
        if probed < len(self.replicas) // 2 + 1:
            return False
        try:
            self.acquire_epoch()
            logger.warning("re-acquired journal %s after an orphaned "
                           "fence (epoch now %d)", self.journal_name,
                           self.epoch)
            return True
        except YtError:
            return False

    def _fenced_error(self, err: YtError) -> YtError:
        return YtError(
            "WAL writer fenced: a newer master acquired the journal; "
            "this master must stop writing",
            code=EErrorCode.JournalEpochFenced, inner_errors=[err])

    def append(self, record: dict) -> None:
        self._append_attempt(record, _retries=3)

    def _append_attempt(self, payload: dict, _retries: int) -> None:
        position = len(self._records)
        attempt_epoch = self.epoch
        # Tag the record with the writing epoch (a copy — the caller's
        # dict stays clean).  Tags are immutable once the record is
        # committed: later writers re-replicate it with its original
        # epoch, which is what recovery's newest-epoch rule relies on.
        # An IN-FLIGHT record is re-tagged if this writer re-acquires a
        # higher epoch mid-append (orphaned-fence recovery): epochs in
        # any log must be non-decreasing, or a fenced competitor's fork
        # could outrank a log holding acknowledged records.
        record = payload
        if isinstance(record, dict) and EPOCH_KEY not in record:
            record = dict(record)
            record[EPOCH_KEY] = attempt_epoch
        prev_epoch = record_epoch(self._records[-1]) if self._records else 0
        acks = 0
        errors = []
        local_appended = False
        if not self._local_broken:
            try:
                self.local.append(record)
                local_appended = True
                if self.count_local_ack:
                    acks += 1
            except OSError as exc:      # local disk failure
                self._local_broken = True
                errors.append(YtError(f"local WAL append failed: {exc}"))
        else:
            errors.append(YtError(
                "local WAL skipped: broken since an earlier append "
                "failure (awaiting realign)"))
        for replica in self.replicas:
            synced = replica.synced_len == position or \
                self._sync_to(replica, position)
            # _sync_to may have re-acquired a new epoch after an orphaned
            # fence; the in-flight record must carry the new epoch, so
            # restart the whole attempt before extending any log with a
            # stale-tagged record (epochs in a log must not regress).
            if self.epoch != attempt_epoch:
                return self._restart_append(payload, _retries, errors,
                                            local_appended)
            if not synced:
                continue
            try:
                replica.channel.call(
                    "data_node", "journal_append",
                    {"journal": self.journal_name, "records": [record],
                     "position": position, "prev_epoch": prev_epoch,
                     **self._fence_body()},
                    idempotent=False)
                replica.synced_len = position + 1
                acks += 1
            except YtError as err:
                replica.synced_len = None
                errors.append(err)
                if err.code == EErrorCode.JournalEpochFenced:
                    if _retries > 0 and self._maybe_reacquire():
                        return self._restart_append(payload, _retries,
                                                    errors, local_appended)
                    # A newer master owns this journal: fail-stop —
                    # assembling a quorum from the remaining locations
                    # would interleave two writers.
                    raise self._fenced_error(err)
        if acks < self.quorum:
            raise YtError(
                f"WAL append reached {acks}/{self.quorum} locations",
                code=EErrorCode.PeerUnavailable, inner_errors=errors[:3])
        self._records.append(record)
        _invariant_check("wal", self._records[-2:])  # tail: non-decreasing

    def _restart_append(self, payload: dict, retries: int, errors: list,
                        local_appended: bool) -> None:
        """Redo an append after a mid-append epoch re-acquisition: rewind
        every location that may hold the stale-tagged in-flight copy
        (local via an O(1) drop of the one record; replicas via the
        divergence/longer-log reset in catch-up) and retry under the new
        epoch.  Any disk failure here surfaces as YtError so the master's
        poison latch can stop serving a tree that is ahead of its WAL."""
        if retries <= 0:
            raise YtError(
                "WAL append could not settle under a stable epoch",
                code=EErrorCode.PeerUnavailable, inner_errors=errors[:3])
        if local_appended:
            try:
                self.local.drop_last()
            except OSError as exc:
                raise YtError(
                    f"local WAL rewind failed: {exc}",
                    code=EErrorCode.PeerUnavailable,
                    inner_errors=errors[:3])
        for replica in self.replicas:
            replica.synced_len = None
        return self._append_attempt(payload, _retries=retries - 1)

    def _sync_to(self, replica: _Replica, position: int) -> bool:
        """Catch a lagging replica up to `position` committed records."""
        if not self._catch_up(replica):
            return False
        return replica.synced_len == position

    # -- recovery --------------------------------------------------------------

    def recover(self) -> list[dict]:
        local_initialized = self.local.was_initialized
        local_records = self.local.recover()
        if self.bootstrap_from_local:
            # First adoption of this quorum config: local history (possibly
            # written under a local-only WAL) is authoritative.
            self._records = list(local_records)
            self.acquire_epoch()
            for replica in self.replicas:
                replica.synced_len = None
                self._catch_up(replica)
            return list(self._records)
        # Under remote-only quorum the local history holds no vote (a
        # successor's fresh local must not dilute the read quorum, and a
        # stale local must not stretch it).
        lists: list[Optional[list]] = [
            local_records if local_initialized and self.count_local_ack
            else None]
        if not local_initialized and local_records:
            raise YtError("local WAL has records but no init marker")
        for replica in self.replicas:
            try:
                body, _ = replica.channel.call(
                    "data_node", "journal_read",
                    {"journal": self.journal_name})
                if not body.get("initialized", True):
                    # A journal this data node never held must not vote a
                    # zero-length prefix (fresh node disk).
                    lists.append(None)
                    continue
                lists.append(list(body.get("records", [])))
            except YtError as err:
                logger.warning("journal location unreachable in recovery: "
                               "%s", err)
                lists.append(None)
        voting = sum(1 for lst in lists if lst is not None)
        n_voting = len(self.replicas) + (1 if self.count_local_ack else 0)
        # The read set must intersect EVERY write quorum (>= n-q+1
        # voters), or an acknowledged record held by exactly q voters
        # could be invisible to recovery and truncated (ADVICE r3 high:
        # ack on A+B, recovery via B+C used to adopt C's shorter log).
        needed = max(self.quorum, n_voting - self.quorum + 1)
        if voting < needed:
            raise YtError(
                f"cannot recover: {voting}/{needed} initialized WAL "
                "locations reachable (the read set must intersect every "
                "write quorum; a fresh/wiped location cannot vote — "
                "bring more journal owners online)",
                code=EErrorCode.PeerUnavailable)
        # Adopt the most up-to-date log among the voters: highest
        # (last-record epoch, length) — the VR view-change rule.  The
        # intersection guarantee puts every acknowledged record on at
        # least one voter, and no fenced writer's fork can carry a newer
        # epoch than the writer that fenced it, so the chosen log
        # contains every acknowledged record.  Its (possibly unacked)
        # tail is adopted wholesale and re-replicated below.
        def _up_to_date(lst: list) -> "tuple[int, int]":
            return (record_epoch(lst[-1]) if lst else 0, len(lst))

        best = max((lst for lst in lists if lst is not None),
                   key=_up_to_date)
        self._records = list(best)
        committed = len(self._records)
        self._realign_local()
        # Fence any previous writer BEFORE this incarnation writes (ref
        # Hydra changelog acquisition at epoch start).
        self.acquire_epoch()
        # Re-replicate the adopted log until >= quorum locations hold it:
        # an adopted tail held by one voter must be as durable as any
        # acked record before the master applies it.
        holders = 1 if self.count_local_ack else 0   # local just realigned
        for replica, lst in zip(self.replicas, lists[1:]):
            if lst is not None and lst == self._records[:len(lst)]:
                replica.synced_len = len(lst)
            else:
                replica.synced_len = None
            if replica.synced_len != committed:
                self._catch_up(replica)
            if replica.synced_len == committed:
                holders += 1
        if holders < self.quorum:
            raise YtError(
                f"recovered log replicated to only {holders}/{self.quorum} "
                "locations; refusing to serve from an under-replicated "
                "tail", code=EErrorCode.PeerUnavailable)
        _invariant_check("wal", self._records)
        return list(self._records)

    def extend(self, channels: list) -> int:
        """Grow the membership AFTER recovery: seed each new location with
        the full committed log (position-checked appends from 0), then
        adopt the larger quorum.  Seeding first keeps the invariant that
        >= quorum locations hold every committed record — adopting the
        quorum before seeding would make the existing history
        unrecoverable under the new threshold.  Returns the number of
        locations successfully added."""
        added = 0
        for channel in channels:
            replica = _Replica(channel)
            replica.synced_len = None
            self.replicas.append(replica)
            if self._catch_up(replica) and \
                    replica.synced_len == len(self._records):
                added += 1
            else:
                self.replicas.pop()
        if added:
            locations = len(self.replicas) + \
                (1 if self.count_local_ack else 0)
            self.quorum = locations // 2 + 1
        return added

    def _realign_local(self) -> None:
        self.local.reset()
        for record in self._records:
            self.local.append(record)
        self._local_broken = False      # whole again (a full rewrite)

    def reset(self) -> None:
        self.local.reset()
        self._local_broken = False      # empty log is a valid prefix
        self._records = []
        for replica in self.replicas:
            try:
                replica.channel.call(
                    "data_node", "journal_reset",
                    {"journal": self.journal_name, **self._fence_body()},
                    idempotent=False)
                replica.synced_len = 0
            except YtError:
                replica.synced_len = None

    def close(self) -> None:
        self.local.close()

    # -- replicated snapshots --------------------------------------------------

    def store_snapshot(self, seq: int, blob: bytes) -> None:
        """Replicate the snapshot to enough journal locations BEFORE the
        journals are truncated: quorum-1 remotes when the local copy
        counts toward the quorum, a full remote quorum otherwise."""
        acks = 0
        errors = []
        for replica in self.replicas:
            try:
                replica.channel.call(
                    "data_node", "snapshot_put",
                    {"name": self.journal_name, "seq": seq,
                     **self._fence_body()}, [blob],
                    idempotent=False)
                acks += 1
            except YtError as err:
                errors.append(err)
        needed = self.quorum - 1 if self.count_local_ack else self.quorum
        if acks < needed:
            raise YtError(
                f"snapshot replication reached {acks}/{needed} "
                "remote locations", code=EErrorCode.PeerUnavailable,
                inner_errors=errors[:3])

    def fetch_snapshot(self) -> "tuple[int, bytes] | None":
        """Newest snapshot available on any journal location."""
        best: "tuple[int, bytes] | None" = None
        for replica in self.replicas:
            try:
                body, attachments = replica.channel.call(
                    "data_node", "snapshot_get",
                    {"name": self.journal_name})
                if body.get("seq") is None:
                    continue
                seq = int(body["seq"])
                if best is None or seq > best[0]:
                    best = (seq, attachments[0])
            except YtError:
                continue
        return best
