"""Master: the metadata authority — WAL-then-apply mutations + snapshots.

Ref: Hydra's mutation pipeline (server/lib/hydra/hydra_manager.h
CommitMutation → decorated_automaton WAL-append-then-apply, snapshot build/
load in composite_automaton.h).  Single-replica stand-in with the same
durability contract: every mutation is appended (fsync'd) to the changelog
BEFORE applying to the in-memory tree; recovery = load last snapshot +
replay the changelog; snapshots truncate the log.

A real multi-peer deployment replicates the changelog via a quorum before
apply — the apply/recover machinery here is the automaton that would sit
under it.

Own copy of the JAX package's `cypress/master.py`.
"""

from __future__ import annotations

import os
import threading
from typing import Any

from ytsaurus_tpu_torch import yson
from ytsaurus_tpu_torch.cypress.tree import CypressTree
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.utils.diskio import fsync_dir as _fsync_dir
from ytsaurus_tpu_torch.utils.varint import encode_varint_u, read_varint_u


class Changelog:
    """Length-prefixed YSON records, fsync'd on append (ref: file changelogs,
    server/lib/hydra/changelog.h)."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "ab")
        self._lock = threading.Lock()

    def append(self, record: dict) -> int:
        """Appends one record; returns the byte offset the record starts
        at (callers can truncate back to it to drop exactly this
        record)."""
        blob = yson.dumps(record, binary=True)
        with self._lock:
            offset = self._file.tell()
            self._file.write(encode_varint_u(len(blob)) + blob)
            self._file.flush()
            os.fsync(self._file.fileno())
            return offset

    def truncate_to(self, byte_len: int) -> None:
        with self._lock:
            self._file.truncate(byte_len)
            self._file.seek(byte_len)
            self._file.flush()
            os.fsync(self._file.fileno())

    def close(self) -> None:
        self._file.close()

    @staticmethod
    def read_all(path: str) -> tuple[list[dict], int]:
        """Returns (records, valid_byte_length).  A torn tail write stops the
        scan; the caller MUST truncate to valid_byte_length before appending,
        or post-recovery records land after garbage and vanish on the next
        recovery."""
        records = []
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return [], 0
        pos = 0
        valid = 0
        while pos < len(data):
            try:
                length, pos = read_varint_u(data, pos)
                blob = data[pos:pos + length]
                if len(blob) != length:
                    break              # torn tail write → stop at last good
                records.append(yson.loads(blob))
                pos += length
                valid = pos
            except (ValueError, YtError):
                break
        return records, valid


class Master:
    """Applies named mutations through the WAL; exposes the Cypress tree."""

    SNAPSHOT = "snapshot.yson"
    CHANGELOG = "changelog.log"

    def __init__(self, root_dir: str, wal=None):
        from ytsaurus_tpu_torch.cypress.quorum import LocalWal
        from ytsaurus_tpu_torch.cypress.transactions import MasterTransactionManager
        self.root_dir = root_dir
        os.makedirs(root_dir, exist_ok=True)
        # Re-entrant BY CONTRACT: mutation_lock holders issue nested
        # commit_mutation calls (see the property below).
        self._lock = threading.RLock()
        self._poisoned = False
        self._mutation_listeners: list = []
        self._snapshot_seq = 0
        self.tree = CypressTree()
        self.tx_manager = MasterTransactionManager(self.tree)
        # wal: LocalWal (default) or QuorumWal over journal locations on
        # data nodes — recover() returns replayable records, append() is
        # the durability barrier, reset() truncates after snapshots.
        self.wal = wal if wal is not None else \
            LocalWal(os.path.join(root_dir, self.CHANGELOG))
        self._recover()

    # -- mutation pipeline -----------------------------------------------------

    _MUTATIONS = ("create", "remove", "set", "copy", "move", "link",
                  "tx_start", "tx_commit", "tx_abort", "lock", "batch")
    _TREE_MUTATIONS = ("create", "remove", "set", "copy", "move", "link")

    @property
    def mutation_lock(self):
        """Public handle on the mutation lock for callers that need an
        atomic read-modify-write spanning a read plus commit_mutation
        (e.g. the chaos coordinator's era bump, the replicator's
        liveness walk).  Guaranteed re-entrant: holders may issue nested
        commit_mutation calls."""
        return self._lock

    def commit_mutation(self, op: str, **args) -> Any:
        """Log, then apply (ref CommitMutation)."""
        if op not in self._MUTATIONS:
            raise YtError(f"Unknown mutation {op!r}")
        if op == "tx_start" and not args.get("tx_id"):
            # The id MUST be fixed before logging: replay regenerating a
            # fresh id would orphan every subsequent tx-scoped record.
            import uuid
            args["tx_id"] = uuid.uuid4().hex
        with self._lock:
            if self._poisoned:
                raise YtError(
                    "Master is read-only: a WAL append failed and the "
                    "in-memory state is ahead of the durable log; restart "
                    "the primary to recover",
                    code=EErrorCode.PeerUnavailable)
            # Validate BEFORE logging by applying to the live tree; Hydra
            # validates in the mutation handler too — a failed apply after a
            # logged record would poison recovery, so log only after the
            # apply succeeds, holding the lock (single-writer semantics).
            result = self._apply(op, args)
            try:
                self.wal.append({"op": op, "args": args})
            except YtError:
                # The tree now holds a mutation the log does not.  Under a
                # quorum WAL this is a routine network failure, and serving
                # further mutations would let later LOGGED records depend
                # on this unlogged one (divergence after replay).  Latch
                # read-only, like a Hydra leader restarting its automaton
                # on changelog failure.
                self._poisoned = True
                raise
            for listener in self._mutation_listeners:
                try:
                    listener(op, args, result)
                except Exception:   # noqa: BLE001 — observers never poison
                    pass
            return result

    def add_mutation_listener(self, listener) -> None:
        """Post-commit observer: listener(op, args, result) runs after a
        mutation is durably logged (Sequoia resolve-table maintenance,
        metrics).  Observers must not mutate the tree via
        commit_mutation from the callback (the lock is held)."""
        self._mutation_listeners.append(listener)

    def _apply(self, op: str, args: dict) -> Any:
        if op == "batch":
            # One WAL record applying several tree ops atomically — the
            # carrier for Hive message application (handler effects + the
            # last-applied bump must land together for exactly-once).
            # Name validation up front; RESOLUTION failures can still hit
            # any sub-op mid-batch (create over an existing node, remove
            # of a missing path), so each sub-op's undo is captured before
            # it applies and a failure rolls the earlier sub-ops back —
            # all-or-nothing, matching the single-WAL-record semantics
            # (the record is only logged if the whole apply succeeds).
            ops = args["ops"]
            for sub in ops:
                if sub["op"] not in ("create", "set", "remove"):
                    raise YtError(
                        f"batch sub-op {sub['op']!r} not allowed",
                        code=EErrorCode.Generic)
            undos: list = []
            results: list = []
            try:
                for sub in ops:
                    sub_args = dict(sub["args"])
                    undos.append(
                        self.tx_manager.capture_undo(sub["op"], sub_args))
                    results.append(self._apply(sub["op"], sub_args))
            except BaseException:
                # Any failure — resolution YtError or a malformed sub-op
                # raising KeyError — must roll earlier sub-ops back, or
                # the tree diverges from the (never-written) WAL record.
                try:
                    for undo in reversed(undos):
                        self.tx_manager.apply_undo(undo)
                except Exception:
                    # Rollback itself failed: the tree diverged from the
                    # log with no record to cover it — latch read-only.
                    self._poisoned = True
                raise
            return results
        # Transaction lifecycle + lock mutations (ref: transaction_server
        # master transactions riding the same Hydra mutation pipeline).
        if op == "tx_start":
            return self.tx_manager.start(args.get("tx_id"),
                                         args.get("parent_id"))
        if op == "tx_commit":
            return self.tx_manager.commit(args["tx_id"])
        if op == "tx_abort":
            return self.tx_manager.abort(args["tx_id"])
        if op == "lock":
            return self.tx_manager.lock(args["tx_id"], args["path"],
                                        args.get("mode", "exclusive"))
        # Tree mutations: lock-conflict check + undo capture first (the
        # undo must observe the pre-mutation state); the undo is recorded
        # only after the tree op succeeds.
        tx_id = args.get("tx")
        undo = self.tx_manager.before_mutation(tx_id, op,
                                               {k: v for k, v in args.items()
                                                if k != "tx"})
        result = self._apply_tree_op(op, args)
        self.tx_manager.after_mutation(tx_id, undo)
        return result

    def _apply_tree_op(self, op: str, args: dict) -> Any:
        if op == "create":
            return self.tree.create(
                args["path"], args["type"],
                attributes=args.get("attributes"),
                recursive=args.get("recursive", False),
                ignore_existing=args.get("ignore_existing", False))
        if op == "remove":
            return self.tree.remove(args["path"],
                                    recursive=args.get("recursive", True),
                                    force=args.get("force", False))
        if op == "set":
            return self.tree.set(args["path"], args.get("value"))
        if op == "copy":
            return self.tree.copy(args["src"], args["dst"],
                                  recursive=args.get("recursive", False))
        if op == "move":
            return self.tree.move(args["src"], args["dst"],
                                  recursive=args.get("recursive", False))
        if op == "link":
            return self.tree.link(args["target"], args["link"],
                                  recursive=args.get("recursive", False))
        raise AssertionError(op)

    # -- snapshots / recovery --------------------------------------------------

    def build_snapshot(self) -> None:
        """Serialize the tree, replicate the snapshot, truncate the
        changelog (ref snapshot build).  Remote replication happens FIRST:
        truncating quorum journals with a local-only snapshot would
        collapse metadata durability back to one disk."""
        with self._lock:
            seq = self._snapshot_seq + 1
            blob = yson.dumps({"seq": seq, "tree": self.tree.serialize(),
                               "transactions": self.tx_manager.serialize()},
                              binary=True)
            self.wal.store_snapshot(seq, blob)
            snap_path = os.path.join(self.root_dir, self.SNAPSHOT)
            tmp = snap_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, snap_path)
            _fsync_dir(self.root_dir)      # make the rename durable first
            self._snapshot_seq = seq
            self.wal.reset()
            _fsync_dir(self.root_dir)

    @staticmethod
    def _load_snapshot_blob(blob: bytes) -> tuple[int, dict, dict]:
        data = yson.loads(blob)
        if isinstance(data, dict) and "seq" in data and "tree" in data:
            return (int(data["seq"]), data["tree"],
                    data.get("transactions") or {})
        return 0, data, {}          # pre-versioning format

    def _recover(self) -> None:
        # Recovery mutates tree/tx state through the same _apply path
        # as live mutations; holding the (re-entrant) mutation lock
        # keeps the single-writer discipline uniform — construction is
        # single-threaded, so this is contention-free, and a subclass
        # or restart path re-running recovery stays safe.
        with self._lock:
            self._recover_locked()

    def _recover_locked(self) -> None:
        local: "tuple[int, dict] | None" = None
        snap_path = os.path.join(self.root_dir, self.SNAPSHOT)
        if os.path.exists(snap_path):
            with open(snap_path, "rb") as f:
                local = self._load_snapshot_blob(f.read())
        remote = self.wal.fetch_snapshot()
        if remote is not None:
            remote = self._load_snapshot_blob(remote[1])
        # Newest snapshot wins: a lost local disk recovers from the
        # replicated copy, and journal tails always belong to the newest
        # snapshot epoch (reset happens after replication).
        best = max((s for s in (local, remote) if s is not None),
                   key=lambda s: s[0], default=None)
        if best is not None:
            from ytsaurus_tpu_torch.cypress.transactions import (
                MasterTransactionManager,
            )
            self._snapshot_seq = best[0]
            self.tree = CypressTree.deserialize(best[1])
            self.tx_manager = MasterTransactionManager.deserialize(
                self.tree, best[2])
        for record in self.wal.recover():
            try:
                self._apply(record["op"], dict(record["args"]))
            except YtError:
                # Mutations are validated before logging; a failing replay
                # record means it raced a snapshot — skip.
                continue
