"""Hive: reliable exactly-once ordered cross-cell messaging.

Ref mapping (server/lib/hive):
  THiveManager::PostMessage (hive_manager.h:130)  → HiveManager.post —
                                                    message lands in a
                                                    WAL-durable outbox
                                                    with a monotone seqno
  mailbox delivery + acks                         → HiveManager.flush —
                                                    replays every message
                                                    past the receiver's
                                                    last-applied seqno,
                                                    then trims the outbox
  exactly-once application (messages apply as     → HiveManager.apply —
  Hydra mutations on the receiving cell)            handler effects and
                                                    the last-applied bump
                                                    ride ONE atomic batch
                                                    mutation, so a replay
                                                    or crash can never
                                                    half-apply a message

Design delta: handlers are declarative — they return cypress tree ops
(create/set/remove) rather than running arbitrary code, which is what
makes the atomic batch possible (the reference gets the same property by
making message application itself an automaton mutation).

Own copy of the JAX package's `cypress/hive.py`.
"""

from __future__ import annotations

from typing import Callable, Optional

from ytsaurus_tpu_torch.cypress.security import ROOT_USER, authenticated_user
from ytsaurus_tpu_torch.errors import EErrorCode, YtError

HIVE_ROOT = "//sys/hive"


class HiveManager:
    """One per cell (cluster); in-process registry of message handlers."""

    def __init__(self, client, cell_id: str):
        self.client = client
        self.cell_id = cell_id
        self._handlers: dict[str, Callable] = {}
        # Outbox mutation is read-modify-write over a document; concurrent
        # posters (daemon worker threads share one manager) must not lose
        # a message or duplicate a seqno.
        import threading
        self._outbox_lock = threading.Lock()

    def register_handler(self, message_type: str,
                         handler: Callable[[dict], "list | None"]) -> None:
        """handler(payload) → list of (op, args) cypress tree ops
        (op ∈ create/set/remove) applied atomically with the ack."""
        self._handlers[message_type] = handler

    # ------------------------------------------------------------- sending

    def _outbox_path(self, dst_cell: str) -> str:
        return f"{HIVE_ROOT}/{self.cell_id}/outbox/{dst_cell}"

    def _inbox_path(self, src_cell: str) -> str:
        return f"{HIVE_ROOT}/{self.cell_id}/inbox/{src_cell}"

    def post(self, dst_cell: str, message_type: str,
             payload: Optional[dict] = None) -> int:
        """Enqueue a message; durable before this returns (outbox state is
        a WAL mutation).  Returns the message's seqno."""
        path = self._outbox_path(dst_cell)
        with self._outbox_lock, authenticated_user(ROOT_USER):
            if not self.client.exists(path):
                self.client.create("document", path, recursive=True)
                self.client.set(path, {"next_seqno": 1, "messages": []})
            state = dict(self.client.get(path))
            seqno = int(state["next_seqno"])
            state["messages"] = list(state["messages"]) + [{
                "seqno": seqno, "type": message_type,
                "payload": payload or {}}]
            state["next_seqno"] = seqno + 1
            self.client.set(path, state)
        return seqno

    def pending(self, dst_cell: str) -> int:
        path = self._outbox_path(dst_cell)
        if not self.client.exists(path):
            return 0
        return len(self.client.get(path)["messages"])

    def flush(self, dst_hive: "HiveManager") -> int:
        """Deliver every unacked message to the destination cell, in
        order; idempotent (the receiver dedupes by seqno).  Returns the
        number of messages newly applied.  Acked messages trim from the
        outbox."""
        path = self._outbox_path(dst_hive.cell_id)
        if not self.client.exists(path):
            return 0
        state = dict(self.client.get(path))
        messages = sorted(state["messages"], key=lambda m: m["seqno"])
        applied = 0
        for msg in messages:
            if dst_hive.apply(self.cell_id, msg):
                applied += 1
        last = dst_hive.last_applied(self.cell_id)
        # Trim under the outbox lock, re-reading: a concurrent post may
        # have appended past the snapshot taken above.
        with self._outbox_lock, authenticated_user(ROOT_USER):
            state = dict(self.client.get(path))
            remaining = [m for m in state["messages"]
                         if m["seqno"] > last]
            if len(remaining) != len(state["messages"]):
                state["messages"] = remaining
                self.client.set(path, state)
        return applied

    # ----------------------------------------------------------- receiving

    def last_applied(self, src_cell: str) -> int:
        path = self._inbox_path(src_cell)
        if not self.client.exists(path):
            return 0
        return int(self.client.get(path))

    def apply(self, src_cell: str, msg: dict) -> bool:
        """Apply one message exactly once.  Returns False for duplicates;
        raises on seqno gaps (ordered delivery is part of the contract)."""
        seqno = int(msg["seqno"])
        last = self.last_applied(src_cell)
        if seqno <= last:
            return False
        if seqno != last + 1:
            raise YtError(
                f"Hive message gap from {src_cell!r}: got seqno {seqno}, "
                f"expected {last + 1}", code=EErrorCode.Generic)
        handler = self._handlers.get(msg["type"])
        if handler is None:
            raise YtError(f"No hive handler for {msg['type']!r} "
                          f"on cell {self.cell_id!r}",
                          code=EErrorCode.Generic)
        ops = list(handler(dict(msg.get("payload") or {})) or [])
        inbox = self._inbox_path(src_cell)
        with authenticated_user(ROOT_USER):
            if not self.client.exists(inbox):
                self.client.create("document", inbox, recursive=True)
                self.client.set(inbox, 0)
            # Handler effects + the ack bump in ONE WAL record.
            self.client.cluster.master.commit_mutation("batch", ops=(
                [{"op": op, "args": args} for op, args in ops] +
                [{"op": "set", "args": {"path": inbox, "value": seqno}}]))
        return True
