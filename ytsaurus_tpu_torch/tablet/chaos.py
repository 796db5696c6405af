"""Chaos replication: replication cards, eras, coordinated sync cutover.
Own copy of the JAX package's `tablet/chaos.py`.

Ref mapping:
  replication cards + eras (server/master/chaos_server/,
    client/chaos_client/replication_card.h) → a per-table
    @replication_card document: {era, history[{era, reason, modes, ts}]}.
    Every configuration change (which replica is synchronous) bumps the
    era and appends a history entry, so participants can tell WHICH
    configuration a write ran under.
  chaos_agent.h (era-driven reconfiguration) → writers observe the card
    era when they enroll sync replicas in a commit; a commit that raced
    an era change re-delivers its events to the new configuration
    (idempotent: replicated applies preserve upstream timestamps, so a
    double delivery converges to the same version).
  switchable sync coordinator → switch_sync(): joint-era cutover.  The
    NEW sync replica is enrolled in the 2PC fanout FIRST (joint era:
    both old and new are synchronous — there is never a window without
    a synchronous copy), then the gap between its async checkpoint and
    the flip is closed by an idempotent catch-up, then the old sync is
    demoted.  A crash mid-switch leaves an over-synchronous
    configuration, never an unprotected one.

Design delta (consistent with tablet/replication.py): the versioned
snapshot IS the replication log, so "catch up the gap" is the same
events_since filter the async replicator uses, and the card is plain
Cypress metadata riding the master WAL — no separate chaos cell
process.
"""

from __future__ import annotations

import time

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.tablet import replication as repl

CARD_ATTR = "replication_card"


def get_card(client, table_path: str) -> dict | None:
    node = client._table_node(table_path)
    card = node.attributes.get(CARD_ATTR)
    return dict(card) if card else None


def current_era(client, table_path: str) -> int:
    """Era 0 = no card yet (plain replicated table, pre-chaos)."""
    card = get_card(client, table_path)
    return int(card["era"]) if card else 0


def redeliver_commit(client, table_path: str, commit_ts: int) -> None:
    """Compensator for a commit that raced an era change: deliver this
    commit's events to every CURRENTLY enabled sync replica, bypassing
    the (possibly already advanced) checkpoint.  Safe to run even when
    nothing was missed — applies preserve upstream timestamps, so
    re-delivery is idempotent."""
    events = repl.events_since(client, table_path, commit_ts - 1)
    if not events:
        return
    for rid, rc, rpath in client._sync_replica_targets(table_path):
        repl.apply_events(rc, rpath, events)


class ChaosCoordinator:
    """Drives replication-card eras for one cluster's client."""

    def __init__(self, client):
        self.client = client

    def ensure_card(self, table_path: str) -> dict:
        card = get_card(self.client, table_path)
        if card is None:
            replicas = repl.replica_descriptors(self.client, table_path)
            card = {"era": 1, "history": [{
                "era": 1, "reason": "created",
                "modes": {rid: info.get("mode")
                          for rid, info in replicas.items()},
                "ts": time.time()}]}
            self._store(table_path, card)
        return card

    def era(self, table_path: str) -> int:
        return int(self.ensure_card(table_path)["era"])

    def _store(self, table_path: str, card: dict) -> None:
        self.client.set(table_path + "/@" + CARD_ATTR, card)

    def _bump(self, table_path: str, reason: str) -> int:
        """Era bump as an ATOMIC read-modify-write: the whole get+set
        runs under the master's mutation lock, so two coordinators
        (threads, or remote drivers executing inside the same leader
        process) cannot both read era N and store N+1 — a lost bump
        would let a racing writer's post-commit era check pass without
        re-delivering to the new configuration.  Multi-master safety
        comes from the coordinator living with the LEADER (a follower's
        writes are fenced by the WAL epoch), matching the reference's
        single chaos cell owning each card."""
        with self.client.cluster.master.mutation_lock:
            card = self.ensure_card(table_path)
            replicas = repl.replica_descriptors(self.client, table_path)
            card["era"] = int(card["era"]) + 1
            card["history"] = list(card["history"]) + [{
                "era": card["era"], "reason": reason,
                "modes": {rid: info.get("mode")
                          for rid, info in replicas.items()},
                "ts": time.time()}]
            self._store(table_path, card)
            return card["era"]

    def _catch_up_from(self, table_path: str, replica_id: str,
                       from_ts: int) -> int:
        """Close the (from_ts, now] gap on one replica regardless of its
        current checkpoint (idempotent over preserved timestamps), then
        raise the checkpoint so the async replicator does not replay."""
        replicas = repl.replica_descriptors(self.client, table_path)
        info = replicas.get(replica_id)
        if info is None:
            raise YtError(f"No such replica {replica_id!r}",
                          code=EErrorCode.ResolveError)
        rc = self.client.table_replicator.replica_client(
            info.get("cluster_root"))
        events = repl.events_since(self.client, table_path, from_ts)
        applied = repl.apply_events(rc, info["path"], events)
        if events:
            head = max(e[0] for e in events)
            replicas = repl.replica_descriptors(self.client, table_path)
            entry = replicas[replica_id]
            entry["last_replicated_ts"] = max(
                int(entry.get("last_replicated_ts", 0)), head)
            repl.set_replica_descriptors(self.client, table_path, replicas)
        return applied

    def switch_sync(self, table_path: str, new_sync_id: str) -> int:
        """Coordinated sync cutover; returns the resulting era.

        Order of operations is the safety argument:
        1. JOINT ERA — the new sync replica joins the 2PC fanout while
           the old one is still synchronous.  From this point no commit
           can miss the new replica; writes in flight from the previous
           era are handled by (2) or by the client's era re-check.
        2. GAP CATCH-UP — events between the replica's pre-flip
           checkpoint and the flip are re-delivered idempotently.
        3. SWITCHED ERA — the old sync replica(s) drop to async.
        """
        replicas = repl.replica_descriptors(self.client, table_path)
        info = replicas.get(new_sync_id)
        if info is None:
            raise YtError(f"No such replica {new_sync_id!r}",
                          code=EErrorCode.ResolveError)
        if not info.get("enabled"):
            raise YtError(f"Replica {new_sync_id!r} is disabled",
                          code=EErrorCode.InvalidTransactionState)
        old_syncs = [rid for rid, i in replicas.items()
                     if i.get("mode") == "sync" and rid != new_sync_id]
        if info.get("mode") == "sync":
            return self.era(table_path)         # already the sync replica
        pre_ckpt = int(info.get("last_replicated_ts", 0))
        self.client.alter_table_replica(table_path, new_sync_id,
                                        mode="sync")
        self._bump(table_path, f"joint:{new_sync_id}")
        self._catch_up_from(table_path, new_sync_id, pre_ckpt)
        for rid in old_syncs:
            self.client.alter_table_replica(table_path, rid, mode="async")
        return self._bump(table_path, f"switched:{new_sync_id}")
