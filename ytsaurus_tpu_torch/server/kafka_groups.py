"""Kafka consumer-group coordinator: the classic 0.9 group membership
protocol (JoinGroup / SyncGroup / Heartbeat / LeaveGroup).

Ref: yt/yt/server/kafka_proxy/group_coordinator.h:14 — the reference
terminates group membership in the proxy so stock Kafka consumers
rebalance against YT queues.  Faithful to the public protocol's
division of labor: the COORDINATOR only runs the membership state
machine (generations, leader election among members, session expiry);
the LEADER CONSUMER computes partition assignments client-side and
ships them through SyncGroup as opaque bytes.  Committed offsets ride
the consumer tables (kafka_proxy.py OffsetCommit), so an assignment
handed to a new member resumes from the group's durable position.

State machine per group (the public GroupMetadata lifecycle):

  Empty → PreparingRebalance → CompletingRebalance → Stable
            ↑__________________________________________|
                    (member join/leave/expiry)

JoinGroup blocks until the join round closes (every known member
rejoined, or the round deadline passes and stragglers are dropped);
SyncGroup blocks followers until the leader ships assignments;
Heartbeat answers REBALANCE_IN_PROGRESS to pull members into the next
round.  A sweeper expires members that stop heartbeating — the death
of one consumer rebalances the survivors.

Own copy of the JAX package's `server/kafka_groups.py`.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("kafka_groups")

# Kafka error codes (public protocol).
ERR_NONE = 0
ERR_ILLEGAL_GENERATION = 22
ERR_INCONSISTENT_GROUP_PROTOCOL = 23
ERR_UNKNOWN_MEMBER_ID = 25
ERR_REBALANCE_IN_PROGRESS = 27

EMPTY = "Empty"
PREPARING = "PreparingRebalance"
COMPLETING = "CompletingRebalance"
STABLE = "Stable"

# How long a join round stays open for known members to rejoin once the
# first joiner arrives (the rebalance window).
JOIN_WINDOW_SECONDS = 3.0


@dataclass
class Member:
    member_id: str
    session_timeout: float                     # seconds
    protocols: "list[tuple[str, bytes]]"
    last_heartbeat: float = field(default_factory=time.monotonic)
    assignment: bytes = b""
    rejoined: bool = False                     # in the CURRENT join round


@dataclass
class Group:
    group_id: str
    state: str = EMPTY
    generation: int = 0
    protocol_type: str = ""
    protocol: str = ""
    leader_id: str = ""
    members: "dict[str, Member]" = field(default_factory=dict)
    join_deadline: float = 0.0


class GroupCoordinator:
    """Membership state machines for every group on this proxy."""

    def __init__(self, sweep_interval: float = 0.5):
        self._cond = threading.Condition()
        self._groups: "dict[str, Group]" = {}
        self._stopped = False
        self._sweeper = threading.Thread(
            target=self._sweep_loop, args=(sweep_interval,),
            daemon=True, name="kafka-group-sweeper")
        self._sweeper.start()

    def stop(self) -> None:
        self._stopped = True
        with self._cond:
            self._cond.notify_all()

    # -- join ------------------------------------------------------------------

    def join_group(self, group_id: str, session_timeout_ms: int,
                   member_id: str, protocol_type: str,
                   protocols: "list[tuple[str, bytes]]",
                   timeout: float = 30.0) -> dict:
        """Blocks until the join round closes.  Returns the JoinGroup
        response fields; the leader's `members` list carries everyone's
        subscription metadata for client-side assignment."""
        deadline = time.monotonic() + timeout
        with self._cond:
            group = self._groups.setdefault(group_id, Group(group_id))
            if member_id and member_id not in group.members:
                return {"error": ERR_UNKNOWN_MEMBER_ID}
            if group.members and protocol_type and group.protocol_type \
                    and protocol_type != group.protocol_type:
                return {"error": ERR_INCONSISTENT_GROUP_PROTOCOL}
            if not member_id:
                member_id = f"{group_id}-{uuid.uuid4().hex[:12]}"
            group.protocol_type = protocol_type or group.protocol_type
            member = Member(member_id,
                            max(session_timeout_ms, 1000) / 1000.0,
                            list(protocols))
            group.members[member_id] = member
            if group.state != PREPARING:
                self._begin_rebalance(group)
            # AFTER _begin_rebalance (which clears every rejoined flag):
            # the joiner itself is in the round by definition.
            member.rejoined = True
            member.last_heartbeat = time.monotonic()
            self._cond.notify_all()
            # Wait for the round to close (we, or whoever notices the
            # deadline/completeness first, closes it).
            while group.state == PREPARING and \
                    time.monotonic() < deadline:
                if self._join_round_closable(group):
                    self._close_join_round(group)
                    break
                self._cond.wait(timeout=0.1)
            if group.state == PREPARING:
                return {"error": ERR_REBALANCE_IN_PROGRESS}
            if member_id not in group.members:
                return {"error": ERR_UNKNOWN_MEMBER_ID}   # dropped
            response = {
                "error": ERR_NONE,
                "generation": group.generation,
                "protocol": group.protocol,
                "leader_id": group.leader_id,
                "member_id": member_id,
                "members": [],
            }
            if member_id == group.leader_id:
                chosen = group.protocol
                for mid, m in group.members.items():
                    metadata = b""
                    for name, meta in m.protocols:
                        if name == chosen:
                            metadata = meta
                            break
                    response["members"].append((mid, metadata))
            return response

    def _begin_rebalance(self, group: Group) -> None:
        group.state = PREPARING
        group.join_deadline = time.monotonic() + JOIN_WINDOW_SECONDS
        for member in group.members.values():
            member.rejoined = False
            member.assignment = b""

    def _join_round_closable(self, group: Group) -> bool:
        if all(m.rejoined for m in group.members.values()):
            return True
        return time.monotonic() >= group.join_deadline

    def _close_join_round(self, group: Group) -> None:
        # Stragglers that never rejoined are out of the generation.
        group.members = {mid: m for mid, m in group.members.items()
                        if m.rejoined}
        # The session clock restarts at the round close: a member's
        # time-to-SyncGroup is measured from HERE, not from whenever it
        # happened to enter the round.
        now = time.monotonic()
        for member in group.members.values():
            member.last_heartbeat = now
        if not group.members:
            group.state = EMPTY
            group.generation += 1
            self._cond.notify_all()
            return
        group.generation += 1
        group.leader_id = sorted(group.members)[0]
        group.protocol = self._select_protocol(group)
        group.state = COMPLETING
        logger.info("group %s generation %d: leader %s, %d members",
                    group.group_id, group.generation, group.leader_id,
                    len(group.members))
        self._cond.notify_all()

    def _select_protocol(self, group: Group) -> str:
        """First protocol (in the leader's preference order) every
        member supports — the public coordinator's vote."""
        leader = group.members[group.leader_id]
        for name, _meta in leader.protocols:
            if all(any(n == name for n, _ in m.protocols)
                   for m in group.members.values()):
                return name
        return leader.protocols[0][0] if leader.protocols else ""

    # -- sync ------------------------------------------------------------------

    def sync_group(self, group_id: str, generation: int, member_id: str,
                   assignments: "list[tuple[str, bytes]]",
                   timeout: float = 30.0) -> "tuple[int, bytes]":
        """(error, member_assignment).  The leader ships everyone's
        assignment; followers block until it lands."""
        deadline = time.monotonic() + timeout
        with self._cond:
            group = self._groups.get(group_id)
            if group is None or member_id not in group.members:
                return ERR_UNKNOWN_MEMBER_ID, b""
            if generation != group.generation:
                return ERR_ILLEGAL_GENERATION, b""
            if member_id == group.leader_id and group.state == COMPLETING:
                for mid, blob in assignments:
                    if mid in group.members:
                        group.members[mid].assignment = blob
                group.state = STABLE
                self._cond.notify_all()
            while group.state == COMPLETING and \
                    time.monotonic() < deadline:
                self._cond.wait(timeout=0.1)
            if group.state == PREPARING:
                return ERR_REBALANCE_IN_PROGRESS, b""
            if group.state != STABLE:
                return ERR_REBALANCE_IN_PROGRESS, b""
            if generation != group.generation or \
                    member_id not in group.members:
                return ERR_ILLEGAL_GENERATION, b""
            group.members[member_id].last_heartbeat = time.monotonic()
            return ERR_NONE, group.members[member_id].assignment

    # -- heartbeat / leave -----------------------------------------------------

    def heartbeat(self, group_id: str, generation: int,
                  member_id: str) -> int:
        with self._cond:
            group = self._groups.get(group_id)
            if group is None or member_id not in group.members:
                return ERR_UNKNOWN_MEMBER_ID
            group.members[member_id].last_heartbeat = time.monotonic()
            if group.state == PREPARING:
                return ERR_REBALANCE_IN_PROGRESS   # come rejoin
            if generation != group.generation:
                return ERR_ILLEGAL_GENERATION
            return ERR_NONE

    def leave_group(self, group_id: str, member_id: str) -> int:
        with self._cond:
            group = self._groups.get(group_id)
            if group is None or member_id not in group.members:
                return ERR_UNKNOWN_MEMBER_ID
            del group.members[member_id]
            self._begin_rebalance(group)
            if not group.members:
                group.state = EMPTY
            self._cond.notify_all()
            return ERR_NONE

    # -- expiry ----------------------------------------------------------------

    def _sweep_loop(self, interval: float) -> None:
        while not self._stopped:
            time.sleep(interval)
            now = time.monotonic()
            with self._cond:
                for group in self._groups.values():
                    if group.state == PREPARING:
                        # Mid-round nobody expires (the join window is
                        # short and bounds stragglers); but a round with
                        # no blocked joiner left to close it must not
                        # zombie — the sweeper closes it at deadline.
                        if now >= group.join_deadline:
                            self._close_join_round(group)
                        continue
                    dead = [mid for mid, m in group.members.items()
                            if now - m.last_heartbeat > m.session_timeout]
                    if not dead:
                        continue
                    for mid in dead:
                        logger.info("group %s: member %s expired",
                                    group.group_id, mid)
                        del group.members[mid]
                    if group.members:
                        self._begin_rebalance(group)
                    else:
                        group.state = EMPTY
                    self._cond.notify_all()

    # -- introspection ---------------------------------------------------------

    def describe(self, group_id: str) -> "Optional[dict]":
        with self._cond:
            group = self._groups.get(group_id)
            if group is None:
                return None
            return {"state": group.state,
                    "generation": group.generation,
                    "leader_id": group.leader_id,
                    "members": sorted(group.members)}
