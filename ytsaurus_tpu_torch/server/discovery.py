"""Discovery server: named group membership with TTL'd heartbeats.

Ref: yt/yt/server/discovery_server (+ client/api discovery requests) —
processes publish themselves into hierarchical groups and clients list
live members instead of carrying hardcoded peer lists.  The framework's
NodeTracker is the special case for data nodes; this generalizes the
same lease model to arbitrary groups (query trackers, proxies, custom
services).

Own copy of the JAX package's `server/discovery.py`.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.rpc import Service, rpc_method
from ytsaurus_tpu_torch.rpc.wire import wire_text as _text
from ytsaurus_tpu_torch.utils import sanitizers

# Every telemetry-bearing daemon self-registers here (member address =
# its MONITORING endpoint): the primary's /cluster roll-up lists this
# group and scrapes each member's /telemetry (server/monitoring.py).
DAEMONS_GROUP = "/daemons"


def announce_daemon(tracker: "DiscoveryTracker", member_id: str,
                    monitoring_address: str, role: str,
                    period: float = 5.0) -> threading.Thread:
    """In-process self-registration loop (primary-side daemons): keeps
    this process's monitoring endpoint alive in the tracker's /daemons
    group.  Remote daemons (data nodes) heartbeat the same group over
    the discovery RPC service instead (server/daemon.py beat loop)."""
    def loop() -> None:
        while True:
            tracker.heartbeat(DAEMONS_GROUP, member_id,
                              address=monitoring_address,
                              attributes={"role": role})
            time.sleep(period)

    thread = threading.Thread(target=loop, daemon=True,
                              name=f"daemon-announce-{member_id}")
    thread.start()
    return thread


class DiscoveryTracker:
    """Group → member_id → (address, attributes, expiry)."""

    def __init__(self, member_ttl: float = 15.0):
        self.member_ttl = member_ttl
        self._groups: dict[str, dict[str, dict]] = {}
        # guards: _groups
        self._lock = sanitizers.register_lock(
            "discovery.DiscoveryTracker._lock")

    @staticmethod
    def _check_group(group: str) -> str:
        if not group.startswith("/") or group.endswith("/") or \
                "//" in group[1:]:
            raise YtError(f"Bad group id {group!r} (use /a/b form)",
                          code=EErrorCode.ResolveError)
        return group

    def heartbeat(self, group: str, member_id: str, address: str = "",
                  attributes: Optional[dict] = None) -> None:
        group = self._check_group(group)
        with self._lock:
            members = self._groups.setdefault(group, {})
            members[member_id] = {
                "address": address,
                "attributes": dict(attributes or {}),
                "expiry": time.monotonic() + self.member_ttl,
            }

    def leave(self, group: str, member_id: str) -> None:
        with self._lock:
            members = self._groups.get(self._check_group(group)) or {}
            members.pop(member_id, None)

    def _alive_locked(self, group: str) -> dict[str, dict]:
        now = time.monotonic()
        members = self._groups.get(group) or {}
        live = {m: info for m, info in members.items()
                if info["expiry"] > now}
        if len(live) != len(members):
            self._groups[group] = live
        return live

    def list_members(self, group: str) -> list[dict]:
        group = self._check_group(group)
        with self._lock:
            live = self._alive_locked(group)
            return sorted(
                ({"id": m, "address": info["address"],
                  "attributes": dict(info["attributes"])}
                 for m, info in live.items()),
                key=lambda e: e["id"])

    def list_groups(self, prefix: str = "/") -> list[str]:
        prefix = prefix.rstrip("/") or "/"
        with self._lock:
            # Segment-aware: '/proxies' matches '/proxies/http' but not
            # '/proxiesold'.
            return sorted(
                g for g in self._groups
                if (prefix == "/" or g == prefix or
                    g.startswith(prefix + "/"))
                and self._alive_locked(g))


class DiscoveryService(Service):
    name = "discovery"

    def __init__(self, tracker: Optional[DiscoveryTracker] = None):
        self.tracker = tracker or DiscoveryTracker()

    @rpc_method()
    def heartbeat(self, body, attachments):
        self.tracker.heartbeat(
            _text(body["group"]), _text(body["member_id"]),
            address=_text(body.get("address") or ""),
            attributes=body.get("attributes") or {})
        return {"ttl": self.tracker.member_ttl}

    @rpc_method()
    def leave(self, body, attachments):
        self.tracker.leave(_text(body["group"]),
                           _text(body["member_id"]))
        return {}

    @rpc_method()
    def list_members(self, body, attachments):
        return {"members": self.tracker.list_members(
            _text(body["group"]))}

    @rpc_method()
    def list_groups(self, body, attachments):
        return {"groups": self.tracker.list_groups(
            _text(body.get("prefix") or "/"))}
