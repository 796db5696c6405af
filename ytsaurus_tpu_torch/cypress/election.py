"""Lease-based leader election for the metadata master.

Ref: Hydra's election + lease tracking (yt/yt/server/lib/election/,
yt/yt/server/lib/hydra/lease_tracker.h): peers vote, the leader holds a
lease it renews continuously, followers take over when the lease lapses.

Design delta for this build: there is no separate election cell — the
JOURNAL locations (data nodes holding the quorum WAL) double as the vote
and lease plane, because they already arbitrate write ownership through
epoch fencing.  Leadership means holding an unexpired lease on a STRICT
MAJORITY of journal locations:

  - acquisition piggybacks on epoch acquisition (journal_acquire grants
    the lease together with the epoch vote, so a freshly elected leader
    is lease-covered before it serves a single write);
  - the leader renews on every location each ttl/3; losing a majority of
    renewals for a full ttl means leadership is lost (step down);
  - candidates poll lease state and attempt takeover only when a
    majority of locations answer AND none reports an unexpired lease
    held by someone else — plus a per-candidate hold-down so two
    standbys don't duel at the same instant.

Safety does NOT rest on the lease schedule: even if two candidates race,
epoch fencing in the quorum WAL guarantees at most one of them can reach
append quorum — the loser fail-stops on its first write.  The lease only
provides liveness and disruption-freedom (a healthy leader is not fenced
by a flapping standby, because journal_acquire refuses grants while an
unexpired foreign lease stands).

Own copy of the JAX package's `cypress/election.py`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("election")


class LeaderElector:
    def __init__(self, journal_name: str, channels,
                 writer_id: str, lease_ttl: float = 6.0,
                 poll_interval: float = 0.5,
                 hold_down: float = 0.0):
        """channels: a list of journal-node channels, or a CALLABLE
        returning the current list — membership can grow after recovery
        (QuorumWal.extend), and both renewal and the majority threshold
        must follow it or the lease cover shrinks to a stale subset."""
        self.journal_name = journal_name
        self._channels_src = channels
        self.writer_id = writer_id
        self.lease_ttl = lease_ttl
        self.poll_interval = poll_interval
        # Deterministic stagger (e.g. master index * 1.5s): the first
        # candidate usually wins before the second even tries.
        self.hold_down = hold_down
        self._stop = threading.Event()
        self._renew_thread: Optional[threading.Thread] = None

    def _channels(self) -> list:
        if callable(self._channels_src):
            return list(self._channels_src())
        return list(self._channels_src)

    def _majority(self, channels) -> int:
        return len(channels) // 2 + 1

    # -- candidate side --------------------------------------------------------

    def _lease_states(self, channels) -> list[dict]:
        states = []
        for channel in channels:
            try:
                body, _ = channel.call(
                    "data_node", "journal_lease",
                    {"journal": self.journal_name})
                states.append(body)
            except YtError:
                continue
        return states

    def wait_until_electable(self, timeout: Optional[float] = None) -> bool:
        """Block until a takeover attempt is warranted: a majority of
        journal locations answer and none holds an unexpired foreign
        lease.  Returns False on stop/timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        held_down_until = time.monotonic() + self.hold_down
        while not self._stop.is_set():
            if deadline is not None and time.monotonic() > deadline:
                return False
            channels = self._channels()
            states = self._lease_states(channels)
            foreign = [s for s in states
                       if float(s.get("remaining", 0)) > 0
                       and _text(s.get("writer")) != self.writer_id]
            if foreign:
                # A live leader exists; check again when its lease could
                # have lapsed.
                self._stop.wait(min(
                    max(float(s.get("remaining", 0)) for s in foreign),
                    self.lease_ttl))
                held_down_until = time.monotonic() + self.hold_down
                continue
            if len(states) < self._majority(channels):
                self._stop.wait(self.poll_interval)
                continue
            if time.monotonic() < held_down_until:
                self._stop.wait(self.poll_interval)
                continue
            return True
        return False

    # -- leader side -----------------------------------------------------------

    def start_renewing(self, epoch,
                       on_lost: Callable[[], None]) -> None:
        """Renew the lease on every journal location each ttl/3; if a
        strict majority has not confirmed a renewal for a full ttl,
        leadership is lost and `on_lost` fires (once).

        `epoch` may be a callable returning the CURRENT epoch: the WAL
        re-acquires a higher epoch when it recovers from an orphaned
        fence, and renewals carrying the stale number would be denied
        everywhere, self-terminating a healthy leader."""
        epoch_fn = epoch if callable(epoch) else (lambda: epoch)

        def loop():
            last_majority = time.monotonic()
            while not self._stop.is_set():
                channels = self._channels()
                acks = 0
                for channel in channels:
                    try:
                        body, _ = channel.call(
                            "data_node", "journal_lease_renew",
                            {"journal": self.journal_name,
                             "epoch": epoch_fn(),
                             "writer": self.writer_id,
                             "ttl": self.lease_ttl}, idempotent=False)
                        if body.get("granted"):
                            acks += 1
                    except YtError:
                        continue
                now = time.monotonic()
                if acks >= self._majority(channels):
                    last_majority = now
                elif now - last_majority > self.lease_ttl:
                    logger.warning(
                        "leader lease lost (no majority for %.1fs)",
                        now - last_majority)
                    on_lost()
                    return
                self._stop.wait(self.lease_ttl / 3.0)

        self._renew_thread = threading.Thread(target=loop, daemon=True,
                                              name="lease-renew")
        self._renew_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._renew_thread is not None:
            self._renew_thread.join(timeout=5)


def _text(value) -> str:
    if isinstance(value, bytes):
        return value.decode()
    return value or ""
