"""Clock quorum: HLC timestamps from an elected clock leader backed by
quorum-persisted ceilings.

Ref mapping:
  cluster clock quorum      → ClockServer (server/clock_server/
                              cluster_clock/ — a Hydra cell whose only
                              state is the timestamp ceiling)
  timestamp provider daemon → ClockService (server/timestamp_provider/)
  client batching           → QuorumTimestampProvider
                              (ytlib/transaction_client/ — concurrent
                              requests coalesce into one RPC)

The safety argument is the reference's: the leader NEVER hands out a
timestamp above the last quorum-persisted ceiling.  Ceilings advance in
coarse quanta (~1s of timestamp space), so persistence is amortized over
thousands of generations ("batched generation"), and a new leader after
failover starts strictly above the old leader's ceiling — monotonicity
survives any failover, including a clock-leader kill -9.

Election + fencing reuse the journal plane (cypress/election.py,
cypress/quorum.py): the clock WAL is just another quorum journal on the
data nodes, so a split-brain clock leader fail-stops on its first
ceiling append exactly like a split-brain master.

Own copy of the JAX package's `tablet/clock.py`.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.tablet.timestamp import COUNTER_BITS
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("clock")

CLOCK_JOURNAL = "clock_wal"
# Timestamp space claimed per persisted ceiling bump: one wall second's
# worth of counters — thousands of generations per quorum write.
CEILING_QUANTUM = 1 << COUNTER_BITS


class NotClockLeader(YtError):
    def __init__(self, address: str = ""):
        super().__init__(f"clock peer {address or 'here'} is not the "
                         "leader", code=EErrorCode.PeerUnavailable)


class ClockServer:
    """One clock-quorum peer: elects over the journal plane, serves
    monotone HLC timestamps under a persisted ceiling when leading."""

    def __init__(self, root: str, journal_channels: Sequence,
                 index: int = 0, lease_ttl: float = 3.0):
        from ytsaurus_tpu_torch.cypress.quorum import QuorumWal

        os.makedirs(root, exist_ok=True)
        self._channels = list(journal_channels)
        self._index = index
        self._lease_ttl = lease_ttl
        majority = len(self._channels) // 2 + 1
        # Remote-only quorum: a restarted clock peer recovers from the
        # SHARED locations (same argument as multi-master WAL).
        self.wal = QuorumWal(os.path.join(root, "clock.wal"),
                             CLOCK_JOURNAL, self._channels,
                             quorum=majority, lease_ttl=lease_ttl,
                             count_local_ack=False)
        self._lock = threading.Condition()
        self._last = 0                  # last handed-out timestamp
        self._ceiling = 0               # quorum-persisted upper bound
        self._bumping = False           # a ceiling append is in flight
        self._leading = False
        self._stopped = False
        self._elector = None
        self._thread: "Optional[threading.Thread]" = None

    def _new_elector(self):
        """Fresh elector per candidacy: LeaderElector.stop() latches its
        stop flag forever, so a peer that lost its lease needs a new one
        to ever campaign again (the master daemon does the same)."""
        from ytsaurus_tpu_torch.cypress.election import LeaderElector
        return LeaderElector(
            CLOCK_JOURNAL, self._channels,
            writer_id=self.wal.writer_id,
            lease_ttl=self._lease_ttl, hold_down=self._index * 1.0)

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "ClockServer":
        self._thread = threading.Thread(target=self._campaign,
                                        daemon=True, name="clock-elect")
        self._thread.start()
        return self

    def _all_locations_fresh(self) -> bool:
        """True iff a majority of journal locations answer and NONE has
        ever held this journal — the only state in which seeding an
        empty log is safe (a partitioned-but-initialized quorum must
        never be re-seeded)."""
        answered = 0
        for replica in self.wal.replicas:
            try:
                body, _ = replica.channel.call(
                    "data_node", "journal_read",
                    {"journal": CLOCK_JOURNAL})
            except YtError:
                continue
            answered += 1
            if body.get("initialized", True):
                return False
        return answered >= len(self.wal.replicas) // 2 + 1

    def _campaign(self) -> None:
        while not self._stopped:
            try:
                self._campaign_once()
            except Exception:   # noqa: BLE001 — candidacy must survive
                logger.exception("clock campaign iteration failed")
                import time as _time
                _time.sleep(0.5)

    def _campaign_once(self) -> None:
        elector = self._new_elector()
        self._elector = elector
        if not elector.wait_until_electable(timeout=60.0):
            return
        if self._stopped:
            return
        # Fence BEFORE reading: a deposed-but-alive leader could
        # otherwise persist one more ceiling between our recovery read
        # and our epoch acquisition, and we would start below
        # timestamps it already issued.  With the fence first, any such
        # late append is rejected by the quorum and the read sees every
        # ceiling that could ever have backed an issued timestamp.
        try:
            self.wal.acquire_epoch()
            records = self.wal.recover()
        except YtError:
            if not self._all_locations_fresh():
                return
            # First-ever leader of a fresh quorum: seed an empty log
            # (identical seeds from racing candidates are
            # indistinguishable; epoch fencing arbitrates appends).
            self.wal.bootstrap_from_local = True
            try:
                records = self.wal.recover()
            except YtError:
                return
            finally:
                self.wal.bootstrap_from_local = False
        ceiling = 0
        for record in records:
            ceiling = max(ceiling, int(record.get("ceiling", 0)))
        with self._lock:
            # Strictly above everything any previous leader COULD have
            # issued: its ceiling is the proof.
            self._last = ceiling
            self._ceiling = ceiling
            self._leading = True
        logger.info("clock leader (epoch %s, ceiling %s)",
                    self.wal.epoch, ceiling)
        lost = threading.Event()
        self._lost_event = lost

        def on_lease_lost():
            with self._lock:
                self._leading = False
                self._lock.notify_all()
            lost.set()

        elector.start_renewing(lambda: self.wal.epoch, on_lease_lost)
        lost.wait()
        elector.stop()
        # Re-enter candidacy with a fresh elector (a fenced leader's
        # appends fail-stop it out of generate() regardless).

    def stop(self) -> None:
        self._stopped = True
        with self._lock:
            self._leading = False
            self._lock.notify_all()
        if self._elector is not None:
            self._elector.stop()
        lost = getattr(self, "_lost_event", None)
        if lost is not None:
            lost.set()          # release a blocked campaign thread

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self._leading

    # -- generation ------------------------------------------------------------

    def generate_batch(self, count: int = 1) -> "tuple[int, int]":
        """(first, count) of a contiguous strictly-monotone timestamp
        range.  Persists a new ceiling (quorum append, epoch-fenced)
        only when the range would cross the current one — and the
        append happens OUTSIDE the serving lock, so a slow journal node
        stalls only the bumping thread, not every generation (nor
        clock_state probes)."""
        import time as _time
        if count < 1:
            raise YtError("count must be >= 1")
        while True:
            with self._lock:
                while self._bumping and self._leading:
                    self._lock.wait(0.5)
                if not self._leading:
                    raise NotClockLeader()
                wall = int(_time.time()) << COUNTER_BITS
                first = max(wall, self._last + 1)
                last = first + count - 1
                if last < self._ceiling:
                    self._last = last
                    return first, count
                self._bumping = True
                target = last + CEILING_QUANTUM
            try:
                # Epoch fencing makes this the linearization point: a
                # deposed leader's append is rejected by the quorum and
                # it steps down here.
                self.wal.append({"ceiling": target})
            except YtError:
                with self._lock:
                    self._leading = False
                    self._bumping = False
                    self._lock.notify_all()
                raise NotClockLeader()
            with self._lock:
                self._ceiling = max(self._ceiling, target)
                self._bumping = False
                self._lock.notify_all()
            # Loop back: serve under the freshly published ceiling.


from ytsaurus_tpu_torch.rpc.server import Service, rpc_method


class ClockService(Service):
    """RPC surface of one clock peer (ref timestamp_provider service)."""

    name = "clock"

    def __init__(self, server: ClockServer):
        self.server = server

    @rpc_method()
    def generate_timestamps(self, body, attachments):
        first, count = self.server.generate_batch(
            int(body.get("count", 1)))
        return {"first": first, "count": count}

    @rpc_method()
    def clock_state(self, body, attachments):
        return {"leader": self.server.is_leader}


class QuorumTimestampProvider:
    """TimestampProvider-shaped client over clock peers: leader-sticky
    with failover, and CONCURRENT generate() calls coalesce into one
    batched RPC (ref transaction_client's timestamp batcher)."""

    def __init__(self, addresses: Sequence[str], timeout: float = 10.0,
                 failover_deadline: float = 30.0):
        self.addresses = list(addresses)
        self.timeout = timeout
        self.failover_deadline = failover_deadline
        self._lock = threading.Lock()
        self._observed = 0
        self._leader: "Optional[str]" = None
        self._channels: dict = {}
        # Batcher state: one in-flight RPC; joiners queue a waiter and
        # the flight leader requests len(waiters) timestamps.
        self._flight = threading.Lock()
        self._waiters: list = []

    def _channel(self, address: str):
        from ytsaurus_tpu_torch.rpc import Channel
        if address not in self._channels:
            self._channels[address] = Channel(address,
                                              timeout=self.timeout)
        return self._channels[address]

    def close(self) -> None:
        for channel in self._channels.values():
            try:
                channel.close()
            except Exception:   # noqa: BLE001
                pass
        self._channels.clear()

    # -- TimestampProvider interface -------------------------------------------

    def generate(self) -> int:
        return self.generate_batch(1)[0]

    def generate_batch(self, count: int = 1) -> "list[int]":
        """count contiguous timestamps from the quorum leader.  Multiple
        threads arriving together share one RPC: whoever holds the
        flight lock drains the whole waiter queue (looping until empty),
        so every queued waiter is served by SOME flight holder."""
        import time as _time
        waiter: dict = {"count": count, "event": threading.Event(),
                        "first": None, "error": None}
        with self._lock:
            self._waiters.append(waiter)
        deadline = _time.monotonic() + self.failover_deadline * 2
        while not waiter["event"].is_set():
            if self._flight.acquire(blocking=False):
                try:
                    self._drain_flight()
                finally:
                    self._flight.release()
                # Queued before acquiring → drained by now (drain loops
                # until the queue is empty under the flight lock).
            elif not waiter["event"].wait(0.05) and \
                    _time.monotonic() > deadline:
                with self._lock:
                    if waiter in self._waiters:
                        self._waiters.remove(waiter)
                raise YtError("timestamp batch timed out",
                              code=EErrorCode.Timeout)
        if waiter["error"] is not None:
            raise waiter["error"]
        first = waiter["first"]
        return list(range(first, first + count))

    def _drain_flight(self) -> None:
        """Serve every queued waiter with ONE leader RPC (repeats until
        the queue is empty — late joiners ride the next iteration)."""
        while True:
            with self._lock:
                batch, self._waiters = self._waiters, []
            if not batch:
                return
            total = sum(w["count"] for w in batch)
            try:
                first = self._rpc_generate(total)
            except YtError as exc:
                for w in batch:
                    w["error"] = exc
                    w["event"].set()
                continue
            cursor = first
            for w in batch:
                w["first"] = cursor
                cursor += w["count"]
                w["event"].set()
            with self._lock:
                self._observed = max(self._observed, cursor - 1)

    def _rpc_generate(self, count: int) -> int:
        import time as _time
        deadline = _time.monotonic() + self.failover_deadline
        last_error: "Optional[YtError]" = None
        while _time.monotonic() < deadline:
            candidates = [self._leader] if self._leader else []
            candidates += [a for a in self.addresses
                           if a not in candidates]
            for address in candidates:
                try:
                    body, _ = self._channel(address).call(
                        "clock", "generate_timestamps",
                        {"count": count})
                    self._leader = address
                    return int(body["first"])
                except YtError as exc:
                    last_error = exc
                    if self._leader == address:
                        self._leader = None
                    # Dead channels must not be reused after failure.
                    ch = self._channels.pop(address, None)
                    if ch is not None:
                        try:
                            ch.close()
                        except Exception:   # noqa: BLE001
                            pass
            _time.sleep(0.3)
        raise last_error or YtError("no clock leader reachable",
                                    code=EErrorCode.PeerUnavailable)

    def last(self) -> int:
        with self._lock:
            return self._observed

    def observe(self, ts: int) -> None:
        """HLC observe: remote commits only advance the CLIENT-side
        floor; the quorum leader's ceiling already dominates all issued
        timestamps."""
        with self._lock:
            if ts > self._observed:
                self._observed = ts
