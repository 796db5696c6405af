"""ChunkReplicator: master-side background re-replication and repair.

Ref: yt/yt/server/master/chunk_server/chunk_replicator.h — the master
continuously compares each chunk's replica set to its target replication
factor and schedules Replicate/Repair jobs on data nodes (job types:
yt/yt/client/job_tracker_client/public.h:31-59).  Before this module a
dead node's chunks stayed under-replicated until the next read happened
to walk past the hole (repair-on-read only).

Redesign: replica placement is rendezvous-hashed over the
alive-node list (server/remote_store.py::placement_rank), so the
replicator derives each chunk's DESIRED holders deterministically and
only has to learn the ACTUAL holders — one id-only list_chunks poll per
node per scan, no chunk directory.  Data never flows through the master:
a repair "job" is one replicate_chunk RPC to a surviving holder, which
pushes the blob straight to the missing target node (erasure chunks are
reconstructed by the holder's read path if its own parts are damaged and
re-encoded on the target).

Own copy of the JAX package's `server/chunk_replicator.py`; it moves
chunk bytes between nodes and decodes nothing.
"""

from __future__ import annotations

import threading
from typing import Callable

from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.rpc import Channel, RetryingChannel
from ytsaurus_tpu_torch.server.remote_store import placement_rank
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("chunk_replicator")

# Consecutive list_chunks failures after which a heartbeat-alive node is
# treated as storage-dead (scans proceed without it instead of waiting
# for membership to settle).
LISTING_FAILURE_THRESHOLD = 3
# Hard bound on consecutive skipped scans: a node that FLAPS (fails,
# then answers, resetting its failure count) must not defer repair of
# chunks lost elsewhere indefinitely — after this many skips the scan
# proceeds with whatever answered.
MAX_CONSECUTIVE_SKIPS = 5


class ChunkReplicator:
    """Periodic scan → replicate under-replicated chunks toward their
    rendezvous targets."""

    def __init__(self, nodes_provider: Callable[[], list[str]],
                 replication_factor: int = 2, interval: float = 3.0,
                 timeout: float = 60.0,
                 liveness_provider: "Callable[[], set] | None" = None):
        self._nodes_provider = nodes_provider
        # Rooted-chunk-id provider (YtClient.referenced_chunk_ids): a
        # DELETED chunk whose removal missed a down node must not be
        # resurrected to full RF when that node rejoins — only live
        # chunks are worth replicating.  Hunk chunks are exempt (their
        # liveness needs per-chunk meta reads; a stale hunk copy is a
        # bounded leak until the next GC sweep, which lists and removes
        # it from every then-alive node).
        self._liveness_provider = liveness_provider
        self.replication_factor = replication_factor
        self.interval = interval
        self.timeout = timeout
        self._channels: dict[str, RetryingChannel] = {}
        self._listing_failures: dict[str, int] = {}
        self._consecutive_skips = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats = {"scans": 0, "scans_skipped": 0,
                      "replications_requested": 0,
                      "replications_failed": 0, "chunks_seen": 0,
                      "under_replicated": 0}

    def _channel(self, address: str) -> RetryingChannel:
        ch = self._channels.get(address)
        if ch is None:
            ch = RetryingChannel(Channel(address, timeout=self.timeout),
                                 attempts=2, backoff=0.1)
            self._channels[address] = ch
        return ch

    def scan_once(self) -> int:
        """One full pass; returns the number of replication requests
        issued.  Exposed for tests and for an on-demand Orchid poke."""
        self.stats["scans"] += 1
        alive = sorted(self._nodes_provider())
        # Failure history is only meaningful for CURRENT members: a node
        # that left and rejoined must not inherit stale counts (one
        # hiccup would then read as 3 "consecutive" failures).
        for address in list(self._listing_failures):
            if address not in alive:
                del self._listing_failures[address]
        if len(alive) < 2:
            return 0
        holders: dict[str, set[str]] = {}
        reachable: list[str] = []
        for address in alive:
            try:
                body, _ = self._channel(address).call(
                    "data_node", "list_chunks", {})
                reachable.append(address)
                self._listing_failures.pop(address, None)
                for cid in body.get("chunk_ids", []):
                    cid = cid.decode() if isinstance(cid, bytes) else cid
                    holders.setdefault(cid, set()).add(address)
            except YtError:
                self._listing_failures[address] = \
                    self._listing_failures.get(address, 0) + 1
        # A heartbeat-ALIVE node that failed a listing is either having a
        # TRANSIENT hiccup (GC pause, overload) — re-computing rendezvous
        # targets without it would mass-copy chunks off-rank, so skip the
        # scan and let membership settle — or it is PERSISTENTLY broken
        # (dead disk behind a live heartbeat), in which case after
        # LISTING_FAILURE_THRESHOLD consecutive failures its chunks ARE
        # effectively lost and re-replicating around it is the point.
        settling = [a for a in alive if a not in reachable and
                    self._listing_failures.get(a, 0) <
                    LISTING_FAILURE_THRESHOLD]
        if settling and self._consecutive_skips < MAX_CONSECUTIVE_SKIPS:
            self._consecutive_skips += 1
            self.stats["scans_skipped"] += 1
            return 0
        self._consecutive_skips = 0
        self.stats["chunks_seen"] = len(holders)
        live: "set | None" = None
        if self._liveness_provider is not None:
            try:
                live = set(self._liveness_provider())
            except Exception:   # noqa: BLE001 — advisory; skip filtering
                live = None
        issued = 0
        under = 0
        from ytsaurus_tpu_torch.chunks.hunks import is_hunk_id
        for chunk_id, holding in holders.items():
            if live is not None and chunk_id not in live and \
                    not is_hunk_id(chunk_id):
                continue            # unrooted: GC's business, not ours
            # Desired holders under the CURRENT alive list; a chunk whose
            # rendezvous targets all hold it is healthy even if an old
            # (now off-rank) replica also survives.
            targets = placement_rank(chunk_id, reachable)[
                : self.replication_factor]
            missing = [t for t in targets if t not in holding]
            if not missing:
                continue
            under += 1
            # The job runs ON a surviving holder (rank order for
            # determinism): master-free data path.
            source = next((a for a in placement_rank(chunk_id, sorted(
                holding)) if a in holding), None)
            if source is None:
                continue
            for target in missing:
                try:
                    self._channel(source).call(
                        "data_node", "replicate_chunk",
                        {"chunk_id": chunk_id, "target": target})
                    issued += 1
                except YtError as err:
                    self.stats["replications_failed"] += 1
                    logger.warning("replicate %s %s->%s failed: %s",
                                   chunk_id, source, target, err)
        self.stats["under_replicated"] = under
        self.stats["replications_requested"] += issued
        if issued:
            logger.info("chunk replicator: %d replications issued "
                        "(%d under-replicated of %d chunks)",
                        issued, under, len(holders))
        return issued

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.scan_once()
            except Exception as exc:    # noqa: BLE001 — keep scanning
                logger.warning("chunk replicator scan failed: %s", exc)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="chunk-replicator")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
