"""P2P hot-chunk distribution on data nodes.

Ref: server/node/data_node/p2p.h:227 (TP2PDistributor) — a data node
holding a chunk that suddenly gets hammered (a hot dictionary table,
a fan-in join side) temporarily seeds copies onto peer nodes, so read
load spreads instead of saturating the RF holders.

Redesign for this runtime: the unit is the whole chunk (our reads are
chunk-granular decodes, not block fetches).  Each node counts reads per
chunk over a sliding window; past the hot threshold it pushes the chunk
to `fanout` peers that do not already hold it (the same node-to-node
path the replicator's repair jobs use), records what it seeded, and
evicts its seeds after a cool-down with no continued heat.  Seeded
copies are ordinary store chunks: the client's fallback/hedged read
paths find them with no protocol change, and if an eviction ever races
a replicator placement the next replicator scan restores RF — the
healing loop bounds the damage.

Own copy of the JAX package's `server/p2p.py`; it moves blobs and
decodes nothing.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

from ytsaurus_tpu_torch.errors import YtError
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("p2p")


class P2PDistributor:
    def __init__(self, store, self_address_provider: Callable[[], str],
                 peers_provider: Callable[[], "Sequence[str]"],
                 hot_threshold: int = 20, window: float = 5.0,
                 fanout: int = 2, cooldown: float = 60.0,
                 tick: float = 1.0):
        self.store = store
        self._self_address = self_address_provider
        self._peers = peers_provider
        self.hot_threshold = hot_threshold
        self.window = window
        self.fanout = fanout
        self.cooldown = cooldown
        self.tick = tick
        self.stats = {"hot_chunks": 0, "seeded_copies": 0,
                      "evicted_copies": 0}
        self._lock = threading.Lock()
        self._counts: "dict[str, int]" = {}
        self._window_start = time.monotonic()
        # chunk_id → {"targets": [addr...], "expiry": t} for seeds WE
        # pushed (pre-existing holders are never evicted by us).
        self._seeded: "dict[str, dict]" = {}
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    # -- read accounting (called from the get_chunk RPC) -----------------------

    def _expire_window_locked(self) -> None:
        now = time.monotonic()
        if now - self._window_start > self.window:
            self._counts.clear()
            self._window_start = now

    def record_read(self, chunk_id: str) -> None:
        with self._lock:
            self._expire_window_locked()
            self._counts[chunk_id] = self._counts.get(chunk_id, 0) + 1

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "P2PDistributor":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="p2p-distributor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.tick):
            try:
                self.tick_once()
            except Exception:   # noqa: BLE001 — distribution is advisory
                logger.exception("p2p tick failed")

    # -- distribution ----------------------------------------------------------

    def _call(self, address: str, method: str, body: dict,
              attachments=()):
        from ytsaurus_tpu_torch.rpc import Channel
        channel = Channel(address, timeout=15)
        try:
            out, _ = channel.call("data_node", method, body,
                                  attachments=attachments)
            return out
        finally:
            channel.close()

    def tick_once(self) -> None:
        with self._lock:
            # The tick expires the window too: if reads stop entirely,
            # record_read never runs again and stale counts would keep
            # "reheating" the seeds forever.
            self._expire_window_locked()
            hot = [cid for cid, n in self._counts.items()
                   if n >= self.hot_threshold
                   and cid not in self._seeded]
            reheated = {cid for cid, n in self._counts.items()
                        if n >= self.hot_threshold}
            now = time.monotonic()
            expired = [cid for cid, entry in self._seeded.items()
                       if now >= entry["expiry"] and cid not in reheated]
            # Continued heat extends the seeds' lease.
            for cid in reheated:
                if cid in self._seeded:
                    self._seeded[cid]["expiry"] = now + self.cooldown
        peers = None
        if hot:
            # ONE peer-discovery RPC per tick, shared by every hot
            # chunk (not one per chunk per tick).
            me = self._self_address()
            peers = [p for p in self._peers() if p and p != me]
        for cid in hot:
            self._seed(cid, peers)
        for cid in expired:
            self._evict(cid)

    def _seed(self, chunk_id: str, peers: "Sequence[str]") -> None:
        from ytsaurus_tpu_torch.server.services import chunk_push_request
        if not self.store.exists(chunk_id):
            return
        targets = []
        body = None
        blob = None
        failures = 0
        for peer in peers:
            if len(targets) >= self.fanout:
                break
            try:
                if self._call(peer, "has_chunk",
                              {"chunk_id": chunk_id}).get("exists"):
                    continue        # a real holder: never ours to evict
                if blob is None:
                    # One read (erasure chunks RECONSTRUCT on read)
                    # serves every fanout target.
                    body, blob = chunk_push_request(self.store, chunk_id)
                self._call(peer, "put_chunk", body, attachments=[blob])
                targets.append(peer)
            except YtError as exc:
                failures += 1
                logger.warning("p2p seed of %s to %s failed: %s",
                               chunk_id, peer, exc)
        if not targets and failures:
            # Every attempt errored (blip, peer restart): do NOT record
            # — the next tick must retry while the chunk stays hot.
            return
        # An empty-but-clean result IS recorded: every eligible peer
        # already holds the chunk, and re-probing the whole fan-out on
        # every tick while the heat lasts would be pure RPC churn.
        with self._lock:
            self._seeded[chunk_id] = {
                "targets": targets,
                "expiry": time.monotonic() + self.cooldown}
        if targets:
            self.stats["hot_chunks"] += 1
            self.stats["seeded_copies"] += len(targets)
            logger.info("p2p: seeded hot chunk %s to %s", chunk_id,
                        targets)

    def _evict(self, chunk_id: str) -> None:
        with self._lock:
            entry = self._seeded.get(chunk_id)
        if entry is None:
            return
        remaining = []
        for peer in entry["targets"]:
            try:
                self._call(peer, "remove_chunk", {"chunk_id": chunk_id})
                self.stats["evicted_copies"] += 1
            except YtError:
                # Transient failure must NOT leak the copy forever:
                # keep the target and retry on a later tick.
                remaining.append(peer)
        with self._lock:
            attempts = entry.get("evict_attempts", 0) + 1
            if remaining and attempts < 5:
                entry["targets"] = remaining
                entry["evict_attempts"] = attempts
                entry["expiry"] = time.monotonic() + \
                    min(self.cooldown, 10.0)
            else:
                # All removed, or the peer is presumed dead (its disk
                # went with it — nothing left to evict).
                self._seeded.pop(chunk_id, None)
