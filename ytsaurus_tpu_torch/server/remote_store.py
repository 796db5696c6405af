"""RpcChunkStore: the FsChunkStore surface over data-node RPC services.

Placement is rendezvous hashing of (chunk_id, node) over the alive-node
list — deterministic, so the primary and any client compute identical
replica sets without a directory lookup (the analog of the master's
chunk_placement.h rack-aware ranking, minus racks).  Reads walk nodes in
rank order and fall back to EVERY node before failing: a shrunken or
reordered alive-list must not lose reachable replicas.

Own copy of the JAX package's `server/remote_store.py`. As the port's
`FsChunkStore`, `read_chunk` takes the device to decode onto (the
cluster's, through `ChunkCache`), and `read_stats` decode-backfills on the
host, `backfill_sketch` included.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Optional

import torch

from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.chunks.encoding import (
    DEFAULT_CODEC,
    deserialize_chunk,
    read_chunk_meta,
    serialize_chunk,
)
from ytsaurus_tpu_torch.chunks.store import (
    _stats_missing_sketch,
    new_chunk_id,
)
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.rpc import Channel, RetryingChannel
from ytsaurus_tpu_torch.rpc.wire import wire_text as _text
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("chunk_client")


def placement_rank(chunk_id: str, nodes: list[str]) -> list[str]:
    """Deterministic replica ordering shared by all cluster participants."""
    def rank(node: str) -> bytes:
        return hashlib.blake2b((chunk_id + "@" + node).encode(),
                               digest_size=8).digest()
    return sorted(nodes, key=rank)


class RpcChunkStore:
    """Chunk store whose locations are data-node processes."""

    def __init__(self, nodes_provider: Callable[[], list[str]],
                 replication_factor: int = 2, codec: str = DEFAULT_CODEC,
                 timeout: float = 120.0, nodes_ttl: float = 3.0):
        self._nodes_provider = nodes_provider
        self.replication_factor = replication_factor
        self.codec = codec
        self.timeout = timeout
        # Short TTL cache: for remote clients nodes_provider is itself an
        # RPC; per-chunk refresh would double every read's round trips.
        self.nodes_ttl = nodes_ttl
        self._nodes_cache: tuple[float, list[str]] | None = None
        self._channels: dict[str, RetryingChannel] = {}
        # publish_table_chunks writes chunks from several threads.
        self._channels_lock = threading.Lock()

    def _channel(self, address: str) -> RetryingChannel:
        with self._channels_lock:
            ch = self._channels.get(address)
            if ch is None:
                ch = RetryingChannel(Channel(address, timeout=self.timeout),
                                     attempts=2, backoff=0.1)
                self._channels[address] = ch
            return ch

    def _nodes(self) -> list[str]:
        import time
        cached = self._nodes_cache
        if cached is not None and time.monotonic() - cached[0] < \
                self.nodes_ttl:
            return cached[1]
        nodes = self._nodes_provider()
        if not nodes:
            raise YtError("No alive data nodes",
                          code=EErrorCode.PeerUnavailable)
        self._nodes_cache = (time.monotonic(), nodes)
        return nodes

    # -- FsChunkStore surface --------------------------------------------------

    def write_chunk(self, chunk: ColumnarChunk,
                    chunk_id: Optional[str] = None,
                    codec: Optional[str] = None,
                    erasure: Optional[str] = None) -> str:
        chunk_id = chunk_id or new_chunk_id()
        blob = serialize_chunk(chunk, codec or self.codec, hunk_store=self)
        self.put_blob(chunk_id, blob, erasure=erasure)
        return chunk_id

    def put_blob(self, chunk_id: str, blob: bytes,
                 erasure: Optional[str] = None) -> str:
        nodes = placement_rank(chunk_id, self._nodes())
        targets = nodes[: self.replication_factor]
        body = {"chunk_id": chunk_id}
        if erasure is not None:
            body["erasure"] = erasure
        written = 0
        errors = []
        for address in targets:
            try:
                self._channel(address).call("data_node", "put_chunk", body,
                                            [blob])
                written += 1
            except YtError as err:
                errors.append(err)
        if written == 0:
            raise YtError(f"Failed to write chunk {chunk_id} to any of "
                          f"{targets}", code=EErrorCode.PeerUnavailable,
                          inner_errors=errors)
        if errors:
            logger.warning("chunk %s under-replicated: %d/%d writes ok",
                           chunk_id, written, len(targets))
        return chunk_id

    def get_blob(self, chunk_id: str) -> bytes:
        nodes = placement_rank(chunk_id, self._nodes())
        errors = []
        # Rank order first (fast path), then every remaining node: replicas
        # written under an older alive-list must stay reachable.
        for address in nodes:
            try:
                _, attachments = self._channel(address).call(
                    "data_node", "get_chunk", {"chunk_id": chunk_id})
                return attachments[0]
            except YtError as err:
                errors.append(err)
                continue
        raise YtError(f"No such chunk {chunk_id} on any node",
                      code=EErrorCode.NoSuchChunk, inner_errors=errors[:3])

    def read_chunk(self, chunk_id: str,
                   device: "str | torch.device" = DEFAULT_DEVICE
                   ) -> ColumnarChunk:
        return deserialize_chunk(self.get_blob(chunk_id), hunk_store=self,
                                 device=device)

    def read_meta(self, chunk_id: str) -> dict:
        return read_chunk_meta(self.get_blob(chunk_id))

    def read_stats(self, chunk_id: str,
                   backfill_sketch: bool = False) -> dict:
        """Seal-time column stats from the chunk meta header; pre-stats
        chunks (and pre-sketch ones, when `backfill_sketch` asks) backfill
        by decoding once on the host (one blob fetch either way)."""
        blob = self.get_blob(chunk_id)
        stats = read_chunk_meta(blob).get("column_stats")
        if stats is None or (backfill_sketch
                             and _stats_missing_sketch(stats)):
            from ytsaurus_tpu_torch.chunks.columnar import chunk_column_stats
            stats = chunk_column_stats(
                deserialize_chunk(blob, hunk_store=self, device="cpu"))
        return stats

    def exists(self, chunk_id: str) -> bool:
        for address in placement_rank(chunk_id, self._nodes()):
            try:
                body, _ = self._channel(address).call(
                    "data_node", "has_chunk", {"chunk_id": chunk_id})
                if body.get("exists"):
                    return True
            except YtError:
                continue
        return False

    def remove_chunk(self, chunk_id: str) -> None:
        for address in self._nodes():
            try:
                self._channel(address).call("data_node", "remove_chunk",
                                            {"chunk_id": chunk_id})
            except YtError:
                continue

    def list_chunks(self) -> list[str]:
        out: set[str] = set()
        for address in self._nodes():
            try:
                body, _ = self._channel(address).call(
                    "data_node", "list_chunks", {})
                out.update(_text(c) for c in body.get("chunk_ids", []))
            except YtError:
                continue
        return sorted(out)

    def close(self) -> None:
        with self._channels_lock:
            channels, self._channels = list(self._channels.values()), {}
        for ch in channels:
            ch.close()

