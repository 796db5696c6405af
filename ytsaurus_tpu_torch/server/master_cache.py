"""Master cache: a read-through caching proxy for master metadata reads.

Ref: the master_cache role (yt/yt/server/master_cache) — hot metadata
reads (get/exists/list) fan IN to a cache process so the master answers
each popular path once per TTL instead of once per client.  The cache
speaks the SAME driver wire surface as the primary's DriverService, so
any thin client points at it unchanged; mutations and uncacheable
commands forward verbatim.

Own copy of the JAX package's `server/master_cache.py`; host code
only, it opens no CUDA context.
"""

from __future__ import annotations

import threading
import time

from ytsaurus_tpu_torch import yson
from ytsaurus_tpu_torch.rpc import Channel, RetryingChannel, Service, rpc_method
from ytsaurus_tpu_torch.rpc.wire import wire_text as _text
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("master_cache")

# Pure reads over master metadata: safe to serve ttl-stale.
CACHEABLE_COMMANDS = frozenset({"get", "exists", "list"})


class MasterCacheService(Service):
    name = "driver"                 # same surface as DriverService

    def __init__(self, upstream_address: str, ttl: float = 2.0,
                 max_entries: int = 10_000, timeout: float = 60.0):
        self.upstream_address = upstream_address
        self.ttl = ttl
        self.max_entries = max_entries
        self._channel = RetryingChannel(
            Channel(upstream_address, timeout=timeout), attempts=3,
            backoff=0.2)
        self._cache: dict = {}      # key → (expiry, body, attachments)
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0, "forwarded": 0}

    def _key(self, command: str, user: str, parameters: dict) -> bytes:
        return yson.dumps({"c": command, "u": user, "p": parameters},
                          binary=True)

    @rpc_method()
    def ping(self, body, attachments):
        return {"ok": True, "cache": dict(self.stats)}

    # Transactions are primary-side state: every tx verb of the driver
    # surface forwards verbatim so a thin client pointed at the cache
    # keeps its full API (the docstring's contract).
    def _forward(self, method: str, body, attachments):
        # RPC methods dispatch concurrently (execute runs at
        # concurrency=16): the tally must ride the cache lock like the
        # hit/miss counters, or increments are lost under contention.
        with self._lock:
            self.stats["forwarded"] += 1
        return self._channel.call("driver", method, body, attachments,
                                  idempotent=False)

    @rpc_method()
    def start_transaction(self, body, attachments):
        return self._forward("start_transaction", body, attachments)

    @rpc_method()
    def commit_transaction(self, body, attachments):
        return self._forward("commit_transaction", body, attachments)

    @rpc_method()
    def abort_transaction(self, body, attachments):
        return self._forward("abort_transaction", body, attachments)

    @rpc_method()
    def insert_rows_tx(self, body, attachments):
        return self._forward("insert_rows_tx", body, attachments)

    @rpc_method()
    def delete_rows_tx(self, body, attachments):
        return self._forward("delete_rows_tx", body, attachments)

    @rpc_method(concurrency=16)
    def execute(self, body, attachments):
        command = _text(body["command"])
        parameters = body.get("parameters") or {}
        user = _text(body.get("user") or "root")
        if command not in CACHEABLE_COMMANDS or attachments:
            with self._lock:
                self.stats["forwarded"] += 1
            return self._channel.call(
                "driver", "execute", body, attachments,
                idempotent=not _is_mutating(command))
        key = self._key(command, user, parameters)
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None and hit[0] > now:
                self.stats["hits"] += 1
                return hit[1], list(hit[2])
        out_body, out_attachments = self._channel.call(
            "driver", "execute", body, ())
        with self._lock:
            self.stats["misses"] += 1
            if len(self._cache) >= self.max_entries:
                # Cheap pressure valve: drop expired entries, then the
                # oldest-expiring half if still over.
                self._cache = {k: v for k, v in self._cache.items()
                               if v[0] > now}
                if len(self._cache) >= self.max_entries:
                    by_expiry = sorted(self._cache.items(),
                                       key=lambda kv: kv[1][0])
                    self._cache = dict(by_expiry[len(by_expiry) // 2:])
            self._cache[key] = (now + self.ttl, out_body,
                                list(out_attachments))
        return out_body, list(out_attachments)


def _is_mutating(command: str) -> bool:
    from ytsaurus_tpu_torch.driver import COMMANDS
    descriptor = COMMANDS.get(command)
    return bool(descriptor and descriptor.is_mutating)


def run_master_cache(root: str, port: int, primary_address: str,
                     ttl: float = 2.0) -> None:
    """Daemon entry (--role master_cache)."""
    import os

    from ytsaurus_tpu_torch.rpc import RpcServer
    os.makedirs(root, exist_ok=True)
    service = MasterCacheService(primary_address, ttl=ttl)
    server = RpcServer([service], port=port)
    server.start()
    path = os.path.join(root, "master_cache.port")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(server.port))
    os.replace(tmp, path)
    print(f"master cache serving on {server.address} -> "
          f"{primary_address} (ttl {ttl}s)", flush=True)
    threading.Event().wait()
