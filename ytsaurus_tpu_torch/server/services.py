"""RPC services hosted by the cluster.

DriverService — the full driver command registry over RPC, plus tx-id-based
                transactions (the proxy pattern: the client stays thin).

Own copy of the JAX package's `server/services.py`, of its DriverService
only. The data node's DataNodeService, the primary's MasterService and the
node tracker (NodeTracker, NodeTrackerService) serve the daemons of a
multi-process cluster, which the port has not yet: they wait for the
quorum, multicell and daemon slices.
"""

from __future__ import annotations

import threading
import time

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.rpc import Service, rpc_method
from ytsaurus_tpu_torch.rpc.wire import wire_text as _text
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("server")


class DriverService(Service):
    """The proxy: executes driver commands against the server-side client.

    Transactions are tx-id based across the wire (the client cannot hold a
    live TabletTransaction object); the registry maps ids to live tx state,
    like the reference's transaction leases on the proxy."""

    name = "driver"

    TX_LEASE_SECONDS = 300.0

    def __init__(self, client):
        from ytsaurus_tpu_torch.driver import Driver
        self.client = client
        self.driver = Driver(client)
        self._transactions: dict[str, tuple[object, float]] = {}
        self._tx_lock = threading.Lock()

    def _sweep_expired_locked(self) -> None:
        """Abort transactions whose lease lapsed (crashed clients must not
        hold 2PC row locks forever — the proxy transaction-lease analog)."""
        now = time.monotonic()
        for tx_id in [i for i, (_, t) in self._transactions.items()
                      if now - t > self.TX_LEASE_SECONDS]:
            tx, _ = self._transactions.pop(tx_id)
            try:
                self.client.abort_transaction(tx)
                logger.warning("aborted expired transaction %s", tx_id)
            except Exception:      # noqa: BLE001 — sweep must not fail ops
                pass

    @rpc_method()
    def ping(self, body, attachments):
        return {"ok": True}

    @rpc_method(concurrency=8)
    def execute(self, body, attachments):
        from ytsaurus_tpu_torch.cypress.security import authenticated_user
        command = _text(body["command"])
        parameters = body.get("parameters") or {}
        if attachments:
            # Bulk row payloads (formatted write_table bodies) ride as
            # attachments, not YSON parameters.
            parameters = dict(parameters)
            parameters["rows"] = attachments[0]
        # Per-request principal (ref: TAuthenticatedUserGuard around every
        # driver invocation).
        user = _text(body.get("user") or "root")
        with authenticated_user(user):
            result = self.driver.execute(command, parameters)
        if isinstance(result, bytes):
            return {"kind": "blob"}, [result]
        return {"kind": "value", "result": result}

    # -- transactions over the wire -------------------------------------------

    def _tx(self, tx_id: str):
        with self._tx_lock:
            self._sweep_expired_locked()
            entry = self._transactions.get(tx_id)
            if entry is not None:
                # Touch the lease on every use.
                self._transactions[tx_id] = (entry[0], time.monotonic())
        if entry is None:
            raise YtError(f"No such transaction {tx_id}",
                          code=EErrorCode.NoSuchTransaction)
        return entry[0]

    @rpc_method()
    def start_transaction(self, body, attachments):
        tx = self.client.start_transaction()
        with self._tx_lock:
            self._sweep_expired_locked()
            self._transactions[tx.id] = (tx, time.monotonic())
        return {"tx_id": tx.id, "start_timestamp": tx.start_timestamp}

    @rpc_method()
    def commit_transaction(self, body, attachments):
        tx_id = _text(body["tx_id"])
        tx = self._tx(tx_id)
        try:
            ts = self.client.commit_transaction(tx)
        finally:
            with self._tx_lock:
                self._transactions.pop(tx_id, None)
        return {"commit_timestamp": ts}

    @rpc_method()
    def abort_transaction(self, body, attachments):
        tx_id = _text(body["tx_id"])
        tx = self._tx(tx_id)
        try:
            self.client.abort_transaction(tx)
        finally:
            with self._tx_lock:
                self._transactions.pop(tx_id, None)
        return {}

    @rpc_method()
    def insert_rows_tx(self, body, attachments):
        tx = self._tx(_text(body["tx_id"]))
        self.client.insert_rows(_text(body["path"]), body["rows"], tx=tx,
                                update=bool(body.get("update", False)))
        return {}

    @rpc_method()
    def delete_rows_tx(self, body, attachments):
        tx = self._tx(_text(body["tx_id"]))
        keys = [tuple(k) for k in body["keys"]]
        self.client.delete_rows(_text(body["path"]), keys, tx=tx)
        return {}
