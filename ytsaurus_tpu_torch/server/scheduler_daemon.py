"""Scheduler / controller-agent daemon: operation control OUT of the
master process.

Ref: the reference runs schedulers (server/scheduler/) and controller
agents (server/controller_agent/) as processes separate from masters —
an operation storm must not contend with the metadata quorum's mutation
path, and controller crashes must not take masters down.  This daemon
realizes that split: it owns an OperationScheduler over a REMOTE thin
client, so every byte of operation state it needs to survive lives in
Cypress (//sys/operations documents + @snapshot chunks), and a freshly
restarted daemon revives its predecessor's orphaned operations from
there (ref revival from snapshots, master connector re-registration).

Only deterministic specs travel the wire (shell commands; Python
callables cannot cross a process boundary) — the same restriction
revival already imposes.

Own copy of the JAX package's `server/scheduler_daemon.py`. The daemon
names a device (`--device`, default cuda): its thin client decodes chunks
and its operation controllers sort there.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.rpc import Channel, RetryingChannel, RpcServer
from ytsaurus_tpu_torch.rpc.server import Service, rpc_method
from ytsaurus_tpu_torch.rpc.wire import wire_text as _text
from ytsaurus_tpu_torch.utils.logging import get_logger

logger = get_logger("scheduler_daemon")


class OperationService(Service):
    """RPC surface of the operation daemon (ref scheduler's
    StartOperation/GetOperation/AbortOperation API)."""

    name = "operations"

    def __init__(self, scheduler):
        self.scheduler = scheduler

    @rpc_method()
    def start_operation(self, body, attachments):
        op_type = _text(body["type"])
        spec = dict(body.get("spec") or {})
        # Async by contract: controllers run minutes; the RPC returns
        # the id and callers poll (ref StartOperation semantics).
        op = self.scheduler.start_operation(op_type, spec, sync=False)
        return {"op_id": op.id}

    @rpc_method()
    def get_operation(self, body, attachments):
        op = self.scheduler.get_operation(_text(body["op_id"]))
        return {"id": op.id, "type": op.type, "state": op.state,
                "error": op.error, "result": op.result,
                "progress": op.progress}

    @rpc_method()
    def abort_operation(self, body, attachments):
        op = self.scheduler.abort_operation(_text(body["op_id"]))
        return {"id": op.id, "state": op.state}

    @rpc_method()
    def list_operations(self, body, attachments):
        return {"operations": [
            {"id": op.id, "type": op.type, "state": op.state}
            for op in self.scheduler.list_operations()]}


def run_scheduler(root: str, port: int, primary: str,
                  slots: int = 4, device: str = "cuda") -> None:
    """Daemon entry: thin client to the masters on `device`, scheduler
    on top, RPC in front, revival of orphaned operations behind."""
    import os

    from ytsaurus_tpu_torch.operations.scheduler import OperationScheduler
    from ytsaurus_tpu_torch.remote_client import RemoteYtClient
    from ytsaurus_tpu_torch.server.daemon import _write_port_file

    os.makedirs(root, exist_ok=True)
    client = RemoteYtClient(primary, device=device)
    scheduler = OperationScheduler(client, slots=slots)
    server = RpcServer([OperationService(scheduler)], port=port)
    server.start()
    _write_port_file(root, "scheduler", server.port)
    print(f"scheduler daemon serving on {server.address} -> {primary} "
          f"(device {client.device})", flush=True)

    def revive():
        # A predecessor's operations sit 'running' in Cypress with
        # per-stripe snapshots; re-run them (completed stripes skip).
        try:
            revived = scheduler.revive_operations()
            if revived:
                print(f"revived {len(revived)} orphaned operations",
                      flush=True)
        except YtError as exc:
            logger.warning("revival failed: %s", exc)

    threading.Thread(target=revive, daemon=True,
                     name="operation-revival").start()
    threading.Event().wait()


class SchedulerClient:
    """Thin client for the operation daemon: submit + poll.  Mirrors
    the YtClient run_* surface for command-based (wire-safe) specs."""

    def __init__(self, address: str, timeout: float = 60.0):
        self._channel = RetryingChannel(Channel(address, timeout=timeout))

    def close(self) -> None:
        self._channel.close()

    def start_operation(self, op_type: str, spec: dict) -> str:
        body, _ = self._channel.call(
            "operations", "start_operation",
            {"type": op_type, "spec": spec}, idempotent=False)
        return _text(body["op_id"])

    def get_operation(self, op_id: str) -> dict:
        body, _ = self._channel.call("operations", "get_operation",
                                     {"op_id": op_id})
        return {"id": _text(body["id"]), "type": _text(body["type"]),
                "state": _text(body["state"]),
                "error": body.get("error"),
                "result": body.get("result") or {},
                "progress": body.get("progress") or {}}

    def abort_operation(self, op_id: str) -> dict:
        body, _ = self._channel.call("operations", "abort_operation",
                                     {"op_id": op_id}, idempotent=False)
        return {"id": _text(body["id"]), "state": _text(body["state"])}

    def list_operations(self) -> "list[dict]":
        body, _ = self._channel.call("operations", "list_operations", {})
        return [{"id": _text(o["id"]), "type": _text(o["type"]),
                 "state": _text(o["state"])}
                for o in body.get("operations") or []]

    def wait_operation(self, op_id: str, timeout: float = 300.0,
                       poll: float = 0.2) -> dict:
        """Poll to a terminal state; raises the operation's error on
        failure (ref wait_for_operation)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                op = self.get_operation(op_id)
            except YtError as exc:
                if exc.code in (EErrorCode.TransportError,
                                EErrorCode.PeerUnavailable,
                                EErrorCode.RpcTimeout,
                                EErrorCode.NoSuchOperation):
                    # Daemon mid-restart: the operation revives from its
                    # Cypress record shortly; keep polling.  (An id that
                    # never existed times out instead of erroring — the
                    # price of restart transparency.)
                    time.sleep(poll)
                    continue
                raise
            if op["state"] == "completed":
                return op
            if op["state"] in ("failed", "aborted"):
                if op.get("error"):
                    raise YtError.from_dict(op["error"])
                raise YtError(f"operation {op_id} {op['state']}",
                              code=EErrorCode.OperationFailed)
            time.sleep(poll)
        raise YtError(f"operation {op_id} did not finish in {timeout}s",
                      code=EErrorCode.Timeout)

    # -- convenience run_* (command specs only) --------------------------------

    def run_sort(self, input_path: str, output_path: str,
                 sort_by: "Sequence[str] | str", **kw) -> str:
        return self.start_operation("sort", {
            "input_table_path": input_path,
            "output_table_path": output_path,
            "sort_by": [sort_by] if isinstance(sort_by, str)
            else list(sort_by), "raise_on_failure": False, **kw})

    def run_map(self, command: str, input_path: str, output_path: str,
                **kw) -> str:
        return self.start_operation("map", {
            "command": command, "input_table_path": input_path,
            "output_table_path": output_path,
            "raise_on_failure": False, **kw})

    def run_reduce(self, command: str, input_path: str, output_path: str,
                   reduce_by, **kw) -> str:
        return self.start_operation("reduce", {
            "command": command, "input_table_path": input_path,
            "output_table_path": output_path, "reduce_by": reduce_by,
            "raise_on_failure": False, **kw})

    def run_map_reduce(self, map_command: "Optional[str]",
                       reduce_command: str, input_path: str,
                       output_path: str, reduce_by, **kw) -> str:
        spec = {"reduce_command": reduce_command,
                "input_table_path": input_path,
                "output_table_path": output_path, "reduce_by": reduce_by,
                "raise_on_failure": False, **kw}
        if map_command:
            spec["map_command"] = map_command
        return self.start_operation("map_reduce", spec)
