"""RemoteYtClient: the IClient facade over a multi-process cluster.

The thin-client/proxy split (ref rpc_proxy client,
client/api/rpc_proxy/client_impl.h): metadata and tablet commands go to
the primary's DriverService; bulk chunk data moves directly between this
process and the data nodes (RpcChunkStore with the shared rendezvous
placement) — the control/data-plane split of the reference's native
client.  Operations (sort/map/merge/erase) run a local controller against
this client, reading and writing chunks over the node RPC data plane.

Own copy of the JAX package's `remote_client.py`. The client names a
device (`connect_remote(address, device="cuda")`): its RpcChunkStore
decodes chunks onto it, and its local OperationScheduler runs the sort,
merge, map, reduce and erase controllers there, so a remote `run_sort`
runs the port's radix kernels in the client's process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch

from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.rpc import Channel, RetryingChannel
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.server.remote_store import RpcChunkStore
from ytsaurus_tpu_torch.tablet.timestamp import MAX_TIMESTAMP


@dataclass
class RemoteTransaction:
    id: str
    start_timestamp: int


class RemoteYtClient:
    def __init__(self, primary_address: "str | Sequence[str]",
                 timeout: float = 120.0, user: str = "root",
                 device: "str | torch.device" = DEFAULT_DEVICE):
        """primary_address: one address, or several (list or
        comma-separated) under multi-master election — the client then
        sticks to whichever master serves and rides out failovers by
        rotating (rpc.FailoverChannel). `device`: where chunks decode and
        the local operation controllers run."""
        self.device = resolve_device(device)
        if isinstance(primary_address, str):
            addresses = [a.strip() for a in primary_address.split(",")
                         if a.strip()]
        else:
            addresses = list(primary_address)
        self.primary_address = ",".join(addresses)
        self.timeout = timeout
        self.user = user
        if len(addresses) > 1:
            from ytsaurus_tpu_torch.rpc import FailoverChannel
            self._channel = FailoverChannel(addresses, timeout=timeout)
        else:
            self._channel = RetryingChannel(
                Channel(addresses[0], timeout=timeout))
        self.chunk_store = RpcChunkStore(self._alive_nodes)
        from ytsaurus_tpu_torch.operations.scheduler import OperationScheduler
        from ytsaurus_tpu_torch.query.statistics import QueryStatistics
        self.scheduler = OperationScheduler(self)
        self.last_query_statistics = QueryStatistics()

    # -- plumbing --------------------------------------------------------------

    def _alive_nodes(self) -> list[str]:
        body, _ = self._channel.call("node_tracker", "list_nodes", {})
        return [a.decode() if isinstance(a, bytes) else a
                for a in body.get("alive", [])]

    def exec_node_addresses(self) -> dict:
        """id -> address of data nodes hosting exec slots."""
        def _t(x):
            return x.decode() if isinstance(x, bytes) else x
        body, _ = self._channel.call("node_tracker", "list_nodes", {})
        return {_t(k): _t(v) for k, v in (body.get("nodes") or {}).items()}

    def _execute(self, command: str, parameters: Optional[dict] = None,
                 attachments=(), idempotent: bool = True):
        body, out_attachments = self._channel.call(
            "driver", "execute",
            {"command": command, "parameters": parameters or {},
             "user": self.user},
            attachments, idempotent=idempotent)
        if body.get("kind") == "blob":
            return out_attachments[0]
        return body.get("result")

    def close(self) -> None:
        self._channel.close()
        self.chunk_store.close()

    # -- master transactions / locks / security --------------------------------

    def as_user(self, user: str) -> "RemoteYtClient":
        """A view of this cluster authenticated as another principal
        (shares nothing; its own channel)."""
        return RemoteYtClient(self.primary_address, timeout=self.timeout,
                              user=user, device=self.device)

    def start_tx(self, parent: Optional[str] = None) -> str:
        return self._execute("start_tx", {"parent": parent}
                             if parent else {})

    def commit_tx(self, tx: str) -> None:
        self._execute("commit_tx", {"tx": tx}, idempotent=False)

    def abort_tx(self, tx: str) -> None:
        self._execute("abort_tx", {"tx": tx}, idempotent=False)

    def lock(self, path: str, mode: str = "exclusive",
             tx: Optional[str] = None) -> None:
        self._execute("lock", {"path": path, "mode": mode, "tx": tx},
                      idempotent=False)

    def create_user(self, name: str) -> None:
        self._execute("create_user", {"name": name})

    def create_group(self, name: str,
                     members: Optional[list] = None) -> None:
        params = {"name": name}
        if members is not None:
            params["members"] = members
        self._execute("create_group", params)

    def create_account(self, name: str,
                       resource_limits: Optional[dict] = None) -> None:
        params = {"name": name}
        if resource_limits is not None:
            params["resource_limits"] = resource_limits
        self._execute("create_account", params)

    def add_member(self, group: str, member: str) -> None:
        self._execute("add_member", {"group": group, "member": member})

    def check_permission(self, user: str, permission: str,
                         path: str) -> dict:
        return self._execute("check_permission", {
            "user": user, "permission": permission, "path": path})

    # -- orchid ----------------------------------------------------------------

    def get_orchid(self, path: str = "/") -> Any:
        """Live daemon state (ref: orchid_service.h virtual trees)."""
        body, _ = self._channel.call("orchid", "get", {"path": path})
        return body.get("value")

    def list_orchid(self, path: str = "/") -> list[str]:
        body, _ = self._channel.call("orchid", "list", {"path": path})
        return list(body.get("names", []))

    # -- cypress ---------------------------------------------------------------

    def create(self, node_type: str, path: str,
               attributes: Optional[dict] = None, recursive: bool = False,
               ignore_existing: bool = False,
               tx: Optional[str] = None) -> str:
        attributes = dict(attributes or {})
        schema = attributes.get("schema")
        if isinstance(schema, TableSchema):
            attributes["schema"] = schema.to_dict()
        params = {
            "type": node_type, "path": path, "attributes": attributes,
            "recursive": recursive, "ignore_existing": ignore_existing}
        if tx is not None:
            params["tx"] = tx
        return self._execute("create", params, idempotent=False)

    def get(self, path: str, tx: Optional[str] = None) -> Any:
        params = {"path": path}
        if tx is not None:
            params["tx"] = tx
        return self._execute("get", params)

    def set(self, path: str, value: Any, tx: Optional[str] = None) -> None:
        params = {"path": path, "value": value}
        if tx is not None:
            params["tx"] = tx
        self._execute("set", params, idempotent=False)

    def exists(self, path: str) -> bool:
        return bool(self._execute("exists", {"path": path}))

    def list(self, path: str) -> list[str]:
        return list(self._execute("list", {"path": path}))

    def copy(self, src: str, dst: str, recursive: bool = False) -> str:
        return self._execute("copy", {"source_path": src,
                                      "destination_path": dst,
                                      "recursive": recursive},
                             idempotent=False)

    def move(self, src: str, dst: str, recursive: bool = False) -> str:
        return self._execute("move", {"source_path": src,
                                      "destination_path": dst,
                                      "recursive": recursive},
                             idempotent=False)

    def link(self, target: str, link: str, recursive: bool = False) -> str:
        return self._execute("link", {"target_path": target,
                                      "link_path": link,
                                      "recursive": recursive},
                             idempotent=False)

    def remove(self, path: str, recursive: bool = True,
               force: bool = False, tx: Optional[str] = None) -> None:
        params = {"path": path, "recursive": recursive, "force": force}
        if tx is not None:
            params["tx"] = tx
        self._execute("remove", params, idempotent=False)

    def collect_garbage(self) -> int:
        """Server-side sweep.  NOTE: client-local operations in flight are
        invisible to the primary; run this only while idle."""
        return int(self._execute("collect_garbage", {}, idempotent=False))

    # -- static tables ---------------------------------------------------------

    def write_table(self, path: str, rows, append: bool = False,
                    schema=None, format: Optional[str] = None) -> None:
        params: dict = {"path": path, "append": append}
        if schema is not None:
            params["schema"] = (schema.to_dict()
                                if isinstance(schema, TableSchema)
                                else schema)
        attachments = []
        if format is not None:
            params["format"] = format
            attachments = [rows if isinstance(rows, bytes)
                           else bytes(rows)]
        else:
            params["rows"] = [dict(r) if isinstance(r, dict) else list(r)
                              for r in rows]
        self._execute("write_table", params, attachments, idempotent=False)

    def read_table(self, path: str, format: Optional[str] = None):
        params: dict = {"path": path}
        if format is not None:
            params["format"] = format
        return self._execute("read_table", params)

    # -- dynamic tables --------------------------------------------------------

    def mount_table(self, path: str) -> None:
        self._execute("mount_table", {"path": path}, idempotent=False)

    def unmount_table(self, path: str) -> None:
        self._execute("unmount_table", {"path": path}, idempotent=False)

    def freeze_table(self, path: str) -> None:
        self._execute("freeze_table", {"path": path}, idempotent=False)

    def reshard_table(self, path: str, pivot_keys) -> None:
        self._execute("reshard_table",
                      {"path": path,
                       "pivot_keys": [list(k) for k in pivot_keys]},
                      idempotent=False)

    def compact_table(self, path: str) -> None:
        self._execute("compact_table", {"path": path}, idempotent=False)

    def insert_rows(self, path: str, rows: Sequence[dict],
                    tx: Optional[RemoteTransaction] = None,
                    update: bool = False) -> None:
        rows = [dict(r) for r in rows]
        if tx is None:
            self._execute("insert_rows",
                          {"path": path, "rows": rows, "update": update},
                          idempotent=False)
            return
        self._channel.call("driver", "insert_rows_tx",
                           {"tx_id": tx.id, "path": path, "rows": rows,
                            "update": update}, idempotent=False)

    def delete_rows(self, path: str, keys: Sequence[tuple],
                    tx: Optional[RemoteTransaction] = None) -> None:
        wire_keys = [list(k) for k in keys]
        if tx is None:
            self._execute("delete_rows", {"path": path, "keys": wire_keys},
                          idempotent=False)
            return
        self._channel.call("driver", "delete_rows_tx",
                           {"tx_id": tx.id, "path": path,
                            "keys": wire_keys}, idempotent=False)

    def lookup_rows(self, path: str, keys: Sequence[tuple],
                    timestamp: int = MAX_TIMESTAMP,
                    column_names: Optional[Sequence[str]] = None,
                    timeout: Optional[float] = None,
                    pool: Optional[str] = None):
        """Server-side lookups go through the primary's QueryGateway:
        a throttled request comes back as a RequestThrottled-coded error
        whose retry_after hint the RetryingChannel honors; a
        DeadlineExceeded answer is terminal (never retried)."""
        params: dict = {"path": path, "keys": [list(k) for k in keys]}
        if timestamp != MAX_TIMESTAMP:
            params["timestamp"] = timestamp
        if column_names is not None:
            params["column_names"] = list(column_names)
        if timeout is not None:
            params["timeout"] = timeout
        if pool is not None:
            params["pool"] = pool
        return self._execute("lookup_rows", params)

    def select_rows(self, query: str, timeout: Optional[float] = None,
                    pool: Optional[str] = None,
                    explain_analyze: bool = False,
                    params: Optional[Sequence] = None) -> list[dict]:
        req: dict = {"query": query}
        if timeout is not None:
            req["timeout"] = timeout
        if pool is not None:
            req["pool"] = pool
        if explain_analyze:
            # Server-side profile, returned as a plain dict (the span
            # tree lives in the PRIMARY's collector; `yt trace` reads it
            # back through the orchid).
            req["explain_analyze"] = True
        if params is not None:
            # Placeholder (`?`) bindings; vectors ride as JSON lists.
            req["params"] = list(params)
        return self._execute("select_rows", req)

    def nearest_rows(self, path: str, column: str, query_vector, k: int,
                     metric: str = "l2",
                     timestamp: int = MAX_TIMESTAMP,
                     timeout: Optional[float] = None,
                     pool: Optional[str] = None) -> list[dict]:
        req: dict = {"path": path, "column": column,
                     "query_vector": list(query_vector), "k": k}
        if metric != "l2":
            req["metric"] = metric
        if timestamp != MAX_TIMESTAMP:
            req["timestamp"] = timestamp
        if timeout is not None:
            req["timeout"] = timeout
        if pool is not None:
            req["pool"] = pool
        return self._execute("nearest_rows", req)

    def push_queue(self, path: str, rows: Sequence[dict]) -> int:
        return int(self._execute(
            "push_queue", {"path": path, "rows": [dict(r) for r in rows]},
            idempotent=False))

    def pull_queue(self, path: str, offset: int = 0,
                   limit: Optional[int] = None) -> list[dict]:
        params: dict = {"path": path, "offset": offset}
        if limit is not None:
            params["limit"] = limit
        return self._execute("pull_queue", params)

    def trim_rows(self, path: str, trimmed_count: int) -> None:
        self._execute("trim_rows", {"path": path,
                                    "trimmed_row_count": trimmed_count},
                      idempotent=False)

    # -- materialized views -----------------------------------------

    def create_materialized_view(self, name: str, query: str,
                                 source: Optional[str] = None,
                                 target: Optional[str] = None,
                                 pool: str = "views",
                                 batch_rows: Optional[int] = None) -> dict:
        params: dict = {"name": name, "query": query, "pool": pool}
        if source is not None:
            params["source"] = source
        if target is not None:
            params["target"] = target
        if batch_rows is not None:
            params["batch_rows"] = batch_rows
        return self._execute("create_materialized_view", params,
                             idempotent=False)

    def list_views(self) -> list[str]:
        return self._execute("list_views", {})

    def get_view(self, name: str) -> dict:
        return self._execute("get_view", {"name": name})

    def pause_view(self, name: str) -> dict:
        return self._execute("pause_view", {"name": name},
                             idempotent=False)

    def resume_view(self, name: str) -> dict:
        return self._execute("resume_view", {"name": name},
                             idempotent=False)

    def remove_view(self, name: str, drop_target: bool = False) -> None:
        self._execute("remove_view",
                      {"name": name, "drop_target": drop_target},
                      idempotent=False)

    def refresh_view(self, name: str, max_batches: int = 0) -> dict:
        return self._execute("refresh_view",
                             {"name": name, "max_batches": max_batches},
                             idempotent=False)

    # -- transactions ----------------------------------------------------------

    def start_transaction(self) -> RemoteTransaction:
        body, _ = self._channel.call("driver", "start_transaction", {},
                                     idempotent=False)
        return RemoteTransaction(id=body["tx_id"],
                                 start_timestamp=int(
                                     body["start_timestamp"]))

    def commit_transaction(self, tx: RemoteTransaction) -> int:
        body, _ = self._channel.call("driver", "commit_transaction",
                                     {"tx_id": tx.id}, idempotent=False)
        return int(body["commit_timestamp"])

    def abort_transaction(self, tx: RemoteTransaction) -> None:
        self._channel.call("driver", "abort_transaction", {"tx_id": tx.id},
                           idempotent=False)

    # -- operations (local controller, remote data plane) ----------------------

    def run_sort(self, input_path: str, output_path: str, sort_by, **kw):
        return self.scheduler.start_operation(
            "sort", {"input_table_path": input_path,
                     "output_table_path": output_path,
                     "sort_by": list(sort_by), **kw})

    def run_merge(self, input_paths, output_path: str,
                  mode: str = "unordered", **kw):
        return self.scheduler.start_operation(
            "merge", {"input_table_paths": list(input_paths),
                      "output_table_path": output_path, "mode": mode, **kw})

    def run_map(self, mapper: "Callable | str", input_path: str,
                output_path: str, **kw):
        spec = {"input_table_path": input_path,
                "output_table_path": output_path, **kw}
        if isinstance(mapper, str):
            spec["command"] = mapper
        else:
            spec["mapper"] = mapper
        return self.scheduler.start_operation("map", spec)

    def run_erase(self, table_path: str, **kw):
        return self.scheduler.start_operation(
            "erase", {"table_path": table_path, **kw})

    def run_reduce(self, reducer: "Callable | str",
                   input_path: "str | Sequence[str]", output_path: str,
                   reduce_by, **kw):
        spec = {"output_table_path": output_path,
                "reduce_by": reduce_by, **kw}
        if isinstance(input_path, str):
            spec["input_table_path"] = input_path
        else:
            spec["input_table_paths"] = list(input_path)
        if isinstance(reducer, str):
            spec["command"] = reducer
        else:
            spec["reducer"] = reducer
        return self.scheduler.start_operation("reduce", spec)

    def run_map_reduce(self, mapper: "Callable | str | None",
                       reducer: "Callable | str", input_path: str,
                       output_path: str, reduce_by, **kw):
        spec = {"input_table_path": input_path,
                "output_table_path": output_path,
                "reduce_by": reduce_by, **kw}
        if isinstance(mapper, str):
            spec["map_command"] = mapper
        elif mapper is not None:
            spec["mapper"] = mapper
        if isinstance(reducer, str):
            spec["reduce_command"] = reducer
        else:
            spec["reducer"] = reducer
        return self.scheduler.start_operation("map_reduce", spec)

    def run_vanilla(self, tasks: dict, sync: bool = True, **kw):
        return self.scheduler.start_operation(
            "vanilla", {"tasks": tasks, **kw}, sync=sync)

    def run_remote_copy(self, cluster_address: str, input_path: str,
                        output_path: str, **kw):
        return self.scheduler.start_operation("remote_copy", {
            "cluster_address": cluster_address,
            "input_table_path": input_path,
            "output_table_path": output_path, **kw})

    def abort_operation(self, op_id: str):
        return self.scheduler.abort_operation(op_id)

    # -- chunk-level IO for the local operation controllers --------------------

    def _read_table_chunks(self, path: str) -> list[ColumnarChunk]:
        if bool(self.get(path + "/@dynamic")):
            schema = TableSchema.from_dict(self.get(path + "/@schema"))
            rows = self._execute(
                "select_rows",
                {"query": f"* FROM [{path}]"})
            return [ColumnarChunk.from_rows(schema.to_unsorted(),
                                            rows or [], device=self.device)]
        chunk_ids = self.get(path + "/@chunk_ids") or []
        if not chunk_ids:
            schema_dict = self.get(path + "/@schema")
            if schema_dict is None:
                raise YtError(f"Empty table {path!r} has no schema",
                              code=EErrorCode.NoSuchNode)
            schema = TableSchema.from_dict(schema_dict)
            return [ColumnarChunk.from_rows(schema.to_unsorted(), [],
                                            device=self.device)]
        return [self.chunk_store.read_chunk(cid, device=self.device)
                for cid in chunk_ids]

    def _write_table_chunks(self, path: str, chunks: list[ColumnarChunk],
                            sorted_by: Optional[list[str]] = None,
                            schema: Optional[TableSchema] = None) -> None:
        from ytsaurus_tpu_torch.client import publish_table_chunks
        if not self.exists(path):
            attributes: dict = {}
            if schema is not None:
                attributes["schema"] = schema.to_dict()
            self.create("table", path, attributes=attributes,
                        recursive=True)
        publish_table_chunks(self, self.chunk_store, path, chunks,
                             sorted_by=sorted_by, schema=schema)


def connect_remote(primary_address: "str | Sequence[str]",
                   device: "str | torch.device" = DEFAULT_DEVICE
                   ) -> RemoteYtClient:
    return RemoteYtClient(primary_address, device=device)


def routed_client(replicas: "Sequence[tuple]", timeout: float = 120.0,
                  user: str = "root", scrape_period: float = 0.5,
                  start: bool = True,
                  device: "str | torch.device" = DEFAULT_DEVICE):
    """Load-aware multi-replica client: one RemoteYtClient
    per serving replica, routed by a ReplicaRouter that scrapes each
    daemon's monitoring `/serving` endpoint (queue depth, hold EWMA,
    brown-out rung) instead of hedging blindly.

    `replicas`: (name, rpc_address, monitor_address) triples — or
    (rpc_address, monitor_address) pairs, where the rpc address doubles
    as the name."""
    from ytsaurus_tpu_torch.query.routing import ReplicaRouter, RoutedYtClient
    router = ReplicaRouter(replicas, scrape_period=scrape_period)
    clients = {r.name: RemoteYtClient(r.address, timeout=timeout,
                                      user=user, device=device)
               for r in router.replicas()}
    routed = RoutedYtClient(router, clients)
    if start:
        router.start()
    return routed
