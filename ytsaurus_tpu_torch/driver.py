"""Driver: string command name + parameters → typed client call.

Ref: the reference driver command registry (client/driver/driver.cpp:121) —
one table of command descriptors shared by every protocol front end (CLI,
HTTP proxy).  `execute(command, parameters)` dispatches onto YtClient; the
registry doubles as the machine-readable API surface list.

Own copy of the JAX package's `driver.py`: the same command names with
the same required / optional parameters and mutating flags. A command
whose client method the port still lacks raises the client's YtError
naming the module it waits for.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError


@dataclass(frozen=True)
class CommandDescriptor:
    name: str
    required: tuple[str, ...]
    optional: tuple[str, ...]
    is_mutating: bool
    invoke: Callable


def _d(name, required, optional, mutating, invoke):
    return CommandDescriptor(name=name, required=tuple(required),
                             optional=tuple(optional), is_mutating=mutating,
                             invoke=invoke)


def _select_rows_command(cl, p: dict):
    """select_rows with the EXPLAIN ANALYZE shape: explain_analyze=True
    returns the ExecutionProfile as a plain dict (wire/JSON safe — this
    registry feeds the RPC driver service and the HTTP proxy)."""
    kwargs = {k: p[k] for k in ("timeout", "pool", "params") if k in p}
    if p.get("explain_analyze"):
        profile = cl.select_rows(p["query"], explain_analyze=True,
                                 **kwargs)
        return profile.to_dict() if hasattr(profile, "to_dict") \
            else profile
    return cl.select_rows(p["query"], **kwargs)


def _registry() -> dict[str, CommandDescriptor]:
    c: dict[str, CommandDescriptor] = {}
    for d in [
        # cypress
        _d("create", ("type", "path"), ("attributes", "recursive",
                                        "ignore_existing", "tx"), True,
           lambda cl, p: cl.create(p["type"], p["path"],
                                   attributes=p.get("attributes"),
                                   recursive=p.get("recursive", False),
                                   ignore_existing=p.get("ignore_existing",
                                                         False),
                                   tx=p.get("tx"))),
        _d("get", ("path",), ("tx",), False,
           lambda cl, p: cl.get(p["path"], tx=p.get("tx"))),
        _d("set", ("path", "value"), ("tx",), True,
           lambda cl, p: cl.set(p["path"], p["value"], tx=p.get("tx"))),
        _d("exists", ("path",), (), False,
           lambda cl, p: cl.exists(p["path"])),
        _d("list", ("path",), (), False, lambda cl, p: cl.list(p["path"])),
        _d("remove", ("path",), ("recursive", "force", "tx"), True,
           lambda cl, p: cl.remove(p["path"],
                                   recursive=p.get("recursive", True),
                                   force=p.get("force", False),
                                   tx=p.get("tx"))),
        # master transactions + locks (ref: start_tx/lock driver commands)
        _d("start_tx", (), ("parent",), True,
           lambda cl, p: cl.start_tx(parent=p.get("parent"))),
        _d("commit_tx", ("tx",), (), True,
           lambda cl, p: cl.commit_tx(p["tx"])),
        _d("abort_tx", ("tx",), (), True,
           lambda cl, p: cl.abort_tx(p["tx"])),
        _d("lock", ("path", "tx"), ("mode",), True,
           lambda cl, p: cl.lock(p["path"],
                                 mode=p.get("mode", "exclusive"),
                                 tx=p["tx"])),
        # security (ref: security_client commands)
        _d("create_user", ("name",), (), True,
           lambda cl, p: cl.cluster.security.create_user(p["name"])),
        _d("create_group", ("name",), ("members",), True,
           lambda cl, p: cl.cluster.security.create_group(
               p["name"], members=p.get("members"))),
        _d("create_account", ("name",), ("resource_limits",), True,
           lambda cl, p: cl.cluster.security.create_account(
               p["name"], resource_limits=p.get("resource_limits"))),
        _d("add_member", ("group", "member"), (), True,
           lambda cl, p: cl.cluster.security.add_member(p["group"],
                                                        p["member"])),
        _d("remove_member", ("group", "member"), (), True,
           lambda cl, p: cl.cluster.security.remove_member(p["group"],
                                                           p["member"])),
        _d("check_permission", ("user", "permission", "path"), (), False,
           lambda cl, p: {"action": "allow"
                          if cl.cluster.security.check_permission(
                              p["user"], p["permission"], p["path"])
                          else "deny"}),
        _d("copy", ("source_path", "destination_path"), ("recursive",), True,
           lambda cl, p: cl.copy(p["source_path"], p["destination_path"],
                                 recursive=p.get("recursive", False))),
        _d("move", ("source_path", "destination_path"), ("recursive",), True,
           lambda cl, p: cl.move(p["source_path"], p["destination_path"],
                                 recursive=p.get("recursive", False))),
        _d("link", ("target_path", "link_path"), ("recursive",), True,
           lambda cl, p: cl.link(p["target_path"], p["link_path"],
                                 recursive=p.get("recursive", False))),
        # static tables
        _d("write_table", ("path", "rows"), ("append", "schema", "format"),
           True,
           lambda cl, p: cl.write_table(p["path"], p["rows"],
                                        append=p.get("append", False),
                                        schema=p.get("schema"),
                                        format=p.get("format"))),
        _d("read_table", ("path",), ("format",), False,
           lambda cl, p: cl.read_table(p["path"], format=p.get("format"))),
        # dynamic tables
        _d("mount_table", ("path",), (), True,
           lambda cl, p: cl.mount_table(p["path"])),
        _d("unmount_table", ("path",), (), True,
           lambda cl, p: cl.unmount_table(p["path"])),
        _d("freeze_table", ("path",), (), True,
           lambda cl, p: cl.freeze_table(p["path"])),
        _d("reshard_table", ("path", "pivot_keys"), (), True,
           lambda cl, p: cl.reshard_table(p["path"], p["pivot_keys"])),
        _d("insert_rows", ("path", "rows"), ("update",), True,
           lambda cl, p: cl.insert_rows(p["path"], p["rows"],
                                        update=p.get("update", False))),
        _d("delete_rows", ("path", "keys"), (), True,
           lambda cl, p: cl.delete_rows(p["path"], p["keys"])),
        _d("lookup_rows", ("path", "keys"),
           ("column_names", "timestamp", "timeout", "pool"), False,
           lambda cl, p: cl.lookup_rows(
               p["path"], p["keys"],
               **({"timestamp": p["timestamp"]} if "timestamp" in p else {}),
               **({"timeout": p["timeout"]} if "timeout" in p else {}),
               **({"pool": p["pool"]} if "pool" in p else {}),
               column_names=p.get("column_names"))),
        _d("select_rows", ("query",),
           ("timeout", "pool", "explain_analyze", "params"), False,
           lambda cl, p: _select_rows_command(cl, p)),
        _d("nearest_rows", ("path", "column", "query_vector", "k"),
           ("metric", "timestamp", "timeout", "pool"), False,
           lambda cl, p: cl.nearest_rows(
               p["path"], p["column"], p["query_vector"], int(p["k"]),
               metric=p.get("metric", "l2"),
               **({"timestamp": p["timestamp"]} if "timestamp" in p
                  else {}),
               **({"timeout": p["timeout"]} if "timeout" in p else {}),
               **({"pool": p["pool"]} if "pool" in p else {}))),
        _d("trim_rows", ("path", "trimmed_row_count"), (), True,
           lambda cl, p: cl.trim_rows(p["path"], p["trimmed_row_count"])),
        _d("push_queue", ("path", "rows"), (), True,
           lambda cl, p: cl.push_queue(p["path"], p["rows"])),
        _d("pull_queue", ("path", "offset"), ("limit",), False,
           lambda cl, p: cl.pull_queue(p["path"], p["offset"],
                                       limit=p.get("limit"))),
        _d("compact_table", ("path",), (), True,
           lambda cl, p: cl.compact_table(p["path"])),
        _d("collect_garbage", (), (), True,
           lambda cl, p: cl.collect_garbage()),
        # operations
        _d("sort", ("input_table_path", "output_table_path", "sort_by"), (),
           True,
           lambda cl, p: cl.run_sort(p["input_table_path"],
                                     p["output_table_path"],
                                     p["sort_by"]).id),
        _d("merge", ("input_table_paths", "output_table_path"), ("mode",),
           True,
           lambda cl, p: cl.run_merge(p["input_table_paths"],
                                      p["output_table_path"],
                                      mode=p.get("mode", "unordered")).id),
        _d("erase", ("table_path",), (), True,
           lambda cl, p: cl.run_erase(p["table_path"]).id),
        _d("map", ("command", "input_table_path", "output_table_path"),
           ("format", "pool", "job_count", "ordered"), True,
           lambda cl, p: cl.run_map(
               p["command"], p["input_table_path"],
               p["output_table_path"],
               **{k: p[k] for k in ("format", "pool", "job_count",
                                    "ordered") if k in p}).id),
        _d("get_operation", ("operation_id",), (), False,
           lambda cl, p: (lambda op: {"id": op.id, "state": op.state,
                                      "type": op.type})(
               cl.scheduler.get_operation(p["operation_id"]))),
        # queue consumers (ref queue_client + queue_agent verbs)
        _d("register_queue_consumer", ("queue_path", "consumer_path"),
           ("vital",), True,
           lambda cl, p: cl.register_queue_consumer(
               p["queue_path"], p["consumer_path"],
               vital=p.get("vital", True))),
        _d("unregister_queue_consumer", ("queue_path", "consumer_path"), (),
           True,
           lambda cl, p: cl.unregister_queue_consumer(
               p["queue_path"], p["consumer_path"])),
        _d("advance_consumer", ("consumer_path", "queue_path", "new_offset"),
           ("old_offset",), True,
           lambda cl, p: cl.advance_consumer(
               p["consumer_path"], p["queue_path"], p["new_offset"],
               old_offset=p.get("old_offset"))),
        _d("pull_consumer", ("consumer_path", "queue_path"), ("limit",),
           False,
           lambda cl, p: (lambda rows, off: {"rows": rows,
                                             "next_offset": off})(
               *cl.pull_consumer(p["consumer_path"], p["queue_path"],
                                 limit=p.get("limit")))),
        # materialized views (continuous queries)
        _d("create_materialized_view", ("name", "query"),
           ("source", "target", "pool", "batch_rows"), True,
           lambda cl, p: cl.create_materialized_view(
               p["name"], p["query"], source=p.get("source"),
               target=p.get("target"), pool=p.get("pool", "views"),
               batch_rows=p.get("batch_rows"))),
        _d("list_views", (), (), False, lambda cl, p: cl.list_views()),
        _d("get_view", ("name",), (), False,
           lambda cl, p: cl.get_view(p["name"])),
        _d("pause_view", ("name",), (), True,
           lambda cl, p: cl.pause_view(p["name"])),
        _d("resume_view", ("name",), (), True,
           lambda cl, p: cl.resume_view(p["name"])),
        _d("remove_view", ("name",), ("drop_target",), True,
           lambda cl, p: cl.remove_view(
               p["name"], drop_target=p.get("drop_target", False))),
        _d("refresh_view", ("name",), ("max_batches",), True,
           lambda cl, p: cl.refresh_view(
               p["name"], max_batches=p.get("max_batches", 0))),
        # query tracker (ref server/query_tracker verbs)
        _d("start_query", ("query",), ("engine", "annotations"), True,
           lambda cl, p: cl.query_tracker.start_query(
               p["query"], engine=p.get("engine", "ql"),
               annotations=p.get("annotations"))),
        _d("get_query", ("query_id",), (), False,
           lambda cl, p: cl.query_tracker.get_query(p["query_id"])),
        _d("list_queries", (), ("state", "engine"), False,
           lambda cl, p: cl.query_tracker.list_queries(
               state=p.get("state"), engine=p.get("engine"))),
        _d("read_query_result", ("query_id",), (), False,
           lambda cl, p: cl.query_tracker.read_query_result(p["query_id"])),
        _d("abort_query", ("query_id",), (), True,
           lambda cl, p: cl.query_tracker.abort_query(p["query_id"])),
    ]:
        c[d.name] = d
    return c


COMMANDS = _registry()


class Driver:
    """Executes named commands against a client (ref IDriver::Execute)."""

    def __init__(self, client):
        self.client = client

    def execute(self, command: str, parameters: Optional[dict] = None) -> Any:
        descriptor = COMMANDS.get(command)
        if descriptor is None:
            raise YtError(f"Unknown command {command!r}",
                          code=EErrorCode.Generic,
                          attributes={"available": sorted(COMMANDS)})
        parameters = dict(parameters or {})
        missing = [name for name in descriptor.required
                   if name not in parameters]
        if missing:
            raise YtError(
                f"Command {command!r} is missing parameters {missing}",
                code=EErrorCode.Generic)
        unknown = set(parameters) - set(descriptor.required) \
            - set(descriptor.optional)
        if unknown:
            raise YtError(
                f"Command {command!r} got unknown parameters "
                f"{sorted(unknown)}", code=EErrorCode.Generic)
        return descriptor.invoke(self.client, parameters)
