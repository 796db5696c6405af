"""Queue agent: consumer registrations, offsets, lag tracking, auto-trim.
Own copy of the JAX package's `server/queue_agent.py`.

Ref mapping (server/queue_agent + client/queue_client):
  consumer tables (consumer_client.h)     → sorted dynamic table with the
                                            standard consumer schema
                                            (queue_path, partition_index)
                                            → offset
  RegisterQueueConsumer                   → register_consumer (recorded in
                                            the queue's @registrations)
  AdvanceConsumer (monotonic unless       → advance_consumer
  client passes expected offset)
  queue_agent controller passes           → QueueAgent.step(): per-queue
  (queue_controller.cpp)                    partition stats, consumer lags,
                                            auto-trim up to the minimum
                                            vital-consumer offset
  @queue_status / orchid export           → @queue_status attribute on the
                                            queue node

Design delta: queues are single-partition ordered tablets today; the
consumer schema and status layout carry partition_index so multi-partition
queues slot in without an API change.
"""

from __future__ import annotations

from typing import Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.schema import TableSchema

CONSUMER_SCHEMA = TableSchema.make([
    ("queue_path", "string", "ascending"),
    ("partition_index", "int64", "ascending"),
    ("offset", "int64"),
], unique_keys=True)


def is_consumer_schema(schema: TableSchema) -> bool:
    return [c.name for c in schema] == [c.name for c in CONSUMER_SCHEMA]


def _consumer_offset(client, consumer_path: str, queue_path: str,
                     partition_index: int = 0) -> int:
    # System path: consumer-offset bookkeeping must not queue behind
    # user read admission.
    rows = client._lookup_rows_direct(consumer_path,
                                      [(queue_path, partition_index)])
    return int(rows[0]["offset"]) if rows[0] is not None else 0


class QueueAgent:
    """Background queue controller (one instance serves a cluster)."""

    def __init__(self, client):
        self.client = client

    def queue_status(self, queue_path: str) -> dict:
        """Partition stats + per-consumer offsets and lags."""
        (tablet,) = self.client._mounted_tablets(queue_path)
        total = tablet.row_count
        trimmed = tablet.trimmed_count
        consumers = {}
        node = self.client._table_node(queue_path)
        for cpath, reg in (node.attributes.get("registrations")
                           or {}).items():
            try:
                offset = _consumer_offset(self.client, cpath, queue_path)
            except YtError:
                offset = 0
            consumers[cpath] = {
                "offset": offset,
                "lag": max(total - offset, 0),
                "vital": bool(reg.get("vital", True)),
            }
        return {
            "partitions": [{
                "partition_index": 0,
                "upper_row_index": total,
                "trimmed_row_count": trimmed,
                "available_row_count": total - trimmed,
            }],
            "consumers": consumers,
        }

    def trim_queue(self, queue_path: str) -> int:
        """Trim rows every VITAL consumer has passed (ref auto-trim:
        vital consumers gate trimming; non-vital ones may lag forever).
        Returns the new trimmed_row_count."""
        status = self.queue_status(queue_path)
        vital_offsets = [c["offset"] for c in status["consumers"].values()
                         if c["vital"]]
        (tablet,) = self.client._mounted_tablets(queue_path)
        if not vital_offsets:
            return tablet.trimmed_count
        target = min(vital_offsets)
        if target > tablet.trimmed_count:
            tablet.trim_rows(target)
        return tablet.trimmed_count

    def step(self) -> dict:
        """One agent pass over every registered queue: refresh
        @queue_status, auto-trim queues whose @auto_trim_config enables it.
        Returns queue_path → status."""
        out = {}
        for queue_path in self._registered_queues():
            try:
                node = self.client._table_node(queue_path)
                auto_trim = (node.attributes.get("auto_trim_config")
                             or {}).get("enable", False)
                if auto_trim:
                    self.trim_queue(queue_path)
                status = self.queue_status(queue_path)
                self.client.set(queue_path + "/@queue_status", status)
                out[queue_path] = status
            except YtError as err:
                out[queue_path] = {"error": str(err)}
        return out

    def _registered_queues(self) -> list[str]:
        """Queues = dynamic tables with an unsorted schema that carry at
        least one registration (scan mirrors the agent's Cypress poll)."""
        found = []
        stack = [("/", self.client.cluster.master.tree.root)]
        while stack:
            path, node = stack.pop()
            if node.type == "table" and \
                    node.attributes.get("registrations"):
                found.append(path)
            for name, child in node.children.items():
                stack.append((f"/{path.rstrip('/')}/{name}", child))
        return sorted(found)


def register_consumer(client, queue_path: str, consumer_path: str,
                      vital: bool = True) -> None:
    """Create (if needed) the consumer table and record the registration
    on the queue node (ref RegisterQueueConsumer)."""
    (tablet,) = client._mounted_tablets(queue_path)
    from ytsaurus_tpu_torch.tablet.ordered import OrderedTablet
    if not isinstance(tablet, OrderedTablet):
        raise YtError(f"{queue_path!r} is not an ordered (queue) table",
                      code=EErrorCode.QueryUnsupported)
    if not client.exists(consumer_path):
        client.create("table", consumer_path, recursive=True,
                      attributes={"schema": CONSUMER_SCHEMA,
                                  "dynamic": True,
                                  "treat_as_queue_consumer": True})
        client.mount_table(consumer_path)
    else:
        schema = client._node_schema(client._table_node(consumer_path))
        if schema is None or not is_consumer_schema(schema):
            raise YtError(f"{consumer_path!r} is not a consumer table",
                          code=EErrorCode.QueryTypeError)
    regs = dict(client._table_node(queue_path).attributes.get(
        "registrations") or {})
    regs[consumer_path] = {"vital": bool(vital)}
    client.set(queue_path + "/@registrations", regs)


def unregister_consumer(client, queue_path: str,
                        consumer_path: str) -> None:
    regs = dict(client._table_node(queue_path).attributes.get(
        "registrations") or {})
    regs.pop(consumer_path, None)
    client.set(queue_path + "/@registrations", regs)


def advance_consumer(client, consumer_path: str, queue_path: str,
                     new_offset: int,
                     old_offset: Optional[int] = None,
                     partition_index: int = 0) -> None:
    """Move a consumer's offset forward.  old_offset, when given, must
    match the stored offset (optimistic concurrency, ref AdvanceConsumer);
    offsets never move backwards."""
    current = _consumer_offset(client, consumer_path, queue_path,
                               partition_index)
    if old_offset is not None and old_offset != current:
        raise YtError(
            f"Consumer offset mismatch: expected {old_offset}, "
            f"stored {current}", code=EErrorCode.TransactionLockConflict)
    if new_offset < current:
        raise YtError(f"Consumer offset may not move backwards "
                      f"({current} -> {new_offset})",
                      code=EErrorCode.QueryTypeError)
    client.insert_rows(consumer_path, [{
        "queue_path": queue_path, "partition_index": partition_index,
        "offset": new_offset}])


def pull_consumer(client, consumer_path: str, queue_path: str,
                  limit: Optional[int] = None,
                  partition_index: int = 0) -> tuple[list[dict], int]:
    """Read rows from the consumer's current offset.  Returns (rows,
    next_offset); the caller advances explicitly after processing
    (at-least-once delivery, ref pull_consumer)."""
    offset = _consumer_offset(client, consumer_path, queue_path,
                              partition_index)
    rows = client.pull_queue(queue_path, offset=offset, limit=limit)
    # Trimming may have advanced past the stored offset: next_offset comes
    # from the actual row indexes served, not offset + len(rows).  When
    # the trim passed the offset AND nothing is live (rows == []), the
    # cursor must still land on the trim boundary — returning the stale
    # offset would park the consumer below trimmed_count forever (its
    # lag never drains, and a later advance_consumer(next_offset) would
    # be a no-op loop).  Surfaced by the view-daemon tail loop;
    # regression-tested in tests/test_views.py.
    if rows:
        next_offset = rows[-1]["$row_index"] + 1
    else:
        (tablet,) = client._mounted_tablets(queue_path)
        next_offset = max(offset, tablet.trimmed_count)
    return rows, next_offset
