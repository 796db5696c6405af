"""Table replication: sync/async replicas, replicator, health tracker.
Own copy of the JAX package's `tablet/replication.py`.

Ref mapping (server/node/tablet_node + server/replicated_table_tracker):
  table_replicator.cpp            → TableReplicator (pulls committed
                                    versions newer than the replica
                                    checkpoint, applies them in timestamp
                                    order to the replica table)
  transaction.cpp:737-830 (sync   → sync replicas are enrolled as extra
  replica fanout in ModifyRows)     participants of the SAME upstream 2PC
                                    commit (client.insert_rows/delete_rows)
  replicated_table_tracker        → ReplicatedTableTracker (health probes,
                                    demote broken sync replicas, promote
                                    caught-up async ones to honor
                                    @min_sync_replicas)
  hedging_channel.h / client      → replica fallback reads: lookup falls
  hedging                           back to the freshest enabled replica

Design delta: there is no separate replication-log table.  The versioned
snapshot ARE the log — every committed version carries its timestamp and
per-column $w written flags, so "what changed after ts X" is a filter
over the tablet's versioned rows (`events_since` walks them on the host,
row by row, as the reference does).  Replica applies preserve upstream
timestamps (the provider is a hybrid logical clock:
`TimestampProvider.observe` folds replicated timestamps into the replica
clock so local commits stay monotone).  A replica under another
`cluster_root` is opened with the port's own `connect`, on this client's
device.
"""

from __future__ import annotations

from typing import Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.tablet.timestamp import _global_provider

REPLICAS_ATTR = "replicas"


def replica_descriptors(client, table_path: str) -> dict:
    """The @replicas attribute: replica_id → descriptor dict.  Reads the
    node attribute directly — this sits on the hot write path, so the
    common non-replicated case must not build/catch an exception."""
    node = client._table_node(table_path)
    return dict(node.attributes.get(REPLICAS_ATTR) or {})


def set_replica_descriptors(client, table_path: str, replicas: dict) -> None:
    client.set(table_path + "/@" + REPLICAS_ATTR, replicas)


def events_since(client, table_path: str, checkpoint_ts: int) -> list:
    """Committed modifications with timestamp > checkpoint_ts, oldest first.

    Each event is (ts, "write"|"delete", row_or_key).  Write payloads carry
    only the columns that version actually wrote (per-column $w planes) so
    partial writes replicate as partial writes (versioned_row_merger
    semantics, ytlib/table_client/versioned_row_merger.h).
    """
    tablets = client._mounted_tablets(table_path)
    schema = tablets[0].schema
    key_names = schema.key_column_names
    value_names = [c.name for c in schema if c.sort_order is None]
    events = []
    for tablet in tablets:
        for vrow in tablet.versioned_rows_snapshot():
            ts = vrow["$timestamp"]
            if ts <= checkpoint_ts:
                continue
            key = tuple(vrow[k] for k in key_names)
            if vrow["$tombstone"]:
                events.append((ts, "delete", key))
            else:
                row = dict(zip(key_names, key))
                for name in value_names:
                    if vrow.get(f"$w:{name}"):
                        row[name] = vrow[name]
                events.append((ts, "write", row))
    events.sort(key=lambda e: e[0])
    return events


def apply_events(replica_client, replica_path: str, events: list) -> int:
    """Apply replicated events to the replica table with PRESERVED upstream
    timestamps (writes go straight into the tablet stores; ordering and
    conflict-freedom come from replaying in commit order)."""
    if not events:
        return 0
    tablets = replica_client._mounted_tablets(replica_path)
    applied = 0
    for ts, op, payload in events:
        _global_provider.observe(ts)
        routed = replica_client._route_rows(replica_path, tablets, [payload])
        for idx, part in routed.items():
            for item in part:
                if op == "delete":
                    tablets[idx].delete_row(tuple(item), ts)
                else:
                    tablets[idx].write_row(item, ts, update=True)
        applied += 1
    return applied


class TableReplicator:
    """Pull-based async replicator (ref table_replicator.cpp).

    One instance serves any number of replicated tables; remote-cluster
    clients (replicas living under a different root_dir) are cached.
    """

    def __init__(self, client):
        self.client = client
        self._remote_clients: dict[str, object] = {}

    def replica_client(self, cluster_root: Optional[str]):
        if cluster_root is None or \
                cluster_root == self.client.cluster.root_dir:
            return self.client
        cached = self._remote_clients.get(cluster_root)
        if cached is None:
            from ytsaurus_tpu_torch.client import connect
            cached = connect(cluster_root,
                             device=self.client.cluster.device)
            self._remote_clients[cluster_root] = cached
        return cached

    def sync_replica(self, table_path: str, replica_id: str) -> int:
        """Catch one replica up to the upstream head; returns the number of
        events applied.  Raises (and records the error on the descriptor)
        if the replica is unreachable."""
        replicas = replica_descriptors(self.client, table_path)
        info = replicas.get(replica_id)
        if info is None:
            raise YtError(f"No such replica {replica_id!r} of {table_path!r}",
                          code=EErrorCode.ResolveError)
        try:
            rc = self.replica_client(info.get("cluster_root"))
            events = events_since(self.client, table_path,
                                  int(info.get("last_replicated_ts", 0)))
            applied = apply_events(rc, info["path"], events)
            if events:
                info["last_replicated_ts"] = max(e[0] for e in events)
            info["error"] = None
        except YtError as err:
            info["error"] = str(err)
            set_replica_descriptors(self.client, table_path, replicas)
            raise
        set_replica_descriptors(self.client, table_path, replicas)
        return applied

    def replicate_step(self, table_path: str) -> dict:
        """One replicator pass: catch up every enabled async replica.
        Returns replica_id → applied-event count (or -1 on error)."""
        out = {}
        for rid, info in replica_descriptors(self.client, table_path).items():
            if not info.get("enabled") or info.get("mode") != "async":
                continue
            try:
                out[rid] = self.sync_replica(table_path, rid)
            except YtError:
                out[rid] = -1
        return out

    def lag(self, table_path: str, replica_id: str) -> int:
        """Unreplicated-event count (upstream versions past checkpoint)."""
        info = replica_descriptors(self.client, table_path)[replica_id]
        return len(events_since(self.client, table_path,
                                int(info.get("last_replicated_ts", 0))))


class ReplicatedTableTracker:
    """Health-based sync/async mode management
    (ref server/replicated_table_tracker).

    step() probes every replica, demotes broken sync replicas to async,
    and promotes caught-up healthy async replicas until the table's
    @min_sync_replicas (default 1) healthy sync replicas exist.
    """

    def __init__(self, replicator: TableReplicator):
        self.replicator = replicator
        self.client = replicator.client

    def probe(self, info: dict) -> Optional[str]:
        """None when healthy, else the failure reason."""
        if not info.get("enabled"):
            return "disabled"
        try:
            rc = self.replicator.replica_client(info.get("cluster_root"))
            if not rc.exists(info["path"]):
                return "replica table missing"
            if rc.get(info["path"] + "/@tablet_state") != "mounted":
                return "replica table not mounted"
        except YtError as err:
            return str(err)
        return None

    def step(self, table_path: str) -> dict:
        try:
            min_sync = int(self.client.get(
                table_path + "/@min_sync_replicas"))
        except YtError:
            min_sync = 1
        replicas = replica_descriptors(self.client, table_path)
        health = {rid: self.probe(info) for rid, info in replicas.items()}
        # Demote broken sync replicas.
        for rid, info in replicas.items():
            if info.get("mode") == "sync" and health[rid] is not None:
                info["mode"] = "async"
        sync_count = sum(1 for rid, info in replicas.items()
                         if info.get("mode") == "sync"
                         and health[rid] is None)
        set_replica_descriptors(self.client, table_path, replicas)
        # Promote healthy async replicas (catch them up first so the flip
        # to sync does not serve stale reads).
        for rid, info in sorted(
                replicas.items(),
                key=lambda kv: -int(kv[1].get("last_replicated_ts", 0))):
            if sync_count >= min_sync:
                break
            if info.get("mode") != "async" or health[rid] is not None:
                continue
            try:
                self.replicator.sync_replica(table_path, rid)
            except YtError:
                continue
            replicas = replica_descriptors(self.client, table_path)
            replicas[rid]["mode"] = "sync"
            set_replica_descriptors(self.client, table_path, replicas)
            sync_count += 1
        return {"health": health, "sync_count": sync_count}
