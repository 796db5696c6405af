"""The client API: a local in-process cluster + the IClient-shaped facade.

Own copy of the JAX package's `client.py` (ref NApi::IClient,
client/api/client.h; yt local mode, yt/python/yt/environment/yt_env.py):
`connect(root_dir, device="cuda")` opens a `YtCluster` whose master, chunk
cache, evaluator, tablets and job slots all run on the one device it
names, and returns a `YtClient`.

Cypress commands: create/get/set/list/exists/remove/copy/move/link/lock
and master transactions. Static tables: write_table/read_table (columnar
chunks in the chunk store, chunk ids recorded as table attributes).
Dynamic tables: mount/unmount/reshard/freeze/compact, insert/delete/
lookup/select, tablet transactions, queues. Operations: run_sort/run_merge/run_map (a Python mapper or a shell
command)/run_reduce/run_map_reduce/run_vanilla/run_erase via the
scheduler, with revival of command operations after a crash. Replicated
tables (sync and async replicas, replica fallback reads hedged across
replicas) and chaos replication cards; secondary indexes maintained in
the writing transaction and used by selects; queue consumers; incremental
materialized views over queues; backups of dynamic tables.

A cluster directory is the reference's: the master's changelog and
snapshot, the chunk files and the attributes are written in the same
formats, so a directory written by either package opens in the other.

The query tracker (`client.query_tracker`, server/query_tracker.py) runs
QL and the ClickHouse dialect (ecosystem/sql.py) on the cluster's device.

In a multi-process cluster (environment/local.py) the primary daemon
sets `YtCluster.node_directory`, and command maps dispatch to the data
nodes' exec slots; `run_remote_copy` pulls a table from another cluster
through `remote_client.connect_remote`.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Optional, Sequence

import torch

from ytsaurus_tpu_torch.chunks.columnar import ColumnarChunk, concat_chunks
from ytsaurus_tpu_torch.chunks.store import ChunkCache, FsChunkStore
from ytsaurus_tpu_torch.cypress.master import Master
from ytsaurus_tpu_torch.device import DEFAULT_DEVICE, resolve_device, same_device
from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.query import ir
from ytsaurus_tpu_torch.query.builder import build_query
from ytsaurus_tpu_torch.query.coordinator import coordinate_and_execute
from ytsaurus_tpu_torch.query.engine.evaluator import Evaluator
from ytsaurus_tpu_torch.schema import EValueType, TableSchema
from ytsaurus_tpu_torch.tablet.tablet import Tablet
from ytsaurus_tpu_torch.tablet.timestamp import MAX_TIMESTAMP
from ytsaurus_tpu_torch.tablet.transactions import TabletTransaction, TransactionManager


class YtCluster:
    """Everything one process needs to be a cluster (local mode), on
    one device: the chunk cache decodes onto it, and the evaluator, the
    tablets, the sorts and the vector batcher run there."""

    def __init__(self, root_dir: str, chunk_store=None, master=None,
                 device: "str | torch.device" = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.root_dir = root_dir
        os.makedirs(root_dir, exist_ok=True)
        self.master = master if master is not None else \
            Master(os.path.join(root_dir, "master"))
        self.chunk_store = chunk_store if chunk_store is not None else \
            FsChunkStore(os.path.join(root_dir, "chunks"))
        self.chunk_cache = ChunkCache(self.chunk_store, device=self.device)
        # Chunks written but not yet published to any table (the chunk
        # merger's write→CAS window): GC and the replicator must treat
        # them as referenced or a concurrent sweep deletes a chunk a
        # table is about to adopt.
        self.protected_chunk_ids: set = set()
        self.transactions = TransactionManager()
        # id -> address of exec-node daemons (set by the primary daemon);
        # None in pure local mode, where command jobs run in-process.
        self.node_directory: "Callable[[], dict] | None" = None
        self.evaluator = Evaluator(self.device)
        self.tablets: dict[str, list[Tablet]] = {}   # node id → tablets
        # Query serving plane (query/serving.py): set serving_config
        # BEFORE the first query to override the defaults; the gateway
        # is cluster-scoped so every client of this cluster shares
        # admission slots and coalesces lookups into common batches.
        self.serving_config = None
        self._gateway = None
        self._gateway_lock = threading.Lock()
        from ytsaurus_tpu_torch.cypress.security import SecurityManager
        self.security = SecurityManager(self.master)
        self.security.ensure_defaults()

    @property
    def gateway(self):
        if self._gateway is None:
            from ytsaurus_tpu_torch.query.serving import QueryGateway
            with self._gateway_lock:
                if self._gateway is None:
                    self._gateway = QueryGateway(self.serving_config)
        return self._gateway


# Chunks a publish writes at once (each one's columns encode on the codec
# pool of chunks/encoding.py).
_PUBLISH_THREADS = 4


def write_table_chunks(chunk_store, chunks) -> "tuple[list, list]":
    """Write `chunks` to `chunk_store` and read back their stats, on
    threads of their own, at most `_PUBLISH_THREADS` at a time: each
    serialize is zlib and the codec library, which release the
    interpreter lock, and the stores take concurrent writes of distinct
    chunks. Returns (chunk ids, stats) in the chunks' order."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=max(1, min(len(chunks),
                                                   _PUBLISH_THREADS)),
                            thread_name_prefix="publish") as pool:
        chunk_ids = list(pool.map(chunk_store.write_chunk, chunks))
        stats = list(pool.map(chunk_store.read_stats, chunk_ids))
    return chunk_ids, stats


def publish_table_chunks(client, chunk_store, path, chunks,
                         sorted_by=None, schema=None) -> None:
    """THE static-table chunk attribute protocol (@schema/@chunk_ids/
    @chunk_stats/@row_count/@sorted_by) — one implementation shared by the
    in-process client and the remote thin client, so tables stay
    cross-readable whichever path wrote them. The chunks are written as
    `write_table_chunks` writes them."""
    chunk_ids, stats = write_table_chunks(chunk_store, chunks)
    total = sum(c.row_count for c in chunks)
    if schema is not None:
        client.set(path + "/@schema", schema.to_dict())
    client.set(path + "/@chunk_ids", chunk_ids)
    # Stats were computed ONCE at seal time (chunk meta header); reading
    # them back is a meta parse, not a host-side min/max recompute.
    client.set(path + "/@chunk_stats", stats)
    client.set(path + "/@row_count", total)
    if sorted_by:
        client.set(path + "/@sorted_by", list(sorted_by))
    elif client.exists(path + "/@sorted_by"):
        client.remove(path + "/@sorted_by", force=True)


def _normalize_per_tablet(ids) -> "list[list[str]]":
    """tablet_chunk_ids layout: nested per-tablet lists; migrate the old
    flat layout.  THE one normalizer — GC correctness depends on every
    reader agreeing (a missed variant mis-marks chunks unreferenced)."""
    if not ids:
        return []
    if isinstance(ids[0], str):
        return [list(ids)]
    return [list(sub) for sub in ids]


def _mc():
    from ytsaurus_tpu_torch.cypress import multicell
    return multicell


def _hedged_race(attempts: "list[Callable]", delay: float,
                 base_error: YtError):
    """rpc.channel.hedged_race with the replica-fallback error shape:
    base_error (the primary-table failure) is always the root cause."""
    from ytsaurus_tpu_torch.rpc.channel import hedged_race

    if not attempts:
        raise base_error
    try:
        return hedged_race(attempts, delay)
    except YtError as err:
        raise YtError("all hedged replica lookups failed",
                      code=base_error.code,
                      inner_errors=[base_error, err])


class YtClient:
    def __init__(self, cluster: YtCluster):
        self.cluster = cluster
        from ytsaurus_tpu_torch.operations.scheduler import OperationScheduler
        from ytsaurus_tpu_torch.query.statistics import QueryStatistics
        self.scheduler = OperationScheduler(self)
        self.last_query_statistics = QueryStatistics()
        self._computed_plans: dict = {}
        self._table_replicator = None
        self._query_tracker = None
        # Stagger between hedged replica lookups (hedging_channel.h).
        self.lookup_hedging_delay = 0.05

    @property
    def device(self):
        """The cluster's device: where this client's operation
        controllers sort, as a remote client's run on its own."""
        return self.cluster.device

    def exec_node_addresses(self) -> dict:
        """id -> address of data nodes hosting exec slots ({} in pure
        local mode, where jobs run in-process)."""
        if self.cluster.node_directory is None:
            return {}
        try:
            return dict(self.cluster.node_directory())
        except Exception:   # noqa: BLE001 — the directory is advisory
            return {}

    @property
    def table_replicator(self):
        """Lazy shared TableReplicator (caches remote-cluster clients)."""
        if self._table_replicator is None:
            from ytsaurus_tpu_torch.tablet.replication import TableReplicator
            self._table_replicator = TableReplicator(self)
        return self._table_replicator

    @property
    def query_tracker(self):
        """Lazy shared QueryTracker (ref server/query_tracker)."""
        if self._query_tracker is None:
            from ytsaurus_tpu_torch.server.query_tracker import QueryTracker
            self._query_tracker = QueryTracker(self)
        return self._query_tracker

    # ------------------------------------------------------------------ cypress

    def create(self, node_type: str, path: str,
               attributes: Optional[dict] = None, recursive: bool = False,
               ignore_existing: bool = False, tx: Optional[str] = None) -> str:
        from ytsaurus_tpu_torch.cypress import multicell
        if node_type == multicell.PORTAL_TYPE:
            multicell.reject_tx(tx)
            delegate = multicell.delegate_for(self, path, "write")
            if delegate is not None:
                # An entrance beneath another portal belongs to THAT
                # cell (chained portals).
                with multicell.as_cell_principal():
                    return delegate.create(
                        node_type, path, attributes=attributes,
                        recursive=recursive,
                        ignore_existing=ignore_existing)
            parent = path.rsplit("/", 1)[0] or "/"
            self.cluster.security.validate_permission("write", parent)
            return multicell.create_portal(self, path, attributes or {},
                                           recursive=recursive,
                                           ignore_existing=ignore_existing)
        delegate = multicell.delegate_for(self, path, "write")
        if delegate is not None:
            multicell.reject_tx(tx)
            with multicell.as_cell_principal():
                return delegate.create(node_type, path,
                                       attributes=attributes,
                                       recursive=recursive,
                                       ignore_existing=ignore_existing)
        parent = path.rsplit("/", 1)[0] or "/"
        self.cluster.security.validate_permission("write", parent)
        attributes = dict(attributes or {})
        if node_type == "table":
            schema = attributes.get("schema")
            if isinstance(schema, TableSchema):
                attributes["schema"] = schema.to_dict()
            elif isinstance(schema, (list, tuple)):
                # YT-style bare column list.
                attributes["schema"] = TableSchema.make(schema).to_dict()
            attributes.setdefault("dynamic", False)
            attributes.setdefault("chunk_ids", [])
            attributes.setdefault("row_count", 0)
        # Charge exactly the nodes this call will create: none when the
        # target pre-exists (ignore_existing), plus missing ancestors for
        # recursive creates.
        new_nodes = self._count_new_nodes(path, recursive)
        if new_nodes:
            self._charge(path, node_count=new_nodes)   # quota gate first
        try:
            return self.cluster.master.commit_mutation(
                "create", path=path, type=node_type, attributes=attributes,
                recursive=recursive, ignore_existing=ignore_existing, tx=tx)
        except YtError:
            if new_nodes:
                self._charge(path, node_count=-new_nodes)
            raise

    def _count_new_nodes(self, path: str, recursive: bool) -> int:
        tree = self.cluster.master.tree
        if tree.try_resolve(path) is not None:
            return 0
        if not recursive:
            return 1
        count = 1
        parent = path.rsplit("/", 1)[0]
        while parent and parent != "/" and \
                tree.try_resolve(parent) is None:
            count += 1
            parent = parent.rsplit("/", 1)[0]
        return count

    def get(self, path: str, tx: Optional[str] = None) -> Any:
        from ytsaurus_tpu_torch.cypress import multicell
        # Reading the entrance path resolves to the exit (like list).
        delegate = multicell.delegate_for(self, path, "read",
                                          include_self=True)
        if delegate is not None:
            multicell.reject_tx(tx)
            with multicell.as_cell_principal():
                return delegate.get(path)
        self.cluster.security.validate_permission("read", path)
        if tx is not None:
            # Snapshot-locked reads see the pinned copy.
            pinned = self.cluster.master.tx_manager.read_snapshot(tx, path)
            if pinned is not None:
                return pinned
        return self.cluster.master.tree.get(path)

    def set(self, path: str, value: Any, tx: Optional[str] = None) -> None:
        from ytsaurus_tpu_torch.cypress import multicell
        delegate = multicell.delegate_for(self, path, "write")
        if delegate is not None:
            multicell.reject_tx(tx)
            with multicell.as_cell_principal():
                return delegate.set(path, value)
        self.cluster.security.validate_permission("write", path)
        self.cluster.master.commit_mutation("set", path=path, value=value,
                                            tx=tx)

    def exists(self, path: str) -> bool:
        from ytsaurus_tpu_torch.cypress import multicell
        delegate = multicell.delegate_for(self, path, None)
        if delegate is not None:
            with multicell.as_cell_principal():
                return delegate.exists(path)
        return self.cluster.master.tree.exists(path)

    def list(self, path: str) -> list[str]:
        from ytsaurus_tpu_torch.cypress import multicell
        # Listing the entrance itself shows the EXIT's children.
        delegate = multicell.delegate_for(self, path, "read",
                                          include_self=True)
        if delegate is not None:
            with multicell.as_cell_principal():
                return delegate.list(path)
        self.cluster.security.validate_permission("read", path)
        return self.cluster.master.tree.list(path)

    # -- master transactions / locks ------------------------------------------
    # (ref: master transactions + cypress locks, transaction_server and
    # node_detail.h; commands mirror the driver's start_tx/lock surface)

    def start_tx(self, parent: Optional[str] = None) -> str:
        return self.cluster.master.commit_mutation("tx_start",
                                                   parent_id=parent)

    def commit_tx(self, tx: str) -> None:
        self.cluster.master.commit_mutation("tx_commit", tx_id=tx)

    def abort_tx(self, tx: str) -> None:
        self.cluster.master.commit_mutation("tx_abort", tx_id=tx)

    def lock(self, path: str, mode: str = "exclusive",
             tx: Optional[str] = None) -> None:
        _mc().reject_under_portal(self, path, "lock")
        if tx is None:
            raise YtError("lock requires a transaction")
        self.cluster.master.commit_mutation("lock", tx_id=tx, path=path,
                                            mode=mode)

    # -- accounts / quota metering ---------------------------------------------

    def _charge(self, path: str, **deltas) -> None:
        """Meter account usage; quota violations raise BEFORE data lands."""
        security = self.cluster.security
        account = security.account_of(path)
        if self.exists(f"//sys/accounts/{account}"):
            security.charge_account(account, **deltas)

    def copy(self, src_path: str, dst_path: str,
             recursive: bool = False) -> str:
        """Deep-copy a subtree.  Static-table chunks are shared by
        reference (never deleted while ANY table references them — the GC
        counts both copies); dynamic-table chunks are physically duplicated
        because compaction/reshard delete the source's chunk files.
        Mounted dynamic tables must unmount first."""
        _mc().reject_under_portal(self, src_path, "copy")
        _mc().reject_under_portal(self, dst_path, "copy")
        src_node = self.cluster.master.tree.try_resolve(src_path)
        if src_node is not None:
            stack = [src_node]
            while stack:
                current = stack.pop()
                if current.id in self.cluster.tablets:
                    raise YtError(
                        f"Unmount dynamic tables under {src_path!r} before "
                        "copying", code=EErrorCode.TabletNotMounted)
                stack.extend(current.children.values())
        node_id = self.cluster.master.commit_mutation(
            "copy", src=src_path, dst=dst_path, recursive=recursive)
        self._duplicate_dynamic_chunks(dst_path)
        return node_id

    def _duplicate_dynamic_chunks(self, path: str) -> None:
        """Give copied dynamic tables their own chunk files (their sources
        delete chunks on compaction/reshard)."""
        tree = self.cluster.master.tree
        node = tree.try_resolve(path)
        if node is None:
            return
        stack = [(path, node)]
        while stack:
            node_path, current = stack.pop()
            if current.type == "table" and current.attributes.get("dynamic"):
                per_tablet = _normalize_per_tablet(
                    current.attributes.get("tablet_chunk_ids", []))
                fresh = []
                for ids in per_tablet:
                    fresh.append([
                        self.cluster.chunk_store.write_chunk(
                            self.cluster.chunk_store.read_chunk(
                                cid, device=self.cluster.device))
                        for cid in ids])
                if fresh:
                    self.set(node_path + "/@tablet_chunk_ids", fresh)
            for name, child in current.children.items():
                stack.append((f"{node_path}/{name}", child))

    def move(self, src_path: str, dst_path: str,
             recursive: bool = False) -> str:
        _mc().reject_under_portal(self, src_path, "move")
        _mc().reject_under_portal(self, dst_path, "move")
        node = self.cluster.master.tree.try_resolve(src_path)
        if node is not None and node.id in self.cluster.tablets:
            raise YtError(f"Unmount {src_path!r} before moving it",
                          code=EErrorCode.TabletNotMounted)
        return self.cluster.master.commit_mutation(
            "move", src=src_path, dst=dst_path, recursive=recursive)

    def link(self, target_path: str, link_path: str,
             recursive: bool = False) -> str:
        _mc().reject_under_portal(self, target_path, "link")
        _mc().reject_under_portal(self, link_path, "link")
        return self.cluster.master.commit_mutation(
            "link", target=target_path, link=link_path, recursive=recursive)

    def remove(self, path: str, recursive: bool = True,
               force: bool = False, tx: Optional[str] = None) -> None:
        from ytsaurus_tpu_torch.cypress import multicell
        delegate = multicell.delegate_for(self, path, "remove")
        if delegate is not None:
            multicell.reject_tx(tx)
            with multicell.as_cell_principal():
                return delegate.remove(path, recursive=recursive,
                                       force=force)
        self.cluster.security.validate_permission("remove", path)
        node = self.cluster.master.tree.try_resolve(path)
        if node is not None and node.type == multicell.PORTAL_TYPE \
                and "/@" not in path:
            # Entrance removal dismantles the exit subtree on its cell
            # (exactly-once via Hive, AFTER the primary removal commits).
            return multicell.remove_portal(self, path,
                                           dict(node.attributes),
                                           recursive=recursive, tx=tx)
        nested_portals = []
        if node is not None and "/@" not in path:
            # Entrances INSIDE the removed subtree must dismantle their
            # exits too, or the secondary cell leaks the subtree (and a
            # recreated portal would resurrect stale data under it).
            # Collected now, dismantled only after the primary removal
            # COMMITS — a refused/failed remove must not destroy exit
            # data — which also means such a removal cannot ride a
            # rollback-able transaction.
            nested_portals = multicell.portals_under(path, node)
            if nested_portals:
                multicell.reject_tx(tx)
        # One subtree walk: tally metered usage + find mounted tables.
        freed_nodes, freed_disk, freed_chunks = 0, 0, 0
        mounted: list[str] = []
        if node is not None and "/@" not in path:
            stack = [node]
            while stack:
                current = stack.pop()
                freed_nodes += 1
                usage = current.attributes.get("resource_usage") or {}
                freed_disk += int(usage.get("disk_space", 0))
                freed_chunks += int(usage.get("chunk_count", 0))
                if current.id in self.cluster.tablets:
                    mounted.append(current.id)
                stack.extend(current.children.values())
        if tx is not None and mounted:
            # A transactional remove can be rolled back, but tablet
            # eviction cannot — refuse rather than strand a restored
            # dynamic table without its tablets.
            raise YtError(
                f"Unmount dynamic tables under {path!r} before a "
                "transactional remove", code=EErrorCode.TabletNotMounted)
        account = self.cluster.security.account_of(path)
        # Mutation FIRST (it can fail on a lock conflict); irreversible
        # side effects — tablet eviction, quota credit — only after it
        # lands.  Transactional removes skip the quota credit: an abort
        # restores the nodes, and usage must still cover them.
        self.cluster.master.commit_mutation(
            "remove", path=path, recursive=recursive, force=force, tx=tx)
        for entrance_path, cell_root in nested_portals:
            multicell._dismantle_exit(self, cell_root, entrance_path)
        for node_id in mounted:
            for tablet in self.cluster.tablets.pop(node_id, ()):
                tablet.set_in_memory(False)
        if tx is None and (freed_nodes or freed_disk or freed_chunks):
            if self.exists(f"//sys/accounts/{account}"):
                self.cluster.security.charge_account(
                    account, node_count=-freed_nodes,
                    disk_space=-freed_disk, chunk_count=-freed_chunks)

    def referenced_chunk_ids(self) -> set:
        """Every chunk id rooted by the metadata tree or live runtime
        tablet state (tables, per-tablet stores, ordered stores,
        operation snapshots).  Hunk chunks are NOT resolved here — their
        liveness needs a meta read per data chunk (see collect_garbage).
        Shared by GC (what to keep) and the chunk replicator (what is
        worth re-replicating).  Walks under the master's mutation lock:
        the replicator calls this from its scan thread and a mutating
        dict mid-iteration would abort the walk."""
        with self.cluster.master.mutation_lock:
            return self._referenced_chunk_ids_locked()

    def _referenced_chunk_ids_locked(self) -> set:
        referenced: set = set()
        stack = [self.cluster.master.tree.root]
        while stack:
            node = stack.pop()
            if node.type == "table":
                referenced.update(node.attributes.get("chunk_ids", []))
                for sub in _normalize_per_tablet(
                        node.attributes.get("tablet_chunk_ids", [])):
                    referenced.update(sub)
                state = node.attributes.get("ordered_state") or {}
                referenced.update(state.get("chunk_ids", []))
            # Operation snapshots root their per-stripe output chunks:
            # revival after a controller death must still find them.
            snap = node.attributes.get("snapshot")
            if isinstance(snap, dict):
                referenced.update(
                    cid for cid in (snap.get("completed") or {}).values()
                    if cid)
            stack.extend(node.children.values())
        # The master lock covers the tree, not cluster.tablets (mount/
        # unmount mutate it lock-free): snapshot the dict and each
        # tablet list in one C-level pass so a concurrent mount cannot
        # abort the replicator's walk mid-iteration.
        for tablets in list(self.cluster.tablets.values()):
            for tablet in list(tablets):
                referenced.update(tablet.chunk_ids)
        # Written-but-unpublished chunks (chunk merger's CAS window).
        referenced.update(self.cluster.protected_chunk_ids)
        return referenced

    def collect_garbage(self) -> int:
        """Remove chunk files referenced by no table (ref: the master's
        object GC sweeping unreferenced chunks, object_server).  Returns the
        number of chunks removed.  Runtime tablet state counts as a
        reference (mounted tables may hold chunks not yet persisted), and
        the sweep refuses to run while operations are in flight — a
        controller writes chunk files before publishing @chunk_ids."""
        for op in self.scheduler.list_operations():
            if op.state in ("pending", "running"):
                raise YtError(
                    f"Cannot collect garbage while operation {op.id} is "
                    f"{op.state}", code=EErrorCode.OperationFailed)
        referenced = self.referenced_chunk_ids()
        # Hunk chunks are live iff a live data chunk's meta references them
        # (ref hunk_chunk_sweeper: ref-counted hunk chunk attachment).
        # The meta pass costs a read per live chunk, so only hunk-bearing
        # stores pay it.
        from ytsaurus_tpu_torch.chunks.hunks import is_hunk_id
        store = self.cluster.chunk_store
        all_ids = store.list_chunks()
        if any(is_hunk_id(cid) for cid in all_ids):
            for cid in all_ids:
                if cid in referenced and not is_hunk_id(cid):
                    try:
                        referenced.update(
                            store.read_meta(cid).get("hunk_chunk_ids", []))
                    except YtError:
                        pass
        removed = 0
        for cid in all_ids:
            if cid not in referenced:
                store.remove_chunk(cid)
                self.cluster.chunk_cache.invalidate(cid)
                removed += 1
        return removed

    # ------------------------------------------------------------- static tables

    def write_table(self, path: str, rows: "Sequence[dict] | bytes",
                    append: bool = False,
                    schema: "TableSchema | dict | None" = None,
                    format: Optional[str] = None) -> None:
        from ytsaurus_tpu_torch.cypress import multicell
        delegate = multicell.delegate_for(self, path, "write")
        if delegate is not None:
            with multicell.as_cell_principal():
                return delegate.write_table(path, rows, append=append,
                                            schema=schema, format=format)
        self.cluster.security.validate_permission("write", path)
        if format == "arrow":
            from ytsaurus_tpu_torch.arrow import (
                arrow_ipc_to_rows,
                arrow_schema_to_table_schema,
            )
            if schema is None:
                import pyarrow as _pa
                with _pa.ipc.open_stream(rows) as reader:
                    schema = arrow_schema_to_table_schema(reader.schema)
            rows = arrow_ipc_to_rows(rows)
        elif format == "skiff":
            from ytsaurus_tpu_torch.formats import loads_skiff
            if schema is None:
                raise YtError("skiff writes require a schema",
                              code=EErrorCode.QueryUnsupported)
            if not isinstance(schema, TableSchema):
                schema = TableSchema.from_dict(schema)
            rows = loads_skiff(rows, schema)
        elif format is not None:
            from ytsaurus_tpu_torch.formats import loads_rows
            columns = None
            if isinstance(schema, TableSchema):
                columns = schema.column_names
            rows = loads_rows(rows, format, columns=columns)
        node = self._table_node(path, create=True, schema=schema)
        if node.attributes.get("dynamic"):
            raise YtError("write_table on a dynamic table; use insert_rows",
                          code=EErrorCode.QueryUnsupported)
        table_schema = self._node_schema(node)
        if table_schema is None and rows:
            table_schema = infer_schema(rows)
            self.set(path + "/@schema", table_schema.to_dict())
        chunks: list[str] = list(node.attributes.get("chunk_ids", [])) \
            if append else []
        stats: list = list(node.attributes.get("chunk_stats", [])) \
            if append else []
        # Keep stats aligned with chunk_ids even for pre-stats tables.
        while len(stats) < len(chunks):
            stats.append({})
        row_count = int(node.attributes.get("row_count", 0)) if append else 0
        if rows:
            chunk = ColumnarChunk.from_rows(table_schema, list(rows),
                                            device=self.cluster.device)
            self._meter_table(path, node, chunk_delta=1,
                              disk_delta=chunk.nbytes)
            cid = self.cluster.chunk_store.write_chunk(chunk)
            chunks.append(cid)
            stats.append(self.cluster.chunk_store.read_stats(cid))
            row_count += chunk.row_count
        self.set(path + "/@chunk_ids", chunks)
        self.set(path + "/@chunk_stats", stats)
        self.set(path + "/@row_count", row_count)
        # Arbitrary rows invalidate any prior sort guarantee.
        if "sorted_by" in node.attributes:
            self.cluster.master.commit_mutation(
                "remove", path=path + "/@sorted_by", force=True)

    def _meter_table(self, path: str, node, chunk_delta: int,
                     disk_delta: int) -> None:
        """Account charge for new chunk data + per-node usage bookkeeping
        (the remove path frees from @resource_usage)."""
        self._charge(path, disk_space=disk_delta, chunk_count=chunk_delta)
        usage = dict(node.attributes.get("resource_usage") or {})
        usage["disk_space"] = int(usage.get("disk_space", 0)) + disk_delta
        usage["chunk_count"] = int(usage.get("chunk_count", 0)) + chunk_delta
        self.cluster.master.commit_mutation(
            "set", path=path + "/@resource_usage", value=usage)

    def read_table(self, path: str, format: Optional[str] = None):
        """Rows as dicts, or serialized bytes when `format` is given
        (yson/json/dsv/schemaful_dsv/skiff/arrow — ref client/formats,
        client/arrow)."""
        from ytsaurus_tpu_torch.cypress import multicell
        delegate = multicell.delegate_for(self, path, "read")
        if delegate is not None:
            with multicell.as_cell_principal():
                return delegate.read_table(path, format=format)
        self.cluster.security.validate_permission("read", path)
        chunks = self._read_table_chunks(path)
        if format == "arrow":
            # Columnar fast path: planes → arrow arrays, no row walk.
            from ytsaurus_tpu_torch.arrow import chunks_to_arrow_ipc
            if not chunks:
                schema = self._node_schema(self._table_node(path))
                if schema is None:
                    raise YtError(
                        "arrow reads of an empty schemaless table need "
                        "a schema", code=EErrorCode.QueryUnsupported)
                chunks = [ColumnarChunk.from_rows(
                    schema.to_unsorted(), [], device=self.cluster.device)]
            return chunks_to_arrow_ipc(chunks)
        rows: list[dict] = []
        for chunk in chunks:
            rows.extend(chunk.to_rows())
        if format is None:
            return rows
        node = self._table_node(path)
        schema = self._node_schema(node)
        if format == "skiff":
            from ytsaurus_tpu_torch.formats import dumps_skiff
            if schema is None:
                schema = infer_schema(rows)
            return dumps_skiff(rows, schema)
        from ytsaurus_tpu_torch.formats import dumps_rows
        columns = schema.column_names if schema else None
        return dumps_rows(rows, format, columns=columns)

    # ------------------------------------------------------------ dynamic tables

    def mount_table(self, path: str) -> None:
        _mc().reject_under_portal(self, path, "mount_table")
        self.cluster.security.validate_permission("mount", path)
        node = self._table_node(path)
        schema = self._node_schema(node)
        if schema is None:
            raise YtError("mount_table requires a schema",
                          code=EErrorCode.TabletNotMounted)
        if not node.attributes.get("dynamic"):
            raise YtError(f"Table {path!r} is not dynamic; "
                          "create with attributes={'dynamic': True}",
                          code=EErrorCode.TabletNotMounted)
        if node.id in self.cluster.tablets:
            return
        if schema.is_sorted:
            # One tablet per pivot range (ref: tablet pivot keys,
            # server/master/tablet_server; partition.h range sharding).
            pivots = [tuple(p) for p in node.attributes.get("pivot_keys", [])]
            per_tablet = _normalize_per_tablet(
                node.attributes.get("tablet_chunk_ids", []))
            tablets = []
            for i in range(len(pivots) + 1):
                tablet = Tablet(schema, self.cluster.chunk_store,
                                tablet_id=f"{node.id}-{i}",
                                pivot_key=pivots[i - 1] if i else None,
                                chunk_cache=self.cluster.chunk_cache,
                                device=self.cluster.device)
                tablet.chunk_ids = list(per_tablet[i]) \
                    if i < len(per_tablet) else []
                tablets.append(tablet)
            self.cluster.tablets[node.id] = tablets
        else:
            # Unsorted dynamic schema → ordered (queue) table.
            from ytsaurus_tpu_torch.tablet.ordered import OrderedTablet
            tablet = OrderedTablet(schema, self.cluster.chunk_store,
                                   tablet_id=f"{node.id}-0",
                                   chunk_cache=self.cluster.chunk_cache,
                                   device=self.cluster.device)
            state = node.attributes.get("ordered_state") or {}
            tablet.chunk_ids = list(state.get("chunk_ids", []))
            tablet.chunk_ranges = [tuple(r) for r in state.get("ranges", [])]
            tablet.base_index = int(state.get("base_index", 0))
            tablet.trimmed_count = int(state.get("trimmed_count", 0))
            self.cluster.tablets[node.id] = [tablet]
        # In-memory mode: tablets own their pins so flush/compact-created
        # chunks stay resident too (ref EInMemoryMode none/uncompressed).
        if node.attributes.get("in_memory_mode", "none") != "none":
            for tablet in self.cluster.tablets[node.id]:
                tablet.set_in_memory(True)
        self.set(path + "/@tablet_state", "mounted")

    def unmount_table(self, path: str) -> None:
        _mc().reject_under_portal(self, path, "unmount_table")
        node = self._table_node(path)
        tablets = self.cluster.tablets.pop(node.id, None)
        if tablets is None:
            # Not materialized in this connection — still record the state
            # so other connections stop lazily re-mounting it.
            if node.attributes.get("tablet_state") == "mounted":
                self.set(path + "/@tablet_state", "unmounted")
            return
        from ytsaurus_tpu_torch.tablet.ordered import OrderedTablet
        for tablet in tablets:
            tablet.flush()
            tablet.set_in_memory(False)
            tablet.mounted = False
        if isinstance(tablets[0], OrderedTablet):
            t = tablets[0]
            self.set(path + "/@ordered_state", {
                "chunk_ids": t.chunk_ids,
                "ranges": [list(r) for r in t.chunk_ranges],
                "base_index": t.base_index,
                "trimmed_count": t.trimmed_count})
        else:
            self.set(path + "/@tablet_chunk_ids",
                     [list(t.chunk_ids) for t in tablets])
        self.set(path + "/@tablet_state", "unmounted")

    def reshard_table(self, path: str, pivot_keys: Sequence[tuple]) -> None:
        _mc().reject_under_portal(self, path, "reshard_table")
        """Re-shard an (unmounted) sorted dynamic table into len(pivots)+1
        tablets; existing data redistributes to the new ranges.

        Ref: tablet_server reshard with pivot keys (tablet_manager.h);
        here redistribution rewrites the versioned chunks per range."""
        from ytsaurus_tpu_torch.tablet.dynamic_store import _null_safe
        from ytsaurus_tpu_torch.tablet.tablet import (
            _versioned_sort_key,
            versioned_schema,
        )
        node = self._table_node(path)
        if node.id in self.cluster.tablets:
            raise YtError(f"Table {path!r} must be unmounted to reshard",
                          code=EErrorCode.TabletNotMounted)
        schema = self._node_schema(node)
        if schema is None or not schema.is_sorted or \
                not node.attributes.get("dynamic"):
            raise YtError("reshard_table requires a sorted dynamic table",
                          code=EErrorCode.TabletNotMounted)
        from ytsaurus_tpu_torch.tablet.tablet import _normalize_value
        key_cols = schema.key_columns
        key_width = len(key_cols)
        pivots = []
        for p in pivot_keys:
            p = tuple(p)
            if len(p) != key_width:
                raise YtError(f"Pivot {p!r} width != key width {key_width}")
            pivots.append(tuple(_normalize_value(v, c.type)
                                for v, c in zip(p, key_cols)))
        safe_pivots = [_null_safe(p) for p in pivots]
        if any(a >= b for a, b in zip(safe_pivots, safe_pivots[1:])):
            raise YtError("Pivot keys must be strictly increasing")

        # Redistribute existing versioned chunks into the new ranges.
        old = _normalize_per_tablet(
            node.attributes.get("tablet_chunk_ids", []))
        all_rows: list[dict] = []
        for ids in old:
            for cid in ids:
                all_rows.extend(self.cluster.chunk_store.read_chunk(
                    cid, device=self.cluster.device).to_rows())
        key_names = schema.key_column_names
        buckets: list[list[dict]] = [[] for _ in range(len(pivots) + 1)]
        for row in all_rows:
            sk = _null_safe(tuple(row[name] for name in key_names))
            idx = 0
            for i, sp in enumerate(safe_pivots):
                if sk >= sp:
                    idx = i + 1
            buckets[idx].append(row)
        vschema = versioned_schema(schema)
        per_tablet_ids: list[list[str]] = []
        for bucket in buckets:
            if bucket:
                bucket.sort(key=_versioned_sort_key(schema))
                chunk = ColumnarChunk.from_rows(
                    vschema, bucket, device=self.cluster.device)
                per_tablet_ids.append(
                    [self.cluster.chunk_store.write_chunk(chunk)])
            else:
                per_tablet_ids.append([])
        for ids in old:
            for cid in ids:
                self.cluster.chunk_store.remove_chunk(cid)
                self.cluster.chunk_cache.invalidate(cid)
        self.set(path + "/@pivot_keys", [list(p) for p in pivots])
        self.set(path + "/@tablet_chunk_ids", per_tablet_ids)
        self.set(path + "/@tablet_count", len(pivots) + 1)

    # queue (ordered table) API — ref queue_client

    def push_queue(self, path: str, rows: Sequence[dict]) -> int:
        """Append rows to an ordered table; returns first $row_index."""
        (tablet,) = self._mounted_tablets(path)
        from ytsaurus_tpu_torch.tablet.ordered import OrderedTablet
        if not isinstance(tablet, OrderedTablet):
            raise YtError(f"{path!r} is not an ordered table",
                          code=EErrorCode.QueryUnsupported)
        ts = self.cluster.transactions.timestamps.generate()
        return tablet.append_rows(list(rows), ts)

    def pull_queue(self, path: str, offset: int = 0,
                   limit: Optional[int] = None) -> list[dict]:
        (tablet,) = self._mounted_tablets(path)
        self._require_ordered(tablet, path)
        return tablet.read_rows(offset, limit)

    def trim_rows(self, path: str, trimmed_count: int) -> None:
        (tablet,) = self._mounted_tablets(path)
        self._require_ordered(tablet, path)
        tablet.trim_rows(trimmed_count)

    # ------------------------------------------------------ queue consumers

    def register_queue_consumer(self, queue_path: str, consumer_path: str,
                                vital: bool = True) -> None:
        from ytsaurus_tpu_torch.server.queue_agent import register_consumer
        register_consumer(self, queue_path, consumer_path, vital=vital)

    def unregister_queue_consumer(self, queue_path: str,
                                  consumer_path: str) -> None:
        from ytsaurus_tpu_torch.server.queue_agent import unregister_consumer
        unregister_consumer(self, queue_path, consumer_path)

    def advance_consumer(self, consumer_path: str, queue_path: str,
                         new_offset: int,
                         old_offset: Optional[int] = None) -> None:
        from ytsaurus_tpu_torch.server.queue_agent import advance_consumer
        advance_consumer(self, consumer_path, queue_path, new_offset,
                         old_offset=old_offset)

    def pull_consumer(self, consumer_path: str, queue_path: str,
                      limit: Optional[int] = None
                      ) -> "tuple[list[dict], int]":
        from ytsaurus_tpu_torch.server.queue_agent import pull_consumer
        return pull_consumer(self, consumer_path, queue_path, limit=limit)

    # ------------------------------------------------- materialized views

    def create_materialized_view(self, name: str, query: str,
                                 source: Optional[str] = None,
                                 target: Optional[str] = None,
                                 pool: str = "views",
                                 batch_rows: Optional[int] = None) -> dict:
        """Register a continuous query: a daemon-tailed
        incremental view over an ordered table, exactly-once into a
        sorted target readable by normal selects (query/views.py)."""
        from ytsaurus_tpu_torch.query.views import create_materialized_view
        return create_materialized_view(
            self, name, query, source=source, target=target, pool=pool,
            batch_rows=batch_rows)

    def list_views(self) -> list[str]:
        from ytsaurus_tpu_torch.query.views import list_views
        return list_views(self)

    def get_view(self, name: str) -> dict:
        from ytsaurus_tpu_torch.query.views import view_status
        return view_status(self, name)

    def pause_view(self, name: str) -> dict:
        from ytsaurus_tpu_torch.query.views import set_view_state
        return set_view_state(self, name, "paused")

    def resume_view(self, name: str) -> dict:
        from ytsaurus_tpu_torch.query.views import set_view_state
        return set_view_state(self, name, "running")

    def remove_view(self, name: str, drop_target: bool = False) -> None:
        from ytsaurus_tpu_torch.query.views import remove_view
        remove_view(self, name, drop_target=drop_target)

    def refresh_view(self, name: str, max_batches: int = 0) -> dict:
        """Drain one view's cursor inline (no daemon): the CLI/driver
        verb behind `yt view refresh` and the test/bench loop."""
        from ytsaurus_tpu_torch.query.views import ViewRefresher, load_view
        refresher = ViewRefresher(self, load_view(self, name))
        return refresher.refresh(max_batches=max_batches)

    @staticmethod
    def _require_ordered(tablet, path: str) -> None:
        from ytsaurus_tpu_torch.tablet.ordered import OrderedTablet
        if not isinstance(tablet, OrderedTablet):
            raise YtError(f"{path!r} is not an ordered (queue) table",
                          code=EErrorCode.QueryUnsupported)

    def _route_rows(self, path: str, tablets, rows):
        """Group rows by owning tablet (pivot ranges); bisect over the
        tablets' own (already normalized) pivot keys."""
        import bisect

        from ytsaurus_tpu_torch.tablet.dynamic_store import _null_safe
        safe_pivots = [
            _null_safe(tablets[0].normalize_key(tuple(t.pivot_key)))
            for t in tablets[1:]]
        out: dict[int, list] = {}
        for row in rows:
            key = tablets[0].active_store.key_of(row) \
                if isinstance(row, dict) else tuple(row)
            sk = _null_safe(tablets[0].normalize_key(key))
            idx = bisect.bisect_right(safe_pivots, sk)
            out.setdefault(idx, []).append(row)
        return out

    @staticmethod
    def _require_sorted(tablet, path: str) -> None:
        from ytsaurus_tpu_torch.tablet.ordered import OrderedTablet
        if isinstance(tablet, OrderedTablet):
            raise YtError(f"{path!r} is an ordered table; this operation "
                          "requires a sorted dynamic table",
                          code=EErrorCode.QueryUnsupported)

    def freeze_table(self, path: str) -> None:
        for tablet in self._mounted_tablets(path):
            tablet.flush()
        self._persist_tablet_chunks(path)

    def compact_table(self, path: str,
                      retention_timestamp: Optional[int] = None) -> None:
        ts = retention_timestamp if retention_timestamp is not None else \
            self.cluster.transactions.timestamps.generate()
        for tablet in self._mounted_tablets(path):
            self._require_sorted(tablet, path)
            tablet.flush()
            tablet.compact(retention_timestamp=ts)
        self._persist_tablet_chunks(path)

    def start_transaction(self) -> TabletTransaction:
        return self.cluster.transactions.start()

    def commit_transaction(self, tx: TabletTransaction) -> int:
        self._finalize_tx(tx)
        commit_ts = self.cluster.transactions.commit(tx)
        # Sync-replica checkpoints for writes staged under this caller-owned
        # transaction (kept on the tx so an abort advances nothing).
        for path, sync_targets, era0 in getattr(
                tx, "pending_sync_advances", []):
            self._advance_sync_checkpoints(path, sync_targets, commit_ts)
            self._recheck_replication_era(path, era0, commit_ts)
        return commit_ts

    def abort_transaction(self, tx: TabletTransaction) -> None:
        self.cluster.transactions.abort(tx)

    def insert_rows(self, path: str, rows: Sequence[dict],
                    tx: Optional[TabletTransaction] = None,
                    update: bool = False) -> Optional[int]:
        """update=True: write only the provided columns; missing ones merge
        per column from older versions (ref ModifyRows update mode +
        versioned_row_merger partial writes)."""
        tablets = self._mounted_tablets(path)
        rows = self._fill_computed_columns(tablets[0].schema, list(rows))
        from ytsaurus_tpu_torch.tablet.ordered import OrderedTablet
        if isinstance(tablets[0], OrderedTablet):
            if tx is not None:
                raise YtError("Transactional writes to ordered tables are "
                              "not supported yet",
                              code=EErrorCode.QueryUnsupported)
            self.push_queue(path, rows)
            return None
        txm = self.cluster.transactions
        own = tx is None
        tx = tx or txm.start()
        # Secondary-index rows ride the same transaction; the net mutation
        # set is computed at commit (finalize_index_mutations).
        from ytsaurus_tpu_torch.tablet.secondary_index import record_index_intent
        record_index_intent(self, tx, path, self._table_node(path),
                            tablets[0].schema, list(rows), None, update)
        for idx, part in self._route_rows(path, tablets, list(rows)).items():
            txm.write_rows(tx, tablets[idx], part, update=update)
        # Sync replicas join the SAME 2PC commit (ref transaction.cpp:737
        # sync-replica fanout): their tablets are extra participants, so a
        # broken sync replica fails the write before anything commits.
        era0, sync_targets = self._replication_state(path)
        for rid, rc, rpath in sync_targets:
            rtablets = rc._mounted_tablets(rpath)
            for idx, part in rc._route_rows(rpath, rtablets,
                                            list(rows)).items():
                txm.write_rows(tx, rtablets[idx], part, update=update)
        if own:
            self._finalize_tx(tx)
            commit_ts = txm.commit(tx)
            self._advance_sync_checkpoints(path, sync_targets, commit_ts)
            self._recheck_replication_era(path, era0, commit_ts)
            return commit_ts
        if sync_targets or era0 is not None:
            tx.pending_sync_advances = getattr(
                tx, "pending_sync_advances", []) + \
                [(path, sync_targets, era0)]
        return None

    def delete_rows(self, path: str, keys: Sequence[tuple],
                    tx: Optional[TabletTransaction] = None) -> Optional[int]:
        tablets = self._mounted_tablets(path)
        self._require_sorted(tablets[0], path)
        keys = self._fill_computed_keys(tablets[0].schema,
                                        [tuple(k) for k in keys])
        txm = self.cluster.transactions
        own = tx is None
        tx = tx or txm.start()
        from ytsaurus_tpu_torch.tablet.secondary_index import record_index_intent
        record_index_intent(self, tx, path, self._table_node(path),
                            tablets[0].schema, None, keys, False)
        for idx, part in self._route_rows(
                path, tablets, keys).items():
            txm.delete_rows(tx, tablets[idx], part)
        era0, sync_targets = self._replication_state(path)
        for rid, rc, rpath in sync_targets:
            rtablets = rc._mounted_tablets(rpath)
            for idx, part in rc._route_rows(rpath, rtablets, keys).items():
                txm.delete_rows(tx, rtablets[idx], part)
        if own:
            self._finalize_tx(tx)
            commit_ts = txm.commit(tx)
            self._advance_sync_checkpoints(path, sync_targets, commit_ts)
            self._recheck_replication_era(path, era0, commit_ts)
            return commit_ts
        if sync_targets or era0 is not None:
            tx.pending_sync_advances = getattr(
                tx, "pending_sync_advances", []) + \
                [(path, sync_targets, era0)]
        return None

    # --------------------------------------------------------------- replication

    def create_table_replica(self, table_path: str, replica_path: str,
                             cluster_root: Optional[str] = None,
                             mode: str = "async",
                             enabled: bool = True) -> str:
        """Register a replica of a replicated (dynamic) table.  The replica
        table must exist (same schema) on the target cluster; cluster_root
        None means this cluster.  Ref: CreateTableReplica
        (client/api/client.h), table_replica objects (tablet_server)."""
        from ytsaurus_tpu_torch.tablet import replication as repl
        if mode not in ("sync", "async"):
            raise YtError(f"Bad replica mode {mode!r}",
                          code=EErrorCode.QueryTypeError)
        self._table_node(table_path)
        replicas = repl.replica_descriptors(self, table_path)
        rid = f"replica-{len(replicas)}"
        while rid in replicas:
            rid = rid + "-1"
        replicas[rid] = {"path": replica_path, "cluster_root": cluster_root,
                         "mode": mode, "enabled": bool(enabled),
                         "last_replicated_ts": 0, "error": None}
        repl.set_replica_descriptors(self, table_path, replicas)
        return rid

    def alter_table_replica(self, table_path: str, replica_id: str,
                            mode: Optional[str] = None,
                            enabled: Optional[bool] = None) -> None:
        from ytsaurus_tpu_torch.tablet import replication as repl
        replicas = repl.replica_descriptors(self, table_path)
        if replica_id not in replicas:
            raise YtError(f"No such replica {replica_id!r}",
                          code=EErrorCode.ResolveError)
        if mode is not None:
            if mode not in ("sync", "async"):
                raise YtError(f"Bad replica mode {mode!r}",
                              code=EErrorCode.QueryTypeError)
            replicas[replica_id]["mode"] = mode
        if enabled is not None:
            replicas[replica_id]["enabled"] = bool(enabled)
        repl.set_replica_descriptors(self, table_path, replicas)

    def get_table_replicas(self, table_path: str) -> dict:
        from ytsaurus_tpu_torch.tablet import replication as repl
        return repl.replica_descriptors(self, table_path)

    def _finalize_tx(self, tx) -> None:
        """Pre-commit hook: stage net secondary-index mutations recorded
        under this transaction."""
        from ytsaurus_tpu_torch.tablet.secondary_index import (
            finalize_index_mutations,
        )
        finalize_index_mutations(self, self.cluster.transactions, tx)

    def _sync_replica_targets(self, path: str):
        """(replica_id, replica_client, replica_path) for each enabled
        sync replica of `path` (empty for non-replicated tables)."""
        return self._replication_state(path)[1]

    def _replication_state(self, path: str):
        """(era, sync_targets) in one node read.  era is None for a
        plain non-replicated table (the common case pays one attribute
        probe and nothing else); otherwise it is the replication-card
        era observed for this write, re-checked after commit so a commit
        racing a chaos sync cutover re-delivers its events to the new
        configuration (chaos_agent.h era semantics)."""
        from ytsaurus_tpu_torch.tablet import replication as repl
        node = self._table_node(path)
        replicas = node.attributes.get(repl.REPLICAS_ATTR) or {}
        card = node.attributes.get("replication_card")
        if not replicas and not card:
            return None, []
        era = int(card["era"]) if card else 0
        out = []
        for rid, info in replicas.items():
            if info.get("enabled") and info.get("mode") == "sync":
                rc = self.table_replicator.replica_client(
                    info.get("cluster_root"))
                out.append((rid, rc, info["path"]))
        return era, out


    def _recheck_replication_era(self, path: str, era0,
                                 commit_ts: int) -> None:
        """Post-commit era check: a chaos sync cutover that raced this
        commit may have enrolled a sync replica the fanout missed;
        re-deliver the commit's events to the current configuration
        (idempotent over preserved timestamps)."""
        if era0 is None:
            return
        from ytsaurus_tpu_torch.tablet import chaos
        if chaos.current_era(self, path) != era0:
            chaos.redeliver_commit(self, path, commit_ts)

    def _advance_sync_checkpoints(self, path: str, sync_targets,
                                  commit_ts: int) -> None:
        if not sync_targets:
            return
        from ytsaurus_tpu_torch.tablet import replication as repl
        replicas = repl.replica_descriptors(self, path)
        for rid, _rc, _rpath in sync_targets:
            if rid in replicas:
                replicas[rid]["last_replicated_ts"] = commit_ts
        repl.set_replica_descriptors(self, path, replicas)

    def lookup_rows(self, path: str, keys: Sequence[tuple],
                    timestamp: int = MAX_TIMESTAMP,
                    column_names: Optional[Sequence[str]] = None,
                    replica_fallback: bool = False,
                    timeout: Optional[float] = None,
                    pool: Optional[str] = None
                    ) -> list[Optional[dict]]:
        """Point reads.  Routed through the cluster's QueryGateway
        (query/serving.py): concurrent lookups against one table
        coalesce into micro-batches with parallel per-tablet fan-out,
        under per-pool admission control and a deadline (`timeout`
        seconds, default ServingConfig.default_timeout).

        replica_fallback=True: when the upstream table is
        unavailable, read from the replicas — HEDGED, not sequential
        (core/rpc/hedging_channel.h): the best replica (sync first, then
        freshest) starts immediately and each further replica is armed
        after `lookup_hedging_delay`, first success wins — so one slow
        replica bounds tail latency at ~delay + healthy-replica latency
        instead of the slow replica's timeout."""
        if replica_fallback:
            try:
                return self.lookup_rows(path, keys, timestamp=timestamp,
                                        column_names=column_names,
                                        timeout=timeout, pool=pool)
            except YtError as primary_err:
                if primary_err.code in (EErrorCode.RequestThrottled,
                                        EErrorCode.DeadlineExceeded):
                    # Serving-plane verdicts are NOT unavailability: a
                    # throttle means back off (retry_after), a lapsed
                    # deadline is terminal — hedging every replica here
                    # would both bust the caller's deadline and multiply
                    # load exactly when the cluster asked for less.
                    raise
                from ytsaurus_tpu_torch.tablet import replication as repl
                replicas = repl.replica_descriptors(self, path)
                ranked = [
                    info for info in sorted(
                        replicas.values(),
                        key=lambda i: (i.get("mode") != "sync",
                                       -int(i.get("last_replicated_ts",
                                                  0))))
                    if info.get("enabled")]

                def from_replica(info):
                    rc = self.table_replicator.replica_client(
                        info.get("cluster_root"))
                    return rc.lookup_rows(
                        info["path"], keys, timestamp=timestamp,
                        column_names=column_names)

                return _hedged_race(
                    [lambda info=info: from_replica(info)
                     for info in ranked],
                    self.lookup_hedging_delay, primary_err)
        gateway = self.cluster.gateway
        if gateway.enabled and keys:
            from ytsaurus_tpu_torch.utils.tracing import start_query_span
            # Entry-point span: roots a (sampled) trace for this lookup,
            # or continues the ambient one (RPC handler / batched
            # caller) — the cohort's batch-flush span parents here.
            with start_query_span("query.lookup", table=path,
                                  keys=len(keys)):
                return gateway.lookup_rows(self, path, keys, timestamp,
                                           column_names=column_names,
                                           pool=pool, timeout=timeout)
        return self._lookup_rows_direct(path, keys, timestamp,
                                        column_names)

    def _lookup_rows_direct(self, path: str, keys: Sequence[tuple],
                            timestamp: int = MAX_TIMESTAMP,
                            column_names: Optional[Sequence[str]] = None
                            ) -> list[Optional[dict]]:
        """The pre-gateway path (serving disabled): sequential per-tablet
        reads, no batching, no admission.  Kept separate so the bench
        can measure batched vs. unbatched and the gateway stays
        bypassable."""
        tablets = self._mounted_tablets(path)
        self._require_sorted(tablets[0], path)
        keys = self._fill_computed_keys(tablets[0].schema,
                                        [tuple(k) for k in keys])
        routed = self._route_rows(path, tablets, keys)
        results: dict[tuple, Optional[dict]] = {}
        for idx, part in routed.items():
            for nk, row in zip(
                    [tablets[idx].normalize_key(k) for k in part],
                    tablets[idx].lookup_rows(
                        part, timestamp=timestamp,
                        column_names=column_names)):
                results[nk] = row
        # preserve request order
        return [results[tablets[0].normalize_key(k)] for k in keys]

    # --------------------------------------------------------------------- query

    def select_rows(self, query: str,
                    timestamp: int = MAX_TIMESTAMP,
                    timeout: Optional[float] = None,
                    pool: Optional[str] = None,
                    explain_analyze: bool = False,
                    params: Optional[Sequence] = None) -> "list[dict]":
        """Distributed QL over static and mounted dynamic tables, routed
        through the cluster's QueryGateway (query/serving.py): admission
        against the per-pool concurrency slots (overflow raises
        ThrottledError with a retry_after hint) and a deadline
        (`timeout` seconds, default ServingConfig.default_timeout)
        cooperatively checked between shard programs.

        Every query runs under a root trace span (sampled per
        config.TracingConfig) covering admission, per-shard staging/
        execution, evaluator compile-vs-execute, and tablet/chunk reads;
        finished queries fold into an ExecutionProfile retained by the
        flight recorder (slow-query log + sampled recent log, monitoring
        `/traces`).  `explain_analyze=True` forces sampling and returns
        the ExecutionProfile (with `.rows` carrying the result) instead
        of the bare row list — EXPLAIN ANALYZE with the compile/execute
        split reported separately.

        Per-query statistics land in `self.last_query_statistics` (ref
        TQueryStatistics) and in the structured Query log."""
        import time as _time

        from ytsaurus_tpu_torch.query.profile import (
            ExecutionProfile,
            get_flight_recorder,
        )
        from ytsaurus_tpu_torch.query.statistics import QueryStatistics
        from ytsaurus_tpu_torch.utils.tracing import start_query_span
        gateway = self.cluster.gateway
        # The admission-resolved pool is the identity every plane shares
        # (admission counters, per-pool sensors, accounting): capturing
        # the raw requested name would split a query between an admitted
        # pool and an invented accounting pool.
        if gateway.enabled:
            pool = gateway.resolve_pool(pool)
        root = start_query_span("query.select", force=explain_analyze,
                                query=query[:200],
                                pool=pool or "default")
        # Statistics object threaded explicitly: `last_query_statistics`
        # is a shared attribute a concurrent select on the same client
        # (HTTP proxy / driver thread pools) would overwrite between our
        # impl finishing and the profile capture reading it.
        stats = QueryStatistics()
        t0 = _time.perf_counter()
        cpu0 = _time.thread_time()
        try:
            with root:
                if not gateway.enabled:
                    rows = self._select_rows_impl(query, timestamp, None,
                                                  stats=stats,
                                                  params=params)
                else:
                    rows = gateway.run_select(
                        lambda token: self._select_rows_impl(
                            query, timestamp, token, stats=stats,
                            params=params),
                        pool=pool, timeout=timeout, stats=stats)
        except YtError as err:
            # Workload recorder: failed queries are part of
            # the workload too — the record carries the classified
            # outcome (throttled/deadline/error) so a replayed mix
            # reproduces the rejection profile, not just the successes.
            from ytsaurus_tpu_torch.query.workload import (
                get_workload_log,
                outcome_of,
            )
            get_workload_log().observe_select(
                query, stats=stats, outcome=outcome_of(err),
                wall_time=_time.perf_counter() - t0, pool=pool,
                trace_id=getattr(root, "trace_id", None))
            raise
        wall = _time.perf_counter() - t0
        # The thread's CPU over the same span, less what the device waits
        # burned (already taken off by evaluator._device_wait).
        stats.host_cpu_time += _time.thread_time() - cpu0
        # The one to_dict of the query: the serving counters, the Query
        # log, the profile (and through it the flight recorder, the
        # accountant and the workload log) read this dict.
        stats_dict = stats.to_dict()
        self._record_query(query, stats_dict)
        profile = ExecutionProfile.capture(root, query, stats_dict, wall,
                                           pool=pool)
        if explain_analyze:
            # Attach BEFORE observe: the recorder strips rows from what
            # it retains (without_rows copy), so attaching afterwards
            # would mutate the stored object and pin the result set.
            profile.rows = rows
        get_flight_recorder().observe(profile)
        # Per-tenant resource accounting: the finished query's
        # counters fold into cumulative (pool, user) usage — the signal
        # fair-share serving weighs tenants by, served on /accounting
        # and `yt top`.
        from ytsaurus_tpu_torch.query.accounting import get_accountant
        get_accountant().observe_query(profile)
        # Workload recorder: the finished query folds one
        # compact record (normalized text + hoisted literals + the
        # wall/compile/execute split + capacity buckets + trace id)
        # into the bounded workload log — the capture `yt replay` and
        # `bench.py --config replay` re-run.
        from ytsaurus_tpu_torch.query.workload import get_workload_log
        get_workload_log().observe_select(query, profile=profile)
        return profile if explain_analyze else rows

    def nearest_rows(self, path: str, column: str,
                     query_vector: Sequence[float], k: int,
                     metric: str = "l2",
                     timestamp: int = MAX_TIMESTAMP,
                     timeout: Optional[float] = None,
                     pool: Optional[str] = None) -> list[dict]:
        """Top-k vector similarity over `column` (a `vector<float,N>`
        column) of `path`, served through the vector micro-batcher
        (query/vector.py): co-admitted NEAREST queries on one
        (table, column, metric) cohort execute as ONE batched
        `(batch, dim) @ (dim, rows)` distance matmul.  Returns up to
        `k` full rows ranked by `metric` ("l2", "cosine", or "dot"),
        each with a `$distance` field (similarity for "dot").

        The equivalent query-language form —
        `SELECT ... FROM [t] NEAREST(column, ?, k)` via
        `select_rows(..., params=[vec])` — runs the same distance
        kernel through the whole-plan SPMD path instead; this entry
        point is the serving-plane fast path for high-QPS workloads."""
        gateway = self.cluster.gateway
        if gateway.enabled:
            from ytsaurus_tpu_torch.utils.tracing import start_query_span
            with start_query_span("query.nearest", table=path, k=k):
                return gateway.nearest_rows(
                    self, path, column, query_vector, k, metric=metric,
                    timestamp=timestamp, pool=pool, timeout=timeout)
        # Serving disabled: execute the same batched kernel directly
        # (a cohort of one), no admission, no coalescing window.
        from ytsaurus_tpu_torch.chunks.columnar import concat_chunks
        from ytsaurus_tpu_torch.query.vector import batched_nearest, rows_at
        chunk = concat_chunks([t.read_snapshot(timestamp)
                               for t in self._mounted_tablets(path)])
        ranked = batched_nearest(chunk, column, [query_vector], k,
                                 metric=metric, device=self.cluster.device)
        rows = rows_at(chunk, [row_idx for row_idx, _ in ranked[0]])
        out = []
        for row_idx, measure in ranked[0]:
            row = dict(rows[row_idx])
            row["$distance"] = measure
            out.append(row)
        return out

    def _select_rows_system(self, query: str,
                            timestamp: int = MAX_TIMESTAMP) -> list[dict]:
        """System-plane select: NO admission, NO deadline.  For internal
        metadata/bookkeeping reads (sequoia resolution, secondary-index
        maintenance, queue offsets) that must not queue behind — or
        nest inside — user admission: a write transaction must not fail
        because the read pool is saturated, and a lookup issued while
        the caller already holds an admission slot would deadlock a
        saturated pool."""
        from ytsaurus_tpu_torch.query.statistics import QueryStatistics
        stats = QueryStatistics()
        rows = self._select_rows_impl(query, timestamp, None, stats=stats)
        self._record_query(query, stats.to_dict())
        return rows

    def _record_query(self, query: str, stats: dict) -> None:
        """A finished select's statistics (`QueryStatistics.to_dict()`)
        into the gateway's serving counters and the structured Query
        log."""
        import logging as _logging

        from ytsaurus_tpu_torch.utils.logging import get_logger, log_event
        if self.cluster._gateway is not None:
            self.cluster.gateway.record_statistics(
                stats, self.cluster.evaluator.cache_size())
        log_event(get_logger("Query"), _logging.INFO, "select_rows",
                  query=query[:200], **stats)

    def _select_rows_impl(self, query: str, timestamp: int,
                          token, stats, params=None) -> list[dict]:
        """The select itself, its stages timed into `stats`
        (query/statistics.py): parse, stage, the coordinator's (compile,
        join, dispatch, device wait), to_rows."""
        from ytsaurus_tpu_torch.utils.tracing import stage
        self.last_query_statistics = stats   # visible even if the query fails
        with stage(stats, "parse_time", "query.parse"):
            plan, intervals = self._parse_select(query, params)
        with stage(stats, "stage_time", "query.stage"):
            source_chunks, range_ordered_by, foreign = self._stage_select(
                plan, intervals, timestamp, token, stats)
        out = coordinate_and_execute(plan, source_chunks, foreign,
                                     evaluator=self.cluster.evaluator,
                                     merge_shards_below=4_000_000,
                                     range_ordered_by=range_ordered_by,
                                     stats=stats, token=token)
        if token is not None and token.rung:
            # Tag the degraded response (brown-out ladder): the rung and
            # the actual staleness served land in the query statistics,
            # which flow to the slow log, EXPLAIN ANALYZE, and drivers.
            stats.degraded_rung = token.rung
            stats.degraded_staleness = round(token.stale_served, 6)
        with stage(stats, "to_rows_time"):
            return out.to_rows()

    def _parse_select(self, query: str, params):
        """(the bound plan, its read permissions checked; the WHERE's
        column intervals, narrowed by semi-join pushdown)."""
        plan = build_query(query, _SchemaResolver(self), params=params)
        # Every source table requires read permission (ref: query agent
        # checks table read access before executing subqueries).
        self.cluster.security.validate_permission("read", plan.source)
        for join in plan.joins:
            self.cluster.security.validate_permission(
                "read", join.foreign_table)
        from ytsaurus_tpu_torch.query.pruning import extract_column_intervals
        intervals = extract_column_intervals(plan.where)
        if plan.joins:
            # Semi-join pushdown: a selective INNER side's
            # key [min, max] — merged off the foreign chunks' sealed
            # metadata stats, no decode — narrows the scan intervals, so
            # whole source shards whose key range cannot join anything
            # prune before staging.
            from ytsaurus_tpu_torch.chunks.columnar import merge_column_stats
            from ytsaurus_tpu_torch.query import planner as query_planner
            from ytsaurus_tpu_torch.query.pruning import Interval
            foreign_meta_stats = {}
            for join in plan.joins:
                try:
                    fnode = self._table_node(join.foreign_table)
                except YtError:
                    continue
                per_chunk = fnode.attributes.get("chunk_stats") or []
                # A placeholder entry ({} — a chunk sealed before stats
                # existed) means that chunk's key range is UNKNOWN:
                # merging the OTHER chunks' bounds and pushing them
                # would prune source rows that join the legacy chunk.
                # Same per column: a column absent from any entry is
                # unbounded for this table.
                if not per_chunk or not all(isinstance(e, dict) and e
                                            for e in per_chunk):
                    continue
                merged = merge_column_stats(per_chunk)
                for cname in list(merged):
                    if cname != "$row_count" and \
                            not all(cname in e for e in per_chunk):
                        merged.pop(cname)
                foreign_meta_stats[join.foreign_table] = merged
            if foreign_meta_stats:
                pushed = query_planner.pushdown_intervals(
                    plan, foreign_meta_stats)
                for name, iv in pushed.items():
                    intervals[name] = intervals.get(
                        name, Interval()).narrow(iv)
        return plan, intervals

    def _stage_select(self, plan, intervals, timestamp: int, token, stats):
        """The select's shards: (source chunks or lazy suppliers, the key
        columns they are range-ordered by or None, {foreign table: its
        chunk})."""
        range_ordered_by = None
        source_chunks = self._indexed_source_chunks(plan, intervals,
                                                    timestamp)
        if source_chunks is None:
            # LIMIT scans stage shards lazily: the coordinator's
            # adaptive prefetcher fetches only what the early exit
            # reads, and pipelines staging under evaluation.
            lazy = plan.limit is not None and plan.group is None
            source_chunks = self._query_shards(plan.source, timestamp,
                                               intervals=intervals,
                                               stats=stats, lazy=lazy,
                                               token=token)
            # Tablet shards of a sorted dynamic table arrive in pivot
            # order: range-ordered by the key columns, which unlocks the
            # ORDER BY <key prefix> LIMIT early exit.
            try:
                node = self._table_node(plan.source)
                if node.attributes.get("dynamic"):
                    schema = self._node_schema(node)
                    if schema is not None and schema.key_column_names:
                        range_ordered_by = list(schema.key_column_names)
            except YtError:
                pass
        foreign = {}
        for join in plan.joins:
            if token is not None:
                token.check()
            shards = self._query_shards(join.foreign_table, timestamp)
            foreign[join.foreign_table] = (
                concat_chunks(shards) if len(shards) > 1 else shards[0])
        return source_chunks, range_ordered_by, foreign

    def _indexed_source_chunks(self, plan, intervals, timestamp):
        """Serve the scan from a secondary index when one applies (WHERE
        bounds the index prefix); None → fall back to the shard scan.
        Ref: secondary-index predicate rewrite."""
        from ytsaurus_tpu_torch.tablet.secondary_index import (
            fetch_via_index,
            pick_index,
        )
        try:
            node = self._table_node(plan.source)
        except YtError:
            return None
        if not node.attributes.get("dynamic"):
            return None
        desc = pick_index(node, intervals)
        if desc is None:
            return None
        schema = self._node_schema(node)
        try:
            rows = fetch_via_index(self, plan.source, schema, desc,
                                   intervals, timestamp)
        except YtError:
            return None
        if rows is None:
            return None
        return [ColumnarChunk.from_rows(schema.to_unsorted(), rows,
                                        device=self.cluster.device)]

    def backup_table(self, src_path: str, dst_path: str,
                     timestamp: Optional[int] = None) -> None:
        """Consistent backup of a dynamic table as of `timestamp` (default
        now): versions newer than the cutoff are excluded, timestamps are
        PRESERVED so a restored table serves the same MVCC reads.

        Ref: backup_manager (tablet_node/backup_manager.h) — checkpoint
        timestamp + per-tablet clipped stores; here the clip is a
        vectorized filter over the versioned snapshot planes."""
        from ytsaurus_tpu_torch.tablet.tablet import (
            _versioned_sort_key,
            versioned_schema,
        )
        tablets = self._mounted_tablets(src_path)
        self._require_sorted(tablets[0], src_path)
        schema = tablets[0].schema
        cutoff = timestamp if timestamp is not None else \
            self.cluster.transactions.timestamps.generate()
        node = self._table_node(src_path)
        pivots = [list(p) for p in node.attributes.get("pivot_keys", [])]
        self.create("table", dst_path, recursive=True,
                    attributes={"schema": schema, "dynamic": True,
                                "pivot_keys": pivots,
                                "backup_timestamp": cutoff})
        per_tablet_chunks: list[list[str]] = []
        vschema = versioned_schema(schema)
        for tablet in tablets:
            rows = [r for r in tablet.versioned_rows_snapshot()
                    if r["$timestamp"] <= cutoff]
            rows.sort(key=_versioned_sort_key(schema))
            if rows:
                chunk = ColumnarChunk.from_rows(vschema, rows,
                                                device=self.cluster.device)
                per_tablet_chunks.append(
                    [self.cluster.chunk_store.write_chunk(chunk)])
            else:
                per_tablet_chunks.append([])
        self.set(dst_path + "/@tablet_chunk_ids", per_tablet_chunks)
        self.set(dst_path + "/@tablet_state", "unmounted")

    def restore_table_backup(self, backup_path: str, dst_path: str) -> None:
        """Materialize a backup as a fresh dynamic table (chunks COPY so
        the restored table's lifecycle is independent of the backup's)."""
        self.copy(backup_path, dst_path, recursive=True)

    def create_secondary_index(self, table_path: str, index_path: str,
                               columns: Sequence[str]) -> None:
        from ytsaurus_tpu_torch.tablet.secondary_index import create_secondary_index
        create_secondary_index(self, table_path, index_path, columns)

    def drop_secondary_index(self, table_path: str, index_path: str,
                             remove_table: bool = True) -> None:
        from ytsaurus_tpu_torch.tablet.secondary_index import drop_secondary_index
        drop_secondary_index(self, table_path, index_path,
                             remove_table=remove_table)

    # ---------------------------------------------------------------- operations

    def run_sort(self, input_path: str, output_path: str,
                 sort_by: "str | Sequence[str]", **kwargs):
        return self.scheduler.start_operation("sort", {
            "input_table_path": input_path, "output_table_path": output_path,
            "sort_by": list(sort_by) if not isinstance(sort_by, str)
            else sort_by, **kwargs})

    def run_merge(self, input_paths: Sequence[str], output_path: str,
                  mode: str = "unordered", **kwargs):
        return self.scheduler.start_operation("merge", {
            "input_table_paths": list(input_paths),
            "output_table_path": output_path, "mode": mode, **kwargs})

    def run_map(self, mapper: "Callable | str", input_path: str,
                output_path: str, **kwargs):
        """mapper: a Python callable rows→rows, or a shell COMMAND string
        run in job-proxy subprocesses (ref user_job.cpp pipes)."""
        spec = {"input_table_path": input_path,
                "output_table_path": output_path, **kwargs}
        if isinstance(mapper, str):
            spec["command"] = mapper
        else:
            spec["mapper"] = mapper
        return self.scheduler.start_operation("map", spec)

    def run_erase(self, table_path: str, **kwargs):
        return self.scheduler.start_operation(
            "erase", {"table_path": table_path, **kwargs})

    def run_reduce(self, reducer: "Callable | str",
                   input_path: "str | Sequence[str]", output_path: str,
                   reduce_by: "str | Sequence[str]", **kwargs):
        """Sorted reduce (ref CreateReduceController,
        sorted_controller.cpp:1451).  reducer: a Python callable
        (key_dict, group_rows) -> rows, or a shell COMMAND streaming
        key-contiguous sorted rows on stdin/stdout."""
        spec = {"output_table_path": output_path,
                "reduce_by": reduce_by, **kwargs}
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
                       output_path: str,
                       reduce_by: "str | Sequence[str]", **kwargs):
        """MapReduce (ref CreateMapReduceController,
        sort_controller.cpp:5029): map+partition → hash shuffle →
        per-partition sort + reduce.  mapper may be None (identity)."""
        spec = {"input_table_path": input_path,
                "output_table_path": output_path,
                "reduce_by": reduce_by, **kwargs}
        if isinstance(mapper, str):
            spec["map_command"] = mapper
        elif mapper is not None:
            spec["mapper"] = mapper
        if isinstance(reducer, str):
            spec["reduce_command"] = reducer
        else:
            spec["reducer"] = reducer
        return self.scheduler.start_operation("map_reduce", spec)

    def run_vanilla(self, tasks: dict, sync: bool = True, **kwargs):
        """Gang operation with no input (ref vanilla_controller.cpp:130):
        tasks = {name: {"job_count": N, "command": ... | "callable": ...}}.
        sync=False hosts long-lived server commands (the clique pattern);
        stop them with abort_operation."""
        return self.scheduler.start_operation(
            "vanilla", {"tasks": tasks, **kwargs}, sync=sync)

    def run_remote_copy(self, cluster_address: str, input_path: str,
                        output_path: str, **kwargs):
        """Copy a table from another cluster (ref
        remote_copy_controller.cpp)."""
        return self.scheduler.start_operation("remote_copy", {
            "cluster_address": cluster_address,
            "input_table_path": input_path,
            "output_table_path": output_path, **kwargs})

    def abort_operation(self, op_id: str):
        return self.scheduler.abort_operation(op_id)

    # ----------------------------------------------------------------- internals

    def _computed_plan(self, schema: TableSchema):
        """Cached (plan, input schema, referenced column names) for a
        schema's computed columns (ref TColumnEvaluatorCache,
        engine_api/column_evaluator.h)."""
        cached = self._computed_plans.get(schema)
        if cached is not None:
            return cached
        computed = [c for c in schema if c.expression]
        supplied = [c for c in schema if not c.expression]
        base_schema = TableSchema.make(
            [(c.name, c.type.value) for c in supplied])
        select_list = ", ".join(
            f"{c.expression} AS {c.name}" for c in computed)
        plan = build_query(f"{select_list} FROM [//$computed]",
                           {"//$computed": base_schema})
        for item, col in zip(plan.project.items, computed):
            if item.expr.type is not col.type:
                raise YtError(
                    f"Computed column {col.name!r}: expression type "
                    f"{item.expr.type.value} != column type {col.type.value}",
                    code=EErrorCode.QueryTypeError)
        # Feed only the columns the expressions actually read.
        referenced: set[str] = set()
        for item in plan.project.items:
            ir.map_expr(item.expr, lambda node: (
                referenced.add(node.name)
                if isinstance(node, ir.TReference) else None) or node)
        input_schema = TableSchema.make(
            [(c.name, c.type.value) for c in supplied
             if c.name in referenced])
        plan = build_query(f"{select_list} FROM [//$computed]",
                           {"//$computed": input_schema})
        entry = (plan, input_schema, [c.name for c in computed])
        self._computed_plans[schema] = entry
        return entry

    def _fill_computed_columns(self, schema: TableSchema,
                               rows: "list[dict]") -> "list[dict]":
        """Evaluate `expression` columns from the other columns at write time
        (ref column evaluator for computed key columns,
        library/query/engine_api/column_evaluator.h).  Runs the expressions
        through the query engine itself so semantics match SELECT exactly."""
        computed = [c for c in schema if c.expression]
        if not computed or not rows:
            return rows
        for row in rows:
            for c in computed:
                if c.name in row:
                    raise YtError(
                        f"Column {c.name!r} is computed "
                        f"({c.expression!r}) and cannot be written directly",
                        code=EErrorCode.QueryTypeError)
        plan, input_schema, _ = self._computed_plan(schema)
        chunk = ColumnarChunk.from_rows(
            input_schema, [{c.name: row.get(c.name) for c in input_schema}
                           for row in rows], device=self.cluster.device)
        out = self.cluster.evaluator.run_plan(plan, chunk).to_rows()
        filled = []
        for row, extra in zip(rows, out):
            merged = dict(row)
            merged.update(extra)
            filled.append(merged)
        return filled

    def _fill_computed_keys(self, schema: TableSchema,
                            keys: "list[tuple]") -> "list[tuple]":
        """Accept keys WITHOUT the computed parts (the natural key) and fill
        them, mirroring insert-time evaluation; full-width keys pass
        through.  Width is checked PER KEY so mixed batches cannot be
        misinterpreted."""
        key_cols = schema.key_columns
        if not any(c.expression for c in key_cols) or not keys:
            return keys
        natural = [c for c in key_cols if not c.expression]
        if len(natural) == len(key_cols):
            return keys
        out: "list[tuple | None]" = [None] * len(keys)
        to_fill: list[int] = []
        for i, key in enumerate(keys):
            if len(key) == len(key_cols):
                out[i] = key               # full key supplied
            elif len(key) == len(natural):
                to_fill.append(i)
            else:
                raise YtError(
                    f"Key width {len(key)} matches neither the full key "
                    f"({len(key_cols)}) nor the natural key ({len(natural)})",
                    code=EErrorCode.QueryTypeError)
        if to_fill:
            rows = [{c.name: v for c, v in zip(natural, keys[i])}
                    for i in to_fill]
            filled_rows = self._fill_computed_columns(schema, rows)
            for i, row in zip(to_fill, filled_rows):
                out[i] = tuple(row[c.name] for c in key_cols)
        return out

    def _table_node(self, path: str, create: bool = False,
                    schema: "TableSchema | dict | None" = None):
        tree = self.cluster.master.tree
        node = tree.try_resolve(path)
        if node is None:
            if not create:
                raise YtError(f"No such table {path!r}",
                              code=EErrorCode.NoSuchNode)
            attributes = {}
            if schema is not None:
                attributes["schema"] = (
                    schema.to_dict() if isinstance(schema, TableSchema)
                    else schema)
            self.create("table", path, attributes=attributes, recursive=True)
            node = tree.resolve(path)
        if node.type != "table":
            raise YtError(f"{path!r} is not a table (type {node.type})",
                          code=EErrorCode.ResolveError)
        return node

    def _node_schema(self, node) -> Optional[TableSchema]:
        schema = node.attributes.get("schema")
        if schema is None:
            return None
        return TableSchema.from_dict(schema)

    def _mounted_tablets(self, path: str) -> list[Tablet]:
        node = self._table_node(path)
        tablets = self.cluster.tablets.get(node.id)
        if tablets is None and \
                node.attributes.get("tablet_state") == "mounted":
            # Mount state is cluster metadata: a fresh connection to a
            # cluster whose master says "mounted" re-materializes the
            # tablets from the persisted chunk lists (ref: tablet cells
            # recover mounted tablets from the master after restart).
            self.mount_table(path)
            tablets = self.cluster.tablets.get(node.id)
        if tablets is None:
            raise YtError(f"Table {path!r} is not mounted",
                          code=EErrorCode.TabletNotMounted)
        return tablets

    def _persist_tablet_chunks(self, path: str) -> None:
        node = self._table_node(path)
        tablets = self.cluster.tablets.get(node.id, [])
        # Nested per-tablet layout — must match mount/unmount exactly, or a
        # restart reassigns every chunk to tablet 0.
        self.set(path + "/@tablet_chunk_ids",
                 [list(t.chunk_ids) for t in tablets])

    def _read_table_chunks(self, path: str) -> list[ColumnarChunk]:
        node = self._table_node(path)
        if node.attributes.get("dynamic"):
            return self._query_shards(path, MAX_TIMESTAMP)
        return [self.cluster.chunk_cache.get(cid)
                for cid in node.attributes.get("chunk_ids", [])]

    def _write_table_chunks(self, path: str, chunks: list[ColumnarChunk],
                            sorted_by: Optional[list[str]] = None,
                            schema: Optional[TableSchema] = None) -> None:
        self._table_node(path, create=True, schema=schema)
        publish_table_chunks(self, self.cluster.chunk_store, path, chunks,
                             sorted_by=sorted_by, schema=schema)

    def _query_shards(self, path: str, timestamp: int,
                      intervals=None, stats=None,
                      lazy: bool = False, token=None) -> list:
        """Shard chunks for a scan.  lazy=True returns zero-arg
        SUPPLIERS instead of chunks: staging (tablet snapshot / chunk
        decode) is deferred into the coordinator's adaptive prefetcher,
        so an ordered LIMIT never touches the shards its early exit
        skips (ref coordinator.h scanOrder/prefetch)."""
        node = self._table_node(path)
        if node.attributes.get("dynamic"):
            from ytsaurus_tpu_torch.tablet.ordered import OrderedTablet
            from ytsaurus_tpu_torch.tablet.timestamp import (
                ASYNC_LAST_COMMITTED,
            )
            tablets = self._mounted_tablets(path)
            if lazy and timestamp >= ASYNC_LAST_COMMITTED:
                # Deferred snapshots taken at read-latest would see
                # DIFFERENT cuts (shard 5 snapshots minutes after shard
                # 0 under a slow scan).  Pin one concrete timestamp
                # now — shared by BOTH table kinds — so every supplier
                # reads the same consistent cut whenever it runs; a
                # caller's concrete timestamp passes through untouched.
                timestamp = \
                    self.cluster.transactions.timestamps.generate()
            if isinstance(tablets[0], OrderedTablet):
                concrete = timestamp if timestamp < ASYNC_LAST_COMMITTED \
                    else None           # eager read-latest: no filter
                if lazy:
                    return [(lambda t=t: t.snapshot(concrete))
                            for t in tablets]
                return [t.snapshot(concrete) for t in tablets]
            # Brown-out rung 1: an admitted-degraded token
            # carries the pool's staleness bound; sorted tablets then
            # serve their snapshot cache within the bound instead of
            # paying the MVCC merge, and the token records the max
            # staleness actually served so the response can be tagged.
            bound = getattr(token, "staleness_bound", None)
            if bound:
                def _read_bounded(t, ts):
                    chunk, stale = t.read_snapshot_bounded(ts, bound)
                    if token is not None and \
                            stale > token.stale_served:
                        token.stale_served = stale
                    return chunk
                if lazy:
                    return [(lambda t=t, ts=timestamp:
                             _read_bounded(t, ts)) for t in tablets]
                return [_read_bounded(t, timestamp) for t in tablets]
            if lazy:
                return [(lambda t=t, ts=timestamp: t.read_snapshot(ts))
                        for t in tablets]
            return [t.read_snapshot(timestamp) for t in tablets]
        chunk_ids = node.attributes.get("chunk_ids", [])
        col_stats = node.attributes.get("chunk_stats", [])
        # Range-inference analog: skip chunks whose min/max stats cannot
        # intersect the WHERE-derived intervals.  Stats pair with chunks
        # positionally, so prune ONLY when the lists are in lockstep (tables
        # persisted before stats existed must never be misaligned).
        if intervals and len(col_stats) == len(chunk_ids):
            from ytsaurus_tpu_torch.query.pruning import chunk_may_match
            kept = [cid for cid, chunk_stats in zip(chunk_ids, col_stats)
                    if chunk_may_match(chunk_stats, intervals)]
            if stats is not None:
                stats.shards_pruned += len(chunk_ids) - len(kept)
            chunk_ids = kept
        if not chunk_ids:
            schema = self._node_schema(node)
            if schema is None:
                raise YtError(f"Empty table {path!r} has no schema",
                              code=EErrorCode.NoSuchNode)
            return [ColumnarChunk.from_rows(schema.to_unsorted(), [],
                                            device=self.cluster.device)]
        if lazy:
            return [(lambda cid=cid: self.cluster.chunk_cache.get(cid))
                    for cid in chunk_ids]
        return [self.cluster.chunk_cache.get(cid) for cid in chunk_ids]


class _SchemaResolver(dict):
    """Lazy table-path → schema mapping for the query builder.

    Schemas are presented unsorted: query shards are snapshot/decoded chunks
    whose schemas carry no sort annotations."""

    def __init__(self, client: YtClient):
        super().__init__()
        self.client = client

    def __contains__(self, path) -> bool:
        return self.client.exists(path)

    def __getitem__(self, path) -> TableSchema:
        node = self.client._table_node(path)
        schema = self.client._node_schema(node)
        if schema is None:
            raise YtError(f"Table {path!r} has no schema",
                          code=EErrorCode.QueryTypeError)
        if node.attributes.get("dynamic") and not schema.is_sorted:
            # Ordered tables expose $row_index/$timestamp system columns.
            from ytsaurus_tpu_torch.tablet.ordered import ordered_chunk_schema
            return ordered_chunk_schema(schema).to_unsorted()
        return schema.to_unsorted()


def infer_schema(rows: Sequence[dict]) -> TableSchema:
    """Infer a schema from row dicts (write_table without explicit schema)."""
    if not rows:
        raise YtError("Cannot infer a schema from zero rows")
    types: dict[str, EValueType] = {}
    order: list[str] = []
    for row in rows:
        for name, value in row.items():
            if name not in types:
                order.append(name)
                types[name] = _value_type(value)
            else:
                current = types[name]
                observed = _value_type(value)
                if current is EValueType.null:
                    types[name] = observed
                elif observed is not EValueType.null and observed != current:
                    if {observed, current} <= {EValueType.int64,
                                               EValueType.double}:
                        types[name] = EValueType.double
                    else:
                        types[name] = EValueType.any
    return TableSchema.make(
        [(name, (types[name] if types[name] is not EValueType.null
                 else EValueType.int64).value) for name in order])


def _value_type(value) -> EValueType:
    if value is None:
        return EValueType.null
    if isinstance(value, bool):
        return EValueType.boolean
    if isinstance(value, int):
        return EValueType.int64 if -(2**63) <= value < 2**63 \
            else EValueType.uint64
    if isinstance(value, float):
        return EValueType.double
    if isinstance(value, (str, bytes)):
        return EValueType.string
    return EValueType.any


_cluster_registry: dict = {}
_cluster_registry_lock = threading.Lock()


def connect(root_dir: str, fresh: bool = False,
            device: "str | torch.device" = DEFAULT_DEVICE) -> YtClient:
    """Open (or create) a local cluster rooted at `root_dir`, on `device`
    ("cuda" unless the caller asks for the CPU; raises YtError when no
    card is present).

    One YtCluster instance per root per process: two clients connecting to
    the same root share cluster state, exactly like two clients of the same
    daemons (and two master instances must not double-write one WAL).
    fresh=True drops the cached instance and re-opens from disk — the
    restart/recovery path for tests exercising WAL replay. Re-connecting
    to a live cluster on another device raises."""
    dev = resolve_device(device)
    key = os.path.realpath(root_dir)
    with _cluster_registry_lock:
        cluster = _cluster_registry.get(key)
        if cluster is not None and not fresh and \
                not same_device(cluster.device, dev):
            raise YtError(
                f"The cluster at {root_dir!r} runs on {cluster.device}, "
                f"not {dev}; reopen it with fresh=True",
                code=EErrorCode.InvalidConfig)
        if cluster is None or fresh:
            cluster = YtCluster(root_dir, device=dev)
            _cluster_registry[key] = cluster
    return YtClient(cluster)
