"""Sequoia: Cypress metadata backed by ground dynamic tables.

Ref: yt/yt/server/master/sequoia_server/ + the ground tables under
yt/yt/ytlib/sequoia_client/ and the read path in
yt/yt/server/cypress_proxy/ — the reference's escape from
all-metadata-in-one-master's-RAM: node records move into distributed
dynamic tables ("ground" tables), so the metadata plane scales like any
other table and masters become coordinators over it.

Two slices are realized, exactly as the reference staged them:

slice 1 — RESOLVE: `//sys/sequoia/resolve` maps path → (node id, type);
  `resolve()` is a point lookup instead of a tree walk.  Records store
  the RAW node at each path — a link row carries the link's own id and
  type "link", so link TRAVERSAL stays a resolver-layer concern and
  removing a link's target never invalidates the link's row.

slice 2 — PER-OBJECT RECORDS + the cypress-proxy READ PATH:
  `//sys/sequoia/nodes` (node id → type, attributes, value) and
  `//sys/sequoia/children` ((parent id, child key) → child id) mirror
  the per-object state, and `read_get`/`read_list`/`read_exists`/
  `read_attribute` serve Cypress reads ENTIRELY from the tables — no
  master-tree access — the cypress_proxy/actions.cpp serving model.
  Transaction aborts no longer force a full resync: the master's undo
  replay reports exactly which paths it touched (abort-scoped undo),
  and only those subtrees resynchronize.

`verify()` proves table/tree agreement across all three tables — the
consistency invariant Sequoia's migration hinges on.

Own copy of the JAX package's `cypress/sequoia.py`. The ground tables are
dynamic tables of the cluster, so their reads run on its device.
"""

from __future__ import annotations

from typing import Iterator, Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.schema import TableSchema
from ytsaurus_tpu_torch.yson import dumps as yson_dumps
from ytsaurus_tpu_torch.yson import loads as yson_loads

RESOLVE_PATH = "//sys/sequoia/resolve"
NODES_PATH = "//sys/sequoia/nodes"
CHILDREN_PATH = "//sys/sequoia/children"

RESOLVE_SCHEMA = TableSchema.make([
    ("path", "string", "ascending"),
    ("node_id", "string"),
    ("node_type", "string"),
    ("revision", "int64"),
], unique_keys=True)

NODES_SCHEMA = TableSchema.make([
    ("node_id", "string", "ascending"),
    ("node_type", "string"),
    ("path", "string"),
    ("attrs", "string"),            # yson map
    ("value", "string"),            # yson payload (documents/scalars)
    ("revision", "int64"),
], unique_keys=True)

CHILDREN_SCHEMA = TableSchema.make([
    ("parent_id", "string", "ascending"),
    ("child_key", "string", "ascending"),
    ("child_id", "string"),
], unique_keys=True)

# Subtree whose mutations must NOT be mirrored (the ground tables' own
# home — mirroring it would recurse through their mount metadata).
_EXCLUDED_ROOT = "//sys/sequoia"


def _excluded(path: str) -> bool:
    return path == _EXCLUDED_ROOT or \
        path.startswith(_EXCLUDED_ROOT + "/")


def _text(value) -> str:
    return value.decode() if isinstance(value, bytes) else value


def _canon(path: str) -> "Optional[str]":
    """Canonical table key for a client-supplied path ('//a//b' and
    '//a/b' address the same node and must share one row)."""
    from ytsaurus_tpu_torch.cypress.tree import parse_ypath
    try:
        tokens, attr = parse_ypath(path)
    except YtError:
        return None
    if attr is not None or not tokens:
        return None
    return "//" + "/".join(tokens)


def _safe_yson(value) -> bytes:
    """YSON-encode, replacing non-encodable leaves with an opaque marker
    (attributes normally arrive through the WAL and ARE encodable; this
    guards in-process clients attaching live objects)."""
    try:
        return yson_dumps(value)
    except TypeError:
        if isinstance(value, dict):
            return yson_dumps({k: yson_loads(_safe_yson(v))
                               for k, v in value.items()})
        return yson_dumps({"$opaque": repr(value)})


def _check_id(node_id: str) -> str:
    """Ids are spliced into QL filters; refuse anything quote-capable."""
    if not node_id or not all(c.isalnum() or c in "-_" for c in node_id):
        raise YtError(f"Malformed node id {node_id!r}",
                      code=EErrorCode.Generic)
    return node_id


class SequoiaResolver:
    """Maintains and serves the ground tables for one cluster."""

    def __init__(self, client):
        self.client = client
        self._revision = 0
        self._enabled = False
        # Host-side mirrors of the tables' key sets: subtree drops become
        # an in-memory prefix scan + exact-key deletes, instead of a
        # table scan under the master mutation lock (and no path text is
        # ever spliced into QL).
        self._paths: set = set()
        self._ids: dict[str, str] = {}          # path → node_id

    # -- lifecycle -------------------------------------------------------------

    def enable(self) -> "SequoiaResolver":
        """Create + mount the ground tables, full-sync them from the
        tree, and subscribe to the mutation stream — atomically under
        the master mutation lock, so no mutation can slip between the
        sync walk and the subscription."""
        for path, schema in ((RESOLVE_PATH, RESOLVE_SCHEMA),
                             (NODES_PATH, NODES_SCHEMA),
                             (CHILDREN_PATH, CHILDREN_SCHEMA)):
            if not self.client.exists(path):
                self.client.create("table", path, recursive=True,
                                   attributes={"schema": schema,
                                               "dynamic": True})
                self.client.mount_table(path)
        master = self.client.cluster.master
        with master.mutation_lock:
            self.full_sync()
            master.add_mutation_listener(self._on_mutation)
        self._enabled = True
        return self

    def _walk_tree(self) -> "Iterator[tuple[str, object, object]]":
        """(path, RAW node, parent node) for every non-excluded tree path
        — THE single walk shared by full_sync and verify.  The parent
        rides along (it is already on the walk's stack), so per-node work
        is O(1) instead of a root-to-parent resolution.  Raw (no link
        following): a link row records the link itself, so target
        mutations never invalidate it and walks cannot loop through
        cyclic links."""
        tree = self.client.cluster.master.tree
        stack = [("/", tree.root)]
        while stack:
            path, node = stack.pop()
            for name, child in list(node.children.items()):
                child_path = f"//{name}" if path == "/" else \
                    f"{path}/{name}"
                if _excluded(child_path):
                    continue
                yield child_path, child, node
                stack.append((child_path, child))

    def _record_rows(self, path: str, node,
                     parent) -> "tuple[dict, dict, dict]":
        """(resolve_row, nodes_row, children_row) for one tree node."""
        _, _, child_key = path.rpartition("/")
        return (
            {"path": path, "node_id": node.id, "node_type": node.type,
             "revision": self._revision},
            {"node_id": node.id, "node_type": node.type, "path": path,
             "attrs": _safe_yson(node.attributes),
             "value": _safe_yson(node.value),
             "revision": self._revision},
            {"parent_id": parent.id if parent is not None else "",
             "child_key": child_key, "child_id": node.id},
        )

    def _parent_node(self, path: str):
        tree = self.client.cluster.master.tree
        parent_path = path.rsplit("/", 1)[0]
        if parent_path in ("", "/"):
            return tree.root
        return tree.try_resolve(parent_path, follow_links=False)

    def full_sync(self) -> int:
        """Rebuild the tables from the live tree (bootstrap, or repair
        after a detected divergence)."""
        resolve_rows, node_rows, child_rows = [], [], []
        for path, node, parent in self._walk_tree():
            r, n, c = self._record_rows(path, node, parent)
            resolve_rows.append(r)
            node_rows.append(n)
            child_rows.append(c)
        for table, key_cols in ((RESOLVE_PATH, ("path",)),
                                (NODES_PATH, ("node_id",)),
                                (CHILDREN_PATH, ("parent_id",
                                                 "child_key"))):
            existing = self.client._select_rows_system(
                f"{', '.join(key_cols)} FROM [{table}]")
            if existing:
                self.client.delete_rows(
                    table, [tuple(_text(r[k]) for k in key_cols)
                            for r in existing])
        if resolve_rows:
            self.client.insert_rows(RESOLVE_PATH, resolve_rows)
            self.client.insert_rows(NODES_PATH, node_rows)
            self.client.insert_rows(CHILDREN_PATH, child_rows)
        self._paths = {r["path"] for r in resolve_rows}
        self._ids = {r["path"]: r["node_id"] for r in resolve_rows}
        return len(resolve_rows)

    # -- incremental maintenance ----------------------------------------------

    def _on_mutation(self, op: str, args: dict, result) -> None:
        try:
            self._apply_mutation(op, args, result)
        except YtError:
            # Upkeep must never block the mutation path; a miss degrades
            # to a stale entry that verify()/full_sync repairs.
            pass

    def _apply_mutation(self, op: str, args: dict, result=None) -> None:
        self._revision += 1
        if op == "create":
            self._upsert(args.get("path"))
        elif op == "remove":
            path = args.get("path")
            if path and "/@" in path:
                self._refresh_record(path.split("/@", 1)[0])
            else:
                self._drop_subtree(path)
        elif op == "set":
            path = args.get("path")
            if path and "/@" in path:
                # Attribute edit: the node's record changes, resolution
                # does not.
                self._refresh_record(path.split("/@", 1)[0])
            elif path:
                # A value set can CREATE the node, and a map_node set
                # replaces its whole child set: resync the subtree.
                self._drop_subtree(path)
                self._upsert_subtree(path)
        elif op in ("copy", "move"):
            if op == "move":
                self._drop_subtree(args.get("src"))
            self._upsert_subtree(args.get("dst"))
        elif op == "link":
            self._upsert(args.get("link"))
        elif op in ("tx_abort", "tx_commit"):
            # Rollback (abort, or commit aborting uncommitted children)
            # edits the tree through undo entries the mutation stream
            # never sees.  The undo replay reports the touched paths —
            # resync exactly those subtrees (abort-scoped undo).
            touched = result if isinstance(result, (list, tuple)) else None
            if touched is None:
                if op == "tx_abort":
                    self.full_sync()        # no scope info: stay correct
                return
            for path in touched:
                self._drop_subtree(path)
                self._upsert_subtree(path)
        elif op == "batch":
            for sub in args.get("ops") or []:
                self._apply_mutation(sub.get("op"), sub.get("args") or {})

    def _skip(self, path: "Optional[str]") -> bool:
        return not path or "/@" in path or _excluded(path)

    def _upsert(self, path: "Optional[str]") -> None:
        path = _canon(path) if path else None
        if self._skip(path):
            return
        node = self.client.cluster.master.tree.try_resolve(
            path, follow_links=False)
        if node is None:
            return
        # Ancestors materialized by recursive creates get records FIRST
        # (their children rows must exist before the child references
        # them in reads).
        parent = path.rsplit("/", 1)[0]
        if parent and parent != "/" and parent not in self._paths:
            self._upsert(parent)
        resolve_row, node_row, child_row = self._record_rows(
            path, node, self._parent_node(path))
        old_id = self._ids.get(path)
        if old_id is not None and old_id != node.id:
            self.client.delete_rows(NODES_PATH, [(old_id,)])
        self.client.insert_rows(RESOLVE_PATH, [resolve_row])
        self.client.insert_rows(NODES_PATH, [node_row])
        self.client.insert_rows(CHILDREN_PATH, [child_row])
        self._paths.add(path)
        self._ids[path] = node.id

    def _refresh_record(self, path: "Optional[str]") -> None:
        """Attribute/value change on an EXISTING node: rewrite its nodes
        row only (resolution and children are untouched)."""
        path = _canon(path) if path else None
        if path is None or _excluded(path):
            return
        node = self.client.cluster.master.tree.try_resolve(
            path, follow_links=False)
        if node is None or path not in self._paths:
            return
        _, node_row, _ = self._record_rows(path, node,
                                           self._parent_node(path))
        self.client.insert_rows(NODES_PATH, [node_row])

    def _upsert_subtree(self, path: "Optional[str]") -> None:
        path = _canon(path) if path else None
        if self._skip(path):
            return
        # RAW node: recursion follows real children only (a link's
        # children are the target's business, recorded at its own path).
        node = self.client.cluster.master.tree.try_resolve(
            path, follow_links=False)
        if node is None:
            return
        self._upsert(path)
        for name in list(node.children):
            self._upsert_subtree(f"{path}/{name}")

    def _drop_subtree(self, path: "Optional[str]") -> None:
        path = _canon(path) if path else None
        if self._skip(path):
            return
        doomed = [p for p in self._paths
                  if p == path or p.startswith(path + "/")]
        if not doomed:
            return
        self.client.delete_rows(RESOLVE_PATH, [(p,) for p in doomed])
        self.client.delete_rows(
            NODES_PATH, [(self._ids[p],) for p in doomed
                         if p in self._ids])
        child_keys = []
        for p in doomed:
            parent_path, _, child_key = p.rpartition("/")
            parent_id = self._ids.get(parent_path) \
                if parent_path not in ("", "/") else \
                self.client.cluster.master.tree.root.id
            if parent_id:
                child_keys.append((parent_id, child_key))
        if child_keys:
            self.client.delete_rows(CHILDREN_PATH, child_keys)
        self._paths.difference_update(doomed)
        for p in doomed:
            self._ids.pop(p, None)

    # -- serving: resolution ---------------------------------------------------

    def resolve(self, path: str) -> "Optional[dict]":
        """Point lookup: {node_id, node_type} or None — the RAW node at
        the path (a link reports type "link"; traversal is the next
        resolver layer).  THE Sequoia win: resolution is a table read,
        not a masters-memory tree walk."""
        path = _canon(path)
        if path is None:
            return None
        (row,) = self.client._lookup_rows_direct(RESOLVE_PATH, [(path,)])
        if row is None:
            return None
        return {"node_id": _text(row["node_id"]),
                "node_type": _text(row["node_type"])}

    # -- serving: the cypress-proxy read path ----------------------------------

    def read_exists(self, path: str) -> bool:
        return self.resolve(path) is not None

    def _node_record(self, node_id: str) -> "Optional[dict]":
        (row,) = self.client._lookup_rows_direct(NODES_PATH, [(node_id,)])
        if row is None:
            return None
        return {"node_type": _text(row["node_type"]),
                "path": _text(row["path"]),
                "attrs": yson_loads(row["attrs"]),
                "value": yson_loads(row["value"])}

    def _children(self, node_id: str) -> "list[tuple[str, str]]":
        rows = self.client._select_rows_system(
            f"child_key, child_id FROM [{CHILDREN_PATH}] "
            f"WHERE parent_id = '{_check_id(node_id)}'")
        return sorted((_text(r["child_key"]), _text(r["child_id"]))
                      for r in rows)

    def read_list(self, path: str) -> "list[str]":
        """Child names, served from the children ground table."""
        res = self.resolve(path)
        if res is None:
            raise YtError(f"No such node {path!r} (sequoia)",
                          code=EErrorCode.ResolveError)
        return [key for key, _ in self._children(res["node_id"])]

    def read_get(self, path: str, depth: "Optional[int]" = None):
        """Cypress get served from the ground tables alone: map nodes
        assemble from children rows, documents/scalars from the value
        column — no master-tree access (cypress_proxy/actions.cpp)."""
        res = self.resolve(path)
        if res is None:
            raise YtError(f"No such node {path!r} (sequoia)",
                          code=EErrorCode.ResolveError)
        return self._assemble(res["node_id"], res["node_type"], depth)

    def _assemble(self, node_id: str, node_type: str,
                  depth: "Optional[int]"):
        if node_type == "map_node":
            if depth == 0:
                return {}
            out = {}
            for key, child_id in self._children(node_id):
                child = self._node_record(child_id)
                if child is None:
                    continue
                out[key] = self._assemble(
                    child_id, child["node_type"],
                    None if depth is None else depth - 1)
            return out
        record = self._node_record(node_id)
        if record is None:
            return {}
        if node_type in ("document", "string_node", "int64_node"):
            return record["value"]
        return {}

    def read_attribute(self, path: str, name: str):
        res = self.resolve(path)
        if res is None:
            raise YtError(f"No such node {path!r} (sequoia)",
                          code=EErrorCode.ResolveError)
        record = self._node_record(res["node_id"])
        if record is None or name not in record["attrs"]:
            raise YtError(f"No attribute {name!r} on {path!r} (sequoia)",
                          code=EErrorCode.ResolveError)
        return record["attrs"][name]

    # -- verification ----------------------------------------------------------

    def verify(self) -> "list[str]":
        """Table/tree agreement check over the FULL namespace and all
        three ground tables; returns divergent paths (empty =
        consistent).  The Sequoia migration invariant, checkable any
        time because both sides coexist."""
        divergent: set = set()
        table_ids: dict[str, str] = {}
        for row in self.client._select_rows_system(
                f"path, node_id FROM [{RESOLVE_PATH}]"):
            table_ids[_text(row["path"])] = _text(row["node_id"])
        node_records: dict[str, dict] = {}
        for row in self.client._select_rows_system(
                f"node_id, node_type, path, attrs, value "
                f"FROM [{NODES_PATH}]"):
            node_records[_text(row["node_id"])] = {
                "node_type": _text(row["node_type"]),
                "path": _text(row["path"]),
                "attrs": row["attrs"], "value": row["value"]}
        children_rows: dict[str, dict[str, str]] = {}
        for row in self.client._select_rows_system(
                f"parent_id, child_key, child_id FROM [{CHILDREN_PATH}]"):
            children_rows.setdefault(_text(row["parent_id"]), {})[
                _text(row["child_key"])] = _text(row["child_id"])

        tree_paths = set()
        tree_ids = set()
        expected_edges: set = set()
        for path, node, parent in self._walk_tree():
            tree_paths.add(path)
            tree_ids.add(node.id)
            child_key = path.rsplit("/", 1)[1]
            expected_edges.add((parent.id, child_key))
            if table_ids.get(path) != node.id:
                divergent.add(path)
                continue
            record = node_records.get(node.id)
            if record is None or record["node_type"] != node.type or \
                    record["attrs"] != _safe_yson(node.attributes) or \
                    record["value"] != _safe_yson(node.value):
                divergent.add(path)
                continue
            if children_rows.get(parent.id, {}).get(child_key) != node.id:
                divergent.add(path)
        divergent.update(p for p in table_ids if p not in tree_paths)
        for node_id, record in node_records.items():
            if node_id not in tree_ids:
                divergent.add(record["path"])
        # Orphan EDGES: a stale children row would make read_list serve a
        # removed child forever if only expected-edge presence were
        # checked.
        for parent_id, by_key in children_rows.items():
            for child_key, child_id in by_key.items():
                if (parent_id, child_key) not in expected_edges:
                    record = node_records.get(child_id)
                    divergent.add(record["path"] if record is not None
                                  else f"<edge {parent_id}/{child_key}>")
        return sorted(divergent)
