"""Master transactions: locks + undo-based rollback over the Cypress tree.

Ref shape: server/master/transaction_server (nested master transactions)
and cypress_server/node_detail.h lock semantics (snapshot/shared/exclusive
locks, implicit exclusive locks on writes).

Redesign: the reference branches versioned node states per transaction and
merges on commit; here mutations under a transaction apply WRITE-THROUGH to
the live tree while an UNDO entry is recorded, and abort replays the undo
in reverse.  Undo entries are recomputed deterministically during WAL
replay (each mutation recomputes its undo against the same tree state), so
only the mutation stream needs to be durable — undo logs never hit disk.
Lock conflicts use path containment: an exclusive lock on `//a/b` blocks
any other writer under `//a/b` and any writer on its ancestor chain.

Own copy of the JAX package's `cypress/transactions.py`.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Optional

from ytsaurus_tpu_torch.cypress.tree import CypressNode, CypressTree, parse_ypath
from ytsaurus_tpu_torch.errors import EErrorCode, YtError

LOCK_MODES = ("snapshot", "shared", "exclusive")


def _node_path(path: str) -> str:
    """Strip an attribute suffix: locks are per node."""
    tokens, _attr = parse_ypath(path)
    return "//" + "/".join(tokens) if tokens else "/"


def _covers(a: str, b: str) -> bool:
    """True if lock path `a` and access path `b` overlap (ancestor either
    way): a writer under a locked subtree conflicts, and so does removing
    an ancestor of a locked node."""
    if a == "/" or b == "/":
        return True
    return a == b or b.startswith(a + "/") or a.startswith(b + "/")


def _undo_paths(entry: tuple) -> "set[str]":
    """Node paths an undo entry edits when replayed (attribute entries
    collapse to their node's path)."""
    kind = entry[0]
    if kind == "seq":
        out: set = set()
        for sub in entry[1:]:
            out.update(_undo_paths(sub))
        return out
    if kind in ("remove_if_created", "restore"):
        return {entry[1]}
    if kind in ("set_attr", "remove_attr"):
        return {_node_path(entry[1])}
    return set()


@dataclass
class MasterTransaction:
    id: str
    parent_id: Optional[str] = None
    # path -> mode for shared/exclusive; snapshot copies are separate.
    locks: dict[str, str] = field(default_factory=dict)
    snapshots: dict[str, CypressNode] = field(default_factory=dict)
    undo: list[tuple] = field(default_factory=list)
    children: list[str] = field(default_factory=list)

    def serialize(self) -> dict:
        # Undo entries MUST be durable: write-through means a transaction's
        # mutations are inside the snapshot, so abort-after-restart depends
        # on the persisted undo log.
        return {"id": self.id, "parent_id": self.parent_id,
                "locks": dict(self.locks),
                "children": list(self.children),
                "undo": [list(_listify(e)) for e in self.undo],
                "snapshots": {p: n.serialize()
                              for p, n in self.snapshots.items()}}

    @classmethod
    def deserialize(cls, data: dict) -> "MasterTransaction":
        return cls(id=data["id"], parent_id=data.get("parent_id"),
                   locks={k: v for k, v in (data.get("locks") or {}).items()},
                   children=list(data.get("children") or []),
                   undo=[_tuplify(e) for e in (data.get("undo") or [])],
                   snapshots={p: CypressNode.deserialize(n)
                              for p, n in
                              (data.get("snapshots") or {}).items()})


class MasterTransactionManager:
    """Lock table + undo logs for transactions on the metadata tree.

    Owned by the Master; all entry points run under the master's mutation
    lock and are invoked both for live mutations and during WAL replay.
    """

    def __init__(self, tree: CypressTree):
        self.tree = tree
        self.transactions: dict[str, MasterTransaction] = {}

    def set_tree(self, tree: CypressTree) -> None:
        self.tree = tree

    # -- lifecycle -------------------------------------------------------------

    def start(self, tx_id: Optional[str] = None,
              parent_id: Optional[str] = None) -> str:
        tx_id = tx_id or uuid.uuid4().hex
        if tx_id in self.transactions:
            raise YtError(f"Transaction {tx_id} already exists",
                          code=EErrorCode.AlreadyExists)
        if parent_id is not None:
            parent = self._get(parent_id)
            parent.children.append(tx_id)
        self.transactions[tx_id] = MasterTransaction(tx_id,
                                                     parent_id=parent_id)
        return tx_id

    def commit(self, tx_id: str) -> "list[str]":
        """Changes are already live (write-through); commit hands locks and
        undo to the parent (nested tx) or discards them (top-level).
        Returns the node paths ROLLED BACK by aborting uncommitted
        children — rollback edits the tree outside the mutation stream,
        so post-commit observers (Sequoia) resync exactly those."""
        tx = self._get(tx_id)
        touched: set = set()
        for child in list(tx.children):
            if child in self.transactions:
                touched.update(self.abort(child))   # children roll back
        parent = self.transactions.get(tx.parent_id) \
            if tx.parent_id else None
        if parent is not None:
            # Parent inherits: its abort must also roll back this child.
            parent.undo.extend(tx.undo)
            for path, mode in tx.locks.items():
                if _rank(mode) > _rank(parent.locks.get(path, "")):
                    parent.locks[path] = mode
            parent.children.remove(tx_id)
        del self.transactions[tx_id]
        return sorted(touched)

    def abort(self, tx_id: str) -> "list[str]":
        """Roll the transaction back; returns every node path the undo
        replay touched (the abort-scoped resync set for observers — the
        Sequoia alternative to a full table resync)."""
        tx = self._get(tx_id)
        touched: set = set()
        for child in list(tx.children):
            if child in self.transactions:
                touched.update(self.abort(child))
        for entry in reversed(tx.undo):
            touched.update(_undo_paths(entry))
            self._apply_undo(entry)
        if tx.parent_id and tx.parent_id in self.transactions:
            parent = self.transactions[tx.parent_id]
            if tx_id in parent.children:
                parent.children.remove(tx_id)
        del self.transactions[tx_id]
        return sorted(touched)

    def _get(self, tx_id: str) -> MasterTransaction:
        tx = self.transactions.get(tx_id)
        if tx is None:
            raise YtError(f"No such transaction {tx_id}",
                          code=EErrorCode.NoSuchTransaction)
        return tx

    # -- locks -----------------------------------------------------------------

    def lock(self, tx_id: str, path: str, mode: str = "exclusive") -> None:
        if mode not in LOCK_MODES:
            raise YtError(f"Unknown lock mode {mode!r}")
        tx = self._get(tx_id)
        path = _node_path(path)
        node = self.tree.resolve(path)
        if mode == "snapshot":
            # Pin a deep copy for the transaction's reads; never conflicts.
            import copy
            tx.snapshots[path] = copy.deepcopy(node)
            return
        self._check_conflicts(tx_id, path, want=mode)
        current = tx.locks.get(path, "")
        if _rank(mode) > _rank(current):
            tx.locks[path] = mode

    def _check_conflicts(self, tx_id: Optional[str], path: str,
                         want: str) -> None:
        """Exclusive conflicts with everything else on overlapping paths;
        shared conflicts with exclusive only."""
        for other in self.transactions.values():
            if other.id == tx_id:
                continue
            # Ancestors of `other` do not conflict with it (nested txs).
            if tx_id is not None and self._is_ancestor(other.id, tx_id):
                continue
            for lock_path, lock_mode in other.locks.items():
                if not _covers(lock_path, path):
                    continue
                if lock_mode == "exclusive" or want == "exclusive":
                    raise YtError(
                        f"Cannot take {want!r} lock on {path!r}: "
                        f"transaction {other.id} holds {lock_mode!r} lock "
                        f"on {lock_path!r}",
                        code=EErrorCode.ConcurrentTransactionLockConflict)

    def _is_ancestor(self, maybe_ancestor: str, tx_id: str) -> bool:
        current = self.transactions.get(tx_id)
        while current is not None and current.parent_id is not None:
            if current.parent_id == maybe_ancestor:
                return True
            current = self.transactions.get(current.parent_id)
        return False

    # -- mutation interception -------------------------------------------------

    def before_mutation(self, tx_id: Optional[str], op: str,
                        args: dict) -> Optional[tuple]:
        """Conflict check + implicit exclusive lock + undo capture.  Called
        BEFORE the mutation applies (the undo must see the old state).
        Returns the undo entry; the caller records it via `after_mutation`
        only once the tree op SUCCEEDS (an undo for a failed mutation would
        roll back state the mutation never changed)."""
        paths = _written_paths(op, args)
        for path in paths:
            self._check_conflicts(tx_id, path, want="exclusive")
        if tx_id is None:
            return None
        tx = self._get(tx_id)
        for path in paths:
            if _rank("exclusive") > _rank(tx.locks.get(path, "")):
                tx.locks[path] = "exclusive"
        return self._capture_undo(op, args)

    def after_mutation(self, tx_id: Optional[str],
                       undo: Optional[tuple]) -> None:
        if tx_id is not None and undo is not None:
            self._get(tx_id).undo.append(undo)

    def _capture_undo(self, op: str, args: dict) -> tuple:
        tree = self.tree
        if op == "create":
            # ignore_existing on a pre-existing node creates nothing —
            # undoing it must NOT delete the pre-existing subtree.
            path = _node_path(args["path"])
            if tree.try_resolve(path) is not None:
                return ("noop",)
            # A recursive create materializes intermediate map nodes too;
            # the undo must remove the TOPMOST node the create builds or
            # rollback leaves orphan ancestors behind.
            tokens, _ = parse_ypath(args["path"])
            for i in range(1, len(tokens) + 1):
                candidate = "//" + "/".join(tokens[:i])
                if tree.try_resolve(candidate) is None:
                    return ("remove_if_created", candidate)
            return ("remove_if_created", path)
        if op == "set":
            path = args["path"]
            tokens, attr = parse_ypath(path)
            node = tree.try_resolve(_node_path(path))
            if node is None:
                return ("remove_if_created", _node_path(path))
            if attr is not None:
                try:
                    old = tree.get(path)
                    return ("set_attr", path, old)
                except YtError:
                    return ("remove_attr", path)
            return ("restore", _node_path(path), node.serialize())
        if op in ("remove", "move"):
            src = args.get("path") or args.get("src")
            tokens, attr = parse_ypath(src)
            if attr is not None:
                try:
                    return ("set_attr", src, tree.get(src))
                except YtError:
                    return ("remove_attr", src)
            node = tree.try_resolve(src)
            if node is None:
                return ("noop",)
            entry = ("restore", _node_path(src), node.serialize())
            if op == "move":
                return ("seq", entry, ("remove_if_created", args["dst"]))
            return entry
        if op == "copy":
            return ("remove_if_created", args["dst"])
        if op == "link":
            return ("remove_if_created", args["link"])
        return ("noop",)

    # Batch atomicity support: the master captures/replays undo entries
    # around multi-op WAL records (Master._apply "batch") so a mid-batch
    # resolution failure rolls earlier sub-ops back.
    def capture_undo(self, op: str, args: dict) -> tuple:
        return self._capture_undo(op, args)

    def apply_undo(self, entry: tuple) -> None:
        self._apply_undo(entry)

    def _apply_undo(self, entry: tuple) -> None:
        kind = entry[0]
        if kind == "noop":
            return
        if kind == "seq":
            for sub in reversed(entry[1:]):
                self._apply_undo(sub)
            return
        if kind == "remove_if_created":
            self.tree.remove(entry[1], recursive=True, force=True)
            return
        if kind == "set_attr":
            self.tree.set(entry[1], entry[2])
            return
        if kind == "remove_attr":
            self.tree.remove(entry[1], force=True)
            return
        if kind == "restore":
            path, payload = entry[1], entry[2]
            self.tree.remove(path, recursive=True, force=True)
            restored = CypressNode.deserialize(payload)
            parent_path = path.rsplit("/", 1)[0] or "/"
            tokens, _ = parse_ypath(path)
            parent = self.tree.resolve(parent_path) \
                if parent_path != "//" else self.tree.root
            parent.children[tokens[-1]] = restored
            return
        raise AssertionError(entry)

    # -- transactional reads ---------------------------------------------------

    def read_snapshot(self, tx_id: str, path: str):
        """Value pinned by a snapshot lock, or None when not pinned."""
        tx = self._get(tx_id)
        node_path = _node_path(path)
        for pinned_path, node in tx.snapshots.items():
            if pinned_path == node_path or \
                    node_path.startswith(pinned_path + "/"):
                shadow = CypressTree()
                tokens, _ = parse_ypath(pinned_path)
                parent = shadow.root
                for token in tokens[:-1]:
                    child = CypressNode(id="x", type="map_node")
                    parent.children[token] = child
                    parent = child
                parent.children[tokens[-1]] = node
                return shadow.get(path)
        return None

    # -- persistence -----------------------------------------------------------

    def serialize(self) -> dict:
        return {tx_id: tx.serialize()
                for tx_id, tx in self.transactions.items()}

    @classmethod
    def deserialize(cls, tree: CypressTree,
                    data: dict) -> "MasterTransactionManager":
        mgr = cls(tree)
        for tx_id, tx_data in (data or {}).items():
            mgr.transactions[tx_id] = MasterTransaction.deserialize(tx_data)
        return mgr


def _listify(entry: tuple) -> list:
    """Undo entry → YSON-able list; recurse only into 'seq' sub-entries
    (payloads like node serializations must pass through untouched)."""
    if entry and entry[0] == "seq":
        return ["seq", *[_listify(e) for e in entry[1:]]]
    return list(entry)


def _tuplify(entry: list) -> tuple:
    if entry and entry[0] == "seq":
        return ("seq", *[_tuplify(e) for e in entry[1:]])
    return tuple(entry)


def _rank(mode: str) -> int:
    return {"": 0, "snapshot": 1, "shared": 2, "exclusive": 3}.get(mode, 0)


def _written_paths(op: str, args: dict) -> list[str]:
    if op in ("create", "remove", "set"):
        return [_node_path(args["path"])]
    if op in ("copy", "move"):
        out = [_node_path(args["dst"])]
        if op == "move":
            out.append(_node_path(args["src"]))
        return out
    if op == "link":
        return [_node_path(args["link"])]
    return []
