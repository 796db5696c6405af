"""Cypress: the versioned metadata tree.

Ref: yt/yt/server/master/cypress_server (cypress_manager.h, node_detail.h) +
core/ytree YPath semantics.  Nodes are typed (map_node, table, file,
document, ...), carry attributes, and are addressed by YPath
(`//a/b/@attr`).  Simplifications vs the reference, by design for round 1:
single master cell, exclusive whole-node locks only, no portals/Sequoia.

Own copy of the JAX package's `cypress/tree.py`.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError

NODE_TYPES = {
    "map_node", "table", "file", "document", "string_node", "int64_node",
    "list_node", "link", "portal_entrance",
}


def parse_ypath(path: str) -> tuple[list[str], Optional[str]]:
    """'//a/b/@attr/x' → (['a','b'], 'attr/x'); '//a/b' → (['a','b'], None)."""
    if not path.startswith("//") and path != "/":
        raise YtError(f"Bad YPath {path!r}: must start with //",
                      code=EErrorCode.ResolveError)
    attr = None
    if "/@" in path:
        path, attr = path.split("/@", 1)
    tokens = [t for t in path[2:].split("/") if t] if path != "/" else []
    return tokens, attr


@dataclass
class CypressNode:
    id: str
    type: str
    attributes: dict = field(default_factory=dict)
    children: dict[str, "CypressNode"] = field(default_factory=dict)
    value: Any = None                  # document/scalar payload

    def to_dict(self, depth: Optional[int] = None) -> Any:
        if self.type == "map_node":
            if depth == 0:
                return {}
            return {name: child.to_dict(None if depth is None else depth - 1)
                    for name, child in self.children.items()}
        if self.type == "document":
            return self.value
        if self.type in ("string_node", "int64_node"):
            return self.value
        return {}

    def serialize(self) -> dict:
        return {
            "id": self.id,
            "type": self.type,
            "attributes": self.attributes,
            "value": self.value,
            "children": {name: child.serialize()
                         for name, child in self.children.items()},
        }

    @classmethod
    def deserialize(cls, data: dict) -> "CypressNode":
        node = cls(id=data["id"], type=data["type"],
                   attributes=dict(data.get("attributes") or {}),
                   value=data.get("value"))
        node.children = {name: cls.deserialize(child)
                         for name, child in (data.get("children") or {}).items()}
        return node


def _clone(node: CypressNode) -> CypressNode:
    import copy as _copy
    cloned = CypressNode(
        id=uuid.uuid4().hex, type=node.type,
        attributes=_copy.deepcopy(node.attributes),
        value=_copy.deepcopy(node.value))
    cloned.children = {name: _clone(child)
                       for name, child in node.children.items()}
    return cloned


class CypressTree:
    def __init__(self):
        self.root = CypressNode(id=uuid.uuid4().hex, type="map_node")

    # -- resolution ------------------------------------------------------------

    def resolve(self, path: str, follow_links: bool = True) -> CypressNode:
        tokens, attr = parse_ypath(path)
        if attr is not None:
            raise YtError(f"Expected a node path, got attribute path {path!r}",
                          code=EErrorCode.ResolveError)
        node = self.root
        for token in tokens:
            child = node.children.get(token)
            if child is None:
                raise YtError(f"Node {path!r} has no child {token!r}",
                              code=EErrorCode.NoSuchNode,
                              attributes={"path": path})
            node = child
            if follow_links and node.type == "link":
                node = self.resolve(node.attributes["target_path"])
        return node

    def try_resolve(self, path: str,
                    follow_links: bool = True) -> Optional[CypressNode]:
        try:
            return self.resolve(path, follow_links=follow_links)
        except YtError:
            return None

    def exists(self, path: str) -> bool:
        tokens, attr = parse_ypath(path)
        node = self.root
        for token in tokens:
            node = node.children.get(token)
            if node is None:
                return False
            if node.type == "link":
                node = self.try_resolve(node.attributes["target_path"])
                if node is None:
                    return False
        if attr is not None:
            return _attr_exists(node, attr)
        return True

    # -- mutations (called through the master WAL) -----------------------------

    def create(self, path: str, node_type: str,
               attributes: Optional[dict] = None, recursive: bool = False,
               ignore_existing: bool = False) -> str:
        if node_type not in NODE_TYPES:
            raise YtError(f"Unknown node type {node_type!r}")
        tokens, attr = parse_ypath(path)
        if attr is not None or not tokens:
            raise YtError(f"Cannot create at {path!r}",
                          code=EErrorCode.ResolveError)
        node = self.root
        for token in tokens[:-1]:
            if node.type != "map_node":
                raise YtError(
                    f"Cannot traverse {node.type} node while creating {path!r}",
                    code=EErrorCode.ResolveError)
            child = node.children.get(token)
            if child is None:
                if not recursive:
                    raise YtError(f"Node {path!r}: missing parent {token!r}",
                                  code=EErrorCode.NoSuchNode)
                child = CypressNode(id=uuid.uuid4().hex, type="map_node")
                node.children[token] = child
            node = child
        name = tokens[-1]
        existing = node.children.get(name)
        if existing is not None:
            if ignore_existing and existing.type == node_type:
                return existing.id
            raise YtError(f"Node {path!r} already exists",
                          code=EErrorCode.AlreadyExists)
        if node.type != "map_node":
            raise YtError(f"Cannot create child under {node.type}",
                          code=EErrorCode.ResolveError)
        new_node = CypressNode(id=uuid.uuid4().hex, type=node_type,
                               attributes=dict(attributes or {}))
        node.children[name] = new_node
        return new_node.id

    def remove(self, path: str, recursive: bool = True,
               force: bool = False) -> None:
        tokens, attr = parse_ypath(path)
        if attr is not None:
            node = self.resolve("//" + "/".join(tokens) if tokens else "/")
            _attr_remove(node, attr)
            return
        if not tokens:
            raise YtError("Cannot remove the root")
        parent = self.root
        for token in tokens[:-1]:
            parent = parent.children.get(token)
            if parent is None:
                if force:
                    return
                raise YtError(f"No such node {path!r}",
                              code=EErrorCode.NoSuchNode)
        name = tokens[-1]
        node = parent.children.get(name)
        if node is None:
            if force:
                return
            raise YtError(f"No such node {path!r}", code=EErrorCode.NoSuchNode)
        if node.children and not recursive:
            raise YtError(f"Node {path!r} is not empty")
        del parent.children[name]

    def set(self, path: str, value: Any) -> None:
        tokens, attr = parse_ypath(path)
        if attr is not None:
            node = self.resolve("//" + "/".join(tokens) if tokens else "/")
            _attr_set(node, attr, value)
            return
        node = self.try_resolve(path)
        if node is None:
            self.create(path, "document", recursive=True)
            node = self.resolve(path)
        if node.type == "map_node" and isinstance(value, dict):
            node.children = {}
            for key, item in value.items():
                self.create(f"{path}/{key}" if path != "/" else f"//{key}",
                            "document")
                self.resolve(f"{path}/{key}").value = item
        else:
            node.value = value

    def copy(self, src_path: str, dst_path: str,
             recursive: bool = False) -> str:
        """Deep-copy a subtree (nodes get fresh ids; attributes copied).
        Copying a link copies the LINK, not its target."""
        node = self.resolve(src_path, follow_links=False)
        cloned = _clone(node)
        self._attach(dst_path, cloned, recursive)
        return cloned.id

    def move(self, src_path: str, dst_path: str,
             recursive: bool = False) -> str:
        """Atomic move: the destination is validated and prepared BEFORE the
        source detaches, so a failing move leaves the tree untouched."""
        node = self.resolve(src_path, follow_links=False)
        attach = self._prepare_attach(dst_path, recursive)
        self.remove(src_path)
        attach(node)
        return node.id

    def link(self, target_path: str, link_path: str,
             recursive: bool = False) -> str:
        """Symlink node storing its target path (resolved on access)."""
        self.resolve(target_path)          # must exist
        return self.create(link_path, "link", recursive=recursive,
                           attributes={"target_path": target_path})

    def _attach(self, path: str, node: CypressNode,
                recursive: bool) -> None:
        self._prepare_attach(path, recursive)(node)

    def _prepare_attach(self, path: str, recursive: bool):
        """Validate + create intermediates; return a closure that attaches a
        node (all failure modes fire BEFORE any caller-side detach)."""
        tokens, attr = parse_ypath(path)
        if attr is not None or not tokens:
            raise YtError(f"Cannot attach at {path!r}",
                          code=EErrorCode.ResolveError)
        parent = self.root
        for token in tokens[:-1]:
            if parent.type != "map_node":
                raise YtError(f"Cannot traverse {parent.type} node")
            child = parent.children.get(token)
            if child is None:
                if not recursive:
                    raise YtError(f"Missing parent {token!r} for {path!r}",
                                  code=EErrorCode.NoSuchNode)
                child = CypressNode(id=uuid.uuid4().hex, type="map_node")
                parent.children[token] = child
            parent = child
        name = tokens[-1]
        if name in parent.children:
            raise YtError(f"Node {path!r} already exists",
                          code=EErrorCode.AlreadyExists)

        def attach(node: CypressNode) -> None:
            parent.children[name] = node
        return attach

    # -- reads -----------------------------------------------------------------

    def get(self, path: str, attributes: Optional[list[str]] = None) -> Any:
        tokens, attr = parse_ypath(path)
        node = self.root
        for token in tokens:
            child = node.children.get(token)
            if child is None:
                raise YtError(f"No such node {path!r}",
                              code=EErrorCode.NoSuchNode)
            node = child
            if node.type == "link":
                node = self.resolve(node.attributes["target_path"])
        if attr is not None:
            return _attr_get(node, attr)
        return node.to_dict()

    def list(self, path: str) -> list[str]:
        node = self.resolve(path)
        if node.type != "map_node":
            raise YtError(f"Cannot list non-map node {path!r}")
        return sorted(node.children)

    # -- persistence -----------------------------------------------------------

    def serialize(self) -> dict:
        return self.root.serialize()

    @classmethod
    def deserialize(cls, data: dict) -> "CypressTree":
        tree = cls()
        tree.root = CypressNode.deserialize(data)
        return tree


_BUILTIN_ATTRS = {"id", "type", "count", "children"}


def _attr_get(node: CypressNode, attr: str):
    parts = attr.split("/")
    name = parts[0]
    if name == "id":
        value: Any = node.id
    elif name == "type":
        value = node.type
    elif name == "count":
        value = len(node.children)
    elif name in node.attributes:
        value = node.attributes[name]
    else:
        raise YtError(f"No such attribute {name!r}",
                      code=EErrorCode.NoSuchNode)
    for part in parts[1:]:
        if isinstance(value, dict) and part in value:
            value = value[part]
        else:
            raise YtError(f"No such attribute path @{attr}",
                          code=EErrorCode.NoSuchNode)
    return value


def _attr_set(node: CypressNode, attr: str, value) -> None:
    parts = attr.split("/")
    if parts[0] in _BUILTIN_ATTRS:
        raise YtError(f"Attribute {parts[0]!r} is read-only")
    target = node.attributes
    for part in parts[:-1]:
        target = target.setdefault(part, {})
        if not isinstance(target, dict):
            raise YtError(f"Attribute path @{attr} is not a map")
    target[parts[-1]] = value


def _attr_remove(node: CypressNode, attr: str) -> None:
    parts = attr.split("/")
    target = node.attributes
    for part in parts[:-1]:
        target = target.get(part)
        if not isinstance(target, dict):
            raise YtError(f"No such attribute @{attr}")
    target.pop(parts[-1], None)


def _attr_exists(node: CypressNode, attr: str) -> bool:
    try:
        _attr_get(node, attr)
        return True
    except YtError:
        return False
