"""Multicell Cypress: portal entrances routing subtrees to secondary
master cells.

Ref: yt/yt/server/master/cypress_server/portal_entrance_node.h /
portal_exit_node.h + the cell_master multicell topology (and the
Sequoia direction of moving metadata out of a single master's memory):
the primary cell owns the root namespace; a `portal_entrance` node at
//path delegates everything beneath it to a secondary cell hosting the
portal exit at the SAME path with its own WAL, snapshots, and quota
accounting.  Clients see one namespace — the split happens at path
resolution.

Design deltas (consistent with the rest of the framework):
- A cell is a full framework cluster (own master + chunk plane),
  reached through the same client registry table replication uses for
  remote clusters — no bespoke cell transport.
- Cross-cell lifecycle rides the existing Hive exactly-once mailboxes
  (cypress/hive.py): removing a portal entrance posts an exit-cleanup
  message to the secondary cell, applied atomically with its inbox ack,
  so a crashed primary retries and the exit is dismantled exactly once.

Own copy of the JAX package's `cypress/multicell.py`. A secondary cell's
client opens on the primary's device (`replication.py::replica_client`).
"""

from __future__ import annotations

from typing import Optional

from ytsaurus_tpu_torch.cypress.tree import parse_ypath
from ytsaurus_tpu_torch.errors import EErrorCode, YtError

PORTAL_TYPE = "portal_entrance"
EXIT_CLEANUP = "portal_exit_cleanup"


def portal_prefix(client, path: str, include_self: bool = False
                  ) -> "Optional[tuple[str, dict]]":
    """The longest portal-entrance prefix of `path` (entrance path,
    entrance attributes), or None.  By default only STRICT prefixes
    route (the entrance node itself is primary-cell metadata);
    include_self also routes the entrance path — the read verbs resolve
    an entrance to its exit, like the reference's entrance→exit
    resolution."""
    try:
        tokens, attr = parse_ypath(path)
    except YtError:
        return None
    tree = client.cluster.master.tree
    # An attribute read on the entrance itself (//portal/@x) addresses
    # the ENTRANCE node, never the exit.
    upto = len(tokens) + (1 if include_self and attr is None else 0)
    for i in range(1, upto):
        prefix = "//" + "/".join(tokens[:i])
        node = tree.try_resolve(prefix)
        if node is None:
            return None
        if node.type == PORTAL_TYPE:
            return prefix, dict(node.attributes)
    return None


def cell_client(client, cell_root: str):
    """Secondary-cell client, cached on the primary client's replicator
    registry (the same remote-cluster cache replication uses)."""
    return client.table_replicator.replica_client(cell_root)


def delegate_for(client, path: str, permission: "Optional[str]",
                 include_self: bool = False):
    """Routed-verb front door: resolves the owning cell AND enforces the
    PRIMARY's ACLs at the portal entrance.  The cell executes the call
    under the cell-trust principal (root) — cross-cell requests carry
    the primary's authorization decision, not a per-cell user registry
    (primary principals do not exist in the secondary's //sys/users).
    Wrap the delegated call in as_cell_principal()."""
    hit = portal_prefix(client, path, include_self=include_self)
    if hit is None:
        return None
    entrance, attrs = hit
    if permission is not None:
        client.cluster.security.validate_permission(permission, entrance)
    cell_root = attrs.get("cell_root")
    if not cell_root:
        raise YtError("portal entrance has no @cell_root",
                      code=EErrorCode.ResolveError)
    return cell_client(client, cell_root)


def as_cell_principal():
    """Context for delegated calls: the cell trusts the primary's ACL
    check at the entrance."""
    from ytsaurus_tpu_torch.cypress.security import ROOT_USER, authenticated_user
    return authenticated_user(ROOT_USER)


def reject_under_portal(client, path: str, what: str) -> None:
    """Loud failure for verbs that do not route across portals yet
    (copy/move/link/lock, dynamic-table verbs): acting on the primary
    tree would either miss or SHADOW the secondary's nodes."""
    if portal_prefix(client, path) is not None:
        raise YtError(f"{what} across a portal is not supported yet "
                      f"({path!r} lives on a secondary cell)",
                      code=EErrorCode.QueryUnsupported)


def reject_tx(tx) -> None:
    if tx is not None:
        raise YtError("cross-cell transactions are not supported",
                      code=EErrorCode.QueryUnsupported)


def create_portal(client, path: str, attributes: dict,
                  recursive: bool = False,
                  ignore_existing: bool = False) -> str:
    """Create the entrance on the primary and the exit root on the
    secondary cell (same path), so routed creates find their ancestors."""
    attrs = dict(attributes or {})
    cell_root = attrs.get("cell_root")
    if not cell_root:
        raise YtError("portal_entrance requires @cell_root",
                      code=EErrorCode.ResolveError)
    attrs.setdefault("cell_tag", 1)
    node_id = client.cluster.master.commit_mutation(
        "create", path=path, type=PORTAL_TYPE, attributes=attrs,
        recursive=recursive, ignore_existing=ignore_existing)
    exit_client = cell_client(client, cell_root)
    exit_client.create("map_node", path, recursive=True,
                       ignore_existing=True,
                       attributes={"portal_exit": True})
    return node_id


def portals_under(path: str, node) -> "list[tuple[str, str]]":
    """(entrance path, cell_root) for every portal entrance inside the
    subtree rooted at `node` (including `node` itself)."""
    out: list = []
    stack = [(path, node)]
    while stack:
        prefix, current = stack.pop()
        if current.type == PORTAL_TYPE:
            cell_root = (current.attributes or {}).get("cell_root")
            if cell_root:
                out.append((prefix, cell_root))
            continue                # nothing routable lives beneath it
        for name, child in current.children.items():
            stack.append((f"{prefix}/{name}", child))
    return out


def remove_portal(client, path: str, entrance_attrs: dict,
                  recursive: bool = True, tx=None) -> None:
    """Remove the entrance, then dismantle the exit subtree on the
    secondary via Hive.  Order matters: the PRIMARY removal commits
    first, so a failed/refused primary remove never destroys exit data;
    a crash between the two steps leaks the exit until the next cleanup
    (bounded, and strictly safer than the converse).  Cross-cell
    removal cannot ride a primary transaction — a rollback could not
    restore the exit — so tx is rejected."""
    reject_tx(tx)
    cell_root = entrance_attrs.get("cell_root")
    exit_client = cell_client(client, cell_root)
    with as_cell_principal():
        non_empty = exit_client.exists(path) and exit_client.list(path)
    if not recursive and non_empty:
        raise YtError(f"Cannot remove non-empty portal {path!r} without "
                      "recursive=True", code=EErrorCode.Generic)
    client.cluster.master.commit_mutation("remove", path=path,
                                          recursive=True)
    _dismantle_exit(client, cell_root, path)


def _dismantle_exit(client, cell_root: str, path: str) -> None:
    """Exactly-once exit removal through Hive (durable outbox intent,
    idempotent receiver)."""
    src = hive_of(client)
    dst = hive_of(cell_client(client, cell_root))
    _ensure_cleanup_handler(dst)
    src.post(dst.cell_id, EXIT_CLEANUP, {"path": path})
    src.flush(dst)


def hive_of(client):
    """One HiveManager per cluster, cell id = the cluster root dir."""
    manager = getattr(client, "_hive_manager", None)
    if manager is None:
        from ytsaurus_tpu_torch.cypress.hive import HiveManager
        manager = HiveManager(client, cell_id=_cell_id(client))
        _ensure_cleanup_handler(manager)
        client._hive_manager = manager
    return manager


def _cell_id(client) -> str:
    root = client.cluster.root_dir
    # Cell ids appear in cypress paths: keep them token-safe.
    return "cell-" + "".join(
        c if c.isalnum() else "-" for c in root).strip("-")


def _ensure_cleanup_handler(manager) -> None:
    if EXIT_CLEANUP in manager._handlers:
        return

    def handle(payload: dict):
        path = payload["path"]
        node = manager.client.cluster.master.tree.try_resolve(path)
        if node is None:
            return []               # already gone: idempotent
        # Portals CHAINED inside this exit must dismantle their own
        # (third-cell) exits too, or a recreated chain resurrects stale
        # data there.  This bends Hive's declarative-handler contract
        # (remote posts happen DURING apply, outside the atomic ack
        # batch), which is safe here because dismantles are idempotent:
        # a crash-then-reapply re-posts a cleanup whose receiver finds
        # the path already gone and acks a no-op.
        for nested_path, nested_root in portals_under(path, node):
            _dismantle_exit(manager.client, nested_root, nested_path)
        return [("remove", {"path": path, "recursive": True})]

    manager.register_handler(EXIT_CLEANUP, handle)
