"""Multicell Cypress, the part for a cluster without portals.

Own copy of the JAX package's `cypress/multicell.py` as far as the client
calls it (ref portal_entrance_node.h / portal_exit_node.h): the routed
verbs ask `delegate_for` which cell owns a path and refuse, through
`reject_under_portal` and `reject_tx`, what does not cross a portal. The
port has no secondary cells yet: creating a portal raises a YtError that
names the missing module (`cypress/hive.py`, the cross-cell mailboxes),
and so does any verb that reaches a portal entrance of a cluster
directory the JAX package wrote.
"""

from __future__ import annotations

from typing import Optional

from ytsaurus_tpu_torch.cypress.tree import parse_ypath
from ytsaurus_tpu_torch.errors import EErrorCode, YtError

PORTAL_TYPE = "portal_entrance"


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


def _portals_not_ported(path: str) -> YtError:
    return YtError(
        f"Portals are not ported yet ({path!r}): cross-cell routing "
        "waits for cypress/hive.py", code=EErrorCode.QueryUnsupported)


def delegate_for(client, path: str, permission: "Optional[str]",
                 include_self: bool = False):
    """Routed-verb front door: None when `path` lies on this cell;
    under a portal entrance it enforces the PRIMARY's ACL at the
    entrance, then raises (no secondary cell is reachable yet)."""
    hit = portal_prefix(client, path, include_self=include_self)
    if hit is None:
        return None
    entrance, attrs = hit
    if permission is not None:
        client.cluster.security.validate_permission(permission, entrance)
    raise _portals_not_ported(entrance)


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
    raise _portals_not_ported(path)


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
    raise _portals_not_ported(path)


def _dismantle_exit(client, cell_root: str, path: str) -> None:
    raise _portals_not_ported(path)
