"""Security: users, groups, accounts with quotas, ACL permission checks.

Ref shape: server/master/security_server/security_manager.h — principals
(users/groups) and accounts are first-class objects; every Cypress node
carries an ACL (list of ACEs: action/subjects/permissions) inherited down
the tree unless @inherit_acl is false; accounts meter node counts and disk
space against hierarchical limits.

Redesign: principals/accounts live IN the Cypress tree (//sys/users/...,
//sys/groups/..., //sys/accounts/...) so they persist through the ordinary
WAL/snapshot pipeline — no separate authority.  The authenticated user is
ambient (contextvar) set per RPC request by the driver service, matching
the reference's per-request authenticated-user stack
(security_manager.h TAuthenticatedUserGuard).

Own copy of the JAX package's `cypress/security.py`.
"""

from __future__ import annotations

import contextvars
from typing import Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError

PERMISSIONS = ("read", "write", "remove", "administer", "use", "mount")

ROOT_USER = "root"
SUPERUSERS = "superusers"
DEFAULT_ACCOUNT = "default"

_current_user: contextvars.ContextVar[str] = \
    contextvars.ContextVar("authenticated_user", default=ROOT_USER)


def current_user() -> str:
    return _current_user.get()


class authenticated_user:
    """Context manager: run a block as a given principal."""

    def __init__(self, user: str):
        self.user = user
        self._token = None

    def __enter__(self):
        self._token = _current_user.set(self.user)
        return self

    def __exit__(self, *exc):
        _current_user.reset(self._token)
        return False


class SecurityManager:
    """Permission + quota authority over one Cypress tree (via its master
    so principal mutations replicate through the WAL)."""

    def __init__(self, master):
        import threading
        self.master = master
        # Serializes read-modify-write cycles on usage/membership state:
        # driver requests run on a thread pool, and an unlocked RMW loses
        # concurrent charges (quota drift).
        self.metering_lock = threading.RLock()

    @property
    def tree(self):
        return self.master.tree

    # -- bootstrap -------------------------------------------------------------

    def ensure_defaults(self) -> None:
        """Idempotent: //sys scaffolding + root/superusers/default account."""
        m = self.master
        for path in ("//sys/users", "//sys/groups", "//sys/accounts"):
            if not self.tree.exists(path):
                m.commit_mutation("create", path=path, type="map_node",
                                  recursive=True)
        if not self.tree.exists(f"//sys/users/{ROOT_USER}"):
            self.create_user(ROOT_USER)
        if not self.tree.exists(f"//sys/groups/{SUPERUSERS}"):
            self.create_group(SUPERUSERS, members=[ROOT_USER])
        if not self.tree.exists(f"//sys/accounts/{DEFAULT_ACCOUNT}"):
            self.create_account(DEFAULT_ACCOUNT)

    # -- principals ------------------------------------------------------------

    def create_user(self, name: str) -> None:
        self.master.commit_mutation(
            "create", path=f"//sys/users/{name}", type="map_node",
            recursive=True, attributes={"user": True, "banned": False})

    def create_group(self, name: str, members: Optional[list] = None) -> None:
        self.master.commit_mutation(
            "create", path=f"//sys/groups/{name}", type="map_node",
            recursive=True, attributes={"members": list(members or [])})

    def add_member(self, group: str, member: str) -> None:
        path = f"//sys/groups/{group}/@members"
        with self.metering_lock:
            members = list(self.tree.get(path))
            if member not in members:
                members.append(member)
                self.master.commit_mutation("set", path=path, value=members)

    def remove_member(self, group: str, member: str) -> None:
        path = f"//sys/groups/{group}/@members"
        with self.metering_lock:
            members = [m for m in self.tree.get(path) if m != member]
            self.master.commit_mutation("set", path=path, value=members)

    def user_exists(self, name: str) -> bool:
        return self.tree.exists(f"//sys/users/{name}")

    def groups_of(self, user: str) -> set[str]:
        groups = {"everyone"}
        groups_node = self.tree.try_resolve("//sys/groups")
        if groups_node is None:
            return groups
        for name, node in groups_node.children.items():
            if user in (node.attributes.get("members") or []):
                groups.add(name)
        return groups

    # -- accounts --------------------------------------------------------------

    def create_account(self, name: str,
                       resource_limits: Optional[dict] = None) -> None:
        limits = {"node_count": 100_000, "disk_space": 1 << 44,
                  "chunk_count": 1 << 30}
        limits.update(resource_limits or {})
        self.master.commit_mutation(
            "create", path=f"//sys/accounts/{name}", type="map_node",
            recursive=True,
            attributes={"resource_limits": limits,
                        "resource_usage": {"node_count": 0, "disk_space": 0,
                                           "chunk_count": 0}})

    def account_of(self, path: str) -> str:
        """Nearest @account walking up from the node (defaults apply)."""
        node = self.tree.try_resolve(path)
        while path not in ("/", "//"):
            if node is not None:
                account = node.attributes.get("account")
                if account:
                    return account
            path = path.rsplit("/", 1)[0] or "/"
            node = self.tree.try_resolve(path) if path != "/" else None
        return DEFAULT_ACCOUNT

    def charge_account(self, account: str, *, node_count: int = 0,
                       disk_space: int = 0, chunk_count: int = 0) -> None:
        """Meter usage; raises AccountLimitExceeded when a POSITIVE delta
        would cross a limit (frees always apply)."""
        acc_path = f"//sys/accounts/{account}"
        if not self.tree.exists(acc_path):
            raise YtError(f"No such account {account!r}",
                          code=EErrorCode.ResolveError)
        with self.metering_lock:
            usage = dict(self.tree.get(f"{acc_path}/@resource_usage"))
            limits = self.tree.get(f"{acc_path}/@resource_limits")
            deltas = {"node_count": node_count, "disk_space": disk_space,
                      "chunk_count": chunk_count}
            for key, delta in deltas.items():
                new = usage.get(key, 0) + delta
                if delta > 0 and new > limits.get(key, 0):
                    raise YtError(
                        f"Account {account!r} is over its {key!r} limit: "
                        f"{new} > {limits.get(key, 0)}",
                        code=EErrorCode.AccountLimitExceeded,
                        attributes={"account": account, "resource": key})
                usage[key] = max(0, new)
            self.master.commit_mutation(
                "set", path=f"{acc_path}/@resource_usage", value=usage)

    # -- permission checks -----------------------------------------------------

    def check_permission(self, user: str, permission: str,
                         path: str) -> bool:
        """Walk the node's ancestor chain collecting ACEs; DENY beats ALLOW
        anywhere on the effective list (ref ACL evaluation order)."""
        if permission not in PERMISSIONS:
            raise YtError(f"Unknown permission {permission!r}")
        if user == ROOT_USER or SUPERUSERS in self.groups_of(user):
            return True
        subjects = self.groups_of(user) | {user}
        allowed = False
        tokens = [t for t in path.split("/") if t and not t.startswith("@")]
        chain = ["//" + "/".join(tokens[:i]) for i in
                 range(len(tokens), 0, -1)] + ["/"]
        inherit = True
        for ancestor in chain:
            node = self.tree.try_resolve(ancestor) \
                if ancestor != "/" else self.tree.root
            if node is None:
                continue
            for ace in node.attributes.get("acl") or []:
                ace_subjects = set(ace.get("subjects") or [])
                ace_perms = set(ace.get("permissions") or [])
                if not (subjects & ace_subjects) \
                        or permission not in ace_perms:
                    continue
                if ace.get("action") == "deny":
                    return False
                allowed = True
            if not node.attributes.get("inherit_acl", True):
                inherit = False
                break
        # Without any matching ACE: default-open for reads (friendly local
        # clusters), closed for everything else — unless nothing demands
        # security (no non-root users defined).
        if allowed:
            return True
        if inherit and not self._has_acls():
            return True
        return permission == "read" and inherit

    def _has_acls(self) -> bool:
        users = self.tree.try_resolve("//sys/users")
        return users is not None and \
            any(name != ROOT_USER for name in users.children)

    def validate_permission(self, permission: str, path: str,
                            user: Optional[str] = None) -> None:
        user = user or current_user()
        if not self.user_exists(user) and user != ROOT_USER:
            raise YtError(f"Unknown user {user!r}",
                          code=EErrorCode.AuthenticationError)
        if self.tree.exists(f"//sys/users/{user}/@banned") and \
                self.tree.get(f"//sys/users/{user}/@banned"):
            raise YtError(f"User {user!r} is banned",
                          code=EErrorCode.AuthenticationError)
        if not self.check_permission(user, permission, path):
            raise YtError(
                f"Access denied: user {user!r} lacks {permission!r} "
                f"permission on {path!r}",
                code=EErrorCode.AuthorizationError,
                attributes={"user": user, "permission": permission,
                            "path": path})
