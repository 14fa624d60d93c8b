"""Copy of myscaledb_tpu/runtime/access.py (JAX-free; imports renamed to this package).

Access control: users, roles, grants, row policies, quotas.

Reference analog: src/Access/ (19.3k LoC — AccessControl, User, Role,
RowPolicy, Quota, EnabledQuota).  The single-controller TPU runtime keeps the
same model in one in-memory registry owned by the Session:

  * users authenticate by SHA-256 password hash (or no password),
  * privileges are (privilege, target) pairs where target is a table name or
    '*'; roles are named grant sets a user can hold,
  * row policies are permissive filters: if ANY policy exists on a table,
    a user sees only rows matching the union of the policies that apply to
    them (users covered by no policy see nothing) — the reference's
    RowPolicyFilterType::SELECT_FILTER semantics,
  * quotas limit per-user counters (queries, result_rows, execution_time)
    over a rolling interval window (src/Access/EnabledQuota.h).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field


class AccessDeniedError(PermissionError):
    pass


class QuotaExceededError(RuntimeError):
    pass


# the privilege lattice subset we enforce (reference: src/Access/Common/
# AccessType.h enumerates ~200; these cover the SQL surface implemented)
PRIVILEGES = ("SELECT", "INSERT", "ALTER", "CREATE TABLE", "DROP",
              "TRUNCATE", "ACCESS MANAGEMENT", "ALL")


def _hash_password(pw: str) -> str:
    return hashlib.sha256(pw.encode()).hexdigest()


@dataclass
class User:
    name: str
    password_hash: str | None = None   # None = no password
    roles: set = field(default_factory=set)
    grants: set = field(default_factory=set)   # {(priv, target)}


@dataclass
class Role:
    name: str
    grants: set = field(default_factory=set)


@dataclass
class RowPolicy:
    name: str
    table: str
    using_expr: object        # parsed expression AST
    using_sql: str            # original text (for system.row_policies)
    to_users: set | None      # None = TO ALL


@dataclass
class Quota:
    name: str
    interval_s: float
    limits: dict              # {"queries": n, "result_rows": n, ...}
    to_users: set | None      # None = TO ALL
    usage: dict = field(default_factory=dict)  # user -> window state


class AccessControl:
    def __init__(self):
        self.users: dict[str, User] = {}
        self.roles: dict[str, Role] = {}
        self.row_policies: list[RowPolicy] = []
        self.quotas: dict[str, Quota] = {}
        # the implicit 'default' user has full access (reference:
        # programs/server/users.xml grants default ALL on *.*)
        self.create_user("default")
        self.users["default"].grants.add(("ALL", "*"))

    # -- principals ----------------------------------------------------------

    def create_user(self, name: str, password: str | None = None,
                    if_not_exists: bool = False) -> None:
        if name in self.users:
            if if_not_exists:
                return
            raise ValueError(f"user {name!r} already exists")
        self.users[name] = User(name, _hash_password(password)
                                if password is not None else None)

    def drop_user(self, name: str, if_exists: bool = False) -> None:
        if name == "default":
            raise ValueError("cannot drop the default user")
        if name not in self.users and not if_exists:
            raise ValueError(f"unknown user {name!r}")
        self.users.pop(name, None)

    def create_role(self, name: str, if_not_exists: bool = False) -> None:
        if name in self.roles:
            if if_not_exists:
                return
            raise ValueError(f"role {name!r} already exists")
        self.roles[name] = Role(name)

    def drop_role(self, name: str, if_exists: bool = False) -> None:
        if name not in self.roles and not if_exists:
            raise ValueError(f"unknown role {name!r}")
        self.roles.pop(name, None)
        for u in self.users.values():
            u.roles.discard(name)

    def authenticate(self, name: str, password: str | None = None) -> str:
        u = self.users.get(name)
        if u is None:
            raise AccessDeniedError(f"unknown user {name!r}")
        if u.password_hash is not None:
            if password is None or _hash_password(password) != u.password_hash:
                raise AccessDeniedError(f"wrong password for user {name!r}")
        return name

    # -- grants --------------------------------------------------------------

    def _grantee_grants(self, grantee: str) -> set:
        if grantee in self.users:
            return self.users[grantee].grants
        if grantee in self.roles:
            return self.roles[grantee].grants
        raise ValueError(f"unknown user or role {grantee!r}")

    def grant(self, privs: list[str], target: str, grantees: list[str]):
        for g in grantees:
            for p in privs:
                p = p.upper()
                if p not in PRIVILEGES:
                    raise ValueError(f"unknown privilege {p!r}")
                self._grantee_grants(g).add((p, target))

    def grant_role(self, roles: list[str], users: list[str]):
        for r in roles:
            if r not in self.roles:
                raise ValueError(f"unknown role {r!r}")
        for uname in users:
            u = self.users.get(uname)
            if u is None:
                raise ValueError(f"unknown user {uname!r}")
            u.roles.update(roles)

    def revoke(self, privs: list[str], target: str, grantees: list[str]):
        for g in grantees:
            gs = self._grantee_grants(g)
            for p in privs:
                gs.discard((p.upper(), target))

    def revoke_role(self, roles: list[str], users: list[str]):
        for uname in users:
            u = self.users.get(uname)
            if u is not None:
                u.roles.difference_update(roles)

    def effective_grants(self, user: str) -> set:
        u = self.users.get(user)
        if u is None:
            return set()
        out = set(u.grants)
        for r in u.roles:
            role = self.roles.get(r)
            if role is not None:
                out |= role.grants
        return out

    def has(self, user: str, priv: str, table: str) -> bool:
        eff = self.effective_grants(user)
        for p in (priv.upper(), "ALL"):
            for t in (table, "*"):
                if (p, t) in eff:
                    return True
        return False

    def check(self, user: str, priv: str, table: str) -> None:
        if not self.has(user, priv, table):
            raise AccessDeniedError(
                f"{user}: not enough privileges ({priv} on {table})")

    # -- row policies --------------------------------------------------------

    def add_row_policy(self, policy: RowPolicy) -> None:
        self.drop_row_policy(policy.name, policy.table, if_exists=True)
        self.row_policies.append(policy)

    def drop_row_policy(self, name: str, table: str,
                        if_exists: bool = False) -> None:
        before = len(self.row_policies)
        self.row_policies = [p for p in self.row_policies
                             if not (p.name == name and p.table == table)]
        if len(self.row_policies) == before and not if_exists:
            raise ValueError(f"unknown row policy {name!r} on {table!r}")

    def row_policy_exprs(self, user: str, table: str):
        """Returns (has_policies, [expr ASTs applying to user]).  Empty list
        with has_policies=True means the user sees no rows."""
        applying, any_on_table = [], False
        for p in self.row_policies:
            if p.table != table:
                continue
            any_on_table = True
            if p.to_users is None or user in p.to_users:
                applying.append(p.using_expr)
        return any_on_table, applying

    # -- quotas --------------------------------------------------------------

    def add_quota(self, q: Quota) -> None:
        self.quotas[q.name] = q

    def drop_quota(self, name: str, if_exists: bool = False) -> None:
        if name not in self.quotas and not if_exists:
            raise ValueError(f"unknown quota {name!r}")
        self.quotas.pop(name, None)

    def _window(self, q: Quota, user: str) -> dict:
        now = time.monotonic()
        w = q.usage.get(user)
        if w is None or now - w["start"] >= q.interval_s:
            w = {"start": now, "queries": 0, "result_rows": 0,
                 "execution_time": 0.0, "errors": 0}
            q.usage[user] = w
        return w

    def quota_check(self, user: str) -> None:
        """Raise if the user's next query would exceed any quota limit."""
        for q in self.quotas.values():
            if q.to_users is not None and user not in q.to_users:
                continue
            w = self._window(q, user)
            for key, limit in q.limits.items():
                if w.get(key, 0) >= limit:
                    raise QuotaExceededError(
                        f"quota {q.name!r} for user {user!r} exceeded: "
                        f"{key} {w.get(key, 0)} >= {limit}")

    def quota_consume(self, user: str, queries: int = 1,
                      result_rows: int = 0, execution_time: float = 0.0,
                      errors: int = 0) -> None:
        for q in self.quotas.values():
            if q.to_users is not None and user not in q.to_users:
                continue
            w = self._window(q, user)
            w["queries"] += queries
            w["result_rows"] += result_rows
            w["execution_time"] += execution_time
            w["errors"] += errors
