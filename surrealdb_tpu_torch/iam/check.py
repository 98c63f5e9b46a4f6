"""Authorization checks.

Role of the reference's is_allowed + per-doc PERMISSIONS evaluation
(reference: core/src/iam/mod.rs:42, iam/policies/, core/src/doc/check.rs):

- System users (root/ns/db) are gated by role: Viewer = read-only,
  Editor = data + schema writes, Owner = everything (users/accesses too).
  Their level must cover the session's ns/db.
- Record-access sessions and anonymous guests bypass nothing: per-table
  (and per-field) PERMISSIONS clauses are evaluated per document with
  $auth/$session bound.
"""

from __future__ import annotations

from typing import Any, Optional

from surrealdb_tpu_torch.err import NotAllowedError
from surrealdb_tpu_torch.sql.value import truthy

_ROLE_RANK = {"Viewer": 1, "Editor": 2, "Owner": 3}


def _role_rank(auth) -> int:
    return max((_ROLE_RANK.get(r, 0) for r in auth.roles), default=0)


def _covers(auth, ns: Optional[str], db: Optional[str]) -> bool:
    if auth.level == "root":
        return True
    if auth.level == "ns":
        return ns is not None and auth.ns == ns
    if auth.level == "db":
        return ns is not None and db is not None and auth.ns == ns and auth.db == db
    return False


def is_system_user(auth) -> bool:
    return auth.level in ("root", "ns", "db")


_LEVEL_RANK = {"db": 1, "ns": 2, "root": 3}


def _level_covers_base(auth, base: str) -> bool:
    """Can this actor manage resources AT `base` level? (root > ns > db)"""
    return _LEVEL_RANK.get(auth.level, 0) >= _LEVEL_RANK.get(base, 0)


def check_ddl(ctx, what: str = "", target_base: Optional[str] = None) -> None:
    """DEFINE/REMOVE/ALTER/REBUILD need an Editor+ system user; user and
    access definitions need Owner AND an auth level at or above the target
    base (an NS owner must not mint root users — reference role matrix)."""
    auth = ctx.session.auth
    ns, db = ctx.session.ns, ctx.session.db
    if not is_system_user(auth) or not _covers(auth, ns, db):
        raise NotAllowedError(action="define", resource=what)
    need = 3 if what in ("user", "access") else 2
    if _role_rank(auth) < need:
        raise NotAllowedError(action="define", resource=what)
    if target_base is not None and not _level_covers_base(auth, target_base):
        raise NotAllowedError(action="define", resource=what)


def check_info(ctx, level: str = "db") -> None:
    """INFO FOR <level>: the actor's auth level must reach that level."""
    auth = ctx.session.auth
    if not is_system_user(auth) or not _covers(auth, ctx.session.ns, ctx.session.db):
        raise NotAllowedError(action="info")
    want = {"root": "root", "ns": "ns", "user": "root"}.get(level, "db")
    if not _level_covers_base(auth, want):
        raise NotAllowedError(action="info")


def check_data_write(ctx) -> None:
    """System users need Editor+ to mutate records; record/anon sessions
    fall through to per-document PERMISSIONS."""
    auth = ctx.session.auth
    if is_system_user(auth):
        if not _covers(auth, ctx.session.ns, ctx.session.db) or _role_rank(auth) < 2:
            raise NotAllowedError(action="edit")


def perms_apply(ctx) -> bool:
    """Do per-document PERMISSIONS clauses apply to this session?"""
    return not is_system_user(ctx.session.auth)


def check_table_permission(ctx, rid, doc_value, verb: str) -> bool:
    """Evaluate the table's PERMISSIONS FOR <verb> clause against one record
    (reference: core/src/doc/check.rs). Returns False when denied."""
    if not perms_apply(ctx):
        return True
    ns, db = ctx.ns_db()
    tb_def = ctx.txn().get_tb(ns, db, rid.tb) if rid is not None else None
    perms = (tb_def or {}).get("permissions")
    if perms is None:
        return False  # no PERMISSIONS clause: guests/record users denied
    rule = perms.get(verb, "NONE")
    return evaluate_permission(ctx, rule, rid, doc_value)


def evaluate_permission(ctx, rule: Any, rid, doc_value) -> bool:
    if rule == "FULL":
        return True
    if rule == "NONE" or rule is None:
        return False
    # WHERE expression with the document bound
    with ctx.with_doc_value(doc_value, rid=rid) as c:
        return truthy(rule.compute(c))


def filter_fields_for_select(ctx, rid, doc_value):
    """Strip fields whose DEFINE FIELD PERMISSIONS deny select
    (reference: field-level permissions in doc/field.rs + pluck)."""
    if not perms_apply(ctx) or not isinstance(doc_value, dict) or rid is None:
        return doc_value
    ns, db = ctx.ns_db()
    fds = ctx.txn().all_tb_fields(ns, db, rid.tb)
    if not fds:
        return doc_value
    out = doc_value
    for fd in fds:
        perms = fd.get("permissions")
        if perms is None:
            continue
        rule = perms.get("select", "FULL")
        if rule != "FULL" and not evaluate_permission(ctx, rule, rid, doc_value):
            if out is doc_value:
                from surrealdb_tpu_torch.sql.value import copy_value

                out = copy_value(doc_value)
            # strip exactly the denied path, not its whole top-level parent
            from surrealdb_tpu_torch.doc.pipeline import _field_parts
            from surrealdb_tpu_torch.sql.path import del_path

            del_path(ctx, out, _field_parts(fd["name"]))
    return out
