"""Custom functions (DEFINE FUNCTION fn::) and closures.

Role of the reference's custom-function lookup + closure invocation
(reference: core/src/fnc/mod.rs fn:: dispatch, sql/closure.rs).
"""

from __future__ import annotations

from typing import Any, List

from surrealdb_tpu_torch.err import (
    FcNotFoundError,
    InvalidArgumentsError,
    ReturnError,
    SurrealError,
    TypeError_,
)
from surrealdb_tpu_torch.sql.value import NONE, Closure


def _check_fc_permission(ctx, name: str, fc: dict) -> None:
    """DEFINE FUNCTION ... PERMISSIONS for record-access / guest sessions
    (reference: core/src/fnc/mod.rs custom-path permission check). Absent
    clause = FULL (the reference default)."""
    from surrealdb_tpu_torch.iam.check import evaluate_permission, perms_apply

    perms = fc.get("permissions")
    if perms is None or not perms_apply(ctx):
        return
    rule = perms.get("select", "NONE") if isinstance(perms, dict) else perms
    doc = ctx.doc
    rid = doc.rid if doc is not None else None
    val = doc.current if doc is not None else None
    if not evaluate_permission(ctx, rule, rid, val):
        raise SurrealError(
            f"The function 'fn::{name}' does not allow execution for this session"
        )


def run_custom(ctx, name: str, args: List[Any]) -> Any:
    caps = ctx.capabilities() if hasattr(ctx, "capabilities") else None
    if caps is not None and not caps.allows_function_name(f"fn::{name}"):
        from surrealdb_tpu_torch.err import FunctionNotAllowedError

        raise FunctionNotAllowedError(f"fn::{name}")
    ns, db = ctx.ns_db()
    fc = ctx.txn().get_fc(ns, db, name)
    if fc is None:
        raise FcNotFoundError(name)
    _check_fc_permission(ctx, name, fc)
    params = fc.get("params", [])
    if len(args) > len(params):
        raise InvalidArgumentsError(
            f"fn::{name}", f"The function expects {len(params)} arguments."
        )
    from surrealdb_tpu_torch.sql.kind import coerce

    with ctx.descend() as c:
        for i, (pname, kind) in enumerate(params):
            v = args[i] if i < len(args) else NONE
            if kind is not None:
                try:
                    v = coerce(kind, v)
                except TypeError_ as e:
                    raise InvalidArgumentsError(
                        f"fn::{name}",
                        f"Argument {i + 1} was the wrong type. Expected {kind!r}.",
                    ) from e
            c.set_param(pname, v)
        try:
            return fc["body"].compute(c)
        except ReturnError as r:
            return r.value


def run_closure(ctx, f, args: List[Any]) -> Any:
    if not isinstance(f, Closure):
        raise TypeError_("Attempted to call a non-function value")
    from surrealdb_tpu_torch.sql.kind import coerce

    with ctx.descend() as c:
        for i, (pname, kind) in enumerate(f.params):
            v = args[i] if i < len(args) else NONE
            if kind is not None:
                v = coerce(kind, v)
            c.set_param(pname, v)
        try:
            out = f.body.compute(c)
        except ReturnError as r:
            out = r.value
        if f.returns is not None:
            out = coerce(f.returns, out)
        return out
