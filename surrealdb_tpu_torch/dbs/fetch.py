"""FETCH clause: resolve record links inside output rows.

Role of the reference's fetch handling (reference: core/src/sql/value/
fetch.rs): for each FETCH idiom, replace Thing values found at that path with
the fetched record documents.
"""

from __future__ import annotations

from typing import Any, List

from surrealdb_tpu_torch.sql.path import get_path, set_path
from surrealdb_tpu_torch.sql.value import NONE, Thing, is_nullish


def apply_fetch(ctx, value: Any, fetch_idioms) -> Any:
    for idiom in fetch_idioms:
        value = _fetch_one(ctx, value, idiom.parts)
    return value


def _fetch_one(ctx, value: Any, parts) -> Any:
    if isinstance(value, list):
        return [_fetch_one(ctx, v, parts) for v in value]
    if not isinstance(value, dict):
        if isinstance(value, Thing) and not parts:
            return _resolve(ctx, value)
        return value
    cur = get_path(ctx, value, parts) if parts else value
    resolved = _resolve(ctx, cur)
    if parts:
        set_path(ctx, value, parts, resolved)
        return value
    return resolved


def _resolve(ctx, v: Any) -> Any:
    if isinstance(v, Thing):
        ns, db = ctx.ns_db()
        doc = ctx.txn().get_record(ns, db, v.tb, v.id)
        return doc if doc is not None else v
    if isinstance(v, list):
        return [_resolve(ctx, x) for x in v]
    return v
