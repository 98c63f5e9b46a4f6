"""record:: functions (reference: core/src/fnc/record.rs)."""

from __future__ import annotations

from surrealdb_tpu_torch.err import InvalidArgumentsError
from surrealdb_tpu_torch.sql.value import Table, Thing

from . import register


def _thing(v, name) -> Thing:
    if not isinstance(v, Thing):
        raise InvalidArgumentsError(name, "Argument 1 was the wrong type. Expected a record.")
    return v


@register("record::exists")
def exists(ctx, v):
    t = _thing(v, "record::exists")
    ns, db = ctx.ns_db()
    return ctx.txn().record_exists(ns, db, t.tb, t.id)


@register("record::id")
def id_(ctx, v):
    return _thing(v, "record::id").id


@register("record::tb")
def tb(ctx, v):
    return Table(_thing(v, "record::tb").tb)


@register("record::table")
def table(ctx, v):
    return Table(_thing(v, "record::table").tb)


# meta:: namespace: deprecated aliases the reference still dispatches
# (fnc/mod.rs "meta::id"/"meta::tb")
@register("meta::id")
def meta_id(ctx, v):
    return _thing(v, "meta::id").id


@register("meta::tb")
def meta_tb(ctx, v):
    return Table(_thing(v, "meta::tb").tb)
