"""session:: functions (reference: core/src/fnc/session.rs)."""

from __future__ import annotations

from surrealdb_tpu_torch.sql.value import NONE

from . import register


def _field(name, getter):
    @register(f"session::{name}")
    def f(ctx, _g=getter):
        v = _g(ctx)
        return v if v is not None else NONE

    return f


_field("ac", lambda ctx: ctx.session.auth.access)
_field("db", lambda ctx: ctx.session.db)
_field("id", lambda ctx: ctx.session.id)
_field("ip", lambda ctx: ctx.session.ip)
_field("ns", lambda ctx: ctx.session.ns)
_field("origin", lambda ctx: ctx.session.origin)
_field("rd", lambda ctx: ctx.session.auth.rid)
_field("token", lambda ctx: ctx.session.token)
