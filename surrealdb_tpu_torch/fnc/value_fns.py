"""value:: / generic functions (reference: core/src/fnc/value.rs) plus the
method-only helpers (chain, diff, patch)."""

from __future__ import annotations

from surrealdb_tpu_torch.sql.value import NONE, copy_value, value_eq

from . import register


@register("value::diff")
def diff(ctx, a, b):
    from surrealdb_tpu_torch.doc.pipeline import diff_patch

    return diff_patch(a, b)


@register("value::patch")
def patch(ctx, v, ops):
    from surrealdb_tpu_torch.doc.pipeline import apply_patch

    return apply_patch(v if isinstance(v, dict) else {}, ops)


@register("chain")
def chain(ctx, v, f):
    from .custom import run_closure

    return run_closure(ctx, f, [v])
