"""object:: functions (reference: core/src/fnc/object.rs)."""

from __future__ import annotations

from surrealdb_tpu_torch.err import InvalidArgumentsError

from . import register


def _obj(v, name):
    if not isinstance(v, dict):
        raise InvalidArgumentsError(name, "Argument 1 was the wrong type. Expected an object.")
    return v


@register("object::entries")
def entries(ctx, o):
    return [[k, v] for k, v in _obj(o, "object::entries").items()]


@register("object::from_entries")
def from_entries(ctx, a):
    if not isinstance(a, list):
        raise InvalidArgumentsError("object::from_entries", "Expected an array of [key, value] pairs.")
    out = {}
    for pair in a:
        if isinstance(pair, (list, tuple)) and len(pair) == 2:
            out[str(pair[0])] = pair[1]
    return out


@register("object::keys")
def keys(ctx, o):
    return list(_obj(o, "object::keys").keys())


@register("object::len")
def len_(ctx, o):
    return len(_obj(o, "object::len"))


@register("object::values")
def values(ctx, o):
    return list(_obj(o, "object::values").values())


@register("object::extend")
def extend(ctx, o, other):
    out = dict(_obj(o, "object::extend"))
    out.update(_obj(other, "object::extend"))
    return out


@register("object::remove")
def remove(ctx, o, key):
    out = dict(_obj(o, "object::remove"))
    ks = key if isinstance(key, list) else [key]
    for k in ks:
        out.pop(str(k), None)
    return out
