"""Built-in function dispatch.

Role of the reference's fnc module (reference: core/src/fnc/mod.rs:39-470 —
the `synchronous`/`asynchronous` dispatch tables over ~544 names). Functions
register into one flat registry `name -> callable(ctx, *args)`; namespaces
live in sibling modules. Value methods (`value.len()`) resolve through the
receiver type's namespace (reference "value methods").
"""

from __future__ import annotations

import time as _time
from typing import Any, Callable, Dict, List, Optional

from surrealdb_tpu_torch.err import InvalidFunctionError, SurrealError, TypeError_
from surrealdb_tpu_torch.sql.value import (
    Datetime,
    Duration,
    Geometry,
    Thing,
    Uuid,
    truthy,
)

Registry = Dict[str, Callable]
REGISTRY: Registry = {}


def register(name: str):
    def deco(fn):
        REGISTRY[name] = fn
        return fn

    return deco


def register_all(mapping: Dict[str, Callable]) -> None:
    REGISTRY.update(mapping)


def run(ctx, name: str, args: List[Any], exprs=None) -> Any:
    """Execute builtin `name` with already-computed args. The datastore's
    capabilities gate every call (reference: fnc/mod.rs idiom() checks
    ctx.check_allowed_function before dispatch)."""
    key = name.lower()
    fn = REGISTRY.get(key)
    if fn is None:
        raise SurrealError(f"The function '{name}' does not exist")
    caps = ctx.capabilities() if hasattr(ctx, "capabilities") else None
    if caps is not None and not caps.allows_function_name(key):
        from surrealdb_tpu_torch.err import FunctionNotAllowedError

        raise FunctionNotAllowedError(name)
    try:
        return fn(ctx, *args)
    except TypeError as e:
        # Python arity errors → SurrealQL invalid-arguments errors
        raise InvalidFunctionError(name, str(e)) from e


# ------------------------------------------------------------------ methods
# receiver type -> candidate namespaces, checked in order
def _method_namespaces(value) -> List[str]:
    if isinstance(value, list):
        return ["array", "vector"]
    if isinstance(value, str):
        return ["string", "parse"]
    if isinstance(value, dict):
        return ["object"]
    if isinstance(value, Thing):
        return ["record"]
    if isinstance(value, Duration):
        return ["duration"]
    if isinstance(value, Datetime):
        return ["time"]
    if isinstance(value, Geometry):
        return ["geo"]
    if isinstance(value, (int, float)):
        return ["math"]
    if isinstance(value, bytes):
        return ["bytes"]
    return []


def run_method(ctx, method: str, receiver: Any, args: List[Any]) -> Any:
    """Idiom method dispatch `value.method(args)` (reference fnc/mod.rs
    per-type method tables, e.g. `"is_array" => type::is::array`,
    `"similarity_jaro" => string::similarity::jaro`): an underscore method
    name addresses a NESTED namespace, so candidates try both the flat and
    the `_`→`::` expanded spellings, plus `to_x` → `type::x` casts."""
    m = method.lower()
    nss = _method_namespaces(receiver)
    # progressive `_`→`::` variants: `similarity_jaro_winkler` must reach
    # string::similarity::jaro_winkler (split once) while `is_leap_year`
    # reaches time::is::leap_year (split once) and `vector_distance_knn`
    # reaches vector::distance::knn (bare, split twice)
    variants = [m]
    parts = m.split("_")
    for k in range(1, len(parts)):
        variants.append("::".join(parts[:k]) + "::" + "_".join(parts[k:]))
    candidates = [f"{ns}::{v}" for ns in nss for v in variants]
    candidates += [v for v in variants[1:]]  # bare nested (vector::add)
    candidates += [f"type::{v}" for v in variants]
    if m.startswith("to_"):
        candidates += [f"type::{m[3:]}"]
    candidates += [m]
    caps = ctx.capabilities() if hasattr(ctx, "capabilities") else None
    for key in candidates:
        fn = REGISTRY.get(key)
        if fn is not None:
            # method syntax resolves to the same builtin — same capability
            # gate as a direct call (a denied family must not be reachable
            # as `value.method()`)
            if caps is not None and not caps.allows_function_name(key):
                from surrealdb_tpu_torch.err import FunctionNotAllowedError

                raise FunctionNotAllowedError(key)
            return fn(ctx, receiver, *args)
    raise SurrealError(f"The method '{method}()' does not exist")


# ------------------------------------------------------------------ core
@register("count")
def _count(ctx, v=None):
    if v is None:
        return 1
    if isinstance(v, list):
        return len(v)
    return 1 if truthy(v) else 0


@register("not")
def _not(ctx, v):
    return not truthy(v)


@register("sleep")
def _sleep(ctx, d):
    secs = d.seconds if isinstance(d, Duration) else float(d)
    _time.sleep(secs)
    from surrealdb_tpu_torch.sql.value import NONE

    return NONE


# assemble namespace modules (import side effects populate REGISTRY)
from . import array_fns  # noqa: E402,F401
from . import bytes_fns  # noqa: E402,F401
from . import crypto_fns  # noqa: E402,F401
from . import duration_fns  # noqa: E402,F401
from . import encoding_fns  # noqa: E402,F401
from . import geo_fns  # noqa: E402,F401
from . import http_fns  # noqa: E402,F401
from . import math_fns  # noqa: E402,F401
from . import object_fns  # noqa: E402,F401
from . import parse_fns  # noqa: E402,F401
from . import rand_fns  # noqa: E402,F401
from . import record_fns  # noqa: E402,F401
from . import search_fns  # noqa: E402,F401
from . import session_fns  # noqa: E402,F401
from . import string_fns  # noqa: E402,F401
from . import time_fns  # noqa: E402,F401
from . import type_fns  # noqa: E402,F401
from . import value_fns  # noqa: E402,F401
from . import vector_fns  # noqa: E402,F401
