"""Embedded scripting: `function() { … }` blocks in SurrealQL.

Role of the reference's script runner (reference: core/src/fnc/script/
main.rs — QuickJS with `this` = current document, `arguments` = computed
call args, memory/stack limits core/src/cnf/mod.rs:56-61). Backed here by
the in-tree JS interpreter (js.py + stdlib.py) with an operation budget and
call-depth cap, gated by the scripting capability
(dbs/capabilities.py; reference capabilities Scripting).
"""

from __future__ import annotations

from typing import Any, List, Optional

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.err import SurrealError
from surrealdb_tpu_torch.sql.value import (
    NONE,
    Datetime,
    Duration,
    Geometry,
    Null,
    Thing,
    Uuid,
    is_none,
    is_null,
)

from .js import Interpreter, JSFunction, ScriptError, ScriptLimitError, undefined


class JSRecord(dict):
    """JS view of a record pointer: `{ tb, id }` plus toString() → `tb:id`
    (reference classes/record). Marshals back to a Thing."""

    def __init__(self, thing: Thing):
        super().__init__(tb=thing.tb, id=to_js(thing.id))
        self.thing = thing


def to_js(v: Any) -> Any:
    """SurrealQL Value → JS value."""
    if is_none(v):
        return undefined
    if v is None or is_null(v):
        return None
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        return float(v)
    if isinstance(v, float):
        return v
    if isinstance(v, str):
        return v
    if isinstance(v, Thing):
        return JSRecord(v)
    if isinstance(v, Duration):
        return str(v)
    if isinstance(v, Datetime):
        return v.to_iso() if hasattr(v, "to_iso") else str(v)
    if isinstance(v, Uuid):
        return str(v)
    if isinstance(v, Geometry):
        return to_js(v.as_geojson()) if hasattr(v, "as_geojson") else str(v)
    if isinstance(v, (list, tuple)):
        return [to_js(x) for x in v]
    if isinstance(v, dict):
        return {str(k): to_js(x) for k, x in v.items()}
    if isinstance(v, bytes):
        return [float(b) for b in v]
    return str(v)


def from_js(v: Any) -> Any:
    """JS value → SurrealQL Value."""
    if v is undefined:
        return NONE
    if v is None:
        return Null
    if isinstance(v, bool):
        return v
    if isinstance(v, float):
        if v.is_integer() and abs(v) < 2**53:
            return int(v)
        return v
    if isinstance(v, int):
        return v
    if isinstance(v, str):
        return v
    if isinstance(v, JSRecord):
        return v.thing
    if isinstance(v, list):
        return [from_js(x) for x in v]
    if isinstance(v, JSFunction):
        return NONE
    if isinstance(v, dict):
        if v.get("__class__") in ("Error", "TypeError", "RangeError", "SyntaxError"):
            raise SurrealError(
                f"Problem with embedded script function. {v.get('name')}: {v.get('message')}"
            )
        return {k: from_js(x) for k, x in v.items() if k != "__class__"}
    return NONE


def run_script(ctx, src: str, args: List[Any], doc: Optional[dict]) -> Any:
    """Execute one script block; returns the SurrealQL result value."""
    caps = ctx.ds().capabilities if ctx is not None else None
    if caps is not None and not caps.allows_scripting():
        raise SurrealError("Scripting functions are not allowed")
    interp = Interpreter(
        max_ops=cnf.SCRIPTING_MAX_OPS, max_depth=cnf.SCRIPTING_MAX_STACK_DEPTH
    )
    this = to_js(doc) if doc is not None else undefined
    try:
        out = interp.run(src, this=this, args=[to_js(a) for a in args])
    except ScriptLimitError as e:
        raise SurrealError(f"Problem with embedded script function. {e}") from None
    except ScriptError as e:
        raise SurrealError(f"Problem with embedded script function. {e}") from None
    except RecursionError:
        # the interpreter's own depth guard counts JS frames, but deeply
        # nested EXPRESSIONS recurse the host evaluator between guard
        # checks — surface the same clean limit error either way
        raise SurrealError(
            "Problem with embedded script function. script stack depth exceeded"
        ) from None
    return from_js(out)
