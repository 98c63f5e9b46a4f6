"""bytes:: functions (reference: core/src/fnc/bytes.rs)."""

from __future__ import annotations

from surrealdb_tpu_torch.err import InvalidArgumentsError

from . import register


@register("bytes::len")
def len_(ctx, v):
    if not isinstance(v, bytes):
        raise InvalidArgumentsError("bytes::len", "Expected bytes.")
    return len(v)
