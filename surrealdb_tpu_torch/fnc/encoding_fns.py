"""encoding:: functions (reference: core/src/fnc/encoding.rs)."""

from __future__ import annotations

import base64

from surrealdb_tpu_torch.err import InvalidArgumentsError

from . import register


@register("encoding::base64::encode")
def b64_encode(ctx, v):
    if isinstance(v, str):
        v = v.encode()
    if not isinstance(v, bytes):
        raise InvalidArgumentsError("encoding::base64::encode", "Expected bytes or a string.")
    return base64.b64encode(v).decode().rstrip("=")


@register("encoding::base64::decode")
def b64_decode(ctx, v):
    if not isinstance(v, str):
        raise InvalidArgumentsError("encoding::base64::decode", "Expected a string.")
    pad = "=" * (-len(v) % 4)
    return base64.b64decode(v + pad)
