"""rand:: functions (reference: core/src/fnc/rand.rs)."""

from __future__ import annotations

import os
import random
import string
import time as _time
import uuid as _uuid

from surrealdb_tpu_torch.err import InvalidArgumentsError
from surrealdb_tpu_torch.sql.value import Datetime, Duration, Uuid

from . import register

_ULID_ALPHABET = "0123456789ABCDEFGHJKMNPQRSTVWXYZ"


@register("rand")
def rand(ctx):
    return random.random()


@register("rand::bool")
def rand_bool(ctx):
    return random.random() < 0.5


@register("rand::enum")
def rand_enum(ctx, *args):
    if len(args) == 1 and isinstance(args[0], list):
        args = args[0]
    if not args:
        from surrealdb_tpu_torch.sql.value import NONE

        return NONE
    return random.choice(list(args))


@register("rand::float")
def rand_float(ctx, lo=None, hi=None):
    if lo is None:
        return random.random()
    return random.uniform(float(lo), float(hi))


@register("rand::int")
def rand_int(ctx, lo=None, hi=None):
    if lo is None:
        return random.randint(-(2**63), 2**63 - 1)
    return random.randint(int(lo), int(hi))


@register("rand::guid")
def rand_guid(ctx, length=None, upper=None):
    n = int(length) if length is not None else 20
    chars = string.ascii_lowercase + string.digits
    return "".join(random.choices(chars, k=n))


@register("rand::string")
def rand_string(ctx, a=None, b=None):
    if a is None:
        n = 32
    elif b is None:
        n = int(a)
    else:
        n = random.randint(int(a), int(b))
    chars = string.ascii_letters + string.digits
    return "".join(random.choices(chars, k=n))


@register("rand::time")
def rand_time(ctx, lo=None, hi=None):
    if lo is None:
        secs = random.randint(0, 2**31 - 1)
    else:
        lo_s = lo.nanos // 10**9 if isinstance(lo, Datetime) else int(lo)
        hi_s = hi.nanos // 10**9 if isinstance(hi, Datetime) else int(hi)
        secs = random.randint(lo_s, hi_s)
    return Datetime(secs * 10**9)


@register("rand::uuid")
def rand_uuid(ctx):
    return Uuid(_uuid.uuid4())


@register("rand::uuid::v4")
def rand_uuid_v4(ctx):
    return Uuid(_uuid.uuid4())


@register("rand::uuid::v7")
def rand_uuid_v7(ctx):
    return Uuid.v7()


@register("rand::ulid")
def rand_ulid(ctx):
    ms = int(_time.time() * 1000)
    out = []
    for i in range(10):
        out.append(_ULID_ALPHABET[(ms >> (5 * (9 - i))) & 31])
    for _ in range(16):
        out.append(random.choice(_ULID_ALPHABET))
    return "".join(out)
