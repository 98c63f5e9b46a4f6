"""duration:: functions (reference: core/src/fnc/duration.rs)."""

from __future__ import annotations

from surrealdb_tpu_torch.err import InvalidArgumentsError
from surrealdb_tpu_torch.sql.value import Duration

from . import register

_NANOS = {
    "nanos": 1,
    "micros": 10**3,
    "millis": 10**6,
    "secs": 10**9,
    "mins": 60 * 10**9,
    "hours": 3600 * 10**9,
    "days": 86400 * 10**9,
    "weeks": 7 * 86400 * 10**9,
    "years": 365 * 86400 * 10**9,
}


def _dur(v, name) -> Duration:
    if not isinstance(v, Duration):
        raise InvalidArgumentsError(name, "Argument 1 was the wrong type. Expected a duration.")
    return v


def _getter(unit):
    @register(f"duration::{unit}")
    def f(ctx, v, _unit=unit):
        return _dur(v, f"duration::{_unit}").nanos // _NANOS[_unit]

    return f


def _from(unit):
    @register(f"duration::from::{unit}")
    def f(ctx, v, _unit=unit):
        return Duration(int(v) * _NANOS[_unit])

    return f


for _u in _NANOS:
    _getter(_u)
    _from(_u)
