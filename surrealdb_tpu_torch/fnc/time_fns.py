"""time:: functions (reference: core/src/fnc/time.rs)."""

from __future__ import annotations

import calendar
import time as _time
from datetime import datetime as _pydt, timezone as _tz

from surrealdb_tpu_torch.err import InvalidArgumentsError
from surrealdb_tpu_torch.sql.value import NONE, Datetime, Duration, is_nullish, sort_key

from . import register


def _dt(v, name) -> Datetime:
    if not isinstance(v, Datetime):
        raise InvalidArgumentsError(name, "Argument 1 was the wrong type. Expected a datetime.")
    return v


def _pd(v, name) -> _pydt:
    return _dt(v, name).to_py()


@register("time::now")
def now(ctx):
    return Datetime.now()


@register("time::day")
def day(ctx, v=None):
    return _pd(v if v is not None else Datetime.now(), "time::day").day


@register("time::hour")
def hour(ctx, v=None):
    return _pd(v if v is not None else Datetime.now(), "time::hour").hour


@register("time::minute")
def minute(ctx, v=None):
    return _pd(v if v is not None else Datetime.now(), "time::minute").minute


@register("time::second")
def second(ctx, v=None):
    return _pd(v if v is not None else Datetime.now(), "time::second").second


@register("time::month")
def month(ctx, v=None):
    return _pd(v if v is not None else Datetime.now(), "time::month").month


@register("time::year")
def year(ctx, v=None):
    return _pd(v if v is not None else Datetime.now(), "time::year").year


@register("time::wday")
def wday(ctx, v=None):
    return _pd(v if v is not None else Datetime.now(), "time::wday").isoweekday()


@register("time::week")
def week(ctx, v=None):
    return _pd(v if v is not None else Datetime.now(), "time::week").isocalendar()[1]


@register("time::yday")
def yday(ctx, v=None):
    return _pd(v if v is not None else Datetime.now(), "time::yday").timetuple().tm_yday


@register("time::unix")
def unix(ctx, v=None):
    d = v if v is not None else Datetime.now()
    return _dt(d, "time::unix").nanos // 10**9


@register("time::micros")
def micros(ctx, v=None):
    d = v if v is not None else Datetime.now()
    return _dt(d, "time::micros").nanos // 10**3


@register("time::millis")
def millis(ctx, v=None):
    d = v if v is not None else Datetime.now()
    return _dt(d, "time::millis").nanos // 10**6


@register("time::nano")
def nano(ctx, v=None):
    d = v if v is not None else Datetime.now()
    return _dt(d, "time::nano").nanos


@register("time::timezone")
def timezone(ctx):
    return _time.strftime("%Z")


@register("time::format")
def format_(ctx, v, fmt):
    return _pd(v, "time::format").strftime(str(fmt))


@register("time::floor")
def floor(ctx, v, d):
    dt = _dt(v, "time::floor")
    if not isinstance(d, Duration) or d.nanos == 0:
        raise InvalidArgumentsError("time::floor", "Argument 2 was the wrong type. Expected a duration.")
    return Datetime((dt.nanos // d.nanos) * d.nanos)


@register("time::ceil")
def ceil(ctx, v, d):
    dt = _dt(v, "time::ceil")
    if not isinstance(d, Duration) or d.nanos == 0:
        raise InvalidArgumentsError("time::ceil", "Argument 2 was the wrong type. Expected a duration.")
    q, r = divmod(dt.nanos, d.nanos)
    return Datetime((q + (1 if r else 0)) * d.nanos)


@register("time::round")
def round_(ctx, v, d):
    dt = _dt(v, "time::round")
    if not isinstance(d, Duration) or d.nanos == 0:
        raise InvalidArgumentsError("time::round", "Argument 2 was the wrong type. Expected a duration.")
    q, r = divmod(dt.nanos, d.nanos)
    return Datetime((q + (1 if r * 2 >= d.nanos else 0)) * d.nanos)


@register("time::group")
def group(ctx, v, unit):
    p = _pd(v, "time::group")
    unit = str(unit)
    if unit == "year":
        p = p.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
    elif unit == "month":
        p = p.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    elif unit == "day":
        p = p.replace(hour=0, minute=0, second=0, microsecond=0)
    elif unit == "hour":
        p = p.replace(minute=0, second=0, microsecond=0)
    elif unit == "minute":
        p = p.replace(second=0, microsecond=0)
    elif unit == "second":
        p = p.replace(microsecond=0)
    else:
        raise InvalidArgumentsError("time::group", f"Unsupported group '{unit}'.")
    return Datetime(int(p.timestamp() * 10**9))


@register("time::max")
def max_(ctx, a):
    if not isinstance(a, list):
        raise InvalidArgumentsError("time::max", "Expected an array of datetimes.")
    vals = [v for v in a if isinstance(v, Datetime)]
    return max(vals, key=sort_key, default=NONE)


@register("time::min")
def min_(ctx, a):
    if not isinstance(a, list):
        raise InvalidArgumentsError("time::min", "Expected an array of datetimes.")
    vals = [v for v in a if isinstance(v, Datetime)]
    return min(vals, key=sort_key, default=NONE)


@register("time::is::leap_year")
def is_leap_year(ctx, v=None):
    y = _pd(v if v is not None else Datetime.now(), "time::is::leap_year").year
    return calendar.isleap(y)


@register("time::from::nanos")
def from_nanos(ctx, v):
    return Datetime(int(v))


@register("time::from::micros")
def from_micros(ctx, v):
    return Datetime(int(v) * 10**3)


@register("time::from::millis")
def from_millis(ctx, v):
    return Datetime(int(v) * 10**6)


@register("time::from::secs")
def from_secs(ctx, v):
    return Datetime(int(v) * 10**9)


@register("time::from::unix")
def from_unix(ctx, v):
    return Datetime(int(v) * 10**9)


@register("time::from::ulid")
def from_ulid(ctx, v):
    from .rand_fns import _ULID_ALPHABET

    s = str(v)
    ms = 0
    for ch in s[:10]:
        ms = ms * 32 + _ULID_ALPHABET.index(ch)
    return Datetime(ms * 10**6)


@register("time::from::uuid")
def from_uuid(ctx, v):
    from surrealdb_tpu_torch.sql.value import Uuid

    if isinstance(v, Uuid) and v.value.version == 7:
        ms = int.from_bytes(v.value.bytes[:6], "big")
        return Datetime(ms * 10**6)
    raise InvalidArgumentsError("time::from::uuid", "Expected a v7 UUID.")
