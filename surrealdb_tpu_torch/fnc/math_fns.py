"""math:: functions (reference: core/src/fnc/math.rs)."""

from __future__ import annotations

import math

from surrealdb_tpu_torch.err import InvalidArgumentsError
from surrealdb_tpu_torch.sql.value import NONE, is_nullish

from . import register


def _num(v, name):
    import decimal as _dec

    if isinstance(v, _dec.Decimal):
        return v
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise InvalidArgumentsError(name, "Argument 1 was the wrong type. Expected a number.")
    return v


def _nums(a, name):
    if not isinstance(a, list):
        raise InvalidArgumentsError(name, "Argument 1 was the wrong type. Expected an array of numbers.")
    import decimal as _dec

    return [
        v
        for v in a
        if isinstance(v, (int, float, _dec.Decimal)) and not isinstance(v, bool)
    ]


def _simple(name, fn):
    @register(f"math::{name}")
    def f(ctx, v, _fn=fn, _name=name):
        return _fn(_num(v, f"math::{_name}"))

    return f


_simple("abs", abs)
_simple("acos", math.acos)
_simple("acot", lambda v: math.atan(1 / v))
_simple("asin", math.asin)
_simple("atan", math.atan)
_simple("cos", math.cos)
_simple("cot", lambda v: 1 / math.tan(v))
_simple("deg2rad", math.radians)
_simple("ln", math.log)
_simple("log10", math.log10)
_simple("log2", math.log2)
_simple("rad2deg", math.degrees)
_simple("sign", lambda v: (v > 0) - (v < 0))
_simple("sin", math.sin)
_simple("sqrt", math.sqrt)
_simple("tan", math.tan)


@register("math::ceil")
def ceil(ctx, v):
    return math.ceil(_num(v, "math::ceil"))


@register("math::floor")
def floor(ctx, v):
    return math.floor(_num(v, "math::floor"))


@register("math::round")
def round_(ctx, v):
    v = _num(v, "math::round")
    import decimal as _dec

    if isinstance(v, _dec.Decimal):
        return int(v.quantize(_dec.Decimal(1), rounding=_dec.ROUND_HALF_UP))
    # round-half-away-from-zero (reference behavior)
    return int(math.floor(v + 0.5)) if v >= 0 else int(math.ceil(v - 0.5))


@register("math::clamp")
def clamp(ctx, v, lo, hi):
    return max(_num(lo, "math::clamp"), min(_num(hi, "math::clamp"), _num(v, "math::clamp")))


@register("math::fixed")
def fixed(ctx, v, places):
    v = _num(v, "math::fixed")
    p = int(places)
    if p <= 0:
        raise InvalidArgumentsError("math::fixed", "Argument 2 must be an integer greater than 0.")
    return round(v, p)


@register("math::lerp")
def lerp(ctx, a, b, t):
    a, b, t = (_num(x, "math::lerp") for x in (a, b, t))
    return a + (b - a) * t


@register("math::lerpangle")
def lerpangle(ctx, a, b, t):
    a, b, t = (_num(x, "math::lerpangle") for x in (a, b, t))
    d = (b - a) % 360
    if d > 180:
        d -= 360
    return a + d * t


@register("math::log")
def log(ctx, v, base):
    return math.log(_num(v, "math::log"), _num(base, "math::log"))


@register("math::pow")
def pow_(ctx, v, p):
    return _num(v, "math::pow") ** _num(p, "math::pow")


@register("math::max")
def max_(ctx, a):
    nums = _nums(a, "math::max")
    return max(nums, default=NONE)


@register("math::min")
def min_(ctx, a):
    nums = _nums(a, "math::min")
    return min(nums, default=NONE)


@register("math::sum")
def sum_(ctx, a):
    return sum(_nums(a, "math::sum"))


@register("math::product")
def product(ctx, a):
    out = 1
    for v in _nums(a, "math::product"):
        out *= v
    return out


@register("math::mean")
def mean(ctx, a):
    nums = _nums(a, "math::mean")
    return sum(nums) / len(nums) if nums else NONE


@register("math::median")
def median(ctx, a):
    nums = sorted(_nums(a, "math::median"))
    if not nums:
        return NONE
    n = len(nums)
    return nums[n // 2] if n % 2 else (nums[n // 2 - 1] + nums[n // 2]) / 2


@register("math::mode")
def mode(ctx, a):
    nums = _nums(a, "math::mode")
    if not nums:
        return NONE
    counts: dict = {}
    for v in nums:
        counts[v] = counts.get(v, 0) + 1
    best = max(counts.values())
    return max(v for v, c in counts.items() if c == best)


@register("math::midhinge")
def midhinge(ctx, a):
    nums = sorted(_nums(a, "math::midhinge"))
    if not nums:
        return NONE
    return (_percentile(nums, 25) + _percentile(nums, 75)) / 2


@register("math::spread")
def spread(ctx, a):
    nums = _nums(a, "math::spread")
    if not nums:
        return NONE
    return max(nums) - min(nums)


@register("math::stddev")
def stddev(ctx, a):
    v = _var(_nums(a, "math::stddev"))
    return math.sqrt(v) if isinstance(v, (int, float)) else v


@register("math::variance")
def variance(ctx, a):
    return _var(_nums(a, "math::variance"))


def _var(nums):
    if not nums:
        return NONE
    if len(nums) == 1:
        return 0.0
    m = sum(nums) / len(nums)
    return sum((x - m) ** 2 for x in nums) / (len(nums) - 1)


def _percentile(sorted_nums, p):
    if not sorted_nums:
        return NONE
    k = (len(sorted_nums) - 1) * p / 100
    f = math.floor(k)
    c = math.ceil(k)
    if f == c:
        return sorted_nums[int(k)]
    return sorted_nums[f] * (c - k) + sorted_nums[c] * (k - f)


@register("math::percentile")
def percentile(ctx, a, p):
    return _percentile(sorted(_nums(a, "math::percentile")), _num(p, "math::percentile"))


@register("math::nearestrank")
def nearestrank(ctx, a, p):
    nums = sorted(_nums(a, "math::nearestrank"))
    if not nums:
        return NONE
    p = _num(p, "math::nearestrank")
    rank = math.ceil(p / 100 * len(nums))
    return nums[max(0, min(len(nums) - 1, rank - 1))]


@register("math::top")
def top(ctx, a, n):
    nums = sorted(_nums(a, "math::top"), reverse=True)
    return nums[: int(n)]


@register("math::bottom")
def bottom(ctx, a, n):
    nums = sorted(_nums(a, "math::bottom"))
    return nums[: int(n)]


@register("math::trimean")
def trimean(ctx, a):
    nums = sorted(_nums(a, "math::trimean"))
    if not nums:
        return NONE
    return (_percentile(nums, 25) + 2 * _percentile(nums, 50) + _percentile(nums, 75)) / 4


@register("math::interquartile")
def interquartile(ctx, a):
    nums = sorted(_nums(a, "math::interquartile"))
    if not nums:
        return NONE
    return _percentile(nums, 75) - _percentile(nums, 25)
