"""Standard-library surface for the embedded JS interpreter.

Covers the globals and prototype methods the reference's scripting tests
and typical `function() { … }` blocks rely on (reference:
core/src/fnc/script/globals/, classes/). Native functions follow the
interpreter's calling convention fn(interp, this, args) -> value.
"""

from __future__ import annotations

import json as _json
import math as _math
import time as _time
from typing import Any, Dict, List, Optional

from .js import (
    JSFunction,
    ScriptError,
    _make_error,
    _num_to_str,
    js_number,
    js_string,
    js_truthy,
    undefined,
)


def _nf(fn):
    """Wrap a python fn(interp, this, args) marking it native."""
    fn.js_native = True
    return fn


def _call(interp, fn, args, this=undefined):
    return interp.call_function(fn, list(args), this_val=this)


# ------------------------------------------------------------------ string
def string_method(interp, s: str, name: str):
    def m(fn):
        return _nf(fn)

    table = {
        "slice": lambda i, t, a: s[_slice_idx(s, a, 0) : _slice_idx(s, a, 1, len(s))],
        "substring": lambda i, t, a: _substring(s, a),
        "indexOf": lambda i, t, a: float(s.find(js_string(a[0]) if a else "undefined")),
        "lastIndexOf": lambda i, t, a: float(s.rfind(js_string(a[0]) if a else "undefined")),
        "includes": lambda i, t, a: (js_string(a[0]) if a else "undefined") in s,
        "startsWith": lambda i, t, a: s.startswith(js_string(a[0]) if a else "undefined"),
        "endsWith": lambda i, t, a: s.endswith(js_string(a[0]) if a else "undefined"),
        "toUpperCase": lambda i, t, a: s.upper(),
        "toLowerCase": lambda i, t, a: s.lower(),
        "trim": lambda i, t, a: s.strip(),
        "trimStart": lambda i, t, a: s.lstrip(),
        "trimEnd": lambda i, t, a: s.rstrip(),
        "split": lambda i, t, a: _split(s, a),
        "replace": lambda i, t, a: s.replace(js_string(a[0]), js_string(a[1]), 1) if len(a) >= 2 else s,
        "replaceAll": lambda i, t, a: s.replace(js_string(a[0]), js_string(a[1])) if len(a) >= 2 else s,
        "charAt": lambda i, t, a: s[int(js_number(a[0]))] if a and 0 <= int(js_number(a[0])) < len(s) else "",
        "charCodeAt": lambda i, t, a: float(ord(s[int(js_number(a[0])) if a else 0])) if s else float("nan"),
        "codePointAt": lambda i, t, a: float(ord(s[int(js_number(a[0])) if a else 0])) if s else undefined,
        "concat": lambda i, t, a: s + "".join(js_string(x) for x in a),
        "repeat": lambda i, t, a: s * max(int(js_number(a[0])) if a else 0, 0),
        "padStart": lambda i, t, a: _pad(s, a, left=True),
        "padEnd": lambda i, t, a: _pad(s, a, left=False),
        "at": lambda i, t, a: _at(s, a),
        "toString": lambda i, t, a: s,
        "localeCompare": lambda i, t, a: float((s > js_string(a[0])) - (s < js_string(a[0]))) if a else 0.0,
    }
    fn = table.get(name)
    return _nf(lambda i, t, a, _f=fn: _f(i, t, a)) if fn else None


def _slice_idx(seq, args, pos, default=None):
    if pos >= len(args) or args[pos] is undefined:
        return default if pos == 1 else 0
    v = int(js_number(args[pos]))
    return v


def _substring(s, a):
    lo = max(int(js_number(a[0])) if a else 0, 0)
    hi = max(int(js_number(a[1])) if len(a) > 1 and a[1] is not undefined else len(s), 0)
    lo, hi = min(lo, hi), max(lo, hi)
    return s[lo:hi]


def _split(s, a):
    if not a or a[0] is undefined:
        return [s]
    sep = js_string(a[0])
    if sep == "":
        return list(s)
    return s.split(sep)


def _pad(s, a, left):
    target = int(js_number(a[0])) if a else 0
    fill = js_string(a[1]) if len(a) > 1 else " "
    if len(s) >= target or not fill:
        return s
    pad = (fill * target)[: target - len(s)]
    return pad + s if left else s + pad


def _at(seq, a):
    i = int(js_number(a[0])) if a else 0
    if i < 0:
        i += len(seq)
    return seq[i] if 0 <= i < len(seq) else undefined


# ------------------------------------------------------------------ array
def array_method(interp, arr: list, name: str):
    def fn_map(i, t, a):
        f = a[0]
        return [_call(i, f, [v, float(j), arr]) for j, v in enumerate(list(arr))]

    def fn_filter(i, t, a):
        f = a[0]
        return [v for j, v in enumerate(list(arr)) if js_truthy(_call(i, f, [v, float(j), arr]))]

    def fn_reduce(i, t, a):
        f = a[0]
        items = list(arr)
        if len(a) > 1:
            acc = a[1]
            start = 0
        else:
            if not items:
                raise ScriptError("reduce of empty array with no initial value")
            acc = items[0]
            start = 1
        for j in range(start, len(items)):
            acc = _call(i, f, [acc, items[j], float(j), arr])
        return acc

    def fn_foreach(i, t, a):
        for j, v in enumerate(list(arr)):
            _call(i, a[0], [v, float(j), arr])
        return undefined

    def fn_find(i, t, a):
        for j, v in enumerate(list(arr)):
            if js_truthy(_call(i, a[0], [v, float(j), arr])):
                return v
        return undefined

    def fn_findindex(i, t, a):
        for j, v in enumerate(list(arr)):
            if js_truthy(_call(i, a[0], [v, float(j), arr])):
                return float(j)
        return -1.0

    def fn_some(i, t, a):
        return any(js_truthy(_call(i, a[0], [v, float(j), arr])) for j, v in enumerate(list(arr)))

    def fn_every(i, t, a):
        return all(js_truthy(_call(i, a[0], [v, float(j), arr])) for j, v in enumerate(list(arr)))

    def fn_sort(i, t, a):
        if a and a[0] is not undefined:
            import functools

            f = a[0]
            arr.sort(key=functools.cmp_to_key(lambda x, y: _cmp_num(_call(i, f, [x, y]))))
        else:
            arr.sort(key=js_string)
        return arr

    def fn_flat(i, t, a):
        depth = int(js_number(a[0])) if a and a[0] is not undefined else 1
        return _flat(arr, depth)

    def fn_flatmap(i, t, a):
        out = []
        for j, v in enumerate(list(arr)):
            r = _call(i, a[0], [v, float(j), arr])
            out.extend(r if isinstance(r, list) else [r])
        return out

    def fn_splice(i, t, a):
        start = int(js_number(a[0])) if a else 0
        if start < 0:
            start = max(len(arr) + start, 0)
        count = int(js_number(a[1])) if len(a) > 1 else len(arr) - start
        removed = arr[start : start + count]
        arr[start : start + count] = list(a[2:])
        return removed

    table = {
        "push": lambda i, t, a: (arr.extend(a), float(len(arr)))[1],
        "pop": lambda i, t, a: arr.pop() if arr else undefined,
        "shift": lambda i, t, a: arr.pop(0) if arr else undefined,
        "unshift": lambda i, t, a: (arr.__setitem__(slice(0, 0), list(a)), float(len(arr)))[1],
        "slice": lambda i, t, a: arr[_norm_slice(arr, a, 0) : _norm_slice(arr, a, 1)],
        "splice": fn_splice,
        "indexOf": lambda i, t, a: float(_index_of(arr, a[0] if a else undefined)),
        "includes": lambda i, t, a: _index_of(arr, a[0] if a else undefined) >= 0,
        "join": lambda i, t, a: (js_string(a[0]) if a and a[0] is not undefined else ",").join(
            "" if v is undefined or v is None else js_string(v) for v in arr
        ),
        "map": fn_map,
        "filter": fn_filter,
        "reduce": fn_reduce,
        "forEach": fn_foreach,
        "find": fn_find,
        "findIndex": fn_findindex,
        "some": fn_some,
        "every": fn_every,
        "sort": fn_sort,
        "reverse": lambda i, t, a: (arr.reverse(), arr)[1],
        "concat": lambda i, t, a: arr + [x for v in a for x in (v if isinstance(v, list) else [v])],
        "flat": fn_flat,
        "flatMap": fn_flatmap,
        "fill": lambda i, t, a: (_fill(arr, a), arr)[1],
        "at": lambda i, t, a: _at(arr, a),
        "keys": lambda i, t, a: [float(j) for j in range(len(arr))],
        "entries": lambda i, t, a: [[float(j), v] for j, v in enumerate(arr)],
        "toString": lambda i, t, a: js_string(arr),
    }
    fn = table.get(name)
    return _nf(lambda i, t, a, _f=fn: _f(i, t, a)) if fn else None


def _cmp_num(v) -> int:
    n = js_number(v)
    if n != n:
        return 0
    return -1 if n < 0 else (1 if n > 0 else 0)


def _norm_slice(arr, a, pos):
    if pos >= len(a) or a[pos] is undefined:
        return None if pos == 1 else 0
    return int(js_number(a[pos]))


def _index_of(arr, v) -> int:
    from .js import _strict_eq

    for j, x in enumerate(arr):
        if _strict_eq(x, v):
            return j
    return -1


def _flat(arr, depth):
    out = []
    for v in arr:
        if isinstance(v, list) and depth > 0:
            out.extend(_flat(v, depth - 1))
        else:
            out.append(v)
    return out


def _fill(arr, a):
    v = a[0] if a else undefined
    lo = int(js_number(a[1])) if len(a) > 1 else 0
    hi = int(js_number(a[2])) if len(a) > 2 else len(arr)
    for j in range(max(lo, 0), min(hi, len(arr))):
        arr[j] = v


# ------------------------------------------------------------------ number
def number_method(interp, x: float, name: str):
    table = {
        "toFixed": lambda i, t, a: f"{x:.{int(js_number(a[0])) if a else 0}f}",
        "toString": lambda i, t, a: _radix_str(x, a),
        "toPrecision": lambda i, t, a: f"{x:.{int(js_number(a[0]))}g}" if a else _num_to_str(x),
        "valueOf": lambda i, t, a: x,
    }
    fn = table.get(name)
    return _nf(lambda i, t, a, _f=fn: _f(i, t, a)) if fn else None


def _radix_str(x: float, a):
    if not a or a[0] is undefined:
        return _num_to_str(x)
    radix = int(js_number(a[0]))
    if radix == 10:
        return _num_to_str(x)
    n = int(x)
    if n == 0:
        return "0"
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    neg = n < 0
    n = abs(n)
    out = []
    while n:
        n, r = divmod(n, radix)
        out.append(digits[r])
    return ("-" if neg else "") + "".join(reversed(out))


# ------------------------------------------------------------------ object
def object_method(interp, obj: dict, name: str):
    table = {
        "hasOwnProperty": lambda i, t, a: js_string(a[0]) in obj if a else False,
        "toString": lambda i, t, a: js_string(obj),
        "valueOf": lambda i, t, a: obj,
    }
    fn = table.get(name)
    return _nf(lambda i, t, a, _f=fn: _f(i, t, a)) if fn else None


# ------------------------------------------------------------------ globals
def _math_obj() -> Dict[str, Any]:
    import random as _random

    def one(f):
        return _nf(lambda i, t, a, _f=f: float(_f(js_number(a[0]) if a else float("nan"))))

    m: Dict[str, Any] = {
        "PI": _math.pi,
        "E": _math.e,
        "LN2": _math.log(2),
        "LN10": _math.log(10),
        "SQRT2": _math.sqrt(2),
        "abs": one(abs),
        "floor": one(_math.floor),
        "ceil": one(_math.ceil),
        "round": one(lambda x: _math.floor(x + 0.5)),
        "trunc": one(_math.trunc),
        "sqrt": one(lambda x: _math.sqrt(x) if x >= 0 else float("nan")),
        "cbrt": one(lambda x: _math.copysign(abs(x) ** (1 / 3), x)),
        "sign": one(lambda x: 0.0 if x == 0 else _math.copysign(1.0, x)),
        "exp": one(_math.exp),
        "log": one(lambda x: _math.log(x) if x > 0 else (float("-inf") if x == 0 else float("nan"))),
        "log2": one(lambda x: _math.log2(x) if x > 0 else (float("-inf") if x == 0 else float("nan"))),
        "log10": one(lambda x: _math.log10(x) if x > 0 else (float("-inf") if x == 0 else float("nan"))),
        "sin": one(_math.sin),
        "cos": one(_math.cos),
        "tan": one(_math.tan),
        "asin": one(lambda x: _math.asin(x) if -1 <= x <= 1 else float("nan")),
        "acos": one(lambda x: _math.acos(x) if -1 <= x <= 1 else float("nan")),
        "atan": one(_math.atan),
        "sinh": one(_math.sinh),
        "cosh": one(_math.cosh),
        "tanh": one(_math.tanh),
        "min": _nf(lambda i, t, a: float(min((js_number(x) for x in a), default=float("inf")))),
        "max": _nf(lambda i, t, a: float(max((js_number(x) for x in a), default=float("-inf")))),
        "pow": _nf(lambda i, t, a: float(js_number(a[0]) ** js_number(a[1])) if len(a) > 1 else float("nan")),
        "atan2": _nf(lambda i, t, a: float(_math.atan2(js_number(a[0]), js_number(a[1]))) if len(a) > 1 else float("nan")),
        "hypot": _nf(lambda i, t, a: float(_math.hypot(*[js_number(x) for x in a]))),
        "random": _nf(lambda i, t, a: _random.random()),
    }
    return m


def _json_obj() -> Dict[str, Any]:
    def stringify(i, t, a):
        if not a:
            return undefined
        indent = None
        if len(a) > 2 and a[2] is not undefined:
            indent = int(js_number(a[2])) if isinstance(a[2], (int, float)) else js_string(a[2])

        def default(v):
            if v is undefined:
                return None
            raise TypeError("not serializable")

        def clean(v):
            if v is undefined:
                return None
            if isinstance(v, float) and (v != v or v in (float("inf"), float("-inf"))):
                return None
            if isinstance(v, float) and v.is_integer() and abs(v) < 2**53:
                return int(v)
            if isinstance(v, list):
                return [clean(x) for x in v]
            if isinstance(v, dict):
                return {k: clean(x) for k, x in v.items() if x is not undefined and not isinstance(x, JSFunction)}
            if isinstance(v, JSFunction):
                return None
            return v

        v = a[0]
        if v is undefined or isinstance(v, JSFunction):
            return undefined
        return _json.dumps(clean(v), indent=indent, separators=(",", ":") if indent is None else None)

    def parse(i, t, a):
        if not a:
            raise ScriptError("JSON.parse expects a string")
        try:
            return _to_js(_json.loads(js_string(a[0])))
        except ValueError as e:
            raise ScriptError(f"SyntaxError: {e}") from None

    return {"stringify": _nf(stringify), "parse": _nf(parse)}


def _to_js(v):
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return v
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, list):
        return [_to_js(x) for x in v]
    if isinstance(v, dict):
        return {k: _to_js(x) for k, x in v.items()}
    return v


def _object_ctor() -> Any:
    def keys(i, t, a):
        o = a[0] if a else undefined
        if isinstance(o, dict):
            return list(o.keys())
        if isinstance(o, list):
            return [str(j) for j in range(len(o))]
        return []

    def values(i, t, a):
        o = a[0] if a else undefined
        if isinstance(o, dict):
            return list(o.values())
        if isinstance(o, list):
            return list(o)
        return []

    def entries(i, t, a):
        o = a[0] if a else undefined
        if isinstance(o, dict):
            return [[k, v] for k, v in o.items()]
        if isinstance(o, list):
            return [[str(j), v] for j, v in enumerate(o)]
        return []

    def assign(i, t, a):
        if not a or not isinstance(a[0], dict):
            raise ScriptError("Object.assign target must be an object")
        tgt = a[0]
        for src in a[1:]:
            if isinstance(src, dict):
                tgt.update(src)
        return tgt

    def fromentries(i, t, a):
        out = {}
        for pair in a[0] if a and isinstance(a[0], list) else []:
            if isinstance(pair, list) and len(pair) >= 2:
                out[js_string(pair[0])] = pair[1]
        return out

    def freeze(i, t, a):
        return a[0] if a else undefined

    ctor = _nf(lambda i, t, a: dict(a[0]) if a and isinstance(a[0], dict) else {})
    ctor.js_members = {
        "keys": _nf(keys),
        "values": _nf(values),
        "entries": _nf(entries),
        "assign": _nf(assign),
        "fromEntries": _nf(fromentries),
        "freeze": _nf(freeze),
    }
    ctor.js_construct = lambda i, a: dict(a[0]) if a and isinstance(a[0], dict) else {}
    return ctor


def _array_ctor() -> Any:
    def from_(i, t, a):
        if not a:
            return []
        src = a[0]
        if isinstance(src, str):
            items: List[Any] = list(src)
        elif isinstance(src, list):
            items = list(src)
        elif isinstance(src, dict) and "length" in src:
            items = [src.get(str(j), undefined) for j in range(int(js_number(src["length"])))]
        else:
            items = []
        if len(a) > 1:
            items = [_call(i, a[1], [v, float(j)]) for j, v in enumerate(items)]
        return items

    ctor = _nf(lambda i, t, a: _array_construct(a))
    ctor.js_members = {
        "isArray": _nf(lambda i, t, a: isinstance(a[0], list) if a else False),
        "from": _nf(from_),
        "of": _nf(lambda i, t, a: list(a)),
    }
    ctor.js_construct = lambda i, a: _array_construct(a)
    ctor.name = "Array"
    return ctor


def _array_construct(a):
    if len(a) == 1 and isinstance(a[0], (int, float)) and not isinstance(a[0], bool):
        return [undefined] * int(a[0])
    return list(a)


def _number_ctor() -> Any:
    ctor = _nf(lambda i, t, a: js_number(a[0]) if a else 0.0)
    ctor.js_members = {
        "isInteger": _nf(
            lambda i, t, a: isinstance(a[0], (int, float))
            and not isinstance(a[0], bool)
            and float(a[0]).is_integer()
            if a
            else False
        ),
        "isFinite": _nf(
            lambda i, t, a: isinstance(a[0], (int, float))
            and not isinstance(a[0], bool)
            and _math.isfinite(a[0])
            if a
            else False
        ),
        "isNaN": _nf(lambda i, t, a: isinstance(a[0], float) and a[0] != a[0] if a else False),
        "parseFloat": _nf(lambda i, t, a: js_number(js_string(a[0])) if a else float("nan")),
        "parseInt": _nf(lambda i, t, a: _parse_int(a)),
        "MAX_SAFE_INTEGER": float(2**53 - 1),
        "MIN_SAFE_INTEGER": float(-(2**53 - 1)),
        "EPSILON": 2.220446049250313e-16,
        "POSITIVE_INFINITY": float("inf"),
        "NEGATIVE_INFINITY": float("-inf"),
        "NaN": float("nan"),
    }
    return ctor


def _parse_int(a) -> float:
    if not a:
        return float("nan")
    s = js_string(a[0]).strip()
    radix = int(js_number(a[1])) if len(a) > 1 and a[1] is not undefined else 10
    neg = s.startswith("-")
    if s and s[0] in "+-":
        s = s[1:]
    if radix == 16 and s[:2].lower() == "0x":
        s = s[2:]
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:radix]
    out = 0
    seen = False
    for c in s.lower():
        if c not in digits:
            break
        out = out * radix + digits.index(c)
        seen = True
    if not seen:
        return float("nan")
    return float(-out if neg else out)


def _error_ctor(cls: str) -> Any:
    def construct(i, a):
        return _make_error(js_string(a[0]) if a else "", cls)

    ctor = _nf(lambda i, t, a: construct(i, a))
    ctor.js_construct = construct
    ctor.name = cls
    return ctor


def _date_ctor() -> Any:
    def construct(i, a):
        ts = js_number(a[0]) if a else _time.time() * 1000.0
        return {"__class__": "Date", "__ts__": ts}

    ctor = _nf(lambda i, t, a: js_string(_time.strftime("%a %b %d %Y")))
    ctor.js_members = {"now": _nf(lambda i, t, a: float(int(_time.time() * 1000)))}
    ctor.js_construct = construct
    ctor.name = "Date"
    return ctor


def build_globals() -> Dict[str, Any]:
    def console_log(i, t, a):
        i.console.append(" ".join(js_string(x) for x in a))
        return undefined

    console = {
        "log": _nf(console_log),
        "info": _nf(console_log),
        "warn": _nf(console_log),
        "error": _nf(console_log),
        "debug": _nf(console_log),
    }
    return {
        "Math": _math_obj(),
        "JSON": _json_obj(),
        "Object": _object_ctor(),
        "Array": _array_ctor(),
        "Number": _number_ctor(),
        "String": _nf(lambda i, t, a: js_string(a[0]) if a else ""),
        "Boolean": _nf(lambda i, t, a: js_truthy(a[0]) if a else False),
        "parseInt": _nf(lambda i, t, a: _parse_int(a)),
        "parseFloat": _nf(lambda i, t, a: js_number(js_string(a[0])) if a else float("nan")),
        "isNaN": _nf(lambda i, t, a: js_number(a[0]) != js_number(a[0]) if a else True),
        "isFinite": _nf(lambda i, t, a: _math.isfinite(js_number(a[0])) if a else False),
        "console": console,
        "Error": _error_ctor("Error"),
        "TypeError": _error_ctor("TypeError"),
        "RangeError": _error_ctor("RangeError"),
        "SyntaxError": _error_ctor("SyntaxError"),
        "Date": _date_ctor(),
        "NaN": float("nan"),
        "Infinity": float("inf"),
        "globalThis": {},
    }
