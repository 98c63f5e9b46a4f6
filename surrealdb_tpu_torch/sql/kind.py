"""Type kinds: casts and field-type coercion.

Role of the reference's Kind enum + Value::coerce_to/convert_to
(reference: core/src/sql/kind.rs, sql/value/coerce.rs, convert.rs).
Kind syntax: any | null | bool | bytes | datetime | duration | float | int |
number | decimal | object | point | string | uuid | regex | record<a|b> |
geometry<kind> | option<K> | array<K, n> | set<K, n> | either `A | B`.
"""

from __future__ import annotations

import math
import uuid as _uuid
from typing import Any, List, Optional

from surrealdb_tpu_torch.err import TypeError_
from .value import (
    NONE,
    Datetime,
    Duration,
    Geometry,
    Null,
    Range,
    Table,
    Thing,
    Uuid,
    format_value,
    is_none,
    is_null,
    is_nullish,
    truthy,
    value_eq,
)


class Kind:
    """Parsed type kind."""

    __slots__ = ("name", "args", "size")

    def __init__(self, name: str, args: Optional[List] = None, size: Optional[int] = None):
        self.name = name  # lowercase base name, or 'either'
        self.args = args or []  # inner kinds / record tables / literal values
        self.size = size

    def __repr__(self):
        if self.name == "either":
            return " | ".join(repr(a) for a in self.args)
        if self.name == "record" and self.args:
            return f"record<{' | '.join(self.args)}>"
        if self.name in ("array", "set") and self.args:
            inner = repr(self.args[0])
            if self.size is not None:
                return f"{self.name}<{inner}, {self.size}>"
            return f"{self.name}<{inner}>"
        if self.name == "option" and self.args:
            return f"option<{self.args[0]!r}>"
        if self.name == "geometry" and self.args:
            return f"geometry<{'|'.join(self.args)}>"
        if self.name == "literal":
            return format_value(self.args[0])
        return self.name

    def __eq__(self, other):
        return isinstance(other, Kind) and repr(self) == repr(other)


def _err(v, kind) -> TypeError_:
    return TypeError_(
        f"Expected a {kind} but found {format_value(v)}"
    )


def coerce(kind: Kind, v: Any, strict: bool = True) -> Any:
    """Coerce value to kind (field TYPE checking). strict=False = cast mode
    (more lenient conversions, e.g. string->int)."""
    name = kind.name
    if name == "any":
        return v
    if name == "option":
        if is_nullish(v):
            return v
        return coerce(kind.args[0], v, strict)
    if name == "either":
        last = None
        for k in kind.args:
            try:
                return coerce(k, v, strict)
            except TypeError_ as e:
                last = e
        raise last or _err(v, kind)
    if name == "literal":
        if value_eq(v, kind.args[0]):
            return v
        raise _err(v, kind)
    if name == "null":
        if is_null(v):
            return Null
        raise _err(v, "null")
    if name == "bool":
        if isinstance(v, bool):
            return v
        if not strict:
            if isinstance(v, str):
                if v.lower() == "true":
                    return True
                if v.lower() == "false":
                    return False
            return truthy(v)
        raise _err(v, "bool")
    if name == "int":
        if isinstance(v, bool):
            raise _err(v, "int")
        if isinstance(v, int):
            return v
        if isinstance(v, float) and v == int(v):
            return int(v)
        if not strict:
            if isinstance(v, str):
                try:
                    return int(float(v)) if "." in v or "e" in v.lower() else int(v)
                except ValueError:
                    raise _err(v, "int")
            if isinstance(v, float):
                return int(v)
        raise _err(v, "int")
    if name == "float":
        if isinstance(v, bool):
            raise _err(v, "float")
        if isinstance(v, float):
            return v
        if isinstance(v, int):
            return float(v)
        if not strict and isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                raise _err(v, "float")
        raise _err(v, "float")
    if name == "decimal":
        import decimal as _dec

        if isinstance(v, bool):
            raise _err(v, name)
        if isinstance(v, _dec.Decimal):
            return v
        if isinstance(v, int):
            return _dec.Decimal(v)
        if isinstance(v, float):
            return _dec.Decimal(repr(v))
        if not strict and isinstance(v, str):
            try:
                return _dec.Decimal(v)
            except _dec.InvalidOperation:
                raise _err(v, "decimal")
        raise _err(v, "decimal")
    if name == "number":
        import decimal as _dec

        if isinstance(v, bool):
            raise _err(v, name)
        if isinstance(v, (int, float, _dec.Decimal)):
            return v
        if not strict and isinstance(v, str):
            try:
                return int(v)
            except ValueError:
                try:
                    return float(v)
                except ValueError:
                    raise _err(v, name)
        raise _err(v, name)
    if name == "string":
        if isinstance(v, str) and not isinstance(v, Table):
            return v
        if not strict:
            if isinstance(v, bytes):
                return v.decode("utf-8", "replace")
            if is_nullish(v):
                raise _err(v, "string")
            if isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, (int,)):
                return str(v)
            if isinstance(v, float):
                return repr(v) if v != int(v) else str(v)
            if isinstance(v, (Thing, Duration)):
                return repr(v)
            if isinstance(v, Datetime):
                return repr(v)[2:-1]
            if isinstance(v, Uuid):
                return str(v.value)
            if isinstance(v, Table):
                return str(v)
        raise _err(v, "string")
    if name == "bytes":
        if isinstance(v, bytes):
            return v
        if not strict and isinstance(v, str):
            return v.encode()
        raise _err(v, "bytes")
    if name == "datetime":
        if isinstance(v, Datetime):
            return v
        if not strict and isinstance(v, str):
            try:
                return Datetime.parse(v)
            except ValueError:
                raise _err(v, "datetime")
        raise _err(v, "datetime")
    if name == "duration":
        if isinstance(v, Duration):
            return v
        if not strict and isinstance(v, str):
            try:
                return Duration.parse(v)
            except ValueError:
                raise _err(v, "duration")
        raise _err(v, "duration")
    if name == "uuid":
        if isinstance(v, Uuid):
            return v
        if isinstance(v, _uuid.UUID):
            return Uuid(v)
        if not strict and isinstance(v, str):
            try:
                return Uuid(_uuid.UUID(v))
            except ValueError:
                raise _err(v, "uuid")
        raise _err(v, "uuid")
    if name == "record":
        if isinstance(v, Thing):
            if kind.args and v.tb not in kind.args:
                raise _err(v, f"record<{'|'.join(kind.args)}>")
            return v
        if not strict and isinstance(v, str):
            from surrealdb_tpu_torch.syn import parse_thing

            t = parse_thing(v)
            if kind.args and t.tb not in kind.args:
                raise _err(v, f"record<{'|'.join(kind.args)}>")
            return t
        raise _err(v, "record")
    if name == "object":
        if isinstance(v, dict):
            return v
        raise _err(v, "object")
    if name in ("array", "set"):
        if not isinstance(v, (list, tuple)):
            if strict:
                raise _err(v, name)
            v = [v]
        out = list(v)
        if kind.args:
            out = [coerce(kind.args[0], x, strict) for x in out]
        if name == "set":
            dedup = []
            for x in out:
                if not any(value_eq(x, y) for y in dedup):
                    dedup.append(x)
            out = dedup
        if kind.size is not None and len(out) > kind.size:
            raise TypeError_(
                f"Expected a {kind!r} but found an array of length {len(out)}"
            )
        return out
    if name == "geometry":
        if isinstance(v, Geometry):
            if kind.args and v.kind.lower() not in [a.lower() for a in kind.args]:
                raise _err(v, f"geometry<{'|'.join(kind.args)}>")
            return v
        if isinstance(v, dict) and "type" in v and ("coordinates" in v or "geometries" in v):
            g = Geometry(v["type"], v.get("coordinates", v.get("geometries")))
            return coerce(kind, g, strict)
        raise _err(v, "geometry")
    if name == "point":
        if isinstance(v, Geometry) and v.kind == "Point":
            return v
        if isinstance(v, (list, tuple)) and len(v) == 2:
            return Geometry("Point", list(v))
        raise _err(v, "point")
    if name in ("function", "closure"):
        from .value import Closure

        if isinstance(v, Closure):
            return v
        raise _err(v, "function")
    if name == "range":
        if isinstance(v, Range):
            return v
        raise _err(v, "range")
    if name == "regex":
        import re

        if isinstance(v, re.Pattern):
            return v
        if not strict and isinstance(v, str):
            return re.compile(v)
        raise _err(v, "regex")
    raise TypeError_(f"unknown kind {name}")


def coerce_cast(kind_text, v: Any) -> Any:
    """<int> style cast — lenient conversions."""
    kind = kind_text if isinstance(kind_text, Kind) else parse_kind_text(kind_text)
    return coerce(kind, v, strict=False)


def parse_kind_text(text: str) -> Kind:
    from surrealdb_tpu_torch.syn import parse_kind

    return parse_kind(text)
