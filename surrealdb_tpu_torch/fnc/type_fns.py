"""type:: functions — conversions and type predicates
(reference: core/src/fnc/type.rs)."""

from __future__ import annotations

from surrealdb_tpu_torch.err import InvalidArgumentsError, TypeError_
from surrealdb_tpu_torch.sql.kind import Kind, coerce_cast
from surrealdb_tpu_torch.sql.value import (
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
)

from . import register


def _cast(kind):
    @register(f"type::{kind}")
    def f(ctx, v, _kind=kind):
        return coerce_cast(_kind, v)

    return f


for _k in ("bool", "bytes", "datetime", "decimal", "duration", "float", "int", "number", "string", "uuid", "array", "object"):
    _cast(_k)


@register("type::field")
def field(ctx, name):
    """Evaluate a field projection dynamically against the current doc."""
    from surrealdb_tpu_torch.syn import parse_value

    from surrealdb_tpu_torch.sql.path import Idiom

    expr = parse_value(str(name))
    return expr.compute(ctx)


@register("type::fields")
def fields(ctx, names):
    return [field(ctx, n) for n in (names if isinstance(names, list) else [names])]


@register("type::point")
def point(ctx, a, b=None):
    if b is not None:
        return Geometry("Point", [float(a), float(b)])
    if isinstance(a, (list, tuple)) and len(a) == 2:
        return Geometry("Point", [float(a[0]), float(a[1])])
    if isinstance(a, Geometry) and a.kind == "Point":
        return a
    raise InvalidArgumentsError("type::point", "Expected a point or two coordinates.")


@register("type::table")
def table(ctx, v):
    if isinstance(v, Table):
        return v
    if isinstance(v, Thing):
        return Table(v.tb)
    return Table(str(v))


@register("type::thing")
def thing(ctx, tb, id_=None):
    if id_ is None:
        if isinstance(tb, Thing):
            return tb
        return Thing.parse(str(tb))
    if isinstance(tb, Table):
        tb = str(tb)
    if isinstance(id_, Thing):
        id_ = id_.id
    return Thing(str(tb), id_)


@register("type::record")
def record(ctx, v, tb=None):
    t = v if isinstance(v, Thing) else Thing.parse(str(v))
    if tb is not None and t.tb != str(tb):
        raise TypeError_(f"Expected a record of table '{tb}'")
    return t


@register("type::range")
def range_(ctx, v):
    if isinstance(v, Range):
        return v
    if isinstance(v, list) and len(v) == 2:
        return Range(v[0], v[1], True, True)
    raise InvalidArgumentsError("type::range", "Expected a range or a two-element array.")


@register("type::geometry")
def geometry(ctx, v):
    if isinstance(v, Geometry):
        return v
    return coerce_cast("geometry", v)


# -------------------------------------------------------------- predicates
@register("type::is::array")
def is_array(ctx, v):
    return isinstance(v, list)


@register("type::is::bool")
def is_bool(ctx, v):
    return isinstance(v, bool)


@register("type::is::bytes")
def is_bytes(ctx, v):
    return isinstance(v, bytes)


@register("type::is::datetime")
def is_datetime(ctx, v):
    return isinstance(v, Datetime)


@register("type::is::decimal")
def is_decimal(ctx, v):
    import decimal as _dec

    return isinstance(v, _dec.Decimal)


@register("type::is::duration")
def is_duration(ctx, v):
    return isinstance(v, Duration)


@register("type::is::float")
def is_float(ctx, v):
    return isinstance(v, float)


@register("type::is::int")
def is_int(ctx, v):
    return isinstance(v, int) and not isinstance(v, bool)


@register("type::is::number")
def is_number(ctx, v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


@register("type::is::none")
def is_none_(ctx, v):
    return is_none(v)


@register("type::is::null")
def is_null_(ctx, v):
    return is_null(v)


@register("type::is::object")
def is_object(ctx, v):
    return isinstance(v, dict)


@register("type::is::record")
def is_record(ctx, v, tb=None):
    return isinstance(v, Thing) and (tb is None or v.tb == str(tb))


@register("type::is::string")
def is_string(ctx, v):
    return isinstance(v, str) and not isinstance(v, Table)


@register("type::is::uuid")
def is_uuid(ctx, v):
    return isinstance(v, Uuid)


@register("type::is::geometry")
def is_geometry(ctx, v):
    return isinstance(v, Geometry)


@register("type::is::point")
def is_point(ctx, v):
    return isinstance(v, Geometry) and v.kind == "Point"


@register("type::is::line")
def is_line(ctx, v):
    return isinstance(v, Geometry) and v.kind == "LineString"


@register("type::is::polygon")
def is_polygon(ctx, v):
    return isinstance(v, Geometry) and v.kind == "Polygon"


@register("type::is::collection")
def is_collection(ctx, v):
    return isinstance(v, Geometry) and v.kind == "GeometryCollection"


@register("type::is::multipoint")
def is_multipoint(ctx, v):
    return isinstance(v, Geometry) and v.kind == "MultiPoint"


@register("type::is::multiline")
def is_multiline(ctx, v):
    return isinstance(v, Geometry) and v.kind == "MultiLineString"


@register("type::is::multipolygon")
def is_multipolygon(ctx, v):
    return isinstance(v, Geometry) and v.kind == "MultiPolygon"
