"""geo:: functions (reference: core/src/fnc/geo.rs)."""

from __future__ import annotations

import math

from surrealdb_tpu_torch.err import InvalidArgumentsError
from surrealdb_tpu_torch.sql.value import Geometry, NONE

from . import register

_EARTH_RADIUS_M = 6_371_008.8
_GEOHASH32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def _point(v, name):
    if isinstance(v, Geometry) and v.kind == "Point":
        return v.coords
    if isinstance(v, (list, tuple)) and len(v) == 2:
        return [float(v[0]), float(v[1])]
    raise InvalidArgumentsError(name, "Expected a point.")


@register("geo::distance")
def distance(ctx, a, b):
    (lon1, lat1) = _point(a, "geo::distance")
    (lon2, lat2) = _point(b, "geo::distance")
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = math.radians(lat2 - lat1)
    dl = math.radians(lon2 - lon1)
    h = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * _EARTH_RADIUS_M * math.asin(math.sqrt(h))


@register("geo::bearing")
def bearing(ctx, a, b):
    (lon1, lat1) = _point(a, "geo::bearing")
    (lon2, lat2) = _point(b, "geo::bearing")
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dl = math.radians(lon2 - lon1)
    y = math.sin(dl) * math.cos(p2)
    x = math.cos(p1) * math.sin(p2) - math.sin(p1) * math.cos(p2) * math.cos(dl)
    return (math.degrees(math.atan2(y, x)) + 360) % 360


@register("geo::centroid")
def centroid(ctx, g):
    if isinstance(g, Geometry):
        if g.kind == "Point":
            return g
        if g.kind == "Polygon":
            ring = g.coords[0]
            n = max(len(ring) - 1, 1)
            lon = sum(p[0] for p in ring[:n]) / n
            lat = sum(p[1] for p in ring[:n]) / n
            return Geometry("Point", [lon, lat])
        if g.kind == "LineString":
            n = len(g.coords)
            lon = sum(p[0] for p in g.coords) / n
            lat = sum(p[1] for p in g.coords) / n
            return Geometry("Point", [lon, lat])
    raise InvalidArgumentsError("geo::centroid", "Expected a geometry.")


@register("geo::area")
def area(ctx, g):
    if not isinstance(g, Geometry) or g.kind != "Polygon":
        raise InvalidArgumentsError("geo::area", "Expected a polygon.")

    def ring_area(ring):
        # spherical excess approximation per ring
        total = 0.0
        for i in range(len(ring) - 1):
            lon1, lat1 = ring[i]
            lon2, lat2 = ring[i + 1]
            total += math.radians(lon2 - lon1) * (
                2 + math.sin(math.radians(lat1)) + math.sin(math.radians(lat2))
            )
        return abs(total * _EARTH_RADIUS_M**2 / 2)

    out = ring_area(g.coords[0])
    for hole in g.coords[1:]:
        out -= ring_area(hole)
    return out


@register("geo::hash::encode")
def hash_encode(ctx, p, precision=None):
    (lon, lat) = _point(p, "geo::hash::encode")
    prec = int(precision) if precision is not None else 12
    lat_rng = [-90.0, 90.0]
    lon_rng = [-180.0, 180.0]
    out = []
    bit = 0
    ch = 0
    even = True
    while len(out) < prec:
        if even:
            mid = (lon_rng[0] + lon_rng[1]) / 2
            if lon > mid:
                ch |= 1 << (4 - bit)
                lon_rng[0] = mid
            else:
                lon_rng[1] = mid
        else:
            mid = (lat_rng[0] + lat_rng[1]) / 2
            if lat > mid:
                ch |= 1 << (4 - bit)
                lat_rng[0] = mid
            else:
                lat_rng[1] = mid
        even = not even
        if bit < 4:
            bit += 1
        else:
            out.append(_GEOHASH32[ch])
            bit = 0
            ch = 0
    return "".join(out)


@register("geo::hash::decode")
def hash_decode(ctx, h):
    if not isinstance(h, str):
        raise InvalidArgumentsError("geo::hash::decode", "Expected a string.")
    lat_rng = [-90.0, 90.0]
    lon_rng = [-180.0, 180.0]
    even = True
    for c in h:
        cd = _GEOHASH32.index(c)
        for bit in range(5):
            mask = 1 << (4 - bit)
            if even:
                mid = (lon_rng[0] + lon_rng[1]) / 2
                if cd & mask:
                    lon_rng[0] = mid
                else:
                    lon_rng[1] = mid
            else:
                mid = (lat_rng[0] + lat_rng[1]) / 2
                if cd & mask:
                    lat_rng[0] = mid
                else:
                    lat_rng[1] = mid
            even = not even
    return Geometry(
        "Point",
        [(lon_rng[0] + lon_rng[1]) / 2, (lat_rng[0] + lat_rng[1]) / 2],
    )


@register("geo::is::valid")
def is_valid(ctx, g):
    if not isinstance(g, Geometry):
        return False
    if g.kind == "Point":
        lon, lat = g.coords
        return -180.0 <= lon <= 180.0 and -90.0 <= lat <= 90.0
    return True
