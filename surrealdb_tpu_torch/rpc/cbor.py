"""CBOR wire format (RFC 8949) with SurrealDB's tag scheme.

Role of the reference's cbor format (reference: core/src/rpc/format/cbor/
convert.rs — the format real SurrealDB SDKs speak). Tags implemented
bidirectionally:

    0   datetime (RFC3339 text, decode)      12  datetime [secs, nanos]
    6   NONE                                 13  duration (text, decode)
    7   table                                14  duration [secs, nanos]
    8   record id (text or [tb, id])         37  uuid (bytes)
    9   uuid (text, decode)                  49  range  (50/51 bounds)
    10  decimal (text)                       88+ geometries

Self-contained encoder/decoder — no third-party cbor dependency exists in
this environment.
"""

from __future__ import annotations

import decimal as _decimal
import math
import struct
from typing import Any, List, Tuple

from surrealdb_tpu_torch.err import SurrealError
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
    is_none,
    is_null,
)

TAG_SPEC_DATETIME = 0
TAG_NONE = 6
TAG_TABLE = 7
TAG_RECORDID = 8
TAG_STRING_UUID = 9
TAG_STRING_DECIMAL = 10
TAG_CUSTOM_DATETIME = 12
TAG_STRING_DURATION = 13
TAG_CUSTOM_DURATION = 14
TAG_SPEC_UUID = 37
TAG_RANGE = 49
TAG_BOUND_INCLUDED = 50
TAG_BOUND_EXCLUDED = 51
TAG_GEOMETRY_POINT = 88
TAG_GEOMETRY_LINE = 89
TAG_GEOMETRY_POLYGON = 90
TAG_GEOMETRY_MULTIPOINT = 91
TAG_GEOMETRY_MULTILINE = 92
TAG_GEOMETRY_MULTIPOLYGON = 93
TAG_GEOMETRY_COLLECTION = 94

_GEOM_TAGS = {
    "Point": TAG_GEOMETRY_POINT,
    "LineString": TAG_GEOMETRY_LINE,
    "Polygon": TAG_GEOMETRY_POLYGON,
    "MultiPoint": TAG_GEOMETRY_MULTIPOINT,
    "MultiLineString": TAG_GEOMETRY_MULTILINE,
    "MultiPolygon": TAG_GEOMETRY_MULTIPOLYGON,
    "GeometryCollection": TAG_GEOMETRY_COLLECTION,
}
_GEOM_NAMES = {v: k for k, v in _GEOM_TAGS.items()}


# ------------------------------------------------------------------ encoder
def _head(major: int, n: int) -> bytes:
    if n < 24:
        return bytes([(major << 5) | n])
    if n < 0x100:
        return bytes([(major << 5) | 24, n])
    if n < 0x10000:
        return bytes([(major << 5) | 25]) + struct.pack(">H", n)
    if n < 0x100000000:
        return bytes([(major << 5) | 26]) + struct.pack(">I", n)
    return bytes([(major << 5) | 27]) + struct.pack(">Q", n)


def _enc_tag(tag: int, payload: bytes) -> bytes:
    return _head(6, tag) + payload


def encode(v: Any) -> bytes:
    out = bytearray()
    _enc(v, out)
    return bytes(out)


def _enc(v: Any, out: bytearray) -> None:
    if is_none(v):
        out += _enc_tag(TAG_NONE, b"\xf6")  # tag 6 + null
        return
    if v is None or is_null(v):
        out += b"\xf6"
        return
    if isinstance(v, bool):
        out += b"\xf5" if v else b"\xf4"
        return
    if isinstance(v, int):
        if v >= 0:
            out += _head(0, v)
        else:
            out += _head(1, -1 - v)
        return
    if isinstance(v, float):
        out += b"\xfb" + struct.pack(">d", v)
        return
    if isinstance(v, _decimal.Decimal):
        s = format(v, "f")
        out += _enc_tag(TAG_STRING_DECIMAL, _head(3, len(s.encode())) + s.encode())
        return
    if isinstance(v, Table):  # before str — Table subclasses str
        out += _enc_tag(TAG_TABLE, encode(str(v)))
        return
    if isinstance(v, str):
        b = v.encode()
        out += _head(3, len(b)) + b
        return
    if isinstance(v, bytes):
        out += _head(2, len(v)) + v
        return
    if isinstance(v, Duration):
        secs, nanos = divmod(v.nanos, 1_000_000_000)
        if secs == 0 and nanos == 0:
            payload = encode([])
        elif nanos == 0:
            payload = encode([secs])
        else:
            payload = encode([secs, nanos])
        out += _enc_tag(TAG_CUSTOM_DURATION, payload)
        return
    if isinstance(v, Datetime):
        secs, nanos = divmod(v.nanos, 1_000_000_000)
        out += _enc_tag(TAG_CUSTOM_DATETIME, encode([secs, nanos]))
        return
    if isinstance(v, Uuid):
        out += _enc_tag(TAG_SPEC_UUID, _head(2, 16) + v.value.bytes)
        return
    if isinstance(v, Thing):
        out += _head(6, TAG_RECORDID)
        inner = bytearray()
        _enc(v.tb, inner)
        if isinstance(v.id, Range):
            inner += _enc_tag(TAG_RANGE, _enc_range_payload(v.id))
        else:
            _enc(v.id, inner)
        out += _head(4, 2) + inner
        return
    if isinstance(v, Range):
        out += _enc_tag(TAG_RANGE, _enc_range_payload(v))
        return
    if isinstance(v, Geometry):
        tag = _GEOM_TAGS.get(v.kind)
        if tag is None:
            raise SurrealError(f"cannot encode geometry {v.kind} as CBOR")
        out += _enc_tag(tag, encode(v.coords))
        return
    if isinstance(v, (list, tuple)):
        out += _head(4, len(v))
        for item in v:
            _enc(item, out)
        return
    if type(v).__name__ == "ndarray":  # packed vector -> plain CBOR array
        _enc(v.tolist(), out)
        return
    if isinstance(v, dict):
        out += _head(5, len(v))
        for k, item in v.items():
            _enc(str(k), out)
            _enc(item, out)
        return
    raise SurrealError(f"cannot encode {type(v).__name__} as CBOR")


def _enc_range_payload(r: Range) -> bytes:
    def bound(val, incl: bool) -> bytes:
        if is_none(val) or val is None:
            return b"\xf6"
        tag = TAG_BOUND_INCLUDED if incl else TAG_BOUND_EXCLUDED
        return _enc_tag(tag, encode(val))

    return _head(4, 2) + bound(r.beg, r.beg_incl) + bound(r.end, r.end_incl)


# ------------------------------------------------------------------ decoder
class _Dec:
    def __init__(self, data: bytes):
        self.b = data
        self.i = 0

    def u8(self) -> int:
        if self.i >= len(self.b):
            raise SurrealError("truncated CBOR")
        v = self.b[self.i]
        self.i += 1
        return v

    def peek(self) -> int:
        if self.i >= len(self.b):
            raise SurrealError("truncated CBOR")
        return self.b[self.i]

    def read(self, n: int) -> bytes:
        if n < 0 or self.i + n > len(self.b):
            raise SurrealError("truncated CBOR")
        v = self.b[self.i : self.i + n]
        self.i += n
        return v

    def length(self, info: int) -> int:
        if info < 24:
            return info
        if info == 24:
            return self.u8()
        if info == 25:
            return struct.unpack(">H", self.read(2))[0]
        if info == 26:
            return struct.unpack(">I", self.read(4))[0]
        if info == 27:
            return struct.unpack(">Q", self.read(8))[0]
        if info == 31:
            return -1  # indefinite
        raise SurrealError("bad CBOR length")

    def value(self) -> Any:
        ib = self.u8()
        major, info = ib >> 5, ib & 0x1F
        if major == 0:
            return self.length(info)
        if major == 1:
            return -1 - self.length(info)
        if major == 2:
            return self._chunks(info, 2)
        if major == 3:
            try:
                return self._chunks(info, 3).decode()
            except UnicodeDecodeError:
                raise SurrealError("invalid CBOR text (not UTF-8)")
        if major == 4:
            n = self.length(info)
            if n < 0:
                out: List[Any] = []
                while self.peek() != 0xFF:
                    out.append(self.value())
                self.i += 1
                return out
            return [self.value() for _ in range(n)]
        if major == 5:
            n = self.length(info)
            obj = {}
            if n < 0:
                while self.peek() != 0xFF:
                    k = self.value()
                    obj[str(k)] = self.value()
                self.i += 1
                return obj
            for _ in range(n):
                k = self.value()
                obj[str(k)] = self.value()
            return obj
        if major == 6:
            tag = self.length(info)
            payload = self.value()
            try:
                return _untag(tag, payload)
            except SurrealError:
                raise
            except (TypeError, ValueError, IndexError, KeyError, AttributeError, OverflowError):
                raise SurrealError(f"malformed CBOR tag {tag} payload")
        # major 7: simple / float
        if info == 20:
            return False
        if info == 21:
            return True
        if info == 22:
            return Null
        if info == 23:
            return NONE  # undefined ~ NONE
        if info == 25:
            return _half(struct.unpack(">H", self.read(2))[0])
        if info == 26:
            return struct.unpack(">f", self.read(4))[0]
        if info == 27:
            return struct.unpack(">d", self.read(8))[0]
        raise SurrealError(f"unsupported CBOR simple value {info}")

    def _chunks(self, info: int, major: int) -> bytes:
        n = self.length(info)
        if n >= 0:
            return self.read(n)
        out = bytearray()
        while self.peek() != 0xFF:
            ib = self.u8()
            if ib >> 5 != major:
                raise SurrealError("bad indefinite chunk")
            m = self.length(ib & 0x1F)
            if m < 0:  # nested indefinite chunk is invalid (RFC 8949 §3.2.3)
                raise SurrealError("bad indefinite chunk")
            out += self.read(m)
        self.i += 1
        return bytes(out)


def _half(h: int) -> float:
    sign = -1.0 if h & 0x8000 else 1.0
    exp = (h >> 10) & 0x1F
    frac = h & 0x3FF
    if exp == 0:
        return sign * frac * 2.0**-24
    if exp == 31:
        return sign * (math.inf if frac == 0 else math.nan)
    return sign * (1 + frac / 1024.0) * 2.0 ** (exp - 15)


def _untag(tag: int, v: Any) -> Any:
    if tag == TAG_NONE:
        return NONE
    if tag == TAG_SPEC_DATETIME:
        return Datetime.parse(str(v))
    if tag == TAG_CUSTOM_DATETIME:
        secs = int(v[0]) if len(v) > 0 else 0
        nanos = int(v[1]) if len(v) > 1 else 0
        return Datetime(secs * 1_000_000_000 + nanos)
    if tag == TAG_STRING_UUID:
        import uuid as _uuid

        return Uuid(_uuid.UUID(str(v)))
    if tag == TAG_SPEC_UUID:
        import uuid as _uuid

        if not isinstance(v, (bytes, bytearray)) or len(v) != 16:
            raise SurrealError("Expected a 16-byte UUID payload")
        return Uuid(_uuid.UUID(bytes=bytes(v)))
    if tag == TAG_STRING_DECIMAL:
        try:
            return _decimal.Decimal(str(v))
        except _decimal.InvalidOperation:
            raise SurrealError("Expected a valid Decimal value")
    if tag == TAG_STRING_DURATION:
        return Duration.parse(str(v))
    if tag == TAG_CUSTOM_DURATION:
        secs = int(v[0]) if len(v) > 0 else 0
        nanos = int(v[1]) if len(v) > 1 else 0
        return Duration(secs * 1_000_000_000 + nanos)
    if tag == TAG_RECORDID:
        if isinstance(v, str):
            return Thing.parse(v)
        if isinstance(v, list) and len(v) == 2:
            tb = str(v[0]) if not isinstance(v[0], Table) else str(v[0])
            return Thing(tb, v[1])
        raise SurrealError("Expected a text or 2-element record id")
    if tag == TAG_TABLE:
        return Table(str(v))
    if tag == TAG_RANGE:
        return _dec_range(v)
    if tag in (TAG_BOUND_INCLUDED, TAG_BOUND_EXCLUDED):
        return (tag, v)  # resolved by _dec_range
    if tag in _GEOM_NAMES:
        return Geometry(_GEOM_NAMES[tag], v)
    return v  # unknown tags pass their payload through


def _dec_range(v: Any) -> Range:
    def bound(b):
        if b is None or is_null(b) or is_none(b):
            return NONE, True
        if isinstance(b, tuple) and len(b) == 2 and b[0] in (TAG_BOUND_INCLUDED, TAG_BOUND_EXCLUDED):
            return b[1], b[0] == TAG_BOUND_INCLUDED
        return b, True

    beg, beg_incl = bound(v[0] if len(v) > 0 else None)
    end, end_incl = bound(v[1] if len(v) > 1 else None)
    return Range(beg, end, beg_incl, end_incl)


def decode(data: bytes) -> Any:
    try:
        return _decode_inner(data)
    except RecursionError:
        raise SurrealError("CBOR value is too deeply nested") from None


def _decode_inner(data: bytes) -> Any:
    d = _Dec(data)
    v = d.value()
    return v
