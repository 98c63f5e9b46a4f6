"""Binary serialization of Values for KV storage.

The reference stores records with a versioned bincode-style format
(`revisioned`); we use msgpack with extension types for the SurrealQL-specific
value kinds. This is the storage codec, not a wire format.
"""

from __future__ import annotations

import decimal as _decimal
import uuid as _uuid
from typing import Any

import msgpack

from surrealdb_tpu_torch.sql.value import (
    NONE,
    Closure,
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

EXT_NONE = 1
EXT_THING = 2
EXT_DURATION = 3
EXT_DATETIME = 4
EXT_UUID = 5
EXT_GEOMETRY = 6
EXT_RANGE = 7
EXT_TABLE = 8
EXT_DECIMAL = 9
EXT_VEC = 10  # packed numeric vector (numpy 1-D), reference trees/vector.rs:23
EXT_PYOBJ = 32  # AST nodes inside catalog definitions (Kind, Expr, ...)

# packed-vector dtype whitelist: order is the wire code
_VEC_DTYPES = ("f4", "f8", "i8", "i4", "i2")


def _pack_vec(v) -> msgpack.ExtType:
    import numpy as np

    if v.ndim != 1:
        raise TypeError("only 1-D numeric arrays are storable as packed vectors")
    code = v.dtype.str[1:]  # e.g. '<f4' -> 'f4'
    if code not in _VEC_DTYPES:
        v = np.asarray(v, dtype=np.float32)
        code = "f4"
    return msgpack.ExtType(
        EXT_VEC, bytes([_VEC_DTYPES.index(code)]) + np.ascontiguousarray(v).tobytes()
    )


def _unpack_vec(data: bytes):
    import numpy as np

    dt = np.dtype(_VEC_DTYPES[data[0]])
    return np.frombuffer(data[1:], dtype=dt)


def _default(v: Any, packer=None):
    # `packer` encodes nested container payloads (Thing ids, Geometry coords,
    # Range bounds) and must stay the SAME codec as the outer encode — if the
    # wire codec nested through the trusted one, an engine-internal object
    # hidden inside a Thing id would still be pickled onto the wire.
    packer = packer or pack
    if is_none(v):
        return msgpack.ExtType(EXT_NONE, b"")
    if is_null(v):
        return None  # NULL round-trips as msgpack nil
    if isinstance(v, Thing):
        return msgpack.ExtType(EXT_THING, packer({"tb": v.tb, "id": v.id}))
    if isinstance(v, Duration):
        return msgpack.ExtType(EXT_DURATION, msgpack.packb(v.nanos))
    if isinstance(v, Datetime):
        return msgpack.ExtType(EXT_DATETIME, msgpack.packb(v.nanos))
    if isinstance(v, _decimal.Decimal):
        return msgpack.ExtType(EXT_DECIMAL, str(v).encode())
    if isinstance(v, Uuid):
        return msgpack.ExtType(EXT_UUID, v.value.bytes)
    if isinstance(v, _uuid.UUID):
        return msgpack.ExtType(EXT_UUID, v.bytes)
    if isinstance(v, Geometry):
        return msgpack.ExtType(EXT_GEOMETRY, packer({"k": v.kind, "c": v.coords}))
    if isinstance(v, Range):
        return msgpack.ExtType(
            EXT_RANGE,
            packer({"b": v.beg, "e": v.end, "bi": v.beg_incl, "ei": v.end_incl}),
        )
    if isinstance(v, Table):
        return msgpack.ExtType(EXT_TABLE, str(v).encode())
    if isinstance(v, tuple):
        return list(v)
    if type(v).__name__ == "ndarray" and type(v).__module__ == "numpy":
        return _pack_vec(v)
    # catalog definitions embed AST nodes (field kinds, VALUE/ASSERT exprs,
    # view selects); these are engine-internal values, pickled as-is
    mod = type(v).__module__
    if mod.startswith("surrealdb_tpu_torch."):
        import pickle

        return msgpack.ExtType(EXT_PYOBJ, pickle.dumps(v))
    raise TypeError(f"cannot serialize {type(v).__name__}")


def _ext_hook(code: int, data: bytes, recurse=None):
    # `recurse` decodes nested container payloads (Thing ids, Geometry coords,
    # Range bounds) and must stay the SAME codec as the outer decode — if the
    # wire codec recursed through the trusted one, a pickle ext nested inside
    # EXT_THING would bypass the EXT_PYOBJ rejection.
    recurse = recurse or unpack
    if code == EXT_NONE:
        return NONE
    if code == EXT_THING:
        d = recurse(data)
        return Thing(d["tb"], d["id"])
    if code == EXT_DURATION:
        return Duration(msgpack.unpackb(data))
    if code == EXT_DATETIME:
        return Datetime(msgpack.unpackb(data))
    if code == EXT_DECIMAL:
        return _decimal.Decimal(data.decode())
    if code == EXT_UUID:
        return Uuid(_uuid.UUID(bytes=data))
    if code == EXT_GEOMETRY:
        d = recurse(data)
        return Geometry(d["k"], d["c"])
    if code == EXT_RANGE:
        d = recurse(data)
        return Range(d["b"], d["e"], d["bi"], d["ei"])
    if code == EXT_TABLE:
        return Table(data.decode())
    if code == EXT_VEC:
        return _unpack_vec(data)
    if code == EXT_PYOBJ:
        import pickle

        return pickle.loads(data)
    return msgpack.ExtType(code, data)


def _wire_ext_hook(code: int, data: bytes):
    # Network-facing decode: EXT_PYOBJ carries pickled engine internals and is
    # storage-codec-only. Accepting it from the wire would hand remote clients
    # arbitrary code execution via pickle.loads, so it is rejected outright —
    # at every nesting depth, not just the top level.
    if code == EXT_PYOBJ:
        raise ValueError("EXT_PYOBJ is not accepted on the wire")
    return _ext_hook(code, data, recurse=wire_unpack)


def _wire_default(v: Any):
    # Network-facing encode: never pickle engine internals onto the wire —
    # at any nesting depth. Anything the storage codec would pickle is
    # degraded to its SurrealQL string form so msgpack clients always
    # receive decodable frames. Packed vectors degrade to plain arrays.
    if type(v).__name__ == "ndarray" and type(v).__module__ == "numpy":
        return v.tolist()
    out = _default(v, packer=wire_pack)
    if isinstance(out, msgpack.ExtType) and out.code == EXT_PYOBJ:
        return repr(v)
    return out


def pack(v: Any) -> bytes:
    return msgpack.packb(v, default=_default, use_bin_type=True, strict_types=True)


def unpack(b: bytes) -> Any:
    return msgpack.unpackb(b, ext_hook=_ext_hook, raw=False, strict_map_key=False)


def wire_pack(v: Any) -> bytes:
    """Encode for the network; engine internals become strings, never pickles."""
    return msgpack.packb(v, default=_wire_default, use_bin_type=True, strict_types=True)


def wire_unpack(b: bytes) -> Any:
    """Decode untrusted network bytes; refuses the pickle extension type."""
    return msgpack.unpackb(b, ext_hook=_wire_ext_hook, raw=False, strict_map_key=False)
