"""`.surml` container format (surrealml-core compatibility).

A copy of surrealdb_tpu/ml/surml.py (pure host code).

Role of the reference's surrealml model files (reference:
core/src/sql/model.rs:37, fixtures tests/*.surml of the reference project): a
4-byte big-endian header length, a `//=>`-delimited text header
(keys, normalisers, output, name, version, description, engine, origin,
author), then the raw ONNX model bytes. Buffered compute maps an input
object through `keys` order with per-column normalisers and denormalises
the output; raw compute feeds numbers straight through.
"""

from __future__ import annotations

import re
import struct
from typing import Any, Dict, List, Optional, Tuple

from surrealdb_tpu_torch.err import SurrealError

_FIELDS = (
    "keys", "normalisers", "output", "name", "version",
    "description", "engine", "origin", "author",
)


def parse_normaliser(text: str) -> Optional[Tuple[str, List[float]]]:
    """`z_score(2120,718.0529)` → ("z_score", [2120.0, 718.0529])."""
    m = re.match(r"([a-z_]+)\(([^)]*)\)", text.strip())
    if not m:
        return None
    args = [float(x) for x in m.group(2).split(",") if x.strip()]
    return m.group(1), args


def parse_surml(raw: bytes) -> dict:
    """Parse a .surml file into {header fields..., "onnx": bytes}."""
    if len(raw) < 4:
        raise SurrealError("not a .surml file (too short)")
    hlen = struct.unpack(">I", raw[:4])[0]
    if 4 + hlen > len(raw):
        raise SurrealError("not a .surml file (bad header length)")
    header = raw[4 : 4 + hlen].decode("utf-8", "replace")
    body = raw[4 + hlen :]
    parts = header.split("//=>")
    if parts and parts[0] == "":
        parts = parts[1:]
    out: Dict[str, Any] = {f: "" for f in _FIELDS}
    for field, text in zip(_FIELDS, parts):
        out[field] = text
    out["keys"] = [k for k in out["keys"].split("=>") if k] if out["keys"] else []
    norms: Dict[str, Tuple[str, List[float]]] = {}
    if out["normalisers"]:
        for entry in out["normalisers"].split("//"):
            if "=>" not in entry:
                continue
            col, func = entry.split("=>", 1)
            parsed = parse_normaliser(func)
            if parsed:
                norms[col] = parsed
    out["normalisers"] = norms
    if out["output"] and "=>" in out["output"]:
        oname, ofunc = out["output"].split("=>", 1)
        out["output"] = (oname, parse_normaliser(ofunc))
    else:
        out["output"] = (out["output"], None)
    out["onnx"] = body
    return out


def normalise(value: float, norm: Optional[Tuple[str, List[float]]]) -> float:
    if norm is None:
        return value
    kind, args = norm
    if kind == "z_score" and len(args) == 2:
        mean, std = args
        return (value - mean) / std if std else value - mean
    if kind == "linear_scaling" and len(args) == 2:
        lo, hi = args
        return (value - lo) / (hi - lo) if hi != lo else 0.0
    if kind in ("log_scaling", "log_scale") and args:
        import math

        base = args[0] or 10.0
        return math.log(max(value, 1e-12), base)
    return value


def denormalise(value: float, norm: Optional[Tuple[str, List[float]]]) -> float:
    if norm is None:
        return value
    kind, args = norm
    if kind == "z_score" and len(args) == 2:
        mean, std = args
        return value * std + mean
    if kind == "linear_scaling" and len(args) == 2:
        lo, hi = args
        return value * (hi - lo) + lo
    if kind in ("log_scaling", "log_scale") and args:
        base = args[0] or 10.0
        return float(base) ** value
    return value
