"""Model specs, weight serialization, and compiled forwards.

Role of the reference's surrealml `.surml` runtime + object store
(reference: core/src/sql/model.rs:37 Model::compute, core/src/obs/mod.rs:20
SHA1-addressed model files). TPU-first design: weights live as
content-addressed blobs in the KV (key/__init__.py blob). Mirrors
surrealdb_tpu/ml/model.py: the numpy forward serves below the device
threshold; the batched device forward (K10) is not ported yet and raises
NotImplementedError.

Spec format (msgpack-serializable dict):
  {"format": "linear" | "mlp",
   "layers": [{"w": [[...]], "b": [...], "activation": "relu"|"tanh"|
               "sigmoid"|"softmax"|None}, ...]}
`linear` is a 1-layer mlp with no activation. Output of a single-output
model is unwrapped to a scalar per row.
"""

from __future__ import annotations

import hashlib
import itertools
from typing import Any, Dict, List, Optional

import numpy as np

from surrealdb_tpu_torch.err import SurrealError
from surrealdb_tpu_torch.utils.ser import pack, unpack

_ACTS = ("relu", "tanh", "sigmoid", "softmax", None)


def validate_spec(spec: dict) -> dict:
    """Normalize + sanity-check a model spec; returns the canonical dict."""
    fmt = spec.get("format")
    if fmt == "onnx":
        return _validate_onnx_spec(spec)
    if fmt not in ("linear", "mlp"):
        raise SurrealError(f"Unsupported model format {fmt!r}")
    layers = spec.get("layers") or []
    if not layers:
        raise SurrealError("Model has no layers")
    canon = []
    prev_out: Optional[int] = None
    for i, layer in enumerate(layers):
        w = np.asarray(layer.get("w"), dtype=np.float32)
        if w.ndim != 2:
            raise SurrealError(f"Layer {i} weight must be a 2-d matrix")
        b = layer.get("b")
        b = np.zeros(w.shape[1], np.float32) if b is None else np.asarray(b, np.float32)
        if b.shape != (w.shape[1],):
            raise SurrealError(f"Layer {i} bias shape {b.shape} != ({w.shape[1]},)")
        act = layer.get("activation")
        if act not in _ACTS:
            raise SurrealError(f"Layer {i} has unknown activation {act!r}")
        if prev_out is not None and w.shape[0] != prev_out:
            raise SurrealError(
                f"Layer {i} input dim {w.shape[0]} != previous output {prev_out}"
            )
        prev_out = w.shape[1]
        canon.append({"w": w, "b": b, "activation": act})
    return {"format": fmt, "layers": canon}


def _validate_onnx_spec(spec: dict) -> dict:
    """ONNX-backed spec (from a .surml import): parse once to verify the
    graph and every operator is supported."""
    from .onnx_mini import OnnxGraph

    raw = spec.get("onnx")
    if not isinstance(raw, bytes) or not raw:
        raise SurrealError("onnx spec has no model bytes")
    graph = OnnxGraph(raw)
    graph.build_forward(np)(np.zeros((1, graph.in_dim), np.float32))  # op check
    out = {
        "format": "onnx",
        "onnx": raw,
        "keys": list(spec.get("keys") or []),
        "normalisers": dict(spec.get("normalisers") or {}),
        "output": spec.get("output"),
        "header": dict(spec.get("header") or {}),
    }
    return out


# ------------------------------------------------------------ serialization
def spec_to_bytes(spec: dict) -> bytes:
    if spec["format"] == "onnx":
        return pack(
            {
                "format": "onnx",
                "onnx": spec["onnx"],
                "keys": spec.get("keys") or [],
                "normalisers": spec.get("normalisers") or {},
                "output": list(spec["output"]) if spec.get("output") else None,
                "header": spec.get("header") or {},
            }
        )
    out = {"format": spec["format"], "layers": []}
    for layer in spec["layers"]:
        out["layers"].append(
            {
                "w_shape": list(layer["w"].shape),
                "w": layer["w"].astype(np.float32).tobytes(),
                "b": layer["b"].astype(np.float32).tobytes(),
                "activation": layer["activation"],
            }
        )
    return pack(out)


def spec_from_bytes(raw: bytes) -> dict:
    d = unpack(raw)
    if d.get("format") == "onnx":
        out = dict(d)
        if out.get("output"):
            o = out["output"]
            norm = o[1]
            out["output"] = (o[0], (norm[0], list(norm[1])) if norm else None)
        out["normalisers"] = {
            k: (v[0], list(v[1])) for k, v in (out.get("normalisers") or {}).items()
        }
        return out
    layers = []
    for layer in d["layers"]:
        sh = tuple(layer["w_shape"])
        layers.append(
            {
                "w": np.frombuffer(layer["w"], np.float32).reshape(sh).copy(),
                "b": np.frombuffer(layer["b"], np.float32).copy(),
                "activation": layer["activation"],
            }
        )
    return {"format": d["format"], "layers": layers}


def digest(raw: bytes) -> str:
    return hashlib.sha1(raw).hexdigest()


# ------------------------------------------------------------ forwards
def _np_act(x: np.ndarray, act: Optional[str]) -> np.ndarray:
    if act == "relu":
        return np.maximum(x, 0.0)
    if act == "tanh":
        return np.tanh(x)
    if act == "sigmoid":
        return 1.0 / (1.0 + np.exp(-x))
    if act == "softmax":
        e = np.exp(x - x.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)
    return x


_MODEL_SEQ = itertools.count(1)


class CompiledModel:
    """One (model, version): host twin + lazily-jitted device forward."""

    def __init__(self, spec: dict):
        self.spec = spec
        # distinguishes compile-log shape keys of dimension-twin models
        # (each instance jits its own executable)
        self.seq = next(_MODEL_SEQ)
        self._graph = None
        if spec["format"] == "onnx":
            from .onnx_mini import OnnxGraph

            self._graph = OnnxGraph(spec["onnx"])
            self.in_dim = self._graph.in_dim
            probe = self._graph.build_forward(np)(
                np.zeros((1, self.in_dim), np.float32)
            )
            self.out_dim = int(probe.shape[1])
        else:
            self.in_dim = spec["layers"][0]["w"].shape[0]
            self.out_dim = spec["layers"][-1]["w"].shape[1]
        self._jitted = None
        # forward invocations (each = one dispatch); the batched SELECT path
        # asserts one dispatch per table scan against this counter
        self.dispatches = 0

    def forward_host(self, x: np.ndarray) -> np.ndarray:
        if self._graph is not None:
            return np.asarray(self._graph.build_forward(np)(x.astype(np.float32)))
        h = x.astype(np.float32)
        for layer in self.spec["layers"]:
            h = _np_act(h @ layer["w"] + layer["b"], layer["activation"])
        return h

    def _device_fn(self):
        """The batched device forward (reference ml/model.py _device_fn)."""
        raise NotImplementedError('ML forward kernel (K10, ml/model.py) not ported yet; see ROADMAP queue 4')

    def forward(self, x: np.ndarray, device_threshold: int = 1024) -> np.ndarray:
        """Batched forward: numpy below `device_threshold` rows; above it the
        device forward, which is not ported yet and raises."""
        from surrealdb_tpu_torch import cnf

        self.dispatches += 1
        if cnf.TPU_DISABLE or x.shape[0] < device_threshold:
            return self.forward_host(x)
        return self._device_fn()(x)

