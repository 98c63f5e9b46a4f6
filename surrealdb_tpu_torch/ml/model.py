"""Model specs, weight serialization, and compiled forwards.

Role of the reference's surrealml `.surml` runtime + object store
(reference: core/src/sql/model.rs:37 Model::compute, core/src/obs/mod.rs:20
SHA1-addressed model files). TPU-first design: weights live as
content-addressed blobs in the KV (key/__init__.py blob). Mirrors
surrealdb_tpu/ml/model.py: a numpy twin serves small batches, and the
batched device forward (K10, the reference's jitted `_device_fn`) is two
hand-written CUDA kernels (csrc/ml.cu), so `ml::m<v>(batch_of_rows)` runs
on the Datastore's device for a whole table scan (BASELINE config 5):

- `linear_act(x, w, b, act)` launches `ml_linear`: act(x @ w + b) with x
  [M, K] f32 or bf16 (the vector mirror as the card holds it), w [K, N]
  and b [N] f32, out [M, N] f32, the activation (none / relu / tanh /
  sigmoid) fused;
- `row_softmax(h)` launches `ml_softmax`: softmax over the last axis of
  [M, N] f32, in the reference's order (max, exp, divide by the sum).

Each wrapper takes tensors on one device. A CUDA tensor goes to the kernel
(or the wrapper raises); a CPU tensor goes to the plain PyTorch version
beside it (`linear_act_plain`, `row_softmax_plain`), which the tests hold
against the reference and chip_smoke.py holds the kernels against. Each
counts its launches (LINEAR, SOFTMAX). An ONNX spec's forward runs its
MatMul / Gemm / Softmax nodes through the same wrappers (ml/onnx_mini.py
TorchNp).

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
import torch

from surrealdb_tpu_torch.err import SurrealError
from surrealdb_tpu_torch.ops.distances import LaunchCounter
from surrealdb_tpu_torch.utils.ser import pack, unpack

_ACTS = ("relu", "tanh", "sigmoid", "softmax", None)

LINEAR = LaunchCounter("ml_linear")
SOFTMAX = LaunchCounter("ml_softmax")
KERNELS = (LINEAR, SOFTMAX)
_ACT_CODE = {None: 0, "relu": 1, "tanh": 2, "sigmoid": 3}  # csrc/ml.cu Act


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


# ------------------------------------------------------------ K10 plain versions
def linear_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     act: Optional[str]) -> torch.Tensor:
    """The reference's layer in plain PyTorch f32: x (upcast from bf16,
    exactly) @ w + b, then the activation; sigmoid as 1 / (1 + exp(-h)),
    as the host twin and the kernel compute it."""
    h = x.to(torch.float32) @ w + b
    if act == "relu":
        return torch.relu(h)
    if act == "tanh":
        return torch.tanh(h)
    if act == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-h))
    return h


def row_softmax_plain(h: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the last axis, in its order: exp(h - row max),
    divided by the row sum."""
    e = torch.exp(h - h.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


# ------------------------------------------------------------ K10 kernels
def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_linear(x, w, b, act) -> None:
    dev = x.device
    if dev.type != "cuda" or w.device != dev or b.device != dev:
        raise ValueError(f"x, w and b must lie on one CUDA device (got {x.device}, "
                         f"{w.device}, {b.device})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"w and b must be float32, got {w.dtype}, {b.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or x.shape[1] == 0 \
            or w.shape[1] == 0 or b.shape != (w.shape[1],):
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)} "
                         "are not [M,K], [K,N], [N] with K, N >= 1")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("x, w and b must be contiguous")
    if act not in _ACT_CODE:
        raise ValueError(f"unknown fused activation {act!r}")


def _launch_linear(lib, x, w, b, act, out, stream):
    """One call of csrc/ml.cu's ml_linear into out [M, N] f32; returns its
    status. `lib` is the built library (or the CPU emulation's, in the
    tests)."""
    return lib.ml_linear(x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
                         b.data_ptr(), x.shape[0], x.shape[1], w.shape[1], _ACT_CODE[act],
                         out.data_ptr(), stream)


def _launch_softmax(lib, h, out, stream):
    return lib.ml_softmax(h.data_ptr(), h.shape[0], h.shape[1], out.data_ptr(), stream)


def linear_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               act: Optional[str] = None) -> torch.Tensor:
    """-> [M, N] f32 = act(x @ w + b) (K10's linear layer). x [M, K] f32 or
    bf16, w [K, N] f32, b [N] f32, act None / "relu" / "tanh" / "sigmoid"."""
    if _on_cpu(x, w, b):
        return linear_act_plain(x, w, b, act)
    _check_linear(x, w, b, act)
    from surrealdb_tpu_torch.ops import _cuda

    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return out
    lib = _cuda.lib()
    with torch.cuda.device(x.device):
        status = _launch_linear(lib, x, w, b, act, out, torch.cuda.current_stream().cuda_stream)
        _cuda.check(status, "ml_linear")
    LINEAR.bump()
    return out


def row_softmax(h: torch.Tensor) -> torch.Tensor:
    """-> [M, N] f32 softmax of each row of h [M, N] f32 (K10's softmax)."""
    if _on_cpu(h):
        return row_softmax_plain(h)
    if h.device.type != "cuda":
        raise ValueError(f"h must lie on a CUDA device (got {h.device})")
    if h.dtype != torch.float32 or h.dim() != 2 or h.shape[1] == 0 or not h.is_contiguous():
        raise ValueError(f"h must be a contiguous [M, N>=1] float32 tensor, got "
                         f"{h.dtype} {tuple(h.shape)}")
    from surrealdb_tpu_torch.ops import _cuda

    out = torch.empty_like(h)
    if h.shape[0] == 0:
        return out
    lib = _cuda.lib()
    with torch.cuda.device(h.device):
        status = _launch_softmax(lib, h, out, torch.cuda.current_stream().cuda_stream)
        _cuda.check(status, "ml_softmax")
    SOFTMAX.bump()
    return out


# ------------------------------------------------------------ compiled models
_MODEL_SEQ = itertools.count(1)


class CompiledModel:
    """One (model, version): host twin + a device forward for each device."""

    def __init__(self, spec: dict):
        self.spec = spec
        # distinguishes compile-log shape keys of dimension-twin models
        # (each instance builds its own device forward)
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
        self._device_fns: Dict[torch.device, Any] = {}
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

    def _device_fn(self, device):
        """The batched forward on `device` (reference ml/model.py
        _device_fn): a function of an [M, in_dim] tensor there (f32, or
        bf16 for the first layer of a linear / MLP spec) to [M, out_dim]
        f32. The weights upload once a device, as f32: a layer is one
        `linear_act` launch, plus `row_softmax` where its activation is
        softmax. An ONNX spec runs its graph over a TorchNp namespace."""
        device = torch.device(device)
        fwd = self._device_fns.get(device)
        if fwd is not None:
            return fwd
        if self._graph is not None:
            from .onnx_mini import TorchNp

            graph_fwd = self._graph.build_forward(TorchNp(device))

            def fwd(x):
                return graph_fwd(x.to(torch.float32))
        else:
            layers = [
                (torch.from_numpy(np.ascontiguousarray(l["w"], np.float32)).to(device),
                 torch.from_numpy(np.ascontiguousarray(l["b"], np.float32)).to(device),
                 l["activation"])
                for l in self.spec["layers"]
            ]

            def fwd(x):
                h = x
                for w, b, act in layers:
                    h = linear_act(h, w, b, None if act == "softmax" else act)
                    if act == "softmax":
                        h = row_softmax(h)
                return h

        self._device_fns[device] = fwd
        return fwd

    def forward(self, x: np.ndarray, device, device_threshold: int = 1024) -> np.ndarray:
        """Batched forward: the numpy twin below `device_threshold` rows (or
        under cnf.TPU_DISABLE), else the device forward on `device` (the
        Datastore's). A failed launch raises; nothing scores on the host
        instead."""
        from surrealdb_tpu_torch import cnf, compile_log
        from surrealdb_tpu_torch.utils.num import next_pow2

        self.dispatches += 1
        if cnf.TPU_DISABLE or x.shape[0] < device_threshold:
            return self.forward_host(x)
        if device is None:
            raise RuntimeError("no device given for the model's batched forward")
        fwd = self._device_fn(device)
        n = x.shape[0]
        # the kernels take any row count, so nothing is padded; the key
        # keeps the reference's pow2 cap, its executables' shape
        with compile_log.tracked(
            "ml_forward", (self.seq, next_pow2(n), self.in_dim, self.out_dim)
        ):
            xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
            return fwd(xt).cpu().numpy()


def model_from_reference(model, device=None) -> CompiledModel:
    """The port's CompiledModel of a reference model: `model` is the
    reference's canonical spec dict (numpy weights, or ONNX bytes with
    their keys and normalisers) or its CompiledModel. With a device, the
    device forward is built (weights uploaded) there. spec_to_bytes of the
    result's spec equals the reference's byte for byte."""
    spec = getattr(model, "spec", model)
    if spec["format"] == "onnx":
        copy = dict(spec)
    else:
        copy = {"format": spec["format"], "layers": [
            {"w": np.array(l["w"], np.float32), "b": np.array(l["b"], np.float32),
             "activation": l["activation"]} for l in spec["layers"]]}
    cm = CompiledModel(copy)
    if device is not None:
        cm._device_fn(device)
    return cm
