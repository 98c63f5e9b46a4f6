"""Model specs, weight serialization, and compiled forwards.

Role of the reference's surrealml `.surml` runtime + object store
(reference: core/src/sql/model.rs:37 Model::compute, core/src/obs/mod.rs:20
SHA1-addressed model files). TPU-first design: weights live as
content-addressed blobs in the KV (key/__init__.py blob). Mirrors
surrealdb_tpu/ml/model.py: a numpy twin serves small batches, and the
batched device forward (the reference's jitted `_device_fn`) runs on
hand-written CUDA kernels, so `ml::m<v>(batch_of_rows)` runs on the
Datastore's device for a whole table scan (BASELINE config 5):

- `linear_act(x, w, epilogue)` launches `ml_linear` (csrc/ml.cu):
  E(x @ w) with x [M, K] f32 or bf16 (the vector mirror as the card holds
  it), w [K, N] f32, out [M, N] f32, E an epilogue program (csrc/ewise.cuh)
  over the product and up to two per-column operands: a layer's act(h + b)
  (none / relu / tanh / sigmoid), or an ONNX product's chain;
- `row_softmax(h)` launches `ml_softmax`: softmax over the last axis of
  [M, N] f32, in the reference's order (max, exp, divide by the sum);
- `ewise(prog, inputs, out)` launches `ml_ewise` (csrc/onnx.cu): a
  register program over up to 4 broadcast inputs into a strided out;
- `reduce_axis(x, axes, keepdims, mean)` launches `ml_reduce`: sums and
  means over runs of adjacent axes.

K10 (linear / MLP specs) is the first two; K16, the ONNX branch, is the
plan that ml/onnx_mini.py OnnxGraph.lower builds over all four. Each
wrapper takes tensors on one device. A CUDA tensor goes to the kernel (or
the wrapper raises); a CPU tensor goes to the plain PyTorch version beside
it (`linear_act_plain`, `row_softmax_plain`, `ewise_plain`,
`reduce_axis_plain`, all over `run_program_plain`), which the tests hold
against the reference and chip_smoke.py holds the kernels against. Each
counts its launches (LINEAR, SOFTMAX, EWISE, REDUCE).

Spec format (msgpack-serializable dict):
  {"format": "linear" | "mlp",
   "layers": [{"w": [[...]], "b": [...], "activation": "relu"|"tanh"|
               "sigmoid"|"softmax"|None}, ...]}
`linear` is a 1-layer mlp with no activation. Output of a single-output
model is unwrapped to a scalar per row.
"""

from __future__ import annotations

import ctypes
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
EWISE = LaunchCounter("ml_ewise")
REDUCE = LaunchCounter("ml_reduce")
KERNELS = (LINEAR, SOFTMAX, EWISE, REDUCE)


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


# ------------------------------------------------------------ programs (csrc/ewise.cuh)
EW_OPS = ("copy", "add", "sub", "mul", "div", "pow", "max", "min", "neg", "exp", "sqrt",
          "tanh", "relu", "leaky", "elu", "sigmoid")
_OP_CODE = {name: i for i, name in enumerate(EW_OPS)}
EW_REGS = 8
IMM = 8  # an operand naming the instruction's immediate
EW_MAX_INS, EPI_MAX_INS = 16, 8
EW_INPUTS, EW_MAX_DIMS = 4, 4


class Program:
    """A register program of csrc/ewise.cuh: instructions (op, dst, a, b,
    imm) over EW_REGS f32 registers, a and b a register or IMM (the
    immediate, rounded to f32 here as the kernel holds it); LeakyRelu's and
    Elu's alpha is the immediate. `out` names the result register."""

    __slots__ = ("ins", "out")

    def __init__(self, ins, out: int):
        self.ins = tuple((op, int(dst), int(a), int(b), float(np.float32(imm)))
                         for op, dst, a, b, imm in ins)
        self.out = int(out)
        for op, dst, a, b, _ in self.ins:
            if op not in _OP_CODE or not (0 <= dst < EW_REGS and 0 <= a <= IMM and 0 <= b <= IMM):
                raise ValueError(f"bad instruction {(op, dst, a, b)}")

    def __len__(self) -> int:
        return len(self.ins)

    def __repr__(self) -> str:
        return f"Program({list(self.ins)}, out={self.out})"


class _EwIns(ctypes.Structure):
    _fields_ = [("op", ctypes.c_ubyte), ("dst", ctypes.c_ubyte), ("a", ctypes.c_ubyte),
                ("b", ctypes.c_ubyte), ("imm", ctypes.c_float)]


class _EpiDesc(ctypes.Structure):  # csrc/ewise.cuh EpiProg
    _fields_ = [("n", ctypes.c_int), ("out", ctypes.c_int), ("ins", _EwIns * EPI_MAX_INS),
                ("opnd", ctypes.c_void_p * 2), ("ostride", ctypes.c_int * 2)]


class _EwDesc(ctypes.Structure):  # csrc/onnx.cu EwDesc
    _fields_ = [("ndim", ctypes.c_int), ("nin", ctypes.c_int), ("nins", ctypes.c_int),
                ("out_reg", ctypes.c_int), ("shape", ctypes.c_longlong * EW_MAX_DIMS),
                ("ostride", ctypes.c_longlong * EW_MAX_DIMS),
                ("istride", (ctypes.c_longlong * EW_MAX_DIMS) * EW_INPUTS),
                ("ibf16", ctypes.c_int * EW_INPUTS), ("ins", _EwIns * EW_MAX_INS),
                ("in_", ctypes.c_void_p * EW_INPUTS), ("out", ctypes.c_void_p)]


def _fill_ins(dst, prog: Program) -> None:
    for i, (op, d, a, b, imm) in enumerate(prog.ins):
        dst[i].op, dst[i].dst, dst[i].a, dst[i].b, dst[i].imm = _OP_CODE[op], d, a, b, imm


def _max_plain(a, b):
    """XLA's maximum: a NaN wins, and +0 is above -0 (csrc/ewise.cuh ew_max)."""
    pick = torch.where(a > b, a, b)
    pick = torch.where((a == b) & ~torch.signbit(a), a, pick)
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b, pick)


def _min_plain(a, b):
    pick = torch.where(a < b, a, b)
    pick = torch.where((a == b) & torch.signbit(a), a, pick)
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b, pick)


def run_program_plain(prog: Program, regs) -> torch.Tensor:
    """The kernels' interpreter in plain PyTorch f32: registers start as
    `regs` (tensors that broadcast together, None = 0), each instruction one
    torch op rounding as the kernel's does (immediates as 0-d tensors on the
    registers' device, so no op takes a scalar shortcut); -> the out
    register."""
    regs = list(regs) + [None] * (EW_REGS - len(regs))
    dev = next(t.device for t in regs if t is not None)
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    r = [zero if t is None else t for t in regs]
    for op, dst, a, b, imm in prog.ins:
        im = torch.tensor(imm, dtype=f32, device=dev)
        va = im if a == IMM else r[a]
        vb = im if b == IMM else r[b]
        if op == "copy":
            v = va
        elif op == "add":
            v = torch.add(va, vb)
        elif op == "sub":
            v = torch.sub(va, vb)
        elif op == "mul":
            v = torch.mul(va, vb)
        elif op == "div":
            v = torch.div(va, vb)
        elif op == "pow":
            v = torch.pow(va, vb)
        elif op == "max":
            v = _max_plain(va, vb)
        elif op == "min":
            v = _min_plain(va, vb)
        elif op == "neg":
            v = torch.neg(va)
        elif op == "exp":
            v = torch.exp(va)
        elif op == "sqrt":
            v = torch.sqrt(va)
        elif op == "tanh":
            v = torch.tanh(va)
        elif op == "relu":
            v = _max_plain(va, zero)
        elif op == "leaky":
            v = torch.where(va > 0, va, torch.mul(im, va))
        elif op == "elu":
            v = torch.where(va > 0, va, torch.mul(im, torch.sub(torch.exp(va), one)))
        else:  # sigmoid
            v = torch.div(one, torch.add(one, torch.exp(torch.neg(va))))
        r[dst] = v
    return r[prog.out]


class Epilogue:
    """ml_linear's epilogue: a Program of at most EPI_MAX_INS instructions,
    a chain over r0 (the product; every instruction writes r0 and reads r0,
    r1, r2 or IMM; r0 is the result), r1 and r2 the operands, each an f32
    tensor of N values (one a column) or of one value, on the product's
    device (csrc/ewise.cuh epi_valid)."""

    __slots__ = ("prog", "operands")

    def __init__(self, prog: Program, operands=()):
        if len(prog) > EPI_MAX_INS or len(operands) > 2:
            raise ValueError(f"an epilogue takes <= {EPI_MAX_INS} instructions and <= 2 "
                             f"operands, got {len(prog)} and {len(operands)}")
        if prog.out != 0 or any(dst != 0 or not (a <= 2 or a == IMM) or not (b <= 2 or b == IMM)
                                for _, dst, a, b, _ in prog.ins):
            raise ValueError(f"an epilogue is a chain over r0 reading r0, r1, r2 or IMM: {prog}")
        self.prog, self.operands = prog, tuple(operands)

    @staticmethod
    def layer(b: Optional[torch.Tensor], act: Optional[str]) -> "Epilogue":
        """A model layer's act(h + b): the bias add, then one activation
        instruction (none / relu / tanh / sigmoid)."""
        if act not in (None, "relu", "tanh", "sigmoid"):
            raise ValueError(f"unknown fused activation {act!r}")
        ins = [] if b is None else [("add", 0, 0, 1, 0.0)]
        if act is not None:
            ins.append((act, 0, 0, 0, 0.0))
        return Epilogue(Program(ins, 0), () if b is None else (b,))


def _epi_desc(ep: Epilogue) -> _EpiDesc:
    d = _EpiDesc()
    d.n, d.out = len(ep.prog), ep.prog.out
    _fill_ins(d.ins, ep.prog)
    for k, t in enumerate(ep.operands):
        d.opnd[k] = t.data_ptr()
        d.ostride[k] = 0 if t.numel() == 1 else 1
    return d


# ------------------------------------------------------------ plain versions
def linear_act_plain(x: torch.Tensor, w: torch.Tensor, epilogue: Epilogue) -> torch.Tensor:
    """The reference's layer in plain PyTorch f32: x (upcast from bf16,
    exactly) @ w, then the epilogue (a layer's: + b, then the activation;
    sigmoid as 1 / (1 + exp(-h)), as the host twin and the kernel compute
    it)."""
    h = x.to(torch.float32) @ w
    y = run_program_plain(epilogue.prog, [h, *epilogue.operands])
    return y if y.shape == h.shape else y.expand(h.shape).contiguous()


def row_softmax_plain(h: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the last axis, in its order: exp(h - row max),
    divided by the row sum."""
    e = torch.exp(h - h.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def ewise_plain(prog: Program, inputs, out: torch.Tensor) -> torch.Tensor:
    """ml_ewise in plain PyTorch: the program over the inputs (upcast to
    f32, broadcast to out's shape), written into out."""
    regs = [torch.broadcast_to(t.to(torch.float32), out.shape) for t in inputs]
    if not regs:
        regs = [torch.zeros(out.shape, dtype=torch.float32, device=out.device)]
    out.copy_(torch.broadcast_to(run_program_plain(prog, regs), out.shape))
    return out


def _norm_axes(ndim: int, axes) -> tuple:
    if axes is None:
        return tuple(range(ndim))
    return tuple(sorted({int(a) % ndim for a in axes})) if ndim else ()


def reduce_axis_plain(x: torch.Tensor, axes, keepdims: bool, mean: bool) -> torch.Tensor:
    """The reference's sum / mean of x over `axes` (None: all) in plain PyTorch f32:
    the sum, divided by the count of reduced values for a mean."""
    xf = x.to(torch.float32)
    dims = _norm_axes(x.dim(), axes)
    if not dims:
        return xf.clone()
    s = torch.sum(xf, dim=dims, keepdim=keepdims)
    if mean:
        count = int(np.prod([x.shape[d] for d in dims]))
        s = torch.div(s, torch.tensor(float(count), dtype=torch.float32, device=x.device))
    return s


# ------------------------------------------------------------ K10 / K16 kernels
def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_linear(x, w, ep: Epilogue) -> None:
    dev = x.device
    if dev.type != "cuda" or w.device != dev or any(t.device != dev for t in ep.operands):
        raise ValueError(f"x, w and the epilogue's operands must lie on one CUDA device (got "
                         f"{x.device}, {w.device}, {[t.device for t in ep.operands]})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != torch.float32 or any(t.dtype != torch.float32 for t in ep.operands):
        raise TypeError(f"w and the operands must be float32, got {w.dtype}, "
                        f"{[t.dtype for t in ep.operands]}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or x.shape[1] == 0 \
            or w.shape[1] == 0 or any(t.numel() not in (1, w.shape[1]) for t in ep.operands):
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{[tuple(t.shape) for t in ep.operands]} are not [M,K], [K,N], "
                         "[N] or one value, with K, N >= 1")
    if not (x.is_contiguous() and w.is_contiguous() and all(t.is_contiguous()
                                                             for t in ep.operands)):
        raise ValueError("x, w and the operands must be contiguous")


def _launch_linear(lib, x, w, epilogue: Epilogue, out, stream):
    """One call of csrc/ml.cu's ml_linear into out [M, N] f32; returns its
    status. `lib` is the built library (or the CPU emulation's, in the
    tests)."""
    desc = _epi_desc(epilogue)
    return lib.ml_linear(x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
                         x.shape[0], x.shape[1], w.shape[1], ctypes.byref(desc),
                         out.data_ptr(), stream)


def _launch_softmax(lib, h, out, stream):
    return lib.ml_softmax(h.data_ptr(), h.shape[0], h.shape[1], out.data_ptr(), stream)


def linear_act(x: torch.Tensor, w: torch.Tensor, epilogue: Epilogue,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> [M, N] f32 = E(x @ w) (K10's linear layer; K16's products): x [M, K]
    f32 or bf16, w [K, N] f32, E the epilogue (a layer's is
    Epilogue.layer(b, act)); written into `out` (contiguous [M, N] f32)
    where given."""
    if _on_cpu(x, w, *epilogue.operands):
        y = linear_act_plain(x, w, epilogue)
        return y if out is None else out.copy_(y)
    _check_linear(x, w, epilogue)
    from surrealdb_tpu_torch.ops import _cuda

    if out is None:
        out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    elif out.shape != (x.shape[0], w.shape[1]) or out.dtype != torch.float32 \
            or out.device != x.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous float32 [M, N] tensor on {x.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if x.shape[0] == 0:
        return out
    lib = _cuda.lib()
    with torch.cuda.device(x.device):
        status = _launch_linear(lib, x, w, epilogue, out, torch.cuda.current_stream().cuda_stream)
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


def _collapse(shape, strides_list):
    """Drop size-1 dims and merge adjacent dims that are contiguous in every
    operand -> (shape, [strides of each operand]); a 0-d shape becomes [1]."""
    keep = [k for k, n in enumerate(shape) if n != 1]
    dims = [[shape[k], [s[k] for s in strides_list]] for k in keep]
    out = []
    for n, st in dims:
        if out and all(prev == cur * n for prev, cur in zip(out[-1][1], st)):
            out[-1][0] *= n
            out[-1][1] = st
        else:
            out.append([n, st])
    if not out:
        return [1], [[0] for _ in strides_list]
    return [n for n, _ in out], [[st[i] for _, st in out] for i in range(len(strides_list))]


def _ew_desc(prog: Program, inputs, out) -> _EwDesc:
    shape = tuple(out.shape)
    views = [torch.broadcast_to(t, shape) for t in inputs]
    cshape, cstrides = _collapse(shape, [out.stride()] + [v.stride() for v in views])
    nd = len(cshape)
    if nd > EW_MAX_DIMS:
        raise ValueError(f"ml_ewise takes up to {EW_MAX_DIMS} dims once collapsed, got "
                         f"{nd} for {shape}")
    d = _EwDesc()
    d.ndim, d.nin, d.nins, d.out_reg = nd, len(inputs), len(prog), prog.out
    lead = EW_MAX_DIMS - nd  # right-aligned
    for k in range(EW_MAX_DIMS):
        d.shape[k] = cshape[k - lead] if k >= lead else 1
        d.ostride[k] = cstrides[0][k - lead] if k >= lead else 0
        for j in range(len(inputs)):
            d.istride[j][k] = cstrides[1 + j][k - lead] if k >= lead else 0
    for j, v in enumerate(views):
        d.ibf16[j] = int(v.dtype == torch.bfloat16)
        d.in_[j] = v.data_ptr()
    _fill_ins(d.ins, prog)
    d.out = out.data_ptr()
    return d


def _launch_ewise(lib, prog, inputs, out, stream):
    return lib.ml_ewise(ctypes.byref(_ew_desc(prog, inputs, out)), stream)


def ewise(prog: Program, inputs, out: torch.Tensor) -> torch.Tensor:
    """out = prog(inputs), elementwise (K16's ml_ewise): up to 4 inputs, f32
    or bf16, in r0..r3, each broadcast to out's shape through its strides;
    out f32 with any strides (a Concat's slice), up to 4-D once its dims
    collapse. Returns out."""
    if _on_cpu(out, *inputs):
        return ewise_plain(prog, inputs, out)
    dev = out.device
    if dev.type != "cuda" or any(t.device != dev for t in inputs):
        raise ValueError(f"inputs and out must lie on one CUDA device (got {out.device}, "
                         f"{[t.device for t in inputs]})")
    if out.dtype != torch.float32 or any(t.dtype not in (torch.float32, torch.bfloat16)
                                         for t in inputs):
        raise TypeError(f"out must be float32 and inputs float32 or bfloat16, got "
                        f"{out.dtype}, {[t.dtype for t in inputs]}")
    if len(inputs) > EW_INPUTS or not 1 <= len(prog) <= EW_MAX_INS:
        raise ValueError(f"ml_ewise takes <= {EW_INPUTS} inputs and 1..{EW_MAX_INS} "
                         f"instructions, got {len(inputs)} and {len(prog)}")
    if out.numel() == 0:
        return out
    from surrealdb_tpu_torch.ops import _cuda

    lib = _cuda.lib()
    with torch.cuda.device(dev):
        status = _launch_ewise(lib, prog, inputs, out, torch.cuda.current_stream().cuda_stream)
        _cuda.check(status, "ml_ewise")
    EWISE.bump()
    return out


def _axis_runs(dims) -> list:
    """Sorted axes -> runs of adjacent ones, [(first, last), ...]."""
    runs = []
    for d in dims:
        if runs and runs[-1][1] == d - 1:
            runs[-1][1] = d
        else:
            runs.append([d, d])
    return runs


def _launch_reduce(lib, x, outer, length, inner, div, out, stream):
    """One ml_reduce call of x viewed as [outer, length, inner] into out
    [outer, inner]; its scratch from torch.empty. Returns the status."""
    n = lib.ml_reduce_scratch_floats(outer, length, inner)
    scratch = torch.empty(n, dtype=torch.float32, device=x.device) if n else None
    return lib.ml_reduce(x.data_ptr(), int(x.dtype == torch.bfloat16), outer, length, inner,
                         div, None if scratch is None else scratch.data_ptr(), n,
                         out.data_ptr(), stream)


def reduce_axis(x: torch.Tensor, axes, keepdims: bool, mean: bool) -> torch.Tensor:
    """The reference's sum / mean of x (f32 or bf16, contiguous) over `axes` (None:
    all) -> f32 (K16's ml_reduce): one launch a run of adjacent axes, the
    last run's first, the mean's division by the whole count in the last
    launch."""
    if _on_cpu(x):
        return reduce_axis_plain(x, axes, keepdims, mean)
    if x.device.type != "cuda" or x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 or bfloat16 CUDA tensor, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    dims = _norm_axes(x.dim(), axes)
    if not dims:
        return ewise(Program([("copy", 0, 0, 0, 0.0)], 0), [x],
                     torch.empty(x.shape, dtype=torch.float32, device=x.device))
    from surrealdb_tpu_torch.ops import _cuda

    count = int(np.prod([x.shape[d] for d in dims]))
    shape = list(x.shape)
    cur = x
    lib = _cuda.lib()
    runs = _axis_runs(dims)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i, (a, z) in enumerate(reversed(runs)):
            outer = int(np.prod(shape[:a]))
            length = int(np.prod(shape[a:z + 1]))
            inner = int(np.prod(shape[z + 1:]))
            out = torch.empty(outer * inner, dtype=torch.float32, device=x.device)
            div = float(count) if mean and i == len(runs) - 1 else 1.0
            if out.numel():
                _cuda.check(_launch_reduce(lib, cur, outer, length, inner, div, out, stream),
                            "ml_reduce")
                REDUCE.bump()
            shape[a:z + 1] = [1] * (z + 1 - a)
            cur = out.view(shape)
    if keepdims:
        return cur
    return cur.view([n for k, n in enumerate(shape) if k not in dims])


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
        _device_fn): a function of an [M, in_dim] tensor there (f32 or
        bf16, read as bf16 by its first launches) to [M, out_dim]
        f32. The weights upload once a device, as f32: a layer is one
        `linear_act` launch, plus `row_softmax` where its activation is
        softmax. An ONNX spec runs its graph's lowered plan
        (OnnxGraph.lower: a fixed list of K16 launches, its first ones
        reading a bf16 input as it is)."""
        device = torch.device(device)
        fwd = self._device_fns.get(device)
        if fwd is not None:
            return fwd
        if self._graph is not None:
            fwd = self._graph.lower(device)
        else:
            layers = []
            for l in self.spec["layers"]:
                act = l["activation"]
                w, b = (torch.from_numpy(np.ascontiguousarray(l[k], np.float32)).to(device)
                        for k in ("w", "b"))
                layers.append((w, Epilogue.layer(b, None if act == "softmax" else act),
                               act == "softmax"))

            def fwd(x):
                h = x
                for w, ep, softmax in layers:
                    h = linear_act(h, w, ep)
                    if softmax:
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
