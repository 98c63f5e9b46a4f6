"""Minimal ONNX runtime: protobuf wire parser + numpy/PyTorch forward builder.

Role of the reference's surrealml-core execution of `.surml` model files
(reference: core/src/sql/model.rs — the crate runs the embedded ONNX graph
through onnxruntime). No onnxruntime or protobuf bindings ship in this
environment, so the framework parses the ONNX protobuf directly (the wire
format is simple tag-length-value) and lowers the graph to a forward
covering the operator set exported by common tabular/MLP models:
MatMul, Gemm, Add/Sub/Mul/Div, Relu/Sigmoid/Tanh/Softmax/LeakyRelu/Elu,
Identity/Flatten/Reshape/Transpose/Cast/Constant/Neg/Exp/Sqrt/Pow/Clip/
ReduceSum/ReduceMean/Concat.

Mirrors surrealdb_tpu/ml/onnx_mini.py; the parser and OnnxGraph are copies.
The reference builds its forward over numpy (the host twin) or jax.numpy
(jitted on the device). Here `build_forward` takes numpy or a `TorchNp`
namespace bound to one device: MatMul and Gemm run K10's linear kernel and
Softmax its row-softmax kernel (ml/model.py `linear_act`, `row_softmax`;
their plain versions on a CPU device), the other nodes run as torch tensor
ops on that device, as the reference's run as jax.numpy ops inside its jit. The
initializers and Constant values are uploaded once, when the forward is
built, and Reshape reads its target shape from those host values, never
from the device.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from surrealdb_tpu_torch.err import SurrealError


# ------------------------------------------------------------------ protobuf
def _read_varint(b: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        c = b[i]
        out |= (c & 0x7F) << shift
        i += 1
        if not c & 0x80:
            return out, i
        shift += 7


def parse_message(b: bytes) -> Dict[int, List[Any]]:
    """Parse one protobuf message into field_number -> [values] (values are
    ints for varint fields, bytes for length-delimited, floats for fixed)."""
    out: Dict[int, List[Any]] = {}
    i, n = 0, len(b)
    while i < n:
        key, i = _read_varint(b, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(b, i)
        elif wire == 1:
            v = struct.unpack_from("<d", b, i)[0]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(b, i)
            v = b[i : i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack_from("<f", b, i)[0]
            i += 4
        else:
            raise SurrealError(f"unsupported protobuf wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def _packed_ints(vals: List[Any]) -> List[int]:
    out: List[int] = []
    for v in vals:
        if isinstance(v, bytes):
            i = 0
            while i < len(v):
                x, i = _read_varint(v, i)
                out.append(x)
        else:
            out.append(int(v))
    return out


# ONNX TensorProto data types
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64, 10: np.float16, 11: np.float64}


def _tensor(b: bytes) -> Tuple[str, np.ndarray]:
    f = parse_message(b)
    dims = _packed_ints(f.get(1, []))
    dt = int(f.get(2, [1])[0])
    name = f.get(8, [b""])[0].decode()
    np_dt = _DTYPES.get(dt)
    if np_dt is None:
        raise SurrealError(f"unsupported ONNX tensor dtype {dt}")
    if 9 in f:  # raw_data
        arr = np.frombuffer(f[9][0], dtype=np_dt)
    elif 4 in f:  # float_data (packed or repeated)
        floats: List[float] = []
        for v in f[4]:
            if isinstance(v, bytes):
                floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:
                floats.append(float(v))
        arr = np.asarray(floats, dtype=np.float32)
    elif 7 in f:  # int64_data
        arr = np.asarray(_packed_ints(f[7]), dtype=np.int64)
    else:
        arr = np.zeros(0, dtype=np_dt)
    if dims:
        arr = arr.reshape(dims)
    return name, arr.astype(np.float32) if arr.dtype in (np.float16, np.float64) else arr


def _attr(b: bytes) -> Tuple[str, Any]:
    f = parse_message(b)
    name = f.get(1, [b""])[0].decode()
    atype = int(f.get(20, [0])[0])
    if atype == 1:  # FLOAT
        return name, float(f.get(2, [0.0])[0])
    if atype == 2:  # INT
        return name, int(f.get(3, [0])[0])
    if atype == 3:  # STRING
        return name, f.get(4, [b""])[0].decode()
    if atype == 4:  # TENSOR
        return name, _tensor(f.get(5, [b""])[0])[1]
    if atype == 6:  # FLOATS
        return name, [float(x) if not isinstance(x, bytes) else list(struct.unpack(f"<{len(x)//4}f", x)) for x in f.get(7, [])]
    if atype == 7:  # INTS
        return name, _packed_ints(f.get(8, []))
    return name, None


def _value_info_dims(b: bytes) -> Tuple[str, List[int]]:
    """ValueInfoProto -> (name, dims) with 0 for dynamic axes."""
    f = parse_message(b)
    name = f.get(1, [b""])[0].decode()
    dims: List[int] = []
    ty = f.get(2, [None])[0]
    if ty:
        tf = parse_message(ty)
        tensor_t = tf.get(1, [None])[0]  # tensor_type
        if tensor_t:
            tt = parse_message(tensor_t)
            shape = tt.get(2, [None])[0]
            if shape:
                sf = parse_message(shape)
                for d in sf.get(1, []):
                    df = parse_message(d)
                    dims.append(int(df.get(1, [0])[0]) if 1 in df else 0)
    return name, dims


class OnnxGraph:
    """Parsed ONNX model: initializers, node list, graph inputs/outputs."""

    def __init__(self, raw: bytes):
        model = parse_message(raw)
        graphs = model.get(7)
        if not graphs:
            raise SurrealError("not an ONNX model (no graph)")
        g = parse_message(graphs[0])
        self.initializers: Dict[str, np.ndarray] = {}
        for t in g.get(5, []):
            name, arr = _tensor(t)
            self.initializers[name] = arr
        self.nodes: List[dict] = []
        for nb in g.get(1, []):
            nf = parse_message(nb)
            self.nodes.append(
                {
                    "inputs": [x.decode() for x in nf.get(1, [])],
                    "outputs": [x.decode() for x in nf.get(2, [])],
                    "op": nf.get(4, [b""])[0].decode(),
                    "attrs": dict(_attr(a) for a in nf.get(5, [])),
                }
            )
        self.inputs: List[Tuple[str, List[int]]] = []
        for vi in g.get(11, []):
            name, dims = _value_info_dims(vi)
            if name not in self.initializers:
                self.inputs.append((name, dims))
        self.outputs: List[str] = [_value_info_dims(vi)[0] for vi in g.get(12, [])]

    @property
    def in_dim(self) -> int:
        if not self.inputs:
            raise SurrealError("ONNX graph has no inputs")
        dims = self.inputs[0][1]
        return int(dims[-1]) if dims and dims[-1] else 1

    def build_forward(self, np_like):
        """Return fwd(x) over numpy OR a TorchNp namespace (np_like): x
        [N, D] → [N, out]. The initializers and Constant node values are
        converted once, here: numpy keeps them, a TorchNp uploads them to
        its device. The forward is pure functional."""
        nodes = [n for n in self.nodes if n["op"] != "Constant"]
        host: Dict[str, np.ndarray] = dict(self.initializers)
        for node in self.nodes:
            if node["op"] == "Constant":
                host[node["outputs"][0]] = np.asarray(node["attrs"].get("value"))
        consts = {name: np_like.asarray(arr) for name, arr in host.items()}
        in_name = self.inputs[0][0]
        out_name = self.outputs[0]

        def fwd(x):
            env: Dict[str, Any] = dict(consts)
            env[in_name] = x
            for node in nodes:
                _apply(np_like, node, env, host)
            if out_name not in env:
                raise SurrealError(f"ONNX output {out_name!r} never produced")
            out = env[out_name]
            if out.ndim == 1:
                out = out.reshape(-1, 1)
            return out

        return fwd


class TorchNp:
    """The part of numpy's namespace that `_apply` uses, over torch tensors
    on one device. MatMul / Gemm products go to K10's linear kernel and
    Softmax to its row-softmax kernel (ml/model.py); on a CPU device those
    run their plain versions."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = torch.device(device)

    def asarray(self, arr):
        """A host array on the device: int64 stays int64, floats are f32
        (as `_tensor` leaves them)."""
        a = np.array(arr, dtype=np.float32 if np.asarray(arr).dtype.kind == "f" else None)
        return self.torch.from_numpy(a).to(self.device)

    def matmul(self, a, b):
        """numpy's matmul over K10: 1-D operands are promoted and squeezed
        as numpy does, a first operand of more than two dims is flattened
        to 2-D, a second one of more than two dims loops the kernel over
        its leading index."""
        from .model import linear_act

        if b.ndim == 1:
            return self.matmul(a, b[:, None])[..., 0]
        if a.ndim == 1:
            return self.matmul(a[None, :], b)[0]
        if b.ndim > 2:
            lead = [a[i] if a.ndim == b.ndim else a for i in range(b.shape[0])]
            return self.torch.stack([self.matmul(ai, b[i]) for i, ai in enumerate(lead)])
        f32 = self.torch.float32
        a2 = a.reshape(-1, a.shape[-1]).to(f32).contiguous()
        w = b.to(f32).contiguous()
        zero = self.torch.zeros(w.shape[1], dtype=f32, device=w.device)
        return linear_act(a2, w, zero, None).reshape(*a.shape[:-1], w.shape[1])

    def softmax(self, x, axis):
        """Softmax over `axis` by K10's row softmax: the axis is moved last
        and the rest flattened to rows."""
        from .model import row_softmax

        moved = self.torch.movedim(x.to(self.torch.float32), axis, -1).contiguous()
        r = row_softmax(moved.reshape(-1, moved.shape[-1]))
        return self.torch.movedim(r.reshape(moved.shape), -1, axis)

    @staticmethod
    def transpose(x, perm=None):
        return x.permute(*perm) if perm else x.permute(*reversed(range(x.ndim)))

    def maximum(self, x, y):
        return self.torch.clamp(x, min=y) if isinstance(y, (int, float)) else self.torch.maximum(x, y)

    def where(self, c, a, b):
        return self.torch.where(c, a, b)

    def exp(self, x):
        return self.torch.exp(x)

    def sqrt(self, x):
        return self.torch.sqrt(x)

    def tanh(self, x):
        return self.torch.tanh(x)

    def clip(self, x, lo, hi):
        """numpy's clip, minimum(maximum(x, lo), hi), with either bound a
        number, a tensor or None."""
        if lo is not None:
            x = self.torch.clamp(x, min=lo)
        if hi is not None:
            x = self.torch.clamp(x, max=hi)
        return x

    def sum(self, x, axis=None, keepdims=False):
        """numpy's sum: `axis` a tuple of dims or None (all of them)."""
        return self.torch.sum(x, dim=axis or tuple(range(x.ndim)), keepdim=keepdims)

    def mean(self, x, axis=None, keepdims=False):
        return self.torch.mean(x, dim=axis or tuple(range(x.ndim)), keepdim=keepdims)

    def concatenate(self, xs, axis):
        return self.torch.cat(xs, dim=axis)


def _apply(np_like, node, env, host) -> None:
    """One node over env (name -> array of np_like's kind); `host` holds
    the initializers and Constant values as numpy arrays."""
    op = node["op"]
    ins = [env[i] if i else None for i in node["inputs"]]
    a = node["attrs"]
    xp = np_like
    if op == "MatMul":
        r = xp.matmul(ins[0], ins[1])
    elif op == "Gemm":
        x, w = ins[0], ins[1]
        if a.get("transA"):
            x = xp.transpose(x)
        if a.get("transB"):
            w = xp.transpose(w)
        r = a.get("alpha", 1.0) * xp.matmul(x, w)
        if len(ins) > 2 and ins[2] is not None:
            r = r + a.get("beta", 1.0) * ins[2]
    elif op == "Add":
        r = ins[0] + ins[1]
    elif op == "Sub":
        r = ins[0] - ins[1]
    elif op == "Mul":
        r = ins[0] * ins[1]
    elif op == "Div":
        r = ins[0] / ins[1]
    elif op == "Neg":
        r = -ins[0]
    elif op == "Exp":
        r = xp.exp(ins[0])
    elif op == "Sqrt":
        r = xp.sqrt(ins[0])
    elif op == "Pow":
        r = ins[0] ** ins[1]
    elif op == "Relu":
        r = xp.maximum(ins[0], 0)
    elif op == "LeakyRelu":
        alpha = a.get("alpha", 0.01)
        r = xp.where(ins[0] > 0, ins[0], alpha * ins[0])
    elif op == "Elu":
        alpha = a.get("alpha", 1.0)
        r = xp.where(ins[0] > 0, ins[0], alpha * (xp.exp(ins[0]) - 1))
    elif op == "Sigmoid":
        r = 1.0 / (1.0 + xp.exp(-ins[0]))
    elif op == "Tanh":
        r = xp.tanh(ins[0])
    elif op == "Softmax":
        axis = a.get("axis", -1)
        if hasattr(xp, "softmax"):  # a TorchNp: K10's row softmax
            r = xp.softmax(ins[0], axis)
        else:
            e = xp.exp(ins[0] - xp.max(ins[0], axis=axis, keepdims=True))
            r = e / xp.sum(e, axis=axis, keepdims=True)
    elif op in ("Identity", "Cast", "Dropout"):
        r = ins[0]
    elif op == "Flatten":
        r = ins[0].reshape(ins[0].shape[0], -1)
    elif op == "Reshape":
        src = host.get(node["inputs"][1])
        shape = [int(s) for s in np.asarray(ins[1] if src is None else src).tolist()]
        shape = [ins[0].shape[i] if s == 0 else s for i, s in enumerate(shape)]
        r = ins[0].reshape(shape)
    elif op == "Transpose":
        r = xp.transpose(ins[0], a.get("perm"))
    elif op == "Clip":
        lo = ins[1] if len(ins) > 1 and ins[1] is not None else a.get("min")
        hi = ins[2] if len(ins) > 2 and ins[2] is not None else a.get("max")
        r = xp.clip(ins[0], lo, hi)
    elif op == "ReduceSum":
        axes = a.get("axes")
        r = xp.sum(ins[0], axis=tuple(axes) if axes else None, keepdims=bool(a.get("keepdims", 1)))
    elif op == "ReduceMean":
        axes = a.get("axes")
        r = xp.mean(ins[0], axis=tuple(axes) if axes else None, keepdims=bool(a.get("keepdims", 1)))
    elif op == "Concat":
        r = xp.concatenate([i for i in ins if i is not None], axis=a.get("axis", 0))
    else:
        raise SurrealError(f"unsupported ONNX operator {op!r}")
    env[node["outputs"][0]] = r
