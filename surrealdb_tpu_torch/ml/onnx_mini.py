"""Minimal ONNX runtime: protobuf wire parser, numpy forward, device plan.

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
The reference builds its forward over numpy (the host twin) or jax.numpy,
jitted into one XLA program on the device. Here `build_forward(np)` is the
host twin, and `OnnxGraph.lower(device)` is the device forward (K16): once
a model and device it turns the node list into a fixed list of launches of
ml/model.py's kernels over named buffers, with the initializers uploaded
once:

- a MatMul or Gemm is one `linear_act` (ml_linear) launch (a MatMul by a
  stack of weights [B, K, N], B launches), its initializer
  weight transposed once on the host, its alpha and + beta C and the chain
  of elementwise nodes after it, each the single consumer of the last,
  folded into its epilogue program while their other operands are
  constants of one value or one a column (at most 8 instructions, 2
  per-column operands);
- any other maximal chain of elementwise nodes is one `ewise` (ml_ewise)
  launch of at most 16 instructions over up to 4 broadcast inputs;
- Transpose is an `ewise` copy through permuted strides, Concat one `ewise`
  copy an input into a slice of its output; Reshape, Flatten, Identity,
  Cast and Dropout are views and launch nothing;
- ReduceSum / ReduceMean are `reduce_axis` (ml_reduce), Softmax
  `row_softmax` (ml_softmax), with `ewise` copies moving another axis last
  and back;
- nodes whose inputs are all constants are evaluated once on the host.

The graph input may be bf16 (the vector mirror as the card holds it): its
first consumers read it as it is. An operator with no lowering raises
SurrealError, as the reference's `_apply` does; nothing runs eagerly.
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
        """Return fwd(x) over numpy (np_like): x [N, D] → [N, out], the
        host twin (the device forward is `lower`). The initializers and
        Constant node values are converted once, here. The forward is pure
        functional."""
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

    def lower(self, device) -> "OnnxPlan":
        """The device forward (K16): the graph lowered once onto `device`,
        its initializers uploaded; a function of an [M, in_dim] f32 or
        bf16 tensor there to [M, out] f32 (the module docstring's rules)."""
        return OnnxPlan(self, device)



# ------------------------------------------------------------------ the device plan (K16)
_BINARY = {"Add": "add", "Sub": "sub", "Mul": "mul", "Div": "div", "Pow": "pow"}
_UNARY = {"Neg": "neg", "Exp": "exp", "Sqrt": "sqrt", "Relu": "relu", "Sigmoid": "sigmoid",
          "Tanh": "tanh"}
_ALPHA = {"LeakyRelu": ("leaky", 0.01), "Elu": ("elu", 1.0)}
_VIEWS = ("Identity", "Cast", "Dropout", "Flatten", "Reshape")
_ACC_EPI, _ACC_EW = 0, 4  # the chain's register: ml_linear's product; past ml_ewise's inputs
_IMM = 8  # ml/model.py IMM
_COPY_INS = (("copy", 0, 0, 0, 0.0),)


def _resolve(ref, env):
    """A step's input: ("val", name, perm or None) from env, or ("const", tensor)."""
    if ref[0] == "const":
        return ref[1]
    t = env[ref[1]]
    return t.permute(*ref[2]) if ref[2] is not None else t


def _copy(t, device):
    """t (any strides, f32 or bf16) into a new contiguous f32 tensor: one ml_ewise."""
    import torch

    from .model import Program, ewise

    return ewise(Program(_COPY_INS, 0), [t], torch.empty(t.shape, dtype=torch.float32,
                                                         device=device))


class _ViewStep:
    kernels = ()

    def __init__(self, op, src, out, target=None):
        self.op, self.src, self.out, self.target = op, src, out, target

    def reads(self):
        return [self.src]

    def run(self, env, device):
        t = env[self.src]
        if self.op == "Flatten":
            t = t.view(t.shape[0], -1)
        elif self.op == "Reshape":
            t = t.view([t.shape[i] if s == 0 else s for i, s in enumerate(self.target)])
        env[self.out] = t


class _EwiseStep:
    """One ml_ewise launch: inputs in r0..r3, the chain in r4."""

    kernels = ("ml_ewise",)

    def __init__(self, out, inputs, ins):
        self.out, self.inputs, self.ins, self.prog = out, list(inputs), list(ins), None

    def reads(self):
        return [ref[1] for ref in self.inputs if ref[0] == "val"]

    def finish(self):
        from .model import Program

        self.prog = Program(self.ins, _ACC_EW)

    def run(self, env, device):
        import torch

        from .model import ewise

        ts = [_resolve(ref, env) for ref in self.inputs]
        out = torch.empty(torch.broadcast_shapes(*(t.shape for t in ts)), dtype=torch.float32,
                          device=device)
        env[self.out] = ewise(self.prog, ts, out)


class _LinearStep:
    """One ml_linear launch: x [..., K] (or [K]) @ w [K, N] (or [K]) with
    numpy's matmul shapes, the epilogue over r0 (the product), r1, r2; a
    stack of B weights [B, K, N] is B launches, each writing its slice of
    one [B, M, N] output, x [M, K] or [B, M, K]."""

    def __init__(self, out, x, w, n, w_vector, rank, batch=0):
        self.out, self.x, self.w, self.n, self.w_vector, self.rank = out, x, w, n, w_vector, rank
        self.batch = batch
        self.kernels = ("ml_linear",) * max(batch, 1)
        self.ins, self.operands, self.epi = [], [], None

    def reads(self):
        return [ref[1] for ref in (self.x, self.w) if ref[0] == "val"]

    def finish(self):
        from .model import Epilogue, Program

        self.epi = Epilogue(Program(self.ins, _ACC_EPI), self.operands)

    def run(self, env, device):
        import torch

        from .model import linear_act

        x, w = _resolve(self.x, env), _resolve(self.w, env)
        if self.batch:
            m = x.shape[-2]
            out = torch.empty((self.batch, m, w.shape[2]), dtype=torch.float32, device=device)
            for i in range(self.batch):
                linear_act(x[i] if x.dim() == 3 else x, w[i], epilogue=self.epi, out=out[i])
            env[self.out] = out
            return
        if w.dim() == 1:
            w = w.view(-1, 1)
        lead = tuple(x.shape[:-1])
        y = linear_act(x.view(-1, x.shape[-1]), w, epilogue=self.epi)
        env[self.out] = y.view(lead) if self.w_vector else y.view(*lead, w.shape[1])


class _ReduceStep:
    def __init__(self, src, out, axes, keepdims, mean, rank):
        from .model import _axis_runs, _norm_axes

        self.src, self.out, self.axes, self.keepdims, self.mean = src, out, axes, keepdims, mean
        dims = _norm_axes(rank, axes)
        self.kernels = ("ml_reduce",) * len(_axis_runs(dims)) if dims else ("ml_ewise",)

    def reads(self):
        return [self.src]

    def run(self, env, device):
        from .model import reduce_axis

        env[self.out] = reduce_axis(env[self.src], self.axes, self.keepdims, self.mean)


class _SoftmaxStep:
    """ml_softmax over the last axis; another axis is moved last by an
    ml_ewise copy and back by another; a bf16 input is copied to f32."""

    def __init__(self, src, out, axis, rank, copy_in):
        self.src, self.out, self.axis, self.rank, self.copy_in = src, out, axis, rank, copy_in
        self.last = axis == rank - 1
        self.kernels = (("ml_ewise",) if copy_in or not self.last else ()) + ("ml_softmax",) \
            + (() if self.last else ("ml_ewise",))

    def reads(self):
        return [self.src]

    def run(self, env, device):
        from .model import row_softmax

        t = env[self.src]
        perm = [i for i in range(self.rank) if i != self.axis] + [self.axis]
        if not self.last:
            t = _copy(t.permute(*perm), device)
        elif self.copy_in:
            t = _copy(t, device)
        r = row_softmax(t.view(-1, t.shape[-1])).view(t.shape)
        if not self.last:
            r = _copy(r.permute(*np.argsort(perm).tolist()), device)
        env[self.out] = r


class _ConcatStep:
    def __init__(self, inputs, out, axis):
        self.inputs, self.out, self.axis = inputs, out, axis
        self.kernels = ("ml_ewise",) * len(inputs)

    def reads(self):
        return [ref[1] for ref in self.inputs if ref[0] == "val"]

    def run(self, env, device):
        import torch

        from .model import Program, ewise

        ts = [_resolve(ref, env) for ref in self.inputs]
        shape = list(ts[0].shape)
        shape[self.axis] = sum(t.shape[self.axis] for t in ts)
        out = torch.empty(shape, dtype=torch.float32, device=device)
        off = 0
        for t in ts:
            ewise(Program(_COPY_INS, 0), [t], out.narrow(self.axis, off, t.shape[self.axis]))
            off += t.shape[self.axis]
        env[self.out] = out


class OnnxPlan:
    """An OnnxGraph lowered onto one device (OnnxGraph.lower): `steps` run
    in order over named buffers, `kernels` the launches a forward makes, in
    order. Calling it runs the forward: x [M, in_dim] f32 or bf16 -> [M,
    out] f32."""

    def __init__(self, graph: "OnnxGraph", device):
        import torch

        self.device = torch.device(device)
        self.in_name, out_name = graph.inputs[0][0], graph.outputs[0]
        host: Dict[str, np.ndarray] = dict(graph.initializers)
        nodes = []
        for node in graph.nodes:
            if node["op"] == "Constant":
                host[node["outputs"][0]] = np.asarray(node["attrs"].get("value"))
            else:
                nodes.append(node)
        # every value's shape on a probe batch (ranks do not depend on M);
        # an unsupported operator raises here, as the reference's _apply does
        probe: Dict[str, Any] = dict(host)
        probe[self.in_name] = np.zeros((3, graph.in_dim), np.float32)
        with np.errstate(all="ignore"):
            for node in nodes:
                _apply(np, node, probe, host)
            live = []
            for node in nodes:  # nodes of constants alone: once, here
                names = [i for i in node["inputs"] if i]
                if names and all(i in host for i in names):
                    _apply(np, node, host, host)
                else:
                    live.append(node)
        self._shapes = {k: np.shape(v) for k, v in probe.items()}
        self._host, self._uploaded = host, {}
        self._consumers: Dict[str, int] = {}
        for node in live:  # consumer nodes of each value
            for i in set(node["inputs"]) - {""}:
                self._consumers[i] = self._consumers.get(i, 0) + 1
        self._consumers[out_name] = self._consumers.get(out_name, 0) + 1
        self.steps: List[Any] = []
        self._open: Dict[str, Any] = {}  # chain end -> the step that can take more
        self._maybe_bf16 = {self.in_name}
        self._seq = 0
        for node in live:
            self._lower(node)
        self.final, self.final_const = out_name, None
        if out_name in host:
            self.final_const = self._upload(host[out_name])
        elif out_name in self._maybe_bf16:
            self.final = self._fresh(out_name)
            self.steps.append(_EwiseStep(self.final, [("val", out_name, None)],
                                         [("copy", _ACC_EW, 0, 0, 0.0)]))
        for step in self.steps:
            if hasattr(step, "finish"):
                step.finish()
        last = {}
        for i, step in enumerate(self.steps):
            for name in step.reads():
                last[name] = i
        self._drop = [[] for _ in self.steps]
        for name, i in last.items():
            if name != self.final:
                self._drop[i].append(name)
        self.kernels = tuple(k for step in self.steps for k in step.kernels)

    def __call__(self, x):
        env: Dict[str, Any] = {self.in_name: x}
        for step, drop in zip(self.steps, self._drop):
            step.run(env, self.device)
            for name in drop:
                env.pop(name, None)
        out = self.final_const if self.final_const is not None else env[self.final]
        return out.view(-1, 1) if out.dim() == 1 else out

    # -------------------------------------------------------------- lowering
    def _fresh(self, base: str) -> str:
        self._seq += 1
        return f"{base}#{self._seq}"

    def _upload(self, arr):
        import torch

        key = id(arr)
        if key not in self._uploaded:
            a = np.ascontiguousarray(np.asarray(arr, dtype=np.float32))
            self._uploaded[key] = (arr, torch.from_numpy(a.copy()).to(self.device))
        return self._uploaded[key][1]

    def _rank(self, name: str) -> int:
        return len(self._shapes[name])

    def _operand(self, name: Optional[str], other_rank: int):
        """A node argument: ("imm", v) for a constant of one value that does
        not widen the result, ("host", array) for another constant,
        ("val", name) for a computed value; None for an absent one."""
        if not name:
            return None
        if name in self._host:
            arr = np.asarray(self._host[name])
            if arr.size == 1 and arr.ndim <= other_rank:
                return ("imm", float(arr.reshape(())))
            return ("host", arr)
        return ("val", name)

    def _push(self, step) -> None:
        self.steps.append(step)
        if isinstance(step, (_EwiseStep, _LinearStep)):
            self._open[step.out] = step

    def _ewise_copy(self, name: str, perm=None) -> str:
        """A new buffer: value `name` (permuted) as contiguous f32."""
        out = self._fresh(name)
        self._push(_EwiseStep(out, [("val", name, perm)], [("copy", _ACC_EW, 0, 0, 0.0)]))
        return out

    def _lower(self, node) -> None:
        op, a, out = node["op"], node["attrs"], node["outputs"][0]
        ins = node["inputs"]
        if op in _VIEWS:
            target = None
            if op == "Reshape":
                if ins[1] not in self._host:
                    raise SurrealError("ONNX Reshape needs a constant shape")
                target = [int(v) for v in np.asarray(self._host[ins[1]]).tolist()]
            self.steps.append(_ViewStep(op, ins[0], out, target))
            if ins[0] in self._maybe_bf16:
                self._maybe_bf16.add(out)
        elif op in _BINARY or op in _UNARY or op in _ALPHA or op == "Clip":
            self._lower_elementwise(node)
        elif op in ("MatMul", "Gemm"):
            self._lower_product(node)
        elif op == "Transpose":
            rank = self._rank(ins[0])
            perm = a.get("perm") or list(reversed(range(rank)))
            step = _EwiseStep(out, [("val", ins[0], [int(p) for p in perm])],
                              [("copy", _ACC_EW, 0, 0, 0.0)])
            self._push(step)
        elif op == "Concat":
            refs = []
            for i in ins:
                if i:
                    refs.append(("const", self._upload(self._host[i])) if i in self._host
                                else ("val", i, None))
            rank = len(self._shapes[out])
            self.steps.append(_ConcatStep(refs, out, int(a.get("axis", 0)) % rank))
        elif op in ("ReduceSum", "ReduceMean"):
            axes = a.get("axes")
            self.steps.append(_ReduceStep(ins[0], out, list(axes) if axes else None,
                                          bool(a.get("keepdims", 1)), op == "ReduceMean",
                                          self._rank(ins[0])))
        elif op == "Softmax":
            rank = self._rank(ins[0])
            self.steps.append(_SoftmaxStep(ins[0], out, int(a.get("axis", -1)) % rank, rank,
                                           ins[0] in self._maybe_bf16))
        else:
            raise SurrealError(f"unsupported ONNX operator {op!r}")

    def _args(self, node):
        """(the node's op code, its arguments as operands, its immediate
        attribute): binary (a, b), unary (x,), Clip (x, lo, hi)."""
        op, a, ins = node["op"], node["attrs"], node["inputs"]
        out_rank = len(self._shapes[node["outputs"][0]])
        if op in _BINARY:
            ranks = [len(self._shapes[i]) for i in ins[:2]]
            return _BINARY[op], [self._operand(ins[0], ranks[1]),
                                 self._operand(ins[1], ranks[0])], 0.0
        if op in _UNARY:
            return _UNARY[op], [self._operand(ins[0], out_rank)], 0.0
        if op in _ALPHA:
            code, default = _ALPHA[op]
            return code, [self._operand(ins[0], out_rank)], float(a.get("alpha", default))
        x_rank = self._rank(ins[0])
        args = [self._operand(ins[0], out_rank)]
        for k, attr in ((1, "min"), (2, "max")):
            if len(ins) > k and ins[k]:
                args.append(self._operand(ins[k], x_rank))
            else:
                v = a.get(attr)
                args.append(None if v is None else ("imm", float(v)))
        return "clip", args, 0.0

    @staticmethod
    def _emit(code, regs, alpha, acc):
        """The node's instructions into register acc: regs are (register or
        IMM, immediate) for each argument (None: absent)."""
        if code == "clip":
            (rx, ix), lo, hi = regs
            ins, cur = [], rx
            for name, bound in (("max", lo), ("min", hi)):
                if bound is not None:
                    ins.append((name, acc, cur, bound[0], bound[1] if bound[0] == _IMM else ix))
                    cur = acc
            return ins or [("copy", acc, rx, rx, ix)]
        if len(regs) == 2:
            (ra, ia), (rb, ib) = regs
            return [(code, acc, ra, rb, ia if ra == _IMM else ib)]
        (ra, ia), = regs
        return [(code, acc, ra, ra, alpha if code in ("leaky", "elu") else ia)]

    def _lower_elementwise(self, node) -> None:
        code, args, alpha = self._args(node)
        out = node["outputs"][0]
        n_ins = 2 if code == "clip" else 1
        for idx, arg in enumerate(args):
            if arg is None or arg[0] != "val":
                continue
            step = self._open.get(arg[1])
            if step is None or self._consumers.get(arg[1], 0) != 1:
                continue
            regs = self._fold_regs(step, args, idx)
            if regs is None or len(step.ins) + n_ins > (
                    8 if isinstance(step, _LinearStep) else 16):
                continue
            self._commit_fold(step, args, idx)
            step.ins += self._emit(code, self._fold_regs(step, args, idx), alpha,
                                   _ACC_EPI if isinstance(step, _LinearStep) else _ACC_EW)
            del self._open[arg[1]]
            step.out = out
            self._open[out] = step
            self.steps.remove(step)  # its new inputs are ready only here
            self.steps.append(step)
            return
        # a new launch: the non-immediate arguments are its inputs
        inputs, regs = [], []
        for arg in args:
            if arg is None:
                regs.append(None)
            elif arg[0] == "imm":
                regs.append((_IMM, arg[1]))
            else:
                ref = ("const", self._upload(arg[1])) if arg[0] == "host" \
                    else ("val", arg[1], None)
                same = [k for k, r in enumerate(inputs) if r[0] == "val" and ref[0] == "val"
                        and r[1] == ref[1]]
                if same:
                    regs.append((same[0], 0.0))
                else:
                    regs.append((len(inputs), 0.0))
                    inputs.append(ref)
        self._push(_EwiseStep(out, inputs, self._emit(code, regs, alpha, _ACC_EW)))

    def _fold_regs(self, step, args, chain):
        """The registers of the arguments if the node folds into `step` with
        argument `chain` the step's output, else None (no room, or an
        argument the step cannot read). Read-only: _commit_fold assigns."""
        regs = []
        if isinstance(step, _LinearStep):
            slots = [id(o) for o in step.operands]
            extra = 0
            for arg in args:
                if arg is None:
                    regs.append(None)
                elif arg == args[chain]:
                    regs.append((_ACC_EPI, 0.0))
                elif arg[0] == "imm":
                    regs.append((_IMM, arg[1]))
                elif arg[0] == "host" and step.n is not None and arg[1].ndim >= 1 \
                        and arg[1].shape[-1] == step.n and arg[1].size == step.n \
                        and arg[1].ndim <= step.rank:
                    t = self._upload(arg[1])
                    if id(t) in slots:
                        regs.append((1 + slots.index(id(t)), 0.0))
                    else:
                        regs.append((1 + len(slots) + extra, 0.0))
                        extra += 1
                else:
                    return None
            return regs if len(slots) + extra <= 2 else None
        refs = list(step.inputs)
        for arg in args:
            if arg is None:
                regs.append(None)
            elif arg == args[chain]:
                regs.append((_ACC_EW, 0.0))
            elif arg[0] == "imm":
                regs.append((_IMM, arg[1]))
            else:
                ref = ("const", self._upload(arg[1])) if arg[0] == "host" \
                    else ("val", arg[1], None)
                hit = [j for j, r in enumerate(refs) if r[0] == ref[0] and (
                    r[1] is ref[1] if r[0] == "const" else (r[1] == ref[1] and r[2] is None))]
                if hit:
                    regs.append((hit[0], 0.0))
                else:
                    regs.append((len(refs), 0.0))
                    refs.append(ref)
        return regs if len(refs) <= 4 else None

    def _commit_fold(self, step, args, chain) -> None:
        """Adds the operands / inputs that _fold_regs counted to the step."""
        if isinstance(step, _LinearStep):
            for arg in args:
                if arg is not None and arg[0] == "host":
                    t = self._upload(arg[1])
                    if all(o is not t for o in step.operands):
                        step.operands.append(t)
            return
        for arg in args:
            if arg is None or arg[0] == "imm" or arg == args[chain]:
                continue
            ref = ("const", self._upload(arg[1])) if arg[0] == "host" else ("val", arg[1], None)
            if not any(r[0] == ref[0] and (r[1] is ref[1] if r[0] == "const"
                                            else (r[1] == ref[1] and r[2] is None))
                       for r in step.inputs):
                step.inputs.append(ref)

    def _lower_product(self, node) -> None:
        op, a, ins, out = node["op"], node["attrs"], node["inputs"], node["outputs"][0]
        gemm = op == "Gemm"
        x_name, w_name = ins[0], ins[1]
        # x: a computed value (transposed by a copy for transA), or a constant
        if x_name in self._host:
            xa = np.asarray(self._host[x_name], np.float32)
            x_ref = ("const", self._upload(xa.T if gemm and a.get("transA") else xa))
            x_rank = xa.ndim
        else:
            if gemm and a.get("transA"):
                x_name = self._ewise_copy(x_name, [1, 0])
            x_ref, x_rank = ("val", x_name, None), self._rank(ins[0])
        # w: a constant transposed once here, or a computed f32 value
        if w_name in self._host:
            wa = np.asarray(self._host[w_name], np.float32)
            if gemm and a.get("transB"):
                wa = wa.T
            w_shape = wa.shape
            w_vector = wa.ndim == 1
            n = 1 if w_vector else wa.shape[-1]
            w_ref = ("const", wa[:, None] if w_vector else wa)
        else:
            w_shape = self._shapes[w_name]
            transb = gemm and a.get("transB")
            if transb or w_name in self._maybe_bf16:
                w_name = self._ewise_copy(w_name, [1, 0] if transb else None)
            w_vector = len(w_shape) == 1
            n = 1 if w_vector else self._shapes[ins[1]][0 if transb else -1]
            w_ref = ("val", w_name, None)
        batch = 0
        if len(w_shape) == 3:  # a stack of weights: x [M, K] or [B, M, K]
            batch = int(w_shape[0])
            if gemm or x_rank not in (2, 3) or (x_rank == 3 and self._shapes[ins[0]][0] != batch):
                raise SurrealError(f"ONNX {op} of a {x_rank}-d by a 3-d operand is not lowered")
        elif len(w_shape) > 2:
            raise SurrealError(f"ONNX {op} with a {len(w_shape)}-d second operand is not lowered")
        if w_ref[0] == "const":
            w_ref = ("const", self._upload(np.ascontiguousarray(w_ref[1])))
        rank = 3 if batch else max(x_rank - 1, 0) + (0 if w_vector else 1)
        c_name = ins[2] if gemm and len(ins) > 2 and ins[2] else None
        alpha, beta = float(a.get("alpha", 1.0)), float(a.get("beta", 1.0))
        step = _LinearStep(out, x_ref, w_ref, None if w_vector else n, w_vector, rank, batch)
        if gemm and alpha != 1.0:
            step.ins.append(("mul", _ACC_EPI, _ACC_EPI, _IMM, alpha))
        if c_name is not None:
            c = self._host.get(c_name)
            bc = None if c is None else np.asarray(c, np.float32)
            if bc is not None and beta != 1.0:
                bc = np.float32(beta) * bc  # beta * C, rounded once, as the reference does
            if bc is not None and bc.size == 1 and bc.ndim <= rank:
                step.ins.append(("add", _ACC_EPI, _ACC_EPI, _IMM, float(bc.reshape(()))))
            elif bc is not None and not w_vector and bc.ndim >= 1 and bc.shape[-1] == n \
                    and bc.size == n and bc.ndim <= rank:
                step.operands.append(self._upload(np.ascontiguousarray(bc.reshape(n))))
                step.ins.append(("add", _ACC_EPI, _ACC_EPI, 1, 0.0))
            else:  # + beta C by an ml_ewise launch after the product
                step.out = self._fresh(out)
                self._push(step)
                c_ref = ("const", self._upload(c)) if c is not None else ("val", c_name, None)
                ins_c = [("mul", _ACC_EW, 1, _IMM, beta), ("add", _ACC_EW, 0, _ACC_EW, 0.0)] \
                    if beta != 1.0 else [("add", _ACC_EW, 0, 1, 0.0)]
                self._push(_EwiseStep(out, [("val", step.out, None), c_ref], ins_c))
                self._consumers[step.out] = 1
                return
        self._push(step)


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
