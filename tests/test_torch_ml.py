"""The ML slice of the PyTorch port (surrealdb_tpu_torch/ml/: model.py with
K10's wrappers `linear_act` / `row_softmax`, onnx_mini.py, surml.py,
exec.py, and `ml::name<v>(...)` through Datastore.execute) held against the
JAX reference on the same seeded inputs: the reference on the CPU
(JAX_PLATFORMS=cpu, its jitted `_device_fn` above the device threshold),
the port with CPU tensors, i.e. the plain PyTorch versions of its kernels.

Tolerances: rtol 1e-5 with atol 1e-5 (f32 products summed in another
order than XLA's), atol 1e-4 at K = 768; softmax outputs atol 1e-6. Below
the device threshold both packages run the same numpy twin, so their
answers are equal exactly.
"""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu.dbs.session import Session as RSession
from surrealdb_tpu.kvs.ds import Datastore as RDatastore
from surrealdb_tpu.ml import exec as RX
from surrealdb_tpu.ml import model as RM
from surrealdb_tpu.ml.onnx_mini import OnnxGraph as ROnnxGraph
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch.dbs.session import Session as PSession
from surrealdb_tpu_torch.kvs.ds import Datastore as PDatastore
from surrealdb_tpu_torch.ml import exec as PX
from surrealdb_tpu_torch.ml import model as PM
from surrealdb_tpu_torch.ml.onnx_mini import OnnxGraph as POnnxGraph
from surrealdb_tpu_torch.ml.surml import denormalise, normalise, parse_surml

RTOL, ATOL, ATOL_768, SOFTMAX_ATOL = 1e-5, 1e-5, 1e-4, 1e-6
CPU = torch.device("cpu")


def _layer(rng, k, n, act, bias=True):
    return {"w": (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32),
            "b": (rng.standard_normal(n) if bias else np.zeros(n)).astype(np.float32),
            "activation": act}


def _spec(layers):
    return RM.validate_spec({"format": "mlp" if len(layers) > 1 else "linear",
                             "layers": layers})


def _ref_device(spec, x):
    """The reference's jitted device forward (the CPU backend here)."""
    return np.asarray(RM.CompiledModel(spec)._device_fn()(jnp.asarray(x)))


def _port_device(spec, x):
    """The port's: each layer `linear_act` (+ `row_softmax`), which on CPU
    tensors run their plain versions."""
    fwd = PM.model_from_reference(spec)._device_fn(CPU)
    return fwd(torch.from_numpy(np.ascontiguousarray(x))).numpy()


# ------------------------------------------------------------ K10 alone
@pytest.mark.parametrize("act", [None, "relu", "tanh", "sigmoid", "softmax"], ids=str)
def test_each_activation_matches_reference(act):
    rng = np.random.default_rng(len(str(act)))
    spec = _spec([_layer(rng, 48, 12, act)])
    x = (rng.standard_normal((300, 48)) * 3).astype(np.float32)
    np.testing.assert_allclose(_port_device(spec, x), _ref_device(spec, x), rtol=RTOL,
                               atol=SOFTMAX_ATOL if act == "softmax" else ATOL)


def test_linear_act_wrapper_equals_its_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    lay = _layer(rng, 20, 3, "tanh")
    x = torch.from_numpy(rng.standard_normal((9, 20)).astype(np.float32))
    w, b = torch.from_numpy(lay["w"]), torch.from_numpy(lay["b"])
    before = [c.launches for c in PM.KERNELS]
    ep = PM.Epilogue.layer(b, "tanh")
    assert torch.equal(PM.linear_act(x, w, ep), PM.linear_act_plain(x, w, ep))
    assert torch.equal(PM.row_softmax(x), PM.row_softmax_plain(x))
    assert [c.launches for c in PM.KERNELS] == before  # the plain versions count nothing


def test_softmax_rows_with_large_magnitudes_match_reference():
    """Rows up to |1e3| (exp overflows without the max subtraction), a row
    of equal values and one with a single dominant entry."""
    rng = np.random.default_rng(11)
    h = (rng.standard_normal((257, 10)) * 400).astype(np.float32)
    h[0] = 900.0
    h[1, 3] = 1e4
    spec = _spec([{"w": np.eye(10, dtype=np.float32), "b": np.zeros(10, np.float32),
                   "activation": "softmax"}])
    got = PM.row_softmax(torch.from_numpy(h)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _ref_device(spec, h), rtol=0, atol=SOFTMAX_ATOL)


def test_sigmoid_saturates_without_nan():
    x = np.array([[-200.0], [-90.0], [0.0], [90.0], [200.0]], np.float32)
    spec = _spec([{"w": np.ones((1, 1), np.float32), "b": np.zeros(1, np.float32),
                   "activation": "sigmoid"}])
    got = _port_device(spec, x)[:, 0]
    assert got.tolist() == [0.0, 0.0, 0.5, 1.0, 1.0]
    np.testing.assert_allclose(got, _ref_device(spec, x)[:, 0], atol=1e-7)
    with np.errstate(over="ignore"):
        assert PM.CompiledModel(spec).forward_host(x)[:, 0].tolist() == got.tolist()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_features"])
def test_config5_linear_768_to_1_matches_reference(bf16):
    """Bench config 5's model (768 -> 1, b = 0) at M = 4096; with the
    features rounded to bf16, as the card's mirror holds them, the port
    reads the bf16 tensor and the reference the same values in f32."""
    rng = np.random.default_rng(5)
    spec = _spec([{"w": rng.standard_normal((768, 1)).astype(np.float32),
                   "b": np.zeros(1, np.float32), "activation": None}])
    x = rng.standard_normal((4096, 768)).astype(np.float32)
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
        x = xt.to(torch.float32).numpy()
    got = PM.model_from_reference(spec)._device_fn(CPU)(xt).numpy()
    np.testing.assert_allclose(got, _ref_device(spec, x), rtol=RTOL, atol=ATOL_768)


def test_mlp_relu_then_softmax_matches_reference():
    rng = np.random.default_rng(8)
    spec = _spec([_layer(rng, 64, 32, "relu"), _layer(rng, 32, 8, "softmax")])
    x = rng.standard_normal((1500, 64)).astype(np.float32)
    got = _port_device(spec, x)
    np.testing.assert_allclose(got, _ref_device(spec, x), rtol=RTOL, atol=SOFTMAX_ATOL)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    """csrc/ml.cu compiled for the CPU under csrc/emu/cuda_emu.h (the
    kernels' own logic: tests/test_torch_kernel_emulation.py)."""
    from test_torch_kernel_emulation import _build_emu, _source

    return _build_emu(tmp_path_factory.mktemp("ml_emu"), {"ml.cu": _source("ml.cu")})


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_features"])
@pytest.mark.parametrize("dims,acts", [((768, 128, 10), ("relu", "softmax")),
                                       ((768, 16), ("sigmoid",))],
                         ids=["mlp_768x128x10", "linear_768x16"])
def test_mlp_shapes_through_the_emulated_kernels_match_reference(monkeypatch, emu_lib, dims,
                                                                  acts, bf16):
    """The scan's MLP (768 -> 128 relu -> 10 softmax: the wide then the
    narrow path and the softmax) and a 768 -> 16 sigmoid (narrow) at M =
    300: the port's device forward with its `linear_act` / `row_softmax`
    launching the emulated kernels, against the reference's jitted
    forward."""
    calls = []

    def linear(x, w, epilogue):
        out = torch.empty((x.shape[0], w.shape[1]))
        assert PM._launch_linear(emu_lib, x, w, epilogue, out, None) == 0
        calls.append("ml_linear")
        return out

    def softmax(h):
        out = torch.empty_like(h)
        assert PM._launch_softmax(emu_lib, h, out, None) == 0
        calls.append("ml_softmax")
        return out

    monkeypatch.setattr(PM, "linear_act", linear)
    monkeypatch.setattr(PM, "row_softmax", softmax)
    rng = np.random.default_rng(sum(dims))
    spec = _spec([_layer(rng, dims[i], dims[i + 1], act) for i, act in enumerate(acts)])
    x = rng.standard_normal((300, dims[0])).astype(np.float32)
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
        x = xt.to(torch.float32).numpy()
    got = PM.model_from_reference(spec)._device_fn(CPU)(xt).numpy()
    assert calls == ["ml_linear"] * len(acts) + ["ml_softmax"] * ("softmax" in acts)
    np.testing.assert_allclose(got, _ref_device(spec, x), rtol=RTOL,
                               atol=SOFTMAX_ATOL if acts[-1] == "softmax" else ATOL_768)


def test_wrappers_reject_bad_inputs_off_the_cpu():
    x, w, b = torch.zeros(4, 3), torch.zeros(3, 2), torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        PM.linear_act(x.to("meta"), w, PM.Epilogue.layer(b, None))
    with pytest.raises(ValueError, match="CUDA"):
        PM.row_softmax(x.to("meta"))


# ------------------------------------------------------------ CompiledModel.forward
@pytest.mark.parametrize("m", [1000, 1024, 3000])
def test_forward_on_both_sides_of_the_threshold(m):
    """Below 1024 rows both packages run the same numpy twin (equal
    exactly); from 1024 on the reference's jitted forward and the port's
    device forward (plain versions on the CPU) agree within tolerance."""
    rng = np.random.default_rng(m)
    spec = _spec([_layer(rng, 16, 32, "relu"), _layer(rng, 32, 4, "sigmoid")])
    ref = RM.CompiledModel(spec)
    port = PM.model_from_reference(ref, CPU)
    x = rng.standard_normal((m, 16)).astype(np.float32)
    want = ref.forward(x)
    got = port.forward(x, CPU)
    assert got.dtype == np.float32 and got.shape == (m, 4)
    if m < 1024:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert port.dispatches == ref.dispatches == 1


def test_forward_above_the_threshold_needs_a_device():
    spec = _spec([_layer(np.random.default_rng(0), 4, 1, None)])
    cm = PM.CompiledModel(spec)
    with pytest.raises(RuntimeError, match="no device"):
        cm.forward(np.zeros((2048, 4), np.float32), None)
    assert cm.forward(np.zeros((3, 4), np.float32), None).shape == (3, 1)


def test_forward_under_tpu_disable_takes_the_host_twin(monkeypatch):
    rng = np.random.default_rng(2)
    spec = _spec([_layer(rng, 8, 2, "tanh")])
    x = rng.standard_normal((2048, 8)).astype(np.float32)
    monkeypatch.setattr(pcnf, "TPU_DISABLE", True)
    monkeypatch.setattr(rcnf, "TPU_DISABLE", True)
    assert np.array_equal(PM.model_from_reference(spec).forward(x, CPU),
                          RM.CompiledModel(spec).forward(x))


def test_spec_bytes_and_digest_equal_the_reference():
    rng = np.random.default_rng(4)
    spec = _spec([_layer(rng, 6, 5, "relu"), _layer(rng, 5, 2, "softmax")])
    port = PM.model_from_reference(spec)
    raw = PM.spec_to_bytes(port.spec)
    assert raw == RM.spec_to_bytes(spec)
    assert PM.digest(raw) == RM.digest(RM.spec_to_bytes(spec))
    back = PM.spec_from_bytes(raw)
    for a, b in zip(back["layers"], spec["layers"]):
        assert np.array_equal(a["w"], b["w"]) and np.array_equal(a["b"], b["b"])
    onnx_spec = RM.validate_spec({"format": "onnx", "onnx": _graph("matmul_add"),
                                  "keys": ["a"], "normalisers": {"a": ("z_score", [1.0, 2.0])},
                                  "output": ("y", ("z_score", [3.0, 4.0]))})
    raw = PM.spec_to_bytes(PM.model_from_reference(onnx_spec).spec)
    assert raw == RM.spec_to_bytes(onnx_spec)
    assert PM.digest(raw) == RM.digest(raw)


# ------------------------------------------------------------ ONNX
def _varint(v):
    out = b""
    while True:
        c = v & 0x7F
        v >>= 7
        out += bytes([c | (0x80 if v else 0)])
        if not v:
            return out


def _tag(field, wire):
    return _varint((field << 3) | wire)


def _ld(field, payload):
    return _tag(field, 2) + _varint(len(payload)) + payload


def _vint(field, v):
    return _tag(field, 0) + _varint(v)


def _tensor(name, arr):
    arr = np.asarray(arr)
    t = b"".join(_vint(1, d) for d in arr.shape)
    t += _vint(2, 7 if arr.dtype == np.int64 else 1)
    t += _ld(8, name.encode())
    return t + _ld(9, arr.astype("<i8" if arr.dtype == np.int64 else "<f4").tobytes())


def _attr(name, v):
    a = _ld(1, name.encode())
    if isinstance(v, float):
        return a + _tag(2, 5) + struct.pack("<f", v) + _vint(20, 1)
    if isinstance(v, int):
        return a + _vint(3, v) + _vint(20, 2)
    if isinstance(v, np.ndarray):
        return a + _ld(5, _tensor("", v)) + _vint(20, 4)
    return a + b"".join(_vint(8, i) for i in v) + _vint(20, 7)


def _value_info(name, last_dim=None):
    """ValueInfoProto with shape [N, last_dim] (N dynamic)."""
    if last_dim is None:
        return _ld(1, name.encode())
    dims = _ld(1, _ld(2, b"N")) + _ld(1, _vint(1, last_dim))
    tensor_type = _vint(1, 1) + _ld(2, dims)
    return _ld(1, name.encode()) + _ld(2, _ld(1, tensor_type))


def _onnx(nodes, inits, in_dim, out="y"):
    """A ModelProto: nodes are (op, inputs, outputs, attrs)."""
    graph = b""
    for op, ins, outs, attrs in nodes:
        n = b"".join(_ld(1, i.encode()) for i in ins) + b"".join(_ld(2, o.encode()) for o in outs)
        n += _ld(4, op.encode()) + b"".join(_ld(5, _attr(k, v)) for k, v in attrs.items())
        graph += _ld(1, n)
    graph += b"".join(_ld(5, _tensor(k, v)) for k, v in inits.items())
    graph += _ld(11, _value_info("x", in_dim)) + _ld(12, _value_info(out))
    return _vint(1, 7) + _ld(7, graph)


def _mini_onnx_linear(w, b):
    """tests/test_surml.py's hand-assembled y = x @ w + b (protobuf wire)."""
    w = np.asarray(w, np.float32)
    return _onnx([("MatMul", ["x", "w"], ["mm"], {}), ("Add", ["mm", "b"], ["y"], {})],
                 {"w": w, "b": np.asarray(b, np.float32)}, w.shape[0])


def _graph(name):
    r = np.random.default_rng(len(name))

    def f(*shape):
        return r.standard_normal(shape).astype(np.float32)

    graphs = {
        "matmul_add": ([("MatMul", ["x", "w"], ["mm"], {}), ("Add", ["mm", "b"], ["a"], {}),
                        ("Constant", [], ["c"], {"value": f(3)}),
                        ("Add", ["a", "c"], ["y"], {})],
                       {"w": f(6, 3), "b": f(3)}),
        "gemm_transb_beta_relu": ([("Gemm", ["x", "wt", "c"], ["g"],
                                    {"transB": 1, "alpha": 1.5, "beta": 0.5}),
                                   ("Relu", ["g"], ["y"], {})],
                                  {"wt": f(4, 6), "c": f(4)}),
        "softmax": ([("MatMul", ["x", "w"], ["mm"], {}), ("Softmax", ["mm"], ["y"], {})],
                    {"w": f(6, 5) * 4}),
        "softmax_axis0": ([("MatMul", ["x", "w"], ["mm"], {}),
                           ("Softmax", ["mm"], ["y"], {"axis": 0})], {"w": f(6, 5)}),
        "reshape_reducesum": ([("MatMul", ["x", "w"], ["mm"], {}),
                               ("Reshape", ["mm", "s3"], ["r3"], {}),
                               ("ReduceSum", ["r3"], ["rs"], {"axes": [2], "keepdims": 1}),
                               ("Reshape", ["rs", "s2"], ["y"], {})],
                              {"w": f(6, 8), "s3": np.array([0, 2, 4], np.int64),
                               "s2": np.array([0, -1], np.int64)}),
        "clip_concat_transpose": ([("MatMul", ["x", "w1"], ["a"], {}),
                                   ("Clip", ["a", "", "hi"], ["ac"], {}),
                                   ("MatMul", ["x", "w2"], ["b"], {}),
                                   ("Sigmoid", ["b"], ["bs"], {}),
                                   ("Tanh", ["bs"], ["bt"], {}),
                                   ("Concat", ["ac", "bt"], ["cat"], {"axis": 1}),
                                   ("Transpose", ["cat"], ["t"], {"perm": [1, 0]}),
                                   ("ReduceMean", ["t"], ["m"], {"axes": [1], "keepdims": 1}),
                                   ("Sub", ["t", "m"], ["d"], {}),
                                   ("Mul", ["d", "d"], ["dd"], {}),
                                   ("Transpose", ["dd"], ["y"], {})],
                                  {"w1": f(6, 3), "w2": f(6, 2),
                                   "hi": np.array(0.25, np.float32)}),
    }
    nodes, inits = graphs[name]
    return _onnx(nodes, inits, 6)


_GRAPHS = ["matmul_add", "gemm_transb_beta_relu", "softmax", "softmax_axis0",
           "reshape_reducesum", "clip_concat_transpose"]


@pytest.mark.parametrize("name", _GRAPHS)
def test_onnx_torch_forward_matches_reference_jit(name):
    """The reference's jitted graph; for Reshape its eager jnp graph, since
    its jit cannot read a shape from a traced initializer (the port reads
    it from the host copy)."""
    raw = _graph(name)
    x = (np.random.default_rng(1).standard_normal((50, 6)) * 2).astype(np.float32)
    ref_fwd = ROnnxGraph(raw).build_forward(jnp)
    if name == "reshape_reducesum":
        with pytest.raises(jax.errors.TracerArrayConversionError):
            jax.jit(ref_fwd)(jnp.asarray(x))
    else:
        ref_fwd = jax.jit(ref_fwd)
    want = np.asarray(ref_fwd(jnp.asarray(x)))
    g = POnnxGraph(raw)
    got = g.lower("cpu")(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=SOFTMAX_ATOL if "softmax" in name else ATOL)
    host = g.build_forward(np)(x)
    assert np.array_equal(host, ROnnxGraph(raw).build_forward(np)(x))


def test_onnx_initializers_upload_once_and_keep_int64(monkeypatch):
    """The plan uploads its f32 weight once, when it is lowered; the
    Reshape targets stay int64 on the host and are never uploaded."""
    from surrealdb_tpu_torch.ml.onnx_mini import OnnxPlan

    calls = []
    upload = OnnxPlan._upload

    def counting(self, arr):
        calls.append(np.asarray(arr).dtype)
        return upload(self, arr)

    monkeypatch.setattr(OnnxPlan, "_upload", counting)
    plan = POnnxGraph(_graph("reshape_reducesum")).lower("cpu")
    n = len(calls)
    assert sorted(set(map(str, calls))) == ["float32"]
    assert plan._host["s3"].dtype == plan._host["s2"].dtype == np.int64
    for _ in range(3):
        plan(torch.zeros(4, 6))
    assert len(calls) == n


@pytest.mark.parametrize("m", [10, 3000])
def test_onnx_compiled_model_forward_matches_reference(m):
    """An ONNX spec carried across: below the threshold the numpy twins,
    above it the reference's jitted graph and the port's lowered plan."""
    spec = RM.validate_spec({"format": "onnx", "onnx": _graph("gemm_transb_beta_relu")})
    ref = RM.CompiledModel(spec)
    port = PM.model_from_reference(spec, CPU)
    assert (port.in_dim, port.out_dim) == (ref.in_dim, ref.out_dim) == (6, 4)
    x = np.random.default_rng(m).standard_normal((m, 6)).astype(np.float32)
    np.testing.assert_allclose(port.forward(x, CPU), ref.forward(x), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ .surml
def _surml(onnx_raw, name="Pred", version="0.1.0"):
    header = "//=>".join([
        "a=>b", "a=>z_score(3.0,2.0)//b=>linear_scaling(0.0,10.0)",
        "price=>z_score(100.0,5.0)", name, version, "a test model", "onnx", "tests", "someone",
    ])
    h = header.encode()
    return struct.pack(">I", len(h)) + h + onnx_raw


def test_surml_import_and_buffered_compute_match_reference():
    raw = _surml(_mini_onnx_linear([[2.0], [-1.0]], [0.5]))
    assert parse_surml(raw)["keys"] == ["a", "b"]
    rds, pds = RDatastore("memory"), PDatastore("memory", device="cpu")
    try:
        outs = []
        for ds, X, S in ((rds, RX, RSession), (pds, PX, PSession)):
            entry = X.import_surml(ds, S.owner(), raw)
            assert (entry["name"], entry["version"], entry["in_dim"], entry["out_dim"]) == \
                ("Pred", "0.1.0", 2, 1)
            outs.append([ds.execute(q)[-1] for q in (
                "RETURN ml::Pred<0.1.0>({a: 5.0, b: 4.0});",
                "RETURN ml::Pred<0.1.0>([1.0, 2.0]);",
                "RETURN ml::Pred<0.1.0>([[1.0, 2.0], [3.0, 0.0]]);",
            )])
        for r, p in zip(*outs):
            assert r["status"] == p["status"] == "OK", (r, p)
            assert p["result"] == r["result"]
        # buffered: a -> (5-3)/2 = 1, b -> 0.4; y = 2 - 0.4 + 0.5; price = y * 5 + 100
        assert outs[1][0]["result"] == pytest.approx((2.0 - 0.4 + 0.5) * 5.0 + 100.0, rel=1e-6)
        blob = [ds.transaction(False).get_ml("test", "test", "Pred", "0.1.0")["blob"]
                for ds in (rds, pds)]
        assert blob[0] == blob[1]  # the same SHA1 of the same stored bytes
    finally:
        rds.close()
        pds.close()


# ------------------------------------------------------------ through Datastore.execute
def _run(ds, sql, vars=None):
    out = ds.execute(sql, vars=vars or {})
    assert all(r["status"] == "OK" for r in out), out
    return out[-1]["result"]


@pytest.fixture(scope="module", params=["HNSW", "MTREE"])
def loaded(request):
    """Config-5-shaped data at 4,096 rows x 64 (record ids 0..4095, a
    column n = id) under the index kind, ingested into both packages, with
    ml::scorer<1> (linear 64 -> 1, b = 0, as bench_ml_scan imports it) and
    ml::mlp<1> (64 -> 16 relu -> 10 softmax)."""
    rng = np.random.default_rng(21)
    corpus = rng.standard_normal((4096, 64)).astype(np.float32)
    scorer = {"format": "linear", "layers": [
        {"w": rng.standard_normal((64, 1)).astype(np.float32).tolist(), "b": [0.0],
         "activation": None}]}
    mlp = {"format": "mlp", "layers": [_layer(rng, 64, 16, "relu"), _layer(rng, 16, 10, "softmax")]}
    pairs = ((RDatastore("memory"), RX, RSession), (PDatastore("memory", device="cpu"), PX, PSession))
    order = rng.permutation(4096)  # ingest out of key order: the scan must sort
    for ds, X, S in pairs:
        _run(ds, f"DEFINE TABLE item; DEFINE INDEX iemb ON item FIELDS emb {request.param} "
                 "DIMENSION 64 DIST EUCLIDEAN; DEFINE MODEL ml::scorer<1>; DEFINE MODEL ml::mlp<1>")
        for lo in range(0, 4096, 1024):
            rows = [{"id": int(i), "emb": corpus[i].tolist(), "n": int(i)}
                    for i in order[lo:lo + 1024]]
            _run(ds, "INSERT INTO item $rows RETURN NONE", {"rows": rows})
        X.import_model(ds, S.owner(), "scorer", "1", scorer)
        X.import_model(ds, S.owner(), "mlp", "1", mlp)
    yield pairs[0][0], pairs[1][0], corpus
    for ds, _, _ in pairs:
        ds.close()


def _same(ref_rows, port_rows, atol=ATOL):
    assert len(ref_rows) == len(port_rows)
    if ref_rows and isinstance(ref_rows[0], dict):
        assert [r["id"].id for r in ref_rows] == [p["id"].id for p in port_rows]
        ref_rows, port_rows = [r["s"] for r in ref_rows], [p["s"] for p in port_rows]
    np.testing.assert_allclose(np.asarray(port_rows, np.float64),
                               np.asarray(ref_rows, np.float64), rtol=RTOL, atol=atol)


@pytest.mark.parametrize("model,atol", [("scorer", ATOL), ("mlp", SOFTMAX_ATOL)])
def test_columnar_scan_matches_reference(loaded, model, atol):
    """Bench config 5's statement: one forward over the whole mirror, in
    table key order, in both packages."""
    ref, port, corpus = loaded
    sql = f"SELECT VALUE ml::{model}<1>(emb) FROM item"
    want, got = _run(ref, sql), _run(port, sql)
    _same(want, got, atol)
    cms = [ds._ml_cache[("test", "test", model, "1")] for ds in (ref, port)]
    d0 = [cm.dispatches for cm in cms]
    _same(_run(ref, sql), _run(port, sql), atol)
    assert [cm.dispatches - d for cm, d in zip(cms, d0)] == [1, 1]  # one forward a scan
    if model == "scorer":
        w = cms[1].spec["layers"][0]["w"].astype(np.float64)
        np.testing.assert_allclose(got, (corpus.astype(np.float64) @ w)[:, 0], rtol=RTOL,
                                   atol=ATOL)


def test_row_path_with_where_matches_reference(loaded):
    """2,000 rows pass the WHERE: one batched forward above the 1024-row
    threshold (the reference's jit, the port's device forward)."""
    ref, port, _ = loaded
    sql = "SELECT id, ml::scorer<1>(emb) AS s FROM item WHERE n < 2000"
    want, got = _run(ref, sql), _run(port, sql)
    assert len(got) == 2000
    _same(want, got)


def test_return_of_a_2000_row_batch_matches_reference(loaded):
    ref, port, corpus = loaded
    sql = f"RETURN ml::scorer<1>({json.dumps(corpus[:2000].tolist())})"
    _same(_run(ref, sql), _run(port, sql))


def test_config5_repro_on_eight_rows_matches_reference():
    """The statement that failed before K10 was ported, on 8 rows under
    MTREE with a linear 4 -> 1 model."""
    rng = np.random.default_rng(0)
    rows = [{"id": i, "emb": rng.standard_normal(4).astype(np.float32).tolist()} for i in range(8)]
    spec = {"format": "linear", "layers": [
        {"w": rng.standard_normal((4, 1)).tolist(), "b": [0.5], "activation": None}]}
    outs = []
    for ds, X, S in ((RDatastore("memory"), RX, RSession),
                     (PDatastore("memory", device="cpu"), PX, PSession)):
        try:
            _run(ds, "DEFINE TABLE item; DEFINE INDEX im ON item FIELDS emb MTREE DIMENSION 4 "
                     "DIST EUCLIDEAN; DEFINE MODEL ml::scorer<1>")
            _run(ds, "INSERT INTO item $rows RETURN NONE", {"rows": rows})
            X.import_model(ds, S.owner(), "scorer", "1", spec)
            outs.append(_run(ds, "SELECT VALUE ml::scorer<1>(emb) FROM item"))
        finally:
            ds.close()
    assert len(outs[1]) == 8
    _same(*outs)


def test_packed_vector_arguments_score_as_the_lists_they_hold():
    """INSERT keeps a numpy-valued field as a packed vector (bench.py's
    vec_rows ingests config 2's items so). The reference's ml:: argument
    check rejects it on the row path; the port scores it as the list it
    holds, equal to the reference's answer for that list."""
    rng = np.random.default_rng(6)
    vecs = rng.standard_normal((5, 4)).astype(np.float32)
    spec = {"format": "linear", "layers": [
        {"w": rng.standard_normal((4, 1)).tolist(), "b": [0.25], "activation": None}]}
    rows = [{"id": i, "emb": vecs[i], "l": vecs[i].tolist()} for i in range(5)]
    outs = []
    for ds, X, S in ((RDatastore("memory"), RX, RSession),
                     (PDatastore("memory", device="cpu"), PX, PSession)):
        try:
            _run(ds, "DEFINE MODEL ml::m<1>; INSERT INTO t $rows RETURN NONE", {"rows": rows})
            X.import_model(ds, S.owner(), "m", "1", spec)
            outs.append([ds.execute(f"SELECT id, ml::m<1>({f}) AS s FROM t")[-1]
                         for f in ("emb", "l")])
        finally:
            ds.close()
    (ref_packed, ref_list), (port_packed, port_list) = outs
    assert ref_packed["status"] == "ERR" and "number array" in ref_packed["result"]
    assert port_packed["status"] == port_list["status"] == ref_list["status"] == "OK"
    assert port_packed["result"] == port_list["result"]
    assert [(r["id"].id, r["s"]) for r in port_list["result"]] == \
        [(r["id"].id, r["s"]) for r in ref_list["result"]]


# ------------------------------------------------------------ the reference's own cases
# tests/test_ml.py, tests/test_ml_batch.py and the non-fixture cases of
# tests/test_surml.py, run against the port (test_ml_http_roundtrip,
# test_ml_sdk_and_cli and test_surml_http_import need net/, sdk/ and cli.py,
# which the port does not have yet)
LINEAR = {
    "name": "house",
    "version": "1.0.0",
    "format": "linear",
    "layers": [{"w": [[2.0], [3.0]], "b": [10.0], "activation": None}],
}
LINEAR_B = {
    "format": "linear",
    "layers": [{"w": [[2.0], [3.0]], "b": [10.0], "activation": None}],
}


@pytest.fixture()
def pds():
    ds = PDatastore("memory", device="cpu")
    yield ds
    ds.close()


@pytest.fixture()
def ml_ds(pds):
    pds.execute("DEFINE MODEL ml::house<1.0.0>;")
    PX.import_model(pds, PSession.owner(), "house", "1.0.0", LINEAR)
    return pds


def test_ml_single_row(ml_ds):
    out = ml_ds.execute("RETURN ml::house<1.0.0>([1.0, 2.0]);")
    assert out[0]["result"] == pytest.approx(2.0 + 6.0 + 10.0)


def test_ml_batched_rows(ml_ds):
    out = ml_ds.execute("RETURN ml::house<1.0.0>([[1.0, 2.0], [0.0, 0.0], [2.0, 1.0]]);")
    assert out[0]["result"] == pytest.approx([18.0, 10.0, 17.0])


def test_ml_over_table_scan(ml_ds):
    ml_ds.execute(";".join(f"CREATE h:{i} SET f = [{i}.0, {i}.0]" for i in range(8)))
    out = ml_ds.execute("RETURN ml::house<1.0.0>((SELECT VALUE f FROM h ORDER BY id));")
    assert out[0]["result"] == pytest.approx([10.0 + 5.0 * i for i in range(8)])


def test_ml_mlp_matches_numpy(pds):
    rng = np.random.default_rng(4)
    w1, b1 = rng.normal(size=(4, 8)), rng.normal(size=8)
    w2, b2 = rng.normal(size=(8, 1)), rng.normal(size=1)
    spec = {
        "format": "mlp",
        "layers": [
            {"w": w1.tolist(), "b": b1.tolist(), "activation": "relu"},
            {"w": w2.tolist(), "b": b2.tolist(), "activation": None},
        ],
    }
    pds.execute("DEFINE MODEL ml::net<2>;")
    PX.import_model(pds, PSession.owner(), "net", "2", spec)
    x = rng.normal(size=(5, 4))
    want = np.maximum(x @ w1 + b1, 0) @ w2 + b2
    out = pds.execute(f"RETURN ml::net<2>({json.dumps(x.tolist())});")
    assert out[0]["result"] == pytest.approx(want[:, 0].tolist(), rel=1e-3, abs=1e-3)


def test_ml_missing_weights_errors(pds):
    pds.execute("DEFINE MODEL ml::empty<1>;")
    out = pds.execute("RETURN ml::empty<1>([1.0]);")
    assert out[0]["status"] == "ERR"
    assert "no stored weights" in out[0]["result"]


def test_ml_remove_model(ml_ds):
    ml_ds.execute("REMOVE MODEL ml::house<1.0.0>;")
    out = ml_ds.execute("RETURN ml::house<1.0.0>([1.0, 2.0]);")
    assert out[0]["status"] == "ERR"


def test_ml_remove_model_gcs_blob(ml_ds):
    from surrealdb_tpu_torch import key as keys
    from surrealdb_tpu_torch.key.encode import prefix_end

    pre = keys.blob_prefix("test", "test")
    txn = ml_ds.transaction(False)
    try:
        assert txn.scan(pre, prefix_end(pre))
    finally:
        txn.cancel()
    ml_ds.execute("REMOVE MODEL ml::house<1.0.0>;")
    txn = ml_ds.transaction(False)
    try:
        assert not txn.scan(pre, prefix_end(pre))
    finally:
        txn.cancel()


def test_ml_remove_database_clears_compiled_cache(ml_ds):
    assert ml_ds.execute("RETURN ml::house<1.0.0>([1.0, 2.0]);")[0]["status"] == "OK"
    ml_ds.execute("REMOVE DATABASE test;")
    out = ml_ds.execute("RETURN ml::house<1.0.0>([1.0, 2.0]);")
    assert out[0]["status"] == "ERR"
    assert "does not exist" in out[0]["result"]


def test_ml_remove_namespace_clears_compiled_cache(ml_ds):
    assert ml_ds.execute("RETURN ml::house<1.0.0>([1.0, 2.0]);")[0]["status"] == "OK"
    assert ml_ds._ml_cache
    ml_ds.execute("REMOVE NAMESPACE test;")
    assert not ml_ds._ml_cache
    assert ml_ds.execute("RETURN ml::house<1.0.0>([1.0, 2.0]);")[0]["status"] == "ERR"


def _import(ds, name="score", version="1", perms_sql=""):
    ds.execute(f"DEFINE MODEL ml::{name}<{version}> {perms_sql};")
    PX.import_model(ds, PSession.owner(), name, version, LINEAR_B)


def _compiled_model(ds, name="score", version="1"):
    return ds._ml_cache[("test", "test", name, version)]


def test_select_scan_is_one_dispatch(pds):
    _import(pds)
    pds.execute(";".join(f"CREATE h:{i} SET f = [{i}.0, {i}.0]" for i in range(20)))
    rows = pds.execute("SELECT id, ml::score<1>(f) AS s FROM h ORDER BY id;")[0]["result"]
    assert len(rows) == 20
    assert rows[3]["s"] == pytest.approx(10.0 + 5.0 * 3)
    assert _compiled_model(pds).dispatches == 1


def test_batched_matches_per_row_values(pds):
    _import(pds)
    pds.execute(";".join(f"CREATE h:{i} SET f = [{i}.0, {2*i}.0]" for i in range(7)))
    out = pds.execute("SELECT VALUE ml::score<1>(f) FROM h ORDER BY id;")
    assert out[0]["result"] == pytest.approx([10.0 + 2.0 * i + 6.0 * i for i in range(7)])


def test_batched_with_where_and_limit(pds):
    _import(pds)
    pds.execute(";".join(f"CREATE h:{i} SET f = [{i}.0, {i}.0], n = {i}" for i in range(10)))
    rows = pds.execute(
        "SELECT id, ml::score<1>(f) AS s FROM h WHERE n >= 4 ORDER BY id LIMIT 3;"
    )[0]["result"]
    assert [r["s"] for r in rows] == pytest.approx([30.0, 35.0, 40.0])
    assert _compiled_model(pds).dispatches == 1


def test_rows_missing_field_fall_back(pds):
    _import(pds)
    pds.execute("CREATE h:1 SET f = [1.0, 1.0]; CREATE h:2 SET g = 1;")
    rows = pds.execute(
        "SELECT id, IF f THEN ml::score<1>(f) ELSE 0 END AS s FROM h ORDER BY id;"
    )[0]["result"]
    assert rows[0]["s"] == pytest.approx(15.0)
    assert rows[1]["s"] == 0
    assert _compiled_model(pds).dispatches == 1


def test_nested_subquery_model_calls(pds):
    _import(pds)
    pds.execute(";".join(f"CREATE h:{i} SET f = [{i}.0, {i}.0]" for i in range(4)))
    pds.execute("CREATE g:1 SET f = [1.0, 1.0];")
    rows = pds.execute(
        "SELECT ml::score<1>(f) AS a, "
        "(SELECT VALUE ml::score<1>(f) FROM g) AS b FROM h ORDER BY id;"
    )[0]["result"]
    assert [r["a"] for r in rows] == pytest.approx([10.0, 15.0, 20.0, 25.0])
    assert all(r["b"] == pytest.approx([15.0]) for r in rows)


def test_model_permissions_none_denies_guest(pds):
    _import(pds, perms_sql="PERMISSIONS NONE")
    pds.execute("DEFINE TABLE pub PERMISSIONS FULL; CREATE pub:1 SET f = [1.0, 2.0];")
    out = pds.execute("SELECT ml::score<1>(f) AS s FROM pub;", PSession.anonymous("test", "test"))
    assert out[0]["status"] == "ERR"
    assert "not allow execution" in out[0]["result"]
    out = pds.execute("SELECT ml::score<1>(f) AS s FROM pub;")
    assert out[0]["result"][0]["s"] == pytest.approx(18.0)


def test_model_permissions_full_admits_guest(pds):
    _import(pds, perms_sql="PERMISSIONS FULL")
    pds.execute("DEFINE TABLE pub PERMISSIONS FULL; CREATE pub:1 SET f = [1.0, 2.0];")
    out = pds.execute("SELECT ml::score<1>(f) AS s FROM pub;", PSession.anonymous("test", "test"))
    assert out[0]["status"] == "OK"
    assert out[0]["result"][0]["s"] == pytest.approx(18.0)


def test_function_permissions_none_denies_guest(pds):
    pds.execute("DEFINE FUNCTION fn::sq($x: number) { RETURN $x * $x } PERMISSIONS NONE;")
    pds.execute("DEFINE TABLE pub PERMISSIONS FULL; CREATE pub:1 SET v = 3;")
    out = pds.execute("SELECT fn::sq(v) AS s FROM pub;", PSession.anonymous("test", "test"))
    assert out[0]["status"] == "ERR"
    assert "does not allow execution" in out[0]["result"]
    assert pds.execute("RETURN fn::sq(3);")[0]["result"] == 9


def test_columnar_scan_over_vector_mirror(pds):
    _import(pds)
    pds.execute("DEFINE INDEX iv ON h FIELDS f HNSW DIMENSION 2;")
    pds.execute(";".join(f"CREATE h:{i} SET f = [{i}.0, {2*i}.0]" for i in range(12)))
    vals = sorted(pds.execute("SELECT VALUE ml::score<1>(f) FROM h;")[-1]["result"])
    assert vals == sorted(10.0 + 2.0 * i + 6.0 * i for i in range(12))
    cm = _compiled_model(pds)
    assert cm.dispatches == 1
    out = pds.execute("SELECT VALUE ml::score<1>(f) FROM h WHERE f[0] > 5;")
    assert len(out[-1]["result"]) == 6
    assert cm.dispatches == 2


def test_columnar_scan_skipped_when_mirror_incomplete(pds):
    _import(pds)
    pds.execute("DEFINE INDEX iv ON h FIELDS f HNSW DIMENSION 2;")
    pds.execute("CREATE h:1 SET f = [1.0, 1.0]; CREATE h:2 SET g = 1;")
    assert pds.execute("SELECT VALUE ml::score<1>(f) FROM h;")[-1]["status"] == "ERR"


def test_columnar_scan_skipped_inside_write_txn(pds):
    _import(pds)
    pds.execute("DEFINE INDEX iv ON h FIELDS f HNSW DIMENSION 2;")
    pds.execute("CREATE h:1 SET f = [1.0, 1.0];")
    out = pds.execute(
        "BEGIN; CREATE h:2 SET f = [2.0, 2.0]; SELECT VALUE ml::score<1>(f) FROM h; COMMIT;"
    )
    assert len(out[-1]["result"]) == 2


def test_columnar_scan_key_order_after_mixed_inserts(pds):
    _import(pds)
    pds.execute("DEFINE INDEX iv ON h FIELDS f HNSW DIMENSION 2;")
    pds.execute(";".join(f"CREATE h:{i} SET f = [{i}.0, {i}.0]" for i in (5, 6, 7)))
    pds.execute("SELECT VALUE ml::score<1>(f) FROM h;")
    pds.execute("CREATE h:1 SET f = [1.0, 1.0];")
    fast = pds.execute("SELECT VALUE ml::score<1>(f) FROM h;")[-1]["result"]
    slow = pds.execute("SELECT VALUE ml::score<1>(f) FROM h WHERE f[0] >= 0;")[-1]["result"]
    assert fast == slow


def test_onnx_mini_forward_matches_numpy():
    w, b = [[1.0, -1.0], [0.5, 2.0]], [0.25, -0.25]
    g = POnnxGraph(_mini_onnx_linear(w, b))
    x = np.array([[3.0, 4.0], [0.0, 1.0]], np.float32)
    np.testing.assert_allclose(g.build_forward(np)(x), x @ np.asarray(w, np.float32) + b,
                               atol=1e-6)


def test_onnx_mini_torch_forward():
    g = POnnxGraph(_mini_onnx_linear([[2.0], [3.0]], [1.0]))
    out = g.lower("cpu")(torch.tensor([[1.0, 1.0]]))
    np.testing.assert_allclose(out.numpy(), [[6.0]], atol=1e-6)


def test_normalisers_roundtrip():
    assert normalise(2120.0, ("z_score", [2120.0, 718.0529])) == 0.0
    assert denormalise(0.0, ("z_score", [367000.0, 105550.94])) == 367000.0
    assert normalise(5.0, ("linear_scaling", [0.0, 10.0])) == 0.5
    assert denormalise(0.5, ("linear_scaling", [0.0, 10.0])) == 5.0


def test_surml_rejects_garbage():
    from surrealdb_tpu_torch.err import SurrealError

    with pytest.raises(SurrealError):
        parse_surml(b"xy")
    with pytest.raises(SurrealError):
        parse_surml(struct.pack(">I", 10_000) + b"short")
