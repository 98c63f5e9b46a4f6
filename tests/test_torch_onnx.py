"""The ONNX / .surml model forward of the PyTorch port (K16:
surrealdb_tpu_torch/ml/onnx_mini.py OnnxGraph.lower, the plan over
ml/model.py's `linear_act` with an epilogue, `ewise`, `reduce_axis` and
`row_softmax`) held against the JAX reference on the same seeded inputs:
the reference's `jax.jit(OnnxGraph.build_forward(jnp))` on the CPU (its
eager jnp forward for a Reshape graph, which its jit cannot trace), the
port's plan on CPU tensors, i.e. the plain PyTorch versions of its kernels.
Graphs A and B are chip_smoke.py's (`onnx_mlp`, `onnx_scaled_head`) at
small widths: 12 features, hidden 8.

Tolerances: rtol 1e-5, atol 1e-5 for a forward (f32 products and sums in
another order than XLA's), softmax outputs atol 1e-6; a single op against
jnp: the same value for add, sub, mul, div, max / min (Clip), neg, relu,
leaky relu (NaN where jnp gives NaN, the sign of a zero too), rtol 2e-6
for exp, sqrt, pow, tanh, sigmoid (the two libraries' f32 functions), and
for elu where alpha (exp(x) - 1) cancels near 0 atol 2e-6 x alpha;
reductions rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as C
from surrealdb_tpu.dbs.session import Session as RSession
from surrealdb_tpu.kvs.ds import Datastore as RDatastore
from surrealdb_tpu.ml import exec as RX
from surrealdb_tpu.ml import model as RM
from surrealdb_tpu.ml.onnx_mini import OnnxGraph as ROnnxGraph
from surrealdb_tpu_torch.dbs.session import Session as PSession
from surrealdb_tpu_torch.err import SurrealError
from surrealdb_tpu_torch.kvs.ds import Datastore as PDatastore
from surrealdb_tpu_torch.ml import exec as PX
from surrealdb_tpu_torch.ml import model as PM
from surrealdb_tpu_torch.ml.onnx_mini import OnnxGraph as POnnxGraph
from test_torch_ml import _GRAPHS, _graph

RTOL, ATOL, SOFTMAX_ATOL = 1e-5, 1e-5, 1e-6
DIM, HIDDEN = 12, 8
CPU = torch.device("cpu")


def _graph_a():
    rng = np.random.default_rng(5)
    return C.onnx_mlp(C.ml_layers(rng, (DIM, HIDDEN, 10), ("relu", "softmax")))


def _graph_b():
    return C.onnx_scaled_head(np.random.default_rng(6), DIM, HIDDEN)


def _raw(name):
    if name == "onnx_mlp":
        return _graph_a()
    if name == "onnx_scaled_head":
        return _graph_b()
    return _graph(name)


def _in_dim(name):
    return 6 if name in _GRAPHS else DIM


def _reference(raw, x, eager=False):
    fwd = ROnnxGraph(raw).build_forward(jnp)
    return np.asarray((fwd if eager else jax.jit(fwd))(jnp.asarray(x)))


ALL = _GRAPHS + ["onnx_mlp", "onnx_scaled_head"]


@pytest.mark.parametrize("name", ALL)
def test_plan_matches_reference_jit(name):
    raw = _raw(name)
    x = (np.random.default_rng(len(name)).standard_normal((64, _in_dim(name))) * 2) \
        .astype(np.float32)
    want = _reference(raw, x, eager=name == "reshape_reducesum")
    got = POnnxGraph(raw).lower("cpu")(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=SOFTMAX_ATOL if "softmax" in name or name == "onnx_mlp"
                               else ATOL)


@pytest.mark.parametrize("name", ALL)
def test_plan_fed_bf16_equals_the_plan_fed_its_upcast(name):
    """The first launches read a bf16 input as it is: the same bits as the
    plan over the f32 upcast of the same values."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((40, _in_dim(name)))
                         .astype(np.float32)).to(torch.bfloat16)
    plan = POnnxGraph(_raw(name)).lower("cpu")
    assert torch.equal(plan(x), plan(x.to(torch.float32)))


def test_plan_launches_of_graphs_a_and_b():
    """Graph A: two products (bias and Relu in the first one's epilogue)
    and a softmax. Graph B: the z-score in one ml_ewise, the two products
    with their chains folded in (Add + LeakyRelu; alpha, + 2 C, Elu, Clip,
    Sigmoid), the mean, and the Concat's two copies."""
    a = POnnxGraph(_graph_a()).lower("cpu")
    assert a.kernels == ("ml_linear", "ml_linear", "ml_softmax")
    b = POnnxGraph(_graph_b()).lower("cpu")
    assert b.kernels == ("ml_ewise", "ml_linear", "ml_linear", "ml_reduce", "ml_ewise",
                         "ml_ewise")
    head = b.steps[2]
    assert [i[0] for i in head.ins] == ["mul", "add", "elu", "max", "min", "sigmoid"]
    assert len(head.operands) == 1  # 2 C, rounded once on the host


def _one_node(op, attrs=None, second=None, third=None, n=DIM):
    """A one-node graph over x [M, n]: op(x[, second[, third]]) with the
    extra operands as initializers."""
    ins, inits = ["x"], {}
    for name, v in (("s", second), ("t", third)):
        if v is not None:
            ins.append(name)
            inits[name] = np.asarray(v, np.float32)
        elif name == "s" and third is not None:
            ins.append("")
    return C.onnx_model([(op, ins, ["y"], attrs or {})], inits, n)


def _special_x(seed, m=40, n=DIM):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, n)) * 3).astype(np.float32)
    x[0, :6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, -1e-30]
    x[1, :] = -0.0
    x[2, :] = np.linspace(-1e-3, 1e-3, n)  # Elu's cancellation, Sigmoid's middle
    x[3, :] = np.linspace(-100, 100, n)  # exp past f32's range both ways
    return x


def _second(seed, n=DIM):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal(n).astype(np.float32)
    s[:4] = [0.0, -0.0, np.nan, np.inf]  # division by zero both ways, NaN, inf
    return s


_EXACT = {"Add", "Sub", "Mul", "Div", "Neg", "Relu", "LeakyRelu", "Clip"}
_OPS = [("Add", None), ("Sub", None), ("Mul", None), ("Div", None), ("Pow", None),
        ("Neg", None), ("Exp", None), ("Sqrt", None), ("Relu", None),
        ("LeakyRelu", {"alpha": 0.1}), ("Elu", {"alpha": 0.7}), ("Sigmoid", None),
        ("Tanh", None), ("Clip", None)]


def _assert_op_close(got, want, op, x, alpha=1.0):
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), op
    if op in _EXACT:
        np.testing.assert_array_equal(got, want, err_msg=op)
        assert np.array_equal(np.signbit(got[~nan]), np.signbit(want[~nan])), op
        return
    # XLA's CPU flushes a subnormal result to zero: 1e-37
    atol = 2e-6 * abs(alpha) if op == "Elu" else 1e-37
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=atol, err_msg=op)


@pytest.mark.parametrize("op,attrs", _OPS, ids=[o for o, _ in _OPS])
def test_each_op_code_matches_jnp_on_non_finite_rows(op, attrs):
    """One node a graph over rows with NaN, +-inf, -0 and values near 0;
    a binary op's second operand holds 0, -0, NaN and inf (division by
    zero); Pow's base is negative against integer and fractional
    exponents; Sqrt meets negatives. Against the eager jnp forward: under
    jit XLA divides by a constant through its reciprocal, one rounding
    more than the division the reference's graph writes."""
    x = _special_x(len(op))
    if op == "Pow":
        second = np.array([2.0, 3.0, 0.5, -1.0, 0.0, -2.0, 1.5, 4.0, -0.5, 1.0, 2.5, -3.0],
                          np.float32)
    elif op in ("Add", "Sub", "Mul", "Div"):
        second = _second(len(op))
    else:
        second = None
    raw = _one_node(op, attrs, second) if op != "Clip" else \
        _one_node("Clip", None, -0.5, 2.0)
    want = _reference(raw, x, eager=True)
    got = POnnxGraph(raw).lower("cpu")(torch.from_numpy(x)).numpy()
    _assert_op_close(got, want, op, x, (attrs or {}).get("alpha", 1.0))


@pytest.mark.parametrize("bound", ["lo", "hi", "both"])
def test_clip_with_a_nan_bound_is_all_nan_as_jnp(bound):
    x = _special_x(9)
    lo = np.nan if bound in ("lo", "both") else -1.0
    hi = np.nan if bound in ("hi", "both") else 1.0
    raw = _one_node("Clip", None, lo, hi)
    want = _reference(raw, x)
    got = POnnxGraph(raw).lower("cpu")(torch.from_numpy(x)).numpy()
    assert np.isnan(want).all() and np.isnan(got).all()


def test_clip_bounds_from_attributes_and_one_sided():
    """Clip's opset-6 attributes, and an input bound with the other absent."""
    x = _special_x(10)
    for raw in (C.onnx_model([("Clip", ["x"], ["y"], {"min": -0.25, "max": 0.5})], {}, DIM),
                _one_node("Clip", None, None, np.float32(0.5)),
                _one_node("Clip", None, np.float32(-0.0))):
        _assert_op_close(POnnxGraph(raw).lower("cpu")(torch.from_numpy(x)).numpy(),
                         _reference(raw, x, eager=True), "Clip", x)


@pytest.mark.parametrize("shape", ["per_column", "row_1xN", "per_row_Mx1", "scalar",
                                   "scalar_1x1"])
@pytest.mark.parametrize("op", ["Add", "Sub", "Mul", "Div"])
def test_broadcast_shapes_match_jnp(op, shape):
    """The second operand [N], [1, N], [M, 1] (a ReduceMean with keepdims,
    computed), a 0-d scalar and a [1, 1] one, on either side of the op;
    values in [0.5, 2) (the non-finite ones are the op tests')."""
    rng = np.random.default_rng(len(op) + len(shape))
    x = rng.uniform(0.5, 2.0, (40, DIM)).astype(np.float32)
    consts = {"per_column": rng.uniform(0.5, 2.0, DIM), "row_1xN": rng.uniform(0.5, 2.0, (1, DIM)),
              "scalar": np.array(-1.75), "scalar_1x1": np.array([[0.375]])}
    for flip in (False, True):
        if shape == "per_row_Mx1":
            nodes = [("ReduceMean", ["x"], ["m"], {"axes": [1], "keepdims": 1}),
                     (op, ["m", "x"] if flip else ["x", "m"], ["y"], {})]
            inits = {}
        else:
            nodes = [(op, ["c", "x"] if flip else ["x", "c"], ["y"], {})]
            inits = {"c": np.asarray(consts[shape], np.float32)}
        raw = C.onnx_model(nodes, inits, DIM)
        want = _reference(raw, x)
        got = POnnxGraph(raw).lower("cpu")(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("keepdims", [0, 1])
@pytest.mark.parametrize("axes", [[1], [0], [0, 1], None], ids=["1", "0", "0_1", "all"])
@pytest.mark.parametrize("op", ["ReduceSum", "ReduceMean"])
def test_reductions_match_jnp(op, axes, keepdims):
    x = (np.random.default_rng(7).standard_normal((300, DIM)) * 2).astype(np.float32)
    attrs = {"keepdims": keepdims}
    if axes is not None:
        attrs["axes"] = axes
    raw = C.onnx_model([(op, ["x"], ["y"], attrs)], {}, DIM)
    want = _reference(raw, x)
    plan = POnnxGraph(raw).lower("cpu")
    assert plan.kernels == ("ml_reduce",)
    got = plan(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_non_adjacent_axes_take_a_launch_each():
    """ReduceMean over axes 0 and 2 of [M, 3, 4] (a Reshape: the eager jnp
    reference): two ml_reduce launches, the division by the whole count in
    the last."""
    nodes = [("Reshape", ["x", "s"], ["r"], {}),
             ("ReduceMean", ["r"], ["y"], {"axes": [0, 2], "keepdims": 0})]
    raw = C.onnx_model(nodes, {"s": np.array([0, 3, 4], np.int64)}, DIM)
    x = np.random.default_rng(8).standard_normal((50, DIM)).astype(np.float32)
    plan = POnnxGraph(raw).lower("cpu")
    assert plan.kernels == ("ml_reduce", "ml_reduce")
    np.testing.assert_allclose(plan(torch.from_numpy(x)).numpy(), _reference(raw, x, True)
                               .reshape(-1, 1), rtol=RTOL, atol=1e-6)


def test_softmax_on_axis_0_and_on_the_bf16_input():
    """Softmax over axis 0 moves the axis last and back (two ml_ewise
    copies); a Softmax straight over the input copies it to f32 first."""
    plan = POnnxGraph(_graph("softmax_axis0")).lower("cpu")
    assert plan.kernels == ("ml_linear", "ml_ewise", "ml_softmax", "ml_ewise")
    raw = C.onnx_model([("Softmax", ["x"], ["y"], {"axis": 1})], {}, DIM)
    x = np.random.default_rng(9).standard_normal((30, DIM)).astype(np.float32)
    plan = POnnxGraph(raw).lower("cpu")
    assert plan.kernels == ("ml_ewise", "ml_softmax")
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_allclose(plan(xb).numpy(), _reference(raw, xb.float().numpy()),
                               rtol=RTOL, atol=SOFTMAX_ATOL)


def test_an_unsupported_operator_raises_surreal_error():
    raw = C.onnx_model([("Floor", ["x"], ["y"], {})], {}, DIM)
    with pytest.raises(SurrealError, match="unsupported ONNX operator 'Floor'"):
        POnnxGraph(raw).lower("cpu")
    with pytest.raises(Exception, match="unsupported ONNX operator 'Floor'"):
        ROnnxGraph(raw).build_forward(jnp)(jnp.zeros((2, DIM)))


def test_constant_only_nodes_run_once_on_the_host():
    """Nodes of constants alone (here Mul of two initializers) are folded
    at lowering: the forward is one product with the result as its bias."""
    nodes = [("Mul", ["a", "b"], ["ab"], {}), ("MatMul", ["x", "w"], ["mm"], {}),
             ("Add", ["mm", "ab"], ["y"], {})]
    rng = np.random.default_rng(11)
    inits = {"a": rng.standard_normal(4).astype(np.float32),
             "b": rng.standard_normal(4).astype(np.float32),
             "w": rng.standard_normal((DIM, 4)).astype(np.float32)}
    raw = C.onnx_model(nodes, inits, DIM)
    plan = POnnxGraph(raw).lower("cpu")
    assert plan.kernels == ("ml_linear",)
    x = rng.standard_normal((20, DIM)).astype(np.float32)
    np.testing.assert_allclose(plan(torch.from_numpy(x)).numpy(), _reference(raw, x),
                               rtol=RTOL, atol=ATOL)


def test_matmul_by_a_stack_of_weights_is_a_launch_a_weight():
    """numpy's matmul of x [M, 12] by w [2, 12, 4] (a bias and Relu folded
    into each launch's epilogue), then of that [2, M, 4] by a computed
    stack [2, 4, 3] (a Sub of two initializers is folded on the host: a
    constant), reduced over the stack: the reference's jit against the
    plan, one ml_linear a weight."""
    rng = np.random.default_rng(14)
    inits = {"w": rng.standard_normal((2, DIM, 4)).astype(np.float32),
             "b": rng.standard_normal(4).astype(np.float32),
             "v": rng.standard_normal((2, 4, 3)).astype(np.float32),
             "u": rng.standard_normal((2, 4, 3)).astype(np.float32)}
    nodes = [("MatMul", ["x", "w"], ["h"], {}), ("Add", ["h", "b"], ["hb"], {}),
             ("Relu", ["hb"], ["r"], {}), ("Sub", ["v", "u"], ["vu"], {}),
             ("MatMul", ["r", "vu"], ["z"], {}),
             ("ReduceMean", ["z"], ["y"], {"axes": [0], "keepdims": 0})]
    raw = C.onnx_model(nodes, inits, DIM)
    plan = POnnxGraph(raw).lower("cpu")
    assert plan.kernels == ("ml_linear",) * 4 + ("ml_reduce",)
    x = rng.standard_normal((50, DIM)).astype(np.float32)
    got = plan(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _reference(raw, x), rtol=RTOL, atol=ATOL)
    bad = C.onnx_model([("MatMul", ["x", "w"], ["y"], {})],
                       {"w": np.zeros((2, 2, DIM, 4), np.float32)}, DIM)
    with pytest.raises(SurrealError, match="4-d second operand is not lowered"):
        POnnxGraph(bad).lower("cpu")


@pytest.mark.parametrize("name", ["onnx_mlp", "onnx_scaled_head"])
def test_model_from_reference_matches_the_reference_forward(name):
    """Graphs A and B as ONNX specs at m = 3,000 (above the device
    threshold): the reference's jitted CompiledModel.forward against the
    port's plan."""
    spec = RM.validate_spec({"format": "onnx", "onnx": _raw(name)})
    ref = RM.CompiledModel(spec)
    port = PM.model_from_reference(spec, CPU)
    assert (port.in_dim, port.out_dim) == (ref.in_dim, ref.out_dim)
    x = np.random.default_rng(3000).standard_normal((3000, DIM)).astype(np.float32)
    np.testing.assert_allclose(port.forward(x, CPU), ref.forward(x), rtol=RTOL,
                               atol=SOFTMAX_ATOL if name == "onnx_mlp" else ATOL)


def _run(ds, sql, vars=None):
    out = ds.execute(sql, vars=vars or {})
    assert all(r["status"] == "OK" for r in out), out
    return out[-1]["result"]


def test_surml_graph_b_scan_matches_reference_in_key_order():
    """Graph B in a .surml file, imported by import_surml into both
    packages (the reference on JAX's CPU, the port with device="cpu"), then
    `SELECT VALUE ml::head<1>(emb) FROM item` over 2,048 rows with an
    MTREE index (one forward over the mirror, in key order)."""
    raw = C.surml_file(_graph_b(), "head", "1")
    rng = np.random.default_rng(12)
    corpus = rng.standard_normal((2048, DIM)).astype(np.float32)
    order = rng.permutation(2048)
    outs = []
    for ds, X, S in ((RDatastore("memory"), RX, RSession),
                     (PDatastore("memory", device="cpu"), PX, PSession)):
        try:
            _run(ds, f"DEFINE TABLE item; DEFINE INDEX iemb ON item FIELDS emb MTREE "
                     f"DIMENSION {DIM} DIST EUCLIDEAN; DEFINE MODEL ml::head<1>")
            rows = [{"id": int(i), "emb": corpus[i].tolist()} for i in order]
            _run(ds, "INSERT INTO item $rows RETURN NONE", {"rows": rows})
            entry = X.import_surml(ds, S.owner(), raw)
            assert (entry["name"], entry["version"], entry["in_dim"], entry["out_dim"]) == \
                ("head", "1", DIM, 9)
            outs.append(_run(ds, "SELECT VALUE ml::head<1>(emb) FROM item"))
            assert ds._ml_cache[("test", "test", "head", "1")].dispatches == 1
        finally:
            ds.close()
    want, got = (np.asarray(o, np.float64) for o in outs)
    assert got.shape == want.shape == (2048, 9)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    f64 = POnnxGraph(_graph_b()).build_forward(np)(corpus.astype(np.float64))
    np.testing.assert_allclose(got, f64, rtol=RTOL, atol=ATOL)  # ids 0..2047: key order


def test_ewise_and_reduce_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions and count no
    launch."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((9, 5)).astype(np.float32))
    prog = PM.Program([("exp", 4, 0, 0, 0.0), ("mul", 4, 4, 1, 0.0)], 4)
    before = [c.launches for c in PM.KERNELS]
    out = PM.ewise(prog, [x, x[0]], torch.empty(9, 5))
    assert torch.equal(out, PM.ewise_plain(prog, [x, x[0]], torch.empty(9, 5)))
    assert torch.equal(PM.reduce_axis(x, [0], True, True),
                       PM.reduce_axis_plain(x, [0], True, True))
    assert [c.launches for c in PM.KERNELS] == before
