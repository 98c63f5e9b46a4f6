"""The CUDA kernels' logic (surrealdb_tpu_torch/csrc/knn.cu, graph.cu,
bm25.cu, ml.cu, onnx.cu and mesh.cu, with the headers they include, and ivf.cu's
rerank as K13 shares it), run on the CPU under the emulation header
csrc/emu/cuda_emu.h and held against the plain PyTorch versions. The IVF
and graph kernels K3-K7 have their cases in
tests/test_torch_kernel_emulation_ivf_graph.py, which builds its library
with this file's `_build_emu`.

The source is compiled with the host C++ compiler: CUDA qualifiers become
no-ops, `__shared__` arrays become function statics (blocks run one after
another), each CUDA thread is an OS thread, and __syncthreads and the warp
intrinsics are barriers. This checks indexing, barriers, tie order and
masking at small shapes — not speed, and not what only the card can show
(it builds, launches and agrees there: chip_smoke.py). Skipped where there
is no C++20 compiler. One build of mesh.cu runs in the header's concurrent
mode (a launch's blocks at once, each with its own shared memory, the later
ones ahead), so K15's look-back really waits on its predecessors there.

Tolerances: K1 distances rtol 1e-5, atol 1e-4 (f32 sums in another order);
K2's select exact, since both sides select from the same distances; the
fused K2 exact against K1's distances selected in the plain order (one
distance core), and within K1's tolerance of the plain search, ids equal
up to ties at the k-th distance; the dense graph count (K8) exact: integer
counts; BM25 (K9) rtol 1e-5, atol 1e-6 (both sides round the same f32
steps in the same order, only log1pf may differ), tied rows bit-identical,
and its top-k order exact; the ML forward (K10) rtol 1e-5, atol 1e-5 (f32
sums in another order), softmax outputs atol 1e-6; the ONNX plan's kernels
(K16): ml_ewise exact for add, sub, mul, div, max, min, neg, relu, leaky
relu and copies (NaN where the plain version has NaN), at most 2 ulp for
exp, sqrt, pow, tanh, sigmoid and elu (the host's libm against PyTorch's);
ml_reduce within 1e-5 of the sum of |x| (f32 sums in another order);
ml_linear's epilogue rtol 1e-5, atol 1e-5 as K10; the mesh kernels: the
merge, the frontier hop and the dedup exact (ids, order, masks, the index
rules), K12's partial and selected distances rtol 1e-5, atol 1e-4 (f32
sums in another order) with ids equal up to ties at the kk-th, K13's
rerank the same against K3's plain rerank a shard (misses exact; on equal
rows, ids and order exact).
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from surrealdb_tpu_torch.idx import graph_csr as G
from surrealdb_tpu_torch.idx import ivf as IVF
from surrealdb_tpu_torch.ml import model as ML
from surrealdb_tpu_torch.ops import _cuda
from surrealdb_tpu_torch.ops import bm25 as B
from surrealdb_tpu_torch.ops import distances as D
from surrealdb_tpu_torch.parallel import mesh as M

CSRC = _cuda.CSRC


_SMEM_IDS = iter(range(1 << 30))  # numbers the `__shared__` declarations of concurrent builds


def _block_smem(m) -> str:
    """`__shared__ T a[n], b;` as references to the block's own arrays
    (cuda_emu.h's emu_smem, concurrent builds)."""
    decls = [d.strip() for d in m.group(1).split(",")]
    first = re.fullmatch(r"(?:__align__\(\d+\) )?(.*?)\s*(\w+)((?:\[[^\]]*\])*)", decls[0])
    kind, out = first.group(1), []
    for d in [first.group(2) + first.group(3)] + decls[1:]:
        name, dims = re.fullmatch(r"(\w+)((?:\[[^\]]*\])*)", d).groups()
        out.append(f"auto& {name} = emu_smem<{kind}{dims}, {next(_SMEM_IDS)}>();")
    return " ".join(out)


def _translate(src: str, concurrent: bool = False) -> str:
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace("#include <cuda_bf16.h>", "")
    if concurrent:  # every block its own shared memory
        src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(.*?) (\w+)\[\];",
                     r"\1* \2 = emu_dyn_smem<\1>();", src)
        src = re.sub(r"__shared__ ([^;]*);", _block_smem, src)
    # dynamic shared memory: a static array, large enough for the test shapes
    src = re.sub(r"extern __shared__ (.*?) (\w+)\[\];", r"static \1 \2[1 << 18];", src)
    return re.sub(
        r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);",
        lambda m: f"emu_launch({m.group(2)}, [&]{{ {m.group(1)}({m.group(3)}); }});",
        src,
        flags=re.S,
    )


def _build_emu(out, sources, concurrent: bool = False):
    """Compile the sources ({name: CUDA text}) under the emulation header
    into out/libkernels_emu.so and bind the signatures it exports; with
    `concurrent`, in cuda_emu.h's mode that runs a launch's blocks at once."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    cpps = []
    # headers are translated too (knn.cuh launches kernels) and found in
    # `out` before csrc/; a header given in `sources` replaces csrc's
    headers = {f: _source(f) for f in os.listdir(CSRC) if f.endswith(".cuh")}
    headers.update({n: t for n, t in sources.items() if n.endswith(".cuh")})
    for name, text in headers.items():
        (out / name).write_text(_translate(text, concurrent))
    for name, text in sources.items():
        if name.endswith(".cuh"):
            continue
        cpp = out / name.replace(".cu", "_emu.cpp")
        cpp.write_text(_translate(text, concurrent))
        cpps.append(str(cpp))
    so = out / "libkernels_emu.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         # the concurrent mode's inline variables (thread_local there) must
         # not bind to an earlier default build's in the same process
         *(["-DEMU_CONCURRENT", "-fno-gnu-unique"] if concurrent else []),
         "-I", os.path.join(CSRC, "emu"), "-I", str(out), "-o", str(so), *cpps],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    handle = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _cuda._SIGNATURES.items():
        fn = getattr(handle, name, None)
        if fn is not None:
            fn.restype, fn.argtypes = restype, argtypes
    return handle


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("kernels_emu")
    return _build_emu(out, {n: _source(n) for n in (
        "knn.cu", "knn_f32.cu", "knn_bf16_lo.cu", "knn_bf16_hi.cu", "ivf.cu", "graph.cu",
        "bm25.cu", "ml.cu", "onnx.cu", "mesh.cu")})


def _means(lib, q, x, metric):
    """knn_row_mean of the queries and the corpus for pearson, else None."""
    if metric != "pearson":
        return None, None
    bf16 = int(x.dtype == torch.bfloat16)
    qm, xm = torch.empty(q.shape[0]), torch.empty(x.shape[0])
    assert lib.knn_row_mean(q.data_ptr(), 0, q.shape[0], q.shape[1], qm.data_ptr(), None) == 0
    assert lib.knn_row_mean(x.data_ptr(), bf16, x.shape[0], x.shape[1], xm.data_ptr(), None) == 0
    return qm, xm


def _ptr(t):
    return None if t is None else t.data_ptr()


def _pairwise(lib, q, x, metric):
    code, p = D._metric_code(metric)
    nq, dim = q.shape
    n = x.shape[0]
    bf16 = int(x.dtype == torch.bfloat16)
    out = torch.empty((nq, n), dtype=torch.float32)
    qm, xm = _means(lib, q, x, metric)
    nbytes = lib.knn_pairwise_scratch_bytes(nq, n, dim, bf16, code)
    scratch = torch.empty(nbytes, dtype=torch.uint8) if nbytes else None
    status = lib.knn_pairwise(q.data_ptr(), x.data_ptr(), bf16, nq, n, dim, code, p, _ptr(qm),
                              _ptr(xm), _ptr(scratch), nbytes, out.data_ptr(), None)
    assert status == 0
    return out


def _search(lib, q, x, mask, metric, k):
    """The fused K2 launch: (dists, ids) [Q, k]."""
    code, p = D._metric_code(metric)
    nq, dim = q.shape
    n = x.shape[0]
    bf16 = int(x.dtype == torch.bfloat16)
    out_d, out_i = torch.empty((nq, k)), torch.empty((nq, k), dtype=torch.int32)
    qm, xm = _means(lib, q, x, metric)
    nbytes = lib.knn_search_scratch_bytes(nq, n, dim, k, bf16, code)
    scratch = torch.empty(nbytes, dtype=torch.uint8)
    m = None if mask is None else mask.contiguous().view(torch.uint8)
    status = lib.knn_search(q.data_ptr(), x.data_ptr(), bf16, _ptr(m), nq, n, dim, code, p, k,
                            _ptr(qm), _ptr(xm), scratch.data_ptr(), nbytes, out_d.data_ptr(),
                            out_i.data_ptr(), None)
    assert status == 0
    return out_d, out_i


def _select(lib, d, mask, k):
    nq, n = d.shape
    out_d = torch.empty((nq, k))
    out_i = torch.empty((nq, k), dtype=torch.int32)
    n2 = 1 << max(k - 1, 0).bit_length()
    cand = torch.empty((nq, n2), dtype=torch.int64) if n2 > lib.knn_select_smem_pairs() else None
    mid = lib.knn_select_mid_elems(nq, n, k)
    mid_d = torch.empty(mid) if mid else None
    mid_i = torch.empty(mid, dtype=torch.int32) if mid else None
    m = mask.contiguous().view(torch.uint8)
    status = lib.knn_select(
        d.data_ptr(), m.data_ptr(), nq, n, k, out_d.data_ptr(), out_i.data_ptr(),
        None if mid_d is None else mid_d.data_ptr(), None if mid_i is None else mid_i.data_ptr(),
        None if cand is None else cand.data_ptr(), 0 if cand is None else n2, None,
    )
    assert status == 0
    return out_d, out_i, bool(mid)


@pytest.mark.parametrize("corpus", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nq", [1, 5, 20])
def test_k1_all_metrics_match_plain(lib, nq, corpus):
    rng = np.random.default_rng(100 + nq)
    q = torch.from_numpy(rng.standard_normal((nq, 48)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((300, 48)).astype(np.float32)).to(corpus)
    for metric in list(D.METRICS) + ["minkowski:3"]:
        qq, xx = (q.abs(), x.abs()) if metric == "jaccard" else (q, x)
        got = _pairwise(lib, qq.contiguous(), xx.contiguous(), metric)
        want = D.pairwise_distance_plain(qq, xx, metric)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4, msg=metric)


def test_k1_unaligned_corpus_takes_the_scalar_path(lib):
    rng = np.random.default_rng(7)
    flat = torch.from_numpy(rng.standard_normal(301 * 40 + 1).astype(np.float32))
    x = flat[1:].view(301, 40)  # 4-byte offset: no 16-byte loads
    q = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    got = _pairwise(lib, q, x, "euclidean")
    torch.testing.assert_close(got, D.pairwise_distance_plain(q, x, "euclidean"),
                               rtol=1e-5, atol=1e-4)


def _cases():
    g = torch.Generator().manual_seed(3)
    mask_3000 = torch.rand(3000, generator=g) > 0.1
    mask_20k = torch.rand(20000, generator=g) > 0.1
    d_3000 = torch.rand(2, 3000, generator=g) * 10
    d_20k = torch.rand(2, 20000, generator=g) * 10
    ties = torch.randint(0, 5, (2, 20000), generator=g).float()
    every3 = torch.ones(20000, dtype=torch.bool)
    every3[::3] = False
    every7 = torch.ones(17000, dtype=torch.bool)
    every7[::7] = False
    three_live = torch.zeros(20000, dtype=torch.bool)
    three_live[[5, 9000, 19999]] = True
    signed_zeros = torch.zeros(1, 20000)
    signed_zeros[0, ::2] = -0.0
    return [
        ("one block, k=1", d_3000, mask_3000, 1, False),
        ("one block, k=256", d_3000, mask_3000, 256, False),
        ("chunks, k=1", d_20k, mask_20k, 1, True),
        ("chunks, k=64", d_20k, mask_20k, 64, True),
        ("chunks, k=256", d_20k, mask_20k, 256, True),
        ("one block above the chunk k", d_20k, mask_20k, 300, False),
        ("ties, chunks", ties, every3, 10, True),
        ("ties, one block", ties, every3, 2000, False),
        ("equal rows, short last chunk", torch.zeros(2, 17000), every7, 200, True),
        ("k = N", torch.zeros(1, 3000), torch.ones(3000, dtype=torch.bool), 3000, False),
        ("fewer live rows than k", torch.rand(2, 20000, generator=g), three_live, 10, True),
        ("-0.0 ties +0.0", signed_zeros, torch.ones(20000, dtype=torch.bool), 10, True),
    ]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_k2_select_matches_plain_exactly(lib, case):
    _label, d, mask, k, two_stage = case
    got_d, got_i, used_chunks = _select(lib, d, mask, k)
    assert used_chunks == two_stage
    want_d, want_i = D._topk_min_stable(
        torch.where(mask[None, :], d, torch.full_like(d, float("inf"))), k
    )
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d, want_d)


# The fused K2 (knn_search): its distances are K1's (one distance core), so
# its answer must equal K1's distances selected by the plain order exactly;
# against knn_search_plain it is within the K1 tolerance, ids up to ties.
_METRICS = list(D.METRICS) + ["minkowski:3"]


def _corpus(rng, nq, n, dim, dtype, metric):
    q = torch.from_numpy(rng.standard_normal((nq, dim)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
    if metric == "jaccard":
        q, x = q.abs(), x.abs()
    x[n // 3] = x[n // 5]  # equal rows: the lower index first
    return q.contiguous(), x.to(dtype).contiguous()


def _check_search(lib, q, x, mask, metric, k):
    got_d, got_i = _search(lib, q, x, mask, metric, k)
    d = _pairwise(lib, q, x, metric)
    if mask is not None:
        d = torch.where(mask[None, :], d, torch.full_like(d, float("inf")))
    want_d, want_i = D._topk_min_stable(d, k)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    plain_d, plain_i = D.knn_search_plain(q, x, torch.ones(x.shape[0], dtype=torch.bool)
                                          if mask is None else mask, metric, k)
    torch.testing.assert_close(got_d, plain_d, rtol=1e-5, atol=1e-4)
    assert _ids_up_to_kth_ties(got_d, got_i, plain_d, plain_i)


def _ids_up_to_kth_ties(a_d, a_i, b_d, b_i):
    """Per query, an id in one result and not the other lies within the K1
    tolerance of the k-th distance (a tie two summation orders may break
    differently)."""
    for r in range(a_i.shape[0]):
        kth = float(b_d[r, -1])
        band = 1e-4 + 1e-5 * abs(kth)
        sa, sb = set(a_i[r].tolist()), set(b_i[r].tolist())
        for dd, ii, other in ((a_d, a_i, sb), (b_d, b_i, sa)):
            for j, v in enumerate(ii[r].tolist()):
                if v not in other and not abs(float(dd[r, j]) - kth) <= band:
                    return False
    return True


def _search_cases():
    cases = []
    for metric in _METRICS:
        for nq in (1, 3, 8):
            cases.append((f"stream-{metric}-q{nq}", metric, nq, 1500, 10, torch.bfloat16, True))
    for nq, k in ((1, 1), (8, 256), (3, 256)):
        cases.append((f"stream-k{k}-q{nq}", "euclidean", nq, 1500, k, torch.bfloat16, True))
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        cases.append((f"stream-{tag}-nomask", "cosine", 8, 1100, 10, dt, False))
        cases.append((f"stream-{tag}-q12", "manhattan", 12, 700, 10, dt, True))  # 8-query tiles
    for metric in ("euclidean", "cosine"):
        for k in (1, 10, 256):
            cases.append((f"tensor-{metric}-k{k}", metric, 12, 700, k, torch.bfloat16, True))
    cases.append(("tensor-two-query-tiles", "euclidean", 70, 300, 10, torch.bfloat16, True))
    cases.append(("probe-shape", "euclidean", 1, 1024, 6, torch.bfloat16, False))
    return cases


@pytest.mark.parametrize("case", _search_cases(), ids=lambda c: c[0])
def test_k2_fused_search_matches_plain(lib, case):
    """Streaming tier at Q <= 8 for every metric and over 8-query tiles,
    tensor tier at Q > 8 (euclidean, cosine on bf16); N over several
    512-, 1,024- and 256-row tiles, none a multiple of one; k from 1 to
    256 (lists in shared memory, and in global scratch past it); masked
    rows read as +inf."""
    _label, metric, nq, n, k, dtype, masked = case
    rng = np.random.default_rng(nq * 1000 + n + k)
    q, x = _corpus(rng, nq, n, 40, dtype, metric)
    mask = torch.from_numpy(rng.random(n) > 0.1) if masked else None
    _check_search(lib, q, x, mask, metric, k)


@pytest.mark.parametrize("nq", [1, 8, 12])
@pytest.mark.parametrize("k", [10, 256])
def test_k2_fused_ties_take_the_lower_index(lib, nq, k):
    """Identical rows: every distance ties, so the k picks are the lowest
    live indices, in order; every 7th row is masked (+inf)."""
    x = torch.zeros(1500, 16, dtype=torch.bfloat16)
    q = torch.zeros(nq, 16)
    mask = torch.ones(1500, dtype=torch.bool)
    mask[::7] = False
    got = _search(lib, q, x, mask, "euclidean", k)
    want = D.knn_search_plain(q, x, mask, "euclidean", k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k2_above_the_fused_k_takes_k1_then_select(lib):
    """k = 257 is past the fused search (a shape rule): knn_search refuses
    it, and K1's distances selected by knn_select equal the plain answer."""
    assert lib.knn_search_max_k() == 256
    rng = np.random.default_rng(257)
    q, x = _corpus(rng, 3, 1500, 40, torch.bfloat16, "euclidean")
    nbytes = lib.knn_search_scratch_bytes(3, 1500, 40, 257, 1, 0)
    scratch = torch.empty(nbytes, dtype=torch.uint8)
    out_d, out_i = torch.empty((3, 257)), torch.empty((3, 257), dtype=torch.int32)
    assert lib.knn_search(q.data_ptr(), x.data_ptr(), 1, None, 3, 1500, 40, 0, 0.0, 257, None,
                          None, scratch.data_ptr(), nbytes, out_d.data_ptr(), out_i.data_ptr(),
                          None) != 0
    mask = torch.ones(1500, dtype=torch.bool)
    got_d, got_i, _ = _select(lib, _pairwise(lib, q, x, "euclidean"), mask, 257)
    want_d, want_i = D.knn_search_plain(q, x, mask, "euclidean", 257)
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-4)
    assert _ids_up_to_kth_ties(got_d, got_i, want_d, want_i)


def _knn_lower_limb_case(rng, groups, dim):
    """f32 queries whose nearest bf16 row is told apart only by limb 1
    (even groups) or only by limb 2 (odd groups) of the kernel's truncating
    split. Group g: rows a (2g) and b (2g + 1) lie at m -+ 4w (w = +-1,
    alternating by column pair), the query at m + r1 + r2 with limbs m, r1,
    r2; b is nearer by 16 sum(w (r1 + r2)) in squared distance (far rows
    keep the formula's cancellation below the tolerance). Limb-1 groups
    take r2 = 0 and a larger r1 where w = 1; limb-2 groups take equal r1 in
    a pair (their sum cancels) and a larger r2 where w = 1. m is one column
    pattern plus g / 16, so other groups' rows are farther by at least D /
    256. A product without the deciding limb sees an exact tie (a, the
    lower index, first) or a nearer a."""
    m = 4 + rng.integers(0, 40, (1, dim)) / 16 + (np.arange(groups) / 16)[:, None]  # bf16
    w = np.where(np.arange(dim) % 2 == 0, 1.0, -1.0)[None, :]
    odd = (np.arange(groups) % 2 == 1)[:, None]
    j = rng.integers(0, 64, (groups, dim // 2)).repeat(2, axis=1)
    j1 = np.where(odd, j, j + np.where(w > 0, 64, 0))
    r1 = (128 + j1) / 8192  # 8 bits in [2^-6, 2^-5): limb 1
    r2 = np.where(odd, np.where(w > 0, rng.integers(112, 128, (groups, dim)),
                                rng.integers(64, 80, (groups, dim))), 0) / 2 ** 20  # limb 2
    q = (m + r1 + r2).astype(np.float32)
    rows = np.stack([m - 4 * w, m + 4 * w], 1).reshape(2 * groups, dim)  # bf16: 1/16 steps
    return torch.from_numpy(q), torch.from_numpy(rows.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("dim", [128, 768])
@pytest.mark.parametrize("k", [1, 2])
def test_k2_tensor_tier_lower_limbs_decide(lib, k, dim):
    """12 queries (the tensor tier) whose nearest row only query limb 1 or
    limb 2 tells apart: row 2g + 1 is first for query g, as in the plain
    version."""
    rng = np.random.default_rng(3 + k + dim)
    q, x = _knn_lower_limb_case(rng, 12, dim)
    got_d, got_i = _search(lib, q, x, None, "euclidean", k)
    assert torch.equal(got_i[:, 0].long(), 2 * torch.arange(12) + 1)
    want_d, want_i = D.knn_search_plain(q, x, torch.ones(24, dtype=torch.bool), "euclidean", k)
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-4)


_K2_FAULTS = {  # fault: [(file, old, new)]
    # the tensor tier without query limb 2
    "dropped_limb2": [("knn_tq.cuh", "for (int l = 2; l >= 0; --l) {",
                       "for (int l = 1; l >= 0; --l) {")],
    # one sum over the three limbs, step by step
    "single_limb_sum": [("knn_tq.cuh",
                         "mma_bf16_16816(l == 0 ? hi[mt][nt] : lo[mt][nt], a[mt], bq[nt]);",
                         "mma_bf16_16816(hi[mt][nt], a[mt], bq[nt]);")],
    # every block's range one row short at its end
    "range_end_off_by_one": [
        ("knn.cuh", "const long long rb = b * per, re = min(N, rb + per);\n  const bool fused",
         "const long long rb = b * per, re = min(N, rb + per - 1);\n  const bool fused"),
        ("knn_tq.cuh", "const long long rb = b * per, re = min(N, rb + per);\n  const long long ld",
         "const long long rb = b * per, re = min(N, rb + per - 1);\n  const long long ld")],
    # the blocks' picks written last block first: among equal distances the
    # merge then takes the higher index
    "ties_take_the_higher_index": [
        ("knn.cuh", "const long long o = ((long long)(q0 + j) * nblk + b) * k;",
         "const long long o = ((long long)(q0 + j) * nblk + (nblk - 1 - b)) * k;"),
        ("knn_tq.cuh", "const long long o = ((long long)(q0 + c) * nblk + b) * k;",
         "const long long o = ((long long)(q0 + c) * nblk + (nblk - 1 - b)) * k;")],
}


@pytest.mark.parametrize("fault", sorted(_K2_FAULTS))
def test_k2_planted_fault_fails_the_comparison(tmp_path, fault):
    """The comparisons above have teeth: a copy of knn.cu's headers (knn.cuh,
    knn_tq.cuh) with one fault planted disagrees with the plain version on
    the lower-limb groups, on queries that sit on the blocks' first and last
    rows, or on a corpus of equal rows."""
    srcs = {n: _source(n) for n in ("knn.cu", "knn_f32.cu", "knn_bf16_lo.cu", "knn_bf16_hi.cu",
                                    "knn.cuh", "knn_tq.cuh")}
    for name, old, new in _K2_FAULTS[fault]:
        assert srcs[name].count(old) == 1, old
        srcs[name] = srcs[name].replace(old, new)
    bad = _build_emu(tmp_path, srcs)
    failed = []

    def differs(q, x, k):
        got_d, got_i = _search(bad, q, x, None, "euclidean", k)
        want_d, want_i = D.knn_search_plain(q, x, torch.ones(x.shape[0], dtype=torch.bool),
                                            "euclidean", k)
        return not (torch.equal(got_i, want_i)
                    and torch.allclose(got_d, want_d, rtol=1e-5, atol=1e-4))

    failed.append(differs(*_knn_lower_limb_case(np.random.default_rng(4), 12, 768), 1))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1500, 40)).astype(np.float32)).to(torch.bfloat16)
    # the blocks' edges (the emulation's 2 SMs: two ranges of 750 rows in both
    # tiers) and the quarters
    edges = [0, 374, 375, 749, 750, 1124, 1125, 1499]
    for nq in (8, 12):
        failed.append(differs(x[(edges * 2)[:nq]].float() + 1e-3, x, 3))
    for nq in (1, 12):
        failed.append(differs(torch.zeros(nq, 16), torch.zeros(1500, 16, dtype=torch.bfloat16), 10))
    assert any(failed)


# ------------------------------------------------------------------ graph


def _frontier(rng, n, width, fill, k):
    """k seeds (some with zero weight, one negative id), the rest sentinels."""
    fr = np.full(width, fill, dtype=np.int32)
    w = np.zeros(width, dtype=np.int32)
    fr[:k] = rng.integers(0, n, k)
    w[:k] = rng.integers(0, 4, k)
    fr[k // 2] = -3  # clipped to node 0
    return torch.from_numpy(fr), torch.from_numpy(w)


@pytest.mark.parametrize("lanes", [8, 32, 64, 96])
@pytest.mark.parametrize("products", [0, 1, 2])
def test_k8_dense_count_matches_plain_exactly(lib, products, lanes):
    """3 column tiles of 128, a reduction of 384 rows in several splits,
    lanes in one (8, 32, 64) or two (96) row chunks."""
    rng = np.random.default_rng(products * 10 + lanes)
    n_src, n0 = 300, 384
    a = np.zeros((n0, n0), dtype=np.float32)
    np.add.at(a, (rng.integers(0, n_src, 4000), rng.integers(0, n_src, 4000)), 1.0)
    A = torch.from_numpy(a).to(torch.bfloat16)
    outdeg = torch.from_numpy(a.sum(1).astype(np.float32))
    frs, cws = zip(*[_frontier(rng, n_src, 16, n0, 3) for _ in range(lanes)])
    fr, w = torch.stack(frs), torch.stack(cws)
    args = ((A,) * products, outdeg, fr, w, n0)
    got, want = G._launch_dense_count(lib, *args), G.dense_count_batch_plain(*args)
    assert torch.equal(got, want) and bool((want > 0).any())
    assert float(want.max()) < 2**24  # the exactness guard's range


def _edge_seeds(rng, lanes, width, n_src, n0):
    """Per lane: a few seeds in range with weights 1-3, and the rules'
    edge cases: a negative id (clipped to node 0), ids at and past n0
    (dropped), and weights of 0 and -2 (dropped)."""
    fr = np.full((lanes, width), n0, dtype=np.int32)
    w = np.zeros((lanes, width), dtype=np.int32)
    for b in range(lanes):
        fr[b, :4] = rng.integers(0, n_src, 4)
        w[b, :4] = rng.integers(1, 4, 4)
        fr[b, 4:9] = [-3, n0, n0 + 7, int(rng.integers(0, n_src)), int(rng.integers(0, n_src))]
        w[b, 4:9] = [2, 5, 1, 0, -2]
    return torch.from_numpy(fr), torch.from_numpy(w)


@pytest.mark.parametrize("order", ["narrow_then_wide", "wide_then_narrow"])
def test_k8_dense_count_chain_of_unequal_widths(lib, order):
    """[n0, n1] then [n1, n2] with n0 != n1 != n2, widths off the 128
    padding, a width of two 2,048-column segments, every seed rule."""
    rng = np.random.default_rng(31 if order == "narrow_then_wide" else 32)
    n0, n1, n2 = (300, 200, 2056) if order == "narrow_then_wide" else (200, 2056, 136)
    mats = []
    for r, c in ((n0, n1), (n1, n2)):
        a = np.zeros((r, c), dtype=np.float32)
        np.add.at(a, (rng.integers(0, r, 3000), rng.integers(0, c, 3000)), 1.0)
        mats.append(a)
    A0, A1 = (torch.from_numpy(a).to(torch.bfloat16) for a in mats)
    outdeg = torch.from_numpy(rng.integers(0, 5, n2).astype(np.float32))
    fr, w = _edge_seeds(rng, 12, 32, n0, n0)
    args = ((A0, A1), outdeg, fr, w, n0)
    got, want = G._launch_dense_count(lib, *args), G.dense_count_batch_plain(*args)
    assert torch.equal(got, want) and bool((want > 0).all())


def test_k8_dense_count_just_under_the_guard_is_exact(lib):
    """A count of 2^24 - 256 (255 x 2,056 x 32), where a lost unit would
    show: one row of 255s over two segments' columns, outdeg 32, one seed
    of weight 1; beside it a lane with node 1 seeded twice (weights 1 and
    2) over its 1,028 even columns."""
    n0, n1 = 16, 2056
    a = np.zeros((n0, n1), dtype=np.float32)
    a[0, :] = 255.0
    a[1, ::2] = 1.0
    A = torch.from_numpy(a).to(torch.bfloat16)
    outdeg = torch.full((n1,), 32.0)
    fr = torch.tensor([[0, n0, n0], [1, 1, -1]], dtype=torch.int32)
    w = torch.tensor([[1, 0, 0], [1, 2, 0]], dtype=torch.int32)
    args = ((A,), outdeg, fr, w, n0)
    got, want = G._launch_dense_count(lib, *args), G.dense_count_batch_plain(*args)
    assert want.tolist() == [2**24 - 256, 3 * 1028 * 32]
    assert torch.equal(got, want)


_K8_FAULTS = {
    # u staged in one plane: a lane's high float4 is the next vector's low one
    "one_u_plane": ("mv_u[((c >> 2) & 1) * half + (c >> 3) * 4 + (c & 3)] = u[c];",
                    "mv_u[c] = u[c];"),
    # the operators applied front to back
    "operators_in_order": ("for (int i = n_mats - 1; i >= 0; --i) {", "for (int i = 0; i < n_mats; ++i) {"),
    # a seed past the space kept (clipped to its last node)
    "seed_past_n0_kept": ("const long long c = clampll(fr[base + j], 0, n);",
                          "const long long c = clampll(fr[base + j], 0, n - 1);"),
}


@pytest.mark.parametrize("fault", sorted(_K8_FAULTS))
def test_k8_planted_fault_fails_the_comparison(tmp_path, fault):
    """The comparisons above have teeth: a copy of graph.cu with one fault
    planted disagrees with the plain version."""
    src = _source("graph.cu")
    old, new = _K8_FAULTS[fault]
    assert src.count(old) == 1
    bad = _build_emu(tmp_path, {"graph.cu": src.replace(old, new)})
    rng = np.random.default_rng(33)
    n0, n1 = 304, 200
    mats = []
    for r, c in ((n0, n1), (n1, n0)):
        a = np.zeros((r, c), dtype=np.float32)
        np.add.at(a, (rng.integers(0, r, 3000), rng.integers(0, c, 3000)), 1.0)
        mats.append(torch.from_numpy(a).to(torch.bfloat16))
    outdeg = torch.from_numpy(rng.integers(0, 5, n0).astype(np.float32))
    fr, w = _edge_seeds(rng, 4, 32, n0, n0)
    args = (tuple(mats), outdeg, fr, w, n0)
    assert not torch.equal(G._launch_dense_count(bad, *args), G.dense_count_batch_plain(*args))


# ------------------------------------------------------------------ BM25


def _bm25_inputs(rng, n, t, tf_dtype):
    """Config-3-like candidates with every hazard at once: repeated rows
    (ties), an all-zero tf row, zero-length (tombstoned) documents, lengths
    that vary, and a total length above 2^24 (it rounds as f32)."""
    tf = rng.integers(0, 4, size=(n, t))
    tf[: n // 3] = tf[0]  # a third of the rows tie with row 0 ...
    tf[n // 2] = 0  # ... and one row matches nothing
    lens = rng.integers(3, 40, size=n).astype(np.float32)
    lens[: n // 3] = lens[0]
    lens[n // 2 + 1 :: 97] = 0.0
    df = rng.integers(1, 5000, size=t).astype(np.float32)
    tf_t = torch.from_numpy(tf.astype(np.float32 if tf_dtype == "f32" else np.int32))
    return tf_t, torch.from_numpy(df), torch.from_numpy(lens), 9_000.0, 16_777_217.0 + 2_000


def _bm25_emu(lib, tf, df, lens, dc, tl, negate=False, k1=1.2, b=0.75):
    out = torch.empty(tf.shape[0])
    assert B._launch_scores(lib, tf, df, lens, dc, tl, k1, b, negate, out, None) == 0
    return out


@pytest.mark.parametrize("tf_dtype", ["f32", "i32"])
@pytest.mark.parametrize("t", [1, 2, 8, 300])
def test_k9_scores_match_plain(lib, t, tf_dtype):
    """Any T (300 > the 256 idf values a block stages at once), int32 and
    f32 tf, 700 rows (three blocks, a ragged last one)."""
    tf, df, lens, dc, tl = _bm25_inputs(np.random.default_rng(t), 700, t, tf_dtype)
    got = _bm25_emu(lib, tf, df, lens, dc, tl)
    want = B.bm25_scores_plain(tf, df, lens, dc, tl)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    tied = got[: 700 // 3]
    assert bool((tied == tied[0]).all())  # bit-identical ties
    assert float(got[350]) == 0.0
    neg = _bm25_emu(lib, tf, df, lens, dc, tl, negate=True)
    assert torch.equal(neg, -got)


@pytest.mark.parametrize("k", [1, 10, 233, 700])
def test_k9_topk_order_with_ties_matches_plain(lib, k):
    """bm25_topk on the card: the negated scores, then K2's select; the
    order is the plain version's (larger first, lower index first), over a
    third of tied rows and a zero row."""
    tf, df, lens, dc, tl = _bm25_inputs(np.random.default_rng(k), 700, 2, "f32")
    neg = _bm25_emu(lib, tf, df, lens, dc, tl, negate=True)
    d, i, _ = _select(lib, neg.view(1, -1), torch.ones(700, dtype=torch.bool), k)
    want_v, want_i = B.bm25_topk_plain(tf, df, lens, dc, tl, k)
    assert torch.equal(i[0], want_i)
    torch.testing.assert_close(0.0 - d[0], want_v, rtol=1e-5, atol=1e-6)


def test_k9_topk_of_a_zero_row_keeps_index_order(lib):
    tf = torch.zeros((300, 2))
    df, lens = torch.tensor([3.0, 9.0]), torch.full((300,), 12.0)
    neg = _bm25_emu(lib, tf, df, lens, 1000.0, 12_000.0, negate=True)
    d, i, _ = _select(lib, neg.view(1, -1), torch.ones(300, dtype=torch.bool), 20)
    assert i[0].tolist() == list(range(20)) and bool(((0.0 - d[0]) == 0).all())
    assert torch.equal(i[0], B.bm25_topk_plain(tf, df, lens, 1000.0, 12_000.0, 20)[1])


_BM25_FAULTS = {
    # the idf's +0.5 smoothing of df
    "idf": ("__fadd_rn(d, 0.5f)", "__fadd_rn(d, 1.5f)"),
    # the length normalisation without the division by the average length
    "length_norm": ("__fdiv_rn(len, avg_len)", "len"),
}


@pytest.mark.parametrize("fault", sorted(_BM25_FAULTS))
def test_k9_planted_fault_fails_the_comparison(tmp_path, fault):
    """The comparison above has teeth: a copy of bm25.cu with one fault
    planted disagrees with the plain version."""
    src = _source("bm25.cu")
    old, new = _BM25_FAULTS[fault]
    assert src.count(old) == 1
    bad = _build_emu(tmp_path, {"bm25.cu": src.replace(old, new)})
    tf, df, lens, dc, tl = _bm25_inputs(np.random.default_rng(1), 300, 2, "f32")
    got = _bm25_emu(bad, tf, df, lens, dc, tl)
    assert not torch.allclose(got, B.bm25_scores_plain(tf, df, lens, dc, tl),
                              rtol=1e-5, atol=1e-6)


def _k9_postings(rng, ndoc=6000):
    """Postings of 15 terms over ndoc documents (tf 1-3, lengths 0-30): 0
    every document, 1-3 a half / a fifth / a twentieth, 4 exactly 256 (one
    tile), 5 the last document only (the largest did), 6 the first and the
    last, 7 / 8 the even / odd ones (disjoint), 9-14 dense (70-95%)."""
    lists = [np.arange(ndoc)]
    lists += [np.nonzero(rng.random(ndoc) < p)[0] for p in (0.5, 0.2, 0.05)]
    lists.append(np.sort(rng.choice(ndoc, 256, replace=False)))
    lists += [np.array([ndoc - 1]), np.array([0, ndoc - 1]), np.arange(0, ndoc, 2),
              np.arange(1, ndoc, 2)]
    lists += [np.nonzero(rng.random(ndoc) < p)[0] for p in (0.9, 0.8, 0.95, 0.7, 0.85, 0.75)]
    indptr = np.zeros(len(lists) + 1, dtype=np.int64)
    indptr[1:] = np.cumsum([len(x) for x in lists])
    dids = np.concatenate(lists).astype(np.int64)
    tfs = rng.integers(1, 4, len(dids)).astype(np.float32)
    lens = rng.integers(0, 31, ndoc).astype(np.float32)
    return B.upload_postings(indptr, dids, tfs, lens, "cpu"), float(lens.sum())


# (label, term ids rarest first, stats_override df or None)
_K9_MATCH_CASES = [
    ("T1 half", [1], None), ("T1 one did", [5], None), ("T1 one tile", [4], None),
    ("T1 every doc, many tiles", [0], None),
    ("T2", [3, 1], None), ("T2 window past the stage", [6, 1], None),
    ("T2 empty", [7, 8], None), ("T2 full", [4, 0], None), ("T2 largest did", [5, 0], None),
    ("T2 many tiles", [1, 9], None), ("T3", [3, 2, 1], None),
    ("T8", [3, 0, 9, 10, 11, 12, 13, 14], None),
    ("T2 stats_override", [3, 1], [400_000.0, 12.5]),
]


def _k9_match_emu(lib, post, tids, df, dc, tl, scratch=None):
    sc = scratch or B.MatchScratch(torch.device("cpu"))
    out = B._launch_match(lib, post, tids, df, dc, tl, 1.2, 0.75, sc, None)
    return out, sc


def _k9_tf_rows(post, tids, dids):
    """The tf rows of the matched dids, for bm25_scores."""
    ip, all_d, all_f = post.host_indptr, post.dids.numpy(), post.tfs.numpy()
    cols = []
    for t in tids:
        d, f = all_d[ip[t]:ip[t + 1]], all_f[ip[t]:ip[t + 1]]
        cols.append(f[np.searchsorted(d, dids)])
    return torch.from_numpy(np.stack(cols, 1).astype(np.float32))


@pytest.mark.parametrize("case", _K9_MATCH_CASES, ids=lambda c: c[0])
def test_k9_match_matches_plain(lib, case):
    """bm25_match_scores under emulation: the plain version's dids in its
    order, scores within the tolerance (log1pf against torch's log1p) and
    bit-equal to bm25_scores' on the same tf rows; the look-back state zero
    after the call."""
    label, tids, odf = case
    post, tl = _k9_postings(np.random.default_rng(90))
    df = np.array(odf or [post.length(t) for t in tids], dtype=np.float32)
    dc, tl = (3_000_000.0, 36_000_001.0) if odf else (6000.0, tl)
    (dids, scores), sc = _k9_match_emu(lib, post, tids, df, dc, tl)
    want_d, want_s = B.bm25_match_scores_plain(post, tids, df, dc, tl)
    np.testing.assert_array_equal(dids, want_d)
    np.testing.assert_allclose(scores, want_s, rtol=1e-5, atol=1e-6)
    assert not bool(sc.state.any())
    if label.endswith("empty"):
        assert dids.size == 0
        return
    assert dids.size > 0
    if "full" in label or label.startswith("T1"):
        assert dids.size == post.length(tids[0])
    if dids.size:
        rows = _k9_tf_rows(post, tids, dids)
        same = _bm25_emu(lib, rows, torch.from_numpy(df), post.doc_len[torch.from_numpy(dids)],
                         dc, tl)
        assert np.array_equal(same.numpy().view(np.int32), scores.view(np.int32))


def test_k9_match_back_to_back_over_one_scratch(lib):
    """Queries of every size in turn over one scratch (it grows with the
    rarest list and its state stays zero): each equal to a fresh call's."""
    post, tl = _k9_postings(np.random.default_rng(91))
    sc = B.MatchScratch(torch.device("cpu"))
    for _, tids, _ in _K9_MATCH_CASES[:10]:
        df = np.array([post.length(t) for t in tids], dtype=np.float32)
        got, _ = _k9_match_emu(lib, post, tids, df, 6000.0, tl, sc)
        want = B.bm25_match_scores_plain(post, tids, df, 6000.0, tl)
        np.testing.assert_array_equal(got[0], want[0])
        assert not bool(sc.state.any())


def _k9_many_terms(n):
    """chip_smoke.py's many-term postings (300 terms, 300 documents holding
    every one) and the first n terms in FtMirror.search's order."""
    import chip_smoke as C

    indptr, dids, tfs, lens = C.many_term_postings()
    post = B.upload_postings(indptr, dids, tfs, lens, "cpu")
    tids = C.search_order(indptr, list(range(n)))
    df = np.array([indptr[t + 1] - indptr[t] for t in tids], dtype=np.float32)
    return post, tids, df, 4096.0, float(lens.sum())


@pytest.fixture(scope="module")
def lib_all_terms_on_card(tmp_path_factory):
    """bm25.cu with MS_MAX_T = 1: every query of two or more terms reads
    its terms from the card."""
    src = _source("bm25.cu")
    old = "constexpr int MS_MAX_T = 256;"
    assert src.count(old) == 1
    return _build_emu(tmp_path_factory.mktemp("bm25_terms_on_card"),
                      {"bm25.cu": src.replace(old, "constexpr int MS_MAX_T = 1;")})


@pytest.mark.parametrize("n", [2, 256, 257, 300])
def test_k9_match_past_the_terms_by_value(lib, lib_all_terms_on_card, monkeypatch, n):
    """_launch_match with 2 and 256 distinct terms (by value) and 257 and
    300 (through the scratch's (tid, df) pairs on the card, idf staged 256
    at a time): the plain version's dids in its order and scores within
    the tolerance (log1pf against torch's log1p), bit-equal to bm25_scores'
    on the same tf rows; the same bits when every term comes from the card;
    the look-back state zero after. Every query keeps the 300 documents
    that hold every term, so the last chunk of terms is reached."""
    assert B.MATCH_BY_VALUE == lib.bm25_match_by_value_terms() == 256
    post, tids, df, dc, tl = _k9_many_terms(n)
    (dids, scores), sc = _k9_match_emu(lib, post, tids, df, dc, tl)
    want_d, want_s = B.bm25_match_scores_plain(post, tids, df, dc, tl)
    np.testing.assert_array_equal(dids, want_d)
    assert dids.size >= 300
    np.testing.assert_allclose(scores, want_s, rtol=1e-5, atol=1e-6)
    assert (sc.terms.numel() >= 2 * n) == (n > 256) and not bool(sc.state.any())
    same = _bm25_emu(lib, _k9_tf_rows(post, tids, dids), torch.from_numpy(df),
                     post.doc_len[torch.from_numpy(dids)], dc, tl)
    assert np.array_equal(same.numpy().view(np.int32), scores.view(np.int32))
    monkeypatch.setattr(B, "MATCH_BY_VALUE", 1)
    (d2, s2), _ = _k9_match_emu(lib_all_terms_on_card, post, tids, df, dc, tl)
    np.testing.assert_array_equal(d2, dids)
    assert np.array_equal(s2.view(np.int32), scores.view(np.int32))


_K9_MANY_TERM_FAULTS = {
    # the second chunk of terms scored with the first chunk's idf values
    "no_restage": ("if (j % IDF_CHUNK == 0) stage_idf(idf, terms, dterms, j, t, nd);", ""),
    # the terms past the first chunk read from the parameter's last slots
    "by_value_index": ("return dterms ? dterms[j].x : terms.tid[j];",
                       "return dterms ? dterms[j % MS_MAX_T].x : terms.tid[j];"),
}


@pytest.mark.parametrize("fault", sorted(_K9_MANY_TERM_FAULTS))
def test_k9_match_many_terms_planted_fault_fails(tmp_path, fault):
    """The 300-term case has teeth: a copy of bm25.cu with one fault in the
    terms past the first 256 disagrees with the plain version."""
    src = _source("bm25.cu")
    old, new = _K9_MANY_TERM_FAULTS[fault]
    assert src.count(old) == 1
    bad = _build_emu(tmp_path, {"bm25.cu": src.replace(old, new)})
    post, tids, df, dc, tl = _k9_many_terms(300)
    (dids, scores), _ = _k9_match_emu(bad, post, tids, df, dc, tl)
    want_d, want_s = B.bm25_match_scores_plain(post, tids, df, dc, tl)
    assert dids.shape != want_d.shape or not np.array_equal(dids, want_d) \
        or not np.allclose(scores, want_s, rtol=1e-5, atol=1e-6)


_K9_MATCH_FAULTS = {
    # the window of another list ends before the tile's last did
    "window_end": ("warp_bound(dids, sj, ej, span[warp], warp == 1)",
                   "warp_bound(dids, sj, ej, span[warp], false)"),
    # each tile ranks its matches from 0: the tiles overwrite each other
    "no_look_back": ("out[1 + before + rank]", "out[1 + 0 * before + rank]"),
    # every term scored with the rarest term's idf
    "idf_of_the_rarest": ("bm25_term(idf[j % IDF_CHUNK], tfs[pos], k1p1, kn)",
                          "bm25_term(idf[0], tfs[pos], k1p1, kn)"),
}


@pytest.mark.parametrize("fault", sorted(_K9_MATCH_FAULTS))
def test_k9_match_planted_fault_fails_the_comparison(tmp_path, fault):
    """The match cases have teeth: a copy of bm25.cu with one fault planted
    disagrees with the plain version on them."""
    src = _source("bm25.cu")
    old, new = _K9_MATCH_FAULTS[fault]
    assert src.count(old) == 1
    bad = _build_emu(tmp_path, {"bm25.cu": src.replace(old, new)})
    post, tl = _k9_postings(np.random.default_rng(90))
    differs = []
    for _, tids, _ in _K9_MATCH_CASES:
        df = np.array([post.length(t) for t in tids], dtype=np.float32)
        (dids, scores), _ = _k9_match_emu(bad, post, tids, df, 6000.0, tl)
        want_d, want_s = B.bm25_match_scores_plain(post, tids, df, 6000.0, tl)
        differs.append(dids.shape != want_d.shape or not np.array_equal(dids, want_d)
                       or not np.allclose(scores, want_s, rtol=1e-5, atol=1e-6))
    assert any(differs)


# ------------------------------------------------------------------ ML (K10)


def _linear_emu(lib, x, w, b, act):
    out = torch.empty((x.shape[0], w.shape[1]))
    assert ML._launch_linear(lib, x, w, ML.Epilogue.layer(b, act), out, None) == 0
    return out


def _linear_plain(x, w, b, act):
    return ML.linear_act_plain(x, w, ML.Epilogue.layer(b, act))


def _softmax_emu(lib, h, out=None):
    out = torch.empty_like(h) if out is None else out
    assert ML._launch_softmax(lib, h, out, None) == 0
    return out


def _ml_inputs(seed, m, k, n, x_dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32) * scale).to(x_dtype)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return x, w, b


@pytest.mark.parametrize("act", [None, "relu", "tanh", "sigmoid"], ids=str)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 10, 130])
def test_k10_linear_matches_plain(lib, n, x_dtype, act):
    """The skinny path (N = 1: a warp a row, 16-byte loads), the narrow
    path (N = 10: a thread a row, cp.async stages) and the wide path (N =
    130: tensor-core limbs, one 256-column tile, ragged) over 77 rows, not
    a multiple of any path's row tile."""
    x, w, b = _ml_inputs(n, 77, 48, n, x_dtype)
    got = _linear_emu(lib, x, w, b, act)
    torch.testing.assert_close(got, _linear_plain(x, w, b, act), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,n", [(45, 1), (45, 3), (45, 40), (1600, 10), (6200, 2),
                                 (13000, 2)],
                         ids=["scalar-n1", "scalar-n3", "wide-k45", "chunks-n10",
                              "chunks-n2", "chunks-n2-past-narrow"])
def test_k10_linear_odd_k_and_chunked_w(lib, k, n, x_dtype):
    """K = 45 takes the scalar loads (no 16-byte alignment) of the skinny
    and the wide paths; K = 1,600 at N = 10 and 13,000 at N = 2 are past
    the narrow path's W and stage W on the skinny path in more than one
    96 KB chunk; K = 6,200 at N = 2 takes the skinny path's one chunk."""
    x, w, b = _ml_inputs(k + n, 37, k, n, x_dtype)
    got = _linear_emu(lib, x, w, b, "relu")
    torch.testing.assert_close(got, _linear_plain(x, w, b, "relu"), rtol=1e-5,
                               atol=1e-4 if k > 1000 else 1e-5)


def test_k10_sigmoid_and_tanh_saturate_without_nan(lib):
    x = torch.tensor([[-200.0], [-90.0], [0.0], [90.0], [200.0]])
    w, b = torch.ones((1, 1)), torch.zeros(1)
    sig = _linear_emu(lib, x, w, b, "sigmoid")[:, 0]
    assert sig.tolist() == [0.0, 0.0, 0.5, 1.0, 1.0]
    assert _linear_emu(lib, x, w, b, "tanh")[:, 0].tolist() == [-1.0, -1.0, 0.0, 1.0, 1.0]
    torch.testing.assert_close(_linear_plain(x, w, b, "sigmoid")[:, 0], sig)


@pytest.mark.parametrize("n", [1, 10, 33, 300])
def test_k10_softmax_matches_plain_on_large_rows(lib, n):
    """Rows with magnitudes up to 1e3 (exp overflows without the max
    subtraction), 37 rows: the last block ragged; in place as well."""
    rng = np.random.default_rng(n)
    h = torch.from_numpy((rng.standard_normal((37, n)) * 300).astype(np.float32))
    h[0] = 1000.0  # a row of equal large values
    want = ML.row_softmax_plain(h)
    got = _softmax_emu(lib, h)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    inplace = h.clone()
    _softmax_emu(lib, inplace, inplace)
    assert torch.equal(inplace, got)


def _assert_linear_close(got, want, k):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 if k > 1000 else 1e-5)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [45, 64, 128, 768])
@pytest.mark.parametrize("n", [2, 3, 10, 16])
def test_k10_narrow_matches_plain(lib, n, k, x_dtype):
    """2 <= N <= 16 over 1,100 rows: three 512-row tiles (the last ragged)
    walked by the emulation's two persistent blocks, K in 64-byte steps
    through the 3-stage ring (K = 45: the skinny path's scalar loads)."""
    x, w, b = _ml_inputs(100 * n + k, 1100, k, n, x_dtype)
    _assert_linear_close(_linear_emu(lib, x, w, b, "tanh"), _linear_plain(x, w, b, "tanh"),
                         k)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [45, 128, 768])
@pytest.mark.parametrize("n", [17, 64, 128, 130, 300])
def test_k10_wide_matches_plain(lib, n, k, x_dtype):
    """N > 16 on the tensor-core limbs over 150 rows (no multiple of the 64-,
    128- or 256-row tiles; the emulation's two persistent blocks walk up to
    9 tiles): one column tile up to N = 128, two at N = 130, three at N =
    300; K = 45 stages x with plain loads and a ragged last K step."""
    x, w, b = _ml_inputs(1000 + n + k, 150, k, n, x_dtype)
    _assert_linear_close(_linear_emu(lib, x, w, b, "relu"), _linear_plain(x, w, b, "relu"),
                         k)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 10, 64])
def test_k10_unaligned_base_takes_the_scalar_loads(lib, n, x_dtype):
    """x a [1:] view (2 or 4 bytes past 16-byte alignment): the skinny and
    the wide paths' scalar loads."""
    rng = np.random.default_rng(30 + n)
    flat = torch.from_numpy(rng.standard_normal(70 * 64 + 1).astype(np.float32)).to(x_dtype)
    x = flat[1:].view(70, 64)
    _, w, b = _ml_inputs(n, 1, 64, n, torch.float32)
    _assert_linear_close(_linear_emu(lib, x, w, b, None), _linear_plain(x, w, b, None), 64)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("k", [45, 768])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k10_skinny_rows_past_a_tile_match_plain(lib, x_dtype, k, offset):
    """N = 1 (config 5's shape) over 1,100 rows: the emulation's two blocks
    take 550 rows each, a 512-row tile and a partial one; K = 45 (no
    16-byte rows) and a base offset by one element take the plain-load
    staging, K = 768 aligned the cp.async ring."""
    rng = np.random.default_rng(k + offset)
    flat = torch.from_numpy(rng.standard_normal(1100 * k + offset).astype(np.float32))
    x = flat.to(x_dtype)[offset:].view(1100, k)
    _, w, b = _ml_inputs(k, 1, k, 1, torch.float32)
    _assert_linear_close(_linear_emu(lib, x, w, b, "sigmoid"),
                         _linear_plain(x, w, b, "sigmoid"), k)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 10, 64])
def test_k10_inf_and_nan_in_x_land_where_f32_puts_them(lib, n, x_dtype):
    """+-inf and NaN in x: every output, its inf and NaN positions too,
    equals the plain version's (the wide path recomputes its non-finite
    outputs as f32 FMA chains)."""
    x, w, b = _ml_inputs(40 + n, 90, 64, n, torch.float32)
    x[3, 5] = float("inf")
    x[7, 0] = -float("inf")
    x[11, 9] = float("nan")
    x[20, 1], x[20, 2] = float("inf"), -float("inf")
    x = x.to(x_dtype)
    got = _linear_emu(lib, x, w, b, "relu")
    want = _linear_plain(x, w, b, "relu")
    assert bool(torch.isinf(want).any()) and bool(torch.isnan(want).any())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("n", [1, 7, 10, 32, 33, 130, 1000, 1500])
def test_k10_softmax_rows_with_neg_inf_match_plain(lib, n):
    """301 rows (no multiple of the 128-row run or the 4-row warp block),
    some entries -inf and one row all -inf (NaN, as jax.nn.softmax gives);
    then the same from a [1:] view (no 16-byte loads); in place too."""
    rng = np.random.default_rng(200 + n)
    h = torch.from_numpy((rng.standard_normal((301, n)) * 30).astype(np.float32))
    h[rng.random((301, n)) < 0.2] = -float("inf")
    h[:, 0] = torch.where(torch.isinf(h[:, 0]), torch.zeros(()), h[:, 0])
    h[17] = -float("inf")
    want = ML.row_softmax_plain(h)
    torch.testing.assert_close(_softmax_emu(lib, h), want, rtol=0, atol=1e-6, equal_nan=True)
    flat = torch.empty(301 * n + 1)
    view = flat[1:].view(301, n)
    view.copy_(h)
    torch.testing.assert_close(_softmax_emu(lib, view), want, rtol=0, atol=1e-6,
                               equal_nan=True)
    _softmax_emu(lib, view, view)
    torch.testing.assert_close(view, want, rtol=0, atol=1e-6, equal_nan=True)


_ML_FAULTS = {
    # the bias (the epilogue's first operand) left out of the three linear
    # paths' epilogues: epi_src, in ewise.cuh, reads it for them all but the
    # wide path's layer instance, which adds it at its store
    "dropped_bias": [("ewise.cuh", "const float* p = e.opnd[reg - 1];",
                      "const float* p = reg == 1 ? nullptr : e.opnd[reg - 1];"),
                     ("v[u] = __fadd_rn(v[u], lb[col + u]);", "v[u] = __fadd_rn(v[u], 0.f);")],
    # the softmax's exp without the row max subtracted, in all three kernels
    "softmax_without_max": [("expf(row[c] - m)", "expf(row[c])"),
                            ("expf(v[j] - m)", "expf(v[j])"),
                            ("expf(src[c] - m)", "expf(src[c])")],
    # the wide path's W limb planes without the middle limb
    "dropped_w1_limb": [("wl[1 * BN * WD_LPW + c * WD_LPW + kp] = pack_bf16(a1, b1);",
                         "wl[1 * BN * WD_LPW + c * WD_LPW + kp] = 0u;")],
    # the narrow and the wide paths read the ring stage after the one that landed
    "swapped_cp_async_stage": [
        ("unsigned char* cur = xs + (int)(s % NR_STAGES) * NR_STAGE_BYTES;",
         "unsigned char* cur = xs + (int)((s + 1) % NR_STAGES) * NR_STAGE_BYTES;"),
        ("const unsigned char* src = wd_smem + (int)(u % WD_STAGES) * Tile::RAW;",
         "const unsigned char* src = wd_smem + (int)((u + 1) % WD_STAGES) * Tile::RAW;")],
    # a softmax thread reduces a window that straddles its row and the next
    "softmax_rows_straddle": [("float* row = sm_run + r * N;",
                               "float* row = sm_run + r * (N + 1);")],
}
# the widths each fault shows at: the linear paths' N, or the softmax's
_ML_FAULT_WIDTHS = {"dropped_bias": (1, 10, 130), "softmax_without_max": (10, 130, 1500),
                    "dropped_w1_limb": (64, 130), "swapped_cp_async_stage": (10, 130),
                    "softmax_rows_straddle": (10,)}


@pytest.mark.parametrize("fault", sorted(_ML_FAULTS))
def test_k10_planted_fault_fails_the_comparison(tmp_path, fault):
    """The comparisons above have teeth: a copy of ml.cu (or of the
    ewise.cuh it includes) with one fault planted disagrees with the plain
    versions, on every path it touches."""
    srcs = {"ml.cu": _source("ml.cu")}
    for *name, old, new in _ML_FAULTS[fault]:  # (file,) old, new; ml.cu by default
        name = name[0] if name else "ml.cu"
        src = srcs.setdefault(name, _source(name))
        assert src.count(old) == 1
        srcs[name] = src.replace(old, new)
    bad = _build_emu(tmp_path, srcs)
    for n in _ML_FAULT_WIDTHS[fault]:
        if fault.startswith("softmax"):
            h = torch.from_numpy((np.random.default_rng(2).standard_normal((300, n)) * 300)
                                 .astype(np.float32))
            assert not torch.allclose(_softmax_emu(bad, h), ML.row_softmax_plain(h), atol=1e-6,
                                      equal_nan=False), n
            continue
        for x_dtype in (torch.float32, torch.bfloat16):
            x, w, b = _ml_inputs(n, 600, 128, n, x_dtype)
            assert not torch.allclose(_linear_emu(bad, x, w, b, None),
                                      _linear_plain(x, w, b, None), rtol=1e-5,
                                      atol=1e-5), (n, x_dtype)



# ------------------------------------------------------------------ ONNX plan (K16)
_EXACT_OPS = ("copy", "add", "sub", "mul", "div", "max", "min", "neg", "relu", "leaky")
_ULP_OPS = ("exp", "sqrt", "pow", "tanh", "sigmoid", "elu")


def _special_rows(rng, m, n, dtype=torch.float32):
    """[m, n] normal values times 3, with NaN, +-inf, -0.0 and 0.0 planted."""
    x = rng.standard_normal((m, n)).astype(np.float32) * 3
    x[0, : min(n, 5)] = [np.nan, np.inf, -np.inf, -0.0, 0.0][: min(n, 5)]
    x[rng.random((m, n)) < 0.02] = -0.0
    x[rng.random((m, n)) < 0.01] = np.nan
    return torch.from_numpy(x).to(dtype)


def _ulps(a, b):
    """|a - b| in f32 units in the last place (NaN against NaN: 0)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = (ordered(a) - ordered(b)).abs()
    return torch.where(both_nan, torch.zeros_like(d), d)


def _assert_ewise_close(got, want, op, x=None, alpha=0.0):
    """Exact ops: the same bits (any NaN for a NaN); others within 2 ulp;
    Elu within 2 ulp, or where alpha (exp(x) - 1) cancels (x near 0) within
    alpha times 2 ulp of exp(x): the two libms' exp may differ by an ulp."""
    assert torch.equal(torch.isnan(got), torch.isnan(want)), op
    ulps = _ulps(got, want)
    if op == "elu":
        e = torch.exp(torch.clamp(x.float(), max=0.0))
        ulps = torch.where((got - want).abs() <= abs(alpha) * 2 * 2.0 ** -23 * e,
                           torch.zeros_like(ulps), ulps)
    limit = 0 if op in _EXACT_OPS else 2
    assert int(ulps.max()) <= limit, (op, int(ulps.max()))


def _ewise_emu(lib, prog, inputs, out):
    assert ML._launch_ewise(lib, prog, inputs, out, None) == 0
    return out


def _op_prog(op, operand):
    """op over r0 and, for a binary op, `operand` ("reg": r1, or a float
    immediate); LeakyRelu / Elu take 0.1 / 0.7 as alpha."""
    if op in ("add", "sub", "mul", "div", "pow", "max", "min"):
        b = ML.IMM if isinstance(operand, float) else 1
        return ML.Program([(op, 4, 0, b, operand if b == ML.IMM else 0.0)], 4)
    alpha = {"leaky": 0.1, "elu": 0.7}.get(op, 0.0)
    return ML.Program([(op, 4, 0, 0, alpha)], 4)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ["per_column", "per_row", "scalar"])
@pytest.mark.parametrize("op", list(ML.EW_OPS))
def test_k16_ewise_each_op_matches_plain(lib, op, shape, x_dtype):
    """Every op code over 301 x 37 values with NaN, +-inf and -0 planted,
    the second operand [37] (one a column), [301, 1] (one a row) or an
    immediate; x f32 or bf16 (read as bf16)."""
    rng = np.random.default_rng(ML.EW_OPS.index(op))
    x = _special_rows(rng, 301, 37, x_dtype)
    if op == "pow":  # negative bases meet integer and fractional exponents
        other = torch.from_numpy(rng.choice([2.0, 3.0, 0.5, -1.0, 0.0, -2.5], 37 if shape ==
                                            "per_column" else (301, 1)).astype(np.float32))
    else:
        other = _special_rows(rng, 301, 37)[:, 0].contiguous()
        other = other[:37].contiguous() if shape == "per_column" else other.view(301, 1)
        other[1] = 0.0  # a division by zero
    operand = -2.5 if shape == "scalar" else "reg"
    prog = _op_prog(op, operand)
    inputs = [x] if operand != "reg" else [x, other]
    got = _ewise_emu(lib, prog, inputs, torch.empty(301, 37))
    _assert_ewise_close(got, ML.ewise_plain(prog, inputs, torch.empty(301, 37)), op,
                        torch.broadcast_to(x.float(), (301, 37)), 0.7)


def test_k16_ewise_chain_over_four_inputs_and_sixteen_instructions(lib):
    """A 16-instruction program over 4 inputs of 4 broadcast shapes (a
    z-score, a gate, clip, a mix of registers), 3-D."""
    rng = np.random.default_rng(40)
    x = torch.from_numpy(rng.standard_normal((7, 50, 12)).astype(np.float32))
    mu = torch.from_numpy(rng.standard_normal(12).astype(np.float32))
    sd = torch.from_numpy((1 + np.abs(rng.standard_normal((50, 1)))).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((7, 1, 1)).astype(np.float32)).to(torch.bfloat16)
    ins = [("sub", 4, 0, 1, 0.0), ("div", 4, 4, 2, 0.0), ("mul", 5, 4, 3, 0.0),
           ("sigmoid", 5, 5, 5, 0.0), ("add", 4, 4, 5, 0.0), ("max", 4, 4, ML.IMM, -1.5),
           ("min", 4, 4, ML.IMM, 2.0), ("neg", 6, 4, 4, 0.0), ("exp", 6, 6, 6, 0.0),
           ("tanh", 7, 4, 4, 0.0), ("mul", 6, 6, 7, 0.0), ("leaky", 6, 6, 6, 0.2),
           ("elu", 6, 6, 6, 1.3), ("sqrt", 7, 5, 5, 0.0), ("pow", 7, 7, ML.IMM, 1.5),
           ("add", 4, 6, 7, 0.0)]
    prog = ML.Program(ins, 4)
    inputs = [x, mu, sd, g]
    got = _ewise_emu(lib, prog, inputs, torch.empty(7, 50, 12))
    want = ML.ewise_plain(prog, inputs, torch.empty(7, 50, 12))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k16_ewise_strided_transpose_and_concat_on_both_axes(lib, x_dtype):
    """A Transpose as one copy through permuted strides (2-D and a 4-D
    permutation), a Concat as one copy an input into a slice of its output
    along each axis: the same bits as the plain versions."""
    rng = np.random.default_rng(41)
    copy = ML.Program([("copy", 0, 0, 0, 0.0)], 0)
    x = torch.from_numpy(rng.standard_normal((130, 24)).astype(np.float32)).to(x_dtype)
    got = _ewise_emu(lib, copy, [x.t()], torch.empty(24, 130))
    assert torch.equal(got, x.t().float())
    x4 = torch.from_numpy(rng.standard_normal((3, 5, 7, 11)).astype(np.float32)).to(x_dtype)
    v = x4.permute(2, 0, 3, 1)
    assert torch.equal(_ewise_emu(lib, copy, [v], torch.empty(v.shape)), v.float())
    a = torch.from_numpy(rng.standard_normal((130, 8)).astype(np.float32)).to(x_dtype)
    b = torch.from_numpy(rng.standard_normal((130, 1)).astype(np.float32))
    cat1 = torch.empty(130, 9)
    _ewise_emu(lib, copy, [a], cat1.narrow(1, 0, 8))
    _ewise_emu(lib, copy, [b], cat1.narrow(1, 8, 1))
    assert torch.equal(cat1, torch.cat([a.float(), b], 1))
    c = torch.from_numpy(rng.standard_normal((77, 8)).astype(np.float32))
    cat0 = torch.empty(207, 8)
    _ewise_emu(lib, copy, [a], cat0.narrow(0, 0, 130))
    _ewise_emu(lib, copy, [c], cat0.narrow(0, 130, 77))
    assert torch.equal(cat0, torch.cat([a.float(), c], 0))


def _reduce_emu(lib, x, axes, mean):
    """reduce_axis's launches over the emulated library: one a run of
    adjacent axes, the last run first, the mean's division last."""
    dims = ML._norm_axes(x.dim(), axes)
    shape, cur = list(x.shape), x
    count = int(np.prod([x.shape[d] for d in dims]))
    runs = ML._axis_runs(dims)
    for i, (a, z) in enumerate(reversed(runs)):
        outer, length = int(np.prod(shape[:a])), int(np.prod(shape[a:z + 1]))
        inner = int(np.prod(shape[z + 1:]))
        out = torch.empty(outer * inner)
        div = float(count) if mean and i == len(runs) - 1 else 1.0
        assert ML._launch_reduce(lib, cur, outer, length, inner, div, out, None) == 0
        shape[a:z + 1] = [1] * (z + 1 - a)
        cur = out.view(shape)
    return cur.view([n for k, n in enumerate(shape) if k not in dims])


_REDUCE_CASES = [
    # (label, shape, axes): the inner axis at G = 1 .. 32 lanes an output,
    # the outer axis (a thread an output), both, non-adjacent axes, and the
    # chunked two-launch split (few outputs over a long axis)
    ("inner_L1", (300, 1), [1]), ("inner_L3", (300, 3), [1]), ("inner_L8", (1000, 8), [1]),
    ("inner_L12", (300, 12), [1]), ("inner_L33", (300, 33), [1]), ("inner_L700", (40, 700), [1]),
    ("outer", (1000, 8), [0]), ("both", (1000, 8), None), ("middle", (6, 50, 7), [1]),
    ("non_adjacent", (6, 50, 7), [0, 2]), ("chunked_outer", (9000, 3), [0]),
    ("chunked_inner", (3, 9000), [1]), ("chunked_all", (300, 40), None),
]


@pytest.mark.parametrize("mean", [False, True], ids=["sum", "mean"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", _REDUCE_CASES, ids=lambda c: c[0])
def test_k16_reduce_matches_plain(lib, case, x_dtype, mean):
    _, shape, axes = case
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(x_dtype)
    got = _reduce_emu(lib, x, axes, mean)
    want = ML.reduce_axis_plain(x, axes, False, mean)
    scale = ML.reduce_axis_plain(x.float().abs(), axes, False, mean)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-7).all()), (got - want).abs().max()


# graph B's second product: alpha 0.5, + 2 C, Elu, Clip(-1, 4), Sigmoid
_HEAD_INS = [("mul", 0, 0, ML.IMM, 0.5), ("add", 0, 0, 1, 0.0), ("elu", 0, 0, 0, 1.0),
             ("max", 0, 0, ML.IMM, -1.0), ("min", 0, 0, ML.IMM, 4.0), ("sigmoid", 0, 0, 0, 0.0)]


@pytest.fixture(scope="module", params=[0, 1, 2, 3], ids=["rule", "forced_skinny",
                                                          "forced_narrow_r2", "forced_narrow_r4"])
def ml_path_lib(request, lib, tmp_path_factory):
    """ml.cu as built (the rule), and with ML_FORCE_PATH 1, 2, 3 (N <= 16
    on the skinny path, or the narrow one at 2 or 4 rows a thread)."""
    if request.param == 0:
        return 0, lib
    out = tmp_path_factory.mktemp(f"ml_force_{request.param}")
    src = f"#define ML_FORCE_PATH {request.param}\n" + _source("ml.cu")
    return request.param, _build_emu(out, {"ml.cu": src})


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,n", [(64, 1), (64, 8), (768, 10), (64, 40), (45, 8)],
                         ids=["skinny-n1", "narrow-n8", "narrow-k768-n10", "wide-n40",
                              "unaligned-k45-n8"])
def test_k16_linear_epilogue_matches_plain(ml_path_lib, k, n, x_dtype):
    """ml_linear with graph B's epilogue (alpha, + beta C as a per-column
    operand, Elu, Clip, Sigmoid) and with a one-value operand, on each path:
    N = 1 skinny, N = 8 and 10 narrow (or skinny / narrow R = 2 / R = 4
    where ML_FORCE_PATH says), N = 40 wide, K = 45 the scalar loads; 1,100
    rows."""
    force, plib = ml_path_lib
    x, w, c = _ml_inputs(k * n + force, 1100, k, n, x_dtype)
    for operand in (c, c[:1].contiguous()):
        ep = ML.Epilogue(ML.Program(_HEAD_INS, 0), [operand])
        out = torch.empty(1100, n)
        assert ML._launch_linear(plib, x, w, ep, out, None) == 0
        _assert_linear_close(out, ML.linear_act_plain(x, w, epilogue=ep), k)


def test_k16_linear_two_operands_and_an_empty_epilogue(lib):
    """Two per-column operands (r1 - r2, then r1 as a divisor; and an
    instruction reading neither side from r0, then r1 over r0) and a bare
    product (no instructions), on the three paths."""
    for n in (1, 8, 40):
        x, w, c = _ml_inputs(n + 7, 300, 64, n, torch.float32)
        d = c.abs() + 0.5
        for ins in ([("sub", 0, 0, 2, 0.0), ("div", 0, 0, 1, 0.0)],
                    [("mul", 0, 0, ML.IMM, 0.25), ("sub", 0, 1, 2, 0.0), ("div", 0, 1, 0, 0.0),
                     ("add", 0, ML.IMM, 0, -1.5)]):
            ep = ML.Epilogue(ML.Program(ins, 0), [d, c])
            out = torch.empty(300, n)
            assert ML._launch_linear(lib, x, w, ep, out, None) == 0
            _assert_linear_close(out, ML.linear_act_plain(x, w, epilogue=ep), 64)
        bare = ML.Epilogue(ML.Program([], 0))
        assert ML._launch_linear(lib, x, w, bare, out, None) == 0
        _assert_linear_close(out, x @ w, 64)


def test_k16_bad_programs_are_refused(lib):
    """An op code, a register or a length out of range: the launch is
    refused (cudaErrorInvalidValue), nothing runs."""
    x = torch.zeros(4, 3)
    bad = ML.Program([("add", 4, 0, 0, 0.0)], 4)
    desc = ML._ew_desc(bad, [x], torch.empty(4, 3))
    desc.ins[0].op = len(ML.EW_OPS)
    assert lib.ml_ewise(ctypes.byref(desc), None) != 0
    desc.ins[0].op, desc.nins = 1, 17
    assert lib.ml_ewise(ctypes.byref(desc), None) != 0
    ep = ML._epi_desc(ML.Epilogue(ML.Program([("relu", 0, 0, 0, 0.0)], 0)))
    ep.ins[0].dst = 9
    assert lib.ml_linear(x.data_ptr(), 0, torch.zeros(3, 2).data_ptr(), 4, 3, 2,
                         ctypes.byref(ep), torch.empty(4, 2).data_ptr(), None) != 0


# ------------------------------------------------------------------ mesh (K11-K15)
INF = float("inf")


def _merge_inputs(seed, nq, s, kk, shard_rows):
    """Candidates with many exact ties (quarters) and +inf picks; each
    shard's kk sorted as a shard's top-kk is."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 6, (nq, s, kk)).astype(np.float32) / 4
    d[rng.random((nq, s, kk)) < 0.2] = INF
    d = np.sort(d, axis=2).reshape(nq, s * kk)
    i = rng.integers(0, shard_rows, (nq, s * kk)).astype(np.int32)
    i[~np.isfinite(d)] = -1  # K13's misses; K11's +inf picks keep ids
    i[:, ::3] = rng.integers(0, shard_rows, i[:, ::3].shape)
    return torch.from_numpy(d), torch.from_numpy(i)


@pytest.mark.parametrize("finite_only", [False, True], ids=["k11", "k13"])
@pytest.mark.parametrize("s,kk,k_out", [(8, 10, 10), (8, 4, 20), (3, 64, 64), (1, 5, 5),
                                        (8, 64, 1)])
def test_mesh_topk_merge_matches_plain(lib, finite_only, s, kk, k_out):
    d, i = _merge_inputs(s * kk + k_out, 5, s, kk, 1000)
    got = M._launch_topk_merge(lib, d, i, kk, 1000, k_out, finite_only)
    want = M.topk_merge_plain(d, i, kk, 1000, k_out, finite_only)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_mesh_topk_merge_tie_order_is_lax_top_k(lib):
    """lax.top_k(-[1, inf, 1, inf, 0.5]) picks positions [4, 0, 2, 1, 3]:
    equal values go to the lower position first, +inf ones included."""
    d = torch.tensor([[1.0, INF, 1.0, INF, 0.5]])
    i = torch.tensor([[10, 11, 12, 13, 14]], dtype=torch.int32)
    vals, ids = M._launch_topk_merge(lib, d, i, 1, 100, 5, False)
    assert ids[0].tolist() == [414, 10, 212, 111, 313]
    assert vals[0].tolist() == [0.5, 1.0, 1.0, INF, INF]
    _, ids = M._launch_topk_merge(lib, d, i, 1, 100, 5, True)
    assert ids[0].tolist() == [414, 10, 212, -1, -1]


def test_mesh_topk_merge_above_shared_memory(lib):
    """More candidates than the merge stages in shared memory: the keys are
    read from device memory instead."""
    d, i = _merge_inputs(3, 2, 8, 1600, 5000)
    got = M._launch_topk_merge(lib, d, i, 1600, 5000, 12, False)
    want = M.topk_merge_plain(d, i, 1600, 5000, 12, False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("finite_only", [False, True], ids=["k11", "k13"])
@pytest.mark.parametrize("s,kk,k_out", [(8, 64, 257), (8, 1600, 300), (3, 200, 600)])
def test_mesh_topk_merge_rank_kernel_above_256(lib, finite_only, s, kk, k_out):
    """k_out above the warp lists' 256: the rank kernel, with its keys in
    shared memory (up to 12,288 candidates) and above."""
    d, i = _merge_inputs(s * kk + k_out, 3, s, kk, 5000)
    got = M._launch_topk_merge(lib, d, i, kk, 5000, k_out, finite_only)
    want = M.topk_merge_plain(d, i, kk, 5000, k_out, finite_only)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("corpus", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nq", [1, 11])
def test_mesh_partial_sqdist_matches_plain(lib, nq, corpus):
    """mesh_knn_2d without selection (K1's epilogue): two feature slices of
    40 and 30 columns (strided views, neither a multiple of the 32-column
    step) over 300 rows (each emulated SM's range ragged; 11 bf16 queries
    on the tensor tier): the first writes, the second adds and finishes
    with the mask."""
    rng = np.random.default_rng(nq)
    q = torch.from_numpy(rng.standard_normal((nq, 70)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((300, 70)).astype(np.float32)).to(corpus)
    mask = torch.from_numpy(rng.random(300) > 0.1)
    acc = M._launch_knn_2d(lib, q[:, :40], x[:, :40], None, False, mask)
    want = M.partial_sqdist_plain(q[:, :40], x[:, :40])
    torch.testing.assert_close(acc, want, rtol=1e-5, atol=1e-4)
    out = M._launch_knn_2d(lib, q[:, 40:], x[:, 40:], acc, True, mask)
    assert out is acc  # in place: the psum's accumulator
    want = M.partial_sqdist_plain(q[:, 40:], x[:, 40:], want, True, mask)
    assert torch.equal(torch.isinf(out), ~mask[None, :].expand(nq, -1))
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)


def _knn2d_steps(lib, q, x, widths, mask, kk):
    """K12 over one row shard on the emulated mesh_knn_2d: the feature
    slices of `widths` columns in order (strided views), the last one
    finished and selected -> (dists [Q, kk], rows [Q, kk])."""
    acc, c0 = None, 0
    for w in widths[:-1]:
        acc = M._launch_knn_2d(lib, q[:, c0:c0 + w], x[:, c0:c0 + w], acc)
        c0 += w
    return M._launch_knn_2d(lib, q[:, c0:], x[:, c0:], acc, True, mask, kk)


def _knn2d_plain(q, x, widths, mask, kk):
    acc, c0 = None, 0
    for w in widths[:-1]:
        acc = M.partial_sqdist_plain(q[:, c0:c0 + w], x[:, c0:c0 + w], acc)
        c0 += w
    return D._topk_min_stable(M.partial_sqdist_plain(q[:, c0:], x[:, c0:], acc, True, mask), kk)


def _knn2d_cases():
    cases = []
    for nq in (1, 4, 11, 64):
        for dt in (torch.float32, torch.bfloat16):
            tag = "f32" if dt == torch.float32 else "bf16"
            widths = (40, 30) if nq in (1, 11) else (24, 24, 24)
            cases.append((f"q{nq}-{tag}-{len(widths)}slices", nq, dt, widths, 10))
    cases.append(("q1-bf16-k1", 1, torch.bfloat16, (24, 24, 24), 1))
    cases.append(("q11-bf16-k256", 11, torch.bfloat16, (40, 30), 256))
    return cases


@pytest.mark.parametrize("case", _knn2d_cases(), ids=lambda c: c[0])
def test_k12_knn_2d_matches_plain(lib, case):
    """K12's step chain on one row shard of 700 rows (each emulated SM's
    range ragged), 10% masked, two rows equal: Q 1 and 4 on the streaming
    tier (query tiles 1 and 8), 11 and 64 on the tensor tier over bf16 rows
    and on 8-query streaming tiles over f32 rows; two feature slices of 40
    and 30 columns (scalar loads) or three of 24 (16-byte loads); ids equal
    up to ties at the kk-th distance, distances rtol 1e-5, atol 1e-4."""
    _label, nq, dtype, widths, kk = case
    rng = np.random.default_rng(nq * 100 + sum(widths) + kk)
    n, dim = 700, sum(widths)
    q = torch.from_numpy(rng.standard_normal((nq, dim)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
    x[n // 3] = x[n // 5]
    x = x.to(dtype)
    mask = torch.from_numpy(rng.random(n) > 0.1)
    got_d, got_i = _knn2d_steps(lib, q, x, widths, mask, kk)
    want_d, want_i = _knn2d_plain(q, x, widths, mask, kk)
    assert got_i.dtype == torch.int32 and got_d.shape == (nq, kk)
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-4)
    assert _ids_up_to_kth_ties(got_d, got_i, want_d, want_i)


@pytest.mark.parametrize("nq", [1, 12])
def test_k12_ties_at_the_kth_take_the_lower_row(lib, nq):
    """Equal rows: every distance ties, so the kk picks are the lowest live
    rows, in order, exactly (both tiers); every 7th row is masked."""
    x = torch.ones(900, 48, dtype=torch.bfloat16)
    q = torch.full((nq, 48), 0.5)
    mask = torch.ones(900, dtype=torch.bool)
    mask[::7] = False
    got = _knn2d_steps(lib, q, x, (16, 32), mask, 20)
    want = _knn2d_plain(q, x, (16, 32), mask, 20)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# K13: sharded tables built as IvfState._device_sharded lays them out
def _k13_tables(rng, n_shards, cap, n_lists, lmax, fill, dim, dtype, metric):
    """Rows [S * cap, D] and per-shard tables [S, C, L]: "packed" lists
    hold their members from position 0, "holes" at scattered positions
    (the rest padding with out-of-range rows); a quarter of the (shard,
    list) buckets are empty."""
    x = rng.standard_normal((n_shards * cap, dim)).astype(np.float32)
    if metric == "jaccard":
        x = np.abs(x)
    rows = np.full((n_shards, n_lists, lmax), cap + 3, dtype=np.int32)
    lmask = np.zeros((n_shards, n_lists, lmax), dtype=bool)
    for s in range(n_shards):
        for c in range(n_lists):
            n = 0 if rng.random() < 0.25 else int(rng.integers(1, lmax + 1))
            where = np.arange(n) if fill == "packed" else np.sort(rng.choice(lmax, n, replace=False))
            rows[s, c, where] = rng.choice(cap, n, replace=False)
            lmask[s, c, where] = True
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(rows), torch.from_numpy(lmask))


def _k13_emu(lib, q, probes, x, list_rows, list_mask, slot_ok, metric, k, groups=None):
    """K3's ivf_rerank over every shard (the plan's mode; `groups` forces a
    pair-major split of each list into that many ranges), then
    mesh_topk_merge, emulated."""
    n_sh, _, lmax = list_rows.shape
    nq, nprobe = probes.shape
    kk = min(k, nprobe * lmax)
    plan = IVF.rerank_plan(lib, nq, n_sh, nprobe, lmax, kk, x.shape[1],
                           int(x.dtype == torch.bfloat16))
    if groups is not None:
        plan = ("pair", groups, min(kk, ((lmax + groups - 1) // groups + 31) // 32 * 32))
    d, i = IVF._launch_rerank(lib, q, probes, x, list_rows, list_mask, slot_ok, metric, plan)
    return M._launch_topk_merge(lib, d, i, nprobe * plan[1] * plan[2], x.shape[0] // n_sh,
                                min(k, n_sh * kk), True)


def _k13_plain(q, probes, x, list_rows, list_mask, slot_ok, metric, k):
    """The reference composition: K3's plain rerank a shard, the merge."""
    n_sh, _, lmax = list_rows.shape
    cap = x.shape[0] // n_sh
    kk = min(k, probes.shape[1] * lmax)
    parts = [IVF.ivf_rerank_plain(q, probes, list_rows[s], list_mask[s], x[s * cap:(s + 1) * cap],
                                  torch.ones(cap, dtype=torch.bool) if slot_ok is None
                                  else slot_ok[s * cap:(s + 1) * cap], metric, kk)
             for s in range(n_sh)]
    return M.topk_merge_plain(torch.cat([p[0] for p in parts], 1),
                              torch.cat([p[1] for p in parts], 1), kk, cap,
                              min(k, n_sh * kk), True)


def _assert_k13_matches(got, want):
    """Misses (+inf / -1) where the plain version has them; finite
    distances rtol 1e-5, atol 1e-4; an id that differs lies at a tie with
    the k-th finite distance (f32 sums in another order)."""
    (gd, gi), (wd, wi) = got, want
    assert gd.shape == wd.shape and gi.dtype == torch.int32
    miss = torch.isinf(wd)
    assert torch.equal(torch.isinf(gd), miss) and torch.equal(gi[miss], wi[miss])
    torch.testing.assert_close(gd[~miss], wd[~miss], rtol=1e-5, atol=1e-4)
    for r in range(gd.shape[0]):
        if miss[r].all():
            continue
        kth = float(wd[r][~miss[r]].max())
        for c in (gi[r] != wi[r]).nonzero()[:, 0].tolist():
            assert abs(float(gd[r, c]) - kth) <= 1e-4 + 1e-5 * abs(kth), (r, c)


def _k13_cases():
    return [
        # label, shards, fill, metric, rows dtype, k, slot_ok share, groups
        ("s1-packed-euclidean", 1, "packed", "euclidean", torch.bfloat16, 10, None, None),
        ("s1-holes-euclidean-3ranges", 1, "holes", "euclidean", torch.float32, 10, None, 3),
        ("s3-holes-cosine", 3, "holes", "cosine", torch.float32, 10, None, None),
        ("s3-packed-manhattan-slotok", 3, "packed", "manhattan", torch.bfloat16, 10, 3, None),
        ("s8-packed-pearson", 8, "packed", "pearson", torch.float32, 10, None, None),
        ("s8-holes-euclidean-slotok", 8, "holes", "euclidean", torch.bfloat16, 10, 3, 2),
        ("s8-packed-cosine-k-above", 8, "packed", "cosine", torch.bfloat16, 3000, None, None),
        ("s1-holes-manhattan-k-above", 1, "holes", "manhattan", torch.float32, 300, 3, 3),
    ]


@pytest.mark.parametrize("case", _k13_cases(), ids=lambda c: c[0])
def test_k13_ivf_rerank_matches_plain(lib, case):
    """K13's rerank over 1, 3 and 8 shards of one tensor, then the merge,
    against K3's plain rerank a shard and the plain merge: packed lists and
    lists with holes (padding rows out of range), empty buckets, slot_ok
    masking every third slot, a list split in 2 or 3 ranges, k above the
    probed candidates (misses +inf / -1); 32-position chunks, L = 96."""
    _label, n_sh, fill, metric, dtype, k, every, groups = case
    rng = np.random.default_rng(n_sh * 10 + k + len(metric))
    cap, n_lists, lmax, dim, nq, nprobe = 120, 6, 96, 24, 3, 3
    x, rows, lmask = _k13_tables(rng, n_sh, cap, n_lists, lmax, fill, dim, dtype, metric)
    slot_ok = None if every is None else torch.from_numpy(np.arange(n_sh * cap) % every != 0)
    q = torch.from_numpy(rng.standard_normal((nq, dim)).astype(np.float32))
    probes = torch.from_numpy(np.stack([rng.choice(n_lists, nprobe, replace=False)
                                        for _ in range(nq)]).astype(np.int32))
    got = _k13_emu(lib, q, probes, x, rows, lmask, slot_ok, metric, k, groups)
    want = _k13_plain(q, probes, x, rows, lmask, slot_ok, metric, k)
    _assert_k13_matches(got, want)
    if k > 100:
        assert torch.isinf(got[0]).any()


def _k13_tie_case(members):
    """Equal rows in 3 shards of 64 rows, 4 lists of 64 positions, the first
    `members` listed, slots in reverse position order; queries at the
    origin probing lists (2, 1) and (1, 3)."""
    n_sh, cap, n_lists, lmax = 3, 64, 4, 64
    x = torch.ones(n_sh * cap, 16, dtype=torch.bfloat16)
    rows = torch.from_numpy(np.tile(np.arange(lmax, dtype=np.int32)[::-1].copy(),
                                    (n_sh, n_lists, 1)))
    lmask = torch.zeros(n_sh, n_lists, lmax, dtype=torch.bool)
    lmask[:, :, :members] = True
    probes = torch.tensor([[2, 1], [1, 3]], dtype=torch.int32)
    return torch.zeros(2, 16), probes, x, rows, lmask


@pytest.mark.parametrize("groups", [1, 3])
def test_k13_ties_across_probes_and_shards_take_the_lower_position(lib, groups):
    """Equal rows in every list of every shard: every distance ties, so the
    picks are taken in (shard, probe rank, position) order, exactly; an
    empty bucket on shard 0, and shard 1's first member dropped by
    slot_ok."""
    q, probes, x, rows, lmask = _k13_tie_case(5)
    lmask[0, 2] = False
    slot_ok = torch.ones(x.shape[0], dtype=torch.bool)
    slot_ok[64 + rows[1, 1, 0]] = False
    got = _k13_emu(lib, q, probes, x, rows, lmask, slot_ok, "euclidean", 12, groups)
    want = _k13_plain(q, probes, x, rows, lmask, slot_ok, "euclidean", 12)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k13_every_probed_list_empty_on_a_shard(lib):
    """Shard 1 holds no member of any probed list: it contributes only
    misses, and the others' picks come back as the plain version's."""
    rng = np.random.default_rng(13)
    x, rows, lmask = _k13_tables(rng, 3, 100, 5, 64, "packed", 20, torch.bfloat16, "euclidean")
    lmask[1] = False
    q = torch.from_numpy(rng.standard_normal((2, 20)).astype(np.float32))
    probes = torch.tensor([[0, 1, 2], [4, 3, 2]], dtype=torch.int32)
    got = _k13_emu(lib, q, probes, x, rows, lmask, None, "euclidean", 10)
    _assert_k13_matches(got, _k13_plain(q, probes, x, rows, lmask, None, "euclidean", 10))
    assert not (got[1] >= 100).logical_and(got[1] < 200).any()


@pytest.mark.parametrize("one_tensor", [True, False], ids=["a-launch-a-device", "a-launch-a-shard"])
def test_k13_card_composition_matches_plain(lib, monkeypatch, one_tensor):
    """parallel/mesh.py's card composition of K13 with the emulated
    kernels: the probe, mesh_ivf_rerank once over shards that are views of
    one tensor (the mesh on one card) or once a shard (shards held apart,
    as on several cards), then the merge, against
    sharded_ivf_search_plain; a third of the slots masked."""
    monkeypatch.setattr(_cuda, "lib", lambda: lib)
    rng = np.random.default_rng(41)
    cap, n_lists, lmax, dim, k, nprobe = 64, 6, 64, 16, 10, 3
    mesh = M.make_mesh(8, devices=[torch.device("cpu")] * 8)
    x, rows, lmask = _k13_tables(rng, 8, cap, n_lists, lmax, "holes", dim, torch.bfloat16,
                                 "euclidean")
    ok = torch.from_numpy(np.arange(8 * cap) % 3 != 0)
    cents = torch.from_numpy(rng.standard_normal((n_lists, dim)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((4, dim)).astype(np.float32))
    placed = [M.shard_corpus(mesh, x), M.shard_tensor(mesh, rows, ("data",)),
              M.shard_tensor(mesh, lmask, ("data",)), M.shard_tensor(mesh, ok, ("data",))]
    if not one_tensor:
        for t in placed:
            t.base = None  # the shards stay views, but are launched one at a time
    kk = min(k, nprobe * lmax)
    M.RERANK.reset()
    got = M._ivf_search_cuda(mesh, M.replicate(mesh, cents), placed[1], placed[2], placed[0],
                             placed[3], M.replicate(mesh, q), kk, min(k, 8 * kk), nprobe,
                             "euclidean", "euclidean", "data", {})
    assert M.RERANK.launches == (1 if one_tensor else 8)
    want = M.sharded_ivf_search_plain(mesh, cents, rows, lmask, x, q, k, nprobe, slot_ok=ok)
    _assert_k13_matches(got, want)


@pytest.mark.parametrize("max_degree", [1, 4, 9, 31, 32, 33, 100])
def test_mesh_frontier_hop_matches_plain(lib, max_degree):
    """Every entry, padded ones included: a negative id wraps once, then
    every index clamps; int32 fr + 1 wraps at 2^31 - 1. At 33 and 100 the
    outputs span two windows of 2,048."""
    rng = np.random.default_rng(max_degree)
    n = 60
    deg = rng.integers(0, 7, n)
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32))
    indices = torch.from_numpy(rng.integers(0, n, int(deg.sum())).astype(np.int32))
    fr = rng.integers(0, n, 40).astype(np.int32)
    fr[[0, 3, 7, 11, 12, 20]] = [-1, n, n + 7, -n - 9, 2**31 - 1, -(2**31)]
    fr, fm = torch.from_numpy(fr), torch.from_numpy(rng.random(40) > 0.25)
    nb, valid = M._launch_frontier_hop(lib, indptr, indices, fr, fm, max_degree)
    want_nb, want_valid = M.frontier_hop_plain(indptr, indices, fr, fm, max_degree)
    assert torch.equal(nb, want_nb) and torch.equal(valid, want_valid)


def _k14_case(label):
    """(indptr, indices, frontier, mask, max_degree) of a K14 edge case."""
    rng = np.random.default_rng(len(label))
    n = 500
    deg = rng.integers(0, 12, n)
    deg[-5:] = 1  # the last rows' windows run past E
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, int(deg.sum())).astype(np.int32)
    f, md = {"past E": (13, 9), "several windows, F odd": (613, 7), "padded frontier": (96, 11),
             "unaligned outputs": (37, 5), "empty frontier": (0, 3)}[label]
    fr = rng.integers(0, n, f).astype(np.int32)
    fm = rng.random(f) > 0.2
    if label == "past E":
        fr[:6] = [n - 1, n - 2, n - 3, n, -1, 2**31 - 1]
        fm[:6] = True
    if label == "padded frontier":  # the live rows, then n masked, as chip_smoke.py pads
        fr[70:], fm[:70], fm[70:] = n, True, False
    t = torch.from_numpy
    return t(indptr), t(indices), t(fr), t(fm), md


@pytest.mark.parametrize("label", ["past E", "several windows, F odd", "padded frontier",
                                   "unaligned outputs", "empty frontier"])
def test_k14_edge_cases_match_plain(lib, label):
    """Rows whose window runs past E (clipped reads, still carried where
    invalid), F not a multiple of the 4-output quads over several windows,
    a frontier padded with the masked id n, outputs one element off the
    16-byte alignment (the byte-by-byte stores), and F = 0."""
    indptr, indices, fr, fm, md = _k14_case(label)
    out = ()
    if label == "unaligned outputs":
        nb_buf = torch.full((fr.numel() * md + 1,), -7, dtype=torch.int32)
        valid_buf = torch.ones(fr.numel() * md + 1, dtype=torch.bool)
        out = (nb_buf[1:], valid_buf[1:])
    nb, valid = M._launch_frontier_hop(lib, indptr, indices, fr, fm, md, *out)
    want_nb, want_valid = M.frontier_hop_plain(indptr, indices, fr, fm, md)
    assert torch.equal(nb, want_nb) and torch.equal(valid, want_valid)
    if out:
        assert int(nb_buf[0]) == -7 and bool(valid_buf[0])


def _k14_placed(one_tensor):
    """K14's padded-frontier case placed over a mesh of 8 CPU shards: the
    shards views of one tensor (one launch group, as on one card) or held
    apart (a launch group a shard, as on several cards)."""
    indptr, indices, fr, fm, md = _k14_case("padded frontier")
    mesh = M.make_mesh(8, devices=[torch.device("cpu")] * 8)
    placed = [M.replicate(mesh, indptr), M.replicate(mesh, indices),
              M.shard_tensor(mesh, fr, ("data",)), M.shard_tensor(mesh, fm, ("data",))]
    if not one_tensor:
        for t in placed:
            t.base = None  # the shards stay views, but are launched one at a time
    return mesh, placed, md, M.sharded_frontier_hop_plain(mesh, indptr, indices, fr, fm, md)


@pytest.mark.parametrize("one_tensor", [True, False], ids=["a-launch-a-device", "a-launch-a-shard"])
def test_k14_card_composition_matches_plain(lib, monkeypatch, one_tensor):
    """parallel/mesh.py's card composition of K14 with the emulated kernel
    (every launch group taken as one on a card): one mesh_frontier_hop over
    a frontier whose 8 shards are views of one tensor (the mesh on one
    card), or one a shard, into the merged output, against
    sharded_frontier_hop_plain."""
    monkeypatch.setattr(_cuda, "lib", lambda: lib)
    monkeypatch.setattr(M, "_on_card", lambda *ts: True)
    mesh, placed, md, want = _k14_placed(one_tensor)
    M.HOP.reset()
    got = M.sharded_frontier_hop(mesh, *placed, md)
    assert M.HOP.launches == (1 if one_tensor else 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k14_cpu_group_takes_the_plain_version(lib, monkeypatch):
    """A launch group whose tensors lie on the CPU takes the plain version
    even where the other groups launch the kernel (a mesh mixing a card's
    shards and the CPU's): here the odd shards are taken as the card's."""
    monkeypatch.setattr(_cuda, "lib", lambda: lib)
    mesh, placed, md, want = _k14_placed(False)
    on_card = M._on_card
    groups = iter(range(8))
    monkeypatch.setattr(M, "_on_card", lambda *ts: next(groups) % 2 == 1 or on_card(*ts))
    M.HOP.reset()
    got = M.sharded_frontier_hop(mesh, *placed, md)
    assert M.HOP.launches == 4
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k14_group_on_two_devices_raises():
    """A launch group whose tensors lie on two devices raises before any
    launch (its pointers cannot reach one kernel): shard 3's indptr replica
    moved to another device."""
    mesh, placed, md, _ = _k14_placed(False)
    pos = mesh.position(data=3)
    placed[0].shards[pos] = placed[0].shard(pos).to("meta")
    M.HOP.reset()
    with pytest.raises(ValueError, match="several devices"):
        M.sharded_frontier_hop(mesh, *placed, md)
    assert M.HOP.launches == 0


def _dedup_inputs(seed, n_nodes, f, dup_only=False):
    """Duplicates, masked entries, and the scatter rule's drops (at and past
    n_nodes, negative ids that stay out of range after one wrap, -1 that
    wraps to n_nodes and is cleared)."""
    rng = np.random.default_rng(seed)
    hi = min(n_nodes, 7) if dup_only else n_nodes
    nodes = rng.integers(0, max(hi, 1), f).astype(np.int32)
    nodes[:4] = nodes[4:8]
    mask = rng.random(f) > 0.15
    if not dup_only:
        nodes[[9, 10, 11, 12, 13]] = [-1, n_nodes, n_nodes + 5, -(n_nodes + 3), -(n_nodes + 1)]
        mask[[9, 10, 11, 12, 13]] = True
    return torch.from_numpy(nodes), torch.from_numpy(mask)


def _dedup_zero(sc):
    return not (bool(sc.bits.any()) or bool(sc.state.any()) or sc.dirty)


@pytest.mark.parametrize("n_nodes,f", [(40, 16), (3000, 64), (5000, 2100), (63, 100), (64, 100),
                                       (65, 100), (140_000, 3000)])
def test_mesh_dedup_frontier_matches_plain(lib, n_nodes, f):
    """The ids, order and mask exact, over a scratch left zero; n_nodes
    around a bitmap word's end, of several compaction tiles (5,000), and
    above the shared-memory marking's 131,072 (the marking in place)."""
    nodes, mask = _dedup_inputs(n_nodes, n_nodes, f)
    sc = M.DedupScratch(lib, n_nodes, torch.device("cpu"))
    got = M._launch_dedup_frontier(lib, nodes, mask, n_nodes, sc)
    want = M.dedup_frontier_plain(nodes, mask, n_nodes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) > 0 and _dedup_zero(sc)


@pytest.mark.parametrize("label", ["all masked", "duplicates only", "negative ids", "no nodes"])
def test_k15_edge_cases_match_plain(lib, label):
    """Every entry masked (all padding), a few ids repeated over F, ids
    below zero only (one wrap: -1 is slot n_nodes, cleared; -n_nodes - 1 is
    0), and n_nodes = 0 (no bitmap, every entry dropped)."""
    n_nodes = 0 if label == "no nodes" else 3000
    nodes, mask = _dedup_inputs(77, n_nodes, 500, dup_only=label == "duplicates only")
    if label == "all masked":
        mask[:] = False
    if label == "negative ids":
        nodes = torch.from_numpy(-np.random.default_rng(3).integers(1, n_nodes + 3, 500)
                                 .astype(np.int32))
    sc = M.DedupScratch(lib, n_nodes, torch.device("cpu"))
    got = M._launch_dedup_frontier(lib, nodes, mask, n_nodes, sc)
    want = M.dedup_frontier_plain(nodes, mask, n_nodes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _dedup_zero(sc)


def test_k15_back_to_back_over_one_scratch_keeps_it_zero(lib):
    """Calls of other inputs one after another over one scratch: each exact,
    the bitmap and the look-back state zero after every call."""
    n_nodes = 9000
    sc = M.DedupScratch(lib, n_nodes, torch.device("cpu"))
    for seed in range(4):
        nodes, mask = _dedup_inputs(100 + seed, n_nodes, 700 * (seed + 1))
        got = M._launch_dedup_frontier(lib, nodes, mask, n_nodes, sc)
        want = M.dedup_frontier_plain(nodes, mask, n_nodes)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), seed
        assert _dedup_zero(sc), seed


class _FailedDedup:
    """The emulated library, whose mesh_dedup_frontier runs, then leaves
    stray bits and a stray ticket in the scratch and reports an error: a
    failed call that left the scratch dirty."""

    def __init__(self, lib, sc):
        self.lib, self.sc = lib, sc

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def mesh_dedup_frontier(self, *args):
        assert self.lib.mesh_dedup_frontier(*args) == 0
        self.sc.bits[::3] = 0x01010101
        self.sc.state[0] = 5
        return 1  # cudaErrorInvalidValue


def test_k15_failed_call_dirties_the_scratch_and_the_next_call_clears_it(lib):
    n_nodes = 9000
    sc = M.DedupScratch(lib, n_nodes, torch.device("cpu"))
    nodes, mask = _dedup_inputs(5, n_nodes, 1500)
    with pytest.raises(RuntimeError, match="mesh_dedup_frontier"):
        M._launch_dedup_frontier(_FailedDedup(lib, sc), nodes, mask, n_nodes, sc)
    assert sc.dirty and bool(sc.bits.any())
    got = M._launch_dedup_frontier(lib, nodes, mask, n_nodes, sc)
    want = M.dedup_frontier_plain(nodes, mask, n_nodes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _dedup_zero(sc)


@pytest.fixture(scope="module")
def concurrent_lib(tmp_path_factory):
    """mesh.cu in the emulator's concurrent mode (a launch's blocks at once,
    the later ones ahead)."""
    return _build_emu(tmp_path_factory.mktemp("kernels_emu_concurrent"),
                      {"mesh.cu": _source("mesh.cu")}, concurrent=True)


def _dedup_concurrent(bad):
    """K15 over 5 compaction tiles, each with marked nodes, with the blocks
    of a launch run at once: the look-back must wait for the earlier
    tiles; True where a call disagrees with the plain version."""
    n_nodes = 5 * 256 * 32
    sc = M.DedupScratch(bad, n_nodes, torch.device("cpu"))
    nodes, mask = _dedup_inputs(9, n_nodes, 2500)
    got = M._launch_dedup_frontier(bad, nodes, mask, n_nodes, sc)
    want = M.dedup_frontier_plain(nodes, mask, n_nodes)
    return not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))


def test_k15_lookback_waits_with_concurrent_blocks(concurrent_lib):
    """The tiles of the compaction in flight at once, the later ones ahead:
    each waits on its predecessors' flags, and the ranks come out exact
    (the planted fault `lookback_wait_dropped` is caught here)."""
    assert not _dedup_concurrent(concurrent_lib)


def _fault_merge(k_out):
    """The merge on tied candidates at k_out (above 256: the rank kernel),
    the least of them at position 40 (warp 1's share of the lists kernel)."""

    def differs(bad):
        d, i = _merge_inputs(k_out, 3, 8, 64, 1000)
        d[:, 40] = -1.0
        got = M._launch_topk_merge(bad, d, i, 64, 1000, k_out, True)
        want = M.topk_merge_plain(d, i, 64, 1000, k_out, True)
        return not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))

    return differs


def _fault_hop(bad):
    indptr = torch.arange(11, dtype=torch.int32)
    indices = torch.arange(10, dtype=torch.int32) * 3
    fr = torch.tensor([-1, 2, -3, 4], dtype=torch.int32)
    fm = torch.ones(4, dtype=torch.bool)
    got = M._launch_frontier_hop(bad, indptr, indices, fr, fm, 2)[0]
    return not torch.equal(got, M.frontier_hop_plain(indptr, indices, fr, fm, 2)[0])


def _fault_dedup(bad):
    nodes = torch.tensor([3, -2, 1, 0], dtype=torch.int32)  # -2 wraps to node 9
    mask = torch.tensor([True, True, True, False])
    got = M._launch_dedup_frontier(bad, nodes, mask, 10, M.DedupScratch(bad, 10, "cpu"))
    want = M.dedup_frontier_plain(nodes, mask, 10)
    return not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))


def _fault_dedup_back_to_back(bad):
    """Two calls over one scratch: the second must not see the first's
    marks."""
    sc = M.DedupScratch(bad, 3000, "cpu")
    differs = []
    for seed in (1, 2):
        nodes, mask = _dedup_inputs(seed, 3000, 400)
        got = M._launch_dedup_frontier(bad, nodes, mask, 3000, sc)
        want = M.dedup_frontier_plain(nodes, mask, 3000)
        differs.append(not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])))
    return any(differs)


def _fault_k12(bad):
    """Two and three feature slices on both tiers."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((300, 48)).astype(np.float32)).to(torch.bfloat16)
    mask = torch.from_numpy(rng.random(300) > 0.1)
    differs = []
    for nq, widths in ((1, (16, 32)), (12, (16, 16, 16))):
        q = torch.from_numpy(rng.standard_normal((nq, 48)).astype(np.float32))
        got_d, got_i = _knn2d_steps(bad, q, x, widths, mask, 10)
        want_d, want_i = _knn2d_plain(q, x, widths, mask, 10)
        differs.append(not (torch.allclose(got_d, want_d, rtol=1e-5, atol=1e-4)
                            and _ids_up_to_kth_ties(got_d, got_i, want_d, want_i)))
    return any(differs)


def _fault_k13(bad):
    """The tie case (both range splits) and a packed case over 3 shards."""
    differs = []
    for groups in (1, 3):
        q, probes, x, rows, lmask = _k13_tie_case(40)
        got = _k13_emu(bad, q, probes, x, rows, lmask, None, "euclidean", 12, groups)
        want = _k13_plain(q, probes, x, rows, lmask, None, "euclidean", 12)
        differs.append(not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])))
    rng = np.random.default_rng(31)
    x, rows, lmask = _k13_tables(rng, 3, 120, 6, 96, "packed", 24, torch.float32, "euclidean")
    q = torch.from_numpy(rng.standard_normal((3, 24)).astype(np.float32))
    probes = torch.tensor([[0, 1, 2], [3, 4, 5], [5, 0, 2]], dtype=torch.int32)
    got = _k13_emu(bad, q, probes, x, rows, lmask, None, "euclidean", 10)
    want = _k13_plain(q, probes, x, rows, lmask, None, "euclidean", 10)
    try:
        _assert_k13_matches(got, want)
    except AssertionError:
        differs.append(True)
    return any(differs)


_MESH_FAULTS = {  # fault: ([(file, old, new)], the comparison that must fail)
    # the rank kernel (k_out > 256): equal keys ranked to the higher position first
    "merge_tie_order": ([("mesh.cu", "(kj == kp && j < p)", "(kj == kp && j > p)")],
                        _fault_merge(300)),
    # the lists kernel (k_out <= 256): warp 1's candidates left out
    "merge_lists_drop_a_warp": ([("mesh.cu", "for (int w = 1; w < MG_WARPS; ++w) {",
                                  "for (int w = 2; w < MG_WARPS; ++w) {")], _fault_merge(10)),
    # a negative frontier id clamped without the wrap
    "hop_no_wrap": ([("mesh.cu", "if (i < 0) i += n;", "")], _fault_hop),
    # a negative node id dropped without the scatter's wrap
    "dedup_no_wrap": ([("mesh.cu", "if (v[k] < 0) v[k] += (long long)n_nodes + 1;", "")],
                      _fault_dedup),
    # K15's compaction leaves the words it read set
    "dedup_word_not_cleared": ([("mesh.cu", "  if (word != 0u) bits[w0 + threadIdx.x] = 0u;\n",
                                 "")], _fault_dedup_back_to_back),
    # the look-back takes a predecessor's flag as it finds it, published or
    # not (shared by K6, K9 and K15; caught with the blocks run at once)
    "lookback_wait_dropped": ([("lookback.cuh",
                                "      while (__ballot_sync(0xffffffffu, (f >> 32) == 0) != 0u)\n"
                                "        if ((f >> 32) == 0) f = lb_peek(&flags[p]);\n", "")],
                              _dedup_concurrent),
    # K12: the accumulator input dropped (the last slice alone), both tiers
    "k12_accumulator_dropped": ([
        ("knn.cuh", "    if (acc_in != nullptr) v = acc_in[(long long)qi * N + row] + v;\n", ""),
        ("knn_tq.cuh",
         "            if (view.acc_in != nullptr) d = view.acc_in[(long long)qi * N + row] + d;\n",
         "")], _fault_k12),
    # K13 (ivf.cu's pair-major rerank): among equal distances the higher
    # probe rank and range first
    "k13_ties_take_the_higher_position": ([
        ("ivf.cu", "const long long o = (qsp * G + g) * kkb;",
         "const long long o = ((qsp / P * P + (P - 1 - pr)) * G + (G - 1 - g)) * kkb;")],
        _fault_k13),
    # K13: a range's first chunk skipped, members and all
    "k13_chunk_skipped": ([("ivf.cu", "if (todo == 0u) continue;",
                            "if (todo == 0u || c0 == lo) continue;")], _fault_k13),
    # K13: every shard reads shard 0's rows
    "k13_shard_rows_offset_dropped": ([("ivf.cu", "\n  const T* xs = x + (long long)s * cap * D;",
                                        "\n  const T* xs = x;")], _fault_k13),
    # the merge without the shard offset of a candidate's slot
    "shard_offset_dropped": ([("mesh.cu", "const long long gid = (long long)ids[p] + shard * shard_rows;",
                               "const long long gid = (long long)ids[p];")], _fault_k13),
}


@pytest.mark.parametrize("fault", sorted(_MESH_FAULTS))
def test_mesh_planted_fault_fails_the_comparison(tmp_path, fault):
    """The comparisons above have teeth: a copy of mesh.cu (or of the
    headers its K12 instances share with K1/K2, or of ivf.cu, whose rerank
    K13 runs) with one fault planted disagrees with the plain versions."""
    patches, differs = _MESH_FAULTS[fault]
    srcs = {"mesh.cu": _source("mesh.cu")}
    if differs is _fault_k13:
        srcs["ivf.cu"] = _source("ivf.cu")
    for name, old, new in patches:
        srcs.setdefault(name, _source(name))
        assert srcs[name].count(old) == 1, old
        srcs[name] = srcs[name].replace(old, new)
    assert differs(_build_emu(tmp_path, srcs, concurrent=differs is _dedup_concurrent))
