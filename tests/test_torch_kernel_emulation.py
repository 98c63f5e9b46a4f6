"""The CUDA kernels' logic (surrealdb_tpu_torch/csrc/knn.cu), run on the CPU
under the emulation header csrc/emu/cuda_emu.h and held against the plain
PyTorch versions.

The source is compiled with the host C++ compiler: CUDA qualifiers become
no-ops, `__shared__` arrays become function statics (blocks run one after
another), each CUDA thread is an OS thread, and __syncthreads and the warp
intrinsics are barriers. This checks indexing, barriers, tie order and
masking at small shapes — not speed, and not what only the card can show
(it builds, launches and agrees there: chip_smoke.py). Skipped where there
is no C++20 compiler.

Tolerances: K1 rtol 1e-5, atol 1e-4 (f32 sums in another order); K2 exact,
since both sides select from the same distances.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from surrealdb_tpu_torch.ops import _cuda
from surrealdb_tpu_torch.ops import distances as D

CSRC = _cuda.CSRC


def _translate(src: str) -> str:
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace("#include <cuda_bf16.h>", "")
    src = src.replace(
        "extern __shared__ unsigned long long smem_pairs[];",
        "static unsigned long long smem_pairs[8192];",
    )
    return re.sub(
        r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);",
        lambda m: f"emu_launch({m.group(2)}, [&]{{ {m.group(1)}({m.group(3)}); }});",
        src,
        flags=re.S,
    )


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("knn_emu")
    cpp = out / "knn_emu.cpp"
    with open(os.path.join(CSRC, "knn.cu")) as f:
        cpp.write_text(_translate(f.read()))
    so = out / "libknn_emu.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         "-I", os.path.join(CSRC, "emu"), "-o", str(so), str(cpp)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    handle = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _cuda._SIGNATURES.items():
        fn = getattr(handle, name)
        fn.restype, fn.argtypes = restype, argtypes
    return handle


def _pairwise(lib, q, x, metric):
    code, p = D._metric_code(metric)
    nq, dim = q.shape
    n = x.shape[0]
    bf16 = int(x.dtype == torch.bfloat16)
    out = torch.empty((nq, n), dtype=torch.float32)
    qm = xm = None
    if metric == "pearson":
        qm, xm = torch.empty(nq), torch.empty(n)
        assert lib.knn_row_mean(q.data_ptr(), 0, nq, dim, qm.data_ptr(), None) == 0
        assert lib.knn_row_mean(x.data_ptr(), bf16, n, dim, xm.data_ptr(), None) == 0
    status = lib.knn_pairwise(
        q.data_ptr(), x.data_ptr(), bf16, nq, n, dim, code, p,
        None if qm is None else qm.data_ptr(), None if xm is None else xm.data_ptr(),
        out.data_ptr(), None,
    )
    assert status == 0
    return out


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
