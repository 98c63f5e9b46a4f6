"""K1/K2 of the PyTorch port (surrealdb_tpu_torch/ops/distances.py) against
the JAX reference (surrealdb_tpu/ops/distances.py), on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels are held against those same plain versions on the card by
chip_smoke.py. Inputs come from numpy seeds and go to both packages.

Tolerances: rtol 1e-5, atol 1e-4 — both sides are f32, summed in another
order. Inputs have no duplicate rows: near a zero distance the cancellation
in |q|^2 + |x|^2 - 2 q.x is amplified by the sqrt (one separate case below
checks a duplicate row lands within 1e-2 of zero).
"""

import numpy as np
import pytest
import torch

from surrealdb_tpu.ops import distances as R
from surrealdb_tpu_torch.ops import distances as P

METRICS = list(R.METRICS) + ["minkowski:3"]
RTOL, ATOL = 1e-5, 1e-4


def _inputs(seed, nq, n, d, metric="euclidean"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "jaccard":
        # weighted-set semantics: sum(max) of signed vectors can cancel to
        # ~0 and blow the ratio up in both packages alike
        q, x = np.abs(q), np.abs(x)
    return q, x


def assert_knn_match(ref_d, ref_i, got_d, got_i):
    """Distances agree to the tolerance (+inf exactly); index sets agree
    except for ties within 1e-5 of the k-th distance."""
    ref_d, ref_i = np.asarray(ref_d), np.asarray(ref_i)
    got_d, got_i = np.asarray(got_d), np.asarray(got_i)
    assert got_d.shape == ref_d.shape and got_i.shape == ref_i.shape
    np.testing.assert_array_equal(np.isinf(got_d), np.isinf(ref_d))
    fin = np.isfinite(ref_d)
    np.testing.assert_allclose(got_d[fin], ref_d[fin], rtol=RTOL, atol=ATOL)
    for r in range(ref_i.shape[0]):
        kth = ref_d[r, -1]
        a, b = set(ref_i[r].tolist()), set(got_i[r].tolist())
        for j in range(ref_i.shape[1]):
            if ref_i[r, j] not in b:
                assert abs(ref_d[r, j] - kth) <= 1e-5 * max(1.0, abs(kth)), (r, j)
            if got_i[r, j] not in a:
                assert abs(got_d[r, j] - kth) <= 1e-5 * max(1.0, abs(kth)), (r, j)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("nq", [1, 8])
@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distance_matches_reference(metric, nq, d):
    q, x = _inputs(1000 + nq * d, nq, 256, d, metric)
    want = np.asarray(R.pairwise_distance(q, x, metric))
    got = P.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), metric)
    assert got.dtype == torch.float32 and got.shape == (nq, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_pairwise_distance_duplicate_row_is_near_zero():
    q, x = _inputs(3, 4, 256, 64)
    x[17] = q[2]
    got = P.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), "euclidean").numpy()
    want = np.asarray(R.pairwise_distance(q, x, "euclidean"))
    assert got[2, 17] <= 1e-2
    assert want[2, 17] <= 1e-2


def test_pairwise_distance_bf16_corpus_upcasts():
    q, x = _inputs(5, 8, 256, 64)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = P.pairwise_distance(torch.from_numpy(q), xb, "euclidean")
    want = P.pairwise_distance_plain(torch.from_numpy(q), xb.float(), "euclidean")
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 10, 256])
@pytest.mark.parametrize("nq", [1, 8, 64])
def test_knn_search_matches_reference(nq, k):
    q, x = _inputs(2000 + nq + k, nq, 256, 32)
    mask = np.ones(256, dtype=bool)
    mask[200:] = False  # pad rows, as pad_rows leaves them
    mask[[3, 77, 150]] = False  # tombstoned slots
    ref_d, ref_i = R.knn_search(q, x, mask, "euclidean", k)
    got_d, got_i = P.knn_search(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(mask), "euclidean", k
    )
    assert got_i.dtype == torch.int32 and np.asarray(ref_i).dtype == np.int32
    assert_knn_match(ref_d, ref_i, got_d.numpy(), got_i.numpy())


@pytest.mark.parametrize("metric", ["cosine", "manhattan", "pearson"])
def test_knn_search_other_metrics_match_reference(metric):
    q, x = _inputs(11, 8, 256, 16, metric)
    mask = np.ones(256, dtype=bool)
    ref_d, ref_i = R.knn_search(q, x, mask, metric, 10)
    got_d, got_i = P.knn_search(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(mask), metric, 10
    )
    assert_knn_match(ref_d, ref_i, got_d.numpy(), got_i.numpy())


@pytest.mark.parametrize("nq", [1, 8])
def test_ivf_probe_shape_matches_reference(nq):
    """The IVF probe's shape: queries against 1,024 f32 centroids of 768
    columns, k = nprobe (default_nprobe(1024, ef=64) = 6), through the
    reference's jitted knn_search and pairwise_distance."""
    from surrealdb_tpu_torch.idx.ivf import default_nprobe

    k = default_nprobe(1024, 64)
    q, cents = _inputs(4000 + nq, nq, 1024, 768)
    ok = np.ones(1024, dtype=bool)
    ref_d, ref_i = R.knn_search(q, cents, ok, "euclidean", k)
    got_d, got_i = P.knn_search(torch.from_numpy(q), torch.from_numpy(cents),
                                torch.from_numpy(ok), "euclidean", k)
    assert got_i.shape == (nq, 6)
    assert_knn_match(ref_d, ref_i, got_d.numpy(), got_i.numpy())
    want = np.asarray(R.pairwise_distance(q, cents, "euclidean"))
    got = P.pairwise_distance(torch.from_numpy(q), torch.from_numpy(cents), "euclidean")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_knn_search_tie_order_is_lower_index_first():
    """All rows equal: every distance ties, so top_k's order is the index
    order, masked rows last as +inf — lax.top_k's tie order."""
    x = np.zeros((64, 8), dtype=np.float32)
    q = np.zeros((2, 8), dtype=np.float32)
    mask = np.ones(64, dtype=bool)
    mask[::5] = False
    ref_d, ref_i = R.knn_search(q, x, mask, "euclidean", 64)
    got_d, got_i = P.knn_search(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(mask), "euclidean", 64
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))


def test_cpu_tensors_launch_no_kernel():
    q, x = _inputs(4, 2, 64, 8)
    before = [c.launches for c in P.KERNELS]
    P.knn_search(torch.from_numpy(q), torch.from_numpy(x), torch.ones(64, dtype=torch.bool),
                 "euclidean", 5)
    P.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x))
    assert [c.launches for c in P.KERNELS] == before


def test_unknown_metric_raises():
    q, x = _inputs(4, 2, 64, 8)
    with pytest.raises(ValueError):
        P.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), "nope")


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan", "jaccard"])
def test_knn_search_host_matches_reference(metric):
    q, x = _inputs(21, 3, 300, 16, metric)
    ref = R.knn_search_host(q, x, metric, 7)
    got = P.knn_search_host(q, x, metric, 7)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("metric", METRICS)
def test_distance_single_matches_reference(metric):
    rng = np.random.default_rng(31)
    for _ in range(4):
        a = rng.standard_normal(12).tolist()
        b = rng.standard_normal(12).tolist()
        assert P.distance_single(a, b, metric) == R.distance_single(a, b, metric)
    zero = [0.0] * 12
    assert P.distance_single(zero, zero, metric) == R.distance_single(zero, zero, metric)


def test_pad_rows_matches_reference():
    x = np.random.default_rng(2).standard_normal((130, 4)).astype(np.float32)
    for a, b in zip(P.pad_rows(x, 128), R.pad_rows(x, 128)):
        np.testing.assert_array_equal(a, b)
