"""The mesh slice of the PyTorch port (surrealdb_tpu_torch/parallel/mesh.py:
K11 sharded_knn, K12 sharded_knn_2d, K13 sharded_ivf_search, K14
sharded_frontier_hop, K15 dedup_frontier; IvfState's sharded tables and
search; the mesh strategies of KnnPlan; parallel/dryrun.py) held against
the JAX reference on the same seeded inputs. The reference runs on the
suite's 8-device CPU mesh (tests/conftest.py); the port on a mesh of eight
shards on the CPU, `make_mesh(8, devices=[cpu] * 8)`, i.e. the plain
PyTorch versions of its kernels.

Tolerances: distances rtol 1e-5, atol 1e-4 (f32 sums in another order);
ids and every integer output exact, ids allowed to differ only at ties
within that tolerance of the k-th distance; misses (+inf / -1) and the ids
the reference returns beside +inf distances exact.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as JP

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu import telemetry as rtel
from surrealdb_tpu.idx import ivf as RIVF
from surrealdb_tpu.kvs.ds import Datastore as RDatastore
from surrealdb_tpu.parallel import mesh as RM
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch import telemetry as ptel
from surrealdb_tpu_torch.idx import ivf as PIVF
from surrealdb_tpu_torch.idx import knn as PKNN
from surrealdb_tpu_torch.kvs.ds import Datastore as PDatastore
from surrealdb_tpu_torch.parallel import dryrun as PDRY
from surrealdb_tpu_torch.parallel import mesh as PM

TOL = dict(rtol=1e-5, atol=1e-4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rmesh():
    assert len(jax.devices()) == 8, "tests require the 8-device CPU mesh"
    return RM.make_mesh(8)


@pytest.fixture(scope="module")
def pmesh():
    return PM.make_mesh(8, devices=[CPU] * 8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jput(mesh, a, spec):
    return jax.device_put(a, NamedSharding(mesh, spec))


def _assert_topk_match(ref_d, ref_i, got_d, got_i):
    """Distances within TOL; misses identical; ids equal except at ties
    within TOL of the k-th distance (the largest finite one); where the
    reference's distance is +inf its id must match exactly."""
    ref_d, ref_i = np.asarray(ref_d), np.asarray(ref_i)
    got_d, got_i = np.asarray(got_d), np.asarray(got_i)
    assert got_d.shape == ref_d.shape and got_i.shape == ref_i.shape
    miss = ~np.isfinite(ref_d)
    np.testing.assert_array_equal(~np.isfinite(got_d), miss)
    np.testing.assert_array_equal(got_i[miss], ref_i[miss])
    np.testing.assert_allclose(got_d[~miss], ref_d[~miss], **TOL)
    for r in range(ref_d.shape[0]):
        fin = ref_d[r][np.isfinite(ref_d[r])]
        kth = float(fin.max()) if fin.size else 0.0
        band = TOL["atol"] + TOL["rtol"] * abs(kth)
        ref_set, got_set = set(ref_i[r][~miss[r]].tolist()), set(got_i[r][~miss[r]].tolist())
        for j in np.nonzero(got_i[r] != ref_i[r])[0]:
            if miss[r, j]:
                continue
            if got_i[r, j] in ref_set and ref_i[r, j] in got_set:
                continue  # an order swap between equal distances
            assert abs(float(ref_d[r, j]) - kth) <= band, (r, j, ref_d[r], got_d[r])


# ------------------------------------------------------------------ mesh, placement
def test_make_mesh_repeats_one_device_and_shards_are_views(pmesh):
    assert pmesh.shape == {"data": 8} and pmesh.axis_names == ("data",)
    assert pmesh.distinct_devices == [CPU] and pmesh.merge_device == CPU
    x = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    st = PM.shard_corpus(pmesh, x)
    assert st.shape == (64, 4) and st.base is not None
    for s in range(8):
        part = st.shard((s,))
        assert part.data_ptr() == st.base[s * 8].data_ptr()  # a view, no copy
        np.testing.assert_array_equal(part.numpy(), x[s * 8:(s + 1) * 8])
    assert st.nbytes() == x.nbytes


def test_shard_tensor_2d_spec_and_replication():
    mesh = PM.Mesh([CPU] * 8, ("data", "model"), (4, 2))
    x = np.arange(32 * 8, dtype=np.float32).reshape(32, 8)
    st = PM.shard_tensor(mesh, x, ("data", "model"))
    np.testing.assert_array_equal(st.shard((2, 1)).numpy(), x[16:24, 4:8])
    rep = PM.replicate(mesh, x[:3])
    assert all(rep.shard(p).data_ptr() == rep.base.data_ptr() for p in np.ndindex(4, 2))
    with pytest.raises(ValueError, match="divide"):
        PM.shard_tensor(mesh, x[:30], ("data", None))


def test_collectives_keep_shard_order():
    parts = [torch.full((2, 3), float(s)) for s in range(4)]
    g = PM.all_gather(parts, CPU)
    assert g.shape == (2, 12)
    np.testing.assert_array_equal(g[0].numpy(), np.repeat(np.arange(4.0), 3))
    np.testing.assert_array_equal(PM.psum(parts, CPU).numpy(), np.full((2, 3), 6.0))


# ------------------------------------------------------------------ K11
def _knn_inputs(seed, n, d, nq, dead=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    mask = np.ones(n, dtype=bool)
    if dead is not None:
        mask[dead] = False
    return x, mask, rng.standard_normal((nq, d)).astype(np.float32)


def _run_k11(rmesh, pmesh, x, mask, qs, k, metric):
    xc = RM.shard_corpus(rmesh, x)
    mc = _jput(rmesh, mask, JP("data"))
    qc = _jput(rmesh, qs, JP(None, None))
    rd, ri = RM.sharded_knn(rmesh, xc, mc, qc, k, metric)
    pd, pi = PM.sharded_knn(pmesh, PM.shard_corpus(pmesh, x),
                            PM.shard_tensor(pmesh, mask, ("data",)), _t(qs), k, metric)
    assert pd.dtype == torch.float32 and pi.dtype == torch.int32
    return (np.asarray(rd), np.asarray(ri)), (pd.numpy(), pi.numpy())


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("nq,k", [(1, 10), (5, 7), (16, 3)])
def test_k11_sharded_knn_matches_reference(rmesh, pmesh, metric, nq, k):
    x, mask, qs = _knn_inputs(11 + nq, 256, 16, nq, dead=np.arange(0, 256, 9))
    ref, got = _run_k11(rmesh, pmesh, x, mask, qs, k, metric)
    _assert_topk_match(*ref, *got)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_k11_shard_with_fewer_live_rows_than_k(rmesh, pmesh, metric):
    """Shard 2 keeps 2 live rows and the whole corpus 15 of 64: k = 20
    returns +inf picks, whose ids the reference still returns (the
    lowest-index dead rows of the first shards in merge order)."""
    n = 64
    live = [0, 1, 2, 3, 4, 5, 6, 8, 17, 19, 24, 32, 40, 48, 56]
    x, mask, qs = _knn_inputs(5, n, 8, 3, dead=np.setdiff1d(np.arange(n), live))
    ref, got = _run_k11(rmesh, pmesh, x, mask, qs, 20, metric)
    assert np.isinf(ref[0]).any()
    _assert_topk_match(*ref, *got)
    np.testing.assert_array_equal(got[1], ref[1])  # every id, +inf picks included


def test_k11_ties_at_the_kth_distance(rmesh, pmesh):
    """Small integers, so every distance is exact in any summation order:
    four equal rows in four shards tie at the query's two nearest, and
    lax.top_k's lower position wins the ties, in both packages."""
    rng = np.random.default_rng(8)
    x = rng.integers(-3, 4, (128, 8)).astype(np.float32)
    for r in (19, 32, 81):
        x[r] = x[3]
    qs = rng.integers(-3, 4, (3, 8)).astype(np.float32)
    qs[0] = x[3] + np.eye(8, dtype=np.float32)[0]
    ref, got = _run_k11(rmesh, pmesh, x, np.ones(128, dtype=bool), qs, 2, "euclidean")
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert ref[1][0].tolist() == [3, 19]


def test_k11_matches_single_device_k2(pmesh):
    """test_mesh.py's test_sharded_knn_matches_single_device, on the port."""
    from surrealdb_tpu_torch.ops import distances as D

    x, mask, qs = _knn_inputs(1, 64, 16, 5)
    pd, pi = PM.sharded_knn(pmesh, PM.shard_corpus(pmesh, x),
                            PM.shard_tensor(pmesh, mask, ("data",)), _t(qs), 7)
    sd, si = D.knn_search(_t(qs), _t(x), _t(mask), "euclidean", 7)
    np.testing.assert_allclose(pd.numpy(), sd.numpy(), atol=1e-4)
    for a, b in zip(pi.numpy(), si.numpy()):
        assert set(a.tolist()) == set(b.tolist())


def test_k11_jit_closure_is_cached(pmesh):
    f = PM.sharded_knn_jit(pmesh, 5, "euclidean")
    assert PM.sharded_knn_jit(pmesh, 5, "euclidean") is f
    x, mask, qs = _knn_inputs(2, 64, 8, 2)
    d, i = f(PM.shard_corpus(pmesh, x), PM.shard_tensor(pmesh, mask, ("data",)), _t(qs))
    assert d.shape == (2, 5) and i.shape == (2, 5)


# ------------------------------------------------------------------ merge
def test_topk_merge_tie_order_is_lax_top_k():
    d = torch.tensor([[1.0, float("inf"), 1.0, float("inf"), 0.5]])
    i = torch.tensor([[10, 11, 12, 13, 14]], dtype=torch.int32)
    vals, ids = PM.topk_merge_plain(d, i, 5, 0, 5, False)
    np.testing.assert_array_equal(ids.numpy()[0], [14, 10, 12, 11, 13])
    want = jax.lax.top_k(-jnp.asarray(d.numpy()), 5)[1]
    np.testing.assert_array_equal(np.asarray(want)[0], [4, 0, 2, 1, 3])
    _, ids = PM.topk_merge(d, i, 1, 100, 5, True)  # five shards of one
    np.testing.assert_array_equal(ids.numpy()[0], [414, 10, 212, -1, -1])


# ------------------------------------------------------------------ K12
@pytest.mark.parametrize("nq,k", [(3, 5), (8, 12), (64, 10)])
def test_k12_sharded_knn_2d_matches_reference(pmesh, nq, k):
    rng = np.random.default_rng(2 + nq)
    n, d = 32, 8
    x = rng.standard_normal((n, d)).astype(np.float32)
    mask = np.ones(n, dtype=bool)
    mask[[3, 9, 10, 30]] = False
    qs = rng.standard_normal((nq, d)).astype(np.float32)
    jm = JMesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    rd, ri = RM.sharded_knn_2d(jm, _jput(jm, x, JP("data", "model")), _jput(jm, mask, JP("data")),
                               _jput(jm, qs, JP(None, "model")), k)
    mesh = PM.Mesh([CPU] * 8, ("data", "model"), (4, 2))
    args = (mesh, PM.shard_tensor(mesh, x, ("data", "model")),
            PM.shard_tensor(mesh, mask, ("data",)), PM.shard_tensor(mesh, qs, (None, "model")), k)
    pd, pi = PM.sharded_knn_2d(*args)
    _assert_topk_match(rd, ri, pd.numpy(), pi.numpy())
    # the in-place accumulation equals the psum of the partials
    qd, qi = PM.sharded_knn_2d_plain(*args)
    np.testing.assert_array_equal(pd.numpy(), qd.numpy())
    np.testing.assert_array_equal(pi.numpy(), qi.numpy())


@pytest.mark.parametrize("one_device", [True, False])
def test_launch_groups_cover_every_shard_in_order(one_device):
    """K12's and K13's launch groups: on one device one group over the
    bases (feature parts as column slices); with shards on several cards
    (no base) one group a row shard, its feature parts the shards at (row,
    feature), a part not split over features its replica there."""
    mesh = PM.Mesh([CPU] * 8, ("data", "model"), (4, 2))
    x = torch.arange(16 * 6, dtype=torch.float32).reshape(16, 6)
    mask = torch.arange(16) % 3 != 0
    placed = [PM.shard_tensor(mesh, x, ("data", "model")), PM.shard_tensor(mesh, mask, ("data",))]
    if not one_device:
        for t in placed:
            t.base = None
    groups = PM._launch_groups(mesh, "data", placed, "model")
    rows = [slice(0, 16)] if one_device else [slice(4 * r, 4 * r + 4) for r in range(4)]
    assert len(groups) == len(rows)
    for (xs, masks), sl in zip(groups, rows):
        assert [torch.equal(p, x[sl, 3 * m:3 * m + 3]) for m, p in enumerate(xs)] == [True] * 2
        assert [torch.equal(p, mask[sl]) for p in masks] == [True] * 2
    flat = PM._launch_groups(mesh, "data", placed[1:])
    assert [torch.equal(g[0], mask[sl]) for g, sl in zip(flat, rows)] == [True] * len(rows)


def test_k12_partial_steps_accumulate_in_feature_order():
    rng = np.random.default_rng(4)
    q = _t(rng.standard_normal((3, 12)).astype(np.float32))
    x = _t(rng.standard_normal((10, 12)).astype(np.float32))
    mask = torch.ones(10, dtype=torch.bool)
    mask[4] = False
    acc = PM.partial_sqdist(q[:, :6], x[:, :6])
    acc = PM.partial_sqdist(q[:, 6:], x[:, 6:], acc, finish=True, mask=mask)
    want = torch.cdist(q.double(), x.double()).float()
    want[:, 4] = float("inf")
    np.testing.assert_allclose(acc.numpy(), want.numpy(), **TOL)


# ------------------------------------------------------------------ K13
def _clustered(n, d, seed, clusters=32):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)).astype(np.float32)
    cid = rng.integers(0, clusters, size=n)
    return centers[cid] + 0.2 * rng.standard_normal((n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def trained():
    x = _clustered(2048, 16, 11)
    ref = RIVF.IvfState.train(x, np.ones(2048, dtype=bool))
    got = PIVF.ivf_from_reference(ref.centroids, ref.lists, ref.trained_n, "cpu")
    return x, ref, got


def test_device_sharded_tables_equal_reference(rmesh, pmesh, trained):
    x, ref, got = trained
    rc, rrows, rmask, rsr = ref._device_sharded(rmesh, x.shape[0])
    pc, prows, pmask, psr = got._device_sharded(pmesh, x.shape[0])
    assert psr == rsr == 256
    assert prows.shape == tuple(np.asarray(rrows).shape)
    np.testing.assert_array_equal(prows.base.numpy(), np.asarray(rrows))
    np.testing.assert_array_equal(pmask.base.numpy(), np.asarray(rmask))
    np.testing.assert_array_equal(pc.base.numpy(), np.asarray(rc))
    assert got._device_sharded(pmesh, x.shape[0])[1] is prows  # cached
    got.add(2047, x[5])  # a list mutation rebuilds (2047 is already listed: no-op add)
    got.remove(2047)
    ref.remove(2047)
    rrows2 = np.asarray(ref._device_sharded(rmesh, x.shape[0])[1])
    prows2 = got._device_sharded(pmesh, x.shape[0])[1]
    assert prows2 is not prows
    np.testing.assert_array_equal(prows2.base.numpy(), rrows2)
    ref.add(2047, x[2047])
    got.add(2047, x[2047])


def test_device_sharded_tables_with_a_remainder_and_empty_lists(rmesh, pmesh):
    """n_total not a multiple of the shard rows' list spread: slots past the
    last full shard go to the last shard; empty lists stay empty."""
    lists = [[0, 700, 3, 1029, 1000, 1026], [], [512, 128, 129], [1022]]
    cents = np.random.default_rng(1).standard_normal((4, 4)).astype(np.float32)
    ref = RIVF.IvfState(cents, [list(l) for l in lists], 10)
    got = PIVF.IvfState(cents, [list(l) for l in lists], 10)
    r = ref._device_sharded(rmesh, 1030)
    p = got._device_sharded(pmesh, 1030)
    assert p[3] == r[3] == 128
    np.testing.assert_array_equal(p[1].base.numpy(), np.asarray(r[1]))
    np.testing.assert_array_equal(p[2].base.numpy(), np.asarray(r[2]))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("nq", [1, 6])
def test_k13_sharded_ivf_search_matches_reference(rmesh, pmesh, trained, metric, nq):
    x, ref, got = trained
    rng = np.random.default_rng(21 + nq)
    qs = x[rng.integers(0, 2048, size=nq)] + rng.standard_normal((nq, 16)).astype(np.float32)
    nprobe = RIVF.default_nprobe(ref.nlists, 80)
    rd, rr = ref.search_batch_sharded(qs, rmesh, RM.shard_corpus(rmesh, x), metric, 10, nprobe)
    pd, pr = got.search_batch_sharded(qs, pmesh, PM.shard_corpus(pmesh, x), metric, 10, nprobe)
    _assert_topk_match(rd, rr, pd, pr)


def test_k13_slot_mask_and_misses_match_reference(rmesh, pmesh, trained):
    """A residual prefilter that leaves fewer than k matching candidates in
    the probed lists: the misses come back as +inf / -1 in both packages."""
    x, ref, got = trained
    rng = np.random.default_rng(5)
    qs = x[rng.integers(0, 2048, size=4)].astype(np.float32)
    slot_mask = np.arange(2048) % 97 == 0
    rd, rr = ref.search_batch_sharded(qs, rmesh, RM.shard_corpus(rmesh, x), "euclidean", 16, 2,
                                      slot_mask=slot_mask)
    pd, pr = got.search_batch_sharded(qs, pmesh, PM.shard_corpus(pmesh, x), "euclidean", 16, 2,
                                      slot_mask=slot_mask)
    assert (rr == -1).any() and np.isinf(rd).any()
    _assert_topk_match(rd, rr, pd, pr)
    assert all(slot_mask[s] for s in pr.reshape(-1) if s >= 0)


def test_k13_sharded_function_matches_reference_k_out(rmesh, pmesh, trained):
    """sharded_ivf_search itself: k above the probed candidates cuts k_out
    as the reference cuts it."""
    x, ref, got = trained
    qs = x[:3]
    rc, rrows, rmask, _ = ref._device_sharded(rmesh, x.shape[0])
    pc, prows, pmask, _ = got._device_sharded(pmesh, x.shape[0])
    big_k = 8 * 1 * int(np.asarray(rrows).shape[2]) + 50
    rd, ri = RM.sharded_ivf_search(rmesh, rc, rrows, rmask, RM.shard_corpus(rmesh, x),
                                   jnp.asarray(qs), big_k, 1)
    pd, pi = PM.sharded_ivf_search(pmesh, pc, prows, pmask, PM.shard_corpus(pmesh, x),
                                   _t(qs), big_k, 1)
    assert pd.shape == tuple(np.asarray(rd).shape)
    _assert_topk_match(rd, ri, pd.numpy(), pi.numpy())


def _hand_tables(rng, n_dev, n_lists, lmax, cap):
    """[n_dev, C, L] local-row tables made by hand: members at scattered
    positions (holes), padding rows out of range, some buckets empty."""
    rows = np.full((n_dev, n_lists, lmax), cap + 7, dtype=np.int32)
    mask = np.zeros((n_dev, n_lists, lmax), dtype=bool)
    for s in range(n_dev):
        for c in range(n_lists):
            n = int(rng.integers(0, lmax + 1))
            where = np.sort(rng.choice(lmax, n, replace=False))
            rows[s, c, where] = rng.choice(cap, n, replace=False)
            mask[s, c, where] = True
    return rows, mask


def _run_k13_tables(rmesh, pmesh, cents, rows, mask, x, qs, k, nprobe, metric):
    spec = JP("data", None, None)
    rd, ri = RM.sharded_ivf_search(rmesh, jnp.asarray(cents), _jput(rmesh, rows, spec),
                                   _jput(rmesh, mask, spec), RM.shard_corpus(rmesh, x),
                                   jnp.asarray(qs), k, nprobe, metric=metric)
    pd, pi = PM.sharded_ivf_search(pmesh, _t(cents), PM.shard_tensor(pmesh, rows, ("data",)),
                                   PM.shard_tensor(pmesh, mask, ("data",)),
                                   PM.shard_corpus(pmesh, x), _t(qs), k, nprobe, metric=metric)
    _assert_topk_match(rd, ri, pd.numpy(), pi.numpy())
    return pd.numpy(), pi.numpy()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_k13_hand_made_mask_with_holes_matches_reference(rmesh, pmesh, metric):
    """sharded_ivf_search over tables whose members sit at scattered list
    positions (the function takes any mask, not only _device_sharded's
    packed one)."""
    rng = np.random.default_rng(17)
    cap, n_lists, lmax, dim = 40, 6, 16, 8
    x = rng.standard_normal((8 * cap, dim)).astype(np.float32)
    rows, mask = _hand_tables(rng, 8, n_lists, lmax, cap)
    cents = rng.standard_normal((n_lists, dim)).astype(np.float32)
    qs = rng.standard_normal((5, dim)).astype(np.float32)
    _run_k13_tables(rmesh, pmesh, cents, rows, mask, x, qs, 10, 3, metric)


def test_k13_every_probed_list_empty_on_one_shard_matches_reference(rmesh, pmesh):
    """Shard 3 holds no member of any list: it yields only misses, and no
    id of its slots comes back."""
    rng = np.random.default_rng(19)
    cap, n_lists, lmax, dim = 40, 6, 16, 8
    x = rng.standard_normal((8 * cap, dim)).astype(np.float32)
    rows, mask = _hand_tables(rng, 8, n_lists, lmax, cap)
    mask[3] = False
    cents = rng.standard_normal((n_lists, dim)).astype(np.float32)
    qs = rng.standard_normal((4, dim)).astype(np.float32)
    _, pi = _run_k13_tables(rmesh, pmesh, cents, rows, mask, x, qs, 12, 2, "euclidean")
    assert not ((pi >= 3 * cap) & (pi < 4 * cap)).any()


def test_sharded_ivf_matches_single_device(pmesh):
    """test_mesh.py's test_sharded_ivf_matches_single_device, on the port."""
    rng = np.random.default_rng(9)
    x = _clustered(4096, 32, 9, clusters=64)
    ivf = PIVF.IvfState.train(x, np.ones(4096, dtype=bool), device="cpu")
    nprobe = PIVF.default_nprobe(ivf.nlists, 80)
    qs = x[rng.integers(0, 4096, size=8)] + 0.05 * rng.standard_normal((8, 32)).astype(np.float32)
    d_ref, s_ref = ivf.search_batch(qs, _t(x), "euclidean", 10, nprobe)
    d_sh, s_sh = ivf.search_batch_sharded(qs, pmesh, PM.shard_corpus(pmesh, x), "euclidean", 10,
                                          nprobe)
    np.testing.assert_allclose(np.sort(d_sh, axis=1), np.sort(d_ref, axis=1), atol=1e-4)
    for a, b in zip(s_sh, s_ref):
        assert set(a.tolist()) == set(b.tolist())


def test_sharded_ivf_respects_slot_mask(pmesh):
    """test_mesh.py's test_sharded_ivf_respects_slot_mask, on the port."""
    rng = np.random.default_rng(11)
    x = _clustered(2048, 16, 11)
    ivf = PIVF.IvfState.train(x, np.ones(2048, dtype=bool), device="cpu")
    nprobe = PIVF.default_nprobe(ivf.nlists, 80)
    slot_mask = np.arange(2048) % 3 == 0
    qs = x[rng.integers(0, 2048, size=6)].astype(np.float32)
    d_sh, s_sh = ivf.search_batch_sharded(qs, pmesh, PM.shard_corpus(pmesh, x), "euclidean", 8,
                                          nprobe, slot_mask=slot_mask)
    for row in s_sh:
        for s in row.tolist():
            if s >= 0:
                assert slot_mask[s], s
    d_ref, s_ref = ivf.search_batch_launch(qs, _t(x), "euclidean", 8, nprobe,
                                           slot_mask=slot_mask)()
    np.testing.assert_allclose(np.sort(d_sh, axis=1), np.sort(d_ref, axis=1), atol=1e-4)
    for a, b in zip(s_sh, s_ref):
        assert set(a.tolist()) == set(b.tolist())


# ------------------------------------------------------------------ K14 / K15
def _ring_csr(n_nodes, rng, extra=40):
    src = np.concatenate([np.arange(n_nodes), rng.integers(0, n_nodes, extra)])
    dst = np.concatenate([(np.arange(n_nodes) + 1) % n_nodes, rng.integers(0, n_nodes, extra)])
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    return np.cumsum(indptr).astype(np.int32), dst[order].astype(np.int32)


@pytest.mark.parametrize("max_degree", [1, 3, 8])
def test_k14_frontier_hop_matches_reference_on_every_entry(rmesh, pmesh, max_degree):
    """Valid and padded entries alike: negative and out-of-range frontier
    ids (wrap once, then clamp) and masked rows read what the reference
    reads."""
    rng = np.random.default_rng(max_degree)
    indptr, indices = _ring_csr(50, rng)
    fr = rng.integers(0, 50, 24).astype(np.int32)
    fr[[1, 5, 9, 13, 21]] = [-1, 50, 51, -60, 2**31 - 1]
    fm = rng.random(24) > 0.2
    rnb, rv = RM.sharded_frontier_hop(rmesh, jnp.asarray(indptr), jnp.asarray(indices),
                                      jnp.asarray(fr), jnp.asarray(fm), max_degree)
    pnb, pv = PM.sharded_frontier_hop(pmesh, _t(indptr), _t(indices), _t(fr), _t(fm), max_degree)
    np.testing.assert_array_equal(pnb.numpy(), np.asarray(rnb))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


def test_jax_gather_and_scatter_index_rules():
    """The rules K14 / K15 reproduce, as JAX applies them on the CPU."""
    p = jnp.arange(10) * 10
    np.testing.assert_array_equal(np.asarray(p[jnp.array([0, 9, 10, 12, -1, -12])]),
                                  [0, 90, 90, 90, 90, 0])
    got = PM._gather_index(torch.tensor([0, 9, 10, 12, -1, -12]), 10)
    np.testing.assert_array_equal(got.numpy(), [0, 9, 9, 9, 9, 0])
    m = np.asarray(jnp.zeros(6, bool).at[jnp.array([1, 7, -1, -9])].set(True))
    np.testing.assert_array_equal(np.nonzero(m)[0], [1, 5])


@pytest.mark.parametrize("n_nodes,f", [(40, 16), (3000, 64), (5000, 24)])
def test_k15_dedup_frontier_matches_reference(n_nodes, f):
    rng = np.random.default_rng(n_nodes)
    nodes = rng.integers(0, n_nodes, f).astype(np.int32)
    nodes[:4] = nodes[4:8]  # duplicates
    nodes[[9, 10, 11, 12]] = [-1, n_nodes, n_nodes + 5, -(n_nodes + 3)]
    mask = rng.random(f) > 0.15
    mask[[9, 10, 11, 12]] = True
    ru, rm = RM.dedup_frontier(jnp.asarray(nodes), jnp.asarray(mask), n_nodes)
    pu, pm = PM.dedup_frontier(_t(nodes), _t(mask), n_nodes)
    assert pu.dtype == torch.int32
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))


def test_cpu_tensors_launch_no_mesh_kernel(pmesh):
    for c in PM.KERNELS:
        c.reset()
    PDRY.dryrun_multichip(8, device="cpu")
    assert all(c.launches == 0 for c in PM.KERNELS)


# ------------------------------------------------------------------ dry run
def test_dryrun_multichip_matches_reference():
    """parallel/dryrun.py against the reference functions on the same
    inputs (the reference's dryrun returns nothing, so its steps are redone
    here in the same order with the same seed)."""
    out = PDRY.dryrun_multichip(8, device="cpu")
    devs = jax.devices()
    jm = JMesh(np.array(devs).reshape(4, 2), ("data", "model"))
    rng = np.random.default_rng(0)
    n_rows, dim, k = 64, 32, 4
    corpus = rng.standard_normal((n_rows, dim)).astype(np.float32)
    mask = np.ones(n_rows, dtype=bool)
    queries = rng.standard_normal((4, dim)).astype(np.float32)
    new_rows = rng.standard_normal((4, dim)).astype(np.float32)
    slots = np.arange(4) * 16
    corpus[slots] = new_rows
    rd, ri = RM.sharded_knn_2d(jm, _jput(jm, corpus, JP("data", "model")),
                               _jput(jm, mask, JP("data")), _jput(jm, queries, JP(None, "model")), k)
    _assert_topk_match(rd, ri, out["dists"].numpy(), out["idxs"].numpy())
    indptr = np.arange(33, dtype=np.int32)
    indices = ((np.arange(32) + 1) % 32).astype(np.int32)
    jm1 = JMesh(np.array(devs), ("data",))
    nb, nm = RM.sharded_frontier_hop(jm1, jnp.asarray(indptr), jnp.asarray(indices),
                                     jnp.arange(8, dtype=jnp.int32), jnp.ones(8, bool), 1)
    np.testing.assert_array_equal(out["nbrs"].numpy(), np.asarray(nb))
    u, um = RM.dedup_frontier(nb, nm, 32)
    np.testing.assert_array_equal(out["uniq"].numpy(), np.asarray(u))
    np.testing.assert_array_equal(out["umask"].numpy(), np.asarray(um))
    c1 = rng.standard_normal((64, 16)).astype(np.float32)
    d1, i1 = RM.sharded_knn(jm1, RM.shard_corpus(jm1, c1), _jput(jm1, np.ones(64, bool), JP("data")),
                            jnp.asarray(queries[:, :16]), k)
    _assert_topk_match(d1, i1, out["d1"].numpy(), out["i1"].numpy())
    x1 = rng.standard_normal((64, 16)).astype(np.float32)
    ivf = RIVF.IvfState.train(x1, np.ones(64, dtype=bool), nlists=8)
    assert out["ivf_lists"] == ivf.lists
    dd, ss = ivf.search_batch_sharded(queries[:, :16], jm1, RM.shard_corpus(jm1, x1),
                                      "euclidean", k, RIVF.default_nprobe(8, 80))
    _assert_topk_match(dd, ss, out["ivf_dists"], out["ivf_slots"])


def test_entry_matches_reference():
    import __graft_entry__ as g

    fn, args = PDRY.entry(device="cpu")
    d, i = fn(*args)
    rfn, rargs = g.entry()
    rd, ri = rfn(*rargs)
    _assert_topk_match(rd, ri, d.numpy(), i.numpy())


# ------------------------------------------------------------------ engine
def test_datastore_mesh_rule(monkeypatch):
    ds = PDatastore("memory", device="cpu")
    try:
        monkeypatch.setattr(PDatastore, "_mesh_cache", ("unset", None))
        assert ds.mesh() is None  # a CPU Datastore builds no mesh
        assert PDatastore._mesh_cache == ("unset", None)
        m = PM.make_mesh(8, devices=[CPU] * 8)
        monkeypatch.setattr(PDatastore, "_mesh_cache", ("mesh", m))
        assert ds.mesh() is m
    finally:
        ds.close()


def test_mirror_replaces_its_matrix_on_a_mesh_change(pmesh):
    x = np.random.default_rng(0).standard_normal((100, 4)).astype(np.float32)
    rids = [PKNN.Thing("t", i) for i in range(100)]
    m = PKNN.mirror_from_reference(x, np.ones(100, dtype=bool), rids, CPU)
    single, _ = m.device_view(CPU)
    assert isinstance(single, torch.Tensor) and m.device_sharded_mask() is None
    sharded, mask = m.device_view(CPU, pmesh)
    assert isinstance(sharded, PM.ShardedTensor) and sharded.shape == (128, 4)
    assert m.device_view(CPU, pmesh)[0] is sharded  # unchanged mesh: no re-placement
    dm = m.device_sharded_mask()
    assert dm.shape == (128,) and bool(dm.base[:100].all()) and not bool(dm.base[100:].any())
    np.testing.assert_array_equal(sharded.base[:100].numpy(), x)
    assert m.device_view(CPU)[0] is not single and m.device_sharded_mask() is None


# ---- SurrealQL through both packages under a mesh
DIM = 32
N_ROWS = 2000


@pytest.fixture()
def pair(monkeypatch, rmesh, pmesh):
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "TPU_KNN_ONDEVICE_THRESHOLD", 64)
        monkeypatch.setattr(c, "TPU_ANN_MIN_ROWS", 256)
        monkeypatch.setattr(c, "COLUMN_MIRROR_MIN_ROWS", 4)
    monkeypatch.setattr(RDatastore, "_mesh_cache", ("mesh", rmesh))
    monkeypatch.setattr(PDatastore, "_mesh_cache", ("mesh", pmesh))
    ref, port = RDatastore("memory"), PDatastore("memory", device="cpu")
    yield ref, port
    ref.close()
    port.close()


def _run(ds, sql, vars=None):
    out = ds.execute(sql, vars=vars or {})
    for r in out:
        assert r["status"] == "OK", (sql, r)
    return out[-1]["result"]


def _hits(result):
    return {(r["id"].tb, r["id"].id): float(r["d"]) for r in result}


def _assert_same_hits(ref_res, port_res, k):
    a, b = _hits(ref_res), _hits(port_res)
    assert len(a) == len(b) == k
    kth = max(a.values())
    for key in a.keys() ^ b.keys():
        d = a.get(key, b.get(key))
        assert abs(d - kth) <= TOL["atol"] + TOL["rtol"] * kth, key
    for key in a.keys() & b.keys():
        assert abs(a[key] - b[key]) <= TOL["atol"] + TOL["rtol"] * a[key], key


def _strategy(tel, strategy):
    return tel.snapshot()["counters"].get(f'knn_strategy{{strategy="{strategy}"}}', 0.0)


def _load(pair, index, extra=""):
    x = _clustered(N_ROWS, DIM, 21)
    rows = [{"id": i, "emb": x[i].tolist(), "flag": bool(i % 2)} for i in range(N_ROWS)]
    for ds in pair:
        _run(ds, "DEFINE TABLE item SCHEMALESS; DEFINE INDEX iv ON item FIELDS emb "
                 f"{index} DIMENSION {DIM} DIST EUCLIDEAN{extra}")
        _run(ds, "INSERT INTO item $rows RETURN NONE", {"rows": rows})
    return x


@pytest.mark.parametrize("dist", ["EUCLIDEAN", "COSINE"])
def test_sql_mtree_takes_exact_sharded_in_both_packages(pair, dist):
    x = _clustered(N_ROWS, DIM, 21)
    rows = [{"id": i, "emb": x[i].tolist()} for i in range(N_ROWS)]
    for ds in pair:
        _run(ds, f"DEFINE TABLE item; DEFINE INDEX im ON item FIELDS emb MTREE DIMENSION {DIM} "
                 f"DIST {dist}")
        _run(ds, "INSERT INTO item $rows RETURN NONE", {"rows": rows})
    sql = "SELECT id, vector::distance::knn() AS d FROM item WHERE emb <|10|> $q"
    rng = np.random.default_rng(3)
    queries = x[rng.integers(0, N_ROWS, 6)] + rng.standard_normal((6, DIM)).astype(np.float32)
    before = [_strategy(t, "exact-sharded") for t in (rtel, ptel)]
    for qv in queries:
        _assert_same_hits(_run(pair[0], sql, {"q": qv.tolist()}),
                          _run(pair[1], sql, {"q": qv.tolist()}), 10)
    after = [_strategy(t, "exact-sharded") for t in (rtel, ptel)]
    assert after[0] - before[0] == 6 and after[1] - before[1] == 6
    assert any(k[0] == "knn-sharded" for k in pair[1].dispatch._buckets)


def test_sql_hnsw_trains_then_takes_ivf_sharded_in_both_packages(pair):
    x = _load(pair, "HNSW", " EFC 64")
    before = [_strategy(t, "exact-sharded(ivf-training)") for t in (rtel, ptel)]
    for ds in pair:
        _run(ds, "SELECT id FROM item WHERE emb <|4,16|> $q", {"q": x[0].tolist()})
    after = [_strategy(t, "exact-sharded(ivf-training)") for t in (rtel, ptel)]
    assert after[0] - before[0] == 1 and after[1] - before[1] == 1
    mirrors = [ds.index_stores.get("test", "test", "item", "iv") for ds in pair]
    for m in mirrors:
        assert m.wait_ivf(120), "background IVF training did not finish"
    assert mirrors[1].ivf.lists == mirrors[0].ivf.lists
    sql = "SELECT id, vector::distance::knn() AS d FROM item WHERE emb <|10,40|> $q"
    rng = np.random.default_rng(31)
    queries = x[rng.integers(0, N_ROWS, 8)] + rng.standard_normal((8, DIM)).astype(np.float32)
    before = [_strategy(t, "ivf-sharded") for t in (rtel, ptel)]
    for qv in queries:
        _assert_same_hits(_run(pair[0], sql, {"q": qv.tolist()}),
                          _run(pair[1], sql, {"q": qv.tolist()}), 10)
    # concurrent clients coalesce into wider tiles
    out = {0: [None] * 8, 1: [None] * 8}

    def client(side, i):
        out[side][i] = _run(pair[side], sql, {"q": queries[i].tolist()})

    threads = [threading.Thread(target=client, args=(s, i)) for s in (0, 1) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i in range(8):
        _assert_same_hits(out[0][i], out[1][i], 10)
    after = [_strategy(t, "ivf-sharded") for t in (rtel, ptel)]
    assert after[0] - before[0] == 16 and after[1] - before[1] == 16
    assert any(k[0] == "knn-ivf-sharded" for k in pair[1].dispatch._buckets)


def test_sql_ivf_sharded_prefilter_matches_reference(pair):
    x = _load(pair, "HNSW")
    for ds in pair:
        _run(ds, "SELECT id FROM item WHERE emb <|4|> $q", {"q": x[31].tolist()})
        assert ds.index_stores.get("test", "test", "item", "iv").wait_ivf(120)
    sql = ("SELECT id, vector::distance::knn() AS d FROM item "
           "WHERE emb <|8,80|> $q AND flag = true")
    q = {"q": (x[31] + 0.01).tolist()}
    before = [_strategy(t, "ivf-sharded") for t in (rtel, ptel)]
    res = [_run(ds, sql, q) for ds in pair]
    assert all(r["id"].id % 2 for r in res[1]) and len(res[1]) == 8
    _assert_same_hits(res[0], res[1], 8)
    after = [_strategy(t, "ivf-sharded") for t in (rtel, ptel)]
    assert after[0] - before[0] == 1 and after[1] - before[1] == 1


def test_sharded_ivf_reachable_under_mesh(monkeypatch, pmesh):
    """test_mesh.py's test_sharded_ivf_reachable_under_mesh, on the port:
    the first query under the mesh kicks training on the sharded matrix."""
    monkeypatch.setattr(pcnf, "TPU_ANN_MIN_ROWS", 64)
    monkeypatch.setattr(pcnf, "TPU_KNN_ONDEVICE_THRESHOLD", 1)
    monkeypatch.setattr(PDatastore, "_mesh_cache", ("mesh", pmesh))
    ds = PDatastore("memory", device="cpu")
    try:
        ds.execute("DEFINE INDEX v ON item FIELDS emb HNSW DIMENSION 8;")
        rng = np.random.default_rng(3)
        x = rng.standard_normal((256, 8)).astype(np.float32)
        ds.execute("INSERT INTO item $rows;",
                   vars={"rows": [{"id": i, "emb": x[i].tolist()} for i in range(256)]})
        ds.execute("SELECT VALUE id FROM item WHERE emb <|3|> $q;", vars={"q": x[5].tolist()})
        mirror = ds.index_stores.get("test", "test", "item", "v")
        assert mirror.wait_ivf(30)
        out = ds.execute("SELECT VALUE id FROM item WHERE emb <|3|> $q;",
                         vars={"q": x[7].tolist()})
        assert out[-1]["result"][0].id == 7
        assert any(k[0] == "knn-ivf-sharded" for k in ds.dispatch._buckets)
    finally:
        ds.close()
