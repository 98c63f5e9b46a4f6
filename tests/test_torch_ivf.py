"""The IVF slice of the PyTorch port (surrealdb_tpu_torch/idx/ivf.py and the
HNSW strategies of idx/knn.py) held against the JAX reference on the same
seeded inputs: the reference on the CPU (JAX_PLATFORMS=cpu, mesh off), the
port with CPU tensors, i.e. the plain PyTorch versions of its kernels.

Tolerances: assignment ids and trained lists exact (a difference is a
fault, not noise); k-means centroids rtol 1e-5, atol 1e-4 (f32 sums in
another order); search distances 1e-5, ids equal up to ties at the k-th
distance; `search_host` (numpy on both sides) exact. Queries are drawn like
corpus points (cluster noise of scale 1), not as near-duplicates of one:
close to a zero distance the sqrt amplifies the cancellation in the
reference's |q|^2 + |x|^2 - 2 q.x, which any two summation orders expose.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu import telemetry as rtel
from surrealdb_tpu.idx import ivf as R
from surrealdb_tpu.kvs.ds import Datastore as RDatastore
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch import telemetry as ptel
from surrealdb_tpu_torch.idx import ivf as P
from surrealdb_tpu_torch.kvs.ds import Datastore as PDatastore

TIE = 1e-5


def _mixture(n, d, clusters=32, seed=3):
    """Gaussian mixture, the reference's tests/test_ivf.py corpus."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32) * 4.0
    assign = rng.integers(0, clusters, size=n)
    return centers[assign] + rng.normal(size=(n, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_topk_match(ref_d, ref_i, got_d, got_i):
    """Distances to 1e-5; ids equal except at ties with the k-th distance;
    misses (+inf / -1) identical."""
    ref_d, ref_i = np.asarray(ref_d), np.asarray(ref_i)
    got_d, got_i = np.asarray(got_d), np.asarray(got_i)
    assert got_d.shape == ref_d.shape and got_i.shape == ref_i.shape
    miss = ~np.isfinite(ref_d)
    np.testing.assert_array_equal(~np.isfinite(got_d), miss)
    np.testing.assert_array_equal(got_i[miss], ref_i[miss])
    np.testing.assert_allclose(got_d[~miss], ref_d[~miss], rtol=TIE, atol=TIE)
    for r in range(ref_d.shape[0]):
        fin = ref_d[r][np.isfinite(ref_d[r])]
        kth = float(fin.max()) if fin.size else 0.0
        for j in np.nonzero(got_i[r] != ref_i[r])[0]:
            assert abs(float(ref_d[r, j]) - kth) <= TIE * max(1.0, abs(kth)), (r, j)


# ------------------------------------------------------------ host helpers
@pytest.mark.parametrize("n", [1, 100, 2000, 65_536, 1 << 20, 1 << 26])
def test_default_nlists_matches_reference(n):
    assert P.default_nlists(n) == R.default_nlists(n)


@pytest.mark.parametrize("nlists,ef", [(8, None), (64, None), (1024, 64), (1024, 400), (64, 0), (16, 5)])
def test_default_nprobe_matches_reference(nlists, ef):
    assert P.default_nprobe(nlists, ef) == R.default_nprobe(nlists, ef)


# ------------------------------------------------------------ K5 / K4
def _assign_inputs(seed):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((40, 16)).astype(np.float32)
    cents[25] = cents[4]  # duplicated centroids: the lower index wins
    cents[31] = cents[9]
    x = rng.standard_normal((500, 16)).astype(np.float32)
    x[:40] = cents[[4, 9] * 20] + 0.01 * x[:40]
    return x, cents


@pytest.mark.parametrize("k_assign", [1, 2])
def test_assign_chunk_matches_reference(k_assign):
    x, cents = _assign_inputs(1)
    ref = np.asarray(R._assign_chunk(jnp.asarray(x), jnp.asarray(cents), k_assign=k_assign))
    got = P._assign_chunk(_t(x), _t(cents), k_assign=k_assign)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(got.reshape(500, -1)[:40, 0].tolist()) == {4, 9}


@pytest.mark.parametrize("k_assign", [1, 2])
def test_assign_gather_matches_reference(k_assign):
    x, cents = _assign_inputs(2)
    idx = np.random.default_rng(3).integers(-10, 520, size=300).astype(np.int32)  # clipped
    ref = np.asarray(R._assign_gather(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(cents),
                                      k_assign=k_assign))
    got = P._assign_gather(_t(x), _t(idx), _t(cents), k_assign=k_assign)
    np.testing.assert_array_equal(got.numpy(), ref)


def _nonfinite_inputs(seed):
    """_assign_inputs plus a row holding +inf, one -inf and one NaN, and a
    column of small integer centroid values (zeros among them: inf x 0)."""
    x, cents = _assign_inputs(seed)
    rng = np.random.default_rng(seed + 100)
    cents[:, 7] = rng.integers(-2, 3, cents.shape[0])
    x[50, 7], x[51, 2], x[52, 11] = np.inf, -np.inf, np.nan
    return x, cents


@pytest.mark.parametrize("gather", [False, True], ids=["rows", "index"])
@pytest.mark.parametrize("k_assign", [1, 2])
def test_assign_nonfinite_rows_match_reference(k_assign, gather):
    """Rows holding inf or NaN get the reference's ids: a NaN distance ranks
    first, lower index first."""
    x, cents = _nonfinite_inputs(4)
    if gather:
        idx = np.array([50, 51, 52, 0, 7, -3, 600], dtype=np.int32)
        ref = R._assign_gather(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(cents),
                               k_assign=k_assign)
        got = P._assign_gather(_t(x), _t(idx), _t(cents), k_assign=k_assign)
    else:
        ref = R._assign_chunk(jnp.asarray(x), jnp.asarray(cents), k_assign=k_assign)
        got = P._assign_chunk(_t(x), _t(cents), k_assign=k_assign)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("k_assign", [1, 2])
def test_assign_bf16_corpus_matches_reference(k_assign):
    """The main path's corpus is bf16: the same bf16 rows through both."""
    x, cents = _assign_inputs(5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = R._assign_chunk(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(cents), k_assign=k_assign)
    got = P._assign_chunk(xb, _t(cents), k_assign=k_assign)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_kmeans_step_matches_reference_with_an_empty_cluster():
    xs = _mixture(3000, 16, clusters=8, seed=4)
    rng = np.random.default_rng(5)
    c = xs[rng.choice(3000, size=12, replace=False)].copy()
    c[11] = 1e3  # far from every row: its cluster stays empty
    ref = np.asarray(R._kmeans_step(jnp.asarray(xs), jnp.asarray(c), 12))
    got = P._kmeans_step(_t(xs), _t(c), 12)
    np.testing.assert_array_equal(got[11].numpy(), c[11])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_kmeans_update_counts_each_cluster():
    xs = _mixture(500, 8, seed=6)
    a = np.random.default_rng(6).integers(0, 9, size=500).astype(np.int32)
    c = np.zeros((10, 8), dtype=np.float32)
    new, counts = P.kmeans_update(_t(xs), _t(a), _t(c))
    np.testing.assert_array_equal(counts.numpy(), np.bincount(a, minlength=10))
    np.testing.assert_allclose(new[3].numpy(), xs[a == 3].mean(0), rtol=1e-5, atol=1e-5)
    assert not new[9].any()  # empty: kept


@pytest.mark.parametrize("corpus", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_index_reduce_mean_is_the_update(corpus):
    """chip_smoke.py times `c.clone().index_reduce_(0, a, x.float(), "mean",
    include_self=False)` beside the K4 update as its one-call yardstick: it
    computes the plain update, an empty cluster keeping its centroid."""
    xs = torch.from_numpy(_mixture(3000, 16, clusters=8, seed=8)).to(corpus)
    a = torch.from_numpy(np.random.default_rng(8).integers(0, 11, size=3000).astype(np.int32))
    a[a == 4] = 5  # cluster 4 empty
    c = torch.from_numpy(np.random.default_rng(9).normal(size=(12, 16)).astype(np.float32))
    want = P.kmeans_update_plain(xs, a, c)[0]
    got = c.clone().index_reduce_(0, a.long(), xs.float(), "mean", include_self=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got[[4, 11]], c[[4, 11]])


@pytest.mark.parametrize("iters", [0, 8])
def test_kmeans_xs_picks_the_same_sample(iters):
    xs = _mixture(4000, 16, seed=7)
    ref = np.asarray(R._kmeans_xs(jnp.asarray(xs), 32, iters=iters))
    got = P._kmeans_xs(_t(xs), 32, iters=iters).numpy()
    if iters == 0:
        np.testing.assert_array_equal(got, ref)  # the seeded initial picks
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_kmeans_host_sample_matches_reference():
    x = _mixture(20000, 8, seed=8)  # above train_n: the seeded subsample
    ref = R._kmeans(x, 16, iters=2)
    got = P._kmeans(x, 16, iters=2, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------ IvfState
@pytest.fixture(scope="module")
def corpus():
    x = _mixture(3000, 16)
    alive = np.ones(3000, dtype=bool)
    alive[::11] = False  # tombstoned slots train nothing
    return x, alive


@pytest.mark.parametrize("branch", ["host", "device"])
def test_train_gives_the_reference_lists(corpus, branch):
    x, alive = corpus
    if branch == "host":
        ref = R.IvfState.train(x, alive)
        got = P.IvfState.train(x, alive, device="cpu")
    else:
        ref = R.IvfState.train(x, alive, matrix=jnp.asarray(x))
        got = P.IvfState.train(x, alive, matrix=_t(x))
    assert got.lists == ref.lists
    assert got.trained_n == ref.trained_n and got.nlists == ref.nlists
    np.testing.assert_allclose(got.centroids, ref.centroids, rtol=1e-5, atol=1e-4)


def _from_reference(ref):
    return P.ivf_from_reference(ref.centroids, ref.lists, ref.trained_n, "cpu")


def test_add_remove_and_retrain_threshold_match_reference(corpus):
    x, alive = corpus
    ref = R.IvfState.train(x[:2000], alive[:2000])
    got = _from_reference(ref)
    rng = np.random.default_rng(12)
    ops = [("add", int(s)) for s in range(2000, 3000)] + [
        ("remove", int(s)) for s in rng.choice(2000, size=300, replace=False)
    ] + [("add", 2500), ("remove", 99_999)]  # idempotent add, unknown remove
    for op, s in ops:
        for st in (ref, got):
            if op == "add":
                st.add(s, x[s])
            else:
                st.remove(s, None)
        assert got.needs_retrain() == ref.needs_retrain()
    assert got.lists == ref.lists and got.size() == ref.size()
    assert got.slot_list == ref.slot_list


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_search_host_matches_reference_exactly(corpus, metric):
    x, alive = corpus
    ref = R.IvfState.train(x, alive)
    got = _from_reference(ref)
    qs = x[:20] + 0.05
    mask = np.random.default_rng(4).random(3000) > 0.4
    for sm in (None, mask):
        rd, ri = ref.search_host(qs, x, metric, 10, 6, slot_mask=sm)
        gd, gi = got.search_host(qs, x, metric, 10, 6, slot_mask=sm)
        np.testing.assert_array_equal(gd, rd)
        np.testing.assert_array_equal(gi, ri)


@pytest.fixture(scope="module")
def trained(corpus):
    x, alive = corpus
    ref = R.IvfState.train(x, alive, matrix=jnp.asarray(x))
    return x, ref, _from_reference(ref)


def _search_both(x, ref, got, qs, metric, k, nprobe, slot_ok):
    probe_metric = metric if metric in R._PROBE_METRICS else "euclidean"
    rc, rr, rm = ref._device()
    rd, ri = R._ivf_search(jnp.asarray(qs), rc, rr, rm, jnp.asarray(x), jnp.asarray(slot_ok),
                           metric=metric, probe_metric=probe_metric, k=k, nprobe=nprobe)
    pc, pr, pm, _ = got._device("cpu")
    gd, gi = P._ivf_search(_t(qs), pc, pr, pm, _t(x), _t(slot_ok), metric=metric,
                           probe_metric=probe_metric, k=k, nprobe=nprobe)
    assert gi.dtype == torch.int32
    return (rd, ri), (gd.numpy(), gi.numpy())


@pytest.mark.parametrize("nq", [1, 8, 64])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan", "pearson"])
def test_ivf_search_matches_reference(trained, metric, nq):
    x, ref, got = trained
    rng = np.random.default_rng(nq)
    qs = x[rng.integers(0, 3000, size=nq)] + rng.standard_normal((nq, 16)).astype(np.float32)
    slot_ok = rng.random(3000) > 0.33  # a residual-WHERE mask over a third
    (rd, ri), (gd, gi) = _search_both(x, ref, got, qs, metric, 10, 6, slot_ok)
    _assert_topk_match(rd, ri, gd, gi)


@pytest.mark.parametrize("k", [10, 200])
def test_ivf_search_queries_sharing_probed_lists_match_reference(trained, k):
    """A tile of 24 queries near three rows, so most probed lists are
    probed by several queries (the shape on which the port's rerank scores
    a list once for all its queries), a third of the slots masked."""
    x, ref, got = trained
    rng = np.random.default_rng(k)
    qs = x[np.repeat([7, 500, 1500], 8)] + rng.standard_normal((24, 16)).astype(np.float32)
    slot_ok = rng.random(3000) > 0.33
    (rd, ri), (gd, gi) = _search_both(x, ref, got, qs, "euclidean", k, 6, slot_ok)
    probes = P.ivf_probe_plain(_t(qs), got._device("cpu")[0], "euclidean", 6).numpy()
    assert len(np.unique(probes)) < probes.size // 2  # lists shared across queries
    rd, ri = np.asarray(rd), np.asarray(ri)
    miss = ~np.isfinite(rd)
    np.testing.assert_array_equal(~np.isfinite(gd), miss)
    np.testing.assert_array_equal(gi[miss], ri[miss])
    np.testing.assert_allclose(gd[~miss], rd[~miss], rtol=TIE, atol=TIE)
    # an id out of place ties (within TIE) with the reference's pick there:
    # two equal distances summed in another order may swap anywhere in k = 200
    for r, j in zip(*np.nonzero(gi != ri)):
        same = np.nonzero(ri[r] == gi[r, j])[0]
        near = abs(float(gd[r, j]) - float(rd[r, j])) <= TIE * max(1.0, abs(float(rd[r, j])))
        tied = same.size and abs(float(rd[r, same[0]]) - float(gd[r, j])) <= TIE * max(
            1.0, abs(float(gd[r, j])))
        assert near and (tied or abs(float(rd[r, -1]) - float(gd[r, j])) <= TIE * max(
            1.0, abs(float(gd[r, j])))), (r, j)


def test_ivf_search_k_above_the_candidates_returns_misses(trained):
    x, ref, got = trained
    lmax = int(ref._device()[1].shape[1])
    k = 2 * lmax + 50  # above nprobe * L = 2 * L
    slot_ok = np.random.default_rng(1).random(3000) > 0.5
    (rd, ri), (gd, gi) = _search_both(x, ref, got, x[:3] + 1.0, "euclidean", k, 2, slot_ok)
    assert np.asarray(rd).shape == (3, 2 * lmax)
    assert (np.asarray(ri) == -1).any()
    _assert_topk_match(rd, ri, gd, gi)


def test_ivf_search_tie_between_probed_lists_keeps_position_order(trained):
    """Two identical rows in two different lists: the row of the list
    probed first wins, as lax.top_k keeps the lower candidate position."""
    x, ref, got = trained
    x = x.copy()
    a, b = ref.lists[3][0], ref.lists[17][0]
    x[b] = x[a]
    qs = (x[a] + 1.0)[None, :]
    (rd, ri), (gd, gi) = _search_both(x, ref, got, qs, "euclidean", 1, ref.nlists,
                                      np.ones(3000, dtype=bool))
    _assert_topk_match(rd, ri, gd, gi)
    np.testing.assert_array_equal(gi, np.asarray(ri))
    assert int(gi[0, 0]) in (a, b)


@pytest.mark.parametrize("nq", [1, 5, 64])
def test_search_batch_matches_reference(trained, nq):
    """The launch loop (tiles of 1, 8 and 64, pad, collect) over the same
    quantizer: IvfState.search_batch of both packages."""
    x, ref, got = trained
    qs = x[np.random.default_rng(nq).integers(0, 3000, size=nq)] + 1.0
    rd, ri = ref.search_batch(qs, jnp.asarray(x), "euclidean", 10, 6)
    gd, gi = got.search_batch(qs, _t(x), "euclidean", 10, 6)
    assert gi.dtype == np.int64 and gd.dtype == np.float32
    _assert_topk_match(rd, ri, gd, gi)


def test_cpu_tensors_launch_no_ivf_kernel(trained):
    x, _ref, got = trained
    before = [c.launches for c in P.KERNELS]
    got.search_batch(x[:3], _t(x), "euclidean", 5, 4)
    P._kmeans_step(_t(x[:100]), _t(x[:8]), 8)
    assert [c.launches for c in P.KERNELS] == before


def test_sharded_search_raises_naming_the_roadmap(trained):
    """The sharded search is ported (K13, parallel/mesh.py): on an 8-shard
    CPU mesh it returns the reference's answers for the same quantizer,
    and a corpus that does not divide over the mesh raises."""
    from surrealdb_tpu.parallel import mesh as RM
    from surrealdb_tpu_torch.parallel import mesh as PM

    x, ref, got = trained
    pmesh = PM.make_mesh(8, devices=[torch.device("cpu")] * 8)
    rmesh = RM.make_mesh(8)
    qs = x[:3] + 0.5
    rd, rr = ref.search_batch_sharded(qs, rmesh, RM.shard_corpus(rmesh, x), "euclidean", 5, 4)
    pd, pr = got.search_batch_sharded(qs, pmesh, PM.shard_corpus(pmesh, x), "euclidean", 5, 4)
    _assert_topk_match(rd, rr, pd, pr)
    with pytest.raises(ValueError, match="divide"):
        got.search_batch_sharded(x[:2], pmesh, _t(x[:-1]), "euclidean", 5, 4)


# ------------------------------------------------------------ SQL parity
DIM = 32
N_ROWS = 2000


@pytest.fixture()
def pair(monkeypatch):
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "TPU_KNN_ONDEVICE_THRESHOLD", 64)
        monkeypatch.setattr(c, "TPU_ANN_MIN_ROWS", 256)
        monkeypatch.setattr(c, "COLUMN_MIRROR_MIN_ROWS", 4)
    monkeypatch.setattr(RDatastore, "_mesh_cache", ("none", None))
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
        assert abs(d - kth) <= TIE * max(1.0, kth), key
    for key in a.keys() & b.keys():
        assert abs(a[key] - b[key]) <= TIE * max(1.0, a[key]), key


def _strategy(tel, strategy):
    return tel.snapshot()["counters"].get(f'knn_strategy{{strategy="{strategy}"}}', 0.0)


def _load_hnsw(pair, index="HNSW", extra=""):
    x = _mixture(N_ROWS, DIM, seed=21)
    rows = [{"id": i, "emb": x[i].tolist(), "flag": bool(i % 2)} for i in range(N_ROWS)]
    for ds in pair:
        _run(ds, "DEFINE TABLE item SCHEMALESS; DEFINE INDEX iv ON item FIELDS emb "
                 f"{index} DIMENSION {DIM} DIST EUCLIDEAN{extra}")
        _run(ds, "INSERT INTO item $rows RETURN NONE", {"rows": rows})
    return x


def _train_both(pair, q):
    """The first ANN query of each side serves exactly and kicks the
    background training; wait for it on both sides."""
    before = [_strategy(t, "exact-device(ivf-training)") for t in (rtel, ptel)]
    for ds in pair:
        _run(ds, "SELECT id FROM item WHERE emb <|4,16|> $q", {"q": q.tolist()})
    after = [_strategy(t, "exact-device(ivf-training)") for t in (rtel, ptel)]
    assert after[0] - before[0] == 1 and after[1] - before[1] == 1
    mirrors = [ds.index_stores.get("test", "test", "item", "iv") for ds in pair]
    for m in mirrors:
        assert m.wait_ivf(120), "background IVF training did not finish"
        assert m.ivf_status()["state"] == "ready"
    assert mirrors[1].ivf.lists == mirrors[0].ivf.lists
    return mirrors


def test_hnsw_ivf_strategy_matches_reference(pair):
    x = _load_hnsw(pair, extra=" EFC 64")
    _train_both(pair, x[0])
    sql = "SELECT id, vector::distance::knn() AS d FROM item WHERE emb <|10,40|> $q"
    rng = np.random.default_rng(31)
    queries = x[rng.integers(0, N_ROWS, size=12)] + rng.standard_normal((12, DIM)).astype(np.float32)
    before = [_strategy(t, "ivf") for t in (rtel, ptel)]
    for qv in queries:
        _assert_same_hits(_run(pair[0], sql, {"q": qv.tolist()}),
                          _run(pair[1], sql, {"q": qv.tolist()}), 10)
    # concurrent clients coalesce into wider tiles
    out = {0: [None] * 12, 1: [None] * 12}

    def client(side, i):
        out[side][i] = _run(pair[side], sql, {"q": queries[i].tolist()})

    threads = [threading.Thread(target=client, args=(s, i)) for s in (0, 1) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i in range(12):
        _assert_same_hits(out[0][i], out[1][i], 10)
    after = [_strategy(t, "ivf") for t in (rtel, ptel)]
    assert after[0] - before[0] == 24 and after[1] - before[1] == 24


def test_ivf_prefilter_and_host_strategy_match_reference(pair, monkeypatch):
    """The residual WHERE rides into the probe+rerank as a slot mask (the
    reference's test_ivf_strategies_consume_columnar_prefilter), on the
    device strategy and on `ivf-host` under TPU_DISABLE."""
    x = _load_hnsw(pair)
    _train_both(pair, x[31])
    sql = ("SELECT id, vector::distance::knn() AS d FROM item "
           "WHERE emb <|8,80|> $q AND flag = true")
    q = {"q": (x[31] + 0.01).tolist()}
    for strategy in ("ivf", "ivf-host"):
        if strategy == "ivf-host":
            for c in (rcnf, pcnf):
                monkeypatch.setattr(c, "TPU_DISABLE", True)
        before = [_strategy(t, strategy) for t in (rtel, ptel)]
        res = [_run(ds, sql, q) for ds in pair]
        assert all(r["id"].id % 2 for r in res[1]) and len(res[1]) == 8
        _assert_same_hits(res[0], res[1], 8)
        after = [_strategy(t, strategy) for t in (rtel, ptel)]
        assert after[0] - before[0] == 1 and after[1] - before[1] == 1


def test_ivf_incremental_add_after_training_matches_reference(pair):
    x = _load_hnsw(pair)
    _train_both(pair, x[0])
    fresh = _mixture(3, DIM, seed=22)  # points of other clusters than the corpus's
    for ds in pair:
        for j in range(3):
            _run(ds, f"CREATE item:{N_ROWS + j} SET emb = $v", {"v": fresh[j].tolist()})
        _run(ds, "DELETE item:5")
    sql = "SELECT id, vector::distance::knn() AS d FROM item WHERE emb <|5,40|> $q"
    q = fresh[1] + np.random.default_rng(2).standard_normal(DIM).astype(np.float32)
    res = [_run(ds, sql, {"q": q.tolist()}) for ds in pair]
    assert (("item", N_ROWS + 1)) in _hits(res[1])
    _assert_same_hits(res[0], res[1], 5)
    mirrors = [ds.index_stores.get("test", "test", "item", "iv") for ds in pair]
    assert mirrors[1].ivf.lists == mirrors[0].ivf.lists


def test_mtree_stays_exact_above_the_ann_threshold(pair):
    x = _load_hnsw(pair, index="MTREE")
    q = x[7] + np.random.default_rng(3).standard_normal(DIM).astype(np.float32)
    res = [_run(ds, "SELECT id, vector::distance::knn() AS d FROM item WHERE emb <|10,4|> $q",
                {"q": q.tolist()}) for ds in pair]
    want = set(np.argsort(((x - q) ** 2).sum(1))[:10].tolist())
    assert {r["id"].id for r in res[1]} == want
    _assert_same_hits(res[0], res[1], 10)
    assert pair[1].index_stores.get("test", "test", "item", "iv").ivf is None
