"""The exact MTREE kNN slice end to end: the same SurrealQL through the JAX
reference's Datastore and the PyTorch port's Datastore(device="cpu").

Both packages get their on-device threshold lowered (each has its own cnf),
and the reference's device mesh is switched off — the suite's 8-device CPU
mesh would otherwise send it down `exact-sharded` — so both serve through
the `exact-device` strategy: the mirror, the dispatch coalescer, the tile
loop and K2. Ids agree up to ties within 1e-5 of the k-th distance;
distances agree to 1e-5.
"""

import threading

import numpy as np
import pytest
import torch

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu import telemetry as rtel
from surrealdb_tpu.idx import knn as rknn
from surrealdb_tpu.kvs.ds import Datastore as RDatastore
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch import telemetry as ptel
from surrealdb_tpu_torch.idx import knn as pknn
from surrealdb_tpu_torch.kvs.ds import Datastore as PDatastore

DIM = 32
N_ROWS = 2000
TIE = 1e-5


@pytest.fixture()
def pair(monkeypatch):
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "TPU_KNN_ONDEVICE_THRESHOLD", 64)
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
        assert abs(a[key] - b[key]) <= 1e-5 * max(1.0, a[key]), key


def _strategy_count(tel, strategy):
    return tel.snapshot()["counters"].get(f'knn_strategy{{strategy="{strategy}"}}', 0.0)


def _load(pair, dist, rng):
    rows = [
        {"id": i, "emb": rng.standard_normal(DIM).astype(np.float32).tolist()}
        for i in range(N_ROWS)
    ]
    for ds in pair:
        _run(ds, "DEFINE TABLE item; DEFINE INDEX im ON item FIELDS emb "
                 f"MTREE DIMENSION {DIM} DIST {dist}")
        _run(ds, "INSERT INTO item $rows RETURN NONE", {"rows": rows})
    return rows


@pytest.mark.parametrize("dist", ["EUCLIDEAN", "COSINE"])
def test_mtree_knn_matches_reference(pair, dist):
    rng = np.random.default_rng(17)
    rows = _load(pair, dist, rng)
    sql = "SELECT id, vector::distance::knn() AS d FROM item WHERE emb <|10|> $q"
    before = [_strategy_count(t, "exact-device") for t in (rtel, ptel)]
    # the first query builds each mirror; the writes after it reach the
    # mirrors as deltas (overwrite in place, tombstone, append)
    for ds in pair:
        _run(ds, sql, {"q": rows[0]["emb"]})
    moved = rng.standard_normal((20, DIM)).astype(np.float32)
    fresh = rng.standard_normal((15, DIM)).astype(np.float32)
    for ds in pair:
        for j in range(20):
            _run(ds, f"UPDATE item:{j * 7} SET emb = $v", {"v": moved[j].tolist()})
        for j in range(30):
            _run(ds, f"DELETE item:{j * 11 + 1}")
        for j in range(15):
            _run(ds, f"CREATE item:{N_ROWS + j} SET emb = $v", {"v": fresh[j].tolist()})
    queries = rng.standard_normal((16, DIM)).astype(np.float32)
    # near overwritten rows, but not near-duplicates: close to a zero
    # distance the sqrt amplifies the |q|^2 + |x|^2 - 2 q.x cancellation
    queries[:4] = moved[:4] + 0.1 * queries[:4]
    for qv in queries:
        _assert_same_hits(
            _run(pair[0], sql, {"q": qv.tolist()}),
            _run(pair[1], sql, {"q": qv.tolist()}), 10,
        )
    # 16 concurrent clients: the coalescer batches them into wider tiles
    out = {0: [None] * 16, 1: [None] * 16}

    def client(side, i):
        out[side][i] = _run(pair[side], sql, {"q": queries[i].tolist()})

    threads = [threading.Thread(target=client, args=(s, i)) for s in (0, 1) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i in range(16):
        _assert_same_hits(out[0][i], out[1][i], 10)
    after = [_strategy_count(t, "exact-device") for t in (rtel, ptel)]
    assert after[0] - before[0] == 33
    assert after[1] - before[1] == 33


def test_bruteforce_knn_matches_reference(pair):
    """No vector index on `emb`: BruteForceKnnPlan. The table carries an
    index on another field, because the planner of both packages returns
    no plan at all for a table with no index, and the operator then
    matches nothing."""
    rng = np.random.default_rng(23)
    rows = [
        {"id": i, "val": i % 7, "emb": rng.standard_normal(DIM).astype(np.float32).tolist()}
        for i in range(300)
    ]
    for ds in pair:
        _run(ds, "DEFINE TABLE plain; DEFINE INDEX iv ON plain FIELDS val")
        _run(ds, "INSERT INTO plain $rows RETURN NONE", {"rows": rows})
    before = [_strategy_count(t, "brute-force") for t in (rtel, ptel)]
    sql = "SELECT id, vector::distance::knn() AS d FROM plain WHERE emb <|10,EUCLIDEAN|> $q"
    for qv in rng.standard_normal((4, DIM)).astype(np.float32):
        _assert_same_hits(
            _run(pair[0], sql, {"q": qv.tolist()}),
            _run(pair[1], sql, {"q": qv.tolist()}), 10,
        )
    after = [_strategy_count(t, "brute-force") for t in (rtel, ptel)]
    assert after[0] - before[0] == 4 and after[1] - before[1] == 4


@pytest.mark.parametrize("nq", [1, 5, 8, 30, 64])
def test_exact_device_launch_matches_reference_on_mirror_state(pair, nq):
    """mirror_from_reference loads the reference mirror's host state into a
    port mirror; both launch functions then run on identical slots."""
    rng = np.random.default_rng(29 + nq)
    rows = _load(pair, "EUCLIDEAN", rng)
    _run(pair[0], "SELECT id FROM item WHERE emb <|3|> $q", {"q": rows[0]["emb"]})
    for j in range(25):
        _run(pair[0], f"DELETE item:{j * 13}")
    rmirror = pair[0].index_stores.get("test", "test", "item", "im")
    data, alive, rids = rmirror.host_view()
    pmirror = pknn.mirror_from_reference(data, alive, rids, "cpu")
    assert pmirror.count() == rmirror.count() == N_ROWS - 25
    qs = rng.standard_normal((nq, DIM)).astype(np.float32)
    rmat, rmask, _ = rmirror.device_snapshot()
    pmat, pmask, prids = pmirror.device_snapshot(torch.device("cpu"))
    np.testing.assert_array_equal(pmask, rmask)
    assert [(r.tb, r.id) for r in prids] == [(r.tb, r.id) for r in rids]
    ref_d, ref_i = rknn._exact_device_batch(qs, rmat, rmask, "euclidean", 10)
    got_d, got_i = pknn._exact_device_batch(qs, pmat, pmask, "euclidean", 10)
    assert got_d.shape == ref_d.shape == (nq, 10) and got_i.dtype == np.int64
    np.testing.assert_allclose(got_d, ref_d, rtol=1e-5, atol=1e-5)
    for r in range(nq):
        kth = ref_d[r, -1]
        for j in np.nonzero(got_i[r] != ref_i[r])[0]:
            assert abs(ref_d[r, j] - kth) <= TIE * max(1.0, kth)
