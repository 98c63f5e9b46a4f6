"""Cluster mode of the port (surrealdb_tpu_torch/cluster/) held to the
reference's single node on the same data, on the CPU.

A 3-node RF-2 cluster of the port (each node a `serve(..., device="cpu")`
store on an ephemeral port, attached to one ring with 64 vnodes) and one
`surrealdb_tpu.kvs.ds.Datastore("memory")` take the same seeded writes;
every statement goes through the cluster's coordinator (n1) and the
reference. The port's kNN and BM25 thresholds are lowered so each node's
shard runs the device branch (K2's and K9's plain versions here), and the
reference's 8-device CPU mesh is switched off so it serves `exact-device`.

Tolerances: kNN ids equal up to ties within 1e-5 of the k-th distance,
distances within 1e-5 (relative, f32 on both sides), or, for a row next
to its query where the reference's f32 |q|^2 + |x|^2 - 2 q.x cancels,
squared distances within 4 ulp of |q|^2 + |x|^2; BM25 ids and order
equal up to ties within the score tolerance, scores rtol 1e-5, atol 1e-6
(the f32 sums may add terms in another order on a shard); scans
byte-equal; graph selects equal as multisets (edge ids are random per
store); placement exact.
"""

import time

import numpy as np
import pytest

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu.cluster import placement as rplace
from surrealdb_tpu.kvs.ds import Datastore as RDatastore
from surrealdb_tpu.rpc import cbor as rcbor
from surrealdb_tpu_torch import cluster as pcluster
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch import telemetry as ptel
from surrealdb_tpu_torch.cluster import placement as pplace
from surrealdb_tpu_torch.dbs.session import Session
from surrealdb_tpu_torch.net.server import serve
from surrealdb_tpu_torch.rpc import cbor as pcbor

DIM, N_ITEMS, K = 16, 600, 10
TIE = 1e-5
RTOL, ATOL = 1e-5, 1e-6
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]


def _ok(resp):
    assert resp["status"] == "OK", resp
    return resp["result"]


class Pair:
    """Three attached port nodes and the reference's single Datastore."""

    def __init__(self):
        self.servers = [serve("memory", port=0, auth_enabled=False, device="cpu")
                        .start_background() for _ in range(3)]
        nodes = [{"id": f"n{i + 1}", "url": srv.url} for i, srv in enumerate(self.servers)]
        self.stores = [srv.httpd.RequestHandlerClass.ds for srv in self.servers]
        for i, ds in enumerate(self.stores):
            pcluster.attach(ds, pcluster.ClusterConfig(nodes, f"n{i + 1}", secret="t-secret"))
        self.ref = RDatastore("memory")
        self.s = Session.owner("t", "t")
        self.down = set()

    @property
    def coord(self):
        return self.stores[0]

    def run(self, sql, vars=None):
        """The same statements on both; the last statement's results."""
        a = self.ref.execute(sql, self.s, dict(vars) if vars else None)
        b = self.coord.execute(sql, self.s, dict(vars) if vars else None)
        assert [r["status"] for r in a] == [r["status"] for r in b], (sql, a, b)
        assert all(r["status"] == "OK" for r in b), (sql, b)
        return a[-1]["result"], b[-1]["result"], b[-1]

    def close(self):
        for i, (srv, ds) in enumerate(zip(self.servers, self.stores)):
            pcluster.detach(ds)
            if i not in self.down:
                srv.shutdown()
            ds.close()
        self.ref.close()


@pytest.fixture()
def pair(monkeypatch):
    monkeypatch.setattr(RDatastore, "_mesh_cache", ("none", None))
    monkeypatch.setattr(rcnf, "TPU_KNN_ONDEVICE_THRESHOLD", 64)
    monkeypatch.setattr(pcnf, "TPU_KNN_ONDEVICE_THRESHOLD", 64)
    monkeypatch.setattr(pcnf, "CLUSTER_RPC_TIMEOUT_SECS", 2.0)
    p = Pair()
    yield p
    p.close()


def _corpus(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N_ITEMS, DIM)).astype(np.float32)
    return [{"id": i, "emb": x[i].tolist(), "band": i % 5, "val": int(rng.integers(0, 1000))}
            for i in range(N_ITEMS)], x


def _load_items(p):
    rows, x = _corpus()
    p.run(f"DEFINE TABLE item SCHEMALESS; DEFINE INDEX im ON item FIELDS emb "
          f"MTREE DIMENSION {DIM} DIST EUCLIDEAN")
    for lo in range(0, N_ITEMS, 200):
        p.run("INSERT INTO item $rows RETURN NONE", {"rows": rows[lo:lo + 200]})
    return rows, x


def _same_bytes(ref, port):
    """The answers encode to the same CBOR bytes, each by its package."""
    return rcbor.encode(ref) == pcbor.encode(port)


def _hits(result):
    return {r["id"].id: float(r["d"]) for r in result}


def _assert_same_hits(ref_res, port_res, k, q, x):
    a, b = _hits(ref_res), _hits(port_res)
    assert len(a) == len(b) == len(port_res) == k, (ref_res, port_res)
    kth = max(a.values())
    for key in a.keys() ^ b.keys():
        assert abs(a.get(key, b.get(key)) - kth) <= TIE * max(1.0, kth), key
    for key in a.keys() & b.keys():
        # the reference's f32 |q|^2 + |x|^2 - 2 q.x cancels for a row next
        # to its query: there the squares agree within 4 ulp of the norms
        near = 4 * 2.0 ** -23 * float(q @ q + x[key] @ x[key])
        assert (abs(a[key] - b[key]) <= 1e-5 * max(1.0, a[key])
                or abs(a[key] ** 2 - b[key] ** 2) <= near), (key, a[key], b[key])


KNN_SQL = ("SELECT id, vector::distance::knn() AS d FROM item WHERE emb <|{k}|> $q "
           "ORDER BY d")


def _knn_parity(p, x, queries):
    for qi in queries:
        q = x[qi] + np.float32(0.01)
        ref, port, _resp = p.run(KNN_SQL.format(k=K), {"q": q.tolist()})
        _assert_same_hits(ref, port, K, q, x)


def test_rows_live_on_rf_nodes_by_the_reference_ring(pair):
    """Every record is on exactly the 2 nodes the reference's ring names."""
    rows, _x = _load_items(pair)
    ring = rplace.HashRing(["n1", "n2", "n3"], vnodes=64)
    counts = []
    for i, ds in enumerate(pair.stores):
        ids = _ok(ds.execute_local("SELECT VALUE id FROM item", pair.s)[0])
        held = {t.id for t in ids}
        want = {r["id"] for r in rows if f"n{i + 1}" in ring.owners_of("item", r["id"], 2)}
        assert held == want, f"n{i + 1}"
        counts.append(len(held))
    assert sum(counts) == 2 * N_ITEMS and all(counts), counts


def test_exact_knn_matches_reference(pair):
    """Each node's shard serves `exact-device` (K2's plain version) and the
    coordinator's merged top-10 equals the reference's single node."""
    _rows, x = _load_items(pair)
    before = ptel.snapshot()["counters"].get('knn_strategy{strategy="exact-device"}', 0.0)
    _knn_parity(pair, x, (3, 77, 150, 333, 599))
    after = ptel.snapshot()["counters"].get('knn_strategy{strategy="exact-device"}', 0.0)
    assert after - before >= 5 * 3, (before, after)  # every node, every query
    # a residual WHERE: each shard's prefiltered top-k merges the same way
    q = x[40] + np.float32(0.01)
    ref, port, _ = pair.run("SELECT id, vector::distance::knn() AS d FROM item "
                            "WHERE emb <|6|> $q AND band = 2 ORDER BY d", {"q": q.tolist()})
    _assert_same_hits(ref, port, 6, q, x)
    ref, port, _ = pair.run("SELECT id FROM item WHERE emb <|7|> $q", {"q": q.tolist()})
    assert len(port) == 7 and len({r["id"].id for r in port}) == 7, port


def test_filtered_scan_with_order_limit_is_byte_equal(pair):
    _load_items(pair)
    for sql in (
        "SELECT id, val FROM item WHERE band = 1 AND val > 300 ORDER BY val DESC, id LIMIT 12",
        "SELECT VALUE val FROM item WHERE val < 100 ORDER BY val, id",
        "SELECT band, count() AS n, math::sum(val) AS tot FROM item GROUP BY band",
        "SELECT count() FROM item GROUP ALL",
    ):
        ref, port, _ = pair.run(sql)
        assert _same_bytes(ref, port), (sql, ref, port)


@pytest.mark.parametrize("threshold", [262_144, 1])
def test_bm25_two_phase_matches_reference(pair, monkeypatch, threshold):
    """Global corpus stats, then each shard scores its postings: at the
    default threshold on the host twin, at 1 through K9's match."""
    from surrealdb_tpu_torch.ops import bm25

    monkeypatch.setattr(pcnf, "TPU_FT_ONDEVICE_THRESHOLD", threshold)
    matches = []
    match = bm25.bm25_match_scores
    monkeypatch.setattr(bm25, "bm25_match_scores",
                        lambda *a, **kw: matches.append(1) or match(*a, **kw))
    pair.run("DEFINE TABLE doc SCHEMALESS; "
             "DEFINE ANALYZER simple TOKENIZERS blank,class FILTERS lowercase; "
             "DEFINE INDEX fbody ON doc FIELDS body SEARCH ANALYZER simple BM25")
    rng = np.random.default_rng(4)
    docs = [{"id": i, "body": " ".join(WORDS[int(w)] for w in
                                       rng.integers(0, len(WORDS), size=3 + i % 7))}
            for i in range(300)]
    pair.run("INSERT INTO doc $rows RETURN NONE", {"rows": docs})
    for terms in ("alpha beta", "gamma", "theta eta zeta", "delta eps alpha beta"):
        ref, port, _ = pair.run("SELECT id, search::score(1) AS sc FROM doc "
                                f"WHERE body @1@ '{terms}' ORDER BY sc DESC, id LIMIT 15")
        assert len(ref) == len(port), terms
        rs = np.array([r["sc"] for r in ref])
        ps = np.array([r["sc"] for r in port])
        np.testing.assert_allclose(ps, rs, rtol=RTOL, atol=ATOL)
        for a, b in zip(ref, port):
            if a["id"].id != b["id"].id:  # a tie inside the tolerance
                assert abs(a["sc"] - b["sc"]) <= ATOL + RTOL * abs(a["sc"]), (terms, ref, port)
    # K9's match ran on every node's shard for every query at threshold 1
    assert len(matches) == (4 * 3 if threshold == 1 else 0), len(matches)
    ref, port, _ = pair.run("SELECT id FROM doc WHERE body @@ 'gamma' ORDER BY id")
    assert _same_bytes(ref, port)
    ref, port, _ = pair.run("SELECT id FROM doc WHERE body @@ 'nonexistentterm'")
    assert ref == port == []


def _norm(v) -> str:
    if isinstance(v, list):
        return "[" + ",".join(sorted(_norm(x) for x in v)) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(f"{k}:{_norm(x)}" for k, x in sorted(v.items())) + "}"
    if hasattr(v, "tb") and hasattr(v, "id"):
        return f"{v.tb}:{v.id!r}"
    return repr(v)


def test_two_hop_graph_select_is_set_equal(pair):
    pair.run("DEFINE TABLE person SCHEMALESS; DEFINE TABLE knows SCHEMALESS")
    pair.run("INSERT INTO person $rows RETURN NONE", {"rows": [{"id": i} for i in range(40)]})
    rng = np.random.default_rng(9)
    pairs = {(int(a), int(b)) for a, b in rng.integers(0, 40, size=(120, 2)) if a != b}
    for f, t in sorted(pairs):
        pair.run(f"RELATE person:{f}->knows->person:{t} RETURN NONE")
    for sql in ("SELECT VALUE ->knows->person->knows->person FROM person:0",
                "SELECT VALUE ->knows->person->knows->person FROM person:7",
                "SELECT ->knows->person AS f FROM person:3",
                "SELECT VALUE <-knows<-person<-knows<-person FROM person:11"):
        ref, port, _ = pair.run(sql)
        assert [_norm(v) for v in ref] == [_norm(v) for v in port], sql


def test_placement_matches_reference():
    """Both packages' rings place the same 1,000 keys (ints, strings and
    arrays) on the same owners and RF-2 replica lists."""
    ids = list(range(400)) + [f"k{i}" for i in range(400)] + [[i, "x"] for i in range(200)]
    rr = rplace.HashRing(["n1", "n2", "n3"], vnodes=64)
    pr = pplace.HashRing(["n1", "n2", "n3"], vnodes=64)
    for rid in ids:
        rk, pk = rplace.placement_key("item", rid), pplace.placement_key("item", rid)
        assert rk == pk, rid
        assert rr.owner_of_key(rk) == pr.owner_of_key(pk), rid
        assert rr.owners_of("item", rid, 2) == pr.owners_of("item", rid, 2), rid
    assert pr.spread([pplace.placement_key("item", r) for r in range(1000)]) == rr.spread(
        [rplace.placement_key("item", r) for r in range(1000)])


def test_failover_with_one_node_down_gives_the_same_answers(pair):
    """n3 stops: every record still has a live replica, so the coordinator
    answers the same, flagged `degraded`, and counts the failover."""
    _rows, x = _load_items(pair)
    qs = [x[qi] + np.float32(0.01) for qi in (5, 250, 444)]
    sqls = [("SELECT id, val FROM item WHERE band = 3 ORDER BY val, id LIMIT 20", None)] + [
        (KNN_SQL.format(k=K), {"q": q.tolist()}) for q in qs]
    healthy = [_ok(pair.coord.execute(sql, pair.s, v)[-1]) for sql, v in sqls]
    fo0 = sum(ptel.counters_matching("cluster_failover_total").values())
    pair.servers[2].shutdown()
    pair.down.add(2)
    time.sleep(0.1)
    for i, ((sql, v), want) in enumerate(zip(sqls, healthy)):
        ref = pair.ref.execute(sql, pair.s, v)[-1]["result"]
        resp = pair.coord.execute(sql, pair.s, v)[-1]
        assert resp["status"] == "OK" and resp.get("degraded") is True, resp
        assert resp["result"] == want, sql
        if v is None:
            assert _same_bytes(ref, resp["result"])
        else:
            _assert_same_hits(ref, resp["result"], K, qs[i - 1], x)
    assert sum(ptel.counters_matching("cluster_failover_total").values()) > fo0
