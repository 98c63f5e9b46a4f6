"""The full-text slice of the PyTorch port (surrealdb_tpu_torch/ops/bm25.py,
K9, and the SEARCH index path of Datastore.execute: idx/ft.py,
idx/ft_index.py, idx/ft_mirror.py, idx/ft_search.py) held against the JAX
reference on the same seeded inputs: the reference on the CPU
(JAX_PLATFORMS=cpu), the port with CPU tensors, i.e. the plain PyTorch
version of its kernel.

Tolerances: scores rtol 1e-5, atol 1e-6 (f32 on both sides, the sum over
the terms in another order); ids and their order exact, top-k order
exact on ties (both rank a stable argsort or lax.top_k's order over the
same f32 scores, and tied documents score bit-identically on each side).
Below the device threshold both packages run the same numpy twin, so
their answers are equal exactly.
"""

import gc
import time
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu.kvs.ds import Datastore as RDatastore
from surrealdb_tpu.ops import bm25 as R
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch.ops import bm25 as P
from surrealdb_tpu_torch.kvs.ds import Datastore as PDatastore
from surrealdb_tpu_torch.sql.value import Thing as PThing

RTOL, ATOL = 1e-5, 1e-6


# ------------------------------------------------------------ K9 alone
def _inputs(seed, n, t, tf_dtype, total_len=16_777_216.0 + 3_000):
    """Seeded candidates: a quarter of the rows tie with row 0, one row is
    all zeros, some documents have length 0 (tombstoned), and total_len
    defaults to a value above 2^24 (it rounds as f32)."""
    rng = np.random.default_rng(seed)
    tf = rng.integers(0, 5, size=(n, t)).astype(tf_dtype)
    lens = rng.choice(np.array([0.0, 7.0, 12.0, 30.0], dtype=np.float32), size=n)
    tf[: n // 4], lens[: n // 4] = tf[0], lens[0]
    tf[n // 2] = 0
    df = rng.integers(1, 40_000, size=t).astype(np.float32)
    return tf, df, lens, np.float32(1_000_000.0), np.float32(total_len)


def _ref_scores(tf, df, lens, dc, tl, k1=1.2, b=0.75):
    return np.asarray(R.bm25_scores(jnp.asarray(tf), jnp.asarray(df), jnp.asarray(lens),
                                    jnp.float32(dc), jnp.float32(tl), k1, b))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("tf_dtype", [np.float32, np.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("t", [1, 2, 3, 8, 10])
@pytest.mark.parametrize("n", [1, 7, 1000, 20_000])
def test_scores_match_reference(n, t, tf_dtype):
    tf, df, lens, dc, tl = _inputs(n * 10 + t, n, t, tf_dtype)
    want = _ref_scores(tf, df, lens, dc, tl)
    got = P.bm25_scores(_t(tf), _t(df), _t(lens), dc, tl)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    tied = got[: n // 4]
    assert bool((tied == tied[0]).all()) if n >= 4 else True


@pytest.mark.parametrize("k1,b", [(1.2, 0.75), (2.0, 0.3), (0.9, 1.0)])
def test_scores_follow_k1_and_b(k1, b):
    tf, df, lens, dc, tl = _inputs(5, 500, 2, np.float32, total_len=6_000.0)
    want = _ref_scores(tf, df, lens, dc, tl, k1, b)
    got = P.bm25_scores(_t(tf), _t(df), _t(lens), dc, tl, k1, b)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_total_len_above_2_24_rounds_as_f32():
    """16,777,217 is not an f32: both sides take it as 16,777,216, so the
    scores equal those at that total (and differ from an f64 total's)."""
    tf, df, lens, dc, _ = _inputs(3, 300, 2, np.float32)
    dc = np.float32(1.0)  # avg_len = total_len, so its rounding shows
    a = P.bm25_scores(_t(tf), _t(df), _t(lens), dc, 16_777_217)
    b_ = P.bm25_scores(_t(tf), _t(df), _t(lens), dc, 16_777_216)
    assert torch.equal(a, b_)
    np.testing.assert_allclose(a.numpy(), _ref_scores(tf, df, lens, dc, np.float32(16_777_217)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 5, 10, 250, 1000])
@pytest.mark.parametrize("tf_dtype", [np.float32, np.int32], ids=["f32", "i32"])
def test_topk_matches_reference_order_on_ties(k, tf_dtype):
    """A quarter of the rows tie: lax.top_k's order, larger first and the
    lower index first among equal scores, exactly."""
    tf, df, lens, dc, tl = _inputs(k, 1000, 2, tf_dtype)
    rv, ri = R.bm25_topk(jnp.asarray(tf), jnp.asarray(df), jnp.asarray(lens),
                         jnp.float32(dc), jnp.float32(tl), k)
    gv, gi = P.bm25_topk(_t(tf), _t(df), _t(lens), dc, tl, k)
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=RTOL, atol=ATOL)


def test_topk_of_a_zero_row_is_index_order():
    tf = np.zeros((50, 3), dtype=np.float32)
    df = np.array([10.0, 20.0, 30.0], dtype=np.float32)
    lens = np.full(50, 12.0, dtype=np.float32)
    rv, ri = R.bm25_topk(jnp.asarray(tf), jnp.asarray(df), jnp.asarray(lens),
                         jnp.float32(100), jnp.float32(1200), 7)
    gv, gi = P.bm25_topk(_t(tf), _t(df), _t(lens), 100, 1200, 7)
    assert gi.tolist() == list(range(7)) == np.asarray(ri).tolist()
    assert bool((gv == 0).all()) and bool((np.asarray(rv) == 0).all())


def test_signed_zero_scores_rank_as_lax_top_k():
    """The plain top-k uses f32's total order, as lax.top_k does: +0.0
    above -0.0 (a -0.0 score needs idf < 0 and tf = 0)."""
    s = torch.tensor([-0.0, 0.0, 0.0, -0.0, 1.0])
    v, i = P._descending_total_order(s, 5)
    assert i.tolist() == [4, 1, 2, 0, 3]


def test_wrappers_reject_tensors_off_the_cpu_and_bad_k():
    tf, df, lens, dc, tl = _inputs(1, 10, 2, np.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        P.bm25_scores(_t(tf).to("meta"), _t(df), _t(lens), dc, tl)
    with pytest.raises(ValueError, match="outside"):
        P.bm25_topk(_t(tf), _t(df), _t(lens), dc, tl, 11)
    assert P.SCORES.launches == 0  # CPU tensors launch nothing


def test_score_candidates_takes_the_host_twin_below_the_threshold(monkeypatch):
    tf, df, lens, dc, tl = _inputs(2, 64, 2, np.float32)
    host = P.bm25_scores_host(tf, df, lens, dc, tl)
    np.testing.assert_array_equal(host, R.bm25_scores_host(tf, df, lens, dc, tl))
    monkeypatch.setattr(pcnf, "TPU_FT_ONDEVICE_THRESHOLD", 65)
    np.testing.assert_array_equal(P.score_candidates(torch.device("cpu"), tf, df, lens, dc, tl),
                                  host)
    monkeypatch.setattr(pcnf, "TPU_FT_ONDEVICE_THRESHOLD", 64)
    dev = P.score_candidates(torch.device("cpu"), tf, df, lens, dc, tl)
    np.testing.assert_allclose(dev, _ref_scores(tf, df, lens, dc, tl), rtol=RTOL, atol=ATOL)
    with pytest.raises(RuntimeError, match="no device"):
        P.score_candidates(None, tf, df, lens, dc, tl)
    monkeypatch.setattr(pcnf, "TPU_DISABLE", True)
    np.testing.assert_array_equal(P.score_candidates(None, tf, df, lens, dc, tl), host)


# ------------------------------------------------------------ through Datastore.execute
VOCAB = [f"w{i:04d}" for i in range(2000)]
N_DOCS = 5000


def _docs(n, seed=7):
    """bench.py ingest_docs' generator: 12 words a document from the
    2,000-word vocabulary, word rank r drawn with p ~ 1/(r + 10)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(len(VOCAB)) + 10.0)
    words = np.asarray(VOCAB)[rng.choice(len(VOCAB), size=(n, 12), p=w / w.sum())]
    return [{"id": i, "body": " ".join(words[i])} for i in range(n)]


def _bm25_queries(seed=11, nq=24):
    """bench.py bench_bm25's queries: two words of rank 10-119, ANDed."""
    pairs = np.random.default_rng(seed).integers(10, 120, size=(nq, 2))
    return [("SELECT id, search::score(1) AS sc FROM doc "
             f"WHERE body @1@ '{VOCAB[a]} {VOCAB[b]}' ORDER BY sc DESC LIMIT 10")
            for a, b in pairs]


def _run(ds, sql, vars=None):
    out = ds.execute(sql, vars=vars or {})
    for r in out:
        assert r["status"] == "OK", (sql, r)
    return out[-1]["result"]


def _key(v):
    return (v.tb, v.id) if hasattr(v, "tb") else v


def _assert_same_rows(ref_rows, port_rows, exact_scores=False):
    """Same rows in the same order; `sc` within tolerance (equal when both
    sides scored on the numpy twin); every other field equal."""
    assert len(ref_rows) == len(port_rows)
    for a, b in zip(ref_rows, port_rows):
        assert a.keys() == b.keys()
        for f in a:
            if f == "sc":
                if exact_scores:
                    assert a[f] == b[f]
                else:
                    assert b[f] == pytest.approx(a[f], rel=RTOL, abs=ATOL)
            elif isinstance(a[f], list):
                assert [_key(x) for x in a[f]] == [_key(x) for x in b[f]]
            else:
                assert _key(a[f]) == _key(b[f]), (f, a, b)


_SCHEMA = ("DEFINE ANALYZER simple TOKENIZERS blank FILTERS lowercase; "
           "DEFINE TABLE doc SCHEMALESS; "
           "DEFINE INDEX fbody ON doc FIELDS body SEARCH ANALYZER simple BM25")


@pytest.fixture(scope="module")
def loaded():
    """Config-3-shaped data (5,000 documents) in both packages, ingested
    as bench.py does (bulk INSERT)."""
    ref, port = RDatastore("memory"), PDatastore("memory", device="cpu")
    rows = _docs(N_DOCS)
    for ds in (ref, port):
        _run(ds, _SCHEMA)
        for i in range(0, N_DOCS, 2000):
            _run(ds, "INSERT INTO doc $rows RETURN NONE", {"rows": rows[i:i + 2000]})
    yield ref, port
    ref.close()
    port.close()


@pytest.fixture(params=[4, 1_000_000], ids=["device_branch", "host_twin"])
def threshold(request, monkeypatch):
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "TPU_FT_ONDEVICE_THRESHOLD", request.param)
    return request.param


def test_bench_bm25_queries_match_reference(loaded, threshold):
    ref, port = loaded
    hits = 0
    for sql in _bm25_queries():
        a, b = _run(ref, sql), _run(port, sql)
        _assert_same_rows(a, b, exact_scores=threshold > N_DOCS)
        hits += len(b)
    assert hits > 24 * 3  # the queries match documents


def test_one_broad_term_matches_reference(loaded, threshold):
    """The most common word (~20% of the corpus), every candidate scored."""
    ref, port = loaded
    sql = "SELECT id, search::score(1) AS sc FROM doc WHERE body @1@ 'w0000' ORDER BY sc DESC"
    a, b = _run(ref, sql), _run(port, sql)
    assert len(b) > N_DOCS // 10
    _assert_same_rows(a, b, exact_scores=threshold > N_DOCS)


def test_writes_and_the_transaction_path_match_reference(threshold, monkeypatch):
    """A bulk INSERT, then CREATE / UPDATE / DELETE of one document, and a
    BEGIN ... COMMIT whose SELECT sees its own uncommitted write through
    the KV path (FtIndex.search), on both sides."""
    from surrealdb_tpu_torch.idx import ft_index as PF

    calls = []
    search = PF.FtIndex.search
    monkeypatch.setattr(PF.FtIndex, "search", lambda self, ctx, q: calls.append(q) or
                        search(self, ctx, q))
    ref, port = RDatastore("memory"), PDatastore("memory", device="cpu")
    rows = _docs(400, seed=3)
    sql = ("SELECT id, search::score(1) AS sc FROM doc WHERE body @1@ 'w0001 w0002' "
           "ORDER BY sc DESC LIMIT 10")
    try:
        out = []
        for ds in (ref, port):
            _run(ds, _SCHEMA)
            _run(ds, "INSERT INTO doc $rows RETURN NONE", {"rows": rows})
            res = [_run(ds, sql)]
            _run(ds, "CREATE doc:100000 SET body = 'w0001 w0002 w0001'")
            _run(ds, "UPDATE doc:5 SET body = 'w0002 w0001 zz'")
            _run(ds, "DELETE doc:7")
            res.append(_run(ds, sql))
            txn = ds.execute("BEGIN; CREATE doc:100001 SET body = 'w0001 w0002 yy'; "
                             f"{sql}; COMMIT;")
            assert all(r["status"] == "OK" for r in txn), txn
            res.append(txn[-1]["result"])
            res.append(_run(ds, sql))
            out.append(res)
        assert calls == ["w0001 w0002"]  # the port's in-transaction KV search
        for a, b in zip(*out):
            assert len(b) == 10
            _assert_same_rows(a, b, exact_scores=threshold > N_DOCS)
        assert ("doc", 100001) in [_key(r["id"]) for r in out[1][2]]
        assert ("doc", 7) not in [_key(r["id"]) for r in out[1][1]]
    finally:
        ref.close()
        port.close()


def test_highlight_and_offsets_match_reference(threshold):
    ref, port = RDatastore("memory"), PDatastore("memory", device="cpu")
    try:
        out = []
        for ds in (ref, port):
            _run(ds, "DEFINE ANALYZER simple TOKENIZERS blank,class FILTERS lowercase; "
                     "DEFINE INDEX t_ix ON book FIELDS title SEARCH ANALYZER simple BM25 "
                     "HIGHLIGHTS")
            for i, title in enumerate(["Rust Web Programming", "Programming in Python",
                                       "The Rust Book", "rust and more rust", "Go"]):
                _run(ds, f"CREATE book:{i} SET title = '{title}'")
            out.append(_run(ds, "SELECT id, search::score(1) AS sc, "
                                "search::highlight('<b>', '</b>', 1) AS h, "
                                "search::offsets(1) AS o FROM book WHERE title @1@ 'rust' "
                                "ORDER BY sc DESC"))
        assert [r["h"] for r in out[1]][0].count("<b>") >= 1
        assert len(out[1]) == 3
        _assert_same_rows(out[0], out[1], exact_scores=threshold > 5)
    finally:
        ref.close()
        port.close()


def test_mirror_search_with_stats_override_matches_reference(loaded, threshold):
    """The cluster's merged statistics (dc, tl above 2^24, a df) replace the
    local ones in FtMirror.search; cluster/ is not ported, so the override
    is passed directly."""
    ref, port = loaded
    for ds in (ref, port):  # build both mirrors
        _run(ds, _bm25_queries()[0])
    mirrors = [ds.index_stores.get("test", "test", "doc", "fbody") for ds in (ref, port)]
    terms = ["w0010", "w0020"]
    override = {"dc": 3_000_000, "tl": 36_000_001.0, "df": {"w0010": 400_000.0}}
    (rd, rs), (pd, ps) = (m.search(terms, 1.2, 0.75, stats_override=override) for m in mirrors)
    np.testing.assert_array_equal(pd, rd)
    assert len(pd) > 0
    np.testing.assert_allclose(ps, rs, rtol=RTOL, atol=ATOL)
    _, plain = mirrors[1].search(terms, 1.2, 0.75)
    assert not np.allclose(plain, ps, rtol=1e-3)  # the override changed the scores
    assert mirrors[1].device == torch.device("cpu")


# ------------------------------------------------------------ K9's match over device postings
def _search_order(mirror, terms):
    """The term ids FtMirror.search passes to the match: rarest first, ties
    in query order; None when a term is unknown or has no postings."""
    tids = []
    for t in dict.fromkeys(terms):
        tid = mirror.term_ids.get(t)
        if tid is None or mirror.t_indptr[tid + 1] == mirror.t_indptr[tid]:
            return None
        tids.append(tid)
    return sorted(tids, key=lambda t: mirror.t_indptr[t + 1] - mirror.t_indptr[t])


_MATCH_TERMS = [
    ["w0010", "w0020"], ["w0100"], ["w0000"], ["w0015", "w0015", "w0042"],
    ["w0003", "w0050", "w0007"], ["w1999", "w0001"], ["nope", "w0001"], ["w0011", "w0111"],
    ["w1999", "w1998"],  # both known, no document has both
]


@pytest.mark.parametrize("thr", [1, 4, 1_000_000])
def test_match_plain_equals_reference_search(loaded, thr, monkeypatch):
    """bm25_match_scores_plain over the port mirror's device postings (CPU)
    against the reference's FtMirror.search at each threshold: the same dids
    in the same order, the scores within the f32 tolerance; and the port's
    own search equal to the reference's (bit-equal where both score on the
    numpy twin)."""
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "TPU_FT_ONDEVICE_THRESHOLD", thr)
    ref, port = loaded
    for ds in (ref, port):
        _run(ds, _bm25_queries()[0])
    rm, pm = (ds.index_stores.get("test", "test", "doc", "fbody") for ds in (ref, port))
    post = pm.device_postings(torch.device("cpu"))
    seen, empty = 0, 0
    for terms in _MATCH_TERMS + [q.split("'")[1].split() for q in _bm25_queries()]:
        rd, rs = rm.search(terms, 1.2, 0.75)
        pd, ps = pm.search(terms, 1.2, 0.75)
        np.testing.assert_array_equal(pd, rd)
        if thr > N_DOCS:
            np.testing.assert_array_equal(ps, rs)
        else:
            np.testing.assert_allclose(ps, rs, rtol=RTOL, atol=ATOL)
        tids = _search_order(pm, terms)
        if tids is None:
            assert rd.size == 0
            continue
        df = np.array([post.length(t) for t in tids], dtype=np.float32)
        md, ms = P.bm25_match_scores_plain(post, tids, df, np.float32(pm.dc), np.float32(pm.tl))
        assert md.dtype == np.int64 and ms.dtype == np.float32
        np.testing.assert_array_equal(md, rd)
        np.testing.assert_allclose(ms, rs, rtol=RTOL, atol=ATOL)
        seen += md.size
        empty += md.size == 0
    assert seen > N_DOCS // 10  # the cases match documents (w0000 alone ~20%)
    assert empty >= 1  # and an empty intersection of known words


def test_match_with_stats_override_equals_reference(loaded, monkeypatch):
    """The cluster's merged statistics through the match (threshold 1)."""
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "TPU_FT_ONDEVICE_THRESHOLD", 1)
    ref, port = loaded
    for ds in (ref, port):
        _run(ds, _bm25_queries()[0])
    rm, pm = (ds.index_stores.get("test", "test", "doc", "fbody") for ds in (ref, port))
    override = {"dc": 3_000_000, "tl": 36_000_001.0, "df": {"w0020": 400_000.0}}
    for terms in (["w0010", "w0020"], ["w0020"], ["w0020", "w0003", "w0010"]):
        rd, rs = rm.search(terms, 1.2, 0.75, stats_override=override)
        pd, ps = pm.search(terms, 1.2, 0.75, stats_override=override)
        np.testing.assert_array_equal(pd, rd)
        assert pd.size > 0
        np.testing.assert_allclose(ps, rs, rtol=RTOL, atol=ATOL)


def test_rarest_list_at_the_threshold_with_a_smaller_and_set_gets_the_twin(loaded, monkeypatch):
    """The rarest list reaches the threshold but the AND set does not: the
    match runs and counts, then the query answers with the host path's
    numpy twin, bit-equal to the reference's (which takes its twin too)."""
    ref, port = loaded
    for ds in (ref, port):
        _run(ds, _bm25_queries()[0])
    rm, pm = (ds.index_stores.get("test", "test", "doc", "fbody") for ds in (ref, port))
    terms = ["w0010", "w0020"]
    tids = _search_order(pm, terms)
    rarest = int(pm.t_indptr[tids[0] + 1] - pm.t_indptr[tids[0]])
    and_set = rm.search(terms, 1.2, 0.75)[0].size
    assert 0 < and_set < rarest
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "TPU_FT_ONDEVICE_THRESHOLD", and_set + 1)
    calls = []
    match = P.bm25_match_scores
    monkeypatch.setattr(P, "bm25_match_scores", lambda *a, **k: calls.append(a) or match(*a, **k))
    rd, rs = rm.search(terms, 1.2, 0.75)
    pd, ps = pm.search(terms, 1.2, 0.75)
    assert len(calls) == 1  # the match ran, and its count fell short
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_array_equal(ps, rs)
    twin = P.bm25_scores_host(*_host_inputs(pm, tids, rd))
    np.testing.assert_array_equal(ps, twin)
    for c in (rcnf, pcnf):  # at the AND set's size the device branch answers
        monkeypatch.setattr(c, "TPU_FT_ONDEVICE_THRESHOLD", and_set)
    pd2, ps2 = pm.search(terms, 1.2, 0.75)
    np.testing.assert_array_equal(pd2, rd)
    assert len(calls) == 2 and not np.array_equal(ps2, twin)
    np.testing.assert_allclose(ps2, twin, rtol=RTOL, atol=ATOL)


def _host_inputs(mirror, tids, dids):
    ip, all_d, all_f = mirror.t_indptr, mirror.t_dids, mirror.t_tfs
    tf = np.stack([all_f[ip[t]:ip[t + 1]][np.searchsorted(all_d[ip[t]:ip[t + 1]], dids)]
                   for t in tids], axis=1)
    df = np.array([ip[t + 1] - ip[t] for t in tids], dtype=np.float32)
    return tf, df, mirror.doclen_arr[dids], mirror.dc, mirror.tl


def test_writes_make_a_new_generation_of_device_postings(monkeypatch):
    """CREATE / UPDATE / DELETE (a tombstone) after a device search: the
    next search uploads the new generation and drops the old one, and
    answers as the reference does."""
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "TPU_FT_ONDEVICE_THRESHOLD", 1)
    ref, port = RDatastore("memory"), PDatastore("memory", device="cpu")
    sql = ("SELECT id, search::score(1) AS sc FROM doc WHERE body @1@ 'w0001 w0002' "
           "ORDER BY sc DESC LIMIT 10")
    try:
        for ds in (ref, port):
            _run(ds, _SCHEMA)
            _run(ds, "INSERT INTO doc $rows RETURN NONE", {"rows": _docs(400, seed=3)})
        _assert_same_rows(_run(ref, sql), _run(port, sql))
        pm = port.index_stores.get("test", "test", "doc", "fbody")
        gen0, _, post0 = pm._dev
        old = weakref.ref(post0.dids)
        del post0
        for ds in (ref, port):
            _run(ds, "CREATE doc:100000 SET body = 'w0001 w0002 w0001'")
            _run(ds, "UPDATE doc:5 SET body = 'w0002 w0001 zz'")
            _run(ds, "DELETE doc:7")
        a, b = _run(ref, sql), _run(port, sql)
        _assert_same_rows(a, b)
        assert ("doc", 100000) in [_key(r["id"]) for r in b]
        assert ("doc", 7) not in [_key(r["id"]) for r in b]
        gen1, _, post1 = pm._dev
        assert gen1 > gen0 and post1.length(pm.term_ids["w0001"]) > 0
        gc.collect()
        assert old() is None  # the old generation is gone
        assert P.MATCH.launches == 0  # CPU postings launch nothing
    finally:
        ref.close()
        port.close()


def test_closed_datastore_frees_its_device_postings(monkeypatch):
    """A closed Datastore's device postings are garbage once the caller
    lets go of it."""
    monkeypatch.setattr(pcnf, "TPU_FT_ONDEVICE_THRESHOLD", 1)
    ds = PDatastore("memory", device="cpu")
    try:
        _run(ds, _SCHEMA)
        _run(ds, "INSERT INTO doc $rows RETURN NONE", {"rows": _docs(50)})
        assert _run(ds, "SELECT id FROM doc WHERE body @1@ 'w0000'")
    finally:
        ds.close()
    post = ds.index_stores.get("test", "test", "doc", "fbody")._dev[2]
    refs = [weakref.ref(post.dids), weakref.ref(post.doc_len)]
    del ds, post
    gc.collect()
    assert [r() for r in refs] == [None, None]


def _sweeps_after(advisor, n0, timeout=20.0):
    t0 = time.monotonic()
    while advisor.snapshot()["sweeps"] < n0 and time.monotonic() - t0 < timeout:
        time.sleep(0.02)
    return advisor.snapshot()["sweeps"]


def test_closed_datastore_frees_its_mirrors(monkeypatch):
    """A closed Datastore's index mirrors (the FT mirror, a vector mirror
    and its matrix tensor, the graph mirrors a background prewarm built)
    are garbage once the caller lets go of it, even after the advisor's
    sweep has visited the Datastore and the prewarm's task record stays in
    the background-task registry."""
    from surrealdb_tpu_torch import advisor

    monkeypatch.setattr(pcnf, "TPU_KNN_ONDEVICE_THRESHOLD", 4)
    monkeypatch.setattr(pcnf, "ADVISOR_INTERVAL_SECS", 0.05)
    monkeypatch.setattr(pcnf, "GRAPH_PREWARM_DELAY_SECS", 0.05)
    ds = PDatastore("memory", device="cpu")
    try:
        _run(ds, _SCHEMA)
        _run(ds, "INSERT INTO doc $rows RETURN NONE", {"rows": _docs(50)})
        _run(ds, "SELECT id FROM doc WHERE body @1@ 'w0000'")
        _run(ds, "DEFINE INDEX iv ON item FIELDS emb MTREE DIMENSION 4 DIST EUCLIDEAN")
        _run(ds, "INSERT INTO item $rows RETURN NONE",
             {"rows": [{"id": i, "emb": [float(i), 0.0, 1.0, 2.0]} for i in range(16)]})
        _run(ds, "SELECT id FROM item WHERE emb <|2|> $q", {"q": [1.0, 0.0, 1.0, 2.0]})
        _run(ds, "CREATE p:0; CREATE p:1; RELATE p:0->knows->p:1")
        assert ds.graph_mirrors.wait_prewarm(10)
        n = _sweeps_after(advisor, advisor.snapshot()["sweeps"] + 2)  # it swept this one
    finally:
        ds.close()
    vm = ds.index_stores.get("test", "test", "item", "iv")
    refs = [weakref.ref(ds.index_stores.get("test", "test", "doc", "fbody")),
            weakref.ref(vm), weakref.ref(vm._dev_matrix), weakref.ref(ds.graph_mirrors)]
    del ds, vm
    _sweeps_after(advisor, n + 2)  # sweeps after the close
    gc.collect()
    assert [r() for r in refs] == [None] * 4
    assert advisor.ensure_started() is True  # the service itself runs on


# ------------------------------------------------------------ the reference's own cases
# tests/test_fulltext.py and tests/test_ft_mirror.py, run against the port
@pytest.fixture()
def pds():
    ds = PDatastore("memory", device="cpu")
    yield ds
    ds.close()


def ok(resp):
    assert resp["status"] == "OK", resp
    return resp["result"]


def _setup_books(ds):
    ds.execute(
        "DEFINE ANALYZER simple TOKENIZERS blank,class FILTERS lowercase;"
        "DEFINE INDEX title_ix ON book FIELDS title SEARCH ANALYZER simple BM25 HIGHLIGHTS;"
    )
    ds.execute(
        "CREATE book:1 SET title = 'Rust Web Programming';"
        "CREATE book:2 SET title = 'Programming in Python';"
        "CREATE book:3 SET title = 'The Rust Book';"
    )


def test_fulltext_matches_basic(pds):
    _setup_books(pds)
    r = pds.execute("SELECT VALUE id FROM book WHERE title @@ 'rust' ORDER BY id;")
    assert ok(r[0]) == [PThing("book", 1), PThing("book", 3)]


def test_fulltext_matches_and_semantics(pds):
    _setup_books(pds)
    r = pds.execute("SELECT VALUE id FROM book WHERE title @@ 'rust programming';")
    assert ok(r[0]) == [PThing("book", 1)]


def test_fulltext_matches_no_hit(pds):
    _setup_books(pds)
    assert ok(pds.execute("SELECT * FROM book WHERE title @@ 'golang';")[0]) == []


def test_fulltext_bm25_score(pds):
    _setup_books(pds)
    rows = ok(pds.execute(
        "SELECT id, search::score(1) AS sc FROM book WHERE title @1@ 'rust' ORDER BY sc DESC;"
    )[0])
    assert len(rows) == 2
    assert all(row["sc"] > 0 for row in rows)
    assert rows[0]["sc"] >= rows[1]["sc"]


def test_fulltext_highlight(pds):
    _setup_books(pds)
    rows = ok(pds.execute(
        "SELECT search::highlight('<b>', '</b>', 1) AS h FROM book WHERE title @1@ 'rust' "
        "ORDER BY id;"
    )[0])
    assert rows[0]["h"] == "<b>Rust</b> Web Programming"
    assert rows[1]["h"] == "The <b>Rust</b> Book"


def test_fulltext_index_updates_on_change(pds):
    _setup_books(pds)
    pds.execute("UPDATE book:2 SET title = 'Advanced Rust';")
    r = pds.execute("SELECT VALUE id FROM book WHERE title @@ 'rust' ORDER BY id;")
    assert ok(r[0]) == [PThing("book", 1), PThing("book", 2), PThing("book", 3)]
    pds.execute("DELETE book:1;")
    r = pds.execute("SELECT VALUE id FROM book WHERE title @@ 'rust' ORDER BY id;")
    assert ok(r[0]) == [PThing("book", 2), PThing("book", 3)]


def test_fulltext_matches_explain(pds):
    _setup_books(pds)
    plan = ok(pds.execute("SELECT * FROM book WHERE title @@ 'rust' EXPLAIN;")[0])
    assert plan[0]["operation"] == "Iterate Index"
    assert plan[0]["detail"]["plan"]["index"] == "title_ix"


def test_fulltext_edgengram_analyzer(pds):
    pds.execute(
        "DEFINE ANALYZER auto TOKENIZERS blank FILTERS lowercase, edgengram(2, 10);"
        "DEFINE INDEX name_ix ON user FIELDS name SEARCH ANALYZER auto;"
        "CREATE user:1 SET name = 'jonathan';"
    )
    assert ok(pds.execute("SELECT VALUE id FROM user WHERE name @@ 'jo';")[0]) == [
        PThing("user", 1)]


def test_fulltext_snowball_stemming(pds):
    pds.execute(
        "DEFINE ANALYZER eng TOKENIZERS blank,class FILTERS lowercase, snowball(english);"
        "DEFINE INDEX c_ix ON doc FIELDS body SEARCH ANALYZER eng;"
        "CREATE doc:1 SET body = 'running quickly through the forests';"
    )
    assert ok(pds.execute("SELECT VALUE id FROM doc WHERE body @@ 'run forest';")[0]) == [
        PThing("doc", 1)]


def _setup_body_ix(ds):
    ds.execute(
        "DEFINE ANALYZER simple TOKENIZERS blank,class FILTERS lowercase;"
        "DEFINE INDEX body_ix ON doc FIELDS body SEARCH ANALYZER simple BM25;"
    )


def _body_mirror(ds):
    return ds.index_stores.get("test", "test", "doc", "body_ix")


def test_ft_mirror_built_once_and_maintained(pds):
    _setup_body_ix(pds)
    pds.execute("CREATE doc:1 SET body = 'alpha beta'; CREATE doc:2 SET body = 'alpha gamma';")
    r = pds.execute("SELECT VALUE id FROM doc WHERE body @@ 'alpha' ORDER BY id;")
    assert ok(r[0]) == [PThing("doc", 1), PThing("doc", 2)]
    m = _body_mirror(pds)
    assert m is not None and m.built and m.count() == 2
    pds.execute("CREATE doc:3 SET body = 'alpha delta';")
    pds.execute("UPDATE doc:1 SET body = 'epsilon only';")
    pds.execute("DELETE doc:2;")
    assert _body_mirror(pds) is m
    assert ok(pds.execute("SELECT VALUE id FROM doc WHERE body @@ 'alpha';")[0]) == [
        PThing("doc", 3)]
    assert ok(pds.execute("SELECT VALUE id FROM doc WHERE body @@ 'epsilon';")[0]) == [
        PThing("doc", 1)]
    assert m.count() == 2


def test_ft_mirror_matches_exact_scores(pds):
    """Mirror BM25 scores equal the exact KV-path scores."""
    from surrealdb_tpu_torch.dbs.context import Context
    from surrealdb_tpu_torch.dbs.executor import Executor
    from surrealdb_tpu_torch.dbs.session import Session
    from surrealdb_tpu_torch.idx.ft_index import FtIndex

    _setup_body_ix(pds)
    for i in range(30):
        words = " ".join(f"w{j}" for j in range(i % 5 + 1)) + (" common" * (i % 3 + 1))
        pds.execute(f"CREATE doc:{i} SET body = '{words}';")
    q = "SELECT id, search::score(1) AS s FROM doc WHERE body @1@ 'common w1' ORDER BY id;"
    mirror_rows = ok(pds.execute(q)[0])
    ex = Executor(pds, Session.owner())
    txn = pds.transaction(False)
    ex.txn = txn
    try:
        ctx = Context(ex, ex.session)
        ix = txn.all_tb_indexes("test", "test", "doc")[0]
        exact = {(rid.tb, repr(rid.id)): s
                 for rid, s in FtIndex.for_index(ctx, ix).search(ctx, "common w1")}
    finally:
        txn.cancel()
    assert len(mirror_rows) == len(exact) > 0
    for row in mirror_rows:
        assert row["s"] == pytest.approx(exact[(row["id"].tb, repr(row["id"].id))], rel=1e-5)


def test_ft_mirror_uncommitted_writes_use_exact_overlay(pds):
    _setup_body_ix(pds)
    pds.execute("CREATE doc:1 SET body = 'alpha';")
    pds.execute("SELECT * FROM doc WHERE body @@ 'alpha';")
    m = _body_mirror(pds)
    out = pds.execute("BEGIN; CREATE doc:9 SET body = 'alpha zulu'; "
                      "SELECT VALUE id FROM doc WHERE body @@ 'zulu'; COMMIT;")
    assert ok(out[-1]) == [PThing("doc", 9)]
    assert m.count() == 2
    pds.execute("BEGIN; CREATE doc:10 SET body = 'alpha yankee'; CANCEL;")
    assert m.count() == 2
    assert ok(pds.execute("SELECT VALUE id FROM doc WHERE body @@ 'yankee';")[0]) == []


def test_ft_mirror_device_path_through_query(pds, monkeypatch):
    """Across TPU_FT_ONDEVICE_THRESHOLD through a real SQL query: the
    device branch (here the plain version) scores as the host twin does."""
    monkeypatch.setattr(pcnf, "TPU_FT_ONDEVICE_THRESHOLD", 4)
    _setup_body_ix(pds)
    for i in range(12):
        pds.execute(f"CREATE doc:{i} SET body = 'shared word{i}';")
    q = "SELECT id, search::score(1) AS s FROM doc WHERE body @1@ 'shared' ORDER BY id;"
    rows = ok(pds.execute(q)[0])
    assert len(rows) == 12
    monkeypatch.setattr(pcnf, "TPU_FT_ONDEVICE_THRESHOLD", 10_000)
    rows_host = ok(pds.execute(q)[0])
    for a, b in zip(rows, rows_host):
        assert a["s"] == pytest.approx(b["s"], rel=1e-4)


def test_ft_mirror_highlight_still_works(pds):
    pds.execute(
        "DEFINE ANALYZER simple TOKENIZERS blank,class FILTERS lowercase;"
        "DEFINE INDEX body_ix ON doc FIELDS body SEARCH ANALYZER simple BM25 HIGHLIGHTS;"
    )
    pds.execute("CREATE doc:1 SET body = 'alpha beta gamma';")
    r = pds.execute("SELECT search::highlight('<b>', '</b>', 1) AS h FROM doc WHERE body @1@ 'beta';")
    assert ok(r[0])[0]["h"] == "alpha <b>beta</b> gamma"


def test_ft_mirror_zero_token_doc_dc_accounting(pds):
    from surrealdb_tpu_torch.dbs.session import Session

    s = Session.owner()
    s.ns, s.db = "test", "test"
    pds.execute("DEFINE ANALYZER a TOKENIZERS blank FILTERS lowercase; "
                "DEFINE TABLE d SCHEMALESS; "
                "DEFINE INDEX f ON d FIELDS body SEARCH ANALYZER a BM25;", s)
    pds.execute("INSERT INTO d $rows", s, vars={"rows": [
        {"id": i, "body": "alpha beta"} for i in range(10)]})
    pds.execute("SELECT id FROM d WHERE body @1@ 'alpha'", s)
    mirror = pds.index_stores.get("test", "test", "d", "f")
    base = mirror.count()
    for _ in range(3):
        pds.execute("CREATE d:999 SET body = ''", s)
        pds.execute("DELETE d:999", s)
    assert mirror.count() == base, (mirror.count(), base)
    out = pds.execute("SELECT count() FROM d WHERE body @1@ 'alpha' GROUP ALL", s)
    assert out[-1]["result"][0]["count"] == 10
