"""The graph slice of the PyTorch port (surrealdb_tpu_torch/idx/graph_csr.py:
K6 chain_kernel, K7 chain_count_batch, K8 dense_count_batch and the device
half of GraphMirrors) held against the JAX reference on the same inputs: the
reference on the CPU (JAX_PLATFORMS=cpu), the port with CPU tensors, i.e.
the plain PyTorch versions of its kernels.

Every comparison is exact: integer counts, node ids and result order (the
reference's counts are exact integers, and chain() emits records in
ascending intern order, so the order is part of the result).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu.idx import graph_csr as R
from surrealdb_tpu.kvs.ds import Datastore as RDatastore
from surrealdb_tpu.sql.value import Thing as RThing
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch import telemetry as ptel
from surrealdb_tpu_torch.idx import graph_csr as P
from surrealdb_tpu_torch.kvs.ds import Datastore as PDatastore
from surrealdb_tpu_torch.sql.value import Thing as PThing


def _ref_kernel(name):
    R._kernels()
    return R._JITTED[name]


def _csr(rng, n_nodes, cap, n_edges):
    """A pow2-padded CSR as PointerCsr.ensure_arrays lays it out: random
    edges over ids < n_nodes, six parallel copies of one edge, node 1
    isolated. Returns (indptr, indices, pow2 max degree) as numpy."""
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    src[:6], dst[:6] = src[0], dst[0]
    src[src == 1] = 2
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(cap + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    md = 1 << max(int(indptr.max()) - 1, 0).bit_length()
    indptr = np.cumsum(indptr).astype(np.int32)
    indices = np.zeros(1 << max(n_edges - 1, 0).bit_length(), dtype=np.int32)
    indices[:n_edges] = dst[order]
    return indptr, indices, md


def _frontier(rng, n, width, fill, k):
    """k seeds (some of weight 0, one negative id), sentinels after."""
    fr = np.full(width, fill, dtype=np.int32)
    w = np.zeros(width, dtype=np.int32)
    fr[:k] = rng.integers(0, n, k)
    w[:k] = rng.integers(0, 4, k)
    fr[k // 2] = -3
    return fr, w


def _both(arrs):
    """The same arrays for the reference (jnp) and the port (torch)."""
    return (tuple(jnp.asarray(a) for a in arrs),
            tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs))


# ------------------------------------------------------------ function level
CHAIN_CASES = [
    # (label, n_nodes, n_cap, mirror caps per hop, out_sizes, frontier width)
    ("one hop", 150, 256, [[256]], [256], 64),
    ("several mirrors in a hop", 150, 256, [[256], [256, 256]], [256, 128], 64),
    ("out_size truncation", 150, 256, [[256], [256]], [256, 8], 64),
    ("mirror cap below n_cap", 200, 256, [[128], [256]], [256, 256], 32),
    ("three hops", 150, 256, [[256], [256], [256]], [256, 256, 64], 16),
]


@pytest.mark.parametrize("count_only", [False, True], ids=["expand", "count"])
@pytest.mark.parametrize("case", CHAIN_CASES, ids=lambda c: c[0])
def test_chain_kernel_matches_reference(case, count_only):
    label, n_nodes, n_cap, caps, outs, width = case
    rng = np.random.default_rng(len(label))
    hops_r, hops_p, mds = [], [], []
    for hop_caps in caps:
        ms = [_csr(rng, min(n_nodes, cap), cap, 6 * n_nodes) for cap in hop_caps]
        pairs = [_both(m[:2]) for m in ms]
        hops_r.append(tuple(r for r, _ in pairs))
        hops_p.append(tuple(p for _, p in pairs))
        mds.append(tuple(m[2] for m in ms))
    fr, w = _frontier(rng, n_nodes, width, n_cap, width // 2)
    fr[-1], w[-1] = n_cap - 1, 5  # a node past every mirror's nodes
    want = _ref_kernel("chain")(
        tuple(hops_r), jnp.asarray(fr), jnp.asarray(w), mds=tuple(mds), n_cap=n_cap,
        out_sizes=tuple(outs), count_only=count_only,
    )
    got = P.chain_kernel(tuple(hops_p), torch.from_numpy(fr), torch.from_numpy(w), tuple(mds),
                         n_cap, tuple(outs), count_only)
    if count_only:
        assert got.dtype == torch.int32 and int(got) == int(want) > 0
        return
    assert got[0].dtype == got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if label == "out_size truncation":
        assert bool((got[1] > 0).all())


def _wrap_and_sentinel_csr(n_cap):
    """Node 0 reaches node 5 by 3 parallel edges, node 6 by 4, node 8 by 2
    and node 7 by 1; node 2 reaches the sentinel n_cap, ids past it and a
    negative id (clipped to node 0)."""
    adj = {0: [5] * 3 + [6] * 4 + [8] * 2 + [7], 2: [n_cap, n_cap + 9, 1 << 30, -4, 3]}
    indptr = np.zeros(n_cap + 1, dtype=np.int32)
    for src, dst in adj.items():
        indptr[src + 1] = len(dst)
    indptr = np.cumsum(indptr).astype(np.int32)
    indices = np.zeros(16, dtype=np.int32)
    flat = [d for src in sorted(adj) for d in adj[src]]
    indices[:len(flat)] = flat
    return indptr, indices, 16


@pytest.mark.parametrize("count_only", [False, True], ids=["expand", "count"])
def test_chain_kernel_wrapped_counts_and_the_sentinel_match_reference(count_only):
    """int32 counts that wrap: 3 x 2^30 (negative), 4 x 2^30 (zero) and
    2 x 2^30 (-2^31) stay absent, as the reference's signed `dense > 0`
    has them, 2^30 stays; a frontier that touches the sentinel drops it
    (ids at and past n_cap) and counts a negative id at node 0."""
    n_cap = 64
    ptr, idx, md = _wrap_and_sentinel_csr(n_cap)
    (ptr_r, idx_r), (ptr_p, idx_p) = _both((ptr, idx))
    fr = np.array([0, 2, 2, n_cap, 9, 0], dtype=np.int32)
    w = np.array([1 << 30, 1, 2, 7, 0, 0], dtype=np.int32)
    hops_r = (((ptr_r, idx_r),), ((ptr_r, idx_r),))
    hops_p = (((ptr_p, idx_p),), ((ptr_p, idx_p),))
    outs = (16, 16)
    want = _ref_kernel("chain")(hops_r, jnp.asarray(fr), jnp.asarray(w), mds=((md,), (md,)),
                                n_cap=n_cap, out_sizes=outs, count_only=count_only)
    got = P.chain_kernel(hops_p, torch.from_numpy(fr), torch.from_numpy(w), ((md,), (md,)),
                         n_cap, outs, count_only)
    if count_only:
        assert int(got) == int(want)
        return
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    one = P.chain_kernel(hops_p[:1], torch.from_numpy(fr), torch.from_numpy(w), ((md,),),
                         n_cap, outs[:1], False)
    live = one[0][one[1] > 0].tolist()
    assert live == [0, 3, 7] and one[1][:3].tolist() == [3, 3, 1 << 30]


CSC_CASES = [
    # (label, hops, lanes)
    ("1-hop count", 0, 32),
    ("one CSC hop", 1, 32),
    ("two CSC hops, one lane", 2, 1),
    ("three CSC hops", 3, 32),
]


@pytest.mark.parametrize("case", CSC_CASES, ids=lambda c: c[0])
def test_chain_count_batch_matches_reference(case):
    label, hops, lanes = case
    rng = np.random.default_rng(hops + lanes)
    n_nodes, n_cap = 180, 256
    csc_r, csc_p, last = [], [], None
    for h in range(hops + 1):
        indptr, indices, _ = _csr(rng, n_nodes, n_cap, 900)
        r, p = _both(P.csc_arrays(indptr, indices))
        csc_r.append((r,))
        csc_p.append((p,))
        last = _both([indptr])
    if hops:  # the first hop has two mirrors
        indptr, indices, _ = _csr(rng, n_nodes, n_cap, 500)
        r, p = _both(P.csc_arrays(indptr, indices))
        csc_r[0], csc_p[0] = csc_r[0] + (r,), csc_p[0] + (p,)
    seeds = [_frontier(rng, n_nodes, 16, n_cap, 3) for _ in range(lanes)]
    fr = np.stack([s[0] for s in seeds])
    w = np.stack([s[1] for s in seeds])
    want = _ref_kernel("chain_count_batch")(
        tuple(csc_r[:hops]), (last[0],), jnp.asarray(fr), jnp.asarray(w), n_cap=n_cap
    )
    got = P.chain_count_batch(tuple(csc_p[:hops]), (last[1],), torch.from_numpy(fr),
                              torch.from_numpy(w), n_cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got > 0).any())


def test_chain_count_batch_narrow_first_hop_matches_reference():
    """An interner grown after a mirror's compaction: the first hop's
    mirror has cap 64 while n_cap is 256, so its output is 65 wide and the
    next hop's gathers past that width read the zero column."""
    rng = np.random.default_rng(12)
    p1, i1, _ = _csr(rng, 60, 64, 300)
    p2, i2, _ = _csr(rng, 200, 256, 900)
    p3, _, _ = _csr(rng, 200, 256, 900)
    (c1r, c1p), (c2r, c2p) = _both(P.csc_arrays(p1, i1)), _both(P.csc_arrays(p2, i2))
    (l3r,), (l3p,) = _both([p3])
    seeds = [_frontier(rng, 60, 8, 256, 4) for _ in range(32)]
    fr = np.stack([s[0] for s in seeds])
    w = np.stack([s[1] for s in seeds])
    want = _ref_kernel("chain_count_batch")(
        ((c1r,), (c2r,)), ((l3r,),), jnp.asarray(fr), jnp.asarray(w), n_cap=256
    )
    got = P.chain_count_batch(((c1p,), (c2p,)), ((l3p,),), torch.from_numpy(fr),
                              torch.from_numpy(w), 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got > 0).any())


def _edge_table_csrs(rng, persons, edges, second_source):
    """person -> edge record -> person as an edge table lays it out in one
    node space (persons first, then the records): the person->record CSR,
    in which every record has one source (or, with second_source, one
    record two), and the record->person CSR."""
    pairs = rng.integers(0, persons, (edges, 2))
    n_cap = 1 << (persons + edges - 1).bit_length()
    src, dst = pairs[:, 0], np.arange(persons, persons + edges)
    if second_source:  # person 3 also points at record 0
        src, dst = np.append(src, 3), np.append(dst, persons)

    def csr(a, b):
        order = np.argsort(a, kind="stable")
        indptr = np.zeros(n_cap + 1, dtype=np.int64)
        np.add.at(indptr, a + 1, 1)
        indices = np.zeros(1 << (len(a) - 1).bit_length(), dtype=np.int32)
        indices[: len(a)] = b[order]
        return np.cumsum(indptr).astype(np.int32), indices

    return csr(src, dst), csr(np.arange(persons, persons + edges), pairs[:, 1]), n_cap


@pytest.mark.parametrize("second_source", [False, True], ids=["one-source", "two-sources"])
def test_chain_count_batch_edge_table_chain_matches_reference(second_source):
    """person->edge->person->edge->person (four CSC hops, then the degree
    over person->edge) where every edge record has one source, so the port
    fuses each (->edge, edge->person) pair on the card, and where one
    record has two (the pairs run hop by hop); the plain versions here,
    against the reference's chain_count_batch."""
    rng = np.random.default_rng(31 + second_source)
    (pk_ptr, pk_idx), (kp_ptr, kp_idx), n_cap = _edge_table_csrs(rng, 40, 300, second_source)
    pk_r, pk_p = _both(P.csc_arrays(pk_ptr, pk_idx))
    kp_r, kp_p = _both(P.csc_arrays(kp_ptr, kp_idx))
    (last_r,), (last_p,) = _both([pk_ptr])
    seeds = [_frontier(rng, 40, 8, n_cap, 3) for _ in range(32)]
    fr = np.stack([s[0] for s in seeds])
    w = np.stack([s[1] for s in seeds])
    fr[0, 0], w[0, 0] = 3, 2  # person 3, the second source's, seeded
    want = _ref_kernel("chain_count_batch")(
        ((pk_r,), (kp_r,), (pk_r,), (kp_r,)), ((last_r,),), jnp.asarray(fr), jnp.asarray(w),
        n_cap=n_cap,
    )
    got = P.chain_count_batch(((pk_p,), (kp_p,), (pk_p,), (kp_p,)), ((last_p,),),
                              torch.from_numpy(fr), torch.from_numpy(w), n_cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got > 0).any())
    assert P.csc_facts(*pk_p)[1] is (not second_source)


@pytest.mark.parametrize("lanes", [8, 32])
@pytest.mark.parametrize("products", [0, 1, 2])
def test_dense_count_batch_matches_reference(products, lanes):
    rng = np.random.default_rng(products * 10 + lanes)
    n_src, n0 = 300, 384
    a = np.zeros((n0, n0), dtype=np.float32)
    np.add.at(a, (rng.integers(0, n_src, 4000), rng.integers(0, n_src, 4000)), 1.0)
    outdeg = a.sum(1).astype(np.float32)
    seeds = [_frontier(rng, n_src, 16, n0, 3) for _ in range(lanes)]
    fr = np.stack([s[0] for s in seeds])
    w = np.stack([s[1] for s in seeds])
    want = _ref_kernel("dense_count_batch")(
        (jnp.asarray(a.astype(ml_dtypes.bfloat16)),) * products, jnp.asarray(outdeg),
        jnp.asarray(fr), jnp.asarray(w), n0=n0,
    )
    got = P.dense_count_batch((torch.from_numpy(a).to(torch.bfloat16),) * products,
                              torch.from_numpy(outdeg), torch.from_numpy(fr),
                              torch.from_numpy(w), n0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_count_batch_chain_of_unequal_widths_matches_reference():
    """[n0, n1] then [n1, n2] with n0 != n1 != n2; seeds with negative ids,
    ids at and past n0, and weights of 0 and below."""
    rng = np.random.default_rng(77)
    n0, n1, n2 = 300, 200, 520
    mats = []
    for r, c in ((n0, n1), (n1, n2)):
        a = np.zeros((r, c), dtype=np.float32)
        np.add.at(a, (rng.integers(0, r, 3000), rng.integers(0, c, 3000)), 1.0)
        mats.append(a)
    outdeg = rng.integers(0, 5, n2).astype(np.float32)
    fr = np.full((8, 16), n0, dtype=np.int32)
    w = np.zeros((8, 16), dtype=np.int32)
    fr[:, :4] = rng.integers(0, n0, (8, 4))
    w[:, :4] = rng.integers(1, 4, (8, 4))
    fr[:, 4:8] = [-3, n0 + 7, 5, 6]
    w[:, 4:8] = [2, 1, 0, -2]
    want = _ref_kernel("dense_count_batch")(
        tuple(jnp.asarray(a.astype(ml_dtypes.bfloat16)) for a in mats), jnp.asarray(outdeg),
        jnp.asarray(fr), jnp.asarray(w), n0=n0,
    )
    got = P.dense_count_batch(tuple(torch.from_numpy(a).to(torch.bfloat16) for a in mats),
                              torch.from_numpy(outdeg), torch.from_numpy(fr),
                              torch.from_numpy(w), n0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got > 0).all())


def test_pointer_csr_arrays_match_reference():
    """Host compaction and the destination-sorted CSC (padding edges on the
    sentinel) are the reference's, array for array."""
    rng = np.random.default_rng(4)
    rit, pit = R.NodeInterner(), P.NodeInterner()
    for i in range(70):
        rit.intern(RThing("p", i))
        pit.intern(PThing("p", i))
    adj = {}
    for s, d in zip(rng.integers(0, 60, 300), rng.integers(0, 70, 300)):
        if int(d) not in adj.setdefault(int(s), []):
            adj[int(s)].append(int(d))
    rm, pm = R.PointerCsr(rit), P.PointerCsr(pit)
    rm.load({k: list(v) for k, v in adj.items()})
    pm.load({k: list(v) for k, v in adj.items()})
    for got, want in zip(pm.device_arrays("cpu") + pm.device_csc("cpu"),
                         rm.device_arrays() + rm.device_csc()):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pm.max_degree == rm.max_degree


def test_cpu_tensors_launch_no_graph_kernel():
    """CPU tensors take the plain versions: no launch counter moves."""
    for c in P.KERNELS:
        c.reset()
    rng = np.random.default_rng(0)
    indptr, indices, md = _csr(rng, 50, 64, 200)
    (ptr, idx) = _both([indptr, indices])[1]
    fr, w = (torch.from_numpy(a) for a in _frontier(rng, 50, 8, 64, 4))
    P.chain_kernel((((ptr, idx),),), fr, w, ((md,),), 64, (64,), False)
    cptr, csrc = _both(P.csc_arrays(indptr, indices))[1]
    P.chain_count_batch((((cptr, csrc),),), ((ptr,),), fr[None], w[None], 64)
    A = torch.zeros((128, 128), dtype=torch.bfloat16)
    P.dense_count_batch((A,), torch.zeros(128), fr[None], w[None], 128)
    assert [c.launches for c in P.KERNELS] == [0, 0, 0]


# ------------------------------------------------------------ slice level
ROUTES = {
    # the defaults: these small graphs stay on the host hop path
    "host": {},
    # every hop on the device (plain versions here), counts by the dense form
    "dense": dict(TPU_GRAPH_ONDEVICE_THRESHOLD=1, TPU_GRAPH_COUNT_EDGES=1),
    # ... and counts by the CSC form: no table fits the dense operator
    "csc": dict(TPU_GRAPH_ONDEVICE_THRESHOLD=1, TPU_GRAPH_COUNT_EDGES=1,
                TPU_GRAPH_DENSE_MAX=0),
}


@pytest.fixture(params=sorted(ROUTES))
def route(request):
    return request.param


@pytest.fixture()
def pair(route, monkeypatch):
    for c in (rcnf, pcnf):
        for k, v in ROUTES[route].items():
            monkeypatch.setattr(c, k, v)
    ref, port = RDatastore("memory"), PDatastore("memory", device="cpu")
    yield ref, port
    ref.close()
    port.close()


def _plain(v):
    """A result with each package's Things as (table, id) pairs."""
    if isinstance(v, (RThing, PThing)):
        return (v.tb, v.id)
    if isinstance(v, list):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


def _same(pair, sql, vars=None):
    """Run sql on both Datastores; every statement's status and result must
    be identical, order included. Returns the last result."""
    ref, port = pair
    r, p = ref.execute(sql, vars=vars or {}), port.execute(sql, vars=vars or {})
    assert [x["status"] for x in p] == [x["status"] for x in r], (sql, r, p)
    for x, y in zip(r, p):
        assert _plain(y["result"]) == _plain(x["result"]), sql
    return _plain(p[-1]["result"])


def _same_kv_walk(pair, sql):
    """A transaction with its own edge writes: the exact KV walk answers,
    in the key order of edge ids each package draws at random, so the last
    result compares as a multiset. Returns it sorted."""
    ref, port = pair
    r, p = ref.execute(sql), port.execute(sql)
    assert [x["status"] for x in p] == [x["status"] for x in r] and r[-1]["status"] == "OK"
    got, want = _plain(p[-1]["result"])[0], _plain(r[-1]["result"])[0]
    assert sorted(got) == sorted(want), sql
    return sorted(got)


def _setup(pair, sql, vars=None):
    """Run writes on both Datastores (each package draws its own random
    edge ids, so only the statuses compare)."""
    for ds in pair:
        out = ds.execute(sql, vars=vars or {})
        assert all(x["status"] == "OK" for x in out), (sql, out)


def _routes():
    counters = ptel.snapshot()["counters"]
    return {sub: sum(v for k, v in counters.items()
                     if k.startswith("compile_cache{") and f'subsystem="{sub}"' in k)
            for sub in ("graph_dense", "graph_csc", "graph_chain")}


def test_multi_hop_chain(pair, route):
    _setup(pair, "CREATE p:0; CREATE p:1; CREATE p:2; CREATE p:3; CREATE p:4;"
                 "RELATE p:0->knows->p:1; RELATE p:1->knows->p:2;"
                 "RELATE p:2->knows->p:3; RELATE p:1->knows->p:4;")
    for ds in pair:  # the ingest-armed build and warm-up calls come first
        assert ds.graph_mirrors.wait_prewarm(timeout=60)
    r0 = _routes()
    out = _same(pair, "SELECT VALUE ->knows->p->knows->p->knows->p FROM p:0")
    assert out == [[("p", 3)]]
    assert _same(pair, "SELECT count(->knows->p->knows->p) AS c FROM p:0") == [{"c": 2}]
    calls = {k: v - r0[k] for k, v in _routes().items()}
    if route == "host":
        assert calls == {"graph_dense": 0, "graph_csc": 0, "graph_chain": 0}
    else:  # the expand's three hops in one chain; the count by its route's form
        want = {"graph_chain": 1, "graph_dense": 0, "graph_csc": 0}
        want["graph_dense" if route == "dense" else "graph_csc"] = 1
        assert calls == want


def test_incremental_deltas(pair):
    _setup(pair, "CREATE p:0; CREATE p:1; CREATE p:2; RELATE p:0->knows->p:1;")
    q = "SELECT VALUE ->knows->p FROM p:0"
    assert _same(pair, q) == [[("p", 1)]]
    _setup(pair, "RELATE p:0->knows->p:2;")
    assert _same(pair, q) == [[("p", 1), ("p", 2)]]
    _setup(pair, "DELETE p:0->knows WHERE out = p:1;")
    assert _same(pair, q) == [[("p", 2)]]
    _setup(pair, "CREATE p:9; RELATE p:2->knows->p:9;")  # a node interned after the build
    assert _same(pair, "SELECT count(->knows->p->knows->p) AS c FROM p:0") == [{"c": 1}]


def test_transaction_with_edge_writes_falls_back(pair):
    _setup(pair, "CREATE p:0; CREATE p:1; RELATE p:0->knows->p:1;")
    _same(pair, "SELECT VALUE ->knows->p FROM p:0")
    out = _same_kv_walk(pair, "BEGIN; CREATE p:2; RELATE p:0->knows->p:2;"
                              " SELECT VALUE ->knows->p FROM p:0; COMMIT;")
    assert out == [("p", 1), ("p", 2)]
    assert sorted(_same(pair, "SELECT VALUE ->knows->p FROM p:0")[0]) == [("p", 1), ("p", 2)]


def test_rerelate_then_delete(pair):
    _setup(pair, "CREATE p:0; CREATE p:1; RELATE p:0->knows:1->p:1;")
    q = "SELECT VALUE ->knows->p FROM p:0"
    assert _same(pair, q) == [[("p", 1)]]
    _setup(pair, "RELATE p:0->knows:1->p:1;")
    assert _same(pair, q) == [[("p", 1)]]
    _setup(pair, "DELETE knows:1;")
    assert _same(pair, q) == [[]]


def test_remove_database_drops_mirrors(pair):
    _setup(pair, "CREATE p:0; CREATE p:1; RELATE p:0->knows->p:1;")
    q = "SELECT VALUE ->knows->p FROM p:0"
    assert _same(pair, q) == [[("p", 1)]]
    _setup(pair, "REMOVE DATABASE test;")
    _setup(pair, "CREATE p:0;")
    assert _same(pair, q) == [[]]


def test_parallel_edges_keep_multiplicity(pair):
    # edge ids fixed: the answer follows the edges' key order, which random
    # ids would make differ between the two packages
    _setup(pair, "CREATE p:0; CREATE p:1; CREATE p:2;"
                 "RELATE p:0->knows:1->p:1; RELATE p:0->knows:2->p:1; RELATE p:0->knows:3->p:2;")
    q = "SELECT VALUE ->knows->p FROM p:0"
    assert _same(pair, q) == [[("p", 1), ("p", 1), ("p", 2)]]
    out = _same_kv_walk(
        pair, "BEGIN; RELATE p:0->knows:4->p:2; SELECT VALUE ->knows->p FROM p:0; COMMIT;")
    assert out == [("p", 1), ("p", 1), ("p", 2), ("p", 2)]
    assert _same(pair, q) == [[("p", 1), ("p", 1), ("p", 2), ("p", 2)]]


def test_converging_paths_count_twice(pair):
    _setup(pair, "CREATE p:0; CREATE p:1; CREATE p:2; CREATE p:3;"
                 "RELATE p:0->knows->p:1; RELATE p:0->knows->p:2;"
                 "RELATE p:1->knows->p:3; RELATE p:2->knows->p:3;")
    assert _same(pair, "SELECT VALUE ->knows->p->knows->p FROM p:0") == [[("p", 3), ("p", 3)]]


def test_count_fast_path_equals_the_expansion(pair):
    rows = [{"id": i} for i in range(20)]
    _setup(pair, "DEFINE TABLE p SCHEMALESS; INSERT INTO p $rows;", {"rows": rows})
    rels = [(i, (i + j) % 20) for i in range(20) for j in (1, 2, 3)] + [(0, 1)]
    for ds, thing in zip(pair, (RThing, PThing)):  # edge ids fixed: one KV order in both
        ds.execute("INSERT RELATION INTO knows $rows;", vars={"rows": [
            {"id": thing("knows", k), "in": thing("p", a), "out": thing("p", b)}
            for k, (a, b) in enumerate(rels)]})
    n = _same(pair, "SELECT count(->knows->p->knows->p) AS c FROM p:0;")[0]["c"]
    expanded = _same(pair, "SELECT ->knows->p->knows->p AS e FROM p:0;")[0]["e"]
    assert n == len(expanded) == 12


# ------------------------------------------------------------ config 1, small
NODES, EDGES = 200, 4000  # bench config 1's shape (uniform `knows`), cut 50x / 250x
CHAIN3 = "->knows->person->knows->person->knows->person"
CHAIN5 = "->knows->person->knows->person->knows"
CHAIN2 = "->knows->person->knows->person"


@pytest.fixture(scope="module")
def config1():
    """Both packages ingest the seeded pairs as bench.py ingest_person_graph
    does, with the thresholds lowered so the small graph takes config 1's
    routes: counts to the device from the seed, expands after three host
    hops, with persons and not knows records in the dense form's range.
    The edges get their pair's index as id and the ingest-time
    prewarm is off, so the first query builds the mirrors in one order and
    both packages intern the same ids (result order is intern order)."""
    mp = pytest.MonkeyPatch()
    for c in (rcnf, pcnf):
        mp.setattr(c, "TPU_GRAPH_COUNT_EDGES", 1000)
        mp.setattr(c, "TPU_GRAPH_ONDEVICE_THRESHOLD", 64)
        mp.setattr(c, "GRAPH_PREWARM", False)
        mp.setattr(c, "TPU_GRAPH_DENSE_MAX", 1000)  # persons fit the dense form, knows not
    pairs = np.random.default_rng(1).integers(0, NODES, size=(EDGES, 2))
    ref, port = RDatastore("memory"), PDatastore("memory", device="cpu")
    for ds, thing in ((ref, RThing), (port, PThing)):
        ds.execute("DEFINE TABLE person SCHEMALESS; DEFINE TABLE knows SCHEMALESS")
        ds.execute("INSERT INTO person $rows RETURN NONE",
                   vars={"rows": [{"id": j} for j in range(NODES)]})
        for i in range(0, EDGES, 1000):
            ds.execute("INSERT RELATION INTO knows $rows RETURN NONE", vars={"rows": [
                {"id": i + j, "in": thing("person", int(a)), "out": thing("person", int(b))}
                for j, (a, b) in enumerate(pairs[i:i + 1000])]})
        # the first chain builds both tables' mirrors, person first
        assert ds.execute(f"SELECT count({CHAIN2}) AS c FROM person:0")[-1]["status"] == "OK"
    yield (ref, port), pairs
    ref.close()
    port.close()
    mp.undo()


def _numpy_hops(pairs, seed, n):
    v = np.zeros(NODES)
    v[seed] = 1.0
    out = []
    for _ in range(n):
        v = np.bincount(pairs[:, 1], weights=v[pairs[:, 0]], minlength=NODES)
        out.append(v)
    return out


@pytest.mark.parametrize("seed", [3, 77, 150])
def test_config1_counts_match_reference_and_numpy(config1, seed):
    pair, pairs = config1
    want = int(_numpy_hops(pairs, seed, 3)[-1].sum())
    r0 = _routes()
    assert _same(pair, f"SELECT count({CHAIN3}) AS c FROM person:{seed}") == [{"c": want}]
    r1 = _routes()
    assert _same(pair, f"SELECT count({CHAIN5}) AS c FROM person:{seed}") == [{"c": want}]
    r2 = _routes()
    assert (r1["graph_dense"] - r0["graph_dense"], r1["graph_csc"] - r0["graph_csc"]) == (1, 0)
    assert (r2["graph_dense"] - r1["graph_dense"], r2["graph_csc"] - r1["graph_csc"]) == (0, 1)


@pytest.mark.parametrize("seed", [3, 77])
def test_config1_expand_matches_reference_and_numpy(config1, seed):
    pair, pairs = config1
    r0 = _routes()
    out = _same(pair, f"SELECT {CHAIN2} AS f FROM person:{seed}")[0]["f"]
    assert _routes()["graph_chain"] - r0["graph_chain"] == 1
    v = _numpy_hops(pairs, seed, 2)[-1]
    got = {}
    for tb, i in out:
        assert tb == "person"
        got[i] = got.get(i, 0) + 1
    assert got == {int(i): int(v[i]) for i in np.nonzero(v)[0]}
    it = pair[1].graph_mirrors.interner("test", "test")
    ids = [it.lookup(PThing(tb, i)) for tb, i in out]
    assert ids == sorted(ids)


def test_graph_from_reference_gives_identical_chains(config1):
    """The port's mirrors built from the reference's intern the same ids and
    give the same device chains, batched CSC counts and dense counts."""
    (ref, _port), pairs = config1
    gm_r = ref.graph_mirrors
    gm_p = P.graph_from_reference(gm_r, "test", "test", "cpu")
    it_r, it_p = gm_r.interner("test", "test"), gm_p.interner("test", "test")
    assert [(t.tb, t.id) for t in it_p.node_of] == [(t.tb, t.id) for t in it_r.node_of]
    assert P.keys.DIR_OUT == R.keys.DIR_OUT
    specs = []
    for i in range(4):
        tb, ft = ("person", "knows") if i % 2 == 0 else ("knows", "person")
        specs.append(([tb], [R.keys.DIR_OUT], [ft]))

    class Inline:
        """A dispatcher that runs each request alone."""

        def submit(self, key, payload, runner):
            return runner([payload])()[0]

    for seed in (3, 150):
        g = it_r.lookup(RThing("person", seed))
        fr, cw = np.array([g], dtype=np.int32), np.array([1], dtype=np.int32)
        for n in (1, 3, 4):
            a = gm_r._device_chain("test", "test", fr, cw, specs[:n])
            b = gm_p._device_chain("test", "test", fr, cw, specs[:n])
            np.testing.assert_array_equal(b[0], a[0])
            np.testing.assert_array_equal(b[1], a[1])
            assert gm_p._device_chain("test", "test", fr, cw, specs[:n], count_only=True) == \
                gm_r._device_chain("test", "test", fr, cw, specs[:n], count_only=True)
            assert gm_p._device_chain("test", "test", fr, cw, specs[:n], True, Inline()) == \
                gm_r._device_chain("test", "test", fr, cw, specs[:n], True, Inline())
        want = int(_numpy_hops(pairs, seed, 2)[-1].sum())
        assert gm_p._dense_chain_count("test", "test", fr, cw, specs, Inline()) == \
            gm_r._dense_chain_count("test", "test", fr, cw, specs, Inline()) == want


def test_warm_count_kernels_runs_the_plain_versions(config1):
    """The ingest-time warm-up launches every count shape the serving
    runners use (here the plain versions): the dense form for
    person->knows->person, the CSC form for knows->person->knows, and no
    prewarm error."""
    (_ref, port), _pairs = config1
    errors = lambda: sum(v for k, v in ptel.snapshot()["counters"].items()  # noqa: E731
                         if k.startswith("prewarm_errors"))
    e0, r0 = errors(), _routes()
    port.graph_mirrors.warm_count_kernels("test", "test")
    r1 = _routes()
    assert errors() == e0
    # lanes {32, 64} x chains of 1-3 pairs, in each form
    assert r1["graph_dense"] - r0["graph_dense"] == 6
    assert r1["graph_csc"] - r0["graph_csc"] == 6
