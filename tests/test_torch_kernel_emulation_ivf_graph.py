"""The IVF and graph kernels' logic (K3-K7: surrealdb_tpu_torch/csrc/ivf.cu
and graph.cu, with K2's select and the merge of mesh.cu that K3 composes
with) run on the CPU under the emulation header csrc/emu/cuda_emu.h and held
against the plain PyTorch versions, as tests/test_torch_kernel_emulation.py
does for the other kernels (its `_build_emu` is reused here).

Tolerances: the IVF rerank's distances rtol 1e-5, atol 1e-4 (f32 sums in
another order), misses (+inf / -1) exact, ids equal up to ties at the k-th
distance; its two modes (pair-major, list-major) bit-equal to each other,
picks and order; on rows that all tie, ids and order exact; the K5
assignment's ids exact except where two centroids' distances tie within
that tolerance; the K4 update's counts exact, its centroids within rtol
1e-5, atol 1e-4 of the plain version (f32 sums in another order) and bit-equal
to a numpy f32 rendering of the order ivf.cu states (a centroid's rows in row
order, summed in runs of UP_ITEM, the runs' sums added in order), two
launches bit-equal; the graph kernels (K6, K7) exact: integer counts, node
ids and their order.
"""

import re

import numpy as np
import pytest
import torch

from surrealdb_tpu_torch.idx import graph_csr as G
from surrealdb_tpu_torch.idx import ivf as IVF
from surrealdb_tpu_torch.ops import distances as D
from surrealdb_tpu_torch.parallel import mesh as M
from test_torch_kernel_emulation import (
    _assert_k13_matches,
    _build_emu,
    _frontier,
    _k13_cases,
    _k13_plain,
    _k13_tables,
    _pairwise,
    _select,
    _source,
)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("kernels_emu_ivf_graph")
    return _build_emu(out, {n: _source(n) for n in ("knn.cu", "knn_f32.cu", "ivf.cu", "graph.cu",
                                                     "mesh.cu")})


# ------------------------------------------------------------------ IVF


def _assign(lib, x, cents, k, idx=None):
    return IVF._launch_assign(lib, x, cents, k, idx)


def _ties_broken(got, want, d):
    """(row, slot, d[got], d[want]) wherever the ids differ and the two
    picks' distances do not tie within the tolerance (f32 sums in another
    order); a non-finite distance never ties."""
    got2, want2 = got.reshape(len(d), -1).long(), want.reshape(len(d), -1).long()
    out = []
    for r, c in (got2 != want2).nonzero().tolist():
        a, b = float(d[r, got2[r, c]]), float(d[r, want2[r, c]])
        if not abs(a - b) <= 1e-4 + 1e-5 * abs(b):
            out.append((r, c, a, b))
    return out


def _assert_ids_up_to_ties(got, want, d):
    """Ids equal, except where the two picks' distances tie within the
    tolerance."""
    assert not _ties_broken(got, want, d)


@pytest.mark.parametrize("gather", [False, True], ids=["rows", "index"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("corpus", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k5_assign_matches_plain(lib, corpus, k, gather):
    rng = np.random.default_rng(40 + k)
    cents = torch.from_numpy(rng.standard_normal((70, 40)).astype(np.float32))
    cents[40] = cents[5]  # exact ties: the lower index wins
    cents[60] = cents[3]
    x = torch.from_numpy(rng.standard_normal((150, 40)).astype(np.float32))
    x[:20] = cents[[5, 3] * 10] + 0.01 * x[:20]
    x = x.to(corpus)
    idx = None
    if gather:  # out-of-range indices are clipped, as the reference clips
        idx = torch.from_numpy(rng.integers(-5, 160, size=130).astype(np.int32))
    got = _assign(lib, x, cents, k, idx)
    want = IVF.assign_plain(x, cents, k, idx=idx)
    rows = x if idx is None else x[idx.long().clamp(0, x.shape[0] - 1)]
    d = D.pairwise_distance_plain(rows, cents, "euclidean")
    _assert_ids_up_to_ties(got, want, d)
    near = slice(0, 20) if idx is None else (idx.clamp(0, 149) < 20).nonzero()[:, 0]
    assert set(got.reshape(len(rows), -1)[near, 0].tolist()) <= {3, 5}


def _assign_case(rng, n, C, D, dtype):
    """Rows near centroids 3 and 5 (ties within the tolerance), two pairs of
    equal centroids (exact ties: the lower index wins), the rest random."""
    cents = torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32))
    cents[C - 10] = cents[5]
    cents[C - 3] = cents[3]
    x = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    x[:20] = cents[[5, 3] * 10] + 0.01 * x[:20]
    return x.to(dtype), cents


@pytest.mark.parametrize("gather", [False, True], ids=["rows", "index"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("C", [70, 300])
@pytest.mark.parametrize("dim", [20, 40, 768])
def test_k5_bf16_shapes_match_plain(lib, dim, C, k, gather):
    """The tensor-core path: D not a multiple of 8 (plain-load staging), of
    16 (a zero-padded limb plane) and the main path's 768; C within one
    centroid tile and over three, the last partial; rows past a block."""
    rng = np.random.default_rng(dim + C + k)
    x, cents = _assign_case(rng, 150, C, dim, torch.bfloat16)
    idx = None
    if gather:  # out-of-range indices are clipped, as the reference clips
        idx = torch.from_numpy(rng.integers(-5, 160, size=140).astype(np.int32))
    got = _assign(lib, x, cents, k, idx)
    want = IVF.assign_plain(x, cents, k, idx=idx)
    rows = x if idx is None else x[idx.long().clamp(0, x.shape[0] - 1)]
    _assert_ids_up_to_ties(got, want, D.pairwise_distance_plain(rows, cents, "euclidean"))
    near = slice(0, 20) if idx is None else (idx.clamp(0, 149) < 20).nonzero()[:, 0]
    assert set(got.reshape(len(rows), -1)[near, 0].tolist()) <= {3, 5}


@pytest.mark.parametrize("gather", [False, True], ids=["rows", "index"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("corpus", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k5_inf_and_nan_rows_match_plain(lib, corpus, k, gather):
    """A row holding +inf, one holding -inf and one holding NaN get the ids
    f32 gives (a NaN distance first, in index order), also where a zero
    limb meets the inf; the finite rows beside them are unchanged."""
    rng = np.random.default_rng(60 + k)
    x, cents = _assign_case(rng, 150, 70, 40, torch.float32)
    cents[:, 7] = torch.from_numpy(rng.integers(-2, 3, 70).astype(np.float32))  # limbs 1, 2 zero
    x[30, 7] = float("inf")
    x[31, 2] = float("-inf")
    x[32, 11] = float("nan")
    x = x.to(corpus)
    idx = torch.tensor([30, 31, 32, 0, 1, 40, 33], dtype=torch.int32) if gather else None
    got = _assign(lib, x, cents, k, idx)
    want = IVF.assign_plain(x, cents, k, idx=idx)
    bad = [0, 1, 2] if gather else [30, 31, 32]
    assert torch.equal(got[bad], want[bad])
    rows = x if idx is None else x[idx.long()]
    fine = [i for i in range(len(rows)) if i not in bad]
    _assert_ids_up_to_ties(got[fine], want[fine],
                           D.pairwise_distance_plain(rows[fine], cents, "euclidean"))


def _lower_limb_case(rng, groups, dim):
    """bf16 rows whose nearest f32 centroid is told from the next one only
    by limb 1 (even groups) or only by limb 2 (odd groups) of the kernel's
    truncating split: a group's centroids are `far` (index 2g) and `near`
    (2g + 1) = far + a value below far's last kept bit, and its row lies 1
    above both in every column, so near is nearer. A product without limb
    1 or limb 2 sees near as far, or farther, and ranks far first."""
    v = 4 + rng.integers(0, 64, (groups, dim)) / 16  # bf16 values: limbs 1, 2 zero
    r1 = (1 + rng.integers(0, 128, (groups, dim)) / 128) / 64  # below v's last bit, 2^-5
    r2 = rng.integers(128, 256, (groups, dim)) / 2 ** 21  # below r1's last bit, 2^-13
    odd = (np.arange(groups) % 2 == 1)[:, None]
    far = v + np.where(odd, r1, 0)
    near = far + np.where(odd, r2, r1)
    cents = np.stack([far, near], 1).reshape(2 * groups, dim).astype(np.float32)
    return torch.from_numpy((v + 1).astype(np.float32)), torch.from_numpy(cents)


@pytest.mark.parametrize("gather", [False, True], ids=["rows", "index"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dim", [40, 768])
def test_k5_lower_limbs_decide_match_plain(lib, dim, k, gather):
    """Centroids off the bf16 grid, where limb 1 or limb 2 alone decides
    the nearest: the ids are the plain version's up to ties, and near wins
    in every group (the case's gaps are far above the tolerance)."""
    rng = np.random.default_rng(dim + k)
    x, cents = _lower_limb_case(rng, 12, dim)
    x = x.to(torch.bfloat16)
    idx = torch.from_numpy(rng.permutation(12).astype(np.int32)) if gather else None
    got = _assign(lib, x, cents, k, idx)
    rows = x if idx is None else x[idx.long()]
    want = IVF.assign_plain(rows, cents, k)
    _assert_ids_up_to_ties(got, want, D.pairwise_distance_plain(rows, cents, "euclidean"))
    owner = torch.arange(12) if idx is None else idx.long()
    assert torch.equal(got.reshape(12, -1)[:, 0].long(), 2 * owner + 1)


_K5_FAULTS = {
    # the largest limb's pass left out of the product
    "dropped_limb0": ("for (int l = hi ? 1 : 0; l < 2; ++l) {",
                      "for (int l = hi ? 2 : 0; l < 2; ++l) {"),
    # a single bf16 pass: limbs 1 and 2 left out
    "dropped_limbs_1_2": ("for (int l = hi ? 1 : 0; l < 2; ++l) {",
                          "for (int l = hi ? 1 : 2; l < 2; ++l) {"),
    # two passes: limb 2 left out
    "dropped_limb2": ("for (int l = hi ? 1 : 0; l < 2; ++l) {",
                      "for (int l = hi ? 1 : 1; l < 2; ++l) {"),
    # limb plane 2 staged from plane 1's place
    "limb_plane2_misplaced": ("const int pl = hi ? 0 : 2 - l;", "const int pl = hi ? 0 : 1;"),
    # a non-finite tensor-core product kept, its row not recomputed as f32 gives it
    "no_fma_recompute": ("if (!finite_f(dot)) bad[r] = 1;", ""),
    # the column warps' best-2 not merged: the first warp's stands
    "unmerged_column_warps": ("for (int w = 1; w < 4; ++w) {", "for (int w = 1; w < 1; ++w) {"),
}


@pytest.mark.parametrize("fault", sorted(_K5_FAULTS))
def test_k5_planted_fault_fails_the_comparison(tmp_path, fault):
    """The comparisons above have teeth: a copy of ivf.cu with one fault
    planted fails the comparison with the plain version (ids up to ties),
    on random rows, a row holding inf and the lower-limb groups."""
    src = _source("ivf.cu")
    old, new = _K5_FAULTS[fault]
    assert src.count(old) == 1
    bad = _build_emu(tmp_path, {"ivf.cu": src.replace(old, new)})
    rng = np.random.default_rng(61)
    x, cents = _assign_case(rng, 150, 300, 40, torch.float32)
    cents[:, 7] = torch.from_numpy(rng.integers(-2, 3, 300).astype(np.float32))
    x[30, 7] = float("inf")
    lx, lc = _lower_limb_case(rng, 12, 40)
    x, cents = torch.cat([x, lx]).to(torch.bfloat16), torch.cat([cents, lc])
    want = IVF.assign_plain(x, cents, 2)
    assert _ties_broken(_assign(bad, x, cents, 2), want,
                        D.pairwise_distance_plain(x, cents, "euclidean"))


# K4's update cases: (rows, centroids, columns, what is special). Every
# case leaves centroid 7 empty; n = 5,001 ends in a short tile and a short
# run of UP_ITEM rows.
_K4_CASES = {
    "uniform": (5001, 20, 24, None),
    "skewed": (5001, 20, 24, "skewed"),  # 90% of the rows to centroid 3: 36 items
    "empty": (5001, 20, 24, "empty"),  # every odd centroid empty
    "odd_c_d20": (5001, 37, 20, "skewed"),  # bf16 rows not 16-byte multiples: one value a load
    "d19": (5001, 20, 19, "skewed"),  # f32 rows too; the combine one value a load
    "unaligned": (5001, 20, 24, "unaligned"),  # rows off a 16-byte boundary
    "outside": (5001, 20, 24, "outside"),  # entries -1 and C: in no cluster
    "long_tiles": (70001, 37, 20, None),  # tiles of two 2,048-entry chunks, the last short
}


def _k4_case(corpus, case, seed=9):
    n, nlists, dim, how = _K4_CASES[case]
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32)).to(corpus)
    if how == "unaligned":  # one element into a flat buffer
        flat = torch.empty(n * dim + 1, dtype=corpus)
        flat[1:] = xs.reshape(-1)
        xs = flat[1:].view(n, dim)
        assert xs.data_ptr() % 16 != 0
    c = torch.from_numpy(rng.standard_normal((nlists, dim)).astype(np.float32))
    a = rng.integers(0, nlists, size=n).astype(np.int32)
    if how == "skewed":
        a[rng.random(n) < 0.9] = 3
    if how == "empty":
        a &= ~1
    a[a == 7] = 8  # centroid 7 stays empty and keeps its value
    if how == "outside":
        a[rng.random(n) < 0.05] = -1
        a[rng.random(n) < 0.05] = nlists
    return xs, torch.from_numpy(a), c


def _k4_item_rows():
    """UP_ITEM of csrc/ivf.cu: the members a work item sums, at most."""
    return int(re.search(r"constexpr int UP_ITEM = (\d+);", _source("ivf.cu")).group(1))


def _k4_render(xs, assign, c):
    """The update in the order ivf.cu states, in numpy f32: a centroid's
    rows in row order cut into runs of UP_ITEM; each run summed from 0 in
    row order; one run: its sum / count; more: 0 + run 0 + run 1 + ...,
    then / count; an empty centroid keeps its value; an entry outside [0,
    C) belongs to no centroid."""
    x, a, new = xs.float().numpy(), assign.numpy(), c.numpy().copy()
    run = _k4_item_rows()
    for k in range(len(new)):
        rows = np.nonzero(a == k)[0]
        if rows.size:
            sums = [np.add.accumulate(x[rows[i:i + run]], axis=0, dtype=np.float32)[-1]
                    for i in range(0, rows.size, run)]
            tot = np.add.accumulate(np.stack(sums), axis=0, dtype=np.float32)[-1]
            new[k] = tot / np.float32(rows.size)
    return torch.from_numpy(new)


def _k4_failures(lib, xs, assign, c):
    """What the emulated update gets wrong on one case (empty: nothing):
    counts exact, the centroids within tolerance of the plain version,
    bit-equal to the stated order, empty centroids kept, a second launch
    bit-equal."""
    new, counts = IVF._launch_kmeans_update(lib, xs, assign, c)
    ok = (assign >= 0) & (assign < c.shape[0])
    want, want_counts = IVF.kmeans_update_plain(xs[ok], assign[ok], c)
    bad = []
    if not torch.equal(counts, want_counts):
        bad.append("counts")
    if not torch.allclose(new, want, rtol=1e-5, atol=1e-4):
        bad.append(f"tolerance ({float((new - want).abs().max())})")
    if not torch.equal(new, _k4_render(xs, assign, c)):
        bad.append("stated order")
    if not torch.equal(new[want_counts == 0], c[want_counts == 0]):
        bad.append("empty centroids")
    if not torch.equal(IVF._launch_kmeans_update(lib, xs, assign, c)[0], new):
        bad.append("second launch")
    return bad


@pytest.mark.parametrize("case", list(_K4_CASES))
@pytest.mark.parametrize("corpus", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k4_update_matches_plain(lib, corpus, case):
    """The update on each case of _K4_CASES: counts exact, within tolerance
    of the plain version, bit-equal to the order ivf.cu states, and the
    same bits on a second launch."""
    xs, assign, c = _k4_case(corpus, case)
    assert int((assign == 7).sum()) == 0
    assert _k4_failures(lib, xs, assign, c) == []


_K4_FAULTS = {
    # the combine leaves out a heavy centroid's first item
    "combine_drops_first_item": ("for (int k = 0; k < ni; k += UP_LOADS) {",
                                 "for (int k = 1; k < ni; k += UP_LOADS) {"),
    # the scatter's warps take their turns last to first: each centroid's
    # rows out of row order
    "scatter_turns_reversed": ("if (warp == w) {", "if (warp == UP_WARPS - 1 - w) {"),
    # a warp's equal entries placed from the highest lane down
    "scatter_lanes_reversed": ("const int rank = __popc(peers[u] & ((1u << lane) - 1u));",
                               "const int rank = __popc(peers[u] >> lane) - 1;"),
}


@pytest.mark.parametrize("fault", sorted(_K4_FAULTS))
def test_k4_planted_fault_fails_the_comparison(tmp_path, fault):
    """The K4 comparison has teeth: a copy of ivf.cu with one fault planted
    in the ticketed combine or in the scatter fails it on the skewed case
    (a centroid over 36 items; three tiles)."""
    src = _source("ivf.cu")
    old, new = _K4_FAULTS[fault]
    assert src.count(old) == 1
    bad = _build_emu(tmp_path, {"ivf.cu": src.replace(old, new)})
    xs, assign, c = _k4_case(torch.bfloat16, "skewed")
    assert _k4_failures(bad, xs, assign, c)


def _ivf_case(rng, corpus, metric):
    cap, dim, nlists, lmax = 300, 24, 10, 32
    x = rng.standard_normal((cap, dim)).astype(np.float32)
    if metric == "jaccard":
        x = np.abs(x)
    lens = rng.integers(5, lmax + 1, size=nlists)
    lens[0] = lmax
    list_rows = np.zeros((nlists, lmax), dtype=np.int32)
    list_mask = np.zeros((nlists, lmax), dtype=bool)
    for i, n in enumerate(lens):
        list_rows[i, :n] = rng.choice(cap, size=n, replace=False)
        list_mask[i, :n] = True
    slot_ok = rng.random(cap) > 0.3
    return (torch.from_numpy(x).to(corpus), torch.from_numpy(list_rows),
            torch.from_numpy(list_mask), torch.from_numpy(slot_ok))


def _span(lmax, groups):
    """The positions a range of a list covers (ivf.cu ir_span)."""
    return ((lmax + groups - 1) // groups + 31) // 32 * 32


def _rerank_emu(lib, q, probes, x, list_rows, list_mask, slot_ok, metric, k, mode, groups=None):
    """ivf_rerank over the S shards of [S, C, L] tables in `mode` (None: the
    plan's; `groups` forces a pair-major range split), then the merge of
    the picks, emulated: (dists, global slots)."""
    n_sh, _, lmax = list_rows.shape
    nq, nprobe = probes.shape
    kk = min(k, nprobe * lmax)
    plan = IVF.rerank_plan(lib, nq, n_sh, nprobe, lmax, kk, x.shape[1],
                           int(x.dtype == torch.bfloat16), mode)
    if groups is not None:
        plan = ("pair", groups, min(kk, _span(lmax, groups)))
    d, i = IVF._launch_rerank(lib, q, probes, x, list_rows, list_mask, slot_ok, metric, plan)
    return M._launch_topk_merge(lib, d, i, nprobe * plan[1] * plan[2], x.shape[0] // n_sh,
                                min(k, n_sh * kk), True)


def _both_modes(lib, q, probes, x, list_rows, list_mask, slot_ok, metric, k):
    """The rerank in both modes, required bit-equal (picks and order)."""
    pair = _rerank_emu(lib, q, probes, x, list_rows, list_mask, slot_ok, metric, k, "pair")
    lst = _rerank_emu(lib, q, probes, x, list_rows, list_mask, slot_ok, metric, k, "list")
    assert torch.equal(pair[0], lst[0]) and torch.equal(pair[1], lst[1])
    return pair


def _shared_probes(rng, nq, nprobe, lists):
    """Probes of nq queries drawn from the first `lists` lists, so most
    lists are probed by several queries (list-major groups of several)."""
    return torch.from_numpy(np.stack([rng.choice(lists, nprobe, replace=False)
                                      for _ in range(nq)]).astype(np.int32))


@pytest.mark.parametrize("corpus", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("metric", list(D.METRICS) + ["minkowski:3"])
def test_k3_rerank_matches_plain(lib, metric, corpus):
    """K3's rerank (one shard) in both modes against ivf_rerank_plain:
    six queries sharing four probed lists of up to 32 members, a third of
    the slots masked, lists of 5-32 members padded to 32; the modes agree
    bit for bit."""
    rng = np.random.default_rng(len(metric) + (corpus == torch.bfloat16))
    x, list_rows, list_mask, slot_ok = _ivf_case(rng, corpus, metric)
    q = torch.from_numpy(rng.standard_normal((6, x.shape[1])).astype(np.float32))
    if metric == "jaccard":
        q = q.abs()
    probes = _shared_probes(rng, 6, 3, 4)
    got = _both_modes(lib, q, probes, x, list_rows[None], list_mask[None], slot_ok, metric, 20)
    want = IVF.ivf_rerank_plain(q, probes, list_rows, list_mask, x, slot_ok, metric, 20)
    _assert_k13_matches(got, want)


@pytest.mark.parametrize("mode", IVF.RERANK_MODES)
def test_k3_masked_slots_with_ties_at_the_kth(lib, mode):
    """Equal rows in every list, so every distance ties: the picks come in
    (probe rank, position) order exactly as the plain version's, the
    masked slots skipped, and the k-th pick is one of many equal ones."""
    cap, n_lists, lmax = 200, 5, 64
    x = torch.ones(cap, 16, dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    list_rows = torch.from_numpy(np.stack([rng.choice(cap, lmax, replace=False)
                                           for _ in range(n_lists)]).astype(np.int32))
    list_mask = torch.zeros(n_lists, lmax, dtype=torch.bool)
    list_mask[:, :40] = True
    slot_ok = torch.from_numpy(np.arange(cap) % 3 != 0)
    q = torch.zeros(9, 16)
    probes = _shared_probes(rng, 9, 2, 3)
    got = _rerank_emu(lib, q, probes, x, list_rows[None], list_mask[None], slot_ok, "euclidean",
                      30, mode)
    want = IVF.ivf_rerank_plain(q, probes, list_rows, list_mask, x, slot_ok, "euclidean", 30)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _modes_cases():
    # label, queries, probes, lists probed, L, k, rows dtype, D, shards, unaligned
    return [
        ("q1", 1, 3, 6, 96, 10, torch.bfloat16, 24, 1, False),
        ("q12-shared-lists", 12, 3, 4, 96, 10, torch.bfloat16, 24, 1, False),
        ("q40-groups-split", 40, 2, 2, 64, 10, torch.float32, 16, 1, False),
        ("k300-ranges", 6, 2, 3, 600, 300, torch.float32, 16, 1, False),
        ("unaligned-rows", 8, 3, 4, 96, 10, torch.float32, 23, 1, True),
        ("f32-d768-k256-one-stage", 4, 1, 1, 512, 256, torch.float32, 768, 1, False),
        ("s3-shards", 8, 3, 4, 96, 10, torch.bfloat16, 24, 3, False),
    ]


@pytest.mark.parametrize("case", _modes_cases(), ids=lambda c: c[0])
def test_k3_modes_bit_equal(lib, case):
    """The list-major and pair-major modes give the same bits at the shapes
    that take list-major's other paths: one query; lists probed by many
    queries (groups of up to 32 and a list split over two groups); k above
    256 (ranges of 256 positions, every candidate kept); rows that are not
    16-byte aligned (staged by plain loads); 768-wide f32 rows with 256
    picks a pair (one stage fits beside the lists); three shards. Both
    equal the plain composition."""
    label, nq, nprobe, lists, lmax, k, dtype, dim, n_sh, unaligned = case
    rng = np.random.default_rng(len(label))
    cap = max(150, lmax)
    x, rows, lmask = _k13_tables(rng, n_sh, cap, 6, lmax, "holes", dim, dtype, "euclidean")
    if unaligned:
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
        flat[1:] = x.reshape(-1)
        x = flat[1:].view(x.shape)
    q = torch.from_numpy(rng.standard_normal((nq, dim)).astype(np.float32))
    probes = _shared_probes(rng, nq, nprobe, lists)
    if label.endswith("one-stage"):
        plan = IVF.rerank_plan(lib, nq, n_sh, nprobe, lmax, k, dim, 0, "list")
        assert plan[0] == "list"
    got = _both_modes(lib, q, probes, x, rows, lmask, None, "euclidean", k)
    _assert_k13_matches(got, _k13_plain(q, probes, x, rows, lmask, None, "euclidean", k))


@pytest.mark.parametrize("case", _k13_cases(), ids=lambda c: c[0])
def test_k13_list_major_matches_plain(lib, case):
    """K13's shared rerank in the list-major mode, on the cases the
    pair-major one is held to (tests/test_torch_kernel_emulation.py): 1, 3
    and 8 shards, packed lists and lists with holes, empty buckets, a third
    of the slots masked, k above the probed candidates; against K3's plain
    rerank a shard and the plain merge."""
    _label, n_sh, fill, metric, dtype, k, every, _groups = case
    rng = np.random.default_rng(n_sh * 10 + k + len(metric))
    cap, n_lists, lmax, dim, nq, nprobe = 120, 6, 96, 24, 3, 3
    x, rows, lmask = _k13_tables(rng, n_sh, cap, n_lists, lmax, fill, dim, dtype, metric)
    slot_ok = None if every is None else torch.from_numpy(np.arange(n_sh * cap) % every != 0)
    q = torch.from_numpy(rng.standard_normal((nq, dim)).astype(np.float32))
    probes = torch.from_numpy(np.stack([rng.choice(n_lists, nprobe, replace=False)
                                        for _ in range(nq)]).astype(np.int32))
    got = _rerank_emu(lib, q, probes, x, rows, lmask, slot_ok, metric, k, "list")
    _assert_k13_matches(got, _k13_plain(q, probes, x, rows, lmask, slot_ok, metric, k))


@pytest.mark.parametrize("k", [3, 200])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "pearson"])
def test_k3_composed_search_matches_plain(lib, metric, k):
    """The CUDA composition of _ivf_search (the probe by K1 and K2's
    select, ivf_rerank in the plan's mode, the merge) under emulation
    against the plain version; k = 200 is above the 4 x 32 candidates."""
    rng = np.random.default_rng(5)
    x, list_rows, list_mask, slot_ok = _ivf_case(rng, torch.float32, metric)
    cents = torch.from_numpy(rng.standard_normal((10, x.shape[1])).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((4, x.shape[1])).astype(np.float32))
    probe_metric = metric if metric in IVF._PROBE_METRICS else "euclidean"
    nprobe = 4
    dc = _pairwise(lib, q, cents, probe_metric)
    _, probes, _ = _select(lib, dc, torch.ones(10, dtype=torch.bool), nprobe)
    vals, slots = _rerank_emu(lib, q, probes, x, list_rows[None], list_mask[None], slot_ok,
                              metric, k, None)
    want_d, want_i = IVF.ivf_search_plain(q, cents, list_rows, list_mask, x, slot_ok, metric,
                                          probe_metric, k, nprobe)
    miss = torch.isinf(want_d)
    assert torch.equal(torch.isinf(vals), miss) and torch.equal(slots[miss], want_i[miss])
    torch.testing.assert_close(vals[~miss], want_d[~miss], rtol=1e-5, atol=1e-4)
    for r in range(4):
        kth = float(want_d[r][~miss[r]].max())
        for c in (slots[r] != want_i[r]).nonzero()[:, 0].tolist():
            assert abs(float(vals[r, c]) - kth) <= 1e-4 + 1e-5 * abs(kth)


# ------------------------------------------------------------------ graph


def _csr(rng, n_nodes, cap, n_edges):
    """A pow2-padded CSR over node ids < n_nodes (cap >= n_nodes): random
    edges, some parallel, node 1 isolated, as PointerCsr.ensure_arrays lays
    it out; returns (indptr, indices, pow2 max degree)."""
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
    return torch.from_numpy(indptr), torch.from_numpy(indices), md


def _chain_cases():
    # (label, n_nodes, n_cap, mirror caps per hop, out_sizes, frontier width)
    return [
        ("one hop, one mirror", 150, 256, [[256]], [256], 64),
        ("two hops, two mirrors", 150, 256, [[256], [256, 256]], [256, 128], 64),
        ("truncated at out_size", 150, 256, [[256], [256]], [256, 8], 64),
        ("mirror cap below n_cap", 200, 256, [[128], [256]], [256, 256], 32),
        ("several compaction blocks", 5000, 8192, [[8192], [8192]], [8192, 8192], 1024),
    ]


@pytest.mark.parametrize("count_only", [False, True], ids=["expand", "count"])
@pytest.mark.parametrize("case", _chain_cases(), ids=lambda c: c[0])
def test_k6_chain_matches_plain_exactly(lib, case, count_only):
    label, n_nodes, n_cap, caps, outs, width = case
    rng = np.random.default_rng(len(label))
    hops, mds = [], []
    for hop_caps in caps:
        ms = [_csr(rng, min(n_nodes, cap), cap, 6 * n_nodes) for cap in hop_caps]
        hops.append(tuple((p, i) for p, i, _ in ms))
        mds.append(tuple(md for _, _, md in ms))
    fr, w = _frontier(rng, n_nodes, width, n_cap, width // 2)
    fr[-1], w[-1] = n_cap - 1, 5  # past every mirror's nodes
    args = (tuple(hops), fr, w, tuple(mds), n_cap, tuple(outs), count_only)
    got, want = G._launch_chain(lib, *args), G.chain_plain(*args)
    if count_only:
        assert got.dtype == want.dtype == torch.int32 and int(got) == int(want) > 0
        return
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    live = want[1] > 0
    nodes = want[0][live]
    assert nodes.numel() and bool((nodes[1:] > nodes[:-1]).all())  # ascending ids
    if label.startswith("truncated"):
        assert bool(live.all())  # more nodes were present than out_size keeps


def _wrap_csr(n_cap):
    """Node 0 reaches node 5 by 3 parallel edges, node 6 by 4, node 8 by 2,
    node 7 by 1; node 2 reaches the sentinel n_cap, ids past it, a negative
    id and node 3."""
    adj = {0: [5] * 3 + [6] * 4 + [8] * 2 + [7], 2: [n_cap, n_cap + 9, 1 << 30, -4, 3]}
    indptr = np.zeros(n_cap + 1, dtype=np.int64)
    for src, dst in adj.items():
        indptr[src + 1] = len(dst)
    indptr = np.cumsum(indptr).astype(np.int32)
    indices = np.zeros(16, dtype=np.int32)
    flat = [d for src in sorted(adj) for d in adj[src]]
    indices[:len(flat)] = flat
    return torch.from_numpy(indptr), torch.from_numpy(indices), 16


def _k6_new_cases(rng):
    """(label, args) of the bitmap design's cases: several bitmap tiles
    (n_cap 2^16: 2,049 words in three tiles of 1,024), int32 counts that
    wrap to <= 0 (absent) beside 2^30 (kept), and the sentinel."""
    n_cap = 1 << 16
    p1, i1, md1 = _csr(rng, 40_000, n_cap, 60_000)
    p2, i2, md2 = _csr(rng, 40_000, n_cap, 30_000)
    fr, w = _frontier(rng, 40_000, 512, n_cap, 400)
    tiles = ((((p1, i1),), ((p2, i2), (p1, i1))), fr, w, ((md1,), (md2, md1)), n_cap,
             (4096, 2048))
    wp, wi, wmd = _wrap_csr(n_cap)
    wfr = torch.tensor([0, 2, 2, n_cap, 9, 0, 40_000], dtype=torch.int32)
    ww = torch.tensor([1 << 30, 1, 2, 7, 0, 0, 3], dtype=torch.int32)
    wrap = ((((wp, wi),), ((wp, wi),)), wfr, ww, ((wmd,), (wmd,)), n_cap, (16, 16))
    wrap1 = ((((wp, wi),),), wfr, ww, ((wmd,),), n_cap, (16,))
    # node 3 reaches 5,000 nodes of the first tile (157 of its words):
    # written out whole, or truncated at 3,000 inside the tile
    dptr = np.zeros(n_cap + 1, dtype=np.int64)
    dptr[4:] = 5000
    didx = np.zeros(8192, dtype=np.int32)
    didx[:5000] = np.arange(5000) * 7 % 5003
    dense = (torch.from_numpy(dptr.astype(np.int32)), torch.from_numpy(didx))
    dfr = torch.tensor([3, 3, n_cap, 7], dtype=torch.int32)
    dw = torch.tensor([2, 1, 0, 4], dtype=torch.int32)
    full = (((dense,),), dfr, dw, ((8192,),), n_cap, (8192,))
    cut = (((dense,),), dfr, dw, ((8192,),), n_cap, (3000,))
    return [("bitmap tiles", tiles), ("wrapped counts and the sentinel", wrap),
            ("wrapped counts, one hop", wrap1), ("a dense tile", full),
            ("a dense tile, truncated", cut)]


def _scratch_zero(sc):
    return not (bool(sc.cnt.any()) or bool(sc.bits.any()) or bool(sc.state.any()))


def test_k6_bitmap_cases_back_to_back_keep_the_scratch_zero(lib):
    """Each case twice, expand and count, over one scratch: exact against
    the plain version every time, and the count array, the bitmap and the
    look-back state all zero after every call."""
    rng = np.random.default_rng(61)
    cases = _k6_new_cases(rng)
    sc = G.ChainScratch(lib, 1 << 16, torch.device("cpu"))
    for _ in range(2):
        for label, args in cases:
            for count_only in (False, True):
                got = G._launch_chain(lib, *args, count_only, scratch=sc)
                want = G.chain_plain(*args, count_only)
                if count_only:
                    assert int(got) == int(want), label
                else:
                    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), label
                assert _scratch_zero(sc) and not sc.dirty, label
    one = G._launch_chain(lib, *cases[2][1], False, scratch=sc)
    assert one[0][one[1] > 0].tolist() == [0, 3, 7]  # 3, 4 and 2 x 2^30 wrap out
    assert one[1][:3].tolist() == [3, 3, 1 << 30]


def test_k6_failed_call_dirties_the_scratch_and_the_next_call_clears_it(lib):
    """A hop whose second mirror has no max degree fails after the first
    mirror's gather ran: the call raises, the scratch holds that gather's
    counts and is marked dirty; the next call zeroes it first and is exact,
    and leaves it zero."""
    rng = np.random.default_rng(62)
    label, args = _k6_new_cases(rng)[0]
    hops, fr, w, mds, n_cap, outs = args
    sc = G.ChainScratch(lib, n_cap, torch.device("cpu"))
    bad_hops = (hops[0] + hops[0],) + hops[1:]
    bad_mds = ((mds[0][0], 0),) + mds[1:]
    with pytest.raises(RuntimeError, match="graph_chain"):
        G._launch_chain(lib, bad_hops, fr, w, bad_mds, n_cap, outs, False, scratch=sc)
    assert sc.dirty and bool(sc.cnt.any()) and bool(sc.bits.any())
    got = G._launch_chain(lib, *args, False, scratch=sc)
    want = G.chain_plain(*args, False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _scratch_zero(sc) and not sc.dirty


_K6_FAULTS = {
    # an unsigned count test: counts that wrap negative stay in the frontier
    "unsigned_count": ("if ((int)c4[i] > 0 && ((word >> (4 * q + i)) & 1u))",
                       "if (c4[i] != 0u && ((word >> (4 * q + i)) & 1u))"),
    # the counts read are not cleared: the next call adds to them
    "count_not_cleared": ("    if ((tw >> lane) & 1u) cnt[node] = 0u;\n", ""),
    # each tile ranks its nodes from 0: the tiles overwrite each other
    "no_look_back": ("const long long before = (long long)lb_offset(state, tile, count);",
                     "const long long before = 0 * (long long)lb_offset(state, tile, count);"),
}


@pytest.mark.parametrize("fault", sorted(_K6_FAULTS))
def test_k6_planted_fault_fails_the_comparison(tmp_path, fault):
    """The bitmap cases have teeth: a copy of graph.cu with one fault planted
    disagrees with the plain version on them, called back to back."""
    src = _source("graph.cu")
    old, new = _K6_FAULTS[fault]
    assert src.count(old) == 1
    bad = _build_emu(tmp_path, {"graph.cu": src.replace(old, new)})
    rng = np.random.default_rng(61)
    sc = G.ChainScratch(bad, 1 << 16, torch.device("cpu"))
    differs = []
    for _ in range(2):
        for label, args in _k6_new_cases(rng):
            got = G._launch_chain(bad, *args, False, scratch=sc)
            want = G.chain_plain(*args, False)
            differs.append(not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])))
    assert any(differs)


def _csc_hop(rng, n_nodes, cap, n_edges):
    p, i, _ = _csr(rng, n_nodes, cap, n_edges)
    return tuple(torch.from_numpy(a) for a in G.csc_arrays(p.numpy(), i.numpy())), p


@pytest.mark.parametrize("lanes", [1, 32, 40, 64])
@pytest.mark.parametrize("hops", [0, 1, 3])
def test_k7_csc_count_matches_plain_exactly(lib, hops, lanes):
    rng = np.random.default_rng(hops * 100 + lanes)
    n_nodes, n_cap = 180, 256
    csc, ptrs = [], []
    for _ in range(hops + 1):
        (cptr, csrc), ptr = _csc_hop(rng, n_nodes, n_cap, 900)
        csc.append(((cptr, csrc),))
        ptrs.append(ptr)
    if hops:  # a hop of two mirrors
        csc[0] = csc[0] + (_csc_hop(rng, n_nodes, n_cap, 500)[0],)
    frs, cws = zip(*[_frontier(rng, n_nodes, 16, n_cap, 3) for _ in range(lanes)])
    fr, w = torch.stack(frs), torch.stack(cws)
    w[-1] = 0  # an empty lane
    args = (tuple(csc[:hops]), ((ptrs[-1],),), fr, w, n_cap)
    got, want = G._launch_csc_count(lib, *args), G.chain_count_batch_plain(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(got[-1]) == 0 and (lanes == 1 or bool((got[:-1] > 0).any()))


def test_k7_narrow_hop_matches_plain(lib):
    """A first hop whose mirror cap (64) is below n_cap (256): its output
    is 65 wide and the next hop's gathers past it read the zero column. A
    last hop narrower than the frontier fails, as it does in the
    reference."""
    rng = np.random.default_rng(8)
    (c1, s1), _ = _csc_hop(rng, 60, 64, 300)
    (c2, s2), _ = _csc_hop(rng, 200, 256, 900)
    _, p3 = _csc_hop(rng, 200, 256, 900)
    frs, cws = zip(*[_frontier(rng, 60, 8, 256, 4) for _ in range(32)])
    fr, w = torch.stack(frs), torch.stack(cws)
    args = ((((c1, s1),), ((c2, s2),)), ((p3,),), fr, w, 256)
    got = G._launch_csc_count(lib, *args)
    assert torch.equal(got, G.chain_count_batch_plain(*args)) and bool((got > 0).any())
    with pytest.raises(ValueError, match="does not cover"):
        G._launch_csc_count(lib, (((c1, s1),),), ((p3,),), fr, w, 256)


def test_k7_reversed_segment_gives_the_negated_sum(lib):
    """A pointer pair out of order gives the negated (wrapped) sum of the
    edges between them, as the reference's cumsum difference does."""
    rng = np.random.default_rng(9)
    (cptr, csrc), ptr = _csc_hop(rng, 200, 256, 900)
    frs, cws = zip(*[_frontier(rng, 200, 64, 256, 60) for _ in range(32)])
    fr, w = torch.stack(frs), torch.stack(cws)
    v = int(torch.argmax(cptr[1:] - cptr[:-1]))  # the busiest destination
    swapped = cptr.clone()
    swapped[v], swapped[v + 1] = cptr[v + 1], cptr[v]
    args = ((((swapped, csrc),),), ((ptr,),), fr, w, 256)
    got = G._launch_csc_count(lib, *args)
    assert torch.equal(got, G.chain_count_batch_plain(*args))
    plain = G.chain_count_batch_plain((((cptr, csrc),),), ((ptr,),), fr, w, 256)
    assert not torch.equal(got, plain)  # the swap changes the answer


def _edge_table(rng, persons, edges):
    """Config 1 in small: persons 0 .. persons - 1, and the record of edge i
    (random person pairs) id persons + i, in one pow2 node space. Returns
    the person->record and record->person CSRs (indptr, indices) and n_cap;
    every record has one source in the first, so its CSC fuses."""
    pairs = rng.integers(0, persons, (edges, 2))
    n_cap = 1 << (persons + edges - 1).bit_length()
    width = 1 << max(edges - 1, 0).bit_length()

    def csr(src, dst):
        order = np.argsort(src, kind="stable")
        indptr = np.zeros(n_cap + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indices = np.zeros(width, dtype=np.int32)
        indices[:edges] = dst[order]
        return np.cumsum(indptr).astype(np.int32), indices

    rec = np.arange(persons, persons + edges)
    return csr(pairs[:, 0], rec), csr(rec, pairs[:, 1]), n_cap


def _csc(indptr, indices):
    return tuple(torch.from_numpy(a) for a in G.csc_arrays(indptr, indices))


def _lane_seeds(rng, lanes, persons, n_cap, width=8):
    frs, cws = zip(*[_frontier(rng, persons, width, n_cap, 3) for _ in range(lanes)])
    fr, w = torch.stack(frs), torch.stack(cws)
    w[-1] = 0  # an empty lane
    return fr, w


def _k7_exact(lib, csc, last, fr, w, n_cap):
    got = G._launch_csc_count(lib, csc, last, fr, w, n_cap)
    want = G.chain_count_batch_plain(csc, last, fr, w, n_cap)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    return got


@pytest.mark.parametrize("lanes", [1, 32, 40, 64])
def test_k7_fused_edge_pairs_match_plain(lib, lanes):
    """person->record->person chains of 2, 3 and 4 CSC hops: each
    (->record, record->person) pair fuses (every record has one source),
    a third hop runs alone; exact against the plain version."""
    rng = np.random.default_rng(70 + lanes)
    pk, kp, n_cap = _edge_table(rng, 60, 400)
    pk_csc, kp_csc = _csc(*pk), _csc(*kp)
    assert G.csc_facts(*pk_csc)[1] and not G.csc_facts(*kp_csc)[1]
    fr, w = _lane_seeds(rng, lanes, 60, n_cap)
    pk_ptr, kp_ptr = torch.from_numpy(pk[0]), torch.from_numpy(kp[0])
    for csc, last in (((pk_csc,), (kp_csc,)), (pk_ptr,)), \
                     (((pk_csc,), (kp_csc,), (pk_csc,)), (kp_ptr,)), \
                     (((pk_csc,), (kp_csc,), (pk_csc,), (kp_csc,)), (pk_ptr,)):
        got = _k7_exact(lib, csc, (last,), fr, w, n_cap)
        assert lanes == 1 or bool((got[:-1] > 0).any())


def test_k7_first_hop_with_two_sources_runs_unfused(lib):
    """A record given a second source: the first hop's CSC no longer fuses,
    and the pair runs as two hops; a chain that starts at the records (a
    many-source first hop) too. Exact against the plain version."""
    rng = np.random.default_rng(72)
    (pk_ptr, pk_idx), kp, n_cap = _edge_table(rng, 60, 400)
    # person 5 also points at person 9's first record
    rec = int(pk_idx[pk_ptr[9]])
    idx = np.insert(pk_idx[: pk_ptr[-1]], pk_ptr[6], rec)
    ptr = pk_ptr.copy()
    ptr[6:] += 1
    idx = np.concatenate([idx, np.zeros(len(pk_idx) - len(idx), np.int32)]) \
        if len(idx) < len(pk_idx) else idx
    pk2 = _csc(ptr, idx.astype(np.int32))
    kp_csc = _csc(*kp)
    assert not G.csc_facts(*pk2)[1]
    fr, w = _lane_seeds(rng, 32, 60, n_cap)
    fr[0, 0], w[0, 0] = 5, 1
    _k7_exact(lib, ((pk2,), (kp_csc,)), ((torch.from_numpy(ptr),),), fr, w, n_cap)
    rfr, rw = _lane_seeds(rng, 32, 400, n_cap)
    rfr[rfr < n_cap] += 60  # records as seeds
    _k7_exact(lib, ((kp_csc,), (pk2,)), ((torch.from_numpy(kp[0]),),), rfr, rw, n_cap)


def test_k7_lanes_wrapping_to_zero_match_plain(lib):
    """A seed row whose lane sums wrap to 0 (2^31 - 1 + 2^31 - 1 + 2): it
    stays marked live, and its zeros count as a row never written does, as
    in the reference."""
    rng = np.random.default_rng(73)
    pk, kp, n_cap = _edge_table(rng, 30, 200)
    pk_csc, kp_csc = _csc(*pk), _csc(*kp)
    fr, w = _lane_seeds(rng, 32, 30, n_cap)
    fr[0, :3], w[0, :3] = 4, torch.tensor([2**31 - 1, 2**31 - 1, 2], dtype=torch.int32)
    got = _k7_exact(lib, ((pk_csc,), (kp_csc,)), ((torch.from_numpy(pk[0]),),), fr, w, n_cap)
    assert int(got[0]) == 0


def _rules_pair():
    """A fused pair over a node space of n_cap = 64 whose first hop is 128
    wide (so the intermediate's column 64 is zeroed before the second hop):
    first-hop sources -1 (wraps to the input's sentinel 64), -5 (wraps to
    60), 64 (column n_cap) and 70 (clamped to the sentinel); second-hop
    sources -1 (wraps to the intermediate's sentinel 128), -3 (126), 64
    (column n_cap), 128 (the sentinel) and 200 (clamped to it), beside
    ordinary ones; a pointer past the edges (clamped). Also a many-source
    hop, 128 wide, to run before the pair."""
    rng = np.random.default_rng(74)
    n_cap, cap1 = 64, 128
    # first hop: intermediate u has one source, or none
    src1 = rng.integers(0, 40, cap1)
    src1[[3, 10, 20, 30, 126]] = [-1, -5, 64, 70, 2]
    has = rng.random(cap1) < 0.8
    has[[3, 10, 20, 30, 126]] = True
    cptr1 = np.concatenate([[0], np.cumsum(has)]).astype(np.int32)
    csrc1 = np.zeros(256, dtype=np.int32)
    csrc1[: has.sum()] = src1[has]
    # second hop: destination v < 64 of the node space, several sources each
    deg = rng.integers(0, 6, n_cap)
    cptr2 = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    csrc2 = rng.integers(0, cap1, 512).astype(np.int32)
    csrc2[[0, 4, 9, 15, 22, 30]] = [-1, -3, 64, 128, 200, 126]
    cptr2[-1] = 600  # past the 512 edges: clamped
    ptr = np.concatenate([[0], np.cumsum(rng.integers(0, 4, n_cap))]).astype(np.int32)
    # a many-source hop 128 wide to run before the pair: its row 64 (column
    # n_cap of the pair's input) is written, and must read as zero
    deg0 = rng.integers(0, 4, cap1)
    deg0[n_cap] = 3
    cptr0 = np.concatenate([[0], np.cumsum(deg0)]).astype(np.int32)
    csrc0 = rng.integers(0, n_cap, 512).astype(np.int32)
    t = torch.from_numpy
    return (t(cptr1), t(csrc1)), (t(cptr2), t(csrc2)), t(ptr), n_cap, (t(cptr0), t(csrc0))


def test_k7_fused_pair_index_rules_match_plain(lib):
    """The reference's index rules at both levels of a fused pair (see
    _rules_pair), on the seeds and after a 128-wide hop whose row n_cap is
    live; exact against the plain version."""
    hop1, hop2, ptr, n_cap, hop0 = _rules_pair()
    assert G.csc_facts(*hop1)[1] and not G.csc_facts(*hop0)[1]
    rng = np.random.default_rng(75)
    fr, w = _lane_seeds(rng, 32, 64, n_cap)
    fr[0, :4], w[0, :4] = torch.tensor([60, 2, 5, 63]), 1
    for csc in ((hop1,), (hop2,)), ((hop0,), (hop1,), (hop2,)):
        got = _k7_exact(lib, csc, ((ptr,),), fr, w, n_cap)
        assert bool((got > 0).any())


def test_k7_reversed_segment_after_a_fused_first_hop(lib):
    """The second hop of a fused pair with a pointer pair out of order (its
    pointers fall, so the destination kernel runs it): the negated sum,
    exact against the plain version, and not the unswapped answer."""
    rng = np.random.default_rng(76)
    pk, kp, n_cap = _edge_table(rng, 60, 400)
    pk_csc, (cptr, csrc) = _csc(*pk), _csc(*kp)
    v = int(torch.argmax(cptr[1:] - cptr[:-1]))
    swapped = cptr.clone()
    swapped[v], swapped[v + 1] = cptr[v + 1], cptr[v]
    assert G.csc_facts(swapped, csrc)[0] is None
    fr, w = _lane_seeds(rng, 32, 60, n_cap, width=16)
    last = ((torch.from_numpy(pk[0]),),)
    got = _k7_exact(lib, ((pk_csc,), ((swapped, csrc),)), last, fr, w, n_cap)
    assert not torch.equal(got, G.chain_count_batch_plain(((pk_csc,), ((cptr, csrc),)), last, fr,
                                                          w, n_cap))


def test_k7_two_mirror_hops_fuse(lib):
    """Two edge tables between the same persons: the first hop's two
    single-source mirrors resolve together, the second hop's two mirrors
    add into the same destinations; exact against the plain version."""
    rng = np.random.default_rng(77)
    persons, edges = 50, 300
    pairs = rng.integers(0, persons, (2 * edges, 2))
    n_cap = 1 << (persons + 2 * edges - 1).bit_length()
    width = 1 << (edges - 1).bit_length()

    def csr(src, dst):
        order = np.argsort(src, kind="stable")
        indptr = np.zeros(n_cap + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indices = np.zeros(width, dtype=np.int32)
        indices[: len(src)] = dst[order]
        return np.cumsum(indptr).astype(np.int32), indices

    mirrors = []
    for t in range(2):  # table t's records persons + t * edges + i
        rec = np.arange(persons + t * edges, persons + (t + 1) * edges)
        half = pairs[t * edges:(t + 1) * edges]
        mirrors.append((csr(half[:, 0], rec), csr(rec, half[:, 1])))
    first = tuple(_csc(*m[0]) for m in mirrors)
    second = tuple(_csc(*m[1]) for m in mirrors)
    assert all(G.csc_facts(*c)[1] for c in first)
    fr, w = _lane_seeds(rng, 32, persons, n_cap)
    last = tuple((torch.from_numpy(m[0][0]),) for m in mirrors)
    _k7_exact(lib, (first, second, first, second), last, fr, w, n_cap)


def test_k7_lanes_above_128_take_the_destination_kernel(lib):
    """130 lanes (above a warp's 128 kept in registers): every hop runs on
    the destination kernel, fused and not; exact against the plain
    version."""
    rng = np.random.default_rng(78)
    pk, kp, n_cap = _edge_table(rng, 40, 250)
    pk_csc, kp_csc = _csc(*pk), _csc(*kp)
    fr, w = _lane_seeds(rng, 130, 40, n_cap)
    _k7_exact(lib, ((pk_csc,), (kp_csc,), (pk_csc,)), ((torch.from_numpy(kp[0]),),), fr, w,
              n_cap)


_K7_FAULTS = {
    # a negative source index clamped to 0 without the wrap, at both levels
    "no_wrap": ("  if (raw < 0) raw += W;\n", ""),
    # a fused pair reads its input's sentinel (and column n_cap) as a row
    "fused_reads_the_sentinel": ("  return dead_col(s, f.W0, n_cap) || !live_bit(xbits, s) ? -1 : s;",
                                 "  return !live_bit(xbits, s) ? -1 : s;"),
    # a warp's edge range not moved to whole destinations: a destination
    # split between two warps is written twice
    "range_not_snapped": ("  if (e0 > 0) {\n    const int prev = cdst[e0 - 1];",
                          "  if (false) {\n    const int prev = cdst[e0 - 1];"),
    # a second flush of a destination (or a second mirror) overwrites it
    "flush_overwrites": ("    if (c < B) y[v * B + c] = had ? y[v * B + c] + acc[i] : acc[i];",
                         "    if (c < B) y[v * B + c] = acc[i];"),
}


@pytest.mark.parametrize("fault", sorted(_K7_FAULTS))
def test_k7_planted_fault_fails_the_comparison(tmp_path, fault):
    """The comparisons above have teeth: a copy of graph.cu with one fault
    planted disagrees with the plain version on the index-rule, fused and
    two-mirror chains."""
    src = _source("graph.cu")
    old, new = _K7_FAULTS[fault]
    assert src.count(old) == 1
    bad = _build_emu(tmp_path, {"graph.cu": src.replace(old, new)})
    differs = []
    hop1, hop2, ptr, n_cap, hop0 = _rules_pair()
    rng = np.random.default_rng(79)
    fr, w = _lane_seeds(rng, 32, 64, n_cap)
    fr[0, :4], w[0, :4] = torch.tensor([60, 2, 5, 63]), 1
    cases = [(((hop1,), (hop2,)), ((ptr,),), fr, w, n_cap),
             (((hop0,), (hop1,), (hop2,)), ((ptr,),), fr, w, n_cap)]
    pk, kp, n_cap2 = _edge_table(rng, 60, 4000)
    pk_csc, kp_csc = _csc(*pk), _csc(*kp)
    fr2, w2 = _lane_seeds(rng, 32, 60, n_cap2)
    cases.append((((pk_csc,), (kp_csc,), (pk_csc,), (kp_csc,)), ((torch.from_numpy(pk[0]),),),
                  fr2, w2, n_cap2))
    cases.append((((pk_csc, pk_csc), (kp_csc, kp_csc)), ((torch.from_numpy(pk[0]),),), fr2, w2,
                  n_cap2))
    for args in cases:
        differs.append(not torch.equal(G._launch_csc_count(bad, *args),
                                       G.chain_count_batch_plain(*args)))
    assert any(differs)
