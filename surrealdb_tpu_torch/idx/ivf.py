"""IVF (inverted-file) ANN index — serves `DEFINE INDEX … HNSW`.

Mirrors surrealdb_tpu/idx/ivf.py. The host half (defaults, IvfState's
list bookkeeping, training's sampling and balanced assignment, and the
numpy twin `search_host`) is the reference's, copied. The device programs
of the reference are hand-written CUDA kernels here (csrc/ivf.cu), each
with a wrapper and a plain PyTorch version in this module:

- K5 `_assign_chunk` / `_assign_gather` (nearest 1 or 2 centroids of each
  row, the rows optionally picked by an index vector inside the kernel)
  launch `ivf_assign`;
- K4 `_kmeans_step` launches `ivf_assign` (k = 1) and `ivf_kmeans_update`
  (three launches: the rows grouped by centroid, then each cluster's mean
  summed in runs of 128 rows in the order csrc/ivf.cu states; an empty
  cluster keeps its centroid);
- K3 `_ivf_search` probes with K2 over the centroids
  (ops/distances.py `knn_search`), reranks the probed lists' members with
  `ivf_rerank` (one launch: pair-major, a block a (query, probe), or
  list-major, each probed list's rows staged once for every query that
  probes it, the plan's choice) and merges the blocks' picks with
  parallel/mesh.py's `topk_merge` as one shard: 4 kernels a tile.

A CUDA tensor goes to the kernels (or the wrapper raises); CPU tensors go
to the plain versions, which the tests hold against the reference and
chip_smoke.py holds the kernels against. The mesh half
(`_device_sharded`, `search_batch_sharded`) runs K13 through
parallel/mesh.py `sharded_ivf_search`: on the card K2's probe once a device
and one `ivf_rerank` launch over a device's shards (this module's
`_launch_rerank`); on the CPU this module's plain probe and rerank
(`ivf_probe_plain`, `ivf_rerank_plain`) once a device and once a shard.

Role of the reference's graph ANN structures (reference:
core/src/idx/trees/hnsw/mod.rs:337-416 layered beam search) re-designed
for a device: a k-means coarse quantizer partitions the corpus into C
lists; a query probes the nprobe nearest lists and exactly reranks only
their members. Sublinear work (nprobe/C of the corpus), tunable recall via
the operator's ef (reference `<|k,ef|>` Ann operator, sql/operator.rs:65).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from surrealdb_tpu_torch.ops import distances as D
from surrealdb_tpu_torch.ops.distances import LaunchCounter
from surrealdb_tpu_torch.utils.num import next_pow2 as _next_pow2

# metrics whose geometry the coarse quantizer can probe directly; the rest
# probe in euclidean space and rely on exact rerank for the final order
_PROBE_METRICS = {"euclidean", "cosine", "manhattan", "chebyshev"}

ASSIGN = LaunchCounter("ivf_assign")
KMEANS_UPDATE = LaunchCounter("ivf_kmeans_update")
RERANK = LaunchCounter("ivf_rerank")
KERNELS = (ASSIGN, KMEANS_UPDATE, RERANK)
RERANK_MODES = ("pair", "list")  # ivf_rerank's modes, by their C code


def _start_host_copy(d, r):
    """Start the device->host copy of one tile's results without blocking:
    a non_blocking copy into pinned host memory plus an event that the
    collector waits on. Returns (d, r, event); on the CPU the results
    already are host tensors and the event is None."""
    if d.device.type != "cuda":
        return d, r, None
    hd = torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
    hr = torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
    hd.copy_(d, non_blocking=True)
    hr.copy_(r, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return hd, hr, ev


def _ivf_shape_key(tile, cents, list_rows, matrix, metric, probe_metric, k, nprobe):
    """Launch-shape key of the probe+rerank kernels: every static dim of
    one launch (compile_log attribution)."""
    return (
        tile, int(matrix.shape[1]), int(matrix.shape[0]), str(matrix.dtype),
        int(cents.shape[0]), int(list_rows.shape[1]), metric, probe_metric,
        k, nprobe,
    )


def default_nlists(n: int) -> int:
    """C ≈ sqrt(N), pow2-clamped to [8, 4096]."""
    return min(max(_next_pow2(int(math.sqrt(max(n, 1)))), 8), 4096)


def default_nprobe(nlists: int, ef: Optional[int]) -> int:
    """Map the HNSW-style ef beam width onto probed-list count. With
    balanced lists each probe examines ~2·N/C candidates, so ef/10 probes
    lands near the reference's beam-width semantics (search ef=80 → 8
    probes ≈ 99% recall on clustered data, see tests/test_ivf.py)."""
    if ef is not None and ef > 0:
        return min(max(4, round(ef / 10)), nlists)
    return min(max(4, nlists // 16), nlists)


# ------------------------------------------------------------ plain versions
def assign_plain(x: torch.Tensor, cents: torch.Tensor, k_assign: int = 1, idx=None) -> torch.Tensor:
    """Plain K5: the nearest (k_assign = 1) or two nearest centroids of each
    row of x [n, D] (or of x[clip(idx, 0, cap-1)]) by euclidean distance,
    lower index first on a tie, a NaN distance first of all -> int32 [n]
    or [n, 2]."""
    if idx is not None:
        x = x[idx.long().clamp(0, x.shape[0] - 1)]
    d = D.pairwise_distance_plain(x, cents, "euclidean")
    # a NaN distance (a row holding inf or NaN) ranks first, lower index
    # first, as the reference's argmin and top_k rank it
    d = torch.where(torch.isnan(d), float("-inf"), d)
    if k_assign == 1:
        return torch.argmin(d, dim=1).to(torch.int32)
    return D._topk_min_stable(d, k_assign)[1]


def kmeans_update_plain(
    xs: torch.Tensor, assign: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4 update: (new centroids [C, D] f32, counts [C] int32). The
    mean of each centroid's rows; an empty cluster keeps its centroid."""
    nlists = c.shape[0]
    a = assign.long()
    sums = torch.zeros((nlists, xs.shape[1]), dtype=torch.float32, device=xs.device)
    sums.index_add_(0, a, xs.float())
    cnts = torch.bincount(a, minlength=nlists)[:nlists].float()
    new = torch.where(cnts[:, None] > 0, sums / torch.clamp(cnts[:, None], min=1.0), c.float())
    return new, cnts.to(torch.int32)


def ivf_search_plain(q, cents, list_rows, list_mask, x, slot_ok, metric, probe_metric, k, nprobe):
    """Plain K3, the reference's _ivf_search: probe the nprobe nearest
    centroids, rerank the probed lists' members that are listed and
    slot_ok with `metric`, top-k in (distance, position) order, positions
    mapped to slots (-1 where the distance is +inf)."""
    probes = ivf_probe_plain(q, cents, probe_metric, nprobe)
    return ivf_rerank_plain(q, probes, list_rows, list_mask, x, slot_ok, metric, k)


def ivf_probe_plain(q, cents, probe_metric, nprobe):
    """The probe of plain K3: the nprobe nearest centroids [Q, nprobe] int32."""
    dc = D.pairwise_distance_plain(q, cents, probe_metric)
    return D._topk_min_stable(dc, nprobe)[1]


def ivf_rerank_plain(q, probes, list_rows, list_mask, x, slot_ok, metric, k):
    """The rerank of plain K3 over given probes [Q, nprobe]."""
    probes = probes.long()
    nq = q.shape[0]
    rows = list_rows[probes].reshape(nq, -1)  # [Q, nprobe*L]
    rows_c = rows.long().clamp(0, x.shape[0] - 1)
    mask = list_mask[probes].reshape(nq, -1) & slot_ok[rows_c]
    d = torch.stack([
        D.pairwise_distance_plain(q[i : i + 1], x[rows_c[i]], metric)[0] for i in range(nq)
    ])
    d = torch.where(mask, d, torch.full_like(d, float("inf")))
    kk = min(k, int(rows.shape[1]))
    vals, pos = D._topk_min_stable(d, kk)
    slots = torch.where(vals < float("inf"), rows.gather(1, pos.long()), torch.full_like(pos, -1))
    return vals, slots.to(torch.int32)


# ------------------------------------------------------------ CUDA kernels
def _rows_ptr(x: torch.Tensor):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rows must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"rows must be a contiguous [n, D] tensor, got {tuple(x.shape)}")
    return x.data_ptr(), int(x.dtype == torch.bfloat16)


def _on_card(*ts) -> bool:
    """True for CUDA tensors on one device, False for CPU tensors; raises
    on a mix."""
    devs = {t.device for t in ts}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    return True


def _launch_assign(lib, x, cents, k_assign, idx=None):
    """ivf_assign's argument checks and launch (K5) through `lib`, the
    kernel library (the tests pass the CPU-emulated one). A bf16 x gets the
    centroids' limb planes and squared norms as scratch."""
    from surrealdb_tpu_torch.ops import _cuda

    if cents.dtype != torch.float32 or not cents.is_contiguous() or cents.shape[1] != x.shape[1]:
        raise ValueError("centroids must be a contiguous float32 [C, D] tensor of the rows' width")
    if k_assign not in (1, 2) or k_assign > cents.shape[0]:
        raise ValueError(f"k_assign={k_assign} must be 1 or 2 and at most C={cents.shape[0]}")
    xp, bf16 = _rows_ptr(x)
    if idx is not None:
        if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
            raise ValueError("idx must be a contiguous int32 [n] tensor")
        n = idx.shape[0]
    else:
        n = x.shape[0]
    C, dim = cents.shape
    limbs = cnorm = None
    if bf16:
        limbs = torch.empty(3 * C * lib.ivf_assign_limb_pitch(dim), dtype=torch.bfloat16,
                            device=x.device)
        cnorm = torch.empty(C, dtype=torch.float32, device=x.device)
    shape = (n,) if k_assign == 1 else (n, k_assign)
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    status = lib.ivf_assign(
        xp, bf16, None if idx is None else idx.data_ptr(), n, x.shape[0], cents.data_ptr(), C,
        dim, k_assign, None if limbs is None else limbs.data_ptr(),
        None if cnorm is None else cnorm.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream if x.device.type == "cuda" else None,
    )
    _cuda.check(status, "ivf_assign")
    return out


def _assign_cuda(x, cents, k_assign, idx=None):
    from surrealdb_tpu_torch.ops import _cuda

    with torch.cuda.device(x.device):
        out = _launch_assign(_cuda.lib(), x, cents, k_assign, idx)
    ASSIGN.bump()
    return out


def _assign_chunk(chunk: torch.Tensor, cents: torch.Tensor, k_assign: int = 1) -> torch.Tensor:
    """Nearest-centroid assignment for one corpus tile (euclidean, K5):
    chunk [n, D] f32/bf16, cents [C, D] f32 -> int32 [n] or [n, k_assign]."""
    if not _on_card(chunk, cents):
        return assign_plain(chunk, cents, k_assign)
    return _assign_cuda(chunk, cents, k_assign)


def _assign_gather(matrix: torch.Tensor, idx: torch.Tensor, cents: torch.Tensor, k_assign: int = 1):
    """Assign rows matrix[clip(idx, 0, cap-1)] of the device-resident
    mirror matrix to their nearest centroids (K5): only the index vector
    crosses to the device, and the kernel reads the rows in place."""
    if not _on_card(matrix, idx, cents):
        return assign_plain(matrix, cents, k_assign, idx=idx)
    return _assign_cuda(matrix, cents, k_assign, idx=idx)


def _launch_kmeans_update(lib, xs, assign, c):
    """ivf_kmeans_update's argument checks and launch (K4's update) through
    `lib`, the kernel library (the tests pass the CPU-emulated one), with
    its scratch from torch's allocator."""
    from surrealdb_tpu_torch.ops import _cuda

    xp, bf16 = _rows_ptr(xs)
    c = c.float().contiguous()
    if c.dim() != 2 or c.shape[1] != xs.shape[1]:
        raise ValueError("centroids must be a [C, D] tensor of the rows' width")
    if assign.dtype != torch.int32 or assign.shape != (xs.shape[0],) or not assign.is_contiguous():
        raise ValueError("assign must be a contiguous int32 [n] tensor")
    n, dim = xs.shape
    nlists = c.shape[0]
    nbytes = lib.ivf_kmeans_update_scratch_bytes(n, dim, nlists)
    if nbytes < 0:
        raise ValueError(f"ivf_kmeans_update takes no rows of shape {tuple(xs.shape)}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=xs.device)
    new = torch.empty_like(c)
    counts = torch.empty(nlists, dtype=torch.int32, device=c.device)
    status = lib.ivf_kmeans_update(
        xp, bf16, n, dim, assign.data_ptr(), c.data_ptr(), nlists, scratch.data_ptr(),
        new.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream().cuda_stream if xs.device.type == "cuda" else None,
    )
    _cuda.check(status, "ivf_kmeans_update")
    return new, counts


def kmeans_update(xs: torch.Tensor, assign: torch.Tensor, c: torch.Tensor):
    """K4's update: (new centroids [C, D] f32, counts [C] int32) from the
    rows xs [n, D], their assignment [n] int32 and the centroids c [C, D]."""
    if not _on_card(xs, assign, c):
        return kmeans_update_plain(xs, assign, c)
    from surrealdb_tpu_torch.ops import _cuda

    with torch.cuda.device(xs.device):
        out = _launch_kmeans_update(_cuda.lib(), xs, assign, c)
    KMEANS_UPDATE.bump()
    return out


def _kmeans_step(xs: torch.Tensor, c: torch.Tensor, nlists: int) -> torch.Tensor:
    """One Lloyd step (K4): assign every row to its nearest centroid, then
    move each centroid to its rows' mean -> [C, D] f32."""
    c = c.float().contiguous()
    a = _assign_chunk(xs, c, 1)
    return kmeans_update(xs, a, c)[0]


def _ivf_search(q, cents, list_rows, list_mask, x, slot_ok, metric, probe_metric, k, nprobe,
                probe_ok=None):
    """q [Q, D] → (dists [Q, k] f32, row slots [Q, k] int32), K3.
    `slot_ok` [cap] masks corpus slots (all-true without a prefilter): the
    columnar residual-WHERE mask ANDs in here, so top-k is computed among
    MATCHING rows only. `probe_ok` is an all-true [C] mask for the probe
    (made when not given)."""
    if not _on_card(q, cents, list_rows, list_mask, x, slot_ok):
        return ivf_search_plain(q, cents, list_rows, list_mask, x, slot_ok, metric,
                                probe_metric, k, nprobe)
    probes = _ivf_probe(q, cents, probe_metric, nprobe, probe_ok)
    return _ivf_rerank(q, probes, list_rows, list_mask, x, slot_ok, metric, k)


def _ivf_probe(q, cents, probe_metric, nprobe, probe_ok=None):
    """K3's probe: the nprobe nearest centroids of each query, [Q, nprobe]
    int32 (the fused K2 over the centroids on the card)."""
    if not _on_card(q, cents):
        return ivf_probe_plain(q, cents, probe_metric, nprobe)
    if probe_ok is None:
        probe_ok = torch.ones(cents.shape[0], dtype=torch.bool, device=q.device)
    return D.knn_search(q, cents, probe_ok, probe_metric, nprobe)[1]


def rerank_plan(lib, n_queries: int, n_shards: int, nprobe: int, lmax: int, kk: int, dim: int,
                bf16: int, mode=None):
    """(mode, groups, kkb) of an ivf_rerank launch, sized on the current
    card: its mode ("pair" or "list"; None lets the plan choose), the
    ranges a probed list splits into and the picks a range keeps."""
    out = (ctypes.c_int * 3)()
    code = -1 if mode is None else RERANK_MODES.index(mode)
    status = lib.ivf_rerank_plan(n_queries, n_shards, nprobe, lmax, kk, dim, bf16, code, out)
    if status != 0:
        raise ValueError(f"ivf_rerank has no {mode!r} plan for {n_queries} queries x {n_shards} "
                         f"shards x {nprobe} probes of {lmax} positions, k={kk}, D={dim}")
    return RERANK_MODES[out[0]], int(out[1]), int(out[2])


def _launch_rerank(lib, q, probes, x, list_rows, list_mask, slot_ok, metric, plan):
    """ivf_rerank's checks and launch through `lib` over the S shards of one
    device held as one tensor each: x [S * cap, D] rows, list_rows /
    list_mask [S, C, L] (slots local to the shard), slot_ok [S * cap] bool
    or None (every slot); `plan` from rerank_plan. Returns the blocks'
    picks (dists [Q, S * P * groups * kkb] f32, local slots int32), in
    (shard, probe rank, position) order."""
    from surrealdb_tpu_torch.ops import _cuda

    xp, bf16 = _rows_ptr(x)
    if q.dtype != torch.float32 or q.dim() != 2 or not q.is_contiguous() \
            or q.shape[1] != x.shape[1]:
        raise ValueError("queries must be a contiguous float32 [Q, D] tensor of the rows' width")
    if probes.dtype != torch.int32 or probes.dim() != 2 or not probes.is_contiguous() \
            or probes.shape[0] != q.shape[0]:
        raise ValueError("probes must be a contiguous int32 [Q, nprobe] tensor")
    if list_rows.dtype != torch.int32 or list_mask.dtype != torch.bool or list_rows.dim() != 3 \
            or list_mask.shape != list_rows.shape or not (list_rows.is_contiguous()
                                                          and list_mask.is_contiguous()):
        raise ValueError("list_rows and list_mask must be contiguous int32 / bool [S, C, L]")
    n_sh, n_lists, lmax = list_rows.shape
    if x.shape[0] % n_sh:
        raise ValueError(f"{x.shape[0]} rows do not split into {n_sh} shards")
    if slot_ok is not None and (slot_ok.dtype != torch.bool or slot_ok.shape != (x.shape[0],)
                                or not slot_ok.is_contiguous()):
        raise ValueError(f"slot_ok must be a contiguous bool [{x.shape[0]}] tensor")
    mode, groups, kkb = plan
    code, p = D._metric_code(metric)
    nq, nprobe = probes.shape
    width = n_sh * nprobe * groups * kkb
    out_d = torch.empty((nq, width), dtype=torch.float32, device=x.device)
    out_i = torch.empty((nq, width), dtype=torch.int32, device=x.device)
    # the list-major blocks' work ticket (the launch resets it)
    work = torch.empty(1, dtype=torch.int32, device=x.device) if mode == "list" else None
    status = lib.ivf_rerank(
        q.data_ptr(), nq, q.shape[1], code, p, probes.data_ptr(), nprobe, xp, bf16,
        x.shape[0] // n_sh, list_rows.data_ptr(), list_mask.view(torch.uint8).data_ptr(), n_lists,
        lmax, None if slot_ok is None else slot_ok.view(torch.uint8).data_ptr(), n_sh,
        RERANK_MODES.index(mode), groups, kkb, None if work is None else work.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream if x.device.type == "cuda" else None,
    )
    _cuda.check(status, "ivf_rerank")
    return out_d, out_i


def _ivf_rerank(q, probes, list_rows, list_mask, x, slot_ok, metric, k, mode=None):
    """K3's rerank over given probes: the probed lists' members (list_rows
    [C, L] row slots of x, list_mask [C, L]) that are listed and slot_ok,
    by `metric`, top-min(k, nprobe*L) in (distance, position) order, slots
    -1 where the distance is +inf. On the card one `ivf_rerank` launch in
    the plan's mode (or `mode`, "pair" or "list") and the merge of its
    picks as one shard (parallel/mesh.py `topk_merge`)."""
    if not _on_card(q, probes, list_rows, list_mask, x, slot_ok):
        return ivf_rerank_plain(q, probes, list_rows, list_mask, x, slot_ok, metric, k)
    from surrealdb_tpu_torch.ops import _cuda
    from surrealdb_tpu_torch.parallel.mesh import topk_merge

    if list_rows.dtype != torch.int32 or list_mask.dtype != torch.bool or slot_ok.dtype != torch.bool:
        raise TypeError("list_rows must be int32, list_mask and slot_ok bool")
    if list_mask.shape != list_rows.shape or slot_ok.shape != (x.shape[0],):
        raise ValueError("list_mask must match list_rows, slot_ok must be [cap]")
    nq, nprobe = probes.shape
    lmax = int(list_rows.shape[1])
    kk = min(k, nprobe * lmax)
    lib = _cuda.lib()
    with torch.cuda.device(q.device):
        plan = rerank_plan(lib, nq, 1, nprobe, lmax, kk, int(x.shape[1]),
                           int(x.dtype == torch.bfloat16), mode)
        d, i = _launch_rerank(lib, q, probes, x, list_rows[None], list_mask[None], slot_ok,
                              metric, plan)
    RERANK.bump()
    return topk_merge(d, i, int(d.shape[1]), 0, kk, True)


# ------------------------------------------------------------ training
def _kmeans_xs(xs: torch.Tensor, nlists: int, iters: int = 8, seed: int = 7) -> torch.Tensor:
    """k-means over an already-device-resident sample [n, D]."""
    rng = np.random.default_rng(seed)
    pick = torch.from_numpy(rng.choice(xs.shape[0], size=nlists, replace=False)).to(xs.device)
    cents = xs[pick].float()
    for _ in range(iters):
        cents = _kmeans_step(xs, cents, nlists)
    return cents


def _kmeans(x: np.ndarray, nlists: int, iters: int = 8, seed: int = 7,
            device="cuda") -> np.ndarray:
    """k-means on a host training subsample, run on `device`; returns
    [C, D] f32 centroids."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    train_n = min(n, max(nlists * 64, 16384))
    sample = x[rng.choice(n, size=train_n, replace=False)] if train_n < n else x
    xs = torch.from_numpy(np.ascontiguousarray(sample, dtype=np.float32)).to(device)
    return _kmeans_xs(xs, nlists, iters, seed).cpu().numpy().astype(np.float32)


def _full_assign(
    x: np.ndarray, cents: np.ndarray, chunk: int = 65536, k_assign: int = 1, device="cuda"
) -> np.ndarray:
    """Assign every corpus row to its k nearest centroids, tiled so the
    [N, C] distance matrix never materializes whole."""
    cj = torch.from_numpy(np.ascontiguousarray(cents, dtype=np.float32)).to(device)
    shape = (x.shape[0],) if k_assign == 1 else (x.shape[0], k_assign)
    out = np.empty(shape, dtype=np.int32)
    for lo in range(0, x.shape[0], chunk):
        hi = min(lo + chunk, x.shape[0])
        tile = x[lo:hi]
        pad = chunk - (hi - lo)
        if pad:
            tile = np.concatenate([tile, np.zeros((pad, x.shape[1]), x.dtype)])
        t = torch.from_numpy(np.ascontiguousarray(tile, dtype=np.float32)).to(device)
        a = _assign_chunk(t, cj, k_assign=k_assign).cpu().numpy()
        out[lo:hi] = a[: hi - lo]
    return out


class IvfState:
    """Trained quantizer + inverted lists over mirror row slots.

    Host-authoritative: `lists` maps centroid → row slots; device tensors
    are compacted lazily (numpy only — never a KV rescan). Incremental adds
    assign to the nearest existing centroid; retrain happens when the corpus
    outgrows the trained size by 50%.
    """

    def __init__(self, centroids: np.ndarray, lists: List[List[int]], trained_n: int):
        self.centroids = centroids  # [C, D] float32
        self.lists = lists  # C lists of row slots
        self.slot_list: Dict[int, int] = {s: i for i, l in enumerate(lists) for s in l}
        self.trained_n = trained_n
        self._n = len(self.slot_list)  # O(1) size, maintained by add/remove
        self.dirty = True
        self._dev = None  # (device, cents, list_rows, list_mask, probe_ok)
        self._slot_ok = None  # (cap, device, all-true [cap] bool)
        self._mut = 0  # bumped on every list mutation
        self._sharded_cache = None  # ((_mut, id(mesh), n_total), sharded tables)
        self._slot_ok_sharded = None  # (id(mesh), cap, all-true sharded [cap] bool)
        self._warmed: set = set()  # (tile, k, nprobe, metric) combos launched

    @property
    def nlists(self) -> int:
        return self.centroids.shape[0]

    # ------------------------------------------------------------ build
    @staticmethod
    def train(
        data: np.ndarray,
        alive: np.ndarray,
        nlists: Optional[int] = None,
        matrix=None,
        device="cuda",
    ) -> "IvfState":
        """Train the quantizer. When `matrix` (the mirror's device-resident
        [cap, D] tensor, or its mesh-sharded ShardedTensor) is given, the
        training sample and the full corpus
        assignment gather rows ON DEVICE — only index vectors and the [C, D]
        centroids cross the host<->device link. Without it the host rows
        train on `device`."""
        rows = np.nonzero(alive)[0]
        c = nlists or default_nlists(rows.size)
        shards = getattr(matrix, "shards", None)
        if shards is not None:
            # a mesh-sharded mirror: on one device its base is the whole
            # matrix, read in place; across cards the host rows train on
            # the mesh's first device
            device = matrix.mesh.merge_device
            matrix = matrix.base
        if matrix is not None and rows.size:
            dev = matrix.device
            rng = np.random.default_rng(7)
            train_n = min(rows.size, max(c * 64, 16384))
            sample_slots = rng.choice(rows, size=train_n, replace=False)
            xs = matrix[torch.from_numpy(sample_slots.astype(np.int64)).to(dev)]
            cents_dev = _kmeans_xs(xs, c)
            del xs
            # full assignment by device gather, chunked index uploads only
            from surrealdb_tpu_torch.utils.num import pad_tail, tile_slices

            chunk = 65536
            assign2 = np.empty((rows.size, 2), dtype=np.int32)
            for lo, hi in tile_slices(rows.size, chunk):
                idx = torch.from_numpy(pad_tail(rows[lo:hi].astype(np.int32), chunk)).to(dev)
                a = _assign_gather(matrix, idx, cents_dev, k_assign=2).cpu().numpy()
                assign2[lo:hi] = a[: hi - lo]
            cents = cents_dev.cpu().numpy().astype(np.float32)
        else:
            x = np.ascontiguousarray(data[rows], dtype=np.float32)
            cents = _kmeans(x, c, device=device)
            assign2 = _full_assign(x, cents, k_assign=2, device=device)
        # balanced assignment: top-2 candidate cells with spill to the
        # runner-up once the nearest is over 2x the mean size — bounds the
        # padded gather at ~2·N/C per probe instead of the worst cell
        cap = max(2 * (rows.size + c - 1) // c, 8)
        lists: List[List[int]] = [[] for _ in range(c)]
        for slot, (a1, a2) in zip(rows.tolist(), assign2.tolist()):
            a = a1 if len(lists[a1]) < cap or len(lists[a2]) >= len(lists[a1]) else a2
            lists[int(a)].append(slot)
        return IvfState(cents, lists, rows.size)

    # ------------------------------------------------------------ writes
    def add(self, slot: int, vec: np.ndarray) -> None:
        if slot in self.slot_list:
            return  # idempotent (reconciliation may revisit a slot)
        d2 = ((self.centroids - vec[None, :]) ** 2).sum(1)
        a1, a2 = np.argpartition(d2, 1)[:2]
        cap = max(2 * (self._n // max(self.nlists, 1) + 1), 8)
        a = int(a1) if len(self.lists[a1]) < cap or len(self.lists[a2]) >= len(self.lists[a1]) else int(a2)
        self.lists[a].append(slot)
        self.slot_list[slot] = a
        self._n += 1
        self.dirty = True
        self._mut += 1

    def remove(self, slot: int, vec=None) -> None:
        a = self.slot_list.pop(slot, None)
        if a is not None:
            try:
                self.lists[a].remove(slot)
                self._n -= 1
            except ValueError:
                pass
        self.dirty = True
        self._mut += 1

    def size(self) -> int:
        return self._n

    def needs_retrain(self) -> bool:
        return self.size() > 1.5 * max(self.trained_n, 1)

    # ------------------------------------------------------------ search
    def _device(self, device):
        """(cents [C, D] f32, list_rows [C, L] int32, list_mask [C, L] bool,
        probe_ok [C] all-true) on `device`; L is the pow2 of the longest
        list. Rebuilt only after a list mutation or for another device."""
        device = torch.device(device)
        if not self.dirty and self._dev is not None and self._dev[0] == device:
            return self._dev[1:]
        c = self.nlists
        maxlen = _next_pow2(max(max((len(l) for l in self.lists), default=1), 1))
        list_rows = np.zeros((c, maxlen), dtype=np.int32)
        list_mask = np.zeros((c, maxlen), dtype=bool)
        for i, l in enumerate(self.lists):
            list_rows[i, : len(l)] = l
            list_mask[i, : len(l)] = True
        self._dev = (
            device,
            torch.from_numpy(np.ascontiguousarray(self.centroids, dtype=np.float32)).to(device),
            torch.from_numpy(list_rows).to(device),
            torch.from_numpy(list_mask).to(device),
            torch.ones(c, dtype=torch.bool, device=device),
        )
        self.dirty = False
        return self._dev[1:]

    def _all_slots(self, cap: int, device):
        """The all-true [cap] slot_ok of a search without a prefilter, made
        once per (cap, device) instead of once per launch."""
        if self._slot_ok is None or self._slot_ok[:2] != (cap, device):
            self._slot_ok = (cap, device, torch.ones(cap, dtype=torch.bool, device=device))
        return self._slot_ok[2]

    def search_host(
        self, qs: np.ndarray, data: np.ndarray, metric: str, k: int, nprobe: int,
        slot_mask: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """CPU twin of `search_batch`: the same probe+exact-rerank recipe in
        numpy over the host mirror. This is the honest CPU-ANN baseline the
        device numbers are judged against (a sublinear competitor, not an
        exact full scan) — same role as the reference's CPU HNSW search
        (reference: core/src/idx/trees/hnsw/mod.rs:337-416).

        qs: [Q, D]; data: host [cap, D] mirror rows. Returns
        (dists [Q, k], slots [Q, k]); misses surface as +inf/-1.
        """
        if metric not in ("euclidean", "cosine"):
            raise ValueError(f"search_host supports euclidean/cosine, not {metric!r}")
        import time as _time

        from surrealdb_tpu_torch import telemetry

        _t_probe = _time.perf_counter()
        qs = np.asarray(qs, dtype=np.float32)
        nq = qs.shape[0]
        cents = self.centroids
        cn = (cents**2).sum(1)
        nprobe = min(nprobe, self.nlists)
        out_d = np.full((nq, k), np.inf, dtype=np.float32)
        out_i = np.full((nq, k), -1, dtype=np.int64)
        # one BLAS call probes every query at once: [Q, C] + |q|^2 constant,
        # so the ordering equals true euclidean distance per row
        d2c = cn[None, :] - 2.0 * (qs @ cents.T)
        probes = np.argpartition(d2c, nprobe - 1, axis=1)[:, :nprobe]
        # concatenate every query's probed lists into ONE flat candidate
        # array with owner segments — the rerank then runs as a handful of
        # vectorized numpy calls over all queries together instead of a
        # per-query python loop (GIL thrash under concurrent clients was a
        # measured contributor to the scale-1.0 concurrent-kNN collapse)
        cand_per_q: List[np.ndarray] = []
        for qi in range(nq):
            cl = [self.lists[int(p)] for p in probes[qi]]
            total = sum(len(l) for l in cl)
            c = np.fromiter((s for l in cl for s in l), dtype=np.int64, count=total)
            if slot_mask is not None:
                # columnar residual prefilter: rerank only matching slots —
                # top-k among rows that satisfy the WHERE, the same
                # condition-checker semantics as the exact strategies
                inb = c < slot_mask.shape[0]
                c = c[inb & slot_mask[np.minimum(c, slot_mask.shape[0] - 1)]]
            cand_per_q.append(c)
            telemetry.observe_hist(
                "ivf_candidates", int(c.size), buckets=telemetry.COUNT_BUCKETS, path="host"
            )
        counts = np.array([c.size for c in cand_per_q], dtype=np.int64)
        q2 = (qs**2).sum(1)
        qn = np.maximum(np.sqrt(q2), 1e-30)
        # bound the gather: query blocks capped at ~128k candidate rows, so
        # a wide batch over a big corpus can't materialize a multi-GB
        # [T, D] temporary (the per-query peak stays what the old loop had)
        cand_block = 1 << 17
        qi0 = 0
        while qi0 < nq:
            qi1 = qi0 + 1
            tot = int(counts[qi0])
            while qi1 < nq and tot + int(counts[qi1]) <= cand_block:
                tot += int(counts[qi1])
                qi1 += 1
            if tot == 0:
                qi0 = qi1
                continue
            cand_all = np.concatenate(cand_per_q[qi0:qi1])
            owner = np.repeat(np.arange(qi0, qi1), counts[qi0:qi1])
            x = data[cand_all]  # [T, D] gather, one fancy-index per block
            dots = np.einsum("ij,ij->i", x, qs[owner])
            xn2 = np.einsum("ij,ij->i", x, x)
            if metric == "cosine":
                xn = np.maximum(np.sqrt(xn2), 1e-30)
                d = 1.0 - dots / (xn * qn[owner])
            else:
                d = xn2 - 2.0 * dots  # + |q|^2 applied after top-k below
            # per-query top-k over its segment: the remaining python loop
            # does only O(T_q) selection work, no distance math
            off = 0
            for qi in range(qi0, qi1):
                t = int(counts[qi])
                if t == 0:
                    continue
                seg = d[off : off + t]
                kk = min(k, t)
                sel = np.argpartition(seg, kk - 1)[:kk] if kk < t else np.arange(t)
                sel = sel[np.argsort(seg[sel])]
                if metric == "cosine":
                    out_d[qi, :kk] = seg[sel]
                else:
                    out_d[qi, :kk] = np.sqrt(np.maximum(seg[sel] + q2[qi], 0.0))
                out_i[qi, :kk] = cand_all[off + sel]
                off += t
            qi0 = qi1
        # probe-level node under the active request's knn_search span + a
        # path-labeled duration histogram (host twin of the device probe)
        from surrealdb_tpu_torch import telemetry, tracing

        _dur = _time.perf_counter() - _t_probe
        telemetry.observe("ivf_probe", _dur, path="host")
        tracing.record_span_into(
            tracing.current(), "ivf_probe",
            {"path": "host", "nq": int(qs.shape[0]), "nprobe": int(nprobe)},
            _t_probe, _dur,
        )
        return out_d, out_i

    def search(
        self, q: np.ndarray, matrix, metric: str, k: int, nprobe: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Probe nprobe lists, exact-rerank their members on device.

        q: [D] query; matrix: device [N*, D] mirror matrix.
        Returns (dists [k], row slots [k]); misses surface as +inf/-1.
        """
        d, r = self.search_batch(q[None, :], matrix, metric, k, nprobe)
        return d[0], r[0]

    def search_batch_launch(
        self, qs: np.ndarray, matrix, metric: str, k: int, nprobe: int,
        tile: Optional[int] = None, owner=None, slot_mask=None,
    ):
        """Async probe+rerank: enqueue every tile's kernels + start the
        device→host copies, return a collect() closure that blocks on the
        results. Lets the dispatch queue overlap the next batch's upload
        with this batch's compute/download (double buffering). `slot_mask`
        [cap] restricts the rerank to matching corpus slots (the columnar
        residual prefilter)."""
        device = matrix.device
        cents, list_rows, list_mask, probe_ok = self._device(device)
        cap = int(matrix.shape[0])
        if slot_mask is None:
            slot_ok = self._all_slots(cap, device)
        else:
            pad = cap - int(slot_mask.shape[0])
            if pad > 0:
                slot_mask = np.concatenate([slot_mask, np.zeros(pad, dtype=bool)])
            slot_ok = torch.from_numpy(np.ascontiguousarray(slot_mask[:cap])).to(
                device, non_blocking=True
            )
        probe_metric = metric if metric in _PROBE_METRICS else "euclidean"
        nprobe = min(nprobe, self.nlists)
        # the kernel can return at most nprobe·L candidates per query
        k = min(k, nprobe * int(list_rows.shape[1]))
        from surrealdb_tpu_torch.utils.num import dispatch_tile, pad_tail, tile_slices

        qs = np.asarray(qs, dtype=np.float32)
        # small tile vocabulary: every distinct padded shape is a separate
        # launch shape; {1, 8, tile} bounds them AND padding waste
        nq = qs.shape[0]
        tile = dispatch_tile(nq, tile)
        from surrealdb_tpu_torch import telemetry

        # per-query probed-candidate ceiling (the kernel scans whole lists)
        telemetry.observe_hist(
            "ivf_candidates",
            nprobe * int(list_rows.shape[1]),
            buckets=telemetry.COUNT_BUCKETS,
            path="device",
        )
        from surrealdb_tpu_torch import compile_log

        pending = []
        with compile_log.tracked(
            "ivf",
            _ivf_shape_key(tile, cents, list_rows, matrix, metric, probe_metric, k, nprobe),
        ):
            for lo, hi in tile_slices(nq, tile):
                qt = torch.from_numpy(np.ascontiguousarray(pad_tail(qs[lo:hi], tile)))
                d, r = _ivf_search(
                    qt.to(device, non_blocking=True), cents, list_rows, list_mask, matrix,
                    slot_ok, metric=metric, probe_metric=probe_metric, k=k, nprobe=nprobe,
                    probe_ok=probe_ok,
                )
                pending.append((lo, hi) + _start_host_copy(d, r))

        def collect() -> Tuple[np.ndarray, np.ndarray]:
            dd = np.empty((nq, k), dtype=np.float32)
            rr = np.empty((nq, k), dtype=np.int64)
            for lo, hi, d, r, ev in pending:
                if ev is not None:
                    ev.synchronize()
                dd[lo:hi] = d.numpy()[: hi - lo]
                rr[lo:hi] = r.numpy()[: hi - lo]
            return dd, rr

        self._warm_tiles(qs.shape[1], cents, list_rows, list_mask, matrix,
                         metric, probe_metric, k, nprobe, tile, owner, probe_ok)
        return collect

    def _warm_tiles(self, dim, cents, list_rows, list_mask, matrix,
                    metric, probe_metric, k, nprobe, served_tile, owner=None,
                    probe_ok=None) -> None:
        """Launch the OTHER dispatch tile shapes for these query params once
        in the background: a burst of concurrent queries coalesces into
        8/64-wide batches, whose first dispatch would otherwise pay the
        kernel library's build and load. Zero-queries through the same
        kernels carry no correctness risk — results are discarded."""
        from surrealdb_tpu_torch.utils.num import warm_tile_sizes

        todo = []
        for t in warm_tile_sizes():
            key = (t, k, nprobe, metric)
            if t != served_tile and key not in self._warmed:
                self._warmed.add(key)
                todo.append(t)
        self._warmed.add((served_tile, k, nprobe, metric))
        if not todo:
            return
        slot_ok = self._all_slots(int(matrix.shape[0]), matrix.device)

        def warm():
            from surrealdb_tpu_torch import compile_log

            for t in todo:
                try:
                    with compile_log.tracked(
                        "ivf",
                        _ivf_shape_key(
                            t, cents, list_rows, matrix, metric, probe_metric,
                            k, nprobe,
                        ),
                        prewarmed=True,
                    ):
                        _ivf_search(
                            torch.zeros((t, dim), dtype=torch.float32, device=matrix.device),
                            cents, list_rows, list_mask, matrix, slot_ok,
                            metric=metric, probe_metric=probe_metric, k=k,
                            nprobe=nprobe, probe_ok=probe_ok,
                        )
                except Exception:
                    from surrealdb_tpu_torch import telemetry

                    # a failed tile warm = a first launch inside some
                    # future request; count it so cold latency is attributable
                    telemetry.inc("prewarm_errors", subsystem="ivf")

        from surrealdb_tpu_torch import bg

        bg.spawn("shape_warm", f"ivf:k{k}:p{nprobe}", warm, owner=owner)

    def search_batch(
        self, qs: np.ndarray, matrix, metric: str, k: int, nprobe: int,
        tile: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched probe+rerank: qs [Q, D] → (dists [Q, k], slots [Q, k]).

        Queries are tiled so the [tile, nprobe·L] candidate distances stay
        within memory; each tile is one probe+rerank launch sequence (the
        cross-query batching seam — amortizes launch latency across queries).
        """
        return self.search_batch_launch(qs, matrix, metric, k, nprobe, tile)()

    # -------------------------------------------------------- mesh search
    def _device_sharded(self, mesh, n_total: int, axis: str = "data"):
        """Per-shard inverted-list tables for sharded_ivf_search: each
        list's slots bucketed by owning shard (slot // shard_rows, the last
        shard taking any remainder) into a [n_dev, C, L] local-row table
        and its mask, list members in list order, L the pow2 of the longest
        (shard, list) bucket; placed sharded over the mesh axis, so each
        shard holds only ITS slab, aligned with its corpus rows. Returns
        (cents replicated, rows, mask, shard_rows); cached per (list
        mutation, mesh, n_total)."""
        from surrealdb_tpu_torch.parallel import mesh as M

        n_dev = mesh.shape[axis]
        shard_rows = n_total // n_dev
        key = (self._mut, id(mesh), n_total)
        if self._sharded_cache is not None and self._sharded_cache[0] == key:
            return self._sharded_cache[1]
        c = self.nlists
        lens = np.array([len(l) for l in self.lists], dtype=np.int64)
        slots = (np.concatenate([np.asarray(l, dtype=np.int64) for l in self.lists])
                 if lens.sum() else np.zeros(0, dtype=np.int64))
        owner = np.minimum(slots // max(shard_rows, 1), n_dev - 1)
        group = owner * c + np.repeat(np.arange(c, dtype=np.int64), lens)  # (shard, list)
        order = np.argsort(group, kind="stable")  # keeps list order inside a group
        counts = np.bincount(group, minlength=n_dev * c)
        starts = np.cumsum(counts) - counts
        g = group[order]
        pos = np.arange(order.size) - starts[g]
        maxlen = _next_pow2(max(int(counts.max()) if counts.size else 1, 1))
        rows = np.zeros((n_dev * c, maxlen), dtype=np.int32)
        mask = np.zeros((n_dev * c, maxlen), dtype=bool)
        rows[g, pos] = (slots - owner * shard_rows)[order]
        mask[g, pos] = True
        spec = (axis, None, None)
        dev = (
            M.replicate(mesh, np.ascontiguousarray(self.centroids, dtype=np.float32)),
            M.shard_tensor(mesh, rows.reshape(n_dev, c, maxlen), spec),
            M.shard_tensor(mesh, mask.reshape(n_dev, c, maxlen), spec),
            shard_rows,
        )
        self._sharded_cache = (key, dev)
        return dev

    def search_batch_sharded(
        self, qs: np.ndarray, mesh, matrix, metric: str, k: int, nprobe: int,
        tile: Optional[int] = None, slot_mask: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched sharded probe+rerank over a mesh-sharded mirror matrix
        (K13). Same contract as search_batch; misses surface as +inf/-1.
        `slot_mask` is the columnar residual prefilter over corpus slots:
        it rides into the kernels row-sharded alongside the corpus so top-k
        is computed among MATCHING rows only."""
        from surrealdb_tpu_torch import compile_log
        from surrealdb_tpu_torch.parallel import mesh as M
        from surrealdb_tpu_torch.utils.num import dispatch_tile, pad_tail, tile_slices

        axis = mesh.axis_names[0]
        matrix = M.as_sharded(mesh, matrix, (axis, None))
        cents, list_rows, list_mask, _ = self._device_sharded(mesh, matrix.shape[0], axis)
        probe_metric = metric if metric in _PROBE_METRICS else "euclidean"
        nprobe = min(nprobe, self.nlists)
        qs = np.asarray(qs, dtype=np.float32)
        cap = int(matrix.shape[0])
        if slot_mask is not None:
            sm = np.asarray(slot_mask, dtype=bool)
            if sm.shape[0] < cap:  # pad slots are dead anyway
                sm = np.concatenate([sm, np.zeros(cap - sm.shape[0], dtype=bool)])
            sm = sm[:cap]
            # placed once here, not once a tile
            slot_dev = M.shard_tensor(mesh, sm, (axis,))
        else:
            # all slots: one all-true mask per (mesh, cap), as _all_slots
            if self._slot_ok_sharded is None or self._slot_ok_sharded[:2] != (id(mesh), cap):
                self._slot_ok_sharded = (id(mesh), cap, M.shard_tensor(
                    mesh, torch.ones(cap, dtype=torch.bool), (axis,)))
            slot_dev = self._slot_ok_sharded[2]
        tile = dispatch_tile(qs.shape[0], tile)
        dd = np.full((qs.shape[0], k), np.inf, dtype=np.float32)
        rr = np.full((qs.shape[0], k), -1, dtype=np.int64)

        def one_slice(lo, hi):
            d, r = M.sharded_ivf_search(
                mesh, cents, list_rows, list_mask, matrix,
                torch.from_numpy(np.ascontiguousarray(pad_tail(qs[lo:hi], tile))),
                k, nprobe, metric=metric, probe_metric=probe_metric, axis=axis,
                slot_ok=slot_dev,
            )
            k_out = int(d.shape[1])
            dd[lo:hi, :k_out] = d.cpu().numpy()[: hi - lo]
            rr[lo:hi, :k_out] = r.cpu().numpy()[: hi - lo]

        # each (tile, corpus, k, nprobe, metrics) is one launch shape: only
        # the FIRST slice can carry the kernel build, so only it is tracked
        slices = list(tile_slices(qs.shape[0], tile))
        with compile_log.tracked(
            "ivf_sharded",
            (tile, int(matrix.shape[1]), int(matrix.shape[0]), k, nprobe,
             metric, probe_metric),
        ):
            one_slice(*slices[0])
        for lo, hi in slices[1:]:
            one_slice(lo, hi)
        return dd, rr


def ivf_from_reference(centroids, lists, trained_n, device) -> IvfState:
    """A port IvfState equal to a reference one: `centroids` [C, D],
    `lists` (C sequences of slots) and `trained_n`, as plain arrays and
    lists. Its device tables are built on `device`. The tests use it to run
    both packages' searches on one quantizer."""
    st = IvfState(
        np.array(centroids, dtype=np.float32),
        [[int(s) for s in l] for l in lists],
        int(trained_n),
    )
    st._device(device)
    return st
