"""Sharded execution over a mesh of devices (PyTorch; CUDA kernels on the card).

Mirrors surrealdb_tpu/parallel/mesh.py. The reference is one process that
drives many devices through `shard_map`; so is this port, with no
torch.distributed: a `Mesh` is a grid of torch devices with named axes, a
`ShardedTensor` is a tensor split over it by a partition spec, and each
sharded function runs one launch sequence a shard, then the collectives:

- `all_gather` copies every shard's candidates, in shard order, into one
  buffer on the merge device (the mesh's first device); a copy between two
  cards waits on the source's stream by an event (PyTorch's cross-device
  copy_), never on a device-wide sync;
- `psum` adds partials in a fixed shard order. K12's kernel performs it
  in place: the accumulator visits the feature shards in order (hopping to
  the next shard's card when it is another), the first writes, the rest add.

The copies are data movement; the selection and the id arithmetic are
kernels (csrc/mesh.cu), each with a wrapper, a launch counter and a plain
PyTorch version here:

- K11 `sharded_knn`: per shard the fused K2 (ops/distances.py `knn_search` on
  the shard's slab: N = shard_rows, the shard's slice of the mask), then
  `mesh_topk_merge`, which selects k in lax.top_k's order and adds each
  candidate's shard offset to its id;
- K12 `sharded_knn_2d`: per (row, feature) shard `mesh_knn_2d` (the
  reference's |q|^2 + |x|^2 - 2 q.x over the feature slice on K1/K2's
  cores, psum over `model` into an accumulator; the last slice finishes,
  masks and selects the row shard's top-kk in the same pass), then
  `mesh_topk_merge`; on one card one `mesh_knn_2d` a feature shard over
  all row shards, the last selecting the answer;
- K13 `sharded_ivf_search`: the probe (the fused K2 over the replicated
  centroids) once a distinct device, then K3's `ivf_rerank` (idx/ivf.py
  `_launch_rerank`) once over all the shards a device holds (every probed
  list's members ranked and selected in one launch, slots mapped), then
  `mesh_topk_merge` (ids of finite distances only, -1 else);
- K14 `sharded_frontier_hop`: `mesh_frontier_hop` once a launch group (on
  one card the whole frontier in one launch, written into the merged
  output);
- K15 `dedup_frontier`: `mesh_dedup_frontier` (two launches over a
  `DedupScratch` kept zero between calls).

Where the shards share a device (a mesh of [cuda:0] * 8 on one card, or
[cpu] * 8 in the tests) every shard is a view of one contiguous tensor, so
the corpus is held once. Where they are on different cards each shard is a
copy on its own card, launched on that card's current stream, and the
candidates are copied to the merge device; that layout follows the same
code but has not run on more than one card.

A CUDA tensor goes to the kernels (or the wrapper raises); CPU tensors go to
the plain versions, which the tests hold against the reference and
chip_smoke.py holds the kernels against.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from surrealdb_tpu_torch.ops import distances as D
from surrealdb_tpu_torch.ops.distances import LaunchCounter
from surrealdb_tpu_torch.ops.scratch import ZeroKept, zero_kept

MERGE = LaunchCounter("mesh_topk_merge")  # K11, K12, K13's merge
KNN2D = LaunchCounter("mesh_knn_2d")  # K12
RERANK = LaunchCounter("mesh_ivf_rerank")  # K13: its launches of ivf_rerank
HOP = LaunchCounter("mesh_frontier_hop")  # K14
DEDUP = LaunchCounter("mesh_dedup_frontier")  # K15
KERNELS = (MERGE, KNN2D, RERANK, HOP, DEDUP)


# ------------------------------------------------------------------ mesh
def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A grid of devices with named axes (jax.sharding.Mesh's role).
    `devices` is a flat sequence laid out row-major over `grid` (default
    1-D); a device may repeat, so several shards can share one card.
    `shape[axis]` is the axis's size, as the reference's callers read it."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str], grid=None):
        devs = [_device(d) for d in devices]
        grid = tuple(grid) if grid is not None else (len(devs),)
        if len(grid) != len(axis_names) or int(np.prod(grid)) != len(devs) or not devs:
            raise ValueError(f"{len(devs)} devices do not fill a {grid} grid over {axis_names}")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.devices = self.devices.reshape(grid)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid))

    @property
    def merge_device(self) -> torch.device:
        """Where the collectives gather: the first device of the grid."""
        return self.devices.flat[0]

    @property
    def distinct_devices(self):
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def position(self, **coords) -> Tuple[int, ...]:
        """The grid position with the given axis coordinates, 0 on the
        others."""
        return tuple(int(coords.get(a, 0)) for a in self.axis_names)

    def device_at(self, pos) -> torch.device:
        return self.devices[tuple(pos)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", devices=None) -> Mesh:
    """A 1-D mesh over `devices` (default: every visible CUDA card), cut to
    the first n_devices. `devices` may repeat one device: [cuda:0] * 8 is
    an 8-shard mesh on one card, [cpu] * 8 the tests' counterpart of the
    reference's forced host device count."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = list(devices)
    n = n_devices or len(devs)
    if not 1 <= n <= len(devs):
        raise ValueError(f"a mesh of {n} devices over {len(devs)} available")
    return Mesh(devs[:n], (axis,))


# ------------------------------------------------------------------ sharded tensors
class ShardedTensor:
    """A tensor split over a mesh by `spec` (one entry a dimension: the mesh
    axis it is split over, or None where it is replicated). `shard(pos)` is
    the part at a grid position. With one distinct device, `base` is the
    whole tensor and every shard a view of it; otherwise `base` is None and
    each shard a copy on its own device."""

    def __init__(self, mesh: Mesh, spec, shape, dtype, shards: Dict[tuple, torch.Tensor],
                 base: Optional[torch.Tensor] = None):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.dtype = dtype
        self.shards = shards
        self.base = base

    def shard(self, pos) -> torch.Tensor:
        return self.shards[tuple(pos)]

    def nbytes(self) -> int:
        """Bytes held on the devices (a view shares its base's)."""
        if self.base is not None:
            return self.base.element_size() * self.base.nelement()
        seen, total = set(), 0
        for t in self.shards.values():
            if id(t) not in seen:
                seen.add(id(t))
                total += t.element_size() * t.nelement()
        return total

    def __repr__(self) -> str:
        return f"ShardedTensor({self.shape}, {self.dtype}, spec={self.spec}, {self.mesh!r})"


def _shard_slices(mesh: Mesh, spec, shape, pos):
    out = []
    for dim, ax in enumerate(spec):
        if ax is None:
            out.append(slice(None))
            continue
        n = mesh.shape[ax]
        w = shape[dim] // n
        i = pos[mesh.axis_names.index(ax)]
        out.append(slice(i * w, (i + 1) * w))
    return tuple(out)


def shard_tensor(mesh: Mesh, t, spec, dtype=None, copy: bool = True) -> ShardedTensor:
    """Place `t` (a tensor or numpy array) over the mesh by `spec`. Each
    split dimension must divide by its axis's size (callers pad with masked
    rows first). With copy=False a tensor already on the mesh's one device
    in `dtype` is used as it is, else the placement copies."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    dtype = dtype or t.dtype
    shape = tuple(t.shape)
    for dim, ax in enumerate(spec):
        if ax is not None and shape[dim] % mesh.shape[ax]:
            raise ValueError(f"dimension {dim} ({shape[dim]}) does not divide over "
                             f"{ax!r} ({mesh.shape[ax]})")
    positions = list(np.ndindex(*mesh.devices.shape))
    devs = mesh.distinct_devices
    if len(devs) == 1:
        dev = devs[0]
        if not copy and t.device == dev and t.dtype == dtype and t.is_contiguous():
            base = t
        else:
            base = t.to(device=dev, copy=True)
            if base.dtype != dtype:
                base = base.to(dtype)
            base = base.contiguous()
        shards = {pos: base[_shard_slices(mesh, spec, shape, pos)] for pos in positions}
        return ShardedTensor(mesh, spec, shape, dtype, shards, base)
    shards, made = {}, {}
    for pos in positions:
        dev = mesh.device_at(pos)
        sl = _shard_slices(mesh, spec, shape, pos)
        key = (dev, tuple((s.start, s.stop) for s in sl))
        if key not in made:  # a replicated part: one copy a device
            part = t[sl].to(device=dev, copy=True)
            made[key] = (part if part.dtype == dtype else part.to(dtype)).contiguous()
        shards[pos] = made[key]
    return ShardedTensor(mesh, spec, shape, dtype, shards)


def shard_corpus(mesh: Mesh, x, axis: str = "data", dtype=None) -> ShardedTensor:
    """Place a [N, D] corpus row-sharded across the mesh. N must divide by
    the axis's size: callers pad with masked rows first."""
    return shard_tensor(mesh, x, (axis, None), dtype=dtype)


def replicate(mesh: Mesh, t, dtype=None) -> ShardedTensor:
    """`t` on every device of the mesh: one copy a distinct device (none
    when it already lies on the mesh's one device in `dtype`)."""
    if isinstance(t, ShardedTensor):
        return t
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    return shard_tensor(mesh, t, (None,) * t.dim(), dtype=dtype, copy=False)


def as_sharded(mesh: Mesh, t, spec, dtype=None) -> ShardedTensor:
    """`t` as a ShardedTensor by `spec`: itself when it is one, else placed
    (without a copy when it already lies on the mesh's one device)."""
    if isinstance(t, ShardedTensor):
        return t
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    return shard_tensor(mesh, t, spec, dtype=dtype, copy=False)


def _launch_groups(mesh: Mesh, axis: str, parts: Sequence[ShardedTensor], feat_axis=None):
    """The shards along `axis` grouped by the launches that cover them, as
    [tensors of each part] a group. When every part's shards are views of
    its base (the mesh on one device), one group whose tensors are the
    bases: a launch over all the shards; otherwise one group a shard, in
    shard order, holding each part's shard there. With `feat_axis` each
    part gives a list, one entry a feature shard: its column slice (of the
    base, or the shard at that grid position) where the part is split over
    `feat_axis`, else the whole part (or its replica at that position)."""
    n_feat = mesh.shape[feat_axis] if feat_axis else 1
    one = all(p.base is not None for p in parts)

    def tensor(p, s, m):
        if not one:
            return p.shard(mesh.position(**{axis: s, **({feat_axis: m} if feat_axis else {})}))
        if feat_axis is None or feat_axis not in p.spec:
            return p.base
        dim = p.spec.index(feat_axis)
        w = p.shape[dim] // n_feat
        return p.base.narrow(dim, m * w, w)

    return [[tensor(p, s, 0) if feat_axis is None else [tensor(p, s, m) for m in range(n_feat)]
             for p in parts] for s in ([0] if one else range(mesh.shape[axis]))]


# ------------------------------------------------------------------ collectives
def all_gather(parts: Sequence[torch.Tensor], device, axis: int = 1) -> torch.Tensor:
    """Concatenate the shards' parts along `axis`, in shard order, into one
    preallocated tensor on `device` (jax.lax.all_gather, tiled=True). A part
    on another card is copied with non_blocking: PyTorch orders the copy
    after the source stream's work by an event."""
    shape = list(parts[0].shape)
    shape[axis] = sum(int(p.shape[axis]) for p in parts)
    out = torch.empty(shape, dtype=parts[0].dtype, device=device)
    lo = 0
    for p in parts:
        w = int(p.shape[axis])
        out.narrow(axis, lo, w).copy_(p, non_blocking=True)
        lo += w
    return out


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of the shards' partials in shard order on `device`
    (jax.lax.psum). K12's plain version reduces with it; on the card the
    K12 kernel adds in the same order as it accumulates."""
    out = parts[0].to(device, copy=True)
    for p in parts[1:]:
        out += p.to(device)
    return out


# ------------------------------------------------------------------ plain versions
def topk_merge_plain(d_all, i_all, kk: int, shard_rows: int, k_out: int, finite_only: bool):
    """Plain merge: lax.top_k(-d_all, k_out)'s picks (distance, then the
    lower position), ids = local id + (position // kk) * shard_rows; with
    finite_only, -1 where the distance is +inf."""
    vals, pos = D._topk_min_stable(d_all.float(), k_out)
    pos = pos.long()
    ids = i_all.gather(1, pos).long() + (pos // kk) * int(shard_rows)
    if finite_only:
        ids = torch.where(vals < float("inf"), ids, torch.full_like(ids, -1))
    return vals, ids.to(torch.int32)


def partial_sqdist_plain(q, x, acc=None, finish: bool = False, mask=None):
    """Plain K12 step: acc (or 0) + |q|^2 + |x|^2 - 2 q.x over the slice,
    f32; with finish, sqrt(max(., 0)) and +inf at masked rows."""
    q = q.float()
    x = x.float()
    qq = (q**2).sum(-1, keepdim=True)
    xx = (x**2).sum(-1)
    d2 = qq + xx[None, :] - 2.0 * (q @ x.T)
    if acc is not None:
        d2 = acc + d2
    if finish:
        d2 = torch.sqrt(torch.clamp(d2, min=0.0))
        if mask is not None:
            d2 = torch.where(mask.to(torch.bool)[None, :], d2, torch.full_like(d2, float("inf")))
    return d2


def _gather_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's gather rule: a negative index wraps once, then clamps."""
    i = i.long()
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def frontier_hop_plain(indptr, indices, frontier, frontier_mask, max_degree: int):
    """Plain K14 step over one frontier shard: (neighbours [F*max_degree]
    int32, valid [F*max_degree] bool), with the reference's index rules."""
    v1, e = int(indptr.shape[0]), int(indices.shape[0])
    fr = frontier.to(torch.int32)
    starts = indptr[_gather_index(fr, v1)]
    degs = indptr[_gather_index(fr + 1, v1)] - starts  # int32, wraps as the reference's
    offs = torch.arange(max_degree, dtype=torch.int32, device=fr.device)[None, :]
    take = starts[:, None] + offs
    valid = (offs < degs[:, None]) & frontier_mask.to(torch.bool)[:, None]
    nb = indices[take.long().clamp(0, e - 1)]
    return nb.reshape(-1).to(torch.int32), valid.reshape(-1)


def dedup_frontier_plain(nodes, mask, n_nodes: int):
    """Plain K15: (the marked ids ascending, padded with n_nodes, [F] int32;
    their mask)."""
    f = int(nodes.shape[0])
    safe = torch.where(mask.to(torch.bool), nodes.long(), torch.full_like(nodes.long(), n_nodes))
    safe = torch.where(safe < 0, safe + n_nodes + 1, safe)
    marks = torch.zeros(n_nodes + 1, dtype=torch.bool, device=nodes.device)
    marks[safe[(safe >= 0) & (safe <= n_nodes)]] = True
    marks[n_nodes] = False
    present = marks.nonzero()[:f, 0].to(torch.int32)
    out = torch.full((f,), n_nodes, dtype=torch.int32, device=nodes.device)
    out[: present.shape[0]] = present
    return out, out < n_nodes


# ------------------------------------------------------------------ CUDA kernels
def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None


def _on(dev):
    """The card `dev` as the current one (a launch plan sizes itself there);
    nothing for the CPU, where the tests drive the kernels' emulation."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _on_card(*ts) -> bool:
    devs = {t.device for t in ts}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    return True


def _launch_topk_merge(lib, d_all, i_all, kk, shard_rows, k_out, finite_only):
    """mesh_topk_merge's argument checks and launch through `lib`."""
    from surrealdb_tpu_torch.ops import _cuda

    if d_all.dtype != torch.float32 or i_all.dtype != torch.int32:
        raise TypeError("d_all must be float32 and i_all int32")
    if d_all.dim() != 2 or d_all.shape != i_all.shape or not (d_all.is_contiguous()
                                                                and i_all.is_contiguous()):
        raise ValueError(f"d_all and i_all must be contiguous [Q, S*kk], got "
                         f"{tuple(d_all.shape)}, {tuple(i_all.shape)}")
    nq, m = d_all.shape
    if kk < 1 or m % kk or not 1 <= k_out <= m:
        raise ValueError(f"kk={kk}, k_out={k_out} do not fit {m} candidates")
    out_d = torch.empty((nq, k_out), dtype=torch.float32, device=d_all.device)
    out_i = torch.empty((nq, k_out), dtype=torch.int32, device=d_all.device)
    status = lib.mesh_topk_merge(
        d_all.data_ptr(), i_all.data_ptr(), nq, m, kk, int(shard_rows), k_out, int(finite_only),
        out_d.data_ptr(), out_i.data_ptr(), _stream(d_all.device),
    )
    _cuda.check(status, "mesh_topk_merge")
    return out_d, out_i


def topk_merge(d_all, i_all, kk: int, shard_rows: int, k_out: int, finite_only: bool = False):
    """Merge the all-gathered candidates d_all / i_all [Q, S*kk] (local ids)
    into (dists [Q, k_out] f32, global ids [Q, k_out] int32)."""
    if not _on_card(d_all, i_all):
        return topk_merge_plain(d_all, i_all, kk, shard_rows, k_out, finite_only)
    from surrealdb_tpu_torch.ops import _cuda

    with torch.cuda.device(d_all.device):
        out = _launch_topk_merge(_cuda.lib(), d_all, i_all, kk, shard_rows, k_out, finite_only)
    MERGE.bump()
    return out


def _launch_knn_2d(lib, q, x, acc=None, finish=False, mask=None, kk=0):
    """mesh_knn_2d's argument checks and launch through `lib`. kk = 0:
    returns the accumulator (made here when acc is None: the first slice);
    kk > 0 (a finished last slice): (dists [Q, kk] f32, rows [Q, kk]
    int32), the row shard's top-kk; acc is then read (unless None), not
    written."""
    from surrealdb_tpu_torch.ops import _cuda

    if q.dtype != torch.float32 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"queries must be float32 and x float32 or bfloat16 ({q.dtype}, {x.dtype})")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1] or q.stride(1) != 1 \
            or x.stride(1) != 1:
        raise ValueError(f"q [Q, Dm] and x [rows, Dm] must have unit column stride, got "
                         f"{tuple(q.shape)} {q.stride()}, {tuple(x.shape)} {x.stride()}")
    nq, rows = q.shape[0], x.shape[0]
    if kk and (not finish or not 1 <= kk <= rows):
        raise ValueError(f"kk={kk} needs finish and 1 <= kk <= {rows}")
    first = acc is None
    if first and not kk:
        acc = torch.empty((nq, rows), dtype=torch.float32, device=x.device)
    elif not first and (acc.dtype != torch.float32 or acc.shape != (nq, rows)
                        or not acc.is_contiguous()):
        raise ValueError(f"acc must be a contiguous float32 [{nq}, {rows}] tensor")
    m = None
    if finish and mask is not None:
        if mask.shape != (rows,) or mask.dtype != torch.bool or not mask.is_contiguous():
            raise ValueError(f"mask must be a contiguous bool [{rows}] tensor")
        m = mask.view(torch.uint8)
    bf16 = int(x.dtype == torch.bfloat16)
    nbytes = int(lib.mesh_knn_2d_scratch_bytes(nq, rows, x.shape[1], kk, bf16))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes else None
    out_d = out_i = None
    if kk:
        out_d = torch.empty((nq, kk), dtype=torch.float32, device=x.device)
        out_i = torch.empty((nq, kk), dtype=torch.int32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    status = lib.mesh_knn_2d(
        q.data_ptr(), q.stride(0), nq, x.data_ptr(), bf16, x.stride(0), rows, x.shape[1],
        ptr(acc), int(first), int(finish), ptr(m), kk, ptr(scratch), nbytes, ptr(out_d),
        ptr(out_i), _stream(x.device),
    )
    _cuda.check(status, "mesh_knn_2d")
    return (out_d, out_i) if kk else acc


def _knn_2d_cuda(q, x, acc, finish, mask, kk):
    from surrealdb_tpu_torch.ops import _cuda

    with torch.cuda.device(x.device):  # the plan sizes itself on the shard's card
        out = _launch_knn_2d(_cuda.lib(), q, x, acc, finish, mask, kk)
    KNN2D.bump()
    return out


def partial_sqdist(q, x, acc=None, finish: bool = False, mask=None):
    """One (row shard, feature shard) step of K12: acc [Q, rows] f32 (None:
    this is the first feature shard) + the slice's partial squared
    distance; `finish` applies sqrt(max(., 0)) and +inf at the rows `mask`
    excludes."""
    ts = [q, x] + ([acc] if acc is not None else []) + ([mask] if mask is not None else [])
    if not _on_card(*ts):
        return partial_sqdist_plain(q, x, acc, finish, mask)
    return _knn_2d_cuda(q, x, acc, finish, mask, 0)


def sqdist_topk(q, x, acc, mask, kk: int):
    """The last feature shard's step of K12: acc (None: the only feature
    shard) + the slice's partial squared distance, finished and masked as
    partial_sqdist's, then the row shard's kk nearest rows in (distance,
    lower row) order -> (dists [Q, kk] f32, rows [Q, kk] int32). On the
    card one fused pass and its merge, so the finished distances never
    reach memory; a kk above K2's fused limit (a shape rule, as K2's)
    finishes into the accumulator and selects it with K2's select."""
    ts = [q, x] + ([acc] if acc is not None else []) + ([mask] if mask is not None else [])
    if not _on_card(*ts):
        return D._topk_min_stable(partial_sqdist_plain(q, x, acc, True, mask), kk)
    from surrealdb_tpu_torch.ops import _cuda

    if kk > _cuda.lib().knn_search_max_k():
        return D.select_min_k(_knn_2d_cuda(q, x, acc, True, mask, 0), kk)
    return _knn_2d_cuda(q, x, acc, True, mask, kk)


def _check_i32(t, what):
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-d int32 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _check_mask(t, n, what):
    if t.dtype != torch.bool or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous bool [{n}] tensor")


def _launch_frontier_hop(lib, indptr, indices, frontier, frontier_mask, max_degree,
                         out_nb=None, out_valid=None):
    """mesh_frontier_hop's checks and launch through `lib`, into out_nb /
    out_valid [F*max_degree] when given (views of the merged output)."""
    from surrealdb_tpu_torch.ops import _cuda

    for t, what in ((indptr, "indptr"), (indices, "indices"), (frontier, "frontier")):
        _check_i32(t, what)
    f = frontier.shape[0]
    _check_mask(frontier_mask, f, "frontier_mask")
    if max_degree < 1 or indptr.shape[0] < 1 or indices.shape[0] < 1:
        raise ValueError("max_degree, indptr and indices must not be empty")
    dev = frontier.device
    if out_nb is None:
        out_nb = torch.empty(f * max_degree, dtype=torch.int32, device=dev)
        out_valid = torch.empty(f * max_degree, dtype=torch.bool, device=dev)
    status = lib.mesh_frontier_hop(
        indptr.data_ptr(), indptr.shape[0], indices.data_ptr(), indices.shape[0],
        frontier.data_ptr(), frontier_mask.view(torch.uint8).data_ptr(), f, max_degree,
        out_nb.data_ptr(), out_valid.view(torch.uint8).data_ptr(), _stream(dev),
    )
    _cuda.check(status, "mesh_frontier_hop")
    return out_nb, out_valid


class DedupScratch(ZeroKept):
    """K15's scratch on one (device, stream, n_nodes) (ops/scratch.py): the
    bitmap of the marked nodes and the compaction's look-back state, zero
    between calls (the kernels leave them so)."""

    def __init__(self, lib, n_nodes: int, device):
        super().__init__()
        words = int(lib.mesh_dedup_bitmap_words(n_nodes))
        self.bits = torch.zeros(max(words, 1), dtype=torch.int32, device=device)
        self.state = torch.zeros(int(lib.mesh_dedup_state_entries(n_nodes)), dtype=torch.int64,
                                 device=device)


def dedup_scratch(lib, device, n_nodes: int, stream=None) -> DedupScratch:
    """The cached DedupScratch of (device, its current stream, n_nodes)."""
    return zero_kept(DedupScratch, lib, device, n_nodes, stream or _stream(device))


def _launch_dedup_frontier(lib, nodes, mask, n_nodes, scratch: Optional[DedupScratch] = None):
    """mesh_dedup_frontier's checks and launch through `lib`, over `scratch`
    (default: the cached one of the nodes' device, stream and n_nodes). The
    one allocation a call is what it returns: F ids and F flags."""
    from surrealdb_tpu_torch.ops import _cuda

    _check_i32(nodes, "nodes")
    f = nodes.shape[0]
    _check_mask(mask, f, "mask")
    if f < 1 or n_nodes < 0:
        raise ValueError(f"F={f}, n_nodes={n_nodes}")
    dev = nodes.device
    stream = _stream(dev)
    if scratch is None:
        scratch = dedup_scratch(lib, dev, n_nodes, stream)
    buf = torch.empty(5 * f, dtype=torch.uint8, device=dev)
    out, out_mask = buf[: 4 * f].view(torch.int32), buf[4 * f:].view(torch.bool)
    status = scratch.run(lambda clear: lib.mesh_dedup_frontier(
        nodes.data_ptr(), mask.view(torch.uint8).data_ptr(), f, n_nodes, scratch.bits.data_ptr(),
        scratch.state.data_ptr(), clear, out.data_ptr(), out_mask.data_ptr(), stream))
    _cuda.check(status, "mesh_dedup_frontier", lib)
    return out, out_mask


# ------------------------------------------------------------------ K11
def _sharded_knn(mesh, corpus, mask, queries, k, metric, axis, search, merge):
    corpus = as_sharded(mesh, corpus, (axis, None))
    mask = as_sharded(mesh, mask, (axis,))
    qs = replicate(mesh, queries, dtype=torch.float32)
    n_dev = mesh.shape[axis]
    shard_rows = corpus.shape[0] // n_dev
    kk = min(k, shard_rows)
    d_parts, i_parts = [], []
    for s in range(n_dev):
        pos = mesh.position(**{axis: s})
        d, i = search(qs.shard(pos), corpus.shard(pos), mask.shard(pos), metric, kk)
        d_parts.append(d)
        i_parts.append(i)
    dev = mesh.merge_device
    return merge(all_gather(d_parts, dev), all_gather(i_parts, dev), kk, shard_rows, k, False)


def sharded_knn(mesh: Mesh, corpus, mask, queries, k: int, metric: str = "euclidean",
                axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over a row-sharded corpus (K11).

    corpus: [N, D] sharded (axis, None); mask: [N] bool sharded (axis,);
    queries: [Q, D] f32, replicated. Returns (dists [Q, k] f32, global ids
    [Q, k] int32) on the merge device. Per shard the distances and a local
    top-kk (the fused K2 on the shard's slab), then one all-gather of the
    kk-candidate sets and the merge."""
    return _sharded_knn(mesh, corpus, mask, queries, k, metric, axis, D.knn_search, topk_merge)


def sharded_knn_plain(mesh: Mesh, corpus, mask, queries, k: int, metric: str = "euclidean",
                      axis: str = "data"):
    """K11 by the plain versions, on whatever device the shards lie."""
    return _sharded_knn(mesh, corpus, mask, queries, k, metric, axis, D.knn_search_plain,
                        topk_merge_plain)


@functools.lru_cache(maxsize=64)
def sharded_knn_jit(mesh: Mesh, k: int, metric: str, axis: str = "data"):
    """A closure for repeated sharded kNN calls, one per (mesh, k, metric,
    axis) (the reference's jitted closure; PyTorch runs eagerly)."""

    def run(corpus, mask, queries):
        return sharded_knn(mesh, corpus, mask, queries, k, metric, axis)

    return run


# ------------------------------------------------------------------ K12
def _sharded_2d_inputs(mesh, corpus, mask, queries, k, data_axis, feat_axis):
    corpus = as_sharded(mesh, corpus, (data_axis, feat_axis))
    mask = as_sharded(mesh, mask, (data_axis,))
    qs = as_sharded(mesh, queries, (None, feat_axis), dtype=torch.float32)
    n_data = mesh.shape[data_axis]
    shard_rows = corpus.shape[0] // n_data
    return corpus, mask, qs, shard_rows, min(k, shard_rows)


def sharded_knn_2d(mesh: Mesh, corpus, mask, queries, k: int, data_axis: str = "data",
                   feat_axis: str = "model") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact euclidean kNN over a 2-D sharded corpus (K12): rows over
    `data_axis`, features over `feat_axis`; queries [Q, D] split on
    features. Each (row, feature) shard adds its partial squared distance
    into its row shard's accumulator in feature order (the psum); the last
    applies the sqrt and the mask and takes the row shard's top-kk in the
    same pass; then the all-gather over rows and the merge. On one card
    each feature shard's step runs once over all row shards, and the last
    one's top-k over all rows is the answer (the merge's order: distance,
    then the lower row). Returns (dists [Q, k], ids [Q, k]) on the merge
    device."""
    corpus, mask, qs, shard_rows, kk = _sharded_2d_inputs(mesh, corpus, mask, queries, k,
                                                          data_axis, feat_axis)
    if corpus.shard(mesh.position()).device.type == "cpu":  # CPU shards: the plain versions
        return sharded_knn_2d_plain(mesh, corpus, mask, qs, k, data_axis, feat_axis)
    n_feat = mesh.shape[feat_axis]
    d_parts, i_parts = [], []
    for xs, q_parts, masks in _launch_groups(mesh, data_axis, (corpus, qs, mask), feat_axis):
        acc = None
        for m, (q, x) in enumerate(zip(q_parts, xs)):
            if acc is not None and acc.device != x.device:
                acc = acc.to(x.device)  # the psum's hop to the next feature shard's card
            if m < n_feat - 1:
                acc = partial_sqdist(q, x, acc)
        d, i = sqdist_topk(q, x, acc, masks[-1], min(k, x.shape[0]))
        d_parts.append(d)
        i_parts.append(i)
    dev = mesh.merge_device
    if len(d_parts) == 1:  # the group covers every row: its top-k is the merge's answer
        return d.to(dev), i.to(dev)
    return topk_merge(all_gather(d_parts, dev), all_gather(i_parts, dev), kk, shard_rows, k)


def sharded_knn_2d_plain(mesh: Mesh, corpus, mask, queries, k: int, data_axis: str = "data",
                         feat_axis: str = "model"):
    """K12 by the plain versions, on whatever device the shards lie, with
    each row shard's partials reduced by `psum` (the tests hold the
    in-kernel accumulation against it)."""
    corpus, mask, qs, shard_rows, kk = _sharded_2d_inputs(mesh, corpus, mask, queries, k,
                                                          data_axis, feat_axis)
    d_parts, i_parts = [], []
    for r in range(mesh.shape[data_axis]):
        first = mesh.position(**{data_axis: r})
        parts = [
            partial_sqdist_plain(qs.shard(pos), corpus.shard(pos))
            for pos in (mesh.position(**{data_axis: r, feat_axis: m})
                        for m in range(mesh.shape[feat_axis]))
        ]
        d2 = psum(parts, mesh.device_at(first))
        d = torch.sqrt(torch.clamp(d2, min=0.0))
        live = mask.shard(first).to(torch.bool)
        d = torch.where(live[None, :], d, torch.full_like(d, float("inf")))
        dd, ii = D._topk_min_stable(d, kk)
        d_parts.append(dd)
        i_parts.append(ii)
    dev = mesh.merge_device
    return topk_merge_plain(all_gather(d_parts, dev), all_gather(i_parts, dev), kk,
                            shard_rows, k, False)


# ------------------------------------------------------------------ K13
def _ivf_search_shards(mesh, cents, list_rows, list_mask, corpus, slot_ok, queries, kk, k_out,
                       nprobe, metric, probe_metric, axis, probe, rerank, merge):
    """K13 a shard at a time: the probe once a device, K3's rerank a shard,
    the merge of the finite picks (the plain versions, or the wrappers
    that take them for CPU tensors)."""
    n_dev = mesh.shape[axis]
    shard_rows = corpus.shape[0] // n_dev
    probes = {}  # the same function of replicated inputs: once a device
    d_parts, i_parts = [], []
    for s in range(n_dev):
        pos = mesh.position(**{axis: s})
        x = corpus.shard(pos)
        q = queries.shard(pos)
        if x.device not in probes:
            probes[x.device] = probe(q, cents.shard(pos), probe_metric, nprobe)
        d, slots = rerank(q, probes[x.device], list_rows.shard(pos)[0], list_mask.shard(pos)[0],
                          x, slot_ok.shard(pos), metric, kk)
        d_parts.append(d)
        i_parts.append(slots)
    dev = mesh.merge_device
    return merge(all_gather(d_parts, dev), all_gather(i_parts, dev), kk, shard_rows, k_out, True)


def _ivf_search_cuda(mesh, cents, list_rows, list_mask, corpus, slot_ok, queries, kk, k_out,
                     nprobe, metric, probe_metric, axis, probe_ok):
    """K13 on the card: the probe once a distinct device, K3's `ivf_rerank`
    once a launch group (all the shards on one card, else a shard), then
    the merge of the finite picks. `probe_ok` caches the probe's all-true mask a (device, C)."""
    from surrealdb_tpu_torch.idx import ivf as IVF
    from surrealdb_tpu_torch.ops import _cuda

    lib = _cuda.lib()
    n_dev = mesh.shape[axis]
    shard_rows = corpus.shape[0] // n_dev
    n_lists, lmax = int(list_rows.shape[1]), int(list_rows.shape[2])
    dev0 = mesh.merge_device
    with _on(dev0):
        plan = IVF.rerank_plan(lib, int(queries.shape[0]), n_dev, nprobe, lmax, kk,
                               int(corpus.shape[1]), int(corpus.dtype == torch.bfloat16))
    groups, kkb = plan[1:]
    probes = {}
    d_parts, i_parts = [], []
    for q, c, x, lrows, lmask, ok in _launch_groups(
            mesh, axis, (queries, cents, corpus, list_rows, list_mask, slot_ok)):
        dev = x.device
        if dev not in probes:
            key = (dev, n_lists)
            if key not in probe_ok:
                probe_ok[key] = torch.ones(n_lists, dtype=torch.bool, device=dev)
            probes[dev] = D.knn_search(q, c, probe_ok[key], probe_metric, nprobe)[1]
        with _on(dev):
            # every launch group takes the plan made for all the shards
            # (valid for fewer), so the merge reads one layout
            d, i = IVF._launch_rerank(lib, q, probes[dev], x, lrows.reshape(-1, n_lists, lmax),
                                      lmask.reshape(-1, n_lists, lmax), ok, metric, plan)
        RERANK.bump()
        d_parts.append(d)
        i_parts.append(i)
    if len(d_parts) == 1 and d_parts[0].device == dev0:
        d_all, i_all = d_parts[0], i_parts[0]
    else:
        d_all, i_all = all_gather(d_parts, dev0), all_gather(i_parts, dev0)
    return topk_merge(d_all, i_all, nprobe * groups * kkb, shard_rows, k_out, True)


@functools.lru_cache(maxsize=64)
def _ivf_searcher(mesh: Mesh, k: int, nprobe: int, kk: int, k_out: int, metric: str,
                  probe_metric: str, axis: str, plain: bool = False):
    """The sharded probe + rerank for one (mesh, params), cached as the
    reference caches its compiled executable: on the card the probe (the
    fused K2 over the centroids) once a distinct device, K13's rerank once
    a device, then the merge of the finite picks; with plain (or shards on
    the CPU) the plain versions a shard."""
    from surrealdb_tpu_torch.idx import ivf as IVF

    if plain:
        fns = (IVF.ivf_probe_plain, IVF.ivf_rerank_plain, topk_merge_plain)
    else:  # CPU shards: the wrappers, which take the plain versions
        fns = (IVF._ivf_probe, IVF._ivf_rerank, topk_merge)
    probe_ok = {}

    def search(cents, list_rows, list_mask, corpus, slot_ok, queries):
        args = (mesh, cents, list_rows, list_mask, corpus, slot_ok, queries, kk, k_out, nprobe,
                metric, probe_metric, axis)
        if plain or corpus.shard(mesh.position()).device.type == "cpu":
            return _ivf_search_shards(*args, *fns)
        return _ivf_search_cuda(*args, probe_ok)

    return search


def _sharded_ivf(mesh, cents, list_rows, list_mask, corpus, queries, k, nprobe, metric,
                 probe_metric, axis, slot_ok, plain):
    corpus = as_sharded(mesh, corpus, (axis, None))
    n_dev = mesh.shape[axis]
    L = int(list_rows.shape[2])
    kk = min(k, nprobe * L)
    k_out = min(k, n_dev * kk)
    if slot_ok is None:
        slot_ok = torch.ones(int(corpus.shape[0]), dtype=torch.bool, device=mesh.merge_device)
    run = _ivf_searcher(mesh, k, nprobe, kk, k_out, metric, probe_metric, axis, plain)
    return run(
        replicate(mesh, cents, dtype=torch.float32),
        as_sharded(mesh, list_rows, (axis, None, None)),
        as_sharded(mesh, list_mask, (axis, None, None)),
        corpus,
        as_sharded(mesh, slot_ok, (axis,)),
        replicate(mesh, queries, dtype=torch.float32),
    )


def sharded_ivf_search(mesh: Mesh, cents, list_rows, list_mask, corpus, queries, k: int,
                       nprobe: int, metric: str = "euclidean", probe_metric: str = "euclidean",
                       axis: str = "data", slot_ok=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded IVF ANN search (K13, the mesh composition of idx/ivf.py).

    Centroids [C, D] and queries [Q, D] replicated; the corpus row-sharded;
    the inverted lists pre-partitioned by owning shard into [n_dev, C, L]
    local-row tables sharded over `axis` (IvfState._device_sharded). Each
    shard reranks only its members of the probed lists; `slot_ok` [N] bool
    (sharded like the corpus; None: every slot) is the residual prefilter.
    Returns (dists [Q, k_out] f32, global slots [Q, k_out] int32), k_out <=
    k when the probed lists cannot yield k candidates; misses +inf / -1."""
    return _sharded_ivf(mesh, cents, list_rows, list_mask, corpus, queries, k, nprobe, metric,
                        probe_metric, axis, slot_ok, False)


def sharded_ivf_search_plain(mesh: Mesh, cents, list_rows, list_mask, corpus, queries, k: int,
                             nprobe: int, metric: str = "euclidean",
                             probe_metric: str = "euclidean", axis: str = "data", slot_ok=None):
    """K13 by the plain versions, on whatever device the shards lie."""
    return _sharded_ivf(mesh, cents, list_rows, list_mask, corpus, queries, k, nprobe, metric,
                        probe_metric, axis, slot_ok, True)


# ------------------------------------------------------------------ graph
def _hop_cuda(args, max_degree, out=()):
    from surrealdb_tpu_torch.ops import _cuda

    with _on(args[2].device):
        res = _launch_frontier_hop(_cuda.lib(), *args, max_degree, *out)
    HOP.bump()
    return res


def _frontier_hop(mesh, indptr, indices, frontier, frontier_mask, max_degree, axis, plain):
    """K14 once a launch group (_launch_groups: the whole frontier at once
    where its shards are views of one tensor, else once a shard): the plain
    version for a group on the CPU (or with `plain`), else the kernel,
    written straight into the merged output where the group lies on the
    merge device, else copied there. The groups' frontiers, in order, are
    the frontier in shard order, so the output is the shards' outputs
    concatenated."""
    ptr = replicate(mesh, indptr)
    idx = replicate(mesh, indices)
    fr = as_sharded(mesh, frontier, (axis,))
    fm = as_sharded(mesh, frontier_mask, (axis,))
    dev = mesh.merge_device
    n = fr.shape[0] * max_degree
    nb = torch.empty(n, dtype=torch.int32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    lo = 0
    for args in _launch_groups(mesh, axis, (ptr, idx, fr, fm)):
        out = slice(lo, lo + args[2].shape[0] * max_degree)
        lo = out.stop
        if plain or not _on_card(*args):
            part = frontier_hop_plain(*args, max_degree)
        elif args[2].device == dev:
            _hop_cuda(args, max_degree, (nb[out], valid[out]))
            continue
        else:
            part = _hop_cuda(args, max_degree)
        nb[out].copy_(part[0], non_blocking=True)
        valid[out].copy_(part[1], non_blocking=True)
    return nb, valid


def sharded_frontier_hop(mesh: Mesh, indptr, indices, frontier, frontier_mask, max_degree: int,
                         axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """One BFS hop over a replicated CSR with a sharded frontier (K14).

    indptr [V+1] and indices [E] int32, replicated; frontier [F] int32 and
    frontier_mask [F] bool, F a multiple of the axis's size, sharded. Each
    shard expands its frontier slice with a fixed-width (max_degree)
    gather (on one card one launch over every shard). Returns (neighbours
    [F*max_degree] int32, valid mask) on the merge device, in frontier
    order (the shards' outputs concatenated)."""
    return _frontier_hop(mesh, indptr, indices, frontier, frontier_mask, max_degree, axis,
                         False)


def sharded_frontier_hop_plain(mesh: Mesh, indptr, indices, frontier, frontier_mask,
                               max_degree: int, axis: str = "data"):
    """K14 by the plain version, on whatever device the shards lie."""
    return _frontier_hop(mesh, indptr, indices, frontier, frontier_mask, max_degree, axis, True)


def dedup_frontier(nodes, mask, n_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-device frontier dedup via a visited bitmap (K15): the nodes' bits
    set, then compacted in ascending order, over a scratch kept zero
    between calls.

    Returns (unique ascending nodes [F] int32, padded with n_nodes;
    new_mask): a fixed output shape, the input's."""
    if not _on_card(nodes, mask):
        return dedup_frontier_plain(nodes, mask, n_nodes)
    from surrealdb_tpu_torch.ops import _cuda

    with torch.cuda.device(nodes.device):
        out = _launch_dedup_frontier(_cuda.lib(), nodes, mask, n_nodes)
    DEDUP.bump()
    return out
