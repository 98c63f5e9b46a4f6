"""Device-resident CSR graph mirrors + batched frontier expansion.

Role of the reference's per-record edge-prefix scans (reference:
core/src/dbs/processor.rs:610-701 collect_edges, sql/value/get.rs:404-446 —
hop N over R records ⇒ R separate KV range scans) re-designed TPU-first
(SURVEY §3.5): each (src_table, direction, foreign_table) pointer keyspace is
packed into CSR arrays (indptr/indices) over a node id space shared across
all mirrors of a database, so a multi-hop idiom like `->knows->person` is a
sequence of fixed-shape gather kernels with on-device dedup instead of
R₁+R₂+… pointer chases.

Maintenance is incremental: the base adjacency is built with ONE scan over
the source table's `~` keyspace (all directions/foreign-tables at once), and
every committed RELATE/DELETE applies per-edge deltas through the
transaction's graph-delta buffer (kvs/tx.py) — no corpus rescans on write
(reference analog: trees/store/cache.rs generation swap, improved). Device
arrays are recompacted lazily from the host adjacency when dirty; queries
inside a transaction that has its own uncommitted edge writes fall back to
the exact KV walk (sql/path.py graph_hop).

Mirrors surrealdb_tpu/idx/graph_csr.py; the host half is the reference's,
copied. Its device programs are hand-written CUDA kernels here
(csrc/graph.cu), each with a wrapper, a launch counter and a plain PyTorch
version in this module:

- K6 `chain_kernel` (the fused frontier chain: weighted CSR gathers,
  scatter-add dedup, ordered compaction) launches `graph_chain`, over a
  scratch kept zero between calls (`ChainScratch`);
- K7 `chain_count_batch` (B count chains over destination-sorted CSC
  adjacency) launches `graph_csc_count`;
- K8 `dense_count_batch` (B count chains through composed node-to-node
  operators, as matrix-vector passes over them and a gather-dot over the
  seeds) launches `graph_dense_count`.

A CUDA tensor goes to the kernel (or the wrapper raises); CPU tensors go to
the plain version, which the tests hold against the reference and
chip_smoke.py holds the kernels against. The device is the owning
Datastore's (`bind_ds`). Counts are exact integers everywhere; int32 sums
wrap as the reference's do.
"""

from __future__ import annotations

import ctypes
import threading
from surrealdb_tpu_torch.utils import locks as _locks
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from surrealdb_tpu_torch import key as keys
from surrealdb_tpu_torch.idx.ivf import _on_card
from surrealdb_tpu_torch.ops.distances import LaunchCounter
from surrealdb_tpu_torch.ops.scratch import ZeroKept, zero_kept
from surrealdb_tpu_torch.key.encode import prefix_end
from surrealdb_tpu_torch.sql.value import Thing
from surrealdb_tpu_torch.utils.num import next_pow2 as _next_pow2


class NodeInterner:
    """Thing ↔ dense-int mapping shared by every mirror of one (ns, db)."""

    def __init__(self):
        self.id_of: Dict[Tuple[str, str], int] = {}
        self.node_of: List[Thing] = []
        self._lock = _locks.Lock("idx.graph.interner")

    def __len__(self) -> int:
        return len(self.node_of)

    def intern(self, t: Thing) -> int:
        k = (t.tb, repr(t.id))
        i = self.id_of.get(k)
        if i is None:
            with self._lock:
                i = self.id_of.get(k)
                if i is None:
                    i = len(self.node_of)
                    self.node_of.append(t)
                    self.id_of[k] = i
        return i

    def lookup(self, t: Thing) -> Optional[int]:
        return self.id_of.get((t.tb, repr(t.id)))


class PointerCsr:
    """Adjacency for one (src_tb, direction, foreign_tb) pointer keyspace.

    Host side: `adj` dict of global-int lists — authoritative, updated by
    deltas. Device side: indptr/indices arrays compacted lazily.
    """

    def __init__(self, interner: NodeInterner):
        self.interner = interner
        self.adj: Dict[int, List[int]] = {}
        self.version = 0  # bumped on every mutation (dense-operator cache key)
        self.dirty = True
        self.indptr: Optional[np.ndarray] = None
        self.indices: Optional[np.ndarray] = None
        self._dev = None  # device (indptr, indices) cache
        self._dev_csc = None  # device (cptr, csrc) dst-sorted cache
        self.edge_count = 0
        self.n_built = 0
        self.max_degree = 0
        self._lock = _locks.Lock("idx.graph.mirror")

    def load(self, adj: Dict[int, List[int]]) -> None:
        with self._lock:
            _locks.assert_held(self._lock, "graph.adjacency")
            self.adj = adj
            self.edge_count = sum(len(v) for v in adj.values())
            self.version += 1
            self.dirty = True

    def apply(self, src: int, dst: int, add: bool) -> None:
        """Idempotent delta: pointer keys are unique in KV, so the mirror
        holds at most one (src, dst) entry per keyspace."""
        with self._lock:
            # adjacency/version/dirty are one guarded unit: a mutation
            # outside idx.graph.mirror races ensure_arrays' compaction
            _locks.assert_held(self._lock, "graph.adjacency")
            lst = self.adj.setdefault(src, [])
            if add:
                if dst not in lst:
                    lst.append(dst)
                    self.edge_count += 1
            else:
                try:
                    lst.remove(dst)
                    self.edge_count -= 1
                except ValueError:
                    pass
                if not lst:
                    del self.adj[src]
            self.version += 1
            self.dirty = True

    def ensure_arrays(self) -> None:
        """Compact host adjacency into CSR arrays (numpy only — no KV)."""
        n = len(self.interner)
        with self._lock:
            _locks.assert_held(self._lock, "graph.adjacency")
            if not self.dirty and self.n_built == n and self.indptr is not None:
                return
            # indptr spans a pow2-padded node capacity and indices a pow2
            # buffer so XLA kernel shapes stay stable while edges trickle in
            # (a recompile per RELATE would dwarf the gather itself)
            cap = _next_pow2(max(n, 1))
            indptr = np.zeros(cap + 1, dtype=np.int32)
            for src, lst in self.adj.items():
                if src < n:
                    indptr[src + 1] = len(lst)
            self.max_degree = int(indptr.max()) if n else 0
            np.cumsum(indptr, out=indptr)
            indices = np.zeros(_next_pow2(max(int(indptr[-1]), 1)), dtype=np.int32)
            fill = indptr[:-1].copy()
            for src, lst in self.adj.items():
                if src >= n:
                    continue
                k = fill[src]
                indices[k : k + len(lst)] = lst
            self.indptr = indptr
            self.indices = indices
            self._dev = None
            self._dev_csc = None
            self.n_built = n
            self.dirty = False

    def device_arrays(self, device):
        """(indptr, indices) as int32 tensors on `device`, cached until the
        next compaction."""
        self.ensure_arrays()
        if self._dev is None:
            self._dev = (
                torch.from_numpy(self.indptr).to(device),
                torch.from_numpy(self.indices).to(device),
            )
        return self._dev

    def device_csc(self, device):
        """Destination-sorted (cptr, csrc) int32 tensors on `device` for the
        batched count chains (K7): y[v] = Σ x[src] over the edges into v.
        Padding edges carry the sentinel src/dst `cap` and fall outside
        every real bin."""
        self.ensure_arrays()
        if self._dev_csc is None:
            cptr, csrc = csc_arrays(self.indptr, self.indices)
            self._dev_csc = (torch.from_numpy(cptr).to(device), torch.from_numpy(csrc).to(device))
            # K7's facts of this generation, from the host arrays
            self._dev_csc[0]._csc_facts = _csc_facts(cptr, len(csrc), device)
        return self._dev_csc


def csc_arrays(indptr: np.ndarray, indices: np.ndarray):
    """(cptr [cap+1], csrc [E]) int32 of a pow2-padded CSR: the edges sorted
    by destination (stably), each carrying its source; padding edges carry
    the sentinel `cap` as source and destination."""
    cap = len(indptr) - 1
    nnz = int(indptr[-1])
    E = len(indices)
    esrc = np.full(E, cap, dtype=np.int32)
    esrc[:nnz] = np.repeat(np.arange(cap, dtype=np.int32), np.diff(indptr))
    edst = indices.astype(np.int64, copy=True)
    edst[nnz:] = cap
    order = np.argsort(edst, kind="stable")
    csrc = esrc[order]
    counts = np.bincount(edst, minlength=cap + 1)
    cptr = np.zeros(cap + 2, dtype=np.int32)
    np.cumsum(counts, out=cptr[1:])
    return np.ascontiguousarray(cptr[: cap + 1]), csrc


def _csc_facts(cptr: np.ndarray, n_edges: int, device):
    """K7's facts of one CSC mirror, taken once a mirror generation: (each
    edge's destination [E] int32 on `device`, cap where it has none, or
    None where the clamped pointers fall somewhere; True where they rise by
    at most one a node, so every destination has at most one source)."""
    c = np.clip(np.asarray(cptr, dtype=np.int64), 0, n_edges)
    steps = np.diff(c)
    if steps.size and steps.min() < 0:
        return None, False
    cap = len(c) - 1
    cdst = np.full(n_edges, cap, dtype=np.int32)
    cdst[c[0]:c[-1]] = np.repeat(np.arange(cap, dtype=np.int32), steps)
    return torch.from_numpy(cdst).to(device), bool(steps.size == 0 or steps.max() <= 1)


def csc_facts(cptr: torch.Tensor, csrc: torch.Tensor):
    """_csc_facts of a CSC pair, kept on its cptr tensor (PointerCsr.device_csc
    sets them from the host arrays; a pair made elsewhere is read to the
    host once)."""
    facts = getattr(cptr, "_csc_facts", None)
    if facts is None:
        facts = _csc_facts(cptr.cpu().numpy(), int(csrc.shape[0]), cptr.device)
        cptr._csc_facts = facts
    return facts


# ------------------------------------------------------------------ kernels
CHAIN = LaunchCounter("graph_chain")  # K6
CSC_COUNT = LaunchCounter("graph_csc_count")  # K7
DENSE_COUNT = LaunchCounter("graph_dense_count")  # K8
KERNELS = (CHAIN, CSC_COUNT, DENSE_COUNT)


def _dense_shape_key(lanes: int, fsz: int, n0: int, As) -> tuple:
    """Launch-shape key of the dense count kernel: lane count, frontier
    pad, source space + each operator's padded dims."""
    return (lanes, fsz, n0, tuple(tuple(int(d) for d in a.shape) for a in As))


def _csc_shape_key(lanes: int, fsz: int, n_cap: int, csc_hops, last_hop) -> tuple:
    """Launch-shape key of the batched CSC count kernel: per-hop array
    paddings decide the launch shape."""
    return (
        lanes, fsz, n_cap,
        tuple(int(a.shape[0]) for hop in csc_hops for pair in hop for a in pair),
        tuple(int(p.shape[0]) for (p,) in last_hop),
    )


def _wrap32(t: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around (the reference's
    int32 arithmetic; sums and products agree modulo 2^32)."""
    return ((t + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _degree_sum(ptr, fr, w):
    """Σ over the last axis of [fr < n and w > 0] * deg(clip(fr)) * w, int64."""
    n = ptr.shape[0] - 1
    fr_c = fr.long().clamp(0, max(n - 1, 0))
    deg = ptr[fr_c + 1].long() - ptr[fr_c].long()
    valid = (fr < n) & (w > 0)
    return torch.where(valid, deg * w.long(), torch.zeros_like(deg)).sum(-1)


# ------------------------------------------------------------ plain versions
def _gather_hop(ptr, idx, frontier, weights, md):
    # one weighted CSR gather: frontier [F] ints with multiplicities →
    # neighbor slots [F*md] + per-slot weight (0 = padding). Carrying a
    # count per node instead of a bare frontier makes the hop an SpMV
    # over the adjacency, which preserves the reference's flatten-
    # without-dedup result multiplicity (sql/value/get.rs:404-446)
    # while still deduplicating the *frontier* between hops.
    n = ptr.shape[0] - 1
    fr = frontier.long().clamp(0, max(n - 1, 0))
    s = ptr[fr].long()
    deg = ptr[fr + 1].long() - s
    offs = torch.arange(md, device=ptr.device)[None, :]
    take = (s[:, None] + offs).clamp(0, idx.shape[0] - 1)
    valid = (offs < deg[:, None]) & (weights > 0)[:, None] & (frontier < n)[:, None]
    w = torch.where(valid, weights[:, None].long(), 0)
    return idx[take].reshape(-1), w.reshape(-1)


def _accum_cap(nodes, w, n_nodes, out_size):
    # dense scatter-add dedup: per-node path counts survive the frontier
    # compaction (capped, static output size, ascending node order)
    safe = torch.where(w > 0, nodes.long().clamp(0, n_nodes), n_nodes)
    dense = torch.zeros(n_nodes + 1, dtype=torch.int64, device=w.device)
    dense = _wrap32(dense.scatter_add_(0, safe, w))
    dense[n_nodes] = 0
    present = torch.nonzero(dense > 0).flatten()[:out_size]
    fill = torch.full((out_size - present.shape[0],), n_nodes, dtype=present.dtype,
                      device=present.device)
    present = torch.cat([present, fill])
    counts = torch.where(present < n_nodes, dense[present], 0)
    return present.to(torch.int32), counts.to(torch.int32)


def chain_plain(hops, frontier, weights, mds, n_cap, out_sizes, count_only):
    """Plain K6, the reference's chain_impl: per hop a weighted gather of
    every mirror, then the dense dedup; a count-only chain's last hop is the
    weighted degree reduction (an int32 scalar)."""
    frj, cwj = frontier, weights
    last = len(hops) - 1
    for h, mirrors in enumerate(hops):
        if h == last and count_only:
            # the final hop of a count never materializes neighbors:
            # paths through node v multiply by deg(v), so the count is
            # one weighted degree reduction
            total = sum(_degree_sum(ptr, frj, cwj) for ptr, _idx in mirrors)
            return _wrap32(torch.as_tensor(total, device=frj.device))
        pieces, ws = [], []
        for (ptr, idx), md in zip(mirrors, mds[h]):
            nodes, w = _gather_hop(ptr, idx, frj, cwj, md)
            pieces.append(nodes)
            ws.append(w)
        frj, cwj = _accum_cap(torch.cat(pieces), torch.cat(ws), n_cap, out_sizes[h])
    return frj, cwj


def chain_count_batch_plain(csc_hops, last_hop, frontiers, weights, n_cap):
    """Plain K7, the reference's chain_count_batch in its cumsum form:
    densify the seeds into [B, n_cap+1], then per CSC hop gather the counts
    at the edges' sources (past the width, the last column), prefix-sum,
    difference at the bins' bounds; then the degree dot over the last hop.
    int32 [B]."""
    B = frontiers.shape[0]
    dev = frontiers.device
    if not csc_hops and not last_hop:
        return torch.zeros(B, dtype=torch.int32, device=dev)
    if not csc_hops:
        # 1-hop count: weighted degree over the compact seed frontier
        return _wrap32(sum(_degree_sum(ptr, frontiers, weights) for (ptr,) in last_hop))
    safe = torch.where(weights > 0, frontiers.long().clamp(0, n_cap), n_cap)
    x = torch.zeros((B, n_cap + 1), dtype=torch.int64, device=dev)
    x.scatter_add_(1, safe, weights.long())
    zcol = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    for mirrors in csc_hops:
        if n_cap < x.shape[1]:
            x[:, n_cap] = 0
        y = None
        for cptr, csrc in mirrors:
            vals = x[:, csrc.long().clamp(max=x.shape[1] - 1)]  # sentinel src reads a zero column
            s = torch.cat([zcol, torch.cumsum(vals, dim=1)], dim=1)
            c = cptr.long().clamp(0, s.shape[1] - 1)
            d = s[:, c[1:]] - s[:, c[:-1]]
            y = d if y is None else y + d
        x = torch.cat([_wrap32(y).long(), zcol], dim=1)
    xr = x[:, :n_cap]
    total = torch.zeros(B, dtype=torch.int64, device=dev)
    for (ptr,) in last_hop:
        deg = ptr[1 : n_cap + 1].long() - ptr[:n_cap].long()
        total = total + (xr * deg[None, :]).sum(dim=1)
    return _wrap32(total)


def dense_count_batch_plain(As, outdeg, frontiers, weights, n0):
    """Plain K8, the reference's dense_count_batch: densify the seeds into
    [B, n0] f32, multiply by each operator read into f32, dot with outdeg.
    f32 [B], integer-valued (exact while the counts stay below 2^24)."""
    B = frontiers.shape[0]
    safe = torch.where(weights > 0, frontiers.long().clamp(0, n0), n0)
    x = torch.zeros((B, n0 + 1), dtype=torch.float32, device=frontiers.device)
    x = x.scatter_add_(1, safe, weights.float())[:, :n0]
    for A in As:
        x = x @ A.float()
    return (x * outdeg[None, :]).sum(dim=1)


# ------------------------------------------------------------ CUDA kernels
def _ptrs(ts):
    return (ctypes.c_void_p * max(len(ts), 1))(*[t.data_ptr() for t in ts])


def _ints(vals, ctype=ctypes.c_int):
    return (ctype * max(len(vals), 1))(*[int(v) for v in vals])


def _check_i32(t, what, dim=1):
    if t.dtype != torch.int32 or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dim}-d int32 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None


def _launch_dense_count(lib, As, outdeg, frontiers, weights, n0):
    """graph_dense_count's argument checks and launch (K8) through `lib`,
    the kernel library (the tests pass the CPU-emulated one)."""
    from surrealdb_tpu_torch.ops import _cuda

    _check_i32(frontiers, "frontiers", 2)
    _check_i32(weights, "weights", 2)
    if weights.shape != frontiers.shape:
        raise ValueError("frontiers and weights must have one shape")
    dims = [int(n0)]
    for A in As:
        if A.dtype != torch.bfloat16 or A.dim() != 2 or not A.is_contiguous():
            raise ValueError("each operator must be a contiguous 2-d bfloat16 tensor")
        if A.shape[0] != dims[-1] or A.shape[1] % 8 or A.data_ptr() % 16:
            raise ValueError(f"operator {tuple(A.shape)} does not follow width {dims[-1]} "
                             "or its rows are not 16-byte aligned")
        dims.append(int(A.shape[1]))
    if outdeg.dtype != torch.float32 or outdeg.shape != (dims[-1],) or not outdeg.is_contiguous():
        raise ValueError(f"outdeg must be a contiguous float32 [{dims[-1]}] tensor")
    B, fsz = frontiers.shape
    dev = frontiers.device
    # u_i = A_i u_{i+1} from the last operator back, in the two buffers in turn
    xa = torch.empty(max(dims) if As else 1, dtype=torch.float32, device=dev)
    xb = torch.empty(max(dims) if len(As) > 1 else 1, dtype=torch.float32, device=dev)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    status = lib.graph_dense_count(
        _ptrs(As), _ints(dims), len(As), outdeg.data_ptr(), frontiers.data_ptr(),
        weights.data_ptr(), B, fsz, xa.data_ptr(), xb.data_ptr(), out.data_ptr(), _stream(dev),
    )
    _cuda.check(status, "graph_dense_count")
    return out


def _launch_csc_count(lib, csc_hops, last_hop, frontiers, weights, n_cap):
    """graph_csc_count's argument checks and launch (K7) through `lib`.
    Shapes the reference cannot combine (mirrors of one hop with different caps, a
    last hop narrower than n_cap) raise, as they fail there."""
    from surrealdb_tpu_torch.ops import _cuda

    _check_i32(frontiers, "frontiers", 2)
    _check_i32(weights, "weights", 2)
    if weights.shape != frontiers.shape:
        raise ValueError("frontiers and weights must have one shape")
    cptrs, csrcs, caps, per_hop = [], [], [], []
    width = n_cap + 1
    for mirrors in csc_hops:
        hop_caps = {int(cptr.shape[0]) - 1 for cptr, _ in mirrors}
        if len(hop_caps) != 1:
            raise ValueError(f"a CSC hop needs mirrors of one capacity, got {sorted(hop_caps)}")
        for cptr, csrc in mirrors:
            _check_i32(cptr, "cptr")
            _check_i32(csrc, "csrc")
            cptrs.append(cptr)
            csrcs.append(csrc)
            caps.append(int(cptr.shape[0]) - 1)
        per_hop.append(len(mirrors))
        width = caps[-1] + 1
    last_caps = []
    for (ptr,) in last_hop:
        _check_i32(ptr, "ptr")
        cap = int(ptr.shape[0]) - 1
        if csc_hops and not min(cap, n_cap) == min(cap + 1, n_cap) == min(n_cap, width):
            raise ValueError(f"last hop of capacity {cap} does not cover n_cap={n_cap} "
                             f"over a frontier of width {width}")
        last_caps.append(cap)
    B, fsz = frontiers.shape
    dev = frontiers.device
    facts = [csc_facts(cptr, csrc) for cptr, csrc in zip(cptrs, csrcs)]
    rows = max([n_cap] + caps) + 1
    words = (rows + 31) // 32
    xa = torch.empty(rows * B if csc_hops else 1, dtype=torch.int32, device=dev)
    xb = torch.empty(rows * B if csc_hops else 1, dtype=torch.int32, device=dev)
    bits = torch.empty((len(per_hop) + 1) * words if csc_hops else 1, dtype=torch.int32,
                       device=dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    status = lib.graph_csc_count(
        _ptrs(cptrs), _ptrs(csrcs),
        (ctypes.c_void_p * max(len(facts), 1))(*[None if d is None else d.data_ptr()
                                                 for d, _ in facts]),
        _ints([single for _, single in facts]), _ints(caps),
        _ints([c.shape[0] for c in csrcs], ctypes.c_longlong), _ints(per_hop), len(per_hop),
        _ptrs([p for (p,) in last_hop]), _ints(last_caps), len(last_caps), frontiers.data_ptr(),
        weights.data_ptr(), B, fsz, n_cap, xa.data_ptr(), xb.data_ptr(), bits.data_ptr(), words,
        out.data_ptr(), _stream(dev),
    )
    _cuda.check(status, "graph_csc_count")
    return out


class ChainScratch(ZeroKept):
    """K6's scratch on one (device, stream, n_cap) (ops/scratch.py): the
    touched-node bitmap, the count array (32 counts a bitmap word: n_cap + 1
    and the tail of the last words) and the compaction's look-back state,
    all zero between calls (the kernels leave them so), and the buffer the
    intermediate hops' outputs take."""

    def __init__(self, lib, n_cap: int, device):
        super().__init__()
        words = int(lib.graph_chain_bitmap_words(n_cap))
        self.bits = torch.zeros(words, dtype=torch.int32, device=device)
        self.cnt = torch.zeros(32 * words, dtype=torch.int32, device=device)
        self.state = torch.zeros(int(lib.graph_chain_state_entries(n_cap)), dtype=torch.int64,
                                 device=device)
        self.inter = torch.empty(0, dtype=torch.int32, device=device)

    def intermediate(self, n: int) -> torch.Tensor:
        """n int32 of the hop-output buffer (reused in stream order)."""
        if self.inter.numel() < n:
            self.inter = torch.empty(n, dtype=torch.int32, device=self.cnt.device)
        return self.inter[:n]


def chain_scratch(lib, device, n_cap: int, stream=None) -> ChainScratch:
    """The cached ChainScratch of (device, its current stream, n_cap)."""
    return zero_kept(ChainScratch, lib, device, n_cap, stream or _stream(device))


def _launch_chain(lib, hops, frontier, weights, mds, n_cap, out_sizes, count_only,
                  scratch: Optional[ChainScratch] = None):
    """graph_chain's argument checks and launch (K6) through `lib`, over
    `scratch` (default: the cached one of the frontier's device, stream and
    n_cap). A mirror with no max degree or index array fails in the call,
    after the hop's earlier launches: the scratch is then marked dirty."""
    from surrealdb_tpu_torch.ops import _cuda

    _check_i32(frontier, "frontier")
    _check_i32(weights, "weights")
    if weights.shape != frontier.shape or not hops:
        raise ValueError("frontier and weights must have one shape, and a chain one hop")
    ptrs, idxs, caps, flat_mds, per_hop = [], [], [], [], []
    for h, mirrors in enumerate(hops):
        if len(mirrors) != len(mds[h]) or not mirrors:
            raise ValueError(f"hop {h}: {len(mirrors)} mirrors, {len(mds[h])} max degrees")
        for (ptr, idx), md in zip(mirrors, mds[h]):
            _check_i32(ptr, "indptr")
            _check_i32(idx, "indices")
            ptrs.append(ptr)
            idxs.append(idx)
            caps.append(int(ptr.shape[0]) - 1)
            flat_mds.append(int(md))
        per_hop.append(len(mirrors))
    dev = frontier.device
    stream = _stream(dev)
    kept = len(hops) - 1 if count_only else len(hops)
    sizes = [int(out_sizes[h]) for h in range(kept)]
    if scratch is None:
        scratch = chain_scratch(lib, dev, n_cap, stream)
    # the one allocation a call: what it returns
    out = torch.empty(1 if count_only else 2 * sizes[-1], dtype=torch.int32, device=dev)
    inner = sizes if count_only else sizes[:-1]
    presents, counts = [], []

    def launch(clear):
        buf = scratch.intermediate(2 * sum(inner))
        at = 0
        for n in inner:
            presents.append(buf[at:at + n])
            counts.append(buf[at + n:at + 2 * n])
            at += 2 * n
        if not count_only:
            presents.append(out[:sizes[-1]])
            counts.append(out[sizes[-1]:])
        return lib.graph_chain(
            _ptrs(ptrs), _ints(caps), _ptrs(idxs),
            _ints([i.shape[0] for i in idxs], ctypes.c_longlong), _ints(flat_mds),
            _ints(per_hop), len(hops), _ints(sizes), frontier.data_ptr(), weights.data_ptr(),
            frontier.shape[0], n_cap, int(count_only), scratch.cnt.data_ptr(),
            scratch.bits.data_ptr(), scratch.state.data_ptr(), clear,
            _ptrs(presents), _ptrs(counts), out.data_ptr(), stream,
        )

    status = scratch.run(launch)
    _cuda.check(status, "graph_chain", lib)
    if count_only:
        return out[0]
    return presents[-1], counts[-1]


def _all_tensors(hops):
    return [a for mirrors in hops for pair in mirrors for a in pair]


def chain_kernel(hops, frontier, weights, mds, n_cap, out_sizes, count_only):
    """Full multi-hop chain in one call (K6). hops: tuple (one per hop) of
    tuples of (indptr, indices) int32 tensors (one per contributing mirror);
    mds/out_sizes: matching pow2 paddings. count_only skips the final
    compaction and returns the int32 path count; else (nodes, counts)
    [out_sizes[-1]] int32, ascending node order, padded with (n_cap, 0)."""
    if not _on_card(frontier, weights, *_all_tensors(hops)):
        return chain_plain(hops, frontier, weights, mds, n_cap, out_sizes, count_only)
    from surrealdb_tpu_torch.ops import _cuda

    with torch.cuda.device(frontier.device):
        out = _launch_chain(_cuda.lib(), hops, frontier, weights, mds, n_cap, out_sizes,
                            count_only)
    CHAIN.bump()
    return out


def chain_count_batch(csc_hops, last_hop, frontiers, weights, n_cap):
    """Batched count-only chains for B concurrent queries over the SAME
    adjacency (K7, the cross-query coalescing seam, dbs/dispatch.py).
    csc_hops: tuple per non-final hop of ((cptr, csrc), ...); last_hop:
    ((ptr,), ...); frontiers/weights [B, fsz] int32 -> [B] int32."""
    tensors = [frontiers, weights, *_all_tensors(csc_hops), *[p for (p,) in last_hop]]
    if not _on_card(*tensors):
        return chain_count_batch_plain(csc_hops, last_hop, frontiers, weights, n_cap)
    from surrealdb_tpu_torch.ops import _cuda

    with torch.cuda.device(frontiers.device):
        out = _launch_csc_count(_cuda.lib(), csc_hops, last_hop, frontiers, weights, n_cap)
    CSC_COUNT.bump()
    return out


def dense_count_batch(As, outdeg, frontiers, weights, n0):
    """Batched count chains as products with composed node-to-node
    operators (K8): each logical `->edge->node` pair is pre-composed into a
    dense adjacency (bf16, exact for multiplicities < 256), so B concurrent
    counts are ((x_b A_0 ... A_{m-1}) * outdeg).sum() in one call. The
    kernel regroups it as x_b . (A_0 (... (A_{m-1} outdeg))): m
    matrix-vector passes whatever B (a 3-hop count: two over [n, n]), then
    a gather-dot over each lane's seeds; exact under the caller's 2^24
    guard. Seeds arrive as compact LOCAL ids. -> [B] f32."""
    if not _on_card(outdeg, frontiers, weights, *As):
        return dense_count_batch_plain(As, outdeg, frontiers, weights, n0)
    from surrealdb_tpu_torch.ops import _cuda

    with torch.cuda.device(frontiers.device):
        out = _launch_dense_count(_cuda.lib(), As, outdeg, frontiers, weights, n0)
    DENSE_COUNT.bump()
    return out


class GraphMirrors:
    """Per-datastore registry: (ns, db, src_tb, dir, ft) → PointerCsr, with a
    shared NodeInterner per (ns, db) so hops compose across tables."""

    def __init__(self):
        self._interners: Dict[Tuple[str, str], NodeInterner] = {}
        self._m: Dict[tuple, PointerCsr] = {}
        self._built: Set[Tuple[str, str, str]] = set()
        # dense composed operators + per-table compact id spaces
        self._spaces: Dict[tuple, dict] = {}  # (ns,db,tb) -> space dict
        self._dense: Dict[tuple, dict] = {}  # pair key -> operator dict
        # tables mid-build: deltas committed during the build scan are
        # buffered here and replayed after load (closes the scan→built gap)
        self._building: Dict[Tuple[str, str, str], List[tuple]] = {}
        self._build_locks: Dict[Tuple[str, str, str], threading.Lock] = {}
        self._lock = _locks.RLock("idx.graph.registry")
        # ingest-time prewarm (cnf.GRAPH_PREWARM): RELATE commits into a
        # not-yet-mirrored table arm a debounced timer; when ingest
        # quiesces, the mirror build + batched-count-kernel compiles run in
        # the background so the FIRST query doesn't pay the multi-second
        # (at scale, multi-minute) build + XLA-compile cliff
        self._ds = None  # weakref to the owning Datastore (set by bind_ds)
        self._prewarm_timers: Dict[Tuple[str, str, str], threading.Timer] = {}
        self._prewarm_deadline: Dict[Tuple[str, str, str], float] = {}
        self._prewarm_running: Set[Tuple[str, str, str]] = set()
        self._warmed_pairs: Set[tuple] = set()
        # flight-recorder task ids of armed prewarms (bg.py lifecycle)
        self._task_ids: Dict[Tuple[str, str, str], int] = {}
        self._owner = None  # id(ds), for bg teardown scoping
        self.device = None  # where the device arrays live (the Datastore's)

    # ------------------------------------------------------------ plumbing
    def bind_ds(self, ds) -> None:
        """Bind the owning Datastore (weakly): prewarm builds open their own
        read transactions, which needs more than the commit-path hook has."""
        import weakref

        self._ds = weakref.ref(ds)
        self._owner = id(ds)
        self.device = ds.device

    def _device(self):
        if self.device is None:
            raise RuntimeError("GraphMirrors has no device: bind a Datastore first")
        return self.device

    def interner(self, ns: str, db: str) -> NodeInterner:
        with self._lock:
            it = self._interners.get((ns, db))
            if it is None:
                it = NodeInterner()
                self._interners[(ns, db)] = it
            return it

    def _get_or_create(self, ns, db, src_tb, d: bytes, ft: str) -> PointerCsr:
        k = (ns, db, src_tb, bytes(d), ft)
        with self._lock:
            m = self._m.get(k)
            if m is None:
                m = PointerCsr(self.interner(ns, db))
                self._m[k] = m
            return m

    def get(self, ns, db, src_tb, d: bytes, ft: str) -> Optional[PointerCsr]:
        return self._m.get((ns, db, src_tb, bytes(d), ft))

    def table_built(self, ns: str, db: str, src_tb: str) -> bool:
        return (ns, db, src_tb) in self._built

    def drop_table(self, ns: str, db: str, tb: str) -> None:
        """Forget a table's mirrors (REMOVE TABLE / bulk invalidation)."""
        with self._lock:
            self._built.discard((ns, db, tb))
            self._building.pop((ns, db, tb), None)
            for k in [k for k in self._m if k[:3] == (ns, db, tb)]:
                del self._m[k]

    def drop_db(self, ns: str, db: str) -> None:
        """Forget everything of one database (REMOVE DATABASE)."""
        with self._lock:
            self._built = {k for k in self._built if k[:2] != (ns, db)}
            self._building = {k: v for k, v in self._building.items() if k[:2] != (ns, db)}
            for k in [k for k in self._m if k[:2] == (ns, db)]:
                del self._m[k]
            self._interners.pop((ns, db), None)

    def drop_ns(self, ns: str) -> None:
        """Forget everything of one namespace (REMOVE NAMESPACE)."""
        with self._lock:
            self._built = {k for k in self._built if k[0] != ns}
            self._building = {k: v for k, v in self._building.items() if k[0] != ns}
            for k in [k for k in self._m if k[0] == ns]:
                del self._m[k]
            for k in [k for k in self._interners if k[0] == ns]:
                del self._interners[k]

    def clear(self) -> None:
        with self._lock:
            self._m.clear()
            self._built.clear()
            self._building.clear()
            self._interners.clear()

    # ------------------------------------------------------------ build
    def ensure_table(self, ctx, src_tb: str) -> None:
        """Build every (dir, ft) mirror of `src_tb` with ONE scan over its
        `~` pointer keyspace. The scan runs on a FRESH snapshot opened after
        delta-buffering starts, so (a) deltas committed concurrently with
        the scan are buffered and replayed afterwards (apply is idempotent)
        and no committed edge can fall between the scan and the built flag,
        and (b) the querying transaction's own uncommitted writes never
        leak into the shared mirror (they force the exact KV walk anyway)."""
        ns, db = ctx.ns_db()
        self.build_table(ctx.ds(), ns, db, src_tb)

    def build_table(self, ds, ns: str, db: str, src_tb: str) -> None:
        """ensure_table's engine: also callable from the background prewarm
        thread, which has a Datastore but no request context."""
        key3 = (ns, db, src_tb)
        with self._lock:
            if key3 in self._built:
                return
            bl = self._build_locks.setdefault(key3, _locks.Lock("idx.graph.build"))
        with bl:
            with self._lock:
                if key3 in self._built:
                    return
                self._building[key3] = []
            it = self.interner(ns, db)
            adjs: Dict[Tuple[bytes, str], Dict[int, List[int]]] = {}
            pre = keys.graph_prefix(ns, db, src_tb)
            txn = ds.transaction(False)
            try:
                for chunk in txn.batch(pre, prefix_end(pre), 4096):
                    for k, _ in chunk:
                        id_, d, ft, fk = keys.decode_graph(k, ns, db, src_tb)
                        if not isinstance(fk, Thing):
                            continue
                        s = it.intern(Thing(src_tb, id_))
                        t = it.intern(fk)
                        adjs.setdefault((bytes(d), ft), {}).setdefault(s, []).append(t)
            finally:
                txn.cancel()
            with self._lock:
                for (d, ft), adj in adjs.items():
                    self._get_or_create(ns, db, src_tb, d, ft).load(adj)
                pending = self._building.pop(key3, [])
                for delta in pending:
                    self._apply_one(delta)
                self._built.add(key3)

    # ------------------------------------------------------------ deltas
    def _apply_one(self, delta: tuple) -> None:
        ns, db, src_tb, d, ft, src, dst, add = delta
        it = self.interner(ns, db)
        m = self._get_or_create(ns, db, src_tb, d, ft)
        m.apply(it.intern(src), it.intern(dst), add)

    def apply_deltas(self, deltas: Sequence[tuple]) -> None:
        """Apply committed edge-pointer deltas to built (or mid-build)
        tables. Each delta: (ns, db, src_tb, dir, ft, src, dst, add).
        Unbuilt tables ignore deltas — their eventual build scan sees the
        committed KV state anyway — but each such commit (re-)arms the
        debounced prewarm so the build + kernel compiles happen in the
        ingest→first-query gap instead of inside the first query.
        """
        unbuilt: Set[Tuple[str, str, str]] = set()
        for delta in deltas:
            key3 = tuple(delta[:3])
            with self._lock:
                if key3 in self._building:
                    self._building[key3].append(delta)
                    continue
                if key3 not in self._built:
                    unbuilt.add(key3)
                    continue
                self._apply_one(delta)
        if unbuilt:
            self._schedule_prewarm(unbuilt)

    # ------------------------------------------------------------ prewarm
    def _arm_timer(self, key3: Tuple[str, str, str], delay: float) -> None:
        """Start one self-identifying timer for key3 (caller holds _lock)."""
        from surrealdb_tpu_torch import bg

        timer = bg.timer(
            delay, self._prewarm, key3, None,
            task_id=self._task_ids.get(key3),
            name=f"bg:graph_prewarm:{key3[2]}", start=False,
        )
        timer.args = (key3, timer)  # the callback must recognise itself
        self._prewarm_timers[key3] = timer
        timer.start()

    def _schedule_prewarm(self, keys3: Set[Tuple[str, str, str]]) -> None:
        """Debounce by DEADLINE, not by timer churn: each commit just moves
        the key's deadline forward; at most ONE live timer exists per key
        (it re-arms itself if it wakes early), so a million single-edge
        commits cost a million dict writes, not a million thread spawns."""
        import time as _time

        from surrealdb_tpu_torch import cnf

        from surrealdb_tpu_torch import bg

        if not cnf.GRAPH_PREWARM or self._ds is None:
            return
        delay = cnf.GRAPH_PREWARM_DELAY_SECS
        now = _time.monotonic()
        with self._lock:
            for key3 in keys3:
                self._prewarm_deadline[key3] = now + delay
                if key3 not in self._prewarm_timers:
                    # flight-recorder record: scheduled now, running when
                    # ingest quiesces and the build + kernel compiles start
                    self._task_ids[key3] = bg.register(
                        "graph_prewarm", target=".".join(key3), owner=self._owner
                    )
                    self._arm_timer(key3, delay)
                else:
                    tid = self._task_ids.get(key3)
                    if tid is not None:
                        bg.touch(tid)

    def _prewarm(self, key3: Tuple[str, str, str], timer) -> None:
        """Timer body (background thread): build the table's mirrors, then
        compile the batched count kernels its chains will hit. Best-effort —
        any failure leaves the lazy first-query path fully intact."""
        import time as _time

        from surrealdb_tpu_torch import telemetry

        ns, db, tb = key3
        with self._lock:
            if self._prewarm_timers.get(key3) is not timer:
                return  # superseded — the newer timer owns this key
            remaining = self._prewarm_deadline.get(key3, 0.0) - _time.monotonic()
            if remaining > 0.001:
                # woke before the (commit-advanced) deadline: re-arm
                self._arm_timer(key3, remaining)
                return
            del self._prewarm_timers[key3]
            self._prewarm_deadline.pop(key3, None)
            self._prewarm_running.add(key3)
            task_id = self._task_ids.pop(key3, None)
        from surrealdb_tpu_torch import bg

        if task_id is None:
            task_id = bg.register(
                "graph_prewarm", target=".".join(key3), owner=self._owner,
                trace_id=None,
            )
        try:
            with bg.run(task_id):
                ds = self._ds() if self._ds is not None else None
                if ds is None:
                    return
                telemetry.inc("graph_prewarm", stage="build")
                self.build_table(ds, ns, db, tb)
                self.warm_count_kernels(ns, db)
        except Exception:
            # the bg task record carries the error detail; the counter makes
            # a string of failed prewarms visible on /metrics
            telemetry.inc("prewarm_errors", subsystem="graph")
        finally:
            with self._lock:
                self._prewarm_running.discard(key3)

    def wait_prewarm(self, timeout: float = 30.0) -> bool:
        """Block until no prewarm timer or build is pending (test/bench
        determinism helper, never used on the query path)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            with self._lock:
                if not self._prewarm_timers and not self._prewarm_running:
                    return True
            _time.sleep(0.01)
        return False

    def shutdown(self, timeout: float = 10.0) -> None:
        """Teardown on Datastore.close(): cancel armed prewarm timers
        (resolving their flight-recorder records) and wait out in-flight
        builds, so no prewarm thread outlives its datastore."""
        from surrealdb_tpu_torch import bg

        with self._lock:
            timers = list(self._prewarm_timers.values())
            self._prewarm_timers.clear()
            self._prewarm_deadline.clear()
            task_ids = list(self._task_ids.values())
            self._task_ids.clear()
        for t in timers:
            t.cancel()
        for tid in task_ids:
            bg.cancel(tid, "cancelled: datastore closed")
        self.wait_prewarm(timeout)

    def warm_count_kernels(self, ns: str, db: str) -> None:
        """Compile the batched count kernels for every composable
        `->edge->node` OUT-pair over built mirrors, at the lane counts and
        frontier pad the serving runners use — so a post-ingest burst of
        count-chain queries starts on pre-compiled shapes (the r6 scale-1.0
        log showed 84.8s/26.4s first-query stalls that were exactly these
        compiles). Results are discarded; zero-weight lanes are harmless."""
        from surrealdb_tpu_torch import cnf, telemetry

        if cnf.TPU_DISABLE:
            return
        dev = self._device()
        with self._lock:
            mkeys = [k for k in self._m if k[0] == ns and k[1] == db]
        pairs = [
            (tb, ft, ft2)
            for (_, _, tb, d, ft) in mkeys
            if d == keys.DIR_OUT
            for (_, _, tb2, d2, ft2) in mkeys
            if tb2 == ft and d2 == keys.DIR_OUT
        ]
        fsz = _next_pow2(max(1, cnf.TPU_GRAPH_FRONTIER_PAD))
        # every lane count the serving runners can pad to: bp =
        # max(_next_pow2(B), LANES) with B capped by the dispatcher width,
        # so the shape set is {LANES, ..., pow2(DISPATCH_MAX_WIDTH)}
        lane_set = []
        b = max(cnf.TPU_GRAPH_BATCH_LANES, 1)
        top = max(_next_pow2(cnf.DISPATCH_MAX_WIDTH), b)
        while b <= top:
            lane_set.append(b)
            b *= 2
        for tb, et, dt_ in pairs:
            pkey = (ns, db, tb, et, dt_)
            with self._lock:
                if pkey in self._warmed_pairs:
                    continue
                self._warmed_pairs.add(pkey)
            spec1 = ([tb], [keys.DIR_OUT], [et])
            spec2 = ([et], [keys.DIR_OUT], [dt_])
            # chains self-compose only when the pair loops back to its
            # source table (person->knows->person); otherwise warm 1 pair
            max_pairs = 3 if dt_ == tb else 1
            telemetry.inc("graph_prewarm", stage="kernels")
            try:
                op = self._dense_pair(ns, db, spec1, spec2)
            except Exception:
                op = None
            if op is not None:
                from surrealdb_tpu_torch import compile_log

                n0 = op["ns_pad"]
                for lanes in lane_set:
                    frs = torch.full((lanes, fsz), n0, dtype=torch.int32, device=dev)
                    cws = torch.zeros((lanes, fsz), dtype=torch.int32, device=dev)
                    for c in range(1, max_pairs + 1):
                        try:
                            As = (op["A"],) * (c - 1)
                            with compile_log.tracked(
                                "graph_dense",
                                _dense_shape_key(lanes, fsz, n0, As),
                                prewarmed=True,
                            ):
                                dense_count_batch(As, op["outdeg"], frs, cws, n0=n0)
                        except Exception:
                            telemetry.inc(
                                "prewarm_errors", subsystem="graph_count"
                            )
                continue
            # dense doesn't fit (oversized tables / fat multiplicities):
            # warm the CSC form the serving path will use instead
            try:
                m1 = self._hop_mirrors(ns, db, spec1)
                m2 = self._hop_mirrors(ns, db, spec2)
                if len(m1) != 1 or len(m2) != 1:
                    continue
                n_cap = _next_pow2(len(self.interner(ns, db)))
                csc1, csc2 = m1[0].device_csc(dev), m2[0].device_csc(dev)
                ptr2 = m2[0].device_arrays(dev)[0]
                from surrealdb_tpu_torch import compile_log

                for lanes in lane_set:
                    frs = torch.full((lanes, fsz), n_cap, dtype=torch.int32, device=dev)
                    cws = torch.zeros((lanes, fsz), dtype=torch.int32, device=dev)
                    for hops in range(1, max_pairs + 1):
                        # `->et->tb` repeated `hops` times = 2*hops specs;
                        # the final spec is a degree reduction (no CSC)
                        csc_hops = tuple(
                            ((csc1,) if i % 2 == 0 else (csc2,))
                            for i in range(2 * hops - 1)
                        )
                        with compile_log.tracked(
                            "graph_csc",
                            _csc_shape_key(lanes, fsz, n_cap, csc_hops, ((ptr2,),)),
                            prewarmed=True,
                        ):
                            chain_count_batch(csc_hops, ((ptr2,),), frs, cws, n_cap=n_cap)
            except Exception:
                telemetry.inc("prewarm_errors", subsystem="graph_count")

    # ------------------------------------------------------------ traversal
    def _hop_mirrors(self, ns, db, spec) -> List[PointerCsr]:
        srcs, dirs, fts = spec
        out = []
        for tb in srcs:
            for d in dirs:
                for ft in fts:
                    m = self.get(ns, db, tb, d, ft)
                    if m is not None and m.adj:
                        out.append(m)
        return out

    def _host_hop(self, ns, db, frontier: np.ndarray, counts: np.ndarray, spec):
        out: Dict[int, int] = {}
        for m in self._hop_mirrors(ns, db, spec):
            with m._lock:  # deltas may mutate adj lists concurrently
                for i, c in zip(frontier.tolist(), counts.tolist()):
                    for dst in m.adj.get(int(i), ()):
                        out[dst] = out.get(dst, 0) + c
        nodes = np.fromiter(sorted(out), dtype=np.int32, count=len(out))
        return nodes, np.array([out[int(n)] for n in nodes], dtype=np.int32)

    def _chain_work_estimate(self, ns, db, specs, counts) -> float:
        """Expected edges traversed by a count chain: Σ over hops of the
        frontier size estimate × that hop's average degree (random-graph
        expectation from mirror edge counts). Decides device routing — a
        1-seed chain over a degree-4 graph is ~40 edges of HOST work no
        matter how many total edges the graph has, while the same seed on
        a degree-100 social graph explodes past any host budget."""
        frontier_est = float(counts.sum())
        work = 0.0
        for sp in specs:
            deg = 0.0
            for m in self._hop_mirrors(ns, db, sp):
                deg += m.edge_count / max(len(m.adj), 1)
            frontier_est *= deg
            work += frontier_est
            if work >= 1e12:
                break
        return work

    # ------------------------------------------------ dense composed counts
    def table_space(self, ns: str, db: str, tb: str) -> dict:
        """Compact per-table id space over the shared interner: sorted
        global ids of `tb`'s nodes + a global->local inverse array.
        Incrementally extended as the interner grows (append-only)."""
        it = self.interner(ns, db)
        with self._lock:
            sp = self._spaces.get((ns, db, tb))
            if sp is None:
                sp = self._spaces[(ns, db, tb)] = {
                    "globals": [], "inv": {}, "scanned": 0,
                }
            n = len(it.node_of)
            if sp["scanned"] < n:
                g, inv = sp["globals"], sp["inv"]
                for i in range(sp["scanned"], n):
                    if it.node_of[i].tb == tb:
                        inv[i] = len(g)
                        g.append(i)
                sp["scanned"] = n
            return sp

    @staticmethod
    def _pad128(n: int) -> int:
        return max(((n + 127) // 128) * 128, 128)

    def _dense_pair(self, ns, db, spec1, spec2):
        """Composed dense operator for one `->edge->node` spec pair:
        A[local_src, local_dst] = number of 2-hop paths through the edge
        table (bf16 on device — exact for multiplicities < 256; falls back
        to None if anything about the pair doesn't fit the dense form)."""
        from surrealdb_tpu_torch import cnf

        srcs1, dirs1, fts1 = spec1
        srcs2, dirs2, fts2 = spec2
        if len(srcs1) != 1 or len(fts1) != 1 or len(dirs1) != 1:
            return None
        if len(fts2) != 1 or len(dirs2) != 1:
            return None
        src_tb, edge_tb, dst_tb = srcs1[0], fts1[0], fts2[0]
        m1s = self._hop_mirrors(ns, db, spec1)
        m2s = self._hop_mirrors(ns, db, spec2)
        if len(m1s) != 1 or len(m2s) != 1:
            return None
        m1, m2 = m1s[0], m2s[0]
        sp_s = self.table_space(ns, db, src_tb)
        sp_d = self.table_space(ns, db, dst_tb)
        n_s, n_d = len(sp_s["globals"]), len(sp_d["globals"])
        if not n_s or not n_d:
            return None
        if max(n_s, n_d) > cnf.TPU_GRAPH_DENSE_MAX:
            return None
        key = (ns, db, src_tb, dirs1[0], edge_tb, dirs2[0], dst_tb)
        gen = (m1.version, m2.version, n_s, n_d)
        with self._lock:
            op = self._dense.get(key)
        if op is not None and op["gen"] == gen:
            return op
        # host composition: one pass over m1's edges, mapping each middle
        # edge-record to its m2 destinations
        inv_s, inv_d = sp_s["inv"], sp_d["inv"]
        ns_pad, nd_pad = self._pad128(n_s), self._pad128(n_d)
        A = np.zeros((ns_pad + 1, nd_pad), dtype=np.float32)
        # copy both adjacencies up front: the O(paths) composition loop must
        # not hold mirror locks (it would stall every concurrent RELATE)
        with m1._lock:
            adj1 = {k: list(v) for k, v in m1.adj.items()}
        with m2._lock:
            adj2 = {k: list(v) for k, v in m2.adj.items()}
        rows_s, rows_d = [], []
        for g_src, mids in adj1.items():
            ls = inv_s.get(g_src)
            if ls is None:
                continue
            for mid in mids:
                for g_dst in adj2.get(mid, ()):
                    ld = inv_d.get(g_dst)
                    if ld is not None:
                        rows_s.append(ls)
                        rows_d.append(ld)
        if rows_s:
            np.add.at(
                A,
                (np.asarray(rows_s, np.int64), np.asarray(rows_d, np.int64)),
                1.0,
            )
        if float(A.max(initial=0.0)) >= 256.0:
            return None  # bf16 would round the multiplicity
        outdeg = A[:ns_pad].sum(axis=1).astype(np.float32)
        dev = self._device()
        op = {
            "gen": gen,
            "n_src": n_s,
            "n_dst": n_d,
            "ns_pad": ns_pad,
            "nd_pad": nd_pad,
            # integers below 256: exact in bf16
            "A": torch.from_numpy(A[:ns_pad]).to(dev).to(torch.bfloat16),
            "outdeg": torch.from_numpy(outdeg).to(dev),
            # ∞-norm of the operator: bounds count growth per hop for the
            # f32-exactness guard in _dense_chain_count
            "rowmax": float(outdeg.max(initial=0.0)),
            "space_src": sp_s,
        }
        with self._lock:
            self._dense[key] = op
        return op

    def _dense_chain_count(self, ns, db, frontier, counts, specs, dispatch):
        """Count chain as composed dense products (see dense_count_batch).
        Returns None when the chain doesn't fit the dense form (odd spec
        count, multi-table hops, oversized tables, fat multiplicities) —
        the caller then uses the CSC path."""
        from surrealdb_tpu_torch import cnf

        if len(specs) < 2 or len(specs) % 2 != 0:
            return None
        ops = []
        for i in range(0, len(specs), 2):
            op = self._dense_pair(ns, db, specs[i], specs[i + 1])
            if op is None:
                return None
            ops.append(op)
        # chain spaces must line up: pair i's dst space is pair i+1's src
        for a, b in zip(ops, ops[1:]):
            if a["nd_pad"] != b["ns_pad"] or a["n_dst"] != b["n_src"]:
                return None
        # f32 sums are exact only below 2^24: bound the worst-case count
        # (Σ seed weights × Π per-hop ∞-norms) and fall back to the exact
        # int32 CSC path when it could overflow the mantissa
        bound = float(counts.sum())
        for op in ops:
            bound *= max(op["rowmax"], 1.0)
        if bound >= float(1 << 24):
            return None
        dev = self._device()
        n0 = ops[0]["ns_pad"]
        inv0 = ops[0]["space_src"]["inv"]
        fsz = _next_pow2(max(frontier.size, cnf.TPU_GRAPH_FRONTIER_PAD))
        fr = np.full(fsz, n0, dtype=np.int32)
        cw = np.zeros(fsz, dtype=np.int32)
        j = 0
        for g, c in zip(frontier.tolist(), counts.tolist()):
            loc = inv0.get(int(g))
            if loc is not None:
                fr[j] = loc
                cw[j] = c
                j += 1
        if j == 0:
            return 0
        As = tuple(op["A"] for op in ops[:-1])
        outdeg = ops[-1]["outdeg"]
        key = (
            "gdense", fsz, n0,
            tuple(id(a) for a in As), id(outdeg),
        )

        def runner(payloads):
            from surrealdb_tpu_torch import compile_log

            B = len(payloads)
            bp = max(_next_pow2(B), cnf.TPU_GRAPH_BATCH_LANES)
            frs = np.full((bp, fsz), n0, dtype=np.int32)
            cws = np.zeros((bp, fsz), dtype=np.int32)
            for i, (f, c) in enumerate(payloads):
                frs[i] = f
                cws[i] = c
            with compile_log.tracked(
                "graph_dense", _dense_shape_key(bp, fsz, n0, As)
            ):
                out = dense_count_batch(
                    As, outdeg, torch.from_numpy(frs).to(dev),
                    torch.from_numpy(cws).to(dev), n0=n0,
                )

            def collect():
                vals = out.cpu().numpy()
                return [int(round(float(vals[i]))) for i in range(B)]

            return collect

        return dispatch.submit(key, (fr, cw), runner)

    def _device_chain(
        self, ns, db, frontier: np.ndarray, counts: np.ndarray, specs,
        count_only: bool = False, dispatch=None,
    ):
        """Run the remaining hops entirely on device in ONE fused call:
        one upload, H weighted gathers with on-device scatter-add dedup
        between hops, one download at the end (a scalar when count_only).
        Every static dimension (frontier size, max degree, node capacity,
        dedup output) is pow2-rounded so concurrent chains share shapes."""
        from surrealdb_tpu_torch import cnf

        dev = self._device()
        it = self.interner(ns, db)
        n_cap = _next_pow2(len(it))
        # floor the frontier pad: chains arriving with 90- vs 130-node
        # frontiers must share ONE launch shape to coalesce
        fsz = _next_pow2(max(frontier.size, cnf.TPU_GRAPH_FRONTIER_PAD))
        fr = np.full(fsz, n_cap, dtype=np.int32)
        fr[: frontier.size] = frontier
        cw = np.zeros(fsz, dtype=np.int32)
        cw[: counts.size] = counts

        hops, mds, out_sizes = [], [], []
        width = fsz
        for spec in specs:
            mirrors = self._hop_mirrors(ns, db, spec)
            if not mirrors:
                if count_only:
                    return 0
                e = np.empty(0, dtype=np.int32)
                return e, e
            hop_arrs, hop_mds, total = [], [], 0
            for m in mirrors:
                hop_arrs.append(m.device_arrays(dev))
                md = _next_pow2(max(m.max_degree, 1))
                hop_mds.append(md)
                total += width * md
            hops.append(tuple(hop_arrs))
            mds.append(tuple(hop_mds))
            width = _next_pow2(min(total, n_cap))
            out_sizes.append(width)
        hops, mds, out_sizes = tuple(hops), tuple(mds), tuple(out_sizes)
        if count_only and dispatch is not None:
            # coalesce concurrent count-chains with identical shape/adjacency
            # into one batched call (dbs/dispatch.py leader-follower)
            csc_hops = tuple(
                tuple(m.device_csc(dev) for m in self._hop_mirrors(ns, db, sp))
                for sp in specs[:-1]
            )
            last_hop = tuple((pair[0],) for pair in hops[-1])
            key = (
                "gchain", fsz, n_cap, len(specs),
                tuple(id(a) for hop in csc_hops for pair in hop for a in pair),
                tuple(id(p) for (p,) in last_hop),
            )

            def runner(payloads):
                from surrealdb_tpu_torch import compile_log

                B = len(payloads)
                # fixed lane count: a batch of 1 and a batch of 32 share
                # one launch shape (padding lanes carry zero weights)
                bp = max(_next_pow2(B), cnf.TPU_GRAPH_BATCH_LANES)
                frs = np.full((bp, fsz), n_cap, dtype=np.int32)
                cws = np.zeros((bp, fsz), dtype=np.int32)
                for i, (f, c) in enumerate(payloads):
                    frs[i] = f
                    cws[i] = c
                with compile_log.tracked(
                    "graph_csc", _csc_shape_key(bp, fsz, n_cap, csc_hops, last_hop)
                ):
                    out = chain_count_batch(
                        csc_hops, last_hop,
                        torch.from_numpy(frs).to(dev), torch.from_numpy(cws).to(dev),
                        n_cap=n_cap,
                    )

                def collect():
                    vals = out.cpu().numpy()
                    return [int(vals[i]) for i in range(B)]

                return collect

            return dispatch.submit(key, (fr, cw), runner)
        from surrealdb_tpu_torch import compile_log

        with compile_log.tracked(
            "graph_chain", (fsz, n_cap, mds, out_sizes, bool(count_only))
        ):
            out = chain_kernel(
                hops, torch.from_numpy(fr).to(dev), torch.from_numpy(cw).to(dev),
                mds=mds, n_cap=n_cap, out_sizes=out_sizes,
                count_only=count_only,
            )
        if count_only:
            return int(out)
        u = out[0].cpu().numpy()
        c = out[1].cpu().numpy()
        keep = c > 0
        return u[keep].astype(np.int32), c[keep].astype(np.int32)

    def _chain_frontier(self, ctx, start: List[Thing], parts: List, count_only: bool = False):
        """Shared frontier machinery for chain()/chain_count(): returns
        (frontier int32[], counts int32[], interner) — or the scalar path
        count when count_only (the device chain then downloads one int)."""
        from surrealdb_tpu_torch import cnf

        ns, db = ctx.ns_db()
        it = self.interner(ns, db)
        dir_map = {"out": [keys.DIR_OUT], "in": [keys.DIR_IN], "both": [keys.DIR_IN, keys.DIR_OUT]}
        # pre-resolve hop specs; a hop filtered on foreign-table ft lands
        # entirely in table ft, so the next hop's sources are exactly p.what
        tables = {t.tb for t in start}
        specs = []
        for p in parts:
            for tb in tables:
                self.ensure_table(ctx, tb)
            specs.append((sorted(tables), dir_map[p.dir], p.what))
            tables = set(p.what)
        cmap: Dict[int, int] = {}
        for t in start:
            i = it.lookup(t)
            if i is not None:
                cmap[i] = cmap.get(i, 0) + 1
        frontier = np.fromiter(sorted(cmap), dtype=np.int32, count=len(cmap))
        counts = np.array([cmap[int(i)] for i in frontier], dtype=np.int32)
        dispatch = getattr(ctx.ds(), "dispatch", None)
        if (
            count_only
            and not cnf.TPU_DISABLE
            and dispatch is not None
            and frontier.size
            and self._chain_work_estimate(ns, db, specs, counts)
            >= cnf.TPU_GRAPH_COUNT_EDGES
        ):
            # big count chain: straight to device from the seed — the whole
            # chain is one tiny-upload batched dispatch (no host hops means
            # no GIL serialization across concurrent clients, and every
            # query shares one compiled shape so they coalesce). Preferred
            # form: composed dense matmuls on the MXU; CSC cumsum otherwise.
            res = self._dense_chain_count(ns, db, frontier, counts, specs, dispatch)
            if res is not None:
                return res
            return self._device_chain(
                ns, db, frontier, counts, specs,
                count_only=True, dispatch=dispatch,
            )
        i = 0
        while i < len(specs):
            # a hop goes on device once the CURRENT frontier is device-sized,
            # or — for count-only chains — as soon as the NEXT frontier would
            # be: the whole remaining chain fuses into one dispatch either
            # way, and skipping the host hops keeps every concurrent query's
            # shapes identical so they coalesce into one vmapped launch
            md = max(
                (m.max_degree for m in self._hop_mirrors(ns, db, specs[i])),
                default=0,
            )
            device_now = frontier.size >= cnf.TPU_GRAPH_ONDEVICE_THRESHOLD or (
                count_only
                and frontier.size * md >= cnf.TPU_GRAPH_ONDEVICE_THRESHOLD
            )
            if not cnf.TPU_DISABLE and device_now:
                res = self._device_chain(
                    ns, db, frontier, counts, specs[i:],
                    count_only=count_only, dispatch=dispatch,
                )
                if count_only:
                    return res
                frontier, counts = res
                break
            frontier, counts = self._host_hop(ns, db, frontier, counts, specs[i])
            i += 1
        if count_only:
            return int(counts.sum())
        return frontier, counts, it

    def chain(
        self,
        ctx,
        start: List[Thing],
        parts: List,  # List[PGraph]
    ) -> List[Thing]:
        """Run a maximal chain of cond-free graph parts `->a->b->c` as
        batched frontier hops: host adjacency while the frontier is small,
        then the rest of the chain on device once it crosses
        TPU_GRAPH_ONDEVICE_THRESHOLD.

        Multiplicity matches the reference's flatten-without-dedup semantics
        (sql/value/get.rs:404-446): the frontier is deduplicated between hops
        but each node carries its path count, and the final result expands
        each node count times. Result order is deterministic (ascending
        intern order ≈ build-scan key order, with delta-added nodes after)
        but not identical to the KV walk's key order; graph hop ordering is
        unspecified upstream.
        """
        frontier, counts, it = self._chain_frontier(ctx, start, parts)
        out: List[Thing] = []
        for j, c in zip(frontier, counts):
            out.extend([it.node_of[int(j)]] * int(c))
        return out

    def chain_count(self, ctx, start: List[Thing], parts: List) -> int:
        """Path count of a chain WITHOUT materializing the expanded result —
        `count(->a->b->c)` sums the frontier's path counts directly (on a
        3-hop over 1M edges the Python expansion would dominate the whole
        query; the device already holds the counts, and the fused chain
        kernel downloads a single scalar)."""
        return self._chain_frontier(ctx, start, parts, count_only=True)


def graph_from_reference(ref_mirrors, ns: str, db: str, device) -> GraphMirrors:
    """A port GraphMirrors holding one (ns, db) of a reference GraphMirrors:
    its interner (`node_of`, converted to this package's Thing, so both
    packages compute over the same intern ids), every PointerCsr's host
    adjacency and the built tables, with device arrays on `device`. The
    tests use it to run both packages' chains on identical mirror state."""
    gm = GraphMirrors()
    gm.device = torch.device(device)
    it = gm.interner(ns, db)
    for t in ref_mirrors.interner(ns, db).node_of:
        it.intern(t if isinstance(t, Thing) else Thing(t.tb, t.id))
    for (rns, rdb, src_tb, d, ft), m in list(ref_mirrors._m.items()):  # noqa: SLF001
        if (rns, rdb) == (ns, db):
            gm._get_or_create(ns, db, src_tb, d, ft).load(
                {int(k): [int(v) for v in lst] for k, lst in m.adj.items()}
            )
    gm._built = {k for k in ref_mirrors._built if k[:2] == (ns, db)}  # noqa: SLF001
    return gm
