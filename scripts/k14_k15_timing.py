#!/usr/bin/env python3
"""K14 (mesh_frontier_hop) and K15 (mesh_dedup_frontier) on one CUDA card,
for the checkout given by --root (default: the one holding this script), so
a parent and a change compare inside one call.

    python3 scripts/k14_k15_timing.py                    # this tree
    python3 scripts/k14_k15_timing.py --root DIR --label parent --out F.json

Two shapes, both at the last hop of a 3-hop BFS from node 7 over 8 frontier
shards on cuda:0 (the frontier padded to a multiple of 8 with the masked id
n_nodes, max_degree its largest out-degree), as chip_smoke.py's
phase_mesh_kernels_graph builds them: "config1", bench config 1's person
graph (10,000 nodes, 1,000,000 knows), and "spread", the same graph with
its nodes moved to distinct seeded ids among 2^20 (config 1's CSC capacity:
the same gathered entries, K15's bitmap 128 KB). At each, for
sharded_frontier_hop and dedup_frontier: the outputs held exactly against
the plain versions, then the event and queued times, the host enqueue of
one call (no sync), the launches a call by the wrappers' counters
(mesh.HOP, mesh.DEDUP) and torch.profiler's device time by kernel a call.
Where the tree's mesh.cu has the window kernel for K14 and marks K15's
bitmap in shared memory first (DD_SMEM_WORDS), two copies of mesh.cu are
built side by side under surrealdb_tpu_torch/_build/k14_k15_variants/ and
timed beside the tree's build through the same wrappers, alternating:
"lane_groups", K14 as a group of lanes a frontier row (LANE_GROUPS below),
at both shapes; "global_marking", K15 with the shared-memory step off
(DD_SMEM_WORDS = 0), at config1. The tree's own chip_smoke.py supplies the
graph and the timers; the chip_smoke.py beside this script the spread
graph and K14's bytes (hop_read_bytes), so a parent tree is timed at the
same shapes and held to the same bound. One JSON line a measurement on
stdout (and, with --out, all of them in that JSON file); exits 1 if an
output disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMEM_STEP = "constexpr int DD_SMEM_WORDS = 4096;"
K15_MARK = "// ------------------------------------------------------------------ K15"
WINDOW_LAUNCH = "  const long long windows = (F * max_degree + HOP_WINDOW - 1) / HOP_WINDOW;"

# K14 by lane groups, the design the window kernel was chosen over: put
# before mesh.cu's K15 section (it uses K14's gather_index), launched by
# mesh_frontier_hop in place of the window kernel.
LANE_GROUPS = r"""
struct HopArgs {
  const int* indptr; long long V1; const int* indices; long long E; const int* frontier;
  const unsigned char* fmask; long long F; int md; int* out_nb; unsigned char* out_valid;
};

// G lanes (max_degree's next power of two, at most 32) a frontier row: the
// group's first lane reads the row's id, mask and both pointers, the group
// takes them by shuffle, lane l writes offsets l, l + G, ... < max_degree
// (coalesced neighbours and flags, no division). A warp's groups take rows
// together, so the shuffles are warp-wide.
template <int G>
__global__ void __launch_bounds__(HOP_THREADS) frontier_hop_lanes(HopArgs a) {
  const int lane = threadIdx.x & 31, first = lane & ~(G - 1);
  const long long warp = ((long long)blockIdx.x * HOP_THREADS + threadIdx.x) >> 5;
  const long long step = (long long)gridDim.x * (HOP_THREADS / 32) * (32 / G);
  for (long long f0 = warp * (32 / G); f0 < a.F; f0 += step) {
    const long long f = f0 + lane / G;
    int start = 0, lim = 0;
    if (lane == first && f < a.F) {
      const int fr = a.frontier[f];
      start = a.indptr[gather_index(fr, a.V1)];
      const int end = a.indptr[gather_index((int)((unsigned)fr + 1u), a.V1)];
      lim = a.fmask[f] ? (int)((unsigned)end - (unsigned)start) : 0;
    }
    start = __shfl_sync(0xffffffffu, start, first);
    lim = __shfl_sync(0xffffffffu, lim, first);
    if (f >= a.F) continue;
    const long long base = f * a.md;
    for (int o = lane & (G - 1); o < a.md; o += G) {
      const int take = (int)((unsigned)start + (unsigned)o);
      const long long safe = take < 0 ? 0 : (take > a.E - 1 ? a.E - 1 : take);
      a.out_nb[base + o] = a.indices[safe];
      a.out_valid[base + o] = o < lim ? 1 : 0;
    }
  }
}

void hop_lanes_launch(const HopArgs& a, cudaStream_t s) {
  int g = 1;
  while (g < a.md && g < 32) g *= 2;
  const long long grid = (a.F + HOP_THREADS / g - 1) / (HOP_THREADS / g);
  const unsigned blocks = (unsigned)(grid < 65536 ? grid : 65536);
  switch (g) {
    case 1: frontier_hop_lanes<1><<<blocks, HOP_THREADS, 0, s>>>(a); break;
    case 2: frontier_hop_lanes<2><<<blocks, HOP_THREADS, 0, s>>>(a); break;
    case 4: frontier_hop_lanes<4><<<blocks, HOP_THREADS, 0, s>>>(a); break;
    case 8: frontier_hop_lanes<8><<<blocks, HOP_THREADS, 0, s>>>(a); break;
    case 16: frontier_hop_lanes<16><<<blocks, HOP_THREADS, 0, s>>>(a); break;
    default: frontier_hop_lanes<32><<<blocks, HOP_THREADS, 0, s>>>(a); break;
  }
}

"""
LANES_LAUNCH = """  hop_lanes_launch(HopArgs{(const int*)indptr, V1, (const int*)indices, E,
                           (const int*)frontier, (const unsigned char*)fmask, F, max_degree,
                           (int*)out_nb, (unsigned char*)out_valid},
                   (cudaStream_t)stream);
"""


def _chip_smoke_here():
    """The chip_smoke.py beside this script, under its own module name."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def last_hop(indptr, indices, nodes: int, seed: int, hops: int, shards: int):
    """The padded frontier, its mask and max_degree at hop `hops` (numpy)."""
    live = np.array([seed], dtype=np.int64)
    for _ in range(hops - 1):
        live = np.unique(np.concatenate([indices[indptr[v]:indptr[v + 1]] for v in live]))
    f = -(-live.size // shards) * shards
    fr = np.full(f, nodes, dtype=np.int32)
    fr[: live.size] = live
    fm = np.zeros(f, dtype=bool)
    fm[: live.size] = True
    return fr, fm, int(np.diff(indptr)[live].max())


def lane_groups(src):
    """mesh.cu with K14's window kernel launch replaced by LANE_GROUPS."""
    at = src.index("int mesh_frontier_hop(")
    lo = src.index(WINDOW_LAUNCH, at)
    hi = src.index("(unsigned char*)out_valid);\n", lo) + len("(unsigned char*)out_valid);\n")
    src = src[:lo] + LANES_LAUNCH + src[hi:]
    return src.replace(K15_MARK, LANE_GROUPS + K15_MARK, 1)


VARIANTS = {
    "lane_groups": lane_groups,
    "global_marking": lambda src: src.replace(SMEM_STEP, "constexpr int DD_SMEM_WORDS = 0;"),
}


def build_variants(cuda):
    """{name: library} of VARIANTS, each a copy of csrc/ with its mesh.cu
    edited, built side by side; {} when the tree's mesh.cu predates them."""
    with open(os.path.join(cuda.CSRC, "mesh.cu")) as f:
        src = f.read()
    if src.count(SMEM_STEP) != 1 or src.count(WINDOW_LAUNCH) != 1 or K15_MARK not in src:
        return {}
    root = os.path.join(os.path.dirname(cuda.CSRC), "_build", "k14_k15_variants")
    cmds, sos = [], {}
    for name, edit in VARIANTS.items():
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda.CSRC, d)
        with open(os.path.join(d, "mesh.cu"), "w") as f:
            f.write(edit(src))
        obj, sos[name] = os.path.join(d, "mesh.o"), os.path.join(d, "libmesh.so")
        cmds.append(["bash", "-c", " ".join(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-c", "-o", obj, os.path.join(d, "mesh.cu"), "&&",
             cuda._nvcc(), *cuda.ARCH_FLAGS, "-shared", "-o", sos[name], obj])])
    libs = {}
    for (name, so), (rc, log) in zip(sos.items(), cuda._run_all(cmds, root)):
        if rc != 0:
            raise SystemExit(f"the variant {name} did not build:\n{log[-3000:]}")
        lib = libs[name] = ctypes.CDLL(so)
        for fn_name, (restype, argtypes) in cuda._SIGNATURES.items():
            fn = getattr(lib, fn_name, None)
            if fn is not None:
                fn.restype, fn.argtypes = restype, argtypes
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose package is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", help="also write the measurements to this JSON file")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("k14_k15_timing: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from surrealdb_tpu_torch.ops import _cuda
    from surrealdb_tpu_torch.parallel import mesh as M

    assert C.__file__.startswith(root), C.__file__
    out, ok = [], True

    def emit(what, **kv):
        rec = {"what": what, "label": args.label, **kv}
        out.append(rec)
        print(json.dumps(rec), flush=True)

    smi = C.phase_environment(torch)
    dev = torch.device("cuda", 0)
    emit("environment", nvidia_smi=smi, root=root, build_seconds=_cuda.build_seconds)
    H = _chip_smoke_here()
    variants = build_variants(_cuda)
    lib = _cuda.lib()
    mesh = C.one_device_mesh(torch, "cuda")
    indptr, indices = C.person_csr(C.graph_pairs(C.GRAPH_NODES, C.GRAPH_EDGES), C.GRAPH_NODES)
    sptr, sidx, ids = H.spread_csr(indptr, indices, 1 << 20)
    shapes = {"config1": (indptr, indices, C.GRAPH_NODES, 7),
              "spread": (sptr, sidx, 1 << 20, int(ids[7]))}
    for shape, (ptr_np, idx_np, n, seed) in shapes.items():
        fr, fm, md = last_hop(ptr_np, idx_np, n, seed, 3, C.MESH_SHARDS)
        ptr, idx = M.replicate(mesh, ptr_np), M.replicate(mesh, idx_np)
        frt, fmt = torch.from_numpy(fr).to(dev), torch.from_numpy(fm).to(dev)
        hop = lambda: M.sharded_frontier_hop(mesh, ptr, idx, frt, fmt, md)  # noqa: E731
        nb, valid = hop()
        want = M.sharded_frontier_hop_plain(mesh, ptr, idx, frt, fmt, md)
        hop_exact = bool(torch.equal(nb, want[0]) and torch.equal(valid, want[1]))
        dedup = lambda: M.dedup_frontier(nb, valid, n)  # noqa: E731
        got, wantd = dedup(), M.dedup_frontier_plain(nb, valid, n)
        dedup_exact = bool(torch.equal(got[0], wantd[0]) and torch.equal(got[1], wantd[1]))
        ok = ok and hop_exact and dedup_exact
        f = int(fr.size)
        hop_bytes = H.hop_read_bytes(ptr_np, idx_np, fr, md) + f * md * 5
        for name, fn, counter, exact, nbytes in (
                ("K14", hop, M.HOP, hop_exact, hop_bytes),
                ("K15", dedup, M.DEDUP, dedup_exact, 10 * f * md)):
            torch.cuda.synchronize()
            enq = []
            for _ in range(40):
                t0 = time.perf_counter()
                fn()
                enq.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            counter.reset()
            fn()
            launches = counter.launches
            emit(name, shape=shape, exact=exact, ms=C.median_ms(fn, iters=30),
                 queued_ms=C.queued_device_ms(torch, fn),
                 enqueue_host_ms=statistics.median(enq[10:]),
                 launches_a_call=launches, kernels_per_call=C.kernels_per_call(torch, fn),
                 bound_ms=C.bound_ms(nbytes, 0.0, "float32")[0], frontier=f, max_degree=md,
                 entries=f * md, nodes=n, reached=int(got[1].sum()))
        place = []  # K14's placement of its four inputs over the mesh, alone
        for _ in range(40):
            t0 = time.perf_counter()
            M.replicate(mesh, ptr), M.replicate(mesh, idx)
            M.as_sharded(mesh, frt, ("data",)), M.as_sharded(mesh, fmt, ("data",))
            place.append((time.perf_counter() - t0) * 1e3)
        emit("K14_placement", shape=shape, host_ms=statistics.median(place[10:]))
        if not variants:
            continue
        pt, it = torch.from_numpy(ptr_np).to(dev), torch.from_numpy(idx_np).to(dev)
        lanes = variants["lane_groups"]
        for label, vlib in (("window", lib), ("lane_groups", lanes), ("lane_groups", lanes),
                            ("window", lib)):
            call = lambda: M._launch_frontier_hop(vlib, pt, it, frt, fmt, md)  # noqa: E731
            res = call()
            exact = bool(torch.equal(res[0], want[0]) and torch.equal(res[1], want[1]))
            ok = ok and exact
            emit("K14_design", shape=shape, variant=label, exact=exact,
                 ms=C.median_ms(call, iters=30), queued_ms=C.queued_device_ms(torch, call),
                 kernels_per_call=C.kernels_per_call(torch, call))
        if shape != "config1":
            continue
        variant = variants["global_marking"]
        for label, vlib in (("shared_marking", lib), ("global_marking", variant),
                            ("global_marking", variant), ("shared_marking", lib)):
            sc = M.DedupScratch(vlib, n, dev)
            call = lambda: M._launch_dedup_frontier(vlib, nb, valid, n, sc)  # noqa: E731
            res = call()
            exact = bool(torch.equal(res[0], wantd[0]) and torch.equal(res[1], wantd[1]))
            ok = ok and exact
            emit("K15_marking", shape=shape, variant=label, exact=exact,
                 ms=C.median_ms(call, iters=30), queued_ms=C.queued_device_ms(torch, call),
                 kernels_per_call=C.kernels_per_call(torch, call))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
