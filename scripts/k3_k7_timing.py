#!/usr/bin/env python3
"""K3, K13, K7, K6 and K4's update on one CUDA card: CUDA-event and queued
times at chip_smoke.py's shapes, for the checkout given by --root (default:
the one holding this script), so two trees compare inside one call.

    python3 scripts/k3_k7_timing.py                       # this tree
    python3 scripts/k3_k7_timing.py --root DIR --label parent
    python3 scripts/k3_k7_timing.py --check               # and hold the
        # rerank's modes and K7 against their plain versions first

Shapes: K3 (probe + rerank) and K13 (the same over 8 shards of the card) on
the HNSW cell's IVF (chip_smoke.py's 2^20 x 768 bf16 corpus and queries,
1,024 lists, nprobe 6, k 10) at Q 1, 8, 16, 32 and 64, each rerank mode
the tree has timed on its own; K7 the odd 5-spec count at 32 lanes; K6 the
friends-of-friends expand's hop; K4's update over 65,536 rows and 1,024
centroids at chip_smoke.py's two assignments (the training's first step and
its second). The tree's own chip_smoke.py supplies the corpus, the graph and
the timers. One JSON line a measurement on stdout (and, with --out, all
of them in that JSON file); exits 1 if a --check fails.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-4)


def ptxas_report(log: str, names=("rerank", "hop_", "live_dot", "seed_rows", "topk_merge")):
    """ptxas's registers / spills / shared memory lines of the kernels
    named, by mangled entry name."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
            cur = fn if any(n in fn for n in names) else None
        elif cur is not None and ("Used" in line or "spill" in line):
            out.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose package is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", help="also write the measurements to this JSON file")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("k3_k7_timing: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from surrealdb_tpu_torch.idx import graph_csr as G
    from surrealdb_tpu_torch.idx import ivf as IVF
    from surrealdb_tpu_torch.ops import _cuda
    from surrealdb_tpu_torch.parallel import mesh as M

    assert C.__file__.startswith(root), C.__file__
    out, failed = [], []

    def emit(what, **kv):
        rec = {"what": what, "label": args.label, **kv}
        out.append(rec)
        print(json.dumps(rec), flush=True)

    def timed(fn, iters=10):
        return dict(ms=C.median_ms(fn, iters=iters), queued_ms=C.queued_device_ms(torch, fn))

    smi = C.phase_environment(torch)
    dev = torch.device("cuda", 0)
    emit("environment", nvidia_smi=smi, root=root, build_seconds=_cuda.build_seconds,
         build_source_seconds=_cuda.build_source_seconds, ptxas=ptxas_report(_cuda.build_log))

    # ------------------------------------------------------------ K3 / K13
    t0 = time.perf_counter()
    dim, n, k = C.DIM, 1 << 20, 10
    corpus = C.gen_corpus(n, dim)
    queries = C.make_queries(corpus, 24 + 32 * 2, 42)
    # the checks' queries: fresh points of the clusters, as chip_smoke.py's K3
    # check takes them (near a zero distance the sqrt amplifies f32 order)
    fresh = C.make_queries(corpus, 64, 7, noise=C.CLUSTER_SIGMA)
    matrix = torch.from_numpy(corpus).to(dev).to(torch.bfloat16)
    t1 = time.perf_counter()  # the training alone: what chip_smoke.py's training_s waits on
    ivf = IVF.IvfState.train(corpus, np.ones(n, dtype=bool), matrix=matrix, device=dev)
    train_s = time.perf_counter() - t1
    del corpus
    nprobe = IVF.default_nprobe(ivf.nlists, 64)
    cents, list_rows, list_mask, probe_ok = ivf._device(dev)
    slot_ok = ivf._all_slots(n, dev)
    lens = np.array([len(l) for l in ivf.lists])
    lmax = int(list_rows.shape[1])
    modes = getattr(IVF, "RERANK_MODES", ())
    has_mode = "mode" in inspect.signature(IVF._ivf_rerank).parameters
    emit("ivf", seconds=time.perf_counter() - t0, train_seconds=train_s, nlists=ivf.nlists,
         nprobe=nprobe, L=lmax,
         list_len_mean=float(lens.mean()), list_len_max=int(lens.max()), modes=list(modes))
    for nq in (1, 8, 16, 32, 64):
        q = torch.from_numpy(np.ascontiguousarray(queries[:nq], dtype=np.float32)).to(dev)
        probes = IVF._ivf_probe(q, cents, "euclidean", nprobe, probe_ok)
        pr = probes.cpu().numpy()
        cand = int(lens[pr].sum())  # (query, member) pairs: the products
        probed = np.unique(pr)
        rows_read = int(lens[probed].sum())  # each probed list's members read once
        nbytes = (nq * dim * 4 + ivf.nlists * dim * 4 + probed.size * lmax
                  + rows_read * (5 + dim * 2) + nq * k * 8)
        bound, by = C.bound_ms(nbytes, 2.0 * nq * ivf.nlists * dim + 2.0 * cand * dim,
                               "bfloat16")
        base = (q, cents, list_rows, list_mask, matrix, slot_ok)
        kw = dict(metric="euclidean", probe_metric="euclidean", k=k, nprobe=nprobe)
        rec = dict(q=nq, bound_ms=bound, bound_by=by, candidate_rows=cand,
                   probed_lists=int(probed.size), rows_read=rows_read,
                   search=timed(lambda: IVF._ivf_search(*base, probe_ok=probe_ok, **kw)))
        rr = (q, probes, list_rows, list_mask, matrix, slot_ok, "euclidean", k)
        rec["rerank"] = timed(lambda: IVF._ivf_rerank(*rr))
        for m in modes:
            rec[f"rerank_{m}"] = timed(lambda: IVF._ivf_rerank(*rr, mode=m))
        if args.check and has_mode and nq in (1, 8, 64):
            qf = torch.from_numpy(np.ascontiguousarray(fresh[:nq], dtype=np.float32)).to(dev)
            for metric in ("euclidean", "cosine"):
                pf = IVF._ivf_probe(qf, cents, metric, nprobe, probe_ok)
                rm = (qf, pf) + rr[2:6] + (metric, k)
                got = {m: IVF._ivf_rerank(*rm, mode=m) for m in modes}
                want = IVF.ivf_rerank_plain(*rm)
                g0 = got[modes[0]]
                equal = all(torch.equal(g[0], g0[0]) and torch.equal(g[1], g0[1])
                            for g in got.values())
                fin = torch.isfinite(want[0])
                close = bool(torch.allclose(g0[0][fin], want[0][fin], **TOL)) and bool(
                    torch.equal(torch.isfinite(g0[0]), fin))
                err = float((g0[0][fin] - want[0][fin]).abs().max()) if bool(fin.any()) else 0.0
                emit("k3_check", q=nq, metric=metric, modes_bit_equal=equal, close=close,
                     max_abs_err=err, ids_equal=bool(torch.equal(g0[1], want[1])))
                if not (equal and close):
                    failed.append(f"K3 q={nq} {metric}")
        emit("k3", **rec)

    mesh = M.Mesh([dev] * C.MESH_SHARDS, ("data",))
    sharded = M.as_sharded(mesh, matrix, ("data", None))
    cents_r, lrows, lmask, _ = ivf._device_sharded(mesh, n)
    all_ok = M.shard_tensor(mesh, torch.ones(n, dtype=torch.bool, device=dev), ("data",),
                            copy=False)
    for nq in (1, 8, 64):
        q = torch.from_numpy(np.ascontiguousarray(queries[:nq], dtype=np.float32)).to(dev)
        call = lambda: M.sharded_ivf_search(mesh, cents_r, lrows, lmask, sharded, q, k,  # noqa
                                            nprobe, slot_ok=all_ok)
        emit("k13", q=nq, **timed(call))
    del matrix, sharded, ivf, cents_r, lrows, lmask, all_ok
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ K4's update
    # chip_smoke.py's two timed assignments (k4_assignments), built here so
    # a parent tree is timed on the same inputs: 65,536 rows (the first
    # chunk of chip_smoke.py's seed-3 corpus) to the training's first seeds
    # (1,024 random rows of x) and to the plain means of that step
    x = torch.from_numpy(C.gen_corpus(65_536, dim, seed=3)).to(dev).to(torch.bfloat16)
    g = torch.Generator().manual_seed(2)
    seeds = x[torch.randperm(65_536, generator=g)[:1024].to(dev)].float().contiguous()
    first = IVF._assign_chunk(x, seeds, 1)
    means = IVF.kmeans_update_plain(x, first, seeds)[0].contiguous()
    for name, (a4, c4) in (("first_step", (first, seeds)),
                           ("means", (IVF._assign_chunk(x, means, 1), means))):
        emit("k4_update", assignment=name, rows=65_536, c=1024, d=dim,
             largest_count=int(torch.bincount(a4.long(), minlength=1024).max()),
             **timed(lambda: IVF.kmeans_update(x, a4, c4)))
    del x, seeds, first, means

    # ------------------------------------------------------------ K7 / K6
    from surrealdb_tpu_torch.utils.num import next_pow2

    arrs = C.graph_arrays(C.graph_pairs(C.GRAPH_NODES, C.GRAPH_EDGES), C.GRAPH_NODES)
    n_cap = arrs["n_cap"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pk, kp = (t(arrs["pk"][0]), t(arrs["pk"][1])), (t(arrs["kp"][0]), t(arrs["kp"][1]))
    pk_csc = tuple(t(a) for a in G.csc_arrays(arrs["pk"][0], arrs["pk"][1]))
    kp_csc = tuple(t(a) for a in G.csc_arrays(arrs["kp"][0], arrs["kp"][1]))
    rng = np.random.default_rng(5)
    fsz = 16
    for lanes in (32, 64):
        fr = np.full((lanes, fsz), n_cap, dtype=np.int32)
        cw = np.zeros((lanes, fsz), dtype=np.int32)
        for b in range(lanes - 3):  # one seed a lane; the last lanes empty
            fr[b, 0], cw[b, 0] = rng.integers(0, C.GRAPH_NODES), 1
        fr, cw = t(fr), t(cw)
        for hops in (2, 4):
            csc = tuple((pk_csc,) if i % 2 == 0 else (kp_csc,) for i in range(hops))
            last = ((pk[0],),)
            run = lambda: G.chain_count_batch(csc, last, fr, cw, n_cap)  # noqa: E731
            if args.check:
                exact = bool(torch.equal(run(), G.chain_count_batch_plain(csc, last, fr, cw,
                                                                          n_cap)))
                emit("k7_check", lanes=lanes, csc_hops=hops, exact=exact)
                if not exact:
                    failed.append(f"K7 lanes={lanes} hops={hops}")
            emit("k7", lanes=lanes, csc_hops=hops, fsz=fsz, n_cap=n_cap, **timed(run))
    fnodes, fcounts = C.fof_frontier(arrs, int(rng.integers(0, C.GRAPH_NODES)))
    ffsz = next_pow2(max(fnodes.size, fsz))
    f1 = np.full(ffsz, n_cap, dtype=np.int32)
    f1[: fnodes.size] = fnodes
    c1 = np.zeros(ffsz, dtype=np.int32)
    c1[: fcounts.size] = fcounts
    f1, c1 = t(f1), t(c1)
    one = ((kp,),)
    emit("k6", fsz=ffsz, frontier=int(fnodes.size),
         **timed(lambda: G.chain_kernel(one, f1, c1, ((1,),), n_cap, (ffsz,), False)))

    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if failed:
        print(f"k3_k7_timing: checks failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
