#!/usr/bin/env python3
"""Smoke run of surrealdb_tpu_torch on one CUDA card.

    python3 chip_smoke.py                  # full size: 2^20 x 768 corpora, the
                                           # 1M-edge graph, the 1M-document index
    python3 chip_smoke.py --rows 262144    # a cut MTREE corpus (record the cut)
    python3 chip_smoke.py --multicard      # only the mesh over 2+ cards
    python3 chip_smoke.py --ml-only        # only phase 10 and ml_paths: the
                                           # narrow against the skinny design
    python3 chip_smoke.py --file-only      # only phase 12 (--file-rows 1048576:
                                           # at config 2's full 2^20 rows)
    python3 chip_smoke.py --cluster-only   # only phase 13 (--cluster-rows 1048576:
                                           # at config 2's full 2^20 rows)
    python3 chip_smoke.py --cpu-rehearsal  # tiny, on the CPU, plain versions;
                                           # exits 1 and prints no result

Phases, one JSON line each (or more):
1. environment: the card, its power limit, the kernel build (nvcc, sm_90a,
   one process a source);
2. every CUDA kernel against its plain PyTorch version on the card: K1/K2
   (exact kNN: the fused search's streaming tier at Q <= 8, its tensor
   tier at Q = 64 with a lower-limb case, k up to 256 and K1 + select
   above, the IVF probe's shape), K5 ivf_assign and the K4 k-means update
   at the training's shapes (the update on four assignments: to one step's
   means, the training's first step's, 90% of the rows in one centroid,
   every odd centroid empty; counts equal, TOL, two runs bit-equal); then
   median times (by events and queued) beside the bound, the plain version
   and a one-call PyTorch yardstick where one exists (K4's update at the
   first and second steps' assignments, beside index_reduce_ "mean");
3. the MTREE main path through Datastore.execute: an exact index over a
   seeded clustered corpus, ingested with INSERT, then sequential and
   concurrent `<|10|>` queries; every query must take `exact-device`, the
   launch counts must equal the dispatched tiles, recall@10 against an f32
   exact ground truth must be >= 0.99;
4. the HNSW main path: `DEFINE INDEX … HNSW … EFC 64` over the same corpus,
   `<|10,64|>` queries; the first after ingest serves exactly while the
   quantizer trains (K4, K5), every timed query takes `ivf` (K2 probe, K3
   rerank), launch counts equal the dispatched tiles, device recall@10
   lies within 0.01 of the host twin's (IvfState.search_host); then K3
   against its plain version and its times, on the trained state;
5. the graph kernels K6 graph_chain, K7 graph_csc_count and K8
   graph_dense_count against their plain versions, exactly, on bench config
   1's adjacency (10,000 `person` nodes, 1,000,000 `knows` edges; K6 also
   with int32 counts that wrap, a frontier that touches the sentinel, two
   mirrors a hop, calls back to back that leave its scratch zero, and a
   planted failed call followed by a good one), and their times (K6's
   beside the floors of its old dense design and its bitmap design);
6. the graph main path: config 1 ingested with INSERT / INSERT RELATION,
   then `count(->knows->person x3)` (K8) sequentially and from 32 clients,
   the odd 5-spec count (K7) and the friends-of-friends expand (K6); every
   answer equals an independent numpy reference built from the same pairs;
7. bm25_kernels: K9 bm25_scores and bm25_topk against their plain versions
   at config 3's candidate shapes (N up to 2^20, T in {1, 2, 8}, int32 and
   f32 tf, a total length above 2^24), their times, and the crossover of
   the engine's device path against the numpy twin; then K9's match
   (bm25_match_scores) over config 3's postings on the card against its
   plain version (dids equal, scores bit-equal, also to bm25_scores' on the
   same tf rows: T 1, 2, 3 and 8, rarest lists of one did, one tile and many
   tiles, empty and full intersections, the largest did, stats_override
   df; T 256, 257 and 300 over many_term_postings, past the terms a launch
   takes by value), its times at the median query, and the engine's per-query paths
   (the match, the old device path, the host path) in the crossover rows;
8. the full-text main path: bench config 3 (1,000,000 documents of 12
   zipf-drawn words) ingested with INSERT, then bench_bm25's `@1@ ... ORDER
   BY sc DESC LIMIT 10` queries sequentially and from 32 clients and one
   broad one-term query, with cnf.TPU_FT_ONDEVICE_THRESHOLD lowered to 1 so
   every query whose words all have postings launches K9's match once (the
   launches must equal them; the first query uploads the postings), one
   query inside a transaction that writes to the index (K9 bm25_scores),
   then again at the default threshold (the numpy twin); every answer
   equals an independent numpy BM25 over the generated words;
9. the ML main path, run on phase 4's Datastore before it closes (its
   2^20 x 768 items and HNSW mirror; nothing re-ingested): bench config 5,
   `SELECT VALUE ml::scorer<1>(emb) FROM item` with a linear 768 -> 1
   (warm-up, 5 timed scans, one under cnf.TPU_DISABLE), an MLP 768 -> 128
   relu -> 10 softmax over the same scan, and the row path `... FROM
   item:0..16384` (a record range); every answer equals a numpy f64
   forward over the bf16 features in key order, each scan is one dispatch,
   and K10's launches are forwards x layers (+ one softmax); cProfile
   breakdowns and the busy share of a scan;
10. ml_kernels: K10 ml_linear (config 5's 2^20 x 768 bf16 -> 1, f32, the
   MLP's layers, config 5's width to 2, 10 and 16 outputs, the row path's
   shapes, a ragged M) and ml_softmax against their plain versions, with
   event and queued times, bounds (the f32-accurate product's: bytes or
   its bf16 limb products on the tensor cores; the f32 FMA bound beside)
   and torch.addmm beside them (with the upcast, and on a pre-cast x); the
   MLP scan's forward timed by CUDA events (phase 9).

11. the mesh path (surrealdb_tpu_torch/parallel/mesh.py), 8 shards on
   cuda:0 (the reference's test mesh on one card): `main_path_mesh` runs
   on phase 3's and (after the ML phase) phase 4's open Datastores with
   Datastore.mesh() returning the 8-shard mesh, nothing re-ingested: the
   same 88 queries must all take `exact-sharded` (recall@10 >= 0.99) and
   `ivf-sharded` (no retraining), return the single-device answers up to
   ties, launch K2 x 8 shards + one merge a tile (exact-sharded) or the
   probe, one K13 rerank over the 8 shards and one merge a tile
   (ivf-sharded), and hold no second corpus; `mesh_kernels`: K11 and K12
   (on a 4 x 2 mesh; Q 1, 4 and 64) on the MTREE mirror's shards, K13 on
   the HNSW state (Q 1, 8 and 64), K14 and K15 on config 1's 3-hop BFS,
   each against its plain version (K11 also against single-device K2, K13
   against K3), with times and the kernels a call runs; `dryrun_mesh`:
   parallel/dryrun.py's entry() and dryrun_multichip(8) on the card;
12. main_path_file: phase 3's MTREE schema on the file backend after a
   crash. A child process ingests the corpus's first 2^18 rows (config 2's
   2^20 cut for the time limit; --file-rows) into `file://<tmp>/db` on the
   card, printing an ack after each committed batch, and is killed with
   SIGKILL once it acknowledged every row (no close, no compaction at
   exit); a torn frame is appended to its WAL. The store reopens on the
   card: count() must equal the acknowledged rows, INFO FOR TABLE must list
   the index, tick() runs, and phase 3's 88 queries must all take
   `exact-device` with K2's launches equal to the dispatched tiles and
   recall@10 >= 0.99 over the cut corpus. Then a compaction and a clean
   close, and a reopen from the snapshot alone answers a query as before.
   It prints ingest rows/s, WAL and snapshot bytes, reopen_s, first_query_s
   and time_to_recover_s (their sum), p50 and qps after recovery, the busy
   share of 8 queries and peak device memory, beside the card's name and
   power limit.
13. main_path_cluster: config 2's kNN from a 3-node RF-2 cluster (README.md
   "Cluster mode": 64 vnodes, a shared secret), each node a Datastore on
   the card behind net.server.serve(..., cluster_config=...) in this
   process. Phase 12's rows (2^18; --cluster-rows) go into each node's own
   store by the ring's placement (the counts must sum to RF x rows and
   match the ring); fresh rows through n1's write path are read back from
   both replicas; the 88 queries through n1's executor (24 sequential, 32
   clients x 2) and 24 over WebSocket must reach every node's K2
   (`exact-device`; launches = the nodes' dispatched tiles, no other
   kernel), recall@10 >= 0.99 and ids equal phase 12's single node's up to
   ties; a kept trace gives the coordinator's spans beside each node's;
   then a scan, BM25 at threshold 1 (K9's match on every shard) and a
   2-hop select against one node on the card, n3 stopped (the same answers,
   `degraded`), and two `start --cluster` children at RF 2 of 2.

Then the kernel table as one JSON line, the card's name and power limit,
and last `{"ok": true, "device": {...}}`. Any failure exits non-zero. This
script imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np

DIM = 768  # the headline corpus's published width (bench.py config 2)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, outside/inside tensor cores
# the CPU tests' tolerance: f32 sums in another order than the plain
# version's (both sides upcast a bf16 corpus to f32 first)
TOL = dict(rtol=1e-5, atol=1e-4)
PROBE_K = 6  # the IVF probe's k: default_nprobe(1024 lists, ef 64)


T0 = time.perf_counter()


def emit(phase: str, **kv) -> None:
    # t_s: the script's clock, so a run's log shows where its time went
    print(json.dumps({"phase": phase, **kv, "t_s": time.perf_counter() - T0}), flush=True)


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------------ corpus
N_CLUSTERS = 4000
CLUSTER_SIGMA = 0.35


def gen_corpus(n, d, seed=42):
    """Deterministic clustered corpus (mixture of gaussians: 4000 centers,
    sigma 0.35). Real embedding spaces are clustered — isotropic gaussian
    noise has NO neighborhood structure (every point's true top-k is spread
    uniformly over the corpus), which makes any sublinear ANN meaningless
    rather than hard. Standard ANN benchmark sets (SIFT/GloVe/DEEP) are all
    clustered; this mirrors them while staying generatable on the fly."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((N_CLUSTERS, d)).astype(np.float32)
    out = np.empty((n, d), dtype=np.float32)
    step = 65_536
    for i in range(0, n, step):
        m = min(step, n - i)
        cid = rng.integers(0, N_CLUSTERS, size=m)
        out[i : i + m] = centers[cid] + CLUSTER_SIGMA * rng.standard_normal(
            (m, d), dtype=np.float32
        )
    return out


def knn_ground_truth(corpus, queries, k):
    """Exact top-k by euclidean distance, chunked float32 BLAS."""
    n = corpus.shape[0]
    q2 = (queries**2).sum(axis=1)[:, None]
    best_d = np.full((queries.shape[0], k), np.inf, dtype=np.float64)
    best_i = np.zeros((queries.shape[0], k), dtype=np.int64)
    step = 131_072
    for i in range(0, n, step):
        blk = corpus[i : i + step]
        d = q2 + (blk**2).sum(axis=1)[None, :] - 2.0 * (queries @ blk.T)
        merged_d = np.concatenate([best_d, d], axis=1)
        merged_i = np.concatenate(
            [best_i, np.broadcast_to(np.arange(i, i + blk.shape[0]), d.shape)], axis=1
        )
        sel = np.argpartition(merged_d, k - 1, axis=1)[:, :k]
        best_d = np.take_along_axis(merged_d, sel, axis=1)
        best_i = np.take_along_axis(merged_i, sel, axis=1)
    order = np.argsort(best_d, axis=1)
    return np.take_along_axis(best_i, order, axis=1)


# ------------------------------------------------------------------ timing
def median_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() by CUDA events, one event pair a call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def queued_device_ms(torch, fn, iters: int = 20, hold_cycles: int = 50_000_000) -> float:
    """Device time a call of fn() when its launches run back to back: a
    sleep kernel holds the stream while the host queues `iters` calls, so
    the events time the kernels (and the gaps between them), not the
    host's launch overhead, which an event pair around one call of a
    microsecond kernel mostly measures."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)  # ~25 ms: longer than queueing the calls
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_busy_share(torch, fn):
    """Run fn() under torch.profiler (CUDA activity only: host-op tracing
    slowed the host path about a hundredfold) and return the device time by
    kernel and its share of the wall time; "not measured" when the profiler
    reports no device time on this machine."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()  # after the profiler's own start-up
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            by_name[ev.key[:60]] = us / 1e3
    if not by_name:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    dev_ms = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "busy_share": dev_ms / wall_ms,
            "top_device_ms": top}


def kernels_per_call(torch, fn, calls: int = 10):
    """The device kernels one call of fn() runs, every kind counted (ours,
    PyTorch's fills and copies; not memcpy / memset), by torch.profiler
    over `calls` calls, one a profiler step, after two warm-up steps (a
    session without them lost the first calls' kernels): {"kernels": n,
    "device_ms": t, "by_name": {name: [kernels, device ms] a call},
    "memsets": memsets a call}, or "not measured" when the profiler reports
    no kernel on this machine."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                 schedule=schedule(wait=0, warmup=2, active=calls, repeat=1)) as prof:
        for _ in range(2 + calls):
            fn()
            torch.cuda.synchronize()
            prof.step()
    by_name, memsets = {}, 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if ev.key.startswith("Memset"):
            memsets += ev.count / calls
        elif us and not ev.key.startswith("Memcpy"):
            n, t = by_name.get(ev.key[:60], (0.0, 0.0))
            by_name[ev.key[:60]] = (n + ev.count / calls, t + us / 1e3 / calls)
    if not by_name:
        return "not measured"
    return {"kernels": sum(n for n, _ in by_name.values()),
            "device_ms": sum(t for _, t in by_name.values()),
            "by_name": {k: list(v) for k, v in by_name.items()}, "memsets": memsets}


# ------------------------------------------------------------------ phase 1
def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from surrealdb_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.lib()
    load_s = time.perf_counter() - t0
    regs = [l.strip() for l in _cuda.build_log.splitlines() if "registers" in l]
    emit(
        "environment", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda,
        build_seconds=_cuda.build_seconds, build_source_seconds=_cuda.build_source_seconds,
        load_seconds=load_s,
        ptxas_register_lines=len(regs),
        max_registers=max((int(l.split("Used ")[1].split()[0]) for l in regs), default=None),
    )
    return smi


# ------------------------------------------------------------------ phase 2
def ids_match_up_to_ties(a_d, a_i, b_d, b_i, finite_kth: bool = False, tol=TOL) -> bool:
    """Per query, every id in one result and not the other lies within the
    tolerance of the k-th value (a tie that the two summation orders may
    break differently). With finite_kth the k-th value is the largest
    finite one of b's row (its misses then must match exactly)."""
    rtol, atol = tol["rtol"], tol["atol"]
    for r in range(a_i.shape[0]):
        fin = b_d[r][np.isfinite(b_d[r])]
        kth = float(fin.max()) if finite_kth and fin.size else float(b_d[r, -1])
        band = atol + rtol * abs(kth)
        sa, sb = set(a_i[r].tolist()), set(b_i[r].tolist())
        extra = [j for j, v in enumerate(a_i[r].tolist()) if v not in sb]
        missing = [j for j, v in enumerate(b_i[r].tolist()) if v not in sa]
        if any(abs(float(a_d[r, j]) - kth) > band for j in extra):
            return False
        if any(abs(float(b_d[r, j]) - kth) > band for j in missing):
            return False
    return True


def phase_kernels(torch, dim: int, big_n: int):
    from surrealdb_tpu_torch.ops import distances as D

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    metrics = list(D.METRICS) + ["minkowski:3"]
    k1_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for nq in (1, 8, 64):
            q = torch.randn(nq, dim, generator=g).to(dev)
            x = torch.randn(4096, dim, generator=g).to(dev).to(dt)
            for m in metrics:
                qq, xx = (q.abs(), x.abs()) if m == "jaccard" else (q, x)
                got = D.pairwise_distance(qq, xx, m)
                torch.cuda.synchronize()
                want = D.pairwise_distance_plain(qq, xx, m)
                err = float((got - want).abs().max())
                ok = bool(torch.allclose(got, want, **TOL))
                emit("k1_check", metric=m, corpus=str(dt).split(".")[-1], q=nq,
                     n=4096, d=dim, max_abs_err=err, ok=ok)
                require(ok, f"K1 {m} {dt} Q={nq} disagrees with its plain version ({err})")
                if m == "euclidean":  # the main path's metric: its error is K1's entry
                    k1_err = max(k1_err, err)

    k2_err = 0.0

    def k2_check(q, x, mask, metric, k, **label):
        got_d, got_i = D.knn_search(q, x, mask, metric, k)
        torch.cuda.synchronize()
        want_d, want_i = D.knn_search_plain(q, x, mask, metric, k)
        fin = torch.isfinite(want_d)
        err = float((got_d - want_d)[fin].abs().max()) if bool(fin.any()) else 0.0
        d_ok = bool(torch.allclose(got_d, want_d, **TOL)) and got_i.dtype == torch.int32
        id_ok = ids_match_up_to_ties(
            got_d.cpu().numpy(), got_i.cpu().numpy(),
            want_d.cpu().numpy(), want_i.cpu().numpy(),
        )
        emit("k2_check", q=q.shape[0], n=x.shape[0], d=x.shape[1], k=k, metric=metric,
             corpus=str(x.dtype).split(".")[-1], max_abs_err=err,
             ids_equal=bool(torch.equal(got_i, want_i)), ids_ok=id_ok, ok=d_ok, **label)
        require(d_ok and id_ok, f"K2 {metric} Q={q.shape[0]} N={x.shape[0]} k={k} {label} "
                "disagrees with its plain version")
        return err, got_i

    # the streaming tier (Q <= 8) and the tensor tier (Q = 64, the dispatch
    # tile above 8); k = 256 is the fused search's largest, 257 takes K1
    # then knn_select, 5000 the one-block select
    for n in (4096, big_n):
        x = torch.randn(n, dim, generator=g).to(dev).to(torch.bfloat16)
        mask = torch.rand(n, generator=g).to(dev) > 0.05  # ~5% dead rows
        for nq in (1, 8, 64):
            q = torch.randn(nq, dim, generator=g).to(dev)
            for k in (1, 10, 100, 256, 257, 5000):
                k2_err = max(k2_err, k2_check(q, x, mask, "euclidean", min(k, n))[0])
            if nq > 1:
                k2_err = max(k2_err, k2_check(q, x, mask, "cosine", 10)[0])
        del x
    # the tensor tier's lower limbs: 64 queries whose nearest row only query
    # limb 1 or limb 2 tells apart (row 2g + 1 for query g); the plain
    # version on queries cut to one or to two limbs is the control: it must
    # miss that row
    q, x = knn_lower_limb_case(torch, dev, 64, dim)
    ones = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
    near_rows = 2 * torch.arange(64) + 1
    cut = limb_split(torch, q)
    d_full = D.pairwise_distance_plain(q, x, "euclidean")
    for k in (1, 2):
        err, ids = k2_check(q, x, ones, "euclidean", k, case="lower_limbs")
        near = bool(torch.equal(ids[:, 0].long().cpu(), near_rows))
        want_d, want_i = D.knn_search_plain(q, x, ones, "euclidean", k)
        controls = {}
        for name, qc in (("one", cut[0]), ("two", cut[0] + cut[1])):
            ci = D.knn_search_plain(qc, x, ones, "euclidean", k)[1]
            cd = d_full.gather(1, ci.long())  # the picks' distances to the f32 queries
            controls[f"{name}_limb_control_near"] = bool(
                torch.equal(ci[:, 0].long().cpu(), near_rows))
            controls[f"{name}_limb_control_ids_ok"] = ids_match_up_to_ties(
                cd.cpu().numpy(), ci.cpu().numpy(), want_d.cpu().numpy(), want_i.cpu().numpy())
        emit("k2_lower_limbs", k=k, nearest_is_near=near, **controls)
        require(near, f"K2's tensor tier missed a lower-limb nearest row (k={k})")
        require(not controls["one_limb_control_near"] and not controls["two_limb_control_near"],
                "the K2 lower-limb case does not tell a one- or two-limb product from the f32 one")
        k2_err = max(k2_err, err)
    # the IVF probe's shape: one query against 1,024 f32 centroids, k = nprobe
    cents = torch.randn(1024, dim, generator=g).to(dev)
    q = torch.randn(1, dim, generator=g).to(dev)
    probe_ok = torch.ones(1024, dtype=torch.bool, device=dev)
    k2_err = max(k2_err, k2_check(q, cents, probe_ok, "euclidean", PROBE_K, case="probe")[0])
    # tie order: a corpus of identical rows makes every distance tie, and
    # the dead rows come back as +inf, in index order — once with k = N
    # (K1, then one select block a query), and over many blocks' ranges in
    # the fused search's streaming and tensor tiers
    for n, k, nq, dt in ((3000, 3000, 2, torch.float32), (200_000, 100, 2, torch.float32),
                         (200_000, 100, 64, torch.bfloat16)):
        x = torch.zeros(n, 8, device=dev, dtype=dt)
        q = torch.zeros(nq, 8, device=dev)
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        mask[::7] = False
        got = D.knn_search(q, x, mask, "euclidean", k)
        want = D.knn_search_plain(q, x, mask, "euclidean", k)
        exact = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        emit("k2_ties", n=n, k=k, q=nq, corpus=str(dt).split(".")[-1], exact=exact)
        require(exact, f"K2 tie order / masked rows differ from the plain version (N={n}, k={k})")
    return k1_err, k2_err


def phase_timing(torch, dim: int, n: int, k: int):
    """Times at the main path's launch shapes: Q in {1, 8, 64} queries (the
    dispatch tiles) against a bf16 corpus of N rows (the mirror's upload
    type on CUDA), by an event pair and queued; then K2 at the IVF probe's
    shape (one query, 1,024 f32 centroids, k = PROBE_K)."""
    from surrealdb_tpu_torch.ops import distances as D

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(n, dim, generator=g).to(dev).to(torch.bfloat16)
    xf = x.float()  # the yardstick's input: cdist takes one dtype
    mask = torch.ones(n, dtype=torch.bool, device=dev)

    def timed(fn, plain, library, nbytes, flops):
        bound, by = bound_ms(nbytes, flops, "bfloat16")
        return dict(ms=median_ms(fn), queued_ms=queued_device_ms(torch, fn),
                    plain_ms=median_ms(plain, iters=5), library_ms=median_ms(library),
                    bound_ms=bound, bound_by=by)

    out = {}
    for nq in (1, 8, 64):
        q = torch.randn(nq, dim, generator=g).to(dev)
        in_bytes = nq * dim * 4 + n * dim * 2
        flops = 2.0 * nq * n * dim
        out[nq] = {
            "knn_pairwise": timed(lambda: D.pairwise_distance(q, x, "euclidean"),
                                  lambda: D.pairwise_distance_plain(q, x, "euclidean"),
                                  lambda: torch.cdist(q, xf), in_bytes + nq * n * 4, flops),
            "knn_select": timed(lambda: D.knn_search(q, x, mask, "euclidean", k),
                                lambda: D.knn_search_plain(q, x, mask, "euclidean", k),
                                lambda: torch.topk(torch.cdist(q, xf), k, largest=False),
                                in_bytes + n + nq * k * 8, flops),
        }
        emit("timing", q=nq, n=n, d=dim, k=k, corpus="bfloat16", **out[nq])
    del x, xf
    cents = torch.randn(1024, dim, generator=g).to(dev)
    q = torch.randn(1, dim, generator=g).to(dev)
    ok = torch.ones(1024, dtype=torch.bool, device=dev)
    out["probe"] = timed(lambda: D.knn_search(q, cents, ok, "euclidean", PROBE_K),
                         lambda: D.knn_search_plain(q, cents, ok, "euclidean", PROBE_K),
                         lambda: torch.topk(torch.cdist(q, cents), PROBE_K, largest=False),
                         dim * 4 + 1024 * dim * 4 + 1024 + PROBE_K * 8, 2.0 * 1024 * dim)
    emit("timing_probe", q=1, n=1024, d=dim, k=PROBE_K, corpus="float32", **out["probe"])
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ IVF kernels
def ids_equal_up_to_ties(got, want, d):
    """got / want [n, k] ids of the k nearest rows of d [n, C]: equal, or
    where they differ the two picks' distances tie within TOL. Returns
    (ok, max |d[got] - d[want]|)."""
    g = got.long().reshape(d.shape[0], -1)
    w = want.long().reshape(d.shape[0], -1)
    dg, dw = d.gather(1, g), d.gather(1, w)
    err = float((dg - dw).abs().max()) if dg.numel() else 0.0
    tol = TOL["atol"] + TOL["rtol"] * dw.abs()
    return bool(((g == w) | ((dg - dw).abs() <= tol)).all()), err


def limb_split(torch, c):
    """The kernel's split of f32 c into three bf16 limbs, by truncation."""
    def trunc(v):
        return (v.view(torch.int32) & -65536).view(torch.float32)
    l0 = trunc(c)
    l1 = trunc(c - l0)
    return l0, l1, c - l0 - l1


def lower_limb_case(torch, dev, groups: int, dim: int, seed: int = 5):
    """bf16 rows whose nearest f32 centroid is told from the next one only
    by limb 1 (even groups) or only by limb 2 (odd groups) of the kernel's
    split: a group's centroids are `far` (index 2g) and `near` (2g + 1) =
    far + a value below far's last kept bit, and its row lies 1 above both
    in every column, so near is nearer, by about 0.65 (limb 1) or 2.5e-3
    (limb 2) at D = 768. A product that drops limb 1 or limb 2 sees near
    as far, or farther, and ranks far first."""
    rng = np.random.default_rng(seed)
    v = 4 + rng.integers(0, 64, (groups, dim)) / 16  # bf16 values: limbs 1, 2 zero
    r1 = (1 + rng.integers(0, 128, (groups, dim)) / 128) / 64  # below v's last bit, 2^-5
    r2 = rng.integers(128, 256, (groups, dim)) / 2 ** 21  # below r1's last bit, 2^-13
    odd = (np.arange(groups) % 2 == 1)[:, None]
    far = v + np.where(odd, r1, 0)
    near = far + np.where(odd, r2, r1)
    cents = np.stack([far, near], 1).reshape(2 * groups, dim).astype(np.float32)
    x = torch.from_numpy((v + 1).astype(np.float32)).to(dev).to(torch.bfloat16)
    return x, torch.from_numpy(cents).to(dev)


def knn_lower_limb_case(torch, dev, groups: int, dim: int, seed: int = 6):
    """K2's tensor tier, lower limbs of the f32 queries: query g's nearest
    bf16 row (2g + 1, b) is told from row 2g (a) only by limb 1 (even
    groups) or only by limb 2 (odd groups) of the kernel's truncating
    split. a and b lie at m -+ 4w (w = +-1 by alternating column), the
    query at m + r1 + r2 with limbs exactly m, r1, r2, so b is nearer by 16
    sum(w (r1 + r2)) in squared distance: limb-1 groups take r2 = 0 and a
    larger r1 where w = 1, limb-2 groups equal r1 in a column pair and a
    larger r2 where w = 1. m is one column pattern plus g / 16 (bf16, below
    10.5, rows below 14.5: 1/16 steps are exact), so other groups' rows are
    farther by at least D / 256. A product without the deciding limb sees a
    tie (a, the lower index, first) or a nearer a."""
    rng = np.random.default_rng(seed)
    m = 4 + rng.integers(0, 40, (1, dim)) / 16 + (np.arange(groups) / 16)[:, None]  # < 10.5
    w = np.where(np.arange(dim) % 2 == 0, 1.0, -1.0)[None, :]
    odd = (np.arange(groups) % 2 == 1)[:, None]
    j = rng.integers(0, 64, (groups, dim // 2)).repeat(2, axis=1)
    j1 = np.where(odd, j, j + np.where(w > 0, 64, 0))
    r1 = (128 + j1) / 8192  # 8 bits in [2^-6, 2^-5): limb 1
    r2 = np.where(odd, np.where(w > 0, rng.integers(112, 128, (groups, dim)),
                                rng.integers(64, 80, (groups, dim))), 0) / 2 ** 20  # limb 2
    q = (m + r1 + r2).astype(np.float32)
    rows = np.stack([m - 4 * w, m + 4 * w], 1).reshape(2 * groups, dim)  # bf16: 1/16 steps
    return (torch.from_numpy(q).to(dev),
            torch.from_numpy(rows.astype(np.float32)).to(dev).to(torch.bfloat16))


def phase_ivf_kernels(torch, dim: int, cap: int, n_rows: int = 65_536, nlists: int = 1024):
    """K5 ivf_assign and the K4 update against their plain versions on the
    card at the training's shapes: 65,536 bf16 rows (a k-means sample, or
    one tile of the full assignment gathered from a [cap, D] corpus) and
    1,024 f32 centroids, the means of one k-means step as the training's
    are, so limb planes 1 and 2 hold data; then rows whose nearest centroid
    only limb 1 or limb 2 tells apart."""
    from surrealdb_tpu_torch.idx import ivf as IVF
    from surrealdb_tpu_torch.ops import distances as D

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(2)
    matrix = torch.from_numpy(gen_corpus(cap, dim, seed=3)).to(dev).to(torch.bfloat16)
    idx = torch.randint(-5, cap + 5, (n_rows,), generator=g, dtype=torch.int32).to(dev)
    x = matrix[:n_rows].contiguous()
    seeds = matrix[torch.randperm(cap, generator=g)[:nlists].to(dev)].float().contiguous()
    # one plain k-means step: means of bf16 rows use the whole f32 mantissa
    cents = IVF.kmeans_update_plain(x, IVF.assign_plain(x, seeds, 1), seeds)[0].contiguous()
    _, l1, l2 = limb_split(torch, cents)
    limb1_share, limb2_share = float((l1 != 0).float().mean()), float((l2 != 0).float().mean())
    emit("k5_centroids", c=nlists, d=dim, limb1_nonzero_share=limb1_share,
         limb2_nonzero_share=limb2_share)
    require(limb1_share > 0.5 and limb2_share > 0.5,
            "the K5 check's centroids leave limb planes 1 and 2 mostly zero")
    del seeds, l1, l2
    k5_err = 0.0
    for gather in (False, True):
        rows = matrix[idx.long().clamp(0, cap - 1)] if gather else x
        d = D.pairwise_distance_plain(rows, cents, "euclidean")
        for k in (1, 2):
            got = IVF._assign_gather(matrix, idx, cents, k) if gather else IVF._assign_chunk(x, cents, k)
            torch.cuda.synchronize()
            want = IVF.assign_plain(matrix, cents, k, idx=idx) if gather else IVF.assign_plain(x, cents, k)
            ok, err = ids_equal_up_to_ties(got, want, d)
            emit("k5_check", rows=n_rows, cap=cap if gather else n_rows, c=nlists, d=dim,
                 k_assign=k, index_vector=gather, ids_equal=bool(torch.equal(got, want)),
                 max_abs_err=err, ok=ok)
            require(ok, f"ivf_assign k={k} gather={gather} disagrees with its plain version")
            k5_err = max(k5_err, err)
        del d, rows
    # the nearest centroid told apart only by limb 1 or limb 2, at the
    # main path's C and D; the plain version on centroids cut to one or to
    # two limbs is the control: it must fail the same comparison
    lx, lc = lower_limb_case(torch, dev, nlists // 2, dim)
    lidx = torch.randperm(lx.shape[0], generator=g).to(dev).int()
    cut = limb_split(torch, lc)
    for gather in (False, True):
        rows = lx[lidx.long()] if gather else lx
        d = D.pairwise_distance_plain(rows, lc, "euclidean")
        for k in (1, 2):
            got = IVF._assign_gather(lx, lidx, lc, k) if gather else IVF._assign_chunk(lx, lc, k)
            torch.cuda.synchronize()
            want = IVF.assign_plain(rows, lc, k)
            ok, err = ids_equal_up_to_ties(got, want, d)
            controls = {f"{n}_limb_control_fails": not ids_equal_up_to_ties(
                IVF.assign_plain(rows, c, k), want, d)[0]
                for n, c in (("one", cut[0]), ("two", cut[0] + cut[1]))}
            emit("k5_check", rows=lx.shape[0], c=lc.shape[0], d=dim, k_assign=k,
                 index_vector=gather, lower_limbs=True, ids_equal=bool(torch.equal(got, want)),
                 max_abs_err=err, **controls, ok=ok and all(controls.values()))
            require(ok, f"ivf_assign k={k} gather={gather} disagrees with its plain version "
                    "where limb 1 or 2 decides")
            require(all(controls.values()), "the lower-limb case does not tell a one- or "
                    "two-limb product from the f32 one")
            k5_err = max(k5_err, err)
        del d, rows
    del lx, lc, lidx, cut
    # rows holding +inf, -inf and NaN; columns 2 and 7 of the centroids on
    # the bf16 grid, so there the zero limbs 1, 2 meet the infs on the
    # tensor cores (inf x 0 = NaN); such products are recomputed as f32 FMA
    # chains, and the ids equal the plain version's (a NaN distance first)
    bad = x[:256].clone()
    bad[3, 7], bad[4, 2], bad[5, 11] = float("inf"), float("-inf"), float("nan")
    nf_cents = cents.clone()
    nf_cents[:, [2, 7]] = nf_cents[:, [2, 7]].bfloat16().float()
    rows = [3, 4, 5]
    rest = [i for i in range(bad.shape[0]) if i not in rows]
    for k in (1, 2):
        got = IVF._assign_chunk(bad, nf_cents, k)
        torch.cuda.synchronize()
        want = IVF.assign_plain(bad, nf_cents, k)
        ok_bad = bool(torch.equal(got[rows], want[rows]))
        ok, err = ids_equal_up_to_ties(got[rest], want[rest],
                                       D.pairwise_distance_plain(bad[rest], nf_cents, "euclidean"))
        emit("k5_check", rows=bad.shape[0], c=nlists, d=dim, k_assign=k, index_vector=False,
             nonfinite_rows=rows, nonfinite_ids_equal=ok_bad, max_abs_err=err, ok=ok and ok_bad)
        require(ok and ok_bad, f"ivf_assign k={k} on rows holding inf / NaN disagrees with its "
                "plain version")
    del bad, nf_cents
    a = IVF._assign_chunk(x, cents, 1)
    k4 = k4_assignments(torch, x, nlists)
    first, seeds = k4["first_step"]
    skewed = first.clone()
    skewed[torch.rand(n_rows, generator=g).to(dev) < 0.9] = 3  # one centroid: 90% of the rows
    # the K4 update: the current case (the assignment to one step's means
    # from rows of the corpus), the training's first step (to rows of x),
    # 90% of the rows in one centroid, and every odd centroid empty
    k4_err = 0.0
    for case, ka, kc in (("means_of_corpus_seeds", a, cents), ("first_step", first, seeds),
                         ("skewed", skewed, seeds), ("empty", first & ~1, seeds)):
        got_c, got_n = IVF.kmeans_update(x, ka, kc)
        torch.cuda.synchronize()
        want_c, want_n = IVF.kmeans_update_plain(x, ka, kc)
        err = float((got_c - want_c).abs().max())
        counts_equal = bool(torch.equal(got_n, want_n))
        ok = bool(torch.allclose(got_c, want_c, **TOL)) and counts_equal
        again = IVF.kmeans_update(x, ka, kc)[0]
        deterministic = bool(torch.equal(again, got_c))
        emit("k4_check", case=case, rows=n_rows, c=nlists, d=dim, max_abs_err=err,
             counts_equal=counts_equal, largest_count=int(want_n.max()),
             empty_clusters=int((want_n == 0).sum()), deterministic=deterministic, ok=ok)
        require(ok, f"ivf_kmeans_update ({case}) disagrees with its plain version")
        require(deterministic, f"ivf_kmeans_update ({case}) is not deterministic")
        k4_err = max(k4_err, err)
    return dict(matrix=matrix, idx=idx, x=x, cents=cents, assign=a, k4=k4), k5_err, k4_err


def k4_assignments(torch, x, nlists: int, seed: int = 2):
    """The K4 update's two timed inputs over the rows x [n, D]: {name:
    (assignment, centroids)} for the training's first step (nlists random
    rows of x, as _kmeans_xs seeds it; "first_step") and its second (the
    plain means of that step; "means"). scripts/k3_k7_timing.py builds the
    same two."""
    from surrealdb_tpu_torch.idx import ivf as IVF

    g = torch.Generator().manual_seed(seed)
    seeds = x[torch.randperm(x.shape[0], generator=g)[:nlists].to(x.device)].float().contiguous()
    first = IVF._assign_chunk(x, seeds, 1)
    means = IVF.kmeans_update_plain(x, first, seeds)[0].contiguous()
    return {"first_step": (first, seeds), "means": (IVF._assign_chunk(x, means, 1), means)}


def k4_update_timing(torch, x, a, c):
    """K4's update on one assignment: the largest count, event and queued
    ms, the kernels a call (torch.profiler), the plain version, the bound
    (rows, assignment, c_old and c_new once; bytes) and, beside it, the
    bytes the design also moves (its row-id scratch and the heavy
    centroids' partial sums, written and read back), and
    `index_reduce_(..., "mean")` as the one-call yardstick, with the upcast
    of x in the call and on a pre-cast x."""
    import re

    from surrealdb_tpu_torch.idx import ivf as IVF
    from surrealdb_tpu_torch.ops import _cuda

    n, dim = x.shape
    nl = c.shape[0]
    counts = torch.bincount(a.long(), minlength=nl)
    with open(os.path.join(_cuda.CSRC, "ivf.cu")) as f:
        item_rows = int(re.search(r"constexpr int UP_ITEM = (\d+);", f.read()).group(1))
    heavy_items = int(((counts + item_rows - 1) // item_rows)[counts > item_rows].sum())
    nbytes = n * dim * x.element_size() + n * 4 + 2 * nl * dim * 4 + nl * 4
    design_bytes = nbytes + 2 * heavy_items * dim * 4 + 3 * n * 4
    bound, by = bound_ms(nbytes, n * dim, "bfloat16")
    al, xf = a.long(), x.float()

    def library(rows, idx):
        return c.clone().index_reduce_(0, idx, rows, "mean", include_self=False)

    run_k = lambda: IVF.kmeans_update(x, a, c)  # noqa: E731
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # index_reduce_ is in beta
        lib_err = float((library(xf, al) - IVF.kmeans_update_plain(x, a, c)[0]).abs().max())
        lib_cast = lambda: library(x.float(), a.long())  # noqa: E731
        lib_nocast = lambda: library(xf, al)  # noqa: E731
        return dict(
            largest_count=int(counts.max()), empty_clusters=int((counts == 0).sum()),
            heavy_items=heavy_items, ms=median_ms(run_k),
            queued_ms=queued_device_ms(torch, run_k),
            kernels_a_call=kernels_per_call(torch, run_k),
            plain_ms=median_ms(lambda: IVF.kmeans_update_plain(x, a, c), iters=5),
            bound_ms=bound, bound_by=by, design_bytes_ms=design_bytes / HBM_BYTES_PER_S * 1e3,
            library_ms=median_ms(lib_cast), library_queued_ms=queued_device_ms(torch, lib_cast),
            library_nocast_ms=median_ms(lib_nocast),
            library_nocast_queued_ms=queued_device_ms(torch, lib_nocast),
            library_max_abs_err=lib_err,
        )


def phase_ivf_timing(torch, inputs, dim: int):
    """Median times of K5 (both launch forms) and of K4 (a whole k-means
    step, and its update alone) at the training's shapes."""
    from surrealdb_tpu_torch.idx import ivf as IVF

    matrix, idx, x, cents, a = (inputs[k] for k in ("matrix", "idx", "x", "cents", "assign"))
    n, nl = x.shape[0], cents.shape[0]
    flops = 2.0 * n * nl * dim
    # the kernel's f32-accurate product: three bf16 limb passes on the
    # tensor cores, as K10's wide path counts it; one pass beside it
    limb_flops = 3 * flops
    out = {}
    for name, k, gather in (("ivf_assign", 2, True), ("ivf_assign_rows_k1", 1, False)):
        nbytes = n * dim * 2 + nl * dim * 4 + n * k * 4 + (n * 4 if gather else 0)
        bound, by = bound_ms(nbytes, limb_flops, "bfloat16")
        single, single_by = bound_ms(nbytes, flops, "bfloat16")
        if gather:
            run = lambda: IVF._assign_gather(matrix, idx, cents, k)  # noqa: E731
            plain = lambda: IVF.assign_plain(matrix, cents, k, idx=idx)  # noqa: E731
            rows = lambda: matrix[idx.long().clamp(0, matrix.shape[0] - 1)].float()  # noqa: E731
        else:
            run = lambda: IVF._assign_chunk(x, cents, k)  # noqa: E731
            plain = lambda: IVF.assign_plain(x, cents, k)  # noqa: E731
            rows = lambda: x.float()  # noqa: E731
        out[name] = dict(
            ms=median_ms(run), queued_ms=queued_device_ms(torch, run, iters=10),
            plain_ms=median_ms(plain, iters=5),
            library_ms=median_ms(lambda: torch.topk(torch.cdist(rows(), cents), k, largest=False),
                                 iters=5),
            bound_ms=bound, bound_by=by, single_pass_bound_ms=single,
            single_pass_bound_by=single_by, k_assign=k, index_vector=gather,
        )
    step_bytes = n * dim * 2 + 2 * nl * dim * 4 + nl * 4
    step_bound, step_by = bound_ms(step_bytes, limb_flops + n * dim, "bfloat16")
    by_assignment = {name: k4_update_timing(torch, x, ka, kc)
                     for name, (ka, kc) in inputs["k4"].items()}
    means = by_assignment["means"]
    out["ivf_kmeans_update"] = dict(
        ms=median_ms(lambda: IVF._kmeans_step(x, cents, nl)),
        plain_ms=median_ms(lambda: IVF.kmeans_update_plain(
            x, IVF.assign_plain(x, cents, 1), cents), iters=5),
        library_ms=None, bound_ms=step_bound, bound_by=step_by,
        single_pass_bound_ms=bound_ms(step_bytes, flops + n * dim, "bfloat16")[0],
        update_ms=means["ms"], update_queued_ms=means["queued_ms"],
        update_plain_ms=means["plain_ms"], update_bound_ms=means["bound_ms"],
        update_bound_by=means["bound_by"], update_library_ms=means["library_ms"],
        update_by_assignment=by_assignment,
    )
    emit("timing_ivf", rows=n, c=nl, d=dim, corpus="bfloat16", **out)
    return out


# K3 with k above its candidate count probes this many lists (k = 4 L + 7,
# L the longest list): the same rank merge as at the main path's nprobe of
# 6, over two thirds of its candidates (at 6 lists those six checks took
# 115 s of the script's 1,200 on an H100, at 4 lists 50 s)
K3_LARGE_K_NPROBE = 4


def check_ivf_search(torch, ivf, matrix, queries, nprobe: int):
    """K3 (the probe, ivf_rerank and the merge) against its plain version on
    the trained state: Q in {1, 8, 64}, euclidean and cosine, bf16 rows and
    an f32 copy of them, a slot_ok that masks a third of the slots, k = 10,
    k = 200 and (bf16 rows) k above the candidate count (over
    K3_LARGE_K_NPROBE probed lists). Ids must agree up to ties at the k-th
    distance, misses (-1 / +inf) exactly and distances within TOL; a query
    whose probed lists differ at a tie of the nprobe-th centroid distance
    is counted and left out. The rerank's two modes
    (pair-major, list-major) must give the same picks bit for bit, on
    every query. The queries are fresh points of the corpus's clusters, not
    the main path's near-duplicates: close to a zero distance the sqrt
    amplifies the cancellation in |q|^2 + |x|^2 - 2 q.x (|x|^2 ~ 860
    here), which any two f32 summation orders expose beyond TOL."""
    from surrealdb_tpu_torch.idx import ivf as IVF
    from surrealdb_tpu_torch.ops import distances as D

    dev = matrix.device
    cents, list_rows, list_mask, probe_ok = ivf._device(dev)
    cap = matrix.shape[0]
    slot_ok = (torch.arange(cap, device=dev) % 3) != 0
    lmax = int(list_rows.shape[1])
    err_max, checks, probe_ties = 0.0, 0, 0
    for rows_dtype in ("bfloat16", "float32"):
        x = matrix if rows_dtype == "bfloat16" else matrix.float()
        # k above the candidates (the rank merge) on the bf16 rows only
        cases = [(nprobe, (10, 200))] + ([(K3_LARGE_K_NPROBE, (K3_LARGE_K_NPROBE * lmax + 7,))]
                                         if rows_dtype == "bfloat16" else [])
        for metric in ("euclidean", "cosine"):
            for nq in (1, 8, 64):
                q = torch.from_numpy(np.ascontiguousarray(queries[:nq], dtype=np.float32)).to(dev)
                for npr, ks in cases:
                    pd = D.pairwise_distance_plain(q, cents, metric)
                    pv, pp = D._topk_min_stable(pd, npr)
                    _, kp = D.knn_search(q, cents, probe_ok, metric, npr)
                    same = (kp.sort(1).values == pp.sort(1).values).all(1)
                    for r in (~same).nonzero()[:, 0].tolist():
                        diff = set(kp[r].tolist()) ^ set(pp[r].tolist())
                        kth = float(pv[r, -1])
                        band = TOL["atol"] + TOL["rtol"] * abs(kth)
                        require(all(abs(float(pd[r, c]) - kth) <= band for c in diff),
                                f"K3 probe of query {r} differs beyond a tie")
                    if rows_dtype == "bfloat16" and npr == nprobe:
                        probe_ties += int((~same).sum())
                    for k in ks:
                        got_d, got_i = IVF._ivf_search(q, cents, list_rows, list_mask, x, slot_ok,
                                                       metric=metric, probe_metric=metric, k=k,
                                                       nprobe=npr, probe_ok=probe_ok)
                        modes = {m: IVF._ivf_rerank(q, kp, list_rows, list_mask, x, slot_ok, metric,
                                                    k, mode=m) for m in IVF.RERANK_MODES}
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        bit_equal = all(torch.equal(v[0], got_d) and torch.equal(v[1], got_i)
                                        for v in modes.values())
                        want_d, want_i = IVF.ivf_search_plain(q, cents, list_rows, list_mask, x,
                                                              slot_ok, metric, metric, k, npr)
                        s = same
                        gd, gi, wd, wi = got_d[s], got_i[s], want_d[s], want_i[s]
                        miss = torch.isinf(wd)
                        miss_ok = bool(torch.equal(torch.isinf(gd), miss)) and bool(
                            torch.equal(gi[miss], wi[miss]))
                        fin = ~miss
                        err = float((gd[fin] - wd[fin]).abs().max()) if bool(fin.any()) else 0.0
                        d_ok = bool(torch.allclose(gd[fin], wd[fin], **TOL))
                        id_ok = ids_match_up_to_ties(
                            gd.cpu().numpy(), gi.cpu().numpy(), wd.cpu().numpy(), wi.cpu().numpy(),
                            finite_kth=True,
                        )
                        emit("k3_check", rows=rows_dtype, metric=metric, q=nq, k=k,
                             k_served=int(got_d.shape[1]), nprobe=npr, L=lmax,
                             probe_tie_queries=int((~s).sum()), misses=int(miss.sum()),
                             max_abs_err=err, ids_equal=bool(torch.equal(gi, wi)),
                             modes_bit_equal=bit_equal, ok=miss_ok and d_ok and id_ok and bit_equal)
                        require(miss_ok and d_ok and id_ok,
                                f"K3 {rows_dtype} {metric} Q={nq} k={k} disagrees with its plain "
                                "version")
                        require(bit_equal, f"K3 {rows_dtype} {metric} Q={nq} k={k}: the rerank's "
                                "modes differ")
                        err_max = max(err_max, err)
                        checks += 1
        del x
    return err_max, checks, probe_ties


K3_KERNELS_A_TILE = {"knn_select": 2, "ivf_rerank": 1, "mesh_topk_merge": 1}


def time_ivf_search(torch, ivf, matrix, queries, nprobe: int, k: int, dim: int):
    """Median times of K3 (probe, ivf_rerank, merge), by events and queued,
    at the main path's launch shapes (Q in {1, 8, 64}, all slots ok,
    euclidean), in the plan's mode and in each mode forced, with its bound
    from this run's probed lists: the queries and centroids, each distinct
    probed list's mask bytes and, for each of its members, its slot, its
    slot_ok byte and its row, once however many queries probe it, and the
    picks; the operations a product a (query, member) pair and the probe's.
    The kernels a call come from the wrappers' counts."""
    from surrealdb_tpu_torch.idx import ivf as IVF
    from surrealdb_tpu_torch.ops import _cuda
    from surrealdb_tpu_torch.ops import distances as D

    dev = matrix.device
    cents, list_rows, list_mask, probe_ok = ivf._device(dev)
    slot_ok = ivf._all_slots(int(matrix.shape[0]), dev)
    nl, lmax = int(cents.shape[0]), int(list_rows.shape[1])
    lens = np.array([len(l) for l in ivf.lists])
    out = {}
    for nq in (1, 8, 64):
        q = torch.from_numpy(np.ascontiguousarray(queries[:nq], dtype=np.float32)).to(dev)
        _, probes = D.knn_search(q, cents, probe_ok, "euclidean", nprobe)
        pr = probes.cpu().numpy()
        cand = int(lens[pr].sum())  # (query, member) pairs of this run: the products
        probed = np.unique(pr)
        rows_read = int(lens[probed].sum())
        nbytes = (nq * dim * 4 + nl * dim * 4 + probed.size * lmax + rows_read * (5 + dim * 2)
                  + nq * k * 8)
        flops = 2.0 * nq * nl * dim + 2.0 * cand * dim
        bound, by = bound_ms(nbytes, flops, "bfloat16")
        args = (q, cents, list_rows, list_mask, matrix, slot_ok)
        kw = dict(metric="euclidean", probe_metric="euclidean", k=k, nprobe=nprobe)
        call = lambda: IVF._ivf_search(*args, probe_ok=probe_ok, **kw)  # noqa: E731
        before = read_launches()
        call()
        torch.cuda.synchronize()
        launched = {c: v - before[c] for c, v in read_launches().items() if v - before[c]}
        kernels = sum(K3_KERNELS_A_TILE.get(c, 99) * v for c, v in launched.items())
        require(set(launched) == set(K3_KERNELS_A_TILE) and kernels == 4,
                f"K3 at Q={nq} launched {launched}: {kernels} kernels a call")
        by_mode = {}
        for m in IVF.RERANK_MODES:
            rr = lambda: IVF._ivf_rerank(q, probes, list_rows, list_mask, matrix,  # noqa: E731
                                         slot_ok, "euclidean", k, mode=m)
            by_mode[m] = dict(rerank_ms=median_ms(rr), rerank_queued_ms=queued_device_ms(torch, rr))
        out[nq] = dict(
            ms=median_ms(call), queued_ms=queued_device_ms(torch, call),
            plain_ms=median_ms(lambda: IVF.ivf_search_plain(*args, **kw), iters=5),
            library_ms=None, bound_ms=bound, bound_by=by, candidate_rows=cand,
            probed_lists=int(probed.size), rows_read=rows_read,
            mode=IVF.rerank_plan(_cuda.lib(), nq, 1, nprobe, lmax, min(k, nprobe * lmax), dim,
                                 int(matrix.dtype == torch.bfloat16))[0],
            launches=launched, kernels=kernels, by_mode=by_mode,
        )
        emit("timing_k3", q=nq, nlists=nl, nprobe=nprobe, L=lmax, k=k, **out[nq])
    return out


# ------------------------------------------------------------------ main paths
def layer_spans(strategy):
    """The engine's own duration histograms (telemetry.observe) along the
    kNN path (or, with no strategy, any SELECT's), outermost first."""
    knn = () if strategy is None else (
        f'knn_search_duration_seconds{{strategy="{strategy}"}}',)
    return (
        'statement_duration_seconds{kind="SelectStatement"}',
        "plan_duration_seconds",
        *knn,
        "dispatch_queue_wait_duration_seconds",
        "dispatch_launch_duration_seconds",
        "dispatch_pipeline_wait_duration_seconds",
        "dispatch_collect_duration_seconds",
    )


def layer_means_ms(before: dict, after: dict, strategy: str) -> dict:
    """Mean ms a call of each layer span over the calls between two
    telemetry snapshots."""
    out = {}
    for name in layer_spans(strategy):
        a, b = after.get(name), before.get(name, {"count": 0, "sum": 0.0})
        if a and a["count"] > b["count"]:
            out[name.split("{")[0].replace("_duration_seconds", "")] = (
                (a["sum"] - b["sum"]) / (a["count"] - b["count"]) * 1e3
            )
    return out


def window_start(torch, device):
    """Start the timed window's device-memory accounting: the peak from
    here on, and the bytes already allocated (None on the CPU)."""
    if device != "cuda":
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _describe_holder(ref, child, module_dicts) -> str:
    """One link of a holder chain: how `ref` holds `child`."""
    import types

    if isinstance(ref, dict):
        key = next((k for k, v in ref.items() if v is child), "?")
        owner = module_dicts.get(id(ref))
        return f"module {owner}.{key}" if owner else f"dict[{key!r}]"[:80]
    if isinstance(ref, types.FrameType):
        return f"frame {ref.f_code.co_name} {os.path.basename(ref.f_code.co_filename)}:{ref.f_lineno}"
    if isinstance(ref, types.FunctionType):
        return f"function {ref.__qualname__}"
    if isinstance(ref, (tuple, list)):
        kinds = ", ".join(type(x).__name__ for x in ref[:6])
        return f"{type(ref).__name__}({len(ref)}: {kinds})"
    return type(ref).__qualname__


def tensor_holders(torch, min_bytes: int = 1 << 28, depth: int = 24, width: int = 16,
                   budget: int = 96):
    """What keeps each live CUDA tensor of at least min_bytes alive: chains
    of gc.get_referrers links from the tensor outwards, as text. A module
    global or a frame ends a chain; a chain still open at `depth`, or with
    no referrer left, ends in "(open)": its holder is invisible to gc (the
    local of another thread's running frame, or a C++ reference). Each
    get_referrers call scans every object, so a tensor gets `budget` calls."""
    import types

    module_dicts = {id(m.__dict__): name for name, m in list(sys.modules.items())
                    if m is not None and hasattr(m, "__dict__")}
    here = sys._getframe()
    # this function's own containers, never a holder; kept alive in `pinned`
    # so that no later object reuses one of their ids
    mine, pinned = set(), []

    def own(*objs):
        pinned.extend(objs)
        mine.update(id(o) for o in objs)

    objs = gc.get_objects()
    big = []
    for obj in objs:
        try:
            if isinstance(obj, torch.Tensor) and obj.is_cuda and (
                obj.element_size() * obj.nelement() >= min_bytes
            ):
                big.append(obj)
        except Exception:  # noqa: BLE001 — objects mid-teardown
            continue
    del objs
    own(big, pinned)
    found = {}
    for t in big:
        label = f"{str(t.dtype).split('.')[-1]}{list(t.shape)}"
        level, paths, chains, seen = [t], [label], [], {id(t)}
        calls = 0
        for _ in range(depth):
            nxt, nxt_paths = [], []
            own(level, paths, nxt, nxt_paths)
            for i in range(min(len(level), budget - calls)):
                calls += 1
                refs = gc.get_referrers(level[i])
                own(refs)
                grew = False
                for r in refs:
                    if id(r) in mine or id(r) in seen or r is here:
                        continue
                    seen.add(id(r))
                    grew = True
                    link = f"{paths[i]} <- {_describe_holder(r, level[i], module_dicts)}"
                    if isinstance(r, types.FrameType) or (
                            isinstance(r, dict) and id(r) in module_dicts):
                        chains.append(link)
                    elif len(nxt) < width:
                        nxt.append(r)
                        nxt_paths.append(link)
                if not grew:
                    chains.append(f"{paths[i]} (open)")
            level, paths = nxt, nxt_paths
            if not level or calls >= budget:
                break
        chains += [f"{p} (open)" for p in paths]
        found.setdefault(label, []).extend(chains)
    return found


def make_queries(corpus, n, seed, noise=0.05):
    """Queries near corpus rows: a row plus gaussian noise of scale `noise`
    (0.05: the main paths' near-duplicates; CLUSTER_SIGMA: a fresh point of
    the row's cluster)."""
    rng = np.random.default_rng(seed + 1)
    qidx = rng.integers(0, corpus.shape[0], size=n)
    return corpus[qidx] + rng.standard_normal((n, corpus.shape[1])).astype(np.float32) * noise


def strategies():
    from surrealdb_tpu_torch import telemetry

    return {
        lab: v for lab, v in telemetry.snapshot()["counters"].items()
        if lab.startswith("knn_strategy")
    }


def strategy_delta(before: dict) -> dict:
    after = strategies()
    return {lab: v - before.get(lab, 0) for lab, v in after.items() if v - before.get(lab, 0)}


def kernel_counters():
    from surrealdb_tpu_torch.idx import graph_csr as G
    from surrealdb_tpu_torch.idx import ivf as IVF
    from surrealdb_tpu_torch.ml import model as ML
    from surrealdb_tpu_torch.ops import bm25 as B
    from surrealdb_tpu_torch.ops import distances as D
    from surrealdb_tpu_torch.parallel import mesh as M

    return D.KERNELS + IVF.KERNELS + G.KERNELS + B.KERNELS + ML.KERNELS + M.KERNELS


def read_launches() -> dict:
    return {c.name: c.launches for c in kernel_counters()}


def reset_launches() -> None:
    for c in kernel_counters():
        c.reset()


def sql_runner(ds):
    def run(sql, vars=None):
        res = ds.execute(sql, vars=vars or {})
        for r in res:
            if r.get("status") != "OK":  # the message only then: a result can be 2^20 rows
                require(False, f"{sql[:60]!r} failed: {r}")
        return res[-1]["result"]

    return run


def ingest(run, corpus, batch: int, lo: int = 0, hi: int = None) -> float:
    """INSERT rows lo..hi of the corpus (record ids = row numbers) in
    batches; returns the seconds spent in INSERT."""
    hi = corpus.shape[0] if hi is None else hi
    total = 0.0
    for i in range(lo, hi, batch):
        rows = [{"id": j, "emb": corpus[j]} for j in range(i, min(i + batch, hi))]
        t = time.perf_counter()
        run("INSERT INTO item $rows RETURN NONE", {"rows": rows})
        total += time.perf_counter() - t
    return total


class GcPauses:
    """Python garbage-collector pauses inside a window (gc.callbacks): a
    full collection over a million stored documents stalls every thread."""

    def __init__(self):
        self.pauses = []  # (generation, seconds)
        self._t0 = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses.append((info["generation"], time.perf_counter() - self._t0))

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        by_gen = {}
        for g, s in self.pauses:
            n, tot, mx = by_gen.get(str(g), (0, 0.0, 0.0))
            by_gen[str(g)] = (n + 1, tot + s * 1e3, max(mx, s * 1e3))
        return {g: {"collections": n, "total_ms": tot, "max_ms": mx}
                for g, (n, tot, mx) in sorted(by_gen.items())}


def drive_queries(ask, n_total, n_seq, n_threads, rounds, strategy):
    """24-style sequential queries, then n_threads closed-loop clients x
    rounds; ask(i) runs query i. Returns the results and the timing of both
    parts."""
    with GcPauses() as gcp:
        results, out = _drive_queries(ask, n_total, n_seq, n_threads, rounds, strategy)
    out["gc_pauses"] = gcp.summary()
    return results, out


def _drive_queries(ask, n_total, n_seq, n_threads, rounds, strategy):
    from surrealdb_tpu_torch import telemetry

    results = [None] * n_total
    seq_lat = []
    spans0 = telemetry.snapshot()["histograms"]
    for i in range(n_seq):
        t = time.perf_counter()
        results[i] = ask(i)
        seq_lat.append(time.perf_counter() - t)
    layers = layer_means_ms(spans0, telemetry.snapshot()["histograms"], strategy)
    conc_lat = []
    lat_lock = threading.Lock()
    errors = []

    def client(ti):
        try:
            for r in range(rounds):
                qi = n_seq + r * n_threads + ti
                t1 = time.perf_counter()
                res = ask(qi)
                with lat_lock:
                    conc_lat.append(time.perf_counter() - t1)
                results[qi] = res
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(ti,)) for ti in range(n_threads)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    conc_wall = time.perf_counter() - t
    require(not any(th.is_alive() for th in threads), "concurrent clients hung")
    if errors:
        raise errors[0]
    n_conc = n_threads * rounds
    return results, dict(
        seq_queries=n_seq, seq_p50_ms=statistics.median(seq_lat) * 1e3,
        seq_max_ms=max(seq_lat) * 1e3, seq_slowest=int(np.argmax(seq_lat)),
        seq_qps=n_seq / sum(seq_lat), seq_layer_mean_ms=layers,
        concurrent_clients=n_threads, rounds=rounds,
        conc_p50_ms=statistics.median(conc_lat) * 1e3 if n_conc else None,
        conc_qps=n_conc / conc_wall if n_conc else None,
    )


def recall_of(results, truth, k):
    recalls = []
    for i, res in enumerate(results):
        require(res is not None and len(res) == k, f"query {i} returned {res!r}")
        got = {int(r["id"].id) for r in res}
        recalls.append(len(got & set(truth[i].tolist())) / k)
    return float(np.mean(recalls))


def dispatched_tiles(ds, widths0):
    from surrealdb_tpu_torch.utils.num import dispatch_tile, tile_slices

    widths1 = ds.dispatch.width_distribution()
    widths = {w: c - widths0.get(w, 0) for w, c in widths1.items() if c - widths0.get(w, 0)}
    tiles = sum(c * len(list(tile_slices(w, dispatch_tile(w)))) for w, c in widths.items())
    return widths, tiles


def serve_exact(torch, device: str, ds, run, sql, queries, truth, k: int,
                n_seq: int, n_threads: int, rounds: int):
    """The MTREE queries of a main path on an open Datastore whose mirror
    is on the device (its first query ran): sequential, then n_threads
    clients; every query must take `exact-device`, K2's launches must equal
    the dispatched tiles (no other kernel), recall@k >= 0.99. Returns the
    window's numbers and the results."""
    from surrealdb_tpu_torch import bg

    # the first query's background warmers launch every other tile shape of
    # this matrix once; let them finish before the counts start
    require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
    mem0 = window_start(torch, device)
    before = strategies()
    widths0 = ds.dispatch.width_distribution()
    reset_launches()
    results, timing = drive_queries(lambda i: run(sql, {"q": queries[i].tolist()}),
                                    queries.shape[0], n_seq, n_threads, rounds,
                                    "exact-device")
    # the background tile warmers launch too: wait for them to finish
    # before the counts are read
    require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
    if device == "cuda":
        torch.cuda.synchronize()
    launches = read_launches()
    widths, tiles = dispatched_tiles(ds, widths0)
    delta = strategy_delta(before)
    n_queries = queries.shape[0]
    require(
        delta == {'knn_strategy{strategy="exact-device"}': float(n_queries)},
        f"strategies {delta}, expected {n_queries} exact-device",
    )
    if device == "cuda":
        # every dispatched tile is one fused knn_search call, counted
        # under knn_select, and no K1 launch (every tile shape was
        # warmed before the counts)
        want = {c.name: 0 for c in kernel_counters()}
        want.update(knn_select=tiles)
        require(launches == want, f"launches {launches} for {tiles} dispatched tiles")
    recall = recall_of(results, truth, k)
    require(recall >= 0.99, f"recall@{k} {recall} < 0.99")
    busy = device_busy_share(torch, lambda: [
        run(sql, {"q": queries[i].tolist()}) for i in range(8)
    ]) if device == "cuda" else None
    return dict(
        **timing,
        dispatch_widths={str(w): c for w, c in sorted(widths.items())},
        tiles_dispatched=tiles, launches=launches,
        strategies=delta, recall_at_10=recall, profiled_8_seq_queries=busy,
        peak_device_memory_bytes=(
            torch.cuda.max_memory_allocated() if device == "cuda" else None
        ),
        device_memory_at_window_start_bytes=mem0,
    ), results


def phase_main_path(torch, device: str, corpus, queries, truth, batch: int,
                    n_seq: int, n_threads: int, rounds: int, then=None):
    """MTREE: exact kNN through Datastore.execute, every query `exact-device`.
    `then(ds, results, out)`, when given, runs last on the open Datastore
    (the mesh path) and its result is returned under "then"."""
    from surrealdb_tpu_torch import bg
    from surrealdb_tpu_torch.kvs.ds import Datastore

    k = 10
    n_rows, dim = corpus.shape
    ds = Datastore("memory", device=device)
    try:
        run = sql_runner(ds)
        run("DEFINE TABLE item SCHEMALESS; "
            f"DEFINE INDEX iemb ON item FIELDS emb MTREE DIMENSION {dim} DIST EUCLIDEAN")
        sql = f"SELECT id FROM item WHERE emb <|{k}|> $q"
        ingest_s = ingest(run, corpus, batch, 0, batch)
        # build the mirror from the first batch, so the rest of the ingest
        # reaches it as deltas (no 1M-row rescan later)
        run(sql, {"q": corpus[0].tolist()})
        ingest_s += ingest(run, corpus, batch, batch)

        # the first query after ingest uploads the mirror to the device
        t = time.perf_counter()
        run(sql, {"q": queries[0].tolist()})
        upload_query_s = time.perf_counter() - t
        served, results = serve_exact(torch, device, ds, run, sql, queries, truth, k,
                                      n_seq, n_threads, rounds)
        out = dict(
            rows=n_rows, dim=dim, device=str(ds.device),
            ingest_rows_per_s=n_rows / ingest_s, ingest_s=ingest_s,
            first_query_with_upload_s=upload_query_s, **served,
        )
        emit("main_path", **out)
        if then is not None:
            out["then"] = then(ds, results, out)
        return out
    finally:
        ds.close()


# ------------------------------------------------------------------ server
SERVER_CLI_ROWS = 4096  # the CLI child's MTREE rows (written over HTTP)
SERVER_SQL_QUERIES = 8  # queries sent to /sql as text
SERVER_GQL_ROWS = 6  # the small table the GraphQL query reads


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(host, port, method, path, body=None, headers=None, timeout=120):
    """One request on a fresh connection -> (status, body bytes)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(method, path, body, headers or {})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def metric_value(text: str, series: str):
    """The value of one sample of a Prometheus scrape, or None."""
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.split()[-1])
    return None


def sql_literal_query(k: int, q) -> str:
    """The kNN query with the vector written as a literal (repr keeps each
    f32 value exactly)."""
    return f"SELECT id FROM item WHERE emb <|{k}|> [{', '.join(repr(float(x)) for x in q)}]"


def server_transport(torch, device, ds, url, queries, truth, base_results, rows, k,
                     n_seq, n_threads, rounds):
    """The cell's queries through the SDK at `url` (HTTP /rpc or WS, CBOR),
    a client a thread: drive_queries' sequential and concurrent windows;
    every query `exact-device`, K2's launches equal to the dispatched tiles,
    the in-process answers up to ties, recall@k >= 0.99."""
    from surrealdb_tpu_torch import bg
    from surrealdb_tpu_torch.sdk import Surreal

    sql = f"SELECT id FROM item WHERE emb <|{k}|> $q"
    local, clients, lock = threading.local(), [], threading.Lock()

    def ask(i):
        db = getattr(local, "db", None)
        if db is None:
            db = local.db = Surreal(url, format="cbor")
            db.use("test", "test")
            with lock:
                clients.append(db)
        res = db.query(sql, {"q": queries[i].tolist()})
        require(res[-1]["status"] == "OK", f"query {i} over {url}: {res[-1]}")
        return res[-1]["result"]

    require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
    before, widths0 = strategies(), ds.dispatch.width_distribution()
    reset_launches()
    try:
        results, timing = drive_queries(ask, queries.shape[0], n_seq, n_threads, rounds,
                                        "exact-device")
    finally:
        for db in clients:
            db.close()
    require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
    if device == "cuda":
        torch.cuda.synchronize()
    launches = read_launches()
    widths, tiles = dispatched_tiles(ds, widths0)
    delta = strategy_delta(before)
    n = queries.shape[0]
    require(delta == {'knn_strategy{strategy="exact-device"}': float(n)},
            f"strategies over {url}: {delta}, expected {n} exact-device")
    if device == "cuda":
        want = {c.name: 0 for c in kernel_counters()}
        want.update(knn_select=tiles)
        require(launches == want, f"launches {launches} over {url} for {tiles} tiles")
    mirror = ds.index_stores.get("test", "test", "item", "iemb")
    equal, tied = sql_ids_up_to_ties(torch, mirror, rows, queries, results, base_results, k)
    recall = recall_of(results, truth, k)
    require(recall >= 0.99, f"recall@{k} over {url}: {recall} < 0.99")
    return dict(**timing, tiles_dispatched=tiles, launches=launches,
                dispatch_widths={str(w): c for w, c in sorted(widths.items())},
                ids_equal_queries=equal, ids_tied_queries=tied, recall_at_10=recall)


class CliChild:
    """`python -m surrealdb_tpu_torch start --bind 127.0.0.1:<free port>
    <args> memory` as a child process, its stderr in a file (so it never
    blocks on a pipe)."""

    def __init__(self, args, port=None):
        import tempfile

        self.port = port or free_port()
        here = os.path.dirname(os.path.abspath(__file__))
        self.err = tempfile.TemporaryFile(mode="w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "surrealdb_tpu_torch", "start", "--bind",
             f"127.0.0.1:{self.port}", *args, "memory"],
            cwd=here, stdout=subprocess.DEVNULL, stderr=self.err)

    def stderr(self) -> str:
        self.err.seek(0)
        return self.err.read()[-2000:]

    def wait_health(self, what: str, limit: float = 180.0) -> float:
        """Poll /health until it answers 200 -> seconds since the start."""
        while True:
            try:
                if http_call("127.0.0.1", self.port, "GET", "/health", timeout=2)[0] == 200:
                    return time.perf_counter() - self.t0
            except OSError:
                pass
            if self.proc.poll() is not None:
                raise SmokeFailure(f"{what} exited: {self.stderr()}")
            require(time.perf_counter() - self.t0 < limit, f"{what} did not come up in {limit} s")
            time.sleep(0.2)

    def stop(self, what: str) -> int:
        """SIGINT, which must end the child with code 0."""
        import signal

        self.proc.send_signal(signal.SIGINT)
        rc = self.proc.wait(timeout=60)
        require(rc == 0, f"{what} exited {rc} on SIGINT: {self.stderr()}")
        return rc

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self.err.close()


def cli_data(dim: int, rows: int, n_queries: int):
    """The CLI checks' seeded rows and queries."""
    data = gen_corpus(rows, dim, seed=7)
    return data, make_queries(data, n_queries, 7)


def sdk_insert(db, data, batch: int, what: str) -> None:
    """data's rows (ids 0..) through an SDK connection, `batch` a statement."""
    for i in range(0, data.shape[0], batch):
        res = db.query("INSERT INTO item $rows RETURN NONE", {"rows": [
            {"id": j, "emb": data[j].tolist()} for j in range(i, min(i + batch, data.shape[0]))]})
        require(res[-1]["status"] == "OK", f"{what} ingest: {res[-1]}")


def hold_to_exact_topk(torch, device, data, qs, got, k: int, what: str) -> None:
    """`got` (a list of id lists) must be numpy's exact top-k of qs over
    data as the mirror holds it (bf16 on a card), up to ties."""
    held = data
    if device == "cuda":  # the mirror's rows on the card are bf16
        held = torch.from_numpy(data).bfloat16().float().numpy()
    d = ((held[None, :, :].astype(np.float64) - qs[:, None, :]) ** 2).sum(-1)
    want_i = np.argsort(d, axis=1, kind="stable")[:, :k]
    got_i = np.array(got)
    require(got_i.shape == want_i.shape, f"{what}: answers of shape {got_i.shape}")
    require(ids_match_up_to_ties(np.take_along_axis(d, got_i, 1), got_i,
                                 np.take_along_axis(d, want_i, 1), want_i),
            f"{what}: answers differ from numpy's exact top-k beyond ties")


def server_cli_child(torch, device, dim, rows, k, n_queries):
    """`python -m surrealdb_tpu_torch start` as a child process on `device`
    (the CLI's --device; cuda is its default): the SDK over HTTP signs in,
    defines a dim-wide MTREE index, writes `rows` seeded rows and asks
    n_queries queries, each held to numpy's exact top-k over the rows as
    the mirror holds them (bf16 on a card) up to ties; its /metrics must
    show device memory in use on a card; SIGINT must end it with code 0."""
    from surrealdb_tpu_torch.sdk import Surreal

    child = CliChild(["--user", "root", "--pass", "root"]
                     + (["--device", device] if device != "cuda" else []))
    try:
        up_s = child.wait_health("the CLI server")
        data, qs = cli_data(dim, rows, n_queries)
        t = time.perf_counter()
        with Surreal(f"http://127.0.0.1:{child.port}", format="cbor") as db:
            db.signin(user="root", password="root")
            db.use("test", "test")
            db.query("DEFINE TABLE item SCHEMALESS; DEFINE INDEX iemb ON item FIELDS emb "
                     f"MTREE DIMENSION {dim} DIST EUCLIDEAN")
            sdk_insert(db, data, 1024, "CLI")
            write_s = time.perf_counter() - t
            got, lat = [], []
            for q in qs:
                t = time.perf_counter()
                res = db.query(f"SELECT id FROM item WHERE emb <|{k}|> $q", {"q": q.tolist()})
                lat.append(time.perf_counter() - t)
                require(res[-1]["status"] == "OK", f"CLI query: {res[-1]}")
                got.append(result_ids(res[-1]["result"]))
        hold_to_exact_topk(torch, device, data, qs, got, k, "the CLI server")
        status, body = http_call("127.0.0.1", child.port, "GET", "/metrics")
        mem = metric_value(body.decode(), 'surreal_device_memory_bytes_in_use{device="0"}')
        require(status == 200 and (device != "cuda" or (mem or 0) > 0),
                f"the CLI server's /metrics shows device memory {mem}")
        rc = child.stop("the CLI server")
        return dict(rows=rows, dim=dim, device=device, up_s=up_s, write_s=write_s,
                    queries=n_queries, p50_ms=statistics.median(lat) * 1e3,
                    exact_up_to_ties=True, device_memory_bytes_in_use=mem, sigint_rc=rc)
    finally:
        child.close()


def phase_main_path_server(torch, device: str, ds, queries, truth, base_results, base,
                           smi, n_seq: int, n_threads: int, rounds: int,
                           cli_rows: int = SERVER_CLI_ROWS):
    """The MTREE cell served over the network from its open Datastore
    (nothing re-ingested): net.server.Server on 127.0.0.1 with the event
    loop, then the cell's queries through the SDK over HTTP /rpc and over
    WebSocket (CBOR; server_transport), SERVER_SQL_QUERIES of them to /sql
    as text, one /metrics scrape (device memory in use, jit_cache_*), one
    GraphQL query on a small table against the same SurrealQL in process,
    and the CLI as a child process (server_cli_child). Prints each
    transport's p50 and qps beside the in-process ones of the same run."""
    from surrealdb_tpu_torch.net.server import Server
    from surrealdb_tpu_torch.sql.value import Thing

    k = 10
    t_phase = time.perf_counter()
    mirror = ds.index_stores.get("test", "test", "item", "iemb")
    rows = mirror.device_snapshot(ds.device)[0]
    srv = Server(ds, "127.0.0.1", 0, auth_enabled=False).start_background()
    try:
        require(srv.loop_mode, "the server is not on the event loop")
        out = {}
        for name, url in (("http_rpc", srv.url),
                          ("ws", srv.url.replace("http://", "ws://") + "/rpc")):
            out[name] = server_transport(torch, device, ds, url, queries, truth, base_results,
                                         rows, k, n_seq, n_threads, rounds)
            emit("main_path_server_transport", transport=name, **out[name],
                 in_process=base_timing_of(base), nvidia_smi=smi)
        # /sql: the vector as a literal in the statement's text
        hdrs = {"surreal-ns": "test", "surreal-db": "test", "Accept": "application/json"}
        before = strategies()
        got, lat = [], []
        for i in range(SERVER_SQL_QUERIES):
            t = time.perf_counter()
            status, body = http_call(srv.host, srv.port, "POST", "/sql",
                                     sql_literal_query(k, queries[i]), hdrs)
            lat.append(time.perf_counter() - t)
            res = json.loads(body)
            require(status == 200 and res[-1]["status"] == "OK", f"/sql query {i}: {res}")
            got.append([{"id": Thing("item", int(str(r["id"]).split(":", 1)[1]))}
                        for r in res[-1]["result"]])
        delta = strategy_delta(before)
        require(delta == {'knn_strategy{strategy="exact-device"}': float(SERVER_SQL_QUERIES)},
                f"/sql strategies {delta}")
        equal, tied = sql_ids_up_to_ties(torch, mirror, rows, queries[:SERVER_SQL_QUERIES],
                                         got, base_results[:SERVER_SQL_QUERIES], k)
        out["sql"] = dict(queries=SERVER_SQL_QUERIES, seq_p50_ms=statistics.median(lat) * 1e3,
                          seq_qps=SERVER_SQL_QUERIES / sum(lat), ids_equal_queries=equal,
                          ids_tied_queries=tied)
        # one scrape of /metrics
        status, body = http_call(srv.host, srv.port, "GET", "/metrics")
        text = body.decode()
        mem = metric_value(text, 'surreal_device_memory_bytes_in_use{device="0"}')
        jit = {g: metric_value(text, f"surreal_jit_cache_{g}") for g in ("hits", "misses", "size")}
        require(status == 200, f"/metrics answered {status}")
        require(device != "cuda" or (mem or 0) > 0, f"/metrics device memory in use {mem}")
        require(all(v is not None for v in jit.values()), f"/metrics jit_cache gauges {jit}")
        out["metrics"] = dict(device_memory_bytes_in_use=mem, jit_cache=jit,
                              bytes=len(body))
        # GraphQL over a small table against the same SurrealQL in process
        run = sql_runner(ds)
        run("DEFINE TABLE person SCHEMALESS; INSERT INTO person $rows RETURN NONE",
            {"rows": [{"id": i, "name": f"p{i}", "age": 20 + 3 * i}
                      for i in range(SERVER_GQL_ROWS)]})
        saved = os.environ.get("SURREAL_EXPERIMENTAL_GRAPHQL")
        os.environ["SURREAL_EXPERIMENTAL_GRAPHQL"] = "true"
        try:
            status, body = http_call(srv.host, srv.port, "POST", "/graphql", json.dumps(
                {"query": "{ person(order: {age: DESC}, limit: 4) { name age } }"}), hdrs)
        finally:
            if saved is None:
                os.environ.pop("SURREAL_EXPERIMENTAL_GRAPHQL")
            else:
                os.environ["SURREAL_EXPERIMENTAL_GRAPHQL"] = saved
        gql = json.loads(body)
        want = run("SELECT name, age FROM person ORDER BY age DESC LIMIT 4")
        require(status == 200 and gql.get("data", {}).get("person") == want,
                f"GraphQL {status} {gql} against {want}")
        out["graphql"] = dict(rows=len(want), equal=True)
    finally:
        srv.shutdown()
    out["cli"] = server_cli_child(torch, device, queries.shape[1], cli_rows, k, 8)
    out.update(in_process=base_timing_of(base), device=str(ds.device), nvidia_smi=smi,
               seconds=time.perf_counter() - t_phase)
    emit("main_path_server", **out)
    return out


def phase_main_path_hnsw(torch, device: str, corpus, queries, truth, batch: int,
                         n_seq: int, n_threads: int, rounds: int, ef: int = 64, then=None):
    """HNSW: `DEFINE INDEX … HNSW … EFC 64` queried with `<|10,64|>`. The
    first query after ingest serves exactly while the quantizer trains in
    the background (K4 k-means, K5 full assignment); every timed query then
    takes the `ivf` strategy (K2 probe, K3 rerank, the merge).
    Device recall@10 must lie within 0.01 of the host twin's
    (IvfState.search_host, numpy f32) on the same quantizer and queries.
    `then(ds, results, out)`, when given, runs last on the open Datastore
    (the ML path, then the mesh path) and its result is returned under
    "then"."""
    from surrealdb_tpu_torch import bg
    from surrealdb_tpu_torch.idx.ivf import default_nprobe
    from surrealdb_tpu_torch.kvs.ds import Datastore

    k = 10
    n_rows, dim = corpus.shape
    ds = Datastore("memory", device=device)
    try:
        run = sql_runner(ds)
        run("DEFINE TABLE item SCHEMALESS; DEFINE INDEX iemb ON item FIELDS emb "
            f"HNSW DIMENSION {dim} DIST EUCLIDEAN EFC 64")
        sql = f"SELECT id FROM item WHERE emb <|{k},{ef}|> $q"
        reset_launches()  # the main path's run: training and queries
        # build the (empty) mirror first: the whole ingest reaches it as
        # deltas, and no quantizer exists before the corpus is in
        run(sql, {"q": queries[0].tolist()})
        ingest_s = ingest(run, corpus, batch)
        mirror = ds.index_stores.get("test", "test", "item", "iemb")
        require(mirror is not None and mirror.count() == n_rows, "HNSW mirror missing rows")

        before = strategies()
        t0 = time.perf_counter()
        run(sql, {"q": queries[0].tolist()})
        first_query_s = time.perf_counter() - t0
        first = strategy_delta(before)
        require(first == {'knn_strategy{strategy="exact-device(ivf-training)"}': 1.0},
                f"first query after ingest took {first}, expected exact-device(ivf-training)")
        require(mirror.wait_ivf(600), "IVF training did not finish in 600 s")
        train_s = time.perf_counter() - t0
        if device == "cuda":
            torch.cuda.synchronize()
        train_launches = read_launches()
        ivf = mirror.ivf
        nprobe = default_nprobe(ivf.nlists, ef)
        lens = np.array([len(l) for l in ivf.lists])
        # the first IVF query builds the list tables and warms the other
        # tile shapes in the background
        run(sql, {"q": queries[0].tolist()})
        require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
        matrix = mirror.device_snapshot(ds.device)[0]
        lmax = int(ivf._device(matrix.device)[1].shape[1])
        mem0 = window_start(torch, device)
        gen0 = mirror.gen
        held = (tensor_holders(torch) if device == "cuda"
                and mem0 > 1.25 * matrix.element_size() * matrix.nelement() else None)
        before = strategies()
        widths0 = ds.dispatch.width_distribution()
        launches0 = read_launches()
        results, timing = drive_queries(lambda i: run(sql, {"q": queries[i].tolist()}),
                                        queries.shape[0], n_seq, n_threads, rounds, "ivf")
        require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
        if device == "cuda":
            torch.cuda.synchronize()
        launches1 = read_launches()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        timed = {n: launches1[n] - launches0[n] for n in launches1}
        widths, tiles = dispatched_tiles(ds, widths0)
        delta = strategy_delta(before)
        n_queries = queries.shape[0]
        require(delta == {'knn_strategy{strategy="ivf"}': float(n_queries)},
                f"strategies {delta}, expected {n_queries} ivf")
        n_assign = 8 + -(-n_rows // 65_536)  # 8 k-means steps + the full assignment's tiles
        if device == "cuda":
            # each dispatched tile: the probe (the fused K2: two kernels, one
            # count), ivf_rerank and the merge, 4 kernels; no training launch
            want = {c.name: 0 for c in kernel_counters()}
            want.update(knn_select=tiles, ivf_rerank=tiles, mesh_topk_merge=tiles)
            require(timed == want, f"launches {timed} for {tiles} dispatched tiles")
            require(train_launches["ivf_assign"] == n_assign
                    and train_launches["ivf_kmeans_update"] == 8,
                    f"training launched {train_launches}, expected {n_assign} assignments "
                    "and 8 k-means updates")
        recall = recall_of(results, truth, k)
        data, _alive, rids = mirror.host_view()
        _, hslots = ivf.search_host(queries, data, "euclidean", k, nprobe)
        host_recall = float(np.mean([
            len({int(rids[s].id) for s in row if s >= 0} & set(truth[i].tolist())) / k
            for i, row in enumerate(hslots)
        ]))
        require(abs(recall - host_recall) <= 0.01,
                f"device recall@{k} {recall} vs host twin {host_recall}")
        busy = device_busy_share(torch, lambda: [
            run(sql, {"q": queries[i].tolist()}) for i in range(8)
        ]) if device == "cuda" else None
        out = dict(
            rows=n_rows, dim=dim, device=str(ds.device),
            ingest_rows_per_s=n_rows / ingest_s, ingest_s=ingest_s,
            first_query_s=first_query_s, first_query_strategy="exact-device(ivf-training)",
            training_s=train_s, training_launches={
                n: train_launches[n] for n in ("ivf_assign", "ivf_kmeans_update")},
            nlists=ivf.nlists, nprobe=nprobe, L=lmax, list_len_mean=float(lens.mean()),
            list_len_max=int(lens.max()), **timing,
            dispatch_widths={str(w): c for w, c in sorted(widths.items())},
            tiles_dispatched=tiles, launches=timed, strategies=delta,
            recall_at_10=recall, host_twin_recall_at_10=host_recall,
            profiled_8_seq_queries=busy, peak_device_memory_bytes=peak,
            device_memory_at_window_start_bytes=mem0,
            large_tensors_at_window_start=held,
            mirror_mutations_in_window=mirror.gen - gen0,
        )
        emit("main_path_hnsw", **out)
        out["run_launches"] = read_launches()
        if device == "cuda":
            from surrealdb_tpu_torch.idx import ivf as IVF
            from surrealdb_tpu_torch.ops import distances as D
            from surrealdb_tpu_torch.parallel import mesh as M

            # K1 has no caller on the engine's paths (K2 fuses its distances)
            path = {c.name: out["run_launches"][c.name]
                    for c in (D.SELECT, M.MERGE) + IVF.KERNELS}
            require(all(v > 0 for v in path.values()),
                    f"a kernel of the HNSW path never launched: {path}")
        fresh = make_queries(corpus, 64, 7, noise=CLUSTER_SIGMA)
        k3_err, k3_checks, probe_ties = check_ivf_search(torch, ivf, matrix, fresh, nprobe)
        out.update(k3_err=k3_err, k3_checks=k3_checks, k3_probe_tie_queries=probe_ties)
        if device == "cuda":
            out["k3_timing"] = time_ivf_search(torch, ivf, matrix, queries, nprobe, k, dim)
        if then is not None:
            del matrix
            out["then"] = then(ds, results, out)
        return out
    finally:
        ds.close()


# ------------------------------------------------------------------ graph
GRAPH_NODES = 10_000  # bench.py NP_NODES at scale 1 (config 1)
GRAPH_EDGES = 1_000_000  # bench.py NE at scale 1
GRAPH_BATCH = 25_000  # bench.py ingest_person_graph's batch
CHAIN3 = "->knows->person->knows->person->knows->person"  # bench_graph_3hop
CHAIN5 = "->knows->person->knows->person->knows"  # odd: the CSC route, same count
CHAIN2 = "->knows->person->knows->person"  # friends of friends, expanded


def graph_pairs(nodes: int, edges: int, seed: int = 1):
    """The `knows` pairs of bench.py ingest_person_graph: uniform (in, out)
    person ids."""
    return np.random.default_rng(seed).integers(0, nodes, size=(edges, 2))


class GraphReference:
    """Independent numpy counts over the pairs (not the port's host twin):
    v <- bincount(dst, weights=v[src]) a hop, exact in float64."""

    def __init__(self, pairs, nodes: int):
        self.a, self.b, self.nodes = pairs[:, 0], pairs[:, 1], nodes

    def hops(self, seed: int, n: int):
        v = np.zeros(self.nodes)
        v[seed] = 1.0
        out = []
        for _ in range(n):
            v = np.bincount(self.b, weights=v[self.a], minlength=self.nodes)
            out.append(v)
        return out

    def count3(self, seed: int) -> int:
        return int(self.hops(seed, 3)[-1].sum())

    def edges_per_seed(self, seed: int) -> int:
        """bench.py bench_graph_3hop: the 1-, 2- and 3-hop path counts summed."""
        return int(sum(v.sum() for v in self.hops(seed, 3)))

    def fof_frontiers(self, seed: int):
        """Frontier sizes before each of CHAIN2's four hops: the seed, its
        edge records, the distinct persons they reach, their edge records."""
        deg = np.bincount(self.a, minlength=self.nodes)
        reached = self.hops(seed, 1)[0] > 0
        return [1, int(deg[seed]), int(reached.sum()), int(deg[reached].sum())]

    def fof(self, seed: int) -> dict:
        v = self.hops(seed, 2)[-1]
        return {int(i): int(v[i]) for i in np.nonzero(v)[0]}


def graph_arrays(pairs, nodes: int):
    """Config 1's adjacency as the mirrors hold it, built directly from the
    pairs: person p has intern id p, the record of edge i id nodes + i.
    Returns the person->knows and knows->person CSRs (pow2 padded), their
    max degrees, n_cap, and the composed person->person operator (the
    dense pair's A, 128-padded) with its row sums."""
    from surrealdb_tpu_torch.utils.num import next_pow2

    e = pairs.shape[0]
    n_cap = next_pow2(nodes + e)
    width = next_pow2(e)

    def csr(src, dst):
        order = np.argsort(src, kind="stable")
        indptr = np.zeros(n_cap + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        deg_max = int(indptr.max())
        indptr = np.cumsum(indptr).astype(np.int32)
        indices = np.zeros(width, dtype=np.int32)
        indices[:e] = dst[order]
        return indptr, indices, deg_max

    rec = np.arange(nodes, nodes + e)
    pk = csr(pairs[:, 0], rec)
    kp = csr(rec, pairs[:, 1])
    n0 = max(((nodes + 127) // 128) * 128, 128)
    A = np.bincount(pairs[:, 0] * n0 + pairs[:, 1], minlength=n0 * n0).reshape(n0, n0)
    return dict(pk=pk, kp=kp, n_cap=n_cap, n0=n0, A=A.astype(np.float32),
                outdeg=A.sum(axis=1).astype(np.float32))


def fof_frontier(arrs, seed: int):
    """The frontier K6 takes on the main path: the knows records reached by
    the first three host hops of CHAIN2 from `seed`, with their path counts."""
    pk_ptr, pk_idx, _ = arrs["pk"]
    kp_ptr, kp_idx, _ = arrs["kp"]
    cnt = {}
    for r in pk_idx[pk_ptr[seed]:pk_ptr[seed + 1]]:
        p = int(kp_idx[kp_ptr[r]])
        for r2 in pk_idx[pk_ptr[p]:pk_ptr[p + 1]]:
            cnt[int(r2)] = cnt.get(int(r2), 0) + 1
    nodes = np.array(sorted(cnt), dtype=np.int32)
    return nodes, np.array([cnt[int(i)] for i in nodes], dtype=np.int32)


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return bool(a.shape == b.shape and a.dtype == b.dtype and (a == b).all())


def _max_abs(a, b) -> float:
    if isinstance(a, tuple):
        return max(_max_abs(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_graph_kernels(torch):
    """K6, K7 and K8 against their plain versions on the card, exactly, on
    config 1's adjacency; then median times at the main path's shapes
    beside their bounds, the plain versions and (K8) torch's product."""
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.idx import graph_csr as G
    from surrealdb_tpu_torch.utils.num import next_pow2

    dev = torch.device("cuda", 0)
    nodes = GRAPH_NODES
    pairs = graph_pairs(nodes, GRAPH_EDGES)
    arrs = graph_arrays(pairs, nodes)
    n_cap, n0 = arrs["n_cap"], arrs["n0"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pk = (t(arrs["pk"][0]), t(arrs["pk"][1]))
    kp = (t(arrs["kp"][0]), t(arrs["kp"][1]))
    pk_csc = tuple(t(a) for a in G.csc_arrays(arrs["pk"][0], arrs["pk"][1]))
    kp_csc = tuple(t(a) for a in G.csc_arrays(arrs["kp"][0], arrs["kp"][1]))
    A = torch.from_numpy(arrs["A"]).to(dev).to(torch.bfloat16)
    outdeg = t(arrs["outdeg"])
    fsz = next_pow2(max(1, cnf.TPU_GRAPH_FRONTIER_PAD))
    rng = np.random.default_rng(5)

    def seeds(lanes, pad, per_lane):
        fr = np.full((lanes, fsz), pad, dtype=np.int32)
        cw = np.zeros((lanes, fsz), dtype=np.int32)
        for b in range(lanes - 3):  # the last lanes stay empty, as padding lanes do
            k = 1 + b % per_lane
            fr[b, :k] = rng.integers(0, nodes, k)
            cw[b, :k] = rng.integers(1, 3, k) if per_lane > 1 else 1
        return t(fr), t(cw)

    err = {"graph_dense_count": 0.0, "graph_csc_count": 0.0, "graph_chain": 0.0}
    checks = []

    def check(name, label, got, want):
        torch.cuda.synchronize()
        ok = _equal(got, want)
        err[name] = max(err[name], _max_abs(got, want))
        checks.append(dict(kernel=name, case=label, exact=ok))
        emit("graph_check", kernel=name, case=label, exact=ok)
        require(ok, f"{name} {label} differs from its plain version")

    for lanes in (32, 64):
        fr, cw = seeds(lanes, n0, 2)
        for prods in (1, 2):
            As = (A,) * prods
            check("graph_dense_count", f"lanes{lanes}_products{prods}",
                  G.dense_count_batch(As, outdeg, fr, cw, n0),
                  G.dense_count_batch_plain(As, outdeg, fr, cw, n0))
    # a chain of unequal widths: [n0, 5000] then [5000, n0]
    fr, cw = seeds(32, n0, 2)
    As = (A[:, :5000].contiguous(), A[:5000].contiguous())
    check("graph_dense_count", "lanes32_unequal_widths",
          G.dense_count_batch(As, outdeg, fr, cw, n0),
          G.dense_count_batch_plain(As, outdeg, fr, cw, n0))
    del As
    # K7: every (->knows, knows->person) pair fuses (each knows record has
    # one source); a hop alone, a 1-hop count, and a chain that starts at
    # the records (kp first: many sources a person) runs unfused
    require(G.csc_facts(*pk_csc)[1] and not G.csc_facts(*kp_csc)[1],
            "the person->knows CSC does not read as single-source")
    for lanes, per_lane in ((32, 3), (64, 1)):
        fr, cw = seeds(lanes, n_cap, per_lane)
        for hops in range(0, 5):
            csc = tuple((pk_csc,) if i % 2 == 0 else (kp_csc,) for i in range(hops))
            last = ((pk[0],),) if hops % 2 == 0 else ((kp[0],),)
            check("graph_csc_count", f"lanes{lanes}_csc_hops{hops}",
                  G.chain_count_batch(csc, last, fr, cw, n_cap),
                  G.chain_count_batch_plain(csc, last, fr, cw, n_cap))
    fr, cw = seeds(32, n_cap, 3)
    fr = torch.where(fr < n_cap, fr + nodes, fr)  # knows records as the seeds
    csc = ((kp_csc,), (pk_csc,), (kp_csc,))
    check("graph_csc_count", "lanes32_kp_unfused_then_pk_kp_fused",
          G.chain_count_batch(csc, ((pk[0],),), fr, cw, n_cap),
          G.chain_count_batch_plain(csc, ((pk[0],),), fr, cw, n_cap))
    fnodes, fcounts = fof_frontier(arrs, int(rng.integers(0, nodes)))
    ffsz = next_pow2(max(fnodes.size, fsz))
    f1 = np.full(ffsz, n_cap, dtype=np.int32)
    f1[: fnodes.size] = fnodes
    c1 = np.zeros(ffsz, dtype=np.int32)
    c1[: fcounts.size] = fcounts
    f1, c1 = t(f1), t(c1)
    md_pk = next_pow2(max(arrs["pk"][2], 1))
    one = ((kp,),)
    three = ((kp,), (pk,), (kp,))
    out1 = (ffsz,)
    out3 = (ffsz, next_pow2(min(ffsz * md_pk, n_cap)), n_cap)
    for label, hops, mds, outs, count_only in (
        ("expand_1spec", one, ((1,),), out1, False),
        ("expand_3spec", three, ((1,), (md_pk,), (1,)), out3, False),
        ("count_3spec", three, ((1,), (md_pk,), (1,)), out3, True),
    ):
        check("graph_chain", f"{label}_fsz{ffsz}_outs{'-'.join(map(str, outs))}",
              G.chain_kernel(hops, f1, c1, mds, n_cap, outs, count_only),
              G.chain_plain(hops, f1, c1, mds, n_cap, outs, count_only))
    # K6's touched-node design: counts that wrap in int32, a frontier that
    # touches the sentinel, two mirrors a hop, each twice back to back over
    # the cached scratch (zero after every call), then a planted failed call
    # (a hop's second mirror with no max degree fails after the first's
    # gather) and a good call after it
    from surrealdb_tpu_torch.ops import _cuda

    sc = G.chain_scratch(_cuda.lib(), dev, n_cap)
    wptr = np.zeros(n_cap + 1, dtype=np.int64)
    wadj = {0: [5] * 3 + [6] * 4 + [8] * 2 + [7], 2: [n_cap, n_cap + 9, 1 << 30, -4, 3]}
    for src, dst in wadj.items():
        wptr[src + 1] = len(dst)
    widx = np.zeros(16, dtype=np.int32)
    widx[:15] = [d for src in sorted(wadj) for d in wadj[src]]
    wrap = (t(np.cumsum(wptr).astype(np.int32)), t(widx))
    wfr = t(np.array([0, 2, 2, n_cap, 9, 0, nodes + 7], dtype=np.int32))
    wcw = t(np.array([1 << 30, 1, 2, 7, 0, 0, 3], dtype=np.int32))
    scratch_zero = []
    new_cases = (
        ("wrapped_counts_and_sentinel_1hop", ((wrap,),), wfr, wcw, ((16,),), (16,), False),
        ("wrapped_counts_and_sentinel_2hops", ((wrap,), (wrap,)), wfr, wcw, ((16,), (16,)),
         (16, 16), False),
        ("two_mirrors_a_hop", ((kp,), (pk, pk)), f1, c1, ((1,), (md_pk, md_pk)),
         out3[:2], False),
        ("two_mirrors_a_hop_count", ((kp,), (pk, pk), (kp,)), f1, c1,
         ((1,), (md_pk, md_pk), (1,)), out3, True),
    )
    for rep in range(2):
        for label, hops, fr_, cw_, mds, outs, count_only in new_cases:
            check("graph_chain", f"{label}_call{rep + 1}",
                  G.chain_kernel(hops, fr_, cw_, mds, n_cap, outs, count_only),
                  G.chain_plain(hops, fr_, cw_, mds, n_cap, outs, count_only))
            zero = not (bool(sc.cnt.any()) or bool(sc.bits.any()) or bool(sc.state.any()))
            scratch_zero.append(zero)
            require(zero and not sc.dirty, f"graph_chain {label}: the scratch is not zero")
    failed = None
    try:
        G.chain_kernel(((kp, kp),), f1, c1, ((1, 0),), n_cap, out1, False)
    except RuntimeError as e:
        failed = str(e)
    torch.cuda.synchronize()
    dirty = sc.dirty and bool(sc.cnt.any()) and bool(sc.bits.any())
    emit("graph_check", kernel="graph_chain", case="planted_failed_call", raised=failed,
         scratch_dirty=dirty)
    require(failed is not None and dirty, "the planted failed graph_chain call left no trace")
    check("graph_chain", "after_the_failed_call", G.chain_kernel(one, f1, c1, ((1,),), n_cap,
                                                                  out1, False),
          G.chain_plain(one, f1, c1, ((1,),), n_cap, out1, False))
    require(not (sc.dirty or bool(sc.cnt.any()) or bool(sc.bits.any())),
            "graph_chain left its scratch dirty after the good call")

    # times at the main path's shapes: K8 a 3-hop count at 32 lanes (two
    # products), K7 the 5-spec count at 32 lanes (four CSC hops), K6 the
    # friends-of-friends expand's device hop
    fr, cw = seeds(32, n0, 1)
    As = (A, A)
    Af = A.float()
    xd = torch.zeros((32, n0 + 1), device=dev).scatter_add_(
        1, torch.where(cw > 0, fr.long().clamp(0, n0), n0), cw.float())[:, :n0].contiguous()
    # K8's floor: the bf16 operator read once per product. Regrouped as
    # x @ (A @ (A @ outdeg)), as the kernel computes it, the function needs
    # 2 n0^2 FMAs (two matrix-vector passes) and a gather-dot over the
    # seeds, so the bytes bound it; design_ops_ms is those operations on
    # the CUDA cores in f32.
    b_bytes = 2 * A.numel() * 2 + n0 * 4 + 2 * fr.numel() * 4 + 32 * 4
    b_ops = 2 * 2.0 * n0 * n0 + 2.0 * 32 * n0
    k8_bound, k8_by = bound_ms(b_bytes, b_ops, "float32")
    design_ops = 2 * 2.0 * n0 * n0 + 2.0 * fr.numel()
    lib = lambda: torch.matmul(torch.matmul(torch.matmul(xd, Af), Af), outdeg)  # noqa: E731
    multi = lambda: torch.linalg.multi_dot([xd, Af, Af, outdeg[:, None]])[:, 0]  # noqa: E731
    k8 = G.dense_count_batch(As, outdeg, fr, cw, n0)
    multi_err = _max_abs(multi(), k8)
    emit("graph_check", kernel="graph_dense_count", case="regrouped_multi_dot_lanes32",
         exact=multi_err == 0.0)
    require(multi_err == 0.0, "torch.linalg.multi_dot's counts differ from graph_dense_count's")
    fr64, cw64 = seeds(64, n0, 1)
    timing = {"graph_dense_count": dict(
        ms=median_ms(lambda: G.dense_count_batch(As, outdeg, fr, cw, n0)),
        queued_ms=queued_device_ms(torch, lambda: G.dense_count_batch(As, outdeg, fr, cw, n0)),
        plain_ms=median_ms(lambda: G.dense_count_batch_plain(As, outdeg, fr, cw, n0), iters=5),
        # the reference's x @ A @ A form in f32 (TF32 off): two [32, n0] x [n0, n0] products
        library_ms=median_ms(lib),
        library_max_abs_err=_max_abs(lib(), k8),
        # the regrouped order over an f32 copy of A (made outside the timing)
        regrouped_multi_dot_ms=median_ms(multi),
        regrouped_multi_dot_queued_ms=queued_device_ms(torch, multi),
        regrouped_multi_dot_max_abs_err=multi_err,
        # twice the lanes: the passes over the operators do not depend on them
        ms_64_lanes=median_ms(lambda: G.dense_count_batch(As, outdeg, fr64, cw64, n0)),
        bound_ms=k8_bound, bound_by=k8_by,
        design_ops_ms=design_ops / PEAK_FLOPS["float32"] * 1e3,
        shape={"lanes": 32, "fsz": fsz, "n0": n0, "products": 2},
    )}
    del Af
    fr, cw = seeds(32, n_cap, 1)
    csc = ((pk_csc,), (kp_csc,), (pk_csc,), (kp_csc,))
    last = ((pk[0],),)
    in_bytes = sum(a.numel() * 4 for hop in csc for pair in hop for a in pair)
    in_bytes += pk[0].numel() * 4 + 2 * fr.numel() * 4 + 32 * 4
    x_bytes = 4 * 2 * (n_cap + 1) * 32 * 4  # the lane-minor x written and read back a hop
    k7_ops = 32.0 * (sum(int(pair[1].numel()) for hop in csc for pair in hop) + 2 * n_cap)
    k7_bound, k7_by = bound_ms(in_bytes, k7_ops, "float32")
    fr64, cw64 = seeds(64, n_cap, 1)
    k7 = lambda: G.chain_count_batch(csc, last, fr, cw, n_cap)  # noqa: E731
    k7_64 = lambda: G.chain_count_batch(csc, last, fr64, cw64, n_cap)  # noqa: E731
    timing["graph_csc_count"] = dict(
        ms=median_ms(k7), queued_ms=queued_device_ms(torch, k7),
        plain_ms=median_ms(lambda: G.chain_count_batch_plain(csc, last, fr, cw, n_cap), iters=5),
        library_ms=None, bound_ms=k7_bound, bound_by=k7_by,
        # the floor of a design that moves x through HBM every hop
        bound_with_x_ms=bound_ms(in_bytes + x_bytes, k7_ops, "float32")[0],
        ms_64_lanes=median_ms(k7_64), queued_ms_64_lanes=queued_device_ms(torch, k7_64),
        shape={"lanes": 32, "fsz": fsz, "n_cap": n_cap, "csc_hops": 4},
    )
    # K6's bytes are this frontier's: its entries, their two pointers each,
    # the adjacency entries it gathers, and the outputs
    kp_ptr = arrs["kp"][0]
    touched = int(np.minimum(kp_ptr[fnodes + 1] - kp_ptr[fnodes], 1).sum())
    k6_bytes = 2 * ffsz * 4 + 2 * int(fnodes.size) * 4 + touched * 4 + 2 * ffsz * 4
    k6_bound, k6_by = bound_ms(k6_bytes, float(touched), "float32")
    k6 = lambda: G.chain_kernel(one, f1, c1, ((1,),), n_cap, out1, False)  # noqa: E731
    nodes_out = int((k6()[1] > 0).sum())
    words = int(sc.bits.numel())
    timing["graph_chain"] = dict(
        ms=median_ms(k6), queued_ms=queued_device_ms(torch, k6),
        plain_ms=median_ms(lambda: G.chain_plain(one, f1, c1, ((1,),), n_cap, out1, False),
                           iters=5),
        library_ms=None, bound_ms=k6_bound, bound_by=k6_by,
        # the floors of the two designs: the old one memsets and scans the
        # dense [n_cap + 1] array; the new one reads the bitmap, and reads
        # and clears each touched node's count and bitmap word
        bound_with_dense_ms=bound_ms(k6_bytes + 2 * 4 * (n_cap + 1), float(touched),
                                     "float32")[0],
        bound_with_bitmap_ms=bound_ms(k6_bytes + 4 * words + 12 * nodes_out, float(touched),
                                      "float32")[0],
        kernels_per_call=kernels_per_call(torch, k6),
        shape={"fsz": ffsz, "frontier": int(fnodes.size), "n_cap": n_cap, "md": 1,
               "out_size": ffsz, "touched": nodes_out, "bitmap_words": words},
    )
    emit("timing_graph", **timing)
    # the wrapper's host side: one allocation a call (what it returns),
    # where the dense design made five
    def enqueue():
        t0 = time.perf_counter()
        k6()
        return (time.perf_counter() - t0) * 1e3

    def old_allocs():
        for n in (ffsz, ffsz, n_cap + 1, (n_cap + 2047) // 2048, 1):
            torch.empty(n, dtype=torch.int32, device=dev)

    enq = [enqueue() for _ in range(30)]
    torch.cuda.synchronize()
    emit("host_side", kernel="graph_chain", torch_empty_a_call=1,
         call_enqueue_host_ms=statistics.median(enq[5:]),
         alloc_host_ms=median_host_ms(lambda: torch.empty(2 * ffsz, dtype=torch.int32,
                                                          device=dev)),
         old_five_allocs_host_ms=median_host_ms(old_allocs), call_event_ms=timing[
             "graph_chain"]["ms"])
    return {"checks": checks, "max_abs_err": err, "timing": timing}


GRAPH_ROUTES = {"graph_dense": "graph_dense_count", "graph_csc": "graph_csc_count",
                "graph_chain": "graph_chain"}  # compile_log subsystem -> its kernel


def graph_routes() -> dict:
    """Calls of each graph kernel site so far (compile_log counts every
    tracked call once under compile_cache: a miss, hit or wait), on either
    device."""
    from surrealdb_tpu_torch import telemetry

    counters = telemetry.snapshot()["counters"]
    return {sub: sum(v for k, v in counters.items()
                     if k.startswith("compile_cache{") and f'subsystem="{sub}"' in k)
            for sub in GRAPH_ROUTES}


def check_graph_window(device, r0, l0, want: dict, what: str):
    """The window between snapshots r0/l0 and now went through exactly the
    `want` calls of each graph site; on the card, each call was one launch
    of its kernel."""
    r1, l1 = graph_routes(), read_launches()
    calls = {sub: r1[sub] - r0[sub] for sub in GRAPH_ROUTES}
    require(calls == {sub: float(want.get(sub, 0)) for sub in GRAPH_ROUTES},
            f"{what}: graph sites called {calls}, expected {want}")
    if device == "cuda":
        launches = {k: l1[k] - l0[k] for k in GRAPH_ROUTES.values()}
        require(launches == {GRAPH_ROUTES[sub]: int(c) for sub, c in calls.items()},
                f"{what}: launches {launches} for site calls {calls}")
    return calls


def prewarm_errors() -> float:
    from surrealdb_tpu_torch import telemetry

    return sum(v for k, v in telemetry.snapshot()["counters"].items()
               if k.startswith("prewarm_errors"))


def phase_main_path_graph(torch, device: str, nodes: int, edges: int, batch: int,
                          n_seq: int, n_threads: int, rounds: int, n_odd: int = 8,
                          n_fof: int = 8):
    """Bench config 1 through Datastore.execute: ingest as bench.py
    ingest_person_graph does, join the ingest-armed mirror build and kernel
    prewarm, then the 3-hop count (K8) sequentially and from n_threads
    clients, the 5-spec count (K7) and the 2-hop expand (K6). Every answer
    must equal GraphReference's."""
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.idx import graph_csr as G
    from surrealdb_tpu_torch.kvs.ds import Datastore
    from surrealdb_tpu_torch.sql.value import Thing

    pairs = graph_pairs(nodes, edges)
    ref = GraphReference(pairs, nodes)
    rng = np.random.default_rng(11)
    seq_seeds = rng.integers(0, nodes, n_seq).tolist()
    conc_seeds = rng.integers(0, nodes, n_threads * rounds).tolist()
    odd_seeds = rng.integers(0, nodes, n_odd).tolist()
    fof_seeds = rng.integers(0, nodes, n_fof).tolist()
    t = time.perf_counter()
    edges_of = {s: ref.edges_per_seed(s) for s in set(seq_seeds + conc_seeds)}
    ref_s = time.perf_counter() - t
    errors0 = prewarm_errors()
    ds = Datastore("memory", device=device)
    try:
        gm = ds.graph_mirrors
        builds = []  # (what, seconds) of the mirror and dense-operator builds

        def timed(name, fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    dt = time.perf_counter() - t0
                    if dt > 0.01:  # a cache hit returns in microseconds
                        builds.append((name, dt))
            return wrapper

        gm.build_table = timed("mirror_build", gm.build_table)
        gm._dense_pair = timed("dense_operator_build", gm._dense_pair)
        run = sql_runner(ds)
        reset_launches()  # the graph path's run: ingest-time prewarm and queries
        run("DEFINE TABLE person SCHEMALESS; DEFINE TABLE knows SCHEMALESS")
        t = time.perf_counter()
        for i in range(0, nodes, batch):
            run("INSERT INTO person $rows RETURN NONE",
                {"rows": [{"id": j} for j in range(i, min(i + batch, nodes))]})
        for i in range(0, edges, batch):
            run("INSERT RELATION INTO knows $rows RETURN NONE",
                {"rows": [{"in": Thing("person", int(a)), "out": Thing("person", int(b))}
                          for a, b in pairs[i:i + batch]]})
        ingest_s = time.perf_counter() - t
        t = time.perf_counter()
        require(gm.wait_prewarm(timeout=600), "graph prewarm did not finish in 600 s")
        prewarm_wait_s = time.perf_counter() - t
        errors = prewarm_errors() - errors0
        require(errors == 0, f"{errors} graph prewarm errors (a kernel failed to build or launch)")

        def count(chain, seed):
            res = run(f"SELECT count({chain}) AS c FROM person:{seed}")
            return res[0]["c"]

        t = time.perf_counter()
        first = count(CHAIN3, seq_seeds[0])
        first_query_s = time.perf_counter() - t
        require(first == ref.count3(seq_seeds[0]), "first 3-hop count differs from the reference")
        mem0 = window_start(torch, device)
        # what holds device memory beyond this phase's own (the 10,112^2
        # bf16 operator, 204.5 MB, and the mirrors' int32 arrays)
        held = tensor_holders(torch) if device == "cuda" and mem0 > 1 << 30 else None
        d0, r0, l0 = ds.dispatch.stats()["dispatches"], graph_routes(), read_launches()
        seq_lat = []
        with GcPauses() as gcp:  # a full collection over the stored graph stalls queries
            for s in seq_seeds:
                t = time.perf_counter()
                got = count(CHAIN3, s)
                seq_lat.append(time.perf_counter() - t)
                require(got == ref.count3(s), f"3-hop count of person:{s}: {got} != {ref.count3(s)}")
            widths0 = ds.dispatch.width_distribution()
            conc_lat, conc_err, lock = [], [], threading.Lock()
            results = {}

            def client(i):
                try:
                    for r in range(rounds):
                        s = conc_seeds[i * rounds + r]
                        t1 = time.perf_counter()
                        got = count(CHAIN3, s)
                        with lock:
                            conc_lat.append(time.perf_counter() - t1)
                            results[(i, r)] = (s, got)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    conc_err.append(e)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(n_threads)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            conc_wall = time.perf_counter() - t
        require(not any(th.is_alive() for th in threads), "graph clients hung")
        if conc_err:
            raise conc_err[0]
        for s, got in results.values():
            require(got == ref.count3(s), f"concurrent 3-hop count of person:{s} differs")
        widths = {w: c - widths0.get(w, 0) for w, c in ds.dispatch.width_distribution().items()
                  if c - widths0.get(w, 0)}
        dense_calls = check_graph_window(device, r0, l0,
                                         {"graph_dense": ds.dispatch.stats()["dispatches"] - d0},
                                         "3-hop window")["graph_dense"]
        busy = device_busy_share(torch, lambda: [count(CHAIN3, s) for s in seq_seeds[:8]]) \
            if device == "cuda" else None

        r0, l0 = graph_routes(), read_launches()
        odd_lat = []
        for s in odd_seeds:
            t = time.perf_counter()
            got = count(CHAIN5, s)
            odd_lat.append(time.perf_counter() - t)
            require(got == ref.count3(s), f"5-spec count of person:{s}: {got} != {ref.count3(s)}")
        check_graph_window(device, r0, l0, {"graph_csc": len(odd_seeds)}, "5-spec window")

        it = gm.interner("test", "test")
        r0, l0 = graph_routes(), read_launches()
        fof_lat, fof_sizes = [], []
        for s in fof_seeds:
            t = time.perf_counter()
            res = run(f"SELECT {CHAIN2} AS f FROM person:{s}")
            fof_lat.append(time.perf_counter() - t)
            got = res[0]["f"]
            want = ref.fof(s)
            multiset = {}
            for th in got:
                require(th.tb == "person", f"expand of person:{s} returned {th}")
                multiset[int(th.id)] = multiset.get(int(th.id), 0) + 1
            require(multiset == want, f"expand of person:{s} differs from the reference")
            ids = [it.lookup(th) for th in got]
            require(ids == sorted(ids), f"expand of person:{s} is not in ascending intern order")
            fof_sizes.append(len(got))
        # one device call for each expand whose frontier reaches the
        # on-device threshold (every seed at config 1's size)
        on_device = sum(max(ref.fof_frontiers(s)) >= cnf.TPU_GRAPH_ONDEVICE_THRESHOLD
                        for s in fof_seeds)
        check_graph_window(device, r0, l0, {"graph_chain": on_device}, "expand window")
        run_launches = read_launches()
        if device == "cuda":
            path = {c.name: run_launches[c.name] for c in G.KERNELS}
            require(all(v > 0 for v in path.values()),
                    f"a kernel of the graph path never launched: {path}")
        seq_edges = sum(edges_of[s] for s in seq_seeds)
        conc_edges = sum(edges_of[s] for s in conc_seeds)
        out = dict(
            nodes=nodes, edges=edges, device=str(ds.device), n_cap=len(it),
            ingest_rows=nodes + edges, ingest_s=ingest_s,
            ingest_rows_per_s=(nodes + edges) / ingest_s,
            prewarm_wait_s=prewarm_wait_s, builds=builds, reference_s=ref_s,
            first_query_s=first_query_s,
            seq_queries=len(seq_seeds), seq_p50_ms=statistics.median(seq_lat) * 1e3,
            seq_max_ms=max(seq_lat) * 1e3, seq_slowest=int(np.argmax(seq_lat)),
            seq_edges_per_s=seq_edges / sum(seq_lat), gc_pauses=gcp.summary(),
            concurrent_clients=n_threads, rounds=rounds,
            conc_p50_ms=statistics.median(conc_lat) * 1e3,
            conc_edges_per_s=conc_edges / conc_wall, conc_qps=len(conc_lat) / conc_wall,
            mean_edges_per_seed=conc_edges / len(conc_seeds),
            dispatch_widths={str(w): c for w, c in sorted(widths.items())},
            dense_dispatches_3hop=dense_calls,
            odd_queries=len(odd_seeds), odd_p50_ms=statistics.median(odd_lat) * 1e3,
            fof_queries=len(fof_seeds), fof_on_device=on_device, fof_p50_ms=statistics.median(fof_lat) * 1e3,
            fof_mean_results=float(np.mean(fof_sizes)), run_launches=run_launches,
            profiled_8_seq_queries=busy,
            peak_device_memory_bytes=(torch.cuda.max_memory_allocated()
                                      if device == "cuda" else None),
            device_memory_at_window_start_bytes=mem0, large_tensors_at_window_start=held,
        )
        emit("main_path_graph", **out)
        return out
    finally:
        ds.close()


# ------------------------------------------------------------------ full text
FT_DOCS = 1_000_000  # bench.py ND at scale 1 (config 3)
FT_VOCAB = 2000  # bench.py VOCAB_N
FT_WORDS = 12  # words a document (bench.py ingest_docs' L)
FT_BATCH = 20_000  # bench.py ingest_docs' batch
FT_SCHEMA = ("DEFINE ANALYZER simple TOKENIZERS blank FILTERS lowercase; "
             "DEFINE TABLE doc SCHEMALESS; "
             "DEFINE INDEX fbody ON doc FIELDS body SEARCH ANALYZER simple BM25")
FT_SQL = ("SELECT id, search::score(1) AS sc FROM doc WHERE body @1@ '{}' "
          "ORDER BY sc DESC LIMIT 10")  # bench.py bench_bm25
BM25_TOL = dict(rtol=1e-5, atol=1e-6)


def ft_word(i: int) -> str:
    return f"w{i:04d}"


def ft_query_pairs(n: int, seed: int = 11):
    """bench.py bench_bm25's query terms: two words of rank 10-119."""
    return np.random.default_rng(seed).integers(10, 120, size=(n, 2))


class FtReference:
    """Independent numpy BM25 over the generated word ranks W [N, 12] (not
    the port's host twin): AND-match, f64 scores with the corpus's doc
    count and total length (every document has 12 tokens), ranked by
    (-score, id)."""

    def __init__(self, words, k1: float = 1.2, b: float = 0.75):
        self.W, self.k1, self.b = words, k1, b
        self.n = words.shape[0]
        self.tl = float(words.size)
        # each word's document frequency (the length of its posting list)
        key = np.unique(np.arange(self.n, dtype=np.int64)[:, None] * FT_VOCAB + words)
        self.df = np.bincount(key % FT_VOCAB, minlength=FT_VOCAB)

    def rarest(self, ranks) -> int:
        """The shortest posting list among the query's words (0: a word no
        document has)."""
        return int(min(self.df[int(r)] for r in ranks))

    def top(self, ranks, k: int = 10):
        """-> (ids, scores) of the k best documents, and the candidate count."""
        tfs = [(self.W == r).sum(axis=1) for r in dict.fromkeys(int(r) for r in ranks)]
        ids = np.nonzero(np.logical_and.reduce([t > 0 for t in tfs]))[0]
        n, avg = float(self.n), self.tl / self.n
        norm = 1.0 - self.b + self.b * (FT_WORDS / avg)
        score = np.zeros(ids.size)
        for t in tfs:
            df = float(np.count_nonzero(t))
            idf = np.log1p((n - df + 0.5) / (df + 0.5))
            f = t[ids].astype(np.float64)
            score += idf * (f * (self.k1 + 1.0)) / (f + self.k1 * norm)
        order = np.lexsort((ids, -score))[:k]
        return ids[order], score[order], int(ids.size)


def ft_ingest(run, n_docs: int, batch: int, seed: int = 7):
    """bench.py ingest_docs: 12 words a document from the 2,000-word
    vocabulary, rank r drawn with p ~ 1/(r + 10), INSERTed in batches.
    Returns the word ranks [N, 12] (int16) and the seconds spent in INSERT."""
    rng = np.random.default_rng(seed)
    vocab = np.asarray([ft_word(i) for i in range(FT_VOCAB)])
    w = 1.0 / (np.arange(FT_VOCAB) + 10.0)
    p = w / w.sum()
    words = np.empty((n_docs, FT_WORDS), dtype=np.int16)
    total = 0.0
    for i in range(0, n_docs, batch):
        n = min(batch, n_docs - i)
        ranks = rng.choice(FT_VOCAB, size=(n, FT_WORDS), p=p)
        words[i:i + n] = ranks
        rows = [{"id": i + j, "body": " ".join(r)} for j, r in enumerate(vocab[ranks].tolist())]
        t = time.perf_counter()
        run("INSERT INTO doc $rows RETURN NONE", {"rows": rows})
        total += time.perf_counter() - t
    return words, total


def bm25_inputs(rng, n: int, t: int, tf_int: bool, total_len: float = 12e6):
    """Candidates shaped like config 3's: tf mostly 1, lengths 12 (a few
    tombstoned documents at 0), so exact ties abound; df as a rank-10-119
    word's."""
    tf = rng.choice(np.array([0, 1, 2, 3]), size=(n, t), p=[0.05, 0.8, 0.1, 0.05])
    lens = np.full(n, 12.0, dtype=np.float32)
    lens[rng.random(n) < 0.01] = 0.0
    df = rng.integers(300, 202_000, size=t).astype(np.float32)
    return (tf.astype(np.int32 if tf_int else np.float32), df, lens,
            np.float32(1e6), np.float32(total_len))


def median_host_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median host-clock time of fn(), which ends in a synchronising copy
    (the device path) or runs on the host (the numpy twin)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


# the match checks' synthetic terms (ft_postings)
FT_EXTRA = ("one", "tile", "all", "even", "odd", "all2", "all3", "third", "not_seventh")


def ft_postings(n_docs: int, seed: int = 7):
    """Config 3's postings built directly with numpy (ft_ingest's
    generator, no SQL): the 2,000 words' lists (ids ascending, tf the
    word's count in the document, lengths 12 with 1% tombstoned at 0),
    then FT_EXTRA's terms for the match checks (tf 1-2): the last document
    alone (the largest did), 256 documents (one tile), every document, the
    even and the odd ones, every document twice more, every third, all but
    every seventh. -> (indptr, dids, tfs, lens)"""
    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(FT_VOCAB) + 10.0)
    words = rng.choice(FT_VOCAB, size=(n_docs, FT_WORDS), p=w / w.sum())
    key, tf = np.unique(words.astype(np.int64) * n_docs + np.arange(n_docs)[:, None],
                        return_counts=True)
    every = np.arange(n_docs)
    extra = [np.array([n_docs - 1]), np.sort(rng.choice(n_docs, 256, replace=False)), every,
             every[::2], every[1::2], every, every, every[::3], every[every % 7 != 0]]
    counts = list(np.bincount(key // n_docs, minlength=FT_VOCAB)) + [len(e) for e in extra]
    indptr = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    dids = np.concatenate([key % n_docs] + extra)
    tfs = np.concatenate([tf.astype(np.float32)]
                         + [rng.integers(1, 3, len(e)).astype(np.float32) for e in extra])
    lens = np.full(n_docs, float(FT_WORDS), dtype=np.float32)
    lens[rng.random(n_docs) < 0.01] = 0.0
    return indptr, dids, tfs, lens


def many_term_postings(n_terms: int = 300, n_docs: int = 4096, seed: int = 17):
    """Postings for K9's match past the terms it takes by value: n_terms
    terms over n_docs documents, each term's list the same 300 documents
    (which so hold every term, spread over the did range) and a share of
    its own (2-50%, drawn a term), tf 1-3, lengths 0-30. The rarest list
    spans two tiles and every query over these terms has matches in each.
    -> (indptr, dids, tfs, lens)"""
    rng = np.random.default_rng(seed)
    core = np.sort(rng.choice(n_docs, 300, replace=False))
    lists = [np.union1d(core, np.nonzero(rng.random(n_docs) < p)[0])
             for p in rng.uniform(0.02, 0.5, n_terms)]
    indptr = np.zeros(n_terms + 1, dtype=np.int64)
    np.cumsum([len(x) for x in lists], out=indptr[1:])
    dids = np.concatenate(lists).astype(np.int64)
    tfs = rng.integers(1, 4, len(dids)).astype(np.float32)
    lens = rng.integers(0, 31, n_docs).astype(np.float32)
    return indptr, dids, tfs, lens


def search_order(indptr, tids):
    """FtMirror.search's term order: rarest first, ties in query order."""
    return sorted(dict.fromkeys(int(t) for t in tids), key=lambda t: indptr[t + 1] - indptr[t])


def host_and(indptr, dids, tids):
    """The reference's AND-match on the host -> the matched dids."""
    cand = dids[indptr[tids[0]]:indptr[tids[0] + 1]]
    for t in tids[1:]:
        d = dids[indptr[t]:indptr[t + 1]]
        pos = np.clip(np.searchsorted(d, cand), 0, len(d) - 1)
        cand = cand[d[pos] == cand]
    return cand


def match_bytes(indptr, dids, tids, matches: int) -> int:
    """The bytes a match must move: the rarest list's dids and tf, each
    other list's dids over the rarest list's did span, the matches' tf of
    every other list and lengths, and the output pairs with the count."""
    first = dids[indptr[tids[0]]:indptr[tids[0] + 1]]
    n = 8 * first.size + 8 + 16 * len(tids)
    for t in tids[1:]:
        d = dids[indptr[t]:indptr[t + 1]]
        n += 4 * int(np.searchsorted(d, first[-1], "right") - np.searchsorted(d, first[0]))
    return n + matches * (4 * (len(tids) - 1) + 4 + 8)


def phase_bm25_match(torch):
    """K9's match (bm25_match_scores) against its plain version on the
    card, over config 3's postings (ft_postings) on the card: T = 1, 2, 3
    and 8; rarest lists of one did (the largest), one tile and many tiles;
    empty and full intersections; stats_override df values; then T = 256,
    257 and 300 over many_term_postings (past 256 the terms reach the
    kernel from the card). The dids must be equal and the scores
    bit-equal, both to the plain version's and to bm25_scores' on the same
    tf rows, and the look-back state zero after. Then its times at config 3's median query and the engine's per-query
    paths (the match; the old host AND-match + uploads + bm25_scores +
    download; the host AND-match + the numpy twin) by candidate count."""
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.idx.ft_mirror import FtMirror
    from surrealdb_tpu_torch.ops import _cuda
    from surrealdb_tpu_torch.ops import bm25 as B

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    indptr, dids, tfs, lens = ft_postings(FT_DOCS)
    build_s = time.perf_counter() - t0
    post = B.upload_postings(indptr, dids, tfs, lens, dev)
    emit("bm25_match_postings", docs=FT_DOCS, postings=int(indptr[FT_VOCAB]),
         bytes=post.nbytes, upload_s=post.seconds, numpy_build_s=build_s)
    ex = {name: FT_VOCAB + i for i, name in enumerate(FT_EXTRA)}
    dc, tl = np.float32(FT_DOCS), np.float32(float(lens.sum()))
    pairs = ft_query_pairs(88)
    counts = [host_and(indptr, dids, search_order(indptr, p)).size for p in pairs]
    med = pairs[int(np.argsort(counts)[len(counts) // 2])]
    cases = [
        ("T1_word", [50], None), ("T1_largest_did", [ex["one"]], None),
        ("T1_one_tile", [ex["tile"]], None), ("T1_every_doc", [ex["all"]], None),
        ("T2_median_query", list(med), None), ("T2_largest_did", [ex["one"], ex["all"]], None),
        ("T2_full", [ex["tile"], ex["all"]], None), ("T2_empty", [ex["even"], ex["odd"]], None),
        ("T2_many_tiles", [0, 1], None), ("T3_words", [110, 50, 10], None),
        ("T3", [10, ex["all"], ex["even"]], None),
        ("T8", [10, 11, ex["all"], ex["all2"], ex["all3"], ex["even"], ex["third"],
                ex["not_seventh"]], None),
        ("T8_one_tile", [ex["tile"], ex["all"], ex["all2"], ex["all3"], ex["odd"], 0, 1, 2],
         None),
        ("T2_stats_override", list(med), [400_000.0, 12.5]),
    ]
    err, checks = 0.0, []

    def check(label, post, arrays, tids, df, cdc, ctl):
        indptr, dids, tfs, _lens = arrays
        got_d, got_s = B.bm25_match_scores(post, tids, df, cdc, ctl)
        want_d, want_s = B.bm25_match_scores_plain(post, tids, df, cdc, ctl)
        host_d = host_and(indptr, dids, tids)
        ok = np.array_equal(got_d, want_d) and np.array_equal(got_d, host_d) and \
            np.array_equal(got_s.view(np.int32), want_s.view(np.int32))
        same_bits = True
        if got_d.size:
            rows = np.stack([tfs[indptr[t]:indptr[t + 1]][
                np.searchsorted(dids[indptr[t]:indptr[t + 1]], got_d)] for t in tids], 1)
            ref = B.bm25_scores(torch.from_numpy(rows).to(dev), torch.from_numpy(df).to(dev),
                                post.doc_len[torch.from_numpy(got_d).to(dev)], cdc, ctl)
            same_bits = np.array_equal(ref.cpu().numpy().view(np.int32), got_s.view(np.int32))
        state_zero = not bool(B.match_scratch(dev).state.any())
        e = float(np.abs(got_s - want_s).max()) if got_s.size and got_d.size == want_d.size \
            else 0.0
        checks.append(dict(case=label, t=len(tids), rarest=int(indptr[tids[0] + 1]
                                                               - indptr[tids[0]]),
                           matches=int(got_d.size), exact=ok, bm25_scores_bits=same_bits,
                           state_zero=state_zero))
        emit("bm25_match_check", **checks[-1], max_abs_err=e)
        require(ok and same_bits and state_zero,
                f"bm25_match_scores {label} disagrees with its plain version")
        return got_d, e

    for label, terms, odf in cases:
        tids = search_order(indptr, terms)
        df = np.array(odf or [indptr[t + 1] - indptr[t] for t in tids], dtype=np.float32)
        cdc, ctl = (np.float32(3e6), np.float32(36_000_001.0)) if odf else (dc, tl)
        got_d, e = check(label, post, (indptr, dids, tfs, lens), tids, df, cdc, ctl)
        err = max(err, e)
        if label == "T2_empty":
            require(got_d.size == 0, "the even and odd lists intersect")
        if label in ("T2_full", "T1_every_doc"):
            require(got_d.size == indptr[tids[0] + 1] - indptr[tids[0]], f"{label} lost dids")
    # past the 256 terms a launch takes by value (the scratch's (tid, df)
    # pairs on the card): 256, 257 and 300 terms over many_term_postings,
    # whose 300 documents hold every term
    many = many_term_postings()
    mpost = B.upload_postings(*many, dev)
    for n in (256, 257, 300):
        tids = search_order(many[0], list(range(n)))
        df = np.array([many[0][t + 1] - many[0][t] for t in tids], dtype=np.float32)
        got_d, e = check(f"T{n}_many_terms", mpost, many, tids, df, np.float32(4096),
                         np.float32(float(many[3].sum())))
        err = max(err, e)
        require(got_d.size >= 300, f"T{n}_many_terms lost the documents holding every term")
    del mpost
    # times at config 3's median query
    tids = search_order(indptr, med)
    df = np.array([indptr[t + 1] - indptr[t] for t in tids], dtype=np.float32)
    n_match = host_and(indptr, dids, tids).size
    lib, sc = _cuda.lib(), B.match_scratch(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    nbytes = match_bytes(indptr, dids, tids, n_match)
    bound, by = bound_ms(nbytes, 5.0 * n_match * len(tids), "float32")
    call = lambda: B.bm25_match_scores(post, tids, df, dc, tl)  # noqa: E731
    launch = lambda: B._launch_match(lib, post, tids, df, dc, tl, 1.2, 0.75, sc, stream,  # noqa: E731
                                     download=False)
    timing = dict(
        ms=median_ms(call, iters=20), queued_ms=queued_device_ms(torch, launch),
        launch_ms=median_ms(launch, iters=20),
        plain_ms=median_ms(lambda: B.bm25_match_scores_plain(post, tids, df, dc, tl)),
        library_ms=None, bound_ms=bound, bound_by=by, bound_bytes=nbytes,
        engine_call_host_ms=median_host_ms(call),
        kernels_per_call=kernels_per_call(torch, launch),
        shape={"t": len(tids), "rarest": int(indptr[tids[0] + 1] - indptr[tids[0]]),
               "matches": int(n_match), "query_ranks": [int(r) for r in med]},
    )
    emit("timing_bm25_match", **timing)
    # the wrapper's host side: no allocation a call (its scratch is cached)
    emit("host_side", kernel="bm25_match_scores", torch_empty_a_call=0,
         call_host_ms=timing["engine_call_host_ms"], call_event_ms=timing["ms"])
    # the engine's per-query paths on config-3 queries, nearest each count
    arrays = (indptr, dids, tfs, lens)
    queries = [search_order(indptr, p) for p in pairs] + [[r] for r in range(0, 120, 3)] + \
        [[ex["all"]]]
    qcount = [host_and(indptr, dids, q).size for q in queries]
    paths = {}
    saved = cnf.TPU_FT_ONDEVICE_THRESHOLD
    cnf.TPU_FT_ONDEVICE_THRESHOLD = 1  # score_candidates takes the card
    try:
        for n in (500, 1000, 2000, 3000, 5000, 8000, 11_000, 202_000, 1 << 20):
            i = int(np.argmin([abs(c - n) for c in qcount]))
            q = queries[i]
            qdf = np.array([indptr[t + 1] - indptr[t] for t in q], dtype=np.float32)

            def old_device(q=q, qdf=qdf):
                cand, tf, ln = FtMirror._and_match(arrays, q)
                return B.score_candidates(dev, tf, qdf, ln, dc, tl)

            def host(q=q, qdf=qdf):
                cand, tf, ln = FtMirror._and_match(arrays, q)
                return B.bm25_scores_host(tf, qdf, ln, dc, tl)

            paths[n] = dict(
                query_candidates=qcount[i], query_rarest=int(indptr[q[0] + 1] - indptr[q[0]]),
                engine_match_path_ms=median_host_ms(
                    lambda q=q, qdf=qdf: B.bm25_match_scores(post, q, qdf, dc, tl)),
                engine_old_device_path_ms=median_host_ms(old_device),
                engine_host_path_ms=median_host_ms(host),
            )
    finally:
        cnf.TPU_FT_ONDEVICE_THRESHOLD = saved
    emit("bm25_match_paths", by_n=paths)
    return {"max_abs_err": err, "checks": checks, "timing": timing, "paths": paths}


def phase_bm25_kernels(torch):
    """K9 bm25_scores and bm25_topk against their plain versions on the
    card at config 3's shapes (N in {1,000, 11,000, 202,000, 2^20}
    candidates, T in {1, 2, 8}, int32 and f32 tf, one total length above
    2^24), then at T = 2: the kernel's median time beside its bytes bound
    and the plain version's, bm25_topk's, and the crossover: the old device
    path (upload tf / df / lengths, launch, download) beside the numpy twin
    on the same arrays; then K9's match (phase_bm25_match), whose per-query
    paths join the crossover rows."""
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.ops import bm25 as B

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(13)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    err = 0.0
    cases = [(n, t, ti, 12e6) for n in (1000, 11_000, 202_000, 1 << 20) for t in (1, 2, 8)
             for ti in (False, True)] + [(1 << 20, 2, False, 20_000_001.0)]
    for n, t, tf_int, tl in cases:
        tf, df, lens, dc, tl32 = (up(a) if isinstance(a, np.ndarray) else a
                                  for a in bm25_inputs(rng, n, t, tf_int, tl))
        got = B.bm25_scores(tf, df, lens, dc, tl32)
        torch.cuda.synchronize()
        want = B.bm25_scores_plain(tf, df, lens, dc, tl32)
        e = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, **BM25_TOL))
        gv, gi = B.bm25_topk(tf, df, lens, dc, tl32, 10)
        torch.cuda.synchronize()
        wv, wi = B.bm25_topk_plain(tf, df, lens, dc, tl32, 10)
        top_ok = bool(torch.allclose(gv, wv, **BM25_TOL)) and gi.dtype == torch.int32 and \
            ids_match_up_to_ties(gv[None].cpu().numpy(), gi[None].cpu().numpy(),
                                 wv[None].cpu().numpy(), wi[None].cpu().numpy(), tol=BM25_TOL)
        emit("bm25_check", n=n, t=t, tf="int32" if tf_int else "float32", total_len=tl,
             max_abs_err=e, ok=ok, topk_ids_equal=bool(torch.equal(gi, wi)), topk_ok=top_ok)
        require(ok and top_ok, f"K9 N={n} T={t} int={tf_int} disagrees with its plain version")
        err = max(err, e)
    timing = {}
    saved = cnf.TPU_FT_ONDEVICE_THRESHOLD
    cnf.TPU_FT_ONDEVICE_THRESHOLD = 1  # score_candidates always takes the card
    try:
        for n in (1000, 11_000, 202_000, 1 << 20):
            host = bm25_inputs(rng, n, 2, False)
            tf, df, lens, dc, tl = (up(a) if isinstance(a, np.ndarray) else a for a in host)
            nbytes = tf.numel() * 4 + df.numel() * 4 + lens.numel() * 4 + n * 4
            ops = 5.0 * tf.numel() + 3.0 * n + 4.0 * df.numel()
            bound, by = bound_ms(nbytes, ops, "float32")
            k_bound, k_by = bound_ms(nbytes - n * 4 + 10 * 8, ops, "float32")
            timing[n] = dict(
                ms=median_ms(lambda: B.bm25_scores(tf, df, lens, dc, tl), iters=20),
                queued_ms=queued_device_ms(torch, lambda: B.bm25_scores(tf, df, lens, dc, tl)),
                plain_ms=median_ms(lambda: B.bm25_scores_plain(tf, df, lens, dc, tl)),
                library_ms=None, bound_ms=bound, bound_by=by,
                topk_ms=median_ms(lambda: B.bm25_topk(tf, df, lens, dc, tl, 10), iters=20),
                topk_queued_ms=queued_device_ms(
                    torch, lambda: B.bm25_topk(tf, df, lens, dc, tl, 10)),
                topk_plain_ms=median_ms(lambda: B.bm25_topk_plain(tf, df, lens, dc, tl, 10)),
                topk_bound_ms=k_bound, topk_bound_by=k_by,
            )
            emit("timing_bm25", n=n, t=2, tf="float32", **timing[n])
        # the crossover: the engine's device path (three uploads, K9, one
        # download) beside the numpy twin on the same arrays
        crossover = {}
        for n in (500, 1000, 2000, 3000, 5000, 8000, 11_000, 202_000, 1 << 20):
            host = bm25_inputs(rng, n, 2, False)
            crossover[n] = dict(
                engine_device_path_ms=median_host_ms(lambda: B.score_candidates(dev, *host)),
                engine_host_twin_ms=median_host_ms(lambda: B.bm25_scores_host(*host)),
            )
    finally:
        cnf.TPU_FT_ONDEVICE_THRESHOLD = saved
    match = phase_bm25_match(torch)
    for n, row in match["paths"].items():  # the engine's new per-query path beside the old
        crossover[n].update(row)
    emit("bm25_crossover", t=2, by_n=crossover)
    return {"max_abs_err": err, "timing": timing, "crossover": crossover, "checks": len(cases),
            "match": match}


def phase_main_path_bm25(torch, device: str, n_docs: int, batch: int, n_seq: int,
                         n_threads: int, rounds: int):
    """Bench config 3 through Datastore.execute: ingest as bench.py
    ingest_docs does, then bench_bm25's queries sequentially and from
    n_threads clients, and the broad one-term query on w0000, with
    cnf.TPU_FT_ONDEVICE_THRESHOLD lowered to 1 so every query whose words
    all have postings launches K9's match (bm25_match_scores, over the
    postings the first query uploads) once, and nothing launches
    bm25_scores; then one query inside a transaction that writes to the
    index (the KV path: one bm25_scores); then the sequential queries again
    at the default threshold (the match where the rarest list reaches it,
    here none: the numpy twin). Every answer must equal FtReference's."""
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.kvs.ds import Datastore

    pairs = ft_query_pairs(n_seq + n_threads * rounds)
    texts = [f"{ft_word(a)} {ft_word(b)}" for a, b in pairs]
    saved = cnf.TPU_FT_ONDEVICE_THRESHOLD
    ds = Datastore("memory", device=device)
    try:
        run = sql_runner(ds)
        run(FT_SCHEMA)
        words, ingest_s = ft_ingest(run, n_docs, batch)
        ref = FtReference(words)
        t = time.perf_counter()
        want = [ref.top(p) for p in pairs] + [ref.top([0])]
        ref_s = time.perf_counter() - t
        cand = [w[2] for w in want]

        def check(i, res, what):
            ids, scores, _ = want[i]
            got_ids = [int(r["id"].id) for r in res]
            require(got_ids == ids.tolist(),
                    f"{what}: query {i} ({texts[i] if i < len(texts) else 'w0000'}) "
                    f"returned {got_ids}, reference {ids.tolist()}")
            got = np.array([r["sc"] for r in res], dtype=np.float64)
            require(np.allclose(got, scores, rtol=BM25_TOL["rtol"], atol=0),
                    f"{what}: query {i} scores {got} vs reference {scores}")

        cnf.TPU_FT_ONDEVICE_THRESHOLD = 1
        t = time.perf_counter()
        check(0, run(FT_SQL.format(texts[0])), "first query")
        first_query_s = time.perf_counter() - t  # builds the mirror, uploads the postings
        mirror = ds.index_stores.get("test", "test", "doc", "fbody")
        post = mirror._dev[2] if mirror is not None and mirror._dev else None
        postings = None if post is None else dict(
            device=str(post.device), bytes=post.nbytes, upload_s=post.seconds,
            postings=int(mirror.t_indptr[-1]))
        emit("bm25_postings_on_device", first_query_s=first_query_s, postings=postings)
        mem0 = window_start(torch, device)
        # what still holds device memory from earlier phases: every tensor
        # of 16 MB or more (this phase's own are a few MB)
        holders = tensor_holders(torch, 1 << 24) if device == "cuda" else None
        if holders:
            emit("held_at_window_start", holders=holders)
        reset_launches()
        results, timing = drive_queries(lambda i: run(FT_SQL.format(texts[i])), len(texts),
                                        n_seq, n_threads, rounds, None)
        t = time.perf_counter()
        results.append(run(FT_SQL.format(ft_word(0))))
        broad_ms = (time.perf_counter() - t) * 1e3
        if device == "cuda":
            torch.cuda.synchronize()
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        for i, res in enumerate(results):
            check(i, res, "threshold 1")
        non_empty = sum(c > 0 for c in cand)
        # the match runs once a query whose every word has postings (the
        # rarest list reaches threshold 1), scoring on the card; no bm25_scores
        ranks = [list(p) for p in pairs] + [[0]]
        with_postings = sum(ref.rarest(r) > 0 for r in ranks)
        if device == "cuda":
            want_l = {c.name: 0 for c in kernel_counters()}
            want_l["bm25_match_scores"] = with_postings
            require(launches == want_l,
                    f"launches {launches}, expected {with_postings} bm25_match_scores")
        busy = None
        for _ in range(2 if device == "cuda" else 0):  # once more if no device time came back
            busy = device_busy_share(torch, lambda: [
                run(FT_SQL.format(texts[i])) for i in range(8)
            ])
            if busy["device_ms"] != "not measured":
                break

        # the in-transaction path (idx/ft_index.py search, for a transaction
        # with its own write to the index) still scores with bm25_scores:
        # one launch; the document is deleted again, so the corpus is as before
        new_ranks = [int(pairs[0][0])] * 5 + [int(pairs[0][1])] * 5 + [200, 201]  # ranks first
        body = " ".join(ft_word(r) for r in new_ranks)
        tx_want = FtReference(np.vstack([words, np.array([new_ranks], dtype=words.dtype)])).top(
            pairs[0])
        lt = read_launches()
        t = time.perf_counter()
        tx = ds.execute(f"BEGIN; CREATE doc:{n_docs} SET body = '{body}'; "
                        f"{FT_SQL.format(texts[0])}; COMMIT;")
        txn_query_ms = (time.perf_counter() - t) * 1e3
        require(all(r.get("status") == "OK" for r in tx), f"the transaction failed: {tx}")
        got_ids = [int(r["id"].id) for r in tx[-1]["result"]]
        got_sc = np.array([r["sc"] for r in tx[-1]["result"]], dtype=np.float64)
        require(got_ids == tx_want[0].tolist() and n_docs in got_ids and
                np.allclose(got_sc, tx_want[1], rtol=BM25_TOL["rtol"], atol=0),
                f"in-transaction query returned {got_ids}, reference {tx_want[0].tolist()}")
        lt1 = read_launches()
        txn_launches = {k: lt1[k] - lt[k] for k in ("bm25_scores", "bm25_match_scores")}
        require(device != "cuda" or txn_launches == {"bm25_scores": 1, "bm25_match_scores": 0},
                f"the in-transaction query launched {txn_launches}")
        run(f"DELETE doc:{n_docs}")

        cnf.TPU_FT_ONDEVICE_THRESHOLD = saved  # what users get today: the numpy twin
        l0 = read_launches()
        lat = []
        for i in range(n_seq):
            t = time.perf_counter()
            res = run(FT_SQL.format(texts[i]))
            lat.append(time.perf_counter() - t)
            check(i, res, f"threshold {saved}")
        # at the default the match runs where the rarest list reaches the
        # threshold, and scores on the card where the candidates do: `above`
        above = sum(c >= saved for c in cand[:n_seq])
        reach = sum(ref.rarest(r) >= saved for r in ranks[:n_seq])
        device_scored = sum(ref.rarest(r) >= saved and c >= saved
                            for r, c in zip(ranks[:n_seq], cand[:n_seq]))
        l1 = read_launches()
        require(device_scored == above and l1["bm25_scores"] == l0["bm25_scores"] and
                l1["bm25_match_scores"] - l0["bm25_match_scores"] ==
                (reach if device == "cuda" else 0),
                f"the default threshold launched the match other than {reach} times")
        out = dict(
            docs=n_docs, words_per_doc=FT_WORDS, vocab=FT_VOCAB, device=str(ds.device),
            ingest_s=ingest_s, ingest_rows_per_s=n_docs / ingest_s, reference_s=ref_s,
            first_query_s=first_query_s, threshold=1, **timing,
            broad_query_ms=broad_ms, broad_candidates=cand[-1],
            candidates=dict(min=int(min(cand[:-1])), p50=float(np.median(cand[:-1])),
                            max=int(max(cand[:-1])), empty=int(sum(c == 0 for c in cand)),
                            single_term=int(sum(a == b for a, b in pairs))),
            launches=launches, non_empty_queries=non_empty, queries_with_postings=with_postings,
            postings_on_device=postings, default_match_launches=reach,
            txn_query_ms=txn_query_ms, txn_query_launches=txn_launches,
            default_device_scored=device_scored,
            profiled_8_seq_queries=busy, peak_device_memory_bytes=peak,
            device_memory_at_window_start_bytes=mem0,
            window_peak_above_start_bytes=None if peak is None else peak - mem0,
            large_tensors_at_window_start=sorted(holders or ()),
            default_threshold=saved, default_seq_p50_ms=statistics.median(lat) * 1e3,
            default_seq_qps=n_seq / sum(lat),
        )
        emit("main_path_bm25", **out)
        return out
    finally:
        cnf.TPU_FT_ONDEVICE_THRESHOLD = saved
        ds.close()


# ------------------------------------------------------------------ ML (K10)
ML_MLP_HIDDEN = 128  # the scan's MLP: 768 -> 128 relu -> 10 softmax
ML_MLP_OUT = 10
# the row path reads the record range item:0..ML_ROW_IDS (a WHERE id <
# item:16384 scans all 2^20 rows: ~30 s on the host)
ML_ROW_IDS = 16_384
ML_NARROW_WIDTHS = (2, 10, 16)  # config 5's 768 inputs to a multi-output head
SOFTMAX_TOL = dict(rtol=0.0, atol=1e-6)


def ml_layers(rng, dims, acts):
    """Seeded f32 layers (w / sqrt(fan-in), b) for dims[0] -> ... -> dims[-1]."""
    return [{"w": (rng.standard_normal((dims[i], dims[i + 1])) / np.sqrt(dims[i]))
             .astype(np.float32),
             "b": rng.standard_normal(dims[i + 1]).astype(np.float32), "activation": act}
            for i, act in enumerate(acts)]


def ml_reference(feats, layers, step: int = 65_536):
    """An independent numpy f64 forward over f32 features -> [n, out] f64."""
    out = []
    for i in range(0, feats.shape[0], step):
        h = feats[i : i + step].astype(np.float64)
        for lay in layers:
            h = h @ lay["w"].astype(np.float64) + lay["b"].astype(np.float64)
            act = lay["activation"]
            if act == "relu":
                h = np.maximum(h, 0.0)
            elif act == "tanh":
                h = np.tanh(h)
            elif act == "sigmoid":
                h = 1.0 / (1.0 + np.exp(-h))
            elif act == "softmax":
                e = np.exp(h - h.max(axis=1, keepdims=True))
                h = e / e.sum(axis=1, keepdims=True)
        out.append(h)
    return np.concatenate(out)


def ml_models(dim: int, seed: int):
    """The ML phase's seeded models: the scorer (a linear dim -> 1, b = 0,
    as bench_ml_scan imports it) and the MLP (dim -> 128 relu -> 10
    softmax), each a list of layers."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((dim, 1)).astype(np.float32)
    scorer = [{"w": w, "b": np.zeros(1, np.float32), "activation": None}]
    return scorer, ml_layers(rng, (dim, ML_MLP_HIDDEN, ML_MLP_OUT), ("relu", "softmax"))


def import_layers(ds, name: str, layers) -> None:
    """import_model of a linear / MLP spec of `layers` as ml::name<1>."""
    from surrealdb_tpu_torch.dbs.session import Session
    from surrealdb_tpu_torch.ml.exec import import_model

    import_model(ds, Session.owner(), name, "1", {
        "format": "mlp" if len(layers) > 1 else "linear",
        "layers": [{"w": l["w"].tolist(), "b": l["b"].tolist(),
                    "activation": l["activation"]} for l in layers]})


def linear_bound(m: int, k: int, n: int, x_bytes: int):
    """The least time of one f32-accurate [m, k] x [k, n] product on the
    card: x read and out written once at HBM rate, or its bf16 limb
    products on the tensor cores (3 passes for bf16 x, 6 for f32 x) at the
    bf16 peak, whichever is longer; beside it the f32 FMA bound of the same
    product on the CUDA cores."""
    nbytes = m * k * x_bytes + k * n * 4 + n * 4 + m * n * 4
    passes = 3 if x_bytes == 2 else 6
    bound, by = bound_ms(nbytes, 2.0 * m * k * n * passes, "bfloat16")
    return bound, by, bound_ms(nbytes, 2.0 * m * k * n, "float32")[0]


def phase_ml_kernels(torch):
    """K10 ml_linear and ml_softmax against their plain versions on the card:
    config 5's [2^20, 768] bf16 x [768, 1] and the same in f32; the MLP
    768 -> 128 relu -> 64 tanh -> 16 sigmoid and 768 -> 128 -> 10 softmax
    at 2^20 rows, each layer on the plain version's input; config 5's
    width to N = 2 (bf16: the skinny path), 10 and 16 (the narrow); the
    row path's 768 -> 1 at M = 1,024, 4,096 and 65,536; M = 100,003 (no multiple of
    any path's row tile) at N = 1 and 130. For each: the median time by an
    event pair and queued (20 calls behind a sleep kernel), the bound
    (linear_bound), the plain version's time, and torch.addmm(b, x.float(),
    W) (TF32 off) with, for bf16 x, the cast alone and addmm on a pre-cast
    x."""
    from surrealdb_tpu_torch.ml import model as ML

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    big = 1 << 20

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=g)

    def layer(k, n):
        return rand(k, n) / float(np.sqrt(k)), rand(n)

    cases = []  # (label, x, w, b, act, softmax after)
    x768 = rand(big, DIM)
    xb = x768.to(torch.bfloat16)
    w1, b1 = layer(DIM, 1)
    cases += [("config5_bf16", xb, w1, torch.zeros(1, device=dev), None, False),
              ("config5_f32", x768, w1, torch.zeros(1, device=dev), None, False)]
    wh, bh = layer(DIM, 128)
    h1 = ML.linear_act_plain(xb, wh, ML.Epilogue.layer(bh, "relu"))
    w2, b2 = layer(128, 64)
    h2 = ML.linear_act_plain(h1, w2, ML.Epilogue.layer(b2, "tanh"))
    w3, b3 = layer(64, 16)
    w4, b4 = layer(128, 10)
    cases += [("mlp_768x128_relu_bf16", xb, wh, bh, "relu", False),
              ("mlp_128x64_tanh", h1, w2, b2, "tanh", False),
              ("mlp_64x16_sigmoid", h2, w3, b3, "sigmoid", False),
              ("mlp_128x10_softmax", h1, w4, b4, None, True)]
    for m in (1024, 4096, 65_536):
        cases.append((f"row_path_m{m}", x768[:m].contiguous(), w1, b1, None, False))
    odd = 100_003
    w5, b5 = layer(DIM, 130)
    cases += [("ragged_m100003_n1_bf16", xb[:odd].contiguous(), w1, b1, "sigmoid", False),
              ("ragged_m100003_n130", x768[:odd].contiguous(), w5, b5, "relu", True)]
    for n in ML_NARROW_WIDTHS:
        wn, bn = layer(DIM, n)
        cases.append((f"narrow_768x{n}_bf16", xb, wn, bn, None, False))
    results, lin_err, sm_err = {}, 0.0, 0.0
    for label, x, w, b, act, softmax in cases:
        ep = ML.Epilogue.layer(b, act)
        got = ML.linear_act(x, w, ep)
        torch.cuda.synchronize()
        want = ML.linear_act_plain(x, w, ep)
        e = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, **TOL))
        m, k = x.shape
        n = w.shape[1]
        bound, by, fma_bound = linear_bound(m, k, n, x.element_size())
        r = dict(m=m, k=k, n=n, x=str(x.dtype).split(".")[-1], act=act, max_abs_err=e, ok=ok,
                 ms=median_ms(lambda: ML.linear_act(x, w, ep)),
                 queued_ms=queued_device_ms(torch, lambda: ML.linear_act(x, w, ep)),
                 plain_ms=median_ms(lambda: ML.linear_act_plain(x, w, ep)),
                 library_ms=median_ms(lambda: torch.addmm(b, x.float(), w)),
                 library_queued_ms=queued_device_ms(torch, lambda: torch.addmm(b, x.float(), w)),
                 bound_ms=bound, bound_by=by, f32_fma_bound_ms=fma_bound)
        if x.dtype == torch.bfloat16:
            r["library_cast_ms"] = median_ms(lambda: x.float())
            xf = x.float()
            r["library_nocast_ms"] = median_ms(lambda: torch.addmm(b, xf, w))
            r["library_nocast_queued_ms"] = queued_device_ms(torch, lambda: torch.addmm(b, xf, w))
            del xf
        require(ok, f"ml_linear {label} disagrees with its plain version (max {e})")
        lin_err = max(lin_err, e)
        if softmax:
            h = want
            sgot = ML.row_softmax(h)
            torch.cuda.synchronize()
            swant = ML.row_softmax_plain(h)
            se = float((sgot - swant).abs().max())
            sok = bool(torch.allclose(sgot, swant, **SOFTMAX_TOL)) and \
                bool(torch.isfinite(sgot).all())
            sb, sby = bound_ms(2.0 * h.numel() * 4, 5.0 * h.numel(), "float32")
            r["softmax"] = dict(
                max_abs_err=se, ok=sok, ms=median_ms(lambda: ML.row_softmax(h)),
                queued_ms=queued_device_ms(torch, lambda: ML.row_softmax(h)),
                plain_ms=median_ms(lambda: ML.row_softmax_plain(h)),
                library_ms=median_ms(lambda: torch.softmax(h, dim=-1)),
                library_queued_ms=queued_device_ms(torch, lambda: torch.softmax(h, dim=-1)),
                bound_ms=sb, bound_by=sby)
            require(sok, f"ml_softmax after {label} disagrees with its plain version ({se})")
            sm_err = max(sm_err, se)
        results[label] = r
        emit("ml_check", case=label, **r)
        del got, want
    return {"max_abs_err": lin_err, "softmax_max_abs_err": sm_err, "cases": results}


ML_PATH_VARIANTS = {"skinny": 1, "narrow_r2": 2, "narrow_r4": 3}  # ml.cu's -DML_FORCE_PATH


def build_ml_variants():
    """csrc/ml.cu alone, built once a ML_PATH_VARIANTS value (N <= 16 forced
    onto the skinny path, or onto the narrow path with 2 rows a thread, or
    with 4 where N > 4), each nvcc of its own, side by side, into the
    gitignored build root; -> {name: ctypes library}."""
    import ctypes

    from surrealdb_tpu_torch.ops import _cuda

    src = os.path.join(_cuda.CSRC, "ml.cu")
    out = os.path.join(_cuda.BUILD_ROOT, "ml_paths_" + _cuda._digest([src]))
    os.makedirs(out, exist_ok=True)
    nvcc = _cuda._nvcc()
    sos = {name: os.path.join(out, f"libml_{name}.so") for name in ML_PATH_VARIANTS}
    cmds = [[nvcc, *_cuda.NVCC_FLAGS, f"-DML_FORCE_PATH={code}", "-shared", "-o", sos[name], src]
            for name, code in ML_PATH_VARIANTS.items()]
    for (rc, log), name in zip(_cuda._run_all(cmds, out), sos):
        require(rc == 0, f"nvcc of ml.cu ({name} variant) failed:\n{log[-3000:]}")
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(so)
        restype, argtypes = _cuda._SIGNATURES["ml_linear"]
        lib.ml_linear.restype, lib.ml_linear.argtypes = restype, argtypes
        libs[name] = lib
    return libs


def phase_ml_paths(torch):
    """ml_linear's skinny and narrow (2 or 4 rows a thread) designs at 2 <=
    N <= 16 on the same inputs (build_ml_variants): config 5's width (bf16,
    K = 768) at N = 2, 10 and 16 and the MLP's f32 layers 64 -> 16 and
    128 -> 10, 2^20 rows each; each held to the plain version (TOL), timed
    by an event pair and queued. The measurement behind ml.cu's (K, N)
    rule."""
    from surrealdb_tpu_torch.ml import model as ML

    t0 = time.perf_counter()
    libs = build_ml_variants()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    big = 1 << 20
    stream = torch.cuda.current_stream(dev).cuda_stream
    cases = [(f"768x{n}_bf16", DIM, n, torch.bfloat16) for n in ML_NARROW_WIDTHS]
    cases += [("64x16_f32", 64, 16, torch.float32), ("128x10_f32", 128, 10, torch.float32)]
    out = {"build_s": build_s}
    for label, k, n, dtype in cases:
        x = torch.randn(big, k, device=dev, generator=g).to(dtype)
        w = torch.randn(k, n, device=dev, generator=g) / float(np.sqrt(k))
        b = torch.randn(n, device=dev, generator=g)
        ep = ML.Epilogue.layer(b, None)
        want = ML.linear_act_plain(x, w, ep)
        rec = {}
        for name, lib in libs.items():
            y = torch.empty(big, n, device=dev)
            status = []

            def run():
                status.append(ML._launch_linear(lib, x, w, ep, y, stream))

            run()
            torch.cuda.synchronize()
            e = float((y - want).abs().max())
            require(bool(torch.allclose(y, want, **TOL)),
                    f"ml.cu's {name} variant disagrees at {label} (max {e})")
            rec[name] = dict(max_abs_err=e, ms=median_ms(run),
                             queued_ms=queued_device_ms(torch, run))
            require(not any(status), f"ml.cu's {name} variant failed to launch: {set(status)}")
        bound, by, _ = linear_bound(big, k, n, x.element_size())
        emit("ml_paths", case=label, bound_ms=bound, bound_by=by, **rec)
        out[label] = dict(bound_ms=bound, **rec)
        del x, y, want
    return out


def ml_launch_delta(before: dict) -> dict:
    after = read_launches()
    return {n: after[n] - before.get(n, 0) for n in after if after[n] - before.get(n, 0)}


ML_SCAN_STEPS = {  # cProfile function name -> the scan's step it is
    "try_columnar_ml_scan": "whole columnar scan",
    "keys": "table key count (txn.keys)",
    "device_snapshot": "mirror snapshot",
    "fwd": "forward (K10 launches + download)",
    "nonzero": "live mask",
    "<built-in method builtins.sorted>": "key-order sort (with enc_value_key)",
    "enc_value_key": "enc_value_key calls",
}


def ml_profile(fn):
    """cProfile one call of fn(): the cumulative seconds of the scan's
    steps (ML_SCAN_STEPS; cProfile's per-call cost inflates the Python
    loops, the sort's key calls most) and the 8 functions with the most
    self time. The output list is built in try_columnar_ml_scan's own
    frame (its self time)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    wall = time.perf_counter() - t0
    steps, top = {}, []
    for (fname, line, func), (_cc, nc, tt, ct, _callers) in pstats.Stats(prof).stats.items():
        top.append((tt, f"{os.path.basename(fname)}:{line}:{func}", nc, ct))
        step = ML_SCAN_STEPS.get(func)
        if step is not None:
            prev = steps.get(step, {"cum_s": 0.0, "self_s": 0.0, "calls": 0})
            steps[step] = {"cum_s": prev["cum_s"] + ct, "self_s": prev["self_s"] + tt,
                           "calls": prev["calls"] + nc}
    top.sort(reverse=True)
    return {"wall_s_under_cprofile": wall, "steps": steps,
            "top_self": [{"fn": lab, "self_s": tt, "cum_s": ct, "calls": nc}
                         for tt, lab, nc, ct in top[:8]]}


@contextlib.contextmanager
def forward_events(torch, cm, device):
    """CUDA events around each call of the model's device function (its
    launches; the download follows it) while the block runs: yields the
    list of their device times in ms."""
    fwd = cm._device_fn(device)
    ms = []

    def timed(x):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        y = fwd(x)
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
        return y

    cm._device_fns[device] = timed
    try:
        yield ms
    finally:
        cm._device_fns[device] = fwd


def ml_forward_share(torch, ds, cm, scan):
    """The device time of one scan's forward (forward_events) and its share
    of the scan's wall time: the busy share where the profiler records no
    device time."""
    with forward_events(torch, cm, ds.device) as ms:
        t0 = time.perf_counter()
        scan()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {"wall_ms": wall_ms, "forward_device_ms": sum(ms), "forwards": len(ms),
            "busy_share": sum(ms) / wall_ms}


def phase_main_path_ml(torch, device: str, ds, corpus, seed: int = 5):
    """Bench config 5 over the HNSW phase's open Datastore (config 2's items,
    ids = row numbers): ml::scorer<1> imported as bench_ml_scan does (a
    linear 768 -> 1, rng.standard_normal weights, b = 0), `SELECT VALUE
    ml::scorer<1>(emb) FROM item` once to warm up and 5 timed runs, once
    under cnf.TPU_DISABLE (bench.py's cpu_mode baseline), then an MLP
    (768 -> 128 relu -> 10 softmax) over the same scan, then the row path
    `SELECT id, ml::scorer<1>(emb) AS s FROM item:0..16384`
    (one batched forward above the 1024-row threshold). Every answer equals
    a numpy f64 forward over the features as the device holds them (bf16 on
    the card), in key order, within TOL; each scan is one dispatch and K10's
    launches are forwards x layers (+ one softmax)."""
    from surrealdb_tpu_torch import cnf

    n, dim = corpus.shape
    run = sql_runner(ds)
    scorer, mlp = ml_models(dim, seed)
    run("DEFINE MODEL ml::scorer<1>; DEFINE MODEL ml::mlp<1>")
    for name, layers in (("scorer", scorer), ("mlp", mlp)):
        import_layers(ds, name, layers)
    sql = "SELECT VALUE ml::scorer<1>(emb) FROM item"
    mlp_sql = "SELECT VALUE ml::mlp<1>(emb) FROM item"
    rows_sql = f"SELECT id, ml::scorer<1>(emb) AS s FROM item:0..{ML_ROW_IDS}"
    n_rows_path = min(ML_ROW_IDS, n)

    t = time.perf_counter()
    # the features as the device holds them: the card's mirror is bf16
    feats = corpus if device == "cpu" else \
        torch.from_numpy(corpus).to(torch.bfloat16).to(torch.float32).numpy()
    want = ml_reference(feats, scorer)[:, 0]
    want_f32 = ml_reference(corpus, scorer)[:, 0]
    want_mlp = ml_reference(feats, mlp)
    reference_s = time.perf_counter() - t

    def check(got, ref, what, tol=TOL):
        got = np.asarray(got, dtype=np.float64)
        require(got.shape == ref.shape and np.isfinite(got).all(),
                f"{what}: shape {got.shape} vs {ref.shape}, or non-finite values")
        e = float(np.abs(got - ref).max())
        require(np.allclose(got, ref, **tol), f"{what}: max abs error {e} against numpy f64")
        return e

    def timed(q):
        t0 = time.perf_counter()
        res = run(q)
        return res, time.perf_counter() - t0

    saved = cnf.TPU_DISABLE
    reset_launches()  # the ML main path's run
    try:
        res, first_s = timed(sql)  # warm-up: key count, the forward's first launch
        cm = ds._ml_cache[("test", "test", "scorer", "1")]
        require(cm.dispatches == 1, f"the first scan took {cm.dispatches} dispatches")
        err_first = check(res, want, "first scan")
        mem0 = window_start(torch, device)
        l0, d0 = read_launches(), cm.dispatches
        secs, errs, dev_f32 = [], [], []
        for _ in range(5):
            res, s_ = timed(sql)
            secs.append(s_)
            errs.append(check(res, want, "timed scan"))
            dev_f32.append(float(np.abs(np.asarray(res, np.float64) - want_f32).max()))
        if device == "cuda":
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        timed_launches = ml_launch_delta(l0)
        require(cm.dispatches - d0 == 5, f"5 scans took {cm.dispatches - d0} dispatches")
        if device == "cuda":
            require(timed_launches == {"ml_linear": 5},
                    f"5 scans launched {timed_launches}, expected 5 ml_linear")

        cnf.TPU_DISABLE = True  # bench.py cpu_mode: the numpy twin over the host mirror
        l0 = read_launches()
        res, host_s = timed(sql)
        cnf.TPU_DISABLE = saved
        err_host = check(res, want_f32, "TPU_DISABLE scan")
        require(not ml_launch_delta(l0), "the TPU_DISABLE scan launched a kernel")

        l0 = read_launches()
        res, mlp_first_s = timed(mlp_sql)
        cm_mlp = ds._ml_cache[("test", "test", "mlp", "1")]
        if device == "cuda":  # the device time of the second scan's forward
            with forward_events(torch, cm_mlp, ds.device) as mlp_forward_ms:
                res, mlp_s = timed(mlp_sql)
        else:
            res, mlp_s = timed(mlp_sql)
            mlp_forward_ms = None
        err_mlp = check(res, want_mlp, "MLP scan")
        require(cm_mlp.dispatches == 2, f"2 MLP scans took {cm_mlp.dispatches} dispatches")
        mlp_launches = ml_launch_delta(l0)
        if device == "cuda":
            require(mlp_launches == {"ml_linear": 4, "ml_softmax": 2},
                    f"2 MLP scans launched {mlp_launches}")

        l0, d0 = read_launches(), cm.dispatches
        res, rows_s = timed(rows_sql)
        require([int(r["id"].id) for r in res] == list(range(n_rows_path)),
                f"the row path returned {len(res)} rows, not ids 0..{n_rows_path - 1} in order")
        err_rows = check([r["s"] for r in res], want_f32[:n_rows_path], "row path")
        require(cm.dispatches - d0 == 1, "the row path took more than one dispatch")
        rows_launches = ml_launch_delta(l0)
        if device == "cuda":
            require(rows_launches == {"ml_linear": 1}, f"the row path launched {rows_launches}")
            torch.cuda.synchronize()
        run_launches = read_launches()
        if device == "cuda":
            require(run_launches["ml_linear"] > 0 and run_launches["ml_softmax"] > 0,
                    f"a kernel of the ML path never launched: {run_launches}")
    finally:
        cnf.TPU_DISABLE = saved
    mirror = ds.index_stores.get("test", "test", "item", "iemb")

    def recount_then_scan():
        mirror._columnar_rows = None  # the first scan's table key count, again
        run(sql)

    profile_first = ml_profile(recount_then_scan)
    profile_steady = ml_profile(lambda: run(sql))
    busy = None
    for _ in range(2 if device == "cuda" else 0):  # once more if no device time came back
        busy = device_busy_share(torch, lambda: run(sql))
        if busy["device_ms"] != "not measured":
            break
    scan_events = ml_forward_share(torch, ds, cm, lambda: run(sql)) \
        if device == "cuda" else None
    out = dict(
        rows=n, dim=dim, device=str(ds.device), datastore="the HNSW phase's, handed over open",
        reference_s=reference_s, first_scan_s=first_s,
        scan_s=secs, scan_p50_s=statistics.median(secs),
        rows_per_s=n / statistics.median(secs),
        host_twin_scan_s=host_s, host_twin_rows_per_s=n / host_s,
        mlp_first_scan_s=mlp_first_s, mlp_scan_s=mlp_s, mlp_rows_per_s=n / mlp_s,
        row_path_rows=n_rows_path, row_path_s=rows_s,
        max_abs_err=dict(first=err_first, timed=max(errs), host_twin=err_host, mlp=err_mlp,
                         row_path=err_rows),
        bf16_policy_max_dev_from_f32_scores=max(dev_f32),
        timed_launches=timed_launches, mlp_launches=mlp_launches,
        row_path_launches=rows_launches, run_launches=run_launches,
        peak_device_memory_bytes=peak, device_memory_at_window_start_bytes=mem0,
        window_peak_above_start_bytes=None if peak is None else peak - mem0,
        profile_first_scan=profile_first, profile_scan=profile_steady,
        profiled_one_scan=busy, forward_events_one_scan=scan_events,
        mlp_forward_events_ms=mlp_forward_ms,
    )
    emit("main_path_ml", **out)
    return out


# ------------------------------------------------------------------ ONNX (K16)
# ONNX models written here from seeded weights (protobuf wire format, the
# fields onnx_mini.py parses); nothing is downloaded
def pb_varint(v: int) -> bytes:
    out = b""
    while True:
        c = v & 0x7F
        v >>= 7
        out += bytes([c | (0x80 if v else 0)])
        if not v:
            return out


def pb_ld(field: int, payload: bytes) -> bytes:
    return pb_varint((field << 3) | 2) + pb_varint(len(payload)) + payload


def pb_vint(field: int, v: int) -> bytes:
    return pb_varint(field << 3) + pb_varint(v)


def onnx_tensor(name: str, arr) -> bytes:
    """TensorProto: f32 (or int64) raw data."""
    arr = np.asarray(arr)
    i64 = arr.dtype == np.int64
    t = b"".join(pb_vint(1, d) for d in arr.shape) + pb_vint(2, 7 if i64 else 1)
    return t + pb_ld(8, name.encode()) + pb_ld(9, arr.astype("<i8" if i64 else "<f4").tobytes())


def onnx_attr(name: str, v) -> bytes:
    """AttributeProto: a float, an int, a tensor or a list of ints."""
    import struct

    a = pb_ld(1, name.encode())
    if isinstance(v, float):
        return a + pb_varint((2 << 3) | 5) + struct.pack("<f", v) + pb_vint(20, 1)
    if isinstance(v, int):
        return a + pb_vint(3, v) + pb_vint(20, 2)
    if isinstance(v, np.ndarray):
        return a + pb_ld(5, onnx_tensor("", v)) + pb_vint(20, 4)
    return a + b"".join(pb_vint(8, i) for i in v) + pb_vint(20, 7)


def onnx_value_info(name: str, last_dim=None) -> bytes:
    """ValueInfoProto, shape [N, last_dim] (N dynamic)."""
    if last_dim is None:
        return pb_ld(1, name.encode())
    dims = pb_ld(1, pb_ld(2, b"N")) + pb_ld(1, pb_vint(1, last_dim))
    return pb_ld(1, name.encode()) + pb_ld(2, pb_ld(1, pb_vint(1, 1) + pb_ld(2, dims)))


def onnx_model(nodes, inits, in_dim: int, out: str = "y") -> bytes:
    """ModelProto of one graph: nodes (op, inputs, outputs, attrs), input
    "x" [N, in_dim], initializers {name: array}."""
    graph = b""
    for op, ins, outs, attrs in nodes:
        n = b"".join(pb_ld(1, i.encode()) for i in ins)
        n += b"".join(pb_ld(2, o.encode()) for o in outs) + pb_ld(4, op.encode())
        graph += pb_ld(1, n + b"".join(pb_ld(5, onnx_attr(k, v)) for k, v in attrs.items()))
    graph += b"".join(pb_ld(5, onnx_tensor(k, v)) for k, v in inits.items())
    graph += pb_ld(11, onnx_value_info("x", in_dim)) + pb_ld(12, onnx_value_info(out))
    return pb_vint(1, 7) + pb_ld(7, graph)


def onnx_mlp(layers) -> bytes:
    """Graph A: an MLP's layers as torch.onnx.export writes an nn.Sequential
    of Linears (weights [out, in], Gemm transB=1) with Relu between and
    Softmax(axis=1) last, for ml_layers' relu -> softmax MLP."""
    (l1, l2) = layers
    nodes = [("Gemm", ["x", "w1", "b1"], ["h"], {"transB": 1}), ("Relu", ["h"], ["r"], {}),
             ("Gemm", ["r", "w2", "b2"], ["z"], {"transB": 1}),
             ("Softmax", ["z"], ["y"], {"axis": 1})]
    inits = {"w1": np.ascontiguousarray(l1["w"].T), "b1": l1["b"],
             "w2": np.ascontiguousarray(l2["w"].T), "b2": l2["b"]}
    return onnx_model(nodes, inits, l1["w"].shape[0])


ONNX_HEAD_HIDDEN, ONNX_HEAD_GATES = 64, 8  # graph B's widths on the card


def onnx_scaled_head(rng, dim: int, hidden: int = ONNX_HEAD_HIDDEN,
                     gates: int = ONNX_HEAD_GATES) -> bytes:
    """Graph B: a StandardScaler-style input and a gated head. (x - mu) /
    sigma, MatMul + Add, LeakyRelu(0.1), Gemm(alpha 0.5, beta 2, C), Elu,
    Clip(-1, 4), Sigmoid -> the gates g [M, gates]; ReduceMean(g, axes
    [1], keepdims 1) and Concat(g, mean) -> [M, gates + 1]."""
    f = rng.standard_normal
    inits = {"mu": (0.05 * f(dim)).astype(np.float32),
             "sigma": (1.0 + 0.1 * np.abs(f(dim))).astype(np.float32),
             "w1": (f((dim, hidden)) / np.sqrt(dim)).astype(np.float32),
             "b1": (0.1 * f(hidden)).astype(np.float32),
             "w2": (f((hidden, gates)) / np.sqrt(hidden)).astype(np.float32),
             "c": f(gates).astype(np.float32),
             "lo": np.array(-1.0, np.float32), "hi": np.array(4.0, np.float32)}
    nodes = [("Sub", ["x", "mu"], ["xc"], {}), ("Div", ["xc", "sigma"], ["xs"], {}),
             ("MatMul", ["xs", "w1"], ["h"], {}), ("Add", ["h", "b1"], ["hb"], {}),
             ("LeakyRelu", ["hb"], ["hl"], {"alpha": 0.1}),
             ("Gemm", ["hl", "w2", "c"], ["z"], {"alpha": 0.5, "beta": 2.0}),
             ("Elu", ["z"], ["ze"], {}), ("Clip", ["ze", "lo", "hi"], ["zc"], {}),
             ("Sigmoid", ["zc"], ["g"], {}),
             ("ReduceMean", ["g"], ["m"], {"axes": [1], "keepdims": 1}),
             ("Concat", ["g", "m"], ["y"], {"axis": 1})]
    return onnx_model(nodes, inits, dim)


def surml_file(onnx_raw: bytes, name: str, version: str) -> bytes:
    """A .surml container (ml/surml.py): no keys, normalisers or output
    normaliser, so a call feeds the vector straight through."""
    import struct

    # a leading separator: parse_surml drops one empty first field
    header = "//=>" + "//=>".join(["", "", "", name, version, "a gated head over config 5's "
                                   "items", "onnx", "chip_smoke.py", "surrealdb_tpu_torch"])
    header = header.encode()
    return struct.pack(">I", len(header)) + header + onnx_raw


def ulp_distance(torch, a, b):
    """Per element |a - b| in f32 units in the last place; 0 where both are
    NaN (a NaN against a number: 2^31)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    an, bn = torch.isnan(a), torch.isnan(b)
    d = (ordered(a) - ordered(b)).abs()
    d = torch.where(an & bn, torch.zeros_like(d), d)
    return torch.where(an ^ bn, torch.full_like(d, 1 << 31), d)


ONNX_EXACT_OPS = ("copy", "add", "sub", "mul", "div", "max", "min", "neg", "relu", "leaky")
# the reductions' tolerance: |kernel - plain| <= 1e-5 sum|x| (the longest
# chain of sequential f32 adds is ~100 of a lane's values, chunk sums and
# butterfly steps; torch.sum's order differs) + 1e-6
REDUCE_TOL = (1e-5, 1e-6)


def ewise_ok(torch, got, want, op, x=None, alpha=0.0):
    """(ok, max ulps): exact ops the same values (NaN where NaN); exp, sqrt,
    pow, tanh, sigmoid, elu within 2 ulp, Elu also within alpha times 2 ulp
    of exp(x) where alpha (exp(x) - 1) cancels near 0."""
    ulps = ulp_distance(torch, got, want)
    if op == "elu":
        e = torch.exp(torch.clamp(x.float(), max=0.0))
        ulps = torch.where((got - want).abs() <= abs(alpha) * 2 * 2.0 ** -23 * e,
                           torch.zeros_like(ulps), ulps)
    worst = int(ulps.max())
    return worst <= (0 if op in ONNX_EXACT_OPS else 2), worst


def special_values(torch, x):
    """x with NaN, +-inf, -0.0 and values near 0 planted (in place)."""
    x[0, :6] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0, -1e-30])
    x[1] = -0.0
    x[2] = torch.linspace(-1e-3, 1e-3, x.shape[1])
    x[3] = torch.linspace(-100, 100, x.shape[1])
    x[7::97] = -0.0
    x[11::101, ::3] = float("nan")
    return x


def phase_onnx_check(torch, device: str = "cuda", m: int = 1 << 20):
    """K16's kernels against their plain versions on the card at 2^20 rows:
    ml_ewise over every op code (f32, and bf16 for three), each broadcast
    shape of the second operand ([N], [M, 1], an immediate), config 5's
    z-score over [2^20, 768] bf16 (graph B's first launch), a strided
    Transpose and a Concat on each axis; ml_reduce over the inner axis
    (graph B's mean, and [2^20, 768] bf16), the outer axis and both;
    ml_linear with an epilogue on its three paths (graph A's first product,
    graph B's two, and the head's chain at N = 1). Each case: event and
    queued ms, its bound (inputs read and outputs written once at 3.35
    TB/s; a product's by linear_bound), the plain version's ms and, where
    one exists, the PyTorch call's (addmm and the activation for a product,
    torch.mean / torch.sum for a reduction). Tolerances: ewise_ok,
    REDUCE_TOL, TOL for a product."""
    import torch.nn.functional as F

    from surrealdb_tpu_torch.ml import model as ML

    t0 = time.perf_counter()
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(19)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=g)

    results = {}

    def timings(fn, plain, library, nbytes, bound=None):
        b, by = bound if bound is not None else bound_ms(nbytes, 0.0, "float32")
        r = dict(ms=median_ms(fn), queued_ms=queued_device_ms(torch, fn),
                 plain_ms=median_ms(plain), bound_ms=b, bound_by=by,
                 library_ms=None if library is None else median_ms(library))
        if library is not None:
            r["library_queued_ms"] = queued_device_ms(torch, library)
        return r

    def out_like(shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    # ---- ml_ewise: every op code over [2^20, 64]
    x64 = special_values(torch, rand(m, 64) * 3)
    col = rand(64)
    col[:4] = torch.tensor([0.0, -0.0, float("nan"), float("inf")])
    row = rand(m, 1)
    row[5::7] = 0.0
    expo = torch.tensor([2.0, 3.0, 0.5, -1.0, 0.0, -2.0, 1.5, 4.0], device=dev).repeat(8)
    shape_of = {"add": "per_column", "sub": "per_row", "mul": "imm", "div": "per_column",
                "pow": "per_column", "max": "per_row", "min": "imm"}
    cases = [(op, torch.float32) for op in ML.EW_OPS] + \
        [(op, torch.bfloat16) for op in ("relu", "sigmoid", "add")]
    worst_ulps = {}
    for op, dtype in cases:
        x = x64.to(dtype)
        alpha = {"leaky": 0.1, "elu": 0.7}.get(op, 0.0)
        kind = shape_of.get(op)
        if kind is None:
            prog, inputs = ML.Program([(op, 4, 0, 0, alpha)], 4), [x]
        elif kind == "imm":
            prog, inputs = ML.Program([(op, 4, 0, ML.IMM, -2.5)], 4), [x]
        else:
            other = expo if op == "pow" else (col if kind == "per_column" else row)
            prog, inputs = ML.Program([(op, 4, 0, 1, 0.0)], 4), [x, other]
        out = out_like((m, 64))
        got = ML.ewise(prog, inputs, out)
        torch.cuda.synchronize()
        want = ML.ewise_plain(prog, inputs, out_like((m, 64)))
        ok, worst = ewise_ok(torch, got, want, op, x, alpha)
        label = f"ewise_{op}_{str(dtype).split('.')[-1]}" + (f"_{kind}" if kind else "")
        require(ok, f"ml_ewise {label} disagrees with its plain version ({worst} ulp)")
        worst_ulps[label] = worst
        nbytes = sum(t.numel() * t.element_size() for t in inputs) + out.numel() * 4
        results[label] = dict(
            kernel="ml_ewise", ulps=worst, max_abs_err=float(
                torch.nan_to_num((got - want).abs(), nan=0.0, posinf=0.0).max()),
            **timings(lambda: ML.ewise(prog, inputs, out),
                      lambda: ML.ewise_plain(prog, inputs, out_like((m, 64))), None, nbytes))
        emit("onnx_check", case=label, **results[label])
    del x64, got, want
    # ---- config 5's z-score: [2^20, 768] bf16 -> f32 (graph B's first launch)
    xb = rand(m, DIM).to(torch.bfloat16)
    mu, sd = rand(DIM) * 0.05, 1.0 + 0.1 * rand(DIM).abs()
    zprog = ML.Program([("sub", 4, 0, 1, 0.0), ("div", 4, 4, 2, 0.0)], 4)
    zout = out_like((m, DIM))
    got = ML.ewise(zprog, [xb, mu, sd], zout)
    torch.cuda.synchronize()
    want = ML.ewise_plain(zprog, [xb, mu, sd], out_like((m, DIM)))
    require(torch.equal(got, want), "ml_ewise's z-score disagrees with its plain version")
    results["ewise_zscore_bf16"] = dict(
        kernel="ml_ewise", max_abs_err=0.0, shape=[m, DIM],
        **timings(lambda: ML.ewise(zprog, [xb, mu, sd], zout),
                  lambda: ML.ewise_plain(zprog, [xb, mu, sd], out_like((m, DIM))), None,
                  m * DIM * 2 + m * DIM * 4 + 2 * DIM * 4))
    emit("onnx_check", case="ewise_zscore_bf16", **results["ewise_zscore_bf16"])
    del got, want
    # ---- layout: a strided Transpose, a Concat on each axis (exact copies)
    copy = ML.Program([("copy", 0, 0, 0, 0.0)], 0)
    a8, b1, c8 = rand(m, 8), rand(m, 1), rand(4096, 8)
    xt = rand(m, 64)

    def transpose():
        return ML.ewise(copy, [xt.t()], out_like((64, m)))

    def cat(axis):
        parts = (a8, b1) if axis == 1 else (a8, c8)
        shape = [m, 9] if axis == 1 else [m + 4096, 8]
        out, off = out_like(shape), 0
        for p in parts:
            ML.ewise(copy, [p], out.narrow(axis, off, p.shape[axis]))
            off += p.shape[axis]
        return out

    for label, fn, want_fn, nbytes in (
            ("ewise_transpose_f32", transpose, lambda: xt.t().contiguous(), 2 * xt.numel() * 4),
            ("ewise_concat_axis1", lambda: cat(1), lambda: torch.cat([a8, b1], 1),
             2 * m * 9 * 4),
            ("ewise_concat_axis0", lambda: cat(0), lambda: torch.cat([a8, c8], 0),
             2 * (m + 4096) * 8 * 4)):
        got = fn()
        torch.cuda.synchronize()
        require(torch.equal(got, want_fn()), f"ml_ewise {label} is not an exact copy")
        results[label] = dict(kernel="ml_ewise", max_abs_err=0.0,
                              launches_a_call=2 if "concat" in label else 1,
                              **timings(fn, want_fn, want_fn, nbytes))
        emit("onnx_check", case=label, **results[label])
    # ---- ml_reduce: the inner axis, the outer axis, both
    g8 = torch.sigmoid(rand(m, 8))
    for label, x, axes, mean, lib_fn in (
            ("reduce_mean_inner_2^20x8", g8, [1], True, lambda: torch.mean(g8, 1, keepdim=True)),
            ("reduce_sum_inner_2^20x768_bf16", xb, [1], False,
             lambda: torch.sum(xb, 1, dtype=torch.float32)),
            ("reduce_mean_outer_2^20x8", g8, [0], True, lambda: torch.mean(g8, 0)),
            ("reduce_sum_both_2^20x8", g8, None, False, lambda: torch.sum(g8))):
        got = ML.reduce_axis(x, axes, True, mean)
        torch.cuda.synchronize()
        want = ML.reduce_axis_plain(x, axes, True, mean)
        scale = ML.reduce_axis_plain(x.float().abs(), axes, True, mean)
        err = (got - want).abs()
        ok = bool((err <= REDUCE_TOL[0] * scale + REDUCE_TOL[1]).all())
        require(ok, f"ml_reduce {label} disagrees with its plain version (max {float(err.max())})")
        results[label] = dict(
            kernel="ml_reduce", max_abs_err=float(err.max()),
            max_rel_err=float((err / want.abs().clamp_min(1e-30)).max()),
            **timings(lambda: ML.reduce_axis(x, axes, True, mean),
                      lambda: ML.reduce_axis_plain(x, axes, True, mean), lib_fn,
                      x.numel() * x.element_size() + got.numel() * 4))
        emit("onnx_check", case=label, **results[label])
    del xb, mu, sd, zout
    # ---- ml_linear with an epilogue on its three paths
    head = [("mul", 0, 0, ML.IMM, 0.5), ("add", 0, 0, 1, 0.0), ("elu", 0, 0, 0, 1.0),
            ("max", 0, 0, ML.IMM, -1.0), ("min", 0, 0, ML.IMM, 4.0),
            ("sigmoid", 0, 0, 0, 0.0)]

    def head_lib(x, w, c2):
        return lambda: torch.sigmoid(torch.clamp(F.elu(torch.addmm(c2, x.float(), w, alpha=0.5)),
                                                 -1.0, 4.0))

    x768b = rand(m, DIM).to(torch.bfloat16)
    x768 = rand(m, DIM)
    h64 = F.leaky_relu(rand(m, ONNX_HEAD_HIDDEN), 0.1)
    lin = []
    w, b = rand(DIM, 128) / float(np.sqrt(DIM)), rand(128)
    lin.append(("linear_wide_add_relu_bf16", x768b, w, ML.Epilogue.layer(b, "relu"),
                (lambda x, w, b: lambda: torch.relu(torch.addmm(b, x.float(), w)))(x768b, w, b)))
    w1, b1 = rand(DIM, ONNX_HEAD_HIDDEN) / float(np.sqrt(DIM)), 0.1 * rand(ONNX_HEAD_HIDDEN)
    lin.append(("linear_wide_add_leaky_f32", x768, w1,
                ML.Epilogue(ML.Program([("add", 0, 0, 1, 0.0), ("leaky", 0, 0, 0, 0.1)], 0),
                            [b1]),
                (lambda: F.leaky_relu(torch.addmm(b1, x768, w1), 0.1))))
    w2 = rand(ONNX_HEAD_HIDDEN, ONNX_HEAD_GATES) / float(np.sqrt(ONNX_HEAD_HIDDEN))
    c2 = 2.0 * rand(ONNX_HEAD_GATES)
    lin.append(("linear_narrow_head_f32", h64, w2, ML.Epilogue(ML.Program(head, 0), [c2]),
                head_lib(h64, w2, c2)))
    ws, cs = rand(DIM, 1) / float(np.sqrt(DIM)), 2.0 * rand(1)
    lin.append(("linear_skinny_head_bf16", x768b, ws, ML.Epilogue(ML.Program(head, 0), [cs]),
                head_lib(x768b, ws, cs)))
    for label, x, w, ep, lib_fn in lin:
        got = ML.linear_act(x, w, ep)
        torch.cuda.synchronize()
        want = ML.linear_act_plain(x, w, ep)
        e = float((got - want).abs().max())
        require(bool(torch.allclose(got, want, **TOL)),
                f"ml_linear {label} disagrees with its plain version (max {e})")
        mm, k = x.shape
        bound, by, fma_bound = linear_bound(mm, k, w.shape[1], x.element_size())
        results[label] = dict(
            kernel="ml_linear", m=mm, k=k, n=w.shape[1], x=str(x.dtype).split(".")[-1],
            epilogue=[i[0] for i in ep.prog.ins], max_abs_err=e, f32_fma_bound_ms=fma_bound,
            **timings(lambda: ML.linear_act(x, w, ep),
                      lambda: ML.linear_act_plain(x, w, ep), lib_fn, 0,
                      (bound, by)))
        emit("onnx_check", case=label, **results[label])
    out = {"cases": results, "seconds": time.perf_counter() - t0,
           "max_abs_err": {kern: max(r["max_abs_err"] for r in results.values()
                                     if r["kernel"] == kern)
                           for kern in ("ml_ewise", "ml_reduce", "ml_linear")},
           "max_ulps": worst_ulps}
    emit("onnx_check_seconds", seconds=out["seconds"])
    return out


ONNX_KERNEL_NAMES = ("ewise_kernel", "reduce_rows_kernel", "reduce_cols_kernel",
                     "skinny_kernel", "narrow_kernel", "wide_kernel", "softmax_rows_kernel",
                     "softmax_warp_kernel", "softmax_long_kernel")


# aten ops that run no device kernel: allocations and views (a plan's
# outputs and its reshapes); a forward that dispatches any other op runs a
# PyTorch kernel (a copy, a fill, an elementwise op) or a host sync
NO_KERNEL_OPS = frozenset((
    "empty.memory_format", "empty_like.default", "empty_strided.default", "view.default",
    "_unsafe_view.default", "as_strided.default", "permute.default", "t.default",
    "transpose.int", "slice.Tensor", "select.int", "expand.default", "unsqueeze.default",
    "squeeze.dim", "squeeze.dims", "alias.default", "detach.default", "_reshape_alias.default"))


def aten_ops(torch, fn):
    """Counter of the aten ops (overload names) one call of fn() dispatches,
    by a TorchDispatchMode: it sees every op on a tensor and every factory
    call, whichever device runs it, and never goes silent; a ctypes launch
    of the port's kernels is no op."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    seen = Counter()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[func.__name__] += 1
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return seen


def config5_store(device: str, corpus, batch: int):
    """An open Datastore on `device` holding config 5's items: the corpus
    under phase 3's MTREE schema (ids = row numbers), ingested with INSERT,
    the mirror built by a first query."""
    from surrealdb_tpu_torch.kvs.ds import Datastore

    ds = Datastore("memory", device=device)
    run = sql_runner(ds)
    run("DEFINE TABLE item SCHEMALESS; "
        f"DEFINE INDEX iemb ON item FIELDS emb MTREE DIMENSION {corpus.shape[1]} DIST EUCLIDEAN")
    t = time.perf_counter()
    ingest(run, corpus, batch)
    run("SELECT id FROM item WHERE emb <|10|> $q", {"q": corpus[0].tolist()})
    emit("config5_store", rows=corpus.shape[0], seconds=time.perf_counter() - t)
    return ds


def onnx_reference(raw: bytes, feats, step: int = 65_536):
    """The graph's numpy f64 forward (OnnxGraph.build_forward(np)) over the
    features in f64, in row blocks on a thread each (numpy's loops and BLAS
    release the GIL; the forward is pure)."""
    from concurrent.futures import ThreadPoolExecutor

    from surrealdb_tpu_torch.ml.onnx_mini import OnnxGraph

    fwd = OnnxGraph(raw).build_forward(np)
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        return np.concatenate(list(pool.map(
            lambda i: fwd(feats[i : i + step].astype(np.float64)),
            range(0, feats.shape[0], step))))


def phase_main_path_onnx(torch, device: str, ds, corpus, seed: int = 5,
                         import_mlp: bool = False):
    """K16's main path over an open Datastore holding config 5's items
    (ids = row numbers, an HNSW or MTREE index on emb, bf16 on the card):
    graph A (`onnx_mlp`: the ML phase's ml::mlp<1> weights as
    torch.onnx.export writes an nn.Sequential, imported as an
    {"format": "onnx"} spec) and graph B (`onnx_scaled_head`, from a .surml
    file through import_surml), each `SELECT VALUE ml::<name><1>(emb) FROM
    item` once to warm up and once timed. Every answer is held to a numpy
    f64 forward of the same graph over the features as the card holds them
    (TOL, key order); each scan is one dispatch and launches exactly its
    plan's kernels, and the four scans are the path's launches (read
    before anything calls a plan directly). Then one forward of each plan
    under aten_ops dispatches no op outside NO_KERNEL_OPS (and launches its
    plan's kernels), and torch.profiler, where it reports, finds only the
    port's kernels; graph A's answers equal ml::mlp<1>'s within TOL. Prints
    rows/s, the forward's device ms (CUDA events) and the window's peak
    memory."""
    from collections import Counter

    from surrealdb_tpu_torch.dbs.session import Session
    from surrealdb_tpu_torch.ml.exec import import_model, import_surml

    t_phase = time.perf_counter()
    n, dim = corpus.shape
    run = sql_runner(ds)
    _, mlp = ml_models(dim, seed)
    if import_mlp:
        run("DEFINE MODEL ml::mlp<1>")
        import_layers(ds, "mlp", mlp)
    graphs = {"onnx_mlp": onnx_mlp(mlp),
              "onnx_scaled_head": onnx_scaled_head(np.random.default_rng(seed + 1), dim)}
    run("DEFINE MODEL ml::onnx_mlp<1>; DEFINE MODEL ml::onnx_scaled_head<1>")
    import_model(ds, Session.owner(), "onnx_mlp", "1",
                 {"format": "onnx", "onnx": graphs["onnx_mlp"]})
    import_surml(ds, Session.owner(),
                 surml_file(graphs["onnx_scaled_head"], "onnx_scaled_head", "1"))
    t = time.perf_counter()
    feats = corpus if device == "cpu" else \
        torch.from_numpy(corpus).to(torch.bfloat16).to(torch.float32).numpy()
    want = {name: onnx_reference(raw, feats) for name, raw in graphs.items()}
    reference_s = time.perf_counter() - t
    del feats

    def check(got, ref, what):
        got = np.asarray(got, dtype=np.float64)
        require(got.shape == ref.shape and np.isfinite(got).all(),
                f"{what}: shape {got.shape} vs {ref.shape}, or non-finite values")
        e = float(np.abs(got - ref).max())
        require(np.allclose(got, ref, **TOL), f"{what}: max abs error {e} against numpy f64")
        return e

    def timed(q):
        t0 = time.perf_counter()
        res = run(q)
        return res, time.perf_counter() - t0

    mirror = ds.index_stores.get("test", "test", "item", "iemb")
    reset_launches()  # the ONNX path's run: the SQL scans below, and nothing else
    out = {"rows": n, "dim": dim, "device": str(ds.device), "reference_s": reference_s}
    answers, plans = {}, {}
    for name in graphs:
        sql = f"SELECT VALUE ml::{name}<1>(emb) FROM item"
        l0 = read_launches()
        res, first_s = timed(sql)  # warm-up: lowers the plan, uploads its weights
        first_launches = ml_launch_delta(l0)
        cm = ds._ml_cache[("test", "test", name, "1")]
        require(cm.dispatches == 1, f"{name}'s first scan took {cm.dispatches} dispatches")
        err_first = check(res, want[name], f"{name} first scan")
        plan = plans[name] = cm._device_fn(ds.device)
        mem0 = window_start(torch, device)
        l0, d0 = read_launches(), cm.dispatches
        fwd_ms = None
        if device == "cuda":
            with forward_events(torch, cm, ds.device) as fwd_ms:
                res, scan_s = timed(sql)
        else:
            res, scan_s = timed(sql)
        err = check(res, want[name], f"{name} timed scan")
        answers[name] = res
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        launches = ml_launch_delta(l0)
        require(cm.dispatches - d0 == 1, f"a {name} scan took {cm.dispatches - d0} dispatches")
        if device == "cuda":
            plan_launches = dict(Counter(plan.kernels))
            for what, got in (("first", first_launches), ("timed", launches)):
                require(got == plan_launches,
                        f"{name}'s {what} scan launched {got}, the plan's {plan_launches}")
        out[name] = dict(plan=list(plan.kernels), first_scan_s=first_s, scan_s=scan_s,
                         rows_per_s=n / scan_s, max_abs_err=max(err_first, err),
                         launches=launches, first_scan_launches=first_launches,
                         forward_device_ms=fwd_ms, peak_device_memory_bytes=peak,
                         device_memory_at_window_start_bytes=mem0,
                         window_peak_above_start_bytes=None if peak is None else peak - mem0)
        emit("main_path_onnx_scan", graph=name, **out[name])
    # the main path's launches: the four scans' alone, read before anything
    # below calls a plan or a model directly
    run_launches = read_launches()
    if device == "cuda":
        want_run = Counter()
        for plan in plans.values():
            want_run.update({k: 2 * v for k, v in Counter(plan.kernels).items()})
        got_run = {k: v for k, v in run_launches.items() if v and k in want_run}
        require(got_run == dict(want_run),
                f"the ONNX scans launched {got_run}, twice their plans' {dict(want_run)}")
        for kern in ("ml_linear", "ml_softmax", "ml_ewise", "ml_reduce"):
            require(run_launches[kern] > 0, f"{kern} never launched on the ONNX path")
    out["run_launches"] = {k: v for k, v in run_launches.items() if v}
    if device == "cuda":  # no PyTorch kernel in a forward, by two witnesses
        matrix, _mask, _rids = mirror.device_snapshot(ds.device)
        for name, plan in plans.items():
            l0 = read_launches()
            ops = aten_ops(torch, lambda: plan(matrix))
            torch.cuda.synchronize()
            foreign = {op: c for op, c in ops.items() if op not in NO_KERNEL_OPS}
            require(sum(ops.values()) > 0 and not foreign,
                    f"{name}'s forward dispatched PyTorch ops that run kernels: {foreign} "
                    f"(all: {dict(ops)})")
            require(ml_launch_delta(l0) == dict(Counter(plan.kernels)),
                    f"{name}'s witnessed forward launched {ml_launch_delta(l0)}")
            kpc = kernels_per_call(torch, lambda: plan(matrix), calls=3)
            if kpc != "not measured":
                foreign_k = [k for k in kpc["by_name"]
                             if not any(ours in k for ours in ONNX_KERNEL_NAMES)]
                require(not foreign_k and not kpc["memsets"],
                        f"{name}'s forward ran kernels not the port's: {foreign_k}, "
                        f"{kpc['memsets']} memsets")
            out[name].update(aten_ops_a_forward=dict(ops), kernels_per_call=kpc)
            emit("main_path_onnx_forward_ops", graph=name, aten_ops=dict(ops),
                 kernels_per_call=kpc)
    # graph A's timed answers against ml::mlp<1>'s, the same weights as a K10 MLP
    mlp_res = np.asarray(run("SELECT VALUE ml::mlp<1>(emb) FROM item"), np.float64)
    a_res = np.asarray(answers["onnx_mlp"], np.float64)
    e = float(np.abs(a_res - mlp_res).max())
    require(a_res.shape == mlp_res.shape and np.allclose(a_res, mlp_res, **TOL),
            f"graph A differs from ml::mlp<1> by {e}")
    out["onnx_mlp_vs_mlp"] = dict(max_abs_diff=e, bit_equal=bool(np.array_equal(a_res, mlp_res)))
    out["seconds"] = time.perf_counter() - t_phase
    emit("main_path_onnx", **{k: v for k, v in out.items() if k not in graphs})
    return out


# ------------------------------------------------------------------ mesh
MESH_SHARDS = 8  # the reference's test mesh (tests/conftest.py), here on one card


def one_device_mesh(torch, device: str, grid=None):
    """MESH_SHARDS shards on one device: the 1-D `data` mesh, or with `grid`
    a 2-D (data, model) one."""
    from surrealdb_tpu_torch.parallel.mesh import Mesh

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    if grid is None:
        return Mesh([dev] * MESH_SHARDS, ("data",))
    return Mesh([dev] * MESH_SHARDS, ("data", "model"), grid)


class MeshForDatastores:
    """Inside the block Datastore.mesh() returns `mesh` (the class-level
    cache, restored on exit)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.prev = None

    def __enter__(self):
        from surrealdb_tpu_torch.kvs.ds import Datastore

        self.prev = Datastore._mesh_cache
        Datastore._mesh_cache = ("mesh", self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        from surrealdb_tpu_torch.kvs.ds import Datastore

        Datastore._mesh_cache = self.prev


def result_ids(res):
    return [int(r["id"].id) for r in res]


def sql_ids_up_to_ties(torch, mirror, rows, queries, got, want, k):
    """Per query, the ids of two strategies equal as sets, or every id in one
    and not the other lies within TOL of the k-th distance of `want`'s ids,
    by the plain K1 over the rows the card holds. Returns (queries with
    equal sets, queries that differ at a tie)."""
    from surrealdb_tpu_torch.idx.knn import _rid_key
    from surrealdb_tpu_torch.sql.value import Thing

    def rows_of(ids):
        return rows[torch.tensor([mirror.slot_of[_rid_key(Thing("item", j))] for j in ids],
                                 device=rows.device)]

    return ids_up_to_ties(torch, rows_of, queries, got, want, k)


def ids_up_to_ties(torch, rows_of, queries, got, want, k):
    """sql_ids_up_to_ties over rows_of(ids) -> [len(ids), D] tensor (the
    rows as the card holds them)."""
    from surrealdb_tpu_torch.ops import distances as D

    equal = tied = 0
    for i, (g, w) in enumerate(zip(got, want)):
        gs, ws = set(result_ids(g)), set(result_ids(w))
        require(len(gs) == len(ws) == k, f"query {i}: {len(gs)} and {len(ws)} ids, want {k}")
        if gs == ws:
            equal += 1
            continue
        ids = sorted(gs | ws)
        held = rows_of(ids)
        q = torch.from_numpy(np.ascontiguousarray(queries[i : i + 1], dtype=np.float32))
        d = D.pairwise_distance_plain(q.to(held.device), held)[0].cpu().numpy()
        dist = dict(zip(ids, d.tolist()))
        kth = max(dist[j] for j in ws)
        band = TOL["atol"] + TOL["rtol"] * abs(kth)
        require(all(abs(dist[j] - kth) <= band for j in gs ^ ws),
                f"query {i}: ids {sorted(gs ^ ws)} differ beyond a tie at {kth}")
        tied += 1
    return equal, tied


def phase_main_path_mesh(torch, device: str, ds, cell: str, index: str, sql: str, strategy: str,
                         per_tile: dict, queries, base_results, base_timing, truth,
                         n_seq: int, n_threads: int, rounds: int):
    """One kNN cell again on its open Datastore, nothing re-ingested, with
    Datastore.mesh() returning MESH_SHARDS shards on one device: the first
    query re-places the mirror row-sharded (the old matrix freed first);
    then the same sequential and concurrent queries as the cell's own
    window. Every one must take `strategy`, launch `per_tile` kernels a
    dispatched tile (none else), and return the cell's own single-device
    answers up to ties; the window's own peak device memory must stay below
    one corpus. Returns the window's numbers, the mesh and the matrix."""
    from surrealdb_tpu_torch import bg
    from surrealdb_tpu_torch.parallel.mesh import ShardedTensor

    k = 10
    run = sql_runner(ds)
    mirror = ds.index_stores.get("test", "test", "item", index)
    ivf0 = mirror.ivf
    mesh = one_device_mesh(torch, device)
    with MeshForDatastores(mesh):
        before = strategies()
        t = time.perf_counter()
        run(sql, {"q": queries[0].tolist()})
        first_s = time.perf_counter() - t
        first = strategy_delta(before)
        require(first == {f'knn_strategy{{strategy="{strategy}"}}': 1.0},
                f"first {cell} query under the mesh took {first}, expected {strategy}")
        require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
        matrix = mirror.device_snapshot(ds.device, mesh)[0]
        require(isinstance(matrix, ShardedTensor) and matrix.base is not None
                and all(matrix.shard((s,)).data_ptr() == matrix.base[s * matrix.shape[0]
                                                                     // MESH_SHARDS].data_ptr()
                        for s in range(MESH_SHARDS)),
                "the mirror is not one tensor viewed by its shards")
        corpus_bytes = matrix.nbytes()
        mem0 = window_start(torch, device)
        before = strategies()
        widths0 = ds.dispatch.width_distribution()
        reset_launches()
        results, timing = drive_queries(lambda i: run(sql, {"q": queries[i].tolist()}),
                                        queries.shape[0], n_seq, n_threads, rounds, strategy)
        require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
        if device == "cuda":
            torch.cuda.synchronize()
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        widths, tiles = dispatched_tiles(ds, widths0)
        delta = strategy_delta(before)
        n_queries = queries.shape[0]
        require(delta == {f'knn_strategy{{strategy="{strategy}"}}': float(n_queries)},
                f"strategies {delta}, expected {n_queries} {strategy}")
        require(mirror.ivf is ivf0, "the quantizer changed in the mesh window")
        if device == "cuda":
            want = {c.name: 0 for c in kernel_counters()}
            want.update({name: n * tiles for name, n in per_tile.items()})
            require(launches == want, f"launches {launches} for {tiles} dispatched tiles")
            require(peak - mem0 < corpus_bytes,
                    f"the window's own peak {peak - mem0} B holds a second corpus")
        equal, tied = sql_ids_up_to_ties(torch, mirror, matrix.base, queries, results,
                                         base_results, k)
        recall = recall_of(results, truth, k)
        busy = device_busy_share(torch, lambda: [
            run(sql, {"q": queries[i].tolist()}) for i in range(8)
        ]) if device == "cuda" else None
    out = dict(
        cell=cell, shards=MESH_SHARDS, device=str(ds.device), strategy=strategy,
        first_query_with_placement_s=first_s, **timing,
        single_device=base_timing,
        dispatch_widths={str(w): c for w, c in sorted(widths.items())},
        tiles_dispatched=tiles, launches=launches, strategies=delta,
        ids_equal_queries=equal, ids_tied_queries=tied, recall_at_10=recall,
        profiled_8_seq_queries=busy, corpus_bytes=corpus_bytes,
        device_memory_at_window_start_bytes=mem0,
        window_own_peak_bytes=None if peak is None else peak - mem0,
    )
    emit("main_path_mesh", **out)
    return out, mesh, matrix


def base_timing_of(out: dict) -> dict:
    return {k: out[k] for k in ("seq_p50_ms", "seq_qps", "conc_p50_ms", "conc_qps")}


def knn_bound(nq: int, n: int, dim: int, k: int):
    """Bytes and operations of an exact top-k over a bf16 [n, dim] corpus
    with a [n] mask: each input read once, each output written once."""
    return bound_ms(nq * dim * 4 + n * dim * 2 + n + nq * k * 8, 2.0 * nq * n * dim, "bfloat16")


def phase_mesh_kernels_exact(torch, matrix, dim: int, k: int = 10):
    """K11 and K12 against their plain versions on the card, on the MTREE
    cell's sharded 2^20 x 768 bf16 mirror (8 shards on cuda:0; K12 on a
    4 x 2 grid of it), with ~5% dead rows; K11 also against single-device
    K2. Then median times (K11 at Q 1 and 64, K12 at Q 1, 4 (the dry run's
    tile) and 64) beside the bound, the plain composition and cdist +
    topk, and the kernels a K12 call runs."""
    from surrealdb_tpu_torch.ops import distances as D
    from surrealdb_tpu_torch.parallel import mesh as M

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    mesh = matrix.mesh
    x = matrix.base
    n = x.shape[0]
    g = torch.Generator().manual_seed(3)
    mask_full = (torch.rand(n, generator=g) > 0.05).to(dev)
    mask = M.shard_tensor(mesh, mask_full, ("data",), copy=False)
    mesh2 = one_device_mesh(torch, "cuda", (4, 2))
    x2 = M.shard_tensor(mesh2, x, ("data", "model"), copy=False)
    mask2 = M.shard_tensor(mesh2, mask_full, ("data",), copy=False)
    errs = {"K11": 0.0, "K12": 0.0}
    for metric in ("euclidean", "cosine"):
        for nq in (1, 4, 64):
            q = torch.randn(nq, dim, generator=g).to(dev)
            if nq != 4:
                got = M.sharded_knn(mesh, matrix, mask, q, k, metric)
                torch.cuda.synchronize()
                want = M.sharded_knn_plain(mesh, matrix, mask, q, k, metric)
                single = D.knn_search(q, x, mask_full, metric, k)
                gn = [t.cpu().numpy() for t in got + want + single]
                err = float(np.abs(gn[0] - gn[2]).max())
                ok = (bool(torch.allclose(got[0], want[0], **TOL)) and got[1].dtype == torch.int32
                      and ids_match_up_to_ties(gn[0], gn[1], gn[2], gn[3])
                      and ids_match_up_to_ties(gn[0], gn[1], gn[4], gn[5]))
                emit("mesh_kernels", kernel="K11", metric=metric, q=nq, n=n, shards=MESH_SHARDS,
                     max_abs_err=err,
                     max_abs_err_single_device=float(np.abs(gn[0] - gn[4]).max()), ok=ok)
                require(ok, f"K11 {metric} Q={nq} disagrees with its plain version or with K2")
                errs["K11"] = max(errs["K11"], err)
            if metric != "euclidean":
                continue
            before = read_launches()
            got = M.sharded_knn_2d(mesh2, x2, mask2, q, k)
            torch.cuda.synchronize()
            launches = {c: v - before[c] for c, v in read_launches().items() if v - before[c]}
            want = M.sharded_knn_2d_plain(mesh2, x2, mask2, q, k)
            gn = [t.cpu().numpy() for t in got + want]
            err = float(np.abs(gn[0] - gn[2]).max())
            ok = (bool(torch.allclose(got[0], want[0], **TOL))
                  and ids_match_up_to_ties(gn[0], gn[1], gn[2], gn[3]))
            emit("mesh_kernels", kernel="K12", metric=metric, q=nq, n=n, grid=[4, 2],
                 max_abs_err=err, launches=launches, ok=ok)
            require(ok, f"K12 Q={nq} disagrees with its plain version")
            # one card: a step a feature shard over all row shards, the last
            # one selecting; no selection or merge launch besides
            require(launches == {"mesh_knn_2d": 2}, f"K12 Q={nq} launched {launches}")
            errs["K12"] = max(errs["K12"], err)
    xf = x.float()  # the yardstick's input: cdist takes one dtype
    timing = {"K11": {}, "K12": {}}
    for nq in (1, 4, 64):
        q = torch.randn(nq, dim, generator=g).to(dev)
        bound, by = knn_bound(nq, n, dim, k)
        lib_fn = lambda: torch.topk(torch.cdist(q, xf), k, largest=False)  # noqa: E731
        lib = median_ms(lib_fn)
        if nq != 4:
            timing["K11"][nq] = dict(
                ms=median_ms(lambda: M.sharded_knn(mesh, matrix, mask, q, k)),
                queued_ms=queued_device_ms(torch, lambda: M.sharded_knn(mesh, matrix, mask, q, k)),
                plain_ms=median_ms(lambda: M.sharded_knn_plain(mesh, matrix, mask, q, k),
                                   iters=3),
                library_ms=lib, bound_ms=bound, bound_by=by,
                single_device_k2_ms=median_ms(
                    lambda: D.knn_search(q, x, mask_full, "euclidean", k)),
            )
        k12 = lambda: M.sharded_knn_2d(mesh2, x2, mask2, q, k)  # noqa: E731
        timing["K12"][nq] = dict(
            ms=median_ms(k12), queued_ms=queued_device_ms(torch, k12),
            plain_ms=median_ms(lambda: M.sharded_knn_2d_plain(mesh2, x2, mask2, q, k), iters=3),
            library_ms=lib, library_queued_ms=queued_device_ms(torch, lib_fn, iters=5),
            bound_ms=bound, bound_by=by, kernels_per_call=kernels_per_call(torch, k12, 10),
        )
        emit("timing_mesh", q=nq, n=n, d=dim, k=k, corpus="bfloat16",
             K11=timing["K11"].get(nq), K12=timing["K12"][nq])
    require(timing["K12"][64]["queued_ms"] < timing["K12"][64]["library_queued_ms"],
            f"K12 at Q=64 ({timing['K12'][64]['queued_ms']} ms queued) is not faster than "
            f"cdist + topk ({timing['K12'][64]['library_queued_ms']} ms)")
    d_all = torch.rand(1, MESH_SHARDS * k, device=dev)
    i_all = torch.zeros(1, MESH_SHARDS * k, dtype=torch.int32, device=dev)
    merge_ms = queued_device_ms(torch, lambda: M.topk_merge(d_all, i_all, k, n // 8, k))
    del xf
    torch.cuda.empty_cache()
    return dict(max_abs_err=errs, timing=timing, merge_queued_ms=merge_ms,
                seconds=time.perf_counter() - t0)


# the device kernels behind one count of each wrapper on K13's path on one
# card: the probe is the fused K2 over f32 centroids (its pass, then the
# merge of the blocks' picks), the rerank and the merge one kernel each
K13_KERNELS_A_LAUNCH = {"knn_select": 2, "mesh_ivf_rerank": 1, "mesh_topk_merge": 1}
# K13's timing keys that are not the kernels line's own
K13_EXTRA = ("candidate_rows", "probed_lists", "rows_read", "launches", "kernels",
             "kernels_per_call")


def phase_mesh_kernels_ivf(torch, ivf, mesh, matrix, queries, nprobe: int, dim: int,
                           k: int = 10):
    """K13 against its plain version and single-device K3 on the card, on
    the HNSW cell's trained state and sharded mirror, euclidean and cosine,
    with and without a slot mask keeping two thirds of the slots; then its
    median times at Q 1, 8 and 64 beside the bound from this run's probed
    lists, the plain composition, and the kernels a call runs: by the
    wrappers' counts, at most 5 on one card (required), and by
    torch.profiler, each kernel's device time (for information; the
    profiler keeps only part of a short call's kernels)."""
    from surrealdb_tpu_torch.idx import ivf as IVF
    from surrealdb_tpu_torch.ops import distances as D
    from surrealdb_tpu_torch.parallel import mesh as M

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    n = matrix.shape[0]
    cents_r, lrows, lmask, _ = ivf._device_sharded(mesh, n)
    cents, rows1, mask1, probe_ok = ivf._device(dev)
    all_ok = torch.ones(n, dtype=torch.bool, device=dev)
    some_ok = torch.from_numpy(np.arange(n) % 3 != 0).to(dev)
    err = 0.0
    for metric in ("euclidean", "cosine"):
        probe_metric = metric
        for nq, sok in ((1, all_ok), (64, all_ok), (8, some_ok)):
            q = torch.from_numpy(np.ascontiguousarray(queries[:nq], dtype=np.float32)).to(dev)
            args = (mesh, cents_r, lrows, lmask, matrix, q, k, nprobe)
            kw = dict(metric=metric, probe_metric=probe_metric,
                      slot_ok=M.shard_tensor(mesh, sok, ("data",), copy=False))
            before = read_launches()
            got = M.sharded_ivf_search(*args, **kw)
            torch.cuda.synchronize()
            launches = {c: v - before[c] for c, v in read_launches().items() if v - before[c]}
            want = M.sharded_ivf_search_plain(*args, **kw)
            single = IVF._ivf_search(q, cents, rows1, mask1, matrix.base, sok, metric,
                                     probe_metric, k, nprobe, probe_ok=probe_ok)
            gn = [t.cpu().numpy() for t in got + want + single]
            fin = np.isfinite(gn[2])
            e = float(np.abs(gn[0] - gn[2])[fin].max()) if fin.any() else 0.0
            ok = (bool(torch.allclose(got[0], want[0], **TOL))
                  and np.array_equal(~np.isfinite(gn[0]), ~fin)
                  and ids_match_up_to_ties(gn[0], gn[1], gn[2], gn[3], finite_kth=True)
                  and ids_match_up_to_ties(gn[0], gn[1], gn[4], gn[5], finite_kth=True))
            emit("mesh_kernels", kernel="K13", metric=metric, q=nq, nprobe=nprobe,
                 L=int(lrows.shape[2]), slots_ok=int(sok.sum()), max_abs_err=e,
                 max_abs_err_single_device=float(np.abs(gn[0] - gn[4])[fin].max())
                 if fin.any() else 0.0, launches=launches, ok=ok)
            require(ok, f"K13 {metric} Q={nq} disagrees with its plain version or with K3")
            require(launches == {"knn_select": 1, "mesh_ivf_rerank": 1, "mesh_topk_merge": 1},
                    f"K13 {metric} Q={nq} launched {launches}")
            err = max(err, e)
    lens = lmask.base.sum(dim=2).cpu().numpy()  # [shards, lists] members
    lmax = int(lrows.shape[2])
    all_ok_sharded = M.shard_tensor(mesh, all_ok, ("data",), copy=False)
    timing = {}
    for nq in (1, 8, 64):
        q = torch.from_numpy(np.ascontiguousarray(queries[:nq], dtype=np.float32)).to(dev)
        _, probes = D.knn_search(q, cents, probe_ok, "euclidean", nprobe)
        probes = probes.cpu().numpy()
        cand = int(lens[:, probes].sum())  # (query, member) pairs of this run: the products
        probed = np.unique(probes)  # the lists any query probes, in every shard
        rows_read = int(lens[:, probed].sum())
        # what a correct rerank must read: the queries and centroids, each
        # probed (shard, list)'s mask bytes (which positions are listed),
        # and for each member of those lists its slot (4 bytes), its
        # slot_ok byte and its row, once however many queries probe the
        # list; the picks written. The operations: a product a (query,
        # member) pair, and the probe's.
        nbytes = (nq * dim * 4 + ivf.nlists * dim * 4 + MESH_SHARDS * probed.size * lmax
                  + rows_read * (5 + dim * 2) + nq * k * 8)
        bound, by = bound_ms(nbytes, 2.0 * nq * ivf.nlists * dim + 2.0 * cand * dim, "bfloat16")
        args = (mesh, cents_r, lrows, lmask, matrix, q, k, nprobe)
        kw = dict(slot_ok=all_ok_sharded)  # placed once, as search_batch_sharded does
        call = lambda: M.sharded_ivf_search(*args, **kw)  # noqa: E731
        before = read_launches()
        call()
        torch.cuda.synchronize()
        launched = {c: v - before[c] for c, v in read_launches().items() if v - before[c]}
        kernels = sum(K13_KERNELS_A_LAUNCH.get(c, 99) * v for c, v in launched.items())
        timing[nq] = dict(
            ms=median_ms(call), queued_ms=queued_device_ms(torch, call),
            plain_ms=median_ms(lambda: M.sharded_ivf_search_plain(*args, **kw), iters=3),
            library_ms=None, bound_ms=bound, bound_by=by, candidate_rows=cand,
            probed_lists=int(probed.size), rows_read=rows_read, launches=launched,
            kernels=kernels, kernels_per_call=kernels_per_call(torch, call, 10),
        )
        emit("timing_mesh_k13", q=nq, nprobe=nprobe, L=lmax, k=k, **timing[nq])
        # the kernels a call, from the wrappers' counts (one card)
        require(set(launched) == set(K13_KERNELS_A_LAUNCH) and kernels <= 5,
                f"K13 at Q={nq} launched {launched}: {kernels} kernels a call")
    return dict(max_abs_err=err, timing=timing, seconds=time.perf_counter() - t0)


def person_csr(pairs, nodes: int):
    """Config 1's person -> person adjacency (knows pairs, parallel edges
    kept) as int32 CSR: indptr [nodes + 1], indices [E]."""
    order = np.argsort(pairs[:, 0], kind="stable")
    indptr = np.zeros(nodes + 1, dtype=np.int64)
    np.add.at(indptr, pairs[:, 0] + 1, 1)
    return np.cumsum(indptr).astype(np.int32), pairs[order, 1].astype(np.int32)


def spread_csr(indptr, indices, cap: int, seed: int = 3):
    """The graph of (indptr, indices) with its nodes moved to distinct
    seeded ids in [0, cap): (indptr [cap + 1], indices, the id map)."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(cap, indptr.size - 1, replace=False).astype(np.int64)
    deg = np.zeros(cap, dtype=np.int64)
    deg[ids] = np.diff(indptr)
    order = np.argsort(ids, kind="stable")  # the rows in their new id order
    rows = np.concatenate([indices[indptr[v]:indptr[v + 1]] for v in order])
    new_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    return new_ptr, ids[rows].astype(np.int32), ids.astype(np.int32)


def hop_read_bytes(indptr, indices, frontier, max_degree: int) -> int:
    """The bytes K14 must read at this hop: the frontier and its mask whole,
    and of indptr and indices the 32-byte sectors its rows touch, each once
    (the two pointers of each row under the reference's gather rule, and
    indices[clip(start + o)] for o < max_degree, every row: invalid entries
    carry their neighbour too)."""
    v1, e = indptr.size, indices.size

    def wrap32(x):
        return (x + (1 << 31)) % (1 << 32) - (1 << 31)

    def gather(i):
        i = np.where(i < 0, i + v1, i)
        return np.clip(i, 0, v1 - 1)

    def sector_bytes(entries, nbytes):
        sectors = np.unique(entries * 4 // 32)
        return int(np.minimum(32, nbytes - 32 * sectors).sum())

    fr = frontier.astype(np.int64)
    a, b = gather(fr), gather(wrap32(fr + 1))
    take = wrap32(indptr[a].astype(np.int64)[:, None] + np.arange(max_degree))
    return (sector_bytes(np.concatenate([a, b]), indptr.nbytes)
            + sector_bytes(np.clip(take, 0, e - 1).ravel(), indices.nbytes) + frontier.size * 5)


def mesh_graph_bfs(torch, M, mesh, indptr, indices, nodes: int, seed: int, hops: int, shape: str):
    """A `hops`-hop BFS from `seed` through K14 and K15 on the card, each
    frontier padded to a multiple of MESH_SHARDS with the masked id
    `nodes`, max_degree its largest out-degree: every hop's outputs equal
    the plain versions', its reached set numpy's; K14 one launch a hop (one
    card), K15 leaves its scratch zero. The last hop's (frontier, mask,
    max_degree, neighbours, valid)."""
    from surrealdb_tpu_torch.ops import _cuda

    dev = torch.device("cuda", 0)
    ptr, idx = M.replicate(mesh, indptr), M.replicate(mesh, indices)
    deg = np.diff(indptr)
    live = np.array([seed], dtype=np.int32)
    for h in range(hops):
        f = -(-live.size // MESH_SHARDS) * MESH_SHARDS
        fr = np.full(f, nodes, dtype=np.int32)
        fr[: live.size] = live
        fm = np.zeros(f, dtype=bool)
        fm[: live.size] = True
        md = int(deg[live].max())
        frt = torch.from_numpy(fr).to(dev)
        fmt = torch.from_numpy(fm).to(dev)
        M.HOP.reset()
        nb, valid = M.sharded_frontier_hop(mesh, ptr, idx, frt, fmt, md)
        torch.cuda.synchronize()
        hop_launches = M.HOP.launches
        want = M.sharded_frontier_hop_plain(mesh, ptr, idx, frt, fmt, md)
        hop_ok = bool(torch.equal(nb, want[0]) and torch.equal(valid, want[1]))
        uniq, umask = M.dedup_frontier(nb, valid, nodes)
        torch.cuda.synchronize()
        wu, wm = M.dedup_frontier_plain(nb, valid, nodes)
        dedup_ok = bool(torch.equal(uniq, wu) and torch.equal(umask, wm))
        sc = M.dedup_scratch(_cuda.lib(), dev, nodes)
        zero = not (bool(sc.bits.any()) or bool(sc.state.any()) or sc.dirty)
        reached = np.unique(np.concatenate([indices[indptr[v]:indptr[v + 1]] for v in live]))
        nxt = uniq[umask].cpu().numpy()
        numpy_ok = bool(np.array_equal(nxt, reached))
        emit("mesh_kernels", kernel="K14+K15", shape=shape, hop=h + 1, frontier=f,
             live=int(live.size), max_degree=md, gathered=int(nb.numel()), reached=int(nxt.size),
             hop_exact=hop_ok, dedup_exact=dedup_ok, numpy_equal=numpy_ok,
             hop_launches=hop_launches, dedup_scratch_zero=zero)
        require(hop_ok and dedup_ok and numpy_ok, f"K14/K15 {shape} hop {h + 1} disagrees")
        require(hop_launches == 1, f"K14 {shape} hop {h + 1}: {hop_launches} launches on one card")
        require(zero, f"K15 {shape} hop {h + 1} left its scratch dirty")
        live = nxt.astype(np.int32)
    return frt, fmt, md, nb, valid


def phase_mesh_kernels_graph(torch, seed: int = 7, hops: int = 3, cap: int = 1 << 20):
    """K14 and K15 against their plain versions on the card, exactly, over
    8 frontier shards on cuda:0 (mesh_graph_bfs): on config 1's person graph
    and on the same graph with its nodes spread over `cap` ids (config 1's
    CSC capacity: K15's bitmap 128 KB, past its shared-memory marking).
    Times at each last hop's shapes beside the bounds and (K15)
    torch.unique; K15's kernels and memsets a call from torch.profiler, and
    its scratch zero after the timing's back-to-back calls."""
    from surrealdb_tpu_torch.ops import _cuda
    from surrealdb_tpu_torch.parallel import mesh as M

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    nodes = GRAPH_NODES
    pairs = graph_pairs(nodes, GRAPH_EDGES)
    indptr, indices = person_csr(pairs, nodes)
    mesh = one_device_mesh(torch, "cuda")
    sptr, sidx, ids = spread_csr(indptr, indices, cap)
    timing = {}
    for shape, (ptr_np, idx_np, n, s0) in (
            ("config1", (indptr, indices, nodes, seed)),
            (f"spread_{cap}", (sptr, sidx, cap, int(ids[seed])))):
        frt, fmt, md, nb, valid = mesh_graph_bfs(torch, M, mesh, ptr_np, idx_np, n, s0, hops,
                                                 shape)
        ptr, idx = M.replicate(mesh, ptr_np), M.replicate(mesh, idx_np)
        f = frt.numel()
        hop = lambda: M.sharded_frontier_hop(mesh, ptr, idx, frt, fmt, md)  # noqa: E731
        dedup = lambda: M.dedup_frontier(nb, valid, n)  # noqa: E731
        read = hop_read_bytes(ptr_np, idx_np, frt.cpu().numpy(), md)
        hop_bound, hop_by = bound_ms(read + f * md * 5, 0.0, "float32")
        dd_bound, dd_by = bound_ms(f * md * 5 + f * md * 5, 0.0, "float32")
        M.DEDUP.reset()
        for _ in range(5):
            dedup()
        calls = M.DEDUP.launches
        per_call = kernels_per_call(torch, dedup)
        sc = M.dedup_scratch(_cuda.lib(), dev, n)
        torch.cuda.synchronize()
        zero = not (bool(sc.bits.any()) or bool(sc.state.any()) or sc.dirty)
        require(zero, f"K15 {shape}: scratch dirty after back-to-back calls")
        # the wrapper's count: one mesh_dedup_frontier (2 launches) a call
        require(calls == 5, f"K15 {shape}: {calls} wrapper launches over 5 calls")
        if per_call != "not measured":
            require(per_call["kernels"] <= 2 and per_call["memsets"] == 0,
                    f"K15 {shape}: {per_call} a call (at most 2 kernels, no memset)")
        else:
            emit("mesh_kernels", kernel="K15", shape=shape, wrapper_launches_a_call=calls / 5,
                 kernels_and_memsets="not measured (the profiler reported no kernel): only "
                                     "the wrapper's one launch a call was checked")
        timing[shape] = {
            "K14": dict(
                ms=median_ms(hop), queued_ms=queued_device_ms(torch, hop),
                plain_ms=median_ms(lambda: M.sharded_frontier_hop_plain(mesh, ptr, idx, frt, fmt,
                                                                        md)),
                library_ms=None, bound_ms=hop_bound, bound_by=hop_by,
                kernels_per_call=kernels_per_call(torch, hop),
                shape={"frontier": f, "max_degree": md, "nodes": n, "edges": GRAPH_EDGES}),
            "K15": dict(
                ms=median_ms(dedup), queued_ms=queued_device_ms(torch, dedup),
                plain_ms=median_ms(lambda: M.dedup_frontier_plain(nb, valid, n)),
                library_ms=median_ms(lambda: torch.unique(nb[valid])),
                bound_ms=dd_bound, bound_by=dd_by, kernels_per_call=per_call,
                scratch_zero_after_timing=zero,
                shape={"entries": int(nb.numel()), "nodes": n}),
        }
        emit("timing_mesh_graph", shape=shape, **timing[shape])
    return dict(timing=timing, seconds=time.perf_counter() - t0)


def phase_dryrun_mesh(torch, device: str):
    """parallel/dryrun.py on the device: entry() once, then
    dryrun_multichip(MESH_SHARDS) with the launch counts read around it
    (the entry point that runs K12, K14 and K15, and K11 and K13 too)."""
    from surrealdb_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    fn, args = dryrun.entry(device)
    d, i = fn(*args)
    reset_launches()
    out = dryrun.dryrun_multichip(MESH_SHARDS, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {n: v for n, v in read_launches().items() if v}
    res = dict(entry_shape=list(d.shape), launches=launches,
               dists_finite=bool(torch.isfinite(out["dists"]).all()),
               reached=int(out["umask"].sum()), seconds=time.perf_counter() - t0)
    if device == "cuda":
        require(all(launches.get(n, 0) > 0 for n in ("mesh_knn_2d", "mesh_frontier_hop",
                                                      "mesh_dedup_frontier", "mesh_topk_merge",
                                                      "mesh_ivf_rerank")),
                f"the dry run skipped a mesh kernel: {launches}")
    emit("dryrun_mesh", **res)
    return res


def phase_mesh_multicard(torch, n: int = 1 << 18, dim: int = DIM, k: int = 10):
    """The mesh with shards on distinct cards (run with --multicard on a
    machine with 2+ cards; the default run has one): K11 on every card
    against its plain version and single-device K2, K12 on an (n/2 x 2)
    grid of cards against its plain version, K13 against single-device K3,
    K14/K15 exactly against their plain versions; then Datastore.mesh()
    over every card through Datastore.execute: MTREE `exact-sharded` and
    HNSW `ivf-sharded` beside a single-device Datastore (MTREE ids equal up
    to ties). Correctness only: no time is taken."""
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.idx import ivf as IVF
    from surrealdb_tpu_torch.kvs.ds import Datastore
    from surrealdb_tpu_torch.ops import distances as D
    from surrealdb_tpu_torch.parallel import mesh as M

    n_dev = torch.cuda.device_count()
    require(n_dev >= 2, f"--multicard needs 2+ cards, found {n_dev}")
    mesh = M.make_mesh()
    dev0 = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(n, dim, generator=g).to(torch.bfloat16)
    mask = torch.rand(n, generator=g) > 0.05
    xs = M.shard_tensor(mesh, x, ("data", None))
    ms = M.shard_tensor(mesh, mask, ("data",))
    require(xs.base is None and len({xs.shard((s,)).device for s in range(n_dev)}) == n_dev,
            "the shards are not on distinct cards")
    xg, mg = x.to(dev0), mask.to(dev0)
    checks = {}
    for metric in ("euclidean", "cosine"):
        for nq in (1, 64):
            q = torch.randn(nq, dim, generator=g).to(dev0)
            got, want = M.sharded_knn(mesh, xs, ms, q, k, metric), \
                M.sharded_knn_plain(mesh, xs, ms, q, k, metric)
            gn = [t.cpu().numpy() for t in got + want + D.knn_search(q, xg, mg, metric, k)]
            checks[f"K11 {metric} q{nq}"] = (
                bool(np.allclose(gn[0], gn[2], **TOL))
                and ids_match_up_to_ties(gn[0], gn[1], gn[2], gn[3])
                and ids_match_up_to_ties(gn[0], gn[1], gn[4], gn[5]))
    if n_dev % 2 == 0:
        mesh2 = M.Mesh([torch.device("cuda", i) for i in range(n_dev)], ("data", "model"),
                       (n_dev // 2, 2))
        x2 = M.shard_tensor(mesh2, x, ("data", "model"))
        m2 = M.shard_tensor(mesh2, mask, ("data",))
        for nq in (1, 64):
            q = torch.randn(nq, dim, generator=g)
            before = read_launches()
            got = M.sharded_knn_2d(mesh2, x2, m2, q, k)
            launched = read_launches()["mesh_knn_2d"] - before["mesh_knn_2d"]
            gn = [t.cpu().numpy() for t in got + M.sharded_knn_2d_plain(mesh2, x2, m2, q, k)]
            checks[f"K12 q{nq}"] = (bool(np.allclose(gn[0], gn[2], **TOL))
                                    and ids_match_up_to_ties(gn[0], gn[1], gn[2], gn[3])
                                    and launched == n_dev)  # a step a card
    corpus = gen_corpus(n, dim)
    ivf = IVF.IvfState.train(corpus, np.ones(n, dtype=bool), device=dev0)
    nprobe = IVF.default_nprobe(ivf.nlists, 64)
    sharded = M.shard_corpus(mesh, corpus, dtype=torch.bfloat16)
    single = torch.from_numpy(corpus).to(dev0).to(torch.bfloat16)
    cents, rows1, mask1, probe_ok = ivf._device(dev0)
    qs = make_queries(corpus, 64, 7, noise=CLUSTER_SIGMA)
    for nq in (1, 64):
        before = read_launches()
        d, r = ivf.search_batch_sharded(qs[:nq], mesh, sharded, "euclidean", k, nprobe)
        launched = {c: v - before[c] for c, v in read_launches().items()}
        # a rerank a card (one shard each), none through K3's own wrapper
        checks[f"K13 launches q{nq}"] = (launched["mesh_ivf_rerank"] == n_dev
                                         and launched["ivf_rerank"] == 0)
        q = torch.from_numpy(np.ascontiguousarray(qs[:nq])).to(dev0)
        sd, sr = IVF._ivf_search(q, cents, rows1, mask1, single,
                                 torch.ones(n, dtype=torch.bool, device=dev0), "euclidean",
                                 "euclidean", k, nprobe, probe_ok=probe_ok)
        checks[f"K13 q{nq}"] = ids_match_up_to_ties(d, r, sd.cpu().numpy(), sr.cpu().numpy(),
                                                    finite_kth=True)
    indptr, indices = person_csr(graph_pairs(GRAPH_NODES, 200_000), GRAPH_NODES)
    fr = np.arange(4 * n_dev * 50, dtype=np.int32)
    fr[::7] = GRAPH_NODES + 3
    fm = np.ones(fr.size, dtype=bool)
    fm[::5] = False
    md = int(np.diff(indptr).max())
    got = M.sharded_frontier_hop(mesh, indptr, indices, fr, fm, md)
    want = M.sharded_frontier_hop_plain(mesh, indptr, indices, fr, fm, md)
    uniq = M.dedup_frontier(got[0], got[1], GRAPH_NODES)
    wu = M.dedup_frontier_plain(got[0], got[1], GRAPH_NODES)
    checks["K14+K15"] = all(bool(torch.equal(a.cpu(), b.cpu()))
                            for a, b in zip(got + uniq, want + wu))
    # the engine: Datastore.mesh() over every card beside a single-device one
    engine = {}
    prev = cnf.TPU_ANN_MIN_ROWS, Datastore._mesh_cache
    cnf.TPU_ANN_MIN_ROWS = 8192
    try:
        for index in ("MTREE", "HNSW"):
            answers = []
            for cache in (("unset", None), ("none", None)):
                Datastore._mesh_cache = cache
                ds = Datastore("memory")
                try:
                    require((ds.mesh() is not None) == (cache[0] == "unset"), "mesh() rule")
                    run = sql_runner(ds)
                    efc = " EFC 64" if index == "HNSW" else ""
                    run("DEFINE TABLE item SCHEMALESS; DEFINE INDEX iemb ON item FIELDS emb "
                        f"{index} DIMENSION {dim} DIST EUCLIDEAN{efc}")
                    ingest(run, corpus[: n // 4], 20_000)
                    run(HNSW_SQL, {"q": qs[0].tolist()})
                    if index == "HNSW":
                        require(ds.index_stores.get("test", "test", "item", "iemb")
                                .wait_ivf(300), "IVF training did not finish")
                        run(HNSW_SQL, {"q": qs[0].tolist()})
                    before = strategies()
                    answers.append([run(HNSW_SQL, {"q": qs[i].tolist()}) for i in range(16)])
                    engine[f"{index} {cache[0]}"] = strategy_delta(before)
                finally:
                    ds.close()
            engine[f"{index} equal id sets"] = sum(
                set(result_ids(a)) == set(result_ids(b)) for a, b in zip(*answers))
    finally:
        cnf.TPU_ANN_MIN_ROWS, Datastore._mesh_cache = prev
    emit("mesh_multicard", cards=n_dev, rows=n, checks=checks, engine=engine)
    require(all(checks.values()), f"multi-card checks failed: {checks}")
    require(engine['MTREE unset'] == {'knn_strategy{strategy="exact-sharded"}': 16.0}
            and engine['HNSW unset'] == {'knn_strategy{strategy="ivf-sharded"}': 16.0}
            and engine["MTREE equal id sets"] >= 15,
            f"multi-card engine run: {engine}")
    return checks, engine


MTREE_SQL = "SELECT id FROM item WHERE emb <|10|> $q"  # phase_main_path's
HNSW_SQL = "SELECT id FROM item WHERE emb <|10,64|> $q"  # phase_main_path_hnsw's


class MeshPaths:
    """The `then` hooks that run the mesh path on the two kNN cells' open
    Datastores: `mtree` after the MTREE window (exact-sharded, then the K11
    and K12 checks on its sharded mirror), `hnsw` after the ML phase on the
    HNSW Datastore (ivf-sharded, then the K13 checks). On the CPU only the
    main paths run (the plain versions)."""

    def __init__(self, torch, device, queries, truth, corpus, n_seq, n_threads, rounds):
        self.torch, self.device = torch, device
        self.queries, self.truth, self.corpus = queries, truth, corpus
        self.drive = dict(n_seq=n_seq, n_threads=n_threads, rounds=rounds)

    def mtree(self, ds, results, base):
        t0 = time.perf_counter()
        out, _mesh, matrix = phase_main_path_mesh(
            self.torch, self.device, ds, "mtree", "iemb", MTREE_SQL, "exact-sharded",
            {"knn_select": MESH_SHARDS, "mesh_topk_merge": 1},
            self.queries, results, base_timing_of(base), self.truth, **self.drive)
        require(out["recall_at_10"] >= 0.99, f"exact-sharded recall@10 {out['recall_at_10']}")
        out["seconds"] = time.perf_counter() - t0
        if self.device == "cuda":
            out["kernels"] = phase_mesh_kernels_exact(self.torch, matrix, DIM)
        return out

    def hnsw(self, ds, results, base):
        from surrealdb_tpu_torch.idx.ivf import default_nprobe

        ml = phase_main_path_ml(self.torch, self.device, ds, self.corpus)
        onnx = phase_main_path_onnx(self.torch, self.device, ds, self.corpus)
        t0 = time.perf_counter()
        out, mesh, matrix = phase_main_path_mesh(
            self.torch, self.device, ds, "hnsw", "iemb", HNSW_SQL, "ivf-sharded",
            {"knn_select": 1, "mesh_ivf_rerank": 1, "mesh_topk_merge": 1},
            self.queries, results, base_timing_of(base), self.truth, **self.drive)
        out["seconds"] = time.perf_counter() - t0
        if self.device == "cuda":
            ivf = ds.index_stores.get("test", "test", "item", "iemb").ivf
            fresh = make_queries(self.corpus, 64, 7, noise=CLUSTER_SIGMA)
            out["kernels"] = phase_mesh_kernels_ivf(
                self.torch, ivf, mesh, matrix, fresh, default_nprobe(ivf.nlists, 64), DIM)
        return ml, onnx, out


# ------------------------------------------------------------------ main
# ------------------------------------------------------------------ phase 12
FILE_ROWS = 1 << 18  # phase 12's rows: config 2's 2^20, cut for the time limit
FILE_BATCH = 20_000  # phase 3's INSERT batch
# the start of a frame whose body never landed: a length past the file's end
TORN_FRAME = (10_000).to_bytes(4, "big") + (12345).to_bytes(4, "big") + b"short"


def file_schema(dim: int) -> str:
    return ("DEFINE TABLE item SCHEMALESS; "
            f"DEFINE INDEX iemb ON item FIELDS emb MTREE DIMENSION {dim} DIST EUCLIDEAN")


def file_child(path: str, rows: int, dim: int, device: str, batch: int) -> int:
    """`--file-child`: open a file-backed Datastore at `path`, INSERT the
    corpus's first `rows` rows in batches, print `{"ack": rows so far,
    "ingest_s": ...}` after each committed batch, then `{"blocked": true}`,
    and wait to be killed (no close(), so no compaction at exit)."""
    from surrealdb_tpu_torch.kvs.ds import Datastore

    corpus = gen_corpus(rows, dim)
    ds = Datastore("file://" + path, device=device)
    run = sql_runner(ds)
    run(file_schema(dim))
    ingest_s = 0.0
    for lo in range(0, rows, batch):
        hi = min(lo + batch, rows)
        ingest_s += ingest(run, corpus, batch, lo, hi)
        print(json.dumps({"ack": hi, "ingest_s": ingest_s}), flush=True)
    print(json.dumps({"blocked": True}), flush=True)
    while True:
        time.sleep(3600)


def file_sizes(path: str) -> dict:
    return {"snapshot_bytes": os.path.getsize(path) if os.path.exists(path) else 0,
            "wal_bytes": os.path.getsize(path + ".wal")}


def phase_main_path_file(torch, device: str, rows: int, dim: int, queries, truth, smi,
                         batch: int, n_seq: int, n_threads: int, rounds: int,
                         child_timeout: float = 900.0):
    """The MTREE main path on the file backend after a crash: a child
    process ingests gen_corpus(rows, dim) (the first rows of phase 3's
    corpus when rows is a multiple of its 65,536-row step, or the whole
    corpus) into `file://<tmp>/db` and is killed (SIGKILL) once it
    has acknowledged every batch; a torn frame is appended to the WAL; the
    store reopens on `device` (snapshot load + WAL replay) and must hold
    every acknowledged row, list the index, run tick(), and serve phase 3's
    queries `exact-device` (K2's launches equal to the dispatched tiles,
    recall@10 >= 0.99 over the cut corpus). Then a compaction and a clean
    close, and a reopen from the snapshot alone answers one query as
    before."""
    import shutil
    import signal
    import tempfile

    from surrealdb_tpu_torch import bg
    from surrealdb_tpu_torch.kvs.ds import Datastore
    from surrealdb_tpu_torch.kvs.file import WAL_MAGIC

    k = 10
    sql = f"SELECT id FROM item WHERE emb <|{k}|> $q"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_file_")
    path = os.path.join(tmp, "db")
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    err_path = os.path.join(tmp, "child.err")
    ds = None
    with open(err_path, "w") as err:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--file-child", path,
             "--file-rows", str(rows), "--file-dim", str(dim), "--file-device", device,
             "--file-batch", str(batch)],
            stdout=subprocess.PIPE, stderr=err, text=True,
        )
    watchdog = threading.Timer(child_timeout, child.kill)
    watchdog.start()
    try:
        acks = []
        for line in child.stdout:
            if not line.startswith("{"):
                continue  # not one of file_child's lines
            msg = json.loads(line)
            if msg.get("blocked"):
                break
            acks.append(msg)
        watchdog.cancel()
        with open(err_path) as f:
            require(bool(acks) and child.poll() is None,
                    f"file child ended before blocking: {f.read()[-2000:]}")
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
        acked, child_ingest_s = acks[-1]["ack"], acks[-1]["ingest_s"]
        require(acked == rows, f"child acknowledged {acked} of {rows} rows")
        killed = file_sizes(path)
        with open(path + ".wal", "ab") as f:
            f.write(TORN_FRAME)

        t = time.perf_counter()
        ds = Datastore("file://" + path, device=device)
        reopen_s = time.perf_counter() - t
        require(os.path.getsize(path + ".wal") == killed["wal_bytes"],
                "the torn WAL tail was not truncated to the intact prefix")
        run = sql_runner(ds)
        t = time.perf_counter()
        count = run("SELECT count() FROM item GROUP ALL")[0]["count"]
        count_s = time.perf_counter() - t
        require(count == acked, f"count() {count} after recovery, {acked} acknowledged")
        info = run("INFO FOR TABLE item")
        require("iemb" in info["indexes"] and "MTREE" in info["indexes"]["iemb"],
                f"INFO FOR TABLE item lists no MTREE index: {info}")
        t = time.perf_counter()
        collected = ds.tick()
        tick_s = time.perf_counter() - t
        # the first query builds the mirror from the KV store and uploads it
        t = time.perf_counter()
        first = run(sql, {"q": queries[0].tolist()})
        first_query_s = time.perf_counter() - t
        served, results = serve_exact(torch, device, ds, run, sql, queries, truth, k,
                                      n_seq, n_threads, rounds)

        ds.backend.flush()  # compaction: the whole state into the snapshot
        ds.close()
        ds = None
        compacted = file_sizes(path)
        require(compacted["wal_bytes"] == len(WAL_MAGIC), f"WAL after compaction {compacted}")
        t = time.perf_counter()
        ds = Datastore("file://" + path, device=device)
        reopen2_s = time.perf_counter() - t
        run = sql_runner(ds)
        t = time.perf_counter()
        again = run(sql, {"q": queries[0].tolist()})
        first_query2_s = time.perf_counter() - t
        require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
        before, widths0 = strategies(), ds.dispatch.width_distribution()
        reset_launches()
        again2 = run(sql, {"q": queries[0].tolist()})
        if device == "cuda":
            torch.cuda.synchronize()
        launches2 = read_launches()
        _widths, tiles2 = dispatched_tiles(ds, widths0)
        ids = [[int(r["id"].id) for r in res] for res in (first, results[0], again, again2)]
        require(all(i == ids[1] for i in ids), f"query 0 after recovery and reopen: {ids}")
        require(strategy_delta(before) == {'knn_strategy{strategy="exact-device"}': 1.0},
                f"strategies after the snapshot reopen {strategy_delta(before)}")
        if device == "cuda":
            want = {c.name: 0 for c in kernel_counters()}
            want.update(knn_select=tiles2)
            require(launches2 == want, f"launches {launches2} for {tiles2} tiles after reopen")
        out = dict(
            rows=rows, dim=dim, device=str(ds.device), nvidia_smi=smi,
            reduced=None if rows == 1 << 20 else {
                "rows": rows, "published_rows": 1 << 20,
                "why": "the script's time limit: at 2^20 rows this phase alone takes ~5.4 "
                       "min on an H100 (6.6 GB on disk, ingest ~7,400 rows/s)"},
            acked_rows=acked, recovered_rows=count,
            ingest_rows_per_s=acked / child_ingest_s, ingest_s=child_ingest_s,
            at_kill=killed, torn_frame_bytes=len(TORN_FRAME),
            reopen_s=reopen_s, first_query_s=first_query_s,
            time_to_recover_s=reopen_s + first_query_s,
            count_s=count_s, tick_s=tick_s, tick_collected=collected,
            **{f"after_recovery_{key}": v for key, v in served.items()},
            after_compaction=compacted, snapshot_reopen_s=reopen2_s,
            snapshot_first_query_s=first_query2_s,
            snapshot_reopen_launches=launches2, snapshot_reopen_tiles=tiles2,
            peak_device_memory_bytes_phase=(
                torch.cuda.max_memory_allocated() if device == "cuda" else None),
            seconds=time.perf_counter() - t_phase,
        )
        emit("main_path_file", **out)
        out["results"] = results  # the answers after recovery (main_path_cluster's twin)
        return out
    finally:
        watchdog.cancel()
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
        child.stdout.close()
        if ds is not None:
            ds.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------------ cluster
# main_path_cluster's rows in the whole run: config 2's 2^20, cut for the time
# limit as phase 12's were, to the same rows (its answers after recovery are
# then the single node's); the in-process load runs 3,900-5,000 768-d rows/s
# on an H100 host
CLUSTER_ROWS = FILE_ROWS
CLUSTER_NODES = 3  # README.md "Cluster mode": n1-n3
CLUSTER_RF = 2  # cnf.CLUSTER_RF's default
CLUSTER_VNODES = 64  # the topology's default vnodes
# the coordinator's own write path: fresh 768-d rows, 1,024 a statement (one
# statement of 16,384 rows sends ~2,700 to a replica set in one RPC, past
# the default 10 s cnf.CLUSTER_RPC_TIMEOUT_SECS at the CBOR codec's rate);
# 16,384 with --cluster-only, 128 (one statement) in the whole run
CLUSTER_WRITE_ROWS, CLUSTER_WRITE_BATCH = 16_384, 1024
CLUSTER_PARITY_DOCS = 4096  # the small routes' sizes: documents and rows
CLUSTER_PARITY_NODES, CLUSTER_PARITY_EDGES = 200, 400  # the 2-hop graph
# the CLI pair's rows, written over HTTP: 256 in the whole run, 4,096 with
# --cluster-only; 256 a statement, since a cluster INSERT answers with every
# row it wrote (the routed statement drops RETURN NONE) and the event loop
# closes a connection whose queued response passes cnf.NET_WRITE_BUF_MAX (4 MB)
CLUSTER_CLI_ROWS, CLUSTER_CLI_BATCH = 4096, 256


def cluster_up(stores, timeout: float = 60.0) -> float:
    """Wait until every node's probes see every peer up (a peer probed
    before it listened is marked down and probed again after a backoff);
    -> seconds waited."""
    t0 = time.perf_counter()
    while True:
        views = [ds.cluster.client.health() for ds in stores]
        if all(h["up"] for v, ds in zip(views, stores) for nid, h in v.items()
               if nid != ds.cluster.node_id) and not any(
                   ds.cluster.client.down_nodes() for ds in stores):
            return time.perf_counter() - t0
        require(time.perf_counter() - t0 < timeout,
                f"cluster peers not all up after {timeout} s: {views}")
        time.sleep(0.1)


def cluster_spans(ds, sql, queries, n: int) -> dict:
    """n queries through the coordinator under kept traces: the mean ms of
    the coordinator's `cluster_execute` (the statement end to end), its
    scatter and replay `statement`, and a node's `cluster_rpc`, its remote
    `statement` and `knn_search` (grafted spans, labelled by node)."""
    import uuid

    from surrealdb_tpu_torch import tracing

    acc = {}
    for i in range(n):
        tid = uuid.uuid4().hex
        with tracing.request("chip_smoke", trace_id=tid):
            tracing.force_keep()
            r = ds.execute(sql, vars={"q": queries[i].tolist()})
        require(r[-1]["status"] == "OK", f"traced query {i}: {r[-1]}")
        doc = tracing.get_trace(tid)
        require(doc is not None, f"trace {tid} was not kept")
        by_id = {sp["id"]: sp for sp in doc["spans"]}
        for sp in doc["spans"]:
            node = sp["labels"].get("node")
            parent = by_id.get(sp["parent"], {})
            if sp["name"] in ("cluster_execute", "cluster_scatter"):
                key = sp["name"]
            elif sp["name"] == "cluster_rpc":
                key = f"cluster_rpc[{node}]"
            elif sp["name"] == "statement" and parent.get("name") == "cluster_scatter":
                key = "replay_statement"
            elif sp["name"] in ("statement", "knn_search"):  # n1's own spans carry no node
                key = f"{sp['name']}[{node or ds.cluster.node_id}]"
            else:
                continue
            acc.setdefault(key, []).append(sp["dur_ms"])
    return {key: float(np.mean(v)) for key, v in sorted(acc.items())}


def cluster_knn_window(torch, device, stores, ask, queries, truth, k, n_seq, n_threads, rounds,
                       n_nodes, min_recall=0.99):
    """The cell's queries through `ask` (drive_queries' windows): every
    query must reach every node's shard as `exact-device`, K2's launches
    summed over the nodes equal their dispatched tiles (no other kernel),
    recall@k >= min_recall (None: a subset of the cell's queries, whose
    caller holds its ids to the whole window's). -> (results, timing)."""
    from surrealdb_tpu_torch import bg, telemetry

    for ds in stores:
        require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
    before = strategies()
    div0 = telemetry.snapshot()["counters"].get("cluster_read_divergence", 0.0)
    widths0 = [ds.dispatch.width_distribution() for ds in stores]
    reset_launches()
    results, timing = drive_queries(ask, queries.shape[0], n_seq, n_threads, rounds,
                                    "exact-device")
    # two replicas' copies of a row that differ (their distances too) count here
    divergence = telemetry.snapshot()["counters"].get("cluster_read_divergence", 0.0) - div0
    for ds in stores:
        require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
    if device == "cuda":
        torch.cuda.synchronize()
    launches = read_launches()
    tiles = {ds.cluster.node_id: dispatched_tiles(ds, w0)[1] for ds, w0 in zip(stores, widths0)}
    delta = strategy_delta(before)
    n = queries.shape[0]
    require(delta == {'knn_strategy{strategy="exact-device"}': float(n * n_nodes)},
            f"strategies {delta}, expected {n} x {n_nodes} nodes exact-device")
    if device == "cuda":
        want = {c.name: 0 for c in kernel_counters()}
        want.update(knn_select=sum(tiles.values()))
        require(launches == want, f"launches {launches} for {tiles} dispatched tiles")
    recall = recall_of(results, truth, k)
    require(min_recall is None or recall >= min_recall, f"recall@{k} {recall} < {min_recall}")
    return results, dict(**timing, tiles_by_node=tiles, launches=launches, strategies=delta,
                         recall_at_10=recall, read_divergence=divergence)


def cluster_load(stores, membership, corpus, rows: int, batch: int, k: int) -> dict:
    """The corpus's first `rows` rows into each node's own store in process
    (execute_local), each row on the RF nodes the ring names; a node's
    mirror is built after its first batch so the rest reach it as deltas."""
    from surrealdb_tpu_torch.cluster.placement import placement_key
    from surrealdb_tpu_torch.dbs.session import Session

    s = Session.owner("test", "test")
    t = time.perf_counter()
    owned = {ds.cluster.node_id: [] for ds in stores}
    for j in range(rows):
        for nid in membership.replicas_of_key(placement_key("item", j), CLUSTER_RF):
            owned[nid].append(j)
    place_s = time.perf_counter() - t
    ingest_s = {}
    for ds in stores:
        ids = owned[ds.cluster.node_id]
        t = time.perf_counter()
        for i in range(0, len(ids), batch):
            # lists, as a client's rows arrive (a record's numpy array would
            # not compare in the coordinator's merge)
            res = ds.execute_local("INSERT INTO item $rows RETURN NONE", s, {
                "rows": [{"id": j, "emb": corpus[j].tolist()} for j in ids[i:i + batch]]})
            require(res[-1]["status"] == "OK", f"{ds.cluster.node_id} ingest: {res[-1]}")
            if i == 0:
                res = ds.execute_local(f"SELECT id FROM item WHERE emb <|{k}|> $q", s,
                                       {"q": corpus[ids[0]].tolist()})
                require(res[-1]["status"] == "OK", f"{ds.cluster.node_id} mirror: {res[-1]}")
        ingest_s[ds.cluster.node_id] = time.perf_counter() - t
    counts = {}
    for ds in stores:
        res = ds.execute_local("SELECT count() FROM item GROUP ALL", s)
        counts[ds.cluster.node_id] = res[-1]["result"][0]["count"]
    require(counts == {nid: len(v) for nid, v in owned.items()},
            f"rows a node {counts}, the ring assigns {({n: len(v) for n, v in owned.items()})}")
    require(sum(counts.values()) == CLUSTER_RF * rows,
            f"rows over the nodes {sum(counts.values())} != RF x rows {CLUSTER_RF * rows}")
    return dict(rows_by_node=counts, placement_s=place_s, ingest_s_by_node=ingest_s,
                ingest_rows_per_s=CLUSTER_RF * rows / sum(ingest_s.values()))


def cluster_write_path(stores, membership, dim: int, n: int, batch: int) -> dict:
    """n fresh rows INSERTed through n1's execute, `batch` rows a statement
    (the coordinator's write path: every row to its RF replicas, the
    remote ones as CBOR; a statement's rows go to a replica set in one
    RPC, which must finish inside cnf.CLUSTER_RPC_TIMEOUT_SECS); every
    acknowledged row is then read back from each of its replicas by
    execute_local on that node."""
    from surrealdb_tpu_torch.cluster.placement import placement_key
    from surrealdb_tpu_torch.dbs.session import Session

    s = Session.owner("test", "test")
    data = gen_corpus(n, dim, seed=9)
    run = sql_runner(stores[0])
    run("DEFINE TABLE fresh SCHEMALESS; "
        f"DEFINE INDEX femb ON fresh FIELDS emb MTREE DIMENSION {dim} DIST EUCLIDEAN")
    write_s = 0.0
    for lo in range(0, n, batch):
        rows = [{"id": j, "emb": data[j].tolist()} for j in range(lo, min(lo + batch, n))]
        t = time.perf_counter()
        run("INSERT INTO fresh $rows RETURN NONE", {"rows": rows})
        write_s += time.perf_counter() - t
    held = {}
    for ds in stores:
        res = ds.execute_local("SELECT id, emb FROM fresh", s)
        require(res[-1]["status"] == "OK", f"{ds.cluster.node_id} read-back: {res[-1]}")
        held[ds.cluster.node_id] = {int(r["id"].id): r["emb"] for r in res[-1]["result"]}
    copies = 0
    for j in range(n):
        for nid in membership.replicas_of_key(placement_key("fresh", j), CLUSTER_RF):
            got = held[nid].get(j)
            require(got is not None and np.array_equal(np.asarray(got, np.float32), data[j]),
                    f"fresh:{j} acknowledged but not read back from replica {nid}")
            copies += 1
    require(copies == CLUSTER_RF * n and sum(len(h) for h in held.values()) == copies,
            f"{copies} replica copies read back, {({k: len(v) for k, v in held.items()})} held")
    run("REMOVE TABLE fresh")
    return dict(rows=n, rows_a_statement=batch, write_s=write_s, write_rows_per_s=n / write_s,
                replica_copies_read_back=copies)


def _multiset(v) -> str:
    """A graph answer as a multiset (edge ids are random a store, so two
    stores expand hops in different orders)."""
    if isinstance(v, list):
        return "[" + ",".join(sorted(_multiset(x) for x in v)) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(f"{k}:{_multiset(x)}" for k, x in sorted(v.items())) + "}"
    return repr(v)


def cluster_parity(torch, device, stores, membership) -> dict:
    """The executor's other routes against one node on the same card and
    data, at a small size: a filtered scan with ORDER/LIMIT (equal), BM25
    two-phase at TPU_FT_ONDEVICE_THRESHOLD 1 (every node's shard runs K9's
    match under the merged global stats: ids and order equal up to ties,
    scores to BM25_TOL), and a 2-hop graph select (equal as multisets; no
    kernel launched while the cluster answers it: cluster/rpc.py expands
    pointer keys on the host; the single node's own launches are shown)."""
    from surrealdb_tpu_torch import bg, cnf
    from surrealdb_tpu_torch.cluster.placement import placement_key
    from surrealdb_tpu_torch.kvs.ds import Datastore

    ref = Datastore("memory", device=device)
    both = (sql_runner(stores[0]), sql_runner(ref))
    out = {}
    try:
        # a filtered scan with ORDER / LIMIT
        rng = np.random.default_rng(21)
        rows = [{"id": i, "band": int(i % 7), "val": int(v)}
                for i, v in enumerate(rng.integers(0, 10_000, CLUSTER_PARITY_DOCS))]
        for run in both:
            run("DEFINE TABLE acct SCHEMALESS; INSERT INTO acct $rows RETURN NONE",
                {"rows": rows})
        scans = ("SELECT id, val FROM acct WHERE band = 3 AND val > 2000 "
                 "ORDER BY val DESC, id LIMIT 25",
                 "SELECT VALUE val FROM acct WHERE val < 500 ORDER BY val, id",
                 "SELECT band, count() AS n, math::sum(val) AS tot FROM acct GROUP BY band")
        for sql in scans:
            a, b = (run(sql) for run in both)
            require(a == b and len(a) > 0, f"cluster scan differs from one node: {sql}")
        out["scan"] = dict(rows=CLUSTER_PARITY_DOCS, statements=len(scans), equal=True)

        # BM25 two-phase, K9's match on every shard
        words = None
        for run in both:
            run(FT_SCHEMA)
            words, _ = ft_ingest(run, CLUSTER_PARITY_DOCS, 1024)
        pairs = ft_query_pairs(24)
        local = {ds.cluster.node_id: set() for ds in stores}
        for j in range(CLUSTER_PARITY_DOCS):
            for nid in membership.replicas_of_key(placement_key("doc", j), CLUSTER_RF):
                local[nid].update(int(w) for w in words[j])
        want_launches = sum(all(int(w) in held for w in pair)
                            for held in local.values() for pair in pairs)
        saved = cnf.TPU_FT_ONDEVICE_THRESHOLD
        cnf.TPU_FT_ONDEVICE_THRESHOLD = 1
        try:
            got = []
            reset_launches()
            for pair in pairs:
                got.append(both[0](FT_SQL.format(" ".join(ft_word(int(w)) for w in pair))))
            if device == "cuda":
                torch.cuda.synchronize()
            launches = read_launches()
            want_ref = [both[1](FT_SQL.format(" ".join(ft_word(int(w)) for w in pair)))
                        for pair in pairs]
        finally:
            cnf.TPU_FT_ONDEVICE_THRESHOLD = saved
        if device == "cuda":
            want = {c.name: 0 for c in kernel_counters()}
            want.update(bm25_match_scores=want_launches)
            require(launches == want, f"BM25 launches {launches}, want {want_launches} "
                                      "K9 matches (a node, a query whose words it holds)")
        err, tied, hits = 0.0, 0, 0
        for pair, a, b in zip(pairs, got, want_ref):
            require(len(a) == len(b), f"BM25 {pair}: {len(a)} rows, one node {len(b)}")
            sa = np.array([r["sc"] for r in a], np.float64)
            sb = np.array([r["sc"] for r in b], np.float64)
            require(np.allclose(sa, sb, **BM25_TOL), f"BM25 {pair}: scores {sa} vs {sb}")
            err = max(err, float(np.abs(sa - sb).max(initial=0.0)))
            for ra, rb in zip(a, b):
                if ra["id"] != rb["id"]:
                    require(abs(ra["sc"] - rb["sc"]) <= BM25_TOL["atol"]
                            + BM25_TOL["rtol"] * abs(rb["sc"]),
                            f"BM25 {pair}: {ra} where one node has {rb}, not a tie")
                    tied += 1
            hits += len(a)
        out["bm25"] = dict(docs=CLUSTER_PARITY_DOCS, queries=len(pairs), rows=hits,
                           k9_match_launches=launches.get("bm25_match_scores")
                           if device == "cuda" else None,
                           want_launches=want_launches, max_abs_score_diff=err,
                           rows_tied=tied, tol=BM25_TOL)

        # a 2-hop graph select
        edges = np.random.default_rng(23).integers(0, CLUSTER_PARITY_NODES,
                                                   size=(CLUSTER_PARITY_EDGES, 2))
        rel = "; ".join(f"RELATE person:{int(a)}->knows->person:{int(b)} RETURN NONE"
                        for a, b in edges)
        for run in both:
            run("DEFINE TABLE person SCHEMALESS; DEFINE TABLE knows SCHEMALESS; "
                "INSERT INTO person $rows RETURN NONE",
                {"rows": [{"id": i} for i in range(CLUSTER_PARITY_NODES)]})
            run(rel)
        seeds = (0, 7, 42, 199)
        sqls = [sql for sd in seeds for sql in (
            f"SELECT VALUE ->knows->person->knows->person FROM person:{sd}",
            f"SELECT ->knows->person AS f FROM person:{sd}")]

        def window(run):
            """The selects through `run` with the counts at 0, after and
            before every store's background work (the RELATEs arm each
            store's graph prewarm, which warms K8 after 0.5 s) -> (answers,
            launches)."""
            for ds in stores + [ref]:
                require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
            reset_launches()
            res = [run(sql) for sql in sqls]
            for ds in stores + [ref]:
                require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
            if device == "cuda":
                torch.cuda.synchronize()
            return res, read_launches()

        got, launches = window(both[0])
        # no kernel at all: cluster/rpc.py expands pointer keys on the host
        require(not any(launches.values()), f"the cluster's 2-hop selects launched {launches}")
        want_ref, ref_launches = window(both[1])
        for sql, a, b in zip(sqls, got, want_ref):
            require([_multiset(v) for v in a] == [_multiset(v) for v in b],
                    f"cluster graph select differs from one node: {sql}")
        out["graph"] = dict(nodes=CLUSTER_PARITY_NODES, edges=CLUSTER_PARITY_EDGES,
                            seeds=len(seeds), statements=len(sqls), multiset_equal=True,
                            cluster_launches={}, single_node_launches={
                                n: c for n, c in ref_launches.items() if c})
    finally:
        ref.close()
    return out


def cluster_nodes(ports):
    return [{"id": f"n{i + 1}", "url": f"http://127.0.0.1:{p}"} for i, p in enumerate(ports)]


def cluster_topology(path, ports, secret):
    nodes = cluster_nodes(ports)
    with open(path, "w") as f:
        json.dump({"nodes": nodes, "self": "n1", "vnodes": CLUSTER_VNODES, "secret": secret}, f)
    return nodes


class ClusterCliPair:
    """`python -m surrealdb_tpu_torch start --cluster topo.json
    [--cluster-node n2] --device <device>` twice (CliChild), started
    first so their start-up overlaps the phase's load; run() writes seeded
    rows over HTTP to n1 (SDK, CBOR), checks that each node's own store
    holds every one (RF 2 of 2, read on the internal /cluster channel) and
    that a kNN through either node gives numpy's exact top-k over the rows
    as held (bf16 on a card) up to ties, and ends both with SIGINT (code 0);
    close() kills what is left."""

    def __init__(self, device):
        import tempfile

        self.device = device
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
        self.ports = [free_port(), free_port()]
        topo = os.path.join(self.tmp, "topo.json")
        self.secret = "chip-smoke-cli"
        self.nodes = cluster_topology(topo, self.ports, self.secret)
        self.children = []
        for i, port in enumerate(self.ports):
            child = CliChild(["--unauthenticated", "--cluster", topo, "--device", device]
                             + (["--cluster-node", f"n{i + 1}"] if i else []), port=port)
            self.children.append(child)

    def run(self, torch, dim: int, rows: int, k: int, n_queries: int) -> dict:
        from surrealdb_tpu_torch.cluster import ClusterConfig
        from surrealdb_tpu_torch.cluster.client import ClusterClient
        from surrealdb_tpu_torch.sdk import Surreal

        ports, t0 = self.ports, self.children[0].t0
        up_s = max(c.wait_health(f"cluster CLI node n{i + 1}")
                   for i, c in enumerate(self.children))
        # each node's probe of the other must have seen it up
        while True:
            views = []
            for port, other in ((ports[0], "n2"), (ports[1], "n1")):
                text = http_call("127.0.0.1", port, "GET", "/metrics")[1].decode()
                views.append(metric_value(text, f'surreal_cluster_node_up{{node="{other}"}}'))
            if views == [1.0, 1.0]:
                break
            require(time.perf_counter() - t0 < 240, f"CLI nodes' probes: {views}")
            time.sleep(0.2)
        probes_s = time.perf_counter() - t0 - up_s
        data, qs = cli_data(dim, rows, n_queries)
        t = time.perf_counter()
        with Surreal(f"http://127.0.0.1:{ports[0]}", format="cbor") as db:
            db.use("test", "test")
            res = db.query("DEFINE TABLE item SCHEMALESS; DEFINE INDEX iemb ON item FIELDS emb "
                           f"MTREE DIMENSION {dim} DIST EUCLIDEAN")
            require(all(r["status"] == "OK" for r in res), f"CLI cluster DDL: {res}")
            sdk_insert(db, data, CLUSTER_CLI_BATCH, "CLI cluster")
        write_s = time.perf_counter() - t
        # RF 2 of 2: each node's own store holds every row
        client = ClusterClient(ClusterConfig(self.nodes, "n1", vnodes=CLUSTER_VNODES,
                                             secret=self.secret))
        try:
            held = {}
            for nid in ("n1", "n2"):
                r = client.call(nid, "query", {"sql": "SELECT count() FROM item GROUP ALL",
                                               "ns": "test", "db": "test"})
                held[nid] = r["results"][-1]["result"][0]["count"]
        finally:
            client.shutdown()
        require(held == {"n1": rows, "n2": rows}, f"CLI nodes hold {held}, want {rows} each")
        by_node = {}
        for nid, port in zip(("n1", "n2"), ports):
            got, lat = [], []
            with Surreal(f"http://127.0.0.1:{port}", format="cbor") as db:
                db.use("test", "test")
                for q in qs:
                    t = time.perf_counter()
                    res = db.query(f"SELECT id FROM item WHERE emb <|{k}|> $q", {"q": q.tolist()})
                    lat.append(time.perf_counter() - t)
                    require(res[-1]["status"] == "OK", f"CLI cluster query via {nid}: {res[-1]}")
                    got.append(result_ids(res[-1]["result"]))
            hold_to_exact_topk(torch, self.device, data, qs, got, k,
                               f"the CLI cluster via {nid}")
            by_node[nid] = statistics.median(lat) * 1e3
        rcs = [c.stop(f"CLI node n{i + 1}") for i, c in enumerate(self.children)]
        return dict(nodes=2, rf=2, rows=rows, dim=dim, device=self.device, up_s=up_s,
                    probes_up_s=probes_s, write_s=write_s, write_rows_per_s=rows / write_s,
                    rows_held=held, queries_a_node=n_queries, p50_ms_by_node=by_node,
                    exact_up_to_ties=True, sigint_rcs=rcs)

    def close(self):
        import shutil

        for child in self.children:
            child.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


def single_node_answers(torch, device, corpus, queries, batch: int, k: int):
    """One node's answers to the queries over the same rows (sequentially),
    for a cluster run whose rows differ from main_path_file's."""
    from surrealdb_tpu_torch.kvs.ds import Datastore

    ds = Datastore("memory", device=device)
    try:
        run = sql_runner(ds)
        run(file_schema(corpus.shape[1]))
        sql = f"SELECT id FROM item WHERE emb <|{k}|> $q"
        ingest(run, corpus, batch, 0, batch)
        run(sql, {"q": corpus[0].tolist()})
        ingest(run, corpus, batch, batch)
        return [run(sql, {"q": q.tolist()}) for q in queries]
    finally:
        ds.close()


def phase_main_path_cluster(torch, device: str, corpus, queries, truth, smi, batch: int,
                            n_seq: int, n_threads: int, rounds: int, single_results=None,
                            write_rows: int = CLUSTER_WRITE_ROWS,
                            cli_rows: int = CLUSTER_CLI_ROWS):
    """Config 2's kNN from a 3-node RF-2 cluster (README.md "Cluster mode",
    cnf.CLUSTER_RF, 64 vnodes): each node a full Datastore on `device`
    behind net.server.serve(..., cluster_config=...) on 127.0.0.1, all in
    this process (tests/test_cluster.py's harness). The rows go into each
    node's own store by the ring's placement (cluster_load), then the
    coordinator's own write path is timed on fresh rows
    (cluster_write_path). The MTREE cell's queries go through n1's
    Datastore.execute (the scatter/gather executor: 24 sequential, 32
    clients x 2) and 24 through the SDK over WebSocket to n1; each must
    reach every node's K2 (`exact-device`, launches = the nodes' dispatched
    tiles), recall@10 >= 0.99, ids equal to `single_results` (one node's
    answers on the same rows; built here when None) up to ties. Then the
    statement's spans beside the remote ones, the executor's other routes
    at a small size (cluster_parity), n3 stopped (the same 24 answers,
    `degraded`, cluster_failover_total up), and the CLI pair
    (cluster_cli_pair)."""
    from surrealdb_tpu_torch import cluster, telemetry
    from surrealdb_tpu_torch.net.server import serve
    from surrealdb_tpu_torch.sdk import Surreal

    k = 10
    rows, dim = corpus.shape
    sql = f"SELECT id FROM item WHERE emb <|{k}|> $q"
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    marks = {}

    def at(step):  # the phase's clock at the end of each step
        marks[step] = time.perf_counter() - t_phase
        emit("main_path_cluster_clock", step=step, at_s=marks[step])

    cli = ClusterCliPair(device)  # its start-up overlaps the load
    try:
        ports = [free_port() for _ in range(CLUSTER_NODES)]
        nodes = cluster_nodes(ports)
        servers, stores = [], []
        down = set()
        out = dict(nodes=CLUSTER_NODES, rf=CLUSTER_RF, vnodes=CLUSTER_VNODES, rows=rows, dim=dim,
                   k=k, device=device, nvidia_smi=smi,
                   reduced=None if rows == 1 << 20 else {
                       "rows": rows, "published_rows": 1 << 20,
                       "why": "the script's time limit (--cluster-rows 1048576 runs the full "
                              "2^20 alone)"},
                   bulk_load="in process, each node's own store by the ring's placement "
                             "(the coordinator's write path is timed on write_rows fresh rows)")
        try:
            for i, port in enumerate(ports):
                cfg = cluster.ClusterConfig(nodes, f"n{i + 1}", vnodes=CLUSTER_VNODES,
                                            secret="chip-smoke-cluster")
                srv = serve("memory", "127.0.0.1", port, auth_enabled=False, cluster_config=cfg,
                            device=device).start_background()
                servers.append(srv)
                stores.append(srv.httpd.RequestHandlerClass.ds)
            coord = stores[0]
            membership = coord.cluster.membership
            out["peers_up_s"] = cluster_up(stores)
            run = sql_runner(coord)
            run(file_schema(dim))  # DDL through the coordinator: every node
            at("up")
            out["load"] = cluster_load(stores, membership, corpus, rows, batch, k)
            at("load")
            emit("main_path_cluster_load", **out["load"])
            out["write_path"] = cluster_write_path(stores, membership, dim, write_rows,
                                                   min(write_rows, CLUSTER_WRITE_BATCH))
            at("write_path")
            emit("main_path_cluster_write", **out["write_path"])
            # the first query through the coordinator uploads every node's mirror
            t = time.perf_counter()
            run(sql, {"q": queries[0].tolist()})
            out["first_query_with_upload_s"] = time.perf_counter() - t
            mem0 = window_start(torch, device)
            results, out["in_process"] = cluster_knn_window(
                torch, device, stores, lambda i: run(sql, {"q": queries[i].tolist()}), queries,
                truth, k, n_seq, n_threads, rounds, CLUSTER_NODES)
            out["device_memory_at_window_start_bytes"] = mem0
            at("in_process")
            emit("main_path_cluster_knn", **out["in_process"])
            out["spans_mean_ms"] = cluster_spans(coord, sql, queries, 8)
            emit("main_path_cluster_spans", **out["spans_mean_ms"])

            ws_url = servers[0].url.replace("http://", "ws://") + "/rpc"
            with Surreal(ws_url, format="cbor") as db:
                db.use("test", "test")

                def ask_ws(i):
                    res = db.query(sql, {"q": queries[i].tolist()})
                    require(res[-1]["status"] == "OK", f"query {i} over WebSocket: {res[-1]}")
                    return res[-1]["result"]

                ws_results, out["ws"] = cluster_knn_window(
                    torch, device, stores, ask_ws, queries[:n_seq], truth[:n_seq], k, n_seq,
                    0, 0, CLUSTER_NODES, min_recall=None)
            require([result_ids(r) for r in ws_results]
                    == [result_ids(r) for r in results[:n_seq]],
                    "the WebSocket answers differ from the in-process ones")
            at("ws")
            emit("main_path_cluster_ws", **out["ws"])

            out["parity"] = cluster_parity(torch, device, stores, membership)
            at("parity")
            emit("main_path_cluster_parity", **out["parity"])

            # failover: n3's server stops; every record keeps a live replica
            fo0 = sum(telemetry.counters_matching("cluster_failover_total").values())
            servers[2].shutdown()
            down.add(2)
            lat, degraded = [], 0
            for i in range(n_seq):
                t = time.perf_counter()
                r = coord.execute(sql, vars={"q": queries[i].tolist()})[-1]
                lat.append(time.perf_counter() - t)
                require(r["status"] == "OK", f"query {i} with n3 down: {r}")
                require(result_ids(r["result"]) == result_ids(results[i]),
                        f"query {i} with n3 down answers {result_ids(r['result'])}, "
                        f"healthy {result_ids(results[i])}")
                degraded += r.get("degraded") is True
            require(degraded == n_seq,
                    f"{degraded} of {n_seq} answers with n3 down say degraded")
            fo = sum(telemetry.counters_matching("cluster_failover_total").values()) - fo0
            require(fo > 0, "cluster_failover_total did not rise with n3 down")
            out["failover"] = dict(down="n3", queries=n_seq, equal=True, degraded=degraded,
                                   failover_total=fo, seq_p50_ms=statistics.median(lat) * 1e3)
            at("failover")
            out["peak_device_memory_bytes_phase"] = (
                torch.cuda.max_memory_allocated() if device == "cuda" else None)
        finally:
            for i, (srv, ds) in enumerate(zip(servers, stores)):
                cluster.detach(ds)
                if i not in down:
                    srv.shutdown()
                ds.close()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        if single_results is None:
            t = time.perf_counter()
            single_results = single_node_answers(torch, device, corpus, queries, batch, k)
            out["single_node_build_s"] = time.perf_counter() - t
        at("single_node")

        def rows_of(ids):
            held = torch.from_numpy(corpus[ids]).to(device)
            return held.bfloat16().float() if device == "cuda" else held

        equal, tied = ids_up_to_ties(torch, rows_of, queries, results, single_results, k)
        out["single_node"] = dict(ids_equal_queries=equal, ids_tied_queries=tied, tol=TOL)
        emit("main_path_cluster_single_node", **out["single_node"])
        out["cli"] = cli.run(torch, dim, cli_rows, k, 8)
    finally:
        cli.close()
    at("cli")
    out["seconds"] = time.perf_counter() - t_phase
    out["clock_at_s"] = marks
    emit("main_path_cluster", **out)
    return out


def kernel_entry(name, kern, source, replaces, launches, err, timing, shape, extra=None):
    # the main path's launches and the checks' error stand over any timing key
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, **timing,
        "launches": launches, "max_abs_err": err, "shape": shape, **(extra or {}),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20,
                    help="MTREE corpus rows (the HNSW phase always runs at 2^20)")
    ap.add_argument("--multicard", action="store_true",
                    help="only the mesh over every visible card (needs 2+ cards)")
    ap.add_argument("--ml-only", action="store_true",
                    help="only the K10 and K16 checks (phases ml_kernels, onnx_check), "
                         "ml_linear's narrow against its skinny design (phase ml_paths) "
                         "and the ONNX path over config 5's items in an MTREE store")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the main paths tiny on the CPU (plain versions); exits 1")
    ap.add_argument("--file-rows", type=int, default=FILE_ROWS,
                    help="rows of phase 12 (main_path_file): a multiple of 65,536 up to 2^20")
    ap.add_argument("--file-only", action="store_true",
                    help="only phase 12 (main_path_file), at --file-rows")
    ap.add_argument("--server-only", action="store_true",
                    help="only phase 3's MTREE store and main_path_server on it")
    ap.add_argument("--cluster-rows", type=int, default=CLUSTER_ROWS,
                    help="rows of phase 13 (main_path_cluster): a multiple of 65,536 up to 2^20")
    ap.add_argument("--cluster-only", action="store_true",
                    help="only phase 13 (main_path_cluster), at --cluster-rows, with "
                         f"{CLUSTER_WRITE_ROWS:,} fresh rows through the coordinator")
    # phase 12's child process (file_child); not for callers
    ap.add_argument("--file-child", help=argparse.SUPPRESS)
    ap.add_argument("--file-dim", type=int, default=DIM, help=argparse.SUPPRESS)
    ap.add_argument("--file-device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--file-batch", type=int, default=FILE_BATCH, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if args.file_child:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return file_child(args.file_child, args.file_rows, args.file_dim, args.file_device,
                          args.file_batch)

    if args.cpu_rehearsal:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from surrealdb_tpu_torch import cnf

        cnf.TPU_KNN_ONDEVICE_THRESHOLD = 16
        cnf.TPU_ANN_MIN_ROWS = 1024
        corpus = gen_corpus(4096, 32)
        queries = make_queries(corpus, 4 + 8 * 2, 42)
        truth = knn_ground_truth(corpus, queries, 10)
        mesh_paths = MeshPaths(torch, "cpu", queries, truth, corpus, n_seq=4, n_threads=8,
                               rounds=2)

        def server_then_mesh(ds, results, out):
            return (phase_main_path_server(torch, "cpu", ds, queries, truth, results, out, None,
                                           n_seq=4, n_threads=8, rounds=2),
                    mesh_paths.mtree(ds, results, out))

        phase_main_path(torch, "cpu", corpus, queries, truth, batch=1000,
                        n_seq=4, n_threads=8, rounds=2, then=server_then_mesh)
        phase_main_path_hnsw(torch, "cpu", corpus, queries, truth, batch=1000,
                             n_seq=4, n_threads=8, rounds=2, then=mesh_paths.hnsw)
        phase_dryrun_mesh(torch, "cpu")
        # 200 nodes x 4,000 edges: the thresholds come down so every device
        # branch of the graph path runs (its plain versions)
        cnf.TPU_GRAPH_COUNT_EDGES = 1000
        cnf.TPU_GRAPH_ONDEVICE_THRESHOLD = 64
        phase_main_path_graph(torch, "cpu", 200, 4000, batch=1000, n_seq=4, n_threads=8,
                              rounds=2, n_odd=2, n_fof=4)
        phase_main_path_bm25(torch, "cpu", 3000, 1000, n_seq=4, n_threads=8, rounds=2)
        file_path = phase_main_path_file(torch, "cpu", corpus.shape[0], 32, queries, truth,
                                         None, batch=1000, n_seq=4, n_threads=8, rounds=2)
        phase_main_path_cluster(torch, "cpu", corpus, queries, truth, None, batch=1000,
                                n_seq=4, n_threads=8, rounds=2,
                                single_results=file_path["results"], write_rows=256,
                                cli_rows=512)
        print("cpu rehearsal: no card, no result", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import surrealdb_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: surrealdb_tpu_torch not found beside this script: {e}",
              file=sys.stderr)
        return 2
    full = 1 << 20
    for flag, rows in (("--file-rows", args.file_rows), ("--cluster-rows", args.cluster_rows)):
        if not (0 < rows <= full and rows % 65_536 == 0):
            # gen_corpus(rows) is then the first rows of phase 3's corpus
            ap.error(f"{flag} must be a multiple of 65,536 up to 2^20")
    t_all = time.perf_counter()
    if args.multicard or args.ml_only or args.file_only or args.server_only or args.cluster_only:
        try:
            smi = phase_environment(torch)
            if args.ml_only:
                phase_ml_kernels(torch)
                phase_onnx_check(torch)
                phase_ml_paths(torch)
                corpus = gen_corpus(full, DIM)
                ds = config5_store("cuda", corpus, FILE_BATCH)
                try:
                    phase_main_path_onnx(torch, "cuda", ds, corpus, import_mlp=True)
                finally:
                    ds.close()
            elif args.server_only:
                corpus = gen_corpus(full, DIM)
                queries = make_queries(corpus, 24 + 32 * 2, 42)
                truth = knn_ground_truth(corpus, queries, 10)
                phase_main_path(
                    torch, "cuda", corpus, queries, truth, batch=20_000, n_seq=24,
                    n_threads=32, rounds=2,
                    then=lambda ds, results, out: phase_main_path_server(
                        torch, "cuda", ds, queries, truth, results, out, smi, n_seq=24,
                        n_threads=32, rounds=2))
            elif args.file_only:
                corpus = gen_corpus(full, DIM)
                queries = make_queries(corpus, 24 + 32 * 2, 42)
                truth = knn_ground_truth(corpus[: args.file_rows], queries, 10)
                del corpus
                phase_main_path_file(torch, "cuda", args.file_rows, DIM, queries, truth, smi,
                                     batch=FILE_BATCH, n_seq=24, n_threads=32, rounds=2)
            elif args.cluster_only:
                corpus = gen_corpus(full, DIM)
                queries = make_queries(corpus, 24 + 32 * 2, 42)
                corpus = corpus[: args.cluster_rows].copy()
                truth = knn_ground_truth(corpus, queries, 10)
                phase_main_path_cluster(torch, "cuda", corpus, queries, truth, smi,
                                        batch=FILE_BATCH, n_seq=24, n_threads=32, rounds=2)
            else:
                phase_mesh_multicard(torch)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(smi, flush=True)
        return 0
    try:
        smi = phase_environment(torch)
        k1_err, k2_err = phase_kernels(torch, DIM, min(args.rows, full))
        ivf_inputs, k5_err, k4_err = phase_ivf_kernels(torch, DIM, full)
        timing = phase_timing(torch, DIM, args.rows, 10)
        ivf_timing = phase_ivf_timing(torch, ivf_inputs, DIM)
        del ivf_inputs
        torch.cuda.empty_cache()
        graph_k = phase_graph_kernels(torch)
        mesh_graph_k = phase_mesh_kernels_graph(torch)
        torch.cuda.empty_cache()
        corpus = gen_corpus(full, DIM)
        queries = make_queries(corpus, 24 + 32 * 2, 42)
        t = time.perf_counter()
        truth = knn_ground_truth(corpus, queries, 10)  # shared by both main paths
        emit("ground_truth", queries=queries.shape[0], seconds=time.perf_counter() - t)
        mtree_truth = truth if args.rows == full else knn_ground_truth(
            corpus[: args.rows], queries, 10)
        file_truth = truth if args.file_rows == full else knn_ground_truth(
            corpus[: args.file_rows], queries, 10)
        cluster_truth = file_truth if args.cluster_rows == args.file_rows else (
            truth if args.cluster_rows == full else knn_ground_truth(
                corpus[: args.cluster_rows], queries, 10))
        mesh_mtree = MeshPaths(torch, "cuda", queries, mtree_truth, corpus, n_seq=24,
                               n_threads=32, rounds=2).mtree

        def server_then_mesh(ds, results, out):
            return (phase_main_path_server(torch, "cuda", ds, queries, mtree_truth, results, out,
                                           smi, n_seq=24, n_threads=32, rounds=2),
                    mesh_mtree(ds, results, out))

        main = phase_main_path(
            torch, "cuda", corpus[: args.rows], queries, mtree_truth, batch=20_000, n_seq=24,
            n_threads=32, rounds=2, then=server_then_mesh)
        server, mesh_a = main.pop("then")
        gc.collect()
        hnsw = phase_main_path_hnsw(
            torch, "cuda", corpus, queries, truth, batch=20_000, n_seq=24, n_threads=32,
            rounds=2, then=MeshPaths(torch, "cuda", queries, truth, corpus, n_seq=24,
                                     n_threads=32, rounds=2).hnsw)
        ml, onnx, mesh_b = hnsw.pop("then")
        cluster_corpus = corpus[: args.cluster_rows].copy()  # gen_corpus(rows)'s rows
        del corpus
        gc.collect()
        torch.cuda.empty_cache()
        graph = phase_main_path_graph(torch, "cuda", GRAPH_NODES, GRAPH_EDGES, GRAPH_BATCH,
                                      n_seq=24, n_threads=32, rounds=2)
        gc.collect()
        torch.cuda.empty_cache()
        bm25_k = phase_bm25_kernels(torch)
        bm25 = phase_main_path_bm25(torch, "cuda", FT_DOCS, FT_BATCH, n_seq=24, n_threads=32,
                                    rounds=2)
        gc.collect()
        torch.cuda.empty_cache()
        ml_k = phase_ml_kernels(torch)
        onnx_k = phase_onnx_check(torch)
        gc.collect()
        torch.cuda.empty_cache()
        dry = phase_dryrun_mesh(torch, "cuda")
        emit("server_seconds", main_path_server=server["seconds"])
        emit("mesh_seconds", main_path_mesh_mtree=mesh_a["seconds"],
             main_path_mesh_hnsw=mesh_b["seconds"],
             mesh_kernels=mesh_a["kernels"]["seconds"] + mesh_b["kernels"]["seconds"]
             + mesh_graph_k["seconds"], dryrun_mesh=dry["seconds"])
        gc.collect()
        torch.cuda.empty_cache()
        file_path = phase_main_path_file(torch, "cuda", args.file_rows, DIM, queries,
                                         file_truth, smi, batch=FILE_BATCH, n_seq=24,
                                         n_threads=32, rounds=2)
        file_results = file_path.pop("results")
        gc.collect()
        torch.cuda.empty_cache()
        # one node's answers on the same rows: phase 12's after recovery
        cluster = phase_main_path_cluster(
            torch, "cuda", cluster_corpus, queries, cluster_truth, smi,
            batch=FILE_BATCH, n_seq=24, n_threads=32, rounds=2,
            single_results=file_results if args.cluster_rows == args.file_rows else None,
            write_rows=128, cli_rows=CLUSTER_CLI_BATCH)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # one entry a kernel, timed at Q=1 (the tile most of the main paths'
    # launches use) or at the training's shapes; other shapes ride along
    knn_shape = {"q": 1, "n": args.rows, "d": DIM, "k": 10, "corpus": "bfloat16"}
    kernels = []
    for name, kern, replaces, err in (
        ("K1 pairwise_distance (knn_pairwise)", "knn_pairwise",
         "surrealdb_tpu/ops/distances.py:41", k1_err),
        ("K2 knn_search (fused knn_search + merge; k > 256: knn_pairwise + knn_select)",
         "knn_select", "surrealdb_tpu/ops/distances.py:87", k2_err),
    ):
        extra = {"by_q": {str(nq): timing[nq][kern] for nq in (8, 64)}}
        if kern == "knn_select":
            extra["by_variant"] = {"ivf probe (q 1, n 1024 f32, k 6)": timing["probe"]}
            extra["main_path_file_launches"] = (
                file_path["after_recovery_launches"][kern]
                + file_path["snapshot_reopen_launches"][kern])
            # the coordinator's 88 queries: every node's shard, summed
            extra["main_path_cluster_launches"] = cluster["in_process"]["launches"][kern]
        kernels.append(kernel_entry(
            name, kern, "surrealdb_tpu_torch/csrc/knn.cu", replaces, main["launches"][kern],
            err, timing[1][kern], knn_shape, extra,
        ))
    run_launches = hnsw["run_launches"]
    k3 = hnsw["k3_timing"]
    k3_shape_keys = ("candidate_rows", "probed_lists", "rows_read", "mode")
    k3_extra = ("by_mode", "launches", "kernels")  # a call's, beside the run's launches
    kernels.append(kernel_entry(
        "K3 _ivf_search (fused knn_search probe + ivf_rerank + mesh_topk_merge, 4 kernels a "
        "tile)",
        "ivf_rerank", "surrealdb_tpu_torch/csrc/ivf.cu",
        "surrealdb_tpu/idx/ivf.py:693", run_launches["ivf_rerank"], hnsw["k3_err"],
        {kk: v for kk, v in k3[1].items() if kk not in k3_shape_keys + k3_extra},
        {"q": 1, "nlists": hnsw["nlists"], "nprobe": hnsw["nprobe"], "L": hnsw["L"],
         "n": full, "d": DIM, "k": 10, **{kk: k3[1][kk] for kk in k3_shape_keys}},
        {"by_q": {str(nq): k3[nq] for nq in (8, 64)}, "by_mode": k3[1]["by_mode"],
         "kernels_a_call": k3[1]["kernels"],
         "launches_by_kernel": {n: run_launches[n] for n in ("knn_select", "ivf_rerank",
                                                              "mesh_topk_merge")}},
    ))
    kernels.append(kernel_entry(
        "K4 _kmeans_step (ivf_assign k=1 + ivf_kmeans_update)", "ivf_kmeans_update",
        "surrealdb_tpu_torch/csrc/ivf.cu", "surrealdb_tpu/idx/ivf.py:98",
        run_launches["ivf_kmeans_update"], k4_err, ivf_timing["ivf_kmeans_update"],
        {"rows": 65_536, "c": 1024, "d": DIM, "corpus": "bfloat16"},
    ))
    kernels.append(kernel_entry(
        "K5 _assign_gather / _assign_chunk (ivf_assign)", "ivf_assign",
        "surrealdb_tpu_torch/csrc/ivf.cu", "surrealdb_tpu/idx/ivf.py:82",
        run_launches["ivf_assign"], k5_err, ivf_timing["ivf_assign"],
        {"rows": 65_536, "cap": full, "c": 1024, "d": DIM, "k_assign": 2,
         "index_vector": True, "corpus": "bfloat16"},
        {"by_variant": {"rows_k1 (surrealdb_tpu/idx/ivf.py:71)":
                        ivf_timing["ivf_assign_rows_k1"]}},
    ))
    graph_shape = {"nodes": GRAPH_NODES, "edges": GRAPH_EDGES}
    for name, kern, replaces in (
        ("K6 chain_kernel (graph_chain)", "graph_chain", "surrealdb_tpu/idx/graph_csr.py:272"),
        ("K7 chain_count_batch (graph_csc_count)", "graph_csc_count",
         "surrealdb_tpu/idx/graph_csr.py:287"),
        ("K8 dense_count_batch (graph_dense_count)", "graph_dense_count",
         "surrealdb_tpu/idx/graph_csr.py:341"),
    ):
        tm = dict(graph_k["timing"][kern])
        kernels.append(kernel_entry(
            name, kern, "surrealdb_tpu_torch/csrc/graph.cu", replaces,
            graph["run_launches"][kern], graph_k["max_abs_err"][kern],
            {k: v for k, v in tm.items() if k != "shape"}, {**graph_shape, **tm["shape"]},
        ))
    # K9 at N = 1,000 candidates (about the main path's median), T = 2; its
    # main-path launch is the in-transaction query's (idx/ft_index.py)
    bt = bm25_k["timing"]
    kernels.append(kernel_entry(
        "K9 bm25_scores (bm25_scores; bm25_topk = bm25_scores + knn_select)", "bm25_scores",
        "surrealdb_tpu_torch/csrc/bm25.cu", "surrealdb_tpu/ops/bm25.py:19",
        bm25["launches"]["bm25_scores"] + bm25["txn_query_launches"]["bm25_scores"],
        bm25_k["max_abs_err"],
        {k: bt[1000][k] for k in ("ms", "queued_ms", "plain_ms", "library_ms", "bound_ms",
                                  "bound_by")},
        {"n": 1000, "t": 2, "tf": "float32"},
        {"by_variant": {"bm25_topk k=10 (surrealdb_tpu/ops/bm25.py:40)": {
            "ms": bt[1000]["topk_ms"], "queued_ms": bt[1000]["topk_queued_ms"],
            "plain_ms": bt[1000]["topk_plain_ms"],
            "bound_ms": bt[1000]["topk_bound_ms"], "bound_by": bt[1000]["topk_bound_by"],
            "library_ms": None}},
         "by_n": {str(n): v for n, v in bt.items() if n != 1000}},
    ))
    # K9's match at config 3's median query, with the engine's per-query paths
    bm = bm25_k["match"]
    kernels.append(kernel_entry(
        "K9 bm25_match_scores (the mirror's AND-match and BM25 scores in one launch over "
        "card-resident postings)", "bm25_match_scores", "surrealdb_tpu_torch/csrc/bm25.cu",
        "surrealdb_tpu/ops/bm25.py:19", bm25["launches"]["bm25_match_scores"],
        bm["max_abs_err"],
        {k: bm["timing"][k] for k in ("ms", "queued_ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by")},
        bm["timing"]["shape"],
        {"also_replaces": "surrealdb_tpu/idx/ft_mirror.py:420 (search's host AND-match)",
         "launch_ms": bm["timing"]["launch_ms"],
         "engine_call_host_ms": bm["timing"]["engine_call_host_ms"],
         "kernels_per_call": bm["timing"]["kernels_per_call"],
         "checks": len(bm["checks"]),
         "engine_paths_by_n": {str(n): v for n, v in bm["paths"].items()},
         "main_path_cluster_parity_launches": cluster["parity"]["bm25"]["k9_match_launches"]},
    ))
    # K10 at bench config 5's shape (the mirror's bf16 [2^20, 768] x [768, 1]);
    # its library time includes addmm's upcast of x (library_cast_ms alone,
    # library_nocast_ms addmm on a pre-cast x)
    c5 = ml_k["cases"]["config5_bf16"]
    timing_keys = ("ms", "queued_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    extra_keys = ("library_queued_ms", "f32_fma_bound_ms", "library_cast_ms",
                  "library_nocast_ms", "library_nocast_queued_ms")
    sm = ml_k["cases"]["mlp_128x10_softmax"]["softmax"]
    kernels.append(kernel_entry(
        "K10 CompiledModel._device_fn (ml_linear; ml_softmax for a softmax layer)",
        "ml_linear", "surrealdb_tpu_torch/csrc/ml.cu", "surrealdb_tpu/ml/model.py:193",
        ml["run_launches"]["ml_linear"], ml_k["max_abs_err"],
        {k: c5[k] for k in timing_keys}, {"m": 1 << 20, "k": DIM, "n": 1, "x": "bfloat16"},
        {**{k: c5[k] for k in extra_keys},
         "by_variant": {"ml_softmax [2^20, 10] (surrealdb_tpu/ml/model.py:220)": {
             **{k: sm[k] for k in timing_keys}, "max_abs_err": sm["max_abs_err"],
             "launches": ml["run_launches"]["ml_softmax"]}},
         "by_case": {lab: {k: r[k] for k in ("m", "k", "n", "x", "act") + timing_keys
                           + extra_keys if k in r}
                     for lab, r in ml_k["cases"].items() if lab != "config5_bf16"},
         "mlp_forward_events_ms": ml["mlp_forward_events_ms"]},
    ))
    # K16 (the ONNX plan): ml_ewise at config 5's z-score (graph B's first
    # launch), ml_reduce at graph B's mean, ml_linear's epilogue at graph
    # B's head; launches over the ONNX path's run (both graphs' two scans
    # each, nothing else)
    oc, onnx_run = onnx_k["cases"], onnx["run_launches"]
    k16_keys = ("ms", "queued_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    for name, kern, case, shape in (
        ("K16 ONNX forward: ml_ewise (elementwise chains, Transpose, Concat)", "ml_ewise",
         "ewise_zscore_bf16", {"m": 1 << 20, "n": DIM, "x": "bfloat16", "program": "sub, div"}),
        ("K16 ONNX forward: ml_reduce (ReduceSum, ReduceMean)", "ml_reduce",
         "reduce_mean_inner_2^20x8", {"m": 1 << 20, "n": ONNX_HEAD_GATES, "axes": [1],
                                      "mean": True}),
        ("K16 ONNX forward: ml_linear with an epilogue program (MatMul / Gemm and the chain "
         "after it)", "ml_linear", "linear_narrow_head_f32",
         {"m": 1 << 20, "k": ONNX_HEAD_HIDDEN, "n": ONNX_HEAD_GATES, "x": "float32"}),
    ):
        kernels.append(kernel_entry(
            name, kern, "surrealdb_tpu_torch/csrc/onnx.cu" if kern != "ml_linear"
            else "surrealdb_tpu_torch/csrc/ml.cu", "surrealdb_tpu/ml/model.py:198",
            onnx_run.get(kern, 0), onnx_k["max_abs_err"][kern],
            {k: oc[case][k] for k in k16_keys}, shape,
            {"queued_and_library_by_case": {lab: {k: r.get(k) for k in k16_keys + (
                "library_queued_ms", "max_abs_err", "ulps") if k in r}
                for lab, r in oc.items() if r["kernel"] == kern},
             "plans": {g: onnx[g]["plan"] for g in ("onnx_mlp", "onnx_scaled_head")},
             "forward_device_ms": {g: onnx[g]["forward_device_ms"]
                                   for g in ("onnx_mlp", "onnx_scaled_head")}},
        ))
    # K11-K15 (parallel/mesh.py): 8 shards on cuda:0; K11's launches are
    # the merges of its mesh window and K13's its reranks (one a dispatched
    # tile each), K12, K14 and K15's those of the dry run, their only caller
    ka, kb = mesh_a["kernels"], mesh_b["kernels"]
    mesh_src = "surrealdb_tpu_torch/csrc/mesh.cu"
    kernels.append(kernel_entry(
        "K11 sharded_knn (per shard the fused knn_search, then mesh_topk_merge)",
        "mesh_topk_merge", mesh_src, "surrealdb_tpu/parallel/mesh.py:68",
        mesh_a["launches"]["mesh_topk_merge"], ka["max_abs_err"]["K11"],
        {k: v for k, v in ka["timing"]["K11"][1].items() if k != "single_device_k2_ms"},
        {"q": 1, "n": args.rows, "d": DIM, "k": 10, "shards": MESH_SHARDS, "corpus": "bfloat16"},
        {"by_q": {"64": ka["timing"]["K11"][64]},
         "single_device_k2_ms": ka["timing"]["K11"][1]["single_device_k2_ms"],
         "merge_queued_ms": ka["merge_queued_ms"],
         "launches_by_kernel": {n: mesh_a["launches"][n] for n in (
             "knn_pairwise", "knn_select", "mesh_topk_merge")}},
    ))
    k12 = ka["timing"]["K12"]
    kernels.append(kernel_entry(
        "K12 sharded_knn_2d (mesh_knn_2d per (row, feature) shard, the last one selecting; "
        "mesh_topk_merge)",
        "mesh_knn_2d", mesh_src, "surrealdb_tpu/parallel/mesh.py:123",
        dry["launches"].get("mesh_knn_2d", 0), ka["max_abs_err"]["K12"],
        {kk: v for kk, v in k12[1].items() if kk != "kernels_per_call"},
        {"q": 1, "n": args.rows, "d": DIM, "k": 10, "grid": [4, 2], "corpus": "bfloat16"},
        {"by_q": {str(nq): k12[nq] for nq in (4, 64)},
         "kernels_per_call": k12[1]["kernels_per_call"]},
    ))
    k13 = kb["timing"]
    kernels.append(kernel_entry(
        "K13 _ivf_searcher / sharded_ivf_search (probe once a card; K3's ivf_rerank once "
        "over a card's shards; mesh_topk_merge)",
        "mesh_ivf_rerank", "surrealdb_tpu_torch/csrc/ivf.cu", "surrealdb_tpu/parallel/mesh.py:173",
        mesh_b["launches"]["mesh_ivf_rerank"], kb["max_abs_err"],
        {kk: v for kk, v in k13[1].items() if kk not in K13_EXTRA},
        {"q": 1, "n": full, "d": DIM, "k": 10, "shards": MESH_SHARDS,
         **{kk: k13[1][kk] for kk in ("candidate_rows", "probed_lists", "rows_read")}},
        {"by_q": {str(nq): k13[nq] for nq in (8, 64)},
         "kernels_a_call": k13[1]["kernels"], "kernels_per_call": k13[1]["kernels_per_call"],
         "launches_by_kernel": {n: mesh_b["launches"][n] for n in (
             "knn_pairwise", "knn_select", "ivf_rerank", "mesh_ivf_rerank",
             "mesh_topk_merge")}},
    ))
    gt = mesh_graph_k["timing"]["config1"]
    spread = {k: v for k, v in mesh_graph_k["timing"].items() if k != "config1"}
    for name, kern, replaces, key in (
        ("K14 sharded_frontier_hop (mesh_frontier_hop)", "mesh_frontier_hop",
         "surrealdb_tpu/parallel/mesh.py:263", "K14"),
        ("K15 dedup_frontier (mesh_dedup_frontier)", "mesh_dedup_frontier",
         "surrealdb_tpu/parallel/mesh.py:396", "K15"),
    ):
        kernels.append(kernel_entry(
            name, kern, mesh_src, replaces, dry["launches"].get(kern, 0), 0.0,
            {k: v for k, v in gt[key].items() if k != "shape"}, gt[key]["shape"],
            {"by_shape": {lab: t[key] for lab, t in spread.items()}},
        ))
    emit("done", seconds=time.perf_counter() - t_all)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
