#!/usr/bin/env python3
"""Smoke run of surrealdb_tpu_torch on one CUDA card.

    python3 chip_smoke.py                  # full size: 2^20 x 768 MTREE corpus
    python3 chip_smoke.py --rows 262144    # a cut corpus (record the cut)
    python3 chip_smoke.py --cpu-rehearsal  # tiny, on the CPU, plain versions;
                                           # exits 1 and prints no result

Phases, one JSON line each:
1. environment: the card, its power limit, the kernel build (nvcc, sm_90a);
2. every CUDA kernel of the exact-kNN path against its plain PyTorch version
   on the card, with median times beside the bound, the plain version and
   the torch.cdist(+topk) yardstick;
3. the main path through Datastore.execute: an MTREE index over a seeded
   clustered corpus, ingested with INSERT, then sequential and concurrent
   `<|10|>` queries; every query must take the `exact-device` strategy,
   the kernels' launch counts must show the path ran through them, and
   recall@10 against an f32 exact ground truth must be >= 0.99.

Then the kernel table as one JSON line, the card's name and power limit,
and last `{"ok": true, "device": {...}}`. Any failure exits non-zero. This
script imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

DIM = 768  # the headline corpus's published width (bench.py config 2)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, outside/inside tensor cores
# the CPU tests' tolerance: f32 sums in another order than the plain
# version's (both sides upcast a bf16 corpus to f32 first)
TOL = dict(rtol=1e-5, atol=1e-4)


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


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


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the engine's own duration histograms (telemetry.observe) along the kNN
# path, outermost first
LAYER_SPANS = (
    'statement_duration_seconds{kind="SelectStatement"}',
    "plan_duration_seconds",
    'knn_search_duration_seconds{strategy="exact-device"}',
    "dispatch_queue_wait_duration_seconds",
    "dispatch_launch_duration_seconds",
    "dispatch_pipeline_wait_duration_seconds",
    "dispatch_collect_duration_seconds",
)


def layer_means_ms(before: dict, after: dict) -> dict:
    """Mean ms a call of each layer span over the calls between two
    telemetry snapshots."""
    out = {}
    for name in LAYER_SPANS:
        a, b = after.get(name), before.get(name, {"count": 0, "sum": 0.0})
        if a and a["count"] > b["count"]:
            out[name.split("{")[0].replace("_duration_seconds", "")] = (
                (a["sum"] - b["sum"]) / (a["count"] - b["count"]) * 1e3
            )
    return out


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
        build_seconds=_cuda.build_seconds, load_seconds=load_s,
        ptxas_register_lines=len(regs),
        max_registers=max((int(l.split("Used ")[1].split()[0]) for l in regs), default=None),
    )
    return smi


# ------------------------------------------------------------------ phase 2
def ids_match_up_to_ties(a_d, a_i, b_d, b_i) -> bool:
    """Per query, every id in one result and not the other lies within the
    distance tolerance of the k-th distance (a tie that the two summation
    orders may break differently)."""
    for r in range(a_i.shape[0]):
        kth = float(b_d[r, -1])
        tol = TOL["atol"] + TOL["rtol"] * abs(kth)
        sa, sb = set(a_i[r].tolist()), set(b_i[r].tolist())
        extra = [j for j, v in enumerate(a_i[r].tolist()) if v not in sb]
        missing = [j for j, v in enumerate(b_i[r].tolist()) if v not in sa]
        if any(abs(float(a_d[r, j]) - kth) > tol for j in extra):
            return False
        if any(abs(float(b_d[r, j]) - kth) > tol for j in missing):
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
    for n in (4096, big_n):
        x = torch.randn(n, dim, generator=g).to(dev).to(torch.bfloat16)
        mask = torch.rand(n, generator=g).to(dev) > 0.05  # ~5% dead rows
        for nq in (1, 8, 64):
            q = torch.randn(nq, dim, generator=g).to(dev)
            for k in (1, 10, 100, 5000):
                k = min(k, n)
                got_d, got_i = D.knn_search(q, x, mask, "euclidean", k)
                torch.cuda.synchronize()
                want_d, want_i = D.knn_search_plain(q, x, mask, "euclidean", k)
                fin = torch.isfinite(want_d)
                err = float((got_d - want_d)[fin].abs().max()) if bool(fin.any()) else 0.0
                d_ok = bool(torch.allclose(got_d, want_d, **TOL)) and got_i.dtype == torch.int32
                id_ok = ids_match_up_to_ties(
                    got_d.cpu().numpy(), got_i.cpu().numpy(),
                    want_d.cpu().numpy(), want_i.cpu().numpy(),
                )
                emit("k2_check", q=nq, n=n, d=dim, k=k, max_abs_err=err,
                     ids_equal=bool(torch.equal(got_i, want_i)), ids_ok=id_ok, ok=d_ok)
                require(d_ok and id_ok, f"K2 Q={nq} N={n} k={k} disagrees with its plain version")
                k2_err = max(k2_err, err)
    # tie order: a corpus of identical rows makes every distance tie, and
    # the dead rows come back as +inf, in index order — once with k = N
    # (one block a query) and once over a corpus the select splits in chunks
    for n, k in ((3000, 3000), (200_000, 100)):
        x = torch.zeros(n, 8, device=dev)
        q = torch.zeros(2, 8, device=dev)
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        mask[::7] = False
        got = D.knn_search(q, x, mask, "euclidean", k)
        want = D.knn_search_plain(q, x, mask, "euclidean", k)
        exact = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        emit("k2_ties", n=n, k=k, exact=exact)
        require(exact, f"K2 tie order / masked rows differ from the plain version (N={n}, k={k})")
    return k1_err, k2_err


def phase_timing(torch, dim: int, n: int, k: int):
    """Times at the main path's launch shapes: Q in {1, 8, 64} queries (the
    dispatch tiles) against a bf16 corpus of N rows (the mirror's upload
    type on CUDA)."""
    from surrealdb_tpu_torch.ops import distances as D

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(n, dim, generator=g).to(dev).to(torch.bfloat16)
    xf = x.float()  # the yardstick's input: cdist takes one dtype
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    out = {}
    for nq in (1, 8, 64):
        q = torch.randn(nq, dim, generator=g).to(dev)
        in_bytes = nq * dim * 4 + n * dim * 2
        flops = 2.0 * nq * n * dim
        k1_bound, k1_by = bound_ms(in_bytes + nq * n * 4, flops, "bfloat16")
        k2_bound, k2_by = bound_ms(in_bytes + n + nq * k * 8, flops, "bfloat16")
        out[nq] = {
            "knn_pairwise": dict(
                ms=median_ms(lambda: D.pairwise_distance(q, x, "euclidean")),
                plain_ms=median_ms(lambda: D.pairwise_distance_plain(q, x, "euclidean"), iters=5),
                library_ms=median_ms(lambda: torch.cdist(q, xf)),
                bound_ms=k1_bound, bound_by=k1_by,
            ),
            "knn_select": dict(
                ms=median_ms(lambda: D.knn_search(q, x, mask, "euclidean", k)),
                plain_ms=median_ms(lambda: D.knn_search_plain(q, x, mask, "euclidean", k), iters=5),
                library_ms=median_ms(lambda: torch.topk(torch.cdist(q, xf), k, largest=False)),
                bound_ms=k2_bound, bound_by=k2_by,
            ),
        }
        emit("timing", q=nq, n=n, d=dim, k=k, corpus="bfloat16", **out[nq])
    del x, xf
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 3
def phase_main_path(torch, device: str, n_rows: int, dim: int, batch: int,
                    n_seq: int, n_threads: int, rounds: int, seed: int = 42):
    from surrealdb_tpu_torch import bg, telemetry
    from surrealdb_tpu_torch.kvs.ds import Datastore
    from surrealdb_tpu_torch.ops import distances as D
    from surrealdb_tpu_torch.utils.num import dispatch_tile, tile_slices

    k = 10
    t0 = time.perf_counter()
    corpus = gen_corpus(n_rows, dim, seed=seed)
    gen_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 1)
    n_conc = n_threads * rounds
    qidx = rng.integers(0, n_rows, size=n_seq + n_conc)
    queries = corpus[qidx] + rng.standard_normal((qidx.size, dim)).astype(np.float32) * 0.05

    ds = Datastore("memory", device=device)
    try:
        def run(sql, vars=None):
            res = ds.execute(sql, vars=vars or {})
            for r in res:
                require(r.get("status") == "OK", f"{sql[:60]!r} failed: {r}")
            return res[-1]["result"]

        run("DEFINE TABLE item SCHEMALESS; "
            f"DEFINE INDEX iemb ON item FIELDS emb MTREE DIMENSION {dim} DIST EUCLIDEAN")
        ingest_s = 0.0
        for i in range(0, n_rows, batch):
            rows = [{"id": j, "emb": corpus[j]} for j in range(i, min(i + batch, n_rows))]
            t = time.perf_counter()
            run("INSERT INTO item $rows RETURN NONE", {"rows": rows})
            ingest_s += time.perf_counter() - t
            if i == 0:
                # build the mirror from the first batch, so the rest of the
                # ingest reaches it as deltas (no 1M-row rescan later)
                run(f"SELECT id FROM item WHERE emb <|{k}|> $q", {"q": corpus[0].tolist()})
        sql = f"SELECT id FROM item WHERE emb <|{k}|> $q"

        def strategies():
            return {
                lab: v for lab, v in telemetry.snapshot()["counters"].items()
                if lab.startswith("knn_strategy")
            }

        # the first query after ingest uploads the mirror to the device
        t = time.perf_counter()
        run(sql, {"q": queries[0].tolist()})
        upload_query_s = time.perf_counter() - t
        # that query's background warmers launch every other tile shape of
        # this matrix once; let them finish before the counts start
        require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = strategies()
        widths0 = ds.dispatch.width_distribution()
        for c in D.KERNELS:
            c.reset()

        results = [None] * qidx.size
        seq_lat = []
        spans0 = telemetry.snapshot()["histograms"]
        for i in range(n_seq):
            t = time.perf_counter()
            results[i] = run(sql, {"q": queries[i].tolist()})
            seq_lat.append(time.perf_counter() - t)
        layers = layer_means_ms(spans0, telemetry.snapshot()["histograms"])
        conc_lat = []
        lat_lock = threading.Lock()
        errors = []

        def client(ti):
            try:
                for r in range(rounds):
                    qi = n_seq + r * n_threads + ti
                    t1 = time.perf_counter()
                    res = run(sql, {"q": queries[qi].tolist()})
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
        # the background tile warmers launch too: wait for them to finish
        # before the counts are read
        require(bg.wait_idle(timeout=120, owner=id(ds)), "background tasks did not finish")
        if device == "cuda":
            torch.cuda.synchronize()
        launches = {c.name: c.launches for c in D.KERNELS}
        after = strategies()
        widths1 = ds.dispatch.width_distribution()
        widths = {w: c - widths0.get(w, 0) for w, c in widths1.items() if c - widths0.get(w, 0)}
        tiles = sum(
            c * len(list(tile_slices(w, dispatch_tile(w)))) for w, c in widths.items()
        )
        delta = {lab: v - before.get(lab, 0) for lab, v in after.items() if v - before.get(lab, 0)}
        n_queries = qidx.size
        require(
            delta == {'knn_strategy{strategy="exact-device"}': float(n_queries)},
            f"strategies {delta}, expected {n_queries} exact-device",
        )
        if device == "cuda":
            # every dispatched tile is one knn_search call: one K1 launch and
            # one selection (every tile shape was warmed before the counts)
            require(
                launches == {"knn_pairwise": tiles, "knn_select": tiles},
                f"launches {launches} for {tiles} dispatched tiles",
            )
        truth = knn_ground_truth(corpus, queries, k)
        recalls = []
        for i, res in enumerate(results):
            require(res is not None and len(res) == k, f"query {i} returned {res!r}")
            got = {int(r["id"].id) for r in res}
            recalls.append(len(got & set(truth[i].tolist())) / k)
        recall = float(np.mean(recalls))
        require(recall >= 0.99, f"recall@{k} {recall} < 0.99")
        busy = device_busy_share(torch, lambda: [
            run(sql, {"q": queries[i].tolist()}) for i in range(8)
        ]) if device == "cuda" else None
        out = dict(
            rows=n_rows, dim=dim, device=str(ds.device), corpus_gen_s=gen_s,
            ingest_rows_per_s=n_rows / ingest_s, ingest_s=ingest_s,
            first_query_with_upload_s=upload_query_s,
            seq_queries=n_seq, seq_p50_ms=statistics.median(seq_lat) * 1e3,
            seq_qps=n_seq / sum(seq_lat),
            seq_layer_mean_ms=layers,
            concurrent_clients=n_threads, rounds=rounds,
            conc_p50_ms=statistics.median(conc_lat) * 1e3,
            conc_qps=n_conc / conc_wall,
            dispatch_widths={str(w): c for w, c in sorted(widths.items())},
            tiles_dispatched=tiles, launches=launches,
            strategies=delta, recall_at_10=recall, profiled_8_seq_queries=busy,
            peak_device_memory_bytes=(
                torch.cuda.max_memory_allocated() if device == "cuda" else None
            ),
        )
        emit("main_path", **out)
        return out
    finally:
        ds.close()


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the main path tiny on the CPU (plain versions); exits 1")
    args = ap.parse_args(argv)

    import torch

    if args.cpu_rehearsal:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from surrealdb_tpu_torch import cnf

        cnf.TPU_KNN_ONDEVICE_THRESHOLD = 16
        phase_main_path(torch, "cpu", n_rows=4096, dim=32, batch=1000,
                        n_seq=4, n_threads=8, rounds=2)
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
    t_all = time.perf_counter()
    try:
        smi = phase_environment(torch)
        k1_err, k2_err = phase_kernels(torch, DIM, min(args.rows, 1 << 20))
        timing = phase_timing(torch, DIM, args.rows, 10)
        main = phase_main_path(torch, "cuda", n_rows=args.rows, dim=DIM,
                               batch=20_000, n_seq=24, n_threads=32, rounds=2)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # one entry a kernel, timed at Q=1, the tile most of the main path's
    # launches use; the other tiles' times ride along under "by_q"
    kernels = []
    for name, kern, replaces, err in (
        ("K1 pairwise_distance (knn_pairwise)", "knn_pairwise",
         "surrealdb_tpu/ops/distances.py:41", k1_err),
        ("K2 knn_search (knn_pairwise + knn_select)", "knn_select",
         "surrealdb_tpu/ops/distances.py:87", k2_err),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": "surrealdb_tpu_torch/csrc/knn.cu",
            "replaces": replaces, "launches": main["launches"][kern], "max_abs_err": err,
            **timing[1][kern],
            "shape": {"q": 1, "n": args.rows, "d": DIM, "k": 10, "corpus": "bfloat16"},
            "by_q": {str(nq): timing[nq][kern] for nq in (8, 64)},
        })
    emit("done", seconds=time.perf_counter() - t_all)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
