#!/usr/bin/env python3
"""The BM25 engine path and K6 on one CUDA card, for the checkout given by
--root (default: the one holding this script), so a parent and a change
compare inside one call.

    python3 scripts/bm25_k6_timing.py                    # this tree
    python3 scripts/bm25_k6_timing.py --root DIR --label parent --out F.json

BM25: bench config 3 (1,000,000 documents of 12 zipf-drawn words, bulk
INSERT as chip_smoke.py ingests it) through Datastore.execute at
cnf.TPU_FT_ONDEVICE_THRESHOLD = 1, bench_bm25's first 24 queries. First the
sequential p50 as users run it, then each query again with its device
branch split into parts by wrapping the tree's own functions (each part
ends in a device synchronisation, so the split runs a little slower than
the plain pass):
- a tree whose mirror search scores through score_candidates (the dense
  design): the host AND-match (search less score_candidates), the three
  uploads (score_candidates up to its bm25_scores call), the launch
  (bm25_scores to a synchronisation), the download (the rest of
  score_candidates);
- a tree with bm25_match_scores: the device postings' lookup, the match's
  one call (launch and download), the launch alone (the kernel without the
  download, timed on its own after the query) and the host rest of search;
- both: the rest of the query outside FtMirror.search (MatchesPlan, the
  ordering, the statement), and the sequential p50 at the default
  threshold.
K6: the friends-of-friends expand's device hop at chip_smoke.py's shape
(config 1's graph, the records three host hops reach), by events and
queued. The tree's own chip_smoke.py supplies the data and the timers. One
JSON line a measurement on stdout (and, with --out, all of them in that
JSON file).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Spans:
    """Wall-clock seconds spent inside wrapped functions, a list a name."""

    def __init__(self):
        self.t = {}

    def wrap(self, owner, name, key=None, sync=False):
        import torch

        fn = getattr(owner, name)
        key = key or name

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if sync:
                    torch.cuda.synchronize()
                self.t.setdefault(key, []).append(time.perf_counter() - t0)

        setattr(owner, name, timed)
        return fn

    def take(self, key) -> float:
        v = self.t.pop(key, [])
        return sum(v) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose package is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--queries", type=int, default=24)
    ap.add_argument("--out", help="also write the measurements to this JSON file")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("bm25_k6_timing: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.idx import ft_mirror as FM
    from surrealdb_tpu_torch.idx import graph_csr as G
    from surrealdb_tpu_torch.kvs.ds import Datastore
    from surrealdb_tpu_torch.ops import _cuda
    from surrealdb_tpu_torch.ops import bm25 as B
    from surrealdb_tpu_torch.utils.num import next_pow2

    assert C.__file__.startswith(root), C.__file__
    out = []

    def emit(what, **kv):
        rec = {"what": what, "label": args.label, **kv}
        out.append(rec)
        print(json.dumps(rec), flush=True)

    smi = C.phase_environment(torch)
    dev = torch.device("cuda", 0)
    emit("environment", nvidia_smi=smi, root=root, build_seconds=_cuda.build_seconds)

    # ------------------------------------------------------------ K6
    pairs = C.graph_pairs(C.GRAPH_NODES, C.GRAPH_EDGES)
    arrs = C.graph_arrays(pairs, C.GRAPH_NODES)
    n_cap = arrs["n_cap"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    kp = (t(arrs["kp"][0]), t(arrs["kp"][1]))
    fsz = next_pow2(max(1, cnf.TPU_GRAPH_FRONTIER_PAD))
    fnodes, fcounts = C.fof_frontier(arrs, int(np.random.default_rng(5).integers(0, 10_000)))
    ffsz = next_pow2(max(fnodes.size, fsz))
    f1 = np.full(ffsz, n_cap, dtype=np.int32)
    f1[: fnodes.size] = fnodes
    c1 = np.zeros(ffsz, dtype=np.int32)
    c1[: fcounts.size] = fcounts
    f1, c1 = t(f1), t(c1)
    one = ((kp,),)
    k6 = lambda: G.chain_kernel(one, f1, c1, ((1,),), n_cap, (ffsz,), False)  # noqa: E731
    got, want = k6(), G.chain_plain(one, f1, c1, ((1,),), n_cap, (ffsz,), False)
    exact = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    enq = []
    for _ in range(40):
        t0 = time.perf_counter()
        k6()
        enq.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    emit("k6", exact=exact, ms=C.median_ms(k6, iters=30), queued_ms=C.queued_device_ms(torch, k6),
         enqueue_host_ms=statistics.median(enq[10:]), frontier=int(fnodes.size), fsz=ffsz,
         n_cap=n_cap, touched=int((got[1] > 0).sum()))
    del kp, f1, c1, got, want
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ BM25
    nq = args.queries
    qp = C.ft_query_pairs(nq)
    texts = [f"{C.ft_word(a)} {C.ft_word(b)}" for a, b in qp]
    saved = cnf.TPU_FT_ONDEVICE_THRESHOLD
    ds = Datastore("memory", device="cuda")
    try:
        run = C.sql_runner(ds)
        run(C.FT_SCHEMA)
        t0 = time.perf_counter()
        C.ft_ingest(run, C.FT_DOCS, C.FT_BATCH)
        ingest_s = time.perf_counter() - t0
        cnf.TPU_FT_ONDEVICE_THRESHOLD = 1
        t0 = time.perf_counter()
        run(C.FT_SQL.format(texts[0]))
        first_s = time.perf_counter() - t0

        def seq(passes=2):
            lat = []
            for _ in range(passes):
                for q in texts:
                    t0 = time.perf_counter()
                    run(C.FT_SQL.format(q))
                    lat.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(lat)

        p50_t1 = seq()
        match = getattr(B, "bm25_match_scores", None)
        sp = Spans()
        sp.wrap(FM.FtMirror, "search", "search")
        parts = []
        if match is None:  # the dense design: host AND-match, then score_candidates
            sp.wrap(B, "score_candidates", "score")
            inner = B.bm25_scores

            def launch(*a, **k):
                torch.cuda.synchronize()  # the uploads are done
                sp.t.setdefault("up_end", []).append(time.perf_counter())
                t0 = time.perf_counter()
                r = inner(*a, **k)
                torch.cuda.synchronize()
                sp.t.setdefault("launch", []).append(time.perf_counter() - t0)
                return r

            B.bm25_scores = launch
            orig_sc = B.score_candidates

            def score(*a, **k):
                sp.t.setdefault("score_start", []).append(time.perf_counter())
                return orig_sc(*a, **k)

            B.score_candidates = score
        else:
            sp.wrap(B, "bm25_match_scores", "match", sync=True)
            sp.wrap(FM.FtMirror, "device_postings", "postings")
        for q in texts:
            t0 = time.perf_counter()
            run(C.FT_SQL.format(q))
            total = (time.perf_counter() - t0) * 1e3
            row = {"query_ms": total, "search_ms": sp.take("search")}
            if match is None:
                score_ms = sp.take("score")
                up_end, start = sp.t.pop("up_end", []), sp.t.pop("score_start", [])
                up_ms = sum(e - s for e, s in zip(up_end, start)) * 1e3
                launch_ms = sp.take("launch")
                row.update(host_and_ms=row["search_ms"] - score_ms, uploads_ms=up_ms,
                           launch_ms=launch_ms, download_ms=score_ms - up_ms - launch_ms)
            else:
                row.update(match_call_ms=sp.take("match"), postings_lookup_ms=sp.take("postings"))
                row["search_host_ms"] = (row["search_ms"] - row["match_call_ms"]
                                         - row["postings_lookup_ms"])
            row["rest_of_query_ms"] = total - row["search_ms"]
            parts.append(row)
        split = {k: statistics.median(r[k] for r in parts) for k in parts[0]}
        if match is not None:  # the launch alone, without the download
            mirror = ds.index_stores.get("test", "test", "doc", "fbody")
            post = mirror._dev[2]
            sc, stream = B.match_scratch(dev), torch.cuda.current_stream(dev).cuda_stream
            lib = _cuda.lib()
            lat = []
            for a, b in qp:
                tids = [mirror.term_ids[C.ft_word(a)], mirror.term_ids[C.ft_word(b)]]
                tids = sorted(dict.fromkeys(tids), key=post.length)
                df = np.array([post.length(x) for x in tids], dtype=np.float32)
                for _ in range(3):
                    t0 = time.perf_counter()
                    B._launch_match(lib, post, tids, df, mirror.dc, mirror.tl, 1.2, 0.75, sc,
                                    stream, download=False)
                    torch.cuda.synchronize()
                    lat.append((time.perf_counter() - t0) * 1e3)
            split["launch_alone_ms"] = statistics.median(lat)
            split["download_ms"] = split["match_call_ms"] - split["launch_alone_ms"]
        cnf.TPU_FT_ONDEVICE_THRESHOLD = saved
        p50_default = seq()
        emit("bm25", ingest_s=ingest_s, first_query_s=first_s, seq_p50_ms_threshold1=p50_t1,
             seq_p50_ms_default=p50_default, default_threshold=saved,
             split_median_ms=split, design="match" if match is not None else "dense")
    finally:
        cnf.TPU_FT_ONDEVICE_THRESHOLD = saved
        ds.close()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
