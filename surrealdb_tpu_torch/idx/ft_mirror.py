"""Device-resident full-text mirror: CSR postings + batched BM25 search.

Mirrors surrealdb_tpu/idx/ft_mirror.py. The host half (the build scan, the
per-document and bulk deltas, the compaction into CSR arrays, term_stats)
is the reference's, copied as it is. `search` keeps the reference's rule
(score on the device from cnf.TPU_FT_ONDEVICE_THRESHOLD candidates, else
the numpy twin) around the port's K9 match (ops/bm25.py
`bm25_match_scores`, csrc/bm25.cu): the AND-match and the scores in one
launch over postings that live on the Datastore's device, which
`ensure_built` records; `device_postings` uploads them once a compaction
generation.

Role of the reference's per-query posting B-tree walks (reference:
core/src/idx/ft/postings.rs, termdocs.rs, scorer.rs:13-92): the inverted
index's postings are packed into CSR arrays (term → sorted doc ids + term
frequencies) kept in sync with committed writes, so a MATCHES query is
numpy slicing + searchsorted intersection + ONE batched BM25 kernel
instead of a per-posting KV scan-and-unpack loop.

The mirror's base state is the bulk ingest's packed chunks
(idx/ft_index.py P/L/R keys) loaded wholesale as numpy arrays — the build
never unpacks per-(term, doc) keys for bulk data. Single-document changes
land in small per-term overlay dicts (tf<=0 = tombstone) merged into the
CSR lazily, mirroring the KV layout's chunk+overlay split exactly.

The KV inverted index stays authoritative/durable; this is the compute
replica (reference analog: TreeCache generation swap,
trees/store/cache.rs — improved to incremental deltas).
"""

from __future__ import annotations

import bisect
import threading
from surrealdb_tpu_torch.utils import locks as _locks
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from surrealdb_tpu_torch import key as keys
from surrealdb_tpu_torch.key.encode import dec_u64, prefix_end
from surrealdb_tpu_torch.sql.value import Thing
from surrealdb_tpu_torch.utils.ser import unpack
from surrealdb_tpu_torch.idx.ft_index import (
    rid_chunk_get,
    unpack_lens,
    unpack_plist,
    unpack_posting,
)


class FtMirror:
    """One search index's postings: packed base chunks + overlay dicts,
    lazily compacted into CSR arrays (pattern of idx/graph_csr.py)."""

    def __init__(self):
        self.built = False
        self.term_ids: Dict[str, int] = {}  # term -> local tid
        # base postings: per tid, list of (dids asc, tfs) chunk arrays in
        # ascending did order (chunk starts are allocated monotonically)
        self.chunks: List[List[Tuple[np.ndarray, np.ndarray]]] = []
        self.overlay: List[Dict[int, float]] = []  # per tid; tf<=0 tombstone
        # doc lengths: [(start, lens f32)] + overlay {did: len} (0 = absent)
        self.len_chunks: List[Tuple[int, np.ndarray]] = []
        self.len_overlay: Dict[int, float] = {}
        # did -> rid: [(start, rid list)] + overlay {did: rid | None}
        self.rid_chunks: List[Tuple[int, list]] = []
        self.rid_overlay: Dict[int, Optional[Thing]] = {}
        self._chunk_starts: set = set()  # bulk idempotence guard
        self.next_did = 0
        self.dc = 0
        self.tl = 0.0
        self.dirty = True
        # compacted arrays
        self.t_indptr: Optional[np.ndarray] = None
        self.t_dids: Optional[np.ndarray] = None
        self.t_tfs: Optional[np.ndarray] = None
        self.doclen_arr: Optional[np.ndarray] = None
        self._pending: Optional[List[tuple]] = None
        # filtered-stats cache (replicated clusters): the responsibility
        # mask depends only on (compacted-array generation, liveness view),
        # so one O(corpus) rid/ring walk serves every BM25 query until a
        # mutation recompacts the arrays or the live set changes
        self._stats_gen = 0
        self._stats_mask: Optional[Tuple[tuple, np.ndarray]] = None
        self._lock = _locks.RLock("idx.ft.state")
        self._build_lock = _locks.Lock("idx.ft.build")
        self.device = None  # the Datastore's torch device, set by ensure_built
        # (generation, device, ops.bm25.Postings): the postings on the card
        self._dev: Optional[tuple] = None

    # ------------------------------------------------------------ build
    def ensure_built(self, ctx, ix: dict) -> None:
        """One scan over the index's KV state builds the mirror. Runs on a
        fresh snapshot opened after delta buffering starts (same protocol as
        idx/knn.py VectorMirror.ensure_built). Records the Datastore's
        device, where search scores."""
        self.device = ctx.ds().device
        if self.built:
            return
        with self._build_lock:
            if self.built:
                return
            with self._lock:
                self._pending = []
            ns, db = ctx.ns_db()
            tb, name = ix["table"], ix["name"]
            txn = ctx.ds().transaction(False)
            try:
                base = keys.index_state(ns, db, tb, name, b"")
                st_raw = txn.get(base + b"s")
                st = unpack(st_raw) if st_raw else {"dc": 0, "tl": 0, "nt": 0, "nd": 0}
                kv_tid_local: Dict[int, int] = {}
                term_ids: Dict[str, int] = {}
                # terms: t{term} -> {id, df}
                pre = base + b"t"
                for chunk in txn.batch(pre, prefix_end(pre), 4096):
                    for k, v in chunk:
                        meta = unpack(v)
                        if meta.get("df", 0) <= 0:
                            continue
                        term = self._dec_term(k, len(pre))
                        local = len(term_ids)
                        term_ids[term] = local
                        kv_tid_local[meta["id"]] = local
                chunks: List[List[Tuple[np.ndarray, np.ndarray]]] = [
                    [] for _ in range(len(term_ids))
                ]
                overlay: List[Dict[int, float]] = [{} for _ in range(len(term_ids))]
                # packed posting chunks: P{tid}{start}
                chunk_starts: set = set()
                pre = base + b"P"
                for batch in txn.batch(pre, prefix_end(pre), 1024):
                    for k, v in batch:
                        tid, off = dec_u64(k, len(pre))
                        start, _ = dec_u64(k, off)
                        local = kv_tid_local.get(tid)
                        if local is not None:
                            chunks[local].append(unpack_plist(v))
                        chunk_starts.add(start)
                # posting overlay: p{tid}{did}
                pre = base + b"p"
                for batch in txn.batch(pre, prefix_end(pre), 8192):
                    for k, v in batch:
                        tid, off = dec_u64(k, len(pre))
                        did, _ = dec_u64(k, off)
                        local = kv_tid_local.get(tid)
                        if local is not None:
                            overlay[local][did] = float(unpack_posting(v)["tf"])
                # doc lengths
                len_chunks: List[Tuple[int, np.ndarray]] = []
                pre = base + b"L"
                for batch in txn.batch(pre, prefix_end(pre), 1024):
                    for k, v in batch:
                        start, _ = dec_u64(k, len(pre))
                        len_chunks.append((start, unpack_lens(v)))
                len_overlay: Dict[int, float] = {}
                pre = base + b"l"
                for batch in txn.batch(pre, prefix_end(pre), 8192):
                    for k, v in batch:
                        did, _ = dec_u64(k, len(pre))
                        len_overlay[did] = float(unpack(v))
                # rid maps
                # rid chunks stay raw bytes until a result lands in them
                # (rid_for decodes on demand — searches touch few chunks)
                rid_chunks: List[Tuple[int, Any]] = []
                pre = base + b"R"
                for batch in txn.batch(pre, prefix_end(pre), 256):
                    for k, v in batch:
                        start, _ = dec_u64(k, len(pre))
                        rid_chunks.append((start, v))
                rid_overlay: Dict[int, Optional[Thing]] = {}
                pre = base + b"r"
                for batch in txn.batch(pre, prefix_end(pre), 8192):
                    for k, v in batch:
                        did, _ = dec_u64(k, len(pre))
                        rid_overlay[did] = unpack(v)
            finally:
                txn.cancel()
            len_chunks.sort(key=lambda c: c[0])
            rid_chunks.sort(key=lambda c: c[0])
            with self._lock:
                self.term_ids = term_ids
                self.chunks = chunks
                self.overlay = overlay
                self.len_chunks = len_chunks
                self.len_overlay = len_overlay
                self.rid_chunks = rid_chunks
                self.rid_overlay = rid_overlay
                self._chunk_starts = chunk_starts | {s for s, _ in len_chunks}
                self.next_did = st["nd"]
                self.dc = st["dc"]
                self.tl = float(st["tl"])
                self.dirty = True
                self.built = True
                pending, self._pending = self._pending, None
                for tag, args in pending:
                    if tag == "doc":
                        self.apply_ft(*args)
                    else:
                        self.apply_ft_bulk(*args)

    @staticmethod
    def _dec_term(k: bytes, off: int) -> str:
        from surrealdb_tpu_torch.key.encode import dec_str

        return dec_str(k, off)[0]

    # ------------------------------------------------------------ deltas
    def _tid_for(self, term: str) -> int:
        tid = self.term_ids.get(term)
        if tid is None:
            tid = len(self.term_ids)
            self.term_ids[term] = tid
            self.chunks.append([])
            self.overlay.append({})
        return tid

    def _len_of(self, did: int) -> Optional[float]:
        """Current doc length, or None when the doc is not indexed. The
        overlay stores -1.0 as its removal tombstone so a present zero-token
        doc (length 0) stays distinguishable from an absent one — dc/tl
        accounting depends on that distinction."""
        v = self.len_overlay.get(did)
        if v is not None:
            return None if v < 0 else v
        i = bisect.bisect_right(self.len_chunks, did, key=lambda c: c[0]) - 1
        if i >= 0:
            start, lens = self.len_chunks[i]
            off = did - start
            if 0 <= off < len(lens):
                return float(lens[off])
        return None

    def apply_ft(
        self,
        rid,
        did: int,
        old_tf: Optional[Dict[str, int]],
        new_tf: Optional[Dict[str, int]],
        new_len: int,
    ) -> None:
        """One committed document change. old/new term-frequency maps follow
        idx/ft_index.py index_document's diff semantics; None = absent."""
        with self._lock:
            if self._pending is not None:
                self._pending.append(("doc", (rid, did, old_tf, new_tf, new_len)))
                return
            if not self.built:
                return
            if old_tf is not None:
                for term in old_tf:
                    tid = self.term_ids.get(term)
                    if tid is not None:
                        self.overlay[tid][did] = 0.0
                prev = self._len_of(did)
                if prev is not None:
                    self.tl -= prev
                    self.dc -= 1
                self.len_overlay[did] = -1.0
            if new_tf is not None:
                # idempotence (the build-window replay protocol relies on
                # it): a delta whose doc the build scan already loaded must
                # not double-count dc/tl
                prev = self._len_of(did)
                if prev is not None:
                    self.tl -= prev
                    self.dc -= 1
                for term, tf in new_tf.items():
                    self.overlay[self._tid_for(term)][did] = float(tf)
                self.len_overlay[did] = float(new_len)
                self.rid_overlay[did] = rid
                self.dc += 1
                self.tl += new_len
                if did >= self.next_did:
                    self.next_did = did + 1
            elif old_tf is not None:
                self.rid_overlay[did] = None
            self.dirty = True

    def apply_ft_bulk(self, start: int, terms: Dict[str, tuple], lens, rids) -> None:
        """One committed bulk batch: append its packed arrays as new base
        chunks (no per-doc work)."""
        with self._lock:
            if self._pending is not None:
                self._pending.append(("bulk", (start, terms, lens, rids)))
                return
            if not self.built:
                return
            if start in self._chunk_starts:
                return  # the build scan already loaded this batch
            self._chunk_starts.add(start)
            for term, (dids, tfs) in terms.items():
                self.chunks[self._tid_for(term)].append(
                    (np.asarray(dids), np.asarray(tfs, dtype=np.float32))
                )
            lens = np.asarray(lens, dtype=np.float32)
            self.len_chunks.append((start, lens))
            self.rid_chunks.append((start, list(rids)))
            self.dc += len(lens)
            self.tl += float(lens.sum())
            if start + len(lens) > self.next_did:
                self.next_did = start + len(lens)
            self.dirty = True

    # ------------------------------------------------------------ rid map
    def rid_for(self, did: int) -> Optional[Thing]:
        with self._lock:
            if did in self.rid_overlay:
                return self.rid_overlay[did]
            i = bisect.bisect_right(self.rid_chunks, did, key=lambda c: c[0]) - 1
            if i >= 0:
                start, rids = self.rid_chunks[i]
                if isinstance(rids, bytes):
                    rids = unpack(rids)  # columnar dict or generic list
                    self.rid_chunks[i] = (start, rids)
                return rid_chunk_get(rids, did - start)
            return None

    # ------------------------------------------------------------ arrays
    def _ensure_arrays(self) -> None:
        if not self.dirty and self.t_indptr is not None:
            return
        T = len(self.term_ids)
        rows: List[Tuple[np.ndarray, np.ndarray]] = []
        for tid in range(T):
            parts = self.chunks[tid]
            ov = self.overlay[tid]
            if parts and not ov:
                if len(parts) == 1:
                    rows.append(parts[0])
                else:
                    d = np.concatenate([p[0] for p in parts])
                    f = np.concatenate([p[1] for p in parts])
                    rows.append((d, f))
                    self.chunks[tid] = [rows[-1]]  # keep the compaction
                continue
            if parts:
                d = np.concatenate([p[0] for p in parts])
                f = np.concatenate([p[1] for p in parts])
            else:
                d = np.empty(0, np.int64)
                f = np.empty(0, np.float32)
            if ov:
                ov_d = np.fromiter(ov.keys(), np.int64, count=len(ov))
                ov_t = np.fromiter(ov.values(), np.float32, count=len(ov))
                if d.size:
                    keep = ~np.isin(d, ov_d)
                    d, f = d[keep], f[keep]
                live = ov_t > 0
                d = np.concatenate([d, ov_d[live]])
                f = np.concatenate([f, ov_t[live]])
                order = np.argsort(d, kind="stable")
                d, f = d[order], f[order]
            rows.append((d, f))
        counts = np.fromiter((len(r[0]) for r in rows), dtype=np.int64, count=T)
        indptr = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        nnz = int(indptr[-1])
        dids = np.empty(nnz, dtype=np.int64)
        tfs = np.empty(nnz, dtype=np.float32)
        for tid, (d, f) in enumerate(rows):
            s, e = indptr[tid], indptr[tid + 1]
            dids[s:e] = d
            tfs[s:e] = f
        cap = max(self.next_did, 1)
        dl = np.zeros(cap, dtype=np.float32)
        for start, lens in self.len_chunks:
            dl[start : start + len(lens)] = lens
        if self.len_overlay:
            idx = np.fromiter(self.len_overlay.keys(), np.int64, count=len(self.len_overlay))
            val = np.fromiter(self.len_overlay.values(), np.float32, count=len(self.len_overlay))
            ok = idx < cap
            dl[idx[ok]] = np.maximum(val[ok], 0.0)  # -1 tombstone scores as 0
        self.t_indptr, self.t_dids, self.t_tfs, self.doclen_arr = indptr, dids, tfs, dl
        self.dirty = False
        self._stats_gen += 1  # responsibility masks over old arrays are stale

    # ------------------------------------------------------------ search
    def term_stats(self, terms: List[str], doc_ok=None, filter_key=None):
        """Local corpus statistics for a term set: (doc count, total doc
        length, {term: document frequency}) — phase one of the cluster's
        two-phase BM25 (cluster/rpc.py ft_stats). Unknown terms report 0.

        `doc_ok(rid) -> bool` restricts the stats to a responsibility
        subset (replicated clusters: each node reports only the docs it is
        the first live replica of, so a doc counts once globally); pass a
        hashable `filter_key` describing what doc_ok depends on (live-node
        set + rf) and the O(corpus) mask is cached until the arrays
        recompact or the key changes. The filtered path counts live docs
        from the length array, so a zero-length doc is excluded — empty
        bodies carry no BM25 mass."""
        with self._lock:
            self._ensure_arrays()
            if doc_ok is None:
                df: Dict[str, int] = {}
                for t in dict.fromkeys(terms):
                    tid = self.term_ids.get(t)
                    df[t] = (
                        int(self.t_indptr[tid + 1] - self.t_indptr[tid])
                        if tid is not None
                        else 0
                    )
                return int(self.dc), float(self.tl), df
            cache_key = (
                (self._stats_gen, filter_key) if filter_key is not None else None
            )
            if self._stats_mask is not None and self._stats_mask[0] == cache_key:
                mask = self._stats_mask[1]
            else:
                cap = len(self.doclen_arr)
                mask = np.zeros(cap, dtype=bool)
                for did in np.nonzero(self.doclen_arr > 0)[0]:
                    rid = self.rid_for(int(did))
                    if rid is not None and doc_ok(rid):
                        mask[did] = True
                if cache_key is not None:
                    self._stats_mask = (cache_key, mask)
            df = {}
            for t in dict.fromkeys(terms):
                tid = self.term_ids.get(t)
                if tid is None:
                    df[t] = 0
                    continue
                s, e = int(self.t_indptr[tid]), int(self.t_indptr[tid + 1])
                df[t] = int(np.count_nonzero(mask[self.t_dids[s:e]]))
            return (
                int(np.count_nonzero(mask)),
                float(self.doclen_arr[mask].sum()),
                df,
            )

    def device_postings(self, device):
        """This compaction generation's postings on `device` (ops/bm25.py
        Postings: int32 dids, f32 tf and lengths, one pinned copy), uploaded
        at the first call after a compaction; the previous generation's are
        dropped first. A did of 2^31 or more raises."""
        from surrealdb_tpu_torch.ops.bm25 import upload_postings

        with self._lock:
            self._ensure_arrays()
            got = self._dev
            if got is not None and got[0] == self._stats_gen and got[1] == device:
                return got[2]
            self._dev = None
            if self.next_did >= 2 ** 31:
                raise ValueError(f"full-text document ids reach {self.next_did}: the card's "
                                 "postings take int32 ids below 2^31")
            post = upload_postings(self.t_indptr, self.t_dids, self.t_tfs, self.doclen_arr,
                                   device)
            self._dev = (self._stats_gen, device, post)
            return post

    @staticmethod
    def _and_match(arrays, tids):
        """The reference's rarest-first intersection over one generation's
        host arrays -> (dids, tf [N, T], lengths); empty dids when none."""
        indptr, all_dids, all_tfs, doclen = arrays
        rows = [(all_dids[indptr[t]:indptr[t + 1]], all_tfs[indptr[t]:indptr[t + 1]])
                for t in tids]
        cand = rows[0][0]
        tf_cols = [rows[0][1]]
        for dids, tfs in rows[1:]:
            pos = np.searchsorted(dids, cand)
            pos_c = np.clip(pos, 0, len(dids) - 1)
            mask = dids[pos_c] == cand
            cand = cand[mask]
            tf_cols = [c[mask] for c in tf_cols]
            tf_cols.append(tfs[pos_c[mask]])
            if cand.size == 0:
                return cand, None, None
        return cand, np.stack(tf_cols, axis=1), doclen[cand]

    def search(self, terms: List[str], k1: float, b: float, stats_override=None):
        """AND-match the analyzed query terms; returns (dids, scores) —
        empty arrays when any term is unknown. `stats_override`
        ({dc, tl, df: {term: n}}) swaps the corpus statistics BM25 scores
        with — the cluster executor passes the merged GLOBAL stats so every
        shard scores exactly as one single-node corpus would.

        The reference's rule decides where a query scores: on the device
        from cnf.TPU_FT_ONDEVICE_THRESHOLD candidates, else on the numpy
        twin. Here the device branch is K9's match, which counts the
        candidates itself: a rarest list shorter than the threshold cannot
        reach it and takes the host path (the reference's intersection, then
        the twin) at once; otherwise `bm25_match_scores` runs on this
        generation's device postings, and if its count stays below the
        threshold the query takes the host path all the same and answers
        with the twin's scores. So every query gets the bits the reference's
        rule gives it. TPU_DISABLE takes the host path; a CPU Datastore's
        device branch is the plain version."""
        from surrealdb_tpu_torch import cnf, compile_log
        from surrealdb_tpu_torch.ops.bm25 import bm25_match_scores, bm25_scores_host

        with self._lock:
            self._ensure_arrays()
            uniq = list(dict.fromkeys(terms))
            if not uniq:
                return np.empty(0, np.int64), np.empty(0, np.float32)
            tids = []
            term_of: Dict[int, str] = {}
            for t in uniq:
                tid = self.term_ids.get(t)
                if tid is None or self.t_indptr[tid + 1] == self.t_indptr[tid]:
                    return np.empty(0, np.int64), np.empty(0, np.float32)
                tids.append(tid)
                term_of[tid] = t
            # rarest first, ties in query order (a stable sort)
            tids.sort(key=lambda tid: self.t_indptr[tid + 1] - self.t_indptr[tid])
            df = np.array(
                [self.t_indptr[t + 1] - self.t_indptr[t] for t in tids],
                dtype=np.float32,
            )
            dc, tl = self.dc, self.tl
            if isinstance(stats_override, dict):
                odf = stats_override.get("df") or {}
                df = np.array(
                    [float(odf.get(term_of[t], df[i])) for i, t in enumerate(tids)],
                    dtype=np.float32,
                )
                dc = float(stats_override.get("dc", dc))
                tl = float(stats_override.get("tl", tl))
            threshold = cnf.TPU_FT_ONDEVICE_THRESHOLD
            n0 = int(self.t_indptr[tids[0] + 1] - self.t_indptr[tids[0]])
            on_device = not cnf.TPU_DISABLE and n0 >= threshold
            if on_device:
                if self.device is None:
                    raise RuntimeError("no device recorded for this full-text index")
                post = self.device_postings(self.device)
            arrays = (self.t_indptr, self.t_dids, self.t_tfs, self.doclen_arr)
        if on_device:
            # K9 on the Datastore's device (compile_log subsystem `bm25_match`)
            with compile_log.tracked("bm25_match", (len(tids),)):
                cand, scores = bm25_match_scores(post, tids, df, np.float32(dc),
                                                 np.float32(tl), k1, b)
            if len(cand) >= threshold:
                return cand, scores
        # the host path: fewer candidates than the threshold
        cand, tf_mat, lens = self._and_match(arrays, tids)
        if cand.size == 0:
            return cand, np.empty(0, np.float32)
        return cand, bm25_scores_host(tf_mat, df, lens, dc, tl, k1, b)

    def count(self) -> int:
        with self._lock:
            return self.dc
