"""Batched BM25 scoring (PyTorch; CUDA kernels on the card).

Mirrors surrealdb_tpu/ops/bm25.py. Its device program (K9) is hand-written
CUDA here (csrc/bm25.cu), in two entries that share one score function:

- `bm25_scores` (tf [N,T] f32 or int32, df [T] f32, doc_len [N] f32, the
  corpus's doc count and total length as f32 scalars -> [N] f32) launches
  `bm25_scores`: one thread a candidate row, the T idf values computed once
  a block in shared memory;
- `bm25_topk` is that kernel writing the negated scores, then K2's
  selection (`knn_select`, ops/distances.py) for the k smallest: lax.top_k's
  order (larger score first, lower index first on ties) with int32 indices;
- `bm25_match_scores` is the full-text mirror's AND-match and scoring in one
  launch over postings that live on the card (`Postings`, uploaded once a
  compaction generation by idx/ft_mirror.py FtMirror.device_postings): the
  query's terms rarest first in, the matched dids (the rarest list's order)
  and their scores out, with one download.

Each launch counter counts its kernel's launches (`bm25_scores` one per call
of either tf wrapper; bm25_topk's selection counts under `knn_select`).

Each wrapper takes tensors on one device. A CUDA tensor goes to the kernel
(or the wrapper raises); a CPU tensor goes to the plain PyTorch version
beside it (`bm25_scores_plain`, `bm25_topk_plain`,
`bm25_match_scores_plain`), which the tests hold against the reference and
chip_smoke.py holds the kernels against. `score_candidates` is the scoring
step of idx/ft_index.py's in-transaction search (and of the reference's
mirror search): the reference's numpy twin `bm25_scores_host`, copied as it
is, below cnf.TPU_FT_ONDEVICE_THRESHOLD candidates, else K9 on the
Datastore's device. idx/ft_mirror.py's search keeps the same threshold rule
around `bm25_match_scores` (its docstring says how).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from surrealdb_tpu_torch.ops.distances import LaunchCounter

SCORES = LaunchCounter("bm25_scores")
MATCH = LaunchCounter("bm25_match_scores")
KERNELS = (SCORES, MATCH)

# csrc/bm25.cu MS_MAX_T: terms a match launch takes by value; a longer query's
# go through MatchScratch.terms on the card
MATCH_BY_VALUE = 256
MATCH_FIRST = 4096  # matches that come down with the count in the first copy


def _f32(x) -> float:
    """A Python or numpy scalar rounded to f32, as the reference passes
    doc_count / total_len (np.float32(...))."""
    return float(np.float32(x))


# ------------------------------------------------------------ plain versions
def bm25_scores_plain(tf, df, doc_len, doc_count, total_len, k1: float = 1.2,
                      b: float = 0.75) -> torch.Tensor:
    """The reference's formula in plain PyTorch f32, in its order of
    operations: idf * (tf * (k1 + 1)) / (tf + k1 * norm), with
    norm = 1 - b + b * (len / avg_len); the row sum adds the T terms left
    to right, as the kernel does. -> [N] f32."""
    dev = tf.device

    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    n = torch.clamp(c(_f32(doc_count)), min=1.0)
    avg_len = torch.clamp(c(_f32(total_len)) / n, min=1e-6)
    dff = df.to(torch.float32)
    idf = torch.log1p((n - dff + 0.5) / (dff + 0.5))
    tff = tf.to(torch.float32)
    # 1 - b and k1 + 1 are taken in double, then rounded (JAX's weak types)
    norm = c(1.0 - b) + c(b) * (doc_len.to(torch.float32) / avg_len)
    s = idf[None, :] * (tff * c(k1 + 1.0)) / (tff + c(k1) * norm[:, None])
    acc = s[:, 0].clone()
    for j in range(1, s.shape[1]):
        acc = acc + s[:, j]
    return acc


def _descending_total_order(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """lax.top_k's pick: the k largest under f32's total order (+0 above
    -0), lower index first among equal values, int32 indices."""
    bits = s.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # signed ints in the floats' total order
    idx = torch.sort(key, descending=True, stable=True).indices[:k]
    return s[idx], idx.to(torch.int32)


def bm25_topk_plain(tf, df, doc_len, doc_count, total_len, k: int, k1: float = 1.2,
                    b: float = 0.75) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain bm25_topk: the scores, then the k largest -> ([k] f32, [k] int32)."""
    _check_k(k, tf.shape[0])
    return _descending_total_order(bm25_scores_plain(tf, df, doc_len, doc_count,
                                                     total_len, k1, b), k)


# ------------------------------------------------------------ CUDA kernel
def _check_k(k: int, n: int) -> None:
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside 1..{n}")


def _check_inputs(tf, df, doc_len) -> None:
    dev = tf.device
    if dev.type != "cuda" or df.device != dev or doc_len.device != dev:
        raise ValueError(
            f"tf, df and doc_len must lie on one CUDA device (got {tf.device}, "
            f"{df.device}, {doc_len.device})"
        )
    if tf.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"tf must be float32 or int32, got {tf.dtype}")
    if df.dtype != torch.float32 or doc_len.dtype != torch.float32:
        raise TypeError(f"df and doc_len must be float32, got {df.dtype}, {doc_len.dtype}")
    if tf.dim() != 2 or tf.shape[1] == 0 or df.shape != (tf.shape[1],) \
            or doc_len.shape != (tf.shape[0],):
        raise ValueError(
            f"shapes {tuple(tf.shape)}, {tuple(df.shape)}, {tuple(doc_len.shape)} "
            "are not [N,T>=1], [T], [N]"
        )
    if not (tf.is_contiguous() and df.is_contiguous() and doc_len.is_contiguous()):
        raise ValueError("tf, df and doc_len must be contiguous")


def _launch_scores(lib, tf, df, doc_len, doc_count, total_len, k1, b, negate, out, stream):
    """One launch of csrc/bm25.cu's bm25_scores into out [N] f32 (the
    negated scores when `negate`); returns its status. `lib` is the built
    library (or the CPU emulation's, in the tests)."""
    n, t = tf.shape
    return lib.bm25_scores(
        tf.data_ptr(), int(tf.dtype == torch.int32), df.data_ptr(), doc_len.data_ptr(),
        n, t, _f32(doc_count), _f32(total_len), _f32(k1), _f32(b),
        _f32(k1 + 1.0), _f32(1.0 - b), int(negate), out.data_ptr(), stream,
    )


def _scores_cuda(tf, df, doc_len, doc_count, total_len, k1, b, negate) -> torch.Tensor:
    from surrealdb_tpu_torch.ops import _cuda

    out = torch.empty(tf.shape[0], dtype=torch.float32, device=tf.device)
    if tf.shape[0] == 0:
        return out
    lib = _cuda.lib()
    with torch.cuda.device(tf.device):
        status = _launch_scores(lib, tf, df, doc_len, doc_count, total_len, k1, b, negate,
                                out, torch.cuda.current_stream().cuda_stream)
        _cuda.check(status, "bm25_scores")
    SCORES.bump()
    return out


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def bm25_scores(tf, df, doc_len, doc_count, total_len, k1: float = 1.2,
                b: float = 0.75) -> torch.Tensor:
    """-> [N] BM25 score of each candidate doc against the query terms (K9).

    tf: [N, T] float32 or int32 term frequencies; df: [T] float32 document
    frequencies; doc_len: [N] float32; doc_count, total_len: scalars, taken
    as f32 (a total_len above 2^24 rounds, as in the reference).
    """
    if _on_cpu(tf, df, doc_len):
        return bm25_scores_plain(tf, df, doc_len, doc_count, total_len, k1, b)
    _check_inputs(tf, df, doc_len)
    return _scores_cuda(tf, df, doc_len, doc_count, total_len, k1, b, negate=False)


def bm25_topk(tf, df, doc_len, doc_count, total_len, k: int, k1: float = 1.2,
              b: float = 0.75) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused score + top-k over the candidate set -> (scores [k] f32,
    indices [k] int32), largest first, lower index first on ties."""
    if _on_cpu(tf, df, doc_len):
        return bm25_topk_plain(tf, df, doc_len, doc_count, total_len, k, k1, b)
    _check_inputs(tf, df, doc_len)
    _check_k(k, tf.shape[0])
    from surrealdb_tpu_torch.ops import distances as D

    neg = _scores_cuda(tf, df, doc_len, doc_count, total_len, k1, b, negate=True)
    # the k smallest of -s in (value, lower index) order are the k largest
    # of s in lax.top_k's order. K2's select ties -0.0 with +0.0, which
    # lax.top_k ranks apart; a -0.0 score needs idf < 0 (df > doc_count),
    # which an index's own statistics never give. 0 - d keeps a zero +0.0.
    d, i = D.select_min_k(neg.view(1, -1), k)
    return 0.0 - d[0], i[0]


# ------------------------------------------------------------ the match
class Postings:
    """One compaction generation of a full-text index's postings on one
    device, as idx/ft_mirror.py lays them out (t_indptr, t_dids, t_tfs,
    doclen_arr): `indptr` int64 [terms + 1], `dids` int32 ascending within
    each term's list (4 zeros past the last posting, so the kernel's 16-byte
    loads stay inside), `tfs` f32, `doc_len` f32 [max(next_did, 1)];
    `host_indptr` is the numpy indptr (the lists' lengths on the host).
    Views of one buffer, filled by one copy from pinned memory; `nbytes` and
    `seconds` (packing and copy) are recorded."""

    def __init__(self, indptr, dids, tfs, doc_len, host_indptr, nbytes, seconds):
        self.indptr, self.dids, self.tfs, self.doc_len = indptr, dids, tfs, doc_len
        self.host_indptr = host_indptr
        self.device = dids.device
        self.nbytes, self.seconds = nbytes, seconds

    def length(self, tid: int) -> int:
        return int(self.host_indptr[tid + 1] - self.host_indptr[tid])


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def upload_postings(indptr, dids, tfs, doc_len, device) -> Postings:
    """Postings on `device` from the mirror's numpy arrays: int32 dids (a did
    of 2^31 or more raises), f32 tf and lengths, in one copy from pinned
    memory (on a CPU device one host buffer of the same layout)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    if len(doc_len) > 2 ** 31 - 1:
        raise ValueError(f"document ids reach {len(doc_len)}: the card's postings take "
                         "int32 ids below 2^31")
    nnz = len(dids)
    sizes = [8 * len(indptr), 4 * (nnz + 4), 4 * nnz, 4 * len(doc_len)]
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + _align16(n))
    pin = device.type == "cuda"
    host = torch.empty(offs[-1], dtype=torch.uint8, pin_memory=pin)
    h = host.numpy()
    h[offs[0]:offs[0] + sizes[0]].view(np.int64)[:] = indptr
    hd = h[offs[1]:offs[1] + sizes[1]].view(np.int32)
    hd[:nnz] = dids
    hd[nnz:] = 0
    h[offs[2]:offs[2] + sizes[2]].view(np.float32)[:] = tfs
    h[offs[3]:offs[3] + sizes[3]].view(np.float32)[:] = doc_len
    buf = host.to(device) if pin else host
    if pin:
        torch.cuda.synchronize(device)

    def part(i, dtype):
        return buf[offs[i]:offs[i] + sizes[i]].view(dtype)

    return Postings(part(0, torch.int64), part(1, torch.int32), part(2, torch.float32),
                    part(3, torch.float32), np.asarray(indptr, dtype=np.int64).copy(),
                    offs[-1], time.perf_counter() - t0)


def bm25_match_scores_plain(postings: Postings, tids: Sequence[int], df, doc_count, total_len,
                            k1: float = 1.2, b: float = 0.75):
    """Plain bm25_match_scores, the reference's intersection in PyTorch on
    the postings' device: the rarest list's dids kept where searchsorted
    finds them in each other list, their tf columns stacked, then
    bm25_scores_plain. -> (dids int64, scores f32) numpy."""
    ip = postings.host_indptr
    rows = [(postings.dids[ip[t]:ip[t + 1]], postings.tfs[ip[t]:ip[t + 1]]) for t in tids]
    cand = rows[0][0]
    cols = [rows[0][1]]
    for dids, tfs in rows[1:]:
        pos = torch.searchsorted(dids, cand).clamp(0, dids.shape[0] - 1)
        mask = dids[pos] == cand
        cand = cand[mask]
        cols = [c[mask] for c in cols] + [tfs[pos[mask]]]
        if cand.numel() == 0:
            return np.empty(0, np.int64), np.empty(0, np.float32)
    dfs = torch.as_tensor(np.asarray(df, dtype=np.float32), device=cand.device)
    s = bm25_scores_plain(torch.stack(cols, 1), dfs, postings.doc_len[cand.long()], doc_count,
                          total_len, k1, b)
    return cand.long().cpu().numpy(), s.cpu().numpy()


class MatchScratch:
    """bm25_match_scores' buffers on one (device, stream), grown with the
    rarest list: the look-back state (zero between calls; a failed call
    marks it `dirty` and the next one zeroes it), the output pairs on the
    device, the host buffer the count and matches come down to (pinned on a
    card), and the (tid, df) pairs of a query of more than MATCH_BY_VALUE
    terms on the device (grown with the terms, written by one copy a call).
    `lock` keeps one call's launch and download together."""

    def __init__(self, device):
        self.device = device
        self.terms = torch.empty(0, dtype=torch.int32, device=device)
        self.state = torch.zeros(0, dtype=torch.int64, device=device)
        self.out = torch.empty(0, dtype=torch.int32, device=device)
        self.host = torch.empty(0, dtype=torch.int32)
        self.dirty = False
        self.lock = threading.Lock()

    def ensure(self, lib, n0: int, t: int) -> None:
        if t > MATCH_BY_VALUE and self.terms.numel() < 2 * t:
            self.terms = torch.empty(2 * t, dtype=torch.int32, device=self.device)
        states = int(lib.bm25_match_state_entries(n0))
        if self.state.numel() < states:
            self.state = torch.zeros(states, dtype=torch.int64, device=self.device)
        elif self.dirty:
            self.state.zero_()
        self.dirty = False
        if self.out.numel() < 2 * (1 + n0):
            self.out = torch.empty(2 * (1 + n0), dtype=torch.int32, device=self.device)
        if self.host.numel() < 2 * (1 + n0):
            self.host = torch.empty(2 * (1 + n0), dtype=torch.int32,
                                    pin_memory=self.device.type == "cuda")


_MATCH_SCRATCH: Dict[tuple, MatchScratch] = {}
_MATCH_SCRATCH_LOCK = threading.Lock()


def match_scratch(device) -> MatchScratch:
    """The cached MatchScratch of (device, its current stream)."""
    key = (device, torch.cuda.current_stream(device).cuda_stream
           if device.type == "cuda" else None)
    with _MATCH_SCRATCH_LOCK:
        sc = _MATCH_SCRATCH.get(key)
        if sc is None:
            sc = _MATCH_SCRATCH[key] = MatchScratch(device)
        return sc


def _launch_match(lib, postings: Postings, tids, df, doc_count, total_len, k1, b,
                  scratch: MatchScratch, stream, download: bool = True):
    """One call of csrc/bm25.cu's bm25_match_scores through `lib` (the
    built library, or the CPU emulation's in the tests): the launch, then
    the count and the matches copied into scratch.host. -> (dids int64,
    scores f32) numpy; with download=False the launch alone (a timing's),
    -> None."""
    t = len(tids)
    if t < 1:
        raise ValueError("a match launch takes at least one term")
    n0 = postings.length(tids[0])
    if n0 <= 0:
        raise ValueError("the rarest term has no postings")
    tid_a = np.ascontiguousarray(tids, dtype=np.int32)
    df_a = np.ascontiguousarray(df, dtype=np.float32)
    with scratch.lock:
        scratch.ensure(lib, n0, t)
        count = lib.bm25_match_scores(
            postings.indptr.data_ptr(), postings.dids.data_ptr(), postings.tfs.data_ptr(),
            postings.doc_len.data_ptr(), tid_a.ctypes.data, df_a.ctypes.data, t, n0,
            _f32(doc_count), _f32(total_len), _f32(k1), _f32(b), _f32(k1 + 1.0),
            _f32(1.0 - b), scratch.terms.data_ptr() if t > MATCH_BY_VALUE else None,
            scratch.state.data_ptr(), scratch.out.data_ptr(),
            scratch.host.data_ptr() if download else None, MATCH_FIRST, stream,
        )
        if count < 0:
            from surrealdb_tpu_torch.ops import _cuda

            scratch.dirty = True
            _cuda.check(int(-count), "bm25_match_scores", lib)
        if not download:
            return None
        pairs = scratch.host.numpy()[2:2 + 2 * count].reshape(count, 2)
        return pairs[:, 0].astype(np.int64), pairs[:, 1].copy().view(np.float32)


def bm25_match_scores(postings: Postings, tids: Sequence[int], df, doc_count, total_len,
                      k1: float = 1.2, b: float = 0.75):
    """The AND-match and BM25 scores of one query over card-resident
    postings (K9, one launch and one download) -> (dids int64, scores f32)
    numpy: the dids of the first term's list found in every other list, in
    that list's ascending order, each scored over the terms left to right.

    tids: the query's distinct term ids rarest first, ties in query order
    (FtMirror.search's order), each list non-empty, any number of them
    (past MATCH_BY_VALUE they reach the kernel through the scratch on the
    card); df: their document frequencies (the index's or a
    stats_override's); doc_count, total_len taken as f32. The scores are
    bm25_scores' bits for the same tf rows. Postings on the CPU run the
    plain version; on a card a failed launch raises."""
    if postings.device.type != "cuda":
        return bm25_match_scores_plain(postings, tids, df, doc_count, total_len, k1, b)
    from surrealdb_tpu_torch.ops import _cuda

    dev = postings.device
    lib = _cuda.lib()
    with torch.cuda.device(dev):
        out = _launch_match(lib, postings, tids, df, doc_count, total_len, k1, b,
                            match_scratch(dev), torch.cuda.current_stream(dev).cuda_stream)
    MATCH.bump()
    return out


# ------------------------------------------------------------ engine step
def score_candidates(device, tf, df, doc_len, doc_count, total_len, k1=1.2, b=0.75):
    """Score one query's candidate set as the reference's two call sites do
    (idx/ft_mirror.py search, idx/ft_index.py search; the port's mirror
    search runs bm25_match_scores under the same rule): numpy arrays in,
    [N] f32 numpy out. Below cnf.TPU_FT_ONDEVICE_THRESHOLD candidates (or
    with TPU_DISABLE) the numpy twin; otherwise tf / df / doc_len go to
    `device` (the Datastore's) and K9 scores them there, with doc_count and
    total_len as f32. A CPU device runs the plain version; a failed launch
    raises, nothing scores on the host instead."""
    from surrealdb_tpu_torch import cnf, compile_log

    if cnf.TPU_DISABLE or len(tf) < cnf.TPU_FT_ONDEVICE_THRESHOLD:
        # tiny candidate sets score on host — a device dispatch costs more
        return bm25_scores_host(tf, df, doc_len, doc_count, total_len, k1, b)
    if device is None:
        raise RuntimeError("no device recorded for this full-text index")

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

    # every distinct (candidates, terms) shape is one first launch
    with compile_log.tracked("bm25", (int(tf.shape[0]), int(tf.shape[1]))):
        s = bm25_scores(up(tf), up(df), up(doc_len), np.float32(doc_count),
                        np.float32(total_len), k1, b)
        return s.cpu().numpy()


def bm25_scores_host(tf, df, doc_len, doc_count, total_len, k1=1.2, b=0.75):
    """numpy twin of bm25_scores for candidate sets too small to amortize a
    device dispatch (threshold in cnf.TPU_FT_ONDEVICE_THRESHOLD)."""
    import numpy as np

    n = max(float(doc_count), 1.0)
    avg_len = max(float(total_len) / n, 1e-6)
    df = np.asarray(df, dtype=np.float64)
    tf = np.asarray(tf, dtype=np.float64)
    doc_len = np.asarray(doc_len, dtype=np.float64)
    idf = np.log1p((n - df + 0.5) / (df + 0.5))
    norm = 1.0 - b + b * (doc_len[:, None] / avg_len)
    score = idf[None, :] * (tf * (k1 + 1.0)) / (tf + k1 * norm)
    return score.sum(axis=1).astype(np.float32)
