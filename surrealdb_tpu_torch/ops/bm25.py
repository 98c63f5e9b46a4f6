"""Batched BM25 scoring (PyTorch; a CUDA kernel on the card).

Mirrors surrealdb_tpu/ops/bm25.py. Its device program (K9) is a
hand-written CUDA kernel here (csrc/bm25.cu):

- `bm25_scores` (tf [N,T] f32 or int32, df [T] f32, doc_len [N] f32, the
  corpus's doc count and total length as f32 scalars -> [N] f32) launches
  `bm25_scores`: one thread a candidate row, the T idf values computed once
  a block in shared memory;
- `bm25_topk` is that kernel writing the negated scores, then K2's
  selection (`knn_select`, ops/distances.py) for the k smallest: lax.top_k's
  order (larger score first, lower index first on ties) with int32 indices.

The launch counter counts launches of the score kernel (one per call of
either wrapper); bm25_topk's selection counts under `knn_select`.

Each wrapper takes tensors on one device. A CUDA tensor goes to the kernel
(or the wrapper raises); a CPU tensor goes to the plain PyTorch version
beside it (`bm25_scores_plain`, `bm25_topk_plain`), which the tests hold
against the reference and chip_smoke.py holds the kernel against.
`score_candidates` is the engine's scoring step (idx/ft_mirror.py,
idx/ft_index.py): the reference's numpy twin `bm25_scores_host`, copied as
it is, below cnf.TPU_FT_ONDEVICE_THRESHOLD candidates, else K9 on the
Datastore's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from surrealdb_tpu_torch.ops.distances import LaunchCounter

SCORES = LaunchCounter("bm25_scores")
KERNELS = (SCORES,)


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


# ------------------------------------------------------------ engine step
def score_candidates(device, tf, df, doc_len, doc_count, total_len, k1=1.2, b=0.75):
    """Score one query's candidate set as the reference's two call sites do
    (idx/ft_mirror.py search, idx/ft_index.py search): numpy arrays in,
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
