"""BM25 scoring, host half.

Mirrors surrealdb_tpu/ops/bm25.py. The batched device kernel (K9:
bm25_scores / bm25_topk) is not ported yet: idx/ft_index.py raises
NotImplementedError above cnf.TPU_FT_ONDEVICE_THRESHOLD. Below it the
reference's numpy twin serves, copied as it is.
"""

from __future__ import annotations


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
