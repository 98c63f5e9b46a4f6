"""Full-text index write path (SEARCH index definitions).

Role of the reference's FtIndex::index_document (reference:
core/src/idx/ft/mod.rs). Delegates to the real inverted index in
idx/ft_index.py — analyzers, term dictionary, postings, doc lengths — which
also buffers the per-document mirror delta consumed by the device-resident
CSR postings mirror (idx/ft_mirror.py) at commit.
"""

from __future__ import annotations

from surrealdb_tpu_torch.sql.value import Thing


def update_ft_index(ctx, ix: dict, rid: Thing, old_vals, new_vals) -> None:
    from surrealdb_tpu_torch.idx.ft_index import FtIndex

    FtIndex.for_index(ctx, ix).index_document(ctx, rid, old_vals, new_vals)
