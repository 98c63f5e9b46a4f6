"""Write-side index maintenance.

Role of the reference's IndexOperation (reference: core/src/idx/index.rs:46-
341): on every document mutation, extract the indexed field values from the
old and new versions and update each index defined on the table. Non-unique
('idx') and unique ('uniq') indexes live directly in the ordered keyspace;
'search' (full-text), 'mtree' and 'hnsw' route to their own modules.

Array-valued fields produce one index entry per element combination,
mirroring the reference's Ids cartesian iterator.
"""

from __future__ import annotations

import itertools
from typing import Any, List, Optional, Sequence

from surrealdb_tpu_torch import key as keys
from surrealdb_tpu_torch.err import IndexExistsError, TypeError_
from surrealdb_tpu_torch.sql.path import get_path
from surrealdb_tpu_torch.sql.value import NONE, Thing, format_value, is_nullish, value_eq

_MAX_COMBINATIONS = 1024


def extract_index_values(ctx, ix: dict, doc: Optional[dict]) -> Optional[List[Any]]:
    """Evaluate the index's field idioms against a document version."""
    if doc is None:
        return None
    with ctx.with_doc_value(doc) as c:
        return [get_path(c, doc, f.parts) for f in ix["fields"]]


def _combinations(vals: Sequence[Any]) -> List[tuple]:
    """Expand array-valued columns into per-element combinations."""
    axes = []
    for v in vals:
        if isinstance(v, list):
            axes.append(v if v else [NONE])
        else:
            axes.append([v])
    total = 1
    for a in axes:
        total *= len(a)
        if total > _MAX_COMBINATIONS:
            raise TypeError_("Index value combination count exceeds the allowed limit")
    return list(itertools.product(*axes))


def index_document(ctx, rid: Thing, old_doc: Optional[dict], new_doc: Optional[dict]) -> None:
    """Diff old/new indexed values and update every index on the table."""
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    indexes = txn.all_tb_indexes(ns, db, rid.tb)
    if not indexes:
        return
    for ix in indexes:
        old_vals = extract_index_values(ctx, ix, old_doc)
        new_vals = extract_index_values(ctx, ix, new_doc)
        if old_vals is not None and new_vals is not None:
            if all(value_eq(a, b) for a, b in zip(old_vals, new_vals)):
                continue
        _apply(ctx, ix, rid, old_vals, new_vals)


def _apply(ctx, ix: dict, rid: Thing, old_vals, new_vals) -> None:
    typ = ix["index"]["type"]
    if typ == "idx":
        _update_idx(ctx, ix, rid, old_vals, new_vals)
    elif typ == "uniq":
        _update_uniq(ctx, ix, rid, old_vals, new_vals)
    elif typ == "search":
        from surrealdb_tpu_torch.idx.ft import update_ft_index

        update_ft_index(ctx, ix, rid, old_vals, new_vals)
    elif typ in ("mtree", "hnsw"):
        from surrealdb_tpu_torch.idx.vector_index import update_vector_index

        update_vector_index(ctx, ix, rid, old_vals, new_vals)
    else:
        raise TypeError_(f"unknown index type {typ!r}")


def _update_idx(ctx, ix: dict, rid: Thing, old_vals, new_vals) -> None:
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    tb, name = ix["table"], ix["name"]
    if old_vals is not None:
        for combo in _combinations(old_vals):
            txn.delete(keys.index_entry(ns, db, tb, name, list(combo), rid))
    if new_vals is not None:
        for combo in _combinations(new_vals):
            txn.set(keys.index_entry(ns, db, tb, name, list(combo), rid), b"")


def _update_uniq(ctx, ix: dict, rid: Thing, old_vals, new_vals) -> None:
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    tb, name = ix["table"], ix["name"]
    from surrealdb_tpu_torch.utils.ser import pack, unpack

    if old_vals is not None:
        for combo in _combinations(old_vals):
            if all(is_nullish(v) for v in combo):
                continue
            txn.delete(keys.unique_entry(ns, db, tb, name, list(combo)))
    if new_vals is not None:
        for combo in _combinations(new_vals):
            if all(is_nullish(v) for v in combo):
                continue  # fully-NONE tuples are not uniqueness-constrained
            k = keys.unique_entry(ns, db, tb, name, list(combo))
            raw = txn.get(k)
            if raw is not None:
                holder = unpack(raw)
                if not (isinstance(holder, Thing) and holder == rid):
                    vals_txt = ", ".join(format_value(v) for v in combo)
                    raise IndexExistsError(holder, name, f"`{vals_txt}`")
            txn.set(k, pack(rid))


def rebuild_index(ctx, tb: str, ix: dict) -> int:
    """Full rebuild: wipe the index keyspace and re-index every record
    (reference: REBUILD INDEX + kvs/index.rs initial build)."""
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    name = ix["name"]
    from surrealdb_tpu_torch.key.encode import prefix_end

    pre = keys.index_prefix(ns, db, tb, name)
    txn.delr(pre, prefix_end(pre))
    ctx.ds().index_stores.remove(ns, db, tb, name)

    count = 0
    rpre = keys.thing_prefix(ns, db, tb)
    from surrealdb_tpu_torch.utils.ser import unpack

    for chunk in txn.batch(rpre, prefix_end(rpre), 1000):
        for k, v in chunk:
            doc = unpack(v)
            rid = Thing(tb, keys.decode_thing_id(k, ns, db, tb))
            new_vals = extract_index_values(ctx, ix, doc)
            _apply(ctx, ix, rid, None, new_vals)
            count += 1
    return count
