"""Changefeed reading: SHOW CHANGES FOR TABLE ... SINCE ...

Role of the reference's cf reader (reference: core/src/cf/reader.rs): scan
the versionstamped change keys of the database and surface each ChangeSet as
{versionstamp, changes: [...]}.
"""

from __future__ import annotations

from typing import Any, List

from surrealdb_tpu_torch import key as keys
from surrealdb_tpu_torch.err import SurrealError
from surrealdb_tpu_torch.key.encode import prefix_end
from surrealdb_tpu_torch.kvs.vs import vs_to_u64, u64_to_vs
from surrealdb_tpu_torch.sql.value import Datetime
from surrealdb_tpu_torch.utils.ser import unpack


def show_changes(ctx, stm) -> List[dict]:
    ns, db = ctx.ns_db()
    txn = ctx.txn()

    db_def = txn.get_db(ns, db)
    tb_def = txn.get_tb(ns, db, stm.table) if stm.table else None
    has_cf = (db_def or {}).get("changefeed") or (tb_def or {}).get("changefeed")
    if not has_cf:
        raise SurrealError(
            f"Change feed for table '{stm.table}' is not enabled"
            if stm.table
            else f"Change feed for database '{db}' is not enabled"
        )

    since_vs = 0
    since_ts = None
    if stm.since is not None:
        v = stm.since.compute(ctx) if hasattr(stm.since, "compute") else stm.since
        if isinstance(v, Datetime):
            # datetime SINCE: entries carry their commit timestamp; skip
            # those older than the requested instant (keys are vs-ordered =
            # time-ordered, so the retained scan stays bounded by GC)
            since_ts = v.nanos
        else:
            since_vs = int(v)

    beg = keys.change(ns, db, u64_to_vs(since_vs))
    end = prefix_end(keys.change_prefix(ns, db))
    # the LIMIT counts RETURNED change sets, so it must apply after the
    # ts filter, not to the raw key scan
    limit = stm.limit if stm.limit is not None else None

    out: List[dict] = []
    for k, raw in txn.scan(beg, end):
        if limit is not None and len(out) >= limit:
            break
        entry = unpack(raw)
        ts = entry.get("ts")
        # entries written before timestamps existed replay (never drop)
        if since_ts is not None and ts is not None and ts < since_ts:
            continue
        vs = keys.decode_change(k, ns, db)
        changes: List[Any] = []
        for tb, muts in entry.get("tables", {}).items():
            if stm.table and tb != stm.table:
                continue
            for m in muts:
                if m.get("delete"):
                    changes.append({"delete": {"id": m["id"]}})
                elif "bulk_ids" in m:
                    # batch entry (bulk ingest): the entry stores record ids
                    # only; expand each to its committed document via a
                    # versioned read pinned at the entry's own commit
                    # version, so replay shows exactly the bulk-op values
                    # even after later updates. Backends without MVCC
                    # version tracking expand with the current value.
                    changes.extend(_expand_bulk(txn, ns, db, tb, k, m["bulk_ids"]))
                else:
                    changes.append({"update": m.get("update")})
        if changes:
            out.append({"versionstamp": vs_to_u64(vs), "changes": changes})
    return out


def _expand_bulk(txn, ns: str, db: str, tb: str, entry_key: bytes, ids) -> List[dict]:
    """Reader-side expansion of a bulk changefeed entry: one `{update: doc}`
    per surviving record id. Records whose pinned version was GC'd past the
    MVCC horizon expand with the oldest retained value (same best-effort
    contract as retention GC); records deleted before their bulk entry was
    read are skipped."""
    ver = txn.tr.version_of(entry_key)
    out: List[dict] = []
    for id_ in ids:
        k = keys.thing(ns, db, tb, id_)
        raw = txn.tr.get(k, ver)
        if raw is None and ver is not None:
            # pinned version GC'd past the MVCC horizon: fall back to the
            # oldest retained value (retention-GC contract) — None there
            # too means the record is genuinely gone
            raw = txn.tr.oldest_retained(k)
        if raw is None:
            continue
        out.append({"update": unpack(raw)})
    return out
