"""Materialized views (DEFINE TABLE ... AS SELECT) with incremental
per-mutation maintenance.

Role of the reference's foreign-table processing (reference:
core/src/doc/table.rs:55-800): a view table's contents are derived from its
source tables and kept current on EVERY source mutation:

- plain views (no GROUP BY): view row id mirrors the source id; the row is
  upserted when the source row matches the view's WHERE (or the view has
  none) and deleted otherwise (table.rs:202-276);
- grouped views: the view row id is the array of group values
  (table.rs:324-327); aggregates adjust in place — count/math::sum increment
  and decrement (table.rs `chg`:513), math::mean is maintained via a hidden
  per-field value counter (table.rs `mean`:650), math::min/max/time::min/max
  keep the extremum on add and RECOMPUTE their group when the removed value
  equals the current extremum (table.rs `min`/`max`:536-647 `one_group_query`);
  hidden bookkeeping lives under a `__` field like the reference's
  `__.{hash}.c` keys, and a group row is purged when its member count drops
  to zero (the del_ops purge conditions, table.rs:336-363).

Aggregates outside the reference's rolling set (stddev, median, array::*)
and `*` projections in grouped views fall back to a full recompute of just
the affected group, never the whole view.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from surrealdb_tpu_torch import key as keys
from surrealdb_tpu_torch.key.encode import prefix_end
from surrealdb_tpu_torch.sql.ast import FunctionCall
from surrealdb_tpu_torch.sql.value import NONE, Thing, is_nullish, sort_key, truthy

# aggregates maintained incrementally (reference table.rs:393-494 is_rolling)
_ROLLING = {"count", "math::sum", "math::mean", "math::min", "math::max",
            "time::min", "time::max"}
_MINMAX = {"math::min", "math::max", "time::min", "time::max"}


# ------------------------------------------------------------------ helpers
def _field_key(f) -> str:
    """Output key of a projection field (mirrors iterator._assign_field)."""
    from surrealdb_tpu_torch.dbs.iterator import field_display_name
    from surrealdb_tpu_torch.sql.path import Idiom

    if f.alias is not None:
        if isinstance(f.alias, Idiom):
            fp = f.alias.field_path()
            if fp is not None and len(fp) == 1:
                return fp[0]
            return repr(f.alias)
        return str(f.alias)
    return field_display_name(f.expr)


def _eval_on(ctx, expr, doc, rid):
    with ctx.with_doc_value(doc, rid=rid) as c:
        return expr.compute(c)


def _cond_ok(ctx, sel, doc, rid) -> bool:
    if sel.cond is None:
        return True
    with ctx.with_doc_value(doc, rid=rid) as c:
        return truthy(sel.cond.compute(c))


def _group_ids(ctx, sel, doc, rid) -> List[Any]:
    with ctx.with_doc_value(doc, rid=rid) as c:
        return [g.compute(c) for g in (sel.group or [])]


def _vid_for_group(view_name: str, gids: List[Any]) -> Thing:
    # group-id array as record id (reference table.rs:324-327)
    return Thing(view_name, list(gids))


def _num(v) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return v


# ------------------------------------------------------------------ plain views
def _apply_plain(ctx, view_name: str, sel, rid: Thing, after, action: str) -> None:
    from surrealdb_tpu_torch.dbs.iterator import project_fields

    ns, db = ctx.ns_db()
    txn = ctx.txn()
    vid = Thing(view_name, rid.id)
    if after is None or not _cond_ok(ctx, sel, after, rid):
        txn.del_record(ns, db, view_name, vid.id)
        return
    with ctx.with_doc_value(after, rid=rid) as c:
        row = project_fields(c, sel.fields, after, rid, value_mode=False)
    if not isinstance(row, dict):
        row = {"value": row}
    row = dict(row)
    row["id"] = vid
    txn.set_record(ns, db, view_name, vid.id, row)


# ------------------------------------------------------------------ grouped views
def _apply_grouped(ctx, view_name: str, sel, rid: Thing, before, after) -> None:
    # -old then +new, each gated by the view's WHERE on that snapshot
    # (reference table.rs:102-199)
    if before is not None and _cond_ok(ctx, sel, before, rid):
        gids = _group_ids(ctx, sel, before, rid)
        _adjust_group(ctx, view_name, sel, gids, before, rid, sign=-1)
    if after is not None and _cond_ok(ctx, sel, after, rid):
        gids = _group_ids(ctx, sel, after, rid)
        _adjust_group(ctx, view_name, sel, gids, after, rid, sign=+1)


def _adjust_group(ctx, view_name, sel, gids, doc, rid, sign: int) -> None:
    from surrealdb_tpu_torch.dbs.iterator import _assign_field

    ns, db = ctx.ns_db()
    txn = ctx.txn()
    vid = _vid_for_group(view_name, gids)
    row = txn.get_record(ns, db, view_name, vid.id)
    if row is None:
        if sign < 0:
            return  # nothing to subtract from (shouldn't happen)
        row = {"id": vid}
    bk = row.get("__")
    if not isinstance(bk, dict):
        bk = row["__"] = {}

    # any field outside the rolling set (or a `*` projection) forces a
    # one-group recompute — still O(group), never O(view)
    for f in sel.fields:
        if f.all or (
            isinstance(f.expr, FunctionCall)
            and f.expr.name not in _ROLLING
            and _is_aggregate(f.expr.name)
        ):
            _recompute_group(ctx, view_name, sel, gids, vid)
            return

    pending_recompute = False
    for f in sel.fields:
        key = _field_key(f)
        expr = f.expr
        if isinstance(expr, FunctionCall) and expr.name in _ROLLING:
            name = expr.name
            if name == "count" and not expr.args:
                cur = _num(row.get(key)) or 0
                _assign_field(ctx, row, f, int(cur) + sign)
                continue
            val = _eval_on(ctx, expr.args[0], doc, rid) if expr.args else NONE
            if name == "count":
                cur = _num(row.get(key)) or 0
                _assign_field(ctx, row, f, int(cur) + (sign if truthy(val) else 0))
            elif name == "math::sum":
                v = _num(val)
                cur = _num(row.get(key)) or 0
                if v is not None:
                    _assign_field(ctx, row, f, cur + sign * v)
            elif name == "math::mean":
                v = _num(val)
                if v is None:
                    continue
                fb = bk.setdefault(key, {})
                c = fb.get("c", 0)
                cur = _num(row.get(key)) or 0.0
                nc = c + sign
                fb["c"] = nc
                if nc <= 0:
                    _assign_field(ctx, row, f, NONE)
                else:
                    _assign_field(ctx, row, f, (cur * c + sign * v) / nc)
            elif name in _MINMAX:
                if is_nullish(val):
                    continue
                cur = row.get(key)
                is_min = name.endswith("min")
                if sign > 0:
                    better = (
                        cur is None
                        or is_nullish(cur)
                        or (
                            (sort_key(val) < sort_key(cur))
                            if is_min
                            else (sort_key(val) > sort_key(cur))
                        )
                    )
                    if better:
                        _assign_field(ctx, row, f, val)
                else:
                    # removing the current extremum: only this group's
                    # members can say what the next extremum is
                    # (reference one_group_query, table.rs:729)
                    if cur is not None and sort_key(val) == sort_key(cur):
                        pending_recompute = True
        else:
            if sign > 0:  # group-constant projections only need setting on add
                _assign_field(ctx, row, f, _eval_on(ctx, expr, doc, rid))

    n = bk.get("n", 0) + sign
    bk["n"] = n
    if n <= 0:
        txn.del_record(ns, db, view_name, vid.id)
        return
    if pending_recompute:
        _recompute_group(ctx, view_name, sel, gids, vid)
        return
    txn.set_record(ns, db, view_name, vid.id, row)


def _is_aggregate(name: str) -> bool:
    from surrealdb_tpu_torch.dbs.iterator import _AGGREGATES

    return name in _AGGREGATES


def _recompute_group(ctx, view_name: str, sel, gids, vid: Thing) -> None:
    """Re-aggregate ONE group from its source rows (reference
    one_group_query, table.rs:729-800)."""
    from surrealdb_tpu_torch.dbs.iterator import (
        _assign_field,
        _eval_grouped,
        _hashable,
        scan_table,
    )
    from surrealdb_tpu_torch.sql.value import Table

    ns, db = ctx.ns_db()
    txn = ctx.txn()
    want = tuple(_hashable(g) for g in gids)
    members: List[Tuple[Thing, dict]] = []
    mean_counts = {}
    for w in sel.what:
        src = w.compute(ctx)
        if not isinstance(src, Table):
            continue
        for srid, sdoc in scan_table(ctx, str(src)):
            if not _cond_ok(ctx, sel, sdoc, srid):
                continue
            k = tuple(_hashable(g) for g in _group_ids(ctx, sel, sdoc, srid))
            if k == want:
                members.append((srid, sdoc))
    if not members:
        txn.del_record(ns, db, view_name, vid.id)
        return
    row: dict = {"id": vid}
    bk: dict = {"n": len(members)}
    for f in sel.fields:
        if f.all:
            first = members[0][1]
            if isinstance(first, dict):
                merged = dict(first)
                merged.update(row)
                row = merged
            continue
        v = _eval_grouped(ctx, f.expr, members)
        _assign_field(ctx, row, f, v)
        if isinstance(f.expr, FunctionCall) and f.expr.name == "math::mean":
            cnt = 0
            for mrid, mdoc in members:
                mv = _num(_eval_on(ctx, f.expr.args[0], mdoc, mrid))
                if mv is not None:
                    cnt += 1
            mean_counts[_field_key(f)] = {"c": cnt}
    bk.update(mean_counts)
    row["__"] = bk
    row["id"] = vid
    txn.set_record(ns, db, view_name, vid.id, row)


# ------------------------------------------------------------------ entry points
def apply_view_mutations(ctx, rid: Thing, before, after, action: str) -> None:
    """Incremental maintenance hook, fired from the doc pipeline after every
    source-table mutation (reference doc/table.rs process_table_views)."""
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    links = txn.all_tb_views(ns, db, rid.tb)
    if not links:
        return
    for link in links:
        view_name = link["name"]
        vdef = txn.get_tb(ns, db, view_name)
        if vdef is None or vdef.get("view") is None:
            continue
        sel = vdef["view"]
        if sel.group or getattr(sel, "group_all", False):
            _apply_grouped(ctx, view_name, sel, rid, before, after)
        else:
            _apply_plain(ctx, view_name, sel, rid, after, action)


def materialize_view(ctx, view_name: str, sel) -> None:
    """Initial materialization at DEFINE time. Grouped views REPLAY the
    incremental add path per source row so bookkeeping (`__` counters) and
    row ids match exactly what maintenance produces; plain views project
    row-by-row with source-mirrored ids."""
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    pre = keys.thing_prefix(ns, db, view_name)
    txn.delr(pre, prefix_end(pre))
    txn.touch_table(ns, db, view_name)  # raw range delete of record keys
    txn.ensure_tb(ns, db, view_name)

    from surrealdb_tpu_torch.dbs.iterator import scan_table
    from surrealdb_tpu_torch.sql.value import Table

    grouped = bool(sel.group or getattr(sel, "group_all", False))
    for w in sel.what:
        src = w.compute(ctx)
        if not isinstance(src, Table):
            continue
        for srid, sdoc in scan_table(ctx, str(src)):
            if grouped:
                if _cond_ok(ctx, sel, sdoc, srid):
                    gids = _group_ids(ctx, sel, sdoc, srid)
                    _adjust_group(ctx, view_name, sel, gids, sdoc, srid, sign=+1)
            else:
                _apply_plain(ctx, view_name, sel, srid, sdoc, "CREATE")


def refresh_views(ctx, tb: str) -> None:
    """Full re-materialization of every view sourcing `tb` (REBUILD-style
    escape hatch; normal maintenance is incremental)."""
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    for link in txn.all_tb_views(ns, db, tb):
        view_name = link["name"]
        vdef = txn.get_tb(ns, db, view_name)
        if vdef is not None and vdef.get("view") is not None:
            materialize_view(ctx, view_name, vdef["view"])
