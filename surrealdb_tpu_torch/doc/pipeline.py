"""Per-record document pipeline.

Role of the reference's Document + per-verb flows (reference: core/src/doc/ —
process.rs, create.rs/update.rs/upsert.rs/delete.rs/insert.rs/relate.rs, and
the shared steps in field.rs/store.rs/index.rs/lives.rs/event.rs/
changefeeds.rs/edges.rs/pluck.rs/purge.rs). The step order follows
doc/upsert.rs:84-98: check → data merge → field defines → store → index →
lives → events → changefeeds → pluck.

Each verb entry point processes ONE record inside the statement's transaction
and returns the RETURN-clause output (or raises IgnoreError to skip).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from surrealdb_tpu_torch import key as keys
from surrealdb_tpu_torch.err import (
    FieldCheckError,
    IgnoreError,
    RecordExistsError,
    SurrealError,
    TypeError_,
)
from surrealdb_tpu_torch.sql.path import Idiom, PField, del_path, get_path, set_path
from surrealdb_tpu_torch.sql.value import (
    NONE,
    Null,
    Thing,
    copy_value,
    format_value,
    is_none,
    is_nullish,
    truthy,
    value_eq,
)
from surrealdb_tpu_torch.dbs.context import CursorDoc


# ------------------------------------------------------------------ data clause
def apply_data(ctx, current: dict, data, rid: Thing) -> dict:
    """Apply a SET/UNSET/CONTENT/MERGE/PATCH/REPLACE clause to the working doc."""
    if data is None:
        return current
    kind = data.kind
    with ctx.with_doc_value(current, rid=rid) as c:
        if kind == "set":
            for idiom, op, expr in data.items:
                v = expr.compute(c)
                parts = idiom.parts
                if op == "=":
                    set_path(c, current, parts, v)
                elif op == "+=":
                    old = get_path(c, current, parts)
                    set_path(c, current, parts, _op_add(old, v))
                elif op == "-=":
                    old = get_path(c, current, parts)
                    set_path(c, current, parts, _op_sub(old, v))
                else:
                    raise TypeError_(f"unknown SET operator {op}")
            return current
        if kind == "unset":
            for idiom in data.items:
                del_path(c, current, idiom.parts)
            return current
        if kind in ("content", "replace"):
            v = data.items.compute(c) if hasattr(data.items, "compute") else data.items
            if not isinstance(v, dict):
                raise TypeError_(f"Cannot use {format_value(v)} as CONTENT")
            return dict(v)
        if kind == "merge":
            v = data.items.compute(c) if hasattr(data.items, "compute") else data.items
            if not isinstance(v, dict):
                raise TypeError_(f"Cannot use {format_value(v)} as MERGE")
            return _deep_merge(current, v)
        if kind == "patch":
            v = data.items.compute(c) if hasattr(data.items, "compute") else data.items
            if not isinstance(v, list):
                raise TypeError_("PATCH expects an array of operations")
            return apply_patch(current, v)
    raise TypeError_(f"unknown data clause {kind}")


def _op_add(old, v):
    if isinstance(old, list):
        return old + (list(v) if isinstance(v, (list, tuple)) else [v])
    if is_nullish(old):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return v
        return [v] if not isinstance(v, (list, tuple)) else list(v)
    if isinstance(old, (int, float)) and isinstance(v, (int, float)):
        return old + v
    if isinstance(old, str) and isinstance(v, str):
        return old + v
    raise TypeError_(f"Cannot add {format_value(v)} to {format_value(old)}")


def _op_sub(old, v):
    if isinstance(old, list):
        out = list(old)
        for x in out:
            if value_eq(x, v):
                out.remove(x)
                break
        return out
    if isinstance(old, (int, float)) and isinstance(v, (int, float)):
        return old - v
    if is_nullish(old) and isinstance(v, (int, float)):
        return -v
    raise TypeError_(f"Cannot subtract {format_value(v)} from {format_value(old)}")


def _deep_merge(dst: dict, src: dict) -> dict:
    out = dict(dst)
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        elif is_none(v):
            out.pop(k, None)
        else:
            out[k] = v
    return out


# ------------------------------------------------------------------ JSON patch
def apply_patch(doc: dict, ops: List[dict]) -> dict:
    out = copy_value(doc)
    for op in ops:
        kind = op.get("op")
        path = _patch_path(op.get("path", ""))
        if kind == "add":
            _patch_set(out, path, op.get("value"), insert=True)
        elif kind == "remove":
            _patch_del(out, path)
        elif kind in ("replace", "change"):
            _patch_set(out, path, op.get("value"), insert=False)
        elif kind == "copy":
            v = _patch_get(out, _patch_path(op.get("from", "")))
            _patch_set(out, path, copy_value(v), insert=True)
        elif kind == "move":
            src = _patch_path(op.get("from", ""))
            v = _patch_get(out, src)
            _patch_del(out, src)
            _patch_set(out, path, v, insert=True)
        elif kind == "test":
            if not value_eq(_patch_get(out, path), op.get("value")):
                raise TypeError_(f"PATCH test failed at {op.get('path')}")
        else:
            raise TypeError_(f"unknown PATCH op {kind!r}")
    return out


def _patch_path(p: str) -> List[str]:
    return [seg for seg in p.split("/") if seg != ""]


def _patch_get(doc, path):
    cur = doc
    for seg in path:
        if isinstance(cur, list):
            cur = cur[int(seg)] if seg.lstrip("-").isdigit() and int(seg) < len(cur) else NONE
        elif isinstance(cur, dict):
            cur = cur.get(seg, NONE)
        else:
            return NONE
    return cur


def _patch_set(doc, path, value, insert: bool):
    if not path:
        return
    cur = doc
    for seg in path[:-1]:
        if isinstance(cur, list):
            cur = cur[_patch_index(cur, seg)]
        else:
            cur = cur.setdefault(seg, {})
    last = path[-1]
    if isinstance(cur, list):
        if last == "-":
            cur.append(value)
        elif insert:
            cur.insert(_patch_index(cur, last, allow_end=True), value)
        else:
            cur[_patch_index(cur, last)] = value
    elif isinstance(cur, dict):
        cur[last] = value


def _patch_index(arr: list, seg: str, allow_end: bool = False) -> int:
    if not seg.lstrip("-").isdigit():
        raise TypeError_(f"Invalid PATCH array index '{seg}'")
    i = int(seg)
    hi = len(arr) + 1 if allow_end else len(arr)
    if not (-len(arr) <= i < hi):
        raise TypeError_(f"PATCH array index {i} out of bounds")
    return i


def _patch_del(doc, path):
    if not path:
        return
    cur = doc
    for seg in path[:-1]:
        if isinstance(cur, list):
            cur = cur[int(seg)]
        elif isinstance(cur, dict):
            cur = cur.get(seg)
        if cur is None:
            return
    last = path[-1]
    if isinstance(cur, list) and last.lstrip("-").isdigit():
        i = int(last)
        if 0 <= i < len(cur):
            del cur[i]
    elif isinstance(cur, dict):
        cur.pop(last, None)


def diff_patch(before, after) -> List[dict]:
    """Compute a JSON-patch style diff (RETURN DIFF output)."""
    out: List[dict] = []
    _diff(before, after, "", out)
    return out


def _diff(a, b, path, out):
    if isinstance(a, dict) and isinstance(b, dict):
        for k in a:
            if k not in b:
                out.append({"op": "remove", "path": f"{path}/{k}"})
        for k, v in b.items():
            if k not in a:
                out.append({"op": "add", "path": f"{path}/{k}", "value": v})
            elif not value_eq(a[k], v):
                _diff(a[k], v, f"{path}/{k}", out)
        return
    if isinstance(a, list) and isinstance(b, list):
        n = min(len(a), len(b))
        for i in range(n):
            if not value_eq(a[i], b[i]):
                _diff(a[i], b[i], f"{path}/{i}", out)
        for i in range(len(b) - 1, n - 1, -1):
            out.append({"op": "add", "path": f"{path}/{i}", "value": b[i]})
        for i in range(len(a) - 1, n - 1, -1):
            out.append({"op": "remove", "path": f"{path}/{i}"})
        return
    out.append({"op": "replace", "path": path or "/", "value": b})


# ------------------------------------------------------------------ fields
def process_field_defs(ctx, rid: Thing, current: dict, initial, is_create: bool) -> dict:
    """Apply DEFINE FIELD clauses: DEFAULT, VALUE, TYPE, ASSERT, READONLY —
    then enforce SCHEMAFULL (reference: core/src/doc/field.rs)."""
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    tb_def = txn.get_tb(ns, db, rid.tb)
    fds = txn.all_tb_fields(ns, db, rid.tb)
    if not fds and (tb_def is None or not tb_def.get("schemafull")):
        return current

    from surrealdb_tpu_torch.sql.kind import coerce

    # parents before children so nested defaults build containers first
    for fd in sorted(fds, key=lambda d: d["name"]):
        parts = _field_parts(fd["name"])
        old = get_path(ctx, initial if isinstance(initial, dict) else {}, parts)
        val = get_path(ctx, current, parts)

        with ctx.with_doc_value(current, rid=rid) as c:
            c.set_param("before", old)
            c.set_param("input", val)
            c.set_param("after", val)
            c.set_param("value", val)

            if fd.get("default") is not None and is_none(val) and (
                is_create or fd.get("default_always")
            ):
                val = fd["default"].compute(c)
                c.set_param("value", val)
                c.set_param("after", val)

            if fd.get("value") is not None:
                val = fd["value"].compute(c)
                c.set_param("value", val)
                c.set_param("after", val)

            if fd.get("kind") is not None and not (is_none(val) and not is_create):
                try:
                    val = coerce(fd["kind"], val)
                except TypeError_ as e:
                    raise FieldCheckError(
                        f"Found {format_value(val)} for field `{fd['name']}`, "
                        f"with record `{rid}`, but expected a {fd['kind']!r}"
                    ) from e
                c.set_param("value", val)
                c.set_param("after", val)

            if fd.get("assert") is not None and not is_none(val):
                if not truthy(fd["assert"].compute(c)):
                    raise FieldCheckError(
                        f"Found {format_value(val)} for field `{fd['name']}`, "
                        f"with record `{rid}`, but field must conform to: "
                        f"{fd['assert']!r}"
                    )

            if fd.get("readonly") and not is_create and not value_eq(old, val):
                raise FieldCheckError(
                    f"Found changed value for field `{fd['name']}`, with record "
                    f"`{rid}`, but field is readonly"
                )

        if is_none(val):
            del_path(ctx, current, parts)
        else:
            set_path(ctx, current, parts, val)

    # SCHEMAFULL: drop keys without a field definition
    if tb_def is not None and tb_def.get("schemafull"):
        defined = set()
        for fd in fds:
            p = _field_parts(fd["name"])
            if p:
                defined.add(p[0].name)
        keep = {"id", "in", "out"}
        for k in list(current.keys()):
            if k not in defined and k not in keep:
                flex = any(
                    fd.get("flex") and _field_parts(fd["name"])[0].name == k
                    for fd in fds
                )
                if not flex:
                    del current[k]
    return current


def _field_parts(name) -> List[PField]:
    if isinstance(name, Idiom):
        return list(name.parts)
    return [PField(seg) for seg in str(name).split(".")]


# ------------------------------------------------------------------ store/purge
def store_record(ctx, rid: Thing, current: dict) -> None:
    ns, db = ctx.ns_db()
    current["id"] = rid
    ctx.txn().set_record(ns, db, rid.tb, rid.id, current)


def purge_record(ctx, rid: Thing, current: dict) -> None:
    """Delete the record, its graph pointers, and any edge records hanging off
    it (reference: core/src/doc/purge.rs)."""
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    txn.del_record(ns, db, rid.tb, rid.id)
    from surrealdb_tpu_torch.key.encode import prefix_end

    pre = keys.graph_prefix(ns, db, rid.tb, rid.id)

    # edge record: remove the pointers on its endpoints + its own block;
    # endpoints themselves stay (reference doc/purge.rs edge branch)
    is_edge = (
        isinstance(current, dict)
        and isinstance(current.get("in"), Thing)
        and isinstance(current.get("out"), Thing)
    )
    if is_edge:
        in_v, out_v = current["in"], current["out"]
        txn.delete(keys.graph(ns, db, in_v.tb, in_v.id, keys.DIR_OUT, rid.tb, rid))
        txn.delete(keys.graph(ns, db, out_v.tb, out_v.id, keys.DIR_IN, rid.tb, rid))
        txn.graph_delta(ns, db, in_v.tb, keys.DIR_OUT, rid.tb, in_v, rid, False)
        txn.graph_delta(ns, db, out_v.tb, keys.DIR_IN, rid.tb, out_v, rid, False)
        txn.graph_delta(ns, db, rid.tb, keys.DIR_IN, in_v.tb, rid, in_v, False)
        txn.graph_delta(ns, db, rid.tb, keys.DIR_OUT, out_v.tb, rid, out_v, False)
        txn.delr(pre, prefix_end(pre))
        return

    # node record: every pointer references an edge record — delete those
    # edge records too (graph integrity, reference doc/purge.rs node branch)
    for k in txn.keys(pre, prefix_end(pre)):
        _, d, ft, fk = keys.decode_graph(k, ns, db, rid.tb)
        txn.delete(k)
        if isinstance(fk, Thing):
            txn.graph_delta(ns, db, rid.tb, d, ft, rid, fk, False)
            edge_doc = txn.get_record(ns, db, fk.tb, fk.id)
            if edge_doc is not None:
                from surrealdb_tpu_torch.idx.index import index_document

                index_document(ctx, fk, edge_doc, None)
                purge_record(ctx, fk, edge_doc)
                _emit_mutation(ctx, fk, edge_doc, None, "DELETE")


def store_edges(ctx, edge_rid: Thing, from_t: Thing, to_t: Thing) -> None:
    """Write the 4 graph pointers for a RELATE
    (reference: core/src/doc/edges.rs:16-75)."""
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    txn.set(keys.graph(ns, db, from_t.tb, from_t.id, keys.DIR_OUT, edge_rid.tb, edge_rid), b"")
    txn.set(keys.graph(ns, db, edge_rid.tb, edge_rid.id, keys.DIR_IN, from_t.tb, from_t), b"")
    txn.set(keys.graph(ns, db, edge_rid.tb, edge_rid.id, keys.DIR_OUT, to_t.tb, to_t), b"")
    txn.set(keys.graph(ns, db, to_t.tb, to_t.id, keys.DIR_IN, edge_rid.tb, edge_rid), b"")
    # mirror upkeep: one delta per pointer, applied after commit
    txn.graph_delta(ns, db, from_t.tb, keys.DIR_OUT, edge_rid.tb, from_t, edge_rid, True)
    txn.graph_delta(ns, db, edge_rid.tb, keys.DIR_IN, from_t.tb, edge_rid, from_t, True)
    txn.graph_delta(ns, db, edge_rid.tb, keys.DIR_OUT, to_t.tb, edge_rid, to_t, True)
    txn.graph_delta(ns, db, to_t.tb, keys.DIR_IN, edge_rid.tb, to_t, edge_rid, True)


# ------------------------------------------------------------------ reactions
def _emit_mutation(ctx, rid: Thing, before, after, action: str) -> None:
    """Shared post-mutation hooks: live queries, events, changefeeds, views.

    (reference: doc/lives.rs, doc/event.rs, doc/changefeeds.rs, doc/table.rs)
    """
    from .views import apply_view_mutations

    apply_view_mutations(ctx, rid, before, after, action)
    process_table_lives(ctx, rid, before, after, action)
    process_table_events(ctx, rid, before, after, action)
    process_changefeeds(ctx, rid, before, after, action)


def process_table_lives(ctx, rid: Thing, before, after, action: str) -> None:
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    from surrealdb_tpu_torch.dbs.stmt_exec import unpack_lq
    from .lives import emit_live_notification

    for raw in txn.all_tb_lives(ns, db, rid.tb):
        lq = unpack_lq(raw)
        emit_live_notification(ctx, lq, rid, before, after, action)


def process_table_events(ctx, rid: Thing, before, after, action: str) -> None:
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    events = txn.all_tb_events(ns, db, rid.tb)
    if not events:
        return
    doc_v = after if after is not None else before
    for ev in events:
        with ctx.with_doc_value(doc_v, rid=rid) as c:
            c.set_param("event", action)
            c.set_param("before", before if before is not None else NONE)
            c.set_param("after", after if after is not None else NONE)
            c.set_param("value", after if after is not None else NONE)
            if ev.get("when") is not None and not truthy(ev["when"].compute(c)):
                continue
            for then in ev.get("then", []):
                then.compute(c)


def process_changefeeds(ctx, rid: Thing, before, after, action: str) -> None:
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    tb_def = txn.get_tb(ns, db, rid.tb)
    db_def = txn.get_db(ns, db)
    cf = (tb_def or {}).get("changefeed") or (db_def or {}).get("changefeed")
    if not cf:
        return
    mut: Dict[str, Any] = {"id": rid}
    if action == "DELETE":
        mut["delete"] = True
    else:
        mut["update"] = after
        if cf.get("original"):
            mut["original"] = before
    txn.buffer_change(ns, db, rid.tb, mut)


# ------------------------------------------------------------------ output
def pluck_output(ctx, stm, rid: Thing, before, after) -> Any:
    """Apply the RETURN clause (reference: core/src/doc/pluck.rs).

    Default per verb: writes return AFTER, DELETE returns NONE.
    """
    output = getattr(stm, "output", None)
    if output is None:
        kind = "none" if type(stm).__name__ == "DeleteStatement" else "after"
    else:
        kind = output.kind
    if kind == "none":
        raise IgnoreError(mutated=True)
    if kind == "null":
        return Null
    if kind == "before":
        return before if before is not None else NONE
    if kind == "after":
        return after if after is not None else NONE
    if kind == "diff":
        return diff_patch(before if before is not None else {}, after if after is not None else {})
    if kind == "fields":
        from surrealdb_tpu_torch.dbs.iterator import project_fields

        doc_v = after if after is not None else (before if before is not None else NONE)
        with ctx.with_doc_value(doc_v, rid=rid) as c:
            c.set_param("before", before if before is not None else NONE)
            c.set_param("after", after if after is not None else NONE)
            return project_fields(c, output.fields, doc_v, rid, value_mode=False)
    raise TypeError_(f"unknown output kind {kind}")


# ------------------------------------------------------------------ verbs
def _check_write_perm(ctx, rid: Thing, doc_v, verb: str) -> None:
    """Statement-level role gate + per-record PERMISSIONS for non-system
    sessions (reference doc/check.rs + iam is_allowed)."""
    from surrealdb_tpu_torch.iam.check import check_data_write, check_table_permission, perms_apply

    check_data_write(ctx)
    if perms_apply(ctx):
        if not check_table_permission(ctx, rid, doc_v, verb):
            raise IgnoreError()


def _check_record_perm(ctx, rid: Thing, doc_v, verb: str) -> None:
    """Per-record PERMISSIONS only (no role gate) — used for the post-data
    check; the reference evaluates table permissions AFTER record data is
    applied (create.rs) and twice for updates (update.rs)."""
    from surrealdb_tpu_torch.iam.check import check_table_permission, perms_apply

    if perms_apply(ctx):
        if not check_table_permission(ctx, rid, doc_v, verb):
            raise IgnoreError()


def _check_cond(ctx, stm, rid, doc_v) -> bool:
    cond = getattr(stm, "cond", None)
    if cond is None:
        return True
    with ctx.with_doc_value(doc_v, rid=rid) as c:
        return truthy(cond.compute(c))


def process_create(ctx, rid: Thing, stm, check_exists: bool = True) -> Any:
    """CREATE one record (reference: core/src/doc/create.rs)."""
    from surrealdb_tpu_torch.iam.check import check_data_write

    check_data_write(ctx)
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    if check_exists and txn.record_exists(ns, db, rid.tb, rid.id):
        raise RecordExistsError(rid)
    txn.ensure_tb(ns, db, rid.tb)
    current: dict = {"id": rid}
    current = apply_data(ctx, current, getattr(stm, "data", None), rid)
    current["id"] = rid
    current = process_field_defs(ctx, rid, current, {}, is_create=True)
    _check_record_perm(ctx, rid, current, "create")
    from surrealdb_tpu_torch.idx.index import index_document

    store_record(ctx, rid, current)
    index_document(ctx, rid, None, current)
    _emit_mutation(ctx, rid, None, current, "CREATE")
    return pluck_output(ctx, stm, rid, None, current)


def process_update(ctx, rid: Thing, initial: dict, stm) -> Any:
    """UPDATE one existing record (reference: core/src/doc/update.rs)."""
    if not _check_cond(ctx, stm, rid, initial):
        raise IgnoreError()
    _check_write_perm(ctx, rid, initial, "update")
    before = copy_value(initial)
    current = copy_value(initial)
    current = apply_data(ctx, current, getattr(stm, "data", None), rid)
    current["id"] = rid
    current = process_field_defs(ctx, rid, current, before, is_create=False)
    _check_record_perm(ctx, rid, current, "update")
    from surrealdb_tpu_torch.idx.index import index_document

    store_record(ctx, rid, current)
    index_document(ctx, rid, before, current)
    _emit_mutation(ctx, rid, before, current, "UPDATE")
    return pluck_output(ctx, stm, rid, before, current)


def process_delete(ctx, rid: Thing, initial: dict, stm) -> Any:
    """DELETE one record (reference: core/src/doc/delete.rs)."""
    if not _check_cond(ctx, stm, rid, initial):
        raise IgnoreError()
    _check_write_perm(ctx, rid, initial, "delete")
    before = copy_value(initial)
    from surrealdb_tpu_torch.idx.index import index_document

    index_document(ctx, rid, before, None)
    purge_record(ctx, rid, initial)
    _emit_mutation(ctx, rid, before, None, "DELETE")
    return pluck_output(ctx, stm, rid, before, None)


def process_insert(ctx, rid: Thing, row: dict, stm) -> Any:
    """INSERT one row (reference: core/src/doc/insert.rs): create, or on
    duplicate key either IGNORE, apply the UPDATE clause, or error."""
    from surrealdb_tpu_torch.iam.check import check_data_write

    check_data_write(ctx)
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    existing = txn.get_record(ns, db, rid.tb, rid.id)
    if existing is not None:
        if getattr(stm, "ignore", False):
            raise IgnoreError()
        update = getattr(stm, "update", None)
        if update is not None:
            from surrealdb_tpu_torch.sql.statements import Data

            sub = _StmView(data=Data("set", update), output=getattr(stm, "output", None))
            return process_update(ctx, rid, existing, sub)
        raise RecordExistsError(rid)
    txn.ensure_tb(ns, db, rid.tb)
    current = dict(row)
    current["id"] = rid
    current = process_field_defs(ctx, rid, current, {}, is_create=True)
    _check_record_perm(ctx, rid, current, "create")
    from surrealdb_tpu_torch.idx.index import index_document

    store_record(ctx, rid, current)
    index_document(ctx, rid, None, current)
    _emit_mutation(ctx, rid, None, current, "CREATE")
    return pluck_output(ctx, stm, rid, None, current)


def process_relate(
    ctx, edge_rid: Thing, from_t: Thing, to_t: Thing, stm, row: Optional[dict] = None
) -> Any:
    """RELATE one edge (reference: core/src/doc/relate.rs + edges.rs)."""
    from surrealdb_tpu_torch.iam.check import check_data_write

    check_data_write(ctx)
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    tb_def = txn.ensure_tb(ns, db, edge_rid.tb)
    if tb_def.get("enforced"):
        for t in (from_t, to_t):
            if not txn.record_exists(ns, db, t.tb, t.id):
                raise SurrealError(
                    f"Cannot create a relation to a non-existent record `{t}`"
                )
    existing = txn.get_record(ns, db, edge_rid.tb, edge_rid.id)
    if existing is not None:
        # INSERT RELATION duplicate handling (reference insert.rs semantics)
        if getattr(stm, "ignore", False):
            raise IgnoreError()
        update = getattr(stm, "update", None)
        if update is not None:
            from surrealdb_tpu_torch.sql.statements import Data

            sub = _StmView(data=Data("set", update), output=getattr(stm, "output", None))
            return process_update(ctx, edge_rid, existing, sub)
    before = copy_value(existing) if existing is not None else None
    current: dict = dict(existing) if existing is not None else {"id": edge_rid}
    if row:
        current.update(row)
    current = apply_data(ctx, current, getattr(stm, "data", None), edge_rid)
    current["id"] = edge_rid
    current["in"] = from_t
    current["out"] = to_t
    current = process_field_defs(ctx, edge_rid, current, before or {}, is_create=existing is None)
    _check_record_perm(ctx, edge_rid, current, "create" if existing is None else "update")
    from surrealdb_tpu_torch.idx.index import index_document

    store_record(ctx, edge_rid, current)
    store_edges(ctx, edge_rid, from_t, to_t)
    index_document(ctx, edge_rid, before, current)
    _emit_mutation(ctx, edge_rid, before, current, "CREATE" if existing is None else "UPDATE")
    return pluck_output(ctx, stm, edge_rid, before, current)


class _StmView:
    """Minimal statement facade for nested pipeline calls."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __getattr__(self, name):
        return None
