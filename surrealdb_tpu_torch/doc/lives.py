"""Live-query evaluation on mutation.

Role of the reference's process_table_lives (reference:
core/src/doc/lives.rs:18-252): for every LIVE SELECT registered on the
mutated table, re-check its WHERE clause against the document and emit a
Notification through the executor's buffer (delivered on commit).
"""

from __future__ import annotations

from surrealdb_tpu_torch.dbs.notification import Notification
from surrealdb_tpu_torch.sql.value import NONE, copy_value, truthy


def emit_live_notification(ctx, lq: dict, rid, before, after, action: str) -> None:
    doc_v = after if action != "DELETE" else before
    if doc_v is None:
        return

    cond = lq.get("cond")
    if cond is not None:
        with ctx.with_doc_value(doc_v, rid=rid) as c:
            if not truthy(cond.compute(c)):
                # if it matched before an UPDATE but no longer does, emit DELETE
                if action == "UPDATE" and before is not None:
                    with ctx.with_doc_value(before, rid=rid) as cb:
                        if truthy(cond.compute(cb)):
                            _emit(ctx, lq, rid, before, "DELETE")
                return

    _emit(ctx, lq, rid, doc_v, action)


def _emit(ctx, lq: dict, rid, doc_v, action: str) -> None:
    if lq.get("diff"):
        from .pipeline import diff_patch

        result = diff_patch({}, doc_v) if action == "CREATE" else doc_v
    else:
        fields = lq.get("fields")
        if fields:
            from surrealdb_tpu_torch.dbs.iterator import project_fields

            with ctx.with_doc_value(doc_v, rid=rid) as c:
                result = project_fields(c, fields, doc_v, rid, value_mode=False)
        else:
            result = copy_value(doc_v)
    ctx.notify(Notification(lq["id"], action, rid, result))
