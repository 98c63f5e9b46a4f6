"""Changefeed garbage collection.

Role of the reference's cf GC (reference: core/src/cf/gc.rs — per-database
watermark = now minus the longest CHANGEFEED retention among the database
and its tables; change entries older than the watermark are deleted on the
node tick)."""

from __future__ import annotations

from typing import List, Tuple

from surrealdb_tpu_torch import key as keys
from surrealdb_tpu_torch.key.encode import prefix_end
from surrealdb_tpu_torch.utils.ser import unpack


def gc_all(ds) -> int:
    """One GC sweep over every database; returns entries deleted. Each
    sweep is a flight-recorder task (bg.py): the server tick loop runs it
    unsupervised, so a wedged sweep must surface as `stalled`, not as an
    unexplained commit-lock stall."""
    from surrealdb_tpu_torch import bg

    task_id = bg.register(
        "changefeed_gc", target=ds.path, owner=id(ds), trace_id=None
    )
    deleted = 0
    with bg.run(task_id, rename_thread=False):
        from surrealdb_tpu_torch import faults

        # chaos hook: a GC sweep that dies must surface through the task
        # registry (failed) and the tick loop's supervision — never wedge
        # the commit lock or leak its transaction
        faults.fire("cf.gc")
        txn = ds.transaction(write=True)
        try:
            now = ds.clock.now_nanos()
            for ns_def in txn.all_ns():
                ns = ns_def["name"]
                for db_def in txn.all_db(ns):
                    db = db_def["name"]
                    retention = _max_retention(txn, ns, db, db_def)
                    if retention is None:
                        continue
                    watermark = now - retention
                    deleted += _gc_db(txn, ns, db, watermark)
            if deleted:
                txn.commit()
            else:
                txn.cancel()
        except BaseException:
            txn.cancel()
            raise
    if not deleted:
        # an uneventful sweep (the overwhelmingly common case on the 10s
        # tick) must not flood the bounded finished-task ring
        bg.forget(task_id)
    return deleted


def _max_retention(txn, ns: str, db: str, db_def: dict):
    """Longest retention among the db's own CHANGEFEED and its tables'."""
    out = None
    cf = db_def.get("changefeed")
    if cf:
        out = cf.get("expiry", 0)
    for tb_def in txn.all_tb(ns, db):
        cf = tb_def.get("changefeed")
        if cf:
            e = cf.get("expiry", 0)
            out = e if out is None else max(out, e)
    return out


def _gc_db(txn, ns: str, db: str, watermark: int) -> int:
    pre = keys.change_prefix(ns, db)
    dead: List[bytes] = []
    for k, raw in txn.scan(pre, prefix_end(pre)):
        entry = unpack(raw)
        ts = entry.get("ts")
        if ts is None:
            continue  # pre-timestamp entries: never GC'd (age unknown)
        if ts >= watermark:
            break  # vs-ordered keys are time-ordered; the rest is retained
        dead.append(k)
    for k in dead:
        txn.delete(k)
    return len(dead)
