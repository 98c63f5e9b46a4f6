"""Background index building (DEFINE INDEX … CONCURRENTLY).

Role of the reference's async index builder (reference:
core/src/kvs/index.rs:28-41 — building statuses started/initial/updates/
ready surfaced through INFO FOR INDEX). The build scans the table in
CHUNKED transactions (one short write txn per batch) so it never holds a
long snapshot against concurrent writers; writes that land during the build
index themselves through the normal doc pipeline, and chunk application is
idempotent (index keys are deterministic), so the two paths converge.

While an index is building the planner refuses to serve reads from it
(status != ready → table scan / brute-force kNN), matching the reference.
"""

from __future__ import annotations

from surrealdb_tpu_torch.utils import locks as _locks
import time
from typing import Dict, Optional, Tuple

from surrealdb_tpu_torch import key as keys
from surrealdb_tpu_torch.key.encode import prefix_end
from surrealdb_tpu_torch.sql.value import Thing
from surrealdb_tpu_torch.utils.ser import unpack


class IndexBuilder:
    def __init__(self, ds):
        self.ds = ds
        self._lock = _locks.Lock("idx.builder")
        self._status: Dict[Tuple[str, str, str, str], dict] = {}

    # ------------------------------------------------------------ status
    def status(self, ns: str, db: str, tb: str, name: str) -> Optional[dict]:
        with self._lock:
            st = self._status.get((ns, db, tb, name))
            return dict(st) if st else None

    def _set(self, key, **kw) -> None:
        with self._lock:
            self._status.setdefault(key, {}).update(kw)

    # ------------------------------------------------------------ build
    def build(self, ns: str, db: str, tb: str, ix: dict, session) -> None:
        """Kick a background initial build; returns immediately. Call AFTER
        the defining transaction commits (on_commit hook) so the builder's
        transactions see the index definition."""
        key = (ns, db, tb, ix["name"])
        with self._lock:
            if self._status.get(key, {}).get("status") in ("started", "indexing"):
                return  # already building
            self._status[key] = {"status": "started", "count": 0}
        from surrealdb_tpu_torch import bg

        task_id = bg.register(
            "index_build", target=f"{tb}.{ix['name']}", owner=id(self.ds)
        )
        bg.start_thread(task_id, self._run, key, ns, db, tb, ix, session, task_id)

    def _ctx(self, session):
        """Fresh executor + write txn + context for one build chunk."""
        from surrealdb_tpu_torch.dbs.context import Context
        from surrealdb_tpu_torch.dbs.executor import Executor

        ex = Executor(self.ds, session, {})
        ex.txn = self.ds.transaction(write=True)
        return Context(ex, session), ex.txn

    _RETRIES = 5

    def _chunk_txn(self, key, session, fn) -> None:
        """Run one build step in its own short txn, retrying on write
        conflicts (first-committer-wins backend) with backoff."""
        from surrealdb_tpu_torch.err import TxConflictError

        for attempt in range(self._RETRIES):
            ctx, txn = self._ctx(session)
            try:
                out = fn(ctx, txn)
                txn.commit()
                return out
            except TxConflictError:
                txn.cancel()
                if attempt == self._RETRIES - 1:
                    raise
                time.sleep(0.01 * (2**attempt))
            except BaseException:
                txn.cancel()
                raise

    def _run(self, key, ns, db, tb, ix, session, task_id=None) -> None:
        from surrealdb_tpu_torch import bg

        if task_id is None:
            task_id = bg.register("index_build", target=f"{tb}.{ix['name']}")
        with bg.run(task_id):
            self._run_inner(key, ns, db, tb, ix, session)

    def _run_inner(self, key, ns, db, tb, ix, session) -> None:
        from surrealdb_tpu_torch.idx.index import extract_index_values, _apply

        name = ix["name"]
        try:
            self._set(key, status="indexing")
            # wipe any previous definition's entries + mirror first (like
            # rebuild_index): a DEFINE INDEX OVERWRITE ... CONCURRENTLY must
            # not leave old-field entries under the same prefix. The planner
            # refuses reads while status != ready, so nothing serves the gap.
            pre_ix = keys.index_prefix(ns, db, tb, name)

            def wipe(ctx, txn):
                txn.delr(pre_ix, prefix_end(pre_ix))

            self._chunk_txn(key, session, wipe)
            self.ds.index_stores.remove(ns, db, tb, name)

            count = 0
            rpre = keys.thing_prefix(ns, db, tb)
            cursor = rpre
            end = prefix_end(rpre)
            batch = 1000
            while True:
                state = {"chunk": None}

                def step(ctx, txn):
                    chunk = list(txn.scan(cursor, end, batch))
                    state["chunk"] = chunk
                    for k, v in chunk:
                        doc = unpack(v)
                        rid = Thing(tb, keys.decode_thing_id(k, ns, db, tb))
                        new_vals = extract_index_values(ctx, ix, doc)
                        _apply(ctx, ix, rid, None, new_vals)

                self._chunk_txn(key, session, step)
                chunk = state["chunk"]
                if not chunk:
                    break
                count += len(chunk)
                cursor = chunk[-1][0] + b"\x00"
                self._set(key, count=count)

            self._flip_status(key, session, ns, db, tb, name, "ready")
            self._set(key, status="ready", count=count, finished=time.time())
            # the index just became servable: cached plans (and prefetched
            # index defs) that planned without it are now stale
            self.ds.plan_cache.bump_generation(ns, db)
        except Exception as e:  # surface failures through INFO — both
            # the live status and the persisted def (so a stuck 'building'
            # never lies about an aborted build)
            self._set(key, status="error", error=str(e))
            try:
                self._flip_status(key, session, ns, db, tb, name, "error")
            except Exception as e2:
                # the live status already says error; keep the secondary
                # failure visible instead of erasing it
                self._set(key, flip_error=str(e2))
        except BaseException as e:
            # shutdown-class (KeyboardInterrupt/SystemExit/injected panic):
            # record the aborted build, then PROPAGATE — bg.run marks the
            # task failed and the interpreter keeps its shutdown signal
            self._set(key, status="error", error=str(e))
            raise

    def _flip_status(self, key, session, ns, db, tb, name, status: str) -> None:
        def flip(ctx, txn):
            d = txn.get_tb_index(ns, db, tb, name)
            if d is not None:
                d["status"] = status
                txn.put_tb_index(ns, db, tb, name, d)

        self._chunk_txn(key, session, flip)
