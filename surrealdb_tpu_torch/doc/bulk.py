"""Bulk INSERT fast path.

Role of the reference's batched indexing writes (reference:
core/src/cnf/mod.rs:44 INDEXING_BATCH_SIZE; doc/insert.rs per-row flow):
`INSERT INTO t $rows` resolves table state — definitions, field defs,
indexes, changefeed, reactive hooks — ONCE per statement instead of once per
row, then applies record + index writes in vectorized batches:

- vector (HNSW/MTREE) indexes convert the whole [B, D] block in one numpy
  pass instead of per-element coercion loops;
- full-text (SEARCH) indexes tokenize per document but merge term metadata
  and statistics across the batch, turning 2 read-modify-writes per (term,
  doc) into one per distinct term per batch;
- plain/unique indexes keep per-row writes (they are pure KV ops) with the
  same IGNORE-on-unique-conflict savepoint semantics as the per-row path.

The fast path only engages when it is semantically identical to the per-row
document pipeline: no live queries, no events, no ON DUPLICATE KEY UPDATE,
owner-level permissions, and AFTER/NONE output. Anything else falls back.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch import key as keys
from surrealdb_tpu_torch.err import IndexExistsError, RecordExistsError, TypeError_
from surrealdb_tpu_torch.key.encode import T_THING, enc_value_key
from surrealdb_tpu_torch.sql.value import NONE, Thing, is_nullish
from surrealdb_tpu_torch.utils.ser import pack


def try_bulk_insert(ctx, stm, rows: List[dict], into_tb: Optional[str]):
    """Bulk-run an INSERT statement; returns the output rows, or None when
    the statement or any target table needs the per-row pipeline."""
    from surrealdb_tpu_torch.iam.check import check_data_write, perms_apply

    if len(rows) < cnf.BULK_INSERT_MIN:
        return None
    if getattr(stm, "update", None) is not None:
        return None
    output = getattr(stm, "output", None)
    out_kind = "after" if output is None else output.kind
    if out_kind not in ("after", "none"):
        return None
    check_data_write(ctx)
    if perms_apply(ctx):
        return None

    relation = bool(getattr(stm, "relation", False))
    ignore = bool(getattr(stm, "ignore", False))

    # group rows by target table, preserving statement order per table
    by_tb: Dict[str, List[Tuple[Thing, dict]]] = {}
    order: List[Tuple[str, int]] = []  # (tb, index within table batch)
    for row in rows:
        row = dict(row)
        rid_v = row.pop("id", None)
        tb = into_tb or (rid_v.tb if isinstance(rid_v, Thing) else None)
        if tb is None:
            raise TypeError_(
                "INSERT RELATION requires a target table"
                if relation
                else "INSERT requires a target table"
            )
        if relation:
            f, w = row.get("in"), row.get("out")
            if not isinstance(f, Thing) or not isinstance(w, Thing):
                raise TypeError_("INSERT RELATION requires `in` and `out` record links")
        rid = _make_rid(tb, rid_v)
        batch = by_tb.setdefault(tb, [])
        order.append((tb, len(batch)))
        batch.append((rid, row))

    txn = ctx.txn()
    ns, db = ctx.ns_db()

    # eligibility per table — checked BEFORE any mutation so fallback is clean
    plans = {}
    for tb in by_tb:
        if (
            txn.all_tb_lives(ns, db, tb)
            or txn.all_tb_events(ns, db, tb)
            or txn.all_tb_views(ns, db, tb)  # views need per-row maintenance
        ):
            return None
        plans[tb] = _TablePlan(ctx, tb)

    results: Dict[str, List[Any]] = {}
    for tb, batch in by_tb.items():
        results[tb] = _insert_table_batch(
            ctx, plans[tb], batch, relation=relation, ignore=ignore, out_kind=out_kind
        )

    if out_kind == "none":
        return []
    out: List[Any] = []
    for tb, i in order:
        v = results[tb][i]
        if v is not _SKIPPED:
            out.append(v)
    return out


_SKIPPED = object()  # row dropped by IGNORE


def try_bulk_relate(ctx, stm, pairs, edge_tb: str):
    """Bulk-run a RELATE statement's endpoint product through the edge
    writer (`_EdgeWriter`) — the same fast path INSERT RELATION takes.
    `pairs` is the [(from, with), ...] product; returns output rows, or
    None when the statement shape needs the per-row pipeline. Non-UNIQUE,
    AFTER/NONE-output RELATEs over an eligible table qualify; a
    SET/CONTENT clause joins the bulk path when it PROVABLY cannot differ
    per edge — no $in/$out (or any per-doc context), no field reads, no
    function calls — in which case it is evaluated ONCE and stamped onto
    every edge (exactly what the per-row pipeline would have computed N
    times). Anything else (UNIQUE needs the existing-edge probe, an
    edge-dependent clause needs per-edge evaluation) falls back."""
    from surrealdb_tpu_torch.iam.check import check_data_write, perms_apply

    if len(pairs) < cnf.BULK_INSERT_MIN:
        return None
    payload = None
    data = getattr(stm, "data", None)
    if data is not None:
        payload = _relate_bulk_payload(ctx, data)
        if payload is None:
            return None
    if getattr(stm, "uniq", False) or getattr(stm, "only", False):
        return None
    output = getattr(stm, "output", None)
    out_kind = "after" if output is None else output.kind
    if out_kind not in ("after", "none"):
        return None
    check_data_write(ctx)
    if perms_apply(ctx):
        return None
    txn = ctx.txn()
    ns, db = ctx.ns_db()
    if (
        txn.all_tb_lives(ns, db, edge_tb)
        or txn.all_tb_events(ns, db, edge_tb)
        or txn.all_tb_views(ns, db, edge_tb)
    ):
        return None
    plan = _TablePlan(ctx, edge_tb)
    if payload:
        import copy

        # nested containers must not be SHARED across edges (field defs /
        # later UPDATEs would alias them); per-row evaluation made a fresh
        # value per edge, so the bulk stamp deep-copies per edge too
        deep = any(isinstance(v, (list, dict)) for v in payload.values())
        batch = [
            (
                Thing(edge_tb),
                {
                    **(copy.deepcopy(payload) if deep else payload),
                    "in": f,
                    "out": w,
                },
            )
            for f, w in pairs
        ]
    else:
        batch = [(Thing(edge_tb), {"in": f, "out": w}) for f, w in pairs]
    out = _insert_table_batch(
        ctx, plan, batch, relation=True, ignore=False, out_kind=out_kind
    )
    if out_kind == "none":
        return []
    return [v for v in out if v is not _SKIPPED]


# parameters the doc pipeline binds per edge/doc: an expression touching
# any of these can differ per edge and must take the per-row path
_RELATE_DOC_PARAMS = frozenset(
    {"in", "out", "this", "parent", "before", "after", "value", "input", "event"}
)


def _edge_independent(expr) -> bool:
    """True when `expr` provably evaluates to the SAME value for every
    edge of the statement: literals, statement-level $params, and
    array/object/binary/unary compositions thereof. Field reads, graph
    idioms, subqueries and function calls (rand(), time::now(), ...) all
    fail the proof — conservatively, anything unrecognized does."""
    from surrealdb_tpu_torch.sql.ast import (
        ArrayLit,
        BinaryOp,
        Constant,
        Literal,
        ObjectLit,
        Param,
        ThingLit,
        UnaryOp,
    )

    if isinstance(expr, (Literal, Constant)):
        return True
    if isinstance(expr, Param):
        return expr.name not in _RELATE_DOC_PARAMS
    if isinstance(expr, ThingLit):
        # record-id literals with expression id parts (person:uuid()) are
        # per-evaluation values; plain ids and literal/param id exprs
        # qualify
        from surrealdb_tpu_torch.sql.ast import Expr as _Expr

        if not isinstance(expr.id, _Expr):
            return True
        return _edge_independent(expr.id)
    if isinstance(expr, ArrayLit):
        return all(_edge_independent(i) for i in expr.items)
    if isinstance(expr, ObjectLit):
        return all(_edge_independent(v) for _, v in expr.pairs)
    if isinstance(expr, UnaryOp):
        return _edge_independent(expr.expr)
    if isinstance(expr, BinaryOp):
        return _edge_independent(expr.l) and _edge_independent(expr.r)
    return False


def _relate_bulk_payload(ctx, data) -> Optional[dict]:
    """Evaluate an edge-independent SET/CONTENT clause ONCE; returns the
    field dict to stamp on every edge, or None when the clause needs the
    per-row pipeline. `id`/`in`/`out` keys are dropped — the per-row
    pipeline forcibly overwrites them after apply_data, so stamping the
    endpoints per pair preserves its semantics exactly."""
    from surrealdb_tpu_torch.sql.path import PField

    if data.kind == "set":
        payload: dict = {}
        for idiom, op, expr in data.items:
            parts = getattr(idiom, "parts", None)
            if (
                op != "="
                or not parts
                or len(parts) != 1
                or not isinstance(parts[0], PField)
                or parts[0].name in ("id", "in", "out")
                or not _edge_independent(expr)
            ):
                return None
            payload[parts[0].name] = expr.compute(ctx)
        return payload
    if data.kind == "content":
        items = data.items
        if hasattr(items, "compute"):
            if not _edge_independent(items):
                return None
            v = items.compute(ctx)
        else:
            v = items
        if not isinstance(v, dict):
            return None  # per-row path raises the precise CONTENT error
        return {k: val for k, val in v.items() if k not in ("id", "in", "out")}
    return None


class _TablePlan:
    """Per-table state resolved once per bulk statement."""

    def __init__(self, ctx, tb: str):
        txn = ctx.txn()
        ns, db = ctx.ns_db()
        self.tb = tb
        self.tb_def = txn.ensure_tb(ns, db, tb)
        self.fds = txn.all_tb_fields(ns, db, tb)
        self.schemafull = bool(self.tb_def.get("schemafull"))
        self.needs_fields = bool(self.fds) or self.schemafull
        db_def = txn.get_db(ns, db)
        self.cf = self.tb_def.get("changefeed") or (db_def or {}).get("changefeed")
        self.cf_original = bool(self.cf and self.cf.get("original"))
        self.indexes = txn.all_tb_indexes(ns, db, tb)
        self.thing_pre = keys.thing_prefix(ns, db, tb)
        self.enforced = bool(self.tb_def.get("enforced"))


def _insert_table_batch(ctx, plan: _TablePlan, batch, relation, ignore, out_kind):
    from surrealdb_tpu_torch.doc import pipeline as doc
    from surrealdb_tpu_torch.idx.index import (
        _update_idx,
        _update_uniq,
        extract_index_values,
    )

    txn = ctx.txn()
    ns, db = ctx.ns_db()
    tb = plan.tb
    # record keyspace written with raw sets below — register the table for
    # columnar-mirror invalidation (set_record would have done this). The
    # bulk variant keeps the write-set representable as a column delta.
    txn.touch_table_bulk(ns, db, tb)
    # Edge batches re-reference the same endpoint Things E/N times; memoize
    # their msgpack ext encoding so the record serializer packs each endpoint
    # once per batch instead of once per edge (a nested packb call per Thing).
    _ext_memo: Dict[Tuple[str, Any], Any] = {}

    def _thing_ext(t: Thing):
        import msgpack

        from surrealdb_tpu_torch.utils.ser import EXT_THING

        try:
            hit = _ext_memo.get((t.tb, t.id))
        except TypeError:  # unhashable id — pack directly
            return msgpack.ExtType(EXT_THING, pack({"tb": t.tb, "id": t.id}))
        if hit is None:
            hit = _ext_memo[(t.tb, t.id)] = msgpack.ExtType(
                EXT_THING, pack({"tb": t.tb, "id": t.id})
            )
        return hit

    kv_ix = [ix for ix in plan.indexes if ix["index"]["type"] in ("idx", "uniq")]
    vec_ix = [ix for ix in plan.indexes if ix["index"]["type"] in ("mtree", "hnsw")]
    ft_ix = [ix for ix in plan.indexes if ix["index"]["type"] == "search"]
    # plain single-field idioms (`FIELDS emb`) skip the per-row
    # with_doc_value + get_path walk: a dict lookup is ~4x cheaper and
    # exactly get_path's dict semantics (missing -> NONE)
    fast_fields = {ix["name"]: _fast_extractor(ix) for ix in vec_ix + ft_ix}

    def _extract(ix, current):
        names = fast_fields.get(ix["name"])
        if names is not None:
            return [current.get(n, NONE) for n in names]
        return extract_index_values(ctx, ix, current)
    vec_batch: Dict[str, List[Tuple[Thing, Any]]] = {ix["name"]: [] for ix in vec_ix}
    ft_batch: Dict[str, List[Tuple[Thing, Any]]] = {ix["name"]: [] for ix in ft_ix}
    edge_writer = _EdgeWriter(ctx, tb) if relation else None
    # mirror delta-feed: when this table is already column-mirrored, hand
    # the decoded rows to the mirror as an append delta at commit instead
    # of arming a full re-scan rebuild (idx/column_mirror.py apply_bulk)
    feed_columns = (
        cnf.COLUMN_DELTA_FEED
        and getattr(txn, "_column_mirrors", None) is not None
        and txn._column_mirrors.get((ns, db, tb)) is not None
    )
    d_ids: List[Any] = []
    d_keys: List[bytes] = []
    d_docs: List[dict] = []
    cf_rids: List[Thing] = []
    cf_batch = plan.cf and cnf.CHANGEFEED_BATCH
    # cluster mode: bulk rows carry the same per-record HLC stamps as the
    # per-row path (kvs/tx.py set_record) — migration/anti-entropy treat
    # bulk-ingested and row-written records identically
    stamp_hlc = txn.hlc_node is not None
    meta_pre = None
    if stamp_hlc:
        from surrealdb_tpu_torch import faults as _faults
        from surrealdb_tpu_torch.cluster import hlc as _hlc

        meta_pre = keys.record_meta_prefix(ns, db, tb)

    out: List[Any] = []
    for rid, row in batch:
        ke = enc_value_key(rid.id)
        kb = plan.thing_pre + ke
        if txn.get(kb) is not None:
            if ignore:
                out.append(_SKIPPED)
                continue
            raise RecordExistsError(rid)
        current = dict(row)
        current["id"] = rid
        if relation:
            f, w = current["in"], current["out"]
            if plan.enforced:
                for t in (f, w):
                    if not txn.record_exists(ns, db, t.tb, t.id):
                        from surrealdb_tpu_torch.err import SurrealError

                        raise SurrealError(
                            f"Cannot create a relation to a non-existent record `{t}`"
                        )
        if plan.needs_fields:
            current = doc.process_field_defs(ctx, rid, current, {}, is_create=True)
            current["id"] = rid

        sp = txn.savepoint() if (kv_ix and ignore) else None
        if relation:
            shadow = dict(current)
            shadow["in"] = _thing_ext(current["in"])
            shadow["out"] = _thing_ext(current["out"])
            txn.set(kb, pack(shadow))
        else:
            txn.set(kb, pack(current))
        if relation:
            edge_writer.write(rid, current["in"], current["out"])
        try:
            for ix in kv_ix:
                vals = extract_index_values(ctx, ix, current)
                if ix["index"]["type"] == "idx":
                    _update_idx(ctx, ix, rid, None, vals)
                else:
                    _update_uniq(ctx, ix, rid, None, vals)
        except IndexExistsError:
            if sp is not None:
                txn.rollback_to(sp)
                out.append(_SKIPPED)
                continue
            raise
        for ix in vec_ix:
            vec_batch[ix["name"]].append((rid, _extract(ix, current)))
        for ix in ft_ix:
            ft_batch[ix["name"]].append((rid, _extract(ix, current)))
        if plan.cf:
            if cf_batch:
                cf_rids.append(rid)  # ONE batch entry after the loop
            else:
                mut: Dict[str, Any] = {"id": rid, "update": current}
                if plan.cf_original:
                    mut["original"] = None
                txn.buffer_change(ns, db, tb, mut)
        if feed_columns:
            d_ids.append(rid.id)
            d_keys.append(ke)
            d_docs.append(current)
        if stamp_hlc:
            _faults.fire("cluster.hlc.stamp")
            txn.set(
                meta_pre + ke,
                pack({"hlc": _hlc.encode(_hlc.now(txn.hlc_node))}),
            )
        out.append(current if out_kind == "after" else _SKIPPED)

    if cf_rids:
        txn.buffer_bulk_change(ns, db, tb, cf_rids)
    if feed_columns and d_ids:
        txn.bulk_column_delta(ns, db, tb, d_ids, d_keys, d_docs)
    for ix in vec_ix:
        _bulk_vector_index(ctx, ix, vec_batch[ix["name"]])
    for ix in ft_ix:
        _bulk_ft_index(ctx, ix, ft_batch[ix["name"]])
    from surrealdb_tpu_torch import telemetry

    telemetry.inc("bulk_insert_batches", kind="relation" if relation else "row")
    telemetry.inc("bulk_insert_rows", by=float(len(batch)))
    return out


def _fast_extractor(ix) -> Optional[List[str]]:
    """Field names when every index idiom is one plain `PField` (no nested
    paths, graph parts or methods) — else None (full get_path per row)."""
    from surrealdb_tpu_torch.sql.path import PField

    names: List[str] = []
    for f in ix["fields"]:
        parts = getattr(f, "parts", None)
        if not parts or len(parts) != 1 or not isinstance(parts[0], PField):
            return None
        names.append(parts[0].name)
    return names


def _make_rid(tb: str, rid_v) -> Thing:
    if isinstance(rid_v, Thing):
        return rid_v if rid_v.tb == tb else Thing(tb, rid_v.id)
    if rid_v is None or is_nullish(rid_v):
        return Thing(tb)
    return Thing(tb, rid_v)


class _EdgeWriter:
    """Batch writer for RELATE graph pointers (same 4 keys + 4 mirror deltas
    as doc.pipeline.store_edges, reference core/src/doc/edges.rs:16-75) with
    per-batch memoized encodings: endpoint Things repeat heavily in edge
    batches (N nodes, E >> N references), so their order-preserving key
    encodings are computed once each instead of once per pointer."""

    def __init__(self, ctx, edge_tb: str):
        self.txn = ctx.txn()
        self.ns, self.db = ctx.ns_db()
        self.edge_tb = edge_tb
        self._gp: Dict[str, bytes] = {}  # tb -> graph keyspace prefix
        self._tbe: Dict[str, bytes] = {}  # tb -> enc_str(tb)
        self._things: Dict[Tuple[str, Any], Tuple[bytes, bytes]] = {}
        self._edge_tb_enc = self._tb_enc(edge_tb)

    def _prefix(self, tb: str) -> bytes:
        p = self._gp.get(tb)
        if p is None:
            p = self._gp[tb] = keys.graph_prefix(self.ns, self.db, tb)
        return p

    def _tb_enc(self, tb: str) -> bytes:
        e = self._tbe.get(tb)
        if e is None:
            from surrealdb_tpu_torch.key.encode import enc_str

            e = self._tbe[tb] = enc_str(tb)
        return e

    def _enc(self, t: Thing) -> Tuple[bytes, bytes]:
        """(enc_value_key(t.id), enc_value_key(t)) — memoized per endpoint."""
        try:
            k = (t.tb, t.id)
            hit = self._things.get(k)
        except TypeError:  # unhashable id (array/object) — encode directly
            ide = enc_value_key(t.id)
            return ide, bytes([T_THING]) + self._tb_enc(t.tb) + ide
        if hit is None:
            ide = enc_value_key(t.id)
            hit = self._things[k] = (ide, bytes([T_THING]) + self._tb_enc(t.tb) + ide)
        return hit

    def write(self, edge: Thing, f: Thing, w: Thing) -> None:
        txn = self.txn
        eid_enc, edge_enc = self._enc(edge)
        fid_enc, f_enc = self._enc(f)
        wid_enc, w_enc = self._enc(w)
        etb = self.edge_tb
        etb_enc = self._edge_tb_enc
        epre = self._prefix(etb)
        txn.set(self._prefix(f.tb) + fid_enc + keys.DIR_OUT + etb_enc + edge_enc, b"")
        txn.set(epre + eid_enc + keys.DIR_IN + self._tb_enc(f.tb) + f_enc, b"")
        txn.set(epre + eid_enc + keys.DIR_OUT + self._tb_enc(w.tb) + w_enc, b"")
        txn.set(self._prefix(w.tb) + wid_enc + keys.DIR_IN + etb_enc + edge_enc, b"")
        ns, db = self.ns, self.db
        txn.graph_delta(ns, db, f.tb, keys.DIR_OUT, etb, f, edge, True)
        txn.graph_delta(ns, db, etb, keys.DIR_IN, f.tb, edge, f, True)
        txn.graph_delta(ns, db, etb, keys.DIR_OUT, w.tb, edge, w, True)
        txn.graph_delta(ns, db, w.tb, keys.DIR_IN, etb, w, edge, True)


# ------------------------------------------------------------------ vector
def _bulk_vector_index(ctx, ix: dict, batch: List[Tuple[Thing, Any]]) -> None:
    """Block-convert a batch of vectors and write index rows + mirror deltas.
    One numpy pass validates/coerces the whole [B, D] block; ragged or
    non-numeric batches fall back to per-row validation for precise errors
    (same checks as idx/vector_index.check_vector)."""
    from surrealdb_tpu_torch.idx.vector_index import _ROW, check_vector, pack_vector

    if not batch:
        return
    txn = ctx.txn()
    ns, db = ctx.ns_db()
    tb, name = ix["table"], ix["name"]
    spre = keys.index_state(ns, db, tb, name, _ROW)
    dim = ix["index"].get("dimension", 0)

    items = [(rid, vals[0]) for rid, vals in batch if vals and not is_nullish(vals[0])]
    if not items:
        return
    vecs: Optional[np.ndarray] = None
    try:
        block = np.asarray([v for _, v in items])
        if (
            block.ndim == 2
            and block.dtype.kind in ("i", "u", "f")
            and (not dim or block.shape[1] == dim)
        ):
            vecs = block.astype(np.float32)
    except (TypeError, ValueError):
        vecs = None
    if vecs is None:
        vecs = np.empty((len(items), dim or len(items[0][1])), dtype=np.float32)
        for i, (rid, v) in enumerate(items):
            arr = check_vector(ix, v)
            if arr is None or arr.shape[0] != vecs.shape[1]:
                raise TypeError_(
                    f"Incorrect vector dimension ({0 if arr is None else arr.shape[0]})."
                    f" Expected a vector of {vecs.shape[1]} dimension."
                )
            vecs[i] = arr

    for (rid, _), vec in zip(items, vecs):
        txn.set(spre + enc_value_key(rid), pack_vector(vec))
    # ONE mirror delta for the whole block: applied via apply_many after
    # commit (one lock hold + one array append instead of B round-trips)
    txn.vector_bulk_delta(ns, db, tb, name, [rid for rid, _ in items], vecs)


# ------------------------------------------------------------------ full-text
def _bulk_ft_index(ctx, ix: dict, batch: List[Tuple[Thing, Any]]) -> None:
    from surrealdb_tpu_torch.idx.ft_index import FtIndex

    if not batch:
        return
    FtIndex.for_index(ctx, ix).index_documents_bulk(ctx, batch)
