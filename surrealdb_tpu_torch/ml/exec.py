"""ML model execution (ml::name<version>(args)) + import/export.

Role of the reference's Model::compute + ml import surface (reference:
core/src/sql/model.rs:37, src/net/ml.rs, src/cli/ml/). Weights persist as
content-addressed blobs (obs.py); execution compiles the spec once per
datastore (cache below) and runs batched rows as ONE device dispatch on the
Datastore's device (ml/model.py CompiledModel.forward, K10's kernels) — the
path of BASELINE config 5 (model scored over a full-table scan). Mirrors
surrealdb_tpu/ml/exec.py.
"""

from __future__ import annotations

from surrealdb_tpu_torch.utils import locks as _locks
from typing import Any, Optional

import numpy as np

from surrealdb_tpu_torch.err import SurrealError
from surrealdb_tpu_torch.obs import get_blob, put_blob

from .model import CompiledModel, spec_from_bytes, spec_to_bytes, validate_spec

_cache_lock = _locks.Lock("ml.cache")


def _model_cache(ds) -> dict:
    cache = getattr(ds, "_ml_cache", None)
    if cache is None:
        with _cache_lock:
            cache = getattr(ds, "_ml_cache", None)
            if cache is None:
                cache = {}
                ds._ml_cache = cache
    return cache


def invalidate(ds, ns: str, db: str, name: str, version: str) -> None:
    _model_cache(ds).pop((ns, db, name, version), None)


def invalidate_db(ds, ns: str, db: str) -> None:
    """Drop every compiled model of one database (REMOVE DATABASE) so a
    recreated database can't serve deleted weights from the cache."""
    cache = _model_cache(ds)
    for k in [k for k in cache if k[:2] == (ns, db)]:
        cache.pop(k, None)


def invalidate_ns(ds, ns: str) -> None:
    """Drop every compiled model of one namespace (REMOVE NAMESPACE)."""
    cache = _model_cache(ds)
    for k in [k for k in cache if k[0] == ns]:
        cache.pop(k, None)


def import_model(ds, session, name: str, version: str, spec: dict) -> dict:
    """Validate + persist a model (spec dict with weights) and register it
    in the catalog. Returns the stored catalog entry."""
    spec = validate_spec(spec)
    raw = spec_to_bytes(spec)
    ns, db = session.ns, session.db
    if not (ns and db):
        raise SurrealError("Model import requires a namespace and database")
    txn = ds.transaction(True)
    try:
        digest = put_blob(txn, ns, db, raw)
        entry = txn.get_ml(ns, db, name, version) or {
            "name": name,
            "version": version,
            "permissions": None,
            "comment": None,
        }
        entry["blob"] = digest
        probe = CompiledModel(spec)
        entry["in_dim"] = int(probe.in_dim)
        entry["out_dim"] = int(probe.out_dim)
        txn.put_ml(ns, db, name, version, entry)
        txn.commit()
    except BaseException:
        if not txn.done:
            txn.cancel()
        raise
    invalidate(ds, ns, db, name, version)
    return entry


def import_surml(ds, session, raw: bytes, name: str = "", version: str = "") -> dict:
    """Import a surrealml `.surml` file (reference tests/*.surml fixtures):
    parse the container, validate the embedded ONNX graph, persist. Name and
    version default to the header's."""
    from .surml import parse_surml

    meta = parse_surml(raw)
    spec = {
        "format": "onnx",
        "onnx": meta["onnx"],
        "keys": meta["keys"],
        "normalisers": meta["normalisers"],
        "output": meta["output"],
        "header": {
            "name": meta["name"],
            "version": meta["version"],
            "description": meta["description"],
            "engine": meta["engine"],
        },
    }
    return import_model(
        ds, session, name or meta["name"], version or meta["version"], spec
    )


def export_model(ds, session, name: str, version: str) -> dict:
    """Return the stored spec (weights as nested lists, json-safe)."""
    ns, db = session.ns, session.db
    txn = ds.transaction(False)
    try:
        entry = txn.get_ml(ns, db, name, version)
        if entry is None or not entry.get("blob"):
            raise SurrealError(f"The model 'ml::{name}<{version}>' does not exist")
        raw = get_blob(txn, ns, db, entry["blob"])
    finally:
        txn.cancel()
    spec = spec_from_bytes(raw)
    if spec["format"] == "onnx":
        import base64

        return {
            "name": name,
            "version": version,
            "format": "onnx",
            "keys": spec.get("keys") or [],
            "onnx_base64": base64.b64encode(spec["onnx"]).decode(),
        }
    return {
        "name": name,
        "version": version,
        "format": spec["format"],
        "layers": [
            {
                "w": layer["w"].tolist(),
                "b": layer["b"].tolist(),
                "activation": layer["activation"],
            }
            for layer in spec["layers"]
        ],
    }


def _compiled(ctx, ns, db, name, version) -> CompiledModel:
    ds = ctx.ds()
    cache = _model_cache(ds)
    key = (ns, db, name, version)
    cm = cache.get(key)
    if cm is not None:
        return cm
    txn = ctx.txn()
    entry = txn.get_ml(ns, db, name, version)
    if entry is None:
        raise SurrealError(f"The model 'ml::{name}<{version}>' does not exist")
    blob = entry.get("blob")
    if blob is None:
        raise SurrealError(f"The model 'ml::{name}<{version}>' has no stored weights")
    raw = get_blob(txn, ns, db, blob)
    if raw is None:
        raise SurrealError(f"The model 'ml::{name}<{version}>' weights are missing")
    cm = CompiledModel(spec_from_bytes(raw))
    cache[key] = cm
    return cm


def _rows_from_arg(arg, in_dim: int):
    """Accept one row (list of numbers / object of numbers) or a batch
    (list of rows). Returns ([N, D] float32, batched?). A packed vector (a
    numpy array, as INSERT stores an array-valued field) counts as the list
    it holds."""
    if isinstance(arg, np.ndarray):
        arg = arg.tolist()
    if isinstance(arg, dict):
        arg = [float(v) for v in arg.values()]
    if not isinstance(arg, (list, tuple)) or not arg:
        raise SurrealError("ml:: argument must be a number array or array of arrays")
    first = arg[0]
    if isinstance(first, (list, tuple)):
        mat = np.asarray([[float(v) for v in row] for row in arg], dtype=np.float32)
        batched = True
    else:
        mat = np.asarray([[float(v) for v in arg]], dtype=np.float32)
        batched = False
    if mat.shape[1] != in_dim:
        raise SurrealError(
            f"ml:: input has {mat.shape[1]} features, model expects {in_dim}"
        )
    return mat, batched


def check_model_permission(ctx, ns: str, db: str, name: str, version: str) -> None:
    """Model execution permission for record-access / guest sessions
    (reference: core/src/sql/model.rs:83-99 Model::compute check). A model
    defined without a PERMISSIONS clause is FULL (the reference's
    Permission::default); PERMISSIONS NONE denies non-system sessions."""
    from surrealdb_tpu_torch.iam.check import evaluate_permission, perms_apply

    if not perms_apply(ctx):
        return
    entry = ctx.txn().get_ml(ns, db, name, version)
    perms = (entry or {}).get("permissions")
    if perms is None:
        return
    rule = perms.get("select", "NONE") if isinstance(perms, dict) else perms
    doc = ctx.doc
    rid = doc.rid if doc is not None else None
    val = doc.current if doc is not None else None
    if not evaluate_permission(ctx, rule, rid, val):
        raise SurrealError(
            f"The model 'ml::{name}<{version}>' does not allow execution for this session"
        )


def run_model(ctx, name: str, version: str, args):
    ns, db = ctx.ns_db()
    cm = _compiled(ctx, ns, db, name, version)
    check_model_permission(ctx, ns, db, name, version)
    if len(args) != 1:
        raise SurrealError("ml:: calls take exactly one argument")
    arg = args[0]
    # surml buffered compute: an object argument against an onnx spec with
    # column keys maps through `keys` order with per-column normalisers and
    # denormalises the output (reference surrealml buffered_compute)
    keys = cm.spec.get("keys") if cm.spec.get("format") == "onnx" else None
    if keys and isinstance(arg, dict):
        from .surml import denormalise, normalise

        norms = cm.spec.get("normalisers") or {}
        row = []
        for k in keys:
            if k not in arg:
                raise SurrealError(f"ml:: input object is missing key {k!r}")
            row.append(normalise(float(arg[k]), norms.get(k)))
        out = cm.forward(np.asarray([row], dtype=np.float32), ctx.ds().device)
        oname_norm = cm.spec.get("output")
        onorm = oname_norm[1] if oname_norm else None
        if cm.out_dim == 1:
            return denormalise(float(out[0, 0]), onorm)
        return [denormalise(float(x), onorm) for x in out[0]]
    mat, batched = _rows_from_arg(arg, cm.in_dim)
    out = cm.forward(mat, ctx.ds().device)
    if cm.out_dim == 1:
        vals = [float(v) for v in out[:, 0]]
    else:
        vals = [[float(x) for x in row] for row in out]
    return vals if batched else vals[0]


def run_model_batch(ctx, name: str, version: str, per_row_args: dict) -> dict:
    """Collected per-row arguments → ONE device dispatch (BASELINE config 5:
    model scored over a full-table scan). `per_row_args` maps row index →
    what that row's ml:: argument evaluated to (a feature vector, or itself
    a batch). Rows whose argument doesn't convert are silently dropped from
    the result — they fall back to the inline per-row path, which raises
    only if the call is actually reached (it may sit under a conditional).
    Returns {row index: result} with the same single/batch shape run_model
    would have produced row-by-row."""
    ns, db = ctx.ns_db()
    cm = _compiled(ctx, ns, db, name, version)
    check_model_permission(ctx, ns, db, name, version)
    spans = []  # (row index, start, count, batched)
    mats = []
    total = 0
    for i, arg in per_row_args.items():
        try:
            mat, batched = _rows_from_arg(arg, cm.in_dim)
        except SurrealError:
            continue
        spans.append((i, total, mat.shape[0], batched))
        mats.append(mat)
        total += mat.shape[0]
    if not mats:
        return {}
    out = cm.forward(np.concatenate(mats, axis=0), ctx.ds().device)
    results: dict = {}
    for i, start, count, batched in spans:
        rows = out[start : start + count]
        if cm.out_dim == 1:
            vals = [float(v) for v in rows[:, 0]]
        else:
            vals = [[float(x) for x in row] for row in rows]
        results[i] = vals if batched else vals[0]
    return results


def try_columnar_ml_scan(ctx, stm, sources):
    """Columnar fast path for `SELECT VALUE ml::m<v>(field) FROM tbl`:
    when `field` is vector-indexed, the feature column already lives
    device-resident in the index mirror — score the WHOLE table in one
    forward over that matrix; rows never round-trip through Python
    (BASELINE config 5; the reference runs Model::compute per document,
    core/src/sql/model.rs). Returns the result list, or None when the
    statement shape / snapshot state makes the path inapplicable — falling
    back is always just an execution-strategy change.

    Applicability: single full-table source; VALUE-mode projection that is
    exactly one ml:: call on a simple field; no WHERE/GROUP/SPLIT/ORDER/
    LIMIT/START/FETCH/OMIT; a ready HNSW/MTREE index on that field; a bare
    statement whose snapshot IS the latest commit, with no uncommitted
    writes (the mirror only holds latest committed state — inside
    BEGIN..COMMIT or against an older snapshot the row path preserves
    snapshot isolation); not a permission-filtered session (per-row
    PERMISSIONS must see each document); and the mirror covers every table
    row (records missing the field would silently vanish instead of
    erroring per-row).

    Results come back in table key order (matching the row path) and, on
    the card, are computed from the mirror's compute dtype (bf16 features,
    read as bf16 by K10 and accumulated in f32 — the same numerical policy
    as the distance kernels; a CPU Datastore keeps full f32).
    """
    from surrealdb_tpu_torch import key as keys
    from surrealdb_tpu_torch.dbs.iterator import ITable
    from surrealdb_tpu_torch.iam.check import perms_apply
    from surrealdb_tpu_torch.idx.knn import VectorMirror
    from surrealdb_tpu_torch.key.encode import prefix_end
    from surrealdb_tpu_torch.sql.ast import ModelCall
    from surrealdb_tpu_torch.sql.path import Idiom

    if len(sources) != 1 or not isinstance(sources[0], ITable):
        return None
    if not getattr(stm, "value_mode", False) or len(stm.fields) != 1:
        return None
    f = stm.fields[0]
    if getattr(f, "all", False):
        return None
    call = f.expr
    if not isinstance(call, ModelCall) or len(call.args) != 1:
        return None
    arg = call.args[0]
    if not isinstance(arg, Idiom) or arg.simple_name() is None:
        return None
    for attr in ("cond", "group", "split", "order", "limit", "start", "fetch", "omit"):
        if getattr(stm, attr, None):
            return None
    if getattr(stm, "group_all", False) or perms_apply(ctx):
        return None
    if getattr(ctx.executor, "explicit", False):
        return None  # inside BEGIN..COMMIT: snapshot may predate the mirror
    txn = ctx.txn()
    if getattr(txn.tr, "writes", None):
        return None  # uncommitted writes are invisible to the mirror
    # the mirror holds LATEST committed state; serve only a snapshot that
    # is the latest commit (a concurrent commit between this txn's open and
    # now would otherwise leak future values into an older read snapshot)
    snap = getattr(txn.tr, "snapshot", None)
    store_v = getattr(getattr(txn.tr, "store", None), "version", None)
    if snap is None or store_v is None or snap != store_v:
        return None
    ns, db = ctx.ns_db()
    tb = sources[0].tb
    field_txt = repr(arg)
    ix = None
    for cand in txn.all_tb_indexes(ns, db, tb):
        if (
            cand["index"].get("type") in ("hnsw", "mtree")
            and cand.get("status", "ready") == "ready"
            and cand["fields"]
            and repr(cand["fields"][0]) == field_txt
        ):
            ix = cand
            break
    if ix is None:
        return None

    ds = ctx.ds()
    mirror = ds.index_stores.get_or_create(ns, db, tb, ix["name"], VectorMirror)
    mirror.ensure_built(ctx, ix)
    # completeness: every table row must be in the mirror. The O(N) key
    # count is cached per (mirror gen, committed store version) — any
    # commit or mirror mutation invalidates it.
    cache_key = (mirror.gen, store_v)
    cached = getattr(mirror, "_columnar_rows", None)
    if cached is not None and cached[0] == cache_key:
        n_rows = cached[1]
    else:
        pre = keys.thing_prefix(ns, db, tb)
        n_rows = sum(1 for _ in txn.keys(pre, prefix_end(pre)))
        mirror._columnar_rows = (cache_key, n_rows)
    if mirror.count() != n_rows:
        return None

    # NOTE: no model PERMISSIONS check needed — the path already bailed for
    # every session where permissions apply
    cm = _compiled(ctx, ns, db, call.name, call.version)
    from surrealdb_tpu_torch import cnf
    from surrealdb_tpu_torch.key.encode import enc_value_key

    if cnf.TPU_DISABLE:
        data, _norms, rids_live = mirror.host_search_view()
        if data.shape[1] != cm.in_dim:
            return None
        cm.dispatches += 1
        out = cm.forward_host(data)
    else:
        device = ds.device
        matrix, mask, rids = mirror.device_snapshot(device)
        if int(matrix.shape[1]) != cm.in_dim:
            return None
        cm.dispatches += 1
        full = cm._device_fn(device)(matrix).cpu().numpy()
        live = np.nonzero(mask[: full.shape[0]])[0]
        out = full[live]
        rids_live = [rids[int(i)] for i in live]
    # the whole-table forward examined every mirrored row (tenant meter
    # parity with the iterator path's per-chunk rows_scanned tally)
    from surrealdb_tpu_torch import accounting

    accounting.tally(rows_scanned=float(len(rids_live)))
    # table key order (the row path's order): sort by encoded record id
    order = sorted(
        range(len(rids_live)), key=lambda i: enc_value_key(rids_live[i].id)
    )
    # the same Python floats as float() of each f32 value, in one pass
    if cm.out_dim == 1:
        return out[order, 0].tolist()
    return out[order].tolist()
