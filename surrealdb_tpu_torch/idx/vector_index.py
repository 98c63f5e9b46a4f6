"""Vector index write path (MTREE / HNSW definitions).

Role of the reference's MTreeIndex/HnswIndex index_document (reference:
core/src/idx/trees/mtree.rs:85, trees/hnsw/index.rs:89). TPU-first design:
vectors are persisted row-wise in the KV under the index's state keyspace,
and the device-resident mirror (a padded [N, D] matrix used by the batched
distance/top-k kernels in idx/knn.py) refreshes by generation, mirroring the
reference's TreeCache generation swap (trees/store/cache.rs).
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from surrealdb_tpu_torch import key as keys
from surrealdb_tpu_torch.err import TypeError_
from surrealdb_tpu_torch.key.encode import enc_value_key, dec_value_key, prefix_end
from surrealdb_tpu_torch.sql.value import Thing, is_nullish
from surrealdb_tpu_torch.utils.ser import pack, unpack

_ROW = b"v"  # per-record vector row


def pack_vector(vec) -> bytes:
    """Row storage codec: packed little-endian float32 (the dtype the device
    mirror holds anyway) — ~40% of the msgpack float-list size at 768-d."""
    return pack({"$f32": np.asarray(vec, dtype="<f4").tobytes()})


def unpack_vector(raw: bytes):
    v = unpack(raw)
    if isinstance(v, dict) and "$f32" in v:
        return np.frombuffer(v["$f32"], dtype="<f4")
    return v  # legacy float-list rows


def check_vector(ix: dict, val: Any) -> Optional[np.ndarray]:
    """Validate/coerce a field value into the index's vector shape
    (float32 row, the dtype the KV codec and device mirror hold)."""
    if is_nullish(val) or val is None:
        return None
    if not isinstance(val, (list, tuple)):
        raise TypeError_("Vector index field must be an array of numbers")
    dim = ix["index"].get("dimension", 0)
    if dim and len(val) != dim:
        raise TypeError_(
            f"Incorrect vector dimension ({len(val)}). Expected a vector of {dim} dimension."
        )
    # bulk numeric coercion: one numpy pass replaces a per-element
    # isinstance/float() loop (the hot path of every indexed vector write);
    # dtype is inferred first so strings/objects/all-bool rows are rejected,
    # and a single type() scan catches bools numpy would promote silently
    try:
        arr = np.asarray(val)
    except (TypeError, ValueError):
        raise TypeError_("Vector index field must be an array of numbers")
    if (
        arr.ndim != 1
        or arr.dtype.kind not in ("i", "u", "f")
        or any(type(x) is bool for x in val)
    ):
        raise TypeError_("Vector index field must be an array of numbers")
    return arr.astype(np.float32)


def _row_key(ns, db, tb, name, rid: Thing) -> bytes:
    return keys.index_state(ns, db, tb, name, _ROW + enc_value_key(rid))


def update_vector_index(ctx, ix: dict, rid: Thing, old_vals, new_vals) -> None:
    ns, db = ctx.ns_db()
    txn = ctx.txn()
    tb, name = ix["table"], ix["name"]
    old_vec = check_vector(ix, old_vals[0]) if old_vals else None
    new_vec = check_vector(ix, new_vals[0]) if new_vals else None
    if old_vec is None and new_vec is None:
        return
    k = _row_key(ns, db, tb, name, rid)
    if new_vec is None:
        txn.delete(k)
    else:
        txn.set(k, pack_vector(new_vec))
    # buffered mirror delta, applied on commit (idx/knn.py VectorMirror);
    # a cancelled transaction never touches the shared mirror
    txn.vector_delta(ns, db, tb, name, rid, new_vec)


def scan_vectors(txn, ns, db, tb, name):
    """Yield (rid, vector) rows from the persisted index state."""
    pre = keys.index_state(ns, db, tb, name, _ROW)
    for chunk in txn.batch(pre, prefix_end(pre), 1000):
        for k, v in chunk:
            rid, _ = dec_value_key(k, len(pre))
            yield rid, unpack_vector(v)
