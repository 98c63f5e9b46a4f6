"""Content-addressed blob store inside the KV.

Role of the reference's object store (reference: core/src/obs/mod.rs:20 —
local/S3/GCS object_store holding SHA1-addressed `.surml` files). Here blobs
live in the database keyspace itself (key/__init__.py blob), so they ride
the same transactions, export machinery, and backends as everything else.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from surrealdb_tpu_torch import key as keys


def put_blob(txn, ns: str, db: str, raw: bytes) -> str:
    """Store bytes content-addressed; returns the sha1 digest.

    The write is unconditional even when the blob already exists: the MVCC
    backends detect conflicts only on *written* keys, so skipping the write
    would let a concurrent REMOVE MODEL blob-GC delete the digest this
    import is about to reference — writing it forces the write-write
    conflict and one side retries."""
    digest = hashlib.sha1(raw).hexdigest()
    txn.set(keys.blob(ns, db, digest), raw)
    return digest


def get_blob(txn, ns: str, db: str, digest: str) -> Optional[bytes]:
    return txn.get(keys.blob(ns, db, digest))


def del_blob(txn, ns: str, db: str, digest: str) -> None:
    txn.delete(keys.blob(ns, db, digest))
