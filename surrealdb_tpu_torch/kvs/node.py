"""Cluster node membership + failure detection.

Role of the reference's node lifecycle (reference: core/src/kvs/node.rs,
ds.rs:623-668 — bootstrap registers the node, background tasks refresh the
heartbeat, expire stale nodes, and clean up archived nodes' live queries;
SDK engine/tasks.rs:45-51 drives the loops). Nodes coordinate only through
the shared keyspace:

    /!nd{uuid}          -> {id, hb (nanos), gc (archived flag)}
    /!nl{uuid}{liveid}  -> {ns, db, tb} pointer to a node's live query

`tick()` on the Datastore calls heartbeat + expire + cleanup, so a periodic
server loop (or an embedded caller) gets the full membership protocol.
"""

from __future__ import annotations

from typing import List, Optional

from surrealdb_tpu_torch import key as keys
from surrealdb_tpu_torch.key.encode import prefix_end
from surrealdb_tpu_torch.utils.ser import pack, unpack

# a node is considered dead after missing heartbeats for this long
DEFAULT_EXPIRY_NANOS = 30 * 1_000_000_000


def register(ds) -> None:
    """Write/refresh this node's registration (reference ds.rs:623 insert_node)."""
    txn = ds.transaction(True)
    try:
        txn.set(
            keys.node(ds.node_id.bytes),
            pack({"id": str(ds.node_id), "hb": ds.clock.now_nanos(), "gc": False}),
        )
        txn.commit()
    except BaseException:
        if not txn.done:
            txn.cancel()
        raise


def heartbeat(ds) -> None:
    """Refresh this node's hb timestamp (reference update_node ds.rs:636)."""
    register(ds)


def list_nodes(ds) -> List[dict]:
    txn = ds.transaction(False)
    try:
        pre = keys.node_prefix()
        return [unpack(v) for _, v in txn.scan(pre, prefix_end(pre))]
    finally:
        txn.cancel()


def expire_nodes(ds, expiry_nanos: int = DEFAULT_EXPIRY_NANOS) -> List[str]:
    """Archive nodes whose heartbeat is stale (reference expire_nodes
    ds.rs:647). Returns the archived node ids."""
    now = ds.clock.now_nanos()
    archived = []
    txn = ds.transaction(True)
    try:
        pre = keys.node_prefix()
        for k, v in txn.scan(pre, prefix_end(pre)):
            nd = unpack(v)
            if nd.get("gc"):
                continue
            if str(nd.get("id")) == str(ds.node_id):
                continue  # never expire ourselves
            if now - int(nd.get("hb", 0)) > expiry_nanos:
                nd["gc"] = True
                txn.set(k, pack(nd))
                archived.append(str(nd["id"]))
        txn.commit()
    except BaseException:
        if not txn.done:
            txn.cancel()
        raise
    return archived


def remove_archived(ds) -> int:
    """Delete archived nodes and their live queries (reference
    remove_nodes + cleanup ds.rs:658, node.rs). Returns LQs cleaned."""
    import uuid as _uuid

    cleaned = 0
    txn = ds.transaction(True)
    try:
        pre = keys.node_prefix()
        dead: List[bytes] = []
        for k, v in txn.scan(pre, prefix_end(pre)):
            nd = unpack(v)
            if nd.get("gc"):
                dead.append(_uuid.UUID(str(nd["id"])).bytes)
                txn.delete(k)
        for nd_bytes in dead:
            npre = keys.node_lq_prefix(nd_bytes)
            for k, v in txn.scan(npre, prefix_end(npre)):
                ptr = unpack(v)
                live_id = k[len(npre) :]
                txn.delete(
                    keys.live_query(ptr["ns"], ptr["db"], ptr["tb"], live_id)
                )
                txn.invalidate_tb_lives(ptr["ns"], ptr["db"], ptr["tb"])
                txn.delete(k)
                cleaned += 1
        txn.commit()
    except BaseException:
        if not txn.done:
            txn.cancel()
        raise
    return cleaned


def bootstrap(ds) -> None:
    """Startup protocol (reference ds.rs:623 bootstrap): register this node,
    archive anything stale, and clean up dead nodes' live queries."""
    register(ds)
    expire_nodes(ds)
    remove_archived(ds)
