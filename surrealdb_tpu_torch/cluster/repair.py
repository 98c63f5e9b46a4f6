"""Convergent repair: read-repair + hash-range anti-entropy over LWW stamps.

This closes the r12 degraded-write caveat ("a degraded-acked write catches
up only when that record is rewritten") with the Dynamo recipe, built on
the HLC stamps the write path now mints (cluster/hlc.py):

- **LWW apply** (`apply_records`): the single ingestion door for repair,
  read-repair back-fill, and shard migration. Each incoming record lands
  only if its stamp beats the local one; applied rows ride the bulk-ingest
  column delta feed (the r11 path — a repairing/migrating shard keeps
  serving columnar) with full index maintenance (`idx.index.index_document`)
  and edge-pointer reconstruction for edge records. Tombstones delete.
  Repair writes are replica upkeep, not logical writes: they bypass
  changefeeds, events, and live queries by design.

- **read-repair** (`schedule_read_repair` / `divergent_winner`): when the
  scatter merge's divergence dedup fires, the coordinator resolves the
  served copy by comparing the holders' ACTUAL stamps (LWW — not the ring
  heuristic), then a background `bg:cluster_read_repair` task back-fills
  every stale replica. `cluster_read_repair_total` counts the fixes.

- **anti-entropy sweep** (`sweep_once` / the supervised
  `bg:cluster_antientropy` service): replica pairs compare per-hash-range
  digests (the ring's own arcs as the partition — placement.range_of_key),
  walk only the mismatched ranges record-by-record, and repair in BOTH
  directions (push newer local copies, pull newer remote ones). Bounded
  work per divergence: digests are one local scan; per-record traffic only
  where a range actually differs. `cluster_repair_ranges` counts compared
  ranges, `cluster_antientropy_repaired_total` counts converged records —
  the counters the r12-caveat regression test reads. A fully clean sweep
  resets the executor's write-degradation watermark, so the pipeline
  pushdowns that stood down after a degraded write RESUME once repair has
  proven the replicas converged.

- **tombstone GC** (`tombstone_gc_once` / the supervised
  `bg:cluster_tombstone_gc` service): DELETE tombstones in the HLC
  sidecar keyspace are harmless under LWW but accumulate forever; a
  bounded sweep deletes those older than CLUSTER_TOMBSTONE_TTL_SECS —
  only after a CLEAN anti-entropy pass has covered their range, so a GC'd
  tombstone can never let a stale replica resurrect the record.
  `cluster_tombstones_gced_total` counts deletions; `cluster.tombstone_gc`
  events mark non-empty passes.
"""

from __future__ import annotations

import hashlib
import time as _time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch import key as keys
from surrealdb_tpu_torch.err import SurrealError, TxConditionNotMetError
from surrealdb_tpu_torch.key.encode import dec_value_key, prefix_end
from surrealdb_tpu_torch.utils import locks as _locks
from surrealdb_tpu_torch.utils.ser import pack, unpack

from . import hlc
from .placement import placement_key


class RepairError(SurrealError):
    pass


# sweep/read-repair shared state: in-flight read-repair keys + the last
# sweep report per node (leaf-style lock — mutate and release, never held
# across an RPC/emit)
_lock = _locks.Lock("cluster.repair")
_rr_inflight: set = set()
_last_sweep: Dict[int, dict] = {}  # id(cluster node) -> report


# ------------------------------------------------------------------ local scan
class LocalRecord:
    """One local record (or tombstone) with its replication meta."""

    __slots__ = ("id", "enc_key", "raw", "stamp", "dead")

    def __init__(self, id_, enc_key: bytes, raw: Optional[bytes],
                 stamp: Optional[hlc.Stamp], dead: bool):
        self.id = id_
        self.enc_key = enc_key
        self.raw = raw  # packed doc bytes, None for tombstones
        self.stamp = stamp
        self.dead = dead

    def doc_hash(self) -> bytes:
        if self.raw is None:
            return b"\x00dead"
        return hashlib.blake2b(self.raw, digest_size=8).digest()

    def wire(self) -> list:
        """[id, doc, hlc, dead] — the record_repair/record_fetch row."""
        doc = None if self.raw is None else unpack(self.raw)
        return [
            self.id,
            doc,
            hlc.encode(self.stamp) if self.stamp is not None else None,
            bool(self.dead),
        ]


def all_tables(ds) -> List[Tuple[str, str, str]]:
    """Every (ns, db, tb) in the catalog — the sweep/migration work list."""
    txn = ds.transaction(False)
    try:
        out: List[Tuple[str, str, str]] = []
        for nsd in txn.all_ns():
            ns = nsd["name"]
            for dbd in txn.all_db(ns):
                db = dbd["name"]
                for tbd in txn.all_tb(ns, db):
                    out.append((ns, db, tbd["name"]))
        return out
    finally:
        txn.cancel()


def local_records(ds, ns: str, db: str, tb: str) -> Iterable[LocalRecord]:
    """This node's records ∪ tombstones for one table, key order. Docs
    without meta (pre-cluster data) carry stamp None; metas without docs
    surface as tombstones only when marked dead."""
    txn = ds.transaction(False)
    try:
        tpre = keys.thing_prefix(ns, db, tb)
        mpre = keys.record_meta_prefix(ns, db, tb)
        docs = {k[len(tpre):]: v for k, v in txn.scan(tpre, prefix_end(tpre))}
        metas = {k[len(mpre):]: v for k, v in txn.scan(mpre, prefix_end(mpre))}
    finally:
        txn.cancel()
    for ek in sorted(set(docs) | set(metas)):
        raw = docs.get(ek)
        meta = metas.get(ek)
        stamp, dead = None, False
        if meta is not None:
            m = unpack(meta)
            stamp = hlc.decode(m.get("hlc"))
            dead = bool(m.get("dead"))
        if raw is None and not dead:
            continue  # ghost meta (no doc, not a tombstone): nothing to sync
        if raw is not None:
            dead = False  # the doc is authoritative when present
        id_, _ = dec_value_key(ek, 0)
        yield LocalRecord(id_, ek, raw, stamp, dead)


def table_key(ns: str, db: str, tb: str) -> str:
    return f"{ns}\x00{db}\x00{tb}"


def split_table_key(tk: str) -> Tuple[str, str, str]:
    ns, db, tb = tk.split("\x00", 2)
    return ns, db, tb


def range_digests(ds, ring, idxs: List[int]) -> Dict[str, Dict[str, str]]:
    """{table_key: {str(range idx): digest}} over this node's records whose
    placement hash falls in the requested ring ranges. One scan per table;
    the digest folds (enc id, doc hash | tombstone) in key order — stamps
    deliberately EXCLUDED (replicas mint independent stamps for the same
    logical write; only content divergence should trip a range)."""
    want = set(int(i) for i in idxs)
    out: Dict[str, Dict[str, str]] = {}
    for ns, db, tb in all_tables(ds):
        hashers: Dict[int, Any] = {}
        for rec in local_records(ds, ns, db, tb):
            idx = ring.range_of_key(placement_key(tb, rec.id))
            if idx not in want:
                continue
            h = hashers.get(idx)
            if h is None:
                h = hashers[idx] = hashlib.blake2b(digest_size=16)
            h.update(rec.enc_key)
            h.update(rec.doc_hash())
        if hashers:
            out[table_key(ns, db, tb)] = {
                str(i): h.hexdigest() for i, h in sorted(hashers.items())
            }
    return out


def range_listing(ds, ring, idxs: List[int]) -> Dict[str, Dict[str, list]]:
    """Per-record detail for mismatched ranges:
    {table_key: {enc_key hex: [id, doc_hash hex, hlc, dead]}}."""
    want = set(int(i) for i in idxs)
    out: Dict[str, Dict[str, list]] = {}
    for ns, db, tb in all_tables(ds):
        rows: Dict[str, list] = {}
        for rec in local_records(ds, ns, db, tb):
            if ring.range_of_key(placement_key(tb, rec.id)) not in want:
                continue
            rows[rec.enc_key.hex()] = [
                rec.id,
                rec.doc_hash().hex(),
                hlc.encode(rec.stamp) if rec.stamp is not None else None,
                bool(rec.dead),
            ]
        if rows:
            out[table_key(ns, db, tb)] = rows
    return out


def fetch_records(ds, ns: str, db: str, tb: str, ids: List[Any]) -> List[list]:
    """[id, doc, hlc, dead] rows for explicit ids (read-repair / pull side).
    Ids with neither doc nor tombstone are omitted."""
    txn = ds.transaction(False)
    try:
        out: List[list] = []
        for id_ in ids:
            raw = txn.get(keys.thing(ns, db, tb, id_))
            meta = txn.get_record_meta(ns, db, tb, id_)
            stamp = hlc.decode((meta or {}).get("hlc"))
            dead = bool((meta or {}).get("dead")) and raw is None
            if raw is None and not dead:
                continue
            out.append([
                id_,
                None if raw is None else unpack(raw),
                hlc.encode(stamp) if stamp is not None else None,
                dead,
            ])
        return out
    finally:
        txn.cancel()


# ------------------------------------------------------------------ LWW apply
def apply_records(ds, ns: str, db: str, tb: str, records: List[list],
                  reason: str = "repair") -> int:
    """Apply incoming [id, doc, hlc, dead] rows under last-writer-wins:
    a row lands only if its stamp beats the local copy's (a missing local
    stamp always loses to a stamped incoming row; two unstamped copies
    keep the local one — the caller's ring-order rule decides pushes).
    Returns the number of rows applied."""
    from surrealdb_tpu_torch import telemetry
    from surrealdb_tpu_torch.dbs.context import Context
    from surrealdb_tpu_torch.dbs.executor import Executor
    from surrealdb_tpu_torch.dbs.session import Session
    from surrealdb_tpu_torch.idx.index import index_document
    from surrealdb_tpu_torch.key.encode import enc_value_key
    from surrealdb_tpu_torch.sql.value import Thing

    if not records:
        return 0
    sess = Session.owner(ns, db)
    ex = Executor(ds, sess)
    ctx = Context(ex, sess)
    ex._open(True)
    applied = 0
    # applied live rows feed the column mirror as ONE bulk delta (the r11
    # path: a migrating/repairing shard serves columnar mid-transfer)
    d_ids: List[Any] = []
    d_keys: List[bytes] = []
    d_docs: List[dict] = []
    try:
        txn = ctx.txn()
        txn.ensure_tb(ns, db, tb)
        feed_columns = (
            cnf.COLUMN_DELTA_FEED
            and getattr(txn, "_column_mirrors", None) is not None
            and txn._column_mirrors.get((ns, db, tb)) is not None
        )
        deletes = False
        for row in records:
            if not isinstance(row, (list, tuple)) or len(row) != 4:
                raise RepairError(f"malformed repair row {row!r}")
            id_, doc, stamp_v, dead = row
            if isinstance(id_, Thing):
                id_ = id_.id
            stamp = hlc.decode(stamp_v)
            local = txn.get_record_meta(ns, db, tb, id_)
            local_stamp = hlc.decode((local or {}).get("hlc"))
            if not hlc.wins(stamp, local_stamp):
                continue
            rid = Thing(tb, id_)
            old = txn.get_record(ns, db, tb, id_)
            if dead or doc is None:
                if old is not None:
                    index_document(ctx, rid, old, None)
                    txn.tr.delete(keys.thing(ns, db, tb, id_))
                    txn.touch_table(ns, db, tb)
                    deletes = True
                txn.put_stamp(ns, db, tb, id_, stamp, dead=True)
            else:
                if not isinstance(doc, dict):
                    raise RepairError(f"repair doc for {rid} is not an object")
                doc = dict(doc)
                doc["id"] = rid
                index_document(ctx, rid, old, doc)
                ek = enc_value_key(id_)
                txn.tr.set(keys.thing_prefix(ns, db, tb) + ek, pack(doc))
                txn.touch_table_bulk(ns, db, tb)
                txn.put_stamp(ns, db, tb, id_, stamp)
                if old is None and isinstance(doc.get("in"), Thing) and isinstance(
                    doc.get("out"), Thing
                ):
                    # a migrated/repaired EDGE record brings its 4 graph
                    # pointer keys along (doc/pipeline.store_edges), so the
                    # new holder answers frontier expansion like any replica
                    from surrealdb_tpu_torch.doc.pipeline import store_edges

                    store_edges(ctx, rid, doc["in"], doc["out"])
                if feed_columns:
                    d_ids.append(id_)
                    d_keys.append(ek)
                    d_docs.append(doc)
            if stamp is not None:
                hlc.observe(stamp)
            applied += 1
        if feed_columns and d_ids and not deletes:
            txn.bulk_column_delta(ns, db, tb, d_ids, d_keys, d_docs)
        ex._commit()
    except BaseException:
        ex._cancel()
        raise
    if applied:
        telemetry.inc("cluster_repair_applied_total", by=float(applied),
                      reason=reason)
    return applied


def send_records(cl, target: str, ns: str, db: str, tb: str,
                 rows: List[list], reason: str) -> int:
    """Push [id, doc, hlc, dead] rows to one member's LWW apply door
    (self short-circuits in-process). Returns the applied count."""
    req = {"ns": ns, "db": db, "tb": tb, "records": rows, "reason": reason}
    if target == cl.node_id:
        return apply_records(cl.ds, ns, db, tb, rows, reason=reason)
    resp = cl.client.call(target, "record_repair", req)
    return int(resp.get("applied") or 0)


# ------------------------------------------------------------------ read repair
def divergent_winner(node, ns: str, db: str, rid,
                     candidates: Tuple[str, str]) -> Optional[str]:
    """Which of two diverged holders serves: compare their records' ACTUAL
    stamps (one RPC per remote holder — paid only on divergence). None
    when stamps cannot decide (missing/unreachable) — the caller falls
    back to the ring-order write-reporter rule."""
    stamps: Dict[str, Optional[hlc.Stamp]] = {}
    for nid in candidates:
        try:
            rows = _fetch_from(node, ns, db, nid, rid)
        except Exception:  # noqa: BLE001 — divergence ranking must not fail the read
            return None
        stamps[nid] = hlc.decode(rows[0][2]) if rows else None
    a, b = candidates
    if hlc.wins(stamps.get(a), stamps.get(b)):
        return a
    if hlc.wins(stamps.get(b), stamps.get(a)):
        return b
    return None


def _fetch_from(node, ns: str, db: str, nid: str, rid) -> List[list]:
    if nid == node.node_id:
        return fetch_records(node.ds, ns, db, rid.tb, [rid.id])
    resp = node.client.call(
        nid, "record_fetch", {"ns": ns, "db": db, "tb": rid.tb, "ids": [rid.id]}
    )
    return list(resp.get("records") or [])


def schedule_read_repair(node, ns: str, db: str, rid) -> bool:
    """Arm a background back-fill for one diverged record. Bounded: at most
    CLUSTER_READ_REPAIR_MAX_INFLIGHT concurrent repairs, one per record —
    beyond that the divergence stays counted and the sweep owns it."""
    from surrealdb_tpu_torch import bg, tracing

    # ns/db belong in the identity: same-named records in different
    # databases are different records and must not dedup each other
    key = (id(node), ns, db, rid.tb, repr(rid.id))
    cap = max(cnf.CLUSTER_READ_REPAIR_MAX_INFLIGHT, 1)
    with _lock:
        if key in _rr_inflight or len(_rr_inflight) >= cap:
            return False
        _rr_inflight.add(key)
    bg.spawn(
        "cluster_read_repair", f"{rid.tb}:{rid.id}",
        _read_repair, node, ns, db, rid, key, tracing.current_trace_id(),
        owner=id(node.ds),
    )
    return True


def _read_repair(node, ns: str, db: str, rid, key, trace_id) -> None:
    """Back-fill every stale replica of one record with the LWW winner."""
    from surrealdb_tpu_torch import events, telemetry

    try:
        ds = node.ds
        rf = max(min(cnf.CLUSTER_RF, len(node.membership.nodes())), 1)
        holders = node.membership.replicas_of_key(
            placement_key(rid.tb, rid.id), rf
        )
        down = set(node.client.down_nodes()) if node.client is not None else set()
        copies: Dict[str, List[list]] = {}
        for nid in holders:
            if nid in down:
                continue
            try:
                if nid == node.node_id:
                    copies[nid] = fetch_records(ds, ns, db, rid.tb, [rid.id])
                else:
                    resp = node.client.call(
                        nid, "record_fetch",
                        {"ns": ns, "db": db, "tb": rid.tb, "ids": [rid.id]},
                    )
                    copies[nid] = list(resp.get("records") or [])
            except Exception:  # noqa: BLE001 — a dead holder waits for the sweep
                continue
        best: Optional[list] = None
        best_stamp: Optional[hlc.Stamp] = None
        for rows in copies.values():
            for row in rows:
                st = hlc.decode(row[2])
                if best is None or hlc.wins(st, best_stamp):
                    best, best_stamp = row, st
        if best is None or best_stamp is None:
            return  # nothing stamped to converge onto
        repaired = 0
        for nid, rows in copies.items():
            st = hlc.decode(rows[0][2]) if rows else None
            if rows and rows[0][1] == best[1] and bool(rows[0][3]) == bool(best[3]):
                continue  # already the winning content
            if hlc.wins(st, best_stamp):
                continue  # raced ahead — it now holds something newer
            repaired += send_records(
                node, nid, ns, db, rid.tb, [best], reason="read_repair"
            )
        if repaired:
            telemetry.inc("cluster_read_repair_total", by=float(repaired))
            events.emit(
                "cluster.read_repair", trace_id=trace_id,
                record=f"{rid.tb}:{rid.id}", repaired=repaired,
            )
    finally:
        with _lock:
            _rr_inflight.discard(key)


# ------------------------------------------------------------------ anti-entropy
def sweep_once(ds, trace_id=None) -> dict:
    """One full anti-entropy pass from THIS node: compare every shared
    hash range with every live replica peer, repair both directions.
    Returns the sweep report (also kept for the debug bundle)."""
    from surrealdb_tpu_torch import events, faults, telemetry

    cl = getattr(ds, "cluster", None)
    if cl is None:
        raise RepairError("not a cluster node")
    mm = cl.membership
    ring = mm.ring()
    rf = max(min(cnf.CLUSTER_RF, len(mm.nodes())), 1)
    self_id = cl.node_id
    down = set(cl.client.down_nodes()) if cl.client is not None else set()
    epoch = mm.epoch
    peers_ranges: Dict[str, List[int]] = {}
    for idx in range(ring.n_ranges()):
        owners = ring.range_owners(idx, rf)
        if self_id not in owners:
            continue
        for peer in owners:
            if peer != self_id and peer not in down:
                peers_ranges.setdefault(peer, []).append(idx)
    report = {
        "ts": _time.time(),
        # the sweep's position on the HLC timeline: tombstone-GC coverage
        # is decided against THIS anchor, never wall clock — the HLC may
        # legitimately run ahead of wall time (observed skewed members),
        # and every stamp the dataset held when the pass started is
        # strictly below a freshly-minted stamp
        "hlc": hlc.encode(hlc.now(self_id)),
        "epoch": epoch,
        "peers": 0,
        "ranges": 0,
        "mismatched_ranges": 0,
        "pushed": 0,
        "pulled": 0,
        "repaired": 0,
        "errors": [],
    }
    # ONE local scan covers every peer leg: digests for the UNION of all
    # shared ranges, sliced per peer below (a per-peer recompute would scan
    # the whole dataset once per replica peer)
    all_idxs = sorted({i for idxs in peers_ranges.values() for i in idxs})
    local_all = range_digests(ds, ring, all_idxs) if all_idxs else {}
    for peer in sorted(peers_ranges):
        idxs = peers_ranges[peer]
        try:
            # chaos hook: a sweep leg that dies here leaves the pair for
            # the next pass — captured in the report, never a dead sweep
            faults.fire("cluster.repair.sweep")
            want = {str(int(i)) for i in idxs}
            local = {
                tk: {si: d for si, d in per.items() if si in want}
                for tk, per in local_all.items()
            }
            local = {tk: per for tk, per in local.items() if per}
            resp = cl.client.call(
                peer, "repair_digests", {"idxs": idxs, "epoch": epoch}
            )
            remote = resp.get("digests") or {}
            report["peers"] += 1
            report["ranges"] += len(idxs)
            telemetry.inc("cluster_repair_ranges", by=float(len(idxs)), peer=peer)
            mism = _mismatched(local, remote, idxs)
            if not mism:
                continue
            report["mismatched_ranges"] += len(
                {i for _, i in mism}
            )
            midxs = sorted({i for _, i in mism})
            llist = range_listing(ds, ring, midxs)
            rresp = cl.client.call(
                peer, "repair_keys", {"idxs": midxs, "epoch": epoch}
            )
            rlist = rresp.get("tables") or {}
            pushed, pulled = _reconcile_pair(
                ds, cl, ring, rf, peer, llist, rlist, midxs
            )
            report["pushed"] += pushed
            report["pulled"] += pulled
            report["repaired"] += pushed + pulled
        except Exception as e:  # noqa: BLE001 — one bad peer must not kill the sweep
            report["errors"].append(f"{peer}: {type(e).__name__}: {e}"[:200])
    if report["repaired"]:
        telemetry.inc(
            "cluster_antientropy_repaired_total", by=float(report["repaired"])
        )
        events.emit(
            "cluster.antientropy_repair", trace_id=trace_id,
            repaired=report["repaired"], ranges=report["mismatched_ranges"],
            epoch=epoch,
        )
    elif not report["errors"] and cl.executor is not None:
        # a clean pass PROVES the replicas converged: the pipeline
        # pushdowns that stood down after a degraded write may resume
        cl.executor.reset_degradation()
    with _lock:
        _last_sweep[id(cl)] = dict(report)
    return report


def _mismatched(local, remote, idxs) -> List[Tuple[str, int]]:
    """(table_key, idx) pairs whose digests differ — including tables/
    ranges present on only one side."""
    out: List[Tuple[str, int]] = []
    for tk in set(local) | set(remote):
        lt = local.get(tk) or {}
        rt = remote.get(tk) or {}
        for i in idxs:
            si = str(int(i))
            if lt.get(si) != rt.get(si):
                out.append((tk, int(i)))
    return out


def _reconcile_pair(ds, cl, ring, rf, peer, llist, rlist, midxs) -> Tuple[int, int]:
    """Record-level reconcile of the mismatched ranges with one peer:
    push local winners, pull remote winners, ring-order tiebreak for
    unstamped divergence."""
    pushed = pulled = 0
    for tk in sorted(set(llist) | set(rlist)):
        ns, db, tb = split_table_key(tk)
        lrows = llist.get(tk) or {}
        rrows = rlist.get(tk) or {}
        push_ids: List[Any] = []
        pull_ids: List[Any] = []
        for kh in set(lrows) | set(rrows):
            l, r = lrows.get(kh), rrows.get(kh)
            if l is not None and r is not None and l[1] == r[1] and bool(l[3]) == bool(r[3]):
                continue  # same content (stamps may differ — that is fine)
            ls = hlc.decode(l[2]) if l else None
            rs = hlc.decode(r[2]) if r else None
            if hlc.wins(ls, rs):
                push_ids.append(l[0])
            elif hlc.wins(rs, ls):
                pull_ids.append(r[0])
            elif l is not None and r is None:
                push_ids.append(l[0])
            elif r is not None and l is None:
                pull_ids.append(r[0])
            else:
                # both unstamped and divergent: the write-reporter rule —
                # the earlier owner in the record's ring order is canon
                rid_l = l[0]
                owners = ring.owners_of_key(placement_key(tb, rid_l), rf)
                rank = {n: i for i, n in enumerate(owners)}
                if rank.get(cl.node_id, len(rank)) <= rank.get(peer, len(rank)):
                    push_ids.append(rid_l)
                else:
                    pull_ids.append(r[0])
        if push_ids:
            rows = fetch_records(ds, ns, db, tb, push_ids)
            if rows:
                pushed += send_records(cl, peer, ns, db, tb, rows,
                                       reason="antientropy")
        if pull_ids:
            resp = cl.client.call(
                peer, "record_fetch",
                {"ns": ns, "db": db, "tb": tb, "ids": pull_ids},
            )
            rows = list(resp.get("records") or [])
            if rows:
                pulled += apply_records(ds, ns, db, tb, rows,
                                        reason="antientropy")
    return pushed, pulled


def last_sweep(cl) -> Optional[dict]:
    with _lock:
        rep = _last_sweep.get(id(cl))
        return dict(rep) if rep is not None else None


# ------------------------------------------------------------------ tombstone GC
def tombstone_gc_once(ds, trace_id=None) -> dict:
    """One bounded tombstone-GC pass over THIS node's HLC sidecar keyspace
    (the `^` record-meta keys): delete tombstones (dead=True metas whose
    doc is gone) older than CLUSTER_TOMBSTONE_TTL_SECS — but ONLY those a
    clean anti-entropy sweep has covered since they were minted. Under LWW
    a stale tombstone is harmless but accumulates forever; GC'ing one
    BEFORE its delete provably propagated could let a stale replica
    resurrect the record, so the eligibility rule is:

      - the node's last sweep finished with NO per-peer errors (every
        shared range was actually compared and reconciled), and
      - the tombstone's stamp predates that sweep's HLC anchor (the
        delete existed when the pass ran, so the pass propagated it) —
        compared on the HLC timeline, not wall clock: the HLC may run
        ahead of wall time after observing a skewed member, and the
        anchor stamp minted at sweep start is strictly above every stamp
        the dataset held then (repair/migration applies observe() remote
        stamps into the local clock first), and
      - the TTL has elapsed since the tombstone's stamp, measured
        against the CURRENT clock position on the same timeline.

    Unstamped dead metas (no HLC — a pre-cluster artifact) are left
    alone: with no mint time neither the TTL nor the coverage rule can be
    proven for them. Returns the pass report; `cluster_tombstones_gced_total`
    counts deletions and a `cluster.tombstone_gc` event marks a non-empty
    pass."""
    from surrealdb_tpu_torch import events, telemetry

    cl = getattr(ds, "cluster", None)
    if cl is None:
        raise RepairError("not a cluster node")
    report = {"ts": _time.time(), "scanned": 0, "eligible": 0, "swept": 0,
              "skipped_no_clean_sweep": False}
    sweep = last_sweep(cl)
    if sweep is None or sweep.get("errors"):
        # no clean pass to anchor coverage on: sweep nothing, say why
        report["skipped_no_clean_sweep"] = True
        return report
    anchor = hlc.decode(sweep.get("hlc"))
    if anchor is None:
        # a pre-anchor report (older node mid-rolling-upgrade): wall-clock
        # fallback, strictly more conservative under an ahead-running HLC
        anchor = (float(sweep.get("ts") or 0.0) * 1000.0, -1, "")
    ttl_ms = max(cnf.CLUSTER_TOMBSTONE_TTL_SECS, 0.0) * 1000.0
    now_ms = hlc.now(cl.node_id)[0]
    doomed: List[Tuple[bytes, bytes]] = []  # (meta key, scanned raw value)
    for ns, db, tb in all_tables(ds):
        txn = ds.transaction(False)
        try:
            tpre = keys.thing_prefix(ns, db, tb)
            mpre = keys.record_meta_prefix(ns, db, tb)
            docs = {k[len(tpre):] for k, _ in txn.scan(tpre, prefix_end(tpre))}
            metas = list(txn.scan(mpre, prefix_end(mpre)))
        finally:
            txn.cancel()
        for mk, raw in metas:
            ek = mk[len(mpre):]
            m = unpack(raw)
            if not m.get("dead") or ek in docs:
                continue  # live record, or meta shadowed by a real doc
            report["scanned"] += 1
            stamp = hlc.decode(m.get("hlc"))
            if stamp is None:
                continue  # unprovable age: keep (see docstring)
            if (stamp[0], stamp[1]) >= (anchor[0], anchor[1]):
                continue  # minted AT/AFTER the clean pass: not covered yet
            if now_ms - stamp[0] < ttl_ms:
                continue  # covered but younger than the TTL
            report["eligible"] += 1
            doomed.append((mk, raw))
    swept = 0
    for mk, raw in doomed:
        # conditional delete against the SCANNED raw value (one small txn
        # per tombstone): a record re-created between the read scan and
        # this delete overwrote the meta with a live stamp — deleting it
        # unconditionally would strip the live record's stamp, and a stale
        # replica's old tombstone would then win LWW over the unstamped
        # doc (the resurrection the eligibility rules exist to prevent).
        # A changed meta simply stays for the next pass to re-judge.
        txn = ds.transaction(True)
        try:
            txn.tr.delc(mk, raw)
            txn.commit()
            swept += 1
        except TxConditionNotMetError:
            txn.cancel()
        except BaseException:
            txn.cancel()
            raise
    if swept:
        report["swept"] = swept
        telemetry.inc("cluster_tombstones_gced_total", by=float(swept))
        events.emit(
            "cluster.tombstone_gc", trace_id=trace_id,
            swept=swept, epoch=cl.membership.epoch,
        )
    return report


def start_tombstone_gc(ds) -> None:
    """The supervised background tombstone sweep: one
    `bg:cluster_tombstone_gc` service per node, pacing at
    CLUSTER_TOMBSTONE_GC_INTERVAL_SECS (0 = disabled; tombstone_gc_once
    stays callable on demand)."""
    from surrealdb_tpu_torch import bg, tracing

    interval = cnf.CLUSTER_TOMBSTONE_GC_INTERVAL_SECS
    if interval <= 0:
        return
    cl = ds.cluster
    bg.spawn_service(
        "cluster_tombstone_gc", cl.node_id,
        _tombstone_gc_loop, ds, cl, tracing.current_trace_id(),
        owner=id(ds), restart=True,
    )


def _tombstone_gc_loop(ds, cl, trace_id) -> None:
    import random as _random

    interval = max(cnf.CLUSTER_TOMBSTONE_GC_INTERVAL_SECS, 0.05)
    while getattr(ds, "cluster", None) is cl:
        tombstone_gc_once(ds, trace_id=trace_id)
        # jittered beat, like the anti-entropy sweep: N nodes' GC passes
        # de-correlate instead of all scanning at once
        _time.sleep(interval * (0.75 + 0.5 * _random.random()))


def start_service(ds) -> None:
    """The supervised background sweep: one `bg:cluster_antientropy`
    service per node, pacing at CLUSTER_ANTIENTROPY_INTERVAL_SECS (0 =
    disabled; sweep_once stays callable on demand)."""
    from surrealdb_tpu_torch import bg, tracing

    interval = cnf.CLUSTER_ANTIENTROPY_INTERVAL_SECS
    if interval <= 0:
        return
    cl = ds.cluster
    bg.spawn_service(
        "cluster_antientropy", cl.node_id,
        _sweep_loop, ds, cl, tracing.current_trace_id(),
        owner=id(ds), restart=True,
    )


def _sweep_loop(ds, cl, trace_id) -> None:
    import random as _random

    interval = max(cnf.CLUSTER_ANTIENTROPY_INTERVAL_SECS, 0.05)
    while getattr(ds, "cluster", None) is cl:
        sweep_once(ds, trace_id=trace_id)
        # jittered beat: N nodes' sweeps de-correlate instead of all
        # scanning at once
        _time.sleep(interval * (0.75 + 0.5 * _random.random()))
