"""Elastic membership: epoch-versioned ring changes + background shard
migration.

Role of the reference's dynamic node table (kvs/node.rs heartbeats + the
TiKV/FoundationDB rebalancers underneath it): the PR-7 ring was static for
a process lifetime, so capacity changes meant downtime. This module makes
membership a VERSIONED object — every change is a new **epoch** driven by
whichever node coordinates it, in two phases over the existing CBOR
channel:

1. **prepare** (`member_update {phase: "prepare"}`): every member installs
   the next ring next to the active one and enters the HANDOFF WINDOW —
   routed writes land on the UNION of a record's active-ring and next-ring
   replica sets (dual-write), scatter reads fan to the union membership
   (dual-read), and responsibility filters (ft_stats / agg_partial
   first-live-replica rules) keep using the ACTIVE ring on every member,
   so no read misses a record and no doc double-counts mid-transfer.
2. **background shard migration**: a supervised `bg:cluster_migration`
   service asks every live source member to stream the records whose
   next-ring replica set gains a node (`migrate_ranges`) — batches ride
   `record_repair` RPCs whose apply path IS the bulk-ingest delta feed
   (cluster/repair.py), so a migrating shard keeps serving columnar
   mid-transfer. Push responsibility: the first LIVE active-ring owner of
   each record (or any holder outside its owner set — the edge-colocation
   case); duplicate pushes are idempotent under the LWW apply.
3. **commit** (`phase: "commit"`, the cutover): every member atomically
   swaps to the next ring and bumps its epoch gauge. Old owners keep their
   now-unowned copies (reads dedup them; the LWW read path keeps them
   honest) — nothing is deleted at cutover.

`join` / `leave` / `replace` compose the same flow. A replace of a DEAD
node tolerates the corpse during both broadcasts (it is in `removed`), and
its records stream from their surviving replicas — that is the chaos-bench
scenario: kill a node mid-window, join its replacement, zero wrong answers.

Requests carry the sender's epoch; `rpc.handle` counts mismatches
(`cluster_epoch_mismatch_total`) and answers with the local epoch, so a
member stuck on an old ring version is visible as peer drift in the
federated bundle (`bench_diff --bundles`).
"""

from __future__ import annotations

import time as _time
from typing import Any, Dict, List, Optional, Tuple

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.err import SurrealError
from surrealdb_tpu_torch.utils import locks as _locks

from .placement import HashRing, placement_key


class MembershipError(SurrealError):
    pass


class Membership:
    """One node's versioned view of the cluster: the active (epoch, nodes,
    ring) triple, plus the next triple during a handoff window. Pure
    snapshot-and-release state: the lock is never held across an RPC,
    another lock, or an emit."""

    def __init__(self, nodes: List[Dict[str, str]], vnodes: int = 64):
        self._lock = _locks.Lock("cluster.membership")
        self._vnodes = max(int(vnodes), 1)
        self._nodes = [dict(n) for n in nodes]
        self._ring = HashRing([n["id"] for n in self._nodes], vnodes=self._vnodes)
        self._epoch = 1
        self._next_nodes: Optional[List[Dict[str, str]]] = None
        self._next_ring: Optional[HashRing] = None
        self._next_epoch: Optional[int] = None

    # ------------------------------------------------------------ views
    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def state(self) -> str:
        with self._lock:
            return "migrating" if self._next_ring is not None else "stable"

    def ring(self) -> HashRing:
        """The ACTIVE ring — what responsibility filters and divergence
        ranking key on, cluster-wide, until the cutover."""
        with self._lock:
            return self._ring

    def rings(self) -> Tuple[HashRing, Optional[HashRing]]:
        with self._lock:
            return self._ring, self._next_ring

    def nodes(self) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(n) for n in self._nodes]

    def all_nodes(self) -> List[Dict[str, str]]:
        """Active ∪ next membership (the dual-read/dual-write fan-out set
        during a handoff window; == active when stable)."""
        with self._lock:
            out = [dict(n) for n in self._nodes]
            seen = {n["id"] for n in out}
            for n in self._next_nodes or []:
                if n["id"] not in seen:
                    out.append(dict(n))
            return out

    def member_ids(self) -> List[str]:
        return [n["id"] for n in self.all_nodes()]

    def replicas_of_key(self, key: bytes, rf: int) -> List[str]:
        """A record's write set: active-ring owners first, then any
        next-ring owners the handoff window adds (dual-write)."""
        with self._lock:
            ring, nxt = self._ring, self._next_ring
        out = ring.owners_of_key(key, rf)
        if nxt is not None:
            for nid in nxt.owners_of_key(key, rf):
                if nid not in out:
                    out.append(nid)
        return out

    def view(self) -> Dict[str, Any]:
        """The membership section of the debug bundle / `membership` op."""
        with self._lock:
            return {
                "epoch": self._epoch,
                "state": "migrating" if self._next_ring is not None else "stable",
                "nodes": [n["id"] for n in self._nodes],
                "next_epoch": self._next_epoch,
                "next_nodes": [n["id"] for n in self._next_nodes]
                if self._next_nodes is not None
                else None,
            }

    # ------------------------------------------------------------ transitions
    def prepare(
        self,
        nodes: List[Dict[str, str]],
        epoch: int,
        prev_nodes: Optional[List[Dict[str, str]]] = None,
        prev_epoch: Optional[int] = None,
    ) -> None:
        """Install the next ring (handoff window opens). A member whose
        active view predates the coordinator's (a joining node booted from
        a config file) adopts the coordinator's active triple first, so
        every member's ACTIVE ring agrees during the window."""
        epoch = int(epoch)
        with self._lock:
            if self._next_epoch == epoch:
                # idempotent re-prepare (coordinator retry) — but ONLY for
                # the SAME proposal: two coordinators racing different
                # changes under one epoch must not both think they prepared
                if {n["id"] for n in nodes} == {
                    n["id"] for n in self._next_nodes or []
                }:
                    return
                raise MembershipError(
                    f"conflicting prepare for epoch {epoch}: another "
                    "coordinator already proposed a different membership"
                )
            if self._next_ring is not None:
                raise MembershipError(
                    f"membership change already in flight (next epoch "
                    f"{self._next_epoch}) — cannot prepare epoch {epoch}"
                )
            if epoch <= self._epoch:
                raise MembershipError(
                    f"stale membership epoch {epoch} (active is {self._epoch})"
                )
            if prev_nodes is not None and prev_epoch is not None and (
                int(prev_epoch) != self._epoch
                or {n["id"] for n in prev_nodes} != {n["id"] for n in self._nodes}
            ):
                # adopt the coordinator's active view (joining-node case)
                self._nodes = [dict(n) for n in prev_nodes]
                self._ring = HashRing(
                    [n["id"] for n in self._nodes], vnodes=self._vnodes
                )
                self._epoch = int(prev_epoch)
            self._next_nodes = [dict(n) for n in nodes]
            self._next_ring = HashRing(
                [n["id"] for n in nodes], vnodes=self._vnodes
            )
            self._next_epoch = epoch

    def commit(self, epoch: int) -> Tuple[List[str], List[str]]:
        """The cutover: swap to the next ring. Returns (added, removed)
        node ids. Idempotent for an already-committed epoch."""
        epoch = int(epoch)
        with self._lock:
            if self._next_ring is None:
                if self._epoch == epoch:
                    return [], []  # already cut over (coordinator retry)
                raise MembershipError(
                    f"no prepared membership change for epoch {epoch}"
                )
            if self._next_epoch != epoch:
                raise MembershipError(
                    f"cutover epoch {epoch} does not match prepared epoch "
                    f"{self._next_epoch}"
                )
            old = {n["id"] for n in self._nodes}
            new = {n["id"] for n in self._next_nodes or []}
            self._nodes = self._next_nodes or []
            self._ring = self._next_ring
            self._epoch = epoch
            self._next_nodes = self._next_ring = self._next_epoch = None
        return sorted(new - old), sorted(old - new)

    def abort(self, epoch: int) -> List[str]:
        """Drop a prepared change (coordinator rollback). Returns the node
        ids that were only in the next membership (probe cleanup)."""
        with self._lock:
            if self._next_ring is None or self._next_epoch != int(epoch):
                return []
            old = {n["id"] for n in self._nodes}
            added = [
                n["id"] for n in self._next_nodes or [] if n["id"] not in old
            ]
            self._next_nodes = self._next_ring = self._next_epoch = None
        return added


class MigrationState:
    """Progress of the background shard migration (bundle + /metrics
    surface). Leaf-style lock: mutate, release, no calls out."""

    def __init__(self):
        self._lock = _locks.Lock("cluster.migration")
        self._cur: Optional[Dict[str, Any]] = None

    def begin(self, epoch: int, kind: str) -> None:
        with self._lock:
            self._cur = {
                "epoch": int(epoch),
                "kind": kind,
                "state": "streaming",
                "rows_streamed": 0,
                "sources": {},
                "started_ts": _time.time(),
                "done_ts": None,
                "error": None,
            }

    def note_source(self, node_id: str, rows: int) -> None:
        with self._lock:
            if self._cur is not None:
                self._cur["sources"][node_id] = int(rows)
                self._cur["rows_streamed"] += int(rows)

    def finish(self, error: Optional[str] = None) -> None:
        with self._lock:
            if self._cur is not None:
                self._cur["state"] = "failed" if error else "done"
                self._cur["error"] = error
                self._cur["done_ts"] = _time.time()

    def view(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._cur) if self._cur is not None else None


# ------------------------------------------------------------------ coordinator
class MembershipChange:
    """Handle for an in-flight change: `wait()` joins the migration
    service thread and raises if the migration failed."""

    def __init__(self, node, epoch: int, thread):
        self._node = node
        self.epoch = epoch
        self._thread = thread

    def wait(self, timeout: Optional[float] = 120.0) -> Dict[str, Any]:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise MembershipError(
                f"membership epoch {self.epoch} migration still running "
                f"after {timeout}s"
            )
        mig = self._node.migration.view() or {}
        if mig.get("error"):
            raise MembershipError(
                f"membership epoch {self.epoch} migration failed: "
                f"{mig['error']}"
            )
        return mig


def join(ds, node: Dict[str, str], wait: bool = True,
         timeout: Optional[float] = 120.0):
    """Add a member: epoch+1, handoff window, background migration, cutover."""
    cl = _cluster_of(ds)
    cur = cl.membership.nodes()
    if any(n["id"] == node.get("id") for n in cur):
        raise MembershipError(f"node {node.get('id')!r} is already a member")
    if not str(node.get("url", "")).startswith(("http://", "https://")):
        raise MembershipError(f"join needs a node dict with an http(s) url, got {node!r}")
    new_nodes = cur + [{"id": str(node["id"]), "url": str(node["url"]).rstrip("/")}]
    return _change(ds, new_nodes, added=[str(node["id"])], removed=[],
                   kind="join", wait=wait, timeout=timeout)


def leave(ds, node_id: str, wait: bool = True,
          timeout: Optional[float] = 120.0):
    """Remove a member (alive or dead): its ranges re-home onto the
    survivors before the cutover drops it from the ring."""
    cl = _cluster_of(ds)
    cur = cl.membership.nodes()
    if not any(n["id"] == node_id for n in cur):
        raise MembershipError(f"node {node_id!r} is not a member")
    if len(cur) < 2:
        raise MembershipError("cannot remove the last member")
    if node_id == cl.node_id:
        raise MembershipError(
            "a node cannot coordinate its own removal — run leave from "
            "another member"
        )
    new_nodes = [n for n in cur if n["id"] != node_id]
    return _change(ds, new_nodes, added=[], removed=[node_id],
                   kind="leave", wait=wait, timeout=timeout)


def replace(ds, old_id: str, node: Dict[str, str], wait: bool = True,
            timeout: Optional[float] = 120.0):
    """Swap a (typically dead) member for a fresh one in ONE epoch: the
    replacement inherits the dead node's ranges from their surviving
    replicas — the 'kill a node, join a replacement' recovery."""
    cl = _cluster_of(ds)
    cur = cl.membership.nodes()
    if not any(n["id"] == old_id for n in cur):
        raise MembershipError(f"node {old_id!r} is not a member")
    if any(n["id"] == node.get("id") for n in cur):
        raise MembershipError(f"node {node.get('id')!r} is already a member")
    if old_id == cl.node_id:
        raise MembershipError("a node cannot coordinate its own replacement")
    new_nodes = [n for n in cur if n["id"] != old_id] + [
        {"id": str(node["id"]), "url": str(node["url"]).rstrip("/")}
    ]
    return _change(ds, new_nodes, added=[str(node["id"])], removed=[old_id],
                   kind="replace", wait=wait, timeout=timeout)


def _cluster_of(ds):
    cl = getattr(ds, "cluster", None)
    if cl is None:
        raise MembershipError("not a cluster node")
    return cl


def _change(ds, new_nodes, added: List[str], removed: List[str], kind: str,
            wait: bool, timeout: Optional[float]):
    from surrealdb_tpu_torch import bg, events, tracing

    cl = _cluster_of(ds)
    mm = cl.membership
    prev_nodes = mm.nodes()
    prev_epoch = mm.epoch
    if mm.state != "stable":
        raise MembershipError(
            "a membership change is already in flight — wait for its "
            "cutover (or abort) first"
        )
    epoch = prev_epoch + 1
    # the client must be able to reach ADDED nodes before the prepare
    # broadcast (their prepare rides the same channel)
    client = cl.client
    for n in new_nodes:
        if n["id"] in added and client is not None:
            client.add_node(n)
    payload = {
        "nodes": new_nodes,
        "epoch": epoch,
        "prev_nodes": prev_nodes,
        "prev_epoch": prev_epoch,
        "phase": "prepare",
    }
    targets = _union_ids(prev_nodes, new_nodes)
    prepared: List[str] = []
    try:
        for nid in targets:
            try:
                _member_call(cl, nid, payload)
                prepared.append(nid)
            except Exception:
                if nid in removed:
                    continue  # a corpse being removed/replaced may stay silent
                raise
    except Exception:
        # roll the prepared members back — a half-prepared membership would
        # dual-write forever
        abort = {"phase": "abort", "epoch": epoch, "nodes": new_nodes}
        for nid in prepared:
            try:
                _member_call(cl, nid, abort)
            except Exception:  # noqa: BLE001 — best-effort rollback
                from surrealdb_tpu_torch import telemetry

                telemetry.inc("cluster_membership_abort_errors")
        if client is not None:
            for nid in added:
                client.remove_node(nid)
        raise
    for nid in added:
        events.emit("cluster.member_join", node=nid, epoch=epoch, change=kind)
    for nid in removed:
        events.emit("cluster.member_leave", node=nid, epoch=epoch, change=kind)
    cl.migration.begin(epoch, kind)
    thread = bg.spawn_service(
        "cluster_migration", f"epoch{epoch}",
        _run_migration, ds, epoch, targets, removed,
        tracing.current_trace_id(),
        owner=id(ds),
    )
    change = MembershipChange(cl, epoch, thread)
    if wait:
        change.wait(timeout)
    return change


def _union_ids(a: List[Dict[str, str]], b: List[Dict[str, str]]) -> List[str]:
    out: List[str] = []
    for n in list(a) + list(b):
        if n["id"] not in out:
            out.append(n["id"])
    return out


def _member_call(cl, nid: str, payload: Dict[str, Any]) -> Dict[str, Any]:
    """One member_update against one node — self in-process (the op fn
    directly: attach()'s own prepare must not depend on its own server)."""
    if nid == cl.node_id:
        return handle_update(cl.ds, dict(payload))
    return cl.client.call(nid, "member_update", payload)


def _run_migration(ds, epoch: int, targets: List[str], removed: List[str],
                   trace_id) -> None:
    """The supervised migration body: stream moved ranges from every live
    source, then broadcast the cutover. Idempotent under LWW apply, so a
    restarted run re-streams safely."""
    from surrealdb_tpu_torch import events, telemetry

    cl = getattr(ds, "cluster", None)
    if cl is None:
        return
    events.emit("cluster.migration_start", trace_id=trace_id, epoch=epoch)
    t0 = _time.monotonic()
    try:
        down = set(cl.client.down_nodes()) if cl.client is not None else set()
        live = [nid for nid in targets if nid not in down and nid not in removed]
        # sources: live members of the ACTIVE membership (they hold the
        # records; a dead source's records stream from their replicas,
        # which run the same responsibility rule over the live list)
        active_ids = [n["id"] for n in cl.membership.nodes()]
        total = 0
        for src in active_ids:
            if src not in live:
                continue
            req = {"epoch": epoch, "live": live}
            if src == cl.node_id:
                resp = migrate_ranges(ds, req)
            else:
                resp = cl.client.call(src, "migrate_ranges", req)
            rows = int(resp.get("rows") or 0)
            cl.migration.note_source(src, rows)
            total += rows
        # cutover: every reachable member swaps rings atomically
        commit = {"phase": "commit", "epoch": epoch}
        for nid in targets:
            try:
                _member_call(cl, nid, commit)
            except Exception:
                if nid in removed or nid in down:
                    continue  # corpse: it rejoins (if ever) via replace
                raise
        if cl.client is not None:
            for nid in removed:
                cl.client.remove_node(nid)
        cl.migration.finish()
        events.emit(
            "cluster.migration_done", trace_id=trace_id, epoch=epoch,
            rows=total, duration_s=round(_time.monotonic() - t0, 3),
        )
        telemetry.gauge_set("cluster_membership_epoch", float(cl.membership.epoch))
    except BaseException as e:
        cl.migration.finish(error=f"{type(e).__name__}: {e}"[:300])
        # roll the prepared window back on EVERY reachable member: a
        # failed migration must not wedge the cluster mid-handoff (the
        # dual-write window would persist and every later change would
        # refuse with change-already-in-flight). The change is safely
        # retryable afterwards under a fresh epoch — streamed rows are
        # idempotent under the LWW apply.
        abort = {"phase": "abort", "epoch": epoch}
        aborted_added: set = set()
        for nid in targets:
            try:
                _member_call(cl, nid, abort)
            except Exception:  # noqa: BLE001 — best-effort rollback
                telemetry.inc("cluster_membership_abort_errors")
        if cl.client is not None:
            # drop members that existed ONLY in the aborted next ring
            active = {n["id"] for n in cl.membership.nodes()}
            for nid in targets:
                if nid not in active:
                    aborted_added.add(nid)
                    cl.client.remove_node(nid)
        events.emit(
            "cluster.migration_done", trace_id=trace_id, epoch=epoch,
            error=f"{type(e).__name__}: {e}"[:200],
            **({"aborted_added": sorted(aborted_added)} if aborted_added else {}),
        )
        raise


# ------------------------------------------------------------------ member ops
def handle_update(ds, req: Dict[str, Any]) -> Dict[str, Any]:
    """The `member_update` op body (every member, coordinator included)."""
    from surrealdb_tpu_torch import faults, telemetry

    cl = _cluster_of(ds)
    phase = str(req.get("phase", ""))
    epoch = int(req.get("epoch") or 0)
    nodes = req.get("nodes") or []
    if phase == "prepare":
        cl.membership.prepare(
            nodes, epoch,
            prev_nodes=req.get("prev_nodes"),
            prev_epoch=req.get("prev_epoch"),
        )
        # reach every member of the union membership from here on
        if cl.client is not None:
            known = set(cl.client.node_ids())
            for n in cl.membership.all_nodes():
                if n["id"] not in known and n["id"] != cl.node_id:
                    cl.client.add_node(n)
    elif phase == "commit":
        # chaos hook: a member whose cutover fails here stays on the old
        # epoch — exactly the peer-drift signature the federated bundle
        # must surface
        faults.fire("cluster.migrate.cutover")
        added, removed = cl.membership.commit(epoch)
        if cl.client is not None:
            for nid in removed:
                cl.client.remove_node(nid)
        telemetry.gauge_set("cluster_membership_epoch", float(cl.membership.epoch))
    elif phase == "abort":
        for nid in cl.membership.abort(epoch):
            if cl.client is not None:
                cl.client.remove_node(nid)
    else:
        raise MembershipError(f"unknown member_update phase {phase!r}")
    return {"ok": True, "view": cl.membership.view()}


def migrate_ranges(ds, req: Dict[str, Any]) -> Dict[str, Any]:
    """The `migrate_ranges` op body: stream THIS node's share of the moving
    records to their next-ring gainers as LWW bulk-ingest batches."""
    from surrealdb_tpu_torch import faults, telemetry

    from . import repair as _repair

    cl = _cluster_of(ds)
    epoch = int(req.get("epoch") or 0)
    live = [str(n) for n in (req.get("live") or [])]
    ring, nxt = cl.membership.rings()
    if nxt is None or cl.membership.view().get("next_epoch") != epoch:
        raise MembershipError(
            f"no migration window open for epoch {epoch} on {cl.node_id!r}"
        )
    rf_prev = max(min(cnf.CLUSTER_RF, len(ring.node_ids)), 1)
    rf_next = max(min(cnf.CLUSTER_RF, len(nxt.node_ids)), 1)
    self_id = cl.node_id
    batch = max(cnf.CLUSTER_MIGRATE_BATCH, 1)
    total = 0
    per_target: Dict[str, int] = {}
    for ns, db, tb in _repair.all_tables(ds):
        # target -> [[id, doc, hlc, dead], ...]
        pushes: Dict[str, List[list]] = {}
        for rec in _repair.local_records(ds, ns, db, tb):
            key = placement_key(tb, rec.id)
            prev_owners = ring.owners_of_key(key, rf_prev)
            new_owners = nxt.owners_of_key(key, rf_next)
            gain = [n for n in new_owners if n not in prev_owners and n != self_id]
            if not gain:
                continue
            # push responsibility: the first LIVE active-ring owner — or
            # any holder OUTSIDE the owner set (edge records colocate with
            # their source, not their own hash; every such holder pushes,
            # and the LWW apply dedups)
            serving = next((n for n in prev_owners if n in live), None)
            if self_id in prev_owners and serving != self_id:
                continue
            row = rec.wire()
            for target in gain:
                if target not in live:
                    continue
                pushes.setdefault(target, []).append(row)
        for target, rows in sorted(pushes.items()):
            for lo in range(0, len(rows), batch):
                chunk = rows[lo : lo + batch]
                # chaos hook: a stream batch that dies here leaves the
                # window open (dual-read still covers) — the supervised
                # migration service owns the retry story
                faults.fire("cluster.migrate.stream")
                _repair.send_records(cl, target, ns, db, tb, chunk,
                                     reason="migration")
                telemetry.inc(
                    "cluster_migration_rows", by=float(len(chunk)), node=target
                )
                total += len(chunk)
                per_target[target] = per_target.get(target, 0) + len(chunk)
    return {"rows": total, "targets": per_target}
