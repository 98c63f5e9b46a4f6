"""Server side of the internal `/cluster` channel.

Each op executes against THIS node's shard of the data (execute_local —
never back through the cluster executor, or a scatter would recurse) and
returns its payload plus the spans recorded while handling, so the
coordinator can graft them into the one request-wide trace.

Ops:
    query     {sql, ns, db, vars}            -> {results}
    ft_stats  {ns, db, tb, field, query}     -> {dc, tl, df, terms} | {missing}
    agg_partial {sql, ns, db, tb, vars, rf, live}
                                             -> {groups, exact, rows} | {fallback}
    expand    {ns, db, part, ids}            -> {map: repr(id) -> expansion}
    ping      {}                             -> {ok}
    bundle    {trace_limit?, full_traces?}   -> {json: <node debug bundle>}
    metrics   {}                             -> {json: <telemetry export>}
    events    {kind?, limit?}                -> {json: <event timeline>}
    statements {limit?, fingerprint?, sort?} -> {json: <statement stats>}
    tenants   {limit?, sort?}                -> {json: <per-(ns,db) meters>}
    member_update {phase, epoch, nodes, ...} -> {ok, view}   (elastic membership)
    membership  {}                           -> {view, migration}
    migrate_ranges {epoch, live}             -> {rows, targets}
    repair_digests {idxs, epoch}             -> {digests: {tbkey: {idx: hex}}}
    repair_keys    {idxs, epoch}             -> {tables: {tbkey: {key: row}}}
    record_fetch   {ns, db, tb, ids}         -> {records: [[id, doc, hlc, dead]]}
    record_repair  {ns, db, tb, records, reason} -> {applied}

Every request carries the sender's membership `epoch` (attached by the
client); handle() counts mismatches (`cluster_epoch_mismatch_total`) and
every response echoes the local epoch — a member stuck on an old ring
version is a counter + a peer-drift flag, never a silent wrong answer.

The observability ops (`bundle`/`metrics`/`events` — the federation plane)
ship their payloads as JSON STRINGS inside the CBOR envelope: bundle
documents carry arbitrary engine values (None-valued fields, nested label
maps) whose CBOR round trip would re-type them, and the coordinator only
re-serializes them anyway.

A `query` response also carries any slow-query / error ring entries the
handled statement recorded on THIS node (`slow` / `errors`, matched by the
request's trace id) so the coordinator can join a slow remote shard into
its own rings — without this, a slow shard is only visible on the shard.

The channel is authenticated by the shared config secret (net/server.py
checks `x-surreal-cluster-key` before calling handle()); ops execute with
system privileges — the COORDINATOR's public ingress is where user auth and
capabilities are enforced.
"""

from __future__ import annotations

import json as _json
import time as _time
from typing import Any, Dict

from surrealdb_tpu_torch.err import SurrealError


def handle(ds, req: Dict[str, Any]) -> Dict[str, Any]:
    """Execute one cluster op; never raises — failures come back as
    {"error": ...} so the transport stays a clean 200 CBOR channel and the
    coordinator can distinguish node-down from op-failed."""
    from surrealdb_tpu_torch import telemetry, tracing

    from surrealdb_tpu_torch import faults

    op = str(req.get("op", ""))
    fn = _OPS.get(op)
    t0 = _time.time()
    local_epoch = _local_epoch(ds)
    req_epoch = req.get("epoch")
    if (
        local_epoch is not None
        and isinstance(req_epoch, int)
        and req_epoch != local_epoch
        and op not in ("member_update", "membership")
    ):
        # one side of this call routed under a different ring version —
        # counted here, flagged as peer drift by bench_diff --bundles
        telemetry.inc("cluster_epoch_mismatch_total", op=op)
    try:
        if fn is None:
            raise SurrealError(f"unknown cluster op {op!r}")
        faults.fire("cluster.rpc.handle")
        with telemetry.span("cluster_serve", op=op):
            out = fn(ds, req)
    except SurrealError as e:
        out = {"error": str(e)}
    except Exception as e:  # noqa: BLE001 — a bad op must not kill the channel
        out = {"error": f"Internal error: {type(e).__name__}: {e}"}
    out["node"] = str(getattr(getattr(ds, "cluster", None), "node_id", "") or "")
    if local_epoch is not None:
        out["epoch"] = _local_epoch(ds)  # post-op: a member_update answers new
    out["spans"] = tracing.export_spans()
    if op == "query":
        _attach_ring_entries(out, t0)
    return out


def _attach_ring_entries(out: Dict[str, Any], t0: float) -> None:
    """Slow/error ring entries recorded WHILE handling this op, matched by
    the request's trace id (the /cluster ingress honored the coordinator's
    traceparent, so the handled statement recorded under it). They ride the
    response next to the grafted spans — the coordinator joins them into
    its own rings as the statement's per-node breakdown."""
    from surrealdb_tpu_torch import telemetry, tracing

    tid = tracing.current_trace_id()
    if tid is None:
        return
    # small epsilon: time.time() is not monotonic across the two reads
    cutoff = t0 - 0.002
    slow = [
        e for e in telemetry.slow_queries()
        if e.get("trace_id") == tid and (e.get("ts") or 0) >= cutoff
    ]
    errs = [
        e for e in telemetry.recent_errors()
        if e.get("trace_id") == tid and (e.get("ts") or 0) >= cutoff
    ]
    # JSON round trip (default=str) pins the entries to CBOR-safe
    # primitives — an exotic plan-note value must never break the query
    # response it happens to ride on
    if slow:
        out["slow"] = _json.loads(_json.dumps(slow, default=str))
    if errs:
        out["errors"] = _json.loads(_json.dumps(errs, default=str))


def _local_epoch(ds):
    node = getattr(ds, "cluster", None)
    if node is None or getattr(node, "membership", None) is None:
        return None
    return node.membership.epoch


def _session(req):
    from surrealdb_tpu_torch.dbs.session import Session

    return Session.owner(req.get("ns"), req.get("db"))


def _op_ping(ds, req):
    return {"ok": True}


def _op_query(ds, req):
    sql = str(req.get("sql", ""))
    vars = req.get("vars") or None
    if vars is not None and not isinstance(vars, dict):
        raise SurrealError("cluster query vars must be an object")
    results = ds.execute_local(sql, _session(req), vars)
    return {"results": results}


def _op_expand(ds, req):
    """One graph hop over THIS node's pointer keys: expand every requested
    record id through one `->edge` / `<-edge` / `<->edge` step, evaluated
    directly on the id (get_path over a Thing) — pointer keys are read even
    when the RECORD lives on another member (RELATE writes both directions'
    pointers where it executes, so inbound pointers routinely sit on a
    non-owner). Ids with no local pointers yield empty lists; the
    coordinator concatenates per-id across members (frontier exchange)."""
    from surrealdb_tpu_torch.dbs.context import Context
    from surrealdb_tpu_torch.dbs.executor import Executor
    from surrealdb_tpu_torch.sql.path import PGraph, get_path
    from surrealdb_tpu_torch.sql.value import Thing

    ids = req.get("ids") or []
    direction = str(req.get("dir", "out"))
    if direction not in ("out", "in", "both"):
        raise SurrealError(f"bad expand direction {direction!r}")
    part = PGraph(direction, [str(w) for w in (req.get("what") or [])])
    sess = _session(req)
    ex = Executor(ds, sess)
    ctx = Context(ex, sess)
    ex._open(False)
    mp: Dict[str, Any] = {}
    try:
        for t in ids:
            if not isinstance(t, Thing):
                continue
            v = get_path(ctx, t, [part])
            mp[repr(t)] = v if isinstance(v, list) else [v]
    finally:
        ex._cancel()
    return {"map": mp}


def _op_ft_stats(ds, req):
    """Local corpus statistics for one search index + query: doc count,
    total doc length, per-term document frequency — phase one of the
    two-phase distributed BM25 (global stats, then globally-scored
    postings).

    Under replication (`rf` > 1 with a `live` node list in the request)
    each node reports ONLY the docs it is the first live replica of — so a
    doc replicated RF ways still counts once in the merged global stats,
    and a dead node's docs are covered by their surviving replicas."""
    from surrealdb_tpu_torch.dbs.executor import Executor
    from surrealdb_tpu_torch.dbs.context import Context
    from surrealdb_tpu_torch.idx.ft_index import FtIndex
    from surrealdb_tpu_torch.idx.ft_mirror import FtMirror

    from .placement import placement_key

    ns, db = req.get("ns"), req.get("db")
    tb, field = str(req.get("tb", "")), str(req.get("field", ""))
    query = str(req.get("query", ""))
    doc_ok = None
    filter_key = None
    rf = int(req.get("rf") or 1)
    live = [str(n) for n in (req.get("live") or [])]
    node = getattr(ds, "cluster", None)
    if rf > 1 and live and node is not None:
        ring, self_id = node.ring, node.node_id
        filter_key = (tuple(sorted(live)), rf)  # the mask's only inputs

        def doc_ok(rid):  # first-live-replica responsibility (see above)
            owners = ring.owners_of_key(placement_key(rid.tb, rid.id), rf)
            serving = next((n for n in owners if n in live), None)
            return serving == self_id

    sess = _session(req)
    ex = Executor(ds, sess)
    ctx = Context(ex, sess)
    ex._open(False)
    try:
        txn = ctx.txn()
        ix = next(
            (
                i
                for i in txn.all_tb_indexes(ns, db, tb)
                if i["index"]["type"] == "search"
                and i.get("status", "ready") == "ready"
                and i["fields"]
                and repr(i["fields"][0]) == field
            ),
            None,
        )
        if ix is None:
            return {"missing": True}
        mirror = ds.index_stores.get_or_create(ns, db, tb, ix["name"], FtMirror)
        mirror.ensure_built(ctx, ix)
        terms = FtIndex.for_index(None, ix).analyzer(ctx).terms(query)
        dc, tl, df = mirror.term_stats(terms, doc_ok=doc_ok, filter_key=filter_key)
        return {"dc": dc, "tl": tl, "df": df, "terms": terms}
    finally:
        ex._cancel()


def _op_agg_partial(ds, req):
    """Per-shard partial aggregates for the cluster GROUP BY pushdown
    (ops/pipeline.py): this node computes factorize + segment-reduce over
    ITS rows (columnar when the mirror serves, the row-scan twin
    otherwise) and returns per-group partials — counts, exact sums,
    min/max with mergeability flags, mean as sum+count, and the group's
    first member values keyed by encoded record key so the coordinator can
    reconstruct the single-node group order and first-member semantics.
    Under replication (`rf`/`live` in the request) rows this node is not
    the first live replica of are excluded — a doc counts exactly once
    across the merged partials (the ft_stats responsibility rule)."""
    from surrealdb_tpu_torch.dbs.context import Context
    from surrealdb_tpu_torch.dbs.executor import Executor
    from surrealdb_tpu_torch.ops.pipeline import partial_aggregate
    from surrealdb_tpu_torch.sql.statements import SelectStatement
    from surrealdb_tpu_torch.syn import parse_query

    from .placement import placement_key

    tb = str(req.get("tb", ""))
    sql = str(req.get("sql", ""))
    vars = req.get("vars") or None
    ast = parse_query(sql)
    if len(ast.statements) != 1 or not isinstance(ast.statements[0], SelectStatement):
        raise SurrealError("agg_partial expects one SELECT statement")
    stm = ast.statements[0]
    owner_ok = None
    rf = int(req.get("rf") or 1)
    live = [str(n) for n in (req.get("live") or [])]
    node = getattr(ds, "cluster", None)
    if rf > 1 and live and node is not None:
        ring, self_id = node.ring, node.node_id

        def owner_ok(rid):  # first-live-replica responsibility
            owners = ring.owners_of_key(placement_key(rid.tb, rid.id), rf)
            serving = next((n for n in owners if n in live), None)
            return serving == self_id

    sess = _session(req)
    ex = Executor(ds, sess, vars)
    ctx = Context(ex, sess)
    for name, value in (vars or {}).items():
        ctx.set_param(name, value)
    ex._open(False)
    try:
        out = partial_aggregate(ctx, tb, stm, owner_ok=owner_ok)
    finally:
        ex._cancel()
    if out is None:
        return {"fallback": True}
    return out


def _op_bundle(ds, req):
    """This node's full debug bundle for the federated
    `/debug/bundle?cluster=1` merge — JSON-encoded (see module doc)."""
    from surrealdb_tpu_torch.bundle import debug_bundle

    b = debug_bundle(
        ds,
        trace_limit=int(req.get("trace_limit") or 50),
        full_traces=int(req.get("full_traces") or 10),
    )
    return {"json": _json.dumps(b, default=str)}


def _op_metrics(ds, req):
    """This node's metrics registry state for the federated
    `/metrics?cluster=1` scrape (re-labeled node=<id> by the coordinator).
    Node gauges are refreshed first, exactly like a direct scrape."""
    from surrealdb_tpu_torch import telemetry

    telemetry.collect_node_metrics(ds)
    return {"json": _json.dumps(telemetry.export_state())}


def _op_events(ds, req):
    """This node's event timeline slice for the federated `/events` merge."""
    from surrealdb_tpu_torch import events

    kind = req.get("kind")
    limit = req.get("limit")
    out = events.snapshot(
        kind_prefix=str(kind) if kind else None,
        limit=int(limit) if limit is not None else None,
    )
    return {"json": _json.dumps(out, default=str)}


def _op_statements(ds, req):
    """This node's statement-fingerprint stats for the federated
    `/statements?cluster=1` merge (workload statistics plane, stats.py):
    entries ride node-UNtagged — the coordinator tags each with its
    serving member id, like the /events merge."""
    from surrealdb_tpu_torch import stats

    limit = req.get("limit")
    fp = req.get("fingerprint")
    out = stats.statements(
        limit=int(limit) if limit is not None else 100,
        fingerprint=str(fp) if fp else None,
        sort=str(req.get("sort") or "total_s"),
    )
    # each member annotates its OWN rows with its plan-cache state (cache
    # contents are per-node), so the federated merge carries them for free
    return {"json": _json.dumps(ds.plan_cache.annotate(out), default=str)}


def _op_tenants(ds, req):
    """This node's per-(ns, db) resource meters for the federated
    `/tenants?cluster=1` merge (tenant cost-attribution plane,
    accounting.py): entries ride node-UNtagged — the coordinator tags
    each with its serving member id, like the /statements merge."""
    from surrealdb_tpu_torch import accounting

    limit = req.get("limit")
    out = accounting.top(
        limit=int(limit) if limit is not None else 100,
        sort=str(req.get("sort") or "exec_s"),
    )
    return {"json": _json.dumps(out, default=str)}


def _op_advisor(ds, req):
    """This node's live advisor proposals for the federated
    `/advisor?cluster=1` merge (advisor plane, advisor.py): records ride
    node-UNtagged — the coordinator dedups by stable proposal id and
    tags each merged record with the member ids that reported it."""
    from surrealdb_tpu_torch import advisor

    limit = req.get("limit")
    out = advisor.export_state(
        limit=int(limit) if limit is not None else 100
    )
    return {"json": _json.dumps(out, default=str)}


def _op_member_update(ds, req):
    """Elastic membership: prepare / commit / abort one epoch change
    (cluster/membership.py drives the two-phase flow)."""
    from . import membership as _membership

    return _membership.handle_update(ds, req)


def _op_membership(ds, req):
    """This node's membership + migration view (tests, observability)."""
    node = getattr(ds, "cluster", None)
    if node is None:
        raise SurrealError("not a cluster node")
    return {
        "view": node.membership.view(),
        "migration": node.migration.view(),
    }


def _op_migrate_ranges(ds, req):
    """Stream this node's share of a migration window's moving records."""
    from . import membership as _membership

    return _membership.migrate_ranges(ds, req)


def _op_repair_digests(ds, req):
    """Per-hash-range digests for the anti-entropy sweep (cluster/repair.py)."""
    from . import repair as _repair

    node = getattr(ds, "cluster", None)
    if node is None:
        raise SurrealError("not a cluster node")
    epoch = req.get("epoch")
    if isinstance(epoch, int) and epoch != node.membership.epoch:
        raise SurrealError(
            f"repair_digests under epoch {epoch} but this node is at "
            f"{node.membership.epoch} — rings disagree, sweep must re-plan"
        )
    idxs = [int(i) for i in (req.get("idxs") or [])]
    return {"digests": _repair.range_digests(ds, node.membership.ring(), idxs)}


def _op_repair_keys(ds, req):
    """Per-record (id, doc-hash, hlc, dead) listing for mismatched ranges."""
    from . import repair as _repair

    node = getattr(ds, "cluster", None)
    if node is None:
        raise SurrealError("not a cluster node")
    epoch = req.get("epoch")
    if isinstance(epoch, int) and epoch != node.membership.epoch:
        # same guard as repair_digests: a cutover landing MID-SWEEP would
        # partition this listing under a different ring than the
        # coordinator's range indices — refuse, the sweep re-plans
        raise SurrealError(
            f"repair_keys under epoch {epoch} but this node is at "
            f"{node.membership.epoch} — rings disagree, sweep must re-plan"
        )
    idxs = [int(i) for i in (req.get("idxs") or [])]
    return {"tables": _repair.range_listing(ds, node.membership.ring(), idxs)}


def _op_record_fetch(ds, req):
    """Docs + stamps for explicit record ids (read-repair / sweep pulls)."""
    from . import repair as _repair

    return {
        "records": _repair.fetch_records(
            ds, str(req.get("ns")), str(req.get("db")), str(req.get("tb")),
            list(req.get("ids") or []),
        )
    }


def _op_record_repair(ds, req):
    """The LWW apply door: migration streams, read-repair back-fills and
    anti-entropy pushes all land here (cluster/repair.py apply_records)."""
    from . import repair as _repair

    reason = str(req.get("reason") or "repair")
    applied = _repair.apply_records(
        ds, str(req.get("ns")), str(req.get("db")), str(req.get("tb")),
        list(req.get("records") or []), reason=reason,
    )
    return {"applied": applied}


_OPS = {
    "ping": _op_ping,
    "query": _op_query,
    "expand": _op_expand,
    "ft_stats": _op_ft_stats,
    "agg_partial": _op_agg_partial,
    "bundle": _op_bundle,
    "metrics": _op_metrics,
    "events": _op_events,
    "statements": _op_statements,
    "tenants": _op_tenants,
    "advisor": _op_advisor,
    # elastic membership + convergent repair
    "member_update": _op_member_update,
    "membership": _op_membership,
    "migrate_ranges": _op_migrate_ranges,
    "repair_digests": _op_repair_digests,
    "repair_keys": _op_repair_keys,
    "record_fetch": _op_record_fetch,
    "record_repair": _op_record_repair,
}
