"""The cluster observability federation plane — one scrape, one bundle,
one timeline from the coordinator.

Every surface here fans the matching RPC op (`metrics` / `bundle` /
`events`, cluster/rpc.py) out to the full membership, executes the self
node in-process, and merges DEGRADED-TOLERANT: a dead member never fails
the federated read — its metrics contribute `cluster_scrape_up 0`, its
bundle section is marked ``{"unreachable": true, "error": ...}``, its
events are simply absent. The request still answers 200; the hole is the
signal.

Used by net/server.py for `GET /metrics?cluster=1`,
`GET /debug/bundle?cluster=1` and `GET /events?cluster=1`, and by bench.py
for the config-7/8 artifact embeds.

IN-PROCESS caveat: telemetry / events / tracing registries are
process-global, so the in-process clusters the tests and bench spin up
(N Datastores, one interpreter) report the SAME registry state under each
node label — per-node attribution is only real across PROCESSES. bench
marks its embeds `in_process: true` so artifact readers know which regime
produced them; the multi-process scale-out re-measure (ROADMAP) is where
the labels start carrying distinct state.
"""

from __future__ import annotations

import contextvars
import json
from typing import Any, Callable, Dict, Optional, Tuple

from surrealdb_tpu_torch.err import SurrealError


def _gather(
    ds, op: str, req: Dict[str, Any]
) -> Tuple[Dict[str, Optional[dict]], Dict[str, str]]:
    """Fan one observability op out to every member; returns
    (node -> decoded JSON payload or None, node -> failure reason). The
    self node executes in-process (no socket, no JSON hop needed — but it
    goes through the same op fn so the payload shape is identical); remote
    calls run concurrently on the executor's scatter pool. Never raises
    for a member failure — the merge is degraded-tolerant by contract."""
    node = getattr(ds, "cluster", None)
    if node is None:
        raise SurrealError("not a cluster node")
    from . import rpc as _rpc

    out: Dict[str, Optional[dict]] = {}
    errors: Dict[str, str] = {}
    futs = {}
    pool = node.executor._pool if node.executor is not None else None
    for n in node.members():
        nid = n["id"]
        if nid == node.node_id or node.client is None:
            continue
        call: Callable = node.client.call
        if pool is not None:
            futs[nid] = pool.submit(
                contextvars.copy_context().run, call, nid, op, req
            )
    # self node: in-process, after the remote fan-out is in flight
    try:
        out[node.node_id] = _decode(_rpc._OPS[op](ds, dict(req, op=op)))
    except Exception as e:  # noqa: BLE001 — degraded-tolerant
        out[node.node_id] = None
        errors[node.node_id] = f"{type(e).__name__}: {e}"[:300]
    for nid, fut in futs.items():
        try:
            out[nid] = _decode(fut.result())
        except Exception as e:  # noqa: BLE001 — a dead member is a marked
            # section, never a failed federated read
            out[nid] = None
            errors[nid] = str(e)[:300]
    return out, errors


def _decode(resp: Any) -> Optional[dict]:
    if not isinstance(resp, dict):
        return None
    payload = resp.get("json")
    if not isinstance(payload, str):
        return None
    v = json.loads(payload)
    return v if isinstance(v, (dict, list)) else None


# ------------------------------------------------------------------ surfaces
def federated_metrics(ds) -> str:
    """`GET /metrics?cluster=1`: one Prometheus exposition covering every
    member, each series re-labeled `node=<id>`; dead members show up as
    `surreal_cluster_scrape_up{node} 0` instead of failing the scrape."""
    from surrealdb_tpu_torch import telemetry

    states, _ = _gather(ds, "metrics", {})
    return telemetry.render_prometheus_federated(states)


def federated_bundle(
    ds, trace_limit: int = 50, full_traces: int = 5
) -> Dict[str, Any]:
    """`GET /debug/bundle?cluster=1`: ONE versioned document with every
    member's full flight-recorder bundle merged under the coordinator —
    a dead member's section is ``{"unreachable": true, "error": ...}`` and
    the request still answers 200 (the degraded-bundle contract)."""
    import time as _time

    from surrealdb_tpu_torch.bundle import BUNDLE_SCHEMA

    req = {"trace_limit": trace_limit, "full_traces": full_traces}
    gathered, errors = _gather(ds, "bundle", req)
    nodes: Dict[str, Any] = {}
    for nid, b in gathered.items():
        if b is None:
            nodes[nid] = {
                "unreachable": True,
                "error": errors.get(nid, "no payload"),
            }
        else:
            nodes[nid] = b
    return {
        "schema": BUNDLE_SCHEMA,
        "cluster": True,
        "ts": _time.time(),
        "coordinator": ds.cluster.node_id,
        "nodes": nodes,
    }


def federated_statements(
    ds, limit: int = 50, fingerprint: Optional[str] = None,
    sort: str = "total_s",
) -> list:
    """`GET /statements?cluster=1`: every member's statement-fingerprint
    stats merged into one list, each entry tagged `node=<id>` (the /events
    merge shape), ordered by cumulative time (or the same `sort` keys the
    single-node view takes) — the cluster-wide answer to "which query
    shapes are eating the cluster". Per-member entries stay separate
    (merging two nodes' latency histograms would fabricate a cluster-wide
    quantile nobody measured). Dead members are MARKED unreachable (the
    /metrics contract: the caller sees "this view is partial", never a
    silent absence) — markers ride after the limit slice so they always
    survive."""
    key = sort if sort in ("total_s", "calls", "errors", "max_ms") else "total_s"
    req: Dict[str, Any] = {"limit": limit, "sort": key}
    if fingerprint:
        req["fingerprint"] = fingerprint
    gathered, errors = _gather(ds, "statements", req)
    merged = []
    for nid, entries in gathered.items():
        if not isinstance(entries, list):
            continue
        for e in entries:
            if isinstance(e, dict):
                merged.append(dict(e, node=nid))
    merged.sort(key=lambda e: (-(e.get(key) or 0), str(e.get("node"))))
    merged = merged[: max(int(limit), 1)]
    merged.extend(_unreachable_markers(gathered, errors))
    return merged


def federated_tenants(ds, limit: int = 50, sort: str = "exec_s") -> list:
    """`GET /tenants?cluster=1`: every member's per-(ns, db) resource
    meters merged into one list, each entry tagged `node=<id>` — the
    cluster-wide answer to "which tenant is eating the cluster, and on
    which nodes". Per-member entries stay separate rather than summed:
    a tenant hot on one node and idle elsewhere is the exact signal a
    merged total would erase (skewed placement vs genuinely heavy load).
    Dead members are MARKED unreachable (the /metrics contract), after
    the limit slice so the markers always survive."""
    from surrealdb_tpu_torch import accounting

    key = sort if sort in accounting.METERS else "exec_s"
    gathered, errors = _gather(ds, "tenants", {"limit": limit, "sort": key})
    merged = []
    for nid, entries in gathered.items():
        if not isinstance(entries, list):
            continue
        for e in entries:
            if isinstance(e, dict):
                merged.append(dict(e, node=nid))
    merged.sort(key=lambda e: (-(e.get(key) or 0), str(e.get("node"))))
    merged = merged[: max(int(limit), 1)]
    merged.extend(_unreachable_markers(gathered, errors))
    return merged


def _unreachable_markers(gathered: Dict[str, Any], errors: Dict[str, str]) -> list:
    """One `{node, unreachable, error}` marker per member that produced
    no payload — the list-shaped twin of federated_bundle's per-node
    marker, shared by /statements, /tenants and /advisor."""
    return [
        {"node": nid, "unreachable": True,
         "error": errors.get(nid, "no payload")}
        for nid, payload in gathered.items()
        if payload is None
    ]


def federated_advisor(ds, limit: int = 50) -> dict:
    """`GET /advisor?cluster=1`: every member's live proposals, DEDUPED
    by stable proposal id — the id is a digest of (kind, subject), so the
    same condition observed from two nodes is ONE record tagged
    `nodes=[...]` (evidence kept from the most-recently-seen reporter;
    two nodes' evidence chains cite the same planes but each node's own
    measurements, and fabricating a merged value would break the
    resolve-in-artifact contract). Dead members are marked unreachable."""
    gathered, errors = _gather(ds, "advisor", {"limit": limit})
    by_id: Dict[str, dict] = {}
    for nid in sorted(gathered.keys()):
        entries = gathered[nid]
        if not isinstance(entries, list):
            continue
        for e in entries:
            if not isinstance(e, dict) or not e.get("id"):
                continue
            cur = by_id.get(e["id"])
            if cur is None:
                by_id[e["id"]] = dict(e, nodes=[nid])
            else:
                cur["nodes"].append(nid)
                if (e.get("last_seen_ts") or 0) > (cur.get("last_seen_ts") or 0):
                    nodes = cur["nodes"]
                    by_id[e["id"]] = dict(e, nodes=nodes)
    merged = sorted(
        by_id.values(),
        key=lambda r: (-(r.get("last_seen_ts") or 0), r["id"]),
    )[: max(int(limit), 1)]
    return {
        "proposals": merged,
        "unreachable": _unreachable_markers(gathered, errors),
    }


def federated_events(
    ds, kind_prefix: Optional[str] = None, limit: Optional[int] = None
) -> list:
    """`GET /events?cluster=1`: every member's timeline merged into one,
    each event tagged `node=<id>`, ordered by timestamp (dead members are
    simply absent — their events are unreachable with them). `limit`
    keeps the single-node contract: the NEWEST `limit` events of the
    MERGED timeline (each member is also asked for only its own newest
    `limit`, a superset of what can survive the merged cut)."""
    req: Dict[str, Any] = {}
    if kind_prefix:
        req["kind"] = kind_prefix
    if limit is not None:
        req["limit"] = limit
    gathered, _ = _gather(ds, "events", req)
    merged = []
    for nid, evs in gathered.items():
        if not isinstance(evs, list):
            continue
        for e in evs:
            if isinstance(e, dict):
                merged.append(dict(e, node=nid))
    merged.sort(key=lambda e: (e.get("ts") or 0, str(e.get("node"))))
    if limit is not None and limit >= 0:
        merged = merged[-limit:] if limit > 0 else []
    return merged
