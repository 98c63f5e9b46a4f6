"""Inter-node RPC client: CBOR over the internal `/cluster` HTTP channel.

Reuses the existing CBOR wire format (rpc/cbor.py — Things, Datetimes,
Durations, vectors all round-trip), carries the coordinator's W3C
`traceparent` outbound so the remote joins the SAME trace, and ships the
remote's recorded spans back in every response for grafting
(tracing.graft_spans). Per-node liveness is maintained by probe pumps
registered through bg.spawn_service — deterministic `bg:cluster_probe:<id>`
threads the flight recorder can see, restarted under supervision if they
ever die on an uncaught exception.

Failure semantics: a dead, timed-out, or garbling node raises
NodeUnavailableError naming the node and url — the executor turns that into
failover onto a replica (or a clear per-shard error when replication cannot
cover), never a hang (the RPC deadline is cnf.CLUSTER_RPC_TIMEOUT_SECS).
A response body that fails to decode (peer died MID-response: truncated or
corrupt CBOR) is the same class of failure as a refused connection — it
must never be served as a partial answer.

Circuit breaker: every remote node carries a closed -> open -> half-open
breaker driven by RPC failures. While open, calls fail fast (no socket, no
timeout) — a dead node costs ONE timeout, not one per statement. After
cnf.CLUSTER_BREAKER_COOLDOWN_SECS one half-open trial call is let through;
the liveness probe's next success also closes the breaker (the pump doubles
as the half-open prober). While a node stays down the probe itself backs
off exponentially (jittered, capped at CLUSTER_PROBE_MAX_INTERVAL_SECS)
instead of hammering a corpse; every up<->down transition counts into
`cluster_node_flaps_total`.
"""

from __future__ import annotations

import http.client
import random as _random
import time as _time
from typing import Any, Dict, List, Optional
from urllib.parse import urlparse

from surrealdb_tpu_torch import cnf, faults
from surrealdb_tpu_torch.err import SurrealError
from surrealdb_tpu_torch.rpc import cbor as _cbor
from surrealdb_tpu_torch.utils import locks as _locks

from .config import ClusterConfig


class ClusterError(SurrealError):
    pass


class NodeUnavailableError(ClusterError):
    def __init__(self, node_id: str, url: str, cause: str, retryable: bool = True):
        super().__init__(
            f"cluster node {node_id!r} ({url}) unavailable: {cause}"
        )
        self.node_id = node_id
        # False for breaker fast-fails: retrying against an OPEN breaker
        # burns the statement's retry budget for nothing
        self.retryable = retryable


class RemoteOpError(ClusterError):
    """The remote executed the op and reported a failure."""

    def __init__(self, node_id: str, message: str):
        super().__init__(f"cluster node {node_id!r}: {message}")
        self.node_id = node_id


# breaker states (gauge values for cluster_breaker_state{node})
_CLOSED, _HALF_OPEN, _OPEN = 0, 1, 2
_STATE_NAMES = {_CLOSED: "closed", _HALF_OPEN: "half_open", _OPEN: "open"}


class _Breaker:
    __slots__ = ("state", "fails", "opened_at", "trips", "trial_inflight")

    def __init__(self):
        self.state = _CLOSED
        self.fails = 0
        self.opened_at = 0.0
        self.trips = 0
        self.trial_inflight = False


class ClusterClient:
    """RPC fan-out to every member of the cluster (one short-lived
    connection per call — scatter calls run concurrently from the
    executor's pool threads, so per-call sockets also sidestep
    http.client's single-in-flight-request limitation)."""

    def __init__(self, config: ClusterConfig, owner: Optional[int] = None):
        self.config = config
        self._owner = owner
        self._lock = _locks.Lock("cluster.client")
        # node_id -> url: seeded from the static config, mutated by elastic
        # membership changes (add_node/remove_node; guarded by cluster.client)
        self._urls: Dict[str, str] = {n["id"]: n["url"] for n in config.nodes}
        # the active membership's epoch, attached to every outbound op so
        # members can flag a coordinator (or themselves) on a stale ring
        # version; wired by cluster.attach
        self.epoch_provider = None
        # node_id -> liveness view maintained by the probe pumps + call
        # outcomes (guarded by cluster.client)
        self._health: Dict[str, Dict[str, Any]] = {
            n["id"]: {
                "up": None, "last_seen": 0.0, "error": None,
                "probe_interval_s": None, "flaps": 0,
            }
            for n in config.nodes
        }
        # node_id -> circuit breaker (guarded by cluster.breaker; the two
        # locks never nest — health and breaker update in separate steps)
        self._breaker_lock = _locks.Lock("cluster.breaker")
        self._breakers: Dict[str, _Breaker] = {
            n["id"]: _Breaker() for n in config.nodes
        }
        self._alive = True
        self._probes_started = False

    # ------------------------------------------------------------ membership
    def url_of(self, node_id: str) -> str:
        with self._lock:
            url = self._urls.get(node_id)
        if url is None:
            raise ClusterError(f"unknown cluster node {node_id!r}")
        return url

    def node_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._urls)

    def add_node(self, node: Dict[str, str]) -> None:
        """Wire a new member into the transport: url map, health entry,
        breaker, and (when the pumps are running) its own liveness probe."""
        nid, url = str(node["id"]), str(node["url"]).rstrip("/")
        start_probe = False
        with self._lock:
            if nid in self._urls:
                self._urls[nid] = url
                return
            self._urls[nid] = url
            self._health[nid] = {
                "up": None, "last_seen": 0.0, "error": None,
                "probe_interval_s": None, "flaps": 0,
            }
            start_probe = self._probes_started
        with self._breaker_lock:
            self._breakers.setdefault(nid, _Breaker())
        if start_probe:
            from surrealdb_tpu_torch import bg

            bg.spawn_service(
                "cluster_probe", nid, self._probe_loop, nid,
                owner=self._owner, restart=True,
            )

    def remove_node(self, node_id: str) -> None:
        """Drop a departed member: its probe pump exits on the next beat
        (the loop checks the health map), calls to it fail fast."""
        with self._lock:
            self._urls.pop(node_id, None)
            self._health.pop(node_id, None)
        with self._breaker_lock:
            self._breakers.pop(node_id, None)

    # ------------------------------------------------------------ transport
    def _request(
        self, node_id: str, path: str, body: bytes, timeout: float,
        headers: Optional[Dict[str, str]] = None,
    ) -> bytes:
        url = self.url_of(node_id)
        u = urlparse(url)
        conn_cls = (
            http.client.HTTPSConnection if u.scheme == "https" else http.client.HTTPConnection
        )
        conn = conn_cls(u.hostname, u.port, timeout=timeout)
        try:
            faults.fire("cluster.rpc.send")
            # Connection: close — one-shot internal requests; leaving the
            # keep-alive socket to be reset on close() makes the remote's
            # ThreadingHTTPServer log spurious ConnectionResetErrors
            hdrs = {"Content-Type": "application/cbor", "Connection": "close"}
            if self.config.secret:
                from surrealdb_tpu_torch.cluster.config import derive_node_key

                # per-node derived credential, never the bare shared secret:
                # the receiver recomputes HMAC(secret, node:epoch) from these
                # two headers and constant-time-compares
                epoch = 0
                if self.epoch_provider is not None:
                    try:
                        epoch = int(self.epoch_provider())
                    except Exception:  # noqa: BLE001 — membership not yet
                        epoch = 0  # attached: epoch-1 boot credential
                hdrs["x-surreal-cluster-node"] = self.config.node_id
                hdrs["x-surreal-cluster-epoch"] = str(epoch)
                hdrs["x-surreal-cluster-key"] = derive_node_key(
                    self.config.secret, self.config.node_id, epoch
                )
            if headers:
                hdrs.update(headers)
            conn.request("POST", path, body=body, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise RemoteOpError(
                    node_id, f"HTTP {resp.status}: {data[:200]!r}"
                )
            # the corrupt action truncates/mangles the body here — the
            # peer-died-mid-response shape the decode below must catch
            return faults.fire("cluster.rpc.recv", data)
        except (OSError, http.client.HTTPException) as e:
            raise NodeUnavailableError(node_id, url, f"{type(e).__name__}: {e}") from e
        finally:
            conn.close()

    def call(self, node_id: str, op: str, req: Dict[str, Any]) -> Dict[str, Any]:
        """One cluster op against one node. Attaches the active trace as an
        outbound `traceparent`, grafts the remote's spans back into it, and
        drives the node's circuit breaker: open = fail fast, no socket."""
        from surrealdb_tpu_torch import telemetry, tracing

        self._breaker_allow(node_id)
        req = dict(req, op=op)
        if self.epoch_provider is not None and "epoch" not in req:
            # the membership epoch this request was placed under — the
            # receiver counts mismatches (cluster_epoch_mismatch_total) so
            # a member on a stale ring version is visible, not silent
            req["epoch"] = self.epoch_provider()
        headers: Dict[str, str] = {}
        ctx = tracing.current()
        if ctx is not None:
            headers["traceparent"] = tracing.format_traceparent(
                ctx.trace.trace_id, ctx.span_id
            )
        t0 = _time.perf_counter()
        try:
            with telemetry.span("cluster_rpc", node=node_id, op=op):
                raw = self._request(
                    node_id, "/cluster", _cbor.encode(req),
                    cnf.CLUSTER_RPC_TIMEOUT_SECS, headers,
                )
                try:
                    resp = _cbor.decode(raw)
                except Exception as e:
                    # truncated/corrupt body: the peer (or the wire) died
                    # mid-response — node-class failure, NEVER a partial
                    # answer served as complete
                    raise NodeUnavailableError(
                        node_id, self.url_of(node_id),
                        f"corrupt response body: {type(e).__name__}: {e}",
                    ) from e
        except NodeUnavailableError:
            telemetry.inc("cluster_rpc_errors", node=node_id, op=op)
            self._mark(node_id, up=False)
            self._breaker_failure(node_id)
            raise
        except ClusterError:
            telemetry.inc("cluster_rpc_errors", node=node_id, op=op)
            # RemoteOpError: the node is alive and answered — no breaker hit
            self._breaker_success(node_id)
            raise
        except BaseException:
            # neither node-down nor op-failed (an unencodable payload, an
            # injected engine-class fault): says nothing about the node's
            # health, but a HALF-OPEN trial must release its latch or every
            # later call fast-fails until the next probe success
            self._breaker_release_trial(node_id)
            raise
        self._mark(node_id, up=True)
        self._breaker_success(node_id)
        if not isinstance(resp, dict):
            raise RemoteOpError(node_id, "malformed cluster response")
        spans = resp.get("spans")
        if spans:
            tracing.graft_spans(spans, t0, node_id)
        if resp.get("error"):
            raise RemoteOpError(node_id, str(resp["error"]))
        return resp

    # ------------------------------------------------------------ breaker
    def _breaker_allow(self, node_id: str) -> None:
        """Gate one call on the node's breaker. Closed: pass. Open: fail
        fast until the cooldown elapses, then admit ONE half-open trial
        (concurrent callers keep failing fast while it is in flight)."""
        from surrealdb_tpu_torch import telemetry

        trial = False
        went_half_open = False
        with self._breaker_lock:
            b = self._breakers.get(node_id)
            if b is None or b.state == _CLOSED:
                return
            now = _time.monotonic()
            if b.state == _OPEN and (
                now - b.opened_at >= max(cnf.CLUSTER_BREAKER_COOLDOWN_SECS, 0.0)
            ):
                b.state = _HALF_OPEN
                b.trial_inflight = False
                went_half_open = True
            if b.state == _HALF_OPEN and not b.trial_inflight:
                b.trial_inflight = True  # this caller is the trial
                trial = True
            else:
                state = _STATE_NAMES[b.state]
        if trial:
            # emit OUTSIDE the breaker lock (concurrent fast-failers
            # contend on it), matching every other emit in this module
            if went_half_open:
                from surrealdb_tpu_torch import events

                events.emit("cluster.breaker_half_open", node=node_id)
            return
        telemetry.inc("cluster_breaker_fast_fails", node=node_id)
        raise NodeUnavailableError(
            node_id, self.url_of(node_id),
            f"circuit breaker {state}", retryable=False,
        )

    def _breaker_release_trial(self, node_id: str) -> None:
        """Un-latch a half-open trial without judging the node either way;
        the next caller (or probe) becomes the trial instead."""
        with self._breaker_lock:
            b = self._breakers.get(node_id)
            if b is not None:
                b.trial_inflight = False

    def _breaker_success(self, node_id: str) -> None:
        self._breaker_set(node_id, up=True)

    def _breaker_failure(self, node_id: str) -> None:
        self._breaker_set(node_id, up=False)

    def _breaker_set(self, node_id: str, up: bool) -> None:
        from surrealdb_tpu_torch import events, telemetry

        tripped = False
        reclosed = False
        with self._breaker_lock:
            b = self._breakers.get(node_id)
            if b is None:
                return
            if up:
                changed = b.state != _CLOSED or b.fails
                reclosed = b.state != _CLOSED
                b.state = _CLOSED
                b.fails = 0
                b.trial_inflight = False
                if not changed:
                    return
            else:
                b.fails += 1
                b.trial_inflight = False
                if b.state == _HALF_OPEN or (
                    b.state == _CLOSED
                    and b.fails >= max(cnf.CLUSTER_BREAKER_THRESHOLD, 1)
                ):
                    if b.state != _OPEN:
                        b.trips += 1
                        tripped = True
                    b.state = _OPEN
                    b.opened_at = _time.monotonic()
            state = b.state
            fails = b.fails
        telemetry.gauge_set("cluster_breaker_state", float(state), node=node_id)
        if tripped:
            telemetry.inc("cluster_breaker_trips", node=node_id)
            events.emit("cluster.breaker_open", node=node_id, fails=fails)
        elif reclosed:
            events.emit("cluster.breaker_close", node=node_id)

    def breaker_state(self, node_id: str) -> str:
        with self._breaker_lock:
            b = self._breakers.get(node_id)
            return _STATE_NAMES[b.state] if b is not None else "unknown"

    # ------------------------------------------------------------ health
    def _mark(self, node_id: str, up: bool, error: Optional[str] = None) -> None:
        from surrealdb_tpu_torch import events, telemetry

        flapped = False
        changed = False
        with self._lock:
            h = self._health.get(node_id)
            if h is None:
                return
            if h["up"] is not None and h["up"] != up:
                h["flaps"] += 1
                flapped = True
            changed = h["up"] != up
            h["up"] = up
            h["error"] = error
            if up:
                h["last_seen"] = _time.time()
            flaps = h["flaps"]
        telemetry.gauge_set("cluster_node_up", 1.0 if up else 0.0, node=node_id)
        if flapped:
            telemetry.inc("cluster_node_flaps_total", node=node_id)
        if changed:
            # timeline entry per TRANSITION (not per probe beat): an event
            # emitted while serving a statement carries that statement's
            # trace id — the flap joins the request it degraded
            events.emit(
                "cluster.node_up" if up else "cluster.node_down",
                node=node_id, flaps=flaps,
                **({"error": str(error)[:200]} if error else {}),
            )

    def health(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._health.items()}

    def down_nodes(self) -> List[str]:
        """Nodes currently believed dead: health says down, or the breaker
        is open — the set the executor's replica failover plans around.
        `None` (never probed) counts as up: optimism costs one timeout,
        pessimism would reject a healthy node."""
        with self._lock:
            down = {nid for nid, h in self._health.items() if h["up"] is False}
        with self._breaker_lock:
            for nid, b in self._breakers.items():
                if b.state == _OPEN:
                    down.add(nid)
        return sorted(down)

    def probe_state(self) -> Dict[str, Any]:
        """Probe + breaker view for the debug bundle's engine section."""
        out: Dict[str, Any] = {}
        health = self.health()
        with self._breaker_lock:
            for nid, b in self._breakers.items():
                h = health.get(nid, {})
                out[nid] = {
                    "up": h.get("up"),
                    "last_seen": h.get("last_seen"),
                    "flaps": h.get("flaps", 0),
                    "probe_interval_s": h.get("probe_interval_s"),
                    "breaker": _STATE_NAMES[b.state],
                    "breaker_fails": b.fails,
                    "breaker_trips": b.trips,
                }
        return out

    def start_probes(self) -> None:
        """One liveness pump per REMOTE node (bg.spawn_service — service
        tasks: exempt from shutdown joins, visible in the task registry,
        supervised: an uncaught pump crash restarts it with backoff)."""
        from surrealdb_tpu_torch import bg

        with self._lock:
            if self._probes_started:
                return
            self._probes_started = True
        for node_id in (n for n in self.node_ids() if n != self.config.node_id):
            bg.spawn_service(
                "cluster_probe", node_id, self._probe_loop, node_id,
                owner=self._owner, restart=True,
            )

    def _probe_loop(self, node_id: str, trace_id=None) -> None:
        # trace_id: the arming request's trace (explicit propagation — the
        # pump's own liveness events are deliberately traceless, but a
        # caller may pin one for attribution)
        interval = max(cnf.CLUSTER_PROBE_INTERVAL_SECS, 0.05)
        while self._alive:
            with self._lock:
                url = self._urls.get(node_id)
            if url is None:
                return  # the member left the cluster: the pump retires
            u = urlparse(url)
            ok = False
            try:
                conn_cls = (
                    http.client.HTTPSConnection
                    if u.scheme == "https"
                    else http.client.HTTPConnection
                )
                conn = conn_cls(u.hostname, u.port, timeout=2.0)
                try:
                    conn.request("GET", "/health", headers={"Connection": "close"})
                    resp = conn.getresponse()
                    resp.read()
                    ok = resp.status == 200
                finally:
                    conn.close()
                self._mark(node_id, up=ok)
            except (OSError, http.client.HTTPException) as e:
                # BadStatusLine etc. is HTTPException, NOT OSError — a peer
                # restarting mid-probe must not kill the pump for good
                self._mark(node_id, up=False, error=str(e))
            if ok:
                # a probe success IS the half-open transition: close the
                # breaker so the next statement goes straight through
                self._breaker_success(node_id)
                interval = max(cnf.CLUSTER_PROBE_INTERVAL_SECS, 0.05)
            else:
                self._breaker_failure(node_id)
                # exponential backoff while the node stays down — a dead
                # peer gets probed gently, not hammered on a fixed beat
                interval = min(
                    max(interval, 0.05) * 2,
                    max(cnf.CLUSTER_PROBE_MAX_INTERVAL_SECS,
                        cnf.CLUSTER_PROBE_INTERVAL_SECS),
                )
            with self._lock:
                h = self._health.get(node_id)
                if h is not None:
                    h["probe_interval_s"] = round(interval, 3)
            # full jitter on the beat so N coordinators' probes de-correlate
            _time.sleep(interval * (0.75 + 0.5 * _random.random()))

    def shutdown(self) -> None:
        self._alive = False
