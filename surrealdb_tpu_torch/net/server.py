"""HTTP + WebSocket server.

Role of the reference's axum net layer + WS RPC actor (reference:
src/net/mod.rs:162-183 routes, src/rpc/connection.rs:80-417): routes /sql,
/rpc (HTTP msgpack POST and WS upgrade), /key/{tb}[/{id}] REST CRUD,
/signin, /signup, /health, /version, /export, /import. Sessions: WS
connections hold a stateful RpcContext; HTTP requests authenticate per
request from headers.

Wire formats: JSON (default, values via to_json_value) and msgpack (the
storage codec doubling as full-fidelity wire format) — content negotiation
via Content-Type/Accept (reference has 5 formats, core/src/rpc/format/).
"""

from __future__ import annotations

import json
import queue
import threading
from surrealdb_tpu_torch.utils import locks as _locks
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import urlparse

from surrealdb_tpu_torch import __version__
from surrealdb_tpu_torch.dbs.session import Auth, Session
from surrealdb_tpu_torch.err import InvalidAuthError, SurrealError
from surrealdb_tpu_torch.rpc.method import RpcContext
from surrealdb_tpu_torch.sql.value import to_json_value
from surrealdb_tpu_torch.utils.ser import wire_pack as pack, wire_unpack

from . import ws as wsproto

# deterministic per-connection labels for the WS service threads
# (bg:ws_pump:connN / bg:ws_worker:connN.i in stack dumps + task registry)
import itertools as _itertools

_WS_CONN_SEQ = _itertools.count(1)


class BodyTooLarge(Exception):
    """Request body exceeds cnf.HTTP_MAX_BODY_SIZE; connection is dropped."""


def _capped(fn):
    """Route wrapper (the per-request middleware seam, reference
    src/net/mod.rs:68-183 + net/tracer.rs): request-id assignment, client-ip
    extraction, trace-context extraction (W3C `traceparent` or
    `surreal-trace-id`), duration telemetry, and the oversized-body 413
    guard. The root span of the request's trace opens here; `_send` echoes
    the trace id so clients can fetch the tree via GET /trace/:id."""

    def inner(self):
        import time as _time

        from surrealdb_tpu_torch import telemetry, tracing
        from surrealdb_tpu_torch.dbs.capabilities import HTTP_ROUTES

        seg = urlparse(self.path).path.split("/")[1] or "root"
        route = seg if seg in HTTP_ROUTES or seg == "root" else "_other"
        tid, parent = None, None
        tp = self.headers.get("traceparent")
        if tp:
            parsed = tracing.parse_traceparent(tp)
            if parsed is not None:
                tid, parent = parsed
        if tid is None and self.headers.get("surreal-trace-id"):
            tid = self.headers.get("surreal-trace-id")
        # a WS upgrade never gets a request-scoped trace: the handler runs
        # the connection loop for the socket's whole lifetime, and each RPC
        # frame mints its own trace — nesting those under one
        # connection-long root would mis-scope (and never finalize) them
        is_ws = (self.headers.get("Upgrade") or "").lower() == "websocket"
        t0 = _time.perf_counter()
        try:
            if is_ws:
                return fn(self)
            with tracing.request(
                "http_request",
                trace_id=tid,
                parent_id=parent,
                method=self.command or "?",
                route=route,
            ) as tr:
                self._trace_id = tr.trace_id if tr is not None else None
                return fn(self)
        except BodyTooLarge:
            return self._send(413, {"error": "request body too large"})
        finally:
            if is_ws:
                # fn() ran the connection loop until disconnect — that is a
                # connection lifetime, not an HTTP request latency, and
                # would blow out the request histogram's tail
                telemetry.observe(
                    "ws_connection_duration", _time.perf_counter() - t0
                )
            else:
                telemetry.observe(
                    "http_request_duration",
                    _time.perf_counter() - t0,
                    method=self.command or "?",
                    route=route,
                )

    return inner


class SurrealHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = f"surrealdb-tpu/{__version__}"
    ds = None  # set by serve()
    auth_enabled = True
    cors_origins = "*"  # None disables CORS headers entirely

    # ------------------------------------------------------------ plumbing
    def log_message(self, fmt, *args):  # quiet by default
        pass

    def parse_request(self):
        # one handler instance serves many keep-alive requests
        self.__dict__.pop("_cached_body", None)
        self.__dict__.pop("_req_id", None)
        self.__dict__.pop("_trace_id", None)
        return super().parse_request()

    def request_id(self) -> str:
        """Per-request id: the client's x-request-id when given (so traces
        compose across services), else a fresh UUID — echoed on every
        response (reference: src/net/mod.rs request-id layer)."""
        rid = self.__dict__.get("_req_id")
        if rid is None:
            import uuid as _uuid

            rid = self.headers.get("x-request-id") or str(_uuid.uuid4())
            self._req_id = rid[:128]
        return self._req_id

    def client_ip(self) -> str:
        """Originating client ip: first X-Forwarded-For hop, X-Real-IP, or
        the socket peer (reference: src/net/client_ip.rs)."""
        fwd = self.headers.get("x-forwarded-for")
        if fwd:
            return fwd.split(",")[0].strip()
        real = self.headers.get("x-real-ip")
        if real:
            return real.strip()
        return self.client_address[0]

    def _cors_headers(self) -> list:
        origins = self.cors_origins
        if origins is None:
            return []
        origin = self.headers.get("Origin")
        if origins == "*":
            allow = "*"
        elif isinstance(origins, str):
            # a single allowed origin — EXACT match (substring matching
            # would reflect attacker origins)
            if origin != origins:
                return []
            allow = origin
        elif origin and origin in origins:  # list/set membership
            allow = origin
        else:
            return []
        out = [("Access-Control-Allow-Origin", allow)]
        if allow != "*":
            out.append(("Vary", "Origin"))
        return out

    def do_OPTIONS(self):
        """CORS preflight (reference: src/net/mod.rs CorsLayer)."""
        self.send_response(204)
        for k, v in self._cors_headers():
            self.send_header(k, v)
        self.send_header("Access-Control-Allow-Methods", "GET, POST, PUT, PATCH, DELETE, OPTIONS")
        self.send_header(
            "Access-Control-Allow-Headers",
            "Authorization, Content-Type, Accept, NS, DB, surreal-ns, surreal-db, x-request-id",
        )
        self.send_header("Access-Control-Max-Age", "86400")
        self.send_header("x-request-id", self.request_id())
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _body(self) -> bytes:
        if not hasattr(self, "_cached_body"):
            from surrealdb_tpu_torch import cnf

            try:
                n = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                n = -1
            if n < 0 or n > cnf.HTTP_MAX_BODY_SIZE:
                # never read an oversized body — respond 413 and drop the
                # connection (draining would block on bytes that may never
                # arrive)
                self._cached_body = b""
                self.close_connection = True
                raise BodyTooLarge()
            self._cached_body = self.rfile.read(n) if n else b""
        return self._cached_body

    def _send(
        self, code: int, payload: Any, content_type: str = "application/json"
    ) -> int:
        # returns the response body size so data routes (/sql) can charge
        # bytes_out to the session's tenant
        # drain any unread request body first, or the next keep-alive request
        # parses mid-stream
        self._body()
        if content_type == "application/json":
            body = json.dumps(to_json_value(payload)).encode()
        elif content_type == "application/msgpack":
            body = pack(payload)
        elif content_type == "application/cbor":
            from surrealdb_tpu_torch.rpc import cbor as _cbor

            body = _cbor.encode(payload)
        else:
            body = payload if isinstance(payload, bytes) else str(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in self._cors_headers():
            self.send_header(k, v)
        self.send_header("x-request-id", self.request_id())
        tid = self.__dict__.get("_trace_id")
        if tid is not None:
            # echo the request's trace context (inbound id honored, fresh
            # ids discoverable); surreal-trace-id is ALWAYS the resolvable
            # /trace/:id key — traceparent only accompanies it when the id
            # is W3C-shaped (deriving one for an opaque id would name a
            # second, unresolvable trace). Root span id is always 1.
            from surrealdb_tpu_torch import tracing

            self.send_header("surreal-trace-id", tid)
            if tracing.is_hex_trace_id(tid):
                self.send_header("traceparent", tracing.format_traceparent(tid, 1))
        self.end_headers()
        self.wfile.write(body)
        return len(body)

    def _session(self) -> Session:
        """Per-request session from headers (HTTP is stateless)."""
        ns = self.headers.get("surreal-ns") or self.headers.get("NS")
        db = self.headers.get("surreal-db") or self.headers.get("DB")
        sess = Session.anonymous(ns, db)
        auth_header = self.headers.get("Authorization") or ""
        if auth_header.startswith("Basic "):
            import base64

            try:
                user, _, pwd = base64.b64decode(auth_header[6:]).decode().partition(":")
            except Exception as e:
                raise InvalidAuthError() from e
            from surrealdb_tpu_torch.iam.signin import basic_signin

            basic_signin(self.ds, sess, user, pwd, ns, db)
        elif auth_header.startswith("Bearer "):
            from surrealdb_tpu_torch.iam.token import authenticate

            authenticate(self.ds, sess, auth_header[7:])
        elif not self.auth_enabled:
            sess = Session.owner(ns, db)
        sess.ns = sess.ns or ns
        sess.db = sess.db or db
        return sess

    def _authorized_session(self) -> Session:
        """Session for a data-access route: anonymous is rejected when auth
        is enabled unless the operator granted the guest-access capability
        (reference: capabilities.rs allows_guest_access, default deny)."""
        sess = self._session()
        if (
            self.auth_enabled
            and sess.auth.is_anon()
            and not self.ds.capabilities.allows_guest_access()
        ):
            raise InvalidAuthError()
        return sess

    def _system_gate(self):
        """Auth gate for debug surfaces that expose raw statement text
        (/slow, /traces, /trace/:id): require a system user when auth is
        enabled. Returns the session, or None after sending the 401."""
        try:
            sess = self._authorized_session()
            if self.auth_enabled and sess.auth.level not in ("db", "ns", "root"):
                raise InvalidAuthError()
            return sess
        except SurrealError as e:
            self._send(401, {"error": str(e)})
            return None

    def _cluster_query(self) -> bool:
        """True when the request asks for the cluster-federated variant of
        an observability surface (`?cluster=1`) AND this node can serve it
        (attached to a cluster)."""
        from urllib.parse import parse_qs

        q = parse_qs(urlparse(self.path).query)
        return (
            q.get("cluster", [""])[0] in ("1", "true")
            and self.ds.cluster is not None
        )

    def _route_allowed(self, route: str) -> bool:
        """HTTP-route capability gate (reference: RouteTarget allow/deny).
        Sends the 403 itself when denied."""
        if self.ds.capabilities.allows_http_route(route):
            return True
        from surrealdb_tpu_torch.err import RouteNotAllowedError

        self._send(403, {"error": str(RouteNotAllowedError(route))})
        return False

    # ------------------------------------------------------------ routes
    @_capped
    def do_GET(self):
        path = urlparse(self.path).path
        from surrealdb_tpu_torch import telemetry

        seg = path.split("/")[1] or "root"
        # bounded label: arbitrary client paths must not mint unbounded series
        from surrealdb_tpu_torch.dbs.capabilities import HTTP_ROUTES

        telemetry.inc(
            "http_requests",
            method="GET",
            route=seg if seg in HTTP_ROUTES or seg == "root" else "_other",
        )
        if path == "/metrics":
            if not self._route_allowed("metrics"):
                return
            from surrealdb_tpu_torch import telemetry

            if self._cluster_query():
                # federated scrape: every member's registry re-labeled
                # node=<id>, dead members as cluster_scrape_up 0. Unlike
                # the plain (local, cheap) render this fans RPCs out to
                # the whole membership on the scatter pool — debug-class
                # work, so system-gated like the other federation routes
                if self._system_gate() is None:
                    return
                from surrealdb_tpu_torch.cluster.federation import federated_metrics

                return self._send(200, federated_metrics(self.ds).encode(), "text/plain")
            # refresh node runtime gauges (RSS, live queries, jit cache,
            # device memory) so the scrape sees current values
            telemetry.collect_node_metrics(self.ds)
            return self._send(
                200, telemetry.render_prometheus().encode(), "text/plain"
            )
        if path == "/traces" or path.startswith("/trace/"):
            # span trees carry statement text in labels, so like /slow the
            # endpoints need a system user, not just the route capability
            if not self._route_allowed("traces" if path == "/traces" else "trace"):
                return
            if self._system_gate() is None:
                return
            from urllib.parse import parse_qs, unquote

            from surrealdb_tpu_torch import tracing

            if path == "/traces":
                return self._send(200, tracing.list_traces())
            doc = tracing.get_trace(unquote(path.split("/", 2)[2]))
            if doc is None:
                return self._send(404, {"error": "trace not found"})
            fmt = parse_qs(urlparse(self.path).query).get("format", [""])[0]
            if fmt == "chrome":
                return self._send(200, tracing.to_chrome(doc))
            return self._send(200, dict(doc, tree=tracing.span_tree(doc)))
        if path == "/debug/bundle":
            # one-shot flight-recorder bundle (bundle.py): traces + slow/
            # error rings + task registry + compile log + dispatch/mirror
            # state. Carries raw statement text, so system-user-gated like
            # /slow and /traces.
            if not self._route_allowed("debug"):
                return
            if self._system_gate() is None:
                return
            from surrealdb_tpu_torch.bundle import debug_bundle

            if self._cluster_query():
                # the federated bundle: per-node sections merged under this
                # coordinator, dead members marked unreachable — still 200
                from surrealdb_tpu_torch.cluster.federation import federated_bundle

                return self._send(200, federated_bundle(self.ds))
            return self._send(200, debug_bundle(self.ds))
        if path == "/events":
            # the structured event timeline (events.py): trace-linked
            # operational transitions. Carries trace ids + node/session
            # context, so system-gated like the other debug surfaces.
            if not self._route_allowed("events"):
                return
            if self._system_gate() is None:
                return
            from urllib.parse import parse_qs

            from surrealdb_tpu_torch import events as _events

            q = parse_qs(urlparse(self.path).query)
            kind = q.get("kind", [None])[0]
            try:
                limit = int(q.get("limit", [None])[0]) if q.get("limit") else None
            except (TypeError, ValueError):
                limit = None
            if self._cluster_query():
                from surrealdb_tpu_torch.cluster.federation import federated_events

                return self._send(
                    200, federated_events(self.ds, kind_prefix=kind, limit=limit)
                )
            return self._send(
                200, _events.snapshot(kind_prefix=kind, limit=limit)
            )
        if path == "/statements":
            # workload statistics plane (stats.py): cumulative per-
            # statement-shape stats + plan-mix vectors. Normalized SQL
            # shapes are statement text (literals erased, but identifiers
            # and structure intact), so system-gated like /slow and /traces.
            if not self._route_allowed("statements"):
                return
            if self._system_gate() is None:
                return
            from urllib.parse import parse_qs

            from surrealdb_tpu_torch import stats as _stats

            q = parse_qs(urlparse(self.path).query)
            fp = q.get("fingerprint", [None])[0]
            try:
                limit = int(q.get("limit", [None])[0]) if q.get("limit") else 50
            except (TypeError, ValueError):
                limit = 50
            sort = q.get("sort", ["total_s"])[0]
            if self._cluster_query():
                from surrealdb_tpu_torch.cluster.federation import federated_statements

                return self._send(
                    200,
                    federated_statements(
                        self.ds, limit=limit, fingerprint=fp, sort=sort
                    ),
                )
            rows = _stats.statements(limit=limit, fingerprint=fp, sort=sort)
            # plan-cache plane: annotate each shape with its cache state
            # (cached? variants? which dispatch fronts serve warm?)
            return self._send(200, self.ds.plan_cache.annotate(rows))
        if path == "/tenants":
            # tenant cost-attribution plane (accounting.py): per-(ns, db)
            # resource meters with per-fingerprint drill-down. Fingerprints
            # name statement shapes and namespaces name customers, so
            # system-gated like /statements.
            if not self._route_allowed("tenants"):
                return
            if self._system_gate() is None:
                return
            from urllib.parse import parse_qs

            from surrealdb_tpu_torch import accounting as _accounting

            q = parse_qs(urlparse(self.path).query)
            try:
                limit = int(q.get("limit", [None])[0]) if q.get("limit") else 50
            except (TypeError, ValueError):
                limit = 50
            sort = q.get("sort", ["exec_s"])[0]
            if self._cluster_query():
                from surrealdb_tpu_torch.cluster.federation import federated_tenants

                return self._send(
                    200, federated_tenants(self.ds, limit=limit, sort=sort)
                )
            return self._send(200, _accounting.top(limit=limit, sort=sort))
        if path == "/advisor":
            # advisor plane (advisor.py): evidence-chained tuning proposals
            # (observe-only; nothing is ever applied). Proposals cite
            # statement fingerprints and tenant namespaces, so system-gated
            # like /statements and /tenants.
            if not self._route_allowed("advisor"):
                return
            if self._system_gate() is None:
                return
            from urllib.parse import parse_qs

            from surrealdb_tpu_torch import advisor as _advisor

            q = parse_qs(urlparse(self.path).query)
            kind = q.get("kind", [None])[0]
            try:
                limit = int(q.get("limit", [None])[0]) if q.get("limit") else 50
            except (TypeError, ValueError):
                limit = 50
            if self._cluster_query():
                from surrealdb_tpu_torch.cluster.federation import federated_advisor

                return self._send(
                    200, federated_advisor(self.ds, limit=limit)
                )
            if kind:
                return self._send(
                    200, {"proposals": _advisor.proposals(limit=limit, kind=kind)}
                )
            return self._send(200, _advisor.snapshot(limit=limit))
        if path == "/slow":
            # structured slow-query log (ring buffer; dbs/executor.py) — the
            # /metrics-adjacent debug endpoint. Entries carry raw statement
            # text which may embed data literals, so like /export it needs a
            # system user, not just the route capability
            if not self._route_allowed("slow"):
                return
            if self._system_gate() is None:
                return
            from surrealdb_tpu_torch import telemetry

            return self._send(200, telemetry.slow_queries())
        if path == "/health":
            if not self._route_allowed("health"):
                return
            return self._send(200, {"status": "ok"})
        if path == "/version":
            if not self._route_allowed("version"):
                return
            return self._send(200, f"surrealdb-tpu-{__version__}", "text/plain")
        if path == "/rpc" and (self.headers.get("Upgrade") or "").lower() == "websocket":
            if not self._route_allowed("rpc"):
                return
            return self._ws_upgrade()
        if path == "/export":
            if not self._route_allowed("export"):
                return
            try:
                sess = self._authorized_session()
                # export dumps raw KV state, bypassing table/field PERMISSIONS,
                # so it requires a *system* user covering this db — record-access
                # users (public /signup) must not reach it (reference:
                # src/net/export.rs db.check(View, Any.on_db(..)))
                if self.auth_enabled:
                    a = sess.auth
                    if a.level not in ("db", "ns", "root") or not a.has_db_access(
                        sess.ns, sess.db
                    ):
                        raise InvalidAuthError()
                from surrealdb_tpu_torch.kvs.export import export_database

                return self._send(200, export_database(self.ds, sess), "text/plain")
            except SurrealError as e:
                return self._send(401, {"error": str(e)})
        if path.startswith("/ml/export/"):
            if not self._route_allowed("ml"):
                return
            return self._ml_export(path)
        if path.startswith("/key/"):
            if not self._route_allowed("key"):
                return
            return self._key_route("GET")
        return self._send(404, {"error": "not found"})

    @_capped
    def do_POST(self):
        from surrealdb_tpu_torch import telemetry

        telemetry.inc(
            "http_requests",
            method="POST",
            route=urlparse(self.path).path.split("/")[1] or "root",
        )
        path = urlparse(self.path).path
        if path == "/sql":
            if not self._route_allowed("sql"):
                return
            return self._sql()
        if path == "/rpc":
            if not self._route_allowed("rpc"):
                return
            return self._rpc_http()
        if path == "/signin":
            if not self._route_allowed("signin"):
                return
            return self._auth_route("signin")
        if path == "/signup":
            if not self._route_allowed("signup"):
                return
            return self._auth_route("signup")
        if path == "/cluster":
            # internal shard-to-shard channel (surrealdb_tpu_torch/cluster/):
            # CBOR ops authenticated by the shared cluster secret, NOT by
            # user auth — the coordinator's public ingress enforced that.
            # 404 (not 403) when this node is not in a cluster, so a
            # misrouted public client learns nothing about the topology.
            if self.ds.cluster is None:
                return self._send(404, {"error": "not found"})
            if not self._route_allowed("cluster"):
                return
            secret = self.ds.cluster.config.secret
            if secret:
                import hmac as _hmac

                from surrealdb_tpu_torch import events, telemetry
                from surrealdb_tpu_torch.cluster.config import derive_node_key

                # per-node derived credential: recompute HMAC(secret,
                # node:epoch) from the request's own derivation inputs and
                # constant-time compare — the shared secret never rides the
                # wire, so a captured header is one node's one-epoch
                # credential, not cluster-wide system privilege
                given = self.headers.get("x-surreal-cluster-key") or ""
                node = self.headers.get("x-surreal-cluster-node") or ""
                epoch = self.headers.get("x-surreal-cluster-epoch") or "0"
                expect = derive_node_key(secret, node, epoch)
                if not given or not _hmac.compare_digest(given, expect):
                    telemetry.inc("cluster_auth_rejects")
                    events.emit("cluster.auth_reject", node=node)
                    return self._send(401, {"error": "bad cluster key"})
            from surrealdb_tpu_torch.cluster import rpc as _cluster_rpc
            from surrealdb_tpu_torch.rpc import cbor as _cbor

            try:
                req = _cbor.decode(self._body())
            except SurrealError:
                return self._send(400, {"error": "invalid CBOR body"})
            if not isinstance(req, dict):
                return self._send(400, {"error": "cluster request must be a map"})
            return self._send(
                200, _cluster_rpc.handle(self.ds, req), "application/cbor"
            )
        if path == "/ml/import":
            if not self._route_allowed("ml"):
                return
            return self._ml_import()
        if path == "/graphql":
            if not self._route_allowed("graphql"):
                return
            return self._graphql()
        if path == "/import":
            if not self._route_allowed("import"):
                return
            try:
                sess = self._authorized_session()
                out = self.ds.execute(self._body().decode(), sess)
                return self._send(200, out)
            except InvalidAuthError as e:
                return self._send(401, {"error": str(e)})
            except SurrealError as e:
                return self._send(400, {"error": str(e)})
        if path.startswith("/key/"):
            return self._key_route("POST")
        return self._send(404, {"error": "not found"})

    @_capped
    def do_PUT(self):
        if urlparse(self.path).path.startswith("/key/"):
            if not self._route_allowed("key"):
                return
            return self._key_route("PUT")
        return self._send(404, {"error": "not found"})

    @_capped
    def do_PATCH(self):
        if urlparse(self.path).path.startswith("/key/"):
            if not self._route_allowed("key"):
                return
            return self._key_route("PATCH")
        return self._send(404, {"error": "not found"})

    @_capped
    def do_DELETE(self):
        if urlparse(self.path).path.startswith("/key/"):
            if not self._route_allowed("key"):
                return
            return self._key_route("DELETE")
        return self._send(404, {"error": "not found"})

    # ------------------------------------------------------------ handlers
    def _sql(self):
        try:
            sess = self._authorized_session()
        except SurrealError as e:
            return self._send(401, {"error": str(e)})
        body = self._body()
        text = body.decode()
        try:
            out = self.ds.execute(text, sess)
        except SurrealError as e:
            return self._send(400, {"error": str(e)})
        sent = self._send(200, out)
        # wire cost: charged here, at the protocol edge, because only the
        # edge knows the serialized sizes (the executor sees row counts)
        from surrealdb_tpu_torch import accounting

        accounting.charge(
            sess.ns, sess.db, bytes_in=float(len(body)), bytes_out=float(sent)
        )
        return None

    def _auth_route(self, kind: str):
        try:
            creds = json.loads(self._body() or b"{}")
        except json.JSONDecodeError:
            return self._send(400, {"error": "invalid JSON"})
        sess = Session.anonymous()
        try:
            if kind == "signin":
                from surrealdb_tpu_torch.iam.signin import signin

                token = signin(self.ds, sess, creds)
            else:
                from surrealdb_tpu_torch.iam.signup import signup

                token = signup(self.ds, sess, creds)
            return self._send(200, {"code": 200, "details": "Authentication succeeded", "token": token})
        except SurrealError as e:
            return self._send(401, {"code": 401, "details": str(e)})

    def _key_route(self, verb: str):
        """REST /key/{tb}[/{id}] (reference: src/net/key.rs)."""
        from urllib.parse import unquote

        from surrealdb_tpu_torch.sql.value import Thing, escape_ident

        parts = urlparse(self.path).path.split("/")[2:]
        tb = unquote(parts[0]) if parts else None
        rid = unquote(parts[1]) if len(parts) > 1 else None
        if not tb:
            return self._send(400, {"error": "missing table"})
        try:
            sess = self._authorized_session()
        except SurrealError as e:
            return self._send(401, {"error": str(e)})
        # escape path segments — they are identifiers, not SurrealQL
        if rid is not None and rid.lstrip("-").isdigit():
            rid = int(rid)
        target = repr(Thing(tb, rid)) if rid is not None else escape_ident(tb)
        body = self._body()
        try:
            data = json.loads(body) if body else None
        except json.JSONDecodeError:
            return self._send(400, {"error": "invalid JSON body"})
        vars = {"_data": data}
        q = {
            "GET": f"SELECT * FROM {target}",
            "POST": f"CREATE {target} CONTENT $_data",
            "PUT": f"UPSERT {target} CONTENT $_data",
            "PATCH": f"UPSERT {target} MERGE $_data",
            "DELETE": f"DELETE {target} RETURN BEFORE",
        }[verb]
        try:
            out = self.ds.execute(q, sess, vars if data is not None else None)
        except SurrealError as e:
            return self._send(400, {"error": str(e)})
        return self._send(200, out)

    # RPC methods an unauthenticated client may always call (the
    # authentication bootstrap itself plus connection management); whether
    # anonymous clients may call anything ELSE is the operator-controlled
    # guest-access capability (reference: rpc layer + allows_guest_access)
    _RPC_ANON_METHODS = frozenset(
        {"ping", "version", "use", "signin", "signup", "authenticate", "invalidate"}
    )

    def _rpc_denied(self, method: str, sess) -> str | None:
        """Capability policy for one RPC call; returns a denial message or
        None. Method allow/deny applies to every caller; anonymous callers
        additionally need guest access for non-bootstrap methods."""
        if not self.ds.capabilities.allows_rpc_method(method):
            from surrealdb_tpu_torch.err import MethodNotAllowedError

            return str(MethodNotAllowedError(method))
        if (
            self.auth_enabled
            and sess.auth.is_anon()
            and method not in self._RPC_ANON_METHODS
            and not self.ds.capabilities.allows_guest_access()
        ):
            return "Not authenticated"
        return None

    def _system_session(self):
        """Session for model import/export: system user covering the db
        (reference: src/net/ml.rs check on Edit/View)."""
        sess = self._authorized_session()
        if self.auth_enabled:
            a = sess.auth
            if a.level not in ("db", "ns", "root") or not a.has_db_access(sess.ns, sess.db):
                raise InvalidAuthError()
        return sess

    def _ml_import(self):
        try:
            sess = self._system_session()
        except SurrealError as e:
            return self._send(401, {"error": str(e)})
        body = self._body()
        ct = (self.headers.get("Content-Type") or "").split(";")[0]
        if ct == "application/octet-stream" or (body[:1] not in (b"{", b"[")):
            # binary .surml upload (reference src/net/ml.rs import route)
            from surrealdb_tpu_torch.ml.exec import import_surml

            try:
                entry = import_surml(self.ds, sess, body)
            except SurrealError as e:
                return self._send(400, {"error": str(e)})
            return self._send(
                200,
                {"name": entry["name"], "version": entry["version"], "blob": entry["blob"]},
            )
        try:
            spec = json.loads(body)
        except json.JSONDecodeError:
            return self._send(400, {"error": "invalid JSON model spec"})
        from surrealdb_tpu_torch.ml.exec import import_model

        try:
            entry = import_model(
                self.ds, sess, spec.get("name", ""), spec.get("version", ""), spec
            )
        except SurrealError as e:
            return self._send(400, {"error": str(e)})
        except (ValueError, TypeError, AttributeError, KeyError) as e:
            # validate_spec raises these on malformed specs (ragged weight
            # lists, non-dict layers, …) — a bad spec is a client error,
            # never a handler crash; anything else is a genuine 500
            return self._send(400, {"error": f"invalid model spec: {e}"})
        return self._send(200, {"name": entry["name"], "version": entry["version"], "blob": entry["blob"]})

    def _ml_export(self, path: str):
        try:
            sess = self._system_session()
        except SurrealError as e:
            return self._send(401, {"error": str(e)})
        parts = path.split("/")[3:]  # /ml/export/{name}/{version}
        if len(parts) != 2:
            return self._send(400, {"error": "expected /ml/export/{name}/{version}"})
        from urllib.parse import unquote

        from surrealdb_tpu_torch.ml.exec import export_model

        try:
            return self._send(200, export_model(self.ds, sess, unquote(parts[0]), unquote(parts[1])))
        except SurrealError as e:
            return self._send(404, {"error": str(e)})

    def _graphql(self):
        """POST /graphql: {"query": ..., "variables": {...}} (reference:
        src/net/gql.rs; gated by SURREAL_EXPERIMENTAL_GRAPHQL)."""
        try:
            sess = self._authorized_session()
        except SurrealError as e:
            return self._send(401, {"error": str(e)})
        try:
            req = json.loads(self._body())
        except json.JSONDecodeError:
            return self._send(400, {"error": "invalid JSON body"})
        if not isinstance(req, dict):
            return self._send(400, {"error": "GraphQL request must be a JSON object"})
        from surrealdb_tpu_torch.gql import execute_graphql

        try:
            return self._send(200, execute_graphql(self.ds, sess, req))
        except SurrealError as e:
            return self._send(400, {"error": str(e)})
        except Exception as e:  # malformed inputs must never kill the handler
            return self._send(400, {"error": f"{type(e).__name__}: {e}"})

    def _rpc_http(self):
        ct = (self.headers.get("Content-Type") or "application/json").split(";")[0]
        body = self._body()
        try:
            if ct == "application/msgpack":
                req = wire_unpack(body)
            elif ct == "application/cbor":
                from surrealdb_tpu_torch.rpc import cbor as _cbor

                req = _cbor.decode(body)
            else:
                req = json.loads(body)
        except Exception:
            return self._send(400, {"error": "invalid request body"})
        try:
            sess = self._session()
        except SurrealError as e:
            return self._send(401, {"error": str(e)})
        rid = req.get("id")
        method = req.get("method", "")
        denied = self._rpc_denied(method, sess)
        if denied is not None:
            return self._send(
                401, {"id": rid, "error": {"code": -32000, "message": denied}}, ct
            )
        ctx = RpcContext(self.ds, sess)
        try:
            result = ctx.execute(method, req.get("params") or [])
            resp = {"id": rid, "result": result}
        except SurrealError as e:
            resp = {"id": rid, "error": {"code": -32000, "message": str(e)}}
        return self._send(200, resp, ct)

    def _ws_encode(self, payload) -> bytes:
        if getattr(self, "_ws_proto", None) == "cbor":
            from surrealdb_tpu_torch.rpc import cbor as _cbor

            return _cbor.encode(payload)
        return pack(payload)

    # ------------------------------------------------------------ websocket
    def _ws_upgrade(self):
        key = self.headers.get("Sec-WebSocket-Key")
        if not key:
            return self._send(400, {"error": "bad websocket request"})
        # format negotiation via subprotocol (reference rpc/format/mod.rs:
        # json | cbor | msgpack; binary frames use the negotiated codec)
        offered = [
            p.strip()
            for p in (self.headers.get("Sec-WebSocket-Protocol") or "").split(",")
            if p.strip()
        ]
        proto = next((p for p in offered if p in ("json", "cbor", "msgpack")), None)
        self.send_response(101, "Switching Protocols")
        self.send_header("Upgrade", "websocket")
        self.send_header("Connection", "Upgrade")
        self.send_header("Sec-WebSocket-Accept", wsproto.accept_key(key))
        if proto:
            self.send_header("Sec-WebSocket-Protocol", proto)
        self.end_headers()
        self.wfile.flush()
        self._ws_proto = proto

        sock = self.connection
        sess = Session.anonymous()
        sess.rt = True
        if not self.auth_enabled:
            sess = Session.owner(None, None)
            sess.ns = sess.db = None
        ctx = RpcContext(self.ds, sess)
        send_lock = _locks.Lock("net.ws_send")
        alive = {"v": True}
        # wire format follows the client's most recent request frame so JSON
        # (text) clients receive notifications they can actually decode
        fmt = {"binary": False}

        # live-notification pump: drain ONLY this connection's live queries
        def pump():
            import time as _t

            hub = self.ds.notifications
            while alive["v"]:
                sent = False
                if hub is not None:
                    for live_id in list(ctx.live_ids):
                        try:
                            n = hub.subscribe(live_id).get_nowait()
                        except (queue.Empty, KeyError):
                            continue
                        note = {"result": n.to_value()}
                        if fmt["binary"]:
                            frame = wsproto.encode_frame(
                                wsproto.OP_BINARY, self._ws_encode(note)
                            )
                        else:
                            frame = wsproto.encode_frame(
                                wsproto.OP_TEXT, json.dumps(to_json_value(note)).encode()
                            )
                        with send_lock:
                            try:
                                sock.sendall(frame)
                            except OSError:
                                return
                        sent = True
                if not sent:
                    _t.sleep(0.02)

        self.ds.enable_notifications()
        # flight-recorder registration: the pump used to be an anonymous
        # daemon thread — a blind spot in every stack dump and task-registry
        # view (graftlint GL001). conn label makes the name deterministic.
        from surrealdb_tpu_torch import bg

        conn = f"conn{next(_WS_CONN_SEQ)}"
        bg.spawn_service("ws_pump", conn, pump, owner=id(self.ds), restart=True)

        # per-socket concurrent request pool (reference: the WS actor's
        # concurrent-request semaphore, src/rpc/connection.rs:80-147).
        # Concurrency here is what lets one connection's queries coalesce
        # into shared kernel launches (dbs/dispatch.py); session-mutating
        # methods drain in-flight work first and run inline so `use`/
        # `signin` can't race a concurrently-executing query.
        from surrealdb_tpu_torch import cnf, telemetry
        from surrealdb_tpu_torch.net.ws import DaemonPool

        telemetry.gauge_add("ws_connections", 1)
        pool = DaemonPool(
            max(cnf.WEBSOCKET_MAX_CONCURRENT_REQUESTS, 1),
            target=conn, owner=id(self.ds),
        )
        inflight: list = []
        _SESSION_METHODS = {
            "use", "signin", "signup", "authenticate", "invalidate",
            "let", "set", "unset", "reset",
        }

        def handle(req: dict, binary: bool) -> None:
            from surrealdb_tpu_torch import tracing

            rid = req.get("id")
            method = req.get("method", "")
            # per-frame trace context: a client-supplied `trace` field (a
            # 32-hex trace id or a full W3C traceparent) is honored and
            # echoed; every statement of a multi-statement `query` frame
            # shares this one trace
            t_field = req.get("trace")
            tid, t_parent = None, None
            if isinstance(t_field, str) and t_field:
                parsed = tracing.parse_traceparent(t_field)
                if parsed is not None:
                    tid, t_parent = parsed
                else:
                    tid = t_field
            frame = None
            tr = None
            try:
                # the trace opens BEFORE the capability check so a denied
                # request still yields a retrievable (errored, pinned)
                # trace under the id the client supplied
                with tracing.request(
                    "ws_rpc", trace_id=tid, parent_id=t_parent, method=str(method)
                ) as tr:
                    # same capability policy as HTTP /rpc; checked per
                    # message because signin/authenticate upgrade the
                    # session mid-stream
                    denied = self._rpc_denied(method, ctx.session)
                    if denied is not None:
                        raise InvalidAuthError(denied)
                    result = ctx.execute(method, req.get("params") or [])
                resp: Dict[str, Any] = {"id": rid, "result": result}
                if tr is not None and tid is not None:
                    resp["trace"] = tr.trace_id
                # encode INSIDE the guard: an unserializable result must
                # still produce an error frame, never a silent dropped id
                if binary:
                    frame = wsproto.encode_frame(wsproto.OP_BINARY, self._ws_encode(resp))
                else:
                    frame = wsproto.encode_frame(
                        wsproto.OP_TEXT, json.dumps(to_json_value(resp)).encode()
                    )
            except Exception as e:  # noqa: BLE001 — a worker must not die silently
                msg = str(e) if isinstance(e, SurrealError) else f"Internal error: {e}"
                resp = {"id": rid, "error": {"code": -32000, "message": msg}}
                # echo the id the trace is actually STORED under (an opaque
                # client id may have been sanitized) — never a derived one
                if tid is not None and tr is not None:
                    resp["trace"] = tr.trace_id
                if binary:
                    frame = wsproto.encode_frame(wsproto.OP_BINARY, self._ws_encode(resp))
                else:
                    frame = wsproto.encode_frame(
                        wsproto.OP_TEXT, json.dumps(to_json_value(resp)).encode()
                    )
            try:
                with send_lock:
                    sock.sendall(frame)
            except OSError:
                pass

        try:
            while True:
                # read via the buffered rfile (it may hold early frame bytes)
                op, payload = wsproto.read_frame(self.rfile)
                if op == wsproto.OP_CLOSE:
                    with send_lock:
                        sock.sendall(wsproto.encode_frame(wsproto.OP_CLOSE, b""))
                    break
                if op == wsproto.OP_PING:
                    with send_lock:
                        sock.sendall(wsproto.encode_frame(wsproto.OP_PONG, payload))
                    continue
                if op not in (wsproto.OP_TEXT, wsproto.OP_BINARY):
                    continue
                fmt["binary"] = op == wsproto.OP_BINARY
                try:
                    if op != wsproto.OP_BINARY:
                        req = json.loads(payload)
                    elif getattr(self, "_ws_proto", None) == "cbor":
                        from surrealdb_tpu_torch.rpc import cbor as _cbor

                        req = _cbor.decode(payload)
                    else:
                        req = wire_unpack(payload)
                except Exception:
                    continue
                if not isinstance(req, dict):
                    continue
                inflight = [ev for ev in inflight if not ev.is_set()]
                # width of the per-socket concurrent-request window — how
                # many requests ride this socket's pool simultaneously (the
                # population that can coalesce into shared kernel launches)
                telemetry.observe_hist("ws_inflight_width", len(inflight) + 1)
                if str(req.get("method", "")).lower() in _SESSION_METHODS:
                    for ev in inflight:
                        ev.wait()
                    inflight.clear()
                    handle(req, op == wsproto.OP_BINARY)
                else:
                    inflight.append(pool.submit(handle, req, op == wsproto.OP_BINARY))
        except (ConnectionError, OSError):
            pass
        finally:
            alive["v"] = False
            pool.shutdown()
            telemetry.gauge_add("ws_connections", -1)
            # disconnect sweep: KILL this connection's remaining live
            # queries — every close/error path used to leak them into the
            # notification hub forever
            ctx.close()
        self.close_connection = True


class _LoopHttpd:
    """`httpd`-shaped facade over the event-loop ingress. Embedders (and
    a decade of tests) reach through `server.httpd` for the bound handler
    class (`.RequestHandlerClass.ds`) and abrupt teardown
    (`.server_close()`); loop mode keeps both spellings working."""

    def __init__(self, handler_cls, netloop):
        self.RequestHandlerClass = handler_cls
        self._netloop = netloop
        self.server_address = (netloop.host, netloop.port)

    def serve_forever(self) -> None:
        self._netloop.serve_forever()

    def shutdown(self) -> None:
        self._netloop.shutdown()

    def server_close(self) -> None:
        self._netloop.server_close()


class Server:
    """Embedded server handle (reference: `surreal start`).

    Ingress is the selector event loop (net/loop.py) unless
    `SURREAL_NET_LOOP=0` or TLS is configured — TLS handshakes are
    blocking per-socket work, so certificates keep the thread-per-
    connection ingress (documented fallback, not a silent downgrade)."""

    def __init__(
        self,
        ds,
        host: str = "127.0.0.1",
        port: int = 8000,
        auth_enabled: bool = True,
        tls_cert: Optional[str] = None,
        tls_key: Optional[str] = None,
        cors_origins="*",
    ):
        from surrealdb_tpu_torch import cnf

        handler = type(
            "BoundHandler",
            (SurrealHandler,),
            {"ds": ds, "auth_enabled": auth_enabled, "cors_origins": cors_origins},
        )
        self.tls = bool(tls_cert)
        self.loop_mode = bool(cnf.NET_LOOP) and not tls_cert
        if self.loop_mode:
            from surrealdb_tpu_torch.net.loop import EventLoopServer

            self.netloop = EventLoopServer(handler, host, port)
            self.httpd = _LoopHttpd(handler, self.netloop)
        else:
            self.netloop = None
            self.httpd = ThreadingHTTPServer((host, port), handler)
            if tls_cert:
                # TLS termination (reference: surreal start --web-crt/--web-key)
                import ssl

                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ctx.load_cert_chain(tls_cert, tls_key or tls_cert)
                self.httpd.socket = ctx.wrap_socket(
                    self.httpd.socket, server_side=True
                )
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        # node membership bootstrap (reference ds.rs:623): register this
        # node and archive dead nodes' live queries
        try:
            ds.bootstrap()
        except Exception:  # noqa: BLE001 — single-node boot must not die
            from surrealdb_tpu_torch import telemetry

            # counted, not silent: a boot that skipped node registration
            # serves fine single-node but is a membership-protocol gap
            telemetry.inc("bootstrap_errors")
        # periodic maintenance (heartbeat + membership + changefeed GC —
        # reference engine/tasks.rs)
        self._tick_stop = threading.Event()

        def tick_loop():
            from surrealdb_tpu_torch import cnf

            # no inner swallow: an uncaught tick failure (a wedged GC
            # sweep, an injected bg.changefeed_gc panic) propagates to the
            # service supervisor, which restarts the loop with capped
            # backoff and counts bg_service_restarts{kind="tick"} — a
            # crash is a metric, not a silent death of all maintenance
            while not self._tick_stop.wait(cnf.CHANGEFEED_GC_INTERVAL_SECS):
                ds.tick()

        from surrealdb_tpu_torch import bg

        self._ticker = bg.spawn_service(
            "tick", "server", tick_loop, owner=id(ds), restart=True
        )

    @property
    def url(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://{self.host}:{self.port}"

    def start_background(self) -> "Server":
        if self.netloop is not None:
            # the loops ARE the background threads (bg:net_loop:N services)
            self.netloop.start()
            return self
        from surrealdb_tpu_torch import bg

        # detached accept loop: requests mint their own traces inside
        # graftflow: disable=GF002
        self._thread = bg.spawn_service(
            "http_serve", f"{self.host}:{self.port}", self.httpd.serve_forever
        )
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self._tick_stop.set()
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)


def serve(
    path: str = "memory",
    host: str = "127.0.0.1",
    port: int = 8000,
    auth_enabled: bool = True,
    capabilities=None,
    tls_cert: Optional[str] = None,
    tls_key: Optional[str] = None,
    cors_origins="*",
    cluster_config=None,
    device="cuda",
) -> Server:
    """Open the store at `path` on `device` (the card unless the caller
    asks for "cpu"; without a card `Datastore` raises) and wrap it in a
    `Server`."""
    from surrealdb_tpu_torch.kvs.ds import Datastore

    ds = Datastore(path, device=device)
    ds.enable_notifications()
    if capabilities is not None:
        ds.capabilities = capabilities
    if cluster_config is not None:
        # sharded serving: this node owns its consistent-hash slice and
        # coordinates scatter/gather for queries that arrive here; the
        # Datastore above has already reached its device (or raised), so
        # no probe or repair service starts for a node that cannot serve
        from surrealdb_tpu_torch import cluster as _cluster

        _cluster.attach(ds, cluster_config)
    return Server(
        ds, host, port, auth_enabled,
        tls_cert=tls_cert, tls_key=tls_key, cors_origins=cors_origins,
    )
