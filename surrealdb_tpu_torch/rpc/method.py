"""RPC method dispatch.

Role of the reference's Method enum + RpcContext::execute (reference:
core/src/rpc/method.rs:3, rpc_context.rs, basic_context.rs): one
transport-agnostic entry point mapping method names + params onto the
Datastore, tracking per-connection session state (USE, LET, auth).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from surrealdb_tpu_torch.err import InvalidAuthError, SurrealError
from surrealdb_tpu_torch.sql.value import NONE, Table, Thing, Uuid, format_value, is_nullish

METHODS = {
    "ping",
    "info",
    "use",
    "signup",
    "signin",
    "authenticate",
    "invalidate",
    "reset",
    "kill",
    "live",
    "set",
    "let",
    "unset",
    "select",
    "insert",
    "insert_relation",
    "create",
    "upsert",
    "update",
    "merge",
    "patch",
    "delete",
    "relate",
    "run",
    "query",
    "version",
    "graphql",
}


class RpcContext:
    """One client connection's RPC state."""

    def __init__(self, ds, session):
        self.ds = ds
        self.session = session
        self.vars: Dict[str, Any] = {}
        self.live_ids: set = set()  # live queries owned by this connection

    def close(self) -> None:
        """Disconnect sweep: KILL every live query this connection still
        owns. Without this, a WS close/error path leaves the registrations
        live forever — the notification hub keeps buffering matches for a
        subscriber that will never drain them (the r19 leak). Each kill is
        independent: one failure (live id already archived by a node
        takeover) must not strand the rest."""
        from surrealdb_tpu_torch import telemetry

        ids, self.live_ids = list(self.live_ids), set()
        for live_id in ids:
            try:
                self._query("KILL $_id", {"_id": _as_uuid(live_id)})
            except Exception:  # noqa: BLE001 — already-dead registration
                telemetry.inc("live_disconnect_kill_errors")

    # ------------------------------------------------------------ dispatch
    def execute(self, method: str, params: Optional[List[Any]] = None) -> Any:
        from surrealdb_tpu_torch import telemetry, tracing

        params = params or []
        m = method.lower()
        if m not in METHODS:
            # bounded label: arbitrary client-supplied names must not mint
            # unbounded metric series
            telemetry.inc("rpc_errors", method="_unknown", error="MethodNotFound")
            raise SurrealError(f"Method '{method}' not found")

        # one seam covers BOTH the HTTP /rpc route and the WS actor
        # (reference: src/telemetry/metrics/ws/ rpc method instrumentation).
        # tracing.request mints the root trace for embedded SDK callers; under
        # an HTTP/WS ingress the rpc_method span below is the nested node.
        telemetry.inc("rpc_requests", method=m)
        try:
            # nest=False: under an HTTP/WS/SDK ingress root the rpc_method
            # span below IS the node; a second wrapper would only duplicate it
            with tracing.request("rpc", method=m, nest=False), telemetry.span(
                "rpc_method", method=m
            ):
                return getattr(self, f"_m_{m}")(params)
        except Exception as e:
            telemetry.inc("rpc_errors", method=m, error=telemetry.error_class(e))
            raise

    # ------------------------------------------------------------ helpers
    def _query(self, text: str, vars: Optional[Dict[str, Any]] = None) -> List[dict]:
        merged = dict(self.vars)
        if vars:
            merged.update(vars)
        return self.ds.execute(text, self.session, merged)

    def _one_result(self, responses: List[dict]) -> Any:
        resp = responses[-1]
        if resp["status"] != "OK":
            raise SurrealError(str(resp["result"]))
        return resp["result"]

    @staticmethod
    def _target(what: Any) -> str:
        if isinstance(what, Thing):
            return repr(what)
        if isinstance(what, (Table, str)):
            from surrealdb_tpu_torch.sql.value import escape_ident

            s = str(what)
            if ":" in s:
                return repr(Thing.parse(s))
            return escape_ident(s)
        raise SurrealError(f"Invalid target {format_value(what)}")

    # ------------------------------------------------------------ methods
    def _m_ping(self, p) -> Any:
        return NONE

    def _m_version(self, p) -> Any:
        from surrealdb_tpu_torch import __version__

        return f"surrealdb-tpu-{__version__}"

    def _m_info(self, p) -> Any:
        return self._one_result(self._query("SELECT * FROM $auth"))

    def _m_use(self, p) -> Any:
        ns = p[0] if len(p) > 0 else None
        db = p[1] if len(p) > 1 else None
        if ns and not is_nullish(ns):
            self.session.ns = str(ns)
        if db and not is_nullish(db):
            self.session.db = str(db)
        return NONE

    def _m_set(self, p) -> Any:
        if len(p) < 2:
            raise SurrealError("set expects [name, value]")
        self.vars[str(p[0]).lstrip("$")] = p[1]
        return NONE

    _m_let = _m_set

    def _m_unset(self, p) -> Any:
        if p:
            self.vars.pop(str(p[0]).lstrip("$"), None)
        return NONE

    def _m_signin(self, p) -> Any:
        from surrealdb_tpu_torch.iam.signin import signin

        creds = p[0] if p else {}
        return signin(self.ds, self.session, creds)

    def _m_signup(self, p) -> Any:
        from surrealdb_tpu_torch.iam.signup import signup

        creds = p[0] if p else {}
        return signup(self.ds, self.session, creds)

    def _m_authenticate(self, p) -> Any:
        from surrealdb_tpu_torch.iam.token import authenticate

        token = p[0] if p else None
        if not isinstance(token, str):
            raise InvalidAuthError()
        authenticate(self.ds, self.session, token)
        return NONE

    def _m_invalidate(self, p) -> Any:
        from surrealdb_tpu_torch.dbs.session import Auth

        self.session.auth = Auth()
        return NONE

    def _m_reset(self, p) -> Any:
        self.vars = {}
        return self._m_invalidate(p)

    def _m_query(self, p) -> Any:
        if not p or not isinstance(p[0], str):
            raise SurrealError("query expects [text, vars?]")
        vars = p[1] if len(p) > 1 and isinstance(p[1], dict) else None
        return self._query(p[0], vars)

    def _m_select(self, p) -> Any:
        what = self._target(p[0])
        return self._one_result(self._query(f"SELECT * FROM {what}"))

    def _m_create(self, p) -> Any:
        what = self._target(p[0])
        data = p[1] if len(p) > 1 else None
        q = f"CREATE {what}"
        vars = None
        if data is not None:
            q += " CONTENT $_data"
            vars = {"_data": data}
        return self._one_result(self._query(q, vars))

    def _m_insert(self, p) -> Any:
        what = self._target(p[0]) if p and p[0] else None
        data = p[1] if len(p) > 1 else {}
        q = "INSERT INTO " + what if what else "INSERT"
        return self._one_result(self._query(q + " $_data", {"_data": data}))

    def _m_insert_relation(self, p) -> Any:
        what = self._target(p[0]) if p and p[0] else None
        data = p[1] if len(p) > 1 else {}
        q = "INSERT RELATION INTO " + what if what else "INSERT RELATION"
        return self._one_result(self._query(q + " $_data", {"_data": data}))

    def _m_update(self, p) -> Any:
        what = self._target(p[0])
        data = p[1] if len(p) > 1 else None
        q = f"UPDATE {what}"
        vars = None
        if data is not None:
            q += " CONTENT $_data"
            vars = {"_data": data}
        return self._one_result(self._query(q, vars))

    def _m_upsert(self, p) -> Any:
        what = self._target(p[0])
        data = p[1] if len(p) > 1 else None
        q = f"UPSERT {what}"
        vars = None
        if data is not None:
            q += " CONTENT $_data"
            vars = {"_data": data}
        return self._one_result(self._query(q, vars))

    def _m_merge(self, p) -> Any:
        what = self._target(p[0])
        data = p[1] if len(p) > 1 else {}
        return self._one_result(
            self._query(f"UPDATE {what} MERGE $_data", {"_data": data})
        )

    def _m_patch(self, p) -> Any:
        what = self._target(p[0])
        data = p[1] if len(p) > 1 else []
        return self._one_result(
            self._query(f"UPDATE {what} PATCH $_data RETURN DIFF" if len(p) > 2 and p[2] else f"UPDATE {what} PATCH $_data", {"_data": data})
        )

    def _m_delete(self, p) -> Any:
        what = self._target(p[0])
        return self._one_result(self._query(f"DELETE {what} RETURN BEFORE"))

    def _m_relate(self, p) -> Any:
        if len(p) < 3:
            raise SurrealError("relate expects [from, kind, to, data?]")
        f = self._target(p[0])
        kind = self._target(p[1])
        w = self._target(p[2])
        q = f"RELATE {f}->{kind}->{w}"
        vars = None
        if len(p) > 3 and p[3] is not None:
            q += " CONTENT $_data"
            vars = {"_data": p[3]}
        return self._one_result(self._query(q, vars))

    def _m_run(self, p) -> Any:
        if not p:
            raise SurrealError("run expects [name, version?, args?]")
        name = str(p[0])
        args = p[2] if len(p) > 2 and isinstance(p[2], list) else []
        arg_params = {f"_a{i}": a for i, a in enumerate(args)}
        arg_txt = ", ".join(f"$_a{i}" for i in range(len(args)))
        return self._one_result(self._query(f"RETURN {name}({arg_txt})", arg_params))

    def _m_live(self, p) -> Any:
        what = self._target(p[0])
        diff = len(p) > 1 and bool(p[1])
        q = f"LIVE SELECT DIFF FROM {what}" if diff else f"LIVE SELECT * FROM {what}"
        out = self._one_result(self._query(q))
        self.live_ids.add(str(getattr(out, "value", out)))
        return out

    def _m_kill(self, p) -> Any:
        if not p:
            raise SurrealError("kill expects [id]")
        u = _as_uuid(p[0])
        self.live_ids.discard(str(u.value))
        return self._one_result(self._query("KILL $_id", {"_id": u}))

    def _m_graphql(self, p) -> Any:
        from surrealdb_tpu_torch.gql import execute_graphql

        req = p[0] if p else {}
        if isinstance(req, str):
            req = {"query": req}
        return execute_graphql(self.ds, self.session, req)


def _as_uuid(v):
    import uuid as _uuid

    if isinstance(v, Uuid):
        return v
    return Uuid(_uuid.UUID(str(v)))
