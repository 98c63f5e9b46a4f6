"""ACCESS statement execution: bearer-grant lifecycle.

Role of the reference's AccessStatement compute (reference:
core/src/sql/statements/access.rs): `ACCESS ac GRANT FOR USER u | FOR RECORD
r` mints a bearer key `surreal-bearer-{id}-{secret}` (key constants
access.rs:18-31: 12-char id, 24-char secret from a 62-char pool), persisted
under the access method's grant keyspace with creation/expiration/revocation
timestamps; SHOW lists grants redacted (access.rs:118-137 — the key never
leaves the server after issuance); REVOKE stamps `revocation`; PURGE deletes
expired/revoked grants. Signin with `{"ac": ..., "key": "surreal-bearer-…"}`
authenticates against the stored grant (reference iam/signin.rs:749-812
validate_grant_bearer / verify_grant_bearer).
"""

from __future__ import annotations

import secrets
import time
from typing import Any, Dict, List, Optional

from surrealdb_tpu_torch.err import InvalidAuthError, SurrealError
from surrealdb_tpu_torch.sql.value import NONE, Datetime, Thing

GRANT_BEARER_PREFIX = "surreal-bearer"
_POOL = "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
GRANT_BEARER_ID_LENGTH = 12
GRANT_BEARER_KEY_LENGTH = 24
GRANT_BEARER_LENGTH = (
    len(GRANT_BEARER_PREFIX) + 1 + GRANT_BEARER_ID_LENGTH + 1 + GRANT_BEARER_KEY_LENGTH
)


def _rand(n: int, pool: str = _POOL) -> str:
    return "".join(secrets.choice(pool) for _ in range(n))


def new_bearer_grant() -> Dict[str, str]:
    """(id, key) — first id char alphabetic (access.rs:273-282)."""
    gid = _rand(1, _POOL[10:]) + _rand(GRANT_BEARER_ID_LENGTH - 1)
    secret = _rand(GRANT_BEARER_KEY_LENGTH)
    return {"id": gid, "key": f"{GRANT_BEARER_PREFIX}-{gid}-{secret}"}


def _now_ns() -> int:
    return time.time_ns()


def _level(ctx, base: Optional[str]) -> tuple:
    s = ctx.session
    if base is None:
        base = "db" if s.db else ("ns" if s.ns else "root")
    if base == "root":
        return ()
    if base == "ns":
        if not s.ns:
            raise SurrealError("Specify a namespace to use")
        return (s.ns,)
    if not s.ns or not s.db:
        raise SurrealError("Specify a namespace and database to use")
    return (s.ns, s.db)


def _grant_public(gr: dict, redact: bool = True) -> dict:
    """Wire/object form of a grant (reference access.rs:159-202); the bearer
    key is redacted everywhere except at issuance."""
    out = {
        "id": gr["id"],
        "ac": gr["ac"],
        "type": gr.get("type", "bearer"),
        "creation": Datetime(gr["creation"]),
        "expiration": Datetime(gr["expiration"]) if gr.get("expiration") else NONE,
        "revocation": Datetime(gr["revocation"]) if gr.get("revocation") else NONE,
        "subject": dict(gr.get("subject") or {}),
        "grant": {
            "id": gr["id"],
            "key": "[REDACTED]" if redact else gr.get("key"),
        },
    }
    return out


def _is_expired(gr: dict) -> bool:
    exp = gr.get("expiration")
    return exp is not None and exp < _now_ns()


def _is_active(gr: dict) -> bool:
    return not _is_expired(gr) and not gr.get("revocation")


def access_compute(ctx, stm):
    from surrealdb_tpu_torch.iam.check import check_ddl

    base = stm.base
    level = _level(ctx, base)
    base_name = ("root", "ns", "db")[len(level)]
    check_ddl(ctx, "access", target_base=base_name)
    txn = ctx.txn()
    ac = txn.get_access(level, stm.name)
    if ac is None:
        raise SurrealError(
            f"The access method '{stm.name}' does not exist"
        )
    op = stm.op
    if op == "grant":
        return _grant(ctx, txn, level, ac, stm)
    if op == "show":
        return _show(ctx, txn, level, ac, stm)
    if op == "revoke":
        return _revoke(ctx, txn, level, ac, stm)
    if op == "purge":
        return _purge(ctx, txn, level, ac, stm)
    raise SurrealError(f"ACCESS {op.upper()} is not supported")


def _get_user(txn, level: tuple, user: str):
    """User lookup at a (root|ns|db) level tuple."""
    if len(level) == 0:
        return txn.get_root_user(user)
    if len(level) == 1:
        return txn.get_ns_user(level[0], user)
    return txn.get_db_user(level[0], level[1], user)


def _grants_for(txn, level, ac_name: str, want):
    """The grants a GRANT-id/ALL/WHERE form operates on: a point lookup
    when a specific id was given, the full prefix scan otherwise."""
    if want is not None:
        gr = txn.get_grant(level, ac_name, want)
        return [gr] if gr is not None else []
    return txn.all_grants(level, ac_name)


def _grant(ctx, txn, level, ac: dict, stm):
    if ac.get("access_type") != "bearer":
        raise SurrealError(
            f"Grants are only supported for bearer access methods, not "
            f"'{ac.get('access_type')}'"
        )
    user = stm.args.get("user")
    record = stm.args.get("record")
    want_subject = ac.get("bearer_subject", "user")
    if user is not None:
        if want_subject != "user":
            raise SurrealError("This access method expects record subjects")
        # the user must exist at this level (access.rs:335-348)
        u = _get_user(txn, level, user)
        if u is None:
            raise SurrealError(f"The user '{user}' does not exist")
        subject = {"user": user}
    elif record is not None:
        if want_subject != "record":
            raise SurrealError("This access method expects user subjects")
        if len(level) != 2:
            raise SurrealError("Specify a namespace and database to use")
        rid = record.compute(ctx) if hasattr(record, "compute") else record
        if not isinstance(rid, Thing):
            raise SurrealError("FOR RECORD expects a record id")
        subject = {"record": rid}
    else:
        raise SurrealError("ACCESS GRANT requires FOR USER or FOR RECORD")

    bearer = new_bearer_grant()
    dur = ac.get("grant_duration")
    gr = {
        "id": bearer["id"],
        "ac": ac["name"],
        "type": "bearer",
        "creation": _now_ns(),
        "expiration": (_now_ns() + dur) if dur else None,
        "revocation": None,
        "subject": subject,
        "key": bearer["key"],
    }
    if txn.get_grant(level, ac["name"], gr["id"]) is not None:
        raise SurrealError("Grant id collision; purge inactive grants")
    txn.put_grant(level, ac["name"], gr["id"], gr)
    # the ONLY time the key is returned in full (access.rs:414-418)
    return _grant_public(gr, redact=False)


def _show(ctx, txn, level, ac: dict, stm):
    want = stm.args.get("grant")
    cond = stm.args.get("cond")
    out: List[Any] = []
    for gr in _grants_for(txn, level, ac["name"], want):
        pub = _grant_public(gr)
        if cond is not None:
            from surrealdb_tpu_torch.sql.value import truthy

            with ctx.with_doc_value(pub) as c:
                if not truthy(cond.compute(c)):
                    continue
        out.append(pub)
    if want is not None and not out:
        raise SurrealError(f"The grant '{want}' does not exist")
    return out


def _revoke(ctx, txn, level, ac: dict, stm):
    want = stm.args.get("grant")
    cond = stm.args.get("cond")
    now = _now_ns()
    out: List[Any] = []
    for gr in _grants_for(txn, level, ac["name"], want):
        if gr.get("revocation"):
            if want is not None:
                raise SurrealError(f"The grant '{gr['id']}' is already revoked")
            continue
        pub = _grant_public(gr)
        if cond is not None:
            from surrealdb_tpu_torch.sql.value import truthy

            with ctx.with_doc_value(pub) as c:
                if not truthy(cond.compute(c)):
                    continue
        gr["revocation"] = now
        txn.put_grant(level, ac["name"], gr["id"], gr)
        pub["revocation"] = Datetime(now)
        out.append(pub)
    if want is not None:
        if not out:
            raise SurrealError(f"The grant '{want}' does not exist")
        return out[0]
    return out


def _purge(ctx, txn, level, ac: dict, stm):
    expired = stm.args.get("expired", True)
    revoked = stm.args.get("revoked", True)
    grace = stm.args.get("grace") or 0
    now = _now_ns()
    out: List[Any] = []
    for gr in txn.all_grants(level, ac["name"]):
        kill = False
        if expired and gr.get("expiration") and gr["expiration"] + grace < now:
            kill = True
        if revoked and gr.get("revocation") and gr["revocation"] + grace < now:
            kill = True
        if kill:
            txn.del_grant(level, ac["name"], gr["id"])
            out.append(_grant_public(gr))
    return out


# ------------------------------------------------------------------ signin
def access_level(ns: Optional[str], db: Optional[str]) -> tuple:
    """Level tuple from optional NS/DB credentials: () root, (ns,), (ns, db)."""
    return (ns, db) if ns and db else ((ns,) if ns else ())


def bearer_signin(ds, session, creds: Dict[str, Any], ac_def: Optional[dict] = None) -> str:
    """Authenticate a bearer key (reference iam/signin.rs:243-331).
    Level comes from the provided NS/DB; the key's id locates the grant.
    `ac_def` skips the access-method lookup when the caller already has it."""
    from surrealdb_tpu_torch.dbs.session import Auth
    from surrealdb_tpu_torch.iam.token import issue_token

    key = str(creds.get("key") or "")
    ac_name = creds.get("AC") or creds.get("ac") or creds.get("access")
    if len(key) != GRANT_BEARER_LENGTH or not key.startswith(GRANT_BEARER_PREFIX + "-"):
        raise InvalidAuthError("There was a problem with authentication")
    kid = key[len(GRANT_BEARER_PREFIX) + 1 :][:GRANT_BEARER_ID_LENGTH]
    ns = creds.get("NS") or creds.get("ns")
    db = creds.get("DB") or creds.get("db")
    level = access_level(ns, db)
    txn = ds.transaction(False)
    try:
        ac = ac_def if ac_def is not None else txn.get_access(level, ac_name)
        gr = txn.get_grant(level, ac_name, kid) if ac else None
    finally:
        txn.cancel()
    if ac is None or ac.get("access_type") != "bearer" or gr is None:
        raise InvalidAuthError("There was a problem with authentication")
    # constant-time key comparison; opaque error on revoked/expired
    # (verify_grant_bearer, signin.rs:788-812)
    if not secrets.compare_digest(gr.get("key") or "", key) or not _is_active(gr):
        raise InvalidAuthError("There was a problem with authentication")

    subject = gr.get("subject") or {}
    kind = ("root", "ns", "db")[len(level)]
    dur = ac.get("token_duration")
    exp = time.time() + (dur / 10**9 if dur else 3600)
    if "record" in subject:
        rid = subject["record"]
        session.ns, session.db = ns, db
        session.auth = Auth("record", ns=ns, db=db, access=ac_name, rid=rid)
        claims = {"ID": repr(rid), "NS": ns, "DB": db, "AC": ac_name,
                  "exp": int(exp), "iss": "surrealdb-tpu"}
        return issue_token(claims, ac.get("jwt_key") or "", ac.get("jwt_alg", "HS512"))
    user = subject.get("user")
    u_txn = ds.transaction(False)
    try:
        u = _get_user(u_txn, level, user)
    finally:
        u_txn.cancel()
    if u is None:
        raise InvalidAuthError("There was a problem with authentication")
    session.ns = ns or session.ns
    session.db = db or session.db
    session.auth = Auth(kind, ns=ns, db=db, user=user, roles=u.get("roles", []))
    claims = {"ID": user, "NS": ns, "DB": db, "AC": ac_name,
              "exp": int(exp), "iss": "surrealdb-tpu"}
    return issue_token(claims, ac.get("jwt_key") or "", ac.get("jwt_alg", "HS512"))
