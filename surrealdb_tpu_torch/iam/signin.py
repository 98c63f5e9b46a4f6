"""Signin flows: root / namespace / database users + record access.

Role of the reference's signin module (reference: core/src/iam/signin.rs):
credential shape decides the level; success mutates the session and returns
a JWT.
"""

from __future__ import annotations

import time
from typing import Any, Dict

from surrealdb_tpu_torch.err import InvalidAuthError, InvalidSigninError
from surrealdb_tpu_torch.sql.value import Thing

from .password import verify_password
from .token import issue_token

_DEFAULT_USER_KEY_LIFETIME = 3600  # 1h token unless DURATION overrides


def signin(ds, session, creds: Dict[str, Any]) -> str:
    ns = creds.get("NS") or creds.get("ns")
    db = creds.get("DB") or creds.get("db")
    ac = creds.get("AC") or creds.get("ac") or creds.get("access")
    user = creds.get("user") or creds.get("username")
    pwd = creds.get("pass") or creds.get("password")

    if ac and creds.get("key") is not None:
        # dispatch on the access method's TYPE, not the key's shape: a
        # RECORD method whose SIGNIN reads $key must not be shadowed by a
        # bearer-looking key (reference signin.rs matches on access kind)
        from .access import access_level, bearer_signin

        txn = ds.transaction(False)
        try:
            acd = txn.get_access(access_level(ns, db), ac)
        finally:
            txn.cancel()
        if acd is not None and acd.get("access_type") == "bearer":
            return bearer_signin(ds, session, creds, ac_def=acd)
    if ac and ns and db:
        return _record_signin(ds, session, ns, db, ac, creds)
    if user is None or pwd is None:
        raise InvalidAuthError("No signin target to a root, namespace, database or record user")
    if ns and db:
        return _user_signin(ds, session, ("db", ns, db), user, pwd)
    if ns:
        return _user_signin(ds, session, ("ns", ns, None), user, pwd)
    return _user_signin(ds, session, ("root", None, None), user, pwd)


def basic_signin(ds, session, user: str, pwd: str, ns=None, db=None) -> str:
    """HTTP Basic auth: try the most specific level first, then fall back
    (reference: iam/verify.rs basic — db → ns → root)."""
    attempts = []
    if ns and db:
        attempts.append(("db", ns, db))
    if ns:
        attempts.append(("ns", ns, None))
    attempts.append(("root", None, None))
    last: Exception = InvalidAuthError()
    for level in attempts:
        try:
            return _user_signin(ds, session, level, user, pwd)
        except InvalidAuthError as e:
            last = e
    raise last


def _user_signin(ds, session, level, user: str, pwd: str) -> str:
    from surrealdb_tpu_torch.dbs.session import Auth

    kind, ns, db = level
    txn = ds.transaction(False)
    try:
        if kind == "root":
            u = txn.get_root_user(user)
        elif kind == "ns":
            u = txn.get_ns_user(ns, user)
        else:
            u = txn.get_db_user(ns, db, user)
    finally:
        txn.cancel()
    if u is None or not u.get("hash") or not verify_password(pwd, u["hash"]):
        raise InvalidAuthError("There was a problem with authentication")

    session.ns = ns or session.ns
    session.db = db or session.db
    session.auth = Auth(kind, ns=ns, db=db, user=user, roles=u.get("roles", []))
    dur = u.get("token_duration")
    exp = time.time() + (dur / 10**9 if dur else _DEFAULT_USER_KEY_LIFETIME)
    claims = {"ID": user, "NS": ns, "DB": db, "exp": int(exp), "iss": "surrealdb-tpu"}
    return issue_token(claims, u["hash"] or "")


def _record_signin(ds, session, ns: str, db: str, ac: str, creds: Dict[str, Any]) -> str:
    from surrealdb_tpu_torch.dbs.session import Auth, Session

    txn = ds.transaction(False)
    try:
        acc = txn.get_access((ns, db), ac)
    finally:
        txn.cancel()
    if acc is None or acc.get("access_type") != "record":
        raise InvalidAuthError("Unknown access method")
    signin_expr = acc.get("signin")
    if signin_expr is None:
        raise InvalidAuthError("This access method has no SIGNIN clause")

    # evaluate the SIGNIN expression with the credential params bound
    sess = Session.owner(ns, db)
    vars = {k: v for k, v in creds.items() if k not in ("NS", "DB", "AC", "ns", "db", "ac")}
    from surrealdb_tpu_torch.dbs.executor import Executor

    ex = Executor(ds, sess, vars)
    rid = ex.compute_expression(signin_expr)
    if isinstance(rid, list):
        rid = rid[0] if rid else None
    if isinstance(rid, dict):
        rid = rid.get("id")
    if not isinstance(rid, Thing):
        raise InvalidSigninError()

    session.ns, session.db = ns, db
    session.auth = Auth("record", ns=ns, db=db, access=ac, rid=rid)
    dur = acc.get("token_duration")
    exp = time.time() + (dur / 10**9 if dur else _DEFAULT_USER_KEY_LIFETIME)
    claims = {
        "ID": repr(rid), "NS": ns, "DB": db, "AC": ac,
        "exp": int(exp), "iss": "surrealdb-tpu",
    }
    return issue_token(claims, acc.get("jwt_key") or "", acc.get("jwt_alg", "HS512"))
