"""Record-access signup (reference: core/src/iam/signup.rs)."""

from __future__ import annotations

import time
from typing import Any, Dict

from surrealdb_tpu_torch.err import InvalidAuthError, InvalidSigninError
from surrealdb_tpu_torch.sql.value import Thing

from .token import issue_token


def signup(ds, session, creds: Dict[str, Any]) -> str:
    from surrealdb_tpu_torch.dbs.session import Auth, Session

    ns = creds.get("NS") or creds.get("ns")
    db = creds.get("DB") or creds.get("db")
    ac = creds.get("AC") or creds.get("ac") or creds.get("access")
    if not (ns and db and ac):
        raise InvalidAuthError("No signup target; NS, DB and AC are required")

    txn = ds.transaction(False)
    try:
        acc = txn.get_access((ns, db), ac)
    finally:
        txn.cancel()
    if acc is None or acc.get("access_type") != "record":
        raise InvalidAuthError("Unknown access method")
    signup_expr = acc.get("signup")
    if signup_expr is None:
        raise InvalidAuthError("This access method has no SIGNUP clause")

    sess = Session.owner(ns, db)
    vars = {k: v for k, v in creds.items() if k not in ("NS", "DB", "AC", "ns", "db", "ac")}
    from surrealdb_tpu_torch.dbs.executor import Executor

    ex = Executor(ds, sess, vars)
    rid = ex.compute_expression(signup_expr)
    if isinstance(rid, list):
        rid = rid[0] if rid else None
    if isinstance(rid, dict):
        rid = rid.get("id")
    if not isinstance(rid, Thing):
        raise InvalidSigninError()

    session.ns, session.db = ns, db
    session.auth = Auth("record", ns=ns, db=db, access=ac, rid=rid)
    dur = acc.get("token_duration")
    exp = time.time() + (dur / 10**9 if dur else 3600)
    claims = {
        "ID": repr(rid), "NS": ns, "DB": db, "AC": ac,
        "exp": int(exp), "iss": "surrealdb-tpu",
    }
    return issue_token(claims, acc.get("jwt_key") or "", acc.get("jwt_alg", "HS512"))
