"""JWT issue/verify for session tokens.

Role of the reference's token machinery (reference: core/src/iam/token.rs,
verify.rs, jwks.rs). HS256/384/512 use stdlib hmac; RS/PS/ES 256/384/512
verify PEM public keys via the `cryptography` backend; JWKS endpoints
(DEFINE ACCESS ... URL) are fetched through the net-target capability with
a TTL cache and keys selected by `kid` (reference iam/jwks.rs cache).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
from surrealdb_tpu_torch.utils import locks as _locks
import time
from typing import Any, Dict, Optional

from surrealdb_tpu_torch.err import ExpiredTokenError, InvalidAuthError

_HS = {"HS256": hashlib.sha256, "HS384": hashlib.sha384, "HS512": hashlib.sha512}
_SHA = {"256": hashlib.sha256, "384": hashlib.sha384, "512": hashlib.sha512}


def _asym_verify(alg: str, key_pem: str, signed: bytes, sig: bytes) -> bool:
    """RS/PS (RSA) and ES (ECDSA) verification over a PEM public key."""
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec, padding, utils

    bits = alg[2:]
    hash_cls = {"256": hashes.SHA256, "384": hashes.SHA384, "512": hashes.SHA512}.get(bits)
    if hash_cls is None:
        return False
    try:
        pub = serialization.load_pem_public_key(key_pem.encode())
    except ValueError as e:
        raise InvalidAuthError("Invalid verification key") from e
    try:
        if alg.startswith("RS"):
            pub.verify(sig, signed, padding.PKCS1v15(), hash_cls())
        elif alg.startswith("PS"):
            pub.verify(
                sig, signed,
                padding.PSS(mgf=padding.MGF1(hash_cls()), salt_length=hash_cls.digest_size),
                hash_cls(),
            )
        elif alg.startswith("ES"):
            # JOSE raw r||s -> DER
            half = len(sig) // 2
            r = int.from_bytes(sig[:half], "big")
            s = int.from_bytes(sig[half:], "big")
            pub.verify(
                utils.encode_dss_signature(r, s), signed, ec.ECDSA(hash_cls())
            )
        else:
            return False
        return True
    except InvalidSignature:
        return False
    except (TypeError, ValueError):
        # key/algorithm type mismatch (e.g. an EC key under RS256) is a
        # clean auth failure, not a server error
        return False


# ------------------------------------------------------------------ JWKS
_JWKS_TTL = 43_200.0  # 12h, reference iam/jwks.rs cache expiry
_JWKS_COOLDOWN = 300.0  # failed-fetch cooldown (reference jwks.rs remote cooldown)
_jwks_cache: Dict[str, tuple] = {}  # url -> (ts, keyset | None on failure)
_jwks_lock = _locks.Lock("iam.jwks")


def _jwk_to_pem(jwk: Dict[str, Any]) -> str:
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import ec, rsa

    def num(field: str) -> int:
        return int.from_bytes(_unb64url(jwk[field]), "big")

    if jwk.get("kty") == "RSA":
        pub = rsa.RSAPublicNumbers(num("e"), num("n")).public_key()
    elif jwk.get("kty") == "EC":
        curve = {"P-256": ec.SECP256R1(), "P-384": ec.SECP384R1(), "P-521": ec.SECP521R1()}[
            jwk["crv"]
        ]
        pub = ec.EllipticCurvePublicNumbers(num("x"), num("y"), curve).public_key()
    else:
        raise InvalidAuthError(f"Unsupported JWK key type {jwk.get('kty')!r}")
    return pub.public_bytes(
        serialization.Encoding.PEM, serialization.PublicFormat.SubjectPublicKeyInfo
    ).decode()


def jwks_key(ds, url: str, kid: Optional[str]) -> str:
    """Resolve a verification key from a JWKS endpoint, TTL-cached per URL;
    the fetch passes the datastore's net-target capability gate
    (reference: iam/jwks.rs fetch + capabilities check)."""
    now = time.monotonic()
    with _jwks_lock:
        hit = _jwks_cache.get(url)
        if hit is not None:
            ts, cached = hit
            if cached is None and now - ts < _JWKS_COOLDOWN:
                # negative cache: a bad token must not trigger a fresh
                # blocking fetch on every attempt
                raise InvalidAuthError("JWKS fetch failed recently (cooldown)")
            keyset = cached if (cached is not None and now - ts < _JWKS_TTL) else None
        else:
            keyset = None
    if keyset is None:
        from surrealdb_tpu_torch.dbs.capabilities import check_net_target

        check_net_target(ds.capabilities, url)
        import urllib.request

        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                keyset = json.loads(resp.read())
        except Exception as e:  # noqa: BLE001 — any fetch failure is an auth failure
            with _jwks_lock:
                _jwks_cache[url] = (now, None)
            raise InvalidAuthError(f"JWKS fetch failed: {e}") from e
        with _jwks_lock:
            _jwks_cache[url] = (now, keyset)
    for jwk in keyset.get("keys", []):
        if kid is None or jwk.get("kid") == kid:
            return _jwk_to_pem(jwk)
    raise InvalidAuthError("No matching JWKS key")


def clear_jwks_cache() -> None:
    with _jwks_lock:
        _jwks_cache.clear()


def _b64url(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def _unb64url(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def issue_token(claims: Dict[str, Any], key: str, alg: str = "HS512") -> str:
    digest = _HS.get(alg.upper())
    if digest is None:
        raise InvalidAuthError(f"Unsupported token algorithm {alg}")
    header = {"alg": alg.upper(), "typ": "JWT"}
    h = _b64url(json.dumps(header, separators=(",", ":")).encode())
    p = _b64url(json.dumps(claims, separators=(",", ":")).encode())
    sig = hmac.new(key.encode(), f"{h}.{p}".encode(), digest).digest()
    return f"{h}.{p}.{_b64url(sig)}"


def verify_token(
    token: str, key: str, alg: Optional[str] = None, ds=None, jwks_url: Optional[str] = None
) -> Dict[str, Any]:
    try:
        h, p, s = token.split(".")
        header = json.loads(_unb64url(h))
        claims = json.loads(_unb64url(p))
    except (ValueError, json.JSONDecodeError) as e:
        raise InvalidAuthError("Invalid token format") from e
    a = header.get("alg", "HS512").upper()
    if alg is not None and a != alg.upper():
        raise InvalidAuthError("Token algorithm mismatch")
    signed = f"{h}.{p}".encode()
    sig = _unb64url(s)
    if jwks_url is not None and ds is not None:
        key = jwks_key(ds, jwks_url, header.get("kid"))
        if a in _HS:
            raise InvalidAuthError("JWKS keys require an asymmetric algorithm")
    if a in _HS:
        expect = hmac.new(key.encode(), signed, _HS[a]).digest()
        if not hmac.compare_digest(expect, sig):
            raise InvalidAuthError("Invalid token signature")
    elif a[:2] in ("RS", "PS", "ES") and a[2:] in _SHA:
        if not _asym_verify(a, key, signed, sig):
            raise InvalidAuthError("Invalid token signature")
    else:
        raise InvalidAuthError(f"Unsupported token algorithm {a}")
    exp = claims.get("exp")
    if exp is not None and time.time() > float(exp):
        raise ExpiredTokenError()
    return claims


def authenticate(ds, session, token: str) -> None:
    """AUTHENTICATE: restore a session from a token issued by signin/signup
    (reference: core/src/iam/verify.rs token paths)."""
    from surrealdb_tpu_torch.dbs.session import Auth
    from surrealdb_tpu_torch.sql.value import Thing

    # decode unverified to find the key-holding definition
    try:
        _, p, _ = token.split(".")
        claims = json.loads(_unb64url(p))
    except (ValueError, json.JSONDecodeError) as e:
        raise InvalidAuthError("Invalid token format") from e

    ns, db, ac = claims.get("NS"), claims.get("DB"), claims.get("AC")
    txn = ds.transaction(False)
    try:
        if ac:
            level = (ns, db) if db else ((ns,) if ns else ())
            acc = txn.get_access(tuple(x for x in level if x), ac)
            if acc is None or not (acc.get("jwt_key") or acc.get("jwt_url")):
                raise InvalidAuthError("Unknown access method")
            claims = verify_token(
                token,
                acc.get("jwt_key") or "",
                # JWKS: the stored alg is the parser's HS512 default, which
                # would reject every asymmetric token — the header alg is
                # validated against the resolved JWK instead (reference
                # iam/verify.rs:181)
                None if acc.get("jwt_url") else acc.get("jwt_alg"),
                ds=ds,
                jwks_url=acc.get("jwt_url"),
            )
            rid = claims.get("ID")
            session.ns, session.db = ns, db
            session.auth = Auth(
                "record", ns=ns, db=db, access=ac,
                rid=Thing.parse(rid) if isinstance(rid, str) else rid,
            )
            session.token = claims
            return
        # user tokens are signed with the stored passhash as key material
        user = claims.get("ID")
        if db:
            u = txn.get_db_user(ns, db, user)
            level = "db"
        elif ns:
            u = txn.get_ns_user(ns, user)
            level = "ns"
        else:
            u = txn.get_root_user(user)
            level = "root"
        if u is None:
            raise InvalidAuthError("Unknown user")
        claims = verify_token(token, u["hash"] or "")
        session.ns = ns or session.ns
        session.db = db or session.db
        session.auth = Auth(level, ns=ns, db=db, user=user, roles=u.get("roles", []))
        session.token = claims
    finally:
        txn.cancel()
