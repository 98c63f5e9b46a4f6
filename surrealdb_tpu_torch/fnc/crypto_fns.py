"""crypto:: functions (reference: core/src/fnc/crypto.rs).

The reference offloads the password KDFs to a blocking thread pool
(reference: fnc/mod.rs:463-470 cpu_intensive); here they run inline on host —
they are host-side by design in the TPU build too.
"""

from __future__ import annotations

import hashlib

from surrealdb_tpu_torch.err import InvalidArgumentsError
from surrealdb_tpu_torch.iam.password import hash_password, verify_password

from . import register


def _s(v, name) -> str:
    if not isinstance(v, str):
        raise InvalidArgumentsError(name, "Argument was the wrong type. Expected a string.")
    return v


@register("crypto::md5")
def md5(ctx, s):
    return hashlib.md5(_s(s, "crypto::md5").encode()).hexdigest()


@register("crypto::sha1")
def sha1(ctx, s):
    return hashlib.sha1(_s(s, "crypto::sha1").encode()).hexdigest()


@register("crypto::sha256")
def sha256(ctx, s):
    return hashlib.sha256(_s(s, "crypto::sha256").encode()).hexdigest()


@register("crypto::sha512")
def sha512(ctx, s):
    return hashlib.sha512(_s(s, "crypto::sha512").encode()).hexdigest()


@register("crypto::blake3")
def blake3(ctx, s):
    # blake3 isn't in the stdlib; blake2b fills the same "fast modern hash"
    # role with the same output size
    return hashlib.blake2b(_s(s, "crypto::blake3").encode(), digest_size=32).hexdigest()


# password KDFs (reference: fnc/crypto.rs argon2/bcrypt/pbkdf2/scrypt
# generate+compare). argon2 and scrypt run their REAL algorithms (argon2-cffi
# backend / hashlib's OpenSSL scrypt) emitting PHC strings; pbkdf2 uses
# stdlib pbkdf2_hmac; bcrypt has no available backend, so its names stay
# callable but hash via PBKDF2 with a self-describing prefix (documented
# deliberate absence — hashes verify within this engine, not against
# foreign bcrypt digests).
import base64 as _b64
import os as _os


def _phc_b64(b: bytes) -> str:
    return _b64.b64encode(b).decode().rstrip("=")


def _phc_unb64(s: str) -> bytes:
    return _b64.b64decode(s + "=" * (-len(s) % 4))


@register("crypto::argon2::generate")
def _argon2_gen(ctx, s):
    from argon2 import PasswordHasher

    return PasswordHasher().hash(_s(s, "crypto::argon2::generate"))


@register("crypto::argon2::compare")
def _argon2_cmp(ctx, hashed, plain):
    from argon2 import PasswordHasher
    from argon2 import exceptions as _argon2_exc

    h = _s(hashed, "crypto::argon2::compare")
    p = _s(plain, "crypto::argon2::compare")
    if h.startswith("pbkdf2$"):
        # hashes generated before the real argon2 backend landed
        return verify_password(p, h)
    try:
        return PasswordHasher().verify(h, p)
    except (_argon2_exc.VerificationError, _argon2_exc.InvalidHashError, ValueError):
        return False


_SCRYPT = {"n": 1 << 15, "r": 8, "p": 1}


@register("crypto::scrypt::generate")
def _scrypt_gen(ctx, s):
    salt = _os.urandom(16)
    dk = hashlib.scrypt(
        _s(s, "crypto::scrypt::generate").encode(), salt=salt,
        n=_SCRYPT["n"], r=_SCRYPT["r"], p=_SCRYPT["p"], maxmem=64 * 1024 * 1024,
    )
    ln = _SCRYPT["n"].bit_length() - 1
    return f"$scrypt$ln={ln},r={_SCRYPT['r']},p={_SCRYPT['p']}${_phc_b64(salt)}${_phc_b64(dk)}"


@register("crypto::scrypt::compare")
def _scrypt_cmp(ctx, hashed, plain):
    import hmac as _hmac

    h = _s(hashed, "crypto::scrypt::compare")
    if h.startswith("pbkdf2$"):
        # hashes generated before the real scrypt backend landed
        return verify_password(_s(plain, "crypto::scrypt::compare"), h)
    try:
        _, scheme, params, salt_s, dk_s = h.split("$")
        if scheme != "scrypt":
            return False
        p = dict(kv.split("=") for kv in params.split(","))
        dk = hashlib.scrypt(
            _s(plain, "crypto::scrypt::compare").encode(),
            salt=_phc_unb64(salt_s),
            n=1 << int(p["ln"]), r=int(p["r"]), p=int(p["p"]),
            maxmem=64 * 1024 * 1024,
        )
        return _hmac.compare_digest(dk, _phc_unb64(dk_s))
    except (ValueError, KeyError):
        return False


def _kdf(name):
    @register(f"crypto::{name}::generate")
    def gen(ctx, s, _n=name):
        return hash_password(_s(s, f"crypto::{_n}::generate"))

    @register(f"crypto::{name}::compare")
    def cmp(ctx, hashed, plain, _n=name):
        return verify_password(_s(plain, f"crypto::{_n}::compare"), _s(hashed, f"crypto::{_n}::compare"))


for _n in ("bcrypt", "pbkdf2"):
    _kdf(_n)
