"""Password hashing for DEFINE USER / signin.

The reference uses Argon2 via the argon2 crate (reference: core/src/iam/
signin.rs verify paths). Argon2 isn't in the baked-in dependency set, so we
use PBKDF2-HMAC-SHA256 from the stdlib with a random salt — same role,
constant-time verify.
"""

from __future__ import annotations

import hashlib
import hmac
import os

_ITERATIONS = 100_000


def hash_password(password: str) -> str:
    salt = os.urandom(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, _ITERATIONS)
    return f"pbkdf2${_ITERATIONS}${salt.hex()}${dk.hex()}"


def verify_password(password: str, stored: str) -> bool:
    try:
        scheme, iters, salt_hex, dk_hex = stored.split("$")
        if scheme != "pbkdf2":
            return False
        dk = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), bytes.fromhex(salt_hex), int(iters)
        )
        return hmac.compare_digest(dk.hex(), dk_hex)
    except (ValueError, AttributeError):
        return False
