"""Session: who is connected and where they point.

Role of the reference's Session (reference: core/src/dbs/session.rs:165):
carries the selected namespace/database, the authentication state, realtime
flag, and the session values exposed to queries ($session, $auth, $access,
$token, $ip, $origin).
"""

from __future__ import annotations

import time
import uuid as _uuid
from typing import Any, Dict, Optional


class Auth:
    """Authentication state (reference: core/src/iam Auth/Actor).

    level: "no" | "record" | "db" | "ns" | "root"
    """

    __slots__ = ("level", "ns", "db", "user", "access", "rid", "roles")

    def __init__(
        self,
        level: str = "no",
        ns: Optional[str] = None,
        db: Optional[str] = None,
        user: Optional[str] = None,
        access: Optional[str] = None,
        rid: Any = None,
        roles: Optional[list] = None,
    ):
        self.level = level
        self.ns = ns
        self.db = db
        self.user = user
        self.access = access
        self.rid = rid  # record id for record-level access
        self.roles = roles or []

    def is_anon(self) -> bool:
        return self.level == "no"

    def is_root(self) -> bool:
        return self.level == "root"

    def is_owner(self) -> bool:
        return self.level == "root" or "Owner" in self.roles

    def has_db_access(self, ns: str, db: str) -> bool:
        if self.level == "root":
            return True
        if self.level == "ns":
            return self.ns == ns
        if self.level in ("db", "record"):
            return self.ns == ns and self.db == db
        return False


class Session:
    __slots__ = ("id", "ns", "db", "auth", "rt", "ip", "origin", "token", "expires")

    def __init__(
        self,
        ns: Optional[str] = None,
        db: Optional[str] = None,
        auth: Optional[Auth] = None,
        rt: bool = False,
    ):
        self.id = str(_uuid.uuid4())
        self.ns = ns
        self.db = db
        self.auth = auth or Auth()
        self.rt = rt  # realtime (live query) capable connection
        self.ip: Optional[str] = None
        self.origin: Optional[str] = None
        self.token: Optional[Dict[str, Any]] = None
        self.expires: Optional[float] = None

    # ------------------------------------------------------------ factories
    @staticmethod
    def owner(ns: Optional[str] = "test", db: Optional[str] = "test") -> "Session":
        """A fully-privileged session (used by embedded/local engines)."""
        return Session(ns, db, Auth("root", roles=["Owner"]), rt=True)

    @staticmethod
    def editor(ns: Optional[str] = "test", db: Optional[str] = "test") -> "Session":
        return Session(ns, db, Auth("root", roles=["Editor"]), rt=True)

    @staticmethod
    def viewer(ns: Optional[str] = "test", db: Optional[str] = "test") -> "Session":
        return Session(ns, db, Auth("root", roles=["Viewer"]), rt=True)

    @staticmethod
    def anonymous(ns: Optional[str] = None, db: Optional[str] = None) -> "Session":
        return Session(ns, db, Auth("no"))

    @staticmethod
    def for_record(ns: str, db: str, access: str, rid) -> "Session":
        return Session(ns, db, Auth("record", ns=ns, db=db, access=access, rid=rid), rt=True)

    # ------------------------------------------------------------ values
    def expired(self) -> bool:
        return self.expires is not None and time.time() > self.expires

    def session_value(self) -> Dict[str, Any]:
        """The $session object."""
        return {
            "id": self.id,
            "ns": self.ns,
            "db": self.db,
            "ip": self.ip,
            "or": self.origin,
            "ac": self.auth.access,
            "rd": self.auth.rid,
            "exp": self.expires,
        }

    def auth_value(self) -> Any:
        """The $auth value: the record id for record access, else NONE."""
        from surrealdb_tpu_torch.sql.value import NONE

        if self.auth.level == "record":
            return self.auth.rid
        return NONE
