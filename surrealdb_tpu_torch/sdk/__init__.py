"""Typed client SDK.

Role of the reference SDK (reference: sdk/src/api — `Surreal<C>` method
builders, `engine/local` embedding a Datastore, `engine/remote` speaking
WS/HTTP, `engine/any` picking by URL scheme). The Python surface:

    db = Surreal("mem://")                # embedded, in-memory, on the card
    db = Surreal("mem://", device="cpu")  # embedded, plain versions on the CPU
    db = Surreal("file:///data/db")       # embedded, persistent
    db = Surreal("http://host:8000")      # remote HTTP
    db = Surreal("ws://host:8000/rpc")    # remote WebSocket
    db.use("ns", "db")
    db.signin(user="root", password="root")
    db.query("SELECT * FROM person WHERE age > $min", {"min": 18})
    db.create("person", {"name": "x"}); db.select("person:1"); ...
    stream = db.live("person"); stream.next(timeout=1)
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from surrealdb_tpu_torch.err import SurrealError


class Surreal:
    def __init__(self, endpoint: str = "mem://", **opts):
        self.endpoint = endpoint
        scheme = endpoint.split("://", 1)[0].lower()
        if scheme in ("mem", "memory", "file", "surrealkv", "rocksdb"):
            from .local import LocalEngine

            self._engine = LocalEngine(endpoint, **opts)
        elif scheme in ("http", "https"):
            from .remote import HttpEngine

            self._engine = HttpEngine(endpoint, **opts)
        elif scheme in ("ws", "wss"):
            from .remote import WsEngine

            self._engine = WsEngine(endpoint, **opts)
        else:
            raise SurrealError(f"Unsupported endpoint scheme {scheme!r}")

    # ------------------------------------------------------------ session
    def use(self, ns: Optional[str] = None, db: Optional[str] = None) -> "Surreal":
        self._engine.rpc("use", [ns, db])
        return self

    def signin(self, **creds) -> str:
        mapped = {}
        for k, v in creds.items():
            mapped[{"user": "user", "username": "user", "password": "pass"}.get(k, k)] = v
        return self._engine.rpc("signin", [mapped])

    def signup(self, **creds) -> str:
        return self._engine.rpc("signup", [creds])

    def authenticate(self, token: str) -> None:
        self._engine.rpc("authenticate", [token])

    def invalidate(self) -> None:
        self._engine.rpc("invalidate", [])

    def let(self, name: str, value: Any) -> None:
        self._engine.rpc("let", [name, value])

    def unset(self, name: str) -> None:
        self._engine.rpc("unset", [name])

    def info(self) -> Any:
        return self._engine.rpc("info", [])

    def version(self) -> str:
        return self._engine.rpc("version", [])

    def ping(self) -> None:
        self._engine.rpc("ping", [])

    # ------------------------------------------------------------ querying
    def query(self, text: str, vars: Optional[Dict[str, Any]] = None) -> List[dict]:
        return self._engine.rpc("query", [text, vars or {}])

    def select(self, what: str) -> Any:
        return self._engine.rpc("select", [what])

    def create(self, what: str, data: Optional[dict] = None) -> Any:
        return self._engine.rpc("create", [what, data])

    def insert(self, what: str, data: Any) -> Any:
        return self._engine.rpc("insert", [what, data])

    def insert_relation(self, what: str, data: Any) -> Any:
        return self._engine.rpc("insert_relation", [what, data])

    def update(self, what: str, data: Optional[dict] = None) -> Any:
        return self._engine.rpc("update", [what, data])

    def upsert(self, what: str, data: Optional[dict] = None) -> Any:
        return self._engine.rpc("upsert", [what, data])

    def merge(self, what: str, data: dict) -> Any:
        return self._engine.rpc("merge", [what, data])

    def patch(self, what: str, ops: List[dict]) -> Any:
        return self._engine.rpc("patch", [what, ops])

    def delete(self, what: str) -> Any:
        return self._engine.rpc("delete", [what])

    def relate(self, from_: str, kind: str, to: str, data: Optional[dict] = None) -> Any:
        return self._engine.rpc("relate", [from_, kind, to, data])

    def run(self, name: str, version: Optional[str] = None, args: Optional[list] = None) -> Any:
        return self._engine.rpc("run", [name, version, args or []])

    # ------------------------------------------------------------ realtime
    def live(self, table: str, diff: bool = False) -> "LiveStream":
        live_id = self._engine.rpc("live", [table, diff])
        return LiveStream(self, live_id)

    def kill(self, live_id) -> None:
        self._engine.rpc("kill", [str(live_id)])

    # ------------------------------------------------------------ export/import
    def export(self) -> str:
        return self._engine.export()

    def import_(self, text: str) -> None:
        self._engine.import_(text)

    def import_surml(self, raw: bytes) -> dict:
        """Import a surrealml `.surml` model file."""
        return self._engine.import_surml(raw)

    def import_model(self, spec: dict) -> dict:
        """Store an ML model (spec dict with weights) for ml:: calls."""
        return self._engine.import_model(spec)

    def export_model(self, name: str, version: str = "") -> dict:
        return self._engine.export_model(name, version)

    def close(self) -> None:
        self._engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LiveStream:
    """Notifications for one LIVE query (reference sdk Stream type)."""

    def __init__(self, client: Surreal, live_id):
        self.client = client
        # normalize Uuid values to the bare hex-dash string used as hub key
        self.id = str(getattr(live_id, "value", live_id))

    def next(self, timeout: Optional[float] = 1.0):
        return self.client._engine.next_notification(str(self.id), timeout)

    def drain(self) -> list:
        out = []
        while True:
            n = self.next(timeout=0.0)
            if n is None:
                return out
            out.append(n)

    def close(self) -> None:
        self.client.kill(self.id)
