"""Embedded (local) SDK engine: owns a Datastore in-process.

Role of the reference's engine/local (reference: sdk/src/api/engine/local/
native.rs — translates Method::* into Datastore calls, routes live
notifications to per-query channels).
"""

from __future__ import annotations

import queue
from typing import Any, List, Optional

from surrealdb_tpu_torch.dbs.session import Session
from surrealdb_tpu_torch.kvs.ds import Datastore
from surrealdb_tpu_torch.rpc.method import RpcContext


class LocalEngine:
    def __init__(self, endpoint: str, device="cuda"):
        """Open the embedded store on `device`: the card unless the caller
        asks for "cpu" (without a card `Datastore` raises)."""
        scheme, _, rest = endpoint.partition("://")
        if scheme in ("mem", "memory"):
            path = "memory"
        else:
            path = f"{scheme}://{rest}"
        self.ds = Datastore(path, device=device)
        self.ds.enable_notifications()
        self.session = Session.owner(None, None)
        self.rpc_ctx = RpcContext(self.ds, self.session)

    def rpc(self, method: str, params: List[Any]) -> Any:
        # SDK ingress: the embedded engine mints the request trace here so
        # local calls get the same span trees as HTTP/WS ones (tracing.py)
        from surrealdb_tpu_torch import tracing

        with tracing.request("sdk_rpc", method=method.lower()):
            return self.rpc_ctx.execute(method, params)

    def next_notification(self, live_id: str, timeout: Optional[float]):
        hub = self.ds.notifications
        if hub is None:
            return None
        q = hub.subscribe(live_id)
        try:
            n = q.get(timeout=timeout) if timeout else q.get_nowait()
            return n.to_value()
        except queue.Empty:
            return None

    def debug_bundle(self) -> dict:
        """Embedded flight-recorder bundle (the GET /debug/bundle payload)
        without standing up a server — attach it to any perf report."""
        from surrealdb_tpu_torch.bundle import debug_bundle

        return debug_bundle(self.ds)

    def export(self) -> str:
        from surrealdb_tpu_torch.kvs.export import export_database

        return export_database(self.ds, self.session)

    def import_(self, text: str) -> None:
        from surrealdb_tpu_torch.kvs.export import import_database

        import_database(self.ds, self.session, text)

    def import_model(self, spec: dict) -> dict:
        from surrealdb_tpu_torch.ml.exec import import_model

        return import_model(
            self.ds, self.session, spec.get("name", ""), spec.get("version", ""), spec
        )

    def import_surml(self, raw: bytes) -> dict:
        from surrealdb_tpu_torch.ml.exec import import_surml

        return import_surml(self.ds, self.session, raw)

    def export_model(self, name: str, version: str) -> dict:
        from surrealdb_tpu_torch.ml.exec import export_model

        return export_model(self.ds, self.session, name, version)

    def close(self) -> None:
        self.ds.close()
