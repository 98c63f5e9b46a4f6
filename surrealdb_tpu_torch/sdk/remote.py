"""Remote SDK engines: HTTP and WebSocket.

Role of the reference's engine/remote (reference: sdk/src/api/engine/remote/
— ws via tungstenite, http via reqwest). Wire format is msgpack (the
full-fidelity codec); the WS engine runs a reader thread routing responses
by request id and live notifications into per-query queues.
"""

from __future__ import annotations

import http.client
import itertools
import queue
import socket
from surrealdb_tpu_torch.utils import locks as _locks
from typing import Any, Dict, List, Optional
from urllib.parse import urlparse

from surrealdb_tpu_torch.err import SurrealError
from surrealdb_tpu_torch.net import ws as wsproto
from surrealdb_tpu_torch.utils.ser import wire_pack as pack, wire_unpack as unpack


class HttpEngine:
    def __init__(self, endpoint: str, **opts):
        u = urlparse(endpoint)
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or (443 if u.scheme == "https" else 80)
        self.tls = u.scheme == "https"
        self.headers: Dict[str, str] = {}
        self._session_params: List[Any] = []
        # wire format: msgpack (default) | cbor | json (reference SDKs
        # negotiate per-connection, core/src/rpc/format/mod.rs)
        self.format = opts.get("format", "msgpack")
        if self.format not in ("msgpack", "cbor", "json"):
            raise SurrealError(f"unknown wire format {self.format!r}")

    def rpc(self, method: str, params: List[Any]) -> Any:
        # HTTP is stateless: replay use/auth state as headers
        if method == "use":
            if params and params[0]:
                self.headers["surreal-ns"] = str(params[0])
            if len(params) > 1 and params[1]:
                self.headers["surreal-db"] = str(params[1])
            return None
        if method == "authenticate" and params:
            self.headers["Authorization"] = f"Bearer {params[0]}"
            return None
        resp = self._post("/rpc", {"id": 1, "method": method, "params": params})
        if "error" in resp and resp["error"]:
            raise SurrealError(resp["error"].get("message", "RPC error"))
        result = resp.get("result")
        if method in ("signin", "signup") and isinstance(result, str):
            self.headers["Authorization"] = f"Bearer {result}"
        return result

    def _conn(self, timeout: int = 30):
        cls = http.client.HTTPSConnection if self.tls else http.client.HTTPConnection
        return cls(self.host, self.port, timeout=timeout)

    def _encode(self, body: Any) -> bytes:
        if self.format == "cbor":
            from surrealdb_tpu_torch.rpc import cbor as _cbor

            return _cbor.encode(body)
        if self.format == "json":
            import json as _json

            from surrealdb_tpu_torch.sql.value import to_json_value

            return _json.dumps(to_json_value(body)).encode()
        return pack(body)

    def _decode(self, data: bytes) -> Any:
        if self.format == "cbor":
            from surrealdb_tpu_torch.rpc import cbor as _cbor

            return _cbor.decode(data)
        if self.format == "json":
            import json as _json

            return _json.loads(data)
        return unpack(data)

    def _post(self, path: str, body: Any) -> Any:
        conn = self._conn()
        try:
            headers = {
                "Content-Type": f"application/{self.format}",
                **self.headers,
            }
            conn.request("POST", path, self._encode(body), headers)
            r = conn.getresponse()
            data = r.read()
            if r.status == 401:
                raise SurrealError("Authentication failed")
            return self._decode(data)
        finally:
            conn.close()

    def next_notification(self, live_id: str, timeout: Optional[float]):
        raise SurrealError("Live queries require a WebSocket connection")

    def export(self) -> str:
        conn = self._conn(timeout=60)
        try:
            conn.request("GET", "/export", headers=self.headers)
            return conn.getresponse().read().decode()
        finally:
            conn.close()

    def import_(self, text: str) -> None:
        conn = self._conn(timeout=120)
        try:
            conn.request("POST", "/import", text.encode(), self.headers)
            conn.getresponse().read()
        finally:
            conn.close()

    def import_surml(self, raw: bytes) -> dict:
        import json as _json

        conn = self._conn(timeout=120)
        try:
            hdrs = {**self.headers, "Content-Type": "application/octet-stream"}
            conn.request("POST", "/ml/import", raw, hdrs)
            resp = conn.getresponse()
            out = _json.loads(resp.read())
            if resp.status != 200:
                raise SurrealError(out.get("error", "model import failed"))
            return out
        finally:
            conn.close()

    def import_model(self, spec: dict) -> dict:
        import json as _json

        conn = self._conn(timeout=120)
        try:
            hdrs = {**self.headers, "Content-Type": "application/json"}
            conn.request("POST", "/ml/import", _json.dumps(spec).encode(), hdrs)
            resp = conn.getresponse()
            out = _json.loads(resp.read())
            if resp.status != 200:
                raise SurrealError(out.get("error", "model import failed"))
            return out
        finally:
            conn.close()

    def export_model(self, name: str, version: str) -> dict:
        import json as _json
        from urllib.parse import quote

        conn = self._conn(timeout=120)
        try:
            conn.request(
                "GET", f"/ml/export/{quote(name, safe='')}/{quote(version, safe='')}",
                headers=self.headers,
            )
            resp = conn.getresponse()
            out = _json.loads(resp.read())
            if resp.status != 200:
                raise SurrealError(out.get("error", "model export failed"))
            return out
        finally:
            conn.close()

    def close(self) -> None:
        pass


class WsEngine:
    def __init__(self, endpoint: str, **opts):
        u = urlparse(endpoint)
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 8000
        path = u.path or "/rpc"
        self.sock = socket.create_connection((self.host, self.port), timeout=30)
        leftover = wsproto.client_handshake(self.sock, f"{self.host}:{self.port}", path)
        self.sock.settimeout(None)
        self._rsock = wsproto.BufferedSocket(self.sock, leftover)
        self._ids = itertools.count(1)
        self._pending: Dict[int, "queue.Queue[Any]"] = {}
        self._notifications: Dict[str, "queue.Queue[Any]"] = {}
        self._lock = _locks.Lock("sdk.ws_client")
        self._closed = False
        # registered service thread (graftlint GL001): the reader shows up
        # in the task registry as bg:sdk_reader:<host>:<port> instead of an
        # anonymous daemon — embedded test/SDK processes share the registry
        from surrealdb_tpu_torch import bg

        self._reader = bg.spawn_service(
            "sdk_reader", f"{self.host}:{self.port}", self._read_loop
        )

    def _read_loop(self) -> None:
        try:
            while not self._closed:
                op, payload = wsproto.read_frame(self._rsock)
                if op == wsproto.OP_CLOSE:
                    return
                if op == wsproto.OP_PING:
                    self.sock.sendall(
                        wsproto.encode_frame(wsproto.OP_PONG, payload, mask=True)
                    )
                    continue
                if op != wsproto.OP_BINARY:
                    continue
                msg = unpack(payload)
                mid = msg.get("id")
                if mid is None:
                    # live notification push
                    n = msg.get("result") or {}
                    lid = str(n.get("id"))
                    with self._lock:
                        q = self._notifications.setdefault(lid, queue.Queue())
                    q.put(n)
                    continue
                with self._lock:
                    q = self._pending.pop(mid, None)
                if q is not None:
                    q.put(msg)
        except (ConnectionError, OSError):
            pass

    def rpc(self, method: str, params: List[Any]) -> Any:
        mid = next(self._ids)
        q: "queue.Queue[Any]" = queue.Queue()
        with self._lock:
            self._pending[mid] = q
        frame = wsproto.encode_frame(
            wsproto.OP_BINARY, pack({"id": mid, "method": method, "params": params}), mask=True
        )
        self.sock.sendall(frame)
        msg = q.get(timeout=60)
        if msg.get("error"):
            raise SurrealError(msg["error"].get("message", "RPC error"))
        return msg.get("result")

    def next_notification(self, live_id: str, timeout: Optional[float]):
        with self._lock:
            q = self._notifications.setdefault(live_id, queue.Queue())
        try:
            return q.get(timeout=timeout) if timeout else q.get_nowait()
        except queue.Empty:
            return None

    def export(self) -> str:
        raise SurrealError("export over WebSocket is not supported; use HTTP")

    def import_(self, text: str) -> None:
        raise SurrealError("import over WebSocket is not supported; use HTTP")

    def import_surml(self, raw: bytes) -> dict:
        import json as _json

        conn = self._conn(timeout=120)
        try:
            hdrs = {**self.headers, "Content-Type": "application/octet-stream"}
            conn.request("POST", "/ml/import", raw, hdrs)
            resp = conn.getresponse()
            out = _json.loads(resp.read())
            if resp.status != 200:
                raise SurrealError(out.get("error", "model import failed"))
            return out
        finally:
            conn.close()

    def import_model(self, spec: dict) -> dict:
        raise SurrealError("model import over WebSocket is not supported; use HTTP")

    def export_model(self, name: str, version: str) -> dict:
        raise SurrealError("model export over WebSocket is not supported; use HTTP")

    def close(self) -> None:
        self._closed = True
        try:
            self.sock.sendall(wsproto.encode_frame(wsproto.OP_CLOSE, b"", mask=True))
            self.sock.close()
        except OSError:
            pass
