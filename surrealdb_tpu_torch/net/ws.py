"""Minimal RFC6455 WebSocket framing (server + client sides).

The reference uses tokio-tungstenite (reference: src/rpc/connection.rs); the
stdlib has no WebSocket support, so the handshake and frame codec live here.
Only the features the RPC protocol needs: text/binary frames, ping/pong,
close, client-side masking.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
from typing import Optional, Tuple

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(opcode: int, payload: bytes, mask: bool = False) -> bytes:
    head = bytearray([0x80 | opcode])
    n = len(payload)
    mbit = 0x80 if mask else 0
    if n < 126:
        head.append(mbit | n)
    elif n < 65536:
        head.append(mbit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mbit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


def _read_exact(sock, n: int) -> bytes:
    """Read exactly n bytes from a socket OR a buffered file-like reader.

    Server handlers must read via their buffered rfile — the HTTP header
    parser may already have consumed the first frame bytes into its buffer;
    reading the raw socket afterwards would desynchronize the stream.
    """
    buf = b""
    reader = sock.recv if hasattr(sock, "recv") else sock.read
    while len(buf) < n:
        chunk = reader(n - len(buf))
        if not chunk:
            raise ConnectionError("websocket closed")
        buf += chunk
    return buf


def read_frame(sock) -> Tuple[int, bytes]:
    """-> (opcode, payload); handles continuation assembly."""
    opcode = None
    payload = b""
    while True:
        b1, b2 = _read_exact(sock, 2)
        fin = b1 & 0x80
        op = b1 & 0x0F
        masked = b2 & 0x80
        n = b2 & 0x7F
        if n == 126:
            n = struct.unpack(">H", _read_exact(sock, 2))[0]
        elif n == 127:
            n = struct.unpack(">Q", _read_exact(sock, 8))[0]
        key = _read_exact(sock, 4) if masked else None
        data = _read_exact(sock, n) if n else b""
        if key:
            data = bytes(b ^ key[i % 4] for i, b in enumerate(data))
        if op != OP_CONT:
            opcode = op
        payload += data
        if fin:
            return opcode if opcode is not None else OP_BINARY, payload


def client_handshake(sock: socket.socket, host: str, path: str) -> bytes:
    """Perform the client upgrade. Returns any frame bytes that arrived in
    the same recv() as the response headers — the caller MUST feed them to
    the frame reader before reading the socket again."""
    key = base64.b64encode(os.urandom(16)).decode()
    req = (
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n"
    )
    sock.sendall(req.encode())
    # read response headers
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("handshake failed")
        buf += chunk
    headers, _, leftover = buf.partition(b"\r\n\r\n")
    status = headers.split(b"\r\n", 1)[0]
    if b"101" not in status:
        raise ConnectionError(f"handshake rejected: {status.decode(errors='replace')}")
    expect = accept_key(key)
    for line in headers.split(b"\r\n"):
        if line.lower().startswith(b"sec-websocket-accept:"):
            got = line.split(b":", 1)[1].strip().decode()
            if got != expect:
                raise ConnectionError("bad accept key")
            return leftover
    raise ConnectionError("missing accept key")


class BufferedSocket:
    """recv() shim serving handshake-leftover bytes before the socket."""

    def __init__(self, sock: socket.socket, leftover: bytes = b""):
        self.sock = sock
        self._buf = leftover

    def recv(self, n: int) -> bytes:
        if self._buf:
            out, self._buf = self._buf[:n], self._buf[n:]
            return out
        return self.sock.recv(n)

    def sendall(self, data: bytes) -> None:
        self.sock.sendall(data)


class DaemonPool:
    """Tiny fixed-size worker pool on DAEMON threads (a stuck query must
    not block interpreter exit the way concurrent.futures' atexit-joined
    workers would — the surrounding HTTP handler threads are daemonized
    for the same reason). submit() returns a threading.Event that sets
    when the task finishes (exceptions included — tasks handle their own
    errors)."""

    def __init__(self, workers: int, target: str = "", owner=None):
        import queue as _queue

        from surrealdb_tpu_torch import bg

        self._q: "_queue.Queue" = _queue.Queue()
        # flight-recorder registration (graftlint GL001): each worker is a
        # bg SERVICE task — deterministic bg:ws_worker:<conn>.<i> names,
        # visible in the task registry, resolved when shutdown() drains
        self._threads = [
            bg.spawn_service(
                "ws_worker",
                f"{target}.{i}" if target else str(i),
                self._worker,
                owner=owner,
                # supervised: a worker that dies on an uncaught exception
                # (panic-class faults included) restarts with backoff
                # instead of silently shrinking the pool
                restart=True,
            )
            for i in range(max(workers, 1))
        ]

    def _worker(self) -> None:
        import time as _time

        from surrealdb_tpu_torch import telemetry

        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, done, t_submit, cvctx = item
            telemetry.observe("ws_pool_queue_wait", _time.perf_counter() - t_submit)
            try:
                # run under the submitter's contextvars snapshot so trace
                # context (tracing.py) survives the thread hand-off
                cvctx.run(fn, *args)
            except Exception:  # noqa: BLE001 — tasks report their own errors
                # through their response frames; count the escape so a
                # crashing pool task is visible on /metrics regardless
                telemetry.inc("ws_pool_task_errors")
            finally:
                done.set()
                telemetry.gauge_add("ws_inflight", -1)

    def submit(self, fn, *args):
        import contextvars as _contextvars
        import threading as _threading
        import time as _time

        from surrealdb_tpu_torch import telemetry

        telemetry.gauge_add("ws_inflight", 1)
        done = _threading.Event()
        self._q.put(
            (fn, args, done, _time.perf_counter(), _contextvars.copy_context())
        )
        return done

    def shutdown(self) -> None:
        for _ in self._threads:
            self._q.put(None)
