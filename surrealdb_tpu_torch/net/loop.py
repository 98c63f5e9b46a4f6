"""Selector-based event-loop ingress (the C1M network plane).

The r10 ingress was thread-per-connection (`ThreadingHTTPServer` + a
`bg:ws` pool per socket): correct, but a few thousand sockets of thread
stacks and scheduler thrash away from the north star's "heavy traffic
from millions of users". This module rebuilds ingress as
`SURREAL_NET_LOOPS` nonblocking accept/read/write loops multiplexing
HTTP parsing and RFC6455 WS framing for 100k+ sockets:

- the LOOP owns sockets: nonblocking accept, incremental HTTP header/
  body assembly, incremental WS frame assembly, and per-connection
  bounded write queues. It never parses SurrealQL and never executes a
  statement;
- fully-decoded requests hand off to a bounded executor pool
  (`SURREAL_NET_EXECUTORS` supervised `bg:net_exec` workers) through the
  per-tenant weighted-fair admission plane (net/qos.py). Responses come
  back as atomic byte-chunk appends to the connection's write queue;
- every overload path is a BOUNDED buffer and a clean counted close,
  never unbounded memory: accepts past `SURREAL_NET_MAX_CONNS` shed
  immediately, header dribblers (slowloris) die at
  `SURREAL_NET_HEADER_TIMEOUT`, and a reader that never drains its
  write queue is closed once `SURREAL_NET_WRITE_BUF_MAX` queued bytes
  accumulate (`net.backpressure_close`).

Route logic is NOT duplicated: a decoded HTTP request replays through
the existing `SurrealHandler` routes via an in-memory rfile/wfile
adapter, so both ingresses serve byte-identical responses. WS framing
is loop-native (the threaded upgrade path runs a blocking per-socket
loop that cannot ride a selector) but dispatches into the same
RpcContext, and one shared `bg:net_notify` pump drains live-query
notifications for EVERY connection on the server — not a thread per
socket.

Scale beyond the fd rlimit: connections are transport-agnostic. A
`VirtualConn` (attach_virtual) runs the same state machine — HTTP
parse, QoS admission, executor dispatch, bounded write queue — with
byte buffers fed/drained by the caller instead of a kernel socket, so
the connection-scale bench can hold 20k+ concurrent connections on a
container whose hard RLIMIT_NOFILE is 20000.

This module is event-loop-marked (graftlint GL016): blocking socket
calls (`recv`/`sendall`/`accept` outside the `_nb_*` nonblocking
wrappers) and `time.sleep` are lint findings here — one blocking call
on the loop thread stalls every socket it owns.
"""

from __future__ import annotations

import heapq
import io
import itertools
import json
import queue as _queue
import selectors
import socket
import struct
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.utils import locks as _locks

from . import qos
from . import ws as wsproto

# graftlint GL016 marker: the rules below apply to this whole module
EVENT_LOOP_MODULE = True

_CONN_SEQ = itertools.count(1)
_MAX_HEADER = 64 * 1024  # request line + headers assembly cap
_READ_CHUNK = 65536

# session-mutating RPC methods run ALONE on their connection (drain the
# concurrent-request window first) — same contract as the threaded ingress
_WS_SESSION_METHODS = frozenset(
    {"use", "signin", "signup", "authenticate", "invalidate",
     "let", "set", "unset", "reset"}
)


# ------------------------------------------------------------------ nb wrappers
def _nb_accept(listener: socket.socket):
    """Nonblocking accept: (sock, addr) or None when no connection is
    pending. The ONLY sanctioned accept call in an event-loop module."""
    try:
        return listener.accept()
    except (BlockingIOError, InterruptedError):
        return None
    except OSError:
        return None


def _nb_recv(sock, n: int) -> Optional[bytes]:
    """Nonblocking read: bytes, b'' on EOF, None when no data is ready.
    The ONLY sanctioned recv call in an event-loop module."""
    try:
        return sock.recv(n)
    except (BlockingIOError, InterruptedError):
        return None
    except OSError:
        return b""


def _nb_send_some(sock, view) -> int:
    """Nonblocking partial send: bytes written (0 = try later, -1 = dead
    socket). The ONLY sanctioned send call in an event-loop module."""
    try:
        return sock.send(view)
    except (BlockingIOError, InterruptedError):
        return 0
    except OSError:
        return -1


# ------------------------------------------------------------------ conn state
class _Conn:
    """One connection's state machine — real socket or virtual transport."""

    __slots__ = (
        "cid", "loop", "sock", "sink", "peer", "inbuf", "outq", "out_bytes",
        "state", "accepted_t", "first_byte_t", "header_deadline",
        "body_total", "http_busy", "close_after_flush", "closed", "ws",
        "want_write", "__weakref__",
    )

    def __init__(self, loop: "_Loop", sock: Optional[socket.socket], sink):
        self.cid = next(_CONN_SEQ)
        self.loop = loop
        self.sock = sock
        self.sink = sink  # virtual-conn output callable (None = accumulate)
        try:
            self.peer = sock.getpeername() if sock is not None else ("virtual", self.cid)
        except OSError:
            self.peer = ("?", 0)
        self.inbuf = bytearray()
        self.outq: Deque[memoryview] = deque()
        self.out_bytes = 0
        self.state = "headers"  # headers -> body -> (headers | ws)
        self.accepted_t = time.monotonic()
        self.first_byte_t: Optional[float] = None
        self.header_deadline = self.accepted_t + max(
            cnf.NET_HEADER_TIMEOUT_SECS, 0.05
        )
        self.body_total = 0  # header_end + content-length while reading a body
        self.http_busy = False  # a request is executing; don't parse the next
        self.close_after_flush = False
        self.closed = False
        self.ws: Optional[dict] = None  # set on upgrade
        self.want_write = False

    @property
    def virtual(self) -> bool:
        return self.sock is None


class VirtualConn:
    """Caller-facing handle for a loop-attached in-memory connection: the
    full ingress state machine without a kernel socket. `feed()` injects
    client->server bytes; output either streams into `collect` or
    accumulates in the bounded write queue (pass collect=None to model a
    reader that never drains — the backpressure-close test shape)."""

    def __init__(self, loop: "_Loop", conn: _Conn, collected: Optional[List[bytes]]):
        self._loop = loop
        self._conn = conn
        self._collected = collected

    def feed(self, data: bytes) -> None:
        self._loop._cmd(("feed", self._conn, bytes(data)))

    def take_output(self) -> bytes:
        if self._collected is None:
            return b""
        out = b"".join(self._collected)
        del self._collected[: len(self._collected)]
        return out

    def close(self) -> None:
        self._loop._cmd(("close", self._conn, "client"))

    @property
    def closed(self) -> bool:
        return self._conn.closed


# ------------------------------------------------------------------ executor
class _ExecPool:
    """Bounded worker pool for decoded requests. Workers are supervised
    bg services (`bg:net_exec:<i>`) — visible in the task registry, and a
    crash restarts with backoff instead of silently shrinking the pool."""

    def __init__(self, workers: int, owner=None):
        from surrealdb_tpu_torch import bg

        self._q: "_queue.Queue" = _queue.Queue()
        self._threads = [
            # detached service workers: each submit() copies the submitter's
            # context (see _worker) — the spawn itself has no arming trace
            # graftflow: disable=GF002
            bg.spawn_service("net_exec", str(i), self._worker, owner=owner, restart=True)
            for i in range(max(workers, 1))
        ]

    def _worker(self) -> None:
        import contextvars as _cv  # noqa: F401 — submit side copies context

        from surrealdb_tpu_torch import telemetry

        while True:
            item = self._q.get()
            if item is None:
                return
            fn, cvctx = item
            try:
                cvctx.run(fn)
            except Exception:  # noqa: BLE001 — tasks answer their own errors
                # through response bytes; count the escape regardless
                telemetry.inc("net_exec_task_errors")

    def submit(self, fn: Callable[[], None]) -> None:
        import contextvars as _cv

        self._q.put((fn, _cv.copy_context()))

    def shutdown(self) -> None:
        for _ in self._threads:
            self._q.put(None)


# ------------------------------------------------------------------ the loop
class _Loop:
    """One selector thread owning a shard of the server's sockets."""

    def __init__(self, server: "EventLoopServer", idx: int):
        self.server = server
        self.idx = idx
        self.sel = selectors.DefaultSelector()
        self._lock = _locks.Lock("net.loop")
        self._cmds: Deque[tuple] = deque()
        self._stop = threading.Event()
        self.conns: set = set()
        self.ws_conns: set = set()
        self._dirty_virtual: set = set()
        self._deadlines: list = []  # heap of (deadline, cid, conn)
        # wakeup channel: any thread appends a cmd and pokes this pipe
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self.sel.register(self._wake_r, selectors.EVENT_READ, None)
        self.listener: Optional[socket.socket] = None

    # ------------------------------------------------------ cross-thread API
    def _cmd(self, cmd: tuple) -> None:
        with self._lock:
            self._cmds.append(cmd)
        self._wake()

    def _wake(self) -> None:
        _nb_send_some(self._wake_w, b"\x00")

    def enqueue_write(self, conn: _Conn, data: bytes) -> None:
        """Append one atomic chunk (a full response / frame) to a
        connection's bounded write queue; any thread may call this."""
        from surrealdb_tpu_torch import telemetry

        overflow = False
        with self._lock:
            if conn.closed:
                return
            conn.outq.append(memoryview(bytes(data)))
            conn.out_bytes += len(data)
            if conn.out_bytes > max(cnf.NET_WRITE_BUF_MAX, 4096):
                overflow = True
            self._cmds.append(("drain", conn, None))
        telemetry.observe_hist("net_write_queue_bytes", conn.out_bytes)
        if overflow:
            self._cmd(("close", conn, "backpressure"))
        else:
            self._wake()

    def attach_virtual(self, collect: bool = True) -> VirtualConn:
        """Attach an in-memory connection (see VirtualConn). collect=False
        models a reader that never drains its write queue."""
        from surrealdb_tpu_torch import telemetry

        conn = _Conn(self, None, None)
        collected: Optional[List[bytes]] = [] if collect else None
        if collect:
            conn.sink = collected.append
        with self._lock:
            self.conns.add(conn)
        heapq.heappush(self._deadlines, (conn.header_deadline, conn.cid, conn))
        telemetry.gauge_add("net_connections", 1)
        self._wake()
        return VirtualConn(self, conn, collected)

    # ------------------------------------------------------------ main loop
    def run(self) -> None:
        try:
            while not self._stop.is_set():
                self._tick()
        finally:
            self._close_all()

    def _tick(self) -> None:
        timeout = 0.05
        if self._dirty_virtual or self._cmds:
            timeout = 0.0
        elif self._deadlines:
            timeout = min(timeout, max(self._deadlines[0][0] - time.monotonic(), 0.0))
        for key, mask in self.sel.select(timeout):
            if key.data is None:  # wakeup pipe
                while _nb_recv(self._wake_r, 4096):
                    pass
                continue
            if key.data == "listener":
                self._accept_ready()
                continue
            conn = key.data
            if mask & selectors.EVENT_READ:
                self._read_ready(conn)
            if mask & selectors.EVENT_WRITE and not conn.closed:
                self._write_ready(conn)
        self._run_cmds()
        self._drain_virtual()
        qos.poll()
        self._expire_deadlines()

    def _run_cmds(self) -> None:
        while True:
            with self._lock:
                if not self._cmds:
                    return
                cmd, conn, arg = self._cmds.popleft()
            if cmd == "feed":
                if conn is not None and not conn.closed:
                    conn.inbuf += arg
                    self._process(conn)
                    self._dirty_virtual.add(conn)
            elif cmd == "drain":
                if not conn.closed:
                    if conn.virtual:
                        self._dirty_virtual.add(conn)
                    else:
                        self._write_ready(conn)
            elif cmd == "close":
                self._close(conn, arg or "server")
            elif cmd == "http_done":
                if not conn.closed:
                    conn.http_busy = False
                    if conn.close_after_flush:
                        self._flush_interest(conn)
                    else:
                        self._process(conn)  # a pipelined next request may wait
            elif cmd == "ws_done":
                self._ws_next(conn)
            elif cmd == "stop":
                self._stop.set()

    # ------------------------------------------------------------ accepting
    def _accept_ready(self) -> None:
        from surrealdb_tpu_torch import events, telemetry

        shed = 0
        while True:
            pair = _nb_accept(self.listener)
            if pair is None:
                break
            sock, _addr = pair
            if self.server.total_conns() >= max(cnf.NET_MAX_CONNS, 8):
                # accept storm past the cap: shed with an immediate close —
                # a counted refusal, not an unbounded accept queue
                try:
                    sock.close()
                except OSError:
                    pass
                shed += 1
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(self, sock, None)
            with self._lock:
                self.conns.add(conn)
            self.sel.register(sock, selectors.EVENT_READ, conn)
            heapq.heappush(self._deadlines, (conn.header_deadline, conn.cid, conn))
            telemetry.gauge_add("net_connections", 1)
        if shed:
            telemetry.inc("net_overload_close", reason="conn_cap", by=float(shed))
            events.emit("net.overload_close", reason="conn_cap", count=shed)

    # ------------------------------------------------------------ reading
    def _read_ready(self, conn: _Conn) -> None:
        budget = 4 * _READ_CHUNK  # per-conn per-tick read fairness
        while budget > 0 and not conn.closed:
            data = _nb_recv(conn.sock, _READ_CHUNK)
            if data is None:
                break
            if data == b"":
                self._close(conn, "eof")
                return
            conn.inbuf += data
            budget -= len(data)
            self._process(conn)

    def _process(self, conn: _Conn) -> None:
        """Advance the connection state machine over whatever is buffered."""
        while not conn.closed:
            if conn.state == "ws":
                if not self._ws_frames(conn):
                    return
                continue
            if conn.http_busy:
                # responses are strictly ordered: buffer (bounded) until
                # the in-flight request finishes
                if len(conn.inbuf) > cnf.HTTP_MAX_BODY_SIZE + _MAX_HEADER:
                    self._close(conn, "pipeline_overflow")
                return
            if conn.state == "headers":
                end = conn.inbuf.find(b"\r\n\r\n")
                if end < 0:
                    if len(conn.inbuf) > _MAX_HEADER:
                        self._close(conn, "header_overflow")
                    return
                if not self._begin_request(conn, end + 4):
                    return
                continue
            if conn.state == "body":
                if len(conn.inbuf) < conn.body_total:
                    return
                self._dispatch_http(conn)
                continue
            return

    def _begin_request(self, conn: _Conn, header_end: int) -> bool:
        """Parse the buffered header block far enough to route: body
        length, tenant headers, websocket upgrade. Returns False when the
        connection changed state terminally (closed/ws)."""
        head = bytes(conn.inbuf[:header_end])
        lines = head.split(b"\r\n")
        headers: Dict[bytes, bytes] = {}
        for line in lines[1:]:
            k, _, v = line.partition(b":")
            if k:
                headers[k.strip().lower()] = v.strip()
        conn.header_deadline = 0.0  # full header block arrived: disarm
        if (headers.get(b"upgrade") or b"").lower() == b"websocket":
            del conn.inbuf[:header_end]
            self._ws_handshake(conn, lines[0], headers)
            return conn.state == "ws" and not conn.closed
        try:
            clen = int(headers.get(b"content-length") or 0)
        except ValueError:
            clen = 0
        if clen < 0 or clen > cnf.HTTP_MAX_BODY_SIZE:
            self._respond_simple(
                conn, 413, {"error": "request body too large"}, close=True
            )
            return False
        conn.body_total = header_end + clen
        conn.state = "body"
        return True

    def _dispatch_http(self, conn: _Conn) -> None:
        """A full request is buffered: admit through per-tenant QoS and
        hand the raw bytes to the executor pool."""
        raw = bytes(conn.inbuf[: conn.body_total])
        del conn.inbuf[: conn.body_total]
        conn.state = "headers"
        conn.http_busy = True
        head, _, body = raw.partition(b"\r\n\r\n")
        lines = head.split(b"\r\n")
        headers: Dict[bytes, bytes] = {}
        for line in lines[1:]:
            k, _, v = line.partition(b":")
            if k:
                headers[k.strip().lower()] = v.strip()
        try:
            path = lines[0].split(b" ")[1].split(b"?")[0].decode("latin-1")
        except (IndexError, UnicodeDecodeError):
            path = "/"
        ns = (headers.get(b"surreal-ns") or headers.get(b"ns") or b"").decode(
            "latin-1"
        ) or None
        db = (headers.get(b"surreal-db") or headers.get(b"db") or b"").decode(
            "latin-1"
        ) or None
        cls = qos.INTERNAL if path == "/cluster" else "tenant"
        fp = None
        if path == "/sql" and 0 < len(body) <= 4096:
            try:
                from surrealdb_tpu_torch import stats

                fp = stats.fingerprint(body.decode())[0]
            except Exception:  # noqa: BLE001 — an unfingerprintable body
                fp = None  # just loses its cost estimate, not its request

        server = self.server

        def run():
            try:
                server.run_http(conn, raw)
            finally:
                qos.release(ns, db, cls=cls)
                self._cmd(("http_done", conn, None))

        try:
            qos.submit(
                ns, db, lambda: server.pool.submit(run), fingerprint=fp, cls=cls
            )
        except qos.Shed:
            self._respond_simple(
                conn, 503,
                {"error": "server overloaded: admission control shed this request"},
            )
            conn.http_busy = False

    def _respond_simple(
        self, conn: _Conn, code: int, payload: dict, close: bool = False
    ) -> None:
        body = json.dumps(payload).encode()
        reason = {413: "Payload Too Large", 503: "Service Unavailable"}.get(code, "")
        head = (
            f"HTTP/1.1 {code} {reason}\r\n"
            f"Content-Type: application/json\r\nContent-Length: {len(body)}\r\n"
            + ("Connection: close\r\n" if close else "")
            + "\r\n"
        ).encode()
        if close:
            conn.close_after_flush = True
        self.enqueue_write(conn, head + body)

    # ------------------------------------------------------------ websocket
    def _ws_handshake(self, conn: _Conn, reqline: bytes, headers: Dict[bytes, bytes]) -> None:
        from surrealdb_tpu_torch import telemetry
        from surrealdb_tpu_torch.dbs.session import Session
        from surrealdb_tpu_torch.rpc.method import RpcContext

        server = self.server
        path = b"/"
        parts = reqline.split(b" ")
        if len(parts) > 1:
            path = parts[1].split(b"?")[0]
        if path != b"/rpc" or not server.ds.capabilities.allows_http_route("rpc"):
            self._respond_simple(conn, 403, {"error": "rpc route not allowed"}, close=True)
            return
        key = (headers.get(b"sec-websocket-key") or b"").decode("latin-1")
        if not key:
            self._respond_simple(conn, 400, {"error": "bad websocket request"}, close=True)
            return
        offered = [
            p.strip()
            for p in (headers.get(b"sec-websocket-protocol") or b"")
            .decode("latin-1").split(",")
            if p.strip()
        ]
        proto = next((p for p in offered if p in ("json", "cbor", "msgpack")), None)
        resp = (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {wsproto.accept_key(key)}\r\n"
            + (f"Sec-WebSocket-Protocol: {proto}\r\n" if proto else "")
            + "\r\n"
        ).encode()
        sess = Session.anonymous()
        sess.rt = True
        if not server.auth_enabled:
            sess = Session.owner(None, None)
            sess.ns = sess.db = None
        shim = server.handler_shim()
        shim._ws_proto = proto
        conn.ws = {
            "ctx": RpcContext(server.ds, sess),
            "shim": shim,
            "binary": False,
            "frag_op": None,
            "frag": bytearray(),
            "inflight": 0,
            "exclusive": False,  # a session-mutating method is running alone
            "pending": deque(),
        }
        conn.state = "ws"
        server.ds.enable_notifications()
        with self._lock:
            self.ws_conns.add(conn)
        telemetry.gauge_add("ws_connections", 1)
        self.enqueue_write(conn, resp)

    def _ws_frames(self, conn: _Conn) -> bool:
        """Assemble frames from inbuf; returns False when more bytes are
        needed (or the conn died)."""
        buf = conn.inbuf
        if len(buf) < 2:
            return False
        b1, b2 = buf[0], buf[1]
        fin, op = b1 & 0x80, b1 & 0x0F
        masked = b2 & 0x80
        n = b2 & 0x7F
        off = 2
        if n == 126:
            if len(buf) < off + 2:
                return False
            n = struct.unpack(">H", bytes(buf[off:off + 2]))[0]
            off += 2
        elif n == 127:
            if len(buf) < off + 8:
                return False
            n = struct.unpack(">Q", bytes(buf[off:off + 8]))[0]
            off += 8
        if n > cnf.HTTP_MAX_BODY_SIZE:
            self._close(conn, "frame_too_large")
            return False
        key = None
        if masked:
            if len(buf) < off + 4:
                return False
            key = bytes(buf[off:off + 4])
            off += 4
        if len(buf) < off + n:
            return False
        payload = bytes(buf[off:off + n])
        del buf[: off + n]
        if key:
            payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        ws = conn.ws
        if op == wsproto.OP_CLOSE:
            self.enqueue_write(conn, wsproto.encode_frame(wsproto.OP_CLOSE, b""))
            conn.close_after_flush = True
            self._flush_interest(conn)
            return False
        if op == wsproto.OP_PING:
            self.enqueue_write(conn, wsproto.encode_frame(wsproto.OP_PONG, payload))
            return True
        if op == wsproto.OP_PONG:
            return True
        # continuation assembly
        if op == wsproto.OP_CONT:
            ws["frag"] += payload
            if not fin:
                return True
            op = ws["frag_op"] or wsproto.OP_BINARY
            payload = bytes(ws["frag"])
            ws["frag"] = bytearray()
            ws["frag_op"] = None
        elif not fin:
            ws["frag_op"] = op
            ws["frag"] = bytearray(payload)
            return True
        if op not in (wsproto.OP_TEXT, wsproto.OP_BINARY):
            return True
        self._ws_message(conn, op == wsproto.OP_BINARY, payload)
        return True

    def _ws_message(self, conn: _Conn, binary: bool, payload: bytes) -> None:
        ws = conn.ws
        ws["binary"] = binary
        try:
            if not binary:
                req = json.loads(payload)
            elif getattr(ws["shim"], "_ws_proto", None) == "cbor":
                from surrealdb_tpu_torch.rpc import cbor as _cbor

                req = _cbor.decode(payload)
            else:
                from surrealdb_tpu_torch.utils.ser import wire_unpack

                req = wire_unpack(payload)
        except Exception:  # noqa: BLE001 — mirror the threaded ingress:
            return  # an undecodable frame is ignored, not fatal
        if not isinstance(req, dict):
            return
        sess = ws["ctx"].session
        fp = None
        method = str(req.get("method", "")).lower()
        if method == "query":
            params = req.get("params") or []
            if params and isinstance(params[0], str) and len(params[0]) <= 4096:
                try:
                    from surrealdb_tpu_torch import stats

                    fp = stats.fingerprint(params[0])[0]
                except Exception:  # noqa: BLE001 — cost estimate only
                    fp = None
        server = self.server

        is_session = method in _WS_SESSION_METHODS

        def on_admit():
            with self._lock:
                if conn.closed or conn.ws is None:
                    released = True
                else:
                    conn.ws["pending"].append(
                        (req, binary, sess.ns, sess.db, is_session)
                    )
                    released = False
            if released:
                qos.release(sess.ns, sess.db)
                return
            self._ws_start_ready(conn)

        try:
            qos.submit(sess.ns, sess.db, on_admit, fingerprint=fp)
        except qos.Shed as e:
            resp = {
                "id": req.get("id"),
                "error": {"code": -32000, "message": str(e)},
            }
            self._ws_send_obj(conn, resp, binary)

    def _ws_start_ready(self, conn: _Conn) -> None:
        """Mirror the threaded ingress's per-socket request window: up to
        WEBSOCKET_MAX_CONCURRENT_REQUESTS frames of one connection execute
        concurrently (so its queries can coalesce into shared kernel
        launches), while a session-mutating method (`use`/`signin`/...)
        drains the window first and runs alone — it can never race a
        concurrently-executing query."""
        limit = max(cnf.WEBSOCKET_MAX_CONCURRENT_REQUESTS, 1)
        starts: List[tuple] = []
        with self._lock:
            ws = conn.ws
            if ws is None or conn.closed:
                return
            while ws["pending"] and not ws["exclusive"]:
                if ws["pending"][0][4]:  # session-mutating head
                    if ws["inflight"] > 0:
                        break  # drain the window first
                    ws["exclusive"] = True
                    ws["inflight"] += 1
                    starts.append(ws["pending"].popleft())
                    break
                if ws["inflight"] >= limit:
                    break
                ws["inflight"] += 1
                starts.append(ws["pending"].popleft())
        for item in starts:
            self.server.pool.submit(lambda it=item: self._ws_run_one(conn, it))

    def _ws_run_one(self, conn: _Conn, item: tuple) -> None:
        req, binary, ns, db, is_session = item
        try:
            if conn.ws is not None and not conn.closed:
                self.server.run_ws_frame(conn, req, binary)
        finally:
            qos.release(ns, db)
            with self._lock:
                ws = conn.ws
                if ws is not None:
                    ws["inflight"] -= 1
                    if is_session:
                        ws["exclusive"] = False
            self._cmd(("ws_done", conn, None))

    def _ws_next(self, conn: _Conn) -> None:
        self._ws_start_ready(conn)

    def _ws_send_obj(self, conn: _Conn, obj: Any, binary: bool) -> None:
        from surrealdb_tpu_torch.sql.value import to_json_value

        if binary:
            frame = wsproto.encode_frame(
                wsproto.OP_BINARY, conn.ws["shim"]._ws_encode(obj)
            )
        else:
            frame = wsproto.encode_frame(
                wsproto.OP_TEXT, json.dumps(to_json_value(obj)).encode()
            )
        self.enqueue_write(conn, frame)

    # ------------------------------------------------------------ writing
    def _flush_interest(self, conn: _Conn) -> None:
        if conn.virtual:
            self._dirty_virtual.add(conn)
        else:
            self._write_ready(conn)

    def _note_first_byte(self, conn: _Conn) -> None:
        if conn.first_byte_t is None:
            from surrealdb_tpu_torch import telemetry

            conn.first_byte_t = time.monotonic()
            dt = conn.first_byte_t - conn.accepted_t
            telemetry.observe("net_accept_to_first_byte", dt)
            self.server.note_ttfb(dt)

    def _write_ready(self, conn: _Conn) -> None:
        """Drain as much of the write queue as the socket accepts; manage
        EVENT_WRITE interest."""
        while conn.outq:
            view = conn.outq[0]
            n = _nb_send_some(conn.sock, view)
            if n < 0:
                self._close(conn, "eof")
                return
            if n == 0:
                break
            self._note_first_byte(conn)
            with self._lock:
                conn.out_bytes -= n
            if n == len(view):
                conn.outq.popleft()
            else:
                conn.outq[0] = view[n:]
        want = bool(conn.outq)
        if want != conn.want_write:
            conn.want_write = want
            mask = selectors.EVENT_READ | (selectors.EVENT_WRITE if want else 0)
            try:
                self.sel.modify(conn.sock, mask, conn)
            except (KeyError, ValueError, OSError):
                pass
        if not conn.outq and conn.close_after_flush:
            self._close(conn, "server")

    def _drain_virtual(self) -> None:
        while self._dirty_virtual:
            conn = self._dirty_virtual.pop()
            if conn.closed:
                continue
            if conn.sink is not None and conn.outq:
                self._note_first_byte(conn)
                with self._lock:
                    chunks = list(conn.outq)
                    conn.outq.clear()
                    conn.out_bytes = 0
                for view in chunks:
                    conn.sink(bytes(view))
            if not conn.outq and conn.close_after_flush:
                self._close(conn, "server")

    # ------------------------------------------------------------ closing
    def _expire_deadlines(self) -> None:
        from surrealdb_tpu_torch import events, telemetry

        now = time.monotonic()
        expired = 0
        while self._deadlines and self._deadlines[0][0] <= now:
            _, _, conn = heapq.heappop(self._deadlines)
            if (
                not conn.closed
                and conn.state == "headers"
                and conn.header_deadline
                and conn.header_deadline <= now
                and not conn.http_busy
                and conn.inbuf  # an idle keep-alive socket is fine;
                # a PARTIAL header block past deadline is a slowloris
            ):
                self._close(conn, "header_timeout", quiet=True)
                expired += 1
        if expired:
            telemetry.inc(
                "net_overload_close", reason="header_timeout", by=float(expired)
            )
            events.emit("net.overload_close", reason="header_timeout", count=expired)

    def _close(self, conn: _Conn, reason: str, quiet: bool = False) -> None:
        from surrealdb_tpu_torch import events, telemetry

        with self._lock:
            if conn.closed:
                return
            conn.closed = True
            self.conns.discard(conn)
            was_ws = conn in self.ws_conns
            self.ws_conns.discard(conn)
            conn.outq.clear()
            conn.out_bytes = 0
        self._dirty_virtual.discard(conn)
        if conn.sock is not None:
            try:
                self.sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            try:
                conn.sock.close()
            except OSError:
                pass
        telemetry.gauge_add("net_connections", -1)
        if reason == "backpressure":
            telemetry.inc("net_backpressure_close")
            ws = conn.ws
            sess = ws["ctx"].session if ws else None
            events.emit(
                "net.backpressure_close",
                ns=(sess.ns if sess else None) or "",
                db=(sess.db if sess else None) or "",
                queued_bytes=cnf.NET_WRITE_BUF_MAX,
            )
        if was_ws and conn.ws is not None:
            telemetry.gauge_add("ws_connections", -1)
            ctx = conn.ws["ctx"]
            conn.ws = None
            # disconnect sweep (the live-query leak fix): KILL every live
            # query this connection still owns, off the loop thread
            self.server.pool.submit(ctx.close)

    def _close_all(self) -> None:
        for conn in list(self.conns):
            self._close(conn, "shutdown", quiet=True)
        try:
            self.sel.unregister(self._wake_r)
        except (KeyError, ValueError):
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        if self.listener is not None:
            try:
                self.sel.unregister(self.listener)
            except (KeyError, ValueError):
                pass
        self.sel.close()


# ------------------------------------------------------------------ the server
_SERVERS: "weakref.WeakSet[EventLoopServer]" = weakref.WeakSet()


class EventLoopServer:
    """The event-loop ingress: a listener + NET_LOOPS selector loops + one
    bounded executor pool, serving the SAME SurrealHandler routes as the
    threaded ingress through an in-memory adapter."""

    def __init__(
        self,
        handler_cls,
        host: str = "127.0.0.1",
        port: int = 8000,
    ):
        self.handler_cls = handler_cls
        self.ds = handler_cls.ds
        self.auth_enabled = handler_cls.auth_enabled
        self.listener = socket.create_server(
            (host, port), backlog=1024, reuse_port=False
        )
        self.listener.setblocking(False)
        self.host, self.port = self.listener.getsockname()[:2]
        self.loops = [_Loop(self, i) for i in range(max(cnf.NET_LOOPS, 1))]
        self.loops[0].listener = self.listener
        self.loops[0].sel.register(self.listener, selectors.EVENT_READ, "listener")
        self.pool = _ExecPool(cnf.NET_EXECUTORS, owner=id(self.ds))
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._adapter_cls = _make_adapter(handler_cls)
        self._ttfb_lock = _locks.Lock("net.loop")  # same family: leaf usage
        self._ttfb: Deque[float] = deque(maxlen=16384)
        self._started = False
        _SERVERS.add(self)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "EventLoopServer":
        from surrealdb_tpu_torch import bg

        if self._started:
            return self
        self._started = True
        self._threads = [
            # detached selector loops own every connection's tracing scope
            # per-request; there is no single arming trace to propagate
            # graftflow: disable=GF002
            bg.spawn_service(
                "net_loop", str(i), lp.run, owner=id(self.ds), restart=True
            )
            for i, lp in enumerate(self.loops)
        ]
        self._threads.append(
            bg.spawn_service(
                "net_notify", "all", self._notify_pump, owner=id(self.ds), restart=True
            )
        )
        return self

    def serve_forever(self) -> None:
        self.start()
        self._stop.wait()

    def shutdown(self) -> None:
        self._stop.set()
        for lp in self.loops:
            lp._stop.set()
            lp._wake()
        self.pool.shutdown()
        for t in self._threads:
            t.join(timeout=5)
        try:
            self.listener.close()
        except OSError:
            pass

    def server_close(self) -> None:
        self.shutdown()

    def total_conns(self) -> int:
        return sum(len(lp.conns) for lp in self.loops)

    def note_ttfb(self, dt: float) -> None:
        with self._ttfb_lock:
            self._ttfb.append(dt)

    def handler_shim(self):
        """A routeless SurrealHandler instance: _rpc_denied/_ws_encode
        without a socket behind it."""
        return self.handler_cls.__new__(self.handler_cls)

    # ------------------------------------------------------------ execution
    def run_http(self, conn: _Conn, raw: bytes) -> None:
        """Executor side: replay the decoded request through the real
        SurrealHandler routes against in-memory files."""
        self._adapter_cls(conn, raw)

    def run_ws_frame(self, conn: _Conn, req: dict, binary: bool) -> None:
        """Executor side: one WS RPC frame — the same trace/deny/execute/
        encode contract as the threaded ingress's per-frame handler."""
        from surrealdb_tpu_torch import tracing
        from surrealdb_tpu_torch.err import InvalidAuthError, SurrealError
        from surrealdb_tpu_torch.sql.value import to_json_value

        ws = conn.ws
        if ws is None:
            return
        ctx, shim = ws["ctx"], ws["shim"]
        rid = req.get("id")
        method = req.get("method", "")
        t_field = req.get("trace")
        tid, t_parent = None, None
        if isinstance(t_field, str) and t_field:
            parsed = tracing.parse_traceparent(t_field)
            if parsed is not None:
                tid, t_parent = parsed
            else:
                tid = t_field
        tr = None
        try:
            with tracing.request(
                "ws_rpc", trace_id=tid, parent_id=t_parent, method=str(method)
            ) as tr:
                denied = shim._rpc_denied(method, ctx.session)
                if denied is not None:
                    raise InvalidAuthError(denied)
                result = ctx.execute(method, req.get("params") or [])
            resp: Dict[str, Any] = {"id": rid, "result": result}
            if tr is not None and tid is not None:
                resp["trace"] = tr.trace_id
        except Exception as e:  # noqa: BLE001 — a worker must not die silently
            msg = str(e) if isinstance(e, SurrealError) else f"Internal error: {e}"
            resp = {"id": rid, "error": {"code": -32000, "message": msg}}
            if tid is not None and tr is not None:
                resp["trace"] = tr.trace_id
        if binary:
            frame = wsproto.encode_frame(wsproto.OP_BINARY, shim._ws_encode(resp))
        else:
            frame = wsproto.encode_frame(
                wsproto.OP_TEXT, json.dumps(to_json_value(resp)).encode()
            )
        conn.loop.enqueue_write(conn, frame)

    # ------------------------------------------------------------ notifications
    def _notify_pump(self) -> None:
        """ONE shared live-query pump for every WS connection on this
        server (the threaded ingress burns a thread per socket on this).
        Event.wait paces it — never time.sleep on a loop-plane thread."""
        from surrealdb_tpu_torch import telemetry  # noqa: F401
        from surrealdb_tpu_torch.sql.value import to_json_value

        while not self._stop.wait(0.02):
            hub = self.ds.notifications
            if hub is None:
                continue
            for lp in self.loops:
                for conn in list(lp.ws_conns):
                    ws = conn.ws
                    if ws is None or conn.closed:
                        continue
                    ctx = ws["ctx"]
                    for live_id in list(ctx.live_ids):
                        try:
                            n = hub.subscribe(live_id).get_nowait()
                        except (_queue.Empty, KeyError):
                            continue
                        note = {"result": n.to_value()}
                        if ws["binary"]:
                            frame = wsproto.encode_frame(
                                wsproto.OP_BINARY, ws["shim"]._ws_encode(note)
                            )
                        else:
                            frame = wsproto.encode_frame(
                                wsproto.OP_TEXT,
                                json.dumps(to_json_value(note)).encode(),
                            )
                        lp.enqueue_write(conn, frame)

    # ------------------------------------------------------------ views
    def ttfb_quantiles(self) -> Dict[str, Optional[float]]:
        with self._ttfb_lock:
            xs = sorted(self._ttfb)
        if not xs:
            return {"p50_ms": None, "p99_ms": None, "samples": 0}
        def q(p: float) -> float:
            return xs[min(int(p * len(xs)), len(xs) - 1)] * 1e3
        return {
            "p50_ms": round(q(0.50), 3),
            "p99_ms": round(q(0.99), 3),
            "samples": len(xs),
        }

    def stats(self) -> dict:
        return {
            "host": self.host,
            "port": self.port,
            "loops": len(self.loops),
            "conns": self.total_conns(),
            "ws_conns": sum(len(lp.ws_conns) for lp in self.loops),
            "virtual_conns": sum(
                1 for lp in self.loops for c in lp.conns if c.virtual
            ),
            "accept_to_first_byte": self.ttfb_quantiles(),
        }


# ------------------------------------------------------------------ adapter
def _make_adapter(handler_cls):
    """Subclass the bound SurrealHandler so a loop-decoded request replays
    through the REAL route logic against in-memory rfile/wfile."""

    class _ConnWriter:
        """wfile shim: buffer the whole response, enqueue ONE atomic chunk
        on flush (so loop-interleaved writers can never shear a response)."""

        def __init__(self, conn: _Conn):
            self._conn = conn
            self._buf = bytearray()

        def write(self, data: bytes) -> int:
            self._buf += data
            return len(data)

        def flush(self) -> None:
            if self._buf:
                self._conn.loop.enqueue_write(self._conn, bytes(self._buf))
                self._buf = bytearray()

    class _LoopAdapter(handler_cls):
        def __init__(self, conn: _Conn, raw: bytes):  # noqa: D401
            # deliberately NOT calling BaseHTTPRequestHandler.__init__:
            # there is no socket to set up — the loop already framed the
            # request; this object only replays routes
            self.rfile = io.BufferedReader(io.BytesIO(raw))
            self.wfile = _ConnWriter(conn)
            self.client_address = conn.peer
            self.connection = None
            self.close_connection = True
            try:
                self.handle_one_request()
            except Exception:  # noqa: BLE001 — a route crash must close
                # the connection, never kill the executor worker
                from surrealdb_tpu_torch import telemetry

                telemetry.inc("net_adapter_errors")
            try:
                self.wfile.flush()
            except Exception:  # noqa: BLE001 — conn raced closed
                from surrealdb_tpu_torch import telemetry

                telemetry.inc("net_adapter_errors")
            if self.close_connection:
                conn.close_after_flush = True
                conn.loop._cmd(("drain", conn, None))

    return _LoopAdapter


# ------------------------------------------------------------------ plane views
def snapshot() -> dict:
    """The bundle `net` section: every live event-loop server + the QoS
    plane's admission state."""
    servers = [s.stats() for s in list(_SERVERS) if s._started and not s._stop.is_set()]
    return {
        "enabled": bool(cnf.NET_LOOP),
        "servers": servers,
        "qos": qos.snapshot(),
    }


def queue_depths() -> Dict[str, float]:
    """Scrape-time gauges: summed write-queue bytes + open conns across
    live servers (telemetry.collect_node_metrics calls this)."""
    conns = 0
    queued = 0
    for s in list(_SERVERS):
        if not s._started or s._stop.is_set():
            continue
        for lp in s.loops:
            for c in list(lp.conns):
                conns += 1
                queued += c.out_bytes
    return {"conns": float(conns), "write_queued_bytes": float(queued)}
