"""The server surface of the port (rpc/, net/, gql/, sdk/, the CLI) held to
the reference's on the same inputs, on the CPU.

- CBOR: seeded value trees (Thing, Datetime, Duration, Uuid, Decimal, NONE,
  nested arrays and objects) encode to the same bytes in both packages and
  decode back to the same trees.
- RpcContext: one reference store and one port store (device "cpu") answer
  the same calls (query with vars, select, create, merge, patch, relate,
  run of an ml:: model, signin / authenticate, graphql) with the same
  values, compared as CBOR bytes.
- One Server of each package on port 0 over 8,192 x 64 MTREE rows: the same
  k = 10 queries over /rpc by HTTP and by WebSocket (each package's SDK,
  CBOR) and over /sql as text give the same ids in the same order, and the
  port's equal numpy's exact top-10 up to ties.
- Every entry point that opens a store defaults to "cuda" and raises
  without a card, cluster mode (`serve(cluster_config=...)`, `start
  --cluster`) included; both cluster entry points attach a node that
  answers a scatter on the CPU; the CLI serves on the CPU when asked and
  exits 0 on SIGINT.
"""

import base64
import decimal
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

K, ROWS, DIM = 10, 8192, 64


def _value_tree(V, rng, depth=0):
    """A seeded tree of the package's value types (V = its sql.value)."""
    kinds = ["int", "float", "str", "thing", "datetime", "duration", "uuid", "decimal", "none",
             "null", "bool"]
    if depth < 3:
        kinds += ["list", "dict"] * 3
    kind = kinds[int(rng.integers(len(kinds)))]
    if kind == "int":
        return int(rng.integers(-2 ** 40, 2 ** 40))
    if kind == "float":
        return float(rng.standard_normal())
    if kind == "str":
        return "s" + "".join(chr(97 + int(c)) for c in rng.integers(0, 26, int(rng.integers(0, 9))))
    if kind == "thing":
        idv = int(rng.integers(0, 10 ** 6)) if rng.random() < 0.5 else f"k{int(rng.integers(99))}"
        return V.Thing("tb" + str(int(rng.integers(5))), idv)
    if kind == "datetime":
        return V.Datetime(int(rng.integers(0, 2 ** 62)))
    if kind == "duration":
        return V.Duration(int(rng.integers(0, 2 ** 50)))
    if kind == "uuid":
        return V.Uuid(uuid.UUID(bytes=rng.bytes(16)))
    if kind == "decimal":
        return decimal.Decimal(f"{int(rng.integers(-10 ** 9, 10 ** 9))}.{int(rng.integers(10 ** 6))}")
    if kind == "none":
        return V.NONE
    if kind == "null":
        return None
    if kind == "bool":
        return bool(rng.random() < 0.5)
    n = int(rng.integers(0, 5))
    if kind == "list":
        return [_value_tree(V, rng, depth + 1) for _ in range(n)]
    return {f"f{i}": _value_tree(V, rng, depth + 1) for i in range(n)}


@pytest.mark.parametrize("seed", range(8))
def test_cbor_bytes_equal_the_reference(seed):
    from surrealdb_tpu.rpc import cbor as RC
    from surrealdb_tpu.sql import value as RV
    from surrealdb_tpu_torch.rpc import cbor as PC
    from surrealdb_tpu_torch.sql import value as PV

    ref = _value_tree(RV, np.random.default_rng(seed))
    port = _value_tree(PV, np.random.default_rng(seed))
    raw = RC.encode(ref)
    assert PC.encode(port) == raw
    # each package decodes the other's bytes to a tree that encodes the same
    assert PC.encode(PC.decode(raw)) == raw
    assert RC.encode(RC.decode(PC.encode(port))) == raw


# ------------------------------------------------------------------ RpcContext
_LINEAR = {"format": "linear", "name": "house", "version": "1.0.0",
           "layers": [{"w": [[2.0], [3.0]], "b": [10.0], "activation": None}]}


def _stores():
    from surrealdb_tpu.kvs.ds import Datastore as RefDs
    from surrealdb_tpu_torch.kvs.ds import Datastore as PortDs

    return RefDs("memory"), PortDs("memory", device="cpu")


def _strip_times(v):
    if isinstance(v, list):
        return [_strip_times(x) for x in v]
    if isinstance(v, dict):
        return {k: _strip_times(x) for k, x in v.items() if k != "time"}
    return v


def _jwt_claims(token):
    payload = token.split(".")[1]
    claims = json.loads(base64.urlsafe_b64decode(payload + "=" * (-len(payload) % 4)))
    return {k: v for k, v in claims.items() if k not in ("iat", "nbf", "exp", "jti")}


def test_rpc_methods_answer_as_the_reference(monkeypatch):
    """The same RpcContext calls on a reference store and a port store give
    the same values (CBOR bytes, statement times left out)."""
    from surrealdb_tpu.dbs.session import Session as RefSession
    from surrealdb_tpu.ml.exec import import_model as ref_import
    from surrealdb_tpu.rpc import cbor as RC
    from surrealdb_tpu.rpc.method import RpcContext as RefRpc
    from surrealdb_tpu_torch.dbs.session import Session as PortSession
    from surrealdb_tpu_torch.ml.exec import import_model as port_import
    from surrealdb_tpu_torch.rpc import cbor as PC
    from surrealdb_tpu_torch.rpc.method import RpcContext as PortRpc

    monkeypatch.setenv("SURREAL_EXPERIMENTAL_GRAPHQL", "true")
    ref_ds, port_ds = _stores()
    try:
        sides = []
        for ds, Rpc, Session, imp, C in ((ref_ds, RefRpc, RefSession, ref_import, RC),
                                          (port_ds, PortRpc, PortSession, port_import, PC)):
            ds.execute("DEFINE MODEL ml::house<1.0.0>;", Session.owner("test", "test"))
            imp(ds, Session.owner("test", "test"), "house", "1.0.0", _LINEAR)
            ds.execute("DEFINE USER dbu ON DATABASE PASSWORD 'pw' ROLES EDITOR;",
                       Session.owner("test", "test"))
            ctx = Rpc(ds, Session.owner(None, None))
            calls = [
                ("use", ["test", "test"]),
                ("query", ["CREATE person:1 SET name = $n, age = $a; "
                           "CREATE person:2 SET name = 'b', age = 40; "
                           "SELECT * FROM person WHERE age > $min ORDER BY id",
                           {"n": "a", "a": 30, "min": 20}]),
                ("create", ["person:3", {"name": "c", "age": 50, "tags": ["x", "y"]}]),
                ("select", ["person"]),
                ("merge", ["person:3", {"age": 51, "extra": {"k": 1}}]),
                ("patch", ["person:3", [{"op": "replace", "path": "/name", "value": "cc"},
                                        {"op": "add", "path": "/tags/-", "value": "z"}]]),
                ("relate", ["person:1", "knows", "person:2", {"since": 2020}]),
                ("query", ["SELECT ->knows->person.name AS n FROM person:1"]),
                ("run", ["ml::house<1.0.0>", None, [[1.0, 2.0]]]),
                ("graphql", [{"query": "{ person(order: {age: DESC}) { name age } }"}]),
                ("set", ["v", 7]),
                ("query", ["RETURN $v * 6"]),
            ]
            out = []
            for method, params in calls:
                res = ctx.execute(method, params)
                if method == "relate":  # the edge's generated id differs
                    res = [{k: v for k, v in r.items() if k != "id"} for r in res]
                out.append(C.encode(_strip_times(res)))
            user = Rpc(ds, Session.owner(None, None))
            token = user.execute("signin", [{"ns": "test", "db": "test", "user": "dbu",
                                             "pass": "pw"}])
            fresh = Rpc(ds, Session())
            fresh.execute("authenticate", [token])
            fresh.execute("use", ["test", "test"])
            out.append(C.encode(_strip_times(fresh.execute("query", ["SELECT name FROM person:2"]))))
            sides.append((out, _jwt_claims(token)))
        (ref_out, ref_claims), (port_out, port_claims) = sides
        assert len(ref_out) == len(port_out)
        for i, (a, b) in enumerate(zip(ref_out, port_out)):
            assert a == b, f"call {i}: {RC.decode(a)!r} != {PC.decode(b)!r}"
        assert ref_claims == port_claims
    finally:
        ref_ds.close()
        port_ds.close()


# ------------------------------------------------------------------ the servers
@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((16, DIM)).astype(np.float32) * 3
    rows = centers[rng.integers(0, 16, ROWS)] + rng.standard_normal((ROWS, DIM)).astype(np.float32)
    queries = rows[rng.integers(0, ROWS, 6)] + 0.05 * rng.standard_normal((6, DIM)).astype(np.float32)
    return rows, queries


def _serve_corpus(Server, ds, rows):
    ds.execute(f"DEFINE TABLE item SCHEMALESS; DEFINE INDEX im ON item FIELDS emb MTREE "
               f"DIMENSION {DIM} DIST EUCLIDEAN")
    for i in range(0, ROWS, 4096):
        out = ds.execute("INSERT INTO item $rows RETURN NONE", vars={"rows": [
            {"id": j, "emb": rows[j].tolist()} for j in range(i, min(i + 4096, ROWS))]})
        assert out[-1]["status"] == "OK", out
    return Server(ds, port=0, auth_enabled=False).start_background()


def _ask_all(Surreal, srv, queries):
    """The queries' ids over HTTP /rpc and WS (CBOR, through the SDK) and
    /sql (text, the vector as a literal)."""
    sql = f"SELECT id FROM item WHERE emb <|{K}|> $q"
    out = {}
    for name, url in (("http", srv.url), ("ws", srv.url.replace("http://", "ws://") + "/rpc")):
        with Surreal(url, format="cbor") as db:
            db.use("test", "test")
            got = []
            for q in queries:
                res = db.query(sql, {"q": q.tolist()})
                assert res[-1]["status"] == "OK", res
                got.append([r["id"].id for r in res[-1]["result"]])
            out[name] = got
    got = []
    for q in queries:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        text = f"SELECT id FROM item WHERE emb <|{K}|> [{', '.join(repr(float(x)) for x in q)}]"
        conn.request("POST", "/sql", text, {"surreal-ns": "test", "surreal-db": "test",
                                             "Accept": "application/json"})
        r = conn.getresponse()
        body = json.loads(r.read())
        conn.close()
        assert r.status == 200 and body[-1]["status"] == "OK", body
        got.append([int(str(row["id"]).split(":")[1]) for row in body[-1]["result"]])
    out["sql"] = got
    return out


def test_servers_answer_knn_as_the_reference(corpus):
    from surrealdb_tpu import telemetry as RT
    from surrealdb_tpu.kvs.ds import Datastore as RefDs
    from surrealdb_tpu.net.server import Server as RefServer
    from surrealdb_tpu.sdk import Surreal as RefSurreal
    from surrealdb_tpu_torch import telemetry as PT
    from surrealdb_tpu_torch.kvs.ds import Datastore as PortDs
    from surrealdb_tpu_torch.net.server import Server as PortServer
    from surrealdb_tpu_torch.sdk import Surreal as PortSurreal

    rows, queries = corpus
    answers = {}
    for label, Ds, Server, Surreal, T in (
            ("ref", lambda: RefDs("memory"), RefServer, RefSurreal, RT),
            ("port", lambda: PortDs("memory", device="cpu"), PortServer, PortSurreal, PT)):
        ds = Ds()
        srv = _serve_corpus(Server, ds, rows)
        try:
            before = T.snapshot()["counters"]
            answers[label] = _ask_all(Surreal, srv, queries)
            after = T.snapshot()["counters"]
            served = {c: after[c] - before.get(c, 0) for c in after
                      if c.startswith("knn_strategy") and after[c] != before.get(c, 0)}
            # the reference serves on its test mesh of 8 CPU devices, the
            # port on the store's one device
            if label == "port":
                assert served == {'knn_strategy{strategy="exact-device"}': 3 * len(queries)}
            else:
                assert sum(served.values()) == 3 * len(queries), served
        finally:
            srv.shutdown()
            ds.close()
    assert answers["port"] == answers["ref"]
    # the port's answers are numpy's exact top-10 up to ties at the k-th distance
    d = ((rows[None, :, :].astype(np.float64) - queries[:, None, :]) ** 2).sum(-1)
    for transport, got in answers["port"].items():
        for qi, ids in enumerate(got):
            kth = np.sort(d[qi])[K - 1]
            exact = set(np.argsort(d[qi], kind="stable")[:K].tolist())
            assert len(ids) == K
            assert all(i in exact or abs(d[qi, i] - kth) <= 1e-4 * kth for i in ids), transport


# ------------------------------------------------------------------ devices
def test_entry_points_default_to_cuda_and_raise_without_a_card():
    from surrealdb_tpu_torch import cli
    from surrealdb_tpu_torch.net.server import serve
    from surrealdb_tpu_torch.sdk import Surreal

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults succeed")

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve("memory", port=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Surreal("mem://")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["start", "--bind", "127.0.0.1:0", "memory"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["export", "--ns", "t", "--db", "t"])


def _topology(path, ports, secret="cluster-test-secret"):
    nodes = [{"id": f"n{i + 1}", "url": f"http://127.0.0.1:{p}"} for i, p in enumerate(ports)]
    path.write_text(json.dumps({"nodes": nodes, "self": "n1", "vnodes": 64, "secret": secret}))
    return str(path)


def _wait_peers_up(stores, timeout=30.0):
    """A node that probed a peer before it listened holds it down until the
    next probe; wait until every node sees every peer up."""
    deadline = time.monotonic() + timeout
    while any(ds.cluster.client.down_nodes() or not all(
            h["up"] for nid, h in ds.cluster.client.health().items()
            if nid != ds.cluster.node_id) for ds in stores):
        assert time.monotonic() < deadline, [ds.cluster.client.health() for ds in stores]
        time.sleep(0.1)


def test_serve_with_cluster_config_attaches_and_answers_a_scatter(tmp_path):
    """Two `serve(..., cluster_config=...)` nodes on the CPU: each is
    attached (its `execute` routes through the executor), a write through
    n1 lands on both (RF 2 of 2), and a scan through either node is
    answered by a scatter over both."""
    from surrealdb_tpu_torch import cluster
    from surrealdb_tpu_torch.dbs.session import Session
    from surrealdb_tpu_torch.net.server import serve

    ports = [_free_port(), _free_port()]
    topo = _topology(tmp_path / "topo.json", ports)
    srvs = [serve("memory", port=p, auth_enabled=False, device="cpu",
                  cluster_config=cluster.load_config(topo, f"n{i + 1}")).start_background()
            for i, p in enumerate(ports)]
    stores = [srv.httpd.RequestHandlerClass.ds for srv in srvs]
    s = Session.owner("t", "t")
    try:
        _wait_peers_up(stores)
        assert [ds.cluster.node_id for ds in stores] == ["n1", "n2"]
        assert all(ds.device == torch.device("cpu") for ds in stores)
        out = stores[0].execute("DEFINE TABLE a SCHEMALESS; "
                                + "; ".join(f"CREATE a:{i} SET v = {i}" for i in range(12)), s)
        assert all(r["status"] == "OK" for r in out), out
        for ds in stores:
            local = ds.execute_local("SELECT VALUE v FROM a", s)[0]["result"]
            assert sorted(local) == list(range(12)), local
        for ds in stores:
            out = ds.execute("SELECT VALUE v FROM a WHERE v >= 3 ORDER BY v DESC LIMIT 4", s)
            assert out[-1]["status"] == "OK" and out[-1]["result"] == [11, 10, 9, 8], out
            plan = ds.execute("SELECT VALUE v FROM a WHERE v >= 3 EXPLAIN ANALYZE", s)[-1]["result"]
            assert sorted(op["detail"]["node"] for op in plan if op["operation"] == "Shard") == [
                "n1", "n2"], plan
    finally:
        for srv, ds in zip(srvs, stores):
            cluster.detach(ds)
            srv.shutdown()
            ds.close()


def test_cli_start_cluster_serves_as_a_node(tmp_path):
    """`start --cluster topo.json --cluster-node n2 --device cpu` serves as
    n2 of a two-node topology whose n1 is served in this process: a write
    through n1 reaches the child's shard, a read through the child sees
    every row, and the child exits 0 on SIGINT."""
    from surrealdb_tpu_torch import cluster
    from surrealdb_tpu_torch.dbs.session import Session
    from surrealdb_tpu_torch.net.server import serve
    from surrealdb_tpu_torch.sdk import Surreal

    ports = [_free_port(), _free_port()]
    topo = _topology(tmp_path / "topo.json", ports)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "surrealdb_tpu_torch", "start", "--device", "cpu",
         "--bind", f"127.0.0.1:{ports[1]}", "--unauthenticated", "--cluster", topo,
         "--cluster-node", "n2", "memory"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    srv = serve("memory", port=ports[0], auth_enabled=False, device="cpu",
                cluster_config=cluster.load_config(topo)).start_background()
    ds = srv.httpd.RequestHandlerClass.ds
    s = Session.owner("t", "t")
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", ports[1], timeout=2)
                conn.request("GET", "/health")
                if conn.getresponse().status == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            assert time.monotonic() < deadline, "the CLI node did not come up"
            time.sleep(0.2)
        _wait_peers_up([ds])
        out = ds.execute("DEFINE TABLE a SCHEMALESS; "
                         + "; ".join(f"CREATE a:{i} SET v = {i}" for i in range(10)), s)
        assert all(r["status"] == "OK" for r in out), out
        with Surreal(f"http://127.0.0.1:{ports[1]}") as db:
            db.use("t", "t")
            out = db.query("SELECT VALUE v FROM a ORDER BY v")
            assert out[-1]["status"] == "OK" and out[-1]["result"] == list(range(10)), out
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0, proc.communicate()[1][-2000:]
        assert "cluster node 'n2': 2 member(s), 64 vnodes" in proc.communicate()[1]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        cluster.detach(ds)
        srv.shutdown()
        ds.close()


def test_cluster_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path, monkeypatch):
    """`serve(cluster_config=...)` and `start --cluster` open the store on
    "cuda" unless told otherwise, and raise without a card before any
    probe or repair service is started (`attach` is never reached)."""
    from surrealdb_tpu_torch import cli, cluster
    from surrealdb_tpu_torch.net.server import serve

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults succeed")
    attached = []
    monkeypatch.setattr(cluster, "attach", lambda *a: attached.append(a))
    topo = _topology(tmp_path / "topo.json", [_free_port(), _free_port()])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve("memory", port=0, cluster_config=cluster.load_config(topo))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["start", "--bind", "127.0.0.1:0", "--cluster", topo, "memory"])
    assert attached == []


def test_cpu_entry_points_keep_their_device():
    from surrealdb_tpu_torch.net.server import serve
    from surrealdb_tpu_torch.sdk import Surreal

    srv = serve("memory", port=0, auth_enabled=False, device="cpu")
    try:
        assert srv.httpd.RequestHandlerClass.ds.device == torch.device("cpu")
    finally:
        srv.httpd.RequestHandlerClass.ds.close()
    with Surreal("mem://", device="cpu") as db:
        assert db._engine.ds.device == torch.device("cpu")
        db.use("t", "t")
        assert db.query("RETURN 1 + 1")[0]["result"] == 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_start_serves_on_the_cpu_and_exits_on_sigint():
    from surrealdb_tpu_torch.sdk import Surreal

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "surrealdb_tpu_torch", "start", "--device", "cpu",
         "--bind", f"127.0.0.1:{port}", "--user", "root", "--pass", "root", "memory"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
                conn.request("GET", "/health")
                if conn.getresponse().status == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            assert time.monotonic() < deadline, "the CLI server did not come up"
            time.sleep(0.2)
        with Surreal(f"http://127.0.0.1:{port}") as db:
            db.signin(user="root", password="root")
            db.use("t", "t")
            out = db.query("CREATE a:1 SET v = 3; SELECT VALUE v FROM a")
            assert out[-1]["result"] == [3], out
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0, proc.communicate()[1][-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
