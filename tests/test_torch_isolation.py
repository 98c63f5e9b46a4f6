"""The PyTorch port stands alone: no JAX, nothing of surrealdb_tpu, CUDA
unless told otherwise, and no silent stand-in for a failed strategy.
The subprocess drives every ported path (MTREE, HNSW through IVF, the
graph path's count and expand branches, the full-text path, the ML
path: a columnar scan, a batch above the device threshold and an ONNX
import from a .surml file, the mesh path: MTREE and HNSW on an
8-shard CPU mesh and the mesh dry run, the server surface: a query over
HTTP and one over WebSocket through the SDK, the embedded engine on a
file store: FETCH, INFO FOR, SHOW CHANGES, an embedded script, tick(),
export and a reopen, and cluster mode: three RF-2 nodes answering a kNN
and a scan through the coordinator) before it looks for a leak. Each
module of `cluster/` is also imported alone in a fresh interpreter."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "surrealdb_tpu_torch")

_SLICE = r"""
import sys
import numpy as np
sys.path.insert(0, {repo!r})
from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.kvs.ds import Datastore
cnf.TPU_KNN_ONDEVICE_THRESHOLD = 16
ds = Datastore("memory", device="cpu")
rng = np.random.default_rng(0)
rows = [{{"id": i, "emb": rng.standard_normal(8).astype(np.float32).tolist()}} for i in range(64)]
ds.execute("DEFINE TABLE item; DEFINE INDEX im ON item FIELDS emb MTREE DIMENSION 8 DIST EUCLIDEAN")
ds.execute("INSERT INTO item $rows RETURN NONE", vars={{"rows": rows}})
out = ds.execute("SELECT id FROM item WHERE emb <|3|> $q", vars={{"q": rows[1]["emb"]}})
assert out[-1]["status"] == "OK" and len(out[-1]["result"]) == 3, out
# the HNSW strategy: train the quantizer, then serve through IVF
cnf.TPU_ANN_MIN_ROWS = 32
ds.execute("DEFINE INDEX ih ON vec FIELDS emb HNSW DIMENSION 8 DIST EUCLIDEAN")
ds.execute("INSERT INTO vec $rows RETURN NONE", vars={{"rows": rows}})
ds.execute("SELECT id FROM vec WHERE emb <|3|> $q", vars={{"q": rows[1]["emb"]}})
assert ds.index_stores.get("test", "test", "vec", "ih").wait_ivf(60)
out = ds.execute("SELECT id FROM vec WHERE emb <|3|> $q", vars={{"q": rows[1]["emb"]}})
assert out[-1]["status"] == "OK" and len(out[-1]["result"]) == 3, out
# the graph path's device branches: K8 and K7 counts, a K6 expand
cnf.TPU_GRAPH_COUNT_EDGES = 1
cnf.TPU_GRAPH_ONDEVICE_THRESHOLD = 1
ds.execute("CREATE p:0; CREATE p:1; CREATE p:2; RELATE p:0->knows->p:1; RELATE p:1->knows->p:2")
out = ds.execute("SELECT count(->knows->p->knows->p) AS c FROM p:0")
assert out[-1]["result"] == [{{"c": 1}}], out
out = ds.execute("SELECT count(->knows->p->knows) AS c FROM p:0")
assert out[-1]["result"] == [{{"c": 1}}], out
out = ds.execute("SELECT VALUE ->knows->p->knows->p FROM p:0")
assert [t.id for t in out[-1]["result"][0]] == [2], out
# the full-text path: a SEARCH index, bulk and single writes, @1@ with
# search::score on the host twin and (threshold 1) the kernel's branch,
# and a transaction's own write through the KV search
ds.execute("DEFINE ANALYZER simple TOKENIZERS blank FILTERS lowercase; "
           "DEFINE INDEX fb ON doc FIELDS body SEARCH ANALYZER simple BM25")
out = ds.execute("INSERT INTO doc $rows RETURN NONE",
                 vars={{"rows": [{{"id": i, "body": "a b" if i % 2 else "a c"}} for i in range(20)]}})
assert out[-1]["status"] == "OK", out
ds.execute("CREATE doc:100 SET body = 'a b b'")
sql = "SELECT id, search::score(1) AS sc FROM doc WHERE body @1@ 'a b' ORDER BY sc DESC LIMIT 3"
for th in (262_144, 1):
    cnf.TPU_FT_ONDEVICE_THRESHOLD = th
    out = ds.execute(sql)
    assert out[-1]["status"] == "OK" and out[-1]["result"][0]["id"].id == 100, out
out = ds.execute("BEGIN; CREATE doc:101 SET body = 'b'; SELECT id FROM doc WHERE body @@ 'b'; COMMIT;")
assert all(r["status"] == "OK" for r in out) and len(out[-1]["result"]) == 12, out
# the ML path: the columnar scan over the MTREE mirror (K10's plain
# versions on the CPU), a batch above the device threshold, and a .surml
# import (ONNX y = x @ [[2], [3]] + 1, keys a, b with normalisers) and its
# buffered compute
from surrealdb_tpu_torch.dbs.session import Session
from surrealdb_tpu_torch.ml.exec import import_model, import_surml
ds.execute("DEFINE MODEL ml::scorer<1>")
import_model(ds, Session.owner(), "scorer", "1", {{"format": "mlp", "layers": [
    {{"w": np.ones((8, 4)).tolist(), "b": [0.0] * 4, "activation": "relu"}},
    {{"w": np.ones((4, 3)).tolist(), "b": [0.0] * 3, "activation": "softmax"}}]}})
out = ds.execute("SELECT VALUE ml::scorer<1>(emb) FROM item")
assert out[-1]["status"] == "OK" and len(out[-1]["result"]) == 64, out
out = ds.execute("RETURN ml::scorer<1>($b)", vars={{"b": [[0.5] * 8] * 1500}})
assert out[-1]["status"] == "OK" and len(out[-1]["result"]) == 1500, out
import_surml(ds, Session.owner(), bytes.fromhex({surml!r}))
out = ds.execute("RETURN ml::lin<1>({{a: 5.0, b: 4.0}})")
assert out[-1]["status"] == "OK" and abs(out[-1]["result"] - 121.0) < 1e-3, out
# the mesh path: both indexes again on eight shards of the CPU, then the dry run
import torch
from surrealdb_tpu_torch import telemetry
from surrealdb_tpu_torch.parallel import dryrun
from surrealdb_tpu_torch.parallel.mesh import make_mesh
Datastore._mesh_cache = ("mesh", make_mesh(8, devices=[torch.device("cpu")] * 8))
for tb in ("item", "vec"):
    out = ds.execute(f"SELECT id FROM {{tb}} WHERE emb <|3|> $q", vars={{"q": rows[2]["emb"]}})
    assert out[-1]["status"] == "OK" and out[-1]["result"][0]["id"].id == 2, out
assert ds.index_stores.get("test", "test", "vec", "ih").wait_ivf(60)
out = ds.execute("SELECT id FROM vec WHERE emb <|3|> $q", vars={{"q": rows[2]["emb"]}})
assert out[-1]["status"] == "OK" and out[-1]["result"][0]["id"].id == 2, out
strategies = telemetry.snapshot()["counters"]
assert strategies['knn_strategy{{strategy="exact-sharded"}}'] == 1, strategies
assert strategies['knn_strategy{{strategy="ivf-sharded"}}'] >= 1, strategies
dryrun.dryrun_multichip(8, device="cpu")
Datastore._mesh_cache = ("unset", None)
# the server surface: one query over HTTP /rpc and one over WebSocket,
# each through the SDK, served from this store
from surrealdb_tpu_torch.net.server import Server
from surrealdb_tpu_torch.sdk import Surreal
srv = Server(ds, port=0, auth_enabled=False).start_background()
for url in (srv.url, srv.url.replace("http://", "ws://") + "/rpc"):
    with Surreal(url, format="cbor") as db:
        db.use("test", "test")
        out = db.query("SELECT id FROM item WHERE emb <|3|> $q", {{"q": rows[1]["emb"]}})
        assert out[-1]["status"] == "OK" and out[-1]["result"][0]["id"].id == 1, out
srv.shutdown()
ds.close()
# the embedded engine's statements on a file store: FETCH, INFO FOR, SHOW
# CHANGES, an embedded script, tick(), export, then a reopen from disk
from surrealdb_tpu_torch.kvs.export import export_database
fds = Datastore("file://" + {db!r}, device="cpu")
fds.capabilities = fds.capabilities.with_scripting(True)
out = fds.execute("DEFINE TABLE person CHANGEFEED 1h; CREATE person:2 SET name = 'b'; "
                  "CREATE person:1 SET name = 'a', friend = person:2; "
                  "DEFINE INDEX pe ON person FIELDS emb MTREE DIMENSION 2; "
                  "SELECT friend FROM person:1 FETCH friend; INFO FOR DB; "
                  "INFO FOR TABLE person; SHOW CHANGES FOR TABLE person SINCE 0; "
                  "RETURN function() {{ return [1, 2].map(v => v * 3); }};")
assert all(r["status"] == "OK" for r in out), out
assert out[4]["result"][0]["friend"]["name"] == "b" and "person" in out[5]["result"]["tables"], out
assert "pe" in out[6]["result"]["indexes"] and len(out[7]["result"]) >= 2, out
assert out[8]["result"] == [3, 6], out
fds.tick()
assert "INSERT [{{ id: person:1, " in export_database(fds, Session.owner())
fds.close()
fds = Datastore("file://" + {db!r}, device="cpu")
out = fds.execute("SELECT VALUE name FROM person")
assert out[-1]["result"] == ["a", "b"], out
fds.close()
# cluster mode: three nodes, RF 2, a kNN and a scan through the coordinator
from surrealdb_tpu_torch import cluster
from surrealdb_tpu_torch.net.server import serve
srvs = [serve("memory", port=0, auth_enabled=False, device="cpu").start_background()
        for _ in range(3)]
nodes = [{{"id": f"n{{i + 1}}", "url": srv.url}} for i, srv in enumerate(srvs)]
stores = [srv.httpd.RequestHandlerClass.ds for srv in srvs]
for i, cds in enumerate(stores):
    cluster.attach(cds, cluster.ClusterConfig(nodes, f"n{{i + 1}}", secret="s"))
out = stores[0].execute("DEFINE TABLE item; DEFINE INDEX im ON item FIELDS emb MTREE "
                        "DIMENSION 8 DIST EUCLIDEAN; INSERT INTO item $rows RETURN NONE; "
                        "SELECT id FROM item WHERE emb <|3|> $q; "
                        "SELECT count() FROM item GROUP ALL", vars={{"rows": rows, "q": rows[1]["emb"]}})
assert all(r["status"] == "OK" for r in out), out
assert out[3]["result"][0]["id"].id == 1 and out[4]["result"] == [{{"count": 64}}], out
for srv, cds in zip(srvs, stores):
    cluster.detach(cds)
    srv.shutdown()
    cds.close()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "ml_dtypes"))
             or m == "surrealdb_tpu" or m.startswith(("surrealdb_tpu.", "scripts"))
             or m == "scripts")
print("LEAKED", bad)
"""


# a .surml file: header (keys a, b; a z_score(3, 2), b linear_scaling(0,
# 10); output price z_score(100, 5); name lin, version 1) and an ONNX graph
# y = x @ [[2], [3]] + 1 with input shape [N, 2]
_SURML = (
    "0000008d613d3e622f2f3d3e613d3e7a5f73636f726528332e302c322e30292f2f623d3e6c696e6561725f"
    "7363616c696e6728302e302c31302e30292f2f3d3e70726963653d3e7a5f73636f7265283130302e302c35"
    "2e30292f2f3d3e6c696e2f2f3d3e312f2f3d3e612074657374206d6f64656c2f2f3d3e6f6e6e782f2f3d3e"
    "74657374732f2f3d3e736f6d656f6e6508073a640a120a01780a017712026d6d22064d61744d756c0a0f0a"
    "026d6d0a016212017922034164642a130802080110014201774a0800000040000040402a0d080110014201"
    "624a040000803f5a140a0178120f0a0d080112090a0312014e0a02080262030a0179"
)


def test_slice_loads_no_jax_and_no_reference_module(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _SLICE.format(repo=REPO, surml=_SURML, db=str(tmp_path / "db"))],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LEAKED []" in proc.stdout, proc.stdout


_CLUSTER_MODULES = sorted(
    f[:-3] for f in os.listdir(os.path.join(PKG, "cluster")) if f.endswith(".py"))

_LEAKED = """
import importlib, sys
sys.path.insert(0, {repo!r})
importlib.import_module({mod!r})
print("LEAKED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "scripts",
                                              "surrealdb_tpu")))
"""


@pytest.fixture(scope="module")
def cluster_imports():
    from concurrent.futures import ThreadPoolExecutor

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

    def one(name):
        mod = "surrealdb_tpu_torch.cluster" + ("" if name == "__init__" else "." + name)
        return subprocess.run([sys.executable, "-c", _LEAKED.format(repo=REPO, mod=mod)],
                              capture_output=True, text=True, timeout=120, env=env, cwd=REPO)

    with ThreadPoolExecutor(4) as pool:
        return dict(zip(_CLUSTER_MODULES, pool.map(one, _CLUSTER_MODULES)))


def test_cluster_has_every_reference_module():
    ref = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "surrealdb_tpu", "cluster"))
                 if f.endswith(".py"))
    assert _CLUSTER_MODULES == ref and len(ref) == 11, (_CLUSTER_MODULES, ref)


def _modules(root):
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _dirs, files in os.walk(root) if "_build" not in d
            for f in files if f.endswith(".py")}


def test_port_has_every_reference_module():
    """A tree diff of the two packages: every module of the reference has
    its twin in the port; the port's own are the kernel loader, its
    scratch cache and the mesh dry run."""
    ref, port = _modules(os.path.join(REPO, "surrealdb_tpu")), _modules(PKG)
    assert ref - port == set()
    assert port - ref == {os.path.join("ops", "_cuda.py"), os.path.join("ops", "scratch.py"),
                          os.path.join("parallel", "dryrun.py")}


@pytest.mark.parametrize("name", _CLUSTER_MODULES)
def test_cluster_module_loads_no_jax_and_no_reference_module(cluster_imports, name):
    proc = cluster_imports[name]
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LEAKED []" in proc.stdout, proc.stdout


_FORBIDDEN = [
    re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M),
    re.compile(r"\bjnp\b"),
    re.compile(r"\bml_dtypes\b"),
    # a module path of the reference package (file paths in docstrings,
    # surrealdb_tpu/..., name the file a module mirrors and are allowed)
    re.compile(r"\bsurrealdb_tpu\b(?!_torch)(?!/)"),
    # the repo's tooling (graftcheck, graftflow) audits the JAX package
    re.compile(r"^\s*(import\s+scripts|from\s+scripts)\b", re.M),
]


def _port_sources():
    for root, _dirs, files in os.walk(PKG):
        if "_build" in root or "__pycache__" in root:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("pattern", _FORBIDDEN, ids=lambda p: p.pattern)
def test_static_scan_finds_no_reference_import(pattern):
    hits = []
    for path in _port_sources():
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if pattern.search(line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{n}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_datastore_defaults_to_cuda_and_raises_without_a_card():
    from surrealdb_tpu_torch.kvs.ds import Datastore

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default constructor succeeds")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Datastore("memory")


def test_cpu_datastore_keeps_its_device():
    from surrealdb_tpu_torch.kvs.ds import Datastore

    ds = Datastore("memory", device="cpu")
    try:
        assert ds.device == torch.device("cpu")
        assert ds.mesh() is None
    finally:
        ds.close()


def test_unported_ivf_branch_raises(monkeypatch):
    """No fallback under a mesh: a mesh kernel that raises fails the query
    (`ivf-sharded` for HNSW, `exact-sharded` for MTREE), and no
    single-device strategy answers in its place."""
    from surrealdb_tpu_torch import cnf, telemetry
    from surrealdb_tpu_torch.idx import ivf as IVF
    from surrealdb_tpu_torch.kvs.ds import Datastore
    from surrealdb_tpu_torch.parallel import mesh as M

    monkeypatch.setattr(cnf, "TPU_KNN_ONDEVICE_THRESHOLD", 16)
    monkeypatch.setattr(cnf, "TPU_ANN_MIN_ROWS", 32)
    monkeypatch.setattr(Datastore, "_mesh_cache",
                        ("mesh", M.make_mesh(8, devices=[torch.device("cpu")] * 8)))
    ds = Datastore("memory", device="cpu")
    try:
        rng = np.random.default_rng(0)
        rows = [{"id": i, "emb": rng.standard_normal(8).astype(np.float32).tolist()}
                for i in range(64)]
        ds.execute("DEFINE TABLE item; DEFINE INDEX ih ON item FIELDS emb "
                   "HNSW DIMENSION 8 DIST EUCLIDEAN; DEFINE TABLE m; DEFINE INDEX im ON m "
                   "FIELDS emb MTREE DIMENSION 8 DIST EUCLIDEAN")
        for tb in ("item", "m"):
            ds.execute(f"INSERT INTO {tb} $rows RETURN NONE", vars={"rows": rows})
        ds.execute("SELECT id FROM item WHERE emb <|3|> $q", vars={"q": rows[0]["emb"]})
        assert ds.index_stores.get("test", "test", "item", "ih").wait_ivf(60)

        def boom(*a, **kw):
            raise RuntimeError("mesh_topk_merge: CUDA launch failed with error 9")

        monkeypatch.setattr(M, "topk_merge", boom)
        before = telemetry.snapshot()["counters"]
        for tb in ("item", "m"):
            out = ds.execute(f"SELECT id FROM {tb} WHERE emb <|3|> $q",
                             vars={"q": rows[0]["emb"]})
            assert out[-1]["status"] == "ERR", out
            assert "mesh_topk_merge" in out[-1]["result"]
        after = telemetry.snapshot()["counters"]
        served = {k: after[k] - before.get(k, 0) for k in after
                  if k.startswith("knn_strategy") and after[k] != before.get(k, 0)}
        assert served == {}, served
        monkeypatch.setattr(IVF, "_ivf_rerank", boom)
        st = ds.index_stores.get("test", "test", "item", "ih").ivf
        with pytest.raises(RuntimeError, match="mesh_topk_merge"):
            st.search_batch_sharded(np.zeros((1, 8), dtype=np.float32), Datastore._mesh_cache[1],
                                    torch.zeros(64, 8), "euclidean", 1, 1)
    finally:
        ds.close()


def test_mesh_cache_is_set_only_through_monkeypatch():
    """Tests that put a mesh on the Datastore do it with monkeypatch, which
    resets `_mesh_cache` after the test; none assigns it directly, so no
    mesh leaks into another test."""
    from surrealdb_tpu_torch.kvs.ds import Datastore

    direct = re.compile(r"Datastore\._mesh_cache\s*=(?!=)")
    hits = []
    for f in sorted(os.listdir(os.path.join(REPO, "tests"))):
        if f.startswith("test_torch_") and f.endswith(".py") and f != "test_torch_isolation.py":
            with open(os.path.join(REPO, "tests", f)) as fh:
                hits += [f"{f}:{n}" for n, line in enumerate(fh, 1) if direct.search(line)]
    assert not hits, hits
    assert Datastore._mesh_cache == ("unset", None)


def test_file_backend_opens_and_persists(tmp_path):
    """`file://` opens the port's file backend (and `surrealkv://`,
    `rocksdb://` name the same one): a write survives close and reopen."""
    from surrealdb_tpu_torch.kvs.ds import Datastore
    from surrealdb_tpu_torch.kvs.file import FileDatastore

    path = str(tmp_path / "db")
    ds = Datastore("file://" + path, device="cpu")
    try:
        assert isinstance(ds.backend, FileDatastore)
        out = ds.execute("CREATE t:1 SET v = 7; CREATE t:2 SET v = 8")
        assert all(r["status"] == "OK" for r in out), out
    finally:
        ds.close()
    for scheme in ("file", "surrealkv", "rocksdb"):
        ds = Datastore(f"{scheme}://{path}", device="cpu")
        try:
            out = ds.execute("SELECT VALUE v FROM t")
            assert out[-1]["result"] == [7, 8], out
        finally:
            ds.close()


def test_dispatch_retries_only_out_of_memory():
    from surrealdb_tpu_torch.dbs.dispatch import _transient
    from surrealdb_tpu_torch.faults import TransientFaultError

    assert _transient(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert _transient(TransientFaultError("injected"))
    assert not _transient(RuntimeError("knn_select: CUDA launch failed with error 9"))
    assert not _transient(RuntimeError("RESOURCE_EXHAUSTED"))
