"""The file backend (`kvs/file.py`) and the statements that read a store
(INFO FOR, SHOW CHANGES, export) held to the JAX reference on the CPU.

The on-disk format is shared: a store that either package wrote opens in
the other and answers SELECT, `<|k|>`, INFO FOR DB and SHOW CHANGES as the
writer's own package does on the same files. Both packages export the same
store to identical text, and a torn WAL tail and a compaction recover the
same rows in both. The reference runs on JAX's CPU with its device mesh
off; the port runs with device="cpu". Each package gets its kNN threshold
lowered so the MTREE query goes through the mirror that a reopen rebuilds
from the KV store. Distances agree to 1e-5 (relative above 1); ids exactly.
"""

import os
import shutil
import struct

import numpy as np
import pytest

from surrealdb_tpu import cnf as rcnf
from surrealdb_tpu.dbs.session import Session as RSession
from surrealdb_tpu.kvs import export as rexport
from surrealdb_tpu.kvs import file as rfile
from surrealdb_tpu.kvs.ds import Datastore as RDatastore
from surrealdb_tpu.sql.value import format_value as rformat
from surrealdb_tpu_torch import cnf as pcnf
from surrealdb_tpu_torch.dbs.session import Session as PSession
from surrealdb_tpu_torch.kvs import export as pexport
from surrealdb_tpu_torch.kvs import file as pfile
from surrealdb_tpu_torch.kvs.ds import Datastore as PDatastore
from surrealdb_tpu_torch.sql.value import format_value as pformat

DIM = 16
N_ITEMS = 300
K = 5
TOL = 1e-5

PKGS = {
    "ref": (lambda path: RDatastore(f"file://{path}"), rformat, rexport, RSession),
    "port": (lambda path: PDatastore(f"file://{path}", device="cpu"), pformat, pexport,
             PSession),
}


@pytest.fixture(autouse=True)
def _both(monkeypatch):
    for c in (rcnf, pcnf):
        monkeypatch.setattr(c, "TPU_KNN_ONDEVICE_THRESHOLD", 64)
    monkeypatch.setattr(RDatastore, "_mesh_cache", ("none", None))


def _run(ds, sql, vars=None):
    out = ds.execute(sql, vars=vars or {})
    for r in out:
        assert r["status"] == "OK", (sql, r)
    return out[-1]["result"]


def _data():
    rng = np.random.default_rng(15)
    items = [{"id": i, "emb": rng.standard_normal(DIM).astype(np.float32).tolist(),
              "tag": int(rng.integers(0, 4))} for i in range(N_ITEMS)]
    queries = rng.standard_normal((3, DIM)).astype(np.float32)
    return items, queries


def _write(pkg, path):
    """A few tables, a 16-d MTREE index, a changefeed table with a create,
    an update and a delete, and a database user. The definitions and the
    people go into a snapshot by a compaction; the rest stays in the WAL,
    one frame a statement."""
    items, _ = _data()
    ds = PKGS[pkg][0](path)
    _run(ds, "DEFINE TABLE person SCHEMAFULL; DEFINE FIELD name ON person TYPE string; "
             "DEFINE FIELD age ON person TYPE int; DEFINE TABLE item; "
             f"DEFINE INDEX im ON item FIELDS emb MTREE DIMENSION {DIM} DIST EUCLIDEAN; "
             "DEFINE TABLE event CHANGEFEED 1h; "
             "DEFINE USER alice ON DATABASE PASSWORD 'pw' ROLES VIEWER")
    _run(ds, "CREATE person:1 SET name = 'ann', age = 31; "
             "CREATE person:2 SET name = 'bob', age = 42; CREATE person:3 SET name = 'cy', age = 7")
    ds.backend.flush()
    _run(ds, "INSERT INTO item $rows RETURN NONE", {"rows": items})
    _run(ds, "CREATE event:1 SET kind = 'a'; CREATE event:2 SET kind = 'b'; "
             "UPDATE event:1 SET kind = 'c'; DELETE event:2; UPDATE person:3 SET age = 8")
    return ds


def _records(fmt, rows):
    """Rows rendered field by field in name order (an import writes a
    record's fields in another order than CREATE ... SET did)."""
    return [fmt(dict(sorted(r.items()))) for r in rows]


def _answers(pkg, path):
    """The writer-independent answers of one package over a store: each
    rendered with that package's own format_value, kNN hits as (id, d)."""
    ds_ctor, fmt, _exp, _sess = PKGS[pkg]
    _items, queries = _data()
    ds = ds_ctor(path)
    try:
        out = {
            "person": _records(fmt, _run(ds, "SELECT * FROM person ORDER BY id")),
            "tags": fmt(_run(ds, "SELECT tag, count() AS n FROM item GROUP BY tag")),
            "info_db": fmt(_run(ds, "INFO FOR DB")),
            "info_tb": fmt(_run(ds, "INFO FOR TABLE item")),
            "changes": fmt(_run(ds, "SHOW CHANGES FOR TABLE event SINCE 0")),
            "knn": [
                [(r["id"].id, float(r["d"])) for r in _run(
                    ds, f"SELECT id, vector::distance::knn() AS d FROM item "
                        f"WHERE emb <|{K}|> $q", {"q": q.tolist()})]
                for q in queries
            ],
        }
    finally:
        ds.close()
    return out


def _assert_same(a, b):
    for key in a:
        if key != "knn":
            assert a[key] == b[key], key
    for qa, qb in zip(a["knn"], b["knn"]):
        assert [i for i, _ in qa] == [i for i, _ in qb]
        for (_, da), (_, db) in zip(qa, qb):
            assert abs(da - db) <= TOL * max(1.0, da)


def _copy(src, dst):
    for suffix in ("", ".wal"):
        if os.path.exists(src + suffix):
            shutil.copyfile(src + suffix, dst + suffix)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_store_opens_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "db")
    _write(writer, path).close()
    assert rfile.storage_version(path) == pfile.storage_version(path) == 1
    own, other = str(tmp_path / "own"), str(tmp_path / "other")
    _copy(path, own)
    _copy(path, other)
    a, b = _answers(writer, own), _answers(reader, other)
    assert len(a["knn"][0]) == K and "alice" in a["info_db"] and "im" in a["info_tb"]
    assert "'c'" in a["changes"] and "delete" in a["changes"]
    _assert_same(a, b)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_export_text_identical_and_imports_into_the_port(tmp_path, writer):
    path = str(tmp_path / "db")
    _write(writer, path).close()
    texts = {}
    for pkg, (ctor, _fmt, exp, sess) in PKGS.items():
        copy = str(tmp_path / pkg)
        _copy(path, copy)
        ds = ctor(copy)
        try:
            texts[pkg] = exp.export_database(ds, sess.owner())
        finally:
            ds.close()
    assert texts["ref"] == texts["port"]
    assert "DEFINE INDEX im ON item" in texts["port"] and "person:3" in texts["port"]
    src = _answers("port", str(tmp_path / "port"))
    imported = str(tmp_path / "imported")
    ds = PDatastore(f"file://{imported}", device="cpu")
    try:
        out = pexport.import_database(ds, PSession.owner(), texts["ref"])
        assert all(r["status"] == "OK" for r in out), [r for r in out if r["status"] != "OK"]
    finally:
        ds.close()
    got = _answers("port", imported)
    _assert_same({k: got[k] for k in ("person", "tags", "knn")}, src)


def _rows(pkg, path):
    ds_ctor, fmt, _exp, _sess = PKGS[pkg]
    ds = ds_ctor(path)
    try:
        return (_records(fmt, _run(ds, "SELECT * FROM person ORDER BY id")),
                _run(ds, "SELECT count() FROM item GROUP ALL")[0]["count"],
                _records(fmt, _run(ds, "SELECT * FROM event ORDER BY id")))
    finally:
        ds.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_torn_wal_tail_and_compaction_recover_identically(tmp_path, writer):
    """A store left without close() and with a partial frame appended to its
    WAL recovers the same rows in both packages, truncates the WAL to the
    same intact prefix, and a compaction of the recovered store keeps them."""
    path = str(tmp_path / "db")
    ds = _write(writer, path)
    _run(ds, "CREATE person:4 SET name = 'dee', age = 55")
    wal_before = os.path.getsize(path + ".wal")
    with open(path + ".wal", "ab") as f:
        f.write(struct.pack(">II", 10_000, 12345) + b"short")
    recovered = {}
    for pkg in PKGS:
        copy = str(tmp_path / pkg)
        _copy(path, copy)
        recovered[pkg] = _rows(pkg, copy)
        assert os.path.getsize(copy + ".wal") == wal_before
    ds.close()
    assert recovered["ref"] == recovered["port"]
    assert "person:4" in recovered["port"][0][-1] and recovered["port"][1] == N_ITEMS
    compacted = {}
    for pkg in PKGS:
        copy = str(tmp_path / pkg)
        d = PKGS[pkg][0](copy)
        d.backend.flush()
        d.close()
        assert os.path.getsize(copy + ".wal") == len(pfile.WAL_MAGIC)
        compacted[pkg] = _rows(pkg, copy)
    assert compacted["ref"] == compacted["port"] == recovered["port"]
    with open(str(tmp_path / "ref"), "rb") as a, open(str(tmp_path / "port"), "rb") as b:
        ra, rb = a.read(), b.read()
    assert ra[:len(rfile.MAGIC)] == rb[:len(pfile.MAGIC)] == b"STPU1\n"
