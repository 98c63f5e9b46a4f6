"""Keyspace layout + builders.

Layout (own design, same roles as reference core/src/key/mod.rs:1-77):

    /!nd{uuid}                          cluster node registration
    /!us{user}                          root user
    /!ac{access}                        root access definition
    /!ns{ns}                            namespace definition
    /*{ns}!db{db}                       database definition
    /*{ns}!us{user}                     namespace user
    /*{ns}!ac{access}                   namespace access
    /*{ns}*{db}!tb{tb}                  table definition
    /*{ns}*{db}!us{user}                database user
    /*{ns}*{db}!ac{access}              database access
    /*{ns}*{db}!fc{name}                custom function
    /*{ns}*{db}!pa{name}                param
    /*{ns}*{db}!az{name}                analyzer
    /*{ns}*{db}!ml{name}{version}       ml model
    /*{ns}*{db}!ts{ts}                  timestamp -> versionstamp mapping
    /*{ns}*{db}#{vs}                    changefeed entry (vs = 10-byte versionstamp)
    /*{ns}*{db}*{tb}!fd{fd}             field definition
    /*{ns}*{db}*{tb}!ix{ix}             index definition
    /*{ns}*{db}*{tb}!ev{ev}             event definition
    /*{ns}*{db}*{tb}!ft{ft}             foreign (view) table link
    /*{ns}*{db}*{tb}!lq{uuid}           live query registration
    /*{ns}*{db}*{tb}*{id}               record
    /*{ns}*{db}*{tb}^{id}               record replication meta (HLC stamp / tombstone)
    /*{ns}*{db}*{tb}~{id}{dir}{ft}{fk}  graph edge pointer (dir: '<' in, '>' out)
    /*{ns}*{db}*{tb}+{ix}*{vals}{id}    index entry (non-unique)
    /*{ns}*{db}*{tb}+{ix}=,{vals}       unique index entry (value = record id)
    /*{ns}*{db}*{tb}+{ix}!m{...}        index-internal state (FT dicts, doc ids, ...)

Record ids / field values use the order-preserving value encoding in
`encode.py`, so range scans over ids and index values work byte-wise.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, List, Tuple

from .encode import (
    enc_str,
    enc_u64,
    enc_value_key,
    dec_str,
    dec_value_key,
    prefix_end,
)

DIR_IN = b"<"
DIR_OUT = b">"


# ------------------------------------------------------------------- root
def node(uuid_bytes: bytes) -> bytes:
    return b"/!nd" + uuid_bytes


def node_prefix() -> bytes:
    return b"/!nd"


def node_lq(uuid_bytes: bytes, lq: bytes) -> bytes:
    """Node-scoped live-query pointer (reference key::node::lq) — lets a
    surviving node find and archive a dead node's live queries."""
    return b"/!nl" + uuid_bytes + lq


def node_lq_prefix(uuid_bytes: bytes = b"") -> bytes:
    return b"/!nl" + uuid_bytes


def root_user(user: str) -> bytes:
    return b"/!us" + enc_str(user)


def root_user_prefix() -> bytes:
    return b"/!us"


def root_access(ac: str) -> bytes:
    return b"/!ac" + enc_str(ac)


def root_access_prefix() -> bytes:
    return b"/!ac"


def namespace(ns: str) -> bytes:
    return b"/!ns" + enc_str(ns)


def namespace_prefix() -> bytes:
    return b"/!ns"


# ------------------------------------------------------------------- ns level
@lru_cache(maxsize=4096)
def _ns(ns: str) -> bytes:
    return b"/*" + enc_str(ns)


def database(ns: str, db: str) -> bytes:
    return _ns(ns) + b"!db" + enc_str(db)


def database_prefix(ns: str) -> bytes:
    return _ns(ns) + b"!db"


def ns_user(ns: str, user: str) -> bytes:
    return _ns(ns) + b"!us" + enc_str(user)


def ns_user_prefix(ns: str) -> bytes:
    return _ns(ns) + b"!us"


def ns_access(ns: str, ac: str) -> bytes:
    return _ns(ns) + b"!ac" + enc_str(ac)


def ns_access_prefix(ns: str) -> bytes:
    return _ns(ns) + b"!ac"


# ------------------------------------------------------------------- db level
@lru_cache(maxsize=4096)
def _db(ns: str, db: str) -> bytes:
    return _ns(ns) + b"*" + enc_str(db)


def table(ns: str, db: str, tb: str) -> bytes:
    return _db(ns, db) + b"!tb" + enc_str(tb)


def table_prefix(ns: str, db: str) -> bytes:
    return _db(ns, db) + b"!tb"


def db_user(ns: str, db: str, user: str) -> bytes:
    return _db(ns, db) + b"!us" + enc_str(user)


def db_user_prefix(ns: str, db: str) -> bytes:
    return _db(ns, db) + b"!us"


def db_access(ns: str, db: str, ac: str) -> bytes:
    return _db(ns, db) + b"!ac" + enc_str(ac)


def db_access_prefix(ns: str, db: str) -> bytes:
    return _db(ns, db) + b"!ac"


def access_grant(level: tuple, ac: str, gr: str) -> bytes:
    """Bearer/JWT grant storage (reference key::root/namespace/database::
    access::gr — `…!gr{ac}{gr}` per level)."""
    return _access_grant_base(level) + enc_str(ac) + enc_str(gr)


def access_grant_prefix(level: tuple, ac: str) -> bytes:
    return _access_grant_base(level) + enc_str(ac)


def _access_grant_base(level: tuple) -> bytes:
    if len(level) == 0:
        return b"/!gr"
    if len(level) == 1:
        return _ns(level[0]) + b"!gr"
    return _db(level[0], level[1]) + b"!gr"


def function(ns: str, db: str, name: str) -> bytes:
    return _db(ns, db) + b"!fc" + enc_str(name)


def function_prefix(ns: str, db: str) -> bytes:
    return _db(ns, db) + b"!fc"


def param(ns: str, db: str, name: str) -> bytes:
    return _db(ns, db) + b"!pa" + enc_str(name)


def param_prefix(ns: str, db: str) -> bytes:
    return _db(ns, db) + b"!pa"


def analyzer(ns: str, db: str, name: str) -> bytes:
    return _db(ns, db) + b"!az" + enc_str(name)


def analyzer_prefix(ns: str, db: str) -> bytes:
    return _db(ns, db) + b"!az"


def model(ns: str, db: str, name: str, version: str) -> bytes:
    return _db(ns, db) + b"!ml" + enc_str(name) + enc_str(version)


def model_prefix(ns: str, db: str) -> bytes:
    return _db(ns, db) + b"!ml"


def blob(ns: str, db: str, digest: str) -> bytes:
    """Content-addressed blob storage (role of the reference's object store,
    core/src/obs/mod.rs:20 — SHA-addressed model weight files)."""
    return _db(ns, db) + b"!ob" + enc_str(digest)


def blob_prefix(ns: str, db: str) -> bytes:
    return _db(ns, db) + b"!ob"


def database_ts(ns: str, db: str, ts: int) -> bytes:
    return _db(ns, db) + b"!ts" + enc_u64(ts)


def database_ts_prefix(ns: str, db: str) -> bytes:
    return _db(ns, db) + b"!ts"


def change(ns: str, db: str, vs: bytes) -> bytes:
    """Changefeed entry; vs is the 10-byte versionstamp."""
    return _db(ns, db) + b"#" + vs


def change_prefix(ns: str, db: str) -> bytes:
    return _db(ns, db) + b"#"


def decode_change(key: bytes, ns: str, db: str) -> bytes:
    pre = change_prefix(ns, db)
    return key[len(pre) :]


# ------------------------------------------------------------------- tb level
@lru_cache(maxsize=8192)
def _tb(ns: str, db: str, tb: str) -> bytes:
    return _db(ns, db) + b"*" + enc_str(tb)


def field(ns: str, db: str, tb: str, fd: str) -> bytes:
    return _tb(ns, db, tb) + b"!fd" + enc_str(fd)


def field_prefix(ns: str, db: str, tb: str) -> bytes:
    return _tb(ns, db, tb) + b"!fd"


def index_def(ns: str, db: str, tb: str, ix: str) -> bytes:
    return _tb(ns, db, tb) + b"!ix" + enc_str(ix)


def index_def_prefix(ns: str, db: str, tb: str) -> bytes:
    return _tb(ns, db, tb) + b"!ix"


def event(ns: str, db: str, tb: str, ev: str) -> bytes:
    return _tb(ns, db, tb) + b"!ev" + enc_str(ev)


def event_prefix(ns: str, db: str, tb: str) -> bytes:
    return _tb(ns, db, tb) + b"!ev"


def foreign_table(ns: str, db: str, tb: str, ft: str) -> bytes:
    return _tb(ns, db, tb) + b"!ft" + enc_str(ft)


def foreign_table_prefix(ns: str, db: str, tb: str) -> bytes:
    return _tb(ns, db, tb) + b"!ft"


def live_query(ns: str, db: str, tb: str, lq: bytes) -> bytes:
    return _tb(ns, db, tb) + b"!lq" + lq


def live_query_prefix(ns: str, db: str, tb: str) -> bytes:
    return _tb(ns, db, tb) + b"!lq"


# ------------------------------------------------------------------- records
def thing(ns: str, db: str, tb: str, id_: Any) -> bytes:
    return _tb(ns, db, tb) + b"*" + enc_value_key(id_)


def thing_prefix(ns: str, db: str, tb: str) -> bytes:
    return _tb(ns, db, tb) + b"*"


def decode_thing_id(key: bytes, ns: str, db: str, tb: str) -> Any:
    pre = thing_prefix(ns, db, tb)
    v, _ = dec_value_key(key, len(pre))
    return v


# ------------------------------------------------------------------- record meta
# /*{ns}*{db}*{tb}^{id}: per-record replication metadata — the HLC
# last-writer-wins stamp minted on every cluster write, and DELETE
# tombstones ({"dead": true}) so anti-entropy can tell "deleted" from
# "never written". Separate keyspace: record scans must never see it.
def record_meta(ns: str, db: str, tb: str, id_: Any) -> bytes:
    return _tb(ns, db, tb) + b"^" + enc_value_key(id_)


def record_meta_prefix(ns: str, db: str, tb: str) -> bytes:
    return _tb(ns, db, tb) + b"^"


def decode_record_meta_id(key: bytes, ns: str, db: str, tb: str) -> Any:
    pre = record_meta_prefix(ns, db, tb)
    v, _ = dec_value_key(key, len(pre))
    return v


# ------------------------------------------------------------------- graph
def graph(ns: str, db: str, tb: str, id_: Any, direction: bytes, ft: str, fk: Any) -> bytes:
    """Edge pointer: on record {tb}:{id_}, direction, edge table ft, edge id fk.

    Same role as reference core/src/key/graph/mod.rs:10-55.
    """
    return (
        _tb(ns, db, tb)
        + b"~"
        + enc_value_key(id_)
        + direction
        + enc_str(ft)
        + enc_value_key(fk)
    )


def graph_prefix(ns: str, db: str, tb: str, id_: Any = None, direction: bytes = None, ft: str = None) -> bytes:
    out = _tb(ns, db, tb) + b"~"
    if id_ is not None:
        out += enc_value_key(id_)
        if direction is not None:
            out += direction
            if ft is not None:
                out += enc_str(ft)
    return out


def decode_graph(key: bytes, ns: str, db: str, tb: str) -> Tuple[Any, bytes, str, Any]:
    """-> (id, direction, edge_table, edge_id)"""
    pre = _tb(ns, db, tb) + b"~"
    pos = len(pre)
    id_, pos = dec_value_key(key, pos)
    direction = key[pos : pos + 1]
    pos += 1
    ft, pos = dec_str(key, pos)
    fk, pos = dec_value_key(key, pos)
    return id_, direction, ft, fk


# ------------------------------------------------------------------- indexes
def index_entry(ns: str, db: str, tb: str, ix: str, vals: List[Any], id_: Any) -> bytes:
    """Non-unique index entry: field values then record id."""
    out = _tb(ns, db, tb) + b"+" + enc_str(ix) + b"*"
    for v in vals:
        out += enc_value_key(v)
    out += enc_value_key(id_)
    return out


def index_entry_prefix(ns: str, db: str, tb: str, ix: str, vals: List[Any] = None) -> bytes:
    out = _tb(ns, db, tb) + b"+" + enc_str(ix) + b"*"
    if vals:
        for v in vals:
            out += enc_value_key(v)
    return out


def decode_index_entry_id(key: bytes, ns: str, db: str, tb: str, ix: str, nvals: int) -> Tuple[List[Any], Any]:
    pre = index_entry_prefix(ns, db, tb, ix)
    pos = len(pre)
    vals = []
    for _ in range(nvals):
        v, pos = dec_value_key(key, pos)
        vals.append(v)
    id_, _ = dec_value_key(key, pos)
    return vals, id_


def unique_entry(ns: str, db: str, tb: str, ix: str, vals: List[Any]) -> bytes:
    """Unique index entry; the record id lives in the value."""
    out = _tb(ns, db, tb) + b"+" + enc_str(ix) + b"=,"
    for v in vals:
        out += enc_value_key(v)
    return out


def unique_entry_prefix(ns: str, db: str, tb: str, ix: str, vals: List[Any] = None) -> bytes:
    out = _tb(ns, db, tb) + b"+" + enc_str(ix) + b"=,"
    if vals:
        for v in vals:
            out += enc_value_key(v)
    return out


def decode_unique_entry_vals(key: bytes, ns: str, db: str, tb: str, ix: str, nvals: int) -> List[Any]:
    pre = unique_entry_prefix(ns, db, tb, ix)
    pos = len(pre)
    vals = []
    for _ in range(nvals):
        v, pos = dec_value_key(key, pos)
        vals.append(v)
    return vals


def index_state(ns: str, db: str, tb: str, ix: str, sub: bytes) -> bytes:
    """Index-internal state key (FT dictionaries, doc-id maps, vector rows...)."""
    return _tb(ns, db, tb) + b"+" + enc_str(ix) + b"!m" + sub


def index_state_prefix(ns: str, db: str, tb: str, ix: str) -> bytes:
    return _tb(ns, db, tb) + b"+" + enc_str(ix) + b"!m"


def index_prefix(ns: str, db: str, tb: str, ix: str) -> bytes:
    """Prefix covering ALL keys belonging to one index."""
    return _tb(ns, db, tb) + b"+" + enc_str(ix)


def table_all_prefix(ns: str, db: str, tb: str) -> bytes:
    """Prefix covering all keys of a table (defs, records, edges, indexes)."""
    return _tb(ns, db, tb)
