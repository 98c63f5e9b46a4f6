"""Logical export/import of a database as .surql text.

Role of the reference's export machinery (reference: core/src/kvs/export.rs,
ds.rs:1115-1175): stream OPTION header, catalog DEFINEs, then table records
as INSERT batches; import = re-execution of the statements.
"""

from __future__ import annotations

from typing import List

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch import key as keys
from surrealdb_tpu_torch.key.encode import prefix_end
from surrealdb_tpu_torch.sql.value import Thing, format_value
from surrealdb_tpu_torch.utils.ser import unpack


def export_database(ds, session) -> str:
    from surrealdb_tpu_torch.dbs.executor import Executor
    from surrealdb_tpu_torch.dbs.info import _r_az, _r_fc, _r_fd, _r_ix, _r_pa, _r_tb, _r_ev

    ns, db = session.ns, session.db
    out: List[str] = [
        "-- ------------------------------",
        "-- OPTION",
        "-- ------------------------------",
        "",
        "OPTION IMPORT;",
        "",
    ]
    txn = ds.transaction(False)
    try:
        def section(title: str):
            out.extend([
                "-- ------------------------------",
                f"-- {title}",
                "-- ------------------------------",
                "",
            ])

        for az in txn.all_az(ns, db):
            section(f"ANALYZER {az['name']}")
            out.append(_r_az(az) + ";")
        for fc in txn.all_fc(ns, db):
            section(f"FUNCTION fn::{fc['name']}")
            out.append(_r_fc(fc) + ";")
        for pa in txn.all_pa(ns, db):
            section(f"PARAM ${pa['name']}")
            out.append(_r_pa(pa) + ";")

        for tb in txn.all_tb(ns, db):
            name = tb["name"]
            section(f"TABLE: {name}")
            out.append(_r_tb(tb) + ";")
            for fd in txn.all_tb_fields(ns, db, name):
                out.append(_r_fd(fd) + ";")
            for ix in txn.all_tb_indexes(ns, db, name):
                out.append(_r_ix(ix) + ";")
            for ev in txn.all_tb_events(ns, db, name):
                out.append(_r_ev(ev) + ";")
            out.append("")

            # record data in INSERT batches; edge records go through
            # INSERT RELATION so import re-creates the graph pointers
            pre = keys.thing_prefix(ns, db, name)
            batch: List[str] = []
            for chunk in txn.batch(pre, prefix_end(pre), cnf.EXPORT_BATCH_SIZE):
                rows, rel_rows = [], []
                for _, raw in chunk:
                    doc = unpack(raw)
                    is_edge = isinstance(doc, dict) and isinstance(
                        doc.get("in"), Thing
                    ) and isinstance(doc.get("out"), Thing)
                    (rel_rows if is_edge else rows).append(format_value(doc))
                if rows:
                    batch.append(f"INSERT [{', '.join(rows)}];")
                if rel_rows:
                    batch.append(f"INSERT RELATION [{', '.join(rel_rows)}];")
            if batch:
                section(f"TABLE DATA: {name}")
                out.extend(batch)
                out.append("")
    finally:
        txn.cancel()
    return "\n".join(out) + "\n"


def import_database(ds, session, text: str) -> List[dict]:
    """Re-execute an exported .surql script (reference importer role)."""
    return ds.execute(text, session)
