"""Registry of device-resident index mirrors.

Role of the reference's IndexStores / TreeCache generation machinery
(reference: core/src/idx/trees/store/mod.rs:217, store/cache.rs): each
(ns, db, tb, ix) owns a mirror object (vector matrix, CSR graph, FT arrays)
that is rebuilt/refreshed by generation and shared across transactions.
Writes go to the KV first; mirrors refresh lazily when their generation
is behind the KV state generation.
"""

from __future__ import annotations

from surrealdb_tpu_torch.utils import locks as _locks
from typing import Any, Dict, Optional, Tuple

IndexKey = Tuple[str, str, str, str]  # ns, db, tb, ix


class IndexStores:
    def __init__(self):
        self._stores: Dict[IndexKey, Any] = {}
        self._lock = _locks.RLock("idx.store")

    def get(self, ns: str, db: str, tb: str, ix: str) -> Optional[Any]:
        with self._lock:
            return self._stores.get((ns, db, tb, ix))

    def get_or_create(self, ns: str, db: str, tb: str, ix: str, factory):
        with self._lock:
            k = (ns, db, tb, ix)
            st = self._stores.get(k)
            if st is None:
                st = factory()
                self._stores[k] = st
            return st

    def remove(self, ns: str, db: str, tb: str, ix: str) -> None:
        with self._lock:
            self._stores.pop((ns, db, tb, ix), None)

    def remove_table(self, ns: str, db: str, tb: str) -> None:
        with self._lock:
            for k in [k for k in self._stores if k[:3] == (ns, db, tb)]:
                del self._stores[k]

    def remove_db(self, ns: str, db: str) -> None:
        """Forget every mirror of one database (REMOVE DATABASE) — a
        recreated database must not reuse stale device state."""
        with self._lock:
            for k in [k for k in self._stores if k[:2] == (ns, db)]:
                del self._stores[k]

    def remove_ns(self, ns: str) -> None:
        """Forget every mirror of one namespace (REMOVE NAMESPACE)."""
        with self._lock:
            for k in [k for k in self._stores if k[0] == ns]:
                del self._stores[k]

    def clear(self) -> None:
        with self._lock:
            self._stores.clear()
