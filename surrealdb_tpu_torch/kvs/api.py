"""The pluggable storage-backend boundary.

Same role as the reference's backend trait (reference: core/src/kvs/api.rs:12-365):
every backend provides a transaction object with get/set/put/putc/del/delc/
exists/keys/scan/batch plus range deletes, and the Datastore hands these out.
Keys and values are raw bytes; ordering is bytewise.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Iterable, List, Optional, Tuple

from surrealdb_tpu_torch.err import (
    TxConditionNotMetError,
    TxFinishedError,
    TxKeyAlreadyExistsError,
    TxReadonlyError,
)

KV = Tuple[bytes, bytes]


class BackendTransaction(ABC):
    """One transaction against a backend. Write=False means read-only."""

    def __init__(self, write: bool):
        self.write = write
        self.done = False

    # -- lifecycle ---------------------------------------------------------
    @abstractmethod
    def commit(self) -> None: ...

    @abstractmethod
    def cancel(self) -> None: ...

    def _check_open(self, needs_write: bool = False) -> None:
        if self.done:
            raise TxFinishedError()
        if needs_write and not self.write:
            raise TxReadonlyError()

    # -- point ops ---------------------------------------------------------
    @abstractmethod
    def get(self, key: bytes, version: Optional[int] = None) -> Optional[bytes]: ...

    @abstractmethod
    def set(self, key: bytes, val: bytes) -> None: ...

    @abstractmethod
    def delete(self, key: bytes) -> None: ...

    def exists(self, key: bytes) -> bool:
        return self.get(key) is not None

    def version_of(self, key: bytes):
        """MVCC version of the newest committed value for `key`, when the
        backend tracks versions (mem does); None disables version-pinned
        features (changefeed bulk-entry expansion reads current values)."""
        return None

    def oldest_retained(self, key: bytes):
        """Oldest committed value still retained for `key` (None when the
        key is absent or its oldest retained entry is a tombstone). The
        changefeed reader's fallback when a pinned version was GC'd past
        the MVCC horizon — best-effort, same contract as retention GC."""
        return None

    def put(self, key: bytes, val: bytes) -> None:
        """Insert only-if-absent."""
        self._check_open(True)
        if self.get(key) is not None:
            raise TxKeyAlreadyExistsError()
        self.set(key, val)

    def putc(self, key: bytes, val: bytes, chk: Optional[bytes]) -> None:
        """Set only if current value == chk (None = must be absent)."""
        self._check_open(True)
        if self.get(key) != chk:
            raise TxConditionNotMetError()
        self.set(key, val)

    def delc(self, key: bytes, chk: Optional[bytes]) -> None:
        self._check_open(True)
        if self.get(key) != chk:
            raise TxConditionNotMetError()
        self.delete(key)

    # -- range ops ---------------------------------------------------------
    @abstractmethod
    def keys(self, beg: bytes, end: bytes, limit: int = -1) -> List[bytes]: ...

    @abstractmethod
    def scan(self, beg: bytes, end: bytes, limit: int = -1) -> List[KV]: ...

    def getr(self, beg: bytes, end: bytes) -> List[KV]:
        return self.scan(beg, end)

    def delr(self, beg: bytes, end: bytes) -> None:
        self._check_open(True)
        for k in self.keys(beg, end):
            self.delete(k)

    def getm(self, keys: Iterable[bytes]) -> List[Optional[bytes]]:
        return [self.get(k) for k in keys]

    def batch(self, beg: bytes, end: bytes, batch_size: int) -> Iterable[List[KV]]:
        """Stream a key range in batches (reference kvs/scanner.rs role)."""
        cur = beg
        while True:
            chunk = self.scan(cur, end, batch_size)
            if not chunk:
                return
            yield chunk
            if len(chunk) < batch_size:
                return
            cur = chunk[-1][0] + b"\x00"


class BackendDatastore(ABC):
    """Backend root: a factory of transactions."""

    @abstractmethod
    def transaction(self, write: bool) -> BackendTransaction: ...

    def close(self) -> None:
        pass
