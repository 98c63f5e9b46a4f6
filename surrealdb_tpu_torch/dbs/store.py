"""Result collection with file-backed spill + external merge sort.

Role of the reference's Results store (reference: core/src/dbs/result.rs:15
Memory | File | Groups; dbs/store/file.rs:18 FileCollector with ext-sort
beyond EXTERNAL_SORTING_BUFFER_LIMIT, cnf/mod.rs:69 = 50k). Rows accumulate
in memory up to the configured limit, then spill to temp files as
length-prefixed msgpack chunks; a big ORDER BY sorts each chunk into a run
and k-way merges the runs (heapq), so peak memory stays one chunk instead
of the whole result set.
"""

from __future__ import annotations

import heapq
import os
import struct
import tempfile
from typing import Any, Callable, Iterable, Iterator, List, Optional

from surrealdb_tpu_torch import cnf
from surrealdb_tpu_torch.utils.ser import pack, unpack


class ResultStore:
    """List-like result collector that spills past `limit` rows."""

    def __init__(self, limit: Optional[int] = None):
        self.limit = limit if limit is not None else cnf.EXTERNAL_SORTING_BUFFER_LIMIT
        self.mem: List[Any] = []
        self._chunks: List[str] = []
        self._tmpdir: Optional[str] = None
        self._spilled = 0

    # ------------------------------------------------------------ list api
    def append(self, v: Any) -> None:
        self.mem.append(v)
        if len(self.mem) >= self.limit:
            self._spill()

    def extend(self, vs: Iterable[Any]) -> None:
        for v in vs:
            self.append(v)

    def __len__(self) -> int:
        return self._spilled + len(self.mem)

    def __iter__(self) -> Iterator[Any]:
        for path in self._chunks:
            yield from _read_chunk(path)
        yield from self.mem

    @property
    def spilled(self) -> bool:
        return bool(self._chunks)

    def to_list(self) -> List[Any]:
        if not self._chunks:
            return self.mem
        return list(self)

    # ------------------------------------------------------------ spill
    def _spill(self) -> None:
        if self._tmpdir is None:
            self._tmpdir = tempfile.mkdtemp(prefix="surreal-results-")
        path = os.path.join(self._tmpdir, f"chunk{len(self._chunks)}.bin")
        _write_chunk(path, self.mem)
        self._chunks.append(path)
        self._spilled += len(self.mem)
        self.mem = []

    def cleanup(self) -> None:
        if self._tmpdir is not None:
            import shutil

            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._chunks = []
            self._tmpdir = None

    # ------------------------------------------------------------ ext sort
    def sorted_iter(self, keyfunc: Callable[[Any], Any]) -> Iterator[Any]:
        """External merge sort: each spilled chunk re-reads, sorts, and
        rewrites as a run; runs + the memory tail merge lazily."""
        if not self._chunks:
            yield from sorted(self.mem, key=keyfunc)
            return
        runs = []
        for path in self._chunks:
            rows = list(_read_chunk(path))
            rows.sort(key=keyfunc)
            _write_chunk(path, rows)
            runs.append(_read_chunk(path))
        runs.append(iter(sorted(self.mem, key=keyfunc)))
        yield from heapq.merge(*runs, key=keyfunc)


def _write_chunk(path: str, rows: List[Any]) -> None:
    with open(path, "wb") as f:
        for row in rows:
            raw = pack(row)
            f.write(struct.pack(">I", len(raw)))
            f.write(raw)


def _read_chunk(path: str) -> Iterator[Any]:
    with open(path, "rb") as f:
        while True:
            head = f.read(4)
            if len(head) < 4:
                return
            (n,) = struct.unpack(">I", head)
            yield unpack(f.read(n))
