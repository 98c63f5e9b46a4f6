"""Kernel scratch kept zero between calls, one a (kind, device, stream, size).

K6's `graph_chain` (idx/graph_csr.py `ChainScratch`) and K15's
`mesh_dedup_frontier` (parallel/mesh.py `DedupScratch`) leave their scratch
zero, so a call needs no memset. A failed call may leave it dirty: the
scratch is then marked so, and the next call passes `clear`, whose C entry
zeroes the scratch first. Each kind keeps only its buffers' layout.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

__all__ = ["ZeroKept", "zero_kept"]


class ZeroKept:
    """The dirty flag and the lock of a zero-kept scratch. `lock` keeps one
    call's launches together on the stream (the ctypes call lets go of the
    GIL)."""

    def __init__(self):
        self.dirty = False
        self.lock = threading.Lock()

    def run(self, launch: Callable[[int], int]) -> int:
        """`launch(clear)`'s status, under the lock: clear = 1 after a
        failed call; a non-zero status marks the scratch dirty."""
        with self.lock:
            status = launch(int(self.dirty))
            self.dirty = status != 0
        return status


_CACHE: Dict[tuple, ZeroKept] = {}
_CACHE_LOCK = threading.Lock()


def zero_kept(cls, lib, device, n: int, stream) -> ZeroKept:
    """The cached `cls(lib, n, device)` of (cls, device, stream, n)."""
    key = (cls, device, stream, int(n))
    with _CACHE_LOCK:
        sc = _CACHE.get(key)
        if sc is None:
            sc = _CACHE[key] = cls(lib, int(n), device)
        return sc
