"""Versionstamps: 10-byte monotone stamps (8-byte version + 2-byte sequence).

Same shape as the reference's versionstamps (reference: core/src/vs/mod.rs:17).
Used to order changefeed entries.
"""

from __future__ import annotations

import struct


def versionstamp(version: int, seq: int = 0) -> bytes:
    return struct.pack(">QH", version, seq)


def decode_versionstamp(vs: bytes) -> tuple[int, int]:
    return struct.unpack(">QH", vs)


def vs_to_u64(vs: bytes) -> int:
    return struct.unpack(">Q", vs[:8])[0]


def u64_to_vs(v: int) -> bytes:
    return struct.pack(">QH", v, 0)


class Oracle:
    """Monotone versionstamp source, one per datastore."""

    def __init__(self):
        from surrealdb_tpu_torch.utils import locks as _locks

        self._last = 0
        self._lock = _locks.Lock("kvs.version_store")

    def next_vs(self, now_nanos: int) -> bytes:
        with self._lock:
            v = max(now_nanos, self._last + 1)
            self._last = v
            return versionstamp(v)


class SystemClock:
    def now_nanos(self) -> int:
        import time

        return time.time_ns()


class FakeClock:
    """Deterministic clock for tests (reference kvs/clock.rs SizedClock role)."""

    def __init__(self, start: int = 0, tick: int = 1):
        self.t = start
        self.tick = tick

    def now_nanos(self) -> int:
        self.t += self.tick
        return self.t
