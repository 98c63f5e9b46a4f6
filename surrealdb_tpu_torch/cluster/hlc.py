"""Hybrid logical clock: the per-record last-writer-wins version authority.

Role of the versioning layer under Dynamo-style convergent replication
(reference: the engine's distributed KV backends resolve concurrent writes
with commit timestamps; Cassandra/Riak ship the same recipe as LWW cells):
every record write in cluster mode is stamped with a hybrid logical
timestamp — `(physical_ms, logical, node_id)` — and two divergent copies of
a record converge by keeping the copy with the LARGER stamp. An HLC is a
physical clock that never runs backwards and never ties: the logical
counter bumps when the wall clock stalls or regresses, remote stamps
observed during repair/migration advance the local clock past them
(Lamport's happened-before, grafted onto wall time), and the node id breaks
exact (ms, logical) collisions deterministically.

What LWW buys and what it costs (the README caveat): concurrent UPDATEs to
the SAME record on different replicas converge to ONE winner without a
consensus round — but the loser's write is silently discarded (a lost
update a serializable system would have ordered). That is the documented
trade for running the write path at replica speed; workloads needing
read-modify-write atomicity route through a single statement (the engine's
per-statement execution is atomic per node).

The clock is process-global (one physical clock per process) and guarded by
`cluster.hlc` in locks.HIERARCHY — a pure tuple update, safe under any
commit/write lock. Stamps serialize as plain lists `[ms, logical, node]` so
they ride msgpack record-meta values and CBOR repair payloads unchanged.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

from surrealdb_tpu_torch.utils import locks as _locks

# (physical_ms, logical, node_id)
Stamp = Tuple[int, int, str]

_lock = _locks.Lock("cluster.hlc")
_last_ms = 0
_last_lc = 0


def now(node_id: str) -> Stamp:
    """Mint the next stamp: physical wall-clock ms, monotonic across the
    process (a stalled/regressing wall clock bumps the logical counter
    instead of reusing or rewinding a stamp)."""
    global _last_ms, _last_lc
    pt = int(time.time() * 1000)
    with _lock:
        if pt > _last_ms:
            _last_ms, _last_lc = pt, 0
        else:
            _last_lc += 1
        return (_last_ms, _last_lc, str(node_id))


def observe(stamp: Optional[Stamp]) -> None:
    """Merge a REMOTE stamp into the clock (repair apply / migration
    ingest): later local writes provably win over everything this node has
    seen, even across clock skew between members."""
    global _last_ms, _last_lc
    if not stamp:
        return
    ms, lc = int(stamp[0]), int(stamp[1])
    with _lock:
        if ms > _last_ms or (ms == _last_ms and lc > _last_lc):
            _last_ms, _last_lc = ms, lc


def encode(stamp: Stamp) -> List[Any]:
    return [int(stamp[0]), int(stamp[1]), str(stamp[2])]


def decode(v: Any) -> Optional[Stamp]:
    """A stamp out of a packed/CBOR payload; None for anything malformed
    (repair treats an undecodable stamp exactly like a missing one)."""
    if (
        isinstance(v, (list, tuple))
        and len(v) == 3
        and isinstance(v[0], int)
        and isinstance(v[1], int)
    ):
        return (v[0], v[1], str(v[2]))
    return None


def wins(a: Optional[Stamp], b: Optional[Stamp]) -> bool:
    """True when stamp `a` beats stamp `b` under LWW. A present stamp
    always beats a missing one; two missing stamps never "win" (callers
    fall back to the ring-order write-reporter rule)."""
    if a is None:
        return False
    if b is None:
        return True
    return a > b
