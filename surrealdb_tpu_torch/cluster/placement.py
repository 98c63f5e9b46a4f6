"""Consistent-hash record placement over one membership VERSION.

Every record id maps to a point on a hash ring; the first node vnode
clockwise owns it. Hashes are blake2b (process-stable — Python's builtin
hash() is salted per process and would scatter the same record to different
owners on different nodes). With `vnodes` virtual nodes per member the load
skew across nodes concentrates to a few percent, and adding a member moves
only ~1/N of the keyspace (the property the name promises) — exactly the
slice elastic membership (cluster/membership.py) streams on a join/leave.
Each HashRing instance is IMMUTABLE; membership changes swap whole rings
under a new epoch.

Placement is by RECORD, not by table: every node owns a slice of every
table, so scans/kNN/BM25 scatter to all members while id-addressed writes
route to exactly one.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Any, Dict, List


def _h64(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


def placement_key(tb: str, rid: Any) -> bytes:
    """Stable placement identity of one record. repr() of the id matches
    the engine's record-identity convention (_rid_key in idx/knn.py)."""
    return f"{tb}\x00{rid!r}".encode("utf-8", "surrogatepass")


class HashRing:
    def __init__(self, node_ids: List[str], vnodes: int = 64):
        if not node_ids:
            raise ValueError("hash ring needs at least one node")
        self.node_ids = list(node_ids)
        self.vnodes = max(int(vnodes), 1)
        points: List[int] = []
        owners: Dict[int, str] = {}
        for nid in node_ids:
            for v in range(self.vnodes):
                p = _h64(f"{nid}\x00{v}".encode())
                # deterministic collision break: lowest node id wins
                if p in owners and owners[p] <= nid:
                    continue
                owners[p] = nid
                points.append(p)
        self._points = sorted(set(points))
        self._owners = owners

    def owner_of(self, tb: str, rid: Any) -> str:
        """The node owning record `tb:rid`."""
        return self.owner_of_key(placement_key(tb, rid))

    def owner_of_key(self, key: bytes) -> str:
        h = _h64(key)
        i = bisect.bisect_right(self._points, h)
        if i == len(self._points):
            i = 0  # wrap
        return self._owners[self._points[i]]

    def owners_of(self, tb: str, rid: Any, rf: int) -> List[str]:
        """The record's replica set: primary + the next rf-1 DISTINCT nodes
        clockwise from its ring position (replication walks the same ring
        as placement, so membership changes move replicas the same ~1/N a
        consistent hash promises)."""
        return self.owners_of_key(placement_key(tb, rid), rf)

    def owners_of_key(self, key: bytes, rf: int) -> List[str]:
        rf = max(min(int(rf), len(self.node_ids)), 1)
        h = _h64(key)
        i = bisect.bisect_right(self._points, h)
        out: List[str] = []
        for step in range(len(self._points)):
            p = self._points[(i + step) % len(self._points)]
            nid = self._owners[p]
            if nid not in out:
                out.append(nid)
                if len(out) == rf:
                    break
        return out

    # ------------------------------------------------------------ hash ranges
    # Anti-entropy + migration address the keyspace by RING RANGE: every
    # ring point i owns the arc ending at it, so `range index == point
    # index` is a partition of the hash space both sides of a replica pair
    # derive identically from the same ring (no Merkle tree to ship — the
    # per-range digests ARE the tree's leaf level).
    def n_ranges(self) -> int:
        return len(self._points)

    def range_of_key(self, key: bytes) -> int:
        """The ring-range index (== owning point index) of a placement key."""
        return self.range_of_hash(_h64(key))

    def range_of_hash(self, h: int) -> int:
        i = bisect.bisect_right(self._points, h)
        return 0 if i == len(self._points) else i

    def range_owners(self, idx: int, rf: int) -> List[str]:
        """The replica set of every record hashing into range `idx`: the
        same rf-distinct-successors walk owners_of_key takes, started at
        the range's owning point."""
        rf = max(min(int(rf), len(self.node_ids)), 1)
        out: List[str] = []
        for step in range(len(self._points)):
            p = self._points[(idx + step) % len(self._points)]
            nid = self._owners[p]
            if nid not in out:
                out.append(nid)
                if len(out) == rf:
                    break
        return out

    def spread(self, keys) -> Dict[str, int]:
        """{node: owned count} over an iterable of placement keys (tests /
        INFO surface)."""
        out = {nid: 0 for nid in self.node_ids}
        for k in keys:
            out[self.owner_of_key(k)] += 1
        return out
