"""Result-merge helpers for the distributed executor.

The guiding invariant: a merged cluster result must be byte-identical to
the single-node result over the same data. Scans therefore re-sort gathered
rows into KEY ORDER (the order a single node's table scan yields), kNN
merges per-shard top-k by distance, and BM25 merges globally-scored rows by
descending score — id-keyed tie-breaks keep every merge deterministic.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from surrealdb_tpu_torch.key.encode import enc_value_key
from surrealdb_tpu_torch.sql.value import Thing


def id_sort_key(row: Any) -> bytes:
    """The storage-order sort key of one gathered row (rows carry `id`
    because the scatter projection is always `*`-based). Rows without a
    usable id sort after everything, stably."""
    if isinstance(row, dict):
        rid = row.get("id")
        if isinstance(rid, Thing):
            try:
                return b"\x00" + enc_value_key(rid.id)
            except Exception:  # noqa: BLE001 — unencodable ids keep repr order
                return b"\x01" + repr(rid).encode()
        if rid is not None:
            try:
                return b"\x00" + enc_value_key(rid)
            except Exception:  # noqa: BLE001
                return b"\x01" + repr(rid).encode()
    return b"\x02" + repr(row).encode()[:64]


def table_rank(row: Any, ranks: Dict[str, int]) -> int:
    """FROM-position of the row's table (multi-source SELECTs yield source
    by source on a single node)."""
    if isinstance(row, dict) and isinstance(row.get("id"), Thing):
        return ranks.get(row["id"].tb, len(ranks))
    return len(ranks)


def sort_rows_scan_order(rows: List[Any], from_tables: List[str]) -> List[Any]:
    """Gathered scan rows -> single-node iteration order: FROM-source rank,
    then key order within the source."""
    ranks = {tb: i for i, tb in enumerate(from_tables)}
    return sorted(rows, key=lambda r: (table_rank(r, ranks), id_sort_key(r)))


def sort_rows_scan_order_by(
    rows: List[Any], key_field: str, from_tables: List[str]
) -> List[Any]:
    """sort_rows_scan_order for PROJECTED rows that carry their record id
    in a carrier field (`__cluster_rid`) instead of `id` — the colocated
    scatter under replication."""
    ranks = {tb: i for i, tb in enumerate(from_tables)}

    def shim(r):
        rid = r.get(key_field) if isinstance(r, dict) else None
        return {"id": rid} if rid is not None else r

    return sorted(
        rows, key=lambda r: (table_rank(shim(r), ranks), id_sort_key(shim(r)))
    )


def merge_hop_lists(lists: List[list]) -> list:
    """Merge one frontier id's per-node expansion lists by MAX MULTIPLICITY:
    a value appears as often as the single node that reported it most. A
    pointer key replicated on RF nodes therefore counts ONCE (each replica
    reports it once), while distinct edges held by different nodes all
    survive (each is the sole reporter of its own value), and a legitimate
    within-node duplicate (a self-loop's `<->` endpoints) is preserved.
    Deterministic: callers pass lists in sorted node order."""
    from collections import Counter

    if len(lists) == 1:
        return list(lists[0])
    need: Counter = Counter()
    for lst in lists:
        c = Counter(repr(v) for v in lst)
        for k, n in c.items():
            if n > need[k]:
                need[k] = n
    out: list = []
    got: Counter = Counter()
    for lst in lists:
        for v in lst:
            k = repr(v)
            if got[k] < need[k]:
                got[k] += 1
                out.append(v)
    return out


def merge_topk(rows: List[dict], k: int, dist_field: str) -> List[dict]:
    """Per-shard kNN candidates -> global top-k by ascending distance
    (id-keyed tie-break). Rows missing the distance sort last."""

    def key(r):
        d = r.get(dist_field) if isinstance(r, dict) else None
        return (
            (0, float(d)) if isinstance(d, (int, float)) else (1, 0.0),
            id_sort_key(r),
        )

    return sorted(rows, key=key)[: max(k, 0)]


def sort_by_score(rows: List[dict], score_field: str) -> List[dict]:
    """Globally-scored BM25 rows -> descending score (the order a single
    node's MATCHES iterator yields), id-keyed tie-break."""

    def key(r):
        s = r.get(score_field) if isinstance(r, dict) else None
        return (
            (0, -float(s)) if isinstance(s, (int, float)) else (1, 0.0),
            id_sort_key(r),
        )

    return sorted(rows, key=key)


def merge_ft_stats(per_node: List[dict]) -> Optional[dict]:
    """Per-node corpus stats -> the global stats every shard scores with.
    None when NO node has the index (caller falls back). A term absent
    everywhere leaves df 0 — the match set is globally empty."""
    present = [s for s in per_node if s and not s.get("missing")]
    if not present:
        return None
    df: Dict[str, float] = {}
    dc = 0.0
    tl = 0.0
    for s in present:
        dc += float(s.get("dc") or 0)
        tl += float(s.get("tl") or 0.0)
        for term, n in (s.get("df") or {}).items():
            df[term] = df.get(term, 0.0) + float(n)
    return {"dc": dc, "tl": tl, "df": df, "terms": present[0].get("terms") or []}


def strip_cluster_fields(result: Any) -> Any:
    """Remove the executor's internal carrier fields (__cluster_dist /
    __cluster_score) from response rows before they reach the client."""
    if isinstance(result, list):
        for row in result:
            if isinstance(row, dict):
                for k in [k for k in row if isinstance(k, str) and k.startswith("__cluster_")]:
                    del row[k]
    elif isinstance(result, dict):
        for k in [k for k in result if isinstance(k, str) and k.startswith("__cluster_")]:
            del result[k]
    return result
