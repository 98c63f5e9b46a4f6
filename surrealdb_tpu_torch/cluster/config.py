"""Boot-time cluster membership config (epoch 1).

The reference derives membership from the distributed KV store's node table
(kvs/node.rs heartbeats); this reproduction boots each node from a topology
file — deterministic and testable without a consensus layer — and evolves
membership at runtime through epoch-versioned join/leave/replace
(cluster/membership.py):

    {
      "nodes": [
        {"id": "n1", "url": "http://127.0.0.1:8101"},
        {"id": "n2", "url": "http://127.0.0.1:8102"}
      ],
      "self": "n1",
      "vnodes": 64,
      "secret": "shared-internal-secret"
    }

`secret` authenticates the internal `/cluster` channel — but it is NEVER
sent on the wire. Each request carries a per-node derived key
(`derive_node_key`: HMAC-SHA256 over `node_id:epoch` keyed by the secret)
plus the `x-surreal-cluster-node`/`x-surreal-cluster-epoch` inputs it was
derived from; the receiver recomputes and constant-time-compares. A
captured header therefore exposes one node's one-epoch credential, not the
cluster-wide secret a bare-secret header used to hand to any on-path
observer, and rotation is as cheap as an epoch bump. Operator/user auth
still applies at the public ingress of whichever node coordinates.
"""

from __future__ import annotations

import hashlib
import hmac
import json
from typing import Any, Dict, List, Optional


def derive_node_key(secret: str, node_id: str, epoch: Any) -> str:
    """The per-node `/cluster` channel credential: HMAC-SHA256 keyed by the
    shared secret over `"{node_id}:{epoch}"`, hex-encoded. Sender and
    receiver both derive it; the shared secret itself stays off the wire."""
    msg = f"{node_id}:{epoch}".encode()
    return hmac.new(secret.encode(), msg, hashlib.sha256).hexdigest()


class ClusterConfigError(ValueError):
    pass


class ClusterConfig:
    __slots__ = ("nodes", "node_id", "vnodes", "secret")

    def __init__(
        self,
        nodes: List[Dict[str, str]],
        node_id: str,
        vnodes: int = 64,
        secret: Optional[str] = None,
    ):
        if not nodes:
            raise ClusterConfigError("cluster config needs at least one node")
        ids = [str(n.get("id", "")) for n in nodes]
        if len(set(ids)) != len(ids) or not all(ids):
            raise ClusterConfigError("cluster node ids must be unique and non-empty")
        for n in nodes:
            if not str(n.get("url", "")).startswith(("http://", "https://")):
                raise ClusterConfigError(
                    f"node {n.get('id')!r}: url must be http(s)://host:port"
                )
        if node_id not in ids:
            raise ClusterConfigError(
                f"self node {node_id!r} is not in the membership list {ids}"
            )
        if len(nodes) > 1 and not secret:
            # the /cluster channel executes ops with SYSTEM privileges and
            # the shared secret is its only gate — an unauthenticated
            # multi-node channel would hand owner-level SurrealQL to
            # anyone with network reach
            raise ClusterConfigError(
                "cluster config requires a non-empty shared 'secret' "
                "(the internal /cluster channel runs with system privileges)"
            )
        self.nodes = [dict(id=str(n["id"]), url=str(n["url"]).rstrip("/")) for n in nodes]
        self.node_id = node_id
        self.vnodes = max(int(vnodes), 1)
        self.secret = secret

    def url_of(self, node_id: str) -> str:
        for n in self.nodes:
            if n["id"] == node_id:
                return n["url"]
        raise ClusterConfigError(f"unknown cluster node {node_id!r}")

    def peer_ids(self) -> List[str]:
        return [n["id"] for n in self.nodes if n["id"] != self.node_id]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "nodes": list(self.nodes),
            "self": self.node_id,
            "vnodes": self.vnodes,
            "secret": self.secret,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any], node_id: Optional[str] = None) -> "ClusterConfig":
        if not isinstance(d, dict):
            raise ClusterConfigError("cluster config must be a JSON object")
        return ClusterConfig(
            d.get("nodes") or [],
            node_id or d.get("self") or "",
            vnodes=d.get("vnodes", 64),
            secret=d.get("secret"),
        )


def load_config(path: str, node_id: Optional[str] = None) -> ClusterConfig:
    """Load a topology file; `node_id` overrides the file's "self" (so one
    file can be shipped to every node of the cluster)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ClusterConfigError(f"unreadable cluster config {path!r}: {e}") from e
    return ClusterConfig.from_dict(doc, node_id)
