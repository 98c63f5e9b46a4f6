"""Cluster mode: multi-node sharded serving with a scatter/gather executor.

Role of the reference's distributed deployment (reference: the engine runs
over TiKV/FoundationDB with a node-task runtime, engine/tasks.rs + kvs/ds.rs
node membership): N server processes each own a deterministic subset of every
table's records (consistent-hash placement over a static membership config,
cluster/placement.py), and any node can coordinate a query — the distributed
executor (cluster/executor.py) scatters work to shard owners over the
internal CBOR RPC channel (cluster/client.py + the `/cluster` route in
net/server.py) and merges the results:

- table scans gather row batches and re-apply ORDER/GROUP/LIMIT locally;
- kNN probes merge per-shard top-k by distance;
- BM25 runs two-phase (global corpus stats, then globally-scored postings);
- graph expansion exchanges frontier sets per hop.

Inter-node requests carry the coordinator's `traceparent`, and each
response ships the spans the remote recorded — the coordinator grafts them
into its own trace (tracing.graft_spans), so ONE trace tree spans nodes.

`attach(ds, config)` wires a Datastore into a cluster: its `execute()` then
routes through the ClusterExecutor, while `/cluster` RPC requests and the
executor's own sub-queries run `execute_local()` against the node's shard.
"""

from __future__ import annotations

from .config import ClusterConfig, load_config
from .placement import HashRing

__all__ = ["ClusterConfig", "load_config", "HashRing", "attach", "detach"]


def attach(ds, config: ClusterConfig):
    """Wire a Datastore into a cluster: versioned membership (epoch 1 from
    the config), RPC client pool (+ health-probe service pumps), the
    scatter/gather executor, and — when CLUSTER_ANTIENTROPY_INTERVAL is
    set — the supervised anti-entropy sweep service. Returns the
    ClusterNode handle (also stored as ds.cluster)."""
    from surrealdb_tpu_torch import telemetry

    from .client import ClusterClient
    from .executor import ClusterExecutor

    node = ClusterNode(ds, config)
    node.client = ClusterClient(config, owner=id(ds))
    node.client.epoch_provider = lambda: node.membership.epoch
    node.executor = ClusterExecutor(ds, node)
    ds.cluster = node
    node.client.start_probes()
    telemetry.gauge_set("cluster_membership_epoch", float(node.membership.epoch))
    from . import repair as _repair

    _repair.start_service(ds)
    _repair.start_tombstone_gc(ds)
    return node


def detach(ds) -> None:
    """Tear a node out of its cluster (tests): stop probe pumps, release
    the scatter pool, restore single-node execution. The anti-entropy
    sweep loop notices ds.cluster changed and retires on its next beat."""
    node = getattr(ds, "cluster", None)
    if node is None:
        return
    ds.cluster = None
    if node.client is not None:
        node.client.shutdown()
    if node.executor is not None:
        node.executor.shutdown()


class ClusterNode:
    """One process's view of the cluster: its identity, the VERSIONED
    membership (epoch + active/next rings — cluster/membership.py), the
    RPC client pool, and the coordinating executor."""

    def __init__(self, ds, config: ClusterConfig):
        from .membership import Membership, MigrationState

        self.ds = ds
        self.config = config
        self.membership = Membership(config.nodes, vnodes=config.vnodes)
        self.migration = MigrationState()
        self.client = None  # ClusterClient (attach() fills)
        self.executor = None  # ClusterExecutor (attach() fills)

    @property
    def node_id(self) -> str:
        return self.config.node_id

    @property
    def ring(self) -> HashRing:
        """The ACTIVE placement ring (next ring only serves dual-writes
        until the cutover — membership.replicas_of_key)."""
        return self.membership.ring()

    def members(self):
        """Active ∪ next membership node dicts (the statement fan-out set)."""
        return self.membership.all_nodes()

    def member_ids(self):
        return self.membership.member_ids()
