"""Event-stream partitioning for the replicated indexer control plane.

Copy of the reference package's `cluster/partition.py`.

N indexer replicas act as one logical index by splitting the fleet's event
streams, not by mirroring them: each (pod, dp_rank) topic is owned by
exactly one replica, chosen by the same FNV-1a striping the rest of the
stack already uses (`fnv32a(pod) % S` shards messages inside one pool,
`chunk_hash % S` stripes `ShardedIndex` segments). Striping by the BARE
pod identity (DP-rank suffix stripped) keeps every rank of a pod — and
therefore every index entry the event pool writes for it — inside one
replica, which is what makes the scatter-gather merge rule exact: a pod's
score is a function of that pod's entries only (`LongestPrefixScorer`
accumulates per pod independently), so the replica owning the pod's stream
computes the same score the monolithic indexer would, and the cluster
answer is the union of per-partition answers.

The partitioner is deterministic and stateless — every replica, router,
and bench computes the same map from (num_replicas, pod) with no
coordination service. Reassignment is a config change (new num_replicas /
replica_id) applied through `ZMQSubscriber.resubscribe` plus the event
pool's ownership gate; no process restart.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.hashing import fnv32a
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import base_pod_identifier


@dataclass
class ClusterConfig:
    """Shape of one replica's membership in the logical index.

    Env mapping (api/http_service.py): CLUSTER_REPLICAS, CLUSTER_REPLICA_ID,
    CLUSTER_GRPC_TARGETS (comma-separated), CLUSTER_SNAPSHOT_PATH.
    """

    num_replicas: int = 1
    replica_id: int = 0
    # Peer scoring endpoints for the gRPC scatter-gather transport, indexed
    # by replica id. Empty = local-only (tests, single-process clusters).
    grpc_targets: List[str] = field(default_factory=list)
    # Where this replica writes/loads its warm-restart snapshot. Empty
    # disables the snapshot endpoints.
    snapshot_path: str = ""
    # Scatter-gather fan-out deadline per replica. A replica that cannot
    # answer inside it contributes no cache signal for its partition —
    # degraded routing, never a stalled request.
    scatter_timeout_s: float = 1.0
    # Replica-liveness windows (reuses the fleethealth state machine with
    # replica ids in place of pods): a replica with no successful scatter
    # response for suspect_after_s is still tried; past stale_after_s the
    # fan-out skips it entirely until it answers a probe again.
    replica_suspect_after_s: float = 10.0
    replica_stale_after_s: float = 30.0

    def __post_init__(self):
        if self.num_replicas <= 0:
            raise ValueError(
                f"num_replicas must be positive, got {self.num_replicas}"
            )
        if not 0 <= self.replica_id < self.num_replicas:
            raise ValueError(
                f"replica_id {self.replica_id} outside [0, {self.num_replicas})"
            )


class ReplicaPartitioner:
    """Deterministic (pod, dp_rank)-topic → replica assignment."""

    def __init__(self, num_replicas: int, replica_id: int = 0):
        if num_replicas <= 0:
            raise ValueError(f"num_replicas must be positive, got {num_replicas}")
        if not 0 <= replica_id < num_replicas:
            raise ValueError(
                f"replica_id {replica_id} outside [0, {num_replicas})"
            )
        self.num_replicas = num_replicas
        self.replica_id = replica_id

    def replica_for(self, pod_identifier: str) -> int:
        """Owning replica of a pod's event topics — FNV-1a over the BARE
        pod identity, so "pod@dp3" lands with "pod"."""
        base = base_pod_identifier(pod_identifier)
        return fnv32a(base.encode("utf-8")) % self.num_replicas

    def owns(self, pod_identifier: str) -> bool:
        return self.replica_for(pod_identifier) == self.replica_id

    def accepts(self, msg) -> bool:
        """`EventPool.message_filter` form: True when this replica owns the
        message's pod stream."""
        return self.owns(msg.pod_identifier)

    def topic_filters(self, pod_identifiers: Sequence[str]) -> List[str]:
        """ZMQ SUB prefix filters for the owned slice of a known pod list:
        one "kv@<pod-id>@" per owned pod, sorted for determinism. ZMQ
        filters are prefix matches, so hash ownership cannot be expressed
        directly — enumerate the fleet instead, and fall back to the
        broad "kv@" filter (plus the authoritative `accepts` gate) while
        the fleet is still being discovered."""
        owned = sorted(
            base_pod_identifier(p)
            for p in pod_identifiers
            if self.owns(p)
        )
        return [f"kv@{pod}@" for pod in dict.fromkeys(owned)]

    def partition_map(self, pod_identifiers: Sequence[str]) -> Dict[int, List[str]]:
        """{replica_id: sorted owned pods} over a pod list (status surfaces
        and the docs' partition-map illustration)."""
        out: Dict[int, List[str]] = {r: [] for r in range(self.num_replicas)}
        for pod in sorted(set(base_pod_identifier(p) for p in pod_identifiers)):
            out[self.replica_for(pod)].append(pod)
        return out

    def as_dict(self) -> dict:
        return {
            "num_replicas": self.num_replicas,
            "replica_id": self.replica_id,
        }
