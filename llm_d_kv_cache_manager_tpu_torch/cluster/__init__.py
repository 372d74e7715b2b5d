"""cluster: the replicated indexer control plane.

Copy of the reference package's `cluster/__init__.py`, less the gRPC
replica transport (ROADMAP.md queue 1 item 7).

N indexer replicas running as one logical index — the first step from "a
library with benches" to a control plane that survives its own restarts
(ROADMAP "Scale out the indexer itself"). Three pillars:

- **Stream partitioning** (`partition.py`): each (pod, dp_rank) event topic
  is owned by exactly one replica via the same FNV striping `ShardedIndex`
  and the kvevents pool use; `ZMQSubscriber` subscribes per-partition
  prefixes and swaps them live on reassignment (`resubscribe`).
- **Scatter-gather scoring** (`scorer.py`): `ClusterScorer` fans
  `get_pod_scores_ex` across replicas (local-call transport) and
  merges by partition ownership — bit-identical to a single replica when
  all partitions answer, degraded (missing partition = no cache signal for
  its pods) when one is down.
- **Snapshot / warm restart** (`snapshot.py`, `replica.py`): the published
  read view of any index backend serializes to a versioned canonical-CBOR
  file together with the per-(pod, topic) seq watermarks fleethealth
  tracks; a restarted replica imports the view, replays only the seq tail
  (idempotently — floors drop already-applied events), and is warm in
  seconds, reporting `replaying` to /readyz until it is.
"""

from llm_d_kv_cache_manager_tpu_torch.cluster.partition import (  # noqa: F401
    ClusterConfig,
    ReplicaPartitioner,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.replica import (  # noqa: F401
    READY,
    REPLAYING,
    IndexerReplica,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.membership import (  # noqa: F401
    DRAINING,
    JOINING,
    LEFT,
    REASSIGNING,
    SERVING,
    WARMING,
    FleetMembership,
    MembershipConfig,
    PartitionTable,
    ReplicaBinding,
    export_pod_view,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.scorer import (  # noqa: F401
    ClusterScorer,
    LocalReplicaTransport,
    ReplicaUnavailable,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.snapshot import (  # noqa: F401
    SNAPSHOT_VERSION,
    Snapshot,
    SnapshotFormatError,
    read_snapshot,
    restore_index,
    seq_counters_from_tracker,
    write_snapshot,
)

__all__ = [
    "ClusterConfig",
    "ClusterScorer",
    "DRAINING",
    "FleetMembership",
    "IndexerReplica",
    "JOINING",
    "LEFT",
    "LocalReplicaTransport",
    "MembershipConfig",
    "PartitionTable",
    "READY",
    "REASSIGNING",
    "REPLAYING",
    "ReplicaBinding",
    "ReplicaPartitioner",
    "ReplicaUnavailable",
    "SERVING",
    "WARMING",
    "export_pod_view",
    "SNAPSHOT_VERSION",
    "Snapshot",
    "SnapshotFormatError",
    "read_snapshot",
    "restore_index",
    "seq_counters_from_tracker",
    "write_snapshot",
]
