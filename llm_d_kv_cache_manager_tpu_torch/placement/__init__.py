"""Predictive placement: hot-prefix detection + proactive K-way replication.

The reference index is purely reactive — a KV block lives wherever traffic
happened to land it. This package closes the loop: the popularity tracker
(fed from the read path, the kvevents write plane, and the instrumented
index) detects hot chains under decay; the replicator proactively pushes
their prefixes to K healthy, spread-out pods through the existing
route-prefetch/transfer plane; and the cost-aware index backend weighs the
same popularity signal against measured re-derivation/transfer cost at
eviction time, so replicated hot prefixes are sticky and cold long-tail
chains drain first. Disabled (the default), every hook is `None` and the
read path is bit-identical to the reactive build.
"""

from llm_d_kv_cache_manager_tpu_torch.placement.popularity import (
    ChainPopularityTracker,
    ChainStat,
    DecayedCountMinSketch,
    PopularityConfig,
)
from llm_d_kv_cache_manager_tpu_torch.placement.replicator import (
    HotPrefixReplicator,
    ReplicationConfig,
)

__all__ = [
    "ChainPopularityTracker",
    "ChainStat",
    "DecayedCountMinSketch",
    "HotPrefixReplicator",
    "PopularityConfig",
    "ReplicationConfig",
]
