"""Hierarchical federation: a global region tier above `cluster/`.

Copy of the reference package's `federation/__init__.py`.

Two-level index for deployments that span regions: region-local PRECISE
indexers (the existing replicated control plane) under a compact global
layer holding only popularity sketches and hot-chain digests per region.

- `region`   — `FederationConfig` + the `Region` handle (a precise fleet
               front + its digest/warm seams, as the global tier sees it).
- `digest`   — `RegionDigest`: versioned canonical-CBOR shipping of the
               count-min sketch + top-K hot chains (utils/cbor.py codec,
               the same one the cluster snapshot rides).
- `router`   — `GlobalRouter`: approximate-affinity region pick, precise
               delegation, cross-region hot-chain admission; a
               single-region federation is pinned bit-identical to the
               flat fleet.
- `failover` — digest staleness → fleethealth-style suspect/stale
               demotion → deterministic rendezvous failover.
"""

from llm_d_kv_cache_manager_tpu_torch.federation.digest import (  # noqa: F401
    DIGEST_MAGIC,
    DIGEST_VERSION,
    DigestFormatError,
    HotChainDigest,
    RegionDigest,
    build_digest,
    decode_digest,
    encode_digest,
)
from llm_d_kv_cache_manager_tpu_torch.federation.failover import (  # noqa: F401
    RegionFailoverTracker,
)
from llm_d_kv_cache_manager_tpu_torch.federation.region import (  # noqa: F401
    FederationConfig,
    Region,
)
from llm_d_kv_cache_manager_tpu_torch.federation.router import (  # noqa: F401
    GlobalRouter,
    GlobalScore,
    derive_fn_from_indexer,
)

__all__ = [
    "DIGEST_MAGIC",
    "DIGEST_VERSION",
    "DigestFormatError",
    "FederationConfig",
    "GlobalRouter",
    "GlobalScore",
    "HotChainDigest",
    "Region",
    "RegionDigest",
    "RegionFailoverTracker",
    "build_digest",
    "decode_digest",
    "derive_fn_from_indexer",
    "encode_digest",
]
