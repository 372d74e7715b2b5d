"""Device-tier backends and scoring weights.

Copy of the reference package's `kvcache/backend.py`: a block resident in
device memory is worth full weight, a block offloaded to host memory is
discounted. Port pods advertise "gpu"/"cpu"; the "hbm"/"host" names of the
TPU fleet keep their weights so mixed fleets score the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List


@dataclass
class KVCacheBackendConfig:
    name: str
    weight: float


DEFAULT_TIER_HBM = "hbm"
DEFAULT_TIER_HOST = "host"


def default_kv_cache_backend_configs() -> List[KVCacheBackendConfig]:
    return [
        KVCacheBackendConfig(name=DEFAULT_TIER_HBM, weight=1.0),
        KVCacheBackendConfig(name=DEFAULT_TIER_HOST, weight=0.8),
        KVCacheBackendConfig(name="gpu", weight=1.0),
        KVCacheBackendConfig(name="cpu", weight=0.8),
    ]


def weight_map(configs: List[KVCacheBackendConfig]) -> Dict[str, float]:
    return {c.name: c.weight for c in configs}
