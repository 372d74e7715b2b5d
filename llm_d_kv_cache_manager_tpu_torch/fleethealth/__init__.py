from llm_d_kv_cache_manager_tpu_torch.fleethealth.faults import (
    FaultInjector,
    FaultPlan,
    PodFaults,
)
from llm_d_kv_cache_manager_tpu_torch.fleethealth.load import (
    PodLoad,
    PodLoadConfig,
    PodLoadTracker,
)
from llm_d_kv_cache_manager_tpu_torch.fleethealth.tracker import (
    HEALTHY,
    STALE,
    SUSPECT,
    FleetHealthConfig,
    FleetHealthTracker,
)

__all__ = [
    "FaultInjector",
    "FaultPlan",
    "FleetHealthConfig",
    "FleetHealthTracker",
    "HEALTHY",
    "PodFaults",
    "PodLoad",
    "PodLoadConfig",
    "PodLoadTracker",
    "STALE",
    "SUSPECT",
]
