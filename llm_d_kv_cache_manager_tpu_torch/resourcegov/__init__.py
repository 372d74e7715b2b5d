"""Resource governor: fleet-wide memory accounting, pressure-tiered
shedding, and departed-entity reaping.

Three planes, all clock-injected and thread-free:

- **accounting** (`ResourceAccountant` / `Meter`): every stateful
  structure registers an entry count, a bytes estimate, and — for the
  sheddable ones — a `shed(fraction)` hook.
- **pressure** (`ResourceGovernor`): ok -> elevated -> critical over a
  configured byte budget, actuating the `SHED_LADDER` in priority
  order (obs first, the index last and only at critical) with per-rung
  cooldowns, a bounded journal, and hysteresis back to baseline.
- **reaping** (`DepartureReaper`): membership-leave / fleet-health
  stale transitions fan out to per-pod forget hooks, so per-pod maps
  track live pods instead of every pod ever seen — active even with
  the governor disabled.
"""

from llm_d_kv_cache_manager_tpu_torch.resourcegov.accountant import (
    Meter,
    RESOURCE_STRUCTURES,
    ResourceAccountant,
    STRUCT_ANTIENTROPY,
    STRUCT_CHAIN_MEMO,
    STRUCT_FLEETHEALTH,
    STRUCT_INDEX,
    STRUCT_LOAD,
    STRUCT_NEGATIVE_CACHE,
    STRUCT_OBS,
    STRUCT_POPULARITY,
    STRUCT_PREFIX_STORE,
    STRUCT_SESSIONS,
    STRUCT_TRANSFER_PEERS,
    shed_lru_oldest,
)
from llm_d_kv_cache_manager_tpu_torch.resourcegov.governor import (
    LEVEL_CRITICAL,
    LEVEL_ELEVATED,
    LEVEL_OK,
    RESOURCE_LEVELS,
    ResourceGovConfig,
    ResourceGovernor,
    SHED_LADDER,
    ShedRung,
    read_rss_bytes,
)
from llm_d_kv_cache_manager_tpu_torch.resourcegov.reaper import DepartureReaper

__all__ = [
    "DepartureReaper",
    "LEVEL_CRITICAL",
    "LEVEL_ELEVATED",
    "LEVEL_OK",
    "Meter",
    "RESOURCE_LEVELS",
    "RESOURCE_STRUCTURES",
    "ResourceAccountant",
    "ResourceGovConfig",
    "ResourceGovernor",
    "SHED_LADDER",
    "STRUCT_ANTIENTROPY",
    "STRUCT_CHAIN_MEMO",
    "STRUCT_FLEETHEALTH",
    "STRUCT_INDEX",
    "STRUCT_LOAD",
    "STRUCT_NEGATIVE_CACHE",
    "STRUCT_OBS",
    "STRUCT_POPULARITY",
    "STRUCT_PREFIX_STORE",
    "STRUCT_SESSIONS",
    "STRUCT_TRANSFER_PEERS",
    "ShedRung",
    "read_rss_bytes",
    "shed_lru_oldest",
]
