"""Anticipatory prefetch: pre-land a session's next turn before it arrives.

- sessions.py: bounded session table learning per-session next-turn ETAs
  (EWMA blended with a fleet-level quantile prior) and continuation
  prefixes from the read path's chain observations.
- scheduler.py: budget-bounded prefetch loop resolving the target pod via
  the REAL routing decision and riding the existing prefetch/warm_chain
  admission seams — serving always wins.
"""

from llm_d_kv_cache_manager_tpu_torch.prediction.scheduler import (
    PrefetchScheduler,
    SchedulerConfig,
    best_score_select,
)
from llm_d_kv_cache_manager_tpu_torch.prediction.sessions import (
    PendingPrefetch,
    PredictionConfig,
    SessionRecord,
    SessionTable,
    fleet_prior_from_tables,
)

__all__ = [
    "PendingPrefetch",
    "PredictionConfig",
    "PrefetchScheduler",
    "SchedulerConfig",
    "SessionRecord",
    "SessionTable",
    "best_score_select",
    "fleet_prior_from_tables",
]
