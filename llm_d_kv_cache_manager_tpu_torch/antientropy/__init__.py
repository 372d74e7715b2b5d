"""Index anti-entropy: detect and repair silent index-vs-reality drift.

Three reinforcing mechanisms close the loop the best-effort KVEvents
write path leaves open (a pod that evicts without its BlockRemoved
landing, or advertises blocks it never holds, diverges silently while
its stream looks healthy):

- `FetchMissFeedback` — the data plane's per-block "missing" answers
  purge the exact phantom placements they disprove (chain-suffix
  extended), through the targeted `Index.remove_entries`.
- `ResidencyAuditor` — sampled, clock-driven challenges of each pod's
  advertised entries against its resident-set digest; repairs both
  phantom entries (purge) and unknown-resident blocks (re-admit).
- `AntiEntropyTracker` — per-pod advertised-vs-verified accuracy EWMA
  feeding a truth-weighted score demotion on the Indexer's
  fleet-health filter path, with recovery as audits come back clean.
"""

from llm_d_kv_cache_manager_tpu_torch.antientropy.auditor import (
    AuditorConfig,
    ResidencyAuditor,
)
from llm_d_kv_cache_manager_tpu_torch.antientropy.feedback import FetchMissFeedback
from llm_d_kv_cache_manager_tpu_torch.antientropy.tracker import (
    DIVERGENCE_SOURCES,
    AntiEntropyConfig,
    AntiEntropyTracker,
)

__all__ = [
    "AntiEntropyConfig",
    "AntiEntropyTracker",
    "AuditorConfig",
    "DIVERGENCE_SOURCES",
    "FetchMissFeedback",
    "ResidencyAuditor",
]
