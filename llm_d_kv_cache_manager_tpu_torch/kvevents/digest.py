"""Synchronous event digestion into a KV-block index.

`digest_batch` applies one EventBatch in the calling thread through the
event pool's own digest (`digest_events`, kvevents/pool.py):
BlockStored -> index.add with request keys recomputed from the event's
token IDs, BlockRemoved -> index.evict, AllBlocksCleared -> no-op. It is
for in-process callers that hold event objects rather than wire bytes;
the pool module holds the one copy of the digestion logic.
"""

from __future__ import annotations

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    ChunkedTokenDatabase,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.events import EventBatch
from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import (
    DEFAULT_DEVICE_TIER,
    digest_events,
)

__all__ = ["DEFAULT_DEVICE_TIER", "digest_batch"]


def digest_batch(
    index: Index,
    token_processor: ChunkedTokenDatabase,
    pod_identifier: str,
    model_name: str,
    batch: EventBatch,
) -> None:
    """Digest every event of one batch, in order."""
    digest_events(index, token_processor, pod_identifier, model_name, batch)
