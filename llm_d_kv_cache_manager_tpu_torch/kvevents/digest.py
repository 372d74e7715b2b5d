"""Synchronous event digestion into a KV-block index.

Port of the reference package's `EventPool._digest_block_stored` and
`_digest_block_removed` as plain functions (the sharded worker pool and the
ZMQ subscriber are not part of this port yet):

- BlockStored -> engine keys from the event's block hashes; request keys
  recomputed from the event's token IDs (continuing the parent chain when
  the parent's request key is known) -> index.add.
- BlockRemoved -> index.evict per engine key.
- AllBlocksCleared -> no-op (engines emit per-block removals too).
"""

from __future__ import annotations

from typing import List, Optional

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key, PodEntry
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    ChunkedTokenDatabase,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.events import (
    BlockRemoved,
    BlockStored,
    EventBatch,
    hash_as_uint64,
)
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("kvevents.digest")

DEFAULT_DEVICE_TIER = "gpu"  # tier for events that carry no medium


def digest_block_stored(
    index: Index,
    token_processor: ChunkedTokenDatabase,
    pod_identifier: str,
    model_name: str,
    ev: BlockStored,
) -> None:
    tier = (ev.medium or DEFAULT_DEVICE_TIER).lower()
    entries = [PodEntry(pod_identifier, tier)]

    engine_keys: List[Key] = []
    for raw in ev.block_hashes:
        try:
            engine_keys.append(Key(model_name, hash_as_uint64(raw)))
        except (TypeError, ValueError) as e:
            logger.debug("bad block hash in BlockStored: %s", e)

    parent_request_key: Optional[Key] = None
    if ev.parent_block_hash is not None:
        try:
            parent_engine_key = Key(model_name, hash_as_uint64(ev.parent_block_hash))
        except (TypeError, ValueError) as e:
            logger.debug("bad parent hash in BlockStored: %s", e)
            return
        parent_request_key = index.get_request_key(parent_engine_key)

    # lora_id arrives off the untrusted wire: accept only non-negative ints,
    # otherwise treat the event as non-LoRA.
    lora_id = ev.lora_id
    if not isinstance(lora_id, int) or isinstance(lora_id, bool) or lora_id < 0:
        if lora_id is not None:
            logger.debug("ignoring invalid lora_id %r in BlockStored", lora_id)
        lora_id = None

    request_keys = token_processor.tokens_to_kv_block_keys(
        parent_request_key, ev.token_ids, model_name, lora_id=lora_id
    )
    if engine_keys:
        try:
            index.add(engine_keys, request_keys, entries)
        except ValueError as e:
            logger.debug("failed to add BlockStored to index: %s", e)


def digest_block_removed(
    index: Index,
    pod_identifier: str,
    model_name: str,
    ev: BlockRemoved,
) -> None:
    tier = (ev.medium or DEFAULT_DEVICE_TIER).lower()
    entries = [PodEntry(pod_identifier, tier)]
    for raw in ev.block_hashes:
        try:
            engine_key = Key(model_name, hash_as_uint64(raw))
        except (TypeError, ValueError) as e:
            logger.debug("bad block hash in BlockRemoved: %s", e)
            continue
        try:
            index.evict(engine_key, entries)
        except ValueError as e:
            logger.debug("failed to evict from index: %s", e)


def digest_batch(
    index: Index,
    token_processor: ChunkedTokenDatabase,
    pod_identifier: str,
    model_name: str,
    batch: EventBatch,
) -> None:
    """Digest every event of one batch, in order."""
    for ev in batch.events:
        if isinstance(ev, BlockStored):
            digest_block_stored(index, token_processor, pod_identifier, model_name, ev)
        elif isinstance(ev, BlockRemoved):
            digest_block_removed(index, pod_identifier, model_name, ev)
