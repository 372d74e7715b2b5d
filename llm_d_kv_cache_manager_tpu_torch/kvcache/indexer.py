"""Indexer: the token-ID read path.

Port of the key-derivation, lookup and scoring stages of the reference
package's `Indexer.get_pod_scores`: tokens -> chained KV-block keys
(`ChunkedTokenDatabase`) -> `index.lookup` -> `LongestPrefixScorer.score`.
The caller hands in token IDs; tokenization and the prefix store are not
part of this port yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.kvcache.backend import (
    default_kv_cache_backend_configs,
    weight_map,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import InMemoryIndex
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.scorer import LongestPrefixScorer


class Indexer:
    """KV-cache-aware pod scorer over one index."""

    def __init__(
        self,
        token_processor_config: Optional[TokenProcessorConfig] = None,
        kv_block_index: Optional[Index] = None,
    ):
        self.token_processor = ChunkedTokenDatabase(token_processor_config)
        self.kv_block_index = kv_block_index or InMemoryIndex()
        self.scorer = LongestPrefixScorer(
            weight_map(default_kv_cache_backend_configs())
        )

    def get_pod_scores(
        self,
        tokens: Sequence[int],
        model_name: str,
        pod_ids: Sequence[str],
        lora_id=None,
    ) -> Dict[str, float]:
        """Score pods by cached-prefix length for `tokens`.

        Empty `pod_ids` means all known pods are relevant. Returns
        {pod_identifier: score}; pods without hits are absent. An invalid
        `lora_id` degrades to the base keyspace, as the event digest does.
        """
        if not isinstance(lora_id, int) or isinstance(lora_id, bool) or lora_id < 0:
            lora_id = None
        keys = self.token_processor.tokens_to_kv_block_keys(
            None, [int(t) for t in tokens], model_name, lora_id=lora_id
        )
        if not keys:
            return {}
        hits = self.kv_block_index.lookup(keys, set(pod_ids))
        return self.scorer.score(keys, hits)
