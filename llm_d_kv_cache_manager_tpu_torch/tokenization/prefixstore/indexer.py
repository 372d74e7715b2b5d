"""Prefix-token store contract.

Copy of the reference package's `tokenization/prefixstore/indexer.py`: a cache of
previous tokenizations keyed by text prefix, so the read path can often skip
full re-tokenization of a shared prompt prefix. `add_tokenization` records a
prompt's tokens with their byte offsets; `find_longest_contained_tokens`
returns the tokens covered by the longest cached prefix plus the coverage
ratio of the prompt.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

Offset = Tuple[int, int]  # [low, high) byte offsets into the prompt


class PrefixStore(abc.ABC):
    @abc.abstractmethod
    def add_tokenization(
        self, prompt: str, tokens: Sequence[int], offsets: Sequence[Offset]
    ) -> None: ...

    @abc.abstractmethod
    def find_longest_contained_tokens(self, prompt: str) -> Tuple[List[int], float]:
        """Returns (tokens, overlap_ratio in [0,1])."""


@dataclass
class PrefixStoreConfig:
    store_type: str = "lru"  # "lru" | "trie"
    cache_size: int = 500_000
    block_size_bytes: int = 256  # prompt bytes per chunk (not tokens)


def new_prefix_store(config: Optional[PrefixStoreConfig] = None) -> PrefixStore:
    cfg = config or PrefixStoreConfig()
    if cfg.store_type == "lru":
        from llm_d_kv_cache_manager_tpu_torch.tokenization.prefixstore.lru_store import (
            LRUStoreConfig,
            LRUTokenStore,
        )

        return LRUTokenStore(
            LRUStoreConfig(cache_size=cfg.cache_size, block_size=cfg.block_size_bytes)
        )
    if cfg.store_type == "trie":
        from llm_d_kv_cache_manager_tpu_torch.tokenization.prefixstore.trie_store import (
            TrieTokenStore,
        )

        return TrieTokenStore(cfg.cache_size)
    raise ValueError(f"unknown prefix store type: {cfg.store_type}")
