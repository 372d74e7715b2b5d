"""Tokens -> chained KV-block keys.

Port of the reference package's `ChunkedTokenDatabase` without its chain
memo (the memo only moves where hashing starts; keys are bit-identical
without it). Tokens are chunked into full blocks of `block_size` (partial
tail dropped); each block's key is the chained hash of (parent_hash,
block_tokens[, lora_id]); an optional parent key continues an existing chain
(the event digest uses it when BlockStored carries a parent hash).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import hashing
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key

DEFAULT_BLOCK_SIZE = 16  # vLLM default block size


@dataclass
class TokenProcessorConfig:
    block_size: int = DEFAULT_BLOCK_SIZE
    # Must match the engine fleet's PYTHONHASHSEED (vLLM NONE_HASH alignment).
    hash_seed: str = ""
    # "fnv64_cbor" (reference scheme) or "sha256_cbor_64bit" (vLLM parity;
    # requires a non-empty hash_seed).
    hash_algo: str = "fnv64_cbor"


class ChunkedTokenDatabase:
    """Converts token sequences into chained KV-block keys."""

    def __init__(self, config: Optional[TokenProcessorConfig] = None):
        self.config = config or TokenProcessorConfig()
        if self.config.hash_algo == "fnv64_cbor":
            self._init_hash = hashing.init_hash(self.config.hash_seed)
        elif self.config.hash_algo == "sha256_cbor_64bit":
            self._init_hash = hashing.sha256_cbor_init_hash(self.config.hash_seed)
        else:
            raise ValueError(f"unknown hash_algo: {self.config.hash_algo!r}")

    @property
    def block_size(self) -> int:
        return self.config.block_size

    @property
    def init_hash(self) -> int:
        return self._init_hash

    def tokens_to_kv_block_keys(
        self,
        parent_key: Optional[Key],
        tokens: Sequence[int],
        model_name: str,
        lora_id: Optional[int] = None,
    ) -> List[Key]:
        """Chain-hash full blocks of tokens into Keys; [] if no full block.
        `lora_id` mixes the adapter identity into every block hash."""
        parent_hash = (
            parent_key.chunk_hash if parent_key is not None else self._init_hash
        )
        extra = None if lora_id is None else [int(lora_id)]
        bs = self.config.block_size
        chunks = [tokens[i * bs:(i + 1) * bs] for i in range(len(tokens) // bs)]
        hashes = hashing.prefix_hashes(
            parent_hash, chunks, extra, algo=self.config.hash_algo
        )
        return [Key(model_name, h) for h in hashes]
