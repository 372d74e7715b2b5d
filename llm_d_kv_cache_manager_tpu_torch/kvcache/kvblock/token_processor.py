"""Tokens → chained KV-block keys.

Copy of the reference package's `ChunkedTokenDatabase`: tokens are
chunked into full blocks of `block_size` (partial tail dropped; vLLM
default 16), each block's key is the chained CBOR+FNV-64a hash of
(parent_hash, block_tokens), and an optional parent key continues an
existing chain (used by the event pool when BlockStored events carry a
parent block hash). The chain memo (kvblock/chain_memo.py) only moves
where hashing starts; keys are bit-identical with it or without it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import hashing
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.chain_memo import (
    ChainMemo,
    ChainMemoConfig,
    PrefixState,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key

DEFAULT_BLOCK_SIZE = 16  # vLLM default block size


@dataclass
class TokenProcessorConfig:
    block_size: int = DEFAULT_BLOCK_SIZE
    # Must match the engine fleet's PYTHONHASHSEED (vLLM NONE_HASH alignment).
    hash_seed: str = ""
    # Chain-hash algorithm. "fnv64_cbor" is the reference scheme.
    # "sha256_cbor_64bit" reproduces vLLM v1's
    # `--prefix-caching-hash-algo=sha256_cbor_64bit` bit-for-bit — pin it when the indexer's request keys must equal the
    # engine's own block hashes rather than merely mapping to them through
    # the dual-key engine→request bookkeeping. sha256_cbor_64bit REQUIRES a
    # non-empty hash_seed: an unseeded vLLM fleet draws a per-process
    # random NONE_HASH (os.urandom, all hash fns), so parity with it is
    # impossible and construction fails loudly instead of scoring zero.
    hash_algo: str = "fnv64_cbor"
    # Chain-state memo (kvblock/chain_memo.py): incremental derivation —
    # follow-up turns resume hashing at the first novel block instead of
    # block 0, and the write plane derives each fleet-shared chain once.
    # Produces bit-identical keys (it only moves WHERE hashing starts);
    # disable to pin the from-scratch path.
    chain_memo: bool = True
    chain_memo_config: ChainMemoConfig = field(default_factory=ChainMemoConfig)

    @classmethod
    def default(cls) -> "TokenProcessorConfig":
        return cls()


class ChunkedTokenDatabase:
    """Converts token sequences into chained KV-block keys."""

    def __init__(self, config: Optional[TokenProcessorConfig] = None):
        self.config = config or TokenProcessorConfig.default()
        if self.config.hash_algo == "fnv64_cbor":
            self._init_hash = hashing.init_hash(self.config.hash_seed)
        elif self.config.hash_algo == "sha256_cbor_64bit":
            self._init_hash = hashing.sha256_cbor_init_hash(
                self.config.hash_seed
            )
        else:
            raise ValueError(
                f"unknown hash_algo: {self.config.hash_algo!r}"
            )
        self.chain_memo: Optional[ChainMemo] = None
        if self.config.chain_memo and self.config.chain_memo_config.enabled:
            self.chain_memo = ChainMemo(self.config.chain_memo_config)

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
        prefix_state: Optional[PrefixState] = None,
    ) -> List[Key]:
        """Chain-hash full blocks of tokens into Keys; [] if no full block.

        `lora_id` mixes the adapter identity into every block hash (vLLM
        "extra keys" semantics), so the same tokens served through different
        LoRA adapters occupy distinct index entries.

        `prefix_state` is the tokenization pool's prefix-store boundary
        fingerprint chain for THIS token list (pool.tokenize_ex). With the
        chain memo enabled it makes warm multi-turn derivation O(boundaries)
        instead of O(tokens); keys are bit-identical either way.
        """
        parent_hash = parent_key.chunk_hash if parent_key is not None else self._init_hash
        extra = None if lora_id is None else [int(lora_id)]
        if self.chain_memo is not None:
            return self.chain_memo.derive_keys(
                model_name, parent_hash, tokens, self.config.block_size,
                extra, self.config.hash_algo, prefix_state=prefix_state,
            )
        hashes = hashing.prefix_hashes_fast(
            parent_hash, tokens, self.config.block_size, extra,
            algo=self.config.hash_algo,
        )
        return [Key(model_name, h) for h in hashes]

    def tokens_to_kv_block_keys_many(
        self, requests: Sequence[tuple]
    ) -> List[List[Key]]:
        """Batched `tokens_to_kv_block_keys` for the `score_many` read
        path: `requests` is a sequence of `(tokens, model_name, lora_id,
        prefix_state)` tuples (parent is always the root hash — the read
        path never continues an engine chain) and the result is one Key
        list per request, bit-identical to per-request derivation.

        With the chain memo enabled the whole batch derives through
        `ChainMemo.derive_keys_many` (one memo probe, intra-batch
        shared-prefix dedup, at most two batched hash calls); with it
        disabled every request derives through
        `hashing.prefix_hashes_fast_many`."""
        bs = self.config.block_size
        algo = self.config.hash_algo
        root = self._init_hash
        if self.chain_memo is not None:
            return self.chain_memo.derive_keys_many([
                (
                    model_name, root, tokens, bs,
                    None if lora_id is None else [int(lora_id)],
                    algo, prefix_state,
                )
                for tokens, model_name, lora_id, prefix_state in requests
            ])
        hashes_per_request = hashing.prefix_hashes_fast_many([
            (
                root, tokens, bs,
                None if lora_id is None else [int(lora_id)], algo,
            )
            for tokens, model_name, lora_id, _ in requests
        ])
        return [
            [Key(model_name, h) for h in hashes]
            for (_, model_name, _, _), hashes
            in zip(requests, hashes_per_request)
        ]
