"""Character-trie prefix-token store (alternative backend).

Copy of the reference package's `TrieTokenStore`: a trie
over prompt characters where each node at depth d records the tokens that are
fully contained within the first d characters; lookup walks the prompt
character by character collecting newly-completed tokens.

This build keys the trie on *byte* positions (consistent with the byte-offset
contract of the tokenizer stack) and bounds memory by node count.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.tokenization.prefixstore.indexer import (
    Offset,
    PrefixStore,
)


class _Node:
    __slots__ = ("children", "tokens_here")

    def __init__(self):
        self.children: Dict[int, "_Node"] = {}
        # Tokens whose end offset == this node's depth.
        self.tokens_here: List[int] = []


class TrieTokenStore(PrefixStore):
    def __init__(self, max_nodes: int = 1_000_000):
        self._root = _Node()
        self._max_nodes = max_nodes
        self._node_count = 0
        self._mu = threading.Lock()

    def add_tokenization(
        self, prompt: str, tokens: Sequence[int], offsets: Sequence[Offset]
    ) -> None:
        if not prompt or not tokens:
            return
        prompt_bytes = prompt.encode("utf-8")
        with self._mu:
            node = self._root
            token_idx = 0
            # Tokens with end offset 0 (e.g. BOS specials) attach to the root.
            while token_idx < len(tokens) and offsets[token_idx][1] == 0:
                if tokens[token_idx] not in node.tokens_here:
                    node.tokens_here.append(tokens[token_idx])
                token_idx += 1
            for depth, byte in enumerate(prompt_bytes, start=1):
                child = node.children.get(byte)
                if child is None:
                    if self._node_count >= self._max_nodes:
                        return
                    child = _Node()
                    node.children[byte] = child
                    self._node_count += 1
                node = child
                while token_idx < len(tokens) and offsets[token_idx][1] == depth:
                    if tokens[token_idx] not in node.tokens_here:
                        node.tokens_here.append(tokens[token_idx])
                    token_idx += 1

    def find_longest_contained_tokens(self, prompt: str) -> Tuple[List[int], float]:
        prompt_bytes = prompt.encode("utf-8")
        if not prompt_bytes:
            return [], 0.0
        with self._mu:
            node = self._root
            collected: List[int] = list(self._root.tokens_here)
            depth = 0
            for byte in prompt_bytes:
                child = node.children.get(byte)
                if child is None:
                    break
                node = child
                depth += 1
                collected.extend(node.tokens_here)
            return collected, depth / len(prompt_bytes)
