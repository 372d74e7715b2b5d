"""LRU prefix-token store with chained xxhash64 chunk keys.

Copy of the reference package's `LRUTokenStore`, hashing with the port's
plain-Python XXH64 (utils/xxh64.py, equal to `xxhash.xxh64`): the prompt
byte string is cut into fixed-size chunks (default 256 bytes, partial tail
dropped); each chunk's key is xxhash64(little_endian(prev_hash) ‖ chunk_bytes)
with prev_hash chained from 0; the value is the list of tokens whose [_, high)
byte offset ends inside that chunk. Lookup re-derives the chain and early-stops
at the first missing chunk, returning accumulated tokens and the byte-coverage
ratio.

Each cached chunk also carries a 64-bit fingerprint of
its token list (xxhash64 over the packed token values, computed once at add
time), and both the add and lookup paths fold those into a cumulative
`prefix_state` — `((fingerprint, cumulative_token_count), ...)` per covered
chunk boundary. The chain-state memo (kvcache/kvblock/chain_memo.py) keys
memoized block-hash chains off this state, so a warm multi-turn read path
resumes key derivation at the first novel block without touching a single
token. The fingerprint chain is a pure function of the exact token lists this
store returns: re-tokenized or relearned chunks change it, so stale chain
states can never be served — they just miss.
"""

from __future__ import annotations

import struct
import threading
from array import array
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.hashing import fold64
from llm_d_kv_cache_manager_tpu_torch.tokenization.prefixstore.indexer import (
    Offset,
    PrefixStore,
)
from llm_d_kv_cache_manager_tpu_torch.utils.lru import LRUCache
from llm_d_kv_cache_manager_tpu_torch.utils.xxh64 import intdigest as _xxh64

DEFAULT_BLOCK_SIZE = 256  # bytes of prompt text per chunk
DEFAULT_MAX_CACHE_SIZE = 500_000

# Basis of the cumulative token-fingerprint fold (arbitrary non-zero odd
# constant, distinct from the FNV offset so text-chunk fp chains and block
# hash chains can never land in each other's keyspace).
_STATE_BASIS = 0xA076_1D64_78BD_642F

_pack_u64 = struct.Struct("<Q").pack


@dataclass
class LRUStoreConfig:
    cache_size: int = DEFAULT_MAX_CACHE_SIZE
    block_size: int = DEFAULT_BLOCK_SIZE


def _chunk_hash(prev_hash: int, chunk: bytes) -> int:
    return _xxh64(_pack_u64(prev_hash) + chunk)


def _token_fp(tokens: Sequence[int]) -> Optional[int]:
    """xxhash64 of the packed token values; None when the tokens don't fit
    u64 packing (exotic ids) — state accumulation stops there."""
    try:
        return _xxh64(array("Q", tokens).tobytes())
    except (OverflowError, TypeError, ValueError):
        return None


class LRUTokenStore(PrefixStore):
    def __init__(self, config: LRUStoreConfig | None = None):
        cfg = config or LRUStoreConfig()
        self.block_size = cfg.block_size
        # chunk text hash → (tokens ending in the chunk, token fingerprint)
        self._cache: LRUCache[int, Tuple[List[int], Optional[int]]] = LRUCache(
            cfg.cache_size
        )
        self._mu = threading.Lock()

    def add_tokenization(
        self, prompt: str, tokens: Sequence[int], offsets: Sequence[Offset]
    ) -> Tuple[Tuple[int, int], ...]:
        """Cache the tokenization chunk by chunk; returns the resulting
        prefix state for the complete-chunk-covered prefix (see module
        docstring) — callers that predate the chain memo can ignore it."""
        if not prompt or not tokens:
            return ()
        prompt_bytes = prompt.encode("utf-8")
        state: List[Tuple[int, int]] = []
        state_fp = _STATE_BASIS
        state_ok = True
        with self._mu:
            token_idx = 0
            prev_hash = 0
            for start in range(0, len(prompt_bytes) - self.block_size + 1, self.block_size):
                end = start + self.block_size
                block_hash = _chunk_hash(prev_hash, prompt_bytes[start:end])
                prev_hash = block_hash

                # A token belongs to this chunk iff its end offset falls within
                # it; a start offset before the chunk is fine.
                block_tokens: List[int] = []
                while token_idx < len(tokens) and offsets[token_idx][1] <= end:
                    block_tokens.append(tokens[token_idx])
                    token_idx += 1

                tok_fp = _token_fp(block_tokens)
                self._cache.add(block_hash, (block_tokens, tok_fp))
                if state_ok and tok_fp is not None:
                    state_fp = fold64(state_fp, tok_fp)
                    state.append((state_fp, token_idx))
                else:
                    state_ok = False  # unfingerprintable chunk breaks the chain
        return tuple(state)

    def find_longest_contained_tokens(self, prompt: str) -> Tuple[List[int], float]:
        tokens, ratio, _ = self.find_longest_with_state(prompt)
        return tokens, ratio

    def find_longest_with_state(
        self, prompt: str
    ) -> Tuple[List[int], float, Tuple[Tuple[int, int], ...]]:
        """Like find_longest_contained_tokens, plus the prefix state of the
        covered chunks — the cumulative token-fingerprint chain the chain
        memo keys block-hash chains off."""
        contained: List[int] = []
        prompt_bytes = prompt.encode("utf-8")
        prev_hash = 0
        overlap_ratio = 0.0
        state: List[Tuple[int, int]] = []
        state_fp = _STATE_BASIS
        state_ok = True
        for start in range(0, len(prompt_bytes) - self.block_size + 1, self.block_size):
            end = start + self.block_size
            block_hash = _chunk_hash(prev_hash, prompt_bytes[start:end])
            prev_hash = block_hash

            entry = self._cache.get(block_hash)
            if entry is None:
                break  # early stop: prefix chain broke
            block_tokens, tok_fp = entry
            contained.extend(block_tokens)
            overlap_ratio = end / len(prompt_bytes)
            if state_ok and tok_fp is not None:
                state_fp = fold64(state_fp, tok_fp)
                state.append((state_fp, len(contained)))
            else:
                state_ok = False
        return contained, overlap_ratio, tuple(state)

    def find_longest_with_state_many(
        self, prompts: Sequence[str]
    ) -> List[Tuple[List[int], float, Tuple[Tuple[int, int], ...]]]:
        """Batched `find_longest_with_state` (the `score_many` read path).

        Router batches share system prefixes, and a shared BYTE prefix is
        a shared chunk-hash chain, so the walk amortizes two ways:

        - The first item over a given leading chunk becomes that chunk's
          REFERENCE walk: it records per-chunk hashes and cumulative
          (token count, state) snapshots. Later items sharing its leading
          chunk find their common chunk-aligned byte prefix by a binary
          search of C-speed `memcmp`s and FORK the reference's snapshot
          at the divergence chunk — one list slice replaces the whole
          shared re-walk (hash, probe, token assembly, fingerprint fold
          per chunk) — then walk only their own tail. Exactly-repeated
          prompts fork whole.
        - Each item's own tail probes the chunk cache in geometrically
          growing WAVES (one `get_many` per wave): the chain hashes are
          pure compute, so hashing a wave ahead trades at most a few
          wasted hashes past a cut for one lock crossing per wave instead
          of one per chunk.

        Per-item results are exactly `find_longest_with_state`'s: byte
        equality of the shared prefix means the same chunk chain, and the
        snapshot carries the same cumulative tokens/fold — forking only
        moves WHO does the identical work; waves only move WHEN a probe
        happens, and the walk still consumes hits strictly in chain order
        with the same first-miss cut. The only observable difference is
        LRU recency: shared chunks are refreshed once per batch (not once
        per item), and a wave may touch a few chunks past an item's cut."""
        bs = self.block_size
        get_many = self._cache.get_many
        refs: dict = {}  # first chunk bytes -> reference walk record
        out: List[Tuple[List[int], float, Tuple[Tuple[int, int], ...]]] = []
        for prompt in prompts:
            prompt_bytes = prompt.encode("utf-8")
            n_chunks = len(prompt_bytes) // bs
            if n_chunks == 0:
                out.append(([], 0.0, ()))
                continue
            contained: List[int] = []
            prev_hash = 0
            state: List[Tuple[int, int]] = []
            state_fp = _STATE_BASIS
            state_ok = True
            start_chunk = 0
            record = None

            first = prompt_bytes[:bs]
            ref = refs.get(first)
            if ref is None:
                # Reference walk: record per-chunk hashes and cumulative
                # snapshots so later batch-mates can fork mid-chain.
                record = {
                    "bytes": prompt_bytes, "hashes": [], "snaps": [],
                    "contained": contained, "state": state, "cut": None,
                }
                refs[first] = record
            else:
                # The ref's recorded chunks are its HITS; a ref that cut
                # offers a shorter shareable span, and the walk below
                # re-probes the divergence chunk itself (an identical
                # chunk repeats the identical miss on an unchanged cache).
                ref_bytes = ref["bytes"]
                hi = min(n_chunks, len(ref["hashes"]))
                m = 0
                if hi >= 1:
                    # Largest m ≤ hi with identical first m chunks. Chunk
                    # 0 matched byte-for-byte via the bucket probe: lo=1.
                    lo = 1
                    while lo < hi:
                        mid = (lo + hi + 1) // 2
                        if prompt_bytes[: mid * bs] == ref_bytes[: mid * bs]:
                            lo = mid
                        else:
                            hi = mid - 1
                    m = lo
                if m > 0:
                    ntok, nstate, state_fp, state_ok = ref["snaps"][m - 1]
                    contained = ref["contained"][:ntok]
                    state = ref["state"][:nstate]
                    prev_hash = ref["hashes"][m - 1]
                    start_chunk = m

            covered = n_chunks
            ci = start_chunk
            wave = 2
            while ci < n_chunks:
                upto = min(ci + wave, n_chunks)
                wave <<= 1
                hashes: List[int] = []
                h = prev_hash
                for k in range(ci, upto):
                    h = _chunk_hash(h, prompt_bytes[k * bs : (k + 1) * bs])
                    hashes.append(h)
                prev_hash = h
                got = get_many(hashes)  # one lock crossing per wave
                cut = False
                for k, block_hash in enumerate(hashes):
                    entry = got.get(block_hash)
                    if entry is None:
                        if record is not None:
                            record["cut"] = ci + k
                        covered = ci + k
                        cut = True
                        break
                    block_tokens, tok_fp = entry
                    contained.extend(block_tokens)
                    if state_ok and tok_fp is not None:
                        state_fp = fold64(state_fp, tok_fp)
                        state.append((state_fp, len(contained)))
                    else:
                        state_ok = False
                    if record is not None:
                        record["hashes"].append(block_hash)
                        record["snaps"].append(
                            (len(contained), len(state), state_fp, state_ok)
                        )
                if cut:
                    break
                ci = upto
            overlap_ratio = (
                (covered * bs) / len(prompt_bytes) if covered else 0.0
            )
            out.append((contained, overlap_ratio, tuple(state)))
        return out
