"""KV-page manager with prefix caching and KVEvent emission.

Port of the reference package's `engine/block_manager.py` without the
host-tier hooks (offload on reclaim, chain restore on miss):

- page allocation for sequences over a fixed device page pool,
- prefix caching: full pages are keyed by the same chained CBOR+FNV-64a hash
  the control plane recomputes, so an indexer with a matching hash seed maps
  engine events onto identical request keys,
- refcounting: freed sequences leave their pages cached; pages are
  reclaimed LRU on allocation pressure,
- event emission: BlockStored when a full page is committed (with parent
  hash chaining), BlockRemoved when a cached page is reclaimed,
  AllBlocksCleared on reset.

Pure host-side bookkeeping; the page tensors live in models/llama.py and
are driven by engine.EnginePod.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.events import (
    AllBlocksCleared,
    BlockRemoved,
    BlockStored,
    Event,
    EventBatch,
)

EventSink = Callable[[EventBatch], None]


@dataclass
class BlockManagerConfig:
    n_pages: int = 512
    page_size: int = 16  # tokens per page == control-plane block size
    hash_seed: str = ""
    device_tier: Optional[str] = None  # None -> events carry no Medium


@dataclass
class SequenceState:
    seq_id: int
    tokens: List[int]
    block_table: List[int]
    num_cached_tokens: int  # prefix-cache hit length at allocation time
    n_hashed_pages: int  # pages already committed (hashed + event emitted)
    lora_id: Optional[int] = None  # adapter scoping for block hashes


class _Page:
    __slots__ = ("page_id", "ref_count", "chunk_hash")

    def __init__(self, page_id: int):
        self.page_id = page_id
        self.ref_count = 0
        self.chunk_hash: Optional[int] = None  # set when committed (full page)


class OutOfPagesError(RuntimeError):
    pass


class BlockManager:
    def __init__(
        self,
        config: BlockManagerConfig,
        event_sink: Optional[EventSink] = None,
    ):
        self.config = config
        self.event_sink = event_sink
        self.token_db = ChunkedTokenDatabase(
            TokenProcessorConfig(block_size=config.page_size, hash_seed=config.hash_seed)
        )
        self._pages = [_Page(i) for i in range(config.n_pages)]
        self._free_fresh = list(range(config.n_pages - 1, -1, -1))  # pop() -> page 0 first
        # hash -> page_id for committed, reusable pages.
        self._hash_to_page: Dict[int, int] = {}
        # LRU of ref_count==0 committed pages, eligible for reclaim.
        self._reclaimable: "OrderedDict[int, None]" = OrderedDict()
        self._seq_counter = 0

    # -- stats ---------------------------------------------------------------

    @property
    def num_free_pages(self) -> int:
        return len(self._free_fresh) + len(self._reclaimable)

    @property
    def num_cached_pages(self) -> int:
        return len(self._hash_to_page)

    # -- allocation ----------------------------------------------------------

    def allocate(
        self, tokens: Sequence[int], lora_id: Optional[int] = None
    ) -> SequenceState:
        """Allocate pages for a new sequence, reusing cached prefix pages.

        `num_cached_tokens` of the result tells the caller how many leading
        tokens need no recompute. Raises OutOfPagesError if the pool cannot
        cover the request. A `lora_id` scopes prefix reuse to that adapter.
        """
        tokens = [int(t) for t in tokens]
        ps = self.config.page_size
        n_pages_needed = (len(tokens) + ps - 1) // ps

        block_table: List[int] = []
        keys = self.token_db.tokens_to_kv_block_keys(None, tokens, "", lora_id=lora_id)
        # 1. Reuse cached pages along the hash chain.
        n_cached_pages = 0
        for key in keys:
            page_id = self._hash_to_page.get(key.chunk_hash)
            if page_id is None:
                break
            page = self._pages[page_id]
            if page.ref_count == 0:
                self._reclaimable.pop(page_id, None)
            page.ref_count += 1
            block_table.append(page_id)
            n_cached_pages += 1

        # 2. Fresh pages for the rest, referenced too (so a page committed
        # here and reused by another sequence is never reclaimed under a
        # live reader).
        try:
            for page_id in self._take_free_pages(n_pages_needed - len(block_table)):
                self._pages[page_id].ref_count += 1
                block_table.append(page_id)
        except OutOfPagesError:
            self._rollback(block_table, n_cached_pages)
            raise

        state = SequenceState(
            seq_id=self._seq_counter,
            tokens=tokens,
            block_table=block_table,
            num_cached_tokens=n_cached_pages * ps,
            n_hashed_pages=n_cached_pages,
            lora_id=lora_id,
        )
        self._seq_counter += 1
        return state

    def commit_prefill(self, state: SequenceState) -> None:
        """Commit the sequence's full pages after prefill compute: hash,
        register for reuse, and emit one BlockStored chaining from the
        cached prefix."""
        self._commit_full_pages(state, n_computed=len(state.tokens))

    def append_token(self, state: SequenceState, token: int) -> None:
        """Record one decoded token; reserves a new page at boundaries.

        The appended token is *pending*: its KV row is written only by the
        next decode pass. A page whose final slot holds the pending token is
        committed by `mark_decode_computed`, after that pass."""
        state.tokens.append(int(token))
        ps = self.config.page_size
        self.reserve_pages(state, (len(state.tokens) + ps - 1) // ps)
        self._commit_full_pages(state, n_computed=len(state.tokens) - 1)

    def mark_decode_computed(self, state: SequenceState) -> None:
        """All of `state.tokens` now have device-resident KV; commit any
        page that completion fills."""
        self._commit_full_pages(state, n_computed=len(state.tokens))

    def reserve_pages(self, state: SequenceState, n_total_pages: int) -> None:
        """Extend the block table with fresh (uncommitted) pages so device
        writes beyond the current token count (bucket-padded prefill rows)
        have somewhere to land. Atomic: on pool exhaustion nothing is taken.
        Unused reservations return to the pool on free()."""
        for page_id in self._take_free_pages(n_total_pages - len(state.block_table)):
            self._pages[page_id].ref_count += 1
            state.block_table.append(page_id)

    def free(self, state: SequenceState) -> None:
        """Release the sequence. Committed pages stay cached (reclaimable);
        uncommitted (partial) pages return to the fresh pool."""
        for page_id in state.block_table:
            page = self._pages[page_id]
            page.ref_count -= 1
            if page.ref_count > 0:
                continue
            if page.chunk_hash is not None:
                self._reclaimable[page_id] = None
                self._reclaimable.move_to_end(page_id)
            else:
                self._free_fresh.append(page_id)

    def clear(self) -> None:
        """Drop everything (engine restart): BlockRemoved for every cached
        page, then AllBlocksCleared (the digest treats the latter as a
        no-op and relies on the per-block removals)."""
        cached_hashes = list(self._hash_to_page)
        self.__init__(self.config, self.event_sink)
        events: List[Event] = []
        if cached_hashes:
            events.append(
                BlockRemoved(block_hashes=cached_hashes, medium=self.config.device_tier)
            )
        events.append(AllBlocksCleared())
        self._emit(events)

    # -- internals -----------------------------------------------------------

    def _take_free_pages(self, k: int) -> List[int]:
        """k pages in one grab, fresh pool first then LRU reclaim (one
        multi-hash BlockRemoved per reclaim wave). Atomic: on shortfall
        nothing is taken."""
        if k <= 0:
            return []
        got = [self._free_fresh.pop() for _ in range(min(k, len(self._free_fresh)))]
        need = k - len(got)
        if need == 0:
            return got
        if len(self._reclaimable) < need:
            self._free_fresh.extend(reversed(got))
            raise OutOfPagesError(f"no free pages (pool={self.config.n_pages})")
        victims = [self._reclaimable.popitem(last=False)[0] for _ in range(need)]
        removed_hashes: List[int] = []
        for page_id in victims:
            page = self._pages[page_id]
            # Only drop the mapping (and tell the control plane) if this page
            # is the registered holder of its hash: a duplicate-content page
            # may have lost the registration race.
            if self._hash_to_page.get(page.chunk_hash) == page_id:
                self._hash_to_page.pop(page.chunk_hash)
                removed_hashes.append(page.chunk_hash)
            page.chunk_hash = None
        if removed_hashes:
            self._emit([
                BlockRemoved(block_hashes=removed_hashes, medium=self.config.device_tier)
            ])
        return got + victims

    def _rollback(self, block_table: List[int], n_cached: int) -> None:
        for i, page_id in enumerate(block_table):
            page = self._pages[page_id]
            page.ref_count -= 1
            if i < n_cached:
                if page.ref_count == 0:
                    self._reclaimable[page_id] = None
            else:
                self._free_fresh.append(page_id)

    def _commit_full_pages(self, state: SequenceState, n_computed: int) -> None:
        """Commit pages fully covered by the first `n_computed` tokens."""
        ps = self.config.page_size
        n_full = min(n_computed, len(state.tokens)) // ps
        if n_full <= state.n_hashed_pages:
            return

        start_page = state.n_hashed_pages
        parent_hash: Optional[int] = None
        if start_page > 0:
            parent_hash = self._pages[state.block_table[start_page - 1]].chunk_hash

        new_tokens = state.tokens[start_page * ps:n_full * ps]
        parent_key = Key("", parent_hash) if parent_hash is not None else None
        keys = self.token_db.tokens_to_kv_block_keys(
            parent_key, new_tokens, "", lora_id=state.lora_id
        )

        new_hashes: List[int] = []
        for offset, key in enumerate(keys):
            page = self._pages[state.block_table[start_page + offset]]
            page.chunk_hash = key.chunk_hash
            # First registration wins: a page already holding this hash
            # keeps its mapping (this page is duplicate content).
            self._hash_to_page.setdefault(key.chunk_hash, page.page_id)
            new_hashes.append(key.chunk_hash)

        state.n_hashed_pages = n_full
        if new_hashes:
            self._emit([
                BlockStored(
                    block_hashes=new_hashes,
                    parent_block_hash=parent_hash,
                    token_ids=new_tokens,
                    block_size=ps,
                    lora_id=state.lora_id,
                    medium=self.config.device_tier,
                )
            ])

    def _emit(self, events: List[Event]) -> None:
        if self.event_sink is not None and events:
            self.event_sink(EventBatch(ts=time.time(), events=events))
