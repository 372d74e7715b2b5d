"""KV-page manager with prefix caching and KVEvent emission.

Port of the reference package's `engine/block_manager.py`:

- page allocation for sequences over a fixed device page pool,
- prefix caching: full pages are keyed by the same chained CBOR+FNV-64a hash
  the control plane recomputes, so an indexer with a matching hash seed maps
  engine events onto identical request keys,
- refcounting: freed sequences leave their pages cached; pages are
  reclaimed LRU on allocation pressure,
- event emission: BlockStored when a full page is committed (with parent
  hash chaining), BlockRemoved when a cached page is reclaimed,
  AllBlocksCleared on reset,
- the host tier's hooks (engine/tiering.py): a reclaim wave offloads its
  committed pages in one batched call, and an allocation that misses on the
  device restores the longest restorable run of its chain in one batch.

Pure host-side bookkeeping; the page tensors live in models/llama.py and
are driven by engine.EnginePod.
"""

from __future__ import annotations

import itertools
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
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("engine.block_manager")

EventSink = Callable[[EventBatch], None]


@dataclass
class BlockManagerConfig:
    n_pages: int = 512
    page_size: int = 16  # tokens per page == control-plane block size
    hash_seed: str = ""
    # False: no page is hashed, reused or advertised (no BlockStored).
    enable_prefix_caching: bool = True
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
    __slots__ = ("page_id", "ref_count", "chunk_hash", "token_ids", "parent_hash", "lora_id")

    def __init__(self, page_id: int):
        self.page_id = page_id
        self.ref_count = 0
        self.chunk_hash: Optional[int] = None  # set when committed (full page)
        # Provenance, kept so a reclaimed page can be offloaded with a
        # well-formed BlockStored (the control plane recomputes request keys
        # from token_ids + parent hash + lora_id).
        self.token_ids: Optional[List[int]] = None
        self.parent_hash: Optional[int] = None
        self.lora_id: Optional[int] = None


class OutOfPagesError(RuntimeError):
    pass


# Hooks of the host tier (engine/tiering.py):
#  ReclaimHook(chunk_hash, token_ids, parent_hash, page_id, lora_id): a
#    committed page is about to be dropped; offload it if desired.
#  ReclaimManyHook([(hash, token_ids, parent, page_id, lora_id)]): the same
#    for a whole reclaim wave (one device gather).
#  PageLoader(chunk_hash, token_ids, parent_hash, page_id) -> bool: land one
#    missing block into `page_id`.
#  ChainPlanner([hashes]) -> int: longest restorable prefix, membership
#    checks only (no bytes moved).
#  ChainLoader([(hash, token_ids, parent)], take_pages) -> [page_ids]: fetch
#    a chain prefix's payloads FIRST, then call take_pages(k) for exactly the
#    pages the fetched payloads need (once per landing wave), land them, and
#    return the landed page ids aligned with the block prefix. Fetch before
#    take: a stale plan cannot evict cached pages for a restore that lands
#    nothing.
ReclaimHook = Callable[[int, List[int], Optional[int], int, Optional[int]], None]
PageLoader = Callable[[int, List[int], Optional[int], int], bool]
ReclaimManyHook = Callable[[List[tuple]], None]
ChainPlanner = Callable[[List[int]], int]
ChainLoader = Callable[[List[tuple], Callable[[int], List[int]]], List[int]]


class BlockManager:
    def __init__(
        self,
        config: BlockManagerConfig,
        event_sink: Optional[EventSink] = None,
        reclaim_hook: Optional[ReclaimHook] = None,
        page_loader: Optional[PageLoader] = None,
        reclaim_many_hook: Optional[ReclaimManyHook] = None,
        chain_planner: Optional[ChainPlanner] = None,
        chain_loader: Optional[ChainLoader] = None,
    ):
        self.config = config
        self.event_sink = event_sink
        self.reclaim_hook = reclaim_hook
        self.page_loader = page_loader
        self.reclaim_many_hook = reclaim_many_hook
        self.chain_planner = chain_planner
        self.chain_loader = chain_loader
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

    def cached_hashes(self, limit: Optional[int] = None) -> List[int]:
        """Device-resident chunk hashes in insertion order, at most `limit`."""
        if limit is None:
            return list(self._hash_to_page)
        return list(itertools.islice(self._hash_to_page, max(limit, 0)))

    def is_cached(self, chunk_hash: int) -> bool:
        """True when the block is device-resident (committed and reusable)."""
        return chunk_hash in self._hash_to_page

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
        keys = (
            self.token_db.tokens_to_kv_block_keys(None, tokens, "", lora_id=lora_id)
            if self.config.enable_prefix_caching
            else []
        )
        # 1. Reuse cached pages along the hash chain; on a device miss, try
        # the host tier (host store, then peer pods) before giving up. A
        # restore's own reclaims can offload LATER chain blocks to the host
        # (restorable one step behind), so retry while each attempt lands
        # something: bounded by the chain length.
        n_cached_pages = 0
        chain_allowed = True
        for i, key in enumerate(keys):
            page_id = self._hash_to_page.get(key.chunk_hash)
            if page_id is None and chain_allowed:
                chain_allowed = self._try_load_chain(keys, tokens, i, lora_id) > 0
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
        self.__init__(self.config, self.event_sink, self.reclaim_hook,
                      self.page_loader, self.reclaim_many_hook,
                      self.chain_planner, self.chain_loader)
        events: List[Event] = []
        if cached_hashes:
            events.append(
                BlockRemoved(block_hashes=cached_hashes, medium=self.config.device_tier)
            )
        events.append(AllBlocksCleared())
        self._emit(events)

    def committed_blocks(self, state: SequenceState):
        """Yield (chunk_hash, token_ids, parent_hash, page_id, lora_id) for
        each committed page of a sequence: what the host tier needs to
        export it (engine.EnginePod.export_sequence)."""
        for i in range(state.n_hashed_pages):
            page = self._pages[state.block_table[i]]
            if page.chunk_hash is None or page.token_ids is None:
                continue
            yield (page.chunk_hash, page.token_ids, page.parent_hash,
                   page.page_id, page.lora_id)

    # -- internals -----------------------------------------------------------

    def _try_load_chain(self, keys: List[Key], tokens: List[int], start: int,
                        lora_id: Optional[int]) -> int:
        """On a device miss, land the longest restorable prefix of the rest
        of the chain in one batch: plan (membership checks), fetch, take
        exactly the pages the fetched payloads need, land them
        (tiering.load_chain), and commit them with one chained multi-block
        BlockStored. Restored blocks register in _hash_to_page, where the
        allocate loop picks them up. Returns the number of blocks landed."""
        if self.chain_loader is None and self.page_loader is None:
            return 0
        ps = self.config.page_size
        # Stop the batch at the first repeated hash (both occurrences
        # registering would strand a page) and at the first device-resident
        # one (re-fetching it would clobber the live page's registration).
        seen = set()
        uniq: List[Key] = []
        for key in keys[start:]:
            if key.chunk_hash in seen or key.chunk_hash in self._hash_to_page:
                break
            seen.add(key.chunk_hash)
            uniq.append(key)
        if not uniq:
            return 0
        if self.chain_planner is not None:
            n_plan = min(self.chain_planner([k.chunk_hash for k in uniq]), len(uniq))
        elif self.chain_loader is not None:
            n_plan = len(uniq)
        else:
            n_plan = 1  # a single-page loader probes one block
        if n_plan <= 0:
            return 0
        blocks = []
        for j in range(n_plan):
            i = start + j
            blocks.append((uniq[j].chunk_hash, tokens[i * ps:(i + 1) * ps],
                           keys[i - 1].chunk_hash if i > 0 else None))

        landed: List[int] = []
        taken: List[int] = []
        if self.chain_loader is not None:
            def take_pages(k: int) -> List[int]:
                got = self._take_free_pages(min(k, self.num_free_pages))
                taken.extend(got)
                return got

            try:
                landed = list(self.chain_loader(blocks, take_pages))
            except Exception as e:  # noqa: BLE001 - a data-plane fault must not fail allocate
                logger.debug("chain loader failed: %s", e)
                landed = []
        else:
            for chunk_hash, token_ids, parent_hash in blocks:
                if self.num_free_pages <= 0:
                    break
                page_id = self._take_free_pages(1)[0]
                taken.append(page_id)
                try:
                    ok = self.page_loader(chunk_hash, token_ids, parent_hash, page_id)
                except Exception as e:  # noqa: BLE001
                    logger.debug("page loader failed for %x: %s", chunk_hash, e)
                    ok = False
                if not ok:
                    break
                landed.append(page_id)

        stored_hashes: List[int] = []
        stored_tokens: List[int] = []
        for (chunk_hash, token_ids, parent_hash), page_id in zip(blocks, landed):
            page = self._pages[page_id]
            page.chunk_hash = chunk_hash
            page.token_ids = list(token_ids)
            page.parent_hash = parent_hash
            page.lora_id = lora_id
            self._hash_to_page[chunk_hash] = page_id
            stored_hashes.append(chunk_hash)
            stored_tokens.extend(token_ids)
        # Pages taken but never landed (loader fault, short fetch) go
        # straight back to the pool.
        landed_set = set(landed)
        self._free_fresh.extend(p for p in taken if p not in landed_set)
        if stored_hashes:
            self._emit([
                BlockStored(
                    block_hashes=stored_hashes,
                    parent_block_hash=blocks[0][2],
                    token_ids=stored_tokens,
                    block_size=ps,
                    lora_id=lora_id,
                    medium=self.config.device_tier,
                )
            ])
        return len(landed)

    def _take_free_pages(self, k: int) -> List[int]:
        """k pages in one grab, fresh pool first then LRU reclaim. Atomic: on
        shortfall nothing is taken. A reclaim wave offloads in one batched
        hook call and drops with one multi-hash BlockRemoved."""
        if k <= 0:
            return []
        got = [self._free_fresh.pop() for _ in range(min(k, len(self._free_fresh)))]
        need = k - len(got)
        if need == 0:
            return got
        if len(self._reclaimable) < need:
            self._free_fresh.extend(reversed(got))
            raise OutOfPagesError(f"no free pages (pool={self.config.n_pages})")
        victims = [self._reclaimable.popitem(last=False)[0] for _ in range(need)]  # LRU order
        offload: List[tuple] = []
        removed_hashes: List[int] = []
        for page_id in victims:
            page = self._pages[page_id]
            # Only drop the mapping (and tell the control plane) if this page
            # is the registered holder of its hash: a duplicate-content page
            # may have lost the registration race.
            if self._hash_to_page.get(page.chunk_hash) == page_id:
                self._hash_to_page.pop(page.chunk_hash)
                if page.token_ids is not None:
                    offload.append((page.chunk_hash, page.token_ids, page.parent_hash,
                                    page_id, page.lora_id))
                removed_hashes.append(page.chunk_hash)
            page.chunk_hash = None
            page.token_ids = None
            page.parent_hash = None
            page.lora_id = None
        if offload:
            if self.reclaim_many_hook is not None:
                try:
                    self.reclaim_many_hook(offload)
                except Exception as e:  # noqa: BLE001 - offload is best-effort
                    logger.debug("reclaim offload failed: %s", e)
            elif self.reclaim_hook is not None:
                # One failing offload must not drop the rest of the wave.
                for block in offload:
                    try:
                        self.reclaim_hook(*block)
                    except Exception as e:  # noqa: BLE001
                        logger.debug("reclaim offload failed for %x: %s", block[0], e)
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
        if not self.config.enable_prefix_caching:
            return
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
            page.token_ids = new_tokens[offset * ps:(offset + 1) * ps]
            page.parent_hash = parent_hash if offset == 0 else keys[offset - 1].chunk_hash
            page.lora_id = state.lora_id
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
