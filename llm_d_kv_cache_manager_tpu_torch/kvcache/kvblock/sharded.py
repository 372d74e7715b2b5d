"""Sharded, lock-striped KV-block index with a lock-free read view.

The single-lock `InMemoryIndex` funnels every reader and every kvevents shard worker
through one global `LRUCache` lock, takes it once *per key* (a 128-block
lookup = 128 acquisitions), and mutates recency order on the read path — so
concurrent `GetPodScores` calls serialize against each other *and* against
the write plane. This backend splits the index into S independent segments
and projects them into a read-optimized view:

- **Striping.** A key routes to segment `chunk_hash % S`. The chunk hash is
  itself an FNV-64a chain hash (hashing.py) — the same hash family the
  kvevents pool shards messages with (`fnv32a(pod) % S`,
  `kvevents/pool.py:add_task`) — so writer→segment affinity costs a single
  integer mod, no per-key re-hashing. Engine keys stripe the engine→request
  map the same way; `evict` resolves the engine segment first, then operates
  on the request key's segment (the two may differ — each step locks only
  its own stripe). Capacity is enforced per segment at ceil(size / S): the
  same total bound, striped.
- **Batching.** Write-side operations group keys by segment first and use
  the batched `LRUCache.get_many/peek_many/add_many` primitives: one lock
  acquisition per *touched segment* per call instead of one per key.
- **Read-mostly fast path (`touch=False`).** Each per-key pod LRU publishes
  its entries as an immutable tuple after every mutation, and the index
  maintains `_view: {request_key: entries}` — plain dict ops, atomic under
  the GIL. `lookup` walks the view with **zero lock acquisitions**: reads
  stop serializing on the write plane entirely. The price is recency: plain
  lookups don't refresh LRU order, so every `recency_refresh_interval`-th
  lookup call runs a batched `get_many` touch pass (one lock per touched
  segment) to keep hot chains away from the eviction end. Interval 1 =
  touch every lookup (InMemoryIndex's recency behavior).

Per-segment semantics are InMemoryIndex's exactly (in_memory.py): empty-pod-cache
and missing-key both cut the lookup walk, double-checked insert on add,
evict re-checks emptiness before removing the key. View maintenance is
write-side: entries are republished under the pod cache's mutex (so
last-writer-wins matches the pod LRU's state) and capacity evictions prune
the view through the segment LRU's eviction callback; adders re-check
membership after publishing so an interleaved eviction can't resurrect a
dead view entry.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import (
    DEFAULT_INDEX_SIZE,
    DEFAULT_PODS_PER_KEY,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index, IndexView
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key, PodEntry, pod_matches
from llm_d_kv_cache_manager_tpu_torch.utils.lru import LRUCache
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("kvblock.sharded")

DEFAULT_NUM_SHARDS = 16
DEFAULT_RECENCY_REFRESH = 64


@dataclass
class ShardedIndexConfig:
    size: int = DEFAULT_INDEX_SIZE
    pod_cache_size: int = DEFAULT_PODS_PER_KEY
    num_shards: int = DEFAULT_NUM_SHARDS
    # One lookup call out of this many runs the batched recency touch pass;
    # the rest read the lock-free view. <=1 = touch every lookup (InMemoryIndex
    # behavior).
    recency_refresh_interval: int = DEFAULT_RECENCY_REFRESH


class _ShardPodCache:
    """Per-key pod LRU with a published read snapshot.

    `entries` is a tuple republished (whole-object swap, atomic under the
    GIL) after every mutation batch, in the pod LRU's oldest-first order —
    exactly what `LRUCache.keys()` returns in InMemoryIndex.
    """

    __slots__ = ("cache", "mu", "entries")

    def __init__(self, capacity: int):
        self.cache: LRUCache[PodEntry, None] = LRUCache(capacity)
        self.mu = threading.Lock()
        self.entries: tuple = ()

    def republish(self) -> None:
        """Call with `mu` held after mutating `cache`."""
        self.entries = tuple(self.cache.keys())


class _Segment:
    """One lock stripe: a two-level LRU plus its slice of the engine map."""

    __slots__ = ("data", "engine_to_request")

    def __init__(self, capacity: int, on_evict):
        self.data: LRUCache[Key, _ShardPodCache] = LRUCache(
            capacity, on_evict=on_evict
        )
        self.engine_to_request: LRUCache[Key, Key] = LRUCache(capacity)


class ShardedIndex(Index):
    def __init__(self, config: Optional[ShardedIndexConfig] = None):
        cfg = config or ShardedIndexConfig()
        if cfg.num_shards <= 0:
            raise ValueError(f"num_shards must be positive, got {cfg.num_shards}")
        if cfg.size <= 0:
            raise ValueError(f"index size must be positive, got {cfg.size}")
        self._num_shards = cfg.num_shards
        self._pod_cache_size = cfg.pod_cache_size
        self._refresh = cfg.recency_refresh_interval
        self._per_shard_capacity = max(1, -(-cfg.size // cfg.num_shards))  # ceil
        # Lock-free read view: {request_key: published entries tuple}.
        # Single-op dict reads/writes are GIL-atomic; the segment LRU prunes
        # it on capacity eviction via the on_evict hook (runs under the
        # segment lock, so a pop can't interleave mid-eviction).
        self._view: Dict[Key, tuple] = {}
        # Monotonic count of keys leaving any segment's data LRU. Writers
        # snapshot it around a publish batch: unchanged means no eviction
        # could have raced their view writes, so the common (far-below-
        # capacity) add path skips the membership re-check entirely.
        self._evictions = 0
        self._segments = [
            _Segment(self._per_shard_capacity, self._on_data_evict)
            for _ in range(cfg.num_shards)
        ]
        # Starts at 1 so the refresh is periodic (every Nth lookup), not
        # immediate-then-periodic. itertools.count is GIL-thread-safe.
        self._lookup_tick = itertools.count(1)

    def _on_data_evict(self, key: Key, pod_cache) -> None:
        # Runs under the evicting segment's lock. The lost-increment race
        # between segments is harmless: the counter is only compared for
        # change, never for magnitude, and it never goes backwards.
        self._evictions += 1
        self._view.pop(key, None)

    # -- sharding ----------------------------------------------------------

    @property
    def num_shards(self) -> int:
        return self._num_shards

    @property
    def per_shard_capacity(self) -> int:
        return self._per_shard_capacity

    def shard_of(self, key: Key) -> int:
        """Deterministic stripe for a key: its FNV-64a chunk hash mod S."""
        return key.chunk_hash % self._num_shards

    def segment_sizes(self) -> List[int]:
        """Current entry count per segment (capacity-invariant probes)."""
        return [len(seg.data) for seg in self._segments]

    def _group_by_shard(self, keys: Sequence[Key]):
        """(shard, keys) pairs for the non-empty stripes."""
        n = self._num_shards
        grouped: List[Optional[List[Key]]] = [None] * n
        for key in keys:
            shard = key.chunk_hash % n
            bucket = grouped[shard]
            if bucket is None:
                grouped[shard] = [key]
            else:
                bucket.append(key)
        return [(s, b) for s, b in enumerate(grouped) if b is not None]

    # -- Index contract ----------------------------------------------------

    def lookup(
        self, request_keys: Sequence[Key], pod_identifier_set: Set[str]
    ) -> Dict[Key, List[PodEntry]]:
        if not request_keys:
            raise ValueError("no request keys provided for lookup")

        refresh = self._refresh
        if refresh <= 1 or next(self._lookup_tick) % refresh == 0:
            # Periodic recency refresh: one batched get_many per touched
            # segment moves this chain away from the LRU eviction end.
            for shard, keys in self._group_by_shard(request_keys):
                self._segments[shard].data.get_many(keys)

        # Lock-free walk in prompt order with InMemoryIndex's cut semantics: a
        # missing key (view miss) and a present-but-podless key (empty
        # published tuple) both end the search — the scorer's active set
        # empties at any gap, so post-gap hits can't score.
        view_get = self._view.get
        pods_per_key: Dict[Key, List[PodEntry]] = {}
        if pod_identifier_set:
            for key in request_keys:
                entries = view_get(key)
                if not entries:
                    kvlog.trace(logger, "chain cut at key: %s", key)
                    return pods_per_key
                hits = [
                    e for e in entries
                    if pod_matches(e.pod_identifier, pod_identifier_set)
                ]
                if hits:
                    pods_per_key[key] = hits
        else:
            for key in request_keys:
                entries = view_get(key)
                if not entries:
                    kvlog.trace(logger, "chain cut at key: %s", key)
                    return pods_per_key
                pods_per_key[key] = list(entries)
        return pods_per_key

    def lookup_many(
        self, requests: Sequence[tuple]
    ) -> List[Dict[Key, List[PodEntry]]]:
        """Batched `lookup` (Index.lookup_many): the whole batch's recency
        refresh collapses into at most ONE `get_many` per touched segment
        — each stripe lock is crossed once per batch, not once per item —
        and the per-item walks stay lock-free on the published view.

        Within a batch, items sharing a key (and pod-filter identity)
        share the materialized entry sequence OBJECT: unfiltered items get
        the published view tuple itself (zero copies, identity for free),
        filtered items share one materialized hit list per (filter, key).
        The scorer's batch path keys its per-key weight-map cache by
        object identity, so B requests over a hot shared prefix compute
        each block's weight map once instead of B times. Per-item results
        carry the same entries in the same order as standalone `lookup`
        calls over the same view state (as immutable tuples rather than
        fresh lists on the unfiltered path)."""
        if not requests:
            return []
        refresh = self._refresh
        if refresh <= 1:
            due_items = range(len(requests))
        else:
            # Consume one tick per item (same cadence as N single calls)
            # and refresh exactly the items whose tick lands on the
            # boundary — the same keys-touched-per-tick amortization as
            # the single-call path, not a whole-batch union touch.
            due_items = [
                j for j in range(len(requests))
                if next(self._lookup_tick) % refresh == 0
            ]
        if due_items:
            union: List[Key] = []
            for j in due_items:
                union.extend(requests[j][0])
            for shard, keys in self._group_by_shard(union):
                self._segments[shard].data.get_many(keys)

        view_get = self._view.get
        out: List[Dict[Key, List[PodEntry]]] = []
        shared: dict = {}
        for request_keys, pod_identifier_set in requests:
            if not request_keys:
                raise ValueError("no request keys provided for lookup")
            pods_per_key: Dict[Key, List[PodEntry]] = {}
            if pod_identifier_set:
                tok = id(pod_identifier_set)
                for key in request_keys:
                    entries = view_get(key)
                    if not entries:
                        break  # chain cut (InMemoryIndex semantics), this item only
                    sk = (tok, key)
                    hits = shared.get(sk)
                    if hits is None:
                        hits = shared[sk] = [
                            e for e in entries
                            if pod_matches(e.pod_identifier, pod_identifier_set)
                        ]
                    if hits:
                        pods_per_key[key] = hits
            else:
                for key in request_keys:
                    entries = view_get(key)
                    if not entries:
                        break
                    pods_per_key[key] = entries
            out.append(pods_per_key)
        return out

    def add(
        self,
        engine_keys: Sequence[Key],
        request_keys: Sequence[Key],
        entries: Sequence[PodEntry],
    ) -> None:
        if not engine_keys or not request_keys or not entries:
            raise ValueError("no keys or entries provided for adding to index")
        if len(engine_keys) != len(request_keys):
            raise ValueError(
                f"engine/request key length mismatch: {len(engine_keys)} != {len(request_keys)}"
            )

        # Engine→request mappings, grouped by the ENGINE key's segment.
        pairs_by_shard: Dict[int, List[tuple]] = {}
        for engine_key, request_key in zip(engine_keys, request_keys):
            pairs_by_shard.setdefault(self.shard_of(engine_key), []).append(
                (engine_key, request_key)
            )
        for shard, pairs in pairs_by_shard.items():
            self._segments[shard].engine_to_request.add_many(pairs)

        # Pod-cache inserts, grouped by the REQUEST key's segment. One
        # batched fetch resolves the existing caches; only absent keys pay
        # the double-checked contains_or_add dance (InMemoryIndex semantics).
        view = self._view
        for shard, keys in self._group_by_shard(request_keys):
            seg = self._segments[shard]
            evictions_before = self._evictions
            existing = seg.data.get_many(keys)
            for request_key in keys:
                pod_cache = existing.get(request_key)
                if pod_cache is None:
                    candidate = _ShardPodCache(self._pod_cache_size)
                    contained, _ = seg.data.contains_or_add(request_key, candidate)
                    if contained:
                        pod_cache = seg.data.get(request_key)
                        if pod_cache is None:  # evicted in the window; re-add ours
                            seg.data.add(request_key, candidate)
                            pod_cache = candidate
                    else:
                        pod_cache = candidate
                    existing[request_key] = pod_cache  # duplicate keys in batch
                with pod_cache.mu:
                    for entry in entries:
                        pod_cache.cache.add(entry, None)
                    pod_cache.republish()
                    # Publish under mu: last view writer == last pod-LRU
                    # writer, so the view can't go backwards.
                    view[request_key] = pod_cache.entries
            if self._evictions != evictions_before:
                # An eviction raced this batch somewhere; its callback may
                # have fired before our publishes landed. Re-check so a dead
                # key can't keep a resurrected view entry. Far below
                # capacity (the steady state) this branch never runs.
                for request_key in keys:
                    if seg.data.peek(request_key) is None:
                        view.pop(request_key, None)

    def evict(self, engine_key: Key, entries: Sequence[PodEntry]) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction from index")

        engine_seg = self._segments[self.shard_of(engine_key)]
        request_key = engine_seg.engine_to_request.get(engine_key)
        if request_key is None:
            kvlog.trace(logger, "engine key not in index, nothing to evict: %s", engine_key)
            return

        request_seg = self._segments[self.shard_of(request_key)]
        pod_cache = request_seg.data.get(request_key)
        if pod_cache is None:
            engine_seg.engine_to_request.remove(engine_key)
            return

        view = self._view
        evictions_before = self._evictions
        with pod_cache.mu:
            for entry in entries:
                pod_cache.cache.remove(entry)
            pod_cache.republish()
            view[request_key] = pod_cache.entries
            is_empty = len(pod_cache.cache) == 0
        if self._evictions != evictions_before and request_seg.data.peek(
            request_key
        ) is None:
            view.pop(request_key, None)  # same resurrection guard as add()

        if is_empty:
            # Same re-check as InMemoryIndex: shrink (not eliminate) the window
            # where a concurrent add repopulates the cache; worst case an
            # empty cache is left behind for LRU to collect.
            current = request_seg.data.get(request_key)
            if current is not None:
                with current.mu:
                    still_empty = len(current.cache) == 0
                if still_empty:
                    request_seg.data.remove(request_key)
                    engine_seg.engine_to_request.remove(engine_key)

    def get_request_key(self, engine_key: Key) -> Optional[Key]:
        return self._segments[self.shard_of(engine_key)].engine_to_request.get(
            engine_key
        )

    def remove_pod(self, pod_identifier: str) -> int:
        """One-pass quarantine purge (Index.remove_pod contract), segment by
        segment — each stripe locks independently, and the read view is
        republished under each pod cache's mutex so concurrent lookups only
        ever see before/after states of a key, never a torn one."""
        target = {pod_identifier}
        removed = 0
        emptied = set()
        view = self._view
        for seg in self._segments:
            for request_key, pod_cache in seg.data.items():
                with pod_cache.mu:
                    victims = [
                        e for e in pod_cache.cache.keys()
                        if pod_matches(e.pod_identifier, target)
                    ]
                    for entry in victims:
                        pod_cache.cache.remove(entry)
                    removed += len(victims)
                    if not victims:
                        continue
                    pod_cache.republish()
                    view[request_key] = pod_cache.entries
                    is_empty = len(pod_cache.cache) == 0
                if is_empty:
                    # The segment LRU's on_evict hook prunes the view entry
                    # under the segment lock.
                    seg.data.remove(request_key)
                    emptied.add(request_key)
        if emptied:
            for seg in self._segments:
                for engine_key, request_key in seg.engine_to_request.items():
                    if request_key in emptied:
                        seg.engine_to_request.remove(engine_key)
        return removed

    def shed(self, fraction: float) -> int:
        """Resource-governor hook: drop the oldest `fraction` of request
        keys in every segment — the LRU tail, exactly what capacity
        eviction would reclaim next, so a shed is indistinguishable from
        running at a smaller index. The segment LRU's on_evict hook
        prunes each dropped key's read-view entry under the segment
        lock; engine mappings pointing at a dropped key are swept after.
        Returns pod entries removed."""
        fraction = min(max(fraction, 0.0), 1.0)
        if fraction <= 0.0:
            return 0
        removed = 0
        emptied = set()
        for seg in self._segments:
            keys = seg.data.keys()
            for request_key in keys[: int(len(keys) * fraction)]:
                pod_cache = seg.data.peek(request_key)
                if pod_cache is None:
                    continue
                with pod_cache.mu:
                    removed += len(pod_cache.cache)
                seg.data.remove(request_key)
                emptied.add(request_key)
        if emptied:
            for seg in self._segments:
                for engine_key, request_key in seg.engine_to_request.items():
                    if request_key in emptied:
                        seg.engine_to_request.remove(engine_key)
        return removed

    def remove_entries(
        self, pod_identifier: str, request_keys, device_tiers=None
    ) -> int:
        """Targeted purge (Index.remove_entries contract). Each touched
        key's read-view entry is REPUBLISHED under its pod cache's mutex
        (same discipline as `add`/`evict`), so concurrent lock-free
        lookups only ever see before/after states of a key — a purged
        phantom stops scoring the moment this returns. Untouched keys are
        accessed via `peek`, keeping their recency order."""
        target = {pod_identifier}
        removed = 0
        emptied = set()
        view = self._view
        for request_key in request_keys:
            seg = self._segments[self.shard_of(request_key)]
            pod_cache = seg.data.peek(request_key)
            if pod_cache is None:
                continue
            with pod_cache.mu:
                victims = [
                    e for e in pod_cache.cache.keys()
                    if pod_matches(e.pod_identifier, target)
                    and (device_tiers is None or e.device_tier in device_tiers)
                ]
                for entry in victims:
                    pod_cache.cache.remove(entry)
                removed += len(victims)
                if not victims:
                    continue
                pod_cache.republish()
                view[request_key] = pod_cache.entries
                is_empty = len(pod_cache.cache) == 0
            if is_empty:
                # The segment LRU's on_evict hook prunes the view entry
                # under the segment lock.
                seg.data.remove(request_key)
                emptied.add(request_key)
        if emptied:
            for seg in self._segments:
                for engine_key, request_key in seg.engine_to_request.items():
                    if request_key in emptied:
                        seg.engine_to_request.remove(engine_key)
        return removed

    def export_view(self) -> IndexView:
        """Snapshot segment by segment, each stripe oldest-first
        (Index.export_view contract). Keys re-stripe identically on
        import (chunk_hash % S is config-independent of insertion
        history), so a same-shape restore reproduces per-segment recency
        exactly; cross-backend restores see segment-grouped order."""
        entries = []
        engine_map = []
        for seg in self._segments:
            for request_key, pod_cache in seg.data.items():
                with pod_cache.mu:
                    pods = tuple(
                        (e.pod_identifier, e.device_tier)
                        for e in pod_cache.cache.keys()
                    )
                entries.append(
                    (request_key.model_name, request_key.chunk_hash, pods)
                )
            for engine_key, request_key in seg.engine_to_request.items():
                engine_map.append((
                    engine_key.model_name, engine_key.chunk_hash,
                    request_key.model_name, request_key.chunk_hash,
                ))
        return IndexView(entries=entries, engine_map=engine_map)

    def import_view(self, view: IndexView) -> int:
        """Rebuild segments + the lock-free read view (Index.import_view).

        Entries publish under each pod cache's mutex exactly like `add`,
        so a replica can import while its read path is already serving —
        lookups see before/after states of a key, never a torn one."""
        imported = 0
        read_view = self._view
        for model_name, chunk_hash, pods in view.entries:
            request_key = Key(model_name, chunk_hash)
            seg = self._segments[self.shard_of(request_key)]
            pod_cache = seg.data.get(request_key)
            if pod_cache is None:
                pod_cache = _ShardPodCache(self._pod_cache_size)
                seg.data.add(request_key, pod_cache)
            with pod_cache.mu:
                for pod, tier in pods:
                    pod_cache.cache.add(PodEntry(pod, tier), None)
                    imported += 1
                pod_cache.republish()
                read_view[request_key] = pod_cache.entries
        for engine_model, engine_hash, req_model, req_hash in view.engine_map:
            engine_key = Key(engine_model, engine_hash)
            self._segments[self.shard_of(engine_key)].engine_to_request.add(
                engine_key, Key(req_model, req_hash)
            )
        return imported
