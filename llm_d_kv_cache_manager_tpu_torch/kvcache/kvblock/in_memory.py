"""Default in-memory KV-block index: two-level LRU.

Copy of the reference package's `InMemoryIndex`: an LRU of request-key →
per-key pod LRU (capped, default 10 pods/key), plus an LRU mapping engine
keys → request keys.

- lookup: a key present with an empty pod cache cuts the search (the prefix
  chain is known to break there). A *missing* key cuts too:
  `LongestPrefixScorer` empties its active set at any gap in the chain, so
  entries past the first missing key can never contribute to a score.
- add: double-checked insertion so concurrent adders share one pod cache.
- evict: resolves engine→request key; removing the last pod removes the key
  from both maps (with a re-check to shrink the race window).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index, IndexView
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key, PodEntry, pod_matches
from llm_d_kv_cache_manager_tpu_torch.utils.lru import LRUCache
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("kvblock.in_memory")

DEFAULT_INDEX_SIZE = 10**8
DEFAULT_PODS_PER_KEY = 10


@dataclass
class InMemoryIndexConfig:
    size: int = DEFAULT_INDEX_SIZE
    pod_cache_size: int = DEFAULT_PODS_PER_KEY


class _PodCache:
    """Per-key LRU of pod entries, guarded for check-and-set sequences."""

    __slots__ = ("cache", "mu")

    def __init__(self, capacity: int):
        self.cache: LRUCache[PodEntry, None] = LRUCache(capacity)
        self.mu = threading.Lock()


class InMemoryIndex(Index):
    def __init__(self, config: Optional[InMemoryIndexConfig] = None):
        cfg = config or InMemoryIndexConfig()
        self._data: LRUCache[Key, _PodCache] = LRUCache(cfg.size)
        self._engine_to_request: LRUCache[Key, Key] = LRUCache(cfg.size)
        self._pod_cache_size = cfg.pod_cache_size

    def lookup(
        self, request_keys: Sequence[Key], pod_identifier_set: Set[str]
    ) -> Dict[Key, List[PodEntry]]:
        if not request_keys:
            raise ValueError("no request keys provided for lookup")

        pods_per_key: Dict[Key, List[PodEntry]] = {}
        for key in request_keys:
            pod_cache = self._data.get(key)
            if pod_cache is None:
                # Gap in the prefix chain: the scorer's active set empties
                # here, so post-gap hits are unusable — stop looking them up.
                kvlog.trace(logger, "key not found, cutting search: %s", key)
                return pods_per_key
            entries = pod_cache.cache.keys()
            if not entries:
                kvlog.trace(logger, "no pods for key, cutting search: %s", key)
                return pods_per_key
            if pod_identifier_set:
                entries = [
                    e for e in entries
                    if pod_matches(e.pod_identifier, pod_identifier_set)
                ]
                if entries:
                    pods_per_key[key] = entries
            else:
                pods_per_key[key] = entries
        return pods_per_key

    def lookup_many(
        self, requests: Sequence[tuple]
    ) -> List[Dict[Key, List[PodEntry]]]:
        """Batched `lookup` (Index.lookup_many): ONE `get_many` over the
        union of every item's keys replaces the per-key lock acquisition
        of N sequential lookups (recency refreshes once per batch instead
        of once per item — an LRU-order difference only, never a score
        difference). Items sharing a key share the materialized entry
        list object, which is what lets the scorer's batch path reuse
        per-key weight maps across items."""
        if not requests:
            return []
        union: List[Key] = []
        for keys, _ in requests:
            if not keys:
                raise ValueError("no request keys provided for lookup")
            union.extend(keys)
        fetched = self._data.get_many(union)
        entries_cache: Dict[Key, list] = {}
        shared: dict = {}
        out: List[Dict[Key, List[PodEntry]]] = []
        for request_keys, pod_identifier_set in requests:
            pods_per_key: Dict[Key, List[PodEntry]] = {}
            for key in request_keys:
                pod_cache = fetched.get(key)
                if pod_cache is None:
                    break  # gap: chain cut for this item only
                entries = entries_cache.get(key)
                if entries is None:
                    entries = entries_cache[key] = pod_cache.cache.keys()
                if not entries:
                    break
                if pod_identifier_set:
                    sk = (id(pod_identifier_set), key)
                    hits = shared.get(sk)
                    if hits is None:
                        hits = shared[sk] = [
                            e for e in entries
                            if pod_matches(e.pod_identifier, pod_identifier_set)
                        ]
                    if hits:
                        pods_per_key[key] = hits
                else:
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

        for engine_key, request_key in zip(engine_keys, request_keys):
            self._engine_to_request.add(engine_key, request_key)

            pod_cache = self._data.get(request_key)
            if pod_cache is None:
                candidate = _PodCache(self._pod_cache_size)
                contained, _ = self._data.contains_or_add(request_key, candidate)
                if contained:
                    pod_cache = self._data.get(request_key)
                    if pod_cache is None:  # evicted in the window; re-add ours
                        self._data.add(request_key, candidate)
                        pod_cache = candidate
                else:
                    pod_cache = candidate

            with pod_cache.mu:
                for entry in entries:
                    pod_cache.cache.add(entry, None)

    def evict(self, engine_key: Key, entries: Sequence[PodEntry]) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction from index")

        request_key = self._engine_to_request.get(engine_key)
        if request_key is None:
            kvlog.trace(logger, "engine key not in index, nothing to evict: %s", engine_key)
            return

        pod_cache = self._data.get(request_key)
        if pod_cache is None:
            self._engine_to_request.remove(engine_key)
            return

        with pod_cache.mu:
            for entry in entries:
                pod_cache.cache.remove(entry)
            is_empty = len(pod_cache.cache) == 0

        if is_empty:
            # Re-check before removal to minimize (not eliminate) the window
            # where a concurrent add repopulates the cache; worst case an
            # empty cache is left behind for LRU to collect.
            current = self._data.get(request_key)
            if current is not None:
                with current.mu:
                    still_empty = len(current.cache) == 0
                if still_empty:
                    self._data.remove(request_key)
                    self._engine_to_request.remove(engine_key)

    def get_request_key(self, engine_key: Key) -> Optional[Key]:
        return self._engine_to_request.get(engine_key)

    def remove_pod(self, pod_identifier: str) -> int:
        """One-pass quarantine purge (Index.remove_pod contract).

        Walks a snapshot of the key space; the same best-effort caveat as
        `evict` applies under concurrency (an add racing the pass can
        repopulate a key, which LRU then collects).
        """
        target = {pod_identifier}
        removed = 0
        emptied = set()
        for request_key, pod_cache in self._data.items():
            with pod_cache.mu:
                victims = [
                    e for e in pod_cache.cache.keys()
                    if pod_matches(e.pod_identifier, target)
                ]
                for entry in victims:
                    pod_cache.cache.remove(entry)
                removed += len(victims)
                is_empty = victims and len(pod_cache.cache) == 0
            if is_empty:
                self._data.remove(request_key)
                emptied.add(request_key)
        if emptied:
            for engine_key, request_key in self._engine_to_request.items():
                if request_key in emptied:
                    self._engine_to_request.remove(engine_key)
        return removed

    def export_view(self) -> IndexView:
        """Snapshot both LRUs oldest-first (Index.export_view contract)."""
        entries = []
        for request_key, pod_cache in self._data.items():
            with pod_cache.mu:
                pods = tuple(
                    (e.pod_identifier, e.device_tier)
                    for e in pod_cache.cache.keys()
                )
            entries.append((request_key.model_name, request_key.chunk_hash, pods))
        engine_map = [
            (ek.model_name, ek.chunk_hash, rk.model_name, rk.chunk_hash)
            for ek, rk in self._engine_to_request.items()
        ]
        return IndexView(entries=entries, engine_map=engine_map)
