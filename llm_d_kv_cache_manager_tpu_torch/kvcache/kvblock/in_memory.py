"""Default in-memory KV-block index: two-level LRU.

Port of the reference package's `InMemoryIndex` (add, evict, lookup): an LRU
of request-key -> per-key pod LRU (capped, default 10 pods/key), plus an LRU
mapping engine keys -> request keys.

- lookup: a missing key, or a key present with an empty pod cache, cuts the
  search (`LongestPrefixScorer` empties its active set at any gap, so later
  hits could never contribute).
- add: double-checked insertion so concurrent adders share one pod cache.
- evict: resolves engine->request key; removing the last pod removes the key
  from both maps (with a re-check to shrink the race window).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import (
    Key,
    PodEntry,
    pod_matches,
)
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog
from llm_d_kv_cache_manager_tpu_torch.utils.lru import LRUCache

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
                f"engine/request key length mismatch: {len(engine_keys)} != "
                f"{len(request_keys)}"
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
            kvlog.trace(
                logger, "engine key not in index, nothing to evict: %s", engine_key
            )
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
            # Re-check before removal to shrink the window where a
            # concurrent add repopulates the cache.
            current = self._data.get(request_key)
            if current is not None:
                with current.mu:
                    still_empty = len(current.cache) == 0
                if still_empty:
                    self._data.remove(request_key)
                    self._engine_to_request.remove(engine_key)

    def get_request_key(self, engine_key: Key) -> Optional[Key]:
        return self._engine_to_request.get(engine_key)
