"""KV-block index contract (port of the reference package's `Index`).

The index maps *request keys* to the set of pods (with device tier) holding
that block, and separately maps *engine keys* to request keys so eviction
events, which only carry engine hashes, can find their entries.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence, Set

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key, PodEntry


class Index(abc.ABC):
    """Thread-safe KV-block locality index."""

    @abc.abstractmethod
    def lookup(
        self, request_keys: Sequence[Key], pod_identifier_set: Set[str]
    ) -> Dict[Key, List[PodEntry]]:
        """Return pods per key, filtered to `pod_identifier_set` (empty = all).

        Walks keys in order; a missing key, or one with an empty pod set,
        cuts the search (the prefix chain broke there). Raises ValueError on
        empty input.
        """

    @abc.abstractmethod
    def add(
        self,
        engine_keys: Sequence[Key],
        request_keys: Sequence[Key],
        entries: Sequence[PodEntry],
    ) -> None:
        """Record that `entries` hold the given blocks (both key spaces)."""

    @abc.abstractmethod
    def evict(self, engine_key: Key, entries: Sequence[PodEntry]) -> None:
        """Remove `entries` from the block identified by its engine key."""

    @abc.abstractmethod
    def get_request_key(self, engine_key: Key) -> Optional[Key]:
        """Resolve an engine key to its request key, or None if unknown."""
