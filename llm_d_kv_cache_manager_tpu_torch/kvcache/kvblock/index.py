"""KV-block index contract + backend selection.

Copy of the reference package's `kvcache/kvblock/index.py`. The index maps
*request keys* to the set of pods (with device tier) holding that block,
and separately maps *engine keys* to request keys so eviction events —
which only carry engine hashes — can find their entries.

Backend selection order is the reference's: in-memory → cost-aware →
redis/valkey, first configured wins; metrics wrapping is applied last. The
in-memory backend is the lock-striped `ShardedIndex` that
`IndexConfig.default()` selects, the single-lock `InMemoryIndex` with
`sharded=False`, or the C arena's `NativeScoringIndex` with `native=True`
(built on first use; a failed build raises rather than falling back to
another backend).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key, PodEntry


class Index(abc.ABC):
    """Thread-safe KV-block locality index."""

    @abc.abstractmethod
    def lookup(
        self, request_keys: Sequence[Key], pod_identifier_set: Set[str]
    ) -> Dict[Key, List[PodEntry]]:
        """Return pods per key, filtered to `pod_identifier_set` (empty = all).

        Walks keys in order; a key that exists with an empty pod set cuts the
        search (prefix chain broke there). Raises ValueError on empty input.
        """

    def lookup_many(
        self, requests: Sequence[Tuple[Sequence[Key], Set[str]]]
    ) -> List[Dict[Key, Sequence[PodEntry]]]:
        """Batched `lookup` (the `score_many` read path): one
        `(request_keys, pod_identifier_set)` pair per router-batch item,
        one result dict per item, each carrying the same entries in the
        same order as a standalone `lookup` over the same state (per-item
        cut semantics preserved; a backend may hand back immutable tuples
        where `lookup` copies into fresh lists).

        This default runs the per-item loop — correct on any backend.
        Backends with a lock to amortize override it: the sharded index
        crosses each touched segment lock at most once per BATCH, the
        cost-aware index takes its global mutex once, and the Redis index
        folds the whole batch into a single pipelined round trip."""
        return [self.lookup(keys, pods) for keys, pods in requests]

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

    def remove_entries(
        self,
        pod_identifier: str,
        request_keys: Sequence[Key],
        device_tiers: Optional[Set[str]] = None,
    ) -> int:
        """Targeted purge: remove `pod_identifier`'s entries for exactly
        the given request keys (optionally only entries whose tier is in
        `device_tiers`; None = all tiers).

        The anti-entropy repair primitive (antientropy/): where
        `remove_pod` quarantines a whole pod, this surgically drops the
        specific (pod, block) placements that fetch-miss feedback or a
        residency audit proved phantom — the pod's OTHER placements keep
        scoring. Pod matching follows `remove_pod` semantics (a bare pod
        name also matches its DP-ranked identities; `key.pod_matches`).
        Keys left with no pods are dropped from both key spaces, exactly
        as if the view had been exported, filtered, and re-imported.
        Keys the pod has no entry for are no-ops. Returns the number of pod
        entries removed.
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not support remove_entries"
        )

    @abc.abstractmethod
    def remove_pod(self, pod_identifier: str) -> int:
        """Bulk-purge every entry `pod_identifier` holds, in one pass.

        The quarantine primitive (fleethealth/tracker.py): when a pod is
        declared stale/dead its placements must stop scoring NOW, not leak
        until LRU churn or per-block removal events that will never arrive.
        A bare pod name also removes its DP-ranked identities ("pod@dpN");
        a ranked name removes only that rank (`key.pod_matches` semantics,
        same as lookup filters). Keys left with no pods are dropped from
        both key spaces. Returns the number of pod entries removed.
        """

    def export_view(self) -> "IndexView":
        """Project the published read state into a portable `IndexView`.

        Entries come out in recency order (oldest first). Best-effort under
        concurrent writers — like `remove_pod`, a racing add may or may
        not be captured; warm-restart callers snapshot a quiesced or
        drained index.
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not support export_view"
        )

    def import_view(self, view: "IndexView") -> int:
        """Load an `export_view` projection into this (fresh) backend.

        Entries are applied oldest-first, re-establishing both key spaces
        and recency order. Import targets an EMPTY index: existing entries
        are kept (imports merge), but recency interleaving with pre-import
        state is unspecified. Returns the number of pod entries imported.
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not support import_view"
        )


@dataclass
class IndexView:
    """Portable projection of an index's read state (export/import_view).

    `entries` holds one row per request key — ``(model_name, chunk_hash,
    ((pod_identifier, device_tier), ...))`` — in recency order, oldest
    first, with each key's pod tuple likewise oldest-first (the order
    `LRUCache.keys()` publishes). `engine_map` rows are
    ``(engine_model, engine_hash, request_model, request_hash)``. Plain
    strings/ints only, so the view serializes without backend knowledge.
    """

    entries: List[tuple] = field(default_factory=list)
    engine_map: List[tuple] = field(default_factory=list)

    def entry_count(self) -> int:
        """Total pod entries across all keys (the unit `remove_pod` and
        `import_view` count in)."""
        return sum(len(row[2]) for row in self.entries)


@dataclass
class IndexConfig:
    """First non-None backend wins, in field order."""

    in_memory_config: Optional["InMemoryIndexConfig"] = None
    cost_aware_config: Optional["CostAwareIndexConfig"] = None
    redis_config: Optional["RedisIndexConfig"] = None
    enable_metrics: bool = False
    metrics_logging_interval_s: float = 60.0
    # InstrumentedIndex: observe kvcache_index_max_pod_hit_count every Nth
    # lookup (the per-lookup pod hit-count walk is the one O(result) pass
    # the wrapper adds; 1 = every call, the historical behavior).
    metrics_hit_count_stride: int = 1
    # In-memory striping (kvblock/sharded.py). When the in-memory backend is
    # selected (explicitly or by default), `sharded=True` builds a
    # lock-striped ShardedIndex over `num_shards` segments instead of the
    # single-lock InMemoryIndex; scores are identical, only contention
    # behavior changes. `recency_refresh_interval` is the touch=False read
    # fast path's refresh cadence (1 = touch every lookup, seed behavior).
    sharded: bool = True
    num_shards: int = 16  # DEFAULT_NUM_SHARDS (sharded.py)
    recency_refresh_interval: int = 64  # DEFAULT_RECENCY_REFRESH (sharded.py)
    # Native scoring core (kvblock/native_index.py): when the in-memory
    # backend is selected, back the index with the C arena so the whole
    # read path (lookup + score + per-pod adjustments) and event digestion
    # run in single GIL-released crossings. Scores are bit-identical to the
    # Python backends.
    native: bool = False

    @classmethod
    def default(cls) -> "IndexConfig":
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import (
            InMemoryIndexConfig,
        )

        return cls(in_memory_config=InMemoryIndexConfig())


def new_index(config: Optional[IndexConfig] = None) -> Index:
    """Build the configured index backend, optionally metrics-instrumented."""
    if config is None:
        config = IndexConfig.default()

    index: Optional[Index] = None
    if config.in_memory_config is not None:
        index = _new_memory_index(config, config.in_memory_config)
    elif config.cost_aware_config is not None:
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.cost_aware import (
            CostAwareMemoryIndex,
        )

        index = CostAwareMemoryIndex(config.cost_aware_config)
    elif config.redis_config is not None:
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.redis_index import RedisIndex

        index = RedisIndex(config.redis_config)
    else:
        index = _new_memory_index(config, None)

    if config.enable_metrics:
        from llm_d_kv_cache_manager_tpu_torch.metrics.collector import (
            register_metrics,
            start_metrics_logging,
        )
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.instrumented import (
            InstrumentedIndex,
        )

        register_metrics()
        start_metrics_logging(config.metrics_logging_interval_s)
        index = InstrumentedIndex(
            index, hit_count_stride=config.metrics_hit_count_stride
        )

    return index


def _new_memory_index(config: IndexConfig, in_memory_config) -> Index:
    """In-memory backend: lock-striped ShardedIndex by default, the
    single-lock InMemoryIndex when `config.sharded` is off."""
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import (
        InMemoryIndex,
        InMemoryIndexConfig,
    )

    if config.native:
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.native_index import (
            NativeIndexConfig,
            NativeScoringIndex,
        )

        imc = in_memory_config or InMemoryIndexConfig()
        return NativeScoringIndex(NativeIndexConfig(
            size=imc.size, pod_cache_size=imc.pod_cache_size,
        ))

    if not config.sharded:
        return InMemoryIndex(in_memory_config)

    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.sharded import (
        ShardedIndex,
        ShardedIndexConfig,
    )

    imc = in_memory_config or InMemoryIndexConfig()
    return ShardedIndex(ShardedIndexConfig(
        size=imc.size,
        pod_cache_size=imc.pod_cache_size,
        num_shards=config.num_shards,
        recency_refresh_interval=config.recency_refresh_interval,
    ))
