"""Cost-aware (byte-budgeted) in-memory index.

Copy of the reference package's `kvcache/kvblock/cost_aware.py`: instead
of bounding the index by entry *count*, bound it by estimated resident
*bytes* (config accepts human-readable sizes like "2GiB"), with an LRU whose
eviction is driven by accumulated entry cost.
"""

from __future__ import annotations

import sys
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Union

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index, IndexView
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key, PodEntry, pod_matches
from llm_d_kv_cache_manager_tpu_torch.utils.humansize import parse_human_size
from llm_d_kv_cache_manager_tpu_torch.utils.lru import LRUCache

DEFAULT_MAX_SIZE = "1GiB"
DEFAULT_PODS_PER_KEY = 10

# Fixed per-object overheads (dict/list headers etc.) — an estimate.
_ENTRY_OVERHEAD = 64


def calculate_byte_size(key: Key, entries: Sequence[PodEntry]) -> int:
    size = _ENTRY_OVERHEAD + len(key.model_name) + 8
    for e in entries:
        size += _ENTRY_OVERHEAD + len(e.pod_identifier) + len(e.device_tier)
    return size


@dataclass
class CostAwareIndexConfig:
    max_size_bytes: Union[int, str] = DEFAULT_MAX_SIZE
    pod_cache_size: int = DEFAULT_PODS_PER_KEY
    # Popularity-weighted eviction (placement/): when a popularity tracker
    # is bound, pressure evicts the lowest-retention key among this many
    # LRU-oldest candidates instead of strictly the oldest. 1 (default)
    # is pure LRU — bit-identical to the pre-placement backend whether or
    # not a tracker is bound.
    eviction_sample: int = 1


class _CostedPodCache:
    __slots__ = ("cache", "mu", "cost")

    def __init__(self, capacity: int):
        self.cache: LRUCache[PodEntry, None] = LRUCache(capacity)
        self.mu = threading.Lock()
        self.cost = 0


class CostAwareMemoryIndex(Index):
    """Byte-budget-bounded index; evicts least-recently-used keys on pressure."""

    def __init__(self, config: Optional[CostAwareIndexConfig] = None):
        cfg = config or CostAwareIndexConfig()
        self._budget = parse_human_size(cfg.max_size_bytes)
        self._pod_cache_size = cfg.pod_cache_size
        self._eviction_sample = max(1, cfg.eviction_sample)
        self._data: "OrderedDict[Key, _CostedPodCache]" = OrderedDict()
        self._engine_to_request: Dict[Key, Key] = {}
        self._request_to_engines: Dict[Key, Set[Key]] = {}
        self._total_cost = 0
        self._mu = threading.Lock()
        # Placement integration (bind_popularity): eviction weighs decayed
        # block popularity against what re-landing the block would cost.
        self._popularity = None
        self._reland_cost_model = None
        self.eviction_stats = {"lru": 0, "weighted": 0}

    def bind_popularity(self, tracker, cost_model=None) -> None:
        """Attach a placement popularity tracker (and optionally an
        engine/costs.TransferCostModel) to eviction.

        Under byte pressure the victim becomes the key with the lowest
        *retention value* among the `eviction_sample` LRU-oldest
        candidates, where retention = decayed block popularity x the
        per-token seconds losing the placement would cost the fleet: with
        a cost model, `recompute_s` for a block only resident in device
        tiers, `staged_restore_s` when a host-tier copy exists (the
        knowledge is cheaper to rebuild, so the entry is less sticky);
        without one, popularity alone ranks the window. Hot replicated
        prefixes therefore stay pinned while the cold long tail drains in
        LRU order — and with `eviction_sample` left at 1 the backend stays
        bit-identical to pure LRU regardless of this binding."""
        self._popularity = tracker
        self._reland_cost_model = cost_model

    @property
    def total_cost_bytes(self) -> int:
        with self._mu:
            return self._total_cost

    def lookup(
        self, request_keys: Sequence[Key], pod_identifier_set: Set[str]
    ) -> Dict[Key, List[PodEntry]]:
        if not request_keys:
            raise ValueError("no request keys provided for lookup")
        pods_per_key: Dict[Key, List[PodEntry]] = {}
        with self._mu:
            for key in request_keys:
                pod_cache = self._data.get(key)
                if pod_cache is None:
                    return pods_per_key  # gap: post-gap hits can't score
                self._data.move_to_end(key)
                entries = pod_cache.cache.keys()
                if not entries:
                    return pods_per_key  # prefix chain breaks here
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
        """Batched `lookup` (Index.lookup_many): the global mutex is taken
        ONCE for the whole batch instead of once per item; per-item walk
        semantics (gap cut, filter, recency touch) are the single-call
        path's exactly. Items sharing a key share the entry list object
        (the scorer's batch path reuses weight maps through it)."""
        if not requests:
            return []
        out: List[Dict[Key, List[PodEntry]]] = []
        entries_cache: Dict[Key, list] = {}
        shared: dict = {}
        with self._mu:
            for request_keys, pod_identifier_set in requests:
                if not request_keys:
                    raise ValueError("no request keys provided for lookup")
                pods_per_key: Dict[Key, List[PodEntry]] = {}
                for key in request_keys:
                    pod_cache = self._data.get(key)
                    if pod_cache is None:
                        break  # gap: post-gap hits can't score
                    self._data.move_to_end(key)
                    entries = entries_cache.get(key)
                    if entries is None:
                        entries = entries_cache[key] = pod_cache.cache.keys()
                    if not entries:
                        break  # prefix chain breaks here
                    if pod_identifier_set:
                        sk = (id(pod_identifier_set), key)
                        hits = shared.get(sk)
                        if hits is None:
                            hits = shared[sk] = [
                                e for e in entries
                                if pod_matches(
                                    e.pod_identifier, pod_identifier_set
                                )
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
            raise ValueError("engine/request key length mismatch")

        with self._mu:
            for engine_key, request_key in zip(engine_keys, request_keys):
                self._engine_to_request[engine_key] = request_key
                self._request_to_engines.setdefault(request_key, set()).add(engine_key)

                pod_cache = self._data.get(request_key)
                if pod_cache is None:
                    pod_cache = _CostedPodCache(self._pod_cache_size)
                    self._data[request_key] = pod_cache
                else:
                    self._data.move_to_end(request_key)

                self._total_cost -= pod_cache.cost
                with pod_cache.mu:
                    for entry in entries:
                        pod_cache.cache.add(entry, None)
                    pod_cache.cost = calculate_byte_size(
                        request_key, pod_cache.cache.keys()
                    )
                self._total_cost += pod_cache.cost

            # Evict until under budget (LRU, or popularity-weighted within
            # the LRU sample window when a tracker is bound).
            self._evict_over_budget()

    def _evict_over_budget(self) -> None:
        """Shed keys until the byte budget holds (caller holds _mu)."""
        while self._total_cost > self._budget and len(self._data) > 1:
            victim = self._pick_victim()
            evicted_cache = self._data.pop(victim)
            self._total_cost -= evicted_cache.cost
            self._drop_engine_mappings(victim)

    def _pick_victim(self) -> Key:
        """LRU victim, unless a popularity tracker is bound AND the sample
        window is >1: then the lowest-retention key among the
        `eviction_sample` oldest (ties keep LRU order, so a tracker that
        scores everything equally degenerates to exact LRU)."""
        it = iter(self._data)
        oldest = next(it)
        if self._popularity is None or self._eviction_sample <= 1:
            self.eviction_stats["lru"] += 1
            return oldest
        self.eviction_stats["weighted"] += 1
        best_key, best_value = oldest, self._retention(oldest)
        for _ in range(self._eviction_sample - 1):
            key = next(it, None)
            if key is None:
                break
            value = self._retention(key)
            if value < best_value:
                best_key, best_value = key, value
        return best_key

    def _retention(self, key: Key) -> float:
        """Popularity x per-token re-landing cost for one key (see
        bind_popularity)."""
        pop = self._popularity.block_score(key.chunk_hash)
        model = self._reland_cost_model
        if model is None:
            return pop
        pod_cache = self._data[key]
        restorable = any(
            e.device_tier not in ("hbm", "gpu", "device")
            for e in pod_cache.cache.keys()
        )
        reland_s = model.staged_restore_s if restorable else model.recompute_s
        return pop * reland_s

    def evict(self, engine_key: Key, entries: Sequence[PodEntry]) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction from index")
        with self._mu:
            request_key = self._engine_to_request.get(engine_key)
            if request_key is None:
                return
            pod_cache = self._data.get(request_key)
            if pod_cache is None:
                self._engine_to_request.pop(engine_key, None)
                return
            self._total_cost -= pod_cache.cost
            with pod_cache.mu:
                for entry in entries:
                    pod_cache.cache.remove(entry)
                is_empty = len(pod_cache.cache) == 0
                pod_cache.cost = calculate_byte_size(
                    request_key, pod_cache.cache.keys()
                )
            self._total_cost += pod_cache.cost
            if is_empty:
                self._data.pop(request_key, None)
                self._total_cost -= pod_cache.cost
                self._drop_engine_mappings(request_key)

    def get_request_key(self, engine_key: Key) -> Optional[Key]:
        with self._mu:
            return self._engine_to_request.get(engine_key)

    def remove_pod(self, pod_identifier: str) -> int:
        """One-pass quarantine purge (Index.remove_pod contract); the byte
        budget is re-credited as entries leave."""
        target = {pod_identifier}
        removed = 0
        with self._mu:
            for request_key in list(self._data):
                pod_cache = self._data[request_key]
                self._total_cost -= pod_cache.cost
                with pod_cache.mu:
                    victims = [
                        e for e in pod_cache.cache.keys()
                        if pod_matches(e.pod_identifier, target)
                    ]
                    for entry in victims:
                        pod_cache.cache.remove(entry)
                    removed += len(victims)
                    is_empty = len(pod_cache.cache) == 0
                    pod_cache.cost = calculate_byte_size(
                        request_key, pod_cache.cache.keys()
                    )
                self._total_cost += pod_cache.cost
                if is_empty:
                    self._data.pop(request_key, None)
                    self._total_cost -= pod_cache.cost
                    self._drop_engine_mappings(request_key)
        return removed

    def remove_entries(
        self, pod_identifier: str, request_keys, device_tiers=None
    ) -> int:
        """Targeted purge (Index.remove_entries contract); each touched
        key is re-costed and the byte budget re-credited as entries leave
        — a phantom purge frees exactly the budget those entries were
        charged. Plain dict gets, so untouched keys keep recency order."""
        target = {pod_identifier}
        removed = 0
        with self._mu:
            for request_key in request_keys:
                pod_cache = self._data.get(request_key)
                if pod_cache is None:
                    continue
                self._total_cost -= pod_cache.cost
                with pod_cache.mu:
                    victims = [
                        e for e in pod_cache.cache.keys()
                        if pod_matches(e.pod_identifier, target)
                        and (
                            device_tiers is None
                            or e.device_tier in device_tiers
                        )
                    ]
                    for entry in victims:
                        pod_cache.cache.remove(entry)
                    removed += len(victims)
                    is_empty = len(pod_cache.cache) == 0
                    pod_cache.cost = calculate_byte_size(
                        request_key, pod_cache.cache.keys()
                    )
                self._total_cost += pod_cache.cost
                if is_empty:
                    self._data.pop(request_key, None)
                    self._total_cost -= pod_cache.cost
                    self._drop_engine_mappings(request_key)
        return removed

    def export_view(self) -> IndexView:
        """Snapshot oldest-first (Index.export_view contract); cost
        bookkeeping is derived state and is recomputed on import."""
        entries = []
        engine_map = []
        with self._mu:
            for request_key, pod_cache in self._data.items():
                with pod_cache.mu:
                    pods = tuple(
                        (e.pod_identifier, e.device_tier)
                        for e in pod_cache.cache.keys()
                    )
                entries.append(
                    (request_key.model_name, request_key.chunk_hash, pods)
                )
            engine_map = [
                (ek.model_name, ek.chunk_hash, rk.model_name, rk.chunk_hash)
                for ek, rk in self._engine_to_request.items()
            ]
        return IndexView(entries=entries, engine_map=engine_map)

    def import_view(self, view: IndexView) -> int:
        """Rebuild in view order, recosting each key and re-running the
        byte-budget eviction sweep at the end (Index.import_view) — a
        snapshot from a larger-budget replica imports to the newest
        entries that fit, not over budget."""
        imported = 0
        with self._mu:
            for model_name, chunk_hash, pods in view.entries:
                request_key = Key(model_name, chunk_hash)
                pod_cache = self._data.get(request_key)
                if pod_cache is None:
                    pod_cache = _CostedPodCache(self._pod_cache_size)
                    self._data[request_key] = pod_cache
                else:
                    self._data.move_to_end(request_key)
                self._total_cost -= pod_cache.cost
                with pod_cache.mu:
                    for pod, tier in pods:
                        pod_cache.cache.add(PodEntry(pod, tier), None)
                        imported += 1
                    pod_cache.cost = calculate_byte_size(
                        request_key, pod_cache.cache.keys()
                    )
                self._total_cost += pod_cache.cost
            for engine_model, engine_hash, req_model, req_hash in view.engine_map:
                engine_key = Key(engine_model, engine_hash)
                request_key = Key(req_model, req_hash)
                self._engine_to_request[engine_key] = request_key
                self._request_to_engines.setdefault(request_key, set()).add(
                    engine_key
                )
            self._evict_over_budget()
        return imported

    def _drop_engine_mappings(self, request_key: Key) -> None:
        for engine_key in self._request_to_engines.pop(request_key, ()):  # noqa: B020
            self._engine_to_request.pop(engine_key, None)
