"""Metrics-instrumented index decorator.

Copy of the reference package's `kvcache/kvblock/instrumented.py`, after
the Go reference's instrumentedIndex
(pkg/kvcache/kvblock/instrumented_index.go): wraps any
Index, emitting admission/eviction counters and, per lookup, the latency plus
the maximum per-pod consecutive hit count.

The per-lookup pod hit-count walk is the expensive part: it re-scans every
(key, entry) pair of the result to rebuild a Counter from scratch, purely to
observe one histogram sample — measurable on a read path whose whole lookup
is ~75µs. Two changes keep the signal without the per-call tax:

- **Strided observation.** `hit_count_stride` observes
  `kvcache_index_max_pod_hit_count` every Nth lookup (1 = seed behavior,
  every call). The histogram is a distribution-shape signal; sampling it
  does not bias it.
- **Shared ingest.** When a placement popularity tracker is attached, the
  same walk that builds the hit counts feeds the tracker's block sketch
  (`observe_lookup`) — blocks that keep getting looked up *and found* are
  reuse evidence. One walk, two consumers; with neither due, no walk at all.
"""

from __future__ import annotations

import time
from collections import Counter as PyCounter
from typing import Dict, List, Optional, Sequence, Set

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key, PodEntry
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as m

DEFAULT_HIT_COUNT_STRIDE = 1


class InstrumentedIndex(Index):
    def __init__(
        self,
        inner: Index,
        hit_count_stride: int = DEFAULT_HIT_COUNT_STRIDE,
        popularity=None,
    ):
        self.inner = inner
        self.hit_count_stride = max(1, int(hit_count_stride))
        # Optional placement.ChainPopularityTracker: lookup hits feed its
        # block sketch through the same result walk the histogram uses.
        self.popularity = popularity
        self._lookup_count = 0

    def lookup(
        self, request_keys: Sequence[Key], pod_identifier_set: Set[str]
    ) -> Dict[Key, List[PodEntry]]:
        start = time.perf_counter()
        result = self.inner.lookup(request_keys, pod_identifier_set)
        elapsed = time.perf_counter() - start

        if m.index_lookup_requests is not None:
            m.index_lookup_requests.inc()
            m.index_lookup_latency.observe(elapsed)
            m.index_lookup_hits.inc(len(result))
            # Racy increment under concurrent readers only perturbs which
            # lookup gets sampled, never the count of samples per stride
            # window by more than the reader count.
            self._lookup_count += 1
            observe_hits = self._lookup_count % self.hit_count_stride == 0
            if observe_hits or self.popularity is not None:
                hit_counts: PyCounter = PyCounter()
                for entries in result.values():
                    for entry in entries:
                        hit_counts[entry.pod_identifier] += 1
                if observe_hits:
                    m.index_max_pod_hits.observe(
                        max(hit_counts.values()) if hit_counts else 0
                    )
                if self.popularity is not None and result:
                    self.popularity.observe_lookup(
                        [k.chunk_hash for k in result]
                    )
        return result

    def lookup_many(
        self, requests: Sequence[tuple]
    ) -> List[Dict[Key, List[PodEntry]]]:
        """Batched `lookup` (Index.lookup_many): delegates to the wrapped
        backend's batch path and observes ONE latency sample plus summed
        hit counters for the whole batch (requests counted per item). The
        max-pod-hit-count histogram samples at the same per-lookup stride,
        counting each item as one lookup."""
        start = time.perf_counter()
        results = self.inner.lookup_many(requests)
        elapsed = time.perf_counter() - start

        if m.index_lookup_requests is not None:
            m.index_lookup_requests.inc(len(requests))
            m.index_lookup_latency.observe(elapsed)
            m.index_lookup_hits.inc(sum(len(r) for r in results))
            before = self._lookup_count
            self._lookup_count = before + len(requests)
            observe_hits = (
                before // self.hit_count_stride
                != self._lookup_count // self.hit_count_stride
            )
            if observe_hits or self.popularity is not None:
                hit_counts: PyCounter = PyCounter()
                looked_up = set()
                for result in results:
                    for key, entries in result.items():
                        if key in looked_up:
                            continue  # shared entry lists: count keys once
                        looked_up.add(key)
                        for entry in entries:
                            hit_counts[entry.pod_identifier] += 1
                if observe_hits:
                    m.index_max_pod_hits.observe(
                        max(hit_counts.values()) if hit_counts else 0
                    )
                if self.popularity is not None and looked_up:
                    self.popularity.observe_lookup(
                        [k.chunk_hash for k in looked_up]
                    )
        return results

    def add(
        self,
        engine_keys: Sequence[Key],
        request_keys: Sequence[Key],
        entries: Sequence[PodEntry],
    ) -> None:
        self.inner.add(engine_keys, request_keys, entries)
        if m.index_admissions is not None:
            m.index_admissions.inc(len(request_keys))

    def evict(self, engine_key: Key, entries: Sequence[PodEntry]) -> None:
        self.inner.evict(engine_key, entries)
        if m.index_evictions is not None:
            m.index_evictions.inc()

    def get_request_key(self, engine_key: Key) -> Optional[Key]:
        return self.inner.get_request_key(engine_key)

    def remove_pod(self, pod_identifier: str) -> int:
        removed = self.inner.remove_pod(pod_identifier)
        if m.index_evictions is not None and removed:
            m.index_evictions.inc(removed)
        return removed

    def remove_entries(
        self, pod_identifier: str, request_keys, device_tiers=None
    ) -> int:
        removed = self.inner.remove_entries(
            pod_identifier, request_keys, device_tiers
        )
        if m.index_evictions is not None and removed:
            m.index_evictions.inc(removed)
        return removed

    def export_view(self):
        return self.inner.export_view()

    def import_view(self, view) -> int:
        imported = self.inner.import_view(view)
        if m.index_admissions is not None and imported:
            m.index_admissions.inc(imported)
        return imported
