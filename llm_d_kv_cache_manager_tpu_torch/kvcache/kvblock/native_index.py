"""Arena-backed native scoring index: both hot loops in one C crossing.

Copy of the reference package's `kvcache/kvblock/native_index.py`.
`NativeScoringIndex` is a full `Index` backend whose published read state
lives in a C arena (`native/kvscore.c`, built by the port on first use as
`llm_d_kv_cache_manager_tpu_torch._kvtpu_kvscore`, `ops/_build.py`) instead
of Python dict-of-LRU structures. Two entry points collapse the paths that
previously bounced between Python orchestration and C islands:

- **`score_plan`** — the router read path. For a whole `score_many` batch,
  lookup + longest-prefix scoring + the per-pod scalar adjustments
  (fleet-health demotion, anti-entropy accuracy factors, routing-policy
  load demotion) run in ONE GIL-released crossing. The scalar pipelines
  ride along as per-pod factor tables built from the trackers' new
  `score_factors` / `score_divisors` hooks, so scoring never drops back
  into Python between the lookup and the final score map.
- **`apply_batch`** — the event write path. Decoded BlockStored /
  BlockRemoved batches are applied against the same arena with request
  keys chain-derived in C (`kvhash.h`, bit-identical to the
  token_processor), readers staying lock-free throughout (per-node
  seqlocks + a structural epoch instead of `sharded.py`'s GIL-atomic
  published tuples).

Strings never cross into C: pods, tiers and models are interned to dense
ids here (ids from 1; 0 is the C empty sentinel) and entries travel as
`(pod_id << 16) | tier_id` packed ints, exactly the view layout the arena
stores. Boxing back to `PodEntry`/score dicts happens on the way out.

Parity contract: every surface is bit-identical to `ShardedIndex` + the
Python scorer/adjustment pipeline, with these documented nuances:

- `score_plan` reads each tracker's factor table once per BATCH (one
  clock read), where the Python path re-reads per item. Identical under
  the frozen clocks the property suites use; immaterial drift otherwise.
- fleet-health demotion modes are computed from the tracker's *expected*
  state without advancing it, and the real `refresh()` — including its
  auto-quarantine purges — runs after the crossing. That preserves the
  Python batch path's ordering, where every lookup happens before the
  first `filter_scores` can purge a newly-stale pod.
- lookups through the native path don't touch per-key recency (the
  sharded backend refreshes recency every Nth read); recency is still
  maintained by adds, evictions and digestion, which is what capacity
  eviction order actually keys off in practice.

The pure-Python path is retained behind `IndexConfig.native`. One
deliberate difference from the reference: where its `new_index` degrades
silently to the Python backend when the module is not built, the port
builds the module on first use and raises, with the compiler's log, when
the build fails.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index, IndexView
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import (
    Key,
    PodEntry,
    pod_matches,
)

def _module():
    """The arena module (`native/kvscore.c`), built and loaded on first use;
    a failed build raises with the compiler's log."""
    from llm_d_kv_cache_manager_tpu_torch.ops import _build

    return _build.extension("_kvtpu_kvscore")


def have_native_index() -> bool:
    """True once the arena module is loaded (built on first use; a failed
    build raises)."""
    _module()
    return True


# Process-wide count of batches handed back to the pure-Python path —
# mirrored into kvcache_native_fallbacks_total when metrics are
# registered, kept as a plain int so /readyz can report it either way.
_fallbacks = 0
_fallbacks_mu = threading.Lock()


def count_fallback() -> None:
    global _fallbacks
    with _fallbacks_mu:
        _fallbacks += 1
    from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics

    metrics.count_native_fallback()


def fallback_total() -> int:
    return _fallbacks


_TIER_MASK = 0xFFFF
_FILTER_CACHE_MAX = 256


@dataclass
class NativeIndexConfig:
    """Capacity knobs, mirroring InMemoryIndexConfig: `size` request keys,
    `pod_cache_size` pod entries per key (the per-key LRU width)."""

    size: int = 10**8
    pod_cache_size: int = 10


class _Interner:
    """str <-> dense-id table. Ids start at 1 (0 = C empty sentinel);
    `by_id[0]` is None. Mutations happen under the owning index's lock;
    reads are GIL-atomic (ids are only published after the string is)."""

    __slots__ = ("ids", "by_id")

    def __init__(self) -> None:
        self.ids: Dict[str, int] = {}
        self.by_id: List[Optional[str]] = [None]

    def intern(self, s: str) -> int:
        i = self.ids.get(s)
        if i is None:
            self.by_id.append(s)
            i = self.ids[s] = len(self.by_id) - 1
        return i


class NativeScoringIndex(Index):
    """`Index` backend over the C arena, plus the fused read/write paths."""

    def __init__(self, config: Optional[NativeIndexConfig] = None):
        self.config = config or NativeIndexConfig()
        self._arena = _module().Arena(
            max_keys=self.config.size,
            pods_per_key=self.config.pod_cache_size,
        )
        self._mu = threading.Lock()
        self._pods = _Interner()
        self._tiers = _Interner()
        self._models = _Interner()
        # Bumped when a NEW pod is interned: invalidates the lex-rank
        # table and the filter-bitmap cache (both are sized/keyed by the
        # pod id space).
        self._pod_epoch = 0
        self._lex_cache: Optional[Tuple[int, List[int]]] = None
        self._filter_cache: Dict[tuple, bytes] = {}
        self._filter_epoch = -1

    # -- interning ---------------------------------------------------------

    def intern_entry(self, pod_identifier: str, device_tier: str) -> int:
        """Packed `(pod_id << 16) | tier_id` for an entry, interning both
        strings. The event-pool digest seam packs entries with this before
        handing shaped batches to `apply_batch`."""
        with self._mu:
            pid = self._pod_id_locked(pod_identifier)
            tid = self._tiers.intern(device_tier)
            if tid > _TIER_MASK:
                raise ValueError("too many distinct device tiers")
        return (pid << 16) | tid

    def model_id(self, model_name: str) -> int:
        with self._mu:
            return self._models.intern(model_name)

    def _pod_id_locked(self, pod: str) -> int:
        i = self._pods.ids.get(pod)
        if i is None:
            self._pods.by_id.append(pod)
            i = self._pods.ids[pod] = len(self._pods.by_id) - 1
            self._pod_epoch += 1
        return i

    def _box_entry(self, packed: int) -> PodEntry:
        return PodEntry(
            self._pods.by_id[packed >> 16],
            self._tiers.by_id[packed & _TIER_MASK],
        )

    def _pod_bitmap_locked(self, pod_set) -> bytes:
        """LSB-first bitmap over pod ids where `pod_matches` accepts the
        interned pod. Ids interned after sizing read as not-matching in C
        (they cannot hold entries the caller could have meant)."""
        by_id = self._pods.by_id
        n = len(by_id)
        bm = bytearray((n + 7) // 8)
        for i in range(1, n):
            if pod_matches(by_id[i], pod_set):
                bm[i >> 3] |= 1 << (i & 7)
        return bytes(bm)

    def _filter_bitmap(self, pods: tuple) -> Optional[bytes]:
        """Cached per-(pod-set, intern-epoch) lookup filter; empty set =
        no filter (None)."""
        if not pods:
            return None
        with self._mu:
            if self._filter_epoch != self._pod_epoch:
                self._filter_cache.clear()
                self._filter_epoch = self._pod_epoch
            bm = self._filter_cache.get(pods)
            if bm is None:
                if len(self._filter_cache) >= _FILTER_CACHE_MAX:
                    self._filter_cache.clear()
                bm = self._pod_bitmap_locked(set(pods))
                self._filter_cache[pods] = bm
        return bm

    def _lex_rank_table(self) -> List[int]:
        """`table[pod_id]` = rank of the pod string in sorted order — the
        C-side stand-in for Python's lexicographic-min argmax tie-break.
        Cached per intern epoch."""
        with self._mu:
            epoch = self._pod_epoch
            cached = self._lex_cache
            if cached is not None and cached[0] == epoch:
                return cached[1]
            names = self._pods.by_id[1:]
            order = sorted(range(len(names)), key=lambda i: names[i])
            table = [len(names)] * (len(names) + 1)
            for rank, idx in enumerate(order):
                table[idx + 1] = rank
            self._lex_cache = (epoch, table)
            return table

    # -- Index contract ----------------------------------------------------

    def lookup(
        self, request_keys: Sequence[Key], pod_identifier_set: Set[str]
    ) -> Dict[Key, List[PodEntry]]:
        if not request_keys:
            raise ValueError("no request keys provided for lookup")
        result: Dict[Key, List[PodEntry]] = {}
        pods = pod_identifier_set
        i, n = 0, len(request_keys)
        while i < n:
            # One lock-free C crossing per run of same-model keys (a
            # router request's chain is single-model; segmentation only
            # matters for hand-built mixed batches).
            model = request_keys[i].model_name
            j = i
            while j < n and request_keys[j].model_name == model:
                j += 1
            mid = self._models.ids.get(model)
            if mid is None:
                break  # unknown model: first key misses -> chain cut
            chains = self._arena.lookup_chain(
                mid, [k.chunk_hash for k in request_keys[i:j]]
            )
            for off, packed_row in enumerate(chains):
                entries = [self._box_entry(p) for p in packed_row]
                if pods:
                    hits = [
                        e for e in entries
                        if pod_matches(e.pod_identifier, pods)
                    ]
                else:
                    hits = entries
                # Filtered-to-empty keys are omitted but do NOT cut the
                # walk (sharded.py semantics); a missing key already cut
                # inside lookup_chain.
                if hits:
                    result[request_keys[i + off]] = hits
            if len(chains) < j - i:
                break
            i = j
        return result

    def add(
        self,
        engine_keys: Sequence[Key],
        request_keys: Sequence[Key],
        entries: Sequence[PodEntry],
    ) -> None:
        eng = [
            (self.model_id(k.model_name), k.chunk_hash) for k in engine_keys
        ]
        req = [
            (self.model_id(k.model_name), k.chunk_hash) for k in request_keys
        ]
        packed = [
            self.intern_entry(e.pod_identifier, e.device_tier)
            for e in entries
        ]
        # The arena raises the contract ValueErrors (empty input, engine/
        # request length mismatch) with the backends' exact messages.
        self._arena.add(eng, req, packed)

    def evict(self, engine_key: Key, entries: Sequence[PodEntry]) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction from index")
        mid = self._models.ids.get(engine_key.model_name)
        if mid is None:
            return  # unknown engine key: no-op, like the Python backends
        packed = [
            self.intern_entry(e.pod_identifier, e.device_tier)
            for e in entries
        ]
        self._arena.evict(mid, engine_key.chunk_hash, packed)

    def get_request_key(self, engine_key: Key) -> Optional[Key]:
        mid = self._models.ids.get(engine_key.model_name)
        if mid is None:
            return None
        res = self._arena.get_request_key(mid, engine_key.chunk_hash)
        if res is None:
            return None
        rm, rh = res
        return Key(self._models.by_id[rm], rh)

    def remove_pod(self, pod_identifier: str) -> int:
        with self._mu:
            bm = self._pod_bitmap_locked({pod_identifier})
        if not any(bm):
            return 0
        return self._arena.remove_matching(bm, None, None)

    def remove_entries(
        self,
        pod_identifier: str,
        request_keys: Sequence[Key],
        device_tiers: Optional[Set[str]] = None,
    ) -> int:
        with self._mu:
            bm = self._pod_bitmap_locked({pod_identifier})
        if not any(bm):
            return 0
        tier_bm: Optional[bytes] = None
        if device_tiers is not None:
            by_id = self._tiers.by_id
            tbm = bytearray((len(by_id) + 7) // 8)
            for i in range(1, len(by_id)):
                if by_id[i] in device_tiers:
                    tbm[i >> 3] |= 1 << (i & 7)
            tier_bm = bytes(tbm)
        pairs = []
        for k in request_keys:
            mid = self._models.ids.get(k.model_name)
            if mid is not None:
                pairs.append((mid, k.chunk_hash))
        if not pairs:
            return 0
        return self._arena.remove_matching(bm, tier_bm, pairs)

    def export_view(self) -> IndexView:
        entry_rows, engine_rows = self._arena.dump()
        models = self._models.by_id
        entries = [
            (
                models[m],
                h,
                tuple(
                    (
                        self._pods.by_id[p >> 16],
                        self._tiers.by_id[p & _TIER_MASK],
                    )
                    for p in packed
                ),
            )
            for (m, h, packed) in entry_rows
        ]
        engine_map = [
            (models[m], h, models[rm], rh)
            for (m, h, rm, rh) in engine_rows
        ]
        return IndexView(entries=entries, engine_map=engine_map)

    def import_view(self, view: IndexView) -> int:
        count = 0
        for model, chunk_hash, pods in view.entries:
            mid = self.model_id(model)
            packed = [self.intern_entry(p, t) for (p, t) in pods]
            count += self._arena.seed_key(mid, chunk_hash, packed)
        for em, eh, rm, rh in view.engine_map:
            self._arena.seed_engine(
                self.model_id(em), eh, self.model_id(rm), rh
            )
        return count

    # -- fused read path ---------------------------------------------------

    def score_plan(
        self,
        plan_specs: Sequence[dict],
        medium_weights: Optional[Dict[str, float]],
        fleet_health=None,
        antientropy=None,
        routing_policy=None,
    ) -> List[Tuple[Dict[str, float], Dict[str, int]]]:
        """The whole router batch in one GIL-released crossing.

        `plan_specs` are the indexer's per-item plan dicts (solo items
        carry `keys`/`pods`; fork items add `ref`/`shared`/`tail`; items
        later forked from are flagged `forked`). Returns one
        `(scores, match_blocks)` pair per spec, bit-identical to
        lookup_many -> score_plan -> filter_scores -> adjust_scores ->
        adjust on the Python path. Trackers participate through their
        factor-table hooks (`score_factors` / `score_divisors`); a
        tracker without the hook raises AttributeError, which the
        indexer's fallback seam converts into a counted Python-path
        retry."""
        by_id = self._pods.by_id
        n_pods = len(by_id)

        tiers = self._tiers.by_id
        if medium_weights:
            tier_w = [
                1.0 if t is None else medium_weights.get(t, 1.0)
                for t in tiers
            ]
        else:
            tier_w = [1.0] * len(tiers)

        health_modes = None
        health_factor = 1.0
        if fleet_health is not None:
            health_modes, health_factor = fleet_health.score_factors(
                by_id[:n_pods]
            )
        ae_factors = None
        if antientropy is not None:
            ae_factors = antientropy.score_factors(by_id[:n_pods])
        divisors = None
        if routing_policy is not None:
            divisors = routing_policy.score_divisors(by_id[:n_pods])

        items = []
        for spec in plan_specs:
            keys = spec["keys"]
            model = keys[0].model_name if keys else ""
            mid = self._models.ids.get(model, 0)  # 0 never matches a node
            ref = spec.get("ref")
            if ref is None:
                hashes = [k.chunk_hash for k in keys]
                ref_pos, shared = -1, 0
            else:
                hashes = [k.chunk_hash for k in spec["tail"]]
                ref_pos, shared = ref, spec["shared"]
            items.append((
                mid,
                hashes,
                self._filter_bitmap(spec["pods"]),
                ref_pos,
                shared,
                bool(spec.get("forked")),
            ))

        raw = self._arena.score_batch(
            items,
            tier_w,
            self._lex_rank_table(),
            health_factor,
            health_modes,
            ae_factors,
            divisors,
        )

        out: List[Tuple[Dict[str, float], Dict[str, int]]] = []
        n_adjusted = 0
        n_overrides = 0
        any_scored = False
        for rows, override, routing_ran in raw:
            scores: Dict[str, float] = {}
            match: Dict[str, int] = {}
            for pid, score, m, dropped in rows:
                pod = by_id[pid]
                match[pod] = m
                if not dropped:
                    scores[pod] = score
            if rows:
                any_scored = True
            n_adjusted += routing_ran
            n_overrides += override
            out.append((scores, match))

        if routing_policy is not None and n_adjusted:
            routing_policy.note_adjusted(n_adjusted, n_overrides)
        # Deferred state machine: the Python path's first non-empty
        # filter_scores call runs refresh() (transitions + auto-quarantine
        # purges) AFTER all of this batch's lookups already happened.
        # score_factors above only *peeked* at expected states; run the
        # real refresh now so purges land with the same ordering.
        if fleet_health is not None and any_scored:
            fleet_health.refresh()
        return out

    # -- fused write path --------------------------------------------------

    def apply_batch(
        self,
        model_name: str,
        root_hash: int,
        block_size: int,
        events: Sequence[tuple],
    ) -> int:
        """Apply shaped BlockStored/BlockRemoved tuples (see kvscore.c
        `apply_batch`) under one crossing; returns blocks applied. Raises
        on conversion errors with the arena untouched, so the event pool
        can fall back to the pure-Python digest for the same batch."""
        return self._arena.apply_batch(
            self.model_id(model_name), root_hash, block_size, events
        )

    # -- introspection -----------------------------------------------------

    def native_status(self) -> dict:
        """Arena occupancy/health for /readyz and /debug/score_explain."""
        st = self._arena.stats()
        st["enabled"] = True
        st["interned_pods"] = len(self._pods.by_id) - 1
        st["interned_tiers"] = len(self._tiers.by_id) - 1
        st["interned_models"] = len(self._models.by_id) - 1
        return st

    def stats(self) -> dict:
        return self._arena.stats()
