"""Pod scoring from block lookup results.

Copy of the reference package's `LongestPrefixScorer`: walk block keys in
prompt order; only pods present for block 0 start "active"; each subsequent
block intersects the active set; every hit adds the pod's maximum device-tier
weight for that block (unknown tiers default to 1.0). Pods that drop out keep
the score accumulated so far — the score is the weighted length of the longest
consecutive cached prefix.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.backend import (
    KVCacheBackendConfig,
    default_kv_cache_backend_configs,
    weight_map,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key, PodEntry

LONGEST_PREFIX_MATCH = "LongestPrefix"


@dataclass
class KVBlockScorerConfig:
    scoring_strategy: str = LONGEST_PREFIX_MATCH
    backend_configs: List[KVCacheBackendConfig] = field(
        default_factory=default_kv_cache_backend_configs
    )


def _pod_max_weights(
    entries: Sequence[PodEntry], weights: Dict[str, float]
) -> Dict[str, float]:
    """One pass over a key's entries → {pod: max device-tier weight}.

    Replaces the per-pod `_max_weight` rescan (O(pods × entries) per key)
    with a single O(entries) pass; scores are bit-identical because the
    same max is taken over the same floats before any addition happens.
    """
    best: Dict[str, float] = {}
    for entry in entries:
        w = weights.get(entry.device_tier, 1.0)
        pod = entry.pod_identifier
        prev = best.get(pod)
        if prev is None or w > prev:
            best[pod] = w
    return best


class LongestPrefixScorer:
    strategy = LONGEST_PREFIX_MATCH

    def __init__(self, medium_weights: Dict[str, float]):
        self.medium_weights = medium_weights

    def score(
        self,
        keys: Sequence[Key],
        key_to_pods: Dict[Key, List[PodEntry]],
    ) -> Dict[str, float]:
        if not keys:
            return {}

        weights = self.medium_weights
        scores = _pod_max_weights(key_to_pods.get(keys[0], []), weights)
        active = set(scores)

        for key in keys[1:]:
            if not active:
                break
            here = _pod_max_weights(key_to_pods.get(key, []), weights)
            active &= here.keys()
            for pod in active:
                scores[pod] += here[pod]

        # Pods that dropped out keep the score accumulated so far; pods that
        # never held block 0 were never admitted to `scores`.
        return scores

    def score_ex(
        self,
        keys: Sequence[Key],
        key_to_pods: Dict[Key, List[PodEntry]],
    ) -> Tuple[Dict[str, float], Dict[str, int]]:
        """(scores, match_blocks): `scores` is bit-identical to `score()`
        (same maxes over the same floats, same addition order);
        `match_blocks[pod]` is the pod's matched-prefix LENGTH in blocks —
        how many consecutive leading keys it holds. The scorer walks that
        prefix anyway to accumulate the score; keeping the count is what
        lets the router hand the data plane the exact tail of the chain
        the chosen pod will miss (the route-driven prefetch), instead of
        throwing the information away after ranking."""
        if not keys:
            return {}, {}

        weights = self.medium_weights
        scores = _pod_max_weights(key_to_pods.get(keys[0], []), weights)
        active = set(scores)
        match = dict.fromkeys(active, 1)

        for key in keys[1:]:
            if not active:
                break
            here = _pod_max_weights(key_to_pods.get(key, []), weights)
            active &= here.keys()
            for pod in active:
                scores[pod] += here[pod]
                match[pod] += 1

        return scores, match

    def score_many_ex(
        self,
        items: Sequence[Tuple[Sequence[Key], Dict[Key, List[PodEntry]]]],
    ) -> List[Tuple[Dict[str, float], Dict[str, int]]]:
        """Batched `score_ex`: one `(keys, key_to_pods)` pair per item,
        one `(scores, match_blocks)` pair back, each bit-identical to a
        standalone `score_ex` call (same maxes over the same floats, same
        per-pod addition order — each pod's sum walks its own chain, so
        set-iteration order never reaches the arithmetic).

        The batch amortizes the weight maps: `_pod_max_weights` builds
        one dict per distinct entry-list object, and the index's
        `lookup_many` hands items that share a key THE SAME entry-list
        object — so the map is computed once and reused across every item
        holding it. Callers that also know WHICH items share a leading
        key-chain prefix (the indexer's `score_many`) use `score_plan`
        instead, which additionally forks the walk state at divergence
        points so a shared prefix is WALKED once, not once per item."""
        return self.score_plan([
            ("solo", keys, key_to_pods, False) for keys, key_to_pods in items
        ])

    def score_plan(
        self, plan: Sequence[tuple]
    ) -> List[Tuple[Dict[str, float], Dict[str, int]]]:
        """Execute a batch scoring plan (the `score_many` read path).

        Plan entries, in order:

          ("solo", keys, key_to_pods, keep_states) — a full `score_ex`
            walk. With `keep_states` the walk snapshots its (scores,
            match, active) state after every processed key, so later
            entries can fork from it.
          ("fork", ref_pos, shared_blocks, tail_keys, tail_key_to_pods) —
            an item whose first `shared_blocks` keys are THE SAME OBJECTS
            as plan[ref_pos]'s leading keys, looked up under the same pod
            filter against the same index state. Its walk resumes from
            the reference's snapshot after `shared_blocks` keys and
            continues over `tail_keys` (the keys past the shared prefix)
            with its own tail lookup result.

        Each result is bit-identical to a standalone `score_ex` over the
        item's full chain: the shared prefix contributes the exact same
        per-pod addition sequence whether walked privately or forked
        (same key objects, same entry lists, same floats, same order) —
        forking only moves WHO walks it. If the reference's walk cut
        before the fork point (missing key / emptied active set), the
        frozen final snapshot is the fork state and the tail contributes
        nothing, exactly as the item's own walk would have cut there."""
        weights = self.medium_weights
        wm_cache: Dict[int, Dict[str, float]] = {}
        states_by_pos: Dict[int, list] = {}
        out: List[Tuple[Dict[str, float], Dict[str, int]]] = []
        for pos, item in enumerate(plan):
            if item[0] == "solo":
                _, keys, key_to_pods, keep_states = item
                if not keys:
                    out.append(({}, {}))
                    continue
                entries = key_to_pods.get(keys[0])
                if entries is None:
                    scores: Dict[str, float] = {}
                    active: set = set()
                    match: Dict[str, int] = {}
                elif len(entries) == 1:
                    # Single-holder fast path (the common shape: most
                    # blocks live on one pod). Identical arithmetic to the
                    # weight-map path — the max over one entry IS that
                    # entry's weight — without building the map.
                    e = entries[0]
                    scores = {e.pod_identifier: weights.get(e.device_tier, 1.0)}
                    active = {e.pod_identifier}
                    match = {e.pod_identifier: 1}
                else:
                    first = wm_cache.get(id(entries))
                    if first is None:
                        first = wm_cache[id(entries)] = _pod_max_weights(
                            entries, weights
                        )
                    # Copy: `scores` is mutated below, the cached map is
                    # shared.
                    scores = dict(first)
                    active = set(scores)
                    match = dict.fromkeys(active, 1)
                states = None
                if keep_states:
                    states = [(dict(scores), dict(match), set(active))]
                for key in keys[1:]:
                    if not active:
                        break
                    entries = key_to_pods.get(key)
                    if entries is None:
                        active = set()
                    elif len(entries) == 1:
                        # active ∩ {pod} then add: same float, same order.
                        e = entries[0]
                        pod = e.pod_identifier
                        if pod in active:
                            if len(active) != 1:
                                active = {pod}
                            scores[pod] += weights.get(e.device_tier, 1.0)
                            match[pod] += 1
                        else:
                            active = set()
                    else:
                        here = wm_cache.get(id(entries))
                        if here is None:
                            here = wm_cache[id(entries)] = _pod_max_weights(
                                entries, weights
                            )
                        active &= here.keys()
                        for pod in active:
                            scores[pod] += here[pod]
                            match[pod] += 1
                    if keep_states:
                        states.append((dict(scores), dict(match), set(active)))
                if keep_states:
                    states_by_pos[pos] = states
                out.append((scores, match))
            else:
                _, ref_pos, shared_blocks, tail_keys, tail_hits = item
                # One snapshot per processed key; a cut freezes the list,
                # and the frozen tail state IS the post-cut state.
                states = states_by_pos[ref_pos]
                s_scores, s_match, s_active = states[
                    min(shared_blocks, len(states)) - 1
                ]
                scores = dict(s_scores)
                match = dict(s_match)
                active = set(s_active)
                for key in tail_keys:
                    if not active:
                        break
                    entries = tail_hits.get(key)
                    if entries is None:
                        active = set()
                    elif len(entries) == 1:
                        e = entries[0]
                        pod = e.pod_identifier
                        if pod in active:
                            if len(active) != 1:
                                active = {pod}
                            scores[pod] += weights.get(e.device_tier, 1.0)
                            match[pod] += 1
                        else:
                            active = set()
                    else:
                        here = wm_cache.get(id(entries))
                        if here is None:
                            here = wm_cache[id(entries)] = _pod_max_weights(
                                entries, weights
                            )
                        active &= here.keys()
                        for pod in active:
                            scores[pod] += here[pod]
                            match[pod] += 1
                out.append((scores, match))
        return out


def new_kv_block_scorer(config: Optional[KVBlockScorerConfig] = None) -> LongestPrefixScorer:
    cfg = config or KVBlockScorerConfig()
    if cfg.scoring_strategy != LONGEST_PREFIX_MATCH:
        raise ValueError(f"unsupported scoring strategy: {cfg.scoring_strategy}")
    return LongestPrefixScorer(weight_map(cfg.backend_configs))
