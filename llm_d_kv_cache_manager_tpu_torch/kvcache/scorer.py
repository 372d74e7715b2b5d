"""Pod scoring from block lookup results.

Port of the reference package's `LongestPrefixScorer.score`: walk block keys
in prompt order; only pods present for block 0 start "active"; each later
block intersects the active set; every hit adds the pod's maximum device-tier
weight for that block (unknown tiers default to 1.0). Pods that drop out
keep the score accumulated so far.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key, PodEntry


def _pod_max_weights(
    entries: Sequence[PodEntry], weights: Dict[str, float]
) -> Dict[str, float]:
    """One pass over a key's entries -> {pod: max device-tier weight}."""
    best: Dict[str, float] = {}
    for entry in entries:
        w = weights.get(entry.device_tier, 1.0)
        pod = entry.pod_identifier
        prev = best.get(pod)
        if prev is None or w > prev:
            best[pod] = w
    return best


class LongestPrefixScorer:
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
        return scores
