"""Pluggable routing policy: blend prefix affinity with pod load.

Copy of the reference package's `kvcache/routing.py`. The read path's
contract so far has been "score = weighted longest cached prefix"; the
router argmaxes it. That is the right answer until the fleet saturates: a
pod with the hottest prefix keeps winning the argmax while its admission
queue deepens — prefix score is a *benefit* signal with no *cost* term.

`RoutingPolicy` adds the cost term at two altitudes:

- **`adjust`** — a post-scoring score-map transformation on the Indexer
  read path (what the scoring API can return):

      effective(pod) = score(pod) / (1 + load_weight * load_index(pod))

  Division (not subtraction) keeps the adjustment scale-free in the
  scorer's units and can demote but never erase or invent a signal — a
  score map has no way to say "route to a pod that isn't in it".
- **`select`** — the full routing decision for callers that know their
  candidate universe (the fleet benches' router; llm-d's EPP blending
  scorer outputs across all endpoints):

      utility(pod) = prefix_frac(pod) - load_weight * load_index(pod)

  over EVERY candidate, cached or not. This is the form in which a
  saturated pod with a perfect prefix genuinely loses to a warm-enough
  idle pod — the idle candidate exists in the decision.

`load_index` is a dimensionless blend of the pod's queue depth,
committed busy time, and decayed preemption rate (fleethealth/load.py),
each scaled by its own normalization knob.

Policies:

- ``prefix_only`` (default) — the identity: `adjust` returns the SAME
  scores dict object, so wiring the policy into the read path is
  bit-identical to not having one.
- ``load_blend`` — the blend above. Every request whose deterministic
  argmax (max score, lexicographic-min pod) changes under the blend
  counts one override in `stats`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("kvcache.routing")

PREFIX_ONLY = "prefix_only"
LOAD_BLEND = "load_blend"
_POLICIES = (PREFIX_ONLY, LOAD_BLEND)


@dataclass
class RoutingPolicyConfig:
    """The blend's strength and the normalization of each load signal."""

    policy: str = PREFIX_ONLY
    # Overall strength of the load discount: 0 disables it numerically
    # (but prefer policy="prefix_only", which skips the walk entirely).
    load_weight: float = 1.0
    # Normalizations: how much of each raw signal equals 1.0 load unit.
    # queue_depth_norm=4 reads "4 queued decodes make a unit of load".
    queue_depth_norm: float = 4.0
    busy_norm_s: float = 1.0
    preemption_norm: float = 8.0

    def __post_init__(self):
        if self.policy not in _POLICIES:
            raise ValueError(
                f"unknown routing policy {self.policy!r}; "
                f"expected one of {_POLICIES}"
            )
        if self.load_weight < 0:
            raise ValueError("load_weight must be >= 0")
        for name in ("queue_depth_norm", "busy_norm_s", "preemption_norm"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")


def _argmax_pod(scores: Dict[str, float]) -> Optional[str]:
    """The router's deterministic choice: max score, lexicographic-min pod
    (the same tie-break `explain_scores` reports)."""
    if not scores:
        return None
    best = max(scores.values())
    return min(p for p, s in scores.items() if s == best)


class RoutingPolicy:
    """Post-scoring adjustment hook for the Indexer read path."""

    def __init__(
        self,
        config: Optional[RoutingPolicyConfig] = None,
        load_tracker=None,
    ):
        self.config = config or RoutingPolicyConfig()
        # fleethealth.load.PodLoadTracker (duck-typed: load_of(pod, now)).
        # None degrades load_blend to the identity — no signals, no blend.
        self.load_tracker = load_tracker
        self._mu = threading.Lock()
        self.stats = {"adjusted_requests": 0, "overrides": 0}

    @property
    def is_noop(self) -> bool:
        return self.config.policy == PREFIX_ONLY

    def load_index(self, pod_identifier: str, now=None) -> float:
        """Dimensionless per-pod load (0 = idle). Public for explain/status
        surfaces; the blend below is `1 / (1 + load_weight * this)`."""
        if self.load_tracker is None:
            return 0.0
        cfg = self.config
        load = self.load_tracker.load_of(pod_identifier, now=now)
        return (
            load.queue_depth / cfg.queue_depth_norm
            + load.busy_s / cfg.busy_norm_s
            + load.preemption_rate / cfg.preemption_norm
        )

    def adjust(
        self, scores: Dict[str, float], _explain: Optional[dict] = None
    ) -> Dict[str, float]:
        """Blend load into a (post-fleet-health) score map.

        prefix_only, an empty map, no tracker, or zero weight return
        `scores` UNCHANGED — the same dict object, so the pinned
        bit-identity paths never even copy. load_blend returns a new map
        in the scorer's units; entries are demoted, never dropped."""
        if (
            self.is_noop
            or not scores
            or self.load_tracker is None
            or self.config.load_weight == 0.0
        ):
            return scores
        weight = self.config.load_weight
        before = _argmax_pod(scores)
        now = None
        clock = getattr(self.load_tracker, "clock", None)
        if clock is not None:
            now = clock()  # one clock read per request, not per pod
        adjusted: Dict[str, float] = {}
        loads: Dict[str, float] = {}
        for pod, score in scores.items():
            li = self.load_index(pod, now=now)
            loads[pod] = li
            adjusted[pod] = score / (1.0 + weight * li)
        after = _argmax_pod(adjusted)
        with self._mu:
            self.stats["adjusted_requests"] += 1
            if after != before:
                self.stats["overrides"] += 1
        if after != before:
            metrics.count_routing_override()
            kvlog.trace(
                logger,
                "load blend overrode prefix argmax %s -> %s", before, after,
            )
        if _explain is not None:
            _explain["routing_policy"] = {
                "policy": self.config.policy,
                "load_index": {
                    p: round(li, 4) for p, li in sorted(loads.items())
                },
                "override": after != before,
                "prefix_choice": before,
                "blended_choice": after,
            }
        return adjusted

    def score_divisors(self, pod_identifiers):
        """Per-pod score divisors for the native scoring core.

        `adjust` computes ``score / (1 + load_weight * load_index)``; this
        returns the denominators aligned with `pod_identifiers`, or None
        when the blend is inert (prefix_only / no tracker / zero weight) —
        the unchanged-scores identity path. One clock read for the whole
        batch, like `adjust`'s one read per request. ``None`` input
        entries (the interner's id-0 sentinel) get the neutral 1.0.
        """
        if (
            self.is_noop
            or self.load_tracker is None
            or self.config.load_weight == 0.0
        ):
            return None
        weight = self.config.load_weight
        now = None
        clock = getattr(self.load_tracker, "clock", None)
        if clock is not None:
            now = clock()
        return [
            1.0 if pod is None
            else 1.0 + weight * self.load_index(pod, now=now)
            for pod in pod_identifiers
        ]

    def note_adjusted(self, adjusted: int, overrides: int) -> None:
        """Fold a native batch's blend accounting into `stats` — the same
        counters `adjust` keeps per request, minus the per-override trace
        log (the native path only knows the override happened, not the
        pod names)."""
        if adjusted <= 0:
            return
        with self._mu:
            self.stats["adjusted_requests"] += adjusted
            self.stats["overrides"] += overrides
        for _ in range(overrides):
            metrics.count_routing_override()

    def select(
        self,
        scores: Dict[str, float],
        candidate_pods,
        now=None,
        _explain: Optional[dict] = None,
    ) -> Optional[str]:
        """Full routing decision over a KNOWN candidate set.

        `adjust` can only demote entries inside the score map — a pod with
        no cache signal is not in the map, so a map transformation can
        never express "the saturated perfect-prefix pod loses to a
        warm-enough idle pod with no cache at all". The router, which
        knows its candidate universe, gets the full blend instead:

            utility(pod) = prefix_frac(pod) - load_weight * load_index(pod)

        where prefix_frac normalizes the pod's prefix score against the
        request's best (1.0 = the longest cached prefix anyone has, 0 =
        no cache) — so `load_weight` reads as "how many units of
        normalized load one full prefix hit is worth". Deterministic
        tie-break: max utility, lexicographic-min pod. Returns None under
        `prefix_only` (or with no tracker/zero weight): the caller's pure
        prefix argmax stays authoritative — and bit-identical.

        Every selection whose winner differs from the pure prefix argmax
        counts one override in `stats`.
        """
        candidates = list(dict.fromkeys(candidate_pods))
        if (
            self.is_noop
            or not candidates
            or self.load_tracker is None
            or self.config.load_weight == 0.0
        ):
            return None
        if now is None:
            clock = getattr(self.load_tracker, "clock", None)
            if clock is not None:
                now = clock()
        max_score = max(scores.values()) if scores else 0.0
        weight = self.config.load_weight
        utilities: Dict[str, float] = {}
        loads: Dict[str, float] = {}
        for pod in candidates:
            li = self.load_index(pod, now=now)
            loads[pod] = li
            frac = (scores.get(pod, 0.0) / max_score) if max_score else 0.0
            utilities[pod] = frac - weight * li
        best = max(utilities.values())
        chosen = min(p for p, u in utilities.items() if u == best)
        prefix_choice = _argmax_pod(
            {p: s for p, s in scores.items() if p in utilities}
        )
        overrode = prefix_choice is not None and chosen != prefix_choice
        with self._mu:
            self.stats["adjusted_requests"] += 1
            if overrode:
                self.stats["overrides"] += 1
        if overrode:
            metrics.count_routing_override()
            kvlog.trace(
                logger,
                "load blend overrode prefix argmax %s -> %s",
                prefix_choice, chosen,
            )
        if _explain is not None:
            _explain["routing_policy"] = {
                "policy": self.config.policy,
                "load_index": {
                    p: round(li, 4) for p, li in sorted(loads.items())
                },
                "utility": {
                    p: round(u, 4) for p, u in sorted(utilities.items())
                },
                "override": overrode,
                "prefix_choice": prefix_choice,
                "blended_choice": chosen,
            }
        return chosen

    def status(self) -> dict:
        cfg = self.config
        with self._mu:
            stats = dict(self.stats)
        return {
            "policy": cfg.policy,
            "load_weight": cfg.load_weight,
            "queue_depth_norm": cfg.queue_depth_norm,
            "busy_norm_s": cfg.busy_norm_s,
            "preemption_norm": cfg.preemption_norm,
            "stats": stats,
            "loads": (
                self.load_tracker.snapshot()
                if self.load_tracker is not None else None
            ),
        }
