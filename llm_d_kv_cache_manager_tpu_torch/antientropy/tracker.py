"""Per-pod advertised-vs-verified trust: the anti-entropy scoreboard.

Copy of the reference package's `antientropy/tracker.py`. The index is eventually
consistent with best-effort KVEvents, so its view of a pod can silently diverge
from what the pod actually holds — a pod that evicted without its BlockRemoved
landing, or a buggy engine advertising blocks it never stored. `fleethealth`
detects pods whose *stream* goes bad; this tracker scores pods whose stream
looks perfectly healthy while their *content* lies.

Three observation sources feed one per-pod accuracy EWMA:

- **fetch-miss feedback** (antientropy/feedback.py): the data plane
  fetched a block the index advertised and the peer answered "missing" —
  ground truth, one block at a time, for free (the fetch already
  happened).
- **sampled residency audits** (antientropy/auditor.py): periodic direct
  challenges of a pod's advertised entries against its resident-set
  digest; each audit contributes its verified fraction.
- **orphan removals** (kvevents/pool.py): a BlockRemoved for a block the
  index never stored. Counted as divergence evidence per pod, but NOT
  charged against accuracy — the pod told the truth; the *index* missed
  the store (a dropped event), so demoting the pod for it would punish
  the honest party.

The EWMA feeds `adjust_scores`, the truth-weighted demotion applied on
the `Indexer.filter_scores` path right after fleet-health filtering: a
pod whose advertised accuracy fell below `distrust_threshold` has its
prefix scores multiplied by a factor that decays with measured accuracy
(floored at `min_factor`) — a chronically divergent pod loses routing
weight like a suspect pod, and wins it back as clean audits pull the
EWMA up. A tracker that has observed nothing (or only clean audits)
returns the scores dict UNCHANGED — the same object — so attaching the
subsystem to a truthful fleet is bit-identical.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import base_pod_identifier
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("antientropy.tracker")

# Fixed divergence-source vocabulary — the only values the
# kvcache_index_divergence_observations_total `source` label may carry
# (pinned in tests/test_metrics_hygiene.py / tests/test_antientropy.py).
SOURCE_FETCH_MISS = "fetch_miss"
SOURCE_ORPHAN_REMOVAL = "orphan_removal"
SOURCE_AUDIT_PHANTOM = "audit_phantom"
DIVERGENCE_SOURCES = (
    SOURCE_FETCH_MISS, SOURCE_ORPHAN_REMOVAL, SOURCE_AUDIT_PHANTOM,
)


@dataclass
class AntiEntropyConfig:
    # EWMA smoothing for the per-pod advertised-vs-verified accuracy.
    # Each observation (one fetch-miss event, one audit round) moves the
    # EWMA by this fraction toward the observed accuracy.
    accuracy_alpha: float = 0.3
    # Accuracy at or above this passes untouched; below it the demotion
    # factor engages. 1.0 would demote on any single miss; the default
    # tolerates isolated event-race noise (an evict landing mid-fetch).
    distrust_threshold: float = 0.9
    # Demotion floor: even a fully divergent pod keeps this fraction of
    # its score — its real entries may still be the best signal available,
    # and a zero factor would be exclusion, which is fleethealth's call.
    min_factor: float = 0.25


class _PodTrust:
    __slots__ = (
        "accuracy", "observations", "fetch_misses", "orphan_removals",
        "audits", "audited_entries", "phantom_entries", "readmitted_blocks",
        "purged_entries", "last_audit_t", "last_observation_t",
    )

    def __init__(self) -> None:
        self.accuracy = 1.0
        self.observations = 0
        self.fetch_misses = 0
        self.orphan_removals = 0
        self.audits = 0
        self.audited_entries = 0
        self.phantom_entries = 0
        self.readmitted_blocks = 0
        self.purged_entries = 0
        self.last_audit_t: Optional[float] = None
        self.last_observation_t: Optional[float] = None

    def as_dict(self) -> dict:
        return {
            "accuracy_ewma": round(self.accuracy, 4),
            "observations": self.observations,
            "fetch_misses": self.fetch_misses,
            "orphan_removals": self.orphan_removals,
            "audits": self.audits,
            "audited_entries": self.audited_entries,
            "phantom_entries": self.phantom_entries,
            "purged_entries": self.purged_entries,
            "readmitted_blocks": self.readmitted_blocks,
            "last_audit_t": self.last_audit_t,
        }


class AntiEntropyTracker:
    """Thread-safe per-pod truth scoreboard + score demotion hook.

    Pods are keyed by base identity (DP-ranked identities fold onto their
    bare pod name): divergence evidence comes from the data plane and the
    audit surface, which address pods, while scores may carry "pod@dpN"
    keys — `factor_for` matches either form.
    """

    def __init__(
        self,
        config: Optional[AntiEntropyConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or AntiEntropyConfig()
        self.clock = clock
        self._mu = threading.Lock()
        self._pods: Dict[str, _PodTrust] = {}

    # -- observation seams -------------------------------------------------

    def _record(self, pod_identifier: str) -> _PodTrust:
        pod = base_pod_identifier(pod_identifier)
        rec = self._pods.get(pod)
        if rec is None:
            rec = self._pods[pod] = _PodTrust()
        return rec

    def _observe_accuracy(self, rec: _PodTrust, sample: float) -> None:
        alpha = self.config.accuracy_alpha
        rec.accuracy += alpha * (sample - rec.accuracy)
        rec.observations += 1
        rec.last_observation_t = self.clock()

    def observe_fetch_miss(
        self, pod_identifier: str, blocks: int = 1, purged: int = 0
    ) -> None:
        """The data plane proved `blocks` advertised placements phantom
        (per-block "missing" answers from the pod itself); `purged` index
        entries were repaired off the back of it."""
        metrics.count_divergence(SOURCE_FETCH_MISS, blocks)
        metrics.count_divergence_purged(purged)
        with self._mu:
            rec = self._record(pod_identifier)
            rec.fetch_misses += blocks
            rec.purged_entries += purged
            self._observe_accuracy(rec, 0.0)

    def observe_orphan_removal(self, pod_identifier: str, blocks: int = 1) -> None:
        """A BlockRemoved arrived for a block the index never stored:
        evidence the index LOST this pod's store event (divergence in the
        other direction). Counted, never charged against the pod's
        accuracy — see the module docstring."""
        metrics.count_divergence(SOURCE_ORPHAN_REMOVAL, blocks)
        with self._mu:
            rec = self._record(pod_identifier)
            rec.orphan_removals += blocks

    def observe_audit(
        self,
        pod_identifier: str,
        verified: int,
        phantom: int,
        purged: int = 0,
        readmitted: int = 0,
        now: Optional[float] = None,
    ) -> None:
        """One audit round's verdict for a pod: `verified` challenged
        entries the pod confirmed, `phantom` it disclaimed (purged), and
        `readmitted` resident blocks the index had lost. A clean audit
        (phantom == 0) is the recovery path — it pulls the EWMA back
        toward 1.0."""
        if phantom:
            metrics.count_divergence(SOURCE_AUDIT_PHANTOM, phantom)
        metrics.count_divergence_purged(purged)
        metrics.count_divergence_readmitted(readmitted)
        metrics.count_divergence_audit()
        if now is None:
            now = self.clock()
        with self._mu:
            rec = self._record(pod_identifier)
            rec.audits += 1
            rec.audited_entries += verified + phantom
            rec.phantom_entries += phantom
            rec.purged_entries += purged
            rec.readmitted_blocks += readmitted
            rec.last_audit_t = now
            if verified + phantom:
                self._observe_accuracy(rec, verified / (verified + phantom))
            elif readmitted == 0:
                # Nothing challenged and nothing missing either way: the
                # pod's advertised set (possibly empty — e.g. everything
                # it had was purged) exactly matches reality. That IS a
                # clean audit; without this, a fully-purged pod could
                # never earn its trust back.
                self._observe_accuracy(rec, 1.0)

    def forget_pod(self, pod_identifier: str) -> int:
        """Drop a departed pod's trust record (the resourcegov reap hook;
        DP-ranked identities fold onto the base key). Forgetting resets
        the pod to the unseen default — accuracy 1.0 — which is correct
        for a departure: a pod that comes back is a new pod and earns
        distrust only from new evidence. Returns rows removed (0 or 1)."""
        pod = base_pod_identifier(pod_identifier)
        with self._mu:
            return 1 if self._pods.pop(pod, None) is not None else 0

    def entries(self) -> int:
        """Tracked per-pod trust rows — the resource accountant's O(1)
        meter read."""
        with self._mu:
            return len(self._pods)

    # -- read-path hook ----------------------------------------------------

    def accuracy(self, pod_identifier: str) -> float:
        """Current advertised-vs-verified EWMA; unseen pods are 1.0 (no
        evidence is no evidence against)."""
        with self._mu:
            rec = self._pods.get(base_pod_identifier(pod_identifier))
            return rec.accuracy if rec is not None else 1.0

    def factor_for(self, pod_identifier: str) -> float:
        """Truth-weighted demotion multiplier in [min_factor, 1.0]."""
        acc = self.accuracy(pod_identifier)
        threshold = self.config.distrust_threshold
        if acc >= threshold:
            return 1.0
        return max(self.config.min_factor, acc / max(threshold, 1e-9))

    def adjust_scores(self, scores: Dict[str, float]) -> Dict[str, float]:
        """Demote divergent pods' scores (the Indexer.filter_scores-path
        seam, applied after fleet-health filtering). A fleet with no
        distrusted pod returns `scores` unchanged — the SAME dict object,
        zero-allocation, bit-identical routing (the acceptance pin)."""
        if not scores or not self._pods:
            return scores
        demoted: Optional[Dict[str, float]] = None
        for pod in scores:
            factor = self.factor_for(pod)
            if factor >= 1.0:
                continue
            if demoted is None:
                demoted = dict(scores)
            demoted[pod] = demoted[pod] * factor
        return scores if demoted is None else demoted

    def score_factors(self, pod_identifiers):
        """Per-pod demotion multipliers for the native scoring core.

        Aligned with `pod_identifiers`; None when the tracker has no
        divergence evidence at all (the zero-allocation unchanged-scores
        path `adjust_scores` takes). ``None`` input entries (the
        interner's id-0 sentinel) get the neutral 1.0. Same arithmetic as
        `factor_for`, folded into one lock acquisition for the batch.
        """
        with self._mu:
            if not self._pods:
                return None
            threshold = self.config.distrust_threshold
            min_factor = self.config.min_factor
            out = [1.0] * len(pod_identifiers)
            for i, pod in enumerate(pod_identifiers):
                if pod is None:
                    continue
                rec = self._pods.get(base_pod_identifier(pod))
                if rec is None:
                    continue
                acc = rec.accuracy
                if acc < threshold:
                    out[i] = max(min_factor, acc / max(threshold, 1e-9))
        return out

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        """Per-pod divergence evidence (the reference service's
        `index_health` section): accuracy EWMA, demotion factor, last audit
        time, and
        the purge/readmit counters."""
        with self._mu:
            pods = {}
            distrusted = 0
            for pod, rec in sorted(self._pods.items()):
                d = rec.as_dict()
                pods[pod] = d
            totals = {
                "fetch_misses": sum(
                    r.fetch_misses for r in self._pods.values()
                ),
                "orphan_removals": sum(
                    r.orphan_removals for r in self._pods.values()
                ),
                "audits": sum(r.audits for r in self._pods.values()),
                "phantom_entries": sum(
                    r.phantom_entries for r in self._pods.values()
                ),
                "purged_entries": sum(
                    r.purged_entries for r in self._pods.values()
                ),
                "readmitted_blocks": sum(
                    r.readmitted_blocks for r in self._pods.values()
                ),
            }
        for pod, d in pods.items():
            d["factor"] = round(self.factor_for(pod), 4)
            if d["factor"] < 1.0:
                distrusted += 1
        return {
            "pods": pods,
            "distrusted_pods": distrusted,
            "totals": totals,
            "config": {
                "accuracy_alpha": self.config.accuracy_alpha,
                "distrust_threshold": self.config.distrust_threshold,
                "min_factor": self.config.min_factor,
            },
        }
