"""Region abstraction + federation config: one precise fleet behind the
global tier.

Copy of the reference package's `federation/region.py`, without the carrier-propagating delegation (ROADMAP.md queue 1
item 7).

A *region* is everything the repo already builds — an `Indexer` (or the
replicated `ClusterScorer` front over N indexer replicas), its event
plane, its popularity tracker — bound to a region id. The federation
tier never reaches into a region's precise index: it sees exactly three
things, all approximate or aggregate:

- the region's **digest** (federation/digest.py): popularity-sketch rows
  + hot-chain digests + a load index, rebuilt every `digest_interval_s`,
- the region's **scoring front**: `get_pod_scores_ex` (and `score_many`),
  delegated to only after the region pick,
- the region's **digest age**: the staleness signal failover watches.

This split is what keeps the reference's read path precise (PAPER.md:
prompt → block keys → index → pod scores) while scaling past one fleet:
the precise index stays region-local where its event streams live, and
only sketch-sized state crosses the WAN.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.federation.digest import RegionDigest, build_digest
from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import PodScores


@dataclass
class FederationConfig:
    """Shape of one federation member + the global-tier policy knobs.

    Env mapping (api/http_service.py): FEDERATION, FEDERATION_REGION_ID,
    FEDERATION_REGIONS (comma-separated), FEDERATION_PEERS
    ("region=host:port,..."), FEDERATION_DIGEST_INTERVAL_S,
    FEDERATION_DIGEST_SUSPECT_S, FEDERATION_DIGEST_STALE_S.
    """

    # This process's home region, and the full region set (self included).
    # An empty `regions` list means single-region — the federation is the
    # flat fleet, and scoring is pinned bit-identical to it.
    region_id: str = "region-0"
    regions: List[str] = field(default_factory=list)
    # Digest cadence and the staleness windows driving region failover
    # (fleethealth vocabulary at region granularity): a region whose digest
    # is older than suspect_after_s is demoted in the pick, older than
    # stale_after_s is excluded and its home sessions fail over.
    digest_interval_s: float = 5.0
    digest_suspect_after_s: float = 15.0
    digest_stale_after_s: float = 45.0
    # Region-pick blend: affinity is the mean sketch estimate over the
    # request's leading `affinity_blocks` block hashes, normalized across
    # regions; `load_weight` demotes a busy region; `home_bonus` breaks
    # affinity ties toward the session's home (user proximity), and the
    # `suspect` demotion halves a quiet region's blended score (the same
    # ×0.5 convention fleethealth applies to suspect pods).
    affinity_blocks: int = 32
    load_weight: float = 0.25
    home_bonus: float = 0.05
    suspect_demotion: float = 0.5
    # Digest content bounds: how many top-K chains ride one digest and how
    # many leading blocks of each retained prefix travel with it.
    digest_hot_k: int = 8
    digest_max_prefix_blocks: int = 64
    # Cross-region hot-prefix admission: chains from a REMOTE digest whose
    # decayed score crosses the threshold are offered to the local region's
    # warm seam (`Region.warm_fn` → EnginePod.warm_chain), at most once per
    # cooldown per chain head. 0 jobs when no warm seam is wired.
    replicate_hot_chains: bool = True
    replicate_score_threshold: float = 20.0
    replicate_cooldown_s: float = 60.0

    def __post_init__(self):
        if self.regions and self.region_id not in self.regions:
            raise ValueError(
                f"region_id {self.region_id!r} not in regions {self.regions}"
            )
        if self.digest_interval_s <= 0:
            raise ValueError("digest_interval_s must be positive")
        if not (
            0 < self.digest_suspect_after_s < self.digest_stale_after_s
        ):
            raise ValueError(
                "need 0 < digest_suspect_after_s < digest_stale_after_s"
            )

    def region_set(self) -> List[str]:
        return list(self.regions) if self.regions else [self.region_id]


class Region:
    """One region-local precise control plane, as the global tier sees it.

    `scorer` is anything with `get_pod_scores_ex(prompt, model_name,
    pod_identifiers, lora_id=None) -> PodScores` — an `Indexer`, a
    `ClusterScorer`, or a remote transport (`GrpcReplicaTransport` has the
    same surface, so a remote region needs no new client code). The
    optional seams are local-region-only:

    - `tracker` (ChainPopularityTracker): the digest source,
    - `pods_fn` / `load_fn`: serving-pod count and load index for the
      digest's aggregate fields,
    - `warm_fn(chain_digest) -> int`: the cross-region replication seam —
      lands a remote hot chain through the engine's warm_chain admission
      path, returns blocks landed.
    """

    def __init__(
        self,
        region_id: str,
        scorer,
        tracker=None,
        pods_fn: Optional[Callable[[], Sequence[str]]] = None,
        load_fn: Optional[Callable[[], float]] = None,
        warm_fn=None,
    ):
        self.region_id = region_id
        self.scorer = scorer
        self.tracker = tracker
        self.pods_fn = pods_fn
        self.load_fn = load_fn
        self.warm_fn = warm_fn
        self._digest_seq = 0

    # -- precise delegation ------------------------------------------------

    def get_pod_scores_ex(
        self, prompt: str, model_name: str, pod_identifiers, lora_id=None
    ) -> PodScores:
        return self.scorer.get_pod_scores_ex(
            prompt, model_name, pod_identifiers, lora_id=lora_id
        )

    def score_many(self, requests) -> List[PodScores]:
        score_many = getattr(self.scorer, "score_many", None)
        if score_many is not None:
            return score_many(requests)
        return [
            self.scorer.get_pod_scores_ex(
                r.prompt, r.model_name, r.pod_identifiers, lora_id=r.lora_id
            )
            for r in requests
        ]

    # -- digest production -------------------------------------------------

    def build_digest(
        self, config: FederationConfig, now: Optional[float] = None
    ) -> RegionDigest:
        """Snapshot this region's approximate state for shipping. Requires
        a popularity tracker (the digest IS the tracker's export)."""
        if self.tracker is None:
            raise ValueError(
                f"region {self.region_id!r} has no popularity tracker to "
                "digest — attach a ChainPopularityTracker"
            )
        if now is None:
            now = time.time()
        self._digest_seq += 1
        return build_digest(
            self.region_id,
            self.tracker,
            seq=self._digest_seq,
            pods=len(self.pods_fn()) if self.pods_fn is not None else 0,
            load=float(self.load_fn()) if self.load_fn is not None else 0.0,
            hot_k=config.digest_hot_k,
            max_prefix_blocks=config.digest_max_prefix_blocks,
            now=now,
        )
