"""GlobalRouter: the two-level read path over a federation of regions.

Copy of the reference package's `federation/router.py`, without its
tracing spans, the carrier-propagating delegation and its metrics
(ROADMAP.md queue 1 item 7); `status()` and `stats_counters` keep every
count.

Level 1 — **approximate, global**: score the request's leading block
hashes against every region's shipped popularity sketch
(`RegionDigest.affinity`), blend with region load and digest-staleness
health, pick ONE region. Nothing here is precise, and nothing here needs
to be: the pick only has to land the request in the region whose fleet
has seen its prefix, and a count-min overestimate cannot make a genuinely
hot region read cold.

Level 2 — **precise, region-local**: delegate to the picked region's
existing front (`Indexer` / `ClusterScorer.get_pod_scores_ex`) for exact
pod scores. The delegation passes the result through UNTOUCHED, which is
what makes the bit-identity pin cheap to state and test: a single-region
federation IS the flat fleet — same PodScores, float for float
(tests/test_federation.py pins it across all four index backends).

Digest ingest doubles as the cross-region replication seam: hot chains
riding a REMOTE region's digest are offered to the local region's
`warm_fn` (→ `EnginePod.warm_chain`, the same admission path placement
replication uses), bounded by a score threshold and a per-chain cooldown
— a popular prefix becomes resident in other regions *before* a failover
or a travelling user needs it there.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from llm_d_kv_cache_manager_tpu_torch.federation.digest import (
    RegionDigest,
    decode_digest,
    encode_digest,
)
from llm_d_kv_cache_manager_tpu_torch.federation.failover import RegionFailoverTracker
from llm_d_kv_cache_manager_tpu_torch.federation.region import FederationConfig, Region
from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import PodScores
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("federation.router")


@dataclass
class GlobalScore:
    """One federated scoring decision: which region, why, and the precise
    answer it produced."""

    region: str
    pod_scores: PodScores
    # Pick evidence: per-region blended score + raw affinity/load/state,
    # failover/mispick flags. Data for /federation/score and the bench —
    # region ids stay out of metric labels except the bounded configured
    # set.
    detail: dict = field(default_factory=dict)


def derive_fn_from_indexer(indexer):
    """Build a `derive_fn(prompt, model_name, lora_id) -> [block_hash]`
    over an Indexer's own tokenization + key derivation — the global tier
    derives the SAME chain the region-local read path will, so sketch
    probes and precise scoring agree on block identity."""

    def derive(prompt: str, model_name: str, lora_id=None) -> List[int]:
        tokens = indexer.tokenizers_pool.tokenize(None, prompt, model_name)
        keys = indexer.token_processor.tokens_to_kv_block_keys(
            None, tokens, model_name, lora_id=lora_id
        )
        return [k.chunk_hash for k in keys]

    return derive


class GlobalRouter:
    """Region pick over shipped digests + precise delegation."""

    def __init__(
        self,
        config: FederationConfig,
        regions: Union[Dict[str, Region], Sequence[Region]],
        derive_fn=None,
        clock=time.monotonic,
    ):
        self.config = config
        if not isinstance(regions, dict):
            regions = {r.region_id: r for r in regions}
        if not regions:
            raise ValueError("GlobalRouter needs at least one region")
        unknown = set(regions) - set(config.region_set())
        if unknown:
            raise ValueError(
                f"regions {sorted(unknown)} not in the configured set "
                f"{config.region_set()}"
            )
        self.regions = dict(regions)
        self.derive_fn = derive_fn
        self.clock = clock
        self.failover = RegionFailoverTracker(
            config.region_set(),
            suspect_after_s=config.digest_suspect_after_s,
            stale_after_s=config.digest_stale_after_s,
            clock=clock,
        )
        # region -> (digest, received_at). One writer lock; reads copy the
        # reference (digests are immutable once ingested).
        self._digests: Dict[str, Tuple[RegionDigest, float]] = {}
        self._mu = threading.Lock()
        # (target_region, chain head) -> last warm attempt (cooldown gate).
        self._warm_last: Dict[Tuple[str, int], float] = {}
        self.stats_counters = {
            "routed": 0,
            "routed_home": 0,
            "mispicked_regions": 0,
            "failover_routes": 0,
            "blind_picks": 0,  # no digest anywhere -> home/first fallback
            "delegation_failures": 0,
            "digests_ingested": 0,
            "digest_bytes_received": 0,
            "digest_bytes_sent": 0,
            "warm_jobs": 0,
            "warmed_blocks": 0,
            "warm_skipped_cooldown": 0,
        }
        self.routed_by_region = {r: 0 for r in config.region_set()}

    # -- digest plane ------------------------------------------------------

    def build_local_digest(self, now: Optional[float] = None) -> bytes:
        """Encode this process's home-region digest (and self-ingest it, so
        the home region's staleness clock and sketch participate in the
        pick exactly like a peer's)."""
        region = self.regions.get(self.config.region_id)
        if region is None:
            raise ValueError(
                f"home region {self.config.region_id!r} is not attached"
            )
        if now is None:
            now = self.clock()
        digest = region.build_digest(self.config, now=now)
        data = encode_digest(digest)
        self.stats_counters["digest_bytes_sent"] += len(data)
        self.ingest_digest(digest, now=now, received_bytes=0)
        return data

    def ingest_digest(
        self,
        digest: Union[RegionDigest, bytes],
        now: Optional[float] = None,
        received_bytes: Optional[int] = None,
    ) -> RegionDigest:
        """Store one region's digest: staleness observation + pick state +
        (for remote digests) the cross-region hot-chain warm offer."""
        if isinstance(digest, (bytes, bytearray)):
            if received_bytes is None:
                received_bytes = len(digest)
            digest = decode_digest(bytes(digest))
        if digest.region_id not in self.failover.regions:
            raise ValueError(
                f"digest from unknown region {digest.region_id!r} "
                f"(configured: {self.failover.regions})"
            )
        if now is None:
            now = self.clock()
        with self._mu:
            self._digests[digest.region_id] = (digest, now)
            self.stats_counters["digests_ingested"] += 1
            if received_bytes:
                self.stats_counters["digest_bytes_received"] += received_bytes
        self.failover.observe_digest(digest.region_id, digest.seq, now=now)
        if self.config.replicate_hot_chains:
            self._offer_hot_chains(digest, now)
        return digest

    def _offer_hot_chains(self, digest: RegionDigest, now: float) -> None:
        """Offer a remote digest's hot chains to every ATTACHED region with
        a warm seam (in a real deployment that is exactly one — the local
        region; the bench attaches all of them to one router). Bounded by
        the score threshold and a per-(region, head) cooldown; landing is
        the engine's warm_chain admission — serving always wins."""
        cfg = self.config
        for region_id, region in self.regions.items():
            if region_id == digest.region_id or region.warm_fn is None:
                continue
            for chain in digest.hot_chains:
                if chain.score < cfg.replicate_score_threshold:
                    continue
                if not chain.prefix_tokens:
                    continue
                key = (region_id, chain.head)
                last = self._warm_last.get(key)
                if last is not None and now - last < cfg.replicate_cooldown_s:
                    self.stats_counters["warm_skipped_cooldown"] += 1
                    continue
                self._warm_last[key] = now
                landed = int(region.warm_fn(chain) or 0)
                self.stats_counters["warm_jobs"] += 1
                if landed:
                    self.stats_counters["warmed_blocks"] += landed
        # Cooldown table hygiene (bounded by the travelling chain set).
        if len(self._warm_last) > 64 * max(len(self.regions), 1):
            horizon = now - cfg.replicate_cooldown_s
            self._warm_last = {
                k: t for k, t in self._warm_last.items() if t >= horizon
            }

    # -- region pick -------------------------------------------------------

    def pick_region(
        self,
        block_hashes: Sequence[int],
        home_region: Optional[str] = None,
        now: Optional[float] = None,
    ) -> Tuple[str, dict]:
        """Level-1 decision: approximate prefix affinity (sketch estimates
        over the leading block hashes, normalized across regions) blended
        with digest-reported load, staleness demotion, and a home bonus.
        Deterministic: ties break toward home, then lexicographically."""
        cfg = self.config
        region_set = cfg.region_set()
        if len(region_set) == 1:
            return region_set[0], {"single_region": True}
        if now is None:
            now = self.clock()
        candidates = self.failover.routable_regions()
        detail: dict = {"regions": {}, "failover": None, "mispick": False}

        home_eff = home_region
        if home_region is not None and home_region not in candidates:
            home_eff = self.failover.failover_region(home_region)
            detail["failover"] = {"home": home_region, "target": home_eff}
        with self._mu:
            digests = dict(self._digests)
        affinities = {}
        for r in candidates:
            entry = digests.get(r)
            affinities[r] = (
                entry[0].affinity(block_hashes, cfg.affinity_blocks)
                if entry is not None else 0.0
            )
        max_aff = max(affinities.values(), default=0.0)
        best_region, best_score = None, None
        for r in candidates:
            aff_frac = affinities[r] / max_aff if max_aff > 0 else 0.0
            entry = digests.get(r)
            load = entry[0].load if entry is not None else 0.0
            demote = self.failover.demotion(r, cfg.suspect_demotion)
            score = aff_frac * demote - cfg.load_weight * load
            if r == home_eff:
                score += cfg.home_bonus
            detail["regions"][r] = {
                "affinity": round(affinities[r], 4),
                "affinity_frac": round(aff_frac, 4),
                "load": round(load, 4),
                "state": self.failover.state_of(r),
                "blend": round(score, 4),
            }
            if best_score is None or score > best_score or (
                score == best_score
                and (r == home_eff or (best_region != home_eff
                                       and r < best_region))
            ):
                best_region, best_score = r, score
        if max_aff <= 0 and not digests:
            self.stats_counters["blind_picks"] += 1
        if detail["failover"] is not None and best_region == home_eff:
            self.stats_counters["failover_routes"] += 1
        if (
            home_region is not None
            and home_region in candidates
            and best_region != home_region
        ):
            detail["mispick"] = True
            self.stats_counters["mispicked_regions"] += 1
        return best_region, detail

    # -- two-level read path ----------------------------------------------

    def score_ex(
        self,
        prompt: str,
        model_name: str,
        pod_identifiers=(),
        lora_id=None,
        home_region: Optional[str] = None,
        now: Optional[float] = None,
    ) -> GlobalScore:
        """Pick a region, then delegate precisely. A region whose front
        fails at delegation time contributes nothing — the request retries
        the next-ranked candidate (degraded, never stalled), and an
        exhausted candidate list answers the explicit no-cache-signal
        empty PodScores."""
        return self._score_ex(
            prompt, model_name, pod_identifiers, lora_id=lora_id,
            home_region=home_region, now=now,
        )

    def _score_ex(
        self,
        prompt: str,
        model_name: str,
        pod_identifiers=(),
        lora_id=None,
        home_region: Optional[str] = None,
        now: Optional[float] = None,
    ) -> GlobalScore:
        region_set = self.config.region_set()
        if len(region_set) == 1:
            # Bit-identity fast path: no derivation, no blend — the flat
            # fleet's answer IS the federation's answer.
            region_id = region_set[0]
            ps, _ = self._delegate(
                self.regions[region_id], prompt, model_name,
                pod_identifiers, lora_id,
            )
            self._count_route(region_id, home_region)
            return GlobalScore(
                region=region_id, pod_scores=ps,
                detail={"single_region": True},
            )
        hashes: Sequence[int] = ()
        if self.derive_fn is not None:
            hashes = self.derive_fn(prompt, model_name, lora_id)
        region_id, detail = self.pick_region(
            hashes, home_region=home_region, now=now
        )
        tried = []
        while region_id is not None:
            region = self.regions.get(region_id)
            if region is not None:
                try:
                    ps, _ = self._delegate(
                        region, prompt, model_name, pod_identifiers,
                        lora_id,
                    )
                    self._count_route(region_id, home_region)
                    detail["tried"] = tried
                    return GlobalScore(
                        region=region_id, pod_scores=ps, detail=detail
                    )
                except Exception as e:  # noqa: BLE001 - degrade per region
                    self.stats_counters["delegation_failures"] += 1
                    logger.warning(
                        "region %s failed at delegation (%s): trying "
                        "failover", region_id, e,
                    )
            tried.append(region_id)
            region_id = self.failover.failover_region(
                tried[0], exclude=tried
            )
        detail["tried"] = tried
        return GlobalScore(
            region="", pod_scores=PodScores(), detail=detail
        )

    def _delegate(self, region, prompt, model_name, pod_identifiers, lora_id):
        """One precise delegation to the region's front."""
        return region.get_pod_scores_ex(
            prompt, model_name, pod_identifiers, lora_id=lora_id
        ), None

    def get_pod_scores_ex(
        self, prompt: str, model_name: str, pod_identifiers, lora_id=None
    ) -> PodScores:
        """Drop-in for the flat fronts' surface (the bit-identity pin's
        subject): federated scoring without the region evidence."""
        return self.score_ex(
            prompt, model_name, pod_identifiers, lora_id=lora_id
        ).pod_scores

    def _count_route(self, region_id: str, home_region: Optional[str]) -> None:
        self.stats_counters["routed"] += 1
        if region_id in self.routed_by_region:
            self.routed_by_region[region_id] += 1
        if home_region is not None and region_id == home_region:
            self.stats_counters["routed_home"] += 1

    # -- introspection -----------------------------------------------------

    def status(self, now: Optional[float] = None) -> dict:
        """Federation document for /federation/status and the /readyz
        `federation` section: per-region digest age + staleness state,
        stale set, failover/route/digest counters."""
        if now is None:
            now = self.clock()
        with self._mu:
            digests = dict(self._digests)
        regions = {}
        staleness = self.failover.summary()
        for r in self.config.region_set():
            entry = digests.get(r)
            age = round(now - entry[1], 3) if entry is not None else None
            regions[r] = {
                **staleness.get(r, {"state": "healthy"}),
                "digest_age_s": age,
                "digest_seq": entry[0].seq if entry is not None else None,
                "digest_pods": entry[0].pods if entry is not None else None,
                "digest_load": (
                    round(entry[0].load, 4) if entry is not None else None
                ),
                "hot_chains": (
                    len(entry[0].hot_chains) if entry is not None else 0
                ),
                "attached": r in self.regions,
            }
        return {
            "region_id": self.config.region_id,
            "regions": regions,
            "stale_regions": self.failover.stale_regions(),
            "failovers": self.failover.failovers,
            "routed_by_region": dict(self.routed_by_region),
            "counters": dict(self.stats_counters),
            "config": {
                "digest_interval_s": self.config.digest_interval_s,
                "digest_suspect_after_s": self.config.digest_suspect_after_s,
                "digest_stale_after_s": self.config.digest_stale_after_s,
                "affinity_blocks": self.config.affinity_blocks,
                "load_weight": self.config.load_weight,
                "home_bonus": self.config.home_bonus,
                "replicate_hot_chains": self.config.replicate_hot_chains,
            },
        }
