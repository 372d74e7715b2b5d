"""Region failover: digest staleness → suspect/stale demotion → rendezvous
failover, reusing membership's two-phase handoff vocabulary at region
granularity.

Copy of the reference package's `federation/failover.py`.

A region does not report itself dead — it goes *quiet*. The only signal
the global tier has is the one it already consumes: the periodic digest
stream. So region liveness is the fleethealth state machine verbatim
(`FleetHealthTracker` with region ids in place of pods, digest arrivals
in place of event batches):

- **healthy** — digests arriving inside the suspect window. Fully
  routable.
- **suspect** — digest overdue past `digest_suspect_after_s`. Still
  routable, but demoted in the region pick (the ×0.5 convention suspect
  pods already get): a WAN hiccup should bend traffic away, not slam it.
- **stale** — digest overdue past `digest_stale_after_s`. Excluded from
  the pick entirely; sessions homed there fail over.

Failover target selection is rendezvous-hashed per (home, candidate) —
the same fnv64a ranking the hot-prefix replicator uses for target pods —
so every router instance, with no coordination, sends a lost region's
sessions to the SAME surviving region (their re-landed prefixes
concentrate instead of scattering), while different lost regions drain to
different survivors. Recovery is the same two-phase story in reverse: the
first digest from a recovered region flips it healthy (fleethealth's
resume-resets-seq rule), and home-pinned sessions snap back.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.fleethealth import (
    HEALTHY,
    STALE,
    SUSPECT,
    FleetHealthConfig,
    FleetHealthTracker,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.hashing import fnv64a
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("federation.failover")

DIGEST_TOPIC = "digest"


class RegionFailoverTracker:
    """Digest-staleness state machine over a fixed region set."""

    def __init__(
        self,
        regions: Sequence[str],
        suspect_after_s: float,
        stale_after_s: float,
        clock=time.monotonic,
    ):
        if not regions:
            raise ValueError("RegionFailoverTracker needs at least one region")
        self.regions = list(dict.fromkeys(regions))
        self.clock = clock
        # auto_quarantine off: there is no local index holding a remote
        # region's entries — exclusion happens at pick time.
        self.health = FleetHealthTracker(
            FleetHealthConfig(
                suspect_after_s=suspect_after_s,
                stale_after_s=stale_after_s,
                auto_quarantine=False,
            ),
            clock=clock,
        )
        self.failovers = 0
        self._last_state: Dict[str, str] = {}

    def observe_digest(
        self, region_id: str, seq: Optional[int], now: Optional[float] = None
    ) -> None:
        """One digest arrived from `region_id` (seq = the digest's wire
        seq; gaps/dups surface through the tracker's stream-integrity
        counters exactly as event streams do)."""
        if now is None:
            now = self.clock()
        self.health.observe_batch(region_id, DIGEST_TOPIC, seq, now)
        self._note_transition(region_id)

    def state_of(self, region_id: str) -> str:
        """healthy | suspect | stale. A region that has NEVER sent a digest
        is healthy (fleethealth's no-evidence rule — at cold start every
        region must be routable or the federation deadlocks)."""
        state = self.health.state_of(region_id)
        self._note_transition(region_id, state)
        return state

    def _note_transition(
        self, region_id: str, state: Optional[str] = None
    ) -> None:
        if state is None:
            state = self.health.state_of(region_id)
        prev = self._last_state.get(region_id)
        if prev != state:
            self._last_state[region_id] = state
            metrics.count_federation_transition(state)
            if prev is not None:
                logger.warning(
                    "region %s: %s -> %s (digest staleness)",
                    region_id, prev, state,
                )

    # -- pick-time queries -------------------------------------------------

    def routable_regions(self) -> List[str]:
        """Everything except stale regions; never empty (a federation
        where every digest is stale routes blind over the full set rather
        than stalling — the no-cache-signal convention)."""
        out = [r for r in self.regions if self.state_of(r) != STALE]
        return out or list(self.regions)

    def stale_regions(self) -> List[str]:
        return [r for r in self.regions if self.state_of(r) == STALE]

    def demotion(self, region_id: str, suspect_factor: float) -> float:
        """Blend multiplier for a region's pick score: 1.0 healthy,
        `suspect_factor` suspect (stale regions never reach the blend)."""
        return suspect_factor if self.state_of(region_id) == SUSPECT else 1.0

    def failover_region(
        self, home: str, exclude: Sequence[str] = ()
    ) -> Optional[str]:
        """Deterministic failover target for a lost home region: the
        rendezvous-top healthy-or-suspect region. Every router computes
        the same answer from the same region set — no coordination, and a
        lost region's sessions re-land TOGETHER (their shared prefixes
        re-warm once, not once per router)."""
        skip = set(exclude) | {home}
        best, best_weight = None, -1
        for region in self.regions:
            if region in skip or self.state_of(region) == STALE:
                continue
            weight = fnv64a(
                f"{home}:{region}".encode("utf-8")
            )
            if weight > best_weight:
                best, best_weight = region, weight
        if best is not None:
            self.failovers += 1
            metrics.count_federation_failover()
        return best

    # -- introspection -----------------------------------------------------

    def summary(self) -> dict:
        """Per-region staleness document (the /readyz federation section's
        region table)."""
        pods = self.health.summary()["pods"]
        out = {}
        for region in self.regions:
            rec = pods.get(region)
            out[region] = {
                "state": self.state_of(region),
                "digest_age_s": (
                    rec["last_event_age_s"] if rec is not None else None
                ),
                "seq_gaps": rec["seq_gaps"] if rec is not None else 0,
                "recoveries": rec["recoveries"] if rec is not None else 0,
            }
        return out
