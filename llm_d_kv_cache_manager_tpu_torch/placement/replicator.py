"""Proactive K-way replication of hot prefixes.

Copy of the reference package's `placement/replicator.py`. The
popularity tracker (placement/popularity.py) says *what* is hot; this
module decides *where* it should live and pushes it there through the planes
that already exist: replica jobs ride the route-driven prefetch queue
(`RoutePrefetcher` → `EnginePod.prefetch_hashes` → the batched DCN transfer
plane), so replication inherits that plane's properties — bounded queue,
counted drops, idempotence against already-resident blocks, fetches off the
TTFT critical path.

Safety is by construction, not by tuning:

- **Never a sick target.** Candidate pods pass through the fleethealth
  state machine; anything not HEALTHY (suspect *or* stale) is skipped and
  counted — a replica pushed onto a dying pod is a phantom placement
  factory.
- **Never a pile-up.** Current owners (pods the index already credits with
  the chain head) are excluded, and target selection is rendezvous-hashed
  per chain: each hot chain gets its own deterministic pod ordering, so K
  replicas of many hot chains interleave across the fleet instead of all
  landing on the lexicographically-first healthy pod.
- **Never a hot loop.** A per-chain cooldown bounds how often one chain can
  be re-examined, and `max_jobs_per_tick` bounds the work one tick may
  enqueue — a popularity spike cannot convert into a replication storm.

The loop itself is pull-based and thread-free: callers invoke `tick()` from
whatever cadence they own (the fleet sim calls it per served request under
the simulated clock; a service wires it to a timer). Everything the tick
does is observable in `stats`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.hashing import fnv64a
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.placement.popularity import (
    ChainPopularityTracker,
    ChainStat,
)
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("placement.replicator")

# submit_fn(pod_identifier, block_hashes, chain) -> bool: enqueue one
# replication job; False = dropped (bounded queue full / plane closed).
SubmitFn = Callable[[str, List[int], ChainStat], bool]


@dataclass
class ReplicationConfig:
    # Target replica count per hot chain, owners included: a chain already
    # on k pods gets at most (k_replicas - k) new targets.
    k_replicas: int = 3
    # Decayed-popularity score a chain must cross to be considered hot.
    # With the default half-life this reads as "sustained requests per
    # ~2 minutes", not a lifetime count.
    hotness_threshold: float = 12.0
    # Re-examination cooldown per chain: replicas need time to land (and
    # to show up in the index) before the same chain is reconsidered.
    cooldown_s: float = 10.0
    # Bound on jobs enqueued by a single tick.
    max_jobs_per_tick: int = 4
    # Blocks pushed per job (the chain's leading prefix; the tracker
    # retains at most its own max_prefix_blocks).
    max_prefix_blocks: int = 64


class HotPrefixReplicator:
    """Policy loop: detect hot chains, pick spread-out healthy targets,
    submit bounded replication jobs through the prefetch plane."""

    def __init__(
        self,
        tracker: ChainPopularityTracker,
        submit_fn: SubmitFn,
        pods_fn: Callable[[], Sequence[str]],
        config: Optional[ReplicationConfig] = None,
        fleet_health=None,
        index=None,
        clock=time.monotonic,
    ):
        self.tracker = tracker
        self.submit_fn = submit_fn
        self.pods_fn = pods_fn
        self.config = config or ReplicationConfig()
        if self.config.k_replicas < 1:
            raise ValueError("k_replicas must be >= 1")
        # Optional fleethealth.FleetHealthTracker: the target gate. None
        # means every pod in pods_fn() is assumed healthy (tests/sims that
        # model no faults).
        self.fleet_health = fleet_health
        # Optional kvblock Index: resolves current owners of a chain head
        # so replication never re-pushes onto a pod that already holds it.
        self.index = index
        self.clock = clock
        self._last_attempt: Dict[int, float] = {}
        self.stats = {
            "ticks": 0,
            "jobs_submitted": 0,
            "blocks_submitted": 0,
            "drops": 0,
            "skipped_unhealthy": 0,
            "skipped_owner": 0,
            "skipped_cooldown": 0,
            "skipped_satisfied": 0,
        }

    # -- policy loop -------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> int:
        """One policy pass; returns the number of jobs submitted."""
        if now is None:
            now = self.clock()
        cfg = self.config
        self.stats["ticks"] += 1
        submitted = 0
        for chain in self.tracker.hot_chains(cfg.hotness_threshold, now=now):
            if submitted >= cfg.max_jobs_per_tick:
                break
            last = self._last_attempt.get(chain.head)
            if last is not None and now - last < cfg.cooldown_s:
                self.stats["skipped_cooldown"] += 1
                continue
            targets = self._pick_targets(chain)
            self._last_attempt[chain.head] = now
            if not targets:
                continue
            prefix = chain.prefix_hashes[: cfg.max_prefix_blocks]
            for pod in targets:
                if self.submit_fn(pod, list(prefix), chain):
                    self.stats["jobs_submitted"] += 1
                    self.stats["blocks_submitted"] += len(prefix)
                    metrics.count_placement_replication(len(prefix))
                else:
                    self.stats["drops"] += 1
                    metrics.count_placement_drop()
            submitted += 1
            kvlog.trace(
                logger,
                "replicating chain %x (score %.1f) to %s",
                chain.head, chain.score, targets,
            )
        # Cooldown table hygiene: entries for chains that left the top-K
        # decay out once stale (bounded by 2x the tracker's table).
        if len(self._last_attempt) > 2 * self.tracker.config.top_k:
            horizon = now - cfg.cooldown_s
            self._last_attempt = {
                h: t for h, t in self._last_attempt.items() if t >= horizon
            }
        return submitted

    # -- target selection --------------------------------------------------

    def _owners(self, chain: ChainStat) -> set:
        """Pods the index credits with the *last* block of the retained
        prefix — holding the chain's tail implies holding the whole
        replicable prefix, whereas the head block alone survives partial
        eviction on pods that can no longer serve the prefix (and that
        routing therefore no longer favors). Partial holders are NOT
        owners: they are fine replication targets (the warm-up is
        idempotent and just tops them up). Base pod names — DP-rank
        suffixes stripped, matching how the replication plane addresses
        pods."""
        if self.index is None or not chain.prefix_hashes:
            return set()
        tail = chain.prefix_hashes[
            min(self.config.max_prefix_blocks, len(chain.prefix_hashes)) - 1
        ]
        try:
            found = self.index.lookup(
                [Key(chain.model_name, tail)], set()
            )
        except ValueError:
            return set()
        owners = set()
        for entries in found.values():
            for entry in entries:
                owners.add(entry.pod_identifier.split("@dp")[0])
        return owners

    def _healthy(self, pod: str) -> bool:
        if self.fleet_health is None:
            return True
        # Strictly HEALTHY: suspect pods are *demoted*, not dead, but a
        # replica is a bet on the target's future — never bet on a pod the
        # health tracker already doubts.
        return self.fleet_health.state_of(pod) == "healthy"

    def _pick_targets(self, chain: ChainStat) -> List[str]:
        owners = self._owners(chain)
        want = self.config.k_replicas - len(owners)
        if want <= 0:
            self.stats["skipped_satisfied"] += 1
            return []
        ranked = []
        for pod in self.pods_fn():
            if pod in owners:
                self.stats["skipped_owner"] += 1
                continue
            if not self._healthy(pod):
                self.stats["skipped_unhealthy"] += 1
                metrics.count_placement_skip_unhealthy()
                continue
            # Rendezvous hash: a per-(chain, pod) weight gives every chain
            # its own deterministic pod ranking — replicas of different hot
            # chains spread across the fleet instead of piling onto one
            # "best" pod, with no shared state to coordinate.
            weight = fnv64a(
                b"%d:%s" % (chain.head, pod.encode("utf-8"))
            )
            ranked.append((weight, pod))
        ranked.sort()
        return [pod for _w, pod in ranked[:want]]

    def register_knobs(self, registry) -> None:
        """Publish this replicator's adaptive surfaces to the autopilot
        (autopilot/knobs.py). tick() re-reads the config each pass, so a
        nudge takes effect on the next tick. Bounds are relative to the
        configured baseline: the controller can roughly double the
        replica spread or halve the per-tick budget, never more."""
        from llm_d_kv_cache_manager_tpu_torch.autopilot.knobs import (
            KNOB_PLACEMENT_JOBS,
            KNOB_PLACEMENT_K,
            KnobSpec,
        )

        cfg = self.config
        registry.register(
            KnobSpec(
                name=KNOB_PLACEMENT_K,
                floor=1.0,
                ceiling=float(max(cfg.k_replicas * 2, cfg.k_replicas + 2)),
                max_step=1.0,
                integer=True,
                description="target replica count per hot chain",
            ),
            get=lambda: cfg.k_replicas,
            set_=lambda v: setattr(cfg, "k_replicas", int(v)),
        )
        registry.register(
            KnobSpec(
                name=KNOB_PLACEMENT_JOBS,
                floor=1.0,
                ceiling=float(max(cfg.max_jobs_per_tick * 2, 2)),
                max_step=1.0,
                integer=True,
                description="replication jobs submitted per tick",
            ),
            get=lambda: cfg.max_jobs_per_tick,
            set_=lambda v: setattr(cfg, "max_jobs_per_tick", int(v)),
        )

    def status(self) -> dict:
        return {
            "config": {
                "k_replicas": self.config.k_replicas,
                "hotness_threshold": self.config.hotness_threshold,
                "cooldown_s": self.config.cooldown_s,
                "max_jobs_per_tick": self.config.max_jobs_per_tick,
                "max_prefix_blocks": self.config.max_prefix_blocks,
            },
            "stats": dict(self.stats),
            "tracker": self.tracker.stats(),
        }
