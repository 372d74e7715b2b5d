"""Elastic fleet membership: pod join/leave as a first-class subsystem.

Copy of the reference package's `cluster/membership.py`.

Without this module, partition reassignment on join/leave is "a config
change" with nothing orchestrating it. An elastic fleet — the saturation
answer the qps ladder demands — needs three things no config change
provides:

- **Warm-before-serve.** A pod that joins cold is a hit-rate crater: the
  router either avoids it (no cache signal → it never warms) or floods it
  (least-loaded fallback → every request recomputes). The join sequence
  replicates the currently-hot prefixes (placement/ popularity tracker →
  prefetch/warm plane, the same jobs `HotPrefixReplicator` emits) BEFORE
  the pod enters the serving set, so its first routed request already
  finds the shared system prompts resident.
- **Live partition handoff, exactly-once.** Replicated indexers own
  disjoint slices of the fleet's event streams; membership changes move
  slices between replicas with a two-phase handoff built entirely from
  existing machinery: pause (ownership override → nobody applies the
  stream; the delivery-seam journal keeps the bytes), transfer (the old
  owner drains, its per-topic seq watermark is captured, the pod's index
  entries move via `export_view`/`import_view`, `remove_pod` clears the
  old owner), then commit (the new owner installs the watermarks as seq
  floors, replays the journal tail through NORMAL ingest — floors make
  double-delivery a no-op — and takes ownership; ZMQ topic filters
  refresh through `resubscribe`). No event is double-applied (floors) or
  lost (journal covers the pause window), and mid-handoff the ownership
  table answers None for the pod, so the scatter-gather merge trusts
  NEITHER replica's answer for it — zero stale-partition scores by
  construction, the same explicit no-signal degradation the cluster
  scorer already uses for a dead replica.
- **Drained departure.** Leave is the fault path made graceful: the pod
  stops being routable the moment draining starts (`serving_pods`
  excludes every non-SERVING phase), its stream drains, and its index
  entries quarantine through the same bulk `remove_pod` the fleet-health
  tracker uses for crashes.

Like fleethealth, the orchestrator is thread-safe, clock-injectable sync
code with no background threads: benches and tests drive it
deterministically; a deployment calls it from its operator loop.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.cluster.partition import ReplicaPartitioner
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import IndexView
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import base_pod_identifier
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("cluster.membership")

# Membership phases — the FIXED vocabulary of the
# kvcache_membership_transitions_total `phase` label (bounded by
# construction; enforced by tests/test_metrics_hygiene.py).
JOINING = "joining"          # roster entry, onboarding seams
WARMING = "warming"          # hot prefixes replicating, NOT routable yet
REASSIGNING = "reassigning"  # partition handoff in flight
SERVING = "serving"          # routable member
DRAINING = "draining"        # leaving: unroutable, stream draining
LEFT = "left"                # departed, entries quarantined
PHASES = (JOINING, WARMING, REASSIGNING, SERVING, DRAINING, LEFT)


@dataclass
class MembershipConfig:
    # Warm-before-serve: how many of the popularity tracker's hottest
    # chains are replicated to a joining pod, and the minimum hotness a
    # chain needs to be worth shipping. 0 top-k disables warming.
    warm_top_k: int = 8
    warm_hotness_threshold: float = 0.0
    # When True (default) a join without a warm plane still gates through
    # WARMING (with zero jobs) — the phase sequence stays uniform for the
    # metrics/status surfaces. The gate itself is structural either way:
    # a pod is routable only in SERVING.
    require_warm: bool = True


class PartitionTable:
    """Ownership table: FNV-hash default with explicit overrides.

    A drop-in for `ReplicaPartitioner` wherever ownership is READ
    (`ClusterScorer._merge`, event-pool gates, topic filters), plus the
    write operations membership needs: `set_owner` overrides a pod's
    owner (None = paused mid-handoff — no replica owns the stream and the
    scatter-gather merge trusts no replica's answer for the pod), and
    `clear_override` returns it to the hash default.

    One table is SHARED by every replica in the process; per-replica
    views come from `gate(rid)` (an `EventPool.message_filter`) and
    `topic_filters(rid, pods)`.
    """

    def __init__(self, num_replicas: int):
        self._hash = ReplicaPartitioner(num_replicas)
        self.num_replicas = num_replicas
        self._mu = threading.Lock()
        self._overrides: Dict[str, Optional[int]] = {}

    # -- reads (ReplicaPartitioner-compatible) -----------------------------

    def replica_for(self, pod_identifier: str) -> Optional[int]:
        """Owning replica, or None while the pod's stream is paused
        mid-handoff (callers comparing `replica_for(p) == rid` then match
        no replica — exactly the no-signal behavior handoff needs)."""
        base = base_pod_identifier(pod_identifier)
        with self._mu:
            if base in self._overrides:
                return self._overrides[base]
        return self._hash.replica_for(base)

    def hash_replica_for(self, pod_identifier: str) -> int:
        """The override-free FNV default (where a pod's stream homes when
        no handoff has moved it)."""
        return self._hash.replica_for(pod_identifier)

    def gate(self, replica_id: int) -> Callable:
        """`EventPool.message_filter` for one replica's pool."""
        def accepts(msg) -> bool:
            return self.replica_for(msg.pod_identifier) == replica_id
        return accepts

    def topic_filters(
        self, replica_id: int, pod_identifiers: Sequence[str]
    ) -> List[str]:
        """ZMQ SUB prefixes for one replica's owned slice of the roster
        (feed to `ZMQSubscriber.resubscribe` after membership changes)."""
        owned = sorted(
            base_pod_identifier(p)
            for p in pod_identifiers
            if self.replica_for(p) == replica_id
        )
        return [f"kv@{pod}@" for pod in dict.fromkeys(owned)]

    def partition_map(
        self, pod_identifiers: Sequence[str]
    ) -> Dict[Optional[int], List[str]]:
        out: Dict[Optional[int], List[str]] = {
            r: [] for r in range(self.num_replicas)
        }
        for pod in sorted({base_pod_identifier(p) for p in pod_identifiers}):
            out.setdefault(self.replica_for(pod), []).append(pod)
        return out

    def as_dict(self) -> dict:
        with self._mu:
            overrides = dict(self._overrides)
        return {
            "num_replicas": self.num_replicas,
            "overrides": {
                pod: rid for pod, rid in sorted(overrides.items())
            },
        }

    # -- writes (membership only) ------------------------------------------

    def set_owner(self, pod_identifier: str, replica_id: Optional[int]) -> None:
        base = base_pod_identifier(pod_identifier)
        if replica_id is not None and not (
            0 <= replica_id < self.num_replicas
        ):
            raise ValueError(
                f"replica {replica_id} outside [0, {self.num_replicas})"
            )
        with self._mu:
            self._overrides[base] = replica_id

    def clear_override(self, pod_identifier: str) -> None:
        with self._mu:
            self._overrides.pop(base_pod_identifier(pod_identifier), None)


@dataclass
class ReplicaBinding:
    """What membership needs to touch one replica during a handoff: its
    partition-gated event pool, its index, and (optionally) a callable
    applying a fresh ZMQ filter list (`ZMQSubscriber.resubscribe`, or the
    pool's subscriber via `EventPool.config.topic_filters` on restart)."""

    replica_id: int
    event_pool: object
    index: object
    resubscribe: Optional[Callable[[List[str]], None]] = None


def export_pod_view(index, pod_identifier: str) -> IndexView:
    """Project ONE pod's slice out of an index's exported view.

    Rows keep only the moved pod's (pod, tier) entries (DP-rank-qualified
    identities move with their base pod, matching `remove_pod`); the
    engine-key map keeps rows whose request key survives — everything the
    new owner needs to score the pod, nothing that would alias another
    replica's partition.
    """
    base = base_pod_identifier(pod_identifier)
    full = index.export_view()
    entries = []
    kept_keys = set()
    for model_name, chunk_hash, pods in full.entries:
        kept = tuple(
            (pod, tier) for pod, tier in pods
            if base_pod_identifier(pod) == base
        )
        if kept:
            entries.append((model_name, chunk_hash, kept))
            kept_keys.add((model_name, chunk_hash))
    engine_map = [
        row for row in full.engine_map if (row[2], row[3]) in kept_keys
    ]
    return IndexView(entries=entries, engine_map=engine_map)


class FleetMembership:
    """Pod lifecycle orchestrator: join / leave / partition handoff."""

    def __init__(
        self,
        config: Optional[MembershipConfig] = None,
        table: Optional[PartitionTable] = None,
        replicas: Sequence[ReplicaBinding] = (),
        fleet_health=None,
        load_tracker=None,
        popularity=None,
        warm_submit: Optional[Callable] = None,
        watermark_fn: Optional[Callable[[str], Dict]] = None,
        journal_fn: Optional[Callable[[], Sequence]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or MembershipConfig()
        self.table = table
        self.replicas = {b.replica_id: b for b in replicas}
        # fleethealth.FleetHealthTracker: departures quarantine through it
        # (stale transition + bulk index purge) so leave and crash share
        # one code path. Optional — leave falls back to raw remove_pod.
        self.fleet_health = fleet_health
        # fleethealth.load.PodLoadTracker: a joining pod gets an explicit
        # idle baseline so the load-blend policy treats it as available
        # the moment it serves (no report ≠ repelled, but be explicit).
        self.load_tracker = load_tracker
        # placement.ChainPopularityTracker (duck-typed: hot_chains): the
        # warm-before-serve source. warm_submit(pod, chain) ships one hot
        # chain to the joining pod (RoutePrefetcher.submit + warm_chain in
        # the benches; an RPC in a deployment) and returns truthiness.
        self.popularity = popularity
        self.warm_submit = warm_submit
        # watermark_fn(pod) -> {(base_pod, topic): last_applied_seq} — the
        # old owner's applied watermark at drain time (the deployment's
        # fleethealth `seq_counters_from_tracker`, the bench's applied-seq
        # map). journal_fn() -> the retained delivery-seam tail (Messages)
        # covering at least the pause window, same contract as
        # warm-restart replay.
        self.watermark_fn = watermark_fn
        self.journal_fn = journal_fn
        self.clock = clock
        # resourcegov.DepartureReaper (optional): leave() fans the
        # departure out to every registered per-pod forget hook after the
        # quarantine/purge, so breaker rows, trust EWMAs, load records
        # and negative-cache entries die with the pod instead of
        # accumulating across churn. Attached by the service wiring.
        self.reaper = None
        self._mu = threading.Lock()
        self._phase: Dict[str, str] = {}
        self._since: Dict[str, float] = {}
        self.stats = {
            "joins": 0, "leaves": 0, "handoffs": 0,
            "warm_jobs_submitted": 0, "entries_moved": 0,
            "journal_replayed": 0, "replay_skipped": 0,
        }

    # -- roster ------------------------------------------------------------

    def phase_of(self, pod_identifier: str) -> Optional[str]:
        with self._mu:
            return self._phase.get(base_pod_identifier(pod_identifier))

    def serving_pods(self) -> List[str]:
        """The routable set — the warm-before-serve gate made structural:
        only SERVING members appear, so a router whose pods_fn consults
        membership cannot route to a pod that is still warming, draining,
        or mid-handoff."""
        with self._mu:
            return sorted(
                p for p, ph in self._phase.items() if ph == SERVING
            )

    def members(self) -> Dict[str, dict]:
        now = self.clock()
        with self._mu:
            return {
                pod: {
                    "phase": ph,
                    "phase_age_s": round(now - self._since[pod], 3),
                }
                for pod, ph in sorted(self._phase.items())
            }

    def bootstrap(self, pod_identifiers: Sequence[str]) -> None:
        """Register an already-running fleet as SERVING members (process
        start / bench init): pods that predate the membership service get
        no join choreography — they are serving by observation."""
        for pod in pod_identifiers:
            self._transition(base_pod_identifier(pod), SERVING)

    def _transition(self, pod: str, phase: str) -> None:
        assert phase in PHASES, phase
        with self._mu:
            old = self._phase.get(pod)
            self._phase[pod] = phase
            self._since[pod] = self.clock()
        metrics.count_membership_transition(phase)
        logger.info("membership: pod %s %s -> %s", pod, old, phase)

    # -- join --------------------------------------------------------------

    def begin_join(self, pod_identifier: str) -> dict:
        """Phase 1 of a join: onboard + start warming. The pod is NOT
        routable yet; the caller executes/awaits the warm jobs (drain the
        prefetch plane) and then calls `finish_join`."""
        pod = base_pod_identifier(pod_identifier)
        with self._mu:
            current = self._phase.get(pod)
        if current is not None and current not in (LEFT,):
            raise ValueError(f"pod {pod} already a member (phase {current})")
        self._transition(pod, JOINING)
        # Onboarding seams: an explicit idle load baseline; fleet health
        # learns the pod lazily from its first event batch (a pod that
        # never stored is healthy by definition — tracker contract).
        if self.load_tracker is not None:
            self.load_tracker.report(pod, queue_depth=0.0, inflight=0.0)
        warm_jobs = 0
        if self.config.require_warm or (
            self.popularity is not None and self.warm_submit is not None
        ):
            self._transition(pod, WARMING)
        if (
            self.popularity is not None
            and self.warm_submit is not None
            and self.config.warm_top_k > 0
        ):
            hot = self.popularity.hot_chains(
                self.config.warm_hotness_threshold
            )
            for chain in hot[: self.config.warm_top_k]:
                if self.warm_submit(pod, chain):
                    warm_jobs += 1
        with self._mu:
            self.stats["joins"] += 1
            self.stats["warm_jobs_submitted"] += warm_jobs
        return {"pod": pod, "phase": self.phase_of(pod),
                "warm_jobs": warm_jobs}

    def finish_join(self, pod_identifier: str) -> dict:
        """Phase 2 of a join: take partition ownership (hash-default home,
        topic filters refreshed) and enter the serving set."""
        pod = base_pod_identifier(pod_identifier)
        current = self.phase_of(pod)
        if current not in (JOINING, WARMING):
            raise ValueError(
                f"pod {pod} not joining (phase {current})"
            )
        stats = {"pod": pod}
        if self.table is not None and self.replicas:
            self._transition(pod, REASSIGNING)
            rid = self.table.hash_replica_for(pod)
            self.table.clear_override(pod)  # hash default IS the owner
            self._refresh_filters()
            stats["owner_replica"] = rid
        self._transition(pod, SERVING)
        return stats

    def join(self, pod_identifier: str) -> dict:
        """Synchronous join (warm jobs submitted, not awaited — callers
        needing a hard warm gate use begin_join / drain / finish_join)."""
        stats = self.begin_join(pod_identifier)
        stats.update(self.finish_join(pod_identifier))
        return stats

    # -- leave -------------------------------------------------------------

    def leave(self, pod_identifier: str) -> dict:
        """Graceful departure: unroutable immediately, stream drained,
        entries quarantined through the fleet-health `remove_pod` path."""
        pod = base_pod_identifier(pod_identifier)
        current = self.phase_of(pod)
        if current != SERVING:
            raise ValueError(f"pod {pod} not serving (phase {current})")
        self._transition(pod, DRAINING)
        owner = (
            self.table.replica_for(pod) if self.table is not None else None
        )
        binding = self.replicas.get(owner)
        if binding is not None:
            binding.event_pool.drain()
        purged = 0
        if self.fleet_health is not None:
            purged = self.fleet_health.quarantine(pod)
        elif binding is not None:
            purged = binding.index.remove_pod(pod)
        if self.table is not None:
            # Departed pods fall back to the hash default (irrelevant
            # until the identity returns) and filters shrink.
            self.table.clear_override(pod)
            self._refresh_filters()
        self._transition(pod, LEFT)
        reaped = 0
        if self.reaper is not None:
            try:
                reaped = sum(self.reaper.reap(pod).values())
            except Exception as e:  # noqa: BLE001 - a reap failure must
                # not fail the departure; the pod is already unroutable
                logger.warning("departure reap failed for %s: %s", pod, e)
        with self._mu:
            self.stats["leaves"] += 1
        return {"pod": pod, "purged_entries": purged,
                "reaped_rows": reaped}

    # -- partition handoff -------------------------------------------------

    def reassign_pod(
        self, pod_identifier: str, new_owner: int
    ) -> dict:
        """Two-phase handoff of one pod's event stream + index slice.

        Phase 1 — prepare: ownership override goes to None (PAUSED: no
        replica's gate accepts the stream; the scatter-gather merge,
        reading this table, trusts no replica's answer for the pod — a
        stray entry cannot score). The old owner drains, its applied
        watermark is captured, and the pod's index slice moves
        (`export_pod_view` → `import_view`; `remove_pod` clears the old
        owner).

        Phase 2 — commit: the new owner installs the watermark as seq
        floors, ownership flips to it (its gate now accepts the stream),
        the delivery-seam journal replays through NORMAL ingest (floors
        drop everything the moved view already contains — no event
        double-applied; the journal covers the pause window — no event
        lost), the pool drains, floors clear, and both replicas' ZMQ
        filters refresh.
        """
        if self.table is None:
            raise ValueError("reassign_pod needs a PartitionTable")
        pod = base_pod_identifier(pod_identifier)
        old_owner = self.table.replica_for(pod)
        stats = {"pod": pod, "from": old_owner, "to": new_owner}
        if old_owner == new_owner:
            return stats
        old_b = self.replicas.get(old_owner)
        new_b = self.replicas.get(new_owner)
        if new_b is None:
            raise ValueError(f"no binding for replica {new_owner}")
        self._transition(pod, REASSIGNING)

        # Phase 1: pause + drain + capture + move.
        self.table.set_owner(pod, None)
        if old_b is not None:
            old_b.event_pool.drain()
        floors = (
            dict(self.watermark_fn(pod)) if self.watermark_fn is not None
            else {}
        )
        # Only this pod's topics may floor the new owner's ingest.
        floors = {
            key: seq for key, seq in floors.items()
            if base_pod_identifier(key[0]) == pod
        }
        moved = 0
        if old_b is not None:
            view = export_pod_view(old_b.index, pod)
            moved = new_b.index.import_view(view)
            old_b.index.remove_pod(pod)

        # Phase 2: floors + ownership flip + journal replay + resume.
        new_b.event_pool.set_seq_floors(floors)
        self.table.set_owner(pod, new_owner)
        skipped_before = new_b.event_pool.replay_skipped
        replayed = 0
        if self.journal_fn is not None:
            for msg in self.journal_fn():
                if base_pod_identifier(msg.pod_identifier) == pod:
                    new_b.event_pool.add_task(msg)
                    replayed += 1
        new_b.event_pool.drain()
        skipped = new_b.event_pool.replay_skipped - skipped_before
        new_b.event_pool.clear_seq_floors()
        self._refresh_filters()
        prior = self.phase_of(pod)
        if prior == REASSIGNING:
            self._transition(pod, SERVING)
        with self._mu:
            self.stats["handoffs"] += 1
            self.stats["entries_moved"] += moved
            self.stats["journal_replayed"] += replayed
            self.stats["replay_skipped"] += skipped
        stats.update({
            "entries_moved": moved,
            "seq_floors": len(floors),
            "journal_replayed": replayed,
            "replay_skipped": skipped,
        })
        logger.info("partition handoff %s: %s", pod, stats)
        return stats

    def _refresh_filters(self) -> None:
        """Push each replica's current owned-topic list to its subscriber
        (`resubscribe` applies between polls — no rebind)."""
        if self.table is None:
            return
        with self._mu:
            roster = [
                p for p, ph in self._phase.items() if ph != LEFT
            ]
        for binding in self.replicas.values():
            if binding.resubscribe is not None:
                binding.resubscribe(
                    self.table.topic_filters(binding.replica_id, roster)
                )

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        with self._mu:
            stats = dict(self.stats)
        return {
            "members": self.members(),
            "serving": self.serving_pods(),
            "partition_table": (
                self.table.as_dict() if self.table is not None else None
            ),
            "config": {
                "warm_top_k": self.config.warm_top_k,
                "warm_hotness_threshold": self.config.warm_hotness_threshold,
                "require_warm": self.config.require_warm,
            },
            "stats": stats,
        }
