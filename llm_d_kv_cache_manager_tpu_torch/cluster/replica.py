"""One member of the replicated indexer control plane.

Copy of the reference package's `cluster/replica.py`, without its
metrics gauges and tracing spans (they come with the port's metrics
collector and tracing spine, ROADMAP.md queue 1 item 7); every stat and
readiness field is kept.

`IndexerReplica` ties the pieces together for a single process: the
partition gate on its event pool (it digests only the streams it owns), the
snapshot writer, and the warm-restart sequence with its readiness state
machine:

    ready ──crash/restart──▶ replaying ──tail drained──▶ ready

The `replaying` state is first-class and distinct from `unready`
(api/http_service.py maps it to a 503 with its own status string): a
replica replaying its seq tail has a *partially stale* view — routers must
not scatter-gather to it yet, but operators should see "warming up, N
events behind", not a generic failure. A freshly-started replica with an
empty index is `ready` (an empty view is a *correct* view — scores degrade
to no-signal, exactly like a cold cache), which is what keeps readiness
from deadlocking on a quiet fleet.

Warm restart is: import the snapshot view, install the snapshot's
per-(pod, topic) seq watermarks as replay floors on the event pool, feed
the retained event tail through the NORMAL ingest path (floors make
already-applied events no-ops — replay is idempotent by construction),
drain, clear the floors, and flip to ready. Only the tail is re-digested:
warm in seconds instead of the minutes a full fleet re-store takes.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.cluster.partition import (
    ClusterConfig,
    ReplicaPartitioner,
)
from llm_d_kv_cache_manager_tpu_torch.cluster import snapshot as snapshot_mod
from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import EventPool, EventPoolConfig
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("cluster.replica")

READY = "ready"
REPLAYING = "replaying"


class IndexerReplica:
    """Partition-scoped Indexer + EventPool + snapshot/warm-restart."""

    def __init__(
        self,
        indexer,
        config: Optional[ClusterConfig] = None,
        pool_config: Optional[EventPoolConfig] = None,
        health_tracker=None,
        clock=time.time,
    ):
        self.config = config or ClusterConfig()
        self.partitioner = ReplicaPartitioner(
            self.config.num_replicas, self.config.replica_id
        )
        self.indexer = indexer
        self.health = health_tracker if health_tracker is not None else getattr(
            indexer, "fleet_health", None
        )
        self.clock = clock
        self.event_pool = EventPool(
            pool_config,
            indexer.kv_block_index,
            indexer.token_processor,
            health_tracker=self.health,
            message_filter=(
                self.partitioner.accepts
                if self.config.num_replicas > 1
                else None  # single replica: the gate is pure overhead
            ),
        )
        self.state = READY
        self.last_snapshot_ts: Optional[float] = None
        self.last_restart_stats: Optional[dict] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self, with_subscriber: bool = False) -> None:
        self.event_pool.start(with_subscriber=with_subscriber)

    def shutdown(self) -> None:
        self.event_pool.shutdown()

    def _set_state(self, state: str) -> None:
        if state == self.state:
            return
        old, self.state = self.state, state
        logger.info(
            "replica %d/%d: %s -> %s",
            self.config.replica_id, self.config.num_replicas, old, state,
        )

    # -- event plane -------------------------------------------------------

    def ingest(self, msg) -> None:
        """Direct delivery seam (benches/tests); production traffic arrives
        through the pool's partition-filtered ZMQ subscriber."""
        self.event_pool.add_task(msg)

    def topic_filters(self, pod_identifiers: Sequence[str]) -> List[str]:
        """ZMQ filter list for this replica's slice of a known fleet; feed
        to `ZMQSubscriber.resubscribe` on reassignment."""
        return self.partitioner.topic_filters(pod_identifiers)

    # -- snapshot / warm restart -------------------------------------------

    def take_snapshot(self, path: Optional[str] = None) -> dict:
        """Drain in-flight events, then write the view + seq watermarks."""
        path = path or self.config.snapshot_path
        if not path:
            raise ValueError("no snapshot path configured")
        self.event_pool.drain()
        seq_counters = (
            snapshot_mod.seq_counters_from_tracker(self.health)
            if self.health is not None
            else {}
        )
        now = self.clock()
        stats = snapshot_mod.write_snapshot(
            path, self.indexer.kv_block_index, seq_counters, created_ts=now
        )
        self.last_snapshot_ts = now
        return stats

    def warm_restart(
        self, path: Optional[str] = None, tail: Iterable = ()
    ) -> dict:
        """Snapshot-load + seq-tail replay; `replaying` until drained.

        `tail` is the retained event tail (Messages) from whatever journal
        the deployment keeps — the bench retains a bounded ring at the
        delivery seam. Replay rides the normal ingest path: the snapshot's
        floors drop anything already inside the imported view.
        """
        path = path or self.config.snapshot_path
        t0 = time.perf_counter()
        snap = snapshot_mod.read_snapshot(path)
        self._set_state(REPLAYING)
        imported = snapshot_mod.restore_index(
            self.indexer.kv_block_index, snap
        )
        floors = snap.seq_floors()
        self.event_pool.set_seq_floors(floors)
        skipped_before = self.event_pool.replay_skipped
        replayed = 0
        for msg in tail:
            self.event_pool.add_task(msg)
            replayed += 1
        self.event_pool.drain()
        self.event_pool.clear_seq_floors()
        self._set_state(READY)
        stats = {
            "snapshot_path": path,
            "snapshot_created_ts": snap.created_ts,
            "imported_pod_entries": imported,
            "seq_floors": len(floors),
            "tail_messages": replayed,
            "replay_skipped": (
                self.event_pool.replay_skipped - skipped_before
            ),
            "warm_restart_s": round(time.perf_counter() - t0, 6),
        }
        self.last_restart_stats = stats
        logger.info(
            "warm restart complete: %d entries imported, %d/%d tail "
            "messages were pre-floor no-ops, %.3fs",
            imported, stats["replay_skipped"], replayed,
            stats["warm_restart_s"],
        )
        return stats

    # -- introspection -----------------------------------------------------

    def snapshot_age_s(self) -> Optional[float]:
        if self.last_snapshot_ts is None:
            return None
        return max(0.0, self.clock() - self.last_snapshot_ts)

    def readiness(self) -> dict:
        """The /readyz `replication` section."""
        age = self.snapshot_age_s()
        return {
            "replica_id": self.config.replica_id,
            "num_replicas": self.config.num_replicas,
            "state": self.state,
            "snapshot_path": self.config.snapshot_path or None,
            "snapshot_age_s": None if age is None else round(age, 3),
            "partition_filtered_events": self.event_pool.filtered_events,
            "replay_skipped": self.event_pool.replay_skipped,
            "last_restart": self.last_restart_stats,
        }
