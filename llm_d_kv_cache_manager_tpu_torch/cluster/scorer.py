"""Scatter-gather scoring across indexer replicas.

Copy of the reference package's `cluster/scorer.py`, without its tracing
spans and metrics counter, the carrier-propagating `*_traced` transport
forms, and the gRPC transport (all of which come with the port's
service surfaces and tracing spine, ROADMAP.md queue 1 item 7):
`GrpcReplicaTransport` raises at construction.

`ClusterScorer` is the router-facing front of the replicated control plane:
it fans one `get_pod_scores_ex` call across every live replica, merges the
per-partition answers, and degrades — never stalls — when a replica is
down.

**Merge rule.** Partitioning assigns each pod's event stream to exactly one
replica (cluster/partition.py), and `LongestPrefixScorer` accumulates each
pod's score from that pod's entries alone, so replica R's answer for the
pods it owns is exactly what the monolithic indexer would compute for them.
The merge is therefore a disjoint union keyed by ownership: pod P's score,
matched-prefix length, and missing tail come from replica
`partitioner.replica_for(P)` and nowhere else (a stray entry on a
non-owning replica — possible mid-reassignment — can never override the
owner). The prompt's block-hash chain is derivation-side and identical on
every replica; the first successful reply supplies it. With all partitions
answering, the merged result is bit-identical to a single-replica run over
the same event stream — pinned by tests/test_cluster.py.

**Degradation.** A replica that errors or misses the fan-out deadline
contributes nothing: the pods it owns simply carry no cache signal this
request (the same explicit no-signal contract fleet-health degradation
uses), and the router's load fallback covers them. Replica liveness reuses
the fleethealth state machine with replica ids in place of pods: successful
responses stamp liveness, silent replicas decay healthy → suspect → stale,
and stale replicas are skipped entirely — one probe per
`replica_stale_after_s` window rather than a timeout on every request.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.cluster.partition import (
    ClusterConfig,
    ReplicaPartitioner,
)
from llm_d_kv_cache_manager_tpu_torch.fleethealth import (
    STALE,
    FleetHealthConfig,
    FleetHealthTracker,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import PodScores
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("cluster.scorer")


class ReplicaUnavailable(Exception):
    """Transport-level failure talking to one replica (degrade, don't fail)."""


class LocalReplicaTransport:
    """In-process replica: wraps an Indexer (or IndexerReplica.indexer)."""

    def __init__(self, indexer):
        self.indexer = indexer

    def get_pod_scores_ex(
        self, prompt: str, model_name: str, pod_identifiers, lora_id=None
    ) -> PodScores:
        return self.indexer.get_pod_scores_ex(
            prompt, model_name, pod_identifiers, lora_id=lora_id
        )

    def score_many(self, requests) -> List[PodScores]:
        """Batched read path against the wrapped indexer (one amortized
        pass instead of N single calls)."""
        return self.indexer.score_many(requests)



class GrpcReplicaTransport:
    """Remote replica over `kvtpu.api.v1.IndexerService/GetPodScoresEx`:
    the reference's gRPC server and client are not ported yet."""

    def __init__(self, target: str, timeout_s: float = 1.0):
        raise NotImplementedError(
            "GrpcReplicaTransport needs the gRPC service surface, which the "
            "port still owes (ROADMAP.md queue 1 item 7); use "
            "LocalReplicaTransport"
        )


class ClusterScorer:
    """N replicas behind one `get_pod_scores` — the router's single front."""

    def __init__(
        self,
        transports: Sequence[object],
        partitioner: Optional[ReplicaPartitioner] = None,
        config: Optional[ClusterConfig] = None,
        clock=time.monotonic,
    ):
        if not transports:
            raise ValueError("ClusterScorer needs at least one transport")
        self.config = config or ClusterConfig(num_replicas=len(transports))
        if len(transports) != self.config.num_replicas:
            raise ValueError(
                f"{len(transports)} transports for "
                f"{self.config.num_replicas} replicas"
            )
        self.transports = list(transports)
        self.partitioner = partitioner or ReplicaPartitioner(len(transports))
        # Replica liveness: the fleethealth state machine verbatim, with
        # replica names as the tracked identities. auto_quarantine off —
        # there is no index to purge; exclusion happens at fan-out time.
        self.health = FleetHealthTracker(
            FleetHealthConfig(
                suspect_after_s=self.config.replica_suspect_after_s,
                stale_after_s=self.config.replica_stale_after_s,
                auto_quarantine=False,
            ),
            clock=clock,
        )
        self.clock = clock
        self._executor = ThreadPoolExecutor(
            max_workers=len(transports), thread_name_prefix="cluster-scatter"
        )
        # Monotonic per-instance counters (the status surface).
        self.scatter_calls = 0
        self.scatter_errors = 0

    @staticmethod
    def replica_name(replica_id: int) -> str:
        return f"replica-{replica_id}"

    def close(self) -> None:
        self._executor.shutdown(wait=False)
        for t in self.transports:
            close = getattr(t, "close", None)
            if close is not None:
                close()

    # -- read path ---------------------------------------------------------

    def get_pod_scores(
        self, prompt: str, model_name: str, pod_identifiers, lora_id=None
    ) -> Dict[str, float]:
        return self.get_pod_scores_ex(
            prompt, model_name, pod_identifiers, lora_id=lora_id
        ).scores

    def get_pod_scores_ex(
        self, prompt: str, model_name: str, pod_identifiers, lora_id=None
    ) -> PodScores:
        return self._scatter_gather(
            prompt, model_name, pod_identifiers, lora_id
        )

    def score_many(self, requests) -> List[PodScores]:
        """Batched scatter-gather: ONE fan-out wave covers the whole
        router batch — each live replica is crossed once per batch (its
        transport's `score_many`), and every item's answer merges under
        the same ownership-keyed rule as `get_pod_scores_ex`. Results are
        bit-identical to per-request scatter-gather over the same state
        (pinned by tests/test_score_many.py at N=2 replicas); a replica
        that fails or misses the deadline contributes no signal to ANY
        item of this batch — the per-partition no-signal degradation,
        batch-scoped."""
        if not requests:
            return []
        requests = list(requests)
        replies = self._fan_out("score_many", requests)
        return [
            self._merge([(rid, reply[i]) for rid, reply in replies])
            for i in range(len(requests))
        ]

    def _fan_out(self, method, *args):
        """One scatter wave: submit the call to every live replica, gather
        under the fan-out deadline, degrade per replica."""
        self.scatter_calls += 1
        targets = self._live_replicas()

        def call(rid: int):
            return getattr(self.transports[rid], method)(*args)

        futures = [
            (rid, self._executor.submit(call, rid)) for rid in targets
        ]
        deadline = time.perf_counter() + self.config.scatter_timeout_s
        replies = []
        degraded: List[int] = []
        for rid, fut in futures:
            budget = max(0.0, deadline - time.perf_counter())
            try:
                result = fut.result(timeout=budget)
            except Exception as e:  # noqa: BLE001 - degrade per replica
                fut.cancel()
                self._observe_failure(rid, e)
                degraded.append(rid)
                continue
            self._observe_success(rid)
            replies.append((rid, result))
        if degraded:
            kvlog.trace(
                logger,
                "scatter-gather degraded: replicas %s contributed no signal",
                degraded,
            )
        return replies

    def _scatter_gather(
        self, prompt, model_name, pod_identifiers, lora_id
    ) -> PodScores:
        replies = self._fan_out(
            "get_pod_scores_ex", prompt, model_name, pod_identifiers, lora_id,
        )
        return self._merge(replies)

    def _live_replicas(self) -> List[int]:
        """All replicas except stale ones — with the carve-out that a stale
        replica is still probed once per refresh of its state (otherwise
        nothing could ever mark it healthy again)."""
        out = []
        for rid in range(len(self.transports)):
            name = self.replica_name(rid)
            if self.health.state_of(name) != STALE:
                out.append(rid)
            else:
                rec = self.health.summary()["pods"].get(name, {})
                # Probe a stale replica at most once per stale window.
                age = rec.get("last_event_age_s")
                if age is not None and (
                    age % self.config.replica_stale_after_s
                ) < self.config.scatter_timeout_s:
                    out.append(rid)
        return out or list(range(len(self.transports)))

    def _observe_success(self, rid: int) -> None:
        self.health.observe_batch(
            self.replica_name(rid), "scatter", None, self.clock()
        )

    def _observe_failure(self, rid: int, e: Exception) -> None:
        self.scatter_errors += 1
        # A failing replica provides no liveness evidence — the tracker's
        # quiet-stream windows do the demotion; the failure count is kept
        # on the record like a decode failure (stream alive but useless).
        self.health.observe_decode_failure(self.replica_name(rid))
        logger.warning(
            "replica %d scatter failed (%s): its partition carries no "
            "cache signal for this request", rid, e,
        )

    def _merge(self, replies: List[Tuple[int, PodScores]]) -> PodScores:
        merged = PodScores()
        replica_for = self.partitioner.replica_for
        for rid, ps in replies:
            if not merged.block_hashes and ps.block_hashes:
                merged.block_hashes = ps.block_hashes
            for pod, score in ps.scores.items():
                if replica_for(pod) == rid:
                    merged.scores[pod] = score
            for pod, n in ps.match_blocks.items():
                if replica_for(pod) == rid:
                    merged.match_blocks[pod] = n
        return merged

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        """Cluster-status document (/cluster/status, gRPC ClusterStatus)."""
        summary = self.health.summary()
        replicas = {}
        for rid in range(len(self.transports)):
            name = self.replica_name(rid)
            rec = summary["pods"].get(name)
            replicas[name] = {
                "state": rec["state"] if rec else "healthy",
                "last_response_age_s": (
                    rec["last_event_age_s"] if rec else None
                ),
                "failures": rec["decode_failures"] if rec else 0,
                "transport": type(self.transports[rid]).__name__,
            }
        return {
            "partitioner": self.partitioner.as_dict(),
            "replicas": replicas,
            "scatter_calls": self.scatter_calls,
            "scatter_errors": self.scatter_errors,
            "scatter_timeout_s": self.config.scatter_timeout_s,
        }
