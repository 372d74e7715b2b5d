"""Scatter-gather scoring across indexer replicas.

Copy of the reference package's `cluster/scorer.py`.

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

import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch import obs
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
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
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

    # -- carrier-propagating forms (obs/carrier.py) ------------------------
    # The scatter-gather runs transports on executor threads, so even an
    # in-process replica loses the caller's thread-local trace; adopting
    # the carrier re-links its root trace to the caller's trace id, and
    # the exported spans ride back exactly like a gRPC reply's — one
    # assembly path for both transports.

    def get_pod_scores_ex_traced(
        self, prompt, model_name, pod_identifiers, lora_id=None, carrier=None
    ):
        with obs.adopt(carrier) as adoption:
            ps = self.indexer.get_pod_scores_ex(
                prompt, model_name, pod_identifiers, lora_id=lora_id
            )
        return ps, obs.export_trace(adoption.trace)

    def score_many_traced(self, requests, carrier=None):
        with obs.adopt(carrier) as adoption:
            results = self.indexer.score_many(requests)
        payload = obs.export_trace(adoption.trace)
        return results, ([payload] if payload is not None else [])


class GrpcReplicaTransport:
    """Remote replica over `kvtpu.api.v1.IndexerService/GetPodScoresEx`.

    The Ex method returns the scores PLUS match_blocks/block_hashes as a
    JSON payload (api/grpc_server.py — same no-protoc generic-handler
    pattern as ExplainScores), which is what the merge needs. Connection
    construction is lazy so building a cluster config never blocks on an
    unreachable peer.
    """

    def __init__(self, target: str, timeout_s: float = 1.0):
        self.target = target
        self.timeout_s = timeout_s
        self._client = None

    def _ensure_client(self):
        if self._client is None:
            from llm_d_kv_cache_manager_tpu_torch.api.grpc_server import (
                IndexerGrpcClient,
            )

            self._client = IndexerGrpcClient(self.target, timeout_s=self.timeout_s)
        return self._client

    @staticmethod
    def _to_pod_scores(payload: dict) -> PodScores:
        return PodScores(
            scores=dict(payload.get("scores", {})),
            match_blocks={
                p: int(n) for p, n in payload.get("match_blocks", {}).items()
            },
            block_hashes=[int(h) for h in payload.get("block_hashes", [])],
        )

    def get_pod_scores_ex(
        self, prompt: str, model_name: str, pod_identifiers, lora_id=None
    ) -> PodScores:
        return self.get_pod_scores_ex_traced(
            prompt, model_name, pod_identifiers, lora_id=lora_id
        )[0]

    def get_pod_scores_ex_traced(
        self, prompt, model_name, pod_identifiers, lora_id=None, carrier=None
    ):
        """Carrier-propagating form: the carrier rides the gRPC metadata,
        the replica runs its stages under the caller's trace id, and its
        span tuples come back as the reply's `trace` field (returned
        separately so the merge never sees it)."""
        import grpc

        try:
            payload = self._ensure_client().get_pod_scores_ex(
                prompt, model_name, pod_identifiers, lora_id=lora_id,
                carrier=carrier,
            )
        except (grpc.RpcError, json.JSONDecodeError, OSError) as e:
            raise ReplicaUnavailable(f"{self.target}: {e}") from e
        return self._to_pod_scores(payload), payload.get("trace")

    def score_many(self, requests) -> List[PodScores]:
        """Batched read path over the streaming `ScorePodsBulk` endpoint:
        the whole batch rides one gRPC stream (the server micro-batches it
        through `Indexer.score_many`), so a replica is crossed once per
        BATCH, not once per request."""
        return self.score_many_traced(requests)[0]

    def score_many_traced(self, requests, carrier=None):
        import grpc

        traces: List[dict] = []
        try:
            payloads = self._ensure_client().score_pods_bulk(
                [
                    {
                        "prompt": r.prompt,
                        "model_name": r.model_name,
                        "pod_identifiers": list(r.pod_identifiers),
                        "lora_id": r.lora_id,
                    }
                    for r in requests
                ],
                carrier=carrier,
                trace_sink=traces,
            )
        except (grpc.RpcError, json.JSONDecodeError, OSError) as e:
            raise ReplicaUnavailable(f"{self.target}: {e}") from e
        if len(payloads) != len(requests):
            raise ReplicaUnavailable(
                f"{self.target}: bulk stream returned {len(payloads)} "
                f"results for {len(requests)} requests"
            )
        return [self._to_pod_scores(p) for p in payloads], traces

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None


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
        # Monotonic per-instance counters (status surface; the Prometheus
        # counterpart is kvcache_replica_scatter_errors_total).
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
        with obs.request(
            "cluster.get_pod_scores", {"replicas": len(self.transports)}
        ) as trace:
            return self._scatter_gather(
                prompt, model_name, pod_identifiers, lora_id, trace
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
        with obs.request(
            "cluster.score_many",
            {"replicas": len(self.transports), "batch": len(requests)},
        ) as trace:
            replies = self._fan_out(
                trace, "score_many", "score_many_traced", requests,
            )
            t_merge = time.perf_counter()
            merged = [
                self._merge([(rid, reply[i]) for rid, reply in replies])
                for i in range(len(requests))
            ]
            obs.record_into(trace, "cluster.merge", t_merge, time.perf_counter())
            return merged

    def _fan_out(self, trace, method, traced_method, *args):
        """One scatter wave: submit the call to every live replica, gather
        under the fan-out deadline, degrade per replica. When the caller
        has a trace, its carrier rides to every replica that supports the
        traced transport form and the replies' span payloads are grafted
        back under per-replica `cluster.rpc` hop spans — the recorder
        then holds ONE cross-process tree for the request."""
        self.scatter_calls += 1
        targets = self._live_replicas()
        carrier = obs.current_carrier() if trace is not None else None

        def call(rid: int):
            transport = self.transports[rid]
            traced = (
                getattr(transport, traced_method, None)
                if carrier is not None else None
            )
            t0 = time.perf_counter()
            if traced is not None:
                result, remote = traced(*args, carrier=carrier)
            else:
                result = getattr(transport, method)(*args)
                remote = None
            return result, remote, t0, time.perf_counter()

        t_fan = time.perf_counter()
        futures = [
            (rid, self._executor.submit(call, rid)) for rid in targets
        ]
        deadline = time.perf_counter() + self.config.scatter_timeout_s
        replies = []
        grafts = []
        degraded: List[int] = []
        for rid, fut in futures:
            budget = max(0.0, deadline - time.perf_counter())
            try:
                result, remote, t0c, t1c = fut.result(timeout=budget)
            except Exception as e:  # noqa: BLE001 - degrade per replica
                fut.cancel()
                self._observe_failure(rid, e)
                degraded.append(rid)
                continue
            self._observe_success(rid)
            replies.append((rid, result))
            if carrier is not None:
                grafts.append((rid, remote, t0c, t1c))
        # One fan-out window for the whole wave, then per-replica rpc hop
        # spans with the replicas' own stages grafted inside them. Which
        # replicas participated/degraded rides in the trace meta (ids are
        # data, never metric labels — cardinality stays bounded).
        obs.record_into(trace, "cluster.fanout", t_fan, time.perf_counter())
        for rid, remote, t0c, t1c in grafts:
            if isinstance(remote, list):
                payloads = [p for p in remote if p] or [None]
            else:
                payloads = [remote]
            for k, payload in enumerate(payloads):
                obs.graft_remote(
                    trace, payload, t0c, t1c, hop="cluster.rpc", depth=2,
                    add_hop=(k == 0),
                )
            obs.annotate("rpc_replicas", self.replica_name(rid))
        if trace is not None and getattr(trace, "meta", None) is not None:
            trace.meta["degraded_replicas"] = degraded
        if degraded:
            kvlog.trace(
                logger,
                "scatter-gather degraded: replicas %s contributed no signal",
                degraded,
            )
        return replies

    def _scatter_gather(
        self, prompt, model_name, pod_identifiers, lora_id, trace
    ) -> PodScores:
        replies = self._fan_out(
            trace, "get_pod_scores_ex", "get_pod_scores_ex_traced",
            prompt, model_name, pod_identifiers, lora_id,
        )
        t_merge = time.perf_counter()
        merged = self._merge(replies)
        obs.record_into(trace, "cluster.merge", t_merge, time.perf_counter())
        return merged

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
        metrics.count_scatter_error()
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
