"""HTTP scoring service — the shipped container entrypoint.

Copy of the reference package's `api/http_service.py` (after the Go
reference's examples/kv_events/online/main.go, its Dockerfile entrypoint):
one process wiring the Indexer read path, the ZMQ KVEvents write plane, and
Prometheus metrics behind HTTP. Every route, handler and environment
variable is the reference's. It is served by the standard library instead
of aiohttp: `api/web.py` keeps the handful of `aiohttp.web` names the
handlers use (`Request`, `Response`, `json_response`, `Application`,
`run_app`) over an asyncio-streams HTTP/1.1 server, so every handler stays
the reference's coroutine, and `/metrics` serves the port's own registry
(`metrics/registry.py`) in the text format 0.0.4.

  POST /score_completions       {"prompt", "model", "pods"?} -> {"podScores"}
  POST /score_completions/batch {"requests": [{"prompt", "model", "pods"?,
                                 "lora_id"?}, ...]} -> {"results":
                                [{"podScores"}, ...]} — the whole batch
                                runs through Indexer.score_many (one
                                amortized read-path pass, per-item
                                results bit-identical to N single calls);
                                batch size capped by SCORE_BATCH_MAX
  POST /score_chat_completions  {"messages"/"conversations", "model",
                                 "chat_template"?, "pods"?}
                                -> {"podScores", "templated_messages"}
  GET  /metrics                 Prometheus exposition
  GET  /health                  liveness (the process is up, nothing more)
  GET  /readyz                  readiness: event-plane state (subscriber
                                thread + consecutive bind failures, shard
                                queue depths, drop counters), the per-pod
                                fleet-health summary, and the flight
                                recorder's own health (`obs` section);
                                503 while the event plane cannot make
                                progress
  GET  /cluster/status          replication introspection: this replica's
                                partition + readiness state and (when a
                                scatter-gather front is wired) per-replica
                                health
  GET  /routing/status          saturation-resilience introspection:
                                routing policy config/override stats +
                                per-pod load snapshot, admission gate
                                depth and shed counters
  POST /pod_load                pod-load reporter seam: {"pod",
                                "queue_depth"?, "inflight"?, "busy_s"?}
                                feeds the load_blend routing policy
                                (400 unless ROUTING_POLICY=load_blend)
  POST /cluster/snapshot        drain + write this replica's index
                                snapshot (view + seq watermarks) to
                                CLUSTER_SNAPSHOT_PATH
  GET  /federation/status       federation introspection: per-region
                                digest age + staleness state (healthy/
                                suspect/stale), stale regions, route/
                                failover/digest counters
  GET/POST /federation/score    two-level scoring entry: region pick over
                                shipped digests, precise delegation, pod
                                scores + region decision evidence
                                (same params as /score_completions plus
                                optional home_region)
  GET/POST /federation/digest   the digest shipping seam: GET builds this
                                region's encoded RegionDigest; POST
                                ingests a peer's
  GET  /prediction/status       anticipatory-prefetch introspection:
                                session-table occupancy/ETA evidence (the
                                soonest-expected sessions), misprediction
                                counters, and — when an embedder wires
                                them — the scheduler's policy stats and
                                the prefetch queue's per-source drops
  GET  /antientropy/status      index anti-entropy introspection: per-pod
                                advertised-vs-verified accuracy EWMA +
                                demotion factor, purge/readmit counters,
                                auditor + fetch-feedback stats when an
                                embedder wired them (also the /readyz
                                `index_health` section)
  GET  /slo/status              SLO burn-rate evaluation (obs/slo.py):
                                per-objective fast/slow-window burn
                                rates off the live registry, breach
                                status (also a /readyz `slo` section)
  GET  /autopilot/status        SLO-autopilot introspection (one
                                rate-limited controller tick, then the
                                document): knob positions vs baseline,
                                per-rule firing/breach evidence, the
                                recent actuation journal tail (also a
                                /readyz `autopilot` section)
  GET  /debug/traces            flight recorder dump: recent complete
                                traces + the slow-outlier reservoir.
                                Filters: ?limit= (alias n=), ?plane=,
                                ?min_ms=, ?trace_id= (exact 16-hex
                                distributed id), ?crit=1 attaches each
                                trace's critical-path breakdown
  GET  /debug/critical_path     window summary: per-(span, hop)
                                critical-path self-time over the recent
                                ring, grouped by root (?root= filters)
  GET  /debug/score_explain     score with the decision evidence attached
                                (per-pod matched prefix, fleet-health
                                adjustment, chain-memo family, chosen
                                pod); scores bit-identical to the scoring
                                endpoints. Query params prompt/model/
                                pods/lora_id, or POST the same JSON body
                                as /score_completions.

Env config mirrors the reference's variable set (online/main.go:41-58):
ZMQ_ENDPOINT, ZMQ_TOPIC, POOL_CONCURRENCY, PYTHONHASHSEED (hash seed!),
BLOCK_SIZE, BLOCK_HASH_ALGO, HTTP_PORT, HF_TOKEN, LOCAL_TOKENIZER_DIR,
the fleet-health windows SUSPECT_AFTER_S / STALE_AFTER_S, the tracing
spine knobs KVTPU_TRACE / KVTPU_TRACE_RING / KVTPU_TRACE_SLOW_MS /
KVTPU_TRACE_PROPAGATE, the SLO plane SLO / SLO_FAST_WINDOW_S /
SLO_SLOW_WINDOW_S / SLO_BURN_THRESHOLD / SLO_READ_P99_MS /
SLO_READ_BUDGET / SLO_HIT_RATE_FLOOR / SLO_SHED_RATE_CEILING, the
admission gate ADMISSION / ADMISSION_MAX_CONCURRENCY /
ADMISSION_QUEUE_DEPTH / ADMISSION_MAX_WAIT_MS / ADMISSION_RETRY_AFTER_MS
(scoring endpoints shed with 429 + Retry-After past the bounds; the
client's remaining budget propagates via the X-Request-Deadline-Ms
header), the load-aware routing policy ROUTING_POLICY /
ROUTING_LOAD_WEIGHT / ROUTING_QUEUE_NORM / ROUTING_BUSY_NORM_S /
ROUTING_PREEMPTION_NORM, the federation tier FEDERATION /
FEDERATION_REGION_ID / FEDERATION_REGIONS / FEDERATION_PEERS /
FEDERATION_DIGEST_INTERVAL_S / FEDERATION_DIGEST_SUSPECT_S /
FEDERATION_DIGEST_STALE_S, and the session predictor PREDICTION /
PREDICTION_MAX_SESSIONS / PREDICTION_ETA_ALPHA /
PREDICTION_MAX_CHAIN_BLOCKS / PREDICTION_DEFAULT_ETA_S (PREDICTION=0,
the default, keeps the read path byte-for-byte — the table is pure
observation even when on), and the index anti-entropy loop ANTIENTROPY /
ANTIENTROPY_ACCURACY_ALPHA / ANTIENTROPY_DISTRUST_THRESHOLD /
ANTIENTROPY_MIN_FACTOR / ANTIENTROPY_AUDIT_INTERVAL_S /
ANTIENTROPY_AUDIT_SAMPLE (ANTIENTROPY=0 default; on, scores stay
bit-identical while the fleet stays truthful — the tracker only demotes
on verified divergence), and the SLO autopilot AUTOPILOT /
AUTOPILOT_MIN_INTERVAL_S / AUTOPILOT_WARMUP_S / AUTOPILOT_COOLDOWN_S /
AUTOPILOT_DECAY_AFTER_S (AUTOPILOT=0 default; on with healthy signals,
every knob stays bit-identical to the operator's configuration — the
controller only actuates while an SLO burns, and walks every knob back
to baseline once it stops).

Run: python -m llm_d_kv_cache_manager_tpu_torch.api.http_service
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Optional


from llm_d_kv_cache_manager_tpu_torch import obs
from llm_d_kv_cache_manager_tpu_torch.api import web
from llm_d_kv_cache_manager_tpu_torch.api.admission import AdmissionRejected
from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import Indexer, IndexerConfig
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.chain_memo import ChainMemoConfig
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import IndexConfig
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    TokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu_torch.fleethealth import (
    FleetHealthConfig,
    FleetHealthTracker,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import EventPool, EventPoolConfig
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics_collector
from llm_d_kv_cache_manager_tpu_torch.preprocessing.chat_completions import (
    ChatTemplatingProcessor,
    RenderRequest,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.pool import TokenizersPoolConfig
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("api.http")


def config_from_env() -> dict:
    return {
        "zmq_endpoint": os.environ.get("ZMQ_ENDPOINT", "tcp://*:5557"),
        "zmq_topic": os.environ.get("ZMQ_TOPIC", "kv@"),
        "pool_concurrency": int(os.environ.get("POOL_CONCURRENCY", "4")),
        "hash_seed": os.environ.get("PYTHONHASHSEED", ""),
        # "fnv64_cbor" (reference parity) or "sha256_cbor_64bit" (bit-exact
        # with vLLM --prefix-caching-hash-algo=sha256_cbor_64bit fleets).
        "hash_algo": os.environ.get("BLOCK_HASH_ALGO", "fnv64_cbor"),
        "block_size": int(os.environ.get("BLOCK_SIZE", "16")),
        # Chain-state memo (incremental block-key derivation). CHAIN_MEMO=0
        # pins the from-scratch path; keys are bit-identical either way.
        "chain_memo": os.environ.get("CHAIN_MEMO", "1") == "1",
        "chain_memo_capacity": int(
            os.environ.get("CHAIN_MEMO_CAPACITY", "131072")
        ),
        "http_port": int(os.environ.get("HTTP_PORT", "8080")),
        # Batched read path (score_many): the largest batch one
        # /score_completions/batch call (or one gRPC ScorePodsBulk
        # micro-batch window) may score, and how long the gRPC stream's
        # micro-batcher waits after a window's first item for stragglers
        # (0 = score whatever has arrived, never wait).
        "score_batch_max": int(os.environ.get("SCORE_BATCH_MAX", "128")),
        "score_batch_window_ms": float(
            os.environ.get("SCORE_BATCH_WINDOW_MS", "0")
        ),
        "hf_token": os.environ.get("HF_TOKEN"),
        "enable_hf": os.environ.get("ENABLE_HF_TOKENIZER", "") == "1",
        "enable_metrics": os.environ.get("ENABLE_METRICS", "1") == "1",
        # Shared index backend (redis:// or valkey:// URL) for multi-replica
        # managers; empty -> in-memory index.
        "index_url": os.environ.get("INDEX_URL", ""),
        # Native scoring core (kvcache/kvblock/native_index.py):
        # NATIVE_SCORING=1 backs the in-memory index with the C arena —
        # the whole read path (lookup + longest-prefix score + per-pod
        # adjustments) and event digestion each run in one GIL-released
        # crossing. Scores are bit-identical to the Python path (pinned
        # by the differential-fuzz suites); the C arena is built at first
        # use, and a failed build raises rather than degrading. Ignored
        # when INDEX_URL selects a shared backend.
        "native_scoring": os.environ.get("NATIVE_SCORING", "0") == "1",
        # UDS tokenizer sidecar socket; empty -> local tokenization only.
        "uds_socket": os.environ.get("UDS_SOCKET", ""),
        # Fleet-health windows (fleethealth/tracker.py): event silence
        # beyond these demotes / excludes-and-purges a pod.
        "suspect_after_s": float(os.environ.get("SUSPECT_AFTER_S", "30")),
        "stale_after_s": float(os.environ.get("STALE_AFTER_S", "120")),
        # Tracing spine (obs/): per-request spans + flight recorder, plus
        # cross-process carrier propagation (obs/carrier.py) — off, every
        # process traces independently; scores identical either way.
        "trace_enabled": os.environ.get("KVTPU_TRACE", "1") == "1",
        "trace_ring": int(os.environ.get("KVTPU_TRACE_RING", "256")),
        "trace_slow_ms": float(os.environ.get("KVTPU_TRACE_SLOW_MS", "10")),
        "trace_propagate": os.environ.get("KVTPU_TRACE_PROPAGATE", "1") == "1",
        # SLO plane (obs/slo.py): declarative objectives evaluated from
        # the live Prometheus registry with fast+slow multi-window burn
        # rates (GET /slo/status, /readyz `slo` section,
        # kvcache_slo_burn_rate gauges). SLO=0 removes the monitor.
        "slo": os.environ.get("SLO", "1") == "1",
        "slo_fast_window_s": float(os.environ.get("SLO_FAST_WINDOW_S", "300")),
        "slo_slow_window_s": float(
            os.environ.get("SLO_SLOW_WINDOW_S", "3600")
        ),
        "slo_burn_threshold": float(
            os.environ.get("SLO_BURN_THRESHOLD", "2.0")
        ),
        "slo_read_p99_ms": float(os.environ.get("SLO_READ_P99_MS", "5")),
        "slo_read_budget": float(os.environ.get("SLO_READ_BUDGET", "0.01")),
        "slo_hit_rate_floor": float(
            os.environ.get("SLO_HIT_RATE_FLOOR", "0.5")
        ),
        "slo_shed_rate_ceiling": float(
            os.environ.get("SLO_SHED_RATE_CEILING", "0.01")
        ),
        # Replicated control plane (cluster/): this process's membership in
        # the logical index. CLUSTER_REPLICAS=1 (default) is the monolithic
        # deployment — no partition gate, no replication section.
        "cluster_replicas": int(os.environ.get("CLUSTER_REPLICAS", "1")),
        "cluster_replica_id": int(os.environ.get("CLUSTER_REPLICA_ID", "0")),
        "cluster_snapshot_path": os.environ.get("CLUSTER_SNAPSHOT_PATH", ""),
        # Predictive placement (placement/): PLACEMENT=1 attaches the
        # hot-prefix popularity tracker to the read path, the event pool,
        # and (when the backends support it) the instrumented/cost-aware
        # index — observation only; scores stay bit-identical. PLACEMENT=0
        # (default) leaves every hook None.
        "placement": os.environ.get("PLACEMENT", "0") == "1",
        "placement_top_k": int(os.environ.get("PLACEMENT_TOP_K", "64")),
        "placement_half_life_s": float(
            os.environ.get("PLACEMENT_HALF_LIFE_S", "120")
        ),
        "placement_hotness": float(
            os.environ.get("PLACEMENT_HOTNESS", "30")
        ),
        # Hierarchical federation (federation/): FEDERATION=1 attaches a
        # GlobalRouter over this region's indexer (+ the popularity
        # tracker the digests ship) and opens the /federation/* surface.
        # Peers are other regions' scoring fronts ("region=host:port",
        # reached over the same gRPC transport the cluster scatter-gather
        # uses). Single-region (no FEDERATION_REGIONS) stays pinned
        # bit-identical to the flat read path.
        "federation": os.environ.get("FEDERATION", "0") == "1",
        "federation_region_id": os.environ.get(
            "FEDERATION_REGION_ID", "region-0"
        ),
        "federation_regions": [
            r for r in os.environ.get("FEDERATION_REGIONS", "").split(",")
            if r
        ],
        "federation_peers": os.environ.get("FEDERATION_PEERS", ""),
        "federation_digest_interval_s": float(
            os.environ.get("FEDERATION_DIGEST_INTERVAL_S", "5")
        ),
        "federation_digest_suspect_s": float(
            os.environ.get("FEDERATION_DIGEST_SUSPECT_S", "15")
        ),
        "federation_digest_stale_s": float(
            os.environ.get("FEDERATION_DIGEST_STALE_S", "45")
        ),
        # Admission control (api/admission.py): bounded concurrency +
        # bounded waiting line on the scoring endpoints; past the bounds
        # requests are shed with 429 + Retry-After instead of queueing
        # without limit. ADMISSION=0 removes the gate entirely.
        "admission": os.environ.get("ADMISSION", "1") == "1",
        "admission_max_concurrency": int(
            os.environ.get("ADMISSION_MAX_CONCURRENCY", "8")
        ),
        "admission_queue_depth": int(
            os.environ.get("ADMISSION_QUEUE_DEPTH", "64")
        ),
        "admission_max_wait_ms": float(
            os.environ.get("ADMISSION_MAX_WAIT_MS", "1000")
        ),
        "admission_retry_after_ms": float(
            os.environ.get("ADMISSION_RETRY_AFTER_MS", "1000")
        ),
        # Load-aware routing policy (kvcache/routing.py): prefix_only
        # (default) is pinned bit-identical to the pure prefix read path;
        # load_blend divides each pod's prefix score by its normalized
        # load (queue depth / busy seconds / decayed preemption rate, fed
        # by POST /pod_load reports and the kvevents BlockRemoved stream).
        "routing_policy": os.environ.get("ROUTING_POLICY", "prefix_only"),
        "routing_load_weight": float(
            os.environ.get("ROUTING_LOAD_WEIGHT", "1.0")
        ),
        "routing_queue_norm": float(
            os.environ.get("ROUTING_QUEUE_NORM", "4.0")
        ),
        "routing_busy_norm_s": float(
            os.environ.get("ROUTING_BUSY_NORM_S", "1.0")
        ),
        "routing_preemption_norm": float(
            os.environ.get("ROUTING_PREEMPTION_NORM", "8.0")
        ),
        # Anticipatory prefetch (prediction/): PREDICTION=1 attaches the
        # session predictor's table at the read-path observation seam.
        # Observation only — scores stay bit-identical; the prefetch
        # scheduler itself needs a prefetch plane to the engine fleet, so
        # embedders wire a PrefetchScheduler + RoutePrefetcher and assign
        # them to `self.prefetch_scheduler` / `self.route_prefetcher` to
        # surface through /prediction/status and /readyz. PREDICTION=0
        # (default) leaves the seam None.
        "prediction": os.environ.get("PREDICTION", "0") == "1",
        "prediction_max_sessions": int(
            os.environ.get("PREDICTION_MAX_SESSIONS", "1024")
        ),
        "prediction_eta_alpha": float(
            os.environ.get("PREDICTION_ETA_ALPHA", "0.4")
        ),
        "prediction_max_chain_blocks": int(
            os.environ.get("PREDICTION_MAX_CHAIN_BLOCKS", "256")
        ),
        "prediction_default_eta_s": float(
            os.environ.get("PREDICTION_DEFAULT_ETA_S", "8")
        ),
        # Index anti-entropy (antientropy/): ANTIENTROPY=1 attaches the
        # per-pod trust tracker at the score-filter seam (truth-weighted
        # demotion; bit-identical while the fleet stays truthful) and the
        # orphan-removal probe in the event pool. The residency auditor
        # and fetch-miss feedback need pod digest / data-plane seams only
        # an embedder owns — assign to `self.auditor` /
        # `self.fetch_feedback` to surface them through /readyz
        # `index_health`. ANTIENTROPY=0 (default) leaves every hook None.
        "antientropy": os.environ.get("ANTIENTROPY", "0") == "1",
        "antientropy_accuracy_alpha": float(
            os.environ.get("ANTIENTROPY_ACCURACY_ALPHA", "0.3")
        ),
        "antientropy_distrust_threshold": float(
            os.environ.get("ANTIENTROPY_DISTRUST_THRESHOLD", "0.9")
        ),
        "antientropy_min_factor": float(
            os.environ.get("ANTIENTROPY_MIN_FACTOR", "0.25")
        ),
        "antientropy_audit_interval_s": float(
            os.environ.get("ANTIENTROPY_AUDIT_INTERVAL_S", "10")
        ),
        "antientropy_audit_sample": int(
            os.environ.get("ANTIENTROPY_AUDIT_SAMPLE", "16")
        ),
        # SLO autopilot (autopilot/): AUTOPILOT=1 attaches the closed-loop
        # controller over whatever knobs this process's subsystems
        # publish (the admission gate at minimum; embedder-wired
        # subsystems register theirs against `service.autopilot_registry`).
        # Ticks ride the /autopilot/status and /readyz poll cadence — no
        # background thread. AUTOPILOT=0 (default) leaves the plane None;
        # on with healthy signals, every knob stays bit-identical to the
        # operator's configuration.
        "autopilot": os.environ.get("AUTOPILOT", "0") == "1",
        "autopilot_min_interval_s": float(
            os.environ.get("AUTOPILOT_MIN_INTERVAL_S", "1")
        ),
        "autopilot_warmup_s": float(
            os.environ.get("AUTOPILOT_WARMUP_S", "10")
        ),
        "autopilot_cooldown_s": float(
            os.environ.get("AUTOPILOT_COOLDOWN_S", "5")
        ),
        "autopilot_decay_after_s": float(
            os.environ.get("AUTOPILOT_DECAY_AFTER_S", "15")
        ),
        # Resource governor (resourcegov/): RESOURCEGOV=1 attaches the
        # accountant + pressure state machine over every stateful
        # structure this construction wired. Ticks ride the /readyz and
        # /resource/status poll cadence — no background thread. The
        # departed-entity reaper is attached unconditionally (membership
        # leaves must shrink per-pod maps with or without a budget).
        # RESOURCEGOV=0 (default) leaves the governor None; a fleet that
        # never crosses the budget sheds nothing and scores
        # bit-identically either way.
        "resourcegov": os.environ.get("RESOURCEGOV", "0") == "1",
        "resourcegov_budget_mb": float(
            os.environ.get("RESOURCEGOV_BUDGET_MB", "256")
        ),
        "resourcegov_cooldown_s": float(
            os.environ.get("RESOURCEGOV_COOLDOWN_S", "10")
        ),
        "resourcegov_rss_probe": (
            os.environ.get("RESOURCEGOV_RSS_PROBE", "0") == "1"
        ),
    }


class _LazyStatusSource:
    """SignalAssembler source resolving its target per snapshot — the
    autopilot can see subsystems an embedder wires AFTER the service is
    constructed (route prefetcher, transfer client) without re-wiring."""

    def __init__(self, resolve):
        self._resolve = resolve

    def status(self) -> dict:
        target = self._resolve()
        return target.status() if target is not None else {}


def _peek_transfer_client():
    from llm_d_kv_cache_manager_tpu_torch.kv_connectors import (
        connector as conn_mod,
    )

    return conn_mod.peek_default_client()


class ScoringService:
    """Owns the Indexer (read path) + EventPool (write plane)."""

    def __init__(
        self,
        env: Optional[dict] = None,
        indexer: Optional[Indexer] = None,
        cluster_replica=None,
    ):
        env = env or config_from_env()
        self.env = env
        # Tracing spine knobs (obs/). Only reconfigure when the env spells
        # them out — embedded/test construction respects whatever the
        # process already configured.
        if "trace_enabled" in env:
            obs.configure(obs.ObsConfig(
                enabled=bool(env.get("trace_enabled", True)),
                ring_capacity=int(env.get("trace_ring", 256)),
                slow_threshold_s=float(env.get("trace_slow_ms", 10)) / 1e3,
                propagate=bool(env.get("trace_propagate", True)),
            ))
        self.templating = ChatTemplatingProcessor()
        self.fleet_health = FleetHealthTracker(FleetHealthConfig(
            suspect_after_s=float(env.get("suspect_after_s", 30.0)),
            stale_after_s=float(env.get("stale_after_s", 120.0)),
        ))
        self._started = False

        # Admission gate (api/admission.py): one controller shared by
        # every scoring endpoint (and handed to serve_grpc when a gRPC
        # front is started next to this service), so the process has ONE
        # bounded budget rather than per-transport invisible queues.
        self.admission = None
        if env.get("admission", True):
            from llm_d_kv_cache_manager_tpu_torch.api.admission import (
                AdmissionConfig,
                AdmissionController,
            )

            self.admission = AdmissionController(AdmissionConfig(
                max_concurrency=int(env.get("admission_max_concurrency", 8)),
                max_queue_depth=int(env.get("admission_queue_depth", 64)),
                max_wait_s=float(env.get("admission_max_wait_ms", 1000)) / 1e3,
                retry_after_s=(
                    float(env.get("admission_retry_after_ms", 1000)) / 1e3
                ),
            ))

        # SLO plane (obs/slo.py): one monitor over the live Prometheus
        # registry. Evaluation is pull-based (/slo/status, /readyz, the
        # scrape cadence); no background thread. A breach never gates
        # readiness — it is an alert, not a liveness failure.
        self.slo = None
        if env.get("slo", True):
            from llm_d_kv_cache_manager_tpu_torch.obs.slo import (
                SLOConfig,
                SLOMonitor,
                default_objectives,
            )

            slo_config = SLOConfig(
                fast_window_s=float(env.get("slo_fast_window_s", 300.0)),
                slow_window_s=float(env.get("slo_slow_window_s", 3600.0)),
                burn_threshold=float(env.get("slo_burn_threshold", 2.0)),
                read_p99_ms=float(env.get("slo_read_p99_ms", 5.0)),
                read_latency_budget=float(env.get("slo_read_budget", 0.01)),
                hit_rate_floor=float(env.get("slo_hit_rate_floor", 0.5)),
                shed_rate_ceiling=float(
                    env.get("slo_shed_rate_ceiling", 0.01)
                ),
            )
            self.slo = SLOMonitor(default_objectives(slo_config), slo_config)

        # Load-aware routing policy (kvcache/routing.py +
        # fleethealth/load.py). The load tracker exists whenever the
        # policy does — load_blend without signals degrades to the
        # identity, so wiring order can't flip routing.
        self.load_tracker = None
        self.routing_policy = None
        policy_name = env.get("routing_policy", "prefix_only")
        if policy_name != "prefix_only":
            from llm_d_kv_cache_manager_tpu_torch.fleethealth import PodLoadTracker
            from llm_d_kv_cache_manager_tpu_torch.kvcache.routing import (
                RoutingPolicy,
                RoutingPolicyConfig,
            )

            self.load_tracker = PodLoadTracker()
            self.routing_policy = RoutingPolicy(
                RoutingPolicyConfig(
                    policy=policy_name,
                    load_weight=float(env.get("routing_load_weight", 1.0)),
                    queue_depth_norm=float(
                        env.get("routing_queue_norm", 4.0)
                    ),
                    busy_norm_s=float(env.get("routing_busy_norm_s", 1.0)),
                    preemption_norm=float(
                        env.get("routing_preemption_norm", 8.0)
                    ),
                ),
                load_tracker=self.load_tracker,
            )

        if indexer is not None:  # injected (tests / embedding)
            self.indexer = indexer
        else:
            index_config = IndexConfig.default()
            # Native scoring core only applies to the in-memory backend;
            # a shared-backend INDEX_URL wins (redis_config takes priority
            # in the backend-selection order below).
            index_config.native = bool(env.get("native_scoring", False))
            if env.get("index_url"):
                from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.redis_index import (
                    RedisIndexConfig,
                )

                index_config = IndexConfig(
                    redis_config=RedisIndexConfig(url=env["index_url"])
                )
            indexer_config = IndexerConfig(
                token_processor_config=TokenProcessorConfig(
                    block_size=env["block_size"],
                    hash_seed=env["hash_seed"],
                    hash_algo=env.get("hash_algo", "fnv64_cbor"),
                    chain_memo=env.get("chain_memo", True),
                    chain_memo_config=ChainMemoConfig(
                        capacity=env.get("chain_memo_capacity", 131072),
                    ),
                ),
                kv_block_index_config=index_config,
                tokenizers_pool_config=TokenizersPoolConfig(
                    enable_local=True,
                    enable_uds=bool(env.get("uds_socket")),
                    uds_socket_path=env.get("uds_socket") or None,
                    enable_hf=env["enable_hf"],
                    hf_auth_token=env.get("hf_token"),
                ),
            )
            indexer_config.kv_block_index_config.enable_metrics = env["enable_metrics"]
            self.indexer = Indexer(
                config=indexer_config, chat_templating=self.templating
            )

        # Wire fleet health into the read path (degraded-mode scoring) and
        # the quarantine target. Injected indexers get the same treatment —
        # their scores must also stop following phantom placements.
        if self.indexer.fleet_health is None:
            self.indexer.fleet_health = self.fleet_health
        if self.fleet_health.index is None:
            self.fleet_health.bind_index(self.indexer.kv_block_index)
        # Routing policy rides AFTER fleet-health filtering in the read
        # path (kvcache/indexer.py): health decides what is trustworthy,
        # the policy decides what is affordable. Injected indexers get the
        # same treatment unless they brought their own.
        if self.routing_policy is not None and self.indexer.routing_policy is None:
            self.indexer.routing_policy = self.routing_policy

        # Replicated deployments wrap the event pool in an IndexerReplica:
        # the pool gains the partition-ownership gate, and the service
        # gains the snapshot/warm-restart surface plus the `replaying`
        # readiness state. A single-replica config keeps the monolithic
        # wiring byte-for-byte (IndexerReplica passes message_filter=None).
        pool_config = EventPoolConfig(
            zmq_endpoint=env["zmq_endpoint"],
            topic_filter=env["zmq_topic"],
            concurrency=env["pool_concurrency"],
        )
        self.replica = None
        if cluster_replica is not None:
            self.replica = cluster_replica
            self.event_pool = cluster_replica.event_pool
        elif (
            int(env.get("cluster_replicas", 1)) > 1
            or env.get("cluster_snapshot_path")
        ):
            from llm_d_kv_cache_manager_tpu_torch.cluster import (
                ClusterConfig,
                IndexerReplica,
            )

            self.replica = IndexerReplica(
                self.indexer,
                ClusterConfig(
                    num_replicas=int(env.get("cluster_replicas", 1)),
                    replica_id=int(env.get("cluster_replica_id", 0)),
                    snapshot_path=env.get("cluster_snapshot_path", ""),
                ),
                pool_config=pool_config,
                health_tracker=self.fleet_health,
            )
            self.event_pool = self.replica.event_pool
        else:
            self.event_pool = EventPool(
                pool_config,
                self.indexer.kv_block_index,
                self.indexer.token_processor,
                health_tracker=self.fleet_health,
            )
        # The kvevents write plane feeds the load tracker's preemption-
        # pressure signal: per-pod BlockRemoved volume is the wire-visible
        # trace of page-pool churn (observation only — digestion and
        # scores are untouched).
        if self.load_tracker is not None:
            self.event_pool.load_tracker = self.load_tracker

        # Index anti-entropy (antientropy/): ANTIENTROPY=1 attaches the
        # trust tracker at the indexer's score-filter seam and the event
        # pool's orphan-removal probe. The auditor / fetch-miss feedback
        # are embedder-wired (they need the pod digest surface and the
        # data-plane client) and surface through /readyz `index_health`.
        self.antientropy = None
        self.auditor = None
        self.fetch_feedback = None
        if env.get("antientropy"):
            from llm_d_kv_cache_manager_tpu_torch.antientropy import (
                AntiEntropyConfig,
                AntiEntropyTracker,
            )

            self.antientropy = AntiEntropyTracker(AntiEntropyConfig(
                accuracy_alpha=float(
                    env.get("antientropy_accuracy_alpha", 0.3)
                ),
                distrust_threshold=float(
                    env.get("antientropy_distrust_threshold", 0.9)
                ),
                min_factor=float(env.get("antientropy_min_factor", 0.25)),
            ))
            self.indexer.antientropy = self.antientropy
            self.event_pool.divergence = self.antientropy
        # Optional scatter-gather front (embedders wire a ClusterScorer
        # over peer replicas); surfaces through /cluster/status only.
        self.cluster_scorer = None

        # Predictive placement (placement/): PLACEMENT=1 attaches the
        # popularity tracker at every ingest seam this process owns. The
        # replicator itself needs a prefetch plane to the engine fleet —
        # embedders wire a HotPrefixReplicator over their RoutePrefetcher
        # and assign it to `self.replicator` to surface through
        # /placement/status.
        self.popularity = None
        self.replicator = None
        if env.get("placement"):
            from llm_d_kv_cache_manager_tpu_torch.placement import (
                ChainPopularityTracker,
                PopularityConfig,
            )

            self.popularity = ChainPopularityTracker(PopularityConfig(
                top_k=int(env.get("placement_top_k", 64)),
                half_life_s=float(env.get("placement_half_life_s", 120.0)),
            ))
            self.indexer.popularity = self.popularity
            self.event_pool.popularity = self.popularity
            index = self.indexer.kv_block_index
            if hasattr(index, "popularity"):  # InstrumentedIndex wrapper
                index.popularity = self.popularity
                index = index.inner
            if hasattr(index, "bind_popularity"):  # cost-aware backend
                index.bind_popularity(self.popularity)

        # Anticipatory prefetch (prediction/): PREDICTION=1 attaches the
        # session table at the read-path observation seam. The scheduler
        # and its prefetch plane are embedder-wired (like the placement
        # replicator) — assign to `prefetch_scheduler`/`route_prefetcher`
        # to surface them through /prediction/status and /readyz.
        self.session_table = None
        self.prefetch_scheduler = None
        self.route_prefetcher = None
        # Data-plane client for the /readyz `transfer` section. Embedders
        # that own a KVConnector assign its TransferClient here; otherwise
        # the section reports the process-wide default client if (and only
        # if) something in this process created one.
        self.transfer_client = None
        if env.get("prediction"):
            from llm_d_kv_cache_manager_tpu_torch.prediction import (
                PredictionConfig,
                SessionTable,
            )

            self.session_table = SessionTable(PredictionConfig(
                max_sessions=int(env.get("prediction_max_sessions", 1024)),
                eta_alpha=float(env.get("prediction_eta_alpha", 0.4)),
                max_chain_blocks=int(
                    env.get("prediction_max_chain_blocks", 256)
                ),
                default_eta_s=float(
                    env.get("prediction_default_eta_s", 8.0)
                ),
            ))
            self.indexer.prediction = self.session_table

        # Hierarchical federation (federation/): this process becomes one
        # region of a global fleet. The local region wraps THIS indexer;
        # peer regions are reached over the cluster gRPC transport.
        # Digests ship pull-style through GET/POST /federation/digest —
        # no background thread in the service; a sidecar (or the peer
        # itself) moves the bytes on whatever cadence it owns.
        self.federation = None
        if env.get("federation"):
            from llm_d_kv_cache_manager_tpu_torch.federation import (
                FederationConfig,
                GlobalRouter,
                Region,
                derive_fn_from_indexer,
            )
            from llm_d_kv_cache_manager_tpu_torch.placement import (
                ChainPopularityTracker,
                PopularityConfig,
            )

            if self.popularity is None:
                # Digests ship the popularity sketch; federation without
                # placement still needs the observation-only tracker.
                self.popularity = ChainPopularityTracker(PopularityConfig(
                    top_k=int(env.get("placement_top_k", 64)),
                    half_life_s=float(
                        env.get("placement_half_life_s", 120.0)
                    ),
                ))
                self.indexer.popularity = self.popularity
                self.event_pool.popularity = self.popularity
            fed_config = FederationConfig(
                region_id=env.get("federation_region_id", "region-0"),
                regions=list(env.get("federation_regions", [])),
                digest_interval_s=float(
                    env.get("federation_digest_interval_s", 5.0)
                ),
                digest_suspect_after_s=float(
                    env.get("federation_digest_suspect_s", 15.0)
                ),
                digest_stale_after_s=float(
                    env.get("federation_digest_stale_s", 45.0)
                ),
            )
            regions = {
                fed_config.region_id: Region(
                    fed_config.region_id,
                    self.indexer,
                    tracker=self.popularity,
                    pods_fn=lambda: list(
                        self.fleet_health.summary()["pods"]
                    ),
                )
            }
            peers = env.get("federation_peers", "")
            if peers:
                from llm_d_kv_cache_manager_tpu_torch.cluster.scorer import (
                    GrpcReplicaTransport,
                )

                for spec in peers.split(","):
                    if not spec.strip():
                        continue
                    region_id, _, target = spec.partition("=")
                    if not target:
                        raise ValueError(
                            f"FEDERATION_PEERS entry {spec!r} is not "
                            "region=host:port"
                        )
                    regions[region_id.strip()] = Region(
                        region_id.strip(),
                        GrpcReplicaTransport(target.strip()),
                    )
            self.federation = GlobalRouter(
                fed_config,
                regions,
                derive_fn=derive_fn_from_indexer(self.indexer),
            )

        # SLO autopilot (autopilot/): AUTOPILOT=1 wires the closed-loop
        # controller LAST, over whatever this construction attached. The
        # admission gate publishes its knob here; embedder-wired
        # subsystems (replicator, prefetch scheduler, auditor, transfer
        # client) publish theirs by calling
        # `x.register_knobs(service.autopilot_registry)` after assigning
        # them — knobs registered later are immediately reachable by the
        # rules. Signal sources that arrive late (route prefetcher,
        # transfer client) are resolved lazily per snapshot.
        self.autopilot = None
        self.autopilot_registry = None
        self.autopilot_signals = None
        if env.get("autopilot"):
            from llm_d_kv_cache_manager_tpu_torch.autopilot import (
                AutopilotConfig,
                AutopilotController,
                KnobRegistry,
                SignalAssembler,
            )

            self.autopilot_registry = KnobRegistry()
            if self.admission is not None:
                self.admission.register_knobs(self.autopilot_registry)
            assembler = SignalAssembler(
                slo_monitor=self.slo,
                load_tracker=self.load_tracker,
                transfer_client=_LazyStatusSource(
                    lambda: self.transfer_client
                    or _peek_transfer_client()
                ),
                antientropy=_LazyStatusSource(lambda: self.antientropy),
                prefetchers={
                    "route": _LazyStatusSource(
                        lambda: self.route_prefetcher
                    ),
                },
            )
            # Kept visible so the resourcegov block (wired below) can
            # attach itself as the memory_pressure source.
            self.autopilot_signals = assembler
            self.autopilot = AutopilotController(
                self.autopilot_registry,
                assembler,
                config=AutopilotConfig(
                    min_interval_s=float(
                        env.get("autopilot_min_interval_s", 1.0)
                    ),
                    warmup_s=float(env.get("autopilot_warmup_s", 10.0)),
                    cooldown_s=float(env.get("autopilot_cooldown_s", 5.0)),
                    decay_after_s=float(
                        env.get("autopilot_decay_after_s", 15.0)
                    ),
                ),
            )

        # Resource governance (resourcegov/): two planes with different
        # opt-ins. The departed-entity REAPER is always constructed —
        # per-pod rows must be able to die with their pod whether or not
        # a byte budget is configured (a leak fix, not a pressure
        # policy). Embedders that own a FleetMembership attach it with
        # `membership.reaper = service.reaper`; under RESOURCEGOV=1 the
        # fleet-health stale-quarantine path fans out through it too.
        # The GOVERNOR (accountant + pressure state machine + shed
        # ladder) attaches only under RESOURCEGOV=1, metering exactly
        # the structures this construction wired; its ticks ride the
        # /readyz and /resource/status poll cadence — no background
        # thread.
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import (
            base_pod_identifier,
        )
        from llm_d_kv_cache_manager_tpu_torch.resourcegov import DepartureReaper

        self.reaper = DepartureReaper()
        self.reaper.register("fleethealth", self.fleet_health.forget_pod)
        if self.load_tracker is not None:
            self.reaper.register("load", self.load_tracker.forget_pod)
        if self.antientropy is not None:
            self.reaper.register(
                "antientropy", self.antientropy.forget_pod
            )

        def _reap_transfer(pod_identifier: str) -> int:
            # Resolved per reap, like the autopilot's lazy sources: the
            # transfer client usually appears after construction. Peer
            # addressing uses the base pod identity as the host.
            client = self.transfer_client or _peek_transfer_client()
            if client is None:
                return 0
            return client.forget_host(base_pod_identifier(pod_identifier))

        self.reaper.register("transfer", _reap_transfer)

        self.resourcegov = None
        self.resource_accountant = None
        if env.get("resourcegov"):
            from llm_d_kv_cache_manager_tpu_torch.resourcegov import (
                STRUCT_ANTIENTROPY,
                STRUCT_CHAIN_MEMO,
                STRUCT_FLEETHEALTH,
                STRUCT_INDEX,
                STRUCT_LOAD,
                STRUCT_OBS,
                STRUCT_POPULARITY,
                STRUCT_PREFIX_STORE,
                STRUCT_SESSIONS,
                STRUCT_TRANSFER_PEERS,
                Meter,
                ResourceAccountant,
                ResourceGovConfig,
                ResourceGovernor,
            )

            accountant = ResourceAccountant()
            recorder = obs.get_recorder()
            accountant.register(Meter(
                STRUCT_OBS, recorder.entries,
                bytes_per_entry=2048.0, shed=recorder.shed,
            ))
            if self.session_table is not None:
                accountant.register(Meter(
                    STRUCT_SESSIONS, self.session_table.sessions,
                    bytes_per_entry=512.0, shed=self.session_table.shed,
                ))
            if self.popularity is not None:
                sketch = self.popularity.sketch
                accountant.register(Meter(
                    STRUCT_POPULARITY, self.popularity.entries,
                    bytes_per_entry=256.0,
                    fixed_bytes=float(sketch.width * sketch.depth * 8),
                    shed=self.popularity.shed,
                ))
            memo = self.indexer.token_processor.chain_memo
            if memo is not None:
                accountant.register(Meter(
                    STRUCT_CHAIN_MEMO, memo.entries,
                    bytes_per_entry=256.0, shed=memo.shed,
                ))
            store = getattr(self.indexer, "prefix_store", None)
            if store is not None and hasattr(store, "shed"):
                accountant.register(Meter(
                    STRUCT_PREFIX_STORE, store.entries,
                    bytes_per_entry=4096.0, shed=store.shed,
                ))
            index = self.indexer.kv_block_index
            inner = getattr(index, "inner", index)

            def _index_entries() -> int:
                sizes = getattr(inner, "segment_sizes", None)
                if callable(sizes):
                    return sum(sizes())
                data = getattr(inner, "_data", None)
                return len(data) if data is not None else 0

            accountant.register(Meter(
                STRUCT_INDEX, _index_entries,
                bytes_per_entry=1024.0,
                shed=getattr(inner, "shed", None),
            ))
            accountant.register(Meter(
                STRUCT_FLEETHEALTH, self.fleet_health.entries,
                bytes_per_entry=512.0,
            ))
            if self.load_tracker is not None:
                accountant.register(Meter(
                    STRUCT_LOAD, self.load_tracker.entries,
                    bytes_per_entry=256.0,
                ))
            if self.antientropy is not None:
                accountant.register(Meter(
                    STRUCT_ANTIENTROPY, self.antientropy.entries,
                    bytes_per_entry=256.0,
                ))

            def _transfer_entries() -> int:
                client = self.transfer_client or _peek_transfer_client()
                return client.entries() if client is not None else 0

            accountant.register(Meter(
                STRUCT_TRANSFER_PEERS, _transfer_entries,
                bytes_per_entry=4096.0,
            ))

            self.resource_accountant = accountant
            self.resourcegov = ResourceGovernor(
                accountant,
                ResourceGovConfig(
                    budget_mb=float(
                        env.get("resourcegov_budget_mb", 256.0)
                    ),
                    cooldown_s=float(
                        env.get("resourcegov_cooldown_s", 10.0)
                    ),
                    rss_probe=bool(
                        env.get("resourcegov_rss_probe", False)
                    ),
                ),
            )
            # Under governance, a stale quarantine reaps like an
            # explicit leave (same fan-out, same idempotent hooks).
            self.fleet_health.on_departed = self.reaper.reap
            if self.autopilot_registry is not None:
                self.resourcegov.register_knobs(self.autopilot_registry)
            if self.autopilot_signals is not None:
                self.autopilot_signals.resourcegov = self.resourcegov

    def start(self, with_subscriber: bool = True) -> None:
        self.indexer.run()
        self.event_pool.start(with_subscriber=with_subscriber)
        self._started = True

    def stop(self) -> None:
        self.event_pool.shutdown()
        self.indexer.shutdown()

    # -- admission plumbing --------------------------------------------------

    @staticmethod
    def _deadline_budget(request: web.Request):
        """Client-propagated deadline: the `X-Request-Deadline-Ms` header
        carries the caller's REMAINING budget in milliseconds (the HTTP
        sibling of the gRPC context deadline). Absent/garbled = no
        deadline."""
        raw = request.headers.get("X-Request-Deadline-Ms")
        if raw is None:
            return None
        try:
            return max(0.0, float(raw) / 1e3)
        except ValueError:
            return None

    @staticmethod
    def _shed_response(e: AdmissionRejected) -> web.Response:
        """429 + Retry-After: the explicit, bounded overload answer."""
        return web.json_response(
            {
                "error": str(e),
                "shed": e.kind,
                "retry_after_s": e.retry_after_s,
            },
            status=429,
            headers={"Retry-After": str(max(1, round(e.retry_after_s)))},
        )

    async def _admitted(self, request: web.Request, fn):
        """Run sync scoring work on a worker thread under the admission
        gate (when one is configured), with the client's deadline budget
        capping the queue wait. Raises `AdmissionRejected` on shed.

        Cross-process tracing seam: an `X-Kvtpu-Trace` header (or a W3C
        `traceparent` from an upstream gateway) makes the read path's
        root trace adopt the caller's trace id. Missing, truncated, or
        malformed values NEVER fail the request — they fall back to a
        fresh local trace, counted in
        kvcache_trace_carrier_errors_total."""
        carrier = request.headers.get(obs.HTTP_TRACE_HEADER)
        if carrier is None:
            carrier = request.headers.get("traceparent")

        def traced():
            if carrier is None:
                return fn()
            with obs.adopt(carrier):
                return fn()

        if self.admission is None:
            return await asyncio.to_thread(traced)
        budget = self._deadline_budget(request)
        admission = self.admission

        def gated():
            with admission.admit(budget):
                return traced()

        return await asyncio.to_thread(gated)

    # -- handlers ------------------------------------------------------------

    async def handle_score_completions(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
            prompt = body["prompt"]
            model = body["model"]
        except (json.JSONDecodeError, KeyError, TypeError) as e:
            return web.json_response(
                {"error": f"invalid request: {e}"}, status=400
            )
        pods = body.get("pods", [])
        lora_id = body.get("lora_id")
        try:
            scores = await self._admitted(
                request,
                lambda: self.indexer.get_pod_scores(
                    prompt, model, pods, lora_id=lora_id
                ),
            )
        except AdmissionRejected as e:
            return self._shed_response(e)
        except Exception as e:  # noqa: BLE001
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({"podScores": scores})

    async def handle_score_completions_batch(
        self, request: web.Request
    ) -> web.Response:
        """Bulk scoring: the whole batch runs through `score_many` — one
        amortized read-path pass, per-item results bit-identical to N
        sequential /score_completions calls. Per-item overload
        degradation applies (a shed item scores empty, the batch
        survives)."""
        from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import ScoreRequest

        try:
            body = await request.json()
            raw = body["requests"]
            if not isinstance(raw, list):
                raise TypeError("requests must be a list")
            score_requests = [
                ScoreRequest(
                    prompt=item["prompt"],
                    model_name=item["model"],
                    pod_identifiers=item.get("pods", []),
                    lora_id=item.get("lora_id"),
                )
                for item in raw
            ]
        except (json.JSONDecodeError, KeyError, TypeError) as e:
            return web.json_response(
                {"error": f"invalid request: {e}"}, status=400
            )
        max_batch = int(self.env.get("score_batch_max", 128))
        if len(score_requests) > max_batch:
            return web.json_response(
                {"error": f"batch of {len(score_requests)} exceeds "
                          f"SCORE_BATCH_MAX={max_batch}"},
                status=400,
            )
        try:
            results = await self._admitted(
                request, lambda: self.indexer.score_many(score_requests)
            )
        except AdmissionRejected as e:
            return self._shed_response(e)
        except Exception as e:  # noqa: BLE001
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response(
            {"results": [{"podScores": r.scores} for r in results]}
        )

    async def handle_score_chat_completions(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
            model = body["model"]
            render_request = RenderRequest.from_dict(body)
        except (json.JSONDecodeError, KeyError, TypeError) as e:
            return web.json_response({"error": f"invalid request: {e}"}, status=400)
        try:
            rendered = await asyncio.to_thread(self.templating.render, render_request)
            scores = await self._admitted(
                request,
                lambda: self.indexer.get_pod_scores(
                    rendered,
                    model,
                    body.get("pods", []),
                    lora_id=body.get("lora_id"),
                ),
            )
        except AdmissionRejected as e:
            return self._shed_response(e)
        except Exception as e:  # noqa: BLE001
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response(
            {"podScores": scores, "templated_messages": rendered}
        )

    async def handle_debug_traces(self, request: web.Request) -> web.Response:
        """Flight-recorder dump: recent complete traces + slow outliers.

        Query filters (AND-combined): `n`/`limit` caps the recent list,
        `plane=` keeps traces whose root lives in that plane, `min_ms=`
        keeps traces at least that slow, `trace_id=` (16 hex) fetches one
        distributed trace exactly, `crit=1` attaches each trace's
        critical-path breakdown. The ring is snapshotted under the lock
        once; filtering and JSON rendering happen outside it."""
        q = request.query
        n = None
        raw_n = q.get("limit", q.get("n"))
        if raw_n is not None:
            try:
                n = max(0, int(raw_n))
            except ValueError:
                return web.json_response(
                    {"error": "limit must be an integer"}, status=400
                )
        min_ms = None
        if "min_ms" in q:
            try:
                min_ms = float(q["min_ms"])
            except ValueError:
                return web.json_response(
                    {"error": "min_ms must be a number"}, status=400
                )
        plane = q.get("plane")
        if plane is not None and plane not in obs.PLANES:
            return web.json_response(
                {"error": f"plane must be one of {list(obs.PLANES)}"},
                status=400,
            )
        snapshot = await asyncio.to_thread(
            lambda: obs.get_recorder().snapshot(
                n=n, plane=plane, min_ms=min_ms,
                trace_id=q.get("trace_id"),
                include_critical=q.get("crit") == "1",
            )
        )
        return web.json_response(snapshot)

    async def handle_debug_critical_path(
        self, request: web.Request
    ) -> web.Response:
        """Critical-path window summary: per-(span, hop) self-time along
        the longest dependency chain, aggregated over the recorder's
        recent ring and grouped by root name — "which hop do I optimize
        next", as one document. `root=` filters to one root name."""
        root = request.query.get("root")

        def build():
            traces = obs.get_recorder().recent()
            if root is not None:
                traces = [t for t in traces if t.name == root]
            return {
                "traces": len(traces),
                "roots": obs.aggregate_critical_path(traces),
            }

        return web.json_response(await asyncio.to_thread(build))

    async def handle_slo_status(self, request: web.Request) -> web.Response:
        """SLO burn-rate evaluation over the live registry (obs/slo.py):
        per-objective fast/slow-window burn rates and breach status."""
        if self.slo is None:
            return web.json_response(
                {"error": "slo monitoring disabled (set SLO=1)"}, status=400
            )
        return web.json_response(await asyncio.to_thread(self.slo.evaluate))

    async def handle_score_explain(self, request: web.Request) -> web.Response:
        """Scores with the decision evidence attached. Same pipeline as
        /score_completions (bit-identical scores); GET query params or the
        same JSON body as the scoring endpoint."""
        if request.method == "POST":
            try:
                body = await request.json()
                prompt = body["prompt"]
                model = body["model"]
            except (json.JSONDecodeError, KeyError, TypeError) as e:
                return web.json_response(
                    {"error": f"invalid request: {e}"}, status=400
                )
            pods = body.get("pods", [])
            lora_id = body.get("lora_id")
        else:
            prompt = request.query.get("prompt")
            model = request.query.get("model")
            if prompt is None or model is None:
                return web.json_response(
                    {"error": "prompt and model query params are required"},
                    status=400,
                )
            pods = [
                p for p in request.query.get("pods", "").split(",") if p
            ]
            lora_id = request.query.get("lora_id")
            if lora_id is not None:
                try:
                    lora_id = int(lora_id)
                except ValueError:
                    return web.json_response(
                        {"error": "lora_id must be an integer"}, status=400
                    )
        try:
            explain = await asyncio.to_thread(
                self.indexer.explain_scores, prompt, model, pods,
                lora_id=lora_id,
            )
        except Exception as e:  # noqa: BLE001
            return web.json_response({"error": str(e)}, status=500)
        # Which engine produced these scores (C arena vs pure Python) and
        # the running fallback count — evidence for "why was this slow".
        explain["native_core"] = self._native_core_section()
        return web.json_response(explain)

    async def handle_metrics(self, request: web.Request) -> web.Response:
        from llm_d_kv_cache_manager_tpu_torch.metrics.registry import (
            CONTENT_TYPE_LATEST,
            REGISTRY,
            generate_latest,
        )

        return web.Response(
            body=generate_latest(REGISTRY), content_type=CONTENT_TYPE_LATEST
        )

    async def handle_health(self, request: web.Request) -> web.Response:
        # Liveness ONLY: the process is up and serving HTTP. Whether the
        # event plane works is a readiness question — see /readyz — so a
        # restart loop is never triggered by a peer's outage.
        return web.json_response({"status": "ok"})

    def readiness(self) -> dict:
        """Readiness snapshot: event-plane progress + per-pod health."""
        subscriber = self.event_pool._subscriber  # noqa: SLF001
        sub_info = None
        sub_ready = True  # pools started without a subscriber (embedded
        # mode / direct event sinks) are ready by construction
        if subscriber is not None:
            failures = subscriber.consecutive_failures
            sub_info = {
                "thread_alive": subscriber.is_alive(),
                "consecutive_failures": failures,
                "endpoint": self.env.get("zmq_endpoint"),
            }
            sub_ready = subscriber.is_alive() and failures == 0
        workers = self.event_pool.workers_alive()
        pool_info = {
            "workers_alive": workers,
            "queue_depths": self.event_pool.queue_depths(),
            "dropped_events": self.event_pool.dropped_events,
            "removals_lost": self.event_pool.removals_lost,
        }
        ready = bool(self._started and workers > 0 and sub_ready)
        status = "ready" if ready else "unready"
        replication = None
        if self.replica is not None:
            replication = self.replica.readiness()
            if ready and replication["state"] != "ready":
                # Replaying the seq tail after a snapshot load: the view is
                # partially stale, so routers must not scatter-gather here
                # yet — but this is warm-up, not failure, and gets its own
                # status string (still 503, like unready).
                status = replication["state"]
        memo = self.indexer.token_processor.chain_memo
        return {
            "status": status,
            "started": self._started,
            # Replicated-control-plane section: replica id/partition shape,
            # readiness state (ready | replaying), snapshot age, replay
            # bookkeeping. None on monolithic deployments.
            "replication": replication,
            "subscriber": sub_info,
            "event_pool": pool_info,
            "fleet": self.fleet_health.summary(),
            # Read-path derivation cache effectiveness (observability only —
            # never gates readiness: a cold memo is a correct memo).
            "chain_memo": memo.stats() if memo is not None else None,
            # Flight-recorder health (ring occupancy, dropped traces,
            # slowest recent stage): degraded observability is itself
            # observable, but never gates readiness.
            "obs": obs.get_recorder().stats(),
            # SLO burn-rate evaluation (obs/slo.py): breach status per
            # objective. NEVER gates readiness — a breaching service is
            # degrading, not down; taking it out of rotation would turn
            # an alert into an outage.
            "slo": self.slo.evaluate() if self.slo is not None else None,
            # Admission gate occupancy + shed counters: a service AT
            # capacity and shedding correctly is still ready (shedding is
            # the designed overload behavior, not a failure).
            "admission": (
                self.admission.status() if self.admission is not None
                else None
            ),
            # Federation section: per-region digest age + staleness state,
            # the stale set, and failover counters. Peer-region staleness
            # never gates THIS region's readiness — a region serving its
            # own traffic while the WAN is dark is degraded, not down.
            "federation": (
                self.federation.status() if self.federation is not None
                else None
            ),
            # Anticipatory-prefetch section: session-table occupancy +
            # misprediction counters, and — when a prefetch plane is
            # wired — the queue's depth and PER-SOURCE drop counters, so
            # a budget-bounded prediction drop is distinguishable from a
            # route-prefetch drop. Never gates readiness: a cold (or
            # absent) predictor is a correct predictor.
            "prediction": self._prediction_section(),
            # Data-plane health: per-peer breaker state + consecutive
            # failures + EWMA fetch latency, and the hedge/corrupt/
            # oversized counters (previously a single opaque failure
            # counter). Never gates readiness — an open breaker means a
            # PEER is dark; this process degrades those fetches to misses
            # and keeps serving.
            "transfer": self._transfer_section(),
            # Index anti-entropy: per-pod advertised-vs-verified accuracy
            # EWMA + demotion factor, last audit time, and the purge/
            # readmit counters. Never gates readiness — a divergent POD
            # is being demoted and repaired; this process is fine.
            "index_health": self._index_health_section(),
            # SLO autopilot: knob positions vs baseline, rule states, and
            # the recent actuation tail. The /readyz poll is also one of
            # the controller's tick cadences (rate-limited internally).
            # NEVER gates readiness — an actuating autopilot is relieving
            # a burn, not failing.
            "autopilot": self._autopilot_section(),
            # Native scoring core: whether the C arena backs the read
            # path, its occupancy (keys/bytes/epoch + digest counters),
            # and how many batches fell back to the pure-Python path.
            # Never gates readiness — the fallback path is bit-identical,
            # just slower.
            "native_core": self._native_core_section(),
            # Resource governor: accounted bytes per structure, pressure
            # level, shed ladder + actuation journal, reaper stats. The
            # /readyz poll is one of the governor's tick cadences (rate-
            # limited internally). NEVER gates readiness — even critical
            # pressure means the process is shedding re-derivable caches
            # to keep serving: degraded, but ready by construction.
            "resource": self._resource_section(),
        }

    def _native_core_section(self) -> dict:
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.native_index import (
            NativeScoringIndex,
            fallback_total,
            have_native_index,
        )

        inner = getattr(
            self.indexer.kv_block_index, "inner", self.indexer.kv_block_index
        )
        if isinstance(inner, NativeScoringIndex):
            section = inner.native_status()
        else:
            section = {
                "enabled": False,
                "module_available": have_native_index(),
            }
        section["fallbacks"] = fallback_total()
        return section

    def _autopilot_section(self) -> Optional[dict]:
        if self.autopilot is None:
            return None
        self.autopilot.tick()
        return self.autopilot.status()

    def _resource_section(self) -> Optional[dict]:
        if self.resourcegov is None:
            # No governor: still surface the reaper (it runs either way)
            # once it has fanned out at least one departure.
            if self.reaper.stats_counters["reaps"]:
                return {"reaper": self.reaper.status()}
            return None
        self.resourcegov.tick()
        section = self.resourcegov.status()
        section["reaper"] = self.reaper.status()
        return section

    def _index_health_section(self) -> Optional[dict]:
        if self.antientropy is None:
            return None
        section = self.antientropy.status()
        if self.auditor is not None:
            section["auditor"] = self.auditor.status()
        if self.fetch_feedback is not None:
            section["fetch_feedback"] = self.fetch_feedback.status()
        return section

    def _transfer_section(self) -> Optional[dict]:
        from llm_d_kv_cache_manager_tpu_torch.kv_connectors import (
            connector as conn_mod,
        )

        client = self.transfer_client or conn_mod.peek_default_client()
        if client is None:
            return None
        return client.status()

    def _prediction_section(self) -> Optional[dict]:
        if self.session_table is None and self.route_prefetcher is None:
            return None
        section: dict = {}
        if self.session_table is not None:
            stats = self.session_table.stats()
            metrics_collector.set_prediction_sessions(
                stats["tracked_sessions"]
            )
            section["table"] = stats
        if self.prefetch_scheduler is not None:
            section["scheduler"] = dict(self.prefetch_scheduler.stats)
        if self.route_prefetcher is not None:
            section["prefetcher"] = self.route_prefetcher.status()
        return section

    async def handle_readyz(self, request: web.Request) -> web.Response:
        payload = await asyncio.to_thread(self.readiness)
        status = 200 if payload["status"] == "ready" else 503
        return web.json_response(payload, status=status)

    async def handle_cluster_status(self, request: web.Request) -> web.Response:
        """Replication introspection: this replica's partition/readiness
        plus the scatter-gather front's per-replica health when one is
        wired. Same document the gRPC ClusterStatus method serves."""
        def build():
            return {
                "replica": (
                    self.replica.readiness() if self.replica is not None else None
                ),
                "scorer": (
                    self.cluster_scorer.status()
                    if self.cluster_scorer is not None
                    else None
                ),
            }

        return web.json_response(await asyncio.to_thread(build))

    async def handle_prediction_status(
        self, request: web.Request
    ) -> web.Response:
        """Anticipatory-prefetch introspection: the session table's
        occupancy/ETA evidence (soonest-expected sessions, tails as hex —
        data, never metric labels), misprediction counters, and the
        scheduler/prefetch-plane stats when an embedder wired them."""
        if self.session_table is None:
            return web.json_response(
                {"error": "prediction disabled (set PREDICTION=1)"},
                status=400,
            )

        def build():
            section = self._prediction_section() or {}
            section["soonest_sessions"] = self.session_table.snapshot()
            return section

        return web.json_response(await asyncio.to_thread(build))

    async def handle_antientropy_status(
        self, request: web.Request
    ) -> web.Response:
        """Anti-entropy introspection: the same document the /readyz
        `index_health` section embeds (per-pod trust evidence, auditor
        and fetch-feedback stats when an embedder wired them)."""
        if self.antientropy is None:
            return web.json_response(
                {"error": "anti-entropy disabled (set ANTIENTROPY=1)"},
                status=400,
            )
        return web.json_response(
            await asyncio.to_thread(self._index_health_section)
        )

    async def handle_autopilot_status(
        self, request: web.Request
    ) -> web.Response:
        """Autopilot introspection: one controller tick (rate-limited
        internally — fast polls are pure reads), then the status
        document the /readyz `autopilot` section embeds (knob positions
        vs baseline, rule firing evidence, recent actuation tail)."""
        if self.autopilot is None:
            return web.json_response(
                {"error": "autopilot disabled (set AUTOPILOT=1)"},
                status=400,
            )
        return web.json_response(
            await asyncio.to_thread(self._autopilot_section)
        )

    async def handle_resource_status(
        self, request: web.Request
    ) -> web.Response:
        """Resource-governor introspection: one governor tick (rate-
        limited internally), then the status document the /readyz
        `resource` section embeds (per-structure meters, pressure level,
        shed ladder, actuation journal, reaper stats). Critical pressure
        is a degraded-but-ready condition — this endpoint never serves
        503 on its own."""
        if self.resourcegov is None:
            return web.json_response(
                {
                    "error": "resource governor disabled "
                             "(set RESOURCEGOV=1)",
                    "reaper": self.reaper.status(),
                },
                status=400,
            )
        return web.json_response(
            await asyncio.to_thread(self._resource_section)
        )

    async def handle_placement_status(self, request: web.Request) -> web.Response:
        """Placement introspection: tracker occupancy/ingest counters, the
        currently-hot chains (heads as hex — data, never metric labels),
        and the replicator's policy stats when one is wired."""
        if self.popularity is None:
            return web.json_response(
                {"error": "placement disabled (set PLACEMENT=1)"},
                status=400,
            )

        def build():
            threshold = float(self.env.get("placement_hotness", 30.0))
            hot = self.popularity.hot_chains(threshold)
            metrics_collector.set_placement_hot_chains(len(hot))
            return {
                "tracker": self.popularity.stats(),
                "hotness_threshold": threshold,
                "hot_chains": [
                    {
                        "head": f"{c.head:016x}",
                        "score": round(c.score, 2),
                        "tenant_extra": list(c.extra),
                        "model": c.model_name,
                        "prefix_blocks": len(c.prefix_hashes),
                        "observations": c.observations,
                    }
                    for c in hot[:32]
                ],
                "replicator": (
                    self.replicator.status()
                    if self.replicator is not None else None
                ),
            }

        return web.json_response(await asyncio.to_thread(build))

    async def handle_pod_load(self, request: web.Request) -> web.Response:
        """POST: one pod-load report (the lightweight reporter seam —
        pods, or a sidecar scraping them, push their own queue depth /
        inflight / busy horizon here; the kvevents stream feeds the
        preemption-pressure signal independently). 400 when no load
        tracker is wired (ROUTING_POLICY=prefix_only needs no signals)."""
        if self.load_tracker is None:
            return web.json_response(
                {"error": "no load tracker (set ROUTING_POLICY=load_blend)"},
                status=400,
            )
        try:
            body = await request.json()
            pod = body["pod"]
            queue_depth = float(body.get("queue_depth", 0.0))
            inflight = float(body.get("inflight", 0.0))
            busy_s = body.get("busy_s")
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            return web.json_response(
                {"error": f"invalid request: {e}"}, status=400
            )
        busy_until = None
        if busy_s is not None:
            busy_until = self.load_tracker.clock() + max(0.0, float(busy_s))
        self.load_tracker.report(
            pod, queue_depth=queue_depth, inflight=inflight,
            busy_until=busy_until,
        )
        return web.json_response({"status": "ok"})

    async def handle_routing_status(self, request: web.Request) -> web.Response:
        """Saturation-resilience introspection: routing policy config +
        override stats + per-pod load snapshot, and the admission gate's
        depth/shed counters."""
        def build():
            return {
                "routing_policy": (
                    self.routing_policy.status()
                    if self.routing_policy is not None
                    else {"policy": "prefix_only"}
                ),
                "admission": (
                    self.admission.status()
                    if self.admission is not None else None
                ),
            }

        return web.json_response(await asyncio.to_thread(build))

    def _federation_disabled(self) -> Optional[web.Response]:
        if self.federation is None:
            return web.json_response(
                {"error": "federation disabled (set FEDERATION=1)"},
                status=400,
            )
        return None

    async def handle_federation_status(
        self, request: web.Request
    ) -> web.Response:
        """Federation introspection: per-region digest age/staleness,
        stale set, route/failover/digest counters (the same document the
        /readyz `federation` section embeds)."""
        err = self._federation_disabled()
        if err is not None:
            return err
        return web.json_response(
            await asyncio.to_thread(self.federation.status)
        )

    async def handle_federation_score(
        self, request: web.Request
    ) -> web.Response:
        """Two-level scoring entry: pick a region over the shipped
        digests, delegate precisely, return the pod scores WITH the
        region decision evidence. Body (POST) or query params (GET) are
        the /score_completions shape plus optional `home_region`."""
        err = self._federation_disabled()
        if err is not None:
            return err
        if request.method == "POST":
            try:
                body = await request.json()
                prompt = body["prompt"]
                model = body["model"]
            except (json.JSONDecodeError, KeyError, TypeError) as e:
                return web.json_response(
                    {"error": f"invalid request: {e}"}, status=400
                )
            pods = body.get("pods", [])
            lora_id = body.get("lora_id")
            home_region = body.get("home_region")
        else:
            prompt = request.query.get("prompt")
            model = request.query.get("model")
            if prompt is None or model is None:
                return web.json_response(
                    {"error": "prompt and model query params are required"},
                    status=400,
                )
            pods = [
                p for p in request.query.get("pods", "").split(",") if p
            ]
            lora_id = request.query.get("lora_id")
            if lora_id is not None:
                try:
                    lora_id = int(lora_id)
                except ValueError:
                    return web.json_response(
                        {"error": "lora_id must be an integer"}, status=400
                    )
            home_region = request.query.get("home_region")
        try:
            result = await self._admitted(
                request,
                lambda: self.federation.score_ex(
                    prompt, model, pods, lora_id=lora_id,
                    home_region=home_region,
                ),
            )
        except AdmissionRejected as e:
            return self._shed_response(e)
        except Exception as e:  # noqa: BLE001
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({
            "podScores": result.pod_scores.scores,
            "region": result.region,
            "detail": result.detail,
        })

    async def handle_federation_digest(
        self, request: web.Request
    ) -> web.Response:
        """The digest shipping seam. GET: build + return this region's
        encoded RegionDigest (peers pull on their own cadence). POST:
        ingest a peer's encoded digest from the request body."""
        err = self._federation_disabled()
        if err is not None:
            return err
        if request.method == "GET":
            try:
                data = await asyncio.to_thread(
                    self.federation.build_local_digest
                )
            except ValueError as e:
                return web.json_response({"error": str(e)}, status=400)
            return web.Response(
                body=data, content_type="application/octet-stream"
            )
        data = await request.read()
        from llm_d_kv_cache_manager_tpu_torch.federation import DigestFormatError

        try:
            digest = await asyncio.to_thread(
                self.federation.ingest_digest, data
            )
        except (DigestFormatError, ValueError) as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response({
            "status": "ok",
            "region": digest.region_id,
            "seq": digest.seq,
            "hot_chains": len(digest.hot_chains),
        })

    async def handle_cluster_snapshot(self, request: web.Request) -> web.Response:
        """POST: drain the event pool and write this replica's snapshot
        (view + seq watermarks) to the configured path."""
        if self.replica is None:
            return web.json_response(
                {"error": "not a replicated deployment (set CLUSTER_REPLICAS "
                          "/ CLUSTER_SNAPSHOT_PATH)"},
                status=400,
            )
        try:
            stats = await asyncio.to_thread(self.replica.take_snapshot)
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        except OSError as e:
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response(stats)

    def make_app(self) -> web.Application:
        app = web.Application()
        app.router.add_post("/score_completions", self.handle_score_completions)
        app.router.add_post(
            "/score_completions/batch", self.handle_score_completions_batch
        )
        app.router.add_post(
            "/score_chat_completions", self.handle_score_chat_completions
        )
        app.router.add_get("/metrics", self.handle_metrics)
        app.router.add_get("/health", self.handle_health)
        app.router.add_get("/readyz", self.handle_readyz)
        app.router.add_get("/cluster/status", self.handle_cluster_status)
        app.router.add_get("/routing/status", self.handle_routing_status)
        app.router.add_post("/pod_load", self.handle_pod_load)
        app.router.add_get("/placement/status", self.handle_placement_status)
        app.router.add_get(
            "/antientropy/status", self.handle_antientropy_status
        )
        app.router.add_get("/prediction/status", self.handle_prediction_status)
        app.router.add_get(
            "/federation/status", self.handle_federation_status
        )
        app.router.add_get("/federation/score", self.handle_federation_score)
        app.router.add_post(
            "/federation/score", self.handle_federation_score
        )
        app.router.add_get(
            "/federation/digest", self.handle_federation_digest
        )
        app.router.add_post(
            "/federation/digest", self.handle_federation_digest
        )
        app.router.add_post("/cluster/snapshot", self.handle_cluster_snapshot)
        app.router.add_get("/slo/status", self.handle_slo_status)
        app.router.add_get("/autopilot/status", self.handle_autopilot_status)
        app.router.add_get("/resource/status", self.handle_resource_status)
        app.router.add_get(
            "/debug/critical_path", self.handle_debug_critical_path
        )
        app.router.add_get("/debug/traces", self.handle_debug_traces)
        app.router.add_get("/debug/score_explain", self.handle_score_explain)
        app.router.add_post("/debug/score_explain", self.handle_score_explain)
        return app


def main() -> None:
    kvlog.setup()
    env = config_from_env()
    service = ScoringService(env)
    service.start()
    try:
        web.run_app(service.make_app(), port=env["http_port"])
    finally:
        service.stop()


if __name__ == "__main__":
    main()
