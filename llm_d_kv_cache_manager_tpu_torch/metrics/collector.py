"""Prometheus collectors + periodic metrics-beat logging.

Copy of the reference package's `metrics/collector.py`, registered in the
port's own registry (`metrics/registry.py`) instead of prometheus_client's:
every collector's name, help text, labels and buckets are the reference's.
Its parity target is the Go reference's pkg/kvcache/metrics/collector.go — eight
collectors under the `kvcache_index_*` / `kvcache_tokenization_*` namespaces,
a once-guarded Register(), and a periodic human-readable "metrics beat" log
line summarizing counters so operators can follow cache health without a
Prometheus stack.
"""

from __future__ import annotations

import threading
from typing import Optional

from llm_d_kv_cache_manager_tpu_torch.metrics.registry import REGISTRY, Counter, Gauge, Histogram

from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("metrics")

_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5,
)

# Collectors are created lazily in register_metrics() so importing this module
# never mutates the global registry (mirrors the reference's explicit
# Register() + sync.Once).
index_admissions: Optional[Counter] = None
index_evictions: Optional[Counter] = None
index_lookup_requests: Optional[Counter] = None
index_lookup_hits: Optional[Counter] = None
index_max_pod_hits: Optional[Histogram] = None
index_lookup_latency: Optional[Histogram] = None
tokenization_latency: Optional[Histogram] = None
tokenized_tokens: Optional[Counter] = None
render_latency: Optional[Histogram] = None
# Per-backend labels, mirroring the reference's CompositeTokenizer metrics
# (the Go reference's pkg/tokenization/tokenizer.go:503-549).
tokenization_backend_latency: Optional[Histogram] = None
tokenization_backend_fallbacks: Optional[Counter] = None
# Overload counters: the reference bounds ingest with rate-limited k8s
# workqueues (the Go reference's pkg/kvcache/kvevents/pool.go:103-144); here the
# queues are bounded and overload is made visible instead of rate-limited.
events_dropped: Optional[Counter] = None
tokenization_rejected: Optional[Counter] = None
# Fleet-health counters (fleethealth/tracker.py): pod lifecycle transitions,
# bulk purges of quarantined pods' index entries, and event-stream
# integrity anomalies (seq gaps / duplicates / reorders / ts regressions).
pod_state_transitions: Optional[Counter] = None
stale_entries_purged: Optional[Counter] = None
event_stream_anomalies: Optional[Counter] = None
# Redis backend connection lifecycle (kvblock/redis_index.py):
# down -> backoff -> up, made operator-visible instead of silently retried.
redis_state_transitions: Optional[Counter] = None
# Transfer plane (kv_connectors/): a DCN fetch that exhausted its bounded
# timeout/retry budget (the blocks degrade to cache misses), and blocks
# queued by the route-driven prefetcher (kv_connectors/prefetch.py).
transfer_failures: Optional[Counter] = None
route_prefetch_blocks: Optional[Counter] = None
# Chaos-hardened data plane (kv_connectors/connector.py): blocks whose
# end-to-end checksum failed on receipt (detected, discarded, NEVER
# landed), per-block error outcomes by fixed kind
# (connector.TRANSFER_ERROR_KINDS: transport/oversized/corrupt/
# breaker_open), hedged fetches launched to an alternate holder, and
# per-peer circuit-breaker transitions by the state entered
# (connector.BREAKER_STATES: closed/open/half_open).
transfer_corrupt_blocks: Optional[Counter] = None
transfer_block_errors: Optional[Counter] = None
transfer_hedges: Optional[Counter] = None
transfer_breaker_transitions: Optional[Counter] = None
# Tracing spine (obs/): per-stage latency across the three planes. Labels
# are the fixed `plane.stage` names from the instrumentation sites —
# bounded by code, never by traffic (tests/test_metrics_hygiene.py walks
# the registry to keep it that way). Observation is strided
# (ObsConfig.histogram_stride), so counts are sampled ×stride.
stage_latency: Optional[Histogram] = None
# Write-plane staleness: event publish (batch.ts) → index visible. The
# fleet-wide freshness signal the ROADMAP's multi-replica indexer needs —
# a replica whose apply delay grows is serving an increasingly stale
# placement view. Observed per batch (not strided).
event_apply_delay: Optional[Histogram] = None

# Replicated control plane (cluster/): partition shape, snapshot freshness,
# replay progress, and scatter-gather degradation. Gauges are per-process
# (one replica per process); the state-transition counter's label takes
# values from the fixed {ready, replaying} set in cluster/replica.py.
replica_partitions: Optional[Gauge] = None
replica_snapshot_age: Optional[Gauge] = None
replica_replay_lag: Optional[Gauge] = None
replica_state_transitions: Optional[Counter] = None
replica_scatter_errors: Optional[Counter] = None

# Predictive placement (placement/): hot-chain table occupancy, replication
# jobs/blocks pushed through the prefetch plane, bounded-queue drops, and
# targets skipped because fleet health doubted them. All unlabeled —
# chain heads and pod names are data, never labels.
placement_hot_chains: Optional[Gauge] = None
placement_replications: Optional[Counter] = None
placement_replicated_blocks: Optional[Counter] = None
placement_drops: Optional[Counter] = None
placement_skipped_unhealthy: Optional[Counter] = None

# Saturation resilience (admission + routing policy + membership):
# explicit sheds at the serving surface (kind ∈ {queue_full, deadline,
# timeout} — fixed in api/admission.py), requests that waited in the
# bounded admission queue, load-blend routing decisions that overrode the
# pure prefix argmax (kvcache/routing.py), and fleet-membership lifecycle
# transitions (phase ∈ the fixed state set in cluster/membership.py).
admission_shed: Optional[Counter] = None
admission_queued: Optional[Counter] = None
routing_policy_overrides: Optional[Counter] = None
membership_transitions: Optional[Counter] = None

# Native scoring core (kvcache/kvblock/native_index.py): batches that fell
# back from the fused C crossing to the pure-Python path (conversion error,
# tracker without factor hooks, digest feature the arena doesn't model).
native_fallbacks: Optional[Counter] = None

# Hierarchical federation (federation/): requests routed per region and
# the global tier's degradation/replication economics. The `region` label
# takes values from the FIXED configured region set (FederationConfig /
# FEDERATION_REGIONS) — deployment topology, never traffic; session ids,
# chain heads, and pod names stay data.
federation_routes: Optional[Counter] = None
federation_mispicks: Optional[Counter] = None
federation_failovers: Optional[Counter] = None
federation_transitions: Optional[Counter] = None
federation_digest_bytes: Optional[Counter] = None
federation_warmed_blocks: Optional[Counter] = None
federation_digest_age: Optional[Gauge] = None

# Fleet-scope distributed tracing (obs/carrier.py): carriers that arrived
# malformed/truncated at a cross-process seam. The request is NEVER
# failed — it falls back to a fresh local trace — so this counter is the
# only evidence a peer is speaking a broken carrier dialect.
trace_carrier_errors: Optional[Counter] = None
# SLO plane (obs/slo.py): multi-window error-budget burn rates. Both
# labels take values from FIXED code vocabularies (SLO_OBJECTIVES /
# SLO_WINDOWS) — objective topology, never traffic.
slo_burn_rate: Optional[Gauge] = None

# Anticipatory prefetch (prediction/): session-predictor occupancy, jobs
# landed ahead of their request, and the honest misprediction cost. The
# prefetch-drop counter's `source` label takes values from the FIXED
# submitter vocabulary (route | replication | prediction) — plane
# identity, never traffic.
prediction_sessions: Optional[Gauge] = None
prediction_jobs: Optional[Counter] = None
prediction_blocks: Optional[Counter] = None
prediction_mispredicted_blocks: Optional[Counter] = None
prefetch_drops: Optional[Counter] = None

# Index anti-entropy (antientropy/): divergence observations by fixed
# source (tracker.DIVERGENCE_SOURCES: fetch_miss / orphan_removal /
# audit_phantom), phantom entries purged and lost residents re-admitted
# by the repair loop, audit rounds applied, and primaries skipped by the
# peer resolver's negative-result cache. Pod identities stay data (the
# /readyz index_health section), never labels.
index_divergence_observations: Optional[Counter] = None
index_divergence_purged: Optional[Counter] = None
index_divergence_readmitted: Optional[Counter] = None
index_divergence_audits: Optional[Counter] = None
index_divergence_negative_skips: Optional[Counter] = None

# SLO autopilot (autopilot/): bounded knob nudges applied by the
# controller and the live position of every registered knob. All three
# labels take values from FIXED code vocabularies (AUTOPILOT_RULES /
# AUTOPILOT_DIRECTIONS in autopilot/controller.py, AUTOPILOT_KNOBS in
# autopilot/knobs.py) — rule/actuator topology, never traffic.
autopilot_actuations: Optional[Counter] = None
autopilot_knob_position: Optional[Gauge] = None

# Resource governor (resourcegov/): accounted bytes per structure,
# pressure-level transitions, and shed actuations. Both labels take
# values from FIXED code vocabularies (RESOURCE_STRUCTURES in
# resourcegov/accountant.py, RESOURCE_LEVELS in resourcegov/
# governor.py) — structure/level topology, never traffic.
resource_accounted_bytes: Optional[Gauge] = None
resource_pressure_transitions: Optional[Counter] = None
resource_shed_events: Optional[Counter] = None

_APPLY_DELAY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0, 60.0,
)

_registered = False
_register_lock = threading.Lock()
_beat_thread: Optional[threading.Thread] = None
_beat_stop: Optional[threading.Event] = None


def register_metrics(registry=None) -> None:
    """Create and register all collectors exactly once."""
    global _registered, index_admissions, index_evictions, index_lookup_requests
    global index_lookup_hits, index_max_pod_hits, index_lookup_latency
    global tokenization_latency, tokenized_tokens, render_latency
    global tokenization_backend_latency, tokenization_backend_fallbacks
    global events_dropped, tokenization_rejected
    global pod_state_transitions, stale_entries_purged
    global event_stream_anomalies, redis_state_transitions
    global transfer_failures, route_prefetch_blocks
    global transfer_corrupt_blocks, transfer_block_errors
    global transfer_hedges, transfer_breaker_transitions
    global stage_latency, event_apply_delay
    global replica_partitions, replica_snapshot_age, replica_replay_lag
    global replica_state_transitions, replica_scatter_errors
    global placement_hot_chains, placement_replications
    global placement_replicated_blocks, placement_drops
    global placement_skipped_unhealthy
    global admission_shed, admission_queued
    global routing_policy_overrides, membership_transitions
    global native_fallbacks
    global federation_routes, federation_mispicks, federation_failovers
    global federation_transitions, federation_digest_bytes
    global federation_warmed_blocks, federation_digest_age
    global prediction_sessions, prediction_jobs, prediction_blocks
    global prediction_mispredicted_blocks, prefetch_drops
    global trace_carrier_errors, slo_burn_rate
    global index_divergence_observations, index_divergence_purged
    global index_divergence_readmitted, index_divergence_audits
    global index_divergence_negative_skips
    global autopilot_actuations, autopilot_knob_position
    global resource_accounted_bytes, resource_pressure_transitions
    global resource_shed_events

    with _register_lock:
        if _registered:
            return
        reg = registry or REGISTRY
        index_admissions = Counter(
            "kvcache_index_admissions_total",
            "Number of KV-block keys admitted into the index",
            registry=reg,
        )
        index_evictions = Counter(
            "kvcache_index_evictions_total",
            "Number of KV-block evictions processed",
            registry=reg,
        )
        index_lookup_requests = Counter(
            "kvcache_index_lookup_requests_total",
            "Number of index lookup requests",
            registry=reg,
        )
        index_lookup_hits = Counter(
            "kvcache_index_lookup_hits_total",
            "Number of block keys that hit at least one pod",
            registry=reg,
        )
        index_max_pod_hits = Histogram(
            "kvcache_index_max_pod_hit_count",
            "Per-lookup maximum consecutive hit count across pods",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
            registry=reg,
        )
        index_lookup_latency = Histogram(
            "kvcache_index_lookup_latency_seconds",
            "Index lookup latency",
            buckets=_LATENCY_BUCKETS,
            registry=reg,
        )
        tokenization_latency = Histogram(
            "kvcache_tokenization_latency_seconds",
            "Full-tokenization latency per prompt",
            buckets=_LATENCY_BUCKETS,
            registry=reg,
        )
        tokenized_tokens = Counter(
            "kvcache_tokenization_tokens_total",
            "Number of tokens produced by full tokenization",
            registry=reg,
        )
        render_latency = Histogram(
            "kvcache_tokenization_render_latency_seconds",
            "Chat-template render latency",
            buckets=_LATENCY_BUCKETS,
            registry=reg,
        )
        tokenization_backend_latency = Histogram(
            "kvcache_tokenization_backend_latency_seconds",
            "Per-backend tokenizer latency",
            labelnames=("backend", "op"),
            buckets=_LATENCY_BUCKETS,
            registry=reg,
        )
        tokenization_backend_fallbacks = Counter(
            "kvcache_tokenization_backend_fallbacks_total",
            "Per-backend tokenizer failures that triggered fallback",
            labelnames=("backend", "op"),
            registry=reg,
        )
        events_dropped = Counter(
            "kvcache_events_dropped_total",
            "KV events dropped because an ingest shard queue was full",
            registry=reg,
        )
        tokenization_rejected = Counter(
            "kvcache_tokenization_rejected_total",
            "Tokenization tasks rejected because the pool queue was full",
            registry=reg,
        )
        pod_state_transitions = Counter(
            "kvcache_pod_state_transitions_total",
            "Pod health-state transitions, labeled by the state entered",
            labelnames=("state",),
            registry=reg,
        )
        stale_entries_purged = Counter(
            "kvcache_stale_index_entries_purged_total",
            "Index pod entries purged by stale-pod quarantine",
            registry=reg,
        )
        event_stream_anomalies = Counter(
            "kvcache_event_stream_anomalies_total",
            "Event-stream integrity anomalies detected by the liveness "
            "tracker",
            labelnames=("kind",),
            registry=reg,
        )
        redis_state_transitions = Counter(
            "kvcache_redis_state_transitions_total",
            "Redis/Valkey index connection state transitions",
            labelnames=("state",),
            registry=reg,
        )
        transfer_failures = Counter(
            "kvcache_transfer_failures_total",
            "KV-block transfers that exhausted their bounded timeout/retry "
            "budget (the blocks degraded to cache misses)",
            registry=reg,
        )
        route_prefetch_blocks = Counter(
            "kvcache_route_prefetch_blocks_total",
            "KV blocks queued for prefetch by the route-driven prefetcher",
            registry=reg,
        )
        transfer_corrupt_blocks = Counter(
            "kvcache_transfer_corrupt_blocks_total",
            "KV blocks whose end-to-end checksum failed on receipt — "
            "detected and discarded, never landed into HBM",
            registry=reg,
        )
        transfer_block_errors = Counter(
            "kvcache_transfer_block_errors_total",
            "Per-block transfer error outcomes, labeled by the fixed kind "
            "vocabulary (transport/oversized/corrupt/breaker_open)",
            labelnames=("kind",),
            registry=reg,
        )
        transfer_hedges = Counter(
            "kvcache_transfer_hedged_fetches_total",
            "Hedged fetches launched to an alternate holder (primary slow "
            "past its adaptive latency bound, or answered with holes)",
            registry=reg,
        )
        transfer_breaker_transitions = Counter(
            "kvcache_transfer_breaker_transitions_total",
            "Per-peer transfer circuit-breaker transitions, labeled by "
            "the state entered (closed/open/half_open)",
            labelnames=("state",),
            registry=reg,
        )
        stage_latency = Histogram(
            "kvcache_stage_latency_seconds",
            "Per-stage latency across the read/write/transfer planes "
            "(obs/ tracing spine; sampled every histogram_stride calls)",
            labelnames=("plane", "stage"),
            buckets=_LATENCY_BUCKETS,
            registry=reg,
        )
        event_apply_delay = Histogram(
            "kvcache_event_apply_delay_seconds",
            "KV-event publish (batch.ts) to index-visible latency — the "
            "fleet-wide index staleness signal",
            buckets=_APPLY_DELAY_BUCKETS,
            registry=reg,
        )
        replica_partitions = Gauge(
            "kvcache_replica_partition_count",
            "Number of replicas the event-stream partition map is striped "
            "over (cluster/partition.py)",
            registry=reg,
        )
        replica_snapshot_age = Gauge(
            "kvcache_replica_snapshot_age_seconds",
            "Age of this replica's last written index snapshot",
            registry=reg,
        )
        replica_replay_lag = Gauge(
            "kvcache_replica_replay_lag_events",
            "Event-tail messages still pending during a warm restart's "
            "seq-tail replay (0 when ready)",
            registry=reg,
        )
        replica_state_transitions = Counter(
            "kvcache_replica_state_transitions_total",
            "Replica readiness-state transitions, labeled by the state "
            "entered (ready/replaying)",
            labelnames=("state",),
            registry=reg,
        )
        replica_scatter_errors = Counter(
            "kvcache_replica_scatter_errors_total",
            "Scatter-gather fan-out calls that a replica failed or timed "
            "out (its partition degraded to no-cache-signal)",
            registry=reg,
        )
        placement_hot_chains = Gauge(
            "kvcache_placement_hot_chains",
            "Chains currently above the hotness threshold in the "
            "popularity tracker's top-K table (placement/popularity.py)",
            registry=reg,
        )
        placement_replications = Counter(
            "kvcache_placement_replications_total",
            "Replication jobs submitted to the prefetch plane by the "
            "hot-prefix replicator",
            registry=reg,
        )
        placement_replicated_blocks = Counter(
            "kvcache_placement_replicated_blocks_total",
            "Prefix blocks submitted for proactive replication",
            registry=reg,
        )
        placement_drops = Counter(
            "kvcache_placement_drops_total",
            "Replication jobs dropped because the bounded prefetch queue "
            "was full or closed",
            registry=reg,
        )
        placement_skipped_unhealthy = Counter(
            "kvcache_placement_skipped_unhealthy_total",
            "Replication targets skipped because fleet health reported "
            "them suspect or stale",
            registry=reg,
        )
        admission_shed = Counter(
            "kvcache_admission_shed_total",
            "Requests explicitly shed at the serving surface (429 / "
            "RESOURCE_EXHAUSTED), labeled by the bounded shed kind",
            labelnames=("kind",),
            registry=reg,
        )
        admission_queued = Counter(
            "kvcache_admission_queued_total",
            "Requests that waited in a bounded admission queue before "
            "being served (admitted-after-wait, not sheds)",
            registry=reg,
        )
        routing_policy_overrides = Counter(
            "kvcache_routing_policy_overrides_total",
            "Scoring calls where the load-blend routing policy changed "
            "the deterministic prefix argmax (kvcache/routing.py)",
            registry=reg,
        )
        native_fallbacks = Counter(
            "kvcache_native_fallbacks_total",
            "Batches the native scoring core handed back to the "
            "pure-Python path (kvcache/kvblock/native_index.py)",
            registry=reg,
        )
        membership_transitions = Counter(
            "kvcache_membership_transitions_total",
            "Fleet-membership lifecycle transitions, labeled by the phase "
            "entered (cluster/membership.py fixed state set)",
            labelnames=("phase",),
            registry=reg,
        )
        federation_routes = Counter(
            "kvcache_federation_routed_total",
            "Requests the global router delegated, labeled by the picked "
            "region (values from the fixed configured region set)",
            labelnames=("region",),
            registry=reg,
        )
        federation_mispicks = Counter(
            "kvcache_federation_mispicked_regions_total",
            "Requests routed to a non-home region while the home region "
            "was routable (affinity/load sent them elsewhere) — the "
            "honest-cost column of approximate region routing",
            registry=reg,
        )
        federation_failovers = Counter(
            "kvcache_federation_failovers_total",
            "Rendezvous failover-target selections for a stale home "
            "region",
            registry=reg,
        )
        federation_transitions = Counter(
            "kvcache_federation_region_transitions_total",
            "Region digest-staleness state transitions, labeled by the "
            "state entered (fleethealth healthy/suspect/stale vocabulary "
            "at region granularity)",
            labelnames=("state",),
            registry=reg,
        )
        federation_digest_bytes = Counter(
            "kvcache_federation_digest_bytes_total",
            "Encoded RegionDigest bytes produced for shipping (the "
            "federation tier's WAN cost)",
            registry=reg,
        )
        federation_warmed_blocks = Counter(
            "kvcache_federation_warmed_blocks_total",
            "KV blocks landed locally from a remote digest's hot chains "
            "through the warm_chain admission seam",
            registry=reg,
        )
        federation_digest_age = Gauge(
            "kvcache_federation_digest_age_seconds",
            "Age of the last ingested digest per region (the failover "
            "tier's staleness signal)",
            labelnames=("region",),
            registry=reg,
        )
        prediction_sessions = Gauge(
            "kvcache_prediction_tracked_sessions",
            "Sessions currently tracked by the anticipatory-prefetch "
            "session table (prediction/sessions.py; hard-bounded by "
            "max_sessions)",
            registry=reg,
        )
        prediction_jobs = Counter(
            "kvcache_prediction_jobs_total",
            "Anticipatory prefetch jobs submitted to the prefetch plane "
            "by the session predictor",
            registry=reg,
        )
        prediction_blocks = Counter(
            "kvcache_prediction_prefetch_blocks_total",
            "KV blocks submitted for anticipatory prefetch (pre-landed "
            "during the session's predicted idle window)",
            registry=reg,
        )
        prediction_mispredicted_blocks = Counter(
            "kvcache_prediction_mispredicted_blocks_total",
            "Anticipatorily prefetched blocks whose predicted turn never "
            "arrived, or that landed on a pod the router did not pick — "
            "the subsystem's honest cost column",
            registry=reg,
        )
        trace_carrier_errors = Counter(
            "kvcache_trace_carrier_errors_total",
            "Trace carriers that arrived missing fields, truncated, or "
            "malformed at a cross-process seam (the request fell back to "
            "a fresh local trace; it was never failed)",
            registry=reg,
        )
        slo_burn_rate = Gauge(
            "kvcache_slo_burn_rate",
            "Error-budget burn rate per SLO objective and evaluation "
            "window (obs/slo.py; 1.0 spends the budget exactly at the "
            "objective rate)",
            labelnames=("objective", "window"),
            registry=reg,
        )
        prefetch_drops = Counter(
            "kvcache_prefetch_drops_total",
            "Prefetch jobs dropped at the bounded queue, labeled by the "
            "submitting plane (fixed vocabulary: route | replication | "
            "prediction)",
            labelnames=("source",),
            registry=reg,
        )
        index_divergence_observations = Counter(
            "kvcache_index_divergence_observations_total",
            "Index-vs-reality divergence observations, labeled by the "
            "fixed evidence source (antientropy.DIVERGENCE_SOURCES: "
            "fetch_miss / orphan_removal / audit_phantom)",
            labelnames=("source",),
            registry=reg,
        )
        index_divergence_purged = Counter(
            "kvcache_index_divergence_purged_entries_total",
            "Phantom index entries purged by the anti-entropy repair "
            "loop (fetch-miss feedback + residency audits)",
            registry=reg,
        )
        index_divergence_readmitted = Counter(
            "kvcache_index_divergence_readmitted_blocks_total",
            "Resident-but-unadvertised blocks re-admitted into the index "
            "by residency audits",
            registry=reg,
        )
        index_divergence_audits = Counter(
            "kvcache_index_divergence_audits_total",
            "Per-pod residency audit verdicts applied by the anti-entropy "
            "auditor",
            registry=reg,
        )
        index_divergence_negative_skips = Counter(
            "kvcache_index_divergence_negative_skips_total",
            "Peer-resolver primary picks demoted by the negative-result "
            "cache (the peer just disclaimed that block)",
            registry=reg,
        )
        autopilot_actuations = Counter(
            "kvcache_autopilot_actuations_total",
            "Bounded knob nudges applied by the SLO autopilot, by rule "
            "and direction",
            labelnames=("rule", "direction"),
            registry=reg,
        )
        autopilot_knob_position = Gauge(
            "kvcache_autopilot_knob_position",
            "Live position of each autopilot-registered policy knob "
            "(equals its baseline whenever signals are healthy)",
            labelnames=("knob",),
            registry=reg,
        )
        resource_accounted_bytes = Gauge(
            "kvcache_resource_accounted_bytes",
            "Estimated bytes held by each registered stateful structure "
            "(the resource governor's accounting plane)",
            labelnames=("structure",),
            registry=reg,
        )
        resource_pressure_transitions = Counter(
            "kvcache_resource_pressure_transitions_total",
            "Memory-pressure level transitions, labeled by the level "
            "entered (ok / elevated / critical)",
            labelnames=("level",),
            registry=reg,
        )
        resource_shed_events = Counter(
            "kvcache_resource_shed_events_total",
            "Shed-ladder actuations applied by the resource governor, "
            "by structure",
            labelnames=("structure",),
            registry=reg,
        )
        _registered = True


# -- guarded observers (no-ops until register_metrics() has run) -------------

def observe_tokenization(seconds: float, n_tokens: int) -> None:
    """Record one full tokenization: latency + tokens produced."""
    if tokenization_latency is not None:
        tokenization_latency.observe(seconds)
    if tokenized_tokens is not None:
        tokenized_tokens.inc(n_tokens)


def observe_render(seconds: float) -> None:
    if render_latency is not None:
        render_latency.observe(seconds)


def observe_backend(backend: str, op: str, seconds: float) -> None:
    if tokenization_backend_latency is not None:
        tokenization_backend_latency.labels(backend=backend, op=op).observe(seconds)


def count_backend_fallback(backend: str, op: str) -> None:
    if tokenization_backend_fallbacks is not None:
        tokenization_backend_fallbacks.labels(backend=backend, op=op).inc()


def count_event_dropped(n: int = 1) -> None:
    if events_dropped is not None:
        events_dropped.inc(n)


def count_tokenization_rejected() -> None:
    if tokenization_rejected is not None:
        tokenization_rejected.inc()


def count_pod_transition(state: str) -> None:
    if pod_state_transitions is not None:
        pod_state_transitions.labels(state=state).inc()


def count_stale_purged(n: int) -> None:
    if stale_entries_purged is not None and n:
        stale_entries_purged.inc(n)


def count_stream_anomaly(kind: str) -> None:
    if event_stream_anomalies is not None:
        event_stream_anomalies.labels(kind=kind).inc()


def count_redis_transition(state: str) -> None:
    if redis_state_transitions is not None:
        redis_state_transitions.labels(state=state).inc()


def count_transfer_failure(n: int = 1) -> None:
    if transfer_failures is not None and n:
        transfer_failures.inc(n)


def count_route_prefetch(n: int) -> None:
    if route_prefetch_blocks is not None and n:
        route_prefetch_blocks.inc(n)


def count_transfer_corrupt(n: int = 1) -> None:
    if transfer_corrupt_blocks is not None and n:
        transfer_corrupt_blocks.inc(n)


def count_transfer_block_error(kind: str, n: int = 1) -> None:
    if transfer_block_errors is not None and n:
        transfer_block_errors.labels(kind=kind).inc(n)


def count_transfer_hedge() -> None:
    if transfer_hedges is not None:
        transfer_hedges.inc()


def count_breaker_transition(state: str) -> None:
    if transfer_breaker_transitions is not None:
        transfer_breaker_transitions.labels(state=state).inc()


def observe_stage(plane: str, stage: str, seconds: float) -> None:
    """Record one (possibly sampled — see obs.ObsConfig.histogram_stride)
    stage duration from the tracing spine."""
    if stage_latency is not None:
        stage_latency.labels(plane=plane, stage=stage).observe(seconds)


def observe_apply_delay(seconds: float) -> None:
    """Record one batch's event-publish → index-visible latency."""
    if event_apply_delay is not None:
        event_apply_delay.observe(seconds)


def set_replica_partitions(n: int) -> None:
    if replica_partitions is not None:
        replica_partitions.set(n)


def set_snapshot_age(seconds: float) -> None:
    if replica_snapshot_age is not None:
        replica_snapshot_age.set(seconds)


def set_replay_lag(n: int) -> None:
    if replica_replay_lag is not None:
        replica_replay_lag.set(n)


def count_replica_transition(state: str) -> None:
    if replica_state_transitions is not None:
        replica_state_transitions.labels(state=state).inc()


def count_scatter_error() -> None:
    if replica_scatter_errors is not None:
        replica_scatter_errors.inc()


def set_placement_hot_chains(n: int) -> None:
    if placement_hot_chains is not None:
        placement_hot_chains.set(n)


def count_placement_replication(blocks: int) -> None:
    if placement_replications is not None:
        placement_replications.inc()
        placement_replicated_blocks.inc(blocks)


def count_placement_drop() -> None:
    if placement_drops is not None:
        placement_drops.inc()


def count_placement_skip_unhealthy() -> None:
    if placement_skipped_unhealthy is not None:
        placement_skipped_unhealthy.inc()


def count_admission_shed(kind: str) -> None:
    if admission_shed is not None:
        admission_shed.labels(kind=kind).inc()


def count_admission_queued() -> None:
    if admission_queued is not None:
        admission_queued.inc()


def count_routing_override() -> None:
    if routing_policy_overrides is not None:
        routing_policy_overrides.inc()


def count_native_fallback() -> None:
    if native_fallbacks is not None:
        native_fallbacks.inc()


def count_membership_transition(phase: str) -> None:
    if membership_transitions is not None:
        membership_transitions.labels(phase=phase).inc()


def count_federation_route(region: str) -> None:
    if federation_routes is not None:
        federation_routes.labels(region=region).inc()


def count_federation_mispick() -> None:
    if federation_mispicks is not None:
        federation_mispicks.inc()


def count_federation_failover() -> None:
    if federation_failovers is not None:
        federation_failovers.inc()


def count_federation_transition(state: str) -> None:
    if federation_transitions is not None:
        federation_transitions.labels(state=state).inc()


def count_federation_digest_bytes(n: int) -> None:
    if federation_digest_bytes is not None and n:
        federation_digest_bytes.inc(n)


def count_federation_warmed(blocks: int) -> None:
    if federation_warmed_blocks is not None and blocks:
        federation_warmed_blocks.inc(blocks)


def set_federation_digest_age(region: str, age_s: float) -> None:
    if federation_digest_age is not None:
        federation_digest_age.labels(region=region).set(age_s)


def set_prediction_sessions(n: int) -> None:
    if prediction_sessions is not None:
        prediction_sessions.set(n)


def count_prediction_prefetch(blocks: int) -> None:
    if prediction_jobs is not None:
        prediction_jobs.inc()
    if prediction_blocks is not None and blocks:
        prediction_blocks.inc(blocks)


def count_prediction_mispredicted(blocks: int) -> None:
    if prediction_mispredicted_blocks is not None and blocks:
        prediction_mispredicted_blocks.inc(blocks)


def count_prefetch_drop(source: str) -> None:
    if prefetch_drops is not None:
        prefetch_drops.labels(source=source).inc()


def count_divergence(source: str, n: int = 1) -> None:
    if index_divergence_observations is not None and n:
        index_divergence_observations.labels(source=source).inc(n)


def count_divergence_purged(n: int) -> None:
    if index_divergence_purged is not None and n:
        index_divergence_purged.inc(n)


def count_divergence_readmitted(n: int) -> None:
    if index_divergence_readmitted is not None and n:
        index_divergence_readmitted.inc(n)


def count_divergence_audit() -> None:
    if index_divergence_audits is not None:
        index_divergence_audits.inc()


def count_negative_cache_skip() -> None:
    if index_divergence_negative_skips is not None:
        index_divergence_negative_skips.inc()


def count_trace_carrier_error() -> None:
    if trace_carrier_errors is not None:
        trace_carrier_errors.inc()


def set_slo_burn_rate(objective: str, window: str, burn: float) -> None:
    if slo_burn_rate is not None:
        slo_burn_rate.labels(objective=objective, window=window).set(burn)


def count_autopilot_actuation(rule: str, direction: str) -> None:
    if autopilot_actuations is not None:
        autopilot_actuations.labels(rule=rule, direction=direction).inc()


def set_autopilot_knob_position(knob: str, value: float) -> None:
    if autopilot_knob_position is not None:
        autopilot_knob_position.labels(knob=knob).set(value)


def set_resource_accounted_bytes(structure: str, n: float) -> None:
    if resource_accounted_bytes is not None:
        resource_accounted_bytes.labels(structure=structure).set(n)


def count_pressure_transition(level: str) -> None:
    if resource_pressure_transitions is not None:
        resource_pressure_transitions.labels(level=level).inc()


def count_shed_event(structure: str, n: int = 1) -> None:
    if resource_shed_events is not None and n:
        resource_shed_events.labels(structure=structure).inc(n)


def counter_value(c: Optional[Counter]) -> float:
    """Public collect()-based counter read (the beat line's data source).

    Replaces the old `c._value.get()` private-attribute peek, which silently
    read 0 for any labeled counter (labeled collectors keep their values on
    child objects, not the parent). Summing the exposition `_total` samples
    works identically for plain and labeled counters — a labeled counter
    reads as the sum across its label sets."""
    if c is None:
        return 0.0
    total = 0.0
    for metric in c.collect():
        for sample in metric.samples:
            if sample.name.endswith("_total"):
                total += sample.value
    return total


def start_metrics_logging(interval_s: float = 60.0) -> None:
    """Start the periodic metrics-beat logger thread (idempotent)."""
    global _beat_thread, _beat_stop
    with _register_lock:
        if _beat_thread is not None:
            return
        _beat_stop = threading.Event()
        _beat_thread = threading.Thread(
            target=_beat_loop, args=(interval_s, _beat_stop),
            name="metrics-beat", daemon=True,
        )
        _beat_thread.start()


def stop_metrics_logging(timeout_s: float = 5.0) -> None:
    """Stop the beat thread and wait for it to exit (idempotent). Tests and
    embedders can now start/stop the beat without leaking a daemon thread
    into every later test's thread count."""
    global _beat_thread, _beat_stop
    with _register_lock:
        thread, _beat_thread = _beat_thread, None
        stop, _beat_stop = _beat_stop, None
    if thread is None:
        return
    if stop is not None:
        stop.set()
    thread.join(timeout=timeout_s)


def _beat_loop(interval_s: float, stop: threading.Event) -> None:
    while not stop.wait(interval_s):
        logger.info(
            "metrics beat: admissions=%d evictions=%d lookups=%d hits=%d "
            "events_dropped=%d tok_rejected=%d anomalies=%d purged=%d "
            "transfer_failures=%d prefetch_blocks=%d",
            counter_value(index_admissions),
            counter_value(index_evictions),
            counter_value(index_lookup_requests),
            counter_value(index_lookup_hits),
            counter_value(events_dropped),
            counter_value(tokenization_rejected),
            counter_value(event_stream_anomalies),
            counter_value(stale_entries_purged),
            counter_value(transfer_failures),
            counter_value(route_prefetch_blocks),
        )
