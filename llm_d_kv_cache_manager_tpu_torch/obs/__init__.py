"""obs: flight-recorder tracing spine for the three planes.

The reference control plane exposes only aggregate Prometheus counters plus
a periodic "metrics beat" log line (pkg/kvcache/metrics/collector.go) — when
GetPodScores is slow, nothing says *which stage* ate the time, and when a
pod scores 0, nothing says *why*. This package closes both gaps:

- **spans** (`spans.py`): a monotonic-clock, allocation-light span API with
  thread-local trace context. No background threads; when tracing is
  disabled every instrumentation point costs one module-state check and
  returns a shared no-op context manager.
- **flight recorder** (`recorder.py`): a bounded ring of recent complete
  traces plus an always-on reservoir of slow outliers, exposed as
  `GET /debug/traces` and surfaced as per-stage Histograms
  (`kvcache_stage_latency_seconds{plane,stage}`).
- **score explain** (`Indexer.explain_scores` + `GET /debug/score_explain`):
  re-runs the scoring pipeline capturing per-pod matched-prefix length,
  fleet-health adjustments, and the chain-memo entry family — with scores
  bit-identical to the plain `get_pod_scores` call.

Stage names are `plane.stage` ("read.tokenize", "write.decode",
"transfer.dcn_fetch"); the plane prefix becomes the bounded Prometheus
label, so cardinality is fixed by the instrumentation sites, never by
traffic.
"""

from llm_d_kv_cache_manager_tpu_torch.obs.spans import (  # noqa: F401
    HOP_SPANS,
    PLANES,
    SPAN_INVENTORY,
    ObsConfig,
    Trace,
    annotate,
    bind,
    configure,
    configure_from_env,
    current_trace,
    enabled,
    get_config,
    record,
    record_into,
    request,
    stage,
)
from llm_d_kv_cache_manager_tpu_torch.obs.recorder import (  # noqa: F401
    FlightRecorder,
    aggregate_critical_path,
    aggregate_stages,
    critical_path,
    get_recorder,
)
from llm_d_kv_cache_manager_tpu_torch.obs.carrier import (  # noqa: F401
    GRPC_CARRIER_KEY,
    HTTP_TRACE_HEADER,
    TraceCarrier,
    adopt,
    current_carrier,
    export_trace,
    graft_remote,
    make_carrier,
    parse_carrier,
)
