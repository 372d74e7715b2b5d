"""TraceCarrier: cross-process trace propagation for the tracing spine.

Copy of the reference package's `obs/carrier.py`; the wire form is
byte-compatible with it. The flight recorder sees one process; every hot
request is multi-process (cluster scatter-gather, federation delegation, DCN
transfer, prediction-driven prefetch). This module is the Dapper-style
answer, sized to this repo:

- **Carrier format.** A compact traceparent-style string,
  ``kvtpu1-<16-hex trace id>-<16-hex parent span id>-<2-hex flags>``
  (flags bit 0 = sampled). W3C ``traceparent`` values
  (``00-<32 hex>-<16 hex>-<2 hex>``) are also accepted on extract — the
  low 64 bits of the W3C trace id are taken — so an upstream gateway's
  header joins the same tree. Injection sites: gRPC metadata
  (``kvtpu-trace`` key) on both scoring surfaces, the HTTP
  ``X-Kvtpu-Trace`` header, the cluster scatter-gather fan-out, and
  federation delegation.
- **Extraction never fails a request.** A missing carrier starts a fresh
  local trace (as without propagation). A malformed one does the same AND
  counts into ``kvcache_trace_carrier_errors_total`` — propagation is
  evidence, never a dependency; scores are bit-identical with carriers
  present, absent, or garbage (pinned in tests/test_obs.py).
- **Span shipping.** A serving process runs its stages under the caller's
  trace id (`adopt`) and ships its completed root's span tuples back in
  the reply (`export_trace`, bounded). The caller grafts them into its
  own trace (`graft_remote`) under a hop span (``cluster.rpc`` /
  ``federation.rpc``), anchored inside the client-observed RPC window —
  remote monotonic clocks are not comparable across hosts, so the remote
  tree is centered in the client window it must fit, which bounds the
  skew error by the (client RTT − server busy time) slack. Remote span
  names are sanitized against the committed SPAN_INVENTORY before they
  touch the recorder, so a peer can never mint a Prometheus label.

The kvevents wire format is deliberately untouched: that plane is
vLLM-compatible and keeps joining traces through the publish→visible
apply-delay stamps (``kvcache_event_apply_delay_seconds``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from llm_d_kv_cache_manager_tpu_torch.metrics import collector as _metrics
from llm_d_kv_cache_manager_tpu_torch.obs import spans as _spans

# Version prefix of this repo's compact carrier format.
CARRIER_VERSION = "kvtpu1"
# gRPC metadata key carrying the serialized carrier (metadata keys must be
# lowercase) and its HTTP header sibling.
GRPC_CARRIER_KEY = "kvtpu-trace"
HTTP_TRACE_HEADER = "X-Kvtpu-Trace"
# Bound on how many span tuples one reply ships back (a replica's read
# path records ~10; the bound is a guard against a pathological trace).
MAX_SHIPPED_SPANS = 128

FLAG_SAMPLED = 0x01


@dataclass(frozen=True)
class TraceCarrier:
    """One hop's worth of trace context: whose tree, which parent, flags."""

    trace_id: int
    span_id: int
    flags: int = FLAG_SAMPLED

    def serialize(self) -> str:
        return (
            f"{CARRIER_VERSION}-{self.trace_id:016x}-"
            f"{self.span_id:016x}-{self.flags:02x}"
        )


def make_carrier(trace) -> Optional[str]:
    """Serialize a carrier for `trace` (the sender's root doubles as the
    parent span id — depths, not span ids, encode structure here)."""
    if trace is None:
        return None
    trace_id = getattr(trace, "trace_id", None)
    if trace_id is None:
        return None
    return TraceCarrier(trace_id, trace_id).serialize()


def current_carrier() -> Optional[str]:
    """The carrier to inject at a client seam: the current trace's
    identity, or None when there is no trace to continue (tracing or
    propagation disabled, or no request open)."""
    cfg = _spans.get_config()
    if not cfg.enabled or not cfg.propagate:
        return None
    return make_carrier(_spans.current_trace())


def parse_carrier(value) -> Optional[TraceCarrier]:
    """Parse a received carrier. None in (absent) parses to None silently;
    anything else that does not parse counts one
    ``kvcache_trace_carrier_errors_total`` and returns None — the caller
    falls back to a fresh local trace either way."""
    if value is None:
        return None
    try:
        if isinstance(value, (bytes, bytearray)):
            value = bytes(value).decode("ascii")
        parts = value.strip().split("-")
        if len(parts) != 4:
            raise ValueError("expected 4 dash-separated fields")
        version, trace_hex, span_hex, flags_hex = parts
        if version == CARRIER_VERSION:
            if len(trace_hex) != 16 or len(span_hex) != 16:
                raise ValueError("bad field width")
        elif version == "00" and len(trace_hex) == 32 and len(span_hex) == 16:
            trace_hex = trace_hex[16:]  # W3C traceparent: low 64 bits
        else:
            raise ValueError(f"unknown carrier version {version!r}")
        if len(flags_hex) != 2:
            raise ValueError("bad flags width")
        trace_id = int(trace_hex, 16)
        span_id = int(span_hex, 16)
        flags = int(flags_hex, 16)
        if trace_id == 0:
            raise ValueError("zero trace id")
    except (ValueError, UnicodeDecodeError, AttributeError, TypeError):
        _metrics.count_trace_carrier_error()
        return None
    return TraceCarrier(trace_id, span_id, flags)


class _AdoptCtx:
    """Pending-adoption scope: the next root trace opened inside inherits
    the carrier's trace id, and is exposed as `.trace` on exit so server
    seams can export it into the reply. A None/malformed carrier (or
    disabled tracing) adopts nothing — the scope is then a plain no-op
    and `.trace` stays None."""

    __slots__ = ("carrier", "trace")

    def __init__(self, carrier: Optional[TraceCarrier]):
        self.carrier = carrier
        self.trace = None

    def __enter__(self):
        if self.carrier is not None and _spans.get_config().enabled:
            _spans._tls.adopt = self  # noqa: SLF001 - module-internal seam
        return self

    def __exit__(self, exc_type, exc, tb):
        if _spans._tls.adopt is self:  # noqa: SLF001
            _spans._tls.adopt = None
        return False


def adopt(value) -> _AdoptCtx:
    """Serve under the caller's trace id. `value` is the raw carrier from
    the wire (header/metadata string, bytes, or None). Returns a context
    manager whose `.trace` holds the root Trace created inside (for
    `export_trace`), or None if none was."""
    cfg = _spans.get_config()
    if not cfg.enabled or not cfg.propagate:
        # Still burn a parse on malformed input so the error is counted
        # even when this process won't adopt.
        if value is not None:
            parse_carrier(value)
        return _AdoptCtx(None)
    return _AdoptCtx(parse_carrier(value))


def export_trace(trace, max_spans: int = MAX_SHIPPED_SPANS) -> Optional[dict]:
    """Serialize a completed (or completing) trace for the reply wire:
    trace id, root name, duration, and span tuples with microsecond
    offsets relative to the root's start — self-contained, no
    perf_counter stamps that only mean something on this host."""
    if trace is None:
        return None
    origin = trace.t0
    spans: List[list] = [
        [
            name,
            depth,
            round((t0 - origin) * 1e6, 1),
            round((t1 - t0) * 1e6, 1),
        ]
        for name, depth, t0, t1 in trace.spans[:max_spans]
    ]
    return {
        "trace_id": f"{trace.trace_id:016x}",
        "root": trace.name,
        "duration_us": round(trace.duration_s * 1e6, 1),
        "spans": spans,
        "clipped_spans": max(0, len(trace.spans) - max_spans),
    }


def graft_remote(
    trace,
    payload: Optional[dict],
    t0: float,
    t1: float,
    hop: str = "cluster.rpc",
    depth: int = 1,
    add_hop: bool = True,
) -> int:
    """Assemble a remote reply's spans into the local `trace`.

    Appends a `hop` span covering the client-observed RPC window
    [t0, t1], then the remote root and its spans anchored inside that
    window (centered: the slack between client RTT and remote busy time
    is split evenly between send and receive legs — monotonic clocks are
    incomparable across hosts, so this is the honest bound, and the
    critical-path walk only needs containment, which centering
    guarantees). Span names not in the committed SPAN_INVENTORY are
    renamed to ``other.remote_span`` so a peer's payload can never mint a
    Prometheus label. Returns the number of remote spans grafted (0 when
    there is nothing to graft — callers may use it for evidence
    counters). `add_hop=False` grafts into an ALREADY-recorded hop window
    (a bulk stream shipping several window traces over one RPC appends
    the hop span once)."""
    if trace is None or getattr(trace, "spans", None) is None:
        return 0
    spans = trace.spans
    if t1 < t0:
        t0, t1 = t1, t0
    if add_hop:
        spans.append((hop, depth, t0, t1))
    if not payload:
        return 0
    try:
        dur_s = max(0.0, float(payload.get("duration_us", 0.0))) / 1e6
        remote_spans = payload.get("spans") or ()
        root_name = payload.get("root")
    except (TypeError, AttributeError):
        _metrics.count_trace_carrier_error()
        return 0
    window = t1 - t0
    dur_s = min(dur_s, window)
    base = t0 + (window - dur_s) / 2.0
    inventory = _spans.SPAN_INVENTORY
    grafted = 0
    if isinstance(root_name, str):
        name = root_name if root_name in inventory else "other.remote_span"
        spans.append((name, depth + 1, base, base + dur_s))
        grafted += 1
    for item in remote_spans:
        try:
            name, d, start_us, dur_us = (
                item[0], int(item[1]), float(item[2]), float(item[3]),
            )
        except (TypeError, ValueError, IndexError):
            _metrics.count_trace_carrier_error()
            continue
        if not isinstance(name, str) or name not in inventory:
            name = "other.remote_span"
        s0 = base + start_us / 1e6
        s1 = s0 + max(dur_us, 0.0) / 1e6
        s0 = min(max(s0, t0), t1)
        s1 = min(max(s1, s0), t1)
        spans.append((name, depth + 2 + max(d, 0), s0, s1))
        grafted += 1
    return grafted
