"""Span API: monotonic-clock stage timing with thread-local trace context.

Copy of the reference package's `obs/spans.py`. Design constraints:

- **Low overhead when enabled.** The warm read path is ~300µs end to end
  in the reference package's micro-bench), so the whole tracing tax across its
  ~7 spans must stay under ~15µs. A recorded span is a plain tuple
  `(name, depth, t0, t1)` appended to the trace's flat list (no Span
  objects, no tree links — nesting is reconstructed from the recorded
  depth), context-manager exits take explicit `(exc_type, exc, tb)`
  signatures so CPython never packs a varargs tuple, and per-stage
  Prometheus observation is *strided* (`ObsConfig.histogram_stride`): a
  `Histogram.observe` costs ~1-3µs, so observing every stage of every
  request would alone blow the budget; systematic 1-in-N sampling keeps
  the latency distribution unbiased while amortizing the cost to noise.
- **Constant-folded no-op when disabled.** `stage()`/`request()` check one
  module-global and return a shared singleton whose `__enter__`/`__exit__`
  do nothing — no allocation, no clock read, no thread-local access.
  Disabled-mode identity is pinned by tests/test_obs.py.
- **No background threads.** Completed root traces are handed synchronously
  to the flight recorder (a deque append under one lock); everything else
  is thread-local.

Cross-thread propagation: the read path hops threads at the tokenization
pool (submitter blocks on a Future while a worker runs the task). The
submitter captures `current_trace()` into the task; the worker wraps its
work in `bind(trace)` so stages land in the request's trace. This is safe
without a trace lock *for that handoff* because the submitter is blocked
until the worker resolves the Future — the trace is only ever touched by
one running thread at a time. Span append is a plain list append (atomic
under the GIL), so even concurrent append-only use cannot corrupt a
trace; ordering across threads is whatever the wall clock says.
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.metrics import collector as _metrics

_perf = time.perf_counter

# The bounded plane vocabulary: the first dotted component of every span
# name, and the only values the `plane` Prometheus label may take
# (tests/test_metrics_hygiene.py walks the registry against this tuple).
PLANES = (
    "read", "write", "transfer", "cluster", "federation", "prediction",
    "other",
)

# The committed span-name inventory: every (plane, stage) the code emits
# anywhere — instrumentation sites, record()/record_into() stamps, and the
# cross-process hop spans grafted by obs/carrier.py. A silent stage rename
# fails tests/test_metrics_hygiene.py's source scan against this set, and
# remote span payloads are sanitized against it before they can mint a
# Prometheus label (graft_remote).
SPAN_INVENTORY = frozenset({
    # read plane (kvcache/indexer.py, tokenization/pool.py)
    "read.get_pod_scores", "read.score_many",
    "read.tokenize", "read.tokenize_queue_wait", "read.render",
    "read.prefix_store", "read.encode", "read.derive",
    "read.lookup", "read.score",
    "read.batch.tokenize", "read.batch.derive", "read.batch.lookup",
    "read.batch.score", "read.batch.native",
    # write plane (kvevents/pool.py)
    "write.digest", "write.queue_wait", "write.decode", "write.index_apply",
    # transfer plane (engine/tiering.py, kv_connectors/)
    "transfer.stage", "transfer.stage_extract", "transfer.stage_drain",
    "transfer.stage_admit", "transfer.offload_dispatch",
    "transfer.offload_drain", "transfer.load_chain", "transfer.staged_fetch",
    "transfer.peer_fetch", "transfer.dcn_fetch", "transfer.onboard_wave",
    "transfer.prefetch_batch", "transfer.route_prefetch",
    # cluster plane (cluster/scorer.py, cluster/replica.py)
    "cluster.get_pod_scores", "cluster.score_many", "cluster.fanout",
    "cluster.merge", "cluster.rpc", "cluster.warm_restart",
    "cluster.snapshot_load", "cluster.replay",
    # federation plane (federation/router.py)
    "federation.score", "federation.region_pick", "federation.delegate",
    "federation.failover_retry", "federation.rpc",
    # prediction plane (prediction/scheduler.py)
    "prediction.tick", "prediction.score_hashes", "prediction.submit",
    # fallback name a grafted remote span is renamed to when its name is
    # not in this inventory (a peer cannot mint labels)
    "other.remote_span",
})

# Spans that mark a cross-process hop: the critical-path analyzer
# attributes every span nested under one of these to that hop instead of
# "local" (obs/recorder.py critical_path).
HOP_SPANS = frozenset({"cluster.rpc", "federation.rpc"})


@dataclass
class ObsConfig:
    """Tracing-spine knobs (env: KVTPU_TRACE, KVTPU_TRACE_RING,
    KVTPU_TRACE_SLOW_MS, KVTPU_TRACE_PROPAGATE — read by
    `configure_from_env`)."""

    enabled: bool = True
    # Flight-recorder ring: how many recent complete traces are kept.
    ring_capacity: int = 256
    # Traces at least this slow also enter the slow-outlier reservoir,
    # which ring churn never evicts (recorder.py).
    slow_threshold_s: float = 0.010
    # Slow-outlier reservoir size: the N slowest traces seen so far.
    reservoir_capacity: int = 64
    # Per-stage Prometheus histogram sampling: every Nth completed TRACE
    # contributes all its stages (observed in one batch at recorder
    # submit), and a stage running with no active trace observes on every
    # Nth completion. 1 = everything. The sampled latency distribution is
    # unbiased; _count_ semantics scale by the stride.
    histogram_stride: int = 8
    # Write-plane batches are orders of magnitude more frequent than read
    # requests (~23k batches/s vs ~3k reads/s): trace every
    # Nth batch so the recorder sees the write plane without taxing it.
    write_trace_stride: int = 16
    # Cross-process trace propagation (obs/carrier.py): inject a
    # TraceCarrier at every client seam we own and adopt one at every
    # server seam. Off, every process traces independently (no
    # carrier anywhere); scores are bit-identical either way.
    propagate: bool = True


# A recorded span: (name, depth, t0, t1) — perf_counter stamps.
SpanTuple = Tuple[str, int, float, float]


def span_as_dict(span: SpanTuple, origin: float) -> dict:
    name, depth, t0, t1 = span
    return {
        "name": name,
        "depth": depth,
        "start_us": round((t0 - origin) * 1e6, 1),
        "duration_us": round((t1 - t0) * 1e6, 1),
    }


class Trace:
    """One request's span collection. Created by `request()`, completed on
    context exit, then handed to the flight recorder."""

    __slots__ = (
        "name", "meta", "t0", "t1", "spans", "thread", "depth",
        "trace_id", "parent_id",
    )

    def __init__(self, name: str, meta: Optional[dict] = None):
        self.name = name
        self.meta = meta
        self.t0 = _perf()
        self.t1 = 0.0
        self.spans: List[SpanTuple] = []
        tname = _tls.name
        if tname is None:
            tname = _tls.name = threading.current_thread().name
        self.thread = tname
        # Distributed identity. A pending adoption (obs/carrier.py set it
        # from an extracted TraceCarrier) hands this root the CALLER's
        # trace id, so the caller's recorder can assemble one
        # cross-process tree; otherwise a fresh process-local id is
        # minted (xor of a per-process random salt and a counter — one
        # integer op, no urandom syscall on the hot path).
        adopt = _tls.adopt
        if adopt is None:
            self.trace_id = next(_id_counter) ^ _ID_SALT
            self.parent_id = 0
        else:
            self.trace_id = adopt.carrier.trace_id
            self.parent_id = adopt.carrier.span_id
            adopt.trace = self
            _tls.adopt = None  # one root per adoption
        # Current nesting depth of open stages. Lives on the trace, not
        # the thread-local: object attribute access is several times
        # cheaper than threading.local lookup, and every span exit needs
        # it. (bind() gives each borrowing thread its own view by saving/
        # restoring, and the submitter is blocked meanwhile.)
        self.depth = 0

    def add(self, name: str, depth: int, t0: float, t1: float) -> None:
        self.spans.append((name, depth, t0, t1))

    @property
    def duration_s(self) -> float:
        return (self.t1 or _perf()) - self.t0

    def stage_seconds(self) -> Dict[str, float]:
        """Total seconds per stage name (a stage may run multiple times)."""
        out: Dict[str, float] = {}
        for name, _, t0, t1 in self.spans:
            out[name] = out.get(name, 0.0) + (t1 - t0)
        return out

    def as_dict(self) -> dict:
        d = {
            "name": self.name,
            "trace_id": f"{self.trace_id:016x}",
            "duration_us": round(self.duration_s * 1e6, 1),
            "thread": self.thread,
            "spans": [span_as_dict(s, self.t0) for s in self.spans],
        }
        if self.parent_id:
            d["parent_id"] = f"{self.parent_id:016x}"
        if self.meta:
            d["meta"] = self.meta
        return d


# -- module state -------------------------------------------------------------

_config = ObsConfig(
    enabled=os.environ.get("KVTPU_TRACE", "1") == "1",
    ring_capacity=int(os.environ.get("KVTPU_TRACE_RING", "256")),
    slow_threshold_s=float(os.environ.get("KVTPU_TRACE_SLOW_MS", "10")) / 1e3,
    propagate=os.environ.get("KVTPU_TRACE_PROPAGATE", "1") == "1",
)

# Trace-id minting: 64-bit, unique within the process (counter) and
# collision-unlikely across a fleet (random salt drawn once at import).
_ID_SALT = random.getrandbits(64) | 1
_id_counter = itertools.count(1)


class _Tls(threading.local):
    trace: Optional[Trace] = None
    name: Optional[str] = None  # cached thread name (current_thread() is
    # a lock-free dict lookup but still ~3x an attribute read)
    # Pending carrier adoption (obs/carrier.py `adopt()` sets it; the next
    # root Trace created on this thread consumes it).
    adopt = None


_tls = _Tls()

# Per-stage completion counters for histogram striding, plus a cache of
# resolved Histogram children (labels() costs a tuple-keyed dict lookup per
# call — resolved once per stage name instead). Keyed by stage name — a
# fixed set defined by the instrumentation sites, so both dicts are
# bounded. Unlocked: a lost increment under races only perturbs *which*
# call gets sampled, never correctness.
_stage_counts: Dict[str, int] = {}
_stage_children: Dict[str, object] = {}

# Set lazily on first root-trace completion (avoids a circular import at
# module load; obs/__init__ imports spans before recorder exists).
_submit = None


def configure(config: ObsConfig) -> ObsConfig:
    """Install `config` process-wide; returns the previous config. The
    flight recorder re-reads ring/reservoir bounds lazily (recorder.py)."""
    global _config
    prev, _config = _config, config
    from llm_d_kv_cache_manager_tpu_torch.obs import recorder as _recorder

    _recorder.get_recorder().reconfigure(config)
    return prev


def configure_from_env() -> ObsConfig:
    """Re-read KVTPU_TRACE / KVTPU_TRACE_RING / KVTPU_TRACE_SLOW_MS (the
    service entrypoints call this after kvlog.setup())."""
    cfg = ObsConfig(
        enabled=os.environ.get("KVTPU_TRACE", "1") == "1",
        ring_capacity=int(os.environ.get("KVTPU_TRACE_RING", "256")),
        slow_threshold_s=float(os.environ.get("KVTPU_TRACE_SLOW_MS", "10"))
        / 1e3,
        propagate=os.environ.get("KVTPU_TRACE_PROPAGATE", "1") == "1",
    )
    configure(cfg)
    return cfg


def get_config() -> ObsConfig:
    return _config


def enabled() -> bool:
    return _config.enabled


def current_trace() -> Optional[Trace]:
    """The thread's active trace (None when tracing is disabled or no
    `request()` is open) — capture this to propagate across a thread hop."""
    return _tls.trace


# -- context managers ---------------------------------------------------------


class _Noop:
    """Shared do-nothing span/trace: what every API point returns when
    tracing is disabled. A singleton, so disabled-mode instrumentation
    allocates nothing (pinned by test_obs.py). `__enter__` yields None —
    never the singleton — so `with obs.request(...) as trace:` callers can
    hand the yield straight to `record_into`/meta updates and disabled
    mode stays a no-op instead of an AttributeError on a span-less
    object."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _Noop()


class _StageCtx:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name  # t0 is stamped by __enter__

    def __enter__(self):
        self.t0 = _perf()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _perf()
        name = self.name
        trace = _tls.trace
        if trace is not None:
            # In-trace spans skip inline histogram work entirely; the
            # recorder observes whole traces at a stride (observe_trace).
            trace.spans.append((name, trace.depth, self.t0, t1))
        else:
            _observe(name, t1 - self.t0)
        return False


class _NestedStageCtx(_StageCtx):
    """A stage that contains sub-stages: bumps the trace's depth so
    children record one level deeper."""

    __slots__ = ()

    def __enter__(self):
        trace = _tls.trace
        if trace is not None:
            trace.depth += 1
        self.t0 = _perf()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _perf()
        name = self.name
        trace = _tls.trace
        if trace is not None:
            trace.depth -= 1
            trace.spans.append((name, trace.depth, self.t0, t1))
        else:
            _observe(name, t1 - self.t0)
        return False


class _NestedRequestCtx(_NestedStageCtx):
    """A `request()` opened while a trace is already active: records as a
    nested stage of the outer trace, but yields the OUTER trace (not the
    stage context) so composing callers — a ClusterScorer inside a
    federation trace — can keep using the yield for `record_into` and
    meta updates exactly as they would with a root trace."""

    __slots__ = ()

    def __enter__(self):
        super().__enter__()
        return _tls.trace


class _RequestCtx:
    """Root context: opens a new Trace on this thread and submits it to the
    flight recorder on exit. If a trace is already active (a traced caller
    composing traced callees), `request()` degrades to a nested stage so
    the outer request owns the recorder entry."""

    __slots__ = ("trace",)

    def __init__(self, trace: Trace):
        self.trace = trace

    def __enter__(self):
        _tls.trace = self.trace
        return self.trace

    def __exit__(self, exc_type, exc, tb):
        global _submit
        trace = self.trace
        trace.t1 = _perf()
        _tls.trace = None
        if _submit is None:
            from llm_d_kv_cache_manager_tpu_torch.obs import recorder as _recorder

            _submit = _recorder.get_recorder().submit
        _submit(trace)
        return False


class _BindCtx:
    """Adopt an existing trace on this thread (cross-thread propagation)."""

    __slots__ = ("trace", "prev", "prev_depth")

    def __init__(self, trace: Optional[Trace]):
        self.trace = trace
        self.prev: Optional[Trace] = None
        self.prev_depth = 0

    def __enter__(self):
        self.prev = _tls.trace
        _tls.trace = self.trace
        trace = self.trace
        if trace is not None:
            self.prev_depth = trace.depth
            trace.depth = 1  # children of the submitting stage
        return trace

    def __exit__(self, exc_type, exc, tb):
        if self.trace is not None:
            self.trace.depth = self.prev_depth
        _tls.trace = self.prev
        return False


def request(name: str, meta: Optional[dict] = None):
    """Open a root trace for one request/batch. Returns a context manager
    yielding the Trace (or the no-op singleton when disabled). Nested
    `request()` calls become plain stages of the outer trace."""
    if not _config.enabled:
        return _NOOP
    if _tls.trace is not None:
        return _NestedRequestCtx(name)
    return _RequestCtx(Trace(name, meta))


def stage(name: str, nested: bool = False):
    """Time one stage of the current trace. Usable without an active trace
    too: the per-stage histogram still observes (strided), so standalone
    plane activity (a background prefetch, a drain) stays visible. `nested`
    marks stages that contain sub-stages (depth bookkeeping only)."""
    if not _config.enabled:
        return _NOOP
    return _NestedStageCtx(name) if nested else _StageCtx(name)


def bind(trace: Optional[Trace]):
    """Adopt `trace` (from `current_trace()` on another thread) for the
    duration of the context. None (or disabled tracing) is a no-op."""
    if not _config.enabled or trace is None:
        return _NOOP
    return _BindCtx(trace)


def record(name: str, t0: float, t1: float) -> None:
    """Record an already-measured interval (perf_counter stamps) — for
    durations that straddle threads, like queue waits measured from an
    enqueue stamp. Feeds the current trace (histograms observe at trace
    submit, strided) or the strided histogram directly when no trace is
    active."""
    if not _config.enabled:
        return
    trace = _tls.trace
    if trace is not None:
        trace.spans.append((name, trace.depth, t0, t1))
    else:
        _observe(name, t1 - t0)


def record_into(trace: Optional[Trace], name: str, t0: float, t1: float,
                depth: int = 1) -> None:
    """`record` against an explicitly-held trace — the zero-thread-local
    form for worker threads that already captured the submitter's trace
    (cheaper than `bind()` when the worker records a handful of flat
    spans)."""
    if trace is not None:
        trace.spans.append((name, depth, t0, t1))
    else:
        _observe(name, t1 - t0)


def annotate(key: str, value) -> None:
    """Attach one piece of evidence to the current trace's meta — the
    data channel for identities that must never become metric labels
    (peer host:port on a DCN fetch, replica ids on a scatter hop).
    Repeated keys accumulate into a small bounded list; no trace (or
    tracing disabled) is a no-op."""
    if not _config.enabled:
        return
    trace = _tls.trace
    if trace is None:
        return
    meta = trace.meta
    if meta is None:
        meta = trace.meta = {}
    cur = meta.get(key)
    if cur is None:
        meta[key] = value
    elif isinstance(cur, list):
        if value not in cur and len(cur) < 8:
            cur.append(value)
    elif cur != value:
        meta[key] = [cur, value]


def split_stage(name: str) -> Tuple[str, str]:
    """'read.tokenize' -> ('read', 'tokenize'); no dot -> ('other', name).
    The plane prefix is the bounded Prometheus label."""
    i = name.find(".")
    if i <= 0:
        return "other", name
    return name[:i], name[i + 1:]


def _observe(name: str, seconds: float) -> None:
    counts = _stage_counts
    n = counts.get(name, 0) + 1
    counts[name] = n
    if n % _config.histogram_stride:
        return
    _observe_direct(name, seconds)


def _observe_direct(name: str, seconds: float) -> None:
    hist = _metrics.stage_latency
    if hist is None:
        return
    child = _stage_children.get(name)
    if child is None:
        plane, stage_name = split_stage(name)
        child = _stage_children[name] = hist.labels(
            plane=plane, stage=stage_name
        )
    child.observe(seconds)


def observe_trace(trace: Trace) -> None:
    """Observe a whole trace's stages (root + spans) into the per-stage
    histograms. Called by the flight recorder for every
    `histogram_stride`-th submitted trace of each root name: one counter
    op per REQUEST instead of dict bookkeeping per span keeps the
    enabled-mode tax inside the <5% budget (obs_overhead leg)."""
    _observe_direct(trace.name, trace.duration_s)
    for name, _, t0, t1 in trace.spans:
        _observe_direct(name, t1 - t0)
