"""Flight recorder: bounded ring of recent traces + slow-outlier reservoir.

Copy of the reference package's `obs/recorder.py`.

The ring answers "what do requests look like right now" (`/debug/traces`);
the reservoir answers "what did the worst requests ever look like" — ring
churn under load would otherwise evict exactly the traces worth keeping.
The reservoir keeps the N slowest traces at or above
`ObsConfig.slow_threshold_s`, so a tail-latency incident leaves evidence
behind even after millions of fast requests have rolled the ring over.

Synchronous and thread-light: `submit` is a deque append (plus a heap push
for slow traces) under one lock — no background thread, no serialization
until someone actually asks for a snapshot.
"""

from __future__ import annotations

import heapq
import itertools
import statistics
import threading
from collections import deque
from typing import Dict, List, Optional

from llm_d_kv_cache_manager_tpu_torch.obs import spans as _spans


class FlightRecorder:
    def __init__(self, config: Optional[_spans.ObsConfig] = None):
        config = config or _spans.get_config()
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, config.ring_capacity))
        self._slow_threshold_s = config.slow_threshold_s
        self._reservoir_cap = max(1, config.reservoir_capacity)
        # Min-heap of (duration, seq, trace): the root is the FASTEST of
        # the retained slow outliers, so a new slower trace displaces it.
        self._slow: List[tuple] = []
        self._seq = itertools.count()
        self._completed = 0
        self._dropped = 0

    def reconfigure(self, config: _spans.ObsConfig) -> None:
        with self._mu:
            if self._ring.maxlen != max(1, config.ring_capacity):
                self._ring = deque(
                    self._ring, maxlen=max(1, config.ring_capacity)
                )
            self._slow_threshold_s = config.slow_threshold_s
            self._reservoir_cap = max(1, config.reservoir_capacity)
            while len(self._slow) > self._reservoir_cap:
                heapq.heappop(self._slow)

    def submit(self, trace: _spans.Trace) -> None:
        # Lock-free fast path: deque.append is GIL-atomic, and the
        # completed/dropped counters are introspection-only (a lost
        # increment under a submit race skews a /readyz stat by one, never
        # a trace). Only slow-outlier admission — rare by definition —
        # takes the lock, so the per-request submit cost stays flat.
        dur = trace.t1 - trace.t0
        ring = self._ring
        if len(ring) == ring.maxlen:
            self._dropped += 1  # ring overwrite: oldest trace lost
        ring.append(trace)
        n = self._completed = self._completed + 1
        if dur >= self._slow_threshold_s:
            with self._mu:
                item = (dur, next(self._seq), trace)
                if len(self._slow) < self._reservoir_cap:
                    heapq.heappush(self._slow, item)
                elif dur > self._slow[0][0]:
                    heapq.heapreplace(self._slow, item)
        # Strided per-stage histogram observation, one whole trace at a
        # time (Histogram.observe locks internally). Strides on the global
        # completion count: one counter for the whole recorder.
        if n % _spans.get_config().histogram_stride == 0:
            _spans.observe_trace(trace)

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()
            self._slow = []
            self._completed = 0
            self._dropped = 0

    def shed(self, fraction: float) -> int:
        """Resource-governor hook: drop the oldest `fraction` of the ring
        and the fastest `fraction` of the slow reservoir (heap roots —
        the least interesting outliers go first, the slowest evidence
        survives longest). Pure diagnostics loss: no score, route, or
        counter depends on a retained trace. Returns traces dropped."""
        fraction = min(max(fraction, 0.0), 1.0)
        dropped = 0
        with self._mu:
            n_ring = int(len(self._ring) * fraction)
            for _ in range(n_ring):
                self._ring.popleft()
            n_slow = int(len(self._slow) * fraction)
            for _ in range(n_slow):
                heapq.heappop(self._slow)
            dropped = n_ring + n_slow
        return dropped

    def entries(self) -> int:
        """Retained traces (ring + slow reservoir) — the resource
        accountant's O(1) meter read."""
        with self._mu:
            return len(self._ring) + len(self._slow)

    # -- introspection -----------------------------------------------------

    def recent(self, n: Optional[int] = None) -> List[_spans.Trace]:
        with self._mu:
            traces = list(self._ring)
        if n is None:
            return traces
        return traces[-n:] if n > 0 else []

    def slow(self) -> List[_spans.Trace]:
        """Slow-outlier reservoir, slowest first."""
        with self._mu:
            items = sorted(self._slow, reverse=True)
        return [t for _, _, t in items]

    @staticmethod
    def _stats_of(window, occupancy, capacity, completed, dropped,
                  slow_count, slow_threshold_s) -> dict:
        slowest_name, slowest_s = None, 0.0
        for trace in window:
            for name, _, t0, t1 in trace.spans:
                d = t1 - t0
                if d > slowest_s:
                    slowest_name, slowest_s = name, d
        return {
            "enabled": _spans.enabled(),
            "ring_occupancy": occupancy,
            "ring_capacity": capacity,
            "completed_traces": completed,
            "dropped_traces": dropped,
            "slow_traces_retained": slow_count,
            "slow_threshold_ms": round(slow_threshold_s * 1e3, 3),
            "slowest_stage_recent": (
                {"stage": slowest_name, "ms": round(slowest_s * 1e3, 3)}
                if slowest_name is not None
                else None
            ),
        }

    def stats(self) -> dict:
        """Health of the recorder itself (for /readyz: degraded
        observability must be observable)."""
        with self._mu:
            window = list(self._ring)
            args = (
                len(self._ring), self._ring.maxlen, self._completed,
                self._dropped, len(self._slow), self._slow_threshold_s,
            )
        return self._stats_of(window, *args)

    def _capture(self):
        """ONE lock crossing for everything a snapshot needs; all
        filtering/JSON rendering happens on the copies, outside the
        lock, so a large dump never stalls submits behind serialization."""
        with self._mu:
            return (
                list(self._ring),
                sorted(self._slow, reverse=True),
                (
                    len(self._ring), self._ring.maxlen, self._completed,
                    self._dropped, len(self._slow), self._slow_threshold_s,
                ),
            )

    def snapshot(
        self,
        n: Optional[int] = None,
        plane: Optional[str] = None,
        min_ms: Optional[float] = None,
        trace_id: Optional[str] = None,
        include_critical: bool = False,
    ) -> dict:
        """JSON-ready dump for GET /debug/traces.

        Filters (all optional, AND-combined): `plane` keeps traces whose
        root name lives in that plane, `min_ms` keeps traces at least
        that slow, `trace_id` (16-hex) fetches one distributed trace
        exactly — ring and reservoir both searched, so a cross-process
        id found on another process's /debug/traces can be chased here.
        `include_critical` attaches each rendered trace's critical-path
        breakdown. The ring is captured under the lock once; rendering
        happens outside it."""
        ring, slow_items, stat_args = self._capture()
        slow_traces = [t for _, _, t in slow_items]

        tid = None
        if trace_id is not None:
            try:
                tid = int(trace_id, 16)
            except (TypeError, ValueError):
                tid = -1  # matches nothing; the caller asked for an id

        def keep(trace) -> bool:
            if tid is not None and trace.trace_id != tid:
                return False
            if plane is not None and (
                _spans.split_stage(trace.name)[0] != plane
            ):
                return False
            if min_ms is not None and trace.duration_s * 1e3 < min_ms:
                return False
            return True

        recent = [t for t in ring if keep(t)]
        slow_kept = [t for t in slow_traces if keep(t)]
        if n is not None:
            recent = recent[-n:] if n > 0 else []

        def render(trace) -> dict:
            d = trace.as_dict()
            if include_critical:
                d["critical_path"] = critical_path(trace)
            return d

        return {
            "stats": self._stats_of(ring, *stat_args),
            "filters": {
                "plane": plane, "min_ms": min_ms, "trace_id": trace_id,
                "limit": n,
            },
            "recent": [render(t) for t in recent],
            "slow": [render(t) for t in slow_kept],
        }


def aggregate_stages(traces: List[_spans.Trace]) -> Dict[str, dict]:
    """Per-stage latency summary over complete traces — the bench-side
    reduction behind the committed stage-attribution sections. Returns
    {stage: {p50_us, p90_us, mean_us, calls, share_pct}}. Each trace also
    contributes a row under its own root name (the whole-request
    duration). share_pct is the stage's fraction of the summed trace
    *windows* — a window stretches to cover spans recorded before the
    root opened (a queue wait stamped at enqueue time), so a wait larger
    than the processing it preceded reads as a large share, not >100% of
    a window that never contained it. Nested stages still overlap their
    parents by design, so shares can sum past 100 across depths."""
    samples: Dict[str, List[float]] = {}
    total_s = 0.0
    for trace in traces:
        w0, w1 = trace.t0, trace.t1 or trace.t0
        root_dur = trace.duration_s
        samples.setdefault(trace.name, []).append(root_dur)
        for name, _, t0, t1 in trace.spans:
            samples.setdefault(name, []).append(t1 - t0)
            if t0 < w0:
                w0 = t0
            if t1 > w1:
                w1 = t1
        total_s += w1 - w0
    out: Dict[str, dict] = {}
    for name, vals in sorted(samples.items()):
        vals.sort()
        stage_total = sum(vals)
        out[name] = {
            "p50_us": round(vals[len(vals) // 2] * 1e6, 1),
            "p90_us": round(
                vals[min(int(len(vals) * 0.9), len(vals) - 1)] * 1e6, 1
            ),
            "mean_us": round(statistics.mean(vals) * 1e6, 1),
            "calls": len(vals),
            "share_pct": round(100.0 * stage_total / total_s, 1)
            if total_s > 0
            else 0.0,
        }
    return out


# -- critical-path attribution ------------------------------------------------

class _Node:
    __slots__ = ("name", "depth", "t0", "t1", "children")

    def __init__(self, name, depth, t0, t1):
        self.name = name
        self.depth = depth
        self.t0 = t0
        self.t1 = t1
        self.children: List["_Node"] = []


_EPS = 1e-9  # float-boundary slack: a child clamped to its parent's edge
# must still count as contained


def _contains(parent: _Node, node: _Node) -> bool:
    """Structural containment: strictly deeper recorded depth AND the
    interval inside the parent's — two parallel same-depth spans
    (scatter-gather rpc hops) that happen to overlap are siblings,
    never nested."""
    return (
        node.depth > parent.depth
        and node.t0 >= parent.t0 - _EPS
        and node.t1 <= parent.t1 + _EPS
    )


def _span_tree(trace: _spans.Trace) -> _Node:
    """Reconstruct the span tree from the flat (name, depth, t0, t1) list.

    Two mechanisms, because the list mixes two provenances:

    - **Graft blocks** (cross-process assembly, obs/carrier.py) are
      appended hop-first and CONTIGUOUSLY, and two parallel hops'
      windows usually overlap — interval containment alone would file
      replica A's spans under replica B's hop. So ownership is resolved
      by recording adjacency first: each span belongs to the nearest
      still-enclosing hop span recorded before it (a stack, popped as
      soon as a span falls outside), and hop nodes are atomic in every
      later containment pass.
    - **Live spans** within one ownership group nest by interval
      containment + recorded depth (children complete and record before
      their parents, so a sort puts parents first for the stack pass).

    Spans that straddle the root window — a queue wait stamped before
    the root opened — are clamped to it; the walk only ever attributes
    time inside the root's own wall."""
    root = _Node(trace.name, -1, trace.t0, trace.t1 or trace.t0)
    hop_names = _spans.HOP_SPANS
    groups = {id(root): []}
    hops: List[_Node] = []
    open_hops: List[_Node] = []
    for name, depth, t0, t1 in trace.spans:
        node = _Node(name, depth, max(t0, root.t0), min(max(t1, t0), root.t1))
        while open_hops and not _contains(open_hops[-1], node):
            open_hops.pop()
        owner = open_hops[-1] if open_hops else root
        groups[id(owner)].append(node)
        if name in hop_names:
            open_hops.append(node)
            hops.append(node)
            groups[id(node)] = []

    def build(container: _Node, members: List[_Node]) -> None:
        members.sort(key=lambda s: (s.t0, -(s.t1 - s.t0), s.depth))
        stack = [container]
        for node in members:
            while len(stack) > 1 and not _contains(stack[-1], node):
                stack.pop()
            stack[-1].children.append(node)
            if node.name not in hop_names:
                stack.append(node)  # hops are atomic: they own their group

    build(root, groups[id(root)])
    for hop in hops:
        build(hop, groups[id(hop)])
    return root


def _crit_walk(node: _Node, w0: float, w1: float, hop: str, acc: dict) -> None:
    """Attribute [w0, w1] exactly: walk backward from the window's end,
    descending into the child that finishes latest (the longest
    dependency chain — of two overlapping parallel children only the one
    on the critical path contributes), and credit every uncovered gap to
    `node` as self-time. Each recursion partitions its window, so the
    per-trace shares sum to 100% of root wall time by construction.

    `hop` is the nearest enclosing cross-process hop span ("local" when
    none): a remote `read.lookup` grafted under `cluster.rpc` aggregates
    separately from the router's own, which is the per-(plane, stage,
    hop) attribution the next perf PR reads."""
    child_hop = node.name if node.name in _spans.HOP_SPANS else hop
    self_s = 0.0
    cursor = w1
    for child in sorted(node.children, key=lambda c: c.t1, reverse=True):
        if cursor <= w0 + _EPS:
            break
        c1 = min(child.t1, cursor)
        c0 = max(child.t0, w0)
        if c1 <= c0 + _EPS:
            continue
        self_s += max(0.0, cursor - c1)
        _crit_walk(child, c0, c1, child_hop, acc)
        cursor = c0
    self_s += max(0.0, cursor - w0)
    key = (node.name, hop)
    acc[key] = acc.get(key, 0.0) + self_s


def critical_path(trace: _spans.Trace) -> dict:
    """One trace's critical-path breakdown: per-(span, hop) self-time
    along the longest dependency chain, shares of root wall time summing
    to ~100% (pinned in tests/test_obs.py)."""
    total_s = trace.duration_s
    acc: dict = {}
    _crit_walk(_span_tree(trace), trace.t0, trace.t1 or trace.t0,
               "local", acc)
    entries = [
        {
            "span": name,
            "hop": hop,
            "self_us": round(self_s * 1e6, 1),
            "share_pct": round(100.0 * self_s / total_s, 2)
            if total_s > 0 else 0.0,
        }
        for (name, hop), self_s in acc.items()
    ]
    entries.sort(key=lambda e: -e["self_us"])
    return {
        "root": trace.name,
        "total_us": round(total_s * 1e6, 1),
        "entries": entries,
        "share_sum_pct": round(sum(e["share_pct"] for e in entries), 1),
    }


def aggregate_critical_path(traces: List[_spans.Trace]) -> Dict[str, dict]:
    """Window summary behind GET /debug/critical_path and the
    `stage_attribution_distributed` micro-bench leg: traces grouped by
    root name, per-(span, hop) self-time summed across the group, shares
    against the group's summed root wall time. The top entry of a group
    answers "which hop do I optimize next" directly."""
    groups: Dict[str, List[_spans.Trace]] = {}
    for trace in traces:
        groups.setdefault(trace.name, []).append(trace)
    out: Dict[str, dict] = {}
    for root_name, group in sorted(groups.items()):
        acc: dict = {}
        total_s = 0.0
        for trace in group:
            total_s += trace.duration_s
            _crit_walk(
                _span_tree(trace), trace.t0, trace.t1 or trace.t0,
                "local", acc,
            )
        entries = [
            {
                "span": name,
                "hop": hop,
                "self_us": round(self_s * 1e6, 1),
                "share_pct": round(100.0 * self_s / total_s, 2)
                if total_s > 0 else 0.0,
            }
            for (name, hop), self_s in acc.items()
        ]
        entries.sort(key=lambda e: -e["self_us"])
        out[root_name] = {
            "traces": len(group),
            "total_ms": round(total_s * 1e3, 3),
            "entries": entries,
        }
    return out


_recorder: Optional[FlightRecorder] = None
_recorder_mu = threading.Lock()


def get_recorder() -> FlightRecorder:
    """Process-wide recorder (all planes share one ring)."""
    global _recorder
    with _recorder_mu:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder
