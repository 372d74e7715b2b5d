"""Per-pod load signals for the saturation-resilient routing policy.

Copy of the reference package's `fleethealth/load.py`, the one module of
`fleethealth/` the routing policy reads. The prefix index answers "who has
my cache"; nothing in the read path answers "who can actually take my
request". Under saturation the router keeps maximizing prefix hit rate while
the winning pod's admission queue deepens and its page pool churns through
recompute-preemptions — a perfect-prefix pod that is 10 requests deep loses
to recompute on an idle pod, but pure prefix scoring cannot see it.

`PodLoadTracker` is the read side's load oracle. Signals, per pod:

- **queue_depth / inflight** — reported by a lightweight pod-load reporter
  (the serving sim reports its own bookkeeping; a real deployment scrapes
  the engine's admission queue or has pods POST it). Reports carry the
  reporter's notion of pending work; the tracker only stores and ages
  them.
- **busy_s** — how far into the future the pod's prefill slot is already
  committed (the router-side queue-wait estimate).
- **preemption rate** — exponentially-decayed count of
  recompute-preemptions, fed either by explicit `observe_preemption`
  calls or from the kvevents stream (the event pool credits BlockRemoved
  bursts via `observe_removed_blocks`; eviction volume is the wire-visible
  trace of page-pool churn).

Reports age out (`stale_report_after_s`): a pod that stopped reporting
contributes no load signal rather than an eternally-frozen one — absent
evidence must not repel traffic forever. Like the health tracker, state
evaluation is lazy and clock-driven: no threads, injectable clock, fully
deterministic under the simulated-clock benches.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import base_pod_identifier


@dataclass
class PodLoadConfig:
    # Half-life of the decayed preemption/eviction-pressure counters: with
    # the 30s default, "preemption_rate 4.0" reads as "~4 recent
    # preemptions' worth of churn", not a lifetime count.
    preemption_half_life_s: float = 30.0
    # Queue/inflight reports older than this contribute nothing (the
    # reporter died or the pod left; frozen load must not keep repelling
    # or attracting traffic).
    stale_report_after_s: float = 10.0
    # Removed-block volume is a noisy proxy for preemption churn: one
    # preemption reclaims a whole sequence's pages. This many removed
    # blocks count as one preemption-equivalent in the pressure signal.
    removed_blocks_per_preemption: float = 64.0


@dataclass
class PodLoad:
    """One pod's current load snapshot (already aged by the tracker)."""

    queue_depth: float = 0.0
    inflight: float = 0.0
    busy_s: float = 0.0
    preemption_rate: float = 0.0

    def as_dict(self) -> dict:
        return {
            "queue_depth": round(self.queue_depth, 3),
            "inflight": round(self.inflight, 3),
            "busy_s": round(self.busy_s, 4),
            "preemption_rate": round(self.preemption_rate, 3),
        }


class _LoadRecord:
    __slots__ = (
        "queue_depth", "inflight", "busy_at", "busy_reported_t",
        "reported_t", "preempt_value", "preempt_t",
    )

    def __init__(self):
        self.queue_depth = 0.0
        self.inflight = 0.0
        # busy_at is an absolute "free at" clock value; busy_s at read time
        # is max(0, busy_at - now), so the estimate drains by itself.
        self.busy_at = 0.0
        self.busy_reported_t: Optional[float] = None
        self.reported_t: Optional[float] = None
        self.preempt_value = 0.0
        self.preempt_t: Optional[float] = None


class PodLoadTracker:
    """Aged per-pod load signals keyed by BASE pod identity (DP-rank
    suffixes stripped — load is a per-pod property; every rank of a pod
    shares one admission queue in the deployments this models)."""

    def __init__(
        self,
        config: Optional[PodLoadConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or PodLoadConfig()
        if self.config.preemption_half_life_s <= 0:
            raise ValueError("preemption_half_life_s must be positive")
        self.clock = clock
        self._mu = threading.Lock()
        self._pods: Dict[str, _LoadRecord] = {}
        self._lambda = math.log(2.0) / self.config.preemption_half_life_s

    # -- reporter seam -----------------------------------------------------

    def report(
        self,
        pod_identifier: str,
        queue_depth: float = 0.0,
        inflight: float = 0.0,
        busy_until: Optional[float] = None,
        now: Optional[float] = None,
    ) -> None:
        """One pod-load report. `busy_until` is an absolute clock value
        ("this pod's prefill slot frees at t"); queue_depth/inflight are
        instantaneous gauges that age out after `stale_report_after_s`."""
        if now is None:
            now = self.clock()
        pod = base_pod_identifier(pod_identifier)
        with self._mu:
            rec = self._pods.get(pod)
            if rec is None:
                rec = self._pods[pod] = _LoadRecord()
            rec.queue_depth = float(queue_depth)
            rec.inflight = float(inflight)
            rec.reported_t = now
            if busy_until is not None:
                rec.busy_at = float(busy_until)
                rec.busy_reported_t = now

    def observe_preemption(
        self, pod_identifier: str, n: float = 1.0, now: Optional[float] = None
    ) -> None:
        """Credit `n` recompute-preemptions to the pod's decayed rate."""
        if n <= 0:
            return
        if now is None:
            now = self.clock()
        pod = base_pod_identifier(pod_identifier)
        with self._mu:
            rec = self._pods.get(pod)
            if rec is None:
                rec = self._pods[pod] = _LoadRecord()
            rec.preempt_value = self._decayed(rec, now) + float(n)
            rec.preempt_t = now

    def observe_removed_blocks(
        self, pod_identifier: str, n_blocks: int, now: Optional[float] = None
    ) -> None:
        """kvevents feed: BlockRemoved volume as preemption-equivalent
        pressure (the event pool calls this per digested removal event)."""
        per = max(self.config.removed_blocks_per_preemption, 1e-9)
        self.observe_preemption(pod_identifier, n_blocks / per, now=now)

    # -- read side ---------------------------------------------------------

    def _decayed(self, rec: _LoadRecord, now: float) -> float:
        if rec.preempt_t is None or rec.preempt_value <= 0.0:
            return 0.0
        dt = max(0.0, now - rec.preempt_t)
        return rec.preempt_value * math.exp(-self._lambda * dt)

    def load_of(
        self, pod_identifier: str, now: Optional[float] = None
    ) -> PodLoad:
        """Current aged snapshot; unknown pods read as idle (no evidence
        is no load — the policy must not punish a pod for silence)."""
        if now is None:
            now = self.clock()
        pod = base_pod_identifier(pod_identifier)
        with self._mu:
            rec = self._pods.get(pod)
            if rec is None:
                return PodLoad()
            out = PodLoad(preemption_rate=self._decayed(rec, now))
            fresh_for = self.config.stale_report_after_s
            if (
                rec.reported_t is not None
                and now - rec.reported_t < fresh_for
            ):
                out.queue_depth = rec.queue_depth
                out.inflight = rec.inflight
            if (
                rec.busy_reported_t is not None
                and now - rec.busy_reported_t < fresh_for
            ):
                out.busy_s = max(0.0, rec.busy_at - now)
            return out

    def forget_pod(self, pod_identifier: str) -> int:
        """Drop a departed pod's load record (the resourcegov reap hook;
        DP-rank-qualified identities fold onto their base key). A
        returning pod re-learns from its first report. Returns rows
        removed (0 or 1 — load is one record per base identity)."""
        pod = base_pod_identifier(pod_identifier)
        with self._mu:
            return 1 if self._pods.pop(pod, None) is not None else 0

    def entries(self) -> int:
        """Tracked per-pod load rows — the resource accountant's O(1)
        meter read."""
        with self._mu:
            return len(self._pods)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, dict]:
        """{pod: load dict} for /readyz-style introspection."""
        if now is None:
            now = self.clock()
        with self._mu:
            pods = sorted(self._pods)
        return {pod: self.load_of(pod, now=now).as_dict() for pod in pods}
