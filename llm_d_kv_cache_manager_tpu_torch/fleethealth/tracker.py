"""Pod-lifecycle & staleness tracking for the KV-block control plane.

Copy of the reference package's `fleethealth/tracker.py`. The index is a *near-real-time* view of
the fleet's cache placement, kept fresh only by the engines' event
streams: a crashed pod, a stalled ZMQ stream, or dropped event batches
leave phantom placements that `GetPodScores` keeps routing traffic to.
Placement metadata is only worth following while it is trustworthy, and
the router must degrade to plain load-based decisions when it is not.

This tracker makes staleness a first-class state:

- **Liveness.** Every decoded `EventBatch` stamps its (DP-rank-qualified)
  pod identity with the tracker clock. A pod whose stream goes quiet
  transitions ``healthy → suspect → stale`` on configurable windows;
  events resuming at any point transition it straight back to healthy
  (a "recovery", counted).
- **Stream-integrity detection.** Per (pod, topic): the wire `seq` must
  advance by exactly 1 — a larger jump is a *gap* (dropped batches), a
  smaller/equal value is a *reorder*/*duplicate*; the batch `ts` must be
  non-decreasing within tolerance (*ts_regression*). Anomalies are counted
  per pod and fleet-wide (`anomaly_totals`) — they are evidence the index
  may have silently diverged even while the pod looks live.
- **Quarantine.** On the stale transition (and on explicit
  `quarantine()`), the pod's entries are purged from the shared index in
  one bulk `Index.remove_pod` pass — phantom blocks stop scoring the
  moment staleness is *detected*, instead of leaking until LRU churn.
  Detection latency (stale-detected minus last-event) is recorded per pod
  and is bounded by ``stale_after_s`` plus the caller's evaluation cadence.
- **Graceful degradation.** `filter_scores` is the read-path hook
  (`kvcache/indexer.py`): healthy pods pass through untouched (bit-identical
  scores on a healthy fleet), suspect pods are demoted by
  ``suspect_demotion_factor``, and stale pods are excluded entirely. A score
  map that empties out is the explicit "no cache signal" answer — the router
  falls back to its load/round-robin strategy rather than chasing phantom
  placements.

State evaluation is *lazy and clock-driven*: there is no background
thread. `refresh()` runs on every `filter_scores` call (O(pods)) and can
be called explicitly; the clock is injectable, so every transition is
deterministic under test and under fault injection (`faults.py`).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import (
    base_pod_identifier,
)
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("fleethealth.tracker")

HEALTHY = "healthy"
SUSPECT = "suspect"
STALE = "stale"


@dataclass
class FleetHealthConfig:
    # Quiet-stream windows: a pod with no decoded events for
    # `suspect_after_s` is demoted; for `stale_after_s` it is excluded and
    # its index entries purged. Production defaults are deliberately
    # generous — event silence also happens on genuinely idle pods, and a
    # false quarantine costs cache hits (never correctness: entries
    # repopulate from the live stream on the next store).
    suspect_after_s: float = 30.0
    stale_after_s: float = 120.0
    # Multiplier applied to a suspect pod's score (1.0 = no demotion).
    suspect_demotion_factor: float = 0.5
    # Purge a pod's index entries automatically on the stale transition.
    auto_quarantine: bool = True
    # Batch `ts` may regress by up to this much (clock skew between a
    # pod's DP ranks publishing on one topic) before counting an anomaly.
    ts_regression_tolerance_s: float = 1.0


class _PodRecord:
    __slots__ = (
        "last_event_t", "state", "state_since", "last_seq", "last_ts",
        "seq_gaps", "gap_events", "duplicates", "reorders",
        "ts_regressions", "decode_failures", "recoveries",
        "stale_detected_at", "detection_latency_s", "purged_entries",
    )

    def __init__(self, now: float):
        self.last_event_t = now
        self.state = HEALTHY
        self.state_since = now
        self.last_seq: Dict[str, int] = {}
        self.last_ts: Optional[float] = None
        self.seq_gaps = 0
        self.gap_events = 0  # estimated batches lost inside the gaps
        self.duplicates = 0
        self.reorders = 0
        self.ts_regressions = 0
        self.decode_failures = 0
        self.recoveries = 0
        self.stale_detected_at: Optional[float] = None
        self.detection_latency_s: Optional[float] = None
        self.purged_entries = 0

    def as_dict(self) -> dict:
        return {
            "state": self.state,
            "last_event_age_s": None,  # filled by summary() with the clock
            "seq_gaps": self.seq_gaps,
            "gap_events": self.gap_events,
            "duplicates": self.duplicates,
            "reorders": self.reorders,
            "ts_regressions": self.ts_regressions,
            "decode_failures": self.decode_failures,
            "recoveries": self.recoveries,
            "detection_latency_s": self.detection_latency_s,
            "purged_entries": self.purged_entries,
        }


class FleetHealthTracker:
    """Per-(pod, dp_rank) liveness + stream integrity + degraded scoring.

    Pods are keyed by the same DP-rank-qualified identity the event pool
    writes into the index ("pod@dpR" for DP>1 engines, the bare pod name
    otherwise), so health state and score keys always line up.
    """

    def __init__(
        self,
        config: Optional[FleetHealthConfig] = None,
        index=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or FleetHealthConfig()
        if self.config.stale_after_s < self.config.suspect_after_s:
            raise ValueError(
                "stale_after_s must be >= suspect_after_s "
                f"({self.config.stale_after_s} < {self.config.suspect_after_s})"
            )
        self.index = index
        self.clock = clock
        self._mu = threading.Lock()
        self._pods: Dict[str, _PodRecord] = {}
        # Subscriber stream state (surfaced by /readyz).
        self._subscriber_failures = 0
        self._subscriber_connected: Optional[bool] = None
        # Data-plane peer breaker states (kv_connectors TransferClient
        # transitions), keyed by peer "host:port". A peer whose transfer
        # breaker is open is a different signal from a stale event stream
        # — the pod may still be scoring fresh placements while its
        # transfer NIC is dark — so it is reported alongside, not merged
        # into, the pod liveness state machine.
        self._transfer_peers: Dict[str, dict] = {}
        # Departure seam: fired (outside the lock) after a stale
        # quarantine finishes purging, with the pod identity — the
        # resourcegov DepartureReaper attaches here so a pod that is gone
        # in practice is reaped like one that left on purpose.
        self.on_departed: Optional[Callable[[str], None]] = None

    def bind_index(self, index) -> None:
        """Late-bind the index quarantine target (Indexer wiring order)."""
        self.index = index

    # -- write-plane observations -----------------------------------------

    def observe_batch(
        self, pod_identifier: str, topic: str, seq: Optional[int], ts: float
    ) -> None:
        """Stamp liveness + check stream integrity for one decoded batch.

        Called by the event-pool worker after decode, with the DP-rank-
        qualified pod identity. `seq` is the wire frame's per-publisher
        monotonic sequence (None when the transport carries none).
        """
        now = self.clock()
        with self._mu:
            rec = self._pods.get(pod_identifier)
            if rec is None:
                rec = _PodRecord(now)
                self._pods[pod_identifier] = rec
            rec.last_event_t = now
            if rec.state != HEALTHY:
                # Events resumed: the stream is discontinuous by
                # definition (restart/stall), so reset seq tracking
                # instead of flagging the fresh stream as one giant gap.
                self._transition(rec, pod_identifier, HEALTHY, now)
                rec.recoveries += 1
                rec.last_seq.clear()
                rec.last_ts = None
                rec.stale_detected_at = None
            if seq is not None:
                last = rec.last_seq.get(topic)
                if last is not None:
                    if seq == last:
                        rec.duplicates += 1
                        metrics.count_stream_anomaly("duplicate")
                    elif seq < last:
                        rec.reorders += 1
                        metrics.count_stream_anomaly("reorder")
                    elif seq > last + 1:
                        rec.seq_gaps += 1
                        rec.gap_events += seq - last - 1
                        metrics.count_stream_anomaly("seq_gap")
                        logger.warning(
                            "event seq gap on %s topic=%s: %d -> %d "
                            "(%d batch(es) lost)",
                            pod_identifier, topic, last, seq, seq - last - 1,
                        )
                rec.last_seq[topic] = max(last or 0, seq)
            if rec.last_ts is not None and (
                ts + self.config.ts_regression_tolerance_s < rec.last_ts
            ):
                rec.ts_regressions += 1
                metrics.count_stream_anomaly("ts_regression")
            rec.last_ts = max(rec.last_ts or ts, ts)

    def observe_decode_failure(self, pod_identifier: str) -> None:
        """A poison-pill frame: the stream is alive but carrying garbage."""
        now = self.clock()
        with self._mu:
            rec = self._pods.get(pod_identifier)
            if rec is None:
                rec = _PodRecord(now)
                self._pods[pod_identifier] = rec
            rec.decode_failures += 1
            # Liveness is NOT stamped: a pod emitting only undecodable
            # frames provides no evidence its placement data is fresh.

    # -- subscriber stream state (zmq_subscriber.py) -----------------------

    def observe_subscriber_failure(self, consecutive: int) -> None:
        with self._mu:
            self._subscriber_failures = consecutive
            self._subscriber_connected = False

    def observe_subscriber_connected(self) -> None:
        with self._mu:
            self._subscriber_failures = 0
            self._subscriber_connected = True

    # -- data-plane breaker feed (kv_connectors/connector.py) --------------

    def observe_transfer_breaker(
        self, peer: str, old_state: str, new_state: str
    ) -> None:
        """One per-peer transfer-breaker transition (the TransferClient's
        `on_breaker_transition` callback lands here). Kept as a bounded
        per-peer record for status reads — peers are fleet
        topology, never traffic."""
        now = self.clock()
        with self._mu:
            rec = self._transfer_peers.get(peer)
            if rec is None:
                rec = self._transfer_peers[peer] = {
                    "state": new_state, "since": now, "transitions": 0,
                    "opens": 0,
                }
            rec["state"] = new_state
            rec["since"] = now
            rec["transitions"] += 1
            if new_state == "open":
                rec["opens"] += 1
        log = logger.info if new_state == "closed" else logger.warning
        log("transfer breaker for peer %s: %s -> %s", peer, old_state,
            new_state)

    def transfer_breaker_summary(self) -> dict:
        with self._mu:
            return {
                peer: dict(rec)
                for peer, rec in sorted(self._transfer_peers.items())
            }

    # -- state machine -----------------------------------------------------

    def _expected_state(self, rec: _PodRecord, now: float) -> str:
        age = now - rec.last_event_t
        if age >= self.config.stale_after_s:
            return STALE
        if age >= self.config.suspect_after_s:
            return SUSPECT
        return HEALTHY

    def _transition(
        self, rec: _PodRecord, pod: str, new_state: str, now: float
    ) -> None:
        """Record a state change. Caller holds `_mu`."""
        old = rec.state
        rec.state = new_state
        rec.state_since = now
        metrics.count_pod_transition(new_state)
        log = logger.info if new_state == HEALTHY else logger.warning
        log("pod %s: %s -> %s (last event %.1fs ago)",
            pod, old, new_state, now - rec.last_event_t)

    def refresh(self, now: Optional[float] = None) -> None:
        """Advance every pod's state to what the clock says it should be.

        Quarantine (the index purge) runs OUTSIDE the tracker lock — the
        index has its own locking, and a slow/remote backend must not
        block concurrent observe_batch calls.
        """
        if now is None:
            now = self.clock()
        to_purge: List[str] = []
        with self._mu:
            for pod, rec in self._pods.items():
                expected = self._expected_state(rec, now)
                if expected == rec.state:
                    continue
                self._transition(rec, pod, expected, now)
                if expected == STALE:
                    rec.stale_detected_at = now
                    rec.detection_latency_s = now - rec.last_event_t
                    if self.config.auto_quarantine:
                        to_purge.append(pod)
        for pod in to_purge:
            self._purge(pod)

    def _purge(self, pod: str) -> None:
        if self.index is None:
            self._fire_departed(pod)
            return
        try:
            removed = self.index.remove_pod(pod)
        except Exception as e:  # noqa: BLE001 - a purge failure must not
            # unwind the read path; the pod stays excluded by state anyway.
            logger.warning("failed to purge stale pod %s from index: %s", pod, e)
            return
        metrics.count_stale_purged(removed)
        with self._mu:
            rec = self._pods.get(pod)
            if rec is not None:
                rec.purged_entries += removed
        logger.warning(
            "quarantined stale pod %s: purged %d index entr%s",
            pod, removed, "y" if removed == 1 else "ies",
        )
        self._fire_departed(pod)

    def _fire_departed(self, pod: str) -> None:
        cb = self.on_departed
        if cb is None:
            return
        try:
            cb(pod)
        except Exception as e:  # noqa: BLE001 - the reap fan-out must
            # never unwind the state machine that detected the departure
            logger.warning("on_departed callback failed for %s: %s", pod, e)

    def quarantine(self, pod_identifier: str) -> int:
        """Force a pod stale and purge its index entries now. Returns the
        number of pod entries removed from the index."""
        now = self.clock()
        with self._mu:
            rec = self._pods.get(pod_identifier)
            if rec is None:
                rec = _PodRecord(now)
                # Backdate so the lazy state machine agrees it is stale.
                rec.last_event_t = now - self.config.stale_after_s
                self._pods[pod_identifier] = rec
            if rec.state != STALE:
                self._transition(rec, pod_identifier, STALE, now)
                rec.stale_detected_at = now
        if self.index is None:
            self._fire_departed(pod_identifier)
            return 0
        removed = self.index.remove_pod(pod_identifier)
        metrics.count_stale_purged(removed)
        with self._mu:
            rec = self._pods.get(pod_identifier)
            if rec is not None:
                rec.purged_entries += removed
        self._fire_departed(pod_identifier)
        return removed

    def forget_pod(self, pod_identifier: str) -> int:
        """Drop every record belonging to a departed pod — all DP-rank-
        qualified variants of its base identity, plus its transfer-peer
        breaker rows (peer host == base identity). The tracker re-learns
        a returning pod from its first decoded batch; forgetting costs
        anomaly history, never correctness. Returns rows removed."""
        base = base_pod_identifier(pod_identifier)
        removed = 0
        with self._mu:
            for key in [
                k for k in self._pods if base_pod_identifier(k) == base
            ]:
                del self._pods[key]
                removed += 1
            for peer in [
                p for p in self._transfer_peers
                if p.rsplit(":", 1)[0] == base
            ]:
                del self._transfer_peers[peer]
                removed += 1
        if removed:
            logger.info(
                "forgot departed pod %s: %d fleet-health row(s)",
                pod_identifier, removed,
            )
        return removed

    def entries(self) -> int:
        """Tracked per-pod + per-peer rows — the resource accountant's
        O(1) meter read."""
        with self._mu:
            return len(self._pods) + len(self._transfer_peers)

    def state_of(self, pod_identifier: str, now: Optional[float] = None) -> str:
        """Current state; pods the tracker has never seen are healthy (an
        absent stream is no evidence against a pod that never stored)."""
        if now is None:
            now = self.clock()
        self.refresh(now)
        with self._mu:
            rec = self._pods.get(pod_identifier)
            return rec.state if rec is not None else HEALTHY

    # -- read-path hook ----------------------------------------------------

    def filter_scores(self, scores: Dict[str, float]) -> Dict[str, float]:
        """Demote suspect pods, exclude stale pods; healthy pass untouched.

        On an all-healthy fleet this returns `scores` unchanged (the same
        dict object — zero overhead, bit-identical routing). An emptied map
        is the explicit no-cache-signal answer: the caller's load fallback
        takes over instead of phantom placements.
        """
        if not scores:
            return scores
        self.refresh()
        factor = self.config.suspect_demotion_factor
        with self._mu:
            demoted: Optional[Dict[str, float]] = None
            for pod in scores:
                rec = self._pods.get(pod)
                if rec is None or rec.state == HEALTHY:
                    continue
                if demoted is None:
                    demoted = dict(scores)
                if rec.state == STALE:
                    del demoted[pod]
                else:  # SUSPECT
                    demoted[pod] = demoted[pod] * factor
        return scores if demoted is None else demoted

    def score_factors(self, pod_identifiers) -> tuple:
        """Per-pod demotion modes for the native scoring core.

        Returns ``(modes, suspect_demotion_factor)`` where ``modes`` is a
        bytes object aligned with `pod_identifiers` (0 healthy/unknown,
        1 suspect, 2 stale), or ``(None, factor)`` when the tracker has
        seen no pods (the all-healthy zero-overhead path). ``None``
        entries in the input are skipped (the interner's id-0 sentinel).

        Modes come from `_expected_state` WITHOUT advancing the state
        machine: `refresh()` transitions land exactly on the expected
        state, so the demote/drop decisions are identical to
        `filter_scores` — but auto-quarantine purges must not run before
        the caller's fused lookup+score crossing (the Python batch path
        does every lookup before its first `filter_scores`). The caller
        runs the real `refresh()` after the crossing.
        """
        factor = self.config.suspect_demotion_factor
        now = self.clock()
        with self._mu:
            if not self._pods:
                return None, factor
            modes = bytearray(len(pod_identifiers))
            for i, pod in enumerate(pod_identifiers):
                if pod is None:
                    continue
                rec = self._pods.get(pod)
                if rec is None:
                    continue
                expected = self._expected_state(rec, now)
                if expected == STALE:
                    modes[i] = 2
                elif expected == SUSPECT:
                    modes[i] = 1
        return bytes(modes), factor

    # -- introspection -----------------------------------------------------

    def summary(self, now: Optional[float] = None) -> dict:
        """Fleet-health snapshot: per-pod state and counters, fleet counts."""
        if now is None:
            now = self.clock()
        self.refresh(now)
        with self._mu:
            pods = {}
            counts = {HEALTHY: 0, SUSPECT: 0, STALE: 0}
            for pod, rec in sorted(self._pods.items()):
                d = rec.as_dict()
                d["last_event_age_s"] = round(now - rec.last_event_t, 3)
                pods[pod] = d
                counts[rec.state] += 1
            out = {
                "pods": pods,
                "counts": counts,
                "subscriber": {
                    "connected": self._subscriber_connected,
                    "consecutive_failures": self._subscriber_failures,
                },
            }
            if self._transfer_peers:
                out["transfer_breakers"] = {
                    peer: dict(rec)
                    for peer, rec in sorted(self._transfer_peers.items())
                }
            return out

    def seq_snapshot(self) -> Dict[str, Dict[str, int]]:
        """Per-(pod, topic) last-applied wire seq: {pod: {topic: seq}}.

        The replication counters (the reference's cluster snapshot): a snapshot
        stores them next to the index view so a restarted replica can replay
        only the event tail — anything at-or-below these watermarks is already
        inside the imported view. Pods whose transport carries no seq are
        absent.
        """
        with self._mu:
            return {
                pod: dict(rec.last_seq)
                for pod, rec in self._pods.items()
                if rec.last_seq
            }

    def anomaly_totals(self) -> dict:
        with self._mu:
            return {
                "seq_gaps": sum(r.seq_gaps for r in self._pods.values()),
                "gap_events": sum(r.gap_events for r in self._pods.values()),
                "duplicates": sum(r.duplicates for r in self._pods.values()),
                "reorders": sum(r.reorders for r in self._pods.values()),
                "ts_regressions": sum(
                    r.ts_regressions for r in self._pods.values()
                ),
                "decode_failures": sum(
                    r.decode_failures for r in self._pods.values()
                ),
            }
