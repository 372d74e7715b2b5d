"""Read-only signal assembly — the autopilot's eyes.

Copy of the reference package's `autopilot/signals.py`.

The controller never touches the subsystems it reads: this module
projects their existing public introspection surfaces (`SLOMonitor
.evaluate`, `PodLoadTracker.snapshot`, `TransferClient.status`'s
per-peer breaker states, `AntiEntropyTracker.status`, `RoutePrefetcher
.status`'s per-source drop counters) into one immutable
`SignalSnapshot` per tick. Assembly is observation with zero side
effects on scoring or routing — the SLO evaluation it triggers updates
the burn-rate gauges exactly as a /slo/status poll would, nothing else
— which is what makes the healthy-signals bit-identity pin structural:
an autopilot whose rules never fire has read some dicts and written
nothing.

Every source is optional (None ⇒ its fields read as empty/healthy): the
service wires whatever subsystems the deployment attached, the fleet
sim wires its own counters through injected SLO objectives, and the
controller's rules only see the one snapshot type either way.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.obs.slo import (
    STATUS_BREACHING,
    STATUS_WARNING,
)


@dataclass(frozen=True)
class SignalSnapshot:
    """One tick's worth of fleet evidence, already reduced to the fields
    the rules condition on. `slo` carries the full evaluate() document
    for the journal/status surfaces; the tuples are the rule inputs."""

    t: float
    # SLO plane.
    slo: dict = field(default_factory=dict)
    breaching: Tuple[str, ...] = ()
    warnings: Tuple[str, ...] = ()
    # Transfer plane: peers whose breaker is currently open, plus the
    # number of breaker opens NEWLY observed since the previous snapshot
    # (a delta, not the lifetime counter: a condition on cumulative trip
    # counts would latch true forever and the hysteresis decay could
    # never walk the touched knobs home).
    open_peers: Tuple[str, ...] = ()
    breaker_opens: int = 0
    # Index-truth plane: pods the trust tracker currently demotes.
    distrusted_pods: Tuple[str, ...] = ()
    min_accuracy: float = 1.0
    # Prefetch plane: cumulative per-source drop counters.
    prefetch_drops: Dict[str, int] = field(default_factory=dict)
    # Load plane: {pod: load dict} (PodLoadTracker.snapshot).
    load: Dict[str, dict] = field(default_factory=dict)
    # Memory plane: accounted-bytes / budget from the resource governor
    # (0.0 with no governor attached — absent pressure is no pressure).
    memory_pressure: float = 0.0

    def objective_status(self, objective: str) -> str:
        doc = self.slo.get("objectives", {}).get(objective)
        return doc["status"] if doc else "no_data"

    def burn(self, objective: str, window: str) -> float:
        doc = self.slo.get("objectives", {}).get(objective)
        if not doc:
            return 0.0
        return doc.get("windows", {}).get(window, {}).get("burn_rate", 0.0)


class SignalAssembler:
    """Builds one `SignalSnapshot` per call from whatever sources are
    attached. Strictly read-only over every source."""

    def __init__(
        self,
        slo_monitor=None,
        load_tracker=None,
        transfer_client=None,
        antientropy=None,
        prefetchers: Optional[Dict[str, object]] = None,
        resourcegov=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.slo_monitor = slo_monitor
        self.load_tracker = load_tracker
        self.transfer_client = transfer_client
        self.antientropy = antientropy
        # resourcegov.ResourceGovernor (or anything with a `pressure()`
        # float): the memory plane. Attached after construction by the
        # service wiring (the governor meters subsystems built later).
        self.resourcegov = resourcegov
        # {plane_name: RoutePrefetcher} — the service attaches e.g.
        # {"placement": ..., "prediction": ...}; drops are summed per
        # SOURCE label across them (the queues already tag per source).
        self.prefetchers = dict(prefetchers or {})
        self.clock = clock
        # Last seen lifetime breaker-open total. The first snapshot
        # BASELINES it (delta 0): attaching an autopilot to a fleet with
        # historical trips must not read as a live incident — open_peers
        # carries the "open right now" evidence either way.
        self._seen_breaker_opens: Optional[int] = None

    def snapshot(self, now: Optional[float] = None) -> SignalSnapshot:
        if now is None:
            now = self.clock()
        slo_doc: dict = {}
        breaching: Tuple[str, ...] = ()
        warnings: Tuple[str, ...] = ()
        if self.slo_monitor is not None:
            slo_doc = self.slo_monitor.evaluate(now)
            objectives = slo_doc.get("objectives", {})
            breaching = tuple(
                name for name, doc in objectives.items()
                if doc.get("status") == STATUS_BREACHING
            )
            warnings = tuple(
                name for name, doc in objectives.items()
                if doc.get("status") == STATUS_WARNING
            )

        open_peers: Tuple[str, ...] = ()
        breaker_opens = 0
        if self.transfer_client is not None:
            try:
                peers = self.transfer_client.status().get("peers", {})
            except Exception:  # noqa: BLE001 - a signal source must never
                peers = {}     # take the controller down with it
            open_peers = tuple(
                sorted(
                    key for key, doc in peers.items()
                    if doc.get("state") == "open"
                )
            )
            total_opens = sum(
                int(doc.get("opens", 0)) for doc in peers.values()
            )
            if self._seen_breaker_opens is not None:
                breaker_opens = max(
                    0, total_opens - self._seen_breaker_opens
                )
            self._seen_breaker_opens = total_opens

        distrusted: Tuple[str, ...] = ()
        min_accuracy = 1.0
        if self.antientropy is not None:
            try:
                doc = self.antientropy.status()
            except Exception:  # noqa: BLE001
                doc = {"pods": {}}
            pods = doc.get("pods", {})
            distrusted = tuple(
                sorted(
                    pod for pod, pdoc in pods.items()
                    if pdoc.get("factor", 1.0) < 1.0
                )
            )
            if pods:
                min_accuracy = min(
                    float(pdoc.get("accuracy", 1.0))
                    for pdoc in pods.values()
                )

        drops: Dict[str, int] = {}
        for prefetcher in self.prefetchers.values():
            try:
                by_source = prefetcher.status().get("by_source", {})
            except Exception:  # noqa: BLE001
                by_source = {}
            for source, st in by_source.items():
                drops[source] = drops.get(source, 0) + int(
                    st.get("dropped", 0)
                )

        load: Dict[str, dict] = {}
        if self.load_tracker is not None:
            try:
                load = self.load_tracker.snapshot(now)
            except Exception:  # noqa: BLE001
                load = {}

        memory_pressure = 0.0
        if self.resourcegov is not None:
            try:
                memory_pressure = float(self.resourcegov.pressure())
            except Exception:  # noqa: BLE001
                memory_pressure = 0.0

        return SignalSnapshot(
            t=now,
            slo=slo_doc,
            breaching=breaching,
            warnings=warnings,
            open_peers=open_peers,
            breaker_opens=breaker_opens,
            distrusted_pods=distrusted,
            min_accuracy=min_accuracy,
            prefetch_drops=drops,
            load=load,
            memory_pressure=memory_pressure,
        )
