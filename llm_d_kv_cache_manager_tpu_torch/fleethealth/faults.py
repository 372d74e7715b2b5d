"""Deterministic fault injection for the KV-event write plane.

Copy of the reference package's `fleethealth/faults.py`. Faults are injected at
the pod→pool delivery seam (the same place a pod's event sink and the ZMQ
subscriber hand `Message`s to `EventPool.add_task`), so everything downstream —
decode, sharding, digest, liveness tracking — is the REAL code path under test.
The injector never inspects payloads; it only drops, duplicates, holds, and
swaps whole messages, exactly what a crashed pod, a stalled stream, or a
lossy/reordering transport does.

Fault classes (per pod, composable):

- **crash / restart**: every message in ``[crash_at_s, restart_at_s)`` is
  swallowed (the pod is gone; nothing publishes). The caller running the
  plan additionally stops *serving* on the pod and replaces it with a cold
  instance at restart.
- **stall**: messages in ``[stall_from_s, stall_until_s)`` are swallowed —
  a wedged publisher/subscriber whose overflow is dropped. The pod keeps
  serving; the index's view of it silently freezes.
- **drop_rate**: each message is independently lost with this probability
  (seeded RNG) — the receiver sees seq gaps.
- **duplicate_rate**: the message is delivered twice, same seq.
- **reorder_rate**: the message is held and delivered AFTER the pod's
  next message — adjacent swap, the receiver sees seq go backwards.

Silent-divergence modes (antientropy/). Unlike the classes above,
these corrupt the index's CONTENT while the stream stays perfectly
healthy (no gap, no silence — nothing fleethealth can see), which is the
failure family the anti-entropy loop exists to heal:

- **silent_wipe_at_s**: the pod loses its cache at this instant (engine
  restart whose removal events were lost) but keeps publishing and
  serving seamlessly — every pre-wipe index entry becomes phantom. The
  caller running the plan owns the cache replacement; the field here is
  the plan's declarative record of it.
- **phantom_advertise_rate / phantom_from_s / phantom_until_s**: a buggy
  engine advertising blocks it never holds. After each of the pod's own
  deliveries in the window, with this probability a recently-seen
  BlockStored message from ANOTHER pod is re-delivered re-attributed to
  this pod (seq=None — the phantom stream carries no sequence, so it
  cannot masquerade as gap evidence): the index learns placements the
  pod cannot serve. These two modes decode payloads (the donor ring must
  recognize BlockStored) — the only modes that do.

Everything is driven by an injected clock and a seeded RNG: a fault run
is a pure function of (plan, workload), replayable bit-for-bit.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


@dataclass
class PodFaults:
    crash_at_s: Optional[float] = None
    restart_at_s: Optional[float] = None  # None with crash_at_s = stays dead
    stall_from_s: Optional[float] = None
    stall_until_s: Optional[float] = None
    drop_rate: float = 0.0
    duplicate_rate: float = 0.0
    reorder_rate: float = 0.0
    # Silent-divergence modes (module docstring): a cache loss the event
    # stream never reports (one-shot at silent_wipe_at_s; recurring every
    # silent_wipe_every_s until silent_wipe_until_s when every > 0 — the
    # "leaky cache layer" shape), and a phantom-advertisement window.
    silent_wipe_at_s: Optional[float] = None
    silent_wipe_every_s: float = 0.0
    silent_wipe_until_s: Optional[float] = None
    phantom_advertise_rate: float = 0.0
    phantom_from_s: Optional[float] = None
    phantom_until_s: Optional[float] = None

    def phantom_active(self, now: float) -> bool:
        if self.phantom_advertise_rate <= 0.0:
            return False
        if self.phantom_from_s is not None and now < self.phantom_from_s:
            return False
        return self.phantom_until_s is None or now < self.phantom_until_s

    def crashed(self, now: float) -> bool:
        if self.crash_at_s is None or now < self.crash_at_s:
            return False
        return self.restart_at_s is None or now < self.restart_at_s

    def stalled(self, now: float) -> bool:
        return (
            self.stall_from_s is not None
            and self.stall_from_s <= now
            and (self.stall_until_s is None or now < self.stall_until_s)
        )


@dataclass
class FaultPlan:
    seed: int = 0
    pods: Dict[str, PodFaults] = field(default_factory=dict)
    # Indexer (control-plane) fault: the index service itself dies at
    # crash_at and comes back at restart_at. While down, nothing digests
    # events and nothing answers scoring calls — the replicated control
    # plane's whole reason to exist. A restarted instance starts from an
    # empty index (cold) or a snapshot + seq-tail replay (warm).
    indexer_crash_at_s: Optional[float] = None
    indexer_restart_at_s: Optional[float] = None

    def for_pod(self, pod_id: str) -> Optional[PodFaults]:
        return self.pods.get(pod_id)

    def indexer_crashed(self, now: float) -> bool:
        if self.indexer_crash_at_s is None or now < self.indexer_crash_at_s:
            return False
        return (
            self.indexer_restart_at_s is None
            or now < self.indexer_restart_at_s
        )

    def as_dict(self) -> dict:
        """JSON-serializable provenance for a run's record."""
        out: Dict[str, dict] = {}
        for pod, f in sorted(self.pods.items()):
            out[pod] = {
                k: v
                for k, v in (
                    ("crash_at_s", f.crash_at_s),
                    ("restart_at_s", f.restart_at_s),
                    ("stall_from_s", f.stall_from_s),
                    ("stall_until_s", f.stall_until_s),
                    ("drop_rate", f.drop_rate),
                    ("duplicate_rate", f.duplicate_rate),
                    ("reorder_rate", f.reorder_rate),
                    ("silent_wipe_at_s", f.silent_wipe_at_s),
                    ("silent_wipe_every_s", f.silent_wipe_every_s),
                    ("silent_wipe_until_s", f.silent_wipe_until_s),
                    ("phantom_advertise_rate", f.phantom_advertise_rate),
                    ("phantom_from_s", f.phantom_from_s),
                    ("phantom_until_s", f.phantom_until_s),
                )
                if v not in (None, 0.0)
            }
        doc = {"seed": self.seed, "pods": out}
        if self.indexer_crash_at_s is not None:
            doc["indexer"] = {
                "crash_at_s": self.indexer_crash_at_s,
                "restart_at_s": self.indexer_restart_at_s,
            }
        return doc


class FaultInjector:
    """Applies a FaultPlan at the message-delivery seam.

    `wrap(pod_id, deliver)` returns a delivery callable with the pod's
    faults applied; pods without planned faults get `deliver` back
    unwrapped (zero overhead — the no-fault path stays bit-identical).
    """

    def __init__(self, plan: FaultPlan, clock: Callable[[], float]):
        self.plan = plan
        self.clock = clock
        self._rng = random.Random(plan.seed)
        # pod -> (message awaiting swap, its delivery callable)
        self._held: Dict[str, tuple] = {}
        # Phantom-advertiser donor ring: recent BlockStored-carrying
        # messages from NON-phantom pods, recorded only when the plan
        # actually contains a phantom mode (pods without planned faults
        # otherwise stay unwrapped — zero overhead).
        self._phantom_in_plan = any(
            f.phantom_advertise_rate > 0.0 for f in plan.pods.values()
        )
        self._donor_ring: list = []
        self._donor_cap = 64
        self.injected = {
            "crash_dropped": 0,
            "stall_dropped": 0,
            "dropped": 0,
            "duplicated": 0,
            "reordered": 0,
            "phantom_advertised": 0,
        }

    def _record_donor(self, msg) -> None:
        """Admit a store-carrying message to the donor ring (decodes the
        payload — acceptable in a fault run, and only reached
        when a phantom mode is planned). Host-tier stores are tagged:
        they are the FETCHABLE advertisements (the data plane only pulls
        staged blocks), so the phantom pick prefers them — a phantom
        device-tier entry misleads only scoring, a phantom host-tier
        entry also sells fetches that can never land."""
        from llm_d_kv_cache_manager_tpu_torch.kvevents.events import (
            BlockStored,
            EventBatch,
        )

        try:
            batch = EventBatch.from_msgpack(msg.payload)
        except Exception:  # noqa: BLE001 - poison pills make poor donors
            return
        stores = [e for e in batch.events if isinstance(e, BlockStored)]
        if not stores:
            return
        hosty = any(
            (e.medium or "").lower() in ("host", "cpu") for e in stores
        )
        self._donor_ring.append((msg, hosty))
        if len(self._donor_ring) > self._donor_cap:
            self._donor_ring.pop(0)

    def _phantom_copy(self, pod_id: str):
        """A seeded donor pick re-attributed to `pod_id`: the phantom
        advertisement (blocks another pod computed, claimed by this one),
        host-tier donors preferred (see _record_donor). seq=None — the
        phantom stream must not double as seq-gap noise."""
        import dataclasses

        donors = [
            (m, hosty) for m, hosty in self._donor_ring
            if m.pod_identifier != pod_id
        ]
        if not donors:
            return None
        host_donors = [m for m, hosty in donors if hosty]
        pool = host_donors if host_donors else [m for m, _h in donors]
        donor = pool[self._rng.randrange(len(pool))]
        return dataclasses.replace(
            donor,
            pod_identifier=pod_id,
            topic=f"kv@{pod_id}@{donor.model_name}",
            seq=None,
            enqueue_t=0.0,
        )

    def wrap(self, pod_id: str, deliver: Callable) -> Callable:
        faults = self.plan.for_pod(pod_id)
        if faults is None:
            if not self._phantom_in_plan:
                return deliver

            # Donor-only wrapper: healthy pods feed the phantom ring.
            def recording_delivery(msg):
                self._record_donor(msg)
                deliver(msg)

            return recording_delivery

        def delivery(msg):
            now = self.clock()
            if faults.crashed(now):
                self.injected["crash_dropped"] += 1
                return
            if faults.stalled(now):
                self.injected["stall_dropped"] += 1
                return
            if faults.drop_rate and self._rng.random() < faults.drop_rate:
                self.injected["dropped"] += 1
                return
            if self._phantom_in_plan and faults.phantom_advertise_rate <= 0.0:
                self._record_donor(msg)
            if faults.reorder_rate:
                held = self._held.pop(pod_id, None)
                if held is not None:
                    # Second half of an adjacent swap: newer first.
                    deliver(msg)
                    held[1](held[0])
                    self.injected["reordered"] += 1
                    return
                if self._rng.random() < faults.reorder_rate:
                    self._held[pod_id] = (msg, deliver)
                    return
            deliver(msg)
            if faults.duplicate_rate and self._rng.random() < faults.duplicate_rate:
                deliver(msg)
                self.injected["duplicated"] += 1
            if (
                faults.phantom_active(now)
                and self._rng.random() < faults.phantom_advertise_rate
            ):
                phantom = self._phantom_copy(pod_id)
                if phantom is not None:
                    deliver(phantom)
                    self.injected["phantom_advertised"] += 1

        return delivery

    def flush(self) -> None:
        """Deliver any message still held for a reorder swap (end of run —
        a real transport would eventually flush its buffer too)."""
        held, self._held = self._held, {}
        for msg, deliver in held.values():
            deliver(msg)

    def held_count(self) -> int:
        return len(self._held)
