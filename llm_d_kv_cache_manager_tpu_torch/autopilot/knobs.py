"""Typed, clamped, steppable policy knobs — the autopilot's write surface.

Copy of the reference package's `autopilot/knobs.py`. Every subsystem re-reads its config dataclass on each
tick/call (`ResidencyAuditor.tick`, the resource governor's budget, ...),
so an in-place mutation of a config attribute is an immediate,
thread-visible actuation with no new plumbing. This module makes those
mutations SAFE to automate:

- a **KnobSpec** declares the knob's hard floor and ceiling (the
  controller can NEVER push a knob outside them, whatever its rules
  say), the max step per actuation (one nudge is always small), and
  whether the underlying field is integral;
- a **Knob** binds a spec to getter/setter callables over the owning
  config object and captures the owner's value at registration time as
  the **baseline** — the position every revert path walks back to, step
  by bounded step, until the knob is bit-identically where the operator
  configured it;
- a **KnobRegistry** is the controller's only handle: subsystems opt in
  by calling their own ``register_knobs(registry)``, so the autopilot
  can only ever touch surfaces whose owners explicitly published them.

Knob names are a fixed vocabulary (`AUTOPILOT_KNOBS`) — the
``kvcache_autopilot_knob_position{knob}`` gauge's label values come from
this tuple and nowhere else (pinned in tests/test_metrics_hygiene.py).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("autopilot.knobs")

# Fixed knob-name vocabulary (the `knob` label of
# kvcache_autopilot_knob_position — bounded by construction, enforced by
# tests/test_metrics_hygiene.py). Each name is owned by exactly one
# subsystem's register_knobs().
KNOB_PLACEMENT_K = "placement.k_replicas"
KNOB_PLACEMENT_JOBS = "placement.max_jobs_per_tick"
KNOB_PREDICTION_JOBS = "prediction.max_jobs_per_tick"
KNOB_TRANSFER_HEDGE_FLOOR = "transfer.hedge_delay_floor_s"
KNOB_ADMISSION_QUEUE = "admission.max_queue_depth"
KNOB_AUDIT_INTERVAL = "antientropy.interval_s"
KNOB_RESOURCEGOV_BUDGET = "resourcegov.budget_mb"
AUTOPILOT_KNOBS = (
    KNOB_PLACEMENT_K,
    KNOB_PLACEMENT_JOBS,
    KNOB_PREDICTION_JOBS,
    KNOB_TRANSFER_HEDGE_FLOOR,
    KNOB_ADMISSION_QUEUE,
    KNOB_AUDIT_INTERVAL,
    KNOB_RESOURCEGOV_BUDGET,
)


@dataclass
class KnobSpec:
    """Static bounds a knob carries for its whole life. The controller
    reads them; it can never widen them."""

    name: str
    floor: float
    ceiling: float
    # Largest |delta| one actuation may apply. Reverts are bounded by the
    # same step: decay walks back to baseline, it never teleports.
    max_step: float
    integer: bool = False
    description: str = ""

    def __post_init__(self):
        if self.name not in AUTOPILOT_KNOBS:
            raise ValueError(
                f"unknown knob name {self.name!r} (not in AUTOPILOT_KNOBS)"
            )
        if not (self.floor <= self.ceiling):
            raise ValueError(f"{self.name}: floor must be <= ceiling")
        if self.max_step <= 0:
            raise ValueError(f"{self.name}: max_step must be positive")


class Knob:
    """One actuator: spec + getter/setter over the owning config object,
    with the registration-time value as the revert baseline."""

    def __init__(
        self,
        spec: KnobSpec,
        get: Callable[[], float],
        set_: Callable[[float], None],
    ):
        self.spec = spec
        self._get = get
        self._set = set_
        baseline = float(get())
        if not (spec.floor <= baseline <= spec.ceiling):
            raise ValueError(
                f"{spec.name}: baseline {baseline} outside "
                f"[{spec.floor}, {spec.ceiling}]"
            )
        self.baseline = baseline
        self.nudges = 0

    def position(self) -> float:
        return float(self._get())

    def at_baseline(self) -> bool:
        return self.position() == self.baseline

    def _coerce(self, value: float) -> float:
        value = min(self.spec.ceiling, max(self.spec.floor, value))
        if self.spec.integer:
            value = float(int(round(value)))
        return value

    def nudge(self, delta: float) -> float:
        """Apply a bounded step; returns the delta actually applied
        (0.0 when already pinned at the relevant bound). The requested
        delta is clipped to ±max_step, then the landing position to
        [floor, ceiling]."""
        step = max(-self.spec.max_step, min(self.spec.max_step, delta))
        before = self.position()
        after = self._coerce(before + step)
        if after == before:
            return 0.0
        self._set(int(after) if self.spec.integer else after)
        self.nudges += 1
        metrics.set_autopilot_knob_position(self.spec.name, after)
        return after - before

    def revert_step(self) -> float:
        """One bounded step toward baseline; lands EXACTLY on baseline
        once within max_step of it (so a reverted knob is bit-identical
        to the operator's configured value, not epsilon-close). Returns
        the applied delta."""
        before = self.position()
        gap = self.baseline - before
        if gap == 0.0:
            return 0.0
        step = max(-self.spec.max_step, min(self.spec.max_step, gap))
        after = self.baseline if abs(gap) <= self.spec.max_step else (
            self._coerce(before + step)
        )
        if after == before:
            return 0.0
        self._set(int(after) if self.spec.integer else after)
        self.nudges += 1
        metrics.set_autopilot_knob_position(self.spec.name, after)
        return after - before

    def status(self) -> dict:
        pos = self.position()
        return {
            "position": pos,
            "baseline": self.baseline,
            "floor": self.spec.floor,
            "ceiling": self.spec.ceiling,
            "max_step": self.spec.max_step,
            "integer": self.spec.integer,
            "at_baseline": pos == self.baseline,
            "nudges": self.nudges,
        }


class KnobRegistry:
    """The controller's only write handle over the fleet's policy
    surfaces. Owners publish knobs (``register_knobs(registry)``); the
    controller nudges them by name; nothing unregistered is reachable."""

    def __init__(self):
        self._mu = threading.Lock()
        self._knobs: Dict[str, Knob] = {}

    def register(
        self,
        spec: KnobSpec,
        get: Callable[[], float],
        set_: Callable[[float], None],
    ) -> Knob:
        knob = Knob(spec, get, set_)
        with self._mu:
            if spec.name in self._knobs:
                raise ValueError(f"knob {spec.name!r} already registered")
            self._knobs[spec.name] = knob
        metrics.set_autopilot_knob_position(spec.name, knob.baseline)
        logger.info(
            "autopilot knob registered: %s baseline=%g bounds=[%g, %g] "
            "max_step=%g",
            spec.name, knob.baseline, spec.floor, spec.ceiling,
            spec.max_step,
        )
        return knob

    def get(self, name: str) -> Optional[Knob]:
        with self._mu:
            return self._knobs.get(name)

    def names(self) -> List[str]:
        with self._mu:
            return sorted(self._knobs)

    def at_baseline(self) -> bool:
        with self._mu:
            knobs = list(self._knobs.values())
        return all(k.at_baseline() for k in knobs)

    def positions(self) -> Dict[str, dict]:
        with self._mu:
            knobs = dict(self._knobs)
        return {name: knob.status() for name, knob in sorted(knobs.items())}
