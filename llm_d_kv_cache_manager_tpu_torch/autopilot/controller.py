"""Closed-loop SLO autopilot: declarative rules from burn to bounded nudges.

Copy of the reference package's `autopilot/controller.py`.

The fleet's planes are observable — burn-rate gauges, breaker states,
trust EWMAs, per-source prefetch drops — but without a controller every
policy knob those signals should drive is a static value fixed at process
start.
This controller closes the loop, in the house discipline:

- **Clock-injected, pull-based.** ``tick(now)`` runs from whatever
  cadence the caller owns (the service's status/readyz polls, the fleet
  sim's arrival clock, tests with a hand clock). No background thread.
- **Every actuation bounded.** A rule may only nudge registered knobs,
  one ``max_step`` at a time, inside the knob's [floor, ceiling]; the
  controller cannot widen a bound or reach an unregistered surface.
- **Rate-limited.** A global ``min_interval_s`` between evaluation
  passes, a per-rule ``cooldown_s`` between firings, and a warm-up
  window before the first actuation (a young monitor's windows clip to
  its lifetime; acting on seconds of evidence is how autopilots
  oscillate).
- **Hysteresis, both directions.** A rule fires while its condition
  breaches; once the condition has been OK for ``decay_after_s``, the
  knobs it moved walk back toward baseline one bounded step per pass
  (rule ``decay_to_baseline``, direction ``revert``) until they are
  bit-identically at the operator's configured values.
- **Counted and journaled.** Every applied nudge increments
  ``kvcache_autopilot_actuations_total{rule,direction}`` and lands in a
  bounded in-memory journal (`/autopilot/status` shows the tail).

The no-op guarantee follows from the shape: a tick on healthy signals
assembles a snapshot (pure reads), evaluates rule conditions (pure
predicates), applies nothing, and mutates nothing — scores, routing,
and knob positions are bit-identical to an autopilot-free process
(pinned in tests/test_autopilot.py and the committed
FLEET_BENCH_AUTOPILOT.json healthy arm).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.autopilot.knobs import (
    KNOB_ADMISSION_QUEUE,
    KNOB_AUDIT_INTERVAL,
    KNOB_PLACEMENT_JOBS,
    KNOB_PLACEMENT_K,
    KNOB_PREDICTION_JOBS,
    KNOB_TRANSFER_HEDGE_FLOOR,
    KnobRegistry,
)
from llm_d_kv_cache_manager_tpu_torch.autopilot.signals import (
    SignalAssembler,
    SignalSnapshot,
)
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.obs.slo import (
    OBJECTIVE_HIT_RATE,
    OBJECTIVE_READ_LATENCY,
    OBJECTIVE_SHED_RATE,
    STATUS_BREACHING,
)
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("autopilot.controller")

# Fixed rule vocabulary (the `rule` label of
# kvcache_autopilot_actuations_total — bounded by construction, enforced
# by tests/test_metrics_hygiene.py). `decay_to_baseline` is the
# hysteresis pseudo-rule every revert actuation is attributed to.
RULE_READ_LATENCY = "read_latency_breach"
RULE_HIT_RATE = "hit_rate_burn"
RULE_BREAKER_TRIPS = "breaker_trips"
RULE_SHED_RATE = "shed_rate_burn"
RULE_DECAY = "decay_to_baseline"
AUTOPILOT_RULES = (
    RULE_READ_LATENCY,
    RULE_HIT_RATE,
    RULE_BREAKER_TRIPS,
    RULE_SHED_RATE,
    RULE_DECAY,
)

# Fixed direction vocabulary (the `direction` label of the same counter).
DIRECTION_UP = "up"
DIRECTION_DOWN = "down"
DIRECTION_REVERT = "revert"
AUTOPILOT_DIRECTIONS = (DIRECTION_UP, DIRECTION_DOWN, DIRECTION_REVERT)


@dataclass
class AutopilotConfig:
    """Env mapping (api/http_service.py): AUTOPILOT,
    AUTOPILOT_MIN_INTERVAL_S, AUTOPILOT_WARMUP_S, AUTOPILOT_COOLDOWN_S,
    AUTOPILOT_DECAY_AFTER_S."""

    # Floor between evaluation passes: polls faster than this are free
    # reads of the cached state, never extra actuations.
    min_interval_s: float = 1.0
    # No actuation until the controller has observed this much clock —
    # burn windows clipped to seconds of lifetime are noise, not signal.
    warmup_s: float = 10.0
    # Per-rule floor between firings: one bounded nudge, then watch the
    # windows move before nudging again.
    cooldown_s: float = 5.0
    # A rule's knobs start decaying back to baseline after its condition
    # has been OK for this long (and re-arm the moment it breaches again).
    decay_after_s: float = 15.0
    # Bounded actuation journal (the /autopilot/status tail).
    journal_len: int = 256

    def __post_init__(self):
        if self.min_interval_s <= 0:
            raise ValueError("min_interval_s must be positive")
        if self.warmup_s < 0:
            raise ValueError("warmup_s must be >= 0")
        if self.cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        if self.decay_after_s <= 0:
            raise ValueError("decay_after_s must be positive")
        if self.journal_len <= 0:
            raise ValueError("journal_len must be positive")


@dataclass(frozen=True)
class Rule:
    """One declarative mapping from a burn condition to bounded nudges.

    ``nudges`` is a tuple of (knob_name, signed step fraction): +1.0 is
    one full max_step up, -0.5 half a step down. Knobs absent from the
    registry are skipped — a rule is only as reachable as the surfaces
    its owners published."""

    name: str
    description: str
    condition: Callable[[SignalSnapshot], bool]
    nudges: Tuple[Tuple[str, float], ...]

    def __post_init__(self):
        if self.name not in AUTOPILOT_RULES:
            raise ValueError(
                f"unknown rule name {self.name!r} (not in AUTOPILOT_RULES)"
            )


def _objective_breaching(objective: str):
    def condition(snap: SignalSnapshot) -> bool:
        return snap.objective_status(objective) == STATUS_BREACHING

    return condition


def default_rules(breaker_trip_threshold: int = 2) -> List[Rule]:
    """The shipped rule set — one rule per burn signal, each nudging the
    cheapest lever that relieves it:

    - ``read_latency_breach``: the read path is paying for background
      work → shrink the replication and prediction prefetch budgets
      (the per-tick job caps are the batch-size knob those planes own).
    - ``hit_rate_burn``: the fleet is recomputing prefixes it should be
      hitting → raise replication K (more holders per hot prefix) and
      tighten the residency-audit interval (repair divergence sooner).
    - ``breaker_trips``: peers are tripping breakers → lower the hedge
      delay floor so the hedge to the next holder launches earlier.
      (The per-peer delay is EWMA-derived and clamped to [floor, cap];
      the floor is the config surface a controller can move.)
    - ``shed_rate_burn``: the serving surface is shedding → widen the
      admission waiting line, within its declared ceiling.
    """

    def breaker_condition(snap: SignalSnapshot) -> bool:
        return (
            len(snap.open_peers) > 0
            or snap.breaker_opens >= breaker_trip_threshold
        )

    return [
        Rule(
            name=RULE_READ_LATENCY,
            description=(
                "read_latency_p99 breaching both windows: shrink the "
                "background prefetch budgets riding the read path"
            ),
            condition=_objective_breaching(OBJECTIVE_READ_LATENCY),
            nudges=(
                (KNOB_PLACEMENT_JOBS, -1.0),
                (KNOB_PREDICTION_JOBS, -1.0),
            ),
        ),
        Rule(
            name=RULE_HIT_RATE,
            description=(
                "hit_rate breaching both windows: raise replication K "
                "and tighten the residency-audit interval"
            ),
            condition=_objective_breaching(OBJECTIVE_HIT_RATE),
            nudges=(
                (KNOB_PLACEMENT_K, 1.0),
                (KNOB_AUDIT_INTERVAL, -1.0),
            ),
        ),
        Rule(
            name=RULE_BREAKER_TRIPS,
            description=(
                "peer breakers tripping: lower the hedge delay floor so "
                "the hedge launches earlier"
            ),
            condition=breaker_condition,
            nudges=((KNOB_TRANSFER_HEDGE_FLOOR, -1.0),),
        ),
        Rule(
            name=RULE_SHED_RATE,
            description=(
                "shed_rate breaching both windows: widen the admission "
                "waiting line within its ceiling"
            ),
            condition=_objective_breaching(OBJECTIVE_SHED_RATE),
            nudges=((KNOB_ADMISSION_QUEUE, 1.0),),
        ),
    ]


class _RuleState:
    __slots__ = ("last_fired_t", "last_breach_t", "fired", "touched")

    def __init__(self):
        self.last_fired_t: Optional[float] = None
        self.last_breach_t: Optional[float] = None
        self.fired = 0
        # Knob names this rule has actually moved (the decay set).
        self.touched: set = set()


class AutopilotController:
    """Rules × knobs × signals, under one injected clock."""

    def __init__(
        self,
        registry: KnobRegistry,
        assembler: SignalAssembler,
        config: Optional[AutopilotConfig] = None,
        rules: Optional[Sequence[Rule]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.registry = registry
        self.assembler = assembler
        self.config = config or AutopilotConfig()
        self.rules = list(rules) if rules is not None else default_rules()
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self.clock = clock
        self._mu = threading.Lock()
        self._started_t: Optional[float] = None
        self._last_tick_t: Optional[float] = None
        self._last_decay_t: Optional[float] = None
        self._states: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules
        }
        # (t, rule, knob, direction, delta, position) — newest right.
        self.journal: deque = deque(maxlen=self.config.journal_len)
        self.stats = {"ticks": 0, "evaluations": 0, "actuations": 0,
                      "reverts": 0}
        self.last_snapshot: Optional[SignalSnapshot] = None

    # -- actuation ---------------------------------------------------------

    def _apply(
        self, now: float, rule_name: str, knob_name: str, frac: float
    ) -> Optional[tuple]:
        knob = self.registry.get(knob_name)
        if knob is None:
            return None
        delta = knob.nudge(frac * knob.spec.max_step)
        if delta == 0.0:
            return None
        direction = DIRECTION_UP if delta > 0 else DIRECTION_DOWN
        entry = (
            round(now, 3), rule_name, knob_name, direction,
            round(delta, 6), knob.position(),
        )
        self.journal.append(entry)
        self.stats["actuations"] += 1
        metrics.count_autopilot_actuation(rule_name, direction)
        logger.info(
            "autopilot actuation: rule=%s knob=%s %s by %g -> %g",
            rule_name, knob_name, direction, delta, knob.position(),
        )
        return entry

    def _decay(self, now: float) -> List[tuple]:
        """Walk fired rules' knobs back toward baseline once their
        conditions have been OK for decay_after_s, one bounded step per
        pass per knob."""
        applied = []
        # A knob may be touched by several rules; it decays only when
        # EVERY touching rule's condition has been quiet long enough.
        quiet: Dict[str, bool] = {}
        for rule in self.rules:
            st = self._states[rule.name]
            rule_quiet = (
                st.last_breach_t is None
                or now - st.last_breach_t >= self.config.decay_after_s
            )
            for knob_name in st.touched:
                quiet[knob_name] = quiet.get(knob_name, True) and rule_quiet
        for knob_name, is_quiet in sorted(quiet.items()):
            if not is_quiet:
                continue
            knob = self.registry.get(knob_name)
            if knob is None or knob.at_baseline():
                continue
            delta = knob.revert_step()
            if delta == 0.0:
                continue
            entry = (
                round(now, 3), RULE_DECAY, knob_name, DIRECTION_REVERT,
                round(delta, 6), knob.position(),
            )
            self.journal.append(entry)
            self.stats["actuations"] += 1
            self.stats["reverts"] += 1
            metrics.count_autopilot_actuation(RULE_DECAY, DIRECTION_REVERT)
            applied.append(entry)
            if knob.at_baseline():
                # Fully reverted: drop it from every rule's decay set so
                # the journal stays quiet until somebody breaches again.
                for st in self._states.values():
                    st.touched.discard(knob_name)
        return applied

    # -- the loop ----------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> List[tuple]:
        """One evaluation pass; returns the actuation entries applied
        (empty on healthy signals, rate-limit skips, and warm-up)."""
        if now is None:
            now = self.clock()
        with self._mu:
            self.stats["ticks"] += 1
            if self._started_t is None:
                self._started_t = now
            if (
                self._last_tick_t is not None
                and now - self._last_tick_t < self.config.min_interval_s
            ):
                return []
            self._last_tick_t = now
            self.stats["evaluations"] += 1
            snap = self.assembler.snapshot(now)
            self.last_snapshot = snap
            applied: List[tuple] = []
            warm = now - self._started_t >= self.config.warmup_s
            for rule in self.rules:
                st = self._states[rule.name]
                try:
                    hot = bool(rule.condition(snap))
                except Exception:  # noqa: BLE001 - one rule's reader must
                    hot = False    # not take the whole loop down
                if not hot:
                    continue
                st.last_breach_t = now
                if not warm:
                    continue
                if (
                    st.last_fired_t is not None
                    and now - st.last_fired_t < self.config.cooldown_s
                ):
                    continue
                fired_any = False
                for knob_name, frac in rule.nudges:
                    entry = self._apply(now, rule.name, knob_name, frac)
                    if entry is not None:
                        applied.append(entry)
                        st.touched.add(knob_name)
                        fired_any = True
                if fired_any:
                    st.last_fired_t = now
                    st.fired += 1
            # Decay pass rides the same cooldown cadence as rules do.
            if warm and (
                self._last_decay_t is None
                or now - self._last_decay_t >= self.config.cooldown_s
            ):
                decayed = self._decay(now)
                if decayed:
                    self._last_decay_t = now
                    applied.extend(decayed)
            return applied

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        """The /autopilot/status document: knob positions vs baseline,
        rule states, and the recent actuation tail."""
        with self._mu:
            rule_docs = {}
            for rule in self.rules:
                st = self._states[rule.name]
                rule_docs[rule.name] = {
                    "description": rule.description,
                    "nudges": [list(n) for n in rule.nudges],
                    "fired": st.fired,
                    "last_fired_t": st.last_fired_t,
                    "last_breach_t": st.last_breach_t,
                    "touched_knobs": sorted(st.touched),
                }
            journal_tail = [list(e) for e in list(self.journal)[-32:]]
            return {
                "config": {
                    "min_interval_s": self.config.min_interval_s,
                    "warmup_s": self.config.warmup_s,
                    "cooldown_s": self.config.cooldown_s,
                    "decay_after_s": self.config.decay_after_s,
                },
                "knobs": self.registry.positions(),
                "at_baseline": self.registry.at_baseline(),
                "rules": rule_docs,
                "recent_actuations": journal_tail,
                "stats": dict(self.stats),
            }
