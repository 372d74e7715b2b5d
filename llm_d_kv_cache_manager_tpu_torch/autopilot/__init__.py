"""SLO-driven autopilot: a closed-loop controller plane over the
fleet's policy knobs.

Copy of the reference package's `autopilot/__init__.py`.

Three pieces, one discipline (docs/architecture.md "SLO autopilot"):

- `signals` — read-only snapshot assembly over the observability
  surfaces the fleet already exposes;
- `knobs` — typed, clamped, steppable actuators the owning subsystems
  publish (`register_knobs(registry)`), each with a hard floor/ceiling,
  a max step per actuation, and a bounded revert-to-baseline path;
- `controller` — declarative rules from burn conditions to bounded
  nudges, with warm-up, per-rule cooldowns, and hysteresis decay.

Healthy signals ⇒ the whole plane is bit-identical to not having it.
"""

from llm_d_kv_cache_manager_tpu_torch.autopilot.controller import (
    AUTOPILOT_DIRECTIONS,
    AUTOPILOT_RULES,
    AutopilotConfig,
    AutopilotController,
    DIRECTION_DOWN,
    DIRECTION_REVERT,
    DIRECTION_UP,
    RULE_BREAKER_TRIPS,
    RULE_DECAY,
    RULE_HIT_RATE,
    RULE_READ_LATENCY,
    RULE_SHED_RATE,
    Rule,
    default_rules,
)
from llm_d_kv_cache_manager_tpu_torch.autopilot.knobs import (
    AUTOPILOT_KNOBS,
    KNOB_ADMISSION_QUEUE,
    KNOB_AUDIT_INTERVAL,
    KNOB_PLACEMENT_JOBS,
    KNOB_PLACEMENT_K,
    KNOB_PREDICTION_JOBS,
    KNOB_RESOURCEGOV_BUDGET,
    KNOB_TRANSFER_HEDGE_FLOOR,
    Knob,
    KnobRegistry,
    KnobSpec,
)
from llm_d_kv_cache_manager_tpu_torch.autopilot.signals import (
    SignalAssembler,
    SignalSnapshot,
)

__all__ = [
    "AUTOPILOT_DIRECTIONS",
    "AUTOPILOT_KNOBS",
    "AUTOPILOT_RULES",
    "AutopilotConfig",
    "AutopilotController",
    "DIRECTION_DOWN",
    "DIRECTION_REVERT",
    "DIRECTION_UP",
    "KNOB_ADMISSION_QUEUE",
    "KNOB_AUDIT_INTERVAL",
    "KNOB_PLACEMENT_JOBS",
    "KNOB_PLACEMENT_K",
    "KNOB_PREDICTION_JOBS",
    "KNOB_RESOURCEGOV_BUDGET",
    "KNOB_TRANSFER_HEDGE_FLOOR",
    "Knob",
    "KnobRegistry",
    "KnobSpec",
    "RULE_BREAKER_TRIPS",
    "RULE_DECAY",
    "RULE_HIT_RATE",
    "RULE_READ_LATENCY",
    "RULE_SHED_RATE",
    "Rule",
    "SignalAssembler",
    "SignalSnapshot",
    "default_rules",
]
