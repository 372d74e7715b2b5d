"""The autopilot's write surface: typed, clamped, steppable policy knobs.

Only `knobs` is ported so far; the reference package's `controller` and
`signals` (the closed loop that nudges these knobs) come with the rest of the
fleet planes' second half (ROADMAP.md queue 1 item 5). Subsystems publish their
knobs through `register_knobs(registry)` all the same.
"""

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

__all__ = [
    "AUTOPILOT_KNOBS",
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
]
