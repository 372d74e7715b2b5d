"""Pressure state machine + shed ladder: graceful degradation under load.

Copy of the reference package's `resourcegov/governor.py`. The accountant (accountant.py) says how big every
stateful structure is; this module decides what to do about it. A configured
byte budget over the summed accounted bytes drives a three-level pressure state
machine — ``ok -> elevated -> critical`` with hysteresis back down
(`recover_frac`, strictly below the elevated threshold, so the level cannot
flap on a boundary) — and each level actuates a **shed ladder** in explicit
priority order:

1. **obs** — trace rings and slow-outlier reservoirs: pure
   introspection; losing them costs debuggability, never a request.
2. **sessions** — prediction session records: losing one costs the
   next turn's anticipatory prefetch (it degrades to reactive serving).
3. **popularity** — coldest top-K chains dropped + a sketch rescale:
   replication targeting coarsens.
4. **chain_memo / prefix_store** — memoized derivations: the next
   request pays a cold tokenization/hash, bit-identical results.
5. **index** — capacity itself, ONLY at critical and only in bounded
   steps (the index is the product; everything above is its support),
   with a restore hook that walks capacity back to baseline once
   pressure clears.

Mechanics reuse the autopilot's actuation idioms (autopilot/
controller.py): clock-injected, thread-free `tick()`, a min-interval
rate limit, per-rung cooldowns, a bounded actuation journal, and
hysteresis that walks every touched structure home — a governor over a
fleet that never crosses its budget journals nothing and sheds nothing.
The governor also publishes its budget as an autopilot knob
(`resourcegov.budget_mb`). Its `memory_pressure` signal into the
autopilot's `SignalSnapshot` waits for the port of `autopilot/signals.py`;
`pressure()` is the O(1) read that signal takes.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.resourcegov.accountant import (
    RESOURCE_STRUCTURES,
    STRUCT_CHAIN_MEMO,
    STRUCT_INDEX,
    STRUCT_OBS,
    STRUCT_POPULARITY,
    STRUCT_PREFIX_STORE,
    STRUCT_SESSIONS,
    ResourceAccountant,
)
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("resourcegov.governor")

# Fixed pressure-level vocabulary — the only values the
# kvcache_resource_pressure_transitions_total `level` label may carry
# (pinned in tests/test_metrics_hygiene.py).
LEVEL_OK = "ok"
LEVEL_ELEVATED = "elevated"
LEVEL_CRITICAL = "critical"
RESOURCE_LEVELS = (LEVEL_OK, LEVEL_ELEVATED, LEVEL_CRITICAL)


@dataclass(frozen=True)
class ShedRung:
    """One ladder step: which structure, how much, and from what level."""

    structure: str
    fraction: float
    critical_only: bool = False

    def __post_init__(self):
        if self.structure not in RESOURCE_STRUCTURES:
            raise ValueError(f"unknown rung structure {self.structure!r}")
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"{self.structure}: fraction must be in (0, 1]")


# The explicit priority order (cheapest evidence first, the index last
# and only at critical — see the module docstring). Fractions are per
# ACTUATION: a rung can fire again after its cooldown if pressure holds.
SHED_LADDER: Tuple[ShedRung, ...] = (
    ShedRung(STRUCT_OBS, 0.50),
    ShedRung(STRUCT_SESSIONS, 0.25),
    ShedRung(STRUCT_POPULARITY, 0.25),
    ShedRung(STRUCT_CHAIN_MEMO, 0.25),
    ShedRung(STRUCT_PREFIX_STORE, 0.25),
    ShedRung(STRUCT_INDEX, 0.10, critical_only=True),
)


@dataclass
class ResourceGovConfig:
    """Knobs of the governor; thresholds are fractions of the budget."""

    # The policy ceiling over summed accounted bytes. Published as the
    # `resourcegov.budget_mb` autopilot knob.
    budget_mb: float = 256.0
    # Pressure thresholds (fractions of the budget). recover_frac must
    # sit strictly below elevated_frac — the hysteresis band.
    elevated_frac: float = 0.85
    critical_frac: float = 0.95
    recover_frac: float = 0.70
    # Tick rate limit + per-rung actuation cooldown (one structure is
    # never shed twice inside its cooldown, however hard pressure holds).
    min_interval_s: float = 1.0
    cooldown_s: float = 10.0
    # Bounded actuation journal (newest last).
    journal_len: int = 64
    # Optional RSS sanity cross-check: annotates status() with the
    # process RSS next to the accounted sum. Never drives actuation —
    # RSS is allocator- and platform-shaped; the accounted signal is
    # the deterministic one.
    rss_probe: bool = False

    def __post_init__(self):
        if self.budget_mb <= 0:
            raise ValueError("budget_mb must be positive")
        if not 0.0 < self.recover_frac < self.elevated_frac:
            raise ValueError(
                "recover_frac must be in (0, elevated_frac) — the "
                "hysteresis band"
            )
        if not self.elevated_frac <= self.critical_frac:
            raise ValueError("critical_frac must be >= elevated_frac")
        if self.min_interval_s < 0 or self.cooldown_s < 0:
            raise ValueError("intervals must be >= 0")
        if self.journal_len <= 0:
            raise ValueError("journal_len must be positive")


def read_rss_bytes() -> Optional[int]:
    """Process VmRSS from /proc/self/status; None where unavailable."""
    try:
        with open("/proc/self/status", "r", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


class ResourceGovernor:
    """Clock-injected, thread-free pressure controller over the
    accountant's meters. Drive it with `tick()` from whatever cadence
    the host already has (the service's status polls, the sim's
    evaluation grid) — there is no background thread."""

    def __init__(
        self,
        accountant: ResourceAccountant,
        config: Optional[ResourceGovConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        ladder: Tuple[ShedRung, ...] = SHED_LADDER,
    ):
        self.accountant = accountant
        self.config = config or ResourceGovConfig()
        self.clock = clock
        self.ladder = tuple(ladder)
        self._mu = threading.Lock()
        self.level = LEVEL_OK
        self._level_since: Optional[float] = None
        self._last_tick: Optional[float] = None
        self._last_total_bytes = 0.0
        self._rung_last_fired: Dict[str, float] = {}
        # Structures shed through a rung whose meter has a restore hook:
        # walked back one bounded step per ok-tick until done.
        self._restore_pending: List[str] = []
        self._journal: deque = deque(maxlen=self.config.journal_len)
        self.stats_counters = {
            "ticks": 0,
            "sheds": 0,
            "entries_shed": 0,
            "restore_steps": 0,
            "transitions": 0,
        }

    # -- signals -----------------------------------------------------------

    @property
    def budget_bytes(self) -> float:
        return self.config.budget_mb * 1024.0 * 1024.0

    def pressure(self) -> float:
        """Accounted-bytes / budget from the LAST tick — O(1), the
        SignalAssembler's memory_pressure source (a signal read must not
        re-poll every meter)."""
        with self._mu:
            return self._last_total_bytes / max(self.budget_bytes, 1.0)

    # -- the control loop --------------------------------------------------

    def _level_for(self, pressure: float) -> str:
        """Target level under hysteresis. Escalation uses the elevated/
        critical thresholds; de-escalation only happens below
        recover_frac (between recover and elevated the CURRENT level
        holds — the band that stops boundary flapping)."""
        if pressure >= self.config.critical_frac:
            return LEVEL_CRITICAL
        if pressure >= self.config.elevated_frac:
            return LEVEL_ELEVATED
        if pressure < self.config.recover_frac:
            return LEVEL_OK
        return self.level if self.level != LEVEL_CRITICAL else LEVEL_ELEVATED

    def _transition(self, new_level: str, now: float, pressure: float) -> None:
        old = self.level
        self.level = new_level
        self._level_since = now
        self.stats_counters["transitions"] += 1
        metrics.count_pressure_transition(new_level)
        self._journal.append(
            (round(now, 3), "level", f"{old}->{new_level}", 0,
             round(pressure, 4))
        )
        log = logger.info if new_level == LEVEL_OK else logger.warning
        log("memory pressure %s -> %s (%.0f%% of %.0f MB budget)",
            old, new_level, pressure * 100.0, self.config.budget_mb)

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """One evaluation: measure, transition, actuate at most one
        ladder pass. Returns the actuation summary when anything
        happened, else None (the caller's journal-free healthy path)."""
        if now is None:
            now = self.clock()
        if (
            self._last_tick is not None
            and now - self._last_tick < self.config.min_interval_s
        ):
            return None
        self._last_tick = now
        self.stats_counters["ticks"] += 1

        snap = self.accountant.snapshot(publish=True)
        total = sum(d["bytes"] for d in snap.values())
        with self._mu:
            self._last_total_bytes = total
        pressure = total / max(self.budget_bytes, 1.0)

        target = self._level_for(pressure)
        acted: List[dict] = []
        if target != self.level:
            self._transition(target, now, pressure)
            acted.append({"transition": target})

        if self.level == LEVEL_OK:
            restored = self._restore_tick(now, pressure)
            if restored:
                acted.append(restored)
            return {"pressure": round(pressure, 4), "actions": acted} \
                if acted else None

        # Elevated or critical: walk the ladder in priority order. One
        # rung per elevated tick; at critical keep walking until the
        # projection clears the budget or the ladder is exhausted —
        # every rung still honors its own cooldown.
        budget = self.budget_bytes
        for rung in self.ladder:
            if rung.critical_only and self.level != LEVEL_CRITICAL:
                continue
            last = self._rung_last_fired.get(rung.structure)
            if last is not None and now - last < self.config.cooldown_s:
                continue
            before = snap.get(rung.structure, {"entries": 0, "bytes": 0.0})
            if before["entries"] <= 0:
                continue
            dropped = self.accountant.shed(rung.structure, rung.fraction)
            if dropped <= 0:
                continue
            self._rung_last_fired[rung.structure] = now
            meter = self.accountant.get(rung.structure)
            after = meter.read() if meter is not None else before
            freed = max(before["bytes"] - after["bytes"], 0.0)
            total -= freed
            self.stats_counters["sheds"] += 1
            self.stats_counters["entries_shed"] += dropped
            if (
                meter is not None
                and meter.restore is not None
                and rung.structure not in self._restore_pending
            ):
                self._restore_pending.append(rung.structure)
            self._journal.append(
                (round(now, 3), "shed", rung.structure, dropped,
                 round(pressure, 4))
            )
            logger.warning(
                "shed %s: dropped %d entr%s (%.1f KB freed) at %s "
                "pressure %.0f%%",
                rung.structure, dropped, "y" if dropped == 1 else "ies",
                freed / 1024.0, self.level, pressure * 100.0,
            )
            acted.append({
                "shed": rung.structure,
                "dropped": dropped,
                "freed_bytes": int(freed),
            })
            if self.level != LEVEL_CRITICAL or total <= budget:
                break
        with self._mu:
            self._last_total_bytes = max(total, 0.0)
        return {"pressure": round(pressure, 4), "actions": acted} \
            if acted else None

    def _restore_tick(self, now: float, pressure: float) -> Optional[dict]:
        """One bounded restore step per ok-tick, LAST-shed structure
        first (the index walks home before anything else re-inflates
        under it) — the hysteresis mirror of the shed ladder."""
        while self._restore_pending:
            structure = self._restore_pending[-1]
            more = self.accountant.restore_step(structure)
            self.stats_counters["restore_steps"] += 1
            self._journal.append(
                (round(now, 3), "restore", structure, 0,
                 round(pressure, 4))
            )
            if not more:
                self._restore_pending.pop()
                continue
            return {"restore": structure}
        return None

    # -- autopilot integration ---------------------------------------------

    def register_knobs(self, registry) -> None:
        """Publish the byte budget to the autopilot (the one governor
        surface the SLO loop may trade against: burning hit-rate SLO
        with memory to spare, the controller can raise the budget;
        never below half nor above 4x the operator's configured value)."""
        from llm_d_kv_cache_manager_tpu_torch.autopilot.knobs import (
            KNOB_RESOURCEGOV_BUDGET,
            KnobSpec,
        )

        cfg = self.config
        registry.register(
            KnobSpec(
                name=KNOB_RESOURCEGOV_BUDGET,
                floor=cfg.budget_mb / 2.0,
                ceiling=cfg.budget_mb * 4.0,
                max_step=max(cfg.budget_mb / 8.0, 1.0),
                description=(
                    "resource governor accounted-bytes budget (MB)"
                ),
            ),
            get=lambda: cfg.budget_mb,
            set_=lambda v: setattr(cfg, "budget_mb", float(v)),
        )

    # -- introspection -----------------------------------------------------

    def journal(self) -> List[tuple]:
        return list(self._journal)

    def status(self) -> dict:
        """The status document (the reference service's `resource`
        section): meters,
        level, pressure, journal. Polling it never actuates (status is
        a read; `tick` is the write path)."""
        snap = self.accountant.snapshot()
        total = sum(d["bytes"] for d in snap.values())
        pressure = total / max(self.budget_bytes, 1.0)
        out = {
            "level": self.level,
            "budget_mb": round(self.config.budget_mb, 3),
            "accounted_bytes": int(total),
            "pressure": round(pressure, 4),
            "thresholds": {
                "elevated_frac": self.config.elevated_frac,
                "critical_frac": self.config.critical_frac,
                "recover_frac": self.config.recover_frac,
            },
            "meters": {
                name: {
                    "entries": doc["entries"],
                    "bytes": int(doc["bytes"]),
                }
                for name, doc in sorted(snap.items())
            },
            "ladder": [
                {
                    "structure": rung.structure,
                    "fraction": rung.fraction,
                    "critical_only": rung.critical_only,
                }
                for rung in self.ladder
            ],
            "restore_pending": list(self._restore_pending),
            "journal": [list(entry) for entry in self._journal],
            "stats": dict(self.stats_counters),
        }
        if self.config.rss_probe:
            rss = read_rss_bytes()
            out["rss_bytes"] = rss
            if rss:
                out["accounted_of_rss"] = round(total / rss, 4)
        return out
