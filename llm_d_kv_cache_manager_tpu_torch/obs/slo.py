"""SLO plane: declarative objectives + multi-window burn-rate monitoring.

Copy of the monitor part of the reference package's `obs/slo.py`: the
window, objective and status names, `SLOConfig`, `SLOObjective` and
`SLOMonitor`, with the objectives' `counts_fn`s and the clock injected by
the caller (the autopilot, a fleet replay, tests). The shipped objective
set reads the Prometheus registry, and the burn-rate gauges are written to
it; both wait for the port's metrics collector (ROADMAP.md queue 1 item 7):
`default_objectives` raises until then, and `evaluate` writes no gauge.

- **Objectives are declarative.** Each `SLOObjective` names a budget (the
  allowed fraction of bad events) and a reader that returns cumulative
  ``(bad, total)`` counts. The reference's shipped set is
  ``read_latency_p99``, ``hit_rate`` and ``shed_rate``; their names are
  kept here so the rules and documents speak the same vocabulary.
- **Burn rates are windowed, fast + slow.** Counters are cumulative, so
  the monitor keeps a bounded ring of (time, counts) samples — one per
  evaluation — and differences against the sample at the window's far
  edge. ``burn = bad_fraction / budget``: burn 1.0 spends the budget
  exactly at the objective's rate; the alert threshold fires well above
  it. An objective is ``breaching`` when BOTH windows burn past
  ``burn_threshold`` (fast-only is ``warning``): the slow window keeps a
  brief spike from paging anyone, the fast window ends the alert quickly
  once the fix lands. Windows clip to the monitor's lifetime, so a young
  monitor alerts on its whole history rather than staying silent for an
  hour.

No background thread: evaluation is pull-based from whatever cadence the
caller owns (a replay's fake clock, tests with an injected clock).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


# Fixed label vocabularies (metric label values come from these tuples
# and nowhere else).
WINDOW_FAST = "fast"
WINDOW_SLOW = "slow"
SLO_WINDOWS = (WINDOW_FAST, WINDOW_SLOW)

OBJECTIVE_READ_LATENCY = "read_latency_p99"
OBJECTIVE_HIT_RATE = "hit_rate"
OBJECTIVE_SHED_RATE = "shed_rate"
SLO_OBJECTIVES = (
    OBJECTIVE_READ_LATENCY, OBJECTIVE_HIT_RATE, OBJECTIVE_SHED_RATE,
)

STATUS_NO_DATA = "no_data"
STATUS_OK = "ok"
STATUS_WARNING = "warning"
STATUS_BREACHING = "breaching"
SLO_STATES = (STATUS_NO_DATA, STATUS_OK, STATUS_WARNING, STATUS_BREACHING)


@dataclass
class SLOConfig:
    """Env mapping (api/http_service.py): SLO, SLO_FAST_WINDOW_S,
    SLO_SLOW_WINDOW_S, SLO_BURN_THRESHOLD, SLO_READ_P99_MS,
    SLO_READ_BUDGET, SLO_HIT_RATE_FLOOR, SLO_SHED_RATE_CEILING."""

    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    # Both windows must burn past this to breach. 1.0 = budget spent
    # exactly at the objective rate; the default pages at 2x.
    burn_threshold: float = 2.0
    # read_latency_p99: requests slower than this are budget spend; the
    # budget is the allowed slow fraction (0.01 → a p99 objective).
    read_p99_ms: float = 5.0
    read_latency_budget: float = 0.01
    # hit_rate: at least this fraction of lookups must find SOME cached
    # block (budget = 1 - floor).
    hit_rate_floor: float = 0.5
    # shed_rate: at most this fraction of arriving requests may be shed.
    shed_rate_ceiling: float = 0.01
    # Sample-ring bound (one sample per evaluation; pruned past the slow
    # window anyway — this is the hard cap for fast pollers).
    max_samples: int = 512

    def __post_init__(self):
        if not (0 < self.fast_window_s < self.slow_window_s):
            raise ValueError("need 0 < fast_window_s < slow_window_s")
        if self.burn_threshold <= 0:
            raise ValueError("burn_threshold must be positive")
        for name in ("read_latency_budget", "shed_rate_ceiling"):
            if not (0 < getattr(self, name) <= 1):
                raise ValueError(f"{name} must be in (0, 1]")
        if not (0 <= self.hit_rate_floor < 1):
            raise ValueError("hit_rate_floor must be in [0, 1)")


@dataclass
class SLOObjective:
    """One objective: a budget plus a cumulative (bad, total) reader."""

    name: str
    description: str
    budget: float  # allowed bad fraction of total events
    counts_fn: Callable[[], Tuple[float, float]]
    detail: dict = field(default_factory=dict)


def default_objectives(config: SLOConfig) -> List[SLOObjective]:
    """The reference's shipped objective set reads the live Prometheus
    registry (stage latency histogram, max-pod-hit histogram, shed and
    lookup counters); the port has no metrics collector yet."""
    raise NotImplementedError(
        "default_objectives reads the metrics collector, which the port "
        "still owes (ROADMAP.md queue 1 item 7); pass SLOObjective "
        "readers to SLOMonitor instead"
    )


class SLOMonitor:
    """Bounded sample ring + multi-window burn evaluation over it."""

    def __init__(
        self,
        objectives: Sequence[SLOObjective],
        config: Optional[SLOConfig] = None,
        clock=time.monotonic,
    ):
        self.config = config or SLOConfig()
        self.objectives = list(objectives)
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        self.clock = clock
        self._mu = threading.Lock()
        # (t, {objective: (bad, total)}) — newest right.
        self._samples: deque = deque()
        self.evaluations = 0
        # Baseline sample at construction: deltas never include budget
        # spent before this monitor existed (counters are process-global
        # and may predate it).
        self.sample()

    # -- sampling ----------------------------------------------------------

    def _read(self) -> Dict[str, Tuple[float, float]]:
        out = {}
        for obj in self.objectives:
            try:
                bad, total = obj.counts_fn()
            except Exception:  # noqa: BLE001 - a reader must never fail /readyz
                bad, total = 0.0, 0.0
            out[obj.name] = (float(bad), float(total))
        return out

    def sample(self, now: Optional[float] = None) -> None:
        """Record one (time, counts) sample; prunes past the slow window
        (keeping one older sample as the far-edge baseline) and bounds
        the ring for fast pollers."""
        if now is None:
            now = self.clock()
        counts = self._read()
        with self._mu:
            samples = self._samples
            if samples and samples[-1][0] >= now:
                samples[-1] = (now, counts)  # non-advancing clock: replace
            else:
                samples.append((now, counts))
            horizon = now - self.config.slow_window_s
            while len(samples) > 2 and samples[1][0] <= horizon:
                samples.popleft()
            while len(samples) > self.config.max_samples:
                # Thin the middle, never the endpoints (the oldest sample
                # is the slow window's baseline, the newest is "now").
                del samples[len(samples) // 2]

    # -- evaluation --------------------------------------------------------

    @staticmethod
    def _baseline(samples, horizon):
        """Latest sample at or before `horizon`, else the oldest (windows
        clip to the monitor's lifetime)."""
        base = samples[0]
        for item in samples:
            if item[0] <= horizon:
                base = item
            else:
                break
        return base

    def evaluate(self, now: Optional[float] = None) -> dict:
        """Take a sample, compute per-objective per-window burn rates and
        return the status document (the reference's /slo/status)."""
        if now is None:
            now = self.clock()
        self.sample(now)
        with self._mu:
            samples = list(self._samples)
            self.evaluations += 1
        latest_t, latest = samples[-1]
        windows = {
            WINDOW_FAST: self.config.fast_window_s,
            WINDOW_SLOW: self.config.slow_window_s,
        }
        objectives_doc = {}
        breaching = []
        for obj in self.objectives:
            bad_now, total_now = latest[obj.name]
            window_docs = {}
            burns = {}
            saw_data = False
            for wname, wlen in windows.items():
                base_t, base = self._baseline(samples, latest_t - wlen)
                bad_0, total_0 = base.get(obj.name, (0.0, 0.0))
                d_bad = max(0.0, bad_now - bad_0)
                d_total = max(0.0, total_now - total_0)
                if d_total > 0:
                    saw_data = True
                    bad_frac = min(1.0, d_bad / d_total)
                else:
                    bad_frac = 0.0
                burn = bad_frac / obj.budget
                burns[wname] = burn
                # The reference also sets the kvcache_slo_burn_rate gauge
                # here; it comes with the metrics collector (ROADMAP.md
                # queue 1 item 7).
                window_docs[wname] = {
                    "window_s": wlen,
                    "effective_window_s": round(latest_t - base_t, 3),
                    "bad": d_bad,
                    "total": d_total,
                    "bad_fraction": round(bad_frac, 6),
                    "burn_rate": round(burn, 4),
                }
            if not saw_data:
                status = STATUS_NO_DATA
            elif (
                burns[WINDOW_FAST] > self.config.burn_threshold
                and burns[WINDOW_SLOW] > self.config.burn_threshold
            ):
                status = STATUS_BREACHING
                breaching.append(obj.name)
            elif burns[WINDOW_FAST] > self.config.burn_threshold:
                status = STATUS_WARNING
            else:
                status = STATUS_OK
            objectives_doc[obj.name] = {
                "description": obj.description,
                "budget": obj.budget,
                "detail": dict(obj.detail),
                "windows": window_docs,
                "status": status,
            }
        return {
            "status": STATUS_BREACHING if breaching else STATUS_OK,
            "breaching": breaching,
            "burn_threshold": self.config.burn_threshold,
            "objectives": objectives_doc,
            "samples_retained": len(samples),
            "evaluations": self.evaluations,
        }

    def burn_history(
        self, objective: str, window: str
    ) -> List[Tuple[float, float]]:
        """Windowed burn-rate series over the retained sample ring,
        through a public seam: [(sample_time, burn_rate)], oldest first,
        one point per retained sample, each computed over the named
        window ending AT that sample (clipped to the monitor's lifetime
        exactly as evaluate() clips). Bounded by the ring
        (``max_samples``); callers — the autopilot's journal, tests —
        never touch the private ring or re-derive the burn math."""
        if window not in SLO_WINDOWS:
            raise ValueError(f"unknown window {window!r} (not in SLO_WINDOWS)")
        obj = next((o for o in self.objectives if o.name == objective), None)
        if obj is None:
            raise ValueError(
                f"unknown objective {objective!r} (have "
                f"{[o.name for o in self.objectives]})"
            )
        wlen = (
            self.config.fast_window_s if window == WINDOW_FAST
            else self.config.slow_window_s
        )
        with self._mu:
            samples = list(self._samples)
        out: List[Tuple[float, float]] = []
        for i, (t, counts) in enumerate(samples):
            base_t, base = self._baseline(samples[: i + 1], t - wlen)
            bad_now, total_now = counts.get(obj.name, (0.0, 0.0))
            bad_0, total_0 = base.get(obj.name, (0.0, 0.0))
            d_bad = max(0.0, bad_now - bad_0)
            d_total = max(0.0, total_now - total_0)
            bad_frac = min(1.0, d_bad / d_total) if d_total > 0 else 0.0
            out.append((t, bad_frac / obj.budget))
        return out
