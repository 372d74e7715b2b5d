"""SLO plane: declarative objectives + multi-window burn-rate monitoring.

A control plane serving millions of users cannot wait for the bench to
notice it is degrading: it needs to know, from its own live metrics,
whether it is spending its error budget faster than the objective allows
— *before* the budget is gone. This module is the classic multi-window
burn-rate design (Google SRE workbook) sized to this repo:

- **Objectives are declarative.** Each `SLOObjective` names a budget (the
  allowed fraction of bad events) and a reader that returns cumulative
  ``(bad, total)`` counts from the REAL Prometheus registry — no parallel
  bookkeeping that can drift from what operators scrape. The shipped set:

  * ``read_latency_p99`` — read-path requests slower than
    ``read_p99_ms``, from ``kvcache_stage_latency_seconds{plane="read",
    stage="get_pod_scores"}`` bucket counts (strided observation: sampled
    but unbiased; the threshold snaps to the nearest bucket boundary at
    or above the configured value).
  * ``hit_rate`` — lookups that found NO cached block, from the
    ``kvcache_index_max_pod_hit_count`` histogram's ``le="0"`` bucket.
    Budget = 1 − ``hit_rate_floor``.
  * ``shed_rate`` — requests explicitly shed at the serving surface
    (``kvcache_admission_shed_total``) against sheds + served lookups.
    Budget = ``shed_rate_ceiling``.

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

- **Surfaces.** ``GET /slo/status`` (api/http_service.py), a ``slo``
  section in ``/readyz`` (never gates readiness — an SLO breach is an
  alert, not a liveness failure), and
  ``kvcache_slo_burn_rate{objective,window}`` gauges whose label values
  are pinned to the fixed vocabularies below
  (tests/test_metrics_hygiene.py).

No background thread: evaluation is pull-based from whatever cadence the
caller owns (scrapes, /readyz probes, tests with an injected clock).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics

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


def _histogram_le_counts(hist, threshold_s: float, label_match: dict):
    """(bad, total, effective_le) from one labeled histogram child:
    total = _count, bad = total - cumulative count of the smallest bucket
    at or above `threshold_s`."""
    if hist is None:
        return 0.0, 0.0, None
    total = 0.0
    buckets: Dict[float, float] = {}
    for metric in hist.collect():
        for s in metric.samples:
            labels = s.labels
            if any(labels.get(k) != v for k, v in label_match.items()):
                continue
            if s.name.endswith("_count"):
                total += s.value
            elif s.name.endswith("_bucket"):
                le = labels.get("le")
                if le is not None:
                    bound = float(le)
                    buckets[bound] = buckets.get(bound, 0.0) + s.value
    if not buckets:
        return 0.0, total, None
    effective = min(
        (b for b in buckets if b >= threshold_s), default=float("inf")
    )
    good = buckets.get(effective, total)
    return max(0.0, total - good), total, (
        effective if effective != float("inf") else None
    )


def default_objectives(config: SLOConfig) -> List[SLOObjective]:
    """The shipped objective set, reading the live registry."""
    threshold_s = config.read_p99_ms / 1e3

    def read_latency_counts():
        bad, total, _ = _histogram_le_counts(
            metrics.stage_latency, threshold_s,
            {"plane": "read", "stage": "get_pod_scores"},
        )
        return bad, total

    def hit_rate_counts():
        # Bad = lookups whose max consecutive hit count was 0 — the
        # le=0 bucket's cumulative count, NOT the latency-style
        # "above threshold" complement.
        hist = metrics.index_max_pod_hits
        if hist is None:
            return 0.0, 0.0
        total = zero = 0.0
        for metric in hist.collect():
            for s in metric.samples:
                if s.name.endswith("_count"):
                    total += s.value
                elif s.name.endswith("_bucket"):
                    le = s.labels.get("le")
                    if le is not None and float(le) == 0.0:
                        zero += s.value
        return zero, total

    def shed_rate_counts():
        shed = metrics.counter_value(metrics.admission_shed)
        served = metrics.counter_value(metrics.index_lookup_requests)
        return shed, shed + served

    return [
        SLOObjective(
            name=OBJECTIVE_READ_LATENCY,
            description=(
                "fraction of read-path scoring requests slower than the "
                "latency threshold (strided histogram sample)"
            ),
            budget=config.read_latency_budget,
            counts_fn=read_latency_counts,
            detail={"threshold_ms": config.read_p99_ms},
        ),
        SLOObjective(
            name=OBJECTIVE_HIT_RATE,
            description=(
                "fraction of index lookups finding no cached block "
                "(floor objective on the fleet's cache usefulness)"
            ),
            budget=max(1e-9, 1.0 - config.hit_rate_floor),
            counts_fn=hit_rate_counts,
            detail={"floor": config.hit_rate_floor},
        ),
        SLOObjective(
            name=OBJECTIVE_SHED_RATE,
            description=(
                "fraction of arriving requests explicitly shed at the "
                "serving surface (429 / RESOURCE_EXHAUSTED)"
            ),
            budget=config.shed_rate_ceiling,
            counts_fn=shed_rate_counts,
            detail={"ceiling": config.shed_rate_ceiling},
        ),
    ]


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
        """Take a sample, compute per-objective per-window burn rates,
        update the `kvcache_slo_burn_rate` gauges, and return the status
        document (/slo/status)."""
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
                metrics.set_slo_burn_rate(obj.name, wname, burn)
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
