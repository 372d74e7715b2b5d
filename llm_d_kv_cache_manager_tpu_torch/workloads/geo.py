"""Geo-distributed ShareGPT-shaped workload: home-pinned sessions under
diurnal skew.

The federation bench's scenario (ROADMAP "Hierarchical federation"):
millions of users span regions, every session lives in exactly one home
region (its user does not move mid-conversation), and *when* each region
is busy follows the sun — traffic peaks walk around the planet with a
phase offset per region. This generator produces that shape,
deterministically:

- every region gets `prefixes_per_region` shared system prompts (the
  regional tenants/products whose prefixes are the thing worth routing
  on); a session's prefix is drawn from its HOME region's set, so prefix
  affinity is a regional property by construction — exactly the signal
  the global tier's popularity sketches can see and a flat global fleet
  cannot exploit;
- session home regions are drawn from per-region **diurnal weights**
  evaluated at the session's start time: region r's weight is
  ``1 + amplitude * sin(2π * (t/day_period - r/R))``, so each region's
  sessions cluster in its own peak window (a compressed day —
  `day_period_s` of sim time — keeps the bench finite);
- turn counts and user/output lengths come from the same committed
  ShareGPT tables as every other generator; arrivals are open-loop with
  per-session think time.

Home pins are recorded per session in the trace (`session_regions`; the
JSONL `region` field on session records, workloads.trace) and surface on
every `MaterializedRequest.region` — so region identity survives the
record/replay round trip, and a pre-geo trace replays unchanged with
`region=None` everywhere. Losing a region mid-replay is a REPLAY-time
event (the bench kills the region's fleet at `--geo`'s loss time); the
trace itself is loss-free so one recording serves both the lossy and
loss-free arms.
"""

from __future__ import annotations

import dataclasses
import math
import random
from dataclasses import dataclass
from typing import List, Optional

from llm_d_kv_cache_manager_tpu_torch.workloads import stats, tables
from llm_d_kv_cache_manager_tpu_torch.workloads.arrivals import (
    arrival_process,
    think_time_s,
)
from llm_d_kv_cache_manager_tpu_torch.workloads.spec import TraceTurn, WorkloadTrace
from llm_d_kv_cache_manager_tpu_torch.workloads.synthetic import text as _text


@dataclass(frozen=True)
class GeoConfig:
    """Knobs of the geo generator (recorded in the trace header)."""

    n_regions: int = 3
    n_sessions: int = 120
    seed: int = 42
    # Diurnal model: one compressed "day" of `day_period_s` sim seconds;
    # region r's arrival weight peaks 1/R of a day after region r-1's.
    # amplitude=0 is the uniform control (no skew); 1.0 means a region's
    # trough receives (almost) no new sessions.
    day_period_s: float = 120.0
    diurnal_amplitude: float = 0.8
    # Session-start arrival process (global, before the region draw).
    arrival: str = "poisson"
    session_rate_per_s: float = 2.0
    burst_on_s: float = 10.0
    burst_off_s: float = 20.0
    think_time_mean_s: float = 4.0
    read_s_per_unit: float = 0.005
    # Regional shared prefixes: how many per region, and their length.
    # Fixed words (like the placement bench) so cross-arm dynamics measure
    # the GEOGRAPHY, not the prefix-length lottery; None draws from the
    # committed prefix-length table.
    prefixes_per_region: int = 2
    prefix_words: Optional[int] = 600
    prefix_length_scale: float = 1.0
    length_scale: float = 1.0
    # Turn cap (the pmf's marathon tail would let one session dominate).
    max_turns: Optional[int] = 5

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def region_name(r: int) -> str:
    return f"region-{r}"


def diurnal_weights(
    t: float, n_regions: int, day_period_s: float, amplitude: float
) -> List[float]:
    """Normalized per-region arrival weights at time `t`."""
    raw = [
        max(
            1.0 + amplitude * math.sin(
                2.0 * math.pi * (t / day_period_s - r / n_regions)
            ),
            0.0,
        )
        for r in range(n_regions)
    ]
    total = sum(raw)
    if total <= 0:  # amplitude > 1 could zero every region at some t
        return [1.0 / n_regions] * n_regions
    return [w / total for w in raw]


def generate(config: Optional[GeoConfig] = None) -> WorkloadTrace:
    """Build the geo trace. Deterministic in (config, seed)."""
    cfg = config or GeoConfig()
    if cfg.n_regions <= 0:
        raise ValueError("n_regions must be >= 1")
    if cfg.diurnal_amplitude < 0:
        raise ValueError("diurnal_amplitude must be >= 0")
    if cfg.day_period_s <= 0:
        raise ValueError("day_period_s must be > 0")
    rng = random.Random(cfg.seed)

    # Regional prefix pools first, in (region, slot) order (fixed draw
    # order — same discipline as the multi-tenant generator).
    prefixes: List[List[str]] = []
    for r in range(cfg.n_regions):
        pool = []
        for p in range(cfg.prefixes_per_region):
            n = cfg.prefix_words
            if n is None:
                n = stats.sample_length(
                    rng, tables.SYSTEM_PREFIX_LEN_QUANTILES,
                    cfg.prefix_length_scale,
                )
            pool.append(f"[{region_name(r)} tenant {p}] " + _text(rng, n))
        prefixes.append(pool)

    starts = arrival_process(
        cfg.arrival, rng, cfg.session_rate_per_s,
        on_s=cfg.burst_on_s, off_s=cfg.burst_off_s,
    )

    sessions = {}
    session_regions = {}
    turns = []
    for s in range(cfg.n_sessions):
        start = next(starts)
        weights = diurnal_weights(
            start, cfg.n_regions, cfg.day_period_s, cfg.diurnal_amplitude
        )
        u = rng.random()
        acc = 0.0
        region = cfg.n_regions - 1
        for r, w in enumerate(weights):
            acc += w
            if u <= acc:
                region = r
                break
        session_id = f"s{s}"
        sessions[session_id] = rng.choice(prefixes[region])
        session_regions[session_id] = region_name(region)
        n_turns = stats.sample_pmf(rng, tables.TURNS_PER_SESSION_PMF)
        if cfg.max_turns is not None:
            n_turns = min(n_turns, cfg.max_turns)
        arrival = start
        for t in range(n_turns):
            user_len = stats.sample_length(
                rng, tables.USER_LEN_QUANTILES, cfg.length_scale
            )
            output_len = stats.sample_length(
                rng, tables.OUTPUT_LEN_QUANTILES, cfg.length_scale
            )
            turns.append(TraceTurn(
                arrival_s=round(arrival, 6),
                session=session_id,
                turn=t,
                user_len=user_len,
                output_len=output_len,
                user_text=_text(rng, user_len),
                response_text=_text(rng, output_len),
            ))
            arrival += think_time_s(
                rng, cfg.think_time_mean_s, output_len, cfg.read_s_per_unit
            )

    turns.sort(key=lambda t: (t.arrival_s, t.session, t.turn))
    return WorkloadTrace(
        workload="geo-sharegpt",
        seed=cfg.seed,
        config=cfg.as_dict(),
        tables_version=tables.TABLES_VERSION,
        sessions=sessions,
        turns=turns,
        session_regions=session_regions,
    )
