"""Deterministic ShareGPT-shaped multi-turn session generator.

Produces a `WorkloadTrace` whose empirical distributions match the
committed ShareGPT tables (workloads.tables): per-turn user prompt
lengths, assistant output lengths, turns-per-conversation, and the
shared-system-prefix mix. The mechanism that actually creates prefix-cache
hits — each conversation's prompt growing by concatenating its prior
turns — lives in `WorkloadTrace.materialize()` (workloads.spec), so the
sim bench and the device harness serve byte-identical prompt streams from
the same trace.

Everything is a pure function of (config, seed): a single
`random.Random(seed)` drives every draw in a fixed order, so two
generations with equal configs are equal traces — the determinism the
record/replay contract (workloads.trace) is built on.

Arrivals are OPEN-LOOP (workloads.arrivals): session starts follow a
Poisson or bursty ON-OFF process; a session's later turns follow its
previous turn after an exponential per-session think time plus a
read-time term proportional to the previous response's length. Arrival
times never depend on measured service times — the bench's queue is
allowed to actually build.
"""

from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass
from typing import Optional

from llm_d_kv_cache_manager_tpu_torch.workloads import stats, tables
from llm_d_kv_cache_manager_tpu_torch.workloads.arrivals import (
    arrival_process,
    think_time_s,
)
from llm_d_kv_cache_manager_tpu_torch.workloads.spec import TraceTurn, WorkloadTrace
from llm_d_kv_cache_manager_tpu_torch.workloads.synthetic import text as _text


@dataclass(frozen=True)
class ShareGPTConfig:
    """Knobs of the generator; the whole dataclass is recorded in the
    trace header (provenance) and round-trips through JSONL."""

    n_sessions: int = 48
    seed: int = 42
    # Session-start arrival process ("poisson" | "bursty") and rate.
    arrival: str = "poisson"
    session_rate_per_s: float = 1.5
    burst_on_s: float = 10.0
    burst_off_s: float = 20.0
    # Per-session think time between turns.
    think_time_mean_s: float = 6.0
    read_s_per_unit: float = 0.01
    # Shared-system-prefix mix (tables.SYSTEM_PREFIX_SHARE by default).
    system_prefix_share: float = tables.SYSTEM_PREFIX_SHARE
    prefix_groups: int = 8
    # Optional truncations for bounded bench runs; None = table-faithful.
    max_turns: Optional[int] = None
    # Scales every sampled length (smoke/CI configs shrink the workload
    # without changing its shape); 1.0 = table-faithful.
    length_scale: float = 1.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def generate(config: Optional[ShareGPTConfig] = None) -> WorkloadTrace:
    """Build the trace: sessions, scripted responses, open-loop arrivals."""
    cfg = config or ShareGPTConfig()
    if not 0.0 <= cfg.system_prefix_share <= 1.0:
        raise ValueError(
            f"system_prefix_share must be in [0,1], got {cfg.system_prefix_share}"
        )
    if cfg.prefix_groups <= 0 and cfg.system_prefix_share > 0:
        raise ValueError("prefix_groups must be >= 1 when prefixes are on")
    rng = random.Random(cfg.seed)

    # Group prefixes first (fixed draw order = determinism): each group's
    # shared system prompt, length from the committed prefix table.
    group_prefixes = []
    for g in range(cfg.prefix_groups if cfg.system_prefix_share > 0 else 0):
        n = stats.sample_length(
            rng, tables.SYSTEM_PREFIX_LEN_QUANTILES, cfg.length_scale
        )
        group_prefixes.append(f"[group {g}] " + _text(rng, n))

    starts = arrival_process(
        cfg.arrival, rng, cfg.session_rate_per_s,
        on_s=cfg.burst_on_s, off_s=cfg.burst_off_s,
    )

    sessions = {}
    turns = []
    for s in range(cfg.n_sessions):
        session_id = f"s{s}"
        start = next(starts)
        if group_prefixes and rng.random() < cfg.system_prefix_share:
            sessions[session_id] = group_prefixes[
                rng.randrange(len(group_prefixes))
            ]
        else:
            sessions[session_id] = ""
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

    # Arrival order with a total, deterministic tie-break.
    turns.sort(key=lambda t: (t.arrival_s, t.session, t.turn))
    return WorkloadTrace(
        workload="sharegpt",
        seed=cfg.seed,
        config=cfg.as_dict(),
        tables_version=tables.TABLES_VERSION,
        sessions=sessions,
        turns=turns,
    )


def uniform_control(config: Optional[ShareGPTConfig] = None) -> WorkloadTrace:
    """Single-turn, prefix-free control at the same lengths/arrivals: the
    workload with the multi-turn growth (and shared prefixes) removed.
    Comparing a bench's hit rate on `generate()` vs this control isolates
    what prefix reuse — the thing the index exists for — is worth."""
    cfg = config or ShareGPTConfig()
    cfg = dataclasses.replace(cfg, system_prefix_share=0.0, max_turns=1)
    trace = generate(cfg)
    return dataclasses.replace(trace, workload="sharegpt-uniform-control")
