"""Multi-tenant ShareGPT-shaped workload: T tenants, Zipf popularity.

The placement bench's scenario (ROADMAP "Hot-prefix replication and
predictive placement"): thousands of tenants share a fleet, each with its
own system prefix, and tenant popularity is heavy-tailed — a handful of hot
tenants carry most of the traffic. Precise prefix routing concentrates each
tenant on the pod that happens to hold its prefix; under a Zipf mix that
turns the hot tenants' pods into hotspots while the rest of the fleet
idles. This generator produces exactly that shape, deterministically:

- every tenant `t` gets a system prefix sampled from the committed
  ShareGPT prefix-length table, and a stable **LoRA keyspace id** (`t`
  itself) so per-tenant cache isolation rides the real extra-key machinery
  in `hashing.py`, not just distinct prefix text;
- sessions draw their tenant from a Zipf(s) distribution (`zipf_s=0` is
  the uniform control mix — the "no hotspot" yardstick the placement bench
  measures retention against);
- turn counts and user/output lengths come from the same committed
  ShareGPT tables as the single-tenant generator, arrivals are open-loop.

Session ids encode their tenant (``t<k>-s<n>``), so the tenant of any
materialized request — and hence its lora/keyspace id — is derivable from
the trace alone and survives the JSONL record/replay round trip unchanged.
"""

from __future__ import annotations

import dataclasses
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
class MultiTenantConfig:
    """Knobs of the multi-tenant generator (recorded in the trace header)."""

    n_tenants: int = 24
    n_sessions: int = 96
    seed: int = 42
    # Tenant-popularity skew: session tenants draw from P(k) ∝ 1/(k+1)^s.
    # 0.0 = uniform (the control mix); ~1.5+ = a pronounced hotspot where
    # the top tenant carries a large constant fraction of all sessions.
    zipf_s: float = 0.0
    # Session-start arrival process and per-session think time.
    arrival: str = "poisson"
    session_rate_per_s: float = 3.0
    burst_on_s: float = 10.0
    burst_off_s: float = 20.0
    think_time_mean_s: float = 4.0
    read_s_per_unit: float = 0.005
    # Per-tenant prefix length scale over the committed prefix table
    # (1.0 = table-faithful) and per-turn length scale.
    prefix_length_scale: float = 1.0
    # Fixed per-tenant prefix length in words; overrides the table draw
    # when set. The placement bench pins this so hotspot dynamics measure
    # the MIX, not the prefix-length lottery of whichever tenant the Zipf
    # head landed on.
    prefix_words: Optional[int] = None
    length_scale: float = 1.0
    # Turn cap (the pmf's marathon tail would let one session dominate).
    max_turns: Optional[int] = 6

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def tenant_weights(n_tenants: int, zipf_s: float) -> List[float]:
    """Normalized Zipf(s) popularity over tenants 0..n-1 (0 = hottest)."""
    raw = [1.0 / ((k + 1) ** zipf_s) for k in range(n_tenants)]
    total = sum(raw)
    return [w / total for w in raw]


def tenant_of(session_id: str) -> int:
    """Tenant index encoded in a session id (``t<k>-s<n>``)."""
    return int(session_id.split("-", 1)[0][1:])


def _draw(rng: random.Random, cum_weights: List[float]) -> int:
    u = rng.random()
    lo, hi = 0, len(cum_weights) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if u <= cum_weights[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo


def generate(config: Optional[MultiTenantConfig] = None) -> WorkloadTrace:
    """Build the multi-tenant trace. Deterministic in (config, seed)."""
    cfg = config or MultiTenantConfig()
    if cfg.n_tenants <= 0:
        raise ValueError("n_tenants must be >= 1")
    if cfg.zipf_s < 0:
        raise ValueError("zipf_s must be >= 0")
    rng = random.Random(cfg.seed)

    # Tenant prefixes first, in tenant order (fixed draw order).
    prefixes = []
    for t in range(cfg.n_tenants):
        n = cfg.prefix_words
        if n is None:
            n = stats.sample_length(
                rng, tables.SYSTEM_PREFIX_LEN_QUANTILES,
                cfg.prefix_length_scale,
            )
        prefixes.append(f"[tenant {t}] " + _text(rng, n))

    weights = tenant_weights(cfg.n_tenants, cfg.zipf_s)
    cum = []
    acc = 0.0
    for w in weights:
        acc += w
        cum.append(acc)
    cum[-1] = 1.0

    starts = arrival_process(
        cfg.arrival, rng, cfg.session_rate_per_s,
        on_s=cfg.burst_on_s, off_s=cfg.burst_off_s,
    )

    sessions = {}
    turns = []
    for s in range(cfg.n_sessions):
        tenant = _draw(rng, cum)
        session_id = f"t{tenant}-s{s}"
        start = next(starts)
        sessions[session_id] = prefixes[tenant]
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
        workload="multitenant-sharegpt",
        seed=cfg.seed,
        config=cfg.as_dict(),
        tables_version=tables.TABLES_VERSION,
        sessions=sessions,
        turns=turns,
    )
