"""Adversarial trace generators: the resource governor's stress diet.

Every other generator in this package models a workload the caches were
BUILT for — shared prefixes, returning sessions, stable fleets. These
three model the workloads that kill an ungoverned control plane, each
aimed at a different stateful structure:

- **Unique-prompt flood** (`generate_flood`): every request is a fresh
  single-turn session with a never-repeating prompt. Zero reuse means
  every byte the chain memo, prefix store, and index retain for it is
  pure waste — the structure-growth worst case the governor's byte
  budget exists to cap (and the arm where shedding costs no hits,
  because there were never going to be any).
- **Session explosion** (`generate_session_explosion`): a storm of
  short-lived sessions, far more than any session table's capacity,
  each abandoned after a turn or two. Per-session state (prediction
  records, popularity credit) grows with the number of sessions EVER
  seen unless something sheds the dead tail.
- **Churn storm** (`generate_churn_storm` + `churn_schedule`): a
  moderate, cache-friendly workload over a fleet whose pods join and
  leave continuously. The trace itself is ordinary on purpose — the
  adversary is the roster: per-pod rows (fleet health, load,
  anti-entropy trust, transfer breakers) must track the LIVE pods, not
  every pod that ever existed. The deterministic join/leave schedule is
  derived from the same config so bench arms replay it exactly.

Like every generator here, outputs are plain `WorkloadTrace`s — pure
functions of (config, seed), one `random.Random(seed)` in fixed draw
order, delta-text turns — so JSONL record/replay is bit-identical by
construction.
"""

from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.workloads import tables
from llm_d_kv_cache_manager_tpu_torch.workloads.arrivals import arrival_process
from llm_d_kv_cache_manager_tpu_torch.workloads.spec import TraceTurn, WorkloadTrace
from llm_d_kv_cache_manager_tpu_torch.workloads.synthetic import text as _text


@dataclass(frozen=True)
class FloodConfig:
    """Knobs of the unique-prompt flood (recorded in the trace header)."""

    n_requests: int = 400
    seed: int = 42
    arrival: str = "poisson"
    rate_per_s: float = 4.0
    burst_on_s: float = 10.0
    burst_off_s: float = 20.0
    # Every prompt is long enough to span many blocks — each request
    # plants a full chain of never-again-touched index entries.
    prompt_words: int = 600
    response_words: int = 60

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def generate_flood(config: Optional[FloodConfig] = None) -> WorkloadTrace:
    """Unique single-turn sessions; no two prompts share a prefix."""
    cfg = config or FloodConfig()
    if cfg.n_requests <= 0:
        raise ValueError("n_requests must be >= 1")
    rng = random.Random(cfg.seed)
    starts = arrival_process(
        cfg.arrival, rng, cfg.rate_per_s,
        on_s=cfg.burst_on_s, off_s=cfg.burst_off_s,
    )
    sessions = {}
    turns: List[TraceTurn] = []
    for k in range(cfg.n_requests):
        session_id = f"f{k}"
        # A per-request tag makes the very first block unique: no two
        # floods share even their opening words, so nothing — memo,
        # prefix store, index chain — is reusable across requests.
        sessions[session_id] = ""
        user = f"[flood {k}] " + _text(rng, cfg.prompt_words)
        resp = _text(rng, cfg.response_words)
        turns.append(TraceTurn(
            arrival_s=round(next(starts), 6),
            session=session_id,
            turn=0,
            user_len=len(user.split()),
            output_len=len(resp.split()),
            user_text=user,
            response_text=resp,
        ))
    turns.sort(key=lambda t: (t.arrival_s, t.session, t.turn))
    return WorkloadTrace(
        workload="adversarial_flood",
        seed=cfg.seed,
        config=cfg.as_dict(),
        tables_version=tables.TABLES_VERSION,
        sessions=sessions,
        turns=turns,
    )


@dataclass(frozen=True)
class SessionExplosionConfig:
    """Knobs of the session explosion (recorded in the trace header)."""

    n_sessions: int = 600
    seed: int = 42
    arrival: str = "bursty"
    rate_per_s: float = 6.0
    burst_on_s: float = 5.0
    burst_off_s: float = 10.0
    # A small shared preamble pool keeps SOME block reuse alive (this
    # storm attacks per-session state, not the block caches), while the
    # 1-2 turn lifetime guarantees almost every session is dead weight
    # the moment its last turn lands.
    n_prefixes: int = 4
    prefix_words: int = 200
    max_turns: int = 2
    think_time_mean_s: float = 2.0
    user_words: int = 40
    response_words: int = 50

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def generate_session_explosion(
    config: Optional[SessionExplosionConfig] = None,
) -> WorkloadTrace:
    """Short-lived session storm: per-session state's worst case."""
    cfg = config or SessionExplosionConfig()
    if cfg.n_sessions <= 0:
        raise ValueError("n_sessions must be >= 1")
    if cfg.max_turns <= 0:
        raise ValueError("max_turns must be >= 1")
    rng = random.Random(cfg.seed)
    prefixes = [
        f"[pool {g}] " + _text(rng, cfg.prefix_words)
        for g in range(max(cfg.n_prefixes, 1))
    ]
    starts = arrival_process(
        cfg.arrival, rng, cfg.rate_per_s,
        on_s=cfg.burst_on_s, off_s=cfg.burst_off_s,
    )
    sessions = {}
    turns: List[TraceTurn] = []
    for k in range(cfg.n_sessions):
        session_id = f"x{k}"
        sessions[session_id] = prefixes[k % len(prefixes)]
        at = next(starts)
        n_turns = 1 + rng.randrange(cfg.max_turns)
        for t in range(n_turns):
            user = _text(rng, cfg.user_words)
            resp = _text(rng, cfg.response_words)
            turns.append(TraceTurn(
                arrival_s=round(at, 6),
                session=session_id,
                turn=t,
                user_len=len(user.split()),
                output_len=len(resp.split()),
                user_text=user,
                response_text=resp,
            ))
            at += rng.expovariate(1.0 / cfg.think_time_mean_s)
    turns.sort(key=lambda t: (t.arrival_s, t.session, t.turn))
    return WorkloadTrace(
        workload="adversarial_sessions",
        seed=cfg.seed,
        config=cfg.as_dict(),
        tables_version=tables.TABLES_VERSION,
        sessions=sessions,
        turns=turns,
    )


@dataclass(frozen=True)
class ChurnStormConfig:
    """Knobs of the churn storm (recorded in the trace header)."""

    seed: int = 42
    # The REQUEST side stays deliberately cache-friendly: the adversary
    # is the roster, and a friendly workload makes any hit-rate damage
    # attributable to churn handling alone.
    n_groups: int = 4
    users_per_group: int = 6
    prefix_words: int = 400
    turns_per_session: int = 4
    arrival: str = "poisson"
    rate_per_s: float = 2.0
    burst_on_s: float = 10.0
    burst_off_s: float = 20.0
    think_time_mean_s: float = 3.0
    user_words: int = 40
    response_words: int = 60
    # The roster side: `base_pods` serve from t=0 and never leave;
    # every `churn_interval_s` one transient pod joins and the oldest
    # transient pod leaves, for `n_churn_events` join/leave pairs —
    # steady-state live count is `base_pods + transient_pods`, while
    # the EVER-SEEN count grows by one pod per event (the leak the
    # reaper exists to stop).
    base_pods: int = 2
    transient_pods: int = 2
    n_churn_events: int = 24
    churn_interval_s: float = 8.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def transient_pod_name(index: int) -> str:
    """Roster name of the index-th transient pod (join order)."""
    return f"churn-{index}"


def churn_schedule(
    config: Optional[ChurnStormConfig] = None,
) -> List[Tuple[float, str, str]]:
    """The deterministic roster script: time-ordered
    ``(t_s, "join" | "leave", pod_name)`` events, a pure function of the
    config (no RNG — replaying arms must agree on the roster exactly).

    The first `transient_pods` joins have no matching leave until the
    pipeline fills; thereafter each interval is one join + one leave of
    the oldest transient, so the live transient count holds constant
    while names never repeat.
    """
    cfg = config or ChurnStormConfig()
    if cfg.transient_pods <= 0 or cfg.n_churn_events < 0:
        raise ValueError(
            f"invalid churn shape: transient_pods={cfg.transient_pods} "
            f"n_churn_events={cfg.n_churn_events}"
        )
    events: List[Tuple[float, str, str]] = []
    for i in range(cfg.n_churn_events):
        at = round((i + 1) * cfg.churn_interval_s, 6)
        events.append((at, "join", transient_pod_name(i)))
        if i >= cfg.transient_pods:
            events.append(
                (at, "leave", transient_pod_name(i - cfg.transient_pods))
            )
    return events


def generate_churn_storm(
    config: Optional[ChurnStormConfig] = None,
) -> WorkloadTrace:
    """Cache-friendly request stream for the churn-storm scenario; the
    roster events come from `churn_schedule` over the same config."""
    cfg = config or ChurnStormConfig()
    if cfg.n_groups <= 0 or cfg.users_per_group <= 0:
        raise ValueError(
            f"invalid shape: n_groups={cfg.n_groups} "
            f"users_per_group={cfg.users_per_group}"
        )
    rng = random.Random(cfg.seed)
    prefixes = [
        f"[churn group {g}] " + _text(rng, cfg.prefix_words)
        for g in range(cfg.n_groups)
    ]
    starts = arrival_process(
        cfg.arrival, rng, cfg.rate_per_s,
        on_s=cfg.burst_on_s, off_s=cfg.burst_off_s,
    )
    sessions = {}
    turns: List[TraceTurn] = []
    for g in range(cfg.n_groups):
        for u in range(cfg.users_per_group):
            session_id = f"c{g}-u{u}"
            sessions[session_id] = prefixes[g]
            at = next(starts)
            for t in range(cfg.turns_per_session):
                user = _text(rng, cfg.user_words)
                resp = _text(rng, cfg.response_words)
                turns.append(TraceTurn(
                    arrival_s=round(at, 6),
                    session=session_id,
                    turn=t,
                    user_len=len(user.split()),
                    output_len=len(resp.split()),
                    user_text=user,
                    response_text=resp,
                ))
                at += rng.expovariate(1.0 / cfg.think_time_mean_s)
    turns.sort(key=lambda t: (t.arrival_s, t.session, t.turn))
    return WorkloadTrace(
        workload="adversarial_churn",
        seed=cfg.seed,
        config=cfg.as_dict(),
        tables_version=tables.TABLES_VERSION,
        sessions=sessions,
        turns=turns,
    )
