"""Agentic trace generator: branching sessions off a shared tool prefix.

The ROADMAP's agentic scenario, and the best case for every prefix plane
in the system — routing, replication, and above all anticipatory prefetch:

- **One large shared preamble.** Every task starts from a big tool/system
  prefix (the tool schemas + instructions an agent framework prepends to
  every call), drawn from a small set of toolsets — the fleet-wide shared
  prefix that precise routing and hot-prefix replication feast on.
- **Fan-out.** After the root agent's planning turn, `fan_out` sub-agents
  branch **off the root's grown prompt**: each sub-agent session's system
  prefix IS the root conversation so far, so the branch point is a shared
  prefix of every worker — one pod warming it serves the whole wave.
- **Tight tool loops.** Each sub-agent runs `subagent_turns` tool-call
  iterations whose gaps are short and regular (tool latency, not human
  think time) — exactly the high-predictability cadence a session
  predictor's ETA model converges on fastest.
- **Fan-in.** When a phase's workers finish, the root continues with a
  synthesis turn extending its own chain; later phases branch again from
  the longer prompt.

Like every generator here, the output is a plain `WorkloadTrace`: a pure
function of (config, seed) — one `random.Random(seed)` drives every draw
in a fixed order — with delta-text turns, so JSONL record/replay is
bit-identical by construction and both benches serve the same prompt
stream. Sub-agent branching needs nothing new from the trace model: a
branch is just a session whose system prefix equals the parent's grown
prompt, built with the exact concatenation `materialize()` performs.
"""

from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass
from typing import List, Optional

from llm_d_kv_cache_manager_tpu_torch.workloads.arrivals import arrival_process
from llm_d_kv_cache_manager_tpu_torch.workloads.spec import TraceTurn, WorkloadTrace
from llm_d_kv_cache_manager_tpu_torch.workloads.synthetic import text as _text
from llm_d_kv_cache_manager_tpu_torch.workloads import tables


@dataclass(frozen=True)
class AgenticConfig:
    """Knobs of the agentic generator (recorded in the trace header)."""

    n_tasks: int = 24
    seed: int = 42
    # Task (root-agent) arrival process.
    arrival: str = "poisson"
    task_rate_per_s: float = 0.8
    burst_on_s: float = 10.0
    burst_off_s: float = 20.0
    # Shared tool/system preambles: every task draws one of
    # `n_tool_prefixes` toolsets round-robin, each `tool_prefix_words`
    # long — the large fleet-shared prefix.
    n_tool_prefixes: int = 2
    tool_prefix_words: int = 1100
    # Fan-out/fan-in shape: phases per task, sub-agents per phase, tool
    # iterations per sub-agent.
    n_phases: int = 2
    fan_out: int = 3
    subagent_turns: int = 3
    # Timing: sub-agents dispatch shortly after the root's planning turn
    # (staggered), iterate at tool latency, and the root synthesizes a
    # beat after the slowest worker.
    dispatch_delay_s: float = 0.4
    worker_stagger_s: float = 0.2
    tool_latency_mean_s: float = 1.2
    synthesis_think_s: float = 2.5
    # Mean word counts (each draw jittered ±30% for realistic spread).
    task_words: int = 70
    plan_words: int = 90
    subtask_words: int = 35
    tool_call_words: int = 55
    tool_result_words: int = 80
    synthesis_request_words: int = 45
    synthesis_words: int = 140

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _jitter(rng: random.Random, mean_words: int) -> int:
    """Deterministic ±30% spread around a mean word count."""
    return max(4, int(mean_words * (0.7 + 0.6 * rng.random())))


def task_of(session_id: str) -> int:
    """Task index encoded in a session id (``a<k>-root`` /
    ``a<k>-p<p>-w<j>``)."""
    return int(session_id.split("-", 1)[0][1:])


def is_root(session_id: str) -> bool:
    return session_id.endswith("-root")


def generate(config: Optional[AgenticConfig] = None) -> WorkloadTrace:
    """Build the agentic trace. Deterministic in (config, seed)."""
    cfg = config or AgenticConfig()
    if cfg.n_tasks <= 0:
        raise ValueError("n_tasks must be >= 1")
    if cfg.fan_out <= 0 or cfg.n_phases < 0 or cfg.subagent_turns <= 0:
        raise ValueError(
            f"invalid agent shape: fan_out={cfg.fan_out} "
            f"n_phases={cfg.n_phases} subagent_turns={cfg.subagent_turns}"
        )
    rng = random.Random(cfg.seed)

    # Toolset preambles first, in fixed draw order.
    tool_prefixes = [
        f"[toolset {g}] " + _text(rng, cfg.tool_prefix_words)
        for g in range(max(cfg.n_tool_prefixes, 1))
    ]

    starts = arrival_process(
        cfg.arrival, rng, cfg.task_rate_per_s,
        on_s=cfg.burst_on_s, off_s=cfg.burst_off_s,
    )

    sessions = {}
    turns: List[TraceTurn] = []

    def emit(session: str, turn: int, at: float, user: str, resp: str):
        turns.append(TraceTurn(
            arrival_s=round(at, 6),
            session=session,
            turn=turn,
            user_len=len(user.split()),
            output_len=len(resp.split()),
            user_text=user,
            response_text=resp,
        ))

    for k in range(cfg.n_tasks):
        root_id = f"a{k}-root"
        prefix = tool_prefixes[k % len(tool_prefixes)]
        sessions[root_id] = prefix
        start = next(starts)

        # Root planning turn. `grown` mirrors materialize()'s exact
        # concatenation — it becomes the sub-agents' branch prefix.
        task_text = _text(rng, _jitter(rng, cfg.task_words))
        plan_text = _text(rng, _jitter(rng, cfg.plan_words))
        emit(root_id, 0, start, task_text, plan_text)
        grown = (
            prefix + " [user] " + task_text + " [assistant] " + plan_text
        )

        root_turn = 1
        root_at = start
        for p in range(cfg.n_phases):
            # Fan-out: each worker branches off the root's grown prompt.
            phase_end = root_at
            for j in range(cfg.fan_out):
                worker_id = f"a{k}-p{p}-w{j}"
                sessions[worker_id] = grown
                at = (
                    root_at
                    + cfg.dispatch_delay_s
                    + j * cfg.worker_stagger_s
                    + rng.expovariate(1.0 / max(cfg.worker_stagger_s, 1e-6))
                )
                for t in range(cfg.subagent_turns):
                    user = _text(rng, _jitter(
                        rng,
                        cfg.subtask_words if t == 0 else cfg.tool_result_words,
                    ))
                    resp = _text(rng, _jitter(rng, cfg.tool_call_words))
                    emit(worker_id, t, at, user, resp)
                    at += rng.expovariate(1.0 / cfg.tool_latency_mean_s)
                # `at` now points one tool latency past the worker's last
                # turn — when its final answer is in hand.
                phase_end = max(phase_end, at)
            # Fan-in: the root synthesizes after the slowest worker.
            root_at = phase_end + cfg.synthesis_think_s + rng.expovariate(
                1.0 / cfg.synthesis_think_s
            )
            syn_req = _text(rng, _jitter(rng, cfg.synthesis_request_words))
            syn_resp = _text(rng, _jitter(rng, cfg.synthesis_words))
            emit(root_id, root_turn, root_at, syn_req, syn_resp)
            grown = grown + " [user] " + syn_req + " [assistant] " + syn_resp
            root_turn += 1

    turns.sort(key=lambda t: (t.arrival_s, t.session, t.turn))
    return WorkloadTrace(
        workload="agentic",
        seed=cfg.seed,
        config=cfg.as_dict(),
        tables_version=tables.TABLES_VERSION,
        sessions=sessions,
        turns=turns,
    )
