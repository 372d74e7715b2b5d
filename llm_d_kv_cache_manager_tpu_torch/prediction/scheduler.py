"""Budget-bounded anticipatory prefetch: pre-land the next turn.

Copy of the reference package's `prediction/scheduler.py`. The session table (prediction/sessions.py) says *when* a
session's next turn is expected and *what* chain it will lead with; this module decides
*where* that chain should already be, and pushes it there during the idle
think window — through the planes that already exist, with serving always
winning:

- **The target is the router's answer, not a guess.** The chain is scored
  through the REAL read-path stages (`Indexer.score_hashes`: same index
  lookup, same scorer arithmetic, same fleet-health filtering, same
  routing-policy adjustment), and the pod is picked by the caller's own
  tie-break (`select_fn` — the bench passes the router's exact rule). A
  prediction can be early or wasted; it can never disagree with where the
  router would send the request.
- **Jobs ride the bounded prefetch plane.** Submissions go through a
  `RoutePrefetcher` under `source="prediction"`, so they inherit its
  non-blocking bounded queue and are dropped (counted, per source) rather
  than ever queueing behind serving. Downstream, `EnginePod.warm_chain`
  admits through the data plane only and aborts on `OutOfPagesError` —
  page pressure from live traffic silently wins.
- **Budgets are structural.** Per-tick job cap, per-session cooldown, and
  the idle-window gate (no prefetch while the response is still
  streaming; none for a turn already overdue past the expiry horizon).

The tick is pull-based and thread-free, like the placement replicator:
callers invoke `tick()` from whatever cadence they own (the fleet sim
calls it per served request under the simulated clock; a service wires a
timer). Every decision is visible in `stats`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from llm_d_kv_cache_manager_tpu_torch import obs
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.prediction.sessions import (
    SessionRecord,
    SessionTable,
)
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("prediction.scheduler")

# submit_fn(pod_identifier, block_hashes) -> bool: enqueue one prefetch
# job (False = bounded queue full / plane closed, counted as a drop).
# Typically `lambda pod, hashes: prefetcher.submit(pod, hashes,
# source="prediction")`.
SubmitFn = Callable[[str, List[int]], bool]
# score_fn(model_name, block_hashes) -> PodScores: the real routing
# decision over an already-derived chain (Indexer.score_hashes; tenant
# scoping needs no extra argument — the adapter id is already mixed into
# every chunk hash).
ScoreFn = Callable[..., object]
# select_fn(scores: dict) -> Optional[pod_identifier]: the router's
# tie-break over the score map. None = no target (skip this session).
SelectFn = Callable[[dict], Optional[str]]


@dataclass
class SchedulerConfig:
    # Bound on prefetch jobs one tick may submit (serving-first: a burst
    # of simultaneously-due sessions trickles out over ticks).
    max_jobs_per_tick: int = 4
    # Per-session cooldown between prefetch attempts — a session whose
    # prefetch was dropped (or partially landed) is not retried in a hot
    # loop.
    session_cooldown_s: float = 5.0
    # Idle-window entry: wait this fraction of the predicted gap after the
    # last arrival before prefetching (the pod is busy streaming the
    # response early in the gap; mid-think competes with nothing).
    start_frac: float = 0.25


def best_score_select(scores: dict) -> Optional[str]:
    """Default deterministic tie-break: best score, lexicographic-min pod
    (the same rule `Indexer.explain_scores` reports as `chosen`). Callers
    with load state pass their own rule instead."""
    if not scores:
        return None
    best = max(scores.values())
    return min(p for p, s in scores.items() if s == best)


class PrefetchScheduler:
    """Policy loop: find sessions in their idle window, resolve the
    router's target pod, pre-land the continuation prefix."""

    def __init__(
        self,
        table: SessionTable,
        score_fn: ScoreFn,
        submit_fn: SubmitFn,
        config: Optional[SchedulerConfig] = None,
        select_fn: Optional[SelectFn] = None,
        clock=time.monotonic,
    ):
        self.table = table
        self.score_fn = score_fn
        self.submit_fn = submit_fn
        self.config = config or SchedulerConfig()
        self.select_fn = select_fn or best_score_select
        self.clock = clock
        self.stats = {
            "ticks": 0,
            "jobs_submitted": 0,
            "blocks_submitted": 0,
            "drops": 0,
            "skipped_no_target": 0,
            "expired": 0,
        }

    def tick(self, now: Optional[float] = None) -> int:
        """One policy pass; returns the number of jobs submitted."""
        if now is None:
            now = self.clock()
        cfg = self.config
        self.stats["ticks"] += 1
        self.stats["expired"] += self.table.expire_pending(now)
        due = self.table.due_sessions(
            now,
            start_frac=cfg.start_frac,
            cooldown_s=cfg.session_cooldown_s,
            limit=cfg.max_jobs_per_tick,
        )
        if not due:
            return 0
        # Only working ticks trace (prediction plane stage attribution):
        # an idle tick is the overwhelmingly common case and must not
        # churn the flight-recorder ring.
        submitted = 0
        with obs.request("prediction.tick", {"due": len(due)}):
            for rec, expected_at in due:
                if submitted >= cfg.max_jobs_per_tick:
                    break
                if self._prefetch(rec, now):
                    submitted += 1
                    kvlog.trace(
                        logger,
                        "anticipatory prefetch for session %x "
                        "(expected in %.2fs)",
                        rec.tail, expected_at - now,
                    )
        return submitted

    def _prefetch(self, rec: SessionRecord, now: float) -> bool:
        if not rec.chain_hashes:
            return False
        with obs.stage("prediction.score_hashes", nested=True):
            result = self.score_fn(rec.model_name, rec.chain_hashes)
        pod = self.select_fn(result.scores)
        if pod is None:
            self.stats["skipped_no_target"] += 1
            return False
        # The WHOLE retained chain is submitted, not the index-derived
        # missing tail: the index cannot distinguish device-resident
        # blocks (nothing to do) from host-staged ones (the evicted
        # prefix this subsystem exists to re-land) — both count toward a
        # pod's matched prefix. The pod-side admission is residency-aware
        # and idempotent (prefetch_hashes filters resident blocks;
        # warm_chain materializes only what some tier can supply), so
        # over-submission costs a queue slot, never a wasted transfer.
        with obs.stage("prediction.submit"):
            submitted = self.submit_fn(pod, list(rec.chain_hashes))
        if submitted:
            self.table.note_prefetch(rec, pod, now)
            self.stats["jobs_submitted"] += 1
            self.stats["blocks_submitted"] += len(rec.chain_hashes)
            metrics.count_prediction_prefetch(len(rec.chain_hashes))
            return True
        self.stats["drops"] += 1
        return False

    def register_knobs(self, registry) -> None:
        """Publish the per-tick prefetch budget to the autopilot
        (autopilot/knobs.py). tick() re-reads the config each pass. The
        floor is 1, not 0: `due_sessions(limit=0)` means UNLIMITED, so a
        zeroed knob would widen the budget it exists to shrink."""
        from llm_d_kv_cache_manager_tpu_torch.autopilot.knobs import (
            KNOB_PREDICTION_JOBS,
            KnobSpec,
        )

        cfg = self.config
        registry.register(
            KnobSpec(
                name=KNOB_PREDICTION_JOBS,
                floor=1.0,
                ceiling=float(max(cfg.max_jobs_per_tick * 2, 2)),
                max_step=1.0,
                integer=True,
                description="anticipatory prefetch jobs submitted per tick",
            ),
            get=lambda: cfg.max_jobs_per_tick,
            set_=lambda v: setattr(cfg, "max_jobs_per_tick", int(v)),
        )

    def status(self) -> dict:
        return {
            "config": {
                "max_jobs_per_tick": self.config.max_jobs_per_tick,
                "session_cooldown_s": self.config.session_cooldown_s,
                "start_frac": self.config.start_frac,
            },
            "stats": dict(self.stats),
            "table": self.table.stats(),
        }
