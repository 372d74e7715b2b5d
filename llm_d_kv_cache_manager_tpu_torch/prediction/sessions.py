"""Session table: learn per-session next-turn ETAs from the read path.

Copy of the reference package's `prediction/sessions.py`. Every plane
before this one reacts to an arrival; this module is the memory that lets
the fleet act *before* one. The read path already derives each routed
prompt's block-hash chain (`Indexer.get_pod_scores_ex`), and a
multi-turn session's turns are chained by construction: turn N's prompt
extends turn N-1's grown prompt, so turn N's chain carries turn N-1's
entire chain as a leading prefix. That containment is the session
identity — no session id, cookie, or router affinity is needed:

- a session is keyed by the **tail hash** of its latest observed chain
  (the last block's hash). Tenant/LoRA extra keys are already mixed into
  every chunk hash (hashing.py), so two tenants' identical token streams
  have disjoint tails — per-tenant isolation rides the same mechanism the
  index itself uses, and sessions sharing a system-prefix group still
  diverge at their first user message.
- a new observation whose chain *contains* a tracked tail is that
  session's next turn: the gap since the previous arrival is a think-time
  sample, and the record re-keys to the new tail.

The think-time model is deliberately small: a per-session EWMA over
observed inter-turn gaps, blended with a **fleet-level quantile prior**
(a bounded reservoir over every session's gaps, seeded from the
workloads/ think-time shape) by observation count — a session's first
continuation is predicted almost entirely by the fleet, its fifth almost
entirely by itself. Everything runs under an injected clock, one mutex,
hard space bounds (LRU past `max_sessions`), and observation is the only
write path — scores and routing are bit-identical with a table attached
(the PREDICTION=0 contract, pinned in tests/test_prediction.py).

Misprediction accounting is first-class: every prefetch the scheduler
lands is noted on the record, and blocks that were pre-landed for a turn
that never arrived (prediction expired, session evicted) — or landed on a
pod the router then did not pick — are counted, in blocks and bytes. The
anticipate bench commits that number as its honest cost column.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics


@dataclass
class PredictionConfig:
    """Knobs of the session predictor; all bounds are hard."""

    # Session-table bound: past it, the least-recently-observed session is
    # evicted (an outstanding prefetch on the victim counts mispredicted).
    max_sessions: int = 1024
    # EWMA weight of the newest inter-turn gap sample (0..1]. Higher adapts
    # faster; lower smooths tool-latency jitter.
    eta_alpha: float = 0.4
    # How many pseudo-observations the fleet prior is worth when blending
    # with the per-session EWMA: eta = (n*ewma + w*prior) / (n + w).
    prior_weight: float = 2.0
    # Bounded reservoir of recent fleet-wide gap samples (any session),
    # and the quantile of it used as the prior.
    fleet_window: int = 256
    fleet_quantile: float = 0.5
    # Cold-start prior before the fleet has observed a single continuation
    # (the workloads/ think-time shape: mean think time plus read time for
    # a median-length response — see `fleet_prior_from_tables`).
    default_eta_s: float = 8.0
    # Sanity clamps on gap samples: sub-min gaps are request fan-out (two
    # arrivals of one logical turn), beyond-max gaps are abandoned
    # sessions coming back — neither should steer the EWMA.
    min_gap_s: float = 0.05
    max_gap_s: float = 600.0
    # Retained continuation prefix per session (blocks, and the matching
    # token slice a warm_chain admission needs).
    max_chain_blocks: int = 256
    # Chain-tail safety margin, in blocks. The tokenization pool's
    # prefix-store shortcut is tail-unstable: the FIRST (cold) tokenization
    # of a prompt can yield a few more trailing tokens than every later
    # (store-hit) call, so a route-time observed chain may end in blocks
    # no engine ever commits. Predictions cover only the stable prefix —
    # the dropped tail is at most this many blocks of the next turn's
    # prefill, while a phantom tail block would head-block the whole
    # chain restore (warm_chain materializes a leading prefix). The
    # store's shortcut re-tokenizes at most one 256-byte text chunk of
    # tail (~5 blocks at block_size 16); 8 is that bound with margin.
    tail_trim_blocks: int = 8
    # A pending prefetch expires (mispredicted) this many ETAs past the
    # predicted arrival.
    expiry_factor: float = 3.0
    # Bytes per KV block for the mispredicted-bytes accounting (0 = count
    # blocks only; the bench passes the model class's real block bytes).
    block_bytes: int = 0


def fleet_prior_from_tables(
    think_time_mean_s: float,
    read_s_per_unit: float,
    quantile: float = 0.5,
) -> float:
    """Static ETA prior from the committed workload tables: mean think
    time plus the read-time term for a `quantile` response length — the
    same shape `workloads.arrivals.think_time_s` draws from, collapsed to
    one number for cold-start prediction."""
    from llm_d_kv_cache_manager_tpu_torch.workloads import tables

    qs = tables.OUTPUT_LEN_QUANTILES
    q = min(max(quantile, 0.0), 1.0)
    # Piecewise-linear inverse CDF over the committed quantile table.
    pos = q * (len(qs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(qs) - 1)
    out_len = qs[lo][1] + (qs[hi][1] - qs[lo][1]) * (pos - lo)
    return think_time_mean_s + read_s_per_unit * out_len


@dataclass
class PendingPrefetch:
    """One outstanding anticipatory prefetch, noted on the session."""

    pod: str
    blocks: int
    submitted_at: float
    expected_at: float
    expires_at: float


@dataclass
class SessionRecord:
    """One tracked session: its latest chain and think-time estimate."""

    tail: int                      # last block hash of the latest chain
    lora_id: Optional[int]
    model_name: str
    chain_hashes: List[int] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    last_arrival_s: float = 0.0
    gap_ewma_s: Optional[float] = None
    turns_observed: int = 1
    gap_samples: int = 0
    # Lifecycle of the anticipatory prefetch for the NEXT turn.
    pending: Optional[PendingPrefetch] = None
    last_prefetch_at: Optional[float] = None
    # The prefetch consumed by the CURRENT turn (set when a continuation
    # resolves a pending prefetch; the bench's audit compares its pod with
    # the router's actual pick).
    consumed: Optional[PendingPrefetch] = None

    def observe_gap(self, gap_s: float, alpha: float) -> None:
        self.gap_samples += 1
        if self.gap_ewma_s is None:
            self.gap_ewma_s = gap_s
        else:
            self.gap_ewma_s += alpha * (gap_s - self.gap_ewma_s)


class SessionTable:
    """Bounded read-path observer: session identity, ETA, prefix memory.

    Attach as `Indexer(prediction=table)` — `observe_route` is called with
    the same arguments the placement popularity ingest gets, is pure
    observation (never read by the scoring stages), and costs one
    attribute check when disabled (`None`).
    """

    def __init__(
        self,
        config: Optional[PredictionConfig] = None,
        clock=time.monotonic,
    ):
        self.config = config or PredictionConfig()
        if self.config.max_sessions <= 0:
            raise ValueError("max_sessions must be positive")
        if not 0.0 < self.config.eta_alpha <= 1.0:
            raise ValueError("eta_alpha must be in (0, 1]")
        self.clock = clock
        self._mu = threading.Lock()
        # tail hash -> record, LRU by last observation. Tenant extras are
        # already mixed into the tail hash, so one flat map is isolated.
        self._by_tail: "OrderedDict[int, SessionRecord]" = OrderedDict()
        self._fleet_gaps: "deque[float]" = deque(
            maxlen=max(self.config.fleet_window, 1)
        )
        self.stats_counters = {
            "observations": 0,
            "continuations": 0,
            "new_sessions": 0,
            "evictions": 0,
            "prefetches_noted": 0,
            "prefetches_resolved": 0,
            "prefetches_expired": 0,
            "mispredicted_blocks": 0,
            "mispredicted_bytes": 0,
            "clamped_gaps": 0,
            "shed_sessions": 0,
        }

    # -- ingest (the Indexer observation seam) -----------------------------

    def observe_route(
        self,
        block_hashes: Sequence[int],
        tokens: Optional[Sequence[int]] = None,
        lora_id: Optional[int] = None,
        model_name: str = "",
        block_size: int = 0,
        now: Optional[float] = None,
    ) -> None:
        """One routed request: continuation detection + ETA update.

        Same signature as the placement tracker's route ingest, so the
        Indexer seam feeds both with one call shape."""
        if not block_hashes:
            return
        if now is None:
            now = self.clock()
        cfg = self.config
        retained = self._retained_slice(block_hashes)
        if not retained:
            return
        with self._mu:
            self.stats_counters["observations"] += 1
            rec = self._find_continuation(block_hashes)
            if rec is not None:
                self._continue_session(
                    rec, retained, tokens, block_size, now
                )
            else:
                rec = SessionRecord(
                    tail=retained[-1],
                    lora_id=lora_id,
                    model_name=model_name,
                    last_arrival_s=now,
                )
                self._retain_chain(rec, retained, tokens, block_size)
                self._by_tail[rec.tail] = rec
                self.stats_counters["new_sessions"] += 1
            self._by_tail.move_to_end(rec.tail)
            while len(self._by_tail) > cfg.max_sessions:
                _, victim = self._by_tail.popitem(last=False)
                self.stats_counters["evictions"] += 1
                if victim.pending is not None:
                    self._count_mispredicted(victim.pending.blocks)

    def _find_continuation(
        self, block_hashes: Sequence[int]
    ) -> Optional[SessionRecord]:
        """The tracked session (if any) whose latest chain is a leading
        prefix of this one. Scanned back-to-front: the previous turn's
        tail sits near the end of the new chain (only the new user
        message extends it), so the match is found in a handful of dict
        probes."""
        by_tail = self._by_tail
        for h in reversed(block_hashes):
            rec = by_tail.get(h)
            if rec is not None:
                return rec
        return None

    def _retained_slice(self, block_hashes: Sequence[int]) -> List[int]:
        """The chain slice a record keeps: bounded AND tail-trimmed (see
        `tail_trim_blocks` — the trailing blocks of a cold tokenization
        are not trustworthy prediction targets)."""
        cfg = self.config
        n = len(block_hashes) - max(cfg.tail_trim_blocks, 0)
        return list(block_hashes[: min(max(n, 1), cfg.max_chain_blocks)])

    def _continue_session(
        self,
        rec: SessionRecord,
        block_hashes: Sequence[int],
        tokens: Optional[Sequence[int]],
        block_size: int,
        now: float,
    ) -> None:
        cfg = self.config
        self.stats_counters["continuations"] += 1
        gap = now - rec.last_arrival_s
        if cfg.min_gap_s <= gap <= cfg.max_gap_s:
            rec.observe_gap(gap, cfg.eta_alpha)
            self._fleet_gaps.append(gap)
        else:
            self.stats_counters["clamped_gaps"] += 1
        rec.turns_observed += 1
        rec.last_arrival_s = now
        # The pending prefetch (if any) is consumed by this arrival — the
        # predicted turn happened. Whether it landed on the right pod is
        # the caller's audit (`consumed` carries the evidence).
        rec.consumed = rec.pending
        if rec.pending is not None:
            self.stats_counters["prefetches_resolved"] += 1
            rec.pending = None
        # Re-key to the new tail.
        old_tail = rec.tail
        new_tail = block_hashes[-1]
        if new_tail != old_tail:
            self._by_tail.pop(old_tail, None)
            rec.tail = new_tail
            self._by_tail[new_tail] = rec
        self._retain_chain(rec, block_hashes, tokens, block_size)

    def _retain_chain(
        self,
        rec: SessionRecord,
        block_hashes: Sequence[int],
        tokens: Optional[Sequence[int]],
        block_size: int,
    ) -> None:
        rec.chain_hashes = list(block_hashes)
        if tokens is not None and block_size > 0:
            # Exactly the retained chain's token span, so a warm_chain
            # re-derivation from these tokens yields exactly chain_hashes.
            rec.tokens = list(tokens[: len(rec.chain_hashes) * block_size])

    def _count_mispredicted(self, blocks: int) -> None:
        self.stats_counters["mispredicted_blocks"] += blocks
        self.stats_counters["mispredicted_bytes"] += (
            blocks * self.config.block_bytes
        )
        metrics.count_prediction_mispredicted(blocks)

    # -- ETA model ---------------------------------------------------------

    def fleet_eta_s(self) -> float:
        """Fleet-level prior: the configured quantile of the recent-gap
        reservoir, or the cold-start default before any continuation."""
        with self._mu:
            return self._fleet_eta_locked()

    def _fleet_eta_locked(self) -> float:
        if not self._fleet_gaps:
            return self.config.default_eta_s
        ordered = sorted(self._fleet_gaps)
        q = min(max(self.config.fleet_quantile, 0.0), 1.0)
        return ordered[min(int(q * len(ordered)), len(ordered) - 1)]

    def _eta_locked(self, rec: SessionRecord) -> float:
        prior = self._fleet_eta_locked()
        if rec.gap_ewma_s is None:
            return prior
        n = rec.gap_samples
        w = self.config.prior_weight
        return (n * rec.gap_ewma_s + w * prior) / (n + w)

    def eta_s(self, rec: SessionRecord) -> float:
        """Blended next-turn ETA (seconds after the last arrival)."""
        with self._mu:
            return self._eta_locked(rec)

    # -- scheduler surface -------------------------------------------------

    def due_sessions(
        self,
        now: float,
        start_frac: float = 0.25,
        cooldown_s: float = 5.0,
        limit: int = 0,
    ) -> List[Tuple[SessionRecord, float]]:
        """Sessions inside their predicted idle window with no outstanding
        prefetch and a cooled-down last attempt: [(record, expected_at)],
        soonest expected arrival first. The window opens `start_frac` of
        the ETA after the last arrival (the pod is still streaming the
        response right after the request; mid-think is when prefetch
        competes with nothing) and closes at the expiry horizon."""
        out: List[Tuple[SessionRecord, float]] = []
        with self._mu:
            for rec in self._by_tail.values():
                if rec.pending is not None:
                    continue
                if (
                    rec.last_prefetch_at is not None
                    and now - rec.last_prefetch_at < cooldown_s
                ):
                    continue
                eta = self._eta_locked(rec)
                expected = rec.last_arrival_s + eta
                opens = rec.last_arrival_s + start_frac * eta
                closes = expected + self.config.expiry_factor * eta
                if opens <= now <= closes:
                    out.append((rec, expected))
        out.sort(key=lambda item: (item[1], item[0].tail))
        if limit > 0:
            out = out[:limit]
        return out

    def note_prefetch(self, rec: SessionRecord, pod: str, now: float) -> None:
        """Record a submitted anticipatory prefetch on the session.
        `blocks` starts at 0 — misprediction cost counts bytes actually
        MOVED, and only the executor knows how many landed
        (`note_landed`); a prefetch that found everything device-resident
        costs nothing and must expire costing nothing."""
        with self._mu:
            eta = self._eta_locked(rec)
            expected = rec.last_arrival_s + eta
            rec.pending = PendingPrefetch(
                pod=pod,
                blocks=0,
                submitted_at=now,
                expected_at=expected,
                expires_at=expected + self.config.expiry_factor * eta,
            )
            rec.last_prefetch_at = now
            self.stats_counters["prefetches_noted"] += 1

    def note_landed(self, tail: int, blocks: int) -> None:
        """Executor feedback: `blocks` were actually transferred for the
        pending prefetch keyed by `tail` (the submitted chain's last
        hash). Lost-race lookups (the session re-keyed because its turn
        already arrived) are fine to drop — a consumed prefetch's cost is
        audited through `consumed`, not `pending`."""
        if not blocks:
            return
        with self._mu:
            rec = self._by_tail.get(tail)
            if rec is not None and rec.pending is not None:
                rec.pending.blocks += blocks

    def expire_pending(self, now: float) -> int:
        """Sweep predictions whose turn never arrived: their blocks are
        mispredicted cost. Returns how many predictions expired."""
        expired = 0
        with self._mu:
            for rec in self._by_tail.values():
                p = rec.pending
                if p is not None and now > p.expires_at:
                    self._count_mispredicted(p.blocks)
                    self.stats_counters["prefetches_expired"] += 1
                    rec.pending = None
                    expired += 1
        return expired

    def shed(self, fraction: float) -> int:
        """Resource-governor hook: evict the `fraction` least-recently-
        observed sessions, SKIPPING any with an outstanding prefetch —
        an in-flight prediction's misprediction accounting rides the
        record, so dropping it would both lose cost evidence and orphan
        the executor's `note_landed` feedback. Sessions are re-learned
        from their next turn (as a fresh session, losing only the ETA
        history). Returns sessions evicted."""
        fraction = min(max(fraction, 0.0), 1.0)
        with self._mu:
            target = int(len(self._by_tail) * fraction)
            if target <= 0:
                return 0
            victims = [
                tail for tail, rec in self._by_tail.items()
                if rec.pending is None
            ][:target]
            for tail in victims:
                del self._by_tail[tail]
            self.stats_counters["shed_sessions"] += len(victims)
            return len(victims)

    # -- queries -----------------------------------------------------------

    def record_by_tail(self, tail: int) -> Optional[SessionRecord]:
        with self._mu:
            return self._by_tail.get(tail)

    def count_wrong_pod(self, blocks: int) -> None:
        """Caller-observed misprediction: the turn arrived but the router
        picked a different pod than the prefetch landed on (the bench's
        audit seam — the table cannot see routing decisions)."""
        with self._mu:
            self._count_mispredicted(blocks)

    def sessions(self) -> int:
        with self._mu:
            return len(self._by_tail)

    def snapshot(self, now: Optional[float] = None, limit: int = 8) -> list:
        """Introspection (the /prediction/status surface): the `limit`
        soonest-expected sessions with their ETA evidence."""
        if now is None:
            now = self.clock()
        with self._mu:
            rows = []
            for rec in self._by_tail.values():
                eta = self._eta_locked(rec)
                rows.append({
                    "tail": f"{rec.tail:016x}",
                    "turns_observed": rec.turns_observed,
                    "eta_s": round(eta, 3),
                    "expected_in_s": round(
                        rec.last_arrival_s + eta - now, 3
                    ),
                    "chain_blocks": len(rec.chain_hashes),
                    "gap_ewma_s": (
                        round(rec.gap_ewma_s, 3)
                        if rec.gap_ewma_s is not None else None
                    ),
                    "pending_prefetch": (
                        {"pod": rec.pending.pod, "blocks": rec.pending.blocks}
                        if rec.pending is not None else None
                    ),
                })
            rows.sort(key=lambda r: r["expected_in_s"])
            return rows[:limit]

    def stats(self) -> Dict[str, float]:
        with self._mu:
            return {
                "tracked_sessions": len(self._by_tail),
                "max_sessions": self.config.max_sessions,
                "fleet_eta_s": round(self._fleet_eta_locked(), 4),
                "fleet_gap_samples": len(self._fleet_gaps),
                **self.stats_counters,
            }
