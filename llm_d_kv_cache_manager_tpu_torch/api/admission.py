"""Bounded admission control for the scoring surfaces.

Copy of the reference package's `api/admission.py`, without its metrics
counters (every count is kept in `stats`; the counters come with the
port's metrics collector, ROADMAP.md queue 1 item 7). The autopilot's
`admission_queue_depth` knob actuates it.

Under saturation an unbounded service queue converts overload into
unbounded latency: every request eventually gets an answer, each one
slower than the last, and the caller's own deadline has long expired by
the time it arrives (the qps_40 row of FLEET_BENCH.json `qps_ladder` is
this failure mode measured end-to-end). The admission controller makes
overload an *explicit, bounded, observable* outcome instead:

- at most ``max_concurrency`` requests score at once;
- at most ``max_queue_depth`` more wait, for at most ``max_wait_s``;
- everything past those bounds is SHED — HTTP 429 with a ``Retry-After``
  hint, gRPC ``RESOURCE_EXHAUSTED`` with a ``retry-after-ms`` trailer —
  never an unbounded queue, never a silent stall. The hint is honest
  backpressure: the baseline ``retry_after_s`` scaled by the shed
  pressure of the last few seconds and clamped at ``retry_after_max_s``,
  so an isolated shed invites a quick retry while a sustained burn
  pushes clients progressively further away.

Deadline propagation rides the same gate: a caller-supplied remaining
budget (the gRPC context deadline, or the HTTP ``X-Request-Deadline-Ms``
header) caps the queue wait, and a request whose budget expires while
waiting is shed as ``deadline`` — the service refuses to compute a score
the caller has already abandoned. This is the service-surface sibling of
`TokenizationPool`'s ``PoolOverloadedError`` per-item degradation: both
turn pressure into an explicit, counted signal at the earliest seam that
can see it.

Every shed is counted in ``kvcache_admission_shed_total{kind}`` (kind one
of the fixed `SHED_*` constants below) and every queued-then-served
request in ``kvcache_admission_queued_total``, so dashboards can tell
"at capacity and shedding correctly" from "mysteriously slow".

The controller is transport-neutral sync code (Condition under one lock,
injectable clock): the aiohttp handlers call it through
``asyncio.to_thread`` alongside the scoring work itself, the gRPC
servicer calls it on its worker thread.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("api.admission")

# Fixed shed-kind vocabulary (the `kind` label of
# kvcache_admission_shed_total — bounded by construction, enforced by
# tests/test_metrics_hygiene.py):
SHED_QUEUE_FULL = "queue_full"  # waiting line at max_queue_depth
SHED_DEADLINE = "deadline"      # caller's propagated budget expired
SHED_TIMEOUT = "timeout"        # waited max_wait_s without a slot
SHED_KINDS = (SHED_QUEUE_FULL, SHED_DEADLINE, SHED_TIMEOUT)


@dataclass
class AdmissionConfig:
    """Env mapping (api/http_service.py): ADMISSION_MAX_CONCURRENCY,
    ADMISSION_QUEUE_DEPTH, ADMISSION_MAX_WAIT_MS, ADMISSION_RETRY_AFTER_MS;
    ADMISSION=0 disables the gate entirely."""

    # Requests scoring concurrently before arrivals start queueing. Sized
    # to the scoring thread pool, not the listener: admitting more than
    # can run just moves the queue somewhere invisible.
    max_concurrency: int = 8
    # Bounded waiting line past the concurrency slots; arrival #
    # (max_concurrency + max_queue_depth + 1) is shed immediately.
    max_queue_depth: int = 64
    # Hard cap on time spent in the waiting line (sheds as "timeout").
    max_wait_s: float = 1.0
    # BASELINE Retry-After hint. The hint a shed response actually
    # carries scales this by live shed pressure (sheds observed in the
    # last `shed_pressure_window_s`, per concurrency slot) and clamps at
    # `retry_after_max_s`: an isolated shed says "retry in a beat", a
    # sustained burn says "back off, honestly". The scale input is the
    # controller's own shed COUNT — not a queue-wait estimate computed
    # from the thing that is overloaded, which is noise.
    retry_after_s: float = 1.0
    # Ceiling on the scaled hint (and the value a client sees when the
    # surface is being hammered).
    retry_after_max_s: float = 8.0
    # Window over which recent sheds count as live pressure.
    shed_pressure_window_s: float = 5.0

    def __post_init__(self):
        if self.max_concurrency <= 0:
            raise ValueError("max_concurrency must be positive")
        if self.max_queue_depth < 0:
            raise ValueError("max_queue_depth must be >= 0")
        if self.max_wait_s <= 0:
            raise ValueError("max_wait_s must be positive")
        if self.retry_after_s < 0:
            raise ValueError("retry_after_s must be >= 0")
        if self.retry_after_max_s < self.retry_after_s:
            raise ValueError("retry_after_max_s must be >= retry_after_s")
        if self.shed_pressure_window_s <= 0:
            raise ValueError("shed_pressure_window_s must be positive")


class AdmissionRejected(Exception):
    """Explicit shed: HTTP maps it to 429, gRPC to RESOURCE_EXHAUSTED."""

    def __init__(self, kind: str, retry_after_s: float, detail: str = ""):
        self.kind = kind
        self.retry_after_s = retry_after_s
        super().__init__(
            detail or f"admission shed ({kind}); retry after "
                      f"{retry_after_s:g}s"
        )


class AdmissionController:
    """Bounded concurrency + bounded waiting line + deadline-capped waits."""

    def __init__(
        self,
        config: Optional[AdmissionConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or AdmissionConfig()
        self.clock = clock
        self._cond = threading.Condition()
        self._active = 0
        self._waiting = 0
        # Shed timestamps inside (roughly) the pressure window — the
        # Retry-After scale input. Bounded: under a flood the window is
        # saturated long before the ring is.
        self._shed_times: deque = deque(maxlen=512)
        self.stats: Dict[str, int] = {
            "admitted": 0,
            "queued": 0,
            "shed_queue_full": 0,
            "shed_deadline": 0,
            "shed_timeout": 0,
        }

    # -- gate --------------------------------------------------------------

    def retry_after_hint(self, now: Optional[float] = None) -> float:
        """The live Retry-After hint: baseline scaled by recent shed
        pressure (sheds in the last `shed_pressure_window_s`, per
        concurrency slot), clamped to `retry_after_max_s`. With no
        recent sheds this is exactly `retry_after_s` — the first shed
        of a burst carries the baseline hint, each subsequent one backs
        clients off harder."""
        cfg = self.config
        if now is None:
            now = self.clock()
        horizon = now - cfg.shed_pressure_window_s
        recent = sum(1 for t in self._shed_times if t > horizon)
        scale = 1.0 + recent / cfg.max_concurrency
        return min(cfg.retry_after_max_s, cfg.retry_after_s * scale)

    def _shed(self, kind: str) -> AdmissionRejected:
        # Hint BEFORE recording this shed: pressure is what the caller
        # arrived into, not what it contributed.
        now = self.clock()
        hint = self.retry_after_hint(now)
        self._shed_times.append(now)
        self.stats[f"shed_{kind}"] += 1
        return AdmissionRejected(kind, hint)

    def try_acquire(self, budget_s: Optional[float] = None) -> None:
        """Take a slot or raise `AdmissionRejected`. `budget_s` is the
        caller's remaining deadline budget (None = no deadline): it caps
        the queue wait, and a request that cannot possibly be served
        inside it is shed as ``deadline`` rather than parked."""
        cfg = self.config
        with self._cond:
            if budget_s is not None and budget_s <= 0:
                # The caller is already out of time: scoring would be
                # work nobody is waiting for.
                raise self._shed(SHED_DEADLINE)
            if self._active < cfg.max_concurrency and self._waiting == 0:
                self._active += 1
                self.stats["admitted"] += 1
                return
            if self._waiting >= cfg.max_queue_depth:
                raise self._shed(SHED_QUEUE_FULL)
            wait_cap = cfg.max_wait_s
            capped_by_deadline = False
            if budget_s is not None and budget_s < wait_cap:
                wait_cap = budget_s
                capped_by_deadline = True
            self._waiting += 1
            self.stats["queued"] += 1
            deadline_at = self.clock() + wait_cap
            try:
                while self._active >= cfg.max_concurrency:
                    remaining = deadline_at - self.clock()
                    if remaining <= 0:
                        raise self._shed(
                            SHED_DEADLINE if capped_by_deadline
                            else SHED_TIMEOUT
                        )
                    self._cond.wait(timeout=remaining)
                self._active += 1
                self.stats["admitted"] += 1
            finally:
                self._waiting -= 1

    def release(self) -> None:
        with self._cond:
            self._active -= 1
            self._cond.notify()

    @contextlib.contextmanager
    def admit(self, budget_s: Optional[float] = None) -> Iterator[None]:
        """`with controller.admit(budget):` — the serving surfaces' gate."""
        self.try_acquire(budget_s)
        try:
            yield
        finally:
            self.release()

    def register_knobs(self, registry) -> None:
        """Publish the waiting-line depth to the autopilot
        (autopilot/knobs.py). The gate reads the config under its lock
        on every acquire, so a nudge widens the line for the very next
        arrival. Floor = the operator's configured depth (the autopilot
        widens under a shed burn and reverts; it never narrows below
        the baseline), ceiling = 4x it."""
        from llm_d_kv_cache_manager_tpu_torch.autopilot.knobs import (
            KNOB_ADMISSION_QUEUE,
            KnobSpec,
        )

        cfg = self.config
        base = cfg.max_queue_depth
        registry.register(
            KnobSpec(
                name=KNOB_ADMISSION_QUEUE,
                floor=float(base),
                ceiling=float(max(base * 4, base + 8)),
                max_step=float(max(base // 2, 8)),
                integer=True,
                description="bounded admission waiting-line depth",
            ),
            get=lambda: cfg.max_queue_depth,
            set_=lambda v: setattr(cfg, "max_queue_depth", int(v)),
        )

    # -- introspection -----------------------------------------------------

    def depth(self) -> Dict[str, int]:
        with self._cond:
            return {"active": self._active, "waiting": self._waiting}

    def shed_total(self) -> int:
        return (
            self.stats["shed_queue_full"]
            + self.stats["shed_deadline"]
            + self.stats["shed_timeout"]
        )

    def status(self) -> dict:
        cfg = self.config
        with self._cond:
            stats = dict(self.stats)
            depth = {"active": self._active, "waiting": self._waiting}
        return {
            "max_concurrency": cfg.max_concurrency,
            "max_queue_depth": cfg.max_queue_depth,
            "max_wait_s": cfg.max_wait_s,
            "retry_after_s": cfg.retry_after_s,
            "retry_after_max_s": cfg.retry_after_max_s,
            "retry_after_hint_s": round(self.retry_after_hint(), 3),
            "depth": depth,
            "stats": stats,
        }
