"""Departed-entity reaping: per-pod state dies when the pod does.

Copy of the reference package's `resourcegov/reaper.py`. Half the control
plane keeps a per-pod (or per-peer) row: fleet-health records, load records,
anti-entropy trust EWMAs, transfer breakers and latency profiles,
negative-cache entries. Before this module, those rows lived forever — a
fleet that churns through N pods (the elastic scale-out/in path) accumulates
N rows per map, not |live| rows.

`DepartureReaper` is the fan-out seam: structures register a
per-identity `forget(identity) -> rows_removed` hook, and the two
departure signals — membership `leave` (the pod is gone on purpose)
and a fleet-health `stale` quarantine (the pod is gone in practice) —
call `reap(pod)` once. Each hook is exception-guarded and DP-rank-
agnostic by contract: a hook receives the identity as reported and is
expected to fold DP-rank-qualified forms onto their base itself (the
trackers' `forget_pod` implementations do — see fleethealth/).

Reaping is *safe by construction* on every structure it touches:
a forgotten pod that comes back is simply re-learned from its next
event batch / report / fetch — per-pod rows are all re-derivable
caches of live behavior, never sources of truth. That is why the
reaper runs even with the governor disabled: it is a leak fix, not a
pressure policy.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("resourcegov.reaper")


class DepartureReaper:
    """Registry of per-identity forget hooks + the reap fan-out."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        journal_len: int = 64,
    ):
        self.clock = clock
        self._mu = threading.Lock()
        self._hooks: Dict[str, Callable[[str], int]] = {}
        self._journal: deque = deque(maxlen=max(journal_len, 1))
        self.stats_counters = {"reaps": 0, "rows_removed": 0, "errors": 0}

    def register(self, name: str, forget: Callable[[str], int]) -> None:
        """Attach one structure's forget hook. `forget(identity)` must
        return the number of rows it removed (0 for an unknown pod) and
        must be idempotent — leave and quarantine can both fire for one
        departure."""
        with self._mu:
            if name in self._hooks:
                raise ValueError(f"reap hook {name!r} already registered")
            self._hooks[name] = forget
        logger.info("departure reap hook registered: %s", name)

    def names(self) -> List[str]:
        with self._mu:
            return sorted(self._hooks)

    def reap(self, pod_identifier: str) -> Dict[str, int]:
        """Fan one departure out to every hook; returns {hook: rows}.
        A failing hook is logged and counted, never re-raised — one
        broken structure must not keep every other map leaking."""
        with self._mu:
            hooks = sorted(self._hooks.items())
        removed: Dict[str, int] = {}
        errors = 0
        for name, forget in hooks:
            try:
                removed[name] = int(forget(pod_identifier))
            except Exception as e:  # noqa: BLE001 - see docstring
                errors += 1
                removed[name] = 0
                logger.warning(
                    "reap hook %s failed for %s: %s", name,
                    pod_identifier, e,
                )
        total = sum(removed.values())
        now = self.clock()
        with self._mu:
            self.stats_counters["reaps"] += 1
            self.stats_counters["rows_removed"] += total
            self.stats_counters["errors"] += errors
            self._journal.append(
                (round(now, 3), pod_identifier, total)
            )
        if total:
            logger.info(
                "reaped departed pod %s: %d row(s) across %d structure(s)",
                pod_identifier, total,
                sum(1 for n in removed.values() if n),
            )
        return removed

    def status(self) -> dict:
        with self._mu:
            return {
                "hooks": sorted(self._hooks),
                "stats": dict(self.stats_counters),
                "recent": [list(entry) for entry in self._journal],
            }
