"""Route-driven prefetch queue: close the router→data-plane loop.

The read path already computes, per pod, the longest cached prefix of every
routed prompt (`Indexer.get_pod_scores_ex`). The moment the router picks a
pod, the exact set of blocks that pod will MISS — the tail of the chain past
its matched prefix — is known, minutes of compute before the engine's
allocator faults on it. This module (a copy of the reference package's
`kv_connectors/prefetch.py`, without its trace span and metrics counters;
`stats` and `status()` are kept) feeds it to the chosen pod's prefetcher, so
the peer fetch rides the request's queue/tokenize/schedule latency rather
than its TTFT.

`RoutePrefetcher` is deliberately thin: a bounded background queue in front
of a caller-supplied `prefetch_fn(pod_identifier, block_hashes)` (typically
`EnginePod.prefetch_hashes`, or an RPC to the pod in a real deployment).
Submission never blocks the routing thread — a full queue drops the request
(counted) because a prefetch is a hint, and the engine's fault path remains
correct without it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Optional

from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("kv_connectors.prefetch")

PrefetchFn = Callable[[str, List[int]], int]

# The fixed submitter vocabulary: every plane that rides this queue names
# itself from this set.
PREFETCH_SOURCES = ("route", "replication", "prediction")


class RoutePrefetcher:
    """Bounded background queue from routing decisions to pod prefetchers."""

    def __init__(self, prefetch_fn: PrefetchFn, queue_bound: int = 64):
        self.prefetch_fn = prefetch_fn
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue(
            maxsize=max(1, queue_bound)
        )
        self._thread: Optional[threading.Thread] = None
        self._mu = threading.Lock()
        self._closed = False
        self._processed = 0
        self.stats: Dict[str, int] = {
            "submitted": 0, "dropped": 0, "executed": 0, "blocks_queued": 0,
        }
        # Per-source bookkeeping: the queue is shared by route-driven
        # prefetch, hot-prefix replication, and anticipatory prediction,
        # and a drop means something different for each (a route drop
        # costs this request's TTFT; a prediction drop costs nothing now).
        # One aggregate counter hid which plane was being shed.
        self.source_stats: Dict[str, Dict[str, int]] = {}

    def _source(self, source: str) -> Dict[str, int]:
        st = self.source_stats.get(source)
        if st is None:
            st = self.source_stats[source] = {
                "submitted": 0, "dropped": 0, "executed": 0,
                "blocks_queued": 0,
            }
        return st

    def queue_depth(self) -> int:
        """Entries waiting for the worker (approximate, lock-free)."""
        return self._q.qsize()

    def submit(
        self,
        pod_identifier: str,
        block_hashes: List[int],
        source: str = "route",
    ) -> bool:
        """Queue the chosen pod's missing tail for background prefetch.
        Non-blocking: returns False (and counts a drop, per `source`) when
        the queue is full or the prefetcher is closed — the engine's fault
        path stays correct without the hint."""
        if not block_hashes:
            return False
        with self._mu:
            if self._closed:
                return False
            self._ensure_thread()
        try:
            self._q.put_nowait((pod_identifier, list(block_hashes), source))
        except queue.Full:
            self.stats["dropped"] += 1
            self._source(source)["dropped"] += 1
            return False
        self.stats["submitted"] += 1
        self._source(source)["submitted"] += 1
        return True

    def submit_route(self, pod_identifier: str, pod_scores) -> bool:
        """Convenience for the Indexer result: submit exactly the blocks
        the chosen pod misses (`PodScores.missing_tail`)."""
        return self.submit(pod_identifier, pod_scores.missing_tail(pod_identifier))

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name="kv-route-prefetch", daemon=True
            )
            self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            pod_identifier, block_hashes, source = item
            try:
                if not self._closed:
                    n = self.prefetch_fn(pod_identifier, block_hashes)
                    self.stats["executed"] += 1
                    self.stats["blocks_queued"] += int(n or 0)
                    st = self._source(source)
                    st["executed"] += 1
                    st["blocks_queued"] += int(n or 0)
            except Exception as e:  # noqa: BLE001 - a hint must never kill
                logger.debug(  # the worker; the engine restores on fault
                    "route prefetch for %s failed: %s", pod_identifier, e
                )
            finally:
                self._processed += 1

    def status(self) -> dict:
        """Introspection snapshot (the /readyz prefetch section): queue
        occupancy plus aggregate AND per-source counters, so a
        budget-bounded prediction drop is distinguishable from a
        route-prefetch drop at a glance."""
        return {
            "queue_depth": self.queue_depth(),
            "queue_bound": self._q.maxsize,
            "stats": dict(self.stats),
            "by_source": {
                src: dict(st) for src, st in self.source_stats.items()
            },
        }

    def drain(self, timeout_s: float = 5.0) -> None:
        """Wait until every submitted entry has been handed to
        `prefetch_fn` (test/bench helper — production callers never wait)."""
        tick = threading.Event()
        waited = 0.0
        while self._processed < self.stats["submitted"] and waited < timeout_s:
            tick.wait(0.01)
            waited += 0.01

    def close(self) -> None:
        with self._mu:
            self._closed = True
            thread = self._thread
        if thread is not None and thread.is_alive():
            self._q.put(None)
            thread.join(timeout=5.0)
        self._thread = None
