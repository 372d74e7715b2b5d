"""Fetch-miss feedback: the data plane correcting the control plane.

Copy of the reference package's `antientropy/feedback.py`. Every peer fetch is
an unintentional audit: the index advertised that a peer holds a block (that is
why the resolver picked it), and the peer's per-block answer is ground truth.
When the answer is "missing" (`-2` on the wire — the peer is healthy and
explicitly disclaims the block), the advertisement was phantom, and this module
repairs the index the moment the evidence exists instead of letting every later
request re-discover it the same expensive way.

The purge is targeted (`Index.remove_entries`) and extends down the
fetched run's suffix: KV-block chains are usable only as leading
prefixes, so a block missing at position k makes the same pod's
advertised placements for positions k+1.. unreachable through it — they
are purged in the same call rather than waiting to miss one by one.

Evidence discipline: an observation is only charged as divergence when
the index ACTUALLY advertised the (pod, block) placement — `purged > 0`.
A local membership probe for a block nobody indexed answers "missing"
too, and that is not a lie, it is a miss; charging it would poison the
trust EWMA with noise. Purges are host-tier-scoped by default: a "not
staged" answer proves the pod's *fetchable* copy is gone, while its
device-tier entry (the engine's own HBM residency) is separate evidence
the residency auditor checks directly.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("antientropy.feedback")

# Host-family tiers a transfer server's "missing" answer disproves (the
# fetchable staging tiers; GPU-era alias included, backend.py precedent).
HOST_TIERS = frozenset({"host", "cpu"})


class FetchMissFeedback:
    """Wire this as a TransferClient's `on_fetch_misses` callback (via
    the embedder, which knows the peer-address → pod map)."""

    def __init__(
        self,
        index,
        model_name: str,
        pod_for_addr: Callable[[Tuple[str, int]], Optional[str]],
        tracker=None,
        device_tiers: Optional[frozenset] = HOST_TIERS,
    ):
        self.index = index
        self.model_name = model_name
        self.pod_for_addr = pod_for_addr
        # Optional AntiEntropyTracker: charged only for confirmed
        # divergence (purged > 0).
        self.tracker = tracker
        self.device_tiers = device_tiers
        self._mu = threading.Lock()
        self.stats = {"events": 0, "divergent_blocks": 0, "purged_entries": 0}

    def on_fetch_misses(
        self,
        host: str,
        port: int,
        hashes: List[int],
        missing: List[int],
    ) -> int:
        """One fetch round trip's explicit-miss evidence: `hashes` is the
        chain run requested, `missing` the subset the peer disclaimed.
        Returns the number of index entries purged."""
        if not missing:
            return 0
        pod = self.pod_for_addr((host, port))
        if pod is None:
            return 0
        missing_set = set(missing)
        first = next(
            (i for i, h in enumerate(hashes) if h in missing_set), None
        )
        if first is None:
            return 0
        # The missed block plus the run's advertised suffix behind it —
        # unreachable through this pod either way.
        suffix = [Key(self.model_name, h) for h in hashes[first:]]
        try:
            purged = self.index.remove_entries(
                pod, suffix, device_tiers=self.device_tiers
            )
        except Exception as e:  # noqa: BLE001 - repair must not unwind a fetch
            logger.warning(
                "fetch-miss purge for pod %s failed: %s", pod, e
            )
            return 0
        with self._mu:
            self.stats["events"] += 1
            if purged:
                self.stats["divergent_blocks"] += len(missing_set)
                self.stats["purged_entries"] += purged
        if purged:
            logger.info(
                "fetch-miss feedback: pod %s disclaimed %d advertised "
                "block(s); purged %d index entr%s (chain suffix of %d)",
                pod, len(missing_set), purged,
                "y" if purged == 1 else "ies", len(suffix),
            )
            if self.tracker is not None:
                self.tracker.observe_fetch_miss(
                    pod, blocks=len(missing_set), purged=purged
                )
        return purged

    def status(self) -> dict:
        with self._mu:
            return dict(self.stats)
