"""Fleet-wide memory accounting: the governor's measurement plane.

Copy of the reference package's `resourcegov/accountant.py`.

Every stateful structure in the control plane — index shards, chain
memo, prefix store, session table, popularity sketch/top-K, obs rings,
per-pod tracker maps, per-peer transfer state — registers a **meter**
here: a name from the fixed `RESOURCE_STRUCTURES` vocabulary, an O(1)
entry count, a bytes estimate, and (for the sheddable structures) a
`shed(fraction)` hook plus an optional bounded `restore()` step.

The accountant only *measures and delegates*: it never decides when to
shed (that is the governor's pressure state machine) and it never
reaches into an owner's internals — owners publish exactly the hooks
they are willing to have actuated, the same opt-in contract the
autopilot's KnobRegistry established. Every read is exception-guarded:
a meter whose owner is mid-teardown reads as empty, never takes the
governor down with it.

Bytes are *estimates by design* (entries x a per-entry constant the
owner supplies, plus a fixed floor for constant-size structures like
the count-min sketch). The governor's budget is a policy ceiling over
this accounted sum — an RSS probe is available as a sanity cross-check,
but the actuation signal is the accounted bytes, which are
deterministic under an injected clock.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("resourcegov.accountant")

# Fixed structure-name vocabulary — the only values the
# kvcache_resource_accounted_bytes / kvcache_resource_shed_events_total
# `structure` label may carry (pinned in tests/test_metrics_hygiene.py).
# Each name is owned by exactly one subsystem's meter registration.
STRUCT_OBS = "obs"
STRUCT_SESSIONS = "sessions"
STRUCT_POPULARITY = "popularity"
STRUCT_CHAIN_MEMO = "chain_memo"
STRUCT_PREFIX_STORE = "prefix_store"
STRUCT_INDEX = "index"
STRUCT_FLEETHEALTH = "fleethealth"
STRUCT_LOAD = "load"
STRUCT_ANTIENTROPY = "antientropy"
STRUCT_TRANSFER_PEERS = "transfer_peers"
STRUCT_NEGATIVE_CACHE = "negative_cache"
RESOURCE_STRUCTURES = (
    STRUCT_OBS,
    STRUCT_SESSIONS,
    STRUCT_POPULARITY,
    STRUCT_CHAIN_MEMO,
    STRUCT_PREFIX_STORE,
    STRUCT_INDEX,
    STRUCT_FLEETHEALTH,
    STRUCT_LOAD,
    STRUCT_ANTIENTROPY,
    STRUCT_TRANSFER_PEERS,
    STRUCT_NEGATIVE_CACHE,
)


@dataclass
class Meter:
    """One structure's accounting contract.

    `entries` must be O(1)-cheap (the governor polls every meter each
    tick). `bytes_per_entry` is the owner's honest per-entry estimate;
    `fixed_bytes` covers constant-size state (a sketch's rows) that
    exists whether or not any entry does. `shed(fraction)` drops up to
    that fraction of entries — never in-flight state (pending prefetch
    jobs, sessions with outstanding prefetches, open breaker rows for
    live peers) — and returns how
    many entries it actually dropped. `restore()` takes one bounded
    step back toward the structure's baseline (index capacity walking
    home) and returns True while more steps remain.
    """

    name: str
    entries: Callable[[], int]
    bytes_per_entry: float = 0.0
    fixed_bytes: float = 0.0
    nbytes: Optional[Callable[[], int]] = None
    shed: Optional[Callable[[float], int]] = None
    restore: Optional[Callable[[], bool]] = None

    def __post_init__(self):
        if self.name not in RESOURCE_STRUCTURES:
            raise ValueError(
                f"unknown structure name {self.name!r} "
                "(not in RESOURCE_STRUCTURES)"
            )
        if self.bytes_per_entry < 0 or self.fixed_bytes < 0:
            raise ValueError(f"{self.name}: byte estimates must be >= 0")

    def read(self) -> Dict[str, float]:
        """{entries, bytes} — exception-guarded (an owner mid-teardown
        reads as empty, never unwinds the governor's tick)."""
        try:
            n = int(self.entries())
        except Exception:  # noqa: BLE001 - measurement must never throw
            n = 0
        if self.nbytes is not None:
            try:
                b = float(self.nbytes())
            except Exception:  # noqa: BLE001
                b = 0.0
        else:
            b = n * self.bytes_per_entry + self.fixed_bytes
        return {"entries": n, "bytes": b}


class ResourceAccountant:
    """Registry of meters; the governor's only measurement handle.

    Owners opt in by registering a meter (nothing unregistered is
    visible or sheddable); duplicate names are an error — one owner per
    structure, same as the knob registry.
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._meters: Dict[str, Meter] = {}
        self.stats_counters = {"sheds": 0, "entries_shed": 0}

    def register(self, meter: Meter) -> Meter:
        with self._mu:
            if meter.name in self._meters:
                raise ValueError(
                    f"meter {meter.name!r} already registered"
                )
            self._meters[meter.name] = meter
        logger.info(
            "resource meter registered: %s (bytes/entry=%g fixed=%g "
            "sheddable=%s)",
            meter.name, meter.bytes_per_entry, meter.fixed_bytes,
            meter.shed is not None,
        )
        return meter

    def get(self, name: str) -> Optional[Meter]:
        with self._mu:
            return self._meters.get(name)

    def names(self) -> List[str]:
        with self._mu:
            return sorted(self._meters)

    def snapshot(self, publish: bool = False) -> Dict[str, Dict[str, float]]:
        """{structure: {entries, bytes}} over every registered meter.
        With `publish`, each structure's bytes land on the accounted-
        bytes gauge (the governor's tick path; ad-hoc status reads keep
        the metric untouched)."""
        with self._mu:
            meters = list(self._meters.values())
        out: Dict[str, Dict[str, float]] = {}
        for meter in meters:
            doc = meter.read()
            out[meter.name] = doc
            if publish:
                metrics.set_resource_accounted_bytes(
                    meter.name, doc["bytes"]
                )
        return out

    def total_bytes(self) -> float:
        return sum(d["bytes"] for d in self.snapshot().values())

    def shed(self, name: str, fraction: float) -> int:
        """Actuate one structure's shed hook; returns entries dropped
        (0 when the meter is absent, hook-less, or empty). Exception-
        guarded like every other owner crossing."""
        meter = self.get(name)
        if meter is None or meter.shed is None:
            return 0
        try:
            dropped = int(meter.shed(fraction))
        except Exception as e:  # noqa: BLE001 - a failing owner must not
            logger.warning("shed(%s, %.2f) failed: %s", name, fraction, e)
            return 0
        if dropped:
            with self._mu:
                self.stats_counters["sheds"] += 1
                self.stats_counters["entries_shed"] += dropped
            metrics.count_shed_event(name)
        return dropped

    def restore_step(self, name: str) -> bool:
        """One bounded restore step; True while more steps remain."""
        meter = self.get(name)
        if meter is None or meter.restore is None:
            return False
        try:
            return bool(meter.restore())
        except Exception as e:  # noqa: BLE001
            logger.warning("restore(%s) failed: %s", name, e)
            return False


def shed_lru_oldest(cache, fraction: float) -> int:
    """Drop the oldest `fraction` of an LRUCache's entries — the shared
    shed shape for the chain memo and prefix store (utils/lru.py keys()
    is oldest-first). Returns entries removed."""
    keys = cache.keys()
    n = int(len(keys) * min(max(fraction, 0.0), 1.0))
    removed = 0
    for key in keys[:n]:
        if cache.remove(key):
            removed += 1
    return removed
