"""Decayed chain-popularity tracking for predictive placement.

The read path already touches every signal hot-prefix detection needs: each
`Indexer.get_pod_scores_ex` call derives the prompt's block-hash chain — whose
head identifies the shared prefix (a tenant's system prompt, a tool preamble)
and already incorporates the tenant/LoRA extra key (hashing.py mixes the
adapter id into every hash, so two tenants' identical token streams have
disjoint chains *and* disjoint popularity buckets by construction). The write
plane sees the complementary signal: which chains the fleet keeps re-storing.

This module turns those observations into a space-bounded popularity model:

- a **decayed count-min sketch** over block hashes — O(width × depth) floats
  regardless of tenant count, with exponential half-life decay applied via a
  global scaling factor (one multiply per read, no timer threads, no
  full-table decay sweeps). This is the per-*block* score the cost-aware
  index weighs at eviction time.
- a **top-K heavy-hitters table** over chain heads — the candidate set the
  replicator polls. Admission is sketch-guided (a newcomer displaces the
  coldest resident only when its estimate exceeds the resident's decayed
  score), so the table converges on the true heavy hitters without ever
  growing past K entries. Entries retain a bounded prefix (hashes + tokens)
  of the most recent observation — exactly what a replication job needs to
  warm a target pod.

Everything is driven by an injected clock and guarded by one mutex: no
threads, deterministic under simulated time, and cheap enough for the read
path (observe cost is O(min(chain, max_prefix_blocks) × depth) integer ops,
paid only when placement is enabled — a disabled tracker is `None` and costs
one attribute check).
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_TOP_K = 64
DEFAULT_SKETCH_WIDTH = 4096
DEFAULT_SKETCH_DEPTH = 4
DEFAULT_HALF_LIFE_S = 120.0

# Odd multipliers for the sketch's row hashes (splitmix64-style finalizer
# constants); depth is capped by the number of rows provided here.
_ROW_SALTS = (
    0x9E3779B97F4A7C15,
    0xBF58476D1CE4E5B9,
    0x94D049BB133111EB,
    0xD6E8FEB86659FD93,
    0xA24BAED4963EE407,
    0xC2B2AE3D27D4EB4F,
)
_MASK64 = 0xFFFFFFFFFFFFFFFF
# Renormalization ceiling for the global decay multiplier: past this, every
# cell is scaled down once and the multiplier resets — keeps floats finite
# over arbitrarily long uptimes.
_RESCALE_LIMIT = 2.0**64


def sketch_cells(item: int, width: int, depth: int):
    """Yield the (row, column) cells of `item` in a (width × depth) sketch.

    Module-level so a shipped sketch (federation/digest.py carries the raw
    rows in decayed-now units) can be probed WITHOUT constructing a
    `DecayedCountMinSketch` — the cell mapping is the wire contract between
    an exporting region and every remote reader, and must stay identical on
    both sides.
    """
    for d in range(min(depth, len(_ROW_SALTS))):
        h = ((item ^ _ROW_SALTS[d]) * 0x100000001B3) & _MASK64
        h ^= h >> 29
        yield d, h % width


def estimate_from_rows(
    rows: Sequence[Sequence[float]], width: int, item: int
) -> float:
    """Count-min estimate of `item` over exported rows (decayed-now units,
    the form `DecayedCountMinSketch.export` produces)."""
    return min(rows[d][i] for d, i in sketch_cells(item, width, len(rows)))


@dataclass
class PopularityConfig:
    """Knobs of the tracker; all bounds are hard (space never grows past
    them no matter how many tenants/chains the fleet serves)."""

    top_k: int = DEFAULT_TOP_K
    sketch_width: int = DEFAULT_SKETCH_WIDTH
    sketch_depth: int = DEFAULT_SKETCH_DEPTH
    # Exponential decay half-life: a chain untouched for one half-life
    # keeps half its score. Hotness is therefore a *rate*, not a lifetime
    # count — yesterday's hot tenant drains out of the top-K on its own.
    half_life_s: float = DEFAULT_HALF_LIFE_S
    # Per-entry retained prefix bound: replication jobs push at most this
    # many leading blocks of a hot chain (and the matching token slice).
    max_prefix_blocks: int = 64
    # Weight of a write-plane (BlockStored) observation relative to a
    # read-path route observation.
    store_weight: float = 0.25


class DecayedCountMinSketch:
    """Count-min sketch with exponential half-life decay.

    Decay is implemented by *inflating new increments* instead of deflating
    old cells: at time t an increment adds `2^((t - t0)/half_life)` and a
    read divides by the same factor, so every cell decays exponentially
    without ever being touched again. When the inflation factor approaches
    float limits, all cells are rescaled once (amortized O(1) per add).
    Not thread-safe on its own — the tracker's mutex serializes access.
    """

    def __init__(self, width: int, depth: int, half_life_s: float):
        if width <= 0 or depth <= 0:
            raise ValueError("sketch width/depth must be positive")
        self.width = width
        self.depth = min(depth, len(_ROW_SALTS))
        self.half_life_s = max(half_life_s, 1e-9)
        self.rows: List[List[float]] = [
            [0.0] * width for _ in range(self.depth)
        ]
        self._t0: Optional[float] = None

    def _factor(self, now: float) -> float:
        if self._t0 is None:
            self._t0 = now
        return 2.0 ** ((now - self._t0) / self.half_life_s)

    def _rescale(self, factor: float) -> float:
        inv = 1.0 / factor
        for row in self.rows:
            for i, v in enumerate(row):
                row[i] = v * inv
        self._t0 = None
        return 1.0

    def _cells(self, item: int):
        return sketch_cells(item, self.width, self.depth)

    def add(self, item: int, amount: float, now: float) -> float:
        """Credit `amount` (decayed-now units) to `item`; returns the new
        decayed estimate."""
        factor = self._factor(now)
        if factor > _RESCALE_LIMIT:
            factor = self._rescale(factor)
            factor = self._factor(now)
        inc = amount * factor
        est = math.inf
        for d, i in self._cells(item):
            v = self.rows[d][i] + inc
            self.rows[d][i] = v
            if v < est:
                est = v
        return est / factor

    def estimate(self, item: int, now: float) -> float:
        """Decayed count-min estimate (an overestimate, never under)."""
        factor = self._factor(now)
        est = min(self.rows[d][i] for d, i in self._cells(item))
        return est / factor

    def export(self, now: float) -> List[List[float]]:
        """Rows normalized to decayed-now units — the inflation factor is
        divided out, so the exported cells read directly as decayed counts
        at `now` and mean the same thing to any remote reader regardless of
        either side's `_t0`. This is what a `RegionDigest` ships; probe it
        with `estimate_from_rows`."""
        factor = self._factor(now)
        inv = 1.0 / factor
        return [[v * inv for v in row] for row in self.rows]

    def merge(
        self, rows: Sequence[Sequence[float]], now: float, scale: float = 1.0
    ) -> None:
        """Fold exported rows (decayed-now units at `now`) into this
        sketch, cell-wise, scaled by `scale`. Requires identical (width,
        depth) — the cell mapping is position-dependent, so merging
        mismatched shapes would silently corrupt every estimate."""
        if len(rows) != self.depth or any(
            len(row) != self.width for row in rows
        ):
            raise ValueError(
                f"sketch shape mismatch: merging {len(rows)} rows of "
                f"{len(rows[0]) if rows else 0} cells into a "
                f"{self.depth}x{self.width} sketch"
            )
        factor = self._factor(now)
        if factor > _RESCALE_LIMIT:
            factor = self._rescale(factor)
            factor = self._factor(now)
        for d, row in enumerate(rows):
            mine = self.rows[d]
            for i, v in enumerate(row):
                if v:
                    mine[i] += v * scale * factor


@dataclass
class ChainStat:
    """One top-K resident: a chain head plus what a replication job needs."""

    head: int
    extra: Tuple[int, ...]  # tenant/LoRA extra key tuple (() = base traffic)
    model_name: str
    score: float  # decayed score at `last_seen`
    last_seen: float
    prefix_hashes: List[int] = field(default_factory=list)
    prefix_tokens: List[int] = field(default_factory=list)
    observations: int = 0

    def decayed_score(self, now: float, half_life_s: float) -> float:
        dt = max(now - self.last_seen, 0.0)
        return self.score * (2.0 ** (-dt / half_life_s))


class ChainPopularityTracker:
    """Space-bounded hot-prefix detector fed from the read and write planes.

    `observe_route` (read path) credits the chain head in the top-K table
    and every retained prefix block in the sketch; `observe_store` (write
    plane) and `observe_lookup` (instrumented index) credit blocks in the
    sketch only — they carry no chain-head identity. All methods take an
    optional `now` so simulated clocks drive decay deterministically.
    """

    def __init__(
        self,
        config: Optional[PopularityConfig] = None,
        clock=time.monotonic,
    ):
        self.config = config or PopularityConfig()
        if self.config.top_k <= 0:
            raise ValueError("top_k must be positive")
        self.clock = clock
        self.sketch = DecayedCountMinSketch(
            self.config.sketch_width,
            self.config.sketch_depth,
            self.config.half_life_s,
        )
        self._chains: Dict[int, ChainStat] = {}
        self._mu = threading.Lock()
        self.stats_counters = {
            "route_observations": 0,
            "store_observations": 0,
            "lookup_observations": 0,
            "admissions": 0,
            "displacements": 0,
            "rejected_cold": 0,
            "shed_chains": 0,
        }

    # -- ingest ------------------------------------------------------------

    def observe_route(
        self,
        block_hashes: Sequence[int],
        tokens: Optional[Sequence[int]] = None,
        lora_id: Optional[int] = None,
        model_name: str = "",
        block_size: int = 0,
        now: Optional[float] = None,
    ) -> None:
        """One routed request for this chain (read path). `tokens` and
        `block_size` let the top-K entry retain the prefix token slice a
        replication warm-up needs; hashes alone still track popularity."""
        if not block_hashes:
            return
        if now is None:
            now = self.clock()
        cfg = self.config
        prefix = list(block_hashes[: cfg.max_prefix_blocks])
        extra = () if lora_id is None else (int(lora_id),)
        with self._mu:
            self.stats_counters["route_observations"] += 1
            for h in prefix:
                self.sketch.add(h, 1.0, now)
            self._credit_chain(
                prefix[0], extra, model_name, 1.0, now,
                prefix_hashes=prefix,
                prefix_tokens=(
                    list(tokens[: len(prefix) * block_size])
                    if tokens is not None and block_size > 0
                    else None
                ),
                block_size=block_size,
            )

    def observe_store(
        self,
        block_hashes: Sequence[int],
        now: Optional[float] = None,
    ) -> None:
        """BlockStored digests (write plane): fleet-wide re-store traffic
        is reuse evidence at block granularity — no chain head is known
        (stores chain off arbitrary parents), so only the sketch learns."""
        if not block_hashes:
            return
        if now is None:
            now = self.clock()
        w = self.config.store_weight
        with self._mu:
            self.stats_counters["store_observations"] += 1
            for h in block_hashes[: self.config.max_prefix_blocks]:
                self.sketch.add(h, w, now)

    def observe_lookup(
        self,
        hit_hashes: Sequence[int],
        now: Optional[float] = None,
    ) -> None:
        """Index-lookup hits (InstrumentedIndex ingest hook): blocks that
        keep getting looked up *and found* are the ones worth keeping."""
        if not hit_hashes:
            return
        if now is None:
            now = self.clock()
        with self._mu:
            self.stats_counters["lookup_observations"] += 1
            for h in hit_hashes[: self.config.max_prefix_blocks]:
                self.sketch.add(h, 1.0, now)

    def _credit_chain(
        self,
        head: int,
        extra: Tuple[int, ...],
        model_name: str,
        amount: float,
        now: float,
        prefix_hashes: Optional[List[int]] = None,
        prefix_tokens: Optional[List[int]] = None,
        block_size: int = 0,
    ) -> None:
        half_life = self.config.half_life_s
        stat = self._chains.get(head)
        if stat is not None:
            stat.score = stat.decayed_score(now, half_life) + amount
            stat.last_seen = now
            stat.observations += 1
            if prefix_hashes and stat.prefix_hashes:
                # Refine toward the SHARED prefix: different requests under
                # the same chain head agree exactly on the common part
                # (the tenant's system prompt) and diverge after it, so the
                # running common prefix converges on what is actually worth
                # replicating — one session's private tail never rides a
                # replication job to pods that can't use it.
                n = 0
                for a, b in zip(stat.prefix_hashes, prefix_hashes):
                    if a != b:
                        break
                    n += 1
                if 0 < n < len(stat.prefix_hashes):
                    stat.prefix_hashes = stat.prefix_hashes[:n]
                    if stat.prefix_tokens and block_size > 0:
                        stat.prefix_tokens = stat.prefix_tokens[
                            : n * block_size
                        ]
            if prefix_tokens is not None and not stat.prefix_tokens:
                stat.prefix_tokens = prefix_tokens[
                    : len(stat.prefix_hashes) * block_size
                ] if block_size > 0 else prefix_tokens
            return
        estimate = self.sketch.estimate(head, now)
        if len(self._chains) >= self.config.top_k:
            coldest_head, coldest = min(
                self._chains.items(),
                key=lambda kv: kv[1].decayed_score(now, half_life),
            )
            if estimate <= coldest.decayed_score(now, half_life):
                self.stats_counters["rejected_cold"] += 1
                return
            del self._chains[coldest_head]
            self.stats_counters["displacements"] += 1
        self.stats_counters["admissions"] += 1
        self._chains[head] = ChainStat(
            head=head,
            extra=extra,
            model_name=model_name,
            score=max(estimate, amount),
            last_seen=now,
            prefix_hashes=list(prefix_hashes or [head]),
            prefix_tokens=list(prefix_tokens or []),
            observations=1,
        )

    def shed(self, fraction: float) -> int:
        """Resource-governor hook: drop the coldest `fraction` of the
        top-K table (by decayed score at shed time) and scale every
        sketch cell down by the same fraction — popularity is a decayed
        rate, so a uniform down-scale is indistinguishable from letting
        extra half-lives elapse; genuinely hot chains re-earn their
        admission within a few observations. Returns chains dropped."""
        fraction = min(max(fraction, 0.0), 1.0)
        now = self.clock()
        half_life = self.config.half_life_s
        with self._mu:
            n = int(len(self._chains) * fraction)
            if n > 0:
                by_cold = sorted(
                    self._chains.items(),
                    key=lambda kv: kv[1].decayed_score(now, half_life),
                )
                for head, _ in by_cold[:n]:
                    del self._chains[head]
                self.stats_counters["shed_chains"] += n
            if fraction > 0.0 and fraction < 1.0:
                # Equivalent to _rescale's renormalization, with a decay
                # multiplier instead of an inflation reset.
                keep = 1.0 - fraction
                for row in self.sketch.rows:
                    for i, v in enumerate(row):
                        if v:
                            row[i] = v * keep
            elif fraction >= 1.0:
                for row in self.sketch.rows:
                    for i in range(len(row)):
                        row[i] = 0.0
            return n

    def entries(self) -> int:
        """Tracked top-K chains — the resource accountant's O(1) meter
        read (sketch rows are its constant `fixed_bytes` floor)."""
        with self._mu:
            return len(self._chains)

    # -- queries -----------------------------------------------------------

    def hot_chains(
        self, threshold: float, now: Optional[float] = None
    ) -> List[ChainStat]:
        """Top-K residents whose decayed score crosses `threshold`, hottest
        first. Returned ChainStats are snapshots (safe to hold across
        ticks); `score` is the decayed value at `now`."""
        if now is None:
            now = self.clock()
        half_life = self.config.half_life_s
        out = []
        with self._mu:
            for stat in self._chains.values():
                s = stat.decayed_score(now, half_life)
                if s >= threshold:
                    out.append(
                        ChainStat(
                            head=stat.head,
                            extra=stat.extra,
                            model_name=stat.model_name,
                            score=s,
                            last_seen=stat.last_seen,
                            prefix_hashes=list(stat.prefix_hashes),
                            prefix_tokens=list(stat.prefix_tokens),
                            observations=stat.observations,
                        )
                    )
        out.sort(key=lambda c: (-c.score, c.head))
        return out

    def chain(self, head: int) -> Optional[ChainStat]:
        with self._mu:
            return self._chains.get(head)

    def block_score(self, chunk_hash: int, now: Optional[float] = None) -> float:
        """Decayed popularity estimate for one block — the signal the
        cost-aware index weighs against re-derivation/transfer cost when
        choosing eviction victims. Count-min overestimates, never under:
        a genuinely hot block can't read cold."""
        if now is None:
            now = self.clock()
        with self._mu:
            return self.sketch.estimate(chunk_hash, now)

    def export_sketch(self, now: Optional[float] = None) -> dict:
        """Snapshot the sketch for digest shipping: shape + half-life +
        rows in decayed-now units (see `DecayedCountMinSketch.export`).
        The returned rows are copies — safe to encode off-lock."""
        if now is None:
            now = self.clock()
        with self._mu:
            return {
                "width": self.sketch.width,
                "depth": self.sketch.depth,
                "half_life_s": self.sketch.half_life_s,
                "rows": self.sketch.export(now),
            }

    def merge_sketch(
        self,
        rows: Sequence[Sequence[float]],
        now: Optional[float] = None,
        scale: float = 1.0,
    ) -> None:
        """Fold a peer's exported rows into this tracker's sketch (an
        aggregator building a fleet-of-fleets view). Top-K chain identity
        does not travel in rows — only block popularity merges."""
        if now is None:
            now = self.clock()
        with self._mu:
            self.sketch.merge(rows, now, scale=scale)

    def stats(self) -> dict:
        with self._mu:
            return {
                "tracked_chains": len(self._chains),
                "top_k": self.config.top_k,
                "sketch_width": self.sketch.width,
                "sketch_depth": self.sketch.depth,
                "half_life_s": self.config.half_life_s,
                **self.stats_counters,
            }
