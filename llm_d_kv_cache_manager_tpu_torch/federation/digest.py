"""RegionDigest: the compact approximate state one region ships to peers.

Copy of the reference package's `federation/digest.py`.

The global tier routes on *approximate prefix affinity* — the precise
index never leaves its region, so what crosses the WAN is exactly what
the count-min popularity machinery already maintains per fleet
(placement/popularity.py):

- the decayed **sketch rows** (decayed-now units, quantized to millis on
  the wire): any peer can probe `estimate(block_hash)` for the leading
  blocks of an incoming request and read "how hot is this prefix over
  there" without a single precise entry travelling,
- the **top-K hot chains** (head, score, bounded prefix hashes + token
  slice): the candidate set for cross-region replication through the
  `warm_chain` admission seam — the token slice is what a remote engine
  needs to land the prefix,
- aggregate **pods/load**: the blend inputs for the region pick.

Encoding is the repo's canonical CBOR subset (utils/cbor.py — the same
codec the cluster snapshot rides), framed magic+version up front with a
hard `DigestFormatError` on mismatch, so a rolling upgrade can never
half-read a foreign format. Sketch cells are quantized to 1/1000 units
(`_ROW_SCALE`) as unsigned ints: a typical mostly-zero sketch encodes in
one byte per cold cell, and popularity estimates are approximate by
construction — the quantization error (≤0.0005) is orders of magnitude
below any sensible hotness threshold.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.placement.popularity import (
    ChainPopularityTracker,
    estimate_from_rows,
)
from llm_d_kv_cache_manager_tpu_torch.utils import cbor

DIGEST_MAGIC = b"KVTPUDGST"
DIGEST_VERSION = 1

# Wire quantization of sketch cells: value -> round(value * _ROW_SCALE) as
# a CBOR uint. Chosen so cold cells cost one byte and the rounding error
# (0.0005) stays far below replication/hotness thresholds.
_ROW_SCALE = 1000


class DigestFormatError(ValueError):
    """Bad magic, unknown version, or malformed CBOR in a region digest."""


@dataclass
class HotChainDigest:
    """One hot chain as it travels: identity + what a remote warm-up needs."""

    head: int
    score: float
    model_name: str
    extra: Tuple[int, ...] = ()
    prefix_hashes: List[int] = field(default_factory=list)
    prefix_tokens: List[int] = field(default_factory=list)


@dataclass
class RegionDigest:
    """A region's shipped approximate state at `created_ts`."""

    region_id: str
    created_ts: float
    seq: int  # per-producer monotonic; the staleness tracker's wire seq
    pods: int  # serving pods behind the region's precise front
    load: float  # region load index (0 = idle; producer-normalized)
    sketch_width: int
    sketch_depth: int
    half_life_s: float
    rows: List[List[float]]  # decayed-now units at created_ts
    hot_chains: List[HotChainDigest] = field(default_factory=list)

    def estimate(self, block_hash: int) -> float:
        """Count-min popularity estimate of one block in this region (an
        overestimate, never under — same contract as the local sketch)."""
        if not self.rows:
            return 0.0
        return estimate_from_rows(self.rows, self.sketch_width, block_hash)

    def affinity(
        self, block_hashes: Sequence[int], max_blocks: int = 32
    ) -> float:
        """Approximate prefix affinity: mean sketch estimate over the
        request's leading block hashes. Mean (not sum) so affinity is
        comparable across requests of different lengths; leading blocks
        only because the shared prefix — the thing worth routing on — is
        a prefix property, and a private tail should not dilute it."""
        if not block_hashes:
            return 0.0
        lead = block_hashes[:max_blocks]
        return sum(self.estimate(h) for h in lead) / len(lead)

    def age_s(self, now: Optional[float] = None) -> float:
        return max(0.0, (time.time() if now is None else now) - self.created_ts)


def build_digest(
    region_id: str,
    tracker: ChainPopularityTracker,
    *,
    seq: int,
    pods: int = 0,
    load: float = 0.0,
    hot_k: int = 8,
    max_prefix_blocks: int = 64,
    now: Optional[float] = None,
) -> RegionDigest:
    """Snapshot `tracker` into a digest. `now` must be the tracker's own
    clock domain (sim time under a simulated clock)."""
    if now is None:
        now = tracker.clock()
    sketch = tracker.export_sketch(now)
    hot = tracker.hot_chains(0.0, now=now)[:hot_k]

    def bounded_tokens(c):
        # Token slice bounded to MATCH the shipped hash slice: the
        # tracker knows its block size only implicitly (tokens/hashes),
        # so derive it — a digest must never ship more warmable tokens
        # than the prefix it advertises.
        if not c.prefix_hashes or not c.prefix_tokens:
            return list(c.prefix_tokens)
        per_block = max(len(c.prefix_tokens) // len(c.prefix_hashes), 1)
        return list(c.prefix_tokens[: max_prefix_blocks * per_block])

    return RegionDigest(
        region_id=region_id,
        created_ts=now,
        seq=seq,
        pods=pods,
        load=load,
        sketch_width=sketch["width"],
        sketch_depth=sketch["depth"],
        half_life_s=sketch["half_life_s"],
        rows=sketch["rows"],
        hot_chains=[
            HotChainDigest(
                head=c.head,
                score=c.score,
                model_name=c.model_name,
                extra=tuple(c.extra),
                prefix_hashes=list(c.prefix_hashes[:max_prefix_blocks]),
                prefix_tokens=bounded_tokens(c),
            )
            for c in hot
        ],
    )


# -- wire codec ---------------------------------------------------------------
# [version, region_id, created_ts, seq, pods, load,
#  width, depth, half_life_s,
#  [[cell_millis, ...] per row],
#  [[head, score, model, [extra...], [hashes...], [tokens...]], ...]]


def encode_digest(d: RegionDigest) -> bytes:
    doc = [
        DIGEST_VERSION,
        d.region_id,
        float(d.created_ts),
        int(d.seq),
        int(d.pods),
        float(d.load),
        int(d.sketch_width),
        int(d.sketch_depth),
        float(d.half_life_s),
        [
            [int(round(v * _ROW_SCALE)) for v in row]
            for row in d.rows
        ],
        [
            [
                int(c.head),
                float(c.score),
                c.model_name,
                [int(e) for e in c.extra],
                [int(h) for h in c.prefix_hashes],
                [int(t) for t in c.prefix_tokens],
            ]
            for c in d.hot_chains
        ],
    ]
    out = bytearray(DIGEST_MAGIC)
    cbor.encode_into(doc, out)
    return bytes(out)


def decode_digest(data: bytes) -> RegionDigest:
    if not data.startswith(DIGEST_MAGIC):
        raise DigestFormatError("not a KVTPU region digest (bad magic)")
    try:
        doc, end = cbor.decode(data, len(DIGEST_MAGIC))
    except cbor.CborDecodeError as e:
        raise DigestFormatError(str(e)) from None
    if end != len(data):
        raise DigestFormatError(f"{len(data) - end} trailing byte(s)")
    if not isinstance(doc, list) or len(doc) != 11:
        raise DigestFormatError("malformed digest document")
    version = doc[0]
    if version != DIGEST_VERSION:
        raise DigestFormatError(
            f"unsupported digest version {version} "
            f"(this build reads version {DIGEST_VERSION})"
        )
    width, depth = int(doc[6]), int(doc[7])
    rows = [[cell / _ROW_SCALE for cell in row] for row in doc[9]]
    if len(rows) != depth or any(len(row) != width for row in rows):
        raise DigestFormatError(
            f"sketch rows do not match the declared {depth}x{width} shape"
        )
    try:
        chains = [
            HotChainDigest(
                head=int(head),
                score=float(score),
                model_name=model,
                extra=tuple(int(e) for e in extra),
                prefix_hashes=[int(h) for h in hashes],
                prefix_tokens=[int(t) for t in tokens],
            )
            for head, score, model, extra, hashes, tokens in doc[10]
        ]
    except (TypeError, ValueError) as e:
        raise DigestFormatError(f"malformed hot-chain entry: {e}") from None
    return RegionDigest(
        region_id=doc[1],
        created_ts=float(doc[2]),
        seq=int(doc[3]),
        pods=int(doc[4]),
        load=float(doc[5]),
        sketch_width=width,
        sketch_depth=depth,
        half_life_s=float(doc[8]),
        rows=rows,
        hot_chains=chains,
    )
