"""Deterministic fault injection for the KV-block TRANSFER plane.

Copy of the reference package's `kv_connectors/faults.py`; the seeded
corruption draw uses the port's own `fnv64a`, so both packages damage the
same blocks.

The write-plane injector (fleethealth/faults.py) chaos-tests the event
seam; this module does the same for the data plane. Faults are injected at
the transfer-client seam — the exact boundary where `TieredKVStore` and the
prefetcher hand fetches to a `TransferClient` — so everything downstream of
a fault (integrity fallback, per-peer breakers, hedged fetches, chain-cut
recompute, the counters) is the REAL code path under test.

Fault classes (per peer address, composable, clock-windowed):

- **corrupt**: a fetched block is corrupted iff a seeded hash of
  (plan seed, peer, block hash) falls under `corrupt_rate` — a
  deterministic "bad cells" model: the same blocks are always the damaged
  ones, independent of fetch order, so a chaos run replays bit-for-bit
  even though the event pool's worker interleaving varies. With integrity
  verification ON (the default) the corruption is *detected*: the block
  degrades to a miss through `TransferClient.note_result` — the same seam
  the C++ client's checksum mismatch reports through — and the breaker
  learns about it. With verification OFF the corrupted payload is
  DELIVERED and counted in `corrupt_admitted`: the silent wrong-KV-bytes
  failure mode the end-to-end checksum exists to kill (the chaos bench's
  control arm).
- **stall**: fetches in the window hang until the IO timeout ladder
  expires, then fail. The injector synthesizes the outcome instantly but
  charges the full `io_timeout * attempts` latency through `charge_s` (the
  bench adds it to the serving clock) and reports the failure to the
  breaker — which is what makes "breaker open ⇒ skip instantly" measurable.
- **blackhole**: connects hang (packets dropped); same shape with the
  connect-timeout ladder.
- **flap**: the peer alternates up/down with `flap_period_s` /
  `flap_down_frac` — the breaker's half-open probe recovery is exercised on
  every up transition.

Everything is driven by an injected clock and seeded hashing, so a chaos
run is a pure function of (plan, workload) and replays bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.hashing import fnv64a
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("kv_connectors.faults")

Addr = Tuple[str, int]


@dataclass
class PeerTransferFaults:
    # Independent per-block corruption probability inside the window.
    corrupt_rate: float = 0.0
    corrupt_from_s: float = 0.0
    corrupt_until_s: Optional[float] = None
    # Stall window: fetches pay the full IO-timeout ladder and fail.
    stall_from_s: Optional[float] = None
    stall_until_s: Optional[float] = None
    # Blackhole window: connects pay the connect-timeout ladder and fail.
    blackhole_from_s: Optional[float] = None
    blackhole_until_s: Optional[float] = None
    # Flapping: from `flap_from_s`, the peer is DOWN for the first
    # `flap_down_frac` of every `flap_period_s` cycle (down = stall-like).
    flap_from_s: Optional[float] = None
    flap_period_s: float = 10.0
    flap_down_frac: float = 0.5

    def corrupting(self, now: float) -> bool:
        return (
            self.corrupt_rate > 0.0
            and now >= self.corrupt_from_s
            and (self.corrupt_until_s is None or now < self.corrupt_until_s)
        )

    def stalled(self, now: float) -> bool:
        if (
            self.stall_from_s is not None
            and self.stall_from_s <= now
            and (self.stall_until_s is None or now < self.stall_until_s)
        ):
            return True
        if self.flap_from_s is not None and now >= self.flap_from_s:
            phase = (now - self.flap_from_s) % max(self.flap_period_s, 1e-9)
            return phase < self.flap_down_frac * self.flap_period_s
        return False

    def blackholed(self, now: float) -> bool:
        return (
            self.blackhole_from_s is not None
            and self.blackhole_from_s <= now
            and (
                self.blackhole_until_s is None
                or now < self.blackhole_until_s
            )
        )

    def as_dict(self) -> dict:
        out = {}
        for k, v in (
            ("corrupt_rate", self.corrupt_rate),
            ("corrupt_from_s", self.corrupt_from_s),
            ("corrupt_until_s", self.corrupt_until_s),
            ("stall_from_s", self.stall_from_s),
            ("stall_until_s", self.stall_until_s),
            ("blackhole_from_s", self.blackhole_from_s),
            ("blackhole_until_s", self.blackhole_until_s),
            ("flap_from_s", self.flap_from_s),
        ):
            if v not in (None, 0.0):
                out[k] = v
        if self.flap_from_s is not None:
            out["flap_period_s"] = self.flap_period_s
            out["flap_down_frac"] = self.flap_down_frac
        return out


@dataclass
class TransferFaultPlan:
    seed: int = 0
    peers: Dict[Addr, PeerTransferFaults] = field(default_factory=dict)

    def for_peer(self, addr: Addr) -> Optional[PeerTransferFaults]:
        return self.peers.get(addr)

    def as_dict(self) -> dict:
        """JSON-serializable provenance for bench artifacts."""
        return {
            "seed": self.seed,
            "peers": {
                f"{host}:{port}": faults.as_dict()
                for (host, port), faults in sorted(self.peers.items())
            },
        }


class FaultyTransport:
    """A TransferClient wrapper applying a TransferFaultPlan at the fetch
    seam.

    Fault-free peers (and the pod's own loopback address, `self_addr`)
    pass straight through to the inner client — the healthy path stays
    bit-identical. Faulted fetches synthesize the outcome a real flaky
    NIC/wire would produce and report it through the inner client's
    bookkeeping seam (`note_result` / the breaker gate), so breakers,
    latency EWMAs, and every counter behave exactly as they would against
    real damage, while the simulated clock charges the latency the real
    damage would have cost (`charge_s`, drained by the bench into the
    serving clock; `fetch_log` keeps per-fetch (t, peer, latency, outcome)
    rows for tail-latency analysis).
    """

    def __init__(
        self,
        inner,
        plan: TransferFaultPlan,
        clock,
        self_addr: Optional[Addr] = None,
        verify_integrity: bool = True,
    ):
        self.inner = inner
        self.plan = plan
        self.clock = clock
        self.self_addr = self_addr
        self.verify_integrity = verify_integrity
        self.charge_s = 0.0  # un-drained synthetic latency (take_charge)
        self.fetch_log: List[tuple] = []  # (t, "host:port", latency_s, kind)
        self.counters = {
            "corrupt_injected": 0,
            "corrupt_detected": 0,
            "corrupt_admitted": 0,
            "stalled_fetches": 0,
            "blackholed_fetches": 0,
            "breaker_skipped_fetches": 0,
        }

    # -- plumbing ----------------------------------------------------------

    def _block_corrupted(self, block_hash: int, rate: float) -> bool:
        """Deterministic per-(seed, block) corruption draw: the same
        blocks are always the damaged ones ("bad cells"), so injected
        damage is independent of fetch order, retries, worker
        interleaving, and the peers' EPHEMERAL ports — a chaos run
        replays bit-for-bit. Which peers damage anything at all is the
        plan's per-peer corrupt_rate/window."""
        draw = fnv64a(f"{self.plan.seed}|{block_hash:x}".encode())
        return draw < rate * float(1 << 64)

    def _charge(self, addr: Addr, latency_s: float, kind: str) -> None:
        self.charge_s += latency_s
        self.fetch_log.append(
            (self.clock(), f"{addr[0]}:{addr[1]}", latency_s, kind)
        )

    def take_charge(self) -> float:
        """Drain the accumulated synthetic latency (the bench adds it to
        the serving clock after each request)."""
        out, self.charge_s = self.charge_s, 0.0
        return out

    def _timeout_ladder_s(self, connect: bool) -> float:
        cfg = self.inner.config
        per = (
            cfg.connect_timeout_ms if connect else cfg.io_timeout_ms
        ) / 1e3
        return per * (cfg.retries + 1)

    def _down_fetch(
        self, addr: Addr, n: int, kind: str, connect: bool
    ) -> List[None]:
        """Synthesize a dead-peer fetch: breaker-gated (an open breaker
        skips instantly — the whole point), else pay the timeout ladder
        and report the failure."""
        if not self.inner.allow_peer(*addr):
            self.counters["breaker_skipped_fetches"] += 1
            self._charge(addr, 0.0, "breaker_skip")
            # Count the skip the same way the real gate does.
            self.inner._breaker_skip(addr[0], addr[1], n)  # noqa: SLF001
            return [None] * n
        latency = self._timeout_ladder_s(connect)
        self.counters[f"{kind}_fetches"] += 1
        self._charge(addr, latency, kind)
        self.inner.note_result(
            addr[0], addr[1], ok=False, latency_s=latency, blocks=n
        )
        self.inner._fail(  # noqa: SLF001 - same log/metric as a real fail
            addr[0], addr[1], n, f"batch fetch ({kind} injected)"
        )
        return [None] * n

    # -- TransferClient surface -------------------------------------------

    def fetch_one(self, host, port, block_hash, max_size):
        return self.fetch_many(host, port, [block_hash], max_size)[0]

    def fetch_many(self, host, port, block_hashes, max_size):
        if not block_hashes:
            return []
        addr = (host, port)
        faults = (
            None if addr == self.self_addr else self.plan.for_peer(addr)
        )
        now = self.clock()
        if faults is not None and faults.blackholed(now):
            return self._down_fetch(
                addr, len(block_hashes), "blackholed", connect=True
            )
        if faults is not None and faults.stalled(now):
            return self._down_fetch(
                addr, len(block_hashes), "stalled", connect=False
            )
        result = self.inner.fetch_many(host, port, block_hashes, max_size)
        if faults is None or not faults.corrupting(now):
            return result
        corrupted = 0
        out = []
        for block_hash, payload in zip(block_hashes, result):
            if payload is not None and self._block_corrupted(
                block_hash, faults.corrupt_rate
            ):
                corrupted += 1
                if self.verify_integrity:
                    # Detected at the client edge (the C++ checksum seam):
                    # the block degrades to a miss, never lands.
                    out.append(None)
                else:
                    # v1 wire: the damage sails through — the engine lands
                    # wrong KV bytes and serves wrong output. Counted so
                    # the control arm can show what integrity prevents.
                    self.counters["corrupt_admitted"] += 1
                    out.append(payload)
            else:
                out.append(payload)
        if corrupted:
            self.counters["corrupt_injected"] += corrupted
            if self.verify_integrity:
                self.counters["corrupt_detected"] += corrupted
                # Report through the SAME seam a real checksum mismatch
                # uses: corrupt counters + breaker failure.
                self.inner.note_result(
                    host, port, ok=True, latency_s=0.0,
                    corrupt_blocks=corrupted, blocks=len(block_hashes),
                )
        return out

    def fetch_many_hedged(self, addrs, block_hashes, max_size):
        """Hedged form: faults apply per underlying fetch (each holder is
        fetched through THIS wrapper), so a corrupt/stalled primary loses
        the race to a healthy alternate exactly as it would in production.
        Synchronous fallback chain — the sim clock cannot overlap real
        threads, so the hedge's win is modeled as 'next holder pays its
        own (possibly zero-fault) fetch', with the primary's charge kept
        (the hedge delay the serving thread actually waited)."""
        if not block_hashes:
            return []
        best = None
        best_cover = -1
        for i, addr in enumerate(addrs):
            result = self.fetch_many(
                addr[0], addr[1], list(block_hashes), max_size
            )
            cover = sum(payload is not None for payload in result)
            if cover > best_cover:
                best, best_cover = result, cover
            if cover == len(block_hashes):
                if i > 0:
                    self.inner.stats["hedges"] += i
                    self.inner.stats["hedge_wins"] += 1
                return result
        if best is None:
            return [None] * len(block_hashes)
        if len(addrs) > 1:
            self.inner.stats["hedges"] += len(addrs) - 1
        return best

    def close(self):
        self.inner.close()

    # Introspection passthroughs (the /readyz + bench surfaces).
    @property
    def stats(self):
        return self.inner.stats

    @property
    def config(self):
        return self.inner.config

    def status(self):
        out = self.inner.status()
        out["injected_faults"] = dict(self.counters)
        return out

    def peer_state(self, host, port):
        return self.inner.peer_state(host, port)

    def allow_peer(self, host, port):
        return self.inner.allow_peer(host, port)

    def note_result(self, *args, **kwargs):
        return self.inner.note_result(*args, **kwargs)
