"""kv_connectors: the KV-block data plane (host store + pod-to-pod wire).

Port of the reference package's `kv_connectors/connector.py` (without its
trace spans, metrics counters and fault injection):

- **Host store**: `KVConnector.stage` registers an opaque block payload with
  the C++ transfer server (`kv_connectors/cpp/kv_transfer.cpp`, loaded with
  ctypes) and emits BlockStored with the host medium ("cpu"), so the control
  plane scores the block at the host tier's weight. `offload` /
  `offload_async` + `drain_offloads` copy a page pair from the card into
  pinned host memory (a non-blocking copy and a CUDA event) and stage it
  when the copy is done.
- **Peer leg**: `TransferClient` pulls staged blocks from another pod's
  transfer server over TCP: one pooled keep-alive connection per peer, one
  round trip per chain (the multi-block wire), bounded connect/read
  timeouts with retry, end-to-end checksums (the v2 wire), per-peer circuit
  breakers, and hedged fetches across several holders.
- **Device to device**: `transfer_ici` is a torch device copy.

The library is built from the repository's source into the port's build/
directory at first use (ops/_build.py), with no fallback.

Block wire format: raw bytes of the page payload, header-free: the hash is
the name, sizes come from the engine config on both ends.
"""

from __future__ import annotations

import ctypes
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from llm_d_kv_cache_manager_tpu_torch.kvevents.events import BlockRemoved, BlockStored, EventBatch
from llm_d_kv_cache_manager_tpu_torch.ops import _build
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("kv_connectors")

_MASK64 = 2**64 - 1
_configured: Optional[ctypes.CDLL] = None
_configure_mu = threading.Lock()


def _configure_lib(lib: ctypes.CDLL) -> None:
    lib.kvt_server_start.restype = ctypes.c_void_p
    lib.kvt_server_start.argtypes = [ctypes.c_int]
    lib.kvt_server_port.restype = ctypes.c_int
    lib.kvt_server_port.argtypes = [ctypes.c_void_p]
    lib.kvt_server_put.restype = ctypes.c_int
    lib.kvt_server_put.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
    ]
    lib.kvt_server_remove.restype = ctypes.c_int
    lib.kvt_server_remove.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.kvt_server_block_count.restype = ctypes.c_uint64
    lib.kvt_server_block_count.argtypes = [ctypes.c_void_p]
    lib.kvt_server_stop.restype = None
    lib.kvt_server_stop.argtypes = [ctypes.c_void_p]
    lib.kvt_server_corrupt.restype = ctypes.c_int
    lib.kvt_server_corrupt.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.kvt_checksum.restype = ctypes.c_uint64
    lib.kvt_checksum.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
    lib.kvt_connect.restype = ctypes.c_int
    lib.kvt_connect.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.kvt_close.restype = None
    lib.kvt_close.argtypes = [ctypes.c_int]
    for fetch in (lib.kvt_fetch_many, lib.kvt_fetch_many2):
        fetch.restype = ctypes.c_int
        fetch.argtypes = [
            ctypes.c_int, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]


def _library() -> ctypes.CDLL:
    """The transfer library, built (ops/_build.py) and configured on first
    use."""
    global _configured
    with _configure_mu:
        if _configured is None:
            lib = _build.library(_build.TRANSFER)
            _configure_lib(lib)
            _configured = lib
        return _configured


def _as_ptr(data: bytes):
    """A uint8 pointer into a bytes object's buffer (no copy)."""
    return ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))


def checksum(data: bytes) -> int:
    """The wire's integrity hash (FNV-1a 64) of `data`, as the server
    computes it at put time and the v2 wire verifies it on receipt."""
    return _library().kvt_checksum(_as_ptr(data), len(data))


class BlockTransferServer:
    """One pod's block-export endpoint (C++ engine, host-RAM store)."""

    def __init__(self, port: int = 0):
        self._lib = _library()
        self._handle = self._lib.kvt_server_start(port)
        if not self._handle:
            raise OSError(f"failed to start block transfer server on port {port}")

    @property
    def port(self) -> int:
        return self._lib.kvt_server_port(self._handle)

    def put(self, block_hash: int, data: bytes) -> None:
        data = bytes(data)
        if self._lib.kvt_server_put(self._handle, block_hash & _MASK64, _as_ptr(data), len(data)):
            raise OSError("kvt_server_put failed")

    def remove(self, block_hash: int) -> bool:
        return self._lib.kvt_server_remove(self._handle, block_hash & _MASK64) == 0

    def corrupt(self, block_hash: int) -> bool:
        """Fault-injection hook: flip a byte of the stored block WITHOUT
        touching its put-time checksum (the silent bit-flip the end-to-end
        check exists to catch). False when the block is absent or empty."""
        return self._lib.kvt_server_corrupt(self._handle, block_hash & _MASK64) == 0

    def block_count(self) -> int:
        return self._lib.kvt_server_block_count(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.kvt_server_stop(self._handle)
            self._handle = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


# -- pooled keep-alive client -------------------------------------------------


@dataclass
class TransferClientConfig:
    connect_timeout_ms: int = 2000
    io_timeout_ms: int = 5000
    # Reconnect-and-retry attempts after a transport error/timeout (the
    # request is idempotent — a fetch has no side effects — so a retry can
    # never double-apply anything).
    retries: int = 1
    # Blocks per wire request; longer chains split into multiple round
    # trips (still 1/max_batch of the serial count).
    max_batch: int = 256
    # End-to-end integrity: fetch over the v2 checksummed wire when the
    # loaded .so carries it; a failed per-block check degrades to a miss
    # (counted), never a landed corrupt block. False restores the v1 wire
    # byte-for-byte (mixed-version peers).
    verify_integrity: bool = True
    # Per-peer circuit breaker: `breaker_failure_threshold` consecutive
    # failed results (timeouts, transport errors, corruption) open the
    # peer's breaker; while open every fetch is skipped instantly (a
    # counted miss — no timeout paid). After `breaker_cooldown_s` the
    # breaker goes half-open and admits ONE probe fetch: success closes
    # it, failure re-opens with a fresh cooldown. Threshold <= 0 disables.
    breaker_failure_threshold: int = 5
    breaker_cooldown_s: float = 30.0
    # Hedged fetches (fetch_many_hedged): when a chain run has >= 2
    # holders, a hedge to the next holder launches after an adaptive
    # delay tracking the primary peer's latency tail (EWMA mean + 4x EWMA
    # deviation — a p99 proxy), clamped to [floor, cap].
    hedge_delay_floor_s: float = 0.005
    hedge_delay_cap_s: float = 2.0
    # Idle-TTL on per-peer state: pooled keep-alive connections and
    # peer failure-memory rows untouched for this long are closed/
    # dropped by `sweep_idle` (ridden by `status()` — no threads).
    # A peer whose breaker is NOT closed is never dropped: an open
    # breaker on a live peer is active protection, and it re-closes
    # through its own half-open probe, not through forgetting. 0
    # disables the sweep.
    peer_idle_ttl_s: float = 0.0


# Breaker states, as transitions and `status()` report them.
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

# Sentinels for per-block wire statuses inside _transport_fetch results.
_OVERSIZED = object()  # -3: present remotely but over the caller's cap
_CORRUPT = object()    # -4: failed the end-to-end checksum on receipt


class PeerBreaker:
    """Per-peer circuit breaker: closed -> open on consecutive failures,
    half-open single-probe recovery. Clock-driven (the owner passes `now`
    into every call), so transitions are deterministic under test and
    under any clock."""

    def __init__(self, failure_threshold: int, cooldown_s: float):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self.opens = 0
        self._probe_inflight = False
        self._mu = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.failure_threshold > 0

    def allow(self, now: float):
        """(allowed, transition): whether a fetch may proceed now, plus the
        (old, new) state transition this call performed (open -> half_open
        when the cooldown elapsed), if any."""
        if not self.enabled:
            return True, None
        with self._mu:
            if self.state == BREAKER_CLOSED:
                return True, None
            if self.state == BREAKER_OPEN:
                if now - (self.opened_at or 0.0) < self.cooldown_s:
                    return False, None
                # Cooldown over: half-open, this caller becomes the probe.
                self.state = BREAKER_HALF_OPEN
                self._probe_inflight = True
                return True, (BREAKER_OPEN, BREAKER_HALF_OPEN)
            # half-open: exactly one probe at a time.
            if self._probe_inflight:
                return False, None
            self._probe_inflight = True
            return True, None

    def record_success(self, now: float):
        """Returns the (old, new) transition, if any."""
        with self._mu:
            self.consecutive_failures = 0
            self._probe_inflight = False
            if self.state == BREAKER_CLOSED:
                return None
            old, self.state = self.state, BREAKER_CLOSED
            self.opened_at = None
            return (old, BREAKER_CLOSED)

    def record_failure(self, now: float):
        """Returns the (old, new) transition, if any."""
        if not self.enabled:
            return None
        with self._mu:
            self.consecutive_failures += 1
            self._probe_inflight = False
            if self.state == BREAKER_HALF_OPEN:
                # Failed probe: straight back to open, fresh cooldown.
                self.state = BREAKER_OPEN
                self.opened_at = now
                self.opens += 1
                return (BREAKER_HALF_OPEN, BREAKER_OPEN)
            if (
                self.state == BREAKER_CLOSED
                and self.consecutive_failures >= self.failure_threshold
            ):
                self.state = BREAKER_OPEN
                self.opened_at = now
                self.opens += 1
                return (BREAKER_CLOSED, BREAKER_OPEN)
            return None

    def status(self, now: Optional[float] = None) -> dict:
        with self._mu:
            out = {
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "opens": self.opens,
            }
            if self.state == BREAKER_OPEN and now is not None:
                out["cooldown_remaining_s"] = round(
                    max(
                        self.cooldown_s - (now - (self.opened_at or 0.0)), 0.0
                    ),
                    3,
                )
            return out


class _PeerState:
    """Per-(host, port) client-side failure memory: the breaker plus an
    EWMA latency profile (mean + mean-absolute-deviation — the hedge
    delay's p99 proxy) and per-peer counters."""

    __slots__ = (
        "key", "breaker", "lock", "lat_ewma", "lat_dev", "lat_n",
        "fetches", "failures", "corrupt_blocks", "breaker_skips",
        "last_used",
    )

    _ALPHA = 0.2  # EWMA smoothing for the latency profile

    def __init__(self, key: str, config: TransferClientConfig):
        self.key = key
        self.breaker = PeerBreaker(
            config.breaker_failure_threshold, config.breaker_cooldown_s
        )
        self.lock = threading.Lock()
        self.lat_ewma = 0.0
        self.lat_dev = 0.0
        self.lat_n = 0
        self.fetches = 0
        self.failures = 0
        self.corrupt_blocks = 0
        self.breaker_skips = 0
        self.last_used = 0.0

    def note_latency(self, seconds: float) -> None:
        with self.lock:
            if self.lat_n == 0:
                self.lat_ewma = seconds
                self.lat_dev = 0.0
            else:
                err = seconds - self.lat_ewma
                self.lat_ewma += self._ALPHA * err
                self.lat_dev += self._ALPHA * (abs(err) - self.lat_dev)
            self.lat_n += 1

    def status(self, now: Optional[float] = None) -> dict:
        with self.lock:
            out = {
                "fetches": self.fetches,
                "failures": self.failures,
                "corrupt_blocks": self.corrupt_blocks,
                "breaker_skips": self.breaker_skips,
                "ewma_fetch_latency_ms": round(self.lat_ewma * 1e3, 3),
                "ewma_latency_dev_ms": round(self.lat_dev * 1e3, 3),
                "latency_samples": self.lat_n,
            }
        out.update(self.breaker.status(now))
        return out


class _Conn:
    __slots__ = ("fd", "lock", "last_used")

    def __init__(self):
        self.fd = -1
        self.lock = threading.Lock()
        self.last_used = 0.0


class TransferClient:
    """Pooled keep-alive fetch client for the peer leg.

    One persistent connection per (host, port); `fetch_many` moves a whole
    chain in one round trip through the C++ multi-block protocol. Every
    operation is bounded by connect/read timeouts and a bounded retry —
    on exhaustion the blocks come back as None (a miss the tiering layer
    already handles) and `transfer_failures` counts the event, so a dead
    peer can never wedge the serving thread on a stuck socket.

    Chaos hardening on top of the pooled protocol:

    - **End-to-end integrity**: fetches ride the v2 checksummed wire
      (put-time FNV-1a 64 per block, verified GIL-free on receipt); a
      failed check degrades the block to a miss — counted in
      `kvcache_transfer_corrupt_blocks_total` — and is NEVER landed.
    - **Per-peer circuit breakers**: consecutive failures (timeouts,
      transport errors, corruption) open the peer's breaker; open peers
      are skipped instantly instead of paying the full timeout, with
      half-open single-probe recovery. Transitions are observable
      (`on_breaker_transition` callback + the transitions metric).
    - **Hedged fetches** (`fetch_many_hedged`): given several holders of
      a chain run, a hedge launches to the next holder after an adaptive
      per-peer-latency delay; the first valid reply wins and the loser's
      reply is drained and discarded (a fetch is idempotent — nothing can
      double-land).

    The clock is injectable (breaker windows + latency profile), so every
    transition is deterministic under test.
    """

    def __init__(
        self,
        config: Optional[TransferClientConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        on_breaker_transition: Optional[Callable[[str, str, str], None]] = None,
        on_fetch_misses: Optional[
            Callable[[str, int, List[int], List[int]], None]
        ] = None,
    ):
        self.config = config or TransferClientConfig()
        self.clock = clock
        # Called as (peer_key, old_state, new_state) on every breaker
        # transition.
        self.on_breaker_transition = on_breaker_transition
        # Called as (host, port, requested_hashes, missing_hashes) when a
        # SUCCESSFUL round trip came back with per-block "missing"
        # answers (-2 on the wire: the peer is healthy and explicitly
        # disclaims the blocks). This is ground truth against whatever
        # advertised the peer as a holder (IndexBackedPeerResolver.note_miss
        # takes it). Transport failures,
        # corruption, and breaker skips never fire it: those say nothing
        # about what the peer holds.
        self.on_fetch_misses = on_fetch_misses
        self._pool: Dict[Tuple[str, int], _Conn] = {}
        self._peers: Dict[Tuple[str, int], _PeerState] = {}
        self._mu = threading.Lock()  # pool/peer maps only
        self.stats: Dict[str, int] = {
            "connects": 0, "reconnects": 0, "failures": 0,
            "batch_fetches": 0, "blocks_fetched": 0,
            "corrupt_blocks": 0, "oversized_blocks": 0,
            "breaker_skipped_blocks": 0, "hedges": 0, "hedge_wins": 0,
            "missing_blocks": 0, "idle_closed_conns": 0,
            "idle_dropped_peers": 0, "reaped_peers": 0,
        }

    def _conn(self, host: str, port: int) -> _Conn:
        with self._mu:
            conn = self._pool.get((host, port))
            if conn is None:
                conn = self._pool[(host, port)] = _Conn()
            conn.last_used = self.clock()
            return conn

    def peer_state(self, host: str, port: int) -> _PeerState:
        with self._mu:
            peer = self._peers.get((host, port))
            if peer is None:
                peer = self._peers[(host, port)] = _PeerState(
                    f"{host}:{port}", self.config
                )
            peer.last_used = self.clock()
            return peer

    def sweep_idle(self, now: Optional[float] = None) -> int:
        """Close pooled connections and drop peer failure-memory rows
        untouched for `peer_idle_ttl_s` (0 disables). Lazy and clock-
        driven: `status()` rides it. Peer rows whose breaker is not
        CLOSED survive any idle age: an open breaker is live protection
        for the next fetch, and dropping it would reset the peer to
        trusted mid-outage. Returns rows removed (conns + peers)."""
        ttl = self.config.peer_idle_ttl_s
        if ttl <= 0:
            return 0
        if now is None:
            now = self.clock()
        removed = 0
        to_close: List[_Conn] = []
        with self._mu:
            for addr in [
                a for a, c in self._pool.items()
                if now - c.last_used >= ttl
            ]:
                to_close.append(self._pool.pop(addr))
            for addr in [
                a for a, p in self._peers.items()
                if now - p.last_used >= ttl
                and p.breaker.state == BREAKER_CLOSED
            ]:
                del self._peers[addr]
                self.stats["idle_dropped_peers"] += 1
                removed += 1
        for conn in to_close:
            with conn.lock:
                self._drop(conn)
            self.stats["idle_closed_conns"] += 1
            removed += 1
        return removed

    def forget_host(self, host: str) -> int:
        """Departure reap hook: drop every pooled connection and peer row
        addressed to `host`, whatever its port and breaker state — the
        pod behind the address is gone, so its failure memory
        protects nothing and its sockets lead nowhere. Returns rows
        removed."""
        removed = 0
        to_close: List[_Conn] = []
        with self._mu:
            for addr in [a for a in self._pool if a[0] == host]:
                to_close.append(self._pool.pop(addr))
            for addr in [a for a in self._peers if a[0] == host]:
                del self._peers[addr]
                self.stats["reaped_peers"] += 1
                removed += 1
        for conn in to_close:
            with conn.lock:
                self._drop(conn)
            removed += 1
        return removed

    def entries(self) -> int:
        """Per-peer rows + pooled connections (an O(1) read)."""
        with self._mu:
            return len(self._peers) + len(self._pool)

    def _ensure_connected(self, conn: _Conn, host: str, port: int) -> bool:
        if conn.fd >= 0:
            return True
        conn.fd = _library().kvt_connect(
            host.encode(), port, self.config.connect_timeout_ms
        )
        if conn.fd >= 0:
            self.stats["connects"] += 1
            return True
        return False

    def _drop(self, conn: _Conn) -> None:
        if conn.fd >= 0:
            _library().kvt_close(conn.fd)
            conn.fd = -1

    def _fail(self, host: str, port: int, n: int, what: str) -> None:
        self.stats["failures"] += 1
        logger.warning(
            "transfer %s from %s:%d failed after %d attempt(s) (%d block(s) "
            "treated as missing)", what, host, port,
            self.config.retries + 1, n,
        )

    # -- per-peer bookkeeping seam ----------------------------------------

    def _note_transition(self, peer: _PeerState, transition) -> None:
        if transition is None:
            return
        old, new = transition
        log = logger.info if new == BREAKER_CLOSED else logger.warning
        log("transfer breaker for %s: %s -> %s", peer.key, old, new)
        if self.on_breaker_transition is not None:
            try:
                self.on_breaker_transition(peer.key, old, new)
            except Exception as e:  # noqa: BLE001 - observer must not
                logger.debug("breaker transition callback failed: %s", e)

    def allow_peer(self, host: str, port: int) -> bool:
        """Breaker gate: False means the peer must be skipped right now
        (its breaker is open, or half-open with the probe slot taken)."""
        peer = self.peer_state(host, port)
        allowed, transition = peer.breaker.allow(self.clock())
        self._note_transition(peer, transition)
        return allowed

    def note_result(
        self,
        host: str,
        port: int,
        ok: bool,
        latency_s: float,
        corrupt_blocks: int = 0,
        blocks: int = 1,
    ) -> None:
        """Record one fetch outcome against the peer's failure memory:
        latency EWMA (successes only — a timeout is not a latency sample),
        corruption counters, and the breaker (corruption counts as a
        failure: a peer shipping garbage is as untrustworthy as a dead
        one). Public so a stand-in for the wire can report the outcomes it
        synthesizes through the same seam."""
        peer = self.peer_state(host, port)
        now = self.clock()
        if ok:
            peer.note_latency(latency_s)
            with peer.lock:
                peer.fetches += 1
        else:
            with peer.lock:
                peer.failures += 1
        if corrupt_blocks:
            with peer.lock:
                peer.corrupt_blocks += corrupt_blocks
            self.stats["corrupt_blocks"] += corrupt_blocks
            logger.warning(
                "%d corrupt block(s) detected from %s:%d — discarded "
                "(checksum mismatch), falling back", corrupt_blocks, host,
                port,
            )
        if ok and not corrupt_blocks:
            self._note_transition(peer, peer.breaker.record_success(now))
        else:
            self._note_transition(peer, peer.breaker.record_failure(now))

    def _breaker_skip(self, host: str, port: int, n: int) -> List[None]:
        peer = self.peer_state(host, port)
        with peer.lock:
            peer.breaker_skips += 1
        self.stats["breaker_skipped_blocks"] += n
        return [None] * n

    # -- fetch paths -------------------------------------------------------

    def fetch_one(
        self, host: str, port: int, block_hash: int, max_size: int,
    ) -> Optional[bytes]:
        """One block over the pooled connection. None when missing remotely
        OR when every attempt failed (counted in `transfer_failures`).
        Rides the same breaker-gated, integrity-checked path as
        `fetch_many` (an n=1 multi-block round trip)."""
        return self.fetch_many(host, port, [block_hash], max_size)[0]

    def fetch_many(
        self, host: str, port: int, block_hashes: List[int], max_size: int,
    ) -> List[Optional[bytes]]:
        """Fetch a chain in one round trip per `max_batch` blocks. Returns
        payloads aligned with `block_hashes`; None marks a block missing
        remotely, failed-integrity (detected corrupt), skipped behind an
        open breaker, or lost to a (bounded, retried, counted) transport
        failure."""
        if not block_hashes:
            return []
        if not self.allow_peer(host, port):
            return self._breaker_skip(host, port, len(block_hashes))
        out: List[Optional[bytes]] = []
        mb = max(1, self.config.max_batch)
        for i in range(0, len(block_hashes), mb):
            out.extend(
                self._fetch_chunk(host, port, block_hashes[i:i + mb], max_size)
            )
        return out

    def _transport_fetch(self, host, port, hashes, max_size):
        """The lib-touching leg of one chunk: (ok, entries). `entries` is
        aligned with `hashes`: payload bytes, None (missing remotely), or
        the _OVERSIZED/_CORRUPT sentinels. ok=False means the whole round
        trip failed its bounded retry budget (entries is None). Tests
        override it with scripted outcomes."""
        n = len(hashes)
        cap = max(max_size, 1)
        arr = (ctypes.c_uint64 * n)(*[h & (2**64 - 1) for h in hashes])
        buf = (ctypes.c_uint8 * (n * cap))()
        lens = (ctypes.c_int64 * n)()
        lib = _library()
        fetch_fn = lib.kvt_fetch_many2 if self.config.verify_integrity else lib.kvt_fetch_many
        conn = self._conn(host, port)
        with conn.lock:
            for attempt in range(self.config.retries + 1):
                if attempt:
                    self.stats["reconnects"] += 1
                if not self._ensure_connected(conn, host, port):
                    continue
                rc = fetch_fn(
                    conn.fd, n, arr, buf, cap, lens, self.config.io_timeout_ms
                )
                if rc == 0:
                    base = ctypes.addressof(buf)
                    entries = []
                    for i in range(n):
                        ln = lens[i]
                        if ln >= 0:
                            entries.append(ctypes.string_at(base + i * cap, ln))
                        elif ln == -3:
                            entries.append(_OVERSIZED)
                        elif ln == -4:
                            entries.append(_CORRUPT)
                        else:
                            entries.append(None)
                    return True, entries
                self._drop(conn)  # transport error: reconnect and retry
        return False, None

    def _fetch_chunk(
        self, host: str, port: int, hashes: List[int], max_size: int,
    ) -> List[Optional[bytes]]:
        n = len(hashes)
        t0 = self.clock()
        ok, entries = self._transport_fetch(host, port, hashes, max_size)
        latency = max(self.clock() - t0, 0.0)
        if not ok:
            self.note_result(host, port, ok=False, latency_s=latency, blocks=n)
            self._fail(host, port, n, "batch fetch")
            return [None] * n
        corrupt = 0
        missing: List[int] = []
        result: List[Optional[bytes]] = []
        for h, entry in zip(hashes, entries):
            if entry is _CORRUPT:
                corrupt += 1
                result.append(None)  # detected — treated exactly like a miss
            elif entry is _OVERSIZED:
                self.stats["oversized_blocks"] += 1
                logger.warning(
                    "block %x from %s:%d exceeds cap %d — dropped",
                    h, host, port, max(max_size, 1),
                )
                result.append(None)
            else:
                if entry is None:
                    # Explicit per-block miss on a healthy round trip:
                    # the peer disclaims the block (-2). The one wire
                    # status that is EVIDENCE rather than damage — fed to
                    # on_fetch_misses seam below.
                    missing.append(h)
                result.append(entry)
        self.stats["batch_fetches"] += 1
        self.stats["blocks_fetched"] += n
        self.note_result(
            host, port, ok=True, latency_s=latency,
            corrupt_blocks=corrupt, blocks=n,
        )
        if missing:
            self.stats["missing_blocks"] += len(missing)
            if self.on_fetch_misses is not None:
                try:
                    self.on_fetch_misses(host, port, list(hashes), missing)
                except Exception as e:  # noqa: BLE001 - observer must not
                    logger.debug("fetch-miss callback failed: %s", e)
        return result

    # -- hedged fetches ----------------------------------------------------

    def hedge_delay_s(self, host: str, port: int) -> float:
        """Adaptive hedge trigger for a peer: EWMA latency mean + 4x EWMA
        mean-absolute-deviation (a p99 proxy that needs no sample ring),
        clamped to [hedge_delay_floor_s, hedge_delay_cap_s]."""
        peer = self.peer_state(host, port)
        with peer.lock:
            if peer.lat_n == 0:
                est = self.config.hedge_delay_floor_s
            else:
                est = peer.lat_ewma + 4.0 * peer.lat_dev
        return min(
            max(est, self.config.hedge_delay_floor_s),
            self.config.hedge_delay_cap_s,
        )

    def fetch_many_hedged(
        self,
        addrs: List[Tuple[str, int]],
        block_hashes: List[int],
        max_size: int,
    ) -> List[Optional[bytes]]:
        """Fetch a chain run that has several holders. The first holder is
        the primary; if it has not answered within the adaptive hedge
        delay — or answered with holes (transport failure, corruption,
        open breaker) — a hedge launches to the next holder. The first
        COMPLETE reply (every block present) wins; a losing fetch still
        runs to completion on its own pooled connection (the reply is
        drained, keeping the connection usable) and its payloads are
        discarded, so a block can never be returned twice. With no
        complete reply anywhere, the reply covering the most blocks wins
        (primary on ties) — the caller's chain-cut logic handles the
        holes."""
        if not block_hashes:
            return []
        if not addrs:
            return [None] * len(block_hashes)
        primary, backups = addrs[0], list(addrs[1:])
        if not backups:
            return self.fetch_many(
                primary[0], primary[1], block_hashes, max_size
            )

        cv = threading.Condition()
        replies: List[tuple] = []  # (addr, result), completion order
        inflight = [0]

        def run(addr):
            result = self.fetch_many(
                addr[0], addr[1], list(block_hashes), max_size
            )
            with cv:
                replies.append((addr, result))
                inflight[0] -= 1
                cv.notify_all()

        def launch(addr):
            inflight[0] += 1
            threading.Thread(
                target=run, args=(addr,), name="kv-hedge-fetch", daemon=True
            ).start()

        def complete(result):
            return all(payload is not None for payload in result)

        with cv:
            launch(primary)
            examined = 0
            cv.wait_for(
                lambda: len(replies) > 0,
                timeout=self.hedge_delay_s(*primary),
            )
            backup_iter = iter(backups)
            while True:
                while examined < len(replies):
                    addr, result = replies[examined]
                    examined += 1
                    if complete(result):
                        if addr != primary:
                            self.stats["hedge_wins"] += 1
                        return result
                nxt = next(backup_iter, None)
                if nxt is not None:
                    # Primary (or an earlier hedge) is slow or answered
                    # with holes: fan to the next rendezvous-ranked holder.
                    launch(nxt)
                    self.stats["hedges"] += 1
                elif inflight[0] == 0:
                    break
                done = examined  # rebind for the closure below
                cv.wait_for(
                    lambda: len(replies) > done or inflight[0] == 0
                )
            # No complete reply: most-covered wins, primary on ties
            # (replies is completion-ordered, primary launched first).
            best: Optional[List[Optional[bytes]]] = None
            best_cover = -1
            for addr, result in replies:
                cover = sum(payload is not None for payload in result)
                if cover > best_cover:
                    best, best_cover = result, cover
            return best if best is not None else [None] * len(block_hashes)

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        """Transfer-plane health snapshot:
        aggregate counters plus per-peer breaker state, consecutive
        failures, and the EWMA fetch-latency profile."""
        now = self.clock()
        self.sweep_idle(now)
        with self._mu:
            peers = dict(self._peers)
            pooled = len(self._pool)
        return {
            "stats": dict(self.stats),
            "breaker": {
                "failure_threshold": self.config.breaker_failure_threshold,
                "cooldown_s": self.config.breaker_cooldown_s,
            },
            "pooled_connections": pooled,
            "peer_idle_ttl_s": self.config.peer_idle_ttl_s,
            "verify_integrity": self.config.verify_integrity,
            "peers": {
                peer.key: peer.status(now) for peer in peers.values()
            },
        }

    def close(self) -> None:
        with self._mu:
            conns = list(self._pool.values())
            self._pool.clear()
        for conn in conns:
            with conn.lock:
                self._drop(conn)


@dataclass
class KVConnectorConfig:
    port: int = 0  # 0 -> ephemeral
    # Events' media, named the reference's way: device pages "gpu", the
    # host store "cpu".
    device_tier_hbm: str = "gpu"
    device_tier_host: str = "cpu"
    # Completion-queue bound for offload_async: at most this many copies
    # awaiting drain (each holds its pinned host buffers); dispatching past
    # the bound drains the oldest entry first.
    max_inflight_offloads: int = 16
    # Client bounds (threaded into this connector's TransferClient).
    connect_timeout_ms: int = 2000
    fetch_timeout_ms: int = 5000
    fetch_retries: int = 1
    fetch_batch_size: int = 256
    verify_integrity: bool = True
    breaker_failure_threshold: int = 5
    breaker_cooldown_s: float = 30.0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensor_bytes(t: torch.Tensor) -> bytes:
    """A tensor's C-order bytes (bf16 included: through a uint8 view)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()


class KVConnector:
    """Per-pod connector: moves KV pages between the card, the host store
    and remote pods, emitting the control-plane events for each move."""

    def __init__(
        self,
        config: Optional[KVConnectorConfig] = None,
        event_sink: Optional[Callable[[EventBatch], None]] = None,
    ):
        self.config = config or KVConnectorConfig()
        self.server = BlockTransferServer(self.config.port)
        self.event_sink = event_sink
        self.client = TransferClient(TransferClientConfig(
            connect_timeout_ms=self.config.connect_timeout_ms,
            io_timeout_ms=self.config.fetch_timeout_ms,
            retries=self.config.fetch_retries,
            max_batch=self.config.fetch_batch_size,
            verify_integrity=self.config.verify_integrity,
            breaker_failure_threshold=self.config.breaker_failure_threshold,
            breaker_cooldown_s=self.config.breaker_cooldown_s,
        ))
        # Dispatched-but-undrained offload copies, FIFO.
        self._offloads: deque = deque()
        self._offload_mu = threading.Lock()

    @property
    def port(self) -> int:
        return self.server.port

    # -- device <-> host store ----------------------------------------------

    def offload(
        self, block_hash: int, k_page, v_page, token_ids, block_size: int,
        parent_hash: Optional[int] = None,
    ) -> None:
        """Stage one page pair in the host store (+ event). Synchronous form:
        starts the copy and drains the whole completion queue (older async
        offloads included) before returning."""
        self.offload_async(block_hash, k_page, v_page, token_ids, block_size, parent_hash)
        self.drain_offloads()

    def offload_async(
        self, block_hash: int, k_page, v_page, token_ids, block_size: int,
        parent_hash: Optional[int] = None, lora_id: Optional[int] = None,
    ) -> None:
        """Start a page pair's copy to the host NOW and return: on the card a
        non-blocking copy into pinned host memory on the current stream
        (behind whatever is queued there, so later writes to the pages
        cannot corrupt it) and a CUDA event; on the CPU a copy. The block is
        staged (+ host-tier event) when `drain_offloads` resolves it. Past
        `max_inflight_offloads`, the oldest entry is drained first."""
        host, event = [], None
        for page in (k_page, v_page):
            if page.device.type == "cuda":
                buf = torch.empty(page.shape, dtype=page.dtype, pin_memory=True)
                buf.copy_(page, non_blocking=True)
            else:
                buf = page.detach().clone()
            host.append(buf)
        if any(page.device.type == "cuda" for page in (k_page, v_page)):
            event = torch.cuda.Event()
            event.record()
        # The device pages stay referenced until the copy has completed.
        entry = (block_hash, host, (k_page, v_page), event, list(token_ids),
                 block_size, parent_hash, lora_id)
        drain_oldest = []
        with self._offload_mu:
            self._offloads.append(entry)
            while len(self._offloads) > max(1, self.config.max_inflight_offloads):
                drain_oldest.append(self._offloads.popleft())
        for old in drain_oldest:
            self._resolve_offload(old)

    def drain_offloads(self, max_blocks: Optional[int] = None) -> List[int]:
        """Resolve pending offloads (oldest first): wait for the copy, stage
        the bytes, emit the host-tier event. Returns the staged block hashes
        in dispatch order."""
        done: List[int] = []
        while max_blocks is None or len(done) < max_blocks:
            with self._offload_mu:
                if not self._offloads:
                    break
                entry = self._offloads.popleft()
            self._resolve_offload(entry)
            done.append(entry[0])
        return done

    @property
    def pending_offloads(self) -> int:
        with self._offload_mu:
            return len(self._offloads)

    def _resolve_offload(self, entry) -> None:
        block_hash, host, _pages, event, token_ids, block_size, parent, lora = entry
        if event is not None:
            event.synchronize()
        self.stage(block_hash, b"".join(_tensor_bytes(t) for t in host), token_ids,
                   block_size, parent, lora)

    def restore(self, block_hash: int, like_k, like_v) -> Optional[Tuple]:
        """Bring a host-staged block back as (k_page, v_page) tensors shaped
        like the given templates, on their device."""
        payload = self.fetch_staged(block_hash, _nbytes(like_k) + _nbytes(like_v))
        return self._decode(payload, like_k, like_v)

    def drop(self, block_hash: int) -> None:
        if self.server.remove(block_hash):
            self._emit(EventBatch(ts=0.0, events=[
                BlockRemoved(block_hashes=[block_hash], medium=self.config.device_tier_host)
            ]))

    # -- opaque-payload tier API (engine/tiering.py drives these) -------------

    def stage(
        self, block_hash: int, payload: bytes, token_ids, block_size: int,
        parent_hash: Optional[int] = None, lora_id: Optional[int] = None,
    ) -> None:
        """Stage an already-serialized block in the host store (+ host-tier
        BlockStored). The payload layout is the engine's business: the data
        plane treats blocks as opaque bytes named by their hash."""
        self.server.put(block_hash, payload)
        self._emit_stored(block_hash, token_ids, block_size, parent_hash,
                          self.config.device_tier_host, lora_id)

    def onboard_payload(
        self, host: str, port: int, block_hash: int, max_size: int,
    ) -> Optional[bytes]:
        """Pull a block's bytes from a pod's transfer server; None if absent
        or the transfer failed its bounded retry. The caller lands it on the
        device and the block manager emits the device-tier BlockStored, so
        no event fires here."""
        return self.client.fetch_one(host, port, block_hash, max_size)

    def onboard_payloads(
        self, host: str, port: int, block_hashes: List[int], max_size: int,
    ) -> List[Optional[bytes]]:
        """Batched onboard_payload: one multi-block round trip per chain."""
        return self.client.fetch_many(host, port, block_hashes, max_size)

    def onboard_payloads_hedged(
        self, addrs: List[Tuple[str, int]], block_hashes: List[int], max_size: int,
    ) -> List[Optional[bytes]]:
        """Batched onboard with fallback holders: primary first, hedge to the
        next holder on latency or failure (first valid reply wins, never
        lands twice)."""
        return self.client.fetch_many_hedged(addrs, block_hashes, max_size)

    def fetch_staged(self, block_hash: int, max_size: int) -> Optional[bytes]:
        """Local host-store lookup; None if the block is not staged."""
        return self.onboard_payload("127.0.0.1", self.port, block_hash, max_size)

    def fetch_staged_many(
        self, block_hashes: List[int], max_size: int,
    ) -> List[Optional[bytes]]:
        """Batched local host-store lookup (one loopback round trip)."""
        return self.onboard_payloads("127.0.0.1", self.port, block_hashes, max_size)

    # -- cross-pod ----------------------------------------------------------

    def onboard(
        self, host: str, port: int, block_hash: int, like_k, like_v,
        token_ids=None, block_size: int = 0, parent_hash: Optional[int] = None,
    ) -> Optional[Tuple]:
        """Fetch a block from a remote pod and land it locally (+ event)."""
        payload = self.onboard_payload(host, port, block_hash, _nbytes(like_k) + _nbytes(like_v))
        pages = self._decode(payload, like_k, like_v)
        if pages is not None and token_ids is not None:
            self._emit_stored(block_hash, token_ids, block_size, parent_hash,
                              self.config.device_tier_hbm)
        return pages

    # -- device to device -----------------------------------------------------

    @staticmethod
    def transfer_ici(pages, device):
        """Copy pages (a tensor or a tuple of them) to another device."""
        if torch.is_tensor(pages):
            return pages.to(device, non_blocking=True)
        return tuple(p.to(device, non_blocking=True) for p in pages)

    # -- internals ------------------------------------------------------------

    @staticmethod
    def _decode(payload: Optional[bytes], like_k, like_v):
        if payload is None:
            return None
        k_n, v_n = _nbytes(like_k), _nbytes(like_v)
        if len(payload) != k_n + v_n:
            raise ValueError(f"block payload size {len(payload)} != expected {k_n + v_n}")
        raw = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        return tuple(
            raw[lo:hi].view(like.dtype).reshape(like.shape).to(like.device)
            for like, lo, hi in ((like_k, 0, k_n), (like_v, k_n, k_n + v_n))
        )

    def _emit_stored(self, block_hash, token_ids, block_size, parent_hash, tier, lora_id=None):
        self._emit(EventBatch(ts=0.0, events=[
            BlockStored(
                block_hashes=[block_hash],
                parent_block_hash=parent_hash,
                token_ids=list(token_ids),
                block_size=block_size,
                lora_id=lora_id,
                medium=tier,
            )
        ]))

    def _emit(self, batch: EventBatch) -> None:
        if self.event_sink is not None:
            self.event_sink(batch)

    def close(self) -> None:
        self.drain_offloads()
        self.client.close()
        self.server.close()
