"""The host tier: wires kv_connectors into the serving loop.

Port of the reference package's `engine/tiering.py`:

- **reclaim -> offload**: when the block manager reclaims a committed device
  page under allocation pressure, the page's bytes are staged in the host
  store (the C++ transfer server) instead of vanishing: BlockRemoved("gpu")
  + BlockStored("cpu") reach the control plane, so the scorer keeps ranking
  this pod for the block at the host tier's weight.
- **miss -> restore/onboard**: when an allocation's hash chain misses on the
  device, the block is landed from the host store or, with a peer resolver,
  fetched from another pod's transfer server over TCP, and committed as a
  normal device page. A pod can serve a prefix it never computed.
- **export**: staging a live sequence's committed pages (the
  prefill/decode-disaggregation push): the pages stay on the device, a copy
  becomes fetchable by peers.

The page payload is opaque bytes; a `PageCodec` serializes one logical page
across all layers (engine._DevicePageCodec). Pods without a model use
`NullPageCodec`: the full event behaviour with zero-byte payloads.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import OrderedDict
from typing import TYPE_CHECKING, Callable, Dict, List, Mapping, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch import obs
from llm_d_kv_cache_manager_tpu_torch.engine.costs import (
    PEER,
    READY,
    STAGED,
    TransferCostModel,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.hashing import fnv64a, fold64
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import (
    Key,
    base_pod_identifier,
)
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

if TYPE_CHECKING:
    from llm_d_kv_cache_manager_tpu_torch.kv_connectors.connector import KVConnector

logger = kvlog.get_logger("engine.tiering")

# (host, port) of a peer pod's transfer server, or None.
PeerResolver = Callable[[int], Optional[Tuple[str, int]]]


class PageCodec:
    """Serializes logical KV pages (all layers) to/from opaque bytes.

    The batch forms are the device-crossing unit: a real codec moves N
    pages in one dispatch (engine._DevicePageCodec), so chain restores and
    bulk reclaims pay O(1) round trips instead of O(pages). The single-page
    forms default to the N=1 batch."""

    page_nbytes: int = 0

    def extract(self, page_id: int) -> bytes:
        return self.extract_many([page_id])[0]

    def extract_many_async(self, page_ids):
        """Capture the pages' CURRENT content and return a zero-arg resolve
        callable producing the payload bytes. The base implementation
        captures by extracting eagerly; device codecs override to enqueue
        the gather + async host copy immediately (a snapshot — later
        overwrites of the pages cannot corrupt it) and pay only the
        already-overlapped host sync at resolve time."""
        payloads = self.extract_many(list(page_ids))
        return lambda: payloads

    def insert(self, page_id: int, payload: bytes) -> None:
        self.insert_many([(page_id, payload)])

    def extract_many(self, page_ids) -> List[bytes]:
        raise NotImplementedError

    def insert_many(self, items) -> None:
        raise NotImplementedError


class NullPageCodec(PageCodec):
    """Zero-byte payloads with the full event behaviour (a store with no
    device behind it, as in the tier store's tests)."""

    def extract_many(self, page_ids) -> List[bytes]:
        return [b"" for _ in page_ids]

    def insert_many(self, items) -> None:
        for _, payload in items:
            if payload:
                raise ValueError("a null codec received a non-empty block")


class TieredKVStore:
    """Per-pod two-tier policy over a KVConnector.

    Bounded host store: staging beyond `capacity_blocks` drops the
    least-recently-staged block first (BlockRemoved(host) via the
    connector), so host RAM use is capped like any cache tier.
    """

    def __init__(
        self,
        connector: "KVConnector",
        codec: PageCodec,
        capacity_blocks: int = 1024,
        peer_resolver: Optional[PeerResolver] = None,
        cost_model: Optional[TransferCostModel] = None,
        prefetch_capacity_blocks: int = 64,
        async_stage_capacity_pages: int = 128,
        stage_wave_pages: int = 16,
        onboard_wave_blocks: int = 8,
        fetch_batch_blocks: int = 32,
    ):
        self.connector = connector
        self.codec = codec
        self.capacity_blocks = capacity_blocks
        self.peer_resolver = peer_resolver
        # Transfer-plane pipelining bounds: pages per extract wave in the
        # double-buffered stager (_stage_many), blocks per H2D insert wave
        # in load_chain (each wave's scatter overlaps the next network
        # receive), and blocks per multi-block round trip over the wire.
        self.stage_wave_pages = max(1, stage_wave_pages)
        self.onboard_wave_blocks = max(1, onboard_wave_blocks)
        self.fetch_batch_blocks = max(1, fetch_batch_blocks)
        # Transfer-vs-recompute gate (engine/costs.py). None admits every
        # restorable block (tests of the mechanics); EnginePod passes its
        # model's gate.
        self.cost_model = cost_model
        # hash -> None, insertion-ordered: the host store's eviction queue.
        self._staged: "OrderedDict[int, None]" = OrderedDict()
        # hash -> (payload, source): payloads the async prefetcher already
        # pulled into host RAM; load_chain lands them at insert-only cost.
        self._ready: "OrderedDict[int, Tuple[bytes, str]]" = OrderedDict()
        self._ready_cap = max(0, prefetch_capacity_blocks)
        # Eager staging (stage_async): hash -> in-flight snapshot entry.
        # Bounded by _async_stage_cap pages of un-resolved snapshots so
        # pending gather outputs cannot hold device memory without limit.
        self._pending_stage: Dict[int, dict] = {}
        self._pending_pages = 0
        self._async_stage_cap = max(0, async_stage_capacity_pages)
        self._stage_q: "queue.Queue[Optional[dict]]" = queue.Queue()
        self._stage_thread: Optional[threading.Thread] = None
        self._mu = threading.Lock()  # guards _staged and _ready
        self._prefetch_q: "queue.Queue[Optional[List[int]]]" = queue.Queue()
        self._prefetch_thread: Optional[threading.Thread] = None
        self._inflight: set = set()  # hashes queued/being fetched
        self._closed = False
        self.stats: Dict[str, int] = {
            "offloads": 0, "restores": 0, "onboards": 0, "host_evictions": 0,
            "gated_blocks": 0, "prefetched": 0, "ready_hits": 0,
            "stage_waves": 0, "batched_fetches": 0,
        }

    # -- BlockManager hook: reclaim → offload ------------------------------

    def reclaim_hook(
        self, chunk_hash: int, token_ids: List[int],
        parent_hash: Optional[int], page_id: int,
        lora_id: Optional[int] = None,
    ) -> None:
        self.reclaim_many_hook(
            [(chunk_hash, token_ids, parent_hash, page_id, lora_id)]
        )

    def reclaim_many_hook(self, blocks: List[tuple]) -> None:
        """Batched reclaim→offload: one device extract dispatch for the
        whole reclaim wave. `blocks`: (hash, token_ids, parent, page_id,
        lora_id) tuples. Only blocks actually host-resident afterwards
        count as offloads — a failed stage is not an offload."""
        self.stats["offloads"] += self._stage_many(blocks)

    # -- P/D disaggregation: stage without reclaiming ----------------------

    def export_block(
        self, chunk_hash: int, token_ids: List[int],
        parent_hash: Optional[int], page_id: int,
        lora_id: Optional[int] = None,
    ) -> None:
        self._stage_many(
            [(chunk_hash, token_ids, parent_hash, page_id, lora_id)]
        )

    def export_blocks(self, blocks: List[tuple]) -> None:
        """Stage a sequence's committed pages in one extract dispatch
        (engine.export_sequence — the P/D disaggregation push)."""
        self._stage_many(blocks)

    # -- BlockManager hook: miss → restore/onboard -------------------------

    def page_loader(
        self, chunk_hash: int, token_ids: List[int],
        parent_hash: Optional[int], page_id: int,
    ) -> bool:
        landed = self.load_chain(
            [(chunk_hash, token_ids, parent_hash)], lambda k: [page_id]
        )
        return len(landed) == 1

    def plan_restore(self, chunk_hashes: List[int]) -> int:
        """Longest prefix of `chunk_hashes` WORTH materializing: membership
        checks (prefetched payloads, local host store, then peer index —
        no bytes moved), truncated by the transfer-vs-recompute gate. The
        block manager calls this before grabbing pages so a chain restore
        allocates exactly what will land."""
        sources: List[str] = []
        for h in chunk_hashes:
            source = self._source_of(h)
            if source is None:
                break
            sources.append(source)
        if not sources:
            return 0
        if self.cost_model is None:
            return len(sources)
        # page_size scales cost and savings identically, so 1 suffices.
        admitted = self.cost_model.admit_prefix(sources, 1)
        self.stats["gated_blocks"] += len(sources) - admitted
        return admitted

    def _live_fetch_admissible(self, so_far: List[str], source: str) -> bool:
        """Cumulative gate re-check for a critical-path fetch: admit block
        len(so_far) at `source` cost only if the whole chain so far plus
        it stays admissible — the same arithmetic plan_restore ran, at the
        costs actually being paid."""
        if self.cost_model is None:
            return True
        return self.cost_model.admit_prefix(so_far + [source], 1) == len(so_far) + 1

    def _source_of(self, chunk_hash: int) -> Optional[str]:
        """Cheapest available source for a block, or None when absent
        everywhere (READY beats STAGED beats PEER — same order load_chain
        fetches)."""
        with self._mu:
            if chunk_hash in self._ready:
                return READY
            if chunk_hash in self._staged:
                return STAGED
        if self.peer_resolver is not None and self.peer_resolver(chunk_hash) is not None:
            return PEER
        return None

    def load_chain(self, blocks: List[tuple], take_pages) -> List[int]:
        """Materialize a chain prefix, pipelined: payloads are fetched in
        chain order (prefetched ready buffer, then local host store, then
        peers over the wire — consecutive same-peer blocks ride ONE multi-block
        round trip instead of one per block) and land in waves of
        `onboard_wave_blocks`: each wave calls `take_pages(k)` for exactly
        the pages its fetched payloads need and dispatches one insert. The
        device insert is asynchronous, so a wave's H2D onboard overlaps
        the next wave's network receive. `blocks`: (chunk_hash, token_ids,
        parent_hash) in chain order. Returns the landed page ids (aligned
        with the block prefix) — fetches stop at the first miss so the
        hash chain never gets a hole, and fetch-before-take means a stale
        plan cannot evict HBM-cached pages for a restore that lands
        nothing.

        A root trace in the flight recorder (`transfer.load_chain`; a
        nested stage when the caller is already traced), with the
        staged/peer fetches and onboard waves as child spans."""
        with obs.request("transfer.load_chain", {"blocks": len(blocks)}):
            return self._load_chain_impl(blocks, take_pages)

    def _load_chain_impl(self, blocks: List[tuple], take_pages) -> List[int]:
        landed: List[int] = []
        buffer: List[tuple] = []  # fetched, not yet landed: (payload, stat)
        cost_sources: List[str] = []  # what each fetched block actually cost
        max_size = max(self.codec.page_nbytes, 1)
        wave = self.onboard_wave_blocks
        exhausted = False

        def land_wave() -> None:
            """Take pages for the buffered payloads and dispatch ONE insert.
            A short take (pool exhausted) lands what fits and stops the
            chain — nothing more could land anyway."""
            nonlocal buffer, exhausted
            if not buffer or exhausted:
                buffer = []
                return
            with obs.stage("transfer.onboard_wave"):
                page_ids = take_pages(len(buffer))
                use = buffer[: len(page_ids)]
                if use:
                    self.codec.insert_many(
                        [(pid, p) for pid, (p, _) in zip(page_ids, use)]
                    )
                    for _, stat in use:
                        self.stats[stat] += 1
                    landed.extend(page_ids[: len(use)])
            if len(use) < len(buffer):
                exhausted = True
            buffer = []

        i = 0
        n = len(blocks)
        while i < n and not exhausted:
            chunk_hash = blocks[i][0]
            payload = None
            stat = None
            with self._mu:
                ready = self._ready.pop(chunk_hash, None)
                staged = chunk_hash in self._staged
            if ready is not None:
                # Prefetched: the fetch already happened off the critical
                # path; classify by where the prefetcher got it so the
                # restore/onboard stats stay truthful.
                payload, stat = ready[0], (
                    "restores" if ready[1] == STAGED else "onboards"
                )
                cost_sources.append(READY)
                self.stats["ready_hits"] += 1
            if payload is None and staged:
                # plan_restore may have admitted this block at READY cost
                # and the ready entry got evicted since (prefetcher cap
                # churn): re-check the gate at the cost actually paid, so
                # a transfer the economics refuse cannot sneak onto the
                # critical path through that race.
                if not self._live_fetch_admissible(cost_sources, STAGED):
                    break
                payload = self.connector.fetch_staged(chunk_hash, max_size)
                if payload is not None:
                    stat = "restores"
                    cost_sources.append(STAGED)
            if payload is not None:
                buffer.append((payload, stat))
                i += 1
                if len(buffer) >= wave:
                    land_wave()
                continue

            # Peer leg. Batch the run of consecutive chain blocks
            # that miss the local tiers and resolve to the SAME peer into
            # one multi-block round trip — the serial protocol paid one
            # RTT per block per chain. When the index shows additional
            # holders for the run's head, they ride along as hedge/
            # fallback targets (first valid reply wins; see
            # _fetch_peer_many).
            if self.peer_resolver is None:
                break
            addr = self.peer_resolver(chunk_hash)
            if addr is None:
                break
            candidates = self._peer_candidates(chunk_hash, addr)
            run = [chunk_hash]
            j = i + 1
            while j < n and len(run) < self.fetch_batch_blocks:
                h = blocks[j][0]
                with self._mu:
                    local = h in self._ready or h in self._staged
                if local or self.peer_resolver(h) != addr:
                    break
                run.append(h)
                j += 1
            if self.cost_model is not None:
                # Same cumulative arithmetic as the per-block gate, applied
                # to the whole run at once: admit only the prefix the
                # economics accept at PEER cost.
                admitted = self.cost_model.admit_prefix(
                    cost_sources + [PEER] * len(run), 1
                ) - len(cost_sources)
                if admitted <= 0:
                    break
                run = run[:admitted]
            payloads = self._fetch_peer_many(
                addr, run, max_size, candidates=candidates
            )
            miss = False
            for payload in payloads:
                if payload is None:
                    miss = True
                    break
                buffer.append((payload, "onboards"))
                cost_sources.append(PEER)
                i += 1
                if len(buffer) >= wave and not exhausted:
                    land_wave()
            if miss:
                break
        land_wave()
        return landed

    def _peer_candidates(
        self, chunk_hash: int, primary: Tuple[str, int]
    ) -> List[Tuple[str, int]]:
        """Holder list for a hedged fetch: the resolver's primary pick
        first (bit-identical healthy-path behavior), then the remaining
        holders in the resolver's rendezvous ranking. Resolvers without a
        `candidates` form (fakes, plain callables) yield just the
        primary — no hedging."""
        candidates_fn = getattr(self.peer_resolver, "candidates", None)
        if candidates_fn is None:
            return [primary]
        try:
            ranked = candidates_fn(chunk_hash)
        except Exception:  # noqa: BLE001 - hedging is an optimization
            return [primary]
        out = [primary]
        for addr in ranked:
            if addr != primary:
                out.append(addr)
        return out

    def _fetch_peer_many(
        self,
        addr: Tuple[str, int],
        hashes: List[int],
        max_size: int,
        candidates: Optional[List[Tuple[str, int]]] = None,
    ) -> List[Optional[bytes]]:
        """One multi-block round trip over the wire when the connector supports it
        (KVConnector.onboard_payloads); per-block fetches otherwise (fake
        connectors in tests, stale .so builds). With >= 2 candidate
        holders and a hedging-capable connector, the fetch is hedged: the
        primary gets an adaptive latency budget, then the next
        rendezvous-ranked holder is raced — the first valid reply wins,
        so a slow/corrupt/broken peer costs the hedge delay instead of
        the full timeout ladder."""
        with obs.stage("transfer.peer_fetch"):
            if candidates is not None and len(candidates) > 1:
                hedged = getattr(
                    self.connector, "onboard_payloads_hedged", None
                )
                if hedged is not None:
                    self.stats["batched_fetches"] += 1
                    return hedged(candidates, hashes, max_size)
            batched = getattr(self.connector, "onboard_payloads", None)
            if batched is not None and len(hashes) > 1:
                self.stats["batched_fetches"] += 1
                return batched(addr[0], addr[1], hashes, max_size)
            out: List[Optional[bytes]] = []
            for h in hashes:
                payload = self.connector.onboard_payload(
                    addr[0], addr[1], h, max_size
                )
                out.append(payload)
                if payload is None:
                    break  # chain cut: later blocks can't land anyway
            return out

    def _fetch_staged_many(
        self, hashes: List[int], max_size: int,
    ) -> List[Optional[bytes]]:
        with obs.stage("transfer.staged_fetch"):
            batched = getattr(self.connector, "fetch_staged_many", None)
            if batched is not None and len(hashes) > 1:
                return batched(hashes, max_size)
            return [self.connector.fetch_staged(h, max_size) for h in hashes]

    # -- async prefetch ----------------------------------------------------

    def prefetch(self, chunk_hashes: List[int]) -> int:
        """Queue block payload fetches on the background prefetcher. The
        network/loopback fetch happens off the serving thread; the device
        insert still happens at allocate time, from the ready buffer, at
        insert-only cost. Returns how many fetches were queued.

        Gate: a prefetched block lands at insert-only cost, so prefetch
        only when even that cost beats recompute (insert cost is uniform
        per block, so the single-block check is exact for whole chains)."""
        if self._ready_cap <= 0 or self._closed:
            return 0
        if self.cost_model is not None and self.cost_model.admit_prefix(
            [READY], 1
        ) == 0:
            return 0
        # Membership-filter BEFORE charging the ready-cap budget: a submit
        # can carry dozens of hashes that exist nowhere, and each would
        # otherwise consume a budget slot (displacing genuinely restorable
        # blocks from this submit) just to be discarded by the background
        # fetch. _source_of is membership-only — no bytes move.
        candidates = [h for h in chunk_hashes if self._source_of(h) is not None]
        if not candidates:
            return 0
        todo: List[int] = []
        with self._mu:
            # Never fetch past the ready-buffer cap: chains restore
            # head-first, so fetching a long tail would evict the head —
            # the part load_chain consumes first — and the evicted
            # payloads' fetch traffic would be pure waste.
            budget = self._ready_cap - len(self._ready) - len(self._inflight)
            for h in candidates:
                if budget <= 0:
                    break
                if h in self._ready or h in self._inflight:
                    continue
                self._inflight.add(h)
                todo.append(h)
                budget -= 1
        if not todo:
            return 0
        self._ensure_prefetcher()
        self._prefetch_q.put(todo)
        return len(todo)

    def _ensure_prefetcher(self) -> None:
        if self._prefetch_thread is None or not self._prefetch_thread.is_alive():
            self._prefetch_thread = threading.Thread(
                target=self._prefetch_loop, name="kv-tier-prefetch", daemon=True
            )
            self._prefetch_thread.start()

    def _prefetch_loop(self) -> None:
        while True:
            batch = self._prefetch_q.get()
            if batch is None:
                return
            try:
                # On close, drain without fetching: pending batches must
                # not hold the connector open through slow-peer timeouts
                # after the pod is being torn down.
                if not self._closed:
                    self._prefetch_batch(batch)
            except Exception as e:  # noqa: BLE001 - best-effort warming
                logger.debug("prefetch batch failed: %s", e)
            finally:
                with self._mu:
                    for h in batch:
                        self._inflight.discard(h)

    def _prefetch_batch(self, batch: List[int]) -> None:
        """Warm a whole submit's worth of blocks with batched fetches: one
        loopback round trip for the host-staged run, one multi-block
        round trip per peer (instead of one connection + RTT per block)."""
        # A root trace of its own: this runs on the background prefetcher
        # thread, where no request trace is ever active.
        with obs.request("transfer.prefetch_batch", {"blocks": len(batch)}):
            self._prefetch_batch_impl(batch)

    def _prefetch_batch_impl(self, batch: List[int]) -> None:
        max_size = max(self.codec.page_nbytes, 1)
        with self._mu:
            todo = [h for h in batch if h not in self._ready]
            staged_set = {h for h in todo if h in self._staged}
        staged_run = [h for h in todo if h in staged_set]
        peer_runs: "OrderedDict[Tuple[str, int], List[int]]" = OrderedDict()
        if self.peer_resolver is not None:
            for h in todo:
                if h in staged_set:
                    continue
                addr = self.peer_resolver(h)
                if addr is not None:
                    peer_runs.setdefault(addr, []).append(h)
        fetched: List[tuple] = []  # (hash, payload, source) in chain order
        if staged_run:
            for h, payload in zip(
                staged_run, self._fetch_staged_many(staged_run, max_size)
            ):
                if payload is not None:
                    fetched.append((h, payload, STAGED))
        for addr, run in peer_runs.items():
            for h, payload in zip(run, self._fetch_peer_many(addr, run, max_size)):
                if payload is not None:
                    fetched.append((h, payload, PEER))
        if not fetched:
            return
        with self._mu:
            for h, payload, source in fetched:
                if h not in self._ready:
                    self._ready[h] = (payload, source)
            while len(self._ready) > self._ready_cap:
                self._ready.popitem(last=False)  # payload copies; no event
        self.stats["prefetched"] += len(fetched)

    def close(self) -> None:
        """Stop the prefetcher and stager (idempotent; safe when they never
        started). Pending batches drain unfetched/unresolved — see
        _prefetch_loop / _stager_loop."""
        with self._mu:
            # Under _mu: stage_async's closed-check is also under the lock,
            # so a racing free() can no longer register entries (and
            # _ensure_stager no longer spawns) after this point.
            self._closed = True
        if self._prefetch_thread is not None and self._prefetch_thread.is_alive():
            self._prefetch_q.put(None)
            self._prefetch_thread.join(timeout=5.0)
        self._prefetch_thread = None
        if self._stage_thread is not None and self._stage_thread.is_alive():
            self._stage_q.put(None)
            self._stage_thread.join(timeout=5.0)
        self._stage_thread = None

    # -- internals ---------------------------------------------------------

    def _stage_many(self, blocks: List[tuple]) -> int:
        """Stage blocks not already host-resident. `blocks`: (hash,
        token_ids, parent, page_id, lora_id). Returns how many of `blocks`
        are host-resident afterwards.

        Waves up to `stage_wave_pages` pay ONE extract dispatch. Bigger
        reclaim waves run double-buffered dispatch-then-drain: wave i+1's
        gather + D2H copy is dispatched BEFORE wave i's payloads are
        admitted, so the device→host DMA overlaps the admit's
        serialization + loopback TCP put + event emission instead of
        serializing behind it.

        Blocks with an in-flight eager snapshot (stage_async) are claimed
        and admitted inline — their content was captured at snapshot time
        and the host copy has been overlapping since, so this path pays
        only the residual sync instead of a fresh extract.

        A root trace in the flight recorder (`transfer.stage`), with
        extract dispatch/drain and host-store admits as child spans."""
        with obs.request("transfer.stage", {"blocks": len(blocks)}):
            return self._stage_many_impl(blocks)

    def _stage_many_impl(self, blocks: List[tuple]) -> int:
        fresh = []
        n_resident = 0
        pending_blocks = []
        pending_entries = []
        with self._mu:
            for block in blocks:
                if block[0] in self._staged:
                    self._staged.move_to_end(block[0])
                    n_resident += 1
                elif block[0] in self._pending_stage:
                    entry = self._pending_stage[block[0]]
                    pending_blocks.append(block)
                    if entry not in pending_entries:
                        pending_entries.append(entry)
                else:
                    fresh.append(block)
        for entry in pending_entries:
            # An entry may cover more blocks than requested; admitting the
            # superset is harmless (they were all freed together).
            self._resolve_entry(entry)
        # Count only the REQUESTED blocks that actually landed (the
        # superset's extras get counted by their own reclaim wave, if any)
        # and fall back to a synchronous extract for requested blocks whose
        # snapshot failed to admit — the page content is still valid here,
        # so losing the snapshot must not lose the block.
        with self._mu:
            for block in pending_blocks:
                if block[0] in self._staged:
                    n_resident += 1
                else:
                    fresh.append(block)
        if not fresh:
            return n_resident
        wave = self.stage_wave_pages
        if len(fresh) <= wave:
            with obs.stage("transfer.stage_extract"):
                payloads = self.codec.extract_many([b[3] for b in fresh])
            return n_resident + self._admit_payloads(fresh, payloads)
        # Dispatch-then-drain double buffering: at most one un-drained wave
        # in flight beyond the one being dispatched, so pending gather
        # outputs stay bounded at 2 waves of pages.
        pending: List[tuple] = []
        for start in range(0, len(fresh), wave):
            w = fresh[start:start + wave]
            try:
                with obs.stage("transfer.stage_extract"):
                    resolve = self.codec.extract_many_async([b[3] for b in w])
            except Exception as e:  # noqa: BLE001 - wave is best-effort
                logger.debug("stage wave dispatch failed: %s", e)
                continue
            pending.append((w, resolve))
            self.stats["stage_waves"] += 1
            if len(pending) >= 2:
                n_resident += self._drain_stage_wave(*pending.pop(0))
        for w, resolve in pending:
            n_resident += self._drain_stage_wave(w, resolve)
        return n_resident

    def _drain_stage_wave(self, blocks: List[tuple], resolve) -> int:
        try:
            with obs.stage("transfer.stage_drain"):
                payloads = resolve()
        except Exception as e:  # noqa: BLE001 - wave is best-effort
            logger.debug("stage wave resolve failed: %s", e)
            return 0
        return self._admit_payloads(blocks, payloads)

    def _admit_payloads(self, blocks: List[tuple], payloads: List[bytes]) -> int:
        """Admit extracted payloads to the host store (capacity-evicting).
        Returns how many landed."""
        with obs.stage("transfer.stage_admit"):
            return self._admit_payloads_impl(blocks, payloads)

    def _admit_payloads_impl(
        self, blocks: List[tuple], payloads: List[bytes]
    ) -> int:
        n_resident = 0
        for (chunk_hash, token_ids, parent_hash, _pid, lora_id), payload in zip(
            blocks, payloads
        ):
            victims: List[int] = []
            with self._mu:
                while len(self._staged) >= self.capacity_blocks:
                    victim, _ = self._staged.popitem(last=False)
                    victims.append(victim)
                    self.stats["host_evictions"] += 1
            # drop() is a server round-trip + event emission — keep it
            # outside the lock so membership checks never stall on I/O.
            for victim in victims:
                self.connector.drop(victim)
            # Per-block isolation: one failed stage must not drop the rest
            # of the wave from the host tier.
            try:
                self.connector.stage(
                    chunk_hash, payload, token_ids,
                    len(token_ids), parent_hash, lora_id,
                )
            except Exception as e:  # noqa: BLE001 - staging is best-effort
                logger.debug("stage failed for %x: %s", chunk_hash, e)
                continue
            with self._mu:
                self._staged[chunk_hash] = None
            n_resident += 1
        return n_resident

    # -- eager (overlapped) staging ----------------------------------------

    def stage_async(self, blocks: List[tuple]) -> int:
        """Begin staging off the critical path: snapshot the pages NOW — one enqueued
        gather whose device→host copy overlaps whatever compute is queued
        behind it — and admit the payloads from the background stager
        thread. A later reclaim finds the blocks either already staged or
        claimable in-flight, instead of paying a synchronous extract on
        the allocation path. Returns the number of snapshots initiated;
        blocks beyond the in-flight budget fall back to the synchronous
        reclaim-time stage."""
        if self._async_stage_cap <= 0 or not blocks:
            return 0
        with self._mu:
            if self._closed:
                return 0
            budget = self._async_stage_cap - self._pending_pages
            fresh = []
            for b in blocks:
                if budget <= 0:
                    break
                if b[0] in self._staged or b[0] in self._pending_stage:
                    continue
                fresh.append(b)
                budget -= 1
            if not fresh:
                return 0
            # Register under the lock (atomic with the membership check so
            # a concurrent stage_async can't double-snapshot), but keep the
            # codec call OUTSIDE it — device I/O under _mu would stall
            # every membership check. Claimants arriving before the
            # snapshot is enqueued wait on `ready`.
            entry = {
                "blocks": fresh, "resolve": None, "claimed": False,
                "ready": threading.Event(), "done": threading.Event(),
            }
            for b in fresh:
                self._pending_stage[b[0]] = entry
            self._pending_pages += len(fresh)
        try:
            entry["resolve"] = self.codec.extract_many_async(
                [b[3] for b in fresh]
            )
        except Exception as e:  # noqa: BLE001 - snapshot is best-effort
            # Unregister so the budget isn't leaked and the blocks fall
            # back to the synchronous reclaim-time stage.
            entry["ready"].set()
            if self._claim_entry(entry):
                self._finish_entry(entry)
            logger.debug("eager stage snapshot failed: %s", e)
            return 0
        entry["ready"].set()
        self._ensure_stager()
        self._stage_q.put(entry)
        return len(fresh)

    def _claim_entry(self, entry: dict) -> bool:
        """Exactly-once claim of an in-flight snapshot (the stager thread
        and an inline reclaim may race for it). The blocks stay registered
        as in flight until _finish_entry: a reclaim that finds one while
        another thread admits it waits for that admit instead of taking
        the block for fresh and extracting it a second time."""
        with self._mu:
            if entry["claimed"]:
                return False
            entry["claimed"] = True
            return True

    def _finish_entry(self, entry: dict) -> None:
        """Its claimant's last step: unregister the snapshot's blocks
        (whether or not they landed), then wake the threads waiting for its
        admit."""
        with self._mu:
            for b in entry["blocks"]:
                self._pending_stage.pop(b[0], None)
            self._pending_pages -= len(entry["blocks"])
        entry["done"].set()

    def _resolve_entry(self, entry: dict) -> int:
        if not self._claim_entry(entry):
            # Another thread (stager vs inline reclaim) owns this entry:
            # wait for its admit so the caller's membership re-check sees
            # the landed blocks instead of paying a duplicate synchronous
            # extract for work already in flight.
            entry["done"].wait(timeout=30.0)
            return 0
        try:
            entry["ready"].wait(timeout=30.0)
            resolve = entry["resolve"]
            if resolve is None:  # snapshot enqueue itself failed
                return 0
            try:
                payloads = resolve()
            except Exception as e:  # noqa: BLE001 - best-effort snapshot
                logger.debug("eager stage resolve failed: %s", e)
                return 0
            return self._admit_payloads(entry["blocks"], payloads)
        finally:
            self._finish_entry(entry)

    def _ensure_stager(self) -> None:
        if self._closed:
            return
        if self._stage_thread is None or not self._stage_thread.is_alive():
            self._stage_thread = threading.Thread(
                target=self._stager_loop, name="kv-tier-stager", daemon=True
            )
            self._stage_thread.start()

    def _stager_loop(self) -> None:
        while True:
            entry = self._stage_q.get()
            try:
                if entry is None:
                    return
                if not self._closed:
                    self._resolve_entry(entry)
                else:
                    if self._claim_entry(entry):  # drop without resolving
                        self._finish_entry(entry)
            except Exception as e:  # noqa: BLE001 - stager must not die
                logger.debug("eager stage failed: %s", e)
            finally:
                self._stage_q.task_done()

    def drain_async_stages(self) -> None:
        """Resolve every in-flight snapshot (test/shutdown helper): claims
        whatever is still pending inline, then waits for the stager thread
        to finish any entry it already claimed but has not admitted."""
        while True:
            with self._mu:
                entries = {
                    id(e): e for e in self._pending_stage.values()
                }
            if not entries:
                break
            for entry in entries.values():
                self._resolve_entry(entry)
        if self._stage_thread is not None and self._stage_thread.is_alive():
            self._stage_q.join()

    @property
    def staged_count(self) -> int:
        with self._mu:
            return len(self._staged)

    # -- residency queries ---------------------------------------------------

    def staged_subset(self, chunk_hashes) -> set:
        """Membership answer over the challenged hashes: which of them are
        host-resident (staged, hence fetchable) RIGHT NOW. One lock
        crossing, no bytes moved — the cheap audit-challenge primitive."""
        with self._mu:
            return {h for h in chunk_hashes if h in self._staged}

    def staged_sample(self, limit: int) -> List[int]:
        """Bounded sample of host-resident hashes, oldest-staged first
        (the re-admit direction of a residency audit: blocks this pod
        holds that the index may have lost)."""
        if limit <= 0:
            return []
        with self._mu:
            return list(itertools.islice(self._staged, limit))


class IndexBackedPeerResolver:
    """Resolve a block hash to a peer pod's transfer address through the
    control-plane index — the routing loop closed over the data plane: the
    indexer knows which pod holds a block and at which tier; pods whose
    entry is host-tier have the bytes staged and fetchable."""

    def __init__(
        self,
        index,
        model_name: str,
        pod_addrs: Mapping[str, Tuple[str, int]],
        self_pod_id: str,
        host_tier: str = "cpu",
        rendezvous_primary: bool = False,
        negative_ttl_s: float = 3.0,
        clock: Callable[[], float] = None,
    ):
        self.index = index
        self.model_name = model_name
        self.pod_addrs = pod_addrs
        self.self_pod_id = self_pod_id
        self.host_tier = host_tier
        # False (default): the primary holder is the index's first
        # matching entry. True: the primary is the per-(chunk, pod)
        # rendezvous winner, which does not depend on the order in which
        # events reached the index.
        self.rendezvous_primary = rendezvous_primary
        # Negative-result cache: a peer that just answered "missing" for
        # a block (note_miss — wired off the TransferClient's
        # on_fetch_misses seam) is demoted from primary for THAT block
        # until the TTL lapses, instead of being re-picked on the very
        # next request while its phantom index entry awaits repair. Other
        # holders move ahead; a peer that is the ONLY holder is still
        # tried (a stale negative must not turn a fetchable block into a
        # permanent miss). With nothing calling note_miss the cache stays
        # empty and candidate order is unchanged from the default
        # behavior. <=0 disables.
        self.negative_ttl_s = negative_ttl_s
        self.clock = clock or time.monotonic
        self._negative: Dict[Tuple[Tuple[str, int], int], float] = {}
        self.negative_skips = 0

    def note_miss(
        self,
        addr: Tuple[str, int],
        chunk_hashes,
        now: Optional[float] = None,
    ) -> None:
        """Record per-(peer, block) explicit-miss answers for the TTL."""
        if self.negative_ttl_s <= 0:
            return
        if now is None:
            now = self.clock()
        for h in chunk_hashes:
            self._negative[(addr, h)] = now + self.negative_ttl_s
        if len(self._negative) > 4096:
            self._negative = {
                k: t for k, t in self._negative.items() if t > now
            }

    def forget_pod(self, pod_identifier: str) -> int:
        """Departure reap hook: drop every negative-cache entry addressed
        to the departed pod (resolved through `pod_addrs` by bare
        identity). Its phantom-miss memory protects nothing once the pod
        is gone, and a replacement pod reusing the address must not
        inherit its predecessor's disclaimers. Returns rows removed."""
        bare = base_pod_identifier(pod_identifier)
        addr = self.pod_addrs.get(pod_identifier) or self.pod_addrs.get(bare)
        if addr is None or not self._negative:
            return 0
        victims = [k for k in self._negative if k[0] == addr]
        for k in victims:
            self._negative.pop(k, None)
        return len(victims)

    def negative_entries(self) -> int:
        """Current negative-cache cardinality."""
        return len(self._negative)

    def _negatively_cached(
        self, addr: Tuple[str, int], chunk_hash: int, now: float
    ) -> bool:
        expiry = self._negative.get((addr, chunk_hash))
        if expiry is None:
            return False
        if expiry <= now:
            self._negative.pop((addr, chunk_hash), None)
            return False
        return True

    def __call__(self, chunk_hash: int) -> Optional[Tuple[str, int]]:
        ranked = self.candidates(chunk_hash)
        return ranked[0] if ranked else None

    def candidates(self, chunk_hash: int) -> List[Tuple[str, int]]:
        """Every fetchable holder of a block, primary first. By default
        the primary is the index's first matching entry (the historical
        `__call__` pick — the healthy path stays bit-identical) and the
        remaining holders follow in per-(chunk, pod) rendezvous order, so
        hedge traffic for a hot block spreads across its replicas instead
        of piling onto one alternate. With `rendezvous_primary` the WHOLE
        list is rendezvous-ordered (order-independent peer choice)."""
        key = Key(self.model_name, chunk_hash)
        hits = self.index.lookup([key], set())
        holders = []  # (rendezvous weight, index order, addr)
        seen = set()
        for order, entry in enumerate(hits.get(key, [])):
            # Compare/resolve by bare pod identity: DP-ranked engines index
            # as "pod@dpR" but the address map (and we) know bare pod ids.
            bare = base_pod_identifier(entry.pod_identifier)
            if bare == base_pod_identifier(self.self_pod_id):
                continue
            if entry.device_tier != self.host_tier:
                continue  # only staged blocks are fetchable
            addr = (
                self.pod_addrs.get(entry.pod_identifier)
                or self.pod_addrs.get(bare)
            )
            if addr is None or addr in seen:
                continue
            seen.add(addr)
            holders.append((fold64(fnv64a(bare.encode()), chunk_hash), order, addr))
        if not holders:
            return []
        if self.rendezvous_primary:
            holders.sort()
            ranked = [addr for _w, _o, addr in holders]
        else:
            first = holders[0]
            rest = sorted(holders[1:])
            ranked = [first[2]] + [addr for _w, _o, addr in rest]
        if not self._negative:
            return ranked
        # Negative-result demotion: holders that just disclaimed this
        # block drop behind the fresh ones (kept — they may be the only
        # holder, and the TTL bounds how long a stale negative can lie).
        now = self.clock()
        fresh = [
            a for a in ranked if not self._negatively_cached(a, chunk_hash, now)
        ]
        if not fresh or fresh[0] == ranked[0]:
            return ranked
        self.negative_skips += 1
        metrics.count_negative_cache_skip()
        return fresh + [a for a in ranked if a not in fresh]
