"""Sharded event-processing pool with per-pod ordering.

Copy of the reference package's `kvevents/pool.py`: messages are sharded to
worker queues by FNV-1a(pod_identifier) % concurrency so all events from one
pod are processed in publish order; workers decode msgpack EventBatches
(with the port's own codec, utils/msgpack_codec.py) and digest them into the
shared KV-block index:

- BlockStored → engine keys from the event's block hashes; request keys
  recomputed from the event's token IDs (continuing the parent chain when the
  parent's request key is known) → index.add.
- BlockRemoved → index.evict per engine key.
- AllBlocksCleared → no-op (engines emit per-block removals too).

Undecodable messages are dropped ("poison pills"), never retried. Port pods
advertise the "gpu"/"cpu" tiers, so the default device tier for events that
carry no medium is "gpu"; events carrying an explicit Medium override it.

Shard queues are bounded. On overflow the OLDEST queued message for that
shard is dropped and counted (`dropped_events`), but its BlockRemoved events
are still applied — by the shard worker between messages, so they stay
ordered after any in-flight store digest: dropping a store self-heals (the
engine re-stores hot blocks, and LRU churn evicts the rest), while dropping a
removal would leave a permanent false-positive entry the engine never
corrects. A victim is decoded AT DROP TIME on the producer thread and only
its BlockRemoved digests are retained; the per-shard pending deque is capped
(`max_pending_drop_removals`), and past the cap the OLDEST pending removal
digest is discarded and counted (`removals_lost`) — a last-resort trade of
index soundness for bounded memory.

Over the native index (kvblock/native_index.py) a whole batch is applied
in one C crossing (`native_digest`).
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from dataclasses import dataclass
from typing import Deque, List, Optional

from llm_d_kv_cache_manager_tpu_torch import obs
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.hashing import fnv32a
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key, PodEntry
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    ChunkedTokenDatabase,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.events import (
    AllBlocksCleared,
    BlockRemoved,
    BlockStored,
    EventBatch,
    hash_as_uint64,
)
from llm_d_kv_cache_manager_tpu_torch.metrics import collector as metrics
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("kvevents.pool")

DEFAULT_DEVICE_TIER = "gpu"  # the tier port pods advertise

# Shared no-op context for the untraced fast path (obs stages only wrap the
# sampled batches — see _process_event).
_NOOP_CTX = contextlib.nullcontext()


@dataclass
class EventPoolConfig:
    zmq_endpoint: str = "tcp://*:5557"
    topic_filter: str = "kv@"
    # Partitioned subscribe (cluster/): when set, overrides `topic_filter`
    # with an explicit filter list — one "kv@<pod-id>@" prefix per owned
    # pod. `ZMQSubscriber.resubscribe` swaps the live set on reassignment.
    topic_filters: Optional[List[str]] = None
    concurrency: int = 4
    default_device_tier: str = DEFAULT_DEVICE_TIER
    # Per-shard queue bound; <=0 means unbounded (not recommended in
    # production — a stalled worker then grows memory without limit).
    max_queue_depth: int = 4096
    # Per-shard cap on retained drop-victim removal digests (see module
    # docstring). Past it the oldest pending digest is discarded and
    # counted in `removals_lost`. <=0 means uncapped.
    max_pending_drop_removals: int = 4096


@dataclass
class Message:
    topic: str
    payload: bytes
    seq: int
    pod_identifier: str
    model_name: str
    # Stamped by add_task (perf_counter): dequeue-time minus this is the
    # shard-queue wait — the stage that separates "digestion is slow" from
    # "a shard worker is backed up" (obs/ write-plane trace).
    enqueue_t: float = 0.0


class EventPool:
    """Sharded worker pool fed by the ZMQ subscriber (or directly in tests)."""

    def __init__(
        self,
        config: Optional[EventPoolConfig],
        index: Index,
        token_processor: ChunkedTokenDatabase,
        health_tracker=None,
        message_filter=None,
        popularity=None,
        load_tracker=None,
        divergence=None,
    ):
        self.config = config or EventPoolConfig()
        self.index = index
        self.token_processor = token_processor
        # Optional partition gate (cluster/partition.py): a predicate over
        # the incoming Message; False means "another replica owns this
        # pod's stream" and the message is discarded before sharding. The
        # belt to the ZMQ topic-filter braces — prefix subscriptions are
        # best-effort (a replica may subscribe broadly while its pod list
        # is still being discovered), ownership here is authoritative.
        self.message_filter = message_filter
        # Seq-tail replay floors (cluster/replica.py warm restart): per
        # (pod_identifier, topic) wire-seq watermarks loaded from a
        # snapshot. A replayed message at-or-below its floor was already
        # applied to the imported view — dropping it is what makes replay
        # idempotent. Cleared by `clear_seq_floors()` once the tail is
        # consumed, so a publisher that later restarts its seq at 0 is not
        # mistaken for stale replay.
        self._seq_floors: dict = {}
        self._filtered = 0
        self._replay_skipped = 0
        # Optional fleethealth.FleetHealthTracker (duck-typed to avoid an
        # import cycle): every decoded batch stamps per-pod liveness and
        # runs seq/ts gap detection; poison pills count as decode failures.
        self.health_tracker = health_tracker
        # Optional placement.ChainPopularityTracker (duck-typed likewise):
        # BlockStored digests credit the stored request keys in the block
        # sketch — fleet-wide re-store traffic is reuse evidence the
        # cost-aware eviction weighs. Observation only; None costs one check.
        self.popularity = popularity
        # Optional fleethealth.load.PodLoadTracker (duck-typed): per-pod
        # BlockRemoved volume feeds the decayed preemption/eviction-pressure
        # signal the load-blend routing policy reads — the wire-visible
        # trace of page-pool churn. Observation only; None costs one check.
        self.load_tracker = load_tracker
        # Optional antientropy.AntiEntropyTracker (duck-typed): a
        # BlockRemoved whose engine key resolves to NOTHING is an orphan —
        # the index never saw the matching store (a dropped event), so the
        # pod's real state diverged from the view in the direction the
        # fetch-miss/audit loop can't see. Counted per pod instead of
        # silently ignored. None (the default) keeps the removal path
        # byte-identical — the extra get_request_key probe (a network RTT
        # on the Redis backend) only runs when a tracker is attached.
        self.divergence = divergence
        depth = max(0, self.config.max_queue_depth)
        self._queues: List["queue.Queue[Optional[Message]]"] = [
            queue.Queue(maxsize=depth) for _ in range(self.config.concurrency)
        ]
        self._workers: List[threading.Thread] = []
        # Removal-only digests of drop-oldest victims — extracted at drop
        # time (producer thread; store payloads discarded there, see module
        # docstring) but APPLIED by the SHARD WORKER between messages: the
        # victim was the oldest queued message, so every message queued
        # before it has already been dequeued — only the worker's single
        # in-flight message could still race, and draining at the top of
        # the worker iteration serializes behind it, preserving per-pod
        # ordering. Entries are (pod_identifier_with_rank, model_name,
        # [BlockRemoved, ...]) tuples, never whole Messages.
        self._pending_drop_removals: List[Deque[tuple]] = [
            collections.deque() for _ in range(self.config.concurrency)
        ]
        self._subscriber = None
        self._started = False
        self._shutdown = False
        self._mu = threading.Lock()
        self._dropped = 0
        self._removals_lost = 0
        self._dropped_mu = threading.Lock()
        # Write-plane trace sampling (obs/): batches are ~10x more frequent
        # than read requests, so only every write_trace_stride-th batch is
        # traced. Racy increments across shard workers only perturb which
        # batch gets sampled.
        self._batch_counter = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self, with_subscriber: bool = True) -> None:
        with self._mu:
            if self._started:
                return
            self._started = True
            self._shutdown = False
            for i, q in enumerate(self._queues):
                t = threading.Thread(
                    target=self._worker_loop, args=(q,), name=f"kvevents-worker-{i}",
                    daemon=True,
                )
                t.start()
                self._workers.append(t)
            if with_subscriber:
                from llm_d_kv_cache_manager_tpu_torch.kvevents.zmq_subscriber import (
                    ZMQSubscriber,
                )

                self._subscriber = ZMQSubscriber(
                    self,
                    self.config.zmq_endpoint,
                    self.config.topic_filters
                    if self.config.topic_filters is not None
                    else self.config.topic_filter,
                )
                self._subscriber.start()

    def shutdown(self) -> None:
        with self._mu:
            if not self._started:
                return
            self._started = False
            self._shutdown = True
        if self._subscriber is not None:
            self._subscriber.stop()
            self._subscriber = None
        # Non-blocking sentinel delivery: a blocking put on a full bounded
        # queue would hang shutdown behind a stuck digest; _offer drops the
        # oldest victim (removals preserved) and never loses a sentinel.
        for shard, q in enumerate(self._queues):
            self._offer(q, None, shard)
        for t in self._workers:
            t.join(timeout=5.0)
        self._workers = []

    def drain(self) -> None:
        """Block until all queued events are processed (test/bench helper)."""
        for q in self._queues:
            q.join()
        # Workers are idle after join (task_done fires post-digest), so
        # flushing any still-pending drop-removals here cannot land before
        # an in-flight store for the same block.
        for pending in self._pending_drop_removals:
            self._flush_pending(pending)

    @staticmethod
    def _flush_pending_pop(pending: "Deque[tuple]") -> Optional[tuple]:
        try:
            return pending.popleft()
        except IndexError:  # lost a check-then-act race with another drainer
            return None

    def _flush_pending(self, pending: "Deque[tuple]") -> None:
        while pending:
            digest = self._flush_pending_pop(pending)
            if digest is None:
                return
            pod, model_name, events = digest
            for ev in events:
                digest_block_removed(self.index, pod, model_name, ev,
                                     self.config.default_device_tier, self.divergence)

    # -- ingestion ---------------------------------------------------------

    @property
    def dropped_events(self) -> int:
        """Messages dropped because their shard queue was full."""
        with self._dropped_mu:
            return self._dropped

    @property
    def removals_lost(self) -> int:
        """BlockRemoved digests discarded because the per-shard pending
        cap was hit — each one is a potential stale index entry."""
        with self._dropped_mu:
            return self._removals_lost

    @property
    def filtered_events(self) -> int:
        """Messages discarded by the partition gate (another replica's)."""
        with self._dropped_mu:
            return self._filtered

    @property
    def replay_skipped(self) -> int:
        """Replayed messages dropped at-or-below their seq floor."""
        with self._dropped_mu:
            return self._replay_skipped

    def set_seq_floors(self, floors: dict) -> None:
        """Install per-(pod_identifier, topic) replay watermarks.

        `floors` maps ``(pod, topic) -> last_applied_seq`` (the counters a
        snapshot carries). Messages at-or-below the floor are no-ops.
        """
        self._seq_floors = dict(floors)

    def clear_seq_floors(self) -> None:
        """End of replay: live-stream seqs flow unfiltered again."""
        self._seq_floors = {}

    def queue_depths(self) -> List[int]:
        """Approximate per-shard queue depth (readiness introspection)."""
        return [q.qsize() for q in self._queues]

    def workers_alive(self) -> int:
        return sum(1 for t in self._workers if t.is_alive())

    def add_task(self, msg: Message) -> None:
        """Shard by FNV-1a(pod) so per-pod ordering is preserved.

        Never blocks: when the shard queue is full the oldest queued message
        is dropped to make room (drop-oldest keeps the freshest view of the
        fleet's cache state). A dropped message still has its BlockRemoved
        events applied — see the module docstring.
        """
        if self._shutdown:
            return  # shutdown in progress: drop quietly
        if self.message_filter is not None and not self.message_filter(msg):
            with self._dropped_mu:
                self._filtered += 1
            return
        if self._seq_floors:
            floor = self._seq_floors.get((msg.pod_identifier, msg.topic))
            if floor is not None and msg.seq <= floor:
                with self._dropped_mu:
                    self._replay_skipped += 1
                return
        if msg.enqueue_t == 0.0:
            msg.enqueue_t = time.perf_counter()
        # Enqueuing before start() is fine — the bounded queue accumulates
        # (drop-oldest past the cap) until workers come up.
        shard = fnv32a(msg.pod_identifier.encode("utf-8")) % len(self._queues)
        self._offer(self._queues[shard], msg, shard)

    def _offer(
        self,
        q: "queue.Queue[Optional[Message]]",
        item: Optional[Message],
        shard: int,
    ) -> None:
        """put_nowait with drop-oldest; never blocks, never loses a sentinel.

        The victim is applied removals-only before being discarded. If the
        victim turns out to be the shutdown sentinel (None), the incoming
        message is dropped instead and the sentinel is restored so the
        worker still exits.
        """
        while True:
            try:
                q.put_nowait(item)
                return
            except queue.Full:
                try:
                    victim = q.get_nowait()
                    q.task_done()
                except queue.Empty:
                    continue  # a worker drained it; retry the put
                if victim is None:
                    # Racing a shutdown: restore the sentinel, drop `item`.
                    if item is not None:
                        self._record_drop(item, shard)
                    item = None
                    continue
                self._record_drop(victim, shard)

    def _record_drop(self, victim: Message, shard: int) -> None:
        # Extract the victim's removals NOW (producer thread — decoding one
        # msgpack batch per dropped message is the bounded backpressure we
        # want) but hand them to the shard worker for APPLICATION: the
        # worker may still be digesting an older message whose BlockStored
        # for the same block hasn't landed, and a producer-thread removal
        # could then be overwritten by that late store — the exact false
        # positive the removals-kept policy exists to prevent. Store-only
        # victims retain NOTHING: their payloads (the big token-id lists)
        # die here, which is what keeps a stuck worker's pending buffer
        # from regrowing without bound.
        digest = self._extract_removals(victim)
        lost = 0
        if digest is not None:
            pending = self._pending_drop_removals[shard]
            cap = self.config.max_pending_drop_removals
            while cap > 0 and len(pending) >= cap:
                stale = self._flush_pending_pop(pending)
                if stale is None:
                    break
                lost += len(stale[2])
            pending.append(digest)
        metrics.count_event_dropped()
        with self._dropped_mu:
            self._dropped += 1
            dropped = self._dropped
            self._removals_lost += lost
            removals_lost = self._removals_lost
        if lost:
            logger.warning(
                "pending drop-removal cap hit on shard %d: discarded %d "
                "BlockRemoved digest(s) (%d lost total) — the index may "
                "retain stale entries for those blocks",
                shard, lost, removals_lost,
            )
        if dropped == 1 or dropped % 1000 == 0:
            logger.warning(
                "event ingest overloaded: dropped %d message(s) "
                "(shard %d full at depth %d) — oldest-first, removals kept",
                dropped, shard, self.config.max_queue_depth,
            )

    def _extract_removals(self, msg: Message) -> Optional[tuple]:
        """(pod_with_rank, model, [BlockRemoved...]) of a message being
        dropped — or None when it carries no removals (nothing retained).

        Evictions are cheap (no token re-hashing) and must not be lost: a
        missed removal leaves a false-positive index entry the engine never
        corrects.
        """
        try:
            batch = EventBatch.from_msgpack(msg.payload)
        except Exception:  # noqa: BLE001 - poison pill: nothing to preserve
            return None
        pod = msg.pod_identifier
        rank = batch.data_parallel_rank
        if isinstance(rank, int) and not isinstance(rank, bool) and rank >= 0:
            pod = f"{pod}@dp{rank}"
        removals = [e for e in batch.events if isinstance(e, BlockRemoved)]
        if not removals:
            return None
        return (pod, msg.model_name, removals)

    # -- workers -----------------------------------------------------------

    def _worker_loop(self, q: "queue.Queue[Optional[Message]]") -> None:
        shard = self._queues.index(q)
        pending = self._pending_drop_removals[shard]
        while True:
            msg = q.get()
            try:
                if msg is not None:
                    self._process_event(msg)
            except Exception as e:  # noqa: BLE001 - a worker must never die
                logger.warning(
                    "event processing failed (topic=%s): %s",
                    getattr(msg, "topic", "?"), e,
                )
            # Apply dropped victims' removals AFTER the dequeued message:
            # `msg` left the queue before any currently-pending victim was
            # dropped (drops only evict messages still queued), so it is
            # older than every victim — flushing before it would let a
            # store digest overwrite a removal that arrived later.
            try:
                self._flush_pending(pending)
            except Exception as e:  # noqa: BLE001 - a worker must never die
                logger.warning("pending drop flush failed: %s", e)
            q.task_done()
            if msg is None:
                return

    def _process_event(self, msg: Message) -> None:
        if obs.enabled():
            self._batch_counter += 1
            stride = max(1, obs.get_config().write_trace_stride)
            if self._batch_counter % stride == 0:
                with obs.request("write.digest", {"topic": msg.topic}):
                    if msg.enqueue_t:
                        obs.record(
                            "write.queue_wait", msg.enqueue_t,
                            time.perf_counter(),
                        )
                    self._process_event_impl(msg, traced=True)
                return
        self._process_event_impl(msg)

    def _process_event_impl(self, msg: Message, traced: bool = False) -> None:
        try:
            with obs.stage("write.decode") if traced else _NOOP_CTX:
                batch = EventBatch.from_msgpack(msg.payload)
        except Exception as e:  # noqa: BLE001 - poison pill: drop, don't retry
            logger.debug("dropping undecodable event batch (topic=%s): %s", msg.topic, e)
            if self.health_tracker is not None:
                self.health_tracker.observe_decode_failure(msg.pod_identifier)
            return
        # DP-rank-aware identity: a DP>1 engine runs one cache per rank, so
        # rank r's blocks are indexed under "pod@dpR" — otherwise the ranks
        # alias one identity and the scorer credits the pod for blocks only
        # one of its ranks holds.
        pod = msg.pod_identifier
        rank = batch.data_parallel_rank
        if isinstance(rank, int) and not isinstance(rank, bool) and rank >= 0:
            pod = f"{pod}@dp{rank}"
        elif rank is not None:
            logger.debug("ignoring invalid data_parallel_rank %r", rank)
        if self.health_tracker is not None:
            # Liveness + stream-integrity check BEFORE digesting, under the
            # same DP-rank-qualified identity the index entries use, so the
            # tracker's state keys always match score keys.
            self.health_tracker.observe_batch(pod, msg.topic, msg.seq, batch.ts)
        with obs.stage("write.index_apply") if traced else _NOOP_CTX:
            self._digest_events(pod, msg.model_name, batch)
        # Event publish → index visible, observed for EVERY batch (the
        # fleet-wide index-staleness signal, not a sampled trace stage).
        # batch.ts is the publisher's wall clock; sim/bench batches carry
        # synthetic ts values, which the plausibility window screens out.
        ts = batch.ts
        if isinstance(ts, float) and ts > 0.0:
            delay = time.time() - ts
            if 0.0 <= delay < 3600.0:
                metrics.observe_apply_delay(delay)

    def _digest_events(self, pod_identifier: str, model_name: str, batch: EventBatch) -> None:
        """Digest one decoded batch under this pool's tier default and hooks."""
        digest_events(
            self.index, self.token_processor, pod_identifier, model_name, batch,
            self.config.default_device_tier, self.popularity, self.load_tracker,
            self.divergence,
        )


# -- digestion -------------------------------------------------------------
# Free functions over the index, the token processor and the optional hooks,
# so that an in-process caller (kvevents/digest.py) digests through the same
# code as the pool's workers without building a pool.


def digest_events(
    index: Index,
    token_processor: ChunkedTokenDatabase,
    pod_identifier: str,
    model_name: str,
    batch: EventBatch,
    default_device_tier: str = DEFAULT_DEVICE_TIER,
    popularity=None,
    load_tracker=None,
    divergence=None,
) -> None:
    """Digest every event of one batch, in order."""
    if native_digest(
        index, token_processor, pod_identifier, model_name, batch,
        default_device_tier, popularity, load_tracker, divergence,
    ):
        return
    for event in batch.events:
        if isinstance(event, BlockStored):
            digest_block_stored(index, token_processor, pod_identifier, model_name, event,
                                default_device_tier, popularity)
        elif isinstance(event, BlockRemoved):
            if load_tracker is not None and event.block_hashes:
                load_tracker.observe_removed_blocks(
                    pod_identifier, len(event.block_hashes)
                )
            digest_block_removed(index, pod_identifier, model_name, event,
                                 default_device_tier, divergence)
        elif isinstance(event, AllBlocksCleared):
            continue  # engines emit per-block removals as well


def native_digest(
    index: Index,
    token_processor: ChunkedTokenDatabase,
    pod_identifier: str,
    model_name: str,
    batch: EventBatch,
    default_device_tier: str = DEFAULT_DEVICE_TIER,
    popularity=None,
    load_tracker=None,
    divergence=None,
) -> bool:
    """Apply the whole decoded batch against the native arena in one
    GIL-released crossing (kvscore.c `apply_batch`), chain-deriving
    request keys in C. Returns False when the batch must take the
    pure-Python digest instead: non-native index backend, a subsystem
    the arena doesn't model (popularity store-observes, divergence
    orphan probes, a non-fnv64 hash chain), or a conversion error —
    the latter counted in `native_index.fallback_total()`. The arena is
    untouched on failure, so the Python path replays the batch to the
    exact same final state. The chain memo isn't warmed by native
    digestion (a read-path perf cache, not state).
    """
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.native_index import (
        NativeScoringIndex,
        count_fallback,
    )

    inner = getattr(index, "inner", index)
    if not isinstance(inner, NativeScoringIndex):
        return False
    if popularity is not None or divergence is not None:
        return False
    tp = token_processor
    if tp.config.hash_algo != "fnv64_cbor":
        return False

    shaped: List[tuple] = []
    removed_counts: List[int] = []
    for event in batch.events:
        if isinstance(event, BlockStored):
            tier = (event.medium or default_device_tier).lower()
            packed = inner.intern_entry(pod_identifier, tier)
            lora_id = event.lora_id
            if (
                not isinstance(lora_id, int)
                or isinstance(lora_id, bool)
                or lora_id < 0
            ):
                if lora_id is not None:
                    logger.debug(
                        "ignoring invalid lora_id %r in BlockStored", lora_id,
                    )
                lora_id = None
            extra = (lora_id,) if lora_id is not None else None
            shaped.append((
                1, event.block_hashes, event.parent_block_hash,
                event.token_ids, extra, packed,
            ))
        elif isinstance(event, BlockRemoved):
            tier = (event.medium or default_device_tier).lower()
            packed = inner.intern_entry(pod_identifier, tier)
            shaped.append((0, event.block_hashes, packed))
            removed_counts.append(
                len(event.block_hashes) if event.block_hashes else 0
            )
        elif isinstance(event, AllBlocksCleared):
            continue  # engines emit per-block removals as well
    try:
        inner.apply_batch(model_name, tp.init_hash, tp.block_size, shaped)
    except Exception as e:  # noqa: BLE001 - arena untouched: replay
        # the batch through the Python digest for an identical result.
        count_fallback()
        logger.debug("native digest fell back to the Python path: %s", e)
        return False
    # Load-tracker pre-pass AFTER the apply succeeded — running it during
    # shaping would double-count if we then fell back.
    if load_tracker is not None:
        for n in removed_counts:
            if n:
                load_tracker.observe_removed_blocks(pod_identifier, n)
    return True


def digest_block_stored(
    index: Index,
    token_processor: ChunkedTokenDatabase,
    pod_identifier: str,
    model_name: str,
    ev: BlockStored,
    default_device_tier: str = DEFAULT_DEVICE_TIER,
    popularity=None,
) -> None:
    tier = (ev.medium or default_device_tier).lower()
    entries = [PodEntry(pod_identifier, tier)]

    engine_keys: List[Key] = []
    for raw in ev.block_hashes:
        try:
            engine_keys.append(Key(model_name, hash_as_uint64(raw)))
        except (TypeError, ValueError) as e:
            logger.debug("bad block hash in BlockStored: %s", e)

    parent_request_key: Optional[Key] = None
    if ev.parent_block_hash is not None:
        try:
            parent_engine_key = Key(model_name, hash_as_uint64(ev.parent_block_hash))
        except (TypeError, ValueError) as e:
            logger.debug("bad parent hash in BlockStored: %s", e)
            return
        parent_request_key = index.get_request_key(parent_engine_key)

    # lora_id arrives off the untrusted wire: accept only non-negative
    # ints, otherwise treat the event as non-LoRA rather than poisoning
    # the hash chain (or the worker).
    lora_id = ev.lora_id
    if not isinstance(lora_id, int) or isinstance(lora_id, bool) or lora_id < 0:
        if lora_id is not None:
            logger.debug("ignoring invalid lora_id %r in BlockStored", lora_id)
        lora_id = None

    request_keys = token_processor.tokens_to_kv_block_keys(
        parent_request_key, ev.token_ids, model_name, lora_id=lora_id
    )

    if popularity is not None and request_keys:
        popularity.observe_store([k.chunk_hash for k in request_keys])

    if engine_keys:
        try:
            index.add(engine_keys, request_keys, entries)
        except ValueError as e:
            logger.debug("failed to add BlockStored to index: %s", e)


def digest_block_removed(
    index: Index,
    pod_identifier: str,
    model_name: str,
    ev: BlockRemoved,
    default_device_tier: str = DEFAULT_DEVICE_TIER,
    divergence=None,
) -> None:
    tier = (ev.medium or default_device_tier).lower()
    entries = [PodEntry(pod_identifier, tier)]
    for raw in ev.block_hashes:
        try:
            engine_key = Key(model_name, hash_as_uint64(raw))
        except (TypeError, ValueError) as e:
            logger.debug("bad block hash in BlockRemoved: %s", e)
            continue
        if divergence is not None:
            try:
                known = index.get_request_key(engine_key) is not None
            except Exception as e:  # noqa: BLE001 - probe must not kill
                logger.debug("orphan probe failed: %s", e)  # the worker
                known = True  # can't tell: digest normally
            if not known:
                # Orphan removal: the index never stored this block —
                # divergence evidence, and nothing to evict.
                divergence.observe_orphan_removal(pod_identifier)
                continue
        try:
            index.evict(engine_key, entries)
        except ValueError as e:
            logger.debug("failed to evict from index: %s", e)
