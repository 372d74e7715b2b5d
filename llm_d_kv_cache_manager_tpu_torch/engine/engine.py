"""EnginePod: a minimal vLLM-style serving pod on torch.

Port of the reference package's `engine/engine.py` in model mode: the device
path (models/llama.py + ops/) and the host path (engine/block_manager.py)
together, publishing the same KVEvents a real engine would to an in-process
event sink, so the control plane can index the pod's cache.

The pod serves on `config.device` ("cuda" by default; construction raises
when no GPU is present unless "cpu" is asked for), with KV pages in the
model dtype or, with `use_quantized_kv`, in int8. On CUDA every attention
call runs a hand-written kernel.

With `lora_adapters`, the pod serves several LoRA adapters beside the base
model (`models/lora.py`): one layer-stacked registry, index 0 the base, and
each sequence's adapter applied in prefill and decode.

With `enable_host_tier`, the pod has the reference's host tier
(engine/tiering.py over kv_connectors/connector.py): reclaimed pages are
offloaded to a host store, a device miss restores a chain from it or
onboards it from a peer pod over the transfer wire, and `_DevicePageCodec`
moves pages between the device pools and host bytes.

With `tp > 1` the pod is one process of a tensor-parallel pod: every rank
of `config.group` builds an EnginePod on the same weights and drives the
same requests, keeps its Megatron shard of the weights and its head shard
of every page (parallel/serving.py), and the model calls all-reduce and
gather across the group. The block manager, the block tables and the trash
page are the same on every rank; rank 0 alone publishes events, so the tp
pod is one pod to the control plane; every chosen token is group rank 0's,
broadcast (models/llama.py, engine/scheduler.py), so every rank commits the
same pages.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from llm_d_kv_cache_manager_tpu_torch.engine.block_manager import (
    BlockManager,
    BlockManagerConfig,
    OutOfPagesError,
    SequenceState,
)
from llm_d_kv_cache_manager_tpu_torch.engine.tiering import PageCodec
from llm_d_kv_cache_manager_tpu_torch.kvevents.events import EventBatch
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.models import lora as lora_mod
from llm_d_kv_cache_manager_tpu_torch.parallel import serving as tp_serving
from llm_d_kv_cache_manager_tpu_torch.parallel.collectives import broadcast_from_first
from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import MeshCoords
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog
from llm_d_kv_cache_manager_tpu_torch.utils.device import resolve_device

logger = kvlog.get_logger("engine")


def _slice_shape(comp: torch.Tensor) -> tuple:
    """One page's slice of a cache component: [n_layers, n_kv, page, ...]."""
    return tuple(comp.shape[:2]) + tuple(comp.shape[3:])


def _slice_nbytes(comp: torch.Tensor) -> int:
    return int(np.prod(_slice_shape(comp))) * comp.element_size()


def _gather_pages(cache: tuple, page_ids: torch.Tensor) -> torch.Tensor:
    """[N, page_nbytes] uint8 on the cache's device: row n is page
    page_ids[n]'s payload, each component's [:, :, page] slice in C order,
    concatenated in the order of the cache tuple."""
    n = page_ids.numel()
    return torch.cat([
        comp.index_select(2, page_ids).movedim(2, 0).contiguous()
        .view(torch.uint8).reshape(n, -1)
        for comp in cache
    ], dim=1)


def _scatter_pages(cache: tuple, page_ids: torch.Tensor, blocks: torch.Tensor) -> None:
    """In place: comp[:, :, page_ids[n]] = block n's slice of comp, for every
    component (the tuple keeps the same tensors). `blocks` is [N,
    page_nbytes] uint8 on the cache's device. Duplicate ids must carry
    identical rows: their write order is not defined."""
    n = page_ids.numel()
    offset = 0
    for comp in cache:
        nbytes = _slice_nbytes(comp)
        part = blocks[:, offset:offset + nbytes].contiguous().view(comp.dtype)
        comp.index_copy_(2, page_ids, part.reshape((n,) + _slice_shape(comp)).movedim(0, 2))
        offset += nbytes


def _pad_bucket(n: int) -> int:
    """Power-of-2 page-count bucket for the gather and scatter, so a
    captured device program needs O(log) shapes, not one per batch size."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return bucket


class _HostBuffers:
    """Reused pinned host buffers for a CUDA pod's page copies (a pinned
    allocation costs milliseconds). A buffer given back with an event is
    reused only once that event has completed (an H2D copy reads it until
    then)."""

    MAX_FREE = 4

    def __init__(self):
        self._free: List[torch.Tensor] = []
        self._busy: List[Tuple[torch.cuda.Event, torch.Tensor]] = []
        self._mu = threading.Lock()

    def take(self, nbytes: int) -> torch.Tensor:
        with self._mu:
            busy = []
            for event, buf in self._busy:
                if event.query():
                    self._free.append(buf)
                else:
                    busy.append((event, buf))
            self._busy = busy
            fits = [i for i, b in enumerate(self._free) if b.numel() >= nbytes]
            if fits:  # the smallest that fits (list.remove would compare tensors)
                return self._free.pop(min(fits, key=lambda i: self._free[i].numel()))
        return torch.empty(_pad_bucket(max(nbytes, 1)), dtype=torch.uint8, pin_memory=True)

    def give(self, buf: torch.Tensor, after: Optional[torch.cuda.Event] = None) -> None:
        with self._mu:
            if after is not None:
                self._busy.append((after, buf))
                return
            self._free.append(buf)
            if len(self._free) > self.MAX_FREE:  # drop the smallest
                self._free.sort(key=lambda b: b.numel())
                self._free.pop(0)


class _DevicePageCodec(PageCodec):
    """Serializes logical pages across every layer of the pod's KV cache.

    Both layouts (the (k, v) pair in the model dtype, and the int8 (k_q,
    k_scale, v_q, v_scale) quadruple with f32 scales): each component is
    [n_layers, n_kv, n_pages, page_size, ...] with the page axis at 2, and a
    block's bytes are each component's [:, :, page_id] slice in C order,
    concatenated in the order of the cache tuple, the reference package's
    layout byte for byte. N pages cross in one gather (or scatter) and one
    copy.

    On the card, an extract gathers into a fresh device tensor on the
    current stream and copies it into a reused pinned buffer on a side
    stream that waits for the current one; resolve() waits for that copy's
    event. An insert copies the payloads into a pinned buffer, then
    host-to-device and scatters in place on the current stream. On the CPU
    nothing is pinned.
    """

    def __init__(self, pod: "EnginePod"):
        self.pod = pod
        self._cuda = pod.device.type == "cuda"
        self._buffers = _HostBuffers() if self._cuda else None
        self._stream = torch.cuda.Stream(device=pod.device) if self._cuda else None

    @property
    def page_nbytes(self) -> int:
        return sum(_slice_nbytes(c) for c in self.pod.kv_cache)

    def _page_ids(self, ids: List[int]) -> torch.Tensor:
        padded = ids + [ids[-1]] * (_pad_bucket(len(ids)) - len(ids))
        return torch.tensor(padded, dtype=torch.long).to(self.pod.device, non_blocking=True)

    def extract_many(self, page_ids) -> List[bytes]:
        return self.extract_many_async(page_ids)()

    def extract_many_async(self, page_ids):
        """Snapshot pages now and return resolve() -> payloads. The gather
        is queued behind whatever the pod already queued and before any
        later write, so a later overwrite of these pages cannot corrupt the
        snapshot; resolve() (any thread) only waits for the copy's event and
        cuts the bytes."""
        ids = [int(i) for i in page_ids]
        if not ids:
            return lambda: []
        n = len(ids)
        gathered = _gather_pages(self.pod.kv_cache, self._page_ids(ids))[:n]
        if not self._cuda:
            rows = gathered.numpy()
            return lambda: [rows[i].tobytes() for i in range(n)]
        nbytes = gathered.shape[1]
        buf = self._buffers.take(n * nbytes)
        done = torch.cuda.Event()
        self._stream.wait_stream(torch.cuda.current_stream(self.pod.device))
        with torch.cuda.stream(self._stream):
            buf[: n * nbytes].view(n, nbytes).copy_(gathered, non_blocking=True)
            done.record()
        # The allocator must not hand the gathered memory out again before
        # the side stream's copy has read it.
        gathered.record_stream(self._stream)

        def resolve():
            done.synchronize()
            rows = buf[: n * nbytes].view(n, nbytes).numpy()
            out = [rows[i].tobytes() for i in range(n)]
            self._buffers.give(buf)
            return out

        return resolve

    def insert_many(self, items) -> None:
        if not items:
            return
        nbytes = self.page_nbytes
        for _, payload in items:
            if len(payload) != nbytes:
                raise ValueError(f"block payload is {len(payload)} bytes, expected {nbytes}")
        n = len(items)
        if self._cuda:
            buf = self._buffers.take(n * nbytes)
            host = buf[: n * nbytes].view(n, nbytes)
        else:
            host = torch.empty((n, nbytes), dtype=torch.uint8)
        rows = host.numpy()
        for i, (_, payload) in enumerate(items):
            rows[i] = np.frombuffer(payload, dtype=np.uint8)
        blocks = host.to(self.pod.device, non_blocking=True)
        if self._cuda:
            copied = torch.cuda.Event()
            copied.record()
            self._buffers.give(buf, after=copied)
        bucket = _pad_bucket(n)
        if bucket > n:  # pad rows repeat the last item: identical bytes
            blocks = torch.cat([blocks, blocks[-1:].expand(bucket - n, -1)])
        _scatter_pages(self.pod.kv_cache, self._page_ids([int(p) for p, _ in items]), blocks)


@dataclass
class EnginePodConfig:
    pod_id: str = "pod-0"
    model_name: str = "test-model"
    # Set: the pod also publishes its events over ZMQ to the indexer's bound
    # SUB endpoint (kvevents/publisher.py); None -> event_sink only.
    zmq_endpoint: Optional[str] = None
    n_pages: int = 512
    page_size: int = 16
    hash_seed: str = ""
    device_tier: Optional[str] = None  # events' Medium; port pods use "gpu"
    max_pages_per_seq: int = 32
    model_config: Optional[llama.LlamaConfig] = None  # or a mixtral.MixtralConfig
    device: str = "cuda"
    # int8 KV pages: half the device memory per cached token, so twice the
    # prefixes a pod keeps resident (ops/quantized_kv.py).
    use_quantized_kv: bool = False
    # The host tier (engine/tiering.py): reclaimed device pages offload to
    # the C++ host store instead of vanishing, and allocation misses restore
    # from it or onboard from peer pods over the transfer wire. Events name
    # the host store's medium "cpu".
    enable_host_tier: bool = False
    host_capacity_blocks: int = 1024
    transfer_port: int = 0  # 0 -> ephemeral
    # Transfer-vs-recompute gate (engine/costs.py). "auto": a gate from this
    # model's arithmetic intensity x the card's measured rates
    # (costs.MEASURED_RATES). An explicit TransferCostModel (e.g.
    # costs.ALWAYS_TRANSFER) overrides it; None disables gating.
    transfer_cost_model: object = "auto"
    # Ready-buffer bound of the background payload prefetcher (blocks held
    # in host RAM awaiting their device insert); <=0 disables prefetch.
    prefetch_capacity_blocks: int = 64
    # Eager staging: free() snapshots the sequence's committed pages (one
    # gather whose host copy overlaps queued compute) and a background
    # thread admits them to the host store, so a later reclaim finds them
    # resident instead of extracting on the allocation path.
    eager_stage: bool = False
    # Bound on un-resolved eager snapshots (their host buffers stay held
    # until the background admit lands); blocks past it fall back to the
    # reclaim-time stage.
    async_stage_capacity_pages: int = 128
    # Pipelining: pages per extract wave of the stager, blocks per insert
    # wave of a chain onboard (each wave overlaps the next receive), and
    # blocks per multi-block round trip to a peer.
    stage_wave_pages: int = 16
    onboard_wave_blocks: int = 8
    fetch_batch_blocks: int = 32
    # Client bounds: a dead peer costs at most connect/fetch timeout x
    # (retries+1) per chain, then counts as a cache miss.
    transfer_connect_timeout_ms: int = 2000
    transfer_fetch_timeout_ms: int = 5000
    transfer_fetch_retries: int = 1
    # Tensor parallelism: this pod is one rank of a tp-rank pod over `group`
    # (a torch.distributed ProcessGroup of tp ranks, required at tp > 1;
    # parallel.multihost.initialize_distributed starts the default one).
    # tp=1 -> the whole model on this process.
    tp: int = 1
    group: Optional[object] = None


class EnginePod:
    def __init__(
        self,
        config: EnginePodConfig,
        event_sink: Optional[Callable[[EventBatch], None]] = None,
        params=None,
        lora_adapters: Optional[dict] = None,  # {lora_id: models.lora params}
    ):
        self.config = config
        self.device = resolve_device(config.device)
        mc = config.model_config or llama.LlamaConfig()
        self.group = None
        if config.tp > 1:
            self.group = self._tp_group(config, mc, lora_adapters)
        # Rank 0 alone speaks for a tp pod.
        self._publishes = self.group is None or dist.get_rank(self.group) == 0
        self._publisher = None
        if config.zmq_endpoint and self._publishes:
            from llm_d_kv_cache_manager_tpu_torch.kvevents.publisher import (
                Publisher,
                make_topic,
            )

            self._publisher = Publisher(
                config.zmq_endpoint, make_topic(config.pod_id, config.model_name)
            )
        self._sink = event_sink
        self._model_config = mc

        self.tier_store = None
        self.connector = None
        if config.enable_host_tier:
            from llm_d_kv_cache_manager_tpu_torch.engine.costs import TransferCostModel
            from llm_d_kv_cache_manager_tpu_torch.engine.tiering import TieredKVStore
            from llm_d_kv_cache_manager_tpu_torch.kv_connectors.connector import (
                KVConnector,
                KVConnectorConfig,
            )

            self.connector = KVConnector(
                KVConnectorConfig(
                    port=config.transfer_port,
                    connect_timeout_ms=config.transfer_connect_timeout_ms,
                    fetch_timeout_ms=config.transfer_fetch_timeout_ms,
                    fetch_retries=config.transfer_fetch_retries,
                    fetch_batch_size=config.fetch_batch_blocks,
                ),
                event_sink=self._emit,
            )
            cost_model = config.transfer_cost_model
            if cost_model == "auto":
                cost_model = TransferCostModel.for_model(
                    mc, quantized=config.use_quantized_kv)
            self.tier_store = TieredKVStore(
                self.connector, _DevicePageCodec(self),
                capacity_blocks=config.host_capacity_blocks,
                cost_model=cost_model,
                prefetch_capacity_blocks=config.prefetch_capacity_blocks,
                async_stage_capacity_pages=config.async_stage_capacity_pages,
                stage_wave_pages=config.stage_wave_pages,
                onboard_wave_blocks=config.onboard_wave_blocks,
                fetch_batch_blocks=config.fetch_batch_blocks,
            )
        store = self.tier_store
        self.block_manager = BlockManager(
            BlockManagerConfig(
                n_pages=config.n_pages,
                page_size=config.page_size,
                hash_seed=config.hash_seed,
                device_tier=config.device_tier,
            ),
            event_sink=self._emit,
            reclaim_hook=store.reclaim_hook if store else None,
            page_loader=store.page_loader if store else None,
            reclaim_many_hook=store.reclaim_many_hook if store else None,
            chain_planner=store.plan_restore if store else None,
            chain_loader=store.load_chain if store else None,
        )
        # Both model families serve through llama.py's paged ops (the MLP
        # dispatches on the layer dict): a config carrying n_experts is the
        # MoE family (models/mixtral.py).
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            if llama.is_moe_config(mc):
                from llm_d_kv_cache_manager_tpu_torch.models import mixtral

                params = mixtral.init_params(mc, gen, self.device)
            else:
                params = llama.init_params(mc, gen, self.device)
        if llama.is_moe_config(mc) != ("router" in params["layers"]):
            raise ValueError(
                "model_config family does not match params structure "
                "(MoE config needs router/expert params and vice versa)"
            )
        self.params = params
        # One sacrificial page beyond the block manager's pool: packed
        # prefill and multi-step decode steer pad rows and over-budget rows
        # there (llama.verify_step_cache, llama.decode_multi_step_cache), so
        # a rectangular batch never corrupts a real page. No block table
        # refers to it and the block manager never hands it out.
        self.trash_page = config.n_pages
        make = llama.make_kv_pages_quantized if config.use_quantized_kv else llama.make_kv_pages
        if self.group is not None:
            # This rank's shards: the weights under the Megatron specs, the
            # pages' kv heads (made whole, then split: the pools start zero).
            at = MeshCoords({"tp": config.tp}, {"tp": dist.get_rank(self.group)})
            self.params = tp_serving.shard_serving_params(params, at)
            self.kv_cache = tp_serving.shard_kv_cache(
                make(mc, config.n_pages + 1, config.page_size, self.device), at)
        else:
            self.kv_cache = make(mc, config.n_pages + 1, config.page_size, self.device)
        self.last_logits: Optional[torch.Tensor] = None

        # Multi-LoRA registry: adapter weights served per sequence, with the
        # cache already scoped per adapter (block hashes carry lora_id).
        # Index 0 is the zero adapter (base traffic).
        self.lora_stack = None
        self._lora_index: dict = {}
        if lora_adapters:
            ids = sorted(lora_adapters)
            stack = lora_mod.stack_adapters([lora_adapters[i] for i in ids])
            self.lora_stack = {k: v.to(self.device) for k, v in stack.items()}
            self._lora_index = {lid: i + 1 for i, lid in enumerate(ids)}

    @staticmethod
    def _tp_group(config: EnginePodConfig, mc, lora_adapters):
        """The checks of a tp pod, all before any weight, page or thread is
        made; returns its group."""
        if llama.is_moe_config(mc):
            raise NotImplementedError(
                "tp serving for the MoE family needs an expert "
                "sharding spec set (parallel/serving.py covers the "
                "dense family); run MoE pods at tp=1"
            )
        tp_serving.validate_tp(config.tp, mc.n_q_heads, mc.n_kv_heads)
        if config.group is None:
            raise ValueError(
                f"EnginePodConfig(tp={config.tp}) needs group=, a process group of "
                f"its {config.tp} ranks: start one with "
                "parallel.multihost.initialize_distributed (or torch.distributed) "
                "and pass it"
            )
        if dist.get_world_size(config.group) != config.tp:
            raise ValueError(f"tp={config.tp} but the group has "
                             f"{dist.get_world_size(config.group)} ranks")
        if config.enable_host_tier or lora_adapters:
            raise NotImplementedError(
                "a tp pod serves without a host tier and without LoRA adapters")
        return config.group

    # -- events --------------------------------------------------------------

    def _emit(self, batch: EventBatch) -> None:
        if not self._publishes:
            return
        if self._publisher is not None:
            self._publisher.publish(batch)
        if self._sink is not None:
            self._sink(batch)

    # -- serving -------------------------------------------------------------

    def prefill(
        self, tokens: List[int], lora_id: Optional[int] = None
    ) -> Tuple[SequenceState, int]:
        """Admit a sequence: allocate (with prefix reuse), compute the
        uncached suffix in one chunk, commit pages + events. Returns
        (state, cached_tokens)."""
        state, start = self.begin_prefill(tokens, lora_id=lora_id)
        self.prefill_chunk(state, start, len(tokens))
        self.finish_prefill(state)
        return state, state.num_cached_tokens

    def begin_prefill(
        self, tokens: List[int], lora_id: Optional[int] = None
    ) -> Tuple[SequenceState, int]:
        """Allocate pages (with prefix reuse) without computing anything.
        Returns (state, compute_start): num_cached_tokens, except for fully
        cached prompts, whose last position is recomputed for its logits."""
        state = self.block_manager.allocate(tokens, lora_id=lora_id)
        n_cached = state.num_cached_tokens
        if n_cached >= len(tokens):
            n_cached = min(n_cached, len(tokens) - 1)
        return state, n_cached

    def lora_index(self, lora_id: Optional[int]) -> int:
        """Registry index for an adapter id (0 = base). Raises KeyError for
        an unknown adapter, so admission rejects the request."""
        if lora_id is None:
            return 0
        if self.lora_stack is None:
            raise KeyError(f"no LoRA adapters configured (requested {lora_id})")
        return self._lora_index[lora_id]

    def _lora_for_prefill(self, lora_id: Optional[int]):
        """One sequence's adapter (per-layer arrays), or None on a pod that
        serves no adapters."""
        if self.lora_stack is None:
            return None
        return lora_mod.select_adapter(self.lora_stack, self.lora_index(lora_id))

    def lora_for_decode(self, lora_ids):
        """(registry stack, [B] int32 indices on the pod's device) for a
        batch, or None when the pod serves no adapters. The per-row weight
        gather happens inside the llama call, once per call."""
        if self.lora_stack is None:
            return None
        idx = torch.tensor([self.lora_index(i) for i in lora_ids], dtype=torch.int32)
        return self.lora_stack, idx.to(self.device)

    def prefill_chunk(self, state: SequenceState, start: int, end: int) -> None:
        """Compute KV (and logits) for tokens[start:end], attending over the
        first `start` already-resident positions.

        The chunk is padded to a power-of-2 length bucket, exactly as the
        reference pod does: the bucket decides which pages get reserved
        (and so which cached pages get reclaimed under pressure), which is
        what keeps this pod's BlockRemoved stream identical to the
        reference's. Pad rows write garbage KV into reserved-ahead pages past
        `end`; every later real write lands before its position is attended,
        and commits only cover real tokens."""
        length = end - start
        bucket = self.batch_bucket(length)
        if bucket > length:
            ps = self.config.page_size
            pages_needed = (start + bucket + ps - 1) // ps
            if pages_needed > self.config.max_pages_per_seq:
                bucket = length  # capacity-capped: compute unpadded
            else:
                try:
                    self.block_manager.reserve_pages(state, pages_needed)
                except OutOfPagesError:
                    bucket = length  # pool too tight: compute unpadded
        block_table = self._padded_table(state)
        chunk = torch.tensor(
            state.tokens[start:end] + [0] * (bucket - length),
            dtype=torch.int32, device=self.device,
        )
        self.kv_cache, self.last_logits = llama.prefill_cache(
            self._model_config, self.params, self.kv_cache, chunk,
            block_table, start, n_valid=length,
            lora=self._lora_for_prefill(state.lora_id), group=self.group,
        )

    def prefill_chunk_batch(self, jobs) -> List[torch.Tensor]:
        """Compute several sequences' prefill chunks in one batched pass.

        `jobs`: [(state, start, end)], each sequence's tokens[start:end)
        computed while attending its own cached prefix. Returns one
        last-position logits vector per job.

        This is packed prefill: one weight stream for several prompts. The
        op is `llama.verify_step_cache`, with per-sequence `max_lens`
        steering the rectangular batch's pad rows into the trash page, so no
        page is reserved beyond each sequence's real tokens. A single job
        takes `prefill_chunk`."""
        if len(jobs) == 1:
            state, start, end = jobs[0]
            self.prefill_chunk(state, start, end)
            return [self.last_logits]
        lengths = [end - start for _, start, end in jobs]
        l_bucket = self.batch_bucket(max(lengths))
        b_pad = self.batch_bucket(len(jobs))
        # Skew guard: a rectangular batch pays bucket-width compute for every
        # row. When padding more than doubles the real token count,
        # per-sequence length-bucketed chunks are the cheaper shape.
        if b_pad * l_bucket > 2 * sum(lengths):
            out = []
            for state, start, end in jobs:
                self.prefill_chunk(state, start, end)
                out.append(self.last_logits)
            return out
        t_bucket = self.table_bucket(max(len(state.block_table) for state, _, _ in jobs))
        chunk = np.zeros((b_pad, l_bucket), dtype=np.int32)
        tables = np.full((b_pad, t_bucket), self.trash_page, dtype=np.int32)
        starts = np.zeros((b_pad,), dtype=np.int32)
        max_lens = np.zeros((b_pad,), dtype=np.int32)  # pad rows: all trash
        lora_ids = [state.lora_id for state, _, _ in jobs]
        lora_ids += [None] * (b_pad - len(jobs))  # pad rows: the base model
        for i, (state, start, end) in enumerate(jobs):
            chunk[i, : end - start] = state.tokens[start:end]
            tables[i, : len(state.block_table)] = state.block_table
            starts[i] = start
            max_lens[i] = end  # real rows: positions start .. end-1
        dev = self.device
        self.kv_cache, logits = llama.verify_step_cache(
            self._model_config, self.params, self.kv_cache,
            torch.from_numpy(chunk).to(dev), torch.from_numpy(tables).to(dev),
            torch.from_numpy(starts).to(dev), torch.from_numpy(max_lens).to(dev),
            self.trash_page, lora=self.lora_for_decode(lora_ids), group=self.group,
        )
        return [logits[i, lengths[i] - 1] for i in range(len(jobs))]

    def finish_prefill(self, state: SequenceState) -> None:
        """Commit full pages + emit BlockStored, now that every page's KV is
        computed."""
        self.block_manager.commit_prefill(state)

    def decode_append(self, state: SequenceState, token: int) -> None:
        """Record one generated token; it stays pending until the next
        decode pass writes its KV row."""
        self.block_manager.append_token(state, token)

    def decode_step(self, state: SequenceState) -> int:
        """Greedy-sample one token for this sequence."""
        pos = len(state.tokens) - 1
        last_token = torch.tensor([state.tokens[-1]], dtype=torch.int32, device=self.device)
        self.kv_cache, logits = llama.decode_step_cache(
            self._model_config, self.params, self.kv_cache, last_token,
            self._padded_table(state)[None],
            torch.tensor([pos], dtype=torch.int32, device=self.device),
            pipelined=True, lora=self.lora_for_decode([state.lora_id]), group=self.group,
        )
        # The pending token's KV row is now resident: commit any page it
        # completed before appending the next (pending) token.
        self.block_manager.mark_decode_computed(state)
        token = int(self.choose(torch.argmax(logits[0])))
        self.block_manager.append_token(state, token)
        return token

    def choose(self, tokens: torch.Tensor) -> torch.Tensor:
        """The tokens every rank of a tp pod commits: group rank 0's (the
        tensor as it is on a single-rank pod)."""
        return broadcast_from_first(tokens, self.group)

    def free(self, state: SequenceState) -> None:
        if self.tier_store is not None and self.config.eager_stage:
            # Snapshot while the pages are still committed: the gather is
            # queued on this (serving) thread, so it precedes any later
            # allocation's overwrite in device order. Best-effort: a failed
            # snapshot must never leak the sequence's pages; its blocks fall
            # back to the reclaim-time stage.
            try:
                self.tier_store.stage_async(list(self.block_manager.committed_blocks(state)))
            except Exception as e:  # noqa: BLE001 - staging is best-effort
                logger.debug("eager stage snapshot failed on free: %s", e)
        self.block_manager.free(state)

    # -- data plane -----------------------------------------------------------

    @property
    def transfer_address(self) -> Optional[Tuple[str, int]]:
        """(host, port) peers use to fetch this pod's staged blocks."""
        if self.connector is None:
            return None
        return ("127.0.0.1", self.connector.port)

    def set_peer_resolver(self, resolver) -> None:
        """Install the hash -> peer-address resolver (once the fleet's pods
        and shared index exist: tiering.IndexBackedPeerResolver)."""
        if self.tier_store is None:
            raise RuntimeError("enable_host_tier=False: no data plane to configure")
        self.tier_store.peer_resolver = resolver

    def export_sequence(self, state: SequenceState) -> int:
        """Stage every committed page of a live sequence in the transfer
        server (the pages stay on the device) so peers can onboard them: the
        prefill/decode-disaggregation push. Returns the number staged."""
        if self.tier_store is None:
            raise RuntimeError("enable_host_tier=False: no data plane to export to")
        blocks = list(self.block_manager.committed_blocks(state))
        self.tier_store.export_blocks(blocks)
        return len(blocks)

    def prefetch(self, tokens: List[int], lora_id: Optional[int] = None) -> int:
        """Start background payload fetches for a queued prompt's restorable
        blocks (the fetch rides the queue wait instead of the time to first
        token). No-op without a host tier. Returns the fetches queued."""
        if self.tier_store is None:
            return 0
        keys = self.block_manager.token_db.tokens_to_kv_block_keys(
            None, [int(t) for t in tokens], "", lora_id=lora_id
        )
        return self.prefetch_hashes([k.chunk_hash for k in keys])

    def prefetch_hashes(self, chunk_hashes: List[int]) -> int:
        """Prefetch by chain hashes the caller already derived: the blocks
        not resident on the device go to the background fetch queue.
        Returns the fetches queued."""
        if self.tier_store is None:
            return 0
        missing = [h for h in chunk_hashes if not self.block_manager.is_cached(h)]
        return self.tier_store.prefetch(missing)

    def resident_prefix_blocks(self, chunk_hashes: List[int]) -> int:
        """Length of the leading run of `chunk_hashes` resident on the
        device right now."""
        n = 0
        for h in chunk_hashes:
            if not self.block_manager.is_cached(h):
                break
            n += 1
        return n

    def resident_block_digest(
        self,
        device_hashes: List[int] = (),
        host_hashes: List[int] = (),
        max_extra: int = 0,
    ) -> dict:
        """Which of the challenged hashes are resident right now, per tier
        (`device` against the block manager's committed cache, `host`
        against the staged store), plus bounded `extra_*` samples of
        resident hashes. Membership checks only: no bytes move."""
        out = {
            "device": {h for h in device_hashes if self.block_manager.is_cached(h)},
            "host": set(),
            "extra_device": [],
            "extra_host": [],
        }
        if self.tier_store is not None:
            out["host"] = self.tier_store.staged_subset(host_hashes)
            if max_extra > 0:
                out["extra_host"] = self.tier_store.staged_sample(max_extra)
        if max_extra > 0:
            out["extra_device"] = self.block_manager.cached_hashes(max_extra)
        return out

    def warm_chain(self, tokens: List[int], lora_id: Optional[int] = None) -> int:
        """Land the longest restorable prefix of this token chain through
        the host tier (ready buffer -> host store -> peers), commit it as
        cached blocks (the chained BlockStored tells the index) and release
        the pages to the evictable prefix cache. Never computes; resident
        blocks cost nothing. Returns the number of blocks newly landed."""
        if self.tier_store is None:
            return 0
        tokens = [int(t) for t in tokens]
        ps = self.config.page_size
        keys = self.block_manager.token_db.tokens_to_kv_block_keys(
            None, tokens, "", lora_id=lora_id
        )
        if not keys:
            return 0
        n_resident = self.resident_prefix_blocks([k.chunk_hash for k in keys])
        rest = [k.chunk_hash for k in keys[n_resident:]]
        if not rest:
            return 0
        restorable = self.tier_store.plan_restore(rest)
        if restorable <= 0:
            return 0
        try:
            state = self.block_manager.allocate(
                tokens[: (n_resident + restorable) * ps], lora_id=lora_id
            )
        except OutOfPagesError:
            return 0  # pressure wins: warming never preempts serving
        landed = max(state.num_cached_tokens // ps - n_resident, 0)
        self.block_manager.free(state)
        return landed

    def close(self) -> None:
        """Close the event publisher and stop the host tier's threads, client
        and server (idempotent)."""
        if self._publisher is not None:
            self._publisher.close()
            self._publisher = None
        if self.tier_store is not None:
            self.tier_store.close()
        if self.connector is not None:
            self.connector.close()

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def batch_bucket(n: int) -> int:
        """Next power-of-2 shape bucket (>=1) for prefill chunk lengths."""
        bucket = 1
        while bucket < n:
            bucket *= 2
        return bucket

    def table_bucket(self, n_pages_needed: int) -> int:
        """Padded block-table width: next power of two covering the need,
        capped at max_pages_per_seq."""
        if n_pages_needed > self.config.max_pages_per_seq:
            raise ValueError(
                f"sequence needs {n_pages_needed} pages > "
                f"max_pages_per_seq={self.config.max_pages_per_seq}; truncating "
                "would silently corrupt K/V pages"
            )
        bucket = 1
        while bucket < max(n_pages_needed, 1):
            bucket *= 2
        return min(bucket, self.config.max_pages_per_seq)

    def _padded_table(self, state: SequenceState) -> torch.Tensor:
        bucket = self.table_bucket(len(state.block_table))
        table = np.zeros((bucket,), dtype=np.int32)
        table[: len(state.block_table)] = state.block_table
        return torch.from_numpy(table).to(self.device)
