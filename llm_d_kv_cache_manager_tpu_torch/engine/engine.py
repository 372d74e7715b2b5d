"""EnginePod: a minimal vLLM-style serving pod on torch.

Port of the reference package's `engine/engine.py` in model mode: the device
path (models/llama.py + ops/) and the host path (engine/block_manager.py)
together, publishing the same KVEvents a real engine would to an in-process
event sink, so the control plane can index the pod's cache.

The pod serves on `config.device` ("cuda" by default; construction raises
when no GPU is present unless "cpu" is asked for), with KV pages in the
model dtype or, with `use_quantized_kv`, in int8. On CUDA every attention
call runs a hand-written kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from llm_d_kv_cache_manager_tpu_torch.engine.block_manager import (
    BlockManager,
    BlockManagerConfig,
    OutOfPagesError,
    SequenceState,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.events import EventBatch
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.utils.device import resolve_device


@dataclass
class EnginePodConfig:
    pod_id: str = "pod-0"
    model_name: str = "test-model"
    n_pages: int = 512
    page_size: int = 16
    hash_seed: str = ""
    device_tier: Optional[str] = None  # events' Medium; port pods use "gpu"
    max_pages_per_seq: int = 32
    model_config: Optional[llama.LlamaConfig] = None
    device: str = "cuda"
    # int8 KV pages: half the device memory per cached token, so twice the
    # prefixes a pod keeps resident (ops/quantized_kv.py).
    use_quantized_kv: bool = False


class EnginePod:
    def __init__(
        self,
        config: EnginePodConfig,
        event_sink: Optional[Callable[[EventBatch], None]] = None,
        params=None,
    ):
        self.config = config
        self.device = resolve_device(config.device)
        self._sink = event_sink
        self.block_manager = BlockManager(
            BlockManagerConfig(
                n_pages=config.n_pages,
                page_size=config.page_size,
                hash_seed=config.hash_seed,
                device_tier=config.device_tier,
            ),
            event_sink=self._emit,
        )
        mc = config.model_config or llama.LlamaConfig()
        self._model_config = mc
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = llama.init_params(mc, gen, self.device)
        self.params = params
        # One sacrificial page beyond the block manager's pool: packed
        # prefill and multi-step decode steer pad rows and over-budget rows
        # there (llama.verify_step_cache, llama.decode_multi_step_cache), so
        # a rectangular batch never corrupts a real page. No block table
        # refers to it and the block manager never hands it out.
        self.trash_page = config.n_pages
        make = llama.make_kv_pages_quantized if config.use_quantized_kv else llama.make_kv_pages
        self.kv_cache = make(mc, config.n_pages + 1, config.page_size, self.device)
        self.last_logits: Optional[torch.Tensor] = None

    # -- events --------------------------------------------------------------

    def _emit(self, batch: EventBatch) -> None:
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
        """Registry index for an adapter id (0 = base). This pod serves no
        adapters, so any other id raises KeyError and admission rejects the
        request."""
        if lora_id is None:
            return 0
        raise KeyError(f"no LoRA adapters configured (requested {lora_id})")

    def lora_for_decode(self, lora_ids) -> None:
        """The adapter stack and per-row indices of a decode batch: None,
        since this pod serves no adapters."""
        return None

    def prefetch(self, tokens: List[int], lora_id: Optional[int] = None) -> int:
        """Start background payload fetches for a queued prompt's restorable
        blocks. This pod has no host tier, so nothing is queued: returns 0."""
        return 0

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
            self.trash_page,
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
            pipelined=True,
        )
        # The pending token's KV row is now resident: commit any page it
        # completed before appending the next (pending) token.
        self.block_manager.mark_decode_computed(state)
        token = int(torch.argmax(logits[0]))
        self.block_manager.append_token(state, token)
        return token

    def free(self, state: SequenceState) -> None:
        self.block_manager.free(state)

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
