"""Continuous-batching scheduler for EnginePod.

Port of the reference package's `engine/scheduler.py`. A waiting queue
admits sequences as pages free up through a **chunked prefill budget**:
each tick computes at most `prefill_token_budget` prompt tokens (a long
prompt spans ticks, several short prompts pack into one packed-prefill
pass), so the running batch's decode latency stays bounded whatever
arrives. All running sequences decode together in one batched
`decode_step_cache` (or `decode_multi_step_cache`) call per tick, with the
batch and the block tables padded to power-of-two buckets.

Capacity policy:
- `submit` rejects deterministically (empty result, `Request.error` set)
  any request whose prompt + max_new_tokens can never fit the pool or the
  per-sequence page cap.
- Decode-time page exhaustion preempts a sequence by recompute: its pages
  are freed (staying prefix-cached), the request rejoins the waiting queue
  with its generated tokens folded into the prompt, and the re-prefill
  mostly hits the cache.

Token selection: greedy argmax by default; per-request SamplingParams
sample on the device with per-position keys (ops/sampling.py), so output
is reproducible, the same as the reference's, and independent of
decode_steps and batch composition. Sequences finish on max_new_tokens or
EOS. Tensors live on `pod.device`; the host reads the tokens back once per
prefill wave and once per decode tick.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from llm_d_kv_cache_manager_tpu_torch.engine.block_manager import (
    OutOfPagesError,
    SequenceState,
)
from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.ops.sampling import (
    SamplingParams,
    position_keys,
    prng_key,
    sample_tokens,
)


@dataclass
class Request:
    req_id: int
    prompt_tokens: List[int]
    max_new_tokens: int
    eos_token: Optional[int] = None
    lora_id: Optional[int] = None
    # None or greedy params => argmax. Sampled requests draw from
    # fold_in(PRNGKey(seed or req_id), position) per emitted position.
    sampling: Optional[SamplingParams] = None
    # Filled by the scheduler:
    state: Optional[SequenceState] = None
    generated: List[int] = field(default_factory=list)
    num_cached_tokens: int = 0
    # Chunked-prefill progress: next prompt position to compute, or None
    # when not mid-prefill.
    prefill_pos: Optional[int] = None
    finished: bool = False
    error: Optional[str] = None


class Scheduler:
    def __init__(
        self,
        pod: EnginePod,
        max_batch: int = 8,
        prefill_token_budget: int = 512,
        decode_steps: int = 1,
    ):
        if prefill_token_budget < 1:
            raise ValueError("prefill_token_budget must be >= 1")
        if decode_steps < 1:
            raise ValueError("decode_steps must be >= 1")
        self.pod = pod
        self.max_batch = max_batch
        # decode_steps > 1: each decode tick runs one multi-step call
        # (llama.decode_multi_step_cache) emitting up to decode_steps tokens
        # per sequence, with the same output as decode_steps=1; admission
        # of waiting requests waits up to decode_steps-1 tokens longer.
        self.decode_steps = decode_steps
        self.prefill_token_budget = prefill_token_budget
        self._waiting: deque = deque()
        self._running: List[Request] = []
        self._rejected: List[Request] = []
        self._next_id = 0
        self._sampling_cache: OrderedDict = OrderedDict()
        self.preemptions = 0  # recompute preemptions so far

    # -- API -----------------------------------------------------------------

    def submit(
        self,
        prompt_tokens: List[int],
        max_new_tokens: int = 16,
        eos_token: Optional[int] = None,
        lora_id: Optional[int] = None,
        sampling: Optional[SamplingParams] = None,
    ) -> int:
        req = Request(self._next_id, list(prompt_tokens), max_new_tokens,
                      eos_token, lora_id, sampling=sampling)
        self._next_id += 1

        error = self._validate(req)
        if error is not None:
            req.finished = True
            req.error = error
            self._rejected.append(req)
        else:
            self._waiting.append(req)
            # Start background fetches of restorable blocks while the
            # request waits (a no-op without a host tier).
            self.pod.prefetch(req.prompt_tokens, req.lora_id)
        return req.req_id

    @property
    def has_work(self) -> bool:
        return bool(self._waiting or self._running or self._rejected)

    def step(self) -> List[Request]:
        """One scheduler tick: surface rejections, spend the prefill token
        budget (chunked, possibly across several waiting sequences), then
        one batched decode across running sequences. Returns newly finished
        requests (pages freed; cache stays warm)."""
        finished, self._rejected = self._rejected, []
        finished += self._prefill_tick()
        finished += self._decode()
        return finished

    def run(self) -> Dict[int, List[int]]:
        """Drain everything; returns {req_id: generated_tokens} (an empty
        list for a rejected request; its reason is on the Request objects
        that step() returns)."""
        results: Dict[int, List[int]] = {}
        while self.has_work:
            for req in self.step():
                results[req.req_id] = req.generated
        return results

    # -- internals -------------------------------------------------------------

    def _validate(self, req: Request) -> Optional[str]:
        if req.max_new_tokens < 1:
            return f"max_new_tokens must be >= 1, got {req.max_new_tokens}"
        try:
            self.pod.lora_index(req.lora_id)
        except KeyError as e:
            return f"unknown LoRA adapter: {e}"
        page_size = self.pod.config.page_size
        total_tokens = len(req.prompt_tokens) + req.max_new_tokens
        pages_needed = (total_tokens + page_size - 1) // page_size
        if pages_needed > self.pod.config.max_pages_per_seq:
            return (
                f"request needs {pages_needed} pages > max_pages_per_seq="
                f"{self.pod.config.max_pages_per_seq}"
            )
        if pages_needed > self.pod.config.n_pages:
            return (
                f"request needs {pages_needed} pages > pool size "
                f"{self.pod.config.n_pages}"
            )
        return None

    def _preempt(self, req: Request) -> None:
        """Recompute preemption: release pages (prefix stays cached), fold
        generated tokens into the prompt, rejoin the queue at the front, but
        never ahead of a mid-prefill request: that request holds its pages
        and progresses only at the queue head, so queueing in front of it
        would deadlock the loop."""
        self.preemptions += 1
        self.pod.free(req.state)
        req.prompt_tokens = list(req.state.tokens)
        req.state = None
        req.prefill_pos = None
        if self._waiting and self._waiting[0].state is not None:
            self._waiting.insert(1, req)
        else:
            self._waiting.appendleft(req)

    def _prefill_tick(self) -> List[Request]:
        """Spend up to prefill_token_budget prompt tokens of compute: plan
        every chunk of the tick (allocation and budget walk, no device
        work), run them all in one packed pass
        (EnginePod.prefill_chunk_batch), then resolve each completed prompt
        (commit, first token from its logits row, admission)."""
        finished: List[Request] = []
        budget = self.prefill_token_budget

        jobs: List = []
        completed: List[Request] = []
        # First-page signatures of prompts with uncommitted compute in this
        # wave: a later arrival sharing a full-page prefix with one of them
        # waits for the next wave, when those pages are committed and hit
        # (any shared full-page prefix implies equal first pages).
        ps = self.pod.config.page_size
        wave_first_pages = set()
        while (
            budget > 0 and self._waiting
            and len(self._running) + len(completed) < self.max_batch
        ):
            req = self._waiting[0]
            if req.state is None:
                if tuple(req.prompt_tokens[:ps]) in wave_first_pages:
                    break  # flush the wave; reuse its commits next tick
                try:
                    state, start = self.pod.begin_prefill(
                        req.prompt_tokens, lora_id=req.lora_id
                    )
                except OutOfPagesError:
                    break  # retry next tick once decodes free pages
                req.state = state
                req.num_cached_tokens = state.num_cached_tokens
                req.prefill_pos = start

            end = min(req.prefill_pos + budget, len(req.prompt_tokens))
            if end > req.prefill_pos:
                jobs.append((req, req.prefill_pos, end))
                wave_first_pages.add(tuple(req.prompt_tokens[:ps]))
                budget -= end - req.prefill_pos
                req.prefill_pos = end
            if req.prefill_pos < len(req.prompt_tokens):
                break  # budget exhausted mid-prompt; resume next tick
            completed.append(req)
            self._waiting.popleft()

        if not jobs:
            return finished

        logits_rows = self.pod.prefill_chunk_batch(
            [(req.state, start, end) for req, start, end in jobs]
        )
        logits_by_req = {id(req): row for (req, _, _), row in zip(jobs, logits_rows)}

        # First tokens of the completed prompts: one argmax or sampling call
        # and one read back for the whole wave. For a re-admitted preempted
        # request this continues its generation.
        first_tokens = {}
        if completed:
            stacked = torch.stack([logits_by_req[id(r)] for r in completed])
            sarr = self._sampling_arrays(completed, len(completed))
            if sarr is None:
                toks = torch.argmax(stacked, dim=-1)
            else:
                pos = torch.tensor([len(r.state.tokens) - 1 for r in completed],
                                   dtype=torch.int32, device=self.pod.device)
                toks = sample_tokens(stacked, sarr[0], sarr[1], sarr[2],
                                     position_keys(sarr[3], pos))
            toks = self.pod.choose(toks)  # a tp pod's ranks commit rank 0's
            first_tokens = {id(r): int(t) for r, t in zip(completed, toks.tolist())}
        for req in completed:
            self.pod.finish_prefill(req.state)
            req.prefill_pos = None
            token = first_tokens[id(req)]
            req.generated.append(token)
            # A finished sequence never attends again: skip the (possibly
            # page-allocating) KV write of its final token.
            if self._done(req, token):
                req.finished = True
                self.pod.free(req.state)
                finished.append(req)
                continue
            try:
                self.pod.decode_append(req.state, token)
            except OutOfPagesError:
                self._preempt(req)  # the token folds into the recompute prompt
                continue
            self._running.append(req)
        return finished

    @staticmethod
    def _done(req: Request, token: int) -> bool:
        return len(req.generated) >= req.max_new_tokens or (
            req.eos_token is not None and token == req.eos_token
        )

    def _assemble_batch(self, running: List[Request]):
        """Bucket-padded decode batch: (tables [Bp, bucket], pending tokens
        [Bp], positions [Bp]) as numpy arrays, shared by the single-step
        and multi-step paths.

        Both the table width and the batch size are padded to power-of-two
        buckets, so a shrinking batch reuses a few shapes. Pad rows carry
        position 0 and an all-trash-page table, so their discarded step
        writes only the trash page; callers index outputs by the real
        running list."""
        need = max(len(r.state.block_table) for r in running)
        bucket = self.pod.table_bucket(need)
        b_pad = self.pod.batch_bucket(len(running))
        tables = np.full((b_pad, bucket), self.pod.trash_page, dtype=np.int32)
        tokens = np.zeros((b_pad,), dtype=np.int32)
        positions = np.zeros((b_pad,), dtype=np.int32)
        for i, req in enumerate(running):
            bt = req.state.block_table
            tables[i, : len(bt)] = bt
            tokens[i] = req.state.tokens[-1]
            positions[i] = len(req.state.tokens) - 1
        return tables, tokens, positions

    def _lora_for(self, running: List[Request], n_rows: int):
        """The decode batch's adapters for the llama call: pad rows run the
        base model (index 0), and their output is discarded."""
        lora_ids = [r.lora_id for r in running] + [None] * (n_rows - len(running))
        return self.pod.lora_for_decode(lora_ids)

    def _sampling_arrays(self, reqs: List[Request], padded_len: int):
        """None when every request is greedy; otherwise (temps, top_ks,
        top_ps, base_keys) on the pod's device, padded to `padded_len` with
        greedy rows. Base keys come from the request seed (default: req_id),
        so a request's draws do not depend on what it was batched with.

        Cached per (request set, padded_len), a few entries deep: prefill
        waves and decode ticks alternate with different signatures, so a
        single slot would rebuild and re-upload the arrays every tick."""
        if all(r.sampling is None or r.sampling.is_greedy for r in reqs):
            return None
        sig = (tuple((r.req_id, r.sampling) for r in reqs), padded_len)
        cache = self._sampling_cache
        cached = cache.get(sig)
        if cached is not None:
            cache.move_to_end(sig)
            return cached
        temps = np.zeros((padded_len,), np.float32)
        top_ks = np.zeros((padded_len,), np.int32)
        top_ps = np.ones((padded_len,), np.float32)
        keys = [prng_key(0, "cpu")] * padded_len
        for i, r in enumerate(reqs):
            sp = r.sampling
            if sp is not None and not sp.is_greedy:
                temps[i] = sp.temperature
                top_ks[i] = sp.top_k
                top_ps[i] = sp.top_p
                keys[i] = prng_key(sp.seed if sp.seed is not None else r.req_id, "cpu")
        dev = self.pod.device
        arrays = (
            torch.from_numpy(temps).to(dev), torch.from_numpy(top_ks).to(dev),
            torch.from_numpy(top_ps).to(dev), torch.stack(keys).to(dev),
        )
        cache[sig] = arrays
        while len(cache) > 8:  # a handful of live shapes; bound the rest
            cache.popitem(last=False)
        return arrays

    def _decode(self) -> List[Request]:
        if not self._running:
            return []
        if self.decode_steps > 1:
            return self._decode_multi()
        pod = self.pod
        dev = pod.device
        tables, tokens, positions = self._assemble_batch(self._running)
        positions_t = torch.from_numpy(positions).to(dev)
        pod.kv_cache, logits = llama.decode_step_cache(
            pod._model_config, pod.params, pod.kv_cache,
            torch.from_numpy(tokens).to(dev), torch.from_numpy(tables).to(dev),
            positions_t, pipelined=True, lora=self._lora_for(self._running, len(tokens)),
            group=pod.group,
        )
        sarr = self._sampling_arrays(self._running, len(tokens))
        if sarr is None:
            next_tokens = torch.argmax(logits, dim=-1)
        else:
            next_tokens = sample_tokens(logits, sarr[0], sarr[1], sarr[2],
                                        position_keys(sarr[3], positions_t))
        next_tokens = pod.choose(next_tokens).tolist()

        # Every running sequence's pending token just had its KV row
        # written: commit the pages that row completed (the only point a
        # decode-filled page becomes advertisable).
        for req in self._running:
            pod.block_manager.mark_decode_computed(req.state)

        finished: List[Request] = []
        still_running: List[Request] = []
        for req, token in zip(self._running, next_tokens):
            req.generated.append(token)
            if self._done(req, token):
                req.finished = True
                pod.free(req.state)
                finished.append(req)
                continue
            try:
                pod.decode_append(req.state, token)
            except OutOfPagesError:
                self._preempt(req)  # tokens incl. this one fold into the prompt
                continue
            still_running.append(req)
        self._running = still_running
        return finished

    def _decode_multi(self) -> List[Request]:
        """One decode tick emitting up to `decode_steps` tokens per sequence
        from one llama.decode_multi_step_cache call.

        Sequence i accepts k_i = min(N, remaining budget, page capacity)
        tokens; the device runs all N steps for the rectangular batch,
        steering row writes past position seq_len + k_i into the pod's
        trash page. The host then appends the accepted tokens as N plain
        ticks would, the last one pending."""
        pod = self.pod
        dev = pod.device
        n = self.decode_steps
        ps = pod.config.page_size
        running = self._running

        # Write headroom per sequence: accepting k tokens writes rows at
        # positions len-1 .. len+k-2. On pool exhaustion degrade to k=1 (the
        # pending token's page is already held).
        accepts: List[int] = []
        for req in running:
            length = len(req.state.tokens)
            capacity = pod.config.max_pages_per_seq * ps - length + 1
            k = max(1, min(n, req.max_new_tokens - len(req.generated), capacity))
            try:
                pod.block_manager.reserve_pages(req.state, (length + k - 1 + ps - 1) // ps)
            except OutOfPagesError:
                k = 1
            accepts.append(k)

        tables, tokens, positions = self._assemble_batch(running)
        # Pad rows: 0 rows allowed (every write lands in the trash page).
        padded_accepts = accepts + [0] * (len(tokens) - len(accepts))
        max_lens = positions + np.asarray(padded_accepts, dtype=np.int32)

        pod.kv_cache, toks = llama.decode_multi_step_cache(
            pod._model_config, pod.params, pod.kv_cache,
            torch.from_numpy(tokens).to(dev), torch.from_numpy(tables).to(dev),
            torch.from_numpy(positions).to(dev), torch.from_numpy(max_lens).to(dev),
            pod.trash_page, n,
            sampling=self._sampling_arrays(running, len(tokens)),
            lora=self._lora_for(running, len(tokens)), group=pod.group,
        )
        toks = toks.tolist()  # [B][n], group rank 0's on a tp pod

        finished: List[Request] = []
        still_running: List[Request] = []
        for i, req in enumerate(running):
            # The pending token's row was written by step 0: pages it
            # completed become advertisable.
            pod.block_manager.mark_decode_computed(req.state)
            done = False
            preempted = False
            k = accepts[i]
            for j in range(k):
                token = toks[i][j]
                req.generated.append(token)
                if self._done(req, token):
                    done = True
                    break
                try:
                    pod.decode_append(req.state, token)
                except OutOfPagesError:
                    self._preempt(req)
                    preempted = True
                    break
                # Every accepted token but the last has resident KV (a
                # later step consumed it); the last is the new pending.
                if j < k - 1:
                    pod.block_manager.mark_decode_computed(req.state)
            if done:
                req.finished = True
                # Every token still in the sequence has resident KV (the
                # done token is never appended): commit the tail page.
                pod.block_manager.mark_decode_computed(req.state)
                pod.free(req.state)
                finished.append(req)
                continue
            if preempted:
                continue
            still_running.append(req)
        self._running = still_running
        return finished
