"""Speculative decoding: a draft model proposes, the target verifies in one
pass. Greedy by default; with non-greedy SamplingParams, speculative
sampling (accept with min(1, q/p), resample a rejection from the residual),
whose emitted-token law is exactly the target's filtered distribution.

Port of the reference package's `engine/speculative.py`, on the port's pod,
scheduler and sampler. Decode reads the whole weight stack for one token,
while one verification pass scores k+1 positions for about the same
weight traffic: a small draft proposes k tokens autoregressively, the
target scores `[t0] + proposals` at once (`prefill_cache(all_logits=True)`,
or `verify_step_cache` for a batch) and keeps the longest prefix whose
greedy argmax chain matches. Every emitted token is the argmax of TARGET
logits, so greedy output equals target-only greedy decoding (pinned on f32
models). In bf16 the draft's decode kernel and the target's flash kernel
round differently, so a near-exact logit tie may resolve differently than
plain decode would, the same caveat batched-vs-isolated decode carries.

Integration with the serving stack:
- the target sequence lives in the pod's BlockManager: the proposals' KV
  lands in pages reserved ahead (`reserve_pages`), and only ACCEPTED tokens
  are appended, so BlockStored events never advertise unverified content.
  Rejected positions leave stale rows beyond seq_len, masked by attention
  and overwritten by the next round.
- the draft keeps a private paged cache (its own page pool, identity block
  table) and catches up on the accepted tokens it did not propose.

Tokens stay on the device through a round: the draft's proposals feed its
next step and the verify chunk without a host copy, and the host reads one
tensor back a round (`SpeculativeDecoder`) or a tick
(`SpeculativeScheduler`); `read_backs` counts them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from llm_d_kv_cache_manager_tpu_torch.engine.block_manager import OutOfPagesError
from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod
from llm_d_kv_cache_manager_tpu_torch.engine.scheduler import Scheduler
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.ops.sampling import (
    accept_or_resample,
    filter_logits,
    gumbel_noise,
    position_keys,
    prng_key,
    sample_tokens,
    split_key,
)

read_backs = 0  # device-to-host reads of a round's (or tick's) results


def _read_back(parts: List[torch.Tensor]) -> List[int]:
    """One device-to-host read of several int tensors, flattened in order."""
    global read_backs
    read_backs += 1
    return torch.cat([p.reshape(-1).long() for p in parts]).tolist()


@dataclass
class SpeculativeStats:
    proposed: int = 0
    accepted: int = 0
    rounds: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


class _DraftState:
    """The draft model's private paged cache for one sequence."""

    def __init__(self, config, params, max_tokens: int, page_size: int, device):
        self.config = config
        self.params = params
        self.page_size = page_size
        n_pages = (max_tokens + page_size - 1) // page_size + 1
        self.cache = llama.make_kv_pages(config, n_pages, page_size, device)
        self.table = torch.arange(n_pages, dtype=torch.int32, device=device)
        self.n_tokens = 0  # positions with valid KV

    def ingest(self, tokens: torch.Tensor) -> torch.Tensor:
        """Write KV for `tokens` ([n] int32 on the device) at the current
        position; returns the last position's logits (the draft's next
        proposal seed). A single token rides the paged decode path; a
        multi-token catch-up chunk rides prefill."""
        n = tokens.shape[0]
        if n == 1:
            self.cache, logits = llama.decode_step_cache(
                self.config, self.params, self.cache, tokens, self.table[None],
                torch.tensor([self.n_tokens], dtype=torch.int32, device=tokens.device),
            )
            self.n_tokens += 1
            return logits[0]
        self.cache, logits = llama.prefill_cache(
            self.config, self.params, self.cache, tokens, self.table, self.n_tokens,
        )
        self.n_tokens += n
        return logits


class SpeculativeDecoder:
    """Single-sequence generation with draft-model speculation."""

    def __init__(self, pod: EnginePod, draft_config, draft_params, k: int = 4):
        if pod.lora_stack is not None:
            raise NotImplementedError("speculative decoding with LoRA adapters")
        if pod.group is not None:
            raise NotImplementedError("speculative decoding on a tp pod")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.pod = pod
        self.draft_config = draft_config
        self.draft_params = draft_params
        self.k = k
        self.stats = SpeculativeStats()
        self._gen_counter = 0  # unseeded sampled calls get distinct streams

    def generate(
        self,
        prompt_tokens: List[int],
        max_new_tokens: int,
        eos_token: Optional[int] = None,
        sampling=None,  # ops.sampling.SamplingParams; None/greedy => argmax
    ) -> List[int]:
        """Greedy by default. With non-greedy `sampling`, speculative
        sampling (Leviathan et al.): the draft samples proposals from its own
        filtered distribution p, the target accepts each with min(1, q/p)
        and resamples the first rejection from the residual max(0, q - p),
        so the emitted law is the target's filtered distribution q. Both
        pass through the `filter_logits` the plain scheduler samples with.
        Target emissions, draft proposals and accept draws ride three key
        streams split from PRNGKey(seed), each folded per absolute position,
        so a seed reproduces its output."""
        pod = self.pod
        dev = pod.device
        page_size = pod.config.page_size
        vocab = self.draft_config.vocab_size
        max_total = len(prompt_tokens) + max_new_tokens + self.k + 1

        sampled_mode = sampling is not None and not sampling.is_greedy
        if sampled_mode:
            # Unseeded calls draw a fresh per-call stream (else best-of-n
            # would collapse to n identical sequences); seeded calls
            # reproduce exactly.
            self._gen_counter += 1
            seed = sampling.seed if sampling.seed is not None else self._gen_counter
            k_target, k_draft, k_accept = split_key(prng_key(seed, dev), 3)
            sp = (torch.tensor([sampling.temperature], dtype=torch.float32, device=dev),
                  torch.tensor([sampling.top_k], dtype=torch.int32, device=dev),
                  torch.tensor([sampling.top_p], dtype=torch.float32, device=dev))

            def rep(n):  # the filter parameters for n rows
                return tuple(t.expand(n) for t in sp)

            def keys(stream, positions: torch.Tensor):  # fold_in per position
                return position_keys(stream.expand(positions.shape[0], 2), positions)

        def positions(first: int, n: int) -> torch.Tensor:
            return torch.arange(first, first + n, dtype=torch.int32, device=dev)

        state, _ = pod.prefill(list(prompt_tokens))
        draft = _DraftState(self.draft_config, self.draft_params, max_total, page_size, dev)
        draft.ingest(torch.tensor(prompt_tokens, dtype=torch.int32, device=dev))

        # The first frontier token, from the target's prefill logits; later
        # ones come back with each round's read.
        if sampled_mode:
            t0 = sample_tokens(pod.last_logits[None], *rep(1),
                               keys(k_target, positions(len(state.tokens), 1)))
        else:
            t0 = torch.argmax(pod.last_logits).to(torch.int32).reshape(1)
        generated: List[int] = []
        try:
            while len(generated) < max_new_tokens:
                pos_t0 = len(state.tokens)  # device position t0 will occupy
                # Cap proposals at what could be accepted: the remaining
                # budget after t0, and the sequence's page capacity.
                capacity_tokens = pod.config.max_pages_per_seq * page_size - pos_t0 - 1
                k_eff = max(0, min(self.k, max_new_tokens - len(generated) - 1,
                                   capacity_tokens))

                # The draft proposes k_eff tokens after t0 (greedy argmax, or
                # sampled from its filtered distribution, kept to form q/p).
                # In the final stretch (k_eff == 0) it is skipped.
                proposals: List[torch.Tensor] = []
                draft_dists = []
                if k_eff > 0:
                    seed_logits = draft.ingest(t0)
                    for j in range(k_eff):
                        if sampled_mode:
                            f = filter_logits(seed_logits[None], *sp)
                            draft_dists.append(torch.softmax(f, dim=-1)[0])
                            g = gumbel_noise(keys(k_draft, positions(pos_t0 + 1 + j, 1)), vocab)
                            p = torch.argmax(f + g, dim=-1).to(torch.int32)
                        else:
                            p = torch.argmax(seed_logits).to(torch.int32).reshape(1)
                        proposals.append(p)
                        seed_logits = draft.ingest(p)
                self.stats.proposed += len(proposals)
                self.stats.rounds += 1

                # The target verifies every proposal in one pass. The chunk
                # starts with t0 (its KV is not yet in the cache); logits[i]
                # is the target's opinion after chunk[i], so logits[i] vs
                # proposals[i] is the acceptance test and column n_accept
                # seeds the next round.
                chunk = torch.cat([t0] + proposals)
                n = chunk.shape[0]
                pod.block_manager.reserve_pages(state, (pos_t0 + n + page_size - 1) // page_size)
                pod.kv_cache, verify_logits = llama.prefill_cache(
                    pod._model_config, pod.params, pod.kv_cache, chunk,
                    pod._padded_table(state), pos_t0, all_logits=True,
                )

                if sampled_mode:
                    # Emission draws for every column (the next t0 after
                    # n_accept acceptances sits at pos_t0 + 1 + n_accept),
                    # and the accept/resample draws of every proposal: one
                    # batch each, one read back.
                    emit = sample_tokens(verify_logits, *rep(n),
                                         keys(k_target, positions(pos_t0 + 1, n)))
                    parts = [chunk, emit]
                    if proposals:
                        qs = torch.softmax(filter_logits(verify_logits[:k_eff], *rep(k_eff)), -1)
                        toks_a, oks = accept_or_resample(
                            qs, torch.stack(draft_dists), chunk[1:],
                            keys(k_accept, positions(pos_t0 + 1, k_eff)))
                        parts += [toks_a, oks]
                    host = _read_back(parts)
                    tokens, emit_h = host[:n], host[n:2 * n]
                    toks_h, oks_h = host[2 * n:2 * n + k_eff], host[2 * n + k_eff:]
                    n_accept, resampled = 0, None
                    for i in range(k_eff):
                        if oks_h[i]:
                            n_accept += 1
                        else:
                            resampled = toks_h[i]
                            break
                    # A residual draw replaces the rejected proposal, but its
                    # KV is not resident (the verify pass wrote the
                    # proposal's row): it is the next round's t0, whose
                    # verify chunk recomputes the position (the pending-token
                    # convention plain decode uses).
                    next_t0 = resampled if resampled is not None else emit_h[n_accept]
                else:
                    host = _read_back([chunk, torch.argmax(verify_logits, dim=-1)])
                    tokens, argmaxes = host[:n], host[n:]
                    n_accept = 0
                    for i in range(k_eff):
                        if argmaxes[i] != tokens[1 + i]:
                            break
                        n_accept += 1
                    next_t0 = argmaxes[n_accept]
                self.stats.accepted += n_accept

                done = False
                for tok in tokens[: 1 + n_accept]:
                    if self._push(state, generated, tok, eos_token, max_new_tokens):
                        done = True
                        break
                if done:
                    break
                # The draft holds KV for t0 and every proposal; on partial
                # acceptance its tail is stale but masked. Rewind its valid
                # count to the accepted frontier so the next ingest
                # overwrites the stale rows (k_eff == 0 rounds never touched
                # it, and k_eff only shrinks).
                if k_eff > 0:
                    draft.n_tokens = len(state.tokens)
                t0 = torch.tensor([next_t0], dtype=torch.int32, device=dev)
        finally:
            pod.free(state)
        return generated

    def _push(self, state, generated: List[int], token: int,
              eos_token: Optional[int], max_new_tokens: int) -> bool:
        """Append one ACCEPTED token to the real sequence (block-manager
        accounting and events). Returns True when generation is finished."""
        generated.append(token)
        if eos_token is not None and token == eos_token:
            return True
        if len(generated) >= max_new_tokens:
            return True
        self.pod.block_manager.append_token(state, token)
        # Unlike plain decode, the pushed token's KV is already resident
        # (the verify pass wrote the whole chunk): commit any page it filled.
        self.pod.block_manager.mark_decode_computed(state)
        return False


class SpeculativeScheduler:
    """Continuous batching with speculation: the whole running batch drafts
    and verifies together.

    Per tick: k batched draft decode steps propose k tokens per running
    sequence, then ONE `verify_step_cache` pass scores every (sequence,
    position), so the target's weights are read once for B·(k+1) positions.
    Admission (chunked prefill), preemption, paging and events ride the
    inner Scheduler unchanged, and the tick keeps the plain scheduler's
    invariant: each running sequence carries exactly one appended-but-not-
    yet-KV-computed "pending" token. The verify chunk is [pending] +
    proposals, acceptance emits the matching proposals, and the correction
    token becomes the next pending, so greedy output equals the plain
    scheduler's (pinned on f32).

    The draft keeps one private page stripe per batch slot; slots are taken
    at admission and recycled on finish or preemption (a preempted request's
    draft state is rebuilt on re-admission).
    """

    def __init__(
        self,
        pod: EnginePod,
        draft_config,
        draft_params,
        k: int = 4,
        max_batch: int = 8,
        prefill_token_budget: int = 512,
    ):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if pod.group is not None:
            raise NotImplementedError("speculative decoding on a tp pod")
        self.inner = Scheduler(pod, max_batch=max_batch,
                               prefill_token_budget=prefill_token_budget)
        self.pod = pod
        self.k = k
        self.draft_config = draft_config
        self.draft_params = draft_params
        self.stats = SpeculativeStats()

        page_size = pod.config.page_size
        self._stripe_pages = pod.config.max_pages_per_seq
        # +1: a shared draft trash page. Each slot's table carries it as a
        # final extra column, so a draft write past the stripe's capacity
        # (a rectangular k-window overrunning one sequence's headroom) lands
        # in the trash page instead of a real row.
        n_draft_pages = max_batch * self._stripe_pages + 1
        self._draft_trash = n_draft_pages - 1
        self._draft_cache = llama.make_kv_pages(draft_config, n_draft_pages, page_size,
                                                pod.device)
        self._free_slots = list(range(max_batch))
        # Host-side per-slot stripe rows (constant), trash column last.
        self._slot_tables = np.stack([
            np.concatenate([
                np.arange(i * self._stripe_pages, (i + 1) * self._stripe_pages, dtype=np.int32),
                np.asarray([self._draft_trash], dtype=np.int32),
            ])
            for i in range(max_batch)
        ])
        # req_id -> [slot, draft_pos]; draft_pos counts positions with valid
        # draft KV (always len(state.tokens) - 1: all but the pending token).
        self._draft_state: dict = {}

    # -- public API mirroring Scheduler ------------------------------------

    def submit(self, prompt_tokens, max_new_tokens=16, eos_token=None, lora_id=None,
               sampling=None):
        """LoRA requests speculate too: the TARGET verifies with the
        sequence's adapter, so emitted tokens are exactly adapter-greedy; the
        draft proposes with its base weights, so adapter drift lowers
        acceptance, never correctness.

        Sampled requests run batched speculative sampling: the draft samples
        proposals from its filtered distribution, acceptance is min(1, q/p)
        per position, and the first rejection's residual draw (or the bonus
        draw on full acceptance) becomes the next pending token, the same
        rule as SpeculativeDecoder. Greedy and sampled requests mix in one
        batch."""
        return self.inner.submit(prompt_tokens, max_new_tokens, eos_token,
                                 lora_id=lora_id, sampling=sampling)

    @property
    def has_work(self) -> bool:
        return self.inner.has_work

    def run(self):
        results = {}
        while self.has_work:
            for req in self.step():
                results[req.req_id] = req.generated
        return results

    # -- internals ----------------------------------------------------------

    def _draft_table(self, slot: int) -> torch.Tensor:
        return torch.from_numpy(self._slot_tables[slot, :-1]).to(self.pod.device)

    def _sync_new_runners(self) -> None:
        """Admissions since the last tick: take a draft slot and ingest the
        request's history up to (excluding) the pending token; the tick's
        first draft step covers the pending token itself."""
        for req in self.inner._running:
            if req.req_id in self._draft_state:
                continue
            slot = self._free_slots.pop()
            history = list(req.state.tokens[:-1])
            if history:
                self._draft_cache, _ = llama.prefill_cache(
                    self.draft_config, self.draft_params, self._draft_cache,
                    torch.tensor(history, dtype=torch.int32, device=self.pod.device),
                    self._draft_table(slot), 0,
                )
            self._draft_state[req.req_id] = [slot, len(history)]
        # Reap the state of requests that left the running set outside the
        # acceptance path (an admission-time EOS, or preemption).
        running_ids = {r.req_id for r in self.inner._running}
        for rid in list(self._draft_state):
            if rid not in running_ids:
                self._release(rid)

    def _release(self, req_id: int) -> None:
        slot_pos = self._draft_state.pop(req_id, None)
        if slot_pos is not None:
            self._free_slots.append(slot_pos[0])

    def step(self):
        finished = self.inner._rejected
        self.inner._rejected = []
        finished += self.inner._prefill_tick()
        self._sync_new_runners()
        finished += self._spec_decode()
        return finished

    @staticmethod
    def _greedy_accepted(argmaxes, proposals, allowed: int) -> int:
        """Proposals a greedy row keeps: those matching the target's argmax
        chain, capped by the row's allowance (columns past it exist only
        because the batch is rectangular)."""
        n = 0
        while n < allowed and argmaxes[n] == proposals[n]:
            n += 1
        return n

    def _spec_decode(self):
        running = self.inner._running
        if not running:
            return []
        pod = self.pod
        dev = pod.device
        page_size = pod.config.page_size

        # Per-sequence acceptance budgets: accepts[i] is how many PROPOSALS
        # sequence i may keep this round, bounded by its remaining budget
        # and page capacity. The rectangular chunk is as wide as the
        # strongest sequence's budget; weaker sequences' overrun rows land
        # in the pod's trash page.
        accepts = []
        for req in running:
            capacity = self._stripe_pages * page_size - len(req.state.tokens)
            budget = req.max_new_tokens - len(req.generated) - 1
            b_i = max(0, min(self.k, capacity, budget))
            # Reserve real pages for the rows this sequence may keep
            # (positions len-1 .. len+b_i-1). On pool exhaustion degrade to
            # b_i = 0, a plain decode step through the verify op, which needs
            # no new page (the pending row's page is already held), rather
            # than preempting the sequence.
            if b_i > 0:
                try:
                    pod.block_manager.reserve_pages(
                        req.state, (len(req.state.tokens) + b_i + page_size - 1) // page_size)
                except OutOfPagesError:
                    b_i = 0
            accepts.append(b_i)
        k_eff = max(accepts)

        b = len(running)
        # The batch is padded to a power-of-2 bucket, as the plain
        # scheduler's decode is. Pad rows carry all-trash tables (the draft
        # trash column, the pod's trash page) and max_len 0, so their
        # discarded steps never touch a real page.
        b_pad = pod.batch_bucket(b)
        pending = np.zeros((b_pad,), dtype=np.int32)
        pending[:b] = [req.state.tokens[-1] for req in running]
        starts = np.zeros((b_pad,), np.int32)
        starts[:b] = [len(r.state.tokens) - 1 for r in running]
        starts_t = torch.from_numpy(starts).to(dev)
        pending_t = torch.from_numpy(pending).to(dev)

        # Batched speculative SAMPLING state for rows with non-greedy
        # SamplingParams: per-row filter parameters and three key streams
        # per request (emissions, draft proposals, accept draws), each
        # folded per absolute position. Greedy rows keep temperature 0 and
        # ride the argmax paths.
        sampled_rows = [r.sampling is not None and not r.sampling.is_greedy for r in running]
        any_sampled = any(sampled_rows)
        if any_sampled:
            sp_temps = np.zeros((b_pad,), np.float32)
            sp_tks = np.zeros((b_pad,), np.int32)
            sp_tps = np.ones((b_pad,), np.float32)
            bases = [prng_key(0, "cpu")] * b_pad
            for i, r in enumerate(running):
                if sampled_rows[i]:
                    sp = r.sampling
                    sp_temps[i], sp_tks[i], sp_tps[i] = sp.temperature, sp.top_k, sp.top_p
                    bases[i] = prng_key(sp.seed if sp.seed is not None else r.req_id, "cpu")
            streams = split_key(torch.stack(bases).to(dev), 3)  # [b_pad, 3, 2]
            emit_keys, draft_keys, accept_keys = streams[:, 0], streams[:, 1], streams[:, 2]
            sp_arrays = (torch.from_numpy(sp_temps).to(dev), torch.from_numpy(sp_tks).to(dev),
                         torch.from_numpy(sp_tps).to(dev))

            def rep(t, n):  # each row's entry n times, rows kept together
                return torch.repeat_interleave(t, n, dim=0)

        # Batched draft proposals: the pending token seeds, then k_eff
        # autoregressive steps. Draft writes past a stripe's capacity land
        # in the shared draft trash column (see __init__); garbage proposals
        # there are harmless, acceptance is the target's.
        cur = pending_t
        proposals = []
        draft_dists = []  # sampled: p_j(.) [b_pad, V] per column
        if k_eff > 0:
            draft_tables = np.full((b_pad, self._slot_tables.shape[1]), self._draft_trash,
                                   dtype=np.int32)
            draft_tables[:b] = self._slot_tables[[self._draft_state[r.req_id][0]
                                                  for r in running]]
            tables = torch.from_numpy(draft_tables).to(dev)
            draft_pos = np.zeros((b_pad,), dtype=np.int32)
            draft_pos[:b] = [self._draft_state[r.req_id][1] for r in running]
            draft_pos_t = torch.from_numpy(draft_pos).to(dev)
            for j in range(k_eff):
                self._draft_cache, logits = llama.decode_step_cache(
                    self.draft_config, self.draft_params, self._draft_cache,
                    cur, tables, draft_pos_t + j,
                )
                if any_sampled:
                    # Proposal j occupies absolute position starts + 1 + j.
                    draft_dists.append(torch.softmax(filter_logits(logits, *sp_arrays), dim=-1))
                    cur = sample_tokens(logits, *sp_arrays,
                                        position_keys(draft_keys, starts_t + 1 + j))
                else:
                    cur = torch.argmax(logits, dim=-1).to(torch.int32)
                proposals.append(cur)
            # Ingest the final proposal's KV too (its logits are unused):
            # without it a fully accepted round leaves a zero-KV hole in the
            # draft cache at that position.
            self._draft_cache, _ = llama.decode_step_cache(
                self.draft_config, self.draft_params, self._draft_cache,
                cur, tables, draft_pos_t + k_eff,
            )
            self.stats.proposed += b * k_eff
        self.stats.rounds += 1

        # One batched target verification over [pending, proposals...], with
        # per-sequence row allowances: sequence i's rows land in real pages
        # up to position len + accepts[i] - 1 and in the trash page past it.
        chunk = torch.stack([pending_t] + proposals, dim=1)
        max_lens = np.zeros((b_pad,), np.int32)  # pad rows: every write to trash
        max_lens[:b] = [len(r.state.tokens) + a for r, a in zip(running, accepts)]
        need = max(len(r.state.block_table) for r in running)
        bucket = pod.table_bucket(need)
        tables = np.full((b_pad, bucket), pod.trash_page, dtype=np.int32)
        for i, req in enumerate(running):
            tables[i, : len(req.state.block_table)] = req.state.block_table
        lora_ids = [r.lora_id for r in running] + [None] * (b_pad - b)
        pod.kv_cache, verify_logits = llama.verify_step_cache(
            pod._model_config, pod.params, pod.kv_cache, chunk,
            torch.from_numpy(tables).to(dev), starts_t,
            torch.from_numpy(max_lens).to(dev), pod.trash_page,
            lora=pod.lora_for_decode(lora_ids),
        )
        cols1 = k_eff + 1
        parts = [chunk[:, 1:], torch.argmax(verify_logits, dim=-1)]  # [B, k], [B, k+1]
        if any_sampled:
            # Accept/resample draws for columns 0..k_eff-1 and emission
            # draws (the bonus on full acceptance, or the plain draw at
            # accepts[i] == 0) for every column, batched. Column j of a row
            # sits at absolute position starts + 1 + j.
            vocab = verify_logits.shape[-1]
            flat = verify_logits.reshape(b_pad * cols1, vocab)
            pos = (starts_t[:, None] + 1 + torch.arange(cols1, device=dev)[None]).reshape(-1)
            flat_sp = tuple(rep(t, cols1) for t in sp_arrays)
            parts.append(sample_tokens(flat, *flat_sp, position_keys(rep(emit_keys, cols1), pos)))
            if k_eff > 0:
                q_all = torch.softmax(filter_logits(flat, *flat_sp), dim=-1)
                q_all = q_all.reshape(b_pad, cols1, vocab)[:, :k_eff].reshape(-1, vocab)
                pos_k = pos.reshape(b_pad, cols1)[:, :k_eff].reshape(-1)
                toks_a, oks = accept_or_resample(
                    q_all, torch.stack(draft_dists, dim=1).reshape(-1, vocab),
                    chunk[:, 1:].reshape(-1),
                    position_keys(rep(accept_keys, k_eff), pos_k),
                )
                parts += [toks_a, oks]
        host = np.asarray(_read_back(parts), dtype=np.int64)
        sizes = [b_pad * k_eff, b_pad * cols1] + ([b_pad * cols1] if any_sampled else [])
        sizes += [b_pad * k_eff] * 2 if any_sampled and k_eff > 0 else []
        pieces = np.split(host, np.cumsum(sizes)[:-1])
        proposals_h = pieces[0].reshape(b_pad, k_eff)
        argmaxes = pieces[1].reshape(b_pad, cols1)
        if any_sampled:
            emit_draws = pieces[2].reshape(b_pad, cols1)
            if k_eff > 0:
                accept_toks = pieces[3].reshape(b_pad, k_eff)
                accept_oks = pieces[4].reshape(b_pad, k_eff)

        # The verify pass wrote KV for every sequence's pending token (and
        # its proposals): the pending row is resident, so commit any page it
        # completed.
        for req in running:
            pod.block_manager.mark_decode_computed(req.state)

        finished = []
        still_running = []
        for i, req in enumerate(running):
            if sampled_rows[i]:
                # Speculative sampling: accept while the min(1, q/p) draw
                # passes (capped by this row's budget); the first rejection's
                # residual draw, or the bonus/plain draw on full acceptance,
                # is the correction token.
                n_accept = 0
                correction = None
                for j in range(accepts[i]):
                    if accept_oks[i, j]:
                        n_accept += 1
                    else:
                        correction = int(accept_toks[i, j])
                        break
                if correction is None:
                    correction = int(emit_draws[i, n_accept])
            else:
                n_accept = self._greedy_accepted(argmaxes[i], proposals_h[i], accepts[i])
                correction = int(argmaxes[i, n_accept])
            self.stats.accepted += n_accept

            # Emit the accepted proposals, then the correction token (the
            # next pending). A final token is not appended, as in the plain
            # scheduler.
            to_emit = [int(p) for p in proposals_h[i, :n_accept]] + [correction]
            done = False
            preempted = False
            for j, tok in enumerate(to_emit):
                req.generated.append(tok)
                if self.inner._done(req, tok):
                    done = True
                    break
                try:
                    pod.decode_append(req.state, tok)
                except OutOfPagesError:
                    self.inner._preempt(req)
                    preempted = True
                    break
                # Accepted proposals (every emitted token but the final
                # correction) already have KV from the verify pass: commit
                # the pages they complete. The correction stays pending.
                if j < n_accept:
                    pod.block_manager.mark_decode_computed(req.state)
            if done:
                req.finished = True
                # Every token still in the sequence has resident KV (the
                # correction is only in `generated` on the done path):
                # commit before freeing so the tail page stays reusable.
                pod.block_manager.mark_decode_computed(req.state)
                pod.free(req.state)
                self._release(req.req_id)
                finished.append(req)
                continue
            if preempted:
                self._release(req.req_id)  # rebuilt on re-admission
                continue
            # Draft validity: everything but the new pending token.
            self._draft_state[req.req_id][1] = len(req.state.tokens) - 1
            still_running.append(req)
        self.inner._running = still_running
        return finished
