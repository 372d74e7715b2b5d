"""On-device token sampling: temperature / top-k / top-p with per-sequence
keys, drawing the same noise as the reference package's `ops/sampling.py`.

Port of the reference's sampler. Its design constraints hold here too:

- **Deterministic and chunking-invariant.** A sequence's randomness comes
  from `fold_in(base_key, position)`, one key per emitted position, so the
  same tokens come out whether the engine runs single-step decode, an
  N-step loop, or any mix, and whatever the sequence was batched with.
- **Rectangular.** Every filter is batched tensor math over [B, vocab]
  logits; temperature-0 rows fall back to argmax in the same call, so a
  batch mixes greedy and sampled traffic.
- **vLLM-style filter order**: temperature, then top-k, then top-p (the
  highest-probability token always survives). Sampling is the
  Gumbel-argmax trick.

The noise is the reference's, bit for bit: JAX's Threefry-2x32 counter hash
(with `jax_threefry_partitionable`, JAX's default) written in torch int64
arithmetic masked to 32 bits, so it runs on any device and the card draws
the same uniforms as the CPU. Keys are int64 tensors [..., 2] holding the
two uint32 words of a JAX key. Nothing here reads a value back to the host,
so a sampled step can later be captured in a CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from llm_d_kv_cache_manager_tpu_torch.utils.device import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls. Defaults mean greedy decoding.

    temperature: 0 => argmax (greedy). > 0 => softmax sampling.
    top_k: keep only the k highest-logit tokens (0 => no top-k filter).
    top_p: nucleus filter, keeping the smallest sorted prefix reaching
        cumulative probability top_p (1.0 => no filter).
    seed: base key seed for this request. None => the scheduler uses the
        request id, so runs stay reproducible.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under
    key words (k1, k2): int64 tensors of uint32 values, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device="cuda") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` as an int64 tensor [2] on `device`. JAX's
    default 32-bit mode keeps the seed's low 32 bits under a zero high
    word."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _key_words(keys: torch.Tensor):
    return keys[..., 0:1], keys[..., 1:2]


def split_key(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split` under partitionable Threefry: key i is the hash of
    counter (0, i). key [..., 2] -> [..., num, 2]."""
    k1, k2 = _key_words(key)
    iota = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(iota), iota)
    return torch.stack([b1, b2], dim=-1)


def position_keys(base_keys: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """One key per (sequence, position): `fold_in` of each sequence's base
    key with the absolute position being sampled. base_keys [B, 2],
    positions [B] -> [B, 2]."""
    pos = positions.to(torch.int64)[:, None] & _MASK
    b1, b2 = threefry2x32(*_key_words(base_keys), torch.zeros_like(pos), pos)
    return torch.cat([b1, b2], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.bits` of n 32-bit words per key: keys [..., 2] ->
    [..., n] int64 (partitionable Threefry: word j hashes counter (0, j))."""
    iota = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(*_key_words(keys), torch.zeros_like(iota), iota)
    return b1 ^ b2


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform`'s map of 32 random bits to f32 in [minval,
    maxval): 23 bits under the exponent of 1.0, minus 1, scaled."""
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(floats * span + lo, lo)


def gumbel_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """`jax.random.gumbel(key, (vocab,))` (mode "low") for each key:
    keys [..., 2] -> [..., vocab] f32."""
    u = uniform_from_bits(random_bits(keys, vocab), _F32_TINY, 1.0)
    return -torch.log(-torch.log(u))


def filter_logits(
    logits: torch.Tensor,  # [B, vocab]
    temps: torch.Tensor,  # [B] f32
    top_ks: torch.Tensor,  # [B] int; 0 = no top-k
    top_ps: torch.Tensor,  # [B] f32; 1.0 = no top-p, 0 clamps to ~greedy
) -> torch.Tensor:
    """Temperature -> top-k -> top-p filtered logits [B, vocab] in f32;
    filtered-out entries are -inf. softmax of the result is the sampling
    distribution, for plain sampling and speculative accept/resample
    alike."""
    vocab = logits.shape[-1]
    neg_inf = float("-inf")
    scaled = logits.float() / torch.clamp_min(temps.float(), 1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    # Top-k: keep logits >= the k-th largest (ties at the boundary survive).
    k_eff = torch.where(top_ks > 0, top_ks, vocab).long()
    kth = torch.gather(sorted_desc, 1, torch.clamp(k_eff - 1, 0, vocab - 1)[:, None])
    filtered = torch.where(scaled >= kth, scaled, neg_inf)
    # Top-k keeps the descending order, so no second sort is needed.
    sorted_f = torch.where(sorted_desc >= kth, sorted_desc, neg_inf)
    # Top-p: a sorted token survives while the probability before it is
    # < top_p, so the first always survives. top_p is clamped away from 0,
    # which would empty the kept set; 1e-6 keeps exactly the argmax.
    top_ps = torch.clamp_min(top_ps.float(), 1e-6)
    probs_sorted = torch.softmax(sorted_f, dim=-1)
    cum_before = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    keep_sorted = cum_before < top_ps[:, None]
    min_kept = torch.where(keep_sorted, sorted_f, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(filtered >= min_kept, filtered, neg_inf)


def sample_tokens(
    logits: torch.Tensor,  # [B, vocab]
    temps: torch.Tensor,  # [B] f32; <= 0 selects greedy for that row
    top_ks: torch.Tensor,  # [B] int; 0 = no top-k
    top_ps: torch.Tensor,  # [B] f32; 1.0 = no top-p
    keys: torch.Tensor,  # [B, 2] keys, already position-folded
) -> torch.Tensor:
    """Batched filtered sampling; returns [B] int32 token ids."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    filtered = filter_logits(logits, temps, top_ks, top_ps)
    noise = gumbel_noise(keys, logits.shape[-1])
    sampled = torch.argmax(filtered + noise, dim=-1).to(torch.int32)
    return torch.where(temps <= 0.0, greedy, sampled)


def accept_or_resample(
    q_probs: torch.Tensor,  # [..., V] target distribution at this position
    p_probs: torch.Tensor,  # [..., V] draft distribution of the proposal
    proposal: torch.Tensor,  # [...] int token the draft proposed
    key: torch.Tensor,  # [..., 2] key for this position's draws
):
    """Speculative-sampling acceptance (Leviathan et al. / Chen et al.):
    accept the proposal with probability min(1, q(x)/p(x)); on rejection
    emit a draw from the residual max(0, q - p), renormalized. The emitted
    token's law is exactly q. Leading dimensions batch independent draws.
    Returns (token int32, accepted bool)."""
    sub = split_key(key)  # [..., 2, 2]
    k_u, k_r = sub[..., 0, :], sub[..., 1, :]
    u = uniform_from_bits(random_bits(k_u, 1)[..., 0])
    proposal = torch.as_tensor(proposal, device=q_probs.device).long()
    shape = torch.broadcast_shapes(q_probs.shape[:-1], proposal.shape)
    q_b = q_probs.expand(*shape, q_probs.shape[-1])
    p_b = p_probs.expand(*shape, p_probs.shape[-1])
    idx = proposal.expand(shape)[..., None]
    ratio = (torch.gather(q_b, -1, idx)
             / torch.clamp_min(torch.gather(p_b, -1, idx), 1e-20))[..., 0]
    accepted = u < ratio
    residual = torch.clamp_min(q_probs - p_probs, 0.0)
    # q == p everywhere => acceptance is certain and the residual draw is
    # dead; the floor only guards the log.
    residual = residual / torch.clamp_min(residual.sum(-1, keepdim=True), 1e-20)
    # jax.random.categorical: argmax of the logits plus Gumbel noise.
    noise = gumbel_noise(k_r.expand(*shape, 2), q_probs.shape[-1])
    resampled = torch.argmax(torch.log(residual + 1e-30) + noise, dim=-1)
    token = torch.where(accepted, proposal.expand(shape), resampled).to(torch.int32)
    return token, accepted
