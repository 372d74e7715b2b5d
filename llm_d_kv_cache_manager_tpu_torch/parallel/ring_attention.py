"""Ring attention: exact causal attention over sequence-sharded inputs.

Port of the reference package's `parallel/ring_attention.py`. The sequence
is split over the ranks of an "sp" group in order; each rank holds its local
Q/K/V chunk, and the K/V blocks travel around the ring (each rank sends its
current block to the next rank and receives the previous rank's, one
`batch_isend_irecv` a step) while every rank accumulates online-softmax
partial results for its own queries. After sp steps every query has
attended to every key: exact attention in O(L / sp) memory per rank.

Causality is decided per (query chunk, key chunk): a rank at ring position
i attends chunks j < i in full, applies the triangular mask at j == i and
masks j > i (all -inf; rows that see no key keep m = -inf, guarded).

On a CUDA group the sends need NCCL (gloo sends CPU tensors only); the
tests run it over gloo on the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from llm_d_kv_cache_manager_tpu_torch.parallel.collectives import tp_rank, tp_size


def _rotate(blocks, group):
    """Each block sent to the next rank of the ring, the previous rank's
    received in its place."""
    n, me = tp_size(group), tp_rank(group)
    dst = dist.get_global_rank(group, (me + 1) % n)
    src = dist.get_global_rank(group, (me - 1) % n)
    received = [torch.empty_like(b) for b in blocks]
    ops = [dist.P2POp(dist.isend, b.contiguous(), dst, group) for b in blocks]
    ops += [dist.P2POp(dist.irecv, r, src, group) for r in received]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


def ring_attention(
    q: torch.Tensor,  # [B, L_local, n_heads, head_dim]
    k: torch.Tensor,  # [B, L_local, n_heads, head_dim]
    v: torch.Tensor,
    group=None,  # the "sp" group; None: one rank holds the whole sequence
) -> torch.Tensor:
    """Exact causal attention with K/V rotating around the group's ring."""
    n_shards, my_idx = tp_size(group), tp_rank(group)
    b, l_local, n_heads, head_dim = q.shape
    scale = 1.0 / (head_dim**0.5)

    qf = q.transpose(1, 2).float()  # [B, H, Lq, D]
    q_pos = torch.arange(l_local, device=q.device)[:, None]
    k_pos = torch.arange(l_local, device=q.device)[None, :]

    m = torch.full_like(qf[..., :1], -float("inf"))
    l_sum = torch.zeros_like(qf[..., :1])
    acc = torch.zeros_like(qf)
    k_blk, v_blk, src = k, v, my_idx  # src: the ring position the block came from
    for step in range(n_shards):
        kf = k_blk.transpose(1, 2).float()
        vf = v_blk.transpose(1, 2).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale

        if src == my_idx:
            mask = k_pos <= q_pos
        else:
            mask = torch.full_like(k_pos <= q_pos, src < my_idx)
        s = s.masked_fill(~mask[None, None], -float("inf"))

        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # All-masked rows keep m = -inf; guard the exp against inf - inf.
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe)
        p = torch.where(mask[None, None], p, 0.0)
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l_sum = alpha * l_sum + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vf)
        m = m_new

        if step < n_shards - 1:
            k_blk, v_blk = _rotate((k_blk, v_blk), group)
            src = (src - 1) % n_shards

    out = acc / torch.where(l_sum == 0, 1.0, l_sum)
    return out.transpose(1, 2).to(q.dtype)  # [B, L_local, H, D]
