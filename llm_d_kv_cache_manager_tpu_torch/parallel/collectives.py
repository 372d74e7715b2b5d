"""The Megatron collectives of a tensor-parallel group, written out.

The reference shards weights with PartitionSpecs and lets the compiler insert
the collectives. Torch has no such pass, so the port's tp paths call these
explicitly (models/llama.py, models/mixtral.py):

- `copy_to_tp` (Megatron's f): identity forward, all-reduce backward. It
  marks where a replicated activation enters a column-parallel product
  (wq/wk/wv, w_gate/w_up, the vocab-parallel head), so the activation's
  gradient sums over the ranks' column shards.
- `reduce_from_tp` (Megatron's g): all-reduce forward, identity backward,
  after each row-parallel product (wo, w_down): the ranks' partial sums of
  one output.
- `gather_from_tp`: the vocab-parallel logits, each rank's column block
  gathered on the last axis; backward keeps this rank's block.
- `broadcast_from_first`: group rank 0's tensor on every rank (no
  gradient). Serving broadcasts the chosen tokens with it, so every rank
  commits the same tokens whatever its own argmax says.

With `group=None` or a group of one rank each is the identity: the
single-rank case, not a fallback. The collectives take tensors on any
device; a gloo group moves CUDA tensors through the host itself (two ranks
on one card), an NCCL group on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def tp_size(group: Group) -> int:
    """Ranks in the group (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def tp_rank(group: Group) -> int:
    """This process's rank within the group (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.width = x.shape[-1]
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        start = dist.get_rank(ctx.group) * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None


def copy_to_tp(x: torch.Tensor, group: Group) -> torch.Tensor:
    if tp_size(group) == 1:
        return x
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group: Group) -> torch.Tensor:
    if tp_size(group) == 1:
        return x
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group: Group) -> torch.Tensor:
    if tp_size(group) == 1:
        return x
    return _GatherFromTP.apply(x, group)


def broadcast_from_first(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Group rank 0's `x` on every rank of the group (same shape and dtype
    everywhere)."""
    if tp_size(group) == 1:
        return x
    x = x.contiguous()
    dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x


def all_reduce_mean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The mean of `x` over the group's ranks (the data-parallel gradient
    and loss average); no gradient flows through it."""
    n = tp_size(group)
    if n == 1:
        return x
    return _all_reduce(x, group) / n
