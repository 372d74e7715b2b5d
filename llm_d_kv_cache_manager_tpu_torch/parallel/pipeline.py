"""Pipeline parallelism: GPipe-style microbatched stages over a "pp" group.

Port of the reference package's `parallel/pipeline.py`. The stacked layer
params ([n_layers, ...]) split on their leading axis over the ranks of a
"pp" group, so each stage runs a contiguous block of layers. Microbatches of
embedded activations flow down the stages: at every tick of the classic
n_micro + n_stages - 1 fill-and-drain schedule, a stage with a live
microbatch receives it from the stage before (stage 0 takes it from the
input), applies its layers and sends it to the stage after. The last stage
keeps the finished microbatches and broadcasts them, so every rank returns
what running all layers on one device returns.

On a CUDA group the sends need NCCL (gloo sends CPU tensors only); the
tests run it over gloo on the CPU.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from llm_d_kv_cache_manager_tpu_torch.models.llama import (
    LlamaConfig,
    _k_proj,
    _mlp,
    _qv_proj_with_lora,
    _rope,
    rms_norm,
)
from llm_d_kv_cache_manager_tpu_torch.ops.flash_prefill import dense_attention
from llm_d_kv_cache_manager_tpu_torch.parallel.collectives import tp_rank, tp_size


def _apply_local_layers(config: LlamaConfig, layers: Dict, x: torch.Tensor) -> torch.Tensor:
    """Run a stage's layer block. x: [mb, L, d] (already embedded)."""
    c = config
    mb, l, _ = x.shape
    positions = torch.arange(l, device=x.device).expand(mb, l)
    for i in range(next(iter(layers.values())).shape[0]):
        layer = {name: w[i] for name, w in layers.items()}
        h = rms_norm(x, layer["attn_norm"], c.rms_eps)
        q_flat, v_flat = _qv_proj_with_lora(h, layer, None)
        q = q_flat.reshape(mb, l, c.n_q_heads, c.head_dim)
        k = _k_proj(layer, h).reshape(mb, l, c.n_kv_heads, c.head_dim)
        v = v_flat.reshape(mb, l, c.n_kv_heads, c.head_dim)
        q = _rope(q, positions, c.rope_theta)
        k = _rope(k, positions, c.rope_theta)
        attn = dense_attention(q, k, v, 0, window=c.sliding_window)
        x = x + attn.reshape(mb, l, c.q_dim) @ layer["wo"]
        h = rms_norm(x, layer["mlp_norm"], c.rms_eps)
        x = x + _mlp(layer, h)
    return x


def stage_layers(layer_params: Dict, group=None) -> Dict:
    """This stage's contiguous block of the stacked layers."""
    n_stages, idx = tp_size(group), tp_rank(group)
    n_layers = next(iter(layer_params.values())).shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_stages} stages must divide n_layers={n_layers}")
    per = n_layers // n_stages
    return {name: w[idx * per:(idx + 1) * per] for name, w in layer_params.items()}


@torch.no_grad()
def pipeline_forward(
    config: LlamaConfig,
    layer_params: Dict,  # the whole stack [n_layers, ...]; each stage runs its block
    x_embedded: torch.Tensor,  # [n_micro, mb, L, d]
    group=None,  # the "pp" group; None: one stage runs every layer
) -> torch.Tensor:
    """Run the stacked layers as a pipeline over `group`. Returns [n_micro,
    mb, L, d] final hidden states (before the final norm and head) on every
    rank."""
    n_stages, idx = tp_size(group), tp_rank(group)
    layers = stage_layers(layer_params, group)
    n_micro = x_embedded.shape[0]
    outputs = torch.zeros_like(x_embedded)
    if n_stages > 1:
        prev = dist.get_global_rank(group, idx - 1) if idx > 0 else None
        nxt = dist.get_global_rank(group, idx + 1) if idx < n_stages - 1 else None
        last = dist.get_global_rank(group, n_stages - 1)
    sends = []
    for t in range(n_micro + n_stages - 1):
        micro = t - idx  # the microbatch this stage holds at tick t
        if not 0 <= micro < n_micro:
            continue
        if idx == 0:
            state = x_embedded[micro]
        else:
            state = torch.empty_like(x_embedded[micro])
            dist.recv(state, prev, group=group)
        state = _apply_local_layers(config, layers, state)
        if idx == n_stages - 1:
            outputs[micro] = state
        else:
            out = state.contiguous()  # held until its send completes
            sends.append((dist.isend(out, nxt, group=group), out))
    for req, _ in sends:
        req.wait()
    if n_stages > 1:
        dist.broadcast(outputs, src=last, group=group)
    return outputs
