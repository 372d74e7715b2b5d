"""Mixtral-style MoE decoder: the serving subset, in torch.

Port of the reference package's `models/mixtral.py`. Attention (GQA, RoPE,
the paged KV cache) is the Llama family's; MoE replaces only the MLP, so
the KV-cache control plane is model-agnostic and every paged serving op of
`models/llama.py` serves this family through `llama._mlp_dispatch` (a layer
dict carrying "router" routes through `_moe_mlp_dense`).

Experts stay stacked on a leading axis ([n_layers, E, ...]) as in the
reference, so `llama.params_from_jax` carries a JAX MoE tree across
unchanged. Routing is top-k softmax gating with the reference's two
dispatch modes, chosen by `MixtralConfig.capacity_factor`:

- None (default): the exact dense dispatch. Every expert runs every token
  and the outputs combine through the (mostly zero) gate matrix: no
  dropping, E x the routed expert FLOPs. Serving always takes it.
- a float: the GShard-style static-capacity dispatch (`_moe_mlp_capacity`),
  sort-based slotting into a fixed per-expert capacity; overflow tokens
  fall back to the residual. `forward_dense` honours it.

The expert products are plain torch matrix products, as the reference
computes them outside any Pallas kernel. Each runs as one batched product
over the expert axis, so the stacked weights are read in place (an
`einsum` over `edf` would permute a copy of them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from llm_d_kv_cache_manager_tpu_torch.models.llama import _rope, rms_norm
from llm_d_kv_cache_manager_tpu_torch.ops.flash_prefill import dense_attention
from llm_d_kv_cache_manager_tpu_torch.utils.device import resolve_device

Params = Dict


@dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 2048
    d_model: int = 256
    n_layers: int = 2
    n_q_heads: int = 8
    n_kv_heads: int = 4
    head_dim: int = 128
    d_ff: int = 512
    n_experts: int = 8
    top_k: int = 2
    # None -> exact dense dispatch (every expert sees every token, E x the
    # FLOPs, no dropping). A float (GShard-style, e.g. 1.25) -> a fixed
    # per-expert capacity C = ceil(S * top_k * factor / E); overflow tokens
    # fall back to the residual. Serving ignores it (llama._mlp_dispatch).
    capacity_factor: Optional[float] = None
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Early Mixtral-8x7B configs set sliding_window=4096; attention is the
    # dense family's, so the window masks every path the same way.
    sliding_window: Optional[int] = None

    @property
    def q_dim(self) -> int:
        return self.n_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def init_params(
    config: MixtralConfig, generator: torch.Generator, device="cuda"
) -> Params:
    """Normal(0.02) init, layers stacked on a leading axis and experts on
    the next: router [n_layers, d, E], w_gate/w_up [n_layers, E, d, f],
    w_down [n_layers, E, f, d]. `generator` must live on `device`."""
    c = config
    dev = resolve_device(device)

    def normal(*shape):
        t = torch.empty(shape, dtype=c.dtype, device=dev)
        return t.normal_(0.0, 0.02, generator=generator)

    def ones(*shape):
        return torch.ones(shape, dtype=c.dtype, device=dev)

    n, e = c.n_layers, c.n_experts
    layers = {
        "attn_norm": ones(n, c.d_model),
        "wq": normal(n, c.d_model, c.q_dim),
        "wk": normal(n, c.d_model, c.kv_dim),
        "wv": normal(n, c.d_model, c.kv_dim),
        "wo": normal(n, c.q_dim, c.d_model),
        "mlp_norm": ones(n, c.d_model),
        "router": normal(n, c.d_model, e),
        "w_gate": normal(n, e, c.d_model, c.d_ff),
        "w_up": normal(n, e, c.d_model, c.d_ff),
        "w_down": normal(n, e, c.d_ff, c.d_model),
    }
    return {
        "embed": normal(c.vocab_size, c.d_model),
        "layers": layers,
        "final_norm": ones(c.d_model),
        "out": normal(c.d_model, c.vocab_size),
    }


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, ties in
    index order (lowest first), as `jax.lax.top_k` picks them: a stable
    descending sort. `torch.topk` promises no order among equal values, and
    an all-equal row (a zero or padded token) is all ties."""
    values, indices = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _experts(layer: Dict, x: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its own rows: x [E, N, d] -> [E, N, d], one
    batched product per projection over the stacked weights."""
    gate_proj = torch.bmm(x, layer["w_gate"])
    up_proj = torch.bmm(x, layer["w_up"])
    hidden = F.silu(gate_proj) * up_proj  # [E, N, f]
    return torch.bmm(hidden, layer["w_down"])


def _moe_mlp_capacity(
    config: MixtralConfig, layer: Dict, x: torch.Tensor
) -> torch.Tensor:
    """Capacity-based (GShard/Switch-style) top-k dispatch. x: [B, L, d].

    The S*K (token, choice) pairs are stably sorted by expert (k-major, so
    k=0 claims slots first), given in-group positions by a cumulative
    count and scattered into the [E, C, d] expert batch; pairs past the
    capacity land in a trash slot that is sliced away. Gates and the
    combine are in f32, as in the reference."""
    c = config
    b, l, d = x.shape
    s = b * l
    sk = s * c.top_k
    dev = x.device
    xf = x.reshape(s, d)
    capacity = max(
        1,
        int(-(-s * c.top_k * c.capacity_factor // c.n_experts)),  # ceil
    )

    logits = (xf @ layer["router"]).float()  # [S, E]
    top_vals, top_idx = top_k(logits, c.top_k)
    gates = torch.softmax(top_vals, dim=-1)  # [S, K] f32

    # k-major pair order: all k=0 pairs (token order), then k=1, ...
    flat_expert = top_idx.T.reshape(sk)
    flat_gate = gates.T.reshape(sk)
    flat_tok = torch.arange(s, device=dev).repeat(c.top_k)

    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]  # sorted pair -> expert
    sg = flat_gate[order]
    st = flat_tok[order]
    counts = torch.bincount(flat_expert, minlength=c.n_experts)
    group_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(sk, device=dev) - group_start[se]
    keep = pos < capacity

    # Kept pairs' destinations are distinct (expert, position) slots.
    slot = se * capacity + pos
    dest = torch.where(keep, slot, torch.full_like(slot, c.n_experts * capacity))
    expert_in = torch.zeros(c.n_experts * capacity + 1, d, dtype=x.dtype, device=dev)
    expert_in[dest] = xf[st]
    expert_out = _experts(layer, expert_in[:-1].reshape(c.n_experts, capacity, d))

    # Combine: gather each kept pair's expert output, weight it by its gate
    # and add it to its token (a token's k pairs sum).
    out_flat = expert_out.reshape(c.n_experts * capacity, d).float()
    vals = out_flat[torch.where(keep, slot, torch.zeros_like(slot))]
    vals = vals * (sg * keep.float())[:, None]
    y = torch.zeros(s, d, dtype=torch.float32, device=dev).index_add_(0, st, vals)
    return y.to(x.dtype).reshape(b, l, d)


def _moe_mlp_dense(config: MixtralConfig, layer: Dict, x: torch.Tensor) -> torch.Tensor:
    """The exact dense, dropless dispatch. x: [B, L, d]. Router logits in
    the model dtype, then f32; top-k and softmax in f32, gates cast back to
    the model dtype; the gate matrix and the combine in the model dtype (the
    reference's order). Each token's output depends on its own row only."""
    c = config
    b, l, d = x.shape
    xf = x.reshape(b * l, d)
    logits = (xf @ layer["router"]).float()  # [N, E]
    top_vals, top_idx = top_k(logits, c.top_k)
    gates = torch.softmax(top_vals, dim=-1).to(x.dtype)  # [N, K]
    gate_matrix = torch.zeros(logits.shape, dtype=x.dtype, device=x.device)
    gate_matrix.scatter_(1, top_idx, gates)  # [N, E], zero off the top k

    # Every expert runs every row; combine through the gate matrix:
    # out[n] = sum_e gate[n, e] * expert_out[e, n].
    expert_out = _experts(layer, xf.expand(c.n_experts, -1, -1))  # [E, N, d]
    out = torch.bmm(gate_matrix[:, None, :], expert_out.transpose(0, 1))  # [N, 1, d]
    return out.reshape(b, l, d)


def _moe_mlp(config: MixtralConfig, layer: Dict, x: torch.Tensor) -> torch.Tensor:
    """Top-k routed mixture of SwiGLU experts. x: [B, L, d]."""
    if config.capacity_factor is not None:
        return _moe_mlp_capacity(config, layer, x)
    return _moe_mlp_dense(config, layer, x)


@torch.no_grad()
def forward_dense(config: MixtralConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Plain causal forward over whole sequences (no cache; inference only):
    the serving tests' oracle. tokens: [B, L] -> logits [B, L, vocab]."""
    c = config
    b, l = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(l, device=x.device).expand(b, l)
    for i in range(c.n_layers):
        layer = {name: w[i] for name, w in params["layers"].items()}
        h = rms_norm(x, layer["attn_norm"], c.rms_eps)
        q = (h @ layer["wq"]).reshape(b, l, c.n_q_heads, c.head_dim)
        k = (h @ layer["wk"]).reshape(b, l, c.n_kv_heads, c.head_dim)
        v = (h @ layer["wv"]).reshape(b, l, c.n_kv_heads, c.head_dim)
        q = _rope(q, positions, c.rope_theta)
        k = _rope(k, positions, c.rope_theta)
        attn = dense_attention(q, k, v, 0, window=c.sliding_window)
        x = x + attn.reshape(b, l, c.q_dim) @ layer["wo"]
        h = rms_norm(x, layer["mlp_norm"], c.rms_eps)
        x = x + _moe_mlp(c, layer, h)
    x = rms_norm(x, params["final_norm"], c.rms_eps)
    return x @ params["out"]
