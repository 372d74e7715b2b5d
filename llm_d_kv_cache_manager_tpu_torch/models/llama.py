"""Llama-3-style decoder with a paged KV cache: the serving subset, in torch.

Port of the reference package's `models/llama.py` serving path: RMSNorm,
RoPE, grouped-query attention, SwiGLU MLP, and two paths over one paged KV
cache (pools `[n_layers, n_kv, n_pages, page, hd]`, block tables on host):

- `prefill_cache`: one sequence's new tokens, written into their pages and
  attending to the cached prefix through `ops.flash_prefill`,
- `decode_step_cache`: a batched one-token step through `ops.paged_attention`.

Both update the page pools IN PLACE (the reference returns new arrays).
Weights keep the reference's `[in, out]` layout (`x @ W`), stacked on a
leading layer axis, so `params_from_jax` carries a JAX parameter tree across
without transposes. On CUDA tensors every attention call runs a
hand-written kernel; on CPU tensors, its plain torch version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llm_d_kv_cache_manager_tpu_torch.ops.flash_prefill import flash_prefill
from llm_d_kv_cache_manager_tpu_torch.ops.paged_attention import (
    paged_attention,
    write_kv_pages,
)
from llm_d_kv_cache_manager_tpu_torch.utils.device import resolve_device

Params = Dict


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 2048
    d_model: int = 256
    n_layers: int = 2
    n_q_heads: int = 8
    n_kv_heads: int = 4
    head_dim: int = 128
    d_ff: int = 512
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Qwen2-family additive q/k/v projection biases (HF `attention_bias`).
    attn_bias: bool = False
    # Sliding-window width (HF `sliding_window`): position p attends
    # [p-window+1, p] in every path. None = full causal attention.
    sliding_window: Optional[int] = None

    @property
    def q_dim(self) -> int:
        return self.n_q_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def init_params(
    config: LlamaConfig, generator: torch.Generator, device="cuda"
) -> Params:
    """Normal(0.02) init, layers stacked on a leading axis. `generator` must
    live on `device` (torch draws on the generator's device)."""
    c = config
    dev = resolve_device(device)

    def normal(*shape):
        t = torch.empty(shape, dtype=c.dtype, device=dev)
        return t.normal_(0.0, 0.02, generator=generator)

    def ones(*shape):
        return torch.ones(shape, dtype=c.dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=c.dtype, device=dev)

    n = c.n_layers
    layers = {
        "attn_norm": ones(n, c.d_model),
        "wq": normal(n, c.d_model, c.q_dim),
        "wk": normal(n, c.d_model, c.kv_dim),
        "wv": normal(n, c.d_model, c.kv_dim),
        "wo": normal(n, c.q_dim, c.d_model),
        "mlp_norm": ones(n, c.d_model),
        "w_gate": normal(n, c.d_model, c.d_ff),
        "w_up": normal(n, c.d_model, c.d_ff),
        "w_down": normal(n, c.d_ff, c.d_model),
    }
    if c.attn_bias:
        layers["bq"] = zeros(n, c.q_dim)
        layers["bk"] = zeros(n, c.kv_dim)
        layers["bv"] = zeros(n, c.kv_dim)
    return {
        "embed": normal(c.vocab_size, c.d_model),
        "layers": layers,
        "final_norm": ones(c.d_model),
        "out": normal(c.d_model, c.vocab_size),
    }


def _to_tensor(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from a JAX array
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_jax(np_params, device="cuda") -> Params:
    """Carry a reference-package parameter tree (leaves as numpy arrays, or
    anything `np.asarray` takes) across as torch tensors, layout unchanged:
    weights stay `[in, out]`, layers stay stacked on axis 0."""
    dev = resolve_device(device)
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, dev) for k, v in np_params.items()}
    return _to_tensor(np_params, dev)


def layer_params(params: Params, layer: int) -> Dict[str, torch.Tensor]:
    return {name: w[layer] for name, w in params["layers"].items()}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., seq, heads, head_dim], positions: [..., seq]."""
    head_dim = x.shape[-1]
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=x.device) / head_dim
    freqs = 1.0 / (theta**exponent)
    angles = positions[..., :, None].float() * freqs  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


def _mlp(layer: Dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ layer["w_gate"])
    return (gate * (x @ layer["w_up"])) @ layer["w_down"]


def _qv_proj(h: torch.Tensor, layer: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/v projections with the optional Qwen2-family bias."""
    q_flat = h @ layer["wq"]
    v_flat = h @ layer["wv"]
    if "bq" in layer:
        q_flat = q_flat + layer["bq"]
        v_flat = v_flat + layer["bv"]
    return q_flat, v_flat


def _k_proj(layer: Dict, h: torch.Tensor) -> torch.Tensor:
    """K projection with the optional Qwen2-family bias."""
    k = h @ layer["wk"]
    return k + layer["bk"] if "bk" in layer else k


# ---------------------------------------------------------------------------
# Paged-cache serving paths
# ---------------------------------------------------------------------------


def make_kv_pages(
    config: LlamaConfig, n_pages: int, page_size: int, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer KV page pools: [n_layers, n_kv, n_pages, page, hd]."""
    c = config
    dev = resolve_device(device)
    shape = (c.n_layers, c.n_kv_heads, n_pages, page_size, c.head_dim)
    return (
        torch.zeros(shape, dtype=c.dtype, device=dev),
        torch.zeros(shape, dtype=c.dtype, device=dev),
    )


def _cache_write(cache: tuple, block_table, k_new, v_new, start_pos) -> tuple:
    """Write one layer's new K/V rows into its page slice (in place)."""
    return write_kv_pages(cache[0], cache[1], block_table, k_new, v_new, start_pos)


def _cache_gather_dense(cache: tuple, block_table: torch.Tensor):
    """Materialize one layer's cached K/V for a block table (prefill path):
    (k_all, v_all), each [1, max_ctx, n_kv, hd], contiguous."""
    ids = block_table.long()

    def gather(pages):
        g = pages[:, ids]  # [n_kv, pages, page, hd]
        n_kv, n_seq_pages, page_size, head_dim = g.shape
        return g.reshape(n_kv, n_seq_pages * page_size, head_dim).transpose(0, 1)[None].contiguous()

    return gather(cache[0]), gather(cache[1])


def _cache_attend(cache: tuple, q, block_tables, seq_lens, window=None,
                  attend: Callable = paged_attention):
    """Batched decode attention over one layer's cache slice."""
    return attend(q, cache[0], cache[1], block_tables, seq_lens, window=window)


def _serving_attention(q, k, v, causal_offset, window=None):
    """Attention for the serving prefill path: the flash-prefill kernel on
    CUDA tensors, its plain version (`dense_attention`) on CPU tensors."""
    return flash_prefill(q, k, v, causal_offset, window=window)


@torch.no_grad()
def prefill_cache(
    config: LlamaConfig,
    params: Params,
    kv_cache: tuple,  # (k_pages, v_pages), layer-stacked; updated in place
    tokens: torch.Tensor,  # [L] one sequence's NEW (non-cached) tokens
    block_table: torch.Tensor,  # [pages_per_seq] int32
    start_pos: int,  # number of already-cached tokens (prefix-cache hit)
    n_valid: Optional[int] = None,  # real token count when `tokens` is
    # padded to a length bucket; pad rows write garbage KV at positions
    # beyond start_pos+n_valid, which callers must have reserved and which
    # is masked until a real write lands there. None -> all rows are real.
) -> Tuple[tuple, torch.Tensor]:
    """Prefill new tokens, attending to the cached prefix; returns
    (kv_cache, logits of token n_valid-1 (or L-1 unpadded))."""
    c = config
    l = tokens.shape[0]
    k_pages, v_pages = kv_cache
    x = params["embed"][tokens.long()][None]  # [1, L, d]
    positions = (start_pos + torch.arange(l, device=x.device))[None]  # [1, L]

    for i in range(c.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], c.rms_eps)
        q_flat, v_flat = _qv_proj(h, layer)
        q = q_flat.reshape(1, l, c.n_q_heads, c.head_dim)
        k = _k_proj(layer, h).reshape(1, l, c.n_kv_heads, c.head_dim)
        v = v_flat.reshape(1, l, c.n_kv_heads, c.head_dim)
        q = _rope(q, positions, c.rope_theta)
        k = _rope(k, positions, c.rope_theta)

        cache = (k_pages[i], v_pages[i])
        _cache_write(cache, block_table, k[0], v[0], start_pos)

        # Attend to everything cached so far (prefix + new), causally.
        k_all, v_all = _cache_gather_dense(cache, block_table)
        attn = _serving_attention(q, k_all, v_all, start_pos, window=c.sliding_window)
        x = x + attn.reshape(1, l, c.q_dim) @ layer["wo"]
        h = rms_norm(x, layer["mlp_norm"], c.rms_eps)
        x = x + _mlp(layer, h)

    x = rms_norm(x, params["final_norm"], c.rms_eps)
    last = l - 1 if n_valid is None else n_valid - 1
    return kv_cache, x[0, last] @ params["out"]


@torch.no_grad()
def _decode_once(
    config: LlamaConfig,
    params: Params,
    kv_cache: tuple,
    tokens: torch.Tensor,  # [B]
    block_tables: torch.Tensor,  # [B, pages_per_seq] int32
    seq_lens: torch.Tensor,  # [B] int32
    write_page_ids: torch.Tensor,  # [B] page each new KV row lands in
    write_slots: torch.Tensor,  # [B]
    attend: Callable = paged_attention,
) -> Tuple[tuple, torch.Tensor]:
    """Single batched decode step: writes each sequence's new K/V row at
    (write_page_ids, write_slots) and attends over seq_lens+1 positions.
    `attend` is the paged-attention op (the kernel wrapper; checks pass the
    plain version to compare against)."""
    c = config
    b = tokens.shape[0]
    k_pages, v_pages = kv_cache
    x = params["embed"][tokens.long()][:, None]  # [B, 1, d]
    positions = seq_lens.long()[:, None]  # [B, 1]
    page_ids = write_page_ids.long()
    slots = write_slots.long()
    lens = seq_lens + 1

    for i in range(c.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], c.rms_eps)
        q_flat, v_flat = _qv_proj(h, layer)
        q = q_flat.reshape(b, 1, c.n_q_heads, c.head_dim)
        k = _k_proj(layer, h).reshape(b, 1, c.n_kv_heads, c.head_dim)
        v = v_flat.reshape(b, 1, c.n_kv_heads, c.head_dim)
        q = _rope(q, positions, c.rope_theta)
        k = _rope(k, positions, c.rope_theta)

        # Scatter each sequence's new row straight into the layer's pool
        # slice: [n_kv, n_pages, page, hd][:, page_ids, slots] is [n_kv, B, hd].
        k_pages[i][:, page_ids, slots] = k[:, 0].transpose(0, 1)
        v_pages[i][:, page_ids, slots] = v[:, 0].transpose(0, 1)

        attn = _cache_attend(
            (k_pages[i], v_pages[i]), q[:, 0].contiguous(), block_tables, lens,
            window=c.sliding_window, attend=attend,
        )
        x = x + attn.reshape(b, 1, c.q_dim) @ layer["wo"]
        h = rms_norm(x, layer["mlp_norm"], c.rms_eps)
        x = x + _mlp(layer, h)

    x = rms_norm(x, params["final_norm"], c.rms_eps)
    return kv_cache, x[:, 0] @ params["out"]


def decode_step_cache(
    config: LlamaConfig,
    params: Params,
    kv_cache: tuple,
    tokens: torch.Tensor,  # [B] current token per sequence
    block_tables: torch.Tensor,  # [B, pages_per_seq] int32
    seq_lens: torch.Tensor,  # [B] int32 tokens already cached (new token's position)
) -> Tuple[tuple, torch.Tensor]:
    """One batched decode step; returns (kv_cache, logits [B, vocab]) with
    the pools updated in place."""
    page_size = kv_cache[0].shape[3]
    page_ids = torch.gather(
        block_tables, 1, (seq_lens // page_size).long()[:, None]
    )[:, 0]
    slots = seq_lens % page_size
    return _decode_once(
        config, params, kv_cache, tokens, block_tables, seq_lens, page_ids, slots
    )
