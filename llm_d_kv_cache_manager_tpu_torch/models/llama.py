"""Llama-3-style decoder with a paged KV cache: the serving subset, in torch.

Port of the reference package's `models/llama.py` serving path: RMSNorm,
RoPE, grouped-query attention, SwiGLU MLP, and two paths over one paged KV
cache (pools `[n_layers, n_kv, n_pages, page, hd]`, block tables on host):

- `prefill_cache`: one sequence's new tokens, written into their pages and
  attending to the cached prefix through `ops.flash_prefill`,
- `decode_step_cache`: a batched one-token step through `ops.paged_attention`
  (`pipelined=True`, the default, or the split-KV tiled kernel),
- `decode_multi_step_cache`: N decode steps with each token (argmax, or
  `ops.sampling.sample_tokens`) kept on the device and over-budget rows
  steered to a trash page,
- `verify_step_cache`: several positions of every sequence in one batched
  pass (packed prefill, speculative verification), through
  `ops.flash_prefill` with per-batch offsets.

Each path takes an optional `lora`: q/v adapter deltas (`models/lora.py`),
one adapter for a prefill, `(stack, [B] indices)` for a batch, where a row
may run the base model (index 0). `lora=None` leaves the computation as it
is without adapters, launch for launch.

The cache is either a (k, v) pair of pools in the model dtype or an int8
(k_q, k_scale, v_q, v_scale) quadruple (`ops/quantized_kv.py`); the helpers
dispatch on the tuple's length. Every path updates the pools IN PLACE (the
reference returns new arrays).
Both model families serve through these paths: the MLP dispatches on the
layer dict (`_mlp_dispatch`), dense SwiGLU or the MoE mixture of
`models/mixtral.py`. `forward_dense` is the dense family's cacheless
forward, the oracle of the serving tests; `loss_fn` and `train_step` train
on the same forward with autograd (no kernel runs under it, as the
reference keeps its kernels out of `value_and_grad`).

Tensor parallel: each paged path and the training forward take `group`, a
process group whose ranks hold the Megatron shards of the weights and the
head shards of the pages (parallel/serving.py). The rank projects onto its
own heads, the kernels attend over those heads only, the row-parallel sums
after wo and w_down are all-reduced and the vocab-parallel logits gathered
(parallel/collectives.py); the multi-step decode broadcasts group rank 0's
token each step. `group=None` is the single-rank model.
Weights keep the reference's `[in, out]` layout (`x @ W`), stacked on a
leading layer axis, so `params_from_jax` carries a JAX parameter tree across
without transposes. On CUDA tensors every attention call runs a
hand-written kernel; on CPU tensors, its plain torch version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llm_d_kv_cache_manager_tpu_torch.models.lora import (
    apply_decode_delta,
    apply_prefill_delta,
    gather_adapters,
)
from llm_d_kv_cache_manager_tpu_torch.ops.flash_prefill import dense_attention, flash_prefill
from llm_d_kv_cache_manager_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
    write_kv_pages,
)
from llm_d_kv_cache_manager_tpu_torch.ops.quantized_kv import (
    dequantize_gathered,
    paged_attention_quantized,
    paged_attention_quantized_reference,
    quantize_rows,
    write_kv_pages_quantized,
)
from llm_d_kv_cache_manager_tpu_torch.ops.sampling import position_keys, sample_tokens
from llm_d_kv_cache_manager_tpu_torch.parallel.collectives import (
    all_reduce_mean,
    broadcast_from_first,
    copy_to_tp,
    gather_from_tp,
    reduce_from_tp,
    tp_size,
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


def _local_heads(config, group) -> Tuple[int, int]:
    """(query heads, kv heads) this rank of `group` holds."""
    tp = tp_size(group)
    return config.n_q_heads // tp, config.n_kv_heads // tp


def _logits(x: torch.Tensor, out: torch.Tensor, group) -> torch.Tensor:
    """The (vocab-parallel) head over normed rows: every rank's block of the
    vocabulary, gathered."""
    return gather_from_tp(copy_to_tp(x, group) @ out, group)


def is_moe_config(config) -> bool:
    """The family predicate: a config carrying n_experts is the MoE family
    (models/mixtral.py), whose layers carry a "router" (the key
    `_mlp_dispatch` reads); the pod checks that the two agree."""
    return getattr(config, "n_experts", None) is not None


def _mlp_dispatch(config, layer: Dict, x: torch.Tensor) -> torch.Tensor:
    """The MLP of the serving paths for both families: a layer dict carrying
    a "router" key is a MoE layer and routes through the mixture, any other
    is dense SwiGLU; `config` is the family's own config.

    Serving always routes dropless (`capacity_factor` is ignored): the
    static-capacity dispatch makes tokens contend for expert slots with
    whatever shares the call, so a token's output would depend on the
    co-batched traffic and the bucket padding, and paged serving would no
    longer equal the dense forward."""
    if "router" in layer:
        from llm_d_kv_cache_manager_tpu_torch.models import mixtral

        return mixtral._moe_mlp_dense(config, layer, x)
    return _mlp(layer, x)


def _qv_proj(h: torch.Tensor, layer: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/v projections with the optional Qwen2-family bias."""
    q_flat = h @ layer["wq"]
    v_flat = h @ layer["wv"]
    if "bq" in layer:
        q_flat = q_flat + layer["bq"]
        v_flat = v_flat + layer["bv"]
    return q_flat, v_flat


def _gathered_lora(lora):
    """Per-sequence adapter weights {name: [n_layers, B, ...]} from (stack,
    indices), gathered once per call; None without adapters."""
    if lora is None:
        return None
    stack, adapter_indices = lora
    return gather_adapters(stack, adapter_indices)


def _layer_lora(lora_layers, i: int):
    """Layer i's slice of gathered (or selected) adapter weights, or None."""
    if lora_layers is None:
        return None
    return {name: w[i] for name, w in lora_layers.items()}


def _qv_proj_with_lora(h: torch.Tensor, layer: Dict, lora_slice):
    """q/v projections with optional per-sequence LoRA deltas: the one
    definition decode, multi-step decode and verify share, so their LoRA
    math cannot drift apart. h: [B, S, d]; lora_slice: a layer's gathered
    adapter arrays ([B, d, r] / [B, r, out]) or None."""
    q_flat, v_flat = _qv_proj(h, layer)
    if lora_slice is not None:
        dq, dv = apply_decode_delta(h, lora_slice)
        q_flat = q_flat + dq
        v_flat = v_flat + dv
    return q_flat, v_flat


def _k_proj(layer: Dict, h: torch.Tensor) -> torch.Tensor:
    """K projection with the optional Qwen2-family bias."""
    k = h @ layer["wk"]
    return k + layer["bk"] if "bk" in layer else k


def dense_core(config: LlamaConfig, params: Params, tokens: torch.Tensor,
               first: int = 0, group=None) -> torch.Tensor:
    """Plain causal forward over whole sequences (no cache), differentiable:
    the training forward. tokens: [B, L] -> logits [B, L - first, vocab] of
    positions first.. (the head runs on those rows only: at a 152k
    vocabulary, logits of every position of a long batch take gigabytes).
    With `group`, params are this rank's Megatron shards (parallel/mesh.py)
    and the collectives carry their gradients."""
    c = config
    n_q, n_kv = _local_heads(c, group)
    b, l = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(l, device=x.device).expand(b, l)
    for i in range(c.n_layers):
        layer = layer_params(params, i)
        h = copy_to_tp(rms_norm(x, layer["attn_norm"], c.rms_eps), group)
        q_flat, v_flat = _qv_proj(h, layer)
        q = _rope(q_flat.reshape(b, l, n_q, c.head_dim), positions, c.rope_theta)
        k = _rope(_k_proj(layer, h).reshape(b, l, n_kv, c.head_dim), positions,
                  c.rope_theta)
        v = v_flat.reshape(b, l, n_kv, c.head_dim)
        attn = dense_attention(q, k, v, 0, window=c.sliding_window)
        x = x + reduce_from_tp(attn.reshape(b, l, n_q * c.head_dim) @ layer["wo"], group)
        h = copy_to_tp(rms_norm(x, layer["mlp_norm"], c.rms_eps), group)
        x = x + reduce_from_tp(_mlp(layer, h), group)
    x = rms_norm(x[:, first:], params["final_norm"], c.rms_eps)
    return _logits(x, params["out"], group)


@torch.no_grad()
def forward_dense(config: LlamaConfig, params: Params, tokens: torch.Tensor,
                  first: int = 0) -> torch.Tensor:
    """`dense_core` for inference only: the serving tests' oracle."""
    return dense_core(config, params, tokens, first)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy in f32 over logits [B, L, vocab] of tokens
    [B, L]: position i predicts token i + 1."""
    logprobs = F.log_softmax(logits.float()[:, :-1], dim=-1)
    nll = -torch.gather(logprobs, -1, tokens[:, 1:].long()[..., None])
    return nll.mean()


def loss_fn(config: LlamaConfig, params: Params, tokens: torch.Tensor,
            group=None) -> torch.Tensor:
    """Next-token cross-entropy of the dense forward (tp over `group`)."""
    return next_token_loss(dense_core(config, params, tokens, group=group), tokens)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _rebuild(tree, values: dict, prefix=()):
    return {k: _rebuild(v, values, prefix + (k,)) if isinstance(v, dict) else values[prefix + (k,)]
            for k, v in tree.items()}


def loss_and_grads(loss_of, params: Params, dp_group=None) -> Tuple[torch.Tensor, Params]:
    """(loss, gradient tree) of a loss over a param tree, by autograd (the
    reference's `jax.value_and_grad`); with `dp_group`, both averaged over
    its ranks, each of which holds a share of the batch."""
    paths, leaves = zip(*_leaves(params))
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_of(_rebuild(params, dict(zip(paths, live))))
        grads = torch.autograd.grad(loss, live)
    grads = {path: all_reduce_mean(g, dp_group) for path, g in zip(paths, grads)}
    return all_reduce_mean(loss.detach(), dp_group), _rebuild(params, grads)


def sgd_step(loss_of, params: Params, lr: float, dp_group=None) -> Tuple[Params, torch.Tensor]:
    """One SGD step of a loss over a param tree: p - lr * g in f32, cast
    back to each param's dtype. Returns (new params, loss)."""
    loss, grads = loss_and_grads(loss_of, params, dp_group)
    new = {path: (p.float() - lr * g.float()).to(p.dtype)
           for (path, p), (_, g) in zip(_leaves(params), _leaves(grads))}
    return _rebuild(params, new), loss


def train_step(config: LlamaConfig, params: Params, tokens: torch.Tensor, lr: float = 1e-3,
               group=None, dp_group=None) -> Tuple[Params, torch.Tensor]:
    """One SGD step. `group`: the tp group whose ranks hold the Megatron
    shards; `dp_group`: the data-parallel group whose ranks each hold a
    share of the batch (parallel/mesh.batch_sharding)."""
    return sgd_step(lambda p: loss_fn(config, p, tokens, group), params, lr, dp_group)


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


def make_kv_pages_quantized(
    config: LlamaConfig, n_pages: int, page_size: int, device="cuda"
) -> Tuple[torch.Tensor, ...]:
    """Per-layer int8 pools, layer-stacked: (k_q, k_scale, v_q, v_scale),
    values [n_layers, n_kv, n_pages, page, hd] int8, scales [..., 1] f32."""
    c = config
    dev = resolve_device(device)
    q_shape = (c.n_layers, c.n_kv_heads, n_pages, page_size, c.head_dim)
    s_shape = q_shape[:-1] + (1,)
    return (
        torch.zeros(q_shape, dtype=torch.int8, device=dev),
        torch.zeros(s_shape, dtype=torch.float32, device=dev),
        torch.zeros(q_shape, dtype=torch.int8, device=dev),
        torch.zeros(s_shape, dtype=torch.float32, device=dev),
    )


def _layer(cache: tuple, i: int) -> tuple:
    """Layer i's slice of every pool of a layer-stacked cache."""
    return tuple(pool[i] for pool in cache)


def _cache_write(cache: tuple, block_table, k_new, v_new, start_pos) -> tuple:
    """Write one layer's new K/V rows into its (model-dtype or int8) page
    slice, in place."""
    if len(cache) == 2:
        return write_kv_pages(cache[0], cache[1], block_table, k_new, v_new, start_pos)
    return write_kv_pages_quantized(*cache, block_table, k_new, v_new, start_pos)


def _scatter_rows(cache: tuple, page_ids, slots, k_rows, v_rows) -> None:
    """Store K/V rows [n_kv, N, hd] at (page_ids, slots) [N] of one layer's
    pools, quantizing them first for an int8 cache (in place)."""
    if len(cache) == 2:
        cache[0][:, page_ids, slots] = k_rows
        cache[1][:, page_ids, slots] = v_rows
        return
    kq, ks, vq, vs = cache
    k_q, k_s = quantize_rows(k_rows)
    v_q, v_s = quantize_rows(v_rows)
    kq[:, page_ids, slots] = k_q
    ks[:, page_ids, slots, 0] = k_s
    vq[:, page_ids, slots] = v_q
    vs[:, page_ids, slots, 0] = v_s


def _cache_gather_dense(cache: tuple, block_tables: torch.Tensor, dtype):
    """Materialize one layer's cached K/V for each row of a block table
    [B, P]: (k_all, v_all), each [B, P * page, n_kv, hd], contiguous. An int8
    cache gathers the referenced pages first and dequantizes only those,
    never the whole pool."""
    ids = block_tables.long()
    if len(cache) == 2:
        k, v = cache[0][:, ids], cache[1][:, ids]
    else:
        k = dequantize_gathered(cache[0], cache[1], ids, dtype)
        v = dequantize_gathered(cache[2], cache[3], ids, dtype)

    def dense(g):  # [n_kv, B, P, page, hd] -> [B, P * page, n_kv, hd]
        n_kv, b, n_seq_pages, page_size, head_dim = g.shape
        return g.permute(1, 2, 3, 0, 4).reshape(b, n_seq_pages * page_size, n_kv, head_dim).contiguous()

    return dense(k), dense(v)


def _cache_attend(cache: tuple, q, block_tables, seq_lens, *, pipelined: bool,
                  window=None, plain: bool = False):
    """Batched decode attention over one layer's cache slice: the decode
    kernel of the cache's format and the chosen variant (its plain version
    on CPU tensors), or with `plain=True` the plain version on any device
    (the checks' comparison path)."""
    if len(cache) == 2:
        if plain:
            return paged_attention_reference(q, *cache, block_tables, seq_lens, window=window)
        return paged_attention(q, *cache, block_tables, seq_lens,
                               pipelined=pipelined, window=window)
    if plain:
        return paged_attention_quantized_reference(
            q, *cache, block_tables, seq_lens, window=window
        )
    return paged_attention_quantized(q, *cache, block_tables, seq_lens,
                                     pipelined=pipelined, window=window)


def _serving_attention(q, k, v, causal_offset, window=None, plain: bool = False):
    """Attention for the serving prefill path: the flash-prefill kernel on
    CUDA tensors, its plain version (`dense_attention`) on CPU tensors, or
    with `plain=True` the plain version on any device (the checks'
    comparison path)."""
    if plain:
        return dense_attention(q, k, v, causal_offset, window=window)
    return flash_prefill(q, k, v, causal_offset, window=window)


@torch.no_grad()
def prefill_cache(
    config: LlamaConfig,
    params: Params,
    kv_cache: tuple,  # (k, v) or int8 (k_q, k_s, v_q, v_s), layer-stacked;
    # updated in place
    tokens: torch.Tensor,  # [L] one sequence's NEW (non-cached) tokens
    block_table: torch.Tensor,  # [pages_per_seq] int32
    start_pos: int,  # number of already-cached tokens (prefix-cache hit)
    n_valid: Optional[int] = None,  # real token count when `tokens` is
    # padded to a length bucket; pad rows write garbage KV at positions
    # beyond start_pos+n_valid, which callers must have reserved and which
    # is masked until a real write lands there. None -> all rows are real.
    plain: bool = False,  # the plain attention path (checks compare with it)
    lora=None,  # this sequence's adapter (lora.select_adapter) or None
    all_logits: bool = False,  # True: logits of EVERY position (spec verify)
    group=None,  # the tp group; params and pages are this rank's shards
) -> Tuple[tuple, torch.Tensor]:
    """Prefill new tokens, attending to the cached prefix; returns
    (kv_cache, logits of token n_valid-1 (or L-1 unpadded)), or with
    `all_logits` (kv_cache, logits [L, vocab]): the speculative decoder's
    verification pass. `lora` adds this sequence's q/v adapter deltas."""
    c = config
    n_q, n_kv = _local_heads(c, group)
    l = tokens.shape[0]
    x = params["embed"][tokens.long()][None]  # [1, L, d]
    positions = (start_pos + torch.arange(l, device=x.device))[None]  # [1, L]

    for i in range(c.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], c.rms_eps)
        q_flat, v_flat = _qv_proj(h, layer)
        if lora is not None:
            dq, dv = apply_prefill_delta(h, _layer_lora(lora, i))
            q_flat = q_flat + dq
            v_flat = v_flat + dv
        q = q_flat.reshape(1, l, n_q, c.head_dim)
        k = _k_proj(layer, h).reshape(1, l, n_kv, c.head_dim)
        v = v_flat.reshape(1, l, n_kv, c.head_dim)
        q = _rope(q, positions, c.rope_theta)
        k = _rope(k, positions, c.rope_theta)

        cache = _layer(kv_cache, i)
        _cache_write(cache, block_table, k[0], v[0], start_pos)

        # Attend to everything cached so far (prefix + new), causally.
        k_all, v_all = _cache_gather_dense(cache, block_table[None], c.dtype)
        attn = _serving_attention(q, k_all, v_all, start_pos, window=c.sliding_window,
                                  plain=plain)
        x = x + reduce_from_tp(attn.reshape(1, l, n_q * c.head_dim) @ layer["wo"], group)
        h = rms_norm(x, layer["mlp_norm"], c.rms_eps)
        x = x + reduce_from_tp(_mlp_dispatch(c, layer, h), group)

    x = rms_norm(x, params["final_norm"], c.rms_eps)
    if all_logits:
        return kv_cache, _logits(x[0], params["out"], group)  # [L, vocab]
    last = l - 1 if n_valid is None else n_valid - 1
    return kv_cache, _logits(x[0, last], params["out"], group)


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
    pipelined: bool = True,  # decode kernel variant; see _cache_attend
    plain: bool = False,  # the plain attention path (checks compare with it)
    lora_layers=None,  # gathered per-sequence adapters (_gathered_lora) or None
    group=None,  # the tp group; params and pages are this rank's shards
) -> Tuple[tuple, torch.Tensor]:
    """Single batched decode step: writes each sequence's new K/V row at
    (write_page_ids, write_slots) and attends over seq_lens+1 positions."""
    c = config
    n_q, n_kv = _local_heads(c, group)
    b = tokens.shape[0]
    x = params["embed"][tokens.long()][:, None]  # [B, 1, d]
    positions = seq_lens.long()[:, None]  # [B, 1]
    page_ids = write_page_ids.long()
    slots = write_slots.long()
    lens = seq_lens + 1

    for i in range(c.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], c.rms_eps)
        q_flat, v_flat = _qv_proj_with_lora(h, layer, _layer_lora(lora_layers, i))
        q = q_flat.reshape(b, 1, n_q, c.head_dim)
        k = _k_proj(layer, h).reshape(b, 1, n_kv, c.head_dim)
        v = v_flat.reshape(b, 1, n_kv, c.head_dim)
        q = _rope(q, positions, c.rope_theta)
        k = _rope(k, positions, c.rope_theta)

        # Scatter each sequence's new row straight into the layer's pools:
        # [n_kv, n_pages, page, hd][:, page_ids, slots] is [n_kv, B, hd].
        cache = _layer(kv_cache, i)
        _scatter_rows(cache, page_ids, slots, k[:, 0].transpose(0, 1),
                      v[:, 0].transpose(0, 1))
        attn = _cache_attend(
            cache, q[:, 0].contiguous(), block_tables, lens,
            pipelined=pipelined, window=c.sliding_window, plain=plain,
        )
        x = x + reduce_from_tp(attn.reshape(b, 1, n_q * c.head_dim) @ layer["wo"], group)
        h = rms_norm(x, layer["mlp_norm"], c.rms_eps)
        x = x + reduce_from_tp(_mlp_dispatch(c, layer, h), group)

    x = rms_norm(x, params["final_norm"], c.rms_eps)
    return kv_cache, _logits(x[:, 0], params["out"], group)


def decode_step_cache(
    config: LlamaConfig,
    params: Params,
    kv_cache: tuple,
    tokens: torch.Tensor,  # [B] current token per sequence
    block_tables: torch.Tensor,  # [B, pages_per_seq] int32
    seq_lens: torch.Tensor,  # [B] int32 tokens already cached (new token's position)
    pipelined: bool = True,  # False: the split-KV tiled decode kernel
    lora=None,  # (adapter registry stack, [B] int32 indices) or None; a
    # batch mixes adapters and base traffic (index 0)
    group=None,  # the tp group; params and pages are this rank's shards
) -> Tuple[tuple, torch.Tensor]:
    """One batched decode step; returns (kv_cache, logits [B, vocab]) with
    the pools updated in place."""
    page_size = kv_cache[0].shape[3]
    page_ids = torch.gather(
        block_tables, 1, (seq_lens // page_size).long()[:, None]
    )[:, 0]
    slots = seq_lens % page_size
    return _decode_once(
        config, params, kv_cache, tokens, block_tables, seq_lens, page_ids, slots,
        pipelined=pipelined, lora_layers=_gathered_lora(lora), group=group,
    )


def decode_multi_step_cache(
    config: LlamaConfig,
    params: Params,
    kv_cache: tuple,
    tokens: torch.Tensor,  # [B] current (pending) token per sequence
    block_tables: torch.Tensor,  # [B, pages_per_seq] covering seq_lens+n_steps
    seq_lens: torch.Tensor,  # [B] int32 tokens already cached
    max_lens: torch.Tensor,  # [B] per-sequence write capacity: positions <
    # max_lens land in real pages, later ones in the trash page
    trash_page: int,  # sacrificial page id for capacity-masked writes
    n_steps: int,
    sampling=None,  # (temps [B], top_ks [B], top_ps [B], base_keys [B, 2])
    # or None for greedy; keys are folded per in-loop position, so the
    # tokens equal single-step sampling's (ops/sampling.py)
    lora=None,  # (stack, [B] indices) or None, as decode_step_cache's
    group=None,  # the tp group; each step's tokens are group rank 0's
) -> Tuple[tuple, torch.Tensor]:
    """N decode steps; returns (kv_cache, tokens_out [B, N]), where
    tokens_out[:, j] is the token chosen at step j (argmax, or filtered
    sampling when `sampling` is given). Each step's token stays on the
    device and feeds the next step, and the page-table walk advances with
    it, so the host reads the tokens once at the end.

    The batch is rectangular: a sequence whose budget ends mid-window keeps
    stepping, but its out-of-budget KV rows go to `trash_page` (a page the
    engine allocates beyond the block manager's pool), so it never corrupts
    a real page; the host discards its out-of-budget tokens."""
    page_size = kv_cache[0].shape[3]
    last_index = block_tables.shape[1] - 1
    lora_layers = _gathered_lora(lora)
    tok, lens = tokens, seq_lens
    out = []
    for _ in range(n_steps):
        # The table index is clamped for overrun rows; their page id is
        # replaced by the trash page anyway.
        idx = torch.clamp(lens // page_size, max=last_index).long()
        pages = torch.gather(block_tables, 1, idx[:, None])[:, 0]
        pages = torch.where(lens < max_lens, pages, torch.full_like(pages, trash_page))
        kv_cache, logits = _decode_once(
            config, params, kv_cache, tok, block_tables, lens, pages, lens % page_size,
            pipelined=True, lora_layers=lora_layers, group=group,
        )
        if sampling is None:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            temps, top_ks, top_ps, base_keys = sampling
            tok = sample_tokens(logits, temps, top_ks, top_ps,
                                position_keys(base_keys, lens))
        tok = broadcast_from_first(tok, group)
        out.append(tok)
        lens = lens + 1
    return kv_cache, torch.stack(out, dim=1)


@torch.no_grad()
def verify_step_cache(
    config: LlamaConfig,
    params: Params,
    kv_cache: tuple,
    tokens: torch.Tensor,  # [B, S] S new tokens per sequence
    block_tables: torch.Tensor,  # [B, pages_per_seq] int32
    start_positions: torch.Tensor,  # [B] int32 cached tokens per sequence
    max_lens: Optional[torch.Tensor] = None,  # [B] per-sequence row-write
    # capacity: rows at positions >= max_lens[b] go to trash_page, so a
    # rectangular batch can exceed a short sequence's budget without
    # corrupting real pages. None: every row lands in a real page.
    trash_page: int = 0,
    lora=None,  # (stack, [B] indices) or None, as decode_step_cache's
    group=None,  # the tp group; params and pages are this rank's shards
) -> Tuple[tuple, torch.Tensor]:
    """Batched multi-position pass: K/V and logits for S new tokens of every
    sequence at once (packed prefill, or the speculative scheduler's
    verification of [pending] + proposals), each attending its own cached
    prefix through the flash-prefill kernel with per-batch causal offsets.
    Returns (kv_cache, logits [B, S, vocab]); logits[b, i] is the next-token
    opinion after tokens[b, i]. Both cache layouts; pools updated in
    place."""
    c = config
    n_q, n_kv = _local_heads(c, group)
    b, s = tokens.shape
    page_size = kv_cache[0].shape[3]
    starts = start_positions.to(torch.int32)
    x = params["embed"][tokens.long()]  # [B, S, d]
    positions = starts.long()[:, None] + torch.arange(s, device=x.device)[None]  # [B, S]

    # Scatter targets of the new rows, (b, s) flattened. The table index is
    # clamped (an over-capacity row's own index would read past the table);
    # its page id is replaced by the trash page where the row exceeds the
    # sequence's allowance.
    page_idx = torch.clamp(positions // page_size, max=block_tables.shape[1] - 1)
    page_ids = torch.gather(block_tables.long(), 1, page_idx)
    if max_lens is not None:
        over = positions >= max_lens.long()[:, None]
        page_ids = torch.where(over, torch.full_like(page_ids, trash_page), page_ids)
    page_ids = page_ids.reshape(-1)  # [B*S]
    slots = (positions % page_size).reshape(-1)
    lora_layers = _gathered_lora(lora)

    for i in range(c.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], c.rms_eps)
        q_flat, v_flat = _qv_proj_with_lora(h, layer, _layer_lora(lora_layers, i))
        q = q_flat.reshape(b, s, n_q, c.head_dim)
        k = _k_proj(layer, h).reshape(b, s, n_kv, c.head_dim)
        v = v_flat.reshape(b, s, n_kv, c.head_dim)
        q = _rope(q, positions, c.rope_theta)
        k = _rope(k, positions, c.rope_theta)

        cache = _layer(kv_cache, i)
        _scatter_rows(
            cache, page_ids, slots,
            k.reshape(b * s, n_kv, c.head_dim).transpose(0, 1),
            v.reshape(b * s, n_kv, c.head_dim).transpose(0, 1),
        )
        # Each sequence attends its own pages from its own causal offset.
        k_all, v_all = _cache_gather_dense(cache, block_tables, c.dtype)
        attn = _serving_attention(q, k_all, v_all, starts, window=c.sliding_window)
        x = x + reduce_from_tp(attn.reshape(b, s, n_q * c.head_dim) @ layer["wo"], group)
        h = rms_norm(x, layer["mlp_norm"], c.rms_eps)
        x = x + reduce_from_tp(_mlp_dispatch(c, layer, h), group)

    x = rms_norm(x, params["final_norm"], c.rms_eps)
    return kv_cache, _logits(x, params["out"], group)  # [B, S, vocab]


def prefill(
    config: LlamaConfig,
    params: Params,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tokens: torch.Tensor,
    block_table: torch.Tensor,
    start_pos: int,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Model-dtype-cache convenience wrapper over prefill_cache: (k_pages,
    v_pages, logits)."""
    (k_pages, v_pages), logits = prefill_cache(
        config, params, (k_pages, v_pages), tokens, block_table, start_pos, group=group
    )
    return k_pages, v_pages, logits


def decode_step(
    config: LlamaConfig,
    params: Params,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tokens: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    pipelined: bool = True,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Model-dtype-cache convenience wrapper over decode_step_cache:
    (k_pages, v_pages, logits)."""
    (k_pages, v_pages), logits = decode_step_cache(
        config, params, (k_pages, v_pages), tokens, block_tables, seq_lens,
        pipelined=pipelined, group=group,
    )
    return k_pages, v_pages, logits
