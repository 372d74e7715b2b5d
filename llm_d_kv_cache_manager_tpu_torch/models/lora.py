"""Multi-LoRA serving: adapter weights for the paged-cache llama path.

Port of the reference package's `models/lora.py`. The control plane scopes
KV blocks by adapter id (block hashes carry `lora_id`); this module applies
each sequence's adapter deltas in prefill and decode.

- Standard LoRA on the q and v projections: W_eff = W + B·A, with the
  alpha/rank scale folded into B, so serving adds two small products per
  projection and layer.
- Adapters are served from one layer-stacked registry (`stack_adapters`):
  index 0 is the all-zeros "no adapter", so a batch mixing base and adapter
  traffic is one gather and one batched product, with no per-sequence
  branch.
- Batched decode gathers each sequence's adapter rows ([n_layers, B, d, r])
  once per call, outside the layer loop.

The deltas are `torch.matmul`/`torch.bmm` in the model dtype, `(h @ A) @ B`
in the reference's order, so both packages round alike.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Sequence, Tuple

import torch

from llm_d_kv_cache_manager_tpu_torch.utils.device import resolve_device

if TYPE_CHECKING:
    from llm_d_kv_cache_manager_tpu_torch.models.llama import LlamaConfig

LoraParams = Dict[str, torch.Tensor]  # layer-stacked wq_a/wq_b/wv_a/wv_b


def init_lora_adapter(
    config: "LlamaConfig", rank: int, generator: torch.Generator, device="cuda"
) -> LoraParams:
    """One adapter: per-layer A (normal(0.02) init) and B (zeros, so a fresh
    adapter is an exact no-op) for wq and wv. `generator` must live on
    `device`."""
    c = config
    dev = resolve_device(device)

    def normal(*shape):
        t = torch.empty(shape, dtype=c.dtype, device=dev)
        return t.normal_(0.0, 0.02, generator=generator)

    wq_a = normal(c.n_layers, c.d_model, rank)
    wv_a = normal(c.n_layers, c.d_model, rank)
    return {
        "wq_a": wq_a,
        "wq_b": torch.zeros((c.n_layers, rank, c.q_dim), dtype=c.dtype, device=dev),
        "wv_a": wv_a,
        "wv_b": torch.zeros((c.n_layers, rank, c.kv_dim), dtype=c.dtype, device=dev),
    }


def make_test_adapter(
    config: "LlamaConfig", rank: int, generator: torch.Generator,
    alpha: float = 16.0, device="cuda",
) -> LoraParams:
    """A non-trivial adapter (random B scaled by alpha/rank) for tests."""
    adapter = init_lora_adapter(config, rank, generator, device)
    scale = alpha / rank
    for name in ("wq_b", "wv_b"):
        b = torch.empty_like(adapter[name]).normal_(0.0, 0.02, generator=generator)
        adapter[name] = b * scale
    return adapter


def stack_adapters(adapters: Sequence[LoraParams]) -> LoraParams:
    """Registry: [n_adapters+1, n_layers, ...] with index 0 the zero
    adapter (base-model traffic)."""
    if not adapters:
        raise ValueError("stack_adapters needs at least one adapter")
    return {
        name: torch.stack([torch.zeros_like(adapters[0][name])] + [a[name] for a in adapters])
        for name in adapters[0]
    }


def select_adapter(stack: LoraParams, index: int) -> LoraParams:
    """Single-sequence selection (prefill): per-layer arrays of one adapter."""
    return {k: v[index] for k, v in stack.items()}


def gather_adapters(stack: LoraParams, adapter_indices: torch.Tensor) -> LoraParams:
    """Batched decode selection: per-sequence adapter rows, layers leading,
    {name: [n_layers, B, ...]}; `adapter_indices` [B] on the stack's device
    (a device gather, no read back)."""
    idx = adapter_indices.long()
    return {k: v[idx].movedim(0, 1) for k, v in stack.items()}


def merge_adapter(params, adapter: LoraParams) -> dict:
    """W + B·A as dense weights (single-adapter serving, equivalence checks):
    the product in f32, then cast to the weights' dtype. Returns a new
    params tree sharing every other tensor."""
    layers = dict(params["layers"])
    for w, a, b in (("wq", "wq_a", "wq_b"), ("wv", "wv_a", "wv_b")):
        base = params["layers"][w]
        delta = torch.einsum("ldr,lro->ldo", adapter[a].float(), adapter[b].float())
        layers[w] = base + delta.to(base.dtype)
    out = dict(params)
    out["layers"] = layers
    return out


def apply_prefill_delta(h: torch.Tensor, lo: LoraParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-sequence deltas: h [1, L, d]; lo arrays [d, r] / [r, out]."""
    dq = (h @ lo["wq_a"]) @ lo["wq_b"]
    dv = (h @ lo["wv_a"]) @ lo["wv_b"]
    return dq, dv


def apply_decode_delta(h: torch.Tensor, lo: LoraParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sequence deltas: h [B, S, d]; lo arrays [B, d, r] / [B, r, out]."""
    dq = torch.bmm(torch.bmm(h, lo["wq_a"]), lo["wq_b"])
    dv = torch.bmm(torch.bmm(h, lo["wv_a"]), lo["wv_b"])
    return dq, dv


def lora_from_jax(np_adapter, device="cuda") -> LoraParams:
    """Carry a reference-package adapter (leaves as numpy arrays, or anything
    `np.asarray` takes) across as torch tensors, layout unchanged, as
    `llama.params_from_jax` does for a parameter tree."""
    from llm_d_kv_cache_manager_tpu_torch.models.llama import params_from_jax

    return params_from_jax(dict(np_adapter), device)
