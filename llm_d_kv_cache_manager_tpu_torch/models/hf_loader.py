"""HuggingFace checkpoint bridge: transformers weights into the port's models.

Port of the reference package's `models/hf_loader.py`. A `transformers`
Llama, Mistral or Qwen2 checkpoint (config + state dict) maps onto
`models/llama.py`'s layer-stacked params, a Mixtral checkpoint onto
`models/mixtral.py`'s, so every serving path runs the real model. The
mapping is exact: the decoders are the same architecture (RMSNorm,
rotate-half RoPE, GQA, SwiGLU or top-k SwiGLU experts, tied or untied
head), and the tests hold the logits against transformers' own forward.

HF `nn.Linear.weight` is [out, in] and computes x @ W^T; the params store
[in, out] for x @ W, so every projection transposes. Layers stack on a
leading axis, experts on the next. Tensors stay torch from the state dict
to the params: transposed, stacked, cast to `config.dtype`, on the requested
device. `transformers` is imported only inside `load_hf_llama`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from llm_d_kv_cache_manager_tpu_torch.models.llama import LlamaConfig
from llm_d_kv_cache_manager_tpu_torch.utils.device import resolve_device


def config_from_hf(hf_config, dtype=torch.bfloat16) -> LlamaConfig:
    """Map a transformers Llama-family config (Llama/Mistral/Qwen2) onto
    LlamaConfig. Qwen2 is the same decoder with additive q/k/v biases: its
    config predates `attention_bias`, so the bias is implied by the
    model_type."""
    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads
    )
    attn_bias = bool(
        getattr(hf_config, "attention_bias", False)
        or getattr(hf_config, "model_type", "") == "qwen2"
    )
    # Mistral sets sliding_window unconditionally; Qwen2 gates it behind
    # use_sliding_window. Carry the effective value: every attention path
    # masks to it.
    window = getattr(hf_config, "sliding_window", None)
    if getattr(hf_config, "use_sliding_window", None) is False:
        window = None
    if window is not None and getattr(hf_config, "use_sliding_window", None):
        # Qwen2's max_window_layers serves the FIRST mwl layers with full
        # attention and only the rest with the window; the port's window is
        # uniform across layers. All-full maps to no window, all-sliding to
        # the uniform window; a mix would diverge from HF, so it is refused.
        mwl = getattr(hf_config, "max_window_layers", 0) or 0
        if mwl >= hf_config.num_hidden_layers:
            window = None
        elif mwl > 0:
            raise NotImplementedError(
                f"max_window_layers={mwl} mixes full- and sliding-window "
                "layers; per-layer windows are not implemented"
            )
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_q_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        head_dim=head_dim,
        d_ff=hf_config.intermediate_size,
        rope_theta=float(hf_config.rope_theta),
        rms_eps=float(hf_config.rms_norm_eps),
        dtype=dtype,
        attn_bias=attn_bias,
        sliding_window=window,
    )


def _params_from_sd(model_or_state_dict, config, mlp_keys, mlp_rows, device) -> Dict:
    """The HF -> params machinery both families share: attention and norm
    rows, the embedding, a tied or untied head, the final assembly.
    `mlp_rows(w, prefix, per_layer)` appends one layer's family-specific MLP
    entries (dense SwiGLU, or router + stacked experts)."""
    dev = resolve_device(device)
    sd = (
        model_or_state_dict
        if isinstance(model_or_state_dict, dict)
        else model_or_state_dict.state_dict()
    )

    def w(name: str, transpose: bool = True) -> torch.Tensor:
        t = sd[name].detach()
        return t.T if transpose else t

    def owned(t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy in the model dtype on `dev`, sharing no storage
        with the checkpoint."""
        out = torch.empty(t.shape, dtype=config.dtype, device=dev)
        return out.copy_(t)

    attn_bias = bool(getattr(config, "attn_bias", False))
    bias_keys = ("bq", "bk", "bv") if attn_bias else ()
    if attn_bias and "model.layers.0.self_attn.o_proj.bias" in sd:
        # Llama-architecture attention_bias=True checkpoints bias all FOUR
        # projections; the port applies q/k/v biases only (Qwen2's layout),
        # so loading one would drop the o bias.
        raise NotImplementedError(
            "checkpoint has self_attn.o_proj.bias; only q/k/v attention "
            "biases (Qwen2 layout) are supported"
        )
    if not attn_bias and "model.layers.0.self_attn.q_proj.bias" in sd:
        # Bias tensors present but the mapped config did not ask for them
        # (a custom export whose config lost attention_bias).
        raise ValueError(
            "checkpoint carries self_attn q/k/v biases but the mapped "
            "config has attn_bias=False; refusing to drop them silently"
        )
    per_layer = {k: [] for k in (
        "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
        *bias_keys, *mlp_keys,
    )}
    for i in range(config.n_layers):
        p = f"model.layers.{i}."
        per_layer["attn_norm"].append(w(p + "input_layernorm.weight", False))
        per_layer["wq"].append(w(p + "self_attn.q_proj.weight"))
        per_layer["wk"].append(w(p + "self_attn.k_proj.weight"))
        per_layer["wv"].append(w(p + "self_attn.v_proj.weight"))
        per_layer["wo"].append(w(p + "self_attn.o_proj.weight"))
        per_layer["mlp_norm"].append(w(p + "post_attention_layernorm.weight", False))
        if attn_bias:  # Qwen2-family q/k/v biases
            per_layer["bq"].append(w(p + "self_attn.q_proj.bias", False))
            per_layer["bk"].append(w(p + "self_attn.k_proj.bias", False))
            per_layer["bv"].append(w(p + "self_attn.v_proj.bias", False))
        mlp_rows(w, p, per_layer)

    embed = w("model.embed_tokens.weight", False)
    if "lm_head.weight" in sd:
        out = w("lm_head.weight")
    else:  # tie_word_embeddings checkpoints share the embedding matrix
        out = embed.T
    return {
        "embed": owned(embed),
        "layers": {k: owned(torch.stack(v)) for k, v in per_layer.items()},
        "final_norm": owned(w("model.norm.weight", False)),
        "out": owned(out),
    }


def params_from_hf(model_or_state_dict, config: LlamaConfig, device="cuda") -> Dict:
    """The layer-stacked params of an HF Llama-family model (or its state
    dict) on `device`. Raises KeyError with the missing weight's name if the
    checkpoint is not Llama-shaped."""

    def mlp_rows(w, p, per_layer):
        per_layer["w_gate"].append(w(p + "mlp.gate_proj.weight"))
        per_layer["w_up"].append(w(p + "mlp.up_proj.weight"))
        per_layer["w_down"].append(w(p + "mlp.down_proj.weight"))

    return _params_from_sd(
        model_or_state_dict, config, ("w_gate", "w_up", "w_down"), mlp_rows, device
    )


def mixtral_config_from_hf(hf_config, dtype=torch.bfloat16):
    """Map transformers.MixtralConfig onto MixtralConfig.

    Gating: HF's MixtralSparseMoeBlock softmaxes over ALL experts, takes
    top-k and renormalizes by the selected sum; `mixtral._moe_mlp` takes
    top-k of the raw logits and softmaxes those. The two are the same
    function (softmax is monotonic, and the renormalized selected values
    are exp(l_i) / sum_topk exp(l_j)); the tests pin it numerically."""
    from llm_d_kv_cache_manager_tpu_torch.models.mixtral import MixtralConfig

    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads
    )
    return MixtralConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_q_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        head_dim=head_dim,
        d_ff=hf_config.intermediate_size,
        n_experts=hf_config.num_local_experts,
        top_k=hf_config.num_experts_per_tok,
        rope_theta=float(hf_config.rope_theta),
        rms_eps=float(hf_config.rms_norm_eps),
        dtype=dtype,
        # Early Mixtral-8x7B configs carry sliding_window=4096.
        sliding_window=getattr(hf_config, "sliding_window", None),
    )


def mixtral_params_from_hf(model_or_state_dict, config, device="cuda") -> Dict:
    """The MoE params of an HF Mixtral model (or its state dict) on
    `device`. HF keeps experts as separate modules
    (block_sparse_moe.experts.{e}.w1/w3/w2); here they stack on a leading
    expert axis: w1 = gate, w3 = up, w2 = down (HF naming)."""

    def mlp_rows(w, p, per_layer):
        per_layer["router"].append(w(p + "block_sparse_moe.gate.weight"))
        moe = p + "block_sparse_moe.experts."
        for key, hf_name in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
            per_layer[key].append(torch.stack([
                w(f"{moe}{e}.{hf_name}.weight") for e in range(config.n_experts)
            ]))

    return _params_from_sd(
        model_or_state_dict, config,
        ("router", "w_gate", "w_up", "w_down"), mlp_rows, device,
    )


def load_hf_llama(
    model_name_or_path: str, dtype=torch.bfloat16, device="cuda"
) -> Tuple[object, Dict]:
    """(config, params) from a local checkpoint directory (never a
    download). Dispatches on the checkpoint's model_type: mixtral ->
    (MixtralConfig, params); llama / mistral / qwen2 -> (LlamaConfig,
    params)."""
    from transformers import AutoConfig, AutoModelForCausalLM

    hf_config = AutoConfig.from_pretrained(model_name_or_path, local_files_only=True)
    model = AutoModelForCausalLM.from_pretrained(model_name_or_path, local_files_only=True)
    try:
        if hf_config.model_type == "mixtral":
            config = mixtral_config_from_hf(hf_config, dtype=dtype)
            return config, mixtral_params_from_hf(model, config, device)
        # llama / mistral / qwen2 share the decoder; config_from_hf sets
        # attn_bias for qwen2 and params_from_hf picks up the bias rows.
        config = config_from_hf(hf_config, dtype=dtype)
        return config, params_from_hf(model, config, device)
    finally:
        del model
