"""The port's HF checkpoint bridge (models/hf_loader.py) against the JAX
package's loader and against transformers itself.

Tiny randomly initialized transformers models (no download), as
`tests/test_hf_loader.py` and `tests/test_qwen2.py` build them: the port's
params from one state dict equal the JAX loader's bit for bit at f32; the
port's logits are within 2e-4 of transformers' own forward for Llama (tied
and untied heads), GQA, Qwen2 with biases, Mistral with a window and
Mixtral; paged greedy generation through the port's Scheduler equals HF
`generate` for Llama and Mixtral; the loader's guards raise the JAX errors.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from llm_d_kv_cache_manager_tpu.models import hf_loader as jax_hf  # noqa: E402
from llm_d_kv_cache_manager_tpu_torch.engine.engine import (  # noqa: E402
    EnginePod,
    EnginePodConfig,
)
from llm_d_kv_cache_manager_tpu_torch.engine.scheduler import Scheduler  # noqa: E402
from llm_d_kv_cache_manager_tpu_torch.models import hf_loader, llama, mixtral  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
TOKENS = [3, 17, 99, 4, 250, 7, 7, 42, 120, 5, 61, 200]


def _llama(tie=False, n_q=4, n_kv=2, seed=0):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=n_q, num_key_value_heads=n_kv, max_position_embeddings=256,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=tie,
        attention_bias=False, mlp_bias=False,
    )
    torch.manual_seed(seed)
    return hf_cfg, transformers.LlamaForCausalLM(hf_cfg).eval()


def _qwen2():
    hf_cfg = transformers.Qwen2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=True,
    )
    torch.manual_seed(0)
    model = transformers.Qwen2ForCausalLM(hf_cfg).eval()
    # transformers zero-initializes the q/k/v biases; random ones make the
    # bias load-bearing.
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_proj.bias"):
                p.normal_(0, 0.5)
    return hf_cfg, model


def _mistral(window=8):
    hf_cfg = transformers.MistralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rope_theta=10000.0, rms_norm_eps=1e-5, sliding_window=window,
        attn_implementation="eager",
    )
    torch.manual_seed(5)
    return hf_cfg, transformers.MistralForCausalLM(hf_cfg).eval()


def _mixtral():
    hf_cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=256, rope_theta=10000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=False,
    )
    torch.manual_seed(1)
    return hf_cfg, transformers.MixtralForCausalLM(hf_cfg).eval()


MODELS = {
    "llama": _llama, "llama_tied": lambda: _llama(tie=True), "llama_gqa": lambda: _llama(n_q=8),
    "qwen2_bias": _qwen2, "mistral_window": _mistral, "mixtral": _mixtral,
}


def _load(name, hf_cfg, model):
    """(config, params) on the port and (config, params) on the JAX package,
    both at f32 from the same HF model."""
    if name == "mixtral":
        cfg = hf_loader.mixtral_config_from_hf(hf_cfg, dtype=torch.float32)
        jcfg = jax_hf.mixtral_config_from_hf(hf_cfg, dtype=jnp.float32)
        return ((cfg, hf_loader.mixtral_params_from_hf(model, cfg, "cpu")),
                (jcfg, jax_hf.mixtral_params_from_hf(model, jcfg)))
    cfg = hf_loader.config_from_hf(hf_cfg, dtype=torch.float32)
    jcfg = jax_hf.config_from_hf(hf_cfg, dtype=jnp.float32)
    return ((cfg, hf_loader.params_from_hf(model, cfg, "cpu")),
            (jcfg, jax_hf.params_from_hf(model, jcfg)))


def _forward(cfg, params, tokens):
    fwd = mixtral.forward_dense if llama.is_moe_config(cfg) else llama.forward_dense
    return fwd(cfg, params, torch.tensor([tokens], dtype=torch.int32))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_params_equal_the_jax_loaders(name):
    hf_cfg, model = MODELS[name]()
    (cfg, params), (jcfg, jparams) = _load(name, hf_cfg, model)
    port_fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__ if f != "dtype"}
    assert port_fields == {f: getattr(jcfg, f) for f in port_fields}
    assert params.keys() == jparams.keys()
    assert params["layers"].keys() == jparams["layers"].keys()
    for key in ("embed", "final_norm", "out"):
        np.testing.assert_array_equal(params[key].numpy(), np.asarray(jparams[key]))
    for key, value in jparams["layers"].items():
        got = params["layers"][key]
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(value))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_match_transformers(name):
    hf_cfg, model = MODELS[name]()
    (cfg, params), _ = _load(name, hf_cfg, model)
    tokens = TOKENS + list(range(20, 28)) if name == "mistral_window" else TOKENS
    with torch.no_grad():
        want = model(torch.tensor([tokens])).logits.numpy()
    got = _forward(cfg, params, tokens).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if name == "mistral_window":  # the window counts: full attention diverges
        import dataclasses

        full = _forward(dataclasses.replace(cfg, sliding_window=None), params, tokens).numpy()
        assert np.abs(full[0, 8:] - want[0, 8:]).max() > 1e-3


def test_bf16_load_casts_in_one_rounding():
    hf_cfg, model = _mixtral()
    cfg = hf_loader.mixtral_config_from_hf(hf_cfg)  # bf16, the default
    params = hf_loader.mixtral_params_from_hf(model, cfg, "cpu")
    sd = model.state_dict()
    w1 = sd["model.layers.1.block_sparse_moe.experts.3.w1.weight"]
    assert params["layers"]["w_gate"].dtype == torch.bfloat16
    assert torch.equal(params["layers"]["w_gate"][1, 3], w1.T.to(torch.bfloat16))
    assert torch.equal(params["layers"]["w_down"][0, 2],
                       sd["model.layers.0.block_sparse_moe.experts.2.w2.weight"].T.bfloat16())


@pytest.mark.parametrize("name, decode_steps", [("llama", 1), ("mixtral", 2)])
def test_paged_generation_matches_hf_greedy(name, decode_steps):
    """The port's serving stack (paged cache, scheduler, batched decode) on
    HF weights emits transformers' own greedy continuation."""
    hf_cfg, model = MODELS[name]()
    (cfg, params), _ = _load(name, hf_cfg, model)
    prompt, n_new = [3, 17, 99, 4, 250, 7], 8
    with torch.no_grad():
        want = model.generate(torch.tensor([prompt]), max_new_tokens=n_new, do_sample=False,
                              pad_token_id=0)[0, len(prompt):].tolist()
    pod = EnginePod(EnginePodConfig(n_pages=32, page_size=4, max_pages_per_seq=16,
                                    device="cpu", model_config=cfg), params=params)
    sched = Scheduler(pod, max_batch=2, decode_steps=decode_steps)
    rid = sched.submit(prompt, max_new_tokens=n_new)
    assert sched.run()[rid] == want


def test_o_proj_bias_is_refused():
    hf_cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=2, attention_bias=True,
    )
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    cfg = hf_loader.config_from_hf(hf_cfg, dtype=torch.float32)
    assert cfg.attn_bias
    with pytest.raises(NotImplementedError, match="o_proj.bias"):
        hf_loader.params_from_hf(model, cfg, "cpu")
    with pytest.raises(NotImplementedError, match="o_proj.bias"):
        jax_hf.params_from_hf(model, jax_hf.config_from_hf(hf_cfg, dtype=jnp.float32))


def test_biases_without_attn_bias_are_refused():
    hf_cfg, model = _qwen2()
    import dataclasses

    cfg = dataclasses.replace(hf_loader.config_from_hf(hf_cfg, dtype=torch.float32),
                              attn_bias=False)
    with pytest.raises(ValueError, match="refusing to drop them silently"):
        hf_loader.params_from_hf(model, cfg, "cpu")


@pytest.mark.parametrize("mwl, window", [(4, None), (0, 32), (2, "raises")])
def test_qwen2_max_window_layers(mwl, window):
    hf_cfg = transformers.Qwen2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, use_sliding_window=True,
        sliding_window=32, max_window_layers=mwl,
    )
    if window == "raises":
        for loader in (hf_loader, jax_hf):
            with pytest.raises(NotImplementedError, match="max_window_layers"):
                loader.config_from_hf(hf_cfg)
    else:
        assert hf_loader.config_from_hf(hf_cfg).sliding_window == window
        assert jax_hf.config_from_hf(hf_cfg).sliding_window == window


def test_load_hf_llama_reads_a_local_checkpoint(tmp_path):
    hf_cfg, model = _mixtral()
    model.save_pretrained(tmp_path)
    cfg, params = hf_loader.load_hf_llama(str(tmp_path), dtype=torch.float32, device="cpu")
    assert isinstance(cfg, mixtral.MixtralConfig) and cfg.n_experts == 4
    with torch.no_grad():
        want = model(torch.tensor([TOKENS])).logits.numpy()
    np.testing.assert_allclose(_forward(cfg, params, TOKENS).numpy(), want, **TOL)
