"""A Qwen2-shaped pod on the port against the JAX package's.

Qwen2 is the Llama decoder with additive q/k/v biases; its small checkpoints
tie the head to the embedding, and its GQA groups (7 for Qwen2.5-7B and
-0.5B) are no power of two. A pod of that shape (biases drawn from a seed,
since init_params makes them 0; the head the embedding's transpose; 14 query
heads over 2 kv heads; 2 layers) serves the same requests on both packages
(f32, device="cpu"), alone and through each package's Scheduler, on
model-dtype and int8 pages: the same greedy and sampled tokens, cached-token
counts and BlockStored / BlockRemoved streams, and prefill logits within
atol 1e-4 (tests/test_torch_engine.py's bar).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import REQUESTS, _event_rows, _PodPair

from llm_d_kv_cache_manager_tpu.engine.scheduler import Scheduler as JaxScheduler
from llm_d_kv_cache_manager_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from llm_d_kv_cache_manager_tpu_torch.engine.scheduler import Scheduler
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.ops.sampling import SamplingParams

QWEN = dict(n_q_heads=14, n_kv_heads=2, head_dim=16, attn_bias=True)
LOGITS_TOL = dict(atol=1e-4, rtol=0)


def _qwen_params(np_params):
    """Seeded q/k/v biases (beside projections of about 0.1 per element)
    and a tied head."""
    rng = np.random.default_rng(5)
    layers = dict(np_params["layers"])
    for key in ("bq", "bk", "bv"):
        layers[key] = rng.normal(0.0, 0.5, layers[key].shape).astype(np.float32)
    return {**np_params, "layers": layers,
            "out": np.ascontiguousarray(np_params["embed"].T)}


def _pair(int8, n_pages=32):
    return _PodPair(n_pages, max_pages_per_seq=8, int8=int8, n_layers=2, config=QWEN,
                    edit_params=_qwen_params)


def _serve(pod, prompt, argmax, n_decode=5):
    state, cached = pod.prefill(prompt)
    logits = np.asarray(pod.last_logits)
    first = int(argmax(pod.last_logits))
    pod.decode_append(state, first)
    tokens = [first] + [pod.decode_step(state) for _ in range(n_decode)]
    pod.free(state)
    return cached, tokens, logits


@pytest.mark.parametrize("n_pages", [32, 8], ids=["roomy_pool", "tight_pool"])
@pytest.mark.parametrize("int8", [False, True], ids=["model_dtype", "int8"])
def test_qwen_pod_matches_jax(int8, n_pages):
    pair = _pair(int8, n_pages)
    assert pair.port.config.model_config.n_q_heads // pair.port.config.model_config.n_kv_heads == 7
    for prompt in REQUESTS:
        j_cached, j_tokens, j_logits = _serve(pair.jax, prompt, jnp.argmax)
        p_cached, p_tokens, p_logits = _serve(pair.port, prompt, torch.argmax)
        assert p_cached == j_cached and p_tokens == j_tokens
        np.testing.assert_allclose(p_logits, j_logits, **LOGITS_TOL)
    assert _event_rows(pair.port_events) == _event_rows(pair.jax_events)
    removed = [row for row in _event_rows(pair.port_events) if row[0] == "BlockRemoved"]
    assert bool(removed) == (n_pages == 8)


def test_qwen_biases_and_tied_head_are_load_bearing():
    """The port's logits move when the biases are dropped, and its head is
    the embedding's transpose."""
    pair = _pair(False)
    params = pair.port.params
    assert torch.equal(params["out"], params["embed"].T)
    tokens = torch.tensor([REQUESTS[2]], dtype=torch.int32)
    cfg = pair.port.config.model_config
    with_bias = llama.forward_dense(cfg, params, tokens)
    no_bias = {**params, "layers": {k: (torch.zeros_like(w) if k in ("bq", "bk", "bv") else w)
                                    for k, w in params["layers"].items()}}
    assert float((with_bias - llama.forward_dense(cfg, no_bias, tokens)).abs().max()) > 1e-2
    # The dense truth's `first` keeps the logits of positions first.. only.
    np.testing.assert_array_equal(llama.forward_dense(cfg, params, tokens, first=9).numpy(),
                                  with_bias[:, 9:].numpy())


def _scheduled(pod, scheduler_cls, sampling_cls, decode_steps):
    """Phase 7b-style traffic in miniature: a shared two-page prefix, greedy
    and sampled requests submitted at once."""
    prompts = [list(range(8)) + [40, 41, 42], list(range(50, 63)),
               list(range(8)) + [90, 91], list(range(100, 107)), list(range(8))]
    samplings = [None, sampling_cls(0.8, 20, 0.9, seed=3), None,
                 sampling_cls(1.2, 0, 0.95, seed=4), None]
    sched = scheduler_cls(pod, max_batch=3, decode_steps=decode_steps)
    ids = [sched.submit(p, max_new_tokens=7, sampling=sp) for p, sp in zip(prompts, samplings)]
    results = sched.run()
    return [results[i] for i in ids]


@pytest.mark.parametrize("decode_steps", [1, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["model_dtype", "int8"])
def test_qwen_scheduler_matches_jax(int8, decode_steps):
    pair = _pair(int8, n_pages=16)
    want = _scheduled(pair.jax, JaxScheduler, JaxSamplingParams, decode_steps)
    got = _scheduled(pair.port, Scheduler, SamplingParams, decode_steps)
    assert got == want and all(len(t) == 7 for t in got)
    assert _event_rows(pair.port_events) == _event_rows(pair.jax_events)
