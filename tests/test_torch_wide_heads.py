"""Pods with heads wider than 256 on the port against the JAX package's.

The port's CUDA kernels run a head dim above 256 in column slabs of 256,
the scores summed over panels of 256 columns (csrc/paged_decode_wide.cu,
csrc/flash_prefill.cu); their plain versions, which these CPU runs take,
hold every head dim. Two pods of two layers, 2 query heads over 1 kv head
of 300 (a bf16 row of 600 bytes, only 8-byte aligned on the card) and of
512 (chip_smoke.py phase 21's head), serve the same requests on both
packages (f32, device="cpu"), alone and through each package's Scheduler
at decode_steps 1 and 4, on model-dtype and int8 pages. d_model is 128, so
n_q x head_dim (600, 1,024) is not d_model and the carried weights take
their explicit head_dim (LlamaConfig.q_dim). The bars: the same greedy and
sampled tokens, cached-token counts and BlockStored / BlockRemoved streams,
exactly; prefill logits within atol 1e-4 on model-dtype pages
(tests/test_torch_engine.py's bar); on int8 pages within 2e-3, the bar of
tests/test_torch_openllama.py and for its reason: XLA's and torch's f32
projections differ in the last bit, and a row's int8 rounding that meets a
tie then lands one quantization step apart in one package only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import REQUESTS, _event_rows, _PodPair
from test_torch_qwen import _scheduled, _serve

from llm_d_kv_cache_manager_tpu.engine.scheduler import Scheduler as JaxScheduler
from llm_d_kv_cache_manager_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from llm_d_kv_cache_manager_tpu_torch.engine.scheduler import Scheduler
from llm_d_kv_cache_manager_tpu_torch.ops.sampling import SamplingParams

WIDE_HEADS = {
    "hd300": dict(d_model=128, n_q_heads=2, n_kv_heads=1, head_dim=300, d_ff=256),
    "hd512": dict(d_model=128, n_q_heads=2, n_kv_heads=1, head_dim=512, d_ff=256),
}
LOGITS_TOL = {False: dict(atol=1e-4, rtol=0), True: dict(atol=2e-3, rtol=0)}  # by int8


def _pair(heads, int8, n_pages=32):
    return _PodPair(n_pages, max_pages_per_seq=8, int8=int8, n_layers=2,
                    config=WIDE_HEADS[heads])


@pytest.mark.parametrize("n_pages", [32, 8], ids=["roomy_pool", "tight_pool"])
@pytest.mark.parametrize("int8", [False, True], ids=["model_dtype", "int8"])
@pytest.mark.parametrize("heads", sorted(WIDE_HEADS))
def test_wide_head_pod_matches_jax(heads, int8, n_pages):
    pair = _pair(heads, int8, n_pages)
    cfg = pair.port.config.model_config
    assert cfg.head_dim > 256 and cfg.q_dim != cfg.d_model
    assert pair.port.params["layers"]["wq"].shape[-1] == cfg.q_dim
    for prompt in REQUESTS:
        j_cached, j_tokens, j_logits = _serve(pair.jax, prompt, jnp.argmax)
        p_cached, p_tokens, p_logits = _serve(pair.port, prompt, torch.argmax)
        assert p_cached == j_cached and p_tokens == j_tokens
        np.testing.assert_allclose(p_logits, j_logits, **LOGITS_TOL[int8])
    assert _event_rows(pair.port_events) == _event_rows(pair.jax_events)
    removed = [row for row in _event_rows(pair.port_events) if row[0] == "BlockRemoved"]
    assert bool(removed) == (n_pages == 8)


@pytest.mark.parametrize("decode_steps", [1, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["model_dtype", "int8"])
@pytest.mark.parametrize("heads", sorted(WIDE_HEADS))
def test_wide_head_scheduler_matches_jax(heads, int8, decode_steps):
    pair = _pair(heads, int8, n_pages=16)
    want = _scheduled(pair.jax, JaxScheduler, JaxSamplingParams, decode_steps)
    got = _scheduled(pair.port, Scheduler, SamplingParams, decode_steps)
    assert got == want and all(len(t) == 7 for t in got)
    assert _event_rows(pair.port_events) == _event_rows(pair.jax_events)
