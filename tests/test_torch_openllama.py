"""An OpenLLaMA-shaped pod on the port against the JAX package's.

OpenLLaMA-3B (openlm-research/open_llama_3b_v2) is a Llama decoder of 32
heads of 100 over 32 kv heads: a head dim that is no multiple of 16, which
the port's CUDA kernels run at the padded width 128 over unpadded pages. A
pod of that head shape (4 heads of 100, d_model 400; 2 layers) serves the
same requests on both packages (f32, device="cpu"), alone and through each
package's Scheduler at decode_steps 1 and 4, on model-dtype and int8 pages:
the same greedy and sampled tokens, cached-token counts and BlockStored /
BlockRemoved streams, and prefill logits within atol 1e-4 on model-dtype
pages (tests/test_torch_engine.py's bar). On int8 pages the bar is 2e-3:
XLA's and torch's f32 projections differ in the last bit, and at this width
a row's int8 rounding meets a tie now and then, where one ulp becomes a
whole quantization step in one package only (request 4 here: one V element
of 4,400 one step apart, 3.0e-4 on the logits after one layer, 1.4e-3
after two); the tokens and the event streams stay exact.
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

OPENLLAMA = dict(d_model=400, n_q_heads=4, n_kv_heads=4, head_dim=100, d_ff=256)
LOGITS_TOL = {False: dict(atol=1e-4, rtol=0), True: dict(atol=2e-3, rtol=0)}  # by int8


def _pair(int8, n_pages=32):
    return _PodPair(n_pages, max_pages_per_seq=8, int8=int8, n_layers=2, config=OPENLLAMA)


@pytest.mark.parametrize("n_pages", [32, 8], ids=["roomy_pool", "tight_pool"])
@pytest.mark.parametrize("int8", [False, True], ids=["model_dtype", "int8"])
def test_openllama_pod_matches_jax(int8, n_pages):
    pair = _pair(int8, n_pages)
    cfg = pair.port.config.model_config
    assert (cfg.head_dim, cfg.n_q_heads // cfg.n_kv_heads) == (100, 1)
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
def test_openllama_scheduler_matches_jax(int8, decode_steps):
    pair = _pair(int8, n_pages=16)
    want = _scheduled(pair.jax, JaxScheduler, JaxSamplingParams, decode_steps)
    got = _scheduled(pair.port, Scheduler, SamplingParams, decode_steps)
    assert got == want and all(len(t) == 7 for t in got)
    assert _event_rows(pair.port_events) == _event_rows(pair.jax_events)
