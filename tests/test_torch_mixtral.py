"""The port's MoE family (models/mixtral.py) against the JAX package's.

The same inputs, drawn from numpy seeds, go through both packages at f32:
the dense dispatch within 1e-5 (ties among router logits included, picked in
`jax.lax.top_k`'s order), the static-capacity dispatch equal to JAX's, both
families' dense forwards within 1e-4, and the paged entry points on a MoE
model (prefill with every position's logits, batched decode pipelined and
tiled, multi-step decode, verify) within 1e-4 on model-dtype and int8 pages.
Every MoE serving test of `tests/test_mixtral.py` (bar the tensor-parallel
one, which waits for `parallel/serving.py`) runs as a scenario on a JAX pod
and a port pod built from one parameter tree: the same tokens and the same
BlockStored / BlockRemoved streams. The pod's family check and the cost
model's MoE branch are held against JAX's too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import _event_rows
from test_torch_llama import _assert_pools_match, _both_caches, _int8_pools, _pools

from llm_d_kv_cache_manager_tpu.engine import costs as jax_costs
from llm_d_kv_cache_manager_tpu.engine.engine import (
    EnginePod as JaxEnginePod,
    EnginePodConfig as JaxEnginePodConfig,
)
from llm_d_kv_cache_manager_tpu.engine.scheduler import Scheduler as JaxScheduler
from llm_d_kv_cache_manager_tpu.engine.speculative import (
    SpeculativeScheduler as JaxSpeculativeScheduler,
)
from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu.models import mixtral as jax_mixtral
from llm_d_kv_cache_manager_tpu_torch.engine import costs
from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig
from llm_d_kv_cache_manager_tpu_torch.engine.scheduler import Scheduler
from llm_d_kv_cache_manager_tpu_torch.engine.speculative import SpeculativeScheduler
from llm_d_kv_cache_manager_tpu_torch.models import llama, mixtral

PAGE = 4
LOGITS_TOL = dict(atol=1e-4, rtol=0)
# tests/test_mixtral.py's model-math config (CFG) and its serving config.
MATH = dict(vocab_size=128, d_model=32, n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=64, n_experts=4, top_k=2)
SERVING = dict(MATH, head_dim=8)
DRAFT = dict(vocab_size=128, d_model=16, n_layers=1, n_q_heads=2, n_kv_heads=2, head_dim=8,
             d_ff=32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(shape=MATH, **overrides):
    fields = {**shape, **overrides}
    return (jax_mixtral.MixtralConfig(**fields, dtype=jnp.float32),
            mixtral.MixtralConfig(**fields, dtype=torch.float32))


def _params(jcfg, seed=0):
    np_params = _np(jax_mixtral.init_params(jcfg, jax.random.PRNGKey(seed)))
    return np_params, llama.params_from_jax(np_params, device="cpu")


def _layer(np_params, i=0):
    """Layer i of a numpy parameter tree as torch tensors."""
    return {k: torch.from_numpy(np.array(v[i])) for k, v in np_params["layers"].items()}


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


# -- parameters and the dispatch ---------------------------------------------------


def test_params_from_jax_carries_moe_tree():
    jcfg, _ = _configs()
    np_params, params = _params(jcfg)
    c = jcfg
    layers = params["layers"]
    assert layers["router"].shape == (c.n_layers, c.d_model, c.n_experts)
    assert layers["w_gate"].shape == (c.n_layers, c.n_experts, c.d_model, c.d_ff)
    assert layers["w_up"].shape == (c.n_layers, c.n_experts, c.d_model, c.d_ff)
    assert layers["w_down"].shape == (c.n_layers, c.n_experts, c.d_ff, c.d_model)
    for name, value in np_params["layers"].items():
        np.testing.assert_array_equal(layers[name].numpy(), value)
    for name in ("embed", "final_norm", "out"):
        np.testing.assert_array_equal(params[name].numpy(), np_params[name])


def test_init_params_shapes_and_seed():
    _, cfg = _configs()
    a = mixtral.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = mixtral.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert a["layers"]["w_down"].shape == (2, 4, 64, 32)
    assert a["layers"]["router"].shape == (2, 32, 4)
    for name, w in a["layers"].items():
        assert torch.equal(w, b["layers"][name])
    assert float(a["layers"]["w_gate"].std()) == pytest.approx(0.02, rel=0.1)


# Router logits with ties: an all-zero row, a tie at the top, ties across the
# k boundary, and ties everywhere but one entry.
TIE_LOGITS = np.array([[0, 0, 0, 0], [1, 3, 3, 0], [3, 1, 3, 3], [2, 2, 1, 2],
                       [-1, -1, -1, 5]], np.float32)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_tie_order_matches_jax(k):
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(TIE_LOGITS), k)
    vals, idx = mixtral.top_k(torch.from_numpy(TIE_LOGITS), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


def _moe_inputs(case, jcfg, np_params):
    """x [2, 6, d] and a layer: random, or a layer whose router gives every
    token tied logits (zero rows, and duplicated router columns)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    layer = {k: np.array(v[0]) for k, v in np_params["layers"].items()}
    if case == "ties":
        x[0, :3] = 0.0  # zero rows: all router logits equal
        router = layer["router"]
        router[:, 2] = router[:, 1]  # experts 1 and 2 always tie
        router[:, 3] = router[:, 0]  # and 0 and 3
    return x, layer


@pytest.mark.parametrize("case", ["random", "ties"])
def test_moe_mlp_matches_jax(case):
    jcfg, cfg = _configs()
    np_params, _ = _params(jcfg)
    x, layer = _moe_inputs(case, jcfg, np_params)
    want = jax_mixtral._moe_mlp(jcfg, {k: jnp.asarray(v) for k, v in layer.items()},
                                jnp.asarray(x))
    got = mixtral._moe_mlp(cfg, {k: torch.from_numpy(v) for k, v in layer.items()},
                           torch.from_numpy(x))
    _close(got, want)
    if case == "ties":  # the tied picks changed the output (ties matter)
        swapped = dict(layer, w_down=layer["w_down"][[3, 2, 1, 0]])
        other = mixtral._moe_mlp(cfg, {k: torch.from_numpy(v) for k, v in swapped.items()},
                                 torch.from_numpy(x))
        assert np.abs(other.numpy() - np.asarray(want)).max() > 1e-3


@pytest.mark.parametrize("factor", [0.25, 1.0, 1.25, 16.0])
def test_moe_mlp_capacity_matches_jax(factor):
    jcfg, cfg = _configs(capacity_factor=factor)
    np_params, _ = _params(jcfg)
    for case in ("random", "ties"):
        x, layer = _moe_inputs(case, jcfg, np_params)
        want = jax_mixtral._moe_mlp_capacity(
            jcfg, {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x))
        got = mixtral._moe_mlp_capacity(
            cfg, {k: torch.from_numpy(v) for k, v in layer.items()}, torch.from_numpy(x))
        _close(got, want)


def test_ample_capacity_matches_dense_dispatch():
    jcfg, cfg_dense = _configs()
    cfg_cap = dataclasses.replace(cfg_dense, capacity_factor=float(cfg_dense.n_experts * 4))
    _, params = _params(jcfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 8)))
    dense = mixtral.forward_dense(cfg_dense, params, tokens)
    cap = mixtral.forward_dense(cfg_cap, params, tokens)
    _close(cap, dense)


def test_tight_capacity_actually_drops():
    jcfg, cfg = _configs()
    tight = dataclasses.replace(cfg, capacity_factor=0.25)
    ample = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts * 4))
    _, params = _params(jcfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 16)))
    out_tight = mixtral.forward_dense(tight, params, tokens).numpy()
    out_ample = mixtral.forward_dense(ample, params, tokens).numpy()
    assert np.isfinite(out_tight).all()
    assert not np.allclose(out_tight, out_ample, atol=1e-3)


def test_dense_dispatch_is_per_token():
    """Pad rows (a packed prefill's, a bucket's) leave a real row's output
    as it is: each token's mixture reads its own row only."""
    jcfg, cfg = _configs()
    np_params, _ = _params(jcfg)
    layer = _layer(np_params)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 5, 32)).astype(np.float32))
    padded = torch.cat([x, torch.zeros(1, 3, 32), 7 * torch.ones(1, 2, 32)], dim=1)
    alone = mixtral._moe_mlp(cfg, layer, x)
    _close(mixtral._moe_mlp(cfg, layer, padded)[:, :5], alone, atol=1e-6)
    _close(mixtral._moe_mlp(cfg, layer, padded.reshape(2, 5, 32))[:1], alone, atol=1e-6)


def test_gating_matches_manual_topk():
    """tests/test_mixtral.py::TestMoE::test_gating_matches_manual_topk on the
    port: a per-token numpy mixture of the top-k experts."""
    jcfg, cfg = _configs()
    np_params, _ = _params(jcfg)
    layer = _layer(np_params)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 6, 32)).astype(np.float32))
    out = mixtral._moe_mlp(cfg, layer, x).numpy()
    lay = {k: v.numpy().astype(np.float64) for k, v in layer.items()}
    xs = x.numpy().astype(np.float64)
    logits = xs @ lay["router"]
    expected = np.zeros_like(out)
    for b in range(2):
        for t in range(6):
            top = np.argsort(-logits[b, t], kind="stable")[: cfg.top_k]
            gates = np.exp(logits[b, t, top] - logits[b, t, top].max())
            gates /= gates.sum()
            for g, e in zip(gates, top):
                h = xs[b, t] @ lay["w_gate"][e]
                hidden = h / (1 + np.exp(-h)) * (xs[b, t] @ lay["w_up"][e])
                expected[b, t] += g * (hidden @ lay["w_down"][e])
    _close(out, expected, atol=1e-5)


# -- the dense forwards ------------------------------------------------------------


def test_mixtral_forward_dense_matches_jax():
    jcfg, cfg = _configs(sliding_window=5)
    np_params, params = _params(jcfg)
    tokens = np.random.default_rng(2).integers(0, 128, (2, 10)).astype(np.int32)
    want = jax_mixtral.forward_dense(jcfg, np_params, jnp.asarray(tokens))
    got = mixtral.forward_dense(cfg, params, torch.from_numpy(tokens))
    assert got.shape == (2, 10, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)


@pytest.mark.parametrize("variant", [{}, {"attn_bias": True, "sliding_window": 4}])
def test_llama_forward_dense_matches_jax(variant):
    shape = {k: v for k, v in MATH.items() if k not in ("n_experts", "top_k")}
    jcfg = jax_llama.LlamaConfig(**shape, **variant, dtype=jnp.float32)
    cfg = llama.LlamaConfig(**shape, **variant, dtype=torch.float32)
    np_params = _np(jax_llama.init_params(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(3)
    if jcfg.attn_bias:  # zeros at init: draw real ones so the bias counts
        for name in ("bq", "bk", "bv"):
            np_params["layers"][name] = rng.standard_normal(
                np_params["layers"][name].shape).astype(np.float32)
    tokens = rng.integers(0, 128, (2, 9)).astype(np.int32)
    want = jax_llama.forward_dense(jcfg, np_params, jnp.asarray(tokens))
    got = llama.forward_dense(cfg, llama.params_from_jax(np_params, "cpu"),
                              torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)


# -- the paged entry points on a MoE model -----------------------------------------


def _caches(jcfg, layout, n_pages, seed=3):
    pools = _int8_pools(jcfg, n_pages, seed) if layout == "int8" else _pools(jcfg, n_pages, seed)
    return pools, _both_caches(pools)


@pytest.mark.parametrize("layout", ["model_dtype", "int8"])
def test_moe_prefill_cache_matches_jax(layout):
    """A prefix, then a chunk padded to 8 after it, every position's logits
    and the last valid one's."""
    jcfg, cfg = _configs()
    np_params, params = _params(jcfg, seed=1)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 128, 13).astype(np.int32)
    table = rng.permutation(8).astype(np.int32)
    _, (jcache, pcache) = _caches(jcfg, layout, 8)
    jcache, want = jax_llama.prefill_cache(jcfg, np_params, jcache, jnp.asarray(tokens[:7]),
                                           jnp.asarray(table), 0, all_logits=True)
    pcache, got = llama.prefill_cache(cfg, params, pcache, torch.from_numpy(tokens[:7]),
                                      torch.from_numpy(table), 0, all_logits=True)
    assert got.shape == (7, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    chunk = np.concatenate([tokens[7:], np.zeros(2, np.int32)])
    jcache, want = jax_llama.prefill_cache(jcfg, np_params, jcache, jnp.asarray(chunk),
                                           jnp.asarray(table), 7, n_valid=jnp.asarray(6))
    pcache, got = llama.prefill_cache(cfg, params, pcache, torch.from_numpy(chunk),
                                      torch.from_numpy(table), 7, n_valid=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    _assert_pools_match(pcache, jcache)


@pytest.mark.parametrize("layout", ["model_dtype", "int8"])
@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "tiled"])
def test_moe_decode_step_cache_matches_jax(layout, pipelined):
    jcfg, cfg = _configs(sliding_window=6)
    np_params, params = _params(jcfg, seed=2)
    rng = np.random.default_rng(7)
    batch, pps = 3, 4
    n_pages = batch * pps + 1
    _, (jcache, pcache) = _caches(jcfg, layout, n_pages, seed=8)
    tables = rng.permutation(n_pages)[: batch * pps].reshape(batch, pps).astype(np.int32)
    seq_lens = np.array([3, 9, 14], np.int32)
    tokens = rng.integers(0, 128, batch).astype(np.int32)
    jcache, want = jax_llama.decode_step_cache(
        jcfg, np_params, jcache, jnp.asarray(tokens), jnp.asarray(tables),
        jnp.asarray(seq_lens), pipelined=pipelined)
    pcache, got = llama.decode_step_cache(
        cfg, params, pcache, torch.from_numpy(tokens), torch.from_numpy(tables),
        torch.from_numpy(seq_lens), pipelined=pipelined)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    _assert_pools_match(pcache, jcache)


@pytest.mark.parametrize("layout", ["model_dtype", "int8"])
def test_moe_decode_multi_step_cache_matches_jax(layout):
    """Two sequences, one of whose budget ends mid-window (its rows go to
    the trash page): the same greedy tokens."""
    jcfg, cfg = _configs()
    np_params, params = _params(jcfg, seed=6)
    trash = 8
    _, (jcache, pcache) = _caches(jcfg, layout, trash + 1, seed=4)
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    tokens = np.array([5, 77], np.int32)
    lens = np.array([6, 3], np.int32)
    max_lens = np.array([16, 5], np.int32)
    _, want = jax_llama.decode_multi_step_cache(
        jcfg, np_params, jcache, jnp.asarray(tokens), jnp.asarray(tables), jnp.asarray(lens),
        jnp.asarray(max_lens), trash, 5)
    _, got = llama.decode_multi_step_cache(
        cfg, params, pcache, torch.from_numpy(tokens), torch.from_numpy(tables),
        torch.from_numpy(lens), torch.from_numpy(max_lens), trash, 5)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("layout", ["model_dtype", "int8"])
def test_moe_verify_step_cache_matches_jax(layout):
    jcfg, cfg = _configs()
    np_params, params = _params(jcfg, seed=4)
    rng = np.random.default_rng(11)
    b, s, pps = 3, 5, 4
    trash = b * pps
    _, (jcache, pcache) = _caches(jcfg, layout, trash + 1)
    tables = np.arange(b * pps, dtype=np.int32).reshape(b, pps)
    tokens = rng.integers(0, 128, (b, s)).astype(np.int32)
    starts = np.array([8, 5, 10], np.int32)
    max_lens = np.array([13, 8, 11], np.int32)
    jcache, want = jax_llama.verify_step_cache(
        jcfg, np_params, jcache, jnp.asarray(tokens), jnp.asarray(tables),
        jnp.asarray(starts), jnp.asarray(max_lens), trash_page=trash)
    pcache, got = llama.verify_step_cache(
        cfg, params, pcache, torch.from_numpy(tokens), torch.from_numpy(tables),
        torch.from_numpy(starts), torch.from_numpy(max_lens), trash_page=trash)
    assert got.shape == (b, s, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    _assert_pools_match(pcache, jcache, skip_page=trash)


# -- TestMoEServing on both packages -------------------------------------------------

_SERVING = {}


def _serving_models():
    """tests/test_mixtral.py::TestMoEServing's target (seed 0) and dense
    draft (seed 9), in both packages."""
    if not _SERVING:
        jcfg, cfg = _configs(SERVING)
        np_params, params = _params(jcfg)
        jdraft = jax_llama.LlamaConfig(**DRAFT, dtype=jnp.float32)
        np_draft = _np(jax_llama.init_params(jdraft, jax.random.PRNGKey(9)))
        _SERVING.update(
            jax=(jcfg, np_params, jdraft, np_draft),
            port=(cfg, params, llama.LlamaConfig(**DRAFT, dtype=torch.float32),
                  llama.params_from_jax(np_draft, "cpu")))
    return _SERVING


class _MoESide:
    """One package's view of a MoE serving scenario; every pod's event
    batches are kept, in creation order."""

    def __init__(self, name, int8):
        self.name, self.int8 = name, int8
        self.cfg, self.params, self.draft_cfg, self.draft_params = _serving_models()[name]
        self.jax = name == "jax"
        self.Scheduler = JaxScheduler if self.jax else Scheduler
        self.SpeculativeScheduler = JaxSpeculativeScheduler if self.jax else SpeculativeScheduler
        self.events = []

    def pod(self, cfg=None, n_pages=32):
        events = []
        self.events.append(events)
        cfg = self.cfg if cfg is None else cfg
        if self.jax:
            return JaxEnginePod(
                JaxEnginePodConfig(n_pages=n_pages, page_size=PAGE, with_model=True,
                                   model_config=cfg, max_pages_per_seq=16, device_tier="gpu",
                                   use_quantized_kv=self.int8),
                event_sink=events.append, params=self.params)
        return EnginePod(
            EnginePodConfig(n_pages=n_pages, page_size=PAGE, max_pages_per_seq=16,
                            device_tier="gpu", device="cpu", model_config=cfg,
                            use_quantized_kv=self.int8),
            event_sink=events.append, params=self.params)

    def argmax(self, logits):
        return int(jnp.argmax(logits)) if self.jax else int(torch.argmax(logits))

    def dense_argmax(self, tokens):
        """The oracle: argmax of mixtral.forward_dense at every position of
        one sequence. The forward is causal, so a greedy chain equals its
        own teacher-forced argmaxes."""
        if self.jax:
            logits = jax_mixtral.forward_dense(self.cfg, self.params,
                                               jnp.asarray([tokens], jnp.int32))
            return np.asarray(jnp.argmax(logits[0], axis=-1)).tolist()
        logits = mixtral.forward_dense(self.cfg, self.params,
                                       torch.tensor([tokens], dtype=torch.int32))
        return torch.argmax(logits[0], dim=-1).tolist()

    def isolated(self, prompt, n_new, cfg=None):
        pod = self.pod(cfg)
        state, _ = pod.prefill(list(prompt))
        out = [self.argmax(pod.last_logits)]
        pod.decode_append(state, out[0])
        while len(out) < n_new:
            out.append(pod.decode_step(state))
        pod.free(state)
        return out


def paged_generation_matches_dense_forward(side):
    prompt = list(range(9))
    out = side.isolated(prompt, 6)
    if not side.int8:  # the dense oracle reads no cache, so no int8 rounding
        assert side.dense_argmax(prompt + out[:-1])[len(prompt) - 1:] == out
    return out


def scheduler_batch_matches_isolated(side):
    prompts = [list(range(5)), list(range(20, 31)), list(range(40, 47))]
    expected = [side.isolated(p, 5) for p in prompts]
    sched = side.Scheduler(side.pod(n_pages=64), max_batch=4, decode_steps=2)
    ids = [sched.submit(p, max_new_tokens=5) for p in prompts]
    results = sched.run()
    assert [results[i] for i in ids] == expected
    return expected


def serving_is_dropless_even_with_tight_capacity(side):
    prompt = list(range(8))
    tight = side.isolated(prompt, 5, cfg=dataclasses.replace(side.cfg, capacity_factor=1.0))
    assert tight == side.isolated(prompt, 5)
    return tight


def speculative_scheduling_on_moe_pod(side):
    prompts = [list(range(5)), list(range(20, 28))]
    plain = side.Scheduler(side.pod(n_pages=64), max_batch=4)
    pids = [plain.submit(p, max_new_tokens=6) for p in prompts]
    pres = plain.run()
    spec = side.SpeculativeScheduler(side.pod(n_pages=64), side.draft_cfg, side.draft_params,
                                     k=3, max_batch=4)
    sids = [spec.submit(p, max_new_tokens=6) for p in prompts]
    sres = spec.run()
    out = [pres[i] for i in pids]
    assert [sres[i] for i in sids] == out
    return out, dataclasses.astuple(spec.stats)


@pytest.mark.parametrize("int8", [False, True], ids=["model_dtype", "int8"])
@pytest.mark.parametrize("scenario", [
    paged_generation_matches_dense_forward, scheduler_batch_matches_isolated,
    serving_is_dropless_even_with_tight_capacity, speculative_scheduling_on_moe_pod,
], ids=lambda f: f.__name__)
def test_moe_serving_matches_jax(scenario, int8):
    sides = {name: _MoESide(name, int8) for name in ("jax", "port")}
    results = {name: scenario(side) for name, side in sides.items()}
    assert results["port"] == results["jax"]
    port_events = [_event_rows(e) for e in sides["port"].events]
    assert port_events == [_event_rows(e) for e in sides["jax"].events]
    assert any(port_events)


# -- the pod and the cost model ----------------------------------------------------


def test_pod_builds_moe_params_and_rejects_family_mismatch():
    _, cfg = _configs(SERVING)
    dense_cfg = llama.LlamaConfig(**DRAFT, dtype=torch.float32)
    pod = EnginePod(EnginePodConfig(n_pages=8, page_size=PAGE, device="cpu", model_config=cfg))
    assert pod.params["layers"]["router"].shape == (2, 32, 4)
    assert pod.params["layers"]["w_gate"].shape == (2, 4, 32, 64)
    dense_params = llama.init_params(dense_cfg, torch.Generator(), "cpu")
    for model_config, params in ((cfg, dense_params), (dense_cfg, pod.params)):
        with pytest.raises(ValueError, match="does not match params structure"):
            EnginePod(EnginePodConfig(n_pages=8, page_size=PAGE, device="cpu",
                                      model_config=model_config), params=params)


RATES = dict(staged_bytes_per_s=2e8, peer_bytes_per_s=3e8, insert_bytes_per_s=4e9,
             compute_flops_per_s=1e14, source="test rates")


@pytest.mark.parametrize("quantized", [False, True])
def test_cost_model_matches_jax_on_moe(quantized):
    # bf16, the default of both packages (the JAX package prices 2-byte KV
    # rows whatever the dtype; the port prices the model dtype).
    shape = dict(SERVING, d_model=64, d_ff=128, n_experts=8)
    jcfg, cfg = jax_mixtral.MixtralConfig(**shape), mixtral.MixtralConfig(**shape)
    assert costs.flops_per_token(cfg) == jax_costs.flops_per_token(jcfg)
    # top_k of 8 experts plus the router, not one expert and not all eight.
    dense = dataclasses.replace(cfg, n_experts=None)
    assert costs.flops_per_token(cfg) - costs.flops_per_token(dense) == 2.0 * 2 * (
        3 * 64 * 128 + 64 * 8)
    want = jax_costs.TransferCostModel.for_model(jcfg, quantized, rates=RATES)
    got = costs.TransferCostModel.for_model(cfg, quantized, rates=RATES)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
