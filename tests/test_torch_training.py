"""The port's training path and bf16-cache wrappers against the JAX package's.

At f32, on the same numpy weights:

- `loss_fn` and every parameter's gradient, for both families, against
  `jax.value_and_grad` of the JAX `loss_fn` (loss rtol 1e-5, gradients
  atol 1e-5);
- `train_step`'s new params against the JAX `train_step`'s (atol 1e-7: one
  SGD step at lr 1e-3 moves a weight by 1e-3 x its gradient), and the loss
  falling over 5 steps (tests/test_model.py:91-99, tests/test_mixtral.py);
- a dp 2 x tp 2 llama train step and an ep 2 x tp 2 Mixtral train step in
  four spawned gloo processes (tests/torch_parallel_workers.py): the loss
  equals the JAX `loss_fn` on the host params within rtol 1e-5
  (tests/test_model.py:101-124, tests/test_mixtral.py's expert-parallel
  step), and each rank's shard of the new params equals the matching slice
  of the JAX single-device step's (atol 1e-7);
- in the same four processes, the Mixtral step on the capacity dispatch
  (8 experts, factors 1.25 and 0.5) at ep 2 x tp 2 and at dp 2 x ep 2 with
  the batch split over dp, held the same way to the JAX single-device
  `train_step` on that factor; the 0.5 factor drops pairs, and slotting
  each dp shard alone would keep a different set;
- `prefill` and `decode_step` against the JAX wrappers (atol 1e-5) and the
  dense forward (atol 1e-4, tests/test_model.py:42-88's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu.models import mixtral as jax_mixtral
from llm_d_kv_cache_manager_tpu_torch.models import llama, mixtral
from llm_d_kv_cache_manager_tpu_torch.parallel import mesh
from torch_parallel_workers import spawn

LLAMA = dict(vocab_size=256, d_model=64, n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=32,
             d_ff=128)  # tests/test_model.py:26-29
MOE = dict(vocab_size=128, d_model=32, n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=16,
           d_ff=64, n_experts=4, top_k=2)  # tests/test_mixtral.py:25-28
FAMILIES = {
    "llama": (jax_llama, llama, jax_llama.LlamaConfig, llama.LlamaConfig, LLAMA),
    "mixtral": (jax_mixtral, mixtral, jax_mixtral.MixtralConfig, mixtral.MixtralConfig, MOE),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(family, seed=7, batch_shape=(4, 16), batch_seed=3):
    jmod, pmod, jcfg_cls, pcfg_cls, kw = FAMILIES[family]
    jcfg = jcfg_cls(**kw, dtype=jnp.float32)
    jparams = jmod.init_params(jcfg, jax.random.PRNGKey(seed))
    batch = np.array(jax.random.randint(jax.random.PRNGKey(batch_seed), batch_shape, 0,
                                          kw["vocab_size"]))
    port = llama.params_from_jax(_np_tree(jparams), "cpu")
    return jmod, pmod, jcfg, pcfg_cls(**kw, dtype=torch.float32), jparams, port, batch


def _flat(tree):
    return {"/".join(p): v for p, v in llama._leaves(tree)}


def _jax_flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_every_gradient_match_value_and_grad(family):
    jmod, pmod, jcfg, cfg, jparams, port, batch = _setup(family)
    ref_loss, ref_grads = jax.value_and_grad(lambda p: jmod.loss_fn(jcfg, p, batch))(jparams)
    loss, grads = llama.loss_and_grads(
        lambda p: pmod.loss_fn(cfg, p, torch.from_numpy(batch)), port)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref, got = _jax_flat(ref_grads), _flat(grads)
    assert set(ref) == set(got)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[name], atol=1e-5, err_msg=name)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_matches_and_the_loss_falls(family):
    jmod, pmod, jcfg, cfg, jparams, port, batch = _setup(family)
    step = jax.jit(lambda p, b: jmod.train_step(jcfg, p, b))
    tokens = torch.from_numpy(batch)
    jp, p, losses = jparams, port, []
    for i in range(5):
        jp, jloss = step(jp, batch)
        p, loss = pmod.train_step(cfg, p, tokens)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        losses.append(float(loss))
        if i == 0:
            want = _jax_flat(jp)
            for name, t in _flat(p).items():
                np.testing.assert_allclose(t.numpy(), want[name], atol=1e-7, err_msg=name)
    assert losses[-1] < losses[0]


def test_bf16_train_step_keeps_dtypes_and_forward_dense_stays_inference_only():
    cfg = llama.LlamaConfig(**LLAMA)  # bf16
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    new, loss = llama.train_step(cfg, params, tokens)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(t.dtype == torch.bfloat16 and not t.requires_grad for _, t in llama._leaves(new))
    leaf = params["layers"]["wq"].requires_grad_(True)
    assert not llama.forward_dense(cfg, params, tokens).requires_grad
    leaf.requires_grad_(False)


def _shard_of(tree: dict, specs: dict, at) -> dict:
    full = llama.params_from_jax(tree, "cpu")
    return _flat(mesh.shard_tree(full, specs, at))


# The capacity dispatch's factors in the multi-rank step: the reference's
# production factor, and one whose routing overflows the capacity.
CAPACITY_FACTORS = (1.25, 0.5)
DP_TP_KW = dict(LLAMA, n_q_heads=8, n_kv_heads=4)
DP_TP_MOE_KW = dict(MOE, n_experts=8)


def _dp_tp_inputs():
    jcfg = jax_llama.LlamaConfig(**DP_TP_KW, dtype=jnp.float32)
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(9))
    batch = np.asarray(jax.random.randint(jax.random.PRNGKey(10), (4, 32), 0,
                                          DP_TP_KW["vocab_size"]))
    mcfg = jax_mixtral.MixtralConfig(**DP_TP_MOE_KW, dtype=jnp.float32)
    mparams = jax_mixtral.init_params(mcfg, jax.random.PRNGKey(4))
    moe_batch = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (4, 16), 0,
                                              DP_TP_MOE_KW["vocab_size"]))
    return jcfg, jparams, batch, mcfg, mparams, moe_batch


@pytest.fixture(scope="module")
def dp_tp_ranks(tmp_path_factory):
    """The four gloo ranks' results of train_dp_tp (one spawn for every
    multi-rank training test)."""
    _, jparams, batch, _, mparams, moe_batch = _dp_tp_inputs()
    return spawn("train_dp_tp", 4, tmp_path_factory.mktemp("train"), DP_TP_KW,
                 _np_tree(jparams), batch, DP_TP_MOE_KW, _np_tree(mparams), moe_batch,
                 CAPACITY_FACTORS)


def test_dp_tp_train_step_matches_the_host_loss(dp_tp_ranks):
    """tests/test_model.py:101-124 and tests/test_mixtral.py's expert-parallel
    step, each rank a gloo process."""
    jcfg, jparams, batch, mcfg, mparams, moe_batch = _dp_tp_inputs()
    ranks = dp_tp_ranks
    ref_loss = float(jax_llama.loss_fn(jcfg, jparams, batch))
    ref_new, _ = jax.jit(lambda p, b: jax_llama.train_step(jcfg, p, b))(jparams, batch)
    moe_ref_loss = float(jax_mixtral.loss_fn(mcfg, mparams, moe_batch))
    moe_ref_new, _ = jax.jit(lambda p, b: jax_mixtral.train_step(mcfg, p, b))(mparams, moe_batch)
    sizes = {"dp": 2, "tp": 2}
    for r in ranks:
        assert r["mesh_shards_equal"]
        np.testing.assert_allclose(r["loss"], ref_loss, rtol=1e-5)
        want = _shard_of(_np_tree(ref_new), mesh.param_specs(), mesh.MeshCoords(sizes,
                                                                                 r["coords"]))
        for name, got in r["new"].items():
            np.testing.assert_allclose(got, want[name].numpy(), atol=1e-7, err_msg=name)
        np.testing.assert_allclose(r["moe_loss"], moe_ref_loss, rtol=1e-5)
        at = mesh.MeshCoords({"ep": 2, "tp": 2}, {"ep": r["coords"]["dp"],
                                                  "tp": r["coords"]["tp"]})
        want = _shard_of(_np_tree(moe_ref_new), mixtral.param_specs(), at)
        for name, got in r["moe_new"].items():
            np.testing.assert_allclose(got, want[name].numpy(), atol=1e-7, err_msg=name)


def _capacity_reference(factor):
    """The JAX single-device Mixtral step on the capacity dispatch: (loss,
    new params as numpy)."""
    _, _, _, mcfg, mparams, moe_batch = _dp_tp_inputs()
    jcfg = jax_mixtral.MixtralConfig(**DP_TP_MOE_KW, capacity_factor=factor, dtype=jnp.float32)
    new, loss = jax.jit(lambda p, b: jax_mixtral.train_step(jcfg, p, b))(mparams, moe_batch)
    return float(loss), _np_tree(new)


@pytest.mark.parametrize("layout", ["ep_tp", "dp_ep"])
@pytest.mark.parametrize("factor", CAPACITY_FACTORS)
def test_capacity_dispatch_step_matches_the_single_device_step(dp_tp_ranks, layout, factor):
    """The capacity dispatch under an ep group, at ep 2 x tp 2 and at dp 2 x
    ep 2 (the batch split over dp): each rank's loss and its shard of the
    new params against JAX's single-device `train_step`, at the dense ep
    step's tolerances."""
    ref_loss, ref_new = _capacity_reference(factor)
    for r in dp_tp_ranks:
        loss, new = r["capacity"][(layout, factor)]
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        d, t = r["coords"]["dp"], r["coords"]["tp"]
        at = (mesh.MeshCoords({"ep": 2, "tp": 2}, {"ep": d, "tp": t}) if layout == "ep_tp"
              else mesh.MeshCoords({"ep": 2, "tp": 1}, {"ep": t, "tp": 0}))
        want = _shard_of(ref_new, mixtral.param_specs(), at)
        for name, got in new.items():
            np.testing.assert_allclose(got, want[name].numpy(), atol=1e-7,
                                       err_msg=f"{layout} {factor} {name}")


def _kept_pairs(top_idx: torch.Tensor, n_experts: int, capacity: int, first_tok: int = 0):
    """The (token, choice) pairs the capacity dispatch keeps for routing
    `top_idx` [S, K]: k-major, each expert's first `capacity` pairs."""
    s, k = top_idx.shape
    load = [0] * n_experts
    kept = set()
    for choice in range(k):
        for tok in range(s):
            e = int(top_idx[tok, choice])
            if load[e] < capacity:
                kept.add((first_tok + tok, choice))
            load[e] += 1
    return kept


def test_capacity_overflow_drops_the_whole_batchs_pairs(monkeypatch):
    """The overflowing factor drops pairs on layer 0, and slotting each dp
    shard on its own would keep a different set: the dp 2 x ep 2 step's
    equality with the single-device step (above) is then the global slots'."""
    _, _, _, _, mparams, moe_batch = _dp_tp_inputs()
    factor = min(CAPACITY_FACTORS)
    cfg = mixtral.MixtralConfig(**DP_TP_MOE_KW, capacity_factor=factor, dtype=torch.float32)
    port = llama.params_from_jax(_np_tree(mparams), "cpu")
    inputs, real = [], mixtral._moe_mlp
    monkeypatch.setattr(mixtral, "_moe_mlp",
                        lambda c, layer, x, *a: inputs.append(x) or real(c, layer, x, *a))
    mixtral.forward_dense(cfg, port, torch.from_numpy(moe_batch))
    e, k = cfg.n_experts, cfg.top_k
    h = inputs[0].reshape(-1, cfg.d_model)
    _, top_idx = mixtral.top_k((h @ port["layers"]["router"][0]).float(), k)
    s = top_idx.shape[0]
    kept = _kept_pairs(top_idx, e, -(-int(s * k * factor) // e))
    assert len(kept) < s * k  # pairs are dropped
    half = s // 2
    per_shard = set()
    for shard in range(2):
        per_shard |= _kept_pairs(top_idx[shard * half:(shard + 1) * half], e,
                                 -(-int(half * k * factor) // e), shard * half)
    assert per_shard != kept


# -- the bf16-cache wrappers -----------------------------------------------------------


@pytest.fixture(scope="module")
def wrapper_setup():
    _, _, jcfg, cfg, jparams, port, _ = _setup("llama")
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(8), (1, 24), 0, jcfg.vocab_size))
    dense = llama.forward_dense(cfg, port, torch.from_numpy(tokens))
    return jcfg, cfg, jparams, port, tokens, dense


def _pages(cfg, jcfg):
    jk, jv = jax_llama.make_kv_pages(jcfg, n_pages=8, page_size=8)
    k, v = llama.make_kv_pages(cfg, 8, 8, "cpu")
    return (jk, jv), (k, v)


def test_prefill_wrapper(wrapper_setup):
    jcfg, cfg, jparams, port, tokens, dense = wrapper_setup
    (jk, jv), (k, v) = _pages(cfg, jcfg)
    bt = np.arange(8, dtype=np.int32)
    _, _, jlogits = jax_llama.prefill(jcfg, jparams, jk, jv, jnp.asarray(tokens[0]), bt, 0)
    _, _, logits = llama.prefill(cfg, port, k, v, torch.from_numpy(tokens[0]),
                                 torch.from_numpy(bt), 0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), dense[0, -1].numpy(), atol=1e-4)


def test_chunked_prefill_and_decode_wrappers(wrapper_setup):
    jcfg, cfg, jparams, port, tokens, dense = wrapper_setup
    (jk, jv), (k, v) = _pages(cfg, jcfg)
    bt = np.arange(8, dtype=np.int32)
    t = torch.from_numpy(tokens)
    jk, jv, _ = jax_llama.prefill(jcfg, jparams, jk, jv, jnp.asarray(tokens[0, :10]), bt, 0)
    jk, jv, jlogits = jax_llama.prefill(jcfg, jparams, jk, jv, jnp.asarray(tokens[0, 10:16]),
                                        bt, 10)
    k, v, _ = llama.prefill(cfg, port, k, v, t[0, :10], torch.from_numpy(bt), 0)
    k, v, logits = llama.prefill(cfg, port, k, v, t[0, 10:16], torch.from_numpy(bt), 10)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), dense[0, 15].numpy(), atol=1e-4)
    for i in range(16, 24):
        jk, jv, jlogits = jax_llama.decode_step(jcfg, jparams, jk, jv, jnp.asarray(tokens[:, i]),
                                                bt[None], jnp.array([i]))
        k, v, logits = llama.decode_step(cfg, port, k, v, t[:, i].to(torch.int32),
                                         torch.from_numpy(bt)[None],
                                         torch.tensor([i], dtype=torch.int32))
        np.testing.assert_allclose(logits[0].numpy(), np.asarray(jlogits[0]), atol=1e-5)
        np.testing.assert_allclose(logits[0].numpy(), dense[0, i].numpy(), atol=1e-4)


def test_batched_decode_wrapper(wrapper_setup):
    jcfg, cfg, jparams, port, _, _ = wrapper_setup
    toks = [np.array(jax.random.randint(jax.random.PRNGKey(s), (1, n), 0, jcfg.vocab_size))
            for s, n in ((1, 12), (2, 20))]
    (jk, jv), (k, v) = _pages(cfg, jcfg)
    bt = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    for row, (tok, n) in enumerate(zip(toks, (11, 19))):
        jk, jv, _ = jax_llama.prefill(jcfg, jparams, jk, jv, jnp.asarray(tok[0, :n]), bt[row], 0)
        k, v, _ = llama.prefill(cfg, port, k, v, torch.from_numpy(tok[0, :n]),
                                torch.from_numpy(bt[row]), 0)
    last = np.array([toks[0][0, 11], toks[1][0, 19]], np.int32)
    _, _, jlogits = jax_llama.decode_step(jcfg, jparams, jk, jv, jnp.asarray(last), bt,
                                          jnp.array([11, 19]))
    _, _, logits = llama.decode_step(cfg, port, k, v, torch.from_numpy(last), torch.from_numpy(bt),
                                     torch.tensor([11, 19], dtype=torch.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5)
    for row, tok in enumerate(toks):
        dense = llama.forward_dense(cfg, port, torch.from_numpy(tok))
        np.testing.assert_allclose(logits[row].numpy(), dense[0, (11, 19)[row]].numpy(),
                                   atol=1e-4)
