"""The port's Llama serving functions against the JAX package's, in f32.

One JAX parameter tree (plus numpy-drawn biases and KV pools) goes through
both packages via `params_from_jax`; prefill and batched decode logits must
agree to 1e-4 and the updated page pools to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.ops import flash_prefill

LOGITS_TOL = dict(atol=1e-4, rtol=0)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 4

BASE = dict(vocab_size=128, d_model=32, n_layers=2, n_q_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=64)


def _configs(**overrides):
    fields = {**BASE, **overrides}
    return (
        jax_llama.LlamaConfig(**fields, dtype=jnp.float32),
        llama.LlamaConfig(**fields, dtype=torch.float32),
    )


def _params(jcfg, seed=0):
    np_params = jax.tree_util.tree_map(
        np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(seed))
    )
    if jcfg.attn_bias:  # zeros at init: draw real ones so the bias is load-bearing
        rng = np.random.default_rng(seed)
        for name in ("bq", "bk", "bv"):
            shape = np_params["layers"][name].shape
            np_params["layers"][name] = rng.standard_normal(shape, dtype=np.float32)
    return np_params, llama.params_from_jax(np_params, device="cpu")


def _pools(cfg, n_pages, seed=3):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, cfg.n_kv_heads, n_pages, PAGE, cfg.head_dim)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


def test_params_from_jax_keeps_layout_and_values():
    jcfg, _ = _configs()
    np_params, params = _params(jcfg)
    c = jcfg
    assert params["layers"]["wq"].shape == (c.n_layers, c.d_model, c.q_dim)  # [in, out]
    assert params["layers"]["w_down"].shape == (c.n_layers, c.d_ff, c.d_model)
    assert params["out"].shape == (c.d_model, c.vocab_size)
    np.testing.assert_array_equal(params["layers"]["wk"].numpy(), np_params["layers"]["wk"])
    np.testing.assert_array_equal(params["embed"].numpy(), np_params["embed"])


def test_params_from_jax_carries_bf16():
    jcfg = jax_llama.LlamaConfig(**BASE)  # bf16, the serving dtype
    np_params = jax_llama.init_params(jcfg, jax.random.PRNGKey(1))
    params = llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, np_params), device="cpu"
    )
    assert params["layers"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["layers"]["wq"].float().numpy(),
        np.asarray(np_params["layers"]["wq"].astype(jnp.float32)),
    )


# (config overrides, prefix tokens already cached, new tokens, padded length)
PREFILL_CASES = {
    "from_scratch_unpadded": ({}, 0, 10, None),
    "from_scratch_padded": ({}, 0, 10, 16),
    "prefix_hit_unpadded": ({}, 8, 6, None),
    "prefix_hit_padded": ({}, 8, 6, 8),
    "sliding_window": ({"sliding_window": 5}, 4, 9, 16),
    "attn_bias": ({"attn_bias": True}, 4, 7, 8),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_cache_matches_jax(case):
    overrides, n_prefix, n_new, padded = PREFILL_CASES[case]
    jcfg, cfg = _configs(**overrides)
    np_params, params = _params(jcfg)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, n_prefix + n_new).astype(np.int32)
    n_pages = 8
    table = rng.permutation(n_pages).astype(np.int32)
    k0, v0 = _pools(jcfg, n_pages)

    # The cached prefix is whatever a first prefill wrote; then the chunk.
    jcache = (jnp.asarray(k0), jnp.asarray(v0))
    pcache = (torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    steps = [(0, n_prefix, None)] if n_prefix else []
    steps.append((n_prefix, n_new, padded))
    for start, length, pad_to in steps:
        chunk = tokens[start:start + length]
        n_valid = None
        if pad_to is not None:
            chunk = np.concatenate([chunk, np.zeros(pad_to - length, np.int32)])
            n_valid = length
        jcache, want = jax_llama.prefill_cache(
            jcfg, np_params, jcache, jnp.asarray(chunk), jnp.asarray(table), start,
            n_valid=None if n_valid is None else jnp.asarray(n_valid, jnp.int32),
        )
        pcache, got = llama.prefill_cache(
            cfg, params, pcache, torch.from_numpy(chunk), torch.from_numpy(table),
            start, n_valid=n_valid,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    for got_pool, want_pool in zip(pcache, jcache):
        np.testing.assert_allclose(got_pool.numpy(), np.asarray(want_pool), **CACHE_TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_prefill_cache_plain_path_matches_default(window):
    """`plain=True` (the checks' comparison path on the card) runs the same
    attention as the default path takes on CPU tensors, and no kernel."""
    _, cfg = _configs(sliding_window=window)
    _, params = _params(_configs()[0])
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, 14).astype(np.int32))
    table = torch.from_numpy(rng.permutation(8).astype(np.int32))
    k0, v0 = _pools(cfg, 8)
    logits = []
    for plain in (False, True):
        cache = (torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
        before = flash_prefill.launches
        cache, _ = llama.prefill_cache(cfg, params, cache, tokens[:8], table, 0, plain=plain)
        cache, out = llama.prefill_cache(cfg, params, cache, tokens[8:], table, 8, plain=plain)
        assert flash_prefill.launches == before
        logits.append(out)
    assert torch.equal(logits[0], logits[1])


@pytest.mark.parametrize("window", [None, 6])
def test_decode_step_cache_batch_matches_jax(window):
    jcfg, cfg = _configs(sliding_window=window)
    np_params, params = _params(jcfg, seed=2)
    rng = np.random.default_rng(7)
    batch, pps = 3, 4
    n_pages = batch * pps + 1
    k0, v0 = _pools(jcfg, n_pages, seed=8)
    tables = rng.permutation(n_pages)[: batch * pps].reshape(batch, pps).astype(np.int32)
    seq_lens = np.array([3, 9, 14], np.int32)  # unequal; 14 -> last page
    tokens = rng.integers(0, jcfg.vocab_size, batch).astype(np.int32)

    jcache, want = jax_llama.decode_step_cache(
        jcfg, np_params, (jnp.asarray(k0), jnp.asarray(v0)), jnp.asarray(tokens),
        jnp.asarray(tables), jnp.asarray(seq_lens),
    )
    pcache, got = llama.decode_step_cache(
        cfg, params, (torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())),
        torch.from_numpy(tokens), torch.from_numpy(tables), torch.from_numpy(seq_lens),
    )
    assert got.shape == (batch, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    for got_pool, want_pool in zip(pcache, jcache):
        np.testing.assert_allclose(got_pool.numpy(), np.asarray(want_pool), **CACHE_TOL)


@pytest.mark.parametrize("fn", ["rms_norm", "rope", "mlp"])
def test_layer_math_matches_jax(fn):
    jcfg, cfg = _configs()
    np_params, params = _params(jcfg)
    rng = np.random.default_rng(9)
    layer_np = {k: v[0] for k, v in np_params["layers"].items()}
    layer = llama.layer_params(params, 0)
    if fn == "rms_norm":
        x = rng.standard_normal((2, 5, jcfg.d_model), dtype=np.float32)
        scale = rng.standard_normal(jcfg.d_model, dtype=np.float32)
        want = jax_llama.rms_norm(jnp.asarray(x), jnp.asarray(scale), jcfg.rms_eps)
        got = llama.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), cfg.rms_eps)
    elif fn == "rope":
        x = rng.standard_normal((2, 5, jcfg.n_q_heads, jcfg.head_dim), dtype=np.float32)
        pos = rng.integers(0, 4096, (2, 5))
        want = jax_llama._rope(jnp.asarray(x), jnp.asarray(pos), jcfg.rope_theta)
        got = llama._rope(torch.from_numpy(x), torch.from_numpy(pos), cfg.rope_theta)
    else:
        x = rng.standard_normal((2, 5, jcfg.d_model), dtype=np.float32)
        want = jax_llama._mlp(layer_np, jnp.asarray(x))
        got = llama._mlp(layer, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_cpu_config_is_the_reference_default_shape():
    """The port's config mirrors the reference's field for field."""
    jfields = [f.name for f in dataclasses.fields(jax_llama.LlamaConfig)]
    pfields = [f.name for f in dataclasses.fields(llama.LlamaConfig)]
    assert pfields == jfields
    _, cfg = _configs()
    assert (cfg.q_dim, cfg.kv_dim) == (64, 32)


# -- int8 pages, the multi-position ops ------------------------------------------


def _int8_pools(cfg, n_pages, seed=3):
    """Random int8 pools (values, positive f32 scales), layer-stacked."""
    rng = np.random.default_rng(seed)
    q_shape = (cfg.n_layers, cfg.n_kv_heads, n_pages, PAGE, cfg.head_dim)
    s_shape = q_shape[:-1] + (1,)
    pools = []
    for _ in range(2):
        pools.append(rng.integers(-127, 128, q_shape).astype(np.int8))
        pools.append(rng.uniform(0.005, 0.05, s_shape).astype(np.float32))
    return tuple(pools)


def _both_caches(pools):
    return (tuple(jnp.asarray(p) for p in pools),
            tuple(torch.from_numpy(p.copy()) for p in pools))


def _assert_pools_match(got, want, skip_page=None):
    """Pools in the model dtype to 1e-5. Int8 values equal except where the
    two packages' f32 matmuls differ in the last bits and flip a rounding:
    then at most one step apart, on at most 0.1% of the entries; scales to
    rtol 1e-5. `skip_page`: a page whose content is unspecified (rows that
    several positions steer to the trash page)."""
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if skip_page is not None:
            g, w = np.delete(g, skip_page, axis=2), np.delete(w, skip_page, axis=2)
        if g.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        else:
            np.testing.assert_allclose(g, w, **CACHE_TOL)


@pytest.mark.parametrize(
    "case", ["from_scratch_unpadded", "prefix_hit_padded", "sliding_window"]
)
def test_prefill_cache_int8_matches_jax(case):
    overrides, n_prefix, n_new, padded = PREFILL_CASES[case]
    jcfg, cfg = _configs(**overrides)
    np_params, params = _params(jcfg)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, n_prefix + n_new).astype(np.int32)
    n_pages = 8
    table = rng.permutation(n_pages).astype(np.int32)
    jcache, pcache = _both_caches(_int8_pools(jcfg, n_pages))
    steps = [(0, n_prefix, None)] if n_prefix else []
    steps.append((n_prefix, n_new, padded))
    for start, length, pad_to in steps:
        chunk = tokens[start:start + length]
        n_valid = None
        if pad_to is not None:
            chunk = np.concatenate([chunk, np.zeros(pad_to - length, np.int32)])
            n_valid = length
        jcache, want = jax_llama.prefill_cache(
            jcfg, np_params, jcache, jnp.asarray(chunk), jnp.asarray(table), start,
            n_valid=None if n_valid is None else jnp.asarray(n_valid, jnp.int32),
        )
        pcache, got = llama.prefill_cache(
            cfg, params, pcache, torch.from_numpy(chunk), torch.from_numpy(table),
            start, n_valid=n_valid,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    _assert_pools_match(pcache, jcache)


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "tiled"])
@pytest.mark.parametrize("window", [None, 6])
def test_decode_step_cache_int8_batch_matches_jax(window, pipelined):
    jcfg, cfg = _configs(sliding_window=window)
    np_params, params = _params(jcfg, seed=2)
    rng = np.random.default_rng(7)
    batch, pps = 3, 4
    n_pages = batch * pps + 1
    jcache, pcache = _both_caches(_int8_pools(jcfg, n_pages, seed=8))
    tables = rng.permutation(n_pages)[: batch * pps].reshape(batch, pps).astype(np.int32)
    seq_lens = np.array([3, 9, 14], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, batch).astype(np.int32)
    jcache, want = jax_llama.decode_step_cache(
        jcfg, np_params, jcache, jnp.asarray(tokens), jnp.asarray(tables),
        jnp.asarray(seq_lens), pipelined=pipelined,
    )
    pcache, got = llama.decode_step_cache(
        cfg, params, pcache, torch.from_numpy(tokens), torch.from_numpy(tables),
        torch.from_numpy(seq_lens), pipelined=pipelined,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    _assert_pools_match(pcache, jcache)


@pytest.mark.parametrize("layout", ["model_dtype", "int8"])
def test_verify_step_cache_matches_jax(layout):
    """tests/test_speculative.py::TestBatchedVerify's shape, with per-batch
    start positions and max_lens that send over-budget rows to the trash
    page."""
    jcfg, cfg = _configs()
    np_params, params = _params(jcfg, seed=4)
    rng = np.random.default_rng(11)
    b, s, pps = 3, 5, 4
    trash = b * pps
    pools = _int8_pools(jcfg, trash + 1) if layout == "int8" else _pools(jcfg, trash + 1)
    jcache, pcache = _both_caches(pools)
    tables = np.arange(b * pps, dtype=np.int32).reshape(b, pps)
    tokens = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    starts = np.array([8, 5, 10], np.int32)
    max_lens = np.array([13, 8, 11], np.int32)  # 5, 3 and 1 real rows
    jcache, want = jax_llama.verify_step_cache(
        jcfg, np_params, jcache, jnp.asarray(tokens), jnp.asarray(tables),
        jnp.asarray(starts), jnp.asarray(max_lens), trash_page=trash,
    )
    pcache, got = llama.verify_step_cache(
        cfg, params, pcache, torch.from_numpy(tokens), torch.from_numpy(tables),
        torch.from_numpy(starts), torch.from_numpy(max_lens), trash_page=trash,
    )
    assert got.shape == (b, s, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    _assert_pools_match(pcache, jcache, skip_page=trash)
    # Over-budget rows landed in the trash page, not at their positions:
    # sequence 1's positions 8-9 (page 6, slots 0-1) and sequence 2's 11-14
    # (page 10 slot 3, page 11 slots 0-2) keep their old content.
    assert not np.array_equal(pcache[0][:, :, trash].numpy(), pools[0][:, :, trash])
    for page, slots in ((6, slice(0, 2)), (10, slice(3, 4)), (11, slice(0, 3))):
        np.testing.assert_array_equal(
            pcache[0][:, :, page, slots].numpy(), pools[0][:, :, page, slots])


def _multi_step_setup(layout):
    """tests/test_multistep_decode.py's setup: a 7-token prompt prefilled
    into pages 0-1 of 16 real pages plus trash page 16, on both packages."""
    jcfg, cfg = _configs()
    np_params, params = _params(jcfg, seed=6)
    if layout == "int8":
        jcache = jax_llama.make_kv_pages_quantized(jcfg, 17, PAGE)
        pcache = llama.make_kv_pages_quantized(cfg, 17, PAGE, device="cpu")
    else:
        jcache = jax_llama.make_kv_pages(jcfg, 17, PAGE)
        pcache = llama.make_kv_pages(cfg, 17, PAGE, device="cpu")
    table = np.arange(4, dtype=np.int32)
    prompt = np.arange(7, dtype=np.int32)
    jcache, jlogits = jax_llama.prefill_cache(
        jcfg, np_params, jcache, jnp.asarray(prompt), jnp.asarray(table), 0)
    pcache, plogits = llama.prefill_cache(
        cfg, params, pcache, torch.from_numpy(prompt), torch.from_numpy(table), 0)
    pending = np.array([int(jnp.argmax(jlogits))], np.int32)
    assert int(torch.argmax(plogits)) == pending[0]
    return (jcfg, np_params, jcache), (cfg, params, pcache), table, pending


@pytest.mark.parametrize("layout", ["model_dtype", "int8"])
def test_decode_multi_step_cache_matches_jax_and_single_steps(layout):
    n = 5
    (jcfg, np_params, jcache), (cfg, params, pcache), table, pending = (
        _multi_step_setup(layout))
    _, want = jax_llama.decode_multi_step_cache(
        jcfg, np_params, jcache, jnp.asarray(pending), jnp.asarray(table[None]),
        jnp.asarray([7], jnp.int32), jnp.asarray([7 + n], jnp.int32), 16, n,
    )
    twin = tuple(p.clone() for p in pcache)
    _, got = llama.decode_multi_step_cache(
        cfg, params, pcache, torch.from_numpy(pending), torch.from_numpy(table[None]),
        torch.tensor([7], dtype=torch.int32), torch.tensor([7 + n], dtype=torch.int32),
        16, n,
    )
    assert got.shape == (1, n) and got.tolist() == np.asarray(want).tolist()
    tok, single = torch.from_numpy(pending), []
    for i in range(n):
        twin, logits = llama.decode_step_cache(
            cfg, params, twin, tok, torch.from_numpy(table[None]),
            torch.tensor([7 + i], dtype=torch.int32), pipelined=True,
        )
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        single.append(int(tok[0]))
    assert got[0].tolist() == single
    for a, b in zip(pcache, twin):
        assert torch.equal(a[:, :, :4], b[:, :, :4])


@pytest.mark.parametrize("layout", ["model_dtype", "int8"])
def test_decode_multi_step_capacity_mask_steers_to_trash(layout):
    """tests/test_multistep_decode.py::test_capacity_mask_steers_overflow_to_trash:
    a budget of 2 rows (max_len 9) over 6 steps."""
    (jcfg, np_params, jcache), (cfg, params, pcache), table, pending = (
        _multi_step_setup(layout))
    full = tuple(p.clone() for p in pcache)
    _, want = jax_llama.decode_multi_step_cache(
        jcfg, np_params, jcache, jnp.asarray(pending), jnp.asarray(table[None]),
        jnp.asarray([7], jnp.int32), jnp.asarray([9], jnp.int32), 16, 6,
    )
    _, got = llama.decode_multi_step_cache(
        cfg, params, pcache, torch.from_numpy(pending), torch.from_numpy(table[None]),
        torch.tensor([7], dtype=torch.int32), torch.tensor([9], dtype=torch.int32), 16, 6,
    )
    assert got.tolist() == np.asarray(want).tolist()
    # Rows 7 and 8 were written (page 1 slot 3, page 2 slot 0); nothing past.
    assert not pcache[0][:, :, 2, 1:].any()
    assert pcache[0][:, :, 16].any()  # the trash page took the overflow
    _, unrestricted = llama.decode_multi_step_cache(
        cfg, params, full, torch.from_numpy(pending), torch.from_numpy(table[None]),
        torch.tensor([7], dtype=torch.int32), torch.tensor([13], dtype=torch.int32), 16, 6,
    )
    assert got[0, :2].tolist() == unrestricted[0, :2].tolist()


@pytest.mark.parametrize("layout", ["model_dtype", "int8"])
def test_decode_multi_step_sampling_matches_jax_and_single_steps(layout):
    """`sampling=(temps, top_ks, top_ps, base_keys)`: the same sampled tokens
    as the JAX package's multi-step decode, and as single steps that sample
    with `position_keys(base_keys, position)`."""
    from llm_d_kv_cache_manager_tpu_torch.ops import sampling

    n = 5
    (jcfg, np_params, jcache), (cfg, params, pcache), table, pending = (
        _multi_step_setup(layout))
    jax_arrays = (jnp.asarray([1.3]), jnp.asarray([20], jnp.int32), jnp.asarray([0.9]),
                  jnp.stack([jax.random.PRNGKey(42)]))
    port_arrays = (torch.tensor([1.3]), torch.tensor([20], dtype=torch.int32),
                   torch.tensor([0.9]), torch.stack([sampling.prng_key(42, "cpu")]))
    _, want = jax_llama.decode_multi_step_cache(
        jcfg, np_params, jcache, jnp.asarray(pending), jnp.asarray(table[None]),
        jnp.asarray([7], jnp.int32), jnp.asarray([7 + n], jnp.int32), 16, n,
        sampling=jax_arrays,
    )
    twin = tuple(p.clone() for p in pcache)
    _, got = llama.decode_multi_step_cache(
        cfg, params, pcache, torch.from_numpy(pending), torch.from_numpy(table[None]),
        torch.tensor([7], dtype=torch.int32), torch.tensor([7 + n], dtype=torch.int32),
        16, n, sampling=port_arrays,
    )
    assert got.tolist() == np.asarray(want).tolist()
    tok, single = torch.from_numpy(pending), []
    for i in range(n):
        pos = torch.tensor([7 + i], dtype=torch.int32)
        twin, logits = llama.decode_step_cache(
            cfg, params, twin, tok, torch.from_numpy(table[None]), pos, pipelined=True)
        tok = sampling.sample_tokens(logits, *port_arrays[:3],
                                     sampling.position_keys(port_arrays[3], pos))
        single.append(int(tok[0]))
    assert got[0].tolist() == single
