"""The port's sampler (`ops/sampling.py`) against the JAX package's.

The port draws JAX's own Threefry noise, so the same logits, parameters and
keys must give the same tokens: uniforms bit for bit, Gumbel noise within
the last ulp of `log`, the same filtered distribution, the same sampled
tokens and the same speculative accept/resample outcomes. Inputs are seeded
numpy draws fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.ops import sampling as jax_sampling
from llm_d_kv_cache_manager_tpu_torch.ops import sampling

SEEDS = [0, 7, 123456, 2**31 + 5]
POSITIONS = [0, 1, 1000, 2**20 + 3]


def _port_keys(seeds, positions):
    base = torch.stack([sampling.prng_key(s, "cpu") for s in seeds])
    return sampling.position_keys(base, torch.tensor(positions, dtype=torch.int32))


def _jax_keys(seeds, positions):
    base = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    return jax_sampling.position_keys(base, jnp.asarray(positions, jnp.int32))


def _params(rng, batch, vocab):
    """Seeded logits and a mix of greedy and sampled rows."""
    logits = (rng.standard_normal((batch, vocab)) * 3).astype(np.float32)
    temps = rng.choice([0.0, 0.5, 1.0, 2.0], batch).astype(np.float32)
    top_ks = rng.choice([0, 1, 5, 20], batch).astype(np.int32)
    top_ps = rng.choice([0.0, 0.5, 0.9, 1.0], batch).astype(np.float32)
    return logits, temps, top_ks, top_ps


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    assert sampling.prng_key(seed, "cpu").tolist() == np.asarray(jax.random.PRNGKey(seed)).tolist()
    for pos in POSITIONS:
        want = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
        assert _port_keys([seed], [pos])[0].tolist() == np.asarray(want).tolist()
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed)))
    assert sampling.split_key(sampling.prng_key(seed, "cpu")).tolist() == want.tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_uniforms_bit_equal_to_jax(seed):
    vocab = 32768
    keys = _port_keys([seed] * len(POSITIONS), POSITIONS)
    batched = sampling.uniform_from_bits(sampling.random_bits(keys, vocab)).numpy()
    for i, pos in enumerate(POSITIONS):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
        want = np.asarray(jax.random.uniform(key, (vocab,))).view(np.uint32)
        one = sampling.uniform_from_bits(sampling.random_bits(keys[i : i + 1], vocab))[0]
        np.testing.assert_array_equal(one.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(batched[i].view(np.uint32), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_noise_matches_jax(seed):
    vocab = 32768
    keys = _port_keys([seed] * len(POSITIONS), POSITIONS)
    got = sampling.gumbel_noise(keys, vocab).numpy()
    want = np.stack([
        np.asarray(jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(seed), p), (vocab,)))
        for p in POSITIONS
    ])
    # Only the last ulp of log separates the two.
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("trial", range(4))
def test_filter_logits_matches_jax(trial):
    rng = np.random.default_rng(trial)
    logits, temps, top_ks, top_ps = _params(rng, 32, 128)
    want = np.asarray(jax_sampling.filter_logits(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps)))
    got = sampling.filter_logits(
        torch.from_numpy(logits), torch.from_numpy(temps), torch.from_numpy(top_ks),
        torch.from_numpy(top_ps)).numpy()
    # The -inf masks agree except where top-p's cut is an f32 rounding tie:
    # a token whose cumulative probability before it is within 1e-6 of top_p
    # (XLA's and torch's exp and sums may round either way there). Such
    # tokens carry almost no mass, as the last assertion shows.
    scaled = logits.astype(np.float64) / np.maximum(temps, 1e-6)[:, None]
    kth = np.sort(scaled, axis=-1)[:, ::-1][
        np.arange(32), np.clip(np.where(top_ks > 0, top_ks, 128) - 1, 0, 127)]
    kept_k = np.where(scaled >= kth[:, None], scaled, -np.inf)
    probs = np.exp(kept_k - kept_k.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    order = np.argsort(-kept_k, axis=-1, kind="stable")
    cum_sorted = np.cumsum(np.take_along_axis(probs, order, -1), -1) - np.take_along_axis(
        probs, order, -1)
    cum_before = np.empty_like(cum_sorted)
    np.put_along_axis(cum_before, order, cum_sorted, -1)
    tie = np.abs(cum_before - np.maximum(top_ps, 1e-6)[:, None]) <= 1e-6
    differ = np.isneginf(got) != np.isneginf(want)
    assert not (differ & ~tie).any()
    assert (probs * differ).sum(-1).max() < 1e-6
    both = np.isfinite(got) & np.isfinite(want)
    np.testing.assert_allclose(got[both], want[both], atol=1e-6, rtol=0)
    assert np.isfinite(got.max(-1)).all()  # every row keeps a token


@pytest.mark.parametrize("trial", range(4))
def test_sample_tokens_match_jax(trial):
    rng = np.random.default_rng(100 + trial)
    batch = 32
    logits, temps, top_ks, top_ps = _params(rng, batch, 128)
    seeds = rng.integers(0, 2**31, batch).tolist()
    positions = rng.integers(0, 5000, batch).tolist()
    want = np.asarray(jax_sampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps),
        _jax_keys(seeds, positions)))
    got = sampling.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temps), torch.from_numpy(top_ks),
        torch.from_numpy(top_ps), _port_keys(seeds, positions))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _unit_logits(batch=4, vocab=64, seed=1):
    """The JAX unit tests' logits (`jax.random.normal * 3`), on both sides."""
    logits = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (batch, vocab)) * 3)
    return logits, torch.from_numpy(logits.copy())


@pytest.mark.parametrize(
    "temp, top_k, top_p",
    [(0.0, 0, 1.0), (5.0, 1, 1.0), (3.0, 0, 1e-6), (2.0, 0, 0.0)],
    ids=["temperature_zero", "top_k_one", "tiny_top_p", "top_p_zero"],
)
def test_degenerate_filters_are_argmax(temp, top_k, top_p):
    """Temperature 0, top_k 1, top_p 1e-6 and top_p 0 all give the argmax
    (top_p 0 clamps to greedy rather than emptying the kept set), as in
    the JAX package."""
    jlogits, logits = _unit_logits()
    args = (torch.full((4,), temp), torch.full((4,), top_k, dtype=torch.int32),
            torch.full((4,), top_p))
    got = sampling.sample_tokens(logits, *args, _port_keys(range(4), range(4)))
    want = jax_sampling.sample_tokens(
        jnp.asarray(jlogits), *(jnp.asarray(a.numpy()) for a in args),
        _jax_keys(range(4), range(4)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), jlogits.argmax(-1))


def test_top_k_restricts_support():
    """1,000 draws at high temperature never leave the top-5 set, and draw
    the same tokens as the JAX package."""
    vocab = 32
    jlogits = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, vocab)))
    top5 = set(np.argsort(-jlogits[0])[:5].tolist())
    n = 1000
    logits = torch.from_numpy(np.repeat(jlogits, n, 0))
    args = (torch.full((n,), 10.0), torch.full((n,), 5, dtype=torch.int32), torch.ones(n))
    got = sampling.sample_tokens(logits, *args, _port_keys([9] * n, range(n))).numpy()
    want = np.asarray(jax_sampling.sample_tokens(
        jnp.asarray(logits.numpy()), *(jnp.asarray(a.numpy()) for a in args),
        _jax_keys([9] * n, range(n))))
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) <= top5
    assert len(set(got.tolist())) > 1


def test_rows_are_independent():
    """A row's draw depends only on its own key, not on the batch."""
    _, logits = _unit_logits(batch=3)
    keys = _port_keys(range(3), [7, 7, 7])
    args = (torch.full((3,), 2.0), torch.zeros(3, dtype=torch.int32), torch.full((3,), 0.9))
    full = sampling.sample_tokens(logits, *args, keys)
    solo = sampling.sample_tokens(logits[1:2], *(a[1:2] for a in args), keys[1:2])
    assert int(full[1]) == int(solo[0])


def test_sampler_never_reads_back_to_the_host():
    """Keys, noise, filters and the draw run on meta tensors, which hold no
    values: no step of a sampled decode reads the device (so it can be
    captured in a CUDA graph later)."""
    b, vocab, meta = 8, 512, "meta"
    keys = sampling.position_keys(torch.empty(b, 2, dtype=torch.int64, device=meta),
                                  torch.empty(b, dtype=torch.int32, device=meta))
    out = sampling.sample_tokens(
        torch.empty(b, vocab, device=meta), torch.empty(b, device=meta),
        torch.empty(b, dtype=torch.int32, device=meta), torch.empty(b, device=meta), keys)
    assert out.device.type == "meta" and out.shape == (b,) and out.dtype == torch.int32


def test_sampling_params():
    assert sampling.SamplingParams().is_greedy
    assert sampling.SamplingParams(temperature=0.7).is_greedy is False
    with pytest.raises(AttributeError):
        sampling.SamplingParams().temperature = 1.0  # frozen


def _accept_inputs(n, vocab=12):
    rng = np.random.default_rng(0)
    q = rng.dirichlet(np.ones(vocab) * 0.5).astype(np.float32)
    p = rng.dirichlet(np.ones(vocab) * 0.5).astype(np.float32)
    # Proposals drawn from p with an independent stream, as in the JAX test.
    prop_keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(4), jnp.arange(n))
    proposals = np.asarray(jax.vmap(lambda k: jax.random.categorical(k, jnp.log(p)))(
        prop_keys)).astype(np.int32)
    return q, p, proposals


def test_accept_or_resample_matches_jax():
    n = 4000
    q, p, proposals = _accept_inputs(n)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(3), jnp.arange(n))
    want_tok, want_acc = jax.vmap(jax_sampling.accept_or_resample, (None, None, 0, 0))(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(proposals), keys)
    tok, acc = sampling.accept_or_resample(
        torch.from_numpy(q), torch.from_numpy(p), torch.from_numpy(proposals),
        _port_keys([3] * n, range(n)))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    assert 0 < int(acc.sum()) < n  # both branches taken
    one_tok, one_acc = sampling.accept_or_resample(
        torch.from_numpy(q), torch.from_numpy(p), int(proposals[5]), _port_keys([3], [5])[0])
    assert (int(one_tok), bool(one_acc)) == (int(want_tok[5]), bool(want_acc[5]))


def test_accept_or_resample_preserves_target_distribution():
    """The emitted token's law is exactly q whatever the draft p: 20k
    trials, total-variation distance under 0.02, and the acceptance rate
    is sum_x min(q, p) (the JAX package's check)."""
    n = 20000
    q, p, proposals = _accept_inputs(n)
    tok, acc = sampling.accept_or_resample(
        torch.from_numpy(q), torch.from_numpy(p), torch.from_numpy(proposals),
        _port_keys([3] * n, range(n)))
    empirical = np.bincount(tok.numpy(), minlength=len(q)) / n
    tv = 0.5 * np.abs(empirical - q).sum()
    assert tv < 0.02, (tv, empirical, q)
    assert abs(float(acc.float().mean()) - np.minimum(q, p).sum()) < 0.02
