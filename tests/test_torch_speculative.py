"""The port's speculative decoding against the JAX package's.

Every test of `tests/test_speculative.py` and the two speculative tests of
`tests/test_sampling.py::TestServingSampling` as a scenario run on JAX pods
and port pods (device="cpu", f32) built from one parameter tree, the draft
models carried across by `llama.params_from_jax` (`_Side` of
`tests/test_torch_lora.py`). Both runs must give the same tokens, sampled
ones included, the same `SpeculativeStats` and the same BlockStored /
BlockRemoved stream on every pod; the scenario's own assertions hold on the
port's run too. Scenarios run on model-dtype and int8 pages (one that fixes
its page format keeps it). The statistical test of the accept/resample rule
runs on the port alone, at the JAX test's tolerance.
"""

import numpy as np
import pytest
import torch

from test_torch_lora import _Side, _stats, run_both

from llm_d_kv_cache_manager_tpu_torch.engine import speculative
from llm_d_kv_cache_manager_tpu_torch.ops import sampling

SAMPLING_PROMPT = [3, 17, 99, 4, 250 % 128, 7]  # test_sampling.py's PROMPT


def _decoder(side, pod, draft="draft5", k=4):
    cfg, params = side.model("target" if draft == "target" else draft)
    return side.speculative.SpeculativeDecoder(pod, cfg, params, k=k)


def _spec_scheduler(side, pod, draft="draft5", k=3, max_batch=4):
    cfg, params = side.model("target" if draft == "target" else draft)
    return side.speculative.SpeculativeScheduler(pod, cfg, params, k=k, max_batch=max_batch)


def _plain(side, prompts, budgets, n_pages=128, max_batch=4):
    sched = side.scheduler(side.pod(n_pages=n_pages), max_batch=max_batch)
    ids = [sched.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    results = sched.run()
    return [results[i] for i in ids]


def _spec_run(spec, prompts, budgets):
    ids = [spec.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    results = spec.run()
    return [results[i] for i in ids]


# -- TestGreedyEquivalence ---------------------------------------------------------


def _weak_draft_output_identical(k):
    def scenario(side):
        prompt = list(range(2, 13))
        expected = side.isolated(prompt, 12)
        spec = _decoder(side, side.pod(), k=k)
        out = spec.generate(prompt, max_new_tokens=12)
        assert out == expected
        # Proposals are capped by the remaining budget in late rounds.
        assert 0 < spec.stats.proposed <= spec.stats.rounds * k
        assert spec.stats.accepted <= spec.stats.proposed
        return out, _stats(spec.stats)
    scenario.__name__ = f"weak_draft_output_identical_k{k}"
    return scenario


def perfect_draft_accepts_everything(side):
    prompt = list(range(3, 10))
    expected = side.isolated(prompt, 10)
    spec = _decoder(side, side.pod(), draft="target", k=3)
    out = spec.generate(prompt, max_new_tokens=10)
    assert out == expected
    # Every token beyond each round's frontier token came from an accepted
    # proposal: none was rejected (the last round is cut by the budget).
    assert spec.stats.accepted == len(out) - spec.stats.rounds
    return out, _stats(spec.stats)


def eos_stops_generation(side):
    prompt = list(range(2, 10))
    eos = side.isolated(prompt, 1)[0]
    spec = _decoder(side, side.pod(), k=3)
    out = spec.generate(prompt, max_new_tokens=10, eos_token=eos)
    assert out == [eos]
    return out, _stats(spec.stats)


# -- TestEngineStateHygiene --------------------------------------------------------


def pages_fully_released_after_generation(side):
    pod = side.pod(n_pages=32)
    spec = _decoder(side, pod, k=4)
    outs = [spec.generate(list(range(2, 13)), max_new_tokens=8)]
    # Every page is back (committed ones cached and reclaimable, reserved
    # ones free): a second, larger run must still fit.
    assert pod.block_manager.num_free_pages == 32
    outs.append(spec.generate(list(range(40, 60)), max_new_tokens=8))
    assert pod.block_manager.num_free_pages == 32
    return outs, _stats(spec.stats)


def prefix_cache_only_advertises_accepted_tokens(side):
    pod = side.pod()
    spec = _decoder(side, pod, k=4)
    prompt = list(range(2, 10))
    out = spec.generate(prompt, max_new_tokens=6)
    full = prompt + list(out)
    emitted = [t for b in side.events[-1] for e in b.events if hasattr(e, "token_ids")
               for t in e.token_ids]
    # Every stored block is a prefix chunk of the accepted sequence.
    assert emitted == full[: len(emitted)]
    return out, emitted


def page_capacity_boundary_completes(side):
    # A generation that exactly fills max_pages_per_seq completes:
    # proposals are capped so the verify chunk never reserves past the page
    # budget (16 pages x 4 = a 64-token capacity).
    prompt = list(range(2, 61))  # 59 tokens
    expected = side.isolated(prompt, 5)
    spec = _decoder(side, side.pod(), k=4)
    out = spec.generate(prompt, max_new_tokens=5)
    assert out == expected
    return out, _stats(spec.stats)


def rejects_k_zero_and_adapter_pods(side):
    # The JAX test's accounting pod has no port counterpart (port pods
    # always hold a model); an adapter pod is refused by both packages.
    errors = []
    with pytest.raises(ValueError, match="k must be") as err:
        _decoder(side, side.pod(), k=0)
    errors.append(str(err.value))
    with pytest.raises(NotImplementedError) as err:
        _decoder(side, side.pod(adapters={7: "A"}))
    errors.append(str(err.value))
    with pytest.raises(ValueError, match="k must be") as err:
        _spec_scheduler(side, side.pod(), k=0)
    errors.append(str(err.value))
    return errors


# -- TestBatchedVerify -------------------------------------------------------------


def verify_matches_per_sequence_prefill(side):
    cfg, params = side.cfg, side.params
    b, prefix_len, s = 3, 8, 5
    pps = (prefix_len + s + 4 - 1) // 4 + 1
    rng = np.random.RandomState(0)
    prefixes = rng.randint(0, cfg.vocab_size, (b, prefix_len))
    chunks = rng.randint(0, cfg.vocab_size, (b, s))
    tables = side.array(np.arange(b * pps).reshape(b, pps))
    cache = side.pages(b * pps)
    for i in range(b):
        cache, _ = side.llama.prefill_cache(cfg, params, cache, side.array(prefixes[i]),
                                            tables[i], 0)
    cache, batched = side.llama.verify_step_cache(cfg, params, cache, side.array(chunks), tables,
                                                  side.array([prefix_len] * b))
    batched = np.asarray(batched, np.float32)
    refs = []
    for i in range(b):
        ref_cache = side.pages(pps + 1)
        ref_table = side.array(np.arange(pps + 1))
        ref_cache, _ = side.llama.prefill_cache(cfg, params, ref_cache,
                                                side.array(prefixes[i]), ref_table, 0)
        _, ref = side.llama.prefill_cache(cfg, params, ref_cache, side.array(chunks[i]),
                                          ref_table, prefix_len, all_logits=True)
        refs.append(np.asarray(ref, np.float32))
        np.testing.assert_allclose(batched[i], refs[-1], rtol=1e-4, atol=1e-4)
    return batched, refs


def quantized_verify_matches_full_precision_closely(side):
    cfg, params = side.cfg, side.params
    prefix = side.array(list(range(2, 10)))
    chunk = side.array([[7, 11, 13]])
    table = side.array(np.arange(4))
    full = side.pages(4, int8=False)
    full, _ = side.llama.prefill_cache(cfg, params, full, prefix, table, 0)
    _, full_logits = side.llama.verify_step_cache(cfg, params, full, chunk, table[None],
                                                  side.array([8]))
    q_cache = side.pages(4, int8=True)
    q_cache, _ = side.llama.prefill_cache(cfg, params, q_cache, prefix, table, 0)
    q_cache, q_logits = side.llama.verify_step_cache(cfg, params, q_cache, chunk, table[None],
                                                     side.array([8]))
    full_logits, q_logits = np.asarray(full_logits), np.asarray(q_logits)
    scale = max(float(np.abs(full_logits).max()), 1.0)
    assert float(np.abs(full_logits - q_logits).max()) < 0.15 * scale
    # The verify wrote quantized rows (position 8 = page 2, slot 0).
    assert np.any(np.asarray(q_cache[0][:, :, 2, 0]))
    return full_logits, q_logits


# -- TestSpeculativeScheduler ------------------------------------------------------


def _batch_matches_plain_scheduler(k):
    def scenario(side):
        prompts = [list(range(5)), list(range(20, 31)), list(range(40, 47))]
        expected = _plain(side, prompts, [8] * 3)
        spec = _spec_scheduler(side, side.pod(n_pages=128), k=k)
        out = _spec_run(spec, prompts, [8] * 3)
        assert out == expected
        assert spec.stats.rounds > 0
        return out, _stats(spec.stats)
    scenario.__name__ = f"batch_matches_plain_scheduler_k{k}"
    return scenario


def perfect_draft_high_acceptance(side):
    prompts = [list(range(3, 10)), list(range(30, 38))]
    expected = _plain(side, prompts, [9, 9])
    spec = _spec_scheduler(side, side.pod(n_pages=128), draft="target", k=3)
    out = _spec_run(spec, prompts, [9, 9])
    assert out == expected
    assert spec.stats.acceptance_rate > 0.5
    return out, _stats(spec.stats)


def staggered_admission_and_finish(side):
    # Budgets differ, so sequences finish at different ticks and later
    # admissions reuse the freed draft slots.
    prompts = [list(range(i * 12, i * 12 + 6)) for i in range(5)]
    budgets = [3, 9, 5, 7, 4]
    expected = _plain(side, prompts, budgets, max_batch=2)
    spec = _spec_scheduler(side, side.pod(n_pages=128), max_batch=2)
    out = _spec_run(spec, prompts, budgets)
    assert out == expected
    return out, _stats(spec.stats)


def preemption_under_page_pressure(side):
    spec = _spec_scheduler(side, side.pod(n_pages=16))
    ids = [spec.submit(list(range(i * 30, i * 30 + 20)), max_new_tokens=8) for i in range(3)]
    ticks, results = 0, {}
    while spec.has_work:
        for req in spec.step():
            results[req.req_id] = req
        ticks += 1
        assert ticks < 500, "speculative scheduler livelocked"
    for rid in ids:
        assert results[rid].error is None and len(results[rid].generated) == 8
    return ticks, [results[i].generated for i in ids], _stats(spec.stats)


def pool_exhaustion_preempts_not_crashes(side):
    prompts = [list(range(18)), list(range(30, 48))]
    expected = _plain(side, prompts, [12, 12], n_pages=12)
    spec = _spec_scheduler(side, side.pod(n_pages=12))
    out = _spec_run(spec, prompts, [12, 12])
    assert out == expected
    return out, _stats(spec.stats)


def quantized_pod_matches_plain_quantized_scheduler(side):
    prompts = [list(range(5)), list(range(20, 31))]
    plain = side.scheduler(side.pod(n_pages=128, int8=True), max_batch=4)
    pids = [plain.submit(p, max_new_tokens=8) for p in prompts]
    pres = plain.run()
    spec = _spec_scheduler(side, side.pod(n_pages=128, int8=True))
    out = _spec_run(spec, prompts, [8, 8])
    assert out == [pres[i] for i in pids]
    assert spec.stats.proposed > 0
    return out, _stats(spec.stats)


def short_budget_does_not_collapse_batch_speculation(side):
    # A sequence one token from its budget must not drag the batch's chunk
    # width to 0: with per-sequence masking the long one keeps proposing.
    prompts = [list(range(5)), list(range(20, 28))]
    expected = _plain(side, prompts, [2, 12])
    spec = _spec_scheduler(side, side.pod(n_pages=128), draft="target")
    out = _spec_run(spec, prompts, [2, 12])
    assert out == expected
    assert spec.stats.accepted >= 6
    return out, _stats(spec.stats)


def perfect_draft_full_acceptance_after_hole_fix(side):
    # The draft's final proposal KV must be ingested, or a fully accepted
    # round leaves a zero-KV hole that degrades later proposals.
    spec = _spec_scheduler(side, side.pod(n_pages=128), draft="target")
    out = _spec_run(spec, [list(range(3, 10))], [12])
    assert spec.stats.proposed > 0
    assert spec.stats.acceptance_rate == 1.0
    return out, _stats(spec.stats)


# -- TestServingSampling's speculative tests ----------------------------------------


def spec_decoder_speculative_sampling(side):
    """Seeded runs reproduce; temperature 0 equals greedy speculation; a
    draft equal to the target accepts every proposal (q == p); unseeded
    calls of one decoder draw independent streams."""
    sp = side.SamplingParams(temperature=1.0, top_k=50, seed=21)

    def spec_generate(sampling, draft="draft5"):
        dec = _decoder(side, side.pod(), draft=draft, k=3)
        return dec.generate(list(SAMPLING_PROMPT), max_new_tokens=10, sampling=sampling), dec.stats

    out1, stats1 = spec_generate(sp)
    out2, _ = spec_generate(sp)
    assert out1 == out2 and len(out1) == 10
    greedy_spec, _ = spec_generate(side.SamplingParams())
    greedy_plain, _ = spec_generate(None)
    sched = side.scheduler(side.pod(), max_batch=2)
    rid = sched.submit(list(SAMPLING_PROMPT), max_new_tokens=10)
    assert greedy_spec == greedy_plain == sched.run()[rid]
    _, perfect = spec_generate(sp, draft="target")
    assert perfect.proposed > 0 and perfect.accepted == perfect.proposed

    dec = _decoder(side, side.pod(), k=3)
    unseeded = side.SamplingParams(temperature=3.0)
    outs = [dec.generate(list(SAMPLING_PROMPT), max_new_tokens=8, sampling=unseeded)
            for _ in range(3)]
    assert len({tuple(o) for o in outs}) > 1
    return out1, _stats(stats1), greedy_spec, _stats(perfect), outs, _stats(dec.stats)


def batched_speculative_sampling(side):
    """Seeded runs reproduce; a greedy request mixed into the batch matches
    the plain scheduler's greedy output; a perfect draft accepts every
    sampled proposal."""
    sp = side.SamplingParams(temperature=1.0, top_k=50, seed=33)

    def spec_run(draft="draft5"):
        spec = _spec_scheduler(side, side.pod(), draft=draft, k=2)
        rid_s = spec.submit(list(SAMPLING_PROMPT), max_new_tokens=10, sampling=sp)
        rid_g = spec.submit([5, 9, 2, 44], max_new_tokens=10)
        res = spec.run()
        return res[rid_s], res[rid_g], spec.stats

    s1, g1, stats1 = spec_run()
    s2, g2, _ = spec_run()
    assert s1 == s2 and g1 == g2 and len(s1) == 10
    sched = side.scheduler(side.pod(), max_batch=1)
    rid = sched.submit([5, 9, 2, 44], max_new_tokens=10)
    assert g1 == sched.run()[rid]
    _, _, perfect = spec_run(draft="target")
    assert perfect.proposed > 0 and perfect.accepted == perfect.proposed
    return s1, g1, _stats(stats1), _stats(perfect)


# Scenario -> page formats (False: model-dtype pages, True: int8). Those that
# compare the formats themselves, or fix int8, run once; so does the
# full-acceptance check, which needs the target's cache to hold the draft's
# own K/V (on int8 pages the target attends quantized rows, the draft its
# model-dtype ones, and both packages then reject a few proposals).
SCENARIOS = {fn.__name__: (fn, formats) for fn, formats in [
    *[(_weak_draft_output_identical(k), (False, True)) for k in (1, 3, 4)],
    (perfect_draft_accepts_everything, (False, True)),
    (eos_stops_generation, (False, True)),
    (pages_fully_released_after_generation, (False, True)),
    (prefix_cache_only_advertises_accepted_tokens, (False, True)),
    (page_capacity_boundary_completes, (False, True)),
    (rejects_k_zero_and_adapter_pods, (False,)),
    (verify_matches_per_sequence_prefill, (False, True)),
    (quantized_verify_matches_full_precision_closely, (False,)),
    *[(_batch_matches_plain_scheduler(k), (False, True)) for k in (1, 3)],
    (perfect_draft_high_acceptance, (False, True)),
    (staggered_admission_and_finish, (False, True)),
    (preemption_under_page_pressure, (False, True)),
    (pool_exhaustion_preempts_not_crashes, (False, True)),
    (quantized_pod_matches_plain_quantized_scheduler, (True,)),
    (short_budget_does_not_collapse_batch_speculation, (False, True)),
    (perfect_draft_full_acceptance_after_hole_fix, (False,)),
    (spec_decoder_speculative_sampling, (False, True)),
    (batched_speculative_sampling, (False, True)),
]}
CASES = [(name, int8) for name, (_, formats) in SCENARIOS.items() for int8 in formats]


@pytest.mark.parametrize("scenario, int8", CASES,
                         ids=[f"{n}-{'int8' if i else 'f32'}_pages" for n, i in CASES])
def test_speculative_matches_jax(scenario, int8):
    run_both(SCENARIOS[scenario][0], int8)


def test_accept_or_resample_preserves_target_distribution():
    """The acceptance rule's emitted-token law is q whatever the draft p:
    20k trials on a fixed (q, p) pair (the JAX test's, on the port alone,
    at its tolerance)."""
    vocab, n = 12, 20000
    rng = np.random.default_rng(0)
    q = rng.dirichlet(np.ones(vocab) * 0.5)
    p = rng.dirichlet(np.ones(vocab) * 0.5)
    qt = torch.tensor(q, dtype=torch.float32)
    pt = torch.tensor(p, dtype=torch.float32)
    trials = torch.arange(n, dtype=torch.int32)
    keys = sampling.position_keys(sampling.prng_key(3, "cpu").expand(n, 2), trials)
    # Proposals drawn from p on an independent stream (categorical: the
    # argmax of log p plus Gumbel noise).
    prop_keys = sampling.position_keys(sampling.prng_key(4, "cpu").expand(n, 2), trials)
    proposals = torch.argmax(torch.log(pt) + sampling.gumbel_noise(prop_keys, vocab), dim=-1)
    tokens, accepted = sampling.accept_or_resample(qt, pt, proposals, keys)
    empirical = np.bincount(tokens.numpy(), minlength=vocab) / n
    tv = 0.5 * np.abs(empirical - q).sum()
    assert tv < 0.02, (tv, empirical, q)
    # The acceptance rate equals sum_x min(q, p) in expectation.
    assert abs(float(accepted.float().mean()) - np.minimum(q, p).sum()) < 0.02


def test_one_read_back_per_round_and_tick():
    """The decoder reads one tensor back a round and the scheduler one a
    decode tick (the draft's proposals stay on the device)."""
    side = _Side("port")
    dec = _decoder(side, side.pod(), k=3)
    before = speculative.read_backs
    dec.generate(list(range(2, 13)), max_new_tokens=10)
    assert speculative.read_backs - before == dec.stats.rounds
    spec = _spec_scheduler(side, side.pod(n_pages=128))
    before = speculative.read_backs
    _spec_run(spec, [list(range(5)), list(range(20, 31))], [8, 8])
    assert speculative.read_backs - before == spec.stats.rounds
