"""The port's continuous-batching Scheduler against the JAX package's.

Each scenario below is one test of the JAX package's `tests/test_scheduler.py`
or `TestServingSampling` (`tests/test_sampling.py`), the speculative ones
excepted. It runs twice: the JAX Scheduler on JAX pods, and the port's
Scheduler on port pods (device="cpu", f32) built from the same parameter
tree. Both must give the same result (generated tokens, sampled ones
included, plus what the scenario observes: cached-token counts, queue
states, rejection reasons, decode shapes) and the same BlockStored /
BlockRemoved stream on every pod; the scenario's own assertions hold the
port's run too. Each scenario runs on model-dtype and int8 pages, at
decode_steps 1 and 4 (a scenario that fixes decode_steps keeps its own).
"""

import contextlib

import jax.numpy as jnp
import pytest
import torch

from test_torch_engine import _event_rows, _PodPair

from llm_d_kv_cache_manager_tpu.engine.scheduler import Scheduler as JaxScheduler
from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from llm_d_kv_cache_manager_tpu_torch.engine.scheduler import Scheduler
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.ops.sampling import SamplingParams

SAMPLING_PROMPT = [3, 17, 99, 4, 250 % 128, 7]  # test_sampling.py's PROMPT


class _Side:
    """One package's view of a scenario: its pods (twins of the other
    side's, in creation order), Scheduler, SamplingParams and llama module."""

    def __init__(self, name, harness):
        self.name, self._harness, self._next = name, harness, 0
        jax_side = name == "jax"
        self.Scheduler = JaxScheduler if jax_side else Scheduler
        self.SamplingParams = JaxSamplingParams if jax_side else SamplingParams
        self.llama = jax_llama if jax_side else llama
        self._argmax = jnp.argmax if jax_side else torch.argmax

    def pod(self, n_pages=64, max_pages_per_seq=16):
        pairs = self._harness.pairs
        if self._next == len(pairs):
            pairs.append(_PodPair(n_pages, max_pages_per_seq, self._harness.int8,
                                  self._harness.n_layers))
        pair = pairs[self._next]
        self._next += 1
        return pair.jax if self.name == "jax" else pair.port

    def scheduler(self, pod, **kwargs):
        kwargs.setdefault("decode_steps", self._harness.decode_steps)
        return self.Scheduler(pod, **kwargs)

    def isolated(self, prompt, n_new):
        """One sequence alone on a fresh pod: prefill, then greedy steps."""
        pod = self.pod()
        state, _ = pod.prefill(list(prompt))
        first = int(self._argmax(pod.last_logits))
        pod.decode_append(state, first)
        out = [first] + [pod.decode_step(state) for _ in range(n_new - 1)]
        pod.free(state)
        return out

    def generate(self, sampling, decode_steps=1, n_new=12, prompt=None):
        """test_sampling.py's `_generate`: one request on a fresh pod."""
        sched = self.scheduler(self.pod(), max_batch=2, decode_steps=decode_steps)
        rid = sched.submit(list(prompt or SAMPLING_PROMPT), max_new_tokens=n_new,
                           sampling=sampling)
        return sched.run()[rid]

    @contextlib.contextmanager
    def spy(self, *names):
        """Count the calls of this side's llama functions `names` (looked up
        by the pods and schedulers at call time) and record their argument
        shapes: {name: [shape of args 3 and 4 per call]}."""
        calls = {name: [] for name in names}
        originals = {name: getattr(self.llama, name) for name in names}

        def wrap(name):
            def spy(*args, **kwargs):
                calls[name].append((tuple(args[3].shape), tuple(args[4].shape)))
                return originals[name](*args, **kwargs)
            return spy

        for name in names:
            setattr(self.llama, name, wrap(name))
        try:
            yield calls
        finally:
            for name, fn in originals.items():
                setattr(self.llama, name, fn)


class _Harness:
    def __init__(self, int8, decode_steps, n_layers):
        self.int8, self.decode_steps, self.n_layers = int8, decode_steps, n_layers
        self.pairs = []

    def run(self, scenario):
        results = {}
        for name in ("jax", "port"):
            results[name] = scenario(_Side(name, self))
        return results


# -- tests/test_scheduler.py ---------------------------------------------------


def batched_equals_isolated(side):
    prompts = [list(range(5)), list(range(20, 31)), list(range(40, 47))]
    expected = [side.isolated(p, 6) for p in prompts]
    sched = side.scheduler(side.pod(), max_batch=4)
    ids = [sched.submit(p, max_new_tokens=6) for p in prompts]
    results = sched.run()
    assert [results[i] for i in ids] == expected
    return results


def admission_waits_for_pages(side):
    sched = side.scheduler(side.pod(n_pages=10), max_batch=4)
    ids = [sched.submit(list(range(i * 10, i * 10 + 8)), max_new_tokens=4) for i in range(3)]
    results = sched.run()
    assert all(len(results[i]) == 4 for i in ids)
    return results


def oversized_request_fails_cleanly(side):
    sched = side.scheduler(side.pod(n_pages=4), max_batch=2)
    too_big = sched.submit(list(range(40)), max_new_tokens=2)
    ok = sched.submit(list(range(6)), max_new_tokens=2)
    first_tick = sched.step()
    errors = {r.req_id: r.error for r in first_tick}
    assert "pages" in errors[too_big]
    results = {r.req_id: r.generated for r in first_tick if r.error is None}
    results.update(sched.run())
    assert len(results[ok]) == 2
    return errors, results


def zero_max_new_tokens_rejected(side):
    sched = side.scheduler(side.pod(), max_batch=1)
    req = sched.submit(list(range(4)), max_new_tokens=0)
    first_tick = sched.step()
    assert first_tick[0].generated == [] and not sched.has_work
    return req, first_tick[0].error


def decode_preemption_recomputes_correctly(side):
    prompts = [list(range(8)), list(range(50, 58))]
    expected = [side.isolated(p, 8) for p in prompts]
    sched = side.scheduler(side.pod(n_pages=7), max_batch=2)
    ids = [sched.submit(p, max_new_tokens=8) for p in prompts]
    results = sched.run()
    assert [results[i] for i in ids] == expected
    return results


def prefix_reuse_across_requests(side):
    pod = side.pod()
    sched = side.scheduler(pod, max_batch=2)
    prompt = list(range(12))
    sched.submit(prompt, max_new_tokens=3)
    first = sched.run()
    again = sched.submit(prompt, max_new_tokens=3)
    results = sched.run()
    assert len(results[again]) == 3
    assert pod.block_manager.num_cached_pages > 0
    return first, results, pod.block_manager.num_cached_pages


def pending_page_not_reused_by_same_prefix_admission(side):
    sched = side.scheduler(side.pod(), max_batch=2, decode_steps=1)
    sched.submit(list(range(4)), max_new_tokens=10)
    sched.step()
    a_req = sched._running[0]
    while len(a_req.state.tokens) < 8:
        sched.step()
    prompt_b = list(a_req.state.tokens)
    b = sched.submit(prompt_b, max_new_tokens=4)
    sched.step()  # admits B before the decode that writes A's pending row
    b_req = next(r for r in sched._running if r.req_id == b)
    assert b_req.num_cached_tokens == 4  # the pending page is not advertised
    results = sched.run()
    assert results[b] == side.isolated(prompt_b, 4)
    return results, b_req.num_cached_tokens


def eos_stops_generation(side):
    probe = side.isolated(list(range(8)), 1)[0]
    sched = side.scheduler(side.pod(), max_batch=1)
    req = sched.submit(list(range(8)), max_new_tokens=10, eos_token=probe)
    results = sched.run()
    assert results[req] == [probe]
    return results


def decode_shapes_bounded_by_batch_buckets(side):
    """The JAX compile-count test: as the batch shrinks from 8 to 1, the
    decode calls see at most 4 batch sizes (8, 4, 2, 1)."""
    sched = side.scheduler(side.pod(n_pages=128), max_batch=8)
    for i in range(8):
        sched.submit(list(range(i * 16, i * 16 + 4)), max_new_tokens=2 + i)
    with side.spy("decode_step_cache", "decode_multi_step_cache") as calls:
        results = sched.run()
    shapes = calls["decode_step_cache"] + calls["decode_multi_step_cache"]
    batch_sizes = {tokens[0] for tokens, _ in shapes}
    assert batch_sizes <= {8, 4, 2, 1} and 8 in batch_sizes
    assert all(table[0] == tokens[0] for tokens, table in shapes)
    return results, sorted(set(shapes))


def padded_batch_output_identical(side):
    prompts = [list(range(i * 16, i * 16 + 5)) for i in range(3)]  # pads to 4
    expected = [side.isolated(p, 5) for p in prompts]
    sched = side.scheduler(side.pod(n_pages=128), max_batch=4)
    ids = [sched.submit(p, max_new_tokens=5) for p in prompts]
    results = sched.run()
    assert [results[i] for i in ids] == expected
    return results


def chunked_equals_unchunked(side):
    prompt = list(range(2, 50))  # 48 tokens: 6 chunks at budget 8
    outs = []
    for budget in (4096, 8):
        sched = side.scheduler(side.pod(), prefill_token_budget=budget)
        rid = sched.submit(prompt, max_new_tokens=6)
        outs.append(sched.run()[rid])
    assert outs[0] == outs[1] and len(outs[0]) == 6
    return outs


def long_prompt_does_not_stall_decode(side):
    sched = side.scheduler(side.pod(n_pages=128), max_batch=4, prefill_token_budget=8,
                           decode_steps=1)
    sched.submit(list(range(5)), max_new_tokens=40)
    sched.step()
    assert len(sched._running) == 1
    short_req = sched._running[0]
    long_id = sched.submit(list(range(60, 108)), max_new_tokens=2)  # 48 tokens
    ticks, done = 0, {}
    while long_id not in done:
        gen_before = len(short_req.generated)
        done.update({r.req_id: r.generated for r in sched.step()})
        ticks += 1
        assert len(short_req.generated) == gen_before + 1  # decoded every tick
        assert ticks < 20
    assert ticks >= 48 // 8
    return ticks, done, list(short_req.generated)


def budget_packs_multiple_short_prompts_in_one_tick(side):
    sched = side.scheduler(side.pod(), max_batch=4, prefill_token_budget=512,
                           decode_steps=1)
    for i in range(3):
        sched.submit(list(range(i * 10, i * 10 + 8)), max_new_tokens=4)
    sched.step()
    assert len(sched._running) == 3
    return [r.generated for r in sched._running], sched.run()


def same_prefix_wave_flushes_and_reuses(side):
    prompt = list(range(12))
    expected = side.isolated(prompt, 4)
    sched = side.scheduler(side.pod(), max_batch=4, prefill_token_budget=512)
    a = sched.submit(prompt, max_new_tokens=4)
    b = sched.submit(prompt, max_new_tokens=4)
    results = {r.req_id: r.generated for r in sched.step()}
    b_req = sched._waiting[0] if sched._waiting else None
    assert b_req is not None and b_req.req_id == b  # deferred one tick
    results.update({r.req_id: r.generated for r in sched.step()})
    assert b_req.num_cached_tokens >= 8
    results.update(sched.run())
    assert results[a] == results[b] == expected
    return results, b_req.num_cached_tokens


def resumed_prompt_guards_same_prefix_arrival(side):
    prompt = list(range(12))
    expected = side.isolated(prompt, 3)
    sched = side.scheduler(side.pod(), max_batch=4, prefill_token_budget=8)
    a = sched.submit(prompt, max_new_tokens=3)
    b = sched.submit(prompt, max_new_tokens=3)
    results = {}
    for _ in range(2):
        results.update({r.req_id: r.generated for r in sched.step()})
    b_req = next(r for r in list(sched._waiting) + sched._running if r.req_id == b)
    while sched.has_work:
        results.update({r.req_id: r.generated for r in sched.step()})
    assert b_req.num_cached_tokens >= 8
    assert results[a] == results[b] == expected
    return results, b_req.num_cached_tokens


def packed_prefill_is_one_dispatch_and_identical(side):
    prompts = [list(range(i * 16, i * 16 + 6)) for i in range(4)]
    expected = [side.isolated(p, 4) for p in prompts]
    sched = side.scheduler(side.pod(), max_batch=4, prefill_token_budget=512)
    ids = [sched.submit(p, max_new_tokens=4) for p in prompts]
    with side.spy("verify_step_cache", "prefill_cache") as calls:
        results = {r.req_id: r.generated for r in sched.step()}  # the admission wave
    assert len(calls["verify_step_cache"]) == 1 and not calls["prefill_cache"]
    results.update(sched.run())
    assert [results[i] for i in ids] == expected
    return results, calls["verify_step_cache"]


def budget_validation(side):
    messages = []
    for kwargs in (dict(prefill_token_budget=0), dict(decode_steps=0)):
        with pytest.raises(ValueError) as err:
            side.Scheduler(side.pod(), **kwargs)
        messages.append(str(err.value))
    assert "prefill_token_budget" in messages[0] and "decode_steps" in messages[1]
    return messages


def preemption_never_starves_mid_prefill_head(side):
    sched = side.scheduler(side.pod(n_pages=16), max_batch=4, prefill_token_budget=4)
    ids = [sched.submit(list(range(i * 30, i * 30 + 20)), max_new_tokens=8)
           for i in range(3)]
    ticks, results = 0, {}
    while sched.has_work:
        results.update({r.req_id: r for r in sched.step()})
        ticks += 1
        assert ticks < 500, "scheduler livelocked under page pressure"
    assert all(results[i].error is None and len(results[i].generated) == 8 for i in ids)
    return ticks, {i: r.generated for i, r in results.items()}


# -- TestServingSampling (tests/test_sampling.py) ------------------------------


def greedy_default_unchanged(side):
    out = side.generate(None)
    assert out == side.generate(side.SamplingParams())
    return out


def seeded_runs_reproduce(side):
    sp = side.SamplingParams(temperature=1.0, top_k=20, seed=42)
    out = side.generate(sp)
    assert out == side.generate(sp)
    return out


def decode_steps_invariant(side):
    sp = side.SamplingParams(temperature=1.0, top_k=20, seed=7)
    out = side.generate(sp, decode_steps=1)
    assert out == side.generate(sp, decode_steps=4)
    return out


def seeds_differentiate(side):
    outs = [side.generate(side.SamplingParams(temperature=2.0, seed=s)) for s in range(5)]
    assert len({tuple(o) for o in outs}) > 1
    return outs


def sampled_differs_from_greedy_sometimes(side):
    greedy = side.generate(None)
    outs = [side.generate(side.SamplingParams(temperature=3.0, seed=s)) for s in range(4)]
    assert any(o != greedy for o in outs)
    return greedy, outs


def mixed_batch_greedy_row_unperturbed(side):
    sched = side.scheduler(side.pod(), max_batch=4, decode_steps=2)
    rid_g = sched.submit(list(SAMPLING_PROMPT), max_new_tokens=10)
    rid_s = sched.submit([5, 9, 2, 44], max_new_tokens=10,
                         sampling=side.SamplingParams(temperature=1.5, seed=3))
    results = sched.run()
    assert results[rid_g] == side.generate(None, n_new=10)
    assert len(results[rid_s]) == 10
    return results


def preemption_does_not_change_sampled_output(side):
    sp = side.SamplingParams(temperature=1.0, top_k=30, seed=11)
    reference = side.generate(sp, n_new=10)
    sched = side.scheduler(side.pod(n_pages=10, max_pages_per_seq=8), max_batch=2)
    rid = sched.submit(list(SAMPLING_PROMPT), max_new_tokens=10, sampling=sp)
    other = sched.submit([8, 1, 60], max_new_tokens=10)
    preempt = sched._preempt
    preempted = []
    sched._preempt = lambda req: (preempted.append(req.req_id), preempt(req))
    results = sched.run()
    assert results[rid] == reference and len(results[other]) == 10
    # This pool (the JAX test's) holds both requests whole, so nothing is
    # preempted; test_mixed_traffic_with_preemption_matches_jax forces it.
    return results, preempted


SCENARIOS = {  # name -> (scenario, model layers: 1 as test_scheduler.py, 2 as test_sampling.py)
    fn.__name__: (fn, layers)
    for layers, fns in (
        (1, [batched_equals_isolated, admission_waits_for_pages,
             oversized_request_fails_cleanly, zero_max_new_tokens_rejected,
             decode_preemption_recomputes_correctly, prefix_reuse_across_requests,
             pending_page_not_reused_by_same_prefix_admission, eos_stops_generation,
             decode_shapes_bounded_by_batch_buckets, padded_batch_output_identical,
             chunked_equals_unchunked, long_prompt_does_not_stall_decode,
             budget_packs_multiple_short_prompts_in_one_tick,
             same_prefix_wave_flushes_and_reuses, resumed_prompt_guards_same_prefix_arrival,
             packed_prefill_is_one_dispatch_and_identical, budget_validation,
             preemption_never_starves_mid_prefill_head]),
        (2, [greedy_default_unchanged, seeded_runs_reproduce, decode_steps_invariant,
             seeds_differentiate, sampled_differs_from_greedy_sometimes,
             mixed_batch_greedy_row_unperturbed, preemption_does_not_change_sampled_output]),
    )
    for fn in fns
}


@pytest.mark.parametrize("decode_steps", [1, 4], ids=["steps1", "steps4"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32_pages", "int8_pages"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scheduler_matches_jax(scenario, int8, decode_steps):
    fn, n_layers = SCENARIOS[scenario]
    harness = _Harness(int8, decode_steps, n_layers)
    results = harness.run(fn)
    assert results["port"] == results["jax"]
    for pair in harness.pairs:
        assert _event_rows(pair.port_events) == _event_rows(pair.jax_events)


def test_mixed_traffic_with_preemption_matches_jax():
    """The chip smoke's small mixed run on the CPU: greedy and sampled
    requests (top_k 0 or 20, top_p 0.9), two sharing a two-page prefix, a
    pool that forces preemption; decode_steps 1 and 4 give the same tokens."""
    prefix = list(range(100, 108))
    prompts = [prefix + [1, 2, 3], prefix + [9, 8, 7, 6, 5], list(range(20, 33)),
               list(range(40, 46)), list(range(60, 75)), list(range(80, 84))]
    samplings = [None, dict(temperature=0.8, top_k=20, top_p=0.9, seed=1), None,
                 dict(temperature=1.5, top_k=0, top_p=0.9, seed=2), None,
                 dict(temperature=1.1, top_k=20, top_p=0.9, seed=3)]

    def scenario(side):
        runs = []
        for steps in (1, 4):
            sched = side.scheduler(side.pod(n_pages=12), max_batch=4,
                                   prefill_token_budget=8, decode_steps=steps)
            preempted = []
            preempt = sched._preempt
            sched._preempt = lambda req: (preempted.append(req.req_id), preempt(req))
            ids = [sched.submit(p, max_new_tokens=10,
                                sampling=None if s is None else side.SamplingParams(**s))
                   for p, s in zip(prompts, samplings)]
            results = sched.run()
            runs.append(([results[i] for i in ids], preempted))
        assert runs[0][0] == runs[1][0]
        assert runs[0][1] and runs[1][1]
        return runs

    for int8 in (False, True):
        harness = _Harness(int8, 1, 1)
        results = harness.run(scenario)
        assert results["port"] == results["jax"]
        for pair in harness.pairs:
            assert _event_rows(pair.port_events) == _event_rows(pair.jax_events)


def test_lora_ids_are_rejected_without_adapters():
    """A pod with no adapter stack rejects a LoRA request at submit, with the
    JAX package's reason, and its hooks report no stack and no prefetch."""
    harness = _Harness(False, 1, 1)

    def scenario(side):
        pod = side.pod()
        sched = side.scheduler(pod)
        rid = sched.submit(list(range(6)), max_new_tokens=2, lora_id=3)
        (req,) = sched.step()
        assert req.req_id == rid and req.generated == [] and "LoRA" in req.error
        assert pod.lora_index(None) == 0
        return req.error, pod.lora_for_decode([None, None]), pod.prefetch([1, 2], None)

    results = harness.run(scenario)
    assert results["port"] == results["jax"]
    assert results["port"][1:] == (None, 0)
