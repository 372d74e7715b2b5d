"""The port's multi-LoRA serving against the JAX package's.

`models/lora.py` and its plumbing (the `lora=` arguments of `models/llama.py`,
the pod's adapter registry, the scheduler's per-row adapters) on the same
inputs as the JAX package: the delta math within 1e-5 relative, the llama
entry points with mixed adapters within 1e-4 on both page formats, and every
test of `tests/test_lora_serving.py` as a scenario run on JAX pods and port
pods (device="cpu", f32) built from one parameter tree, with adapters carried
across by `lora.lora_from_jax`. Both runs must give the same result (tokens,
cached-token counts, rejection reasons, speculative stats; logits within
1e-4) and the same BlockStored / BlockRemoved stream on every pod, and the
scenario's own assertions hold on the port's run too.

`_Side` builds either package's pods; `tests/test_torch_speculative.py`
runs its scenarios through it as well.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import _event_rows

from llm_d_kv_cache_manager_tpu.engine import speculative as jax_speculative
from llm_d_kv_cache_manager_tpu.engine.engine import (
    EnginePod as JaxEnginePod,
    EnginePodConfig as JaxEnginePodConfig,
)
from llm_d_kv_cache_manager_tpu.engine.scheduler import Scheduler as JaxScheduler
from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu.models import lora as jax_lora
from llm_d_kv_cache_manager_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from llm_d_kv_cache_manager_tpu_torch.engine import speculative
from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig
from llm_d_kv_cache_manager_tpu_torch.engine.scheduler import Scheduler
from llm_d_kv_cache_manager_tpu_torch.models import llama, lora
from llm_d_kv_cache_manager_tpu_torch.ops.sampling import SamplingParams

PAGE = 4
# The JAX tests' target (test_lora_serving.py, test_speculative.py,
# test_sampling.py) and their small draft.
TARGET = dict(vocab_size=128, d_model=32, n_layers=2, n_q_heads=2, n_kv_heads=2, head_dim=16,
              d_ff=64)
DRAFT = dict(vocab_size=128, d_model=16, n_layers=1, n_q_heads=2, n_kv_heads=2, head_dim=8,
             d_ff=32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _Model:
    """One model (config, params) in both packages, from a JAX PRNG seed."""

    def __init__(self, shape, seed):
        self.jax_cfg = jax_llama.LlamaConfig(**shape, dtype=jnp.float32)
        self.jax_params = jax_llama.init_params(self.jax_cfg, jax.random.PRNGKey(seed))
        self.cfg = llama.LlamaConfig(**shape, dtype=torch.float32)
        self.params = llama.params_from_jax(_np(self.jax_params), device="cpu")

    def side(self, name):
        return (self.jax_cfg, self.jax_params) if name == "jax" else (self.cfg, self.params)


MODELS = {"target": _Model(TARGET, 0), "draft5": _Model(DRAFT, 5), "draft9": _Model(DRAFT, 9)}
_TARGET_CFG = MODELS["target"].jax_cfg
JAX_ADAPTERS = {
    "A": jax_lora.make_test_adapter(_TARGET_CFG, rank=4, key=jax.random.PRNGKey(1)),
    "B": jax_lora.make_test_adapter(_TARGET_CFG, rank=4, key=jax.random.PRNGKey(2)),
}
PORT_ADAPTERS = {name: lora.lora_from_jax(_np(a), "cpu") for name, a in JAX_ADAPTERS.items()}


class _Side:
    """One package's view of a scenario: its modules, the target model, the
    adapters, and every pod it builds (each pod's event batches are kept,
    in creation order, for the comparison with the other package's)."""

    def __init__(self, name, int8=False, decode_steps=1):
        self.name, self.int8, self.decode_steps = name, int8, decode_steps
        jax_side = name == "jax"
        self.llama = jax_llama if jax_side else llama
        self.lora = jax_lora if jax_side else lora
        self.speculative = jax_speculative if jax_side else speculative
        self.Scheduler = JaxScheduler if jax_side else Scheduler
        self.SamplingParams = JaxSamplingParams if jax_side else SamplingParams
        self.argmax = jnp.argmax if jax_side else torch.argmax
        self.cfg, self.params = MODELS["target"].side(name)
        self.events = []

    def model(self, name):
        """(config, params) of MODELS[name] in this package."""
        return MODELS[name].side(self.name)

    def adapter(self, name):
        return (JAX_ADAPTERS if self.name == "jax" else PORT_ADAPTERS)[name]

    def pod(self, params=None, adapters=None, n_pages=64, max_pages_per_seq=16, int8=None):
        """A target pod (`params` default: the target's) serving `adapters`
        ({lora_id: adapter name or this package's adapter})."""
        int8 = self.int8 if int8 is None else int8
        events = []
        self.events.append(events)
        if adapters:
            adapters = {lid: self.adapter(a) if isinstance(a, str) else a
                        for lid, a in adapters.items()}
        params = self.params if params is None else params
        if self.name == "jax":
            return JaxEnginePod(
                JaxEnginePodConfig(n_pages=n_pages, page_size=PAGE, with_model=True,
                                   model_config=self.cfg, max_pages_per_seq=max_pages_per_seq,
                                   device_tier="gpu", use_quantized_kv=int8),
                event_sink=events.append, params=params, lora_adapters=adapters)
        return EnginePod(
            EnginePodConfig(n_pages=n_pages, page_size=PAGE, max_pages_per_seq=max_pages_per_seq,
                            device_tier="gpu", device="cpu", model_config=self.cfg,
                            use_quantized_kv=int8),
            event_sink=events.append, params=params, lora_adapters=adapters)

    def scheduler(self, pod, **kwargs):
        kwargs.setdefault("decode_steps", self.decode_steps)
        return self.Scheduler(pod, **kwargs)

    def pages(self, n_pages, cfg=None, int8=None):
        cfg = self.cfg if cfg is None else cfg
        int8 = self.int8 if int8 is None else int8
        make = self.llama.make_kv_pages_quantized if int8 else self.llama.make_kv_pages
        return make(cfg, n_pages, PAGE) if self.name == "jax" else make(cfg, n_pages, PAGE, "cpu")

    def array(self, values, dtype=np.int32):
        arr = np.asarray(values, dtype=dtype)
        return jnp.asarray(arr) if self.name == "jax" else torch.from_numpy(arr)

    def isolated(self, prompt, n_new, params=None, eos=None):
        """One sequence alone on a fresh pod: prefill, then greedy steps
        (stopping after `eos` if given)."""
        pod = self.pod(params=params)
        state, _ = pod.prefill(list(prompt))
        out = [int(self.argmax(pod.last_logits))]
        pod.decode_append(state, out[0])
        while len(out) < n_new and (eos is None or out[-1] != eos):
            out.append(pod.decode_step(state))
        pod.free(state)
        return out


def _stats(stats):
    return dataclasses.astuple(stats)


def _assert_same(port, ref, path="result"):
    """Equal results, numpy arrays within 1e-4 (absolute or relative)."""
    if isinstance(ref, np.ndarray):
        np.testing.assert_allclose(np.asarray(port), ref, rtol=1e-4, atol=1e-4, err_msg=path)
    elif isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            _assert_same(p, r, f"{path}[{i}]")
    elif isinstance(ref, dict):
        assert port.keys() == ref.keys(), path
        for key in ref:
            _assert_same(port[key], ref[key], f"{path}[{key!r}]")
    else:
        assert port == ref, f"{path}: {port!r} != {ref!r}"


def run_both(scenario, int8=False, decode_steps=1):
    """Run `scenario` on both packages; the results and every pod's event
    stream must agree. Returns the port's result."""
    sides = {name: _Side(name, int8, decode_steps) for name in ("jax", "port")}
    results = {name: scenario(side) for name, side in sides.items()}
    _assert_same(results["port"], results["jax"])
    port_events = [_event_rows(e) for e in sides["port"].events]
    assert port_events == [_event_rows(e) for e in sides["jax"].events]
    return results["port"]


# -- the delta math ---------------------------------------------------------------


def _random_adapter(rng, n_layers, d, r, q_dim, kv_dim):
    return {"wq_a": rng.standard_normal((n_layers, d, r)), "wq_b": rng.standard_normal((n_layers, r, q_dim)),
            "wv_a": rng.standard_normal((n_layers, d, r)), "wv_b": rng.standard_normal((n_layers, r, kv_dim))}


def _f32(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


def _close(got, want, rtol=1e-5):
    """Within `rtol` of the largest |want|: the products round in different
    orders on the two packages."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("batch, seq", [(1, 7), (3, 1), (4, 5)])
def test_decode_delta_matches_jax(batch, seq):
    rng = np.random.default_rng(batch * 10 + seq)
    h = rng.standard_normal((batch, seq, 32)).astype(np.float32)
    lo = _f32(_random_adapter(rng, batch, 32, 4, 24, 16))  # [B, d, r] / [B, r, out]
    want = jax_lora.apply_decode_delta(jnp.asarray(h), {k: jnp.asarray(v) for k, v in lo.items()})
    got = lora.apply_decode_delta(torch.from_numpy(h), {k: torch.from_numpy(v) for k, v in lo.items()})
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("length", [1, 9])
def test_prefill_delta_matches_jax(length):
    rng = np.random.default_rng(length)
    h = rng.standard_normal((1, length, 32)).astype(np.float32)
    lo = _f32({k: v[0] for k, v in _random_adapter(rng, 1, 32, 8, 32, 16).items()})
    want = jax_lora.apply_prefill_delta(jnp.asarray(h), {k: jnp.asarray(v) for k, v in lo.items()})
    got = lora.apply_prefill_delta(torch.from_numpy(h), {k: torch.from_numpy(v) for k, v in lo.items()})
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def _random_stacks(rng, n_adapters=3):
    adapters = [_f32(_random_adapter(rng, 2, 32, 4, 32, 16)) for _ in range(n_adapters)]
    jax_stack = jax_lora.stack_adapters([{k: jnp.asarray(v) for k, v in a.items()} for a in adapters])
    port_stack = lora.stack_adapters([lora.lora_from_jax(a, "cpu") for a in adapters])
    return jax_stack, port_stack


def test_gather_and_select_adapters_match_jax():
    jax_stack, port_stack = _random_stacks(np.random.default_rng(3))
    idx = np.asarray([2, 0, 3, 3, 1], np.int32)
    want = jax_lora.gather_adapters(jax_stack, jnp.asarray(idx))
    got = lora.gather_adapters(port_stack, torch.from_numpy(idx))
    assert got.keys() == want.keys()
    for name in want:
        assert tuple(got[name].shape) == want[name].shape  # [n_layers, B, ...]
        _close(got[name].numpy(), want[name])
    for i in range(4):
        for name, w in jax_lora.select_adapter(jax_stack, i).items():
            _close(lora.select_adapter(port_stack, i)[name].numpy(), w)
    assert not port_stack["wq_a"][0].any()  # index 0 is the base model


def test_merge_adapter_matches_jax():
    rng = np.random.default_rng(4)
    jax_params = MODELS["target"].jax_params
    adapter = _f32(_random_adapter(rng, 2, 32, 4, 32, 32))
    want = jax_lora.merge_adapter(jax_params, {k: jnp.asarray(v) for k, v in adapter.items()})
    got = lora.merge_adapter(MODELS["target"].params, lora.lora_from_jax(adapter, "cpu"))
    for name in ("wq", "wv"):
        _close(got["layers"][name].numpy(), want["layers"][name])
    assert got["layers"]["wk"] is MODELS["target"].params["layers"]["wk"]


def test_adapter_init_shapes_and_zero_b():
    cfg = MODELS["target"].cfg
    fresh = lora.init_lora_adapter(cfg, 4, torch.Generator().manual_seed(0), device="cpu")
    test = lora.make_test_adapter(cfg, 4, torch.Generator().manual_seed(0), alpha=16.0, device="cpu")
    want = {k: v.shape for k, v in JAX_ADAPTERS["A"].items()}
    assert {k: tuple(v.shape) for k, v in fresh.items()} == want
    assert {k: tuple(v.shape) for k, v in test.items()} == want
    assert not fresh["wq_b"].any() and not fresh["wv_b"].any()
    # B carries the alpha/rank scale: its spread is about 0.02 * 16 / 4.
    assert 0.04 < float(test["wq_b"].std()) < 0.12


# -- the llama entry points with mixed adapters --------------------------------------

PREFIXES = [5, 9, 13]  # cached tokens per sequence
ADAPTER_OF_ROW = [2, 0, 1]  # registry index per sequence: B, base, A


def _llama_run(side, entry):
    """Prefix prefills of three sequences, each with its adapter (logits of
    every position), then `entry` over the batch with per-row adapters."""
    rng = np.random.default_rng(11)
    cfg, params = side.cfg, side.params
    stack = side.lora.stack_adapters([side.adapter("A"), side.adapter("B")])
    pps = 8
    cache = side.pages(3 * pps + 1)
    trash = 3 * pps
    tables = side.array(np.arange(3 * pps).reshape(3, pps))
    prefill_logits = []
    for i, n in enumerate(PREFIXES):
        tokens = side.array(rng.integers(0, cfg.vocab_size, n))
        cache, logits = side.llama.prefill_cache(
            cfg, params, cache, tokens, tables[i], 0,
            lora=side.lora.select_adapter(stack, ADAPTER_OF_ROW[i]), all_logits=True)
        prefill_logits.append(np.asarray(logits))
    if entry == "prefill_cache":
        return prefill_logits
    lora_arg = (stack, side.array(ADAPTER_OF_ROW))
    lens = side.array(PREFIXES)
    kernel = {"use_kernel": False} if side.name == "jax" else {}
    if entry == "decode_step_cache":
        tokens = side.array(rng.integers(0, cfg.vocab_size, 3))
        _, logits = side.llama.decode_step_cache(cfg, params, cache, tokens, tables, lens,
                                                 lora=lora_arg, **kernel)
        return np.asarray(logits)
    if entry == "decode_multi_step_cache":
        tokens = side.array(rng.integers(0, cfg.vocab_size, 3))
        max_lens = side.array(np.asarray(PREFIXES) + [3, 1, 2])  # rows 2, 3 overrun
        _, toks = side.llama.decode_multi_step_cache(cfg, params, cache, tokens, tables, lens,
                                                     max_lens, trash, 3, lora=lora_arg, **kernel)
        return np.asarray(toks).tolist()
    chunk = side.array(rng.integers(0, cfg.vocab_size, (3, 4)))
    max_lens = side.array(np.asarray(PREFIXES) + [4, 2, 3])
    _, logits = side.llama.verify_step_cache(cfg, params, cache, chunk, tables, lens, max_lens,
                                             trash, lora=lora_arg)
    return np.asarray(logits)


@pytest.mark.parametrize("int8", [False, True], ids=["f32_pages", "int8_pages"])
@pytest.mark.parametrize("entry", ["prefill_cache", "decode_step_cache",
                                   "decode_multi_step_cache", "verify_step_cache"])
def test_llama_with_mixed_adapters_matches_jax(entry, int8):
    want = _llama_run(_Side("jax", int8), entry)
    got = _llama_run(_Side("port", int8), entry)
    _assert_same(got, want)


def test_lora_none_is_the_base_path():
    """lora=None and the zero adapter give the same logits, so the base
    path is untouched by the LoRA plumbing."""
    side = _Side("port")
    cfg, params = side.cfg, side.params
    tokens = torch.arange(2, 14, dtype=torch.int32)
    table = torch.arange(16, dtype=torch.int32)
    stack = lora.stack_adapters([PORT_ADAPTERS["A"]])
    _, base = llama.prefill_cache(cfg, params, side.pages(16), tokens, table, 0)
    _, zero = llama.prefill_cache(cfg, params, side.pages(16), tokens, table, 0,
                                  lora=lora.select_adapter(stack, 0))
    _, every = llama.prefill_cache(cfg, params, side.pages(16), tokens, table, 0, all_logits=True)
    assert torch.equal(base, zero)
    # The last row of all_logits is the same product, at another matmul shape.
    torch.testing.assert_close(every[-1], base, atol=1e-6, rtol=1e-6)
    assert tuple(every.shape) == (12, cfg.vocab_size)


# -- tests/test_lora_serving.py --------------------------------------------------------


def _prefill_logits(side, params, tokens, lora_sel=None):
    table = side.array(np.arange(16))
    _, logits = side.llama.prefill_cache(side.cfg, params, side.pages(16), side.array(tokens),
                                         table, 0, lora=lora_sel)
    return np.asarray(logits)


def delta_path_equals_merged_weights(side):
    tokens = list(range(2, 14))
    stack = side.lora.stack_adapters([side.adapter("A")])
    via_delta = _prefill_logits(side, side.params, tokens, side.lora.select_adapter(stack, 1))
    via_merge = _prefill_logits(side, side.lora.merge_adapter(side.params, side.adapter("A")),
                                tokens)
    np.testing.assert_allclose(via_delta, via_merge, rtol=1e-4, atol=1e-4)
    return via_delta, via_merge


def zero_adapter_is_exact_noop(side):
    tokens = list(range(2, 14))
    stack = side.lora.stack_adapters([side.adapter("A")])
    base = _prefill_logits(side, side.params, tokens)
    zeroed = _prefill_logits(side, side.params, tokens, side.lora.select_adapter(stack, 0))
    np.testing.assert_allclose(zeroed, base, rtol=1e-6, atol=1e-6)
    return base


def fresh_adapter_is_noop_by_construction(side):
    # LoRA-standard zero-init B: an untrained adapter changes nothing. Each
    # package draws A from its own generator; B is zeros in both.
    if side.name == "jax":
        fresh = jax_lora.init_lora_adapter(side.cfg, rank=4, key=jax.random.PRNGKey(9))
    else:
        fresh = lora.init_lora_adapter(side.cfg, 4, torch.Generator().manual_seed(9), "cpu")
    tokens = list(range(2, 14))
    stack = side.lora.stack_adapters([fresh])
    got = _prefill_logits(side, side.params, tokens, side.lora.select_adapter(stack, 1))
    np.testing.assert_allclose(got, _prefill_logits(side, side.params, tokens),
                               rtol=1e-6, atol=1e-6)
    return got


def adapter_changes_logits(side):
    tokens = list(range(2, 14))
    stack = side.lora.stack_adapters([side.adapter("A")])
    with_adapter = _prefill_logits(side, side.params, tokens, side.lora.select_adapter(stack, 1))
    base = _prefill_logits(side, side.params, tokens)
    assert not np.allclose(with_adapter, base, atol=1e-4)
    return with_adapter, base


def mixed_batch_matches_isolated_merged_pods(side):
    # One pod serving base + two adapters concurrently generates, per
    # request, what a dedicated pod with merged weights generates.
    prompts = {None: list(range(5)), 7: list(range(20, 31)), 8: list(range(40, 47))}
    merged = {7: side.lora.merge_adapter(side.params, side.adapter("A")),
              8: side.lora.merge_adapter(side.params, side.adapter("B"))}
    expected = {lid: side.isolated(p, 6, params=merged.get(lid)) for lid, p in prompts.items()}
    sched = side.scheduler(side.pod(adapters={7: "A", 8: "B"}), max_batch=4)
    ids = {lid: sched.submit(p, max_new_tokens=6, lora_id=lid) for lid, p in prompts.items()}
    results = sched.run()
    for lid, rid in ids.items():
        assert results[rid] == expected[lid], f"lora_id={lid}"
    return results


def unknown_adapter_rejected_deterministically(side):
    sched = side.scheduler(side.pod(adapters={7: "A"}), max_batch=2)
    rid = sched.submit(list(range(8)), max_new_tokens=2, lora_id=99)
    done = sched.step()
    assert done and done[0].req_id == rid
    assert "unknown LoRA adapter" in done[0].error
    return done[0].error


def adapter_on_pod_without_adapters_rejected(side):
    sched = side.scheduler(side.pod(), max_batch=2)
    sched.submit(list(range(8)), max_new_tokens=2, lora_id=7)
    done = sched.step()
    assert done and done[0].error is not None
    return done[0].error


def adapter_scoped_prefix_cache_no_cross_reuse(side):
    pod = side.pod(adapters={7: "A", 8: "B"})
    tokens = list(range(16))
    s1, cached1 = pod.prefill(tokens, lora_id=7)
    pod.free(s1)
    _, cached2 = pod.prefill(tokens, lora_id=8)
    assert cached1 == 0 and cached2 == 0  # no cross-adapter hits
    _, cached3 = pod.prefill(tokens, lora_id=8)
    assert cached3 == 16  # a same-adapter hit
    return cached1, cached2, cached3


def _submit_mixed_adapters(sched):
    return [sched.submit(list(range(5)), max_new_tokens=7),
            sched.submit(list(range(20, 28)), max_new_tokens=7, lora_id=101),
            sched.submit(list(range(40, 46)), max_new_tokens=7, lora_id=202)]


def mixed_adapter_batch_matches_plain_scheduler(side):
    adapters = {101: "A", 202: "B"}
    plain = side.scheduler(side.pod(adapters=adapters), max_batch=4)
    pids = _submit_mixed_adapters(plain)
    pres = plain.run()
    draft_cfg, draft_params = side.model("draft9")
    spec = side.speculative.SpeculativeScheduler(side.pod(adapters=adapters), draft_cfg,
                                                 draft_params, k=3, max_batch=4)
    sids = _submit_mixed_adapters(spec)
    sres = spec.run()
    for pid, sid in zip(pids, sids):
        assert sres[sid] == pres[pid]
    assert spec.stats.rounds > 0
    return [pres[i] for i in pids], _stats(spec.stats)


def adapter_verification_uses_the_right_adapter(side):
    # Target as draft on an adapter sequence: verification with the wrong
    # (base) weights would accept the base draft wholesale and drift from
    # adapter-greedy; high acceptance and adapter-correct output together
    # pin the wiring.
    plain = side.scheduler(side.pod(adapters={101: "A"}), max_batch=2)
    pid = plain.submit(list(range(8, 16)), max_new_tokens=8, lora_id=101)
    pres = plain.run()
    spec = side.speculative.SpeculativeScheduler(side.pod(adapters={101: "A"}), side.cfg,
                                                 side.params, k=3, max_batch=2)
    sid = spec.submit(list(range(8, 16)), max_new_tokens=8, lora_id=101)
    sres = spec.run()
    assert sres[sid] == pres[pid]
    assert spec.stats.accepted > 0
    return pres[pid], _stats(spec.stats)


SCENARIOS = {fn.__name__: fn for fn in (
    delta_path_equals_merged_weights, zero_adapter_is_exact_noop,
    fresh_adapter_is_noop_by_construction, adapter_changes_logits,
    mixed_batch_matches_isolated_merged_pods, unknown_adapter_rejected_deterministically,
    adapter_on_pod_without_adapters_rejected, adapter_scoped_prefix_cache_no_cross_reuse,
    mixed_adapter_batch_matches_plain_scheduler, adapter_verification_uses_the_right_adapter,
)}
# Every scenario on both page formats; the mixed batch at decode_steps 4 too.
CASES = [(name, int8, steps) for name in SCENARIOS for int8 in (False, True)
         for steps in ((1, 4) if name == "mixed_batch_matches_isolated_merged_pods" else (1,))]


@pytest.mark.parametrize(
    "scenario, int8, decode_steps", CASES,
    ids=[f"{n}-{'int8' if i else 'f32'}_pages-steps{s}" for n, i, s in CASES])
def test_lora_serving_matches_jax(scenario, int8, decode_steps):
    run_both(SCENARIOS[scenario], int8, decode_steps)


def test_lora_decode_indices_live_on_the_pod_device():
    """lora_for_decode hands the llama call int32 indices on the pod's
    device (no per-row host work inside the step), and unknown ids raise
    KeyError with the id, as the JAX pod's registry does."""
    side = _Side("port")
    pod = side.pod(adapters={7: "A", 8: "B"})
    stack, idx = pod.lora_for_decode([8, None, 7])
    assert idx.dtype == torch.int32 and idx.device == pod.device
    assert idx.tolist() == [2, 0, 1] and stack["wq_a"].shape[0] == 3
    with pytest.raises(KeyError, match="99"):
        pod.lora_index(99)
