"""The port's parallel/ package against the JAX package's.

Specs and shards: the port's spec tables equal the JAX PartitionSpecs axis
for axis, and on a (dp 2, tp 4) mesh each rank's slice of the weights, the
KV pages (both formats) and a batch equals, bit for bit, the matching
device's `addressable_shards` of the JAX placement of the same numpy
arrays (`device_put` only: nothing compiles).

The multi-rank paths run in spawned gloo processes on the CPU
(tests/torch_parallel_workers.py, one spawn per scenario group, a FileStore
under tmp_path, each spawn joined under a time limit); the children import
neither jax nor the JAX package, and the JAX side is computed here:

- tp serving at tp 2 and 4 on the reference tp test's model (f32, vocab
  128, d_model 32, 2 layers, 8/4 heads of 16): prefill and 3 decode steps
  on both page formats, verify_step_cache and decode_multi_step_cache
  against the JAX package's single-device results within its rtol = atol =
  1e-5; a tp pod's Scheduler tokens, event stream and prefix reuse equal a
  JAX single-device pod's exactly; every page tensor holds n_kv / tp heads;
- ring attention at sp 2 and 4 against the JAX `ring_attention` under
  shard_map (atol 2e-5), and the long-context case at sp 4 against the JAX
  ring at sp 8;
- the pipeline at (stages, micro) (2, 2), (2, 4) and (1, 1) against the
  JAX `pipeline_forward` and, through the final norm and head, the JAX
  `forward_dense` (atol 1e-4);
- the hybrid mesh helpers of tests/test_multihost.py on gloo.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from llm_d_kv_cache_manager_tpu.engine.engine import (
    EnginePod as JaxEnginePod,
    EnginePodConfig as JaxEnginePodConfig,
)
from llm_d_kv_cache_manager_tpu.engine.scheduler import Scheduler as JaxScheduler
from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu.models import mixtral as jax_mixtral
from llm_d_kv_cache_manager_tpu.parallel import mesh as jax_mesh
from llm_d_kv_cache_manager_tpu.parallel import serving as jax_serving
from llm_d_kv_cache_manager_tpu.parallel.pipeline import (
    _apply_local_layers as jax_apply_layers,
    pipeline_forward as jax_pipeline_forward,
)
from llm_d_kv_cache_manager_tpu.parallel.ring_attention import ring_attention as jax_ring
from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig
from llm_d_kv_cache_manager_tpu_torch.models import llama, mixtral
from llm_d_kv_cache_manager_tpu_torch.parallel import mesh, multihost, serving
from llm_d_kv_cache_manager_tpu_torch.parallel.pipeline import pipeline_forward
from torch_parallel_workers import spawn

TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_tp_serving.py's
TP_CFG = dict(vocab_size=128, d_model=32, n_layers=2, n_q_heads=8, n_kv_heads=4,
              head_dim=16, d_ff=64)  # tests/test_tp_serving.py:24-27
JCFG = jax_llama.LlamaConfig(**TP_CFG, dtype=jnp.float32)
POD = dict(n_pages=32, page_size=4, max_pages_per_seq=16)
PROMPTS = [list(range(5)), list(range(20, 31)), list(range(40, 47))]
MAX_NEW = 6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _coords_of(jmesh: Mesh) -> dict:
    """Each device of a JAX mesh -> its MeshCoords."""
    out = {}
    for idx in np.ndindex(jmesh.devices.shape):
        out[jmesh.devices[idx]] = mesh.MeshCoords(
            dict(jmesh.shape), dict(zip(jmesh.axis_names, map(int, idx))))
    return out


def _assert_shards_equal(jax_tree, port_full, shard_port, jmesh):
    """Every addressable shard of every JAX leaf equals the port's slice for
    that device's mesh position, bit for bit."""
    coords = _coords_of(jmesh)
    leaves = jax.tree_util.tree_leaves_with_path(jax_tree)
    checked = 0
    for at in coords.values():
        port = shard_port(port_full, at)
        for path, leaf in leaves:
            got = port
            for key in path:
                got = got[key.key if hasattr(key, "key") else key.idx]
            shard = next(s for s in leaf.addressable_shards if coords[s.device] == at)
            want = _bits(shard.data)
            assert got.shape == want.shape, (path, got.shape, want.shape)
            assert np.array_equal(_torch_bits(got), want), path
            checked += 1
    assert checked == len(coords) * len(leaves)


# -- specs and shards ----------------------------------------------------------------


@pytest.mark.parametrize("attn_bias", [False, True])
def test_param_specs_equal_the_partition_specs(attn_bias):
    want = jax.tree_util.tree_map(tuple, jax_mesh.param_specs(attn_bias),
                                  is_leaf=lambda x: isinstance(x, P))
    assert mesh.param_specs(attn_bias) == want


def test_mixtral_param_specs_equal_the_partition_specs():
    want = jax.tree_util.tree_map(tuple, jax_mixtral.param_specs(),
                                  is_leaf=lambda x: isinstance(x, P))
    assert mixtral.param_specs() == want


def test_kv_spec_equals_the_reference_sharding():
    jmesh = jax_serving.tp_mesh(4)
    for s in jax_serving.kv_cache_shardings(jmesh, 4):
        assert tuple(s.spec) == serving.KV_SPEC


@pytest.mark.parametrize("attn_bias", [False, True], ids=["llama", "qwen2_bias"])
def test_shard_params_equal_addressable_shards(attn_bias):
    cfg = dict(TP_CFG, attn_bias=attn_bias)
    params = jax_llama.init_params(jax_llama.LlamaConfig(**cfg), jax.random.PRNGKey(3))
    if attn_bias:  # nonzero biases, so a wrong slice shows
        rng = np.random.default_rng(0)
        for name in ("bq", "bk", "bv"):
            shape = params["layers"][name].shape
            params["layers"][name] = jnp.asarray(rng.normal(size=shape), params["layers"][name].dtype)
    host = _np_tree(params)
    assert host["embed"].dtype.name == "bfloat16"
    jmesh = jax_mesh.make_mesh(dp=2, tp=4)
    placed = jax_mesh.shard_params(host, jmesh)
    _assert_shards_equal(placed, llama.params_from_jax(host, "cpu"), mesh.shard_params, jmesh)
    # param_shardings names the same slices shard_params takes.
    at = mesh.MeshCoords({"dp": 2, "tp": 4}, {"dp": 1, "tp": 2})
    assert mesh.param_shardings(at, attn_bias)["layers"]["wo"] == ((1, 2, 4),)


def test_mixtral_shard_params_equal_addressable_shards():
    cfg = jax_mixtral.MixtralConfig(vocab_size=128, d_model=32, n_layers=2, n_q_heads=4,
                                    n_kv_heads=2, head_dim=16, d_ff=64, n_experts=8, top_k=2)
    host = _np_tree(jax_mixtral.init_params(cfg, jax.random.PRNGKey(4)))
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("dp", "tp", "ep"))
    placed = jax_mixtral.shard_params(host, jmesh)
    _assert_shards_equal(placed, llama.params_from_jax(host, "cpu"), mixtral.shard_params, jmesh)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_shard_kv_cache_equals_addressable_shards(quantized):
    jcfg = jax_llama.LlamaConfig(**TP_CFG)
    make = jax_llama.make_kv_pages_quantized if quantized else jax_llama.make_kv_pages
    rng = np.random.default_rng(1)
    host = []
    for comp in make(jcfg, 6, 4):
        arr = np.asarray(comp)
        if arr.dtype == np.int8:
            host.append(rng.integers(-127, 128, arr.shape).astype(np.int8))
        else:
            host.append(rng.normal(size=arr.shape).astype(arr.dtype))
    host = tuple(host)
    jmesh = jax_mesh.make_mesh(dp=2, tp=4)
    placed = jax_serving.shard_kv_cache(host, jmesh)
    port = tuple(llama.params_from_jax(c, "cpu") for c in host)
    _assert_shards_equal(placed, port, serving.shard_kv_cache, jmesh)


def test_batch_sharding_equals_addressable_shards():
    batch = np.arange(4 * 32, dtype=np.int32).reshape(4, 32)
    jmesh = jax_mesh.make_mesh(dp=2, tp=4)
    placed = jax.device_put(batch, jax_mesh.batch_sharding(jmesh))
    _assert_shards_equal(placed, torch.from_numpy(batch), mesh.batch_sharding, jmesh)


def test_tp_must_divide_heads():
    with pytest.raises(ValueError, match="divide") as port:
        serving.validate_tp(3, TP_CFG["n_q_heads"], TP_CFG["n_kv_heads"])
    with pytest.raises(ValueError) as ref:
        jax_serving.validate_tp(3, TP_CFG["n_q_heads"], TP_CFG["n_kv_heads"])
    assert str(port.value) == str(ref.value)


# -- the tp pod's guards -------------------------------------------------------------


def test_tp_pod_without_a_group_raises():
    with pytest.raises(ValueError, match="initialize_distributed"):
        EnginePod(EnginePodConfig(**POD, model_config=llama.LlamaConfig(**TP_CFG),
                                  device="cpu", tp=2))


def test_moe_tp_pod_raises_before_any_params(monkeypatch):
    built = []
    for module in (llama, mixtral):
        monkeypatch.setattr(module, "init_params", lambda *a, **k: built.append(a))
    kw = dict(vocab_size=128, d_model=32, n_layers=1, n_q_heads=4, n_kv_heads=2,
              head_dim=16, d_ff=64, n_experts=4, top_k=2)
    with pytest.raises(NotImplementedError) as port:
        EnginePod(EnginePodConfig(**POD, model_config=mixtral.MixtralConfig(**kw),
                                  device="cpu", tp=2))
    assert not built
    with pytest.raises(NotImplementedError) as ref:
        JaxEnginePod(JaxEnginePodConfig(**POD, with_model=True, tp=2,
                                        model_config=jax_mixtral.MixtralConfig(**kw)))
    assert str(port.value) == str(ref.value)


# -- tp serving ------------------------------------------------------------------------


def _jax_params(seed):
    return jax_llama.init_params(JCFG, jax.random.PRNGKey(seed))


def _jax_serving(quantized):
    params = _jax_params(0)
    make = jax_llama.make_kv_pages_quantized if quantized else jax_llama.make_kv_pages
    cache = make(JCFG, 16, 4)
    table = jnp.arange(4, dtype=jnp.int32)
    cache, logits = jax_llama.prefill_cache(JCFG, params, cache, jnp.arange(10, dtype=jnp.int32),
                                            table, 0)
    out = [np.asarray(logits)]
    tok = jnp.argmax(logits)[None].astype(jnp.int32)
    for i in range(3):
        cache, logits = jax_llama.decode_step_cache(JCFG, params, cache, tok, table[None],
                                                    jnp.asarray([10 + i], jnp.int32))
        out.append(np.asarray(logits[0]))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return out


def _jax_verify():
    params = _jax_params(1)
    cache = jax_llama.make_kv_pages(JCFG, 16, 4)
    for t, tab in ((jnp.arange(6, dtype=jnp.int32), [0, 1, 2, 3]),
                   (jnp.arange(20, 29, dtype=jnp.int32), [4, 5, 6, 7])):
        cache, _ = jax_llama.prefill_cache(JCFG, params, cache, t, jnp.asarray(tab, jnp.int32), 0)
    _, logits = jax_llama.verify_step_cache(
        JCFG, params, cache, jnp.asarray([[1, 2, 3], [4, 5, 6]], jnp.int32),
        jnp.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], jnp.int32), jnp.asarray([6, 9], jnp.int32))
    return np.asarray(logits)


def _jax_multi_step():
    params = _jax_params(2)
    cache = jax_llama.make_kv_pages(JCFG, 17, 4)
    table = jnp.arange(4, dtype=jnp.int32)
    cache, logits = jax_llama.prefill_cache(JCFG, params, cache, jnp.arange(7, dtype=jnp.int32),
                                            table, 0)
    pending = jnp.argmax(logits)[None].astype(jnp.int32)
    _, toks = jax_llama.decode_multi_step_cache(
        JCFG, params, cache, pending, table[None], jnp.asarray([7], jnp.int32),
        jnp.asarray([12], jnp.int32), 16, 5)
    return [int(t) for t in np.asarray(toks)[0]]


def _event_rows(batches):
    return [tuple(e.to_tagged_union()) for b in batches for e in b.events]


def _jax_pod(events=None):
    return JaxEnginePod(JaxEnginePodConfig(**POD, with_model=True, model_config=JCFG),
                        event_sink=None if events is None else events.append)


def _jax_pod_side():
    events = []
    sched = JaxScheduler(_jax_pod(events), max_batch=4)
    ids = [sched.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    results = sched.run()
    out = {"scheduler": [results[i] for i in ids], "scheduler_events": _event_rows(events)}
    events = []
    pod = _jax_pod(events)
    state, _ = pod.prefill(list(range(10)))
    pod.decode_append(state, int(jnp.argmax(pod.last_logits)))
    for _ in range(4):
        pod.decode_step(state)
    out["pod_tokens"] = list(state.tokens)
    pod.free(state)
    out["pod_events"] = _event_rows(events)
    return out


@pytest.fixture(scope="module")
def jax_tp_reference():
    return dict(serving=_jax_serving(False), serving_int8=_jax_serving(True),
                verify=_jax_verify(), multi_step=_jax_multi_step(), **_jax_pod_side())


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_serving_matches_the_single_device_reference(tp, tmp_path, jax_tp_reference):
    ref = jax_tp_reference
    params = {seed: _np_tree(_jax_params(seed)) for seed in (0, 1, 2)}
    ranks = spawn("tp_serving", tp, tmp_path, TP_CFG, params, POD, PROMPTS, MAX_NEW)
    n_kv = TP_CFG["n_kv_heads"] // tp
    for rank, got in enumerate(ranks):
        for key in ("serving", "serving_int8"):
            for a, b in zip(got[key], ref[key]):
                np.testing.assert_allclose(a, b, **TOL, err_msg=f"rank {rank} {key}")
        np.testing.assert_allclose(got["verify"], ref["verify"], **TOL)
        assert got["multi_step"] == ref["multi_step"]
        assert got["scheduler"] == ref["scheduler"]
        assert got["pod_tokens"] == ref["pod_tokens"]
        assert got["prefix_reuse"] == (0, 12)  # head-sharded pages reused through the table
        for shapes in (got["heads"], got["heads_int8"], got["pod_heads"]):
            assert all(s[1] == n_kv for s in shapes), shapes
    # The tp pod is one pod: rank 0 publishes the reference's stream, no other rank
    # publishes anything.
    assert ranks[0]["scheduler_events"] == ref["scheduler_events"]
    assert ranks[0]["pod_events"] == ref["pod_events"]
    assert all(not r["scheduler_events"] and not r["pod_events"] for r in ranks[1:])


# -- ring attention, the pipeline, the hybrid mesh -------------------------------------

PIPE_CFG = dict(vocab_size=128, d_model=32, n_layers=4, n_q_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=64)  # tests/test_pipeline.py:14-17


def _jax_ring(n, q, k, v):
    jmesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    fn = jax.shard_map(lambda a, b, c: jax_ring(a, b, c, axis_name="sp"), mesh=jmesh,
                       in_specs=(P(None, "sp", None, None),) * 3,
                       out_specs=P(None, "sp", None, None))
    return np.asarray(fn(q, k, v))


def _ring_inputs(n):  # tests/test_ring_attention.py:32-38
    b, l, h, d = 2, 16 * n, 4, 32
    keys = jax.random.split(jax.random.PRNGKey(n), 3)
    return tuple(np.asarray(jax.random.normal(key, (b, l, h, d))) for key in keys)


def test_ring_attention_pipeline_and_hybrid_mesh(tmp_path):
    ring_cases = [(n, _ring_inputs(n)) for n in (2, 4)]
    long_q = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 256, 2, 16)))
    jcfg = jax_llama.LlamaConfig(**PIPE_CFG, dtype=jnp.float32)
    params = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 10), 0, jcfg.vocab_size)
    x = params["embed"][tokens]
    host = _np_tree(params)
    micro_counts = (2, 4)
    ranks = spawn("p2p", 4, tmp_path, ring_cases,
                  long_q, (PIPE_CFG, host["layers"], np.asarray(x), micro_counts))

    for n, (q, k, v) in ring_cases:
        got = np.concatenate([ranks[r]["ring"][n] for r in range(n)], axis=1)
        np.testing.assert_allclose(got, _jax_ring(n, q, k, v), atol=2e-5)
    long_got = np.concatenate([r["long"] for r in ranks], axis=1)
    assert long_got.shape == long_q.shape and not np.isnan(long_got).any()
    np.testing.assert_allclose(long_got, _jax_ring(8, long_q, long_q, long_q), atol=2e-5)

    ref_layers = np.asarray(jax_apply_layers(jcfg, params["layers"], x))
    dense = np.asarray(jax_llama.forward_dense(jcfg, params, tokens))
    port = llama.params_from_jax(host, "cpu")
    for n_micro in micro_counts:
        jmesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
        xm = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
        want = np.asarray(jax_pipeline_forward(jcfg, params["layers"], xm, jmesh))
        for r in (0, 1):
            got = ranks[r]["pipeline"][n_micro]
            np.testing.assert_allclose(got, want, atol=1e-4)
            np.testing.assert_allclose(got.reshape(x.shape), ref_layers, atol=1e-4)
        hidden = torch.from_numpy(ranks[0]["pipeline"][n_micro].reshape(x.shape))
        logits = llama.rms_norm(hidden, port["final_norm"], jcfg.rms_eps) @ port["out"]
        np.testing.assert_allclose(logits.numpy(), dense, atol=1e-4)

    for r in ranks:  # tests/test_multihost.py's cases, on four gloo ranks
        assert r["hybrid"] == (("dp", "tp"), (2, 2), float(np.arange(8 * 16).sum()))
        assert "needs 16" in r["too_many"]
        assert r["ici"] == ("tp",)
        assert r["again"]


def test_single_stage_pipeline_degenerates_to_dense():
    jcfg = jax_llama.LlamaConfig(**PIPE_CFG, dtype=jnp.float32)
    params = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (6, 10), 0, jcfg.vocab_size)
    x = params["embed"][tokens]
    jmesh = Mesh(np.array(jax.devices()[:1]), ("pp",))
    want = np.asarray(jax_pipeline_forward(jcfg, params["layers"], x[None], jmesh))
    port = llama.params_from_jax(_np_tree(params), "cpu")
    cfg = llama.LlamaConfig(**PIPE_CFG, dtype=torch.float32)
    got = pipeline_forward(cfg, port["layers"], torch.from_numpy(np.array(x))[None])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jax_apply_layers(
        jcfg, params["layers"], x)), atol=1e-4)


def test_initialize_is_noop_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_distributed() is None
    assert not torch.distributed.is_initialized()


def test_hybrid_mesh_too_many_ranks_raises_single_process():
    with pytest.raises(ValueError, match="needs 16"):
        multihost.make_hybrid_mesh({"tp": 8}, {"dp": 2}, device="cpu")
