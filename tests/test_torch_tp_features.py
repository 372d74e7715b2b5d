"""A tp pod's host tier, LoRA adapters and speculation against the JAX package's.

The reference serves all three on a tensor-parallel pod (its weights and
pages sharded over a mesh); so does the port. The model is the reference tp
test's (f32, vocab 128, d_model 32, 2 layers, 8/4 heads of 16). The port's
tp = 2 and tp = 4 pods run in spawned gloo processes on the CPU
(tests/torch_parallel_workers.py `tp_features`, one spawn per tp value);
the JAX side is a tp = 4 pod (tests/conftest.py gives 8 host devices) and a
tp = 1 pod on the same params, and the port's tp = 1 pod runs here too:

- the host tier (`ALWAYS_TRANSFER`, 6 pages: offload on reclaim, then a
  restore of the 16-token prefix) on f32 and int8 pages: greedy tokens,
  cached tokens, tier stats and event streams (the cpu-tier BlockStored and
  BlockRemoved included) exactly equal to the JAX tp pod's, the JAX tp = 1
  pod's and the port's tp = 1 pod's; only rank 0 publishes and holds a tier
  store; its staged payloads hold the tp = 1 pod's values in the tp = 1
  layout (f32 within 1e-5);
- cross-onboarding: a tp pod onboards a tp = 1 pod's exported prefix and the
  reverse, through the transfer servers, each serving it as a hit (suffix
  logits within 1e-4 of the exporter's own hit); what each then stages is
  the exporter's payload byte for byte;
- LoRA: two adapters and the base through the Scheduler: the same tokens and
  adapter-scoped block hashes; each rank's registry holds its columns of
  the B matrices;
- speculation: `SpeculativeScheduler` at k = 3 with a 1-layer draft and a
  greedy `SpeculativeDecoder` with the target as its own draft (every
  proposal accepted): tokens, `SpeculativeStats` and events equal to the
  JAX tp pod's; a sampled request's tokens equal on every rank and to the
  tp = 1 pod's;
- the LoRA registry's specs against the JAX `addressable_shards` of the same
  stack placed under them.

The JAX pods' host tiers borrow the port's transfer library, as
tests/test_torch_connector.py's `jax_lib` does.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_parallel import TP_CFG, _assert_shards_equal

from llm_d_kv_cache_manager_tpu.engine import speculative as jax_speculative
from llm_d_kv_cache_manager_tpu.engine.costs import ALWAYS_TRANSFER as JAX_ALWAYS
from llm_d_kv_cache_manager_tpu.engine.engine import (
    EnginePod as JaxEnginePod,
    EnginePodConfig as JaxEnginePodConfig,
)
from llm_d_kv_cache_manager_tpu.engine.scheduler import Scheduler as JaxScheduler
from llm_d_kv_cache_manager_tpu.kv_connectors import connector as jax_connector
from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu.models import lora as jax_lora
from llm_d_kv_cache_manager_tpu.ops.sampling import SamplingParams as JaxSamplingParams
from llm_d_kv_cache_manager_tpu.parallel import mesh as jax_mesh
from llm_d_kv_cache_manager_tpu_torch.kv_connectors import connector
from llm_d_kv_cache_manager_tpu_torch.models import lora
from llm_d_kv_cache_manager_tpu_torch.ops.sampling import SamplingParams
from llm_d_kv_cache_manager_tpu_torch.parallel import mesh, serving
from torch_parallel_workers import (
    PortKit,
    host_tier_sequence,
    lora_sequence,
    spawn,
    speculative_sequence,
)

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ compiler (g++ or c++) to build the port's transfer library",
)

JCFG = jax_llama.LlamaConfig(**TP_CFG, dtype=jnp.float32)
DRAFT_CFG = dict(TP_CFG, n_layers=1)
JDRAFT = jax_llama.LlamaConfig(**DRAFT_CFG, dtype=jnp.float32)
SAMPLING = dict(temperature=0.8, top_k=20, top_p=0.9, seed=5)
TPS = (2, 4)
FORMATS = ("f32", "int8")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs():
    params = jax_llama.init_params(JCFG, jax.random.PRNGKey(0))
    draft = jax_llama.init_params(JDRAFT, jax.random.PRNGKey(1))
    adapters = {name: jax_lora.make_test_adapter(JCFG, rank=4, key=jax.random.PRNGKey(seed))
                for name, seed in (("A", 2), ("B", 3))}
    return params, draft, adapters


class JaxKit:
    """The JAX package's side of the scenarios: pods at `tp` on one mesh."""

    def __init__(self, tp: int):
        self.params, draft, self.adapters = _inputs()
        self.cfg, self.draft, self.tp, self.leads = JCFG, (JDRAFT, draft), tp, True
        self.Scheduler, self.speculative = JaxScheduler, jax_speculative

    def pod(self, events, adapters=None, **over):
        kw = dict(pod_id="pod-t", model_name="m", page_size=4, max_pages_per_seq=8,
                  device_tier="hbm", transfer_cost_model=JAX_ALWAYS)
        kw.update(over)
        return JaxEnginePod(
            JaxEnginePodConfig(**kw, with_model=True, model_config=JCFG, tp=self.tp),
            event_sink=events.append, params=self.params,
            lora_adapters={k: self.adapters[v] for k, v in (adapters or {}).items()} or None)

    def pick(self, pod, logits) -> int:
        return int(jnp.argmax(logits))


def _run_all(kit, sampling) -> dict:
    out = {fmt: host_tier_sequence(kit, fmt == "int8") for fmt in FORMATS}
    out["lora"] = lora_sequence(kit)
    out["speculative"] = speculative_sequence(kit, sampling)
    return out


@pytest.fixture(scope="module")
def lent_library():
    """The port's transfer library lent to the JAX connector for this module
    (no file of the JAX package changes, and its own copy stays unbuilt)."""
    lib = connector._library()
    jax_connector._configure_lib(lib)
    real, jax_connector._lib = jax_connector._lib, lib
    yield lib
    jax_connector._lib = real


@pytest.fixture(scope="module")
def sides(lent_library, tmp_path_factory):
    """Every side's results: the JAX tp = 4 and tp = 1 pods, the port's tp = 1
    pod here, and each rank of the port's tp = 2 and tp = 4 pods."""
    params, draft, adapters = _inputs()
    np_adapters = {k: _np(v) for k, v in adapters.items()}
    out = {f"jax{tp}": _run_all(JaxKit(tp), JaxSamplingParams(**SAMPLING)) for tp in (4, 1)}
    out["port1"] = _run_all(PortKit(TP_CFG, _np(params), DRAFT_CFG, _np(draft), np_adapters),
                            SamplingParams(**SAMPLING))
    for tp in TPS:
        out[f"port{tp}"] = spawn("tp_features", tp, tmp_path_factory.mktemp(f"tp{tp}"), TP_CFG,
                                 _np(params), DRAFT_CFG, _np(draft), np_adapters, SAMPLING)
    return out


def test_lora_stack_specs_equal_addressable_shards():
    jmesh = jax_mesh.make_mesh(dp=2, tp=4)
    _, _, adapters = _inputs()
    stack = _np(jax_lora.stack_adapters([adapters["A"], adapters["B"]]))
    placed = {name: jax.device_put(arr, NamedSharding(jmesh, P(*mesh.LORA_STACK_SPECS[name])))
              for name, arr in stack.items()}
    port = {name: lora.lora_from_jax({name: arr}, "cpu")[name] for name, arr in stack.items()}
    _assert_shards_equal(placed, port, serving.shard_lora_stack, jmesh)
    # The B matrices split as the projections they add onto.
    assert mesh.LORA_STACK_SPECS["wq_b"][2:] == mesh.param_specs()["layers"]["wq"][1:]
    assert mesh.LORA_STACK_SPECS["wv_b"][2:] == mesh.param_specs()["layers"]["wv"][1:]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("tp", TPS)
def test_host_tier_matches_the_jax_tp_pod(sides, tp, fmt):
    ref = sides["jax4"][fmt]
    for other in ("jax1", "port1"):  # the reference's own tp parity, and the port's
        got = sides[other][fmt]
        assert (got["tokens"], got["stats"], got["staged"], got["events"]) == (
            ref["tokens"], ref["stats"], ref["staged"], ref["events"]), other
    first, again, cached, _ = ref["tokens"]
    assert cached == 16 and first == again and ref["stats"]["restores"] == 4
    ranks = sides[f"port{tp}"]
    r0 = ranks[0][fmt]
    assert r0["tokens"] == ref["tokens"]
    assert r0["stats"] == ref["stats"] and r0["staged"] == ref["staged"]
    assert r0["events"] == ref["events"]
    assert [r[0] for r in r0["events"] if r[-1] == "cpu"] == [
        r[0] for r in ref["events"] if r[-1] == "cpu"]
    for r in ranks[1:]:  # one pod to the control plane: no events, no tier store
        assert r[fmt]["tokens"] == ref["tokens"]
        assert not r[fmt]["events"] and "stats" not in r[fmt]


@pytest.mark.parametrize("tp", TPS)
def test_host_tier_payloads_hold_the_single_rank_layout(sides, tp):
    """The staged blocks of the tp pod are the tp = 1 pod's blocks: the same
    hashes, and on f32 pages the same values where they sit in a tp = 1
    payload (a rank-by-rank byte layout scrambles them)."""
    for fmt in FORMATS:
        got, want = sides[f"port{tp}"][0][fmt]["payloads"], sides["port1"][fmt]["payloads"]
        assert got.keys() == want.keys() and len(got) > 0
        assert all(len(got[h]) == len(want[h]) for h in want)
    got, want = sides[f"port{tp}"][0]["f32"]["payloads"], sides["port1"]["f32"]["payloads"]
    for h in want:
        np.testing.assert_allclose(np.frombuffer(got[h], np.float32),
                                   np.frombuffer(want[h], np.float32), atol=1e-5, rtol=0)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("tp", TPS)
def test_cross_onboard_both_ways(sides, tp, fmt):
    ranks = sides[f"port{tp}"]
    r0 = ranks[0]["cross"][fmt]
    assert r0["x_cached"] == 16 and r0["x_onboards"] == 4
    assert r0["y_cached"] == 16 and r0["y_onboards"] == 4 and r0["y_tp_hit"] == 16
    assert r0["x_bytes_equal"] and r0["y_bytes_equal"]
    assert r0["x_err"] <= 1e-4 and r0["y_err"] <= 1e-4, (r0["x_err"], r0["y_err"])
    for r in ranks[1:]:
        assert r["cross"][fmt]["x_cached"] == 16 and r["cross"][fmt]["y_tp_hit"] == 16


@pytest.mark.parametrize("tp", TPS)
def test_lora_at_tp_matches_the_jax_tp_pod(sides, tp):
    ref = sides["jax4"]["lora"]
    assert sides["jax1"]["lora"] == ref and sides["port1"]["lora"] == ref
    ranks = sides[f"port{tp}"]
    assert all(r["lora"]["tokens"] == ref["tokens"] for r in ranks)
    assert ranks[0]["lora"]["events"] == ref["events"]
    assert {r[5] for r in ref["events"] if r[0] == "BlockStored"} == {7, 9, None}
    assert all(not r["lora"]["events"] for r in ranks[1:])
    q_dim, kv_dim = JCFG.n_q_heads * JCFG.head_dim, JCFG.n_kv_heads * JCFG.head_dim
    for r in ranks:
        shapes = r["shapes"]
        assert shapes["lora"]["wq_b"][-1] == q_dim // tp and shapes["lora"]["wv_b"][-1] == \
            kv_dim // tp
        assert shapes["lora"]["wq_a"][-2:] == (JCFG.d_model, 4)
        assert all(s[1] == JCFG.n_kv_heads // tp for s in shapes["pages"])


@pytest.mark.parametrize("tp", TPS)
def test_speculation_at_tp_matches_the_jax_tp_pod(sides, tp):
    ref = sides["jax4"]["speculative"]
    n = len(ref["scheduler"]) - 1  # the greedy requests
    for other in ("jax1", "port1"):
        got = sides[other]["speculative"]
        assert got["scheduler"][:n] == ref["scheduler"][:n], other
        assert got["decoder"] == ref["decoder"] and got["decoder_stats"] == ref["decoder_stats"]
    ranks = sides[f"port{tp}"]
    single = sides["port1"]["speculative"]
    for r in ranks:
        got = r["speculative"]
        assert got["scheduler"][:n] == ref["scheduler"][:n]
        assert got["scheduler"] == single["scheduler"]  # the sampled request too
        assert got["scheduler_stats"] == ranks[0]["speculative"]["scheduler_stats"] == \
            single["scheduler_stats"]
        assert got["decoder"] == ref["decoder"] and got["decoder_stats"] == ref["decoder_stats"]
    proposed, accepted, _ = ref["decoder_stats"]
    assert accepted == proposed > 0  # the perfect draft's rounds accept everything
    assert ranks[0]["speculative"]["decoder_events"] == ref["decoder_events"]
    assert ranks[0]["speculative"]["scheduler_events"] == single["scheduler_events"]
    assert all(not r["speculative"]["scheduler_events"] and not r["speculative"][
        "decoder_events"] for r in ranks[1:])
