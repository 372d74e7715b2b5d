"""The port's placement plane against the JAX package's, on the same inputs.

- Every test of tests/test_placement.py but those that need code the port
  does not carry (`WAITS`) runs on both packages (`reference_module`): the
  decayed count-min sketch, the chain popularity tracker, the replicator's
  targets, cooldowns and drops, the read path's bit identity with a tracker
  attached, cost-aware eviction, tenant isolation on every backend, the
  event pool's store ingest, and a warm_chain from a peer over the real
  transfer library (the JAX package's connector borrows the port's build;
  the port's pods get a small f32 model, as they always compute).
- One seeded stream of route, store and lookup observations, block events,
  evictions, replicator and prefetch-scheduler ticks and sheds under a fake
  clock (`proactive_stream`): the top-K chains, block scores, sketch rows,
  chosen targets, session ETAs and the jobs in order are exactly equal on
  both packages, on every index backend.
- chip_smoke.py phase 16b's arms at CPU parameters: observe-only serves
  exactly as placement off, and placement on lands replicated blocks with
  no unhealthy target and no drop.
"""

import dataclasses
import importlib
import random
from types import SimpleNamespace

import pytest

from tests.test_torch_fleethealth import (
    BACKEND_IDS,
    BACKEND_NAMES,
    JAX_PKG,
    MODEL,
    PACKAGES,
    PAGE,
    PKG_IDS,
    PORT_PKG,
    SIM_PODS,
    Clock,
    backend,
    case_id,
    reference_cases,
    reference_module,
    run_reference_case,
)

# Cases of tests/test_placement.py that need code the port does not carry.
WAITS = {
    "TestClusterReplicasEquivalence":
        "bench.py's FleetSim, the benchmark's own code, which is not ported (chip_smoke.py "
        "phase 17a and tests/test_torch_cluster.py's rehearsal of it make the claim, cluster "
        "scoring bit-identical to a monolithic indexer, on the port's pods)",
    "TestPlacementEndToEnd::test_replication_lands_blocks_and_disabled_is_bit_identical":
        "bench.py's FleetSim, the benchmark's own code, which is not ported "
        "(test_phase_16b_arms_rehearse_the_end_to_end_claims makes its claims on the port's pods)",
}
# TestTenantIsolationProperty builds its backends itself (its module's own
# `_backend_factories`: in-memory, sharded, cost-aware and Redis): it runs
# over those four below rather than the shared backend spread.
OWN_BACKENDS = "TestTenantIsolationProperty"
CASES = [c for c in reference_cases("test_placement.py", WAITS) if c[0] != OWN_BACKENDS]
# Cases that build an EnginePod: the port's pods always compute, so they get
# a small f32 model on the CPU (the reference's default pod keeps no model).
POD_CASES = {("TestPlacementEndToEnd", "test_warm_chain_restores_from_peer_and_emits_events")}
POD_MODEL = dict(vocab_size=2048, d_model=64, n_layers=1, n_q_heads=2, n_kv_heads=1, head_dim=32,
                 d_ff=128)


@pytest.fixture
def transfer_library(monkeypatch):
    """The port's build of the transfer library, lent to the JAX package's
    connector for one test (its own copy stays unbuilt)."""
    from llm_d_kv_cache_manager_tpu.kv_connectors import connector as jax_connector
    from llm_d_kv_cache_manager_tpu_torch.kv_connectors import connector

    lib = connector._library()
    jax_connector._configure_lib(lib)
    monkeypatch.setattr(jax_connector, "_lib", lib)
    return lib


def small_model_pods(monkeypatch):
    """Point the port's EnginePodConfig at a small f32 model on the CPU for
    one test (the reference's tests build pods with its defaults)."""
    import torch

    from llm_d_kv_cache_manager_tpu_torch.engine import engine
    from llm_d_kv_cache_manager_tpu_torch.models import llama

    cfg = llama.LlamaConfig(**POD_MODEL, dtype=torch.float32)
    base = engine.EnginePodConfig

    def config(**kw):
        return base(**{"model_config": cfg, "device": "cpu", **kw})

    monkeypatch.setattr(engine, "EnginePodConfig", config)


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_placement_case_on_both_packages(case, pkg, request):
    if case[:2] in POD_CASES:
        request.getfixturevalue("transfer_library")
        if pkg == PORT_PKG:
            small_model_pods(request.getfixturevalue("monkeypatch"))
    run_reference_case("test_placement.py", case, pkg, request)


def _own_backend_cases():
    ns = reference_module("test_placement.py", JAX_PKG)
    out = []
    for name, meth in vars(getattr(ns, OWN_BACKENDS)).items():
        if name.startswith("test_"):
            (mark,) = [m for m in meth.pytestmark if m.name == "parametrize"]
            out += [(name, b) for b in mark.args[1]]
    return out


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("meth,backend_name", _own_backend_cases(),
                         ids=[f"{m}::{b}-index" for m, b in _own_backend_cases()])
def test_tenant_isolation_on_both_packages(meth, backend_name, pkg):
    ns = reference_module("test_placement.py", pkg)
    getattr(getattr(ns, OWN_BACKENDS)(), meth)(backend=backend_name)


def test_every_placement_case_is_taken():
    ns = reference_module("test_placement.py", JAX_PKG)
    every = {(c, m) for c, cls in vars(ns).items() if c.startswith("Test")
             for m in vars(cls) if m.startswith("test_")}
    waiting = {(c, m) for c, m in every if c in WAITS or f"{c}::{m}" in WAITS}
    own = {(OWN_BACKENDS, m) for m, _ in _own_backend_cases()}
    assert {(c, m) for c, m, _ in CASES} | own == every - waiting
    assert len(waiting) == 2 and len(_own_backend_cases()) == 4


def test_port_namespace_runs_the_port():
    ns = reference_module("test_placement.py", PORT_PKG)
    for name in ("ChainPopularityTracker", "DecayedCountMinSketch", "HotPrefixReplicator",
                 "PopularityConfig", "ReplicationConfig", "Indexer", "CostAwareMemoryIndex"):
        assert getattr(ns, name).__module__.startswith(PORT_PKG + "."), name


# -- one seeded stream through both packages' proactive planes ------------------

STREAM_TICKS = 14
STREAM_SESSIONS = 6


def proactive_parts(pkg):
    mods = dict(pl="placement", pr="prediction", pool="kvevents.pool", ev="kvevents.events",
                indexer="kvcache.indexer", tp="kvcache.kvblock.token_processor",
                health="fleethealth.tracker")
    return SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{v}") for k, v in mods.items()})


def _sessions(rng):
    """Seeded multi-turn sessions over two shared system prefixes: each
    session's tokens, grown a turn at a time."""
    prefixes = [[rng.randrange(1000) for _ in range(3 * PAGE)] for _ in range(2)]
    return [dict(tokens=list(prefixes[s % 2]), pod=SIM_PODS[s % len(SIM_PODS)], tail=None)
            for s in range(STREAM_SESSIONS)]


def proactive_stream(pkg, backend_name, seed, ticks=STREAM_TICKS):
    """Package `pkg`'s popularity tracker (on the event pool and, for the
    cost-aware backend, its eviction), session table, HotPrefixReplicator
    and PrefetchScheduler over one index, driven by a seeded stream: turns
    of multi-turn sessions observed on the read path and stored by their
    pods, evictions, lookups, a tick of each loop per step, sheds and
    landed prefetches. Returns every reading the packages must agree on."""
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import hashing

    p = proactive_parts(pkg)
    rng = random.Random(seed)
    clock = Clock()
    index = backend(pkg, backend_name)
    health = p.health.FleetHealthTracker(
        p.health.FleetHealthConfig(suspect_after_s=3.0, stale_after_s=6.0), clock=clock)
    pop = p.pl.ChainPopularityTracker(
        p.pl.PopularityConfig(half_life_s=8.0, top_k=4, max_prefix_blocks=5), clock=clock)
    table = p.pr.SessionTable(p.pr.PredictionConfig(default_eta_s=2.0, tail_trim_blocks=1,
                                                    max_sessions=5, max_chain_blocks=12),
                              clock=clock)
    if backend_name == "cost_aware":
        index.bind_popularity(pop)
    indexer = p.indexer.Indexer(
        p.indexer.IndexerConfig(token_processor_config=p.tp.TokenProcessorConfig(block_size=PAGE)),
        kv_block_index=index, fleet_health=health)
    pool = p.pool.EventPool(p.pool.EventPoolConfig(concurrency=1, default_device_tier="hbm"),
                            index, indexer.token_processor, popularity=pop,
                            health_tracker=health)
    pool.start(with_subscriber=False)
    jobs = []

    def replicate(pod, hashes, chain):
        jobs.append(("replication", clock.t, pod, list(hashes), chain.head))
        return len(jobs) % 4 != 0  # every fourth job finds the queue full

    replicator = p.pl.HotPrefixReplicator(
        pop, submit_fn=replicate, pods_fn=lambda: list(SIM_PODS),
        config=p.pl.ReplicationConfig(k_replicas=2, hotness_threshold=2.0, cooldown_s=2.0,
                                      max_jobs_per_tick=2, max_prefix_blocks=5),
        fleet_health=health, index=index, clock=clock)
    scheduler = p.pr.PrefetchScheduler(
        table, score_fn=indexer.score_hashes,
        submit_fn=lambda pod, hashes: jobs.append(("prediction", clock.t, pod, list(hashes)))
        or True,
        config=p.pr.SchedulerConfig(max_jobs_per_tick=2, session_cooldown_s=1.0, start_frac=0.5),
        select_fn=p.pr.best_score_select, clock=clock)
    root = hashing.init_hash("")
    sessions = _sessions(rng)
    seqs = {pod: 0 for pod in SIM_PODS}
    held = {pod: [] for pod in SIM_PODS}
    readings = dict(hot=[], scores=[], sketch=[], ticks=[], etas=[], stats=[], sheds=[])
    try:
        for t in range(ticks):
            clock.t = 0.5 * t
            for s in rng.sample(sessions, rng.randint(1, 3)):
                s["tokens"] += [rng.randrange(1000) for _ in range(rng.randint(1, 3) * PAGE)]
                chain = hashing.prefix_hashes_fast(root, s["tokens"], PAGE)
                for tracker in (pop, table):
                    tracker.observe_route(chain, tokens=s["tokens"], model_name=MODEL,
                                          block_size=PAGE)
                if rng.random() < 0.3:
                    s["pod"] = rng.choice(SIM_PODS)
                events = [p.ev.BlockStored(block_hashes=list(chain), parent_block_hash=None,
                                           token_ids=list(s["tokens"]), block_size=PAGE)]
                held[s["pod"]] += [h for h in chain if h not in held[s["pod"]]]
                if len(held[s["pod"]]) > 24:
                    gone, held[s["pod"]] = held[s["pod"]][:6], held[s["pod"]][6:]
                    events.append(p.ev.BlockRemoved(block_hashes=gone))
                pool.add_task(p.pool.Message(
                    topic=f"kv@{s['pod']}@{MODEL}",
                    payload=p.ev.EventBatch(ts=clock.t, events=events).to_msgpack(),
                    seq=seqs[s["pod"]], pod_identifier=s["pod"], model_name=MODEL))
                seqs[s["pod"]] += 1
                pool.drain()  # the pool's store credits land before the lookup's
                pop.observe_lookup(chain[:rng.randint(0, len(chain))])
            before = len(jobs)
            readings["ticks"].append((t, replicator.tick(), scheduler.tick()))
            for job in jobs[before:]:
                if job[0] == "prediction" and rng.random() < 0.7:
                    table.note_landed(job[3][-1], len(job[3]))
            if t in (6, 11):
                readings["sheds"].append((t, pop.shed(0.5), table.shed(0.5)))
            now = clock.t
            readings["hot"].append([dataclasses.astuple(c) for c in pop.hot_chains(1.0, now=now)])
            sample = [h for s in sessions
                      for h in hashing.prefix_hashes_fast(root, s["tokens"], PAGE)[::3]]
            readings["scores"].append([pop.block_score(h, now=now) for h in sample])
            readings["sketch"].append(pop.export_sketch(now=now))
            readings["etas"].append(table.snapshot(now=now, limit=8))
            readings["stats"].append((pop.stats(), table.stats(), dict(replicator.stats),
                                      dict(scheduler.stats)))
    finally:
        pool.shutdown()
    readings.update(jobs=jobs, replicator=replicator.status(), scheduler=scheduler.status(),
                    fleet_eta=table.fleet_eta_s(),
                    index=sorted((h, pod, tier) for _, h, pods in index.export_view().entries
                                 for pod, tier in pods))
    return readings


def stream_matches(backend_name, seed):
    jax = proactive_stream(JAX_PKG, backend_name, seed)
    port = proactive_stream(PORT_PKG, backend_name, seed)
    assert port.keys() == jax.keys()
    for key in jax:
        assert port[key] == jax[key], key
    return port


@pytest.mark.parametrize("backend_name", BACKEND_NAMES, ids=BACKEND_IDS)
def test_proactive_stream_matches_jax(backend_name):
    port = stream_matches(backend_name, seed=3)
    kinds = [j[0] for j in port["jobs"]]
    # The stream exercised what it claims to: hot chains replicated to
    # chosen targets, sessions predicted and pre-landed, both loops shed.
    assert "replication" in kinds and "prediction" in kinds
    assert port["replicator"]["stats"]["drops"] > 0
    assert port["replicator"]["stats"]["skipped_owner"] > 0
    assert any(port["hot"]) and any(port["etas"])
    assert all(a > 0 or b > 0 for _, a, b in port["sheds"])


# -- chip_smoke.py phase 16b, rehearsed on the CPU -------------------------------


@pytest.fixture(scope="module")
def rehearsal_model():
    import chip_smoke

    return chip_smoke.small_model("cpu", seed=0, **chip_smoke.REHEARSAL_MODEL)


def test_phase_16b_arms_rehearse_the_end_to_end_claims(rehearsal_model, transfer_library):
    """tests/test_placement.py's end-to-end claims on the port's pods at CPU
    width: with an unreachable threshold the served stream (routes, cached
    tokens, greedy tokens, every pod's events) is placement off's exactly;
    on, hot prefixes replicate, blocks land where the index says, no target
    is unhealthy and nothing is dropped. The card runs the same arms."""
    import chip_smoke

    params, cfg = rehearsal_model
    requests = chip_smoke.placement_requests()
    arms = {name: chip_smoke.placement_arm(params, cfg, requests, p)
            for name, p in chip_smoke.PLACEMENT_ARMS.items()}
    assert [f for arm in arms.values() for f in arm["failures"]] == []
    assert chip_smoke.placement_bars(arms) == []
    on = arms["on"]
    assert on["replicated_blocks"] > 0 and on["replicator"]["jobs_submitted"] > 0
    assert on["prefetcher"]["by_source"]["replication"]["executed"] > 0
    assert arms["observe"]["streams"] == arms["off"]["streams"]
