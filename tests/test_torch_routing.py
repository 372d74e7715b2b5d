"""The port's routing policy, load tracker and route prefetcher against the
JAX package's, on the same inputs.

Every case of tests/test_routing_policy.py runs as a scenario on both
packages: each asserts what the JAX test asserts, and the two packages'
readings (scores, choices, stats, loads, explain sections) must be exactly
equal. The port has no metrics collector, so the override-metric case
reads the policy's `stats` counter instead. Then `PodLoadTracker` under
seeded random reports, and `RoutePrefetcher` (its bound, counted drops,
drain and close) with the same calls on both packages.
"""

import importlib
import math
import random
import threading
from types import SimpleNamespace

import pytest

from tests.conftest import TEST_MODEL_NAME, TEST_TOKENIZER_JSON

JAX_PKG = "llm_d_kv_cache_manager_tpu"
PORT_PKG = "llm_d_kv_cache_manager_tpu_torch"
MODEL = "routing-model"
BLOCK_SIZE = 4


def _pkg(pkg):
    mods = dict(
        load="fleethealth.load", routing="kvcache.routing", indexer="kvcache.indexer",
        tp="kvcache.kvblock.token_processor", ev="kvevents.events", pool="kvevents.pool",
        in_memory="kvcache.kvblock.in_memory", tpool="tokenization.pool",
        prefetch="kv_connectors.prefetch",
    )
    return SimpleNamespace(name=pkg, **{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in mods.items()})


BOTH = [_pkg(JAX_PKG), _pkg(PORT_PKG)]


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _load(load):
    return (load.queue_depth, load.inflight, load.busy_s, load.preemption_rate)


def _blend_policy(p, clock, **cfg):
    tracker = p.load.PodLoadTracker(clock=clock)
    defaults = dict(policy=p.routing.LOAD_BLEND, load_weight=1.0)
    defaults.update(cfg)
    return p.routing.RoutingPolicy(
        p.routing.RoutingPolicyConfig(**defaults), load_tracker=tracker), tracker


# -- the cases of tests/test_routing_policy.py, as scenarios ------------------


def unknown_pod_reads_idle(p):
    load = p.load.PodLoadTracker(clock=_Clock()).load_of("never-seen")
    assert load == p.load.PodLoad()
    return _load(load)


def reports_age_out(p):
    clock = _Clock()
    tracker = p.load.PodLoadTracker(p.load.PodLoadConfig(stale_report_after_s=10.0),
                                    clock=clock)
    tracker.report("pod-1", queue_depth=5, inflight=3, busy_until=4.0)
    out = [_load(tracker.load_of("pod-1"))]
    assert out[0][:2] == (5, 3) and out[0][2] == pytest.approx(4.0)
    clock.t = 9.0
    out.append(_load(tracker.load_of("pod-1")))
    assert out[-1][0] == 5 and out[-1][2] == 0.0
    clock.t = 11.0
    assert tracker.load_of("pod-1") == p.load.PodLoad()
    return out


def busy_horizon_drains_by_itself(p):
    clock = _Clock()
    tracker = p.load.PodLoadTracker(clock=clock)
    tracker.report("pod-1", busy_until=3.0)
    clock.t = 2.0
    busy = tracker.load_of("pod-1").busy_s
    assert busy == pytest.approx(1.0)
    return busy


def preemption_half_life_decay(p):
    clock = _Clock()
    tracker = p.load.PodLoadTracker(p.load.PodLoadConfig(preemption_half_life_s=30.0),
                                    clock=clock)
    tracker.observe_preemption("pod-1", 8.0)
    out = []
    for t, want in ((0.0, 8.0), (30.0, 4.0), (90.0, 1.0)):
        clock.t = t
        out.append(tracker.load_of("pod-1").preemption_rate)
        assert out[-1] == pytest.approx(want, rel=1e-6)
    return out


def removed_blocks_convert_to_preemption_equivalents(p):
    tracker = p.load.PodLoadTracker(
        p.load.PodLoadConfig(removed_blocks_per_preemption=64.0), clock=_Clock())
    tracker.observe_removed_blocks("pod-1", 128)
    rate = tracker.load_of("pod-1").preemption_rate
    assert rate == pytest.approx(2.0)
    return rate


def dp_ranks_fold_to_base_pod(p):
    tracker = p.load.PodLoadTracker(clock=_Clock())
    tracker.observe_preemption("pod-1@dp3", 2.0)
    tracker.observe_preemption("pod-1", 1.0)
    rate = tracker.load_of("pod-1@dp0").preemption_rate
    assert rate == pytest.approx(3.0)
    return rate


def snapshot_shape(p):
    tracker = p.load.PodLoadTracker(clock=_Clock())
    tracker.report("pod-2", queue_depth=1)
    snap = tracker.snapshot()
    assert set(snap) == {"pod-2"}
    assert set(snap["pod-2"]) == {"queue_depth", "inflight", "busy_s", "preemption_rate"}
    return snap


def invalid_half_life_rejected(p):
    with pytest.raises(ValueError) as err:
        p.load.PodLoadTracker(p.load.PodLoadConfig(preemption_half_life_s=0))
    return str(err.value)


def unknown_policy_rejected(p):
    with pytest.raises(ValueError) as err:
        p.routing.RoutingPolicyConfig(policy="weighted_coinflip")
    return str(err.value)


def negative_weight_and_norms_rejected(p):
    out = []
    for kwargs in (dict(load_weight=-1), dict(queue_depth_norm=0), dict(busy_norm_s=-2)):
        with pytest.raises(ValueError) as err:
            p.routing.RoutingPolicyConfig(**kwargs)
        out.append(str(err.value))
    return out


def prefix_only_is_identity_same_object(p):
    policy = p.routing.RoutingPolicy(p.routing.RoutingPolicyConfig(policy=p.routing.PREFIX_ONLY))
    scores = {"pod-0": 3.0, "pod-1": 1.0}
    assert policy.adjust(scores) is scores
    assert policy.select(scores, ["pod-0", "pod-1"]) is None
    return policy.stats


def no_tracker_and_zero_weight_are_identity(p):
    scores = {"pod-0": 3.0}
    no_tracker = p.routing.RoutingPolicy(p.routing.RoutingPolicyConfig(
        policy=p.routing.LOAD_BLEND))
    assert no_tracker.adjust(scores) is scores
    policy, _ = _blend_policy(p, _Clock(), load_weight=0.0)
    assert policy.adjust(scores) is scores
    empty = {}
    policy2, _ = _blend_policy(p, _Clock())
    assert policy2.adjust(empty) is empty
    return [no_tracker.stats, policy.stats, policy2.stats]


def demotes_loaded_never_drops(p):
    policy, tracker = _blend_policy(p, _Clock(), busy_norm_s=1.0)
    tracker.report("pod-0", busy_until=3.0)  # 3 load units
    out = policy.adjust({"pod-0": 4.0, "pod-1": 2.0})
    assert set(out) == {"pod-0", "pod-1"}
    assert out["pod-0"] == pytest.approx(1.0) and out["pod-1"] == pytest.approx(2.0)
    assert policy.stats["overrides"] == 1
    return out, policy.stats


def idle_fleet_changes_nothing_numerically(p):
    policy, _ = _blend_policy(p, _Clock())
    scores = {"pod-0": 4.0, "pod-1": 2.0}
    out = policy.adjust(scores)
    assert out == scores and policy.stats["overrides"] == 0
    return out, policy.stats


def explain_section(p):
    policy, tracker = _blend_policy(p, _Clock())
    tracker.report("pod-0", busy_until=5.0)
    detail = {}
    policy.adjust({"pod-0": 4.0, "pod-1": 2.0}, _explain=detail)
    section = detail["routing_policy"]
    assert section["policy"] == p.routing.LOAD_BLEND and section["override"] is True
    assert section["prefix_choice"] == "pod-0" and section["blended_choice"] == "pod-1"
    return detail


def saturated_perfect_prefix_loses_to_idle_no_cache(p):
    policy, tracker = _blend_policy(p, _Clock(), load_weight=0.25)
    tracker.report("pod-0", busy_until=8.0)
    detail = {}
    chosen = policy.select({"pod-0": 10.0}, [f"pod-{i}" for i in range(8)], _explain=detail)
    assert chosen != "pod-0" and policy.stats["overrides"] == 1
    return chosen, detail


def mild_load_keeps_the_cache_win(p):
    policy, tracker = _blend_policy(p, _Clock(), load_weight=0.25)
    tracker.report("pod-0", busy_until=0.5)
    chosen = policy.select({"pod-0": 10.0}, [f"pod-{i}" for i in range(8)])
    assert chosen == "pod-0" and policy.stats["overrides"] == 0
    return chosen


def all_idle_reduces_to_prefix_argmax(p):
    policy, _ = _blend_policy(p, _Clock())
    chosen = policy.select({"pod-2": 5.0, "pod-1": 5.0, "pod-0": 1.0},
                           ["pod-0", "pod-1", "pod-2", "pod-3"])
    assert chosen == "pod-1"
    return chosen


def empty_scores_selects_least_loaded(p):
    policy, tracker = _blend_policy(p, _Clock())
    tracker.report("pod-0", busy_until=2.0)
    tracker.report("pod-1", busy_until=1.0)
    chosen = policy.select({}, ["pod-0", "pod-1"])
    assert chosen == "pod-1"
    return chosen


def prefix_only_returns_none(p):
    policy = p.routing.RoutingPolicy(p.routing.RoutingPolicyConfig(policy=p.routing.PREFIX_ONLY))
    assert policy.select({"pod-0": 1.0}, ["pod-0"]) is None


def override_metric_counts(p):
    policy, tracker = _blend_policy(p, _Clock(), load_weight=1.0)
    tracker.report("pod-0", busy_until=50.0)
    before = policy.stats["overrides"]
    policy.select({"pod-0": 10.0}, ["pod-0", "pod-1"])
    assert policy.stats["overrides"] == before + 1
    return policy.stats


def event_pool_feeds_removed_block_pressure(p):
    tracker = p.load.PodLoadTracker(p.load.PodLoadConfig(removed_blocks_per_preemption=4.0),
                                    clock=_Clock())
    index = p.in_memory.InMemoryIndex(p.in_memory.InMemoryIndexConfig(size=256,
                                                                       pod_cache_size=4))
    pool = p.pool.EventPool(p.pool.EventPoolConfig(concurrency=1), index,
                            p.tp.ChunkedTokenDatabase(p.tp.TokenProcessorConfig(
                                block_size=BLOCK_SIZE)), load_tracker=tracker)
    pool.start(with_subscriber=False)
    try:
        store = p.ev.BlockStored(block_hashes=[1, 2], parent_block_hash=None,
                                 token_ids=list(range(8)), block_size=BLOCK_SIZE)
        for seq, events in enumerate(([store], [p.ev.BlockRemoved(block_hashes=[1, 2])])):
            pool.add_task(p.pool.Message(
                topic=f"kv@pod-1@{MODEL}",
                payload=p.ev.EventBatch(ts=0.0, events=events).to_msgpack(),
                seq=seq, pod_identifier="pod-1", model_name=MODEL))
        pool.drain()
        rate = tracker.load_of("pod-1").preemption_rate
        assert rate == pytest.approx(0.5)
        return rate
    finally:
        pool.shutdown()


def _scored_indexer(p, routing_policy=None):
    """An Indexer + digested events for two pods holding the same prefix
    (pod-a the whole chain, pod-b a shorter prefix)."""
    tok_pool = p.tpool.TokenizationPool(p.tpool.TokenizersPoolConfig(
        workers=2, local_tokenizer_files={TEST_MODEL_NAME: TEST_TOKENIZER_JSON}))
    indexer = p.indexer.Indexer(
        config=p.indexer.IndexerConfig(
            token_processor_config=p.tp.TokenProcessorConfig(block_size=BLOCK_SIZE)),
        tokenization_pool=tok_pool, routing_policy=routing_policy)
    indexer.run()
    pool = p.pool.EventPool(p.pool.EventPoolConfig(concurrency=1), indexer.kv_block_index,
                            indexer.token_processor)
    pool.start(with_subscriber=False)
    prompt = "alpha bravo charlie delta echo foxtrot golf hotel"
    tokens = indexer.tokenizers_pool.tokenize(None, prompt, TEST_MODEL_NAME)
    n_blocks = len(tokens) // BLOCK_SIZE
    for pod, depth in (("pod-a", n_blocks), ("pod-b", max(1, n_blocks // 2))):
        ev = p.ev.BlockStored(block_hashes=list(range(1, depth + 1)), parent_block_hash=None,
                              token_ids=list(tokens[: depth * BLOCK_SIZE]),
                              block_size=BLOCK_SIZE)
        pool.add_task(p.pool.Message(
            topic=f"kv@{pod}@{TEST_MODEL_NAME}",
            payload=p.ev.EventBatch(ts=0.0, events=[ev]).to_msgpack(),
            seq=0, pod_identifier=pod, model_name=TEST_MODEL_NAME))
    pool.drain()
    pool.shutdown()
    return indexer, prompt


def indexer_prefix_only_bit_identical(p):
    bare, prompt = _scored_indexer(p)
    pinned, _ = _scored_indexer(p, p.routing.RoutingPolicy(
        p.routing.RoutingPolicyConfig(policy=p.routing.PREFIX_ONLY)))
    try:
        s_bare = bare.get_pod_scores(prompt, TEST_MODEL_NAME, [])
        s_pinned = pinned.get_pod_scores(prompt, TEST_MODEL_NAME, [])
    finally:
        bare.shutdown()
        pinned.shutdown()
    assert s_bare == s_pinned and s_bare
    return s_bare


def indexer_load_blend_demotes_through_read_path(p):
    tracker = p.load.PodLoadTracker(clock=_Clock())
    policy = p.routing.RoutingPolicy(p.routing.RoutingPolicyConfig(
        policy=p.routing.LOAD_BLEND, load_weight=1.0), load_tracker=tracker)
    indexer, prompt = _scored_indexer(p, policy)
    try:
        baseline = dict(indexer.get_pod_scores(prompt, TEST_MODEL_NAME, []))
        tracker.report("pod-a", busy_until=4.0)  # 4 load units
        blended = indexer.get_pod_scores(prompt, TEST_MODEL_NAME, [])
    finally:
        indexer.shutdown()
    assert blended["pod-a"] == pytest.approx(baseline["pod-a"] / 5.0)
    assert blended["pod-b"] == pytest.approx(baseline["pod-b"])
    return baseline, blended, policy.stats


def explain_scores_carries_routing_section(p):
    tracker = p.load.PodLoadTracker(clock=_Clock())
    policy = p.routing.RoutingPolicy(p.routing.RoutingPolicyConfig(policy=p.routing.LOAD_BLEND),
                                     load_tracker=tracker)
    indexer, prompt = _scored_indexer(p, policy)
    try:
        tracker.report("pod-a", busy_until=9.0)
        report = indexer.explain_scores(prompt, TEST_MODEL_NAME, [])
    finally:
        indexer.shutdown()
    assert report["routing_policy"]["policy"] == p.routing.LOAD_BLEND
    return report["routing_policy"]


def status_surface(p):
    policy, tracker = _blend_policy(p, _Clock())
    tracker.report("pod-9", queue_depth=2)
    status = policy.status()
    assert status["policy"] == p.routing.LOAD_BLEND and "pod-9" in status["loads"]
    assert status["stats"] == {"adjusted_requests": 0, "overrides": 0}
    return status


def decay_math_is_half_life(p):
    tracker = p.load.PodLoadTracker(p.load.PodLoadConfig(preemption_half_life_s=10.0))
    assert tracker._lambda == pytest.approx(math.log(2.0) / 10.0)
    return tracker._lambda


CASES = [
    unknown_pod_reads_idle, reports_age_out, busy_horizon_drains_by_itself,
    preemption_half_life_decay, removed_blocks_convert_to_preemption_equivalents,
    dp_ranks_fold_to_base_pod, snapshot_shape, invalid_half_life_rejected,
    unknown_policy_rejected, negative_weight_and_norms_rejected,
    prefix_only_is_identity_same_object, no_tracker_and_zero_weight_are_identity,
    demotes_loaded_never_drops, idle_fleet_changes_nothing_numerically, explain_section,
    saturated_perfect_prefix_loses_to_idle_no_cache, mild_load_keeps_the_cache_win,
    all_idle_reduces_to_prefix_argmax, empty_scores_selects_least_loaded,
    prefix_only_returns_none, override_metric_counts, event_pool_feeds_removed_block_pressure,
    indexer_prefix_only_bit_identical, indexer_load_blend_demotes_through_read_path,
    explain_scores_carries_routing_section, status_surface, decay_math_is_half_life,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_routing_policy_case_matches_jax(case):
    jax_out, port_out = (case(p) for p in BOTH)
    assert port_out == jax_out


# -- the load tracker and the policy under seeded random traffic --------------


@pytest.mark.parametrize("seed", range(4))
def test_load_tracker_and_select_match_jax_on_random_reports(seed):
    """Seeded reports, preemptions and removals at explicit `now` values:
    every `load_of`, snapshot, `select` choice and `adjust` map equal."""
    outs = []
    for p in BOTH:
        rng = random.Random(seed)
        tracker = p.load.PodLoadTracker(p.load.PodLoadConfig(
            preemption_half_life_s=rng.choice([5.0, 30.0]), stale_report_after_s=4.0),
            clock=_Clock())
        policy = p.routing.RoutingPolicy(p.routing.RoutingPolicyConfig(
            policy=p.routing.LOAD_BLEND, load_weight=rng.choice([0.25, 1.0, 2.0])),
            load_tracker=tracker)
        pods = [f"pod-{i}" for i in range(5)] + ["pod-1@dp1"]
        out, now = [], 0.0
        for _ in range(200):
            now += rng.random()
            pod = rng.choice(pods)
            op = rng.randrange(4)
            if op == 0:
                tracker.report(pod, queue_depth=rng.randrange(10), inflight=rng.randrange(4),
                               busy_until=now + rng.random() * 3 if rng.random() < 0.5 else None,
                               now=now)
            elif op == 1:
                tracker.observe_preemption(pod, rng.random() * 3, now=now)
            elif op == 2:
                tracker.observe_removed_blocks(pod, rng.randrange(200), now=now)
            scores = {q: float(rng.randrange(1, 20)) for q in rng.sample(pods, rng.randrange(4))}
            out.append((
                [_load(tracker.load_of(q, now=now)) for q in pods],
                policy.select(scores, pods, now=now),
            ))
        out.append((tracker.snapshot(now=now), policy.stats))
        outs.append(out)
    assert outs[1] == outs[0]


# -- RoutePrefetcher ------------------------------------------------------------


class _Scores:
    """A PodScores stand-in: the chain and each pod's matched prefix."""

    def __init__(self, block_hashes, match_blocks):
        self.block_hashes, self.match_blocks = block_hashes, match_blocks

    def missing_tail(self, pod):
        return self.block_hashes[self.match_blocks.get(pod, 0):]


def _prefetch_run(p, gate: bool):
    """Submissions past the bound while the worker is held, then released:
    the same return values, stats, per-source stats and calls."""
    calls, hold = [], threading.Event()

    def prefetch_fn(pod, hashes):
        if gate:
            hold.wait(5.0)
        calls.append((pod, list(hashes)))
        return len(hashes) - 1

    rp = p.prefetch.RoutePrefetcher(prefetch_fn, queue_bound=2)
    out = [rp.submit("pod-x", [])]  # nothing missing: not queued
    scores = _Scores(list(range(100, 110)), {"pod-a": 3, "pod-b": 10})
    out.append(rp.submit_route("pod-b", scores))  # nothing missing
    first = rp.submit_route("pod-a", scores)
    out.append(first)
    if gate:
        # Wait until the worker holds the first entry, so exactly the
        # bound's worth of later entries fits in the queue.
        for _ in range(500):
            if rp.queue_depth() == 0:
                break
            hold.wait(0.01)
    for i in range(5):
        out.append(rp.submit("pod-c", [i, i + 1], source="prediction" if i % 2 else "route"))
    hold.set()
    rp.drain(timeout_s=5.0)
    out.append(rp.status())
    rp.close()
    out.append(rp.submit("pod-d", [1]))  # closed: refused
    out.append(rp.status()["stats"])
    return out, calls


@pytest.mark.parametrize("gate", [False, True], ids=["free", "held"])
def test_route_prefetcher_matches_jax(gate):
    (jax_out, jax_calls), (port_out, port_calls) = (_prefetch_run(p, gate) for p in BOTH)
    assert port_out == jax_out and port_calls == jax_calls
    assert port_calls[0] == ("pod-a", list(range(103, 110)))  # the missing tail
    if gate:
        stats = port_out[-1]
        assert stats["dropped"] == 3 and stats["submitted"] == 3 and stats["executed"] == 3
