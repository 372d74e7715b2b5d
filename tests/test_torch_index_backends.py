"""The port's cost-aware, Redis and native index backends and the C hash
core against the JAX package's, on the same inputs.

- The common index suite of tests/test_index.py, as scenarios on the
  cost-aware, Redis (tests/fake_redis.py, a real socket server) and native
  backends of both packages: the readings must be exactly equal, and each
  scenario asserts what the JAX test asserts. Then the cost-aware and Redis
  specific cases, and seeded random operation streams under byte budgets.
- The native backend (the port's own build of native/kvscore.c): the
  scenarios of tests/test_native_core.py held against the JAX package's
  Python backends and, where the JAX package's build is importable, its
  native module. Its score plans here run with the routing policy only;
  tests/test_torch_fleethealth.py runs them with both trackers.
- The C hash core (native/fnvcbor.c): every fast path equals its
  pure-Python definition and the JAX package's hashes.
- The event pool's native digest and the Indexer's native score plan
  against the sharded path, through msgpack messages and four workers.
"""

import importlib
import random
import threading
from types import SimpleNamespace

import pytest

from tests.fake_redis import FakeRedisServer

JAX_PKG = "llm_d_kv_cache_manager_tpu"
PORT_PKG = "llm_d_kv_cache_manager_tpu_torch"
MODEL = "native-core-model"
PODS = [f"pod-{i}" for i in range(6)] + ["pod-2@dp1"]
TIERS = ["hbm", "host"]
WEIGHTS = {"hbm": 1.0, "host": 0.8}


def _pkg(pkg):
    mods = dict(
        key="kvcache.kvblock.key", index="kvcache.kvblock.index",
        cost="kvcache.kvblock.cost_aware", redis="kvcache.kvblock.redis_index",
        resp="kvcache.kvblock.resp", native="kvcache.kvblock.native_index",
        sharded="kvcache.kvblock.sharded", in_memory="kvcache.kvblock.in_memory",
        hashing="kvcache.kvblock.hashing", tp="kvcache.kvblock.token_processor",
        scorer="kvcache.scorer", routing="kvcache.routing", indexer="kvcache.indexer",
        ev="kvevents.events", pool="kvevents.pool", tpool="tokenization.pool",
        tok="tokenization.tokenizer", humansize="utils.humansize",
    )
    return SimpleNamespace(name=pkg, **{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in mods.items()})


JAX, PORT = _pkg(JAX_PKG), _pkg(PORT_PKG)
BOTH = [JAX, PORT]
_server = None


def _redis_url():
    global _server
    if _server is None:
        _server = FakeRedisServer()
    return _server.url


def _jax_native_built():
    return JAX.native.have_native_index()


def _backend(p, name):
    """A fresh backend of package `p` (the Redis one FLUSHALLs the shared
    fake server, so the two packages' runs never overlap)."""
    if name == "cost_aware":
        return p.cost.CostAwareMemoryIndex(p.cost.CostAwareIndexConfig(
            max_size_bytes="1MiB", pod_cache_size=10))
    if name == "redis":
        index = p.redis.RedisIndex(p.redis.RedisIndexConfig(url=_redis_url()))
        index._pipeline([("FLUSHALL",)])
        return index
    if name == "native":
        if p is JAX and not _jax_native_built():
            # The JAX package's build is absent: its Python backend is the
            # reference the native one is bit-identical to.
            return p.sharded.ShardedIndex(p.sharded.ShardedIndexConfig(size=1000,
                                                                       pod_cache_size=10))
        return p.native.NativeScoringIndex(p.native.NativeIndexConfig(size=1000,
                                                                      pod_cache_size=10))
    raise ValueError(name)


def _close(index):
    if hasattr(index, "close"):
        index.close()


def _k(p, i, model="m"):
    return p.key.Key(model, i)


def _pod(p, name, tier="hbm"):
    return p.key.PodEntry(name, tier)


def _view(view):
    """An IndexView's rows (the two packages' IndexView classes differ)."""
    return view.entries, view.engine_map


def _plain(result):
    """A lookup result as plain tuples, key and entry order kept."""
    return [((k.model_name, k.chunk_hash), [(e.pod_identifier, e.device_tier) for e in v])
            for k, v in result.items()]


# -- the common suite of tests/test_index.py, as scenarios --------------------


def basic_add_and_lookup(p, index):
    keys = [_k(p, 1), _k(p, 2)]
    index.add(keys, keys, [_pod(p, "p1")])
    got = index.lookup(keys, set())
    assert got == {_k(p, 1): [_pod(p, "p1")], _k(p, 2): [_pod(p, "p1")]}
    return _plain(got)


def duplicate_pod_handling(p, index):
    index.add([_k(p, 1)], [_k(p, 1)], [_pod(p, "p1")])
    index.add([_k(p, 1)], [_k(p, 1)], [_pod(p, "p1")])
    got = index.lookup([_k(p, 1)], set())
    assert got[_k(p, 1)] == [_pod(p, "p1")]
    return _plain(got)


def multiple_pods_and_tiers(p, index):
    index.add([_k(p, 1)], [_k(p, 1)],
              [_pod(p, "p1", "hbm"), _pod(p, "p1", "host"), _pod(p, "p2")])
    got = index.lookup([_k(p, 1)], set())
    assert set(got[_k(p, 1)]) == {_pod(p, "p1", "hbm"), _pod(p, "p1", "host"), _pod(p, "p2")}
    return sorted(_plain(got)[0][1])


def filtered_lookup(p, index):
    index.add([_k(p, 1)], [_k(p, 1)], [_pod(p, "p1"), _pod(p, "p2")])
    got = index.lookup([_k(p, 1)], {"p2"})
    assert got[_k(p, 1)] == [_pod(p, "p2")]
    return _plain(got)


def filtered_lookup_no_match_omits_key(p, index):
    index.add([_k(p, 1)], [_k(p, 1)], [_pod(p, "p1")])
    got = index.lookup([_k(p, 1)], {"nope"})
    assert _k(p, 1) not in got
    return _plain(got)


def evict_basic(p, index):
    index.add([_k(p, 1)], [_k(p, 1)], [_pod(p, "p1"), _pod(p, "p2")])
    index.evict(_k(p, 1), [_pod(p, "p1")])
    got = index.lookup([_k(p, 1)], set())
    assert got[_k(p, 1)] == [_pod(p, "p2")]
    return _plain(got)


def evict_last_pod_removes_key(p, index):
    index.add([_k(p, 1)], [_k(p, 1)], [_pod(p, "p1")])
    index.evict(_k(p, 1), [_pod(p, "p1")])
    assert index.lookup([_k(p, 1)], set()) == {}
    assert index.get_request_key(_k(p, 1)) is None


def evict_unknown_engine_key_is_noop(p, index):
    index.evict(_k(p, 99), [_pod(p, "p1")])


def engine_to_request_key_mapping(p, index):
    engine, request = _k(p, 100), _k(p, 200)
    index.add([engine], [request], [_pod(p, "p1")])
    assert index.get_request_key(engine) == request
    assert request in index.lookup([request], set())
    return tuple(index.get_request_key(engine))


def empty_inputs_raise(p, index):
    out = []
    for call in (lambda: index.lookup([], set()), lambda: index.add([], [], []),
                 lambda: index.evict(_k(p, 1), [])):
        with pytest.raises(ValueError) as err:
            call()
        out.append(str(err.value))
    return out


def mismatched_key_lengths_raise(p, index):
    with pytest.raises(ValueError) as err:
        index.add([_k(p, 1), _k(p, 2)], [_k(p, 1)], [_pod(p, "p1")])
    return str(err.value)


def concurrent_operations(p, index):
    keys = [_k(p, i) for i in range(20)]
    errors = []

    def writer(pod):
        try:
            for key in keys:
                index.add([key], [key], [_pod(p, pod)])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def reader():
        try:
            for _ in range(50):
                index.lookup(keys, set())
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(f"p{i}",)) for i in range(4)]
    threads += [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    got = index.lookup(keys, set())
    for key in keys:
        assert {e.pod_identifier for e in got[key]} == {"p0", "p1", "p2", "p3"}
    return sorted((k.chunk_hash, sorted(e.pod_identifier for e in v)) for k, v in got.items())


def dp_ranked_identity_matches_bare_filter(p, index):
    entry = p.key.PodEntry("pod-9@dp3", "host")
    index.add([_k(p, 7)], [_k(p, 7)], [entry])
    assert index.lookup([_k(p, 7)], {"pod-9"})[_k(p, 7)] == [entry]
    assert index.lookup([_k(p, 7)], {"pod-9@dp3"})[_k(p, 7)] == [entry]
    index.evict(_k(p, 7), [entry])
    return _plain(index.lookup([_k(p, 7)], set()))


COMMON = [
    basic_add_and_lookup, duplicate_pod_handling, multiple_pods_and_tiers, filtered_lookup,
    filtered_lookup_no_match_omits_key, evict_basic, evict_last_pod_removes_key,
    evict_unknown_engine_key_is_noop, engine_to_request_key_mapping, empty_inputs_raise,
    mismatched_key_lengths_raise, concurrent_operations, dp_ranked_identity_matches_bare_filter,
]


@pytest.mark.parametrize("backend", ["cost_aware", "redis", "native"])
@pytest.mark.parametrize("case", COMMON, ids=lambda c: c.__name__)
def test_common_index_case_matches_jax(case, backend):
    outs = []
    for p in BOTH:
        index = _backend(p, backend)
        try:
            outs.append(case(p, index))
        finally:
            _close(index)
    assert outs[1] == outs[0]


def test_new_index_builds_every_backend():
    """`new_index` builds the cost-aware, Redis and native backends (the
    in-memory config wins over the others, as in the reference)."""
    idx = PORT.index
    cost = idx.new_index(idx.IndexConfig(cost_aware_config=PORT.cost.CostAwareIndexConfig()))
    redis = idx.new_index(idx.IndexConfig(redis_config=PORT.redis.RedisIndexConfig(
        url=_redis_url())))
    native = idx.new_index(idx.IndexConfig(
        in_memory_config=PORT.in_memory.InMemoryIndexConfig(size=64, pod_cache_size=3),
        native=True, cost_aware_config=PORT.cost.CostAwareIndexConfig()))
    try:
        assert type(cost) is PORT.cost.CostAwareMemoryIndex
        assert type(redis) is PORT.redis.RedisIndex
        assert type(native) is PORT.native.NativeScoringIndex
        assert (native.config.size, native.config.pod_cache_size) == (64, 3)
        assert not isinstance(idx.new_index(idx.IndexConfig.default()),
                              PORT.native.NativeScoringIndex)
    finally:
        redis.close()


# -- cost-aware ---------------------------------------------------------------------


def _cost(p, budget, pods=4):
    return p.cost.CostAwareMemoryIndex(p.cost.CostAwareIndexConfig(max_size_bytes=budget,
                                                                   pod_cache_size=pods))


def test_cost_aware_budget_eviction_matches_jax():
    outs = []
    for p in BOTH:
        index = _cost(p, 2000)
        keys = [_k(p, i) for i in range(50)]
        for key in keys:
            index.add([key], [key], [_pod(p, "p1")])
        assert index.total_cost_bytes <= 2000
        assert index.lookup([keys[-1]], set()) and not index.lookup([keys[0]], set())
        outs.append((index.total_cost_bytes, _view(index.export_view()),
                     dict(index.eviction_stats)))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("text", ["4KiB", "2GiB", "512 MB", "1.5kb", 1234, 99.9, "10", "7 tb"])
def test_human_size_parsing_matches_jax(text):
    assert PORT.humansize.parse_human_size(text) == JAX.humansize.parse_human_size(text)
    assert _cost(PORT, "4KiB")._budget == 4096


@pytest.mark.parametrize("text", ["", "12 parsecs", "MB", "-1MB"])
def test_human_size_errors_match_jax(text):
    errs = []
    for p in BOTH:
        with pytest.raises(ValueError) as err:
            p.humansize.parse_human_size(text)
        errs.append(str(err.value))
    assert errs[1] == errs[0]


def test_cost_aware_evicted_key_drops_engine_mapping():
    outs = []
    for p in BOTH:
        index = _cost(p, 600)
        engine, request = _k(p, 1000), _k(p, 2000)
        index.add([engine], [request], [_pod(p, "p1")])
        for i in range(30):
            index.add([_k(p, i)], [_k(p, i)], [_pod(p, "p1")])
        assert index.get_request_key(engine) is None
        outs.append(_view(index.export_view()))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("seed, budget", [(0, 3000), (1, 20_000), (2, "8KiB"), (3, 1 << 20)])
def test_cost_aware_random_ops_match_jax(seed, budget):
    """A seeded stream of adds (multi-key chains, several pods and tiers),
    evictions, lookups with filters, pod removals and entry removals: the
    same readings after every operation, the bytes held within the budget,
    and the same final view."""
    outs = []
    for p in BOTH:
        rng = random.Random(seed)
        index = _cost(p, budget)
        parsed = p.humansize.parse_human_size(budget)
        out = []
        for _ in range(400):
            op = rng.randrange(10)
            if op < 5:
                n = rng.randint(1, 5)
                base = rng.randrange(300)
                eng = [_k(p, 10_000 + base + j) for j in range(n)]
                req = [_k(p, base + j) for j in range(n)]
                ents = [_pod(p, rng.choice(PODS), rng.choice(TIERS))
                        for _ in range(rng.randint(1, 3))]
                index.add(eng, req, ents)
            elif op < 7:
                index.evict(_k(p, 10_000 + rng.randrange(300)),
                            [_pod(p, rng.choice(PODS), rng.choice(TIERS))])
            elif op < 9:
                keys = [_k(p, rng.randrange(300)) for _ in range(rng.randint(1, 6))]
                pods = set(rng.sample(PODS, rng.randint(0, 2)))
                out.append(_plain(index.lookup(keys, pods)))
            elif rng.random() < 0.5:
                out.append(index.remove_pod(rng.choice(PODS)))
            else:
                out.append(index.remove_entries(
                    rng.choice(PODS), [_k(p, rng.randrange(300)) for _ in range(5)],
                    {rng.choice(TIERS)} if rng.random() < 0.5 else None))
            assert index.total_cost_bytes <= parsed
            out.append(index.total_cost_bytes)
        out.append(_view(index.export_view()))
        outs.append(out)
    assert outs[1] == outs[0]


# -- Redis (the fake server: a real socket) -------------------------------------------


def test_valkey_url_normalization_matches_jax():
    for url in ("valkey://h:1", "valkeys://h:1", "h:1", "redis://h:1", "unix:///tmp/r.sock"):
        assert PORT.resp._normalize_url(url) == JAX.resp._normalize_url(url)
    assert PORT.resp._normalize_url("valkey://h:1") == "redis://h:1"


def test_redis_missing_key_cuts_lookup_and_state_is_shared():
    outs = []
    for p in BOTH:
        a = _backend(p, "redis")
        b = p.redis.RedisIndex(p.redis.RedisIndexConfig(url=_redis_url()))
        try:
            a.add([_k(p, 2)], [_k(p, 2)], [_pod(p, "p1")])
            cut = a.lookup([_k(p, 1), _k(p, 2)], set())
            assert cut == {}
            a.add([_k(p, 5)], [_k(p, 5)], [_pod(p, "p9")])
            shared = b.lookup([_k(p, 5)], set())
            assert shared == {_k(p, 5): [_pod(p, "p9")]}
            outs.append((_plain(cut), _plain(shared), _view(b.export_view())))
        finally:
            a.close()
            b.close()
    assert outs[1] == outs[0]


def test_redis_outage_cuts_chain_then_recovers():
    """The connection severed under the client: the read path reconnects
    inside the pipeline (the server is up) and reads the entry."""
    outs = []
    for p in BOTH:
        index = p.redis.RedisIndex(p.redis.RedisIndexConfig(url=_redis_url(), timeout_s=1.0))
        index._pipeline([("FLUSHALL",)])
        try:
            key = _k(p, 9)
            index.add([key], [key], [_pod(p, "p1")])
            index._conn.close()
            outs.append(_plain(index.lookup([key], set())))
        finally:
            index.close()
    assert outs[1] == outs[0] == [(("m", 9), [("p1", "hbm")])]


@pytest.mark.parametrize("seed", [0, 1])
def test_redis_random_ops_match_jax(seed):
    """Seeded adds, evictions, filtered lookups (also batched through
    `lookup_many`'s one round trip), pod and entry removals, and the final
    export view, on both packages' clients against the same server."""
    outs = []
    for p in BOTH:
        rng = random.Random(seed)
        index = _backend(p, "redis")
        out = []
        try:
            for _ in range(60):
                op = rng.randrange(8)
                if op < 4:
                    n = rng.randint(1, 4)
                    base = rng.randrange(60)
                    index.add([_k(p, 5000 + base + j) for j in range(n)],
                              [_k(p, base + j) for j in range(n)],
                              [_pod(p, rng.choice(PODS), rng.choice(TIERS))])
                elif op == 4:
                    index.evict(_k(p, 5000 + rng.randrange(60)),
                                [_pod(p, rng.choice(PODS), rng.choice(TIERS))])
                elif op == 5:
                    reqs = [([_k(p, rng.randrange(60)) for _ in range(3)],
                             set(rng.sample(PODS, rng.randint(0, 2)))) for _ in range(3)]
                    out.append([_plain(dict(r)) for r in index.lookup_many(reqs)])
                    out.append([_plain(index.lookup(k, s)) for k, s in reqs])
                elif op == 6:
                    out.append(index.remove_pod(rng.choice(PODS)))
                else:
                    out.append(index.remove_entries(
                        rng.choice(PODS), [_k(p, rng.randrange(60)) for _ in range(4)]))
            view = index.export_view()
            out.append((sorted(view.entries), sorted(view.engine_map)))
        finally:
            index.close()
        outs.append(out)
    assert outs[1] == outs[0]


# -- the native backend (tests/test_native_core.py's scenarios) ---------------------


def _populate(p, rng, indexes, n_chains=10, models=(MODEL,)):
    chains = {m: [] for m in models}
    for model in models:
        for _ in range(n_chains):
            chain = [rng.getrandbits(64) for _ in range(rng.randint(1, 8))]
            chains[model].append(chain)
            for h in chain:
                req = [p.key.Key(model, h)]
                eng = [p.key.Key(model, h ^ 0xABCDEF)]
                ents = [p.key.PodEntry(rng.choice(PODS), rng.choice(TIERS))
                        for _ in range(rng.randint(1, 4))]
                for ix in indexes:
                    ix.add(eng, req, ents)
    return chains


def _native_pair(p, size=10_000):
    return (p.native.NativeScoringIndex(p.native.NativeIndexConfig(size=size, pod_cache_size=4)),
            p.sharded.ShardedIndex(p.sharded.ShardedIndexConfig(size=size, pod_cache_size=4)))


def _contract_readings(p, nat):
    """tests/test_native_core.py's contract scenario on `nat`."""
    rng = random.Random(11)
    chains = _populate(p, rng, (nat,), models=(MODEL, "other/model"))
    Key, PodEntry = p.key.Key, p.key.PodEntry
    for model, model_chains in chains.items():
        for chain in model_chains[:3]:
            nat.evict(Key(model, chain[0] ^ 0xABCDEF), [PodEntry("pod-1", "hbm")])
    out = [nat.remove_pod("pod-3"),
           nat.remove_entries("pod-2", [Key(MODEL, c[0]) for c in chains[MODEL][:4]])]
    for model, model_chains in chains.items():
        for chain in model_chains:
            keys = [Key(model, h) for h in chain]
            for pods in (set(), {"pod-0", "pod-2"}, {"nope"}):
                out.append(_plain(nat.lookup(keys, pods)))
            rk = nat.get_request_key(Key(model, chain[0] ^ 0xABCDEF))
            out.append(None if rk is None else tuple(rk))
    out.append(nat.get_request_key(Key("m/none", 1)))
    return out


def test_native_contract_matches_sharded_and_jax():
    """Lookups (filtered too), evictions, request-key mapping and bulk
    removals: the port's arena equals the JAX package's ShardedIndex, and
    the JAX arena where it is built (the port's ShardedIndex has no
    `remove_entries` yet: its callers are the fleet planes)."""
    readings = [_contract_readings(PORT, _native_pair(PORT)[0]),
                _contract_readings(JAX, _native_pair(JAX)[1])]
    if _jax_native_built():
        readings.append(_contract_readings(JAX, _native_pair(JAX)[0]))
    assert all(r == readings[0] for r in readings[1:])


def test_native_validation_errors_match_sharded():
    nat, sha = _native_pair(PORT)
    jax_sha = _native_pair(JAX)[1]
    for p, indexes in ((PORT, (nat, sha)), (JAX, (jax_sha,))):
        key = [p.key.Key(MODEL, 1)]
        ents = [p.key.PodEntry("p", "hbm")]
        cases = (("lookup", ([], set())), ("add", ([], [], ents)), ("add", (key, [], ents)),
                 ("add", (key + key, key, ents)), ("evict", (p.key.Key(MODEL, 1), [])))
        for name, call in cases:
            msgs = []
            for ix in indexes + (nat,):
                with pytest.raises(ValueError) as err:
                    getattr(ix, name)(*call)
                msgs.append(str(err.value))
            assert len(set(msgs)) == 1, (name, msgs)


def test_native_export_import_round_trip():
    rng = random.Random(5)
    nat, _ = _native_pair(PORT)
    chains = _populate(PORT, rng, (nat,))
    view = nat.export_view()
    fresh = PORT.native.NativeScoringIndex(PORT.native.NativeIndexConfig(size=10_000))
    assert fresh.import_view(view) == view.entry_count()
    for chain in chains[MODEL]:
        keys = [PORT.key.Key(MODEL, h) for h in chain]
        assert nat.lookup(keys, set()) == fresh.lookup(keys, set())
        ek = PORT.key.Key(MODEL, chain[0] ^ 0xABCDEF)
        assert nat.get_request_key(ek) == fresh.get_request_key(ek)


def test_native_arenas_of_the_two_packages_are_separate():
    """The port's extension is its own file with its own static state: an
    arena's contents never show in another arena, the JAX package's (where
    its build is importable) included."""
    arenas = [_native_pair(PORT)[0], _native_pair(PORT)[0]]
    if _jax_native_built():
        arenas.append(_native_pair(JAX)[0])
        assert type(arenas[0]._arena) is not type(arenas[2]._arena)
        assert PORT.native._module().__file__ != importlib.import_module(
            f"{JAX_PKG}._kvtpu_kvscore").__file__
    _populate(PORT, random.Random(1), arenas[:1])
    assert arenas[0].native_status()["keys"] > 0
    assert all(a.native_status()["keys"] == 0 for a in arenas[1:])


class _Load:
    """Deterministic per-pod load for the routing-policy legs."""

    def __init__(self, loads):
        self.loads = loads

    def load_of(self, pod, now=None):
        q, b, r = self.loads.get(pod, (0, 0.0, 0.0))
        return SimpleNamespace(queue_depth=q, busy_s=b, preemption_rate=r)


def _python_pipeline(p, specs, index, rp):
    scorer = p.scorer.LongestPrefixScorer(WEIGHTS)
    plan = []
    for spec in specs:
        if spec["ref"] is None:
            plan.append(("solo", spec["keys"], index.lookup(spec["keys"], set(spec["pods"])),
                         spec.get("forked", False)))
        else:
            hits = index.lookup(spec["tail"], set(spec["pods"])) if spec["tail"] else {}
            plan.append(("fork", spec["ref"], spec["shared"], spec["tail"], hits))
    out = []
    for scores, match in scorer.score_plan(plan):
        if rp is not None:
            scores = rp.adjust(scores)
        out.append((scores, match))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_native_score_plan_matches_python_pipeline(seed):
    """Seeded solo + fork plans, with and without a load-blend routing
    policy: the port's fused crossing equals the Python pipeline on the
    port's and the JAX package's backends (and the JAX arena where built),
    routing stats included."""
    results = []
    sides = [(PORT, True), (PORT, False), (JAX, False)]
    if _jax_native_built():
        sides.append((JAX, True))
    for p, native in sides:
        rng = random.Random(seed)
        nat, sha = _native_pair(p)
        index = nat if native else sha
        chains = _populate(p, rng, (index,), n_chains=12)[MODEL]
        out = []
        for trial in range(12):
            load = _Load({pod: (rng.randint(0, 8), rng.random(), rng.random() * 4)
                          for pod in PODS})
            rp = p.routing.RoutingPolicy(p.routing.RoutingPolicyConfig(
                policy=p.routing.LOAD_BLEND, load_weight=0.7), load_tracker=load) \
                if trial % 2 else None
            keys = [p.key.Key(MODEL, h) for h in rng.choice(chains)]
            pods_t = rng.choice([(), tuple(sorted(rng.sample(PODS, 3)))])
            shared = rng.randint(1, len(keys))
            tail = [p.key.Key(MODEL, h) for h in rng.choice(chains)][: rng.randint(0, 3)]
            specs = [
                {"item": 0, "keys": keys, "ref": None, "pods": pods_t, "forked": True},
                {"item": 1, "keys": keys[:shared] + tail, "ref": 0, "shared": shared,
                 "tail": tail, "pods": pods_t},
                {"item": 2, "keys": [p.key.Key(MODEL, h) for h in rng.choice(chains)],
                 "ref": None, "pods": ()},
            ]
            if native:
                got = index.score_plan(specs, WEIGHTS, routing_policy=rp)
            else:
                got = _python_pipeline(p, specs, index, rp)
            out.append((got, None if rp is None else dict(rp.stats)))
        results.append(out)
    assert all(r == results[0] for r in results[1:])


def _adversarial_batches(p, seed, bs=16):
    """tests/test_native_core.py's adversarial stream: oversized ints, raw
    bytes, bools, empty hashes, garbage LoRA ids, parent chaining, mixed
    mediums, removals, clears."""
    rng = random.Random(seed)

    def rand_hash():
        choice = rng.randint(0, 9)
        if choice < 6:
            return rng.getrandbits(64)
        if choice == 6:
            return rng.getrandbits(96)
        if choice == 7:
            return rng.getrandbits(64).to_bytes(8, "big")
        if choice == 8:
            return True
        return b""

    stored, out = [], []
    for _ in range(200):
        pod = rng.choice(PODS[:5])
        kind = rng.randint(0, 5)
        if kind <= 3:
            n_blocks = rng.randint(1, 4)
            toks = [rng.randint(0, 50000) for _ in range(n_blocks * bs + rng.randint(0, bs - 1))]
            hashes = [rand_hash() for _ in range(n_blocks)]
            parent = rng.choice(rng.choice(stored)) if stored and rng.random() < 0.5 else None
            ev = p.ev.BlockStored(block_hashes=hashes, parent_block_hash=parent, token_ids=toks,
                                  block_size=bs, lora_id=rng.choice([None, 0, 3, -1, True, "bad"]),
                                  medium=rng.choice([None, "hbm", "HOST"]))
            good = [h for h in hashes if not isinstance(h, bool) and h != b""]
            if good:
                stored.append(good)
        elif kind == 4 and stored:
            ev = p.ev.BlockRemoved(block_hashes=list(rng.choice(stored)),
                                   medium=rng.choice([None, "hbm"]))
        else:
            ev = p.ev.AllBlocksCleared()
        out.append((pod, p.ev.EventBatch(ts=1.0, events=[ev])))
    return out


def _state(view):
    return ({(e[0], e[1]): e[2] for e in view.entries},
            {(r[0], r[1]): (r[2], r[3]) for r in view.engine_map})


@pytest.mark.parametrize("seed", [99, 100])
def test_native_digest_reaches_the_python_state(seed):
    """The adversarial stream through the port's digest seam into its arena
    reaches the state the JAX package's Python digest reaches in its
    ShardedIndex (and its arena, where built); the port's ShardedIndex too.
    Same keys, per-key pod tuples and engine mappings."""
    states = []
    sides = [(PORT, True), (PORT, False), (JAX, False)]
    if _jax_native_built():
        sides.append((JAX, True))
    for p, native in sides:
        tp = p.tp.ChunkedTokenDatabase(p.tp.TokenProcessorConfig(block_size=16,
                                                                 chain_memo=False))
        index = (p.native.NativeScoringIndex(p.native.NativeIndexConfig(size=50_000)) if native
                 else p.sharded.ShardedIndex(p.sharded.ShardedIndexConfig(size=50_000)))
        pool = p.pool.EventPool(p.pool.EventPoolConfig(default_device_tier="hbm"), index, tp)
        for pod, batch in _adversarial_batches(p, seed):
            if p is PORT:
                p.pool.digest_events(index, tp, pod, MODEL, batch, "hbm")
            else:
                pool._digest_events(pod, MODEL, batch)
        if native:
            status = index.native_status()
            assert status["blocks_applied"] > 0
            assert status["keys"] == len(index.export_view().entries)
        states.append(_state(index.export_view()))
    assert all(s == states[0] for s in states[1:])
    assert PORT.native.fallback_total() == 0


def test_native_readers_race_a_writer_then_match_a_replay():
    """Reader threads on the seqlock'd read path (score_plan, lookup) while
    one writer digests into the same arena: no error, and the final state
    equals a sequential replay."""
    p, bs = PORT, 16
    rng = random.Random(3)
    tp = p.tp.ChunkedTokenDatabase(p.tp.TokenProcessorConfig(block_size=bs, chain_memo=False))
    nat = p.native.NativeScoringIndex(p.native.NativeIndexConfig(size=100_000))
    toks = [rng.randint(0, 50000) for _ in range(bs * 4)]
    batches = []
    for i in range(400):
        hashes = [i * 4 + j + 1 for j in range(4)]
        events = [p.ev.BlockStored(block_hashes=hashes, parent_block_hash=None, token_ids=toks,
                                   block_size=bs)]
        if i % 5 == 4:
            events.append(p.ev.BlockRemoved(block_hashes=hashes[:2]))
        batches.append(p.ev.EventBatch(ts=float(i), events=events))
    errors, stop = [], threading.Event()

    def reader(seed):
        r = random.Random(seed)
        try:
            while not stop.is_set():
                view = nat.export_view()
                if view.entries:
                    row = r.choice(view.entries)
                    key = p.key.Key(row[0], row[1])
                    assert len(nat.score_plan([{"item": 0, "keys": [key], "ref": None,
                                                "pods": ()}], WEIGHTS)) == 1
                    nat.lookup([key], set())
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    readers = [threading.Thread(target=reader, args=(s,)) for s in range(4)]
    for t in readers:
        t.start()
    try:
        for i, b in enumerate(batches):
            p.pool.digest_events(nat, tp, f"pod-{i % 4}", MODEL, b)
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in readers)
    replay = p.native.NativeScoringIndex(p.native.NativeIndexConfig(size=100_000))
    for i, b in enumerate(batches):
        p.pool.digest_events(replay, tp, f"pod-{i % 4}", MODEL, b)
    assert _state(nat.export_view())[0] == _state(replay.export_view())[0]
    assert nat.native_status()["locked_lookups"] >= 0


def test_native_non_fnv_hash_algo_digests_in_python():
    p = PORT
    tp = p.tp.ChunkedTokenDatabase(p.tp.TokenProcessorConfig(
        block_size=4, chain_memo=False, hash_algo="sha256_cbor_64bit", hash_seed="42"))
    nat = p.native.NativeScoringIndex(p.native.NativeIndexConfig(size=4096))
    batch = p.ev.EventBatch(ts=1.0, events=[p.ev.BlockStored(
        block_hashes=[1, 2], parent_block_hash=None, token_ids=list(range(8)), block_size=4)])
    assert not p.pool.native_digest(nat, tp, "pod-0", MODEL, batch)
    p.pool.digest_events(nat, tp, "pod-0", MODEL, batch)
    assert nat.native_status()["blocks_applied"] == 0 and nat.stats()["keys"] == 2


# -- the C hash core ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_native_hash_streams_equal_the_plain_ones(seed):
    """`have_native()` is true with the port's build; every fast path
    (single, batched, fingerprints) equals its pure-Python definition and
    the JAX package's hashes, extra keys and odd lengths included."""
    h = PORT.hashing
    assert h.have_native()
    rng = random.Random(seed)
    tasks = []
    for _ in range(40):
        block = rng.choice([1, 4, 16, 17])
        tokens = [rng.randrange(1 << rng.choice([8, 17, 32])) for _ in range(rng.randrange(0, 300))]
        extra = rng.choice([None, (rng.randrange(1000),), (0, 7)])
        parent = rng.getrandbits(64)
        tasks.append((parent, tokens, block, extra, "fnv64_cbor"))
        chunks = [tokens[i * block:(i + 1) * block] for i in range(len(tokens) // block)]
        want = h.prefix_hashes(parent, chunks, extra)
        assert h.prefix_hashes_fast(parent, tokens, block, extra) == want
        assert JAX.hashing.prefix_hashes_fast(parent, tokens, block, extra) == want
        seg = rng.choice([1, 3, 16])
        fp0 = rng.getrandbits(64)
        assert h.token_fingerprints(fp0, tokens, seg) == h.token_fingerprints_plain(
            fp0, tokens, seg) == JAX.hashing.token_fingerprints(fp0, tokens, seg)
    want_many = [h.prefix_hashes(t[0], [t[1][i * t[2]:(i + 1) * t[2]]
                                        for i in range(len(t[1]) // t[2])], t[3]) for t in tasks]
    assert h.prefix_hashes_fast_many(tasks) == want_many
    mixed = tasks[:3] + [(5, list(range(40)), 4, None, "sha256_cbor_64bit")]
    assert h.prefix_hashes_fast_many(mixed) == JAX.hashing.prefix_hashes_fast_many(mixed)


@pytest.mark.parametrize("tokens", [
    [-1, 2, 3, 4], [1.0, 2.0, 3.0, 4.0], [1 << 70, 1, 2, 3], [1 << 40, 1, 2, 3], [True, 2, 3, 4],
], ids=["negative", "floats", "huge", "wide", "bool"])
def test_native_hash_rejects_fall_back_to_the_plain_path(tokens):
    """Tokens the C conversion refuses take the pure-Python path, as in the
    reference: the same hashes, or the same error, on both packages."""
    for call in (lambda h: h.prefix_hashes_fast(7, tokens, 2),
                 lambda h: h.token_fingerprints(7, tokens, 2)):
        outs = []
        for h in (JAX.hashing, PORT.hashing):
            try:
                outs.append(call(h))
            except (ValueError, OverflowError) as e:
                outs.append((type(e).__name__, str(e)))
        assert outs[1] == outs[0]


# -- the pool's native digest and the Indexer's native score plan --------------------


class _WordTokenizer:
    """Word i of the prompt is token int(word)."""

    def __new__(cls, p):
        class Word(p.tok.Tokenizer):
            def encode(self, prompt, model_name):
                words = prompt.split(" ")
                offsets, pos = [], 0
                for w in words:
                    offsets.append((pos, pos + len(w)))
                    pos += len(w) + 1
                return p.tok.TokenizationResult(tokens=[int(w) for w in words], offsets=offsets)

        return Word()


def _fleet(p, native, seed, bs=4):
    """Seeded per-pod streams (shared prefixes, unique tails, removals) as
    msgpack messages through an EventPool of 4 workers; then score_many,
    score_hashes and get_pod_scores_ex over seeded prompts."""
    rng = random.Random(seed)
    indexer = p.indexer.Indexer(
        p.indexer.IndexerConfig(
            token_processor_config=p.tp.TokenProcessorConfig(block_size=bs),
            kv_block_index_config=p.index.IndexConfig(
                in_memory_config=p.in_memory.InMemoryIndexConfig(), native=native),
            tokenizers_pool_config=p.tpool.TokenizersPoolConfig(
                workers=2, min_prefix_overlap_ratio=float("inf"))),
        tokenization_pool=p.tpool.TokenizationPool(p.tpool.TokenizersPoolConfig(
            workers=2, min_prefix_overlap_ratio=float("inf")), tokenizer=_WordTokenizer(p)))
    pool = p.pool.EventPool(p.pool.EventPoolConfig(concurrency=4, default_device_tier="gpu"),
                            indexer.kv_block_index, indexer.token_processor)
    pool.start(with_subscriber=False)
    prefixes = [[rng.randrange(5000) for _ in range(bs * 6)] for _ in range(4)]
    seqs, prompts = {}, []
    try:
        for step in range(120):
            pod = f"pod-{rng.randrange(5)}"
            pre = rng.choice(prefixes)
            tail = [rng.randrange(5000) for _ in range(bs * rng.randint(0, 4))]
            tokens = pre + tail
            hashes = [rng.getrandbits(64) for _ in range(len(tokens) // bs)]
            events = [p.ev.BlockStored(block_hashes=hashes, parent_block_hash=None,
                                       token_ids=tokens, block_size=bs)]
            if rng.random() < 0.3:
                events.append(p.ev.BlockRemoved(block_hashes=hashes[rng.randrange(len(hashes)):]))
            seq = seqs.get(pod, 0)
            seqs[pod] = seq + 1
            pool.add_task(p.pool.Message(
                topic=f"kv@{pod}@{MODEL}",
                payload=p.ev.EventBatch(ts=float(step), events=events).to_msgpack(),
                seq=seq, pod_identifier=pod, model_name=MODEL))
            prompts.append(tokens + [rng.randrange(5000) for _ in range(rng.randint(0, 9))])
        pool.drain()
    finally:
        pool.shutdown()
    indexer.run()
    try:
        reqs = [p.indexer.ScoreRequest(" ".join(map(str, t)), MODEL,
                                       pod_identifiers=rng.choice([[], ["pod-1", "pod-3"]]))
                for t in prompts[::3]]
        many = [(m.scores, m.match_blocks, m.block_hashes) for m in indexer.score_many(reqs)]
        singles = [indexer.score_hashes(MODEL, h).scores for _, _, h in many]
        exes = [(e.scores, e.match_blocks) for e in (
            indexer.get_pod_scores_ex(r.prompt, MODEL, r.pod_identifiers) for r in reqs[:10])]
    finally:
        indexer.shutdown()
    pairs = sorted((e[1], pod, tier) for e in indexer.kv_block_index.export_view().entries
                   for pod, tier in e[2])
    status = indexer.kv_block_index.native_status() if native else None
    return dict(pairs=pairs, many=many, singles=singles, exes=exes), status


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_native_digest_and_indexer_score_plan_match_sharded(seed):
    before = PORT.native.fallback_total()
    native, status = _fleet(PORT, True, seed)
    sharded, _ = _fleet(PORT, False, seed)
    jax_sharded, _ = _fleet(JAX, False, seed)
    assert native == sharded == jax_sharded
    assert status["blocks_applied"] > 0 and any(m[0] for m in native["many"])
    assert PORT.native.fallback_total() == before


def test_native_crossing_error_falls_back_and_counts(monkeypatch):
    """A failed crossing degrades to the Python path, with the same scores,
    and is counted; an ordinary backend is no fallback."""
    p = PORT
    indexer = p.indexer.Indexer(
        p.indexer.IndexerConfig(
            token_processor_config=p.tp.TokenProcessorConfig(block_size=4),
            kv_block_index_config=p.index.IndexConfig(
                in_memory_config=p.in_memory.InMemoryIndexConfig(), native=True)),
        tokenization_pool=p.tpool.TokenizationPool(p.tpool.TokenizersPoolConfig(workers=1),
                                                   tokenizer=_WordTokenizer(p)))
    indexer.run()
    try:
        tokens = list(range(1, 33))
        p.pool.digest_events(indexer.kv_block_index, indexer.token_processor, "pod-x", MODEL,
                             p.ev.EventBatch(ts=0.0, events=[p.ev.BlockStored(
                                 block_hashes=list(range(8)), parent_block_hash=None,
                                 token_ids=tokens, block_size=4)]))
        req = [p.indexer.ScoreRequest(" ".join(map(str, tokens)), MODEL)]
        before = p.native.fallback_total()
        healthy = indexer.score_many(req)
        assert p.native.fallback_total() == before and healthy[0].scores == {"pod-x": 8.0}
        monkeypatch.setattr(indexer.kv_block_index, "score_plan",
                            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
        broken = indexer.score_many(req)
        assert p.native.fallback_total() == before + 1
        assert (broken[0].scores, broken[0].match_blocks) == (healthy[0].scores,
                                                              healthy[0].match_blocks)
    finally:
        indexer.shutdown()
