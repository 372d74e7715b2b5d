"""The port's fleet-health plane against the JAX package's, on the same inputs.

- Every test of tests/test_fleethealth.py runs on both packages: its source
  is compiled a second time with its imports of the JAX package pointed at
  the port (`reference_module`), and each case runs once per package. The
  index cases run over every backend each package has: in-memory, sharded,
  cost-aware, Redis (tests/fake_redis.py) and native (the JAX package's
  build, where importable, else its sharded index, which the native one is
  bit-identical to).
- A seeded `FaultPlan` and one message stream of four simulated pods
  (`sim_specs`: shared prefixes and chained tails, evictions, a pod crashed,
  one stalled, one lossy, one wiped and advertising phantoms) go through
  each package's `FaultInjector` -> `EventPool` -> index with the health
  tracker, the anti-entropy tracker and the residency auditor wired: the
  delivered messages, the tracker's `summary()`, `anomaly_totals()` and
  `seq_snapshot()`, the purged counts, the Indexer's scores, the auditor's
  per-round verdicts and the index contents must be exactly equal, on every
  backend.
- The Indexer's fused score plan over the native index, with a stale, a
  suspect and a distrusted pod: equal to its Python path, to the sharded
  index and to the JAX package.

`reference_module` and `reference_cases` are shared with
tests/test_torch_antientropy.py and tests/test_torch_resourcegov.py.
"""

import ast
import importlib
import inspect
import pathlib
import random
from types import SimpleNamespace

import pytest

from tests.fake_redis import FakeRedisServer

JAX_PKG = "llm_d_kv_cache_manager_tpu"
PORT_PKG = "llm_d_kv_cache_manager_tpu_torch"
PACKAGES = [JAX_PKG, PORT_PKG]
PKG_IDS = ["jax", "port"]
BACKEND_NAMES = ["in_memory", "sharded", "cost_aware", "redis", "native"]
# tests/conftest.py skips every test carrying the keyword "native" when the
# JAX package's C extension is not built, and a bare parameter id is such a
# keyword: parametrize over backends with these ids.
BACKEND_IDS = [f"{b}-index" for b in BACKEND_NAMES]
TESTS = pathlib.Path(__file__).parent

pytestmark = pytest.mark.faults


# -- the JAX package's own tests, on either package ----------------------------


# What the reference tests import from libraries the port does not use, and
# the port's counterparts: its own Prometheus registry, and a loopback client
# for its HTTP service (tests/loopback_client.py).
PORT_STAND_INS = {
    "prometheus_client": f"{PORT_PKG}.metrics.registry",
    "aiohttp.test_utils": "tests.loopback_client",
}


class _ImportsOf(ast.NodeTransformer):
    """Point every `from <JAX package>... import` at `pkg`; for the port,
    also point the library imports of `PORT_STAND_INS` at their stand-ins."""

    def __init__(self, pkg):
        self.pkg = pkg

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if mod == JAX_PKG or mod.startswith(JAX_PKG + "."):
            node.module = self.pkg + mod[len(JAX_PKG):]
        elif self.pkg == PORT_PKG and mod in PORT_STAND_INS:
            node.module = PORT_STAND_INS[mod]
        return node

    def visit_Import(self, node):
        if self.pkg == PORT_PKG:
            for alias in node.names:
                if alias.name in PORT_STAND_INS:
                    alias.asname = alias.asname or alias.name
                    alias.name = PORT_STAND_INS[alias.name]
        return node


def _available(node):
    """A top-level import trimmed to the names its module has: the port lacks
    some modules and names still (the cases that use them wait, see each
    file's WAITS). None when nothing of it is there."""
    try:
        mod = importlib.import_module(node.module)
    except ImportError:
        return None

    def present(name):
        if hasattr(mod, name):
            return True
        try:  # a submodule not imported yet
            importlib.import_module(f"{node.module}.{name}")
        except ImportError:
            return False
        return True

    node.names = [a for a in node.names if present(a.name)]
    return node if node.names else None


_MODULES = {}


def reference_module(test_file, pkg):
    """tests/<test_file> compiled with its imports pointed at `pkg`, as a
    fresh namespace (the JAX test module itself is never touched)."""
    key = (test_file, pkg)
    if key not in _MODULES:
        path = TESTS / test_file
        tree = _ImportsOf(pkg).visit(ast.parse(path.read_text()))
        body = []
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(pkg):
                node = _available(node)
            if node is not None:
                body.append(node)
        tree.body = body
        ns = {"__name__": f"tests.{path.stem}__{pkg}", "__file__": str(path)}
        exec(compile(tree, str(path), "exec"), ns)
        _MODULES[key] = SimpleNamespace(**ns)
    return _MODULES[key]


_redis_server = None


def _redis_url():
    global _redis_server
    if _redis_server is None:
        _redis_server = FakeRedisServer()
    return _redis_server.url


def backend(pkg, name):
    """A fresh index of package `pkg` (the Redis one FLUSHALLs the shared
    fake server, so runs never overlap)."""
    def mod(path):
        return importlib.import_module(f"{pkg}.kvcache.kvblock.{path}")

    if name == "in_memory":
        m = mod("in_memory")
        return m.InMemoryIndex(m.InMemoryIndexConfig(size=1000, pod_cache_size=10))
    if name == "sharded":
        m = mod("sharded")
        return m.ShardedIndex(m.ShardedIndexConfig(size=1000, pod_cache_size=10))
    if name == "cost_aware":
        m = mod("cost_aware")
        return m.CostAwareMemoryIndex(m.CostAwareIndexConfig(max_size_bytes="1MiB",
                                                             pod_cache_size=10))
    if name == "redis":
        m = mod("redis_index")
        index = m.RedisIndex(m.RedisIndexConfig(url=_redis_url()))
        index._pipeline([("FLUSHALL",)])
        return index
    if name == "native":
        m = mod("native_index")
        if pkg == JAX_PKG and not m.have_native_index():
            return backend(pkg, "sharded")
        return m.NativeScoringIndex(m.NativeIndexConfig(size=1000, pod_cache_size=10))
    raise ValueError(name)


def _backend_factories(ns, pkg):
    """The test module's own index factories, completed to every backend."""
    own = {}
    if hasattr(ns, "_backends"):
        own.update(dict(ns._backends()))
    own.update({k: v for k, v in getattr(ns, "BACKENDS", {}).items() if k in BACKEND_NAMES})
    return {name: own.get(name, lambda name=name: backend(pkg, name)) for name in BACKEND_NAMES}


def _marks(func):
    return [m for m in getattr(func, "pytestmark", []) if m.name == "parametrize"]


def _argnames(mark):
    names = mark.args[0]
    return tuple(n.strip() for n in names.split(",")) if isinstance(names, str) else tuple(names)


def reference_cases(test_file, waits):
    """(class, method, param ids) of every test in tests/<test_file> but the
    ones `waits` names (by "Class::method" or "Class"), with an index
    parameter ("index", "backend", "name,make") spread over BACKEND_NAMES."""
    ns = reference_module(test_file, JAX_PKG)
    out = []
    for cls_name, cls in vars(ns).items():
        if not (cls_name.startswith("Test") and inspect.isclass(cls)) or cls_name in waits:
            continue
        for meth_name, meth in vars(cls).items():
            if not meth_name.startswith("test_") or f"{cls_name}::{meth_name}" in waits:
                continue
            axes = []
            for mark in _marks(meth):
                names = _argnames(mark)
                if names in (("backend",), ("name", "make")):
                    axes.append([f"backend={b}" for b in BACKEND_NAMES])
                else:
                    axes.append([f"{names[0]}#{i}" for i in range(len(mark.args[1]))])
            if "index" in inspect.signature(meth).parameters:
                axes.append([f"backend={b}" for b in BACKEND_NAMES])
            combos = [()]
            for axis in axes:
                combos = [c + (v,) for c in combos for v in axis]
            out += [(cls_name, meth_name, combo) for combo in combos]
    return out


def case_id(case):
    cls_name, meth_name, combo = case
    return "::".join([cls_name, meth_name] + [c.split("=")[-1] for c in combo])


def run_reference_case(test_file, case, pkg, request, adapt=None):
    """Run one case of tests/<test_file> on package `pkg`; `adapt(cls)`, where
    given, returns the class to run it on (a documented port difference)."""
    ns = reference_module(test_file, pkg)
    cls_name, meth_name, combo = case
    cls = getattr(ns, cls_name)
    if adapt is not None:
        cls = adapt(cls)
    meth = getattr(cls, meth_name)
    factories = _backend_factories(ns, pkg)
    chosen = [c.split("=", 1)[1] for c in combo if c.startswith("backend=")]
    kwargs = {}
    for mark in _marks(meth):
        names = _argnames(mark)
        if names == ("name", "make"):
            b = chosen.pop(0)
            kwargs.update(name=b, make=factories[b])
        elif names == ("backend",):
            b = chosen.pop(0)
            ns.BACKENDS[b] = factories[b]
            kwargs["backend"] = b
        else:
            i = int(next(c for c in combo if c.startswith(names[0] + "#")).split("#")[1])
            values = mark.args[1][i]
            kwargs.update(zip(names, values if len(names) > 1 else (values,)))
    for arg in list(inspect.signature(meth).parameters)[1:]:
        if arg == "index":
            kwargs["index"] = factories[chosen.pop(0)]()
        elif arg not in kwargs:
            kwargs[arg] = request.getfixturevalue(arg)
    obj = cls()
    if hasattr(obj, "setup_method"):
        obj.setup_method(meth)
    try:
        getattr(obj, meth_name)(**kwargs)
    finally:
        if hasattr(obj, "teardown_method"):
            obj.teardown_method(meth)


# Cases of tests/test_fleethealth.py that need a module the port lacks: none.
WAITS = {}
CASES = reference_cases("test_fleethealth.py", WAITS)


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_fleethealth_case_on_both_packages(case, pkg, request):
    run_reference_case("test_fleethealth.py", case, pkg, request)


def test_every_reference_case_is_taken():
    """All 27 tests of tests/test_fleethealth.py run here."""
    assert len({(c, m) for c, m, _ in CASES}) == 27


def test_port_namespace_runs_the_port():
    """The recompiled module's names come from the port, never the JAX
    package (a rewrite that missed an import would test the reference
    twice)."""
    ns = reference_module("test_fleethealth.py", PORT_PKG)
    for name in ("FleetHealthTracker", "FaultInjector", "InMemoryIndex", "ShardedIndex",
                 "CostAwareMemoryIndex", "RedisIndex", "Key"):
        assert getattr(ns, name).__module__.startswith(PORT_PKG + "."), name


# -- one seeded stream through both packages' planes ---------------------------

MODEL = "resilience-model"
PAGE = 4
SIM_PODS = ("pod-0", "pod-1", "pod-2", "pod-3")
SHARED_PREFIXES = 6


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def sim_specs(seed, ticks, pods=SIM_PODS):
    """A small fleet's event stream from `seed`, as plain data: per tick and
    pod, the chains it stores (a shared prefix or its own tail, chained) and
    the blocks it evicts. Hashes are the chained block hashes the request
    path derives (engine key == request key, as port and JAX pods do), so
    an audit's digest answers in the index's own key space."""
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import hashing

    rng = random.Random(seed)
    root = hashing.init_hash("")
    prefixes = []
    for _ in range(SHARED_PREFIXES):
        tokens = [rng.randrange(1000) for _ in range(4 * PAGE)]
        prefixes.append((tokens, hashing.prefix_hashes_fast(root, tokens, PAGE)))
    specs = []
    for _ in range(ticks):
        tick = {}
        for pod in pods:
            stores = []
            for _ in range(rng.randint(1, 3)):
                s = rng.randrange(SHARED_PREFIXES)
                tokens, hashes = prefixes[s]
                stores.append((None, tokens, hashes))
                tail = [rng.randrange(1000) for _ in range(rng.randint(1, 3) * PAGE)]
                stores.append((hashes[-1], tail,
                               hashing.prefix_hashes_fast(hashes[-1], tail, PAGE)))
            tick[pod] = (stores, rng.random())
        specs.append(tick)
    return specs


class SimPod:
    """What a pod holds (the auditor's ground truth) and its publisher's seq."""

    def __init__(self):
        self.resident = []  # insertion order, the pod's LRU
        self.seq = 0

    def digest(self, device_hashes, host_hashes, max_extra):
        held = set(self.resident)
        return {"device": {h for h in device_hashes if h in held}, "host": set(),
                "extra_device": self.resident[:max_extra], "extra_host": []}


def _plan(p, plan):
    return p.faults.FaultPlan(seed=plan["seed"], pods={
        pod: p.faults.PodFaults(**f) for pod, f in plan["pods"].items()})


RESILIENCE_PLAN = dict(seed=7, pods={
    "pod-0": dict(crash_at_s=3.0, restart_at_s=8.0),
    "pod-1": dict(stall_from_s=2.0, stall_until_s=9.0),
    "pod-2": dict(drop_rate=0.2, duplicate_rate=0.1, reorder_rate=0.2),
    "pod-3": dict(silent_wipe_at_s=6.0, phantom_advertise_rate=0.3, phantom_from_s=4.0,
                  phantom_until_s=8.0),
})


def plane_pkg(pkg):
    mods = dict(
        tracker="fleethealth.tracker", faults="fleethealth.faults", ae="antientropy",
        rg="resourcegov", pool="kvevents.pool", ev="kvevents.events",
        indexer="kvcache.indexer", tp="kvcache.kvblock.token_processor",
        key="kvcache.kvblock.key", load="fleethealth.load",
    )
    return SimpleNamespace(name=pkg, **{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in mods.items()})


def index_set(index):
    return sorted((m, h, pod, tier) for m, h, pods in index.export_view().entries
                  for pod, tier in pods)


def resilience_run(pkg, backend_name, seed=0, ticks=14, plan=RESILIENCE_PLAN, hooks=None):
    """Drive `ticks` steps of the simulated fleet through package `pkg`'s
    FaultInjector -> EventPool -> index, with the fleet-health tracker, the
    anti-entropy tracker and the residency auditor wired as the port's
    chip_smoke phase 15a wires them (the Indexer's fleet_health= and
    antientropy=, the pool's health_tracker= and divergence=). Returns every
    reading the two packages must agree on. `hooks(p, parts, tick)` runs at
    the end of each tick (the governor scenario's seam)."""
    p = plane_pkg(pkg)
    clock = Clock()
    index = backend(pkg, backend_name)
    tracker = p.tracker.FleetHealthTracker(
        p.tracker.FleetHealthConfig(suspect_after_s=1.5, stale_after_s=2.5), clock=clock)
    trust = p.ae.AntiEntropyTracker(p.ae.AntiEntropyConfig(accuracy_alpha=0.4), clock=clock)
    indexer = p.indexer.Indexer(
        p.indexer.IndexerConfig(token_processor_config=p.tp.TokenProcessorConfig(block_size=PAGE)),
        kv_block_index=index, fleet_health=tracker, antientropy=trust)
    pool = p.pool.EventPool(p.pool.EventPoolConfig(concurrency=1, default_device_tier="hbm"),
                            index, indexer.token_processor, health_tracker=tracker,
                            divergence=trust)
    pool.start(with_subscriber=False)
    sims = {pod: SimPod() for pod in SIM_PODS}
    auditor = p.ae.ResidencyAuditor(
        index, MODEL, lambda pod, d, h, k: sims[pod].digest(d, h, k), tracker=trust,
        config=p.ae.AuditorConfig(interval_s=2.0, sample_per_pod=8, readmit_sample=8, seed=seed),
        clock=clock)
    verdicts = []
    audit_once = auditor.audit_once
    auditor.audit_once = lambda now=None: verdicts.append((now, audit_once(now))) or verdicts[-1][1]
    injector = p.faults.FaultInjector(_plan(p, plan), clock)
    delivered = []

    def deliver_to_pool(msg):
        delivered.append((msg.pod_identifier, msg.topic, msg.seq, msg.payload))
        pool.add_task(msg)

    deliver = {pod: injector.wrap(pod, deliver_to_pool) for pod in SIM_PODS}
    specs = sim_specs(seed, ticks)
    faults = _plan(p, plan)
    parts = SimpleNamespace(index=index, tracker=tracker, trust=trust, indexer=indexer,
                            pool=pool, auditor=auditor, clock=clock, sims=sims)
    readings = dict(scores=[], audits=[], summaries=[])
    chains = [hashes for (_, _, hashes) in
              (s for tick in specs[:2] for stores, _ in tick.values() for s in stores)][:12]
    try:
        for t, tick in enumerate(specs):
            clock.t = float(t)
            for pod in SIM_PODS:
                f = faults.for_pod(pod)
                sim = sims[pod]
                if f is not None and f.silent_wipe_at_s == clock.t:
                    sim.resident = []  # the cache is gone; no event says so
                if f is not None and f.crashed(clock.t):
                    if f.restart_at_s is not None and clock.t + 1 >= f.restart_at_s:
                        sims[pod] = sim = SimPod()  # a cold replacement, seq from 0
                    continue
                stores, evict_draw = tick[pod]
                events = []
                for parent, tokens, hashes in stores:
                    events.append(p.ev.BlockStored(block_hashes=list(hashes),
                                                   parent_block_hash=parent,
                                                   token_ids=list(tokens), block_size=PAGE))
                    sim.resident += [h for h in hashes if h not in sim.resident]
                if evict_draw < 0.5 and len(sim.resident) > 8:
                    gone = sim.resident[:4]
                    sim.resident = sim.resident[4:]
                    events.append(p.ev.BlockRemoved(block_hashes=gone))
                msg = p.pool.Message(
                    topic=f"kv@{pod}@{MODEL}",
                    payload=p.ev.EventBatch(ts=clock.t, events=events).to_msgpack(),
                    seq=sim.seq, pod_identifier=pod, model_name=MODEL)
                sim.seq += 1
                deliver[pod](msg)
            pool.drain()
            for chain in chains:
                ps = indexer.score_hashes(MODEL, chain)
                readings["scores"].append((t, sorted(ps.scores.items()),
                                           sorted(ps.match_blocks.items())))
            ran = auditor.tick(clock.t)
            readings["audits"].append((t, ran, dict(auditor.stats)))
            readings["summaries"].append(tracker.summary())
            if hooks is not None:
                hooks(p, parts, t)
        injector.flush()
        pool.drain()
    finally:
        pool.shutdown()
    readings.update(
        delivered=delivered, injected=dict(injector.injected), summary=tracker.summary(),
        anomalies=tracker.anomaly_totals(), seq=tracker.seq_snapshot(),
        purged={pod: d["purged_entries"] for pod, d in tracker.summary()["pods"].items()},
        verdicts=verdicts,
        trust=trust.status(), auditor=auditor.status(), index=index_set(index),
        counters=dict(dropped=pool.dropped_events, removals_lost=pool.removals_lost))
    return readings, parts


# The Redis backend runs one seed: the fake server answers a pipeline in about
# 28 ms, so one run of the whole stream takes about 22 s a package. The other
# files' Redis runs stop after SHORT_TICKS ticks (every fault of their plans
# has shown by then).
STREAM_CASES = [(seed, b) for seed in (0, 1) for b in BACKEND_NAMES
                if not (b == "redis" and seed)]
SHORT_TICKS = 8


@pytest.mark.parametrize("seed,backend_name", STREAM_CASES)
def test_seeded_fault_stream_matches_jax(seed, backend_name):
    """The same plan and stream through both packages: the same delivered
    messages, health summaries, anomaly counts, seq watermarks, purges,
    scores, audit rounds and index contents, exactly."""
    jax, _ = resilience_run(JAX_PKG, backend_name, seed)
    port, parts = resilience_run(PORT_PKG, backend_name, seed)
    assert port.keys() == jax.keys()
    for key in jax:
        assert port[key] == jax[key], key
    # The plan's faults all showed: both stale pods detected and recovered,
    # every injected class counted, the auditor repaired in both directions.
    pods = port["summary"]["pods"]
    for pod in ("pod-0", "pod-1"):
        assert pods[pod]["recoveries"] >= 1 and pods[pod]["detection_latency_s"] is not None
        assert pods[pod]["detection_latency_s"] <= 2.5 + 1.0
    injected = port["injected"]
    assert all(injected[k] > 0 for k in ("stall_dropped", "dropped", "duplicated", "reordered",
                                         "phantom_advertised"))
    assert port["anomalies"]["duplicates"] == injected["duplicated"]
    assert port["anomalies"]["reorders"] == injected["reordered"]
    assert port["auditor"]["phantoms_purged"] > 0
    assert port["auditor"]["blocks_readmitted"] > 0


# -- the native score plan with both trackers ----------------------------------


def _planned_scores(pkg, backend_name):
    """Three pods holding prefixes of two prompts, one stale (quarantine off,
    so its entries stay and only the filter can drop them), one suspect, one
    distrusted by the anti-entropy tracker: score_many (over the native
    index, one fused crossing with both trackers' factors) and
    get_pod_scores_ex (the Python path) for both prompts."""
    from tests.conftest import TEST_MODEL_NAME, TEST_TOKENIZER_JSON

    p = plane_pkg(pkg)
    tpool = importlib.import_module(f"{pkg}.tokenization.pool")
    clock = Clock()
    tracker = p.tracker.FleetHealthTracker(p.tracker.FleetHealthConfig(
        suspect_after_s=2.0, stale_after_s=5.0, auto_quarantine=False), clock=clock)
    trust = p.ae.AntiEntropyTracker(clock=clock)
    indexer = p.indexer.Indexer(
        p.indexer.IndexerConfig(token_processor_config=p.tp.TokenProcessorConfig(block_size=PAGE)),
        tokenization_pool=tpool.TokenizationPool(tpool.TokenizersPoolConfig(
            workers=1, local_tokenizer_files={TEST_MODEL_NAME: TEST_TOKENIZER_JSON})),
        kv_block_index=backend(pkg, backend_name), fleet_health=tracker, antientropy=trust)
    indexer.run()
    pool = p.pool.EventPool(p.pool.EventPoolConfig(concurrency=1), indexer.kv_block_index,
                            indexer.token_processor, health_tracker=tracker)
    pool.start(with_subscriber=False)
    prompts = ["alpha bravo charlie delta echo foxtrot golf hotel india juliet kilo lima",
               "alpha bravo charlie delta mike november oscar papa quebec romeo"]
    try:
        for pod, prompt, t in (("pod-a", 0, 4.0), ("pod-b", 0, 0.0), ("pod-c", 1, 3.0),
                               ("pod-d", 1, 4.0)):
            tokens = indexer.tokenizers_pool.tokenize(None, prompts[prompt], TEST_MODEL_NAME)
            n = len(tokens) // PAGE
            clock.t = t
            ev = p.ev.BlockStored(block_hashes=[100 * len(pod) + i for i in range(n)],
                                  parent_block_hash=None, token_ids=list(tokens[:n * PAGE]),
                                  block_size=PAGE)
            pool.add_task(p.pool.Message(
                topic=f"kv@{pod}@{TEST_MODEL_NAME}", seq=0, pod_identifier=pod,
                payload=p.ev.EventBatch(ts=t, events=[ev]).to_msgpack(),
                model_name=TEST_MODEL_NAME))
            pool.drain()
        trust.observe_audit("pod-d", verified=1, phantom=3, now=4.0)
        clock.t = 5.5  # pod-b stale, pod-c suspect, pod-a healthy, pod-d distrusted
        many = indexer.score_many([p.indexer.ScoreRequest(q, TEST_MODEL_NAME) for q in prompts])
        singles = [indexer.get_pod_scores_ex(q, TEST_MODEL_NAME, []) for q in prompts]
        states = {pod: tracker.state_of(pod) for pod in ("pod-a", "pod-b", "pod-c", "pod-d")}
    finally:
        pool.shutdown()
        indexer.shutdown()
    return ([(m.scores, m.match_blocks) for m in many],
            [(s.scores, s.match_blocks) for s in singles], states)


@pytest.mark.parametrize("backend_name", ["sharded", "native"], ids=lambda b: f"{b}-index")
def test_score_plan_applies_both_trackers_as_jax(backend_name):
    """The port's Indexer over the native index runs score_many as one fused
    crossing that takes both trackers' factors; it must agree with its own
    Python path, with the sharded index and with the JAX package."""
    port = _planned_scores(PORT_PKG, backend_name)
    assert port == _planned_scores(JAX_PKG, backend_name)
    assert port == _planned_scores(PORT_PKG, "sharded")
    many, singles, states = port
    assert many == singles
    assert states == {"pod-a": "healthy", "pod-b": "stale", "pod-c": "suspect",
                      "pod-d": "healthy"}
    (first, first_blocks), (second, second_blocks) = many
    assert "pod-b" in first_blocks and "pod-b" not in first  # stale: held, not scored
    assert second["pod-c"] == 0.5 * second_blocks["pod-c"]  # suspect: demoted
    assert 0.25 * second_blocks["pod-d"] <= second["pod-d"] < second_blocks["pod-d"]  # distrusted
