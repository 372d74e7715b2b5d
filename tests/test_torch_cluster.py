"""The port's replicated indexer control plane against the JAX package's.

- Every test of tests/test_cluster.py and tests/test_membership.py but those
  that need code the port does not carry (`WAITS`) runs on both packages:
  the JAX test file is compiled a second time with its imports pointed at
  the port (`reference_module`), and each case (class methods and
  module-level functions, with the file's own parameters and fixtures,
  `own_cases` / `run_own_case`) runs once per package.
- A snapshot written by either package decodes in the other, and for the
  same index the two files are byte-equal.
- One seeded event stream gives a `ClusterScorer` over 1 and 3 replicas the
  same `PodScores` as a single `Indexer`, on every index backend, on both
  packages.
- chip_smoke.py phase 17a at CPU width: the flagship's vocabulary on a
  1-layer, 64-wide model, four pods, the ShareGPT trace cut to its first
  requests; replicated scoring, the replicas' union, the warm restart and a
  single-region `GlobalRouter` held to the monolithic Indexer.

`own_cases` and `run_own_case` are shared with tests/test_torch_federation.py,
tests/test_torch_autopilot.py and tests/test_torch_transfer_chaos.py.
"""

import importlib
import inspect
import random

import pytest

from tests.fake_redis import FakeRedisServer
from tests.test_torch_fleethealth import (
    BACKEND_IDS,
    BACKEND_NAMES,
    JAX_PKG,
    PACKAGES,
    PKG_IDS,
    PORT_PKG,
    backend,
    reference_module,
)

# Cases that need code the port does not carry yet.
WAITS = {
    "TestGrpcTransport": "api.grpc_server and the gRPC replica transport (ROADMAP.md queue 1 "
                         "item 7)",
    "TestIndexerReplica::test_readyz_reports_replaying_as_503":
        "api.http_service's ScoringService (ROADMAP.md queue 1 item 7)",
    "TestIndexerReplica::test_cluster_snapshot_endpoint":
        "api.http_service's ScoringService (ROADMAP.md queue 1 item 7)",
}
MEMBERSHIP_WAITS = {
    "test_reassignment_counts_transitions": "metrics.collector (ROADMAP.md queue 1 item 7)",
    "test_join_warms_through_data_plane_e2e":
        "bench.py's FleetSim, the benchmark's own code, which is not ported (phase 17a and "
        "its rehearsal make the cluster's claims on the port's pods)",
}


# -- the JAX package's own tests, on either package ----------------------------


def _fixture_function(obj):
    """The function under a pytest fixture definition, else None."""
    if type(obj).__name__ == "FixtureFunctionDefinition":
        return obj._get_wrapped_function()
    return None


def _param_marks(func):
    return [m for m in getattr(func, "pytestmark", []) if m.name == "parametrize"]


def _argnames(mark):
    names = mark.args[0]
    return tuple(n.strip() for n in names.split(",")) if isinstance(names, str) else tuple(names)


def _value_id(values, i):
    v = values[i]
    return str(v) if isinstance(v, (str, int)) else f"{i}"


def own_cases(test_file, waits):
    """(class name or "", test name, param ids) of every test of
    tests/<test_file> (its Test* classes' methods and its module-level
    test functions) but the ones `waits` names ("Class", "Class::test" or a
    module-level "test"), spread over the file's own parameters."""
    ns = reference_module(test_file, JAX_PKG)
    out = []

    def add(cls_name, name, func):
        combos = [()]
        for mark in _param_marks(func):
            names, values = _argnames(mark), mark.args[1]
            axis = [f"{names[0]}#{i}={_value_id(values, i)}" for i in range(len(values))]
            combos = [c + (v,) for c in combos for v in axis]
        out.extend((cls_name, name, combo) for combo in combos)

    for name, obj in vars(ns).items():
        if name.startswith("Test") and inspect.isclass(obj) and name not in waits:
            for meth, func in vars(obj).items():
                if meth.startswith("test_") and f"{name}::{meth}" not in waits:
                    add(name, meth, func)
        elif name.startswith("test_") and inspect.isfunction(obj) and name not in waits:
            add("", name, obj)
    return out


def own_case_id(case):
    cls_name, name, combo = case
    return "::".join([p for p in (cls_name, name) if p] + [c.split("=", 1)[1] for c in combo])


def run_own_case(test_file, case, pkg, request, fixtures=None):
    """Run one case of tests/<test_file> on package `pkg`. Its fixtures
    resolve, in order, from `fixtures` (name -> function of the fixture
    resolver), the test's class, the test module, then pytest's own
    (`tmp_path`, `monkeypatch`, ...); generator fixtures are closed after
    the test."""
    ns = reference_module(test_file, pkg)
    cls_name, name, combo = case
    cls = getattr(ns, cls_name) if cls_name else None
    obj = cls() if cls is not None else None
    func = getattr(cls, name) if cls is not None else getattr(ns, name)
    kwargs = {}
    for mark in _param_marks(func):
        names = _argnames(mark)
        i = int(next(c for c in combo if c.startswith(names[0] + "#")).split("#")[1].split("=")[0])
        values = mark.args[1][i]
        kwargs.update(zip(names, values if len(names) > 1 else (values,)))
    cache, teardown = {}, []

    def resolve(arg):
        if arg in cache:
            return cache[arg]
        own = (fixtures or {}).get(arg)
        if own is not None:
            value = own(resolve)
        else:
            fn = _fixture_function(vars(cls).get(arg)) if cls is not None else None
            bound = fn is not None
            if fn is None:
                fn = _fixture_function(getattr(ns, arg, None))
            if fn is None:
                value = request.getfixturevalue(arg)
            else:
                params = list(inspect.signature(fn).parameters)
                args = [resolve(a) for a in params[1 if bound else 0:]]
                value = fn(obj, *args) if bound else fn(*args)
                if inspect.isgenerator(value):
                    gen, value = value, next(value)
                    teardown.append(gen)
        cache[arg] = value
        return value

    params = list(inspect.signature(func).parameters)[1 if cls is not None else 0:]
    if hasattr(obj, "setup_method"):
        obj.setup_method(func)
    try:
        for arg in params:
            if arg not in kwargs:
                kwargs[arg] = resolve(arg)
        (getattr(obj, name) if obj is not None else func)(**kwargs)
    finally:
        for gen in reversed(teardown):
            for _ in gen:
                pass
        if hasattr(obj, "teardown_method"):
            obj.teardown_method(func)


def every_test(test_file):
    """Every ("Class" or "", test) of tests/<test_file>."""
    ns = reference_module(test_file, JAX_PKG)
    out = set()
    for name, obj in vars(ns).items():
        if name.startswith("Test") and inspect.isclass(obj):
            out |= {(name, m) for m in vars(obj) if m.startswith("test_")}
        elif name.startswith("test_") and inspect.isfunction(obj):
            out.add(("", name))
    return out


def waiting(test_file, waits):
    return {(c, m) for c, m in every_test(test_file)
            if (c and (c in waits or f"{c}::{m}" in waits)) or (not c and m in waits)}


CASES = own_cases("test_cluster.py", WAITS)
MEMBERSHIP_CASES = own_cases("test_membership.py", MEMBERSHIP_WAITS)


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", CASES, ids=own_case_id)
def test_cluster_case_on_both_packages(case, pkg, request):
    run_own_case("test_cluster.py", case, pkg, request)


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", MEMBERSHIP_CASES, ids=own_case_id)
def test_membership_case_on_both_packages(case, pkg, request):
    run_own_case("test_membership.py", case, pkg, request)


def test_every_cluster_case_is_taken():
    for test_file, waits, cases, n_all, n_waiting in (
            ("test_cluster.py", WAITS, CASES, 24, 4),
            ("test_membership.py", MEMBERSHIP_WAITS, MEMBERSHIP_CASES, 18, 2)):
        every = every_test(test_file)
        assert {(c, m) for c, m, _ in cases} == every - waiting(test_file, waits)
        assert (len(every), len(waiting(test_file, waits))) == (n_all, n_waiting)


# -- snapshots across the two packages ----------------------------------------

MODEL = "cluster-model"
BLOCK = 4
PODS = [f"pod-{i}" for i in range(6)]


def _mods(pkg):
    return {k: importlib.import_module(f"{pkg}.{v}") for k, v in dict(
        cluster="cluster", snapshot="cluster.snapshot", indexer="kvcache.indexer",
        tp="kvcache.kvblock.token_processor", ev="kvevents.events", pool="kvevents.pool",
        fh="fleethealth", key="kvcache.kvblock.key", scorer="kvcache.scorer",
        cbor="utils.cbor").items()}


def fresh_index(pkg, name, servers):
    """An index of `backend`'s kind; a Redis one gets a fake server of its
    own (appended to `servers`), so several live side by side."""
    if name != "redis":
        return backend(pkg, name)
    server = FakeRedisServer()
    servers.append(server)
    m = importlib.import_module(f"{pkg}.kvcache.kvblock.redis_index")
    return m.RedisIndex(m.RedisIndexConfig(url=server.url))


def seeded_stream(seed, n_messages=60, pods=PODS):
    """(pod, seq, tokens, engine base, parent, removed engine hashes) rows:
    shared roots and divergent tails, some removals."""
    rng = random.Random(seed)
    roots = [[rng.randrange(1, 5000) for _ in range(BLOCK * rng.randint(2, 5))] for _ in range(4)]
    seqs = {p: 0 for p in pods}
    held = {p: [] for p in pods}
    rows = []
    base = 10_000
    for _ in range(n_messages):
        pod = rng.choice(pods)
        if held[pod] and rng.random() < 0.2:
            gone = rng.sample(held[pod], min(len(held[pod]), rng.randint(1, 3)))
            held[pod] = [h for h in held[pod] if h not in gone]
            rows.append((pod, seqs[pod], None, None, None, gone))
        else:
            tokens = rng.choice(roots) + [rng.randrange(1, 5000)
                                          for _ in range(BLOCK * rng.randint(0, 4))]
            n = len(tokens) // BLOCK
            rows.append((pod, seqs[pod], tokens, base, None, None))
            held[pod] += list(range(base, base + n))
            base += 100
        seqs[pod] += 1
    return rows


def stream_messages(m, rows):
    ev, pool = m["ev"], m["pool"]
    out = []
    for pod, seq, tokens, base, parent, gone in rows:
        if gone is not None:
            events = [ev.BlockRemoved(block_hashes=list(gone))]
        else:
            events = [ev.BlockStored(block_hashes=list(range(base, base + len(tokens) // BLOCK)),
                                     parent_block_hash=parent, token_ids=list(tokens),
                                     block_size=BLOCK)]
        out.append(pool.Message(topic=f"kv@{pod}@{MODEL}",
                                payload=ev.EventBatch(ts=float(seq), events=events).to_msgpack(),
                                seq=seq, pod_identifier=pod, model_name=MODEL))
    return out


def digest(m, index, messages, message_filter=None, health=None):
    processor = m["tp"].ChunkedTokenDatabase(m["tp"].TokenProcessorConfig(block_size=BLOCK))
    # The port's pods name their device tier "gpu" (the reference's "hbm").
    pool = m["pool"].EventPool(m["pool"].EventPoolConfig(concurrency=1, default_device_tier="gpu"),
                               index, processor,
                               health_tracker=health, message_filter=message_filter)
    pool.start(with_subscriber=False)
    for msg in messages:
        pool.add_task(msg)
    pool.drain()
    pool.shutdown()
    return processor


def snapshot_bytes(pkg, backend_name, seed, tmp_path, servers):
    m = _mods(pkg)
    index = fresh_index(pkg, backend_name, servers)
    health = m["fh"].FleetHealthTracker(m["fh"].FleetHealthConfig(), clock=lambda: 0.0)
    digest(m, index, stream_messages(m, seeded_stream(seed)), health=health)
    path = tmp_path / f"{pkg}-{backend_name}.cbor"
    m["snapshot"].write_snapshot(str(path), index,
                                 m["snapshot"].seq_counters_from_tracker(health),
                                 created_ts=1234.5)
    return path.read_bytes(), index


def entry_set(index):
    """Index contents as (model, hash, pod, tier) rows: replicas hold
    disjoint pods of a key, so their union is compared row by row."""
    view = index.export_view()
    return {(model, h, pod, tier) for model, h, pods in view.entries for pod, tier in pods}, \
        set(view.engine_map)


def view_set(index):
    view = index.export_view()
    return sorted((model, h, tuple(sorted(pods))) for model, h, pods in view.entries), \
        sorted(view.engine_map)


@pytest.mark.parametrize("backend_name", BACKEND_NAMES, ids=BACKEND_IDS)
def test_snapshot_bytes_equal_and_decode_across_packages(backend_name, tmp_path):
    servers = []
    try:
        jax_bytes, jax_index = snapshot_bytes(JAX_PKG, backend_name, 3, tmp_path, servers)
        port_bytes, port_index = snapshot_bytes(PORT_PKG, backend_name, 3, tmp_path, servers)
        assert port_bytes == jax_bytes
        for data, pkg, source in ((jax_bytes, PORT_PKG, jax_index),
                                  (port_bytes, JAX_PKG, port_index)):
            m = _mods(pkg)
            snap = m["snapshot"].decode_snapshot(data)
            assert snap.created_ts == 1234.5
            fresh = fresh_index(pkg, backend_name, servers)
            assert m["snapshot"].restore_index(fresh, snap) > 0
            assert view_set(fresh) == view_set(source)
            assert m["snapshot"].encode_snapshot(snap.view, snap.seq_counters,
                                                 created_ts=snap.created_ts) == data
    finally:
        for server in servers:
            server.close()


def test_cbor_codec_bytes_equal_across_packages():
    rng = random.Random(11)

    def value(depth=0):
        kind = rng.randrange(7 if depth < 3 else 5)
        return [lambda: None, lambda: kind == 1, lambda: rng.randrange(-2**63, 2**64),
                lambda: rng.random() * 1e6,
                lambda: "".join(chr(rng.randrange(32, 0x2FF)) for _ in range(rng.randrange(40))),
                lambda: [value(depth + 1) for _ in range(rng.randrange(5))],
                lambda: (value(depth + 1), value(depth + 1))][kind]()

    jax_cbor, port_cbor = _mods(JAX_PKG)["cbor"], _mods(PORT_PKG)["cbor"]
    for _ in range(300):
        v = value()
        data = jax_cbor.encode(v)
        assert port_cbor.encode(v) == data
        assert port_cbor.decode(data) == jax_cbor.decode(data)
    with pytest.raises(port_cbor.CborDecodeError):
        port_cbor.decode(b"\x9a\x00")


# -- a ClusterScorer over 1 and 3 replicas against a single Indexer -----------


class _WordTokenizer:
    """Each space-separated word is its decimal token id."""

    def encode(self, prompt, model_name):
        from types import SimpleNamespace

        words = prompt.split(" ")
        return SimpleNamespace(tokens=[int(w) for w in words],
                               offsets=[(0, 0)] * len(words))


def _indexer(m, pkg, backend_name, servers):
    tokpool = importlib.import_module(f"{pkg}.tokenization.pool")
    indexer = m["indexer"].Indexer(
        m["indexer"].IndexerConfig(
            token_processor_config=m["tp"].TokenProcessorConfig(block_size=BLOCK)),
        tokenization_pool=tokpool.TokenizationPool(
            tokpool.TokenizersPoolConfig(workers=1, min_prefix_overlap_ratio=float("inf")),
            tokenizer=_WordTokenizer()),
        kv_block_index=fresh_index(pkg, backend_name, servers))
    indexer.run()
    return indexer


def cluster_scores(pkg, backend_name, n_replicas, seed):
    """One seeded stream into a single Indexer and into `n_replicas`
    partition-gated replicas behind a ClusterScorer: both answers for every
    probe prompt, and the replicas' contents."""
    m = _mods(pkg)
    rows = seeded_stream(seed)
    messages = stream_messages(m, rows)
    servers = []
    mono = _indexer(m, pkg, backend_name, servers)
    digest(m, mono.kv_block_index, messages)
    mono_view = entry_set(mono.kv_block_index)
    mono_out = []
    probes = sorted({" ".join(map(str, tokens)) for _, _, tokens, *_ in rows if tokens})[:16]
    for prompt in probes:
        ps = mono.get_pod_scores_ex(prompt, MODEL, [])
        mono_out.append((ps.scores, ps.match_blocks, ps.block_hashes))
    mono.shutdown()
    replicas, transports = [], []
    for rid in range(n_replicas):
        part = m["cluster"].ReplicaPartitioner(n_replicas, rid)
        r = _indexer(m, pkg, backend_name, servers)
        digest(m, r.kv_block_index, messages,
               message_filter=part.accepts if n_replicas > 1 else None)
        replicas.append(r)
        transports.append(m["cluster"].LocalReplicaTransport(r))
    scorer = m["cluster"].ClusterScorer(transports)
    try:
        clu_out = []
        for prompt in probes:
            ps = scorer.get_pod_scores_ex(prompt, MODEL, [])
            clu_out.append((ps.scores, ps.match_blocks, ps.block_hashes))
        many = [(ps.scores, ps.match_blocks, ps.block_hashes) for ps in scorer.score_many(
            [m["indexer"].ScoreRequest(p, MODEL) for p in probes])]
        union, engine = set(), set()
        for r in replicas:
            entries, engine_map = entry_set(r.kv_block_index)
            union |= entries
            engine |= engine_map
    finally:
        scorer.close()
        for r in replicas:
            r.shutdown()
        for server in servers:
            server.close()
    return dict(mono=mono_out, cluster=clu_out, many=many, mono_view=mono_view,
                union=(union, engine), status=scorer.status()["scatter_calls"])


@pytest.mark.parametrize("n_replicas", [1, 3], ids=["one-replica", "three-replicas"])
@pytest.mark.parametrize("backend_name", BACKEND_NAMES, ids=BACKEND_IDS)
def test_cluster_scorer_equals_a_single_indexer(backend_name, n_replicas):
    out = {pkg: cluster_scores(pkg, backend_name, n_replicas, seed=5) for pkg in PACKAGES}
    port = out[PORT_PKG]
    assert port["cluster"] == port["mono"]
    assert port["many"] == port["mono"]
    assert any(scores for scores, _, _ in port["mono"])
    if backend_name != "cost_aware":  # a byte budget keeps what each index's own load admits
        # The entries are the same rows. An engine mapping is dropped once
        # its request key holds no pod, which a replica that sees fewer pods
        # reaches sooner, so the union's mappings are a subset.
        assert port["union"][0] == port["mono_view"][0]
        assert port["union"][1] <= port["mono_view"][1]
    assert port == out[JAX_PKG]


# -- chip_smoke.py phase 17a at CPU width ----------------------------------------


@pytest.fixture
def one_thread():
    """The rehearsals' models are 64 wide: torch's intra-op threads only
    contend with the other test workers, so each runs on one."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phase_17a_rehearses_the_replicated_arm(one_thread):
    """Phase 16a's precise arm with phase 17a's replicas beside it, on the
    flagship's vocabulary at CPU width (the card runs the same code on the
    flagship): every request's ClusterScorer and single-region router
    answers equal the Indexer's, the warm restart drops exactly the
    journaled duplicates and replays the messages missed, and the replicas'
    union is the Indexer's entries."""
    import chip_smoke

    params, cfg = chip_smoke.small_model("cpu", seed=0, **chip_smoke.REHEARSAL_MODEL)
    requests = chip_smoke.sharegpt_requests()
    arm = chip_smoke.cluster_arm(params, cfg, requests)
    c = arm["cluster"]
    assert arm["failures"] == [] and c["failures"] == []
    assert c["compared"] == c["router_compared"] == c["scatter"] == len(requests)
    restart = c["restart"]
    assert restart["request"] == len(requests) // 2
    assert restart["duplicates"] == restart["replay_skipped"] == chip_smoke.CLUSTER_OVERLAP
    assert restart["missed"] > 0 and restart["entries"] == restart["owned"] > 0
    assert c["union"]["replica_entries"] == c["union"]["indexer_entries"] > 0
    assert sum(c["union"]["filtered"]) > 0


@pytest.mark.parametrize("fault", ["wrong_owner_merge", "snapshot_drops_last_entry"])
def test_phase_17a_bars_catch_the_planted_faults(fault, one_thread):
    """chip_fault_check.py's 17a faults fail the rehearsal's bars over 16a's
    first requests, where the real planes pass."""
    import chip_fault_check as fc
    import chip_smoke

    params, cfg = chip_smoke.small_model("cpu", seed=0, **chip_smoke.REHEARSAL_MODEL)
    requests = chip_smoke.sharegpt_requests()[:fc.FLEET_PLANE_REQUESTS]

    def fails(**kw):
        arm = chip_smoke.cluster_arm(params, cfg, requests, **kw)
        return arm["failures"] + arm["cluster"]["failures"]

    if fault == "wrong_owner_merge":
        assert fails() == []
        got = fails(scorer_cls=fc.WrongOwnerScorer)
        assert any("the cluster scored" in f for f in got)
    else:
        fc.snapshot_mod.encode_snapshot = fc.drop_last_entry_encoder
        try:
            got = fails()
        finally:
            fc.snapshot_mod.encode_snapshot = fc.REAL_ENCODE
        assert any(f.startswith("warm restart") for f in got)
