"""The port's metrics collector and tracing spine against the JAX package's.

- Every test of tests/test_obs.py (spans, the flight recorder, score explain,
  the carrier and the cluster-mode trace over real gRPC),
  tests/test_metrics_hygiene.py (the registry walk and the span vocabulary),
  tests/test_tokenization_metrics.py and tests/test_index.py's
  `TestInstrumentedMetrics` runs on both packages (`own_cases`
  / `run_own_case` of tests/test_torch_cluster.py). On the port the
  reference tests' `prometheus_client` is the port's own registry
  (`metrics/registry.py`) and aiohttp's test client is
  tests/loopback_client.py (`PORT_STAND_INS` in
  tests/test_torch_fleethealth.py).
- The registry writes the text format 0.0.4 byte for byte as
  prometheus_client does (without the `_created` series), on seeded
  operations over every collector type.
- One seeded workload through each package (an instrumented index, the
  Indexer's read path, the tokenization pool, the admission gate, the
  carrier): the `kvcache_*` samples it adds to each exposition, parsed with
  `prometheus_client.parser`, are equal; so are every HELP and TYPE line.
  Masked, because they time the machine: the latency histograms' buckets
  and sums (their `_count`s are compared) and the strided
  `kvcache_stage_latency_seconds`.
- One read trace has the same span names at the same depths in both
  packages; a carrier and an exported trace written by either package are
  read by the other.
- The port's instrumentation sites emit exactly the span names the JAX
  package's do, all in the committed inventory.
"""

import importlib
import random
import re
from pathlib import Path

import prometheus_client
import pytest
from prometheus_client import parser as prom_parser

from tests.conftest import TEST_MODEL_NAME, TEST_TOKENIZER_JSON
from tests.test_torch_cluster import (
    every_test,
    own_case_id,
    own_cases,
    run_own_case,
    waiting,
)
from tests.test_torch_fleethealth import JAX_PKG, PACKAGES, PKG_IDS, PORT_PKG

OBS_CASES = own_cases("test_obs.py", {})
# tests/test_index.py's metrics case (its backend suite runs as scenarios in
# tests/test_torch_index_backends.py).
INSTRUMENTED_CASES = [c for c in own_cases("test_index.py", {})
                      if c[0] == "TestInstrumentedMetrics"]
HYGIENE_CASES = own_cases("test_metrics_hygiene.py", {})
TOKENIZATION_CASES = own_cases("test_tokenization_metrics.py", {})

ROOT = Path(__file__).resolve().parent.parent


class _PortCaplog:
    """pytest's caplog with the reference package's logger names (`kvtpu.`)
    read as the port's (`kvtorch.`, utils/logging.py)."""

    def __init__(self, caplog):
        self._caplog = caplog

    def at_level(self, level, logger=None):
        if logger is not None and logger.startswith("kvtpu."):
            logger = "kvtorch." + logger[len("kvtpu."):]
        return self._caplog.at_level(level, logger=logger)

    def __getattr__(self, name):
        return getattr(self._caplog, name)


def _own_fixtures(pkg):
    if pkg == PORT_PKG:
        return {"caplog": lambda resolve: _PortCaplog(resolve("caplog_of_pytest"))}
    return None


@pytest.fixture
def caplog_of_pytest(caplog):
    return caplog


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", OBS_CASES, ids=own_case_id)
def test_obs_case_on_both_packages(case, pkg, request):
    run_own_case("test_obs.py", case, pkg, request, fixtures=_own_fixtures(pkg))


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", HYGIENE_CASES, ids=own_case_id)
def test_metrics_hygiene_case_on_both_packages(case, pkg, request):
    run_own_case("test_metrics_hygiene.py", case, pkg, request)


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", TOKENIZATION_CASES, ids=own_case_id)
def test_tokenization_metrics_case_on_both_packages(case, pkg, request):
    run_own_case("test_tokenization_metrics.py", case, pkg, request)


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", INSTRUMENTED_CASES, ids=own_case_id)
def test_instrumented_index_case_on_both_packages(case, pkg, request):
    run_own_case("test_index.py", case, pkg, request)


def test_every_obs_case_is_taken():
    for test_file, cases, n_all in (("test_obs.py", OBS_CASES, 38),
                                    ("test_metrics_hygiene.py", HYGIENE_CASES, 17),
                                    ("test_tokenization_metrics.py", TOKENIZATION_CASES, 7)):
        every = every_test(test_file)
        assert {(c, m) for c, m, _ in cases} == every - waiting(test_file, {})
        assert len(every) == n_all
    assert len(INSTRUMENTED_CASES) == 1


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# -- the registry against prometheus_client -------------------------------------


def _exposition_without_created(text: str) -> str:
    keep = []
    for line in text.splitlines():
        name = line.split(" ")[2] if line.startswith("#") else re.split(r"[{ ]", line, 1)[0]
        if not name.endswith("_created"):
            keep.append(line + "\n")
    return "".join(keep)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_writes_prometheus_client_text(seed):
    """The same collectors and the same operations on prometheus_client's
    registry and the port's give the same exposition, byte for byte, once
    prometheus_client's `_created` series are left out."""
    registry = _mod(PORT_PKG, "metrics.registry")
    rng = random.Random(seed)
    ours = registry.CollectorRegistry()
    theirs = prometheus_client.CollectorRegistry()
    buckets = (0.001, 0.01, 0.1, 1.0, 10.0)
    made = []
    for lib, reg in ((registry, ours), (prometheus_client, theirs)):
        made.append({
            "c": lib.Counter("kvcache_t_c_total", "a counter\nwith a \\ line", registry=reg),
            "cl": lib.Counter("kvcache_t_cl", "labelled", ["kind"], registry=reg),
            "g": lib.Gauge("kvcache_t_g", "a gauge", registry=reg),
            "gl": lib.Gauge("kvcache_t_gl", "labelled gauge", ["state", "region"], registry=reg),
            "h": lib.Histogram("kvcache_t_h_seconds", "a histogram", buckets=buckets,
                               registry=reg),
            "hl": lib.Histogram("kvcache_t_hl", "labelled histogram", ["plane"],
                                buckets=(0, 1, 2, 4, 8), registry=reg),
            "empty": lib.Counter("kvcache_t_empty", "never touched", ["op"], registry=reg),
        })
    for _ in range(200):
        op = rng.randrange(6)
        amount = rng.choice([0.0, 0.5, 1.0, 3.0, 1e-4, 12345.678, 1e7])
        label = rng.choice(["a", 'q"uote', "b\\s", "new\nline"])
        for m in made:
            if op == 0:
                m["c"].inc(amount)
            elif op == 1:
                m["cl"].labels(kind=label).inc(amount)
            elif op == 2:
                m["g"].set(amount - 5.0)
                m["gl"].labels(label, "r1").inc(amount)
            elif op == 3:
                m["h"].observe(amount)
            elif op == 4:
                m["hl"].labels(plane=label).observe(amount)
            else:
                m["gl"].labels(state="s", region=label).dec(amount)
    text = registry.generate_latest(ours).decode()
    assert text == _exposition_without_created(prometheus_client.generate_latest(theirs).decode())
    assert made[0]["c"]._value.get() == made[1]["c"]._value.get()
    assert made[0]["cl"].labels(kind="a")._value.get() == made[1]["cl"].labels(kind="a")._value.get()
    ours_fams = [(f.name, f.type, f.documentation, [(s.name, s.labels, s.value) for s in f.samples])
                 for f in ours.collect()]
    theirs_fams = [(f.name, f.type, f.documentation,
                    [(s.name, s.labels, s.value) for s in f.samples
                     if not s.name.endswith("_created")])
                   for f in theirs.collect()]
    assert ours_fams == theirs_fams


def test_registry_refuses_a_second_registration():
    registry = _mod(PORT_PKG, "metrics.registry")
    reg = registry.CollectorRegistry()
    registry.Counter("kvcache_t_dup_total", "x", registry=reg)
    with pytest.raises(ValueError, match="Duplicated timeseries"):
        registry.Counter("kvcache_t_dup", "x", registry=reg)
    with pytest.raises(ValueError):
        registry.Histogram("kvcache_t_le", "x", ["le"], registry=reg)
    with pytest.raises(ValueError):
        registry.Counter("kvcache_t_neg", "x", registry=reg).inc(-1)


# -- one workload, two expositions -----------------------------------------------


def _exposition(pkg) -> str:
    if pkg == JAX_PKG:
        return prometheus_client.generate_latest(prometheus_client.REGISTRY).decode()
    registry = _mod(PORT_PKG, "metrics.registry")
    return registry.generate_latest(registry.REGISTRY).decode()


# Families whose values time the machine: compared by their `_count` only,
# or (strided by a process-wide counter) not at all.
_TIMED = re.compile(r"_seconds$")
_MASKED = {"kvcache_stage_latency_seconds", "kvcache_event_apply_delay_seconds"}


def _kvcache_samples(text: str) -> dict:
    out = {}
    for fam in prom_parser.text_string_to_metric_families(text):
        if not fam.name.startswith("kvcache_") or fam.name in _MASKED:
            continue
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            if _TIMED.search(fam.name) and not s.name.endswith("_count"):
                continue
            out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def _help_and_type_lines(text: str) -> list:
    return sorted(line for line in text.splitlines()
                  if line.startswith(("# HELP kvcache_", "# TYPE kvcache_"))
                  and "_created " not in line)


def _workload(pkg):
    """A seeded run through the collectors' real call sites."""
    collector = _mod(pkg, "metrics.collector")
    collector.register_metrics()
    index_mod = _mod(pkg, "kvcache.kvblock.index")
    key_mod = _mod(pkg, "kvcache.kvblock.key")
    indexer_mod = _mod(pkg, "kvcache.indexer")
    tp_mod = _mod(pkg, "kvcache.kvblock.token_processor")
    pool_mod = _mod(pkg, "tokenization.pool")
    admission = _mod(pkg, "api.admission")
    carrier = _mod(pkg, "obs.carrier")
    rng = random.Random(7)
    index = index_mod.new_index(index_mod.IndexConfig(enable_metrics=True))
    indexer = indexer_mod.Indexer(
        config=indexer_mod.IndexerConfig(
            token_processor_config=tp_mod.TokenProcessorConfig(block_size=4)),
        tokenization_pool=pool_mod.TokenizationPool(pool_mod.TokenizersPoolConfig(
            workers=1, local_tokenizer_files={TEST_MODEL_NAME: TEST_TOKENIZER_JSON})),
        kv_block_index=index,
    )
    indexer.run()
    try:
        words = "alpha beta gamma delta epsilon zeta eta theta iota kappa".split()
        prompts = [" ".join(rng.choice(words) for _ in range(rng.randint(8, 30)))
                   for _ in range(6)]
        for i, prompt in enumerate(prompts[:4]):
            enc = indexer.tokenizers_pool.tokenizer.encode(prompt, TEST_MODEL_NAME)
            keys = indexer.token_processor.tokens_to_kv_block_keys(None, enc.tokens,
                                                                   TEST_MODEL_NAME)
            engine = [key_mod.Key(TEST_MODEL_NAME, 1000 * (i + 1) + j) for j in range(len(keys))]
            index.add(engine, keys, [key_mod.PodEntry(f"pod-{i % 2}", "gpu")])
            if i == 3:
                index.evict(engine[-1], [key_mod.PodEntry("pod-1", "gpu")])
        for prompt in prompts:
            indexer.get_pod_scores(prompt, TEST_MODEL_NAME, [])
        indexer.score_many([indexer_mod.ScoreRequest(p, TEST_MODEL_NAME, []) for p in prompts])
        gate = admission.AdmissionController(admission.AdmissionConfig(
            max_concurrency=1, max_queue_depth=0, max_wait_s=0.001))
        with gate.admit(None):
            with pytest.raises(admission.AdmissionRejected):
                with gate.admit(None):
                    pass
        with pytest.raises(admission.AdmissionRejected):
            with gate.admit(0.0):
                pass
        carrier.parse_carrier("not-a-carrier")
    finally:
        indexer.shutdown()


def test_one_workload_adds_the_same_samples_to_both_expositions():
    before = {pkg: _exposition(pkg) for pkg in PACKAGES}
    for pkg in PACKAGES:
        _workload(pkg)
    after = {pkg: _exposition(pkg) for pkg in PACKAGES}
    for pkg in PACKAGES:
        _mod(pkg, "metrics.collector").stop_metrics_logging()
    deltas = {}
    for pkg in PACKAGES:
        b, a = _kvcache_samples(before[pkg]), _kvcache_samples(after[pkg])
        deltas[pkg] = {k: v - b.get(k, 0.0) for k, v in a.items() if v != b.get(k, 0.0)}
    assert deltas[PORT_PKG] == deltas[JAX_PKG]
    moved = {name for name, _ in deltas[PORT_PKG]}
    assert {"kvcache_index_admissions_total", "kvcache_index_evictions_total",
            "kvcache_index_lookup_requests_total", "kvcache_index_lookup_hits_total",
            "kvcache_index_lookup_latency_seconds_count", "kvcache_tokenization_tokens_total",
            "kvcache_admission_shed_total", "kvcache_trace_carrier_errors_total"} <= moved
    assert _help_and_type_lines(after[PORT_PKG]) == _help_and_type_lines(after[JAX_PKG])


# -- traces and carriers across the packages ---------------------------------------


def _read_trace(pkg):
    obs = _mod(pkg, "obs")
    ns = importlib.import_module("tests.test_torch_fleethealth").reference_module(
        "test_obs.py", pkg)
    obs.configure(obs.ObsConfig(enabled=True))
    obs.get_recorder().clear()
    indexer = ns._make_indexer()
    try:
        ns._seed_index(indexer)
        indexer.get_pod_scores(ns.PROMPT, TEST_MODEL_NAME, [])
        return obs.get_recorder().recent()[-1]
    finally:
        indexer.shutdown()
        obs.configure(obs.ObsConfig())
        obs.get_recorder().clear()


def test_a_read_trace_has_the_same_spans_in_both_packages():
    traces = {pkg: _read_trace(pkg) for pkg in PACKAGES}
    shapes = {pkg: (t.name, [(s[0], s[1]) for s in t.spans]) for pkg, t in traces.items()}
    assert shapes[PORT_PKG] == shapes[JAX_PKG]
    names = [n for n, _ in shapes[PORT_PKG][1]]
    for stage in ("read.tokenize", "read.tokenize_queue_wait", "read.prefix_store",
                  "read.encode", "read.derive", "read.lookup", "read.score"):
        assert stage in names


@pytest.mark.parametrize("writer,reader", [(JAX_PKG, PORT_PKG), (PORT_PKG, JAX_PKG)],
                         ids=["jax-to-port", "port-to-jax"])
def test_carriers_cross_the_packages(writer, reader):
    w, r = _mod(writer, "obs"), _mod(reader, "obs")
    rng = random.Random(3)
    for _ in range(20):
        trace_id = rng.getrandbits(64) or 1
        span_id, flags = rng.getrandbits(64), rng.getrandbits(8)
        wire = w.TraceCarrier(trace_id, span_id, flags).serialize()
        parsed = r.parse_carrier(wire)
        assert (parsed.trace_id, parsed.span_id, parsed.flags) == (trace_id, span_id, flags)
        assert parsed.serialize() == wire
    w.configure(w.ObsConfig(enabled=True))
    r.configure(r.ObsConfig(enabled=True))
    try:
        with w.request("read.get_pod_scores") as _:
            trace = w.current_trace()
            with w.stage("read.lookup"):
                pass
            wire = w.current_carrier()
        with r.adopt(wire) as scope:
            with r.request("cluster.get_pod_scores"):
                with r.stage("read.score"):
                    pass
        assert scope.trace.trace_id == trace.trace_id
        payload = r.export_trace(scope.trace)
        local = w.Trace("cluster.scatter")
        assert w.graft_remote(local, payload, local.t0, local.t0 + 1.0) == 2
        assert [(s[0], s[1]) for s in local.spans] == [
            ("cluster.rpc", 1), ("cluster.get_pod_scores", 2), ("read.score", 3)]
    finally:
        for o in (w, r):
            o.configure(o.ObsConfig())
            o.get_recorder().clear()


_SPAN_SITE = re.compile(r'obs\.(?:request|stage)\(\s*["\']([a-z_][a-z_.]*)["\']'
                        r'|obs\.record(?:_into)?\(\s*(?:[\w.\[\]]+\s*,\s*)?["\']([a-z_][a-z_.]*)["\']'
                        r'|hop=["\']([a-z_][a-z_.]*)["\']', re.S)


def _emitted(pkg_dir: str) -> set:
    names = set()
    for path in (ROOT / pkg_dir).rglob("*.py"):
        if path.parent.name == "obs":
            continue
        for groups in _SPAN_SITE.findall(path.read_text(encoding="utf-8")):
            names.update(g for g in groups if g)
    return names


def test_port_sites_emit_the_reference_span_names():
    port, jax = _emitted(PORT_PKG), _emitted(JAX_PKG)
    assert len(port) >= 25
    assert port == jax
    assert port <= _mod(PORT_PKG, "obs.spans").SPAN_INVENTORY
    assert _mod(PORT_PKG, "obs.spans").SPAN_INVENTORY == _mod(JAX_PKG, "obs.spans").SPAN_INVENTORY


def test_metrics_beat_thread_stops():
    collector = _mod(PORT_PKG, "metrics.collector")
    collector.stop_metrics_logging(timeout_s=5.0)
    collector.start_metrics_logging(interval_s=0.01)
    thread = collector._beat_thread
    try:
        assert thread is not None and thread.is_alive()
    finally:
        collector.stop_metrics_logging(timeout_s=5.0)
    assert collector._beat_thread is None
    thread.join(5.0)
    assert not thread.is_alive()
