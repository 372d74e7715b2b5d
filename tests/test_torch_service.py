"""The port's scoring services and config against the JAX package's.

- Every test of tests/test_api.py (the gRPC service and client, the HTTP
  service), tests/test_config.py and tests/test_admission.py (the gate, its
  HTTP 429 with Retry-After and the X-Request-Deadline-Ms budget, its gRPC
  RESOURCE_EXHAUSTED), the config_from_env case of tests/test_helm_chart.py,
  the HTTP cases of tests/test_native_core.py and the gRPC bulk stream and
  HTTP batch cases of tests/test_score_many.py run on both packages
  (`own_cases` / `run_own_case` of tests/test_torch_cluster.py). On the port
  aiohttp's `TestClient(TestServer(app))` is tests/loopback_client.py, which
  talks to the port's server over 127.0.0.1. The native-readiness case that
  needs the JAX package's C arena built runs on the port, which builds its
  own at first use.
- `config_from_env` gives the same dict on the same environ, and the two
  `indexer_pb2` descriptors serialize byte for byte alike.
- One scripted fleet (the same index contents, event batches and requests)
  behind each package's ScoringService, with every subsystem the service
  can wire switched on: every one of the 25 route registrations answers
  with the same status and body. Masked, because they time or date the
  run: the keys in `VOLATILE`, and in `BUILT_HERE` whether each package's
  C extension is built where the test runs; /metrics is compared by its `kvcache_` HELP
  and TYPE lines, /debug/traces by its traces' names and span names, and
  /federation/digest by the digest each package decodes from it.
- chip_smoke.py phase 18a at CPU width (the flagship's vocabulary on a
  1-layer, 64-wide model): the service beside phase 16a's precise arm and
  17a's replicas, over the whole trace, holds every bar, and its /metrics
  counts, pod states and trace count are `SERVICE_PREDICTED`'s, which the
  card's run is held to; chip_fault_check.py's three service faults fail
  those bars, where the real service passes.
"""

import asyncio
import importlib
import itertools
import json
import random
import re

import pytest

from tests.conftest import TEST_MODEL_NAME, TEST_TOKENIZER_JSON
from tests.test_torch_cluster import (  # noqa: F401 - one_thread is a fixture
    every_test,
    one_thread,
    own_case_id,
    own_cases,
    run_own_case,
    waiting,
)
from tests.test_torch_fleethealth import JAX_PKG, PACKAGES, PKG_IDS, PORT_PKG


def _only(test_file, keep):
    """own_cases of tests/<test_file> whose "Class" or "Class::test" is in
    `keep`."""
    return [c for c in own_cases(test_file, {})
            if c[0] in keep or f"{c[0]}::{c[1]}" in keep]


# (test file, case, the packages it runs on)
CASES = (
    [("test_api.py", c, PACKAGES) for c in own_cases("test_api.py", {})]
    + [("test_config.py", c, PACKAGES) for c in own_cases("test_config.py", {})]
    + [("test_admission.py", c, PACKAGES) for c in own_cases("test_admission.py", {})]
    + [("test_helm_chart.py", c, PACKAGES) for c in _only(
        "test_helm_chart.py", {"TestScheduling::test_manager_env_wiring_matches_service_env_contract"})]
    + [("test_native_core.py", c, PACKAGES) for c in _only(
        "test_native_core.py", {"TestHttpSurfaces::test_readyz_native_core_section_disabled"})]
    + [("test_native_core.py", c, [PORT_PKG]) for c in _only(
        "test_native_core.py", {"TestHttpSurfaces::test_readyz_native_core_section_enabled"})]
    + [("test_score_many.py", c, PACKAGES) for c in _only(
        "test_score_many.py", {"TestGrpcBulkStream", "TestHttpBatch"})]
)
RUNS = [(f, c, pkg) for f, c, pkgs in CASES for pkg in pkgs]


def _run_id(run):
    test_file, case, pkg = run
    return f"{test_file[5:-3]}::{own_case_id(case)}-{PKG_IDS[PACKAGES.index(pkg)]}"


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_service_case(run, request):
    test_file, case, pkg = run
    run_own_case(test_file, case, pkg, request)


def test_every_service_case_is_taken():
    for test_file in ("test_api.py", "test_config.py", "test_admission.py"):
        assert {(c, m) for f, (c, m, _), _ in CASES if f == test_file} == every_test(test_file)
    assert sum(f == "test_score_many.py" for f, _, _ in CASES) == 2
    assert sum(f == "test_native_core.py" for f, _, _ in CASES) == 2
    assert waiting("test_api.py", {}) == set()


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# -- config and the wire contract ------------------------------------------------


def _env_kinds():
    """{variable: "int" | "float" | "flag" | "str"} of every variable the
    reference's config_from_env reads, from its source."""
    import inspect

    src = inspect.getsource(_mod(JAX_PKG, "api.http_service").config_from_env)
    kinds = {}
    for m in re.finditer(r'(int|float)?\(?\s*os\.environ\.get\(\s*"([A-Z_0-9]+)"[^)]*\)'
                         r'(\s*==\s*"1")?', src):
        kind, name, flag = m.groups()
        kinds[name] = "flag" if flag else (kind or "str")
    return kinds


def _env_value(rng, kind):
    if kind == "int":
        return str(rng.randint(0, 500))
    if kind == "float":
        return f"{rng.uniform(0.0, 99.0):.3f}"
    if kind == "flag":
        return rng.choice(["0", "1", "yes"])
    return rng.choice(["", "x", "region-0,region-1", f"v{rng.randint(0, 99)}"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_config_from_env_is_the_reference_dict(seed, monkeypatch):
    """The same environ (every variable the reference reads, seeded values,
    some left unset) gives the same dict from both packages."""
    kinds = _env_kinds()
    assert len(kinds) >= 70 and kinds["HTTP_PORT"] == "int" and kinds["SLO"] == "flag"
    rng = random.Random(seed)
    for name, kind in sorted(kinds.items()):
        if seed and rng.random() < 0.8:
            monkeypatch.setenv(name, _env_value(rng, kind))
        else:
            monkeypatch.delenv(name, raising=False)
    got = {pkg: _mod(pkg, "api.http_service").config_from_env() for pkg in PACKAGES}
    assert got[PORT_PKG] == got[JAX_PKG]


def test_indexer_pb2_is_the_reference_wire_contract():
    port, jax = (_mod(pkg, "api.indexer_pb2") for pkg in (PORT_PKG, JAX_PKG))
    assert port.DESCRIPTOR.serialized_pb == jax.DESCRIPTOR.serialized_pb
    assert port.DESCRIPTOR.package == "kvtpu.api.v1"
    msg = jax.GetPodScoresRequest(prompt="p", model_name="m", pod_identifiers=["a"], lora_id=3)
    back = port.GetPodScoresRequest.FromString(msg.SerializeToString())
    assert (back.prompt, back.model_name, list(back.pod_identifiers), back.lora_id) == (
        "p", "m", ["a"], 3)


# -- one scripted fleet behind both services -------------------------------------

BLOCK = 4
PODS = ["pod-a", "pod-b", "pod-c"]
# Keys whose values time or date the run (or count the process's own
# history, like the recorder's totals), masked in every route's body.
VOLATILE = {
    "age_s", "last_event_age_s", "snapshot_age_s", "created_ts", "ts", "t0", "t1", "at",
    "duration_ms", "duration_us", "duration_s", "start_us", "dur_us", "trace_id", "parent_id",
    "thread", "p50_us", "p90_us", "mean_us", "share_pct", "self_us", "wall_us", "us",
    "ms", "elapsed_s", "now", "last_tick", "last_tick_s", "last_audit_t", "started_at",
    "uptime_s", "last_actuation", "slowest_stage_recent", "ewma_fetch_latency_ms",
    "completed_traces", "dropped_traces", "ring_occupancy", "slow_traces_retained",
    "bytes", "accounted_bytes", "total_bytes", "rss_bytes", "entries", "fallbacks",
    "last_digest_age_s", "digest_age_s", "expected_in_s", "eta_s", "last_seen_s",
    "samples", "burn_rate", "burn", "read_ms", "window_s", "effective_window_s",
}


# Keys that say whether a package's C extension is built where the test runs:
# the port builds its own at first use, the JAX package's exists only where
# it was built (a fresh checkout has none).
BUILT_HERE = {"native", "module_available"}


def _masked(obj):
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in VOLATILE | BUILT_HERE else _masked(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


def _env(tmp_path, pkg):
    return dict(
        zmq_endpoint="tcp://*:0", zmq_topic="kv@", pool_concurrency=2, hash_seed="",
        block_size=BLOCK, http_port=0, enable_metrics=True, trace_enabled=True,
        trace_ring=512, trace_slow_ms=1e9, trace_propagate=True, suspect_after_s=1e6,
        stale_after_s=2e6, routing_policy="load_blend", placement=True, placement_hotness=1.0,
        prediction=True, antientropy=True, autopilot=True, resourcegov=True,
        resourcegov_budget_mb=256.0, federation=True, federation_region_id="region-0",
        cluster_snapshot_path=str(tmp_path / "snapshot.cbor"), admission_retry_after_ms=2500,
    )


def _indexer(pkg):
    indexer_mod = _mod(pkg, "kvcache.indexer")
    index_mod = _mod(pkg, "kvcache.kvblock.index")
    tp_mod = _mod(pkg, "kvcache.kvblock.token_processor")
    pool_mod = _mod(pkg, "tokenization.pool")
    import dataclasses

    indexer = indexer_mod.Indexer(
        config=indexer_mod.IndexerConfig(
            token_processor_config=tp_mod.TokenProcessorConfig(block_size=BLOCK),
            kv_block_index_config=dataclasses.replace(index_mod.IndexConfig.default(),
                                                      enable_metrics=True)),
        tokenization_pool=pool_mod.TokenizationPool(pool_mod.TokenizersPoolConfig(
            workers=1, local_tokenizer_files={TEST_MODEL_NAME: TEST_TOKENIZER_JSON})),
    )
    indexer.run()
    return indexer


def _prompts():
    rng = random.Random(11)
    words = "the quick brown fox jumps over a lazy dog near river bank".split()
    return [" ".join(rng.choice(words) for _ in range(rng.randint(10, 40))) for _ in range(6)]


def _batches(pkg, service):
    """Each pod's event batch: BlockStored for the chains of its prompts."""
    events = _mod(pkg, "kvevents.events")
    pool = _mod(pkg, "kvevents.pool")
    tok = service.indexer.tokenizers_pool.tokenizer
    msgs = []
    for i, prompt in enumerate(_prompts()[:4]):
        pod = PODS[i % len(PODS)]
        tokens = tok.encode(prompt, TEST_MODEL_NAME).tokens
        n = len(tokens) // BLOCK
        hashes = [1000 * (i + 1) + j for j in range(n)]
        batch = events.EventBatch(ts=0.0, events=[events.BlockStored(
            block_hashes=hashes, parent_block_hash=None, token_ids=tokens[:n * BLOCK],
            block_size=BLOCK, medium="gpu")])
        if i == 3:
            batch.events.append(events.BlockRemoved(block_hashes=hashes[-1:], medium="gpu"))
        msgs.append(pool.Message(topic=f"kv@{pod}@{TEST_MODEL_NAME}", payload=batch.to_msgpack(),
                                 seq=i // len(PODS), pod_identifier=pod,
                                 model_name=TEST_MODEL_NAME))
    return msgs


_CHAT_TEMPLATE = ("{% for m in messages %}[{{ m.role }}] {{ m.content }} {% endfor %}"
                  "{% if add_generation_prompt %}[assistant]{% endif %}")


async def _script(pkg, service, client_mod):
    """Every route, in a fixed order; (label, status, body) each."""
    out = []
    prompts = _prompts()
    carrier = _mod(pkg, "obs").TraceCarrier(0x1234, 0x1234).serialize()
    async with client_mod.TestClient(client_mod.TestServer(service.make_app())) as client:
        async def rec(label, resp, kind="json"):
            if kind == "json":
                body = await resp.json()
            elif kind == "text":
                body = await resp.text()
            else:
                body = await resp.read()
            out.append((label, resp.status, body))

        service.start(with_subscriber=False)
        for msg in _batches(pkg, service):
            service.event_pool.add_task(msg)
        service.event_pool.drain()
        await rec("health", await client.get("/health"))
        for k, p in enumerate(prompts):
            await rec(f"score {k}", await client.post(
                "/score_completions", json={"prompt": p, "model": TEST_MODEL_NAME},
                headers={"X-Kvtpu-Trace": carrier}))
        await rec("score bad", await client.post("/score_completions", json={"model": "x"}))
        await rec("batch", await client.post("/score_completions/batch", json={"requests": [
            {"prompt": p, "model": TEST_MODEL_NAME, "pods": PODS[:2]} for p in prompts]}))
        await rec("batch cap", await client.post("/score_completions/batch", json={
            "requests": [{"prompt": "x", "model": TEST_MODEL_NAME}] * 200}))
        await rec("chat", await client.post("/score_chat_completions", json={
            "model": TEST_MODEL_NAME, "chat_template": _CHAT_TEMPLATE,
            "messages": [{"role": "user", "content": prompts[0]}]}))
        await rec("explain get", await client.get("/debug/score_explain", params={
            "prompt": prompts[1], "model": TEST_MODEL_NAME, "pods": ",".join(PODS)}))
        await rec("explain post", await client.post("/debug/score_explain", json={
            "prompt": prompts[2], "model": TEST_MODEL_NAME}))
        await rec("explain bad", await client.get("/debug/score_explain"))
        await rec("pod_load", await client.post("/pod_load", json={
            "pod": "pod-a", "queue_depth": 3, "inflight": 1}))
        await rec("pod_load bad", await client.post("/pod_load", json={"queue_depth": 3}))
        await rec("routing", await client.get("/routing/status"))
        await rec("cluster", await client.get("/cluster/status"))
        await rec("placement", await client.get("/placement/status"))
        await rec("antientropy", await client.get("/antientropy/status"))
        await rec("prediction", await client.get("/prediction/status"))
        await rec("federation", await client.get("/federation/status"))
        await rec("federation score get", await client.get("/federation/score", params={
            "prompt": prompts[3], "model": TEST_MODEL_NAME}))
        await rec("federation score post", await client.post("/federation/score", json={
            "prompt": prompts[4], "model": TEST_MODEL_NAME, "home_region": "region-0"}))
        await rec("digest get", await client.get("/federation/digest"), kind="bytes")
        await rec("digest post bad", await client.post("/federation/digest", data=b"\x00junk"))
        await rec("snapshot", await client.post("/cluster/snapshot"))
        await rec("slo", await client.get("/slo/status"))
        await rec("autopilot", await client.get("/autopilot/status"))
        await rec("resource", await client.get("/resource/status"))
        await rec("critical", await client.get("/debug/critical_path"))
        await rec("traces", await client.get("/debug/traces?plane=read&limit=50"))
        await rec("traces bad", await client.get("/debug/traces?plane=bogus"))
        await rec("traces id", await client.get(f"/debug/traces?trace_id={0x1234:016x}"))
        await rec("metrics", await client.get("/metrics"), kind="text")
        await rec("readyz", await client.get("/readyz"))
        resp = await client.get("/health", headers={"X-Request-Deadline-Ms": "0"})
        await rec("health deadline", resp)
        resp = await client.post("/score_completions", json={
            "prompt": prompts[0], "model": TEST_MODEL_NAME},
            headers={"X-Request-Deadline-Ms": "0"})
        out.append(("deadline", resp.status, await resp.json(), resp.headers.get("Retry-After")))
    return out


def _normalize(pkg, label, body):
    if label == "metrics":
        return sorted(line for line in body.splitlines()
                      if line.startswith(("# HELP kvcache_", "# TYPE kvcache_"))
                      and "_created " not in line)
    if label.startswith("traces"):
        if "recent" not in body:
            return body
        return [(t["name"], [s["name"] for s in t["spans"]]) for t in body["recent"]]
    if label == "critical":
        return sorted(body["roots"])
    if label == "digest get":
        digest = _mod(pkg, "federation").decode_digest(body)
        return _masked(json.loads(json.dumps(digest.__dict__ if hasattr(digest, "__dict__")
                                             else digest, default=repr)))
    return _masked(body)


# The service's subsystems that decay or learn on their own clock (load
# blend, popularity, session gaps, health, anti-entropy, the federation's
# digest ages, the autopilot and the governor): frozen at one instant, both
# services answer alike however long each run takes.
FROZEN_CLOCK = ("load_tracker", "popularity", "session_table", "fleet_health", "antientropy",
                "federation", "autopilot", "autopilot_signals", "resourcegov", "reaper")
# The span API's stamps (obs/spans.py `_perf`) feed the read-latency
# histogram that /slo/status's read_latency_p99 counts against its 5 ms
# threshold: on a loaded host a real clock puts one request past it in one
# package's run only. A step clock of 1 us a read keeps every span far
# below the threshold in both.
SPAN_CLOCK_STEP_S = 1e-6


def _freeze_clocks(service):
    for name in FROZEN_CLOCK:
        obj = getattr(service, name, None)
        if obj is not None and hasattr(obj, "clock"):
            obj.clock = lambda: 1000.0
            for inner in vars(obj).values():
                if hasattr(inner, "clock") and not isinstance(inner, type):
                    inner.clock = obj.clock


def _step_clock():
    reads = itertools.count()
    return lambda: 1000.0 + next(reads) * SPAN_CLOCK_STEP_S


def _run_script(pkg, tmp_path):
    obs = _mod(pkg, "obs")
    obs.get_recorder().clear()
    spans = _mod(pkg, "obs.spans")
    real_perf, spans._perf = spans._perf, _step_clock()
    client_mod = (importlib.import_module("aiohttp.test_utils") if pkg == JAX_PKG
                  else importlib.import_module("tests.loopback_client"))
    service = _mod(pkg, "api.http_service").ScoringService(_env(tmp_path, pkg),
                                                            indexer=_indexer(pkg))
    _freeze_clocks(service)
    try:
        out = asyncio.run(_script(pkg, service, client_mod))
    finally:
        service.stop()
        _mod(pkg, "metrics.collector").stop_metrics_logging()
        obs.configure(obs.ObsConfig())
        obs.get_recorder().clear()
        spans._perf = real_perf
    return [(row[0], row[1], _normalize(pkg, row[0], row[2]), *row[3:]) for row in out]


def test_every_route_answers_as_the_reference(tmp_path):
    """The same scripted fleet behind both services: every route's status
    and (masked) body are equal, and the script reaches all 25 route
    registrations."""
    got = {pkg: _run_script(pkg, tmp_path) for pkg in PACKAGES}
    assert [r[:2] for r in got[PORT_PKG]] == [r[:2] for r in got[JAX_PKG]]
    for port_row, jax_row in zip(got[PORT_PKG], got[JAX_PKG]):
        assert port_row == jax_row, port_row[0]
    statuses = dict((r[0], r[1]) for r in got[PORT_PKG])
    assert statuses["deadline"] == 429 and statuses["batch cap"] == 400
    assert statuses["readyz"] == 200 and statuses["snapshot"] == 200
    app = _mod(PORT_PKG, "api.http_service").ScoringService(
        _env(tmp_path, "routes"), indexer=_indexer(PORT_PKG)).make_app()
    assert len(app.router.routes()) == 25


# -- chip_smoke.py phase 18a at CPU width ---------------------------------------


def _jax_read_trace(prompt):
    """The JAX package's read trace of one prompt through an Indexer built
    as phase 18a's service builds its own (the word tokenizer, the prefix
    store's shortcut off)."""
    import chip_smoke

    jax_obs = _mod(JAX_PKG, "obs")
    indexer_mod = _mod(JAX_PKG, "kvcache.indexer")
    tp_mod = _mod(JAX_PKG, "kvcache.kvblock.token_processor")
    pool_mod = _mod(JAX_PKG, "tokenization.pool")
    indexer = indexer_mod.Indexer(
        config=indexer_mod.IndexerConfig(
            token_processor_config=tp_mod.TokenProcessorConfig(block_size=chip_smoke.PAGE)),
        tokenization_pool=pool_mod.TokenizationPool(
            pool_mod.TokenizersPoolConfig(workers=2, min_prefix_overlap_ratio=float("inf")),
            tokenizer=chip_smoke.TextTokenizer(chip_smoke.FLAGSHIP["vocab_size"])))
    indexer.run()
    jax_obs.configure(jax_obs.ObsConfig(enabled=True))
    jax_obs.get_recorder().clear()
    try:
        indexer.get_pod_scores(prompt, chip_smoke.PROACTIVE_MODEL, [])
        return tuple(s[0] for s in jax_obs.get_recorder().recent()[-1].spans)
    finally:
        indexer.shutdown()
        jax_obs.configure(jax_obs.ObsConfig())
        jax_obs.get_recorder().clear()


def test_phase_18a_read_spans_are_the_reference_order():
    import chip_smoke

    long_prompt = " ".join(f"w{i}" for i in range(3 * chip_smoke.PAGE))
    assert _jax_read_trace(long_prompt) == chip_smoke.SERVICE_READ_SPANS
    assert _jax_read_trace("too short") == chip_smoke.SERVICE_SHORT_SPANS


def test_phase_18a_rehearses_the_service_beside_16a_and_17a(one_thread):
    """Phase 16a's precise arm with 17a's replicas and 18a's service beside
    it, as the full run has them, over the whole trace: every bar holds, and
    the service's readings are the predictions the card is held to."""
    import chip_smoke

    params, cfg = chip_smoke.small_model("cpu", seed=0, **chip_smoke.REHEARSAL_MODEL)
    requests = chip_smoke.sharegpt_requests()
    service = chip_smoke.ServiceShadow()
    arm = chip_smoke.cluster_arm(params, cfg, requests, service=service)
    assert arm["failures"] == [] and arm["cluster"]["failures"] == []
    s = arm["service"]
    assert s["failures"] == []
    want = chip_smoke.SERVICE_PREDICTED[len(requests)]
    assert {k: s[k] for k in want} == want
    assert s["batch"] == len(requests) and len(s["explained"]) == chip_smoke.SERVICE_EXPLAIN
    assert s["roots"] == ["read.get_pod_scores"]
    assert "read.get_pod_scores" in s["critical_roots"]
    assert s["metrics"]["kvcache_index_admissions_total"] > 0


def test_phase_18a_bars_catch_the_planted_faults(one_thread):
    """chip_fault_check.py's service faults over 16a's trace: the real
    service passes every bar (and reads the prediction), each fault fails
    its own."""
    import chip_fault_check as fc
    import chip_smoke

    params, cfg = chip_smoke.small_model("cpu", seed=0, **chip_smoke.REHEARSAL_MODEL)
    out = fc.run_service_bars(params, cfg)
    assert out["service_real"]["ok"]
    for label, key in fc.SERVICE_FAULTS.items():
        assert not out[label]["ok"] and out[label][key] > 0, (label, out[label])
