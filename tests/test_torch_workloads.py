"""The port's workload engine against the JAX package's, on the same inputs.

- Every test of tests/test_workloads.py but the one that drives bench.py's
  fleet simulator (`WAITS`) runs on both packages (`reference_module`):
  distribution fidelity, determinism and record/replay, the arrival
  processes, the geo and agentic scenarios.
- Every generator (ShareGPT and its uniform control, multi-tenant, agentic,
  geo, and the three adversarial ones) at two seeds, and the ShareGPT trace
  chip_smoke.py phase 16a serves: the JSONL bytes and the `materialize()`
  prompt streams of both packages are equal, a trace written by either
  package reads back in the other byte for byte, and the KS/TV numbers of
  `stats.validate_trace` are equal. The sha256 of 16a's trace equals the
  constant chip_smoke.py checks on the card.
- chip_smoke.py phase 16a's arms at CPU parameters over that trace: the
  router's prediction comes true on every precise request, precise routing
  hits more than round robin, and the checked requests' greedy tokens are a
  never-evicting pod's.
"""

import dataclasses
import hashlib
import importlib
import io

import pytest

from tests.test_torch_fleethealth import (
    JAX_PKG,
    PACKAGES,
    PKG_IDS,
    PORT_PKG,
    case_id,
    reference_cases,
    reference_module,
    run_reference_case,
)

# Cases of tests/test_workloads.py that need code this port does not carry.
WAITS = {
    "TestSimBenchShareGPT": "bench.py's FleetSim, the benchmark's own code, which is not "
                            "ported (chip_smoke.py phase 16a serves the ShareGPT trace instead; "
                            "test_phase_16a_arms_rehearse_the_replay rehearses it)",
}
CASES = reference_cases("test_workloads.py", WAITS)


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_workloads_case_on_both_packages(case, pkg, request):
    run_reference_case("test_workloads.py", case, pkg, request)


def test_every_workloads_case_is_taken():
    ns = reference_module("test_workloads.py", JAX_PKG)
    every = {(c, m) for c, cls in vars(ns).items() if c.startswith("Test")
             for m in vars(cls) if m.startswith("test_")}
    waiting = {(c, m) for c, m in every if c in WAITS or f"{c}::{m}" in WAITS}
    assert {(c, m) for c, m, _ in CASES} == every - waiting
    assert len(waiting) == 1


def test_port_namespace_runs_the_port():
    ns = reference_module("test_workloads.py", PORT_PKG)
    for name in ("ShareGPTConfig", "generate", "read_trace", "write_trace", "poisson_arrivals"):
        assert getattr(ns, name).__module__.startswith(PORT_PKG + "."), name
    assert ns.stats.__name__ == f"{PORT_PKG}.workloads.stats"


# -- every generator, byte for byte ---------------------------------------------

# (generator, config class, config keywords beside the seed)
GENERATORS = {
    "sharegpt": ("generate", "ShareGPTConfig",
                 dict(n_sessions=12, max_turns=4, length_scale=0.3, prefix_groups=4)),
    "uniform_control": ("uniform_control", "ShareGPTConfig",
                        dict(n_sessions=12, length_scale=0.3)),
    "multitenant": ("generate_multitenant", "MultiTenantConfig",
                    dict(n_tenants=3, n_sessions=16, zipf_s=2.0, session_rate_per_s=6.0,
                         max_turns=2, prefix_words=120)),
    "agentic": ("generate_agentic", "AgenticConfig", {}),
    "geo": ("generate_geo", "GeoConfig", dict(n_sessions=20)),
    "flood": ("generate_flood", "FloodConfig", dict(n_requests=40, prompt_words=60)),
    "session_explosion": ("generate_session_explosion", "SessionExplosionConfig",
                          dict(n_sessions=40, prefix_words=40)),
    "churn_storm": ("generate_churn_storm", "ChurnStormConfig",
                    dict(users_per_group=2, prefix_words=40, n_churn_events=6)),
}
SEEDS = (5, 11)
# chip_smoke.py phase 16a's traffic: benchmarking/fleet_device_bench.py's
# SHAREGPT_FULL over four pods at its default seed.
SHAREGPT_FULL = dict(seed=7, prefix_groups=4, n_sessions=24, max_turns=8, length_scale=1.0,
                     session_rate_per_s=0.5)


def _workloads(pkg):
    return importlib.import_module(f"{pkg}.workloads")


def _trace(pkg, name, seed):
    w = _workloads(pkg)
    fn, cfg_cls, kwargs = GENERATORS[name]
    return getattr(w, fn)(getattr(w, cfg_cls)(seed=seed, **kwargs))


def _jsonl(pkg, trace) -> str:
    buf = io.StringIO()
    _workloads(pkg).write_trace(trace, buf)
    return buf.getvalue()


def _stream(trace) -> list:
    return [dataclasses.astuple(r) for r in trace.materialize()]


GEN_CASES = [(name, seed) for name in GENERATORS for seed in SEEDS]


@pytest.mark.parametrize("name,seed", GEN_CASES, ids=[f"{n}-{s}" for n, s in GEN_CASES])
def test_generator_bytes_and_prompts_match_jax(name, seed):
    jax_trace, port_trace = _trace(JAX_PKG, name, seed), _trace(PORT_PKG, name, seed)
    jax_bytes = _jsonl(JAX_PKG, jax_trace)
    assert _jsonl(PORT_PKG, port_trace) == jax_bytes
    assert _stream(port_trace) == _stream(jax_trace)
    assert len(jax_bytes) > 1000 and len(_stream(jax_trace)) > 1
    # Written by one package, read by the other: the same bytes again.
    for reader, writer, trace in ((PORT_PKG, JAX_PKG, jax_trace), (JAX_PKG, PORT_PKG, port_trace)):
        back = _workloads(reader).read_trace(io.StringIO(_jsonl(writer, trace)))
        assert type(back).__module__.startswith(reader + ".")
        assert _jsonl(reader, back) == jax_bytes
        assert _stream(back) == _stream(jax_trace)


def test_churn_schedule_matches_jax():
    for seed in SEEDS:
        cfgs = [_workloads(p).ChurnStormConfig(seed=seed, n_churn_events=9) for p in PACKAGES]
        jax, port = (_workloads(p).churn_schedule(c) for p, c in zip(PACKAGES, cfgs))
        assert port == jax and len(jax) > 9


def _sharegpt_full(pkg):
    w = _workloads(pkg)
    return w.generate(w.ShareGPTConfig(**SHAREGPT_FULL))


def test_phase_16a_trace_is_the_reference_trace():
    """The card serves the JAX package's exact prompt stream: chip_smoke.py
    checks its trace's sha256 against SHAREGPT_SHA256, which is the JAX
    package's trace's."""
    import chip_smoke

    jax_trace, port_trace = _sharegpt_full(JAX_PKG), _sharegpt_full(PORT_PKG)
    jax_bytes = _jsonl(JAX_PKG, jax_trace)
    assert _jsonl(PORT_PKG, port_trace) == jax_bytes
    assert hashlib.sha256(jax_bytes.encode()).hexdigest() == chip_smoke.SHAREGPT_SHA256
    assert chip_smoke.SHAREGPT_FULL == SHAREGPT_FULL
    assert _stream(port_trace) == _stream(jax_trace)
    assert [r.prompt for r in chip_smoke.sharegpt_requests()] == \
        [r.prompt for r in jax_trace.materialize()]


@pytest.mark.parametrize("seed", SEEDS + (SHAREGPT_FULL["seed"],))
def test_fidelity_numbers_match_jax(seed):
    """stats.validate_trace's KS and TV statistics and tolerances, and the
    sampling helpers' draws, are equal on both packages."""
    import random

    reports = []
    for pkg in PACKAGES:
        w = _workloads(pkg)
        trace = (_sharegpt_full(pkg) if seed == SHAREGPT_FULL["seed"]
                 else w.generate(w.ShareGPTConfig(seed=seed, n_sessions=200)))
        report = w.stats.validate_trace(trace)
        rng = random.Random(seed)
        draws = [w.stats.sample_length(rng, w.tables.USER_LEN_QUANTILES, 0.5)
                 for _ in range(200)]
        draws += [w.stats.sample_pmf(rng, w.tables.TURNS_PER_SESSION_PMF) for _ in range(200)]
        reports.append(([(c.name, c.statistic, c.tolerance, c.n) for c in report.checks],
                        report.as_dict(), draws))
    assert reports[1] == reports[0]
    assert len(reports[0][0]) == 3


def test_tables_are_the_reference_tables():
    jax, port = (importlib.import_module(f"{p}.workloads.tables") for p in PACKAGES)
    names = [n for n in vars(jax) if n.isupper()]
    assert names and all(getattr(port, n) == getattr(jax, n) for n in names)
    assert [n for n in vars(port) if n.isupper()] == names


def test_workload_shim_and_exports_match():
    for pkg in PACKAGES:
        shim = importlib.import_module(f"{pkg}.utils.workload")
        assert shim.text is _workloads(pkg).synthetic.text
    assert _workloads(PORT_PKG).__all__ == _workloads(JAX_PKG).__all__


def test_phase_16a_arms_rehearse_the_replay():
    """tests/test_workloads.py's growth claim on the port's pods at CPU width
    (a 1-layer, 64-wide model of the flagship's vocabulary): over the
    ShareGPT trace the card serves, each precise request's cached tokens are
    16 x the index's match_blocks, every pod's index equals its pages,
    precise routing hits more than round robin, and the checked requests'
    greedy tokens equal a never-evicting pod's. The card runs these arms."""
    import chip_smoke

    params, cfg = chip_smoke.small_model("cpu", seed=0, **chip_smoke.REHEARSAL_MODEL)
    requests = chip_smoke.sharegpt_requests()
    arms = {policy: chip_smoke.trace_arm(params, cfg, requests, policy)
            for policy in ("precise", "round_robin")}
    assert [f for arm in arms.values() for f in arm["failures"]] == []
    precise, rr = arms["precise"], arms["round_robin"]
    assert precise["summary"]["requests"] == rr["summary"]["requests"] == len(requests)
    assert precise["summary"]["hit_rate"] > rr["summary"]["hit_rate"] + 0.2
    assert all(r["cached"] == r["predicted"] for r in precise["rows"])
    tok = chip_smoke.TextTokenizer(cfg.vocab_size)
    subset = chip_smoke.alone_subset(len(requests))
    want = chip_smoke.never_evicting_tokens(
        params, cfg, [tok.encode(r.prompt, "").tokens for r in requests], subset)
    assert [precise["rows"][k]["tokens"] for k in subset] == want
