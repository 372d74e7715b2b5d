"""The port's anti-entropy plane against the JAX package's, on the same inputs.

- Every test of tests/test_antientropy.py runs on both packages
  (`reference_module`), the HTTP service's readiness document and the
  metrics-instrumented index included: `remove_entries` over
  every backend, the trust tracker, fetch-miss feedback (also end to end
  through a real transfer server and client: the JAX package's connector
  borrows the port's build of the transfer library), the resolver's negative
  cache, orphan removals in the event pool, the residency auditor and the
  engine's digest surface.
- A seeded silent-divergence plan (a pod wiped without a removal event, and a
  pod advertising blocks it never holds) through both packages' injector,
  pool, trackers and auditor: the auditor's per-round verdicts and repairs,
  the trust scores and the index contents must be exactly equal, on every
  backend.
"""

import pytest

from tests.test_torch_fleethealth import (
    BACKEND_IDS,
    BACKEND_NAMES,
    JAX_PKG,
    PACKAGES,
    PKG_IDS,
    PORT_PKG,
    SHORT_TICKS,
    case_id,
    reference_cases,
    resilience_run,
    run_reference_case,
)

# Cases of tests/test_antientropy.py that need a module the port lacks.
WAITS = {}
CASES = reference_cases("test_antientropy.py", WAITS)


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


def _host_tier_named_host(cls):
    """Port pods stage under the tier name "cpu", so the port's resolver
    reads that tier by default (`IndexBackedPeerResolver(host_tier="cpu")`,
    ROADMAP.md "Differences from the reference"); the reference's tests index
    their staged copies under "host", its default. The negative-cache cases
    run with the resolver reading "host" on both packages."""
    class NegativeCacheAtHost(cls):
        def _resolver(self, now, ttl=3.0):
            resolver, keys = cls._resolver(self, now, ttl)
            resolver.host_tier = "host"
            return resolver, keys

    return NegativeCacheAtHost


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_antientropy_case_on_both_packages(case, pkg, request):
    if case[0] == "TestFetchMissE2E":
        request.getfixturevalue("transfer_library")
    adapt = _host_tier_named_host if case[0] == "TestNegativeCache" else None
    run_reference_case("test_antientropy.py", case, pkg, request, adapt)


def test_every_policy_case_is_taken():
    """Every test of tests/test_antientropy.py."""
    from tests.test_torch_fleethealth import reference_module

    ns = reference_module("test_antientropy.py", JAX_PKG)
    every = {(c, m) for c, cls in vars(ns).items() if c.startswith("Test")
             for m in vars(cls) if m.startswith("test_")}
    taken = {(c, m) for c, m, _ in CASES}
    assert every - taken == set()


DIVERGENCE_PLAN = dict(seed=11, pods={
    "pod-1": dict(silent_wipe_at_s=4.0),
    "pod-2": dict(phantom_advertise_rate=0.5, phantom_from_s=2.0, phantom_until_s=7.0),
})


@pytest.mark.parametrize("backend_name", BACKEND_NAMES, ids=BACKEND_IDS)
def test_silent_divergence_repair_matches_jax(backend_name):
    """Neither fault shows in the stream (no gap, no silence), so only the
    auditor can find them: both packages' verdicts, repairs, trust and index
    must agree round by round, and the repairs must have happened."""
    ticks = SHORT_TICKS if backend_name == "redis" else 14
    jax, _ = resilience_run(JAX_PKG, backend_name, seed=3, ticks=ticks, plan=DIVERGENCE_PLAN)
    port, _ = resilience_run(PORT_PKG, backend_name, seed=3, ticks=ticks, plan=DIVERGENCE_PLAN)
    for key in jax:
        assert port[key] == jax[key], key
    assert port["anomalies"]["seq_gaps"] == 0
    assert port["injected"]["phantom_advertised"] > 0
    wiped = [v for _, round_ in port["verdicts"] for pod, v in round_.items()
             if pod == "pod-1" and v["phantom"]]
    assert wiped and port["auditor"]["phantoms_purged"] > 0
    assert port["trust"]["pods"]["pod-2"]["phantom_entries"] > 0


def test_auditor_readmits_at_the_configured_tiers():
    """The port's one addition to the auditor: re-admissions land under the
    tier names the pods publish ("gpu"/"cpu" on port pods); the defaults are
    the reference's "hbm"/"host"."""
    from llm_d_kv_cache_manager_tpu_torch.antientropy import AuditorConfig, ResidencyAuditor
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import (
        InMemoryIndex,
        InMemoryIndexConfig,
    )

    assert (AuditorConfig().device_tier, AuditorConfig().host_tier) == ("hbm", "host")
    index = InMemoryIndex(InMemoryIndexConfig(size=100))

    def digest(pod, device, host, k):
        return {"device": set(), "host": set(), "extra_device": [1, 2], "extra_host": [3]}

    auditor = ResidencyAuditor(index, "m", digest, clock=lambda: 0.0,
                               config=AuditorConfig(device_tier="gpu", host_tier="cpu"))
    verdict = auditor._reconcile("pod-a", [], [], {}, digest("pod-a", [], [], 4))
    assert verdict["readmitted"] == 3
    tiers = {(h, tier) for _, h, pods in index.export_view().entries for _, tier in pods}
    assert tiers == {(1, "gpu"), (2, "gpu"), (3, "cpu")}
