"""The port's SLO monitor and autopilot against the JAX package's.

- Every test of tests/test_slo.py runs on both packages: the burn
  arithmetic, the multi-window states, the baseline at the monitor's birth,
  the bounded ring, the config's validation, the shipped objectives over
  each package's metrics registry and the HTTP surfaces.
- Every class of tests/test_autopilot.py but the knob classes (run by
  tests/test_torch_resourcegov.py, `WAITS`) runs on both packages: the
  signal assembler, the burn history, the controller's rules, warm-up,
  cooldown, decay and journal, the admission gate's dynamic Retry-After, the
  healthy bit identity and the service wiring.
- chip_smoke.py phase 17d at CPU width: phase 15a's no-fault arm with an
  autopilot attached, and the fourth arm (the plan, the plane and the
  autopilot).
"""

import pytest

from tests.test_torch_cluster import (  # noqa: F401 - one_thread is a fixture
    every_test,
    one_thread,
    own_case_id,
    own_cases,
    run_own_case,
    waiting,
)
from tests.test_torch_fleethealth import PACKAGES, PKG_IDS

pytestmark = pytest.mark.autopilot

SLO_WAITS = {}
# TestKnobs and TestRegisteredKnobs run in tests/test_torch_resourcegov.py.
WAITS = {
    "TestKnobs": "tests/test_torch_resourcegov.py",
    "TestRegisteredKnobs": "tests/test_torch_resourcegov.py",
}
SLO_CASES = own_cases("test_slo.py", SLO_WAITS)
CASES = own_cases("test_autopilot.py", WAITS)


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", SLO_CASES, ids=own_case_id)
def test_slo_case_on_both_packages(case, pkg, request):
    run_own_case("test_slo.py", case, pkg, request)


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", CASES, ids=own_case_id)
def test_autopilot_case_on_both_packages(case, pkg, request):
    run_own_case("test_autopilot.py", case, pkg, request)


def test_every_autopilot_case_is_taken():
    for test_file, waits, cases, counts in (
            ("test_slo.py", SLO_WAITS, SLO_CASES, (13, 0)),
            ("test_autopilot.py", WAITS, CASES, (36, 10))):
        every = every_test(test_file)
        assert {(c, m) for c, m, _ in cases} == every - waiting(test_file, waits)
        assert (len(every), len(waiting(test_file, waits))) == counts
    assert {c for c, _, _ in SLO_CASES} == {"TestBurnMath", "TestRegistryObjectives",
                                             "TestSloHttpSurface"}
    assert len(SLO_CASES) == 13


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
def test_slo_config_validation(pkg):
    """TestBurnMath::test_config_validation's checks, the duplicate names
    made of hand-made objectives; `default_objectives` builds the shipped
    set, one objective per name of `SLO_OBJECTIVES`."""
    import importlib

    slo = importlib.import_module(f"{pkg}.obs.slo")
    with pytest.raises(ValueError):
        slo.SLOConfig(fast_window_s=600, slow_window_s=60)
    with pytest.raises(ValueError):
        slo.SLOConfig(burn_threshold=0)
    with pytest.raises(ValueError):
        slo.SLOConfig(hit_rate_floor=1.5)
    with pytest.raises(ValueError):
        slo.SLOConfig(read_latency_budget=0.0)
    objectives = [slo.SLOObjective(name=name, description="", budget=0.1,
                                   counts_fn=lambda: (0.0, 0.0))
                  for name in slo.SLO_OBJECTIVES]
    with pytest.raises(ValueError, match="duplicate"):
        slo.SLOMonitor(objectives + objectives[:1], slo.SLOConfig())
    assert slo.SLOMonitor(objectives, slo.SLOConfig()).evaluate(0.0)["status"] == slo.STATUS_OK
    shipped = slo.default_objectives(slo.SLOConfig())
    assert tuple(o.name for o in shipped) == tuple(slo.SLO_OBJECTIVES)


# -- chip_smoke.py phase 17d at CPU width ----------------------------------------


def test_phase_17d_rehearses_the_autopilot_arms(one_thread):  # noqa: F811
    """Phase 15a's no-fault arm with and without the autopilot, and the plan
    with the plane and the autopilot, on the flagship's vocabulary at CPU
    width: healthy, nothing moves and every score, route, cached and greedy
    token is the same; under the plan the audit-cadence knob is nudged down
    within its bounds, journaled and walked back to its baseline, and 15a's
    bars hold."""
    import chip_smoke

    params, cfg = chip_smoke.small_model("cpu", seed=0, **chip_smoke.REHEARSAL_MODEL)
    waves = chip_smoke.multitenant_traffic(0, cfg.vocab_size, chip_smoke.RESILIENCE_WAVES)
    bare = chip_smoke.resilience_arm(params, cfg, waves, dict(seed=0, pods={}), True)
    with_it = chip_smoke.resilience_arm(params, cfg, waves, dict(seed=0, pods={}), True,
                                        autopilot=chip_smoke.AutopilotController)
    assert bare["failures"] == [] and with_it["failures"] == []
    out = chip_smoke.autopilot_arms(params, cfg, waves, with_it, bare)
    assert out["failures"] == [] and out["compared_to_bare"]
    healthy = out["healthy"]
    plan = out["arms"]["faults_plane_autopilot"]["autopilot"]
    assert healthy["actuations"] == 0 and healthy["counts"][0] == 0
    assert plan["actuations"] == len(plan["journal"]) > plan["reverts"] > 0
    assert [e[3] for e in plan["journal"]] == ["down"] * (plan["actuations"] - plan["reverts"]) \
        + ["revert"] * plan["reverts"]
    assert plan["final"] == plan["baseline"]


def test_phase_17d_bar_catches_a_controller_past_the_ceiling(one_thread):  # noqa: F811
    import chip_fault_check as fc
    import chip_smoke

    params, cfg = chip_smoke.small_model("cpu", seed=0, **chip_smoke.REHEARSAL_MODEL)
    waves = chip_smoke.multitenant_traffic(0, cfg.vocab_size, chip_smoke.RESILIENCE_WAVES)
    r = chip_smoke.resilience_arm(params, cfg, waves, chip_smoke.RESILIENCE_PLAN, True,
                                  autopilot=fc.PastCeilingController)
    assert any("bounds" in f or "outside" in f for f in r["failures"])
