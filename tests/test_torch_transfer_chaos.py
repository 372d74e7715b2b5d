"""The port's transfer-plane chaos injector against the JAX package's.

- Every test of tests/test_transfer_chaos.py runs on both packages
  (`own_cases` / `run_own_case` of tests/test_torch_cluster.py): the peer
  breaker, the client's breaker and integrity accounting, hedged fetches,
  `FaultyTransport`'s corruption, stall, blackhole and flap windows, the
  fleet-health feed and the status surfaces. The port's build of
  `kv_transfer.cpp` is built once and lent to the JAX package's connector
  (`transfer_library`), whose own copy stays unbuilt.
- The seeded corruption draw picks the same blocks in both packages.
- chip_smoke.py phase 17c at CPU width: phase 8's peer onboard with the
  onboarding pod's client wrapped in `FaultyTransport` (corrupt with
  integrity on and off, stall), on bf16-shaped (f32 here) and int8 pages.
"""

import importlib

import pytest

from tests.test_torch_cluster import (  # noqa: F401 - one_thread is a fixture
    every_test,
    one_thread,
    own_case_id,
    own_cases,
    run_own_case,
)
from tests.test_torch_fleethealth import JAX_PKG, PACKAGES, PKG_IDS, PORT_PKG
from tests.test_torch_placement import transfer_library  # noqa: F401 - a fixture

CASES = own_cases("test_transfer_chaos.py", {})


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", CASES, ids=own_case_id)
def test_transfer_chaos_case_on_both_packages(case, pkg, request, transfer_library):  # noqa: F811
    run_own_case("test_transfer_chaos.py", case, pkg, request)


def test_every_transfer_chaos_case_is_taken():
    assert {(c, m) for c, m, _ in CASES} == every_test("test_transfer_chaos.py")
    assert len(CASES) == 28


def test_seeded_corruption_draw_is_the_same_blocks():
    picked = {}
    for pkg in PACKAGES:
        faults = importlib.import_module(f"{pkg}.kv_connectors.faults")
        ft = faults.FaultyTransport(None, faults.TransferFaultPlan(seed=23), clock=lambda: 0.0)
        picked[pkg] = [h for h in range(4096) if ft._block_corrupted(h * 0x9E3779B97F4A7C15 %
                                                                      2**64, 0.125)]
    assert picked[PORT_PKG] == picked[JAX_PKG]
    assert 400 < len(picked[PORT_PKG]) < 640


# -- chip_smoke.py phase 17c at CPU width ----------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["f32-pages", "int8-pages"])
def test_phase_17c_rehearses_the_chaos_onboard(int8, one_thread):  # noqa: F811
    """Phase 17c's three arms on the flagship's vocabulary at CPU width: the
    damaged blocks are the seeded draw's, detected and recomputed (P' equals
    the never-evicting pod), admitted with integrity off, and the stalled
    peer's breaker opens after the threshold and skips uncharged."""
    import chip_smoke

    params, cfg = chip_smoke.small_model("cpu", seed=0, **chip_smoke.REHEARSAL_MODEL)
    out = chip_smoke.chaos_check(params, cfg, int8)
    assert out["failures"] == []
    corrupt = out["arms"]["corrupt"]
    assert corrupt["cached"] == chip_smoke.PAGE * out["cut"] == chip_smoke.PAGE * \
        out["damaged_indices"][0]
    assert corrupt["counters"]["corrupt_admitted"] == 0
    assert corrupt["damaged_blocks"] == len(out["damaged_indices"])
    off = out["arms"]["corrupt_integrity_off"]
    assert off["counters"]["corrupt_admitted"] == len(out["damaged_indices"])
    stall = out["arms"]["stall"]
    assert stall["breaker"] == "open" and all(stall["equal"])
    assert stall["counters"]["breaker_skipped_fetches"] == \
        chip_smoke.CHAOS_STALL_REQUESTS - chip_smoke.CHAOS_BREAKER


def test_phase_17c_bar_catches_a_transport_that_admits_damage(one_thread):  # noqa: F811
    import chip_fault_check as fc
    import chip_smoke

    params, cfg = chip_smoke.small_model("cpu", seed=0, **chip_smoke.REHEARSAL_MODEL)
    out = chip_smoke.chaos_check(params, cfg, False, transport_cls=fc.AdmittingTransport)
    assert any(f.startswith("corrupt:") for f in out["failures"])
