"""The port's federated region tier against the JAX package's.

- Every test of tests/test_federation.py but those that need the service
  surfaces the port does not carry (`WAITS`) runs on both packages
  (`own_cases` / `run_own_case` of tests/test_torch_cluster.py): the digest
  codec, the sketch export and merge, the single-region bit identity over
  the index backends and the ClusterScorer front, the region pick, the
  failover tracker and the cross-region warm.
- A region digest built from the same seeded routes and stores is byte-equal
  in the two packages, and each package decodes the other's.
- chip_smoke.py phase 17b at CPU width: two regions of two pods, one of them
  lost at `loss_at`, over the geo trace cut to its first requests.
"""

import importlib
import random

import pytest

from tests.test_torch_cluster import (  # noqa: F401 - one_thread is a fixture
    every_test,
    one_thread,
    own_case_id,
    own_cases,
    run_own_case,
    waiting,
)
from tests.test_torch_fleethealth import JAX_PKG, PACKAGES, PKG_IDS, PORT_PKG

WAITS = {
    "TestFederationHttp": "api.http_service's /federation surfaces (ROADMAP.md queue 1 item 7)",
    "TestGrpcCrossRegion": "api.grpc_server and the gRPC cross-region transport (ROADMAP.md "
                           "queue 1 item 7)",
}
CASES = own_cases("test_federation.py", WAITS)


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", CASES, ids=own_case_id)
def test_federation_case_on_both_packages(case, pkg, request):
    run_own_case("test_federation.py", case, pkg, request)


def test_every_federation_case_is_taken():
    every = every_test("test_federation.py")
    assert {(c, m) for c, m, _ in CASES} == every - waiting("test_federation.py", WAITS)
    assert (len(every), len(waiting("test_federation.py", WAITS))) == (25, 3)


# -- digest bytes across the two packages ---------------------------------------


def seeded_digest(pkg, seed, now=50.0):
    """A popularity tracker fed seeded routes (with token prefixes and
    adapters) and stores on a fixed clock, digested at `now`."""
    pop = importlib.import_module(f"{pkg}.placement.popularity")
    fed = importlib.import_module(f"{pkg}.federation")
    rng = random.Random(seed)
    t = [0.0]
    tracker = pop.ChainPopularityTracker(pop.PopularityConfig(
        sketch_width=128, sketch_depth=4, top_k=8, half_life_s=30.0), clock=lambda: t[0])
    heads = [[rng.randrange(1, 2**64) for _ in range(rng.randint(1, 6))] for _ in range(12)]
    for step in range(200):
        t[0] = step * 0.25
        chain = rng.choice(heads)
        if rng.random() < 0.7:
            tracker.observe_route(chain, tokens=list(range(4 * len(chain))), block_size=4,
                                  model_name="m", lora_id=rng.choice([None, 3]))
        else:
            tracker.observe_store(chain[: rng.randint(1, len(chain))])
    digest = fed.build_digest("region-a", tracker, seq=7, pods=2, load=0.375, hot_k=6,
                              max_prefix_blocks=4, now=now)
    return fed, digest, fed.encode_digest(digest)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_digest_bytes_equal_and_decode_across_packages(seed):
    jax_fed, jax_digest, jax_bytes = seeded_digest(JAX_PKG, seed)
    port_fed, port_digest, port_bytes = seeded_digest(PORT_PKG, seed)
    assert port_bytes == jax_bytes
    assert port_digest.hot_chains, "the seeded routes make hot chains"
    for fed, data in ((port_fed, jax_bytes), (jax_fed, port_bytes)):
        back = fed.decode_digest(data)
        assert fed.encode_digest(back) == data
        probe = [c.head for c in port_digest.hot_chains]
        assert back.affinity(probe, 4) == port_fed.decode_digest(port_bytes).affinity(probe, 4)
    with pytest.raises(port_fed.DigestFormatError):
        port_fed.decode_digest(jax_bytes[:-3])


# -- chip_smoke.py phase 17b at CPU width ----------------------------------------


def test_phase_17b_rehearses_the_lost_region(one_thread):  # noqa: F811
    """Phase 17b's two regions of two pods on the flagship's vocabulary at
    CPU width: the lost region is suspect, then stale, exactly when its last
    digest is 8 and 12 s old, nothing is delegated to it after that, every
    failover goes to the rendezvous successor, every request's cached
    tokens are 16 x its pod's match_blocks, and the checked requests'
    greedy tokens equal a never-evicting pod of their region's."""
    import chip_smoke

    params, cfg = chip_smoke.small_model("cpu", seed=0, **chip_smoke.REHEARSAL_MODEL)
    requests, n_all = chip_smoke.geo_requests()
    assert len(requests) == chip_smoke.GEO_MAX_REQUESTS == n_all
    arm = chip_smoke.geo_arm(params, cfg, requests)
    assert arm["failures"] == []
    assert chip_smoke.geo_alone_failures(params, cfg, arm, requests) == []
    assert arm["detected"] == arm["last_lost_digest"] + 12.0
    assert arm["failovers"] >= 1 and arm["retried"] >= 1
    assert arm["counters"]["delegation_failures"] == arm["retried"]
    assert arm["lost_state"]["state"] == "stale"
    assert len(arm["alone_checked"]) == chip_smoke.GEO_ALONE


def test_phase_17b_bar_catches_a_tracker_that_never_demotes(one_thread):  # noqa: F811
    import chip_fault_check as fc
    import chip_smoke

    params, cfg = chip_smoke.small_model("cpu", seed=0, **chip_smoke.REHEARSAL_MODEL)
    requests, _ = chip_smoke.geo_requests()
    arm = chip_smoke.geo_arm(params, cfg, requests, tracker_cls=fc.NeverDemoteTracker)
    assert any("detected at" in f for f in arm["failures"])
