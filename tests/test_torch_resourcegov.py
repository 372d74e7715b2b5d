"""The port's resource governor, departure reaper and autopilot knobs against
the JAX package's, on the same inputs.

- Every test of tests/test_resourcegov.py runs on both packages
  (`reference_module`): the accountant, the governor's config, pressure state machine, shed ladder and
  restore, its budget knob, the reaper, each tracker's `forget_pod`, the
  transfer client's peer bounding and the shed/rewarm bit identity.
- tests/test_autopilot.py's `TestKnobs` and the admission gate's, the
  auditor's, the prediction scheduler's and the replicator's registered
  knobs, on both packages.
- A governor over the seeded fault stream of tests/test_torch_fleethealth.py
  (meters on the index, the chain memo, the prefix store, fleet health, load
  and anti-entropy; a budget a quarter of the accounted bytes; a pod leaving
  through a quarantine that the reaper fans out): the journal, `status()`,
  the reaper's status and the index contents must be exactly equal, on every
  backend.
"""

import importlib
import random

import pytest

from tests.test_torch_fleethealth import (
    BACKEND_IDS,
    BACKEND_NAMES,
    JAX_PKG,
    MODEL,
    PACKAGES,
    PAGE,
    PKG_IDS,
    PORT_PKG,
    SHORT_TICKS,
    case_id,
    index_set,
    reference_cases,
    reference_module,
    resilience_run,
    run_reference_case,
)

pytestmark = pytest.mark.resourcegov

# Cases of tests/test_resourcegov.py that need a module the port lacks.
WAITS = {}
CASES = reference_cases("test_resourcegov.py", WAITS)


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_resourcegov_case_on_both_packages(case, pkg, request):
    run_reference_case("test_resourcegov.py", case, pkg, request)


def test_every_governor_case_is_taken():
    ns = reference_module("test_resourcegov.py", JAX_PKG)
    every = {(c, m) for c, cls in vars(ns).items() if c.startswith("Test")
             for m in vars(cls) if m.startswith("test_")}
    waiting = {(c, m) for c, m in every
               if c in WAITS or f"{c}::{m}" in WAITS}
    assert {(c, m) for c, m, _ in CASES} == every - waiting
    assert len(waiting) == 0


# tests/test_autopilot.py: the knob registry and the admission gate's, the
# auditor's, the prediction scheduler's and the replicator's registered
# knobs. The controller, the signal assembler, the burn history and the
# healthy bit identity, and the service wiring, run in
# tests/test_torch_autopilot.py.
REGISTERED_KNOBS = ("test_admission_knob_widens_the_live_waiting_line",
                    "test_auditor_knob_tightens_the_live_cadence",
                    "test_prediction_jobs_floor_is_one_not_zero",
                    "test_replicator_registers_both_placement_knobs")
KNOB_CASES = [c for c in reference_cases("test_autopilot.py", {})
              if c[0] == "TestKnobs"
              or (c[0] == "TestRegisteredKnobs" and c[1] in REGISTERED_KNOBS)]


@pytest.mark.autopilot
@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", KNOB_CASES, ids=case_id)
def test_knob_case_on_both_packages(case, pkg, request):
    run_reference_case("test_autopilot.py", case, pkg, request)


def test_knob_cases_taken():
    assert len(KNOB_CASES) == 10


# -- a governor over the seeded fault stream -----------------------------------

LEAVER = "pod-2"


def _fill_caches(pkg, seed):
    """A token processor's chain memo and an LRU prefix store of package
    `pkg`, each holding a few hundred seeded entries (what a scoring front
    end had memoized)."""
    lru_mod = importlib.import_module(f"{pkg}.tokenization.prefixstore.lru_store")
    tp_mod = importlib.import_module(f"{pkg}.kvcache.kvblock.token_processor")
    rng = random.Random(seed)
    tp = tp_mod.ChunkedTokenDatabase(tp_mod.TokenProcessorConfig(block_size=PAGE))
    store = lru_mod.LRUTokenStore(lru_mod.LRUStoreConfig(block_size=16))
    for _ in range(200):
        tokens = [rng.randrange(500) for _ in range(rng.randint(9, 24) * PAGE)]
        tp.tokens_to_kv_block_keys(None, tokens, MODEL)
        words = [f"t{t:03d}" for t in tokens]
        store.add_tokenization(" ".join(words), tokens,
                               [(5 * i, 5 * i + 4) for i in range(len(tokens))])
    assert tp.chain_memo.entries() > 0 and store.entries() > 0
    return tp.chain_memo, store


def governor_run(pkg, backend_name, seed, ticks=14):
    """The fault stream with a governor and a reaper wired as the reference
    service wires them (`fleet_health.on_departed = reaper.reap`), ticked at
    the end of every tick; the governor's budget a quarter of the first
    tick's accounted bytes; `LEAVER` quarantined (it left) at tick 5."""
    state = {}

    def hook(p, parts, t):
        rg = p.rg
        if t == 0:
            memo, store = _fill_caches(p.name, seed)
            load = p.load.PodLoadTracker(clock=parts.clock)
            for pod in parts.sims:
                load.report(pod, queue_depth=1, inflight=1, busy_until=parts.clock.t + 1.0)
            reaper = rg.DepartureReaper(clock=parts.clock)
            reaper.register("fleethealth", parts.tracker.forget_pod)
            reaper.register("load", load.forget_pod)
            reaper.register("antientropy", parts.trust.forget_pod)
            parts.tracker.on_departed = reaper.reap
            acc = rg.ResourceAccountant()
            index = parts.index
            acc.register(rg.Meter(rg.STRUCT_INDEX, lambda: len(index.export_view().entries),
                                  bytes_per_entry=1024.0, shed=getattr(index, "shed", None)))
            acc.register(rg.Meter(rg.STRUCT_CHAIN_MEMO, memo.entries, bytes_per_entry=256.0,
                                  shed=memo.shed))
            acc.register(rg.Meter(rg.STRUCT_PREFIX_STORE, store.entries,
                                  bytes_per_entry=4096.0, shed=store.shed))
            acc.register(rg.Meter(rg.STRUCT_FLEETHEALTH, parts.tracker.entries,
                                  bytes_per_entry=512.0))
            acc.register(rg.Meter(rg.STRUCT_LOAD, load.entries, bytes_per_entry=256.0))
            acc.register(rg.Meter(rg.STRUCT_ANTIENTROPY, parts.trust.entries,
                                  bytes_per_entry=256.0))
            budget_mb = acc.total_bytes() / 4 / (1024.0 * 1024.0)
            gov = rg.ResourceGovernor(acc, rg.ResourceGovConfig(
                budget_mb=budget_mb, min_interval_s=0.0, cooldown_s=1.0), clock=parts.clock)
            state.update(memo=memo, store=store, load=load, reaper=reaper, acc=acc, gov=gov)
        if t == 5:
            state["quarantined"] = parts.tracker.quarantine(LEAVER)
            state["rows_after_reap"] = dict(fleethealth=parts.tracker.entries(),
                                            load=state["load"].entries(),
                                            antientropy=parts.trust.entries())
        state.setdefault("ticks", []).append(state["gov"].tick(parts.clock.t))

    readings, parts = resilience_run(pkg, backend_name, seed, ticks=ticks, hooks=hook)
    gov = state["gov"]
    readings.update(journal=gov.journal(), gov_status=gov.status(), ticks=state["ticks"],
                    reaper=state["reaper"].status(), quarantined=state["quarantined"],
                    rows_after_reap=state["rows_after_reap"], index_after=index_set(parts.index))
    return readings, parts, state


@pytest.mark.parametrize("backend_name", BACKEND_NAMES, ids=BACKEND_IDS)
def test_governor_over_the_fault_stream_matches_jax(backend_name):
    ticks = SHORT_TICKS if backend_name == "redis" else 14
    jax, _, _ = governor_run(JAX_PKG, backend_name, seed=5, ticks=ticks)
    port, _, state = governor_run(PORT_PKG, backend_name, seed=5, ticks=ticks)
    for key in jax:
        assert port[key] == jax[key], key
    gov = state["gov"]
    assert port["gov_status"]["accounted_bytes"] <= gov.budget_bytes
    sheds = [e for e in port["journal"] if e[1] == "shed"]
    assert sheds, "a quarter budget must shed"
    order = [r.structure for r in gov.ladder]
    by_time = {}
    for e in sheds:
        by_time.setdefault(e[0], []).append(order.index(e[2]))
    assert all(ix == sorted(ix) for ix in by_time.values())
    # The leaver's rows went with it: every per-pod map lost the rows of the
    # pods reaped by then (the two stale quarantines and the leaver).
    reaped = {pod for t, pod, _ in port["reaper"]["recent"] if t <= 5.0}
    assert LEAVER in reaped
    assert port["rows_after_reap"] == dict(fleethealth=4 - len(reaped), load=4 - len(reaped),
                                           antientropy=4 - len(reaped))
