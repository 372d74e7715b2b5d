"""The port's prediction plane against the JAX package's, on the same inputs.

- Every test of tests/test_prediction.py but those that need code the port
  does not carry (`WAITS`) runs on both packages (`reference_module`): the
  session table's identity, ETA model, bounds and misprediction counts, the
  prefetch scheduler's budgets, the read path's bit identity with a table
  attached, serving winning over a warm admission (the port's pods get a
  small f32 model, as they always compute) and the prefetcher's per-source
  counters.
- tests/test_torch_placement.py's seeded proactive stream at another seed,
  on every index backend: session ETAs, the scheduler's jobs in order and
  its counters equal on both packages.
- Sessions observed through each package's Indexer seam (`prediction=` on
  get_pod_scores_ex, the fixture tokenizer): equal tables, and the fleet
  prior from the committed tables.
- chip_smoke.py phase 16c's arms at CPU parameters: observe-only serves
  exactly as prediction off, the scenario evicts s0's prefix when off, and
  anticipation leaves more of it resident before its next turn.
"""

import importlib

import pytest

from tests.test_torch_fleethealth import (
    BACKEND_IDS,
    BACKEND_NAMES,
    JAX_PKG,
    PACKAGES,
    PKG_IDS,
    PORT_PKG,
    case_id,
    reference_cases,
    reference_module,
    run_reference_case,
)
from tests.test_torch_placement import (  # noqa: F401 (fixtures)
    rehearsal_model,
    small_model_pods,
    stream_matches,
    transfer_library,
)

# Cases of tests/test_prediction.py that need code the port does not carry.
WAITS = {
    "TestPredictionEndToEnd": "bench.py's FleetSim, the benchmark's own code, which is not ported "
                              "(test_phase_16c_arms_rehearse_the_end_to_end_claims makes its "
                              "claims on the port's pods)",
}
CASES = reference_cases("test_prediction.py", WAITS)


@pytest.mark.parametrize("pkg", PACKAGES, ids=PKG_IDS)
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_prediction_case_on_both_packages(case, pkg, request):
    if case[0] == "TestServingWins" and pkg == PORT_PKG:
        small_model_pods(request.getfixturevalue("monkeypatch"))
    run_reference_case("test_prediction.py", case, pkg, request)


def test_every_prediction_case_is_taken():
    ns = reference_module("test_prediction.py", JAX_PKG)
    every = {(c, m) for c, cls in vars(ns).items() if c.startswith("Test")
             for m in vars(cls) if m.startswith("test_")}
    waiting = {(c, m) for c, m in every if c in WAITS or f"{c}::{m}" in WAITS}
    assert {(c, m) for c, m, _ in CASES} == every - waiting
    assert len(waiting) == 2


def test_port_namespace_runs_the_port():
    ns = reference_module("test_prediction.py", PORT_PKG)
    for name in ("SessionTable", "PrefetchScheduler", "PredictionConfig", "SchedulerConfig",
                 "best_score_select", "fleet_prior_from_tables", "Indexer"):
        assert getattr(ns, name).__module__.startswith(PORT_PKG + "."), name


@pytest.mark.parametrize("backend_name", BACKEND_NAMES, ids=BACKEND_IDS)
def test_prediction_stream_matches_jax(backend_name):
    port = stream_matches(backend_name, seed=8)
    jobs = [j for j in port["jobs"] if j[0] == "prediction"]
    assert jobs and any(port["etas"])
    stats = port["scheduler"]["stats"]
    assert stats["jobs_submitted"] == len(jobs)
    table = port["stats"][-1][1]
    assert table["continuations"] > 0 and table["new_sessions"] > 0


def _seam_readings(pkg):
    """Prompts of three growing sessions (two on one system prefix) scored
    through package `pkg`'s Indexer with a SessionTable on its
    `prediction=` seam, on a fake clock: the table's snapshot and stats
    after each, and the scores (the seam must not touch them)."""
    from tests.conftest import TEST_MODEL_NAME, TEST_TOKENIZER_JSON

    ix = importlib.import_module(f"{pkg}.kvcache.indexer")
    tp = importlib.import_module(f"{pkg}.kvcache.kvblock.token_processor")
    tpool = importlib.import_module(f"{pkg}.tokenization.pool")
    pr = importlib.import_module(f"{pkg}.prediction")
    clock = [0.0]
    table = pr.SessionTable(pr.PredictionConfig(tail_trim_blocks=1, default_eta_s=4.0),
                            clock=lambda: clock[0])
    indexer = ix.Indexer(
        ix.IndexerConfig(token_processor_config=tp.TokenProcessorConfig(block_size=4)),
        tokenization_pool=tpool.TokenizationPool(tpool.TokenizersPoolConfig(
            workers=1, local_tokenizer_files={TEST_MODEL_NAME: TEST_TOKENIZER_JSON})),
        prediction=table)
    indexer.run()
    base = "the quick brown fox jumps over the lazy dog " * 3
    sessions = {"a": base + "alpha", "b": base + "bravo", "c": "lorem ipsum dolor sit amet " * 4}
    out = []
    try:
        for step in range(9):
            clock[0] = 1.5 * step
            name = "abc"[step % 3]
            sessions[name] += f" turn {step} more words here"
            ps = indexer.get_pod_scores_ex(sessions[name], TEST_MODEL_NAME, [])
            out.append((dict(ps.scores), table.snapshot(now=clock[0]), table.stats(),
                        table.fleet_eta_s()))
    finally:
        indexer.shutdown()
    return out, [pr.fleet_prior_from_tables(6.0, 0.01, q) for q in (0.0, 0.3, 0.5, 0.9, 1.0)]


def test_indexer_seam_sessions_match_jax():
    jax, port = _seam_readings(JAX_PKG), _seam_readings(PORT_PKG)
    assert port == jax
    steps, prior = port
    assert steps[-1][2]["continuations"] >= 6 and steps[-1][2]["new_sessions"] == 3
    assert prior == sorted(prior) and prior[0] >= 6.0


def test_phase_16c_arms_rehearse_the_end_to_end_claims(rehearsal_model, transfer_library):
    """tests/test_prediction.py's end-to-end claims on the port's pods at CPU
    width: observe-only serves exactly as prediction off; off, the junk
    churn evicts s0's prefix before its next turn; on, the scheduler
    pre-lands blocks and more of the prefix is resident; turn 1's tokens
    are a never-evicting pod's in every arm. The card runs the same arms."""
    import chip_smoke

    params, cfg = rehearsal_model
    requests = chip_smoke.prediction_requests()
    arms = {name: chip_smoke.prediction_arm(params, cfg, requests, p)
            for name, p in chip_smoke.PREDICTION_ARMS.items()}
    tok = chip_smoke.TextTokenizer(cfg.vocab_size)
    want = chip_smoke.never_evicting_tokens(
        params, cfg, [tok.encode(r.prompt, "").tokens for r in requests
                      if r.session == chip_smoke.PREDICTION_SESSION], [1])[0]
    assert [f for arm in arms.values() for f in arm["failures"]] == []
    assert chip_smoke.prediction_bars(arms, want) == []
    off, on = arms["off"]["audit"], arms["on"]["audit"]
    assert off["resident"] < off["prefix_blocks"] and on["resident"] > off["resident"]
    assert arms["on"]["predicted_landed_blocks"] > 0
    assert arms["on"]["prefetcher"]["by_source"]["prediction"]["executed"] > 0
