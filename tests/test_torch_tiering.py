"""The port's host tier against the JAX package's, with no transfer library.

- the device page codec: extract/insert round trips on both page formats,
  and the cross-package landing test (a block extracted by a JAX pod lands
  in a port pod and the reverse: the next decode step's logits agree within
  the port's logits tolerance, and re-extracting gives the other package's
  bytes back);
- the block manager's tier hooks, driven with the same fake hooks on both
  packages' BlockManager: the same hook calls, events and pages;
- TieredKVStore under the same fake connector and counting codec on both
  packages: the same fetches, insert waves and stats;
- IndexBackedPeerResolver over each package's index;
- the transfer cost model against the JAX one at fixed rates.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import CFG, _PodPair

from llm_d_kv_cache_manager_tpu.engine import block_manager as jax_bm
from llm_d_kv_cache_manager_tpu.engine import costs as jax_costs
from llm_d_kv_cache_manager_tpu.engine import tiering as jax_tiering
from llm_d_kv_cache_manager_tpu.engine.engine import _DevicePageCodec as JaxCodec
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import in_memory as jax_in_memory
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import key as jax_key
from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu_torch.engine import block_manager as port_bm
from llm_d_kv_cache_manager_tpu_torch.engine import costs as port_costs
from llm_d_kv_cache_manager_tpu_torch.engine import tiering as port_tiering
from llm_d_kv_cache_manager_tpu_torch.engine.engine import (
    EnginePod,
    EnginePodConfig,
    _DevicePageCodec,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import in_memory as port_in_memory
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock import key as port_key
from llm_d_kv_cache_manager_tpu_torch.models import llama

LOGITS_TOL = dict(atol=1e-4, rtol=0)  # tests/test_torch_llama.py
PAGE = 4

# The two packages' modules, side by side.
JAX = dict(bm=jax_bm, tiering=jax_tiering, costs=jax_costs, index=jax_in_memory, key=jax_key)
PORT = dict(bm=port_bm, tiering=port_tiering, costs=port_costs, index=port_in_memory,
            key=port_key)


def _rows(batches):
    return [tuple(e.to_tagged_union()) for b in batches for e in b.events]


# -- the device page codec ------------------------------------------------------


def _port_pod(int8=False, n_pages=8):
    cfg = llama.LlamaConfig(**CFG, dtype=torch.float32)
    return EnginePod(EnginePodConfig(n_pages=n_pages, page_size=PAGE, device="cpu",
                                     model_config=cfg, use_quantized_kv=int8,
                                     max_pages_per_seq=8))


def _manual_payload(pod, page_id):
    return b"".join(
        c[:, :, page_id].contiguous().view(torch.uint8).numpy().tobytes() for c in pod.kv_cache)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_codec_extract_matches_manual_page_bytes(int8):
    pod = _port_pod(int8)
    state, _ = pod.prefill(list(range(12)))
    codec = _DevicePageCodec(pod)
    payloads = codec.extract_many(state.block_table[:3])
    for page_id, payload in zip(state.block_table[:3], payloads):
        assert payload == _manual_payload(pod, page_id)
        assert len(payload) == codec.page_nbytes
    assert codec.page_nbytes > 0 and any(any(p) for p in payloads)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_codec_insert_round_trips_in_place(int8):
    pod_a = _port_pod(int8)
    state, _ = pod_a.prefill(list(range(12)))
    payloads = _DevicePageCodec(pod_a).extract_many(state.block_table[:3])
    pod_b = _port_pod(int8)
    before = [id(c) for c in pod_b.kv_cache]
    codec_b = _DevicePageCodec(pod_b)
    codec_b.insert_many(list(zip([5, 1, 6], payloads)))  # 3 items: padded to 4
    assert [id(c) for c in pod_b.kv_cache] == before  # updated in place
    assert codec_b.extract_many([5, 1, 6]) == payloads
    # Pages not written stay zero.
    assert not any(_manual_payload(pod_b, p).strip(b"\0") for p in (0, 2, 3, 4, 7))


def test_codec_empty_single_and_bad_size():
    pod = _port_pod()
    codec = _DevicePageCodec(pod)
    assert codec.extract_many([]) == []
    codec.insert_many([])
    state, _ = pod.prefill(list(range(4)))
    pid = state.block_table[0]
    assert codec.extract(pid) == codec.extract_many([pid])[0]
    resolve = codec.extract_many_async([pid])
    assert resolve() == [codec.extract(pid)]
    with pytest.raises(ValueError, match="expected"):
        codec.insert_many([(0, b"short")])


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_codec_payload_size_matches_jax(int8):
    pair = _PodPair(n_pages=8, int8=int8)
    assert _DevicePageCodec(pair.port).page_nbytes == JaxCodec(pair.jax).page_nbytes


def _decode_logits(pod, state, token, is_jax):
    """The next decode step's logits at `token`, over `state`'s pages (the
    step writes its KV row into the pod's cache, as a decode step does)."""
    pos = len(state.tokens)
    table = pod._padded_table(state)[None]
    if is_jax:
        pod.kv_cache, logits = jax_llama.decode_step_cache(
            pod._model_config, pod.params, pod.kv_cache, jnp.asarray([token], jnp.int32),
            table, jnp.asarray([pos], jnp.int32))
        return np.asarray(logits[0], dtype=np.float32)
    _, logits = llama.decode_step_cache(
        pod._model_config, pod.params, pod.kv_cache, torch.tensor([token], dtype=torch.int32),
        table, torch.tensor([pos], dtype=torch.int32))
    return logits[0].numpy()


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("jax_to_port", [True, False], ids=["jax_to_port", "port_to_jax"])
def test_blocks_land_across_packages(int8, jax_to_port):
    """One package's pod extracts its pages of prompt A; they land in the
    other package's pod over its pages of prompt B. The next decode step
    over the landed pages equals the source pod's own within the logits
    tolerance, and re-extracting the landed pages gives the source's
    payload back byte for byte."""
    pair = _PodPair(n_pages=16, max_pages_per_seq=8, int8=int8)
    rng = np.random.default_rng(5)
    prompt_a, prompt_b = (rng.integers(0, CFG["vocab_size"], 18).tolist() for _ in range(2))
    n_pages = -(-len(prompt_a) // PAGE)  # 5, the last one partial
    ends = [(pair.jax, JaxCodec(pair.jax), True), (pair.port, _DevicePageCodec(pair.port), False)]
    (src_pod, src_codec, src_jax), (dst_pod, dst_codec, dst_jax) = (
        ends if jax_to_port else ends[::-1])
    src_state, _ = src_pod.prefill(prompt_a)
    dst_state, _ = dst_pod.prefill(prompt_b)
    src_pages = src_state.block_table[:n_pages]
    dst_pages = dst_state.block_table[:n_pages]
    payloads = src_codec.extract_many(src_pages)
    assert {len(p) for p in payloads} == {dst_codec.page_nbytes}
    token = 7
    # Before the landing, prompt B's own KV gives other logits.
    own = _decode_logits(dst_pod, dst_state, token, dst_jax)
    dst_codec.insert_many(list(zip(dst_pages, payloads)))
    assert dst_codec.extract_many(dst_pages) == payloads
    want = _decode_logits(src_pod, src_state, token, src_jax)
    got = _decode_logits(dst_pod, dst_state, token, dst_jax)
    np.testing.assert_allclose(got, want, **LOGITS_TOL)
    assert np.abs(own - want).max() > 1e-2


# -- the block manager's tier hooks ----------------------------------------------


def _bm(pkg, n_pages, events=None, **hooks):
    m = pkg["bm"]
    return m.BlockManager(m.BlockManagerConfig(n_pages=n_pages, page_size=PAGE,
                                               device_tier="gpu"),
                          event_sink=events.append if events is not None else None, **hooks)


def _scenario_take_atomic(pkg, log, events):
    bm = _bm(pkg, 4, events)
    s1 = bm.allocate(list(range(12)))
    free_before = bm.num_free_pages
    with pytest.raises(pkg["bm"].OutOfPagesError):
        bm._take_free_pages(2)
    log.append((free_before, bm.num_free_pages, len(bm._take_free_pages(1))))
    bm.free(s1)


def _scenario_batched_reclaim(pkg, log, events):
    bm = _bm(pkg, 4, events, reclaim_many_hook=lambda blocks: log.append(list(blocks)))
    s1 = bm.allocate(list(range(16)))
    bm.commit_prefill(s1)
    bm.free(s1)
    s2 = bm.allocate([99] * 12)  # one 3-victim wave
    log.append(s2.block_table)


def _scenario_single_hook(pkg, log, events):
    bm = _bm(pkg, 4, events, reclaim_hook=lambda *a: log.append(a))
    s1 = bm.allocate(list(range(16)), lora_id=3)
    bm.commit_prefill(s1)
    bm.free(s1)
    bm.allocate([99] * 8)


def _scenario_chain_restore(pkg, log, events):
    def loader(blocks, take_pages):
        log.append(list(blocks))
        return take_pages(len(blocks))

    bm = _bm(pkg, 8, events, chain_planner=lambda h: len(h), chain_loader=loader)
    s = bm.allocate(list(range(16)))
    s2 = bm.allocate(list(range(16)))  # a pure device hit: no loader call
    log.append((s.num_cached_tokens, s.block_table, s2.num_cached_tokens, s2.block_table))


def _scenario_partial_chain(pkg, log, events):
    calls = []

    def loader(blocks, take_pages):
        calls.append(len(blocks))
        return take_pages(1) if len(calls) == 1 else []

    bm = _bm(pkg, 8, events, chain_planner=lambda h: len(h), chain_loader=loader)
    free_before = bm.num_free_pages
    s = bm.allocate(list(range(16)))
    log.append((calls, s.num_cached_tokens, free_before - bm.num_free_pages, s.block_table))
    bm.free(s)


def _scenario_dry_fetch(pkg, log, events):
    bm = _bm(pkg, 4, events, chain_planner=lambda h: len(h),
             chain_loader=lambda blocks, take_pages: [])
    s1 = bm.allocate(list(range(16)))
    bm.commit_prefill(s1)
    bm.free(s1)
    cached_before = bm.num_cached_pages
    s2 = bm.allocate([500 + i for i in range(4)])
    log.append((cached_before, bm.num_cached_pages, s2.block_table))


def _scenario_resident_suffix(pkg, log, events):
    def loader(blocks, take_pages):
        log.append([b[0] for b in blocks])
        return take_pages(len(blocks))

    bm = _bm(pkg, 16, events, chain_planner=lambda h: len(h), chain_loader=loader)
    s1 = bm.allocate(list(range(16)))
    bm.free(s1)
    first = log[0][0]
    page_id = bm._hash_to_page.pop(first)  # an interior eviction of block 0
    bm._reclaimable.pop(page_id, None)
    bm._free_fresh.append(page_id)
    s2 = bm.allocate(list(range(16)))
    log.append((s2.num_cached_tokens, s2.block_table))


def _scenario_plan_zero_and_fault(pkg, log, events):
    bm = _bm(pkg, 8, events, chain_planner=lambda h: 0,
             chain_loader=lambda blocks, take_pages: log.append(blocks) or [])
    log.append(bm.allocate(list(range(16))).num_cached_tokens)

    def faulty(blocks, take_pages):
        take_pages(len(blocks))
        raise RuntimeError("device fault mid-insert")

    bm = _bm(pkg, 8, events, chain_planner=lambda h: len(h), chain_loader=faulty)
    free_before = bm.num_free_pages
    s = bm.allocate(list(range(16)))
    bm.free(s)
    log.append((s.num_cached_tokens, free_before, bm.num_free_pages))


def _scenario_clear_and_queries(pkg, log, events):
    bm = _bm(pkg, 8, events, reclaim_many_hook=lambda blocks: log.append(list(blocks)),
             chain_planner=lambda h: 0, chain_loader=lambda b, t: [])
    s = bm.allocate(list(range(10)), lora_id=2)
    bm.commit_prefill(s)
    log.append(list(bm.committed_blocks(s)))
    log.append((bm.cached_hashes(), bm.cached_hashes(1), bm.cached_hashes(0)))
    log.append([bm.is_cached(h) for h in bm.cached_hashes() + [12345]])
    hooks = (bm.reclaim_many_hook, bm.chain_planner, bm.chain_loader)
    bm.clear()
    log.append(hooks == (bm.reclaim_many_hook, bm.chain_planner, bm.chain_loader))
    log.append(bm.cached_hashes())


BM_SCENARIOS = [
    _scenario_take_atomic, _scenario_batched_reclaim, _scenario_single_hook,
    _scenario_chain_restore, _scenario_partial_chain, _scenario_dry_fetch,
    _scenario_resident_suffix, _scenario_plan_zero_and_fault, _scenario_clear_and_queries,
]


@pytest.mark.parametrize("scenario", BM_SCENARIOS, ids=lambda f: f.__name__[10:])
def test_block_manager_hooks_match_jax(scenario):
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        log, events = [], []
        scenario(pkg, log, events)
        out[name] = (log, _rows(events))
    assert out["port"] == out["jax"]
    assert out["port"][0]  # the scenario observed something


def test_block_manager_hook_scenarios_see_what_jax_tests_assert():
    """Spot checks of the shared scenarios against the JAX tests' own
    assertions (tests/test_data_plane_batch.py), on the port."""
    log, events = [], []
    _scenario_batched_reclaim(PORT, log, events)
    assert len(log[0]) == 3 and log[0][0][1] == list(range(4))
    log, events = [], []
    _scenario_partial_chain(PORT, log, events)
    assert log[0][:3] == ([4, 3], 4, 4)
    log, events = [], []
    _scenario_chain_restore(PORT, log, events)
    stored = [r for r in _rows(events) if r[0] == "BlockStored"]
    assert len(log) == 2 and len(log[0]) == 4 and log[1][0] == log[1][2] == 16
    assert len(stored) == 1 and len(stored[0][1]) == 4 and stored[0][2] is None


# -- TieredKVStore under fakes ----------------------------------------------------


class FakeConnector:
    """Dict-backed host store + a scripted peer; records batching shape."""

    def __init__(self, peer_blocks=None, hedged=False):
        self.store = {}
        self.peer_blocks = peer_blocks or {}
        self.calls = []
        if hedged:
            self.onboard_payloads_hedged = self._hedged

    def stage(self, block_hash, payload, token_ids, block_size, parent_hash=None, lora_id=None):
        self.calls.append(("stage", block_hash, list(token_ids), parent_hash, lora_id))
        self.store[block_hash] = payload

    def drop(self, block_hash):
        self.calls.append(("drop", block_hash))
        self.store.pop(block_hash, None)

    def fetch_staged(self, block_hash, max_size):
        self.calls.append(("staged", block_hash))
        return self.store.get(block_hash)

    def fetch_staged_many(self, block_hashes, max_size):
        self.calls.append(("staged_many", list(block_hashes)))
        return [self.store.get(h) for h in block_hashes]

    def onboard_payload(self, host, port, block_hash, max_size):
        self.calls.append(("peer", block_hash))
        return self.peer_blocks.get(block_hash)

    def onboard_payloads(self, host, port, block_hashes, max_size):
        self.calls.append(("peer_many", (host, port), list(block_hashes)))
        return [self.peer_blocks.get(h) for h in block_hashes]

    def _hedged(self, addrs, block_hashes, max_size):
        self.calls.append(("hedged", list(addrs), list(block_hashes)))
        return [self.peer_blocks.get(h) for h in block_hashes]


def counting_codec(base):
    class CountingCodec(base):
        """Payload = page id as bytes; counts dispatch shapes."""

        page_nbytes = 8

        def __init__(self):
            self.extract_calls, self.async_calls, self.insert_calls = [], [], []
            self.fail_async = False

        def extract_many(self, page_ids):
            self.extract_calls.append(len(page_ids))
            return [int(i).to_bytes(8, "little") for i in page_ids]

        def extract_many_async(self, page_ids):
            ids = list(page_ids)
            self.async_calls.append(len(ids))
            if self.fail_async:
                def boom():
                    raise RuntimeError("snapshot lost")
                return boom
            return lambda: [int(i).to_bytes(8, "little") for i in ids]

        def insert_many(self, items):
            self.insert_calls.append([(pid, p) for pid, p in items])

    return CountingCodec()


def _payload(i):
    return int(i).to_bytes(8, "little")


def _block(i):
    return (1000 + i, [i], None, i, None)


def _taker():
    taken = []

    def take_pages(k):
        got = list(range(len(taken), len(taken) + k))
        taken.extend(got)
        return got
    return take_pages


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


def _tier_stage_waves(pkg, log):
    codec, conn = counting_codec(pkg["tiering"].PageCodec), FakeConnector()
    for wave, n in ((16, 5), (4, 11)):
        store = pkg["tiering"].TieredKVStore(conn, codec, stage_wave_pages=wave)
        try:
            blocks = [_block(i) for i in range(n)]
            log.append((store._stage_many(blocks), store._stage_many(blocks)))
            log.append(dict(store.stats))
        finally:
            store.close()
    log.append((codec.extract_calls, codec.async_calls, sorted(conn.store.items())))


def _tier_peer_runs(pkg, log):
    peer = {1000 + i: _payload(i) for i in range(10)}
    peer.pop(1007)  # a hole cuts the chain
    for wave in (8, 4):
        codec, conn = counting_codec(pkg["tiering"].PageCodec), FakeConnector(peer)
        store = pkg["tiering"].TieredKVStore(conn, codec, peer_resolver=lambda h: ("p", 1),
                                             onboard_wave_blocks=wave, fetch_batch_blocks=3)
        try:
            landed = store.load_chain([(1000 + i, [i], None) for i in range(10)], _taker())
            log.append((landed, conn.calls, codec.insert_calls, dict(store.stats)))
        finally:
            store.close()


def _tier_mixed_sources(pkg, log):
    codec = counting_codec(pkg["tiering"].PageCodec)
    conn = FakeConnector(peer_blocks={1002: b"p2", 1003: b"p3"})
    store = pkg["tiering"].TieredKVStore(conn, codec, peer_resolver=lambda h: ("p", 1))
    try:
        conn.store[1001] = b"s1"
        with store._mu:
            store._staged[1001] = None
            store._ready[1000] = (b"r0", pkg["costs"].STAGED)
        landed = store.load_chain([(1000 + i, [i], None) for i in range(4)],
                                  lambda k: list(range(k)))
        log.append((landed, conn.calls, codec.insert_calls, dict(store.stats)))
    finally:
        store.close()


def _tier_hedged_candidates(pkg, log):
    class Resolver:
        def __call__(self, h):
            return ("a", 1)

        def candidates(self, h):
            return [("b", 2), ("a", 1), ("c", 3)]

    codec = counting_codec(pkg["tiering"].PageCodec)
    conn = FakeConnector(peer_blocks={1000 + i: _payload(i) for i in range(3)}, hedged=True)
    store = pkg["tiering"].TieredKVStore(conn, codec, peer_resolver=Resolver())
    try:
        landed = store.load_chain([(1000 + i, [i], None) for i in range(3)], _taker())
        log.append((landed, conn.calls, codec.insert_calls, dict(store.stats)))
    finally:
        store.close()


def _tier_prefetch(pkg, log):
    c = pkg["costs"]
    conn = FakeConnector(peer_blocks={1005: b"p5", 1006: b"p6"})
    for i in range(3):
        conn.store[1000 + i] = b"s%d" % i
    codec = counting_codec(pkg["tiering"].PageCodec)
    store = pkg["tiering"].TieredKVStore(conn, codec, peer_resolver=lambda h: ("p", 1),
                                         cost_model=c.ALWAYS_TRANSFER)
    try:
        with store._mu:
            store._staged.update({1000 + i: None for i in range(3)})
        log.append(store.prefetch([1000, 1001, 1002, 1005, 1006, 1009]))
        assert _wait(lambda: store.stats["prefetched"] == 5)
        log.append(sorted(map(repr, conn.calls)))
        conn.calls.clear()
        landed = store.load_chain([(1000 + i, [i], None) for i in range(3)],
                                  lambda k: list(range(k)))
        log.append((landed, conn.calls, codec.insert_calls, dict(store.stats)))
    finally:
        store.close()


def _tier_prefetch_cap(pkg, log):
    store = pkg["tiering"].TieredKVStore(FakeConnector(), pkg["tiering"].NullPageCodec(),
                                         prefetch_capacity_blocks=4)
    try:
        store.export_blocks([(h, [1, 2], None, 0, None) for h in range(100, 140)])
        log.append((store.prefetch(list(range(100, 140))), store.prefetch([7])))
        assert _wait(lambda: store.stats["prefetched"] == 4)
        with store._mu:
            log.append(list(store._ready))
    finally:
        store.close()


def _tier_gate(pkg, log):
    c = pkg["costs"]
    never = c.TransferCostModel(recompute_s=0.0, staged_restore_s=1.0, onboard_s=1.0,
                                insert_s=1.0)
    insert_only = c.TransferCostModel(recompute_s=1.0, staged_restore_s=10.0,
                                      onboard_s=10.0, insert_s=0.0)
    for gate in (never, None, insert_only):
        conn = FakeConnector()
        store = pkg["tiering"].TieredKVStore(conn, pkg["tiering"].NullPageCodec(),
                                             cost_model=gate)
        try:
            store.export_blocks([(h, [1, 2], None, 0, None) for h in (7, 11)])
            log.append((store.plan_restore([7, 11]), store.prefetch([7])))
            if gate is insert_only:
                assert _wait(lambda: store.stats["prefetched"] == 1)
                log.append(store.plan_restore([7]))
                conn.calls.clear()
                with store._mu:
                    store._ready.clear()  # the ready entry is evicted
                log.append((store.load_chain([(7, [1, 2], None)], lambda k: list(range(k))),
                            conn.calls))
            log.append(dict(store.stats))
        finally:
            store.close()


def _tier_eager_stage(pkg, log):
    codec, conn = counting_codec(pkg["tiering"].PageCodec), FakeConnector()
    store = pkg["tiering"].TieredKVStore(conn, codec, async_stage_capacity_pages=2,
                                         capacity_blocks=3)
    try:
        log.append((store.stage_async([_block(i) for i in range(4)]),
                    store.stage_async([_block(0), _block(1)])))
        store.drain_async_stages()
        log.append(store.staged_count)
        log.append(store._stage_many([_block(i) for i in range(4)]))
        codec.fail_async = True
        log.append(store.stage_async([_block(9)]))
        log.append(store._stage_many([_block(9)]))
        log.append((codec.extract_calls, codec.async_calls, sorted(conn.store.items()),
                    conn.calls, dict(store.stats), store.staged_count,
                    sorted(store.staged_subset([1000, 1001, 1002, 1003, 1009])),
                    store.staged_sample(2), store.staged_sample(0)))
    finally:
        store.close()


TIER_SCENARIOS = [_tier_stage_waves, _tier_peer_runs, _tier_mixed_sources,
                  _tier_hedged_candidates, _tier_prefetch, _tier_prefetch_cap, _tier_gate,
                  _tier_eager_stage]


@pytest.mark.parametrize("scenario", TIER_SCENARIOS, ids=lambda f: f.__name__[6:])
def test_tiered_store_matches_jax(scenario):
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        log = []
        scenario(pkg, log)
        out[name] = log
    assert out["port"] == out["jax"]
    assert out["port"]


def test_tiered_store_scenarios_see_what_jax_tests_assert():
    log = []
    _tier_stage_waves(PORT, log)
    assert log[0] == (5, 5) and log[2] == (11, 11)
    assert log[4][:2] == ([5], [4, 4, 3]) and log[3]["stage_waves"] == 3
    log = []
    _tier_peer_runs(PORT, log)
    landed, calls, inserts, stats = log[1]
    assert landed == list(range(7)) and [len(c) for c in inserts] == [4, 3]
    assert calls[0] == ("peer_many", ("p", 1), [1000, 1001, 1002])
    assert stats["onboards"] == 7 and stats["batched_fetches"] == 3
    log = []
    _tier_hedged_candidates(PORT, log)
    assert log[0][1] == [("hedged", [("a", 1), ("b", 2), ("c", 3)], [1000, 1001, 1002])]


def test_prefetch_races_load_chain():
    """The background prefetcher and load_chain race for the same blocks:
    every load lands each block once, with the store's bytes, in order."""
    n = 24
    conn = FakeConnector()
    codec = counting_codec(port_tiering.PageCodec)
    for i in range(n):
        conn.store[1000 + i] = _payload(i)
    store = port_tiering.TieredKVStore(conn, codec, cost_model=port_costs.ALWAYS_TRANSFER)
    with store._mu:
        store._staged.update({1000 + i: None for i in range(n)})
    stop = threading.Event()

    def spam():
        while not stop.is_set():
            store.prefetch([1000 + i for i in range(n)])
            time.sleep(0.001)

    t = threading.Thread(target=spam, daemon=True)
    t.start()
    try:
        for _ in range(10):
            landed = store.load_chain([(1000 + i, [i], None) for i in range(n)], _taker())
            assert landed == list(range(n))
            assert [x for call in codec.insert_calls for x in call] == [
                (i, _payload(i)) for i in range(n)]
            codec.insert_calls.clear()
    finally:
        stop.set()
        t.join(timeout=5)
        store.close()
    assert not t.is_alive()


# -- the peer resolver --------------------------------------------------------------


@pytest.mark.parametrize("rendezvous", [False, True])
def test_peer_resolver_matches_jax(rendezvous):
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        index = pkg["index"].InMemoryIndex()
        Key, PodEntry = pkg["key"].Key, pkg["key"].PodEntry
        key = Key("m", 42)
        for pod, tier in (("pod-self", "cpu"), ("pod-x", "gpu"), ("pod-y", "cpu"),
                          ("pod-z@dp1", "cpu"), ("pod-w", "cpu")):
            index.add([key], [key], [PodEntry(pod, tier)])
        addrs = {"pod-self": ("h", 1), "pod-x": ("h", 2), "pod-y": ("h", 3),
                 "pod-z": ("h", 4), "pod-w": ("h", 5)}
        clock = [100.0]
        resolver = pkg["tiering"].IndexBackedPeerResolver(
            index, "m", addrs, "pod-self", host_tier="cpu", rendezvous_primary=rendezvous,
            clock=lambda: clock[0])
        log = [resolver(42), resolver.candidates(42), resolver(43)]
        resolver.note_miss(log[0], [42])
        log += [resolver.candidates(42), resolver.negative_skips, resolver.negative_entries()]
        clock[0] += 10.0
        log += [resolver.candidates(42), resolver.forget_pod("pod-y"),
                resolver.negative_entries()]
        out[name] = log
    assert out["port"] == out["jax"]
    assert out["port"][0] is not None and ("h", 1) not in out["port"][1]
    assert ("h", 2) not in out["port"][1]  # a device-tier entry is not fetchable


def test_peer_resolver_defaults_to_the_cpu_tier():
    index = port_in_memory.InMemoryIndex()
    key = port_key.Key("m", 9)
    index.add([key], [key], [port_key.PodEntry("pod-a", "cpu")])
    resolver = port_tiering.IndexBackedPeerResolver(index, "m", {"pod-a": ("h", 7)}, "pod-b")
    assert resolver(9) == ("h", 7)


# -- the cost model ------------------------------------------------------------------


RATES = {"staged_bytes_per_s": 9e9, "peer_bytes_per_s": 2e9, "insert_bytes_per_s": 2.5e10,
         "compute_flops_per_s": 4e14, "source": "fixed"}


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("margin", [1.0, 0.5])
def test_cost_model_matches_jax(quantized, margin):
    kw = dict(vocab_size=32768, d_model=2048, n_layers=16, n_q_heads=16, n_kv_heads=8,
              head_dim=128, d_ff=8192)
    jcfg, pcfg = jax_llama.LlamaConfig(**kw), llama.LlamaConfig(**kw)
    assert port_costs.flops_per_token(pcfg) == jax_costs.flops_per_token(jcfg)
    assert port_costs.kv_bytes_per_token(pcfg, quantized) == jax_costs.kv_bytes_per_token(
        jcfg, quantized)
    want = jax_costs.TransferCostModel.for_model(jcfg, quantized, rates=RATES, margin=margin)
    got = port_costs.TransferCostModel.for_model(pcfg, quantized, rates=RATES, margin=margin)
    fields = ("recompute_s", "staged_restore_s", "onboard_s", "insert_s", "margin", "source")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    S, P, R = port_costs.STAGED, port_costs.PEER, port_costs.READY
    for chain in ([S] * 8, [P] * 8, [P, R, R, R], [S, P, S, P], [], [R] * 3):
        for page in (1, 16, 64):
            assert got.admit_prefix(chain, page) == want.admit_prefix(chain, page)
            assert got.with_margin(3.0).admit_prefix(chain, page) == want.with_margin(
                3.0).admit_prefix(chain, page)
    assert port_costs.ALWAYS_TRANSFER.admit_prefix([P] * 5, 16) == 5


def test_cost_model_rates_and_f32_bytes():
    cfg = llama.LlamaConfig(**CFG, dtype=torch.float32)
    # f32 pages carry 4 bytes per element (the payload the codec moves).
    assert port_costs.kv_bytes_per_token(cfg) == 2 * 1 * 2 * 16 * 4
    rates = port_costs.MEASURED_RATES
    if rates is None:
        with pytest.raises(ValueError, match="rates"):
            port_costs.TransferCostModel.for_model(cfg)
    else:
        gate = port_costs.TransferCostModel.for_model(cfg)
        assert gate.source == rates["source"] and "H100" in gate.source
        for key in ("staged_bytes_per_s", "peer_bytes_per_s", "insert_bytes_per_s",
                    "compute_flops_per_s"):
            assert rates[key] > 0
    explicit = port_costs.TransferCostModel.for_model(cfg, rates=RATES)
    assert explicit.source == "fixed"


def test_host_buffers_reuse_the_smallest_fit_after_their_event(monkeypatch):
    """The pinned-buffer pool of a CUDA pod's codec, with CPU tensors
    standing in for pinned ones and flags for CUDA events: a buffer given
    back with an event is reused only once the event has completed, a take
    gets the smallest free buffer that fits, and at most MAX_FREE stay."""
    from llm_d_kv_cache_manager_tpu_torch.engine import engine

    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k: real_empty(*a, **k))

    class Event:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

    pool = engine._HostBuffers()
    small, mid, big = pool.take(100), pool.take(5000), pool.take(70000)
    assert [b.numel() for b in (small, mid, big)] == [128, 8192, 131072]
    event = Event(False)
    pool.give(small)
    pool.give(mid)
    pool.give(big, after=event)
    assert pool.take(3000) is mid
    assert pool.take(60000) is not big  # its copy has not completed
    event.done = True
    assert pool.take(60000) is big
    for n in range(1, 7):
        pool.give(real_empty(n * 1000, dtype=torch.uint8))
    assert len(pool._free) == pool.MAX_FREE
    assert sorted(b.numel() for b in pool._free)[0] == 3000
