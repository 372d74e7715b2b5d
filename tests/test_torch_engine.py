"""The port's pod, event stream and read path against the JAX package's.

A port EnginePod (device="cpu", f32) and a JAX EnginePod share one parameter
tree and serve the same requests; greedy tokens and the BlockStored /
BlockRemoved stream must match exactly, including under page pressure where
bucket-padded prefill reservations decide what gets reclaimed. The port's
events, as msgpack bytes, digested by the JAX EventPool must give the index
the port's own digest builds, and the port's token-ID read path must score
pods exactly as the JAX ChunkedTokenDatabase -> InMemoryIndex.lookup ->
LongestPrefixScorer pipeline does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.engine.block_manager import (
    BlockManager as JaxBlockManager,
    BlockManagerConfig as JaxBlockManagerConfig,
)
from llm_d_kv_cache_manager_tpu.engine.engine import (
    EnginePod as JaxEnginePod,
    EnginePodConfig as JaxEnginePodConfig,
)
from llm_d_kv_cache_manager_tpu.kvcache.kvblock.in_memory import (
    InMemoryIndex as JaxInMemoryIndex,
)
from llm_d_kv_cache_manager_tpu.kvcache.kvblock.token_processor import (
    ChunkedTokenDatabase as JaxTokenDatabase,
    TokenProcessorConfig as JaxTokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu.kvcache.scorer import new_kv_block_scorer
from llm_d_kv_cache_manager_tpu.kvevents.pool import EventPool, EventPoolConfig, Message
from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu_torch.engine.block_manager import (
    BlockManager,
    BlockManagerConfig,
)
from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig
from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import Indexer
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import InMemoryIndex
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.digest import digest_batch
from llm_d_kv_cache_manager_tpu_torch.kvevents.events import EventBatch
from llm_d_kv_cache_manager_tpu_torch.models import llama

PAGE = 4
MODEL = "m"
CFG = dict(vocab_size=128, d_model=32, n_layers=1, n_q_heads=2, n_kv_heads=2,
           head_dim=16, d_ff=64)


def _event_rows(batches):
    """Every event as a plain tuple (schema-independent comparison)."""
    return [tuple(e.to_tagged_union()) for b in batches for e in b.events]


class _PodPair:
    """The same pod on both packages, sharing one f32 parameter tree."""

    def __init__(self, n_pages, max_pages_per_seq=16, int8=False, n_layers=1):
        cfg = {**CFG, "n_layers": n_layers}
        jcfg = jax_llama.LlamaConfig(**cfg, dtype=jnp.float32)
        jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
        np_params = jax.tree_util.tree_map(np.asarray, jparams)
        self.jax_events, self.port_events = [], []
        self.jax = JaxEnginePod(
            JaxEnginePodConfig(
                n_pages=n_pages, page_size=PAGE, with_model=True, model_config=jcfg,
                max_pages_per_seq=max_pages_per_seq, device_tier="gpu",
                use_quantized_kv=int8,
            ),
            event_sink=self.jax_events.append, params=jparams,
        )
        self.port = EnginePod(
            EnginePodConfig(
                n_pages=n_pages, page_size=PAGE, max_pages_per_seq=max_pages_per_seq,
                device_tier="gpu", device="cpu", use_quantized_kv=int8,
                model_config=llama.LlamaConfig(**cfg, dtype=torch.float32),
            ),
            event_sink=self.port_events.append,
            params=llama.params_from_jax(np_params, device="cpu"),
        )

    def serve(self, prompt, n_decode=5):
        """prefill + first token + n_decode greedy steps + free, on both."""
        out = []
        for pod, argmax in ((self.jax, jnp.argmax), (self.port, torch.argmax)):
            state, cached = pod.prefill(prompt)
            first = int(argmax(pod.last_logits))
            pod.decode_append(state, first)
            tokens = [first] + [pod.decode_step(state) for _ in range(n_decode)]
            pod.free(state)
            out.append((cached, tokens))
        return out


REQUESTS = [
    list(range(10)),
    list(range(10)),  # full prefix hit (two pages of four)
    list(range(40, 53)),
    list(range(10)) + [99, 98, 97],
    list(range(70, 81)),
    list(range(40, 53)),
]


@pytest.fixture(
    scope="module", params=[(32, False), (8, False), (32, True), (8, True)],
    ids=["roomy_pool", "tight_pool", "roomy_pool_int8", "tight_pool_int8"],
)
def served(request):
    n_pages, int8 = request.param
    pair = _PodPair(n_pages=n_pages, max_pages_per_seq=8, int8=int8)
    results = [pair.serve(prompt) for prompt in REQUESTS]
    return n_pages, pair, results


def test_generation_with_prefix_reuse_matches_jax(served):
    _, _, results = served
    for (jax_cached, jax_tokens), (port_cached, port_tokens) in results:
        assert port_cached == jax_cached
        assert port_tokens == jax_tokens
    assert results[1][1][0] == 8  # the repeated prompt hits two cached pages


def test_event_stream_matches_jax(served):
    n_pages, pair, _ = served
    port_rows = _event_rows(pair.port_events)
    assert port_rows == _event_rows(pair.jax_events)
    assert all(row[-1] == "gpu" for row in port_rows)  # medium
    removed = [row for row in port_rows if row[0] == "BlockRemoved"]
    if n_pages == 8:
        assert removed  # page pressure reclaimed cached pages
    else:
        assert not removed


def test_pods_allocate_a_trash_page(served):
    _, pair, _ = served
    n_pages = pair.port.config.n_pages
    assert pair.port.trash_page == pair.jax.trash_page == n_pages
    assert all(pool.shape[2] == n_pages + 1 for pool in pair.port.kv_cache)
    assert len(pair.port.kv_cache) == len(pair.jax.kv_cache)  # 2 or 4 pools


@pytest.mark.parametrize("int8", [False, True], ids=["model_dtype", "int8"])
def test_prefill_chunk_batch_matches_jax(int8):
    """Packed prefill of 3 jobs (two after a cached prefix, one fresh) on
    both packages: the same logits, greedy continuations, event stream and
    pod scores."""
    pair = _PodPair(n_pages=32, int8=int8)
    # Chunks of 13, 10 and 16 tokens: a 4 x 16 batch, within the skew guard
    # (at most twice the real tokens), so both pods take one packed pass.
    shared = list(range(1, 9))  # two pages, cached by a first request
    prompts = [shared + list(range(20, 33)), list(range(40, 50)),
               shared + list(range(60, 76))]
    out = []
    for pod, argmax in ((pair.jax, jnp.argmax), (pair.port, torch.argmax)):
        state, _ = pod.prefill(shared)
        pod.free(state)
        jobs = []
        for prompt in prompts:
            state, start = pod.begin_prefill(prompt)
            jobs.append((state, start, len(prompt)))
        logits = pod.prefill_chunk_batch(jobs)
        tokens = []
        for (state, _, _), row in zip(jobs, logits):
            pod.finish_prefill(state)
            first = int(argmax(row))
            pod.decode_append(state, first)
            tokens.append([first] + [pod.decode_step(state) for _ in range(3)])
        for state, _, _ in jobs:
            pod.free(state)
        out.append(([start for _, start, _ in jobs], logits, tokens))
    (jstarts, jlogits, jtokens), (starts, logits, tokens) = out
    assert starts == jstarts == [8, 0, 8]
    for got, want in zip(logits, jlogits):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert tokens == jtokens
    assert _event_rows(pair.port_events) == _event_rows(pair.jax_events)
    by_pod = {"pod-e": pair.port_events}
    jax_index, jax_tp = _jax_index_from_msgpack(by_pod)
    indexer = _port_index(by_pod)
    scorer = new_kv_block_scorer()
    for probe in prompts + [shared + [7, 7, 7, 7]]:
        jkeys = jax_tp.tokens_to_kv_block_keys(None, probe, MODEL)
        want = scorer.score(jkeys, jax_index.lookup(jkeys, set())) if jkeys else {}
        assert indexer.get_pod_scores(probe, MODEL, []) == want
    assert indexer.get_pod_scores(prompts[2], MODEL, [])["pod-e"] == 6.0


def _jax_index_from_msgpack(batches_by_pod):
    """Digest msgpack bytes through the JAX EventPool into a JAX index."""
    index = JaxInMemoryIndex()
    processor = JaxTokenDatabase(JaxTokenProcessorConfig(block_size=PAGE))
    pool = EventPool(EventPoolConfig(concurrency=1), index, processor)
    pool.start(with_subscriber=False)
    try:
        for pod_id, batches in batches_by_pod.items():
            for batch in batches:
                pool.add_task(Message(
                    topic=f"kv@{pod_id}@{MODEL}", payload=batch.to_msgpack(), seq=0,
                    pod_identifier=pod_id, model_name=MODEL,
                ))
        pool.drain()
    finally:
        pool.shutdown()
    return index, processor


def _port_index(batches_by_pod):
    indexer = Indexer(TokenProcessorConfig(block_size=PAGE))
    for pod_id, batches in batches_by_pod.items():
        for batch in batches:
            digest_batch(indexer.kv_block_index, indexer.token_processor, pod_id,
                         MODEL, batch)
    return indexer


def _entries(lookup_result):
    return {
        (k.model_name, k.chunk_hash): [(e.pod_identifier, e.device_tier) for e in v]
        for k, v in lookup_result.items()
    }


def test_msgpack_events_digested_by_jax_pool_match_port_index(served):
    _, pair, _ = served
    # The wire round trip is lossless.
    for batch in pair.port_events:
        again = EventBatch.from_msgpack(batch.to_msgpack())
        assert _event_rows([again]) == _event_rows([batch])
    by_pod = {"pod-e": pair.port_events}
    jax_index, jax_tp = _jax_index_from_msgpack(by_pod)
    indexer = _port_index(by_pod)
    for prompt in REQUESTS + [list(range(20)), list(range(40, 60))]:
        jkeys = jax_tp.tokens_to_kv_block_keys(None, prompt, MODEL)
        pkeys = indexer.token_processor.tokens_to_kv_block_keys(None, prompt, MODEL)
        assert [k.chunk_hash for k in pkeys] == [k.chunk_hash for k in jkeys]
        assert _entries(indexer.kv_block_index.lookup(pkeys, set())) == _entries(
            jax_index.lookup(jkeys, set())
        )


def test_pod_scores_match_jax_read_path():
    """Two port pods; the port's get_pod_scores vs the JAX pipeline over the
    same events (sent as msgpack bytes)."""
    events = {"pod-a": [], "pod-b": []}
    cfg = llama.LlamaConfig(**CFG, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prefixes = {"pod-a": list(range(1, 13)), "pod-b": list(range(60, 69))}
    for pod_id in events:
        pod = EnginePod(
            EnginePodConfig(pod_id=pod_id, n_pages=16, page_size=PAGE, device_tier="gpu",
                            max_pages_per_seq=8, model_config=cfg, device="cpu"),
            event_sink=events[pod_id].append, params=params,
        )
        for suffix in ([100, 101, 102], [103, 104, 105, 106, 107]):
            state, _ = pod.prefill(prefixes[pod_id] + suffix)
            pod.free(state)
    jax_index, jax_tp = _jax_index_from_msgpack(events)
    scorer = new_kv_block_scorer()
    indexer = _port_index(events)
    probes = [
        prefixes["pod-a"] + [100, 101, 102, 7],
        prefixes["pod-a"][:8] + [1, 1, 1, 1],
        prefixes["pod-b"] + [103, 104, 105],
        list(range(200, 216)),
        prefixes["pod-b"][:4],
    ]
    for probe in probes:
        for pods in ([], ["pod-a"], ["pod-a", "pod-b"]):
            jkeys = jax_tp.tokens_to_kv_block_keys(None, probe, MODEL)
            want = scorer.score(jkeys, jax_index.lookup(jkeys, set(pods))) if jkeys else {}
            assert indexer.get_pod_scores(probe, MODEL, pods) == want
    assert indexer.get_pod_scores(probes[0], MODEL, [])["pod-a"] == 3.0
    assert indexer.get_pod_scores(probes[2], MODEL, []) == {"pod-b": 3.0}


@pytest.mark.parametrize("seed", ["", "x"])
@pytest.mark.parametrize("lora_id", [None, 7])
def test_hash_parity_with_jax(seed, lora_id):
    tokens = list(range(3, 40))
    port = ChunkedTokenDatabase(TokenProcessorConfig(block_size=PAGE, hash_seed=seed))
    ref = JaxTokenDatabase(
        JaxTokenProcessorConfig(block_size=PAGE, hash_seed=seed, chain_memo=False)
    )
    assert port.init_hash == ref.init_hash
    want = [k.chunk_hash for k in ref.tokens_to_kv_block_keys(None, tokens, MODEL, lora_id=lora_id)]
    got = [k.chunk_hash for k in port.tokens_to_kv_block_keys(None, tokens, MODEL, lora_id=lora_id)]
    assert got == want and len(got) == len(tokens) // PAGE

    # The block managers emit the same chained stream for the same traffic.
    streams = []
    for cls, cfg_cls in ((BlockManager, BlockManagerConfig),
                         (JaxBlockManager, JaxBlockManagerConfig)):
        batches = []
        bm = cls(cfg_cls(n_pages=6, page_size=PAGE, hash_seed=seed, device_tier="gpu"),
                 event_sink=batches.append)
        for prompt in (tokens[:10], tokens[:14], tokens[20:33], tokens[:10]):
            state = bm.allocate(prompt, lora_id=lora_id)
            bm.commit_prefill(state)
            for t in (1, 2, 3):
                bm.append_token(state, t)
            bm.mark_decode_computed(state)
            bm.free(state)
        bm.clear()
        streams.append(_event_rows(batches))
    assert streams[0] == streams[1]
    assert any(row[0] == "BlockRemoved" for row in streams[0])


def test_sha256_hash_parity_with_jax():
    port = ChunkedTokenDatabase(
        TokenProcessorConfig(block_size=PAGE, hash_seed="x", hash_algo="sha256_cbor_64bit")
    )
    ref = JaxTokenDatabase(JaxTokenProcessorConfig(
        block_size=PAGE, hash_seed="x", hash_algo="sha256_cbor_64bit", chain_memo=False,
    ))
    tokens = list(range(50, 75))
    for lora_id in (None, 3):
        assert [k.chunk_hash for k in port.tokens_to_kv_block_keys(None, tokens, MODEL, lora_id)] == [
            k.chunk_hash for k in ref.tokens_to_kv_block_keys(None, tokens, MODEL, lora_id)
        ]
    with pytest.raises(ValueError, match="non-empty hash_seed"):
        ChunkedTokenDatabase(TokenProcessorConfig(hash_algo="sha256_cbor_64bit"))


def _random_block_traffic(bm, rng, n_ops=120):
    """Random allocate / reserve / decode / free / clear traffic on one block
    manager; returns what a caller observes (states, errors)."""
    from llm_d_kv_cache_manager_tpu_torch.engine.block_manager import OutOfPagesError
    from llm_d_kv_cache_manager_tpu.engine.block_manager import (
        OutOfPagesError as JaxOutOfPagesError,
    )

    prefixes = [rng.integers(0, 50, rng.integers(4, 14)).tolist() for _ in range(4)]
    live, seen = [], []
    for _ in range(n_ops):
        op = rng.integers(0, 10)
        try:
            if op < 4 or not live:
                tokens = prefixes[rng.integers(0, 4)] + rng.integers(0, 50, rng.integers(0, 9)).tolist()
                state = bm.allocate(tokens, lora_id=[None, 1][rng.integers(0, 2)])
                bm.commit_prefill(state)
                live.append(state)
                seen.append(("alloc", list(state.block_table), state.num_cached_tokens))
            elif op < 5:
                state = live[rng.integers(0, len(live))]
                bm.reserve_pages(state, len(state.block_table) + int(rng.integers(1, 3)))
                seen.append(("reserve", list(state.block_table)))
            elif op < 8:
                state = live[rng.integers(0, len(live))]
                bm.append_token(state, int(rng.integers(0, 50)))
                if rng.integers(0, 2):
                    bm.mark_decode_computed(state)
                seen.append(("decode", list(state.block_table), state.n_hashed_pages))
            elif op < 9 or len(live) > 1:
                bm.free(live.pop(rng.integers(0, len(live))))
                seen.append(("free", bm.num_free_pages, bm.num_cached_pages))
            else:
                bm.clear()
                live = []
                seen.append(("clear",))
        except (OutOfPagesError, JaxOutOfPagesError):
            seen.append(("out_of_pages",))
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_manager_random_traffic_matches_jax(seed):
    runs = []
    for cls, cfg_cls in ((BlockManager, BlockManagerConfig),
                         (JaxBlockManager, JaxBlockManagerConfig)):
        batches = []
        bm = cls(cfg_cls(n_pages=12, page_size=PAGE, device_tier="gpu"),
                 event_sink=batches.append)
        seen = _random_block_traffic(bm, np.random.default_rng(seed))
        runs.append((seen, _event_rows(batches)))
    assert runs[0] == runs[1]
    assert any(s[0] == "out_of_pages" for s in runs[0][0])
    assert any(row[0] == "BlockRemoved" for row in runs[0][1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_in_memory_index_random_ops_match_jax(seed):
    """Random add / evict on both indices (small LRU capacities, so
    capacity eviction runs too), then lookups with and without pod filters."""
    from llm_d_kv_cache_manager_tpu.kvcache.kvblock.in_memory import (
        InMemoryIndexConfig as JaxInMemoryIndexConfig,
    )
    from llm_d_kv_cache_manager_tpu.kvcache.kvblock.key import (
        Key as JaxKey,
        PodEntry as JaxPodEntry,
    )
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import (
        InMemoryIndexConfig,
    )
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key, PodEntry

    rng = np.random.default_rng(seed)
    port = InMemoryIndex(InMemoryIndexConfig(size=40, pod_cache_size=3))
    ref = JaxInMemoryIndex(JaxInMemoryIndexConfig(size=40, pod_cache_size=3))
    pods = ["pod-a", "pod-b", "pod-c", "pod-d@dp1"]
    tiers = ["gpu", "cpu"]
    for _ in range(300):
        hashes = rng.integers(0, 60, rng.integers(1, 5)).tolist()
        pod, tier = pods[rng.integers(0, 4)], tiers[rng.integers(0, 2)]
        if rng.integers(0, 3):
            port.add([Key(MODEL, h + 1000) for h in hashes], [Key(MODEL, h) for h in hashes],
                     [PodEntry(pod, tier)])
            ref.add([JaxKey(MODEL, h + 1000) for h in hashes], [JaxKey(MODEL, h) for h in hashes],
                    [JaxPodEntry(pod, tier)])
        else:
            port.evict(Key(MODEL, hashes[0] + 1000), [PodEntry(pod, tier)])
            ref.evict(JaxKey(MODEL, hashes[0] + 1000), [JaxPodEntry(pod, tier)])
        probe = rng.integers(0, 60, rng.integers(1, 6)).tolist()
        pod_filter = [set(), {"pod-a"}, {"pod-d"}, {"pod-b", "pod-c"}][rng.integers(0, 4)]
        assert _entries(port.lookup([Key(MODEL, h) for h in probe], pod_filter)) == _entries(
            ref.lookup([JaxKey(MODEL, h) for h in probe], pod_filter)
        )
        assert port.get_request_key(Key(MODEL, probe[0] + 1000)) == ref.get_request_key(
            JaxKey(MODEL, probe[0] + 1000)
        )
