"""The port's read path against the JAX package's, on the same inputs.

Inputs are made from seeds (numpy and `random`), and each is run through
both packages in the same order, so their caches (prefix store, chain memo,
index recency) evolve alike; every result must be exactly equal:

- the prefix stores (LRU and trie) and the tokenization pool's
  `tokenize_ex` prefix state, over the fixture tokenizer
  (tests/fixtures/test-model/tokenizer.json);
- the chain memo's key streams (request, boundary and segment families);
- `ShardedIndex` under random operations with capacity eviction;
- the scorer's `score_ex`, `score_many_ex` and `score_plan`;
- every scoring method of the `Indexer` on identical event streams, with and
  without LoRA ids, over the sharded and the unsharded index.

The one unported path, the metrics-instrumented index, raises
NotImplementedError; the chat, UDS and other index backends are held in
tests/test_torch_chat.py and tests/test_torch_index_backends.py.
"""

import importlib
import os
import random
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("tokenizers")

JAX_PKG = "llm_d_kv_cache_manager_tpu"
PORT_PKG = "llm_d_kv_cache_manager_tpu_torch"
MODEL = "test-model"
TOKENIZER_JSON = os.path.join(os.path.dirname(__file__), "fixtures", MODEL, "tokenizer.json")
BLOCK = 4
PODS = ["pod-0", "pod-1", "pod-2", "pod-3"]
WORDS = (
    "alpha bravo charlie delta echo foxtrot golf hotel india juliet "
    "kilo lima mike november oscar papa quebec romeo sierra tango"
).split()


def _pkg(pkg):
    mods = dict(
        key="kvcache.kvblock.key", tp="kvcache.kvblock.token_processor",
        memo="kvcache.kvblock.chain_memo", index="kvcache.kvblock.index",
        in_memory="kvcache.kvblock.in_memory", sharded="kvcache.kvblock.sharded",
        scorer="kvcache.scorer", indexer="kvcache.indexer", ev="kvevents.events",
        pool="kvevents.pool", tpool="tokenization.pool",
        store="tokenization.prefixstore.indexer", lru="tokenization.prefixstore.lru_store",
        trie="tokenization.prefixstore.trie_store", tok="tokenization.tokenizer",
    )
    return SimpleNamespace(name=pkg, **{
        k: importlib.import_module(f"{pkg}.{v}") for k, v in mods.items()})


BOTH = [_pkg(JAX_PKG), _pkg(PORT_PKG)]


def _no_native(value):
    """Drop the chain memo's "native" flag: the JAX package's C hash core may
    or may not be built, the port builds its own; the keys are equal either
    way."""
    if isinstance(value, dict):
        return {k: _no_native(v) for k, v in value.items() if k != "native"}
    if isinstance(value, list):
        return [_no_native(v) for v in value]
    return value


def _text(rng, n):
    return " ".join(rng.choice(WORDS) for _ in range(n))


def _prompts(seed, n=6):
    """Prompts sharing a long prefix, with multi-turn extensions."""
    rng = random.Random(seed)
    shared = _text(rng, 30)
    out = [shared + " " + _text(rng, 8) for _ in range(n)]
    out.append(out[0] + " " + _text(rng, 12))  # the next turn of prompt 0
    out.append(_text(rng, 25))  # unrelated
    return out


# -- prefix stores and the tokenization pool -----------------------------------


def _tokenizer(p):
    return p.tok.CachedLocalTokenizer(tokenizer_files={MODEL: TOKENIZER_JSON})


@pytest.mark.parametrize("seed", [0, 1])
def test_lru_store_and_trie_match_jax(seed):
    prompts = _prompts(seed)
    outs = []
    for p in BOTH:
        tok = _tokenizer(p)
        lru = p.lru.LRUTokenStore(p.lru.LRUStoreConfig(cache_size=24, block_size=32))
        trie = p.trie.TrieTokenStore(max_nodes=600)
        seen = []
        for i, prompt in enumerate(prompts):
            res = tok.encode(prompt, MODEL)
            seen.append(("encode", res.tokens, res.offsets))
            if i % 2 == 0:  # learn every other prompt, look every one up
                seen.append(("add", lru.add_tokenization(prompt, res.tokens, res.offsets)))
                trie.add_tokenization(prompt, res.tokens, res.offsets)
            seen.append(("lru", lru.find_longest_with_state(prompt)))
            seen.append(("trie", trie.find_longest_contained_tokens(prompt)))
        seen.append(("many", lru.find_longest_with_state_many(prompts + prompts[:3])))
        outs.append(seen)
    assert outs[1] == outs[0]
    assert any(s[0] == "lru" and s[1][2] for s in outs[1])  # states were built


def test_tokenize_ex_prefix_state_matches_jax():
    prompts = _prompts(3)
    outs = []
    for p in BOTH:
        pool = p.tpool.TokenizationPool(
            p.tpool.TokenizersPoolConfig(workers=1),
            prefix_store=p.store.new_prefix_store(p.store.PrefixStoreConfig(block_size_bytes=32)),
            tokenizer=_tokenizer(p),
        )
        try:
            got = []
            for _ in range(2):  # cold, then warm
                for prompt in prompts:
                    t = pool.tokenize_ex(None, prompt, MODEL)
                    got.append((t.tokens, t.prefix_state))
            got.append([(t.tokens, t.prefix_state) for t in
                        pool.tokenize_many([(None, q, MODEL) for q in prompts])])
            got.append(pool.tokenize(None, prompts[0], MODEL))
        finally:
            pool.shutdown()
        outs.append(got)
    assert outs[1] == outs[0]
    assert outs[1][len(prompts)][1]  # a warm prompt carries its prefix state


def test_trie_prefix_store_through_the_pool_matches_jax():
    prompts = _prompts(4)
    outs = []
    for p in BOTH:
        pool = p.tpool.TokenizationPool(
            p.tpool.TokenizersPoolConfig(workers=1, local_tokenizer_files={MODEL: TOKENIZER_JSON}),
            prefix_store=p.store.new_prefix_store(p.store.PrefixStoreConfig(store_type="trie")),
        )
        try:
            outs.append([pool.tokenize_ex(None, q, MODEL).__dict__ for q in prompts * 2])
        finally:
            pool.shutdown()
    assert outs[1] == outs[0]


# -- chain memo ----------------------------------------------------------------


def _boundary_state(tokens):
    """A prefix state as the pool builds one: (fingerprint, n_tokens) at
    every 6th token and at the end, the fingerprint a fold of the tokens."""
    state, fp = [], 0xA0761D6478BD642F
    for n in sorted(set(range(6, len(tokens) + 1, 6)) | {len(tokens)}):
        for t in tokens[state[-1][1] if state else 0:n]:
            fp = ((fp ^ t) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        state.append((fp, n))
    return tuple(state)


def _memo_stream(p, seed):
    """Derivations through every entry family (cold, segment, boundary,
    request) with eviction (capacity 48), under several identities."""
    rng = np.random.default_rng(seed)
    memo = p.memo.ChainMemo(p.memo.ChainMemoConfig(capacity=48, segment_blocks=2,
                                                   boundary_stride=2))
    base = rng.integers(0, 500, 64).tolist()
    requests = []
    for i in range(24):
        tokens = base[:int(rng.integers(4, 64))] + rng.integers(0, 500, int(rng.integers(0, 9))).tolist()
        requests.append((tokens, [None, [3], [3, 9]][i % 3],
                         "sha256_cbor_64bit" if i % 10 == 9 else "fnv64_cbor",
                         777 if i % 11 == 10 else 12345, i % 2 == 1))
    order = list(range(24)) + [int(i) for i in rng.integers(0, 24, 24)]
    out = []
    for i in order:
        tokens, extra, algo, parent, with_state = requests[i]
        state = _boundary_state(tokens) if with_state else None
        keys = memo.derive_keys(MODEL, parent, tokens, BLOCK, extra, algo, prefix_state=state)
        out.append(([k.chunk_hash for k in keys], memo.last_family()))
    batch = [(MODEL, 12345, base[:c], BLOCK, None, "fnv64_cbor", _boundary_state(base[:c]))
             for c in (64, 40, 64, 12, 3)] + [(MODEL, 12345, base[:50], BLOCK, [3], "fnv64_cbor",
                                                None)]
    out.append([[k.chunk_hash for k in keys] for keys in memo.derive_keys_many(batch)])
    out.append(_no_native(memo.stats()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_memo_key_streams_match_jax(seed):
    jax_out, port_out = (_memo_stream(p, seed) for p in BOTH)
    assert port_out == jax_out
    families = {f for keys, f in port_out[:48]}
    assert {"cold", "segment", "boundary", "request"} <= families
    # And the memo never changes a key: the plain derivation agrees.
    plain = _pkg(PORT_PKG).tp.ChunkedTokenDatabase(
        _pkg(PORT_PKG).tp.TokenProcessorConfig(block_size=BLOCK, chain_memo=False))
    assert plain.chain_memo is None


@pytest.mark.parametrize("tokens", [
    [], [0, 23, 24, 255, 256, 65535], [65536, 2 ** 32, 2 ** 64 - 1, 7],
    np.arange(16, dtype=np.int64).tolist(), list(np.arange(60000, 60016, dtype=np.int64)),
], ids=["empty", "uint16_edges", "past_uint16", "ints", "numpy_ints"])
@pytest.mark.parametrize("extra", [None, [3]])
def test_block_hash_payload_matches_jax(tokens, extra):
    """The CBOR payload behind every block key, at the encoding's edges."""
    jax_h, port_h = (importlib.import_module(f"{p}.kvcache.kvblock.hashing")
                     for p in (JAX_PKG, PORT_PKG))
    assert port_h.cbor_hash_payload(2 ** 63, tokens, extra) == jax_h.cbor_hash_payload(
        2 ** 63, tokens, extra)
    assert port_h.prefix_hashes_fast(5, tokens, 4, extra) == jax_h.prefix_hashes_fast(
        5, tokens, 4, extra)


# -- the sharded index ---------------------------------------------------------


def _index_stream(p, seed, sharded):
    rng = np.random.default_rng(seed)
    index = p.index.new_index(p.index.IndexConfig(
        in_memory_config=p.in_memory.InMemoryIndexConfig(size=40, pod_cache_size=3),
        sharded=sharded, num_shards=4, recency_refresh_interval=3))
    K, E = p.key.Key, p.key.PodEntry
    pods = ["pod-a", "pod-b", "pod-c", "pod-d@dp1"]
    out = []
    for step in range(400):
        hashes = rng.integers(0, 80, int(rng.integers(1, 6))).tolist()
        pod, tier = pods[rng.integers(0, 4)], ["gpu", "cpu"][rng.integers(0, 2)]
        op = rng.integers(0, 12)
        if op < 7:
            index.add([K(MODEL, h + 1000) for h in hashes], [K(MODEL, h) for h in hashes],
                      [E(pod, tier)])
        else:
            index.evict(K(MODEL, hashes[0] + 1000), [E(pod, tier)])
        if step % 50 == 49:  # a bare name also purges its ranked identities
            out.append(("remove_pod", index.remove_pod(pod.split("@")[0] if op % 2 else pod)))
        probe = [K(MODEL, h) for h in rng.integers(0, 80, int(rng.integers(1, 7))).tolist()]
        filt = [set(), {"pod-a"}, {"pod-d"}, {"pod-b", "pod-c"}][rng.integers(0, 4)]
        got = index.lookup(probe, filt)
        out.append(("lookup", {(k.chunk_hash): [tuple(e) for e in v] for k, v in got.items()}))
        if step % 9 == 0:
            many = index.lookup_many([(probe, filt), (probe[:2], set()), (probe[::-1], filt)])
            out.append(("many", [{k.chunk_hash: [tuple(e) for e in v] for k, v in r.items()}
                                 for r in many]))
        out.append(("req", index.get_request_key(K(MODEL, probe[0].chunk_hash + 1000))))
    view = index.export_view()
    out.append(("view", view.entries, view.engine_map))
    if sharded:
        out.append(("segments", index.segment_sizes(), index.per_shard_capacity))
    return out


@pytest.mark.parametrize("sharded", [True, False], ids=["sharded", "in_memory"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_random_ops_with_eviction_match_jax(seed, sharded):
    jax_out, port_out = (_index_stream(p, seed, sharded) for p in BOTH)
    assert port_out == jax_out
    assert sum(1 for o in port_out if o[0] == "lookup" and o[1]) > 20
    if sharded:
        assert sum(port_out[-1][1]) > 0 and port_out[-1][2] == 10


def test_default_index_config_builds_the_sharded_index():
    p = _pkg(PORT_PKG)
    index = p.index.new_index()
    assert isinstance(index, p.sharded.ShardedIndex)
    assert index.num_shards == 16 and index.per_shard_capacity == 10 ** 8 // 16
    assert isinstance(p.index.new_index(p.index.IndexConfig(sharded=False)),
                      p.in_memory.InMemoryIndex)


# -- the scorer ----------------------------------------------------------------


def _scorer_stream(p, seed):
    rng = np.random.default_rng(seed)
    scorer = p.scorer.new_kv_block_scorer()
    K, E = p.key.Key, p.key.PodEntry
    chains = [[K(MODEL, int(h)) for h in rng.integers(0, 2 ** 63, 12)] for _ in range(4)]
    tiers = ["hbm", "host", "gpu", "cpu", "odd"]
    hits = {}
    for chain in chains:
        depth = {pod: int(rng.integers(0, 13)) for pod in PODS}
        for i, key in enumerate(chain):
            entries = [E(pod, tiers[rng.integers(0, 5)]) for pod in PODS if i < depth[pod]]
            if entries and rng.integers(0, 10):
                hits[key] = entries
    out = [scorer.score_ex(c, hits) for c in chains]
    out.append(scorer.score_many_ex([(c, hits) for c in chains] + [([], hits)]))
    # A plan with forks: chain 1 shares chain 0's first 5 keys.
    forked = chains[0][:5] + chains[1][5:]
    plan = [("solo", chains[0], hits, True),
            ("fork", 0, 5, forked[5:], hits),
            ("fork", 0, 12, [], {}),
            ("solo", chains[2], hits, False)]
    out.append(scorer.score_plan(plan))
    out.append(scorer.score_ex(forked, hits))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_scorer_matches_jax(seed):
    jax_out, port_out = (_scorer_stream(p, seed) for p in BOTH)
    assert port_out == jax_out
    assert port_out[-2][1] == port_out[-1]  # a fork scores as its own walk


# -- the Indexer ---------------------------------------------------------------


def _make_indexer(p, sharded):
    indexer = p.indexer.Indexer(
        config=p.indexer.IndexerConfig(
            token_processor_config=p.tp.TokenProcessorConfig(block_size=BLOCK),
            kv_block_index_config=p.index.IndexConfig(sharded=sharded),
            prefix_store_config=p.store.PrefixStoreConfig(block_size_bytes=32),
        ),
        tokenization_pool=p.tpool.TokenizationPool(
            p.tpool.TokenizersPoolConfig(workers=2, local_tokenizer_files={MODEL: TOKENIZER_JSON}),
            prefix_store=p.store.new_prefix_store(p.store.PrefixStoreConfig(block_size_bytes=32)),
        ),
    )
    indexer.run()
    return indexer


def _events(p, prompts, seed, loras):
    """One event stream (BlockStored with random depths on random pods,
    some removals), made from the fixture tokenizer's tokens."""
    rng = random.Random(seed)
    tok = _tokenizer(p)
    ev = p.ev
    out = []
    seq = 0
    for prompt in prompts:
        tokens = tok.encode(prompt, MODEL).tokens
        n_blocks = len(tokens) // BLOCK
        for lora in loras:
            for pod in rng.sample(PODS, rng.randint(1, 3)):
                depth = rng.randint(1, n_blocks)
                hashes = [5_000_000 + seq * 1000 + i for i in range(depth)]
                seq += 1
                out.append((pod, ev.EventBatch(float(seq), [ev.BlockStored(
                    hashes, None, tokens[:depth * BLOCK], BLOCK, lora_id=lora,
                    medium=rng.choice(["gpu", "cpu", None]))])))
                if rng.random() < 0.2:
                    out.append((pod, ev.EventBatch(float(seq), [ev.BlockRemoved(hashes[-1:])])))
    return out


def _indexer_stream(p, sharded, seed, loras):
    indexer = _make_indexer(p, sharded)
    pool = p.pool.EventPool(p.pool.EventPoolConfig(default_device_tier="gpu"),
                            indexer.kv_block_index, indexer.token_processor)
    prompts = _prompts(seed)
    for pod, batch in _events(p, prompts, seed, loras):
        pool._process_event(p.pool.Message(
            topic=f"kv@{pod}@{MODEL}", payload=batch.to_msgpack(), seq=0,
            pod_identifier=pod, model_name=MODEL))
    out = []
    try:
        fields = lambda r: (r.scores, r.match_blocks, r.block_hashes)  # noqa: E731
        for lora in loras + [-3]:
            for q in prompts:  # cold, then warm
                out.append(indexer.get_pod_scores(q, MODEL, [], lora_id=lora))
                out.append(fields(indexer.get_pod_scores_ex(q, MODEL, ["pod-0", "pod-2"],
                                                            lora_id=lora)))
        S = p.indexer.ScoreRequest
        reqs = [S(q, MODEL) for q in prompts] + [
            S(prompts[0], MODEL, pod_identifiers=["pod-1", "pod-3"]),
            S(prompts[1], MODEL, lora_id=loras[-1]), S(prompts[2], MODEL, lora_id=-5),
            S("x", MODEL), S(prompts[0] + " echo golf", MODEL)]  # one cold item
        out.append([fields(r) for r in indexer.score_many(reqs)])
        chain = indexer.get_pod_scores_ex(prompts[0], MODEL, []).block_hashes
        out.append(fields(indexer.score_hashes(MODEL, chain, ["pod-0", "pod-1", "pod-3"])))
        out.append(fields(indexer.score_hashes(MODEL, [], [])))
        for q, lora in ((prompts[0], None), (prompts[-2], loras[-1]), ("x", None)):
            out.append(_no_native(indexer.explain_scores(q, MODEL, [], lora_id=lora)))
        out.append(_no_native(indexer.token_processor.chain_memo.stats()))
    finally:
        indexer.shutdown()
    return out


@pytest.mark.parametrize("sharded", [True, False], ids=["sharded", "in_memory"])
@pytest.mark.parametrize("loras", [[None], [None, 1, 2]], ids=["base", "lora"])
def test_indexer_scoring_methods_match_jax(sharded, loras):
    jax_out, port_out = (_indexer_stream(p, sharded, 5, loras) for p in BOTH)
    assert port_out == jax_out
    assert sum(1 for o in port_out if isinstance(o, dict) and o and "scores" not in o) > 5
    explain = port_out[-2]
    assert explain["degraded"] == "no_block_keys"
    assert port_out[-6][0]  # score_hashes found holders


def _word_tokenizer(p):
    """A deterministic word-level tokenizer through the `tokenizer=` seam:
    each word's id is its index in WORDS, offsets are byte offsets."""

    class WordTokenizer(p.tok.Tokenizer):
        def encode(self, prompt, model_name):
            tokens, offsets, pos = [], [], 0
            for word in prompt.split(" "):
                tokens.append(WORDS.index(word) if word in WORDS else len(WORDS))
                offsets.append((pos, pos + len(word)))
                pos += len(word) + 1
            return p.tok.TokenizationResult(tokens=tokens, offsets=offsets)

    return WordTokenizer()


def test_injected_tokenizer_seam_matches_jax():
    outs = []
    for p in BOTH:
        pool = p.tpool.TokenizationPool(p.tpool.TokenizersPoolConfig(workers=1),
                                        tokenizer=_word_tokenizer(p))
        indexer = p.indexer.Indexer(
            p.indexer.IndexerConfig(token_processor_config=p.tp.TokenProcessorConfig(
                block_size=BLOCK)), tokenization_pool=pool)
        keys = indexer.token_processor.tokens_to_kv_block_keys(
            None, list(range(16)), MODEL)
        indexer.kv_block_index.add([p.key.Key(MODEL, 9 + i) for i in range(4)], keys,
                                   [p.key.PodEntry("pod-w", "gpu")])
        prompt = " ".join(WORDS[:18])
        outs.append([indexer.get_pod_scores(prompt, MODEL, []) for _ in range(3)])
        indexer.shutdown()
    assert outs[1] == outs[0] and outs[1][0] == {"pod-w": 4.0}


# -- what is not ported yet ----------------------------------------------------


def test_unported_paths_raise_not_implemented():
    """Nothing of the read path is left unported: `enable_metrics=True`
    wraps the index in the metrics-instrumented one. A render request on a
    tokenizer that has no chat-templating processor raises
    NotImplementedError, as the reference's base contract does, on every
    read-path entry."""
    p = _pkg(PORT_PKG)
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.instrumented import InstrumentedIndex
    from llm_d_kv_cache_manager_tpu_torch.metrics import collector

    try:
        assert isinstance(p.index.new_index(p.index.IndexConfig(enable_metrics=True)),
                          InstrumentedIndex)
    finally:
        collector.stop_metrics_logging()
    indexer = p.indexer.Indexer(tokenization_pool=p.tpool.TokenizationPool(
        p.tpool.TokenizersPoolConfig(workers=1), tokenizer=_word_tokenizer(p)))
    try:
        for call in (
            lambda: indexer.get_pod_scores("alpha", MODEL, [], render_request=object()),
            lambda: indexer.get_pod_scores_ex("alpha", MODEL, [], render_request=object()),
            lambda: indexer.explain_scores("alpha", MODEL, [], render_request=object()),
            lambda: indexer.tokenizers_pool.tokenize(object(), "alpha", MODEL),
            lambda: _tokenizer(p).render_chat_template(object()),
        ):
            with pytest.raises(NotImplementedError):
                call()
    finally:
        indexer.shutdown()
