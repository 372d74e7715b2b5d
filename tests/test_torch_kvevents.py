"""The port's write plane against the JAX package's, on the same bytes.

- The wire primitives: the port's msgpack codec gives the bytes of
  `msgpack.packb(..., use_bin_type=True)` and decodes what
  `msgpack.unpackb(..., raw=False, strict_map_key=False)` decodes; its XXH64
  equals `xxhash.xxh64`.
- The block manager's `enable_prefix_caching=False`, on both packages.
- The EventPool scenarios of the JAX package's pool tests (sharding,
  drop-oldest with removal recovery and `removals_lost`, seq floors and
  filters, poison pills and fuzzed payloads, the duck-typed hooks), run on a
  JAX pool and a port pool with the device tier set on both: the index
  contents and the counters must be equal.
"""

import importlib
import random
import threading
from types import SimpleNamespace

import msgpack
import numpy as np
import pytest
import xxhash

from llm_d_kv_cache_manager_tpu_torch.utils import msgpack_codec
from llm_d_kv_cache_manager_tpu_torch.utils.xxh64 import intdigest

JAX_PKG = "llm_d_kv_cache_manager_tpu"
PORT_PKG = "llm_d_kv_cache_manager_tpu_torch"
TIER = "gpu"
MODEL = "m"
BLOCK = 4


# -- wire primitives ----------------------------------------------------------


def _random_value(rng, depth=0):
    """A random msgpack-representable value (seeded numpy), nested."""
    kind = rng.integers(0, 12 if depth < 3 else 8)
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:  # ints spread over every width, both signs
        bits = int(rng.integers(0, 64))
        v = int(rng.integers(0, 2 ** 62)) >> (62 - min(bits, 62))
        return -v - 1 if rng.integers(0, 2) and v < 2 ** 63 else v
    if kind == 3:
        return [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                -2 ** 31, -2 ** 31 - 1, -2 ** 63][int(rng.integers(0, 20))]
    if kind == 4:
        return float(rng.normal() * 10.0 ** int(rng.integers(-5, 6)))
    if kind == 5:
        n = int([0, 5, 31, 32, 255, 256, 70000][rng.integers(0, 7)])
        return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, n))
    if kind == 6:
        n = int([0, 3, 255, 256, 70000][rng.integers(0, 5)])
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 7:  # a token-id list
        return rng.integers(0, 65536, int(rng.integers(0, 40))).tolist()
    if kind in (8, 9):
        n = int([0, 1, 15, 16, 17][rng.integers(0, 5)])
        items = [_random_value(rng, depth + 1) for _ in range(n)]
        return tuple(items) if kind == 9 else items
    n = int([0, 1, 15, 16][rng.integers(0, 4)])
    return {int(rng.integers(-5, 1000)) if rng.integers(0, 2) else f"k{i}":
            _random_value(rng, depth + 1) for i in range(n)}


@pytest.mark.parametrize("seed", range(6))
def test_codec_random_values_match_msgpack(seed):
    rng = np.random.default_rng(seed)
    for _ in range(150):
        value = _random_value(rng)
        want = msgpack.packb(value, use_bin_type=True)
        assert msgpack_codec.packb(value) == want
        assert msgpack_codec.unpackb(want) == msgpack.unpackb(
            want, raw=False, strict_map_key=False)
    # Array and map lengths past 16 and 65,535 elements.
    for n in (16, 65535, 65536):
        for value in (list(range(n)), {i: i for i in range(n)}):
            want = msgpack.packb(value, use_bin_type=True)
            assert msgpack_codec.packb(value) == want
            assert msgpack_codec.unpackb(want) == value


def test_codec_decodes_float32():
    raw = msgpack.packb([1.5, -0.1], use_single_float=True)
    assert raw[1] == 0xCA
    assert msgpack_codec.unpackb(raw) == msgpack.unpackb(raw)


@pytest.mark.parametrize("raw", [
    b"", b"\xc1", b"\x92\x01", b"\xdc\x00\x05\x01", b"\xd9\x05ab", b"\xc4\x02a",
    b"\x01\x02", b"\xa2\xff\xfe", b"\xcd\x01", b"\x81\x91\x01\x02",
    b"\xdd\xff\xff\xff\xff",
], ids=["empty", "reserved", "short_array", "short_array16", "short_str8", "short_bin8",
        "extra_data", "bad_utf8", "short_uint16", "unhashable_key", "huge_array32"])
def test_codec_malformed_input_raises_as_msgpack_does(raw):
    with pytest.raises((ValueError, TypeError)) as want:
        msgpack.unpackb(raw, raw=False, strict_map_key=False)
    expected = TypeError if issubclass(want.type, TypeError) else ValueError
    with pytest.raises(expected):
        msgpack_codec.unpackb(raw)


def test_codec_refuses_ext_and_unknown_types():
    """The event wire carries no ext type: the codec refuses them both ways
    (msgpack itself would pack and return an ExtType)."""
    for value in (msgpack.ExtType(1, b"x"), object(), {1, 2}):
        with pytest.raises(TypeError):
            msgpack_codec.packb(value)
    for raw in (b"\xd4\x01\x00", b"\xc7\x01\x05a", msgpack.packb([1, msgpack.ExtType(2, b"ab")])):
        assert isinstance(msgpack.unpackb(raw), (msgpack.ExtType, list))
        with pytest.raises(ValueError, match="ext type"):
            msgpack_codec.unpackb(raw)
    with pytest.raises(OverflowError):
        msgpack_codec.packb(2 ** 64)


def _batch_shapes(ev):
    """Every EventBatch shape of tests/test_kvevents.py, built from one
    package's events module."""
    h = (123456789).to_bytes(32, "big")
    return [
        ev.EventBatch(ts=123.5, events=[ev.BlockStored(
            block_hashes=[1, 2], parent_block_hash=None, token_ids=[10, 11, 12, 13],
            block_size=4, medium="hbm")]),
        ev.EventBatch(ts=1.0, events=[ev.BlockRemoved(block_hashes=[7]),
                                      ev.AllBlocksCleared()], data_parallel_rank=3),
        ev.EventBatch(ts=2.0, events=[ev.BlockStored([5], None, [1], 1)]),
        ev.EventBatch(ts=0.0, events=[ev.BlockStored([h], h, [1, 2], 2)]),
        ev.EventBatch(ts=3.25, events=[ev.BlockStored([2 ** 64 - 1, -5], 2 ** 63, [70000, 0],
                                                     1, lora_id=7, medium="cpu")]),
        ev.EventBatch(ts=0.0, events=[]),
    ]


def _rows(batch):
    return (batch.ts, [tuple(e.to_tagged_union()) for e in batch.events],
            batch.data_parallel_rank)


def test_event_batches_have_the_jax_packages_bytes():
    jev = importlib.import_module(f"{JAX_PKG}.kvevents.events")
    pev = importlib.import_module(f"{PORT_PKG}.kvevents.events")
    for jb, pb in zip(_batch_shapes(jev), _batch_shapes(pev)):
        assert pb.to_msgpack() == jb.to_msgpack()
        assert _rows(pev.EventBatch.from_msgpack(jb.to_msgpack())) == _rows(
            jev.EventBatch.from_msgpack(pb.to_msgpack()))
    unknown = msgpack.packb([1.0, [["FutureEvent", 1, 2], ["AllBlocksCleared"]]])
    assert _rows(pev.EventBatch.from_msgpack(unknown)) == _rows(
        jev.EventBatch.from_msgpack(unknown))


def test_xxh64_matches_xxhash_on_every_tail_length():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 1100, dtype=np.uint8).tobytes()
    for n in range(1101):
        assert intdigest(data[:n]) == xxhash.xxh64(data[:n]).intdigest(), n


# -- the block manager's prefix-caching switch --------------------------------


def _bm_run(pkg, enable):
    bm_mod = importlib.import_module(f"{pkg}.engine.block_manager")
    batches = []
    bm = bm_mod.BlockManager(
        bm_mod.BlockManagerConfig(n_pages=8, page_size=4, device_tier=TIER,
                                  enable_prefix_caching=enable),
        event_sink=batches.append,
    )
    seen = []
    tokens = list(range(1, 11))
    for _ in range(2):  # the second allocation would hit two cached pages
        state = bm.allocate(tokens)
        bm.commit_prefill(state)
        for t in (20, 21, 22):
            bm.append_token(state, t)
        bm.mark_decode_computed(state)
        seen.append((list(state.block_table), state.num_cached_tokens,
                     state.n_hashed_pages, bm.num_cached_pages))
        bm.free(state)
    bm.clear()
    events = [tuple(e.to_tagged_union()) for b in batches for e in b.events]
    return seen, events


@pytest.mark.parametrize("enable", [False, True], ids=["off", "on"])
def test_prefix_caching_switch_matches_jax(enable):
    port = _bm_run(PORT_PKG, enable)
    assert port == _bm_run(JAX_PKG, enable)
    seen, events = port
    if enable:
        assert seen[1][1] == 8 and any(e[0] == "BlockStored" for e in events)
    else:
        assert [s[1] for s in seen] == [0, 0]
        assert not any(e[0] == "BlockStored" for e in events)
        assert all(s[3] == 0 for s in seen)


# -- the event pool on both packages ------------------------------------------


def _side(pkg, backend="in_memory"):
    """One package's write-plane modules and a fresh index of `backend`."""
    m = SimpleNamespace(
        pkg=pkg,
        ev=importlib.import_module(f"{pkg}.kvevents.events"),
        pool=importlib.import_module(f"{pkg}.kvevents.pool"),
        key=importlib.import_module(f"{pkg}.kvcache.kvblock.key"),
        tp=importlib.import_module(f"{pkg}.kvcache.kvblock.token_processor"),
        index=importlib.import_module(f"{pkg}.kvcache.kvblock.index"),
        in_memory=importlib.import_module(f"{pkg}.kvcache.kvblock.in_memory"),
    )
    m.new_index = lambda size=1000, pods=10: m.index.new_index(m.index.IndexConfig(
        in_memory_config=m.in_memory.InMemoryIndexConfig(size=size, pod_cache_size=pods),
        sharded=backend == "sharded", num_shards=4))
    m.processor = m.tp.ChunkedTokenDatabase(m.tp.TokenProcessorConfig(block_size=BLOCK))
    return m


def _pool(m, index=None, **cfg):
    cfg.setdefault("concurrency", 2)
    hooks = {k: cfg.pop(k) for k in ("health_tracker", "message_filter", "popularity",
                                      "load_tracker", "divergence") if k in cfg}
    index = index if index is not None else m.new_index()
    return m.pool.EventPool(
        m.pool.EventPoolConfig(default_device_tier=TIER, **cfg), index, m.processor, **hooks)


def _msg(m, batch, pod="pod-1", seq=0, payload=None):
    return m.pool.Message(
        topic=f"kv@{pod}@{MODEL}", payload=payload if payload is not None else batch.to_msgpack(),
        seq=seq, pod_identifier=pod, model_name=MODEL)


def _contents(index):
    """Index contents as plain data: {request key: sorted (pod, tier)} and
    the engine -> request map."""
    view = index.export_view()
    entries = {(model, h): sorted(pods) for model, h, pods in view.entries}
    return entries, sorted(view.engine_map)


def _counters(pool):
    return dict(dropped=pool.dropped_events, lost=pool.removals_lost,
                filtered=pool.filtered_events, replay=pool.replay_skipped,
                pending=[len(d) for d in pool._pending_drop_removals])


def _run_started(pool, msgs):
    pool.start(with_subscriber=False)
    try:
        for msg in msgs:
            pool.add_task(msg)
        pool.drain()
        alive = pool.workers_alive()
    finally:
        pool.shutdown()
    return alive


def _scenario_digest(m):
    """Stores, DP ranks (valid and garbage), a medium override, parent chain
    continuation, an unknown parent, removals, per-pod ordering, LoRA ids
    (valid and garbage) and AllBlocksCleared, over three pods."""
    ev = m.ev
    t1, t2, t3 = [1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]
    batches = [
        ("pod-1", ev.EventBatch(0.0, [ev.BlockStored([100, 200], None, t1 + t2, 4)])),
        ("pod-1", ev.EventBatch(1.0, [ev.BlockStored([300], 200, t3, 4)])),
        ("pod-2", ev.EventBatch(0.0, [ev.BlockStored([100], None, t1, 4)], data_parallel_rank=0)),
        ("pod-2", ev.EventBatch(0.0, [ev.BlockStored([400], None, t2, 4)], data_parallel_rank=1)),
        ("pod-2", ev.EventBatch(0.0, [ev.BlockStored([500], None, t3, 4)],
                                data_parallel_rank="three")),
        ("pod-3", ev.EventBatch(0.0, [ev.BlockStored([600], None, t1, 4, medium="CPU")])),
        ("pod-3", ev.EventBatch(0.0, [ev.BlockStored([700], 999, t2, 4)])),
        ("pod-3", ev.EventBatch(0.0, [ev.BlockStored([800], None, t1, 4, lora_id=3)])),
        ("pod-3", ev.EventBatch(0.0, [ev.BlockStored([900], None, t3, 4, lora_id=-2)])),
        ("pod-3", ev.EventBatch(0.0, [ev.BlockStored([901], None, t2, 4, lora_id=True)])),
        ("pod-1", ev.EventBatch(2.0, [ev.BlockRemoved([300]), ev.AllBlocksCleared()])),
        ("pod-3", ev.EventBatch(2.0, [ev.BlockRemoved([600], medium="cpu")])),
        ("pod-3", ev.EventBatch(2.0, [ev.BlockRemoved([12345, b""])])),
    ]
    for _ in range(5):  # store-then-remove on one shard ends removed
        batches.append(("pod-2", ev.EventBatch(3.0, [ev.BlockStored([77], None, [7] * 4, 4)])))
        batches.append(("pod-2", ev.EventBatch(3.0, [ev.BlockRemoved([77])])))
    pool = _pool(m)
    alive = _run_started(pool, [_msg(m, b, pod) for pod, b in batches])
    return _contents(pool.index), _counters(pool), alive


def _scenario_sharding(m):
    """fnv32a(pod) % concurrency decides each message's queue. The key's pod
    cache holds all 12 pods: with the default 10, which pods survive would
    depend on the order the four workers run."""
    pool = _pool(m, index=m.new_index(pods=12), concurrency=4)
    pods = [f"pod-{i}" for i in range(12)]
    batch = m.ev.EventBatch(0.0, [m.ev.BlockStored([1], None, [1, 2, 3, 4], 4)])
    for i, pod in enumerate(pods):
        for _ in range(i % 3 + 1):
            pool.add_task(_msg(m, batch, pod))
    depths = pool.queue_depths()
    alive = _run_started(pool, [])
    return depths, _contents(pool.index), alive


def _store_msg(m, i, pod="pod-a", removal=False):
    ev = m.ev
    event = (ev.BlockRemoved(block_hashes=[i]) if removal else
             ev.BlockStored(block_hashes=[i], parent_block_hash=None,
                            token_ids=[i, i + 1, i + 2, i + 3], block_size=BLOCK))
    return _msg(m, ev.EventBatch(ts=float(i), events=[event]), pod, seq=i)


def _scenario_flood(m):
    """A stalled consumer: bounded queue, drop-oldest, counted; then the
    workers come up and land the freshest messages."""
    pool = _pool(m, concurrency=1, max_queue_depth=8)
    for i in range(300):
        pool.add_task(_store_msg(m, i))
    kept = [pool._queues[0].queue[j].seq for j in range(pool._queues[0].qsize())]
    before = _counters(pool)
    alive = _run_started(pool, [])
    return kept, before, _counters(pool), _contents(pool.index), alive


def _scenario_removal_cap(m):
    """Store-only victims retain nothing; removal-only victims are retained
    up to the cap, the oldest beyond it are counted lost (their entries
    stay stale), and the survivors evict on drain."""
    stalled = _pool(m, concurrency=1, max_queue_depth=1, max_pending_drop_removals=8)
    for i in range(40):
        stalled.add_task(_store_msg(m, i))
    stores = _counters(stalled)
    pool = _pool(m, concurrency=1)
    _run_started(pool, [_store_msg(m, 1000 + i) for i in range(30)])
    landed = _contents(pool.index)
    stalled = _pool(m, pool.index, concurrency=1, max_queue_depth=1,
                    max_pending_drop_removals=8)
    for i in range(30):
        stalled.add_task(_store_msg(m, 1000 + i, removal=True))
    pending = [d[2][0].block_hashes[0] for d in stalled._pending_drop_removals[0]]
    before = _counters(stalled)
    alive = _run_started(stalled, [])
    return stores, landed, pending, before, _counters(stalled), _contents(stalled.index), alive


def _scenario_inflight_store(m):
    """A dropped victim's removal lands after the in-flight store of the
    same block (applied by the shard worker, never by the producer)."""
    gate = SimpleNamespace(in_add=threading.Event(), release=threading.Event())
    index = m.new_index()
    inner_add = index.add

    def gated_add(engine_keys, request_keys, entries):
        gate.in_add.set()
        assert gate.release.wait(timeout=5.0)
        return inner_add(engine_keys, request_keys, entries)

    index.add = gated_add
    pool = _pool(m, index, concurrency=1, max_queue_depth=1)
    pool.start(with_subscriber=False)
    try:
        pool.add_task(_store_msg(m, 1))
        assert gate.in_add.wait(timeout=5.0)
        pool.add_task(_store_msg(m, 1, removal=True))
        pool.add_task(_store_msg(m, 99))
        dropped = pool.dropped_events
        gate.release.set()
        pool.drain()
        resolved = pool.index.get_request_key(m.key.Key(MODEL, 1))
    finally:
        gate.release.set()
        pool.shutdown()
    return dropped, resolved, _contents(pool.index)


def _scenario_floors_and_filter(m):
    """Seq floors skip replayed messages at or below the floor, clearing
    them lets the live stream through, and the message filter discards
    another replica's pods."""
    pool = _pool(m, message_filter=lambda msg: msg.pod_identifier != "pod-x")
    pool.set_seq_floors({("pod-a", f"kv@pod-a@{MODEL}"): 5})
    msgs = [_store_msg(m, i, "pod-a") for i in range(10)]
    msgs += [_store_msg(m, 50 + i, "pod-x") for i in range(3)]
    msgs += [_store_msg(m, 60 + i, "pod-b") for i in range(3)]
    alive = _run_started(pool, msgs)
    mid = _counters(pool)
    pool.clear_seq_floors()
    alive2 = _run_started(pool, [_store_msg(m, 2, "pod-a")])
    return mid, _counters(pool), _contents(pool.index), alive, alive2


def _mutate(payload, rng):
    """tests/test_event_wire_fuzz.py's mutations: truncation, byte flips,
    a garbage prefix, an empty frame, a map, tag confusion."""
    mode = rng.randrange(6)
    if mode == 0 and len(payload) > 2:
        return payload[: rng.randrange(1, len(payload))]
    if mode == 1:
        b = bytearray(payload)
        for _ in range(rng.randint(1, 4)):
            b[rng.randrange(len(b))] ^= rng.randrange(1, 256)
        return bytes(b)
    if mode == 2:
        return bytes(rng.randrange(256) for _ in range(rng.randint(1, 8))) + payload
    if mode == 3:
        return b""
    if mode == 4:
        return msgpack.packb({"not": "an event batch", "n": rng.randrange(99)})
    ts, events = msgpack.unpackb(payload, raw=False)
    if events and rng.random() < 0.5:
        events[0][0] = rng.choice([99, -1, "BlockStored", None])
    else:
        events = [[rng.randrange(3)]]
    return msgpack.packb([ts, events])


def _fuzz_payloads(seed):
    """Good and mutated payloads (made once, with JAX's events; the bytes are
    what the wire carries), as (pod, seq, payload) triples."""
    jev = importlib.import_module(f"{JAX_PKG}.kvevents.events")
    rng = random.Random(seed)
    out = []
    for i in range(150):
        tokens = list(range(i * BLOCK, (i + 1) * BLOCK))
        batch = jev.EventBatch(ts=float(i), events=[
            jev.BlockStored([10_000 + i], None, tokens, BLOCK),
            jev.BlockRemoved([10_000 + i - 3]) if i % 7 == 0 else jev.AllBlocksCleared(),
        ])
        payload = batch.to_msgpack()
        if rng.random() < 0.5:
            payload = _mutate(payload, rng)
        out.append((f"pod-{i % 3}", i, payload))
    return out


class _Recorder:
    """The duck-typed hooks (health tracker, popularity, load tracker,
    divergence), recording every call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("observe"):
            # repr: a fuzzed ts may decode to NaN, which equals nothing.
            return lambda *args, **kw: self.calls.append(repr((name, args, sorted(kw.items()))))
        raise AttributeError(name)


def _scenario_fuzz(m, seed):
    """Poison pills and fuzzed payloads among good ones, every hook wired:
    the workers live, and every decode result, index entry and hook call
    is the same on both packages."""
    decoded = []
    for _, _, payload in _fuzz_payloads(seed):
        try:
            decoded.append(repr(_rows(m.ev.EventBatch.from_msgpack(payload))))
        except Exception as e:  # noqa: BLE001 - compare which inputs raise
            decoded.append(("raised", isinstance(e, (ValueError, TypeError))))
    rec = _Recorder()
    pool = _pool(m, concurrency=1, health_tracker=rec, popularity=rec,
                 load_tracker=rec, divergence=rec)
    msgs = [_msg(m, None, pod, seq, payload) for pod, seq, payload in _fuzz_payloads(seed)]
    alive = _run_started(pool, msgs)
    return decoded, _contents(pool.index), rec.calls, alive


SCENARIOS = {
    "digest": _scenario_digest,
    "sharding": _scenario_sharding,
    "flood": _scenario_flood,
    "removal_cap": _scenario_removal_cap,
    "inflight_store": _scenario_inflight_store,
    "floors_and_filter": _scenario_floors_and_filter,
}


@pytest.mark.parametrize("backend", ["in_memory", "sharded"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pool_scenario_matches_jax(name, backend):
    jax_out = SCENARIOS[name](_side(JAX_PKG, backend))
    port_out = SCENARIOS[name](_side(PORT_PKG, backend))
    assert port_out == jax_out
    # Each scenario shows what it claims (not a vacuous agreement).
    if name == "digest":
        entries, _ = port_out[0]
        pods = {p for pods in entries.values() for p, _ in pods}
        assert {"pod-1", "pod-2@dp0", "pod-2@dp1", "pod-2", "pod-3"} <= pods
        assert ("pod-3", "cpu") not in {e for v in entries.values() for e in v}
        # t1, t1 -> t2, t2, t3 and LoRA t1; the removed chains are gone.
        assert len(entries) == 5
    elif name == "sharding":
        assert sum(port_out[0]) == 24 and sum(d > 0 for d in port_out[0]) >= 3
    elif name == "flood":
        kept, before, after, _, alive = port_out
        assert kept == list(range(292, 300)) and before["dropped"] == 292 and alive == 1
    elif name == "removal_cap":
        stores, landed, pending, before, final, contents, _ = port_out
        assert stores["dropped"] == 39 and stores["pending"] == [0] and stores["lost"] == 0
        assert len(landed[1]) == 30
        assert pending == list(range(1021, 1029)) and before["lost"] == 21
        assert final["lost"] == 21 and final["pending"] == [0]
        # The 21 lost removals leave their entries; the rest are evicted.
        assert sorted(h for _, h, _, _ in contents[1]) == list(range(1000, 1021))
    elif name == "inflight_store":
        assert port_out[0] == 1 and port_out[1] is None
    elif name == "floors_and_filter":
        mid, final, _, _, _ = port_out
        assert mid["replay"] == 6 and mid["filtered"] == 3 and final["replay"] == 6


@pytest.mark.parametrize("seed", [7, 99])
def test_pool_fuzzed_payloads_match_jax(seed):
    jax_out = _scenario_fuzz(_side(JAX_PKG), seed)
    port_out = _scenario_fuzz(_side(PORT_PKG), seed)
    assert port_out == jax_out
    decoded, (entries, _), calls, alive = port_out
    assert alive == 1
    assert any(isinstance(d, tuple) for d in decoded) and entries
    assert {c.split("'")[1] for c in calls} >= {
        "observe_batch", "observe_decode_failure", "observe_store", "observe_removed_blocks",
        "observe_orphan_removal"}


def test_digest_batch_is_the_pools_digest():
    """kvevents/digest.py runs the pool's own digest in the caller's thread:
    the same index as the pool's workers over the same batches."""
    from llm_d_kv_cache_manager_tpu_torch.kvevents.digest import digest_batch

    m = _side(PORT_PKG)
    ev = m.ev
    batches = [ev.EventBatch(0.0, [ev.BlockStored([1, 2], None, list(range(8)), 4)]),
               ev.EventBatch(1.0, [ev.BlockStored([3], 2, [9, 9, 9, 9], 4, lora_id=1)]),
               ev.EventBatch(2.0, [ev.BlockRemoved([1]), ev.AllBlocksCleared()])]
    index = m.new_index()
    for b in batches:
        digest_batch(index, m.processor, "pod-1", MODEL, b)
    pool = _pool(m)
    _run_started(pool, [_msg(m, b) for b in batches])
    assert _contents(index) == _contents(pool.index)
    assert _contents(index)[0]
