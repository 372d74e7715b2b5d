"""The port's transfer library, connector and host-tier pods, on the CPU.

The port builds its own copy of the C++ transfer engine
(kv_connectors/cpp/kv_transfer.cpp) with the C++ compiler into its build/
directory at first use; these tests skip, with a reason, only when no C++
compiler is found, and fail on a build error.

- the server and the pooled client: round trips, the batched fetch against
  the serial one byte for byte, checksums and corruption, the breaker, the
  hedge, bounded failure against a dead peer;
- KVConnector: offload/restore of torch page pairs (bf16 through a uint8
  view), the async offload queue, drop, onboard;
- host-tier pods of both packages (the JAX pod is lent the port's library
  for the test) running the reference package's host-tier sequences (offload
  on reclaim, the host capacity bound, restore on a miss, eager staging with
  an overwrite before the admit, a two-pod onboard through the index): the
  same tokens and tier-store stats, and the same event streams once the JAX
  pod's media ("hbm", "host") are read as the port's ("gpu", "cpu").
"""

import os
import shutil
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import CFG

from llm_d_kv_cache_manager_tpu.engine.costs import ALWAYS_TRANSFER as JAX_ALWAYS
from llm_d_kv_cache_manager_tpu.engine.engine import (
    EnginePod as JaxEnginePod,
    EnginePodConfig as JaxEnginePodConfig,
)
from llm_d_kv_cache_manager_tpu.engine.tiering import (
    IndexBackedPeerResolver as JaxResolver,
)
from llm_d_kv_cache_manager_tpu.kv_connectors import connector as jax_connector
from llm_d_kv_cache_manager_tpu.kvcache.kvblock.in_memory import InMemoryIndex as JaxIndex
from llm_d_kv_cache_manager_tpu.kvcache.kvblock.token_processor import (
    ChunkedTokenDatabase as JaxTokenDatabase,
    TokenProcessorConfig as JaxTokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu.kvevents.pool import EventPool, EventPoolConfig, Message
from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu_torch.engine.costs import ALWAYS_TRANSFER
from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig
from llm_d_kv_cache_manager_tpu_torch.engine.tiering import IndexBackedPeerResolver, TieredKVStore
from llm_d_kv_cache_manager_tpu_torch.kv_connectors import connector
from llm_d_kv_cache_manager_tpu_torch.kv_connectors.connector import (
    BlockTransferServer,
    KVConnector,
    KVConnectorConfig,
    TransferClient,
    TransferClientConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import InMemoryIndex
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.digest import digest_batch
from llm_d_kv_cache_manager_tpu_torch.kvevents.events import BlockRemoved, BlockStored
from llm_d_kv_cache_manager_tpu_torch.models import llama
from llm_d_kv_cache_manager_tpu_torch.ops import _build

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ compiler (g++ or c++) to build the port's transfer library",
)

PAGE = 4
LOGITS_TOL = dict(atol=1e-4, rtol=0)  # tests/test_torch_llama.py
MEDIA = {"hbm": "gpu", "host": "cpu"}  # the JAX pod's media, read as the port's


def _dead_port() -> int:
    """A loopback port with nothing listening on it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the library ----------------------------------------------------------------


def test_library_builds_into_the_port_build_dir():
    lib = connector._library()
    path = _build.library_path(_build.TRANSFER)
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.name.startswith(f"lib{_build.TRANSFER}_")
    assert lib is _build.library(_build.TRANSFER)
    # The JAX package's copy is never written (its `transfer` tests stay as
    # they were).
    assert not (_build.TRANSFER_SOURCE.parent / "libkvtransfer.so").exists()
    assert "KVTPU_TRANSFER_LIB" not in os.environ


def test_build_error_raises_with_the_compiler_log(monkeypatch, tmp_path):
    bad = tmp_path / "kv_transfer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "TRANSFER_SOURCE", bad)
    with pytest.raises(RuntimeError, match="native library build failed") as err:
        _build.build([_build.TRANSFER])
    assert "kv_transfer.cpp" in str(err.value)  # the compiler's own message


# -- server and client ------------------------------------------------------------


class TestTransferEngine:
    def test_put_fetch_roundtrip_and_checksum(self):
        server = BlockTransferServer()
        client = TransferClient()
        try:
            data = os.urandom(4096)
            server.put(0xDEADBEEF, data)
            got = client.fetch_one("127.0.0.1", server.port, 0xDEADBEEF, 8192)
            assert got == data
            assert connector.checksum(got) == connector.checksum(data)
            assert connector.checksum(data[:-1] + b"x") != connector.checksum(data)
        finally:
            client.close()
            server.close()

    def test_empty_missing_remove_and_cross_pod(self):
        pod_a, pod_b = BlockTransferServer(), BlockTransferServer()
        client = TransferClient()
        try:
            pod_a.put(3, b"")
            pod_a.put(1, b"a-block")
            pod_b.put(2, b"b-block" * 2)
            assert client.fetch_one("127.0.0.1", pod_a.port, 3, 64) == b""
            assert client.fetch_one("127.0.0.1", pod_a.port, 4, 64) is None
            assert client.fetch_one("127.0.0.1", pod_b.port, 2, 64) == b"b-block" * 2
            assert client.fetch_one("127.0.0.1", pod_a.port, 2, 64) is None
            assert pod_a.block_count() == 2
            assert pod_a.remove(1) and not pod_a.remove(1)
            assert pod_a.block_count() == 1
            assert client.stats["missing_blocks"] == 2
        finally:
            client.close()
            pod_a.close()
            pod_b.close()

    def test_batched_fetch_matches_serial_byte_for_byte(self):
        server = BlockTransferServer()
        client = TransferClient(TransferClientConfig(max_batch=3))
        try:
            data = {h: os.urandom(512 + h) for h in range(1, 9)}
            data[5] = b""
            for h, payload in data.items():
                server.put(h, payload)
            hashes = [3, 1, 99, 5, 8, 2, 77, 4, 6, 7]
            batched = client.fetch_many("127.0.0.1", server.port, hashes, 4096)
            serial = [client.fetch_one("127.0.0.1", server.port, h, 4096) for h in hashes]
            assert batched == serial == [data.get(h) for h in hashes]
            assert client.stats["connects"] == 1  # one pooled connection
            assert client.stats["batch_fetches"] == 4 + len(hashes)  # max_batch 3
        finally:
            client.close()
            server.close()

    def test_large_block_and_oversized(self):
        server = BlockTransferServer()
        client = TransferClient()
        try:
            data = os.urandom(2 * 1024 * 1024)
            server.put(99, data)
            assert client.fetch_one("127.0.0.1", server.port, 99, len(data)) == data
            assert client.fetch_one("127.0.0.1", server.port, 99, len(data) - 1) is None
            assert client.stats["oversized_blocks"] == 1
            # The oversized reply was drained: the connection still serves.
            assert client.fetch_one("127.0.0.1", server.port, 99, len(data)) == data
        finally:
            client.close()
            server.close()

    def test_corruption_detected_counted_and_breaker_charged(self):
        server = BlockTransferServer()
        client = TransferClient(TransferClientConfig(breaker_failure_threshold=0))
        try:
            data = os.urandom(1024)
            server.put(11, data)
            assert client.fetch_one("127.0.0.1", server.port, 11, 4096) == data
            assert server.corrupt(11)
            assert client.fetch_one("127.0.0.1", server.port, 11, 4096) is None
            assert client.stats["corrupt_blocks"] == 1
            assert client.peer_state("127.0.0.1", server.port).corrupt_blocks == 1
            assert not server.corrupt(12)
            # The v1 wire (no checksum) lands the flipped byte.
            v1 = TransferClient(TransferClientConfig(verify_integrity=False))
            got = v1.fetch_one("127.0.0.1", server.port, 11, 4096)
            assert got is not None and got != data and got[1:] == data[1:]
            v1.close()
        finally:
            client.close()
            server.close()

    def test_dead_peer_is_a_bounded_counted_miss_and_opens_the_breaker(self):
        port = _dead_port()
        client = TransferClient(TransferClientConfig(
            connect_timeout_ms=200, io_timeout_ms=200, retries=0,
            breaker_failure_threshold=2, breaker_cooldown_s=60.0,
        ))
        try:
            for _ in range(2):
                assert client.fetch_many("127.0.0.1", port, [1, 2], 64) == [None, None]
            assert client.stats["failures"] == 2
            assert client.peer_state("127.0.0.1", port).breaker.state == "open"
            t0 = time.monotonic()
            assert client.fetch_many("127.0.0.1", port, [3], 64) == [None]
            assert time.monotonic() - t0 < 0.1  # skipped: no connect attempt
            assert client.stats["breaker_skipped_blocks"] == 1
            peers = client.status()["peers"]
            assert peers[f"127.0.0.1:{port}"]["state"] == "open"
        finally:
            client.close()

    def test_breaker_half_open_probe_closes_on_success(self):
        clock = [0.0]
        server = BlockTransferServer()
        server.put(1, b"x")
        client = TransferClient(TransferClientConfig(
            connect_timeout_ms=200, io_timeout_ms=200, retries=0,
            breaker_failure_threshold=1, breaker_cooldown_s=5.0,
        ), clock=lambda: clock[0])
        transitions = []
        client.on_breaker_transition = lambda *t: transitions.append(t)
        try:
            client.note_result("127.0.0.1", server.port, ok=False, latency_s=0.0)
            assert client.fetch_one("127.0.0.1", server.port, 1, 8) is None  # open
            clock[0] = 6.0
            assert client.fetch_one("127.0.0.1", server.port, 1, 8) == b"x"  # the probe
            key = f"127.0.0.1:{server.port}"
            assert transitions == [(key, "closed", "open"), (key, "open", "half_open"),
                                   (key, "half_open", "closed")]
        finally:
            client.close()
            server.close()

    def test_hedged_fetch_wins_from_second_holder_when_primary_dead(self):
        pod_b = BlockTransferServer()
        data = {h: os.urandom(256 + h) for h in (1, 2, 3)}
        for h, payload in data.items():
            pod_b.put(h, payload)
        client = TransferClient(TransferClientConfig(
            connect_timeout_ms=200, io_timeout_ms=200, retries=0,
            breaker_failure_threshold=0,
        ))
        try:
            out = client.fetch_many_hedged(
                [("127.0.0.1", _dead_port()), ("127.0.0.1", pod_b.port)], [1, 2, 3], 4096)
            assert out == [data[1], data[2], data[3]]
            assert client.stats["hedges"] >= 1 and client.stats["hedge_wins"] == 1
            # One holder: a plain fetch.
            assert client.fetch_many_hedged([("127.0.0.1", pod_b.port)], [2], 4096) == [data[2]]
            assert client.fetch_many_hedged([], [2], 4096) == [None]
        finally:
            client.close()
            pod_b.close()

    def test_fetch_after_server_death_is_bounded(self):
        server = BlockTransferServer()
        port = server.port
        client = TransferClient(TransferClientConfig(
            connect_timeout_ms=400, io_timeout_ms=400, retries=1))
        try:
            server.put(1, b"alive")
            assert client.fetch_one("127.0.0.1", port, 1, 64) == b"alive"
            server.close()  # the peer dies with the keep-alive connection open
            t0 = time.time()
            assert client.fetch_many("127.0.0.1", port, [1, 2, 3], 64) == [None] * 3
            assert time.time() - t0 < 5.0
            assert client.stats["failures"] >= 1
        finally:
            client.close()

    def test_miss_feedback_sweep_and_forget(self):
        clock = [0.0]
        server = BlockTransferServer()
        server.put(1, b"x")
        misses = []
        client = TransferClient(TransferClientConfig(peer_idle_ttl_s=10.0),
                                clock=lambda: clock[0],
                                on_fetch_misses=lambda *a: misses.append(a))
        try:
            assert client.fetch_many("127.0.0.1", server.port, [1, 2], 8) == [b"x", None]
            assert misses == [("127.0.0.1", server.port, [1, 2], [2])]
            assert client.entries() == 2
            clock[0] = 20.0
            assert client.sweep_idle() == 2 and client.entries() == 0
            client.fetch_one("127.0.0.1", server.port, 1, 8)
            assert client.forget_host("127.0.0.1") == 2 and client.entries() == 0
            assert client.status()["stats"]["reaped_peers"] == 1
        finally:
            client.close()
            server.close()


# -- the connector ------------------------------------------------------------------


class TestKVConnector:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_offload_restore_roundtrip(self, dtype):
        events = []
        conn = KVConnector(event_sink=events.append)
        try:
            k = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8).to(dtype) / 7
            v = k + 1
            conn.offload(123, k, v, token_ids=list(range(16)), block_size=16)
            ev = events[-1].events[0]
            assert isinstance(ev, BlockStored) and ev.medium == "cpu"
            assert ev.block_hashes == [123]
            got = conn.restore(123, torch.empty_like(k), torch.empty_like(v))
            assert got[0].dtype == dtype and torch.equal(got[0], k) and torch.equal(got[1], v)
            raw = conn.fetch_staged(123, 1 << 16)
            assert raw == k.view(torch.uint8).numpy().tobytes() + v.view(torch.uint8).numpy().tobytes()
        finally:
            conn.close()

    def test_onboard_from_remote_pod_and_drop(self):
        events_a, events_b = [], []
        pod_a = KVConnector(event_sink=events_a.append)
        pod_b = KVConnector(event_sink=events_b.append)
        try:
            k, v = torch.full((4, 4), 3.0), torch.full((4, 4), 5.0)
            pod_a.offload(55, k, v, token_ids=[1, 2, 3, 4], block_size=4)
            got = pod_b.onboard("127.0.0.1", pod_a.port, 55, k, v,
                                token_ids=[1, 2, 3, 4], block_size=4)
            assert torch.equal(got[0], k) and torch.equal(got[1], v)
            assert events_b[-1].events[0].medium == "gpu"  # landed on the device tier
            pod_a.drop(55)
            assert isinstance(events_a[-1].events[0], BlockRemoved)
            assert events_a[-1].events[0].medium == "cpu"
            assert pod_a.restore(55, k, v) is None
            with pytest.raises(ValueError, match="payload size"):
                pod_a.stage(56, b"xyz", [1], 1)
                pod_a.restore(56, k, v)
        finally:
            pod_a.close()
            pod_b.close()

    def test_offload_async_drains_in_dispatch_order_and_bounds_inflight(self):
        events = []
        conn = KVConnector(KVConnectorConfig(max_inflight_offloads=3), event_sink=events.append)
        try:
            pages = {}
            for i in range(5):
                k = torch.arange(8, dtype=torch.float32) + i
                pages[100 + i] = (k, k * 2)
                conn.offload_async(100 + i, k, k * 2, token_ids=[i], block_size=1)
                k += 100  # a later write to the page: the snapshot holds
            assert conn.pending_offloads == 3 and conn.server.block_count() == 2
            assert conn.drain_offloads() == [102, 103, 104]
            assert conn.pending_offloads == 0
            for h, (k, v) in pages.items():
                want = ((k - 100).numpy().tobytes() + (v).numpy().tobytes())
                assert conn.fetch_staged(h, 1 << 16) == want
            assert [e.block_hashes[0] for b in events for e in b.events] == list(pages)
        finally:
            conn.close()

    def test_transfer_ici_is_a_device_copy(self):
        pages = (torch.ones(2, 2), torch.zeros(2, 2))
        out = KVConnector.transfer_ici(pages, "cpu")
        assert all(torch.equal(a, b) for a, b in zip(out, pages))
        assert torch.equal(KVConnector.transfer_ici(pages[0], "cpu"), pages[0])

    def test_load_chain_degrades_on_dead_peer(self):
        from test_torch_tiering import counting_codec
        from llm_d_kv_cache_manager_tpu_torch.engine.tiering import PageCodec

        conn = KVConnector(KVConnectorConfig(connect_timeout_ms=300, fetch_timeout_ms=300,
                                             fetch_retries=0))
        port = _dead_port()
        store = TieredKVStore(conn, counting_codec(PageCodec),
                              peer_resolver=lambda h: ("127.0.0.1", port))
        try:
            t0 = time.time()
            landed = store.load_chain([(1, [0], None), (2, [1], None)], lambda k: list(range(k)))
            assert landed == [] and time.time() - t0 < 5.0
            assert store.stats["onboards"] == 0
        finally:
            store.close()
            conn.close()


# -- host-tier pods on both packages ---------------------------------------------


@pytest.fixture
def jax_lib(monkeypatch):
    """Lend the JAX package's connector the port's library for one test (no
    file of the JAX package changes, and its own copy stays unbuilt)."""
    lib = connector._library()
    jax_connector._configure_lib(lib)
    monkeypatch.setattr(jax_connector, "_lib", lib)
    return lib


def _event_rows(batches, jax_side):
    rows = []
    for b in batches:
        for e in b.events:
            row = list(e.to_tagged_union())
            if jax_side and row[-1] in MEDIA:
                row[-1] = MEDIA[row[-1]]
            rows.append(tuple(row))
    return rows


class _TierPair:
    """A host-tier pod on each package, one f32 parameter tree."""

    def __init__(self, n_pages, int8=False, pod_id="pod-t", sinks=None, params=None, **over):
        jcfg = jax_llama.LlamaConfig(**CFG, dtype=jnp.float32)
        jparams = params or jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
        np_params = jax.tree_util.tree_map(np.asarray, jparams)
        self.jax_events, self.port_events = [], []
        sinks = sinks or (self.jax_events.append, self.port_events.append)
        common = dict(pod_id=pod_id, model_name="m", n_pages=n_pages, page_size=PAGE,
                      max_pages_per_seq=8, use_quantized_kv=int8, enable_host_tier=True,
                      **over)
        self.jax = self.port = None
        try:
            self.jax = JaxEnginePod(
                JaxEnginePodConfig(**common, device_tier="hbm", with_model=True,
                                   model_config=jcfg, transfer_cost_model=JAX_ALWAYS),
                event_sink=sinks[0], params=jparams)
            self.port = EnginePod(
                EnginePodConfig(**common, device_tier="gpu", device="cpu",
                                model_config=llama.LlamaConfig(**CFG, dtype=torch.float32),
                                transfer_cost_model=ALWAYS_TRANSFER),
                event_sink=sinks[1], params=llama.params_from_jax(np_params, device="cpu"))
        except BaseException:
            self.close()
            raise
        self.jparams = jparams

    def pods(self):
        return (("jax", self.jax, jnp.argmax), ("port", self.port, torch.argmax))

    def run(self, steps):
        """Each step is (prompt, n_decode, free): prefill, greedy decode, and
        free or keep. Returns {side: [(cached, tokens)]}."""
        out = {}
        for side, pod, argmax in self.pods():
            results = []
            for prompt, n_decode, free in steps:
                state, cached = pod.prefill(prompt)
                tokens = [int(argmax(pod.last_logits))]
                if n_decode:
                    pod.decode_append(state, tokens[0])
                    tokens += [pod.decode_step(state) for _ in range(n_decode)]
                if free:
                    pod.free(state)
                results.append((cached, tokens))
            out[side] = results
        return out

    def check_same(self, out):
        assert out["port"] == out["jax"]
        assert self.port.tier_store.stats == self.jax.tier_store.stats
        assert self.port.tier_store.staged_count == self.jax.tier_store.staged_count
        assert _event_rows(self.port_events, False) == _event_rows(self.jax_events, True)

    def close(self):
        for pod in (self.jax, self.port):
            if pod is not None:
                pod.close()


def _media(rows, kind, medium):
    return [r for r in rows if r[0] == kind and r[-1] == medium]


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_offload_on_reclaim_matches_jax(jax_lib, int8):
    pair = _TierPair(n_pages=4, int8=int8)
    try:
        out = pair.run([(list(range(16)), 0, True), ([90 + i for i in range(8)], 0, True)])
        pair.check_same(out)
        rows = _event_rows(pair.port_events, False)
        assert pair.port.tier_store.stats["offloads"] == 2
        assert pair.port.connector.server.block_count() == 2
        stored = _media(rows, "BlockStored", "cpu")
        assert len(stored) == 2 and stored[0][3] == list(range(4)) and stored[0][2] is None
        assert sum(len(r[1]) for r in _media(rows, "BlockRemoved", "gpu")) == 2
    finally:
        pair.close()


def test_host_capacity_bound_matches_jax(jax_lib):
    pair = _TierPair(n_pages=4, host_capacity_blocks=2)
    try:
        out = pair.run([(list(range(16)), 0, True), ([90 + i for i in range(16)], 0, True)])
        pair.check_same(out)
        stats = pair.port.tier_store.stats
        assert stats["offloads"] == 4 and stats["host_evictions"] == 2
        assert pair.port.tier_store.staged_count == pair.port.connector.server.block_count() == 2
        assert len(_media(_event_rows(pair.port_events, False), "BlockRemoved", "cpu")) == 2
    finally:
        pair.close()


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("lora_id", [None, 7])
def test_restore_on_miss_matches_jax(jax_lib, int8, lora_id):
    pair = _TierPair(n_pages=6, int8=int8)
    prefix = list(range(16))
    try:
        out = {}
        for side, pod, argmax in pair.pods():
            s1, _ = pod.prefill(prefix + [50, 51], lora_id=lora_id)
            first = int(argmax(pod.last_logits))
            pod.free(s1)
            s2, _ = pod.prefill([90 + i for i in range(20)], lora_id=lora_id)  # reclaims
            pod.free(s2)
            s3, cached = pod.prefill(prefix + [50, 51], lora_id=lora_id)
            again = int(argmax(pod.last_logits))
            pod.decode_append(s3, again)
            tokens = [pod.decode_step(s3) for _ in range(5)]
            pod.free(s3)
            out[side] = (first, again, cached, tokens)
        pair.check_same({"jax": out["jax"], "port": out["port"]})
        first, again, cached, _ = out["port"]
        assert cached == 16 and first == again
        stats = pair.port.tier_store.stats
        assert stats["restores"] >= 4 and stats["offloads"] >= 4
        rows = _event_rows(pair.port_events, False)
        assert all(r[5] == lora_id for r in _media(rows, "BlockStored", "cpu"))
    finally:
        pair.close()


def test_restore_decodes_like_a_resident_prefix(jax_lib):
    """On the port: a prefix restored from the host store gives the same
    suffix logits and greedy tokens as the same prefix left resident."""
    pair = _TierPair(n_pages=8)
    roomy = EnginePod(EnginePodConfig(n_pages=32, page_size=PAGE, device="cpu",
                                      max_pages_per_seq=8, model_config=pair.port._model_config),
                      params=pair.port.params)
    prefix, suffix = list(range(16)), [50, 51, 52]
    try:
        outs = []
        for pod, evict in ((pair.port, True), (roomy, False)):
            s1, _ = pod.prefill(prefix + [60])
            pod.free(s1)
            if evict:
                s2, _ = pod.prefill([90 + i for i in range(28)])
                pod.free(s2)
            state, cached = pod.prefill(prefix + suffix)
            logits = pod.last_logits.clone()
            pod.decode_append(state, int(torch.argmax(logits)))
            tokens = [pod.decode_step(state) for _ in range(6)]
            outs.append((cached, logits, tokens))
        assert outs[0][0] == outs[1][0] == 16
        assert pair.port.tier_store.stats["restores"] >= 4
        torch.testing.assert_close(outs[0][1], outs[1][1], atol=0, rtol=0)
        assert outs[0][2] == outs[1][2]
    finally:
        pair.close()
        roomy.close()


def test_eager_stage_survives_overwrite_matches_jax(jax_lib):
    """With eager_stage, free() snapshots committed pages; a reclaim that
    overwrites them before the background admit runs still stages the
    pre-overwrite bytes, with no extract on the allocation path."""
    pair = _TierPair(n_pages=8, eager_stage=True)
    rng = np.random.RandomState(9)
    prompt_a = rng.randint(0, CFG["vocab_size"], size=16).tolist()
    prompt_b = rng.randint(0, CFG["vocab_size"], size=32).tolist()
    try:
        staged = {}
        for side, pod, _ in pair.pods():
            state_a, _ = pod.prefill(prompt_a)
            blocks_a = list(pod.block_manager.committed_blocks(state_a))
            assert len(blocks_a) == 4
            truth = dict(zip([b[0] for b in blocks_a],
                             pod.tier_store.codec.extract_many([b[3] for b in blocks_a])))
            pod.free(state_a)  # snapshots start here
            extracts = []
            real = pod.tier_store.codec.extract_many
            pod.tier_store.codec.extract_many = lambda ids: extracts.append(len(ids)) or real(ids)
            state_b, _ = pod.prefill(prompt_b)  # reclaims every page of A
            pod.tier_store.codec.extract_many = real
            pod.tier_store.drain_async_stages()
            assert extracts == []
            assert pod.tier_store.staged_count >= 4
            for chunk_hash, expected in truth.items():
                assert pod.connector.fetch_staged(chunk_hash, len(expected) + 64) == expected
            staged[side] = truth
            pod.free(state_b)  # eager snapshots of B's pages
            pod.tier_store.drain_async_stages()
        assert staged["port"].keys() == staged["jax"].keys()
        for h, payload in staged["port"].items():  # f32 KV of one computation
            np.testing.assert_allclose(np.frombuffer(payload, np.float32),
                                       np.frombuffer(staged["jax"][h], np.float32), atol=1e-5)
        assert pair.port.tier_store.stats == pair.jax.tier_store.stats
        assert _event_rows(pair.port_events, False) == _event_rows(pair.jax_events, True)
    finally:
        pair.close()


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_two_pod_onboard_through_the_index_matches_jax(jax_lib, int8):
    """Pod A exports a prefix; pod B, resolving holders through the index
    that digests both pods' events, onboards it over loopback TCP: the same
    on both packages, and B's suffix logits equal A's own prefix-hit ones."""
    model = "m"
    jax_index = JaxIndex()
    jax_proc = JaxTokenDatabase(JaxTokenProcessorConfig(block_size=PAGE))
    pool = EventPool(EventPoolConfig(concurrency=1), jax_index, jax_proc)
    pool.start(with_subscriber=False)
    port_index = InMemoryIndex()
    port_proc = ChunkedTokenDatabase(TokenProcessorConfig(block_size=PAGE))

    def sinks(pod_id):
        def jax_sink(batch):
            pool.add_task(Message(topic=f"kv@{pod_id}@{model}", payload=batch.to_msgpack(),
                                  seq=0, pod_identifier=pod_id, model_name=model))

        def port_sink(batch):
            digest_batch(port_index, port_proc, pod_id, model, batch)
        return jax_sink, port_sink

    pair_a = pair_b = None
    try:
        pair_a = _TierPair(n_pages=16, int8=int8, pod_id="pod-a", sinks=sinks("pod-a"))
        pair_b = _TierPair(n_pages=16, int8=int8, pod_id="pod-b", sinks=sinks("pod-b"),
                           params=pair_a.jparams)
        rng = np.random.RandomState(3)
        prompt = rng.randint(0, CFG["vocab_size"], size=19).tolist()
        results = {}
        for side, index, resolver_cls, host in (
                ("jax", jax_index, JaxResolver, "host"),
                ("port", port_index, IndexBackedPeerResolver, "cpu")):
            pod_a, pod_b = getattr(pair_a, side), getattr(pair_b, side)
            argmax = jnp.argmax if side == "jax" else torch.argmax
            state_a, _ = pod_a.prefill(prompt)
            assert pod_a.export_sequence(state_a) == 4
            pool.drain()
            pod_b.set_peer_resolver(resolver_cls(
                index, model, {"pod-a": pod_a.transfer_address}, "pod-b", host_tier=host))
            state_b, cached_b = pod_b.prefill(prompt)
            logits_b = np.asarray(pod_b.last_logits, dtype=np.float32)
            pod_b.decode_append(state_b, int(argmax(pod_b.last_logits)))
            tokens_b = [pod_b.decode_step(state_b) for _ in range(4)]
            _, cached_a2 = pod_a.prefill(prompt)
            np.testing.assert_allclose(
                logits_b, np.asarray(pod_a.last_logits, dtype=np.float32), **LOGITS_TOL)
            pool.drain()
            results[side] = (cached_b, cached_a2, tokens_b, dict(pod_b.tier_store.stats),
                             logits_b)
        assert results["port"][:4] == results["jax"][:4]
        np.testing.assert_allclose(results["port"][4], results["jax"][4], **LOGITS_TOL)
        assert results["port"][0] == 16 and results["port"][3]["onboards"] == 4
        for pair in (pair_a, pair_b):
            assert _event_rows(pair.port_events, False) == _event_rows(pair.jax_events, True)
        keys = port_proc.tokens_to_kv_block_keys(None, prompt, model)
        hits = port_index.lookup(keys, set())
        assert all(any(e.pod_identifier == "pod-b" and e.device_tier == "gpu"
                       for e in hits.get(k, [])) for k in keys)
    finally:
        for pair in (pair_a, pair_b):
            if pair is not None:
                pair.close()
        pool.shutdown()


def test_prefetch_and_warm_chain(jax_lib):
    """The pod's prefetch fills the ready buffer off the serving thread and
    the next allocation lands from it; warm_chain lands a restorable chain
    without computing and is idempotent."""
    pair = _TierPair(n_pages=6)
    pod = pair.port
    try:
        prefix = list(range(16))
        s1, _ = pod.prefill(prefix + [60])
        pod.free(s1)
        s2, _ = pod.prefill([90 + i for i in range(24)])  # reclaims the whole prefix
        pod.free(s2)
        keys = pod.block_manager.token_db.tokens_to_kv_block_keys(None, prefix, "")
        hashes = [k.chunk_hash for k in keys]
        n_host = len(pod.resident_block_digest(host_hashes=hashes)["host"])
        assert n_host == 4 and pod.resident_prefix_blocks(hashes) == 0
        assert pod.prefetch(prefix) == 4
        deadline = time.monotonic() + 5
        while pod.tier_store.stats["prefetched"] < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pod.tier_store.stats["prefetched"] == 4
        assert pod.warm_chain(prefix) == 4
        assert pod.tier_store.stats["ready_hits"] == 4
        assert pod.resident_prefix_blocks(hashes) == 4
        assert pod.warm_chain(prefix) == 0  # already resident
        assert pod.prefetch_hashes(hashes) == 0
        digest = pod.resident_block_digest(device_hashes=hashes, max_extra=2)
        assert digest["device"] == set(hashes) and len(digest["extra_device"]) == 2
    finally:
        pair.close()
