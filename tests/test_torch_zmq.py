"""The port's write plane over real ZMQ, in both directions.

- a port `Publisher` into a JAX `EventPool`;
- a JAX `Publisher` into a port `EventPool`;
- a port pod with `zmq_endpoint` set into a port `EventPool`.

Each index must equal the one in-process digestion of the same batches
gives. Endpoints are `ipc://` under the test's own tmp_path. No fixed
sleeps: a subscriber is known to be joined when an empty probe batch
published in a loop reaches the pool's health hook, and every wait has a
deadline of at most 5 s.
"""

import importlib
import threading
import time

import pytest
import torch

pytest.importorskip("zmq")

from llm_d_kv_cache_manager_tpu_torch.engine.engine import EnginePod, EnginePodConfig  # noqa: E402
from llm_d_kv_cache_manager_tpu_torch.models import llama  # noqa: E402

JAX_PKG = "llm_d_kv_cache_manager_tpu"
PORT_PKG = "llm_d_kv_cache_manager_tpu_torch"
MODEL = "m"
BLOCK = 4
DEADLINE_S = 5.0


class _Seen:
    """Duck-typed health hook: records the seq of every decoded batch."""

    def __init__(self):
        self.seqs = []
        self.cond = threading.Condition()

    def observe_batch(self, pod, topic, seq, ts):
        with self.cond:
            self.seqs.append(seq)
            self.cond.notify_all()

    def observe_decode_failure(self, pod):
        pass

    def wait(self, predicate) -> bool:
        with self.cond:
            return self.cond.wait_for(lambda: predicate(self.seqs), timeout=DEADLINE_S)


def _mods(pkg):
    return {name: importlib.import_module(f"{pkg}.{path}") for name, path in (
        ("ev", "kvevents.events"), ("pool", "kvevents.pool"), ("pub", "kvevents.publisher"),
        ("tp", "kvcache.kvblock.token_processor"), ("index", "kvcache.kvblock.index"),
    )}


def _subscribed_pool(pkg, endpoint, sharded):
    m = _mods(pkg)
    index = m["index"].new_index(m["index"].IndexConfig(sharded=sharded))
    tp = m["tp"].ChunkedTokenDatabase(m["tp"].TokenProcessorConfig(block_size=BLOCK))
    seen = _Seen()
    pool = m["pool"].EventPool(
        m["pool"].EventPoolConfig(zmq_endpoint=endpoint, concurrency=2,
                                  default_device_tier="gpu"),
        index, tp, health_tracker=seen,
    )
    pool.start(with_subscriber=True)
    return pool, seen


def _join(publish_probe, seen):
    """Publish empty probe batches until one arrives (ZMQ's slow joiner:
    a PUB drops what it sends before the subscription reaches it)."""
    deadline = time.monotonic() + DEADLINE_S
    while time.monotonic() < deadline:
        publish_probe()
        with seen.cond:
            if seen.cond.wait_for(lambda: seen.seqs, timeout=0.05):
                return
    raise AssertionError("subscriber never joined")


def _contents(index):
    view = index.export_view()
    return ({(m, h): sorted(p) for m, h, p in view.entries}, sorted(view.engine_map))


def _in_process(batches_by_pod, sharded):
    """The same batches' bytes digested in the caller's thread by a port
    pool that runs no worker (its `_process_event`)."""
    m = _mods(PORT_PKG)
    index = m["index"].new_index(m["index"].IndexConfig(sharded=sharded))
    tp = m["tp"].ChunkedTokenDatabase(m["tp"].TokenProcessorConfig(block_size=BLOCK))
    pool = m["pool"].EventPool(m["pool"].EventPoolConfig(default_device_tier="gpu"), index, tp)
    for pod, batches in batches_by_pod.items():
        for seq, batch in enumerate(batches):
            pool._process_event(m["pool"].Message(
                topic=f"kv@{pod}@{MODEL}", payload=batch.to_msgpack(), seq=seq,
                pod_identifier=pod, model_name=MODEL))
    return _contents(index)


def _traffic(ev):
    t = list(range(1, 13))
    return [
        ev.EventBatch(0.0, [ev.BlockStored([11, 12], None, t[:8], BLOCK)]),
        ev.EventBatch(1.0, [ev.BlockStored([13], 12, t[8:], BLOCK, lora_id=None, medium="gpu")]),
        ev.EventBatch(2.0, [ev.BlockStored([21], None, [9, 9, 9, 9], BLOCK, lora_id=4)]),
        ev.EventBatch(3.0, [ev.BlockRemoved([12]), ev.AllBlocksCleared()]),
        ev.EventBatch(4.0, [ev.BlockStored([31], None, [5, 6, 7, 8], BLOCK, medium="cpu")],
                      data_parallel_rank=1),
    ]


@pytest.mark.parametrize("sharded", [False, True], ids=["in_memory", "sharded"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_publisher_into_the_other_packages_pool(tmp_path, direction, sharded):
    pub_pkg, pool_pkg = ((PORT_PKG, JAX_PKG) if direction == "port_to_jax"
                         else (JAX_PKG, PORT_PKG))
    endpoint = f"ipc://{tmp_path}/events.sock"
    pool, seen = _subscribed_pool(pool_pkg, endpoint, sharded)
    pub_mods = _mods(pub_pkg)
    ev = pub_mods["ev"]
    publisher = pub_mods["pub"].Publisher(endpoint, pub_mods["pub"].make_topic("pod-z", MODEL))
    try:
        _join(lambda: publisher.publish(ev.EventBatch(0.0, [])), seen)
        batches = _traffic(ev)
        last = None
        for batch in batches:
            last = publisher.publish(batch)
        assert seen.wait(lambda seqs: last in seqs), "published batches never arrived"
        pool.drain()
        got = _contents(pool.index)
    finally:
        publisher.close()
        pool.shutdown()
    port_ev = _mods(PORT_PKG)["ev"]
    want = _in_process({"pod-z": _traffic(port_ev)}, sharded)
    assert got == want
    assert len(want[0]) >= 4 and any(p == "pod-z@dp1" for v in want[0].values() for p, _ in v)


@pytest.mark.parametrize("sharded", [False, True], ids=["in_memory", "sharded"])
def test_port_pod_publishes_to_a_port_pool(tmp_path, sharded):
    """A port pod (device="cpu", f32) with zmq_endpoint set publishes its
    block manager's batches; the subscribed port pool indexes exactly what
    in-process digestion of the pod's sink batches indexes."""
    endpoint = f"ipc://{tmp_path}/pod.sock"
    pool, seen = _subscribed_pool(PORT_PKG, endpoint, sharded)
    cfg = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=1, n_q_heads=2,
                            n_kv_heads=1, head_dim=16, d_ff=64, dtype=torch.float32)
    sink = []
    pod = EnginePod(
        EnginePodConfig(pod_id="pod-p", model_name=MODEL, zmq_endpoint=endpoint, n_pages=6,
                        page_size=BLOCK, device_tier="gpu", max_pages_per_seq=8,
                        model_config=cfg, device="cpu"),
        event_sink=sink.append,
        params=llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
    )
    ev = _mods(PORT_PKG)["ev"]
    try:
        _join(lambda: pod._emit(ev.EventBatch(0.0, [])), seen)
        n_probes = len(sink)
        for prompt in (list(range(1, 11)), list(range(1, 11)), list(range(30, 45)),
                       list(range(50, 63))):
            state, _ = pod.prefill(prompt)
            pod.decode_append(state, int(torch.argmax(pod.last_logits)))
            pod.decode_step(state)
            pod.free(state)
        last = pod._publisher._seq - 1
        assert seen.wait(lambda seqs: last in seqs), "pod batches never arrived"
        pool.drain()
        got = _contents(pool.index)
    finally:
        pod.close()
        pool.shutdown()
    served = sink[n_probes:]
    assert any(type(e).__name__ == "BlockRemoved" for b in served for e in b.events)
    assert got == _in_process({"pod-p": sink}, sharded)
    assert got[0]
