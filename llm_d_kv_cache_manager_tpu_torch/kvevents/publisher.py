"""ZMQ PUB publisher for KVEvents.

Copy of the reference package's `kvevents/publisher.py`: a PUB socket that
*connects* to the indexer's bound SUB endpoint and publishes 3-frame
messages [topic, seq big-endian, msgpack(EventBatch)] with a monotonically
increasing sequence number.

A port pod with `EnginePodConfig.zmq_endpoint` set publishes its block
manager's BlockStored/BlockRemoved batches through this class. This module
and kvevents/zmq_subscriber.py are the only port modules that import
`zmq`; everything else imports them lazily.
"""

from __future__ import annotations

import threading

import zmq

from llm_d_kv_cache_manager_tpu_torch.kvevents.events import EventBatch


class Publisher:
    """Thread-safe KVEvents publisher for one engine pod."""

    def __init__(self, endpoint: str, topic: str):
        """`topic` should be `kv@<pod-id>@<model>`."""
        self.endpoint = endpoint
        self.topic = topic.encode("utf-8")
        self._seq = 0
        self._mu = threading.Lock()
        self._ctx = zmq.Context.instance()
        self._socket = self._ctx.socket(zmq.PUB)
        self._socket.connect(endpoint)

    def publish(self, batch: EventBatch) -> int:
        """Publish one batch; returns the sequence number used."""
        payload = batch.to_msgpack()
        with self._mu:
            seq = self._seq
            self._seq += 1
            self._socket.send_multipart(
                [self.topic, seq.to_bytes(8, "big"), payload]
            )
        return seq

    def close(self) -> None:
        self._socket.close(linger=100)


def make_topic(pod_identifier: str, model_name: str, prefix: str = "kv") -> str:
    return f"{prefix}@{pod_identifier}@{model_name}"
