"""ZMQ SUB subscriber for engine KVEvents.

Copy of the reference package's `kvevents/zmq_subscriber.py`: the
indexer *binds* a SUB socket (engines connect out to it, so a fleet of pods
needs no per-pod endpoint config), subscribes to the topic filter (default
"kv@"), and receives 3-frame messages:

    [topic: "kv@<pod-id>@<model>", seq: uint64 big-endian, payload: msgpack]

The receive loop polls with a 250ms timeout so shutdown is responsive. On
any socket error it tears down and reconnects forever, with capped
exponential backoff and jitter (base `RETRY_INTERVAL_S`, cap
`RETRY_MAX_S`): a persistently broken endpoint backs off instead of
hammering, while jitter keeps a fleet of managers from retrying in
lockstep. The consecutive-failure count is surfaced to the fleet-health
tracker (`pool.health_tracker`, when wired) and via the
`consecutive_failures` attribute — a manager whose event plane cannot bind
is *live* but not *ready*.
"""

from __future__ import annotations

import random
import threading
from typing import List, Optional, Sequence, Union

import zmq

from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import Message
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("kvevents.zmq_subscriber")

RETRY_INTERVAL_S = 5.0  # backoff base (first retry delay)
RETRY_MAX_S = 60.0  # backoff cap
RETRY_JITTER = 0.25  # uniform extra fraction of the delay
POLL_TIMEOUT_MS = 250


def backoff_delay(
    consecutive_failures: int,
    base: Optional[float] = None,
    cap: Optional[float] = None,
    jitter: float = 0.0,
) -> float:
    """Capped exponential backoff for the Nth consecutive failure (N>=1).

    `jitter` in [0, 1] stretches the delay by a uniform random fraction;
    pass 0 (the default) for the deterministic base schedule.
    """
    if base is None:
        base = RETRY_INTERVAL_S
    if cap is None:
        cap = RETRY_MAX_S
    n = max(consecutive_failures, 1)
    delay = min(base * (2.0 ** (n - 1)), max(cap, base))
    if jitter > 0.0:
        delay *= 1.0 + jitter * random.random()
    return delay


def _normalize_filters(topic_filter: Union[str, Sequence[str]]) -> List[str]:
    """One filter string, or a sequence of them (partitioned subscribe).

    An empty sequence degenerates to the subscribe-everything filter ""
    rather than a socket with no subscriptions at all — a replica whose
    partition map is momentarily empty should see (and discard) traffic,
    not silently go deaf.
    """
    if isinstance(topic_filter, str):
        return [topic_filter]
    filters = [str(f) for f in topic_filter]
    return filters or [""]


class ZMQSubscriber:
    def __init__(
        self,
        pool,
        endpoint: str,
        topic_filter: Union[str, Sequence[str]] = "kv@",
    ):
        self.pool = pool
        self.endpoint = endpoint
        # Subscription filter set. ZMQ SUB filters are prefix matches, so a
        # partitioned replica subscribes to one "kv@<pod-id>@" prefix per
        # owned pod (cluster/partition.py builds the list) instead of the
        # firehose "kv@". Kept as a list; `topic_filter` (the first entry)
        # survives for single-filter callers and log lines.
        self.topic_filters = _normalize_filters(topic_filter)
        # Consecutive _run_subscriber exits without a successful bind+poll
        # session; reset on every successful bind.
        self.consecutive_failures = 0
        # Filter swaps applied by the receive loop (introspection/tests).
        self.resubscriptions = 0
        self._filters_mu = threading.Lock()
        self._pending_filters: Optional[List[str]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ctx: Optional[zmq.Context] = None

    @property
    def topic_filter(self) -> str:
        return self.topic_filters[0]

    def resubscribe(self, topic_filter: Union[str, Sequence[str]]) -> None:
        """Swap the subscription filter set without a process restart.

        Partition reassignment (a replica joining/leaving the cluster)
        changes which topic prefixes this subscriber should digest. The
        swap is applied by the receive loop between polls on the SAME
        bound socket — no rebind, no backoff reset, and engines' PUB
        sockets never see the endpoint flap. When the loop isn't running
        the new set simply becomes the initial subscription of the next
        `start()`.
        """
        filters = _normalize_filters(topic_filter)
        with self._filters_mu:
            if self._thread is not None and self._thread.is_alive():
                self._pending_filters = filters
            else:
                self.topic_filters = filters
                self._pending_filters = None

    def _take_pending_filters(self) -> Optional[List[str]]:
        with self._filters_mu:
            pending, self._pending_filters = self._pending_filters, None
            return pending

    def start(self) -> None:
        if self._thread is not None:
            return
        self._ctx = zmq.Context.instance()
        self._thread = threading.Thread(
            target=self._run, name="zmq-subscriber", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _notify_health(self, connected: bool) -> None:
        tracker = getattr(self.pool, "health_tracker", None)
        if tracker is None:
            return
        try:
            if connected:
                tracker.observe_subscriber_connected()
            else:
                tracker.observe_subscriber_failure(self.consecutive_failures)
        except Exception as e:  # noqa: BLE001 - health reporting is advisory
            logger.debug("health notify failed: %s", e)

    def _run(self) -> None:
        while not self._stop.is_set():
            self._run_subscriber()
            if self._stop.is_set():
                return
            self.consecutive_failures += 1
            self._notify_health(connected=False)
            delay = backoff_delay(
                self.consecutive_failures, jitter=RETRY_JITTER
            )
            if self._stop.wait(delay):
                return
            logger.info(
                "retrying zmq-subscriber (attempt %d, waited %.2fs)",
                self.consecutive_failures + 1, delay,
            )

    def _run_subscriber(self) -> None:
        try:
            sub = self._ctx.socket(zmq.SUB)
        except zmq.ZMQError as e:
            logger.error("failed to create SUB socket: %s", e)
            return
        try:
            sub.bind(self.endpoint)
            # Fold any resubscribe() that raced the (re)bind into the
            # initial subscription set, then subscribe every filter.
            pending = self._take_pending_filters()
            if pending is not None:
                self.topic_filters = pending
            for f in self.topic_filters:
                sub.setsockopt_string(zmq.SUBSCRIBE, f)
            logger.info(
                "bound subscriber socket at %s (%d filter(s))",
                self.endpoint, len(self.topic_filters),
            )
            self.consecutive_failures = 0
            self._notify_health(connected=True)

            poller = zmq.Poller()
            poller.register(sub, zmq.POLLIN)

            while not self._stop.is_set():
                pending = self._take_pending_filters()
                if pending is not None:
                    # Partition reassignment: swap filters on the live
                    # socket. Unsubscribe-then-subscribe on the same socket
                    # is atomic enough for our semantics — a message
                    # matching neither set during the swap was not owned by
                    # this replica under either assignment.
                    for f in self.topic_filters:
                        sub.setsockopt_string(zmq.UNSUBSCRIBE, f)
                    for f in pending:
                        sub.setsockopt_string(zmq.SUBSCRIBE, f)
                    self.topic_filters = pending
                    self.resubscriptions += 1
                    logger.info(
                        "resubscribed %s with %d filter(s)",
                        self.endpoint, len(pending),
                    )
                try:
                    polled = dict(poller.poll(POLL_TIMEOUT_MS))
                except zmq.ZMQError as e:
                    logger.debug("poll failed: %s", e)
                    return  # reconnect
                if sub not in polled:
                    continue
                try:
                    parts = sub.recv_multipart()
                except zmq.ZMQError as e:
                    logger.debug("recv failed: %s", e)
                    return  # reconnect
                if len(parts) != 3:
                    logger.debug("malformed message: %d frames", len(parts))
                    continue
                topic = parts[0].decode("utf-8", errors="replace")
                seq = int.from_bytes(parts[1], "big")
                payload = parts[2]

                topic_parts = topic.split("@")
                if len(topic_parts) != 3:
                    logger.debug(
                        "bad topic %r, expected kv@<pod-id>@<model-name>", topic
                    )
                    continue
                _prefix, pod_identifier, model_name = topic_parts

                self.pool.add_task(
                    Message(
                        topic=topic,
                        payload=payload,
                        seq=seq,
                        pod_identifier=pod_identifier,
                        model_name=model_name,
                    )
                )
        except zmq.ZMQError as e:
            logger.error("subscriber socket error on %s: %s", self.endpoint, e)
        finally:
            sub.close(linger=0)
