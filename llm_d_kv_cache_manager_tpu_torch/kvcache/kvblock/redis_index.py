"""Distributed KV-block index on Redis/Valkey.

Copy of the reference package's `kvcache/kvblock/redis_index.py`: the index
shared by multiple indexer replicas. Schema:

- hash per request key (`<model>@<decimal-hash>`), one field per pod entry
  (`pod@tier`, empty value),
- string key `engine:<model>@<hash>` → request-key string for the
  engine→request mapping.

Lookups pipeline one HKEYS per block key (single RTT); a missing key or a
fully-filtered-out key cuts the prefix walk. Valkey URLs (valkey://) are
accepted and rewritten; the RDMA config flag is kept as a placeholder. The
reference's state-transition metrics counter is left out; the transitions
are still logged.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index, IndexView
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.key import Key, PodEntry, pod_matches
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.resp import (
    RespConnection,
    RespError,
)
from llm_d_kv_cache_manager_tpu_torch.utils import logging as kvlog

logger = kvlog.get_logger("kvblock.redis")


@dataclass
class RedisIndexConfig:
    url: str = "redis://localhost:6379"
    timeout_s: float = 5.0
    enable_rdma: bool = False  # placeholder, kept for config parity
    # Reconnect backoff (after a failed reconnect, lookups fail fast for
    # this long instead of each paying the connect timeout). Consecutive
    # failures double the window up to the cap; jitter (a uniform fraction
    # of the window) desynchronizes a fleet of manager replicas all
    # backing off from the same outage.
    reconnect_backoff_s: float = 5.0
    reconnect_backoff_max_s: float = 60.0
    reconnect_jitter: float = 0.2
    # SCAN page size for bulk maintenance passes (remove_pod).
    scan_count: int = 512


def _key_str(key: Key) -> str:
    return f"{key.model_name}@{key.chunk_hash:d}"


def _engine_key_str(key: Key) -> str:
    return "engine:" + _key_str(key)


def _parse_key(text: str) -> Optional[Key]:
    model, sep, hash_str = text.rpartition("@")
    if not sep or not hash_str.isdigit():
        return None
    return Key(model, int(hash_str))


def _parse_entry(field: str) -> Optional[PodEntry]:
    # rpartition: the tier is always the LAST segment, so ranked pod
    # identities ("pod@dp0@hbm") round-trip with their rank intact.
    pod, sep, tier = field.rpartition("@")
    if not sep:
        return None
    return PodEntry(pod, tier)


# Default for RedisIndexConfig.reconnect_backoff_s (kept as a module
# constant for back-compat with callers/tests that monkeypatch it): after a
# failed reconnect, skip further reconnect attempts for this long — without
# it, a partitioned Redis makes EVERY scoring lookup block the full connect
# timeout before soft-failing — a fleet-wide stall, not a miss.
RECONNECT_BACKOFF_S = 5.0
# Cut-chain events surface at WARNING at most this often (an outage must be
# operator-visible, not a debug-level mystery hit-rate collapse).
_WARN_INTERVAL_S = 30.0


class RedisIndex(Index):
    def __init__(self, config: Optional[RedisIndexConfig] = None):
        self.config = config or RedisIndexConfig()
        self._conn = RespConnection(self.config.url, self.config.timeout_s)
        self._mu = threading.Lock()  # guards backoff/reconnect bookkeeping
        self._reconnecting = False
        self._down_until = 0.0
        # Connection lifecycle: "up" -> "down" (first pipeline failure) ->
        # "backoff" (reconnect failed; lookups fail fast) -> "up". Every
        # transition is logged and counted
        # (kvcache_redis_state_transitions_total) — an outage must be
        # operator-visible, not a silently-absorbed hit-rate collapse.
        self._state = "up"
        self._consecutive_failures = 0
        self._jitter_rng = random.Random()
        # Negative sentinel: monotonic() is time-since-boot, so 0.0 would
        # suppress the FIRST outage warning during early uptime.
        self._last_warn = -_WARN_INTERVAL_S
        self._conn.connect()
        if not self._conn.ping():
            raise ConnectionError(f"redis PING failed for {self.config.url}")

    def close(self) -> None:
        self._conn.close()

    def _pipeline(self, commands):
        # ADVICE r2: _down_until (and _reconnecting/_last_warn) are only
        # read/written under _mu — with the threaded scoring pool,
        # unguarded reads let concurrent lookups race the backoff window
        # and each pay a full connect timeout. _mu is NEVER held across
        # socket I/O: exactly one thread claims the reconnect (flag below)
        # and pays the connect timeout while every other thread fails fast
        # to cache-miss degradation.
        with self._mu:
            if time.monotonic() < self._down_until or self._reconnecting:
                raise ConnectionError(
                    f"redis backend in reconnect backoff ({self.config.url})"
                )
        try:
            return self._conn.pipeline(commands)
        except OSError:
            with self._mu:
                if time.monotonic() < self._down_until or self._reconnecting:
                    raise  # another thread is on it / already failed
                self._reconnecting = True
                self._set_state_locked("down")
            try:
                self._conn.connect()
                replies = self._conn.pipeline(commands)
            except OSError:
                with self._mu:
                    delay = self._backoff_delay_locked()
                    self._down_until = time.monotonic() + delay
                    self._set_state_locked("backoff")
                logger.warning(
                    "redis reconnect to %s failed (attempt %d): backing off "
                    "%.2fs", self.config.url, self._consecutive_failures, delay,
                )
                raise
            finally:
                with self._mu:
                    self._reconnecting = False
            with self._mu:
                self._down_until = 0.0
                self._consecutive_failures = 0
                self._set_state_locked("up")
            return replies

    def _backoff_delay_locked(self) -> float:
        """Next capped-exponential backoff window (+jitter). Holds `_mu`."""
        self._consecutive_failures += 1
        base = max(self.config.reconnect_backoff_s, 0.0)
        delay = min(
            base * (2.0 ** (self._consecutive_failures - 1)),
            max(self.config.reconnect_backoff_max_s, base),
        )
        jitter = max(self.config.reconnect_jitter, 0.0)
        if jitter:
            delay *= 1.0 + jitter * self._jitter_rng.random()
        return delay

    def _set_state_locked(self, state: str) -> None:
        if state == self._state:
            return
        old, self._state = self._state, state
        log = logger.info if state == "up" else logger.warning
        log("redis index %s: %s -> %s", self.config.url, old, state)

    def _warn_cut(self, e: Exception) -> None:
        now = time.monotonic()
        with self._mu:
            if now - self._last_warn < _WARN_INTERVAL_S:
                return
            self._last_warn = now
        logger.warning(
            "redis index unavailable, scoring degrades to cache misses: %s", e
        )

    def lookup(
        self, request_keys: Sequence[Key], pod_identifier_set: Set[str]
    ) -> Dict[Key, List[PodEntry]]:
        if not request_keys:
            raise ValueError("no request keys provided for lookup")

        try:
            replies = self._pipeline(
                [("HKEYS", _key_str(k)) for k in request_keys]
            )
        except OSError as e:  # includes ConnectionError
            # Reference semantics (redis.go:185-192): a Redis failure cuts
            # the prefix chain — the read path degrades to a cache miss, it
            # never unwinds the scoring request. Writes still raise (their
            # callers log and drop the event).
            self._warn_cut(e)
            return {}

        pods_per_key: Dict[Key, List[PodEntry]] = {}
        for key, reply in zip(request_keys, replies):
            if isinstance(reply, RespError) or reply is None:
                logger.debug("lookup reply error for %s: %s", key, reply)
                return pods_per_key  # cut: prefix chain breaks here
            entries: List[PodEntry] = []
            for field in reply:
                entry = _parse_entry(
                    field.decode("utf-8") if isinstance(field, bytes) else field
                )
                if entry is None:
                    continue
                if not pod_identifier_set or pod_matches(
                    entry.pod_identifier, pod_identifier_set
                ):
                    entries.append(entry)
            if not entries:
                return pods_per_key  # cut on miss or fully-filtered key
            pods_per_key[key] = entries
        return pods_per_key

    def lookup_many(
        self, requests: Sequence[tuple]
    ) -> List[Dict[Key, List[PodEntry]]]:
        """Batched `lookup` (Index.lookup_many): ONE pipelined round trip
        covers the union of every item's keys — a 32-request batch over a
        shared prefix pays one network RTT instead of 32 — then each item
        walks the shared parsed replies with the single-call cut semantics
        (a miss, an error reply, or a fully-filtered key cuts that item's
        chain, exactly as in `lookup`). A Redis outage degrades the whole
        batch to cache misses, never an exception."""
        if not requests:
            return []
        unique: List[Key] = []
        seen = set()
        for keys, _ in requests:
            if not keys:
                raise ValueError("no request keys provided for lookup")
            for k in keys:
                if k not in seen:
                    seen.add(k)
                    unique.append(k)
        try:
            replies = self._pipeline(
                [("HKEYS", _key_str(k)) for k in unique]
            )
        except OSError as e:  # includes ConnectionError
            self._warn_cut(e)
            return [{} for _ in requests]

        parsed: Dict[Key, Optional[List[PodEntry]]] = {}
        for key, reply in zip(unique, replies):
            if isinstance(reply, RespError) or reply is None:
                logger.debug("lookup reply error for %s: %s", key, reply)
                parsed[key] = None
                continue
            entries: List[PodEntry] = []
            for field in reply:
                entry = _parse_entry(
                    field.decode("utf-8") if isinstance(field, bytes) else field
                )
                if entry is not None:
                    entries.append(entry)
            parsed[key] = entries

        out: List[Dict[Key, List[PodEntry]]] = []
        shared: dict = {}
        for request_keys, pod_identifier_set in requests:
            pods_per_key: Dict[Key, List[PodEntry]] = {}
            for key in request_keys:
                entries = parsed.get(key)
                if entries is None:
                    break  # error reply: prefix chain breaks here
                if pod_identifier_set:
                    sk = (id(pod_identifier_set), key)
                    hits = shared.get(sk)
                    if hits is None:
                        hits = shared[sk] = [
                            e for e in entries
                            if pod_matches(e.pod_identifier, pod_identifier_set)
                        ]
                else:
                    hits = entries
                if not hits:
                    break  # cut on miss or fully-filtered key
                pods_per_key[key] = hits
            out.append(pods_per_key)
        return out

    def add(
        self,
        engine_keys: Sequence[Key],
        request_keys: Sequence[Key],
        entries: Sequence[PodEntry],
    ) -> None:
        if not engine_keys or not request_keys or not entries:
            raise ValueError("no keys or entries provided for adding to index")
        if len(engine_keys) != len(request_keys):
            raise ValueError("engine/request key length mismatch")

        commands = []
        for engine_key, request_key in zip(engine_keys, request_keys):
            commands.append(("SET", _engine_key_str(engine_key), _key_str(request_key)))
            for entry in entries:
                commands.append(("HSET", _key_str(request_key), str(entry), ""))
        self._pipeline(commands)

    def evict(self, engine_key: Key, entries: Sequence[PodEntry]) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction from index")
        request_key = self.get_request_key(engine_key)
        if request_key is None:
            return
        commands = [("HDEL", _key_str(request_key), str(e)) for e in entries]
        commands.append(("HLEN", _key_str(request_key)))
        replies = self._pipeline(commands)
        if replies and replies[-1] == 0:
            self._pipeline([
                ("DEL", _key_str(request_key)),
                ("DEL", _engine_key_str(engine_key)),
            ])

    def get_request_key(self, engine_key: Key) -> Optional[Key]:
        # Deliberately NOT soft-failed: None means "parent genuinely not
        # indexed" and makes the event pool start a fresh hash chain —
        # returning it on a connection blip would commit mid-prompt blocks
        # under fresh-chain request keys (false prefix hits that persist).
        # A raised error instead drops the event batch (worker catch-all),
        # which is consistent.
        replies = self._pipeline([("GET", _engine_key_str(engine_key))])
        value = replies[0]
        if value is None or isinstance(value, RespError):
            return None
        return _parse_key(value.decode("utf-8") if isinstance(value, bytes) else value)

    def remove_pod(self, pod_identifier: str) -> int:
        """One-pass quarantine purge (Index.remove_pod contract).

        SCAN-walks the keyspace (cursor iteration, never the blocking
        KEYS), HDELs the pod's fields from each request-key hash in
        pipelined pages, DELs hashes that emptied, and finally drops
        engine:* mappings that point at deleted request keys. Connection
        errors propagate like the write path's (callers log and retry the
        quarantine; the pod stays excluded by health state meanwhile).
        """
        target = {pod_identifier}
        removed = 0
        emptied: Set[str] = set()
        for page in self._scan_pages():
            request_keys = [k for k in page if not k.startswith("engine:")]
            if not request_keys:
                continue
            replies = self._pipeline([("HKEYS", k) for k in request_keys])
            commands = []
            victims_per_key: List[tuple] = []
            for key_str, reply in zip(request_keys, replies):
                if isinstance(reply, RespError) or reply is None:
                    continue
                victims = []
                for field in reply:
                    field_str = (
                        field.decode("utf-8") if isinstance(field, bytes) else field
                    )
                    entry = _parse_entry(field_str)
                    if entry is not None and pod_matches(
                        entry.pod_identifier, target
                    ):
                        victims.append(field_str)
                if victims:
                    commands.append(("HDEL", key_str, *victims))
                    commands.append(("HLEN", key_str))
                    victims_per_key.append((key_str, len(victims)))
            if not commands:
                continue
            replies = self._pipeline(commands)
            del_cmds = []
            for i, (key_str, n_victims) in enumerate(victims_per_key):
                removed += n_victims
                if replies[2 * i + 1] == 0:  # the HLEN after the HDEL
                    del_cmds.append(("DEL", key_str))
                    emptied.add(key_str)
            if del_cmds:
                self._pipeline(del_cmds)
        if emptied:
            for page in self._scan_pages(match="engine:*"):
                engine_keys = [k for k in page if k.startswith("engine:")]
                if not engine_keys:
                    continue
                values = self._pipeline([("GET", k) for k in engine_keys])
                stale = [
                    k
                    for k, v in zip(engine_keys, values)
                    if isinstance(v, (bytes, str))
                    and (v.decode("utf-8") if isinstance(v, bytes) else v)
                    in emptied
                ]
                if stale:
                    self._pipeline([("DEL", *stale)])
        return removed

    def remove_entries(
        self, pod_identifier: str, request_keys, device_tiers=None
    ) -> int:
        """Targeted purge (Index.remove_entries contract), fully
        pipelined: ONE round trip reads the targeted hashes (HKEYS per
        key), one issues the HDELs + HLENs, and one DELs the keys that
        emptied — no SCAN of the keyspace (that is `remove_pod`'s job; a
        feedback purge must stay O(targeted keys), not O(index)).
        Engine:* mappings pointing at deleted keys are dropped in a final
        targeted sweep over the emptied keys' engine aliases resolved the
        same way `evict` resolves them — by skipping it: a dangling
        engine:* row is self-healing here (get_request_key → evict finds
        the hash gone and deletes the row), and hunting it down would
        cost the SCAN this method exists to avoid. Connection errors
        propagate like the write path's."""
        target = {pod_identifier}
        keys = list(request_keys)
        if not keys:
            return 0
        replies = self._pipeline([("HKEYS", _key_str(k)) for k in keys])
        commands = []
        victims_per_key: List[tuple] = []
        for key, reply in zip(keys, replies):
            if isinstance(reply, RespError) or reply is None:
                continue
            victims = []
            for field in reply:
                field_str = (
                    field.decode("utf-8") if isinstance(field, bytes) else field
                )
                entry = _parse_entry(field_str)
                if (
                    entry is not None
                    and pod_matches(entry.pod_identifier, target)
                    and (
                        device_tiers is None
                        or entry.device_tier in device_tiers
                    )
                ):
                    victims.append(field_str)
            if victims:
                key_str = _key_str(key)
                commands.append(("HDEL", key_str, *victims))
                commands.append(("HLEN", key_str))
                victims_per_key.append((key, len(victims)))
        if not commands:
            return 0
        replies = self._pipeline(commands)
        removed = 0
        del_cmds = []
        for i, (key, n_victims) in enumerate(victims_per_key):
            removed += n_victims
            if replies[2 * i + 1] == 0:  # the HLEN after the HDEL
                del_cmds.append(("DEL", _key_str(key)))
                # Engine aliases resolve through the same decimal-hash
                # string on this backend's schema, so the 1:1 alias row
                # can be dropped in the same sweep.
                del_cmds.append(("DEL", _engine_key_str(key)))
        if del_cmds:
            self._pipeline(del_cmds)
        return removed

    def export_view(self) -> IndexView:
        """SCAN-walk the keyspace into an IndexView (Index.export_view).

        Redis has no recency order to preserve — rows come out in SCAN
        order, which is fine: restores into redis are order-insensitive,
        and restores into LRU backends get an arbitrary-but-valid recency
        seed. Connection errors propagate (a snapshot must be complete or
        fail loudly, never silently partial)."""
        entries = []
        engine_map = []
        for page in self._scan_pages():
            request_strs = [k for k in page if not k.startswith("engine:")]
            engine_strs = [k for k in page if k.startswith("engine:")]
            if request_strs:
                replies = self._pipeline([("HKEYS", k) for k in request_strs])
                for key_str, reply in zip(request_strs, replies):
                    key = _parse_key(key_str)
                    if key is None or isinstance(reply, RespError) or reply is None:
                        continue
                    pods = []
                    for field in reply:
                        entry = _parse_entry(
                            field.decode("utf-8")
                            if isinstance(field, bytes) else field
                        )
                        if entry is not None:
                            pods.append((entry.pod_identifier, entry.device_tier))
                    entries.append((key.model_name, key.chunk_hash, tuple(pods)))
            if engine_strs:
                values = self._pipeline([("GET", k) for k in engine_strs])
                for key_str, value in zip(engine_strs, values):
                    if value is None or isinstance(value, RespError):
                        continue
                    engine_key = _parse_key(key_str[len("engine:"):])
                    request_key = _parse_key(
                        value.decode("utf-8") if isinstance(value, bytes) else value
                    )
                    if engine_key is None or request_key is None:
                        continue
                    engine_map.append((
                        engine_key.model_name, engine_key.chunk_hash,
                        request_key.model_name, request_key.chunk_hash,
                    ))
        return IndexView(entries=entries, engine_map=engine_map)

    def import_view(self, view: IndexView) -> int:
        """Pipelined HSET/SET restore (Index.import_view). Batched in
        pages so a large snapshot doesn't build one giant pipeline."""
        imported = 0
        commands = []
        for model_name, chunk_hash, pods in view.entries:
            key_str = _key_str(Key(model_name, chunk_hash))
            for pod, tier in pods:
                commands.append(
                    ("HSET", key_str, str(PodEntry(pod, tier)), "")
                )
                imported += 1
        for engine_model, engine_hash, req_model, req_hash in view.engine_map:
            commands.append((
                "SET", _engine_key_str(Key(engine_model, engine_hash)),
                _key_str(Key(req_model, req_hash)),
            ))
        for i in range(0, len(commands), 1024):
            self._pipeline(commands[i:i + 1024])
        return imported

    def _scan_pages(self, match: str = "*"):
        """Yield pages of keys (decoded str) via cursor SCAN."""
        cursor = "0"
        while True:
            reply = self._pipeline(
                [("SCAN", cursor, "MATCH", match, "COUNT", self.config.scan_count)]
            )[0]
            if isinstance(reply, RespError) or reply is None:
                return
            cursor_raw, keys = reply[0], reply[1]
            cursor = (
                cursor_raw.decode("utf-8")
                if isinstance(cursor_raw, bytes)
                else str(cursor_raw)
            )
            yield [
                k.decode("utf-8") if isinstance(k, bytes) else k for k in keys
            ]
            if cursor == "0":
                return
