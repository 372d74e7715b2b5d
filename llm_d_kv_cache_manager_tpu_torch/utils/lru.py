"""Thread-safe LRU cache.

Copy of the reference package's `utils/lru.py`: the LRU behind the index,
the prefix store, the chain memo and the tokenizer cache. An OrderedDict
under a lock, with the semantics the index code relies on (get refreshes
recency, add evicts oldest beyond capacity, contains_or_add for
double-checked insertion, golang-lru style).

Hot-path additions for the sharded index (kvcache/kvblock/sharded.py):

- `get_many`/`peek_many`/`add_many` amortize the lock to ONE acquisition per
  batch — a 128-key lookup against a striped index takes at most
  one acquisition per touched stripe instead of one per key.
- `keys()` serves from a cached tuple snapshot rebuilt lazily after a
  mutation, so steady-state readers of a stable cache (the index read path
  walking pod entries) don't take the lock at all. Snapshot publication is
  a single attribute store, atomic under the GIL.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Generic, Hashable, Iterable, Iterator, List, Optional, Sequence, Tuple, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")

_MISSING = object()


class LRUCache(Generic[K, V]):
    """A bounded, thread-safe LRU map.

    `on_evict(key, value)`, when given, fires whenever an entry leaves the
    cache — capacity eviction, `remove`, or `purge`. It runs WHILE THE CACHE
    LOCK IS HELD so departure is atomic with the callback (the sharded
    index's read view relies on this); keep it tiny and never call back
    into the cache from it.
    """

    def __init__(self, capacity: int, on_evict=None):
        if capacity <= 0:
            raise ValueError(f"LRU capacity must be positive, got {capacity}")
        self._capacity = capacity
        self._data: "OrderedDict[K, V]" = OrderedDict()
        self._lock = threading.Lock()
        self._on_evict = on_evict
        # Cached keys() snapshot; None = stale. Only ever replaced whole
        # (never mutated), so lock-free readers see a consistent tuple.
        self._snap: Optional[Tuple[K, ...]] = None

    @property
    def capacity(self) -> int:
        return self._capacity

    def get(self, key: K, default=None):
        with self._lock:
            try:
                self._data.move_to_end(key)
            except KeyError:
                return default
            self._snap = None  # recency order changed
            return self._data[key]

    def peek(self, key: K, default=None):
        """Read without refreshing recency."""
        with self._lock:
            return self._data.get(key, default)

    def get_many(self, keys: Sequence[K]) -> dict:
        """Batched get: hits refresh recency; one lock acquisition total."""
        out = {}
        with self._lock:
            data = self._data
            for key in keys:
                if key in data:
                    data.move_to_end(key)
                    out[key] = data[key]
            if out:
                self._snap = None
        return out

    def peek_many(self, keys: Sequence[K]) -> dict:
        """Batched peek: no recency mutation; one lock acquisition total."""
        out = {}
        with self._lock:
            data = self._data
            for key in keys:
                v = data.get(key, _MISSING)
                if v is not _MISSING:
                    out[key] = v
        return out

    def __contains__(self, key: K) -> bool:
        with self._lock:
            return key in self._data

    def add(self, key: K, value: V) -> bool:
        """Insert/replace. Returns True if an eviction occurred."""
        with self._lock:
            self._snap = None
            if key in self._data:
                self._data.move_to_end(key)
                self._data[key] = value
                return False
            self._data[key] = value
            if len(self._data) > self._capacity:
                old_key, old_value = self._data.popitem(last=False)
                if self._on_evict is not None:
                    self._on_evict(old_key, old_value)
                return True
            return False

    def add_many(self, items: Iterable[Tuple[K, V]]) -> int:
        """Batched add of (key, value) pairs under one lock acquisition.

        Same per-pair semantics as `add`; returns the number of evictions.
        """
        evicted = 0
        with self._lock:
            self._snap = None
            data = self._data
            for key, value in items:
                if key in data:
                    data.move_to_end(key)
                    data[key] = value
                    continue
                data[key] = value
                if len(data) > self._capacity:
                    old_key, old_value = data.popitem(last=False)
                    if self._on_evict is not None:
                        self._on_evict(old_key, old_value)
                    evicted += 1
        return evicted

    def contains_or_add(self, key: K, value: V) -> Tuple[bool, bool]:
        """(contained, evicted): add only if absent, like golang-lru ContainsOrAdd."""
        with self._lock:
            if key in self._data:
                return True, False
            self._snap = None
            self._data[key] = value
            if len(self._data) > self._capacity:
                old_key, old_value = self._data.popitem(last=False)
                if self._on_evict is not None:
                    self._on_evict(old_key, old_value)
                return False, True
            return False, False

    def remove(self, key: K) -> bool:
        with self._lock:
            value = self._data.pop(key, _MISSING)
            removed = value is not _MISSING
            if removed:
                self._snap = None
                if self._on_evict is not None:
                    self._on_evict(key, value)
            return removed

    def keys(self) -> List[K]:
        """Snapshot of keys, oldest first (matches golang-lru Keys())."""
        snap = self._snap
        if snap is None:
            with self._lock:
                snap = self._snap
                if snap is None:
                    snap = tuple(self._data.keys())
                    self._snap = snap
        return list(snap)

    def items(self) -> list:
        with self._lock:
            return list(self._data.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __iter__(self) -> Iterator[K]:
        return iter(self.keys())

    def purge(self) -> None:
        with self._lock:
            if self._on_evict is not None:
                for key, value in self._data.items():
                    self._on_evict(key, value)
            self._data.clear()
            self._snap = None
