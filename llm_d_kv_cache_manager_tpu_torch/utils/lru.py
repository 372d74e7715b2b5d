"""Thread-safe LRU cache.

Copy of the reference package's `utils/lru.py`, cut to what the in-memory
index uses: an OrderedDict under a lock where `get` refreshes recency, `add`
evicts the oldest entry beyond capacity, and `contains_or_add` supports
double-checked insertion.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Generic, Hashable, List, Tuple, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")

_MISSING = object()


class LRUCache(Generic[K, V]):
    """A bounded, thread-safe LRU map."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"LRU capacity must be positive, got {capacity}")
        self._capacity = capacity
        self._data: "OrderedDict[K, V]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: K, default=None):
        with self._lock:
            try:
                self._data.move_to_end(key)
            except KeyError:
                return default
            return self._data[key]

    def add(self, key: K, value: V) -> bool:
        """Insert/replace. Returns True if an eviction occurred."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self._data[key] = value
                return False
            self._data[key] = value
            if len(self._data) > self._capacity:
                self._data.popitem(last=False)
                return True
            return False

    def contains_or_add(self, key: K, value: V) -> Tuple[bool, bool]:
        """(contained, evicted): add only if absent, like golang-lru ContainsOrAdd."""
        with self._lock:
            if key in self._data:
                return True, False
            self._data[key] = value
            if len(self._data) > self._capacity:
                self._data.popitem(last=False)
                return False, True
            return False, False

    def remove(self, key: K) -> bool:
        with self._lock:
            return self._data.pop(key, _MISSING) is not _MISSING

    def keys(self) -> List[K]:
        """Snapshot of keys, oldest first (matches golang-lru Keys())."""
        with self._lock:
            return list(self._data.keys())

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)
