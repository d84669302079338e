"""Tiny insertion-ordered LRU used by the serving-path memo caches.

Every hot-path cache here used to `clear()` on overflow — wiping all 64
entries and forcing a full re-warm the moment a 65th signature appeared
(the exact workload shape of a fleet cycling through ~65 selector
signatures). LRU eviction keeps the hottest entries resident instead.

Plain dict + move-to-end on hit: Python dicts preserve insertion order, so
the first key is always the least-recently-used one. A small internal lock
serializes mutations — most consumers are single-threaded by the batcher
contract, but the solver's candidate-mask cache is also touched from the
unschedulable-marker thread, and the del+reinsert pair must not interleave.
"""

from __future__ import annotations

import threading
from typing import Any, Iterator


class LRUCache:
    __slots__ = ("_d", "_cap", "_lock")

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._d: dict = {}
        self._cap = capacity
        self._lock = threading.Lock()

    def get(self, key) -> Any | None:
        with self._lock:
            d = self._d
            v = d.get(key)
            if v is not None:
                # Move to end: most-recently-used keys live at the back.
                del d[key]
                d[key] = v
            return v

    def put(self, key, value) -> None:
        with self._lock:
            d = self._d
            if key in d:
                del d[key]
            elif len(d) >= self._cap:
                del d[next(iter(d))]  # evict least-recently-used
            d[key] = value

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def keys(self) -> Iterator:
        return iter(self._d)
