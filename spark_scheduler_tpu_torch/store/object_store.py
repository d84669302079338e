"""Thread-safe object store with resource-version semantics.

Rebuilds internal/cache/store/store.go:26-130: a map keyed by (namespace,
name) whose writers are the cache owner (Put/PutIfAbsent/Delete) and whose
watch stream may only fast-forward resourceVersions of objects it already
holds (OverrideResourceVersionIfNewer) — external mutations never clobber
local pending state.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

Key = tuple[str, str]  # (namespace, name)


def obj_key(obj: Any) -> Key:
    return (obj.namespace, obj.name)


class ObjectStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._store: dict[Key, Any] = {}

    def put(self, obj: Any) -> None:
        with self._lock:
            self._store[obj_key(obj)] = obj

    def put_if_absent(self, obj: Any) -> bool:
        with self._lock:
            k = obj_key(obj)
            if k in self._store:
                return False
            self._store[k] = obj
            return True

    def override_resource_version_if_newer(self, obj: Any) -> None:
        """Apply a watch event: only bump the stored object's resourceVersion
        (store.go:96-118) — the cache owner is the sole writer of content."""
        with self._lock:
            cur = self._store.get(obj_key(obj))
            if cur is not None and obj.resource_version > cur.resource_version:
                cur.resource_version = obj.resource_version

    def get(self, namespace: str, name: str) -> Optional[Any]:
        with self._lock:
            return self._store.get((namespace, name))

    def delete(self, namespace: str, name: str) -> None:
        with self._lock:
            self._store.pop((namespace, name), None)

    def list(self) -> list[Any]:
        with self._lock:
            return list(self._store.values())

    def apply(self, namespace: str, name: str, fn: Callable[[Any], Any]) -> Optional[Any]:
        """Atomically read-modify-write one entry; fn gets the current object
        (or None) and returns the replacement (or None to leave unchanged)."""
        with self._lock:
            cur = self._store.get((namespace, name))
            new = fn(cur)
            if new is not None:
                self._store[(namespace, name)] = new
            return new

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)
