"""Write-through caches with async write-back.

Rebuilds internal/cache/{cache.go,resourcereservations.go,demands.go,
safedemands.go}: the cache owner is the SOLE writer for its objects —
Create/Update/Delete mutate the local store synchronously and enqueue a
write; watch events may only fast-forward resourceVersions (external
creates/updates are ignored to avoid conflicts) and apply deletions. Each
CRD kind gets 5 write workers over a sharded dedup queue
(resourceReservationClients=5, resourcereservations.go:29-34).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional

from spark_scheduler_tpu_torch.store.async_client import (
    DEFAULT_MAX_RETRIES,
    AsyncClient,
    AsyncClientMetrics,
)
from spark_scheduler_tpu_torch.store.backend import DEMAND_CRD, ClusterBackend
from spark_scheduler_tpu_torch.store.object_store import ObjectStore
from spark_scheduler_tpu_torch.store.queue import Request, RequestType, make_sharded_queue

NUM_WRITE_CLIENTS = 5


class BatchableListener:
    """A mutation listener with a batched variant.

    `WriteThroughCache.create_many` (the serving window's coalesced commit)
    delivers all of a batch's (old, new) pairs in ONE `batch(pairs)` call to
    listeners registered through this wrapper — the delta consumer takes its
    own lock once per window instead of once per reservation. Single
    mutations still arrive through `__call__` exactly as before."""

    __slots__ = ("_fn", "batch")

    def __init__(self, fn, batch):
        self._fn = fn
        self.batch = batch

    def __call__(self, old, new) -> None:
        self._fn(old, new)


class WriteThroughCache:
    def __init__(
        self,
        backend: ClusterBackend,
        kind: str,
        *,
        num_clients: int = NUM_WRITE_CLIENTS,
        max_retries: int = DEFAULT_MAX_RETRIES,
        sync_writes: bool = False,
        retry_policy=None,
        breaker=None,
        on_retry=None,
    ):
        """sync_writes=True drains the queue inline after every mutation —
        deterministic mode for tests and single-threaded deployments."""
        self._store = ObjectStore()
        self._queue = make_sharded_queue(num_clients)
        self._sync = sync_writes
        self._defer_threads: dict[int, int] = {}  # see deferred_sync()
        # Mutation listeners: fn(old, new) fired synchronously after every
        # local-store mutation (create: old=None; delete: new=None). This is
        # the delta feed for incremental aggregates (ReservedUsageTracker).
        # The read-old -> write -> notify sequence is serialized by
        # `_write_mutex`: the owner is the sole REQUEST-path writer, but the
        # watch thread delivers `apply_external_delete`, so without the mutex
        # racing writers could deliver mismatched (old, new) pairs and
        # permanently corrupt delta-maintained state.
        self._mutation_listeners: list = []
        self._write_mutex = threading.RLock()
        # Per-thread deferred-notification state: {tid: [depth, pairs]} —
        # see deferred_notifications().
        self._deferred_notify: dict[int, list] = {}
        self.client = AsyncClient(
            backend, kind, self._store, self._queue,
            max_retries=max_retries, metrics=AsyncClientMetrics(),
            retry_policy=retry_policy, breaker=breaker, on_retry=on_retry,
        )
        # Initial fill from the backend (cache/resourcereservations.go:53-60).
        for obj in backend.list(kind):
            self._store.put(obj)
        backend.subscribe(
            kind,
            on_add=self._store.override_resource_version_if_newer,
            on_update=lambda old, new: self._store.override_resource_version_if_newer(new),
            on_delete=lambda obj: None,  # see note below
        )
        # NOTE on deletes: the reference removes watched deletions from the
        # store (cache.go:127-133). With the in-memory backend the only
        # deleter is this cache itself (delete already removed it); a k8s
        # adapter should call `apply_external_delete` from its watch stream.

    def add_mutation_listener(self, fn) -> None:
        """fn(old, new); see __init__ note. Must be fast and non-blocking."""
        self._mutation_listeners.append(fn)

    def set_max_retries(self, n: int) -> None:
        """Live write-back retry-budget change (runtime config reload)."""
        self.client.set_max_retries(n)

    def _notify(self, old: Any, new: Any) -> None:
        deferred = self._deferred_notify.get(threading.get_ident())
        if deferred is not None:
            deferred[1].append((old, new))
            return
        for fn in self._mutation_listeners:
            fn(old, new)

    def apply_external_delete(self, namespace: str, name: str) -> None:
        with self._write_mutex:
            old = self._store.get(namespace, name)
            self._store.delete(namespace, name)
            if old is not None:
                self._notify(old, None)

    def apply_external_upsert(self, obj: Any) -> None:
        """Absorb another writer's committed object (HA standby tailing):
        store it and notify listeners with the LOCAL previous version as
        `old` so delta consumers (usage tracker) apply the correct diff.
        No write-back is enqueued — the object came FROM the backend.
        Callers must dedup self-originated events (the owner's own writes
        already notified through create/update)."""
        with self._write_mutex:
            old = self._store.get(obj.namespace, obj.name)
            self._store.put(obj)
            self._notify(old, obj)

    def start(self) -> None:
        if not self._sync:
            self.client.start()

    def stop(self) -> None:
        self.client.stop()

    def flush(self) -> None:
        self.client.drain_sync()

    @contextlib.contextmanager
    def deferred_sync(self):
        """Batch sync-mode write-back FOR THE CALLING THREAD: inside the
        context its per-mutation drains are suppressed; ONE drain runs at
        exit. A serving window applies dozens of mutations back to back —
        per-write queue drains (num_buckets pops each) were measurable
        host time, and deferring them changes nothing observable for this
        thread: reads go through the local store (write-through), and the
        drain still completes before the window's responses are released.
        Scoped per thread so a CONCURRENT writer (watch handlers, GC
        subscribers) keeps the full sync-mode drain-on-write guarantee.
        No-op in async mode. Reentrant."""
        if not self._sync:
            yield
            return
        tid = threading.get_ident()
        self._defer_threads[tid] = self._defer_threads.get(tid, 0) + 1
        try:
            yield
        finally:
            n = self._defer_threads[tid] - 1
            if n:
                self._defer_threads[tid] = n
            else:
                del self._defer_threads[tid]
                self.client.drain_sync()

    def _after_write(self) -> None:
        if self._sync and threading.get_ident() not in self._defer_threads:
            self.client.drain_sync()

    def _notify_batch(self, pairs: list) -> None:
        """Deliver a batch of (old, new) pairs: batch-aware listeners
        (BatchableListener) get ONE call, plain listeners get one per pair.
        Must run inside `_write_mutex` like `_notify`, so batched pairs
        cannot interleave with a concurrent writer's notifications."""
        if not pairs:
            return
        for fn in self._mutation_listeners:
            batch = getattr(fn, "batch", None)
            if batch is not None:
                batch(pairs)
            else:
                for old, new in pairs:
                    fn(old, new)

    @contextlib.contextmanager
    def deferred_notifications(self):
        """Coalesce THIS THREAD's mutation notifications into ONE batched
        delivery at context exit (batch-aware listeners get a single
        `batch(pairs)` call — see BatchableListener). A serving window
        commits dozens of reservations back to back, and per-mutation
        listener fan-out (a lock + delta application per consumer per
        write) was measurable host time; one batch per window keeps it
        O(window).

        Correctness contract: the registered delta consumers commute —
        the usage tracker applies additive per-slot diffs and the overhead
        store recomputes from current state — so delivering this thread's
        pairs after a concurrent writer's interleaved mutations reaches
        the same aggregates. A listener that requires immediate
        per-mutation delivery must not run under this context. Local-store
        reads are unaffected (write-through). Reentrant; pairs are
        delivered even when the body raises."""
        tid = threading.get_ident()
        state = self._deferred_notify.get(tid)
        if state is None:
            state = self._deferred_notify[tid] = [0, []]
        state[0] += 1
        try:
            yield
        finally:
            state[0] -= 1
            if state[0] == 0:
                del self._deferred_notify[tid]
                if state[1]:
                    with self._write_mutex:
                        self._notify_batch(state[1])

    def create(self, obj: Any) -> bool:
        with self._write_mutex:
            if not self._store.put_if_absent(obj):
                return False
            self._queue.add_if_absent(Request(key=(obj.namespace, obj.name), type=RequestType.CREATE))
            self._notify(None, obj)
        self._after_write()
        return True

    def update(self, obj: Any) -> bool:
        with self._write_mutex:
            old = self._store.get(obj.namespace, obj.name)
            if old is None:
                return False
            self._store.put(obj)
            self._queue.add_if_absent(Request(key=(obj.namespace, obj.name), type=RequestType.UPDATE))
            self._notify(old, obj)
        self._after_write()
        return True

    def delete(self, namespace: str, name: str) -> None:
        with self._write_mutex:
            old = self._store.get(namespace, name)
            self._store.delete(namespace, name)
            self._queue.add_if_absent(Request(key=(namespace, name), type=RequestType.DELETE))
            if old is not None:
                self._notify(old, None)
        self._after_write()

    def get(self, namespace: str, name: str) -> Optional[Any]:
        return self._store.get(namespace, name)

    def list(self) -> list[Any]:
        return self._store.list()

    def queue_lengths(self) -> list[int]:
        return self._queue.queue_lengths()


class ResourceReservationCache(WriteThroughCache):
    def __init__(self, backend: ClusterBackend, **kw):
        super().__init__(backend, "resourcereservations", **kw)


class DemandCache(WriteThroughCache):
    def __init__(self, backend: ClusterBackend, **kw):
        super().__init__(backend, "demands", **kw)


class SafeDemandCache:
    """Demand cache gated on Demand-CRD existence (safedemands.go:40-127 +
    crd/demand_informer.go): lazily initializes the real cache the first
    time the CRD is observed; all operations no-op before that."""

    def __init__(self, backend: ClusterBackend, **kw):
        self._backend = backend
        self._kw = kw
        self._cache: DemandCache | None = None

    def crd_exists(self) -> bool:
        if self._cache is not None:
            return True
        if self._backend.crd_exists(DEMAND_CRD):
            self._cache = DemandCache(self._backend, **self._kw)
            self._cache.start()
            return True
        return False

    def set_max_retries(self, n: int) -> None:
        self._kw["max_retries"] = int(n)  # applies if the cache appears later
        if self._cache is not None:
            self._cache.set_max_retries(n)

    def get(self, namespace: str, name: str):
        return self._cache.get(namespace, name) if self.crd_exists() else None

    def create(self, obj) -> bool:
        if not self.crd_exists():
            return False
        return self._cache.create(obj)

    def delete(self, namespace: str, name: str) -> None:
        if self.crd_exists():
            self._cache.delete(namespace, name)

    def list(self) -> list[Any]:
        return self._cache.list() if self.crd_exists() else []

    @contextlib.contextmanager
    def deferred_sync(self):
        # Bind the inner cache's context only if the CRD cache exists NOW;
        # a cache appearing mid-context just drains per-write as before.
        if self._cache is None:
            yield
            return
        with self._cache.deferred_sync():
            yield

    def queue_lengths(self) -> list[int]:
        return self._cache.queue_lengths() if self._cache is not None else []

    def flush(self) -> None:
        if self._cache is not None:
            self._cache.flush()

    def stop(self) -> None:
        if self._cache is not None:
            self._cache.stop()
