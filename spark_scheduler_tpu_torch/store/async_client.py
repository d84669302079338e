"""Async write-back workers.

Rebuilds internal/cache/async.go:44-224: N worker threads (one per queue
shard) drain write requests and replay them against the backend. Create and
update read the CURRENT object from the local store at drain time (so
compacted consecutive writes collapse into one request carrying the latest
state); conflicts re-read the backend object, fast-forward the stored
resourceVersion and retry; failures retry up to `max_retries` then drop with
a metric. Creates into terminating namespaces are dropped (async.go:88-96);
deletes of already-gone objects succeed.

The shared retry ladder replaced the bare retry count: a
RetryPolicy computes each requeue's backoff (exponential + full jitter,
slept by the background worker — never by drain_sync, whose callers need
deterministic inline drains), a CircuitBreaker fails background writes
fast while the backend is down (a refused request requeues WITHOUT
consuming its retry budget, so nothing is lost — the backend just stops
being hammered; drain_sync bypasses the gate), and `fault_hook` is the
FaultInjector's seam over every drained write (`kube.write.<verb>`).
`max_retries` / `async_client_retry_count` keep working as the attempt
budget: they are the policy's max_attempts minus one.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from spark_scheduler_tpu_torch.faults.retry import CircuitBreaker, RetryPolicy
from spark_scheduler_tpu_torch.store.backend import (
    AlreadyExistsError,
    ClusterBackend,
    ConflictError,
    NamespaceTerminatingError,
    NotFoundError,
)
from spark_scheduler_tpu_torch.store.object_store import ObjectStore
from spark_scheduler_tpu_torch.store.queue import Request, RequestType, ShardedUniqueQueue

DEFAULT_MAX_RETRIES = 5  # config.go:72-77

# Write-back backoff defaults: short base (a conflict storm resolves in
# milliseconds), capped well under the reservation-GC horizon.
DEFAULT_RETRY_POLICY = RetryPolicy(
    max_attempts=DEFAULT_MAX_RETRIES + 1,
    base_delay_s=0.02,
    multiplier=2.0,
    max_delay_s=2.0,
)


class AsyncClientMetrics:
    """Counters mirroring AsyncClientMetrics (async.go:180-224)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.applied: dict[str, int] = {}
        self.retries = 0
        self.dropped = 0
        self.conflicts = 0

    def mark_applied(self, verb: str) -> None:
        with self.lock:
            self.applied[verb] = self.applied.get(verb, 0) + 1

    def mark_retry(self) -> None:
        with self.lock:
            self.retries += 1

    def mark_dropped(self) -> None:
        with self.lock:
            self.dropped += 1

    def mark_conflict(self) -> None:
        with self.lock:
            self.conflicts += 1


class AsyncClient:
    """Write-back pump between an ObjectStore and a backend kind."""

    def __init__(
        self,
        backend: ClusterBackend,
        kind: str,
        store: ObjectStore,
        queue: ShardedUniqueQueue,
        max_retries: int = DEFAULT_MAX_RETRIES,
        metrics: Optional[AsyncClientMetrics] = None,
        on_error: Optional[Callable[[Request, Exception], None]] = None,
        retry_policy: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        on_retry: Optional[Callable[[int, float], None]] = None,
    ):
        self._backend = backend
        self._kind = kind
        self._store = store
        self._queue = queue
        self._max_retries = max_retries
        # `max_retries` stays the attempt budget (back-compat alias for
        # `async-client-retry-count`); the policy supplies the DELAYS.
        self._retry_policy = retry_policy or DEFAULT_RETRY_POLICY
        self._breaker = breaker
        self._on_retry = on_retry  # fn(retry_count, backoff_s) — telemetry
        self.metrics = metrics or AsyncClientMetrics()
        self._on_error = on_error
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        # FaultInjector seam: fn(request) fired on every drained write
        # BEFORE it reaches the backend (the kube client failing, not the
        # apiserver); raising routes into the retry ladder.
        self.fault_hook: Optional[Callable[[Request], None]] = None

    def set_max_retries(self, n: int) -> None:
        """Live retry-budget change (runtime config reload). Read by workers
        without a lock: int assignment is atomic, and an in-flight request
        observing either budget is acceptable."""
        self._max_retries = int(n)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        for bucket in range(self._queue.num_buckets):
            t = threading.Thread(
                target=self._run_worker, args=(bucket,), daemon=True,
                name=f"async-{self._kind}-{bucket}",
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        """Signal workers and join them. Joining matters for the native
        queue backend: destroying the C++ queue while a worker is blocked in
        queue_pop would free the shard mutex under a waiter; the 0.05s pop
        timeout bounds the join."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = [t for t in self._threads if t.is_alive()]

    def _run_worker(self, bucket: int) -> None:
        while not self._stop.is_set():
            req = self._queue.pop(bucket, timeout_s=0.05)
            if req is not None:
                self.process(req, allow_backoff=True)

    def drain_sync(self) -> None:
        """Synchronously drain every shard — deterministic test mode and
        graceful-shutdown flush."""
        for bucket in range(self._queue.num_buckets):
            while True:
                req = self._queue.pop(bucket, timeout_s=0)
                if req is None:
                    break
                self.process(req)

    # -- request processing -------------------------------------------------

    def process(self, req: Request, allow_backoff: bool = False) -> None:
        from spark_scheduler_tpu_torch.faults.errors import BreakerOpenError
        from spark_scheduler_tpu_torch.tracing import tracer

        with tracer().span(
            "write-back",
            verb=req.type.name.lower(),
            key=f"{req.key[0]}/{req.key[1]}",
        ):
            breaker = self._breaker
            try:
                if (
                    breaker is not None
                    and allow_backoff
                    and not breaker.allow()
                ):
                    # Backend known-down: fail fast into the requeue
                    # instead of another doomed round-trip. Background
                    # path only — drain_sync needs inline determinism
                    # (and termination), so it always attempts the call.
                    raise BreakerOpenError(breaker.name or self._kind)
                if self.fault_hook is not None:
                    self.fault_hook(req)
                if req.type == RequestType.CREATE:
                    self._do_create(req)
                elif req.type == RequestType.UPDATE:
                    self._do_update(req)
                else:
                    self._do_delete(req)
            except NamespaceTerminatingError:
                self.metrics.mark_dropped()  # not retryable (async.go:88-96)
                if breaker is not None:
                    # The backend ANSWERED — this is a healthy dependency
                    # refusing one request, and it must release a
                    # half-open probe slot or the breaker wedges open.
                    breaker.on_success()
            except BreakerOpenError:
                # The refusal is the breaker's state, not this request's
                # failure: requeue WITHOUT consuming retry budget (the
                # 5-step ladder exhausts in well under reset_timeout, so
                # burning it here would drop every write queued while
                # the breaker is open) and wait out the policy backoff.
                self.metrics.mark_retry()
                pause = self._retry_policy.delay(req.retry_count)
                if self._on_retry is not None:
                    self._on_retry(req.retry_count + 1, pause)
                if pause > 0:
                    self._stop.wait(pause)
                self._queue.add_if_absent(req)
            except Exception as exc:  # bounded retry (async.go:139-154)
                if breaker is not None:
                    breaker.on_failure()
                self._maybe_retry(req, exc, allow_backoff)
            else:
                if breaker is not None:
                    breaker.on_success()

    def _do_create(self, req: Request) -> None:
        obj = self._store.get(*req.key)
        if obj is None:
            return  # deleted since enqueue
        try:
            created = self._backend.create(self._kind, obj)
        except AlreadyExistsError:
            latest = self._backend.get(self._kind, *req.key)
            if latest is not None:
                self._store.override_resource_version_if_newer(latest)
            self.metrics.mark_applied("create")
            return
        self._store.override_resource_version_if_newer(created)
        self.metrics.mark_applied("create")

    def _do_update(self, req: Request) -> None:
        obj = self._store.get(*req.key)
        if obj is None:
            return
        try:
            updated = self._backend.update(self._kind, obj)
        except ConflictError:
            self.metrics.mark_conflict()
            latest = self._backend.get(self._kind, *req.key)
            if latest is not None:
                # fast-forward and retry with the new resourceVersion
                self._store.override_resource_version_if_newer(latest)
            raise
        except NotFoundError:
            # object vanished server-side; recreate it (lost-write recovery)
            created = self._backend.create(self._kind, obj)
            self._store.override_resource_version_if_newer(created)
            self.metrics.mark_applied("update")
            return
        self._store.override_resource_version_if_newer(updated)
        self.metrics.mark_applied("update")

    def _do_delete(self, req: Request) -> None:
        try:
            self._backend.delete(self._kind, *req.key)
        except NotFoundError:
            pass  # already gone — success
        self.metrics.mark_applied("delete")

    def _maybe_retry(
        self, req: Request, exc: Exception, allow_backoff: bool = False
    ) -> None:
        if req.retry_count < self._max_retries:
            self.metrics.mark_retry()
            pause = self._retry_policy.delay(req.retry_count)
            if self._on_retry is not None:
                self._on_retry(req.retry_count + 1, pause)
            if allow_backoff and pause > 0:
                # Background worker only: the requeue waits out the
                # backoff (interruptible by stop()) so a failing backend
                # is probed at the policy's cadence, not the pop loop's.
                # drain_sync callers need inline determinism and skip it.
                self._stop.wait(pause)
            self._queue.add_if_absent(req.with_increased_retry())
        else:
            self.metrics.mark_dropped()
            if self._on_error is not None:
                self._on_error(req, exc)
