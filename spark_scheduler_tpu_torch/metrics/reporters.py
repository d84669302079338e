"""Periodic metric reporters (cmd/server.go:239-247 starts five of these in
the reference; each ticks every 30s, metrics.go:79).

Every reporter exposes `report_once()` so tests and the serving layer can
drive it synchronously; `ReporterRunner` threads them on a cadence.
"""

from __future__ import annotations

import threading
import time

from spark_scheduler_tpu_torch.core.sparkpods import (
    ROLE_DRIVER,
    SPARK_ROLE_LABEL,
    find_instance_group,
)
from spark_scheduler_tpu_torch.metrics.registry import MetricRegistry

USAGE_CPU = "foundry.spark.scheduler.resource.usage.cpu"
USAGE_MEMORY = "foundry.spark.scheduler.resource.usage.memory"
USAGE_GPU = "foundry.spark.scheduler.resource.usage.nvidia.com/gpu"
LIFECYCLE_MAX = "foundry.spark.scheduler.pod.lifecycle.max"
LIFECYCLE_MIN = "foundry.spark.scheduler.pod.lifecycle.min"
LIFECYCLE_P99 = "foundry.spark.scheduler.pod.lifecycle.p99"
LIFECYCLE_P95 = "foundry.spark.scheduler.pod.lifecycle.p95"
LIFECYCLE_P50 = "foundry.spark.scheduler.pod.lifecycle.p50"
LIFECYCLE_COUNT = "foundry.spark.scheduler.pod.lifecycle.count"
CACHED_OBJECTS = "foundry.spark.scheduler.cache.objects.count"
INFLIGHT_REQUESTS = "foundry.spark.scheduler.cache.inflight.count"
UNEXPLAINED_DIFFERENCE = "foundry.spark.scheduler.cache.unexplained.difference"
# Size skew explained by informer propagation delay (cache.go:33-34).
INFORMER_DELAY_BUFFER = 5
SOFT_RESERVATION_COUNT = "foundry.spark.scheduler.softreservation.count"
SOFT_RESERVATION_EXECUTORS = "foundry.spark.scheduler.softreservation.executorcount"

TICK_INTERVAL_S = 30.0  # metrics.go:79
STUCK_POD_THRESHOLD_S = 12 * 3600.0  # queue.go:32


class UsageReporter:
    """Reserved CPU/mem/GPU gauges per node, with stale-series cleanup
    (metrics/usage.go:33-114)."""

    def __init__(self, registry: MetricRegistry, reservation_manager):
        self._registry = registry
        self._rrm = reservation_manager
        self._seen_nodes: set[str] = set()

    def report_once(self) -> None:
        usage = self._rrm.get_reserved_resources()  # {node: Resources}
        live = set(usage)
        for node in self._seen_nodes - live:  # stale tag cleanup
            for name in (USAGE_CPU, USAGE_MEMORY, USAGE_GPU):
                self._registry.unregister(name, nodename=node)
        self._seen_nodes = live
        for node, res in usage.items():
            self._registry.gauge(USAGE_CPU, nodename=node).set(res.cpu_milli)
            self._registry.gauge(USAGE_MEMORY, nodename=node).set(res.mem_kib)
            self._registry.gauge(USAGE_GPU, nodename=node).set(res.gpu_milli)


class CacheReporter:
    """Cache depth vs backend truth + inflight write-queue lengths + drift
    detection (metrics/cache.go:32-141).

    With a `backend`, each tick also lists the backend's truth for every
    cached type and compares: a size skew larger than the inflight write
    queue plus the informer-delay buffer is UNEXPLAINED — exactly the
    failure mode the async fire-and-forget write path can produce — and is
    surfaced as a warning (with per-object only-in-cache / only-in-backend
    lines, cache.go:115-127) plus the `cache.unexplained.difference`
    gauge."""

    def __init__(
        self,
        registry: MetricRegistry,
        caches: dict[str, object],
        backend=None,
    ):
        self._registry = registry
        self._caches = caches  # {object_type: WriteThroughCache}
        self._backend = backend

    def report_once(self) -> None:
        from spark_scheduler_tpu_torch.tracing import svc1log

        for obj_type, cache in self._caches.items():
            crd_gate = getattr(cache, "crd_exists", None)
            if crd_gate is not None and not crd_gate():
                continue  # SafeDemandCache before the CRD appears
            cached = cache.list()
            self._registry.gauge(
                CACHED_OBJECTS, objectType=obj_type, source="cache"
            ).set(len(cached))
            total_queue = 0
            for i, depth in enumerate(cache.queue_lengths()):
                total_queue += depth
                self._registry.gauge(
                    INFLIGHT_REQUESTS, objectType=obj_type, queueIndex=str(i)
                ).set(depth)
            if self._backend is None:
                continue
            try:
                actual = self._backend.list(obj_type)
            except Exception as exc:
                svc1log().error(
                    "failed to list backend objects for cache drift check",
                    objectType=obj_type, error=repr(exc),
                )
                continue
            self._registry.gauge(
                CACHED_OBJECTS, objectType=obj_type, source="lister"
            ).set(len(actual))
            skew = abs(len(actual) - len(cached))
            unexplained = skew > total_queue + INFORMER_DELAY_BUFFER
            self._registry.gauge(
                UNEXPLAINED_DIFFERENCE, objectType=obj_type
            ).set(skew if unexplained else 0)
            if unexplained:
                svc1log().warn(
                    "found unexplained cache size difference",
                    objectType=obj_type,
                    cached=len(cached), actual=len(actual),
                    inflight=total_queue,
                )
                def _key(obj):
                    return getattr(obj, "uid", None) or (
                        getattr(obj, "namespace", ""), getattr(obj, "name", "")
                    )

                cached_keys = {_key(o) for o in cached}
                actual_keys = {_key(o) for o in actual}
                for obj in actual:
                    if _key(obj) not in cached_keys:
                        svc1log().warn(
                            "object only exists in backend",
                            objectType=obj_type,
                            name=getattr(obj, "name", ""),
                            namespace=getattr(obj, "namespace", ""),
                        )
                for obj in cached:
                    if _key(obj) not in actual_keys:
                        svc1log().warn(
                            "object only exists in cache",
                            objectType=obj_type,
                            name=getattr(obj, "name", ""),
                            namespace=getattr(obj, "namespace", ""),
                        )


class SoftReservationReporter:
    """Soft-reservation app/executor counts (metrics/softreservations.go:31-104)."""

    def __init__(self, registry: MetricRegistry, soft_store):
        self._registry = registry
        self._store = soft_store

    def report_once(self) -> None:
        self._registry.gauge(SOFT_RESERVATION_COUNT).set(
            self._store.application_count()
        )
        self._registry.gauge(SOFT_RESERVATION_EXECUTORS).set(
            self._store.active_extra_executor_count()
        )


class QueueReporter:
    """Pod lifecycle age histograms per (instance group, role, lifecycle)
    with stuck-pod detection (metrics/queue.go:31-192). Lifecycle of a pod:
    queued (not scheduled), initializing (scheduled, not ready), ready."""

    def __init__(
        self,
        registry: MetricRegistry,
        backend,
        instance_group_label: str,
        clock=time.time,
        on_stuck_pod=None,
    ):
        self._registry = registry
        self._backend = backend
        self._label = instance_group_label
        self._clock = clock
        self._on_stuck_pod = on_stuck_pod
        self._seen_tags: set[tuple[str, str, str]] = set()

    @staticmethod
    def lifecycle_of(pod) -> str:
        if not pod.is_scheduled():
            return "queued"
        ready = pod.get_condition("Ready")
        if ready is None or not ready.status:
            return "initializing"
        return "ready"

    def report_once(self) -> None:
        now = self._clock()
        buckets: dict[tuple[str, str, str], list[float]] = {}
        for pod in self._backend.list_pods():
            role = pod.labels.get(SPARK_ROLE_LABEL)
            if role is None or pod.is_terminated():
                continue
            lifecycle = self.lifecycle_of(pod)
            if lifecycle == "ready":
                continue  # only pending/initializing ages are interesting
            group = find_instance_group(pod, self._label) or ""
            age = max(now - pod.creation_timestamp, 0.0)
            buckets.setdefault((group, role, lifecycle), []).append(age)
            if age > STUCK_POD_THRESHOLD_S and self._on_stuck_pod is not None:
                self._on_stuck_pod(pod, lifecycle, age)
        # Stale-series cleanup: a bucket that emptied must not keep reporting
        # its last values (same pattern as UsageReporter).
        for group, role, lifecycle in self._seen_tags - set(buckets):
            tags = {
                "instance-group": group,
                "sparkrole": role,
                "lifecycle": lifecycle,
            }
            for name in (
                LIFECYCLE_COUNT, LIFECYCLE_MAX, LIFECYCLE_MIN,
                LIFECYCLE_P99, LIFECYCLE_P95, LIFECYCLE_P50,
            ):
                self._registry.unregister(name, **tags)
        self._seen_tags = set(buckets)
        for (group, role, lifecycle), ages in buckets.items():
            ages.sort()
            tags = {
                "instance-group": group,
                "sparkrole": role,
                "lifecycle": lifecycle,
            }
            n = len(ages)
            self._registry.gauge(LIFECYCLE_COUNT, **tags).set(n)
            self._registry.gauge(LIFECYCLE_MAX, **tags).set(ages[-1])
            self._registry.gauge(LIFECYCLE_MIN, **tags).set(ages[0])
            self._registry.gauge(LIFECYCLE_P99, **tags).set(
                ages[min(int(0.99 * n), n - 1)]
            )
            self._registry.gauge(LIFECYCLE_P95, **tags).set(
                ages[min(int(0.95 * n), n - 1)]
            )
            self._registry.gauge(LIFECYCLE_P50, **tags).set(
                ages[min(int(0.5 * n), n - 1)]
            )


class ReporterRunner:
    """Threads a set of reporters on the 30s tick (cmd/server.go:243-247)."""

    def __init__(self, reporters, interval_s: float = TICK_INTERVAL_S, on_error=None):
        self._reporters = list(reporters)
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._on_error = on_error

    def report_once(self) -> None:
        # Per-reporter isolation: one failing reporter must not starve the
        # others (and must not silently kill the tick loop).
        for r in self._reporters:
            try:
                r.report_once()
            except Exception as exc:
                if self._on_error is not None:
                    self._on_error(r, exc)
                else:
                    import sys
                    import traceback

                    print(
                        f"metric reporter {type(r).__name__} failed: {exc}",
                        file=sys.stderr,
                    )
                    traceback.print_exc()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self._interval):
                self.report_once()

        self._thread = threading.Thread(target=loop, daemon=True, name="metric-reporter")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
