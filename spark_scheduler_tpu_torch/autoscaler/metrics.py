"""Autoscaler metric families, backed by the tagged registry.

Same shape as metrics/scheduler_metrics.py: `foundry.spark.scheduler.*`
names so the series land next to the scheduler's own on dashboards. The
scale-up latency histogram additionally keeps a bounded raw-sample list so
a caller can report exact p50/p99 (the registry histogram's percentiles
are reservoir-bounded approximations past its capacity).

The port's copy of spark_scheduler_tpu/autoscaler/metrics.py, on the
port's metrics/registry.py.
"""

from __future__ import annotations

import threading

from spark_scheduler_tpu_torch.metrics.registry import MetricRegistry

SCALE_UP_LATENCY = "foundry.spark.scheduler.autoscaler.scaleup.latency"
NODES_ADDED = "foundry.spark.scheduler.autoscaler.nodes.added"
NODES_DRAINED = "foundry.spark.scheduler.autoscaler.nodes.drained"
DEMANDS_FULFILLED = "foundry.spark.scheduler.autoscaler.demands.fulfilled"
DEMANDS_UNFULFILLABLE = "foundry.spark.scheduler.autoscaler.demands.unfulfillable"
CLUSTER_SIZE = "foundry.spark.scheduler.autoscaler.cluster.size"
CONSECUTIVE_FAILURES = (
    "foundry.spark.scheduler.autoscaler.consecutive.failures"
)

TAG_INSTANCE_GROUP = "instance-group"

_MAX_RAW_SAMPLES = 8192


class AutoscalerMetrics:
    def __init__(self, registry: MetricRegistry | None = None):
        self.registry = registry or MetricRegistry()
        self._lock = threading.Lock()
        # Raw demand-to-fulfilled latencies (seconds) for exact percentile
        # reporting; bounded so a long-lived server can't grow
        # it without bound.
        self._scaleup_samples: list[float] = []

    # -- hooks ---------------------------------------------------------------

    def on_nodes_added(self, instance_group: str, count: int) -> None:
        self.registry.counter(
            NODES_ADDED, **{TAG_INSTANCE_GROUP: instance_group}
        ).inc(count)

    def on_nodes_drained(self, count: int) -> None:
        self.registry.counter(NODES_DRAINED).inc(count)

    def on_demand_fulfilled(self, instance_group: str, latency_s: float) -> None:
        self.registry.counter(
            DEMANDS_FULFILLED, **{TAG_INSTANCE_GROUP: instance_group}
        ).inc()
        self.registry.histogram(SCALE_UP_LATENCY).update(latency_s)
        with self._lock:
            if len(self._scaleup_samples) < _MAX_RAW_SAMPLES:
                self._scaleup_samples.append(latency_s)

    def on_demand_unfulfillable(self, instance_group: str) -> None:
        self.registry.counter(
            DEMANDS_UNFULFILLABLE, **{TAG_INSTANCE_GROUP: instance_group}
        ).inc()

    def set_cluster_size(self, n: int) -> None:
        self.registry.gauge(CLUSTER_SIZE).set(float(n))

    def set_consecutive_failures(self, n: int) -> None:
        """Failed control-loop passes in a row (0 = healthy); paired with
        the controller's exponential backoff."""
        self.registry.gauge(CONSECUTIVE_FAILURES).set(float(n))

    # -- inspection ----------------------------------------------------------

    def scaleup_latency_samples(self) -> list[float]:
        with self._lock:
            return list(self._scaleup_samples)

    def counts(self) -> dict:
        """Compact {added, drained, fulfilled, unfulfillable} totals across
        instance groups — the test/bench summary view."""
        snap = self.registry.snapshot()

        def total(name: str) -> int:
            return sum(e["value"] for e in snap.get(name, []))

        return {
            "nodes_added": total(NODES_ADDED),
            "nodes_drained": total(NODES_DRAINED),
            "demands_fulfilled": total(DEMANDS_FULFILLED),
            "demands_unfulfillable": total(DEMANDS_UNFULFILLABLE),
        }
