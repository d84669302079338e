"""Scheduler metric families.

The hook surface the extender and demand manager call, backed by the tagged
registry. Metric names mirror the reference's `foundry.spark.scheduler.*`
series (internal/metrics/metrics.go:29-59) so existing dashboards carry
over; tag names likewise (metrics.go:61-76).
"""

from __future__ import annotations

import threading
import time

from spark_scheduler_tpu_torch.core.sparkpods import find_instance_group
from spark_scheduler_tpu_torch.metrics.registry import MetricRegistry

REQUEST_COUNTER = "foundry.spark.scheduler.requests"
SCHEDULE_TIME = "foundry.spark.scheduler.schedule.time"
RECONCILIATION_TIME = "foundry.spark.scheduler.reconciliation.time"
WAIT_TIME = "foundry.spark.scheduler.wait.time"
RETRY_TIME = "foundry.spark.scheduler.retry.time"
CROSS_AZ_TRAFFIC = "foundry.spark.scheduler.az.cross.traffic"
TOTAL_TRAFFIC = "foundry.spark.scheduler.total.traffic"
APP_ZONES_COUNT = "foundry.spark.scheduler.application.zones.count"
PACKING_EFFICIENCY = "foundry.spark.scheduler.packing.efficiency"
SINGLE_AZ_PACK_FAILURE = (
    "foundry.spark.scheduler.singleazdynamicallocationpackfailure.count"
)
COMPACTION_TIME = "foundry.spark.scheduler.softreservation.compaction.time"

TAG_ROLE = "sparkrole"
TAG_OUTCOME = "outcome"
TAG_INSTANCE_GROUP = "instance-group"
TAG_DIMENSION = "dimension"
TAG_FUNCTION = "function"


class SchedulerMetrics:
    """Request-path metrics (ScheduleTimer, metrics.go:149-204 + cross-AZ
    reporter metrics.go:206-254 + packing efficiency, binpack.go:25-64)."""

    def __init__(
        self,
        registry: MetricRegistry | None = None,
        instance_group_label: str = "instance-group",
        clock=time.time,
    ):
        self.registry = registry or MetricRegistry()
        self._label = instance_group_label
        self._clock = clock
        # First-failure timestamps per pod, for wait/retry times
        # (metrics.go:184-204): wait = now - pod creation; retry = now -
        # first failed attempt. Entries are dropped on success or by
        # `cleanup()` (pods deleted without ever succeeding would otherwise
        # accumulate forever).
        self._first_failure: dict[tuple[str, str], float] = {}
        self._first_failure_max_age_s = 6 * 3600.0
        # Request threads and the reporter tick both touch _first_failure.
        self._ff_lock = threading.Lock()

    def _group(self, pod) -> str:
        return find_instance_group(pod, self._label) or ""

    # ------------------------------------------------------------- extender

    def mark_schedule_outcome(self, pod, role: str, outcome: str, elapsed_s: float):
        tags = {
            TAG_ROLE: role,
            TAG_OUTCOME: outcome,
            TAG_INSTANCE_GROUP: self._group(pod),
        }
        self.registry.counter(REQUEST_COUNTER, **tags).inc()
        self.registry.histogram(SCHEDULE_TIME, **tags).update(elapsed_s)
        now = self._clock()
        self.registry.histogram(WAIT_TIME, **tags).update(
            max(now - pod.creation_timestamp, 0.0)
        )
        with self._ff_lock:
            first = self._first_failure.get(pod.key)
            if outcome.startswith("success"):
                self._first_failure.pop(pod.key, None)
        if first is not None:
            self.registry.histogram(RETRY_TIME, **tags).update(max(now - first, 0.0))

    def mark_failed_scheduling_attempt(self, pod, outcome: str):
        with self._ff_lock:
            self._first_failure.setdefault(pod.key, self._clock())

    def forget_pod(self, pod) -> None:
        """Pod deleted without ever scheduling — drop its retry state."""
        with self._ff_lock:
            self._first_failure.pop(pod.key, None)

    def report_once(self) -> None:
        """Periodic eviction of abandoned retry state (ReporterRunner tick)."""
        cutoff = self._clock() - self._first_failure_max_age_s
        with self._ff_lock:
            stale = [k for k, t in self._first_failure.items() if t <= cutoff]
            for k in stale:
                del self._first_failure[k]

    def mark_reconciliation_finished(self, elapsed_s: float, instance_group: str = ""):
        self.registry.histogram(
            RECONCILIATION_TIME, **{TAG_INSTANCE_GROUP: instance_group}
        ).update(elapsed_s)

    def mark_compaction(self, elapsed_s: float):
        self.registry.histogram(COMPACTION_TIME).update(elapsed_s)

    def mark_single_az_dynamic_allocation_pack_failure(self, zone: str):
        self.registry.counter(SINGLE_AZ_PACK_FAILURE, zone=zone).inc()

    # -------------------------------------------------------------- packing

    def report_packing_efficiency(self, binpacker_name: str, packing):
        """Avg packing efficiency per dimension (metrics/binpack.go:37-64)."""
        for dim, value in (
            ("CPU", packing.efficiency_cpu),
            ("Memory", packing.efficiency_memory),
            ("GPU", packing.efficiency_gpu),
            ("Max", packing.efficiency_max),
        ):
            self.registry.histogram(
                PACKING_EFFICIENCY,
                **{TAG_FUNCTION: binpacker_name, TAG_DIMENSION: dim},
            ).update(value)

    def report_cross_zone(self, driver_node: str, executor_nodes, nodes):
        """Cross-AZ pod pairs for one app (metrics.go:206-254): pods paired
        across different zones / total pairs, plus distinct-zone count."""
        zone_of = {n.name: n.zone for n in nodes}
        placements = [driver_node] + list(executor_nodes)
        per_zone: dict[str, int] = {}
        for name in placements:
            z = zone_of.get(name)
            if z is None:
                return  # node vanished; skip like the reference's error path
            per_zone[z] = per_zone.get(z, 0) + 1
        total = len(placements)
        total_pairs = total * (total - 1) // 2
        same_pairs = sum(c * (c - 1) // 2 for c in per_zone.values())
        self.registry.counter(CROSS_AZ_TRAFFIC).inc(total_pairs - same_pairs)
        self.registry.counter(TOTAL_TRAFFIC).inc(total_pairs)
        self.registry.histogram(APP_ZONES_COUNT).update(len(per_zone))
