"""Scheduling-waste reporter (metrics/waste.go:36-298).

Tracks, per pending pod, its failed scheduling attempts and the create /
fulfill times of its Demand, and on successful scheduling attributes the
elapsed "waste" to a phase:

  before-demand-creation                 first failure -> demand created
  after-demand-fulfilled                 demand fulfilled -> scheduled
  after-demand-fulfilled-no-failures     fulfilled -> scheduled, no failures after
  after-demand-fulfilled-since-last-failure  last failure after fulfillment -> scheduled
  total-time-no-demand                   first failure -> scheduled (no demand)

Histograms are tagged by waste type + instance group; entries for pods that
terminated are dropped after the 6h cleanup tick (waste.go:279-298).
"""

from __future__ import annotations

import dataclasses
import threading
import time

from spark_scheduler_tpu_torch.core.sparkpods import find_instance_group
from spark_scheduler_tpu_torch.metrics.registry import MetricRegistry

SCHEDULING_WASTE = "foundry.spark.scheduler.scheduling.waste"
SCHEDULING_WASTE_PER_GROUP = "foundry.spark.scheduler.scheduling.wasteperinstancegroup"

CLEANUP_AFTER_S = 6 * 3600.0  # waste.go cleanup cadence


@dataclasses.dataclass
class _PodInfo:
    first_failure: float | None = None
    last_failure: float | None = None
    demand_created: float | None = None
    demand_fulfilled: float | None = None
    done: float | None = None  # scheduled or deleted


class WasteReporter:
    def __init__(
        self,
        registry: MetricRegistry | None = None,
        instance_group_label: str = "instance-group",
        clock=time.time,
    ):
        self.registry = registry or MetricRegistry()
        self._label = instance_group_label
        self._clock = clock
        self._pods: dict[tuple[str, str], _PodInfo] = {}
        # Request threads, informer callbacks, and the reporter tick all
        # touch _pods.
        self._lock = threading.Lock()

    # --------------------------------------------------------------- inputs

    def mark_failed_scheduling_attempt(self, pod, outcome: str) -> None:
        now = self._clock()
        with self._lock:
            info = self._pods.setdefault(pod.key, _PodInfo())
            if info.first_failure is None:
                info.first_failure = now
            info.last_failure = now

    def on_demand_created(self, pod_key) -> None:
        now = self._clock()
        with self._lock:
            self._pods.setdefault(pod_key, _PodInfo()).demand_created = now

    def on_demand_fulfilled(self, pod_key) -> None:
        now = self._clock()
        with self._lock:
            self._pods.setdefault(pod_key, _PodInfo()).demand_fulfilled = now

    def on_pod_scheduled(self, pod) -> None:
        now = self._clock()
        with self._lock:
            info = self._pods.get(pod.key)
            if info is None or info.done is not None:
                return
            # Claim the transition under the lock so a concurrently
            # delivered duplicate update can't double-count the histograms.
            info = dataclasses.replace(info, done=now)
            self._pods[pod.key] = info
        group = find_instance_group(pod, self._label) or ""

        def mark(waste_type: str, duration: float) -> None:
            if duration <= 0:
                return
            self.registry.histogram(SCHEDULING_WASTE, wastetype=waste_type).update(
                duration
            )
            self.registry.histogram(
                SCHEDULING_WASTE_PER_GROUP,
                wastetype=waste_type,
                **{"instance-group": group},
            ).update(duration)

        if info.demand_created is None:
            if info.first_failure is not None:
                mark("total-time-no-demand", now - info.first_failure)
            return
        if info.first_failure is not None:
            mark("before-demand-creation", info.demand_created - info.first_failure)
        if info.demand_fulfilled is not None:
            mark("after-demand-fulfilled", now - info.demand_fulfilled)
            if info.last_failure is None or info.last_failure <= info.demand_fulfilled:
                mark("after-demand-fulfilled-no-failures", now - info.demand_fulfilled)
            else:
                mark(
                    "after-demand-fulfilled-since-last-failure",
                    now - info.last_failure,
                )

    def on_pod_deleted(self, pod) -> None:
        now = self._clock()
        with self._lock:
            info = self._pods.get(pod.key)
            if info is not None and info.done is None:
                info.done = now

    # -------------------------------------------------------------- cleanup

    def cleanup(self) -> None:
        """Drop entries finished more than 6h ago (waste.go:279-298)."""
        now = self._clock()
        with self._lock:
            stale = [
                k
                for k, v in self._pods.items()
                if v.done is not None and now - v.done >= CLEANUP_AFTER_S
            ]
            for k in stale:
                del self._pods[k]
