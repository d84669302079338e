"""Demand lifecycle: creation on failed fits, deletion on success/schedule.

Rebuilds internal/extender/demand.go:58-198 and demand_gc.go:27-51. Demands
are named "demand-<pod>" and carry the resources the pod's application could
not get; the DemandGC deletes a pod's demand when the pod gets scheduled
(covering races the inline deletions miss).
"""

from __future__ import annotations

from typing import Optional

from spark_scheduler_tpu_torch.models.demands import (
    Demand,
    DemandSpec,
    DemandUnit,
    demand_name_for_pod,
)
from spark_scheduler_tpu_torch.models.kube import Pod, PodCondition
from spark_scheduler_tpu_torch.models.resources import Resources
from spark_scheduler_tpu_torch.core.sparkpods import (
    SPARK_APP_ID_LABEL,
    SparkApplicationResources,
    find_instance_group,
    is_spark_scheduler_pod,
)

POD_DEMAND_CREATED_CONDITION = "PodDemandCreated"


class DemandManager:
    def __init__(self, backend, demand_cache, instance_group_label: str,
                 is_single_az_binpacker: bool = False, events=None, waste=None,
                 clock=None):
        import time as _time

        self._backend = backend
        self._cache = demand_cache
        self._instance_group_label = instance_group_label
        self._is_single_az = is_single_az_binpacker
        self._events = events
        self._waste = waste
        self._clock = clock or _time.time

    def deferred_sync(self):
        """Window-scoped write-back batching (WriteThroughCache.deferred_sync)
        for this manager's demand cache."""
        return self._cache.deferred_sync()

    # -- creation -----------------------------------------------------------

    def create_demand_for_application(
        self, driver: Pod, app_resources: SparkApplicationResources
    ) -> Optional[Demand]:
        """Driver unit (count 1, attributed to the driver pod) + one unit of
        min-executor count (demand.go:172-198)."""
        if not self._cache.crd_exists():
            return None
        units = [
            DemandUnit(
                resources=app_resources.driver_resources.copy(),
                count=1,
                pod_names_by_namespace={driver.namespace: [driver.name]},
            )
        ]
        if app_resources.min_executor_count > 0:
            units.append(
                DemandUnit(
                    resources=app_resources.executor_resources.copy(),
                    count=app_resources.min_executor_count,
                )
            )
        return self._create(driver, units, zone=None)

    def create_demand_for_executor(
        self, executor: Pod, executor_resources: Resources, zone: str | None = None
    ) -> Optional[Demand]:
        if not self._cache.crd_exists():
            return None
        units = [
            DemandUnit(
                resources=executor_resources.copy(),
                count=1,
                pod_names_by_namespace={executor.namespace: [executor.name]},
            )
        ]
        return self._create(executor, units, zone=zone)

    def _create(self, pod: Pod, units: list[DemandUnit], zone: str | None) -> Optional[Demand]:
        instance_group = find_instance_group(pod, self._instance_group_label)
        if instance_group is None:
            return None  # no instance group -> skip demand (demand.go:93-99)
        app_id = pod.labels.get(SPARK_APP_ID_LABEL)
        if app_id is None:
            return None
        demand = Demand(
            name=demand_name_for_pod(pod),
            namespace=pod.namespace,
            labels={SPARK_APP_ID_LABEL: app_id},
            owner_pod_uid=pod.uid,
            # creationTimestamp rides the uninterpreted-metadata slot (it
            # survives webhook conversion verbatim); the autoscaler anchors
            # demand-to-fulfilled latency on it.
            metadata_extra={"creationTimestamp": self._clock()},
            spec=DemandSpec(
                instance_group=instance_group,
                units=units,
                enforce_single_zone_scheduling=self._is_single_az,
                zone=zone,
            ),
        )
        created = self._cache.create(demand)
        if not created:
            # already exists for the pod -> no action (demand.go:118-126)
            return self._cache.get(demand.namespace, demand.name)
        if self._events is not None:
            self._events.emit_demand_created(demand)
        if self._waste is not None:
            self._waste.on_demand_created(pod.key)
        pod.set_condition(PodCondition(type=POD_DEMAND_CREATED_CONDITION, status=True))
        return demand

    # -- deletion -----------------------------------------------------------

    def delete_demand_if_exists(self, pod: Pod, source: str = "extender") -> None:
        if not self._cache.crd_exists():
            return
        name = demand_name_for_pod(pod)
        demand = self._cache.get(pod.namespace, name)
        if demand is not None:
            self._cache.delete(pod.namespace, name)
            if self._events is not None:
                self._events.emit_demand_deleted(demand, source)


def start_demand_gc(backend, demand_manager: DemandManager) -> None:
    """Delete a pod's demand when it transitions to scheduled
    (demand_gc.go:35-51 + common/utils/pods.go OnPodScheduled)."""

    def on_update(old: Pod, new: Pod) -> None:
        if not is_spark_scheduler_pod(new):
            return
        if not old.node_name and new.node_name:
            demand_manager.delete_demand_if_exists(new, source="DemandGC")

    backend.subscribe("pods", on_update=on_update)
