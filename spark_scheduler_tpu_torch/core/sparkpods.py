"""Spark application shapes from pod annotations + driver FIFO listing.

Rebuilds internal/extender/sparkpods.go and internal/common/constants.go:
the driver pod carries the whole application's resource shape in
annotations; executors are matched back to their driver by the app-id label.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from spark_scheduler_tpu_torch.models.kube import Pod
from spark_scheduler_tpu_torch.models.reservations import DRIVER_RESERVATION  # noqa: F401  (re-export)
from spark_scheduler_tpu_torch.models.resources import (
    CPU_DIM,
    GPU_DIM,
    MEM_DIM,
    Resources,
    parse_quantity,
)

# Scheduler identity + labels (constants.go:17-29)
SPARK_SCHEDULER_NAME = "spark-scheduler"
SPARK_ROLE_LABEL = "spark-role"
SPARK_APP_ID_LABEL = "spark-app-id"
ROLE_DRIVER = "driver"
ROLE_EXECUTOR = "executor"

# Annotation keys (constants.go:31-51)
DRIVER_CPU = "spark-driver-cpu"
DRIVER_MEMORY = "spark-driver-mem"
DRIVER_GPUS = "spark-driver-nvidia.com/gpu"
EXECUTOR_CPU = "spark-executor-cpu"
EXECUTOR_MEMORY = "spark-executor-mem"
EXECUTOR_GPUS = "spark-executor-nvidia.com/gpu"
DYNAMIC_ALLOCATION_ENABLED = "spark-dynamic-allocation-enabled"
EXECUTOR_COUNT = "spark-executor-count"
DA_MIN_EXECUTOR_COUNT = "spark-dynamic-allocation-min-executor-count"
DA_MAX_EXECUTOR_COUNT = "spark-dynamic-allocation-max-executor-count"


class SparkPodError(ValueError):
    """Invalid/missing annotations (maps to failure-internal outcomes)."""


@dataclasses.dataclass
class SparkApplicationResources:
    driver_resources: Resources
    executor_resources: Resources
    min_executor_count: int
    max_executor_count: int


def spark_resources(pod: Pod) -> SparkApplicationResources:
    """Parse the driver's annotation set (sparkpods.go:79-138), with the same
    validation: ExecutorCount required iff static allocation; DA min/max
    required iff dynamic; GPUs optional.

    Memoized per pod OBJECT: the FIFO path re-parses every pending earlier
    driver on every request (quadratic in queue depth), and exact-decimal
    quantity parsing is the host hot spot under windowed serving. Updated
    pods arrive as fresh objects (the backend replaces, never mutates), so
    object identity is a safe cache key."""
    cached = pod.__dict__.get("_spark_resources_cache")
    if cached is not None:
        if isinstance(cached, SparkPodError):
            raise cached
        return cached
    try:
        out = _parse_spark_resources(pod)
    except SparkPodError as exc:
        pod.__dict__["_spark_resources_cache"] = exc
        raise
    pod.__dict__["_spark_resources_cache"] = out
    return out


def _parse_spark_resources(pod: Pod) -> SparkApplicationResources:
    ann = pod.annotations
    da_raw = ann.get(DYNAMIC_ALLOCATION_ENABLED)
    dynamic = False
    if da_raw is not None:
        if da_raw.lower() not in ("true", "false", "1", "0"):
            raise SparkPodError(
                "annotation DynamicAllocationEnabled could not be parsed as a boolean"
            )
        dynamic = da_raw.lower() in ("true", "1")

    def need(key: str) -> str:
        val = ann.get(key)
        if val is None:
            raise SparkPodError(f"annotation {key} is missing from driver")
        return val

    def parse_count(key: str) -> int:
        val = need(key)
        try:
            return int(parse_quantity(val, GPU_DIM) // 1000)
        except ValueError as e:
            raise SparkPodError(f"annotation {key} does not have a parseable value {val}") from e

    if dynamic:
        for key in (DA_MIN_EXECUTOR_COUNT, DA_MAX_EXECUTOR_COUNT):
            if key not in ann:
                raise SparkPodError(
                    f"annotation {key} is required when DynamicAllocationEnabled is true"
                )
        min_count = parse_count(DA_MIN_EXECUTOR_COUNT)
        max_count = parse_count(DA_MAX_EXECUTOR_COUNT)
    else:
        if EXECUTOR_COUNT not in ann:
            raise SparkPodError(
                "annotation ExecutorCount is required when DynamicAllocationEnabled is false"
            )
        min_count = max_count = parse_count(EXECUTOR_COUNT)

    def parse_res(cpu_key: str, mem_key: str, gpu_key: str) -> Resources:
        try:
            return Resources(
                parse_quantity(need(cpu_key), CPU_DIM),
                parse_quantity(need(mem_key), MEM_DIM),
                parse_quantity(ann.get(gpu_key, "0"), GPU_DIM),
            )
        except ValueError as e:
            raise SparkPodError(str(e)) from e

    return SparkApplicationResources(
        driver_resources=parse_res(DRIVER_CPU, DRIVER_MEMORY, DRIVER_GPUS),
        executor_resources=parse_res(EXECUTOR_CPU, EXECUTOR_MEMORY, EXECUTOR_GPUS),
        min_executor_count=min_count,
        max_executor_count=max_count,
    )


def find_instance_group(pod: Pod, instance_group_label: str) -> Optional[str]:
    """Instance group from nodeAffinity match expressions or nodeSelector
    (internal/podspec.go:29-53)."""
    values = pod.node_affinity.get(instance_group_label)
    if values:
        return values[0]
    sel = pod.node_selector.get(instance_group_label)
    if sel is not None:
        return sel
    return None


def pod_matches_node(pod: Pod, node) -> bool:
    """Required node affinity + nodeSelector matching (the subset of
    v1affinityhelper.GetRequiredNodeAffinity().Match the scheduler needs)."""
    for k, v in pod.node_selector.items():
        if node.labels.get(k) != v:
            return False
    for k, allowed in pod.node_affinity.items():
        if node.labels.get(k) not in allowed:
            return False
    return True


class SparkPodLister:
    """Driver/executor pod queries over the backend (sparkpods.go:39-77)."""

    def __init__(self, backend, instance_group_label: str):
        self._backend = backend
        self.instance_group_label = instance_group_label
        # Per-app and per-role listing are on the executor/FIFO hot paths;
        # with an index-capable backend they touch one bucket instead of
        # scanning every pod (the reference's informer indexers).
        register = getattr(backend, "register_pod_index", None)
        if register is not None:
            register(SPARK_APP_ID_LABEL)
            register(SPARK_ROLE_LABEL)

    def list_pending_drivers(self) -> list[Pod]:
        """All unscheduled, undeleted driver pods, oldest first — ONE backend
        scan shared by every request of a serving window (the per-request
        filter in `earlier_of` is then O(pending))."""
        out = [
            p
            for p in self._backend.list_pods(labels={SPARK_ROLE_LABEL: ROLE_DRIVER})
            if not p.node_name and p.deletion_timestamp is None
        ]
        out.sort(key=lambda p: p.creation_timestamp)
        return out

    @staticmethod
    def is_earlier_driver(p: Pod, p_group: Optional[str], driver: Pod,
                          driver_group: Optional[str]) -> bool:
        """The FIFO predecessor predicate (same scheduler + instance group,
        strictly earlier creation, sparkpods.go:51-77) — THE single
        definition, shared by the solo path and the window assembly so the
        two cannot drift."""
        return (
            p.scheduler_name == driver.scheduler_name
            and p.creation_timestamp < driver.creation_timestamp
            and p_group == driver_group
        )

    @staticmethod
    def earlier_of(pending: list[Pod], driver: Pod, group: Optional[str],
                   instance_group_label: str) -> list[Pod]:
        """Filter a `list_pending_drivers` snapshot down to `driver`'s FIFO
        predecessors. Snapshot is already oldest-first."""
        return [
            p
            for p in pending
            if SparkPodLister.is_earlier_driver(
                p, find_instance_group(p, instance_group_label), driver, group
            )
        ]

    def list_earlier_drivers(self, driver: Pod) -> list[Pod]:
        """Unscheduled drivers of the same scheduler + instance group created
        strictly earlier, oldest first (sparkpods.go:51-77)."""
        group = find_instance_group(driver, self.instance_group_label)
        return self.earlier_of(
            self.list_pending_drivers(), driver, group, self.instance_group_label
        )

    def get_driver_pod(self, app_id: str, namespace: str) -> Optional[Pod]:
        pods = self._backend.list_pods(
            namespace=namespace,
            labels={SPARK_APP_ID_LABEL: app_id, SPARK_ROLE_LABEL: ROLE_DRIVER},
        )
        return pods[0] if len(pods) == 1 else None

    def get_driver_for_executor(self, executor: Pod) -> Optional[Pod]:
        return self.get_driver_pod(
            executor.labels.get(SPARK_APP_ID_LABEL, ""), executor.namespace
        )

    def list_app_pods(self, app_id: str, namespace: str) -> list[Pod]:
        return self._backend.list_pods(
            namespace=namespace, labels={SPARK_APP_ID_LABEL: app_id}
        )


def is_spark_scheduler_pod(pod: Pod) -> bool:
    return pod.scheduler_name == SPARK_SCHEDULER_NAME and SPARK_ROLE_LABEL in pod.labels


def is_spark_scheduler_executor_pod(pod: Pod) -> bool:
    return (
        pod.scheduler_name == SPARK_SCHEDULER_NAME
        and pod.labels.get(SPARK_ROLE_LABEL) == ROLE_EXECUTOR
    )
