"""Unschedulable-pod marker.

Rebuilds internal/extender/unschedulablepods.go:40-188: periodically scan
pending drivers older than the timeout and check whether the gang could fit
an EMPTY cluster (zero usage, only non-schedulable overhead); set the
`PodExceedsClusterCapacity` condition accordingly (both directions, so a
cluster scale-up clears it).
"""

from __future__ import annotations

import threading
import time

from spark_scheduler_tpu_torch.models.kube import Pod, PodCondition
from spark_scheduler_tpu_torch.core.binpacker import Binpacker
from spark_scheduler_tpu_torch.core.solver import PlacementSolver
from spark_scheduler_tpu_torch.core.sparkpods import (
    ROLE_DRIVER,
    SPARK_ROLE_LABEL,
    SPARK_SCHEDULER_NAME,
    SparkPodError,
    pod_matches_node,
    spark_resources,
)

POD_EXCEEDS_CLUSTER_CAPACITY_CONDITION = "PodExceedsClusterCapacity"
POLLING_INTERVAL_S = 60.0  # unschedulablePollingInterval
DEFAULT_TIMEOUT_S = 600.0  # 10 min default (unschedulablepods.go:61-63)


class UnschedulablePodMarker:
    def __init__(
        self,
        backend,
        overhead_computer,
        binpacker: Binpacker,
        solver: PlacementSolver,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        clock=time.time,
    ):
        self._backend = backend
        self._overhead = overhead_computer
        self._binpacker = binpacker
        self._solver = solver
        self._timeout_s = timeout_s if timeout_s > 0 else DEFAULT_TIMEOUT_S
        self._clock = clock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="unschedulable-marker"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(POLLING_INTERVAL_S):
            try:
                self.scan_for_unschedulable_pods()
            except Exception:  # background loop must not die
                pass

    def scan_for_unschedulable_pods(self) -> None:
        now = self._clock()
        for pod in self._backend.list_pods():
            if (
                pod.scheduler_name == SPARK_SCHEDULER_NAME
                and not pod.node_name
                and pod.deletion_timestamp is None
                and pod.labels.get(SPARK_ROLE_LABEL) == ROLE_DRIVER
                and pod.creation_timestamp + self._timeout_s < now
            ):
                try:
                    exceeds = self.does_pod_exceed_cluster_capacity(pod)
                except SparkPodError:
                    continue
                pod.set_condition(
                    PodCondition(
                        type=POD_EXCEEDS_CLUSTER_CAPACITY_CONDITION,
                        status=exceeds,
                        last_transition_time=now,
                    )
                )

    def does_pod_exceed_cluster_capacity(self, driver: Pod) -> bool:
        """Gang-fit against empty-cluster capacity (unschedulablepods.go:131-170)."""
        nodes = [
            n for n in self._backend.list_nodes() if pod_matches_node(driver, n)
        ]
        overhead = self._overhead.get_non_schedulable_overhead(nodes)
        tensors = self._solver.build_tensors(nodes, {}, overhead)
        app_resources = spark_resources(driver)
        packing = self._solver.pack(
            self._binpacker.name,
            tensors,
            app_resources.driver_resources,
            app_resources.executor_resources,
            app_resources.min_executor_count,
            [n.name for n in nodes],
        )
        return not packing.has_capacity
