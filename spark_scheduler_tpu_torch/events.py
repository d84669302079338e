"""Business events (internal/events/events.go:27-83).

Structured JSON-line events with the reference's event names, so downstream
event pipelines keyed on `foundry.spark.scheduler.*` carry over. The sink is
pluggable: any callable taking the event dict (default: a JSON line to the
given stream). Tests pass a list-appending sink.
"""

from __future__ import annotations

import json
import sys
import time

APPLICATION_SCHEDULED = "foundry.spark.scheduler.application_scheduled"
DEMAND_CREATED = "foundry.spark.scheduler.demand_created"
DEMAND_DELETED = "foundry.spark.scheduler.demand_deleted"


class EventEmitter:
    def __init__(self, sink=None, instance_group_label: str = "instance-group", clock=time.time):
        if sink is None:
            # Resolve sys.stderr at EMIT time, not construction: capturing
            # the stream object here silently ignores any later stderr
            # redirection (capsys, contextlib.redirect_stderr, a daemon
            # re-pointing fd 2) for an emitter built before it.
            def sink(event):
                sys.stderr.write(json.dumps(event) + "\n")

        self._sink = sink
        self._label = instance_group_label
        self._clock = clock

    def _emit(self, name: str, values: dict) -> None:
        self._sink({"event": name, "time": self._clock(), **values})

    def emit_application_scheduled(self, pod, app_resources) -> None:
        """events.go:35-58: emitted once the driver and all min executors
        have reservations."""
        from spark_scheduler_tpu_torch.core.sparkpods import (
            SPARK_APP_ID_LABEL,
            find_instance_group,
        )

        d = app_resources.driver_resources
        e = app_resources.executor_resources
        self._emit(
            APPLICATION_SCHEDULED,
            {
                "instanceGroup": find_instance_group(pod, self._label) or "",
                "sparkAppID": pod.labels.get(SPARK_APP_ID_LABEL, ""),
                "driverCpuMilli": d.cpu_milli,
                "driverMemoryKib": d.mem_kib,
                "driverNvidiaGpuMilli": d.gpu_milli,
                "executorCpuMilli": e.cpu_milli,
                "executorMemoryKib": e.mem_kib,
                "executorNvidiaGpuMilli": e.gpu_milli,
                "minExecutorCount": app_resources.min_executor_count,
                "maxExecutorCount": app_resources.max_executor_count,
            },
        )

    def emit_demand_created(self, demand) -> None:
        self._emit(
            DEMAND_CREATED,
            {
                "instanceGroup": demand.spec.instance_group,
                "demandNamespace": demand.namespace,
                "demandName": demand.name,
            },
        )

    def emit_demand_deleted(self, demand, source: str) -> None:
        self._emit(
            DEMAND_DELETED,
            {
                "instanceGroup": demand.spec.instance_group,
                "demandNamespace": demand.namespace,
                "demandName": demand.name,
                "source": source,
            },
        )
