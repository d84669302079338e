"""In-memory component-test harness.

Rebuilds internal/extender/extendertest/extender_test_utils.go:51-397: a
COMPLETE real scheduler (real caches, reservation manager, packing kernels,
FIFO) wired to the in-memory backend with synchronous write-back, plus
fixture factories matching the reference's (8 CPU / 8 GiB / 1 GPU nodes,
fully-annotated driver+executor pod sets). `schedule` invokes the real
predicate and then simulates kube-scheduler binding; `terminate_pod`
simulates executor death via terminated container statuses.

The port's copy of spark_scheduler_tpu/testing/harness.py. `Harness` takes
`device=` and passes it to the app (the card by default; tests pass
"cpu").
"""

from __future__ import annotations

import itertools

from spark_scheduler_tpu_torch.core.extender import ExtenderArgs, ExtenderFilterResult
from spark_scheduler_tpu_torch.core.sparkpods import (
    DA_MAX_EXECUTOR_COUNT,
    DA_MIN_EXECUTOR_COUNT,
    DRIVER_CPU,
    DRIVER_MEMORY,
    DYNAMIC_ALLOCATION_ENABLED,
    EXECUTOR_COUNT,
    EXECUTOR_CPU,
    EXECUTOR_MEMORY,
    ROLE_DRIVER,
    ROLE_EXECUTOR,
    SPARK_APP_ID_LABEL,
    SPARK_ROLE_LABEL,
    SPARK_SCHEDULER_NAME,
)
from spark_scheduler_tpu_torch.models.kube import Container, Node, Pod, ZONE_LABEL
from spark_scheduler_tpu_torch.models.resources import Resources
from spark_scheduler_tpu_torch.server.app import SchedulerApp, build_scheduler_app
from spark_scheduler_tpu_torch.server.config import InstallConfig
from spark_scheduler_tpu_torch.store.backend import DEMAND_CRD, InMemoryBackend

INSTANCE_GROUP_LABEL = "resource_channel"
DEFAULT_INSTANCE_GROUP = "batch-medium-priority"

_ts = itertools.count(1)


def new_node(name: str, zone: str = "zone1", instance_group: str = DEFAULT_INSTANCE_GROUP) -> Node:
    """8 CPU / 8 GiB / 1 GPU node (extender_test_utils.go:225-257)."""
    return Node(
        name=name,
        allocatable=Resources.from_quantities("8", "8Gi", "1", round_up=False),
        labels={
            ZONE_LABEL: zone,
            INSTANCE_GROUP_LABEL: instance_group,
        },
    )


def _spark_pods(
    app_id: str,
    num_executors: int,
    annotations: dict[str, str],
    instance_group: str = DEFAULT_INSTANCE_GROUP,
) -> list[Pod]:
    ts = float(next(_ts))
    driver = Pod(
        name=f"{app_id}-driver",
        namespace="namespace",
        labels={SPARK_ROLE_LABEL: ROLE_DRIVER, SPARK_APP_ID_LABEL: app_id},
        annotations=dict(annotations),
        creation_timestamp=ts,
        scheduler_name=SPARK_SCHEDULER_NAME,
        node_selector={INSTANCE_GROUP_LABEL: instance_group},
        containers=[Container(requests=Resources.from_quantities("1", "1Gi"))],
    )
    pods = [driver]
    for i in range(num_executors):
        pods.append(
            Pod(
                name=f"{app_id}-exec-{i + 1}",
                namespace="namespace",
                labels={SPARK_ROLE_LABEL: ROLE_EXECUTOR, SPARK_APP_ID_LABEL: app_id},
                creation_timestamp=ts,
                scheduler_name=SPARK_SCHEDULER_NAME,
                node_selector={INSTANCE_GROUP_LABEL: instance_group},
                containers=[Container(requests=Resources.from_quantities("1", "1Gi"))],
            )
        )
    return pods


def static_allocation_spark_pods(
    app_id: str,
    num_executors: int,
    instance_group: str = DEFAULT_INSTANCE_GROUP,
) -> list[Pod]:
    """Driver + executors, 1 CPU / 1 GiB each (extender_test_utils.go:261-277).
    `instance_group` pins the pods' node selector to that group's nodes —
    the multi-group topology the multi-device serving tests drive."""
    return _spark_pods(
        app_id,
        num_executors,
        {
            DRIVER_CPU: "1",
            DRIVER_MEMORY: "1Gi",
            EXECUTOR_CPU: "1",
            EXECUTOR_MEMORY: "1Gi",
            EXECUTOR_COUNT: str(num_executors),
        },
        instance_group=instance_group,
    )


def dynamic_allocation_spark_pods(
    app_id: str, min_executors: int, max_executors: int
) -> list[Pod]:
    """(extender_test_utils.go:280-302): pod list sized max, annotations
    min/max with dynamic allocation on."""
    return _spark_pods(
        app_id,
        max_executors,
        {
            DRIVER_CPU: "1",
            DRIVER_MEMORY: "1Gi",
            EXECUTOR_CPU: "1",
            EXECUTOR_MEMORY: "1Gi",
            DYNAMIC_ALLOCATION_ENABLED: "true",
            DA_MIN_EXECUTOR_COUNT: str(min_executors),
            DA_MAX_EXECUTOR_COUNT: str(max_executors),
        },
    )


class Harness:
    def __init__(
        self,
        binpack_algo: str = "single-az-tightly-pack",
        fifo: bool = True,
        same_az_dynamic_allocation: bool = False,
        metrics=None,
        events=None,
        waste=None,
        backend=None,
        clock=None,
        device="cuda",
        **config_kw,
    ):
        # An injected backend is used as-is; default is a fresh in-memory
        # cluster.
        self.backend = backend if backend is not None else InMemoryBackend()
        self.backend.register_crd(DEMAND_CRD)
        config_kw.setdefault("sync_writes", True)
        self.app: SchedulerApp = build_scheduler_app(
            self.backend,
            InstallConfig(
                fifo=fifo,
                binpack_algo=binpack_algo,
                instance_group_label=INSTANCE_GROUP_LABEL,
                should_schedule_dynamically_allocated_executors_in_same_az=(
                    same_az_dynamic_allocation
                ),
                **config_kw,
            ),
            metrics=metrics,
            events=events,
            waste=waste,
            clock=clock,
            device=device,
        )
        self.extender = self.app.extender
        # suppress time-gap reconciliation in deterministic tests
        self.extender._last_request = float("inf")
        # ... and record that suppression in the trace (when one is being
        # captured), so a replay suppresses it too.
        if self.app.trace_writer is not None:
            self.app.trace_writer.emit_meta(resync_suppressed=True)

    # -- cluster fixtures ---------------------------------------------------

    def add_nodes(self, *nodes: Node) -> None:
        for n in nodes:
            self.backend.add_node(n)

    def add_pods(self, *pods: Pod) -> None:
        for p in pods:
            if self.backend.get("pods", p.namespace, p.name) is None:
                self.backend.add_pod(p)

    # -- scheduling ---------------------------------------------------------

    def schedule(self, pod: Pod, node_names: list[str]) -> ExtenderFilterResult:
        """Run the real predicate; on success simulate kube-scheduler binding
        + kubelet running (extender_test_utils.go:176-190)."""
        self.add_pods(pod)
        result = self.extender.predicate(ExtenderArgs(pod=pod, node_names=node_names))
        if result.ok:
            self.backend.bind_pod(pod, result.node_names[0])
        return result

    def schedule_app(self, pods: list[Pod], node_names: list[str]) -> list[ExtenderFilterResult]:
        return [self.schedule(p, node_names) for p in pods]

    def terminate_pod(self, pod: Pod) -> None:
        """Executor death via terminated containers (extender_test_utils.go:193-206)."""
        cur = self.backend.get("pods", pod.namespace, pod.name)
        for c in cur.containers:
            c.terminated = True
        self.backend.update_pod(cur)

    def delete_pod(self, pod: Pod) -> None:
        self.backend.delete_pod(pod)

    # -- inspection ---------------------------------------------------------

    def get_reservation(self, namespace: str, app_id: str):
        return self.app.rr_cache.get(namespace, app_id)

    def soft_reservations(self):
        return self.app.soft_store.get_all_copy()

    def demands(self):
        return self.app.demand_cache.list()

    @property
    def autoscaler(self):
        """The ElasticAutoscaler when built with autoscaler_enabled=True."""
        return self.app.autoscaler


def overcommit_violations(app, backend) -> list[tuple[str, str]]:
    """[(node_name, dimension)] wherever hard+soft reservations + overhead
    exceed allocatable — THE over-commit invariant, shared by bench.py's
    10k serving bench and tests/test_invariant_soak.py so the definition
    cannot drift. A reservation on a node the backend no longer knows is
    reported as ("<name>", "missing-node")."""
    from spark_scheduler_tpu_torch.models.resources import Resources

    all_nodes = backend.list_nodes()
    known = {n.name for n in all_nodes}
    overhead = app.overhead_computer.get_overhead(all_nodes)
    assert isinstance(overhead, dict), type(overhead)  # the one provider
    reserved = app.reservation_manager.get_reserved_resources()
    out: list[tuple[str, str]] = []
    for node in all_nodes:
        res = reserved.get(node.name)
        if res is None:
            continue
        ov = overhead.get(node.name, Resources.zero()).as_array()
        alloc = node.allocatable
        if res.cpu_milli + int(ov[0]) > alloc.cpu_milli:
            out.append((node.name, "cpu"))
        if res.mem_kib + int(ov[1]) > alloc.mem_kib:
            out.append((node.name, "memory"))
        if res.gpu_milli + int(ov[2]) > alloc.gpu_milli:
            out.append((node.name, "gpu"))
    for name in reserved:
        if name not in known:
            out.append((name, "missing-node"))
    return out
