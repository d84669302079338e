"""Node provisioner: turns demand units into registered Nodes.

The slot a cloud node-group API would fill in a real deployment: given the
units of one or more Demands, compute how many template-shaped nodes are
needed (first-fit-decreasing over empty template bins — the same shape the
external autoscaler's node-group estimator runs) and register them through
the cluster backend, labeled with the demand's instance group and a zone.

Zone policy (v1alpha2 semantics, models/demands.py):
  - `spec.zone` set (executor reschedule affinity) -> every node lands there;
  - `enforce_single_zone_scheduling` -> one zone, chosen round-robin per
    provisioning call, reported back as `fulfilled_zone`;
  - otherwise nodes spread round-robin across the configured zones.

Provisioned nodes carry PROVISIONED_BY_LABEL so the scale-down drainer can
tell elastic capacity from the static fleet.

The port's copy of spark_scheduler_tpu/autoscaler/provisioner.py.
"""

from __future__ import annotations

import itertools

from spark_scheduler_tpu_torch.models.demands import DemandUnit
from spark_scheduler_tpu_torch.models.kube import DEFAULT_ZONE, ZONE_LABEL, Node
from spark_scheduler_tpu_torch.models.resources import Resources

PROVISIONED_BY_LABEL = "spark-scheduler/provisioned-by"
PROVISIONER_NAME = "elastic-autoscaler"


def nodes_needed(units: list[DemandUnit], template: Resources) -> int | None:
    """Template-node count that fits every unit instance, by first-fit-
    decreasing (sorted by cpu, then memory) over empty template bins.
    Returns None when any single instance exceeds an empty template node —
    no amount of scale-up can fulfill that demand."""
    instances: list[Resources] = []
    for u in units:
        for _ in range(u.count):
            instances.append(u.resources)
    for r in instances:
        if (
            r.cpu_milli > template.cpu_milli
            or r.mem_kib > template.mem_kib
            or r.gpu_milli > template.gpu_milli
        ):
            return None
    instances.sort(key=lambda r: (r.cpu_milli, r.mem_kib, r.gpu_milli), reverse=True)
    bins: list[Resources] = []  # free space per new node
    for r in instances:
        for free in bins:
            if (
                r.cpu_milli <= free.cpu_milli
                and r.mem_kib <= free.mem_kib
                and r.gpu_milli <= free.gpu_milli
            ):
                free.sub(r)
                break
        else:
            free = template.copy()
            free.sub(r)
            bins.append(free)
    return len(bins)


class NodeProvisioner:
    def __init__(
        self,
        backend,
        instance_group_label: str,
        node_template: Resources,
        zones: list[str] | None = None,
        node_prefix: str = "autoscaled",
        clock=None,
    ):
        import time as _time

        self._backend = backend
        self._ig_label = instance_group_label
        self.node_template = node_template
        self._zones = list(zones) if zones else [DEFAULT_ZONE]
        self._prefix = node_prefix
        self._clock = clock or _time.time
        self._seq = itertools.count()
        self._zone_rr = itertools.count()

    def nodes_needed(self, units: list[DemandUnit]) -> int | None:
        return nodes_needed(units, self.node_template)

    def pick_zone(self) -> str:
        return self._zones[next(self._zone_rr) % len(self._zones)]

    def provision(
        self, count: int, instance_group: str, zone: str | None
    ) -> list[Node]:
        """Register `count` template nodes. A fixed `zone` pins every node;
        zone=None spreads round-robin across the configured zones."""
        created: list[Node] = []
        now = self._clock()
        for _ in range(count):
            z = zone if zone is not None else self.pick_zone()
            node = Node(
                name=f"{self._prefix}-{next(self._seq)}",
                allocatable=self.node_template.copy(),
                labels={
                    ZONE_LABEL: z,
                    self._ig_label: instance_group,
                    PROVISIONED_BY_LABEL: PROVISIONER_NAME,
                },
                creation_timestamp=now,
            )
            self._backend.add_node(node)
            created.append(node)
        return created
