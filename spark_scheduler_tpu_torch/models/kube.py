"""Minimal cluster object model (Node / Pod) — the framework's view of k8s.

The reference consumes `corev1.Node` / `corev1.Pod` through informer caches;
this framework is backend-agnostic: any system that can produce these two
records (a real apiserver watch, a test harness, a synthetic generator) can
drive the scheduler. Only the fields the reference actually reads are modeled:

  Node:  name, labels, allocatable, unschedulable, ready, creationTimestamp
         (resources.go:61-100, sort/nodesorting.go:41-64)
  Pod:   metadata (name/namespace/labels/annotations/creationTimestamp/uid),
         spec (nodeName, schedulerName, nodeSelector, node affinity,
         container + initContainer resource requests), status (phase,
         conditions, container termination) — the subset read by
         internal/extender/sparkpods.go, overhead.go and common/utils/pods.go.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from spark_scheduler_tpu_torch.models.resources import Resources

# corev1.LabelZoneFailureDomain, used for AZ awareness (resources.go:96-99).
ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"
DEFAULT_ZONE = "default"  # zoneLabelPlaceholder, resources.go:27-29

_uid_counter = itertools.count(1)


@dataclasses.dataclass
class Node:
    name: str
    allocatable: Resources = dataclasses.field(default_factory=Resources.zero)
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    unschedulable: bool = False
    ready: bool = True
    creation_timestamp: float = 0.0

    @property
    def zone(self) -> str:
        return self.labels.get(ZONE_LABEL, DEFAULT_ZONE)


@dataclasses.dataclass
class PodCondition:
    type: str
    status: bool
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclasses.dataclass
class Container:
    """A container's resource *requests* (the only part scheduling reads)."""

    name: str = ""
    requests: Resources = dataclasses.field(default_factory=Resources.zero)
    terminated: bool = False  # status: all-containers-terminated => pod dead


@dataclasses.dataclass
class Pod:
    name: str
    namespace: str = "default"
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)
    creation_timestamp: float = 0.0
    uid: str = ""
    deletion_timestamp: Optional[float] = None

    # spec
    scheduler_name: str = ""
    node_name: str = ""  # empty until bound
    node_selector: dict[str, str] = dataclasses.field(default_factory=dict)
    # Required node affinity expressed as {label: [allowed values]}; the
    # reference reads requiredDuringSchedulingIgnoredDuringExecution match
    # expressions only to extract the instance group (internal/podspec.go:29-53).
    node_affinity: dict[str, list[str]] = dataclasses.field(default_factory=dict)
    containers: list[Container] = dataclasses.field(default_factory=list)
    init_containers: list[Container] = dataclasses.field(default_factory=list)

    # status
    phase: str = "Pending"
    conditions: list[PodCondition] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.uid:
            self.uid = f"uid-{next(_uid_counter)}"

    @property
    def key(self) -> tuple[str, str]:
        return (self.namespace, self.name)

    def is_terminated(self) -> bool:
        """All containers terminated (common/utils/pods.go IsPodTerminated)."""
        return bool(self.containers) and all(c.terminated for c in self.containers)

    def is_scheduled(self) -> bool:
        return bool(self.node_name)

    def request(self) -> Resources:
        """max(sum of containers, max of init containers) per dim — the
        effective pod request (internal/extender/overhead.go:195-208)."""
        total = Resources.zero()
        for c in self.containers:
            total.add(c.requests)
        for c in self.init_containers:
            total.set_max(c.requests)
        return total

    def get_condition(self, cond_type: str) -> Optional[PodCondition]:
        for c in self.conditions:
            if c.type == cond_type:
                return c
        return None

    def set_condition(self, cond: PodCondition) -> bool:
        """Upsert a condition; returns True if it changed (mirrors k8s
        podutil behavior used by unschedulablepods.go / demand.go)."""
        existing = self.get_condition(cond.type)
        if existing is None:
            self.conditions.append(cond)
            return True
        if (existing.status, existing.reason, existing.message) != (
            cond.status,
            cond.reason,
            cond.message,
        ):
            existing.status = cond.status
            existing.reason = cond.reason
            existing.message = cond.message
            existing.last_transition_time = cond.last_transition_time
            return True
        return False
