"""Demand records — the autoscaler signaling surface.

Rebuilds the scaler CRD pair
(vendor/.../apis/scaler/v1alpha2/types_demand.go:23-157 and v1alpha1):
a Demand names resources an application needs but cannot get, consumed by an
external cluster autoscaler. v1alpha2 adds zone affinity + per-unit pod
attribution; v1alpha1 is the flat legacy form kept for conversion parity.

Demand name for a pod is "demand-<pod name>" (common/utils/demands.go:28-67).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from spark_scheduler_tpu_torch.models.resources import Resources

DEMAND_NAME_PREFIX = "demand-"

# Phases (types_demand.go:124-141)
PHASE_EMPTY = ""
PHASE_PENDING = "pending"
PHASE_FULFILLED = "fulfilled"
PHASE_CANNOT_FULFILL = "cannot-fulfill"


def demand_name_for_pod(pod) -> str:
    return DEMAND_NAME_PREFIX + pod.name


@dataclasses.dataclass
class DemandUnit:
    resources: Resources
    count: int
    # {namespace: [pod names]} — pods whose own requests already cover part
    # of the demand, so the autoscaler doesn't double-count
    # (types_demand.go:88-100).
    pod_names_by_namespace: dict[str, list[str]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DemandSpec:
    instance_group: str
    units: list[DemandUnit] = dataclasses.field(default_factory=list)
    is_long_lived: bool = False
    enforce_single_zone_scheduling: bool = False
    zone: Optional[str] = None


@dataclasses.dataclass
class DemandStatus:
    phase: str = PHASE_EMPTY
    fulfilled_zone: Optional[str] = None
    last_transition_time: float = 0.0


@dataclasses.dataclass
class Demand:
    name: str
    namespace: str = "default"
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    owner_pod_uid: str = ""
    resource_version: int = 0
    # Uninterpreted metadata (uid, creationTimestamp, ownerReferences, ...)
    # preserved verbatim through webhook conversion.
    metadata_extra: dict = dataclasses.field(default_factory=dict)
    spec: DemandSpec = dataclasses.field(default_factory=lambda: DemandSpec(""))
    status: DemandStatus = dataclasses.field(default_factory=DemandStatus)

    def is_fulfilled(self) -> bool:
        return self.status.phase == PHASE_FULFILLED


# -- v1alpha1 legacy form + conversion (apis/scaler/v1alpha1) ---------------


@dataclasses.dataclass
class DemandUnitV1Alpha1:
    """v1alpha1 unit carries flat cpu/memory/gpu quantities
    (apis/scaler/v1alpha1/types_demand.go:57-62)."""

    cpu_milli: int
    mem_kib: int
    count: int
    gpu_milli: int = 0


@dataclasses.dataclass
class DemandV1Alpha1:
    name: str
    namespace: str = "default"
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    resource_version: int = 0
    metadata_extra: dict = dataclasses.field(default_factory=dict)
    instance_group: str = ""
    units: list[DemandUnitV1Alpha1] = dataclasses.field(default_factory=list)
    is_long_lived: bool = False
    phase: str = PHASE_EMPTY
    last_transition_time: float = 0.0


def convert_demand_to_v1alpha1(d: Demand) -> DemandV1Alpha1:
    """Storage -> legacy (conversion_demand.go ConvertFrom): phase,
    last-transition-time and per-unit cpu/memory/gpu carry over; zone
    semantics and pod attribution have no v1alpha1 shape and drop."""
    return DemandV1Alpha1(
        name=d.name,
        namespace=d.namespace,
        labels=dict(d.labels),
        resource_version=d.resource_version,
        metadata_extra=dict(d.metadata_extra),
        instance_group=d.spec.instance_group,
        units=[
            DemandUnitV1Alpha1(
                u.resources.cpu_milli, u.resources.mem_kib, u.count,
                gpu_milli=u.resources.gpu_milli,
            )
            for u in d.spec.units
        ],
        is_long_lived=d.spec.is_long_lived,
        phase=d.status.phase,
        last_transition_time=d.status.last_transition_time,
    )


def convert_demand_from_v1alpha1(old: DemandV1Alpha1) -> Demand:
    """Legacy -> storage (conversion_demand.go ConvertTo)."""
    return Demand(
        name=old.name,
        namespace=old.namespace,
        labels=dict(old.labels),
        resource_version=old.resource_version,
        metadata_extra=dict(old.metadata_extra),
        spec=DemandSpec(
            instance_group=old.instance_group,
            units=[
                DemandUnit(Resources(u.cpu_milli, u.mem_kib, u.gpu_milli), u.count)
                for u in old.units
            ],
            is_long_lived=old.is_long_lived,
        ),
        status=DemandStatus(
            phase=old.phase, last_transition_time=old.last_transition_time
        ),
    )
