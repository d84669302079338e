"""ResourceReservation records — the durable placement state.

Rebuilds the CRD pair of the reference
(vendor/.../apis/sparkscheduler/v1beta2/types_resource_reservation.go:40-102
and v1beta1/types_resource_reservation.go:22-68 plus the conversion in
v1beta1/conversion_resource_reservation.go:29-121):

  v1beta2 (storage): Spec.Reservations: {name -> {node, resources{cpu,mem,
      gpu}}}, Status.Pods: {name -> bound pod name}.
  v1beta1 (served legacy): flat {node, cpu, memory} per reservation; the
      lossless round-trip (GPU etc.) travels in the `reservation-spec`
      annotation as JSON.

Reservation names are "driver", "executor-1".."executor-N"
(resourcereservations.go:436-466).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from spark_scheduler_tpu_torch.models.resources import (
    Resources,
    resources_from_quantity_map,
    resources_to_quantity_map,
)

APP_ID_LABEL = "spark-app-id"
# v1beta1 round-trip carrier; fully-qualified key so reference-written objects
# (sparkscheduler common.go:23-32 GroupName + "/reservation-spec") upgrade
# losslessly through this webhook too.
RESERVATION_SPEC_ANNOTATION = "sparkscheduler.palantir.com/reservation-spec"
DRIVER_RESERVATION = "driver"
# Priority class of the gang (policy subsystem). Set on the driver pod by the
# submitter; stamped onto the ResourceReservation at creation so the running
# gang's tier survives driver-pod deletion and is visible to the preemption
# search. Absent on both when the policy engine is off — objects stay
# byte-identical to the pre-policy wire form.
PRIORITY_CLASS_ANNOTATION = "spark-priority-class"


def executor_reservation_name(i: int) -> str:
    """0-based index -> "executor-1"... (resourcereservations.go:469-471)."""
    return f"executor-{i + 1}"


@dataclasses.dataclass
class Reservation:
    node: str
    resources: Resources

    def copy(self) -> "Reservation":
        return Reservation(self.node, self.resources.copy())


@dataclasses.dataclass
class ReservationSpec:
    reservations: dict[str, Reservation] = dataclasses.field(default_factory=dict)

    def copy(self) -> "ReservationSpec":
        return ReservationSpec({k: v.copy() for k, v in self.reservations.items()})


@dataclasses.dataclass
class ReservationStatus:
    pods: dict[str, str] = dataclasses.field(default_factory=dict)

    def copy(self) -> "ReservationStatus":
        return ReservationStatus(dict(self.pods))


@dataclasses.dataclass
class ResourceReservation:
    """v1beta2 storage form. Named after the app ID, owned by the driver pod."""

    name: str
    namespace: str = "default"
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)
    owner_pod_uid: str = ""
    resource_version: int = 0
    # Verbatim passthrough of metadata fields this model doesn't interpret
    # (uid, creationTimestamp, generation, ownerReferences, finalizers, ...).
    # The apiserver requires conversion to preserve immutable metadata, so
    # the webhook must round-trip these (conversion_resource_reservation.go:
    # ConvertTo/ConvertFrom DeepCopy the whole ObjectMeta).
    metadata_extra: dict = dataclasses.field(default_factory=dict)
    spec: ReservationSpec = dataclasses.field(default_factory=ReservationSpec)
    status: ReservationStatus = dataclasses.field(default_factory=ReservationStatus)

    def copy(self) -> "ResourceReservation":
        return ResourceReservation(
            name=self.name,
            namespace=self.namespace,
            labels=dict(self.labels),
            annotations=dict(self.annotations),
            owner_pod_uid=self.owner_pod_uid,
            resource_version=self.resource_version,
            metadata_extra=dict(self.metadata_extra),
            spec=self.spec.copy(),
            status=self.status.copy(),
        )


def new_resource_reservation(
    driver_node: str,
    executor_nodes: list[str],
    driver_pod,
    driver_resources: Resources,
    executor_resources: Resources,
) -> ResourceReservation:
    """Build the gang's reservation object (resourcereservations.go:436-466):
    driver slot bound to the driver pod, one slot per min-executor."""
    reservations = {
        DRIVER_RESERVATION: Reservation(driver_node, driver_resources.copy())
    }
    for idx, node in enumerate(executor_nodes):
        reservations[executor_reservation_name(idx)] = Reservation(
            node, executor_resources.copy()
        )
    app_id = driver_pod.labels.get(APP_ID_LABEL, driver_pod.name)
    annotations: dict[str, str] = {}
    priority_class = (driver_pod.annotations or {}).get(PRIORITY_CLASS_ANNOTATION)
    if priority_class is not None:
        annotations[PRIORITY_CLASS_ANNOTATION] = priority_class
    return ResourceReservation(
        name=app_id,
        namespace=driver_pod.namespace,
        labels={APP_ID_LABEL: app_id},
        annotations=annotations,
        owner_pod_uid=driver_pod.uid,
        spec=ReservationSpec(reservations),
        status=ReservationStatus(pods={DRIVER_RESERVATION: driver_pod.name}),
    )


# ---------------------------------------------------------------------------
# v1beta1 legacy form + conversion (served for pre-upgrade clients; the
# conversion webhook serves both directions, SURVEY.md L9).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReservationV1Beta1:
    node: str
    cpu_milli: int
    mem_kib: int


@dataclasses.dataclass
class ResourceReservationV1Beta1:
    name: str
    namespace: str = "default"
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)
    resource_version: int = 0
    metadata_extra: dict = dataclasses.field(default_factory=dict)
    reservations: dict[str, ReservationV1Beta1] = dataclasses.field(default_factory=dict)
    pods: dict[str, str] = dataclasses.field(default_factory=dict)


def convert_to_v1beta1(rr: ResourceReservation) -> ResourceReservationV1Beta1:
    """Downgrade, stashing the marshaled v1beta2 spec (incl. GPU) in the
    reservation-spec annotation for lossless round-trip. The stash is the
    reference's exact format — the JSON-marshaled v1beta2
    ResourceReservationSpec with quantity strings — so objects written by
    this webhook upgrade cleanly through the reference's and vice versa
    (conversion_resource_reservation.go ConvertFrom: json.Marshal(src.Spec))."""
    spec_json = json.dumps(
        {
            "reservations": {
                name: {
                    "node": r.node,
                    "resources": resources_to_quantity_map(r.resources),
                }
                for name, r in rr.spec.reservations.items()
            }
        },
        sort_keys=True,
    )
    annotations = dict(rr.annotations)
    annotations[RESERVATION_SPEC_ANNOTATION] = spec_json
    return ResourceReservationV1Beta1(
        name=rr.name,
        namespace=rr.namespace,
        labels=dict(rr.labels),
        annotations=annotations,
        resource_version=rr.resource_version,
        metadata_extra=dict(rr.metadata_extra),
        reservations={
            name: ReservationV1Beta1(r.node, r.resources.cpu_milli, r.resources.mem_kib)
            for name, r in rr.spec.reservations.items()
        },
        pods=dict(rr.status.pods),
    )


def convert_from_v1beta1(old: ResourceReservationV1Beta1) -> ResourceReservation:
    """Upgrade with the reference's merge semantics
    (conversion_resource_reservation.go ConvertTo): node/cpu/memory come from
    the v1beta1 struct fields; the stashed annotation only contributes
    resources the flat shape cannot carry (GPU). The stash annotation is
    removed from the upgraded object."""
    annotations = dict(old.annotations)
    raw = annotations.pop(RESERVATION_SPEC_ANNOTATION, None)
    if raw is None:
        # Round-1 builds of this codebase stashed under a bare key.
        raw = annotations.pop("reservation-spec", None)
    stashed: Optional[dict] = None
    if raw is not None:
        try:
            parsed = json.loads(raw)
            if isinstance(parsed, dict):
                # Reference format: {"reservations": {name: {node, resources}}};
                # round-1 legacy format was flat {name: {node, cpu_milli, ...}}.
                stashed = parsed.get("reservations", parsed)
        except json.JSONDecodeError:
            stashed = None
    reservations: dict[str, Reservation] = {}
    for name, r in old.reservations.items():
        gpu_milli = 0
        if stashed is not None and name in stashed:
            entry = stashed[name] or {}
            if "resources" in entry:
                gpu_milli = resources_from_quantity_map(entry["resources"]).gpu_milli
            else:
                gpu_milli = int(entry.get("gpu_milli", 0))
        reservations[name] = Reservation(
            r.node, Resources(r.cpu_milli, r.mem_kib, gpu_milli)
        )
    return ResourceReservation(
        name=old.name,
        namespace=old.namespace,
        labels=dict(old.labels),
        annotations=annotations,
        resource_version=old.resource_version,
        metadata_extra=dict(old.metadata_extra),
        spec=ReservationSpec(reservations),
        status=ReservationStatus(dict(old.pods)),
    )
