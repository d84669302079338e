"""CRD version-conversion webhook (SURVEY.md L9).

Rebuilds the reference's conversion webhook
(internal/conversionwebhook/resource_reservation.go:44-98 and the standalone
service spark-scheduler-conversion-webhook/): a `POST /convert` route that
receives a Kubernetes `ConversionReview` and converts CRD objects between
served versions:

  ResourceReservation  sparkscheduler.palantir.com  v1beta1 <-> v1beta2
  Demand               scaler.palantir.com          v1alpha1 <-> v1alpha2

Wire-object codecs live here (the apiserver speaks JSON-shaped CRD objects);
the pure model-to-model conversion rules live in
`models.reservations` / `models.demands` (the k8s-free layer, mirroring
v1beta1/conversion_resource_reservation.go:29-121 and apis/scaler/v1alpha1).
Unknown fields are preserved verbatim where the round-trip annotation
carries them; unknown groups/versions fail the review with a `Failed`
result, matching controller-runtime's conversion handler behavior.
"""

from __future__ import annotations

from typing import Any, Callable

from spark_scheduler_tpu_torch.models.demands import (
    Demand,
    DemandSpec,
    DemandStatus,
    DemandUnit,
    DemandUnitV1Alpha1,
    DemandV1Alpha1,
    convert_demand_from_v1alpha1,
    convert_demand_to_v1alpha1,
)
from spark_scheduler_tpu_torch.models.reservations import (
    PRIORITY_CLASS_ANNOTATION,
    Reservation,
    ReservationSpec,
    ReservationStatus,
    ReservationV1Beta1,
    ResourceReservation,
    ResourceReservationV1Beta1,
    convert_from_v1beta1,
    convert_to_v1beta1,
)
from spark_scheduler_tpu_torch.models.resources import (
    format_quantity_kib,
    format_quantity_milli,
    resources_from_quantity_map,
    resources_to_quantity_map,
)

SPARK_SCHEDULER_GROUP = "sparkscheduler.palantir.com"
SCALER_GROUP = "scaler.palantir.com"

RR_V1BETA1 = f"{SPARK_SCHEDULER_GROUP}/v1beta1"
RR_V1BETA2 = f"{SPARK_SCHEDULER_GROUP}/v1beta2"
DEMAND_V1ALPHA1 = f"{SCALER_GROUP}/v1alpha1"
DEMAND_V1ALPHA2 = f"{SCALER_GROUP}/v1alpha2"


# metadata keys the models interpret; everything else rides metadata_extra.
# resourceVersion is deliberately NOT here: it is an opaque string per the
# k8s API contract, so it rides metadata_extra verbatim (the model's int
# resource_version is a best-effort parse for internal versioning only).
_KNOWN_META = ("name", "namespace", "labels", "annotations")


def _metadata_to_wire(obj) -> dict:
    """Re-emit metadata losslessly: uninterpreted fields (uid,
    creationTimestamp, generation, ownerReferences, finalizers, ...) first,
    overlaid with the model-owned fields. The apiserver rejects conversion
    responses that mutate immutable metadata, so this must round-trip
    everything (reference DeepCopies ObjectMeta through conversion)."""
    meta: dict[str, Any] = dict(getattr(obj, "metadata_extra", None) or {})
    meta["name"] = obj.name
    meta["namespace"] = obj.namespace
    if obj.labels:
        meta["labels"] = dict(obj.labels)
    annotations = getattr(obj, "annotations", None)
    if annotations:
        meta["annotations"] = dict(annotations)
    # metadata_extra carries the wire resourceVersion verbatim; only objects
    # built internally (no extra) emit the parsed int form.
    if obj.resource_version and "resourceVersion" not in meta:
        meta["resourceVersion"] = str(obj.resource_version)
    return meta


def _metadata_fields(raw: dict, *, with_annotations: bool = True) -> dict:
    meta = raw.get("metadata") or {}
    rv = str(meta.get("resourceVersion") or "0")
    out = {
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", "default"),
        "labels": dict(meta.get("labels") or {}),
        # Opaque string per API contract; parse best-effort for the models'
        # internal optimistic-concurrency checks, never re-emitted when the
        # original is carried in metadata_extra.
        "resource_version": int(rv) if rv.isdigit() else 0,
        "metadata_extra": {k: v for k, v in meta.items() if k not in _KNOWN_META},
    }
    if with_annotations:
        out["annotations"] = dict(meta.get("annotations") or {})
    elif meta.get("annotations"):
        # The Demand models carry no annotations field; ride them through
        # metadata_extra so conversion doesn't erase operator-set annotations.
        out["metadata_extra"]["annotations"] = dict(meta["annotations"])
    return out


# ------------------------------------------------- ResourceReservation wire


def rr_v1beta2_to_wire(rr: ResourceReservation) -> dict:
    """types_resource_reservation.go:40-102 (v1beta2 storage shape).

    A gang's priority class (policy subsystem) is a first-class optional
    spec field in v1beta2, emitted only when present so pre-policy objects
    stay byte-identical; in v1beta1 it simply stays in annotations."""
    spec: dict = {
        "reservations": {
            name: {"node": r.node, "resources": resources_to_quantity_map(r.resources)}
            for name, r in rr.spec.reservations.items()
        }
    }
    priority_class = rr.annotations.get(PRIORITY_CLASS_ANNOTATION)
    if priority_class is not None:
        spec["priorityClass"] = priority_class
    wire = {
        "apiVersion": RR_V1BETA2,
        "kind": "ResourceReservation",
        "metadata": _metadata_to_wire(rr),
        "spec": spec,
        "status": {"pods": dict(rr.status.pods)},
    }
    if priority_class is not None:
        # The annotation is the in-model carrier; the wire carries the spec
        # field only (no duplicate), matching how reservation-spec stashes
        # are stripped on upgrade.
        wire["metadata"].get("annotations", {}).pop(PRIORITY_CLASS_ANNOTATION, None)
        if not wire["metadata"].get("annotations"):
            wire["metadata"].pop("annotations", None)
    return wire


def rr_v1beta2_from_wire(raw: dict) -> ResourceReservation:
    spec_raw = raw.get("spec") or {}
    reservations = {
        name: Reservation(
            node=r.get("node", ""),
            resources=resources_from_quantity_map(r.get("resources")),
        )
        for name, r in (spec_raw.get("reservations") or {}).items()
    }
    rr = ResourceReservation(
        spec=ReservationSpec(reservations),
        status=ReservationStatus(dict((raw.get("status") or {}).get("pods") or {})),
        **_metadata_fields(raw),
    )
    priority_class = spec_raw.get("priorityClass")
    if priority_class is not None:
        rr.annotations.setdefault(PRIORITY_CLASS_ANNOTATION, str(priority_class))
    return rr


def rr_v1beta1_to_wire(rr1: ResourceReservationV1Beta1) -> dict:
    """v1beta1 flat shape (types_resource_reservation.go:22-68): per-slot
    {node, cpu, memory}; GPU travels in the reservation-spec annotation."""
    return {
        "apiVersion": RR_V1BETA1,
        "kind": "ResourceReservation",
        "metadata": _metadata_to_wire(rr1),
        "spec": {
            "reservations": {
                name: {
                    "node": r.node,
                    "cpu": format_quantity_milli(r.cpu_milli),
                    "memory": format_quantity_kib(r.mem_kib),
                }
                for name, r in rr1.reservations.items()
            }
        },
        "status": {"pods": dict(rr1.pods)},
    }


def rr_v1beta1_from_wire(raw: dict) -> ResourceReservationV1Beta1:
    reservations = {}
    for name, r in ((raw.get("spec") or {}).get("reservations") or {}).items():
        res = resources_from_quantity_map({"cpu": r.get("cpu", "0"), "memory": r.get("memory", "0")})
        reservations[name] = ReservationV1Beta1(
            node=r.get("node", ""), cpu_milli=res.cpu_milli, mem_kib=res.mem_kib
        )
    return ResourceReservationV1Beta1(
        reservations=reservations,
        pods=dict((raw.get("status") or {}).get("pods") or {}),
        **_metadata_fields(raw),
    )


def _parse_transition_time(val) -> float:
    """Accept RFC3339 strings (k8s metav1.Time) or epoch numbers."""
    if val is None:
        return 0.0
    if isinstance(val, (int, float)):
        return float(val)
    import datetime

    try:
        return datetime.datetime.fromisoformat(
            str(val).replace("Z", "+00:00")
        ).timestamp()
    except ValueError:
        return 0.0


def _format_transition_time(epoch: float) -> str:
    """Epoch seconds -> RFC3339 UTC, the metav1.Time wire encoding
    ("2006-01-02T15:04:05Z")."""
    import datetime

    return (
        datetime.datetime.fromtimestamp(epoch, tz=datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%SZ")
    )


# --------------------------------------------------------------- Demand wire
#
# Key names are the reference CRD JSON tags EXACTLY — kebab-case
# (apis/scaler/v1alpha2/types_demand.go:82-122, v1alpha1/types_demand.go:36-62).
# Readers also accept this codebase's earlier camelCase spellings for
# backward compatibility with already-persisted objects.


def _get(raw: dict, kebab: str, camel: str, default=None):
    if kebab in raw:
        return raw[kebab]
    return raw.get(camel, default)


def demand_v1alpha2_to_wire(d: Demand) -> dict:
    """types_demand.go:71-123 (v1alpha2, status subresource). Fields without
    omitempty (instance-group, is-long-lived, enforce-single-zone-scheduling,
    phase) are always emitted, matching Go json marshaling."""
    spec: dict[str, Any] = {
        "units": [
            {
                "resources": resources_to_quantity_map(u.resources),
                "count": u.count,
                **(
                    {
                        "pod-names-by-namespace": {
                            ns: list(names)
                            for ns, names in u.pod_names_by_namespace.items()
                        }
                    }
                    if u.pod_names_by_namespace
                    else {}
                ),
            }
            for u in d.spec.units
        ],
        "instance-group": d.spec.instance_group,
        "is-long-lived": d.spec.is_long_lived,
        "enforce-single-zone-scheduling": d.spec.enforce_single_zone_scheduling,
    }
    if d.spec.zone:
        spec["zone"] = d.spec.zone
    status: dict[str, Any] = {"phase": d.status.phase}
    if d.status.last_transition_time:
        status["last-transition-time"] = _format_transition_time(
            d.status.last_transition_time
        )
    if d.status.fulfilled_zone:
        status["fulfilled-zone"] = d.status.fulfilled_zone
    return {
        "apiVersion": DEMAND_V1ALPHA2,
        "kind": "Demand",
        "metadata": _metadata_to_wire(d),
        "spec": spec,
        "status": status,
    }


def demand_v1alpha2_from_wire(raw: dict) -> Demand:
    spec_raw = raw.get("spec") or {}
    units = [
        DemandUnit(
            resources=resources_from_quantity_map(u.get("resources")),
            count=int(u.get("count", 0)),
            pod_names_by_namespace={
                ns: list(names)
                for ns, names in (
                    _get(u, "pod-names-by-namespace", "podNamesByNamespace") or {}
                ).items()
            },
        )
        for u in spec_raw.get("units") or []
    ]
    status_raw = raw.get("status") or {}
    return Demand(
        spec=DemandSpec(
            units=units,
            instance_group=_get(spec_raw, "instance-group", "instanceGroup", ""),
            is_long_lived=bool(_get(spec_raw, "is-long-lived", "isLongLived", False)),
            enforce_single_zone_scheduling=bool(
                _get(
                    spec_raw,
                    "enforce-single-zone-scheduling",
                    "enforceSingleZoneScheduling",
                    False,
                )
            ),
            zone=spec_raw.get("zone") or None,
        ),
        status=DemandStatus(
            phase=status_raw.get("phase", ""),
            last_transition_time=_parse_transition_time(
                _get(status_raw, "last-transition-time", "lastTransitionTime")
            ),
            fulfilled_zone=_get(status_raw, "fulfilled-zone", "fulfilledZone") or None,
        ),
        **_metadata_fields(raw, with_annotations=False),
    )


def demand_v1alpha1_to_wire(d1: DemandV1Alpha1) -> dict:
    """v1alpha1 legacy shape (apis/scaler/v1alpha1/types_demand.go:36-62):
    units carry flat cpu/memory/gpu quantities; no zone semantics."""
    status: dict[str, Any] = {"phase": d1.phase}
    if d1.last_transition_time:
        status["last-transition-time"] = _format_transition_time(
            d1.last_transition_time
        )
    return {
        "apiVersion": DEMAND_V1ALPHA1,
        "kind": "Demand",
        "metadata": _metadata_to_wire(d1),
        "spec": {
            "units": [
                {
                    "cpu": format_quantity_milli(u.cpu_milli),
                    "memory": format_quantity_kib(u.mem_kib),
                    **(
                        {"gpu": format_quantity_milli(u.gpu_milli)} if u.gpu_milli else {}
                    ),
                    "count": u.count,
                }
                for u in d1.units
            ],
            "instance-group": d1.instance_group,
            "is-long-lived": d1.is_long_lived,
        },
        "status": status,
    }


def demand_v1alpha1_from_wire(raw: dict) -> DemandV1Alpha1:
    spec_raw = raw.get("spec") or {}
    units = []
    for u in spec_raw.get("units") or []:
        res = resources_from_quantity_map(
            {
                "cpu": u.get("cpu", "0"),
                "memory": u.get("memory", "0"),
                "nvidia.com/gpu": u.get("gpu", "0"),
            }
        )
        units.append(
            DemandUnitV1Alpha1(
                cpu_milli=res.cpu_milli,
                mem_kib=res.mem_kib,
                count=int(u.get("count", 0)),
                gpu_milli=res.gpu_milli,
            )
        )
    status_raw = raw.get("status") or {}
    return DemandV1Alpha1(
        units=units,
        instance_group=_get(spec_raw, "instance-group", "instanceGroup", ""),
        is_long_lived=bool(_get(spec_raw, "is-long-lived", "isLongLived", False)),
        phase=status_raw.get("phase", ""),
        last_transition_time=_parse_transition_time(
            _get(status_raw, "last-transition-time", "lastTransitionTime")
        ),
        **_metadata_fields(raw, with_annotations=False),
    )


# ------------------------------------------------------------- review logic

_DECODERS: dict[str, Callable[[dict], Any]] = {
    RR_V1BETA1: rr_v1beta1_from_wire,
    RR_V1BETA2: rr_v1beta2_from_wire,
    DEMAND_V1ALPHA1: demand_v1alpha1_from_wire,
    DEMAND_V1ALPHA2: demand_v1alpha2_from_wire,
}


def _convert_object(raw: dict, desired: str) -> dict:
    src = raw.get("apiVersion", "")
    decode = _DECODERS.get(src)
    if decode is None:
        raise ValueError(f"unsupported apiVersion {src!r}")
    if desired not in _DECODERS:
        raise ValueError(f"unsupported desiredAPIVersion {desired!r}")
    if src == desired:
        return raw
    obj = decode(raw)

    if src == RR_V1BETA1:
        obj = convert_from_v1beta1(obj)
    elif src == DEMAND_V1ALPHA1:
        obj = convert_demand_from_v1alpha1(obj)
    # obj is now the hub (storage) model: v1beta2 RR or v1alpha2 Demand.

    if desired == RR_V1BETA2:
        return rr_v1beta2_to_wire(obj)
    if desired == RR_V1BETA1:
        return rr_v1beta1_to_wire(convert_to_v1beta1(obj))
    if desired == DEMAND_V1ALPHA2:
        return demand_v1alpha2_to_wire(obj)
    return demand_v1alpha1_to_wire(convert_demand_to_v1alpha1(obj))


def convert_review(review: dict) -> dict:
    """Handle a ConversionReview (conversionwebhook/resource_reservation.go:
    44-98): convert request.objects to request.desiredAPIVersion; any failure
    fails the whole review (the apiserver retries)."""
    if not isinstance(review, dict):
        review = {}
    request = review.get("request")
    if not isinstance(request, dict):
        request = {}
    uid = request.get("uid", "")
    desired = request.get("desiredAPIVersion", "")
    converted = []
    try:
        objects = request.get("objects") or []
        if not isinstance(objects, list):
            raise ValueError("request.objects must be a list")
        for raw in objects:
            if not isinstance(raw, dict):
                raise ValueError("conversion objects must be JSON objects")
            converted.append(_convert_object(raw, desired))
        response: dict[str, Any] = {
            "uid": uid,
            "convertedObjects": converted,
            "result": {"status": "Success"},
        }
    except Exception as exc:
        response = {
            "uid": uid,
            "convertedObjects": [],
            "result": {"status": "Failed", "message": str(exc)},
        }
    return {
        "apiVersion": review.get("apiVersion", "apiextensions.k8s.io/v1"),
        "kind": "ConversionReview",
        "response": response,
    }
