"""Full CRD definitions with openAPI v3 schemas.

The reference ships complete CustomResourceDefinition manifests for both
CRD groups — served/storage version sets, structural openAPI validation,
status subresource, and the webhook conversion strategy
(vendor/.../apis/sparkscheduler/v1beta2/crd_resource_reservation.go:23-115,
vendor/.../apis/scaler/v1alpha2/crd_demand.go:15-195). These builders
produce the equivalent manifests as plain dicts; they are what
`ensure_resource_reservations_crd` registers, what the deployment
manifests in examples/ embed, and what the fake apiserver can validate
against.
"""

from __future__ import annotations

from typing import Any, Optional

RESERVATION_GROUP = "sparkscheduler.palantir.com"
DEMAND_GROUP = "scaler.palantir.com"
RESERVATION_CRD_NAME = f"resourcereservations.{RESERVATION_GROUP}"
DEMAND_CRD_NAME = f"demands.{DEMAND_GROUP}"

_QUANTITY = {
    # k8s resource.Quantity serializes as a string or (small ints) a number;
    # the reference schema uses x-kubernetes-int-or-string semantics.
    "x-kubernetes-int-or-string": True,
}

_RESOURCES_SCHEMA = {
    "type": "object",
    "properties": {
        "cpu": _QUANTITY,
        "memory": _QUANTITY,
        "nvidia.com/gpu": _QUANTITY,
    },
}


def _objectmeta_passthrough() -> dict:
    return {"type": "object"}


def resource_reservation_crd(webhook_url: Optional[str] = None,
                             ca_bundle: Optional[str] = None) -> dict:
    """The ResourceReservation CRD: v1beta2 is the storage version, v1beta1
    stays served for old clients, and a conversion webhook bridges them
    (crd_resource_reservation.go:83-115). `webhook_url` wires the conversion
    client config the way InitializeCRDConversionWebhook does in-process
    (internal/conversionwebhook/resource_reservation.go:46-84)."""
    v1beta2_schema = {
        "openAPIV3Schema": {
            "type": "object",
            "properties": {
                "metadata": _objectmeta_passthrough(),
                "spec": {
                    "type": "object",
                    "required": ["reservations"],
                    "properties": {
                        "reservations": {
                            "type": "object",
                            "additionalProperties": {
                                "type": "object",
                                "required": ["node", "resources"],
                                "properties": {
                                    "node": {"type": "string"},
                                    "resources": _RESOURCES_SCHEMA,
                                },
                            },
                        },
                        # Gang priority class (policy subsystem); optional so
                        # pre-policy objects — and all objects written with
                        # the engine off — validate unchanged.
                        "priorityClass": {"type": "string"},
                    },
                },
                "status": {
                    "type": "object",
                    "properties": {
                        "pods": {
                            "type": "object",
                            "additionalProperties": {"type": "string"},
                        }
                    },
                },
            },
        }
    }
    v1beta1_schema = {
        "openAPIV3Schema": {
            "type": "object",
            "properties": {
                "metadata": _objectmeta_passthrough(),
                "spec": {
                    "type": "object",
                    "required": ["reservations"],
                    "properties": {
                        "reservations": {
                            "type": "object",
                            "additionalProperties": {
                                "type": "object",
                                "required": ["node", "cpu", "memory"],
                                "properties": {
                                    "node": {"type": "string"},
                                    "cpu": _QUANTITY,
                                    "memory": _QUANTITY,
                                },
                            },
                        }
                    },
                },
                "status": {
                    "type": "object",
                    "properties": {
                        "pods": {
                            "type": "object",
                            "additionalProperties": {"type": "string"},
                        }
                    },
                },
            },
        }
    }
    conversion: dict[str, Any] = {"strategy": "None"}
    if webhook_url:
        conversion = {
            "strategy": "Webhook",
            "webhook": {
                "conversionReviewVersions": ["v1"],
                "clientConfig": {
                    "url": webhook_url,
                    **({"caBundle": ca_bundle} if ca_bundle else {}),
                },
            },
        }
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": RESERVATION_CRD_NAME},
        "spec": {
            "group": RESERVATION_GROUP,
            "scope": "Namespaced",
            "names": {
                "kind": "ResourceReservation",
                "listKind": "ResourceReservationList",
                "plural": "resourcereservations",
                "singular": "resourcereservation",
                "shortNames": ["rr"],
            },
            "preserveUnknownFields": False,
            "conversion": conversion,
            "versions": [
                {
                    "name": "v1beta1",
                    "served": True,
                    "storage": False,
                    "schema": v1beta1_schema,
                },
                {
                    "name": "v1beta2",
                    "served": True,
                    "storage": True,
                    "schema": v1beta2_schema,
                },
            ],
        },
    }


def demand_crd() -> dict:
    """The Demand CRD (owned by the external autoscaler; the scheduler only
    consumes it): v1alpha2 storage with the status subresource and phase
    enum validation (crd_demand.go:15-195)."""
    unit_v1alpha2 = {
        "type": "object",
        "required": ["resources", "count"],
        "properties": {
            "resources": _RESOURCES_SCHEMA,
            "count": {"type": "integer", "minimum": 0},
            "pod-names-by-namespace": {
                "type": "object",
                "additionalProperties": {
                    "type": "array",
                    "items": {"type": "string"},
                },
            },
        },
    }
    v1alpha2_schema = {
        "openAPIV3Schema": {
            "type": "object",
            "properties": {
                "metadata": _objectmeta_passthrough(),
                "spec": {
                    "type": "object",
                    "required": ["units", "instance-group"],
                    "properties": {
                        "units": {"type": "array", "items": unit_v1alpha2},
                        "instance-group": {"type": "string"},
                        "is-long-lived": {"type": "boolean"},
                        "enforce-single-zone-scheduling": {"type": "boolean"},
                        "zone": {"type": "string"},
                    },
                },
                "status": {
                    "type": "object",
                    "properties": {
                        "phase": {
                            "type": "string",
                            # types_demand.go phases: empty/pending/fulfilled/
                            # cannot-fulfill
                            "enum": [
                                "",
                                "empty",
                                "pending",
                                "fulfilled",
                                "cannot-fulfill",
                            ],
                        },
                        "last-transition-time": {"type": "string"},
                        "fulfilled-zone": {"type": "string"},
                    },
                },
            },
        }
    }
    unit_v1alpha1 = {
        "type": "object",
        "required": ["count"],
        "properties": {
            "cpu": _QUANTITY,
            "memory": _QUANTITY,
            "gpu": _QUANTITY,
            "count": {"type": "integer", "minimum": 0},
        },
    }
    v1alpha1_schema = {
        "openAPIV3Schema": {
            "type": "object",
            "properties": {
                "metadata": _objectmeta_passthrough(),
                "spec": {
                    "type": "object",
                    "required": ["units", "instance-group"],
                    "properties": {
                        "units": {"type": "array", "items": unit_v1alpha1},
                        "instance-group": {"type": "string"},
                        "is-long-lived": {"type": "boolean"},
                    },
                },
                "status": {
                    "type": "object",
                    "properties": {
                        "phase": {"type": "string"},
                        "last-transition-time": {"type": "string"},
                    },
                },
            },
        }
    }
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": DEMAND_CRD_NAME},
        "spec": {
            "group": DEMAND_GROUP,
            "scope": "Namespaced",
            "names": {
                "kind": "Demand",
                "listKind": "DemandList",
                "plural": "demands",
                "singular": "demand",
                "shortNames": ["dem"],
            },
            "preserveUnknownFields": False,
            "conversion": {"strategy": "None"},
            "versions": [
                {
                    "name": "v1alpha1",
                    "served": True,
                    "storage": False,
                    "schema": v1alpha1_schema,
                },
                {
                    "name": "v1alpha2",
                    "served": True,
                    "storage": True,
                    "schema": v1alpha2_schema,
                    "subresources": {"status": {}},
                },
            ],
        },
    }


def validate_against_schema(obj: dict, schema: dict, path: str = "$") -> list[str]:
    """Minimal structural openAPI v3 validator (type / required /
    properties / additionalProperties / items / enum / minimum /
    int-or-string) — enough to enforce the CRD schemas above the way the
    apiserver's structural validation would. Returns a list of violation
    strings (empty = valid)."""
    errors: list[str] = []
    if schema.get("x-kubernetes-int-or-string"):
        if not isinstance(obj, (int, float, str)):
            errors.append(f"{path}: expected int-or-string, got {type(obj).__name__}")
        return errors
    stype = schema.get("type")
    if stype == "object":
        if not isinstance(obj, dict):
            return [f"{path}: expected object, got {type(obj).__name__}"]
        for req in schema.get("required", []):
            if req not in obj:
                errors.append(f"{path}: missing required field '{req}'")
        props = schema.get("properties", {})
        extra = schema.get("additionalProperties")
        for key, val in obj.items():
            if key in props:
                errors.extend(validate_against_schema(val, props[key], f"{path}.{key}"))
            elif isinstance(extra, dict):
                errors.extend(validate_against_schema(val, extra, f"{path}.{key}"))
    elif stype == "array":
        if not isinstance(obj, list):
            return [f"{path}: expected array, got {type(obj).__name__}"]
        item_schema = schema.get("items")
        if isinstance(item_schema, dict):
            for i, item in enumerate(obj):
                errors.extend(validate_against_schema(item, item_schema, f"{path}[{i}]"))
    elif stype == "string":
        if not isinstance(obj, str):
            errors.append(f"{path}: expected string, got {type(obj).__name__}")
    elif stype == "integer":
        if not isinstance(obj, int) or isinstance(obj, bool):
            errors.append(f"{path}: expected integer, got {type(obj).__name__}")
        elif "minimum" in schema and obj < schema["minimum"]:
            errors.append(f"{path}: {obj} < minimum {schema['minimum']}")
    elif stype == "boolean":
        if not isinstance(obj, bool):
            errors.append(f"{path}: expected boolean, got {type(obj).__name__}")
    if "enum" in schema and obj not in schema["enum"]:
        errors.append(f"{path}: {obj!r} not in enum {schema['enum']}")
    return errors


def validate_custom_resource(crd: dict, obj: dict) -> list[str]:
    """Validate a custom resource against its CRD's schema for the
    apiVersion the object declares."""
    api_version = obj.get("apiVersion", "")
    version = api_version.split("/")[-1] if api_version else ""
    for v in crd["spec"]["versions"]:
        if v["name"] == version:
            schema = (v.get("schema") or {}).get("openAPIV3Schema")
            if schema is None:
                return []
            return validate_against_schema(obj, schema)
    return [f"$: version {version!r} not served by {crd['metadata']['name']}"]
