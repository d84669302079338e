"""Kubernetes JSON wire codecs.

Decodes the k8s-shaped JSON the extender protocol carries (v1.Pod inside
`ExtenderArgs`, vendor/k8s.io/kube-scheduler/extender/v1/types.go:71-80)
into the framework's models, and node objects for the state-sync endpoints.
Only the fields the scheduler consumes are mapped (the reference reads the
same subset through client-go listers).
"""

from __future__ import annotations

from typing import Any

from spark_scheduler_tpu_torch.models.kube import Container, Node, Pod, PodCondition
from spark_scheduler_tpu_torch.models.resources import Resources


def _parse_time(val) -> float:
    """Missing/unparsable creationTimestamp => "now": treating it as epoch 0
    would give ~56-year pod ages, tripping stuck-pod detection and poisoning
    the wait-time histograms."""
    import time as _time

    if val is None:
        return _time.time()
    if isinstance(val, (int, float)):
        return float(val)
    import datetime

    try:
        return datetime.datetime.fromisoformat(str(val).replace("Z", "+00:00")).timestamp()
    except ValueError:
        return _time.time()


def _resources_from_requests(requests: dict | None) -> Resources:
    requests = requests or {}
    return Resources.from_quantities(
        str(requests.get("cpu", "0")),
        str(requests.get("memory", "0")),
        str(requests.get("nvidia.com/gpu", "0")),
    )


def _containers(raw: list | None) -> list[Container]:
    out = []
    for c in raw or []:
        out.append(
            Container(
                name=c.get("name", ""),
                requests=_resources_from_requests(
                    (c.get("resources") or {}).get("requests")
                ),
            )
        )
    return out


def _node_affinity(spec: dict) -> dict[str, list[str]]:
    """Flatten requiredDuringScheduling nodeSelectorTerms matchExpressions
    (In operator) into {label: [values]} (internal/podspec.go:29-53)."""
    out: dict[str, list[str]] = {}
    affinity = (spec.get("affinity") or {}).get("nodeAffinity") or {}
    required = affinity.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    for term in required.get("nodeSelectorTerms") or []:
        for expr in term.get("matchExpressions") or []:
            if expr.get("operator") == "In":
                out.setdefault(expr["key"], []).extend(expr.get("values") or [])
    return out


def pod_from_k8s(raw: dict[str, Any]) -> Pod:
    meta = raw.get("metadata") or {}
    spec = raw.get("spec") or {}
    status = raw.get("status") or {}
    conditions = [
        PodCondition(
            type=c.get("type", ""),
            status=str(c.get("status", "False")).lower() == "true",
            reason=c.get("reason", ""),
            message=c.get("message", ""),
            last_transition_time=_parse_time(c.get("lastTransitionTime")),
        )
        for c in status.get("conditions") or []
    ]
    containers = _containers(spec.get("containers"))
    statuses = {
        cs.get("name"): cs for cs in status.get("containerStatuses") or []
    }
    for c in containers:
        cs = statuses.get(c.name)
        if cs is not None and "terminated" in (cs.get("state") or {}):
            c.terminated = True
    return Pod(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        labels=dict(meta.get("labels") or {}),
        annotations=dict(meta.get("annotations") or {}),
        creation_timestamp=_parse_time(meta.get("creationTimestamp")),
        uid=meta.get("uid", ""),
        deletion_timestamp=(
            _parse_time(meta["deletionTimestamp"])
            if meta.get("deletionTimestamp")
            else None
        ),
        scheduler_name=spec.get("schedulerName", ""),
        node_name=spec.get("nodeName", ""),
        node_selector=dict(spec.get("nodeSelector") or {}),
        node_affinity=_node_affinity(spec),
        containers=containers,
        init_containers=_containers(spec.get("initContainers")),
        phase=status.get("phase", "Pending"),
        conditions=conditions,
    )


def node_from_k8s(raw: dict[str, Any]) -> Node:
    meta = raw.get("metadata") or {}
    spec = raw.get("spec") or {}
    status = raw.get("status") or {}
    alloc = status.get("allocatable") or {}
    ready = True
    for c in status.get("conditions") or []:
        if c.get("type") == "Ready":
            ready = str(c.get("status", "True")).lower() == "true"
    return Node(
        name=meta.get("name", ""),
        allocatable=Resources.from_quantities(
            str(alloc.get("cpu", "0")),
            str(alloc.get("memory", "0")),
            str(alloc.get("nvidia.com/gpu", "0")),
            round_up=False,
        ),
        labels=dict(meta.get("labels") or {}),
        unschedulable=bool(spec.get("unschedulable", False)),
        ready=ready,
        creation_timestamp=_parse_time(meta.get("creationTimestamp")),
    )


def _requests_to_k8s(res: Resources) -> dict:
    from spark_scheduler_tpu_torch.models.resources import resources_to_quantity_map

    return resources_to_quantity_map(res)


def pod_to_k8s(pod: Pod) -> dict[str, Any]:
    """Inverse of pod_from_k8s: emit the k8s-shaped JSON the parser reads
    back losslessly (numeric epoch timestamps are accepted by _parse_time,
    so sub-second creation times survive). Used by the durable store's
    log records and by test fixtures."""
    containers = []
    container_statuses = []
    for c in pod.containers:
        containers.append(
            {"name": c.name, "resources": {"requests": _requests_to_k8s(c.requests)}}
        )
        if c.terminated:
            container_statuses.append({"name": c.name, "state": {"terminated": {}}})
    raw: dict[str, Any] = {
        "kind": "Pod",
        "apiVersion": "v1",
        "metadata": {
            "name": pod.name,
            "namespace": pod.namespace,
            "labels": dict(pod.labels),
            "annotations": dict(pod.annotations),
            "creationTimestamp": pod.creation_timestamp,
            "uid": pod.uid,
            **(
                {"deletionTimestamp": pod.deletion_timestamp}
                if pod.deletion_timestamp is not None
                else {}
            ),
        },
        "spec": {
            "schedulerName": pod.scheduler_name,
            **({"nodeName": pod.node_name} if pod.node_name else {}),
            "nodeSelector": dict(pod.node_selector),
            **(
                {
                    "affinity": {
                        "nodeAffinity": {
                            "requiredDuringSchedulingIgnoredDuringExecution": {
                                "nodeSelectorTerms": [
                                    {
                                        "matchExpressions": [
                                            {
                                                "key": k,
                                                "operator": "In",
                                                "values": list(vals),
                                            }
                                            for k, vals in pod.node_affinity.items()
                                        ]
                                    }
                                ]
                            }
                        }
                    }
                }
                if pod.node_affinity
                else {}
            ),
            "containers": containers,
            "initContainers": [
                {"name": c.name, "resources": {"requests": _requests_to_k8s(c.requests)}}
                for c in pod.init_containers
            ],
        },
        "status": {
            "phase": pod.phase,
            "conditions": [
                {
                    "type": c.type,
                    "status": "True" if c.status else "False",
                    "reason": c.reason,
                    "message": c.message,
                    "lastTransitionTime": c.last_transition_time,
                }
                for c in pod.conditions
            ],
            **(
                {"containerStatuses": container_statuses}
                if container_statuses
                else {}
            ),
        },
    }
    return raw


def node_to_k8s(node: Node) -> dict[str, Any]:
    """Inverse of node_from_k8s."""
    return {
        "kind": "Node",
        "apiVersion": "v1",
        "metadata": {
            "name": node.name,
            "labels": dict(node.labels),
            "creationTimestamp": node.creation_timestamp,
        },
        "spec": {"unschedulable": node.unschedulable},
        "status": {
            "allocatable": _requests_to_k8s(node.allocatable),
            "conditions": [
                {"type": "Ready", "status": "True" if node.ready else "False"}
            ],
        },
    }


def filter_result_to_k8s(result) -> dict[str, Any]:
    """ExtenderFilterResult with Go field names (types.go:86-101; the Go
    struct has no json tags, so fields serialize capitalized). Internal
    failures use the protocol's whole-request Error channel (the per-node
    messages are identical in that case)."""
    error = ""
    if result.outcome == "failure-internal" and result.failed_nodes:
        error = next(iter(result.failed_nodes.values()))
    return {
        "NodeNames": list(result.node_names),
        "FailedNodes": dict(result.failed_nodes),
        "Error": error,
    }


def extender_args_from_k8s(raw: dict[str, Any]):
    """(pod, node_names) from ExtenderArgs JSON. `NodeNames` when the
    scheduler is nodeCacheCapable (examples/extender.yml:56), else the full
    `Nodes` list."""
    pod = pod_from_k8s(raw.get("Pod") or raw.get("pod") or {})
    node_names = raw.get("NodeNames") or raw.get("nodeNames")
    if node_names is None:
        nodes = (raw.get("Nodes") or raw.get("nodes") or {}).get("items") or []
        node_names = [((n.get("metadata") or {}).get("name", "")) for n in nodes]
    return pod, list(node_names)
