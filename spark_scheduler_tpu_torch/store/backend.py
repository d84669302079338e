"""Pluggable cluster backend — the framework's "apiserver".

The reference talks to a real Kubernetes apiserver through typed clientsets
and informers (SURVEY.md §2c); its tests swap in fake in-memory clientsets
(extendertest harness). This framework makes that boundary explicit: every
control-plane component takes a `ClusterBackend`, which provides

  - CRUD with optimistic concurrency (resourceVersion conflict on update,
    already-exists on create, not-found on delete) for four kinds:
    pods, nodes, resource reservations, demands;
  - informer-style event subscription (add/update/delete callbacks fired
    synchronously after each mutation);
  - CRD registry (the Demand CRD may not exist yet — SafeDemandCache gates
    on it, internal/cache/safedemands.go:91);
  - namespace-termination simulation (async write-back gives up on writes
    into terminating namespaces, internal/cache/async.go:88-96).

`InMemoryBackend` is both the test harness backend and the state engine for
standalone deployments; a k8s-REST adapter can implement the same interface.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Iterable, Optional

from spark_scheduler_tpu_torch.models.kube import Node, Pod


class BackendError(Exception):
    pass


class ConflictError(BackendError):
    """resourceVersion mismatch on update (async.go:111-120 retry path)."""


class NotFoundError(BackendError):
    pass


class AlreadyExistsError(BackendError):
    pass


class NamespaceTerminatingError(BackendError):
    """Create into a terminating namespace — not retryable (async.go:88-96)."""


class _Handlers:
    def __init__(self):
        self.add: list[Callable[[Any], None]] = []
        self.update: list[Callable[[Any, Any], None]] = []
        self.delete: list[Callable[[Any], None]] = []


KINDS = ("pods", "nodes", "resourcereservations", "demands", "leases")
# The kinds a decision trace journals (replay/trace.TraceWriter subscribes
# to these): their mutations take the trace's order lock when one is set.
ORDERED_KINDS = frozenset({"pods", "nodes"})

DEMAND_CRD = "demands.scaler.palantir.com"
RESERVATION_CRD = "resourcereservations.sparkscheduler.palantir.com"


class ClusterBackend:
    """Interface; see InMemoryBackend for semantics."""


class InMemoryBackend(ClusterBackend):
    def __init__(self):
        self._lock = threading.RLock()
        self._objects: dict[str, dict[tuple[str, str], Any]] = {k: {} for k in KINDS}
        self._handlers: dict[str, _Handlers] = {k: _Handlers() for k in KINDS}
        self._rv_counter = 0
        # Bumped on every NODE add/update/delete: lets serving-path
        # consumers (domain caches, the solver's arena sync) skip O(nodes)
        # re-walks between requests when the topology hasn't changed.
        self.nodes_version = 0
        self._crds: set[str] = {RESERVATION_CRD}
        # Full CRD manifests (openAPI schemas etc.) keyed by CRD name; the
        # reference ships complete CustomResourceDefinition objects
        # (crd_resource_reservation.go:83-115), not just names.
        self._crd_definitions: dict[str, dict] = {}
        self.terminating_namespaces: set[str] = set()
        # Write fault injection for tests: fn(kind, verb, obj) -> Exception | None
        self.fault_injector: Optional[Callable[[str, str, Any], Optional[Exception]]] = None
        # Incrementally-maintained pod indexes by label key — the informer
        # indexer slot (the reference's clientsets list pods through indexed
        # informer caches, never by scanning every pod). Registered lazily
        # by consumers (SparkPodLister); list_pods uses them when the filter
        # carries an indexed key.
        self._pod_indexes: dict[str, dict[str, dict[tuple[str, str], Pod]]] = {}
        # A decision trace's order lock (order_events_with): None unless a
        # trace is being captured.
        self._event_order_lock = None

    def order_events_with(self, lock) -> None:
        """Serialize node and pod mutations, each with its event hooks,
        under `lock`. A trace capture holds the same lock while a serving
        window reads its state and journals itself, so every event lands
        wholly before or wholly after that window in the trace, as the
        scheduler observed it."""
        self._event_order_lock = lock

    def _ordered(self, kind: str):
        lock = self._event_order_lock
        if lock is None or kind not in ORDERED_KINDS:
            return contextlib.nullcontext()
        return lock

    # -- CRDs ---------------------------------------------------------------

    def _on_committed(self, kind: str, verb: str, obj: Any) -> None:
        """Hook invoked INSIDE the mutation lock, after the store changed
        but before the lock releases. DurableBackend appends its WAL record
        here so the log order cannot diverge from commit order under
        concurrent writers (request threads + async write-back workers)."""

    def _on_crd_committed(self, verb: str, name: str, definition) -> None:
        """CRD-registry twin of _on_committed (also inside the lock)."""

    def register_crd(self, name: str, definition: Optional[dict] = None) -> None:
        """Create-or-upgrade: re-registering an existing CRD replaces its
        definition (the reference's EnsureResourceReservationsCRD update
        path, crd/utils.go:98-133)."""
        with self._lock:
            self._crds.add(name)
            if definition is not None:
                self._crd_definitions[name] = definition
            self._on_crd_committed("register_crd", name, definition)

    def crd_exists(self, name: str) -> bool:
        with self._lock:
            return name in self._crds

    def get_crd_definition(self, name: str) -> Optional[dict]:
        with self._lock:
            return self._crd_definitions.get(name)

    def unregister_crd(self, name: str) -> None:
        """Delete-on-failed-verify path (crd/utils.go:134-149)."""
        with self._lock:
            self._crds.discard(name)
            self._crd_definitions.pop(name, None)
            self._on_crd_committed("unregister_crd", name, None)

    # -- event subscription -------------------------------------------------

    def subscribe(
        self,
        kind: str,
        on_add: Callable[[Any], None] | None = None,
        on_update: Callable[[Any, Any], None] | None = None,
        on_delete: Callable[[Any], None] | None = None,
    ) -> None:
        h = self._handlers[kind]
        if on_add:
            h.add.append(on_add)
        if on_update:
            h.update.append(on_update)
        if on_delete:
            h.delete.append(on_delete)

    def _fire(self, kind: str, event: str, *args) -> None:
        h = self._handlers[kind]
        for cb in getattr(h, event):
            cb(*args)

    # -- generic CRUD -------------------------------------------------------

    @staticmethod
    def _key(obj: Any) -> tuple[str, str]:
        return (getattr(obj, "namespace", ""), obj.name)

    def _next_rv(self) -> int:
        self._rv_counter += 1
        return self._rv_counter

    def _check_fault(self, kind: str, verb: str, obj: Any) -> None:
        if self.fault_injector is not None:
            exc = self.fault_injector(kind, verb, obj)
            if exc is not None:
                raise exc

    def create(self, kind: str, obj: Any) -> Any:
        with self._ordered(kind):
            with self._lock:
                self._check_fault(kind, "create", obj)
                ns = getattr(obj, "namespace", "")
                if ns in self.terminating_namespaces:
                    raise NamespaceTerminatingError(ns)
                k = self._key(obj)
                if k in self._objects[kind]:
                    raise AlreadyExistsError(f"{kind} {k}")
                if hasattr(obj, "resource_version"):
                    obj.resource_version = self._next_rv()
                self._objects[kind][k] = obj
                if kind == "pods":
                    self._pod_index_add(obj)
                elif kind == "nodes":
                    self.nodes_version += 1
                self._on_committed(kind, "create", obj)
            self._fire(kind, "add", obj)
        return obj

    def update(self, kind: str, obj: Any) -> Any:
        with self._ordered(kind):
            with self._lock:
                self._check_fault(kind, "update", obj)
                k = self._key(obj)
                cur = self._objects[kind].get(k)
                if cur is None:
                    raise NotFoundError(f"{kind} {k}")
                if hasattr(obj, "resource_version") and hasattr(cur, "resource_version"):
                    if obj.resource_version != cur.resource_version:
                        raise ConflictError(
                            f"{kind} {k}: rv {obj.resource_version} != {cur.resource_version}"
                        )
                    obj.resource_version = self._next_rv()
                old = cur
                self._objects[kind][k] = obj
                if kind == "pods":
                    self._pod_index_remove(old)
                    self._pod_index_add(obj)
                elif kind == "nodes":
                    self.nodes_version += 1
                self._on_committed(kind, "update", obj)
            self._fire(kind, "update", old, obj)
        return obj

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._ordered(kind):
            with self._lock:
                self._check_fault(kind, "delete", (namespace, name))
                cur = self._objects[kind].pop((namespace, name), None)
                if cur is None:
                    raise NotFoundError(f"{kind} {(namespace, name)}")
                if kind == "pods":
                    self._pod_index_remove(cur)
                elif kind == "nodes":
                    self.nodes_version += 1
                self._on_committed(kind, "delete", (namespace, name))
            self._fire(kind, "delete", cur)

    def get(self, kind: str, namespace: str, name: str) -> Optional[Any]:
        with self._lock:
            return self._objects[kind].get((namespace, name))

    def list(self, kind: str) -> list[Any]:
        with self._lock:
            return list(self._objects[kind].values())

    # -- typed conveniences -------------------------------------------------

    def add_node(self, node: Node) -> Node:
        return self.create("nodes", node)

    def get_node(self, name: str) -> Optional[Node]:
        return self.get("nodes", "", name)

    def list_nodes(self) -> list[Node]:
        return self.list("nodes")

    def add_pod(self, pod: Pod) -> Pod:
        return self.create("pods", pod)

    def update_pod(self, pod: Pod) -> Pod:
        return self.update("pods", pod)

    def delete_pod(self, pod: Pod) -> None:
        self.delete("pods", pod.namespace, pod.name)

    def register_pod_index(self, label_key: str) -> None:
        """Maintain a pods-by-label-value index for `label_key`; list_pods
        filters carrying that key then touch only the matching bucket
        instead of scanning every pod (informer-indexer semantics)."""
        with self._lock:
            if label_key in self._pod_indexes:
                return
            idx: dict[str, dict[tuple[str, str], Pod]] = {}
            for k, p in self._objects["pods"].items():
                v = p.labels.get(label_key)
                if v is not None:
                    idx.setdefault(v, {})[k] = p
            self._pod_indexes[label_key] = idx

    def _pod_index_add(self, pod: Pod) -> None:
        k = self._key(pod)
        for label_key, idx in self._pod_indexes.items():
            v = pod.labels.get(label_key)
            if v is not None:
                idx.setdefault(v, {})[k] = pod

    def _pod_index_remove(self, pod: Pod) -> None:
        k = self._key(pod)
        for label_key, idx in self._pod_indexes.items():
            v = pod.labels.get(label_key)
            if v is not None:
                bucket = idx.get(v)
                if bucket is not None:
                    bucket.pop(k, None)
                    if not bucket:
                        idx.pop(v, None)

    def list_pods(
        self,
        namespace: str | None = None,
        labels: dict[str, str] | None = None,
    ) -> list[Pod]:
        with self._lock:
            pods: Iterable[Pod] = None  # type: ignore[assignment]
            if labels:
                for k in labels:
                    idx = self._pod_indexes.get(k)
                    if idx is not None:
                        pods = idx.get(labels[k], {}).values()
                        break
            if pods is None:
                pods = self._objects["pods"].values()
            out = []
            for p in pods:
                if namespace is not None and p.namespace != namespace:
                    continue
                if labels and any(p.labels.get(k) != v for k, v in labels.items()):
                    continue
                out.append(p)
            return out

    def bind_pod(self, pod: Pod, node_name: str, phase: str = "Running") -> Pod:
        """Simulate kube-scheduler binding + kubelet running the pod — the
        harness's Schedule write-back (extender_test_utils.go:176-190)."""
        with self._ordered("pods"):
            with self._lock:
                cur = self._objects["pods"].get((pod.namespace, pod.name))
                if cur is None:
                    raise NotFoundError(pod.name)
                old = Pod(**{f.name: getattr(cur, f.name) for f in cur.__dataclass_fields__.values()})  # type: ignore[attr-defined]
                cur.node_name = node_name
                cur.phase = phase
                self._on_committed("pods", "update", cur)
            self._fire("pods", "update", old, cur)
        return cur
