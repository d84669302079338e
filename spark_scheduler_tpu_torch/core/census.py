"""ClusterCensus — incrementally-maintained control-loop state.

The autoscaler and scale-down drainer used to re-derive their world on
every pass: `len(backend.list_nodes())` for the cluster size (three times
per autoscaler pass), a full walk of every reservation of every app plus
every pod for the drainer's never-drain/busy census — O(nodes + pods +
apps x slots) Python per pass even when nothing changed. At the
million-node tier those passes dominate the control plane.

This census keeps the same answers RESIDENT and event-maintained, the
feature-store pattern applied to the control loops:

  node mirror       {name: Node} + O(1) count, fed by backend node events;
                    optionally an `eligible` subset indexed by one label
                    (the drainer's provisioned-by filter), so a drain pass
                    scans the elastic fleet, not the whole cluster.
  busy pods         per-node refcount of bound, non-terminated pods, fed
                    by backend pod events.
  reserved nodes    per-node refcount of hard reservation slots (rr-cache
                    mutation listener, the cache-owner invariant the
                    ReservedUsageTracker rides) + soft reservations (the
                    store's delta listeners). Refcounted, not summed: a
                    zero-resource reservation still pins its node.

Every query is O(1) or O(answer); every event costs O(changed). `rebuild()`
recomputes from the sources — the attach-time oracle and the consistency
tests' from-scratch twin.

The port's copy of spark_scheduler_tpu/core/census.py.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from spark_scheduler_tpu_torch.models.kube import Node, Pod
from spark_scheduler_tpu_torch.store.cache import BatchableListener


class ClusterCensus:
    def __init__(
        self,
        backend,
        rr_cache=None,
        soft_store=None,
        eligible_label: tuple[str, str] | None = None,
    ):
        self._backend = backend
        self._rr_cache = rr_cache
        self._soft_store = soft_store
        self._eligible_label = eligible_label
        self._lock = threading.RLock()
        self._nodes: dict[str, Node] = {}
        self._eligible: dict[str, Node] = {}
        self._pods_on_node: dict[str, int] = {}
        self._reserved_refs: dict[str, int] = {}
        # Instrumentation — the O(changed) claim as counters.
        self.events_applied = 0
        self.rebuilds = 0
        backend.subscribe(
            "nodes",
            on_add=self._on_node_add,
            on_update=self._on_node_update,
            on_delete=self._on_node_delete,
        )
        backend.subscribe(
            "pods",
            on_add=self._on_pod_add,
            on_update=self._on_pod_update,
            on_delete=self._on_pod_delete,
        )
        if rr_cache is not None:
            rr_cache.add_mutation_listener(
                BatchableListener(self._on_rr_mutation, self._on_rr_batch)
            )
        if soft_store is not None:
            soft_store.add_delta_listener(self._on_soft_delta)
        self.rebuild()

    # -- queries -------------------------------------------------------------

    def node_count(self) -> int:
        with self._lock:
            return len(self._nodes)

    def get_node(self, name: str) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(name)

    def nodes_view(self) -> dict[str, Node]:
        """Snapshot of the full node mirror (O(nodes) copy — callers that
        only need the eligible subset should use eligible_view)."""
        with self._lock:
            return dict(self._nodes)

    def eligible_view(self) -> dict[str, Node]:
        """Snapshot of the label-eligible subset (O(eligible))."""
        with self._lock:
            if self._eligible_label is None:
                return dict(self._nodes)
            return dict(self._eligible)

    def is_busy(self, name: str) -> bool:
        """Node has a bound non-terminated pod OR any hard/soft
        reservation names it — the drainer's never-drain test, O(1)."""
        with self._lock:
            return (
                self._pods_on_node.get(name, 0) > 0
                or self._reserved_refs.get(name, 0) > 0
            )

    def reserved_node_names(self) -> set[str]:
        with self._lock:
            return set(self._reserved_refs)

    def stats(self) -> dict:
        with self._lock:
            return {
                "nodes": len(self._nodes),
                "eligible": len(self._eligible),
                "busy_nodes": sum(
                    1 for v in self._pods_on_node.values() if v > 0
                ),
                "reserved_nodes": len(self._reserved_refs),
                "events_applied": self.events_applied,
                "rebuilds": self.rebuilds,
            }

    # -- maintenance ---------------------------------------------------------

    def rebuild(self) -> None:
        """Recompute every aggregate from the sources (the from-scratch
        oracle; also the attach-time initializer)."""
        with self._lock:
            self._nodes = {n.name: n for n in self._backend.list_nodes()}
            self._eligible = {
                name: n
                for name, n in self._nodes.items()
                if self._is_eligible(n)
            }
            self._pods_on_node = {}
            for pod in self._backend.list("pods"):
                node = self._pod_contrib(pod)
                if node is not None:
                    self._pods_on_node[node] = (
                        self._pods_on_node.get(node, 0) + 1
                    )
            self._reserved_refs = {}
            if self._rr_cache is not None:
                for rr in self._rr_cache.list():
                    for res in rr.spec.reservations.values():
                        self._ref(res.node, +1)
            if self._soft_store is not None:
                for sr in self._soft_store.get_all_copy().values():
                    for r in sr.reservations.values():
                        self._ref(r.node, +1)
            self.rebuilds += 1

    def _is_eligible(self, node: Node) -> bool:
        if self._eligible_label is None:
            return True
        key, value = self._eligible_label
        return node.labels.get(key) == value

    @staticmethod
    def _pod_contrib(pod: Pod) -> Optional[str]:
        if pod.node_name and not pod.is_terminated():
            return pod.node_name
        return None

    def _ref(self, node: str, sign: int) -> None:
        refs = self._reserved_refs.get(node, 0) + sign
        if refs <= 0:
            self._reserved_refs.pop(node, None)
        else:
            self._reserved_refs[node] = refs

    # -- node events ---------------------------------------------------------

    def _on_node_add(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.name] = node
            if self._is_eligible(node):
                self._eligible[node.name] = node
            else:
                self._eligible.pop(node.name, None)
            self.events_applied += 1

    def _on_node_update(self, _old: Node, new: Node) -> None:
        self._on_node_add(new)

    def _on_node_delete(self, node: Node) -> None:
        with self._lock:
            self._nodes.pop(node.name, None)
            self._eligible.pop(node.name, None)
            self.events_applied += 1

    # -- pod events ----------------------------------------------------------

    def _pod_delta(self, node: Optional[str], sign: int) -> None:
        if node is None:
            return
        cnt = self._pods_on_node.get(node, 0) + sign
        if cnt <= 0:
            self._pods_on_node.pop(node, None)
        else:
            self._pods_on_node[node] = cnt

    def _on_pod_add(self, pod: Pod) -> None:
        with self._lock:
            self._pod_delta(self._pod_contrib(pod), +1)
            self.events_applied += 1

    def _on_pod_update(self, old: Pod, new: Pod) -> None:
        with self._lock:
            self._pod_delta(self._pod_contrib(old), -1)
            self._pod_delta(self._pod_contrib(new), +1)
            self.events_applied += 1

    def _on_pod_delete(self, pod: Pod) -> None:
        with self._lock:
            self._pod_delta(self._pod_contrib(pod), -1)
            self.events_applied += 1

    # -- reservation events --------------------------------------------------

    def _apply_rr(self, old: Any, new: Any) -> None:
        if (
            old is not None
            and new is not None
            and old.spec.reservations == new.spec.reservations
        ):
            return
        if old is not None:
            for res in old.spec.reservations.values():
                self._ref(res.node, -1)
        if new is not None:
            for res in new.spec.reservations.values():
                self._ref(res.node, +1)

    def _on_rr_mutation(self, old: Any, new: Any) -> None:
        with self._lock:
            self._apply_rr(old, new)
            self.events_applied += 1

    def _on_rr_batch(self, pairs) -> None:
        with self._lock:
            for old, new in pairs:
                self._apply_rr(old, new)
            self.events_applied += 1

    def _on_soft_delta(self, node: str, _resources, sign: int) -> None:
        with self._lock:
            self._ref(node, sign)
            self.events_applied += 1
