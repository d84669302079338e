"""ClusterAggregates — resident per-cluster capacity totals for routing
(the port's copy of spark_scheduler_tpu/fleet/aggregates.py).

The ZoneAggregates / ClusterCensus pattern lifted one level: each cluster
in the fleet keeps free/allocatable/reserved totals plus a top-node
headroom vector RESIDENT and event-maintained from its own backend's
node + reservation events, so the fleet router's home-cluster pick is
O(F) over numbers that already exist — no cluster is walked on the
serving path.

Totals are exact int64 sums over (cpu_milli, mem_kib, gpu_milli).
Reserved counts HARD reservations only (the durable commit record): soft
reservations are a compaction hint, not capacity, and the router only
needs a routing signal — `rebuild()` is the walk-oracle twin that
defines the contract and backs the equivalence tests.
"""

from __future__ import annotations

import threading

RESERVATIONS_KIND = "resourcereservations"

_ZERO = (0, 0, 0)


def _res_tuple(r) -> tuple[int, int, int]:
    return (int(r.cpu_milli), int(r.mem_kib), int(r.gpu_milli))


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _fits(need, have) -> bool:
    return need[0] <= have[0] and need[1] <= have[1] and need[2] <= have[2]


class ClusterAggregates:
    """Event-maintained capacity aggregates for ONE cluster's backend."""

    __slots__ = (
        "_backend", "_label", "_lock",
        "_node_alloc", "_node_groups", "_rr_per_node",
        "_reserved_by_node", "_alloc_total", "_reserved_total",
        "_top_dirty", "_top_free",
        "events_applied", "rebuilds",
    )

    def __init__(self, backend, instance_group_label: str):
        self._backend = backend
        self._label = instance_group_label
        self._lock = threading.RLock()
        # name -> (cpu, mem, gpu) allocatable, and name -> group label.
        self._node_alloc: dict[str, tuple[int, int, int]] = {}
        self._node_groups: dict[str, str] = {}
        # rr name -> {node -> (cpu, mem, gpu)} per-reservation totals, and
        # the per-node reserved sum they roll up into.
        self._rr_per_node: dict[str, dict[str, tuple[int, int, int]]] = {}
        self._reserved_by_node: dict[str, tuple[int, int, int]] = {}
        self._alloc_total = _ZERO
        self._reserved_total = _ZERO
        # Top-node free headroom is recomputed lazily: events only mark it
        # dirty, the router's read pays the O(nodes) max when stale.
        self._top_dirty = True
        self._top_free = _ZERO
        self.events_applied = 0
        self.rebuilds = 0
        backend.subscribe(
            "nodes",
            on_add=self._on_node_add,
            on_update=self._on_node_update,
            on_delete=self._on_node_delete,
        )
        backend.subscribe(
            RESERVATIONS_KIND,
            on_add=self._on_rr_upsert,
            on_update=self._on_rr_update,
            on_delete=self._on_rr_delete,
        )
        self.rebuild()

    # -- event feed ----------------------------------------------------------

    def _on_node_add(self, node) -> None:
        with self._lock:
            self.events_applied += 1
            prev = self._node_alloc.get(node.name, _ZERO)
            cur = _res_tuple(node.allocatable)
            self._node_alloc[node.name] = cur
            self._node_groups[node.name] = node.labels.get(self._label, "")
            self._alloc_total = _add(_sub(self._alloc_total, prev), cur)
            self._top_dirty = True

    def _on_node_update(self, old, new) -> None:
        self._on_node_add(new)

    def _on_node_delete(self, node) -> None:
        with self._lock:
            self.events_applied += 1
            prev = self._node_alloc.pop(node.name, None)
            self._node_groups.pop(node.name, None)
            if prev is not None:
                self._alloc_total = _sub(self._alloc_total, prev)
            self._top_dirty = True

    def _on_rr_upsert(self, rr) -> None:
        with self._lock:
            self.events_applied += 1
            self._retire_rr(rr.name)
            per_node: dict[str, tuple[int, int, int]] = {}
            for resv in rr.spec.reservations.values():
                t = _res_tuple(resv.resources)
                per_node[resv.node] = _add(per_node.get(resv.node, _ZERO), t)
            self._rr_per_node[rr.name] = per_node
            for node, t in per_node.items():
                self._reserved_by_node[node] = _add(
                    self._reserved_by_node.get(node, _ZERO), t
                )
                self._reserved_total = _add(self._reserved_total, t)
            self._top_dirty = True

    def _on_rr_update(self, old, new) -> None:
        self._on_rr_upsert(new)

    def _on_rr_delete(self, rr) -> None:
        with self._lock:
            self.events_applied += 1
            self._retire_rr(rr.name)
            self._top_dirty = True

    def _retire_rr(self, name: str) -> None:
        prev = self._rr_per_node.pop(name, None)
        if not prev:
            return
        for node, t in prev.items():
            left = _sub(self._reserved_by_node.get(node, _ZERO), t)
            if left == _ZERO:
                self._reserved_by_node.pop(node, None)
            else:
                self._reserved_by_node[node] = left
            self._reserved_total = _sub(self._reserved_total, t)

    # -- queries -------------------------------------------------------------

    def _refresh_top(self) -> None:
        best = _ZERO
        best_key = (-1, -1, -1)
        for name, alloc in self._node_alloc.items():
            free = _sub(alloc, self._reserved_by_node.get(name, _ZERO))
            key = (free[0], free[1], free[2])
            if key > best_key:
                best_key = key
                best = free
        self._top_free = best
        self._top_dirty = False

    def free_total(self) -> tuple[int, int, int]:
        with self._lock:
            return _sub(self._alloc_total, self._reserved_total)

    def top_node_free(self) -> tuple[int, int, int]:
        """Free headroom of the single best node — the gang-fit ceiling a
        router can check without walking the cluster."""
        with self._lock:
            if self._top_dirty:
                self._refresh_top()
            return self._top_free

    def hosts_group(self, group: str) -> bool:
        with self._lock:
            return group in self._node_groups.values()

    def groups(self) -> set[str]:
        with self._lock:
            return {g for g in self._node_groups.values() if g}

    def could_fit(self, per_pod: tuple[int, int, int], count: int) -> bool:
        """Optimistic admission test: the gang's total fits the cluster's
        free sum AND one pod fits the best node. Optimistic by design —
        the in-cluster solver is the truth; this only ranks siblings."""
        total = (per_pod[0] * count, per_pod[1] * count, per_pod[2] * count)
        return _fits(total, self.free_total()) and _fits(
            per_pod, self.top_node_free()
        )

    def stats(self) -> dict:
        with self._lock:
            free = _sub(self._alloc_total, self._reserved_total)
            if self._top_dirty:
                self._refresh_top()
            return {
                "nodes": len(self._node_alloc),
                "allocatable": list(self._alloc_total),
                "reserved": list(self._reserved_total),
                "free": list(free),
                "top_node_free": list(self._top_free),
                "groups": sorted(self.groups()),
                "events_applied": self.events_applied,
                "rebuilds": self.rebuilds,
            }

    # -- oracle --------------------------------------------------------------

    def rebuild(self) -> None:
        """From-scratch walk over the backend — the oracle twin the
        consistency tests diff the event-maintained state against."""
        with self._lock:
            self.rebuilds += 1
            self._node_alloc = {
                n.name: _res_tuple(n.allocatable)
                for n in self._backend.list_nodes()
            }
            self._node_groups = {
                n.name: n.labels.get(self._label, "")
                for n in self._backend.list_nodes()
            }
            self._alloc_total = _ZERO
            for t in self._node_alloc.values():
                self._alloc_total = _add(self._alloc_total, t)
            self._rr_per_node = {}
            self._reserved_by_node = {}
            self._reserved_total = _ZERO
            for rr in self._backend.list(RESERVATIONS_KIND):
                per_node: dict[str, tuple[int, int, int]] = {}
                for resv in rr.spec.reservations.values():
                    t = _res_tuple(resv.resources)
                    per_node[resv.node] = _add(
                        per_node.get(resv.node, _ZERO), t
                    )
                self._rr_per_node[rr.name] = per_node
                for node, t in per_node.items():
                    self._reserved_by_node[node] = _add(
                        self._reserved_by_node.get(node, _ZERO), t
                    )
                    self._reserved_total = _add(self._reserved_total, t)
            self._top_dirty = True

    def oracle_equals(self) -> bool:
        """Compare the resident state against a fresh walk (test hook)."""
        with self._lock:
            snap = (
                dict(self._node_alloc),
                dict(self._reserved_by_node),
                self._alloc_total,
                self._reserved_total,
            )
            applied, rebuilds = self.events_applied, self.rebuilds
            self.rebuild()
            ok = snap == (
                dict(self._node_alloc),
                dict(self._reserved_by_node),
                self._alloc_total,
                self._reserved_total,
            )
            self.events_applied, self.rebuilds = applied, rebuilds
            return ok
