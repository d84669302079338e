"""Scale-down drainer: cordon + remove nodes idle past a TTL.

Two-phase, like a real node-group scale-down: a node that has been idle
(no hard reservation, no soft reservation, no pod bound to it) for
`idle_ttl_s` is CORDONED first (a replacement Node object with
unschedulable=True, the watch-path idiom — the solver's candidate mask
excludes cordoned nodes, so no new gang can land while the drain is
pending); on a LATER pass, if it is still idle, it is deleted. A node that
picks up work between the two phases is uncordoned and forgotten.

The refusal rule is absolute: reservation_manager (hard slots) and the
soft-reservation store are the source of truth, and a node either of them
names is never cordoned or deleted, whatever its idle age. By default only
nodes the provisioner created (PROVISIONED_BY_LABEL) are eligible, so the
static fleet — cordoned by an operator or not — is never touched. An
eligible node found cordoned outside this drainer's memory (a pre-restart
drain pass whose in-memory phase state died with the process, or an
operator cordoning elastic capacity) is re-adopted: idle-tracked and
removed only after a full fresh TTL of staying reservation-free.

The port's copy of spark_scheduler_tpu/autoscaler/drainer.py.
"""

from __future__ import annotations

import dataclasses

from spark_scheduler_tpu_torch.autoscaler.provisioner import (
    PROVISIONED_BY_LABEL,
    PROVISIONER_NAME,
)
from spark_scheduler_tpu_torch.store.backend import BackendError


class ScaleDownDrainer:
    def __init__(
        self,
        backend,
        rr_cache,
        soft_store,
        idle_ttl_s: float = 300.0,
        clock=None,
        drain_static_fleet: bool = False,
        census=None,
    ):
        import time as _time

        self._backend = backend
        self._rr_cache = rr_cache
        self._soft_store = soft_store
        self.idle_ttl_s = idle_ttl_s
        self._clock = clock or _time.time
        self._drain_static = drain_static_fleet
        # Incremental control-loop census (core/census.py): when attached,
        # a drain pass reads the resident node mirror / busy refcounts
        # (O(eligible fleet) per pass, O(1) busy checks) instead of
        # re-listing every node, pod, and reservation. None = the
        # reference's full walks.
        self._census = census
        self._idle_since: dict[str, float] = {}
        # Nodes WE cordoned, pending deletion next pass. Operator cordons
        # are not in this map and are never uncordoned by us.
        self._pending_drain: set[str] = set()

    # -- busy-node census ----------------------------------------------------

    def reserved_node_names(self) -> set[str]:
        """Every node a hard OR soft reservation names — the never-drain set."""
        if self._census is not None:
            return self._census.reserved_node_names()
        used: set[str] = set()
        for rr in self._rr_cache.list():
            for res in rr.spec.reservations.values():
                used.add(res.node)
        for sr in self._soft_store.get_all_copy().values():
            for r in sr.reservations.values():
                used.add(r.node)
        return used

    def _busy_nodes(self) -> set[str]:
        busy = self.reserved_node_names()
        for pod in self._backend.list("pods"):
            if pod.node_name and not pod.is_terminated():
                busy.add(pod.node_name)
        return busy

    # -- the pass ------------------------------------------------------------

    def run_once(self, now: float | None = None) -> list[str]:
        """One drain pass; returns the names of nodes deleted this pass."""
        if now is None:
            now = self._clock()
        census = self._census
        if census is not None:
            # Census pass: scan only the eligible (provisioned) fleet —
            # at the million-node tier the static fleet never enters the
            # loop — with O(1) busy checks against the resident refcounts.
            # Identical decisions to the full-walk pass (the census is the
            # same sources, event-maintained).
            busy = None
            live = (
                census.nodes_view()
                if self._drain_static
                else census.eligible_view()
            )
        else:
            busy = self._busy_nodes()
            live = {n.name: n for n in self._backend.list_nodes()}
        drained: list[str] = []
        # Forget tracking state for nodes that disappeared out from under us.
        for name in list(self._idle_since):
            if name not in live:
                del self._idle_since[name]
        self._pending_drain &= set(live)

        for name, node in live.items():
            eligible = self._drain_static or (
                node.labels.get(PROVISIONED_BY_LABEL) == PROVISIONER_NAME
            )
            if not eligible:
                continue
            is_busy = census.is_busy(name) if busy is None else name in busy
            if is_busy:
                # Busy again: reset the idle clock; if we had cordoned it
                # for drain, hand it back (a reservation raced the cordon).
                # On a failed uncordon write (rv conflict with concurrent
                # ingestion) the node STAYS in _pending_drain so the
                # uncordon retries next pass against the re-listed object.
                self._idle_since.pop(name, None)
                if name in self._pending_drain and self._mutate(
                    "update", dataclasses.replace(node, unschedulable=False)
                ):
                    self._pending_drain.discard(name)
                continue
            if name in self._pending_drain:
                # Phase 2: still idle after a full pass cordoned — remove.
                if self._mutate("delete", node):
                    drained.append(name)
                self._pending_drain.discard(name)
                self._idle_since.pop(name, None)
                continue
            if node.unschedulable:
                # An eligible (provisioned) node cordoned outside this
                # drainer's memory: a pre-restart drain pass (the durable
                # backend persists nodes; _pending_drain doesn't survive),
                # or an operator cordoning elastic capacity. Re-adopt it —
                # idle-track and remove only after a FULL fresh TTL of
                # staying reservation-free, never instantly. Static-fleet
                # cordons are never seen here (not eligible).
                if now - self._idle_since.setdefault(name, now) >= self.idle_ttl_s:
                    self._pending_drain.add(name)
                continue
            first_idle = self._idle_since.setdefault(name, now)
            if now - first_idle >= self.idle_ttl_s:
                # Phase 1: cordon with a REPLACEMENT object (watch-path
                # idiom; in-place mutation would defeat the solver's
                # identity-based arena sync).
                if self._mutate(
                    "update", dataclasses.replace(node, unschedulable=True)
                ):
                    self._pending_drain.add(name)
        return drained

    def _mutate(self, verb: str, node) -> bool:
        """Node write tolerant of concurrent topology churn: a node updated
        or deleted out from under a drain pass just falls out of this pass;
        the next one re-censuses."""
        try:
            if verb == "delete":
                self._backend.delete("nodes", "", node.name)
            else:
                self._backend.update("nodes", node)
            return True
        except BackendError:
            return False
