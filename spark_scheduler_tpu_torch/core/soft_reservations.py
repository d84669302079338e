"""In-memory soft reservations for dynamic-allocation extra executors.

Rebuilds internal/cache/softreservations.go:32-254, including the tombstone
`status` map that defeats the race between an executor's death event and a
late scheduling request for the same executor: once an executor name is
marked dead (status[name]=False), AddReservationForPod is a no-op for it.
"""

from __future__ import annotations

import dataclasses
import threading
from types import MappingProxyType
from typing import Mapping

from spark_scheduler_tpu_torch.models.kube import Pod
from spark_scheduler_tpu_torch.models.reservations import Reservation
from spark_scheduler_tpu_torch.models.resources import FrozenResources, Resources
from spark_scheduler_tpu_torch.core.sparkpods import (
    ROLE_DRIVER,
    ROLE_EXECUTOR,
    SPARK_APP_ID_LABEL,
    SPARK_ROLE_LABEL,
    is_spark_scheduler_pod,
)


@dataclasses.dataclass
class SoftReservation:
    reservations: dict[str, Reservation] = dataclasses.field(default_factory=dict)
    status: dict[str, bool] = dataclasses.field(default_factory=dict)

    def copy(self) -> "SoftReservation":
        return SoftReservation(
            reservations={k: v.copy() for k, v in self.reservations.items()},
            status=dict(self.status),
        )


class SoftReservationStore:
    def __init__(self, backend=None):
        self._store: dict[str, SoftReservation] = {}
        self._lock = threading.RLock()
        # Both listener families fire AFTER the store lock is released, so a
        # listener may re-enter store queries without lock-order inversion
        # (listeners take their own locks, then call back into this store).
        # Consequence: deltas can be observed reordered relative to store
        # state; consumers must treat them as commutative increments.
        # Delta listeners: fn(node, resources, sign) on every soft-usage
        # change (+1 reservation added, -1 removed) — the incremental feed
        # for ReservedUsageTracker.
        self._delta_listeners: list = []
        # Membership listeners: fn(app_id, pod_name) fired when an executor
        # gains/loses a soft reservation — the overhead computer's signal
        # that the pod flipped between overhead and reserved.
        self._membership_listeners: list = []
        # Incrementally-maintained per-node usage aggregate (the dense
        # mirror behind used_soft_reservation_resources): mutable running
        # sums + reservation refcounts per node, updated under the lock by
        # the same mutations that feed the delta listeners. The walk over
        # every app x reservation is gone from the query path.
        self._usage_sum: dict[str, Resources] = {}
        self._usage_refs: dict[str, int] = {}
        self._usage_version = 0
        self._usage_view: tuple[int, Mapping[str, FrozenResources]] | None = None
        if backend is not None:
            backend.subscribe("pods", on_delete=self._on_pod_deletion)

    def add_delta_listener(self, fn) -> None:
        self._delta_listeners.append(fn)

    def add_membership_listener(self, fn) -> None:
        self._membership_listeners.append(fn)

    def _notify_delta(self, node: str, resources: Resources, sign: int) -> None:
        for fn in self._delta_listeners:
            fn(node, resources, sign)

    def _notify_membership(self, app_id: str, pod_name: str) -> None:
        for fn in self._membership_listeners:
            fn(app_id, pod_name)

    # -- queries ------------------------------------------------------------

    def get_soft_reservation(self, app_id: str) -> tuple[SoftReservation, bool]:
        with self._lock:
            sr = self._store.get(app_id)
            if sr is None:
                return SoftReservation(), False
            return sr.copy(), True

    def get_all_copy(self) -> dict[str, SoftReservation]:
        with self._lock:
            return {k: v.copy() for k, v in self._store.items()}

    def executor_has_soft_reservation(self, executor: Pod) -> bool:
        return self.get_executor_soft_reservation(executor) is not None

    def get_executor_soft_reservation(self, executor: Pod) -> Reservation | None:
        app_id = executor.labels.get(SPARK_APP_ID_LABEL)
        if app_id is None:
            return None
        with self._lock:
            sr = self._store.get(app_id)
            if sr is not None and executor.name in sr.reservations:
                return sr.reservations[executor.name].copy()
        return None

    def used_soft_reservation_resources(self) -> Mapping[str, Resources]:
        """Per-node usage of all live soft reservations
        (softreservations.go:155-172).

        Returns a MEMOIZED IMMUTABLE view (MappingProxyType of
        FrozenResources) over the incrementally-maintained aggregate —
        the same shape as the reference's fresh dict, but O(1) when
        nothing changed since the last call and never a per-app walk.
        Mutating the view (or a value in it) raises; call `.copy()` on a
        value for a mutable one."""
        with self._lock:
            view = self._usage_view
            if view is not None and view[0] == self._usage_version:
                return view[1]
            frozen = MappingProxyType(
                {
                    node: FrozenResources(
                        res.cpu_milli, res.mem_kib, res.gpu_milli
                    )
                    for node, res in self._usage_sum.items()
                }
            )
            self._usage_view = (self._usage_version, frozen)
            return frozen

    def _usage_apply(self, node: str, resources: Resources, sign: int) -> None:
        """Apply one reservation delta to the dense mirror (caller holds
        the lock). Refcounted so a node whose reservations all vanish
        drops out of the view exactly as the reference's walk would omit
        it — including zero-resource reservations."""
        refs = self._usage_refs.get(node, 0) + sign
        if refs <= 0:
            self._usage_refs.pop(node, None)
            self._usage_sum.pop(node, None)
        else:
            self._usage_refs[node] = refs
            cur = self._usage_sum.get(node)
            if cur is None:
                cur = self._usage_sum[node] = Resources.zero()
            if sign > 0:
                cur.add(resources)
            else:
                cur.sub(resources)
        self._usage_version += 1

    # -- mutations ----------------------------------------------------------

    def create_soft_reservation_if_not_exists(self, app_id: str) -> None:
        with self._lock:
            self._store.setdefault(app_id, SoftReservation())

    def add_reservation_for_pod(
        self, app_id: str, pod_name: str, reservation: Reservation
    ) -> None:
        with self._lock:
            sr = self._store.get(app_id)
            if sr is None:
                raise KeyError(
                    f"cannot add soft reservation: app {app_id} not in store"
                )
            if pod_name in sr.status:
                # tombstoned (dead) or already reserved: no-op
                # (softreservations.go:119-127)
                return
            sr.reservations[pod_name] = reservation
            sr.status[pod_name] = True
            self._usage_apply(reservation.node, reservation.resources, +1)
        self._notify_delta(reservation.node, reservation.resources, +1)
        self._notify_membership(app_id, pod_name)

    def remove_executor_reservation(self, app_id: str, executor_name: str) -> None:
        with self._lock:
            sr = self._store.get(app_id)
            if sr is None:
                return
            removed = sr.reservations.pop(executor_name, None)
            # Always tombstone: remember the death to beat the
            # death-event/schedule-request race (softreservations.go:197-210).
            sr.status[executor_name] = False
            if removed is not None:
                self._usage_apply(removed.node, removed.resources, -1)
        if removed is not None:
            self._notify_delta(removed.node, removed.resources, -1)
            self._notify_membership(app_id, executor_name)

    def remove_driver_reservation(self, app_id: str) -> None:
        with self._lock:
            sr = self._store.pop(app_id, None)
            if sr is not None:
                for r in sr.reservations.values():
                    self._usage_apply(r.node, r.resources, -1)
        if sr is not None:
            for name, r in sr.reservations.items():
                self._notify_delta(r.node, r.resources, -1)
                self._notify_membership(app_id, name)

    def _on_pod_deletion(self, pod: Pod) -> None:
        if not is_spark_scheduler_pod(pod):
            return
        app_id = pod.labels.get(SPARK_APP_ID_LABEL, "")
        role = pod.labels.get(SPARK_ROLE_LABEL)
        if role == ROLE_DRIVER:
            self.remove_driver_reservation(app_id)
        elif role == ROLE_EXECUTOR:
            self.remove_executor_reservation(app_id, pod.name)

    # -- metrics ------------------------------------------------------------

    def application_count(self) -> int:
        with self._lock:
            return len(self._store)

    def active_extra_executor_count(self) -> int:
        with self._lock:
            return sum(len(sr.reservations) for sr in self._store.values())
