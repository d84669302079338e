"""ResourceReservationManager — hard + soft reservation lifecycle.

Rebuilds internal/extender/resourcereservations.go:42-484: reservation
creation for admitted gangs, the executor binding ladder (already-bound /
unbound / rescheduled / soft), unbound-reservation discovery (slots whose
executor is missing, dead, or moved), free soft spots, reserved-usage
aggregation, and dynamic-allocation compaction (soft reservations migrate
into freed hard slots when executors die).
"""

from __future__ import annotations

import threading
from typing import Optional

from spark_scheduler_tpu_torch.models.kube import Pod
from spark_scheduler_tpu_torch.models.reservations import (
    Reservation,
    ResourceReservation,
    new_resource_reservation,
)
from spark_scheduler_tpu_torch.models.resources import Resources
from spark_scheduler_tpu_torch.core.soft_reservations import SoftReservationStore
from spark_scheduler_tpu_torch.core.sparkpods import (
    SPARK_APP_ID_LABEL,
    SparkApplicationResources,
    SparkPodLister,
    is_spark_scheduler_executor_pod,
    spark_resources,
)


class ReservationError(Exception):
    """Maps to failure-internal outcomes."""


class ResourceReservationManager:
    def __init__(
        self,
        backend,
        rr_cache,
        soft_reservation_store: SoftReservationStore,
        pod_lister: SparkPodLister,
    ):
        self._backend = backend
        self.rr_cache = rr_cache
        self.soft_store = soft_reservation_store
        self.pod_lister = pod_lister
        self._mutex = threading.RLock()
        self._compaction_lock = threading.Lock()
        self._compaction_apps: dict[str, str] = {}  # appID -> namespace
        # Optional delta-maintained usage aggregate (core/usage_tracker.py);
        # attached by the DI wiring once the solver's NodeRegistry exists.
        self.usage_tracker = None
        backend.subscribe("pods", on_delete=self._on_executor_pod_deletion)

    def attach_usage_tracker(self, tracker) -> None:
        self.usage_tracker = tracker

    # -- queries ------------------------------------------------------------

    def get_resource_reservation(
        self, app_id: str, namespace: str
    ) -> Optional[ResourceReservation]:
        return self.rr_cache.get(namespace, app_id)

    def pod_has_reservation(self, pod: Pod) -> bool:
        """Hard (Status.Pods) or soft reservation membership
        (resourcereservations.go:88-104)."""
        app_id = pod.labels.get(SPARK_APP_ID_LABEL)
        if app_id is None:
            return False
        rr = self.get_resource_reservation(app_id, pod.namespace)
        if rr is not None and pod.name in rr.status.pods.values():
            return True
        return is_spark_scheduler_executor_pod(
            pod
        ) and self.soft_store.executor_has_soft_reservation(pod)

    def get_reserved_resources(self) -> dict[str, Resources]:
        """Per-node hard+soft reservation usage (resourcereservations.go:228-233).
        With a tracker attached this is the O(nonzero) incremental view;
        otherwise the reference's full walk."""
        if self.usage_tracker is not None:
            return self.usage_tracker.as_map()
        usage: dict[str, Resources] = {}
        for rr in self.rr_cache.list():
            for res in rr.spec.reservations.values():
                usage.setdefault(res.node, Resources.zero()).add(res.resources)
        for node, res in self.soft_store.used_soft_reservation_resources().items():
            usage.setdefault(node, Resources.zero()).add(res)
        return usage

    def reserved_usage(self):
        """Hot-path usage view: the tracker's dense int64 array when attached
        (O(1) per request), else the map (O(apps x slots) fallback). Both
        shapes are accepted by PlacementSolver.build_tensors."""
        if self.usage_tracker is not None:
            return self.usage_tracker.array()
        return self.get_reserved_resources()

    # -- gang admission -----------------------------------------------------

    def create_reservations(
        self,
        driver: Pod,
        app_resources: SparkApplicationResources,
        driver_node: str,
        executor_nodes: list[str],
    ) -> ResourceReservation:
        app_id = driver.labels.get(SPARK_APP_ID_LABEL, driver.name)
        rr = self.get_resource_reservation(app_id, driver.namespace)
        if rr is None:
            rr = new_resource_reservation(
                driver_node,
                executor_nodes,
                driver,
                app_resources.driver_resources,
                app_resources.executor_resources,
            )
            if not self.rr_cache.create(rr):
                raise ReservationError(f"failed to create resource reservation {rr.name}")
        if app_resources.max_executor_count > app_resources.min_executor_count:
            # only dynamic-allocation apps get a soft-reservation shell
            self.soft_store.create_soft_reservation_if_not_exists(app_id)
        return rr

    def create_reservations_batch(
        self, entries: list[tuple]
    ) -> list[Optional[ReservationError]]:
        """A serving window's reservation commits COALESCED: every entry
        still goes through `create_reservations` (so per-entry semantics —
        idempotency, soft shells, failure raising, test fault injection —
        are exactly the serial path's), but under ONE deferred-notification
        context: the usage tracker and overhead store receive a single
        batched delta application per window instead of a listener fan-out
        per reservation.

        `entries` is [(driver, app_resources, driver_node, executor_nodes)]
        in window order. Returns one slot per entry: None on success, else
        the ReservationError that entry raised — the caller fails just that
        request, exactly as the serial path did."""
        out: list[Optional[ReservationError]] = []
        with self.rr_cache.deferred_notifications():
            for driver, app_resources, driver_node, executor_nodes in entries:
                try:
                    self.create_reservations(
                        driver, app_resources, driver_node, executor_nodes
                    )
                    out.append(None)
                except ReservationError as exc:
                    out.append(exc)
        return out

    # -- executor binding ladder -------------------------------------------

    def find_already_bound_reservation_node(
        self, executor: Pod
    ) -> tuple[Optional[str], bool]:
        """Idempotent retry path (resourcereservations.go:133-149)."""
        rr = self.get_resource_reservation(
            executor.labels.get(SPARK_APP_ID_LABEL, ""), executor.namespace
        )
        if rr is None:
            raise ReservationError("failed to get resource reservations")
        for name, res in rr.spec.reservations.items():
            if rr.status.pods.get(name) == executor.name:
                return res.node, True
        sr = self.soft_store.get_executor_soft_reservation(executor)
        if sr is not None:
            return sr.node, True
        return None, False

    def get_remaining_allowed_executor_count(
        self, app_id: str, namespace: str, *, unbound_count: int | None = None
    ) -> int:
        """`unbound_count` lets a caller that just scanned the unbound slots
        (reserve_executor_on_unbound) skip re-deriving them."""
        if unbound_count is None:
            unbound_count = len(self._get_unbound_reservations(app_id, namespace))
        return unbound_count + self._get_free_soft_reservation_spots(app_id, namespace)

    def reserve_executor_on_unbound(
        self, executor: Pod, node_names: list[str]
    ) -> tuple[Optional[str], int]:
        """The find-unbound + bind rungs fused into ONE unbound scan under
        the mutex (a split find -> re-scan -> bind pair would derive the
        active pod set twice per executor — the serving ladder's hot spot).
        Binds to the first OFFERED candidate (node_names order) holding an
        unbound slot, matching the split path's choice exactly
        (resource.go:389-400). Returns (bound node | None, unbound slot
        count); the count feeds get_remaining_allowed_executor_count."""
        with self._mutex:
            unbound = self._get_unbound_reservations(
                executor.labels.get(SPARK_APP_ID_LABEL, ""), executor.namespace
            )
            if unbound:
                nodes = set(unbound.values())
                chosen = next((n for n in node_names if n in nodes), None)
                if chosen is not None:
                    for res_name, res_node in unbound.items():
                        if res_node == chosen:
                            self._bind_executor_to_resource_reservation(
                                executor, res_name, chosen
                            )
                            return chosen, len(unbound)
            return None, len(unbound)

    def executor_ladder_batch(
        self, app_id: str, namespace: str, items: list[tuple[Pod, list[str]]]
    ) -> list[tuple[str, object]]:
        """Rungs 1-2 of the executor binding ladder for EVERY executor of
        one app in a serving window, in arrival order, under ONE mutex hold
        with one reservation fetch, one active-pod listing, and one cache
        write (the serial per-request ladder re-derived the active pod set
        and re-wrote the reservation once per executor — the serving path's
        host bottleneck at high executor arrival rates).

        `items` = [(executor_pod, offered_node_names)]. Returns one rung per
        executor, in order:
          ("already", node)      idempotent retry: bound (hard or soft) on an
                                 OFFERED node (resource.go:377-388)
          ("bound", node)        bound to an unbound slot on an offered node
                                 (resource.go:389-400)
          ("reschedule", had_unbound)
                                 a free spot exists and was pre-consumed from
                                 the working view; the caller solves the
                                 placement and applies the bind via
                                 reserve_for_executor_on_rescheduled_node
          ("dup-reschedule", None)
                                 duplicate submission of a pod already
                                 granted a reschedule in this batch — no
                                 second spot is consumed; the caller resolves
                                 it from the first occurrence's result (the
                                 serial path's rung 1 would return
                                 already-bound after the first bind applied)
          ("no-spots", None)     no unbound slots, no free soft spots

        Raises ReservationError when the app has no reservation or the
        batched cache write fails — the caller fails the app's whole batch
        failure-internal, as the solo rungs would.

        Documented deviation from strict arrival serialization: a
        reschedule's actual slot move (applied after the caller's grouped
        solve) picks from the then-committed unbound map, which can be a
        different — semantically equivalent — slot than a strict serial
        interleaving would have moved (any unbound slot satisfies the
        reservation; resourcereservations.go:202-225 itself picks
        arbitrarily)."""
        with self._mutex:
            rr = self.get_resource_reservation(app_id, namespace)
            if rr is None:
                raise ReservationError("failed to get resource reservations")
            active = self._get_active_pods(app_id, namespace)
            # Working views — binds made earlier in this batch must be
            # visible to later executors (duplicate submissions included).
            bound_by_pod: dict[str, str] = {}
            unbound: dict[str, str] = {}
            for res_name, res in rr.spec.reservations.items():
                pod_name = rr.status.pods.get(res_name)
                pod = active.get(pod_name) if pod_name is not None else None
                if (
                    pod_name is None
                    or pod is None
                    or (pod.node_name and pod.node_name != res.node)
                ):
                    unbound[res_name] = res.node
                if pod_name is not None:
                    bound_by_pod[pod_name] = res.node
            free_soft = self._get_free_soft_reservation_spots(app_id, namespace)
            binds: list[tuple[str, str, str]] = []  # (pod, slot, node)
            offered_sets: dict[int, frozenset] = {}
            resched_pods: set[str] = set()
            out: list[tuple[str, object]] = []
            for executor, node_names in items:
                offered = offered_sets.get(id(node_names))
                if offered is None:
                    offered = frozenset(node_names)
                    offered_sets[id(node_names)] = offered
                # Rung 1: already bound (hard slot or soft reservation).
                node = bound_by_pod.get(executor.name)
                if node is None:
                    sr = self.soft_store.get_executor_soft_reservation(executor)
                    if sr is not None:
                        node = sr.node
                if node is not None and node in offered:
                    out.append(("already", node))
                    continue
                # Bound but not offered falls through (resource.go:377-388).
                # Rung 2: first OFFERED candidate holding an unbound slot
                # (node_names order, matching the solo rung exactly).
                if unbound:
                    values = set(unbound.values())
                    chosen = next(
                        (n for n in node_names if n in values), None
                    )
                    if chosen is not None:
                        for res_name, res_node in unbound.items():
                            if res_node == chosen:
                                del unbound[res_name]
                                break
                        bound_by_pod[executor.name] = chosen
                        binds.append((executor.name, res_name, chosen))
                        out.append(("bound", chosen))
                        continue
                # Rung 3 classification: pre-consume a spot so later
                # executors of this window see the serialized budget. A
                # duplicate of a pod already granted a reschedule consumes
                # nothing (serially it would find itself already bound).
                if executor.name in resched_pods:
                    out.append(("dup-reschedule", None))
                    continue
                had_unbound = bool(unbound)
                if len(unbound) + free_soft > 0:
                    if unbound:
                        unbound.pop(next(iter(unbound)))
                    else:
                        free_soft -= 1
                    resched_pods.add(executor.name)
                    out.append(("reschedule", had_unbound))
                else:
                    out.append(("no-spots", None))
            if binds:
                updated = rr.copy()
                for pod_name, res_name, node in binds:
                    updated.spec.reservations[res_name].node = node
                    updated.status.pods[res_name] = pod_name
                if not self.rr_cache.update(updated):
                    raise ReservationError(
                        "failed to update resource reservation"
                    )
            return out

    def reserve_for_executor_on_rescheduled_node(
        self, executor: Pod, node: str
    ) -> None:
        """Bind to ANY unbound hard slot (moving it to `node`), else to a
        soft reservation (resourcereservations.go:202-225)."""
        with self._mutex:
            app_id = executor.labels.get(SPARK_APP_ID_LABEL, "")
            unbound = self._get_unbound_reservations(app_id, executor.namespace)
            if unbound:
                res_name = next(iter(unbound))
                self._bind_executor_to_resource_reservation(executor, res_name, node)
                return
            if self._get_free_soft_reservation_spots(app_id, executor.namespace) > 0:
                self._bind_executor_to_soft_reservation(executor, node)
                return
        raise ReservationError("failed to find free reservation for executor")

    # -- compaction ---------------------------------------------------------

    def compact_dynamic_allocation_applications(self) -> None:
        """Migrate soft reservations of live executors into freed hard slots
        (resourcereservations.go:238-268). Apps are queued by the executor
        pod-deletion handler and drained here, on the request path.

        One unbound-slot derivation and ONE reservation write per app: the
        per-pod form re-derived the active pod set and re-wrote the
        reservation once per soft executor — O(slots x pods) per
        compaction pass, a measured host cost at high dynamic-allocation
        churn. Slot choice per pod is unchanged (prefer a slot already on
        the pod's node, else the first unbound slot,
        resourcereservations.go:283-301); a consumed slot is not re-offered
        within the pass even when the bind leaves it node-mismatched —
        semantically equivalent, the same deviation contract as
        executor_ladder_batch (any unbound slot satisfies the reservation;
        the reference itself picks arbitrarily)."""
        with self._compaction_lock:
            drained, self._compaction_apps = self._compaction_apps, {}
        with self._mutex:
            for app_id, namespace in drained.items():
                sr, ok = self.soft_store.get_soft_reservation(app_id)
                if not ok:
                    continue
                pods = self._get_active_pods(app_id, namespace)
                live = [
                    pods[name] for name in sr.reservations if name in pods
                ]
                if not live:
                    continue
                self._compact_app(app_id, live, pods)

    def _compact_app(
        self, app_id: str, pods: list[Pod], active: dict[str, Pod]
    ) -> None:
        """`active` is the app's already-derived active-pod map — the
        caller pays that walk exactly once per compacted app."""
        if not pods:
            return
        namespace = pods[0].namespace
        rr = self.get_resource_reservation(app_id, namespace)
        if rr is None:
            return
        unbound = self._unbound_of(rr, active)
        if not unbound:
            return
        binds: list[tuple[Pod, str, str]] = []  # (pod, slot, node)
        for pod in pods:
            if not unbound:
                break
            res_name = next(
                (
                    name
                    for name, node in unbound.items()
                    if node == pod.node_name
                ),
                None,
            )
            if res_name is None:
                res_name = next(iter(unbound))
            binds.append((pod, res_name, unbound.pop(res_name)))
        if not binds:
            return
        updated = rr.copy()
        for pod, res_name, node in binds:
            updated.spec.reservations[res_name].node = node
            updated.status.pods[res_name] = pod.name
        if not self.rr_cache.update(updated):
            raise ReservationError("failed to update resource reservation")
        for pod, _res_name, _node in binds:
            self.soft_store.remove_executor_reservation(app_id, pod.name)

    # -- internals ----------------------------------------------------------

    def _bind_executor_to_resource_reservation(
        self, executor: Pod, reservation_name: str, node: str
    ) -> None:
        rr = self.get_resource_reservation(
            executor.labels.get(SPARK_APP_ID_LABEL, ""), executor.namespace
        )
        if rr is None:
            raise ReservationError(
                f"failed to get resource reservation {reservation_name}"
            )
        updated = rr.copy()
        res = updated.spec.reservations[reservation_name]
        res.node = node
        updated.status.pods[reservation_name] = executor.name
        if not self.rr_cache.update(updated):
            raise ReservationError(
                f"failed to update resource reservation {reservation_name}"
            )

    def _bind_executor_to_soft_reservation(self, executor: Pod, node: str) -> None:
        driver = self.pod_lister.get_driver_for_executor(executor)
        if driver is None:
            raise ReservationError("failed to get driver pod for executor")
        app_resources = spark_resources(driver)
        self.soft_store.add_reservation_for_pod(
            driver.labels.get(SPARK_APP_ID_LABEL, ""),
            executor.name,
            Reservation(node, app_resources.executor_resources.copy()),
        )

    @staticmethod
    def _unbound_of(rr: ResourceReservation, active: dict[str, Pod]) -> dict[str, str]:
        """Slots not bound to an active pod, bound to a dead pod, or bound to
        a pod that landed on a different node (resourcereservations.go:358-380),
        over an already-derived active-pod map."""
        unbound: dict[str, str] = {}
        for res_name, res in rr.spec.reservations.items():
            pod_name = rr.status.pods.get(res_name)
            pod = active.get(pod_name) if pod_name is not None else None
            if (
                pod_name is None
                or pod is None
                or (pod.node_name and pod.node_name != res.node)
            ):
                unbound[res_name] = res.node
        return unbound

    def _get_unbound_reservations(self, app_id: str, namespace: str) -> dict[str, str]:
        rr = self.get_resource_reservation(app_id, namespace)
        if rr is None:
            raise ReservationError("failed to get resource reservation")
        return self._unbound_of(rr, self._get_active_pods(app_id, namespace))

    def _get_free_soft_reservation_spots(self, app_id: str, namespace: str) -> int:
        sr, ok = self.soft_store.get_soft_reservation(app_id)
        if not ok:
            return 0
        used = len(sr.reservations)
        driver = self.pod_lister.get_driver_pod(app_id, namespace)
        if driver is None:
            return 0
        app_resources = spark_resources(driver)
        allowed = app_resources.max_executor_count - app_resources.min_executor_count
        return max(allowed - used, 0)

    def _get_active_pods(self, app_id: str, namespace: str) -> dict[str, Pod]:
        return {
            p.name: p
            for p in self.pod_lister.list_app_pods(app_id, namespace)
            if not p.is_terminated()
        }

    def _on_executor_pod_deletion(self, pod: Pod) -> None:
        if not is_spark_scheduler_executor_pod(pod):
            return
        _, has_app = self.soft_store.get_soft_reservation(
            pod.labels.get(SPARK_APP_ID_LABEL, "")
        )
        if has_app and not self.soft_store.executor_has_soft_reservation(pod):
            with self._compaction_lock:
                self._compaction_apps[pod.labels.get(SPARK_APP_ID_LABEL, "")] = (
                    pod.namespace
                )
