"""Failover reconciliation — rebuild durable state from observed pods.

Rebuilds internal/extender/failover.go:35-432. Reservation writes are async
and fire-and-forget, so a leader change can lose writes; before serving, the
new leader walks every scheduled spark pod that has no claimed reservation
slot and (a) patches existing reservations to re-claim executors, (b)
constructs new reservations for stale drivers (greedily reserving nodes for
min-executors not yet seen), (c) rebuilds the in-memory soft-reservation
store, and (d) deletes demands of now-scheduled pods.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from spark_scheduler_tpu_torch.models.kube import Node, Pod
from spark_scheduler_tpu_torch.models.reservations import (
    Reservation,
    executor_reservation_name,
    new_resource_reservation,
)
from spark_scheduler_tpu_torch.models.resources import Resources
from spark_scheduler_tpu_torch.core.sparkpods import (
    ROLE_DRIVER,
    ROLE_EXECUTOR,
    SPARK_APP_ID_LABEL,
    SPARK_ROLE_LABEL,
    SPARK_SCHEDULER_NAME,
    SparkPodError,
    find_instance_group,
    spark_resources,
)


@dataclasses.dataclass
class _StaleAppPods:
    """sparkPods (failover.go:75-83): one app's unclaimed scheduled pods."""

    app_id: str
    inconsistent_driver: Optional[Pod] = None
    inconsistent_executors: list[Pod] = dataclasses.field(default_factory=list)


class FailoverReconciler:
    def __init__(
        self,
        backend,
        pod_lister,
        rr_cache,
        soft_store,
        demand_manager,
        overhead_computer,
        instance_group_label: str,
    ):
        self._backend = backend
        self._pod_lister = pod_lister
        self._rr_cache = rr_cache
        self._soft_store = soft_store
        self._demands = demand_manager
        self._overhead = overhead_computer
        self._instance_group_label = instance_group_label
        # Mutation counters of the pass in flight (see the sync method).
        self._summary: dict[str, int] = {}

    # ------------------------------------------------------------------ API

    def sync_resource_reservations_and_demands(self) -> dict:
        """One reconciliation pass. Returns a mutation summary
        ({stale_apps, created, patched, soft_added}) — all zeros on a
        repeat pass over unchanged state: reconciliation is IDEMPOTENT
        (re-claimed pods leave the stale set, create-or-update converges,
        soft-shell creation is if-not-exists), which is what lets two
        racing replicas both run it without duplicating reservations
        (pinned by tests/test_ha.py)."""
        self._summary = {
            "stale_apps": 0, "created": 0, "patched": 0, "soft_added": 0,
        }
        pods = self._backend.list_pods()
        rrs = self._rr_cache.list()
        stale = self._unreserved_spark_pods(rrs, pods)
        self._summary["stale_apps"] = len(stale)

        if stale:
            # The per-group availability map (an O(nodes) walk of Resources
            # copies) exists only to greedily place stale drivers' missing
            # executors — build it lazily. The common pass (HA promotion
            # over tailed-warm state, the gap-heuristic resync on a healthy
            # leader) has ZERO stale apps and stays O(pods + reservations),
            # which is what makes warm promotion fast at 100k nodes.
            nodes = self._backend.list_nodes()
            overhead = self._overhead.get_overhead(nodes)
            soft_usage = self._soft_store.used_soft_reservation_resources()
            available, ordered_nodes = self._available_per_instance_group(
                rrs, nodes, overhead, soft_usage
            )
        extra_executors_by_app: dict[str, list[Pod]] = {}
        for sp in stale.values():
            extras = self._sync_resource_reservations(sp, available, ordered_nodes)
            if extras:
                extra_executors_by_app[sp.app_id] = extras
            self._sync_demands(sp)
        self._sync_soft_reservations(extra_executors_by_app)
        return dict(self._summary)

    # ----------------------------------------------------------- inventory

    def _unreserved_spark_pods(self, rrs, pods) -> dict[str, _StaleAppPods]:
        """Scheduled spark pods claimed by no reservation, grouped by app
        (failover.go:233-270).

        Documented deviation: TERMINATED pods are skipped. The reference's
        filter (failover.go:272-274) checks only scheduler/deletion/node,
        so until a dead executor's object is deleted it would re-claim a
        slot or re-add a soft reservation for the corpse — over-committing
        the node against the live pods that replaced it (caught by the
        invariant soak). Terminated pods free their resources; reconciling
        them back is never right."""
        claimed = set()
        for rr in rrs:
            claimed.update(rr.status.pods.values())
        out: dict[str, _StaleAppPods] = {}
        for pod in pods:
            if (
                pod.scheduler_name != SPARK_SCHEDULER_NAME
                or pod.deletion_timestamp is not None
                or pod.is_terminated()
                or not pod.node_name
                or pod.name in claimed
            ):
                continue
            role = pod.labels.get(SPARK_ROLE_LABEL)
            if role == ROLE_EXECUTOR and self._soft_store.executor_has_soft_reservation(pod):
                continue
            app_id = pod.labels.get(SPARK_APP_ID_LABEL, "")
            sp = out.setdefault(app_id, _StaleAppPods(app_id=app_id))
            if role == ROLE_DRIVER:
                sp.inconsistent_driver = pod
            elif role == ROLE_EXECUTOR:
                sp.inconsistent_executors.append(pod)
        return out

    def _available_per_instance_group(
        self, rrs, nodes: list[Node], overhead, soft_usage
    ) -> tuple[dict[str, dict[str, Resources]], dict[str, list[Node]]]:
        """Schedulable+ready nodes grouped by instance group, newest first;
        available = allocatable - reservations - overhead - soft usage
        (failover.go:276-313)."""
        nodes = sorted(nodes, key=lambda n: n.creation_timestamp, reverse=True)
        grouped: dict[str, list[Node]] = {}
        for n in nodes:
            if n.unschedulable or not n.ready:
                continue
            grouped.setdefault(n.labels.get(self._instance_group_label, ""), []).append(n)

        usage: dict[str, Resources] = {}
        for rr in rrs:
            for res in rr.spec.reservations.values():
                usage.setdefault(res.node, Resources.zero()).add(res.resources)
        for source in (overhead, soft_usage):
            for node_name, res in source.items():
                usage.setdefault(node_name, Resources.zero()).add(res)

        available: dict[str, dict[str, Resources]] = {}
        for group, ns in grouped.items():
            available[group] = {
                n.name: n.allocatable.copy().sub(usage.get(n.name, Resources.zero()))
                for n in ns
            }
        return available, grouped

    # ------------------------------------------------------- reservations

    def _sync_resource_reservations(
        self, sp: _StaleAppPods, available, ordered_nodes
    ) -> list[Pod]:
        """Returns executors that still have no hard slot (soft candidates)
        (failover.go:95-155)."""
        if sp.inconsistent_driver is None and sp.inconsistent_executors:
            exec0 = sp.inconsistent_executors[0]
            rr = self._rr_cache.get(exec0.namespace, sp.app_id)
            if rr is None:
                return []
            new_rr = self._patch_resource_reservation(sp.inconsistent_executors, rr.copy())
            if new_rr is None:
                return []
            self._summary["patched"] = self._summary.get("patched", 0) + 1
            claimed = set(new_rr.status.pods.values())
            return [e for e in sp.inconsistent_executors if e.name not in claimed]

        if sp.inconsistent_driver is not None:
            driver = sp.inconsistent_driver
            try:
                app_resources = spark_resources(driver)
            except SparkPodError:
                return []
            group = find_instance_group(driver, self._instance_group_label) or ""
            end = min(len(sp.inconsistent_executors), app_resources.min_executor_count)
            up_to_min = sp.inconsistent_executors[:end]
            extras = sp.inconsistent_executors[end:]

            group_nodes = ordered_nodes.get(group)
            group_avail = available.get(group)
            if group_nodes is None or group_avail is None:
                return []

            to_assign = app_resources.min_executor_count - len(up_to_min)
            reserved_names: list[str] = []
            reserved_usage: dict[str, Resources] = {}
            if to_assign > 0:
                reserved_names, reserved_usage = _find_nodes(
                    to_assign,
                    app_resources.executor_resources,
                    group_avail,
                    group_nodes,
                )
            executor_nodes = [e.node_name for e in up_to_min] + reserved_names
            rr = new_resource_reservation(
                driver.node_name,
                executor_nodes,
                driver,
                app_resources.driver_resources,
                app_resources.executor_resources,
            )
            for i, e in enumerate(up_to_min):
                rr.status.pods[executor_reservation_name(i)] = e.name
            if not self._rr_cache.create(rr):
                # already exists -> force update (failover.go:141-150)
                existing = self._rr_cache.get(rr.namespace, rr.name)
                if existing is not None:
                    rr.resource_version = existing.resource_version
                if not self._rr_cache.update(rr):
                    return []
            self._summary["created"] = self._summary.get("created", 0) + 1
            for node_name, res in reserved_usage.items():
                if node_name in group_avail:
                    group_avail[node_name].sub(res)
            return extras
        return []

    def _patch_resource_reservation(self, execs: list[Pod], rr):
        """Re-claim reservation slots on each executor's node when the slot
        is unclaimed or its pod is gone/dead (failover.go:316-336)."""
        for e in execs:
            for name, reservation in rr.spec.reservations.items():
                if reservation.node != e.node_name:
                    continue
                current = rr.status.pods.get(name)
                if current is None:
                    rr.status.pods[name] = e.name
                    break
                pod = self._backend.get("pods", e.namespace, current)
                if pod is None or pod.is_terminated():
                    rr.status.pods[name] = e.name
                    break
        if not self._rr_cache.update(rr):
            return None
        return rr

    # ------------------------------------------------------------- demands

    def _sync_demands(self, sp: _StaleAppPods) -> None:
        if sp.inconsistent_driver is not None:
            self._demands.delete_demand_if_exists(sp.inconsistent_driver, "Reconciler")
        for e in sp.inconsistent_executors:
            self._demands.delete_demand_if_exists(e, "Reconciler")

    # ---------------------------------------------------- soft reservations

    def _sync_soft_reservations(self, extras_by_app: dict[str, list[Pod]]) -> None:
        """(failover.go:164-231): recreate app shells for all running
        dynamic-allocation drivers, then re-add extra-executor reservations
        up to max-min."""
        for d in self._backend.list_pods(labels={SPARK_ROLE_LABEL: ROLE_DRIVER}):
            if (
                d.scheduler_name != SPARK_SCHEDULER_NAME
                or not d.node_name
                or d.phase in ("Succeeded", "Failed")
            ):
                continue
            try:
                app_resources = spark_resources(d)
            except SparkPodError:
                continue
            if app_resources.max_executor_count > app_resources.min_executor_count:
                self._soft_store.create_soft_reservation_if_not_exists(
                    d.labels.get(SPARK_APP_ID_LABEL, "")
                )

        for app_id, extras in extras_by_app.items():
            driver = self._pod_lister.get_driver_for_executor(extras[0])
            if driver is None:
                continue
            try:
                app_resources = spark_resources(driver)
            except SparkPodError:
                continue
            allowed = app_resources.max_executor_count - app_resources.min_executor_count
            for i, extra in enumerate(extras):
                if i >= allowed:
                    break
                try:
                    self._soft_store.add_reservation_for_pod(
                        app_id,
                        extra.name,
                        Reservation(
                            extra.node_name, app_resources.executor_resources.copy()
                        ),
                    )
                    self._summary["soft_added"] = (
                        self._summary.get("soft_added", 0) + 1
                    )
                except KeyError:
                    pass  # app shell missing (not dynamic-allocation) — skip


def _find_nodes(
    executor_count: int,
    executor_resources: Resources,
    available: dict[str, Resources],
    ordered_nodes: list[Node],
) -> tuple[list[str], dict[str, Resources]]:
    """Greedy fallback packer for reconciliation (failover.go:402-426):
    fill newest-first schedulable nodes; may return fewer than requested."""
    names: list[str] = []
    reserved: dict[str, Resources] = {}
    for n in ordered_nodes:
        res = reserved.setdefault(n.name, Resources.zero())
        avail = available.get(n.name, Resources.zero())
        while True:
            res.add(executor_resources)
            if res.greater_than(avail):
                res.sub(executor_resources)
                break
            names.append(n.name)
            if len(names) == executor_count:
                return names, reserved
    return names, reserved
