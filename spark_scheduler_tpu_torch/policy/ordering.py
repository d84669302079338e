"""Window-ordering strategies: FIFO (reference), priority-then-FIFO, DRF.

The extender consults ONE hook per driver request — `blockers(pod, group,
parsed_pending, now)` — to decide which pending gangs are ahead of it in
the queue. The contract mirrors the reference's FIFO predecessor scan
(sparkpods.go:51-77): same-instance-group blockers become capacity rows
packed ahead of the driver in the same window solve, so ordering and
feasibility are decided by one device program. Cross-instance-group
ordering (DRF) cannot ride capacity rows — instance-group domains are
disjoint node sets — so it surfaces as a *hard block*: the driver yields
this round with FAILURE_EARLIER_DRIVER and retries, exactly how
kube-scheduler treats any other queueing denial.

DRF (Ghodsi et al., NSDI '11): a gang's instance group is charged the sum
of its hard reservations (soft/speculative executor slots deliberately
excluded — they are reclaimable and would let opportunistic bursts distort
fairness); dominant share = max over resource dimensions of group usage /
cluster capacity; the queue admits smallest dominant share first.
`GroupUsageAggregates` maintains the per-group totals event-driven off the
reservation cache and node feed (the `core/zone_aggregates.py` pattern) —
no per-request walks.

The port's copy of spark_scheduler_tpu/policy/ordering.py, a
BatchableListener on the port's store/cache.py.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from spark_scheduler_tpu_torch.core.sparkpods import SparkPodLister
from spark_scheduler_tpu_torch.models.resources import NUM_DIMS
from spark_scheduler_tpu_torch.policy.priority import effective_priority, pod_priority
from spark_scheduler_tpu_torch.store.cache import BatchableListener

_UNKNOWN_GROUP = ""


class GroupUsageAggregates:
    """Per-instance-group reserved usage + cluster capacity, delta-maintained.

    Same listener discipline as ReservedUsageTracker (core/usage_tracker.py):
    the reservation cache owner is the sole writer, so every hard-reservation
    change flows through the mutation listener; node capacity follows the
    backend's node feed. `rebuild()` is the from-scratch oracle the
    consistency test diffs against."""

    def __init__(self, backend, rr_cache, pod_lister: SparkPodLister):
        self._pod_lister = pod_lister
        self._backend = backend
        self._rr_cache = rr_cache
        self._lock = threading.Lock()
        self._usage: dict[str, np.ndarray] = {}
        self._capacity = np.zeros(NUM_DIMS, dtype=np.int64)
        # app (ns, name) -> instance group, pinned at reservation create so
        # the debit on delete matches the credit even after the driver pod
        # (the group's source of truth) is gone.
        self._group_of_app: dict[tuple[str, str], str] = {}
        backend.subscribe(
            "nodes",
            on_add=self._on_node_add,
            on_update=self._on_node_update,
            on_delete=self._on_node_delete,
        )
        rr_cache.add_mutation_listener(
            BatchableListener(self._on_rr_mutation, self._on_rr_mutation_batch)
        )
        self.rebuild()

    # -- queries -------------------------------------------------------------

    def dominant_share(self, group: Optional[str]) -> float:
        """max over dimensions of group usage / cluster capacity, in [0, 1]
        (0.0 for unseen groups or an empty cluster)."""
        key = group if group is not None else _UNKNOWN_GROUP
        with self._lock:
            u = self._usage.get(key)
            if u is None:
                return 0.0
            share = 0.0
            for d in range(NUM_DIMS):
                cap = int(self._capacity[d])
                if cap > 0:
                    share = max(share, int(u[d]) / cap)
            return share

    def snapshot(self) -> dict[str, tuple[int, ...]]:
        """{group: usage tuple} — for tests and the stats endpoint."""
        with self._lock:
            return {g: tuple(int(x) for x in u) for g, u in self._usage.items()}

    # -- maintenance ---------------------------------------------------------

    def rebuild(self) -> None:
        with self._lock:
            self._usage = {}
            self._capacity = np.zeros(NUM_DIMS, dtype=np.int64)
            for node in self._backend.list_nodes():
                self._capacity += node.allocatable.as_array().astype(np.int64)
            for rr in self._rr_cache.list():
                self._apply_rr(None, rr)

    def _group_of(self, rr) -> str:
        key = (rr.namespace, rr.name)
        group = self._group_of_app.get(key)
        if group is None:
            driver = self._pod_lister.get_driver_pod(rr.name, rr.namespace)
            if driver is not None:
                from spark_scheduler_tpu_torch.core.sparkpods import find_instance_group

                group = find_instance_group(
                    driver, self._pod_lister.instance_group_label
                ) or _UNKNOWN_GROUP
            else:
                group = _UNKNOWN_GROUP
            self._group_of_app[key] = group
        return group

    @staticmethod
    def _rr_usage(rr) -> np.ndarray:
        total = np.zeros(NUM_DIMS, dtype=np.int64)
        for res in rr.spec.reservations.values():
            total += res.resources.as_array().astype(np.int64)
        return total

    def _apply_rr(self, old, new) -> None:
        """Caller holds the lock. O(slots of the touched app)."""
        if (
            old is not None
            and new is not None
            and old.spec.reservations == new.spec.reservations
        ):
            return  # status-only update (executor binding)
        rr = new if new is not None else old
        group = self._group_of(rr)
        bucket = self._usage.setdefault(group, np.zeros(NUM_DIMS, dtype=np.int64))
        if old is not None:
            bucket -= self._rr_usage(old)
        if new is not None:
            bucket += self._rr_usage(new)
        if new is None:
            self._group_of_app.pop((rr.namespace, rr.name), None)

    # -- listeners -----------------------------------------------------------

    def _on_rr_mutation(self, old, new) -> None:
        with self._lock:
            self._apply_rr(old, new)

    def _on_rr_mutation_batch(self, pairs) -> None:
        with self._lock:
            for old, new in pairs:
                self._apply_rr(old, new)

    def _on_node_add(self, node) -> None:
        with self._lock:
            self._capacity += node.allocatable.as_array().astype(np.int64)

    def _on_node_update(self, old, new) -> None:
        with self._lock:
            self._capacity += new.allocatable.as_array().astype(np.int64)
            self._capacity -= old.allocatable.as_array().astype(np.int64)

    def _on_node_delete(self, node) -> None:
        with self._lock:
            self._capacity -= node.allocatable.as_array().astype(np.int64)


# ---------------------------------------------------------------------------
# Ordering strategies.
# ---------------------------------------------------------------------------


def _is_same_pod(a, b) -> bool:
    return a.namespace == b.namespace and a.name == b.name


class FifoOrdering:
    """The reference ordering, bit-for-bit: same-group strictly-earlier
    drivers block, in snapshot (oldest-first) order."""

    name = "fifo"

    def blockers(self, pod, group, parsed_pending, now):
        rows = [
            t
            for t in parsed_pending
            if SparkPodLister.is_earlier_driver(t[0], t[1], pod, group)
        ]
        return rows, False


class PriorityOrdering:
    """Priority-then-FIFO with age-based anti-starvation promotion: a
    same-group pending gang is ahead when its effective (age-promoted)
    priority is higher, or equal and it is older. Ordering among blockers is
    (effective priority desc, creation asc) — the order they would admit."""

    name = "priority"

    def __init__(self, promote_after_s: float):
        self.promote_after_s = promote_after_s

    def _effective(self, pod, now: float) -> int:
        return effective_priority(
            pod_priority(pod), now - pod.creation_timestamp, self.promote_after_s
        )

    def blockers(self, pod, group, parsed_pending, now):
        mine = self._effective(pod, now)
        ahead: list[tuple[int, tuple]] = []
        for t in parsed_pending:
            ed, ed_group = t[0], t[1]
            if (
                ed_group != group
                or ed.scheduler_name != pod.scheduler_name
                or _is_same_pod(ed, pod)
            ):
                continue
            ep = self._effective(ed, now)
            if ep > mine or (
                ep == mine and ed.creation_timestamp < pod.creation_timestamp
            ):
                ahead.append((ep, t))
        # Stable sort: equal keys keep the snapshot's oldest-first order.
        ahead.sort(key=lambda e: (-e[0], e[1][0].creation_timestamp))
        return [t for _, t in ahead], False


class DrfOrdering:
    """Smallest-dominant-share-first across instance groups; FIFO within a
    group. A pending gang of another group with a strictly smaller dominant
    share hard-blocks this driver (disjoint domains — capacity rows cannot
    express the yield); the age gate (`skip` flag, resource.go:260-270
    semantics) keeps too-young gangs from enforcing the yield, which bounds
    cross-group waiting exactly like FIFO's enforcement delay."""

    name = "drf"

    def __init__(self, shares: GroupUsageAggregates):
        self.shares = shares

    def blockers(self, pod, group, parsed_pending, now):
        rows = [
            t
            for t in parsed_pending
            if SparkPodLister.is_earlier_driver(t[0], t[1], pod, group)
        ]
        my_share = self.shares.dominant_share(group)
        share_of: dict = {}
        hard = False
        for t in parsed_pending:
            ed, ed_group, _res, ed_skip = t
            if (
                ed_group == group
                or ed_skip
                or ed.scheduler_name != pod.scheduler_name
                or _is_same_pod(ed, pod)
            ):
                continue
            if ed_group not in share_of:
                share_of[ed_group] = self.shares.dominant_share(ed_group)
            if share_of[ed_group] < my_share:
                hard = True
                break
        return rows, hard


ORDERING_STRATEGIES = ("fifo", "priority", "drf")
