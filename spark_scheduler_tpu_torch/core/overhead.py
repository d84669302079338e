"""Overhead accounting: resource requests of pods outside our reservations.

Rebuilds internal/extender/overhead.go:32-209 — overhead(node) = requests of
pods on the node that have no hard or soft reservation; non-schedulable
overhead additionally counts only pods of OTHER schedulers.

Documented deviation: TERMINATED pods contribute nothing. The reference
keeps counting a terminated pod's requests until the pod object is deleted
(overhead.go:163-174 tracks by pod event, never checks the phase), but
kube-scheduler itself releases Succeeded/Failed pods' resources — counting
them both under-reports capacity and double-counts a dead executor whose
freed slot has been re-bound (reservation usage for the new holder + the
corpse's requests as overhead). The invariant soak caught exactly that
double-count (tests/test_invariant_soak.py).

The reference recomputes membership per node at query time (overhead.go:
120-168, an O(pods-on-node) walk with a cache lookup per pod). This rebuild
maintains the aggregates INCREMENTALLY, because at the 10k-node x 1k-app
target the per-request walk is the latency floor (SURVEY.md §7):

  total[node]     = sum of requests of pods bound to the node
  reserved[node]  = sum of requests of bound pods that HAVE a reservation
  overhead(node)  = total - reserved
  nonsched[node]  = sum of requests of unreserved pods of other schedulers

Membership of a pod changes only on: pod add/update/delete (backend watch),
its app's ResourceReservation changing (rr-cache mutation listener), or its
app's soft reservations changing (soft-store membership listener) — each
triggers an O(pods-of-one-app) recompute, never a full-cluster walk. The
from-scratch oracle (`compute_node_overhead_oracle`) stays for tests.
"""

from __future__ import annotations

import threading

import numpy as np

from spark_scheduler_tpu_torch.models.kube import Pod
from spark_scheduler_tpu_torch.models.resources import (
    NUM_DIMS,
    FrozenResources,
    Resources,
)
from spark_scheduler_tpu_torch.core.dirty_feed import DirtyRowFeed
from spark_scheduler_tpu_torch.core.sparkpods import SPARK_SCHEDULER_NAME
from spark_scheduler_tpu_torch.store.cache import BatchableListener


class _PodState:
    __slots__ = ("node", "requests", "counted_overhead", "counted_nonsched")

    def __init__(self, node: str, requests: Resources):
        self.node = node
        self.requests = requests
        self.counted_overhead = False
        self.counted_nonsched = False


class OverheadComputer:
    def __init__(self, backend, reservation_manager):
        self._backend = backend
        self._rrm = reservation_manager
        self._lock = threading.RLock()
        self._pods: dict[tuple[str, str], _PodState] = {}  # (ns, name) -> state
        self._on_node: dict[str, int] = {}  # node name -> pods tracked there
        self._by_name: dict[str, set[tuple[str, str]]] = {}  # name -> keys
        self._overhead: dict[str, Resources] = {}
        self._nonsched: dict[str, Resources] = {}
        # Frozen per-node views handed out by the query methods, memoized
        # until that node's aggregate next changes — the old
        # copy-every-Resources-under-the-lock walk was a measured per-call
        # cost at 10k nodes, and no caller ever mutated the copies.
        self._frozen: dict[int, dict[str, FrozenResources]] = {
            id(self._overhead): {},
            id(self._nonsched): {},
        }
        # Optional dense [cap, 3] int64 mirror of the schedulable-overhead
        # aggregate over a NodeRegistry's index space (attach_registry) —
        # the HostFeatureStore's zero-walk feed. `overhead_version` bumps on
        # every applied overhead delta so snapshots can key on it.
        self._registry = None
        self._dense: np.ndarray | None = None
        self.overhead_version = 0
        # Dirty-row feed for the HostFeatureStore's resident overhead
        # master: rows the dense mirror changed since the last
        # drain, so the store patches O(changed) instead of copying the
        # whole [cap, 3] array (core/dirty_feed.py — the drain protocol
        # shared with the usage tracker).
        self._dirty = DirtyRowFeed()
        # Instrumentation: per-event membership recomputes (delta evidence).
        self.recomputes = 0
        backend.subscribe(
            "pods",
            on_add=self._on_pod_add,
            on_update=self._on_pod_update,
            on_delete=self._on_pod_delete,
        )
        # Reservation-membership feeds: an app's RR or soft reservations
        # changing flips its pods between overhead and reserved. Batch-aware
        # so a serving window's coalesced reservation write-back recomputes
        # under one lock hold.
        reservation_manager.rr_cache.add_mutation_listener(
            BatchableListener(self._on_rr_mutation, self._on_rr_mutation_batch)
        )
        if hasattr(reservation_manager.soft_store, "add_membership_listener"):
            reservation_manager.soft_store.add_membership_listener(
                self._on_soft_membership
            )
        for pod in backend.list_pods():
            self._on_pod_add(pod)

    # -- event handlers ------------------------------------------------------

    def _on_pod_add(self, pod: Pod) -> None:
        if not pod.node_name:
            return
        self._recompute(pod.namespace, pod.name)

    def _on_pod_update(self, old: Pod, new: Pod) -> None:
        # Catches the unbound->bound transition and node moves; membership is
        # re-evaluated from current state either way.
        if old.node_name or new.node_name:
            self._recompute(new.namespace, new.name)

    def _on_pod_delete(self, pod: Pod) -> None:
        self._recompute(pod.namespace, pod.name)

    @staticmethod
    def _rr_flipped_pods(old, new) -> set[tuple[str, str]]:
        """Pods whose Status.Pods membership actually flipped: only those
        can change overhead membership, so recompute the symmetric
        difference (one pod per executor bind), not the union — a union
        walk would make binding executor k of an n-gang O(k·n) and the
        whole gang O(n³) via pod_has_reservation's slot scan."""
        old_pods = set((old.namespace, p) for p in old.status.pods.values()) if old else set()
        new_pods = set((new.namespace, p) for p in new.status.pods.values()) if new else set()
        return old_pods.symmetric_difference(new_pods)

    def _on_rr_mutation(self, old, new) -> None:
        for ns, name in self._rr_flipped_pods(old, new):
            self._recompute(ns, name)

    def _on_rr_mutation_batch(self, pairs) -> None:
        """A whole serving window's reservation commits as one batched
        membership update: union of per-pair flips, recomputed under a
        single (reentrant) lock hold."""
        flipped: set[tuple[str, str]] = set()
        for old, new in pairs:
            flipped |= self._rr_flipped_pods(old, new)
        if not flipped:
            return
        with self._lock:
            for ns, name in flipped:
                self._recompute(ns, name)

    def _on_soft_membership(self, app_id: str, pod_name: str) -> None:
        """A soft reservation was added/removed for an executor. Namespace is
        not carried by the soft store; recompute every tracked pod with that
        name (pod names are unique per namespace; collisions across
        namespaces just cause a redundant recompute)."""
        with self._lock:
            keys = list(self._by_name.get(pod_name, ()))
        for ns, name in keys:
            self._recompute(ns, name)
        # The pod may not be tracked yet (soft reservation granted during
        # admission, before binding) — recompute on add covers that case.

    # -- membership ----------------------------------------------------------

    def _recompute(self, namespace: str, name: str) -> None:
        """Re-evaluate one pod's contribution to the aggregates. The backend
        read happens INSIDE the lock so two racing recomputes of the same pod
        can't apply a stale read after a delete retracted it."""
        with self._lock:
            pod = self._backend.get("pods", namespace, name)
            self.recomputes += 1
            key = (namespace, name)
            state = self._pods.get(key)
            # Retract the old contribution.
            if state is not None:
                if state.counted_overhead:
                    self._sub(self._overhead, state.node, state.requests)
                if state.counted_nonsched:
                    self._sub(self._nonsched, state.node, state.requests)
                del self._pods[key]
                left = self._on_node[state.node] - 1
                if left:
                    self._on_node[state.node] = left
                else:
                    del self._on_node[state.node]
                peers = self._by_name.get(name)
                if peers is not None:
                    peers.discard(key)
                    if not peers:
                        del self._by_name[name]
            if pod is None or not pod.node_name or pod.is_terminated():
                return  # terminated pods free their resources (see module doc)
            state = _PodState(pod.node_name, pod.request())
            unreserved = not self._rrm.pod_has_reservation(pod)
            if unreserved:
                state.counted_overhead = True
                self._add(self._overhead, state.node, state.requests)
                if pod.scheduler_name != SPARK_SCHEDULER_NAME:
                    state.counted_nonsched = True
                    self._add(self._nonsched, state.node, state.requests)
            self._pods[key] = state
            self._on_node[state.node] = self._on_node.get(state.node, 0) + 1
            self._by_name.setdefault(name, set()).add(key)

    def _add(self, agg: dict[str, Resources], node: str, res: Resources) -> None:
        agg.setdefault(node, Resources.zero()).add(res)
        self._on_agg_delta(agg, node, res, +1)

    def _sub(self, agg: dict[str, Resources], node: str, res: Resources) -> None:
        cur = agg.get(node)
        if cur is not None:
            cur.sub(res)
            if cur.is_zero():
                del agg[node]
            self._on_agg_delta(agg, node, res, -1)

    def _on_agg_delta(self, agg, node: str, res: Resources, sign: int) -> None:
        """One applied aggregate delta (caller holds the lock): invalidate
        the node's frozen view and scatter into the dense mirror."""
        self._frozen[id(agg)].pop(node, None)
        if agg is self._overhead:
            self.overhead_version += 1
            if self._dense is not None:
                idx = self._registry.intern(node)
                if idx >= self._dense.shape[0]:
                    grow = max(idx + 1, self._dense.shape[0] * 2, 8)
                    self._dense = np.pad(
                        self._dense, ((0, grow - self._dense.shape[0]), (0, 0))
                    )
                self._dense[idx] += sign * res.as_array().astype(np.int64)
                self._dirty.note(idx)

    # -- dense feed (HostFeatureStore) ---------------------------------------

    def holds_node(self, node: str) -> bool:
        """Whether a tracked pod (bound, not terminated, reserved or not)
        is bound to `node`: its requests key on the name, so the name's
        registry row must not be recycled under it."""
        return node in self._on_node

    def attach_registry(self, registry) -> None:
        """Start maintaining the dense [cap, 3] int64 overhead mirror over
        `registry`'s node-index space, and hold the rows of names that
        pods are still bound to (`NodeRegistry.row_holder`; the JAX
        package recycles them). Idempotent; rebuilt from the current
        aggregate on (re)attach."""
        registry.row_holder = self.holds_node
        with self._lock:
            if self._registry is registry and self._dense is not None:
                return
            self._registry = registry
            dense = np.zeros((max(registry.capacity, 1), NUM_DIMS), np.int64)
            for node, res in self._overhead.items():
                idx = registry.intern(node)
                if idx >= dense.shape[0]:
                    dense = np.pad(dense, ((0, idx + 1 - dense.shape[0]), (0, 0)))
                dense[idx] += res.as_array().astype(np.int64)
            self._dense = dense
            self.overhead_version += 1
            self._dirty.mark_unknown()

    def collect_delta(self):
        """Drain the dirty-row feed (single consumer: the feature store's
        resident overhead master). Returns (version, rows, vals) — rows is
        None when the mirror cannot name its changes (a re-attach rebuild):
        the consumer then takes one full `overhead_snapshot` copy. vals are
        the current values of `rows`, copied under the lock (consistent
        with `version`). Requires attach_registry."""
        with self._lock:
            if self._dense is None:
                raise RuntimeError("attach_registry() before collect_delta()")
            rows, vals = self._dirty.drain(self._dense)
            return self.overhead_version, rows, vals

    def dense_values(self, rows: np.ndarray) -> np.ndarray:
        """Current dense-mirror values of `rows` (a consistent copy under
        the lock) — the feature store's live-mask-flip patch input. Rows
        beyond the mirror (interned after the last delta) read as zero."""
        with self._lock:
            if self._dense is None:
                raise RuntimeError("attach_registry() before dense_values()")
            rows = np.asarray(rows, dtype=np.int64)
            out = np.zeros((rows.shape[0], NUM_DIMS), np.int64)
            inside = rows < self._dense.shape[0]
            out[inside] = self._dense[rows[inside]]
            return out

    def overhead_snapshot(self, last_version: int | None = None):
        """(version, dense copy | None): None when nothing changed since
        `last_version` — the consistent-copy half of the feature store's
        zero-copy snapshot protocol. Requires attach_registry."""
        with self._lock:
            if self._dense is None:
                raise RuntimeError("attach_registry() before overhead_snapshot()")
            if last_version is not None and last_version == self.overhead_version:
                return self.overhead_version, None
            return self.overhead_version, self._dense.copy()

    # -- queries -------------------------------------------------------------

    def _frozen_views(
        self, agg: dict[str, Resources], nodes
    ) -> dict[str, FrozenResources]:
        memo = self._frozen[id(agg)]
        out: dict[str, FrozenResources] = {}
        for n in nodes:
            res = agg.get(n.name)
            if res is None:
                continue
            view = memo.get(n.name)
            if view is None:
                view = memo[n.name] = FrozenResources(
                    res.cpu_milli, res.mem_kib, res.gpu_milli
                )
            out[n.name] = view
        return out

    def get_overhead(self, nodes) -> dict[str, Resources]:
        """{node: overhead} for `nodes`, as immutable FrozenResources views
        (memoized until the node's aggregate changes — no per-call deep
        copies). Callers needing a mutable value must .copy()."""
        with self._lock:
            return self._frozen_views(self._overhead, nodes)

    def get_non_schedulable_overhead(self, nodes) -> dict[str, Resources]:
        with self._lock:
            return self._frozen_views(self._nonsched, nodes)

    # -- oracle (tests) ------------------------------------------------------

    def compute_node_overhead_oracle(self, node_name: str) -> tuple[Resources, Resources]:
        """The reference's per-query walk (overhead.go:120-168); used by the
        consistency tests to prove the incremental aggregates exact."""
        overhead = Resources.zero()
        non_schedulable = Resources.zero()
        for pod in self._backend.list_pods():
            if pod.node_name != node_name or pod.is_terminated():
                continue
            if not self._rrm.pod_has_reservation(pod):
                overhead.add(pod.request())
                if pod.scheduler_name != SPARK_SCHEDULER_NAME:
                    non_schedulable.add(pod.request())
        return overhead, non_schedulable
