"""Vectorized preemption search + eviction execution.

When a high-priority gang fails fit, enumerate running lower-priority gangs
as eviction candidates, and solve the masked fit for ALL candidate sets in
one batched device pass (core/solver.py preemption_search →
ops/packing.py preemption_batched_fit). Candidate sets are NESTED prefixes
of the victim list ordered (priority asc, youngest first): set c evicts
victims[0..c]. Freed capacity is monotone in c, so the first feasible
prefix is the minimal-cost eviction set — picked on host with one argmax,
no per-candidate Python loop over kernel calls.

Hard-reservation safety: eviction only ever *releases* a victim's own
reservations (pod deletes + cache delete + soft-store release — the exact
teardown path every other component uses); reservations of non-victims are
never touched, and gangs at or above the protected class ("system") are
never candidates. The search decides only WHO to evict; the requester then
re-runs the normal admission solve against the freed cluster, so placement
semantics (including single-AZ strategies) cannot drift from the serving
path.

The port's copy of spark_scheduler_tpu/policy/preemption.py. `search`
calls the port's `PlacementSolver.preemption_search`, which runs
ops/packing.py `preemption_batched_fit` on the solver's device (the card
unless the app was built on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from spark_scheduler_tpu_torch.models.resources import NUM_DIMS
from spark_scheduler_tpu_torch.models.reservations import PRIORITY_CLASS_ANNOTATION
from spark_scheduler_tpu_torch.policy.priority import (
    PROTECTED_PRIORITY,
    effective_priority,
    parse_priority_class,
)


@dataclasses.dataclass
class PreemptionResult:
    """What happened, for the FlightRecorder and the caller's retry."""

    evicted: list[str]  # app ids, eviction order
    candidates: int  # eviction sets searched (one batched pass)
    searched: int  # victims enumerated
    cost: int  # reservation slots released
    search_ms: float


class PreemptionSearch:
    def __init__(
        self,
        rr_cache,
        pod_lister,
        soft_store,
        backend,
        clock,
        *,
        max_evictions: int,
        protected_priority: int = PROTECTED_PRIORITY,
        promote_after_s: Optional[float] = None,
    ):
        self._rr_cache = rr_cache
        self._pod_lister = pod_lister
        self._soft_store = soft_store
        self._backend = backend
        self._clock = clock
        self.max_evictions = max_evictions
        self.protected_priority = protected_priority
        # Anti-starvation symmetry with the ordering's age promotion: a
        # gang that aged into a higher effective tier also stops being an
        # eviction candidate for that tier (else sustained high-priority
        # pressure could evict a promoted gang forever). None = base
        # priority only.
        self.promote_after_s = promote_after_s

    # -- candidate enumeration ----------------------------------------------

    def enumerate_victims(
        self, requester_priority: int, domain_names: Optional[set]
    ) -> list[tuple[int, float, object]]:
        """Running gangs strictly below the requester's priority (and below
        the protected class), whose reservations touch the requester's
        domain. Returns [(priority, creation_ts, rr)] ordered cheapest-first:
        lowest priority, then youngest (Borg §2.3 eviction order)."""
        ceiling = min(requester_priority, self.protected_priority)
        now = self._clock()
        out = []
        for rr in self._rr_cache.list():
            pc = parse_priority_class(
                rr.annotations.get(PRIORITY_CLASS_ANNOTATION)
            )
            if domain_names is not None:
                nodes = {r.node for r in rr.spec.reservations.values()}
                if not (nodes & domain_names):
                    continue
            driver = self._pod_lister.get_driver_pod(rr.name, rr.namespace)
            created = driver.creation_timestamp if driver is not None else 0.0
            if self.promote_after_s is not None and driver is not None:
                pc = effective_priority(
                    pc, now - created, self.promote_after_s
                )
            if pc >= ceiling:
                continue
            out.append((pc, created, rr))
        out.sort(key=lambda v: (v[0], -v[1]))
        return out

    def freed_prefixes(self, victims, registry) -> np.ndarray:
        """[C, rows, 3] int64 cumulative freed capacity: row c = capacity
        released by evicting victims[0..c] (hard slots + the victims' own
        soft reservations), scattered into the solver's registry index
        space. Nodes the registry does not know free nothing usable."""
        soft = self._soft_store.get_all_copy()
        rows = max(registry.capacity, 1)
        freed = np.zeros((len(victims), rows, NUM_DIMS), dtype=np.int64)
        for c, (_pc, _created, rr) in enumerate(victims):
            step = freed[c]
            for res in rr.spec.reservations.values():
                idx = registry.index_of(res.node)
                if idx is not None and idx < rows:
                    step[idx] += res.resources.as_array().astype(np.int64)
            sr = soft.get(rr.name)
            if sr is not None:
                for r in sr.reservations.values():
                    idx = registry.index_of(r.node)
                    if idx is not None and idx < rows:
                        step[idx] += r.resources.as_array().astype(np.int64)
        return np.cumsum(freed, axis=0)

    # -- search + execution --------------------------------------------------

    def search(
        self,
        solver,
        strategy: str,
        tensors,
        app_resources,
        driver_candidate_names,
        domain_names: Optional[set],
        requester_priority: int,
        domain_mask=None,
    ) -> tuple[Optional[PreemptionResult], list]:
        """One batched pass over all candidate eviction sets. Returns
        (result, victims_to_evict); (None, []) when no eviction set admits
        the gang."""
        t0 = self._clock()
        victims = self.enumerate_victims(requester_priority, domain_names)[
            : self.max_evictions
        ]
        if not victims:
            return None, []
        freed_cum = self.freed_prefixes(victims, solver.registry)
        idx, _info = solver.preemption_search(
            strategy,
            tensors,
            app_resources.driver_resources,
            app_resources.executor_resources,
            app_resources.min_executor_count,
            driver_candidate_names,
            freed_cum,
            domain_mask=domain_mask,
        )
        if idx < 0:
            return None, []
        chosen = victims[: idx + 1]
        cost = sum(len(rr.spec.reservations) for _p, _c, rr in chosen)
        result = PreemptionResult(
            evicted=[rr.name for _p, _c, rr in chosen],
            candidates=len(victims),
            searched=len(victims),
            cost=cost,
            search_ms=(self._clock() - t0) * 1e3,
        )
        return result, chosen

    def execute(self, victims) -> None:
        """Release the chosen gangs through the normal teardown path: delete
        the app's pods (fires the soft-store / reservation-manager pod
        handlers), drop the app's remaining soft reservations, then delete
        the hard reservation (debiting the usage tracker via the cache's
        mutation listeners). Never touches another gang's reservations."""
        for _pc, _created, rr in victims:
            for pod in self._pod_lister.list_app_pods(rr.name, rr.namespace):
                cur = self._backend.get("pods", pod.namespace, pod.name)
                if cur is not None:
                    self._backend.delete_pod(cur)
            self._soft_store.remove_driver_reservation(rr.name)
            if self._rr_cache.get(rr.namespace, rr.name) is not None:
                self._rr_cache.delete(rr.namespace, rr.name)
