"""Continuous defragmenter: pool-idle repack planning off the serving path.

Fragmentation here is slot-stranding: free capacity that cannot host a
whole reference executor because it is scattered sub-slot across nodes.
With `unit` the reference executor shape,

    slots(node)  = min over dims of floor(free[d] / unit[d])
    ideal_slots  = min over dims of floor(sum(free)[d] / unit[d])
    fragmentation = 1 - total_slots / ideal_slots          (0 when ideal=0)

— 0.0 means every free byte is usable at executor granularity, 1.0 means
all free capacity is stranded.

`run_once()` (called from the policy engine's background cadence when the
device pool is idle, or directly by tests/soak) measures fragmentation,
then *migrates* up to `budget` reclaimable executors per pass: it picks
soft-reserved (dynamic-allocation extra) executors on stranded donor nodes
whose release completes at least one slot, deletes those pods — the normal
executor-death path, which releases the soft slot and queues the app for
compaction — and drains `compact_dynamic_allocation_applications()` so the
apps re-bind into hard slots. Hard reservations are never touched, so the
preemption budget bounds exactly the number of running executor pods
disturbed per pass.

The port's copy of spark_scheduler_tpu/policy/defrag.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from spark_scheduler_tpu_torch.models.reservations import APP_ID_LABEL
from spark_scheduler_tpu_torch.models.resources import NUM_DIMS, Resources

FRAGMENTATION_GAUGE = "foundry.spark.scheduler.policy.fragmentation"
DEFRAG_MIGRATIONS = "foundry.spark.scheduler.policy.defrag.migrations"
DEFRAG_PASSES = "foundry.spark.scheduler.policy.defrag.passes"


def _slots(free: np.ndarray, unit: np.ndarray) -> int:
    """Whole reference-executor slots a free vector can host (dims with a
    zero unit requirement don't constrain)."""
    s = None
    for d in range(NUM_DIMS):
        if unit[d] <= 0:
            continue
        k = int(free[d] // unit[d])
        s = k if s is None else min(s, k)
    return max(s or 0, 0)


class Defragmenter:
    def __init__(
        self,
        backend,
        soft_store,
        reservation_manager,
        clock,
        *,
        budget: int,
        unit: Resources | None = None,
        registry=None,
        solver=None,
    ):
        self._backend = backend
        self._soft_store = soft_store
        self._rrm = reservation_manager
        self._clock = clock
        self.budget = budget
        self._unit = np.maximum(
            (unit or Resources.from_quantities("1", "1Gi", "0", round_up=False))
            .as_array()
            .astype(np.int64),
            0,
        )
        self._metrics = registry
        self._solver = solver
        self.passes = 0
        self.migrations = 0
        self.last_fragmentation: Optional[float] = None

    # -- metric --------------------------------------------------------------

    def _free_by_node(self) -> dict[str, np.ndarray]:
        reserved = self._rrm.get_reserved_resources()
        out: dict[str, np.ndarray] = {}
        for node in self._backend.list_nodes():
            free = node.allocatable.as_array().astype(np.int64)
            res = reserved.get(node.name)
            if res is not None:
                free = free - res.as_array().astype(np.int64)
            out[node.name] = np.maximum(free, 0)
        return out

    def fragmentation(self) -> float:
        free = self._free_by_node()
        if not free:
            return 0.0
        total_slots = sum(_slots(f, self._unit) for f in free.values())
        ideal = _slots(sum(free.values()), self._unit)
        if ideal <= 0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - total_slots / ideal))

    # -- one pass ------------------------------------------------------------

    def _pool_idle(self) -> bool:
        """Only consume device time the serving path is not using. Solvers
        without a pool (single-device) are always 'idle' for this purpose.
        A pool without an `idle_slots()` (the port's, like the JAX
        package's) answers idle too."""
        pool = getattr(self._solver, "pool", None) or getattr(
            self._solver, "_pool", None
        )
        if pool is None:
            return True
        idle = getattr(pool, "idle_slots", None)
        if callable(idle):
            try:
                return bool(idle())
            except Exception:
                return True
        return True

    def run_once(self, force: bool = False) -> dict:
        """One defrag pass. Returns {fragmentation_before, fragmentation_after,
        migrations} (the soak's reduction assertion reads these)."""
        if not force and not self._pool_idle():
            return {"skipped": "pool-busy"}
        before = self.fragmentation()
        free = self._free_by_node()
        migrated = 0
        # Reclaimable executors: soft-reserved extras whose release completes
        # at least one slot on their (currently stranded) node.
        soft = self._soft_store.get_all_copy()
        candidates: list[tuple[str, str, str]] = []  # (app, pod, node)
        for app_id, sr in soft.items():
            for pod_name, r in sr.reservations.items():
                f = free.get(r.node)
                if f is None:
                    continue
                gain = _slots(
                    f + r.resources.as_array().astype(np.int64), self._unit
                ) - _slots(f, self._unit)
                if _slots(f, self._unit) == 0 and gain > 0:
                    candidates.append((app_id, pod_name, r.node))
        for app_id, pod_name, _node in candidates[: self.budget]:
            pod = next(
                (
                    p
                    for p in self._backend.list_pods(
                        labels={APP_ID_LABEL: app_id}
                    )
                    if p.name == pod_name
                ),
                None,
            )
            if pod is None:
                continue
            self._backend.delete_pod(pod)
            migrated += 1
        if migrated:
            # Migrations ride the EXISTING soft-reservation compaction: the
            # deletions above queued each app; one drain re-binds survivors
            # into freed hard slots.
            self._rrm.compact_dynamic_allocation_applications()
        after = self.fragmentation()
        self.passes += 1
        self.migrations += migrated
        self.last_fragmentation = after
        if self._metrics is not None:
            self._metrics.gauge(FRAGMENTATION_GAUGE).set(round(after, 6))
            self._metrics.counter(DEFRAG_PASSES).inc()
            if migrated:
                self._metrics.counter(DEFRAG_MIGRATIONS).inc(migrated)
        return {
            "fragmentation_before": before,
            "fragmentation_after": after,
            "migrations": migrated,
        }
