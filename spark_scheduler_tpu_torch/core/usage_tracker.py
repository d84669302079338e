"""Incremental reserved-usage aggregate — delta-maintained device-state feed.

The reference rebuilds per-node reservation usage from every reservation of
every application on every request (`GetReservedResources`,
internal/extender/resourcereservations.go:228-233 → `UsageForNodes`,
resources.go:150-166 — an O(apps x slots) walk). That is fine for Go maps at
hundreds of apps; this rebuild targets 1k concurrent apps x 10k nodes
with a <50 ms budget (SURVEY.md §7 "Host↔device latency budget"), where the
per-request walk, not the kernel, becomes the latency floor.

`ReservedUsageTracker` replaces the walk with a dense int64 `[cap, 3]`
usage array over the solver's stable node-index space, maintained by
scatter-add deltas:

  - hard reservations: mutation listener on the ResourceReservation
    write-through cache (the cache owner is the sole writer, so every
    change flows through it — cache.go:27-89 ownership invariant);
  - soft reservations: delta listener on SoftReservationStore.

Per-request cost is O(1): `array()` hands the maintained buffer straight to
`build_cluster_tensors` (a single vectorized pad/copy), and every mutation
costs O(slots of the touched app). `rebuild()` recomputes from scratch —
used at attach time, after failover resyncs, and by the consistency tests
(delta-maintained state == from-scratch rebuild).
"""

from __future__ import annotations

import threading

import numpy as np

from spark_scheduler_tpu_torch.core.dirty_feed import DirtyRowFeed
from spark_scheduler_tpu_torch.models.cluster import NodeRegistry
from spark_scheduler_tpu_torch.models.resources import NUM_DIMS, Resources
from spark_scheduler_tpu_torch.store.cache import BatchableListener


class ReservedUsageTracker:
    def __init__(self, registry: NodeRegistry, rr_cache, soft_store):
        self._registry = registry
        self._rr_cache = rr_cache
        self._soft_store = soft_store
        self._lock = threading.RLock()
        self._dense = np.zeros((0, NUM_DIMS), dtype=np.int64)
        # Monotonic change counter: bumped under the lock by every applied
        # delta / rebuild. The HostFeatureStore keys its zero-copy snapshot
        # on it — an unchanged version proves the cached copy is current.
        self.version = 0
        # Instrumentation: number of scatter deltas applied since attach —
        # the "per-request host work proportional to the delta" evidence.
        self.deltas_applied = 0
        self.rebuilds = 0
        # Dirty-row feed for the HostFeatureStore's resident usage master
        #: every scatter records its row so the store patches
        # O(changed) rows instead of copying the whole [cap, 3] array per
        # serving window (core/dirty_feed.py — the drain protocol shared
        # with the overhead mirror).
        self._dirty = DirtyRowFeed()
        # Batch-aware: a serving window's coalesced reservation write-back
        # (create_reservations_batch under rr_cache.deferred_notifications)
        # applies all its per-slot diffs under ONE lock hold instead of one
        # per reservation.
        rr_cache.add_mutation_listener(
            BatchableListener(self._on_rr_mutation, self._on_rr_mutation_batch)
        )
        soft_store.add_delta_listener(self._on_soft_delta)
        self.rebuild()

    # -- queries -------------------------------------------------------------

    def array(self, min_rows: int | None = None) -> np.ndarray:
        """The dense [cap, 3] int64 usage array (a copy, padded to at least
        `min_rows`). One vectorized op per request — no per-reservation walk."""
        with self._lock:
            out = self._dense
            rows = max(min_rows or 0, out.shape[0])
            if rows > out.shape[0]:
                out = np.pad(out, ((0, rows - out.shape[0]), (0, 0)))
            else:
                out = out.copy()
            return out

    def as_map(self) -> dict[str, Resources]:
        """{node: Resources} view for map-shaped consumers (reporters,
        failover). O(nodes with nonzero usage), vectorized scan."""
        with self._lock:
            nz = np.flatnonzero(self._dense.any(axis=1))
            out: dict[str, Resources] = {}
            for idx in nz:
                name = self._registry.name_of(int(idx))
                if name is not None:
                    out[name] = Resources.from_array(self._dense[idx])
            return out

    # -- maintenance ---------------------------------------------------------

    def rebuild(self) -> None:
        """Recompute the aggregate from the caches (the from-scratch oracle)."""
        with self._lock:
            self._dense = np.zeros(
                (max(self._registry.capacity, 1), NUM_DIMS), dtype=np.int64
            )
            for rr in self._rr_cache.list():
                for res in rr.spec.reservations.values():
                    self._scatter(res.node, res.resources, +1)
            for node, res in self._soft_store.used_soft_reservation_resources().items():
                self._scatter(node, res, +1)
            self.rebuilds += 1
            self.version += 1
            self._dirty.mark_unknown()

    def collect_delta(self):
        """Drain the dirty-row feed (single consumer: the feature store's
        resident usage master). Returns (version, rows, vals):

          rows  int64 registry rows whose usage changed since the last
                drain (deduplicated), or None when the tracker cannot name
                them (a from-scratch rebuild happened) — the consumer then
                pays one full `array()` copy;
          vals  the current [len(rows), 3] int64 values of those rows,
                copied under the tracker lock (consistent with `version`).
        """
        with self._lock:
            rows, vals = self._dirty.drain(self._dense)
            return self.version, rows, vals

    def _ensure_row(self, idx: int) -> None:
        if idx >= self._dense.shape[0]:
            grow = max(idx + 1, self._dense.shape[0] * 2, 8)
            self._dense = np.pad(
                self._dense, ((0, grow - self._dense.shape[0]), (0, 0))
            )

    def _scatter(self, node: str, res: Resources, sign: int) -> None:
        idx = self._registry.intern(node)
        self._ensure_row(idx)
        self._dense[idx] += sign * res.as_array().astype(np.int64)
        self.deltas_applied += 1
        self.version += 1
        self._dirty.note(idx)

    # -- listeners -----------------------------------------------------------

    def _apply_rr_mutation(self, old, new) -> None:
        """Per-slot diff of one ResourceReservation change (caller holds the
        lock): O(slots of one app). Status-only updates (executor pod
        bindings — the most common RR mutation) change no Spec slot and are
        skipped outright."""
        if (
            old is not None
            and new is not None
            and old.spec.reservations == new.spec.reservations
        ):
            return
        if old is not None:
            for res in old.spec.reservations.values():
                self._scatter(res.node, res.resources, -1)
        if new is not None:
            for res in new.spec.reservations.values():
                self._scatter(res.node, res.resources, +1)

    def _on_rr_mutation(self, old, new) -> None:
        with self._lock:
            self._apply_rr_mutation(old, new)

    def _on_rr_mutation_batch(self, pairs) -> None:
        """A whole serving window's reservation commits as ONE update: one
        lock hold, all per-slot diffs applied back to back."""
        with self._lock:
            for old, new in pairs:
                self._apply_rr_mutation(old, new)

    def _on_soft_delta(self, node: str, res: Resources, sign: int) -> None:
        with self._lock:
            self._scatter(node, res, sign)
