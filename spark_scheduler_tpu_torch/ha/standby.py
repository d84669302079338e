"""StandbyTailer — keep a replica's caches hot from backend events.

A WriteThroughCache deliberately ignores external creates/updates (its
owner is the sole writer, cache.go:96-118) — correct for ONE process, but
a warm standby must absorb the leader's reservation/demand commits or its
promotion pays a full cold rebuild. The tailer subscribes to the shared
backend's event bus and applies every event it did NOT originate into the
replica's own caches via `apply_external_upsert` / `apply_external_delete`
— which fire the caches' mutation listeners, so the ReservedUsageTracker's
dense usage array (and through it the HostFeatureStore's snapshot) stays
warm too. Promotion then costs one failover reconcile, not a state
rebuild.

Self-write dedup: the owner's writes also fire backend events back at the
tailer. rv equality CANNOT be the signal — the cache's own
watch-subscription (registered first) fast-forwards the stored object's
resourceVersion to the committed one without touching content, so by the
time the tailer runs, an EXTERNAL update's rv matches too and rv-dedup
would drop the leader's new content forever. Content equality is the
correct signal: for an own write the stored object IS the committed
content (the owner wrote it, and the rv was just fast-forwarded), so
`stored == obj` holds; an external update differs somewhere or there is
nothing to absorb. This makes the tailer safe to leave running in EVERY
role: on a standby all events are external; on the leader all are own
writes; on an active-active shard member both mix.
"""

from __future__ import annotations


class StandbyTailer:
    def __init__(self, app):
        self._app = app
        self.enabled = True
        self.applied = 0
        self.skipped_own = 0
        backend = app.backend
        backend.subscribe(
            "resourcereservations",
            on_add=lambda obj: self._upsert(self._rr_cache(), obj),
            on_update=lambda old, new: self._upsert(self._rr_cache(), new),
            on_delete=lambda obj: self._delete(self._rr_cache(), obj),
        )
        backend.subscribe(
            "demands",
            on_add=lambda obj: self._upsert(self._demand_cache(), obj),
            on_update=lambda old, new: self._upsert(self._demand_cache(), new),
            on_delete=lambda obj: self._delete(self._demand_cache(), obj),
        )

    def _rr_cache(self):
        return self._app.rr_cache

    def _demand_cache(self):
        # SafeDemandCache: the inner cache exists only once the Demand CRD
        # does; before that, demand events have nothing to warm.
        safe = self._app.demand_cache
        return safe._cache if safe.crd_exists() else None

    def _upsert(self, cache, obj) -> None:
        if not self.enabled or cache is None:
            return
        stored = cache.get(obj.namespace, obj.name)
        if stored is not None and stored == obj:
            self.skipped_own += 1  # own write (or an absorbed no-op)
            return
        # Store a copy when the model supports it: backend and cache must
        # not alias one mutable object across replicas.
        cache.apply_external_upsert(obj.copy() if hasattr(obj, "copy") else obj)
        self.applied += 1

    def _delete(self, cache, obj) -> None:
        if not self.enabled or cache is None:
            return
        if cache.get(obj.namespace, obj.name) is None:
            self.skipped_own += 1  # own delete already removed it
            return
        cache.apply_external_delete(obj.namespace, obj.name)
        self.applied += 1

    def stats(self) -> dict:
        return {"applied": self.applied, "skipped_own": self.skipped_own}
