"""FleetRouter — the fleet-level (coarse) half of two-level placement
(the port's copy of spark_scheduler_tpu/fleet/router.py).

Borg's cell pick over per-cell state, Omega's coarse/fine split: choose
the home cluster in O(F) from resident ClusterAggregates, then let that
cluster's unchanged solver stack do the fine placement. Three rules, in
order:

  affinity   an app already routed (driver placed or in flight) keeps its
             home — executors must land beside their driver's
             reservation, and gang identity must stay within one cluster
             for the byte-identity contract to mean anything.
  hosting    only clusters whose node roster hosts the pod's instance
             group are candidates (a group's gangs only place on that
             group's nodes — the instance-group domain boundary, now
             fleet-wide).
  headroom   among hosts, argmax free-capacity score with a
             deterministic lowest-index tie-break; no host at all falls
             back to the stable CRC32 membership hash (StableMembership,
             shared with ha/shard.py), so routing stays a pure function
             of (key, membership) even for never-seen groups.
"""

from __future__ import annotations

import threading

from spark_scheduler_tpu_torch.core.membership import StableMembership


class FleetRouter:
    def __init__(self, n_clusters: int, aggregates):
        self.members = StableMembership(n_clusters)
        self._aggs = list(aggregates)
        self._lock = threading.RLock()
        self._affinity: dict[str, int] = {}  # app_id -> home cluster
        self.picks = {"affinity": 0, "hosting": 0, "headroom": 0, "hash": 0}
        self.rerouted_orphans = 0

    # -- affinity ------------------------------------------------------------

    def bind(self, app_id: str, cluster: int) -> None:
        with self._lock:
            self._affinity[app_id] = cluster

    def unbind(self, app_id: str) -> None:
        with self._lock:
            self._affinity.pop(app_id, None)

    def affinity_of(self, app_id: str):
        with self._lock:
            return self._affinity.get(app_id)

    def drop_pending_affinity(self, cluster: int, placed) -> int:
        """A cluster died: apps never PLACED there (no durable
        reservation) lose their affinity so the next retry re-routes to a
        survivor — the orphaned-gang re-route. Apps already placed keep
        their binding (their state lives in the dead cluster; releasing
        them elsewhere would double-place the gang)."""
        with self._lock:
            orphans = [
                a for a, c in self._affinity.items()
                if c == cluster and a not in placed
            ]
            for a in orphans:
                del self._affinity[a]
            self.rerouted_orphans += len(orphans)
            return len(orphans)

    # -- the O(F) pick -------------------------------------------------------

    def route(self, app_id: str, instance_group: str) -> tuple[int, str]:
        """Return (home cluster, pick reason)."""
        with self._lock:
            home = self._affinity.get(app_id)
            if home is not None:
                self.picks["affinity"] += 1
                return home, "affinity"
            live = self.members.live()
            hosts = [
                i for i in live
                if self._aggs[i].hosts_group(instance_group)
            ]
            if len(hosts) == 1:
                reason = "hosting"
                choice = hosts[0]
            elif hosts:
                reason = "headroom"
                choice = max(
                    hosts,
                    key=lambda i: (self._score(i), -i),
                )
            else:
                reason = "hash"
                choice = self.members.owner(instance_group)
            self.picks[reason] += 1
            self._affinity[app_id] = choice
            return choice, reason

    def siblings(self, home: int, instance_group: str) -> list[int]:
        """Spillover candidates: live hosts of the group, best headroom
        first, home excluded."""
        with self._lock:
            live = [i for i in self.members.live() if i != home]
            hosts = [
                i for i in live
                if self._aggs[i].hosts_group(instance_group)
            ]
            def key(i):
                top, free = self._score(i)
                return (-top, -free, i)

            return sorted(hosts, key=key)

    def _score(self, i: int):
        free = self._aggs[i].free_total()
        top = self._aggs[i].top_node_free()
        # Headroom score: best-node fit first (can a gang member land at
        # all), then the free sum (how many can).
        return (top[0] + top[1] // 1024 + top[2],
                free[0] + free[1] // 1024 + free[2])

    def describe(self) -> dict:
        with self._lock:
            return {
                "clusters": self.members.n_slots,
                "live": self.members.live(),
                "apps_routed": len(self._affinity),
                "picks": dict(self.picks),
                "rerouted_orphans": self.rerouted_orphans,
            }
