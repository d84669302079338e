"""ReplicaRuntime — one scheduler replica's role state machine.

A replica is a full SchedulerApp built over a FencedBackend, plus:

  - a LeaseManager (election mode) whose heartbeat renews leadership or
    detects deposition;
  - a StandbyTailer keeping its caches/feature store hot in every role;
  - `promote()` — the standby -> leader transition: run the failover
    reconciler against observed pods (the reference's new-leader rebuild,
    failover.go:35-72), warm the feature-store snapshot, and only then
    mark the replica serving. Warm caches make this a reconcile, not a
    state rebuild (chip_smoke.py phase 10 measures the gap on the card).

`ShardedServingGroup` composes N replicas over ONE shared backend into
the active-active topology: traffic shards by instance group (ShardMap),
replica 0 additionally holds the lease and owns reconciliation, and
wrong-shard requests are forwarded to their owner so kube-scheduler can
hit any replica.

The port's copy of spark_scheduler_tpu/ha/replica.py. `build_replica` and
`ShardedServingGroup` take `device=` (the card unless the caller asks for
the CPU) and pass it to `build_scheduler_app`, so every replica owns its
own `PlacementSolver` with its own device base, host mirror and pinned
buffers; several replicas share one card.
"""

from __future__ import annotations

import threading
import time

from spark_scheduler_tpu_torch.ha.fencing import FencedBackend
from spark_scheduler_tpu_torch.ha.lease import BackendLeaseStore, FencingError, LeaseManager
from spark_scheduler_tpu_torch.ha.shard import ShardMap
from spark_scheduler_tpu_torch.ha.standby import StandbyTailer

ROLE_STANDBY = "standby"
ROLE_LEADER = "leader"
ROLE_ACTIVE = "active"  # sharded-group member serving its shard
ROLE_DEPOSED = "deposed"

SERVING_ROLES = frozenset({ROLE_LEADER, ROLE_ACTIVE})


class ReplicaRuntime:
    def __init__(
        self,
        replica_id: str,
        app,
        lease: LeaseManager | None = None,
        tailer: StandbyTailer | None = None,
        telemetry=None,
        heartbeat_s: float | None = None,
        clock=time.time,
    ):
        self.replica_id = replica_id
        self.app = app
        self.lease = lease
        self.tailer = tailer
        self.telemetry = telemetry
        self._clock = clock
        # Heartbeat well inside the TTL: three chances to renew before a
        # standby may take over (the classic lease discipline).
        self.heartbeat_s = heartbeat_s or (
            lease.ttl_s / 3.0 if lease is not None else 1.0
        )
        self.role = ROLE_STANDBY
        self.last_promotion_ms: float | None = None
        self.last_reconcile_ms: float | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._dead = False  # kill() flips it: chaos-crashed, ticks no-op
        if telemetry is not None:
            telemetry.on_role(self.role)

    # -- election ----------------------------------------------------------

    def run_election_once(self) -> str:
        """One deterministic election tick (the heartbeat thread calls this
        on its interval; tests and the chaos soak drive it by hand):
        leaders renew (a failed renew = deposed, serving stops), standbys
        poll the lease and promote on takeover. Returns the role after the
        tick."""
        if self._dead or self.lease is None:
            return self.role
        if self.role == ROLE_LEADER:
            if not self.lease.renew():
                self._set_role(ROLE_DEPOSED)
        elif self.role in (ROLE_STANDBY, ROLE_DEPOSED):
            if self.role == ROLE_DEPOSED:
                # Deposition is an event, not a terminal state: serving
                # stopped the tick the renew failed; from the next tick on
                # the replica rejoins the election as a warm standby. (A
                # single transient lease-store read failure must not
                # permanently halve the fleet.)
                self._set_role(ROLE_STANDBY)
            # Cross-process WAL deployments: pull the leader's appended
            # records before judging the lease, so promotion reconciles
            # against current state (in-process backends have no poll_log
            # — the event bus already delivered everything).
            poll = getattr(self.app.backend, "poll_log", None)
            if poll is not None:
                poll()
            if self.lease.try_acquire():
                self.promote()
            else:
                # Keep the host feature arrays warm every heartbeat: the
                # promotion-time snapshot then pays O(since-last-tick),
                # not an O(nodes) roster walk accumulated over the whole
                # standby life.
                try:
                    self.app.extender.features.snapshot()
                except Exception:
                    pass  # a torn mid-churn snapshot retries next tick
        if self.telemetry is not None and self.lease is not None:
            st = self.lease.state()
            self.telemetry.on_lease(st["lease_epoch"], st["lease_age_s"])
            if self.tailer is not None:
                self.telemetry.on_tailed(self.tailer.applied)
        return self.role

    def promote(self) -> dict:
        """Standby -> leader: reconcile durable state against observed pods
        BEFORE serving (a takeover IS a leader change), warm the feature
        snapshot, then flip the role. Returns the reconcile summary."""
        t0 = time.perf_counter()
        poll = getattr(self.app.backend, "poll_log", None)
        if poll is not None:
            poll()  # final catch-up before we own the state
        become_writer = getattr(self.app.backend, "promote_to_writer", None)
        if become_writer is not None:
            become_writer()
        r0 = time.perf_counter()
        summary = self.app.reconciler.sync_resource_reservations_and_demands()
        reconcile_ms = (time.perf_counter() - r0) * 1e3
        # First serving window must not pay the roster walk: snapshot now.
        self.app.extender.features.snapshot()
        # The promotion reconcile covers the gap heuristic's reason to
        # exist for this leadership term.
        self.app.extender._last_request = self.app.extender._clock()
        self._set_role(ROLE_LEADER)
        self.last_reconcile_ms = reconcile_ms
        self.last_promotion_ms = (time.perf_counter() - t0) * 1e3
        if self.telemetry is not None:
            self.telemetry.on_promotion(self.last_promotion_ms, reconcile_ms)
        return summary if isinstance(summary, dict) else {}

    def _set_role(self, role: str) -> None:
        self.role = role
        if self.telemetry is not None:
            self.telemetry.on_role(role)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Spawn the heartbeat/election thread (idempotent)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.heartbeat_s):
                try:
                    self.run_election_once()
                except Exception:
                    # A flaky lease store read must not kill the election
                    # loop; the next tick retries (an expired lease is the
                    # failure detector, not this thread's liveness).
                    pass

        self._thread = threading.Thread(
            target=_loop, daemon=True, name=f"ha-heartbeat-{self.replica_id}"
        )
        self._thread.start()

    def stop(self) -> None:
        """Graceful shutdown: stop heartbeating and expire the lease NOW so
        a standby promotes without waiting out the TTL."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.lease is not None and self.role == ROLE_LEADER:
            self.lease.release()
        if self.role in SERVING_ROLES:
            self._set_role(ROLE_STANDBY)

    def kill(self) -> None:
        """Chaos crash: heartbeats stop mid-lease, NOTHING is released —
        the lease expires by TTL and the successor's takeover bumps the
        fencing epoch, exactly like a SIGKILLed process."""
        self._dead = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- serving -----------------------------------------------------------

    def is_serving(self) -> bool:
        return not self._dead and self.role in SERVING_ROLES

    def state(self) -> dict:
        out = {
            "replica": self.replica_id,
            "role": self.role,
            "serving": self.is_serving(),
            "promotion_ms": self.last_promotion_ms,
            "reconcile_ms": self.last_reconcile_ms,
        }
        if self.lease is not None:
            out["lease"] = self.lease.state()
        if self.tailer is not None:
            out["tailer"] = self.tailer.stats()
        return out


def build_replica(
    shared_backend,
    replica_id: str,
    *,
    config=None,
    lease: LeaseManager | None = None,
    gate=None,
    metrics=None,
    events=None,
    waste=None,
    clock=None,
    registry=None,
    device="cuda",
) -> ReplicaRuntime:
    """Wire one replica over a shared backend: lease (unless a custom
    fencing `gate` is supplied — the sharded group does that), fenced
    backend, full SchedulerApp, standby tailer, telemetry. The replica's
    solver runs on `device` (the card unless the caller asks for the
    CPU), as `build_scheduler_app` does."""
    import time as _time

    from spark_scheduler_tpu_torch.observability import HATelemetry
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app

    clock = clock or _time.time
    ttl = getattr(config, "ha_lease_ttl_s", 3.0) if config is not None else 3.0
    if lease is None and gate is None:
        lease = LeaseManager(
            BackendLeaseStore(shared_backend), replica_id, ttl_s=ttl, clock=clock
        )
    telemetry = HATelemetry(
        registry if registry is not None
        else (metrics.registry if metrics is not None else None),
        replica=replica_id,
    )
    fenced = FencedBackend(
        shared_backend,
        gate if gate is not None else lease.check_fence,
        on_reject=lambda _kind: telemetry.on_fenced_reject(),
    )
    app = build_scheduler_app(
        fenced, config, metrics=metrics, events=events, waste=waste,
        clock=clock, device=device,
    )
    if lease is not None:
        app.extender.ha_lease = lease
    tailer = StandbyTailer(app)
    heartbeat = (
        getattr(config, "ha_heartbeat_s", None) if config is not None else None
    )
    return ReplicaRuntime(
        replica_id, app, lease=lease, tailer=tailer, telemetry=telemetry,
        heartbeat_s=heartbeat, clock=clock,
    )


class ShardedServingGroup:
    """N active replicas over one shared backend, traffic sharded by
    instance group. Replica 0 holds the lease (it owns promotion-time and
    gap-heuristic reconciliation); every member serves its own groups'
    predicates, and a request landing on the wrong member is FORWARDED to
    the owner (the in-process analog of an HTTP redirect) so the client
    never sees a gap. Per-group decisions are byte-identical to a single
    unsharded replica: group domains are disjoint (pods pin their
    instance group), so per-group solves commute — the property the
    solver's instance-group domain partitioning rests on and the
    equivalence test pins."""

    def __init__(
        self,
        shared_backend,
        n_replicas: int,
        *,
        config_factory=None,
        clock=None,
        registry=None,
        device="cuda",
    ):
        import time as _time

        self.shard_map = ShardMap(n_replicas)
        self.forwarded = 0
        self._members_live = [True] * n_replicas
        clock = clock or _time.time
        self.replicas: list[ReplicaRuntime] = []
        for i in range(n_replicas):
            config = config_factory(i) if config_factory is not None else None
            if i == 0:
                runtime = build_replica(
                    shared_backend, f"replica-{i}", config=config,
                    clock=clock, registry=registry, device=device,
                )
            else:
                runtime = build_replica(
                    shared_backend, f"replica-{i}", config=config,
                    gate=self._member_gate(i), clock=clock, registry=registry,
                    device=device,
                )
                # Reconciliation belongs to the lease holder (replica 0);
                # a member's request-gap resync would race it AND be
                # fenced — disable the heuristic outright.
                runtime.app.extender._config.resync_gap_seconds = float("inf")
            self.replicas.append(runtime)
        self._label = self.replicas[0].app.extender._config.instance_group_label

    def _member_gate(self, index: int):
        def gate() -> None:
            if not self._members_live[index]:
                raise FencingError(
                    f"fenced write rejected: replica-{index} was removed "
                    "from the serving group"
                )

        return gate

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Elect replica 0, promote it (reconcile-before-serve), and mark
        every other member active for its shard."""
        leader = self.replicas[0]
        assert leader.lease is not None and leader.lease.try_acquire()
        leader.promote()
        for r in self.replicas[1:]:
            r._set_role(ROLE_ACTIVE)

    def stop(self) -> None:
        for r in self.replicas:
            r.stop()
            r.app.stop()

    def remove_member(self, index: int) -> None:
        """Fence a member OUT of the group (crash or drain): its shard's
        groups remap onto the survivors, it stops serving, and any commit
        it still has in flight is rejected by its gate instead of racing
        the new owner — the member-group analog of the lease's fencing
        epoch. Replica 0 cannot leave this way: it holds the lease, so its
        death is a leader failover (the chaos soak's territory)."""
        if index == 0:
            raise ValueError(
                "replica 0 holds the lease; its death is a leader "
                "failover, not a member drain"
            )
        self._members_live[index] = False
        self.shard_map.remove(index)
        self.replicas[index]._set_role(ROLE_STANDBY)

    # -- routing -----------------------------------------------------------

    def owner_index(self, pod) -> int:
        from spark_scheduler_tpu_torch.core.sparkpods import find_instance_group

        return self.shard_map.owner(find_instance_group(pod, self._label) or "")

    def predicate(self, args, via: int = 0):
        """Serve one predicate as replica `via` received it: owner serves
        directly, non-owners forward."""
        idx = self.owner_index(args.pod)
        if idx != via:
            self.forwarded += 1
        return self.replicas[idx].app.extender.predicate(args)

    def predicate_batch(self, args_list, via: int = 0):
        """Serve a window: split by owning shard (per-group arrival order
        preserved), serve each owner's sub-window through its own
        extender, and reassemble results in request order."""
        by_owner: dict[int, list[int]] = {}
        for i, a in enumerate(args_list):
            by_owner.setdefault(self.owner_index(a.pod), []).append(i)
        results = [None] * len(args_list)
        for idx, positions in by_owner.items():
            if idx != via:
                self.forwarded += len(positions)
            sub = [args_list[p] for p in positions]
            for p, res in zip(
                positions, self.replicas[idx].app.extender.predicate_batch(sub)
            ):
                results[p] = res
        return results

    def state(self) -> dict:
        return {
            "replicas": [r.state() for r in self.replicas],
            "forwarded": self.forwarded,
            "shard_map": self.shard_map.describe(),
        }
