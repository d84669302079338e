"""FleetFacade — one serving endpoint over F independent cluster stacks
(the port's copy of spark_scheduler_tpu/fleet/facade.py). Every stack's
solver runs on the facade's `device`: the card unless the caller asks for
the CPU. On the card each cluster's windows run the row-walk kernel from
its own worker thread; the clusters share the card, and a window's fetch
waits on its own copy's event, never on the whole device.

The ha/shard.py ShardMap generalized one level: instead of N replicas
sharing one backend partitioned by instance group, the fleet runs F
FULLY independent per-cluster solver stacks — own backend, feature
store, planner, solver, extender — each serialized behind its own
dedicated worker thread, so per-cluster order is exactly a standalone
cluster's while windows on DIFFERENT clusters run concurrently
(aggregate decisions/s scales with F instead of serializing behind one
pipeline; kernel launches, device waits and the simulated device RTT
release the GIL).

Byte-identity is the contract, mechanically enforced: every operation a
cluster serves (node add, schedule, release, terminate, delete) is an
ordinary single-cluster op executed on that cluster's thread, optionally
journaled in a per-cluster OPLOG. `replay_standalone()` re-serves a
cluster's oplog on a fresh standalone stack and
`verify_cluster_equivalence()` diffs every decision (ok / node_names /
outcome) and the durable reservation state byte-for-byte — the HA-shard
equivalence bar, lifted to clusters, asserted in-arm by the fleet bench.

Routing is two-level (router.py): O(F) home pick from resident
aggregates, then the unchanged in-cluster kernel. A driver denied a
capacity fit at home spills to the best sibling (spillover.py). Cluster
kill/rejoin rides StableMembership: a dead cluster's PENDING apps are
re-routed to survivors, PLACED apps keep their (unavailable) home so a
gang can never be placed twice.
"""

from __future__ import annotations

import copy
import threading
from concurrent.futures import ThreadPoolExecutor

from spark_scheduler_tpu_torch.core.extender import (
    FAILURE_FIT,
    FAILURE_INTERNAL,
    ExtenderArgs,
    ExtenderFilterResult,
)
from spark_scheduler_tpu_torch.core.sparkpods import (
    ROLE_DRIVER,
    SPARK_APP_ID_LABEL,
    SPARK_ROLE_LABEL,
    find_instance_group,
)
from spark_scheduler_tpu_torch.fleet.aggregates import (
    RESERVATIONS_KIND,
    ClusterAggregates,
)
from spark_scheduler_tpu_torch.fleet.router import FleetRouter
from spark_scheduler_tpu_torch.fleet.spillover import (
    FleetDecision,
    SpilloverCoordinator,
)
from spark_scheduler_tpu_torch.observability.telemetry import FleetTelemetry
from spark_scheduler_tpu_torch.server.app import build_scheduler_app
from spark_scheduler_tpu_torch.server.config import InstallConfig
from spark_scheduler_tpu_torch.store.backend import DEMAND_CRD, InMemoryBackend

CLUSTER_UNAVAILABLE = "cluster unavailable"


class ClusterStack:
    """One cluster's complete scheduler stack behind one worker thread.

    All mutating ops go through `_run` — a dedicated single worker per
    cluster — so per-cluster serving order is total (a standalone
    cluster's order) while different clusters overlap. A standalone
    replay executes the same `_do_*` methods on the calling thread:
    same code, same order, same bytes.
    """

    def __init__(
        self,
        index: int,
        config: InstallConfig,
        *,
        clock=None,
        record_ops: bool = False,
        suppress_resync: bool = True,
        threaded: bool = True,
        device="cuda",
    ):
        self.index = index
        self.config = config
        self.device = device
        self.backend = InMemoryBackend()
        self.backend.register_crd(DEMAND_CRD)
        self.app = build_scheduler_app(
            self.backend, config, clock=clock, device=device
        )
        self.extender = self.app.extender
        if suppress_resync:
            # Deterministic serving: the clock-gap resync heuristic would
            # make decisions depend on wall time (the Harness suppression).
            self.extender._last_request = float("inf")
        self._label = config.instance_group_label
        self.aggregates = ClusterAggregates(self.backend, self._label)
        self.oplog: list | None = [] if record_ops else None
        self.decisions = 0
        self._worker = (
            ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"fleet-c{index}"
            )
            if threaded
            else None
        )

    # -- execution -----------------------------------------------------------

    def _run(self, fn, *args):
        if self._worker is None:
            return fn(*args)
        return self._worker.submit(fn, *args).result()

    def _log(self, entry) -> None:
        if self.oplog is not None:
            self.oplog.append(entry)

    def _run_logged(self, entry_of, fn, *args):
        """Execute an op on the worker AND journal it there, so oplog
        order IS execution order even when multiple client threads hit
        the same cluster concurrently (spillover from a sibling's pump
        thread, the stacked-dispatch soak's concurrent offered load). A
        client-side `_log` around `_run` could journal two racing ops in
        the opposite order the worker served them, and the standalone
        replay would then diverge for reasons that are artifacts of the
        journal, not the decisions. `entry_of(result)` builds the entry
        from already-deepcopied inputs."""

        def body():
            result = fn(*args)
            self._log(entry_of(result))
            return result

        return self._run(body)

    # -- ops (public: thread-dispatched + oplogged) --------------------------

    def add_node(self, node) -> None:
        pristine = copy.deepcopy(node)
        self._run_logged(
            lambda _: ("add_node", pristine), self._do_add_node, node
        )

    def schedule(self, pod, node_names=None) -> ExtenderFilterResult:
        pristine = copy.deepcopy(pod)
        if node_names is None:
            node_names = self.group_node_names(
                find_instance_group(pod, self._label) or ""
            )
        names = list(node_names)
        return self._run_logged(
            lambda r: ("schedule", pristine, tuple(names), r),
            self._do_schedule,
            pod,
            names,
        )

    def release(self, pod) -> None:
        """Delete the pod AND its demand — the spillover hand-off's home
        cleanup (and the sibling cleanup after a failed attempt)."""
        pristine = copy.deepcopy(pod)
        self._run_logged(
            lambda _: ("release", pristine), self._do_release, pod
        )

    def terminate_pod(self, pod) -> None:
        pristine = copy.deepcopy(pod)
        self._run_logged(
            lambda _: ("terminate", pristine), self._do_terminate, pod
        )

    def delete_pod(self, pod) -> None:
        pristine = copy.deepcopy(pod)
        self._run_logged(
            lambda _: ("delete_pod", pristine), self._do_delete_pod, pod
        )

    # -- op bodies (single-cluster semantics, worker-thread only) ------------

    def _do_add_node(self, node) -> None:
        self.backend.add_node(node)

    def _do_schedule(self, pod, node_names) -> ExtenderFilterResult:
        if self.backend.get("pods", pod.namespace, pod.name) is None:
            self.backend.add_pod(pod)
        result = self.extender.predicate(
            ExtenderArgs(pod=pod, node_names=node_names)
        )
        if result.ok:
            self.backend.bind_pod(pod, result.node_names[0])
        self.decisions += 1
        return result

    def _do_release(self, pod) -> None:
        self.app.demand_manager.delete_demand_if_exists(pod, source="fleet")
        if self.backend.get("pods", pod.namespace, pod.name) is not None:
            self.backend.delete_pod(pod)

    def _do_terminate(self, pod) -> None:
        cur = self.backend.get("pods", pod.namespace, pod.name)
        if cur is None:
            return
        for c in cur.containers:
            c.terminated = True
        self.backend.update_pod(cur)

    def _do_delete_pod(self, pod) -> None:
        if self.backend.get("pods", pod.namespace, pod.name) is not None:
            self.backend.delete_pod(pod)

    # -- queries -------------------------------------------------------------

    def group_node_names(self, group: str) -> list[str]:
        return [
            n.name
            for n in self.backend.list_nodes()
            if not group or n.labels.get(self._label, "") == group
        ]

    def reservation_specs(self) -> dict:
        """Durable placement state, serialized for byte-for-byte diffing."""
        out = {}
        for rr in self.backend.list(RESERVATIONS_KIND):
            out[(rr.namespace, rr.name)] = {
                pod: (
                    resv.node,
                    resv.resources.cpu_milli,
                    resv.resources.mem_kib,
                    resv.resources.gpu_milli,
                )
                for pod, resv in rr.spec.reservations.items()
            }
        return out

    def stop(self) -> None:
        if self._worker is not None:
            self._worker.shutdown(wait=True)
        self.app.stop()


def _synthesized_unavailable() -> ExtenderFilterResult:
    return ExtenderFilterResult(
        node_names=[],
        failed_nodes={},
        outcome=FAILURE_INTERNAL,
    )


class FleetFacade:
    def __init__(
        self,
        n_clusters: int,
        config: InstallConfig | None = None,
        *,
        clock=None,
        registry=None,
        record_ops: bool = False,
        max_spillover_hops: int = 1,
        suppress_resync: bool = True,
        stack_window_ms: float | None = None,
        device="cuda",
    ):
        if n_clusters < 1:
            raise ValueError("n_clusters must be >= 1")
        base = config or InstallConfig(fifo=True, sync_writes=True)
        self._label = base.instance_group_label
        self.stacks = [
            ClusterStack(
                i,
                copy.deepcopy(base),
                clock=clock,
                record_ops=record_ops,
                suppress_resync=suppress_resync,
                device=device,
            )
            for i in range(n_clusters)
        ]
        self.router = FleetRouter(
            n_clusters, [s.aggregates for s in self.stacks]
        )
        self.telemetry = FleetTelemetry(registry)
        self.spillover = SpilloverCoordinator(
            self.stacks,
            self.router,
            self.telemetry,
            max_hops=max_spillover_hops,
        )
        self.telemetry.on_live(n_clusters)
        self.forwarded = 0
        self.unavailable_denials = 0
        self._lock = threading.RLock()
        # Fused fleet dispatch: when `fleet.stack-window-ms` is > 0, at
        # least two clusters exist and the stacks solve on the CPU, every
        # stack's solver gets the shared FleetDispatchCoordinator as its
        # deferred-dispatch lane: concurrent per-cluster plain windows
        # gather into one stacked call. The key is inert on the card,
        # where the row walk serves every window (the JAX lane defers only
        # non-Pallas windows), so a `cuda` fleet builds no coordinator and
        # reports stacking disabled. None/0 = off: the lane stays None and
        # every serving path is byte-identical to the unstacked fleet.
        if stack_window_ms is None:
            stack_window_ms = base.fleet_stack_window_ms
        self.dispatch = None
        on_card = self.stacks[0].app.solver.device.type == "cuda"
        if (stack_window_ms and stack_window_ms > 0 and n_clusters >= 2
                and not on_card):
            from spark_scheduler_tpu_torch.fleet.dispatch import (
                FleetDispatchCoordinator,
            )

            self.dispatch = FleetDispatchCoordinator(
                stack_window_ms,
                expected=n_clusters,
                telemetry=self.telemetry,
            )
            for s in self.stacks:
                s.app.solver._dispatch_lane = self.dispatch

    # -- topology ------------------------------------------------------------

    def add_node(self, cluster: int, node) -> None:
        self.stacks[cluster].add_node(node)

    def start_background(self) -> None:
        """Start every cluster's background loops: the async write-back
        workers, the unschedulable marker, the demand watcher (and the
        autoscaler where enabled). A fleet served with `sync_writes` off
        needs them on every stack, not only on the stack the HTTP server
        fronts: without them clusters 1..F-1 never write their
        reservations back. Idempotent; `stop` flushes and stops them."""
        for s in self.stacks:
            s.app.start_background()

    def kill_cluster(self, cluster: int) -> int:
        """Remove a cluster from serving. Apps PLACED there (a reservation
        in its backend, or in its cache with the write-back still queued)
        keep their affinity and deny while it is down — re-placing them
        on a sibling would double-place the gang. PENDING apps are
        orphans: their affinity drops so the next retry re-routes to a
        survivor. Returns the orphan count."""
        stack = self.stacks[cluster]
        with self._lock:
            placed = {
                rr.name for rr in stack.backend.list(RESERVATIONS_KIND)
            } | {rr.name for rr in stack.app.rr_cache.list()}
            self.router.members.remove(cluster)
            orphans = self.router.drop_pending_affinity(cluster, placed)
        if self.dispatch is not None:
            # Survivors' gathers must stop waiting on the dead peer, and
            # its own parked window (if any — kill can land mid-gather)
            # resolves via the forced single-window fallback.
            self.dispatch.set_expected(len(self.router.members.live()))
            self.dispatch.expel(self.stacks[cluster].app.solver)
        self.telemetry.on_live(len(self.router.members.live()))
        self.telemetry.on_orphans_rerouted(orphans)
        return orphans

    def rejoin_cluster(self, cluster: int) -> None:
        with self._lock:
            self.router.members.rejoin(cluster)
        if self.dispatch is not None:
            self.dispatch.set_expected(len(self.router.members.live()))
        self.telemetry.on_live(len(self.router.members.live()))

    # -- serving -------------------------------------------------------------

    def schedule(self, pod, node_names=None, via: int | None = None) -> FleetDecision:
        """Serve one predicate + bind cycle, fleet-routed.

        `via` models which cluster endpoint kube-scheduler hit: when the
        pod routes elsewhere the call is forwarded (counted, like the
        ShardMap's wrong-shard forwarding) — the decision bytes are the
        owner's either way.
        """
        app_id = pod.labels.get(SPARK_APP_ID_LABEL, pod.name)
        group = find_instance_group(pod, self._label) or ""
        home, reason = self.router.route(app_id, group)
        self.telemetry.on_pick(reason)
        if via is not None and via != home:
            self.forwarded += 1
            self.telemetry.on_forwarded()
        if not self.router.members.is_live(home):
            # NOT an op in any cluster's stream: the cluster never saw it.
            self.unavailable_denials += 1
            return FleetDecision(
                _synthesized_unavailable(), home, unavailable=True
            )
        result = self.stacks[home].schedule(pod, node_names)
        self.telemetry.on_decision(home)
        if result.ok:
            return FleetDecision(result, home)
        is_driver = pod.labels.get(SPARK_ROLE_LABEL) == ROLE_DRIVER
        if not is_driver or result.outcome != FAILURE_FIT:
            return FleetDecision(result, home)
        return self.spillover.try_spillover(
            pod, app_id, group, home, result
        )

    def schedule_app(self, pods, node_names=None) -> list[FleetDecision]:
        return [self.schedule(p, node_names) for p in pods]

    # -- introspection -------------------------------------------------------

    def state(self) -> dict:
        for s in self.stacks:
            self.telemetry.on_aggregate_events(
                s.index, s.aggregates.events_applied
            )
        return {
            "router": self.router.describe(),
            "spillover": {
                "max_hops": self.spillover.max_hops,
                "spilled": self.spillover.spilled,
                "denied": self.spillover.denied,
            },
            "stacking": (
                self.dispatch.describe()
                if self.dispatch is not None
                else {"enabled": False}
            ),
            "forwarded": self.forwarded,
            "unavailable_denials": self.unavailable_denials,
            "clusters": [
                {
                    "index": s.index,
                    "live": self.router.members.is_live(s.index),
                    "decisions": s.decisions,
                    "aggregates": s.aggregates.stats(),
                }
                for s in self.stacks
            ],
        }

    def stop(self) -> None:
        if self.dispatch is not None:
            # Release any gather still parked on a worker thread before
            # the per-stack shutdown joins those workers.
            self.dispatch.drain()
        for s in self.stacks:
            s.stop()


# -- the equivalence oracle ---------------------------------------------------


def replay_standalone(
    oplog, config: InstallConfig, *, clock=None, device="cuda"
) -> tuple[ClusterStack, list]:
    """Re-serve a cluster's oplog on a fresh STANDALONE stack (no fleet,
    no worker thread) on `device` and return (stack, per-schedule
    results)."""
    stack = ClusterStack(
        0, copy.deepcopy(config), clock=clock, threaded=False,
        device=device,
    )
    results = []
    for entry in oplog:
        kind = entry[0]
        if kind == "add_node":
            stack.add_node(copy.deepcopy(entry[1]))
        elif kind == "schedule":
            results.append(
                stack.schedule(copy.deepcopy(entry[1]), list(entry[2]))
            )
        elif kind == "release":
            stack.release(copy.deepcopy(entry[1]))
        elif kind == "terminate":
            stack.terminate_pod(copy.deepcopy(entry[1]))
        elif kind == "delete_pod":
            stack.delete_pod(copy.deepcopy(entry[1]))
        else:  # pragma: no cover - oplog writers above are exhaustive
            raise ValueError(f"unknown oplog op {kind!r}")
    return stack, results


def verify_cluster_equivalence(facade: FleetFacade, device=None) -> dict:
    """Diff every fleet cluster against a standalone replay of its oplog:
    each decision's (ok, node_names, outcome) and the final durable
    reservation specs must match byte-for-byte. The replay runs on
    `device` (None: the cluster's own device). Returns a per-cluster
    report; raises AssertionError on any mismatch (the in-arm bench
    assertion and the soak's invariant)."""
    report = {}
    for s in facade.stacks:
        if s.oplog is None:
            raise ValueError(
                "facade was not built with record_ops=True"
            )
        fleet_decisions = [
            (e[3].ok, tuple(e[3].node_names), e[3].outcome)
            for e in s.oplog
            if e[0] == "schedule"
        ]
        standalone, results = replay_standalone(
            s.oplog, s.config,
            device=s.device if device is None else device,
        )
        try:
            solo_decisions = [
                (r.ok, tuple(r.node_names), r.outcome) for r in results
            ]
            assert fleet_decisions == solo_decisions, (
                f"cluster {s.index}: fleet decisions diverge from "
                f"standalone replay"
            )
            fleet_specs = s.reservation_specs()
            solo_specs = standalone.reservation_specs()
            assert fleet_specs == solo_specs, (
                f"cluster {s.index}: reservation state diverges from "
                f"standalone replay"
            )
        finally:
            standalone.stop()
        report[s.index] = {
            "decisions": len(fleet_decisions),
            "reservations": len(s.reservation_specs()),
            "identical": True,
        }
    return report
