"""Soak engines of the port: the randomized invariant soak and its chaos,
HA and fleet drivers.

The port's copy of spark_scheduler_tpu/testing/soak.py, every engine of it:

- `Soak`: a seeded random sequence of driver and executor arrivals,
  executor deaths, app teardowns, node add / cordon / delete, forced
  reconciles, write faults and idempotent retries through pipelined
  serving windows (dispatch before fetch, depth 2, the batcher's loop
  shape). With `elastic=True` it adds gangs too big for the cluster and
  autoscaler passes across a `SoakClock`. It asserts as it goes: no node
  over-committed; every admitted gang holds exactly its reservation; the
  drained availability mirror equals the host truth; a retried driver
  never moves or double-books; the flight recorder agrees with every
  placement; and, elastic, no reserved node is ever drained.
- `ChaosMatrixSoak`: `Soak` under one seeded `FaultPlan` per surface
  family (backend, kube, wal, device, lease) through faults/injector.py.
- `HAChaosSoak`: two replicas (ha/replica.py) over one shared backend,
  the leader killed with a window in flight; the dead leader's commit
  must be fenced.
- `PolicySoak`: sustained high-priority pressure against low-priority
  gangs through the policy engine.
- `FleetSoak`: gangs across F clusters behind one `FleetFacade`, one
  cluster killed and rejoined; every cluster must replay byte-identical.

Every engine takes `device=` and hands it to `Harness`, `build_replica` or
`FleetFacade`: the card by default, "cpu" in tests. On the card every
window is served by the row-walk kernel (ops/window.py); the `device`
chaos surface injects an h2d fault, whose window the host greedy serves.
`fleet.stack-window-ms` is inert on the card (no coordinator is built), so
there `FleetSoak`'s stacking mode runs its concurrent bursts unstacked and
its verdict reads `"stacking": {"enabled": False}`.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from spark_scheduler_tpu_torch.core.extender import ExtenderArgs
from spark_scheduler_tpu_torch.core.solver import PipelineDrainRequired
from spark_scheduler_tpu_torch.testing.harness import (
    Harness,
    dynamic_allocation_spark_pods,
    new_node,
    overcommit_violations,
    static_allocation_spark_pods,
)

CHECK_EVERY = 50  # full invariant sweep cadence (every step would be O(n^2))


class SoakClock:
    """Monotonic wall clock with a manual offset. Real elapsed time flows
    through (so demand-to-fulfilled latencies the bench reports are real),
    while elastic ops advance the offset to cross the drainer's idle TTL
    deterministically without sleeping."""

    def __init__(self):
        self._offset = 0.0

    def __call__(self) -> float:
        return time.monotonic() + self._offset

    def advance(self, dt: float) -> None:
        self._offset += dt


class Soak:
    def __init__(
        self, rng, strategy, n_nodes: int = 12, elastic: bool = False,
        backend=None, trace_path=None, device="cuda",
    ):
        self.rng = rng
        self.elastic = elastic
        self.clock = SoakClock() if elastic else None
        # Decision-trace capture: route the whole run through the live
        # TraceWriter wiring so a replay can check it bit for bit.
        trace_kw = {"trace_path": trace_path} if trace_path else {}
        # same_az under single-az strategies: without it the extender's
        # zone-restriction gate (is_single_az AND same-az-dynalloc config)
        # stays False and the zone-restricted executor-reschedule ladder —
        # the very path the single-az matrix slot exists to soak — never
        # executes.
        elastic_kw = (
            dict(
                autoscaler_enabled=True,
                # Low enough that autoscaler_tick ops cross it; real drains
                # happen mid-soak and provisioned capacity recycles.
                autoscaler_idle_ttl_s=30.0,
                # Headroom for several bursts, low enough that a busy run
                # exercises the cannot-fulfill cap path too.
                autoscaler_max_cluster_size=n_nodes + 48,
                autoscaler_zones=["zone0", "zone1", "zone2"],
                clock=self.clock,
            )
            if elastic
            else {}
        )
        self.h = Harness(
            binpack_algo=strategy, fifo=True,
            same_az_dynamic_allocation="single-az" in strategy,
            # Injected backend (e.g. a DurableBackend so the chaos matrix
            # can fault the WAL surface); default in-memory.
            backend=backend,
            device=device,
            **trace_kw,
            **elastic_kw,
        )
        self.trace = self.h.app.trace_writer
        self.node_seq = 0
        self.nodes: dict[str, object] = {}
        for _ in range(n_nodes):
            self._add_node()
        self.app_seq = 0
        # app_id -> {"driver": Pod, "execs": [Pod], "node": str,
        #            "min": int, "bound": {pod_name: node}}
        self.admitted: dict[str, dict] = {}
        self.pending_tickets = []  # pipelined windows in flight (max 2)
        self.ext = self.h.extender
        self.steps = 0
        self.op_counts: dict[str, int] = {}

    # ---------------------------------------------------------------- ops

    def _add_node(self):
        name = f"sn{self.node_seq}"
        self.node_seq += 1
        node = new_node(name, zone=f"zone{self.node_seq % 3}")
        self.h.add_nodes(node)
        self.nodes[name] = node

    def node_names(self):
        if self.elastic:
            # Elastic topology is backend truth: autoscaled nodes join the
            # candidate set, drained ones leave it.
            return [n.name for n in self.h.backend.list_nodes()]
        return list(self.nodes)

    def _dispatch(self, args_list):
        """Dispatch a window, draining the pipeline on topology changes the
        way the serving loop does (PipelineDrainRequired contract)."""
        for _ in range(3):
            try:
                t = self.ext.predicate_window_dispatch(args_list)
                self.pending_tickets.append(t)
                return
            except PipelineDrainRequired:
                self.drain()
        raise AssertionError("dispatch kept raising PipelineDrainRequired")

    def _complete_oldest(self):
        t = self.pending_tickets.pop(0)
        results = self.ext.predicate_window_complete(t)
        for args, res in zip(t.args_list, results):
            pod = args.pod
            role = pod.labels.get("spark-role", "")
            app_id = pod.labels.get("spark-app-id", "")
            if not res.ok:
                continue
            node = res.node_names[0]
            if role == "driver":
                entry = self.admitted.get(app_id)
                if entry is None:
                    # tracked by the op that submitted it
                    continue
                entry["node"] = node
                if self.h.backend.get("pods", pod.namespace, pod.name) is not None:
                    self.h.backend.bind_pod(pod, node)
            elif role == "executor":
                entry = self.admitted.get(app_id)
                if entry is not None:
                    entry["bound"][pod.name] = node
                # The app may have been torn down while this window was in
                # flight (its pods deleted) — a dead pod can't bind.
                if self.h.backend.get("pods", pod.namespace, pod.name) is not None:
                    self.h.backend.bind_pod(pod, node)
        return results

    def drain(self):
        while self.pending_tickets:
            self._complete_oldest()

    def op_submit_drivers(self):
        if len(self.admitted) > 24:
            # Bound the pending-driver population: unbounded FIFO prefixes
            # grow every later request's hypothetical rows (and the row
            # buckets) without adding coverage.
            self.op_teardown_app()
            return
        k = int(self.rng.integers(1, 4))
        args = []
        for _ in range(k):
            app_id = f"app-{self.app_seq}"
            self.app_seq += 1
            execs = int(self.rng.integers(1, 5))
            if self.rng.random() < 0.3:
                pods = dynamic_allocation_spark_pods(
                    app_id, execs, execs + int(self.rng.integers(1, 3))
                )
            else:
                pods = static_allocation_spark_pods(app_id, execs)
            self.h.add_pods(pods[0])
            self.admitted[app_id] = {
                "driver": pods[0], "execs": pods[1:], "node": None,
                "min": execs, "bound": {},
            }
            args.append(
                ExtenderArgs(pod=pods[0], node_names=self.node_names())
            )
        self._dispatch(args)
        if len(self.pending_tickets) > 2 or self.rng.random() < 0.6:
            self._complete_oldest()

    def op_submit_executors(self):
        ready = [
            (a, e) for a, e in self.admitted.items() if e["node"] is not None
        ]
        if not ready:
            return
        args = []
        for _ in range(int(self.rng.integers(1, 5))):
            app_id, entry = ready[int(self.rng.integers(0, len(ready)))]
            unsubmitted = [
                p for p in entry["execs"] if p.name not in entry["bound"]
            ]
            if not unsubmitted:
                continue
            pod = unsubmitted[int(self.rng.integers(0, len(unsubmitted)))]
            self.h.add_pods(pod)
            names = self.node_names()
            if self.rng.random() < 0.2:  # restricted candidates: reschedule
                self.rng.shuffle(names)
                names = names[: max(3, len(names) // 2)]
            args.append(ExtenderArgs(pod=pod, node_names=names))
        if not args:
            return
        self._dispatch(args)
        self._complete_oldest()

    def op_kill_executor(self):
        apps = [e for e in self.admitted.values() if e["bound"]]
        if not apps:
            return
        entry = apps[int(self.rng.integers(0, len(apps)))]
        name = list(entry["bound"])[0]
        pod = next(p for p in entry["execs"] if p.name == name)
        cur = self.h.backend.get("pods", pod.namespace, pod.name)
        if cur is not None:
            self.h.terminate_pod(cur)
        del entry["bound"][name]

    def op_teardown_app(self):
        if not self.admitted:
            return
        app_id = list(self.admitted)[int(self.rng.integers(0, len(self.admitted)))]
        entry = self.admitted.pop(app_id)
        for p in [entry["driver"]] + entry["execs"]:
            cur = self.h.backend.get("pods", p.namespace, p.name)
            if cur is not None:
                self.h.backend.delete_pod(cur)
        rr = self.h.get_reservation("namespace", app_id)
        if rr is not None:
            self.h.app.rr_cache.delete(rr.namespace, rr.name)
            if self.trace is not None:
                # Operator-initiated RR deletion is an INPUT: the trace
                # writer's backend hooks only watch nodes/pods (scheduler-
                # originated RR writes are outputs), so journal it here.
                self.trace.emit_rr_delete(rr.namespace, rr.name)

    def op_node_churn(self):
        self.drain()  # topology changes force a drain in the serving loop
        r = self.rng.random()
        if r < 0.5 or len(self.nodes) < 8:
            self._add_node()
        elif r < 0.8:
            # cordon/uncordon with a REPLACEMENT object, like the real
            # watch path — an in-place mutation would defeat the solver's
            # identity-based arena sync and test nothing.
            import dataclasses as _dc

            name = list(self.nodes)[int(self.rng.integers(0, len(self.nodes)))]
            node = _dc.replace(
                self.nodes[name],
                unschedulable=not self.nodes[name].unschedulable,
            )
            self.nodes[name] = node
            self.h.backend.update("nodes", node)
        else:
            # delete a node with no reservations on it (hard OR soft)
            used = set()
            for rr in self.h.app.rr_cache.list():
                for res in rr.spec.reservations.values():
                    used.add(res.node)
            for _app_id, sr in self.h.app.soft_store.get_all_copy().items():
                for r in sr.reservations.values():
                    used.add(r.node)
            free = [n for n in self.nodes if n not in used]
            if free:
                name = free[int(self.rng.integers(0, len(free)))]
                self.h.backend.delete("nodes", "", name)
                del self.nodes[name]

    def op_reconcile(self):
        self.drain()
        if self.ext._reconciler is not None:
            self.ext._reconciler.sync_resource_reservations_and_demands()
            if self.trace is not None:
                self.trace.emit_reconcile()

    def op_write_fault(self):
        """One faulted reservation write: the request fails internal and
        nothing may double-book afterwards. Runs through the unified
        FaultInjector: a one-shot error spec on the reservation-write
        surface."""
        from spark_scheduler_tpu_torch.faults import FaultInjector, FaultPlan, FaultSpec

        plan = FaultPlan(
            seed=int(self.rng.integers(0, 2**31)),
            name="soak-write-fault",
            specs=[
                FaultSpec(
                    surface="backend.resourcereservations.*",
                    mode="error",
                    limit=1,
                    error=lambda: RuntimeError("soak-injected write fault"),
                )
            ],
        )
        with FaultInjector(plan) as inj:
            inj.install_backend(self.h.backend)
            self.op_submit_drivers()
            self.drain()
        # The faulted app (if any) got failure-internal; forget our intent
        # for apps that have no reservation so invariant #2 stays exact.
        for app_id in list(self.admitted):
            e = self.admitted[app_id]
            if e["node"] is None and self.h.get_reservation(
                "namespace", app_id
            ) is None:
                del self.admitted[app_id]

    def op_idempotent_retry(self):
        ready = [
            (a, e) for a, e in self.admitted.items() if e["node"] is not None
        ]
        if not ready:
            return
        app_id, entry = ready[int(self.rng.integers(0, len(ready)))]
        before = {
            k: (v.node)
            for k, v in self.h.get_reservation(
                "namespace", app_id
            ).spec.reservations.items()
        }
        res = self.ext.predicate(
            ExtenderArgs(pod=entry["driver"], node_names=self.node_names())
        )
        assert res.ok and res.node_names[0] == entry["node"], (
            "idempotent retry moved the driver",
            app_id, res, entry["node"],
        )
        after = {
            k: (v.node)
            for k, v in self.h.get_reservation(
                "namespace", app_id
            ).spec.reservations.items()
        }
        assert before == after, ("retry changed reservations", app_id)

    # ------------------------------------------------------- elastic ops

    def _assert_no_reserved_drained(self):
        """THE drain-safety invariant: after any autoscaler pass, every node
        a hard or soft reservation names must still exist."""
        known = {n.name for n in self.h.backend.list_nodes()}
        reserved = self.h.autoscaler.drainer.reserved_node_names()
        missing = reserved - known
        assert not missing, ("reserved node drained", missing, self.steps)

    def op_elastic_burst(self):
        """A gang too large for current free capacity: the failed admission
        creates a Demand, the autoscaler provisions nodes for it, and the
        retried driver should land on them. Each burst moves the node count
        across the solver's padding buckets (_bucket(capacity, 8)) under
        load — the recompile-boundary churn this soak mode exists for."""
        self.drain()
        execs = int(self.rng.integers(8, 17))
        app_id = f"burst-{self.app_seq}"
        self.app_seq += 1
        pods = static_allocation_spark_pods(app_id, execs)
        self.h.add_pods(pods[0])
        self.admitted[app_id] = {
            "driver": pods[0], "execs": pods[1:], "node": None,
            "min": execs, "bound": {},
        }
        for attempt in range(3):
            res = self.ext.predicate(
                ExtenderArgs(pod=pods[0], node_names=self.node_names())
            )
            if res.ok:
                self.admitted[app_id]["node"] = res.node_names[0]
                self.h.backend.bind_pod(pods[0], res.node_names[0])
                return
            # Demand emitted for the failed fit -> provision -> retry. The
            # retry may still fail (FIFO earlier drivers, or the cap) —
            # the global invariants cover both outcomes.
            self.h.autoscaler.run_once()
            self._assert_no_reserved_drained()

    def op_autoscaler_tick(self):
        """One autoscaler control-loop pass after a clock jump: sub-TTL
        jumps exercise idle tracking and cordons-in-progress, super-TTL
        jumps complete drains. Reserved nodes must survive every pass."""
        self.drain()  # topology may change: serving loop would drain too
        ttl = self.h.autoscaler.drainer.idle_ttl_s
        self.clock.advance(ttl * (0.6 if self.rng.random() < 0.5 else 1.1))
        self.h.autoscaler.run_once()
        self._assert_no_reserved_drained()

    # --------------------------------------------------------- invariants

    def check_invariants(self):
        # 1. no node over-committed (reservations + overhead <= allocatable)
        #    — the ONE shared definition (testing/harness.py).
        violations = overcommit_violations(self.h.app, self.h.backend)
        assert not violations, ("over-commit", violations, self.steps)
        # 2. every admitted gang has exactly its reservation
        for app_id, entry in self.admitted.items():
            if entry["node"] is None:
                continue
            rr = self.h.get_reservation("namespace", app_id)
            assert rr is not None, ("admitted app lost its RR", app_id)
            assert rr.spec.reservations["driver"].node == entry["node"], (
                "driver slot moved", app_id)
            exec_slots = [k for k in rr.spec.reservations if k != "driver"]
            assert len(exec_slots) == entry["min"], (
                "executor slot count", app_id)
        # 5. flight-recorder cross-check: recorded verdicts match actual
        #    placements (every checkpoint pass, observability contract).
        self.check_recorder()

    def check_recorder(self):
        """Recorded verdict == actual placement: the newest driver record
        of every admitted app is a success naming the reserved node, and
        every denied record carries its per-node failure-reason map. The
        soak is the one place windowed, solo, retried, and faulted
        admissions all flow through the recorder under churn."""
        rec = self.h.app.recorder
        if rec is None:
            return
        for app_id, entry in self.admitted.items():
            if entry["node"] is None:
                continue
            r = rec.latest_for_app("namespace", app_id, role="driver")
            if r is None:
                # The ring is bounded: a very long soak can evict an early
                # admission's record while the app stays admitted. Only a
                # missing record with ZERO evictions is a real failure —
                # once the ring has dropped records, absence is expected.
                assert rec.stats()["dropped"] > 0, (
                    "admitted app has no decision record",
                    app_id, self.steps,
                )
                continue
            assert r.verdict == "success" and r.node == entry["node"], (
                "recorded verdict diverges from placement",
                app_id, r.verdict, r.node, entry["node"], self.steps,
            )
        for d in rec.query(verdict="failure-*", limit=25):
            assert d["node"] is None and d["failed_nodes"], (
                "denied record lacks its failure map", d, self.steps)

    def check_drained_mirror(self):
        """Invariant 3: with the pipeline drained, the device-embodied
        availability mirror equals the host truth."""
        self.drain()
        solver = self.h.app.solver
        if solver._pipe is None:
            return
        backend = self.h.backend
        all_nodes = backend.list_nodes()
        usage = self.h.app.reservation_manager.reserved_usage()
        overhead = self.h.app.overhead_computer.get_overhead(all_nodes)
        tensors = solver.build_tensors_pipelined(
            all_nodes, usage, overhead,
            topo_version=getattr(backend, "nodes_version", None),
        )
        host = getattr(tensors, "host", tensors)
        # Copies, never views: the host fields may alias the native
        # arena's resident buffers, which the next build patches in place.
        truth = np.array(host.available, dtype=np.int64, copy=True)
        mirror = np.array(solver._pipe["mirror"], dtype=np.int64, copy=True)
        assert np.array_equal(truth, mirror), (
            "drained mirror diverges from host truth", self.steps)

    # -------------------------------------------------------------- drive

    OPS = (
        ("submit_drivers", 30, op_submit_drivers),
        ("submit_executors", 30, op_submit_executors),
        ("kill_executor", 10, op_kill_executor),
        ("teardown_app", 8, op_teardown_app),
        ("node_churn", 6, op_node_churn),
        ("reconcile", 4, op_reconcile),
        ("write_fault", 4, op_write_fault),
        ("idempotent_retry", 8, op_idempotent_retry),
    )
    ELASTIC_OPS = (
        ("elastic_burst", 8, op_elastic_burst),
        ("autoscaler_tick", 10, op_autoscaler_tick),
    )

    def run(self, steps):
        ops = self.OPS + (self.ELASTIC_OPS if self.elastic else ())
        if self.trace is not None:
            # Injected faults are not part of the replayable input surface
            # (replay has no FaultInjector schedule), so a recorded soak
            # drives every op EXCEPT write faults.
            ops = tuple(o for o in ops if o[0] != "write_fault")
        names = [name for name, w, _ in ops for _ in range(w)]
        fns = {name: fn for name, _, fn in ops}
        while self.steps < steps:
            self.steps += 1
            name = names[int(self.rng.integers(0, len(names)))]
            self.op_counts[name] = self.op_counts.get(name, 0) + 1
            fns[name](self)
            if self.steps % CHECK_EVERY == 0:
                self.drain()
                self.check_invariants()
            if self.steps % (CHECK_EVERY * 4) == 0:
                self.check_drained_mirror()
        self.drain()
        self.check_invariants()
        self.check_drained_mirror()


# ------------------------------------------------------------ chaos matrix


class ChaosMatrixSoak:
    """The chaos matrix: the randomized Soak workload run under ONE
    seeded FaultPlan per surface family — {backend, kube, wal, device,
    lease} — through the unified FaultInjector. Per run it asserts the
    engine's scheduling invariants (zero double placements, zero
    reservation over-commits), that faulted work was RETRIED or FENCED
    rather than silently dropped (write-back `dropped == 0`; the WAL leg
    additionally replays the log into a fresh backend and requires it to
    equal live reservation truth), and that per-step latency stays under
    `step_budget_s` (bounded spikes, not stalls). The verdict dict holds
    only DETERMINISTIC fields: the same seed yields the same fault
    schedule and the same verdict.

    Surface families:
      backend  reservation/demand mutations error under the apiserver's
               lock (the write-back retry ladder absorbs them)
      kube     the async write-back client's drained requests error
               (p-faults AND a contiguous partition window shorter than
               the retry budget)
      wal      DurableBackend appends/fsyncs fail; parked records must
               reach the log anyway (durable._wal_pending)
      device   a device h2d dies mid-soak; the window is served by the
               degraded greedy fallback and the device path recovers
      lease    a LeaseManager's store blips under the soak; the retry
               ladder must absorb the faults without a spurious deposition
    """

    SURFACES = ("backend", "kube", "wal", "device", "lease")

    @staticmethod
    def plan_for(surface: str, seed: int):
        """The shipped chaos-matrix plan for one surface family. Bounded
        (`limit`) so every plan also tests RECOVERY: the workload must
        return to steady state after the last scheduled fault."""
        from spark_scheduler_tpu_torch.faults import FaultPlan, FaultSpec

        specs = {
            "backend": [
                FaultSpec(surface="backend.resourcereservations.*",
                          mode="error", p=0.15, limit=10),
                FaultSpec(surface="backend.demands.*",
                          mode="error", p=0.2, limit=6),
            ],
            "kube": [
                FaultSpec(surface="kube.write.*", mode="error",
                          p=0.1, limit=8),
                # A dead-apiserver window: 3 consecutive drained writes
                # fail — shorter than the retry budget, so every one is
                # absorbed by requeues, never dropped.
                FaultSpec(surface="kube.write.*", mode="partition",
                          start=20, length=3, limit=3),
            ],
            "wal": [
                # Reservation/demand appends only: the soak's DIRECT pod
                # and node fixture writes are scaffolding with no retry
                # ladder in front of them — the serving paths are what
                # the leg probes.
                FaultSpec(surface="wal.append.resourcereservations",
                          mode="error", every=7, limit=5),
                FaultSpec(surface="wal.append.demands",
                          mode="error", p=0.3, limit=3),
                FaultSpec(surface="wal.fsync.resourcereservations",
                          mode="error", at=[3], limit=1),
            ],
            "device": [
                # The 3rd h2d dies (tunnel drop mid-soak): that window is
                # served by the host greedy fallback; the next dispatch
                # recovers the device path.
                FaultSpec(surface="device.h2d", mode="error",
                          at=[2], limit=1),
            ],
            "lease": [
                FaultSpec(surface="lease.read", mode="error",
                          p=0.2, limit=8),
                FaultSpec(surface="lease.write", mode="error",
                          p=0.2, limit=6),
            ],
        }[surface]
        return FaultPlan(seed=seed, name=f"matrix-{surface}", specs=specs)

    def __init__(
        self,
        surface: str,
        seed: int = 0,
        strategy: str = "tightly-pack",
        n_nodes: int = 12,
        wal_path: str | None = None,
        step_budget_s: float = 60.0,
        plan=None,
        device="cuda",
    ):
        import numpy as _np

        from spark_scheduler_tpu_torch.faults import FaultInjector

        assert surface in self.SURFACES, surface
        self.surface = surface
        self.seed = seed
        self.plan = plan if plan is not None else self.plan_for(surface, seed)
        self.injector = FaultInjector(self.plan)
        self.step_budget_s = step_budget_s
        self.wal_path = wal_path
        backend = None
        if surface == "wal":
            assert wal_path, "the wal leg needs a log path"
            from spark_scheduler_tpu_torch.store.durable import DurableBackend

            backend = DurableBackend(wal_path)
        self.soak = Soak(
            _np.random.default_rng(seed), strategy, n_nodes=n_nodes,
            backend=backend, device=device,
        )
        self.step_times: list[float] = []
        self.lease_mgr = None
        self.lease_io_errors = 0
        self.lease_renews_ok = 0

    # -- per-surface wiring -------------------------------------------------

    def _install(self) -> None:
        inj, h = self.injector, self.soak.h
        if self.surface == "backend":
            inj.install_backend(h.backend)
        elif self.surface == "kube":
            inj.install_async_client(h.app.rr_cache.client)
        elif self.surface == "wal":
            inj.install_wal(h.backend)
        elif self.surface == "device":
            inj.install_device()
        elif self.surface == "lease":
            from spark_scheduler_tpu_torch.ha.lease import (
                BackendLeaseStore,
                LeaseManager,
            )

            self.lease_mgr = LeaseManager(
                inj.lease_store(BackendLeaseStore(h.backend)),
                "matrix-holder",
                ttl_s=3600.0,  # nothing may depose it but a real failure
            )
            assert self.lease_mgr.try_acquire()

    def _lease_tick(self) -> None:
        try:
            if self.lease_mgr.renew():
                self.lease_renews_ok += 1
        except Exception:
            # Retry-exhausted store IO. The lease itself is NOT lost — the
            # epoch is only moved by a successful takeover.
            self.lease_io_errors += 1

    # -- drive --------------------------------------------------------------

    def run(self, steps: int) -> dict:
        s = self.soak
        names = [name for name, w, _ in s.OPS for _ in range(w)]
        fns = {name: fn for name, _, fn in s.OPS}
        with self.injector:
            self._install()
            while s.steps < steps:
                s.steps += 1
                name = names[int(s.rng.integers(0, len(names)))]
                s.op_counts[name] = s.op_counts.get(name, 0) + 1
                t0 = time.perf_counter()
                fns[name](s)
                if self.lease_mgr is not None:
                    self._lease_tick()
                self.step_times.append(time.perf_counter() - t0)
                if s.steps % CHECK_EVERY == 0:
                    s.drain()
                    s.check_invariants()
            s.drain()
            s.check_invariants()
            s.check_drained_mirror()
        return self._verdict(steps)

    # -- verdict ------------------------------------------------------------

    def _verdict(self, steps: int) -> dict:
        s = self.soak
        client = s.h.app.rr_cache.client
        # Never silently dropped: every faulted write-back was absorbed by
        # its bounded requeue (the plans stay under the retry budget by
        # construction — a plan that can exhaust it must pair with an
        # on_error consumer, not silence).
        assert client.metrics.dropped == 0, (
            "chaos matrix dropped write-back work",
            self.surface, client.metrics.dropped,
        )
        # Bounded spikes: no single step may stall the serving loop.
        worst = max(self.step_times) if self.step_times else 0.0
        assert worst < self.step_budget_s, (
            "chaos-matrix step exceeded the latency budget",
            self.surface, worst, self.step_budget_s,
        )
        verdict = {
            "surface": self.surface,
            "seed": self.seed,
            "plan": self.plan.name,
            "steps": steps,
            "op_counts": dict(s.op_counts),
            "apps": s.app_seq,
            "fired": dict(self.injector.fired),
            "schedule": self.injector.schedule(),
            "write_back": {
                "retries": client.metrics.retries,
                "dropped": client.metrics.dropped,
            },
        }
        if self.surface == "device":
            solver = s.h.app.solver
            deg = solver.degraded
            snap = deg.snapshot() if deg is not None else {}
            # The faulted window was served (fallback), and the device
            # path recovered once the plan's faults exhausted.
            assert snap.get("fallback_decisions", 0) > 0, snap
            assert not (deg is not None and deg.active), (
                "device path never recovered", snap
            )
            verdict["device"] = {
                "fallback_decisions": snap.get("fallback_decisions"),
                "engagements": snap.get("engagements"),
            }
        if self.surface == "wal":
            verdict["wal"] = self._check_wal_durability()
        if self.surface == "lease":
            mgr = self.lease_mgr
            # Transient store blips never depose a healthy holder: the
            # epoch this manager acquired is still the live record's.
            assert mgr.acquired_epoch == 1, mgr.state()
            assert self.lease_renews_ok > 0
            verdict["lease"] = {
                "renews_ok": self.lease_renews_ok,
                "io_errors": self.lease_io_errors,
            }
        return verdict

    def _check_wal_durability(self) -> dict:
        """Append-faulted records must still reach the log: flush parked
        records, replay the log into a FRESH backend, and require its
        reservation truth to equal the live backend's."""
        from spark_scheduler_tpu_torch.store.durable import DurableBackend

        live = self.soak.h.backend
        flushed = live.wal_flush()
        assert not live._wal_pending
        replayed = DurableBackend(self.wal_path, compact_on_load=False)
        def rr_truth(b):
            return {
                (rr.namespace, rr.name): {
                    k: v.node for k, v in rr.spec.reservations.items()
                }
                for rr in b.list("resourcereservations")
            }
        assert rr_truth(replayed) == rr_truth(live), (
            "WAL replay diverges from live truth after append faults"
        )
        replayed.close()
        return {
            "append_failures": live.wal_append_failures,
            "flushed_at_end": flushed,
        }


# ---------------------------------------------------------------- HA chaos


class HAChaosSoak:
    """Leader-kill chaos engine: N replicas (ha/replica.py) over
    ONE shared backend; driver bursts hit the current leader; mid-burst
    the leader is KILLED with a window in flight; after the lease TTL a
    warm standby promotes (reconcile-before-serve) and the burst
    continues; the dead leader's in-flight commit is then completed and
    must be FENCED (epoch moved at takeover) instead of double-placing.

    Asserted per cycle:
      - zero double placements: every admitted app has exactly ONE
        reservation whose driver slot names the node the SURVIVING
        leader answered (the dead leader's conflicting commit was
        rejected at the durability layer);
      - zero reservation-invariant violations (the shared
        overcommit_violations definition);
      - bounded placement-latency spike: the first post-failover decision
        completes within `spike_budget_s` wall seconds of the kill
        (promotion + retry, the TTL itself is crossed on the virtual
        clock).

    The kill itself rides the unified FaultInjector: the
    `replica.kill` surface is fired once per cycle and the PLAN decides
    whether the leader dies — the default plan kills every cycle (the
    original hardcoded behavior); a seeded plan with `p`/`at` makes the
    kill schedule stochastic-but-replayable, and cycles the plan spares
    run the same staged windows to completion on the live leader (steady
    control arm). Plans carrying `lease.*` specs additionally wrap every
    replica's lease store in FaultyLeaseStore, so store blips ride the
    takeover itself.
    """

    def __init__(
        self,
        strategy: str = "tightly-pack",
        n_nodes: int = 16,
        ttl_s: float = 3.0,
        spike_budget_s: float = 30.0,
        backend=None,
        max_live_apps: int = 18,
        fault_plan=None,
        device="cuda",
    ):
        from spark_scheduler_tpu_torch.faults import FaultInjector, FaultPlan, FaultSpec
        from spark_scheduler_tpu_torch.ha.replica import build_replica
        from spark_scheduler_tpu_torch.server.config import InstallConfig
        from spark_scheduler_tpu_torch.store.backend import DEMAND_CRD, InMemoryBackend
        from spark_scheduler_tpu_torch.testing.harness import (
            INSTANCE_GROUP_LABEL,
            new_node,
        )

        if fault_plan is None:
            # The legacy contract: every cycle kills its leader.
            fault_plan = FaultPlan(
                seed=0, name="ha-kill-every-cycle",
                specs=[FaultSpec(surface="replica.kill", mode="error")],
            )
        self.injector = FaultInjector(fault_plan)
        self._fault_leases = any(
            s.surface.startswith("lease") for s in fault_plan.specs
        )
        self.kills = 0
        self.spared_cycles = 0
        self.backend = backend if backend is not None else InMemoryBackend()
        self.backend.register_crd(DEMAND_CRD)
        self.clock = SoakClock()
        self.ttl_s = ttl_s
        self.spike_budget_s = spike_budget_s
        self._config = lambda: InstallConfig(
            fifo=True,
            binpack_algo=strategy,
            instance_group_label=INSTANCE_GROUP_LABEL,
            sync_writes=True,
            ha_enabled=True,
            ha_lease_ttl_s=ttl_s,
        )
        def _build(rid):
            r = build_replica(
                self.backend, rid, config=self._config(), clock=self.clock,
                device=device,
            )
            if self._fault_leases and r.lease is not None:
                r.lease._store = self.injector.lease_store(r.lease._store)
            return r

        self._build = _build
        for i in range(n_nodes):
            self.backend.add_node(new_node(f"hn{i}", zone=f"zone{i % 3}"))
        self.node_names = [f"hn{i}" for i in range(n_nodes)]
        self._replica_seq = 2
        self.replicas = [self._build("replica-0"), self._build("replica-1")]
        assert self.replicas[0].lease.try_acquire()
        self.replicas[0].promote()
        self.app_seq = 0
        # app_id -> node the SURVIVING leader answered (live apps only —
        # completed apps retire so an arbitrary-cycle soak runs at bounded
        # state instead of exhausting the fixed fleet)
        self.placed: dict[str, str] = {}
        self.max_live_apps = max_live_apps
        self.total_placed = 0
        self.retired = 0
        self.driver_pods: dict[str, object] = {}
        self.steady_latencies: list[float] = []
        self.failover_spikes: list[float] = []
        self.fenced_drops = 0
        self.promotions = 0

    # -- plumbing ----------------------------------------------------------

    @property
    def leader(self):
        for r in self.replicas:
            if r.is_serving():
                return r
        raise AssertionError("no serving replica")

    @property
    def standby(self):
        for r in self.replicas:
            if not r._dead and not r.is_serving():
                return r
        raise AssertionError("no standby replica")

    def _new_app(self, execs: int = 2):
        from spark_scheduler_tpu_torch.testing.harness import (
            static_allocation_spark_pods,
        )

        app_id = f"chaos-{self.app_seq}"
        self.app_seq += 1
        pods = static_allocation_spark_pods(app_id, execs)
        self.backend.add_pod(pods[0])
        self.driver_pods[app_id] = pods[0]
        return app_id, pods[0]

    def _serve_driver(self, runtime, pod, record=None) -> str:
        from spark_scheduler_tpu_torch.core.extender import ExtenderArgs

        t0 = time.perf_counter()
        res = runtime.app.extender.predicate(
            ExtenderArgs(pod=pod, node_names=list(self.node_names))
        )
        if record is not None:
            record.append(time.perf_counter() - t0)
        assert res.ok, (pod.name, res.outcome, res.failed_nodes and next(iter(res.failed_nodes.values())))
        node = res.node_names[0]
        self.backend.bind_pod(pod, node)
        return node

    # -- one chaos cycle ---------------------------------------------------

    def run_cycle(self, burst: int = 4, inflight: int = 2) -> None:
        from spark_scheduler_tpu_torch.core.extender import ExtenderArgs

        leader = self.leader
        # Steady phase: admit a burst on the live leader.
        for _ in range(burst):
            app_id, driver = self._new_app()
            self.placed[app_id] = self._serve_driver(
                leader, driver, self.steady_latencies
            )
            self.total_placed += 1
        # Stage the kill: dispatch (but do not complete) a window of fresh
        # gangs on the soon-dead leader — the async fire-and-forget commit
        # the fencing epoch exists for. Half are RETRIED by their client on
        # the new leader (the tailer makes the dead commit an idempotent
        # no-op); the rest are ORPHANS only the dead leader ever saw —
        # their commit is a brand-new reservation write and MUST be fenced
        # at the durability layer.
        staged = [self._new_app() for _ in range(inflight)]
        orphans = [self._new_app() for _ in range(max(1, inflight // 2))]
        ticket = leader.app.extender.predicate_window_dispatch(
            [
                ExtenderArgs(pod=p, node_names=list(self.node_names))
                for _aid, p in staged + orphans
            ]
        )
        # The kill decision is the fault plan's (replica.kill surface):
        # an InjectedFault IS the crash; a spared cycle completes the
        # same staged window on the live leader (steady control arm).
        from spark_scheduler_tpu_torch.faults import InjectedFault

        try:
            self.injector.fire("replica.kill")
            kill = False
        except InjectedFault:
            kill = True
        if not kill:
            self.spared_cycles += 1
            results = leader.app.extender.predicate_window_complete(ticket)
            for (app_id, driver), res in zip(staged + orphans, results):
                assert res.ok, (app_id, res.outcome)
                node = res.node_names[0]
                self.backend.bind_pod(driver, node)
                self.placed[app_id] = node
                self.total_placed += 1
            self._retire_oldest()
            self.check_invariants()
            return
        self.kills += 1
        kill_t0 = time.perf_counter()
        leader.kill()
        drops_before = leader.app.rr_cache.client.metrics.dropped
        # The lease must EXPIRE (no clean release on a crash).
        self.clock.advance(self.ttl_s * 1.5)
        survivor = self.standby
        assert survivor.run_election_once() == "leader", survivor.state()
        self.promotions += 1
        # Clients retry the in-flight gangs against the new leader; the
        # first retried decision's wall time since the kill is the spike.
        for i, (app_id, driver) in enumerate(staged):
            node = self._serve_driver(survivor, driver)
            self.placed[app_id] = node
            self.total_placed += 1
            if i == 0:
                self.failover_spikes.append(time.perf_counter() - kill_t0)
        # The dead leader's window now lands. Retried apps: the tailer
        # already delivered the new leader's reservation, so the commit is
        # an idempotent no-op. Orphans: a fresh reservation write carrying
        # the stale epoch — rejected by the fence, counted dropped.
        try:
            leader.app.extender.predicate_window_complete(ticket)
        except Exception:
            pass  # a fenced demand/reservation write surfacing is fine
        drops = leader.app.rr_cache.client.metrics.dropped - drops_before
        self.fenced_drops += drops
        assert leader.lease.fenced_rejects > 0 and drops >= len(orphans), (
            "the dead leader's orphan commit was never fenced",
            leader.lease.fenced_rejects, drops,
        )
        for app_id, driver in orphans:
            assert (
                self.backend.get(
                    "resourcereservations", driver.namespace, app_id
                )
                is None
            ), ("fenced orphan reservation reached the durable store", app_id)
            # The orphan's client went away with its leader: remove the
            # pending driver pod so FIFO doesn't track a ghost forever.
            self.backend.delete_pod(driver)
            del self.driver_pods[app_id]
        # Fresh standby replaces the corpse (built AFTER the new state
        # exists: its caches fill warm, the tailer keeps them warm).
        self.replicas = [r for r in self.replicas if not r._dead]
        self.replicas.append(self._build(f"replica-{self._replica_seq}"))
        self._replica_seq += 1
        self._retire_oldest()
        self.check_invariants()

    def _retire_oldest(self) -> None:
        """Completed apps leave the cluster: delete the driver pod and its
        reservation through the NEW leader's fenced write path (tailers
        propagate the deletes to every replica's cache and usage tracker),
        so an arbitrary-cycle soak recycles capacity instead of hitting
        legitimate does-not-fit on the fixed fleet — which would starve the
        orphan-fencing assertion of its reservation write."""
        leader = self.leader
        while len(self.placed) > self.max_live_apps:
            app_id = next(iter(self.placed))
            driver = self.driver_pods.pop(app_id)
            # Pod first: a bound driver with no reservation is exactly what
            # reconcile calls stale and would re-place.
            self.backend.delete_pod(driver)
            leader.app.rr_cache.delete(driver.namespace, app_id)
            del self.placed[app_id]
            self.retired += 1

    # -- invariants --------------------------------------------------------

    def check_invariants(self) -> None:
        from spark_scheduler_tpu_torch.testing.harness import overcommit_violations

        leader = self.leader
        # Reservation invariant over DURABLE truth.
        violations = overcommit_violations(leader.app, self.backend)
        assert not violations, ("over-commit", violations)
        # Zero double placements: one RR per admitted app, driver slot on
        # the surviving answer's node.
        rrs = {rr.name: rr for rr in self.backend.list("resourcereservations")}
        for app_id, node in self.placed.items():
            rr = rrs.get(app_id)
            assert rr is not None, ("admitted app lost its reservation", app_id)
            assert rr.spec.reservations["driver"].node == node, (
                "double placement: durable driver slot diverges from the "
                "surviving leader's answer",
                app_id, rr.spec.reservations["driver"].node, node,
            )
        # Latency spike bounded.
        for spike in self.failover_spikes:
            assert spike < self.spike_budget_s, (
                "failover spike exceeds budget", spike, self.spike_budget_s
            )

    def run(self, cycles: int = 3, burst: int = 4) -> dict:
        for _ in range(cycles):
            self.run_cycle(burst=burst)
        mid = sorted(self.steady_latencies)
        return {
            "cycles": cycles,
            "kills": self.kills,
            "spared_cycles": self.spared_cycles,
            "fault_stats": self.injector.stats(),
            "apps_placed": self.total_placed,
            "live_apps": len(self.placed),
            "retired": self.retired,
            "steady_p50_ms": round(mid[len(mid) // 2] * 1e3, 3) if mid else None,
            "failover_spike_ms": [
                round(s * 1e3, 1) for s in self.failover_spikes
            ],
            "fenced_drops": self.fenced_drops,
            "promotions": self.promotions,
        }


class PolicySoak:
    """Priority/preemption soak: sustained
    high-priority pressure against a fixed set of low-priority gangs plus
    one protected "system" gang, through the REAL policy-enabled extender
    (priority ordering + vectorized preemption search + age promotion).

    Deterministic manual clock: pods are stamped with the soak clock so
    age promotion is driven by `advance()`, not wall time. Each step:

      submit 1 fresh high-priority gang (evicts low gangs while they are
      young; denied once they age into the promotion cap), retire the
      oldest high gang past a small working-set bound (so capacity keeps
      turning over), retry every pending/evicted low gang, advance the
      clock one `step_s`.

    Invariants collected for the test layer (`verdict()`):
      * no starvation — every low gang holds a reservation at the end,
        and every admission happened within `starvation_bound_s` of its
        original submission (the age-promotion bound: once promoted to
        the cap a low gang is neither blocked behind fresh high gangs
        nor evictable by them);
      * the system gang's hard reservation survives every step;
      * zero over-commit at every step.
    """

    def __init__(
        self,
        n_low: int = 3,
        n_nodes: int = 3,
        promote_after_s: float = 120.0,
        step_s: float = 30.0,
        device="cuda",
    ):
        class _Clock:
            def __init__(self):
                self.t = 1_000.0

            def __call__(self):
                return self.t

            def advance(self, dt):
                self.t += dt

        self.clock = _Clock()
        self.promote_after_s = promote_after_s
        self.step_s = step_s
        self.h = Harness(
            binpack_algo="tightly-pack",
            fifo=True,
            clock=self.clock,
            policy_enabled=True,
            policy_ordering="priority",
            policy_preemption=True,
            policy_promote_after_s=promote_after_s,
            # The manual clock jumps step_s per step — without this every
            # request would cross the leader-gap heuristic and run a full
            # failover reconcile mid-soak (resurrecting evicted gangs
            # from their leftover pending pods).
            resync_gap_seconds=1e12,
            device=device,
        )
        for i in range(n_nodes):
            self.h.add_nodes(new_node(f"pn{i}", zone=f"zone{i % 3}"))
        self.names = [f"pn{i}" for i in range(n_nodes)]
        self.seq = 0
        self.highs: list[tuple[str, list]] = []  # (app_id, pods) admitted
        self.evictions = 0
        self.denied_high = 0
        self.system_rr_lost = False
        self.overcommit: list = []
        # app_id -> {"pods", "submitted", "admitted"(clock time or None)}
        self.lows: dict[str, dict] = {}

        from spark_scheduler_tpu_torch.models.reservations import (
            PRIORITY_CLASS_ANNOTATION,
        )

        self._ann = PRIORITY_CLASS_ANNOTATION

        # One protected gang: its reservation must survive the whole soak.
        sys_pods = self._gang("system-app", 2, "system")
        assert self._admit_gang(sys_pods), "system gang must admit first"

        for i in range(n_low):
            app_id = f"low-{i}"
            pods = self._gang(app_id, 2, "low")
            self.lows[app_id] = {
                "pods": pods,
                "submitted": self.clock(),
                "admitted": None,
            }

    def _gang(self, app_id: str, execs: int, pclass: str):
        pods = static_allocation_spark_pods(app_id, execs)
        pods[0].annotations[self._ann] = pclass
        for p in pods:  # stamp with the SOAK clock, not the global counter
            p.creation_timestamp = self.clock()
        return pods

    def _admit_gang(self, pods) -> bool:
        r = self.h.schedule(pods[0], self.names)
        if not r.ok:
            return False
        for p in pods[1:]:
            self.h.schedule(p, self.names)
        return True

    def _teardown(self, app_id: str, pods) -> None:
        for p in pods:
            cur = self.h.backend.get("pods", p.namespace, p.name)
            if cur is not None:
                self.h.backend.delete_pod(cur)
        rr = self.h.get_reservation("namespace", app_id)
        if rr is not None:
            self.h.app.rr_cache.delete(rr.namespace, rr.name)

    def step(self) -> None:
        # Sustained pressure: one fresh high gang per step.
        app_id = f"high-{self.seq}"
        self.seq += 1
        pods = self._gang(app_id, 2, "high")
        if self._admit_gang(pods):
            self.highs.append((app_id, pods))
        else:
            self.denied_high += 1
        if len(self.highs) > 4:
            old_id, old_pods = self.highs.pop(0)
            self._teardown(old_id, old_pods)

        # Low gangs retry every step (the kube retry loop). Resubmission
        # uses FRESH pod objects carrying the ORIGINAL creation stamp:
        # binding mutates the stored pod's node_name in place, so reusing
        # the old objects would re-add pods that look already-bound (a
        # phantom the availability mirror would count as usage) — while a
        # fresh stamp would reset the gang's promotion clock.
        import dataclasses as _dc

        for low_id, entry in self.lows.items():
            rr = self.h.get_reservation("namespace", low_id)
            if rr is not None:
                continue
            if entry["admitted"] is not None:
                self.evictions += 1
                entry["admitted"] = None
            entry["pods"] = [
                _dc.replace(p, node_name=None, phase="Pending")
                for p in entry["pods"]
            ]
            if self._admit_gang(entry["pods"]):
                entry["admitted"] = self.clock()

        if self.h.get_reservation("namespace", "system-app") is None:
            self.system_rr_lost = True
        self.overcommit.extend(overcommit_violations(self.h.app, self.h.backend))
        self.clock.advance(self.step_s)

    def run(self, steps: int) -> dict:
        for _ in range(steps):
            self.step()
        return self.verdict()

    def verdict(self) -> dict:
        waits = {}
        for low_id, entry in self.lows.items():
            waits[low_id] = (
                entry["admitted"] - entry["submitted"]
                if entry["admitted"] is not None
                else None
            )
        return {
            "steps": self.seq,
            "low_waits_s": waits,
            "evictions": self.evictions,
            "denied_high": self.denied_high,
            "system_rr_lost": self.system_rr_lost,
            "overcommit": self.overcommit,
            "preemptions": [
                rec["preemption"]
                for rec in self.h.app.recorder.query(limit=10_000)
                if rec.get("preemption")
            ],
        }


class FleetSoak:
    """Fleet chaos soak: randomized gang traffic across F
    per-cluster stacks behind one FleetFacade, with cluster kill/rejoin
    chaos riding StableMembership. Groups are multi-homed (each instance
    group hosted by two clusters) so routing has real choices and denied
    drivers have a live spillover sibling.

    Each step: submit a fresh gang on a random group, retry a few pending
    (denied) gangs, occasionally tear one placed app down. At `kill_at`
    one cluster is removed from serving (its pending gangs become orphans
    and MUST re-route to survivors); at `rejoin_at` it returns.

    Invariants (verdict()):
      * zero double placements — every app's reservation exists in at
        most ONE cluster's backend at every checkpoint;
      * zero over-commits — per-cluster overcommit_violations() empty at
        every checkpoint;
      * orphaned gangs re-routed — every pre-kill PENDING gang bound to
        the dead cluster ends up placed on (or routed to) a survivor;
      * aggregates == walk-oracle per cluster at every checkpoint;
      * per-cluster decisions byte-identical to a standalone replay of
        the cluster's op stream (checked once at the end — the oplog
        covers the entire soak).

    STACKING MODE (`stack_window_ms` > 0): the facade runs the
    FleetDispatchCoordinator, and each step's fresh gangs are submitted
    CONCURRENTLY — one per group from its own thread — so per-cluster
    windows actually meet inside the gather and flush as stacked
    launches. The kill lands while a concurrent burst is in flight
    (kill-mid-gather: the victim's parked window must resolve via the
    forced fallback and the survivors' stack must flush clean), and
    every invariant above — byte-identity included — holds unchanged.
    """

    def __init__(
        self,
        n_clusters: int = 3,
        nodes_per_cluster: int = 2,
        seed: int = 0,
        max_spillover_hops: int = 1,
        stack_window_ms: float = 0.0,
        device="cuda",
    ):
        from spark_scheduler_tpu_torch.fleet import FleetFacade
        from spark_scheduler_tpu_torch.server.config import InstallConfig
        from spark_scheduler_tpu_torch.testing.harness import (
            INSTANCE_GROUP_LABEL,
        )

        self.rng = np.random.default_rng(seed)
        self.F = n_clusters
        self.stack_window_ms = stack_window_ms
        self._traffic_lock = threading.Lock()
        cfg = InstallConfig(
            fifo=True,
            sync_writes=True,
            instance_group_label=INSTANCE_GROUP_LABEL,
        )
        self.facade = FleetFacade(
            n_clusters,
            cfg,
            record_ops=True,
            max_spillover_hops=max_spillover_hops,
            stack_window_ms=stack_window_ms,
            device=device,
        )
        # Group g is hosted by clusters g and (g+1) % F — multi-homed.
        self.groups = [f"ig-{g}" for g in range(n_clusters)]
        for g in range(n_clusters):
            for c in (g, (g + 1) % n_clusters):
                for i in range(nodes_per_cluster):
                    self.facade.add_node(
                        c, new_node(f"c{c}-g{g}-n{i}", instance_group=f"ig-{g}")
                    )
        self.seq = 0
        self.placed: dict[str, dict] = {}   # app_id -> {pods, cluster}
        self.pending: dict[str, dict] = {}  # app_id -> {pods, group}
        self.dead: int | None = None
        self.double_placements: list = []
        self.overcommit: list = []
        self.oracle_mismatches: list = []
        self.orphans_at_kill: set[str] = set()
        self.orphans_rerouted = 0
        self.unavailable_denials = 0
        self.steps_run = 0

    # -- traffic -------------------------------------------------------------

    def _submit(self, app_id: str, group: str) -> None:
        pods = static_allocation_spark_pods(
            app_id, int(self.rng.integers(1, 4)), instance_group=group
        )
        self._try_place(app_id, group, pods)

    def _try_place(self, app_id: str, group: str, pods) -> None:
        # schedule() runs OUTSIDE the traffic lock so concurrent burst
        # threads (stacking mode) can meet inside the gather window;
        # only the soak's own bookkeeping is lock-guarded.
        d = self.facade.schedule(pods[0])
        if d.unavailable:
            with self._traffic_lock:
                self.unavailable_denials += 1
                self.pending[app_id] = {"pods": pods, "group": group}
            return
        if not d.ok:
            with self._traffic_lock:
                self.pending[app_id] = {"pods": pods, "group": group}
            return
        for p in pods[1:]:
            self.facade.schedule(p)
        with self._traffic_lock:
            self.pending.pop(app_id, None)
            self.placed[app_id] = {"pods": pods, "cluster": d.cluster}
            if app_id in self.orphans_at_kill:
                self.orphans_rerouted += 1

    def _start_burst(self) -> list[threading.Thread]:
        """Stacking mode: one fresh gang per group, each submitted from
        its own thread so per-cluster windows can stack. Pods and RNG
        draws happen on the caller's thread to keep the soak
        deterministic; only the facade calls run concurrently."""
        jobs = []
        for group in self.groups:
            self.seq += 1
            app_id = f"fleet-soak-{self.seq}"
            pods = static_allocation_spark_pods(
                app_id, int(self.rng.integers(1, 4)), instance_group=group
            )
            jobs.append((app_id, group, pods))
        threads = [
            threading.Thread(
                target=self._try_place, args=job, name=f"soak-burst-{job[0]}"
            )
            for job in jobs
        ]
        for t in threads:
            t.start()
        return threads

    def _teardown(self, app_id: str) -> None:
        info = self.placed.pop(app_id)
        stack = self.facade.stacks[info["cluster"]]
        if not self.facade.router.members.is_live(info["cluster"]):
            self.placed[app_id] = info  # cluster down: cannot tear down
            return
        for p in info["pods"]:
            stack.delete_pod(p)
        self.facade.router.unbind(app_id)

    # -- invariants ----------------------------------------------------------

    def _reservation_holders(self, app_id: str) -> list[int]:
        out = []
        for s in self.facade.stacks:
            if any(
                rr.name == app_id
                for rr in s.backend.list("resourcereservations")
            ):
                out.append(s.index)
        return out

    def _check(self) -> None:
        for app_id in list(self.placed) + list(self.pending):
            holders = self._reservation_holders(app_id)
            if len(holders) > 1:
                self.double_placements.append((self.steps_run, app_id, holders))
        for s in self.facade.stacks:
            v = overcommit_violations(s.app, s.backend)
            if v:
                self.overcommit.append((self.steps_run, s.index, v))
            if not s.aggregates.oracle_equals():
                self.oracle_mismatches.append((self.steps_run, s.index))

    # -- the soak loop -------------------------------------------------------

    def run(
        self,
        steps: int = 45,
        kill_at: int = 15,
        rejoin_at: int = 30,
        check_every: int = 5,
    ) -> "FleetSoak":
        stacking = self.stack_window_ms > 0
        for step in range(steps):
            self.steps_run = step
            kill_now = step == kill_at and self.dead is None
            if kill_now and not stacking:
                self._kill()
            if step == rejoin_at and self.dead is not None:
                self.facade.rejoin_cluster(self.dead)
                self.dead = None
            # Fresh gang(s). Stacking mode submits one per group
            # concurrently so the coordinator actually gathers; the kill
            # then lands while the burst is in flight (kill-mid-gather).
            if stacking:
                burst = self._start_burst()
                if kill_now:
                    time.sleep(min(self.stack_window_ms, 50.0) / 2e3)
                    self._kill()
                for t in burst:
                    t.join()
            else:
                self.seq += 1
                group = self.groups[
                    int(self.rng.integers(0, len(self.groups)))
                ]
                self._submit(f"fleet-soak-{self.seq}", group)
            # Retry up to two pending gangs (oldest first).
            for app_id in list(self.pending)[:2]:
                info = self.pending.pop(app_id)
                self._try_place(app_id, info["group"], info["pods"])
            # Occasionally retire a placed app.
            if self.placed and self.rng.random() < 0.25:
                ids = sorted(self.placed)
                self._teardown(ids[int(self.rng.integers(0, len(ids)))])
            if step % check_every == 0:
                self._check()
        self._check()
        return self

    def _kill(self) -> None:
        victim = int(self.rng.integers(0, self.F))
        # Pending gangs routed to the victim are the orphans the
        # re-route invariant tracks.
        with self._traffic_lock:
            self.orphans_at_kill = {
                a
                for a in self.pending
                if self.facade.router.affinity_of(a) == victim
            }
        self.facade.kill_cluster(victim)
        self.dead = victim

    def verdict(self) -> dict:
        from spark_scheduler_tpu_torch.fleet import verify_cluster_equivalence

        equivalence = verify_cluster_equivalence(self.facade)
        st = self.facade.state()
        # Every orphan must have left the dead cluster: either re-placed
        # on a survivor (orphans_rerouted) or re-routed and still pending
        # with a LIVE affinity (or none yet).
        unrouted = []
        for a in self.orphans_at_kill:
            aff = self.facade.router.affinity_of(a)
            if aff is not None and not self.facade.router.members.is_live(aff):
                unrouted.append(a)
        return {
            "steps": self.steps_run + 1,
            "double_placements": self.double_placements,
            "overcommit": self.overcommit,
            "oracle_mismatches": self.oracle_mismatches,
            "orphans_at_kill": len(self.orphans_at_kill),
            "orphans_rerouted": self.orphans_rerouted,
            "orphans_unrouted": unrouted,
            "unavailable_denials": self.unavailable_denials,
            "placed": len(self.placed),
            "pending": len(self.pending),
            "spillovers": st["spillover"]["spilled"],
            "stacking": st.get("stacking", {"enabled": False}),
            "equivalence": equivalence,
        }

    def stop(self) -> None:
        self.facade.stop()
