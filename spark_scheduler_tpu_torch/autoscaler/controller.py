"""ElasticAutoscaler: the control loop that closes the Demand loop.

One `run_once()` pass (the loop body, also the deterministic test/soak
hook):

  1. take ownership of newly-created demands (phase "" -> "pending");
     cap-limited "cannot-fulfill" demands whose units still fit a template
     node are re-acked to "pending" once headroom exists, so a capped gang
     is never starved after capacity frees;
  2. group pending demands by (instance-group, zone), oldest first, and
     decide scale-up counts per group by packing the group's units into
     template-node bins (provisioner.nodes_needed);
  3. provision nodes for every group that fits under the max-cluster-size
     cap and flip its demands "pending" -> "fulfilled" (recording
     demand-to-fulfilled latency); demands that cannot fit — a unit larger
     than a template node, or the cap reached — flip to "cannot-fulfill";
  4. run the scale-down drainer.

Phase flips are written straight to the backend with a REPLACEMENT object,
exactly how the external autoscaler would write the status subresource: the
scheduler's demand cache fast-forwards resourceVersions on watch and the
waste reporter's on-update subscription observes the fulfillment
(server/app.py), so nothing downstream can tell this autoscaler from the
reference's external one.

`start()` runs the loop on a daemon thread with a demand-add wakeup (gated
on the Demand CRD existing, same as every other demand consumer);
`run_once()` stays callable without any thread for tests and for
chip_smoke.py's phase 13.

The port's copy of spark_scheduler_tpu/autoscaler/controller.py.
"""

from __future__ import annotations

import dataclasses
import threading

from spark_scheduler_tpu_torch.autoscaler.drainer import ScaleDownDrainer
from spark_scheduler_tpu_torch.autoscaler.metrics import AutoscalerMetrics
from spark_scheduler_tpu_torch.autoscaler.provisioner import NodeProvisioner
from spark_scheduler_tpu_torch.models.demands import (
    PHASE_CANNOT_FULFILL,
    PHASE_EMPTY,
    PHASE_FULFILLED,
    PHASE_PENDING,
    Demand,
)
from spark_scheduler_tpu_torch.store.backend import BackendError


class ElasticAutoscaler:
    def __init__(
        self,
        backend,
        provisioner: NodeProvisioner,
        drainer: ScaleDownDrainer,
        max_cluster_size: int = 1000,
        poll_interval_s: float = 2.0,
        metrics: AutoscalerMetrics | None = None,
        recorder=None,
        clock=None,
        census=None,
    ):
        import time as _time

        self._backend = backend
        self.provisioner = provisioner
        self.drainer = drainer
        # Incremental census (core/census.py): cluster size becomes an
        # O(1) counter read instead of materializing the full node list
        # (three times per pass). None = the reference's list_nodes walk.
        self._census = census
        self.max_cluster_size = max_cluster_size
        self._poll_interval_s = poll_interval_s
        self.metrics = metrics or AutoscalerMetrics()
        # FlightRecorder: fulfilled demands annotate the denied decision
        # that created them, closing the denial -> scale-up story on the
        # record an operator pulls from GET /debug/decisions.
        self._recorder = recorder
        self._clock = clock or _time.time
        # (namespace, name) -> first time this controller saw the demand;
        # fallback latency anchor when the creator didn't stamp
        # creationTimestamp into metadata_extra.
        self._first_seen: dict[tuple[str, str], float] = {}
        self._wakeup = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._attached = False
        # Failed-pass backoff: consecutive
        # failures back off exponentially (capped, full jitter) and the
        # count is a gauge so a wedged controller is visible, not silent.
        from spark_scheduler_tpu_torch.faults.retry import RetryPolicy

        self.retry_policy = RetryPolicy(
            max_attempts=None,
            base_delay_s=poll_interval_s,
            multiplier=2.0,
            max_delay_s=max(30.0, poll_interval_s),
        )
        self.consecutive_failures = 0

    # -- lifecycle -----------------------------------------------------------

    def attach(self) -> None:
        """Subscribe the demand-add wakeup. Called via the Demand-CRD
        watcher's on_ready (demands may appear any time after startup)."""
        if self._attached:
            return
        self._attached = True
        self._backend.subscribe("demands", on_add=lambda d: self._wakeup.set())

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.is_set():
                self._wakeup.wait(self._poll_interval_s)
                self._wakeup.clear()
                if self._stop.is_set():
                    return
                try:
                    self.run_once()
                    self._note_pass_ok()
                except Exception as exc:
                    from spark_scheduler_tpu_torch.tracing import svc1log

                    pause = self._note_pass_failed()
                    svc1log().warn(
                        "autoscaler pass failed; backing off",
                        error=f"{type(exc).__name__}: {exc}",
                        consecutiveFailures=self.consecutive_failures,
                        backoffS=round(pause, 3),
                    )
                    # On top of the poll wait: a failing backend is
                    # probed at the ladder's cadence, and the demand-add
                    # wakeup is cleared below so it cannot bypass it.
                    self._stop.wait(pause)
                    self._wakeup.clear()

        self._thread = threading.Thread(
            target=loop, daemon=True, name="elastic-autoscaler"
        )
        self._thread.start()

    def _note_pass_ok(self) -> None:
        if self.consecutive_failures:
            self.consecutive_failures = 0
            self.metrics.set_consecutive_failures(0)

    def _note_pass_failed(self) -> float:
        """Count one failed pass; returns the backoff to wait before the
        next attempt (exponential in the failure streak)."""
        delay = self.retry_policy.delay(self.consecutive_failures)
        self.consecutive_failures += 1
        self.metrics.set_consecutive_failures(self.consecutive_failures)
        return delay

    def stop(self) -> None:
        self._stop.set()
        self._wakeup.set()
        if self._thread is not None:
            self._thread.join(timeout=self._poll_interval_s + 1)
            self._thread = None

    # -- the pass ------------------------------------------------------------

    def run_once(self, now: float | None = None) -> dict:
        """One full control-loop pass. Returns a summary dict:
        {nodes_added, drained, fulfilled, unfulfillable}."""
        if now is None:
            now = self._clock()
        summary = {"nodes_added": 0, "drained": [], "fulfilled": 0, "unfulfillable": 0}

        # 1. ownership: "" -> pending (the external autoscaler's ack).
        # Cap-limited refusals are retried — a cannot-fulfill demand goes
        # back to pending once its OWN node count fits under the cap
        # (drained capacity or a raised cap), so a capped gang is never
        # starved forever; requiring full fit (not just any headroom)
        # keeps a still-too-big demand from oscillating cannot-fulfill ->
        # pending -> cannot-fulfill with two status writes per pass.
        # Unit-infeasible demands (a unit larger than an empty template
        # node) stay terminal.
        cluster_size = self._cluster_size()
        pending: list[Demand] = []
        live: set[tuple[str, str]] = set()
        for d in self._backend.list("demands"):
            key = (d.namespace, d.name)
            live.add(key)
            if d.status.phase in (PHASE_EMPTY, PHASE_CANNOT_FULFILL):
                if d.status.phase == PHASE_CANNOT_FULFILL:
                    needed = self.provisioner.nodes_needed(d.spec.units)
                    if (
                        needed is None
                        or cluster_size + needed > self.max_cluster_size
                    ):
                        continue
                marked = self._set_phase(d, PHASE_PENDING, now)
                if marked is not None:
                    self._first_seen.setdefault(key, now)
                    pending.append(marked)
            elif d.status.phase == PHASE_PENDING:
                self._first_seen.setdefault(key, now)
                pending.append(d)
        # Forget latency anchors for demands that no longer exist (GC'd,
        # deleted on successful schedule).
        for key in list(self._first_seen):
            if key not in live:
                del self._first_seen[key]

        # 2. group by (instance-group, pinned zone), oldest demand first.
        groups: dict[tuple[str, str | None], list[Demand]] = {}
        for d in sorted(
            pending, key=lambda d: self._first_seen.get((d.namespace, d.name), now)
        ):
            zone = d.spec.zone or None
            groups.setdefault((d.spec.instance_group, zone), []).append(d)

        for (instance_group, zone), demands in groups.items():
            # Impossible demands (a unit larger than an empty template
            # node) can never be fulfilled by scale-up: fail them now so
            # they don't poison the group's bin-pack.
            feasible: list[Demand] = []
            for d in demands:
                if self.provisioner.nodes_needed(d.spec.units) is None:
                    self._finish(d, PHASE_CANNOT_FULFILL, None, now)
                    summary["unfulfillable"] += 1
                else:
                    feasible.append(d)
            if not feasible:
                continue
            # Largest oldest-first prefix that fits under the cap: demands
            # beyond it are unfulfillable at the current max cluster size.
            # Prefix node count is monotone in prefix length (a superset of
            # units never packs into fewer bins), so binary-search the cut
            # instead of re-packing per one-demand decrement.
            cluster_size = self._cluster_size()
            units = lambda ds: [u for d in ds for u in d.spec.units]  # noqa: E731
            lo, hi, needed = 0, len(feasible), 0
            while lo < hi:
                mid = (lo + hi + 1) // 2
                mid_needed = self.provisioner.nodes_needed(units(feasible[:mid]))
                if cluster_size + mid_needed <= self.max_cluster_size:
                    lo, needed = mid, mid_needed
                else:
                    hi = mid - 1
            take = lo
            for d in feasible[take:]:
                self._finish(d, PHASE_CANNOT_FULFILL, None, now)
                summary["unfulfillable"] += 1
            if take == 0:
                continue
            # Zone pin: the demand's own zone, else one round-robin zone
            # when any demand in the group enforces single-zone placement.
            pinned = zone
            if pinned is None and any(
                d.spec.enforce_single_zone_scheduling for d in feasible[:take]
            ):
                pinned = self.provisioner.pick_zone()
            created = self.provisioner.provision(needed, instance_group, pinned)
            summary["nodes_added"] += len(created)
            self.metrics.on_nodes_added(instance_group, len(created))
            for d in feasible[:take]:
                self._finish(d, PHASE_FULFILLED, pinned, now)
                summary["fulfilled"] += 1

        # 4. scale down.
        drained = self.drainer.run_once(now)
        summary["drained"] = drained
        if drained:
            self.metrics.on_nodes_drained(len(drained))
        self.metrics.set_cluster_size(self._cluster_size())
        return summary

    def _cluster_size(self) -> int:
        if self._census is not None:
            return self._census.node_count()
        return len(self._backend.list_nodes())

    # -- phase transitions ---------------------------------------------------

    def _set_phase(
        self, demand: Demand, phase: str, now: float, fulfilled_zone: str | None = None
    ) -> Demand | None:
        """Flip a demand's phase with a replacement object against the
        backend (the external-autoscaler write path). Returns the updated
        object, or None when the demand was deleted/rewritten concurrently
        (the next pass re-reads)."""
        cur = self._backend.get("demands", demand.namespace, demand.name)
        if cur is None:
            return None
        updated = dataclasses.replace(cur)
        updated.status = dataclasses.replace(
            cur.status,
            phase=phase,
            last_transition_time=now,
            fulfilled_zone=fulfilled_zone or cur.status.fulfilled_zone,
        )
        try:
            return self._backend.update("demands", updated)
        except BackendError:
            return None

    def _finish(
        self, demand: Demand, phase: str, fulfilled_zone: str | None, now: float
    ) -> None:
        if self._set_phase(demand, phase, now, fulfilled_zone) is None:
            return
        key = (demand.namespace, demand.name)
        if phase == PHASE_FULFILLED:
            anchor = demand.metadata_extra.get("creationTimestamp")
            try:
                anchor = float(anchor)
            except (TypeError, ValueError):
                # A demand ingested off the wire carries an RFC3339 string
                # here (conversion keeps unknown metadata verbatim) — not
                # this clock's epoch either way; anchor on first-seen.
                anchor = self._first_seen.get(key, now)
            self.metrics.on_demand_fulfilled(
                demand.spec.instance_group, max(0.0, now - anchor)
            )
            if self._recorder is not None:
                from spark_scheduler_tpu_torch.models.demands import (
                    DEMAND_NAME_PREFIX,
                )

                pod_name = demand.name
                if pod_name.startswith(DEMAND_NAME_PREFIX):
                    pod_name = pod_name[len(DEMAND_NAME_PREFIX):]
                self._recorder.annotate_demand_fulfilled(
                    demand.namespace, pod_name, max(0.0, now - anchor), now
                )
        else:
            self.metrics.on_demand_unfulfillable(demand.spec.instance_group)
        self._first_seen.pop(key, None)
