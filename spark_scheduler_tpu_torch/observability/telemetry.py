"""Serving-path telemetry: the solver, the retry ladder, the HTTP
transport, the HA replica runtime and the fleet facade.

The port's copy of `SolverTelemetry`, `RetryTelemetry`,
`TransportTelemetry`, `HATelemetry` and `FleetTelemetry` from
spark_scheduler_tpu/observability/telemetry.py.
SolverTelemetry publishes the solver's internals as
`foundry.spark.scheduler.solver.*` series: windows dispatched per path,
padding-bucket occupancy, solo packs, pipelined builds and how they
reached the device, pipeline drains and discards, host<->device bytes, and
the host featurize split. The JAX package counts XLA compiles through a
jax.monitoring listener; the port has none to count, and its compile
gauges read the library builds of ops/_build.py instead.
`FleetTelemetry` publishes `foundry.spark.scheduler.fleet.*` under the JAX
package's names.
"""

from __future__ import annotations

import threading

from spark_scheduler_tpu_torch.metrics.registry import MetricRegistry
from spark_scheduler_tpu_torch.ops._build import build_totals

JIT_COMPILES = "foundry.spark.scheduler.solver.jit.compiles"
JIT_COMPILE_SECONDS = "foundry.spark.scheduler.solver.jit.compile.seconds"
WINDOW_DISPATCHES = "foundry.spark.scheduler.solver.window.dispatches"
BUCKET_OCCUPANCY = "foundry.spark.scheduler.solver.bucket.occupancy"
PIPELINE_EVENTS = "foundry.spark.scheduler.solver.pipeline.events"
TRANSFER_BYTES = "foundry.spark.scheduler.solver.transfer.bytes"
SOLO_PACKS = "foundry.spark.scheduler.solver.packs"
# Per-device series tagged device=<label> (one label per pool slot in the
# JAX package; the port's one device).
DEVICE_UPLOADS = "foundry.spark.scheduler.solver.device.uploads"
DEVICE_INFLIGHT = "foundry.spark.scheduler.solver.device.inflight"
DEVICE_SOLVE_MS = "foundry.spark.scheduler.solver.device.solve.ms"
DEVICE_FETCH_MS = "foundry.spark.scheduler.solver.device.fetch.ms"
DEVICE_RESIDENT_AGE = (
    "foundry.spark.scheduler.solver.device.resident.age.seconds"
)
# Per-slot delta-synced availability mirrors: rows scattered
# by delta catch-ups, full availability re-ships ("dense" syncs — the
# number the pooled tier drives to 0 on pruned traffic), and catch-up
# events, each tagged device=<label>.
DEVICE_MIRROR_DELTA_ROWS = (
    "foundry.spark.scheduler.solver.device.mirror.delta.rows"
)
DEVICE_MIRROR_DENSE_SYNCS = (
    "foundry.spark.scheduler.solver.device.mirror.dense.syncs"
)
DEVICE_MIRROR_CATCHUP = (
    "foundry.spark.scheduler.solver.device.mirror.catchup"
)
# Device-slot quarantine/recovery (the JAX package's _DevicePool):
# events tagged event=quarantine|reinstate|redispatch|probe-failed and a
# live count of quarantined slots.
DEVICE_QUARANTINE_EVENTS = (
    "foundry.spark.scheduler.solver.device.quarantine.events"
)
DEVICE_QUARANTINE_ACTIVE = (
    "foundry.spark.scheduler.solver.device.quarantine.active"
)
# The degraded-mode gauge readiness keys on (faults/degraded.py, not
# ported yet: nothing sets it).
FAULTS_DEGRADED_ACTIVE = "foundry.spark.scheduler.faults.degraded.active"
# Fused multi-window dispatch engine (core/solver.py
# pack_windows_dispatch): how many windows each device dispatch carried,
# the per-window share of the dispatch->decisions round trip, and how
# busy the dispatch surface (pool slots / in-flight pipeline) was when a
# new dispatch launched — the upload/solve/fetch overlap actually
# engaging.
PRUNE_WINDOWS = "foundry.spark.scheduler.solver.prune.windows"
PRUNE_ESCALATIONS = "foundry.spark.scheduler.solver.prune.escalations"
PRUNE_KEPT_ROWS = "foundry.spark.scheduler.solver.prune.kept.rows"
PRUNE_KEPT_RATIO = "foundry.spark.scheduler.solver.prune.kept.ratio"
# O(K + changed) planning: per-window prune phase wall times
# (prefilter plan / statics+mask gather / zone-sum offset derivation) and
# the statics-gather reuse hits that skip the host gather + re-upload.
PRUNE_PLAN_MS = "foundry.spark.scheduler.solver.prune.plan.ms"
PRUNE_GATHER_MS = "foundry.spark.scheduler.solver.prune.gather.ms"
PRUNE_OFFSET_MS = "foundry.spark.scheduler.solver.prune.offset.ms"
PRUNE_GATHER_REUSE = "foundry.spark.scheduler.solver.prune.gather.reuse"
DISPATCH_FUSED_K = "foundry.spark.scheduler.solver.dispatch.fused.k"
DISPATCH_AMORTIZED_RTT_MS = (
    "foundry.spark.scheduler.solver.dispatch.amortized.rtt.ms"
)
DISPATCH_OVERLAP_OCCUPANCY = (
    "foundry.spark.scheduler.solver.dispatch.overlap.occupancy"
)
# Host featurize (core/feature_store.py): per-window sub-phase wall times
# tagged phase=snapshot|tensors|domains|fifo, and the store's O(changed)
# evidence counters (roster re-walks vs snapshots served resident).
FEATURIZE_MS = "foundry.spark.scheduler.solver.featurize.ms"
FEATURIZE_SNAPSHOTS = "foundry.spark.scheduler.solver.featurize.snapshots"
FEATURIZE_ROSTER_REBUILDS = (
    "foundry.spark.scheduler.solver.featurize.roster.rebuilds"
)
FEATURIZE_USAGE_REFRESHES = (
    "foundry.spark.scheduler.solver.featurize.usage.refreshes"
)
FEATURIZE_OVERHEAD_REFRESHES = (
    "foundry.spark.scheduler.solver.featurize.overhead.refreshes"
)
# O(K + changed) tensor build: per-window build wall time, rows
# the DENSE mirror sweep examined (0 in steady state — the fallback), and
# rows the event-fed dirty-set sync examined instead.
BUILD_MS = "foundry.spark.scheduler.solver.build.ms"
BUILD_ROWS_COMPARED = "foundry.spark.scheduler.solver.build.rows.compared"
BUILD_DIRTY_ROWS = "foundry.spark.scheduler.solver.build.dirty.rows"


def compile_stats() -> dict:
    """Process-wide library builds: {"count", "seconds"} (ops/_build.py)."""
    return build_totals()


class SolverTelemetry:
    """Publishes solver internals into a tagged registry. Hook methods are
    cheap (a counter/histogram touch) and only ever called guarded by
    `solver.telemetry is not None`.

    The port's copy of the JAX package's SolverTelemetry. The port
    JIT-compiles nothing, so the compile gauges and `compile_count()`
    report the libraries this process compiled (the CUDA kernels and the
    native runtime, ops/_build.py) under the JAX package's series names.
    The pruned solve's window path is "pallas-pruned" on the card (the
    row walk over the gathered rows) and "xla-pruned" on the CPU, the
    JAX package's name for its pruned path. The device pool books
    `on_device_mirror` (a slot replica's catch-up or dense copy),
    `on_device_age`, `on_device_window`, `on_slot_event` and
    `on_quarantine_count`; degraded mode books `on_degraded`."""

    def __init__(self, registry: MetricRegistry | None = None):
        self.registry = registry or MetricRegistry()
        # Baseline so this scheduler reports ITS builds, not the whole
        # process's history (test matrices build many apps per process).
        self._base = compile_stats()

    # -- compiles ------------------------------------------------------------

    def compile_count(self) -> int:
        return compile_stats()["count"] - self._base["count"]

    def sync_compile_gauges(self) -> None:
        cur = compile_stats()
        self.registry.gauge(JIT_COMPILES).set(
            cur["count"] - self._base["count"]
        )
        self.registry.gauge(JIT_COMPILE_SECONDS).set(
            round(cur["seconds"] - self._base["seconds"], 6)
        )

    # -- windows / packs -----------------------------------------------------

    def on_window_dispatch(
        self,
        path: str,
        *,
        nodes: int,
        rows: int,
        row_bucket: int,
        segment_bucket: int = 1,
    ) -> None:
        """One dispatched window solve: count it per device path and record
        how full its padding bucket was (padding is pure waste the compile
        cache buys; occupancy says whether the bucket grid fits the
        workload)."""
        self.registry.counter(WINDOW_DISPATCHES, path=path).inc()
        denom = max(1, row_bucket * segment_bucket)
        self.registry.histogram(
            BUCKET_OCCUPANCY,
            nodes=str(nodes),
            apps=str(row_bucket * segment_bucket),
            path=path,
        ).update(min(1.0, rows / denom))
        self.sync_compile_gauges()

    def on_featurize(self, phases: dict, store=None) -> None:
        """One serving window's host-featurize breakdown. `phases` maps
        record keys ("featurize_snapshot_ms", ...) to wall ms; `store` is
        the HostFeatureStore whose counters become gauges (how often the
        roster/usage/overhead actually refreshed vs served resident)."""
        for key, ms in phases.items():
            phase = key[len("featurize_"):]
            if phase.endswith("_ms"):
                phase = phase[:-3]
            self.registry.histogram(FEATURIZE_MS, phase=phase).update(ms)
        if store is not None:
            self.registry.gauge(FEATURIZE_SNAPSHOTS).set(store.snapshots)
            self.registry.gauge(FEATURIZE_ROSTER_REBUILDS).set(
                store.roster_rebuilds
            )
            self.registry.gauge(FEATURIZE_USAGE_REFRESHES).set(
                store.usage_refreshes
            )
            self.registry.gauge(FEATURIZE_OVERHEAD_REFRESHES).set(
                store.overhead_refreshes
            )

    def on_pack(self, *, nodes: int, emax: int) -> None:
        self.registry.counter(
            SOLO_PACKS, nodes=str(nodes), emax=str(emax)
        ).inc()
        self.sync_compile_gauges()

    # -- fused dispatch ------------------------------------------------------

    def on_fused_dispatch(self, fused_k: int, occupancy: float) -> None:
        """One fused multi-window dispatch: its batch size (fused_k = 1
        means the fused claim found only one window's worth of backlog)
        and the dispatch surface's busy fraction at launch."""
        self.registry.histogram(DISPATCH_FUSED_K).update(fused_k)
        self.registry.histogram(DISPATCH_OVERLAP_OCCUPANCY).update(
            round(occupancy, 4)
        )

    def on_dispatch_complete(
        self, amortized_rtt_ms: float, fused_k: int
    ) -> None:
        """Dispatch -> decisions-on-host wall time per WINDOW of the
        dispatch (the fused batch divides one device round trip by K)."""
        self.registry.histogram(
            DISPATCH_AMORTIZED_RTT_MS, fused=str(fused_k)
        ).update(round(amortized_rtt_ms, 3))

    # -- device pool ---------------------------------------------------------

    def on_device_upload(self, device: str, kind: str, nbytes: int = 0) -> None:
        """How one pipelined build reached the device: kind is "full"
        (the whole node state uploaded), "delta" (changed rows scattered
        into the resident state) or "reuse" (the resident state served as
        it was). The JAX package books this per device-pool slot only."""
        self.registry.counter(DEVICE_UPLOADS, device=device, kind=kind).inc()
        if nbytes > 0:
            self.on_transfer("h2d", nbytes)

    def on_device_mirror(
        self, device: str, kind: str, rows: int, nbytes: int = 0
    ) -> None:
        """One per-slot availability-mirror sync: "catchup" =
        a lagging slot scattered `rows` journaled rows instead of taking
        the full [N,3] base; "dense" = the full re-ship (no replica, a
        journal gap, or an unknowable epoch in the chain)."""
        if kind == "catchup":
            self.registry.counter(DEVICE_MIRROR_CATCHUP, device=device).inc()
            if rows:
                self.registry.counter(
                    DEVICE_MIRROR_DELTA_ROWS, device=device
                ).inc(int(rows))
        else:
            self.registry.counter(
                DEVICE_MIRROR_DENSE_SYNCS, device=device
            ).inc()
        if nbytes > 0:
            self.on_transfer("h2d", nbytes)

    def on_device_inflight(self, device: str, inflight: int) -> None:
        """Dispatched-but-unfetched window solves currently on the device."""
        self.registry.gauge(DEVICE_INFLIGHT, device=device).set(inflight)

    def on_device_age(self, device: str, age_s: float) -> None:
        """Seconds since the slot's resident state was last fully uploaded
        — a cold replica explains a latency outlier on that device."""
        self.registry.gauge(DEVICE_RESIDENT_AGE, device=device).set(
            round(age_s, 3)
        )

    def on_device_window(
        self, device: str, solve_ms: float, fetch_ms: float,
        inflight: int | None = None,
    ) -> None:
        """Per-slot phase wall times of one window (or window partition):
        device solve vs decision-blob fetch."""
        self.registry.histogram(DEVICE_SOLVE_MS, device=device).update(
            solve_ms
        )
        self.registry.histogram(DEVICE_FETCH_MS, device=device).update(
            fetch_ms
        )
        if inflight is not None:
            self.on_device_inflight(device, inflight)

    # -- quarantine / degraded ----------------------------------------------

    def on_slot_event(self, event: str, device: str) -> None:
        """quarantine | reinstate | redispatch | probe-failed — the
        slot-failure recovery machinery's countable transitions."""
        self.registry.counter(
            DEVICE_QUARANTINE_EVENTS, event=event, device=device
        ).inc()

    def on_quarantine_count(self, count: int) -> None:
        self.registry.gauge(DEVICE_QUARANTINE_ACTIVE).set(int(count))

    def on_degraded(self, active: bool) -> None:
        self.registry.gauge(FAULTS_DEGRADED_ACTIVE).set(1 if active else 0)

    # -- candidate pruning (the two-tier solve) ------------------------------

    def on_prune_dispatch(self, kept_rows: int, candidate_rows: int) -> None:
        """One window (or pooled partition) served over a pruned top-K
        gather: how many rows the device actually solved vs the domain's
        full candidate count."""
        self.registry.counter(PRUNE_WINDOWS).inc()
        self.registry.histogram(PRUNE_KEPT_ROWS).update(kept_rows)
        if candidate_rows > 0:
            self.registry.histogram(PRUNE_KEPT_RATIO).update(
                round(kept_rows / candidate_rows, 4)
            )

    def on_prune_escalation(self, reason: str) -> None:
        """A failed soundness certificate: the window re-solved on the
        exact full path. Labeled by the first failed test so a hot
        escalation reason is visible."""
        self.registry.counter(PRUNE_ESCALATIONS, reason=reason).inc()

    def on_prune_phases(
        self, plan_ms: float, gather_ms: float, offset_ms: float
    ) -> None:
        """One pruned window's host-side phase split: prefilter planning,
        statics/mask gather (+ upload staging), and the zone-sum offset
        derivation — the O(K + changed) claim as wall times."""
        self.registry.histogram(PRUNE_PLAN_MS).update(round(plan_ms, 4))
        self.registry.histogram(PRUNE_GATHER_MS).update(round(gather_ms, 4))
        self.registry.histogram(PRUNE_OFFSET_MS).update(round(offset_ms, 4))

    def on_prune_gather_reuse(self) -> None:
        """A pruned window re-served the previous window's gathered
        statics sub-blob (kept rows and their static fields unchanged):
        no host gather, no h2d re-upload."""
        self.registry.counter(PRUNE_GATHER_REUSE).inc()

    # -- tensor build --------------------------------------------------------

    def on_build(
        self, ms: float, rows_compared: int, dirty_rows: int
    ) -> None:
        """One pipelined tensor build: wall time, rows the dense mirror
        sweep examined (the fallback — 0 in steady state, the O(changed)
        claim as a counter), and rows the event-fed dirty-set sync
        examined."""
        self.registry.histogram(BUILD_MS).update(round(ms, 4))
        if rows_compared:
            self.registry.counter(BUILD_ROWS_COMPARED).inc(
                int(rows_compared)
            )
        if dirty_rows:
            self.registry.counter(BUILD_DIRTY_ROWS).inc(int(dirty_rows))

    # -- pipeline ------------------------------------------------------------

    def on_pipeline_event(self, event: str) -> None:
        """drain | discard | fetch-failure — the pipelined serving loop's
        exceptional paths, countable so a drain storm is visible."""
        self.registry.counter(PIPELINE_EVENTS, event=event).inc()

    # -- transfers -----------------------------------------------------------

    def on_transfer(self, direction: str, nbytes: int) -> None:
        """Host->device ("h2d") / device->host ("d2h") bytes the serving
        path actually ships (delta rows, full uploads, decision blobs)."""
        if nbytes > 0:
            self.registry.counter(TRANSFER_BYTES, direction=direction).inc(
                int(nbytes)
            )


# Fault-tolerance subsystem: injected-fault counts per surface, retry-ladder
# activity and breaker state.
FAULTS_INJECTED = "foundry.spark.scheduler.faults.injected"
RETRY_ATTEMPTS = "foundry.spark.scheduler.retry.attempts"
RETRY_BACKOFF_MS = "foundry.spark.scheduler.retry.backoff.ms"
RETRY_BREAKER_STATE = "foundry.spark.scheduler.retry.breaker.state"
RETRY_BREAKER_OPENS = "foundry.spark.scheduler.retry.breaker.opens"

# Breaker-state gauge encoding (a label would fragment the series).
BREAKER_STATE_VALUES = {"closed": 0, "half-open": 1, "open": 2}


class RetryTelemetry:
    """`foundry.spark.scheduler.retry.*` — the shared retry ladder's
    activity, tagged by consumer (kube-write-back, lease, reflector,
    autoscaler) so one hammering consumer is attributable."""

    def __init__(self, registry: MetricRegistry | None = None):
        self.registry = registry or MetricRegistry()

    def on_retry(self, consumer: str, attempt: int, backoff_s: float) -> None:
        self.registry.counter(RETRY_ATTEMPTS, consumer=consumer).inc()
        self.registry.histogram(RETRY_BACKOFF_MS, consumer=consumer).update(
            round(backoff_s * 1e3, 3)
        )

    def retry_hook(self, consumer: str):
        """fn(attempt, exc, pause) for RetryPolicy.call's on_retry."""

        def hook(attempt, exc, pause) -> None:
            self.on_retry(consumer, attempt, pause)

        return hook

    def breaker_hook(self, consumer: str):
        """fn(old, new) for CircuitBreaker's on_transition."""

        def hook(old: str, new: str) -> None:
            self.registry.gauge(
                RETRY_BREAKER_STATE, consumer=consumer
            ).set(BREAKER_STATE_VALUES.get(new, -1))
            if new == "open":
                self.registry.counter(
                    RETRY_BREAKER_OPENS, consumer=consumer
                ).inc()

        return hook

    def fault_hook(self):
        """fn(surface, action) for FaultInjector.on_fire: per-surface
        injected-fault counts, so a chaos run's blast radius reads
        straight off /metrics."""

        def hook(surface: str, action: str) -> None:
            self.registry.counter(
                FAULTS_INJECTED, surface=surface, action=action
            ).inc()

        return hook


class TransportTelemetry:
    """`foundry.spark.scheduler.server.*` — HTTP transport internals.

    The event-loop transport mutates the phase accumulators (`parse_s`,
    `queue_s`, `write_s`, `bytes_in/out`) directly from its single loop
    thread — no lock on the hot path; the method hooks (connections,
    requests, sheds) take the lock because the threaded transport calls
    them from many handler threads. `stats()` renders the snapshot that
    GET /metrics surfaces (JSON key `server_transport`, Prometheus extra
    gauges under the server prefix) — the same pull discipline as the
    predicate batcher's stats."""

    def __init__(self, transport: str, ingest: str = "python"):
        self.transport = transport
        # Which ingest lane the server resolved to (post-degrade): rides
        # the transport snapshot so a scrape shows transport x ingest.
        self.ingest = ingest
        self._lock = threading.Lock()
        self.open_connections = 0
        self.connections_total = 0
        self.requests_total = 0
        # Requests beyond the first on a persistent connection: the
        # keep-alive reuse the transport actually delivered.
        self.keepalive_requests = 0
        self.connection_sheds = 0  # max-connections 503s
        self.queue_sheds = 0  # batcher-depth 503s (routing layer)
        self.body_rejections = 0  # max-body-bytes 413s
        # Phase accumulators (seconds + sample counts): request parse,
        # dispatch->respond (the batcher window for predicates), and
        # response assembly+write.
        self.parse_s = 0.0
        self.parse_samples = 0
        self.queue_s = 0.0
        self.queue_samples = 0
        self.write_s = 0.0
        self.write_samples = 0
        self.bytes_in = 0
        self.bytes_out = 0

    def on_connection_open(self) -> None:
        with self._lock:
            self.open_connections += 1
            self.connections_total += 1

    def on_connection_close(self) -> None:
        with self._lock:
            self.open_connections = max(0, self.open_connections - 1)

    def on_connection_shed(self) -> None:
        with self._lock:
            self.connection_sheds += 1

    def on_queue_shed(self) -> None:
        with self._lock:
            self.queue_sheds += 1

    def on_request(self, *, reused: bool) -> None:
        with self._lock:
            self.requests_total += 1
            if reused:
                self.keepalive_requests += 1

    def on_body_rejected(self) -> None:
        with self._lock:
            self.body_rejections += 1

    def on_bytes_out(self, nbytes: int) -> None:
        with self._lock:
            self.bytes_out += nbytes

    @staticmethod
    def _mean_ms(total_s: float, samples: int):
        return round(total_s * 1e3 / samples, 4) if samples else None

    def stats(self) -> dict:
        requests = self.requests_total
        return {
            "transport": self.transport,
            "ingest": self.ingest,
            "open_connections": self.open_connections,
            "connections_total": self.connections_total,
            "requests_total": requests,
            "keepalive_requests": self.keepalive_requests,
            "keepalive_reuse_ratio": round(
                self.keepalive_requests / requests, 4
            )
            if requests
            else 0.0,
            "connection_sheds": self.connection_sheds,
            "queue_sheds": self.queue_sheds,
            "body_rejections": self.body_rejections,
            "parse_mean_ms": self._mean_ms(self.parse_s, self.parse_samples),
            "queue_mean_ms": self._mean_ms(self.queue_s, self.queue_samples),
            "write_mean_ms": self._mean_ms(self.write_s, self.write_samples),
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
        }


# HA replica runtime (spark_scheduler_tpu_torch/ha/): role, fencing epoch, lease
# age, promotion/reconcile wall times, and fenced-write rejects — the
# series an operator's failover dashboard keys on.
HA_ROLE = "foundry.spark.scheduler.ha.role"
HA_EPOCH = "foundry.spark.scheduler.ha.epoch"
HA_LEASE_AGE = "foundry.spark.scheduler.ha.lease.age.seconds"
HA_PROMOTION_MS = "foundry.spark.scheduler.ha.promotion.ms"
HA_RECONCILE_MS = "foundry.spark.scheduler.ha.reconcile.ms"
HA_FENCED_REJECTS = "foundry.spark.scheduler.ha.fenced.write.rejects"
HA_TAILED_EVENTS = "foundry.spark.scheduler.ha.standby.tailed.events"

# Role gauge encoding (a label would fragment the series per role flip).
HA_ROLE_VALUES = {"standby": 0, "leader": 1, "active": 2, "deposed": -1}


class HATelemetry:
    """`foundry.spark.scheduler.ha.*` — one replica's election state."""

    def __init__(self, registry: MetricRegistry | None = None, replica: str = ""):
        self.registry = registry or MetricRegistry()
        self.replica = replica

    def _tags(self) -> dict:
        return {"replica": self.replica} if self.replica else {}

    def on_role(self, role: str) -> None:
        self.registry.gauge(HA_ROLE, **self._tags()).set(
            HA_ROLE_VALUES.get(role, -1)
        )

    def on_lease(self, epoch: int, age_s) -> None:
        tags = self._tags()
        self.registry.gauge(HA_EPOCH, **tags).set(int(epoch))
        if age_s is not None:
            self.registry.gauge(HA_LEASE_AGE, **tags).set(round(age_s, 3))

    def on_promotion(self, promotion_ms: float, reconcile_ms: float) -> None:
        tags = self._tags()
        self.registry.histogram(HA_PROMOTION_MS, **tags).update(
            round(promotion_ms, 3)
        )
        self.registry.histogram(HA_RECONCILE_MS, **tags).update(
            round(reconcile_ms, 3)
        )

    def on_fenced_reject(self) -> None:
        self.registry.counter(HA_FENCED_REJECTS, **self._tags()).inc()

    def on_tailed(self, applied: int) -> None:
        self.registry.gauge(HA_TAILED_EVENTS, **self._tags()).set(applied)


FLEET_CLUSTERS_LIVE = "foundry.spark.scheduler.fleet.clusters.live"
FLEET_DECISIONS = "foundry.spark.scheduler.fleet.decisions"
FLEET_ROUTER_PICKS = "foundry.spark.scheduler.fleet.router.picks"
FLEET_FORWARDED = "foundry.spark.scheduler.fleet.forwarded"
FLEET_SPILLOVERS = "foundry.spark.scheduler.fleet.spillovers"
FLEET_SPILLOVER_DENIED = "foundry.spark.scheduler.fleet.spillover.denied"
FLEET_ORPHANS_REROUTED = "foundry.spark.scheduler.fleet.orphans.rerouted"
FLEET_AGG_EVENTS = "foundry.spark.scheduler.fleet.aggregate.events.applied"
# Fused fleet dispatch (fleet/dispatch.py): stacked launches,
# windows-per-launch, fallback singles, and how long a deferred window
# waited in the gather before its flush.
FLEET_DISPATCH_STACKED = "foundry.spark.scheduler.fleet.dispatch.stacked"
FLEET_DISPATCH_ARMS = "foundry.spark.scheduler.fleet.dispatch.arms"
FLEET_DISPATCH_FALLBACKS = "foundry.spark.scheduler.fleet.dispatch.fallbacks"
FLEET_DISPATCH_GATHER_WAIT_MS = (
    "foundry.spark.scheduler.fleet.dispatch.gather.wait.ms"
)


class FleetTelemetry:
    """`foundry.spark.scheduler.fleet.*` — the facade's two-level serving
    surface: live cluster count, per-cluster decision counters, router
    pick reasons, spillovers by (from, to), and aggregate freshness."""

    def __init__(self, registry: MetricRegistry | None = None):
        self.registry = registry or MetricRegistry()

    def on_live(self, live: int) -> None:
        self.registry.gauge(FLEET_CLUSTERS_LIVE).set(int(live))

    def on_decision(self, cluster: int) -> None:
        self.registry.counter(FLEET_DECISIONS, cluster=str(cluster)).inc()

    def on_pick(self, reason: str) -> None:
        self.registry.counter(FLEET_ROUTER_PICKS, reason=reason).inc()

    def on_forwarded(self) -> None:
        self.registry.counter(FLEET_FORWARDED).inc()

    def on_spillover(self, home: int, sibling: int) -> None:
        self.registry.counter(
            FLEET_SPILLOVERS, from_cluster=str(home), to_cluster=str(sibling)
        ).inc()

    def on_spillover_denied(self, home: int) -> None:
        self.registry.counter(
            FLEET_SPILLOVER_DENIED, from_cluster=str(home)
        ).inc()

    def on_orphans_rerouted(self, n: int) -> None:
        if n:
            self.registry.counter(FLEET_ORPHANS_REROUTED).inc(n)

    def on_aggregate_events(self, cluster: int, applied: int) -> None:
        self.registry.gauge(FLEET_AGG_EVENTS, cluster=str(cluster)).set(
            int(applied)
        )

    # -- fused fleet dispatch (fleet/dispatch.py) ----------------------------

    def on_stacked_dispatch(self, arms: int) -> None:
        self.registry.counter(FLEET_DISPATCH_STACKED).inc()
        self.registry.counter(FLEET_DISPATCH_ARMS).inc(arms)

    def on_stack_fallback(self, reason: str) -> None:
        self.registry.counter(FLEET_DISPATCH_FALLBACKS, reason=reason).inc()

    def on_gather_wait(self, wait_ms: float) -> None:
        self.registry.histogram(FLEET_DISPATCH_GATHER_WAIT_MS).update(
            round(wait_ms, 3)
        )
