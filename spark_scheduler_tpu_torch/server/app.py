"""Dependency wiring — the initServer DI graph (cmd/server.go:56-266).

`build_scheduler_app` assembles every component of the scheduler around a
ClusterBackend: caches with async write-back, soft-reservation store,
reservation manager, overhead computer, demand manager + GC, failover
reconciler, placement solver, the extender, and the unschedulable-pod
marker. The same builder serves tests (sync writes, in-memory backend) and
the HTTP server (async write-back, background loops).

The port's copy of spark_scheduler_tpu/server/app.py. The wiring is the
JAX package's, line for line, for every option the port supports. The
solver runs on the card unless the caller passes `device="cpu"`. The port
serves every install key of the JAX package; a key it could not serve
would raise NotImplementedError up front, naming the key
(`unsupported_keys`): `build_scheduler_app` never degrades quietly.
`jax-compilation-cache-dir` names the directory the port's CUDA kernels
and native runtime build into and load from (ops/_build.py
`use_build_dir`), applied before anything loads one. With `kube_api_url` set the
app carries a `KubeIngestion` (node and pod reflectors, or the in-cluster
serviceaccount variant) that `start_background` starts first. With the
flight recorder on (the default) the solver carries SolverTelemetry, as in
the JAX package. With `policy.enabled` the extender carries a PolicyEngine
(priority or DRF ordering, the preemption search on the solver's device,
the defragmenter); with `autoscaler.enabled` the app carries an
ElasticAutoscaler over a ClusterCensus, started and stopped with the app.
`solver.device-pool` / `solver.mesh` give the solver a device pool, of
node-sharded mesh slots when `solver.mesh.node-shards` > 1, and
`solver.scale-tier` its node-sharded re-solves (`pool_devices=` names the
devices instead, several on one card allowed), and the solver always carries the DegradedModeController of
`server.degraded-mode`, as in the JAX package. With `trace.path` (and the
flight recorder on) the app carries a replay.TraceWriter: the recorder's
sink plus node and pod subscriptions journal every decision's inputs and
results (`fleet.*` is served by fleet/facade.py, which builds one app per
cluster).
"""

from __future__ import annotations

import dataclasses

from spark_scheduler_tpu_torch.core.binpacker import select_binpacker
from spark_scheduler_tpu_torch.core.demands import DemandManager, start_demand_gc
from spark_scheduler_tpu_torch.core.extender import ExtenderConfig, SparkSchedulerExtender
from spark_scheduler_tpu_torch.core.failover import FailoverReconciler
from spark_scheduler_tpu_torch.core.overhead import OverheadComputer
from spark_scheduler_tpu_torch.core.reservation_manager import ResourceReservationManager
from spark_scheduler_tpu_torch.core.solver import PlacementSolver
from spark_scheduler_tpu_torch.core.soft_reservations import SoftReservationStore
from spark_scheduler_tpu_torch.core.sparkpods import SparkPodLister
from spark_scheduler_tpu_torch.core.unschedulable import UnschedulablePodMarker
from spark_scheduler_tpu_torch.core.usage_tracker import ReservedUsageTracker
from spark_scheduler_tpu_torch.ops._build import use_build_dir
from spark_scheduler_tpu_torch.server.config import InstallConfig
from spark_scheduler_tpu_torch.store.backend import ClusterBackend, DEMAND_CRD
from spark_scheduler_tpu_torch.store.cache import ResourceReservationCache, SafeDemandCache
from spark_scheduler_tpu_torch.store.crd import (
    LazyDemandCRDWatcher,
    ensure_resource_reservations_crd,
)


# Install keys the port cannot serve yet: field -> (YAML key, where it is
# ported). A field that differs from InstallConfig's default raises. The
# port serves every key of the JAX package.
UNSUPPORTED_KEYS: dict = {}


def unsupported_keys(config: InstallConfig) -> list[str]:
    """One message per install key of `config` the port cannot serve."""
    defaults = {f.name: f for f in dataclasses.fields(InstallConfig)}
    out = []
    for field, (key, where) in UNSUPPORTED_KEYS.items():
        f = defaults[field]
        default = (
            f.default_factory()
            if f.default is dataclasses.MISSING
            else f.default
        )
        value = getattr(config, field)
        if value != default:
            out.append(
                f"{key}: {value!r} is not supported by the port "
                f"(default {default!r}; {where})"
            )
    return out


@dataclasses.dataclass
class SchedulerApp:
    backend: ClusterBackend
    config: InstallConfig
    rr_cache: ResourceReservationCache
    demand_cache: SafeDemandCache
    soft_store: SoftReservationStore
    pod_lister: SparkPodLister
    reservation_manager: ResourceReservationManager
    overhead_computer: OverheadComputer
    demand_manager: DemandManager
    reconciler: FailoverReconciler
    solver: PlacementSolver
    extender: SparkSchedulerExtender
    unschedulable_marker: UnschedulablePodMarker
    demand_crd_watcher: LazyDemandCRDWatcher
    ingestion: object | None = None  # KubeIngestion when kube_api_url is set
    runtime_manager: object | None = None  # RuntimeConfigManager when configured
    autoscaler: object | None = None  # ElasticAutoscaler when enabled
    recorder: object | None = None  # FlightRecorder when flight_recorder is on
    trace_writer: object | None = None  # replay.TraceWriter when trace_path set
    _background_started: bool = False

    def start_background(self) -> None:
        """Async write-back workers + background loops (cmd/server.go:239-247).
        Ingestion reflectors start first so WaitForCacheSync-style readiness
        can observe them (cmd/server.go:111-147). Idempotent: the CLI calls
        it before reconciliation and SchedulerHTTPServer.start() calls it
        again."""
        if self._background_started:
            return
        self._background_started = True
        # Boot-heap freeze: everything constructed by
        # build_scheduler_app is long-lived; freezing it keeps steady-state
        # gen-2 collections from re-scanning the boot heap on the serving
        # tail.
        from spark_scheduler_tpu_torch.server.runtime import freeze_boot_heap

        freeze_boot_heap()
        if self.ingestion is not None:
            self.ingestion.start()
        self.rr_cache.start()
        self.unschedulable_marker.start()
        self.demand_crd_watcher.start()
        if self.autoscaler is not None:
            self.autoscaler.start()
        if self.runtime_manager is not None:
            self.runtime_manager.start()

    def stop(self) -> None:
        if self.runtime_manager is not None:
            self.runtime_manager.stop()
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.ingestion is not None:
            self.ingestion.stop()
        self.demand_crd_watcher.stop()
        self.unschedulable_marker.stop()
        self.rr_cache.flush()
        self.rr_cache.stop()
        self.demand_cache.flush()
        self.demand_cache.stop()
        self.solver.close()
        if self.trace_writer is not None:
            self.trace_writer.close()


def build_scheduler_app(
    backend: ClusterBackend,
    config: InstallConfig | None = None,
    metrics=None,
    events=None,
    waste=None,
    clock=None,
    *,
    device="cuda",
    pool_devices=None,
    use_native: bool = True,
) -> SchedulerApp:
    """The scheduler app over `backend`. `device` is where the solver
    solves (the card unless the caller asks for "cpu"); `pool_devices`
    lays the window-solve pool's slots on named devices; `use_native=False`
    gives the solver the dense Python host build instead of the native
    arena's resident build (the tests' oracle twin)."""
    import time as _time

    config = config or InstallConfig()
    clock = clock or _time.time
    refused = unsupported_keys(config)
    if refused:
        raise NotImplementedError("; ".join(refused))
    if config.jax_compilation_cache_dir:
        # Before anything loads a kernel or the native runtime. A
        # RuntimeError, never an OSError: the fault classifier counts
        # OSError as a device fault.
        try:
            use_build_dir(config.jax_compilation_cache_dir)
        except OSError as exc:
            raise RuntimeError(
                "jax-compilation-cache-dir: "
                f"{config.jax_compilation_cache_dir!r} cannot hold the "
                f"port's compiled libraries: {exc}"
            ) from exc

    # The scheduler owns its reservation CRD: create-or-upgrade + verify
    # Established before anything consumes it (cmd/server.go:103-109); the
    # full manifest (schemas + conversion strategy) is registered.
    ensure_resource_reservations_crd(
        backend, webhook_url=config.conversion_webhook_url
    )

    # Shared retry ladder: ONE policy shape for every kube
    # write-back consumer, with a per-kind circuit breaker so a down
    # backend is probed instead of hammered. `async_client_retry_count`
    # remains the attempt budget exactly as before.
    from spark_scheduler_tpu_torch.faults.retry import CircuitBreaker, RetryPolicy
    from spark_scheduler_tpu_torch.observability.telemetry import RetryTelemetry

    retry_policy = RetryPolicy(
        max_attempts=config.async_client_retry_count + 1,
        base_delay_s=config.retry_base_delay_s,
        multiplier=config.retry_multiplier,
        max_delay_s=config.retry_max_delay_s,
    )
    retry_telemetry = RetryTelemetry(
        metrics.registry if metrics is not None else None
    )

    def _breaker(consumer: str):
        if config.breaker_failure_threshold <= 0:
            return None
        return CircuitBreaker(
            failure_threshold=config.breaker_failure_threshold,
            reset_timeout_s=config.breaker_reset_timeout_s,
            on_transition=retry_telemetry.breaker_hook(consumer),
            name=consumer,
        )

    rr_cache = ResourceReservationCache(
        backend,
        max_retries=config.async_client_retry_count,
        sync_writes=config.sync_writes,
        retry_policy=retry_policy,
        breaker=_breaker("rr-write-back"),
        on_retry=lambda n, pause: retry_telemetry.on_retry(
            "rr-write-back", n, pause
        ),
    )
    demand_cache = SafeDemandCache(
        backend,
        max_retries=config.async_client_retry_count,
        sync_writes=config.sync_writes,
        retry_policy=retry_policy,
        breaker=_breaker("demand-write-back"),
        on_retry=lambda n, pause: retry_telemetry.on_retry(
            "demand-write-back", n, pause
        ),
    )
    soft_store = SoftReservationStore(backend)
    pod_lister = SparkPodLister(backend, config.instance_group_label)
    reservation_manager = ResourceReservationManager(
        backend, rr_cache, soft_store, pod_lister
    )
    overhead_computer = OverheadComputer(backend, reservation_manager)
    binpacker = select_binpacker(config.binpack_algo)
    demand_manager = DemandManager(
        backend,
        demand_cache,
        config.instance_group_label,
        is_single_az_binpacker=binpacker.is_single_az,
        events=events,
        waste=waste,
        clock=clock,
    )
    # Demand features activate only once the Demand CRD exists — it belongs
    # to the external autoscaler and may appear any time after startup
    # (demand_informer.go:75-138). SafeDemandCache additionally gates every
    # operation; the watcher wires the push-style consumers (GC, waste).
    demand_crd_watcher = LazyDemandCRDWatcher(backend, DEMAND_CRD)
    demand_crd_watcher.on_ready(lambda: start_demand_gc(backend, demand_manager))

    # Waste / retry-state lifecycle hooks (waste.go:90-146 informer hookup):
    # pod scheduled -> close out waste phases; pod deleted -> drop state.
    if waste is not None or metrics is not None:

        def _on_pod_update(old, new):
            if waste is not None and not old.node_name and new.node_name:
                waste.on_pod_scheduled(new)

        def _on_pod_delete(pod):
            if waste is not None:
                waste.on_pod_deleted(pod)
            if metrics is not None and hasattr(metrics, "forget_pod"):
                metrics.forget_pod(pod)

        backend.subscribe("pods", on_update=_on_pod_update, on_delete=_on_pod_delete)
    if waste is not None:
        from spark_scheduler_tpu_torch.models.demands import DEMAND_NAME_PREFIX

        def _on_demand_update(old, new):
            # The external autoscaler flips the phase to fulfilled
            # (waste.go:235-243 OnDemandFulfilled); it arrives here as a
            # backend demand update.
            if new.is_fulfilled() and not old.is_fulfilled():
                pod_name = new.name[len(DEMAND_NAME_PREFIX):]
                waste.on_demand_fulfilled((new.namespace, pod_name))

        demand_crd_watcher.on_ready(
            lambda: backend.subscribe("demands", on_update=_on_demand_update)
        )
    # The window-solve device pool: `solver.mesh {groups, node-shards}`
    # wins over the `solver.device-pool` shorthand when both are set
    # (node-shards > 1: mesh slots on the node-sharded engine).
    # `pool_devices` names the flat device list instead (repeats allowed).
    mesh = None
    if config.solver_mesh_groups or config.solver_mesh_node_shards:
        mesh = (
            config.solver_mesh_groups or 1,
            config.solver_mesh_node_shards or 1,
        )
    solver = PlacementSolver(
        driver_label_priority=(
            config.driver_prioritized_node_label.as_tuple()
            if config.driver_prioritized_node_label
            else None
        ),
        executor_label_priority=(
            config.executor_prioritized_node_label.as_tuple()
            if config.executor_prioritized_node_label
            else None
        ),
        device=device,
        device_pool=config.solver_device_pool,
        mesh=mesh,
        quarantine_probe_s=config.quarantine_probe_s,
        pool_devices=pool_devices,
        prune_top_k=config.solver_prune_top_k,
        prune_slack=config.solver_prune_slack,
        delta_statics=config.solver_delta_statics,
        use_native=use_native,
        build_oracle=config.solver_build_oracle,
        lazy_warm_start=config.solver_lazy_warm_start,
        scale_tier=config.solver_scale_tier,
    )
    recorder = None
    if config.flight_recorder:
        # Flight recorder + solver telemetry: decision explainability
        # (GET /debug/decisions) and foundry.spark.scheduler.solver.*
        # series. Telemetry lands in the caller's registry when metrics
        # are wired so GET /metrics exposes it; otherwise it keeps a
        # private registry (still drives build hit/miss on records).
        from spark_scheduler_tpu_torch.observability import (
            FlightRecorder,
            SolverTelemetry,
        )

        recorder = FlightRecorder(
            capacity=config.flight_recorder_capacity, clock=clock
        )
        solver.telemetry = SolverTelemetry(
            metrics.registry if metrics is not None else None
        )
    trace_writer = None
    if config.trace_path:
        if recorder is None:
            import warnings

            warnings.warn(
                "trace.path set but the flight recorder is disabled — "
                "decision tracing requires flight-recorder: true; "
                "no trace will be written",
                RuntimeWarning,
                stacklevel=2,
            )
        else:
            # Durable decision trace: header (config fingerprint) ->
            # bootstrap journal of the pre-existing world -> live event
            # hooks. The sink rides the recorder, so the extender's capture
            # wrappers cost one attribute check when tracing is off.
            from spark_scheduler_tpu_torch.replay.trace import TraceWriter

            trace_writer = TraceWriter(
                config.trace_path,
                clock=clock,
                decisions=config.trace_decisions,
                epoch_fn=lambda: getattr(backend, "nodes_version", None),
            )
            trace_writer.write_header(config)
            trace_writer.bootstrap(backend)
            recorder.attach_sink(trace_writer)
            backend.order_events_with(trace_writer.order_lock)
            backend.subscribe(
                "nodes",
                on_add=trace_writer.on_node_add,
                on_update=trace_writer.on_node_update,
                on_delete=trace_writer.on_node_delete,
            )
            backend.subscribe(
                "pods",
                on_add=trace_writer.on_pod_add,
                on_update=trace_writer.on_pod_update,
                on_delete=trace_writer.on_pod_delete,
            )
    # Degraded-mode controller: when no device can serve, the solver
    # consults this policy — host greedy fallback or 503+Retry-After
    # shedding. Readiness and /debug/state reflect it.
    from spark_scheduler_tpu_torch.faults.degraded import DegradedModeController

    solver.degraded = DegradedModeController(
        policy=config.degraded_mode,
        retry_after_s=config.degraded_retry_after_s,
        clock=clock,
        on_change=(
            solver.telemetry.on_degraded
            if solver.telemetry is not None
            else None
        ),
    )
    # Delta-maintained reserved-usage aggregate over the solver's node-index
    # space: the hot path reads a dense array instead of walking every
    # reservation slot per request (SURVEY.md §7 latency budget).
    reservation_manager.attach_usage_tracker(
        ReservedUsageTracker(solver.registry, rr_cache, soft_store)
    )
    reconciler = FailoverReconciler(
        backend,
        pod_lister,
        rr_cache,
        soft_store,
        demand_manager,
        overhead_computer,
        config.instance_group_label,
    )
    # Policy engine: constructed ONLY when enabled — with policy=None every
    # extender hook takes the exact pre-policy branch, keeping the default
    # FIFO path byte-identical.
    policy = None
    if config.policy_enabled:
        from spark_scheduler_tpu_torch.policy import PolicyConfig, PolicyEngine

        policy = PolicyEngine(
            PolicyConfig(
                ordering=config.policy_ordering,
                preemption=config.policy_preemption,
                max_evictions=config.policy_max_evictions,
                promote_after_s=config.policy_promote_after_s,
                defrag=config.policy_defrag,
                defrag_interval_s=config.policy_defrag_interval_s,
                defrag_budget=config.policy_defrag_budget,
                protected_class=config.policy_protected_class,
            ),
            backend=backend,
            rr_cache=rr_cache,
            pod_lister=pod_lister,
            soft_store=soft_store,
            reservation_manager=reservation_manager,
            solver=solver,
            clock=clock,
            metrics_registry=(
                metrics.registry if metrics is not None else None
            ),
        )
    extender = SparkSchedulerExtender(
        backend,
        pod_lister,
        reservation_manager,
        demand_manager,
        overhead_computer,
        binpacker,
        solver,
        config=ExtenderConfig(
            fifo=config.fifo,
            fifo_config=config.fifo_config,
            instance_group_label=config.instance_group_label,
            schedule_dynamically_allocated_executors_in_same_az=(
                config.should_schedule_dynamically_allocated_executors_in_same_az
            ),
            batched_admission=config.batched_admission,
            resync_gap_seconds=config.resync_gap_seconds,
        ),
        reconciler=reconciler,
        metrics=metrics,
        events=events,
        waste=waste,
        recorder=recorder,
        clock=clock,
        policy=policy,
    )
    marker = UnschedulablePodMarker(
        backend,
        overhead_computer,
        binpacker,
        solver,
        timeout_s=config.unschedulable_pod_timeout_s,
        clock=clock,
    )
    ingestion = None
    # The informer-delay histogram lands in the metric registry. The JAX
    # package hands ingestion the SchedulerMetrics facade, which has no
    # `histogram`: there every watched pod add with a creation timestamp
    # raises AttributeError in the reflector, which relists.
    registry = metrics.registry if metrics is not None else None
    if config.kube_api_url == "in-cluster":
        # Serviceaccount CA + rotating bearer token against
        # https://kubernetes.default.svc (rest.InClusterConfig slot,
        # cmd/server.go:57-75 "kube-config-type: in-cluster").
        from spark_scheduler_tpu_torch.kube.reflector import in_cluster_ingestion

        ingestion = in_cluster_ingestion(backend, metrics=registry, clock=clock)
    elif config.kube_api_url:
        from spark_scheduler_tpu_torch.kube.reflector import KubeIngestion

        ingestion = KubeIngestion(
            backend,
            config.kube_api_url,
            metrics=registry,
            clock=clock,
            insecure_skip_tls_verify=config.kube_api_insecure_skip_tls_verify,
        )
    autoscaler = None
    if config.autoscaler_enabled:
        # In-process elastic autoscaler: consumes the pending demands this
        # scheduler emits, provisions simulated nodes through the same
        # backend, and drains idle ones — replacing the external cluster
        # autoscaler.
        from spark_scheduler_tpu_torch.autoscaler import (
            AutoscalerMetrics,
            ElasticAutoscaler,
            NodeProvisioner,
            ScaleDownDrainer,
        )
        from spark_scheduler_tpu_torch.autoscaler.provisioner import (
            PROVISIONED_BY_LABEL,
            PROVISIONER_NAME,
        )
        from spark_scheduler_tpu_torch.core.census import ClusterCensus
        from spark_scheduler_tpu_torch.models.resources import Resources

        # Event-maintained control-loop census: the autoscaler's cluster
        # size and the drainer's busy/never-drain sets are resident
        # O(changed) state instead of per-pass full walks.
        census = ClusterCensus(
            backend,
            rr_cache,
            soft_store,
            eligible_label=(PROVISIONED_BY_LABEL, PROVISIONER_NAME),
        )
        autoscaler = ElasticAutoscaler(
            backend,
            provisioner=NodeProvisioner(
                backend,
                config.instance_group_label,
                Resources.from_quantities(
                    config.autoscaler_node_cpu,
                    config.autoscaler_node_memory,
                    config.autoscaler_node_gpu,
                    round_up=False,
                ),
                zones=config.autoscaler_zones,
                clock=clock,
            ),
            drainer=ScaleDownDrainer(
                backend,
                rr_cache,
                soft_store,
                idle_ttl_s=config.autoscaler_idle_ttl_s,
                clock=clock,
                census=census,
            ),
            census=census,
            max_cluster_size=config.autoscaler_max_cluster_size,
            poll_interval_s=config.autoscaler_poll_interval_s,
            metrics=AutoscalerMetrics(registry),
            recorder=recorder,
            clock=clock,
        )
        # The demand-add wakeup waits for the Demand CRD like every other
        # demand consumer.
        demand_crd_watcher.on_ready(autoscaler.attach)
    # A pre-existing Demand CRD (registered before the app was built)
    # activates demand features synchronously; otherwise the background
    # poll in start_background() picks it up.
    demand_crd_watcher.check_now()
    app = SchedulerApp(
        backend=backend,
        config=config,
        rr_cache=rr_cache,
        demand_cache=demand_cache,
        soft_store=soft_store,
        pod_lister=pod_lister,
        reservation_manager=reservation_manager,
        overhead_computer=overhead_computer,
        demand_manager=demand_manager,
        reconciler=reconciler,
        solver=solver,
        extender=extender,
        unschedulable_marker=marker,
        demand_crd_watcher=demand_crd_watcher,
        ingestion=ingestion,
        autoscaler=autoscaler,
        recorder=recorder,
        trace_writer=trace_writer,
    )
    if config.runtime_config_path:
        from spark_scheduler_tpu_torch.server.runtime import RuntimeConfigManager

        app.runtime_manager = RuntimeConfigManager(app, config.runtime_config_path)
    return app
