"""Dependency wiring — the initServer DI graph (cmd/server.go:56-266).

`build_scheduler_app` assembles every component of the scheduler around a
ClusterBackend: caches with async write-back, soft-reservation store,
reservation manager, overhead computer, demand manager + GC, failover
reconciler, placement solver, the extender, and the unschedulable-pod
marker. The same builder serves tests (sync writes, in-memory backend) and
the HTTP server (async write-back, background loops).

The port's copy of spark_scheduler_tpu/server/app.py. The wiring is the
JAX package's, line for line, for every option the port supports. The
solver runs on the card unless the caller passes `device="cpu"`. An
install key the port cannot serve yet raises NotImplementedError up front,
naming the key and the ROADMAP item that ports it (`unsupported_keys`):
`build_scheduler_app` never degrades quietly. With `kube_api_url` set the
app carries a `KubeIngestion` (node and pod reflectors, or the in-cluster
serviceaccount variant) that `start_background` starts first. With the
flight recorder on (the default) the solver carries SolverTelemetry, as in
the JAX package. One
part of the JAX wiring is absent by design until its module is ported:
the degraded-mode controller (`solver.degraded` is unset, so readiness
answers as a healthy server does and a solve failure reaches the client
through the protocol's Error channel).
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
from spark_scheduler_tpu_torch.server.config import InstallConfig
from spark_scheduler_tpu_torch.store.backend import ClusterBackend, DEMAND_CRD
from spark_scheduler_tpu_torch.store.cache import ResourceReservationCache, SafeDemandCache
from spark_scheduler_tpu_torch.store.crd import (
    LazyDemandCRDWatcher,
    ensure_resource_reservations_crd,
)


# Install keys the port cannot serve yet: field -> (YAML key, where it is
# ported). A field that differs from InstallConfig's default raises.
UNSUPPORTED_KEYS = {
    "solver_device_pool": ("solver.device-pool", "ROADMAP A.4"),
    "solver_mesh_groups": ("solver.mesh.groups", "ROADMAP A.4"),
    "solver_mesh_node_shards": ("solver.mesh.node-shards", "ROADMAP A.6"),
    "solver_scale_tier": ("solver.scale-tier", "ROADMAP A.6"),
    "solver_build_oracle": ("solver.build-oracle", "ROADMAP B.5"),
    "degraded_mode": ("server.degraded-mode", "ROADMAP A.5"),
    "autoscaler_enabled": ("autoscaler.enabled", "ROADMAP A.3"),
    "policy_enabled": ("policy.enabled", "ROADMAP A.2"),
    "trace_path": ("trace.path", "ROADMAP A.7"),
    "fleet_enabled": ("fleet.enabled", "ROADMAP A.7"),
    "fleet_clusters": ("fleet.clusters", "ROADMAP A.7"),
    "fleet_max_spillover_hops": ("fleet.max-spillover-hops", "ROADMAP A.7"),
    "fleet_stack_window_ms": ("fleet.stack-window-ms", "ROADMAP A.7"),
    "jax_compilation_cache_dir": (
        "jax-compilation-cache-dir",
        "none: the port's kernels build into spark_scheduler_tpu_torch/_build/",
    ),
}


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
    recorder: object | None = None  # FlightRecorder when flight_recorder is on
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
        if self.runtime_manager is not None:
            self.runtime_manager.start()

    def stop(self) -> None:
        if self.runtime_manager is not None:
            self.runtime_manager.stop()
        if self.ingestion is not None:
            self.ingestion.stop()
        self.demand_crd_watcher.stop()
        self.unschedulable_marker.stop()
        self.rr_cache.flush()
        self.rr_cache.stop()
        self.demand_cache.flush()
        self.demand_cache.stop()
        self.solver.close()


def build_scheduler_app(
    backend: ClusterBackend,
    config: InstallConfig | None = None,
    metrics=None,
    events=None,
    waste=None,
    clock=None,
    *,
    device="cuda",
) -> SchedulerApp:
    import time as _time

    config = config or InstallConfig()
    clock = clock or _time.time
    refused = unsupported_keys(config)
    if refused:
        raise NotImplementedError("; ".join(refused))

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
    # One device serves every window: the device pool and the mesh are
    # refused above.
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
        prune_top_k=config.solver_prune_top_k,
        prune_slack=config.solver_prune_slack,
        delta_statics=config.solver_delta_statics,
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
        recorder=recorder,
    )
    if config.runtime_config_path:
        from spark_scheduler_tpu_torch.server.runtime import RuntimeConfigManager

        app.runtime_manager = RuntimeConfigManager(app, config.runtime_config_path)
    return app
