"""CLI (cmd/root.go:22-35, cmd/server.go:44-54):

  python -m spark_scheduler_tpu_torch server [--config install.yml] [--port N]
      [--transport threaded|async] [--ingest python|native]
      [--kube-api-url URL|in-cluster] [--durable-store WAL]
      [--ha-replica ID [--ha-lease-ttl SECONDS]] [--autoscaler]
      [--device-pool N | --mesh GROUPSxSHARDS] [--scale-tier]
      [--fleet-stack MS]
  python -m spark_scheduler_tpu_torch print-crds [--conversion-webhook-url URL]
  python -m spark_scheduler_tpu_torch conversion-webhook [--port N]
  python -m spark_scheduler_tpu_torch version

`conversion-webhook` is the standalone CRD-conversion service the reference
ships as a second binary (spark-scheduler-conversion-webhook/main.go:27).

The port's copy of spark_scheduler_tpu/__main__.py: the in-memory, the
durable (JSONL WAL) and the apiserver (KubeBackend) backends, list+watch
ingestion, lease-elected HA replicas, the in-process elastic
autoscaler (`--autoscaler`), and the multi-cluster fleet (`fleet.enabled`:
F private in-memory cluster stacks behind this endpoint, cluster 0
doubling as the local app; refused with HA, a durable store or an
apiserver backend, as in the JAX package). The server solves on the current
CUDA card and raises without one, and `--ingest native` builds the port's
native library or raises. With a durable store or an apiserver
the server waits for the watch caches to sync, reconciles (or runs one
election tick as an HA replica), and only then serves. The multi-device
flags are the JAX package's: `--device-pool N`, `--mesh GROUPSxSHARDS`
(SHARDS > 1: node-sharded mesh slots over the cards, parallel/mesh.py)
and `--scale-tier` (node-sharded escalation re-solves). `--fleet-stack MS`
sets `fleet.stack-window-ms` as in the JAX CLI; the server solves on the
card, where the setting is inert (the row walk serves every window;
fleet/facade.py). Every flag of the JAX CLI is served.
"""

from __future__ import annotations

import argparse
import sys

__version__ = "0.1.0"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="spark-scheduler-torch")
    sub = parser.add_subparsers(dest="command")
    sub.add_parser("version", help="print version")
    srv = sub.add_parser("server", help="run the scheduler extender server")
    srv.add_argument("--config", help="install YAML (config/config.go:24-84 surface)")
    srv.add_argument("--host", default="0.0.0.0")
    srv.add_argument("--port", type=int, default=None)
    srv.add_argument(
        "--durable-store",
        default=None,
        help="JSONL write-ahead log path; state survives restarts "
        "(the etcd/CRD persistence slot, SURVEY.md §5.4)",
    )
    srv.add_argument(
        "--kube-api-url",
        default=None,
        help="apiserver base URL for list+watch ingestion (informer slot), "
        "or 'in-cluster' for the pod's serviceaccount",
    )
    srv.add_argument(
        "--transport",
        choices=("threaded", "async"),
        default=None,
        help="serving transport: 'threaded' (stdlib thread-per-connection,"
        " default) or 'async' (single-threaded event loop with pipelined"
        " keep-alive framing and explicit backpressure); overrides the"
        " install config's server.transport",
    )
    srv.add_argument(
        "--ingest",
        choices=("python", "native"),
        default=None,
        help="serving ingest lane: 'python' (json.loads per predicate "
        "body, default) or 'native' (C++ request framing + zero-copy "
        "predicate decode via native/runtime.cpp; raises when the native "
        "library cannot be built); overrides the install config's "
        "server.ingest",
    )
    srv.add_argument(
        "--device-pool",
        type=int,
        default=None,
        help="window-solve device pool: a resident cluster replica on each "
        "of N cards (clamped to the cards there are), concurrent window "
        "solves spread over them (disjoint instance-group windows solve in "
        "parallel), a slot that faults quarantined and its work "
        "re-dispatched; overrides the install config's solver.device-pool",
    )
    srv.add_argument(
        "--mesh",
        default=None,
        metavar="GROUPSxSHARDS",
        help="full mesh form of --device-pool, e.g. '4x2' = 4 pool slots "
        "of 2 node-sharding cards each (solver.mesh {groups, "
        "node-shards}); node-shards > 1 runs each window on the slot's "
        "node-sharded engine",
    )
    srv.add_argument(
        "--fuse-windows",
        type=int,
        default=None,
        help="fused multi-window dispatch: when the predicate backlog "
        "exceeds one window, claim up to K windows and solve them in ONE "
        "dispatch of the row walk, carrying the committed state on the "
        "device between windows (K windows share one decision pull); "
        "overrides the install config's solver.fuse-windows (default 1 = "
        "unfused)",
    )
    srv.add_argument(
        "--prune-top-k",
        type=int,
        default=None,
        help="sound top-K candidate pruning (the two-tier solve): serve "
        "eligible windows over a gathered top-K sub-cluster sized from "
        "the window's demand x --prune-slack, on the row walk, with a "
        "post-solve certificate that re-solves any window a pruned row "
        "could have changed (decisions stay byte-identical); overrides the "
        "install config's solver.prune-top-k (default 0 = off)",
    )
    srv.add_argument(
        "--scale-tier",
        action="store_true",
        default=None,
        help="run certificate escalations and fallback re-solves as a "
        "node-sharded solve over the local cards instead of one card's "
        "row walk (identical decisions); overrides solver.scale-tier "
        "(default off)",
    )
    srv.add_argument(
        "--prune-slack",
        type=float,
        default=None,
        help="candidate-pruning slack factor: kept rows per zone = "
        "max(prune-top-k, ceil(window aggregate demand x slack)); "
        "overrides solver.prune-slack (default 2.0)",
    )
    srv.add_argument(
        "--no-delta-statics",
        action="store_true",
        default=None,
        help="disable delta STATIC uploads (solver.delta-statics): every "
        "statics change re-uploads the full node state and drains "
        "in-flight windows",
    )
    srv.add_argument(
        "--ha-replica",
        default=None,
        metavar="REPLICA_ID",
        help="run as one replica of a lease-elected HA group (enables the "
        "ha: install block with this replica id): boot as a warm standby "
        "tailing backend state, serve only after winning the leader lease "
        "and running the failover reconcile; reservation writes carry the "
        "lease's fencing epoch. With --durable-store the WAL is opened in "
        "follower mode and the lease lives in an flock-guarded "
        "<wal>.lease sidecar (the supported multi-process arbiter); "
        "combining with --kube-api-url is refused — the apiserver backend "
        "does not persist a lease kind yet, so each replica would elect "
        "itself (split-brain)",
    )
    srv.add_argument(
        "--ha-lease-ttl",
        type=float,
        default=None,
        metavar="SECONDS",
        help="leader lease TTL (default 3s; heartbeat renews at TTL/3); "
        "overrides the install config's ha.lease-ttl",
    )
    srv.add_argument(
        "--autoscaler",
        action="store_true",
        help="enable the in-process elastic autoscaler: consume pending "
        "Demand CRDs, provision simulated nodes, drain idle ones "
        "(see the install config's `autoscaler:` block for knobs)",
    )
    srv.add_argument(
        "--fleet-stack",
        type=float,
        default=None,
        metavar="MS",
        help="fused fleet dispatch gather window in milliseconds "
        "(fleet.stack-window-ms): concurrent per-cluster windows stack "
        "into one dispatch (fleet/dispatch.py); 0 disables; requires "
        "fleet.enabled with >= 2 clusters to have any effect, and on the "
        "card, where the row walk serves every window, it is inert",
    )
    pc = sub.add_parser(
        "print-crds",
        help="emit the CustomResourceDefinition manifests as YAML "
        "(kubectl apply -f -)",
    )
    pc.add_argument(
        "--conversion-webhook-url",
        default=None,
        help="wire the webhook conversion strategy with this client URL",
    )
    cw = sub.add_parser(
        "conversion-webhook", help="run the standalone CRD-conversion webhook"
    )
    cw.add_argument("--host", default="0.0.0.0")
    cw.add_argument("--port", type=int, default=8485)
    cw.add_argument("--cert-file", default=None)
    cw.add_argument("--key-file", default=None)
    cw.add_argument(
        "--request-log",
        action="store_true",
        help="emit a structured request.2 access-log line per HTTP call",
    )
    args = parser.parse_args(argv)

    if args.command == "version":
        print(__version__)
        return 0
    if args.command == "print-crds":
        import yaml

        from spark_scheduler_tpu_torch.models.crds import demand_crd, resource_reservation_crd

        print(
            yaml.safe_dump_all(
                [
                    resource_reservation_crd(
                        webhook_url=args.conversion_webhook_url
                    ),
                    demand_crd(),
                ],
                sort_keys=False,
            ),
            end="",
        )
        return 0
    if args.command == "conversion-webhook":
        from spark_scheduler_tpu_torch.server.http import ConversionWebhookServer

        server = ConversionWebhookServer(
            host=args.host,
            port=args.port,
            cert_file=args.cert_file,
            key_file=args.key_file,
            request_log=args.request_log,
        )
        print(
            f"conversion webhook serving on {args.host}:{server.port}", file=sys.stderr
        )
        server.serve_forever()
        return 0
    if args.command != "server":
        parser.print_help()
        return 2

    from spark_scheduler_tpu_torch.events import EventEmitter
    from spark_scheduler_tpu_torch.metrics import (
        CacheReporter,
        MetricRegistry,
        QueueReporter,
        ReporterRunner,
        SchedulerMetrics,
        SoftReservationReporter,
        UsageReporter,
        WasteReporter,
    )
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.server.http import SchedulerHTTPServer
    from spark_scheduler_tpu_torch.store.backend import DEMAND_CRD, InMemoryBackend

    config = InstallConfig()
    if args.config:
        import yaml

        with open(args.config) as f:
            config = InstallConfig.from_dict(yaml.safe_load(f) or {})
    if args.port is not None:
        config.port = args.port
    if args.durable_store is not None:
        config.durable_store_path = args.durable_store
    if args.kube_api_url is not None:
        config.kube_api_url = args.kube_api_url
    if args.autoscaler:
        config.autoscaler_enabled = True
    if args.ha_replica is not None:
        config.ha_enabled = True
        config.ha_replica_id = args.ha_replica
    if args.ha_lease_ttl is not None:
        config.ha_lease_ttl_s = args.ha_lease_ttl
    if args.fleet_stack is not None:
        config.fleet_stack_window_ms = args.fleet_stack
    if args.transport is not None:
        config.server_transport = args.transport
    if args.ingest is not None:
        config.server_ingest = args.ingest
    if args.no_delta_statics:
        config.solver_delta_statics = False
    if args.device_pool is not None:
        # The flag overrides the whole pool config: a configured
        # solver.mesh would otherwise win inside the solver and make
        # `--device-pool 1` a no-op. An explicit --mesh still wins.
        config.solver_device_pool = args.device_pool
        config.solver_mesh_groups = None
        config.solver_mesh_node_shards = None
    if args.fuse_windows is not None:
        config.solver_fuse_windows = args.fuse_windows
    if args.prune_top_k is not None:
        config.solver_prune_top_k = args.prune_top_k
    if args.prune_slack is not None:
        config.solver_prune_slack = args.prune_slack
    if args.scale_tier:
        config.solver_scale_tier = True
    if args.mesh is not None:
        try:
            groups, shards = (int(x) for x in args.mesh.lower().split("x"))
        except ValueError:
            print(
                f"--mesh expects GROUPSxSHARDS (e.g. 4x2), got {args.mesh!r}",
                file=sys.stderr,
            )
            return 2
        config.solver_mesh_groups = groups
        config.solver_mesh_node_shards = shards

    registry = MetricRegistry()
    metrics = SchedulerMetrics(registry, config.instance_group_label)
    events = EventEmitter(instance_group_label=config.instance_group_label)
    waste = WasteReporter(registry, config.instance_group_label)
    kube_backend = False
    if config.durable_store_path:
        from spark_scheduler_tpu_torch.store.durable import DurableBackend

        # HA replicas open the shared WAL in FOLLOWER mode: read-only
        # tailing until this replica wins the lease and promotes (the
        # promotion flips it to the writer). A standalone (non-HA) server
        # is the sole writer from the start.
        backend = DurableBackend(
            config.durable_store_path, follow=config.ha_enabled
        )
    elif config.kube_api_url:
        # Reservations/demands persist as CRs in the apiserver — the
        # reference's actual deployment mode (CRDs ARE the durable store,
        # SURVEY.md §5.4). A durable-store path overrides this with a
        # local WAL instead.
        from spark_scheduler_tpu_torch.kube.backend import KubeBackend

        if config.kube_api_url == "in-cluster":
            from spark_scheduler_tpu_torch.kube.reflector import in_cluster_config

            base_url, ca_file, token_file = in_cluster_config()
        else:
            base_url, ca_file, token_file = config.kube_api_url, None, None
        backend = KubeBackend(
            base_url,
            qps=config.kube_api_qps,
            burst=config.kube_api_burst,
            ca_file=ca_file,
            token_file=token_file,
            insecure_skip_tls_verify=config.kube_api_insecure_skip_tls_verify,
            metrics=registry,
        )
        backend.start()  # initial CR list + watch
        kube_backend = True
    else:
        backend = InMemoryBackend()
    if not kube_backend:
        # On a real cluster the Demand CRD belongs to the external
        # autoscaler (demand_informer.go); locally we provide it so demand
        # features are exercisable.
        backend.register_crd(DEMAND_CRD)
    if config.fleet_enabled and (
        config.ha_enabled or config.durable_store_path or kube_backend
    ):
        # Fleet mode boots F private in-memory cluster stacks; composing
        # it with HA roles or a shared durable/apiserver backend (whose
        # state would reach only cluster 0) needs per-cluster state
        # ingestion — refusing beats serving a silently half-wired fleet.
        raise SystemExit(
            "fleet.enabled composes with the in-memory backend only for "
            "now (not ha.enabled / --durable-store / --kube-api-url): "
            "each cluster stack owns a private backend."
        )
    ha_runtime = None
    fleet_facade = None
    if config.ha_enabled:
        from spark_scheduler_tpu_torch.ha import (
            BackendLeaseStore,
            FileLeaseStore,
            LeaseManager,
        )
        from spark_scheduler_tpu_torch.ha.replica import build_replica

        # The lease arbiter must be shared across replicas: the WAL
        # deployment uses the flock-guarded sidecar (the log itself has no
        # cross-process CAS); the in-memory backend CASes through its
        # optimistic concurrency.
        if config.durable_store_path:
            lease_store = FileLeaseStore(config.durable_store_path + ".lease")
        elif kube_backend:
            # KubeBackend round-trips only reservations/demands to the
            # apiserver; a "leases" object would land in each process's
            # PRIVATE local store — every replica would elect itself at
            # epoch 1 and no write would ever be fenced. Refusing beats
            # silent split-brain; a coordination.k8s.io Lease codec is the
            # future fix.
            raise SystemExit(
                "--ha-replica with --kube-api-url is not supported: the "
                "lease would be process-local (each replica elects itself "
                "— split-brain). Use --durable-store for multi-process HA."
            )
        else:
            lease_store = BackendLeaseStore(backend)
        lease = LeaseManager(
            lease_store, config.ha_replica_id, ttl_s=config.ha_lease_ttl_s
        )
        ha_runtime = build_replica(
            backend,
            config.ha_replica_id,
            config=config,
            lease=lease,
            metrics=metrics,
            events=events,
            waste=waste,
            registry=registry,
        )
        app = ha_runtime.app
    elif config.fleet_enabled:
        from spark_scheduler_tpu_torch.fleet import FleetFacade

        # F independent per-cluster stacks behind this one endpoint
        # (fleet/facade.py), each solving on the card. Cluster 0 doubles
        # as the server's local app (readiness, debug state, PUT /state
        # ingestion); /predicates is fleet-routed by the routing layer the
        # moment `fleet` is wired.
        fleet_facade = FleetFacade(
            config.fleet_clusters,
            config,
            registry=registry,
            max_spillover_hops=config.fleet_max_spillover_hops,
            suppress_resync=False,
        )
        # Every cluster's write-back loops, not only cluster 0's (which
        # the server's start would run): a cluster whose reservations never
        # reach its backend looks empty to kill_cluster.
        fleet_facade.start_background()
        app = fleet_facade.stacks[0].app
    else:
        app = build_scheduler_app(
            backend, config, metrics=metrics, events=events, waste=waste
        )

    class _Cleanups:  # periodic state eviction + metric flush on the tick
        def report_once(self):
            waste.cleanup()
            metrics.report_once()
            if config.metrics_log:
                with open(config.metrics_log, "a") as f:
                    registry.emit(f)

    reporters = ReporterRunner(
        [
            UsageReporter(registry, app.reservation_manager),
            CacheReporter(
                registry,
                {"resourcereservations": app.rr_cache, "demands": app.demand_cache},
                backend=backend,
            ),
            SoftReservationReporter(registry, app.soft_store),
            QueueReporter(registry, backend, config.instance_group_label),
            _Cleanups(),
        ]
    )
    server = SchedulerHTTPServer(
        app,
        registry,
        host=args.host,
        port=config.port,
        cert_file=config.cert_file,
        key_file=config.key_file,
        client_ca_files=config.client_ca_files,
        request_timeout_s=config.request_timeout_s,
        debug_routes=config.debug_routes,
        request_log=config.request_log,
        ha=ha_runtime,
        fleet=fleet_facade,
    )
    reporters.start()
    print(
        f"spark-scheduler-torch serving on {args.host}:{server.port} "
        f"({app.solver.device})",
        file=sys.stderr,
    )
    try:
        if config.durable_store_path or kube_backend:
            # Restored state (WAL replay or apiserver CR list) must be
            # reconciled against CURRENT cluster state BEFORE any
            # /predicates request is served: wait for watch-ingestion cache
            # sync (blocking until it succeeds — a half-populated cache
            # would make reconciliation delete reservations for pods that
            # merely haven't listed yet), then reconcile, then open the
            # server (WaitForCacheSync precedes failover recovery:
            # cmd/server.go:140-147 then failover.go:35-72 — a restart IS
            # a leader change).
            app.start_background()
            if app.ingestion is not None:
                while not app.ingestion.wait_synced(timeout=30.0):
                    print(
                        "waiting for apiserver cache sync before reconcile...",
                        file=sys.stderr,
                    )
            if kube_backend:
                while not backend.wait_synced(timeout=30.0):
                    print(
                        "waiting for reservation/demand cache sync...",
                        file=sys.stderr,
                    )
            if ha_runtime is None:
                app.reconciler.sync_resource_reservations_and_demands()
            else:
                # Election decides who reconciles: one immediate tick so a
                # sole/first replica serves without waiting a heartbeat;
                # losers stay warm standbys (readiness reports the role)
                # until the heartbeat loop promotes them.
                ha_runtime.run_election_once()
        elif ha_runtime is not None:
            ha_runtime.run_election_once()
        server.start()
        server.join()
    except KeyboardInterrupt:
        server.stop()
    finally:
        reporters.stop()
        if fleet_facade is not None:
            fleet_facade.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
