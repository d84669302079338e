"""CLI (cmd/root.go:22-35, cmd/server.go:44-54):

  python -m spark_scheduler_tpu_torch server [--config install.yml] [--port N]
      [--transport threaded|async] [--ingest python|native]
  python -m spark_scheduler_tpu_torch print-crds [--conversion-webhook-url URL]
  python -m spark_scheduler_tpu_torch conversion-webhook [--port N]
  python -m spark_scheduler_tpu_torch version

`conversion-webhook` is the standalone CRD-conversion service the reference
ships as a second binary (spark-scheduler-conversion-webhook/main.go:27).

The port's copy of spark_scheduler_tpu/__main__.py for the in-memory
backend. The server solves on the current CUDA card and raises without one;
an install key the port cannot serve yet raises NotImplementedError
(server/app.py), and `--ingest native` builds the port's native library or
raises. The JAX package's durable-store, apiserver, HA, fleet, autoscaler
and multi-device flags are not ported.
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
        "--no-delta-statics",
        action="store_true",
        default=None,
        help="disable delta STATIC uploads (solver.delta-statics): every "
        "statics change re-uploads the full node state and drains "
        "in-flight windows",
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
    if args.transport is not None:
        config.server_transport = args.transport
    if args.ingest is not None:
        config.server_ingest = args.ingest
    if args.no_delta_statics:
        config.solver_delta_statics = False

    registry = MetricRegistry()
    metrics = SchedulerMetrics(registry, config.instance_group_label)
    events = EventEmitter(instance_group_label=config.instance_group_label)
    waste = WasteReporter(registry, config.instance_group_label)
    backend = InMemoryBackend()
    # On a real cluster the Demand CRD belongs to the external autoscaler
    # (demand_informer.go); locally we provide it so demand features are
    # exercisable.
    backend.register_crd(DEMAND_CRD)
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
    )
    reporters.start()
    print(
        f"spark-scheduler-torch serving on {args.host}:{server.port} "
        f"({app.solver.device})",
        file=sys.stderr,
    )
    try:
        server.start()
        server.join()
    except KeyboardInterrupt:
        server.stop()
    finally:
        reporters.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
