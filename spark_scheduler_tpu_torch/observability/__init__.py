"""Scheduling flight recorder and serving telemetry (SURVEY.md §0 decision
explainability).

  - `recorder`: every extender decision becomes a structured
    `DecisionRecord` (verdict, per-node failure map, FIFO queue position,
    dispatch id, phase times) in a bounded thread-safe ring, queryable at
    GET /debug/decisions.
  - `telemetry`: `SolverTelemetry` — the hook surface core/solver.py calls
    to publish library-build counts/seconds, padding-bucket occupancy,
    pipeline drain/discard counters, build kinds and host<->device
    transfer bytes under `foundry.spark.scheduler.solver.*` — and
    `RetryTelemetry` / `TransportTelemetry` / `HATelemetry`, the retry
    ladder's, the HTTP transport's and an HA replica's series.
  - `exposition`: Prometheus text rendering of a MetricRegistry snapshot,
    giving the push-only JSON-line reporter a pull surface (GET /metrics).
  - `state`: the point-in-time GET /debug/state snapshot (hard/soft
    reservations, FIFO queue, unschedulable set, node fleet).
"""

from spark_scheduler_tpu_torch.observability.recorder import (  # noqa: F401
    DecisionRecord,
    FlightRecorder,
)
from spark_scheduler_tpu_torch.observability.telemetry import (  # noqa: F401
    HATelemetry,
    RetryTelemetry,
    SolverTelemetry,
    TransportTelemetry,
    compile_stats,
)
from spark_scheduler_tpu_torch.observability.exposition import (  # noqa: F401
    prefers_prometheus,
    render_prometheus,
)
from spark_scheduler_tpu_torch.observability.state import (  # noqa: F401
    debug_state_snapshot,
)

__all__ = [
    "DecisionRecord",
    "FlightRecorder",
    "HATelemetry",
    "RetryTelemetry",
    "SolverTelemetry",
    "TransportTelemetry",
    "compile_stats",
    "prefers_prometheus",
    "render_prometheus",
    "debug_state_snapshot",
]
