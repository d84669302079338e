"""Durable decision traces, deterministic replay, what-if simulation and
batched multi-arm sweeps: the port's copy of spark_scheduler_tpu/replay.
Replays, what-ifs and sweeps run on the card unless `device="cpu"` is
passed.

  trace       versioned JSONL codec: TraceWriter (the FlightRecorder's
              journaling sink) + TraceReader (torn-tail tolerant).
  engine      backend-free deterministic replay (`replay_trace`) and the
              config what-if differ (`what_if`), factored into per-arm
              `ReplayLane`s a multi-lane driver can interleave.
  sweep       the grid driver: one trace, M config arms, lockstep lanes
              over one shared host build (stacked cross-arm window solves
              on the CPU; the row walk per arm on the card) (`run_sweep` /
              `SweepReport` / `grid_arms`).
  generators  seed-deterministic synthetic workloads (diurnal / bursty /
              churn) emitting the same trace format.

CLI: `python -m spark_scheduler_tpu_torch.replay --help`.
"""

from spark_scheduler_tpu_torch.replay.engine import (
    ReplayMismatchError,
    ReplayReport,
    replay_trace,
    what_if,
)
from spark_scheduler_tpu_torch.replay.generators import GENERATORS, generate
from spark_scheduler_tpu_torch.replay.sweep import (
    SweepReport,
    grid_arms,
    last_sweep_telemetry,
    run_sweep,
)
from spark_scheduler_tpu_torch.replay.trace import (
    TRACE_VERSION,
    TraceReader,
    TraceWriter,
    config_fingerprint,
    config_from_fingerprint,
    config_hash,
)

__all__ = [
    "GENERATORS",
    "ReplayMismatchError",
    "ReplayReport",
    "SweepReport",
    "TRACE_VERSION",
    "TraceReader",
    "TraceWriter",
    "config_fingerprint",
    "config_from_fingerprint",
    "config_hash",
    "generate",
    "grid_arms",
    "last_sweep_telemetry",
    "replay_trace",
    "run_sweep",
    "what_if",
]
