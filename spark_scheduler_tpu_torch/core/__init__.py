"""The port's serving engine: the single-device window solver."""

from spark_scheduler_tpu_torch.core.solver import (  # noqa: F401
    HostPacking,
    PlacementSolver,
    WindowDecision,
    WindowRequest,
)
