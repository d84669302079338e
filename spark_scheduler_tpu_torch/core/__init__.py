"""The port's gang-admission engine: the SparkSchedulerExtender predicate
over the PlacementSolver (the host <-> device boundary around ops/), with
app-shape parsing (sparkpods), the soft-reservation store, overhead
accounting, the reservation manager, the demand lifecycle and the host
feature store."""

from spark_scheduler_tpu_torch.core.extender import (  # noqa: F401
    ExtenderConfig,
    SparkSchedulerExtender,
)
from spark_scheduler_tpu_torch.core.solver import (  # noqa: F401
    HostPacking,
    PipelineDrainRequired,
    PlacementSolver,
    WindowDecision,
    WindowRequest,
)
from spark_scheduler_tpu_torch.core.binpacker import (  # noqa: F401
    Binpacker,
    select_binpacker,
)
