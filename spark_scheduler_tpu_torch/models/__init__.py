"""Domain state models: resource algebra, node objects, cluster tensors."""

from spark_scheduler_tpu_torch.models.resources import (  # noqa: F401
    Resources,
    parse_quantity,
    CPU_DIM,
    MEM_DIM,
    GPU_DIM,
    NUM_DIMS,
)
