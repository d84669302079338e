"""Grouped solves: independent instance-group queues solved together on one
device (the port of spark_scheduler_tpu/parallel/, without a mesh)."""

from spark_scheduler_tpu_torch.parallel.solve import (  # noqa: F401
    grouped_fifo_pack,
    grouped_fifo_pack_reference,
    grouped_queue_operands,
    stack_groups,
)
