"""Test harness utilities (parity with the reference's exported
extendertest package)."""

from spark_scheduler_tpu_torch.testing.harness import (  # noqa: F401
    Harness,
    new_node,
    static_allocation_spark_pods,
    dynamic_allocation_spark_pods,
)
