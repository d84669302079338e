"""Elastic autoscaler — the in-process consumer of the Demand surface.

The reference emits Demand CRDs for an EXTERNAL cluster autoscaler and stops
there (internal/extender/demand.go); this subsystem closes the loop inside
the process: a controller watches pending demands through the existing
backend/reflector surface, a provisioner registers simulated nodes (honoring
v1alpha2 zone affinity) and flips demand phases pending -> fulfilled (or
cannot-fulfill at the max-cluster-size cap), and a scale-down drainer
cordons + removes nodes idle past a TTL — never a node holding a hard or
soft reservation (reservation_manager + soft_reservations are the source of
truth for that refusal).

The port's copy of spark_scheduler_tpu/autoscaler/__init__.py.
"""

from spark_scheduler_tpu_torch.autoscaler.controller import ElasticAutoscaler
from spark_scheduler_tpu_torch.autoscaler.drainer import ScaleDownDrainer
from spark_scheduler_tpu_torch.autoscaler.metrics import AutoscalerMetrics
from spark_scheduler_tpu_torch.autoscaler.provisioner import (
    PROVISIONED_BY_LABEL,
    PROVISIONER_NAME,
    NodeProvisioner,
)

__all__ = [
    "AutoscalerMetrics",
    "ElasticAutoscaler",
    "NodeProvisioner",
    "PROVISIONED_BY_LABEL",
    "PROVISIONER_NAME",
    "ScaleDownDrainer",
]
