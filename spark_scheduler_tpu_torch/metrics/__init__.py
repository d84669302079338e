"""Observability: tagged metric registry, scheduler metric families, periodic
reporters, and the scheduling-waste tracker (SURVEY.md §2a metrics rows;
internal/metrics/* in the reference).
"""

from spark_scheduler_tpu_torch.metrics.registry import MetricRegistry
from spark_scheduler_tpu_torch.metrics.scheduler_metrics import SchedulerMetrics
from spark_scheduler_tpu_torch.metrics.reporters import (
    CacheReporter,
    QueueReporter,
    ReporterRunner,
    SoftReservationReporter,
    UsageReporter,
)
from spark_scheduler_tpu_torch.metrics.waste import WasteReporter

__all__ = [
    "MetricRegistry",
    "SchedulerMetrics",
    "UsageReporter",
    "CacheReporter",
    "QueueReporter",
    "SoftReservationReporter",
    "WasteReporter",
    "ReporterRunner",
]
