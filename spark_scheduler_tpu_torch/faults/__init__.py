"""Fault-tolerance subsystem of the port.

  errors     the exception taxonomy: InjectedFault / DeviceFaultError and
             CudaDeviceFault (slot-fatal), AllSlotsQuarantinedError,
             DegradedUnavailableError, RetryDeadlineExceeded /
             AttemptTimeoutError / BreakerOpenError, and
             classify_slot_failure.
  retry      RetryPolicy and CircuitBreaker, the retry ladder the kube
             async client, backend write-back, lease renewals, reflector
             relists and the autoscaler loop ride.
  injector   FaultPlan / FaultSpec / FaultInjector — seeded, deterministic
             schedules of latency/error/partition faults over NAMED
             surfaces (backend verbs, kube async-client writes, device
             h2d/dispatch/d2h, lease store, WAL append/fsync).
  degraded   DegradedModeController — the `server.degraded-mode` policy
             (host-side greedy fallback vs 503+Retry-After shedding) the
             solver consults when no device can serve.
"""

from spark_scheduler_tpu_torch.faults.errors import (
    AllSlotsQuarantinedError,
    AttemptTimeoutError,
    BreakerOpenError,
    CudaDeviceFault,
    DegradedUnavailableError,
    DeviceFaultError,
    InjectedFault,
    RetryDeadlineExceeded,
    classify_slot_failure,
)
from spark_scheduler_tpu_torch.faults.retry import CircuitBreaker, RetryPolicy
from spark_scheduler_tpu_torch.faults.injector import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
    FaultyLeaseStore,
)
from spark_scheduler_tpu_torch.faults.degraded import (
    DEGRADED_GREEDY,
    DEGRADED_SHED,
    DegradedModeController,
)

__all__ = [
    "AllSlotsQuarantinedError",
    "AttemptTimeoutError",
    "BreakerOpenError",
    "CircuitBreaker",
    "CudaDeviceFault",
    "DEGRADED_GREEDY",
    "DEGRADED_SHED",
    "DegradedModeController",
    "DegradedUnavailableError",
    "DeviceFaultError",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "FaultyLeaseStore",
    "InjectedFault",
    "RetryDeadlineExceeded",
    "RetryPolicy",
    "classify_slot_failure",
]
