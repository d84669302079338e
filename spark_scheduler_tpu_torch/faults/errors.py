"""Exception taxonomy of the fault-tolerance subsystem.

The split that matters operationally is SLOT-FATAL vs PROGRAMMING ERROR:
a device slot whose solve died of a tunnel drop / XlaRuntimeError should
be quarantined and its window re-dispatched on a survivor, while a
TypeError in the packing code must propagate loudly — retrying it on
another slot would fail identically and hide the bug.
`classify_slot_failure` draws that line in one place.
"""

from __future__ import annotations


class InjectedFault(RuntimeError):
    """An error the FaultInjector raised on purpose. Carries the surface
    it fired on so assertions can tell injected failures from real ones."""

    def __init__(self, surface: str, message: str = ""):
        super().__init__(message or f"injected fault on {surface}")
        self.surface = surface


class DeviceFaultError(InjectedFault):
    """Injected DEVICE-surface fault (h2d / dispatch / d2h): classified
    slot-fatal, exactly like a real tunnel drop or XlaRuntimeError."""


class AllSlotsQuarantinedError(RuntimeError):
    """Every device slot of the pool is quarantined: no device can serve.
    The extender answers per the `server.degraded-mode` policy (greedy
    host fallback or 503+Retry-After)."""


class DegradedUnavailableError(RuntimeError):
    """No device can serve and the degraded-mode policy is "shed": the
    request must be answered 503 with Retry-After instead of a decision."""

    def __init__(self, reason: str, retry_after_s: float = 5.0):
        super().__init__(reason)
        self.retry_after_s = retry_after_s


class RetryDeadlineExceeded(RuntimeError):
    """RetryPolicy.call gave up: the overall deadline elapsed (or the
    attempt budget ran out with a deadline configured). `__cause__` is the
    last attempt's real exception."""


class AttemptTimeoutError(TimeoutError):
    """One attempt exceeded the policy's per-attempt timeout. The attempt
    thread is abandoned (there is no portable way to cancel it); the
    caller retries or gives up per the policy."""


class BreakerOpenError(RuntimeError):
    """A call was refused because the circuit breaker is open (the
    downstream is failing; probing is rationed to the half-open window)."""


# Exception type names that mean "the DEVICE (or its transport) died", as
# opposed to "the program is wrong". Matched by name so the classifier
# needs no jaxlib import (the concrete class moved modules across jax
# releases).
_SLOT_FATAL_TYPE_NAMES = frozenset(
    {"XlaRuntimeError", "ChannelError", "RpcError"}
)


def classify_slot_failure(exc: BaseException) -> bool:
    """True when `exc` indicates the device slot (hardware, runtime, or
    tunnel) failed and the work should be retried on a surviving slot;
    False for programming errors that must propagate."""
    if isinstance(exc, DeviceFaultError):
        return True
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return True
    for klass in type(exc).__mro__:
        if klass.__name__ in _SLOT_FATAL_TYPE_NAMES:
            return True
    return False
