"""Exception taxonomy of the fault-tolerance subsystem.

The split that matters operationally is SLOT-FATAL vs PROGRAMMING ERROR:
a device slot whose solve died of a device fault (an uncorrectable ECC
error, a device gone unavailable, a dropped transport) should be
quarantined and its window re-dispatched on a survivor, while a
TypeError in the packing code, a kernel that does not build, a launch
the kernel's own configuration refuses, or an illegal address or launch
failure (what a wrong kernel raises) must propagate loudly — retrying it
on another slot or on the host would hide the bug. `classify_slot_failure`
draws that line in one place.
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


# cudaError_t codes that mean the DEVICE failed and that no kernel of the
# port, right or wrong, can cause, by value, with their runtime names and
# the strings cudaGetErrorString gives them. Every other code propagates:
# an invalid value or configuration, a launch out of resources, no kernel
# image for the device, and the faults a wrong kernel raises itself (an
# illegal address, instruction or alignment, a launch failure, a hardware
# stack error, a launch timeout), which a host fallback would hide.
CUDA_DEVICE_FAULT_CODES = {
    214: ("cudaErrorECCUncorrectable", "uncorrectable ECC error encountered"),
    46: (
        "cudaErrorDevicesUnavailable",
        "CUDA-capable device(s) is/are busy or unavailable",
    ),
}


class CudaDeviceFault(RuntimeError):
    """A kernel wrapper's launch or a CUDA runtime call reported a
    device-side fault (one of CUDA_DEVICE_FAULT_CODES): slot-fatal. `code`
    is the cudaError_t value."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = int(code)


def cuda_launch_error(code: int, what: str, detail: str) -> RuntimeError:
    """The exception a kernel wrapper raises for a nonzero cudaError_t:
    CudaDeviceFault for a device-side fault, a plain RuntimeError (a
    programming or configuration error) for every other code."""
    message = f"{what} failed: {detail} (cudaError {int(code)})"
    if int(code) in CUDA_DEVICE_FAULT_CODES:
        return CudaDeviceFault(code, message)
    return RuntimeError(message)


def _is_cuda_device_fault_message(exc: BaseException) -> bool:
    """torch's own CUDA errors (a RuntimeError or AcceleratorError whose
    message starts "CUDA error: <cudaGetErrorString>", possibly naming the
    code) carrying one of the device-fault codes."""
    msg = str(exc)
    if "CUDA error" not in msg and "cudaError" not in msg:
        return False
    return any(
        name in msg or text in msg
        for name, text in CUDA_DEVICE_FAULT_CODES.values()
    )


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
# opposed to "the program is wrong", kept from the JAX package's taxonomy
# (matched by name: the port imports no runtime that defines them).
_SLOT_FATAL_TYPE_NAMES = frozenset(
    {"XlaRuntimeError", "ChannelError", "RpcError"}
)


def classify_slot_failure(exc: BaseException) -> bool:
    """True when `exc` indicates the device slot (hardware, runtime, or
    tunnel) failed and the work should be retried on a surviving slot;
    False for programming errors that must propagate."""
    if isinstance(exc, (DeviceFaultError, CudaDeviceFault)):
        return True
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return True
    for klass in type(exc).__mro__:
        if klass.__name__ in _SLOT_FATAL_TYPE_NAMES:
            return True
    return isinstance(exc, RuntimeError) and _is_cuda_device_fault_message(exc)
