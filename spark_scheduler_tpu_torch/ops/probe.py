"""Build-and-launch check for the port's CUDA kernels.

Counterpart of spark_scheduler_tpu/ops/pallas_fifo.py `pallas_available`:
the same trivial `o = x + 1` kernel over an [8, 128] int32 tensor. It is
NOT a gate that picks another path: on a CUDA tensor `probe` launches
csrc/probe.cu and raises if anything fails; on a CPU tensor it computes the
plain version.
"""

from __future__ import annotations

import ctypes
import threading

import torch

PROBE_SHAPE = (8, 128)


def probe_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version of the probe kernel."""
    return x + 1


def _lib():
    from spark_scheduler_tpu_torch.ops._build import load_library

    lib = load_library("probe")
    if lib.probe_add_one.argtypes is None:
        lib.probe_add_one.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.probe_add_one.restype = ctypes.c_int
        lib.probe_error.argtypes = [ctypes.c_int]
        lib.probe_error.restype = ctypes.c_char_p
    return lib


def probe_add_one(x: torch.Tensor) -> torch.Tensor:
    """`x + 1` for an int32 tensor: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("probe takes a contiguous int32 tensor")
    if x.device.type == "cpu":
        return probe_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"probe runs on cuda or cpu, got {x.device}")
    lib = _lib()
    out = torch.empty_like(x)
    err = lib.probe_add_one(
        x.device.index, x.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "probe kernel launch failed: " + lib.probe_error(err).decode()
        )
    with _launches_lock:
        probe_add_one.launches += 1
    return out


probe_add_one.launches = 0
_launches_lock = threading.Lock()  # solvers on several threads probe


def probe(device="cuda") -> None:
    """Launch the probe once on `device` and check it; raises on failure."""
    x = torch.zeros(PROBE_SHAPE, dtype=torch.int32, device=device)
    out = probe_add_one(x)
    if not bool((out == 1).all()):
        raise RuntimeError(f"probe kernel returned wrong values on {device}")
