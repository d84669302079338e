"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, compiled for Hopper (sm_90a) into `BUILD_DIR` at first use:
`spark_scheduler_tpu_torch/_build/`, or the directory the install key
`jax-compilation-cache-dir` names (`use_build_dir`). The file name carries a hash of the flags, the source and every
header in `csrc/`, so an edited source builds anew and a stale library is
never loaded. `build_all()` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
DEFAULT_BUILD_DIR = _PKG / "_build"
# Where libraries build and load from; native/__init__.py keeps a copy
# (`use_build_dir` sets both).
BUILD_DIR = DEFAULT_BUILD_DIR
SOURCES = ("probe", "window_kernel", "fifo_kernel")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# One build-and-load at a time: a server solves on more than one thread.
_load_lock = threading.Lock()
# Libraries this process compiled (the CUDA kernels here, the native runtime
# in native/__init__.py) and the wall time their builds took: the solver
# telemetry's compile gauges (observability/telemetry.py).
_totals = {"count": 0, "seconds": 0.0}
_totals_lock = threading.Lock()


def note_builds(count: int, seconds: float) -> None:
    """Book `count` libraries compiled in `seconds` of wall time."""
    with _totals_lock:
        _totals["count"] += count
        _totals["seconds"] += seconds


def build_totals() -> dict:
    """{"count", "seconds"}: libraries compiled by this process so far."""
    with _totals_lock:
        return dict(_totals)


def use_build_dir(path) -> Path:
    """Build the CUDA kernels and the native runtime into `path`, and load
    them from there, from now on: the port's counterpart of the JAX
    package's persistent compilation cache (`jax-compilation-cache-dir`).
    Builds stay atomic (a `.<pid>.tmp` file, then `os.replace`), so
    replicas may share the directory. Libraries this process has already
    loaded stay loaded. Raises OSError when `path` cannot be created or
    written."""
    global BUILD_DIR
    from spark_scheduler_tpu_torch import native

    d = Path(path).expanduser().resolve()
    d.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryFile(dir=d):
        pass
    BUILD_DIR = native.BUILD_DIR = d
    return d


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else PATH, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels build "
        "from source at first use"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source in `names` whose library is missing, one nvcc
    per source, all started together. Returns {name: compiler output}
    (ptxas register and memory use) for what was built; raises with the
    compiler's output if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        try:
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
        except OSError as exc:
            # A RuntimeError, never an OSError: the fault classifier
            # (faults/errors.py) counts OSError as a device fault, and a
            # build that cannot run must not engage degraded mode.
            raise RuntimeError(f"CUDA build failed: cannot run {nvcc}: {exc}") from exc
        procs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    note_builds(len(procs) - len(failed), time.perf_counter() - t0)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                build_all((name,))
                try:
                    lib = ctypes.CDLL(str(library_path(name)))
                except OSError as exc:  # not a device fault (see build_all)
                    raise RuntimeError(
                        f"CUDA library load failed: {library_path(name)}: {exc}"
                    ) from exc
                _loaded[name] = lib
    return lib
