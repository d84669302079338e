"""What every cell shares: finding a cell's files by name, the build
directory, the card check, spans, the profiler slice and its reduction, the
card's clocks and power, and the result line.

A configuration is `configs/<name>.json`, a cell `workloads/<name>.json`, a
traffic driver `drivers/<name>.py` and a per-layer metric
`metrics/<name>.py`; each is found by the name `BENCHMARK.json` or the
cell's file gives, so a later cell, driver or metric is a new file.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD_DIR = HERE / ".build"
# Top-level module names that may not be loaded in a run: JAX and the JAX
# package the port was made from. Compared whole: the port's own name
# begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "spark_scheduler_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result."""


# ------------------------------------------------------------ finding files


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """Import `<kind>/<name>.py` by file (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1]} named {name!r} ({path})")
    mod_name = f"port_bench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) `BENCHMARK.json` gives the
    cell: those that list it, and those that list no cells."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]
    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


# ------------------------------------------------------------- environment


def pin_caches() -> None:
    """Every build and kernel cache under one fixed directory of the
    checkout, so a checkout's first run builds and every later run loads."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD_DIR / "triton")


def build_program() -> None:
    """The port's CUDA kernels (nvcc) and native runtime (g++), built into
    `BUILD_DIR` on a checkout's first run and loaded from it after."""
    from spark_scheduler_tpu_torch import native
    from spark_scheduler_tpu_torch.ops import _build

    _build.use_build_dir(BUILD_DIR)
    _build.build_all()
    native.build()


def require_cards(count: int):
    """The card the cell runs on; raises without `count` CUDA devices."""
    import torch

    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: no card")
    if torch.cuda.device_count() < count:
        raise BenchError(f"{torch.cuda.device_count()} CUDA devices, the cell "
                         f"asks for {count}")
    return torch.device("cuda", 0)


def smi_sample() -> dict:
    """The card's name, SM clock, power draw and limit, and temperature."""
    fields = "name,clocks.sm,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return {"error": repr(exc)}
    if out.returncode != 0:
        return {"error": out.stderr.strip()[:200]}
    vals = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
    return dict(zip(fields.split(","), vals))


def forbidden_modules() -> list[str]:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# ------------------------------------------------------------------- spans


class Spans:
    """Host spans the drivers record around the program's layers: (name,
    start, end) on the host's monotonic clock, kept in memory."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: list[tuple[str, float, float]] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.items.append((name, t0, t1))

    def between(self, t0: float, t1: float, name: str | None = None) -> list:
        with self._lock:
            return [s for s in self.items if s[2] > t0 and s[1] < t1
                    and (name is None or s[0] == name)]


# ----------------------------------------------------------- device profile


class DeviceProfile:
    """torch.profiler over one steady slice of a traced run. After the
    slice: the device operations as (name, start, end) on the host's
    perf_counter clock, and the slice's bounds."""

    def __init__(self):
        self.ops: list[tuple[str, float, float]] = []
        self.t0 = self.t1 = None

    @staticmethod
    def init_here() -> None:
        """Initialise the profiler on this (the main) thread: Kineto takes
        its first start's thread as its own, and a later start on another
        thread then works."""
        from torch.profiler import ProfilerActivity, profile

        import torch

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        with profile(activities=acts):
            pass

    def start(self) -> None:
        """Start profiling; call it on the thread that launches the device
        work (Kineto keeps the device operations of the threads it
        records)."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        card = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
        if card:
            torch.cuda.synchronize()
        self._prof = profile(activities=activities)
        self._prof.start()
        with record_function("port_bench.align"):
            self._t_align = time.perf_counter()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """Stop profiling, on the thread that started it."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.stop()

    def finish(self) -> None:
        """Read the stopped profile's device operations (any thread)."""
        self.ops = self._device_ops(self._prof, self._t_align)
        self._prof = None

    @contextlib.contextmanager
    def slice(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()
        self.finish()

    @staticmethod
    def _device_ops(prof, t_align) -> list:
        """Every device operation of the trace Kineto kept, with its
        threads' correlation or without, on the perf_counter clock (aligned
        by the annotation made at `t_align`)."""
        path = Path(tempfile.mkdtemp()) / "slice.json"
        try:
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text()).get("traceEvents", [])
        finally:
            if path.exists():
                path.unlink()
            path.parent.rmdir()
        align = [e for e in events if e.get("name") == "port_bench.align"]
        if not align:
            raise BenchError("the profiler kept no alignment event")
        offset = t_align - float(align[0]["ts"]) / 1e6
        device = ("kernel", "gpu_memcpy", "gpu_memset")
        return sorted(
            (e["name"], float(e["ts"]) / 1e6 + offset,
             (float(e["ts"]) + float(e.get("dur", 0))) / 1e6 + offset)
            for e in events if e.get("ph") == "X" and e.get("cat") in device)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_s(self, match=None, exclude=None, kernels_only=False) -> float:
        """Device seconds of the operations whose name holds `match` (all
        when None) and not `exclude`; with `kernels_only`, copies and
        fills left out."""
        return sum(b - a for n, a, b in self.ops
                   if (match is None or match in n)
                   and (exclude is None or exclude not in n)
                   and not (kernels_only and n.startswith(("Memcpy", "Memset"))))

    def breakdown(self, spans: Spans) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps, each named by the host span running at its
        middle."""
        by_name: dict[str, float] = {}
        for n, a, b in self.ops:
            by_name[n[:120]] = by_name.get(n[:120], 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:10]:
            mid = (a + b) / 2
            running = [s[0] for s in spans.between(mid, mid)]
            named.append(["host: " + (", ".join(sorted(set(running)))
                                      or "no benchmark span"), b - a])
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": named}


# ------------------------------------------------------------ run result


class Check:
    """One number compared with its limit: `value <= limit` for "<=",
    `value >= limit` for ">="."""

    def __init__(self, name, value, limit, rule="<="):
        self.name, self.value, self.limit, self.rule = name, value, limit, rule

    @property
    def ok(self) -> bool:
        return (self.value <= self.limit if self.rule == "<="
                else self.value >= self.limit)

    def as_json(self) -> dict:
        return {"value": self.value, "limit": self.limit, "rule": self.rule}
