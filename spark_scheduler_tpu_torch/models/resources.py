"""Exact fixed-point resource algebra.

The PyTorch port's own copy of spark_scheduler_tpu/models/resources.py
(the port imports nothing of the JAX package). Rebuild of the reference's
resource layer
(vendor/.../k8s-spark-scheduler-lib/pkg/resources/resources.go:31-279). The
reference carries `k8s.io/apimachinery` `resource.Quantity` (infinite-precision
decimals) through every comparison; admission decisions only ever need exact
ordering and exact floor-division, so we normalize every quantity ONCE at the
boundary into integer fixed-point units and do all math in int64 host-side /
int32 device-side:

  dim 0: CPU    in millicores  (1 core  == 1000)
  dim 1: Memory in KiB         (1 Mi    == 1024)
  dim 2: GPU    in milli-GPUs  (1 GPU   == 1000)

These units are exact for every quantity k8s users actually write (integer
millicores; Ki/Mi/Gi/Ti memory; whole GPUs). Sub-KiB memory quantities round
UP for requests and DOWN for allocatable — conservative in the admission
direction, never optimistic (SURVEY.md §7 "Quantity fidelity").

Device-side the three dims form the last axis of an `[N, 3]` int32 tensor;
int32 bounds each dim at ~2.1e9 (2.1M cores / 2 TiB / 2.1M GPUs per node) —
`parse_quantity` saturates beyond that rather than overflowing.
"""

from __future__ import annotations

import dataclasses
import re
from fractions import Fraction
from functools import lru_cache

import numpy as np

CPU_DIM = 0
MEM_DIM = 1
GPU_DIM = 2
NUM_DIMS = 3

# Saturation bound for a single int32 device cell, leaving headroom so that a
# node's (allocatable - usage) stays representable even when overcommitted.
# Also used as the +inf sentinel across cluster tensors and kernels — the two
# uses must stay equal so clipped values never collide with sentinels.
INT32_SAT = 2**31 - 2
INT32_INF = INT32_SAT

_DECIMAL_SUFFIX = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}
_BINARY_SUFFIX = {
    "Ki": Fraction(2**10),
    "Mi": Fraction(2**20),
    "Gi": Fraction(2**30),
    "Ti": Fraction(2**40),
    "Pi": Fraction(2**50),
    "Ei": Fraction(2**60),
}

# Exponent alternative ([eE]...) must precede the bare "E" (exa) suffix so
# "1E3" parses as 1000 (k8s decimalExponent grammar), while "1E" is exa.
_QUANTITY_RE = re.compile(
    r"^\s*([+-]?\d+(?:\.\d*)?|\.\d+)(Ki|Mi|Gi|Ti|Pi|Ei|[eE][+-]?\d+|n|u|m|k|M|G|T|P|E)?\s*$"
)


def _parse_to_fraction(s: str | int | float) -> Fraction:
    """Parse a k8s quantity string (e.g. '500m', '8Gi', '1.5', '2e3') exactly."""
    if isinstance(s, int):
        return Fraction(s)
    if isinstance(s, float):
        return Fraction(s).limit_denominator(10**9)
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {s!r}")
    num, suffix = m.group(1), m.group(2) or ""
    base = Fraction(num)
    if suffix[:1] in ("e", "E") and len(suffix) > 1:  # decimal exponent
        return base * Fraction(10) ** int(suffix[1:])
    if suffix in _BINARY_SUFFIX:
        return base * _BINARY_SUFFIX[suffix]
    return base * _DECIMAL_SUFFIX[suffix]


def parse_quantity(s: str | int | float, dim: int, *, round_up: bool = True) -> int:
    """Parse a quantity into this framework's integer unit for `dim`.

    round_up=True (requests) rounds toward +inf; round_up=False (allocatable)
    rounds toward -inf, so rounding is always conservative for admission.

    Memoized: quantity strings repeat massively at serving time (every pod
    of a fleet carries the same handful of "8"/"8Gi"-style values), and the
    exact-Fraction parse is the expensive part. Pure function of hashable
    inputs — safe to cache."""
    return _parse_quantity_cached(s, dim, round_up)


@lru_cache(maxsize=8192)
def _parse_quantity_cached(s, dim: int, round_up: bool) -> int:
    frac = _parse_to_fraction(s)
    scale = 1024 if dim == MEM_DIM else 1000
    # Memory unit is KiB; CPU/GPU units are milli.
    if dim == MEM_DIM:
        scaled = frac / scale
    else:
        scaled = frac * scale
    n, d = scaled.numerator, scaled.denominator
    val = -((-n) // d) if round_up else n // d
    return max(-INT32_SAT, min(INT32_SAT, val))


@dataclasses.dataclass
class Resources:
    """A (cpu, memory, gpu) triple in fixed-point units.

    Mirrors `resources.Resources` (resources.go:150-166) with the same
    operation set: Add/Sub/Copy/SetMax/GreaterThan/Eq — but over plain ints.
    Mutating ops modify the receiver in place, matching the reference.
    """

    cpu_milli: int = 0
    mem_kib: int = 0
    gpu_milli: int = 0

    @classmethod
    def zero(cls) -> "Resources":
        return cls(0, 0, 0)

    @classmethod
    def from_quantities(
        cls, cpu="0", memory="0", gpu="0", *, round_up: bool = True
    ) -> "Resources":
        return cls(
            parse_quantity(cpu, CPU_DIM, round_up=round_up),
            parse_quantity(memory, MEM_DIM, round_up=round_up),
            parse_quantity(gpu, GPU_DIM, round_up=round_up),
        )

    def copy(self) -> "Resources":
        return Resources(self.cpu_milli, self.mem_kib, self.gpu_milli)

    def add(self, other: "Resources") -> "Resources":
        self.cpu_milli += other.cpu_milli
        self.mem_kib += other.mem_kib
        self.gpu_milli += other.gpu_milli
        return self

    def sub(self, other: "Resources") -> "Resources":
        self.cpu_milli -= other.cpu_milli
        self.mem_kib -= other.mem_kib
        self.gpu_milli -= other.gpu_milli
        return self

    def mul(self, k: int) -> "Resources":
        """Scale by an integer count (used for demand units / gang totals)."""
        return Resources(self.cpu_milli * k, self.mem_kib * k, self.gpu_milli * k)

    def set_max(self, other: "Resources") -> "Resources":
        """Per-dim max, the reference's SetMaxResource (resources.go:225-238)."""
        self.cpu_milli = max(self.cpu_milli, other.cpu_milli)
        self.mem_kib = max(self.mem_kib, other.mem_kib)
        self.gpu_milli = max(self.gpu_milli, other.gpu_milli)
        return self

    def greater_than(self, other: "Resources") -> bool:
        """True if ANY dim exceeds other's (resources.go:242-245): the fit
        check is `not request.greater_than(available)`."""
        return (
            self.cpu_milli > other.cpu_milli
            or self.mem_kib > other.mem_kib
            or self.gpu_milli > other.gpu_milli
        )

    def eq(self, other: "Resources") -> bool:
        return self.as_tuple() == other.as_tuple()

    def is_zero(self) -> bool:
        return self.as_tuple() == (0, 0, 0)

    def as_tuple(self) -> tuple[int, int, int]:
        return (self.cpu_milli, self.mem_kib, self.gpu_milli)

    def as_array(self) -> np.ndarray:
        return np.array(self.as_tuple(), dtype=np.int32)

    @classmethod
    def from_array(cls, arr) -> "Resources":
        a = np.asarray(arr)
        return cls(int(a[CPU_DIM]), int(a[MEM_DIM]), int(a[GPU_DIM]))

    def __repr__(self) -> str:  # human units for logs
        return (
            f"Resources(cpu={self.cpu_milli}m, mem={self.mem_kib}Ki, "
            f"gpu={self.gpu_milli}m)"
        )


class FrozenResources(Resources):
    """Read-only Resources view.

    Shared-aggregate queries (OverheadComputer.get_overhead) used to
    deep-copy every value under their lock so callers could not corrupt the
    aggregate; profiling showed the copies, not the lock, were the cost.
    A frozen view is handed out instead: mutators raise, `copy()` stays the
    escape hatch for a caller that genuinely needs a mutable value.

    Equality is by value against ANY Resources (the generated dataclass
    `__eq__` is class-exact and would make `Resources(...) ==
    FrozenResources(...)` silently False for equal triples)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        object.__setattr__(self, "_frozen", True)

    def __setattr__(self, name, value):
        # Direct field writes must fail too, not just the mutator methods
        # — a shared memoized view silently corrupted by `view.cpu_milli
        # -= x` would poison every later reader.
        if getattr(self, "_frozen", False):
            raise TypeError(
                "frozen Resources view — call .copy() before mutating"
            )
        object.__setattr__(self, name, value)

    def _reject(self, *_args, **_kwargs):
        raise TypeError(
            "frozen Resources view — call .copy() before mutating"
        )

    add = _reject
    sub = _reject
    set_max = _reject

    def __eq__(self, other):
        if isinstance(other, Resources):
            return self.as_tuple() == other.as_tuple()
        return NotImplemented

    __hash__ = None  # mutable-by-family type, same as Resources


def format_quantity_milli(milli: int) -> str:
    """Milli-units -> k8s quantity string ("1500m", or "2" when integral)."""
    if milli % 1000 == 0:
        return str(milli // 1000)
    return f"{milli}m"


def format_quantity_kib(kib: int) -> str:
    return f"{kib}Ki"


def resources_to_quantity_map(res: Resources) -> dict:
    """Wire-shape v1beta2 ResourceList {"cpu","memory","nvidia.com/gpu"}
    (types_resource_reservation.go:24-34,77-78); GPU omitted when zero,
    matching how the reference only carries it for GPU apps."""
    out = {
        "cpu": format_quantity_milli(res.cpu_milli),
        "memory": format_quantity_kib(res.mem_kib),
    }
    if res.gpu_milli:
        out["nvidia.com/gpu"] = format_quantity_milli(res.gpu_milli)
    return out


def resources_from_quantity_map(raw: dict | None) -> Resources:
    raw = raw or {}
    return Resources.from_quantities(
        str(raw.get("cpu", "0")),
        str(raw.get("memory", "0")),
        str(raw.get("nvidia.com/gpu", "0")),
    )


def stack_resources(items: list[Resources]) -> np.ndarray:
    """[len(items), 3] int32 tensor from a list of Resources."""
    if not items:
        return np.zeros((0, NUM_DIMS), dtype=np.int32)
    return np.stack([r.as_array() for r in items])
