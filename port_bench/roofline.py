"""Least time the H100 could take for the program's queue kernel,
reckoned from the inputs' shapes and the live rows alone, the same whatever
implements it: `chip_smoke.py`'s `queue_bound` arithmetic (same peaks, same operation count), frozen here and narrowed to
the kernel, since the per-layer roofline metric divides by the profiled
time of the kernel alone. The kernel reads the node state and the orders
once, its rows once, and writes its decisions and the availability once;
it does OPS_PER_NODE_ROW int32 operations per node per live row (times the
zones for the single-AZ fills). The sorts around it are the orders
layer's, measured as device time.

Peaks: NVIDIA's H100 SXM data sheet, at the full 700 W: 3.35 TB/s of HBM,
and 67 TFLOP/s of float32 outside the tensor cores, which stands in for
scalar int32 work.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_SCALAR_OPS_S = 67e12
# int32 operations per node per live row that any row walk must do: the
# capacity identity (5 per dimension + 3) and the driver feasibility
# test (6).
OPS_PER_NODE_ROW = 24
# One node of a kernel's orders: driver and executor rank and order
# (int32), driver and executor eligibility (bool).
ORDER_BYTES_PER_NODE = 4 * 4 + 2
# One node's state as the kernels read it: availability (3 int32), zone.
STATE_BYTES_PER_NODE = 4 * 4
# One app row: driver and executor requests (3 int32 each), count (int32),
# valid and skippable (bool).
ROW_BYTES = 7 * 4 + 2


def zone_passes(fill: str, num_zones: int) -> int:
    return num_zones if fill.startswith(("single-az", "az-aware")) else 1


def _least(t_bytes: float, ops: float) -> float:
    return max(t_bytes / PEAK_BYTES_S, ops / PEAK_SCALAR_OPS_S)


def queue_kernel_bound(*, nodes, groups, apps, live, emax, num_zones,
                       fill) -> float:
    """Seconds for one launch of the queue kernel over `groups` queues:
    node state and orders read once, apps read once, decisions and
    availability written once, the row walk's int32 work per live app."""
    n = nodes
    in_bytes = groups * (n * (STATE_BYTES_PER_NODE + ORDER_BYTES_PER_NODE)
                         + apps * ROW_BYTES)
    out_bytes = groups * (apps * (4 + emax) * 4 + 2 * apps + n * 3 * 4)
    ops = groups * live * n * OPS_PER_NODE_ROW * zone_passes(fill, num_zones)
    return _least(in_bytes + out_bytes, ops)
