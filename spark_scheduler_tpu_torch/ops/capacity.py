"""Per-node executor capacity (binpack/minimal_fragmentation.go:113-151
`getNodeCapacity` / `getCapacityAgainstSingleDimension`), the port's
counterpart of spark_scheduler_tpu/ops/capacity.py. Exact integer
semantics:

  per dim: 0                       if reserved > available
           INF                     if required == 0
           floor((avail-res)/req)  otherwise
  node capacity = min over dims, never negative.

The floor division only ever sees a non-negative numerator (the
`reserved > available` case is masked first) and a divisor clamped to 1,
and uses `torch.div(..., rounding_mode="floor")` explicitly.
"""

from __future__ import annotations

import torch

from spark_scheduler_tpu_torch.models.resources import INT32_INF

CAP_INF = INT32_INF


def node_capacities(
    available: torch.Tensor,  # [N, 3] i32
    reserved: torch.Tensor,  # [N, 3] i32 (already-tentatively-reserved)
    request: torch.Tensor,  # [3] i32 (one executor)
) -> torch.Tensor:  # [N] i32
    """How many `request`-shaped items fit on each node."""
    diff = available - reserved
    req = request.reshape(1, -1)
    safe = torch.clamp(req, min=1)
    over = reserved > available
    per_dim = torch.where(
        req == 0,
        torch.full_like(diff, CAP_INF),
        torch.div(torch.where(over, 0, diff), safe, rounding_mode="floor"),
    )
    per_dim = torch.where(over, 0, per_dim)
    return torch.clamp(per_dim.min(dim=-1).values, min=0).to(torch.int32)


def fits(
    available: torch.Tensor,  # [N, 3] i32
    request: torch.Tensor,  # [3] i32
) -> torch.Tensor:  # [N] bool
    """Per-node `not request.greater_than(available)` (resources.go:242-245)."""
    return (request.reshape(1, -1) <= available).all(dim=-1)
