"""Node-priority ordering (internal/sort/nodesorting.go), the port's
counterpart of spark_scheduler_tpu/ops/sorting.py:

  1. AZ priority: zones ranked ascending by total available (memory first,
     then CPU) over the metadata domain (nodesorting.go:97-121).
  2. Within a zone: available memory asc, then CPU asc, then node name
     (nodesorting.go:84-95).
  3. Optional configured label priority as the most significant key,
     missing labels rank last (nodesorting.go:62-64,160-185).

PyTorch has no `lexsort`: `lexsort_torch` chains stable argsorts, least
significant key first, which is exactly lexsort's definition. Keys are never
packed into int64 (name_rank x mem x cpu would overflow).
"""

from __future__ import annotations

from typing import Sequence

import torch

from spark_scheduler_tpu_torch.models.cluster import ClusterTensors
from spark_scheduler_tpu_torch.models.resources import CPU_DIM, MEM_DIM


def _rank_of_position(order: torch.Tensor) -> torch.Tensor:
    """rank[node] = position of node in `order` (int32)."""
    n = order.shape[0]
    rank = torch.zeros(n, dtype=torch.int32, device=order.device)
    rank[order.long()] = torch.arange(n, dtype=torch.int32, device=order.device)
    return rank


def lexsort_torch(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """`numpy.lexsort` semantics (the LAST key is primary; ties keep index
    order) as chained stable argsorts. Returns int64 indices."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _zone_sum_chunks(vals, mask, zone_id, num_zones: int, base=None) -> list:
    """Exact int32 per-zone sums without int64: each value splits into four
    8-bit chunks (the top chunk keeps the sign via arithmetic shift), each
    chunk is segment-summed, then carries normalize upward. Low-chunk sums
    are <= n*255, exact for n < 2^23 nodes. Chunks most-significant first,
    comparable lexicographically. `base` = (hi, lo) int32 limbs of per-zone
    offsets (S >> 24, S & 0xFFFFFF), added into the chunks before the
    carries normalize."""
    v = torch.where(mask, vals, 0)
    zone = zone_id.long()

    def seg(x):
        out = torch.zeros(num_zones, dtype=torch.int32, device=v.device)
        return out.index_add_(0, zone, x.to(torch.int32))

    s3 = seg(v >> 24)
    s2 = seg((v >> 16) & 0xFF)
    s1 = seg((v >> 8) & 0xFF)
    s0 = seg(v & 0xFF)
    if base is not None:
        hi, lo = base
        s3 = s3 + hi
        s2 = s2 + ((lo >> 16) & 0xFF)
        s1 = s1 + ((lo >> 8) & 0xFF)
        s0 = s0 + (lo & 0xFF)
    s1 = s1 + (s0 >> 8)
    s0 = s0 & 0xFF
    s2 = s2 + (s1 >> 8)
    s1 = s1 & 0xFF
    s3 = s3 + (s2 >> 8)
    s2 = s2 & 0xFF
    return [s3, s2, s1, s0]


def zone_ranks(
    cluster: ClusterTensors,
    domain_mask: torch.Tensor,  # [N] bool — nodes in the metadata domain
    num_zones: int,  # upper bound on the zone-id space
    available: torch.Tensor | None = None,  # [N,3] override
    zone_base: tuple | None = None,  # pruned-solve zone-sum offsets
) -> torch.Tensor:  # [num_zones] i32: rank of each zone (0 = highest priority)
    """Zones ordered ascending by (total available memory, total CPU)
    (nodesorting.go:101-104, 124-134). Zones with no domain nodes rank last;
    ties between zones are pinned by zone id.

    `zone_base` = (mem_hi, mem_lo, cpu_hi, cpu_lo, present), [num_zones]
    tensors: the per-zone sums of rows left out of a gathered sub-cluster
    (candidate pruning), as int32 limbs hi = S >> 24, lo = S & 0xFFFFFF, and
    which zones those rows populate. The sub-cluster then ranks its zones
    exactly as the full domain does."""
    if available is None:
        available = cluster.available
    mask = domain_mask & cluster.valid
    mem_base = cpu_base = base_present = None
    if zone_base is not None:
        mem_hi, mem_lo, cpu_hi, cpu_lo, base_present = zone_base
        mem_base, cpu_base = (mem_hi, mem_lo), (cpu_hi, cpu_lo)
    mem_k = _zone_sum_chunks(
        available[:, MEM_DIM], mask, cluster.zone_id, num_zones, mem_base
    )
    cpu_k = _zone_sum_chunks(
        available[:, CPU_DIM], mask, cluster.zone_id, num_zones, cpu_base
    )
    members = torch.zeros(num_zones, dtype=torch.int32, device=mask.device)
    members.index_add_(0, cluster.zone_id.long(), mask.to(torch.int32))
    present = members > 0
    if base_present is not None:
        present = present | base_present
    keys = (
        [torch.arange(num_zones, device=mask.device)]
        + list(reversed(cpu_k))
        + list(reversed(mem_k))
        + [(~present).to(torch.int32)]
    )
    order = lexsort_torch(keys)
    return _rank_of_position(order)


def priority_order(
    cluster: ClusterTensors,
    eligible: torch.Tensor,  # [N] bool
    zrank: torch.Tensor,  # [num_zones] i32 from zone_ranks
    label_rank: torch.Tensor,  # [N] i32 (INT32_INF = unranked)
    available: torch.Tensor | None = None,  # [N,3] override
) -> tuple[torch.Tensor, torch.Tensor]:
    """(order[N] int32 node indices, count) — eligible nodes in priority
    order, ineligible pushed to the end. `count` stays a device scalar."""
    if available is None:
        available = cluster.available
    elig = eligible & cluster.valid
    az = zrank[cluster.zone_id.long()]
    mem = available[:, MEM_DIM]
    cpu = available[:, CPU_DIM]
    order = lexsort_torch(
        (cluster.name_rank, cpu, mem, az, label_rank, (~elig).to(torch.int32))
    )
    count = elig.sum().to(torch.int32)
    return order.to(torch.int32), count
