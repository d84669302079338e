"""Node-priority ordering (internal/sort/nodesorting.go), the port's
counterpart of spark_scheduler_tpu/ops/sorting.py:

  1. AZ priority: zones ranked ascending by total available (memory first,
     then CPU) over the metadata domain (nodesorting.go:97-121).
  2. Within a zone: available memory asc, then CPU asc, then node name
     (nodesorting.go:84-95).
  3. Optional configured label priority as the most significant key,
     missing labels rank last (nodesorting.go:62-64,160-185).

Every order is exactly `numpy.lexsort`'s over the int32 keys (name rank,
cpu, mem, zone rank, label rank, not eligible), least significant first,
and every zone rank exactly its lexsort over (zone id, cpu sum, mem sum,
absent). Both are sorted as chains of stable argsorts: a stable pass by k2
over an order already sorted by k1 orders by (k2, k1), which is lexsort's
definition. Fewer passes do the same work over keys packed without loss:

  - Zone sums are exact int64 sums (`index_add_` over the node rows). The
    JAX package sums int32 8-bit chunks and compares their carry-normal
    form (s3, s2, s1, s0), s2..s0 in 0..255, which orders exactly as the
    sum S = s3 * 2^24 + s2 * 2^16 + s1 * 2^8 + s0 does; a `zone_base` limb
    pair rebuilds exactly as S = (hi << 24) + lo. core/prune.py's
    `zone_ranks_host` rests on the same equality. Zones sort in three
    passes, cpu sum, mem sum, absent; the zone id is the stable sort's own
    tie-break.
  - lo = (mem << 32) + (cpu + 2^31), int64: mem signed in bits 32-63, cpu
    biased into 0..2^32-1 in bits 0-31, so lo orders as (mem, cpu) and
    spans [-2^63, 2^63 - 1] exactly.
  - hi = (not eligible) << (32 + zbits) | (label + 2^31) << zbits | zone
    rank, int64, zbits = bit_length(num_zones - 1): the zone rank
    (0..num_zones-1) in bits 0..zbits-1, the biased label in the next 32,
    the flag above them, so hi < 2^(33 + zbits) <= 2^63 while num_zones <=
    2^30 (`MAX_PACKED_ZONES`; beyond it the key would overflow, and
    `priority_order` and `priority_orders` raise).

An order is three passes: name rank, lo, hi. The driver and the executor
orders over one availability share the first two (`priority_orders`), so
the two cost four passes over the nodes.
"""

from __future__ import annotations

from typing import Sequence

import torch

from spark_scheduler_tpu_torch.models.cluster import ClusterTensors
from spark_scheduler_tpu_torch.models.resources import CPU_DIM, MEM_DIM

MAX_PACKED_ZONES = 2**30


def _rank_of_position(order: torch.Tensor) -> torch.Tensor:
    """rank[node] = position of node in `order` (int32); `order` is a
    permutation of 0..n-1, so every slot is written."""
    n = order.shape[0]
    rank = torch.empty(n, dtype=torch.int32, device=order.device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=order.device)
    return rank


def stable_argsort(key: torch.Tensor) -> torch.Tensor:
    """One stable sort pass (int64 indices), counted in
    `stable_argsort.passes`."""
    stable_argsort.passes += 1
    return torch.argsort(key, stable=True)


stable_argsort.passes = 0


def _then_by(order: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """`order` re-sorted stably by `key`: ties keep their place in `order`."""
    return order[stable_argsort(key[order])]


def lexsort_torch(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """`numpy.lexsort` semantics (the LAST key is primary; ties keep index
    order) as chained stable argsorts. Returns int64 indices."""
    order = stable_argsort(keys[0])
    for k in keys[1:]:
        order = _then_by(order, k)
    return order


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
    # The domain's (cpu, mem, 1) rows, summed by zone exactly in int64.
    rows = torch.stack((available[:, CPU_DIM], available[:, MEM_DIM], mask), 1)
    rows = torch.where(mask[:, None], rows, 0).to(torch.int64)
    sums = torch.zeros((num_zones, 3), dtype=torch.int64, device=mask.device)
    sums.index_add_(0, cluster.zone_id.long(), rows)
    cpu, mem, absent = sums[:, 0], sums[:, 1], sums[:, 2] == 0
    if zone_base is not None:
        mem_hi, mem_lo, cpu_hi, cpu_lo, base_present = zone_base
        cpu = cpu + (cpu_hi.to(torch.int64) << 24) + cpu_lo
        mem = mem + (mem_hi.to(torch.int64) << 24) + mem_lo
        absent = absent & ~base_present
    return _rank_of_position(lexsort_torch((cpu, mem, absent)))


def _zone_bits(num_zones: int) -> int:
    """zbits of the hi key; raises where the key would overflow int64."""
    if num_zones > MAX_PACKED_ZONES:
        raise ValueError(
            f"{num_zones} zones: the packed priority key holds at most "
            f"{MAX_PACKED_ZONES}"
        )
    return (num_zones - 1).bit_length()


def _zone_key(cluster: ClusterTensors, zrank: torch.Tensor):
    """(key, flag, unit): per node, hi's zone rank, label bias and flag
    with the flag set (int64); an eligible node subtracts `flag`, and the
    label rank adds in `unit`s."""
    zbits = _zone_bits(zrank.shape[0])
    flag = 1 << (32 + zbits)
    key = zrank.to(torch.int64) + (flag + (1 << (31 + zbits)))
    return key[cluster.zone_id.long()], flag, 1 << zbits


def _by_name_then_lo(cluster: ClusterTensors, available: torch.Tensor):
    """Passes 1-2: int64 node indices ordered by (mem, cpu, name rank)."""
    lo = torch.add(
        available[:, CPU_DIM].to(torch.int64) + 2**31,
        available[:, MEM_DIM], alpha=2**32,
    )
    return _then_by(stable_argsort(cluster.name_rank), lo)


def priority_order(
    cluster: ClusterTensors,
    eligible: torch.Tensor,  # [N] bool
    zrank: torch.Tensor,  # [num_zones] i32 from zone_ranks
    label_rank: torch.Tensor,  # [N] i32 (INT32_INF = unranked)
    available: torch.Tensor | None = None,  # [N,3] override
) -> tuple[torch.Tensor, torch.Tensor]:
    """(order[N] int32 node indices, count) — eligible nodes in priority
    order, ineligible pushed to the end. `count` stays a device scalar.
    Raises for more than `MAX_PACKED_ZONES` zones."""
    if available is None:
        available = cluster.available
    az, flag, unit = _zone_key(cluster, zrank)
    elig = eligible & cluster.valid
    hi = torch.add(torch.add(az, elig, alpha=-flag), label_rank, alpha=unit)
    order = _then_by(_by_name_then_lo(cluster, available), hi)
    return order.to(torch.int32), elig.sum().to(torch.int32)


def priority_orders(
    cluster: ClusterTensors,
    driver_elig: torch.Tensor,  # [N] bool
    exec_elig: torch.Tensor,  # [N] bool
    zrank: torch.Tensor,  # [num_zones] i32 from zone_ranks
    available: torch.Tensor | None = None,  # [N,3] override
) -> tuple[torch.Tensor, torch.Tensor]:
    """(driver order, executor order), int32 node indices: `priority_order`
    of each eligibility with the cluster's driver and executor label ranks,
    in four passes where two calls take six, since both share the name and
    lo passes. One tensor passed as both eligibilities (queue mode) is
    masked once."""
    if available is None:
        available = cluster.available
    az, flag, unit = _zone_key(cluster, zrank)
    base = _by_name_then_lo(cluster, available)
    d_key = torch.add(az, driver_elig & cluster.valid, alpha=-flag)
    e_key = (
        d_key if exec_elig is driver_elig
        else torch.add(az, exec_elig & cluster.valid, alpha=-flag)
    )
    return tuple(
        _then_by(base, torch.add(key, label, alpha=unit)).to(torch.int32)
        for key, label in (
            (d_key, cluster.label_rank_driver),
            (e_key, cluster.label_rank_executor),
        )
    )
