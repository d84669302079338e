"""Packing efficiency (binpack/efficiency.go:23-156) for host-side reporting,
copied from spark_scheduler_tpu/ops/efficiency.py (`avg_packing_efficiency_np`
is numpy on both sides, so the two packages report identical floats), and
`zone_score`, the single-AZ zone score on tensors.

Per-node efficiency = (already-reserved + newly-reserved) / schedulable per
dim; GPU only counts on nodes with schedulable GPU. The average runs over a
packing's entries (driver + one entry PER executor). Deviation from the
reference, recorded deliberately: exact fixed-point units are divided in
float32, where the Go code divides rounded `Quantity.Value()`s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spark_scheduler_tpu_torch.models.resources import (
    CPU_DIM,
    GPU_DIM,
    MEM_DIM,
)


class AvgEfficiency(NamedTuple):
    cpu: float
    memory: float
    gpu: float
    max: float  # the field zone selection compares (efficiency.go:36-39)


def avg_packing_efficiency_np(
    schedulable,
    available,
    driver_node: int,
    executor_nodes,
    driver_req,
    exec_req,
) -> AvgEfficiency:
    """Average packing efficiency of one packing, in O(entries): the means
    only read the driver/executor entry rows."""
    executor_nodes = np.asarray(executor_nodes)
    entries = np.concatenate([[driver_node], executor_nodes])
    valid = entries >= 0
    if not valid.any():
        return AvgEfficiency(cpu=0.0, memory=0.0, gpu=0.0, max=0.0)
    schedulable = np.asarray(schedulable)
    available = np.asarray(available)
    dreq = np.asarray(driver_req)
    ereq = np.asarray(exec_req)
    idx = np.clip(entries, 0, None).astype(np.int64)
    uniq, pos = np.unique(idx, return_inverse=True)  # entry -> uniq row
    sched_u = schedulable[uniq]
    new_res_u = np.zeros_like(sched_u)
    if driver_node >= 0:
        new_res_u[pos[0]] += dreq
    ex_valid = valid.copy()
    ex_valid[0] = False
    if ex_valid.any():
        np.add.at(new_res_u, pos[ex_valid], ereq)
    reserved_u = (sched_u - available[uniq]) + new_res_u
    denom_u = np.where(sched_u == 0, 1, sched_u).astype(np.float32)
    eff_u = reserved_u.astype(np.float32) / denom_u
    gpu_node_u = sched_u[:, GPU_DIM] != 0
    eff_gpu_u = np.where(gpu_node_u, eff_u[:, GPU_DIM], 0.0)
    node_max_u = np.maximum(
        eff_gpu_u, np.maximum(eff_u[:, CPU_DIM], eff_u[:, MEM_DIM])
    )

    cnt = float(valid.sum())
    cpu_mean = float(np.where(valid, eff_u[pos, CPU_DIM], 0.0).sum() / cnt)
    mem_mean = float(np.where(valid, eff_u[pos, MEM_DIM], 0.0).sum() / cnt)
    gpu_valid = valid & gpu_node_u[pos]
    gpu_cnt = int(gpu_valid.sum())
    gpu_mean = (
        1.0  # no GPU nodes among entries => 1 (efficiency.go:139-144)
        if gpu_cnt == 0
        else float(np.where(gpu_valid, eff_gpu_u[pos], 0.0).sum() / gpu_cnt)
    )
    max_mean = float(np.where(valid, node_max_u[pos], 0.0).sum() / cnt)
    return AvgEfficiency(cpu=cpu_mean, memory=mem_mean, gpu=gpu_mean, max=max_mean)


def zone_score_sum(
    is_drv: torch.Tensor,  # [N] i32, 1 on the driver's node
    counts: torch.Tensor,  # [N] i32 executors placed per node
    sched: torch.Tensor,  # [N,3] i32
    avail: torch.Tensor,  # [N,3] i32
    dreq: torch.Tensor,  # [3] i32
    ereq: torch.Tensor,  # [3] i32
    include_exec_in_reserved: bool,
) -> torch.Tensor:  # 0-d float64
    """The float64 sum of `zone_score`'s per-node terms over these nodes.
    A node-sharded solve (parallel/node_shards.py) adds its shards' sums
    and rounds that once; the order of the additions differs from one
    sum over all nodes, so the float64 totals can differ in the last ulp
    and, rarely, the float32 scores too: equal except for a cross-zone
    tie within one float32 ulp."""
    new_res = is_drv[:, None] * dreq[None, :]
    if include_exec_in_reserved:
        new_res = new_res + counts[:, None] * ereq[None, :]
    reserved = (sched - avail) + new_res
    eff = reserved.to(torch.float32) / torch.clamp(sched, min=1).to(torch.float32)
    eff_gpu = torch.where(sched[:, GPU_DIM] != 0, eff[:, GPU_DIM], 0.0)
    node_max = torch.maximum(
        eff_gpu, torch.maximum(eff[:, CPU_DIM], eff[:, MEM_DIM])
    )
    w = (counts + is_drv).to(torch.float32)
    return (node_max * w).to(torch.float64).sum()


def zone_score(
    count,  # executors in the gang (int or 0-d tensor)
    is_drv: torch.Tensor,  # [N] i32, 1 on the driver's node
    counts: torch.Tensor,  # [N] i32 executors placed per node
    sched: torch.Tensor,  # [N,3] i32
    avail: torch.Tensor,  # [N,3] i32 — availability the gang packed against
    dreq: torch.Tensor,  # [3] i32
    ereq: torch.Tensor,  # [3] i32
    include_exec_in_reserved: bool,
) -> torch.Tensor:  # 0-d float32
    """Single-AZ zone score (single_az.go:23-97): the float32 mean over the
    packing's entries (driver + one per executor) of the per-node max
    dimension efficiency with the tentative reservation applied
    (efficiency.go:85-144). minimalFragmentation leaves its executors out
    of the reservation (`include_exec_in_reserved=False`). Each node's term
    is its float32 efficiency times its entry count, rounded to float32;
    the terms are summed in float64 and rounded once, so the score does not
    depend on summation order (the CUDA row walk reproduces it exactly).
    The JAX package sums in float32 instead: the two can differ in the last
    ulp, which only matters for a cross-zone tie closer than that. Stays on
    the tensors' device: no host synchronisation."""
    total = zone_score_sum(
        is_drv, counts, sched, avail, dreq, ereq, include_exec_in_reserved
    ).to(torch.float32)
    # A tensor divisor on the device: a scalar one may be applied as a
    # multiplication by its reciprocal, which rounds differently.
    entries = torch.as_tensor(count, device=total.device) + 1
    return total / entries.to(torch.float32)
