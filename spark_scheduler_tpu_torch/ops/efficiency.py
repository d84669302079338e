"""Packing efficiency (binpack/efficiency.go:23-156) for host-side reporting,
copied from spark_scheduler_tpu/ops/efficiency.py (`avg_packing_efficiency_np`
is numpy on both sides, so the two packages report identical floats).

Per-node efficiency = (already-reserved + newly-reserved) / schedulable per
dim; GPU only counts on nodes with schedulable GPU. The average runs over a
packing's entries (driver + one entry PER executor). Deviation from the
reference, recorded deliberately: exact fixed-point units are divided in
float32, where the Go code divides rounded `Quantity.Value()`s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

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
