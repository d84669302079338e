"""The per-gang solve, in plain PyTorch.

Counterpart of the closures the JAX package shares between its two Mosaic
kernels (spark_scheduler_tpu/ops/pallas_fifo.py `make_driver_selector`,
`make_fill_runner`, `make_gang_solver`), and `walk_rows`, the FIFO row walk
around it that the window and queue paths share. The same math runs on the
card as CUDA device functions in csrc/gang_solve.cuh; this module is its
plain version, used on the CPU and as the card kernels' yardstick of
correctness.

Nodes are keyed by the segment's priority RANKS: `drank`/`erank` are
permutations of 0..N-1 (rank of each node in the driver/executor priority
order) and `d_order`/`e_order` their inverses, so "the first node in
priority order among a mask" is the minimum rank over the mask, and its node
is `order[rank]`. The card kernels place executors slot by slot
(pallas_fifo.py:26-40): tightly-pack gives each slot to the open node of
smallest executor rank, distribute-evenly to the open node of smallest
(slots already placed there, executor rank), minimal-fragmentation to the
smallest single node fitting the whole gang, else consumes nodes in
(clamped capacity desc, rank asc) order and puts the remainder on the
smallest unconsumed node fitting it. Their plain version here is the
closed form of the same greedy outcome, shared with the batched engine
(ops/packing.py `_FILLS`).

Single-AZ wrappers: the inner fill runs per zone; a zone's score is the
float32 mean, over entries (driver + one per executor), of the per-node max
dimension efficiency with the tentative reservation applied; the strictly
greatest score wins, ties to the zone that appears first in driver priority
order, and a best score of exactly 0.0 rejects (single_az.go:23-97). The
weighted sum is accumulated in float64 over the float32 products and rounded
once to float32, so it does not depend on summation order and the card
kernel reproduces it exactly. The JAX package sums in float32 in tile order
instead; the two can differ in the last ulp, so a cross-zone tie closer than
about 1 ulp may break differently (the deviation pallas_fifo.py:49-56
documents between the JAX package's own two paths).
"""

from __future__ import annotations

import numpy as np
import torch

from spark_scheduler_tpu_torch.models.resources import INT32_INF
from spark_scheduler_tpu_torch.ops.capacity import fits, node_capacities
from spark_scheduler_tpu_torch.ops.efficiency import zone_score
from spark_scheduler_tpu_torch.ops.packing import _FILLS

PALLAS_FILLS = ("tightly-pack", "distribute-evenly", "minimal-fragmentation")

# Single-AZ strategy -> (inner fill, az-aware plain fallback, executors
# counted in the zone-efficiency reservation — the minimalFragmentation
# quirk, ops/efficiency.py).
PALLAS_SINGLE_AZ = {
    "single-az-tightly-pack": ("tightly-pack", False, True),
    "single-az-minimal-fragmentation": ("minimal-fragmentation", False, False),
    "az-aware-tightly-pack": ("tightly-pack", True, True),
}

# Inner fill -> the `fill` code of the CUDA kernels (csrc/gang_solve.cuh).
FILL_CODES = {
    "tightly-pack": 0,
    "distribute-evenly": 1,
    "minimal-fragmentation": 2,
}

INF = INT32_INF


def strategy_params(fill: str):
    """(inner fill, single-AZ, az-aware fallback, executors counted in the
    zone-efficiency reservation) of one of the six strategies."""
    if fill in PALLAS_SINGLE_AZ:
        inner, az_fallback, include_exec = PALLAS_SINGLE_AZ[fill]
        return inner, True, az_fallback, include_exec
    if fill in PALLAS_FILLS:
        return fill, False, False, True
    raise ValueError(f"unsupported strategy: {fill}")


def _masked_min(mask: torch.Tensor, vals: torch.Tensor) -> int:
    return int(torch.where(mask, vals, INF).min())


def select_driver(count, cap_e, cap_wd, fit_d, elig_d, drank, d_order, zmask):
    """The feasibility identity (ops/packing.py pack_one_app): reserving the
    driver on node i only changes node i's executor capacity. Returns
    (found, driver node or -1, executor capacities with it reserved)."""
    cap_e_m = torch.where(zmask, cap_e, 0)
    cap_wd_m = torch.where(zmask, cap_wd, 0)
    cap_e_c = torch.clamp(cap_e_m, max=count)
    cap_wd_c = torch.clamp(cap_wd_m, max=count)
    total_if = cap_e_c.sum() - cap_e_c + cap_wd_c
    feasible = elig_d & zmask & fit_d & (total_if >= count)
    best_rank = _masked_min(feasible, drank)
    if best_rank >= INF:
        return False, -1, cap_e_m
    drv = int(d_order[best_rank])
    caps_fill = cap_e_m.clone()
    caps_fill[drv] = cap_wd_m[drv]
    return True, drv, caps_fill


def run_fill(inner_fill, emax, count, ok, caps_fill, erank, e_order):
    """Executor placement for one gang: ([emax] node per slot, -1 padded;
    [N] int32 executors per node). The closed-form fills of ops/packing.py
    over the capacities in executor priority order; `caps_fill` is zero on
    every node the gang may not use."""
    n = caps_fill.shape[0]
    counts = torch.zeros(n, dtype=torch.int32, device=caps_fill.device)
    if not ok:
        return [-1] * emax, counts
    if inner_fill not in _FILLS:
        raise ValueError(f"unsupported fill: {inner_fill}")
    nodes, _ = _FILLS[inner_fill](
        caps_fill[e_order.long()], e_order, count, emax
    )
    counts.index_add_(
        0, torch.clamp(nodes, min=0).long(), (nodes >= 0).to(torch.int32)
    )
    return nodes.tolist(), counts


def zone_efficiency(count, drv, counts, sched, avail, dreq, ereq,
                    include_exec_in_reserved) -> np.float32:
    """Single-AZ zone score on the host (`ops/efficiency.zone_score`)."""
    is_drv = torch.zeros_like(counts)
    if drv >= 0:
        is_drv[drv] = 1
    dev = counts.device
    score = zone_score(
        count, is_drv, counts, sched, avail,
        torch.as_tensor(dreq, dtype=torch.int32, device=dev),
        torch.as_tensor(ereq, dtype=torch.int32, device=dev),
        include_exec_in_reserved,
    )
    return np.float32(float(score))


def gang_solve(
    fill: str,
    *,
    num_zones: int,
    emax: int,
    count: int,
    cap_e: torch.Tensor,  # [N] i32 executor capacity, no driver reserved
    cap_wd: torch.Tensor,  # [N] i32 executor capacity with the driver
    fit_d: torch.Tensor,  # [N] bool driver fits
    elig_e: torch.Tensor,  # [N] bool
    elig_d: torch.Tensor,  # [N] bool
    drank: torch.Tensor,  # [N] i32
    d_order: torch.Tensor,  # [N] i32
    erank: torch.Tensor,  # [N] i32
    e_order: torch.Tensor,  # [N] i32
    zone: torch.Tensor,  # [N] i32
    sched: torch.Tensor,  # [N,3] i32
    avail: torch.Tensor,  # [N,3] i32
    dreq,  # [3] ints
    ereq,  # [3] ints
):
    """Driver selection + executor fill for one gang, and for the single-AZ
    wrappers the per-zone pack and zone pick (make_gang_solver semantics).
    Returns (ok, driver node or -1, [emax] executor slots, [N] counts)."""
    inner, single_az, az_fallback, include_exec = strategy_params(fill)
    all_nodes = torch.ones_like(elig_e)

    def solve_in(zmask):
        found, drv, caps = select_driver(
            count, cap_e, cap_wd, fit_d, elig_d, drank, d_order, zmask
        )
        execs, counts = run_fill(inner, emax, count, found, caps, erank, e_order)
        return found, drv, execs, counts

    if not single_az:
        return solve_in(all_nodes)

    best = None
    best_eff = np.float32(-1.0)
    best_first = INF
    any_valid = False
    for z in range(num_zones):
        zmask = zone == z
        zone_first = _masked_min(elig_d & zmask, drank)
        zone_has_exec = bool((elig_e & zmask).any())
        found, drv, execs, counts = solve_in(zmask)
        valid_z = found and zone_first < INF and zone_has_exec
        if not valid_z:
            continue
        any_valid = True
        eff = zone_efficiency(
            count, drv, counts, sched, avail, dreq, ereq, include_exec
        )
        if eff > best_eff or (eff == best_eff and zone_first < best_first):
            best_eff, best_first = eff, zone_first
            best = (True, drv, execs, counts)
    # chooseBestResult replaces only on strictly greater than 0.0.
    if any_valid and best_eff > 0.0:
        return best
    if az_fallback:
        # az-aware: the plain pack when no single zone fits
        # (az_aware_pack_tightly.go:27-38).
        return solve_in(all_nodes)
    return False, -1, [-1] * emax, torch.zeros_like(cap_e)


def walk_rows(
    fill: str,
    *,
    num_zones: int,
    emax: int,
    cluster,  # ClusterTensors: zone_id and schedulable are read
    avail: torch.Tensor,  # [N,3] i32, debited in place by admitted rows
    orders,  # (elig_e, elig_d, drank, d_order, erank, e_order)
    driver_req: np.ndarray,  # [R,3] i32
    exec_req: np.ndarray,  # [R,3] i32
    exec_count: np.ndarray,  # [R] i32
    valid: np.ndarray,  # [R] bool
    skippable: np.ndarray,  # [R] bool
):
    """The plain FIFO row walk, shared by the window and queue paths (the
    loop of pallas_fifo.py `_make_kernel` and of the window kernel): rows in
    order, availability carried from row to row, one `gang_solve` per valid
    row. `packed` = the gang fits and `count <= emax`; `admitted` = packed
    and not blocked; an admitted gang is debited from `avail`; a valid,
    non-skippable row that does not pack blocks every later row
    (resource.go:241-249). Padding rows never pack, debit or block.

    Returns host (meta [R,4] i32 rows of (driver, admitted, packed, 0) with
    driver -1 unless admitted, execs [R,emax] i32, -1 unless admitted)."""
    elig_e, elig_d, drank, d_order, erank, e_order = orders
    dev = avail.device
    r_pad = len(exec_count)
    meta = np.zeros((r_pad, 4), np.int32)
    meta[:, 0] = -1
    execs = np.full((r_pad, emax), -1, np.int32)
    no_res = torch.zeros_like(avail)
    blocked = False
    for r in range(r_pad):
        if not valid[r]:
            continue
        raw = int(exec_count[r])
        count = min(raw, emax)
        dreq = driver_req[r]
        ereq = exec_req[r]
        dreq_t = torch.as_tensor(dreq, dtype=torch.int32, device=dev)
        ereq_t = torch.as_tensor(ereq, dtype=torch.int32, device=dev)
        cap_e = torch.where(elig_e, node_capacities(avail, no_res, ereq_t), 0)
        cap_wd = torch.where(
            elig_e,
            node_capacities(avail, dreq_t.expand_as(avail), ereq_t),
            0,
        )
        ok, drv, row_execs, counts = gang_solve(
            fill, num_zones=num_zones, emax=emax, count=count,
            cap_e=cap_e, cap_wd=cap_wd, fit_d=fits(avail, dreq_t),
            elig_e=elig_e, elig_d=elig_d, drank=drank, d_order=d_order,
            erank=erank, e_order=e_order, zone=cluster.zone_id,
            sched=cluster.schedulable, avail=avail, dreq=dreq, ereq=ereq,
        )
        packed = ok and raw <= emax
        admitted = packed and not blocked
        if admitted:
            delta = counts[:, None] * ereq_t[None, :]
            delta[drv] += dreq_t
            avail -= delta
            meta[r] = (drv, 1, 1, 0)
            execs[r] = row_execs
        else:
            meta[r, 2] = int(packed)
        blocked = blocked or (not packed and not skippable[r])
    return meta, execs
