"""Vectorized bin-packing strategies with slot-exact reference semantics,
the port's counterpart of spark_scheduler_tpu/ops/packing.py.

The reference's greedy loops (internal/extender/binpack.go:39-54) become
closed-form tensor programs: the per-node executor capacity
`cap[i] = floor((avail - reserved) / req)` fully determines each greedy
outcome, so a placement is prefix sums, sorts and searchsorted over `cap`,
and gang feasibility is `sum(cap) >= count`.

  tightly-pack: slot j lands on the first node whose cumulative capacity
      exceeds j.
  distribute-evenly: round-robin; slot j's round and index within the round
      come from searchsorted over the cumulative round sizes
      M[r] = #{i: cap_i > r}.
  minimal-fragmentation: the smallest single node fitting the whole gang;
      else consume nodes in (capacity desc, priority asc) order while the
      running total stays <= count, the remainder on the smallest
      unconsumed node fitting it.
  single-az-*: the inner pack per zone (zones in driver-priority
      first-appearance order), the best average packing efficiency wins
      (strictly greater, so the earliest zone wins ties).
  az-aware-tightly-pack: single-AZ tightly-pack, else plain tightly-pack.

Driver selection (`pack_one_app`, binpack.go:60-87) uses the feasibility
identity: reserving the driver on node d only changes node d's executor
capacity, so every driver candidate is checked at once.

These are plain PyTorch functions on tensors, on the CPU and the card alike.
`jax.vmap` over zones or candidates becomes a loop over them with the same
result. Every function stays on its tensors' device and reads nothing back
to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spark_scheduler_tpu_torch.models.cluster import ClusterTensors
from spark_scheduler_tpu_torch.models.resources import INT32_INF
from spark_scheduler_tpu_torch.ops.capacity import fits, node_capacities
from spark_scheduler_tpu_torch.ops.efficiency import zone_score
from spark_scheduler_tpu_torch.ops.sorting import (
    _rank_of_position,
    lexsort_torch,
    priority_order,
    priority_orders,
    zone_ranks,
)

SINGLE_AZ_PACKERS = frozenset(
    {"single-az-tightly-pack", "single-az-minimal-fragmentation"}
)
DEFAULT_BINPACK = "tightly-pack"


class Packing(NamedTuple):
    """Device-side PackingResult (binpack/binpack.go:25-31): node indices
    instead of names, -1 for "no node" / padding."""

    driver_node: torch.Tensor  # 0-d i32
    executor_nodes: torch.Tensor  # [Emax] i32
    has_capacity: torch.Tensor  # 0-d bool


def _check_cumsum_bound(n: int, emax: int) -> None:
    """Guard int32 accumulators bounded by n*emax (prefix sums, and the
    distribute-evenly key `placed * n + rank`) instead of overflowing
    silently. Clusters beyond this bound must shard the node axis."""
    if n * emax >= 2**31:
        raise ValueError(
            f"n_nodes*emax = {n}*{emax} >= 2^31: int32 prefix sums would "
            "overflow; shard the node axis across devices instead of packing "
            "a single flat tensor"
        )


def _as_count(count, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(count, dtype=torch.int32, device=like.device)


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=torch.int32)


def _masked_argmin_pos(mask, key, pos, n):
    """Smallest `pos` among `mask` nodes of minimal `key`, clipped to
    [0, n) (a dead index when `mask` is empty; callers gate on it)."""
    inf = torch.full_like(key, INT32_INF)
    k_min = torch.where(mask, key, inf).min()
    p = torch.where(mask & (key == k_min), pos, torch.full_like(pos, INT32_INF))
    return torch.clamp(p.min(), 0, n - 1)


# ---------------------------------------------------------------------------
# Executor-distribution fills. Each takes capacities arranged by executor
# priority position plus the position -> node map, and returns
# ([Emax] i32 node per slot, -1 padded; 0-d bool feasible).
# ---------------------------------------------------------------------------


def _fill_tightly(caps_pos, order, count, emax):
    n = caps_pos.shape[0]
    _check_cumsum_bound(n, emax)
    count = _as_count(count, caps_pos)
    caps = torch.minimum(caps_pos, count)  # bounds the cumsum at n * count
    cum = _cumsum32(caps)
    ok = cum[-1] >= count
    j = torch.arange(emax, dtype=torch.int32, device=caps_pos.device)
    pos = torch.clamp(torch.searchsorted(cum, j, right=True), 0, n - 1)
    nodes = torch.where(j < count, order[pos], -1)
    return nodes.to(torch.int32), ok


def _fill_distribute_evenly(caps_pos, order, count, emax):
    n = caps_pos.shape[0]
    _check_cumsum_bound(n, emax)
    dev = caps_pos.device
    count = _as_count(count, caps_pos)
    caps = torch.minimum(caps_pos, count)
    ok = caps.sum() >= count
    # m[r] = nodes still open in round r = #{i: cap_i > r}.
    sorted_caps = torch.sort(caps).values
    r = torch.arange(emax, dtype=torch.int32, device=dev)
    m = (n - torch.searchsorted(sorted_caps, r, right=True)).to(torch.int32)
    rounds = _cumsum32(m)  # slots placed through round r
    j = r
    r_j = torch.clamp(torch.searchsorted(rounds, j, right=True), 0, emax - 1)
    prev = torch.where(
        r_j > 0, rounds[torch.clamp(r_j - 1, min=0)], torch.zeros_like(j)
    )
    k_j = j - prev  # index within round r_j, in priority order
    open_ = caps[None, :] > r_j[:, None].to(torch.int32)  # [Emax, N]
    rank = torch.cumsum(open_, dim=1, dtype=torch.int32)
    hit = open_ & (rank == (k_j + 1)[:, None])
    pos_j = torch.argmax(hit.to(torch.int32), dim=1)  # first hit
    nodes = torch.where(j < count, order[pos_j], -1)
    return nodes.to(torch.int32), ok


def _fill_minimal_fragmentation(caps_pos, order, count, emax):
    n = caps_pos.shape[0]
    _check_cumsum_bound(n, emax)
    dev = caps_pos.device
    count = _as_count(count, caps_pos)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    cap_ok = caps_pos > 0
    caps_c = torch.minimum(caps_pos, count)
    ok = caps_c.sum() >= count

    # Branch A: some node fits the whole gang -> smallest such (cap, pos).
    mask_a = cap_ok & (caps_pos >= count)
    exists_a = mask_a.any()
    pos_a = _masked_argmin_pos(mask_a, caps_pos, pos, n)

    # Branch B: consume (cap desc, pos asc) while the running total <= count.
    desc = lexsort_torch((pos, -caps_c, (~cap_ok).to(torch.int32)))
    caps_desc = torch.where(cap_ok[desc], caps_c[desc], 0)
    cum = _cumsum32(caps_desc)
    consumed = cum <= count
    total = torch.where(consumed, caps_desc, 0).sum()
    remainder = count - total
    consumed_pos = torch.zeros(n, dtype=torch.bool, device=dev)
    consumed_pos[desc] = consumed
    mask_fin = cap_ok & ~consumed_pos & (caps_pos >= remainder)
    pos_f = _masked_argmin_pos(mask_fin, caps_pos, pos, n)

    j = torch.arange(emax, dtype=torch.int32, device=dev)
    idx = torch.clamp(torch.searchsorted(cum, j, right=True), 0, n - 1)
    pos_b = torch.where(j < total, desc[idx].to(torch.int32), pos_f)

    chosen_pos = torch.where(exists_a, pos_a, pos_b)
    nodes = torch.where(j < count, order[chosen_pos.long()], -1)
    return nodes.to(torch.int32), ok


_FILLS = {
    "tightly-pack": _fill_tightly,
    "distribute-evenly": _fill_distribute_evenly,
    "minimal-fragmentation": _fill_minimal_fragmentation,
}


# ---------------------------------------------------------------------------
# SparkBinPack: driver selection + executor distribution.
# ---------------------------------------------------------------------------


def pack_one_app(
    avail: torch.Tensor,  # [N,3] i32 — current availability
    exec_elig: torch.Tensor,  # [N] bool
    driver_elig: torch.Tensor,  # [N] bool
    d_order: torch.Tensor,  # [N] i32 driver priority order
    d_rank: torch.Tensor,  # [N] i32 rank of each node in d_order
    e_order: torch.Tensor,  # [N] i32 executor priority order
    driver_req: torch.Tensor,  # [3] i32
    exec_req: torch.Tensor,  # [3] i32
    count,  # i32 (int or 0-d tensor)
    fill_fn,
    emax: int,
):
    """Core gang pack against a given availability (binpack.go:60-87):
    driver selection via the feasibility identity + one executor fill with
    the chosen driver tentatively reserved. Shared by `spark_bin_pack`, the
    single-AZ pack and the batched engine (ops/batched.py), so their
    semantics cannot diverge.

    Returns (driver_node 0-d i32, driver_one_hot [N,1] bool,
    exec_nodes [Emax] i32, ok 0-d bool)."""
    n = avail.shape[0]
    count = _as_count(count, avail)
    zero = torch.zeros_like(avail)
    cap_base = torch.where(exec_elig, node_capacities(avail, zero, exec_req), 0)
    cap_base_c = torch.minimum(cap_base, count)
    total_base = cap_base_c.sum()

    # Capacity of node i for executors if the driver were reserved on i.
    driver_reserved = driver_req[None, :].expand_as(avail)
    cap_with_driver = torch.where(
        exec_elig, node_capacities(avail, driver_reserved, exec_req), 0
    )
    total_if_driver = (
        total_base - cap_base_c + torch.minimum(cap_with_driver, count)
    )

    driver_fit = driver_elig & fits(avail, driver_req)
    feasible = driver_fit & (total_if_driver >= count)
    best_rank = torch.where(
        feasible, d_rank, torch.full_like(d_rank, INT32_INF)
    ).min()
    found = best_rank < INT32_INF
    driver_node = torch.where(
        found, d_order[torch.clamp(best_rank, 0, n - 1).long()], -1
    ).to(torch.int32)

    one_hot = (torch.arange(n, device=avail.device) == driver_node)[:, None]
    reserved = torch.where(one_hot, driver_req[None, :], 0).to(avail.dtype)
    caps = torch.where(exec_elig, node_capacities(avail, reserved, exec_req), 0)
    e_idx = e_order.long()
    exec_nodes, fill_ok = fill_fn(caps[e_idx], e_order, count, emax)
    return driver_node, one_hot, exec_nodes, found & fill_ok


def _eligibility(cluster: ClusterTensors, driver_candidate_mask, domain_mask):
    """(domain, driver-eligible, executor-eligible) node masks
    (sort/nodesorting.go:51-58)."""
    domain = domain_mask & cluster.valid
    driver_elig = domain & driver_candidate_mask
    exec_elig = domain & ~cluster.unschedulable & cluster.ready
    return domain, driver_elig, exec_elig


def spark_bin_pack(
    cluster: ClusterTensors,
    driver_req: torch.Tensor,  # [3] i32
    exec_req: torch.Tensor,  # [3] i32
    count,  # i32 — number of executors
    driver_candidate_mask: torch.Tensor,  # [N] bool (kube-scheduler candidates)
    domain_mask: torch.Tensor,  # [N] bool (instance-group metadata domain)
    *,
    fill: str,
    emax: int,
    num_zones: int,
    zrank: torch.Tensor | None = None,
) -> Packing:
    """Gang-pack one app (binpack/binpack.go:60-87). Driver candidates are
    `domain & driver_candidate_mask` in driver priority order;
    executor-eligible nodes are `domain & schedulable & ready`."""
    fill_fn = _FILLS[fill]
    _domain, driver_elig, exec_elig = _eligibility(
        cluster, driver_candidate_mask, domain_mask
    )
    if zrank is None:
        zrank = zone_ranks(cluster, _domain, num_zones)
    d_order, e_order = priority_orders(cluster, driver_elig, exec_elig, zrank)
    d_rank = _rank_of_position(d_order)
    driver_node, _, exec_nodes, has_cap = pack_one_app(
        cluster.available, exec_elig, driver_elig, d_order, d_rank, e_order,
        driver_req, exec_req, count, fill_fn, emax,
    )
    return Packing(
        driver_node=torch.where(has_cap, driver_node, -1).to(torch.int32),
        executor_nodes=torch.where(has_cap, exec_nodes, -1).to(torch.int32),
        has_capacity=has_cap,
    )


def single_az_orders(
    cluster,
    driver_elig: torch.Tensor,  # [N] bool
    exec_elig: torch.Tensor,  # [N] bool
    zrank: torch.Tensor,  # [num_zones] i32
    num_zones: int,
    available: torch.Tensor | None = None,
):
    """Per-zone priority orders for the single-AZ packers: each eligibility
    vector restricted to one zone and sorted (single_az.go:44-56).
    Returns ([Z,N] driver eligibility, [Z,N] executor eligibility,
    [Z,N] driver orders, [Z,N] driver ranks, [Z,N] executor orders)."""
    zones = torch.arange(num_zones, dtype=torch.int32, device=zrank.device)
    zmask_all = cluster.zone_id[None, :] == zones[:, None]
    d_elig_z = driver_elig[None, :] & zmask_all
    e_elig_z = exec_elig[None, :] & zmask_all
    per_zone = [
        priority_orders(cluster, d, e, zrank, available=available)
        for d, e in zip(d_elig_z, e_elig_z)
    ]
    d_order_z = torch.stack([d for d, _ in per_zone])
    e_order_z = torch.stack([e for _, e in per_zone])
    d_rank_z = torch.stack([_rank_of_position(o) for o in d_order_z])
    return d_elig_z, e_elig_z, d_order_z, d_rank_z, e_order_z


def pack_one_app_single_az(
    zone_id: torch.Tensor,  # [N] i32
    schedulable: torch.Tensor,  # [N,3] i32
    avail: torch.Tensor,  # [N,3] i32 — CURRENT availability
    driver_elig: torch.Tensor,  # [N] bool (domain & candidates & valid)
    exec_elig: torch.Tensor,  # [N] bool
    d_rank_global: torch.Tensor,  # [N] i32 — rank in the FULL driver order
    d_elig_z,  # [Z,N] bool
    e_elig_z,  # [Z,N] bool
    d_order_z,  # [Z,N] i32
    d_rank_z,  # [Z,N] i32
    e_order_z,  # [Z,N] i32
    driver_req: torch.Tensor,  # [3] i32
    exec_req: torch.Tensor,  # [3] i32
    count,  # i32
    fill_fn,
    emax: int,
    num_zones: int,
    include_executors_in_reserved: bool,
):
    """Single-AZ gang pack against a given availability (single_az.go:23-97):
    `pack_one_app` in every zone, keep the feasible zones, pick the best
    zone score (`efficiency.zone_score`), strictly greater, so the earliest
    zone (first appearance in driver priority order) wins ties; a best
    score of exactly 0.0 rejects. Shared by the standalone single-AZ pack
    and the batched engine.

    Returns (driver_node, driver_one_hot [N,1], exec_nodes [Emax], ok)."""
    dev = avail.device
    n = avail.shape[0]
    count = _as_count(count, avail)
    zone = zone_id.long()
    inf = torch.full((num_zones,), INT32_INF, dtype=torch.int32, device=dev)
    # Zone first-appearance rank in driver priority order (single_az.go:58-73).
    zone_first = inf.scatter_reduce(
        0, zone,
        torch.where(driver_elig, d_rank_global, INT32_INF).to(torch.int32),
        reduce="amin",
    )
    # Zones with no executor-eligible nodes are skipped (single_az.go:40-43).
    zone_has_exec = torch.zeros(num_zones, dtype=torch.int32, device=dev)
    zone_has_exec = zone_has_exec.scatter_reduce(
        0, zone, exec_elig.to(torch.int32), reduce="amax"
    ) > 0

    drivers, one_hots, exec_nodes, oks, effs = [], [], [], [], []
    for z in range(num_zones):
        drv, hot, execs, ok = pack_one_app(
            avail, e_elig_z[z], d_elig_z[z], d_order_z[z], d_rank_z[z],
            e_order_z[z], driver_req, exec_req, count, fill_fn, emax,
        )
        placed = torch.zeros(n, dtype=torch.int32, device=dev)
        placed.index_add_(
            0, torch.clamp(execs, min=0).long(), (execs >= 0).to(torch.int32)
        )
        effs.append(zone_score(
            count, hot[:, 0].to(torch.int32), placed, schedulable, avail,
            driver_req, exec_req, include_executors_in_reserved,
        ))
        drivers.append(drv)
        one_hots.append(hot)
        exec_nodes.append(execs)
        oks.append(ok)
    oks = torch.stack(oks)
    effs = torch.stack(effs)
    valid_zone = oks & (zone_first < INT32_INF) & zone_has_exec
    effs = torch.where(valid_zone, effs, -torch.inf)
    best_eff = effs.max()
    # chooseBestResult starts from WorstAvgPackingEfficiency (Max=0.0) and
    # replaces only on strictly greater (single_az.go:84-97).
    any_valid = valid_zone.any() & (best_eff > 0.0)
    tie = valid_zone & (effs == best_eff)
    best_zone = torch.argmin(torch.where(tie, zone_first, inf))
    driver_node = torch.where(any_valid, torch.stack(drivers)[best_zone], -1)
    execs = torch.where(any_valid, torch.stack(exec_nodes)[best_zone], -1)
    one_hot = torch.stack(one_hots)[best_zone] & any_valid
    return (
        driver_node.to(torch.int32), one_hot, execs.to(torch.int32), any_valid
    )


def _single_az_pack(
    cluster, driver_req, exec_req, count, driver_candidate_mask, domain_mask,
    *, fill, emax, num_zones,
) -> Packing:
    """Single-AZ wrapper (binpack/single_az.go:23-97): per-zone SparkBinPack,
    the best feasible zone by average packing efficiency."""
    domain, driver_elig, exec_elig = _eligibility(
        cluster, driver_candidate_mask, domain_mask
    )
    zrank = zone_ranks(cluster, domain, num_zones)
    d_order, _ = priority_order(cluster, driver_elig, zrank, cluster.label_rank_driver)
    zone_orders = single_az_orders(cluster, driver_elig, exec_elig, zrank, num_zones)
    driver_node, _, execs, ok = pack_one_app_single_az(
        cluster.zone_id, cluster.schedulable, cluster.available,
        driver_elig, exec_elig, _rank_of_position(d_order), *zone_orders,
        driver_req, exec_req, count, _FILLS[fill], emax, num_zones,
        include_executors_in_reserved=(fill != "minimal-fragmentation"),
    )
    return Packing(driver_node=driver_node, executor_nodes=execs, has_capacity=ok)


# ---------------------------------------------------------------------------
# Public strategy entry points (internal/extender/binpack.go:39-54 registry).
# ---------------------------------------------------------------------------


def tightly_pack(cluster, driver_req, exec_req, count, driver_mask, domain_mask, *, emax, num_zones):
    return spark_bin_pack(
        cluster, driver_req, exec_req, count, driver_mask, domain_mask,
        fill="tightly-pack", emax=emax, num_zones=num_zones,
    )


def distribute_evenly(cluster, driver_req, exec_req, count, driver_mask, domain_mask, *, emax, num_zones):
    return spark_bin_pack(
        cluster, driver_req, exec_req, count, driver_mask, domain_mask,
        fill="distribute-evenly", emax=emax, num_zones=num_zones,
    )


def minimal_fragmentation(cluster, driver_req, exec_req, count, driver_mask, domain_mask, *, emax, num_zones):
    return spark_bin_pack(
        cluster, driver_req, exec_req, count, driver_mask, domain_mask,
        fill="minimal-fragmentation", emax=emax, num_zones=num_zones,
    )


def single_az_tightly_pack(cluster, driver_req, exec_req, count, driver_mask, domain_mask, *, emax, num_zones):
    return _single_az_pack(
        cluster, driver_req, exec_req, count, driver_mask, domain_mask,
        fill="tightly-pack", emax=emax, num_zones=num_zones,
    )


def single_az_minimal_fragmentation(cluster, driver_req, exec_req, count, driver_mask, domain_mask, *, emax, num_zones):
    return _single_az_pack(
        cluster, driver_req, exec_req, count, driver_mask, domain_mask,
        fill="minimal-fragmentation", emax=emax, num_zones=num_zones,
    )


def az_aware_tightly_pack(cluster, driver_req, exec_req, count, driver_mask, domain_mask, *, emax, num_zones):
    """Single-AZ tightly-pack, falling back to plain tightly-pack
    (binpack/az_aware_pack_tightly.go:27-38)."""
    az = single_az_tightly_pack(
        cluster, driver_req, exec_req, count, driver_mask, domain_mask,
        emax=emax, num_zones=num_zones,
    )
    plain = tightly_pack(
        cluster, driver_req, exec_req, count, driver_mask, domain_mask,
        emax=emax, num_zones=num_zones,
    )
    pick_az = az.has_capacity
    return Packing(
        driver_node=torch.where(pick_az, az.driver_node, plain.driver_node),
        executor_nodes=torch.where(pick_az, az.executor_nodes, plain.executor_nodes),
        has_capacity=pick_az | plain.has_capacity,
    )


# Strategy registry (internal/extender/binpack.go:21-54), keyed by the
# reference's config strings.
BINPACK_FUNCTIONS = {
    "tightly-pack": tightly_pack,
    "distribute-evenly": distribute_evenly,
    "minimal-fragmentation": minimal_fragmentation,
    "single-az-tightly-pack": single_az_tightly_pack,
    "single-az-minimal-fragmentation": single_az_minimal_fragmentation,
    "az-aware-tightly-pack": az_aware_tightly_pack,
}
BINPACK_STRATEGIES = tuple(BINPACK_FUNCTIONS)


# ---------------------------------------------------------------------------
# Preemption search (policy subsystem).
# ---------------------------------------------------------------------------

# The preemption SEARCH is a feasibility probe (the admission after eviction
# re-runs the real strategy), so each strategy maps to its plain inner fill.
PREEMPTION_FILL = {
    "tightly-pack": "tightly-pack",
    "distribute-evenly": "distribute-evenly",
    "minimal-fragmentation": "minimal-fragmentation",
    "single-az-tightly-pack": "tightly-pack",
    "single-az-minimal-fragmentation": "minimal-fragmentation",
    "az-aware-tightly-pack": "tightly-pack",
}


def preemption_batched_fit(
    cluster: ClusterTensors,
    freed_cum: torch.Tensor,  # [C,N,3] i32 — capacity freed by each eviction set
    driver_req: torch.Tensor,  # [3] i32
    exec_req: torch.Tensor,  # [3] i32
    count,  # i32
    driver_candidate_mask: torch.Tensor,  # [N] bool
    domain_mask: torch.Tensor,  # [N] bool
    *,
    fill: str,
    emax: int,
    num_zones: int,
):
    """Masked gang fit for every candidate eviction set. Candidate c's
    availability is `cluster.available + freed_cum[c]`; the priority orders
    depend on availability, so each candidate re-ranks its zones, re-sorts
    both orders and runs `pack_one_app` against its own availability.

    The JAX package vmaps this program over the candidate axis; here it is
    a loop over the C candidates with the same result. C is small (nested
    prefixes of one victim list), and a batched axis would need batched
    zone ranks and lexsorts that nothing else uses.

    Eligibility masks are availability-independent and computed once.
    Returns (ok [C] bool, driver_node [C] i32, exec_nodes [C,Emax] i32).
    With nested candidate sets the first ok index is the minimal eviction
    set."""
    fill_fn = _FILLS[fill]
    n = cluster.available.shape[0]
    _check_cumsum_bound(n, emax)
    domain, driver_elig, exec_elig = _eligibility(
        cluster, driver_candidate_mask, domain_mask
    )
    oks, drivers, execs = [], [], []
    for freed in freed_cum:
        avail = cluster.available + freed
        zrank = zone_ranks(cluster, domain, num_zones, available=avail)
        d_order, e_order = priority_orders(
            cluster, driver_elig, exec_elig, zrank, available=avail
        )
        driver_node, _, exec_nodes, ok = pack_one_app(
            avail, exec_elig, driver_elig, d_order, _rank_of_position(d_order),
            e_order, driver_req, exec_req, count, fill_fn, emax,
        )
        oks.append(ok)
        drivers.append(driver_node)
        execs.append(exec_nodes)
    dev = cluster.available.device
    if not oks:
        return (
            torch.zeros(0, dtype=torch.bool, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev),
            torch.zeros((0, emax), dtype=torch.int32, device=dev),
        )
    return torch.stack(oks), torch.stack(drivers), torch.stack(execs)
