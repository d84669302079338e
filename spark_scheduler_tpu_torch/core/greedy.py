"""Host-side greedy packing — the reference's literal semantics in Python.

The port's copy of the JAX package's greedy oracle: a per-slot
reimplementation of the reference's packing (binpack/pack_tightly.go,
distribute_evenly.go, minimal_fragmentation.go, binpack.go, single_az.go,
az_aware_pack_tightly.go, sort/nodesorting.go) over numpy arrays. Its
consumer is DEGRADED-MODE serving (core/fallback.py): when the card
failed and no pool slot is left, the extender packs on the host through
these functions — the decisions the row walk would have made, O(nodes)
Python instead of one kernel launch.

Two differences from the JAX package's copy, both so that the host
decides exactly as the port's kernels do:
  - a single-AZ zone score is the port's (ops/efficiency.zone_score): each
    node's float32 efficiency times its entry count, rounded to float32,
    summed exactly and rounded once, over float32 entries; the JAX copy
    compares unrounded float64 means;
  - `az-aware-tightly-pack` falls back to plain tightly-pack over every
    zone when no single zone packs (the JAX copy has no entry for it).

Nodes are integer indices; resources are [3] int arrays (same fixed-point
units as the framework).
"""

from __future__ import annotations

import math

import numpy as np

INF = 10**9


def greedy_fits(avail, req) -> bool:
    return bool(np.all(req <= avail))


def greedy_capacity(avail, reserved, req) -> int:
    cap = INF
    for d in range(3):
        if reserved[d] > avail[d]:
            return 0
        if req[d] == 0:
            continue
        cap = min(cap, (avail[d] - reserved[d]) // req[d])
    return max(int(cap), 0)


def greedy_tightly(avail, exec_req, count, order, reserved):
    out = []
    if count == 0:
        return out, True
    for n in order:
        while True:
            reserved[n] = reserved[n] + exec_req
            if np.any(reserved[n] > avail[n]):
                reserved[n] = reserved[n] - exec_req
                break
            out.append(n)
            if len(out) == count:
                return out, True
    return None, False


def greedy_distribute(avail, exec_req, count, order, reserved):
    open_nodes = set(order)
    out = []
    if count == 0:
        return out, True
    while open_nodes:
        for n in order:
            if n not in open_nodes:
                continue
            reserved[n] = reserved[n] + exec_req
            if np.any(reserved[n] > avail[n]):
                open_nodes.discard(n)
                reserved[n] = reserved[n] - exec_req
            else:
                out.append(n)
                if len(out) == count:
                    return out, True
    return None, False


def greedy_minimal_fragmentation(avail, exec_req, count, order, reserved):
    out = []
    if count == 0:
        return out, True
    caps = [
        (n, greedy_capacity(avail[n], reserved.get(n, np.zeros(3, np.int64)), exec_req))
        for n in order
    ]
    caps = [(n, c) for (n, c) in caps if c > 0]
    caps.sort(key=lambda t: t[1])  # stable ascending by capacity
    remaining = count
    while caps:
        fit_all = next((i for i, (_, c) in enumerate(caps) if c >= remaining), None)
        if fit_all is not None:
            out.extend([caps[fit_all][0]] * remaining)
            return out, True
        max_cap = caps[-1][1]
        first_max = next(i for i, (_, c) in enumerate(caps) if c >= max_cap)
        cur = first_max
        while remaining >= max_cap and cur < len(caps):
            out.extend([caps[cur][0]] * max_cap)
            remaining -= max_cap
            cur += 1
        if remaining == 0:
            return out, True
        caps = caps[:first_max] + caps[cur:]
    return None, False


GREEDY_FILLS = {
    "tightly-pack": greedy_tightly,
    "distribute-evenly": greedy_distribute,
    "minimal-fragmentation": greedy_minimal_fragmentation,
}


class _ReservedMap(dict):
    """dict defaulting to a zero resource vector (NodeGroupResources)."""

    def __getitem__(self, k):
        if k not in self:
            dict.__setitem__(self, k, np.zeros(3, np.int64))
        return dict.__getitem__(self, k)


def greedy_spark_bin_pack(
    avail, driver_req, exec_req, count, driver_order, exec_order, fill
):
    """binpack.go:60-87: first driver candidate whose executors still pack."""
    fill_fn = GREEDY_FILLS[fill]
    for d in driver_order:
        if not greedy_fits(avail[d], driver_req):
            continue
        r = _ReservedMap()
        r[d] = driver_req.astype(np.int64).copy()
        nodes, ok = fill_fn(avail, exec_req, count, exec_order, r)
        if ok:
            return d, nodes, True, r
    return -1, [], False, {}


def greedy_priority_order(avail, zone_of, names, eligible, domain=None, label_rank=None):
    """sort/nodesorting.go:84-134: (az priority, mem asc, cpu asc, name),
    then optional stable label-priority re-sort. Zone totals are computed
    over the full metadata `domain` (PotentialNodes sorts the whole domain,
    then filters to eligible, preserving order)."""
    if domain is None:
        domain = eligible
    idxs = [i for i in range(len(names)) if eligible[i]]
    dom = [i for i in range(len(names)) if domain[i]]
    zones = sorted(
        {zone_of[i] for i in dom},
        key=lambda z: (
            sum(int(avail[i][1]) for i in dom if zone_of[i] == z),
            sum(int(avail[i][0]) for i in dom if zone_of[i] == z),
            z,
        ),
    )
    zprio = {z: r for r, z in enumerate(zones)}
    out = sorted(
        idxs,
        key=lambda i: (zprio[zone_of[i]], int(avail[i][1]), int(avail[i][0]), names[i]),
    )
    if label_rank is not None:
        out.sort(key=lambda i: label_rank[i])  # stable
    return out


def greedy_avg_efficiency(
    avail, schedulable, driver, exec_nodes, driver_req, exec_req,
    include_executors_in_reserved=True,
):
    """efficiency.go:107-156 over the packing's entries (duplicates kept),
    computed as the port's kernels compute a single-AZ zone score
    (ops/efficiency.zone_score): per node, the float32 max-dimension
    efficiency with the tentative reservation applied, times the node's
    entry count and rounded to float32; the terms summed exactly, rounded
    once to float32, and divided in float32 by the entry count. Returns a
    numpy float32. `include_executors_in_reserved=False` mirrors
    minimalFragmentation never mutating reservedResources."""
    entries = ([driver] if driver >= 0 else []) + list(exec_nodes)
    if not entries:
        return np.float32(0.0)
    weight: dict = {}
    new_res: dict = {}
    for n in entries:
        weight[n] = weight.get(n, 0) + 1
        new_res.setdefault(n, np.zeros(3, np.int64))
    new_res[driver] = new_res[driver] + driver_req
    if include_executors_in_reserved:
        for n in exec_nodes:
            new_res[n] = new_res[n] + exec_req
    terms = []
    for n, w in weight.items():
        reserved = (schedulable[n] - avail[n]) + new_res[n]
        denom = np.maximum(schedulable[n], 1).astype(np.float32)
        eff = reserved.astype(np.float32) / denom
        gpu_eff = eff[2] if schedulable[n][2] != 0 else np.float32(0.0)
        node_max = max(gpu_eff, eff[0], eff[1])
        terms.append(float(np.float32(node_max * np.float32(w))))
    total = np.float32(math.fsum(terms))
    return np.float32(total / np.float32(len(entries)))


# Single-AZ strategy -> (inner fill, plain fallback over every zone).
SINGLE_AZ_STRATEGIES = {
    "single-az-tightly-pack": ("tightly-pack", False),
    "single-az-minimal-fragmentation": ("minimal-fragmentation", False),
    "az-aware-tightly-pack": ("tightly-pack", True),
}


# --------------------------------------------------------------- strategies


def greedy_single_az_bin_pack(
    avail, sched, zone_of, driver_req, exec_req, count,
    d_order_all, e_order_all, fill,
):
    """single_az.go:23-97: run the inner fill per zone (zones in the
    driver order's first-appearance order), keep the best average
    efficiency; chooseBestResult starts at 0.0 and replaces on strictly
    greater, so zero-efficiency zones are rejected outright."""
    zones_in_order: list = []
    for i in d_order_all:
        if zone_of[i] not in zones_in_order:
            zones_in_order.append(zone_of[i])
    best = None
    for z in zones_in_order:
        d_order = [i for i in d_order_all if zone_of[i] == z]
        e_order = [i for i in e_order_all if zone_of[i] == z]
        if not e_order:
            continue
        d, ex, ok, _ = greedy_spark_bin_pack(
            avail, driver_req, exec_req, count, d_order, e_order, fill
        )
        if not ok:
            continue
        eff = greedy_avg_efficiency(
            avail, sched, d, ex, driver_req, exec_req,
            include_executors_in_reserved=(fill != "minimal-fragmentation"),
        )
        if eff > (best[0] if best is not None else np.float32(0.0)):
            best = (eff, d, ex)
    if best is None:
        return -1, [], False
    return best[1], list(best[2]), True


def greedy_strategy_pack(
    strategy,
    *,
    avail,
    schedulable,
    zone_of,
    names,
    valid,
    unschedulable,
    ready,
    label_rank_driver,
    label_rank_executor,
    cand_mask,
    domain_mask,
    driver_req,
    exec_req,
    count,
):
    """One gang pack under any registered strategy (the 5-way plug board),
    with the kernels' exact eligibility conventions: the domain is
    `domain & valid`; driver candidates additionally need the candidate
    mask; executors need schedulable (not cordoned) + ready. Returns
    (driver_idx, exec_idx_list, ok). All arrays are host numpy."""
    dom = np.asarray(domain_mask, bool) & np.asarray(valid, bool)
    d_elig = dom & np.asarray(cand_mask, bool)
    e_elig = dom & ~np.asarray(unschedulable, bool) & np.asarray(ready, bool)
    avail64 = np.asarray(avail).astype(np.int64)
    drv64 = np.asarray(driver_req).astype(np.int64)
    exc64 = np.asarray(exec_req).astype(np.int64)
    d_order = greedy_priority_order(
        avail64, zone_of, names, d_elig, domain=dom,
        label_rank=label_rank_driver,
    )
    e_order = greedy_priority_order(
        avail64, zone_of, names, e_elig, domain=dom,
        label_rank=label_rank_executor,
    )
    return greedy_pack(
        strategy, avail64, np.asarray(schedulable).astype(np.int64), zone_of,
        drv64, exc64, count, d_order, e_order,
    )


def greedy_pack(
    strategy, avail, sched, zone_of, driver_req, exec_req, count,
    d_order, e_order,
):
    """One gang pack under any of the six strategies with precomputed
    priority orders: (driver_idx, exec_idx_list, ok). A single-AZ strategy
    packs zone by zone; az-aware-tightly-pack then falls back to plain
    tightly-pack over every zone (az_aware_pack_tightly.go:27-38)."""
    if strategy in SINGLE_AZ_STRATEGIES:
        fill, az_fallback = SINGLE_AZ_STRATEGIES[strategy]
        d, ex, ok = greedy_single_az_bin_pack(
            avail, sched, zone_of, driver_req, exec_req, count,
            d_order, e_order, fill,
        )
        if ok or not az_fallback:
            return d, ex, ok
        strategy = fill
    d, ex, ok, _ = greedy_spark_bin_pack(
        avail, driver_req, exec_req, count, d_order, e_order, strategy
    )
    return d, list(ex) if ok else [], ok
