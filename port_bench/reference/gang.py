"""Plain NumPy gang admission: the semantics the program's orders, row
walk and queue kernel must reproduce, written from the scheduler's rules
(k8s-spark-scheduler `internal/sort/nodesorting.go`,
`internal/binpack`, `internal/extender/resource.go`) and frozen here so that
no change to the program moves them.

Nodes are numbered 0..N-1. Resources are int64 [N, 3] (CPU, memory, GPU),
so no sum can wrap. A cluster is a dict of numpy arrays: `available`,
`zone`, `name_rank`, `label_rank_driver`, `label_rank_executor`,
`unschedulable`, `ready`, `valid`.
"""

from __future__ import annotations

import numpy as np

INF = 2**31 - 1
CPU, MEM = 0, 1


def zone_ranks(cluster, domain, available, num_zones):
    """Zones ascending by (total available memory, total CPU) over the
    domain; zones with no domain node last; ties by zone id. Returns the
    rank of each zone."""
    mask = domain & cluster["valid"]
    zone = cluster["zone"]
    mem = np.zeros(num_zones, np.int64)
    cpu = np.zeros(num_zones, np.int64)
    np.add.at(mem, zone[mask], available[mask, MEM])
    np.add.at(cpu, zone[mask], available[mask, CPU])
    present = np.bincount(zone[mask], minlength=num_zones) > 0
    order = np.lexsort((np.arange(num_zones), cpu, mem, ~present))
    rank = np.empty(num_zones, np.int64)
    rank[order] = np.arange(num_zones)
    return rank


def priority_order(cluster, eligible, zrank, label_rank, available):
    """Eligible nodes first; then label rank, zone rank, available memory,
    available CPU and name, all ascending. Returns the node order."""
    elig = eligible & cluster["valid"]
    return np.lexsort((
        cluster["name_rank"], available[:, CPU], available[:, MEM],
        zrank[cluster["zone"]], label_rank, ~elig,
    ))


def rank_of(order):
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    return rank


def orders(cluster, driver_elig, exec_elig, domain, available, num_zones):
    """(exec_elig, driver_elig, driver rank, driver order, executor rank,
    executor order) ranked from `available`."""
    zr = zone_ranks(cluster, domain, available, num_zones)
    d_order = priority_order(cluster, driver_elig, zr,
                             cluster["label_rank_driver"], available)
    e_order = priority_order(cluster, exec_elig, zr,
                             cluster["label_rank_executor"], available)
    return exec_elig, driver_elig, rank_of(d_order), d_order, rank_of(e_order), e_order


def queue_orders(cluster, num_zones):
    """Queue mode: driver and executor eligibility are both valid, ready
    and schedulable nodes, zones ranked over the valid nodes, from the
    queue's starting availability."""
    elig = cluster["valid"] & ~cluster["unschedulable"] & cluster["ready"]
    return orders(cluster, elig, elig, cluster["valid"],
                  cluster["available"], num_zones)


def capacities(available, reserved, request):
    """How many `request`-shaped executors fit on each node: per dimension
    floor((available - reserved) / request), unbounded where the request
    is 0, none where reserved exceeds available; the least dimension."""
    diff = available - reserved
    over = reserved > available
    req = np.asarray(request, np.int64)[None, :]
    per = np.where(req == 0, INF, np.where(over, 0, diff) // np.maximum(req, 1))
    per = np.where(over, 0, per)
    return np.maximum(per.min(axis=1), 0)


def fill_tightly(caps_pos, count):
    """Slots in priority order, each node filled to its capacity."""
    out = []
    for pos in np.flatnonzero(caps_pos > 0):
        take = min(int(caps_pos[pos]), count - len(out))
        out += [int(pos)] * take
        if len(out) == count:
            break
    return out


def fill_distribute_evenly(caps_pos, count):
    """Round r places one executor on every node (in priority order) that
    has room for more than r."""
    out = []
    caps = np.minimum(caps_pos, count)
    r = 0
    while len(out) < count:
        open_ = np.flatnonzero(caps > r)
        if len(open_) == 0:
            break
        out += [int(p) for p in open_[: count - len(out)]]
        r += 1
    return out


FILLS = {"tightly-pack": fill_tightly, "distribute-evenly": fill_distribute_evenly}


def solve_gang(fill, count, avail, dreq, ereq, ords):
    """Driver choice and executor placement of one gang on `avail`.
    Returns (ok, driver node, executor nodes [count])."""
    elig_e, elig_d, drank, d_order, _erank, e_order = ords
    dreq = np.asarray(dreq, np.int64)
    ereq = np.asarray(ereq, np.int64)
    cap_e = np.where(elig_e, capacities(avail, np.zeros_like(avail), ereq), 0)
    cap_wd = np.where(elig_e, capacities(avail, np.broadcast_to(dreq, avail.shape), ereq), 0)
    fit_d = (dreq[None, :] <= avail).all(axis=1)
    ce, cw = np.minimum(cap_e, count), np.minimum(cap_wd, count)
    total_if = ce.sum() - ce + cw
    feasible = elig_d & fit_d & (total_if >= count)
    if not feasible.any():
        return False, -1, []
    drv = int(d_order[int(drank[feasible].min())])
    caps = cap_e.copy()
    caps[drv] = cap_wd[drv]
    pos = FILLS[fill](caps[e_order], count)
    if len(pos) < count:
        return False, -1, []
    return True, drv, [int(e_order[p]) for p in pos]


def walk_rows(fill, avail, ords, rows, emax):
    """The FIFO row walk: rows (driver req, executor req, count, skippable)
    in order on `avail`, debiting each admitted gang; a row that does not
    pack and may not be skipped blocks every later row. Returns one
    (admitted, packed, driver, executors) per row; `avail` is debited in
    place."""
    out = []
    blocked = False
    for dreq, ereq, count, skip in rows:
        ok, drv, execs = solve_gang(fill, int(count), avail, dreq, ereq, ords)
        packed = ok and int(count) <= emax
        admitted = packed and not blocked
        if admitted:
            avail[drv] -= np.asarray(dreq, np.int64)
            np.add.at(avail, np.asarray(execs, np.int64),
                      -np.asarray(ereq, np.int64))
            out.append((True, True, drv, execs))
        else:
            out.append((False, packed, -1, []))
        blocked = blocked or (not packed and not skip)
    return out


def queue_pack(fill, cluster, apps, emax, num_zones):
    """One queue-mode call: orders from the starting availability, then the
    row walk over the queue's apps. `apps` = (driver [B,3], executor [B,3],
    count [B], skippable [B]). Returns (rows as walk_rows gives them,
    availability after)."""
    ords = queue_orders(cluster, num_zones)
    avail = cluster["available"].astype(np.int64).copy()
    rows = list(zip(*apps))
    return walk_rows(fill, avail, ords, rows, emax), avail
