"""Plain NumPy single-AZ gang admission (`single-az-tightly-pack`): the
semantics the program's queue path must reproduce for that strategy,
written from the scheduler's rules (k8s-spark-scheduler
`internal/extender/binpack.go`, which registers the strategy;
`binpack/single_az.go`, the wrapper; `binpack/efficiency.go`, the score)
on top of the plain tightly-pack of `gang.py`, and frozen here so that no
change to the program moves them.

For each gang, in FIFO order on the availability the earlier gangs of the
window left:

- every zone is tried on its own: driver and executor eligibility are cut
  to the zone's nodes, the driver is picked as `gang.solve_gang` picks it
  (the first node in driver priority order that fits it and leaves room
  for every executor), and the executors are packed tightly over the
  zone's nodes in executor priority order;
- a zone counts when a driver was found there and the zone holds a
  driver-eligible node and an executor-eligible node;
- a counted zone's packing is scored by its average packing efficiency:
  per node, its largest dimension of (reserved + newly reserved) /
  schedulable, the GPU dimension only on nodes with schedulable GPUs,
  averaged over the packing's entries (the driver and one per executor);
- the strictly greatest score wins; between equal scores the zone whose
  first driver-eligible node comes first in driver priority order wins;
  a best score that is not above 0 rejects the gang. No zone, no
  admission: a gang that only fits across zones is rejected.

Precision, a departure from upstream, which scores in float64: each
node's efficiency is a float32 division of the exact integer amounts,
its term is that times the node's entry count, rounded to float32; the
terms are summed in float64 and rounded once to float32, and the mean is
a float32 division by the entry count. That is the contract the port
documents for its zone score, and it is exact enough to be independent
of summation order, so the cell compares decisions and availability
exactly, with no tolerance. The single-AZ driver also compares each
packed row's zone score with the program's, to a relative 1e-5: float16
arithmetic misses by up to 2^-11 of a score, float32 by 2^-24.

Clusters and apps are as in `gang.py`, with one more cluster field,
`schedulable` (int64 [N, 3]).
"""

from __future__ import annotations

import numpy as np

from port_bench.reference.gang import INF, queue_orders, rank_of, solve_gang

FILL = "single-az-tightly-pack"
GPU = 2


def zone_views(cluster, ords, num_zones):
    """Per zone: its nodes, and the orders cut to them (indices into the
    zone's nodes, relative priority kept), so that a zone is packed as a
    cluster of its own; and the zone's two facts: the smallest driver rank
    among its driver-eligible nodes (INF where it has none), and whether it
    holds an executor-eligible node."""
    elig_e, elig_d, drank, d_order, _erank, e_order = ords
    local = np.full(len(cluster["zone"]), -1, np.int64)
    views = []
    for z in range(num_zones):
        nodes = np.flatnonzero(cluster["zone"] == z)
        local[:] = -1
        local[nodes] = np.arange(len(nodes))
        d_o = local[d_order][local[d_order] >= 0]
        e_o = local[e_order][local[e_order] >= 0]
        z_ords = (elig_e[nodes], elig_d[nodes], rank_of(d_o), d_o,
                  rank_of(e_o), e_o)
        ranks = drank[nodes][elig_d[nodes]]
        first = int(ranks.min()) if len(ranks) else INF
        views.append((nodes, z_ords, first, bool(elig_e[nodes].any())))
    return views


def zone_score(sched, avail, drv, execs, dreq, ereq) -> np.float32:
    """The average packing efficiency of one zone's tentative packing, in
    the float32 contract of the module docstring."""
    entries = np.asarray([drv, *execs], np.int64)
    nodes, per_node = np.unique(entries, return_counts=True)
    new = np.zeros((len(nodes), 3), np.int64)
    for i, node in enumerate(nodes):
        executors = int(per_node[i]) - int(node == drv)
        new[i] = executors * np.asarray(ereq, np.int64)
        if node == drv:
            new[i] += np.asarray(dreq, np.int64)
    s = sched[nodes]
    reserved = s - avail[nodes] + new
    eff = reserved.astype(np.float32) / np.where(s == 0, 1, s).astype(np.float32)
    node_max = np.where(s[:, GPU] != 0, eff.max(axis=1), eff[:, :GPU].max(axis=1))
    terms = (node_max * per_node.astype(np.float32)).astype(np.float32)
    total = np.float32(terms.astype(np.float64).sum())
    return np.float32(total / np.float32(len(entries)))


def solve_gang_single_az(count, avail, dreq, ereq, views, sched):
    """(ok, driver node, executor nodes, score) of one gang: the best
    zone's tightly-pack and its score, or a rejection with score 0."""
    best, best_score, best_first = None, np.float32(-1.0), INF
    for nodes, z_ords, first, has_exec in views:
        ok, drv, execs = solve_gang("tightly-pack", count, avail[nodes], dreq,
                                    ereq, z_ords)
        if not (ok and first < INF and has_exec):
            continue
        drv, execs = int(nodes[drv]), [int(nodes[e]) for e in execs]
        score = zone_score(sched, avail, drv, execs, dreq, ereq)
        if score > best_score or (score == best_score and first < best_first):
            best, best_score, best_first = (drv, execs), score, first
    if best is None or not best_score > 0.0:
        return False, -1, [], np.float32(0.0)
    return True, best[0], best[1], best_score


def queue_pack(fill, cluster, apps, emax, num_zones):
    """One queue-mode call, as `gang.queue_pack` is for the plain fills:
    orders from the starting availability, then the FIFO row walk with the
    single-AZ solve; a row that does not pack and may not be skipped blocks
    every later row. Returns (one (admitted, packed, driver, executors,
    zone score) per row, availability after); a row that does not pack
    scores 0."""
    if fill != FILL:
        raise ValueError(f"the single-AZ reference runs {FILL}, not {fill!r}")
    views = zone_views(cluster, queue_orders(cluster, num_zones), num_zones)
    avail = cluster["available"].astype(np.int64).copy()
    out = []
    blocked = False
    for dreq, ereq, count, skip in zip(*apps):
        ok, drv, execs, score = solve_gang_single_az(
            int(count), avail, dreq, ereq, views, cluster["schedulable"])
        packed = ok and int(count) <= emax
        admitted = packed and not blocked
        if admitted:
            avail[drv] -= np.asarray(dreq, np.int64)
            np.add.at(avail, np.asarray(execs, np.int64),
                      -np.asarray(ereq, np.int64))
            out.append((True, True, drv, execs, score))
        else:
            out.append((False, packed, -1, [],
                        score if packed else np.float32(0.0)))
        blocked = blocked or (not packed and not skip)
    return out, avail
