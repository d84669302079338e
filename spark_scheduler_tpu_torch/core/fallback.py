"""GreedyFallbackSolver — degraded-mode serving on the host.

When every device slot is quarantined (or the single card failed
mid-window) and `server.degraded-mode` is "greedy", the solver routes the
window through this class instead of the row walk: each request packs via
the host greedy oracle (core/greedy.py) with the SAME segment semantics as
the row-walk kernel — availability rewinds to the threaded
committed base per segment, priority orders compute once from the
segment-start availability, hypothetical earlier-driver rows subtract
only within their segment, the commit row's admission persists into the
base, and a non-skippable miss blocks the rest of the segment.

O(nodes) Python per row instead of one device scan — decisions/s drops,
correctness doesn't (the oracle is slot-for-slot the kernels' semantics, zone scores
included: tests/test_torch_faults.py holds it to the port's row walk and
to the JAX package's greedy over every strategy).
"""

from __future__ import annotations

import numpy as np

from spark_scheduler_tpu_torch.core.greedy import (
    greedy_pack,
    greedy_priority_order,
)
from spark_scheduler_tpu_torch.models.cluster import pad_bucket
from spark_scheduler_tpu_torch.ops.efficiency import avg_packing_efficiency_np


def _slots(ex, width: int) -> np.ndarray:
    """A packing's executor nodes as the row walk's decision blob holds
    them: `width` (the dispatch's emax) slots, -1 past the gang. The
    efficiency means sum over these slots in float32, and their rounding
    depends on the slot count: the greedy reports what the kernels
    report."""
    out = np.full(max(width, len(ex)), -1, np.int64)
    out[: len(ex)] = ex
    return out


class GreedyFallbackSolver:
    """Bound to one PlacementSolver for its registry and candidate-mask
    cache; stateless otherwise."""

    def __init__(self, solver):
        self._solver = solver

    # -- one gang -----------------------------------------------------------

    def _orders(self, strategy, host, avail64, cand_mask, dom_mask):
        dom = np.asarray(dom_mask, bool) & np.asarray(host.valid, bool)
        d_elig = dom & np.asarray(cand_mask, bool)
        e_elig = (
            dom
            & ~np.asarray(host.unschedulable, bool)
            & np.asarray(host.ready, bool)
        )
        zone = np.asarray(host.zone_id)
        names = np.asarray(host.name_rank)
        d_order = greedy_priority_order(
            avail64, zone, names, d_elig, domain=dom,
            label_rank=np.asarray(host.label_rank_driver),
        )
        e_order = greedy_priority_order(
            avail64, zone, names, e_elig, domain=dom,
            label_rank=np.asarray(host.label_rank_executor),
        )
        return d_order, e_order

    def _pack_once(
        self, strategy, host, avail64, d_order, e_order, drv64, exc64, count
    ):
        """One pack against the CURRENT availability with PRECOMPUTED
        orders (the kernel computes orders once per segment and reuses
        them while availability mutates)."""
        return greedy_pack(
            strategy, avail64, np.asarray(host.schedulable).astype(np.int64),
            np.asarray(host.zone_id), drv64, exc64, count, d_order, e_order,
        )

    def pack(
        self, strategy, host, driver_resources, executor_resources,
        executor_count, driver_mask, domain_mask,
    ):
        """Solo-pack fallback: HostPacking from host-side greedy (the
        degraded twin of PlacementSolver.pack)."""
        from spark_scheduler_tpu_torch.core.solver import HostPacking

        avail64 = np.asarray(host.available).astype(np.int64)
        drv64 = driver_resources.as_array().astype(np.int64)
        exc64 = executor_resources.as_array().astype(np.int64)
        d_order, e_order = self._orders(
            strategy, host, avail64, driver_mask, domain_mask
        )
        d, ex, ok = self._pack_once(
            strategy, host, avail64, d_order, e_order, drv64, exc64,
            executor_count,
        )
        eff = avg_packing_efficiency_np(
            np.asarray(host.schedulable),
            avail64,
            d,
            _slots(ex, pad_bucket(max(executor_count, 1), 8)),
            drv64,
            exc64,
        )
        registry = self._solver.registry
        return HostPacking(
            driver_node=registry.name_of(d) if d >= 0 else None,
            executor_nodes=[registry.name_of(i) for i in ex],
            has_capacity=ok,
            efficiency_max=float(eff.max),
            efficiency_cpu=float(eff.cpu),
            efficiency_memory=float(eff.memory),
            efficiency_gpu=float(eff.gpu),
        )

    # -- one serving window -------------------------------------------------

    def window_decisions(self, strategy, host, base_avail, requests, emax=None):
        """The degraded twin of pack_window_dispatch+fetch: decisions for
        a window of WindowRequests against `base_avail` (the committed
        base the device would have seen — host truth minus un-applied
        prior windows). `emax` is the executor slots a row of the
        dispatch holds (default: the bucket of these requests' largest
        gang, as a dispatch of them alone has). Returns (decisions,
        placements[N,3] int64)."""
        if emax is None:
            emax = pad_bucket(
                max([int(r[2]) for req in requests for r in req.rows] + [1]), 8
            )
        from spark_scheduler_tpu_torch.core.solver import (
            HostPacking,
            WindowDecision,
        )

        solver = self._solver
        registry = solver.registry
        valid = np.asarray(host.valid, bool)
        sched = np.asarray(host.schedulable)
        base = np.asarray(base_avail).astype(np.int64).copy()
        placements = np.zeros_like(base)
        decisions: list[WindowDecision] = []
        for req in requests:
            cand = solver.candidate_mask(host, req.driver_candidate_names)
            if req.domain_mask is not None:
                dom = np.asarray(req.domain_mask) & valid
            elif req.domain_node_names is not None:
                dom = (
                    solver.candidate_mask(host, req.domain_node_names) & valid
                )
            else:
                dom = valid
            seg_avail = base.copy()
            d_order, e_order = self._orders(
                strategy, host, seg_avail, cand, dom
            )
            blocked = False
            earlier_blocked = False
            last = len(req.rows) - 1
            real_admitted = False
            real_d, real_ex = -1, []
            real_packed = False
            eff = None
            drv64_real = exc64_real = None
            for j, row in enumerate(req.rows):
                drv64 = row[0].as_array().astype(np.int64)
                exc64 = row[1].as_array().astype(np.int64)
                count, skip = int(row[2]), bool(row[3])
                d, ex, packed = self._pack_once(
                    strategy, host, seg_avail, d_order, e_order,
                    drv64, exc64, count,
                )
                admitted = packed and not blocked
                if j == last:
                    real_admitted = admitted
                    real_packed = packed
                    if admitted:
                        real_d, real_ex = d, ex
                        drv64_real, exc64_real = drv64, exc64
                        eff = avg_packing_efficiency_np(
                            sched, seg_avail, d, _slots(ex, emax),
                            drv64, exc64,
                        )
                    break
                if admitted:
                    seg_avail[d] -= drv64
                    for n in ex:
                        seg_avail[n] -= exc64
                if not packed and not skip:
                    blocked = True
                    earlier_blocked = True
            if real_admitted:
                base[real_d] -= drv64_real
                placements[real_d] += drv64_real
                for n in real_ex:
                    base[n] -= exc64_real
                    placements[n] += exc64_real
            decisions.append(
                WindowDecision(
                    packing=HostPacking(
                        driver_node=(
                            registry.name_of(real_d) if real_d >= 0 else None
                        ),
                        executor_nodes=[
                            registry.name_of(n) for n in real_ex
                        ],
                        has_capacity=real_packed,
                        efficiency_max=float(eff.max) if eff else 0.0,
                        efficiency_cpu=float(eff.cpu) if eff else 0.0,
                        efficiency_memory=float(eff.memory) if eff else 0.0,
                        efficiency_gpu=float(eff.gpu) if eff else 0.0,
                    ),
                    admitted=real_admitted,
                    earlier_blocked=earlier_blocked,
                )
            )
        return decisions, placements
