"""Segmented serving windows: the port of spark_scheduler_tpu/ops/pallas_window.py.

`core/solver.pack_window` expresses a serving window as SEGMENTS: each
/predicates request is its FIFO-earlier hypothetical rows followed by its
own committing row. Availability rewinds to the committed base between
segments, and the node priority orders are re-sorted per segment from the
segment-start availability (the sort at resource.go:299).

The work splits as in the JAX package:

  - PyTorch, per segment: the eligibility masks and the priority sorts from
    the committed base (`_segment_orders`);
  - the row walk, per segment: hypothetical earlier drivers + the committing
    row, availability carried from row to row. On the card this is the
    hand-written CUDA kernel csrc/window_kernel.cu (one launch of one
    thread-block cluster per live segment, which also subtracts the
    committing row from the base; `ops/launch.kernel_layout` picks where
    its node state lives); on the CPU it is `window_pack_reference`, its
    plain PyTorch version.

`window_pack` returns (meta [S,R,4] i32, execs [S,R,emax] i32,
base_after [N,3] i32); meta rows are (driver_node, admitted, packed, 0) in
node indices, the contract of `window_pack_pallas`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from spark_scheduler_tpu_torch.models.cluster import (
    ClusterTensors,
    check_cluster,
)
from spark_scheduler_tpu_torch.ops.gang import (
    FILL_CODES,
    PALLAS_FILLS,
    PALLAS_SINGLE_AZ,
    strategy_params,
    walk_rows,
)
from spark_scheduler_tpu_torch.ops.launch import (
    KernelLibrary,
    count_launch,
    gang_scratch_words,
    kernel_layout,
)
from spark_scheduler_tpu_torch.ops.packing import (
    _check_cumsum_bound,
    _rank_of_position,
)
from spark_scheduler_tpu_torch.ops.sorting import priority_orders, zone_ranks


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class SegmentedWindow(NamedTuple):
    """A serving window re-shaped segment-major (host numpy arrays).

    S segments (one per /predicates request), each padded to R rows; row
    [s, r] is the r-th FIFO row of request s (its pending earlier drivers,
    then — at index row_count[s]-1 — the request's own application).
    Padding rows carry valid=False."""

    driver_req: np.ndarray  # [S, R, 3] i32
    exec_req: np.ndarray  # [S, R, 3] i32
    exec_count: np.ndarray  # [S, R] i32
    valid: np.ndarray  # [S, R] bool
    skippable: np.ndarray  # [S, R] bool
    row_count: np.ndarray  # [S] i32 — real rows per segment
    driver_cand: np.ndarray  # [S, N] bool — the request's kube candidates
    domain: np.ndarray  # [S, N] bool — the request's affinity domain


def segmented_window_from_flat(
    drv_arr,  # [B, 3] int — flat rows, segment-major
    exc_arr,  # [B, 3] int
    counts,  # [B] int
    skip_arr,  # [B] bool
    row_counts,  # [S] int — rows per segment (sum == B)
    cand_masks,  # list/array of [N] bool — per segment
    domain_masks,  # list/array of [N] bool — per segment
    *,
    pad_segments: int,
    pad_rows: int,
):
    """Scatter flat segment-major row arrays into the padded [S, R] shape.
    Returns (SegmentedWindow, seg_idx, row_idx) — the flat->[S, R] index
    map the fetch side uses to flatten the decision blob."""
    s = len(row_counts)
    rc = np.asarray(row_counts, np.int64)
    seg_idx = np.repeat(np.arange(s, dtype=np.int64), rc)
    row_idx = np.concatenate(
        [np.arange(k, dtype=np.int64) for k in rc]
    ) if s else np.zeros(0, np.int64)
    n = len(cand_masks[0])
    dreq = np.zeros((pad_segments, pad_rows, 3), np.int32)
    ereq = np.zeros((pad_segments, pad_rows, 3), np.int32)
    cnt = np.zeros((pad_segments, pad_rows), np.int32)
    valid = np.zeros((pad_segments, pad_rows), bool)
    skip = np.zeros((pad_segments, pad_rows), bool)
    row_count = np.zeros(pad_segments, np.int32)
    cand = np.zeros((pad_segments, n), bool)
    dom = np.zeros((pad_segments, n), bool)
    dreq[seg_idx, row_idx] = drv_arr
    ereq[seg_idx, row_idx] = exc_arr
    cnt[seg_idx, row_idx] = counts
    valid[seg_idx, row_idx] = True
    skip[seg_idx, row_idx] = skip_arr
    row_count[:s] = rc
    cand[:s] = np.stack(cand_masks)
    dom[:s] = np.stack(domain_masks)
    win = SegmentedWindow(
        driver_req=dreq, exec_req=ereq, exec_count=cnt, valid=valid,
        skippable=skip, row_count=row_count, driver_cand=cand, domain=dom,
    )
    return win, seg_idx, row_idx


def make_segmented_window(
    requests_rows,  # list of list[(driver_req[3], exec_req[3], count, skip)]
    cand_masks,  # list of [N] bool — per request
    domain_masks,  # list of [N] bool — per request
    *,
    row_bucket: int = 16,
    pad_segments: int | None = None,
    pad_rows: int | None = None,
) -> SegmentedWindow:
    """List-of-rows front-end over `segmented_window_from_flat` (tests,
    smoke). Padding segments have row_count 0 and are skipped."""
    s = len(requests_rows)
    r = 1
    for rws in requests_rows:
        r = max(r, len(rws))
    r = pad_rows if pad_rows is not None else _round_up(r, row_bucket)
    s_pad = pad_segments if pad_segments is not None else s
    rc = [len(rws) for rws in requests_rows]
    flat = [row for rws in requests_rows for row in rws]
    win, _, _ = segmented_window_from_flat(
        np.asarray([row[0] for row in flat], np.int32).reshape(-1, 3),
        np.asarray([row[1] for row in flat], np.int32).reshape(-1, 3),
        np.asarray([row[2] for row in flat], np.int32),
        np.asarray([bool(row[3]) for row in flat]),
        rc,
        cand_masks,
        domain_masks,
        pad_segments=s_pad,
        pad_rows=r,
    )
    return win


def _check_fill(fill: str, zone_base=None) -> None:
    if fill not in PALLAS_FILLS and fill not in PALLAS_SINGLE_AZ:
        raise ValueError(
            f"window path supports {PALLAS_FILLS + tuple(PALLAS_SINGLE_AZ)}, "
            f"got {fill!r}"
        )
    if zone_base is not None and fill in PALLAS_SINGLE_AZ:
        raise ValueError(
            "zone_base offsets are only sound for plain fills; "
            f"got single-AZ strategy {fill!r}"
        )


def _segment_orders(
    cluster: ClusterTensors, base, cand, domain, num_zones, zone_base=None
):
    """Per-segment eligibility + priority orders from the committed base
    (ops/batched.py masked mode, resource.go:299). Returns
    (elig_e, elig_d, drank, d_order, erank, e_order), ranks and orders
    int32 permutations of 0..N-1. `zone_base` (a pruned window over a
    gathered sub-cluster): the excluded rows' per-zone sums, so the zone
    ranks are the full cluster's (ops/sorting.zone_ranks)."""
    dom = domain & cluster.valid
    driver_elig = dom & cand
    exec_elig = dom & ~cluster.unschedulable & cluster.ready
    zrank = zone_ranks(
        cluster, dom, num_zones, available=base, zone_base=zone_base
    )
    d_order, e_order = priority_orders(
        cluster, driver_elig, exec_elig, zrank, available=base
    )
    return (
        exec_elig, driver_elig,
        _rank_of_position(d_order), d_order,
        _rank_of_position(e_order), e_order,
    )


def _commit(base, dreq, ereq, driver: int, execs: list) -> None:
    """Subtract one admitted request row's placement from the base."""
    dev = base.device
    if driver >= 0:
        base[driver] -= torch.as_tensor(dreq, dtype=torch.int32, device=dev)
    nodes = [x for x in execs if x >= 0]
    if nodes:
        idx = torch.tensor(nodes, dtype=torch.long, device=dev)
        e = torch.as_tensor(ereq, dtype=torch.int32, device=dev)
        base.index_add_(0, idx, -e.expand(len(nodes), 3).contiguous())


def window_pack_reference(
    cluster: ClusterTensors,
    win: SegmentedWindow,
    *,
    fill: str,
    emax: int,
    num_zones: int,
    zone_base: tuple | None = None,
):
    """The plain PyTorch version of `window_pack`: the same sorts, then the
    row walk as a Python loop over rows (`ops/gang.walk_rows`, one
    `gang_solve` per gang). Runs on whatever device `cluster` lives on."""
    _check_fill(fill, zone_base)
    n = cluster.num_nodes
    _check_cumsum_bound(n, emax)
    dev = cluster.device
    s_pad, r_pad = win.exec_count.shape
    meta = np.zeros((s_pad, r_pad, 4), np.int32)
    execs = np.full((s_pad, r_pad, emax), -1, np.int32)
    base = cluster.available.clone()
    cand = torch.as_tensor(win.driver_cand, device=dev)
    dom = torch.as_tensor(win.domain, device=dev)
    for s in range(s_pad):
        rc = int(win.row_count[s])
        if rc == 0:  # padding segment: no sorts, no rows
            continue
        elig_e, elig_d, drank, d_order, erank, e_order = _segment_orders(
            cluster, base, cand[s], dom[s], num_zones, zone_base
        )
        meta[s], execs[s] = walk_rows(
            fill, num_zones=num_zones, emax=emax, cluster=cluster,
            avail=base.clone(),
            orders=(elig_e, elig_d, drank, d_order, erank, e_order),
            driver_req=win.driver_req[s], exec_req=win.exec_req[s],
            exec_count=win.exec_count[s], valid=win.valid[s],
            skippable=win.skippable[s],
        )
        ci = rc - 1
        if meta[s, ci, 1]:
            _commit(
                base, win.driver_req[s, ci], win.exec_req[s, ci],
                int(meta[s, ci, 0]), list(execs[s, ci]),
            )
    return (
        torch.tensor(meta, device=dev),
        torch.tensor(execs, device=dev),
        base,
    )


_ROW_WALK = KernelLibrary("window_kernel", "window_kernel", {
    "window_row_walk": (
        [ctypes.c_int]  # device index: the entry point sets it first
        + [ctypes.c_void_p] * 5  # dreq, ereq, cnt, valid, skip (segment slices)
        + [ctypes.c_int] * 2  # rows, row_count
        + [ctypes.c_void_p]  # base [N,3] (read, then commit row subtracted)
        # elig_e, elig_d, drank, d_order, erank, e_order, zone, sched
        + [ctypes.c_void_p] * 8
        # n, emax, num_zones, fill, single_az, az_fallback, include_exec
        + [ctypes.c_int] * 7
        + [ctypes.c_void_p] * 3  # meta, execs, scratch
        + [ctypes.c_int] * 2  # slice, smem_state
        + [ctypes.c_void_p]  # stream
    ),
    # device index, smem_state, lanes, slice, out[4]
    "window_kernel_info": [ctypes.c_int] * 4 + [ctypes.c_void_p],
})


def window_kernel_info(n: int, fill: str, *, state: str | None = None,
                       device=None) -> dict:
    """What a card (`device`, default the current one) reports for the row
    walk's instantiation for `n` nodes under `fill`, in its default or the
    forced node-state place (`KernelLibrary.info`)."""
    lay = kernel_layout(n, fill, team="cluster", state=state)
    return _ROW_WALK.info(device, int(lay.state == "smem"),
                          int(lay.zone_lanes), lay.slice)


def window_pack(
    cluster: ClusterTensors,
    win: SegmentedWindow,
    *,
    fill: str,
    emax: int,
    num_zones: int,
    state: str | None = None,
    zone_base: tuple | None = None,
):
    """Serve a segmented window. CUDA tensors: per live segment, the sorts
    in PyTorch, then one launch of the CUDA row-walk kernel on one
    thread-block cluster (which also subtracts the committing row from the
    base) — no host synchronisation inside the segment loop. CPU tensors:
    `window_pack_reference`. Any other device raises. The launch shape is
    `ops/launch.kernel_layout(n, fill, team="cluster")`; `state` forces the
    node-state place (tests drive the global-state layout at a small n). A
    single-AZ strategy runs the zone-parallel instantiation (counted in
    `window_pack.zone_parallel_launches`).

    `zone_base` = (mem_hi, mem_lo, cpu_hi, cpu_lo) int32 and `present` bool
    [num_zones] tensors on the cluster's device: the per-zone sums of the
    rows a pruned window left out of its gathered sub-cluster
    (core/prune.py). The zone ranks then come out as the full cluster's;
    the kernel itself computes no zone sum for a plain fill, so only its
    orders change. Plain fills only."""
    _check_fill(fill, zone_base)
    check_cluster(cluster)
    dev = cluster.device
    if zone_base is not None:
        want = (torch.int32,) * 4 + (torch.bool,)
        if len(zone_base) != 5 or any(
            t.device != dev or tuple(t.shape) != (num_zones,) or t.dtype != d
            for t, d in zip(zone_base, want)
        ):
            raise ValueError(
                f"zone_base must be four int32 limbs and a bool present "
                f"mask, each [{num_zones}] on {dev}"
            )
    if dev.type == "cpu":
        return window_pack_reference(
            cluster, win, fill=fill, emax=emax, num_zones=num_zones,
            zone_base=zone_base,
        )
    if dev.type != "cuda":
        raise ValueError(f"window_pack runs on cuda or cpu, got {dev}")
    n = cluster.num_nodes
    _check_cumsum_bound(n, emax)
    s_pad, r_pad = win.exec_count.shape
    if win.driver_cand.shape != (s_pad, n) or win.domain.shape != (s_pad, n):
        raise ValueError("window masks must be [S, N] over the cluster's N")
    inner, single_az, az_fallback, include_exec = strategy_params(fill)
    layout = kernel_layout(n, fill, team="cluster", state=state)

    def up(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    dreq = up(win.driver_req, torch.int32)
    ereq = up(win.exec_req, torch.int32)
    cnt = up(win.exec_count, torch.int32)
    valid = up(win.valid, torch.bool)
    skip = up(win.skippable, torch.bool)
    cand = up(win.driver_cand, torch.bool)
    dom = up(win.domain, torch.bool)
    base = cluster.available.clone()
    zone = cluster.zone_id.contiguous()
    sched = cluster.schedulable.contiguous()
    meta = torch.empty((s_pad, r_pad, 4), dtype=torch.int32, device=dev)
    execs = torch.empty((s_pad, r_pad, emax), dtype=torch.int32, device=dev)
    scratch = torch.empty(
        gang_scratch_words(layout, 1, emax, num_zones), dtype=torch.int32,
        device=dev,
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    dead = np.flatnonzero(np.asarray(win.row_count) == 0)
    for s in range(s_pad):
        rc = int(win.row_count[s])
        if rc == 0:
            continue
        elig_e, elig_d, drank, d_order, erank, e_order = _segment_orders(
            cluster, base, cand[s], dom[s], num_zones, zone_base
        )
        _ROW_WALK.call(
            "window_row_walk", "window row-walk kernel launch",
            dev.index, dreq[s].data_ptr(), ereq[s].data_ptr(), cnt[s].data_ptr(),
            valid[s].data_ptr(), skip[s].data_ptr(),
            r_pad, rc,
            base.data_ptr(),
            elig_e.data_ptr(), elig_d.data_ptr(),
            drank.data_ptr(), d_order.data_ptr(),
            erank.data_ptr(), e_order.data_ptr(),
            zone.data_ptr(), sched.data_ptr(),
            n, emax, num_zones, FILL_CODES[inner], int(single_az),
            int(az_fallback), int(include_exec),
            meta[s].data_ptr(), execs[s].data_ptr(), scratch.data_ptr(),
            layout.slice, int(layout.state == "smem"),
            stream,
        )
        count_launch(window_pack, single_az)
    if dead.size:
        idx = torch.as_tensor(dead, device=dev)
        meta.index_fill_(0, idx, 0)
        execs.index_fill_(0, idx, -1)
    return meta, execs, base


window_pack.launches = 0
# Row-walk launches that ran the zone-parallel (single-AZ) instantiation.
window_pack.zone_parallel_launches = 0
