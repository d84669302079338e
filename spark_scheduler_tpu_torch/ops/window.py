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
    committing row from the base; `walk_layout` picks where its node state
    lives); on the CPU it is `window_pack_reference`, its plain PyTorch
    version.

`window_pack` returns (meta [S,R,4] i32, execs [S,R,emax] i32,
base_after [N,3] i32); meta rows are (driver_node, admitted, packed, 0) in
node indices, the contract of `window_pack_pallas`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from spark_scheduler_tpu_torch.faults.errors import cuda_launch_error
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


# The row walk's launch shape (csrc/window_kernel.cu). A cluster of K
# blocks runs one segment; block r owns nodes [r * slice, (r + 1) * slice).
CLUSTER_BLOCKS = 8  # kGsCluster: the largest portable cluster on Hopper
SMEM_PER_BLOCK = 232_448  # shared memory one H100 block may opt into
STATE_WORDS = 8  # int32 words of mutable state per node
WALK_STATIC_SMEM = 400  # static reduction buffers: (32 + 2 x 8 + 2) x 8 B
# The single-AZ strategies run the zone-parallel instantiation
# (csrc/gang_solve.cuh `gs_gang_solve_lanes`): its reductions carry
# ZONE_LANES lanes, one a zone, and its gang slots take one row a lane.
ZONE_LANES = 8  # kGsLanes
# A team's lane buffers, in 8-byte words (gang_solve.cuh kGsLaneWords):
# three rotating accumulators of ZONE_LANES, the zone scores' warp partials
# (ZONE_LANES rows of 33), two int arrays of ZONE_LANES and the best zone
# so far (4 ints).
LANE_WORDS = 3 * ZONE_LANES + ZONE_LANES * 33 + ZONE_LANES + 2
# The cluster team's beside WALK_STATIC_SMEM add two rows of CLUSTER_BLOCKS
# x ZONE_LANES block partials (kGsClusterLaneWords).
WALK_LANE_SMEM = (LANE_WORDS + 2 * CLUSTER_BLOCKS * ZONE_LANES) * 8


class WalkLayout(NamedTuple):
    """Launch shape of the row walk for one node count."""

    k: int  # blocks in the cluster
    slice: int  # nodes per block, ceil(n / k)
    smem_bytes: int  # shared memory per block, static + dynamic
    state: str  # "smem": node state in shared memory; "global": in scratch
    zone_lanes: bool = False  # the zone-parallel (single-AZ) instantiation


def walk_layout(
    n: int, *, state: str | None = None, zone_lanes: bool = False
) -> WalkLayout:
    """The row walk's layout for `n` nodes: the node state in shared memory
    when a block's slice of it (8 words a node) fits beside the static
    buffers, else in global scratch (n above 58,008; above 57,160 for the
    zone-parallel instantiation, `zone_lanes`, whose lane buffers take
    WALK_LANE_SMEM more). Both are the same hand-written kernel. `state`
    forces one layout (tests)."""
    if n < 1:
        raise ValueError(f"walk_layout needs n >= 1, got {n}")
    sl = -(-n // CLUSTER_BLOCKS)
    static = WALK_STATIC_SMEM + (WALK_LANE_SMEM if zone_lanes else 0)
    smem = STATE_WORDS * 4 * sl + static
    fits = smem <= SMEM_PER_BLOCK
    if state is None:
        state = "smem" if fits else "global"
    if state not in ("smem", "global") or (state == "smem" and not fits):
        raise ValueError(f"no {state!r} row-walk layout for n={n}")
    return WalkLayout(
        CLUSTER_BLOCKS, sl, smem if state == "smem" else static, state,
        bool(zone_lanes),
    )


def gang_scratch_words(emax: int, num_zones: int, zone_lanes: bool) -> int:
    """Global words of one block's gang slots and zone facts (gang_solve.cuh
    `gs_extra_words`): two slot buffers and the zone facts, and for the
    zone-parallel instantiation one slot row a lane, min(num_zones,
    ZONE_LANES) rows."""
    lanes = min(num_zones, ZONE_LANES) if zone_lanes else 0
    return (2 + lanes) * emax + 2 * num_zones


def walk_scratch_words(layout: WalkLayout, emax: int, num_zones: int) -> int:
    """Global scratch of one launch: per block, the gang's slot buffers and
    the zone facts (`gang_scratch_words`), plus the node state in the
    global layout."""
    per_block = gang_scratch_words(emax, num_zones, layout.zone_lanes)
    if layout.state == "global":
        per_block += STATE_WORDS * layout.slice
    return layout.k * per_block


_ROW_WALK_ARGTYPES = (
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
)


def _device_index(device) -> int:
    """The CUDA device index of `device` (None: the current device)."""
    if device is None:
        return torch.cuda.current_device()
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"kernel queries need a CUDA device, got {device}")
    return torch.cuda.current_device() if device.index is None else device.index


def _row_walk_lib():
    from spark_scheduler_tpu_torch.ops._build import load_library

    lib = load_library("window_kernel")
    fn = lib.window_row_walk
    if fn.argtypes is None:
        fn.argtypes = _ROW_WALK_ARGTYPES
        fn.restype = ctypes.c_int
        lib.window_kernel_error.argtypes = [ctypes.c_int]
        lib.window_kernel_error.restype = ctypes.c_char_p
        lib.window_kernel_info.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.window_kernel_info.restype = ctypes.c_int
    return lib


def window_kernel_info(layout: WalkLayout, device=None) -> dict:
    """What a card (`device`, default the current one) reports for the row
    walk at `layout`: registers and local (spill) bytes a thread, static
    shared bytes a block, and how many such clusters can be resident at
    once (0: the launch cannot run)."""
    lib = _row_walk_lib()
    out = (ctypes.c_int * 4)()
    err = lib.window_kernel_info(
        _device_index(device), int(layout.state == "smem"),
        int(layout.zone_lanes), layout.slice, out,
    )
    if err != 0:
        raise cuda_launch_error(
            err, "window kernel query", lib.window_kernel_error(err).decode()
        )
    return dict(regs=out[0], local_bytes=out[1], static_smem=out[2],
                max_active_clusters=out[3])


def window_pack(
    cluster: ClusterTensors,
    win: SegmentedWindow,
    *,
    fill: str,
    emax: int,
    num_zones: int,
    layout: WalkLayout | None = None,
    zone_base: tuple | None = None,
):
    """Serve a segmented window. CUDA tensors: per live segment, the sorts
    in PyTorch, then one launch of the CUDA row-walk kernel on one
    thread-block cluster (which also subtracts the committing row from the
    base) — no host synchronisation inside the segment loop. CPU tensors:
    `window_pack_reference`. Any other device raises. `layout` defaults to
    `walk_layout(n)`; tests pass another to drive the global-state layout
    at a small n. A single-AZ strategy runs the zone-parallel
    instantiation in the given layout's node-state place (counted in
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
    if layout is None:
        layout = walk_layout(n, zone_lanes=single_az)
    if layout.k != CLUSTER_BLOCKS or layout.slice * layout.k < n:
        raise ValueError(f"{layout} is not a row-walk layout for {n} nodes")
    if layout.zone_lanes != single_az:
        layout = walk_layout(n, state=layout.state, zone_lanes=single_az)
    lib = _row_walk_lib()

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
        walk_scratch_words(layout, emax, num_zones), dtype=torch.int32, device=dev
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
        err = lib.window_row_walk(
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
        if err != 0:
            raise cuda_launch_error(
                err, "window row-walk kernel launch",
                lib.window_kernel_error(err).decode(),
            )
        with _launches_lock:
            window_pack.launches += 1
            window_pack.zone_parallel_launches += int(single_az)
    if dead.size:
        idx = torch.as_tensor(dead, device=dev)
        meta.index_fill_(0, idx, 0)
        execs.index_fill_(0, idx, -1)
    return meta, execs, base


window_pack.launches = 0
# Row-walk launches that ran the zone-parallel (single-AZ) instantiation.
window_pack.zone_parallel_launches = 0
# Several solvers (HA replicas, a standby beside its leader) launch from
# their own threads: the count's read-modify-write takes a lock.
_launches_lock = threading.Lock()
