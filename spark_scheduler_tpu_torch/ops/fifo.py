"""Queue-mode FIFO gang admission: the port of spark_scheduler_tpu/ops/pallas_fifo.py.

`fifo_pack` admits a FIFO queue of B apps in queue mode, for all six
strategies: the priority orders are sorted ONCE per call from the starting
availability (`ops/batched.queue_mode_orders`), then the apps are walked in
order with the availability carried from app to app and strict-FIFO
blocking. It is the counterpart of both `fifo_pack_pallas` and
`fifo_pack_auto`:

  - CUDA tensors: the sorts in PyTorch, then ONE launch of the hand-written
    queue kernel csrc/fifo_kernel.cu, which walks the whole queue on one
    team of threads, a block or a thread-block cluster by node count
    (`queue_layout`; it shares its per-app step with the window kernel
    through csrc/gang_solve.cuh);
  - CPU tensors: `fifo_pack_reference`, its plain PyTorch version (the same
    sorts, then `ops/gang.walk_rows`);
  - any other device raises. There is no switch and no fallback.

Nodes are keyed by priority rank, as in the window path, so
`available_after` comes out in node order: the JAX kernel's pre-permuted,
sublane-folded node axis (pallas_fifo.py:88-96, :623-651) is a TPU layout
choice, not part of the contract.

Deviation from the JAX package, shared with the window path (ops/gang.py):
the single-AZ zone scores are summed in float64 and rounded once, where the
JAX package sums float32 in tile order, so a cross-zone tie closer than
about 1 ulp may break differently.
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
from spark_scheduler_tpu_torch.ops.batched import (
    APP_DTYPES,
    AppBatch,
    BatchedPacking,
    queue_mode_orders,
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
from spark_scheduler_tpu_torch.ops.window import (
    CLUSTER_BLOCKS,
    SMEM_PER_BLOCK,
    STATE_WORDS,
    WALK_STATIC_SMEM,
    _device_index,
)

def fifo_eligible(apps: AppBatch, fill: str) -> bool:
    """What the queue path serves (pallas_fifo.py `pallas_eligible`): queue
    mode (no per-app masks, no window rows) with any of the six
    strategies."""
    return (
        (fill in PALLAS_FILLS or fill in PALLAS_SINGLE_AZ)
        and apps.commit is None
        and apps.driver_cand is None
        and apps.domain is None
    )


def check_queue(apps: AppBatch, fill: str) -> None:
    if not fifo_eligible(apps, fill):
        raise ValueError(
            f"queue path supports queue mode with "
            f"{PALLAS_FILLS + tuple(PALLAS_SINGLE_AZ)}, got "
            f"fill={fill!r} masked={apps.driver_cand is not None or apps.domain is not None} "
            f"segmented={apps.commit is not None}"
        )


def kernel_orders(cluster: ClusterTensors, num_zones: int):
    """The queue-mode orders as the row walk takes them: (elig_e, elig_d,
    drank, d_order, erank, e_order), ranks and orders int32 permutations of
    0..N-1."""
    driver_elig, exec_elig, d_order, d_rank, e_order, _ = queue_mode_orders(
        cluster, num_zones
    )
    return (
        exec_elig, driver_elig, d_rank, d_order,
        _rank_of_position(e_order), e_order,
    )


def empty_packing(available: torch.Tensor, emax: int, lead=()) -> BatchedPacking:
    """An empty queue admits nothing and leaves the availability unchanged
    (pallas_fifo.py:604-613); `available_after` is a copy."""
    dev = available.device
    return BatchedPacking(
        driver_node=torch.zeros((*lead, 0), dtype=torch.int32, device=dev),
        executor_nodes=torch.zeros((*lead, 0, emax), dtype=torch.int32, device=dev),
        admitted=torch.zeros((*lead, 0), dtype=torch.bool, device=dev),
        packed=torch.zeros((*lead, 0), dtype=torch.bool, device=dev),
        available_after=available.clone(),
    )


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fifo_pack_reference(
    cluster: ClusterTensors,
    apps: AppBatch,
    *,
    fill: str = "tightly-pack",
    emax: int,
    num_zones: int,
) -> BatchedPacking:
    """The plain PyTorch version of `fifo_pack`: `queue_mode_orders` once,
    then a Python loop over the B apps (`ops/gang.walk_rows`), carrying the
    availability and the blocked flag. Runs on whatever device `cluster`
    lives on; the app fields may be tensors or numpy arrays."""
    check_queue(apps, fill)
    _check_cumsum_bound(cluster.num_nodes, emax)
    avail = cluster.available.clone()
    if apps.driver_req.shape[0] == 0:
        return empty_packing(cluster.available, emax)
    meta, execs = walk_rows(
        fill, num_zones=num_zones, emax=emax, cluster=cluster, avail=avail,
        orders=kernel_orders(cluster, num_zones),
        driver_req=_host(apps.driver_req), exec_req=_host(apps.exec_req),
        exec_count=_host(apps.exec_count), valid=_host(apps.app_valid),
        skippable=_host(apps.skippable),
    )
    dev = cluster.device
    meta = torch.tensor(meta, device=dev)
    return BatchedPacking(
        driver_node=meta[:, 0].contiguous(),
        executor_nodes=torch.tensor(execs, device=dev),
        admitted=meta[:, 1] != 0,
        packed=meta[:, 2] != 0,
        available_after=avail,
    )


def device_apps(apps: AppBatch, device: torch.device, lead=()) -> list:
    """The five queue fields of `apps` as contiguous tensors of the kernel's
    dtypes; raises unless each is a tensor on `device` of shape
    lead + [B, 3] or lead + [B]."""
    out = []
    b = None
    # The first five AppBatch fields: the queue-mode ones.
    for field, dtype in zip(AppBatch._fields[:5], APP_DTYPES[:5]):
        t = getattr(apps, field)
        if not isinstance(t, torch.Tensor) or t.device != device:
            raise ValueError(
                f"apps.{field} must be a tensor on {device} "
                "(ops/batched.app_batch_to_device)"
            )
        b = t.shape[len(lead)] if b is None else b
        want = (*lead, b, 3) if field.endswith("_req") else (*lead, b)
        if tuple(t.shape) != want:
            raise ValueError(f"apps.{field}: expected shape {want}, got {tuple(t.shape)}")
        out.append(t.to(dtype).contiguous())
    return out


# The queue kernel's teams (csrc/fifo_kernel.cu). From this node count on, a
# queue runs on a cluster of CLUSTER_BLOCKS blocks, below it on one block.
# chip_smoke.py phase 4's crossover sweep (100 tightly-pack apps, both teams
# with the node state in shared memory, NVIDIA H100 80GB HBM3 at 700 W):
# the block was faster at 1,000 nodes (431 against 481 us), the cluster from
# 1,250 on (480 against 509 us); at 10,000 nodes, where the block's state
# no longer fits in shared memory, 3.4x faster than the block (PERF.md).
QUEUE_CLUSTER_MIN_NODES = 1_250
# The block team's static shared memory: two alternating buffers of 32
# 8-byte warp partials. The cluster team's is the row walk's,
# WALK_STATIC_SMEM.
QUEUE_BLOCK_STATIC_SMEM = 2 * 32 * 8
_TEAM_CODES = {"block": 0, "cluster": 1}


class QueueLayout(NamedTuple):
    """Launch shape of the queue kernel for one node count."""

    team: str  # "block": one block a queue; "cluster": one cluster a queue
    k: int  # blocks a team
    slice: int  # nodes a block owns, ceil(n / k)
    smem_bytes: int  # shared memory a block, static + dynamic
    state: str  # "smem": node state in shared memory; "global": in scratch


def queue_layout(
    n: int, *, team: str | None = None, state: str | None = None
) -> QueueLayout:
    """The queue kernel's layout for `n` nodes: one block a queue below
    QUEUE_CLUSTER_MIN_NODES nodes, one cluster from there on; the node state
    (8 words a node) in shared memory where a block's slice of it fits
    beside the static buffers (n up to 7,248 for a block, 58,008 for a
    cluster), else in global scratch. `team` and `state` force a layout
    (tests and chip_smoke.py); a forced "smem" that does not fit raises."""
    if n < 1:
        raise ValueError(f"queue_layout needs n >= 1, got {n}")
    if team is None:
        team = "cluster" if n >= QUEUE_CLUSTER_MIN_NODES else "block"
    if team not in _TEAM_CODES:
        raise ValueError(f"no {team!r} queue team")
    k = CLUSTER_BLOCKS if team == "cluster" else 1
    static = WALK_STATIC_SMEM if team == "cluster" else QUEUE_BLOCK_STATIC_SMEM
    sl = -(-n // k)
    smem = STATE_WORDS * 4 * sl + static
    fits = smem <= SMEM_PER_BLOCK
    if state is None:
        state = "smem" if fits else "global"
    if state not in ("smem", "global") or (state == "smem" and not fits):
        raise ValueError(f"no {team!r}/{state!r} queue layout for n={n}")
    return QueueLayout(team, k, sl, smem if state == "smem" else static, state)


def queue_scratch_words(
    layout: QueueLayout, groups: int, emax: int, num_zones: int
) -> int:
    """Global scratch of one launch over `groups` queues: per block, the
    gang's two slot buffers and the zone facts, plus the node state in the
    global layout."""
    per_block = 2 * emax + 2 * num_zones
    if layout.state == "global":
        per_block += STATE_WORDS * layout.slice
    return groups * layout.k * per_block


_QUEUE_ARGTYPES = (
    # device index (the entry point sets it first), groups, rows, n, emax,
    # num_zones, fill, single_az, az_fallback, include_exec
    [ctypes.c_int] * 10
    + [ctypes.c_void_p] * 5  # dreq, ereq, cnt, valid, skip
    # avail, elig_e, elig_d, drank, d_order, erank, e_order, zone, sched
    + [ctypes.c_void_p] * 9
    + [ctypes.c_void_p] * 4  # meta, execs, avail_out, scratch
    + [ctypes.c_int] * 3  # team, slice, smem_state
    + [ctypes.c_void_p]  # stream
)


def _queue_lib():
    from spark_scheduler_tpu_torch.ops._build import load_library

    lib = load_library("fifo_kernel")
    fn = lib.fifo_queue
    if fn.argtypes is None:
        fn.argtypes = _QUEUE_ARGTYPES
        fn.restype = ctypes.c_int
        lib.fifo_kernel_error.argtypes = [ctypes.c_int]
        lib.fifo_kernel_error.restype = ctypes.c_char_p
        lib.fifo_kernel_info.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.fifo_kernel_info.restype = ctypes.c_int
    return lib


def fifo_kernel_info(layout: QueueLayout, device=None) -> dict:
    """What a card (`device`, default the current one) reports for the
    queue kernel at `layout`: registers and local (spill) bytes a thread,
    static shared bytes a block, and how many such teams can be resident at
    once (0: the launch cannot run)."""
    lib = _queue_lib()
    out = (ctypes.c_int * 4)()
    err = lib.fifo_kernel_info(
        _device_index(device), _TEAM_CODES[layout.team],
        int(layout.state == "smem"), layout.slice, out,
    )
    if err != 0:
        raise RuntimeError(
            "queue kernel query failed: " + lib.fifo_kernel_error(err).decode()
        )
    return dict(regs=out[0], local_bytes=out[1], static_smem=out[2],
                max_active_teams=out[3])


def fifo_queue(avail, sched, zone, orders, app_fields, *, fill, emax, num_zones,
               layout: QueueLayout):
    """ONE launch of the CUDA queue kernel over G independent queues, one
    team of `layout` each. Every input is a contiguous CUDA tensor stacked
    on a leading group axis: `avail`/`sched` [G,N,3] i32, `zone` [G,N] i32,
    `orders` the six [G,N] tensors of `kernel_orders`, `app_fields` the
    five of `device_apps` ([G,B,3] or [G,B]). Returns (meta [G,B,4],
    execs [G,B,emax], avail_after [G,N,3]), all new tensors; the kernel runs
    on the current stream and nothing waits for it."""
    g, n, _ = avail.shape
    if layout != queue_layout(n, team=layout.team, state=layout.state):
        raise ValueError(f"{layout} is not a queue layout for {n} nodes")
    b = app_fields[0].shape[1]
    dev = avail.device
    # The scratch and any temporaries may be freed when this returns, before
    # the kernel ends: the caching allocator hands their memory only to
    # later work on the same stream, which runs after the kernel.
    inner, single_az, az_fallback, include_exec = strategy_params(fill)
    lib = _queue_lib()
    meta = torch.empty((g, b, 4), dtype=torch.int32, device=dev)
    execs = torch.empty((g, b, emax), dtype=torch.int32, device=dev)
    avail_out = torch.empty((g, n, 3), dtype=torch.int32, device=dev)
    scratch = torch.empty(
        queue_scratch_words(layout, g, emax, num_zones), dtype=torch.int32,
        device=dev,
    )
    err = lib.fifo_queue(
        dev.index, g, b, n, emax, num_zones, FILL_CODES[inner], int(single_az),
        int(az_fallback), int(include_exec),
        *(t.data_ptr() for t in app_fields),
        avail.data_ptr(),
        *(t.data_ptr() for t in orders),
        zone.data_ptr(), sched.data_ptr(),
        meta.data_ptr(), execs.data_ptr(), avail_out.data_ptr(),
        scratch.data_ptr(),
        _TEAM_CODES[layout.team], layout.slice, int(layout.state == "smem"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "queue kernel launch failed: " + lib.fifo_kernel_error(err).decode()
        )
    fifo_pack.launches += 1
    return meta, execs, avail_out


def queue_operands(cluster: ClusterTensors, fields: list, num_zones: int) -> tuple:
    """`fifo_queue`'s five operands for one queue (the cluster's
    availability, schedulable and zones, its queue-mode orders, the app
    fields of `device_apps`), each with a group axis of 1."""
    orders = kernel_orders(cluster, num_zones)
    return (
        cluster.available.contiguous()[None],
        cluster.schedulable.contiguous()[None],
        cluster.zone_id.contiguous()[None],
        [t.contiguous()[None] for t in orders],
        [t[None] for t in fields],
    )


def queue_packing(meta, execs, avail_after) -> BatchedPacking:
    """`fifo_queue`'s outputs as a BatchedPacking stacked [G, ...]."""
    return BatchedPacking(
        driver_node=meta[..., 0].contiguous(),
        executor_nodes=execs,
        admitted=meta[..., 1] != 0,
        packed=meta[..., 2] != 0,
        available_after=avail_after,
    )


def fifo_pack(
    cluster: ClusterTensors,
    apps: AppBatch,
    *,
    fill: str = "tightly-pack",
    emax: int,
    num_zones: int,
) -> BatchedPacking:
    """Admit a FIFO queue in queue mode. CUDA tensors: the sorts in
    PyTorch, then one launch of the CUDA queue kernel in the layout
    `queue_layout` picks for the node count (the app fields must be tensors
    on the cluster's device). CPU tensors: `fifo_pack_reference`.
    Any other device raises. `emax` is the executor-slot padding; a gang of
    more than `emax` executors never packs. `available_after` is always a
    new tensor: the caller's `cluster.available` is left as it was."""
    check_queue(apps, fill)
    check_cluster(cluster)
    dev = cluster.device
    if dev.type == "cpu":
        return fifo_pack_reference(
            cluster, apps, fill=fill, emax=emax, num_zones=num_zones
        )
    if dev.type != "cuda":
        raise ValueError(f"fifo_pack runs on cuda or cpu, got {dev}")
    _check_cumsum_bound(cluster.num_nodes, emax)
    fields = device_apps(apps, dev)
    if fields[0].shape[0] == 0:
        return empty_packing(cluster.available, emax)
    out = queue_packing(*fifo_queue(
        *queue_operands(cluster, fields, num_zones),
        fill=fill, emax=emax, num_zones=num_zones,
        layout=queue_layout(cluster.num_nodes),
    ))
    return BatchedPacking(*(x[0] for x in out))


fifo_pack.launches = 0
