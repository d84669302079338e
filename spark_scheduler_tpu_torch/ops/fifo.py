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
    (`ops/launch.kernel_layout`; it shares its per-app step with the window
    kernel through csrc/gang_solve.cuh);
  - CPU tensors: `fifo_pack_reference`, its plain PyTorch version (the same
    sorts, then `ops/gang.walk_rows`);
  - any other device raises. There is no switch and no fallback.

`grouped_fifo_pack` runs G independent queues (instance groups) stacked on
a leading axis the same way, one team a queue in the one launch;
`fifo_pack` is the same solve on one group.

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
from spark_scheduler_tpu_torch.ops.launch import (
    TEAM_CODES,
    KernelLibrary,
    count_launch,
    gang_scratch_words,
    kernel_layout,
)
from spark_scheduler_tpu_torch.ops.packing import (
    _check_cumsum_bound,
    _rank_of_position,
)
from spark_scheduler_tpu_torch.tracing import profiled_span


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
    0..N-1. Traced as the span `queue.orders`."""
    with profiled_span("queue.orders"):
        driver_elig, exec_elig, d_order, d_rank, e_order, _ = queue_mode_orders(
            cluster, num_zones
        )
        return (
            exec_elig, driver_elig, d_rank, d_order,
            _rank_of_position(e_order), e_order,
        )


def _stack(ts) -> torch.Tensor:
    """`ts` stacked on a new leading axis: a view for one tensor (of a
    contiguous copy where it is not contiguous), a new tensor for more."""
    return ts[0].contiguous()[None] if len(ts) == 1 else torch.stack(ts)


def group_views(clusters: ClusterTensors, apps: AppBatch) -> list:
    """Per group g of `clusters` and `apps` stacked on a leading axis:
    (cluster g, apps g), as views."""
    return [
        (
            ClusterTensors(*(f[g] for f in clusters.fields())),
            AppBatch(*(None if col is None else col[g] for col in apps)),
        )
        for g in range(clusters.available.shape[0])
    ]


def _empty(available: torch.Tensor, emax: int, lead=()):
    """An empty queue admits nothing and leaves the availability unchanged
    (pallas_fifo.py:604-613): (packing, zone scores), `available_after` a
    copy."""
    dev = available.device
    return BatchedPacking(
        driver_node=torch.zeros((*lead, 0), dtype=torch.int32, device=dev),
        executor_nodes=torch.zeros((*lead, 0, emax), dtype=torch.int32, device=dev),
        admitted=torch.zeros((*lead, 0), dtype=torch.bool, device=dev),
        packed=torch.zeros((*lead, 0), dtype=torch.bool, device=dev),
        available_after=available.clone(),
    ), torch.zeros((*lead, 0), dtype=torch.float32, device=dev)


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
    return _walk_queue(cluster, apps, fill=fill, emax=emax,
                       num_zones=num_zones)[0]


def grouped_fifo_pack_reference(
    clusters: ClusterTensors,  # fields stacked [G, N, ...]
    apps: AppBatch,  # fields stacked [G, B, ...]
    *,
    fill: str = "tightly-pack",
    emax: int,
    num_zones: int,
) -> BatchedPacking:
    """The plain PyTorch version of `grouped_fifo_pack`:
    `fifo_pack_reference` per group, stacked. Runs on whatever device the
    tensors live on."""
    return _reference(group_views(clusters, apps), fill=fill, emax=emax,
                      num_zones=num_zones)[0]


def _reference(groups, *, fill, emax, num_zones):
    """The plain walk of each (cluster, apps) of `groups`: (packing, zone
    scores), stacked on a leading group axis."""
    outs = [_walk_queue(c, a, fill=fill, emax=emax, num_zones=num_zones)
            for c, a in groups]
    packing = BatchedPacking(*(_stack(x) for x in zip(*(p for p, _ in outs))))
    return packing, _stack([s for _, s in outs])


def _walk_queue(cluster, apps, *, fill, emax, num_zones):
    """`fifo_pack_reference`'s walk: (packing, `zone_scores`)."""
    check_queue(apps, fill)
    _check_cumsum_bound(cluster.num_nodes, emax)
    avail = cluster.available.clone()
    if apps.driver_req.shape[0] == 0:
        return _empty(cluster.available, emax)
    meta, execs = walk_rows(
        fill, num_zones=num_zones, emax=emax, cluster=cluster, avail=avail,
        orders=kernel_orders(cluster, num_zones),
        driver_req=_host(apps.driver_req), exec_req=_host(apps.exec_req),
        exec_count=_host(apps.exec_count), valid=_host(apps.app_valid),
        skippable=_host(apps.skippable), with_score=True,
    )
    dev = cluster.device
    meta = torch.tensor(meta, device=dev)
    return BatchedPacking(
        driver_node=meta[:, 0].contiguous(),
        executor_nodes=torch.tensor(execs, device=dev),
        admitted=meta[:, 1] != 0,
        packed=meta[:, 2] != 0,
        available_after=avail,
    ), zone_scores(meta)


def zone_scores(meta: torch.Tensor) -> torch.Tensor:
    """The float32 scores of the zones a queue solve chose, from its meta
    rows' fourth word: a packed row's score under a single-AZ or az-aware
    strategy, 0.0 where a row did not pack or no zone was chosen. A view of
    `meta`: no copy, no synchronisation."""
    return meta[..., 3].view(torch.float32)


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


_QUEUE = KernelLibrary("fifo_kernel", "fifo_kernel", {
    "fifo_queue": (
        # device index (the entry point sets it first), groups, rows, n,
        # emax, num_zones, fill, single_az, az_fallback, include_exec
        [ctypes.c_int] * 10
        + [ctypes.c_void_p] * 5  # dreq, ereq, cnt, valid, skip
        # avail, elig_e, elig_d, drank, d_order, erank, e_order, zone, sched
        + [ctypes.c_void_p] * 9
        + [ctypes.c_void_p] * 4  # meta, execs, avail_out, scratch
        + [ctypes.c_int] * 3  # team, slice, smem_state
        + [ctypes.c_void_p]  # stream
    ),
    # device index, team, smem_state, lanes, slice, out[4]
    "fifo_kernel_info": [ctypes.c_int] * 5 + [ctypes.c_void_p],
})


def fifo_kernel_info(n: int, fill: str, *, team: str | None = None,
                     state: str | None = None, device=None) -> dict:
    """What a card (`device`, default the current one) reports for the
    queue kernel's instantiation for `n` nodes under `fill`, in its default
    or the forced team and node-state place (`KernelLibrary.info`)."""
    lay = kernel_layout(n, fill, team=team, state=state)
    return _QUEUE.info(device, TEAM_CODES[lay.team], int(lay.state == "smem"),
                       int(lay.zone_lanes), lay.slice)


def fifo_queue(avail, sched, zone, orders, app_fields, *, fill, emax, num_zones,
               team: str | None = None, state: str | None = None):
    """ONE launch of the CUDA queue kernel over G independent queues, one
    team each. Every input is a contiguous CUDA tensor stacked on a leading
    group axis: `avail`/`sched` [G,N,3] i32, `zone` [G,N] i32, `orders` the
    six [G,N] tensors of `kernel_orders`, `app_fields` the five of
    `device_apps` ([G,B,3] or [G,B]). Returns (meta [G,B,4] rows of
    (driver, admitted, packed, `zone_scores` bits), execs [G,B,emax],
    avail_after [G,N,3]), all new tensors; the kernel runs on the current
    stream and nothing waits for it. The launch shape is
    `ops/launch.kernel_layout(n, fill)`; `team` and `state` force one
    (tests and chip_smoke.py). A single-AZ strategy runs the zone-parallel
    instantiation (counted in `fifo_pack.zone_parallel_launches`)."""
    g, n, _ = avail.shape
    layout = kernel_layout(n, fill, team=team, state=state)
    inner, single_az, az_fallback, include_exec = strategy_params(fill)
    b = app_fields[0].shape[1]
    dev = avail.device
    # The scratch and any temporaries may be freed when this returns, before
    # the kernel ends: the caching allocator hands their memory only to
    # later work on the same stream, which runs after the kernel.
    meta = torch.empty((g, b, 4), dtype=torch.int32, device=dev)
    execs = torch.empty((g, b, emax), dtype=torch.int32, device=dev)
    avail_out = torch.empty((g, n, 3), dtype=torch.int32, device=dev)
    scratch = torch.empty(
        gang_scratch_words(layout, g, emax, num_zones), dtype=torch.int32,
        device=dev,
    )
    _QUEUE.call(
        "fifo_queue", "queue kernel launch",
        dev.index, g, b, n, emax, num_zones, FILL_CODES[inner], int(single_az),
        int(az_fallback), int(include_exec),
        *(t.data_ptr() for t in app_fields),
        avail.data_ptr(),
        *(t.data_ptr() for t in orders),
        zone.data_ptr(), sched.data_ptr(),
        meta.data_ptr(), execs.data_ptr(), avail_out.data_ptr(),
        scratch.data_ptr(),
        TEAM_CODES[layout.team], layout.slice, int(layout.state == "smem"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    count_launch(fifo_pack, single_az)
    return meta, execs, avail_out


def _state(cluster: ClusterTensors) -> tuple:
    """What the queue kernel reads of a cluster besides its orders: the
    availability, schedulable and zones."""
    return cluster.available, cluster.schedulable, cluster.zone_id


def queue_operands(clusters: ClusterTensors, fields: list, num_zones: int) -> tuple:
    """`fifo_queue`'s five operands for G queues, from `clusters` and the
    app `fields` of `device_apps`, both stacked on a leading axis of G: the
    availability, schedulable and zones, each group's queue-mode orders
    stacked, and the app fields."""
    views = [ClusterTensors(*(f[g] for f in clusters.fields()))
             for g in range(clusters.available.shape[0])]
    return _operands(_state(clusters), views, fields, num_zones)


def _operands(state, views, fields, num_zones) -> tuple:
    """`queue_operands` from the groups' `state` stacked and their
    clusters' `views`. One group's orders are views, not stacked copies."""
    orders = [kernel_orders(c, num_zones) for c in views]
    return (
        *(t.contiguous() for t in state),
        [_stack(cols) for cols in zip(*orders)],
        fields,
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


def _queue_solve(groups, state, apps, *, fill, emax, num_zones):
    """The queue solve of G groups: `groups` their (cluster, apps) pairs;
    `state`, the clusters' `_state`, and `apps` the same stacked on a
    leading axis of G. Returns (packing [G, ...], zone scores [G, B]).
    Traced, entry to return, as the span `queue.pack` (each group's orders
    a `queue.orders` under it)."""
    g, n = state[0].shape[:2]
    with profiled_span("queue.pack", nodes=n, rows=apps.driver_req.shape[1],
                       groups=g):
        check_queue(apps, fill)
        for c, _ in groups:
            check_cluster(c)
        dev = state[0].device
        if dev.type == "cpu":
            return _reference(groups, fill=fill, emax=emax, num_zones=num_zones)
        if dev.type != "cuda":
            raise ValueError(f"fifo_pack runs on cuda or cpu, got {dev}")
        _check_cumsum_bound(n, emax)
        fields = device_apps(apps, dev, lead=(g,))
        if fields[0].shape[1] == 0:
            return _empty(state[0], emax, lead=(g,))
        meta, execs, after = fifo_queue(
            *_operands(state, [c for c, _ in groups], fields, num_zones),
            fill=fill, emax=emax, num_zones=num_zones,
        )
        return queue_packing(meta, execs, after), zone_scores(meta)


def grouped_fifo_pack(
    clusters: ClusterTensors,  # fields stacked [G, N, ...]
    apps: AppBatch,  # fields stacked [G, B, ...]
    *,
    fill: str = "tightly-pack",
    emax: int,
    num_zones: int,
) -> BatchedPacking:
    """G independent queue-mode solves (instance groups, failover.go:276-313;
    JAX `grouped_fifo_pack_auto` -> `_grouped_pallas`); outputs stacked
    [G, ...]. CUDA tensors: each group's sorts in PyTorch, then ONE launch
    of the queue kernel with G teams. CPU tensors:
    `grouped_fifo_pack_reference`. Any other device raises. Decisions equal
    G separate `fifo_pack` calls."""
    return _queue_solve(group_views(clusters, apps), _state(clusters), apps,
                        fill=fill, emax=emax, num_zones=num_zones)[0]


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
    `ops/launch.kernel_layout` picks for the node count and strategy (the
    app fields must be tensors on the cluster's device). CPU tensors:
    `fifo_pack_reference`. Any other device raises. `emax` is the
    executor-slot padding; a gang of more than `emax` executors never
    packs. `available_after` is always a new tensor: the caller's
    `cluster.available` is left as it was. Traced, entry to return, as the
    span `queue.pack`."""
    return fifo_pack_with_scores(cluster, apps, fill=fill, emax=emax,
                                 num_zones=num_zones)[0]


def fifo_pack_with_scores(
    cluster: ClusterTensors,
    apps: AppBatch,
    *,
    fill: str = "tightly-pack",
    emax: int,
    num_zones: int,
) -> tuple[BatchedPacking, torch.Tensor]:
    """`fifo_pack`, and its [B] float32 `zone_scores`: the score of the zone
    each packed row chose under a single-AZ or az-aware strategy (0.0
    elsewhere), read from the same solve at no extra cost. It is
    `grouped_fifo_pack`'s solve on one group."""
    packing, scores = _queue_solve(
        [(cluster, apps)], [t[None] for t in _state(cluster)],
        AppBatch(*(None if col is None else col[None] for col in apps)),
        fill=fill, emax=emax, num_zones=num_zones,
    )
    return BatchedPacking(*(x[0] for x in packing)), scores[0]


fifo_pack.launches = 0
# Queue-kernel launches that ran the zone-parallel (single-AZ) instantiation.
fifo_pack.zone_parallel_launches = 0
