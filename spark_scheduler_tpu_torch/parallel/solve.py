"""Single-device grouped FIFO admission, the port of the single-chip route
of spark_scheduler_tpu/parallel/solve.py (`grouped_fifo_pack_auto` ->
`_grouped_pallas`, :205-301).

Instance groups (failover.go:276-313) are independent subproblems: each has
its own cluster, its own app queue and its own priority orders, and no data
flows between them. So `grouped_fifo_pack` sorts each group in PyTorch and
then makes ONE launch of the queue kernel with one team per group (a block
or a thread-block cluster, `ops/fifo.queue_layout`): the G queues run side
by side. Spreading groups over several cards is
later work; there is no mesh here.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_scheduler_tpu_torch.models.cluster import (
    ClusterTensors,
    check_cluster,
)
from spark_scheduler_tpu_torch.ops.batched import AppBatch, BatchedPacking
from spark_scheduler_tpu_torch.ops.fifo import (
    check_queue,
    device_apps,
    empty_packing,
    fifo_pack_reference,
    fifo_queue,
    kernel_orders,
    queue_layout,
    queue_packing,
)
from spark_scheduler_tpu_torch.ops.packing import _check_cumsum_bound


def _stack(vals, what):
    shapes = {tuple(v.shape) for v in vals}
    if len(shapes) != 1:
        raise ValueError(
            f"{what}: groups must share one padded shape, got {sorted(shapes)}"
        )
    if isinstance(vals[0], torch.Tensor):
        return torch.stack(list(vals))
    return np.stack([np.asarray(v) for v in vals])


def stack_groups(
    clusters: list[ClusterTensors], app_batches: list[AppBatch]
) -> tuple[ClusterTensors, AppBatch]:
    """Stack per-instance-group subproblems on a leading axis. All groups
    must be padded to identical (N, B) shapes, and an optional AppBatch
    field must be set for every group or for none."""
    if len(clusters) != len(app_batches) or not clusters:
        raise ValueError("stack_groups needs one app batch per cluster")
    cluster = ClusterTensors(
        *(
            _stack(vals, f"cluster field {i}")
            for i, vals in enumerate(zip(*(c.fields() for c in clusters)))
        )
    )
    cols = []
    for field, vals in zip(AppBatch._fields, zip(*app_batches)):
        present = [v is not None for v in vals]
        if not any(present):
            cols.append(None)
            continue
        if not all(present):
            raise ValueError(
                f"AppBatch field {field!r} set for some groups but not others; "
                "masks must be provided for every group or none"
            )
        cols.append(_stack(vals, f"apps.{field}"))
    return cluster, AppBatch(*cols)


def _groups(clusters: ClusterTensors, apps: AppBatch):
    """Per group g: (cluster g, apps g), as views."""
    return [
        (
            ClusterTensors(*(f[g] for f in clusters.fields())),
            AppBatch(*(None if col is None else col[g] for col in apps)),
        )
        for g in range(clusters.available.shape[0])
    ]


def grouped_queue_operands(
    clusters: ClusterTensors, fields: list, num_zones: int
) -> tuple:
    """`ops/fifo.fifo_queue`'s five operands for G stacked queues: the
    clusters' availability, schedulable and zones, each group's queue-mode
    orders stacked, and the app fields of `device_apps`."""
    g = clusters.available.shape[0]
    per_group = [
        kernel_orders(ClusterTensors(*(f[i] for f in clusters.fields())), num_zones)
        for i in range(g)
    ]
    return (
        clusters.available.contiguous(),
        clusters.schedulable.contiguous(),
        clusters.zone_id.contiguous(),
        [torch.stack(cols) for cols in zip(*per_group)],
        fields,
    )


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
    outs = [
        fifo_pack_reference(c, a, fill=fill, emax=emax, num_zones=num_zones)
        for c, a in _groups(clusters, apps)
    ]
    return BatchedPacking(*(torch.stack(x) for x in zip(*outs)))


def grouped_fifo_pack(
    clusters: ClusterTensors,  # fields stacked [G, N, ...]
    apps: AppBatch,  # fields stacked [G, B, ...]
    *,
    fill: str = "tightly-pack",
    emax: int,
    num_zones: int,
) -> BatchedPacking:
    """G independent queue-mode solves; outputs stacked [G, ...]. CUDA
    tensors: each group's sorts in PyTorch, then ONE launch of the queue
    kernel with G teams. CPU tensors: `grouped_fifo_pack_reference`. Any
    other device raises. Decisions equal G separate `fifo_pack` calls."""
    check_queue(apps, fill)
    groups = _groups(clusters, apps)
    for c, _ in groups:
        check_cluster(c)
    dev = clusters.available.device
    if dev.type == "cpu":
        return grouped_fifo_pack_reference(
            clusters, apps, fill=fill, emax=emax, num_zones=num_zones
        )
    if dev.type != "cuda":
        raise ValueError(f"grouped_fifo_pack runs on cuda or cpu, got {dev}")
    g = len(groups)
    _check_cumsum_bound(clusters.available.shape[1], emax)
    fields = device_apps(apps, dev, lead=(g,))
    if fields[0].shape[1] == 0:
        return empty_packing(clusters.available, emax, lead=(g,))
    return queue_packing(*fifo_queue(
        *grouped_queue_operands(clusters, fields, num_zones),
        fill=fill, emax=emax, num_zones=num_zones,
        layout=queue_layout(clusters.available.shape[1]),
    ))
