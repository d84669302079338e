"""Grouped and sharded FIFO admission, the port of
spark_scheduler_tpu/parallel/solve.py.

Instance groups (failover.go:276-313) are independent subproblems: each has
its own cluster, its own app queue and its own priority orders, and no data
flows between them.

  grouped_fifo_pack — the single-card route (JAX `grouped_fifo_pack_auto`
      -> `_grouped_pallas`, :205-301): each group sorted in PyTorch, then
      ONE launch of the queue kernel with one team per group (a block or a
      thread-block cluster, `ops/fifo.queue_layout`).
  grouped_queue_sharded — the group-sharded route (JAX
      `_grouped_pallas_sharded`, :142-202): G groups split over the mesh's
      "groups" devices, one launch of the queue kernel a device with G/D
      teams, each on its own stream; zero cross-device reductions.
  sharded_fifo_pack — one cluster's node axis split over the mesh's
      "nodes" shards (JAX :92-117; parallel/node_shards.py).
  grouped_sharded_fifo_pack — the 2-D route (JAX `grouped_fifo_pack(mesh,
      ...)`, :304): per group, the node-sharded engine over that group's row
      of the mesh.
  grouped_fifo_pack_auto — JAX's routing between them (:205-273).

A mesh is parallel/mesh.py's SolverMesh; its devices may repeat (several
streams on one card). On CPU tensors every route takes the plain versions.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from spark_scheduler_tpu_torch.models.cluster import (
    ClusterTensors,
    check_cluster,
)
from spark_scheduler_tpu_torch.ops.batched import (
    AppBatch,
    BatchedPacking,
    app_batch_to_device,
)
from spark_scheduler_tpu_torch.ops.fifo import (
    check_queue,
    device_apps,
    empty_packing,
    fifo_eligible,
    fifo_pack_reference,
    fifo_queue,
    kernel_orders,
    queue_layout,
    queue_packing,
)
from spark_scheduler_tpu_torch.ops.packing import _check_cumsum_bound
from spark_scheduler_tpu_torch.parallel.mesh import SolverMesh
from spark_scheduler_tpu_torch.parallel.node_shards import (
    NodeShards,
    node_sharded_fifo_pack,
    shard_cluster,
    shard_fields,
)
from spark_scheduler_tpu_torch.parallel.node_shards import (
    shard_apps as _shard_apps,
)


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


# -- the mesh routes ---------------------------------------------------------


def _node_devices(mesh: SolverMesh) -> list:
    """The ("nodes",) devices a one-cluster solve shards over: the mesh's
    first row (a "groups" axis replicates, as in the JAX sharding)."""
    return mesh.grid[0]


def node_sharding(mesh: SolverMesh, x: torch.Tensor) -> list:
    """A node-axis field (axis 0) placed on the mesh's "nodes" shards:
    chunk s on shard s's device (the JAX `node_sharding` placement)."""
    return [t for (t,) in shard_fields(_node_devices(mesh), [x])]


def shard_apps(apps: AppBatch, mesh: SolverMesh, n: int) -> list:
    """An app batch placed on the mesh's "nodes" shards: the row fields
    replicated, the [B, N] masks cut with the cluster (JAX `shard_apps`)."""
    return _shard_apps(apps, NodeShards(_node_devices(mesh), n))


def sharded_fifo_pack(
    mesh: SolverMesh,
    cluster: ClusterTensors,
    apps: AppBatch,
    *,
    fill: str = "tightly-pack",
    emax: int,
    num_zones: int,
    zone_base: tuple | None = None,
    stats: dict | None = None,
) -> BatchedPacking:
    """Batched FIFO admission with the node axis sharded over the mesh's
    "nodes" shards (parallel/node_shards.py); decisions equal
    `ops/batched.batched_fifo_pack`'s. The node count must divide by the
    shard count (pad the cluster with invalid slots). Outputs land on the
    first shard's device."""
    return node_sharded_fifo_pack(
        shard_cluster(_node_devices(mesh), cluster), apps, fill=fill,
        emax=emax, num_zones=num_zones, zone_base=zone_base, stats=stats,
    )


def _group_apps(apps: AppBatch, lo: int, hi: int, dev) -> AppBatch:
    """Groups [lo, hi) of a stacked batch (numpy or tensors) on `dev`."""
    return app_batch_to_device(
        AppBatch(*(None if x is None else x[lo:hi] for x in apps)), dev
    )


def _land_on(out, dev, src_stream, dst_stream):
    """A BatchedPacking made on `src_stream` usable on `dst_stream` of
    `dev`."""
    if src_stream is None:
        return BatchedPacking(*(t.to(dev) for t in out))
    if out.available_after.device == dev:
        ev = torch.cuda.Event()
        ev.record(src_stream)
        dst_stream.wait_event(ev)
        for t in out:
            t.record_stream(dst_stream)
        return out
    with torch.cuda.stream(src_stream), torch.cuda.stream(dst_stream):
        return BatchedPacking(*(t.to(dev) for t in out))


def grouped_queue_sharded(
    mesh: SolverMesh,
    clusters: ClusterTensors,  # fields stacked [G, N, ...]
    apps: AppBatch,  # fields stacked [G, B, ...]
    *,
    fill: str = "tightly-pack",
    emax: int,
    num_zones: int,
) -> BatchedPacking:
    """The group-sharded queue route (JAX `_grouped_pallas_sharded`): the
    G groups split over the mesh's D "groups" devices (G must divide by
    D), each device's G/D groups solved by ONE `grouped_fifo_pack` (one
    queue-kernel launch with G/D teams on a card, the plain version on the
    CPU) on a stream of its own. Every launch goes out before any result
    is read; the outputs are gathered to the first device, stacked [G,
    ...]. Groups are independent, so the solve makes zero cross-device
    reductions."""
    check_queue(apps, fill)
    devices = [row[0] for row in mesh.grid]
    g, d = clusters.available.shape[0], len(devices)
    if g % d:
        raise ValueError(
            f'group count {g} not divisible by mesh "groups" axis {d}'
        )
    per = g // d
    first = devices[0]
    cuda = first.type == "cuda"
    outs = []
    for k, dev in enumerate(devices):
        lo, hi = k * per, (k + 1) * per
        stream = torch.cuda.Stream(device=dev) if cuda else None
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
        ctx = torch.cuda.stream(stream) if cuda else contextlib.nullcontext()
        with ctx:
            sub_c = ClusterTensors(
                *(f[lo:hi].to(dev) for f in clusters.fields())
            )
            sub_a = _group_apps(apps, lo, hi, dev)
            outs.append((grouped_fifo_pack(
                sub_c, sub_a, fill=fill, emax=emax, num_zones=num_zones,
            ), stream))
    dst = torch.cuda.current_stream(first) if cuda else None
    landed = [_land_on(o, first, st, dst) for o, st in outs]
    return BatchedPacking(*(torch.cat(x) for x in zip(*landed)))


def grouped_sharded_fifo_pack(
    mesh: SolverMesh,
    clusters: ClusterTensors,  # fields stacked [G, N, ...]
    apps: AppBatch,  # fields stacked [G, B, ...]
    *,
    fill: str = "tightly-pack",
    emax: int,
    num_zones: int,
) -> BatchedPacking:
    """2-D admission, the port of the JAX `grouped_fifo_pack(mesh, ...)`
    (:304-330): group g is solved by the node-sharded engine over row
    g // (G / groups) of the mesh, every mode and strategy of
    `batched_fifo_pack`. Outputs stacked [G, ...] on the mesh's first
    device."""
    g = clusters.available.shape[0]
    rows = mesh.shape["groups"]
    if g % rows:
        raise ValueError(
            f'group count {g} not divisible by mesh "groups" axis {rows}; '
            "pad with empty groups"
        )
    per = g // rows
    first = mesh.devices[0]
    outs = []
    for gi, (c, a) in enumerate(_groups(clusters, apps)):
        row = mesh.grid[gi // per]
        out = node_sharded_fifo_pack(
            shard_cluster(row, c), a, fill=fill, emax=emax, num_zones=num_zones,
        )
        outs.append(BatchedPacking(*(t.to(first) for t in out)))
    return BatchedPacking(*(torch.stack(x) for x in zip(*outs)))


def grouped_fifo_pack_auto(
    mesh: SolverMesh,
    clusters: ClusterTensors,  # fields stacked [G, N, ...]
    apps: AppBatch,  # fields stacked [G, B, ...]
    *,
    fill: str = "tightly-pack",
    emax: int,
    num_zones: int,
) -> BatchedPacking:
    """JAX's routing (:205-273): a groups-only mesh of several devices on a
    plain queue takes the queue kernel per device
    (`grouped_queue_sharded`); a one-device mesh on a plain queue the
    single-launch `grouped_fifo_pack` on that device; anything else the
    2-D route. The port has no Mosaic gate: on a card the kernel runs or
    raises, and on CPU tensors every route is the plain version."""
    eligible = fifo_eligible(apps, fill)
    if (
        mesh.size > 1
        and mesh.shape["groups"] == mesh.size
        and clusters.available.shape[0] % mesh.size == 0
        and eligible
    ):
        return grouped_queue_sharded(
            mesh, clusters, apps, fill=fill, emax=emax, num_zones=num_zones
        )
    if mesh.size == 1 and eligible:
        dev = mesh.devices[0]
        return grouped_fifo_pack(
            ClusterTensors(*(f.to(dev) for f in clusters.fields())),
            _group_apps(apps, 0, clusters.available.shape[0], dev),
            fill=fill, emax=emax, num_zones=num_zones,
        )
    return grouped_sharded_fifo_pack(
        mesh, clusters, apps, fill=fill, emax=emax, num_zones=num_zones
    )
