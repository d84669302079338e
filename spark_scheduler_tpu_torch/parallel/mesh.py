"""Device meshes for the solver, and the placements of its window-solve pool.

The port of spark_scheduler_tpu/parallel/mesh.py. Axes:

  "groups" — data parallelism over independent instance-group subproblems
             (failover.go:276-313 groups nodes by the instance-group label,
             so each group's admission is independent);
  "nodes"  — sharding of the node axis of one large subproblem: the
             elementwise capacity work stays on each shard, the reductions
             and sorts cross shards (parallel/node_shards.py).

A mesh is a grid of named `torch.device`s. The port's deliberate deviation
from the JAX package: a device list may name one device several times, so
several shards (or pool slots) share one card, each on a CUDA stream of its
own. On one card that drives every cross-shard code path; with several
cards the same mesh lays the shards on distinct cards.
"""

from __future__ import annotations

import torch


def local_devices(device_type: str) -> list[torch.device]:
    """Every device of `device_type` this process sees: each card for
    "cuda", the one host device for "cpu"."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device type {device_type!r}")


class SolverMesh:
    """A [groups, nodes] grid of devices (repeats allowed), with the JAX
    Mesh's `shape` dict, its flat `devices` (row-major) and `size`."""

    def __init__(self, grid):
        grid = [[torch.device(d) for d in row] for row in grid]
        if not grid or not grid[0] or len({len(r) for r in grid}) != 1:
            raise ValueError("a mesh is a non-empty rectangular device grid")
        self.grid = grid
        self.shape = {"groups": len(grid), "nodes": len(grid[0])}

    @property
    def devices(self) -> list[torch.device]:
        return [d for row in self.grid for d in row]

    @property
    def size(self) -> int:
        return self.shape["groups"] * self.shape["nodes"]

    @property
    def label(self) -> str:
        """`cuda:0-3` as the JAX slot labels a sub-mesh: the type and the
        first and last device index (`cpu:0-0` for shards on the host)."""
        first, last = self.devices[0], self.devices[-1]
        return f"{first.type}:{first.index or 0}-{last.index or 0}"

    def __repr__(self) -> str:
        return f"SolverMesh({self.shape}, {[str(d) for d in self.devices]})"


def make_solver_mesh(
    n_groups: int | None = None,
    n_nodes_shards: int | None = None,
    devices=None,
) -> SolverMesh:
    """Build a ("groups", "nodes") mesh over `devices` (default: every
    local card). With neither axis size given, every device goes to
    "nodes"; the axis sizes must multiply to the device count."""
    devices = [
        torch.device(d)
        for d in (devices if devices is not None else local_devices("cuda"))
    ]
    d = len(devices)
    if n_groups is None and n_nodes_shards is None:
        n_groups, n_nodes_shards = 1, d
    elif n_groups is None:
        n_groups = d // n_nodes_shards
    elif n_nodes_shards is None:
        n_nodes_shards = d // n_groups
    if n_groups * n_nodes_shards != d or d == 0:
        raise ValueError(f"mesh {n_groups}x{n_nodes_shards} != {d} devices")
    return SolverMesh([
        devices[g * n_nodes_shards:(g + 1) * n_nodes_shards]
        for g in range(n_groups)
    ])


def make_pool_slots(pool: int, node_shards: int = 1, devices=None) -> list:
    """Placements for the serving window-solve pool (core/solver.py):
    `pool` slots, each either one device (node_shards == 1) or a
    ("nodes",) sub-mesh of `node_shards` devices. Slot k gets devices
    [k*S, (k+1)*S) of the flat list (default: every local card), the
    row-major layout of `make_solver_mesh`.

    More slots than the devices hold CLAMP to what exists, as in the JAX
    package (slot count is a throughput knob, not a correctness contract);
    node shards beyond the devices raise. `devices` may name one device
    several times: each entry is a slot (or a shard) of its own, with its
    own stream."""
    devices = [
        torch.device(d)
        for d in (devices if devices is not None else local_devices("cuda"))
    ]
    node_shards = max(1, node_shards)
    usable = len(devices) // node_shards
    if usable < 1:
        raise ValueError(
            f"mesh node-shards {node_shards} exceeds the {len(devices)} "
            "available devices"
        )
    pool = min(max(1, pool), usable)
    if node_shards == 1:
        return devices[:pool]
    return [
        SolverMesh([devices[k * node_shards:(k + 1) * node_shards]])
        for k in range(pool)
    ]
