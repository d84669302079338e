"""Multi-device solves, the port of spark_scheduler_tpu/parallel/: device
meshes and pool placements (mesh.py), the node-sharded engine
(node_shards.py), the grouped route (ops/fifo.py `grouped_fifo_pack`) and
the group-sharded, node-sharded and 2-D routes (solve.py). The first eight
names are the JAX package's `__all__`."""

from spark_scheduler_tpu_torch.ops.fifo import (
    grouped_fifo_pack,
    grouped_fifo_pack_reference,
)
from spark_scheduler_tpu_torch.parallel.mesh import (
    SolverMesh,
    local_devices,
    make_pool_slots,
    make_solver_mesh,
)
from spark_scheduler_tpu_torch.parallel.node_shards import (
    node_sharded_fifo_pack,
    shard_cluster,
)
from spark_scheduler_tpu_torch.parallel.solve import (
    grouped_fifo_pack_auto,
    grouped_queue_sharded,
    grouped_sharded_fifo_pack,
    node_sharding,
    shard_apps,
    sharded_fifo_pack,
    stack_groups,
)

__all__ = [
    "make_pool_slots",
    "make_solver_mesh",
    "node_sharding",
    "shard_apps",
    "sharded_fifo_pack",
    "grouped_fifo_pack",
    "grouped_fifo_pack_auto",
    "stack_groups",
    "SolverMesh",
    "local_devices",
    "node_sharded_fifo_pack",
    "shard_cluster",
    "grouped_fifo_pack_reference",
    "grouped_queue_sharded",
    "grouped_sharded_fifo_pack",
]
