"""Device placements for the solver's window-solve pool.

The port of spark_scheduler_tpu/parallel/mesh.py's `make_pool_slots`: a
pool slot is one device of the solver's type. The node-sharded slots of
the JAX package (a ("nodes",) sub-mesh per slot, `node_shards > 1`) are
not ported (ROADMAP §A.6) and raise.
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


def make_pool_slots(pool: int, node_shards: int = 1, devices=None) -> list:
    """Placements for the serving window-solve pool (core/solver.py):
    `pool` slots, slot k on device k of `devices` (default: every local
    device of the CUDA type).

    More slots than there are devices CLAMP to what exists, as in the JAX
    package (slot count is a throughput knob, not a correctness contract).
    `devices` may name one device several times: each entry is a slot of
    its own (several slots on one card, each with its own stream)."""
    if node_shards > 1:
        raise NotImplementedError(
            f"solver.mesh.node-shards={node_shards}: node-sharded pool slots "
            "are not ported (ROADMAP A.6)"
        )
    devices = [
        torch.device(d)
        for d in (devices if devices is not None else local_devices("cuda"))
    ]
    if not devices:
        raise ValueError("no device for the pool")
    return devices[: min(max(1, pool), len(devices))]
