"""The strategy table and the packing helpers the window path needs, from
spark_scheduler_tpu/ops/packing.py. The closed-form fills of the solo
`pack()` path are not part of the port yet."""

from __future__ import annotations

import torch

# Strategy names (internal/extender/binpack.go:21-54): the keys of the JAX
# package's BINPACK_FUNCTIONS, in the same order.
BINPACK_STRATEGIES = (
    "tightly-pack",
    "distribute-evenly",
    "minimal-fragmentation",
    "single-az-tightly-pack",
    "single-az-minimal-fragmentation",
    "az-aware-tightly-pack",
)
SINGLE_AZ_PACKERS = frozenset(
    {"single-az-tightly-pack", "single-az-minimal-fragmentation"}
)
DEFAULT_BINPACK = "tightly-pack"


def _rank_of_position(order: torch.Tensor) -> torch.Tensor:
    """rank[node] = position of node in `order` (int32)."""
    n = order.shape[0]
    rank = torch.zeros(n, dtype=torch.int32, device=order.device)
    rank[order.long()] = torch.arange(n, dtype=torch.int32, device=order.device)
    return rank


def _check_cumsum_bound(n: int, emax: int) -> None:
    """Guard int32 accumulators bounded by n*emax (prefix sums, and the
    distribute-evenly key `placed * n + rank`) instead of overflowing
    silently. Clusters beyond this bound must shard the node axis."""
    if n * emax >= 2**31:
        raise ValueError(
            f"n_nodes*emax = {n}*{emax} >= 2^31: int32 prefix sums would "
            "overflow; shard the node axis across devices instead of packing "
            "a single flat tensor"
        )
