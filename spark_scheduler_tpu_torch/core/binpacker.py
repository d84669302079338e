"""Binpacker registry (internal/extender/binpack.go:21-54): checks the
configured algorithm name against the strategy table and flags single-AZ
packers (which gate zone-scoped demands + same-AZ dynamic allocation). The
port's copy of spark_scheduler_tpu/core/binpacker.py."""

from __future__ import annotations

import dataclasses

from spark_scheduler_tpu_torch.ops.packing import BINPACK_STRATEGIES, SINGLE_AZ_PACKERS

AZ_AWARE_TIGHTLY_PACK = "az-aware-tightly-pack"
SINGLE_AZ_TIGHTLY_PACK = "single-az-tightly-pack"
SINGLE_AZ_MINIMAL_FRAGMENTATION = "single-az-minimal-fragmentation"
TIGHTLY_PACK = "tightly-pack"
DISTRIBUTE_EVENLY = "distribute-evenly"
MINIMAL_FRAGMENTATION = "minimal-fragmentation"


@dataclasses.dataclass(frozen=True)
class Binpacker:
    name: str
    is_single_az: bool


def select_binpacker(name: str) -> Binpacker:
    """Resolve a configured algorithm name to its packer.

    The reference silently falls back to tightly-pack on an unknown name
    (binpack.go:47-54); here a typo'd config string raises an
    `UnknownStrategyError` listing the valid names — the same error shape
    the policy plug-board uses (policy/registry.py)."""
    from spark_scheduler_tpu_torch.policy.registry import resolve

    resolve(name, dict.fromkeys(BINPACK_STRATEGIES), "binpack algorithm")
    return Binpacker(name=name, is_single_az=name in SINGLE_AZ_PACKERS)
