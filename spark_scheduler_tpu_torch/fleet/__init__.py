"""Fleet federation: many clusters behind one scheduler facade — the
port's copy of spark_scheduler_tpu/fleet. Each cluster stack's solver runs
on the facade's device (the card unless `device="cpu"`).

Two-level placement (ROADMAP item 4): a FleetFacade owns F fully
independent per-cluster solver stacks running concurrently, a FleetRouter
picks the home cluster in O(F) from resident ClusterAggregates, and a
SpilloverCoordinator retries capacity-denied drivers on the best sibling.
Per-cluster decisions stay byte-identical to a standalone cluster —
`verify_cluster_equivalence` is the mechanical oracle.
"""

from spark_scheduler_tpu_torch.fleet.aggregates import ClusterAggregates  # noqa: F401
from spark_scheduler_tpu_torch.fleet.dispatch import (  # noqa: F401
    FleetDispatchCoordinator,
)
from spark_scheduler_tpu_torch.fleet.facade import (  # noqa: F401
    ClusterStack,
    FleetFacade,
    replay_standalone,
    verify_cluster_equivalence,
)
from spark_scheduler_tpu_torch.fleet.router import FleetRouter  # noqa: F401
from spark_scheduler_tpu_torch.fleet.spillover import (  # noqa: F401
    FleetDecision,
    SpilloverCoordinator,
)

__all__ = [
    "ClusterAggregates",
    "ClusterStack",
    "FleetDecision",
    "FleetDispatchCoordinator",
    "FleetFacade",
    "FleetRouter",
    "SpilloverCoordinator",
    "replay_standalone",
    "verify_cluster_equivalence",
]
