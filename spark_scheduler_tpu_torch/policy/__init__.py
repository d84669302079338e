"""Policy subsystem: priority tiers, vectorized preemption search, DRF
window ordering, and a pool-driven continuous defragmenter.

Everything here is default-off: `build_scheduler_app` only constructs a
`PolicyEngine` when `InstallConfig.policy_enabled` is set, and every hook in
the extender takes the exact pre-policy branch when the engine is absent —
the FIFO path stays byte-identical.

The port's copy of spark_scheduler_tpu/policy/__init__.py.
"""

from spark_scheduler_tpu_torch.policy.engine import PolicyConfig, PolicyEngine  # noqa: F401
from spark_scheduler_tpu_torch.policy.priority import (  # noqa: F401
    PRIORITY_CLASS_ANNOTATION,
    PRIORITY_CLASSES,
    effective_priority,
    pod_priority,
)
from spark_scheduler_tpu_torch.policy.registry import UnknownStrategyError, resolve  # noqa: F401
