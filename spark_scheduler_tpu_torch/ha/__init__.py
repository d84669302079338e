"""Active-active HA: lease-based leader election, warm standbys, sharding.

The reference's failover story (failover.go:35-72) assumes ONE extender
process whose restart is a leader change; this package makes the leader a
ROLE instead of a process:

  lease      a fenced lease record (epoch counter bumped on every
             takeover) renewed on a heartbeat; CAS through the backend's
             optimistic concurrency in-process, or an flock-guarded
             sidecar file for multi-process WAL deployments.
  fencing    `FencedBackend` — reservation/demand writes carry the
             holder's fencing epoch; a deposed leader's in-flight commit
             raises `FencingError` instead of double-placing.
  standby    `StandbyTailer` — replicas tail backend events so the
             reservation cache, usage tracker, and host feature store
             stay hot; promotion only needs the failover reconcile.
  shard      `ShardMap` — instance group -> owning replica (stable
             CRC32), the active-active traffic partition; per-group
             solves commute (instance-group domain partitioning), so sharded
             decisions are byte-identical per group to one replica.
  replica    `ReplicaRuntime` (role state machine: standby -> leader via
             `promote()`, heartbeat loop, /debug/ha surface) and
             `ShardedServingGroup` (N active replicas over one backend,
             wrong-shard requests forwarded to the owner).
"""

from spark_scheduler_tpu_torch.ha.lease import (  # noqa: F401
    BackendLeaseStore,
    FencingError,
    FileLeaseStore,
    LeaseManager,
    LeaseRecord,
)
from spark_scheduler_tpu_torch.ha.fencing import FencedBackend  # noqa: F401
from spark_scheduler_tpu_torch.ha.shard import ShardMap  # noqa: F401
from spark_scheduler_tpu_torch.ha.standby import StandbyTailer  # noqa: F401
from spark_scheduler_tpu_torch.ha.replica import (  # noqa: F401
    ReplicaRuntime,
    ShardedServingGroup,
)

__all__ = [
    "BackendLeaseStore",
    "FencedBackend",
    "FencingError",
    "FileLeaseStore",
    "LeaseManager",
    "LeaseRecord",
    "ReplicaRuntime",
    "ShardMap",
    "ShardedServingGroup",
    "StandbyTailer",
]
