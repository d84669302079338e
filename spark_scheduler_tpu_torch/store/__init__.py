"""Durable-state layer: object store, sharded write queue, async write-back,
write-through caches, and the pluggable cluster backend (the framework's
"apiserver"). Rebuilds the reference's internal/cache + internal/cache/store."""

from spark_scheduler_tpu_torch.store.object_store import ObjectStore  # noqa: F401
from spark_scheduler_tpu_torch.store.queue import ShardedUniqueQueue, Request, RequestType  # noqa: F401
from spark_scheduler_tpu_torch.store.backend import (  # noqa: F401
    ClusterBackend,
    InMemoryBackend,
    ConflictError,
    NotFoundError,
    AlreadyExistsError,
    NamespaceTerminatingError,
)
from spark_scheduler_tpu_torch.store.cache import (  # noqa: F401
    WriteThroughCache,
    ResourceReservationCache,
    DemandCache,
    SafeDemandCache,
)
