"""Kubernetes list+watch ingestion (the reference's informer slot, L3).

The reference learns cluster state from apiserver watch streams through
client-go SharedInformerFactory (cmd/server.go:111-147) and ships fake
clientsets for tests. This package provides the same boundary natively:

  - `FakeKubeAPIServer` — an in-process HTTP server speaking the k8s REST
    list/watch subset (resourceVersions, chunked watch streams, 410 Gone),
    the stand-in for both the real apiserver and client-go's fakes;
  - `Reflector` — list-then-watch with resourceVersion resume, relist on
    410/expiry, per-kind decode;
  - `KubeIngestion` — reflectors for nodes + pods applying into a
    `ClusterBackend`, with informer-delay measurement
    (internal/metrics/informer.go:28-51).
"""

from spark_scheduler_tpu_torch.kube.apiserver import FakeKubeAPIServer
from spark_scheduler_tpu_torch.kube.backend import KubeBackend, RestClient, TokenBucket
from spark_scheduler_tpu_torch.kube.reflector import (
    BackendSyncTarget,
    KubeIngestion,
    Reflector,
    in_cluster_ingestion,
)

__all__ = [
    "FakeKubeAPIServer",
    "KubeBackend",
    "RestClient",
    "TokenBucket",
    "Reflector",
    "BackendSyncTarget",
    "KubeIngestion",
    "in_cluster_ingestion",
]
