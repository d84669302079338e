"""Cluster state as torch tensors.

The port's counterpart of spark_scheduler_tpu/models/cluster.py: the same
dense `[N, 3]` int32 scheduling view over a stable node-index space, held as
torch tensors on an explicit device.

  available[N,3]    = allocatable - reservation usage - overhead
  schedulable[N,3]  = allocatable - overhead
  zone_id[N]        int32 zone of each node (registry-interned)
  name_rank[N]      lexicographic rank of the node name (sort tie-break,
                    sort/nodesorting.go:86-95)
  label_rank_*[N]   configured label-priority rank (lower = higher priority,
                    INT32_INF when the label/value is absent;
                    sort/nodesorting.go:160-185)
  unschedulable[N] / ready[N] / valid[N] bool masks

`NodeRegistry` owns the name <-> index interning host-side. Indices are stable
across node churn (freed slots are recycled and masked out via `valid`).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Mapping, Sequence

import numpy as np
import torch

from spark_scheduler_tpu_torch.models.kube import Node
from spark_scheduler_tpu_torch.models.resources import (
    INT32_INF,
    NUM_DIMS,
    Resources,
)

# Field dtypes in constructor order (cluster_from_numpy converts with these).
FIELD_DTYPES = (
    torch.int32,  # available
    torch.int32,  # schedulable
    torch.int32,  # zone_id
    torch.int32,  # name_rank
    torch.int32,  # label_rank_driver
    torch.int32,  # label_rank_executor
    torch.bool,  # unschedulable
    torch.bool,  # ready
    torch.bool,  # valid
)


@dataclasses.dataclass
class ClusterTensors:
    """The dense scheduling view consumed by ops/. All fields live on one
    device. The solver's builds also set a `host` attribute holding the
    numpy arrays the tensors were uploaded from, so host-side math
    (candidate masks, fetch reconstruction) never reads the device."""

    available: torch.Tensor  # [N,3] i32
    schedulable: torch.Tensor  # [N,3] i32
    zone_id: torch.Tensor  # [N] i32
    name_rank: torch.Tensor  # [N] i32
    label_rank_driver: torch.Tensor  # [N] i32
    label_rank_executor: torch.Tensor  # [N] i32
    unschedulable: torch.Tensor  # [N] bool
    ready: torch.Tensor  # [N] bool
    valid: torch.Tensor  # [N] bool

    @property
    def num_nodes(self) -> int:
        return int(self.available.shape[0])

    @property
    def device(self) -> torch.device:
        return self.available.device

    def fields(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def cluster_statics(cluster: ClusterTensors) -> tuple:
    """Every ClusterTensors field EXCEPT `available`, as a flat tuple, in
    constructor order (cluster_from_statics)."""
    return cluster.fields()[1:]


def cluster_from_statics(available, statics: tuple) -> ClusterTensors:
    """Rebuild a ClusterTensors from an availability tensor + the static
    tuple `cluster_statics` produced."""
    return ClusterTensors(available, *statics)


def cluster_from_numpy(fields: Sequence, device="cuda") -> ClusterTensors:
    """The port's ClusterTensors from the nine fields of a JAX-package
    ClusterTensors (numpy arrays, constructor order). Every field is COPIED
    (`torch.tensor`, never `torch.from_numpy`): an aliased availability
    buffer mutated by one side would be debited twice."""
    if len(fields) != len(FIELD_DTYPES):
        raise ValueError(
            f"expected {len(FIELD_DTYPES)} ClusterTensors fields, "
            f"got {len(fields)}"
        )
    return ClusterTensors(
        *(
            torch.tensor(np.asarray(f), dtype=dt, device=device)
            for f, dt in zip(fields, FIELD_DTYPES)
        )
    )


def check_cluster(cluster: ClusterTensors) -> None:
    """Raise unless every field has its dtype and shape ([N,3] or [N]) and
    lies on the cluster's device: what the CUDA kernels take as they are."""
    n = cluster.num_nodes
    for f, t, want in zip(
        dataclasses.fields(cluster), cluster.fields(), FIELD_DTYPES
    ):
        shape = (n, 3) if f.name in ("available", "schedulable") else (n,)
        if t.dtype != want or tuple(t.shape) != shape:
            raise ValueError(
                f"cluster.{f.name}: expected {want} {shape}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != cluster.device:
            raise ValueError(
                f"cluster.{f.name} is on {t.device}, expected {cluster.device}"
            )


def pad_bucket(n: int, minimum: int) -> int:
    """Power-of-two size bucketing (the solver pads its tensors with it)."""
    out = minimum
    while out < n:
        out *= 2
    return out


class NodeRegistry:
    """Host-side interning of node names and zone labels to stable indices.

    Interning is locked: two threads racing `intern` must never be handed
    the same index for different names."""

    def __init__(self):
        self._intern_lock = threading.Lock()
        self._index: dict[str, int] = {}
        self._names: list[str | None] = []
        self._free: list[int] = []
        self._zone_ids: dict[str, int] = {}
        self._zone_names: list[str] = []
        # Bumped on every name->index mapping change; lets derived artifacts
        # (candidate masks) cache against a stable mapping. Seqlock
        # discipline: bumped BEFORE and AFTER each mutation, so an odd value
        # means a mutation is in flight — lock-free readers must not cache
        # anything keyed on an odd epoch, and must re-check the epoch after
        # reading to detect a concurrent mutation.
        self._epoch = 0
        # Mapping-change journal: post-mutation EVEN epoch ->
        # [("add"|"remove", name, row)]. Bounded; a missing epoch sends the
        # consumer to a full rebuild.
        self._journal: dict[int, list] = {}
        # name -> bool, or None. A deleted node's row is recycled only
        # while it does not hold the name: the overhead computer sets it
        # (pods still bound to the name), so the node that next takes the
        # row inherits none of their requests.
        self.row_holder = None

    def _journal_put(self, entries: list) -> None:
        """Record one mutation's mapping changes (caller holds the lock;
        epoch is even again)."""
        self._journal[self._epoch] = entries
        while len(self._journal) > 128:
            self._journal.pop(next(iter(self._journal)))

    def journal_between(self, e0: int, e1: int):
        """Concatenated mapping changes over the even epochs in (e0, e1],
        oldest first — or None when any epoch is missing."""
        if e1 < e0 or (e1 - e0) % 2 or e1 - e0 > 256:
            return None
        out: list = []
        for e in range(e0 + 2, e1 + 1, 2):
            ent = self._journal.get(e)
            if ent is None:
                return None
            out.extend(ent)
        return out

    @property
    def epoch(self) -> int:
        return self._epoch

    def _alloc_locked(self, name: str) -> int:
        """Assign a slot to a NEW name. Caller holds the intern lock and
        has already bumped the epoch odd."""
        if self._free:
            idx = self._free.pop()
            self._names[idx] = name
        else:
            idx = len(self._names)
            self._names.append(name)
        self._index[name] = idx
        return idx

    def intern(self, name: str) -> int:
        with self._intern_lock:
            idx = self._index.get(name)
            if idx is None:
                self._epoch += 1  # odd: mapping unstable
                idx = self._alloc_locked(name)
                self._epoch += 1  # even: stable again
                self._journal_put([("add", name, idx)])
            return idx

    def intern_many(self, names) -> np.ndarray:
        """Bulk intern under one lock hold. Returns the int32 registry row
        of each name, in input order."""
        with self._intern_lock:
            index = self._index
            missing = [n for n in names if n not in index]
            if missing:
                self._epoch += 1  # odd: mapping unstable
                added = []
                for n in missing:
                    if n not in index:  # duplicate within `missing`
                        added.append(("add", n, self._alloc_locked(n)))
                self._epoch += 1  # even: stable again
                self._journal_put(added)
            return np.fromiter(
                (index[n] for n in names), np.int32, count=len(names)
            )

    def remove(self, name: str) -> None:
        with self._intern_lock:
            if name not in self._index:
                return
            self._epoch += 1  # odd: mapping unstable
            idx = self._index.pop(name)
            self._names[idx] = None
            self._free.append(idx)
            self._epoch += 1  # even: stable again
            self._journal_put([("remove", name, idx)])

    def index_of(self, name: str) -> int | None:
        return self._index.get(name)

    def read_consistent(self, fn):
        """Run `fn()` under the intern lock: a name->index view guaranteed
        stable for the duration."""
        with self._intern_lock:
            return fn()

    def name_of(self, idx: int) -> str | None:
        if 0 <= idx < len(self._names):
            return self._names[idx]
        return None

    def zone_id(self, zone: str) -> int:
        with self._intern_lock:
            zid = self._zone_ids.get(zone)
            if zid is None:
                zid = len(self._zone_names)
                self._zone_ids[zone] = zid
                self._zone_names.append(zone)
            return zid

    @property
    def num_zones(self) -> int:
        return len(self._zone_names)

    @property
    def capacity(self) -> int:
        return len(self._names)

    def names(self) -> list[str | None]:
        return list(self._names)


def resources_map_to_tensor(
    usage: Mapping[str, Resources], registry: NodeRegistry, num_nodes: int
) -> np.ndarray:
    """[N,3] int32 array from a {node name: Resources} map."""
    out = np.zeros((num_nodes, NUM_DIMS), dtype=np.int64)
    for name, res in usage.items():
        idx = registry.index_of(name)
        if idx is not None and idx < num_nodes:
            out[idx] += res.as_array()
    return np.clip(out, -INT32_INF, INT32_INF).astype(np.int32)


def _fit_rows(arr: np.ndarray, n_slots: int) -> np.ndarray:
    """Pad/truncate a dense [cap, 3] array to n_slots rows (rows past the
    registry capacity can only be unused zeros)."""
    if arr.shape[0] < n_slots:
        return np.pad(arr, ((0, n_slots - arr.shape[0]), (0, 0)))
    return arr[:n_slots]


def build_host_tensors(
    nodes: list[Node],
    usage: np.ndarray | Mapping[str, Resources],
    overhead: np.ndarray | Mapping[str, Resources],
    registry: NodeRegistry,
    *,
    driver_label_priority: tuple[str, list[str]] | None = None,
    executor_label_priority: tuple[str, list[str]] | None = None,
    pad_to: int | None = None,
) -> ClusterTensors:
    """The dense scheduling view for a set of live nodes as numpy arrays
    (a ClusterTensors of fresh host arrays, nothing on a device).

    Mirrors `NodeSchedulingMetadataForNodes` (resources.go:61-100):
      available   = allocatable - usage - overhead
      schedulable = allocatable - overhead
    plus the priority inputs of sort/nodesorting.go. `pad_to` rounds N up.
    """
    for n in nodes:
        registry.intern(n.name)
    n_slots = registry.capacity
    if pad_to is not None:
        n_slots = max(n_slots, pad_to)

    if not isinstance(usage, np.ndarray):
        usage = resources_map_to_tensor(usage, registry, n_slots)
    if not isinstance(overhead, np.ndarray):
        overhead = resources_map_to_tensor(overhead, registry, n_slots)

    alloc = np.zeros((n_slots, NUM_DIMS), dtype=np.int64)
    zone_id = np.zeros(n_slots, dtype=np.int32)
    unschedulable = np.zeros(n_slots, dtype=bool)
    ready = np.zeros(n_slots, dtype=bool)
    valid = np.zeros(n_slots, dtype=bool)
    name_rank = np.full(n_slots, INT32_INF, dtype=np.int32)
    lr_driver = np.full(n_slots, INT32_INF, dtype=np.int32)
    lr_executor = np.full(n_slots, INT32_INF, dtype=np.int32)

    live = sorted(nodes, key=lambda n: n.name)
    for rank, node in enumerate(live):
        idx = registry.intern(node.name)
        alloc[idx] = node.allocatable.as_array()
        zone_id[idx] = registry.zone_id(node.zone)
        unschedulable[idx] = node.unschedulable
        ready[idx] = node.ready
        valid[idx] = True
        name_rank[idx] = rank
        for target, prio in (
            (lr_driver, driver_label_priority),
            (lr_executor, executor_label_priority),
        ):
            if prio is not None:
                label, values = prio
                val = node.labels.get(label)
                if val is not None and val in values:
                    target[idx] = values.index(val)

    usage = _fit_rows(usage, n_slots)
    overhead = _fit_rows(overhead, n_slots)
    available = np.clip(
        alloc - usage.astype(np.int64) - overhead.astype(np.int64),
        -INT32_INF,
        INT32_INF,
    ).astype(np.int32)
    schedulable = np.clip(
        alloc - overhead.astype(np.int64), -INT32_INF, INT32_INF
    ).astype(np.int32)

    return ClusterTensors(
        available=available,
        schedulable=schedulable,
        zone_id=zone_id,
        name_rank=name_rank,
        label_rank_driver=lr_driver,
        label_rank_executor=lr_executor,
        unschedulable=unschedulable,
        ready=ready,
        valid=valid,
    )


def host_view(cluster: ClusterTensors) -> ClusterTensors:
    """The numpy arrays behind `cluster`: its `host` attribute when
    a build set one, else a device-to-host copy."""
    host = getattr(cluster, "host", None)
    if host is not None:
        return host
    return ClusterTensors(*(t.cpu().numpy() for t in cluster.fields()))
