"""Batched FIFO gang admission: the queue's data types and its orders, the
port's counterpart of spark_scheduler_tpu/ops/batched.py.

A FIFO-sorted queue of B apps is one batch (`AppBatch`); admission walks it
in order, carrying the cluster availability from app to app, and returns a
`BatchedPacking`. Only QUEUE mode is served: every app sees the same
eligibility, and the node priority orders are computed once from the
starting availability and reused for every app (`queue_mode_orders`,
fitEarlierDrivers semantics, resource.go:221-258). Batches with per-app
masks (`driver_cand`/`domain`) or window rows (`commit`/`reset`) are
refused by the solve (ops/fifo.py); the serving windows have their own
path (ops/window.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spark_scheduler_tpu_torch.models.cluster import ClusterTensors
from spark_scheduler_tpu_torch.ops.packing import _rank_of_position
from spark_scheduler_tpu_torch.ops.sorting import priority_order, zone_ranks


class AppBatch(NamedTuple):
    """FIFO-ordered queue of gang requests (one row per Spark application),
    already sorted by creation time (sparkpods.go:60-77). Rows past the real
    queue length are padding with `app_valid=False`.

    `make_app_batch` builds one of host numpy arrays; `app_batch_to_device`
    carries one (this package's or the JAX package's) onto a device as torch
    tensors, which is what the solve takes. The optional masks and window
    rows keep the JAX package's fields; the queue solve refuses them."""

    driver_req: object  # [B, 3] i32 — driver request
    exec_req: object  # [B, 3] i32 — executor request
    exec_count: object  # [B] i32 — gang size (min executors)
    app_valid: object  # [B] bool — padding mask
    skippable: object  # [B] bool — FIFO age-based skip (resource.go:260-270)
    driver_cand: object = None  # [B, N] bool — kube candidate list
    domain: object = None  # [B, N] bool — node-affinity domain
    commit: object = None  # [B] bool — window mode: request rows
    reset: object = None  # [B] bool — window mode: segment-start rows


class BatchedPacking(NamedTuple):
    """Per-app gang placement for the whole queue."""

    driver_node: torch.Tensor  # [B] i32, -1 = not admitted
    executor_nodes: torch.Tensor  # [B, Emax] i32, -1 = padding / not admitted
    admitted: torch.Tensor  # [B] bool — packed AND not FIFO-blocked
    packed: torch.Tensor  # [B] bool — would fit, ignoring FIFO blocking
    available_after: torch.Tensor  # [N, 3] i32 — availability after all admits


# dtype of each AppBatch field on the device.
APP_DTYPES = (
    torch.int32, torch.int32, torch.int32, torch.bool, torch.bool,
    torch.bool, torch.bool, torch.bool, torch.bool,
)


def queue_mode_orders(cluster: ClusterTensors, num_zones: int):
    """Queue-mode eligibility + priority orders, fixed from the starting
    availability. Driver and executor eligibility are both
    `valid & ~unschedulable & ready` (no kube candidate filter in queue
    mode), and the zones are ranked over `domain = cluster.valid`.

    Returns (driver_elig, exec_elig, d_order, d_rank, e_order, zrank)."""
    domain0 = cluster.valid
    exec_elig = domain0 & ~cluster.unschedulable & cluster.ready
    driver_elig = exec_elig
    zrank = zone_ranks(cluster, domain0, num_zones)
    d_order, _ = priority_order(
        cluster, driver_elig, zrank, cluster.label_rank_driver
    )
    e_order, _ = priority_order(
        cluster, exec_elig, zrank, cluster.label_rank_executor
    )
    d_rank = _rank_of_position(d_order)
    return driver_elig, exec_elig, d_order, d_rank, e_order, zrank


def make_app_batch(
    driver_reqs,  # [B,3] array-like
    exec_reqs,  # [B,3] array-like
    exec_counts,  # [B] array-like
    *,
    pad_to: int | None = None,
    skippable=None,
    driver_cand=None,  # [B,N] bool — per-app kube candidate masks
    domain=None,  # [B,N] bool — per-app node-affinity domains
    commit=None,  # [B] bool — window mode: request rows (persist into base)
    reset=None,  # [B] bool — window mode: segment-start rows
) -> AppBatch:
    """Host helper: pad a queue to a bucketed batch size (numpy arrays).
    Padding rows are `app_valid=False` with all-zero requests and all-False
    masks."""
    driver_reqs = np.asarray(driver_reqs, np.int32)
    exec_reqs = np.asarray(exec_reqs, np.int32)
    exec_counts = np.asarray(exec_counts, np.int32)
    b = driver_reqs.shape[0]
    if skippable is None:
        skippable = np.zeros(b, bool)
    else:
        skippable = np.asarray(skippable, bool)
    pad = max(pad_to or b, b)
    valid = np.zeros(pad, bool)
    valid[:b] = True

    def _pad_mask(m):
        if m is None:
            return None
        return np.pad(np.asarray(m, bool), ((0, pad - b), (0, 0)))

    def _pad_flag(v):
        if v is None:
            return None
        return np.pad(np.asarray(v, bool), (0, pad - b))

    if (commit is None) != (reset is None):
        # A commit default of True on hypothetical rows would double-subtract
        # them; refuse partial window arguments.
        raise ValueError("window mode requires commit AND reset together")
    return AppBatch(
        driver_req=np.pad(driver_reqs, ((0, pad - b), (0, 0))),
        exec_req=np.pad(exec_reqs, ((0, pad - b), (0, 0))),
        exec_count=np.pad(exec_counts, (0, pad - b)),
        app_valid=valid,
        skippable=np.pad(skippable, (0, pad - b)),
        driver_cand=_pad_mask(driver_cand),
        domain=_pad_mask(domain),
        commit=_pad_flag(commit),
        reset=_pad_flag(reset),
    )


def app_batch_to_device(apps, device="cuda") -> AppBatch:
    """This package's AppBatch of torch tensors on `device`, from any batch
    with the AppBatch fields (numpy arrays, e.g. the JAX package's
    `make_app_batch`, or tensors). Every field is COPIED (`torch.tensor`,
    never `torch.from_numpy`), so the caller's arrays are never aliased."""
    out = []
    for field, dtype in zip(AppBatch._fields, APP_DTYPES):
        v = getattr(apps, field, None)
        if v is None:
            out.append(None)
        elif isinstance(v, torch.Tensor):
            out.append(v.to(device=device, dtype=dtype, copy=True))
        else:
            out.append(torch.tensor(np.asarray(v), dtype=dtype, device=device))
    return AppBatch(*out)
