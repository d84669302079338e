"""Batched FIFO gang admission, the port's counterpart of
spark_scheduler_tpu/ops/batched.py.

A FIFO-sorted queue of B apps is one batch (`AppBatch`). `batched_fifo_pack`
admits it in order, carrying the cluster availability from app to app: each
step is one vectorized gang pack (the semantics of ops/packing.py
`pack_one_app`, or of the single-AZ pack), and an admitted gang's usage is
subtracted before the next app packs (resource.go:251-255). A valid, non-skippable app that fails
blocks every later app (strict FIFO, resource.go:241-249).

Three modes, as in the JAX package:

  queue: no per-app masks; every app sees the same eligibility and the node
      priority orders are computed once from the starting availability
      (`queue_mode_orders`, fitEarlierDrivers semantics,
      resource.go:221-258);
  masked: per-app `driver_cand` / `domain`; each row packs as a standalone
      `spark_bin_pack` with its masks against the then-current availability
      (orders re-sorted every row);
  window: `commit` / `reset` rows; each serving request is a segment (its
      FIFO-earlier hypothetical rows, then its committing row), sorted once
      at its reset row from the committed base (resource.go:299).

The JAX package's `lax.scan` is a Python loop over rows here, with the carry
as tensors on the cluster's device; the loop reads only the host copies of
the row flags, never a device result, so on the card it queues its work
without synchronising. It is the XLA program's counterpart and runs on the
CPU and the card alike, as the one-shard case of the node-sharded engine
(parallel/node_shards.py); the serving path uses the row-walk kernel
(ops/window.py) and the queue kernel (ops/fifo.py) instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spark_scheduler_tpu_torch.models.cluster import (
    ClusterTensors,
    cluster_from_statics,
)
from spark_scheduler_tpu_torch.ops.sorting import (
    _rank_of_position,
    priority_orders,
    zone_ranks,
)

# Single-AZ strategies run the per-zone pack + efficiency-scored zone pick
# inside the step; az-aware additionally computes the plain fallback
# (az_aware_pack_tightly.go:27-38). Values are the inner executor fill.
_SINGLE_AZ_INNER = {
    "single-az-tightly-pack": "tightly-pack",
    "single-az-minimal-fragmentation": "minimal-fragmentation",
    "az-aware-tightly-pack": "tightly-pack",
}


class AppBatch(NamedTuple):
    """FIFO-ordered queue of gang requests (one row per Spark application),
    already sorted by creation time (sparkpods.go:60-77). Rows past the real
    queue length are padding with `app_valid=False`.

    `make_app_batch` builds one of host numpy arrays; `app_batch_to_device`
    carries one (this package's or the JAX package's) onto a device as torch
    tensors. `driver_cand` / `domain` select masked mode and `commit` /
    `reset` window mode (module docstring); the queue kernel (ops/fifo.py)
    refuses both. A fused multi-window batch (`fuse_app_batches`) is an
    ordinary window batch: a window boundary is a segment boundary, and the
    committed base carries across it as `available_after` would between
    sequential dispatches."""

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
    d_order, e_order = priority_orders(cluster, driver_elig, exec_elig, zrank)
    d_rank = _rank_of_position(d_order)
    return driver_elig, exec_elig, d_order, d_rank, e_order, zrank


def _device_zone_base(zone_base, dev):
    if zone_base is None:
        return None
    *limbs, present = zone_base
    return tuple(
        torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
        if not isinstance(x, torch.Tensor) else x.to(dev, torch.int32)
        for x in limbs
    ) + (torch.as_tensor(present, dtype=torch.bool, device=dev),)


def batched_fifo_pack(
    cluster: ClusterTensors,
    apps: AppBatch,
    *,
    fill: str = "tightly-pack",
    emax: int,
    num_zones: int,
    zone_base: tuple | None = None,
) -> BatchedPacking:
    """Admit a FIFO queue of gang requests (module docstring for the three
    modes). `apps` may hold numpy arrays or tensors; they are copied onto
    the cluster's device.

    `emax` is the executor-slot padding: a gang of more than `emax`
    executors never packs. Strict FIFO: once a valid, non-skippable app
    fails to pack, every later app (in window mode: of its segment) is
    rejected, but its hypothetical packing is still reported in `packed`.
    Window mode replicates fitEarlierDrivers exactly, including its
    double-count of an admitted-but-unbound earlier driver: hypothetical
    rows subtract only within their segment, while a committing row's
    admission persists into the base the next segment starts from.

    All six strategies run in every mode; the single-AZ wrappers score their
    zones against the then-current availability. `zone_base` (candidate
    pruning): constant per-zone sum offsets of rows left out of a gathered
    sub-cluster, forwarded to every `zone_ranks` call. Plain fills only: the
    single-AZ zone scores depend on the subset.

    `available_after` is a new tensor (the committed base in window mode);
    `cluster.available` is left as it was.

    It is the one-shard case of the node-sharded engine
    (parallel/node_shards.py `node_sharded_fifo_pack`), so one code path
    holds the batched packing semantics, sharded or not. Window mode's
    first valid row must be a reset row (the JAX scan would pack it
    against placeholder orders; here it raises)."""
    # parallel/node_shards.py imports this module.
    from spark_scheduler_tpu_torch.parallel.node_shards import (
        node_sharded_fifo_pack,
    )

    dev = cluster.device
    return node_sharded_fifo_pack(
        [cluster], apps, fill=fill, emax=emax, num_zones=num_zones,
        zone_base=zone_base,
        streams=[torch.cuda.current_stream(dev)] if dev.type == "cuda" else None,
    )


def batched_fifo_pack_carry(
    available: torch.Tensor,
    statics: tuple,
    apps: AppBatch,
    *,
    fill: str = "tightly-pack",
    emax: int,
    num_zones: int,
) -> BatchedPacking:
    """`batched_fifo_pack` with the availability carry split out:
    `statics` is `models.cluster.cluster_statics(cluster)`, the resident
    fields. A caller threading the committed base across back-to-back
    windows passes each call's `available_after` to the next. The JAX
    package donates `available` to reuse its buffer; here the input is left
    as it was and `available_after` is a new tensor."""
    return batched_fifo_pack(
        cluster_from_statics(available, statics), apps,
        fill=fill, emax=emax, num_zones=num_zones,
    )


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


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def fuse_app_batches(batches, *, pad_to: int | None = None) -> AppBatch:
    """Concatenate K window batches into ONE window batch, the ops-layer
    contract of the fused multi-window dispatch (core/solver.py
    `pack_windows_dispatch`).

    The fused batch's decisions equal those of the K batches run one after
    another with `available_after` threaded between them: a window boundary
    is a segment boundary (the next window's first row resets to the base
    the previous window committed), FIFO blocking is segment-local, and the
    orders are sorted per segment. Each batch's padding rows
    (app_valid=False) are dropped before concatenation and the fused batch
    is padded once, to `pad_to`.

    Every batch must be a window batch (commit/reset set) over one node
    axis; batches without masks get all-true ones when another batch
    carries them (what the engine assumes for a missing mask)."""
    if not batches:
        raise ValueError("fuse_app_batches requires at least one batch")
    n = None
    for b in batches:
        if b.commit is None or b.reset is None:
            raise ValueError("fuse_app_batches requires segmented window batches")
        for m in (b.driver_cand, b.domain):
            if m is not None:
                m_n = _host(m).shape[1]
                if n is None:
                    n = m_n
                elif n != m_n:
                    raise ValueError("node axes differ across batches")
    any_cand = any(b.driver_cand is not None for b in batches)
    any_dom = any(b.domain is not None for b in batches)

    def real(b, field):
        sel = np.flatnonzero(_host(b.app_valid))
        arr = getattr(b, field)
        if arr is None:
            return np.ones((len(sel), n), bool)
        return _host(arr)[sel]

    def cat(field):
        return np.concatenate([real(b, field) for b in batches])

    return make_app_batch(
        cat("driver_req"),
        cat("exec_req"),
        cat("exec_count"),
        pad_to=pad_to,
        skippable=cat("skippable"),
        driver_cand=cat("driver_cand") if any_cand else None,
        domain=cat("domain") if any_dom else None,
        commit=cat("commit"),
        reset=cat("reset"),
    )


# -- stacked solves (replay sweep arms, fleet clusters) ----------------------


def pad_app_batch(apps: AppBatch, pad_to: int) -> AppBatch:
    """Re-pad a host batch (numpy fields) to a LARGER row bucket: windows
    stacked into one solve must share the app axis, so every member grows
    to the group max. New rows are pure padding (app_valid=False,
    all-zero/False), what make_app_batch emits at the bigger bucket, so
    decisions cannot shift. Returns `apps` itself when it is already as
    large; the input arrays are never written."""
    b = np.asarray(apps.driver_req).shape[0]
    if pad_to <= b:
        return apps
    grow = pad_to - b

    def _rows(a):
        if a is None:
            return None
        a = np.asarray(a)
        return np.pad(a, [(0, grow)] + [(0, 0)] * (a.ndim - 1))

    return AppBatch(*(_rows(getattr(apps, f)) for f in AppBatch._fields))


def stack_app_batches(batches) -> AppBatch:
    """Stack M same-shape host batches along a new leading member axis
    ([M, B, ...]) for `bucket_stacked_fifo_pack`. Optional masks must be
    set on every member or on none: a mix raises."""

    def _stack(field):
        vals = [getattr(b, field) for b in batches]
        if all(v is None for v in vals):
            return None
        if any(v is None for v in vals):
            raise ValueError(
                f"cannot stack batches with mixed None-ness in {field!r}"
            )
        return np.stack([_host(v) for v in vals])

    return AppBatch(*(_stack(f) for f in AppBatch._fields))


def _packing_blob(out: BatchedPacking) -> torch.Tensor:
    """[B, 3 + emax] int32 in the window blob's column layout: driver,
    admitted, packed, executor slots."""
    return torch.cat(
        [
            out.driver_node[:, None],
            out.admitted[:, None].to(torch.int32),
            out.packed[:, None].to(torch.int32),
            out.executor_nodes,
        ],
        dim=1,
    )


def _stacked_solve(avail_stack, statics_of, apps_of, fills, emax, num_zones):
    if len(fills) != avail_stack.shape[0]:
        raise ValueError(
            f"fills ({len(fills)}) must match the member axis "
            f"({avail_stack.shape[0]})"
        )
    blobs, avails = [], []
    # A per-member loop: each member is solved on its own with its own
    # fill, so the JAX package's same-fill sub-stacks (a vmap needs one
    # static fill) have no counterpart here.
    for m, fill in enumerate(fills):
        out = batched_fifo_pack(
            cluster_from_statics(avail_stack[m], statics_of(m)),
            apps_of(m), fill=fill, emax=emax, num_zones=num_zones,
        )
        blobs.append(_packing_blob(out))
        avails.append(out.available_after)
    return torch.stack(blobs), torch.stack(avails)


def arm_stacked_fifo_pack(
    avail_stack: torch.Tensor,  # [M, N, 3] i32 — per-arm committed base
    statics: tuple,
    apps: AppBatch,
    *,
    fills: tuple,  # per-arm fill strategy
    emax: int,
    num_zones: int,
):
    """One window solved for M config arms in one call, the replay sweep's
    stacked solve. The window's app batch and statics are arm-invariant
    (node events are inputs, not decisions); only the availability carry
    differs per arm, so it stacks as `[M, N, 3]`.

    The JAX package's counterpart is an XLA program that vmaps each
    same-fill sub-stack. Here the members are solved in turn by
    `batched_fifo_pack` under their own fill, on the stack's device, with
    the app batch copied there once: the call stacks the results, not the
    work, so it costs M sequential solves and buys no speed. It is kept
    for the CPU deferred lane's parity with the JAX package. `avail_stack`
    is left as it was (the JAX package donates it).

    Returns `(blob, avail_after)`: `blob` `[M, B, 3+emax]` int32 in the
    window blob's column layout (driver, admitted, packed, exec slots),
    `avail_after` `[M, N, 3]`; arm m's rows equal a sequential
    `batched_fifo_pack` under `fills[m]`."""
    dev_apps = app_batch_to_device(apps, avail_stack.device)
    return _stacked_solve(
        avail_stack, lambda m: statics, lambda m: dev_apps, fills, emax,
        num_zones,
    )


def bucket_stacked_fifo_pack(
    avail_stack: torch.Tensor,  # [M, N, 3] i32 — per-cluster availability
    statics_stack: tuple,  # cluster_statics stacked per field: each [M, N]
    apps_stack: AppBatch,  # fields stacked [M, B, ...]
    *,
    fills: tuple,  # per-member fill strategy
    emax: int,
    num_zones: int,
):
    """M different clusters' windows solved in one call, the fleet's
    generalization of `arm_stacked_fifo_pack`: statics and apps stack too,
    and member m sees only its own cluster's statics, masks and
    availability, so its rows equal that cluster's own `batched_fifo_pack`
    solve. Members agree on the padded shapes (node bucket, emax, zones,
    app rows via `pad_app_batch`), not on content. A per-member loop like
    the arm solve; `avail_stack` is left as it was.

    Returns `(blob, avail_after)`: `blob` `[M, B, 3+emax]`, `avail_after`
    `[M, N, 3]`."""
    if len(fills) != avail_stack.shape[0]:
        raise ValueError(
            f"fills ({len(fills)}) must match the member axis "
            f"({avail_stack.shape[0]})"
        )
    dev = avail_stack.device
    dev_apps = app_batch_to_device(apps_stack, dev)

    def apps_of(m):
        return AppBatch(*(None if f is None else f[m] for f in dev_apps))

    return _stacked_solve(
        avail_stack, lambda m: tuple(s[m] for s in statics_stack), apps_of,
        fills, emax, num_zones,
    )
