"""PlacementSolver — the host <-> device boundary of the port's scheduler.

The port of spark_scheduler_tpu/core/solver.py's single-device serving path:
everything above this module speaks names and Resources, everything below it
(ops/) speaks int32 tensors over a stable node-index space. The solver
interns nodes into the NodeRegistry, builds ClusterTensors on its device
(padded to a power-of-two node count), serves a window of coalesced
/predicates requests through the segmented window solve (ops/window.py), and
maps the decisions back to node names.

Pipelined serving (`build_tensors_pipelined` -> `pack_window_dispatch` ->
`pack_window_fetch`) keeps the availability resident on the device and
threads it from window to window: window k+1 may be dispatched before
window k is fetched. `pack_windows_dispatch` serves K queued windows as ONE
dispatch (one segmented window of all their requests, one decision pull),
fetched through one `FusedWindowView` per window. The solo solve `pack` is
one live row of the same window solve; `preemption_search` probes candidate
eviction sets with the batched fit of ops/packing.py.

The solver runs on `device="cuda"` unless the caller asks for the CPU; with
no card and no explicit CPU request it raises, and it never moves work to
the CPU on its own. On the card the window goes through the CUDA row-walk
kernel; on the CPU through its plain PyTorch version.

Device-fault tolerance (`device_pool` / `mesh`, `degraded`): a pooled
solver spreads each pipelined window over slots (core/device_pool.py),
partitioned by disjoint instance-group domains, each slot on its own CUDA
stream; a slot whose solve dies of a classified device fault
(faults/errors.classify_slot_failure) is quarantined and its part
re-dispatched on a survivor, and a probe launch reinstates it later. With
no device left the degraded-mode controller answers: the host greedy
(core/fallback.py) or a shed. A build failure, a launch the kernel's own
configuration refuses, and an illegal address or launch failure (what a
wrong kernel raises) are never classified: they raise.

The host tensor build (`build_tensors`) runs on the native C++ arena
(native/runtime.cpp's ClusterArena) by default: per-node state is upserted
only when a node object changes, the nine host field buffers stay RESIDENT
between serving builds and the rows the feature store's availability
journal names are recomputed in one C call, so a window's build is
O(K + changed). The pipelined device mirror syncs over the same named rows
(the event-fed dirty set); the dense [N] compare runs only on a journal gap
and as the `solver.build-oracle` check. `use_native=False` is the dense
Python build (models/cluster.build_host_tensors), the oracle twin of the
tests.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import itertools
import os
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import Future, wait
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_scheduler_tpu_torch import native
from spark_scheduler_tpu_torch.core.device_pool import (
    PART_WAIT_S,
    DevicePool,
    PendingBase,
    WindowPart,
    on_solve_worker,
    shared_solve_pool,
)
from spark_scheduler_tpu_torch.core.prune import (
    PLAIN_FILLS,
    PrunePlanner,
    certify_window,
)
from spark_scheduler_tpu_torch.faults.errors import (
    AllSlotsQuarantinedError,
    DegradedUnavailableError,
    classify_slot_failure,
)
from spark_scheduler_tpu_torch.models.cluster import (
    FIELD_DTYPES,
    ClusterTensors,
    NodeRegistry,
    build_host_tensors,
    cluster_from_numpy,
    cluster_from_statics,
    cluster_statics,
    host_view,
    pad_bucket,
)
from spark_scheduler_tpu_torch.models.kube import Node
from spark_scheduler_tpu_torch.models.resources import (
    INT32_INF,
    NUM_DIMS,
    Resources,
)
from spark_scheduler_tpu_torch.ops.batched import _packing_blob, make_app_batch
from spark_scheduler_tpu_torch.ops.efficiency import avg_packing_efficiency_np
from spark_scheduler_tpu_torch.ops.packing import (
    BINPACK_STRATEGIES,
    PREEMPTION_FILL,
    preemption_batched_fit,
)
from spark_scheduler_tpu_torch.ops.probe import PROBE_SHAPE, probe, probe_add_one
from spark_scheduler_tpu_torch.ops.window import (
    SegmentedWindow,
    segmented_window_from_flat,
    window_pack,
)
from spark_scheduler_tpu_torch.parallel.node_shards import (
    node_sharded_fifo_pack,
    shard_cluster,
    shard_fields,
)

# Device shim (testing/rtt_shim.py, faults/injector.py). When installed,
# the solver calls it with "h2d" on the dispatcher thread at every window
# or solo upload, "dispatch" on the thread launching a pooled slot's solve
# (and before a quarantine probe), and "d2h" on the thread pulling a
# decision blob. None keeps every hook a single global read.
_DEVICE_SHIM = None


def set_device_shim(shim) -> None:
    """Install (or clear, with None) the process-wide device shim."""
    global _DEVICE_SHIM
    _DEVICE_SHIM = shim


def _shim(kind: str) -> None:
    s = _DEVICE_SHIM
    if s is not None:
        s(kind)


def _build_segmented_window(
    requests, drv_arr, exc_arr, counts, skip_arr, cand_per_req, dom_per_req
):
    """Segment-major [S, R] arrays with S and R BUCKETED coarsely (S to
    4 * 8^k, R to 16 * 4^k, as the JAX package does); padding segments are
    skipped at run time. Returns (SegmentedWindow, seg_idx, row_idx) —
    seg_idx/row_idx map each flat row to its [S, R] position."""
    s = len(requests)
    rc = np.asarray([len(req.rows) for req in requests], np.int32)
    s_pad = 4
    while s_pad < s:
        s_pad *= 8
    r_pad = 16
    while r_pad < int(rc.max()):
        r_pad *= 4
    return segmented_window_from_flat(
        drv_arr, exc_arr, counts, skip_arr, rc, cand_per_req, dom_per_req,
        pad_segments=s_pad, pad_rows=r_pad,
    )


class WindowBatch(NamedTuple):
    """A window's requests laid out for the segmented solve."""

    win: SegmentedWindow
    emax: int  # executor slots per row, bucketed to 8 * 2^k
    num_zones: int  # zone-id space, bucketed to 2^k
    seg_map: tuple  # (seg_idx, row_idx): flat row -> [S, R] position
    driver_req: np.ndarray  # [B, 3] flat rows, request-major
    exec_req: np.ndarray  # [B, 3]
    skippable: np.ndarray  # [B] bool
    # Per request, the identity of its affinity domain: ("digest", d) for
    # a digest ticket, the names tuple for a list of at most 4,096 names,
    # ("id", id(names)) for a longer one, None for no names (the valid
    # mask) or a precomputed mask.
    dom_keys: tuple = ()


class _WindowRows(NamedTuple):
    """A window's requests before the segmented layout: the flat row
    arrays (request-major) and each request's [N] candidate and domain
    masks. The full and the pruned dispatch lay them out differently."""

    requests: tuple
    drv_arr: np.ndarray  # [B, 3]
    exc_arr: np.ndarray  # [B, 3]
    counts: np.ndarray  # [B] int32
    skip_arr: np.ndarray  # [B] bool
    cand_per_req: list  # [N] bool per request
    dom_per_req: list  # [N] bool per request (domain & valid)
    dom_keys: tuple
    emax: int
    num_zones: int


class HostPacking(NamedTuple):
    driver_node: Optional[str]
    executor_nodes: list[str]
    has_capacity: bool
    efficiency_max: float
    efficiency_cpu: float
    efficiency_memory: float
    efficiency_gpu: float


class WindowRequest(NamedTuple):
    """One serving request inside a coalesced /predicates window
    (see PlacementSolver.pack_window)."""

    # (driver_resources, executor_resources, executor_count, skippable) in
    # FIFO order; the LAST row is the request's own application, earlier
    # rows are its pending earlier drivers (fitEarlierDrivers semantics,
    # resource.go:221-258 + sparkpods.go:60-77).
    rows: Sequence[tuple]
    driver_candidate_names: Sequence[str]
    domain_node_names: Sequence[str] | None = None  # None = all valid nodes
    domain_mask: "np.ndarray | None" = None  # precomputed [N] bool override


class WindowDecision(NamedTuple):
    """Outcome of one window request (see PlacementSolver.pack_window)."""

    packing: HostPacking
    admitted: bool
    # A non-skippable, still-pending earlier driver failed to fit => the
    # request fails FAILURE_EARLIER_DRIVER instead of FAILURE_FIT
    # (resource.go:241-249).
    earlier_blocked: bool



class PipelineDrainRequired(RuntimeError):
    """Raised by build_tensors_pipelined when node topology/attributes
    changed while a dispatched window is still un-fetched: the caller must
    fetch (complete) the pending window first, then retry — the fresh full
    upload would otherwise discard the in-flight window's threaded base."""


# Fields that force a full re-upload (or a static row delta) when they
# change: node topology / attribute changes, rare next to availability.
_STATIC_FIELDS = (
    "schedulable",
    "zone_id",
    "name_rank",
    "label_rank_driver",
    "label_rank_executor",
    "unschedulable",
    "ready",
    "valid",
)

_INT32 = np.iinfo(np.int32)


def _host_nbytes(host: ClusterTensors) -> int:
    """Bytes of a full upload of the host view (every field)."""
    return sum(np.asarray(f).nbytes for f in host.fields())


def _window_nbytes(win: SegmentedWindow) -> int:
    """Bytes of a segmented window's arrays (what a dispatch ships)."""
    return sum(np.asarray(a).nbytes for a in win)


def _gather_statics_host(host, keep: np.ndarray, k_real: int) -> tuple:
    """Host-side gather of the static cluster fields onto a (padded) kept
    row set for the pruned sub-cluster upload. Padding repeats keep[0];
    the padded rows' `valid` is forced False so they are transparent to
    the row walk (eligibility, zone sums, capacity all mask on valid)."""
    fields = [np.asarray(f)[keep] for f in cluster_statics(host)]
    valid = fields[-1].copy()  # cluster_statics order ends with `valid`
    valid[k_real:] = False
    fields[-1] = valid
    return tuple(fields)


class WindowHandle:
    """A dispatched-but-not-yet-fetched window solve
    (PlacementSolver.pack_window_dispatch -> pack_window_fetch)."""

    __slots__ = (
        "strategy", "blob", "ready", "requests", "host_avail",
        "host_schedulable", "host_tensors", "priors", "prior_debited",
        "window_placements", "row_driver_req", "row_exec_req",
        "row_skippable", "seg_map", "window_rows", "info", "request_device",
        "dispatched_at", "released", "fused_decisions", "fused_bounds",
        "applied", "prune", "base_kept", "use_fallback", "resolved",
        "parts", "greedy", "blob_future", "host_avail32", "avail_gen",
        "avail_note_epoch", "__weakref__",
    )

    def __init__(self, *, strategy, blob, requests, host_avail,
                 host_schedulable, priors=(), prior_debited=None):
        self.strategy = strategy
        # Decision blob [S, R, 3 + emax] int32: (driver, admitted, packed,
        # executor slots...) per segment row; seg_map flattens the real
        # rows after the pull. On the card it is a pinned host buffer
        # whose copy was queued right behind the window's kernels, and
        # `ready` is the CUDA event that copy records.
        self.blob = blob
        self.ready = None
        # A window deferred into a dispatch lane's stacked solve (replay
        # sweep, fleet): the lane's future resolves to the flat host blob
        # [B, 3 + emax]; blob is None until then.
        self.blob_future = None
        self.requests = requests
        # Host availability at dispatch (an int64 [N,3] copy; None for a
        # pruned or pooled dispatch, see host_avail32); the device base
        # additionally lacks the placements of `priors` (windows
        # dispatched earlier but un-fetched at this dispatch).
        self.host_avail = host_avail
        # A pruned or pooled dispatch keeps no dense copy: host_avail is
        # None, host_avail32 is the resident int32 host buffer and
        # avail_gen its generation at dispatch. The resident build patches
        # that buffer in place afterwards; `_avail_at_dispatch` replays the
        # undo journal to the dispatch-time view on the rare dense paths.
        self.host_avail32 = None
        self.avail_gen = None
        # Pooled dispatch of a whole window: the availability epoch it
        # journaled as unknowable, patched with the commit rows at fetch.
        self.avail_note_epoch = None
        self.host_schedulable = host_schedulable
        self.host_tensors = None  # the host ClusterTensors view at dispatch
        self.priors = priors  # tuple[WindowHandle] — fetched before this one
        # Per prior, the windows the pipeline mirror had already debited
        # when the dispatched tensors were built (a fused umbrella's views
        # fetched by then): the host view held their reservations, so the
        # device base lacked only the others.
        self.prior_debited = (
            tuple(prior_debited)
            if prior_debited is not None
            else tuple(frozenset() for _ in priors)
        )
        # Committed placements, filled at fetch: per window of the dispatch
        # (one, or K for a fused umbrella), the rows they touched (sorted)
        # and the int64 [P,3] amounts at those rows.
        self.window_placements = None
        self.row_driver_req = None  # int64 [B,3]
        self.row_exec_req = None
        self.row_skippable = None
        self.seg_map = None  # (seg_idx, row_idx)
        # The window's rows and masks (_WindowRows): a full re-solve after a
        # pruned window's escalation lays the window out again from them.
        self.window_rows = None
        # Dispatch info ({"path", "nodes", "rows", "row_bucket", "emax",
        # "state_upload", "dispatch_id"}) for the decision records.
        self.info = None
        # Multi-device attribution of each request; None on one device.
        self.request_device = None
        # Host clock at dispatch (the dispatch -> decisions telemetry).
        self.dispatched_at = 0.0
        # close()/discard_pipeline() dropped the decision buffer.
        self.released = False
        # A fused umbrella's memoised fetch, ("ok", [(decisions, rows,
        # amounts) per window]) or ("err", exception), shared by its
        # FusedWindowViews; its windows' request ranges; and which windows'
        # placements the pipeline mirror has taken (one per fetched view).
        self.fused_decisions = None
        self.fused_bounds = None
        self.applied: set = set()
        # Pruned dispatch (core/prune.py): the plan, and the [k_real, 3]
        # int64 host availability on the kept rows at dispatch.
        self.prune = None
        self.base_kept = None
        # Dispatched on a carry that a pruned window's escalation poisoned:
        # the fetch re-solves the window in full ("prune-escalation"), or
        # a solo build did so first (build_tensors_solo) and kept the
        # windows' results here for the fetch.
        self.use_fallback = False
        self.resolved = None
        # Pooled dispatch: the WindowParts (per-part futures); None on the
        # single-device path. request_device names each request's slot.
        self.parts = None
        # No device solved this window (the card failed at dispatch, or no
        # pool slot was healthy): the fetch serves it on the host greedy.
        self.greedy = False

    @property
    def dispatch_id(self):
        return (self.info or {}).get("dispatch_id")

    def fetch_ready(self) -> bool:
        """True when every decision pull this dispatch started has landed
        (completing it costs no blocking wait); False when there is none
        to wait for on a side thread."""
        if self.parts is not None:
            return all(p.future.done() for p in self.parts)
        if self.blob_future is not None:
            return self.blob_future.done()
        return False

    def has_eager_fetch(self) -> bool:
        """Whether decision pulls run on side threads (a pooled dispatch's
        parts): the serving loop then waits on their futures instead of
        blocking in the fetch."""
        return self.parts is not None

    def release_buffers(self) -> None:
        """Drop the decision buffer (close()/discard_pipeline()): a
        discarded fused batch must not keep its blob alive through views
        parked in the serving loop. A later fetch fails fast."""
        self.released = True
        self.blob = None
        self.ready = None
        for part in self.parts or ():
            part.future.cancel()

    def fetch_blob(self) -> np.ndarray:
        """The decision blob on the host, waiting for the device if the
        copy has not landed yet."""
        if self.blob_future is not None:
            return self.blob_future.result()[None]
        if self.ready is not None:
            self.ready.synchronize()
        return self.blob.numpy()


class FusedWindowView:
    """One window of a fused K-window dispatch
    (PlacementSolver.pack_windows_dispatch): a slice of the umbrella
    WindowHandle that solved the K windows' requests in one dispatch. It
    has the handle surface the serving loop and the extender read
    (requests, request_device, info, dispatch_id); pack_window_fetch of a
    view fetches the umbrella ONCE (memoised on the owner, a failure
    included) and returns the view's slice, so the first view fetched pays
    the single decision pull and the rest are free."""

    __slots__ = ("owner", "lo", "hi", "index", "fused_k", "info")

    def __init__(self, owner: WindowHandle, lo: int, hi: int, index: int,
                 fused_k: int):
        self.owner = owner
        self.lo = lo
        self.hi = hi
        self.index = index
        self.fused_k = fused_k
        # Per-view copy: a decision record names the view's position in the
        # fused batch without touching the shared owner info.
        self.info = {**(owner.info or {}), "fused_index": index}

    @property
    def dispatch_id(self):
        return self.owner.dispatch_id

    @property
    def requests(self):
        return self.owner.requests[self.lo:self.hi]

    @property
    def request_device(self):
        rd = self.owner.request_device
        return rd[self.lo:self.hi] if rd is not None else None

    # The serving loop's eager-fetch surface (server/http.py eager_futures).
    @property
    def parts(self):
        return self.owner.parts

    def fetch_ready(self) -> bool:
        if self.owner.fused_decisions is not None:
            return True
        return self.owner.fetch_ready()

    def has_eager_fetch(self) -> bool:
        return self.owner.has_eager_fetch()


def _debit_rows(base, base_rows, rows, vals):
    """Subtract `vals` from `base` (in place, returned) where the sorted
    global rows `base_rows` that index it hold `rows`; rows outside it
    are skipped."""
    if rows.size:
        loc = np.searchsorted(base_rows, rows)
        locc = np.clip(loc, 0, base_rows.size - 1)
        on = base_rows[locc] == rows
        if on.any():
            base[locc[on]] -= vals[on]
    return base


class _NameRankSpace:
    """Order-maintaining name ranks for the native arena.

    Every sort and certificate reads name_rank as a key: rank ORDER
    matters, values never do. So ranks need not be dense: values are
    assigned with gaps, and an added node takes the midpoint between its
    lexicographic neighbours' values (a bisect and one arena scatter)
    instead of renumbering every slot. A crowded gap relabels a local
    neighbourhood; only genuine exhaustion renumbers the whole space
    (`renumbers`).

    Values stay under 2^29 < INT32_INF / 2, so they never collide with the
    arena's invalid-slot sentinel."""

    _SPAN = 1 << 29

    __slots__ = ("names", "ranks", "renumbers", "rebalances")

    def __init__(self):
        self.names: list[str] = []  # lexicographically sorted
        self.ranks: list[int] = []  # parallel gapped values, ascending
        self.renumbers = 0
        self.rebalances = 0

    def assign_all(self, names_sorted) -> None:
        self.names = list(names_sorted)
        gap = max(1, self._SPAN // (len(self.names) + 1))
        self.ranks = [(i + 1) * gap for i in range(len(self.names))]
        self.renumbers += 1

    def insert(self, name: str):
        """Insert one name. Returns the names whose rank VALUES changed
        (just `name` for a clean gap insert, a rebalanced neighbourhood
        when the local gap is exhausted), or None when the whole space
        renumbered (the caller re-scatters every rank)."""
        i = bisect.bisect_left(self.names, name)
        if i < len(self.names) and self.names[i] == name:
            return []  # already ranked
        lo = self.ranks[i - 1] if i > 0 else 0
        hi = (
            self.ranks[i]
            if i < len(self.ranks)
            else min(lo + 2 * max(1, self._SPAN // (len(self.names) + 2)),
                     self._SPAN)
        )
        self.names.insert(i, name)
        if hi - lo < 2:
            self.ranks.insert(i, lo)  # placeholder; _rebalance assigns
            return self._rebalance(i)
        self.ranks.insert(i, (lo + hi) // 2)
        return [name]

    def _rebalance(self, i: int):
        """Spread a geometrically grown neighbourhood of position `i`
        evenly across its enclosing value interval. Returns the names whose
        values moved, or None after a full renumber."""
        n = len(self.names)
        half = 4
        while True:
            a = max(0, i - half)
            b = min(n, i + half)
            lo = self.ranks[a - 1] if a > 0 else 0
            hi = self.ranks[b] if b < n else self._SPAN
            count = b - a
            if hi - lo >= 4 * (count + 1):
                gap = (hi - lo) // (count + 1)
                changed: list[str] = []
                for k in range(a, b):
                    val = lo + (k - a + 1) * gap
                    if self.ranks[k] != val:
                        self.ranks[k] = val
                        changed.append(self.names[k])
                self.rebalances += 1
                return changed
            if a == 0 and b == n:
                self.assign_all(self.names)
                return None
            half *= 2

    def remove(self, name: str) -> None:
        """Drop one name (a node delete): its value leaves the space and
        the neighbours keep theirs."""
        i = bisect.bisect_left(self.names, name)
        if i < len(self.names) and self.names[i] == name:
            self.names.pop(i)
            self.ranks.pop(i)

    def rank_of(self, name: str) -> int:
        return self.ranks[bisect.bisect_left(self.names, name)]


# The nine ClusterTensors fields of the resident build, in field order.
_RES_FIELDS = (
    "available", "schedulable", "zone_id", "name_rank",
    "label_rank_driver", "label_rank_executor",
    "unschedulable", "ready", "valid",
)


class PlacementSolver:
    def __init__(
        self,
        driver_label_priority: tuple[str, list[str]] | None = None,
        executor_label_priority: tuple[str, list[str]] | None = None,
        device="cuda",
        delta_statics: bool = True,
        prune_top_k: int = 0,
        prune_slack: float = 2.0,
        device_pool: int = 1,
        mesh: "tuple[int, int] | None" = None,
        quarantine_probe_s: float = 5.0,
        pool_devices=None,
        use_native: bool = True,
        build_oracle: bool = False,
        lazy_warm_start: bool = True,
        scale_tier: bool = False,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PlacementSolver(device='cuda') needs a CUDA device and none "
                "is available; pass device='cpu' to run the plain PyTorch path"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" names the current card; pin it, so tensors built here
            # compare equal to the solver's device.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.registry = NodeRegistry()
        # The window-solve device pool (`solver.device-pool` /
        # `solver.mesh.groups`): `mesh=(groups, node_shards)` or
        # `device_pool=P` (mesh (P, 1)) asks for that many slots over the
        # devices of the solver's type, clamped to their count, so one card
        # gives no pool. `pool_devices` (a deliberate deviation from the
        # JAX package) names the devices instead, repeats allowed, as the
        # flat list `make_pool_slots` groups row-major: with one node shard
        # each entry is a slot (several slots on one card, each on its own
        # stream), with S node shards each S entries are one MESH slot
        # (parallel/mesh.py), so `mesh=(1, 4), pool_devices=[cuda:0] * 4`
        # is one 4-shard slot on one card. A pool of one plain slot is no
        # pool; one mesh slot is (JAX :1262-1266).
        self._pool: DevicePool | None = None
        groups, node_shards = mesh if mesh is not None else (device_pool, 1)
        node_shards = max(1, int(node_shards or 1))
        if node_shards & (node_shards - 1):
            # The node axis is padded to powers of two (pad_bucket, the
            # pruned gathers), so no other shard count divides it.
            raise ValueError(
                f"solver.mesh node-shards={node_shards}: the solver's "
                f"power-of-two node buckets are not divisible by mesh "
                f'"nodes" axis {node_shards}; pad with invalid slots, or '
                "use a power of two"
            )
        if pool_devices is not None or groups > 1 or node_shards > 1:
            from spark_scheduler_tpu_torch.parallel.mesh import (
                local_devices,
                make_pool_slots,
            )

            devices = (
                pool_devices
                if pool_devices is not None
                else local_devices(self.device.type)
            )
            slots = make_pool_slots(
                len(devices) if pool_devices is not None else groups,
                node_shards, devices=devices,
            )
            flat = [
                d for sl in slots
                for d in (sl.devices if node_shards > 1 else [sl])
            ]
            if any(d.type != self.device.type for d in flat):
                raise ValueError(
                    f"pool devices {[str(d) for d in flat]} are not of the "
                    f"solver's type {self.device.type}"
                )
            if len(slots) > 1 or node_shards > 1:
                self._pool = DevicePool(slots)
        # `solver.scale-tier`: a window re-solve from the host truth (a
        # pruned window's certificate escalation, a fallback handle) runs
        # node-sharded over the solver's devices (`_scale_mesh_for`) when
        # they give more than one shard; `sharded` counts those,
        # `fallbacks` the re-solves a classified device fault sent to the
        # host greedy.
        self._scale_tier = bool(scale_tier)
        self.scale_tier_stats = {"resolves": 0, "sharded": 0, "fallbacks": 0}
        # Quarantine probing, the degraded-mode controller
        # (faults/degraded.py, wired by build_scheduler_app; None = device
        # failures propagate) and the lazy host greedy it serves through.
        self.quarantine_probe_s = float(quarantine_probe_s)
        self.degraded = None
        self._fallback = None
        self.redispatch_count = 0
        self._clock = time.time
        # Pool worker futures in flight -> their slots: cancelled (if not
        # started) and awaited by close(), awaited by discard_pipeline();
        # after close() a dispatch fails fast.
        self._inflight_futures: dict = {}
        self._closed = False
        # Statics-epoch journal: epoch -> rows a static row delta changed.
        # A pool slot E epochs behind scatters the union of those rows; a
        # full upload clears it (every replica then re-uploads).
        self._static_journal: dict[int, np.ndarray] = {}
        self._driver_label_priority = driver_label_priority
        self._executor_label_priority = executor_label_priority
        # Static row deltas: a node event that changes few static rows
        # ships a row scatter of those rows instead of a full upload (and
        # instead of draining the pipeline). False restores the
        # full-upload-per-statics-change path.
        self._delta_statics = bool(delta_statics)
        # Candidate-mask memo keyed by (N, registry epoch, names): serving
        # windows pass the same (usually cluster-wide) candidate list once
        # per request, and the mask build walks every name. The lock guards
        # the memo's order: the unschedulable-pod marker's solo `pack` runs
        # on its own thread beside the predicate batcher's windows.
        self._cand_cache: OrderedDict = OrderedDict()
        self._cand_lock = threading.Lock()
        # The card's kernels are built and checked by one probe launch
        # before the first solve on a CUDA device (once, whichever thread
        # solves first).
        self._probed = False
        self._probe_lock = threading.Lock()
        # Which path served each dispatched window: "cuda" (the row-walk
        # kernel) or "reference" (its plain version on the CPU).
        self.window_path_counts: dict[str, int] = {}
        # Pipelined serving state (build_tensors_pipelined /
        # pack_window_dispatch / pack_window_fetch): the device
        # availability threaded ACROSS windows, an int64 mirror of what it
        # embodies in host terms, and the dispatched-but-unfetched
        # handles. Single-threaded by contract (the predicate batcher is
        # the serialization point).
        self._pipe: dict | None = None
        self._dispatch_seq = itertools.count(1)
        # Umbrella handles of fused dispatches, released by close() and
        # discard_pipeline() (weak: a fetched batch needs no release).
        self._fused_owners: "weakref.WeakSet[WindowHandle]" = weakref.WeakSet()
        # How the LAST pipelined build reached the device
        # ("full" | "delta" | "reuse").
        self.last_state_upload: str | None = None
        # How the pipelined and cached builds reached the device: full
        # uploads, availability row deltas, reuses, static row deltas, and
        # every upload's h2d bytes.
        self.device_state_stats = {
            "full_uploads": 0,
            "delta_uploads": 0,
            "delta_rows": 0,
            "reuse_hits": 0,
            "static_delta_uploads": 0,
            "static_delta_rows": 0,
            "upload_bytes": 0,
        }
        # The host build (`build_tensors`): the native arena
        # (native/runtime.cpp ClusterArena) unless `use_native=False`, which
        # keeps the dense Python build as the oracle twin. The arena builds
        # the port's runtime with g++ at first use or raises: no build
        # degrades to the Python path.
        self._arena = native.ClusterArena() if use_native else None
        # The arena's view of each node (upserted only when the Node object
        # changes), the name-rank generation and its gapped rank space.
        self._node_seen: dict[str, Node] = {}
        self._rank_epoch = -1
        self._rank_space = _NameRankSpace()
        # Deleted nodes' registry rows awaiting recycling: a row re-enters
        # the registry's free list once its usage and overhead drained to
        # zero and no window is in flight; until then it stays masked out.
        self._pending_tombstones: set[str] = set()
        self.tombstones_recycled = 0
        # Topology memo: the feature store's node version the arena last
        # synced to, and the request mask memoized on it.
        self._topo_seen = None
        self._topo_request_mask = None  # ((version, pad, n), [pad] bool)
        # The resident build: the nine host field buffers stay alive
        # between serving builds and only the changed rows are recomputed.
        # Statics copy-on-write when their rows change (in-flight handles
        # keep their dispatch-time arrays); `available` is patched in place
        # with an undo journal while pruned or pooled handles are in
        # flight. `_res_pending` holds arena rows upserted since the
        # resident buffers last absorbed them; `_res_full_pending` marks a
        # change no row list names (a full rank renumber).
        self._snap_res: dict | None = None
        self._res_pending: list = []
        self._res_full_pending = False
        # A static row the resident build patched since the pipeline last
        # synced its statics: the feature store's statics epoch alone no
        # longer proves the statics unchanged (a build on another thread
        # may have upserted a node the store has not journaled yet).
        self._res_statics_moved = False
        self._avail_gen = 0
        self._avail_undo: list = []  # (gen, buffer, rows, old int32 rows)
        self._avail_handles: "weakref.WeakSet[WindowHandle]" = weakref.WeakSet()
        # (availability rows, static rows) the last build named; None when
        # it could not name them (a full snapshot, the Python build).
        self._last_build_rows: "tuple | None" = None
        # Union of the rows every build named since the pipelined statics
        # last synced (None: some build could not name its rows): the
        # candidate rows of `_plan_static_delta`'s field diff.
        self._static_acc: "list | None" = []
        # `solver.build-oracle`: after every dirty-set mirror sync run the
        # dense compare and raise on a changed row the dirty set missed
        # (SPARK_SCHEDULER_BUILD_ORACLE=1 forces it, as in the JAX package).
        self.build_oracle = bool(build_oracle) or (
            os.environ.get("SPARK_SCHEDULER_BUILD_ORACLE", "") not in ("", "0")
        )
        # `solver.lazy-warm-start`: a full device upload whose host build
        # named its changed rows keeps the prune planner resident; False
        # invalidates it on every full upload.
        self._lazy_warm_start = bool(lazy_warm_start)
        # The arena and the resident buffers are shared by every thread
        # that builds (the predicate batcher and the unschedulable-pod
        # marker): one lock serializes their builds and ledger updates.
        self._build_lock = threading.RLock()
        # build_tensors_cached's device-resident state (the solo path of
        # the JAX package's serving loop and /debug/state).
        self._dev: dict | None = None
        # Pipeline tokens: a pool slot's availability replica is a valid
        # catch-up base only within the pipeline generation that wrote it.
        self._pipe_tokens = itertools.count(1)
        # Per-names patch bases of the candidate-mask patch across
        # registry epochs (`_cand_try_patch`).
        self._cand_patch: OrderedDict = OrderedDict()
        self.build_stats = {
            "builds": 0,
            "build_ms": 0.0,
            "incremental_builds": 0,
            "full_snapshots": 0,
            # Rows the DENSE mirror sweep examined (a journal gap, or a
            # build that could not name its rows; 0 in steady state), and
            # the rows the event-fed dirty-set sync examined.
            "mirror_rows_compared": 0,
            "mirror_dense_syncs": 0,
            "dirty_rows": 0,
            # Rows pooled fetches debited sparsely into the mirror.
            "pooled_debit_rows": 0,
            "oracle_checks": 0,
        }
        # Deferred-dispatch lane (replay/sweep.py, fleet/dispatch.py); None
        # on the plain serving path. A lane is a coordinator that takes a
        # pipelined window's plain solve and defers it into a stacked
        # solve: the sweep stacks the SAME window across config arms at
        # its lockstep barrier (ops/batched.arm_stacked_fifo_pack), the
        # fleet stacks concurrent windows of different clusters inside a
        # short gather window (bucket_stacked_fifo_pack). As in the JAX
        # package, only a window that does not take the kernel route can
        # defer: on a CUDA solver the row walk serves every window of all
        # six strategies and the lane is never asked. Protocol:
        # `accepts(solver)` gates each deferral, `row_bucket_quantum`
        # (None = the solver's `_row_bucket_quantum`) pads the deferred
        # window's app rows, and `defer_window(...)` parks the window and
        # returns (future of the host blob, PendingBase of the committed
        # base). `_sweep_shared` is the sweep's cross-lane candidate-mask
        # memo (registry state is arm-invariant, so lanes 2..M reuse lane
        # 1's mask builds). `_row_bucket_quantum` stays 32 on serving
        # paths; sweep lanes set 8.
        self._dispatch_lane = None
        self._sweep_shared: dict | None = None
        self._row_bucket_quantum = 32
        # Dispatch info of the most recent solve (solo pack or window).
        self.last_solve_info: dict | None = None
        # SolverTelemetry hook surface (observability/telemetry.py), wired
        # by build_scheduler_app; None keeps every hot-path hook a single
        # attribute test.
        self.telemetry = None
        # Candidate pruning (`solver.prune-top-k` / `solver.prune-slack`,
        # core/prune.py): when top-k > 0, an eligible pipelined window
        # solves a gathered top-K sub-cluster on the row walk, and its
        # decisions are certified against the full solve at fetch (a
        # failed certificate re-solves the dispatch in full). 0 = off.
        self._prune_top_k = int(prune_top_k)
        self._prune_slack = float(prune_slack)
        self._planner: PrunePlanner | None = None  # lazy
        # Gathered statics of a plan's kept rows, keyed by the keep
        # array's identity (the planner re-serves the same object while
        # the kept set stands; the entry pins it, so the id cannot
        # recycle), with their device copies; an entry drops when a
        # static row delta touches its rows, on full uploads and close().
        self._prune_gather_cache: dict = {}
        # (domain key, registry epoch, statics epoch, N) -> "is the full
        # valid mask" memo for named domains.
        self._full_dom_memo: dict = {}
        # Statics epoch: moves on every full upload and every static row
        # delta (the content the full-domain memo compared).
        self._static_epoch = 0
        # Dispatches whose carry an escalation dropped (the escalated one
        # and those dispatched on it), with the views fetched so far: until
        # their last view is fetched, their gangs are neither on the card
        # nor in the host view, so a pipelined build must drain first.
        self._poisoned: dict = {}
        # Solo builds that debited the live pipeline's in-flight windows
        # (build_tensors_solo after a topology change), and preemption
        # searches by the device type they ran on.
        self.solo_inflight_debits = 0
        self.preemption_searches: dict[str, int] = {}
        self.prune_stats = {
            "windows": 0,
            "escalations": 0,
            "kept_rows": 0,
            "window_rows": 0,
            "candidate_rows": 0,
            "reasons": {},
            # O(K + changed) planning: rows the planner examined, the
            # cold-build rows, subset-domain sweeps, resync compares,
            # cache activity, and the per-phase wall-time sums.
            "planner_rows_scanned": 0,
            "planner_cold_rows": 0,
            "planner_sweep_rows": 0,
            "planner_resync_rows": 0,
            "planner_zone_rescans": 0,
            "planner_zone_refreshes": 0,
            "planner_merges": 0,
            "planner_boundary_inserts": 0,
            "plan_reuse": 0,
            "gather_reuse": 0,
            "plan_ms": 0.0,
            "gather_ms": 0.0,
            "offset_ms": 0.0,
        }

    # -- device-fault tolerance -------------------------------------------

    @property
    def fallback(self):
        """The host greedy the degraded "greedy" policy serves through."""
        if self._fallback is None:
            from spark_scheduler_tpu_torch.core.fallback import (
                GreedyFallbackSolver,
            )

            self._fallback = GreedyFallbackSolver(self)
        return self._fallback

    @property
    def pool_size(self) -> int:
        """Slots of the window-solve pool (1 = the single-device path)."""
        return len(self._pool.slots) if self._pool is not None else 1

    def device_pool_stats(self) -> dict:
        """Per-slot resident-state stats ({label: {full, delta, reuse,
        inflight, quarantined, failures, mirror}})."""
        return self._pool.stats() if self._pool is not None else {}

    def device_health(self) -> dict:
        """{slots, healthy, quarantined: [labels]} — /debug/state and the
        readiness probe's degraded view."""
        if self._pool is None:
            return {"slots": 1, "healthy": 1, "quarantined": []}
        return self._pool.health()

    def dispatch_occupancy(self) -> float:
        """Busy fraction of the dispatch surface now: pooled, the share of
        slots with a solve in flight; one device, 1.0 while a dispatched
        window is still unfetched."""
        if self._pool is not None:
            return self._pool.occupancy()
        p = self._pipe
        return 1.0 if p is not None and p["unfetched"] else 0.0

    def _on_slot_event(self, event: str, label: str) -> None:
        if self.telemetry is not None:
            self.telemetry.on_slot_event(event, label)
            if self._pool is not None:
                self.telemetry.on_quarantine_count(
                    len(self._pool.quarantined_slots())
                )

    def _quarantine_slot(self, slot, exc) -> None:
        self._pool.quarantine(slot, self._clock())
        self._on_slot_event("quarantine", slot.label)
        from spark_scheduler_tpu_torch.tracing import svc1log

        svc1log().warn(
            "device slot quarantined",
            device=slot.label,
            error=f"{type(exc).__name__}: {exc}",
            failures=slot.failure_count,
        )

    def probe_quarantined(self, force: bool = False) -> int:
        """Launch the probe kernel (ops/probe.probe_add_one) on each
        quarantined slot whose probe interval elapsed, on the slot's
        stream (a mesh slot: on each shard's device and stream); success reinstates the slot (statics re-upload on its next
        dispatch). A classified device fault keeps it quarantined; wrong
        values or any other error raise. Returns the slots reinstated.
        After a fault that poisons the CUDA context (an uncorrectable ECC
        error) the probe keeps failing and the slot stays out."""
        pool = self._pool
        if pool is None:
            return 0
        reinstated = 0
        now = self._clock()
        for s in pool.quarantined_slots():
            if not force and now - s.last_probe < self.quarantine_probe_s:
                continue
            s.last_probe = now
            try:
                # A mesh slot probes every shard's device: it is back only
                # when all of them answer.
                ok = True
                for k, dev in enumerate(s.shard_devices):
                    stream = (
                        s.shard_streams[k] if s.shard_streams is not None
                        else s.stream
                    )
                    ctx = (
                        torch.cuda.stream(stream) if stream is not None
                        else contextlib.nullcontext()
                    )
                    with ctx:
                        _shim("dispatch")
                        x = torch.zeros(PROBE_SHAPE, dtype=torch.int32, device=dev)
                        ok = ok and bool((probe_add_one(x) == 1).all())
            except Exception as exc:
                if classify_slot_failure(exc):
                    self._on_slot_event("probe-failed", s.label)
                    continue
                raise
            if not ok:
                raise RuntimeError(
                    f"probe kernel returned wrong values on slot {s.label}"
                )
            pool.reinstate(s)
            reinstated += 1
            self._on_slot_event("reinstate", s.label)
        if reinstated and self.degraded is not None and pool.healthy_slots():
            self.degraded.clear()
        return reinstated

    def _degraded_or_raise(self, exc):
        """A device failure with no healthy slot to retry on: consult the
        degraded policy. Returns True when the caller should serve on the
        host greedy; raises DegradedUnavailableError (shed) or re-raises
        `exc` (no controller wired)."""
        d = self.degraded
        if d is None:
            raise exc
        d.engage(f"{type(exc).__name__}: {exc}")
        if d.sheds:
            d.on_shed()
            raise DegradedUnavailableError(
                f"no device slot available: {exc}", d.retry_after_s
            ) from exc
        return True

    def _device_recovered(self) -> None:
        """A device solve completed: a degraded mode engaged by a transient
        single-device failure clears (a pool's clears at reinstatement)."""
        d = self.degraded
        if d is not None and d.active:
            if self._pool is None or self._pool.healthy_slots():
                d.clear()

    def _drop_pipeline(self, event: str) -> None:
        """A device fault made the threaded base unknowable: drop it (the
        next build uploads the host view in full). The windows still in
        flight on it hold builds back until they are fetched, as after a
        pruned window's escalation: their gangs are on no device base and
        in no host view yet (the JAX package full-uploads without them,
        and a window dispatched on that upload can over-commit)."""
        p = self._pipe
        if p is not None:
            for h in p["unfetched"]:
                self._poisoned.setdefault(h, set(h.applied))
            self._pipe = None
            self._note_inflight()
        self._prune_mark_unknown()
        if self.telemetry is not None:
            self.telemetry.on_pipeline_event(event)

    def _release_pool(self) -> None:
        if self._pool is None:
            return
        self._pool.release()
        if self.telemetry is not None:
            for s in self._pool.slots:
                self.telemetry.on_device_inflight(s.label, 0)

    @property
    def uses_native_arena(self) -> bool:
        return self._arena is not None

    def _build_host(
        self,
        nodes: Sequence[Node],
        usage,
        overhead,
        *,
        full_node_list: bool = False,
        topo_version: Optional[int] = None,
        roster_rows: "np.ndarray | None" = None,
        dirty_hint: "tuple | None" = None,
        avail_epoch: "int | None" = None,
        avail_journal: "dict | None" = None,
    ) -> ClusterTensors:
        """The host view (a ClusterTensors of numpy arrays) of `nodes`:
        the arena's resident build, or with `use_native=False` the dense
        Python build, which names no changed row."""
        with self._build_lock:
            if self._arena is not None:
                return self._build_tensors_native(
                    nodes, usage, overhead,
                    full_node_list=full_node_list, topo_version=topo_version,
                    roster_rows=roster_rows, dirty_hint=dirty_hint,
                    avail_epoch=avail_epoch, avail_journal=avail_journal,
                )
            self._last_build_rows = None
            self._acc_build_rows()
            self._note_consumers_unknown()
            for n in nodes:
                self.registry.intern(n.name)
            return build_host_tensors(
                list(nodes),
                usage,
                overhead,
                self.registry,
                driver_label_priority=self._driver_label_priority,
                executor_label_priority=self._executor_label_priority,
                pad_to=pad_bucket(self.registry.capacity, 8),
            )

    def _upload(self, host: ClusterTensors) -> ClusterTensors:
        """Copy a host view to the solver's device. Every field is copied,
        on the CPU too: the resident build patches the host buffers in
        place, so no tensor may alias them."""
        out = cluster_from_numpy(host.fields(), device=self.device)
        out.host = host
        return out

    def build_tensors(
        self,
        nodes: Sequence[Node],
        usage,
        overhead,
        *,
        full_node_list: bool = False,
        topo_version: Optional[int] = None,
        roster_rows: "np.ndarray | None" = None,
        dirty_hint: "tuple | None" = None,
        avail_epoch: "int | None" = None,
        avail_journal: "dict | None" = None,
    ):
        """Device tensors of `nodes`. `usage` / `overhead` are {node:
        Resources} maps or dense int64 [cap, 3] arrays indexed by this
        solver's registry.

        The keyword arguments are the feature store's build accelerators
        (core/feature_store.FeatureSnapshot). `full_node_list` asserts
        `nodes` is the backend's whole roster and `topo_version` is its
        node version, captured before the list: together they skip the
        arena's O(nodes) sync walk and memoize the request mask.
        `roster_rows` makes the request mask one scatter; `dirty_hint`
        (previous version, changed nodes, deleted names) upserts only the
        changed nodes. `avail_epoch` / `avail_journal` name the rows whose
        availability inputs changed: with a gap-free chain the resident
        build recomputes just those rows, otherwise it materializes every
        row into fresh buffers. No hint changes a result."""
        return self._upload(
            self._build_host(
                nodes, usage, overhead,
                full_node_list=full_node_list, topo_version=topo_version,
                roster_rows=roster_rows, dirty_hint=dirty_hint,
                avail_epoch=avail_epoch, avail_journal=avail_journal,
            )
        )

    def build_tensors_cached(
        self,
        nodes: Sequence[Node],
        usage,
        overhead,
        topo_version: Optional[int] = None,
        roster_rows=None,
        dirty_hint=None,
        avail_epoch=None,
        avail_journal=None,
    ) -> ClusterTensors:
        """Device-resident cluster state with delta updates: the host view
        of build_tensors (the full node list), with the device copy kept
        alive between calls. When only availability rows changed, just
        those rows ship (an out-of-place row copy); unchanged state reuses
        the resident tensors; a static-field change uploads in full. With
        the resident build the availability buffer is patched in place, so
        the changed rows come from the pending ledger, not a value
        compare."""
        with self._build_lock:
            host = self._build_host(
                nodes, usage, overhead,
                full_node_list=True, topo_version=topo_version,
                roster_rows=roster_rows, dirty_hint=dirty_hint,
                avail_epoch=avail_epoch, avail_journal=avail_journal,
            )
            stats = self.device_state_stats
            dev = self._dev
            tensors = None
            n = host.available.shape[0]
            if dev is not None and dev["host"].available.shape == host.available.shape:
                prev = dev["host"]
                if all(
                    getattr(prev, f) is getattr(host, f)
                    or np.array_equal(getattr(prev, f), getattr(host, f))
                    for f in _STATIC_FIELDS
                ):
                    if prev.available is host.available:
                        pend = dev.get("pending")
                        if pend is None:
                            dirty = None
                        elif pend:
                            dirty = np.unique(
                                np.concatenate([np.asarray(c) for c in pend])
                            ).astype(np.int64)
                            dirty = dirty[dirty < n]
                        else:
                            dirty = np.empty(0, np.int64)
                    else:
                        dirty = np.flatnonzero(
                            np.any(prev.available != host.available, axis=1)
                        )
                    if dirty is not None and not dirty.size:
                        tensors = dev["tensors"]
                        stats["reuse_hits"] += 1
                        self.last_state_upload = "reuse"
                    elif dirty is not None and dirty.size <= max(32, n // 8):
                        rows = host.available[dirty].copy()
                        avail = dev["tensors"].available.index_copy(
                            0,
                            torch.as_tensor(dirty, device=self.device),
                            torch.as_tensor(rows, device=self.device),
                        )
                        tensors = dataclasses.replace(
                            dev["tensors"], available=avail
                        )
                        nbytes = rows.nbytes + dirty.nbytes
                        stats["delta_uploads"] += 1
                        stats["delta_rows"] += int(dirty.size)
                        stats["upload_bytes"] += nbytes
                        self._note_transfer("h2d", nbytes)
                        self.last_state_upload = "delta"
                    else:
                        # A copy: the resident buffer is patched in place.
                        tensors = dataclasses.replace(
                            dev["tensors"],
                            available=torch.tensor(
                                host.available, device=self.device
                            ),
                        )
                        stats["full_uploads"] += 1
                        stats["upload_bytes"] += host.available.nbytes
                        self._note_transfer("h2d", host.available.nbytes)
                        self.last_state_upload = "full"
            if tensors is None:
                tensors = self._upload(host)
                nbytes = _host_nbytes(host)
                stats["full_uploads"] += 1
                stats["upload_bytes"] += nbytes
                self._note_transfer("h2d", nbytes)
                self.last_state_upload = "full"
            tensors.host = host
            self._dev = {"host": host, "tensors": tensors, "pending": []}
            return tensors

    # -- the native arena's resident build --------------------------------

    def _label_rank(self, node: Node, prio) -> int:
        if prio is None:
            return INT32_INF
        label, values = prio
        val = node.labels.get(label)
        if val is not None and val in values:
            return values.index(val)
        return INT32_INF

    def _build_tensors_native(
        self,
        nodes: Sequence[Node],
        usage,
        overhead,
        *,
        full_node_list: bool = False,
        topo_version: Optional[int] = None,
        roster_rows: "np.ndarray | None" = None,
        dirty_hint: "tuple | None" = None,
        avail_epoch: "int | None" = None,
        avail_journal: "dict | None" = None,
    ) -> ClusterTensors:
        """The arena-backed host view (caller holds the build lock).

        Name ranks are GLOBAL and gapped over every known node, not dense
        over the request's subset: every consumer reads rank order only,
        and the order is the same for any subset.

        The serving contract (full node list + topology version) keeps the
        nine buffers resident and patches the changed rows (journal rows
        and arena upserts) in one C call; every other caller (a filtered
        subset, a journal gap, pad growth) materializes every row into
        FRESH buffers, so no earlier handle's arrays are touched."""
        arena = self._arena
        seen = self._node_seen
        topo = topo_version

        def _upsert(node) -> None:
            seen[node.name] = node
            # A re-added name is live again: its tombstone must not
            # release the row under it.
            self._pending_tombstones.discard(node.name)
            idx = self.registry.intern(node.name)
            arena.upsert(
                idx,
                node.allocatable.as_array(),
                self.registry.zone_id(node.zone),
                node.unschedulable,
                node.ready,
                self._label_rank(node, self._driver_label_priority),
                self._label_rank(node, self._executor_label_priority),
            )
            # Pending until a resident patch (or a full snapshot) absorbs
            # this row's statics.
            self._res_pending.append(idx)

        if not (topo is not None and topo == self._topo_seen):
            if (
                dirty_hint is not None
                and full_node_list
                and topo is not None
                and dirty_hint[0] == self._topo_seen
            ):
                # A verified version chain: upsert just the changed nodes.
                # New names take a gapped rank between their neighbours;
                # deleted names tombstone (masked out by the request mask,
                # recycled once their usage drains).
                new_names = [
                    n.name for n in dirty_hint[1] if n.name not in seen
                ]
                for node in dirty_hint[1]:
                    _upsert(node)
                if new_names:
                    self._insert_name_ranks(new_names)
                for name in dirty_hint[2] if len(dirty_hint) > 2 else ():
                    if name in seen:
                        seen.pop(name, None)
                        self._rank_space.remove(name)
                        self._pending_tombstones.add(name)
                self._topo_seen = topo
            else:
                changed_names = False
                for node in nodes:
                    if seen.get(node.name) is node:
                        continue
                    if node.name not in seen:
                        changed_names = True
                    _upsert(node)
                if changed_names or self._rank_epoch < 0:
                    self._assign_all_name_ranks()
                if full_node_list and topo is not None:
                    # Only a full-list walk proves the arena synced to this
                    # version; a filtered subset must not skip later walks.
                    self._topo_seen = topo
        pad = pad_bucket(self.registry.capacity, 8)
        usage_t = self._dense_or_scatter(usage, pad)
        overhead_t = self._dense_or_scatter(overhead, pad)
        # Only the serving contract may consume the resident buffers (a
        # filtered subset would bake its request mask into them), and only
        # a serving build recycles tombstones: its usage and overhead are
        # the store's, where a filtered build (the unschedulable-pod
        # marker's, with no usage) would free a row that still holds
        # reservations.
        serving = topo is not None and full_node_list
        if serving and self._pending_tombstones:
            self._release_tombstones(usage_t, overhead_t)
        res = self._snap_res
        rows_hint = None
        if (
            serving
            and res is not None
            and not self._res_full_pending
            and res["pad"] == pad
        ):
            rows_hint = self._avail_rows_between(
                res.get("avail_epoch"), avail_epoch, avail_journal
            )
        if rows_hint is not None:
            host = self._patch_resident(
                res, rows_hint, usage_t, overhead_t, nodes, topo, pad,
                roster_rows,
            )
            res["avail_epoch"] = avail_epoch
            return host
        return self._snapshot_full(
            pad, usage_t, overhead_t, nodes, topo, serving, roster_rows,
            avail_epoch,
        )

    def _request_mask(self, nodes, topo, pad, roster_rows, cacheable):
        """[pad] bool mask of this request's node rows (the arena knows
        every node ever seen). Memoized on the topology version for a full
        node list only (a filtered subset of the same length would
        collide)."""
        cached = self._topo_request_mask
        if (
            cacheable
            and cached is not None
            and cached[0] == (topo, pad, len(nodes))
        ):
            return cached[1]
        request_mask = np.zeros(pad, dtype=bool)
        if roster_rows is not None and len(roster_rows) == len(nodes):
            request_mask[roster_rows[roster_rows < pad]] = True
        else:
            idxs = [self.registry.index_of(n.name) for n in nodes]
            request_mask[[i for i in idxs if i is not None and i < pad]] = True
        if cacheable:
            if (
                cached is not None
                and cached[1].shape[0] == pad
                and np.array_equal(cached[1], request_mask)
            ):
                # Membership did not move (a node update): keep the old
                # object, whose identity keeps the valid mask and the
                # planner's per-domain contexts stable.
                request_mask = cached[1]
            self._topo_request_mask = ((topo, pad, len(nodes)), request_mask)
        return request_mask

    def _avail_rows_between(self, prev, cur, journal):
        """(usage rows, overhead rows, node rows) changed between the
        resident build's synced availability epoch and the snapshot's,
        from the feature store's journal; None on a gap (a journal break,
        an evicted epoch, a caller that passes no journal). Usage rows
        touch only `available`, overhead rows `schedulable` too, node rows
        any static field."""
        if prev is None or cur is None or journal is None:
            return None
        if cur < prev or cur - prev > 64:
            return None
        empty = np.empty(0, np.int64)
        if cur == prev:
            return empty, empty, empty
        arows: list = []
        orows: list = []
        nrows: list = []
        for e in range(prev + 1, cur + 1):
            ent = journal.get(e)
            if ent is None:
                return None
            arows.append(ent[0])
            orows.append(ent[1])
            nrows.append(ent[2])
        return (
            np.unique(np.concatenate(arows)).astype(np.int64),
            np.unique(np.concatenate(orows)).astype(np.int64),
            np.unique(np.concatenate(nrows)).astype(np.int64),
        )

    def _acc_build_rows(self) -> None:
        """Fold the last build's named rows into the statics-delta
        candidate accumulator (None: the next `_plan_static_delta` takes
        the dense field diff)."""
        rows = self._last_build_rows
        if rows is None:
            self._static_acc = None
            return
        if self._static_acc is None:
            return
        if rows[0].size:
            self._static_acc.append(rows[0])
        if rows[1].size:
            self._static_acc.append(rows[1])

    def _note_consumer_rows(self, rows) -> None:
        """Rows the resident build just patched, appended to the device
        mirrors' pending ledgers (the pipelined and the cached sync compare
        exactly these instead of every row)."""
        for st in (self._pipe, self._dev):
            if st is not None and st.get("pending") is not None:
                st["pending"].append(rows)

    def _note_consumers_unknown(self) -> None:
        """This build could not name its changed rows: each device mirror
        falls back to one dense compare."""
        for st in (self._pipe, self._dev):
            if st is not None:
                st["pending"] = None

    def _mirror_dirty(self, p, host, mirror) -> np.ndarray:
        """Rows whose availability the next delta upload must ship.

        The pipeline's pending ledger (rows the resident build patched and
        rows fetched placements debited from the mirror) is a superset of
        every mirror-vs-host difference, so the sync compares just those
        rows. A build that could not name its rows leaves the ledger None
        and the dense [N] compare runs once (`mirror_dense_syncs`). With
        `build_oracle` the dense compare also runs after every dirty-set
        sync and a missed row raises."""
        pend = p.get("pending")
        bs = self.build_stats
        if pend is None:
            dirty = np.flatnonzero((mirror != host.available).any(axis=1))
            bs["mirror_rows_compared"] += int(mirror.shape[0])
            bs["mirror_dense_syncs"] += 1
            return dirty
        if pend:
            cand = np.unique(np.concatenate([np.asarray(c) for c in pend]))
            cand = cand.astype(np.int64)
            cand = cand[cand < mirror.shape[0]]
        else:
            cand = np.empty(0, np.int64)
        if cand.size:
            neq = (mirror[cand] != host.available[cand]).any(axis=1)
            dirty = cand[neq]
        else:
            dirty = cand
        bs["dirty_rows"] += int(cand.size)
        if self.build_oracle:
            bs["oracle_checks"] += 1
            oracle = np.flatnonzero((mirror != host.available).any(axis=1))
            missed = np.setdiff1d(oracle, dirty)
            if missed.size:
                raise AssertionError(
                    "dirty-set mirror sync missed changed rows "
                    f"{missed[:8].tolist()} (of {missed.size})"
                )
        return dirty

    def _res_tensors(self, res) -> ClusterTensors:
        """The resident buffers as a host ClusterTensors. The bool views of
        the uint8 backings are memoized: a view's identity stays stable
        while its backing does, so the pipelined statics compare settles
        unchanged fields with `is`."""
        f = res["fields"]
        views = res.setdefault("views", {})
        for name in ("unschedulable", "ready"):
            v = views.get(name)
            if v is None or v.base is not f[name]:
                views[name] = v = f[name].view(np.bool_)
        return ClusterTensors(
            f["available"],
            f["schedulable"],
            f["zone_id"],
            f["name_rank"],
            f["label_rank_driver"],
            f["label_rank_executor"],
            views["unschedulable"],
            views["ready"],
            res["valid_req"],
        )

    def _snapshot_full(
        self, pad, usage_t, overhead_t, nodes, topo, serving, roster_rows,
        avail_epoch,
    ) -> ClusterTensors:
        """Every row materialized into FRESH buffers (the cold build, pad
        growth, a journal gap, a filtered subset). Earlier handles keep
        the old arrays; a serving build makes the new ones resident."""
        raw = self._arena.snapshot_raw(pad, usage_t, overhead_t)
        fields = dict(zip(_RES_FIELDS, raw))
        request_mask = self._request_mask(nodes, topo, pad, roster_rows, serving)
        valid_req = fields["valid"].view(np.bool_) & request_mask
        self._last_build_rows = None
        self._acc_build_rows()
        self._note_consumers_unknown()
        if serving:
            self._snap_res = res = {
                "pad": pad,
                "avail_epoch": avail_epoch,
                "mask": request_mask,
                "fields": fields,
                "valid_req": valid_req,
            }
            self._res_pending = []
            self._res_full_pending = False
            self._res_statics_moved = True
            self.build_stats["full_snapshots"] += 1
            return self._res_tensors(res)
        return ClusterTensors(
            *raw[:6], raw[6].view(np.bool_), raw[7].view(np.bool_), valid_req,
        )

    def _patch_resident(
        self, res, rows_hint, usage_t, overhead_t, nodes, topo, pad,
        roster_rows,
    ) -> ClusterTensors:
        """The O(K + changed) build: recompute exactly the changed rows
        into the resident buffers. Node rows copy every static field
        first, overhead rows only `schedulable`, so in-flight handles keep
        their dispatch-time statics. The copy is also what the pipelined
        build's static row delta relies on: it finds the static rows to
        ship by comparing the previous host view's arrays with these, and
        an in-place static patch would hide a node event from the card.
        `available` is patched in place, with an undo entry while pruned
        or pooled handles are in flight."""
        arows, orows, nrows = rows_hint
        if self._res_pending:
            prows = np.unique(np.asarray(self._res_pending, np.int64))
            self._res_pending = []
            nrows = np.union1d(nrows, prows) if nrows.size else prows
        patch = arows
        for extra in (orows, nrows):
            if extra.size:
                patch = np.union1d(patch, extra) if patch.size else extra
        f = res["fields"]
        mask = self._request_mask(nodes, topo, pad, roster_rows, True)
        mask_changed = mask is not res["mask"]
        if patch.size:
            if nrows.size:
                for name in _RES_FIELDS[1:]:
                    f[name] = f[name].copy()
                self._res_statics_moved = True
            elif orows.size:
                f["schedulable"] = f["schedulable"].copy()
                self._res_statics_moved = True
            avail = f["available"]
            if self._avail_handles:
                # Trim the undo journal to the oldest live handle's
                # generation before appending: serving keeps a handle in
                # flight, so clearing only when none is would never clear.
                gens = [
                    h.avail_gen for h in self._avail_handles
                    if h.avail_gen is not None
                ]
                if gens:
                    min_gen = min(gens)
                    if self._avail_undo and self._avail_undo[0][0] < min_gen:
                        self._avail_undo = [
                            e for e in self._avail_undo if e[0] >= min_gen
                        ]
                self._avail_undo.append(
                    (self._avail_gen, avail, patch, avail[patch].copy())
                )
            elif self._avail_undo:
                self._avail_undo.clear()
            self._avail_gen += 1
            self._arena.snapshot_rows(
                patch, usage_t, overhead_t,
                f["available"], f["schedulable"], f["zone_id"],
                f["name_rank"], f["label_rank_driver"],
                f["label_rank_executor"], f["unschedulable"], f["ready"],
                f["valid"],
            )
            self._note_consumer_rows(patch)
        if mask_changed:
            res["mask"] = mask
            res["valid_req"] = f["valid"].view(np.bool_) & mask
        elif nrows.size:
            vals = f["valid"].view(np.bool_)[nrows] & mask[nrows]
            if not np.array_equal(vals, res["valid_req"][nrows]):
                # Copy only when validity moved: a flip that leaves it
                # (unschedulable, labels) keeps the valid mask's identity.
                vr = res["valid_req"].copy()
                vr[nrows] = vals
                res["valid_req"] = vr
        # The planner's feed: overhead rows move availability keys, node
        # rows are static dirt.
        self._last_build_rows = (
            np.union1d(arows, orows) if orows.size else arows,
            nrows,
        )
        self._acc_build_rows()
        self.build_stats["incremental_builds"] += 1
        return self._res_tensors(res)

    def _release_tombstones(self, usage_t, overhead_t) -> None:
        """Recycle deleted nodes' registry rows: a row whose reservation
        usage and overhead drained re-enters the registry's free list (a
        later node add reuses it; its statics ship as an ordinary static
        row delta). A row with leftovers stays parked and is retried every
        build; so is every row while a window is in flight (its fetch may
        still name the row), and every row whose name the registry's
        `row_holder` still holds: the overhead rows here are masked to
        live nodes, so a deleted node's surviving pods show only there
        (the JAX solver recycles such a row, and the next node to take it
        inherits their overhead)."""
        p = self._pipe
        if p is not None and p["unfetched"]:
            return
        still = set()
        holder = self.registry.row_holder
        for name in self._pending_tombstones:
            row = self.registry.index_of(name)
            if row is None:
                continue
            if (
                row < usage_t.shape[0]
                and row < overhead_t.shape[0]
                and not usage_t[row].any()
                and not overhead_t[row].any()
                and not (holder is not None and holder(name))
            ):
                self.registry.remove(name)
                self.tombstones_recycled += 1
            else:
                still.add(name)
        self._pending_tombstones = still

    def _scatter_all_ranks(self) -> None:
        space = self._rank_space
        index_of = self.registry.index_of
        idx = np.fromiter(
            (index_of(name) for name in space.names),
            np.int64,
            count=len(space.names),
        )
        self._arena.set_name_ranks(np.empty(0, np.int64))  # every slot INF
        self._arena.set_name_rank_values(idx, np.asarray(space.ranks, np.int32))

    def _assign_all_name_ranks(self) -> None:
        """Assign every known name its rank from scratch (the cold path):
        every slot's rank moves, so the next build snapshots in full."""
        self._res_full_pending = True
        self._rank_space.assign_all(sorted(self._node_seen))
        self._scatter_all_ranks()
        self._rank_epoch += 1

    def _insert_name_ranks(self, names: list[str]) -> None:
        """Rank the newly added names, O(changed). A crowded gap relabels
        its neighbourhood (those rows ride the resident build's static
        dirt); only an exhausted space renumbers every rank."""
        space = self._rank_space
        changed: list[str] = []
        renumbered = False
        for name in names:
            out = space.insert(name)
            if out is None:
                renumbered = True
            elif not renumbered:
                changed.extend(out)
        index_of = self.registry.index_of
        if renumbered:
            self._scatter_all_ranks()
            self._res_full_pending = True
            self._prune_invalidate()
        elif changed:
            pairs = [
                (r, n)
                for r, n in ((index_of(n), n) for n in changed)
                if r is not None
            ]
            if pairs:
                # rank_of at scatter time: a name a later rebalance moved
                # again scatters its final value.
                self._arena.set_name_rank_values(
                    np.asarray([r for r, _ in pairs], np.int64),
                    np.asarray([space.rank_of(n) for _, n in pairs], np.int32),
                )
                self._res_pending.extend(int(r) for r, _ in pairs)
        self._rank_epoch += 1

    def _dense_or_scatter(self, mapping, pad: int) -> np.ndarray:
        """[pad, 3] int64 usage or overhead: a dense array is taken as it is
        when it already has the pad's shape (the feature store's resident
        masters; no consumer writes it), else padded or cut in one copy
        (rows past the registry can only be zeros); a map scatters entry
        by entry."""
        if isinstance(mapping, np.ndarray):
            if (
                mapping.shape[0] == pad
                and mapping.dtype == np.int64
                and mapping.flags.c_contiguous
            ):
                return mapping
            out = np.zeros((pad, NUM_DIMS), dtype=np.int64)
            rows = min(pad, mapping.shape[0])
            out[:rows] = mapping[:rows]
            return out
        out = np.zeros((pad, NUM_DIMS), dtype=np.int64)
        for name, res in mapping.items():
            idx = self.registry.index_of(name)
            if idx is not None and idx < pad:
                out[idx] += res.as_array()
        return out

    def _avail_at_dispatch(self, handle) -> np.ndarray:
        """The int32 host availability as of `handle`'s dispatch: the
        resident buffer with the undo entries newer than the handle's
        generation replayed in reverse. Rare paths only (escalations,
        greedy and re-dispatch re-solves, pooled whole-window fetches)."""
        arr = handle.host_avail32
        gen = handle.avail_gen
        with self._build_lock:
            entries = [
                e for e in self._avail_undo if e[1] is arr and e[0] >= gen
            ]
            if not entries:
                return arr.copy()
            out = arr.copy()
            for _g, _buf, rows, old in reversed(entries):
                out[rows] = old
            return out

    def _track_avail(self, handle, host) -> None:
        """Point a pruned or pooled handle at the resident host buffer
        (no dense copy at dispatch) and register it for the undo
        journal."""
        handle.host_avail32 = np.asarray(host.available)
        with self._build_lock:
            handle.avail_gen = self._avail_gen
            self._avail_handles.add(handle)

    def close(self) -> None:
        """Release the pipelined device state (the app's shutdown): cancel
        the pool's queued part solves of this solver (the shared workers
        stay up for other solvers) and wait for its running ones
        (`_await_inflight`), drop the pipeline, the gathered statics, fused
        buffers and every slot's resident replicas. A dispatch after
        close() raises. On one device a dispatch's decision copy is queued
        on the card's stream: there is nothing to cancel. A running part
        that failed with an error no device fault explains raises here,
        once the state is released."""
        self._closed = True
        for fut in list(self._inflight_futures):
            fut.cancel()
        try:
            self._await_inflight()
        finally:
            self._inflight_futures.clear()
            self._pipe = None
            self._dev = None
            with self._build_lock:
                self._snap_res = None  # the resident host buffers
                self._avail_undo.clear()
            self._poisoned.clear()
            self._prune_gather_cache.clear()  # release the gathered statics
            self._release_fused()
            self._release_pool()
            self._note_inflight()

    def discard_pipeline(self) -> None:
        """Drop the pipelined device state: the next build_tensors_pipelined
        does a full upload from the host view. Used when in-flight window
        decisions are being discarded (capacity changed under them) — the
        host view is the durable truth once every surviving window has
        applied. Fused batches in flight release their decision buffers:
        their decisions are discarded with the pipeline, and the pooled
        part solves still running end first (`_await_inflight`: the wait
        runs where a window's fetch would wait, in its completion; no part
        solve takes the build lock or the trace order lock)."""
        try:
            self._await_inflight()
        finally:
            self._pipe = None
            self._poisoned.clear()
            self._prune_gather_cache.clear()  # release the gathered statics
            self._release_fused()
            self._release_pool()
            self._note_inflight()
            if self.telemetry is not None:
                self.telemetry.on_pipeline_event("discard")

    def _await_inflight(self) -> None:
        """Wait, up to PART_WAIT_S, for this solver's part solves still on
        the shared pool (`_await_parts`); a solve still running then is
        taken as stuck on a dead device and logged, and the slot's buffers
        it reads stay allocated on its stream (PoolSlot.release)."""
        stuck = self._await_parts(
            list(self._inflight_futures.items()), timeout=PART_WAIT_S
        )
        if stuck:
            from spark_scheduler_tpu_torch.tracing import svc1log

            svc1log().warn(
                "part solve still running after the wait",
                devices=sorted({slot.label for _f, slot in stuck}),
                wait_s=PART_WAIT_S,
            )

    def _await_parts(self, parts, timeout=None) -> list:
        """Wait for pooled part solves [(future, slot)] that a route ends
        or abandons: each part that ended releases its slot's in-flight
        count, a classified device fault quarantines its slot, and once
        every part has ended (or `timeout` passed) the first other failure
        raises. A cancelled part only releases its count. Returns the
        [(future, slot)] still running at `timeout`. Never on a worker of
        the shared pool, where it could wait for itself, and never under
        the build lock."""
        if not parts:
            return []
        if on_solve_worker():
            raise RuntimeError("a part solve is awaited on a worker of its pool")
        pending = wait([f for f, _slot in parts], timeout=timeout).not_done
        failure = None
        for fut, slot in parts:
            if fut in pending:
                continue
            if not fut.cancelled():
                exc = fut.exception()
                if exc is not None:
                    if classify_slot_failure(exc):
                        self._quarantine_slot(slot, exc)
                    elif failure is None:
                        failure = exc
            slot.inflight = max(0, slot.inflight - 1)
            if self.telemetry is not None:
                self.telemetry.on_device_inflight(slot.label, slot.inflight)
        if failure is not None:
            raise failure
        return [(f, slot) for f, slot in parts if f in pending]

    def _release_fused(self) -> None:
        for h in list(self._fused_owners):
            h.release_buffers()
        self._fused_owners.clear()

    def _note_inflight(self) -> None:
        """Publish the dispatched-but-unfetched pipelined windows."""
        if self.telemetry is not None:
            p = self._pipe
            self.telemetry.on_device_inflight(
                str(self.device), len(p["unfetched"]) if p is not None else 0
            )

    def build_tensors_solo(
        self, nodes: Sequence[Node], usage, overhead, **hints
    ) -> ClusterTensors:
        """Tensors for a solo solve while the pipelined build raises
        PipelineDrainRequired: the host view (build_tensors), minus the
        gangs of every window in flight, as the threaded base would have
        shown them.

        - Windows dispatched on a carry that a pruned window's escalation
          dropped and not fetched yet re-solve here, in dispatch order, and
          their fetches return these decisions.
        - Windows in flight on the live pipeline (a topology change or an
          int32 swing refused the pipelined build) are read from their
          decision blobs (`_inflight_placements`), and only the views the
          mirror has not debited yet. The blob stays on the handle: the
          fetch reads the same bytes.

        The keyword arguments are those of build_tensors. The host view's
        arrays are never written here: the debits go into copies."""
        host = self._build_host(nodes, usage, overhead, **hints)
        p = self._pipe
        if p is not None and p["unfetched"]:
            avail = host.available.astype(np.int64)
            for name, amounts in self._inflight_placements(p["unfetched"]):
                row = self.registry.index_of(name)
                if row is not None and host.valid[row]:
                    avail[row] -= amounts
            host = dataclasses.replace(
                host,
                available=np.clip(avail, _INT32.min, _INT32.max).astype(np.int32),
            )
            self.solo_inflight_debits += 1
        if self._poisoned:
            avail = host.available.astype(np.int64)
            for h, fetched in list(self._poisoned.items()):
                bounds = h.fused_bounds or [(0, len(h.requests))]
                if h.resolved is None and h.requests:
                    if h.greedy:
                        h.resolved = self._fetch_fallback(h, bounds)
                    elif h.use_fallback:
                        h.resolved = self._resolve_full(h, bounds)
                for i, (rows, amounts) in enumerate(h.window_placements or ()):
                    if i not in fetched and rows.size:
                        avail[rows] -= amounts
            host = dataclasses.replace(
                host,
                available=np.clip(avail, _INT32.min, _INT32.max).astype(np.int32),
            )
        return self._upload(host)

    def _inflight_placements(self, handles):
        """(node name, int64 [3] amount) of every committed placement of
        the windows of `handles` (dispatched, not fetched) whose views the
        mirror has not debited, read from each dispatch's decision blob
        (waiting for its copy to land, as its fetch would). Keyed by name:
        a build after a topology change maps them onto its own rows. A
        pruned dispatch's blob is in kept-local rows (the plan maps them);
        its certificate is not run here: the blob is what the device's
        carry embodies."""
        name_of = self.registry.name_of
        for h in handles:
            bounds = h.fused_bounds or [(0, len(h.requests))]
            if h.window_placements is not None:
                for i, (rows, amounts) in enumerate(h.window_placements):
                    if i not in h.applied:
                        for r, a in zip(rows, amounts):
                            yield name_of(int(r)), a
                continue
            if h.parts is not None:
                # A pooled dispatch: each part's blob, in its own row space.
                pieces = [
                    (p.future.result()["blob"].astype(np.int64), p.req_ids,
                     p.rows.drv_arr.astype(np.int64),
                     p.rows.exc_arr.astype(np.int64),
                     None if p.idx is None else p.idx.astype(np.int64))
                    for p in h.parts
                ]
            else:
                blob = h.fetch_blob()[h.seg_map[0], h.seg_map[1]]
                pieces = [(
                    blob.astype(np.int64), range(len(h.requests)),
                    h.row_driver_req, h.row_exec_req,
                    h.prune.keep.astype(np.int64) if h.prune is not None else None,
                )]
            window_of = np.zeros(len(h.requests), np.int64)
            for i, (lo, hi) in enumerate(bounds):
                window_of[lo:hi] = i
            for blob, req_ids, drv64, exc64, gmap in pieces:
                drivers, admitted, execs = blob[:, 0], blob[:, 1], blob[:, 3:]
                real = -1
                for k in req_ids:
                    real += len(h.requests[k].rows)
                    if window_of[k] in h.applied or not admitted[real]:
                        continue
                    slots = [(drivers[real], drv64[real])]
                    slots += [(e, exc64[real]) for e in execs[real]]
                    for row, amount in slots:
                        if row >= 0:
                            if gmap is not None:
                                row = gmap[row]
                            yield name_of(int(row)), amount

    def build_tensors_pipelined(
        self,
        nodes: Sequence[Node],
        usage,
        overhead,
        topo_version: Optional[int] = None,
        statics_version: Optional[int] = None,
        roster_rows=None,
        dirty_hint=None,
        avail_epoch=None,
        avail_journal=None,
    ) -> ClusterTensors:
        """Timing and telemetry shell around the pipelined build: its wall
        time (`build_stats`, `solver.build.ms`), the rows a dense mirror
        sweep examined and the rows the event-fed dirty-set sync examined
        (`on_build`), and how the build reached the device
        (`on_device_upload`). The keyword arguments are build_tensors'
        accelerators; `statics_version` is the feature store's statics
        epoch (see _build_tensors_pipelined). The build holds the build
        lock throughout, so a build on another thread never lands between
        the host build and the mirror sync."""
        bs = self.build_stats
        with self._build_lock:
            compared0 = bs["mirror_rows_compared"]
            dirty0 = bs["dirty_rows"]
            t0 = time.perf_counter()
            try:
                tensors = self._build_tensors_pipelined(
                    nodes, usage, overhead,
                    topo_version=topo_version,
                    statics_version=statics_version,
                    roster_rows=roster_rows,
                    dirty_hint=dirty_hint,
                    avail_epoch=avail_epoch,
                    avail_journal=avail_journal,
                )
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                bs["builds"] += 1
                bs["build_ms"] += ms
                if self.telemetry is not None:
                    self.telemetry.on_build(
                        ms,
                        bs["mirror_rows_compared"] - compared0,
                        bs["dirty_rows"] - dirty0,
                    )
        if self.telemetry is not None:
            self.telemetry.on_device_upload(
                str(self.device), self.last_state_upload
            )
        return tensors

    def _build_tensors_pipelined(
        self,
        nodes: Sequence[Node],
        usage,
        overhead,
        topo_version: Optional[int] = None,
        statics_version: Optional[int] = None,
        roster_rows=None,
        dirty_hint=None,
        avail_epoch=None,
        avail_journal=None,
    ) -> ClusterTensors:
        """Device-resident availability threaded ACROSS serving windows.

        The device availability stays equal to `last window's committed
        base` + `external deltas`: the row walk's `base_after` from the
        previous dispatch, plus the ADDITIVE difference between the current
        host view and an int64 mirror of what the device already embodies.
        A window's gang placements are debited from the mirror when the
        window is fetched (pack_window_fetch), so the host's own
        reservation bookkeeping for those gangs is not shipped a second
        time — and a gang whose reservation the host then failed to create
        is restored by the next delta. This is what makes it safe to
        DISPATCH window k+1 before FETCHING window k.

        The mirror syncs over the pending ledger (`_mirror_dirty`): the
        rows the resident build patched and the rows fetches debited. A
        build that named no rows leaves a dense compare.

        `statics_version` (the feature store's statics epoch) equal to the
        pipeline's proves the static fields unchanged and skips their
        compare, unless the resident build patched a static row since the
        last sync. A static-field change that touches few rows ships as a
        row scatter (`delta_statics`, diffed over the rows the builds
        named); any other static change needs a full upload, which raises
        PipelineDrainRequired while a window is in flight — fetch it first,
        then retry. So does an availability delta beyond int32.

        After a pruned window's escalation dropped the pipeline, the build
        raises PipelineDrainRequired until every window dispatched on the
        dropped carry has been fetched: their gangs are on no device base
        and in no host view yet, and a window dispatched on a fresh upload
        would not see them (the JAX package does not wait, and such a
        window can over-commit). So does a device fault that dropped the
        pipeline (`_drop_pipeline`), and a pooled window's base combine
        that failed drops it here."""
        self._resolve_base()
        if self._pipe is None and self._poisoned:
            if self.telemetry is not None:
                self.telemetry.on_pipeline_event("drain")
            raise PipelineDrainRequired(
                "windows dispatched on a carry a pruned window's escalation "
                "dropped are still in flight"
            )
        host = self._build_host(
            nodes, usage, overhead,
            full_node_list=True, topo_version=topo_version,
            roster_rows=roster_rows, dirty_hint=dirty_hint,
            avail_epoch=avail_epoch, avail_journal=avail_journal,
        )
        stats = self.device_state_stats
        p = self._pipe
        static_plan = None
        statics_same = False
        if p is not None and p["host"].available.shape == host.available.shape:
            statics_same = (
                statics_version is not None
                and statics_version == p.get("statics_version")
                and not self._res_statics_moved
            ) or all(
                # Identity first: the resident build shares unchanged
                # static arrays across builds.
                getattr(p["host"], f) is getattr(host, f)
                or np.array_equal(getattr(p["host"], f), getattr(host, f))
                for f in _STATIC_FIELDS
            )
            if not statics_same and self._delta_statics:
                # In-flight windows are unaffected: their decisions were
                # computed from (and reconstruct against) their own
                # dispatch-time host view, exactly as with availability
                # deltas.
                static_plan = self._plan_static_delta(p["host"], host)
        if statics_same or static_plan is not None:
            mirror = p["mirror"]
            dirty = self._mirror_dirty(p, host, mirror)
            delta_rows = host.available[dirty].astype(np.int64) - mirror[dirty]
            # A swing too large for int32 delta rows falls through to a
            # FULL re-upload instead of wrapping and corrupting the base.
            fits_i32 = dirty.size == 0 or (
                delta_rows.min() >= _INT32.min and delta_rows.max() <= _INT32.max
            )
            if not fits_i32 and p["unfetched"]:
                if self.telemetry is not None:
                    self.telemetry.on_pipeline_event("drain")
                raise PipelineDrainRequired(
                    "availability delta exceeds int32 with a window in flight"
                )
            if fits_i32:
                static_fields = {}
                if static_plan is not None:
                    static_fields = self._apply_static_delta(p, static_plan, host)
                avail = p["avail"]
                if dirty.size:
                    # The prune planner's O(changed) sync and the pool
                    # slots' availability mirrors ride exactly this dirty
                    # set (and the fetched placement rows).
                    self._prune_note_rows(dirty)
                    self._avail_journal_note(p, dirty)
                    # Out of place: the base a caller still holds (through
                    # an earlier build's tensors) is never written.
                    rows32 = delta_rows.astype(np.int32)
                    avail = avail.index_add(
                        0,
                        torch.as_tensor(dirty, device=self.device),
                        torch.as_tensor(rows32, device=self.device),
                    )
                    mirror[dirty] = host.available[dirty]
                    nbytes = dirty.nbytes + rows32.nbytes
                    stats["delta_uploads"] += 1
                    stats["delta_rows"] += int(dirty.size)
                    stats["upload_bytes"] += nbytes
                    self._note_transfer("h2d", nbytes)
                    self.last_state_upload = "delta"
                elif static_plan is not None:
                    self.last_state_upload = "delta"
                else:
                    stats["reuse_hits"] += 1
                    self.last_state_upload = "reuse"
                tensors = dataclasses.replace(
                    p["tensors"], available=avail, **static_fields
                )
                tensors.host = host
                # Which views of each in-flight window the mirror has
                # debited as of THIS build: the host view holds their
                # reservations, the device base lacks only the rest.
                debited = {h: frozenset(h.applied) for h in p["unfetched"]}
                p.update(
                    host=host, tensors=tensors, avail=avail, debited=debited,
                    statics_version=statics_version,
                    # Mirror synced: the ledger drains.
                    pending=[],
                )
                self._static_acc = []
                self._res_statics_moved = False
                return tensors
        if p is not None and p["unfetched"]:
            if self.telemetry is not None:
                self.telemetry.on_pipeline_event("drain")
            raise PipelineDrainRequired(
                "cluster topology changed with a window in flight"
            )
        tensors = self._upload(host)
        nbytes = _host_nbytes(host)
        stats["full_uploads"] += 1
        stats["upload_bytes"] += nbytes
        self._note_transfer("h2d", nbytes)
        self.last_state_upload = "full"
        # The statics may have changed: the gathered statics and every pool
        # replica start again from this host view (the journal cannot
        # bridge a full upload). The prune planner keys on host state: when
        # this build named its changed rows it stays resident (lazy warm
        # start).
        self._static_epoch += 1
        self._static_journal.clear()
        self._static_acc = []
        self._res_statics_moved = False
        self._prune_full_upload()
        self._pipe = {
            "host": host,
            "tensors": tensors,
            "avail": tensors.available,
            "mirror": host.available.astype(np.int64),
            "unfetched": [],
            "debited": {},
            "statics_version": statics_version,
            # The dirty-row ledger of the event-fed mirror sync: rows the
            # resident build patches and rows fetched placements debit;
            # None = unknown (a dense compare next build). Empty now: the
            # mirror IS the host view.
            "pending": [],
            # The availability epoch and journal of the pool slots'
            # mirrors: each change of the canonical base bumps the epoch
            # and journals its rows (None: unknowable). A fresh token: no
            # replica from before is a catch-up base.
            "avail_epoch": 0,
            "avail_journal": {},
            "token": next(self._pipe_tokens),
        }
        return tensors

    def _resolve_base(self) -> None:
        """Resolve a pooled window's pending committed-base combine (each
        partition's sub-base scattered back into the global base). A
        combine that failed (a part's solve died) leaves the base
        unknowable: the pipeline drops, exactly as after a failed fetch."""
        p = self._pipe
        if p is not None and isinstance(p["avail"], PendingBase):
            try:
                p["avail"] = p["avail"].result()
            except Exception:
                self._drop_pipeline("fetch-failure")

    def _plan_static_delta(self, prev, host):
        """(changed field names, dirty rows) when the static drift between
        two same-shape host views is small enough to ship as a row
        scatter; None sends the caller to the full-upload/drain path.

        When every build since the last sync named its rows
        (`_static_acc`), the diff runs over just those rows: the resident
        build only ever rewrites named rows (its statics copy-on-write), so
        they are a superset of every field difference. Otherwise the dense
        diff runs."""
        n = host.available.shape[0]
        acc = self._static_acc
        cand = None
        if acc is not None:
            cand = (
                np.unique(np.concatenate(acc)).astype(np.int64)
                if acc
                else np.empty(0, np.int64)
            )
            cand = cand[cand < n]
            if not cand.size:
                # A field differs but no build named a row: take the
                # dense diff.
                cand = None
        changed: list[str] = []
        sel = cand if cand is not None else slice(None)
        rows_mask = np.zeros(cand.shape[0] if cand is not None else n, bool)
        for f in _STATIC_FIELDS:
            a = np.asarray(getattr(prev, f))
            b = np.asarray(getattr(host, f))
            if a is b:
                continue
            neq = a[sel] != b[sel]
            if neq.ndim == 2:
                neq = neq.any(axis=1)
            if neq.any():
                changed.append(f)
                rows_mask |= neq
        if not changed:
            return None
        rows = cand[rows_mask] if cand is not None else np.flatnonzero(rows_mask)
        if len(rows) > max(32, n // 8):
            return None
        return changed, rows

    def _apply_static_delta(self, p, plan, host) -> dict:
        """The changed static-field rows scattered into copies of the
        resident device fields; returns them for dataclasses.replace."""
        changed, rows = plan
        idx = torch.as_tensor(rows, device=self.device)
        out = {}
        nbytes = rows.nbytes
        for f in changed:
            cur = getattr(p["tensors"], f)
            host_vals = np.asarray(getattr(host, f))[rows]
            nbytes += host_vals.nbytes
            vals = torch.as_tensor(host_vals, device=self.device).to(cur.dtype)
            out[f] = cur.index_copy(0, idx, vals)
        stats = self.device_state_stats
        stats["static_delta_uploads"] += 1
        stats["static_delta_rows"] += int(rows.size)
        stats["upload_bytes"] += nbytes
        self._note_transfer("h2d", nbytes)
        self._static_epoch += 1
        # Pool replicas catch up by scattering the same rows.
        self._static_journal[self._static_epoch] = rows
        while len(self._static_journal) > 64:
            self._static_journal.pop(next(iter(self._static_journal)))
        if self._planner is not None:
            # Static dirt: a kept row's zone or validity flip re-scans its
            # zone; a new valid row merges exactly.
            self._planner.note_static(rows)
        for ck, ent in list(self._prune_gather_cache.items()):
            # A gathered statics entry whose rows just changed is stale;
            # entries the delta missed keep serving.
            if np.isin(rows, ent["keep"]).any():
                self._prune_gather_cache.pop(ck, None)
        return out

    def _note_transfer(self, direction: str, nbytes: int) -> None:
        if self.telemetry is not None:
            self.telemetry.on_transfer(direction, nbytes)

    def _ensure_probed(self) -> None:
        if self.device.type == "cuda" and not self._probed:
            with self._probe_lock:
                if not self._probed:
                    probe(self.device)
                    self._probed = True

    def candidate_mask(self, tensors, node_names: Sequence[str]) -> np.ndarray:
        """[N] bool host mask of the named nodes (read-only, memoized).

        Native-ingest tickets (server/ingest.NativeNodeNames) hash by their
        content digest with memcmp equality: the memo keys on the ticket
        itself, so a steady-state request (kube-scheduler resends the same
        candidate list every call) hits WITHOUT materializing its names or
        hashing a tuple of them; only a cold miss iterates. Plain lists
        keep the tuple key. Across registry epochs (a node add or a
        recycled row) a cached mask is patched from the registry's journal
        (`_cand_try_patch`) instead of rebuilt by a walk over every name."""
        n = tensors.num_nodes
        names = (
            node_names
            if getattr(node_names, "names_digest", None) is not None
            else tuple(node_names)
        )

        def _build():
            mask = np.zeros(n, dtype=bool)
            unresolved: set = set()
            index_of = self.registry.index_of
            for name in names:
                idx = index_of(name)
                if idx is not None and idx < n:
                    mask[idx] = True
                elif idx is None:
                    # A name with no registry row yet: its mask bit flips
                    # if it ever interns (the patch must know it).
                    unresolved.add(name)
            mask.flags.writeable = False
            return mask, unresolved

        for _ in range(4):
            epoch = self.registry.epoch
            if epoch & 1:  # a mapping change in flight: the walk would tear
                continue
            key = (n, epoch, names)
            with self._cand_lock:
                mask = self._cand_cache.get(key)
                if mask is not None:
                    self._cand_cache.move_to_end(key)
                    return mask
                patched = self._cand_try_patch(names, n, epoch)
            shared = self._sweep_shared
            hit = None
            if patched is None and shared is not None:
                # Replay sweep: a sibling lane's mask for the same (n,
                # epoch, names) is this lane's mask (node events are
                # inputs, so the registries agree).
                with self._cand_lock:
                    hit = shared.get(key)
                    if hit is not None:
                        shared["__hits__"] = shared.get("__hits__", 0) + 1
            if patched is not None:
                mask, unresolved, removed = patched
            elif hit is not None:
                (mask, unresolved), removed = hit, set()
            else:
                (mask, unresolved), removed = _build(), set()
            # Seqlock read: cache only a walk over one stable mapping.
            if self.registry.epoch == epoch:
                with self._cand_lock:
                    if shared is not None:
                        shared.setdefault(key, (mask, unresolved))
                    self._cand_cache[key] = mask
                    while len(self._cand_cache) > 64:
                        self._cand_cache.popitem(last=False)
                    self._cand_patch[names] = (epoch, n, mask, unresolved, removed)
                    self._cand_patch.move_to_end(names)
                    while len(self._cand_patch) > 16:
                        self._cand_patch.popitem(last=False)
                if getattr(names, "patch_base", None) is not None:
                    # Re-based: drop the lineage so older tickets can go.
                    try:
                        names.patch_base = None
                    except AttributeError:
                        pass
                return mask
        # The registry churned through every try: one consistent build
        # under its lock (not cached: the epoch is stale by construction).
        return self.registry.read_consistent(lambda: _build()[0])

    def _cand_try_patch(self, names, n: int, epoch: int):
        """Patch a cached candidate mask across registry epochs from the
        registry's mapping journal (models/cluster.NodeRegistry
        .journal_between); the caller holds the memo lock. The patch is
        exact: a newly interned name is a member iff it was unresolved
        (named before it had a row) or removed (deleted, then re-added); a
        removed name clears its row and parks in `removed`. Domain tickets
        also carry lineage (core/extender._DomainNames patch_base /
        patch_added / patch_removed): the patch follows the chain to the
        last ticket it has a base for and replays the membership deltas
        oldest first. Returns (mask, unresolved, removed), or None (no
        base, a journal gap, too many changes, another pad)."""
        prev = self._cand_patch.get(names)
        lineage: list = []
        base_key = names
        while prev is None and len(lineage) < 8:
            base = getattr(base_key, "patch_base", None)
            if base is None:
                return None
            lineage.append(base_key)
            base_key = base
            prev = self._cand_patch.get(base_key)
        if prev is None:
            return None
        e0, n0, mask0, unresolved0, removed0 = prev
        # An equal epoch is patchable only with lineage (membership deltas
        # of a node update or delete move no registry epoch).
        if n0 != n or epoch < e0 or (epoch == e0 and not lineage):
            return None
        ops = self.registry.journal_between(e0, epoch)
        if ops is None or len(ops) > 4096:
            return None
        # Copy on WRITE: when no change flips a bit (a node event elsewhere
        # moved the epoch), the same mask object re-caches, and its
        # identity keeps the planner's per-domain contexts warm.
        mask = mask0
        writable = False

        def _w():
            nonlocal mask, writable
            if not writable:
                mask = mask0.copy()
                writable = True

        unresolved = set(unresolved0)
        removed = set(removed0)
        for op, nm, row in ops:
            if op == "add":
                member = nm in removed or nm in unresolved
                removed.discard(nm)
                unresolved.discard(nm)
                if row < n:
                    if bool(mask[row]) != member:
                        _w()
                        mask[row] = member
                elif member:
                    return None  # a member beyond the pad: rebuild
            elif row < n and mask[row]:
                removed.add(nm)
                _w()
                mask[row] = False
        index_of = self.registry.index_of
        for tk in reversed(lineage):
            for nm in tk.patch_removed:
                row = index_of(nm)
                if row is not None and row < n and mask[row]:
                    _w()
                    mask[row] = False
                unresolved.discard(nm)
                removed.discard(nm)
            for nm in tk.patch_added:
                removed.discard(nm)
                row = index_of(nm)
                if row is None:
                    unresolved.add(nm)
                elif row < n:
                    if not mask[row]:
                        _w()
                        mask[row] = True
                else:
                    return None
        if writable:
            mask.flags.writeable = False
        return mask, unresolved, removed

    def _num_zones_bucket(self) -> int:
        return pad_bucket(max(self.registry.num_zones, 1), 2)

    def pack_window(
        self,
        strategy: str,
        tensors: ClusterTensors,
        requests: Sequence[WindowRequest],
    ) -> list[WindowDecision]:
        """Serve a WINDOW of coalesced /predicates driver requests.

        Each request becomes a SEGMENT: its pending earlier drivers
        (hypothetical rows) followed by its own application (the committing
        row). Availability rewinds to a threaded base between segments, so
        each segment sees exactly what that request's solo solve would have
        seen — decisions are identical to serving the requests one at a time
        in window order, including the FIFO earlier-driver semantics
        (resource.go:221-258). Within a segment the priority orders are
        computed once from the segment-start availability (resource.go:299).
        Synchronous form: dispatch + fetch back to back."""
        return self.pack_window_fetch(
            self.pack_window_dispatch(strategy, tensors, requests)
        )

    def window_batch(
        self, tensors: ClusterTensors, requests: Sequence[WindowRequest]
    ) -> "WindowBatch":
        """The segment-major window `pack_window_dispatch` solves for
        `requests`: candidate and domain masks per request, the flat row
        arrays, the emax bucket, the [S, R] layout and each request's
        domain key."""
        return self._layout(self._window_rows(tensors, requests))

    def _window_rows(
        self, tensors: ClusterTensors, requests: Sequence[WindowRequest]
    ) -> _WindowRows:
        """Candidate and domain masks per request and the flat row arrays.

        Domain identity key per request: a digest ticket (the extender's
        domain names, a native-ingest ticket) keys in O(1); a list of at
        most 4,096 names keys by its content; a longer plain list by its
        object identity (building and hashing a huge tuple per request is
        a host cost, and identity keying only costs the pruned path an
        equal-content window it does not recognise as shared)."""
        valid_np = np.asarray(host_view(tensors).valid)
        flat_rows: list[tuple] = []
        cand_per_req: list[np.ndarray] = []
        dom_per_req: list[np.ndarray] = []
        dom_keys: list = []
        dom_memo: dict = {}
        for req in requests:
            cand = self.candidate_mask(tensors, req.driver_candidate_names)
            key = None
            if req.domain_mask is not None:
                dom = np.asarray(req.domain_mask) & valid_np
            elif req.domain_node_names is not None:
                dom_names = req.domain_node_names
                digest = getattr(dom_names, "names_digest", None)
                if digest is not None:
                    key = ("digest", digest)
                elif len(dom_names) <= 4096:
                    key = tuple(dom_names)
                else:
                    key = ("id", id(dom_names))
                dom = dom_memo.get(key)
                if dom is None:
                    dom = self.candidate_mask(tensors, dom_names) & valid_np
                    dom_memo[key] = dom
            else:
                dom = valid_np
            dom_keys.append(key)
            cand_per_req.append(cand)
            dom_per_req.append(dom)
            flat_rows.extend(req.rows)

        # FIFO windows repeat the SAME row objects across requests, so
        # materialize each distinct Resources once.
        arr_memo: dict[int, np.ndarray] = {}

        def as_arr(res) -> np.ndarray:
            a = arr_memo.get(id(res))
            if a is None:
                a = res.as_array()
                arr_memo[id(res)] = a
            return a

        counts = np.asarray([r[2] for r in flat_rows], np.int32)
        return _WindowRows(
            requests=tuple(requests),
            drv_arr=np.stack([as_arr(r[0]) for r in flat_rows]),
            exc_arr=np.stack([as_arr(r[1]) for r in flat_rows]),
            counts=counts,
            skip_arr=np.asarray([bool(r[3]) for r in flat_rows]),
            cand_per_req=cand_per_req,
            dom_per_req=dom_per_req,
            dom_keys=tuple(dom_keys),
            emax=pad_bucket(max(int(counts.max()), 1), 8),
            num_zones=self._num_zones_bucket(),
        )

    @staticmethod
    def _layout(rows: _WindowRows, cand=None, dom=None) -> WindowBatch:
        """The [S, R] window of `rows`; `cand` / `dom` replace the [N]
        masks per request (a pruned window's masks over its kept rows)."""
        win, seg_idx, row_idx = _build_segmented_window(
            rows.requests, rows.drv_arr, rows.exc_arr, rows.counts,
            rows.skip_arr,
            rows.cand_per_req if cand is None else cand,
            rows.dom_per_req if dom is None else dom,
        )
        return WindowBatch(
            win=win,
            emax=rows.emax,
            num_zones=rows.num_zones,
            seg_map=(seg_idx, row_idx),
            driver_req=rows.drv_arr,
            exec_req=rows.exc_arr,
            skippable=rows.skip_arr,
            dom_keys=rows.dom_keys,
        )

    def pack(
        self,
        strategy: str,
        tensors: ClusterTensors,
        driver_resources: Resources,
        executor_resources: Resources,
        executor_count: int,
        driver_candidate_names: Sequence[str],
        domain_mask: np.ndarray | None = None,
    ) -> HostPacking:
        """Solo solve of one application: one live row of the window solve
        (a one-segment, one-row window with the request's driver-candidate
        and domain masks), the row-walk kernel on the card and its plain
        version on the CPU. `has_capacity` is the row's `packed` flag. The
        availability is read, never threaded: `tensors` is left as it was,
        and a pipelined base carries on untouched."""
        if strategy not in BINPACK_STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        self._check_device(tensors)
        n = tensors.num_nodes
        host = host_view(tensors)
        driver_mask = self.candidate_mask(tensors, driver_candidate_names)
        if domain_mask is None:
            domain_mask = np.asarray(host.valid)
        emax = pad_bucket(max(executor_count, 1), 8)
        drv = driver_resources.as_array()
        exc = executor_resources.as_array()
        win, _, _ = segmented_window_from_flat(
            drv[None], exc[None], np.asarray([executor_count], np.int32),
            np.zeros(1, bool), [1], [driver_mask],
            [np.asarray(domain_mask, bool)], pad_segments=1, pad_rows=1,
        )
        tel = self.telemetry
        compiles_before = tel.compile_count() if tel is not None else None
        try:
            _shim("h2d")
            self._ensure_probed()
            meta, execs, _base_after = window_pack(
                tensors, win, fill=strategy, emax=emax,
                num_zones=self._num_zones_bucket(),
            )
            _shim("d2h")
            blob = torch.cat([meta[0, 0, :3], execs[0, 0]]).cpu().numpy()
        except Exception as exc:
            if not (classify_slot_failure(exc) and self.degraded is not None):
                raise
            # A solo pack does not thread the pipelined base, so the
            # pipeline survives; this decision is served degraded.
            self._degraded_or_raise(exc)
            self.last_solve_info = {
                "path": "greedy-fallback",
                "nodes": n,
                "emax": emax,
                "compile_cache_hit": None,
                "degraded": True,
            }
            packing = self.fallback.pack(
                strategy, host, driver_resources, executor_resources,
                executor_count, driver_mask, domain_mask,
            )
            self.degraded.on_fallback_decision()
            return packing
        self.last_solve_info = {
            "path": "cuda" if self.device.type == "cuda" else "reference",
            "nodes": n,
            "emax": emax,
        }
        if tel is not None:
            # No library built during this solve: the build-cache hit the
            # flight recorder reports.
            self.last_solve_info["compile_cache_hit"] = (
                tel.compile_count() == compiles_before
            )
            tel.on_pack(nodes=n, emax=emax)
            tel.on_transfer("h2d", _window_nbytes(win))
            tel.on_transfer("d2h", blob.nbytes)
        driver_idx = int(blob[0])
        executor_nodes = blob[3:]
        eff = avg_packing_efficiency_np(
            np.asarray(host.schedulable),
            np.asarray(host.available),
            driver_idx,
            executor_nodes,
            drv,
            exc,
        )
        name_of = self.registry.name_of
        self._device_recovered()
        return HostPacking(
            driver_node=name_of(driver_idx) if driver_idx >= 0 else None,
            executor_nodes=[name_of(int(i)) for i in executor_nodes if i >= 0],
            has_capacity=bool(blob[2]),
            efficiency_max=float(eff.max),
            efficiency_cpu=float(eff.cpu),
            efficiency_memory=float(eff.memory),
            efficiency_gpu=float(eff.gpu),
        )

    def can_batch(self, strategy: str) -> bool:
        return strategy in BINPACK_STRATEGIES

    def preemption_search(
        self,
        strategy: str,
        tensors: ClusterTensors,
        driver_resources: Resources,
        executor_resources: Resources,
        executor_count: int,
        driver_candidate_names: Sequence[str],
        freed_cum: np.ndarray,  # [C, rows, 3] int — per-candidate freed capacity
        domain_mask: np.ndarray | None = None,
    ) -> tuple[int, dict]:
        """Masked-fit probe over candidate eviction sets (policy subsystem):
        candidate c's availability is the cluster plus `freed_cum[c]` (in
        registry index space), all solved by ops/packing.py
        `preemption_batched_fit` on the solver's device. With nested
        prefixes the first feasible index is the minimal eviction set.
        Returns (first feasible candidate index or -1, solve info)."""
        self._check_device(tensors)
        n = tensors.num_nodes
        host = host_view(tensors)
        driver_mask = self.candidate_mask(tensors, driver_candidate_names)
        if domain_mask is None:
            domain_mask = np.asarray(host.valid)
        emax = pad_bucket(max(executor_count, 1), 8)
        c = freed_cum.shape[0]
        freed = np.zeros((c, n, freed_cum.shape[2]), dtype=np.int32)
        rows = min(freed_cum.shape[1], n)
        freed[:, :rows, :] = freed_cum[:, :rows, :]
        fill = PREEMPTION_FILL.get(strategy, "tightly-pack")
        dev = self.device

        def up(a, dtype=torch.int32):
            return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

        ok, _drv, _execs = preemption_batched_fit(
            tensors, up(freed), up(driver_resources.as_array()),
            up(executor_resources.as_array()), executor_count,
            up(driver_mask, torch.bool), up(domain_mask, torch.bool),
            fill=fill, emax=emax, num_zones=self._num_zones_bucket(),
        )
        ok_host = ok.cpu().numpy()
        kind = dev.type
        self.preemption_searches[kind] = self.preemption_searches.get(kind, 0) + 1
        idx = int(np.argmax(ok_host)) if bool(ok_host.any()) else -1
        return idx, {
            "path": "batched-preemption",
            "candidates": c,
            "nodes": n,
            "emax": emax,
            "fill": fill,
        }

    def _check_device(self, tensors: ClusterTensors) -> None:
        if tensors.device != self.device:
            raise ValueError(
                f"tensors live on {tensors.device}, solver on {self.device}"
            )

    def pack_window_dispatch(
        self,
        strategy: str,
        tensors: ClusterTensors,
        requests: Sequence[WindowRequest],
    ) -> WindowHandle:
        """Build the segmented window and launch the solve without waiting
        for its result. Returns a handle for pack_window_fetch.

        When `tensors` came from build_tensors_pipelined, the row walk's
        committed base (still on the device, never fetched) becomes the
        base of the NEXT pipelined build, and the handle notes which
        earlier windows were still un-fetched — their placements are
        subtracted from this window's host-side base at fetch time, so the
        host reconstruction sees exactly the availability the device saw.

        With `prune_top_k` set, a pipelined window of a plain fill, with
        no label priorities and one domain shared by its requests, solves
        the planner's top-K rows instead (`_dispatch_pruned`), unless the
        planner declines it."""
        if strategy not in BINPACK_STRATEGIES:
            raise ValueError(f"strategy {strategy!r} is not batchable")
        if self._closed:
            # Fail fast before any device work or pipeline mutation.
            raise RuntimeError("cannot schedule new futures after shutdown")
        self._check_device(tensors)
        if not requests:
            return WindowHandle(
                strategy=strategy, blob=None, requests=(), host_avail=None,
                host_schedulable=None,
            )
        rows = self._window_rows(tensors, requests)
        p = self._pipe
        pipelined = p is not None and tensors is p["tensors"]
        if self._pool is not None and pipelined:
            # The device pool: the window, partitioned by disjoint
            # domains when it can be, over the pool's slots (each
            # partition pruned on its own when pruning is on).
            return self._dispatch_pooled(strategy, tensors, rows, p)
        if pipelined and self._prune_eligible(strategy):
            dom_shared, dom_key = self._shared_prune_domain(
                requests, rows.dom_keys, rows.dom_per_req
            )
            if dom_shared is not None:
                handle = self._dispatch_pruned(
                    strategy, tensors, rows, p, dom_shared, dom_key
                )
                if handle is not None:
                    return handle
        lane = self._dispatch_lane
        if (
            pipelined
            and self.device.type != "cuda"
            and lane is not None
            and lane.accepts(self)
        ):
            return self._dispatch_deferred(strategy, tensors, rows, p, lane)
        n = tensors.num_nodes
        batch = self._layout(rows)
        tel = self.telemetry
        compiles_before = tel.compile_count() if tel is not None else None
        path = "cuda" if self.device.type == "cuda" else "reference"
        try:
            _shim("h2d")
            self._ensure_probed()
            meta, execs, base_after = window_pack(
                tensors, batch.win, fill=strategy, emax=batch.emax,
                num_zones=batch.num_zones,
            )
            blob, ready = self._stage_blob(meta, execs)
        except Exception as exc:
            if not classify_slot_failure(exc):
                raise
            return self._device_failed_at_dispatch(
                exc, strategy, tensors, rows, p if pipelined else None
            )
        self.window_path_counts[path] = (
            self.window_path_counts.get(path, 0) + 1
        )
        priors: tuple = ()
        debited = None
        if pipelined:
            priors = tuple(p["unfetched"])
            debited = [p["debited"].get(h, frozenset()) for h in priors]
            p["avail"] = base_after  # the next pipelined build extends this
        s_pad, r_pad = batch.win.exec_count.shape
        info = {
            "path": path,
            "nodes": n,
            "rows": len(batch.skippable),
            "row_bucket": s_pad * r_pad,
            "emax": batch.emax,
            "state_upload": self.last_state_upload if pipelined else None,
            "dispatch_id": next(self._dispatch_seq),
            "fused_k": 1,
        }
        self.last_solve_info = info
        if tel is not None:
            info["compile_cache_hit"] = tel.compile_count() == compiles_before
            # The path as the JAX package's telemetry names it: "pallas" for
            # the row-walk kernel on the card (the route it stands for),
            # "xla" for the plain path on the CPU.
            tel.on_window_dispatch(
                "pallas" if self.device.type == "cuda" else "xla",
                nodes=n, rows=info["rows"], row_bucket=r_pad,
                segment_bucket=s_pad,
            )
            tel.on_transfer("h2d", _window_nbytes(batch.win))
        host = host_view(tensors)
        handle = WindowHandle(
            strategy=strategy,
            blob=blob,
            requests=rows.requests,
            host_avail=np.array(host.available, dtype=np.int64),
            host_schedulable=np.asarray(host.schedulable),
            priors=priors,
            prior_debited=debited,
        )
        handle.ready = ready
        handle.dispatched_at = time.perf_counter()
        # int64 so the fetch-side subtractions against the int64 base
        # never wrap.
        handle.row_driver_req = batch.driver_req.astype(np.int64)
        handle.row_exec_req = batch.exec_req.astype(np.int64)
        handle.row_skippable = batch.skippable
        handle.seg_map = batch.seg_map
        handle.info = info
        # Read by a re-solve only: the host greedy after a device fault,
        # or the row walk after a pruned window's escalation poisoned the
        # carry this dispatch rides.
        handle.host_tensors = host
        handle.window_rows = rows
        if pipelined:
            p["unfetched"].append(handle)
            self._note_inflight()
        return handle

    def window_app_batch(self, rows: _WindowRows, pad_to: int):
        """The flat window batch of `rows` (ops/batched.AppBatch, host
        numpy) that the stacked solves take: request-major rows, each
        request's earlier drivers then its committing row (commit on the
        last row, reset on the first), its candidate and domain masks on
        every row, padded to `pad_to` rows."""
        commit, reset, cand_rows, dom_rows = [], [], [], []
        for req, cand, dom in zip(
            rows.requests, rows.cand_per_req, rows.dom_per_req
        ):
            k = len(req.rows)
            commit.extend(j == k - 1 for j in range(k))
            reset.extend(j == 0 for j in range(k))
            cand_rows.extend([cand] * k)
            dom_rows.extend([dom] * k)
        return make_app_batch(
            rows.drv_arr, rows.exc_arr, rows.counts,
            pad_to=pad_to, skippable=rows.skip_arr,
            driver_cand=np.stack(cand_rows), domain=np.stack(dom_rows),
            commit=np.asarray(commit), reset=np.asarray(reset),
        )

    def _dispatch_deferred(self, strategy, tensors, rows, p, lane):
        """Park a pipelined window's plain solve with the dispatch lane.
        The handle's blob is the lane's future (the flat [B, 3 + emax]
        blob, one segment of B rows for the fetch's reconstruction) and
        the pipeline's next base is the lane's PendingBase, which the next
        build resolves on this solver's thread."""
        b = len(rows.skip_arr)
        quantum = (
            getattr(lane, "row_bucket_quantum", None)
            or self._row_bucket_quantum
        )
        row_bucket = pad_bucket(b, quantum)
        apps = self.window_app_batch(rows, row_bucket)
        future, base = lane.defer_window(
            self, apps,
            avail=tensors.available,
            statics=cluster_statics(tensors),
            host=host_view(tensors),
            fill=strategy, emax=rows.emax, num_zones=rows.num_zones,
        )
        self.window_path_counts["deferred"] = (
            self.window_path_counts.get("deferred", 0) + 1
        )
        priors = tuple(p["unfetched"])
        debited = [p["debited"].get(h, frozenset()) for h in priors]
        p["avail"] = base  # the next pipelined build resolves it
        info = {
            "path": "deferred",
            "nodes": tensors.num_nodes,
            "rows": b,
            "row_bucket": row_bucket,
            "emax": rows.emax,
            "state_upload": self.last_state_upload,
            "dispatch_id": next(self._dispatch_seq),
            "fused_k": 1,
        }
        self.last_solve_info = info
        tel = self.telemetry
        if tel is not None:
            info["compile_cache_hit"] = True
            tel.on_window_dispatch(
                "xla", nodes=info["nodes"], rows=b, row_bucket=row_bucket,
                segment_bucket=1,
            )
            tel.on_transfer(
                "h2d", sum(getattr(f, "nbytes", 0) for f in apps)
            )
        host = host_view(tensors)
        handle = WindowHandle(
            strategy=strategy,
            blob=None,
            requests=rows.requests,
            host_avail=np.array(host.available, dtype=np.int64),
            host_schedulable=np.asarray(host.schedulable),
            priors=priors,
            prior_debited=debited,
        )
        handle.blob_future = future
        handle.dispatched_at = time.perf_counter()
        handle.row_driver_req = rows.drv_arr.astype(np.int64)
        handle.row_exec_req = rows.exc_arr.astype(np.int64)
        handle.row_skippable = rows.skip_arr
        handle.seg_map = (np.zeros(b, np.int64), np.arange(b))
        handle.info = info
        handle.host_tensors = host
        handle.window_rows = rows
        p["unfetched"].append(handle)
        self._note_inflight()
        return handle

    def _device_failed_at_dispatch(self, exc, strategy, tensors, rows, p):
        """A classified device fault while dispatching on the solver's
        device: the threaded base may hold half a solve, so the pipeline
        drops (`p` is the live pipeline when the dispatch rode it), and the
        window is served per the degraded policy: a greedy handle, a shed,
        or `exc` again with no controller."""
        priors: tuple = ()
        debited = None
        if p is not None:
            priors = tuple(p["unfetched"])
            debited = [p["debited"].get(h, frozenset()) for h in priors]
        self._drop_pipeline("device-failure")
        self._degraded_or_raise(exc)
        return self._make_fallback_handle(
            strategy, rows, host_view(tensors), priors, debited
        )

    def _make_fallback_handle(
        self, strategy, rows: _WindowRows, host, priors, debited
    ) -> WindowHandle:
        """A dispatch-less handle: no device solved the window (degraded
        "greedy" with no device to serve it); pack_window_fetch serves it
        on the host greedy, from the same reconstruction every fetch uses.
        It holds builds back until it is fetched: its gangs are on no
        device base."""
        handle = WindowHandle(
            strategy=strategy,
            blob=None,
            requests=rows.requests,
            host_avail=np.array(host.available, dtype=np.int64),
            host_schedulable=np.asarray(host.schedulable),
            priors=priors,
            prior_debited=debited,
        )
        handle.greedy = True
        handle.host_tensors = host
        handle.window_rows = rows
        handle.info = {
            "path": "greedy-fallback",
            "nodes": int(host.available.shape[0]),
            "rows": len(rows.drv_arr),
            "row_bucket": 0,
            "emax": 0,
            "state_upload": None,
            "compile_cache_hit": None,
            "dispatch_id": next(self._dispatch_seq),
            "fused_k": 1,
            "degraded": True,
        }
        handle.dispatched_at = time.perf_counter()
        self.last_solve_info = handle.info
        self.window_path_counts["greedy-fallback"] = (
            self.window_path_counts.get("greedy-fallback", 0) + 1
        )
        self._poisoned[handle] = set()
        return handle

    def _fetch_fallback(self, handle: WindowHandle, bounds) -> list:
        """Serve a dispatch's windows on the host greedy, over the same base
        reconstruction every fetch path uses (the host view at dispatch
        minus the placements of windows in flight then), so the degraded
        decisions see exactly the availability a device solve would have."""
        base = self._dense_base(handle)
        out = []
        for lo, hi in bounds:
            decisions, placements = self.fallback.window_decisions(
                handle.strategy, handle.host_tensors, base,
                handle.requests[lo:hi], emax=handle.window_rows.emax,
            )
            base -= placements
            rows = np.flatnonzero(placements.any(axis=1)).astype(np.int64)
            out.append((decisions, rows, placements[rows]))
        handle.window_placements = [(r, a) for _, r, a in out]
        if self.degraded is not None:
            self.degraded.on_fallback_decision(len(handle.requests))
        for _, rows, _ in out:
            self._prune_note_rows(rows)
        if self.telemetry is not None:
            k = max(1, (handle.info or {}).get("fused_k", 1))
            self.telemetry.on_dispatch_complete(
                (time.perf_counter() - handle.dispatched_at) * 1e3 / k, k
            )
        return out

    def _stage_blob(self, meta, execs):
        """The decision blob [S, R, 3 + emax] of a window solve, and the
        event its host copy records on the card (None on the CPU). On the
        card the pull is queued right behind the window's kernels into a
        pinned buffer, so a fetch never waits for windows dispatched after
        it."""
        blob = torch.cat([meta[:, :, :3], execs], dim=2)
        if not blob.is_cuda:
            return blob, None
        host_blob = torch.empty(blob.shape, dtype=blob.dtype, pin_memory=True)
        host_blob.copy_(blob, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return host_blob, ready

    # -- candidate pruning (core/prune.py) --------------------------------

    def _prune_eligible(self, strategy: str) -> bool:
        """Static gate for the two-tier solve: plain fills only (single-AZ
        wrappers score zones by subset-dependent efficiencies) and no
        configured label priorities (the prefilter/certificate keys assume
        a uniform label rank)."""
        return (
            self._prune_top_k > 0
            and strategy in PLAIN_FILLS
            and self._driver_label_priority is None
            and self._executor_label_priority is None
        )

    def _prune_planner(self) -> PrunePlanner:
        """The lazy PrunePlanner (resident per-zone rank index, zone
        aggregates and plan cache, core/prune.py)."""
        if self._planner is None:
            self._planner = PrunePlanner(self.prune_stats)
        return self._planner

    def _prune_invalidate(self) -> None:
        """Drop every resident prefilter artifact (planner state and the
        gathered statics): a full name-rank renumber moved every row's
        key."""
        if self._planner is not None:
            self._planner.invalidate()
        self._prune_gather_cache.clear()

    def _prune_note_rows(self, rows) -> None:
        """Feed EXACT changed rows to the planner (O(changed) sync)."""
        if self._planner is not None and len(rows):
            self._planner.note_dirty(rows)

    def _prune_full_upload(self) -> None:
        """A full device upload is happening. The gathered statics die with
        it; the PLANNER keys on host state, so when the build that caused
        the upload named its changed rows (the resident build), feeding
        them keeps the planner exact and a warm restart (discard_pipeline,
        then a full upload of unchanged host state) skips the O(N log N)
        cold replan. A build that named no rows, or `lazy_warm_start`
        off, invalidates it."""
        self._prune_gather_cache.clear()
        planner = self._planner
        if planner is None:
            return
        rows = self._last_build_rows
        if self._lazy_warm_start and rows is not None:
            arows, srows = rows
            if len(arows):
                planner.note_dirty(arows)
            if len(srows):
                planner.note_static(srows)
        else:
            planner.invalidate()

    def _prune_mark_unknown(self) -> None:
        """A path that cannot name its changed rows touched availability:
        the planner's next sync diff-scans the snapshots instead."""
        if self._planner is not None:
            self._planner.mark_unknown()

    def _prune_gather_entry(self, host, plan) -> dict:
        """Gathered-statics cache entry for a plan's kept rows, keyed by
        the keep array's IDENTITY (the planner re-serves the same object;
        the entry pins it, so the id cannot recycle). The device copies
        join the entry at its first dispatch."""
        cache = self._prune_gather_cache
        ent = cache.get(id(plan.keep))
        if ent is not None and ent["keep"] is plan.keep:
            return ent
        while len(cache) >= 17:
            # Evict the oldest entry only: a rotation over many domains
            # must not wipe every warm gather on each new keep set.
            cache.pop(next(iter(cache)))
        ent = {
            "keep": plan.keep,
            "statics_np": _gather_statics_host(host, plan.keep, plan.k_real),
        }
        cache[id(plan.keep)] = ent
        return ent

    def _plan_prune(
        self, host, dom_mask, cand_per_req, drv_arr, exc_arr, counts,
        dom_key=None, dom_ref=None,
    ):
        """Build a PrunePlan for one window, or None.

        A full-valid-mask domain — by identity (no names pinned) or by
        memoized content equality (a named domain enumerating the whole
        roster) — takes the O(K + changed) resident-aggregate path;
        genuine subset domains take the counted sweep."""
        planner = self._prune_planner()
        planner.sync(host, self._num_zones_bucket())
        if self._is_full_domain(
            dom_mask, np.asarray(host.valid), dom_key, dom_ref
        ):
            plan = planner.plan_full_domain(
                host,
                cand_per_req=cand_per_req,
                drv_arr=drv_arr,
                exc_arr=exc_arr,
                counts=counts,
                num_zones=self._num_zones_bucket(),
                top_k=self._prune_top_k,
                slack=self._prune_slack,
            )
        else:
            plan = planner.plan_with_masks(
                host,
                dom_mask=np.asarray(dom_mask, bool),
                cand_per_req=cand_per_req,
                drv_arr=drv_arr,
                exc_arr=exc_arr,
                counts=counts,
                num_zones=self._num_zones_bucket(),
                top_k=self._prune_top_k,
                slack=self._prune_slack,
                dom_key=dom_key,
            )
        if plan is not None:
            st = self.prune_stats
            st["plan_ms"] += plan.plan_ms
            st["offset_ms"] += plan.offset_ms
        return plan

    @staticmethod
    def _shared_prune_domain(requests, dom_keys, dom_per_req):
        """(domain mask, domain key) of the single shared window domain,
        or (None, None) when requests pin distinct domains or a
        precomputed mask (such a window solves in full)."""
        if any(r.domain_mask is not None for r in requests):
            return None, None
        keys = set(dom_keys)
        if len(keys) != 1:
            return None, None
        return dom_per_req[0], dom_keys[0]

    def _is_full_domain(self, dom, valid_np, dom_key, dom_ref) -> bool:
        """Whether a window's shared domain covers the ENTIRE valid mask —
        the gate for the planner's resident-aggregate path. The default
        (no names pinned) is the valid mask by identity; a named domain
        that enumerates the whole roster is detected by ONE content
        compare memoized on (domain key, registry epoch, statics epoch,
        N), so the O(N) compare runs once per roster generation. `dom_ref`
        (the names object behind the key) is held ALIVE by the memo entry:
        an identity-derived key must never match a recycled id."""
        if dom is valid_np:
            return True
        if dom_key is None:
            return False
        memo_key = (
            dom_key, self.registry.epoch, self._static_epoch,
            valid_np.shape[0],
        )
        hit = self._full_dom_memo.get(memo_key)
        if hit is None:
            if len(self._full_dom_memo) > 16:
                self._full_dom_memo.clear()
            hit = (dom_ref, bool(np.array_equal(dom, valid_np)))
            self._full_dom_memo[memo_key] = hit
        return hit[1]

    def _note_prune_dispatch(self, plan, window_rows: int) -> None:
        st = self.prune_stats
        st["windows"] += 1
        st["kept_rows"] += plan.k_real
        st["window_rows"] += window_rows
        st["candidate_rows"] += plan.dom_rows
        if self.telemetry is not None:
            self.telemetry.on_prune_dispatch(plan.k_real, plan.dom_rows)

    def _note_prune_escalation(self, handle, reason: str) -> None:
        """A failed certificate. The carry embodies the pruned (now
        discarded) placements: every window dispatched on it re-solves in
        full at its fetch, and the next build does a full upload."""
        st = self.prune_stats
        st["escalations"] += 1
        st["reasons"][reason] = st["reasons"].get(reason, 0) + 1
        if self._planner is not None:
            # Re-scan to exactness: the failed certificate may trace to
            # conservative drift in a cached entry, and an escalation must
            # never loop on the same stale summaries.
            self._planner.reset_plan_entries()
        if handle.info is not None:
            handle.info["prune_escalated"] = reason
        if self.telemetry is not None:
            self.telemetry.on_prune_escalation(reason)
            self.telemetry.on_pipeline_event("prune-escalation")
        p = self._pipe
        if p is not None:
            if handle in p["unfetched"]:
                p["unfetched"].remove(handle)
                self._poisoned[handle] = set()
            for h in p["unfetched"]:
                h.use_fallback = True
                self._poisoned[h] = set()
            self._pipe = None
            self._note_inflight()

    @staticmethod
    def _prior_windows(handle):
        """(window index, rows, amounts) of every window of every prior
        that this dispatch's device base lacked: the windows the mirror had
        not debited when the dispatched tensors were built. A prior whose
        fetch never ran yields (None, None, None)."""
        for prior, debited in zip(handle.priors, handle.prior_debited):
            wp = prior.window_placements
            if wp is None:
                yield None, None, None
                continue
            for i, (rows, amounts) in enumerate(wp):
                if i not in debited:
                    yield i, rows, amounts

    def _collect_priors(self, handle, strict: bool):
        """Sparse union (rows, summed deltas) of the in-flight priors'
        committed placements that the device base lacked, O(placed).
        `strict` (the certificate's contract): a prior whose placements
        are UNKNOWN (its fetch never ran) returns None, and the caller
        escalates. Lenient: an unknown prior contributes nothing."""
        rows_list: list[np.ndarray] = []
        deltas_list: list[np.ndarray] = []
        for i, rows, amounts in self._prior_windows(handle):
            if i is None:
                if strict:
                    return None
                continue
            rows_list.append(rows)
            deltas_list.append(amounts)
        if not rows_list:
            return (
                np.empty(0, np.int64),
                np.empty((0, NUM_DIMS), np.int64),
            )
        rows = np.concatenate(rows_list)
        deltas = np.concatenate(deltas_list)
        uniq, inv = np.unique(rows, return_inverse=True)
        out = np.zeros((uniq.size, deltas.shape[1]), np.int64)
        np.add.at(out, inv, deltas)
        return uniq.astype(np.int64), out

    def _dispatch_pruned(
        self, strategy, tensors, rows: _WindowRows, p, dom_shared, dom_key
    ) -> "WindowHandle | None":
        """Tier 1 of the two-tier solve: the planner's kept rows gather out
        of the resident device carry (a [K] index_select; the [N,3] base
        never moves), their statics gather host-side into a small upload
        (reused while the kept set stands), and the row walk solves the
        [K,3] sub-cluster with the excluded rows' zone sums as offsets.
        Its committed base scatters back into the carry out of place, as a
        delta (padded rows add zero). Returns None when the planner
        declines: the caller solves the window in full."""
        host = host_view(tensors)
        requests = rows.requests
        plan = self._plan_prune(
            host, dom_shared, rows.cand_per_req, rows.drv_arr, rows.exc_arr,
            rows.counts, dom_key=dom_key,
            dom_ref=requests[0].domain_node_names,
        )
        if plan is None:
            return None
        n = tensors.num_nodes
        b = len(rows.drv_arr)
        dev = self.device
        tel = self.telemetry
        compiles_before = tel.compile_count() if tel is not None else None
        try:
            return self._dispatch_pruned_solve(
                strategy, tensors, rows, p, dom_shared, plan, host, n, b,
                dev, tel, compiles_before,
            )
        except Exception as exc:
            if not classify_slot_failure(exc):
                raise
            return self._device_failed_at_dispatch(
                exc, strategy, tensors, rows, p
            )

    def _dispatch_pruned_solve(
        self, strategy, tensors, rows, p, dom_shared, plan, host, n, b, dev,
        tel, compiles_before,
    ) -> "WindowHandle":
        """The pruned dispatch's device work and handle (_dispatch_pruned)."""
        requests = rows.requests
        _shim("h2d")
        self._ensure_probed()
        keep = plan.keep
        t_gather = time.perf_counter()
        ent = self._prune_gather_entry(host, plan)
        gather_reused = "statics_dev" in ent
        if gather_reused:
            self.prune_stats["gather_reuse"] += 1
        else:
            ent["idx_dev"] = torch.as_tensor(keep.astype(np.int64), device=dev)
            ent["statics_dev"] = tuple(
                torch.tensor(f, dtype=dt, device=dev)
                for f, dt in zip(ent["statics_np"], FIELD_DTYPES[1:])
            )
        idx_dev = ent["idx_dev"]
        sub_avail = p["avail"].index_select(0, idx_dev)
        sub = cluster_from_statics(sub_avail, ent["statics_dev"])
        dom_sub = np.asarray(dom_shared)[keep]
        batch = self._layout(
            rows, cand=plan.cand_kept, dom=[dom_sub] * len(requests)
        )
        zone_base = tuple(torch.as_tensor(a, device=dev) for a in plan.zone_base)
        gather_ms = (time.perf_counter() - t_gather) * 1e3
        self.prune_stats["gather_ms"] += gather_ms
        meta, execs, base_after = window_pack(
            sub, batch.win, fill=strategy, emax=batch.emax,
            num_zones=batch.num_zones, zone_base=zone_base,
        )
        blob, ready = self._stage_blob(meta, execs)
        p["avail"] = p["avail"].index_add(0, idx_dev, base_after - sub_avail)
        priors = tuple(p["unfetched"])
        debited = [p["debited"].get(h, frozenset()) for h in priors]
        path = "cuda-pruned" if dev.type == "cuda" else "reference-pruned"
        self.window_path_counts[path] = self.window_path_counts.get(path, 0) + 1
        s_pad, r_pad = batch.win.exec_count.shape
        info = {
            "path": path,
            "nodes": n,
            "rows": b,
            "row_bucket": s_pad * r_pad,
            "emax": batch.emax,
            "state_upload": self.last_state_upload,
            "dispatch_id": next(self._dispatch_seq),
            "fused_k": 1,
            "pruned": True,
            "kept_rows": plan.k_real,
            "candidate_rows": plan.dom_rows,
            "gather_reused": gather_reused,
        }
        self.last_solve_info = info
        self._note_prune_dispatch(plan, b)
        if tel is not None:
            info["compile_cache_hit"] = tel.compile_count() == compiles_before
            tel.on_window_dispatch(
                "pallas-pruned" if dev.type == "cuda" else "xla-pruned",
                nodes=n, rows=b, row_bucket=r_pad, segment_bucket=s_pad,
            )
            tel.on_prune_phases(plan.plan_ms, gather_ms, plan.offset_ms)
            if gather_reused:
                tel.on_prune_gather_reuse()
            # What the pruned dispatch ships: the gathered statics and the
            # kept-row index (unless reused), the [S, R] window over the
            # kept rows, and the zone offsets; no [N] array leaves the host.
            tel.on_transfer(
                "h2d",
                (
                    0
                    if gather_reused
                    else sum(f.nbytes for f in ent["statics_np"])
                    + keep.astype(np.int64).nbytes
                )
                + _window_nbytes(batch.win)
                + sum(np.asarray(a).nbytes for a in plan.zone_base),
            )
        handle = WindowHandle(
            strategy=strategy,
            blob=blob,
            requests=requests,
            host_avail=None,
            host_schedulable=np.asarray(host.schedulable),
            priors=priors,
            prior_debited=debited,
        )
        handle.ready = ready
        # The certificate's base, gathered on the kept rows now: the
        # resident host buffer is patched in place by later builds.
        self._track_avail(handle, host)
        handle.base_kept = handle.host_avail32[keep[: plan.k_real]].astype(
            np.int64
        )
        handle.host_tensors = host
        handle.window_rows = rows
        handle.row_driver_req = rows.drv_arr.astype(np.int64)
        handle.row_exec_req = rows.exc_arr.astype(np.int64)
        handle.row_skippable = rows.skip_arr
        handle.seg_map = batch.seg_map
        handle.prune = plan
        handle.info = info
        handle.dispatched_at = time.perf_counter()
        p["unfetched"].append(handle)
        self._note_inflight()
        return handle

    # -- the device pool (core/device_pool.py) ----------------------------

    @staticmethod
    def _rows_subset(rows: _WindowRows, req_ids) -> _WindowRows:
        """The flat rows and masks of the requests `req_ids` of a window,
        in that order."""
        starts = np.concatenate(
            [[0], np.cumsum([len(r.rows) for r in rows.requests])]
        ).astype(np.int64)
        row_sel = np.concatenate(
            [np.arange(starts[r], starts[r + 1]) for r in req_ids]
        )
        return _WindowRows(
            requests=tuple(rows.requests[r] for r in req_ids),
            drv_arr=rows.drv_arr[row_sel],
            exc_arr=rows.exc_arr[row_sel],
            counts=rows.counts[row_sel],
            skip_arr=rows.skip_arr[row_sel],
            cand_per_req=[rows.cand_per_req[r] for r in req_ids],
            dom_per_req=[rows.dom_per_req[r] for r in req_ids],
            dom_keys=tuple(rows.dom_keys[r] for r in req_ids),
            emax=rows.emax,
            num_zones=rows.num_zones,
        )

    def _slot_inputs_ready(self, slot, base) -> None:
        """Queue the slot's stream behind the work the calling thread has
        queued so far (the base it is about to read), and mark the base in
        use on that stream."""
        if slot.stream is None:
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        slot.stream.wait_event(ev)
        if base.device == slot.device:
            base.record_stream(slot.stream)

    def _base_on_slot(self, slot, base, idx=None, p=None) -> torch.Tensor:
        """The committed base (or its rows `idx`) on the slot's device,
        under the slot's stream. Same device: the base itself, or a gather
        of it; another device: the slot's availability replica, caught up
        from the pipeline's journal (`_pool_full_base`)."""
        if idx is not None:
            sub = base.index_select(
                0, torch.as_tensor(idx.astype(np.int64), device=base.device)
            )
            return sub if sub.device == slot.device else sub.to(slot.device)
        if slot.is_mesh:
            # A mesh slot's availability is re-placed at each dispatch
            # (the solve places its shard chunks, `shard_fields`); it keeps no
            # mirror.
            return base if base.device == slot.device else base.to(slot.device)
        if base.device == slot.device:
            slot.mirror["reuse"] += 1
            return base
        return self._pool_full_base(p, slot, base)

    def _avail_journal_note(self, p, rows):
        """Bump the pipeline's availability epoch with the rows the
        canonical base just changed on (a delta upload's dirty rows, a
        pruned or partitioned window's rows at dispatch), or None when they
        are unknowable (a whole window's commit, patched at its fetch).
        Pool replicas catch up by scattering the journaled union; a gap or
        a None epoch in a replica's missed chain re-ships the whole base. A
        journaled superset is harmless: catch-up copies the canonical
        values. Returns the epoch (None without a pool)."""
        if self._pool is None or p is None:
            return None
        e = p["avail_epoch"] + 1
        p["avail_epoch"] = e
        j = p["avail_journal"]
        j[e] = None if rows is None else np.asarray(rows, np.int64)
        while len(j) > 64:
            j.pop(next(iter(j)))
        return e

    @staticmethod
    def _journal_rows_between(p, lo: int, hi: int):
        """Union of the journaled rows of epochs (lo, hi], or None on a
        gap or an unknowable epoch."""
        if lo == hi:
            return np.empty(0, np.int64)
        j = p["avail_journal"]
        out = []
        for e in range(lo + 1, hi + 1):
            rows = j.get(e)
            if rows is None:
                return None
            out.append(rows)
        return np.unique(np.concatenate(out)).astype(np.int64)

    def _pool_full_base(self, p, slot, base) -> torch.Tensor:
        """The full committed base on a slot of ANOTHER device than the
        solver's, for a whole-window solve: the slot's replica, when it
        belongs to this pipeline generation and every epoch it missed is
        journaled, catches up by scattering just those rows; otherwise the
        whole [N,3] base is copied over. The replica is never the
        canonical base and is replaced out of place (a solve on the slot's
        stream may still read the old one)."""
        tel = self.telemetry
        token, epoch = p["token"], p["avail_epoch"]
        rep = slot.avail
        rows = None
        if (
            rep is not None
            and slot.avail_token == token
            and 0 <= slot.avail_epoch <= epoch
            and rep.shape == base.shape
        ):
            rows = self._journal_rows_between(p, slot.avail_epoch, epoch)
        if rows is not None and not rows.size:
            slot.mirror["reuse"] += 1
            out = rep
        elif rows is not None:
            idx = torch.as_tensor(rows, device=base.device)
            vals = base.index_select(0, idx).to(slot.device)
            out = rep.index_copy(0, idx.to(slot.device), vals)
            slot.mirror["catchup"] += 1
            slot.mirror["delta_rows"] += int(rows.size)
            if tel is not None:
                tel.on_device_mirror(
                    slot.label, "catchup", int(rows.size),
                    rows.nbytes + vals.numel() * vals.element_size(),
                )
        else:
            slot.mirror["dense"] += 1
            if tel is not None:
                tel.on_device_mirror(
                    slot.label, "dense", int(base.shape[0]),
                    base.numel() * base.element_size(),
                )
            out = base.to(slot.device, copy=True)
        slot.avail, slot.avail_epoch, slot.avail_token = out, epoch, token
        return out

    def _land(self, res) -> torch.Tensor:
        """A part's committed (sub-)base, for the calling thread's stream:
        that stream waits for the slot's solve and the tensor is marked in
        use on it; a part on another device copies over."""
        t, ev = res
        if ev is not None:
            cur = torch.cuda.current_stream(t.device)
            cur.wait_event(ev)
            t.record_stream(cur)
        return t if t.device == self.device else t.to(self.device)

    @staticmethod
    def _slot_solve(slot, strategy, sub_avail, statics, batch, apps,
                    zone_base):
        """A window's solve on `slot`, on the calling thread's current
        stream: the row walk over the slot's (sub-)cluster, or on a mesh
        slot the node-sharded engine in window mode over its shards
        (`apps`, the flat window batch; the JAX package runs
        `_window_blob_statics` there). Returns (decision blob, committed
        base): the blob [S, R, 3 + emax] of the row walk, or flat
        [B, 3 + emax] rows in request order from the engine."""
        if not slot.is_mesh:
            meta, execs, after = window_pack(
                cluster_from_statics(sub_avail, statics), batch.win,
                fill=strategy, emax=batch.emax, num_zones=batch.num_zones,
                zone_base=zone_base,
            )
            return torch.cat([meta[:, :, :3], execs], dim=2), after
        shards = [
            cluster_from_statics(av, st)
            for (av,), st in zip(shard_fields(slot.mesh.devices, [sub_avail]), statics)
        ]
        out = node_sharded_fifo_pack(
            shards, apps, fill=strategy, emax=batch.emax,
            num_zones=batch.num_zones, zone_base=zone_base,
            streams=slot.shard_streams,
        )
        return _packing_blob(out), out.available_after

    @staticmethod
    def _blob_rows(full: np.ndarray, batch, apps) -> np.ndarray:
        """The flat decision rows, in request order, of `_slot_solve`'s
        pulled blob."""
        return full if apps is not None else full[batch.seg_map[0], batch.seg_map[1]]

    def _mesh_apps(self, slot, rows: _WindowRows, idx=None):
        """The flat window batch a mesh slot solves (None on a plain
        slot); `idx` gathers the masks onto a sub-cluster's rows."""
        if not slot.is_mesh:
            return None
        if idx is not None:
            rows = rows._replace(
                cand_per_req=[c[idx] for c in rows.cand_per_req],
                dom_per_req=[d[idx] for d in rows.dom_per_req],
            )
        return self.window_app_batch(rows, pad_to=len(rows.drv_arr))

    @staticmethod
    def _part_solve(slot, strategy, sub_avail, statics, batch, apps,
                    zone_base, delta, after_fut):
        """One part's solve on a pool worker, on the slot's stream
        (`_slot_solve`); its committed base (a delta over the kept rows for
        a pruned part) publishes on `after_fut` as soon as the solve is
        queued, then the decision blob is pulled."""
        t0 = time.perf_counter()
        try:
            with slot.context():
                _shim("dispatch")
                blob, after = PlacementSolver._slot_solve(
                    slot, strategy, sub_avail, statics, batch, apps, zone_base
                )
                if delta:
                    after = after - sub_avail
                ev = None
                if slot.stream is not None:
                    ev = torch.cuda.Event()
                    ev.record(slot.stream)
        except BaseException as exc:
            if not after_fut.done():
                after_fut.set_exception(exc)
            raise
        after_fut.set_result((after, ev))
        t1 = time.perf_counter()
        with slot.context():
            _shim("d2h")
            full = blob.cpu().numpy()
        t2 = time.perf_counter()
        return {
            "blob": PlacementSolver._blob_rows(full, batch, apps),
            "solve_ms": (t1 - t0) * 1e3,
            "fetch_ms": (t2 - t1) * 1e3,
            "device": slot.label,
        }

    def _dispatch_pooled(self, strategy, tensors, rows: _WindowRows, p):
        """Pooled window dispatch (`solver.device-pool`, the JAX package's
        `_dispatch_pooled`).

        The window splits into PARTITIONS of requests whose affinity
        domains are pairwise disjoint (instance groups: every request's
        node selector pins it to one group). Requests of different
        partitions interact through no availability row, and zone ranks,
        priority orders and efficiencies all derive from domain-masked
        aggregates, so partitions COMMUTE: each solves over a gathered
        sub-cluster of its domain's rows on its own slot, and the decisions
        equal the serialized window's. A window that does not partition
        runs whole on the next slot. With pruning on, each partition (or a
        whole window with one shared domain) solves the planner's top-K
        rows of its domain instead. A pool of MESH slots makes no partition
        plan (JAX :4627-4635): a mesh slot solves the whole window (or its
        pruned gather, with its `zone_base`) on the node-sharded engine.

        The committed base stays one logical thread: each part's committed
        rows scatter back into a copy of the global base (out of place: a
        handle in flight may still read the old one) when the next
        pipelined build resolves the combine."""
        host = host_view(tensors)
        n = tensors.num_nodes
        pool = self._pool
        tel = self.telemetry
        compiles_before = tel.compile_count() if tel is not None else None
        requests = rows.requests
        solve_pool = shared_solve_pool(min(8, 2 * len(pool.slots)))
        now = self._clock()
        # Quarantine gate: probe the quarantined slots whose interval
        # elapsed; with no healthy slot left, the degraded policy answers.
        if pool.quarantined_slots():
            self.probe_quarantined()
        if not pool.healthy_slots():
            return self._device_failed_at_dispatch(
                AllSlotsQuarantinedError(
                    f"all {len(pool.slots)} device slot(s) quarantined"
                ),
                strategy, tensors, rows, p,
            )
        dom_keys, dom_per_req = rows.dom_keys, rows.dom_per_req
        # The partition plan: at least two distinct domain keys, every
        # request keyed, masks pairwise disjoint and non-empty.
        plan = None
        if (
            not any(s.is_mesh for s in pool.slots)
            and all(k is not None for k in dom_keys)
        ):
            groups: dict = {}
            for r, key in enumerate(dom_keys):
                groups.setdefault(key, []).append(r)
            if len(groups) > 1:
                masks = [dom_per_req[ids[0]] for ids in groups.values()]
                overlap = np.zeros(n, np.int32)
                for m in masks:
                    overlap += m
                if int(overlap.max()) <= 1 and all(m.any() for m in masks):
                    plan = list(groups.items())
        base = tensors.available  # the pipeline's carry (p["avail"])
        havail = np.asarray(host.available)
        request_device: list = [None] * len(requests)
        parts: list = []
        note_epoch = None
        try_prune = self._prune_eligible(strategy)
        shared_dom, shared_key = (
            self._shared_prune_domain(requests, dom_keys, dom_per_req)
            if try_prune
            else (None, None)
        )
        epoch = self._static_epoch

        def submit_part(slot, req_ids, idx_key, idx):
            sub = self._rows_subset(rows, req_ids)
            prune_plan = None
            if try_prune:
                part_dom = dom_per_req[req_ids[0]] if idx is not None else shared_dom
                part_key = dom_keys[req_ids[0]] if idx is not None else shared_key
                if part_dom is not None:
                    prune_plan = self._plan_prune(
                        host, part_dom, sub.cand_per_req, sub.drv_arr,
                        sub.exc_arr, sub.counts, dom_key=part_key,
                        dom_ref=requests[req_ids[0]].domain_node_names,
                    )
                if prune_plan is not None:
                    # The pruned gather replaces the domain gather.
                    idx = prune_plan.keep
                    idx_key = None
                    self._note_prune_dispatch(prune_plan, len(sub.drv_arr))
            if idx is None:
                batch = self._layout(sub)
            else:
                batch = self._layout(
                    sub, cand=[c[idx] for c in sub.cand_per_req],
                    dom=[d[idx] for d in sub.dom_per_req],
                )
            _shim("h2d")
            zone_base = None
            with slot.context():
                self._slot_inputs_ready(slot, base)
                if idx is None:
                    statics = slot.resident_statics(
                        host, epoch, self._clock, tel,
                        journal=self._static_journal,
                    )
                    sub_avail = self._base_on_slot(slot, base, p=p)
                elif prune_plan is not None:
                    t_gather = time.perf_counter()
                    ent = self._prune_gather_entry(host, prune_plan)
                    per_slot = ent.setdefault("slot_statics", {})
                    statics = per_slot.get(slot.label)
                    if statics is not None:
                        slot.uploads["reuse"] += 1
                        self.prune_stats["gather_reuse"] += 1
                        if tel is not None:
                            tel.on_device_upload(slot.label, "reuse", 0)
                            tel.on_prune_gather_reuse()
                    else:
                        statics = slot.upload_statics(ent["statics_np"])
                        per_slot[slot.label] = statics
                        slot.uploads["full"] += 1
                        if tel is not None:
                            tel.on_device_upload(
                                slot.label, "full",
                                sum(f.nbytes for f in ent["statics_np"]),
                            )
                    sub_avail = self._base_on_slot(slot, base, idx)
                    zone_base = tuple(
                        torch.as_tensor(a, device=slot.device)
                        for a in prune_plan.zone_base
                    )
                    self.prune_stats["gather_ms"] += (
                        time.perf_counter() - t_gather
                    ) * 1e3
                else:
                    statics = slot.sub_replica(
                        host, idx_key, idx, epoch, self._clock, tel
                    )
                    sub_avail = self._base_on_slot(slot, base, idx)
            slot.inflight += 1
            if tel is not None:
                tel.on_device_inflight(slot.label, slot.inflight)
                if slot.last_full_upload:
                    tel.on_device_age(
                        slot.label, max(0.0, now - slot.last_full_upload)
                    )
            after_fut: Future = Future()
            fut = solve_pool.submit(
                self._part_solve, slot, strategy, sub_avail, statics, batch,
                self._mesh_apps(slot, sub, idx), zone_base,
                prune_plan is not None, after_fut,
            )

            def propagate_cancel(f, af=after_fut):
                # A part close() cancelled never runs: its base future
                # fails too, instead of hanging a later combine.
                if f.cancelled() and not af.done():
                    af.cancel()

            fut.add_done_callback(propagate_cancel)
            self._inflight_futures[fut] = slot
            fut.add_done_callback(
                lambda f: self._inflight_futures.pop(f, None)
            )
            for r in req_ids:
                request_device[r] = slot.label
            return WindowPart(
                future=fut, after_future=after_fut, req_ids=list(req_ids),
                requests=sub.requests, rows=sub, batch=batch,
                idx=None if idx is None else np.asarray(idx, np.int64),
                idx_key=idx_key, slot=slot, prune=prune_plan,
                base_kept=None if idx is None else havail[idx].astype(np.int64),
            )

        try:
            self._ensure_probed()
            if plan is None:
                head = submit_part(
                    pool.next_slot(), list(range(len(requests))), None, None
                )
                parts.append(head)
                if head.prune is not None:
                    # A pruned whole window: its part returns the kept
                    # rows' DELTA, folded into the base (padding adds 0).
                    idx_dev = torch.as_tensor(head.idx, device=self.device)
                    p["avail"] = PendingBase(
                        lambda: base.index_add(
                            0, idx_dev, self._land(head.after_future.result())
                        )
                    )
                    self._avail_journal_note(p, head.idx)
                else:
                    p["avail"] = PendingBase(
                        lambda: self._land(head.after_future.result())
                    )
                    note_epoch = self._avail_journal_note(p, None)
            else:
                for key, req_ids in plan:
                    idx = np.flatnonzero(dom_per_req[req_ids[0]])
                    parts.append(submit_part(pool.next_slot(), req_ids, key, idx))

                def combine(parts=tuple(parts)):
                    # Disjoint rows: each partition's committed sub-base
                    # scatters into the base; a pruned one adds its delta.
                    out = base
                    for part in parts:
                        sub_after = self._land(part.after_future.result())
                        idx_dev = torch.as_tensor(part.idx, device=self.device)
                        if part.prune is not None:
                            out = out.index_add(0, idx_dev, sub_after)
                        else:
                            out = out.index_copy(0, idx_dev, sub_after)
                    return out

                p["avail"] = PendingBase(combine)
                self._avail_journal_note(
                    p, np.concatenate([pt.idx for pt in parts])
                )
        except Exception as exc:
            # The parts already submitted are cancelled, or end, and release
            # their slots before the dispatch fails.
            for part in parts:
                part.future.cancel()
            self._await_parts([(pt.future, pt.slot) for pt in parts])
            if not classify_slot_failure(exc):
                raise
            # A device boundary failed on the dispatcher thread: the window
            # is served per the degraded policy.
            return self._device_failed_at_dispatch(
                exc, strategy, tensors, rows, p
            )
        self.window_path_counts["pool"] = self.window_path_counts.get("pool", 0) + 1
        b = len(rows.drv_arr)
        info = {
            "path": "pool",
            "nodes": n,
            "rows": b,
            "row_bucket": pad_bucket(b, 8),
            "emax": rows.emax,
            "partitions": len(parts),
            "devices": sorted({pt.slot.label for pt in parts}),
            "state_upload": self.last_state_upload,
            "dispatch_id": next(self._dispatch_seq),
            "fused_k": 1,
        }
        self.last_solve_info = info
        if tel is not None:
            info["compile_cache_hit"] = tel.compile_count() == compiles_before
            tel.on_window_dispatch(
                "pool", nodes=n, rows=b, row_bucket=pad_bucket(b, 8)
            )
            tel.on_transfer(
                "h2d", sum(_window_nbytes(pt.batch.win) for pt in parts)
            )
        priors = tuple(p["unfetched"])
        handle = WindowHandle(
            strategy=strategy,
            blob=None,
            requests=requests,
            host_avail=None,
            host_schedulable=np.asarray(host.schedulable),
            priors=priors,
            prior_debited=[p["debited"].get(h, frozenset()) for h in priors],
        )
        self._track_avail(handle, host)
        handle.avail_note_epoch = note_epoch
        handle.parts = parts
        handle.request_device = request_device
        handle.host_tensors = host
        handle.window_rows = rows
        handle.row_driver_req = rows.drv_arr.astype(np.int64)
        handle.row_exec_req = rows.exc_arr.astype(np.int64)
        handle.row_skippable = rows.skip_arr
        handle.info = info
        handle.dispatched_at = time.perf_counter()
        p["unfetched"].append(handle)
        self._note_inflight()
        return handle

    def _fetch_pooled(self, handle: WindowHandle, bounds) -> list:
        """Fetch and reconstruct a pooled (possibly partitioned) dispatch,
        window by window of `bounds`.

        Partitions are row-disjoint, so any order of their reconstruction
        gives the serialized window's base. A gathered part reconstructs
        in its own row space against the base captured at dispatch; a
        whole-window part against the dense reconstruction. A part whose
        solve died of a device fault quarantines its slot and re-solves on
        a survivor from the host reconstruction (`_redispatch_part`), or
        with no survivor on the host greedy (degraded "greedy"). A pruned
        part whose certificate fails re-solves on the row walk over the
        dense base (the port's recorded deviation: never on the greedy,
        which serves only when the card failed)."""
        requests = handle.requests
        tel = self.telemetry
        window_of = np.zeros(len(requests), np.int64)
        for i, (lo, hi) in enumerate(bounds):
            window_of[lo:hi] = i
        results: list = [None] * len(requests)
        win_rows: list = [[] for _ in bounds]
        win_vals: list = [[] for _ in bounds]
        committed: list = []
        dense: dict = {"base": None}
        lp_rows, lp_vals = self._collect_priors(handle, strict=False)
        strict: dict = {}

        def dense_base() -> np.ndarray:
            # The dense reconstruction, minus what earlier parts committed.
            if dense["base"] is None:
                b = self._dense_base(handle)
                for r, v in committed:
                    b[r] -= v
                dense["base"] = b
            return dense["base"]

        def record(w, rows_, vals, applied) -> None:
            win_rows[w].append(rows_)
            win_vals[w].append(vals)
            committed.append((rows_, vals))
            if not applied and dense["base"] is not None and rows_.size:
                dense["base"][rows_] -= vals

        def groups(part):
            # [window, part-local request positions, row lo, row hi], one
            # per run of the part's requests in one window.
            out, r0 = [], 0
            for k, rid in enumerate(part.req_ids):
                r1 = r0 + len(requests[rid].rows)
                if out and out[-1][0] == window_of[rid]:
                    out[-1][1].append(k)
                    out[-1][3] = r1
                else:
                    out.append([int(window_of[rid]), [k], r0, r1])
                r0 = r1
            return out

        def reconstruct(part, blob, base, sched, row_map, applied) -> None:
            drivers = blob[:, 0].astype(np.int64)
            admitted = blob[:, 1].astype(bool)
            packed = blob[:, 2].astype(bool)
            execs = blob[:, 3:].astype(np.int64)
            drv64 = part.rows.drv_arr.astype(np.int64)
            exc64 = part.rows.exc_arr.astype(np.int64)
            skip = part.rows.skip_arr
            for w, ks, lo, hi in groups(part):
                placements = np.zeros_like(base)
                decisions = self._reconstruct_requests(
                    [part.requests[k] for k in ks], drivers[lo:hi],
                    admitted[lo:hi], packed[lo:hi], execs[lo:hi],
                    drv64[lo:hi], exc64[lo:hi], skip[lo:hi], base,
                    placements, sched, row_map=row_map,
                )
                for k, d in zip(ks, decisions):
                    results[part.req_ids[k]] = d
                loc = np.flatnonzero(placements.any(axis=1))
                g = loc if row_map is None else row_map[loc]
                record(w, g.astype(np.int64), placements[loc], applied)

        def greedy(part) -> None:
            base = dense_base()
            for w, ks, _lo, _hi in groups(part):
                decisions, placements = self.fallback.window_decisions(
                    handle.strategy, handle.host_tensors, base,
                    [part.requests[k] for k in ks], emax=part.rows.emax,
                )
                base -= placements
                for k, d in zip(ks, decisions):
                    results[part.req_ids[k]] = d
                g = np.flatnonzero(placements.any(axis=1)).astype(np.int64)
                record(w, g, placements[g], True)
            if self.degraded is not None:
                self.degraded.on_fallback_decision(len(part.requests))

        def release(part) -> None:
            part.slot.inflight = max(0, part.slot.inflight - 1)
            if tel is not None:
                tel.on_device_inflight(part.slot.label, part.slot.inflight)

        def fetch_part(part) -> None:
            try:
                out = part.future.result()
            except Exception as exc:
                release(part)
                if not classify_slot_failure(exc):
                    # The base embodies unknowable placements: the pipeline
                    # drops.
                    self._drop_pipeline("fetch-failure")
                    raise
                # Slot-failure recovery: quarantine the slot (its resident
                # state is unreachable and the base it fed is poisoned),
                # then re-solve this part on a survivor from the exact host
                # reconstruction.
                self._drop_pipeline("fetch-failure")
                self._quarantine_slot(part.slot, exc)
                out = self._redispatch_part(handle, part, dense_base())
                if out is None:
                    greedy(part)
                    return
            else:
                release(part)
            blob = out["blob"]
            if tel is not None:
                tel.on_transfer("d2h", blob.nbytes)
                tel.on_device_window(
                    out["device"], out["solve_ms"], out["fetch_ms"],
                    inflight=part.slot.inflight,
                )
            if part.idx is None:
                # A whole window: global rows over the dense base, as the
                # single-device fetch.
                reconstruct(
                    part, blob, dense_base(), handle.host_schedulable, None, True
                )
                return
            gmap = part.idx
            sched_loc = np.asarray(handle.host_schedulable)[gmap]
            if part.prune is None:
                bk = _debit_rows(part.base_kept.copy(), gmap, lp_rows, lp_vals)
                reconstruct(part, blob, bk, sched_loc, gmap, False)
                return
            # A pruned part: its certificate, in its own row space.
            if "ps" not in strict:
                strict["ps"] = self._collect_priors(handle, strict=True)
            ok, reason, base_loc = self._certify_pruned(
                part.prune, handle, part.requests, blob.astype(np.int64),
                part.rows.drv_arr.astype(np.int64),
                part.rows.exc_arr.astype(np.int64), part.base_kept, strict["ps"],
            )
            if not ok:
                # Re-solve just this partition over the dense base
                # (`_escalation_decisions`; the other partitions are
                # row-disjoint and stand), then poison the carry.
                res = self._escalation_decisions(
                    handle.strategy, handle.host_tensors, dense_base(),
                    part.rows,
                )
                if res is None:
                    greedy(part)
                    self._note_prune_escalation(handle, reason)
                    return
                full_blob, segments, nbytes = res
                reconstruct(
                    part, full_blob, dense_base(), handle.host_schedulable,
                    None, True,
                )
                if handle.info is not None:
                    handle.info["resolved"] = {
                        "reason": "certificate",
                        "segments": segments,
                        "d2h": nbytes,
                    }
                self._note_prune_escalation(handle, reason)
                return
            reconstruct(part, blob, base_loc, sched_loc, gmap, False)

        for part_i, part in enumerate(handle.parts):
            try:
                fetch_part(part)
            except BaseException:
                # Whatever ends the fetch (a shed, a fault with no
                # controller, an error no device fault explains), the parts
                # not reached yet end and release their slots first.
                self._await_parts(
                    [(pt.future, pt.slot) for pt in handle.parts[part_i + 1:]]
                )
                raise
        out = []
        for w, (lo, hi) in enumerate(bounds):
            if win_rows[w]:
                allr = np.concatenate(win_rows[w])
                allv = np.concatenate(win_vals[w])
                uniq, inv = np.unique(allr, return_inverse=True)
                vals = np.zeros((uniq.size, NUM_DIMS), np.int64)
                np.add.at(vals, inv, allv)
            else:
                uniq = np.empty(0, np.int64)
                vals = np.empty((0, NUM_DIMS), np.int64)
            out.append((results[lo:hi], uniq, vals))
            self._prune_note_rows(uniq)
        handle.window_placements = [(r, a) for _, r, a in out]
        if tel is not None:
            k = max(1, (handle.info or {}).get("fused_k", 1))
            tel.on_dispatch_complete(
                (time.perf_counter() - handle.dispatched_at) * 1e3 / k, k
            )
        return out

    def _redispatch_part(self, handle: WindowHandle, part, base):
        """Re-run a failed part's solve on a SURVIVING slot with the same
        inputs: the availability rows from the host reconstruction `base`
        (what the dead slot's base embodied; partitions are row-disjoint,
        so earlier parts' commits touch none of this part's rows), the
        statics uploaded to the survivor, the part's own window layout.
        Slot choice never changes a decision.

        Returns the worker-style {"blob", "solve_ms", "fetch_ms",
        "device"}, or None when NO slot survives and the degraded policy
        is greedy (the caller serves the part on the host). Raises
        DegradedUnavailableError (shed) or AllSlotsQuarantinedError (no
        controller)."""
        pool = self._pool
        host = handle.host_tensors
        tel = self.telemetry
        batch = part.batch
        while True:
            self.probe_quarantined()
            healthy = pool.healthy_slots()
            if not healthy:
                self._degraded_or_raise(
                    AllSlotsQuarantinedError("no surviving slot for re-dispatch")
                )
                return None
            slot = min(healthy, key=lambda s: s.inflight)
            t0 = time.perf_counter()
            try:
                with slot.context():
                    _shim("h2d")
                    epoch = self._static_epoch
                    if part.idx is None:
                        statics = slot.resident_statics(
                            host, epoch, self._clock, tel,
                            journal=self._static_journal,
                        )
                        avail_rows = base
                    elif part.prune is not None:
                        # Fresh gathered statics on the survivor (a keep
                        # set is per window).
                        statics = slot.upload_statics(
                            _gather_statics_host(
                                host, part.idx, part.prune.k_real
                            )
                        )
                        avail_rows = base[part.idx]
                    else:
                        statics = slot.sub_replica(
                            host, part.idx_key, part.idx, epoch, self._clock,
                            tel,
                        )
                        avail_rows = base[part.idx]
                    sub_avail = slot.put(
                        np.clip(avail_rows, _INT32.min, _INT32.max).astype(
                            np.int32
                        )
                    )
                    zone_base = None
                    if part.prune is not None:
                        zone_base = tuple(
                            torch.as_tensor(a, device=slot.device)
                            for a in part.prune.zone_base
                        )
                    _shim("dispatch")
                    apps = self._mesh_apps(slot, part.rows, part.idx)
                    blob, _ = self._slot_solve(
                        slot, handle.strategy, sub_avail, statics, batch,
                        apps, zone_base,
                    )
                    t1 = time.perf_counter()
                    _shim("d2h")
                    full = blob.cpu().numpy()
                t2 = time.perf_counter()
            except Exception as exc:
                if classify_slot_failure(exc):
                    # The survivor died too: quarantine it and walk on.
                    self._quarantine_slot(slot, exc)
                    continue
                raise
            self.redispatch_count += 1
            self._on_slot_event("redispatch", slot.label)
            if handle.info is not None:
                handle.info["redispatches"] = handle.info.get("redispatches", 0) + 1
            if handle.request_device is not None:
                for r in part.req_ids:
                    handle.request_device[r] = slot.label
            return {
                "blob": self._blob_rows(full, batch, apps),
                "solve_ms": (t1 - t0) * 1e3,
                "fetch_ms": (t2 - t1) * 1e3,
                "device": slot.label,
            }

    def pack_windows_dispatch(
        self,
        strategy: str,
        tensors: ClusterTensors,
        request_windows: Sequence[Sequence[WindowRequest]],
    ) -> list[FusedWindowView]:
        """FUSED K-window dispatch: the K windows' requests concatenate into
        ONE segmented window, so the row walk serves every segment of all K
        windows in one dispatch and the decisions come back in one pull. A
        window boundary is an ordinary segment boundary: the committed base
        carries on the device from one window to the next exactly as it is
        threaded between K sequential dispatches, so the decisions equal
        dispatching the K windows one after another. The caller claimed all
        K windows at one instant, before any of them completed (the
        predicate batcher's fused claim).

        Returns one FusedWindowView per window; fetch them IN DISPATCH
        ORDER with pack_window_fetch."""
        windows = [list(w) for w in request_windows]
        occupancy = self.dispatch_occupancy()
        flat = [r for w in windows for r in w]
        owner = self.pack_window_dispatch(strategy, tensors, flat)
        k = len(windows)
        if owner.info is not None:
            owner.info["fused_k"] = k
        bounds, lo = [], 0
        for w in windows:
            bounds.append((lo, lo + len(w)))
            lo += len(w)
        owner.fused_bounds = bounds
        self._fused_owners.add(owner)
        if self.telemetry is not None:
            self.telemetry.on_fused_dispatch(k, occupancy)
        return [FusedWindowView(owner, lo, hi, i, k)
                for i, (lo, hi) in enumerate(bounds)]

    def pack_window_fetch(self, handle) -> list[WindowDecision]:
        """Wait for a dispatched window's decisions and reconstruct the
        per-request outcomes (the second half of pack_window). A
        FusedWindowView fetches its umbrella ONCE (memoised, a failure
        included: every window of the batch raises the same error, and no
        view retries the pull on its own) and returns its own window's
        decisions.

        Pipeline accounting: the device base embodies every committed gang
        of a window from its dispatch on; its placements are debited from
        the mirror when the window is fetched, so the next build's
        host-vs-mirror delta ships only EXTERNAL changes, and a gang whose
        reservation the host then failed to create gets its capacity back
        with the next delta. The caller creates a window's reservations
        right after fetching it, so a fused batch debits each window when
        ITS view is fetched, not all K at the first: a build between two
        views' fetches must not hand the later windows' capacity back to
        the device before their reservations exist. The umbrella leaves
        the in-flight set when its last view is fetched."""
        if isinstance(handle, FusedWindowView):
            owner = handle.owner
            res = owner.fused_decisions
            if res is None:
                try:
                    res = ("ok", self._fetch_dispatch(owner, owner.fused_bounds))
                except Exception as exc:
                    res = ("err", exc)
                owner.fused_decisions = res
            kind, val = res
            if kind == "err":
                self._settle_poisoned(owner, handle.index)
                raise val
            decisions, rows, amounts = val[handle.index]
            self._debit_mirror(owner, handle.index, rows, amounts)
            self._settle_poisoned(owner, handle.index)
            return decisions
        if not handle.requests:
            return []
        try:
            ((decisions, rows, amounts),) = self._fetch_dispatch(
                handle, [(0, len(handle.requests))]
            )
        finally:
            self._settle_poisoned(handle, 0)
        self._debit_mirror(handle, 0, rows, amounts)
        return decisions

    def _settle_poisoned(self, handle: WindowHandle, index: int) -> None:
        """A view of a dispatch on a dropped carry was fetched (or failed);
        the dispatch stops holding builds back with its last view."""
        views = self._poisoned.get(handle)
        if views is not None:
            views.add(index)
            if len(views) == len(handle.fused_bounds or (None,)):
                del self._poisoned[handle]

    def _fetch_dispatch(self, handle: WindowHandle, bounds) -> list:
        """The decisions of a dispatch's windows (`bounds`: their [lo, hi)
        request ranges, in order; the committed base threads from one
        window to the next): [(decisions, placement rows, int64 amounts at
        those rows)] per window, also kept on the handle for later
        dispatches' priors. A window dispatched on a carry that a pruned
        window's escalation poisoned re-solves in full; a pruned window is
        certified first."""
        if handle.released:
            # close()/discard_pipeline() dropped this dispatch's buffer; its
            # decisions are gone by design.
            raise RuntimeError("window dispatch was discarded")
        if handle.greedy:
            if handle.resolved is None:
                if handle.parts is not None:
                    self._drain_parts(handle)
                handle.resolved = self._fetch_fallback(handle, bounds)
            return handle.resolved
        if handle.use_fallback:
            if handle.resolved is None:
                handle.resolved = self._resolve_full(handle, bounds)
            return handle.resolved
        if handle.parts is not None:
            out = self._fetch_pooled(handle, bounds)
            self._device_recovered()
            return out
        try:
            _shim("d2h")
            full = handle.fetch_blob()
        except Exception as exc:
            # The device base embodies this window's (now unknowable)
            # placements: the pipeline drops. With one device and no
            # survivor, the degraded policy answers: the host greedy
            # re-solves THIS window exactly (nothing of it was applied), or
            # a shed.
            self._drop_pipeline("fetch-failure")
            if not (classify_slot_failure(exc) and self.degraded is not None):
                raise
            self._degraded_or_raise(exc)
            handle.greedy = True
            handle.resolved = self._fetch_fallback(handle, bounds)
            return handle.resolved
        self._note_transfer("d2h", full.nbytes)
        if handle.prune is not None:
            out = self._fetch_pruned(handle, bounds, full)
        else:
            blob = full[handle.seg_map[0], handle.seg_map[1]]
            out = self._windows_from_blob(
                handle, bounds, blob, self._dense_base(handle),
                handle.host_schedulable,
            )
        self._device_recovered()
        return out

    def _drain_parts(self, handle: WindowHandle) -> None:
        """A pooled dispatch answered another way (re-solved in full, or on
        the host greedy) discards its part solves, but each runs to its end
        first (a solve left running on a worker could outlive the process)
        and releases its slot (`_await_parts`: a classified device fault
        quarantines the slot; any other failure raises)."""
        parts, handle.parts = handle.parts, None
        self._await_parts([(pt.future, pt.slot) for pt in parts])

    def _windows_from_blob(
        self, handle, bounds, blob, base, host_schedulable, row_map=None
    ) -> list:
        """Reconstruct each window of a flat decision blob [B, 3 + emax]
        over `base` (mutated: committed placements thread through it).
        `row_map` (a pruned fetch): decision indices, `base` and the
        placements live in kept-local space, and row_map maps a local
        index to its registry row."""
        drivers = blob[:, 0]
        admitted = blob[:, 1].astype(bool)
        packed = blob[:, 2].astype(bool)
        execs = blob[:, 3:]
        starts = np.concatenate(
            [[0], np.cumsum([len(req.rows) for req in handle.requests])]
        )
        out = []
        for lo, hi in bounds:
            rs = slice(int(starts[lo]), int(starts[hi]))
            requests = handle.requests[lo:hi]
            placements = np.zeros_like(base)
            decisions = self._reconstruct_requests(
                requests, drivers[rs], admitted[rs], packed[rs], execs[rs],
                handle.row_driver_req[rs], handle.row_exec_req[rs],
                handle.row_skippable[rs], base, placements, host_schedulable,
                row_map=row_map,
            )
            if row_map is None:
                rows = self._commit_rows(
                    requests, drivers[rs], admitted[rs], execs[rs]
                )
                out.append((decisions, rows, placements[rows]))
            else:
                loc = np.flatnonzero(placements.any(axis=1))
                out.append((decisions, row_map[loc], placements[loc]))
        handle.window_placements = [(r, a) for _, r, a in out]
        # The placed rows are availability churn the planner absorbs.
        for _, rows, _ in out:
            self._prune_note_rows(rows)
        if self.telemetry is not None:
            # Dispatch -> decisions on the host, per window of the dispatch
            # (a fused batch divides one round trip by its K windows).
            k = max(1, (handle.info or {}).get("fused_k", 1))
            self.telemetry.on_dispatch_complete(
                (time.perf_counter() - handle.dispatched_at) * 1e3 / k, k
            )
        return out

    def _fetch_pruned(self, handle: WindowHandle, bounds, full) -> list:
        """Tier 2 of the two-tier solve: certify the pruned decisions
        against the exact dispatch base on the kept rows (the host view
        minus the priors' placements) and reconstruct them in kept-local
        space, or escalate the dispatch to a full re-solve. O(K + rows):
        nothing here touches an [N]-wide array."""
        plan = handle.prune
        blob = full[handle.seg_map[0], handle.seg_map[1]].astype(np.int64)
        ok, reason, base_loc = self._certify_pruned(
            plan, handle, handle.requests, blob, handle.row_driver_req,
            handle.row_exec_req, handle.base_kept,
            self._collect_priors(handle, strict=True),
        )
        if not ok:
            return self._escalate_pruned(handle, bounds, reason)
        return self._windows_from_blob(
            handle, bounds, blob, base_loc,
            np.asarray(handle.host_schedulable)[plan.keep],
            row_map=plan.keep.astype(np.int64),
        )

    def _certify_pruned(
        self, plan, handle, requests, blob, drv64, exc64, base_kept, ps
    ):
        """The certificate of one pruned solve, in its kept-row space: the
        kept rows' dispatch base (`base_kept`, the host view on
        plan.keep[:k_real]) minus the priors' placements on them (`ps`,
        strict `_collect_priors`; None when unknown), then `certify_window`
        over the int64 decision `blob`, mapped back to global rows.
        Returns (ok, reason, the kept-local base [len(plan.keep), 3] the
        decisions reconstruct over)."""
        if ps is None:
            return False, "prior-unknown", None
        prior_rows, prior_deltas = ps
        gmap = plan.keep.astype(np.int64)
        bk = _debit_rows(
            base_kept[: plan.k_real].copy(), plan.keep[: plan.k_real],
            prior_rows, prior_deltas,
        )
        drivers_l, execs_l = blob[:, 0], blob[:, 3:]
        ok, reason = certify_window(
            plan,
            strategy=handle.strategy,
            requests=requests,
            drivers=np.where(drivers_l >= 0, gmap[np.clip(drivers_l, 0, None)], -1),
            admitted=blob[:, 1].astype(bool),
            packed=blob[:, 2].astype(bool),
            execs=np.where(execs_l >= 0, gmap[np.clip(execs_l, 0, None)], -1),
            drv64=drv64,
            exc64=exc64,
            base_kept=bk.copy(),  # certify threads commits
            host=handle.host_tensors,
            prior_rows=prior_rows,
            prior_deltas=prior_deltas,
        )
        base_loc = np.zeros((gmap.shape[0], NUM_DIMS), np.int64)
        base_loc[: plan.k_real] = bk
        return ok, reason, base_loc

    def _escalate_pruned(self, handle: WindowHandle, bounds, reason) -> list:
        """A failed certificate: re-solve the whole dispatch (every window
        of a fused umbrella) in full, then poison the carry, which
        embodies the discarded pruned placements."""
        out = self._resolve_full(handle, bounds)
        self._note_prune_escalation(handle, reason)
        return out

    def _resolve_full(self, handle: WindowHandle, bounds) -> list:
        """Re-solve a dispatch from the exact host reconstruction: the full
        [N,3] `_dense_base` (the host view at dispatch minus the placements
        of windows in flight then) and the dispatch's own statics and
        masks, through `_escalation_decisions` (the row walk on the
        solver's device, or the scale tier's node-sharded solve). The same
        solve an unpruned dispatch on that base runs, so the decisions are
        those of the unpruned path. A pooled dispatch's part solves end
        first (`_drain_parts`), whichever way the re-solve then answers."""
        if handle.parts is not None:
            self._drain_parts(handle)
        base = self._dense_base(handle)
        res = self._escalation_decisions(
            handle.strategy, handle.host_tensors, base, handle.window_rows
        )
        if res is None:
            handle.greedy = True
            return self._fetch_fallback(handle, bounds)
        blob, segments, nbytes = res
        if handle.info is not None:
            # The re-solve's reason, its live segments (row-walk launches
            # on the card) and its decision bytes, for the records.
            handle.info["resolved"] = {
                "reason": (
                    "prune-escalation" if handle.use_fallback else "certificate"
                ),
                "segments": segments,
                "d2h": nbytes,
            }
        return self._windows_from_blob(
            handle, bounds, blob, base, handle.host_schedulable,
        )

    def _escalation_decisions(self, strategy, host, base, rows: _WindowRows):
        """The exact re-solve of a window from host truth (JAX
        :4424-4445): (flat decision blob, row-walk segments, pulled bytes),
        or None when the caller serves the host greedy.

        With `solver.scale-tier` off, or where `_scale_mesh_for` finds a
        single shard, it is the row walk over `base` (`_solve_on_base`):
        the port's recorded deviation, since the JAX package re-solves on
        its host greedy there. With the tier on and S > 1 shards it is the
        node-sharded engine in window mode (`_scale_tier_decisions`).
        Deviation, recorded: the JAX tier falls back to the host greedy on
        ANY exception; here only a classified device fault
        (faults/errors.classify_slot_failure) reaches the degraded policy,
        as every device fault of the port does (`_degraded_or_raise`: the
        fault again with no controller, DegradedUnavailableError under
        shed); a greedy answer counts in `fallbacks`. Anything else
        raises."""
        if not self._scale_tier:
            return self._solve_on_base(strategy, host, base, rows)
        try:
            out = self._scale_tier_decisions(strategy, host, base, rows)
        except Exception as exc:
            if not classify_slot_failure(exc):
                raise
            self._degraded_or_raise(exc)
            self.scale_tier_stats["fallbacks"] += 1
            return None
        self.scale_tier_stats["resolves"] += 1
        return out

    def _scale_mesh_for(self, n: int):
        """The shard devices of a scale-tier re-solve (JAX :4447-4464): the
        largest power of two of the solver's devices that divides `n`, or
        None for one shard (the unsharded re-solve). The devices: a
        healthy mesh slot's shards when the pool has one (repeats allowed,
        as the mesh names them), else every local device of the solver's
        type."""
        from spark_scheduler_tpu_torch.parallel.mesh import local_devices

        meshes = [
            s.mesh.devices for s in (self._pool.slots if self._pool else ())
            if s.is_mesh and not s.quarantined
        ]
        devs = meshes[0] if meshes else local_devices(self.device.type)
        shards = 1
        while shards * 2 <= len(devs) and n % (shards * 2) == 0:
            shards *= 2
        return devs[:shards] if shards > 1 else None

    def _scale_tier_decisions(self, strategy, host, base, rows: _WindowRows):
        """One synchronous window re-solve over `base` (int64 [N,3]) and
        `host`'s statics: node-sharded over `_scale_mesh_for`'s devices
        (counted in `sharded`), else the row walk."""
        n = int(host.available.shape[0])
        devices = self._scale_mesh_for(n)
        if devices is None:
            return self._solve_on_base(strategy, host, base, rows)
        apps = self.window_app_batch(rows, pad_to=len(rows.drv_arr))
        avail32 = np.clip(base, _INT32.min, _INT32.max).astype(np.int32)
        self._note_transfer("h2d", _host_nbytes(host))
        self._ensure_probed()
        cluster = cluster_from_numpy(
            (avail32,) + tuple(cluster_statics(host)), device=devices[0]
        )
        out = node_sharded_fifo_pack(
            shard_cluster(devices, cluster), apps, fill=strategy,
            emax=rows.emax, num_zones=rows.num_zones,
        )
        full = _packing_blob(out).cpu().numpy()
        self._note_transfer("d2h", full.nbytes)
        self.scale_tier_stats["sharded"] += 1
        return full, 0, full.nbytes

    def _solve_on_base(self, strategy, host, base, rows: _WindowRows):
        """The row walk over `rows` on the full cluster with availability
        `base` (int64 [N,3]) and `host`'s statics, on the solver's device:
        (flat decision blob, live segments, pulled bytes)."""
        batch = self._layout(rows)
        avail32 = np.clip(base, _INT32.min, _INT32.max).astype(np.int32)
        cluster = cluster_from_numpy(
            (avail32,) + tuple(cluster_statics(host)), device=self.device
        )
        self._note_transfer("h2d", _host_nbytes(host) + _window_nbytes(batch.win))
        self._ensure_probed()
        meta, execs, _ = window_pack(
            cluster, batch.win, fill=strategy, emax=batch.emax,
            num_zones=batch.num_zones,
        )
        full = torch.cat([meta[:, :, :3], execs], dim=2).cpu().numpy()
        self._note_transfer("d2h", full.nbytes)
        return (
            full[batch.seg_map[0], batch.seg_map[1]],
            int((batch.win.row_count > 0).sum()),
            full.nbytes,
        )

    def _debit_mirror(self, handle: WindowHandle, index: int, rows, amounts) -> None:
        """Debit one fetched window's placements from the pipeline mirror
        (pack_window_fetch); the dispatch leaves the in-flight set with its
        last window."""
        p = self._pipe
        if p is None or handle not in p["unfetched"] or index in handle.applied:
            return
        ne = handle.avail_note_epoch
        if ne is not None and p["avail_journal"].get(ne, 0) is None:
            # The dispatch journaled its epoch as unknowable; the fetch
            # knows the commit rows of all its windows now: pool replicas
            # can catch up across it.
            p["avail_journal"][ne] = np.unique(
                np.concatenate(
                    [np.empty(0, np.int64)]
                    + [r for r, _ in handle.window_placements or ()]
                )
            )
        handle.applied.add(index)
        if rows.size:
            p["mirror"][rows] -= amounts
            with self._build_lock:
                if p.get("pending") is not None:
                    # Debited rows differ from the host view until their
                    # reservations write back: the mirror sync keeps
                    # comparing them.
                    p["pending"].append(rows)
            if handle.parts is not None:
                self.build_stats["pooled_debit_rows"] += int(rows.size)
        if len(handle.applied) == len(handle.fused_bounds or (None,)):
            p["unfetched"].remove(handle)
            self._note_inflight()

    @staticmethod
    def _commit_rows(requests, drivers, admitted, execs) -> np.ndarray:
        """Sorted rows a window's COMMITTED placements touched, read from
        the decision blob: each admitted request's final row's driver and
        executor nodes (the support of the dense placements)."""
        rows: list[int] = []
        r = 0
        for req in requests:
            real = r + len(req.rows) - 1
            r += len(req.rows)
            if not bool(admitted[real]):
                continue
            if drivers[real] >= 0:
                rows.append(int(drivers[real]))
            ev = execs[real]
            rows.extend(int(x) for x in ev[ev >= 0])
        return np.unique(np.asarray(rows, np.int64))

    def _dense_base(self, handle) -> np.ndarray:
        """The [N,3] int64 fetch-side base: the host view at dispatch minus
        the placements the device base lacked then — those of the windows
        in flight whose views the mirror had not yet debited when the
        dispatched tensors were built (a fused umbrella's fetched views
        were in the host view already). A prior whose fetch never ran
        contributes nothing: its capacity returns with the next full
        upload."""
        if handle.host_avail is not None:
            base = np.array(handle.host_avail, dtype=np.int64)
        else:
            base = self._avail_at_dispatch(handle).astype(np.int64)
        for i, rows, amounts in self._prior_windows(handle):
            if i is not None and rows.size:
                base[rows] -= amounts
        return base

    def _reconstruct_requests(
        self, requests, drivers, admitted, packed, execs,
        drv64, exc64, skip, base, placements, host_schedulable,
        row_map=None,
    ) -> list[WindowDecision]:
        """Host-side reconstruction for per-request packing efficiency: the
        availability each admitted request's final pack saw = the host view
        at dispatch, minus the committed placements of windows in flight
        then, minus committed placements of earlier segments, minus
        in-segment admitted hypothetical placements. Mutates `base` and
        `placements` (the window's committed gangs, added in place).
        `row_map` (a pruned fetch): indices, `base` and `placements` are
        kept-local, and row_map maps a local index to its registry row."""
        name_of = self.registry.name_of
        if row_map is not None:
            registry_name = name_of

            def name_of(i):
                return registry_name(int(row_map[i]))

        decisions: list[WindowDecision] = []
        row = 0
        for req in requests:
            nrows = len(req.rows)
            hyp = np.arange(row, row + nrows - 1)
            real = row + nrows - 1
            row += nrows
            req_admitted = bool(admitted[real])
            earlier_blocked = False
            eff = None
            if nrows > 1:
                adm_h = admitted[hyp]
                earlier_blocked = bool(
                    np.any(~adm_h & ~packed[hyp] & ~skip[hyp])
                )
            if req_admitted:
                seg_avail = base.copy()
                if nrows > 1:
                    dsel = adm_h & (drivers[hyp] >= 0)
                    if dsel.any():
                        np.subtract.at(
                            seg_avail, drivers[hyp][dsel], drv64[hyp][dsel]
                        )
                    e = execs[hyp]
                    esel = adm_h[:, None] & (e >= 0)
                    if esel.any():
                        ri, _si = np.nonzero(esel)
                        np.subtract.at(seg_avail, e[esel], exc64[hyp][ri])
                eff = avg_packing_efficiency_np(
                    host_schedulable,
                    seg_avail,
                    int(drivers[real]),
                    execs[real],
                    drv64[real],
                    exc64[real],
                )
                # Commit this request's placement into the base for the
                # segments after it (mirrors the device-side base thread).
                if drivers[real] >= 0:
                    base[drivers[real]] -= drv64[real]
                    placements[drivers[real]] += drv64[real]
                ev = execs[real]
                ev = ev[ev >= 0]
                if ev.size:
                    np.subtract.at(base, ev, exc64[real])
                    np.add.at(placements, ev, exc64[real])
            exec_idx = [int(x) for x in execs[real] if int(x) >= 0]
            decisions.append(
                WindowDecision(
                    packing=HostPacking(
                        driver_node=(
                            name_of(int(drivers[real]))
                            if drivers[real] >= 0
                            else None
                        ),
                        executor_nodes=[name_of(x) for x in exec_idx],
                        has_capacity=bool(packed[real]),
                        efficiency_max=float(eff.max) if eff else 0.0,
                        efficiency_cpu=float(eff.cpu) if eff else 0.0,
                        efficiency_memory=float(eff.memory) if eff else 0.0,
                        efficiency_gpu=float(eff.gpu) if eff else 0.0,
                    ),
                    admitted=req_admitted,
                    earlier_blocked=earlier_blocked,
                )
            )
        return decisions

    def subtract_usage(self, tensors: ClusterTensors, usage: dict[str, Resources]):
        """Subtract per-node usage from availability
        (NodeGroupSchedulingMetadata.SubtractUsageIfExists,
        resources.go:128-135); returns new tensors on the solver's device
        and never writes the input's `available`."""
        avail = np.array(tensors.available.cpu().numpy())
        for name, res in usage.items():
            idx = self.registry.index_of(name)
            if idx is not None and idx < avail.shape[0]:
                avail[idx] = avail[idx] - res.as_array()
        out = dataclasses.replace(
            tensors, available=torch.tensor(avail, device=self.device)
        )
        out.host = dataclasses.replace(host_view(tensors), available=avail)
        return out
