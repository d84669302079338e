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
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import weakref
from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_scheduler_tpu_torch.core.prune import (
    PLAIN_FILLS,
    PrunePlanner,
    certify_window,
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
from spark_scheduler_tpu_torch.models.resources import NUM_DIMS, Resources
from spark_scheduler_tpu_torch.ops.efficiency import avg_packing_efficiency_np
from spark_scheduler_tpu_torch.ops.packing import (
    BINPACK_STRATEGIES,
    PREEMPTION_FILL,
    preemption_batched_fit,
)
from spark_scheduler_tpu_torch.ops.probe import probe
from spark_scheduler_tpu_torch.ops.window import (
    SegmentedWindow,
    segmented_window_from_flat,
    window_pack,
)


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
        "__weakref__",
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
        self.requests = requests
        # Host availability at dispatch ([N,3]: an int64 copy, or for a
        # pruned dispatch the int32 host array itself, read only on an
        # escalation); the device base additionally lacks the placements
        # of `priors` (windows dispatched earlier but un-fetched at this
        # dispatch).
        self.host_avail = host_avail
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

    @property
    def dispatch_id(self):
        return (self.info or {}).get("dispatch_id")

    def release_buffers(self) -> None:
        """Drop the decision buffer (close()/discard_pipeline()): a
        discarded fused batch must not keep its blob alive through views
        parked in the serving loop. A later fetch fails fast."""
        self.released = True
        self.blob = None
        self.ready = None

    def fetch_blob(self) -> np.ndarray:
        """The decision blob on the host, waiting for the device if the
        copy has not landed yet."""
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


class PlacementSolver:
    def __init__(
        self,
        driver_label_priority: tuple[str, list[str]] | None = None,
        executor_label_priority: tuple[str, list[str]] | None = None,
        device="cuda",
        delta_statics: bool = True,
        prune_top_k: int = 0,
        prune_slack: float = 2.0,
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
        # Static row deltas shipped (a node event riding the pipeline).
        self.device_state_stats = {"static_delta_uploads": 0}
        # Dispatch info of the most recent solve (solo pack or window).
        self.last_solve_info: dict | None = None
        # SolverTelemetry hook surface (observability/telemetry.py), wired
        # by build_scheduler_app; None keeps every hot-path hook a single
        # attribute test. There is no degraded mode: a build or launch
        # failure raises.
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

    def _build_host(self, nodes: Sequence[Node], usage, overhead):
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
        """Copy a host view to the solver's device (never aliasing it)."""
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
        """`usage` / `overhead` are {node: Resources} maps or dense int64
        [cap, 3] arrays indexed by this solver's registry.

        The keyword arguments are the JAX package's build accelerators
        (topology memo, roster rows, dirty hints, availability journal).
        The port always runs the full host build, the JAX package's own
        path without its native arena, so it accepts them and reads none:
        no hint can change a result."""
        return self._upload(self._build_host(nodes, usage, overhead))

    def close(self) -> None:
        """Release the pipelined device state (the app's shutdown). The
        solver keeps no worker threads: a dispatch's decision copy is
        queued on the card's stream, so there is no queued work to
        cancel."""
        self._pipe = None
        self._poisoned.clear()
        self._prune_gather_cache.clear()  # release the gathered statics
        self._release_fused()
        self._note_inflight()

    def discard_pipeline(self) -> None:
        """Drop the pipelined device state: the next build_tensors_pipelined
        does a full upload from the host view. Used when in-flight window
        decisions are being discarded (capacity changed under them) — the
        host view is the durable truth once every surviving window has
        applied. Fused batches in flight release their decision buffers:
        their decisions are discarded with the pipeline."""
        self._pipe = None
        self._poisoned.clear()
        self._prune_gather_cache.clear()  # release the gathered statics
        self._release_fused()
        self._note_inflight()
        if self.telemetry is not None:
            self.telemetry.on_pipeline_event("discard")

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
        gangs of the windows dispatched on a carry that a pruned window's
        escalation dropped and not fetched yet. Those windows re-solve
        here, in dispatch order, and their fetches return these decisions,
        so a solo solve sees their gangs as the threaded base would have
        shown them. Windows in flight across a topology change are still
        not seen (ROADMAP §C.6). The keyword arguments are those of
        build_tensors, read by neither."""
        host = self._build_host(nodes, usage, overhead)
        if self._poisoned:
            avail = host.available.astype(np.int64)
            for h, fetched in list(self._poisoned.items()):
                if h.use_fallback and h.resolved is None and h.requests:
                    h.resolved = self._resolve_full(
                        h, h.fused_bounds or [(0, len(h.requests))]
                    )
                for i, (rows, amounts) in enumerate(h.window_placements or ()):
                    if i not in fetched and rows.size:
                        avail[rows] -= amounts
            host = dataclasses.replace(
                host,
                available=np.clip(avail, _INT32.min, _INT32.max).astype(np.int32),
            )
        return self._upload(host)

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
        time, the rows the dense mirror compare examined and the rows it
        found changed (`on_build`), and how the build reached the device
        (`on_device_upload`). The keyword arguments are build accelerators
        the port does not read (see build_tensors)."""
        t0 = time.perf_counter()
        counts = {"compared": 0, "dirty": 0}
        try:
            tensors = self._build_tensors_pipelined(nodes, usage, overhead, counts)
        finally:
            if self.telemetry is not None:
                self.telemetry.on_build(
                    (time.perf_counter() - t0) * 1e3,
                    counts["compared"],
                    counts["dirty"],
                )
        if self.telemetry is not None:
            self.telemetry.on_device_upload(
                str(self.device), self.last_state_upload
            )
        return tensors

    def _build_tensors_pipelined(
        self, nodes: Sequence[Node], usage, overhead, counts: dict
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

        A static-field change that touches few rows ships as a row scatter
        (`delta_statics`); any other static change needs a full upload,
        which raises PipelineDrainRequired while a window is in flight —
        fetch it first, then retry. So does an availability delta beyond
        int32. `counts` receives the rows compared and found dirty.
        Single-threaded by contract.

        After a pruned window's escalation dropped the pipeline, the build
        raises PipelineDrainRequired until every window dispatched on the
        dropped carry has been fetched: their gangs are on no device base
        and in no host view yet, and a window dispatched on a fresh upload
        would not see them (the JAX package does not wait, and such a
        window can over-commit)."""
        if self._pipe is None and self._poisoned:
            if self.telemetry is not None:
                self.telemetry.on_pipeline_event("drain")
            raise PipelineDrainRequired(
                "windows dispatched on a carry a pruned window's escalation "
                "dropped are still in flight"
            )
        host = self._build_host(nodes, usage, overhead)
        p = self._pipe
        static_plan = None
        statics_same = False
        if p is not None and p["host"].available.shape == host.available.shape:
            statics_same = all(
                np.array_equal(getattr(p["host"], f), getattr(host, f))
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
            # Rows whose availability the delta must ship: a dense compare
            # of the host view against the mirror.
            dirty = np.flatnonzero((mirror != host.available).any(axis=1))
            counts["compared"] += len(mirror)
            counts["dirty"] += len(dirty)
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
                    # The prune planner's O(changed) sync rides exactly
                    # this dirty set (and the fetched placement rows).
                    self._prune_note_rows(dirty)
                    # Out of place: the base a caller still holds (through
                    # an earlier build's tensors) is never written.
                    rows32 = delta_rows.astype(np.int32)
                    avail = avail.index_add(
                        0,
                        torch.as_tensor(dirty, device=self.device),
                        torch.as_tensor(rows32, device=self.device),
                    )
                    mirror[dirty] = host.available[dirty]
                    self._note_transfer("h2d", dirty.nbytes + rows32.nbytes)
                self.last_state_upload = (
                    "delta" if dirty.size or static_plan is not None else "reuse"
                )
                tensors = dataclasses.replace(
                    p["tensors"], available=avail, **static_fields
                )
                tensors.host = host
                # Which views of each in-flight window the mirror has
                # debited as of THIS build: the host view holds their
                # reservations, the device base lacks only the rest.
                debited = {h: frozenset(h.applied) for h in p["unfetched"]}
                p.update(host=host, tensors=tensors, avail=avail,
                         debited=debited)
                return tensors
        if p is not None and p["unfetched"]:
            if self.telemetry is not None:
                self.telemetry.on_pipeline_event("drain")
            raise PipelineDrainRequired(
                "cluster topology changed with a window in flight"
            )
        tensors = self._upload(host)
        self._note_transfer("h2d", _host_nbytes(host))
        self.last_state_upload = "full"
        # The statics may have changed: the planner's resident state and
        # the gathered statics start again from this host view.
        self._static_epoch += 1
        self._prune_invalidate()
        self._pipe = {
            "host": host,
            "tensors": tensors,
            "avail": tensors.available,
            "mirror": host.available.astype(np.int64),
            "unfetched": [],
            "debited": {},
        }
        return tensors

    def _plan_static_delta(self, prev, host):
        """(changed field names, dirty rows) when the static drift between
        two same-shape host views is small enough to ship as a row
        scatter; None sends the caller to the full-upload/drain path."""
        n = host.available.shape[0]
        changed: list[str] = []
        rows_mask = np.zeros(n, dtype=bool)
        for f in _STATIC_FIELDS:
            neq = np.asarray(getattr(prev, f)) != np.asarray(getattr(host, f))
            if neq.ndim == 2:
                neq = neq.any(axis=1)
            if neq.any():
                changed.append(f)
                rows_mask |= neq
        if not changed:
            return None
        rows = np.flatnonzero(rows_mask)
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
        self.device_state_stats["static_delta_uploads"] += 1
        self._note_transfer("h2d", nbytes)
        self._static_epoch += 1
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
        keep the tuple key."""
        n = tensors.num_nodes
        names = (
            node_names
            if getattr(node_names, "names_digest", None) is not None
            else tuple(node_names)
        )
        epoch = self.registry.epoch
        key = (n, epoch, names)
        with self._cand_lock:
            mask = self._cand_cache.get(key)
            if mask is not None:
                self._cand_cache.move_to_end(key)
                return mask
        mask = np.zeros(n, dtype=bool)
        index_of = self.registry.index_of
        for name in names:
            idx = index_of(name)
            if idx is not None and idx < n:
                mask[idx] = True
        mask.flags.writeable = False
        # Seqlock read: cache only a walk over one stable mapping.
        if not epoch & 1 and self.registry.epoch == epoch:
            with self._cand_lock:
                self._cand_cache[key] = mask
                while len(self._cand_cache) > 64:
                    self._cand_cache.popitem(last=False)
        return mask

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
        self._ensure_probed()
        meta, execs, _base_after = window_pack(
            tensors, win, fill=strategy, emax=emax,
            num_zones=self._num_zones_bucket(),
        )
        blob = torch.cat([meta[0, 0, :3], execs[0, 0]]).cpu().numpy()
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
        self._check_device(tensors)
        if not requests:
            return WindowHandle(
                strategy=strategy, blob=None, requests=(), host_avail=None,
                host_schedulable=None,
            )
        rows = self._window_rows(tensors, requests)
        p = self._pipe
        pipelined = p is not None and tensors is p["tensors"]
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
        n = tensors.num_nodes
        batch = self._layout(rows)
        tel = self.telemetry
        compiles_before = tel.compile_count() if tel is not None else None
        self._ensure_probed()
        path = "cuda" if self.device.type == "cuda" else "reference"
        meta, execs, base_after = window_pack(
            tensors, batch.win, fill=strategy, emax=batch.emax,
            num_zones=batch.num_zones,
        )
        blob, ready = self._stage_blob(meta, execs)
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
        if pipelined:
            if self._prune_top_k > 0:
                # Read only by a full re-solve, after a pruned window's
                # escalation poisoned the carry this dispatch rides.
                handle.host_tensors = host
                handle.window_rows = rows
            p["unfetched"].append(handle)
            self._note_inflight()
        return handle

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
        gathered statics): the full-upload contract. The port keeps no
        resident host build that could name a full upload's changed rows,
        so there is no warm restart of the planner."""
        if self._planner is not None:
            self._planner.invalidate()
        self._prune_gather_cache.clear()

    def _prune_note_rows(self, rows) -> None:
        """Feed EXACT changed rows to the planner (O(changed) sync)."""
        if self._planner is not None and len(rows):
            self._planner.note_dirty(rows)

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
            host_avail=np.asarray(host.available),
            host_schedulable=np.asarray(host.schedulable),
            priors=priors,
            prior_debited=debited,
        )
        handle.ready = ready
        # The certificate's base, gathered on the kept rows now.
        handle.base_kept = handle.host_avail[keep[: plan.k_real]].astype(
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
        p = self._pipe
        occupancy = 1.0 if p is not None and p["unfetched"] else 0.0
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
        if handle.use_fallback:
            if handle.resolved is None:
                handle.resolved = self._resolve_full(handle, bounds)
            return handle.resolved
        if handle.prune is not None:
            return self._fetch_pruned(handle, bounds)
        full = handle.fetch_blob()
        self._note_transfer("d2h", full.nbytes)
        blob = full[handle.seg_map[0], handle.seg_map[1]]
        return self._windows_from_blob(
            handle, bounds, blob, self._dense_base(handle),
            handle.host_schedulable,
        )

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

    def _fetch_pruned(self, handle: WindowHandle, bounds) -> list:
        """Tier 2 of the two-tier solve: certify the pruned decisions
        against the exact dispatch base on the kept rows (the host view
        minus the priors' placements) and reconstruct them in kept-local
        space, or escalate the dispatch to a full re-solve. O(K + rows):
        nothing here touches an [N]-wide array."""
        plan = handle.prune
        full = handle.fetch_blob()
        self._note_transfer("d2h", full.nbytes)
        blob = full[handle.seg_map[0], handle.seg_map[1]].astype(np.int64)
        gmap = plan.keep.astype(np.int64)
        keep_real = plan.keep[: plan.k_real]
        drivers_l = blob[:, 0]
        execs_l = blob[:, 3:]
        drivers = np.where(drivers_l >= 0, gmap[np.clip(drivers_l, 0, None)], -1)
        execs = np.where(execs_l >= 0, gmap[np.clip(execs_l, 0, None)], -1)
        ps = self._collect_priors(handle, strict=True)
        if ps is None:
            ok, reason = False, "prior-unknown"
        else:
            prior_rows, prior_deltas = ps
            base_kept = handle.base_kept.copy()
            if prior_rows.size:
                loc = np.searchsorted(keep_real, prior_rows)
                locc = np.clip(loc, 0, keep_real.size - 1)
                on_kept = keep_real[locc] == prior_rows
                if on_kept.any():
                    base_kept[locc[on_kept]] -= prior_deltas[on_kept]
            ok, reason = certify_window(
                plan,
                strategy=handle.strategy,
                requests=handle.requests,
                drivers=drivers,
                admitted=blob[:, 1].astype(bool),
                packed=blob[:, 2].astype(bool),
                execs=execs,
                drv64=handle.row_driver_req,
                exc64=handle.row_exec_req,
                base_kept=base_kept.copy(),  # certify threads commits
                host=handle.host_tensors,
                prior_rows=prior_rows,
                prior_deltas=prior_deltas,
            )
        if not ok:
            return self._escalate_pruned(handle, bounds, reason)
        base_loc = np.zeros((plan.keep.shape[0], NUM_DIMS), np.int64)
        base_loc[: plan.k_real] = base_kept
        return self._windows_from_blob(
            handle, bounds, blob, base_loc,
            np.asarray(handle.host_schedulable)[plan.keep], row_map=gmap,
        )

    def _escalate_pruned(self, handle: WindowHandle, bounds, reason) -> list:
        """A failed certificate: re-solve the whole dispatch (every window
        of a fused umbrella) in full, then poison the carry, which
        embodies the discarded pruned placements."""
        out = self._resolve_full(handle, bounds)
        self._note_prune_escalation(handle, reason)
        return out

    def _resolve_full(self, handle: WindowHandle, bounds) -> list:
        """Re-solve a dispatch from the exact host reconstruction: the row
        walk over the full [N,3] `_dense_base` (the host view at dispatch
        minus the placements of windows in flight then) and the dispatch's
        own statics and masks, on the solver's device. The same solve an
        unpruned dispatch on that base runs, so the decisions are those
        of the unpruned path."""
        base = self._dense_base(handle)
        host = handle.host_tensors
        batch = self._layout(handle.window_rows)
        avail32 = np.clip(base, _INT32.min, _INT32.max).astype(np.int32)
        cluster = cluster_from_numpy(
            (avail32,) + tuple(cluster_statics(host)), device=self.device
        )
        self._note_transfer("h2d", _host_nbytes(host) + _window_nbytes(batch.win))
        self._ensure_probed()
        meta, execs, _ = window_pack(
            cluster, batch.win, fill=handle.strategy, emax=batch.emax,
            num_zones=batch.num_zones,
        )
        full = torch.cat([meta[:, :, :3], execs], dim=2).cpu().numpy()
        self._note_transfer("d2h", full.nbytes)
        if handle.info is not None:
            # The re-solve's reason, its live segments (row-walk launches
            # on the card) and its decision bytes, for the records.
            handle.info["resolved"] = {
                "reason": (
                    "prune-escalation" if handle.use_fallback else "certificate"
                ),
                "segments": int((batch.win.row_count > 0).sum()),
                "d2h": full.nbytes,
            }
        return self._windows_from_blob(
            handle, bounds, full[batch.seg_map[0], batch.seg_map[1]], base,
            handle.host_schedulable,
        )

    def _debit_mirror(self, handle: WindowHandle, index: int, rows, amounts) -> None:
        """Debit one fetched window's placements from the pipeline mirror
        (pack_window_fetch); the dispatch leaves the in-flight set with its
        last window."""
        p = self._pipe
        if p is None or handle not in p["unfetched"] or index in handle.applied:
            return
        handle.applied.add(index)
        if rows.size:
            p["mirror"][rows] -= amounts
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
        base = np.array(handle.host_avail, dtype=np.int64)
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
