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

from spark_scheduler_tpu_torch.models.cluster import (
    ClusterTensors,
    NodeRegistry,
    build_host_tensors,
    cluster_from_numpy,
    host_view,
    pad_bucket,
)
from spark_scheduler_tpu_torch.models.kube import Node
from spark_scheduler_tpu_torch.models.resources import Resources
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


class WindowHandle:
    """A dispatched-but-not-yet-fetched window solve
    (PlacementSolver.pack_window_dispatch -> pack_window_fetch)."""

    __slots__ = (
        "strategy", "blob", "ready", "requests", "host_avail",
        "host_schedulable", "priors", "placement_rows", "placement_vals",
        "row_driver_req", "row_exec_req", "row_skippable", "seg_map", "info",
        "request_device", "dispatched_at", "released", "fused_decisions",
        "fused_bounds", "applied", "__weakref__",
    )

    def __init__(self, *, strategy, blob, requests, host_avail,
                 host_schedulable, priors=()):
        self.strategy = strategy
        # Decision blob [S, R, 3 + emax] int32: (driver, admitted, packed,
        # executor slots...) per segment row; seg_map flattens the real
        # rows after the pull. On the card it is a pinned host buffer
        # whose copy was queued right behind the window's kernels, and
        # `ready` is the CUDA event that copy records.
        self.blob = blob
        self.ready = None
        self.requests = requests
        # Host availability at dispatch (int64 [N,3]); the device base
        # additionally lacks the placements of `priors` (windows dispatched
        # earlier but un-fetched at this dispatch).
        self.host_avail = host_avail
        self.host_schedulable = host_schedulable
        self.priors = priors  # tuple[WindowHandle] — fetched before this one
        # Committed placements, filled at fetch: the rows they touched
        # (sorted) and the int64 [P,3] amounts at those rows.
        self.placement_rows = None
        self.placement_vals = None
        self.row_driver_req = None  # int64 [B,3]
        self.row_exec_req = None
        self.row_skippable = None
        self.seg_map = None  # (seg_idx, row_idx)
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
        Single-threaded by contract."""
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
                p.update(host=host, tensors=tensors, avail=avail)
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
        self._pipe = {
            "host": host,
            "tensors": tensors,
            "avail": tensors.available,
            "mirror": host.available.astype(np.int64),
            "unfetched": [],
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
        arrays, the emax bucket and the [S, R] layout."""
        valid_np = np.asarray(host_view(tensors).valid)
        flat_rows: list[tuple] = []
        cand_per_req: list[np.ndarray] = []
        dom_per_req: list[np.ndarray] = []
        dom_memo: dict = {}
        for req in requests:
            cand = self.candidate_mask(tensors, req.driver_candidate_names)
            if req.domain_mask is not None:
                dom = np.asarray(req.domain_mask) & valid_np
            elif req.domain_node_names is not None:
                key = tuple(req.domain_node_names)
                dom = dom_memo.get(key)
                if dom is None:
                    dom = self.candidate_mask(tensors, key) & valid_np
                    dom_memo[key] = dom
            else:
                dom = valid_np
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

        drv_arr = np.stack([as_arr(r[0]) for r in flat_rows])
        exc_arr = np.stack([as_arr(r[1]) for r in flat_rows])
        counts = np.asarray([r[2] for r in flat_rows], np.int32)
        skip_arr = np.asarray([bool(r[3]) for r in flat_rows])
        win, seg_idx, row_idx = _build_segmented_window(
            requests, drv_arr, exc_arr, counts, skip_arr,
            cand_per_req, dom_per_req,
        )
        return WindowBatch(
            win=win,
            emax=pad_bucket(max(int(counts.max()), 1), 8),
            num_zones=self._num_zones_bucket(),
            seg_map=(seg_idx, row_idx),
            driver_req=drv_arr,
            exec_req=exc_arr,
            skippable=skip_arr,
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
        host reconstruction sees exactly the availability the device saw."""
        if strategy not in BINPACK_STRATEGIES:
            raise ValueError(f"strategy {strategy!r} is not batchable")
        self._check_device(tensors)
        if not requests:
            return WindowHandle(
                strategy=strategy, blob=None, requests=(), host_avail=None,
                host_schedulable=None,
            )
        n = tensors.num_nodes
        batch = self.window_batch(tensors, requests)
        tel = self.telemetry
        compiles_before = tel.compile_count() if tel is not None else None
        self._ensure_probed()
        path = "cuda" if self.device.type == "cuda" else "reference"
        meta, execs, base_after = window_pack(
            tensors, batch.win, fill=strategy, emax=batch.emax,
            num_zones=batch.num_zones,
        )
        blob = torch.cat([meta[:, :, :3], execs], dim=2)
        ready = None
        if blob.is_cuda:
            # Queue the decision pull right behind this window's kernels,
            # so a fetch never waits for windows dispatched after it.
            host_blob = torch.empty(blob.shape, dtype=blob.dtype, pin_memory=True)
            host_blob.copy_(blob, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            blob = host_blob
        self.window_path_counts[path] = (
            self.window_path_counts.get(path, 0) + 1
        )
        p = self._pipe
        pipelined = p is not None and tensors is p["tensors"]
        priors: tuple = ()
        if pipelined:
            priors = tuple(p["unfetched"])
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
            requests=tuple(requests),
            host_avail=np.array(host.available, dtype=np.int64),
            host_schedulable=np.asarray(host.schedulable),
            priors=priors,
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
                    res = ("ok", self._fetch_windows(owner, owner.fused_bounds))
                except Exception as exc:
                    res = ("err", exc)
                owner.fused_decisions = res
            kind, val = res
            if kind == "err":
                raise val
            decisions, rows, amounts = val[handle.index]
            self._debit_mirror(owner, handle.index, rows, amounts)
            return decisions
        if not handle.requests:
            return []
        ((decisions, rows, amounts),) = self._fetch_windows(
            handle, [(0, len(handle.requests))]
        )
        self._debit_mirror(handle, 0, rows, amounts)
        return decisions

    def _fetch_windows(self, handle: WindowHandle, bounds) -> list:
        """Pull a dispatch's decision blob and reconstruct each window's
        requests (`bounds`: their [lo, hi) ranges, in order; the committed
        base threads from one window to the next). Returns [(decisions,
        placement rows, int64 amounts at those rows)] per window and sets
        the handle's placements (all windows) for later dispatches'
        `_dense_base`."""
        if handle.released:
            # close()/discard_pipeline() dropped this dispatch's buffer; its
            # decisions are gone by design.
            raise RuntimeError("window dispatch was discarded")
        full = handle.fetch_blob()
        self._note_transfer("d2h", full.nbytes)
        blob = full[handle.seg_map[0], handle.seg_map[1]]
        drivers = blob[:, 0]
        admitted = blob[:, 1].astype(bool)
        packed = blob[:, 2].astype(bool)
        execs = blob[:, 3:]
        base = self._dense_base(handle)
        total = np.zeros_like(base)
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
                handle.row_skippable[rs], base, placements,
                handle.host_schedulable,
            )
            rows = self._commit_rows(requests, drivers[rs], admitted[rs], execs[rs])
            out.append((decisions, rows, placements[rows]))
            total += placements
        rows = np.unique(np.concatenate([r for _, r, _ in out]))
        handle.placement_rows = rows
        handle.placement_vals = total[rows]
        if self.telemetry is not None:
            # Dispatch -> decisions on the host, per window of the dispatch
            # (a fused batch divides one round trip by its K windows).
            k = max(1, (handle.info or {}).get("fused_k", 1))
            self.telemetry.on_dispatch_complete(
                (time.perf_counter() - handle.dispatched_at) * 1e3 / k, k
            )
        return out

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
        the placements of the windows still in flight then (the device had
        them threaded). A prior whose fetch never ran contributes nothing:
        its capacity returns with the next full upload."""
        base = handle.host_avail.copy()
        for prior in handle.priors:
            if prior.placement_rows is not None and prior.placement_rows.size:
                base[prior.placement_rows] -= prior.placement_vals
        return base

    def _reconstruct_requests(
        self, requests, drivers, admitted, packed, execs,
        drv64, exc64, skip, base, placements, host_schedulable,
    ) -> list[WindowDecision]:
        """Host-side reconstruction for per-request packing efficiency: the
        availability each admitted request's final pack saw = the host view
        at dispatch, minus the committed placements of windows in flight
        then, minus committed placements of earlier segments, minus
        in-segment admitted hypothetical placements. Mutates `base` and
        `placements` (the window's committed gangs, added in place)."""
        name_of = self.registry.name_of
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
