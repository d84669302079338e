"""PlacementSolver — the host <-> device boundary of the port's scheduler.

The port of spark_scheduler_tpu/core/solver.py's single-device serving path:
everything above this module speaks names and Resources, everything below it
(ops/) speaks int32 tensors over a stable node-index space. The solver
interns nodes into the NodeRegistry, builds ClusterTensors on its device
(padded to a power-of-two node count), serves a window of coalesced
/predicates requests through the segmented window solve (ops/window.py), and
maps the decisions back to node names.

The solver runs on `device="cuda"` unless the caller asks for the CPU; with
no card and no explicit CPU request it raises, and it never moves work to
the CPU on its own. On the card the window goes through the CUDA row-walk
kernel; on the CPU through its plain PyTorch version.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spark_scheduler_tpu_torch.models.cluster import (
    ClusterTensors,
    NodeRegistry,
    build_cluster_tensors,
    host_view,
    pad_bucket,
)
from spark_scheduler_tpu_torch.models.kube import Node
from spark_scheduler_tpu_torch.ops.efficiency import avg_packing_efficiency_np
from spark_scheduler_tpu_torch.ops.packing import BINPACK_STRATEGIES
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


class WindowHandle:
    """A dispatched-but-not-yet-fetched window solve
    (PlacementSolver.pack_window_dispatch -> pack_window_fetch)."""

    __slots__ = (
        "strategy", "blob", "requests", "host_avail", "host_schedulable",
        "row_driver_req", "row_exec_req", "row_skippable", "seg_map",
    )

    def __init__(self, *, strategy, blob, requests, host_avail,
                 host_schedulable):
        self.strategy = strategy
        # Device blob [S, R, 3 + emax] int32: (driver, admitted, packed,
        # executor slots...) per segment row; seg_map flattens the real
        # rows after the pull.
        self.blob = blob
        self.requests = requests
        # Host availability at dispatch (int64 [N,3]) for the fetch-side
        # efficiency reconstruction.
        self.host_avail = host_avail
        self.host_schedulable = host_schedulable
        self.row_driver_req = None  # int64 [B,3]
        self.row_exec_req = None
        self.row_skippable = None
        self.seg_map = None  # (seg_idx, row_idx)


class PlacementSolver:
    def __init__(
        self,
        driver_label_priority: tuple[str, list[str]] | None = None,
        executor_label_priority: tuple[str, list[str]] | None = None,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PlacementSolver(device='cuda') needs a CUDA device and none "
                "is available; pass device='cpu' to run the plain PyTorch path"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.registry = NodeRegistry()
        self._driver_label_priority = driver_label_priority
        self._executor_label_priority = executor_label_priority
        # Candidate-mask memo keyed by (N, registry epoch, names): serving
        # windows pass the same (usually cluster-wide) candidate list once
        # per request, and the mask build walks every name.
        self._cand_cache: OrderedDict = OrderedDict()
        # The card's kernels are built and checked by one probe launch
        # before the first window solve on a CUDA device.
        self._probed = False
        # Which path served each dispatched window: "cuda" (the row-walk
        # kernel) or "reference" (its plain version on the CPU).
        self.window_path_counts: dict[str, int] = {}

    def build_tensors(self, nodes: Sequence[Node], usage, overhead):
        """`usage` / `overhead` are {node: Resources} maps or dense int64
        [cap, 3] arrays indexed by this solver's registry."""
        for n in nodes:
            self.registry.intern(n.name)
        pad = pad_bucket(self.registry.capacity, 8)
        return build_cluster_tensors(
            list(nodes),
            usage,
            overhead,
            self.registry,
            driver_label_priority=self._driver_label_priority,
            executor_label_priority=self._executor_label_priority,
            pad_to=pad,
            device=self.device,
        )

    def candidate_mask(self, tensors, node_names: Sequence[str]) -> np.ndarray:
        """[N] bool host mask of the named nodes (read-only, memoized)."""
        n = tensors.num_nodes
        names = tuple(node_names)
        epoch = self.registry.epoch
        key = (n, epoch, names)
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

    def pack_window_dispatch(
        self,
        strategy: str,
        tensors: ClusterTensors,
        requests: Sequence[WindowRequest],
    ) -> WindowHandle:
        """Build the segmented window and launch the solve without waiting
        for its result. Returns a handle for pack_window_fetch."""
        if strategy not in BINPACK_STRATEGIES:
            raise ValueError(f"strategy {strategy!r} is not batchable")
        if tensors.device != self.device:
            raise ValueError(
                f"tensors live on {tensors.device}, solver on {self.device}"
            )
        if not requests:
            return WindowHandle(
                strategy=strategy, blob=None, requests=(), host_avail=None,
                host_schedulable=None,
            )
        batch = self.window_batch(tensors, requests)
        if self.device.type == "cuda" and not self._probed:
            probe(self.device)
            self._probed = True
        path = "cuda" if self.device.type == "cuda" else "reference"
        meta, execs, _base_after = window_pack(
            tensors, batch.win, fill=strategy, emax=batch.emax,
            num_zones=batch.num_zones,
        )
        blob = torch.cat([meta[:, :, :3], execs], dim=2)
        self.window_path_counts[path] = (
            self.window_path_counts.get(path, 0) + 1
        )
        host = host_view(tensors)
        handle = WindowHandle(
            strategy=strategy,
            blob=blob,
            requests=tuple(requests),
            host_avail=np.array(host.available, dtype=np.int64),
            host_schedulable=np.asarray(host.schedulable),
        )
        # int64 so the fetch-side subtractions against the int64 base
        # never wrap.
        handle.row_driver_req = batch.driver_req.astype(np.int64)
        handle.row_exec_req = batch.exec_req.astype(np.int64)
        handle.row_skippable = batch.skippable
        handle.seg_map = batch.seg_map
        return handle

    def pack_window_fetch(self, handle: WindowHandle) -> list[WindowDecision]:
        """Wait for a dispatched window's decisions and reconstruct the
        per-request outcomes (the second half of pack_window)."""
        if not handle.requests:
            return []
        blob = handle.blob.cpu().numpy()[handle.seg_map[0], handle.seg_map[1]]
        drivers = blob[:, 0]
        admitted = blob[:, 1].astype(bool)
        packed = blob[:, 2].astype(bool)
        execs = blob[:, 3:]
        return self._reconstruct_requests(
            handle.requests, drivers, admitted, packed, execs,
            handle.row_driver_req, handle.row_exec_req,
            handle.row_skippable, handle.host_avail.copy(),
            handle.host_schedulable,
        )

    def _reconstruct_requests(
        self, requests, drivers, admitted, packed, execs,
        drv64, exc64, skip, base, host_schedulable,
    ) -> list[WindowDecision]:
        """Host-side reconstruction for per-request packing efficiency: the
        availability each admitted request's final pack saw = the host view
        at dispatch, minus committed placements of earlier segments, minus
        in-segment admitted hypothetical placements. Mutates `base`."""
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
                ev = execs[real]
                ev = ev[ev >= 0]
                if ev.size:
                    np.subtract.at(base, ev, exc64[real])
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
