"""The window-solve device pool: slots, their resident state, quarantine.

The port of spark_scheduler_tpu/core/solver.py's `_DaemonFetchPool`,
`_PoolSlot`, `_DevicePool`, `_PendingBase` and `_WindowPart`. A slot is a
device plus, on a card, a CUDA stream of its own: several slots may share
one card (`PlacementSolver(pool_devices=[...])`), and then their solves
overlap on the card's streams. Slot choice never changes a decision: every
slot serves the same statics, and a slot re-solves from the same inputs.

A MESH slot (`solver.mesh.node-shards` > 1) is a ("nodes",) SolverMesh
(parallel/mesh.py): its statics live as S node chunks, one a shard, each
shard with a stream of its own beside the slot's; it solves whole windows
on the node-sharded engine (parallel/node_shards.py), and a device fault
on any of its shards quarantines the whole slot.

Stream rules (core/solver.py keeps them): work for a slot is queued on its
stream behind an event of the stream that produced its inputs, and every
tensor one stream allocated and another reads is `record_stream`ed there,
so the caching allocator never hands its memory out while a kernel still
reads it.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from spark_scheduler_tpu_torch.faults.errors import AllSlotsQuarantinedError
from spark_scheduler_tpu_torch.models.cluster import FIELD_DTYPES, cluster_statics
from spark_scheduler_tpu_torch.parallel.node_shards import shard_fields


class _DaemonFetchPool:
    """Minimal worker pool with DAEMON threads: a solve stuck on a dead
    device must never block interpreter exit, which ThreadPoolExecutor's
    non-daemon workers (joined by its atexit hook) would. Futures are
    concurrent.futures.Future.

    ONE pool is shared by every solver in the process
    (`shared_solve_pool`): workers run stateless solves, and a pool per
    solver would leak daemon threads wherever solvers are built without a
    paired close()."""

    def __init__(self, workers: int = 4, name: str = "window-solve"):
        import queue as _queue

        self._q: "_queue.Queue" = _queue.Queue()
        self._name = name
        self._threads: list = []
        for _ in range(workers):
            self._spawn_worker()

    def _spawn_worker(self) -> None:
        t = threading.Thread(
            target=self._run, daemon=True,
            name=f"{self._name}-{len(self._threads)}",
        )
        t.start()
        self._threads.append(t)

    def ensure_workers(self, n: int) -> None:
        """Grow the pool to at least `n` workers (never shrinks: idle
        threads park on the queue)."""
        while len(self._threads) < n:
            self._spawn_worker()

    def _run(self) -> None:
        while True:
            fut, fn = self._q.get()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as exc:  # delivered via future.result()
                fut.set_exception(exc)
                if isinstance(exc, KeyboardInterrupt):
                    import _thread

                    _thread.interrupt_main()

    def submit(self, fn, *args):
        from concurrent.futures import Future

        fut: Future = Future()
        self._q.put((fut, lambda: fn(*args)))
        return fut


_solve_pool: "_DaemonFetchPool | None" = None
_solve_pool_lock = threading.Lock()


def shared_solve_pool(min_workers: int = 2) -> _DaemonFetchPool:
    """The process-wide worker pool of the pooled window solves, grown to
    `min_workers` (the solver asks for two per slot, at most 8: a slot can
    solve one window while the next one's inputs are staged)."""
    global _solve_pool
    with _solve_pool_lock:
        if _solve_pool is None:
            _solve_pool = _DaemonFetchPool(workers=max(1, min_workers))
        else:
            _solve_pool.ensure_workers(min_workers)
        return _solve_pool


class PoolSlot:
    """One slot of the window-solve pool: a device, its stream on a card,
    the slot's resident STATIC replica (and gathered sub-replicas per
    partition domain), upload stats, in-flight count and quarantine
    state."""

    __slots__ = (
        "device", "label", "stream", "mesh", "shard_streams",
        "statics", "statics_epoch",
        "sub_statics", "uploads", "last_full_upload", "inflight",
        "quarantined", "last_probe", "failure_count",
        "mirror", "avail", "avail_epoch", "avail_token",
    )

    def __init__(self, placement, label: str):
        # A mesh slot's `device` is its lead shard's: the decision blob and
        # the committed base land there.
        self.mesh = placement if hasattr(placement, "grid") else None
        device = self.mesh.devices[0] if self.mesh is not None else placement
        self.device = device
        self.label = label
        self.stream = (
            torch.cuda.Stream(device=device) if device.type == "cuda" else None
        )
        self.shard_streams = None
        if self.mesh is not None and device.type == "cuda":
            self.shard_streams = [
                torch.cuda.Stream(device=d) for d in self.mesh.devices
            ]
        self.statics = None  # resident static-field tuple (full cluster)
        self.statics_epoch = -1
        # idx_key -> (epoch, statics tuple) for gathered partition domains.
        self.sub_statics: dict = {}
        # "full" (statics uploaded), "delta" (a lagging replica caught up
        # by scattering the statics journal's rows), "reuse" (resident).
        self.uploads = {"full": 0, "delta": 0, "reuse": 0}
        self.last_full_upload = 0.0
        self.inflight = 0
        # A quarantined slot takes no new dispatches until a periodic
        # probe launch succeeds on it.
        self.quarantined = False
        self.last_probe = 0.0
        self.failure_count = 0
        # How whole-window solves reached the committed base: "reuse" (the
        # base lives on this slot's device, or the slot's replica was
        # current), "catchup" (the replica scattered the journaled rows it
        # missed; "delta_rows" counts them) or "dense" (the whole base
        # copied over from the solver's device).
        self.mirror = {"dense": 0, "reuse": 0, "catchup": 0, "delta_rows": 0}
        # The slot's availability replica when it lies on another device
        # than the solver's base: valid within the pipeline generation
        # `avail_token`, as of the pipeline's availability epoch
        # `avail_epoch` (core/solver.py `_pool_full_base`).
        self.avail = None
        self.avail_epoch = -1
        self.avail_token = None

    @property
    def is_mesh(self) -> bool:
        return self.mesh is not None

    @property
    def shard_devices(self) -> list:
        """The devices the slot's work runs on (one, or every shard's)."""
        return self.mesh.devices if self.mesh is not None else [self.device]

    def context(self):
        """The slot's stream as the calling thread's current stream (a
        no-op on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def put(self, arr, dtype=None) -> torch.Tensor:
        """A host array copied onto the slot's device (never aliased)."""
        return torch.tensor(np.asarray(arr), dtype=dtype, device=self.device)

    def upload_statics(self, fields) -> tuple:
        """Static fields (cluster_statics order) uploaded to the slot; on
        a mesh slot, one tuple of node chunks a shard."""
        if self.mesh is not None:
            return shard_fields(self.mesh.devices, [
                torch.tensor(np.asarray(f), dtype=dt)
                for f, dt in zip(fields, FIELD_DTYPES[1:])
            ])
        return tuple(
            self.put(f, dt) for f, dt in zip(fields, FIELD_DTYPES[1:])
        )

    def resident_statics(self, host, epoch, clock, telemetry, journal=None):
        """The slot's resident full-cluster static replica.

        Epoch current: serve the resident copy. Epoch behind with every
        missed epoch in `journal` (the solver's statics-delta journal):
        scatter just the union of changed rows. Anything else (first
        touch, a shape change, an evicted journal epoch, a full upload
        having cleared the journal) uploads the full statics."""
        if self.statics is not None and self.statics_epoch == epoch:
            self.uploads["reuse"] += 1
            if telemetry is not None:
                telemetry.on_device_upload(self.label, "reuse", 0)
            return self.statics
        statics_np = cluster_statics(host)
        if (
            self.mesh is None  # a mesh slot re-uploads its chunks in full
            and self.statics is not None
            and journal
            and 0 <= self.statics_epoch < epoch
            and self.statics[0].shape[0] == np.asarray(statics_np[0]).shape[0]
            and all(
                e in journal for e in range(self.statics_epoch + 1, epoch + 1)
            )
        ):
            rows = np.unique(
                np.concatenate(
                    [journal[e] for e in range(self.statics_epoch + 1, epoch + 1)]
                )
            )
            idx_dev = self.put(rows.astype(np.int64))
            nbytes = rows.astype(np.int64).nbytes
            updated = []
            for dev_f, host_f in zip(self.statics, statics_np):
                vals = np.asarray(host_f)[rows]
                nbytes += vals.nbytes
                # Out of place: a solve still reading the old replica on
                # this slot's stream keeps it.
                updated.append(
                    dev_f.index_copy(0, idx_dev, self.put(vals, dev_f.dtype))
                )
            self.statics = tuple(updated)
            self.statics_epoch = epoch
            self.uploads["delta"] += 1
            if telemetry is not None:
                telemetry.on_device_upload(self.label, "delta", nbytes)
            return self.statics
        self.statics = self.upload_statics(statics_np)
        self.statics_epoch = epoch
        self.uploads["full"] += 1
        self.last_full_upload = clock()
        if telemetry is not None:
            nbytes = sum(np.asarray(f).nbytes for f in statics_np)
            telemetry.on_device_upload(self.label, "full", nbytes)
        return self.statics

    def sub_replica(self, host, idx_key, idx, epoch, clock, telemetry):
        """Gathered static sub-cluster for a partition domain, cached per
        (domain, statics epoch). `idx` is the host-side index array."""
        cached = self.sub_statics.get(idx_key)
        if cached is not None and cached[0] == epoch:
            self.uploads["reuse"] += 1
            if telemetry is not None:
                telemetry.on_device_upload(self.label, "reuse", 0)
            return cached[1]
        fields = [np.asarray(f)[idx] for f in cluster_statics(host)]
        statics = self.upload_statics(fields)
        if len(self.sub_statics) >= 64:
            self.sub_statics.clear()
        self.sub_statics[idx_key] = (epoch, statics)
        self.uploads["full"] += 1
        self.last_full_upload = clock()
        if telemetry is not None:
            telemetry.on_device_upload(
                self.label, "full", sum(f.nbytes for f in fields)
            )
        return statics

    def release(self) -> None:
        """Drop every resident device buffer (close()/discard_pipeline()/
        quarantine). In-flight accounting resets too: a release goes with
        dropping the pipeline, and a discarded window's parts are never
        fetched."""
        self.statics = None
        self.statics_epoch = -1
        self.sub_statics.clear()
        self.avail = None
        self.avail_epoch = -1
        self.avail_token = None
        self.inflight = 0


def slot_labels(devices) -> list[str]:
    """One label per slot: the device's name (a mesh slot's `cuda:0-3`),
    with `/k` appended when several slots share it (k counts from 0)."""
    names = [getattr(d, "label", None) or str(d) for d in devices]
    seen: dict = {}
    out = []
    for name in names:
        k = seen.get(name, 0)
        seen[name] = k + 1
        out.append(name if names.count(name) == 1 else f"{name}/{k}")
    return out


class DevicePool:
    """Slot allocator of the window-solve pool: least-loaded HEALTHY slot
    first, round-robin tiebreak, so a fresh window stages on an idle slot
    while busy slots keep solving. Slot choice never affects decisions."""

    def __init__(self, devices):
        self.slots = [
            PoolSlot(d, label) for d, label in zip(devices, slot_labels(devices))
        ]
        self._next = 0

    def next_slot(self) -> PoolSlot:
        """Least-loaded healthy slot; raises AllSlotsQuarantinedError when
        none is left (the degraded-mode trigger)."""
        n = len(self.slots)
        best, best_i = None, 0
        for off in range(n):
            i = (self._next + off) % n
            s = self.slots[i]
            if s.quarantined:
                continue
            if best is None or s.inflight < best.inflight:
                best, best_i = s, i
                if s.inflight == 0:
                    break
        if best is None:
            raise AllSlotsQuarantinedError(f"all {n} device slot(s) quarantined")
        self._next = (best_i + 1) % n
        return best

    def healthy_slots(self) -> list:
        return [s for s in self.slots if not s.quarantined]

    def quarantined_slots(self) -> list:
        return [s for s in self.slots if s.quarantined]

    def quarantine(self, slot: PoolSlot, now: float) -> None:
        """Take the slot out of rotation and drop its resident buffers:
        the device is suspect, so its replicas are unreachable state."""
        slot.quarantined = True
        slot.last_probe = now
        slot.failure_count += 1
        slot.release()

    def reinstate(self, slot: PoolSlot) -> None:
        """The probe succeeded: back into rotation (statics re-upload on
        the slot's next dispatch)."""
        slot.quarantined = False

    def occupancy(self) -> float:
        """Fraction of slots with at least one in-flight solve."""
        busy = sum(1 for s in self.slots if s.inflight > 0)
        return busy / max(1, len(self.slots))

    def health(self) -> dict:
        q = [s.label for s in self.slots if s.quarantined]
        return {
            "slots": len(self.slots),
            "healthy": len(self.slots) - len(q),
            "quarantined": q,
        }

    def release(self) -> None:
        for s in self.slots:
            s.release()

    def stats(self) -> dict:
        return {
            s.label: {
                **s.uploads,
                "inflight": s.inflight,
                "quarantined": s.quarantined,
                "failures": s.failure_count,
                "mirror": dict(s.mirror),
            }
            for s in self.slots
        }


class PendingBase:
    """A pooled window's committed-base combine, deferred until the next
    pipelined build resolves it ON THE BUILD THREAD (a combine run as a
    worker task could park pool workers waiting on other pool tasks).
    Duck-typed to Future.result()."""

    __slots__ = ("_fn", "_done", "_val", "_exc")

    def __init__(self, fn):
        self._fn = fn
        self._done = False
        self._val = None
        self._exc = None

    def result(self):
        if not self._done:
            try:
                self._val = self._fn()
            except Exception as exc:  # surfaced by the build's resolve
                self._exc = exc
            self._done = True
            self._fn = None
        if self._exc is not None:
            raise self._exc
        return self._val


class WindowPart:
    """One partition of a pooled window: its requests (`req_ids`, their
    positions in the window) and row arrays, the worker future resolving
    to the pulled blob and timings, the EARLY future carrying the
    committed sub-base (set when the solve is queued, before the blob
    pull), the node index map of a gathered sub-cluster (None = the whole
    cluster), and what a re-dispatch on a surviving slot needs."""

    __slots__ = (
        "future", "after_future", "req_ids", "requests", "rows", "batch",
        "idx", "idx_key", "slot", "prune", "base_kept",
    )

    def __init__(self, *, future, after_future, req_ids, requests, rows,
                 batch, idx, idx_key, slot, prune=None, base_kept=None):
        self.future = future
        self.after_future = after_future
        self.req_ids = req_ids
        self.requests = requests
        # The part's _WindowRows (flat row arrays, [N] masks per request)
        # and its segmented layout (masks over `idx` for a gathered part).
        self.rows = rows
        self.batch = batch
        self.idx = idx  # np int64 global node indices, None = full cluster
        self.idx_key = idx_key
        self.slot = slot
        # PrunePlan when the part solved a pruned top-K gather of its
        # domain: its after_future then carries a DELTA over the kept rows.
        self.prune = prune
        # [len(idx), 3] int64 host availability of the part's rows at
        # dispatch (gathered parts only).
        self.base_kept = base_kept
