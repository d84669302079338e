"""Fleet-fused dispatch — F clusters' windows, ONE stacked solve.

The port's copy of spark_scheduler_tpu/fleet/dispatch.py. The
FleetDispatchCoordinator is the deferred-dispatch lane
(`solver._dispatch_lane`) of every cluster stack's solver when
`fleet.stack-window-ms` > 0:

  * Each cluster's worker thread, on a pipelined plain window dispatch,
    DEFERS its window here instead of solving it (the handle's
    `blob_future` and the pipeline's PendingBase are the lane contract
    shared with replay/sweep.py).
  * The deferring thread then waits a short GATHER window
    (`fleet.stack-window-ms`) for the other live clusters' windows to
    arrive. Whoever completes the set (or times out first) claims
    everything pending and flushes.
  * A flush groups windows by SHAPE BUCKET — `(bucket_n, emax, zones,
    mask signature)`. Members need compatible padded shapes only: app rows
    re-pad up to the group max (`ops/batched.pad_app_batch`). Each group
    solves as ONE `ops/batched.bucket_stacked_fifo_pack` call with one
    host copy, and per-member blobs and bases scatter back to each
    cluster's handle.
  * Singleton groups and timed-out stragglers fall back to the cluster's
    own plain solve — counted, never blocking. A killed cluster's parked
    window is expelled the same way (`forced_resolves`).

As in the JAX package, only a window that does not take the kernel route
defers. On the card the row-walk kernel serves every window of all six
strategies (the Pallas kernel's role on a TPU), so a `cuda` fleet never
defers and every cluster window launches the row walk; the stacked plain
solve is the CPU route.

Byte-identity per cluster holds by construction (each member sees only
its own cluster's availability, statics and masks) and is re-asserted by
`verify_cluster_equivalence`, whose standalone replay runs unstacked.

Row-bucket policy: deferred windows bucket app rows at quantum 8; windows
that do NOT defer (stacking off, fewer than 2 live clusters, pruned or
pooled windows, the card) keep the serving layout untouched.
"""

from __future__ import annotations

import threading
import time

import torch

from spark_scheduler_tpu_torch.core.device_pool import PendingBase

# How long a claimed-but-unresolved waiter sleeps between wake-up checks
# (its group is being solved by another cluster's thread; the solve ends
# with a notify_all, so this is only a lost-wakeup backstop).
_CLAIMED_POLL_S = 0.05


class _FleetBlobFuture:
    """Future protocol (`result`/`done`/`cancel`) for a deferred fleet
    window blob. Unlike the sweep's future — resolved by the lockstep
    driver's explicit flush — `result()` IS the gather: the owning
    cluster thread parks here until its group flushes (by count, by its
    deadline, or by drain/expel), and flushes it itself if it is the one
    that completes the set or times out first."""

    __slots__ = ("_coord", "payload", "_value", "_exc", "_done")

    def __init__(self, coord):
        self._coord = coord
        self.payload = None
        self._value = None
        self._exc = None
        self._done = False

    def _set(self, value) -> None:
        self._value = value
        self._done = True

    def _set_exception(self, exc) -> None:
        self._exc = exc
        self._done = True

    def result(self, timeout=None):
        if not self._done:
            self._coord._gather_and_flush(self.payload)
        if self._exc is not None:
            raise self._exc
        return self._value

    def done(self) -> bool:
        return self._done

    def cancel(self) -> bool:
        return False


class _Payload:
    """One cluster's deferred window: everything a flush needs to solve
    it (stacked or singly) and patch that cluster's pipeline."""

    __slots__ = (
        "solver", "apps", "avail", "statics", "fill", "emax",
        "num_zones", "future", "deferred_at", "deadline",
        "claimed", "avail_after",
    )

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)
        self.claimed = False
        self.avail_after = None

    def bucket_key(self):
        """Windows stack iff their PADDED shapes are compatible: same
        bucketed node axis, same executor-slot padding, same zone bound,
        and the same optional-mask signature (serving windows always
        carry all masks; the signature guards hypothetical callers).
        App-row counts may differ — the flush re-pads to the group max."""
        return (
            int(self.avail.shape[0]),
            self.emax,
            self.num_zones,
            tuple(f is not None for f in self.apps),
        )


class FleetDispatchCoordinator:
    """The fleet's deferred-dispatch lane (`solver._dispatch_lane` on
    every cluster stack when `fleet.stack-window-ms` > 0).

    Threading model: each cluster's single worker thread defers at most
    one window at a time (serving is dispatch-then-fetch per predicate),
    then blocks in `result()` until its window resolves. All bookkeeping
    runs under one condition variable; device work (the stacked solve or
    a fallback single) runs OUTSIDE the lock on whichever cluster thread
    claimed the batch, while the other owners wait — exactly one solve
    in flight per claimed batch. An owner's pipeline base is a PendingBase
    its own next build resolves, on its own thread, so no pipeline is
    ever raced."""

    # Lane protocol: deferred windows bucket app rows like sweep lanes
    # (see module docstring); non-deferred serving windows keep 32.
    row_bucket_quantum = 8

    def __init__(
        self,
        window_ms: float,
        expected: int,
        *,
        telemetry=None,
        clock=time.monotonic,
    ):
        self.window_s = max(0.0, float(window_ms)) / 1e3
        self.telemetry = telemetry
        self._clock = clock
        self._cond = threading.Condition()
        self._pending: list[_Payload] = []
        self._expected = max(1, int(expected))
        self._draining = False
        self.stats = {
            "stacked_dispatches": 0,
            "stack_arms": 0,
            "fallbacks": 0,  # singleton groups + straggler timeouts
            "forced_resolves": 0,  # expel / early fetch / stale overwrite
            "flushes": 0,
            "deferred": 0,
            "gather_wait_ms": 0.0,
        }

    # -- lane protocol (called from PlacementSolver.pack_window_dispatch) ----

    def accepts(self, solver) -> bool:
        """Defer only when a stacking partner can exist: at least two
        clusters live and not draining. Declined windows take the normal
        serving path untouched (immediate solve)."""
        with self._cond:
            return self._expected >= 2 and not self._draining

    def defer_window(
        self, solver, apps, *, avail, statics, host, fill, emax, num_zones
    ):
        fut = _FleetBlobFuture(self)
        now = self._clock()
        payload = _Payload(
            solver=solver, apps=apps, avail=avail, statics=statics,
            fill=fill, emax=emax, num_zones=num_zones,
            future=fut,
            deferred_at=now, deadline=now + self.window_s,
        )
        fut.payload = payload
        stale = None
        with self._cond:
            # Defensive: serving is synchronous dispatch-then-fetch, so a
            # solver can never have two windows parked — but if a future
            # async path ever dispatches ahead, resolve the old window
            # singly rather than stacking two windows of one pipeline.
            for pl in self._pending:
                if pl.solver is solver:
                    stale = pl
                    break
            if stale is not None:
                self._pending.remove(stale)
                stale.claimed = True
            self._pending.append(payload)
            self.stats["deferred"] += 1
            self._cond.notify_all()
        if stale is not None:
            self._resolve_forced(stale)
        return fut, PendingBase(lambda: self._base_after(payload))

    def _base_after(self, payload: _Payload):
        """The owner's committed base after its deferred window: resolved
        by the owner's next pipelined build, on the owner's thread."""
        payload.future.result()
        return payload.avail_after

    # -- gather --------------------------------------------------------------

    def _gather_and_flush(self, payload: _Payload) -> None:
        """Park the owning cluster thread until `payload` resolves; claim
        and flush the pending set when this thread completes it, hits its
        own deadline, or the coordinator is draining."""
        fut = payload.future
        batch = None
        timed_out = False
        with self._cond:
            while True:
                if fut._done:
                    return
                if payload.claimed:
                    # Another cluster's thread is solving our group right
                    # now; its notify_all wakes us.
                    self._cond.wait(timeout=_CLAIMED_POLL_S)
                    continue
                now = self._clock()
                full = len(self._pending) >= self._expected
                timed_out = now >= payload.deadline
                if full or timed_out or self._draining:
                    batch = [pl for pl in self._pending if not pl.claimed]
                    for pl in batch:
                        pl.claimed = True
                    self._pending = [
                        pl for pl in self._pending if pl not in batch
                    ]
                    break
                self._cond.wait(
                    timeout=max(1e-4, payload.deadline - now)
                )
        self._flush(batch, timed_out=timed_out and not full)

    # -- flush ---------------------------------------------------------------

    def _flush(self, batch: list[_Payload], *, timed_out: bool) -> None:
        now = self._clock()
        for pl in batch:
            wait_ms = max(0.0, now - pl.deferred_at) * 1e3
            self.stats["gather_wait_ms"] += wait_ms
            if self.telemetry is not None:
                self.telemetry.on_gather_wait(wait_ms)
        groups: dict = {}
        for pl in batch:
            groups.setdefault(pl.bucket_key(), []).append(pl)
        with self._cond:
            self.stats["flushes"] += 1
        for members in groups.values():
            if len(members) == 1:
                reason = "straggler-timeout" if timed_out else "singleton"
                with self._cond:
                    self.stats["fallbacks"] += 1
                if self.telemetry is not None:
                    self.telemetry.on_stack_fallback(reason)
                self._solve_guarded(self._solve_single, members)
            else:
                with self._cond:
                    self.stats["stacked_dispatches"] += 1
                    self.stats["stack_arms"] += len(members)
                if self.telemetry is not None:
                    self.telemetry.on_stacked_dispatch(len(members))
                self._solve_guarded(self._solve_stacked, members)

    def _solve_guarded(self, solve, members: list[_Payload]) -> None:
        """Run a solve, convert failures into per-member future
        exceptions (the fetch path's device-failure handling — pipeline
        drop + degraded policy — takes over in each owner), and ALWAYS
        wake the parked owners."""
        try:
            solve(members)
        except BaseException as exc:  # noqa: BLE001 - fanned out to owners
            for pl in members:
                if not pl.future._done:
                    pl.future._set_exception(exc)
        finally:
            with self._cond:
                self._cond.notify_all()

    def _solve_single(self, members: list[_Payload]) -> None:
        from spark_scheduler_tpu_torch.core.solver import _shim
        from spark_scheduler_tpu_torch.ops.batched import (
            _packing_blob,
            batched_fifo_pack_carry,
        )

        (payload,) = members
        # The round trip this window would have paid on the normal path.
        _shim("h2d")
        out = batched_fifo_pack_carry(
            payload.avail, payload.statics, payload.apps,
            fill=payload.fill, emax=payload.emax,
            num_zones=payload.num_zones,
        )
        payload.avail_after = out.available_after
        _shim("d2h")
        payload.future._set(_packing_blob(out).cpu().numpy())

    def _solve_stacked(self, members: list[_Payload]) -> None:
        from spark_scheduler_tpu_torch.core.solver import _shim
        from spark_scheduler_tpu_torch.ops.batched import (
            bucket_stacked_fifo_pack,
            pad_app_batch,
            stack_app_batches,
        )

        fills = tuple(pl.fill for pl in members)
        rows = max(pl.apps.driver_req.shape[0] for pl in members)
        apps = stack_app_batches(
            [pad_app_batch(pl.apps, rows) for pl in members]
        )
        # New stacks: no owner's base or statics are written.
        statics = tuple(
            torch.stack([pl.statics[i] for pl in members])
            for i in range(len(members[0].statics))
        )
        avail_stack = torch.stack([pl.avail for pl in members])
        lead = members[0]
        # ONE simulated round trip for the whole group.
        _shim("h2d")
        blob, avail_after = bucket_stacked_fifo_pack(
            avail_stack, statics, apps,
            fills=fills, emax=lead.emax, num_zones=lead.num_zones,
        )
        _shim("d2h")
        np_blob = blob.cpu().numpy()
        for i, pl in enumerate(members):
            pl.avail_after = avail_after[i]
            # Slice back to the member's own row bucket so the fetch
            # decodes exactly the unstacked blob shape.
            pl.future._set(np_blob[i, : pl.apps.driver_req.shape[0]])

    def _resolve_forced(self, payload: _Payload) -> None:
        with self._cond:
            self.stats["forced_resolves"] += 1
        if self.telemetry is not None:
            self.telemetry.on_stack_fallback("forced")
        self._solve_guarded(self._solve_single, [payload])

    # -- membership / lifecycle ---------------------------------------------

    def set_expected(self, live: int) -> None:
        """Track live-cluster count (kill/rejoin): gathers complete at
        the live count, and below 2 live the lane stops accepting."""
        with self._cond:
            self._expected = max(1, int(live))
            self._cond.notify_all()

    def expel(self, solver) -> None:
        """A cluster was killed: resolve its parked window NOW via the
        single-window fallback so its worker unblocks and the survivors'
        gather no longer waits on a dead peer."""
        with self._cond:
            victim = None
            for pl in self._pending:
                if pl.solver is solver:
                    victim = pl
                    break
            if victim is not None:
                self._pending.remove(victim)
                victim.claimed = True
        if victim is not None:
            self._resolve_forced(victim)

    def drain(self) -> None:
        """Shutdown: stop accepting, release every parked owner (each
        claims and flushes immediately on wake)."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    # -- introspection --------------------------------------------------------

    def describe(self) -> dict:
        with self._cond:
            out = dict(self.stats)
            out.update(
                enabled=True,
                window_ms=self.window_s * 1e3,
                expected=self._expected,
                pending=len(self._pending),
                draining=self._draining,
            )
            out["gather_wait_ms"] = round(out["gather_wait_ms"], 3)
        return out
