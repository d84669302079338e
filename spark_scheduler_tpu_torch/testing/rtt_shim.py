"""Simulated-RTT device shim.

On the CPU every device boundary is microseconds, so the properties that
pay off where a device round trip is long (a fused K-window dispatch pays
one round trip for K windows; pooled slots overlap their launches) are
invisible. This shim makes them measurable without hardware: installed
into the solver's device hook (core/solver.set_device_shim), it sleeps a
configurable share of the round trip at each boundary, on the thread that
would pay it:

  "h2d"      the dispatcher thread, once per device DISPATCH (window-batch
             upload + kernel launch). This is the serialized cost a fused
             K-window batch pays once where K sequential dispatches pay it
             K times.
  "dispatch" a pool worker thread, once per pooled slot launch (overlaps
             across slots).
  "d2h"      the thread paying a decision-blob pull (concurrent pulls
             overlap).

Default split: h2d and d2h each take rtt_ms/2, dispatch takes 0 — one
unfused window costs one full round trip; a fused K-window dispatch costs
one round trip for all K. Event counts are recorded per kind, so tests
assert the amortization structurally (fused serving of K windows fires
ONE h2d and ONE d2h) rather than by wall clock.

`tunnel_serialized=True` models a SHARED device link: every boundary's
sleep holds one lock, so concurrent transfers from different threads
queue behind each other instead of overlapping. Default False: independent
transfers overlap.
"""

from __future__ import annotations

import threading
import time


class SimulatedRTT:
    """Context-manager shim: `with SimulatedRTT(50.0) as rtt: ...` serves
    every window inside the block against a simulated 50 ms device round
    trip; `rtt.counts` holds the per-boundary event counts."""

    def __init__(
        self,
        rtt_ms: float = 50.0,
        *,
        h2d_ms: float | None = None,
        dispatch_ms: float = 0.0,
        d2h_ms: float | None = None,
        tunnel_serialized: bool = False,
    ):
        half = rtt_ms / 2.0
        self.rtt_ms = rtt_ms
        self.h2d_ms = half if h2d_ms is None else h2d_ms
        self.dispatch_ms = dispatch_ms
        self.d2h_ms = half if d2h_ms is None else d2h_ms
        self.tunnel_serialized = tunnel_serialized
        self.counts = {"h2d": 0, "dispatch": 0, "d2h": 0}
        self._lock = threading.Lock()
        self._tunnel = threading.Lock()
        self._prior = None
        self._installed = False

    def __call__(self, kind: str) -> None:
        with self._lock:
            if kind in self.counts:
                self.counts[kind] += 1
        ms = {
            "h2d": self.h2d_ms,
            "dispatch": self.dispatch_ms,
            "d2h": self.d2h_ms,
        }.get(kind, 0.0)
        if ms > 0:
            if self.tunnel_serialized:
                # One shared link: this transfer occupies the tunnel for
                # its full duration, queueing concurrent boundaries.
                with self._tunnel:
                    time.sleep(ms / 1e3)
            else:
                time.sleep(ms / 1e3)

    def reset_counts(self) -> None:
        with self._lock:
            for k in self.counts:
                self.counts[k] = 0

    def install(self) -> "SimulatedRTT":
        from spark_scheduler_tpu_torch.core import solver as _solver

        if self._installed:
            return self
        self._prior = _solver._DEVICE_SHIM
        _solver.set_device_shim(self)
        self._installed = True
        return self

    def uninstall(self) -> None:
        from spark_scheduler_tpu_torch.core import solver as _solver

        if not self._installed:
            return
        _solver.set_device_shim(self._prior)
        self._prior = None
        self._installed = False

    def __enter__(self) -> "SimulatedRTT":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
