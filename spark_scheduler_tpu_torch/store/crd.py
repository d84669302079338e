"""CRD lifecycle: ensure-on-startup and lazy establishment watching.

Rebuilds internal/crd/utils.go:32-151 and internal/crd/demand_informer.go:
the scheduler owns the ResourceReservation CRD (creates or upgrades it at
startup, verifies it becomes Established, deletes a failed create), while
the Demand CRD belongs to the external autoscaler — the scheduler only
*polls* for it (1/min) and lazily enables demand features when it appears.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from spark_scheduler_tpu_torch.store.backend import RESERVATION_CRD

ESTABLISH_POLL_INTERVAL_S = 0.05
ESTABLISH_TIMEOUT_S = 10.0  # crd/utils.go poll-verify window
DEMAND_CRD_POLL_INTERVAL_S = 60.0  # demand_informer.go:75-97 (1/min)


class CRDError(Exception):
    pass


def check_crd_exists(backend, name: str) -> bool:
    """Established-condition check (crd/utils.go:32-55)."""
    return backend.crd_exists(name)


def ensure_resource_reservations_crd(
    backend,
    name: str = RESERVATION_CRD,
    timeout_s: float = ESTABLISH_TIMEOUT_S,
    clock=time.monotonic,
    sleep=time.sleep,
    webhook_url: str | None = None,
    ca_bundle: str | None = None,
) -> None:
    """Create-or-upgrade the reservation CRD — the FULL manifest with
    openAPI schemas, served/storage versions and (when `webhook_url` is
    given) the webhook conversion strategy — then poll until it reports
    Established; on verification failure delete the half-created CRD and
    raise, so a restart retries cleanly (crd/utils.go:98-151,
    crd_resource_reservation.go:83-115)."""
    from spark_scheduler_tpu_torch.models.crds import resource_reservation_crd

    definition = resource_reservation_crd(webhook_url=webhook_url, ca_bundle=ca_bundle)
    # Upsert even when the CRD already exists: the reference's ensure path
    # *updates* an existing CRD to the current definition (version upgrade).
    backend.register_crd(name, definition)
    deadline = clock() + timeout_s
    while not backend.crd_exists(name):
        if clock() > deadline:
            try:
                backend.unregister_crd(name)
            except Exception:
                pass
            raise CRDError(f"CRD {name} did not become established in {timeout_s}s")
        sleep(ESTABLISH_POLL_INTERVAL_S)


class LazyDemandCRDWatcher:
    """Poll for the Demand CRD until it exists, then fire ready callbacks
    once (internal/crd/demand_informer.go:75-138). The SafeDemandCache keeps
    gating every operation on crd_exists(); this watcher is the push-style
    complement that lets components (demand GC, waste reporter wiring)
    initialize as soon as demands become available."""

    def __init__(
        self,
        backend,
        crd_name: str,
        poll_interval_s: float = DEMAND_CRD_POLL_INTERVAL_S,
    ):
        self._backend = backend
        self._crd_name = crd_name
        self._poll_interval_s = poll_interval_s
        self._ready = threading.Event()
        self._callbacks: list[Callable[[], None]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def on_ready(self, callback: Callable[[], None]) -> None:
        """Register a callback; fires immediately if already ready."""
        fire = False
        with self._lock:
            if self._ready.is_set():
                fire = True
            else:
                self._callbacks.append(callback)
        if fire:
            callback()

    def ready(self) -> bool:
        return self._ready.is_set()

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        return self._ready.wait(timeout)

    def check_now(self) -> bool:
        """One poll step (also the test hook): fire callbacks on first hit."""
        if self._ready.is_set():
            return True
        if not self._backend.crd_exists(self._crd_name):
            return False
        with self._lock:
            if self._ready.is_set():
                return True
            callbacks, self._callbacks = self._callbacks, []
            self._ready.set()
        for cb in callbacks:
            cb()
        return True

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.is_set():
                if self.check_now():
                    return
                self._stop.wait(self._poll_interval_s)

        self._thread = threading.Thread(
            target=loop, daemon=True, name="lazy-demand-crd"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
