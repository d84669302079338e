"""FencedBackend — the fenced commit path.

A replica's SchedulerApp is built over this proxy instead of the shared
backend: every mutation of a FENCED kind (reservations, demands — the
durable scheduling decisions) first validates the replica's fencing gate,
raising `FencingError` when the replica is no longer entitled to write.
Reservation writes are async and fire-and-forget in the reference
(failover.go:35-41), so a deposed leader can have commits in flight at the
moment a standby takes over; without the fence those commits land AFTER
the new leader reconciled and double-place gangs. With it they fail
internal, the client retries against the new leader, and the invariant
soak's zero-double-placement assertion holds through leader kills.

Reads and pod/node writes (observed cluster state, not scheduling
decisions) pass through unfenced — every replica must keep ingesting
watch state to stay warm.

The gate is a callable so the two HA modes share the proxy:
leader/standby passes `LeaseManager.check_fence` (epoch comparison
against the live lease); the active-active sharded group passes its
membership check (a removed member's writes fail).
"""

from __future__ import annotations

from typing import Any

FENCED_KINDS = frozenset({"resourcereservations", "demands"})


class FencedBackend:
    """Delegating proxy over a ClusterBackend. Only the generic mutation
    verbs are intercepted — reservation/demand traffic flows exclusively
    through the write-through caches, which call these verbs; pod/node
    conveniences (add_pod, bind_pod, ...) delegate untouched."""

    def __init__(self, inner, gate, on_reject=None):
        # Object.__setattr__ not needed: we define real attributes and
        # forward the rest via __getattr__.
        self._inner = inner
        self._gate = gate
        self._on_reject = on_reject

    def _check(self, kind: str) -> None:
        if kind in FENCED_KINDS:
            try:
                self._gate()
            except Exception:
                if self._on_reject is not None:
                    self._on_reject(kind)
                raise

    # -- fenced verbs ------------------------------------------------------

    def create(self, kind: str, obj: Any) -> Any:
        self._check(kind)
        return self._inner.create(kind, obj)

    def update(self, kind: str, obj: Any) -> Any:
        self._check(kind)
        return self._inner.update(kind, obj)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._check(kind)
        return self._inner.delete(kind, namespace, name)

    # -- delegation --------------------------------------------------------

    def __getattr__(self, name: str):
        return getattr(self._inner, name)

    @property
    def inner(self):
        """The shared (unfenced) backend — what the lease store and the
        replica group's shared fixtures write through."""
        return self._inner
