"""DegradedModeController — what the scheduler does when no device can
serve.

The reference has no analogue (its "device" is a Go for-loop); here a
deployment on GPUs can lose every pool slot at once (a device fault, a
driver reset) and a front-end with many users needs a defined answer:

  greedy  keep serving: the extender solves on the HOST via the host
          greedy oracle (core/greedy.py — slot-for-slot the kernels'
          semantics, just O(nodes) Python instead of one device program).
          Readiness stays 200 but reports degraded; throughput drops,
          correctness doesn't.
  shed    answer /predicates 503 with Retry-After (the kube-scheduler
          extender client retries); readiness flips 503 so load balancers
          drain the replica while probes keep watching it.

Either way /debug/state and the telemetry gauge reflect the state, and
the controller auto-clears as soon as a quarantined slot's probe
reinstates it.
"""

from __future__ import annotations

import threading
import time

DEGRADED_GREEDY = "greedy"
DEGRADED_SHED = "shed"

DEGRADED_POLICIES = (DEGRADED_GREEDY, DEGRADED_SHED)


class DegradedModeController:
    def __init__(
        self,
        policy: str = DEGRADED_GREEDY,
        retry_after_s: float = 5.0,
        clock=time.time,
        on_change=None,
    ):
        if policy not in DEGRADED_POLICIES:
            raise ValueError(
                f"degraded-mode policy {policy!r}: expected one of "
                f"{DEGRADED_POLICIES}"
            )
        self.policy = policy
        self.retry_after_s = retry_after_s
        self._clock = clock
        self._on_change = on_change  # fn(active: bool) — telemetry hook
        self._lock = threading.Lock()
        self.active = False
        self.reason = ""
        self.since = 0.0
        self.engagements = 0
        self.fallback_decisions = 0
        self.shed_requests = 0

    def engage(self, reason: str) -> None:
        with self._lock:
            if not self.active:
                self.active = True
                self.since = self._clock()
                self.engagements += 1
                changed = True
            else:
                changed = False
            self.reason = reason
        if changed and self._on_change is not None:
            self._on_change(True)

    def clear(self) -> None:
        with self._lock:
            changed = self.active
            self.active = False
            self.reason = ""
        if changed and self._on_change is not None:
            self._on_change(False)

    def on_fallback_decision(self, n: int = 1) -> None:
        with self._lock:
            self.fallback_decisions += n

    def on_shed(self, n: int = 1) -> None:
        with self._lock:
            self.shed_requests += n

    @property
    def sheds(self) -> bool:
        return self.policy == DEGRADED_SHED

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "policy": self.policy,
                "active": self.active,
                "reason": self.reason,
                "since": self.since if self.active else None,
                "engagements": self.engagements,
                "fallback_decisions": self.fallback_decisions,
                "shed_requests": self.shed_requests,
                "retry_after_s": self.retry_after_s,
            }
