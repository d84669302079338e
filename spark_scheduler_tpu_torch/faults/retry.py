"""RetryPolicy + CircuitBreaker — the one retry ladder of the scheduler.

The reference's only retry knob is a bare count (`async-client-retry-count`,
config.go:72-77); every consumer here used either that count with zero
delay or a fixed sleep. RetryPolicy replaces both with the standard shape:
exponential backoff, FULL jitter (delay ~ U[0, min(cap, base*mult^n)] — the
AWS-architecture result that full jitter minimizes contention on a
recovering dependency), an optional per-attempt timeout, and an optional
overall deadline. CircuitBreaker adds the closed/open/half-open discipline
so a down dependency is probed, not hammered.

Both are clock-injectable and rng-injectable: the chaos-matrix soak runs
them deterministically, and the unit tests pin the exact backoff sequence
and jitter bounds.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Optional

from spark_scheduler_tpu_torch.faults.errors import (
    AttemptTimeoutError,
    BreakerOpenError,
    RetryDeadlineExceeded,
)


@dataclasses.dataclass
class RetryPolicy:
    """`max_attempts` counts TOTAL tries (1 = no retry); None = unbounded
    (loop-style consumers like the reflector, which retry forever with
    capped backoff). `jitter="full"` draws each delay uniformly from
    [0, backoff(attempt)]; "none" sleeps the deterministic backoff."""

    max_attempts: Optional[int] = 5
    base_delay_s: float = 0.1
    multiplier: float = 2.0
    max_delay_s: float = 30.0
    jitter: str = "full"
    attempt_timeout_s: Optional[float] = None
    deadline_s: Optional[float] = None

    def backoff(self, attempt: int) -> float:
        """Deterministic (pre-jitter) delay after the `attempt`-th failure
        (0-based): base * multiplier^attempt, capped at max_delay_s."""
        return min(
            self.max_delay_s,
            self.base_delay_s * (self.multiplier ** max(0, attempt)),
        )

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        cap = self.backoff(attempt)
        if self.jitter == "full":
            return (rng or random).uniform(0.0, cap)
        return cap

    def replace(self, **kw) -> "RetryPolicy":
        return dataclasses.replace(self, **kw)

    # -- execution ----------------------------------------------------------

    def call(
        self,
        fn: Callable,
        *,
        retry_on: tuple = (Exception,),
        breaker: "CircuitBreaker | None" = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        rng: random.Random | None = None,
        on_retry: Callable[[int, BaseException, float], None] | None = None,
    ):
        """Run `fn()` under this policy. Per-attempt timeout (when set)
        runs the attempt on a daemon thread and abandons it on timeout;
        the overall deadline aborts BETWEEN attempts (it never interrupts
        one) with RetryDeadlineExceeded chaining the last real error.
        `breaker`, when given, gates every attempt (BreakerOpenError when
        refused without a half-open probe slot) and is fed the outcome."""
        start = clock()
        attempt = 0
        while True:
            if breaker is not None and not breaker.allow():
                raise BreakerOpenError(breaker.name or "circuit open")
            try:
                if self.attempt_timeout_s is not None:
                    result = _run_with_timeout(fn, self.attempt_timeout_s)
                else:
                    result = fn()
            except retry_on as exc:
                if breaker is not None:
                    breaker.on_failure()
                attempt += 1
                out_of_attempts = (
                    self.max_attempts is not None
                    and attempt >= self.max_attempts
                )
                if out_of_attempts:
                    raise
                pause = self.delay(attempt - 1, rng)
                if self.deadline_s is not None and (
                    clock() - start + pause > self.deadline_s
                ):
                    raise RetryDeadlineExceeded(
                        f"retry deadline {self.deadline_s}s exceeded after "
                        f"{attempt} attempt(s)"
                    ) from exc
                if on_retry is not None:
                    on_retry(attempt, exc, pause)
                if pause > 0:
                    sleep(pause)
                continue
            if breaker is not None:
                breaker.on_success()
            return result


def _run_with_timeout(fn: Callable, timeout_s: float):
    """Run fn on a daemon thread, abandon it on timeout. The abandoned
    thread keeps running to completion (documented caveat — Python offers
    no safe cross-thread cancel); its result is discarded."""
    from concurrent.futures import Future, TimeoutError as _FutTimeout

    fut: Future = Future()

    def run():
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(fn())
        except BaseException as exc:
            fut.set_exception(exc)

    t = threading.Thread(target=run, daemon=True, name="retry-attempt")
    t.start()
    try:
        return fut.result(timeout=timeout_s)
    except _FutTimeout:
        raise AttemptTimeoutError(
            f"attempt exceeded {timeout_s}s (thread abandoned)"
        ) from None


CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """Classic three-state breaker. CLOSED counts consecutive failures;
    at `failure_threshold` it OPENS and refuses calls for
    `reset_timeout_s`; the first allow() after the window flips to
    HALF_OPEN and admits exactly one probe — success closes, failure
    re-opens (re-arming the window). Thread-safe; `on_transition(old,
    new)` is the telemetry hook."""

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Callable[[str, str], None] | None = None,
        name: str = "",
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_s = float(reset_timeout_s)
        self.name = name
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_out = False
        self.opens = 0  # lifetime open transitions (telemetry)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, new: str) -> None:
        old, self._state = self._state, new
        if new == OPEN:
            self.opens += 1
            self._opened_at = self._clock()
        if old != new and self._on_transition is not None:
            self._on_transition(old, new)

    def allow(self) -> bool:
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    self._transition(HALF_OPEN)
                    self._probe_out = True
                    return True
                return False
            # HALF_OPEN: one probe at a time.
            if not self._probe_out:
                self._probe_out = True
                return True
            return False

    def on_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_out = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def on_failure(self) -> None:
        with self._lock:
            self._probe_out = False
            if self._state == HALF_OPEN:
                self._transition(OPEN)
                return
            self._failures += 1
            if self._state == CLOSED and self._failures >= self.failure_threshold:
                self._transition(OPEN)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "state": self._state,
                "failures": self._failures,
                "opens": self.opens,
            }
