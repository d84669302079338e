"""Request-scoped tracing + safe-param structured logging (SURVEY.md §5.1).

The reference gets zipkin tracing with b3 propagation from witchcraft
middleware (vendor/github.com/palantir/witchcraft-go-tracing) and svc1log
structured logging with *safe params* (internal/logging.go:22-45,
lib pkg/logging/logging.go:23-55). This module provides both natively:

  - `Tracer`: thread-local span stacks; `span()` context manager; b3
    single+multi header extraction/injection (x-b3-traceid / x-b3-spanid /
    x-b3-sampled); finished spans land in a bounded ring buffer (pollable
    at GET /debug/traces) and optionally as JSON lines in a trace log.
  - `svc1log`: JSON-line service log with explicit safe-param dicts —
    `pod_safe_params`, `demand_safe_params`, `rr_safe_params` mirror the
    reference's safe-param helpers so log pipelines receive identical keys.

The port's copy of spark_scheduler_tpu/tracing.py without the JAX profiler
hooks (`start_jax_profile` / `stop_jax_profile`); their torch.profiler
counterpart comes with the server's /debug/profile route.
"""

from __future__ import annotations

import collections
import itertools
import json
import random
import secrets
import sys
import threading
import time
from typing import Any, Optional

_span_counter = itertools.count(1)


class Span:
    __slots__ = (
        "name",
        "trace_id",
        "span_id",
        "parent_id",
        "start",
        "end",
        "tags",
        "sampled",
    )

    def __init__(self, name, trace_id, span_id, parent_id, sampled=True):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = 0.0
        self.end = 0.0
        self.tags: dict[str, Any] = {}
        self.sampled = sampled

    @property
    def duration_ms(self) -> float:
        return (self.end - self.start) * 1e3

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "traceId": self.trace_id,
            "id": self.span_id,
            **({"parentId": self.parent_id} if self.parent_id else {}),
            "timestamp_s": self.start,
            "duration_ms": round(self.duration_ms, 3),
            "tags": dict(self.tags),
        }


class _SpanContext:
    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def tag(self, key: str, value) -> None:
        self.span.tags[key] = value

    def __enter__(self) -> "_SpanContext":
        self.span.start = self._tracer._clock()
        self._tracer._push(self.span)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.span.end = self._tracer._clock()
        if exc is not None:
            self.span.tags["error"] = repr(exc)
        self._tracer._pop(self.span)


# Span/trace ids need uniqueness, not cryptographic strength — and
# secrets.token_hex is a syscall (urandom) per id, which profiled at ~1 ms
# per serving DECISION at 10k nodes (two ids per select-node span). A
# process-local PRNG seeded once from urandom keeps the id format and
# collision odds while costing nanoseconds. Thread-local: random.Random is
# not safe under concurrent getrandbits.
_id_rng = threading.local()


def _new_id(bits: int = 64) -> str:
    rng = getattr(_id_rng, "rng", None)
    if rng is None:
        rng = _id_rng.rng = random.Random(secrets.randbits(64))
    return f"{rng.getrandbits(bits):0{bits // 4}x}"


class _AttachedContext:
    """Adopt an EXISTING span as another thread's current span: children
    created inside join its trace; the span itself is NOT finished on exit
    (its owner finishes it). Used by the predicate batcher to carry the
    handler thread's b3 context onto the dispatcher thread."""

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> "_AttachedContext":
        self._tracer._push(self.span)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        stack = self._tracer._stack()
        if stack and stack[-1] is self.span:
            stack.pop()


class Tracer:
    """Thread-local span stack + bounded finished-span ring buffer."""

    def __init__(self, capacity: int = 512, log_stream=None, clock=time.time):
        self._local = threading.local()
        self._finished: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._log_stream = log_stream
        self._clock = clock

    # -- context management --------------------------------------------------

    def _stack(self) -> list[Span]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        if span.sampled:
            # Stream write stays under the lock: concurrent handler threads
            # finishing spans must not interleave JSONL lines.
            with self._lock:
                self._finished.append(span)
                if self._log_stream is not None:
                    self._log_stream.write(json.dumps(span.to_dict()) + "\n")

    # -- span creation -------------------------------------------------------

    def span(self, name: str, **tags) -> _SpanContext:
        """Child of the thread's current span, or a new root."""
        parent = self.current()
        if parent is not None:
            s = Span(name, parent.trace_id, _new_id(), parent.span_id, parent.sampled)
        else:
            s = Span(name, _new_id(128), _new_id(), None)
        s.tags.update(tags)
        return _SpanContext(self, s)

    def attach(self, span: Span) -> _AttachedContext:
        """Adopt `span` as this thread's current span (see _AttachedContext)."""
        return _AttachedContext(self, span)

    def root_from_headers(self, headers, name: str, **tags) -> _SpanContext:
        """Continue a b3-propagated trace (witchcraft middleware slot).
        Accepts multi-header b3 (X-B3-TraceId/SpanId/Sampled) and the
        single `b3: traceid-spanid-sampled` form."""
        get = headers.get
        trace_id = get("X-B3-TraceId") or get("x-b3-traceid")
        parent_id = get("X-B3-SpanId") or get("x-b3-spanid")
        sampled_raw = get("X-B3-Sampled") or get("x-b3-sampled")
        single = get("b3") or get("B3")
        if single and not trace_id:
            parts = single.split("-")
            if len(parts) == 1:
                # lone sampling decision: "b3: 0" (deny) / "1" / "d"
                sampled_raw = parts[0]
            if len(parts) >= 2:
                trace_id, parent_id = parts[0], parts[1]
            if len(parts) >= 3:
                sampled_raw = parts[2]
        sampled = sampled_raw not in ("0", "false", "False")
        if trace_id:
            s = Span(name, trace_id, _new_id(), parent_id, sampled)
        else:
            # New root — the sampling decision still applies (lone "b3: 0").
            s = Span(name, _new_id(128), _new_id(), None, sampled)
        s.tags.update(tags)
        return _SpanContext(self, s)

    def inject_headers(self) -> dict[str, str]:
        """b3 headers for outbound calls from the current span."""
        cur = self.current()
        if cur is None:
            return {}
        return {
            "X-B3-TraceId": cur.trace_id,
            "X-B3-SpanId": cur.span_id,
            "X-B3-Sampled": "1" if cur.sampled else "0",
        }

    # -- detached spans ------------------------------------------------------

    def begin_detached(self, span: Span) -> None:
        """Start a span WITHOUT pushing it on this thread's stack. The
        event-loop serving transport cannot hold a request's root span
        open on its (shared, interleaved) loop thread the way a dedicated
        handler thread can — detached spans are timed by hand and land in
        the finished ring via finish_detached."""
        span.start = self._clock()

    def finish_detached(self, span: Span) -> None:
        span.end = self._clock()
        if span.sampled:
            with self._lock:
                self._finished.append(span)
                if self._log_stream is not None:
                    self._log_stream.write(json.dumps(span.to_dict()) + "\n")

    # -- inspection ----------------------------------------------------------

    def finished_spans(self) -> list[dict]:
        with self._lock:
            return [s.to_dict() for s in self._finished]

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()


# Process-wide default tracer: instrumentation points (extender, solver,
# async write-back) call tracer() so embedding programs can swap the sink.
_default_tracer = Tracer()


def tracer() -> Tracer:
    return _default_tracer


def set_tracer(t: Tracer) -> Tracer:
    global _default_tracer
    _default_tracer = t
    return t


# --------------------------------------------------- svc1log + safe params


def pod_safe_params(pod) -> dict:
    """internal/logging.go:22-33 (podName/podNamespace + spark labels)."""
    return {
        "podName": pod.name,
        "podNamespace": pod.namespace,
        "podSparkRole": pod.labels.get("spark-role", ""),
        "podSparkAppID": pod.labels.get("spark-app-id", ""),
    }


def demand_safe_params(demand) -> dict:
    """internal/logging.go:35-45 (demand identity + units)."""
    return {
        "demandName": demand.name,
        "demandNamespace": demand.namespace,
        "demandUnits": [
            {"count": u.count, "cpu": u.resources.cpu_milli, "memoryKib": u.resources.mem_kib}
            for u in demand.spec.units
        ],
        "demandInstanceGroup": demand.spec.instance_group,
    }


def rr_safe_params(rr) -> dict:
    """lib pkg/logging/logging.go:23-55 (reservation names/nodes/pods)."""
    return {
        "reservationName": rr.name,
        "reservationNamespace": rr.namespace,
        "reservationNodes": sorted({r.node for r in rr.spec.reservations.values()}),
        "reservationPodNames": sorted(rr.status.pods.values()),
    }


class Svc1Logger:
    """svc1log-shaped JSON lines: explicit params vs unsafe free text is the
    reference's logging discipline; every entry carries the active trace
    context so logs and traces join."""

    LEVELS = {"DEBUG": 0, "INFO": 1, "WARN": 2, "ERROR": 3}

    def __init__(
        self,
        stream=None,
        origin: str = "spark-scheduler-tpu",
        clock=time.time,
        level: str = "INFO",
    ):
        self._stream = stream if stream is not None else sys.stderr
        self._origin = origin
        self._clock = clock
        self._lock = threading.Lock()
        self._min_level = self.LEVELS.get(str(level).upper(), 1)

    def set_level(self, level: str) -> None:
        """Live log-level change — the witchcraft runtime-config reload slot
        (config/config.go:24-47 Runtime embed)."""
        self._min_level = self.LEVELS.get(str(level).upper(), self._min_level)

    @property
    def level(self) -> str:
        for name, rank in self.LEVELS.items():
            if rank == self._min_level:
                return name
        return "INFO"

    def _log(self, level: str, message: str, params: dict | None) -> None:
        if self.LEVELS.get(level, 1) < self._min_level:
            return
        entry = {
            "type": "service.1",
            "level": level,
            "time": self._clock(),
            "origin": self._origin,
            "message": message,
            "params": params or {},
        }
        cur = tracer().current()
        if cur is not None:
            entry["traceId"] = cur.trace_id
            entry["spanId"] = cur.span_id
        with self._lock:
            self._stream.write(json.dumps(entry) + "\n")

    def request(
        self,
        method: str,
        path: str,
        status: int,
        duration_us: int,
        *,
        protocol: str = "HTTP/1.1",
        trace_id: str | None = None,
    ) -> None:
        """Structured per-request access log — the witchcraft req2log slot
        (middleware/route.go:28-48): every HTTP call gets one line with
        method, path, status, duration (microseconds) and trace id.
        Bypasses the service-log level filter (request logs are their own
        stream type in the reference)."""
        entry = {
            "type": "request.2",
            "time": self._clock(),
            "origin": self._origin,
            "method": method,
            "protocol": protocol,
            "path": path,
            "status": int(status),
            "duration": int(duration_us),
        }
        if trace_id:
            entry["traceId"] = trace_id
        with self._lock:
            self._stream.write(json.dumps(entry) + "\n")

    def debug(self, message: str, **params) -> None:
        self._log("DEBUG", message, params)

    def info(self, message: str, **params) -> None:
        self._log("INFO", message, params)

    def warn(self, message: str, **params) -> None:
        self._log("WARN", message, params)

    def error(self, message: str, **params) -> None:
        self._log("ERROR", message, params)


_default_logger = Svc1Logger()


def svc1log() -> Svc1Logger:
    return _default_logger


def set_svc1log(logger: Svc1Logger) -> Svc1Logger:
    global _default_logger
    _default_logger = logger
    return logger
