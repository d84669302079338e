"""Request-scoped tracing + safe-param structured logging (SURVEY.md §5.1).

The reference gets zipkin tracing with b3 propagation from witchcraft
middleware (vendor/github.com/palantir/witchcraft-go-tracing) and svc1log
structured logging with *safe params* (internal/logging.go:22-45,
lib pkg/logging/logging.go:23-55). This module provides both natively:

  - `Tracer`: thread-local span stacks; `span()` context manager; b3
    single+multi header extraction/injection (x-b3-traceid / x-b3-spanid /
    x-b3-sampled); finished spans land in a bounded ring buffer (pollable
    at GET /debug/traces). Spans are timed on `time.perf_counter`, the
    clock the benchmark aligns device traces to; `timestamp_s` is reported
    in epoch seconds.
  - `profiled_span`: a span on the device path (the queue solve) that is
    recorded only while a torch profiler runs, and then also marks its
    interval in the profiler's trace, so the trace nests the span's kernels
    under it. With no profiler running it costs one flag read.
  - `svc1log`: JSON-line service log with explicit safe-param dicts —
    `pod_safe_params`, `demand_safe_params`, `rr_safe_params` mirror the
    reference's safe-param helpers so log pipelines receive identical keys.
  - torch.profiler hooks: `start_torch_profile(dir)` /
    `stop_torch_profile()` drive the server's /debug/profile routes (the
    JAX package's `start_jax_profile` / `stop_jax_profile`); the trace
    records every thread, and a stopped trace is written to
    `<dir>/trace.json` in the Chrome trace format.
"""

from __future__ import annotations

import collections
import json
import os
import random
import secrets
import sys
import threading
import time
from typing import Any, Optional

from torch.autograd import profiler as _autograd_profiler


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

    def to_dict(self, epoch: float = 0.0) -> dict:
        """The span as /debug/traces gives it; `epoch` is added to the
        tracer's clock to give `timestamp_s`."""
        return {
            "name": self.name,
            "traceId": self.trace_id,
            "id": self.span_id,
            **({"parentId": self.parent_id} if self.parent_id else {}),
            "timestamp_s": self.start + epoch,
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
    """Thread-local span stack + bounded finished-span ring buffer.

    Spans are timed on `clock`; by default `time.perf_counter`, with
    `timestamp_s` moved to epoch seconds by one offset taken here. A clock
    passed in is used as given, its readings reported unchanged."""

    def __init__(self, capacity: int = 512, clock=None):
        self._local = threading.local()
        self._finished: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        if clock is None:
            clock = time.perf_counter
            self._epoch = time.time() - time.perf_counter()
        else:
            self._epoch = 0.0
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
        self._record(span)

    def _record(self, span: Span) -> None:
        if span.sampled:
            with self._lock:
                self._finished.append(span)

    # -- span creation -------------------------------------------------------

    def _child(self, name: str, tags: dict) -> Span:
        parent = self.current()
        if parent is not None:
            s = Span(name, parent.trace_id, _new_id(), parent.span_id, parent.sampled)
        else:
            s = Span(name, _new_id(128), _new_id(), None)
        s.tags.update(tags)
        return s

    def span(self, name: str, **tags) -> _SpanContext:
        """Child of the thread's current span, or a new root."""
        return _SpanContext(self, self._child(name, tags))

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
        self._record(span)

    # -- inspection ----------------------------------------------------------

    def finished_spans(self) -> list[dict]:
        with self._lock:
            return [s.to_dict(self._epoch) for s in self._finished]

    def finished(self) -> list[Span]:
        """The finished spans themselves, oldest first: name, span_id,
        parent_id, and start / end on the tracer's clock."""
        with self._lock:
            return list(self._finished)

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


class _ProfiledContext(_SpanContext):
    """A span that also marks its interval in the running torch.profiler
    trace (`record_function`), so the trace shows the span's device work
    under its name."""

    def __enter__(self) -> "_ProfiledContext":
        super().__enter__()
        self._mark = _autograd_profiler.record_function(self.span.name)
        self._mark.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self._mark.__exit__(exc_type, exc, tb)
        finally:
            super().__exit__(exc_type, exc, tb)


class _NoSpan:
    """What `profiled_span` returns while no profiler runs: records
    nothing."""

    __slots__ = ()

    def tag(self, key: str, value) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NO_SPAN = _NoSpan()


def profiled_span(name: str, **tags):
    """A span on the device path, child of the thread's current span in the
    default tracer. It is recorded only while a torch profiler runs (the
    benchmark's traced slice, /debug/profile), and then also enters
    `torch.profiler.record_function(name)`. Otherwise it returns one shared
    no-op context: one flag read, no ids, no lock."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    t = _default_tracer
    return _ProfiledContext(t, t._child(name, tags))


# --------------------------------------------------- svc1log + safe params



# ------------------------------------------------------- torch.profiler

_profile_lock = threading.Lock()
_profile: Optional[tuple] = None  # (stop event, worker, directory, errors)


def _profile_worker(log_dir, started, stop, errors) -> None:
    """One thread starts, stops and exports the trace: the profiler is
    bound to the thread that started it, and the HTTP routes that drive it
    run on whichever handler thread took the request."""
    import torch
    from torch._C._profiler import _ExperimentalConfig

    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        # Every thread's ops and spans, not only this one's: the serving
        # threads do the work.
        prof = torch.profiler.profile(
            activities=activities,
            experimental_config=_ExperimentalConfig(profile_all_threads=True),
        )
        prof.start()
    except Exception as exc:
        errors.append(exc)
        started.set()
        return
    started.set()
    stop.wait()
    try:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    except Exception as exc:
        errors.append(exc)


def start_torch_profile(log_dir: str) -> bool:
    """Start a torch.profiler trace (host, and the card's kernels when CUDA
    is available) that `stop_torch_profile` writes into `log_dir`. Returns
    False if a trace is already running."""
    global _profile
    with _profile_lock:
        if _profile is not None:
            return False
        os.makedirs(log_dir, exist_ok=True)
        started, stop, errors = threading.Event(), threading.Event(), []
        worker = threading.Thread(
            target=_profile_worker,
            args=(log_dir, started, stop, errors),
            daemon=True,
            name="torch-profile",
        )
        worker.start()
        started.wait()
        if errors:
            raise errors[0]
        _profile = (stop, worker, log_dir, errors)
        return True


def stop_torch_profile() -> Optional[str]:
    """Stop the running trace and write `<dir>/trace.json`; returns the
    directory (None if no trace was running). The running state is cleared
    before the write, so a failed write never wedges later starts."""
    global _profile
    with _profile_lock:
        if _profile is None:
            return None
        (stop, worker, out, errors), _profile = _profile, None
        stop.set()
        worker.join()
        if errors:
            raise errors[0]
        return out


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
