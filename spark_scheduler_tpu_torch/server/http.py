r"""HTTP front-end — the witchcraft-server slot (cmd/server.go, cmd/endpoints.go).

Routes (all JSON):

  POST /predicates            kube-scheduler extender filter call
                              (ExtenderArgs -> ExtenderFilterResult,
                              cmd/endpoints.go:28-42)
  POST /convert               CRD version-conversion webhook
                              (ConversionReview, SURVEY.md L9; also served
                              standalone by ConversionWebhookServer)
  GET  /status/liveness       200 when the process is up
  GET  /status/readiness      200 once cluster state has been synced
                              (at least one node known to the backend)
  GET  /metrics               metric-registry snapshot: JSON by default,
                              Prometheus text exposition when the Accept
                              header prefers text/plain (or
                              ?format=prometheus) — the pull surface for
                              scrape stacks
  GET  /debug/decisions       flight-recorder query (?app=&verdict=&role=
                              &limit=), gated on debug-routes
  GET  /debug/state           point-in-time scheduler state (hard/soft
                              reservations, FIFO queue, unschedulable set,
                              node fleet), gated on debug-routes
  PUT  /state/nodes           upsert a k8s Node object   \  informer-watch
  PUT  /state/pods            upsert a k8s Pod object     } substitute: the
  DELETE /state/pods/{ns}/{n} remove a pod               /  state-sync API

The reference learns cluster state through apiserver watch streams
(cmd/server.go:111-147); in environments without one, the state-sync routes
carry the same information.

This module is the SERVING CORE: the PredicateBatcher (the serialization
point for mutable scheduling state) and the server facades that wire a
route table (server/routing.py) onto a transport. Two transports exist,
selected by the `server.transport` install knob:

  threaded (default)  server/transport_threaded.py — the stdlib
                      thread-per-connection stack; simplest to debug.
  async               server/transport_async.py — a single-threaded event
                      loop with an incremental HTTP/1.1 parser, pipelined
                      keep-alive framing, one-write responses, and explicit
                      backpressure (max-connections 503, max-body-bytes
                      413, batcher-queue-depth load shedding). Requests
                      hand straight to the PredicateBatcher.

The port's copy of spark_scheduler_tpu/server/http.py. `ingest="native"`
builds the port's native library (spark_scheduler_tpu_torch/native) or
raises: the JAX package's degrade of `native` to `python` is not copied.
`ha=` takes an HA replica runtime (ha/replica.py) and `fleet=` a
FleetFacade (fleet/facade.py), as in the JAX package.
"""

from __future__ import annotations

import threading

# Re-exports: the framing exceptions and the TLS helpers are imported from
# server.http by callers.
from spark_scheduler_tpu_torch.server.routing import (  # noqa: F401
    BodyTooLarge,
    ConversionRoutes,
    SchedulerRoutes,
    UnframeableBody,
    UnsupportedTransferEncoding,
)
from spark_scheduler_tpu_torch.server.transport_threaded import (  # noqa: F401
    ThreadedTransport,
    _maybe_wrap_tls,
    build_server_ssl_context,
)

TRANSPORTS = ("threaded", "async")

# Ingest lanes (`server.ingest`): how a framed predicate body becomes
# ExtenderArgs — "python" (json.loads + dict walk) or "native" (the C++
# framer/decoder in native/runtime.cpp emitting zero-copy tickets). See
# server/ingest.py. The native lane composes with BOTH transports: the
# async transport swaps its Python parser for the native framer, the
# threaded transport keeps stdlib framing and routes predicate bodies
# through the native decoder.
INGESTS = ("python", "native")


class _CallbackEvent:
    """Event-shaped completion hook for `PredicateBatcher.submit_nowait`:
    the dispatcher's `entry[1].set()` fires the registered callback exactly
    once (set is idempotent under races between the dispatcher and
    `stop()`), so the dispatcher code path is identical for blocking and
    callback entries."""

    __slots__ = ("_cb", "_fired", "_lock")

    def __init__(self, cb):
        self._cb = cb
        self._fired = False
        self._lock = threading.Lock()

    def set(self) -> None:
        with self._lock:
            if self._fired:
                return
            self._fired = True
            cb, self._cb = self._cb, None
        try:
            cb()
        except Exception:
            # A failing responder (e.g. a client that vanished) must never
            # kill the dispatcher thread mid-window.
            pass

    def is_set(self) -> bool:
        return self._fired

    def wait(self, timeout=None) -> bool:  # Event-interface parity
        return self._fired


class PredicateBatcher:
    """Coalesces concurrent POST /predicates calls into windowed
    `extender.predicate_batch` solves.

    A single dispatcher thread drains the queue: whatever arrived while the
    previous window was being served forms the next window, plus — during
    busy periods only — a short accumulation hold (`hold_ms`) so clients
    answering the previous window can rejoin and windows stay near the
    concurrency level. An idle server serves a lone request immediately
    (window of 1 = the solo path); a loaded server amortizes one device
    solve over every queued request. The dispatcher thread is ALSO the
    serialization point for mutable scheduling state, replacing the
    per-request lock (SURVEY.md §7 "Mutable-state races")."""

    # Debug log of claim decisions is HARD-BOUNDED: recording stops at this
    # many entries (tests/test_predicate_batcher.py pins the bound).
    CLAIM_LOG_CAP = 4096

    def __init__(
        self, extender, max_window: int = 32, hold_ms: float = 25.0,
        registry=None, pipeline_depth: int = 3, fuse_windows: int = 1,
    ):
        self._extender = extender
        self._max_window = max_window
        # How many dispatched windows may be awaiting their decision pull
        # at once: a window dispatched while the previous one is in flight
        # queues its kernels behind it on the card, so the host builds the
        # next window while the card solves this one. With fusion, depth
        # counts DISPATCHES (a fused batch of K windows is one round trip),
        # see _run's inflight_dispatches.
        self._pipeline_depth = max(1, pipeline_depth)
        # Fused multi-window dispatch (`solver.fuse-windows`): when the
        # backlog holds more than one window's worth of requests, claim up
        # to fuse_windows x max_window of them and dispatch the sub-windows
        # as ONE fused device program (extender.predicate_windows_dispatch):
        # K windows share one dispatch and one decision pull. 1 = one window
        # a dispatch.
        self._fuse_windows = max(1, fuse_windows)
        # Window-size histogram + wait time in the tagged registry (the
        # reference's metric discipline for every serving subsystem,
        # metrics/metrics.go:29-76).
        self._registry = registry
        # Adaptive accumulation: when the PREVIOUS window was coalesced
        # (>1 request — i.e. we are in a busy period), hold up to hold_ms
        # for stragglers before solving, so clients answering the previous
        # window have time to submit their next request and windows stay
        # near the concurrency level instead of oscillating small. A lone
        # request on an idle server is never held.
        self._hold_s = hold_ms / 1e3
        self._last_window = 1
        # Whether the previous window dispatched a DEVICE solve. The hold
        # exists to amortize one device program over more requests; an
        # executor-only window is pure host work and holding for
        # stragglers just adds their wait to everyone's latency.
        self._last_had_solve = False
        # The hold engages only while a busy period is LIVE: within this
        # TTL of the previous coalesced window. A lone request on a
        # since-idle server is served immediately.
        self._busy_ttl_s = 2.0
        self._busy_until = 0.0
        self._cv = threading.Condition()
        self._queue: list[list] = []  # [args, event, result, exception, trace]
        # Entries the dispatcher has claimed whose events may not be set
        # yet — what stop() fails when the dispatcher thread is stalled in
        # a blocking fetch against a dead tunnel (join times out but
        # in-flight HTTP handlers must not hang until request timeout).
        # Entries are REMOVED on completion (_finish_entries), so a
        # timed-out-then-completed request never leaves a slot behind.
        self._claimed: list[list] = []
        self._stopped = False
        # Serving stats (surfaced at GET /metrics).
        self.windows_served = 0
        self.requests_served = 0
        self.max_window_seen = 0
        # Debug log of claim decisions:
        # (window, queue_after, pending, hold_ms). Cheap appends; recording
        # stops at the CLAIM_LOG_CAP bound; stats() exposes the tail for
        # serving-dynamics forensics.
        self.claim_log: list[tuple] = []
        # Windows dispatched while another window was still in flight (the
        # dispatch-before-fetch overlap actually engaging).
        self.pipelined_windows = 0
        # Fused claims dispatched, and the largest K among them.
        self.fused_dispatches = 0
        self.max_fused_k = 1
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="predicate-batcher"
        )
        self._thread.start()

    def submit(self, args, timeout: float | None = None):
        from spark_scheduler_tpu_torch.tracing import tracer

        # Carry the handler thread's trace context to the dispatcher.
        entry = [args, threading.Event(), None, None, tracer().current()]
        with self._cv:
            if self._stopped:
                raise RuntimeError("scheduler is shutting down")
            self._queue.append(entry)
            self._cv.notify()
        if not entry[1].wait(timeout):
            # Shed the abandoned request: if the dispatcher has not claimed
            # it yet, remove it so no window slot is burned solving for a
            # client that already got an error (overload would otherwise
            # spiral: dead entries crowd out live ones). If it WAS claimed,
            # the solve proceeds harmlessly and _finish_entries clears the
            # claimed slot at completion.
            self.abandon(entry)
            raise TimeoutError("predicate window timed out")
        if entry[3] is not None:
            raise entry[3]
        return entry[2]

    def submit_nowait(self, args, done, trace_span=None):
        """Callback-mode submission for event-loop transports: no thread
        parks. `done(result, exc)` is invoked exactly once — from the
        dispatcher thread on completion, or from the stopping thread at
        shutdown. Returns the queue entry for use with `abandon`."""
        entry = [args, None, None, None, trace_span]

        def _fire():
            done(entry[2], entry[3])

        entry[1] = _CallbackEvent(_fire)
        with self._cv:
            if self._stopped:
                raise RuntimeError("scheduler is shutting down")
            self._queue.append(entry)
            self._cv.notify()
        return entry

    def abandon(self, entry) -> bool:
        """Remove a not-yet-claimed entry (client timed out / went away).
        True when removed — its event/callback will never fire. False when
        the dispatcher already claimed it: the solve proceeds and the
        caller's completion hook must tolerate (or dedup) the late fire."""
        with self._cv:
            try:
                self._queue.remove(entry)
                return True
            except ValueError:
                return False

    def queue_depth(self) -> int:
        """Current un-claimed backlog — what 503 load shedding keys on."""
        with self._cv:
            return len(self._queue)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=5)
        # Fail every claimed/queued entry whose event is still unset so
        # in-flight handlers return instead of hanging until their own
        # request timeout — covers a dispatcher STALLED in a decision pull
        # against a dead tunnel (join timed out) and one that DIED with a
        # batch's events unset. No-op on a clean exit (everything is set);
        # a late set() by a stalled thread is harmless (set is idempotent
        # for both entry kinds).
        err = RuntimeError("scheduler is shutting down")
        with self._cv:
            leftovers = self._claimed + self._queue
            self._queue.clear()
        for entry in leftovers:
            if not entry[1].is_set():
                entry[3] = err
                entry[1].set()

    def _run(self) -> None:
        """PIPELINED serving loop: dispatch the next window (host build +
        the card's queued kernels) while up to `pipeline_depth` earlier
        windows are still awaiting their decisions. Windows complete
        strictly in dispatch order. Decisions are unchanged: the solver
        threads the committed base availability device-side across
        in-flight windows (build_tensors_pipelined), an app whose admission
        is still in flight is deferred to its own window's post-apply solo
        loop (extender in-flight set), and a ticket with no dispatched
        solve (the solo path) drains the pipeline before serving. A fused
        claim (`fuse_windows` > 1) dispatches its sub-windows as one
        device program and occupies one depth slot.

        A pooled window (`solver.device-pool`) pulls its decisions on pool
        workers, one future per part: its completion waits for them
        without blocking the loop, so requests arriving meanwhile dispatch
        the next window first. A single-device window completes when the
        depth bound or an empty queue asks for it (or, inside a fused
        batch, once the batch's one pull has landed), waiting on the
        card's copy event."""
        import time as _time
        from collections import deque

        from spark_scheduler_tpu_torch.core.solver import PipelineDrainRequired

        pending: deque = deque()  # (ticket, batch) in dispatch order

        def complete_head():
            ok = self._complete_window(pending.popleft())
            if not ok and pending:
                # A failed fetch dropped the solver's pipelined state; the
                # remaining in-flight windows' gangs exist only in their
                # (still valid) device decisions. Apply them ALL before any
                # new dispatch — a fresh full upload from the host view
                # would otherwise lack their capacity debits and the next
                # window could double-book.
                while pending:
                    self._complete_window(pending.popleft())

        def complete_all():
            while pending:
                complete_head()

        def head_ready() -> bool:
            """The head's decisions are on the host (every part's pull of a
            pooled window, or a fused batch's one pull): it completes at no
            cost."""
            t = pending[0][0]
            if t.handle is None:
                return False
            ready = getattr(t.handle, "fetch_ready", None)
            return ready is not None and ready()

        def eager_futures(handle) -> list:
            parts = getattr(handle, "parts", None)
            return [p.future for p in parts] if parts else []

        def inflight_dispatches() -> int:
            """Pipeline depth in DEVICE ROUND TRIPS: the windows of one
            fused dispatch share its dispatch_id and count once."""
            ids = set()
            for t, _ in pending:
                did = getattr(t.handle, "dispatch_id", None)
                ids.add(did if did is not None else id(t))
            return len(ids)

        while True:
            with self._cv:
                while not self._queue and not self._stopped and not pending:
                    self._cv.wait()
                busy = (
                    self._last_window > 1
                    and _time.monotonic() < self._busy_until
                )
                if (
                    not self._stopped
                    and self._queue
                    and not pending
                    and self._hold_s > 0
                    and busy
                    and self._last_had_solve
                ):
                    # Accumulation hold, only when nothing is in flight — a
                    # pending window's fetch IS the accumulation period
                    # otherwise: requests arriving during it dispatch as
                    # the next window and their solve overlaps the fetch.
                    # Deliberately NO stopped-growing early exit: arrival
                    # gaps of several ms mid-resubmission made it claim
                    # straggler subgroups that then ratcheted the window
                    # size down. Cost: after a cohort SHRINKS, the first
                    # window waits the full hold once; the target then
                    # adapts to the new cohort size.
                    hold_t0 = _time.monotonic()
                    target = min(self._last_window, self._max_window)
                    deadline = hold_t0 + self._hold_s
                    while (
                        len(self._queue) < target and not self._stopped
                    ):
                        remaining = deadline - _time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                    hold_ms = (_time.monotonic() - hold_t0) * 1e3
                else:
                    hold_ms = 0.0
                if self._stopped:
                    err = RuntimeError("scheduler is shutting down")
                    for _, entries in pending:
                        for entry in entries:
                            entry[3] = err
                            entry[1].set()
                    pending.clear()
                    for entry in self._queue:
                        entry[3] = err
                        entry[1].set()
                    self._queue.clear()
                    return
                # Fused claim: up to fuse-windows x max-window of the
                # backlog; past one window's worth it splits into
                # sub-windows dispatched as ONE fused device program.
                claim = self._max_window * self._fuse_windows
                batch = self._queue[:claim]
                del self._queue[:claim]
                if batch and len(self.claim_log) < self.CLAIM_LOG_CAP:
                    self.claim_log.append((
                        len(batch), len(self._queue), len(pending),
                        round(hold_ms, 1),
                    ))
                self._claimed = [
                    e for e in self._claimed if not e[1].is_set()
                ]
                self._claimed.extend(batch)
                if batch:
                    self._last_window = len(batch)
                    if len(batch) > 1:
                        self._busy_until = (
                            _time.monotonic() + self._busy_ttl_s
                        )
            dispatched: list = []
            if batch:
                sub_batches = [
                    batch[i : i + self._max_window]
                    for i in range(0, len(batch), self._max_window)
                ]
                try:
                    dispatched = self._dispatch_batches(sub_batches)
                except PipelineDrainRequired:
                    # Topology changed under in-flight windows: apply them
                    # first, then the fresh full upload is safe.
                    complete_all()
                    try:
                        dispatched = self._dispatch_batches(sub_batches)
                    except Exception as exc:
                        self._fail_batch(batch, exc)
                except Exception as exc:
                    self._fail_batch(batch, exc)
            if dispatched:
                self._last_had_solve = any(
                    t.handle is not None for t, _ in dispatched
                )
            for ticket, sub in dispatched:
                if ticket.handle is None:
                    # No dispatched device solve (lone request -> solo path,
                    # or a batch that didn't window): its serve must observe
                    # every earlier window's reservations, and there is no
                    # fetch to overlap — drain, then serve now. (Inside a
                    # fused claim this drains the batch's earlier windows —
                    # one pull — before the solo serve.)
                    complete_all()
                    self._complete_window((ticket, sub))
                else:
                    if pending:
                        self.pipelined_windows += 1
                    pending.append((ticket, sub))
                    # Wake the loop the moment a pooled window's pulls land,
                    # so its completion never waits on a timeout.
                    for fut in eager_futures(ticket.handle):
                        fut.add_done_callback(lambda _f: self._notify())
            # Heads whose pulls already landed complete at no cost; the
            # depth bound backpressures (blocking complete) when the
            # pipeline is full; with nothing queued, the head completes now,
            # or, when its pulls run on pool workers, once they land or a
            # request arrives (which dispatches first).
            while pending and head_ready():
                complete_head()
            while pending and inflight_dispatches() >= self._pipeline_depth:
                complete_head()
            if not batch and pending and not self._queue:
                head = pending[0][0]
                if head.handle is None or not eager_futures(head.handle):
                    complete_head()
                else:
                    with self._cv:
                        while (
                            not self._queue
                            and not self._stopped
                            and pending
                            and not head_ready()
                        ):
                            self._cv.wait(0.005)

    def _notify(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def _dispatch_batches(self, sub_batches):
        """Dispatch one claim: a single window, or a FUSED group of K
        sub-windows solved by one device dispatch
        (extender.predicate_windows_dispatch). Returns [(ticket, batch)] in
        dispatch order; completions stay strictly FIFO."""
        if len(sub_batches) == 1:
            return [(self._dispatch_window(sub_batches[0]), sub_batches[0])]
        from spark_scheduler_tpu_torch.tracing import tracer

        with tracer().span(
            "predicate-window-fused",
            windows=len(sub_batches),
            requests=sum(len(s) for s in sub_batches),
        ):
            tickets = self._extender.predicate_windows_dispatch(
                [[e[0] for e in sub] for sub in sub_batches]
            )
        # Counted AFTER the dispatch landed: a PipelineDrainRequired retry
        # re-enters for the same claim and must not count the aborted
        # attempt.
        self.fused_dispatches += 1
        self.max_fused_k = max(self.max_fused_k, len(sub_batches))
        if self._registry is not None:
            self._registry.histogram(
                "foundry.spark.scheduler.predicate.fused.windows"
            ).update(len(sub_batches))
        return list(zip(tickets, sub_batches))

    def _dispatch_window(self, batch):
        from spark_scheduler_tpu_torch.tracing import tracer

        args_list = [e[0] for e in batch]
        if len(batch) == 1 and batch[0][4] is not None:
            # Lone request: its work continues the caller's b3 trace
            # exactly as the pre-batcher serving path did.
            with tracer().attach(batch[0][4]):
                return self._extender.predicate_window_dispatch(args_list)
        # Coalesced window: one solve serves many traces — emit a window
        # span linking every request trace (zipkin span-link style).
        with tracer().span(
            "predicate-window",
            window=len(batch),
            request_traces=[e[4].trace_id for e in batch if e[4] is not None],
        ):
            return self._extender.predicate_window_dispatch(args_list)

    def _finish_entries(self, batch) -> None:
        """Clear completed entries out of the claimed set immediately: a
        request that timed out client-side while its window was in flight
        must not leave its slot in `_claimed` until the next claim's lazy
        rebuild happens to run (on an idle server that could be never)."""
        with self._cv:
            claimed = self._claimed
            for entry in batch:
                try:
                    claimed.remove(entry)
                except ValueError:
                    pass

    def _complete_window(self, pending) -> bool:
        """Returns False when the window failed (entries got the error) —
        the serving loop then drains the rest of the pipeline before
        dispatching anything new."""
        from spark_scheduler_tpu_torch.tracing import tracer

        ticket, batch = pending
        try:
            if len(batch) == 1 and batch[0][4] is not None:
                with tracer().attach(batch[0][4]):
                    results = self._extender.predicate_window_complete(ticket)
            else:
                with tracer().span(
                    "predicate-window-complete", window=len(batch)
                ):
                    results = self._extender.predicate_window_complete(ticket)
        except Exception as exc:  # whole-window failure
            self._fail_batch(batch, exc)
            return False
        self.windows_served += 1
        self.requests_served += len(batch)
        self.max_window_seen = max(self.max_window_seen, len(batch))
        if self._registry is not None:
            self._registry.histogram(
                "foundry.spark.scheduler.predicate.window"
            ).update(len(batch))
        for entry, result in zip(batch, results):
            entry[2] = result
            entry[1].set()
        self._finish_entries(batch)
        return True

    def _fail_batch(self, batch, exc) -> None:
        for entry in batch:
            entry[3] = exc
            entry[1].set()
        self._finish_entries(batch)

    def stats(self) -> dict:
        return {
            "windows_served": self.windows_served,
            "requests_served": self.requests_served,
            "max_window_seen": self.max_window_seen,
            "pipelined_windows": self.pipelined_windows,
            "fuse_windows": self._fuse_windows,
            "fused_dispatches": self.fused_dispatches,
            "max_fused_k": self.max_fused_k,
            "queue_depth": self.queue_depth(),
            "mean_window": (
                round(self.requests_served / self.windows_served, 2)
                if self.windows_served
                else 0.0
            ),
            # (window, queue_after, pending, hold_ms) for recent claims.
            "claim_log_tail": self.claim_log[-32:],
        }


def _build_transport(
    transport: str,
    routes,
    host: str,
    port: int,
    *,
    cert_file,
    key_file,
    client_ca_files,
    request_timeout_s,
    request_log,
    max_body_bytes,
    max_connections,
    telemetry,
    name: str,
    ingest_codec=None,
):
    if transport == "async":
        from spark_scheduler_tpu_torch.server.transport_async import AsyncTransport

        return AsyncTransport(
            routes,
            host,
            port,
            cert_file=cert_file,
            key_file=key_file,
            client_ca_files=client_ca_files,
            request_timeout_s=request_timeout_s,
            request_log=request_log,
            max_body_bytes=max_body_bytes,
            max_connections=max_connections,
            telemetry=telemetry,
            name=name,
            ingest_codec=ingest_codec,
        )
    if transport != "threaded":
        raise ValueError(
            f"unknown server transport {transport!r}; expected one of {TRANSPORTS}"
        )
    return ThreadedTransport(
        routes,
        host,
        port,
        cert_file=cert_file,
        key_file=key_file,
        client_ca_files=client_ca_files,
        request_timeout_s=request_timeout_s,
        request_log=request_log,
        max_body_bytes=max_body_bytes,
        telemetry=telemetry,
        name=name,
    )


class SchedulerHTTPServer:
    def __init__(
        self,
        app,
        registry=None,
        host: str = "127.0.0.1",
        port: int = 8484,
        cert_file: str | None = None,
        key_file: str | None = None,
        client_ca_files=None,
        request_timeout_s: float = 30.0,
        debug_routes: bool = False,
        request_log: bool = False,
        transport: str | None = None,
        ingest: str | None = None,
        max_body_bytes: int | None = None,
        max_connections: int | None = None,
        shed_queue_depth: int | None = None,
        ha=None,
        fleet=None,
    ):
        from spark_scheduler_tpu_torch.observability import TransportTelemetry

        self.app = app
        self.registry = registry
        self.request_timeout_s = request_timeout_s
        self.request_log = request_log
        # /debug/* (trace dump, profiler control) is an explicit opt-in:
        # on the cluster-exposed extender port it would let any peer start
        # profiler writes to server-side paths.
        self.debug_routes = debug_routes
        # HA replica runtime (ha/replica.ReplicaRuntime) when this server
        # is one replica of an elected group: readiness then ALSO requires
        # a serving role (leader/active), GET /debug/ha exposes the role /
        # lease / tailer state, and start()/stop() run the heartbeat.
        self.ha = ha
        # FleetFacade (fleet/facade.py) when this endpoint fronts F
        # per-cluster stacks: GET /debug/fleet exposes router/spillover/
        # aggregate state and threaded-transport predicates accept a
        # ?cluster=N tag (which cluster endpoint kube-scheduler thinks it
        # hit — wrong-cluster calls are forwarded, counted, and
        # byte-identical either way).
        self.fleet = fleet
        self.ready = threading.Event()
        self._shutdown = threading.Event()
        cfg = getattr(app, "config", None)
        # Transport + backpressure knobs resolve explicit args first, then
        # the install config, then defaults — so embedded uses (tests,
        # bench) can A/B without a config object.
        self.transport_name = transport or getattr(
            cfg, "server_transport", "threaded"
        )
        # Ingest lane: `native` builds the port's native library or
        # raises — never a quiet fall back to the python lane.
        self.ingest_name = ingest or getattr(cfg, "server_ingest", "python")
        if self.ingest_name not in INGESTS:
            raise ValueError(
                f"unknown server ingest {self.ingest_name!r}; "
                f"expected one of {INGESTS}"
            )
        self.ingest_codec = None
        if self.ingest_name == "native":
            from spark_scheduler_tpu_torch.server.ingest import NativeIngestCodec

            self.ingest_codec = NativeIngestCodec()
        self.max_body_bytes = (
            max_body_bytes
            if max_body_bytes is not None
            else getattr(cfg, "max_body_bytes", 16 * 1024 * 1024)
        )
        self.max_connections = (
            max_connections
            if max_connections is not None
            else getattr(cfg, "max_connections", 512)
        )
        self.shed_queue_depth = (
            shed_queue_depth
            if shed_queue_depth is not None
            else getattr(cfg, "shed_queue_depth", 256)
        )
        # Concurrent predicates coalesce into windowed batch solves; the
        # batcher's dispatcher thread is the serialization point for mutable
        # scheduling state (SURVEY.md §7 "Mutable-state races").
        self.batcher = PredicateBatcher(
            app.extender,
            max_window=getattr(cfg, "predicate_max_window", 32),
            hold_ms=getattr(cfg, "predicate_hold_ms", 25.0),
            registry=registry,
            # One window in flight per pool slot at least.
            pipeline_depth=max(3, getattr(app.solver, "pool_size", 1)),
            # Fused multi-window dispatch (`solver.fuse-windows` /
            # --fuse-windows): a deep backlog rides one device round trip
            # per K windows instead of one each.
            fuse_windows=getattr(cfg, "solver_fuse_windows", 1),
        )
        self.telemetry = TransportTelemetry(
            self.transport_name, ingest=self.ingest_name
        )
        self.routes = SchedulerRoutes(self)
        self._transport = _build_transport(
            self.transport_name,
            self.routes,
            host,
            port,
            cert_file=cert_file,
            key_file=key_file,
            client_ca_files=client_ca_files,
            request_timeout_s=request_timeout_s,
            request_log=request_log,
            max_body_bytes=self.max_body_bytes,
            max_connections=self.max_connections,
            telemetry=self.telemetry,
            name=f"scheduler-http-{self.transport_name}",
            ingest_codec=self.ingest_codec,
        )
        self.tls = self._transport.tls

    # Hooks the route table calls back into -------------------------------

    def transport_stats(self) -> dict:
        return self.telemetry.stats()

    def ingest_stats(self) -> dict:
        """`foundry.spark.scheduler.server.ingest.*` snapshot: the codec's
        live counters on the native lane, a plain lane marker on the
        python lane."""
        if self.ingest_codec is not None:
            return self.ingest_codec.stats()
        return {"ingest": self.ingest_name, "degraded": 0}

    def on_queue_shed(self) -> None:
        self.telemetry.on_queue_shed()

    # ----------------------------------------------------------- lifecycle

    @property
    def port(self) -> int:
        return self._transport.port

    def set_request_log(self, enabled: bool) -> None:
        """Toggle the per-request access log on the running transport (the
        runtime-config reload slot; also what the tests flip)."""
        self.request_log = enabled
        self._transport.set_request_log(enabled)

    def start(self) -> None:
        self.app.start_background()
        if self.ha is not None:
            self.ha.start()
        self._transport.start()
        # Ready only once cluster state exists; pre-seeded backends (tests,
        # embedded use) are ready at once, otherwise the first successful
        # PUT /state/nodes — or watch-ingestion cache sync
        # (WaitForCacheSync, cmd/server.go:140-147) — flips it.
        if self.app.backend.list_nodes():
            self.ready.set()
        elif getattr(self.app, "ingestion", None) is not None:
            def _ready_on_sync():
                # Wait as long as it takes (WaitForCacheSync blocks until
                # sync or shutdown) — a slow apiserver must not leave the
                # server permanently not-ready.
                while not self.ready.is_set():
                    if self.app.ingestion.wait_synced(timeout=30.0):
                        self.ready.set()
                        return
                    if self._shutdown.is_set():
                        return

            threading.Thread(
                target=_ready_on_sync, daemon=True, name="ingestion-sync-ready"
            ).start()

    def stop(self) -> None:
        self._shutdown.set()
        self.ready.clear()
        if self.ha is not None:
            # Release the lease FIRST: a clean shutdown lets the standby
            # promote immediately instead of waiting out the TTL.
            self.ha.stop()
        # Batcher first: pending entries fail fast while the transport is
        # still able to write the error responses.
        self.batcher.stop()
        self._transport.stop()
        self.app.stop()

    def join(self) -> None:
        """Block until the serving thread exits (after start())."""
        self._transport.join()

    def serve_forever(self) -> None:
        self.start()
        try:
            self.join()
        except KeyboardInterrupt:
            self.stop()


class ConversionWebhookServer:
    """Standalone conversion-webhook service (the reference ships this as a
    second binary: spark-scheduler-conversion-webhook/cmd/server.go:39-54).
    Serves only POST /convert + liveness; no scheduler state."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8485,
        cert_file: str | None = None,
        key_file: str | None = None,
        client_ca_files=None,
        request_timeout_s: float = 30.0,
        request_log: bool = False,
        max_body_bytes: int = 16 * 1024 * 1024,
    ):
        self._transport = ThreadedTransport(
            ConversionRoutes(),
            host,
            port,
            cert_file=cert_file,
            key_file=key_file,
            client_ca_files=client_ca_files,
            request_timeout_s=request_timeout_s,
            request_log=request_log,
            max_body_bytes=max_body_bytes,
            name="conversion-http",
        )
        self.tls = self._transport.tls

    @property
    def port(self) -> int:
        return self._transport.port

    def start(self) -> None:
        self._transport.start()

    def stop(self) -> None:
        self._transport.stop()

    def serve_forever(self) -> None:
        self.start()
        try:
            self._transport.join()
        except KeyboardInterrupt:
            self.stop()
