"""Transport-agnostic serving core: request/response model + route tables.

The stack is layered:

  transport  (server/transport_threaded.py, server/transport_async.py)
      owns sockets, framing (Content-Length validation, Transfer-Encoding
      rejection, max-body-bytes), keep-alive discipline, TLS, timeouts,
      and writes — and hands each framed request here;
  routing    (this module)
      owns the URL table and every handler body: the extender protocol,
      state-sync, metrics/debug surfaces, conversion. Handlers are plain
      `Request -> Response` functions with no socket awareness, so both
      transports serve byte-identical routes.

The predicate route has TWO entry points: `handle` blocks the calling
thread on `PredicateBatcher.submit` (the threaded transport's model — one
handler thread per connection), while `handle_nowait` registers a
completion callback via `PredicateBatcher.submit_nowait` and returns
immediately (the async transport's model — the event loop must never block
on a device solve; the batcher's dispatcher thread was always the real
serialization point, so parked handler threads bought nothing).

The port's copy of spark_scheduler_tpu/server/routing.py, with the HA
surfaces (readiness by role, GET /debug/ha). Not here yet: the fleet
surface (ROADMAP A.9); the replay sweep counters of
/debug/trace (the port has no trace sink). /debug/profile drives
torch.profiler instead of the JAX profiler.
"""

from __future__ import annotations

import dataclasses
import json
import threading


class UnframeableBody(ValueError):
    """The request body's length cannot be determined safely (client
    framing error — mapped to a 400, and the connection is closed)."""


class UnsupportedTransferEncoding(UnframeableBody):
    """Request body uses Transfer-Encoding (no chunked decoder here)."""


class BodyTooLarge(ValueError):
    """Request body exceeds `server.max-body-bytes` — mapped to a 413
    after the transport drained the body (keep-alive framing survives)."""


def error_code(exc: Exception) -> int:
    # Client framing errors are 4xx, not server failures (a 500 would
    # count against server error budgets and invite pointless retries).
    if isinstance(exc, BodyTooLarge):
        return 413
    return 400 if isinstance(exc, UnframeableBody) else 500


@dataclasses.dataclass
class Request:
    """One framed HTTP request, transport-independent.

    `headers` is any case-insensitive mapping with `.get` (the stdlib
    email.Message for the threaded transport, the async transport's
    `Headers`). `body_error` carries a framing failure the transport
    deferred so the ROUTE decides the status (a Transfer-Encoding body on
    a 404 route must still 404 — pinned by the HTTP tests)."""

    method: str
    path: str
    query: dict
    headers: object
    body: bytes = b""
    body_error: Exception | None = None
    # Native-ingest hand-off: the transport already decoded the predicate
    # body into a (pod, node_names) ticket — the route must not re-parse.
    predicate_parsed: object = None
    # The transport already TRIED the native decoder (hit or miss): on a
    # miss the route must go straight to the Python parser instead of
    # re-tokenizing the same ~200 KB body a second time.
    native_decode_attempted: bool = False

    def json(self):
        if self.body_error is not None:
            raise self.body_error
        return json.loads(self.body or b"{}")

    def q(self, name: str):
        vals = self.query.get(name)
        return vals[0] if vals else None


@dataclasses.dataclass
class Response:
    status: int
    body: bytes
    content_type: str = "application/json"
    close: bool = False  # transport must close the connection after writing
    # Extra response headers (e.g. Retry-After on degraded-mode sheds).
    # None on the hot path — transports only walk it when set.
    headers: dict | None = None


def json_response(
    status: int, payload, close: bool = False, headers: dict | None = None
) -> Response:
    return Response(
        status, json.dumps(payload).encode(), close=close, headers=headers
    )


def text_response(status: int, text: str, content_type: str) -> Response:
    return Response(status, text.encode(), content_type)


_NOT_FOUND = {"error": "not found"}

# Canned hot-path bodies: liveness/readiness probes and 404s are hit every
# scrape interval (and 404 floods under misconfigured probes); re-running
# json.dumps per request for a constant payload was pure GIL time. Bytes
# are json.dumps-identical (pinned by tests/test_torch_ingest.py).
_NOT_FOUND_BODY = json.dumps(_NOT_FOUND).encode()
_LIVENESS_BODY = json.dumps({"status": "up"}).encode()
_READY_BODY = json.dumps({"ready": True}).encode()
_NOT_READY_BODY = json.dumps({"ready": False}).encode()
# Queue-depth 503s vary only in the depth digit — splice it in.
_SHED_PRE = b'{"error": "scheduler overloaded", "queue_depth": '


def not_found_response() -> Response:
    return Response(404, _NOT_FOUND_BODY)


# ------------------------------------------------- filter-result encoding

# Serialized FailedNodes maps keyed by (candidate-names key, message): a
# fleet's failure storms repeat the SAME uniform 10k-entry map per
# candidate list, and json.dumps of that map (~ms at 10k nodes) dominated
# the failure path. The key is the node_names object itself when it
# carries a content digest (the native lane's NativeNodeNames — hash is
# the digest, equality memcmps the blob) or a tuple of the names
# otherwise; either way a colliding hash cannot alias two lists.
_FAILED_MAP_CACHE_CAP = 32
_failed_map_cache = None


def _encode_failed_nodes(failed: dict, node_names) -> bytes:
    payload = None
    if (
        node_names is not None
        and len(failed) == len(node_names) > 8
    ):
        vals = iter(failed.values())
        first = next(vals)
        if all(v == first for v in vals) and all(
            a is b or a == b for a, b in zip(failed, node_names)
        ):
            global _failed_map_cache
            if _failed_map_cache is None:
                from spark_scheduler_tpu_torch.core.lru import LRUCache

                _failed_map_cache = LRUCache(_FAILED_MAP_CACHE_CAP)
            key_names = (
                node_names
                if getattr(node_names, "names_digest", None) is not None
                else tuple(node_names)
            )
            key = (key_names, first)
            payload = _failed_map_cache.get(key)
            if payload is None:
                payload = json.dumps(dict(failed)).encode()
                _failed_map_cache.put(key, payload)
            return payload
    return json.dumps(dict(failed)).encode()


def encode_filter_result(result, node_names=None) -> bytes:
    """ExtenderFilterResult response bytes, byte-identical to
    `json.dumps(filter_result_to_k8s(result))` (test-pinned) without
    re-serializing the hot shapes: the success body is a template splice
    around the decision bytes, and uniform failure maps reuse the cached
    per-candidate-list fragment."""
    error = ""
    if result.outcome == "failure-internal" and result.failed_nodes:
        error = next(iter(result.failed_nodes.values()))
    names = ", ".join(json.dumps(n) for n in result.node_names)
    if result.failed_nodes:
        failed = _encode_failed_nodes(result.failed_nodes, node_names)
    else:
        failed = b"{}"
    return (
        b'{"NodeNames": ['
        + names.encode()
        + b'], "FailedNodes": '
        + failed
        + b', "Error": '
        + json.dumps(error).encode()
        + b"}"
    )


class SyncRoutes:
    """Base routing contract both transports drive. Synchronous-only route
    tables implement `handle`; `handle_nowait` falls through to it."""

    def handle(self, req: Request) -> Response:
        raise NotImplementedError

    def handle_nowait(self, req: Request, respond, schedule_timeout=None):
        """CPS entry for event-loop transports: `respond(Response)` exactly
        once, now or later from any thread. `schedule_timeout(delay_s, cb)`
        (optional) arms a transport timer and returns a handle with
        `.cancel()`."""
        respond(self.handle(req))


class ConversionRoutes(SyncRoutes):
    """The standalone conversion webhook's table: liveness + POST /convert
    (the reference ships this as a second binary,
    spark-scheduler-conversion-webhook/cmd/server.go:39-54)."""

    def handle(self, req: Request) -> Response:
        if req.method == "GET" and req.path == "/status/liveness":
            return Response(200, _LIVENESS_BODY)
        if req.method == "POST" and req.path == "/convert":
            return _convert(req)
        return not_found_response()


def _convert(req: Request) -> Response:
    from spark_scheduler_tpu_torch.server.conversion import convert_review

    try:
        review = req.json()
    except Exception as exc:
        code = 413 if isinstance(exc, BodyTooLarge) else 400
        return json_response(code, {"error": str(exc)})
    return json_response(200, convert_review(review))


class SchedulerRoutes(SyncRoutes):
    """The scheduler front-end's full table (cmd/endpoints.go:28-42 plus
    the state-sync/debug/metrics surfaces — see server/http.py's module
    docstring for the route list)."""

    def __init__(self, server):
        # The owning SchedulerHTTPServer: app, registry, batcher, ready
        # event, debug_routes flag, shed/timeout knobs, transport stats.
        self._s = server

    # ------------------------------------------------------------- dispatch

    def handle(self, req: Request) -> Response:
        if req.method == "POST" and req.path == "/predicates":
            return self._predicate_blocking(req)
        return self._handle_common(req)

    def handle_nowait(self, req: Request, respond, schedule_timeout=None):
        if req.method == "POST" and req.path == "/predicates":
            self._predicate_nowait(req, respond, schedule_timeout)
            return
        respond(self._handle_common(req))

    def _handle_common(self, req: Request) -> Response:
        try:
            if req.method == "GET":
                return self._get(req)
            if req.method == "POST":
                return self._post(req)
            if req.method == "PUT":
                return self._put(req)
            if req.method == "DELETE":
                return self._delete(req)
        except Exception as exc:  # route bodies own their error mapping;
            # this is the last-resort 500 (never a dropped connection)
            return json_response(500, {"error": str(exc)})
        return not_found_response()

    # ------------------------------------------------------------------ GET

    def _get(self, req: Request) -> Response:
        s = self._s
        path = req.path
        if path == "/status/liveness":
            return Response(200, _LIVENESS_BODY)
        if path == "/status/readiness":
            degraded = getattr(s.app.solver, "degraded", None)
            deg_active = degraded is not None and degraded.active
            ha = getattr(s, "ha", None)
            if ha is not None and not s.ready.is_set() and s.app.backend.list_nodes():
                # HA replicas receive cluster state by TAILING the shared
                # backend (WAL poll / event bus), never through the
                # PUT /state/nodes that flips `ready` on a standalone
                # server — without this re-check a promoted standby would
                # answer 503 forever and kube would never route to it.
                s.ready.set()
            if ha is not None:
                # HA replica: ready = state synced AND a serving role
                # (leader / active shard member). Standbys answer 503 with
                # the role so kube routes traffic to the leader while the
                # warm replica stays probeable. Degraded mode composes:
                # a shedding leader must flip 503 too, or the load
                # balancer never drains the replica that answers every
                # predicate 503 — exactly the multi-replica topology
                # where draining elsewhere is the point of shed.
                up = (
                    s.ready.is_set()
                    and ha.is_serving()
                    and not (deg_active and degraded.sheds)
                )
                body = {"ready": up, "role": ha.role}
                if deg_active:
                    body.update(
                        degraded=True,
                        policy=degraded.policy,
                        reason=degraded.reason,
                    )
                return json_response(200 if up else 503, body)
            if deg_active:
                # Degraded mode: with the greedy policy the
                # replica still serves (host fallback) — stay ready but
                # say so; with shed it answers predicates 503, so flip
                # readiness too and let load balancers drain it while
                # probes keep watching.
                up = s.ready.is_set() and not degraded.sheds
                return json_response(
                    200 if up else 503,
                    {
                        "ready": up,
                        "degraded": True,
                        "policy": degraded.policy,
                        "reason": degraded.reason,
                    },
                )
            up = s.ready.is_set()
            return Response(
                200 if up else 503, _READY_BODY if up else _NOT_READY_BODY
            )
        if path == "/metrics":
            return self._metrics(req)
        if path == "/debug/ha" and getattr(s, "ha", None) is not None:
            # Operational surface (role, lease epoch/age, tailer counters):
            # served whenever HA is wired — failover forensics must not
            # depend on the debug-routes opt-in.
            return json_response(200, s.ha.state())
        if path == "/debug/traces" and s.debug_routes:
            from spark_scheduler_tpu_torch.tracing import tracer

            return json_response(200, {"spans": tracer().finished_spans()})
        if path == "/debug/decisions" and s.debug_routes:
            return self._debug_decisions(req)
        if path == "/debug/trace" and s.debug_routes:
            # The port has no trace sink yet (ROADMAP A.9).
            return json_response(404, {"error": "trace sink disabled"})
        if path == "/debug/state" and s.debug_routes:
            from spark_scheduler_tpu_torch.observability import debug_state_snapshot

            return json_response(200, debug_state_snapshot(s.app, server=s))
        return not_found_response()

    def _metrics(self, req: Request) -> Response:
        s = self._s
        # Compile gauges are pull-synced: the build counters of
        # ops/_build.py feed process totals, the scrape publishes.
        telemetry = getattr(s.app.solver, "telemetry", None)
        if telemetry is not None:
            telemetry.sync_compile_gauges()
        snap = s.registry.snapshot() if s.registry else {}
        fmt = req.q("format") or ""
        accept = req.headers.get("Accept", "") or ""
        from spark_scheduler_tpu_torch.observability import (
            prefers_prometheus,
            render_prometheus,
        )

        if fmt == "prometheus" or (fmt != "json" and prefers_prometheus(accept)):
            # Prometheus text exposition: the pull surface for scrape
            # stacks (`?format=` forces either way).
            extra = {
                f"foundry.spark.scheduler.predicate.batcher.{k}": v
                for k, v in s.batcher.stats().items()
                if isinstance(v, (int, float))
            }
            extra.update(
                {
                    f"foundry.spark.scheduler.server.{k}": v
                    for k, v in s.transport_stats().items()
                    if isinstance(v, (int, float))
                }
            )
            extra.update(
                {
                    f"foundry.spark.scheduler.server.ingest.{k}": v
                    for k, v in s.ingest_stats().items()
                    if isinstance(v, (int, float))
                }
            )
            recorder = getattr(s.app, "recorder", None)
            if recorder is not None:
                # ring-overflow drops are THE signal that forensic history
                # is being lost — export alongside the other ring stats
                extra.update(
                    {
                        f"foundry.spark.scheduler.recorder.{k}": v
                        for k, v in recorder.stats().items()
                        if isinstance(v, (int, float))
                    }
                )
            return text_response(
                200,
                render_prometheus(snap, extra_gauges=extra),
                "text/plain; version=0.0.4",
            )
        snap["predicate_batcher"] = s.batcher.stats()
        snap["server_transport"] = s.transport_stats()
        snap["server_ingest"] = s.ingest_stats()
        recorder = getattr(s.app, "recorder", None)
        if recorder is not None:
            snap["flight_recorder"] = recorder.stats()
        return json_response(200, snap)

    def _debug_decisions(self, req: Request) -> Response:
        recorder = getattr(self._s.app, "recorder", None)
        if recorder is None:
            return json_response(404, {"error": "flight recorder disabled"})
        try:
            limit = int(req.q("limit") or 100)
        except ValueError:
            return json_response(400, {"error": "bad limit"})
        since_seq = req.q("since_seq")
        if since_seq is not None:
            try:
                since_seq = int(since_seq)
            except ValueError:
                return json_response(400, {"error": "bad since_seq"})
        return json_response(
            200,
            {
                "decisions": recorder.query(
                    # `app_id` aliases `app` (the label the records carry)
                    app=req.q("app") or req.q("app_id"),
                    verdict=req.q("verdict"),
                    role=req.q("role"),
                    namespace=req.q("namespace"),
                    limit=limit,
                    instance_group=req.q("instance_group"),
                    since_seq=since_seq,
                ),
                "recorder": recorder.stats(),
            },
        )

    # ----------------------------------------------------------------- POST

    def _post(self, req: Request) -> Response:
        s = self._s
        if req.path == "/convert":
            return _convert(req)
        if req.path == "/debug/profile/start" and s.debug_routes:
            return self._profile_start(req)
        if req.path == "/debug/profile/stop" and s.debug_routes:
            from spark_scheduler_tpu_torch.tracing import stop_torch_profile

            try:
                out_dir = stop_torch_profile()
            except Exception as exc:
                return json_response(500, {"profiling": False, "error": str(exc)})
            return json_response(
                200 if out_dir else 409, {"profiling": False, "dir": out_dir}
            )
        return not_found_response()

    def _profile_start(self, req: Request) -> Response:
        from spark_scheduler_tpu_torch.tracing import start_torch_profile

        try:
            body = req.json()
        except (UnframeableBody, BodyTooLarge) as exc:
            # The body (with its would-be "dir") was never read — reject
            # rather than silently profiling into the default dir.
            return json_response(error_code(exc), {"error": str(exc)})
        except Exception:
            body = {}  # empty/garbage body: defaults are fine
        if not isinstance(body, dict):
            body = {}
        log_dir = body.get("dir") or "/tmp/spark-scheduler-torch-trace"
        try:
            started = start_torch_profile(log_dir)
        except Exception as exc:  # unwritable dir etc.
            return json_response(500, {"profiling": False, "error": str(exc)})
        return json_response(
            200 if started else 409, {"profiling": started, "dir": log_dir}
        )

    # ------------------------------------------------------------ PUT/DELETE

    def _put(self, req: Request) -> Response:
        from spark_scheduler_tpu_torch.server.kube_io import node_from_k8s, pod_from_k8s

        s = self._s
        try:
            if req.path == "/state/nodes":
                node = node_from_k8s(req.json())
                existing = s.app.backend.get_node(node.name)
                if existing is None:
                    s.app.backend.add_node(node)
                else:
                    s.app.backend.update("nodes", node)
                s.ready.set()  # first synced node => ready
                return json_response(200, {"applied": node.name})
            if req.path == "/state/pods":
                pod = pod_from_k8s(req.json())
                if s.app.backend.get("pods", pod.namespace, pod.name) is None:
                    s.app.backend.add_pod(pod)
                else:
                    s.app.backend.update_pod(pod)
                return json_response(200, {"applied": pod.name})
            return not_found_response()
        except Exception as exc:
            return json_response(error_code(exc), {"error": str(exc)})

    def _delete(self, req: Request) -> Response:
        s = self._s
        try:
            parts = req.path.strip("/").split("/")
            if len(parts) == 4 and parts[:2] == ["state", "pods"]:
                ns, name = parts[2], parts[3]
                pod = s.app.backend.get("pods", ns, name)
                if pod is None:
                    return json_response(404, {"error": "pod not found"})
                s.app.backend.delete_pod(pod)
                return json_response(200, {"deleted": name})
            return not_found_response()
        except Exception as exc:  # e.g. concurrent-delete race
            return json_response(500, {"error": str(exc)})

    # ----------------------------------------------------------- predicates

    def _parse_predicate(self, req: Request):
        """(pod, node_names) for POST /predicates, by lane:

          - the async transport's native framer may have decoded the body
            already (`req.predicate_parsed` — the zero-copy ticket);
          - a binary-protocol body decodes natively when the codec is
            loaded, through the pure-Python decoder otherwise;
          - a JSON body tries the native fast path on the native lane, and
            ANY deviation falls back to the Python parser below —
            identical decisions either way, the miss is telemetry.
        """
        parsed = req.predicate_parsed
        if parsed is not None:
            return parsed
        if req.body_error is not None:
            raise req.body_error
        from spark_scheduler_tpu_torch.server import ingest
        from spark_scheduler_tpu_torch.server.kube_io import extender_args_from_k8s

        codec = None
        if not req.native_decode_attempted:
            codec = getattr(self._s, "ingest_codec", None)
        if ingest.is_binary_content_type(req.headers.get("Content-Type")):
            if codec is not None:
                parsed = codec.decode_predicate_body(req.body, binary=True)
                if parsed is not None:
                    return parsed
            return ingest.decode_predicate_binary_py(req.body)
        if codec is not None:
            parsed = codec.decode_predicate_body(req.body, binary=False)
            if parsed is not None:
                return parsed
        return extender_args_from_k8s(req.json())

    def _shed_response(self) -> Response | None:
        """503 load shedding tied to the batcher queue depth: a backlog the
        window solver will never catch up on is answered immediately
        instead of parking it until the request timeout (overload would
        otherwise spiral — dead entries crowd out live ones)."""
        s = self._s
        threshold = s.shed_queue_depth
        if not threshold:
            return None
        depth = s.batcher.queue_depth()  # one lock round-trip per check
        if depth >= threshold:
            s.on_queue_shed()
            return Response(503, _SHED_PRE + str(depth).encode() + b"}")
        return None

    @staticmethod
    def _predicate_ok(pod, result, node_names=None) -> Response:
        from spark_scheduler_tpu_torch.tracing import pod_safe_params, svc1log

        svc1log().info(
            "predicate",
            outcome=result.outcome,
            nodes=list(result.node_names),
            **pod_safe_params(pod),
        )
        return Response(200, encode_filter_result(result, node_names))

    @staticmethod
    def _predicate_err(pod, exc) -> Response:
        # Internal errors ride the protocol's Error channel
        # (ExtenderFilterResult.Error) so kube-scheduler gets a well-formed
        # response instead of a dropped connection.
        from spark_scheduler_tpu_torch.faults.errors import DegradedUnavailableError
        from spark_scheduler_tpu_torch.tracing import pod_safe_params, svc1log

        if isinstance(exc, DegradedUnavailableError):
            # Degraded-mode shed: no device can serve and the
            # policy is "shed" — a 503 with Retry-After, NOT a protocol
            # Error (the kube-scheduler extender client retries 5xx; an
            # Error would fail the pod's scheduling cycle outright).
            svc1log().warn(
                "predicate shed: degraded mode",
                error=str(exc),
                retryAfterS=exc.retry_after_s,
                **pod_safe_params(pod),
            )
            return json_response(
                503,
                {"error": str(exc), "degraded": True},
                headers={"Retry-After": str(int(max(1, exc.retry_after_s)))},
            )
        svc1log().error(
            "predicate failed", error=repr(exc), **pod_safe_params(pod)
        )
        return json_response(
            200, {"NodeNames": [], "FailedNodes": {}, "Error": str(exc)}
        )

    def _predicate_blocking(self, req: Request) -> Response:
        """Threaded-transport path: the handler thread parks in
        `batcher.submit` until its window completes."""
        from spark_scheduler_tpu_torch.core.extender import ExtenderArgs
        from spark_scheduler_tpu_torch.tracing import tracer

        s = self._s
        try:
            pod, node_names = self._parse_predicate(req)
        except Exception as exc:
            return json_response(error_code(exc), {"Error": str(exc)})
        shed = self._shed_response()
        if shed is not None:
            return shed
        # Root span continues the caller's b3 trace context (the
        # witchcraft tracing middleware slot).
        with tracer().root_from_headers(
            req.headers, "predicate", pod=f"{pod.namespace}/{pod.name}"
        ) as root:
            try:
                result = s.batcher.submit(
                    ExtenderArgs(pod=pod, node_names=node_names),
                    timeout=s.request_timeout_s,
                )
            except Exception as exc:
                root.tag("outcome", "failure-internal")
                return self._predicate_err(pod, exc)
            root.tag("outcome", result.outcome)
            return self._predicate_ok(pod, result, node_names)

    def _predicate_nowait(self, req: Request, respond, schedule_timeout):
        """Event-loop path: no thread parks. The batcher invokes `done`
        from its dispatcher thread when the window completes; a transport
        timer sheds the entry at the request timeout. Exactly one respond
        fires whichever side wins the race."""
        from spark_scheduler_tpu_torch.core.extender import ExtenderArgs
        from spark_scheduler_tpu_torch.tracing import tracer

        s = self._s
        try:
            pod, node_names = self._parse_predicate(req)
        except Exception as exc:
            respond(json_response(error_code(exc), {"Error": str(exc)}))
            return
        shed = self._shed_response()
        if shed is not None:
            respond(shed)
            return
        # Detached root span: the event loop's span stack cannot hold it
        # open across interleaved requests, so it is begun/finished by
        # hand and carried to the dispatcher via the batcher entry (the
        # same trace-context slot the threaded path populates).
        ctx = tracer().root_from_headers(
            req.headers, "predicate", pod=f"{pod.namespace}/{pod.name}"
        )
        span = ctx.span
        tracer().begin_detached(span)
        lock = threading.Lock()
        state = {"sent": False, "timer": None}

        def claim() -> bool:
            """First winner (completion vs timeout) responds; the loser's
            late call is a no-op — the span, log line, and response are
            all written exactly once."""
            with lock:
                if state["sent"]:
                    return False
                state["sent"] = True
            timer = state["timer"]
            if timer is not None:
                try:
                    timer.cancel()
                except Exception:
                    pass
            return True

        def done(result, exc):
            if not claim():
                return
            # Attach the detached root while building the response so the
            # svc1log line carries the caller's trace id, exactly like the
            # threaded path's in-span logging.
            with tracer().attach(span):
                if exc is not None:
                    span.tags["outcome"] = "failure-internal"
                    resp = self._predicate_err(pod, exc)
                else:
                    span.tags["outcome"] = result.outcome
                    resp = self._predicate_ok(pod, result, node_names)
            tracer().finish_detached(span)
            respond(resp)

        try:
            entry = s.batcher.submit_nowait(
                ExtenderArgs(pod=pod, node_names=node_names),
                done,
                trace_span=span,
            )
        except Exception as exc:  # shutdown race
            done(None, exc)
            return
        if schedule_timeout is not None and s.request_timeout_s:

            def on_timeout():
                # Shed the abandoned entry if the dispatcher has not
                # claimed it; a claimed entry's solve proceeds and its
                # late `done` loses the claim race harmlessly.
                s.batcher.abandon(entry)
                if not claim():
                    return
                span.tags["outcome"] = "failure-internal"
                with tracer().attach(span):
                    resp = self._predicate_err(
                        pod, TimeoutError("predicate window timed out")
                    )
                tracer().finish_detached(span)
                respond(resp)

            state["timer"] = schedule_timeout(s.request_timeout_s, on_timeout)
