"""Single-threaded event-loop HTTP/1.1 transport.

The port's copy of spark_scheduler_tpu/server/transport_async.py. The
threaded transport parks one handler thread per connection in
`PredicateBatcher.submit`, while the batcher's dispatcher thread is the
serialization point anyway. This transport replaces those threads with
ONE event loop:

  - minimal incremental HTTP/1.1 parser over a growing buffer: request
    line + headers split once, Content-Length validated with the same
    RFC 7230 strictness as the threaded stack (differing duplicates,
    non-digit forms, Transfer-Encoding all rejected), pipelined requests
    framed back-to-back from the same buffer;
  - persistent keep-alive connections with in-order response slots, so a
    pipelining client's responses never reorder even though predicate
    decisions complete asynchronously on the batcher's dispatcher thread;
  - precomputed response header blocks per (status, content-type) and ONE
    transport.write per response (headers + body in a single bytes
    object — the writev/sendmsg shape, no per-header syscalls);
  - explicit backpressure instead of unbounded thread spawn: a
    max-connections gate answered with a canned 503 + close, per-request
    max-body-bytes answered 413 with the body drained (keep-alive
    survives), pipelined-slot caps that pause the socket, and queue-depth
    load shedding in the predicate route (routing._shed_response);
  - `foundry.spark.scheduler.server.*` transport telemetry: open
    connections, keep-alive reuse ratio, parse/queue/write phase times,
    shed counts — surfaced through GET /metrics next to the batcher's.

The loop runs in one daemon thread; `routes.handle_nowait` must never
block it (the predicate route hands off to the batcher and responds from
its completion callback via call_soon_threadsafe).

With `server.ingest: native` the Python parser above is replaced per
connection by the C++ incremental framer (native/runtime.cpp IngestConn):
received bytes feed a connection-owned C++ buffer, framed-request events
come back as offset spans, and a POST /predicates body is tokenized
STRAIGHT OUT of that buffer into a predicate arena slot — the ~200 KB
candidate-name bulk never materializes as Python objects; the routing
layer receives the decoded (pod, NativeNodeNames) ticket on the Request.
Framing strictness (RFC 7230 Content-Length/TE rules, 431/400 rejects,
413 drain) is the same by construction — the conformance suite in
tests/test_torch_native.py and tests/test_torch_transport_async.py run
the same edges against both framers.
"""

from __future__ import annotations

import asyncio
import socket
import threading
import time
from collections import deque
from http import HTTPStatus
from urllib.parse import parse_qs, urlparse

from spark_scheduler_tpu_torch.server.routing import (
    BodyTooLarge,
    Request,
    Response,
    UnframeableBody,
    UnsupportedTransferEncoding,
)
from spark_scheduler_tpu_torch.server.transport_threaded import build_server_ssl_context

_MAX_HEADER_BYTES = 65536
# Pipelined requests a single connection may have awaiting responses
# before its socket is paused (resumed at the low-water mark): one
# misbehaving client cannot queue unbounded work.
_PIPELINE_HIGH_WATER = 64
_PIPELINE_LOW_WATER = 16


def _reason(status: int) -> str:
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


class _HeaderBlocks:
    """Precomputed `HTTP/1.1 <code> <reason>\\r\\nContent-Type: ...\\r\\n
    Content-Length: ` prefixes keyed by (status, content_type): the hot
    path assembles a response with one dict hit + two concats."""

    def __init__(self):
        self._blocks: dict[tuple, bytes] = {}

    def get(self, status: int, content_type: str) -> bytes:
        key = (status, content_type)
        block = self._blocks.get(key)
        if block is None:
            block = (
                f"HTTP/1.1 {status} {_reason(status)}\r\n"
                f"Content-Type: {content_type}\r\n"
                "Content-Length: "
            ).encode()
            self._blocks[key] = block
        return block


_BLOCKS = _HeaderBlocks()

_SHED_BODY = b'{"error": "connection limit reached"}'
_SHED_RESPONSE = (
    b"HTTP/1.1 503 Service Unavailable\r\n"
    b"Content-Type: application/json\r\n"
    b"Content-Length: " + str(len(_SHED_BODY)).encode() + b"\r\n"
    b"Connection: close\r\n\r\n" + _SHED_BODY
)


class Headers:
    """Case-insensitive multi-value header view with the two lookups the
    routing layer and tracer use (`get`, `get_all`)."""

    __slots__ = ("_items",)

    def __init__(self):
        self._items: list[tuple[str, str]] = []

    def add(self, name: str, value: str) -> None:
        self._items.append((name.lower(), value))

    def get(self, name: str, default=None):
        name = name.lower()
        for k, v in self._items:
            if k == name:
                return v
        return default

    def get_all(self, name: str, default=None):
        name = name.lower()
        found = [v for k, v in self._items if k == name]
        return found if found else default


def _validated_content_length(headers: Headers) -> int:
    """Same RFC 7230 3.3.2 strictness as the threaded transport's
    `_content_length` (differing duplicates = smuggling vector, 1*DIGIT
    only); raises UnframeableBody."""
    raws = headers.get_all("Content-Length") or []
    vals = {r.strip() for r in raws}
    if len(vals) > 1:
        raise UnframeableBody("invalid Content-Length")
    raw = next(iter(vals), None)
    if raw is None:
        return 0
    if raw.isascii() and raw.isdigit():
        return int(raw)
    raise UnframeableBody("invalid Content-Length")


class _Slot:
    """One pipelined request's response slot: responses are written in
    request order, whichever order the routes complete them in."""

    __slots__ = (
        "done", "resp", "close_after", "method", "path", "trace_id",
        "t_start", "t_queued",
    )

    def __init__(self, method, path, trace_id, t_start, close_after):
        self.done = False
        self.resp = None
        self.close_after = close_after
        self.method = method
        self.path = path
        self.trace_id = trace_id
        self.t_start = t_start
        self.t_queued = 0.0


# Parser states.
_HEADERS, _BODY, _DRAIN = 0, 1, 2


class _HTTPProtocol(asyncio.Protocol):
    __slots__ = (
        "_t", "_transport", "_buf", "_state", "_hdr_scan", "_shed",
        "_slots", "_closing", "_paused", "_conn_requests", "_idle_handle",
        # per-request parse state carried from headers into body/drain
        "_method", "_target", "_headers", "_need", "_body_error",
        "_keep_alive", "_close_after", "_req_t0",
        "_nconn",  # native framer connection (server.ingest: native)
    )

    def __init__(self, t: "AsyncTransport"):
        self._t = t
        self._transport = None
        self._buf = bytearray()
        self._nconn = (
            t.ingest_codec.new_conn(t.max_body_bytes, _MAX_HEADER_BYTES)
            if t.ingest_codec is not None
            else None
        )
        self._state = _HEADERS
        self._hdr_scan = 0
        self._shed = False
        self._slots: deque[_Slot] = deque()
        self._closing = False
        self._paused = False
        self._conn_requests = 0
        self._idle_handle = None
        self._method = ""
        self._target = ""
        self._headers = None
        self._need = 0
        self._body_error = None
        self._keep_alive = True
        self._close_after = False
        self._req_t0 = 0.0

    # ------------------------------------------------------------ lifecycle

    def connection_made(self, transport):
        self._transport = transport
        t = self._t
        tel = t.telemetry
        # The live-connection set is transport-owned (not the optional
        # telemetry object), so the cap holds even with metrics off.
        if len(t._protocols) >= t.max_connections:
            # Connection-level load shed: answer with a canned 503 and
            # close instead of queueing unbounded per-connection state —
            # the bounded analogue of the threaded stack's thread spawn.
            self._shed = True
            if tel is not None:
                tel.on_connection_shed()
            transport.write(_SHED_RESPONSE)
            transport.close()
            return
        if tel is not None:
            tel.on_connection_open()
        t._protocols.add(self)
        self._arm_idle_timer()

    def connection_lost(self, exc):
        if self._shed:
            return
        t = self._t
        t._protocols.discard(self)
        if t.telemetry is not None:
            t.telemetry.on_connection_close()
        if self._idle_handle is not None:
            self._idle_handle.cancel()
            self._idle_handle = None
        self._closing = True
        self._slots.clear()  # late responds see done-or-gone slots
        if self._nconn is not None:
            self._nconn.close()  # release the C++ connection buffer now
            self._nconn = None

    def close(self):
        self._closing = True
        if self._transport is not None:
            self._transport.close()

    def _arm_idle_timer(self):
        """Close connections with no COMPLETED request inside the timeout
        (the threaded transport's per-connection socket timeout slot). The
        timer re-arms on every framed request and defers while responses
        are still pending — a long device solve is not idleness."""
        timeout = self._t.request_timeout_s
        if not timeout:
            return
        if self._idle_handle is not None:
            self._idle_handle.cancel()
        self._idle_handle = self._t._loop.call_later(timeout, self._idle_fired)

    def _idle_fired(self):
        self._idle_handle = None
        if self._closing:
            return
        if self._slots:  # response in flight: not idle, re-arm
            self._arm_idle_timer()
            return
        self.close()

    # -------------------------------------------------------------- parsing

    def data_received(self, data: bytes):
        if self._shed or self._closing:
            return  # discard: drain-before-close for error'd connections
        tel = self._t.telemetry
        if tel is not None:
            tel.bytes_in += len(data)
        if self._nconn is not None:
            self._nconn.feed(data)
            self._parse_native()
            return
        self._buf += data
        self._parse()

    # ----------------------------------------------------- native framing

    def _parse_native(self):
        """Drain framed-request events from the C++ framer — the native
        twin of `_parse`. Body bytes are copied out ONLY when the route
        needs them (non-predicate routes, fast-path misses); a predicate
        body decodes in place into an arena slot."""
        from spark_scheduler_tpu_torch import native as _n
        from spark_scheduler_tpu_torch.server.ingest import is_binary_content_type

        conn = self._nconn
        codec = self._t.ingest_codec
        tel = self._t.telemetry
        while not self._closing:
            ev = conn.next()
            if ev.kind == _n.EV_NEED_MORE:
                return
            if ev.kind == _n.EV_REJECT:
                msg = {
                    _n.REJECT_HEADER_TOO_LARGE: "header block too large",
                    _n.REJECT_REQUEST_LINE: "malformed request line",
                    _n.REJECT_HEADER_LINE: "malformed header line",
                }.get(ev.err_code, "malformed request")
                self._reject_connection(ev.status, msg)
                return
            t0 = time.perf_counter()
            head = conn.read(ev.head_off, ev.head_len)
            lines = head.decode("latin-1").split("\r\n")
            headers = Headers()
            for line in lines[1:]:
                if not line:
                    continue
                name, _, value = line.partition(":")
                headers.add(name.strip(), value.strip())
            self._method = conn.read(ev.method_off, ev.method_len).decode(
                "latin-1"
            )
            self._target = conn.read(ev.target_off, ev.target_len).decode(
                "latin-1"
            )
            self._headers = headers
            self._req_t0 = t0
            self._keep_alive = bool(ev.flags & _n.FLAG_KEEP_ALIVE)
            self._close_after = bool(ev.flags & _n.FLAG_CLOSE_AFTER)
            self._body_error = None
            stop_after = False
            if ev.body_error == _n.BODY_ERR_TRANSFER_ENCODING:
                self._body_error = UnsupportedTransferEncoding(
                    "Transfer-Encoding not supported; send Content-Length"
                )
                stop_after = True  # nothing after an unframed body parses
            elif ev.body_error == _n.BODY_ERR_CONTENT_LENGTH:
                self._body_error = UnframeableBody("invalid Content-Length")
                stop_after = True
            elif ev.body_error == _n.BODY_ERR_TOO_LARGE:
                if tel is not None:
                    tel.on_body_rejected()
                self._body_error = BodyTooLarge(
                    f"request body of {ev.declared_len} bytes exceeds "
                    f"max-body-bytes={self._t.max_body_bytes}"
                )
            body = b""
            parsed = None
            attempted = False
            if self._body_error is None and ev.body_len:
                if ev.flags & _n.FLAG_PREDICATE:
                    # Zero-copy hand-off: tokenize the body out of the
                    # connection buffer into a predicate slot; only a
                    # fast-path miss copies the bytes up for json.loads.
                    attempted = True
                    parsed = codec.decode_from_conn(
                        conn,
                        binary=is_binary_content_type(
                            headers.get("Content-Type")
                        ),
                    )
                if parsed is None:
                    body = conn.read(ev.body_off, ev.body_len)
            if tel is not None:
                tel.parse_s += ev.parse_ns / 1e9
                tel.parse_samples += 1
            codec.telemetry.on_parse_ns(ev.parse_ns)
            self._dispatch(body, parsed, attempted)
            if stop_after:
                self._closing = True
                return

    def _parse(self):
        buf = self._buf
        while not self._closing:
            if self._state == _HEADERS:
                if not buf:
                    return
                idx = buf.find(b"\r\n\r\n", max(0, self._hdr_scan - 3))
                if idx < 0:
                    if len(buf) > _MAX_HEADER_BYTES:
                        self._reject_connection(431, "header block too large")
                        return
                    self._hdr_scan = len(buf)
                    return
                t0 = time.perf_counter()
                head = bytes(buf[:idx])
                del buf[: idx + 4]
                self._hdr_scan = 0
                if not self._begin_request(head, t0):
                    return
            elif self._state == _BODY:
                if len(buf) < self._need:
                    return
                body = bytes(buf[: self._need])
                del buf[: self._need]
                self._state = _HEADERS
                self._dispatch(body)
            else:  # _DRAIN: discard an oversized body, then answer 413
                take = min(len(buf), self._need)
                del buf[:take]
                self._need -= take
                if self._need:
                    return
                self._state = _HEADERS
                self._dispatch(b"")

    def _begin_request(self, head: bytes, t0: float) -> bool:
        """Parse request line + headers; set up body framing. Returns False
        when the connection is now closing (parse error)."""
        tel = self._t.telemetry
        try:
            lines = head.decode("latin-1").split("\r\n")
            parts = lines[0].split()
            if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
                raise ValueError(f"malformed request line: {lines[0]!r}")
            self._method, self._target, version = parts
            headers = Headers()
            for line in lines[1:]:
                if not line:
                    continue
                name, sep, value = line.partition(":")
                if not sep:
                    raise ValueError(f"malformed header line: {line!r}")
                headers.add(name.strip(), value.strip())
            self._headers = headers
        except (ValueError, UnicodeDecodeError) as exc:
            self._reject_connection(400, str(exc))
            return False
        self._req_t0 = t0
        conn_tok = (headers.get("Connection") or "").lower()
        if version == "HTTP/1.0":
            self._keep_alive = "keep-alive" in conn_tok
        else:
            self._keep_alive = "close" not in conn_tok
        self._close_after = False
        self._body_error = None
        self._need = 0
        # Body framing — the same contract as the threaded transport:
        # framing failures defer into the Request (the route decides 400
        # vs 404) and flag the connection to close so unread bytes never
        # desync a keep-alive follow-up.
        if headers.get("Transfer-Encoding"):
            self._body_error = UnsupportedTransferEncoding(
                "Transfer-Encoding not supported; send Content-Length"
            )
            self._close_after = True
            self._state = _HEADERS  # body never parsed; connection closes
            self._dispatch(b"")
            # Nothing after the unframed body can be parsed safely: stop
            # reading (the pending slot still flushes; later buffered
            # bytes — e.g. the chunked body itself — are discarded).
            self._closing = True
            return False
        try:
            length = _validated_content_length(headers)
        except UnframeableBody as exc:
            self._body_error = exc
            self._close_after = True
            self._state = _HEADERS
            self._dispatch(b"")
            self._closing = True
            return False
        cap = self._t.max_body_bytes
        if cap is not None and length > cap:
            if tel is not None:
                tel.on_body_rejected()
            self._body_error = BodyTooLarge(
                f"request body of {length} bytes exceeds max-body-bytes={cap}"
            )
            self._state = _DRAIN
            self._need = length
        else:
            self._state = _BODY
            self._need = length
        if tel is not None:
            tel.parse_s += time.perf_counter() - t0
            tel.parse_samples += 1
        return True

    def _reject_connection(self, status: int, message: str):
        """Protocol-level parse failure: nothing later can be framed, so
        stop parsing — but the error response rides the SLOT queue like
        any other, so pipelined responses still flush strictly in request
        order ahead of it (an out-of-band write would desync the client
        and could race a still-solving earlier request's response)."""
        from spark_scheduler_tpu_torch.server.routing import json_response

        self._closing = True  # stop parsing; data_received now discards
        slot = _Slot("-", "-", None, time.perf_counter(), True)
        self._slots.append(slot)
        self._complete(
            slot, json_response(status, {"error": str(message)}, close=True)
        )

    def _delayed_close(self):
        """Close after a short grace so bytes a client is still sending do
        not turn the close into an RST that destroys the in-flight
        response (the threaded transport's bounded drain, event-loop
        shaped: data_received keeps discarding meanwhile)."""
        self._closing = True
        loop = self._t._loop
        loop.call_later(0.05, self.close)

    # ------------------------------------------------------------ dispatch

    def _dispatch(self, body: bytes, predicate_parsed=None,
                  native_decode_attempted=False):
        parsed = urlparse(self._target)
        headers = self._headers
        req = Request(
            method=self._method,
            path=parsed.path,
            query=parse_qs(parsed.query),
            headers=headers,
            body=body,
            body_error=self._body_error,
            predicate_parsed=predicate_parsed,
            native_decode_attempted=native_decode_attempted,
        )
        self._conn_requests += 1
        tel = self._t.telemetry
        if tel is not None:
            tel.on_request(reused=self._conn_requests > 1)
        close_after = self._close_after or not self._keep_alive
        slot = _Slot(
            req.method,
            self._target,
            headers.get("X-B3-TraceId") or headers.get("b3", "").split("-")[0]
            or None,
            self._req_t0,
            close_after,
        )
        slot.t_queued = time.perf_counter()
        self._slots.append(slot)
        self._arm_idle_timer()
        loop = self._t._loop
        loop_thread = self._t._loop_thread_ident

        def respond(resp: Response):
            if threading.get_ident() == loop_thread:
                self._complete(slot, resp)
            else:
                try:
                    loop.call_soon_threadsafe(self._complete, slot, resp)
                except RuntimeError:
                    pass  # loop already closed at shutdown

        def schedule_timeout(delay_s: float, cb):
            # Only ever called from the loop thread (handle_nowait runs
            # inline in _dispatch); .cancel() from other threads is routed
            # back through the loop by the routing layer's claim().
            return _ThreadsafeTimer(loop, loop.call_later(delay_s, cb))

        try:
            self._t.routes.handle_nowait(req, respond, schedule_timeout)
        except Exception as exc:  # a raising route must not kill the loop
            from spark_scheduler_tpu_torch.server.routing import json_response

            respond(json_response(500, {"error": str(exc)}))
        # Pipelining backpressure: cap un-responded slots per connection.
        if len(self._slots) >= _PIPELINE_HIGH_WATER and not self._paused:
            self._paused = True
            try:
                self._transport.pause_reading()
            except Exception:
                pass

    def _complete(self, slot: _Slot, resp: Response):
        if slot.done or self._transport is None:
            return
        slot.done = True
        slot.resp = resp
        tel = self._t.telemetry
        if tel is not None:
            tel.queue_s += time.perf_counter() - slot.t_queued
            tel.queue_samples += 1
        self._flush()

    def _flush(self):
        slots = self._slots
        tel = self._t.telemetry
        while slots and slots[0].done:
            slot = slots.popleft()
            resp = slot.resp
            t0 = time.perf_counter()
            close = slot.close_after or resp.close
            prefix = _BLOCKS.get(resp.status, resp.content_type)
            extra = b""
            if resp.headers:
                extra = b"".join(
                    f"\r\n{name}: {value}".encode()
                    for name, value in resp.headers.items()
                )
            data = (
                prefix
                + str(len(resp.body)).encode()
                + extra
                + (b"\r\nConnection: close\r\n\r\n" if close else b"\r\n\r\n")
                + resp.body
            )
            self._transport.write(data)
            if tel is not None:
                tel.write_s += time.perf_counter() - t0
                tel.write_samples += 1
                tel.bytes_out += len(data)
            if self._t.request_log:
                self._emit_request_log(slot, resp)
            if close:
                self._delayed_close()
                return
        if self._paused and len(slots) <= _PIPELINE_LOW_WATER:
            self._paused = False
            try:
                self._transport.resume_reading()
            except Exception:
                pass

    def _emit_request_log(self, slot: _Slot, resp: Response):
        from spark_scheduler_tpu_torch.tracing import svc1log

        svc1log().request(
            slot.method,
            slot.path,
            resp.status,
            int((time.perf_counter() - slot.t_start) * 1e6),
            protocol="HTTP/1.1",
            trace_id=slot.trace_id or None,
        )


class _ThreadsafeTimer:
    """Wraps an asyncio TimerHandle so `.cancel()` is safe from any thread
    (TimerHandle.cancel is loop-thread-only; completions fire on the
    batcher's dispatcher thread)."""

    __slots__ = ("_loop", "_handle")

    def __init__(self, loop, handle):
        self._loop = loop
        self._handle = handle

    def cancel(self):
        try:
            self._loop.call_soon_threadsafe(self._handle.cancel)
        except RuntimeError:
            pass


class AsyncTransport:
    """Event-loop transport facade: binds its socket at construction
    (ephemeral ports resolve immediately, matching ThreadedTransport),
    runs the loop in one daemon thread on start()."""

    def __init__(
        self,
        routes,
        host: str = "127.0.0.1",
        port: int = 8484,
        *,
        cert_file: str | None = None,
        key_file: str | None = None,
        client_ca_files=None,
        request_timeout_s: float = 30.0,
        request_log: bool = False,
        max_body_bytes: int | None = None,
        max_connections: int = 512,
        telemetry=None,
        name: str = "scheduler-http-async",
        ingest_codec=None,
    ):
        self.routes = routes
        self.request_timeout_s = request_timeout_s
        self.request_log = request_log
        self.max_body_bytes = max_body_bytes
        self.max_connections = max_connections
        self.telemetry = telemetry
        # Native ingest lane: when set, connections frame via the C++
        # incremental parser and predicate bodies decode into arena slots
        # (see _parse_native); None = the Python parser above.
        self.ingest_codec = ingest_codec
        self._name = name
        self._ssl_ctx = build_server_ssl_context(
            cert_file, key_file, client_ca_files
        )
        self.tls = self._ssl_ctx is not None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread_ident: int | None = None
        self._server: asyncio.AbstractServer | None = None
        self._thread: threading.Thread | None = None
        self._protocols: set[_HTTPProtocol] = set()
        self._started = threading.Event()
        self._startup_error: Exception | None = None

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def set_request_log(self, enabled: bool) -> None:
        self.request_log = enabled

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=self._name
        )
        self._thread.start()
        self._started.wait(timeout=10)
        if self._startup_error is not None:
            raise self._startup_error

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        self._loop_thread_ident = threading.get_ident()
        try:
            kw = {}
            if self._ssl_ctx is not None:
                kw["ssl"] = self._ssl_ctx
                kw["ssl_handshake_timeout"] = self.request_timeout_s
            self._server = loop.run_until_complete(
                loop.create_server(
                    lambda: _HTTPProtocol(self), sock=self._sock, **kw
                )
            )
        except Exception as exc:
            self._startup_error = exc
            self._started.set()
            loop.close()
            return
        self._started.set()
        try:
            loop.run_forever()
        finally:
            for proto in list(self._protocols):
                try:
                    proto.close()
                except Exception:
                    pass
            self._server.close()
            try:
                loop.run_until_complete(self._server.wait_closed())
            except Exception:
                pass
            loop.close()

    def stop(self) -> None:
        loop = self._loop
        if loop is not None and self._startup_error is None:
            # call_soon_threadsafe also covers the start()-raced case: if
            # run_forever has not begun yet the stop callback runs the
            # moment it does, so join() below cannot hang.
            try:
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        try:
            self._sock.close()
        except OSError:
            pass

    def join(self) -> None:
        """Block until the serving thread exits (after start())."""
        if self._thread is not None:
            self._thread.join()
