"""Thread-per-connection HTTP transport — the stdlib `ThreadingHTTPServer`
stack the scheduler served from day one, now reduced to a pure transport:
it frames requests (Content-Length validation, Transfer-Encoding rejection,
max-body-bytes) and hands them to a `routing.SyncRoutes` table; the handler
thread blocks until the route responds. Keep-alive discipline, the
drain-before-close dance, TLS wrapping, and the per-request access log all
live here — byte-compatible with the pre-split server (the raw-socket HTTP
tests pin every edge).

The port's copy of spark_scheduler_tpu/server/transport_threaded.py, the
default transport (`server.transport: threaded`). It keeps its stdlib
socket framing on BOTH `server.ingest` lanes: the native lane plugs in
downstream, where routing._parse_predicate hands predicate bodies to the
C++ decoder (server/ingest.py) instead of json.loads. The async transport
is the one that also swaps its framing for the native IngestConn. A
response goes out in two sends (header, then body), exactly as the JAX
package's threaded transport writes it.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from spark_scheduler_tpu_torch.server.routing import (
    BodyTooLarge,
    Request,
    UnframeableBody,
    UnsupportedTransferEncoding,
    json_response,
)


def build_server_ssl_context(
    cert_file: str | None, key_file: str | None, client_ca_files=None
):
    """Server-side SSLContext from install-config TLS material (reference
    server.cert-file/key-file/client-ca-files, examples/extender.yml:75-80).
    `client_ca_files` (str or list) requires client certificates signed by
    ANY of the given CAs (mTLS). None when TLS is not configured. Shared by
    both transports."""
    if not cert_file:
        return None
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_file, key_file or cert_file)
    if isinstance(client_ca_files, str):
        client_ca_files = [client_ca_files]
    for ca in client_ca_files or []:
        ctx.load_verify_locations(ca)
    if client_ca_files:
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


class _RoutedHandler(BaseHTTPRequestHandler):
    """Framing + keep-alive discipline; every verb funnels into _dispatch
    which builds a routing.Request and writes the routes' Response."""

    # Keep-alive: without this the stdlib default (HTTP/1.0) closes the
    # connection after EVERY response, so each request pays TCP connect +
    # a fresh handler thread — measured ~6 ms/call on loopback, dwarfing
    # the actual handler work. Every response sets Content-Length, which
    # HTTP/1.1 persistent connections require.
    protocol_version = "HTTP/1.1"

    # Class attributes stamped by ThreadedTransport at construction:
    routes = None
    request_log = False
    max_body_bytes: int | None = None
    telemetry = None

    def log_message(self, *args):  # stdlib's unstructured stderr lines: quiet
        pass

    def log_request(self, code="-", size="-"):
        # Called by send_response mid-request; capture the status and defer
        # the log line to handle_one_request so it carries the FULL
        # duration (handler + response write).
        self._log_status = code

    def setup(self):
        super().setup()
        self._conn_requests = 0
        tel = self.telemetry
        if tel is not None:
            tel.on_connection_open()

    def finish(self):
        tel = self.telemetry
        if tel is not None:
            tel.on_connection_close()
        super().finish()

    def _content_length(self) -> int:
        """Validated Content-Length. Raises UnframeableBody — after flagging
        the connection for drain+close — on negative or non-numeric values
        (int() would raise / read(-1) would block to EOF) and on duplicate
        headers with differing values (RFC 7230 3.3.2: reading only the
        first would leave the rest of the body to desync the next keep-alive
        request — request smuggling)."""
        raws = self.headers.get_all("Content-Length") or []
        vals = {r.strip() for r in raws}
        length = None
        if len(vals) <= 1:
            raw = next(iter(vals), None)
            if raw is None:
                return 0
            # RFC 7230: 1*DIGIT only. Bare int() also accepts '1_6', '+16'
            # and Unicode digits — forms an RFC-strict proxy in front of us
            # would frame differently (the smuggling vector again).
            if raw.isascii() and raw.isdigit():
                length = int(raw)
            else:
                length = None
        if length is None or length < 0:
            self.close_connection = True
            self._drain_on_close = True
            raise UnframeableBody("invalid Content-Length")
        return length

    def _read_body(self) -> tuple[bytes, Exception | None]:
        """Frame the request body up front. On framing failures the error
        is DEFERRED into the Request so the route decides the status (a
        Transfer-Encoding body on a 404 route still 404s); the connection
        is flagged for drain+close where the unread bytes could desync a
        keep-alive follow-up."""
        if self.headers.get("Transfer-Encoding"):
            # No chunked decoder here — without this, a chunked POST would
            # parse as an empty body and be answered with a confidently
            # wrong success. Unframeable (and Content-Length may lie
            # alongside it): don't block in read(); close after the
            # response instead.
            self.close_connection = True
            self._drain_on_close = True
            return b"", UnsupportedTransferEncoding(
                "Transfer-Encoding not supported; send Content-Length"
            )
        try:
            length = self._content_length()
        except UnframeableBody as exc:
            return b"", exc  # never read; drained at close
        cap = self.max_body_bytes
        if cap is not None and length > cap:
            if self.telemetry is not None:
                self.telemetry.on_body_rejected()
            # Drain in bounded chunks (the body never lands in one
            # allocation) so the keep-alive framing survives the 413.
            remaining = length
            while remaining > 0:
                chunk = self.rfile.read(min(65536, remaining))
                if not chunk:
                    self.close_connection = True
                    break
                remaining -= len(chunk)
            return b"", BodyTooLarge(
                f"request body of {length} bytes exceeds max-body-bytes={cap}"
            )
        return (self.rfile.read(length) if length else b""), None

    def _dispatch(self):
        body, body_error = self._read_body()
        parsed = urlparse(self.path)
        req = Request(
            method=self.command,
            path=parsed.path,
            query=parse_qs(parsed.query),
            headers=self.headers,
            body=body,
            body_error=body_error,
        )
        self._conn_requests += 1
        tel = self.telemetry
        if tel is not None:
            tel.on_request(reused=self._conn_requests > 1)
        try:
            resp = self.routes.handle(req)
        except Exception as exc:  # last resort: never a dropped connection
            resp = json_response(500, {"error": str(exc)})
        if resp.close:
            self.close_connection = True
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(resp.body)))
        if resp.headers:
            for name, value in resp.headers.items():
                self.send_header(name, str(value))
        if self.close_connection:
            # Advertise the close so a pipelining client doesn't race its
            # next request onto a socket we're about to shut.
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(resp.body)
        if tel is not None:
            tel.on_bytes_out(len(resp.body))

    do_GET = _dispatch
    do_POST = _dispatch
    do_PUT = _dispatch
    do_DELETE = _dispatch

    def parse_request(self):
        # Request-log clock: started AFTER the request line arrived, so a
        # keep-alive connection's idle wait for the client's next request
        # never counts into the logged duration.
        self._req_start = time.monotonic()
        return super().parse_request()

    def handle_one_request(self):
        self._drain_on_close = False
        self._log_status = None
        self._req_start = None
        super().handle_one_request()
        start = self._req_start
        if self.request_log and self._log_status is not None and start is not None:
            from spark_scheduler_tpu_torch.tracing import svc1log

            headers = getattr(self, "headers", None)
            try:
                status = int(self._log_status)
            except (TypeError, ValueError):  # send_error's "-" placeholder
                status = 0
            svc1log().request(
                getattr(self, "command", "-") or "-",
                getattr(self, "path", "-") or "-",
                status,
                int((time.monotonic() - start) * 1e6),
                protocol=self.protocol_version,
                trace_id=(
                    headers.get("X-B3-TraceId") or headers.get("x-b3-traceid")
                )
                if headers
                else None,
            )
        # An unframeable body (Transfer-Encoding, garbage Content-Length)
        # was answered without being read; close the connection so the
        # unread bytes can never desync a subsequent request on the
        # persistent socket.
        if self._drain_on_close:
            self.close_connection = True
            # Drain the unread body so close() sends FIN, not RST (unread
            # receive data at close resets the connection on Linux and can
            # destroy the in-flight response). The body usually rode in
            # with the headers and sits read-ahead in rfile's user-space
            # buffer — invisible to connection.recv — so consume that
            # first, non-blocking.
            try:
                self.connection.setblocking(False)
                while self.rfile.read1(65536):
                    pass
            except (OSError, ValueError):
                pass
            # Then a short timed kernel drain for bytes still in flight,
            # bounded in bytes and wall time so a client streaming forever
            # can't pin the handler thread.
            try:
                self.connection.settimeout(0.05)
                budget = 1 << 18
                deadline = time.monotonic() + 1.0
                while budget > 0 and time.monotonic() < deadline:
                    got = self.connection.recv(65536)
                    if not got:
                        break
                    budget -= len(got)
            except OSError:
                pass


class _Server(ThreadingHTTPServer):
    # Default listen backlog (5) resets connections under a concurrent
    # client burst — exactly the load the predicate batcher exists for.
    request_queue_size = 128


def _run_threaded(server: ThreadingHTTPServer, name: str) -> threading.Thread:
    thread = threading.Thread(target=server.serve_forever, daemon=True, name=name)
    thread.start()
    return thread


def _maybe_wrap_tls(
    server: ThreadingHTTPServer,
    cert_file: str | None,
    key_file: str | None,
    client_ca_files=None,
    handshake_timeout_s: float = 30.0,
) -> bool:
    """Serve HTTPS when a cert/key pair is configured — the witchcraft
    server slot. Returns True if TLS was enabled.

    The TLS handshake runs PER CONNECTION in the worker thread (via a
    finish_request override), never in the accept loop: a client that
    stalls mid-handshake ties up one bounded-timeout worker, not the whole
    server."""
    ctx = build_server_ssl_context(cert_file, key_file, client_ca_files)
    if ctx is None:
        return False
    import ssl

    orig_finish_request = server.finish_request

    def finish_request(request, client_address):
        # ThreadingMixIn calls finish_request from the per-connection worker
        # thread; the handshake happens here under a timeout.
        try:
            request.settimeout(handshake_timeout_s)
            tls_request = ctx.wrap_socket(request, server_side=True)
        except (OSError, ssl.SSLError):
            try:
                request.close()
            except OSError:
                pass
            return
        orig_finish_request(tls_request, client_address)

    server.finish_request = finish_request
    return True


class ThreadedTransport:
    """Transport facade the server front-ends drive: bind at construction
    (ephemeral ports resolve immediately), serve on start(), drain on
    stop()."""

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
        telemetry=None,
        name: str = "scheduler-http",
    ):
        # Socket read timeout per connection: a stalled client cannot pin a
        # handler thread forever (the extender protocol budget is 30 s,
        # examples/extender.yml:59).
        handler = type(
            "Handler",
            (_RoutedHandler,),
            {
                "routes": routes,
                "request_log": request_log,
                "max_body_bytes": max_body_bytes,
                "telemetry": telemetry,
                "timeout": request_timeout_s,
            },
        )
        self._handler_cls = handler
        self._name = name
        self._server = _Server((host, port), handler)
        self.telemetry = telemetry
        self.tls = _maybe_wrap_tls(
            self._server,
            cert_file,
            key_file,
            client_ca_files,
            handshake_timeout_s=request_timeout_s,
        )
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def set_request_log(self, enabled: bool) -> None:
        self._handler_cls.request_log = enabled

    def start(self) -> None:
        self._thread = _run_threaded(self._server, self._name)

    def stop(self) -> None:
        # shutdown() blocks on serve_forever()'s exit handshake — only call
        # it if serving actually started (Ctrl-C can land before start()
        # finished, e.g. during the pre-start cache-sync wait).
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
        self._server.server_close()

    def join(self) -> None:
        """Block until the serving thread exits (after start())."""
        if self._thread is not None:
            self._thread.join()
