"""The async transport: the port's against the JAX package's.

Each side is `build_scheduler_app` of its package behind its
`SchedulerHTTPServer` with `server.transport: async`, on port 0, on the
python and on the native ingest lane; the port's app runs on
`device="cpu"`. The scenarios are those of tests/test_transport_async.py
and tests/test_ingest_native.py, fed the same bytes: `/predicates` bodies
(JSON and binary) compared as bytes; raw framing cases compared as whole
response streams with the `Date` header taken out; pipelined requests
answered in order; the max-connections 503; the 413 that drains the body
and keeps the connection; queue-depth shedding; and the concurrent-client
pinned-window test of tests/test_torch_server.py on the event loop.

Tolerance: none. Every socket has its own timeout and every server stops
in its fixture's teardown.
"""

from __future__ import annotations

import json
import re
import socket
import threading
import time

import pytest

from tests.test_torch_native import load_jax_native
from tests.test_torch_server import (
    JAX,
    PORT,
    Served,
    k8s_node,
    k8s_spark_pod,
    same,
)

LANES = ("python", "native")
SOCKET_TIMEOUT = 10.0


def _served(root, lane, **cfg):
    if lane == "native":
        load_jax_native()
    return Served(root, server_transport="async", server_ingest=lane, **cfg)


@pytest.fixture(params=LANES)
def lane(request):
    return request.param


@pytest.fixture
def async_pair(lane):
    sides = [_served(JAX, lane), _served(PORT, lane)]
    yield sides
    for s in sides:
        s.stop()


def _call_raw(port, method, path, body=None, ctype="application/json"):
    """(status, body bytes) of one request on a fresh connection."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SOCKET_TIMEOUT)
    conn.request(method, path, body=body, headers={"Content-Type": ctype})
    resp = conn.getresponse()
    out = (resp.status, resp.read())
    conn.close()
    return out


def _exchange(port, data: bytes) -> bytes:
    """Send `data` on one socket and read until the server closes it."""
    s = socket.create_connection(("127.0.0.1", port), timeout=SOCKET_TIMEOUT)
    try:
        s.sendall(data)
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return buf
            buf += chunk
    finally:
        s.close()


def _undated(stream: bytes) -> bytes:
    return re.sub(rb"\r\nDate: [^\r]*", b"", stream)


# ------------------------------------------------------- predicate bodies

NAMES = [f"n{i}" for i in range(4)]


def _scenario(s, ingest):
    """tests/test_ingest_native.py's serving scenario on one server:
    every step's (status, body bytes)."""
    out = {}
    for i, n in enumerate(NAMES):
        s.call("PUT", "/state/nodes", k8s_node(n, zone=f"zone{i % 2}"))
    pod = k8s_spark_pod("app-json", "driver", "drv-json")
    s.call("PUT", "/state/pods", pod)
    out["ok_json"] = _call_raw(
        s.port, "POST", "/predicates",
        json.dumps({"Pod": pod, "NodeNames": NAMES}).encode(),
    )
    pod_b = k8s_spark_pod("app-bin", "driver", "drv-bin")
    s.call("PUT", "/state/pods", pod_b)
    out["ok_binary"] = _call_raw(
        s.port, "POST", "/predicates",
        ingest.encode_predicate_binary(pod_b, NAMES),
        ingest.BINARY_CONTENT_TYPE,
    )
    big = k8s_spark_pod("app-big", "driver", "drv-big", executors=90, exec_cpu="4")
    s.call("PUT", "/state/pods", big)
    body = json.dumps({"Pod": big, "NodeNames": NAMES}).encode()
    out["fail_1"] = _call_raw(s.port, "POST", "/predicates", body)
    out["fail_2"] = _call_raw(s.port, "POST", "/predicates", body)
    out["fail_binary"] = _call_raw(
        s.port, "POST", "/predicates",
        ingest.encode_predicate_binary(big, NAMES), ingest.BINARY_CONTENT_TYPE,
    )
    pod_e = k8s_spark_pod("app-esc", "driver", "drv-esc")
    s.call("PUT", "/state/pods", pod_e)
    out["escaped"] = _call_raw(
        s.port, "POST", "/predicates",
        b'{"Pod": ' + json.dumps(pod_e).encode()
        + b', "NodeNames": ["n0", "n\\u0031", "n2", "n3"]}',
    )
    out["garbage"] = _call_raw(s.port, "POST", "/predicates", b"{not json")
    out["bad_binary"] = _call_raw(
        s.port, "POST", "/predicates", b"SPRDxxxx", ingest.BINARY_CONTENT_TYPE
    )
    out["liveness"] = _call_raw(s.port, "GET", "/status/liveness")
    out["missing"] = _call_raw(s.port, "GET", "/no/such/route")
    return out


SCENARIO_STEPS = (
    "ok_json", "ok_binary", "fail_1", "fail_2", "fail_binary", "escaped",
    "garbage", "bad_binary", "liveness", "missing",
)


@pytest.fixture(scope="module", params=LANES)
def scenario_runs(request):
    """The scenario on both packages' async servers, one lane."""
    import importlib

    runs = {}
    for root in (JAX, PORT):
        s = _served(root, request.param)
        try:
            ingest = importlib.import_module(f"{root}.server.ingest")
            runs[root] = (_scenario(s, ingest), s.server.ingest_stats())
        finally:
            s.stop()
    return request.param, runs


@pytest.mark.parametrize("step", SCENARIO_STEPS)
def test_predicate_bodies_match_jax(scenario_runs, step):
    lane, runs = scenario_runs
    (want, _), (got, _) = runs[JAX], runs[PORT]
    assert got[step][0] == want[step][0], (lane, step)
    assert same(got[step][1], want[step][1]), (lane, step, got[step], want[step])
    if step in ("ok_json", "ok_binary"):
        assert json.loads(got[step][1])["NodeNames"]


def test_ingest_counters_match_jax(scenario_runs):
    lane, runs = scenario_runs
    (_, want), (_, got) = runs[JAX], runs[PORT]
    keys = ("ingest", "degraded", "decode_hits", "decode_fallbacks", "binary_requests")
    assert {k: got.get(k) for k in keys} == {k: want.get(k) for k in keys}
    if lane == "native":
        # The escaped-name body, the garbage JSON and the bad binary body
        # are the counted fallbacks; every well-formed body is a hit.
        assert got["decode_fallbacks"] == 3 and got["decode_hits"] == 5


# ---------------------------------------------------------------- framing

LIVE = b"GET /status/liveness HTTP/1.1\r\nHost: x\r\n\r\n"
CLOSE = b"GET /status/readiness HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
LIVE_CLOSE = b"GET /status/liveness HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"

FRAMING = {
    "pipelined": LIVE + b"GET /nope HTTP/1.1\r\nHost: x\r\n\r\n" + CLOSE,
    "garbage-after-valid": LIVE + b"TOTAL GARBAGE\r\n\r\n",
    "bad-version": b"GET /status/liveness HTTP-WRONG\r\n\r\n",
    "no-colon-header": b"GET /x HTTP/1.1\r\nno-colon-header\r\n\r\n",
    "header-too-large": b"GET / HTTP/1.1\r\nX-Junk: " + b"j" * 70_000,
    "chunked": b"POST /predicates HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n",
    "chunked-404": b"POST /nope HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n",
    "cl-conflict": b"POST /predicates HTTP/1.1\r\nContent-Length: 5\r\nContent-Length: 6\r\n\r\n",
    "cl-negative": b"POST /predicates HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
    "cl-underscore": b"POST /predicates HTTP/1.1\r\nContent-Length: 1_6\r\n\r\n",
    "too-large-drained": (
        b"POST /predicates HTTP/1.1\r\nHost: x\r\nContent-Length: 40000\r\n\r\n"
        + b"x" * 40_000 + CLOSE
    ),
    "http10": b"GET /status/liveness HTTP/1.0\r\n\r\n",
    "empty-predicate": b"POST /predicates HTTP/1.1\r\nContent-Length: 0\r\n\r\n" + CLOSE,
    "empty-te": (
        b"POST /predicates HTTP/1.1\r\nTransfer-Encoding:\r\nContent-Length: 2\r\n\r\n{}"
        + CLOSE
    ),
}


@pytest.fixture(scope="module", params=LANES)
def framing_pair(request):
    """Both packages' async servers on one lane, with max-body-bytes
    32 KiB so the drain case answers 413."""
    sides = [
        _served(JAX, request.param, max_body_bytes=32 * 1024),
        _served(PORT, request.param, max_body_bytes=32 * 1024),
    ]
    for s in sides:
        s.call("PUT", "/state/nodes", k8s_node("n0"))
    yield sides
    for s in sides:
        s.stop()


@pytest.mark.parametrize("case", sorted(FRAMING))
def test_framing_responses_match_jax(framing_pair, case):
    want, got = (_undated(_exchange(s.port, FRAMING[case])) for s in framing_pair)
    assert got.startswith(b"HTTP/1.1 "), got[:200]
    assert same(got, want), (case, got[:400], want[:400])


def test_pipelined_responses_come_back_in_request_order(async_pair):
    for s in async_pair:
        s.call("PUT", "/state/nodes", k8s_node("n0"))
    streams = [_exchange(s.port, FRAMING["pipelined"]) for s in async_pair]
    for stream in streams:
        assert re.findall(rb"HTTP/1\.1 (\d{3})", stream) == [b"200", b"404", b"200"]
    assert same(_undated(streams[1]), _undated(streams[0]))


def test_oversized_body_413_keeps_the_connection(lane):
    """413 with the body drained; the same socket serves the next request,
    on both packages, byte for byte."""
    out = []
    for root in (JAX, PORT):
        s = _served(root, lane, max_body_bytes=1024)
        try:
            sock = socket.create_connection(("127.0.0.1", s.port), timeout=SOCKET_TIMEOUT)
            big = b"x" * 4096
            sock.sendall(
                b"POST /predicates HTTP/1.1\r\nHost: x\r\nContent-Length: "
                + str(len(big)).encode() + b"\r\n\r\n" + big + LIVE_CLOSE
            )
            buf = b""
            while chunk := sock.recv(65536):
                buf += chunk
            sock.close()
            assert s.server.telemetry.stats()["body_rejections"] == 1
        finally:
            s.stop()
        statuses = re.findall(rb"HTTP/1\.1 (\d{3})", buf)
        assert statuses == [b"413", b"200"], buf[:300]
        assert buf.count(b"Connection: close") == 1  # only the last response
        out.append(_undated(buf))
    assert same(out[1], out[0])


def test_max_connections_503_and_no_hung_socket(lane):
    cap = 4
    for root in (JAX, PORT):
        s = _served(root, lane, max_connections=cap)
        try:
            admitted = [
                socket.create_connection(("127.0.0.1", s.port), timeout=SOCKET_TIMEOUT)
                for _ in range(cap)
            ]
            for sock in admitted:
                sock.sendall(LIVE)
                assert sock.recv(65536).startswith(b"HTTP/1.1 200")
            shed = []
            for _ in range(3):
                shed.append(_exchange(s.port, b""))
            for buf in shed:
                assert buf.startswith(b"HTTP/1.1 503"), buf[:80]
                assert b"connection limit reached" in buf
            for sock in admitted:
                sock.close()
            deadline = time.monotonic() + SOCKET_TIMEOUT
            while s.server.telemetry.stats()["open_connections"] and time.monotonic() < deadline:
                time.sleep(0.01)
            assert _exchange(s.port, LIVE_CLOSE).startswith(b"HTTP/1.1 200")
            stats = s.server.telemetry.stats()
            assert stats["connection_sheds"] == 3 and stats["transport"] == "async"
        finally:
            s.stop()


def test_queue_depth_shedding_503_matches_jax(lane, monkeypatch):
    out = []
    for root in (JAX, PORT):
        s = _served(root, lane, shed_queue_depth=1)
        try:
            monkeypatch.setattr(s.server.batcher, "queue_depth", lambda: 99)
            body = json.dumps({"Pod": {"metadata": {}}, "NodeNames": ["n0"]}).encode()
            out.append(_call_raw(s.port, "POST", "/predicates", body))
            assert s.server.telemetry.stats()["queue_sheds"] == 1
        finally:
            s.stop()
    assert out[1] == out[0]
    assert out[1][0] == 503
    assert json.loads(out[1][1]) == {"error": "scheduler overloaded", "queue_depth": 99}


def test_keepalive_reuse_counted(lane):
    s = _served(PORT, lane)
    try:
        sock = socket.create_connection(("127.0.0.1", s.port), timeout=SOCKET_TIMEOUT)
        for _ in range(4):
            sock.sendall(LIVE)
            assert sock.recv(65536).startswith(b"HTTP/1.1 200")
        sock.close()
        stats = s.server.telemetry.stats()
        assert stats["requests_total"] == 4 and stats["keepalive_requests"] == 3
        assert stats["ingest"] == lane
        snap = json.loads(s.call("GET", "/metrics")[1])
        assert snap["server_transport"]["transport"] == "async"
        assert snap["server_ingest"]["ingest"] == lane
    finally:
        s.stop()


# ---------------------------------------- pinned windows on the event loop


def _serve_pinned_windows_async(s, bodies):
    """tests/test_torch_server.py's `_serve_pinned_windows` on the async
    transport: bodies[0] alone in the first window, held in dispatch until
    every other body has queued, so the batcher serves [bodies[0]] and
    [bodies[1:]] whatever the threads' timing."""
    ext = s.app.extender
    orig = ext.predicate_window_dispatch
    entered, gate = threading.Event(), threading.Event()
    sizes = []

    def gated(args_list):
        sizes.append(len(args_list))
        if len(sizes) == 1:
            entered.set()
            assert gate.wait(SOCKET_TIMEOUT * 6)
        return orig(args_list)

    ext.predicate_window_dispatch = gated
    out = [None] * len(bodies)

    def post(i):
        out[i] = _call_raw(s.port, "POST", "/predicates", json.dumps(bodies[i]).encode())

    threads = [threading.Thread(target=post, args=(0,))]
    threads[0].start()
    assert entered.wait(SOCKET_TIMEOUT * 6)
    for i in range(1, len(bodies)):
        t = threading.Thread(target=post, args=(i,))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + SOCKET_TIMEOUT * 6
        while s.server.batcher.queue_depth() < i:
            assert time.monotonic() < deadline
            time.sleep(0.001)
    gate.set()
    for t in threads:
        t.join(SOCKET_TIMEOUT * 6)
    ext.predicate_window_dispatch = orig
    return out, sizes


def test_concurrent_requests_pinned_windows_match_jax(async_pair):
    import numpy as np

    rng = np.random.default_rng(7)
    names = [f"n{i}" for i in range(24)]
    for s in async_pair:
        for i, n in enumerate(names):
            assert s.call("PUT", "/state/nodes", k8s_node(n, zone=f"zone{i % 3}"))[0] == 200
    bodies = []
    for i in range(13):
        pod = k8s_spark_pod(
            f"conc-{i}", "driver", f"conc-{i}-driver",
            executors=int(rng.integers(1, 9)),
            created=f"2026-07-29T12:00:{i:02d}Z",
            exec_cpu=str(int(rng.integers(1, 4))),
        )
        for s in async_pair:
            assert s.call("PUT", "/state/pods", pod)[0] == 200
        bodies.append({"Pod": pod, "NodeNames": names})
    (want, want_sizes), (got, got_sizes) = (
        _serve_pinned_windows_async(s, bodies) for s in async_pair
    )
    assert got_sizes == want_sizes == [1, 12]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0] == 200, i
        assert same(g[1], w[1]), (i, g[1][:300], w[1][:300])
    assert sum(bool(json.loads(g[1])["NodeNames"]) for g in got) >= 2
    for s in async_pair:
        assert s.server.batcher.stats()["max_window_seen"] == 12
