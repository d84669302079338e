"""The serving front end: the port's server against the JAX package's.

Each side is `build_scheduler_app` of its package behind its
`SchedulerHTTPServer` on the threaded transport, on port 0, fed the same
k8s JSON made here (from a numpy seed where it varies). The port's app runs
on `device="cpu"`. The `/predicates` bodies, the readiness and liveness
bodies and the `/convert` body are compared as bytes; the framing cases
compare the whole response with its `Date` header taken out. The
scenarios of tests/test_extender_scenarios.py run through each package's
`testing/harness.Harness` (the app with its usage tracker, reconciler and
unschedulable marker), and a seeded workload drives the feature store's
usage-tracker branch on both.

Tolerance: none. No response body compared here names a package; where an
error string would, the one allowed difference is the package name, and
`same` below maps the port's name to the JAX package's before comparing.
"""

from __future__ import annotations

import copy
import dataclasses
import http.client
import importlib
import itertools
import json
import socket
import threading
import time
import types

import numpy as np
import pytest

from tests.test_torch_extender import NOW, STRATEGIES, Side, canon, mixed_workload
from tests.test_torch_native import load_jax_native

JAX = "spark_scheduler_tpu"
PORT = "spark_scheduler_tpu_torch"
IG_LABEL = "resource_channel"
GROUP = "batch-medium-priority"


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def same(port_bytes: bytes, jax_bytes: bytes) -> bool:
    """Byte identity, with the package name the one allowed difference."""
    return port_bytes.replace(PORT.encode(), JAX.encode()) == jax_bytes


# ----------------------------------------------------------------- servers


class Served:
    """One package's app behind its HTTP server on an ephemeral port."""

    def __init__(self, root, *, clock=lambda: NOW, debug_routes=True, raw=None,
                 **cfg):
        self.root = root
        backend_mod = _mod(root, "store.backend")
        metrics = _mod(root, "metrics")
        self.backend = backend_mod.InMemoryBackend()
        self.backend.register_crd(backend_mod.DEMAND_CRD)
        self.registry = metrics.MetricRegistry()
        config = dict(
            fifo=True,
            binpack_algo="single-az-tightly-pack",
            instance_group_label=IG_LABEL,
            sync_writes=True,
        )
        config.update(cfg)
        kw = {"device": "cpu"} if root == PORT else {}
        if root == JAX:
            # The JAX app's solver and feature store use the JAX package's
            # native runtime when it loads: load it the same way in every
            # worker (tests/test_torch_native.py `load_jax_native`).
            load_jax_native()
        install = _mod(root, "server.config").InstallConfig
        if raw is not None:
            # Synchronous write-back has no YAML key: the test setting.
            config = dataclasses.replace(install.from_dict(raw), sync_writes=True)
        else:
            config = install(**config)
        self.app = _mod(root, "server.app").build_scheduler_app(
            self.backend,
            config,
            metrics=metrics.SchedulerMetrics(self.registry, IG_LABEL),
            clock=clock,
            **kw,
        )
        self.server = _mod(root, "server.http").SchedulerHTTPServer(
            self.app, self.registry, port=0, debug_routes=debug_routes
        )
        self.server.start()

    @property
    def port(self):
        return self.server.port

    def call(self, method, path, payload=None, headers=None):
        """(status, body bytes) of one request on a fresh connection."""
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        body = json.dumps(payload).encode() if payload is not None else None
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        out = (resp.status, resp.read())
        conn.close()
        return out

    def stop(self):
        self.server.stop()


@pytest.fixture
def pair():
    sides = [Served(JAX), Served(PORT)]
    yield sides
    for s in sides:
        s.stop()


def both(pair, method, path, payload=None, headers=None):
    """Send one request to each server; the port's answer must equal the
    JAX package's byte for byte. Returns (status, parsed body)."""
    (js, jb), (ps, pb) = (s.call(method, path, payload, headers) for s in pair)
    assert ps == js, (method, path, ps, js)
    assert same(pb, jb), (method, path, pb[:300], jb[:300])
    return ps, json.loads(pb)


def k8s_node(name, zone="zone1", cpu="8", mem="8Gi", gpu="1"):
    return {
        "metadata": {
            "name": name,
            "labels": {
                "failure-domain.beta.kubernetes.io/zone": zone,
                IG_LABEL: GROUP,
            },
        },
        "status": {
            "allocatable": {"cpu": cpu, "memory": mem, "nvidia.com/gpu": gpu},
            "conditions": [{"type": "Ready", "status": "True"}],
        },
    }


def k8s_spark_pod(app_id, role, name, executors=2, created="2026-07-29T12:00:00Z",
                  exec_cpu="1"):
    return {
        "metadata": {
            "name": name,
            "namespace": "ns",
            "uid": f"uid-{name}",
            "labels": {"spark-role": role, "spark-app-id": app_id},
            "annotations": {
                "spark-driver-cpu": "1",
                "spark-driver-mem": "1Gi",
                "spark-executor-cpu": exec_cpu,
                "spark-executor-mem": "1Gi",
                "spark-executor-count": str(executors),
            },
            "creationTimestamp": created,
        },
        "spec": {
            "schedulerName": "spark-scheduler",
            "nodeSelector": {IG_LABEL: GROUP},
            "containers": [
                {
                    "name": "main",
                    "resources": {"requests": {"cpu": "1", "memory": "1Gi"}},
                }
            ],
        },
        "status": {"phase": "Pending"},
    }


# ------------------------------------------- tests/test_http_server.py


def test_gang_schedule_over_http_matches_jax(pair):
    status, body = both(pair, "GET", "/status/liveness")
    assert status == 200 and body == {"status": "up"}
    status, body = both(pair, "GET", "/status/readiness")
    assert status == 503 and body == {"ready": False}
    names = [f"n{i}" for i in range(4)]
    for n in names:
        both(pair, "PUT", "/state/nodes", k8s_node(n))
    status, body = both(pair, "GET", "/status/readiness")
    assert status == 200 and body == {"ready": True}

    driver = k8s_spark_pod("app-http", "driver", "app-http-driver")
    both(pair, "PUT", "/state/pods", driver)
    status, result = both(
        pair, "POST", "/predicates", {"Pod": driver, "NodeNames": names}
    )
    assert status == 200 and result["NodeNames"], result
    driver["spec"]["nodeName"] = result["NodeNames"][0]
    driver["status"]["phase"] = "Running"
    both(pair, "PUT", "/state/pods", driver)
    for i in range(2):
        ex = k8s_spark_pod("app-http", "executor", f"app-http-exec-{i}")
        both(pair, "PUT", "/state/pods", ex)
        status, result = both(
            pair, "POST", "/predicates", {"Pod": ex, "NodeNames": names}
        )
        assert result["NodeNames"], result
        ex["spec"]["nodeName"] = result["NodeNames"][0]
        both(pair, "PUT", "/state/pods", ex)

    big = k8s_spark_pod("app-big", "driver", "app-big-driver", executors=100)
    both(pair, "PUT", "/state/pods", big)
    status, result = both(
        pair, "POST", "/predicates", {"Pod": big, "NodeNames": names}
    )
    assert not result["NodeNames"] and set(result["FailedNodes"]) == set(names)

    # Metrics are live numbers (times), so only their shape is compared.
    # Both solvers sync their device mirrors over the event-fed dirty set
    # (`build.dirty.rows`); the series only the port books are its
    # recorded deviations (tests/test_torch_telemetry.py checks them by
    # count).
    snaps = [json.loads(s.call("GET", "/metrics")[1]) for s in pair]
    assert "foundry.spark.scheduler.requests" in snaps[1]
    solver = "foundry.spark.scheduler.solver."
    assert set(snaps[0]) - set(snaps[1]) == set()
    assert set(snaps[1]) - set(snaps[0]) == {
        solver + "device.uploads",
        solver + "device.inflight",
    }
    assert snaps[1]["predicate_batcher"]["requests_served"] == 4
    prom = pair[1].call("GET", "/metrics?format=prometheus")
    assert prom[0] == 200 and b"predicate_batcher_requests_served" in prom[1]
    # The port's /debug/state names its device and the row walk's path.
    state = json.loads(pair[1].call("GET", "/debug/state")[1])
    assert state["solver"]["device"] == "cpu"
    assert state["solver"]["window_paths"] == {"reference": 2}
    decisions = json.loads(pair[1].call("GET", "/debug/decisions")[1])
    want = json.loads(pair[0].call("GET", "/debug/decisions")[1])
    def key(d):
        return (d["pod_name"], d["role"], d["verdict"], d["node"], d["message"])

    assert [key(d) for d in decisions["decisions"]] == [
        key(d) for d in want["decisions"]
    ]


def test_non_spark_pod_rejected_matches_jax(pair):
    both(pair, "PUT", "/state/nodes", k8s_node("n0"))
    pod = {
        "metadata": {"name": "web", "namespace": "ns", "labels": {}},
        "spec": {"containers": []},
    }
    status, result = both(
        pair, "POST", "/predicates", {"Pod": pod, "NodeNames": ["n0"]}
    )
    assert status == 200 and not result["NodeNames"]


def test_garbage_predicate_body_matches_jax(pair):
    both(pair, "PUT", "/state/nodes", k8s_node("n0"))
    for payload in ({"Pod": {}, "NodeNames": ["n0"]}, {"NodeNames": ["n0"]}):
        status, result = both(pair, "POST", "/predicates", payload)
        assert result["Error"] or not result["NodeNames"]


def _raw(port, request_bytes, timeout=5.0):
    s = socket.create_connection(("127.0.0.1", port))
    s.sendall(request_bytes)
    s.settimeout(timeout)
    resp, closed = b"", False
    try:
        while True:
            chunk = s.recv(4096)
            if not chunk:
                closed = True
                break
            resp += chunk
    except socket.timeout:
        pass
    s.close()
    return resp, closed


def _undated(resp: bytes) -> bytes:
    return b"\r\n".join(
        line for line in resp.split(b"\r\n") if not line.startswith(b"Date: ")
    )


def raw_both(pair, request_bytes, timeout=5.0):
    (jr, jc), (pr, pc) = (_raw(s.port, request_bytes, timeout) for s in pair)
    assert pc == jc
    assert same(_undated(pr), _undated(jr)), (pr[:300], jr[:300])
    return pr, pc


def test_chunked_transfer_encoding_matches_jax(pair):
    payload = b'{"Pod": {}, "NodeNames": ["n0"]}'
    resp, closed = raw_both(
        pair,
        b"POST /predicates HTTP/1.1\r\nHost: x\r\n"
        b"Transfer-Encoding: chunked\r\nContent-Type: application/json\r\n\r\n"
        + hex(len(payload))[2:].encode() + b"\r\n" + payload + b"\r\n0\r\n\r\n",
    )
    assert b"Transfer-Encoding not supported" in resp and closed
    both(pair, "GET", "/status/liveness")


def test_transfer_encoding_on_no_body_route_matches_jax(pair):
    t0 = time.monotonic()
    resp, closed = raw_both(
        pair,
        b"POST /nope HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n"
        b"Content-Length: 1000000\r\n\r\n2\r\n{}\r\n0\r\n\r\n",
        timeout=10.0,
    )
    assert resp.split(b"\r\n", 1)[0] == b"HTTP/1.1 404 Not Found" and closed
    assert time.monotonic() - t0 < 10.0


@pytest.mark.parametrize(
    "headers",
    [
        b"Content-Length: -1\r\n",
        b"Content-Length: abc\r\n",
        b"Content-Length: 4\r\nContent-Length: 28\r\n",
    ],
)
def test_garbage_content_length_matches_jax(pair, headers):
    resp, closed = raw_both(
        pair,
        b"POST /predicates HTTP/1.1\r\nHost: x\r\n" + headers
        + b"\r\n" + b'{"Pod": {}, "NodeNames": []}',
    )
    assert resp.split(b"\r\n", 1)[0] == b"HTTP/1.1 400 Bad Request" and closed


def test_identical_duplicate_content_length_matches_jax(pair):
    body = b'{"Pod": {}, "NodeNames": []}'
    n = str(len(body)).encode()
    resp, _ = raw_both(
        pair,
        b"POST /predicates HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
        b"Content-Length: " + n + b"\r\nContent-Length: " + n + b"\r\n\r\n" + body,
    )
    assert resp.split(b"\r\n", 1)[0] == b"HTTP/1.1 200 OK"


def test_request_log_matches_jax(pair):
    import io

    lines = []
    for s in pair:
        tracing = _mod(s.root, "tracing")
        stream = io.StringIO()
        old = tracing.svc1log()
        tracing.set_svc1log(tracing.Svc1Logger(stream=stream))
        s.server.set_request_log(True)
        try:
            s.call("GET", "/status/liveness", headers={"X-B3-TraceId": "abc123def456"})
            s.call("GET", "/nope")
            deadline = time.monotonic() + 5.0
            while (
                stream.getvalue().count('"request.2"') < 2
                and time.monotonic() < deadline
            ):
                time.sleep(0.01)
        finally:
            s.server.set_request_log(False)
            tracing.set_svc1log(old)
        got = [
            json.loads(line)
            for line in stream.getvalue().splitlines()
            if '"request.2"' in line
        ]
        lines.append(
            [(g["method"], g["path"], g["status"], g.get("traceId")) for g in got]
        )
    assert lines[1] == lines[0]
    assert lines[1][0] == ("GET", "/status/liveness", 200, "abc123def456")
    assert lines[1][1][:3] == ("GET", "/nope", 404)


def test_convert_reservation_matches_jax(pair):
    """One v1beta1 ResourceReservation converted to v1beta2 by /convert."""
    review = {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "ConversionReview",
        "request": {
            "uid": "conv-1",
            "desiredAPIVersion": "sparkscheduler.palantir.com/v1beta2",
            "objects": [
                {
                    "apiVersion": "sparkscheduler.palantir.com/v1beta1",
                    "kind": "ResourceReservation",
                    "metadata": {"name": "app-1", "namespace": "ns"},
                    "spec": {
                        "reservations": {
                            "driver": {"node": "n1", "cpu": "1", "memory": "1Gi"},
                            "executor-1": {
                                "node": "n2", "cpu": "2", "memory": "4Gi",
                            },
                        }
                    },
                    "status": {"pods": {"driver": "app-1-driver"}},
                }
            ],
        },
    }
    status, body = both(pair, "POST", "/convert", review)
    assert status == 200
    assert body["response"]["result"]["status"] == "Success", body
    obj = body["response"]["convertedObjects"][0]
    assert obj["apiVersion"] == "sparkscheduler.palantir.com/v1beta2"


# --------------------------------- tests/test_window_serving.py:384-450


def _serve_pinned_windows(s, bodies):
    """POST bodies[0] alone, hold its window in dispatch until every other
    body has queued in order, then release: the batcher serves the windows
    [bodies[0]] and [bodies[1:]] whatever the threads' timing. Returns the
    (status, body bytes) of each request and the window sizes."""
    ext = s.app.extender
    orig = ext.predicate_window_dispatch
    entered, gate = threading.Event(), threading.Event()
    sizes = []

    def gated(args_list):
        sizes.append(len(args_list))
        if len(sizes) == 1:
            entered.set()
            assert gate.wait(60)
        return orig(args_list)

    ext.predicate_window_dispatch = gated
    out = [None] * len(bodies)

    def post(i):
        out[i] = s.call("POST", "/predicates", bodies[i])

    threads = [threading.Thread(target=post, args=(0,))]
    threads[0].start()
    assert entered.wait(60)
    for i in range(1, len(bodies)):
        t = threading.Thread(target=post, args=(i,))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 60
        while s.server.batcher.queue_depth() < i:
            assert time.monotonic() < deadline
            time.sleep(0.001)
    gate.set()
    for t in threads:
        t.join(120)
    ext.predicate_window_dispatch = orig
    return out, sizes


def test_http_concurrent_requests_pinned_windows_match_jax(pair):
    rng = np.random.default_rng(7)
    names = [f"n{i}" for i in range(24)]
    for i, n in enumerate(names):
        both(pair, "PUT", "/state/nodes", k8s_node(n, zone=f"zone{i % 3}"))
    bodies = []
    for i in range(13):
        pod = k8s_spark_pod(
            f"conc-{i}", "driver", f"conc-{i}-driver",
            executors=int(rng.integers(1, 9)),
            created=f"2026-07-29T12:00:{i:02d}Z",
            exec_cpu=str(int(rng.integers(1, 4))),
        )
        both(pair, "PUT", "/state/pods", pod)
        bodies.append({"Pod": pod, "NodeNames": names})
    runs = [_serve_pinned_windows(s, bodies) for s in pair]
    (want, want_sizes), (got, got_sizes) = runs
    assert got_sizes == want_sizes == [1, 12]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0] == 200, i
        assert same(g[1], w[1]), (i, g[1][:300], w[1][:300])
    admitted = [json.loads(g[1])["NodeNames"] for g in got]
    assert sum(bool(a) for a in admitted) >= 2
    for s in pair:
        stats = s.server.batcher.stats()
        assert stats["requests_served"] == 13 and stats["max_window_seen"] == 12
        hist = s.registry.snapshot()["foundry.spark.scheduler.predicate.window"]
        assert hist[0]["count"] == 2
    for i, a in enumerate(admitted):
        rr = pair[1].app.rr_cache.get("ns", f"conc-{i}")
        assert (rr is not None) == bool(a)


def _serve_with_node_put_in_flight(s, bodies, node_payloads):
    """Windows [bodies[0]] and [bodies[1:]] as `_serve_pinned_windows`
    serves them, with the node PUTs applied while the second window's
    dispatch is entered and the first window is still in flight (so the
    second dispatch sees the change under an un-fetched window). Returns
    the responses and how many dispatches ran (a drain re-dispatches)."""
    from_root = _mod(s.root, "core.solver")
    ext = s.app.extender
    orig = ext.predicate_window_dispatch
    entered, gate = threading.Event(), threading.Event()
    calls = []

    def gated(args_list):
        calls.append(len(args_list))
        if len(calls) == 1:
            entered.set()
            assert gate.wait(60)
        if len(calls) == 2:
            for payload in node_payloads:
                assert s.call("PUT", "/state/nodes", payload)[0] == 200
        try:
            return orig(args_list)
        except from_root.PipelineDrainRequired:
            calls.append("drain")
            raise

    ext.predicate_window_dispatch = gated
    out = [None] * len(bodies)

    def post(i):
        out[i] = s.call("POST", "/predicates", bodies[i])

    threads = [threading.Thread(target=post, args=(0,))]
    threads[0].start()
    assert entered.wait(60)
    for i in range(1, len(bodies)):
        t = threading.Thread(target=post, args=(i,))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 60
        while s.server.batcher.queue_depth() < i:
            assert time.monotonic() < deadline
            time.sleep(0.001)
    gate.set()
    for t in threads:
        t.join(120)
    ext.predicate_window_dispatch = orig
    return out, calls


NODE_CHANGES = {
    "node_added": [k8s_node("late-0", zone="zone1", cpu="32", mem="32Gi")],
    # Past the node-axis padding bucket: a full upload, so the batcher
    # must drain the in-flight window and re-dispatch.
    "nodes_added_past_bucket": [
        k8s_node(f"late-{i}", zone=f"zone{i % 2}", cpu="32", mem="32Gi")
        for i in range(8)
    ],
    "node_cordoned": [dict(k8s_node("n3"), spec={"unschedulable": True})],
    "node_resized": [k8s_node("n5", cpu="2", mem="2Gi")],
}


@pytest.mark.parametrize("change", sorted(NODE_CHANGES))
def test_node_put_under_in_flight_window_matches_jax(pair, change):
    """A PUT /state/nodes while a window is in flight: the batcher drains
    and re-dispatches where the solver asks it to (PipelineDrainRequired),
    exactly as the JAX package's batcher does, and every response is the
    JAX server's byte for byte."""
    names = [f"n{i}" for i in range(12)]
    for i, n in enumerate(names):
        both(pair, "PUT", "/state/nodes", k8s_node(n, zone=f"zone{i % 2}"))
    bodies = []
    for i in range(6):
        pod = k8s_spark_pod(
            f"d{i}", "driver", f"d{i}-driver", executors=2 + i,
            created=f"2026-07-29T12:02:{i:02d}Z",
        )
        both(pair, "PUT", "/state/pods", pod)
        bodies.append({"Pod": pod, "NodeNames": names + ["late-0"]})
    runs = [
        _serve_with_node_put_in_flight(s, bodies, NODE_CHANGES[change])
        for s in pair
    ]
    (want, want_calls), (got, got_calls) = runs
    assert got_calls == want_calls
    if change == "nodes_added_past_bucket":
        assert got_calls == [1, 5, "drain", 5]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0] == 200, i
        assert same(g[1], w[1]), (i, g[1][:300], w[1][:300])


def _served_on_cpu_shards(root, shards=4, **cfg):
    """`root`'s test Harness with install keys `cfg`; the port's app lays
    its devices on `cpu` x `shards` (`build_scheduler_app`'s
    `pool_devices=`), the JAX package's on its virtual devices."""
    h_mod = _mod(root, "testing.harness")
    h_mod._ts = itertools.count(1)
    if root == JAX:
        load_jax_native()
        return h_mod.Harness(clock=lambda: NOW, **cfg)
    import functools
    from unittest import mock

    build = functools.partial(
        h_mod.build_scheduler_app, pool_devices=["cpu"] * shards
    )
    with mock.patch.object(h_mod, "build_scheduler_app", build):
        return h_mod.Harness(clock=lambda: NOW, device="cpu", **cfg)


def _resync_pod_uids():
    """Pod uids come from a counter a package; the harness twins compare
    reservations (owner uids included) and keep both counters in
    lock-step. A test that makes one package's pods alone restarts both."""
    for root in (JAX, PORT):
        _mod(root, "models.kube")._uid_counter = itertools.count(1)


def _serve_drivers(h, root, n_nodes=8, n_drivers=4):
    h_mod = _mod(root, "testing.harness")
    h.add_nodes(*[h_mod.new_node(f"n{i}") for i in range(n_nodes)])
    names = [f"n{i}" for i in range(n_nodes)]
    return [
        canon(h.schedule(h_mod.static_allocation_spark_pods(f"f-{i}", 2)[0], names))
        for i in range(n_drivers)
    ]


@pytest.mark.parametrize(
    "key,cfg",
    [
        ("solver.mesh.node-shards",
         {"solver_mesh_groups": 1, "solver_mesh_node_shards": 4}),
        ("solver.scale-tier", {"solver_scale_tier": True}),
    ],
    ids=["solver.mesh.node-shards", "solver.scale-tier"],
)
def test_formerly_refused_key_is_served(key, cfg):
    """The two keys the port refused until it had its node-sharded engine
    (parallel/node_shards.py) build an app on `cpu` shards and serve
    drivers as the JAX package and the port's plain app do."""
    from spark_scheduler_tpu_torch.server.app import unsupported_keys
    from spark_scheduler_tpu_torch.server.config import InstallConfig

    assert unsupported_keys(InstallConfig(**cfg)) == []
    kw = dict(binpack_algo="tightly-pack", **cfg)
    h = _served_on_cpu_shards(PORT, **kw)
    solver = h.app.solver
    if "solver_mesh_node_shards" in cfg:
        assert solver.pool_size == 1 and solver._pool.slots[0].is_mesh
    else:
        assert solver._scale_tier
    got = _serve_drivers(h, PORT)
    assert solver.window_path_counts, solver.window_path_counts
    h.app.stop()
    plain = _served_on_cpu_shards(PORT, binpack_algo="tightly-pack")
    want = _serve_drivers(plain, PORT)
    plain.app.stop()
    jax_h = _served_on_cpu_shards(JAX, **kw)
    jax_got = _serve_drivers(jax_h, JAX)
    jax_h.app.stop()
    _resync_pod_uids()
    assert got == want == jax_got
    assert all(d[0] for d in got)


def test_build_oracle_and_lazy_warm_start_keys_are_served():
    """`solver.build-oracle` and `solver.lazy-warm-start` (refused or
    ignored before the port had its resident host build) reach the
    solver: the app serves, the solver builds on the native arena with
    the oracle armed, and both packages' harnesses with the oracle armed
    schedule the same drivers alike while the oracle checks every
    dirty-set mirror sync."""
    from spark_scheduler_tpu_torch.server.app import (
        build_scheduler_app,
        unsupported_keys,
    )
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.store.backend import InMemoryBackend

    config = InstallConfig(solver_build_oracle=True, solver_lazy_warm_start=False)
    assert unsupported_keys(config) == []
    app = build_scheduler_app(InMemoryBackend(), config, device="cpu")
    assert app.solver.build_oracle and not app.solver._lazy_warm_start
    assert app.solver.uses_native_arena
    app.stop()
    load_jax_native()
    outs = []
    for root in (JAX, PORT):
        h, m = _harness(
            root, binpack_algo="tightly-pack", solver_build_oracle=True
        )
        h.add_nodes(*[m.h.new_node(f"n{i}") for i in range(8)])
        names = [f"n{i}" for i in range(8)]
        outs.append([
            canon(h.schedule(m.h.static_allocation_spark_pods(f"o-{i}", 2)[0], names))
            for i in range(4)
        ])
        bs = h.app.solver.build_stats
        assert bs["oracle_checks"] >= 3 and bs["mirror_dense_syncs"] == 0, bs
        h.app.stop()
    assert outs[0] == outs[1]


ENABLED_YAML = {
    "policy": {
        "policy": {"enabled": True, "ordering": "priority", "preemption": True,
                   "max-evictions": 8, "protected-class": "system",
                   "promote-after": 0, "defrag": {"enabled": True, "budget": 4}},
    },
    "autoscaler": {
        "autoscaler": {"enabled": True, "max-cluster-size": 6,
                       "idle-ttl": "1m", "zones": ["zone1", "zone2"]},
    },
}


@pytest.mark.parametrize("block", sorted(ENABLED_YAML))
def test_enabled_policy_and_autoscaler_yaml_serve_like_jax(block):
    """`policy.enabled: true` and `autoscaler.enabled: true` (the keys the
    port refused before it had the engine and the autoscaler) build from
    YAML on both packages and serve alike: with the policy, a low gang
    admits, then a high driver that fits only after an eviction is denied
    with the eviction named; with the autoscaler, a gang too big for the
    cluster is denied with a demand, the autoscaler provisions, and the
    driver's retry admits on the new nodes. Every /predicates body and the
    /debug/state fleet and census blocks are equal across the packages."""
    raw = {"fifo": True, "binpack-algo": "tightly-pack",
           "instance-group-label": IG_LABEL, **ENABLED_YAML[block]}
    sides = [Served(JAX, raw=raw), Served(PORT, raw=raw)]
    try:
        for s in sides:
            assert (s.app.extender._policy is not None) == (block == "policy")
            assert (s.app.autoscaler is not None) == (block == "autoscaler")
            if s.app.autoscaler is not None:
                # The server started the autoscaler's loop; the test drives
                # its passes itself, on both sides at the same point.
                s.app.autoscaler.stop()
        names = ["n0", "n1"]
        for i, n in enumerate(names):
            both(sides, "PUT", "/state/nodes", k8s_node(n, zone=f"zone{i + 1}"))
        bodies = []

        def predicate(pod, node_names):
            both(sides, "PUT", "/state/pods", pod)
            status, body = both(sides, "POST", "/predicates",
                                {"Pod": pod, "NodeNames": node_names})
            assert status == 200
            bodies.append(body)
            return body

        if block == "policy":
            low = k8s_spark_pod("low", "driver", "low-driver", executors=12)
            low["metadata"]["annotations"]["spark-priority-class"] = "low"
            assert predicate(low, names)["NodeNames"]
            high = k8s_spark_pod("high", "driver", "high-driver", executors=6,
                                 created="2026-07-29T12:00:05Z")
            high["metadata"]["annotations"]["spark-priority-class"] = "high"
            denied = predicate(high, names)
            assert not denied["NodeNames"]
            assert "preempted 1" in json.dumps(denied["FailedNodes"])
            assert predicate(high, names)["NodeNames"]
        else:
            big = k8s_spark_pod("big", "driver", "big-driver", executors=24)
            assert not predicate(big, names)["NodeNames"]
            summaries = [s.app.autoscaler.run_once() for s in sides]
            assert summaries[1] == summaries[0]
            assert summaries[0]["fulfilled"] == 1
            grown = sorted(n.name for n in sides[0].backend.list_nodes())
            assert grown == sorted(n.name for n in sides[1].backend.list_nodes())
            assert len(grown) > len(names)
            assert predicate(big, grown)["NodeNames"]
        (_, js), (_, ps) = (s.call("GET", "/debug/state") for s in sides)
        jstate, pstate = json.loads(js), json.loads(ps)
        assert pstate["nodes"] == jstate["nodes"]
        assert pstate.get("census") == jstate.get("census")
        assert ("census" in pstate) == (block == "autoscaler")
        assert len(bodies) == (3 if block == "policy" else 2)
    finally:
        for s in sides:
            s.stop()


SERVED_KEYS = {
    "kube_api_url": "https://127.0.0.1:6443",
    "durable_store_path": "state.wal",
    "ha_enabled": True,
    "ha_replica_id": "replica-1",
    "ha_lease_ttl_s": 9.0,
    "ha_heartbeat_s": 1.0,
    "solver_fuse_windows": 4,
    "solver_prune_top_k": 4,
    "solver_prune_slack": 0.5,
}


def _wiring(app):
    """What `build_scheduler_app` wired: the type of every component the
    port's app has (the JAX app's autoscaler and trace writer are not
    ported), the install config, and the ingestion's reflectors
    (collection, base URL)."""
    from spark_scheduler_tpu_torch.server.app import SchedulerApp

    out = {f.name: type(getattr(app, f.name)).__name__
           for f in dataclasses.fields(SchedulerApp) if not f.name.startswith("_")}
    out["config"] = canon(app.config)[1]
    ing = app.ingestion
    if ing is not None:
        out["reflectors"] = [(r.name, r._path, r._host, r._port, r._tls)
                             for r in ing.reflectors]
    return out


@pytest.mark.parametrize("field", sorted(SERVED_KEYS))
def test_served_key_builds_like_jax(field):
    """The keys the port now serves (the apiserver URL, the durable store,
    the ha.* block, solver.fuse-windows and solver.prune-top-k / -slack)
    build an app wired as the JAX package's is."""
    config = {field: SERVED_KEYS[field], "instance_group_label": IG_LABEL}
    wired = []
    load_jax_native()
    for root in (JAX, PORT):
        kw = {"device": "cpu"} if root == PORT else {}
        app = _mod(root, "server.app").build_scheduler_app(
            _mod(root, "store.backend").InMemoryBackend(),
            _mod(root, "server.config").InstallConfig(**config),
            **kw,
        )
        wired.append(_wiring(app))
        app.stop()
    assert wired[1] == wired[0]
    assert (wired[1]["ingestion"] == "KubeIngestion") == (field == "kube_api_url")


def test_node_sharded_mesh_still_raises_naming_a6():
    """Once refused naming ROADMAP §A.6, node-sharded `solver.mesh` slots
    are served now: `{groups: 2, node-shards: 2}` from YAML builds two mesh
    slots of two `cpu` shards each, and its drivers land as a pool-less
    app's. One node shard still builds a plain pool (clamped to the one
    CPU device)."""
    from spark_scheduler_tpu_torch.server.app import (
        build_scheduler_app,
        unsupported_keys,
    )
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.store.backend import InMemoryBackend

    raw = {"solver": {"mesh": {"groups": 2, "node-shards": 2}}}
    config = InstallConfig.from_dict(raw)
    assert unsupported_keys(config) == []
    assert (config.solver_mesh_groups, config.solver_mesh_node_shards) == (2, 2)
    h = _served_on_cpu_shards(
        PORT, binpack_algo="tightly-pack", solver_mesh_groups=2,
        solver_mesh_node_shards=2,
    )
    slots = h.app.solver._pool.slots
    assert [s.is_mesh for s in slots] == [True, True]
    assert [s.label for s in slots] == ["cpu:0-0/0", "cpu:0-0/1"]
    got = _serve_drivers(h, PORT)
    assert h.app.solver.window_path_counts.get("pool", 0) >= 1
    h.app.stop()
    plain = _served_on_cpu_shards(PORT, binpack_algo="tightly-pack")
    want = _serve_drivers(plain, PORT)
    plain.app.stop()
    _resync_pod_uids()
    assert got == want
    one = {"solver": {"mesh": {"groups": 2, "node-shards": 1}},
           "server": {"degraded-mode": "shed"}}
    app = build_scheduler_app(
        InMemoryBackend(), InstallConfig.from_dict(one), device="cpu"
    )
    assert app.solver.pool_size == 1  # clamped to the one CPU device
    assert app.solver.degraded.policy == "shed"
    app.stop()


def test_supported_defaults_build_and_match_jax_config():
    """Every default builds; the port parses YAML to the JAX package's
    InstallConfig, field for field."""
    from spark_scheduler_tpu.server.config import InstallConfig as JaxConfig
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.server.config import InstallConfig
    from spark_scheduler_tpu_torch.store.backend import InMemoryBackend

    raw = {
        "fifo": True,
        "binpack-algo": "az-aware-tightly-pack",
        "server": {"port": 9000, "degraded-mode": "greedy"},
        "solver": {"device-pool": 1, "fuse-windows": 1, "delta-statics": False},
        "flight-recorder": True,
        "predicate-max-window": 16,
    }
    port_cfg, jax_cfg = InstallConfig.from_dict(raw), JaxConfig.from_dict(raw)
    assert canon(port_cfg)[1] == canon(jax_cfg)[1]
    app = build_scheduler_app(InMemoryBackend(), port_cfg, device="cpu")
    assert app.solver.device.type == "cpu"
    assert app.solver.telemetry is not None
    # The JAX package always wires the controller; so does the port now.
    assert app.solver.degraded.policy == "greedy"
    assert app.solver.pool_size == 1
    assert app.reservation_manager.usage_tracker is not None
    assert app.recorder is not None
    app.stop()


def test_app_and_cli_default_to_the_card():
    """`build_scheduler_app` and `python -m spark_scheduler_tpu_torch
    server` ask for CUDA by default and raise without a card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    from spark_scheduler_tpu_torch.__main__ import main
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.store.backend import InMemoryBackend

    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        build_scheduler_app(InMemoryBackend())
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        main(["server", "--port", "0"])


def test_print_crds_matches_jax(capsys):
    from spark_scheduler_tpu.__main__ import main as jax_main
    from spark_scheduler_tpu_torch.__main__ import main

    out = []
    for fn in (jax_main, main):
        assert fn(["print-crds", "--conversion-webhook-url", "https://x/convert"]) == 0
        out.append(capsys.readouterr().out)
    assert out[1] == out[0] and "ResourceReservation" in out[1]


def test_debug_profile_routes_drive_torch_profiler(tmp_path):
    s = Served(PORT)
    try:
        d = str(tmp_path / "trace")
        status, body = s.call("POST", "/debug/profile/start", {"dir": d})
        assert status == 200 and json.loads(body) == {"profiling": True, "dir": d}
        assert s.call("POST", "/debug/profile/start", {"dir": d})[0] == 409
        s.call("GET", "/status/liveness")
        status, body = s.call("POST", "/debug/profile/stop")
        assert status == 200 and json.loads(body)["dir"] == d
        assert (tmp_path / "trace" / "trace.json").exists()
        assert s.call("POST", "/debug/profile/stop")[0] == 409
    finally:
        s.stop()


# ---------------------------------- tests/test_extender_scenarios.py


def _harness(root, **kw):
    """The package's testing.Harness on a fixed clock, fixture timestamps
    restarted, so both packages see the same pods."""
    h_mod = _mod(root, "testing.harness")
    h_mod._ts = itertools.count(1)
    if root == PORT:
        kw["device"] = "cpu"
    h = h_mod.Harness(clock=lambda: NOW, **kw)
    m = types.SimpleNamespace(
        h=h_mod,
        ext=_mod(root, "core.extender"),
        kube=_mod(root, "models.kube"),
        res=_mod(root, "models.resources"),
    )
    return h, m


def _state(h):
    def by_name(kind):
        return sorted(
            (canon(o) for o in h.backend.list(kind)),
            key=lambda c: (c[1]["namespace"], c[1]["name"]),
        )

    return {
        "reservations": by_name("resourcereservations"),
        "soft": canon(h.soft_reservations()),
        "demands": by_name("demands"),
    }


def _extra_pod(m, like, name):
    return m.kube.Pod(
        name=name,
        namespace="namespace",
        labels=dict(like.labels),
        scheduler_name=like.scheduler_name,
        node_selector=dict(like.node_selector),
        containers=[
            m.kube.Container(requests=m.res.Resources.from_quantities("1", "1Gi"))
        ],
    )


def sc_gang_then_extra_executor(h, m, log):
    h.add_nodes(m.h.new_node("n1"))
    pods = m.h.static_allocation_spark_pods("app-1", 2)
    log(h.schedule_app(pods, ["n1"]))
    log(h.schedule(_extra_pod(m, pods[1], "app-1-exec-extra"), ["n1"]))


def sc_replace_reservation_after_termination(h, m, log):
    h.add_nodes(m.h.new_node("n1"))
    pods = m.h.static_allocation_spark_pods("app-2", 2)
    log(h.schedule_app(pods, ["n1"]))
    h.terminate_pod(pods[2])
    log(h.schedule(_extra_pod(m, pods[2], "app-2-exec-replacement"), ["n1"]))


def sc_retries_are_idempotent(h, m, log):
    h.add_nodes(m.h.new_node("n1"), m.h.new_node("n2"))
    pods = m.h.static_allocation_spark_pods("app-3", 1)
    log(h.schedule_app(pods, ["n1", "n2"]))
    for p in pods:
        log(h.extender.predicate(m.ext.ExtenderArgs(pod=p, node_names=["n1", "n2"])))


def sc_gang_does_not_fit_creates_demand(h, m, log):
    h.add_nodes(m.h.new_node("n1"))
    pods = m.h.static_allocation_spark_pods("app-5", 100)
    log(h.schedule(pods[0], ["n1"]))
    for i in range(2, 15):
        h.add_nodes(m.h.new_node(f"n{i}"))
    log(h.schedule(pods[0], [f"n{i}" for i in range(1, 15)]))


def sc_fifo_earlier_driver_blocks(h, m, log):
    h.add_nodes(m.h.new_node("n1"))
    big = m.h.static_allocation_spark_pods("app-old", 20)
    small = m.h.static_allocation_spark_pods("app-new", 1)
    h.add_pods(*big)
    log(h.schedule(big[0], ["n1"]))
    log(h.schedule(small[0], ["n1"]))


def sc_fifo_age_gate_skips_young_drivers(h, m, log):
    h.app.config.fifo_config.enforce_after_pod_age_s = 3600.0
    h.extender._config.fifo_config.enforce_after_pod_age_s = 3600.0
    h.add_nodes(m.h.new_node("n1"))
    big = m.h.static_allocation_spark_pods("app-old2", 20)
    big[0].creation_timestamp = NOW - 10
    small = m.h.static_allocation_spark_pods("app-new2", 1)
    small[0].creation_timestamp = NOW
    h.add_pods(*big)
    log(h.schedule(big[0], ["n1"]))
    log(h.schedule(small[0], ["n1"]))


def sc_dynamic_allocation_soft_reservation(h, m, log):
    h.add_nodes(m.h.new_node("n1"))
    driver, exec1, exec2 = m.h.dynamic_allocation_spark_pods("app-da", 1, 2)
    for p in (driver, exec1, exec2):
        log(h.schedule(p, ["n1"]))
    log(h.schedule(_extra_pod(m, exec1, "app-da-exec-3"), ["n1"]))


def sc_dynamic_allocation_compaction(h, m, log):
    h.add_nodes(m.h.new_node("n1"))
    driver, exec1, exec2 = m.h.dynamic_allocation_spark_pods("app-da2", 1, 2)
    for p in (driver, exec1, exec2):
        log(h.schedule(p, ["n1"]))
    h.delete_pod(exec1)
    probe = m.h.static_allocation_spark_pods("probe", 0)
    log(h.schedule(probe[0], ["n1"]))


def sc_unschedulable_marker(h, m, log):
    h.add_nodes(m.h.new_node("n1"), m.h.new_node("n2"))
    small = m.h.static_allocation_spark_pods("app-small", 2)[0]
    big = m.h.static_allocation_spark_pods("app-big", 100)[0]
    gpu = m.h.static_allocation_spark_pods("app-gpu", 2)[0]
    gpu.annotations["spark-executor-nvidia.com/gpu"] = "2"
    h.add_pods(small, big, gpu)
    marker = h.app.unschedulable_marker
    log([marker.does_pod_exceed_cluster_capacity(p) for p in (small, big, gpu)])
    # The scan marks drivers older than the timeout (600 s by default).
    for p in (small, big, gpu):
        p.creation_timestamp = NOW - 3600
        h.backend.update_pod(p)
    marker.scan_for_unschedulable_pods()
    log([
        [
            (c.type, c.status)
            for c in h.backend.get("pods", p.namespace, p.name).conditions
        ]
        for p in (small, big, gpu)
    ])


def sc_failover_rebuilds_reservations(h, m, log):
    h.add_nodes(m.h.new_node("n1"))
    pods = m.h.static_allocation_spark_pods("app-fo", 2)
    log(h.schedule_app(pods, ["n1"]))
    h.app.rr_cache.delete("namespace", "app-fo")
    h.app.rr_cache.flush()
    log(h.get_reservation("namespace", "app-fo"))
    h.app.reconciler.sync_resource_reservations_and_demands()
    log(h.get_reservation("namespace", "app-fo"))


def sc_failover_rebuilds_soft_reservations(h, m, log):
    h.add_nodes(m.h.new_node("n1"))
    driver, exec1, exec2 = m.h.dynamic_allocation_spark_pods("app-fo2", 1, 2)
    for p in (driver, exec1, exec2):
        log(h.schedule(p, ["n1"]))
    h.app.soft_store.remove_driver_reservation("app-fo2")
    h.app.reconciler.sync_resource_reservations_and_demands()
    log(h.soft_reservations())


def sc_fifo_mixed_queue(h, m, log):
    h.add_nodes(*(m.h.new_node(f"n{i}") for i in range(4)))
    nodes = [f"n{i}" for i in range(4)]
    outcomes = []
    a = m.h.static_allocation_spark_pods("app-a", 2)
    outcomes.append(h.schedule(a[0], nodes))
    b = m.h.static_allocation_spark_pods("app-b", 30)
    h.add_pods(b[0])
    c = m.h.static_allocation_spark_pods("app-c", 1)
    outcomes.append(h.schedule(c[0], nodes))
    h.delete_pod(b[0])
    outcomes.append(h.schedule(c[0], nodes))
    outcomes += h.schedule_app(a[1:] + c[1:], nodes)
    log(outcomes)
    log([r.outcome for r in outcomes])


SCENARIOS = {
    f.__name__[3:]: f
    for f in (
        sc_gang_then_extra_executor,
        sc_replace_reservation_after_termination,
        sc_retries_are_idempotent,
        sc_gang_does_not_fit_creates_demand,
        sc_fifo_earlier_driver_blocks,
        sc_fifo_age_gate_skips_young_drivers,
        sc_dynamic_allocation_soft_reservation,
        sc_dynamic_allocation_compaction,
        sc_unschedulable_marker,
        sc_failover_rebuilds_reservations,
        sc_failover_rebuilds_soft_reservations,
        sc_fifo_mixed_queue,
    )
}


def run_harness_both(scenario, **kw):
    logs = []
    for root in (JAX, PORT):
        h, m = _harness(root, **kw)
        log = []
        scenario(h, m, lambda x: log.append((canon(x), _state(h))))
        h.app.stop()
        logs.append(log)
    want, got = logs
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], f"step {i}: results differ"
        assert g[1] == w[1], f"step {i}: reservations or demands differ"
    return got


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_harness_scenario_matches_jax(name):
    run_harness_both(SCENARIOS[name])


@pytest.mark.parametrize("algo", STRATEGIES)
def test_all_binpack_algos_through_harness_match_jax(algo):
    def scenario(h, m, log):
        h.add_nodes(m.h.new_node("n1", zone="zone1"), m.h.new_node("n2", zone="zone2"))
        res = h.schedule_app(m.h.static_allocation_spark_pods(f"app-{algo}", 3), ["n1", "n2"])
        log(res)
        log([r.outcome for r in res])

    got = run_harness_both(scenario, binpack_algo=algo)
    assert got[1][0] == ["success"] * 4


@pytest.mark.parametrize("batched", [True, False])
def test_harness_fifo_mixed_queue_batched_and_sequential(batched):
    got = run_harness_both(
        SCENARIOS["fifo_mixed_queue"],
        binpack_algo="tightly-pack",
        batched_admission=batched,
    )
    assert got[1][0][:3] == ["success", "failure-earlier-driver", "success"]


# ------------------------------- the feature store's usage-tracker branch


class AppSide(Side):
    """`tests/test_torch_extender.Side` over a whole app: the package's
    testing.Harness, so the reservation manager carries the
    ReservedUsageTracker the app attaches and the feature store reads its
    deltas (the branch `Side`'s hand wiring leaves out)."""

    def __init__(self, root, *, binpack="single-az-tightly-pack", fifo=True):
        self.root = root
        self.kube = _mod(root, "models.kube")
        self.resources = _mod(root, "models.resources")
        self.sparkpods = _mod(root, "core.sparkpods")
        self.ext_mod = _mod(root, "core.extender")
        kw = {"device": "cpu"} if root == PORT else {}
        h = _mod(root, "testing.harness").Harness(
            binpack_algo=binpack, fifo=fifo, clock=lambda: NOW, **kw
        )
        self.app = h.app
        self.backend = h.backend
        self.soft_store = h.app.soft_store
        self.extender = h.app.extender
        self.solver = h.app.solver
        self._ts = itertools.count(1)
        self.log = []


def _run_app_sides(scenario, **kw):
    sides = [AppSide(root, **kw) for root in (JAX, PORT)]
    for s in sides:
        scenario(s)
    want, got = sides[0].log, sides[1].log
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], f"request {i}: results differ"
        assert g[1] == w[1], f"request {i}: reservations or demands differ"
    return sides


@pytest.mark.parametrize("strategy", ["tightly-pack", "single-az-tightly-pack",
                                      "distribute-evenly"])
@pytest.mark.parametrize("windows", [True, False])
def test_usage_tracker_branch_matches_jax(strategy, windows):
    """Reservation writes, soft reservations (dynamic-allocation extras),
    executor deaths and pod deletions through the app's usage tracker: the
    port's decisions and state equal the JAX app's after every request,
    and the feature store took the tracker's deltas, not the map walk."""
    seed = STRATEGIES.index(strategy)
    jax_side, port_side = _run_app_sides(
        lambda h: mixed_workload(h, seed, windows), binpack=strategy
    )
    stats = [s.extender.features.stats() for s in (jax_side, port_side)]
    assert port_side.app.reservation_manager.usage_tracker is not None
    assert stats[1]["usage_patches"] > 0
    for key in ("usage_refreshes", "usage_patches", "roster_rebuilds"):
        assert stats[1][key] == stats[0][key], key
    for s in (jax_side, port_side):
        s.app.stop()


def test_usage_tracker_pipelined_windows_match_jax():
    """Pipelined windows (dispatch k+1 before completing k) over the
    tracker, with a deletion and a soft reservation between them."""

    def scenario(h):
        names = [f"n{i}" for i in range(6)]
        h.add_nodes(*(h.node(n, zone=f"zone{i % 2}") for i, n in enumerate(names)))
        apps = [h.spark_pods(f"p{i}", 2, dynamic=(1, 3) if i % 2 else None)
                for i in range(6)]
        for pods in apps:
            h.add_pods(pods[0])
        t1 = h.dispatch([h.args(p[0], names) for p in apps[:3]])
        t2 = h.dispatch([h.args(p[0], names) for p in apps[3:]])
        for pods, res in zip(apps[:3], h.complete(t1)):
            h.bind(pods[0], res)
        for pods, res in zip(apps[3:], h.complete(t2)):
            h.bind(pods[0], res)
        for pods in apps:
            for p in pods[1:]:
                h.schedule(p, names)
        h.delete_pod(apps[0][1])
        late = h.spark_pods("late", 3)
        h.add_pods(late[0])
        t3 = h.dispatch([h.args(late[0], names)])
        h.complete(t3)

    sides = _run_app_sides(scenario, binpack="tightly-pack")
    for s in sides:
        s.app.stop()


# ---------------- the marker's solo pack between a dispatch and its fetch


def test_marker_pack_between_dispatch_and_fetch_leaves_window_unchanged():
    """The unschedulable-pod marker runs `build_tensors` + `pack` on its own
    thread while the batcher's windows are in flight. A marker pack (over a
    node the window never saw, so the shared registry grows) between a
    window's dispatch and its fetch leaves that window's decisions, and the
    next window's, as they are without it."""

    def scenario(side, with_marker):
        names = [f"n{i}" for i in range(8)]
        side.add_nodes(*(side.node(n, zone=f"zone{i % 2}") for i, n in enumerate(names)))
        apps = [side.spark_pods(f"w{i}", 1 + i % 4) for i in range(8)]
        for pods in apps:
            side.add_pods(pods[0])
        t1 = side.dispatch([side.args(p[0], names) for p in apps[:4]])
        t2 = side.dispatch([side.args(p[0], names) for p in apps[4:]])
        if with_marker:
            marker = side.app.unschedulable_marker
            side.add_nodes(side.node("extra", zone="zone1", cpu="64", mem="64Gi"))
            probe = side.spark_pods("probe", 30)[0]
            side.add_pods(probe)
            exceeds = marker.does_pod_exceed_cluster_capacity(probe)
            assert exceeds is False
        else:
            side.add_nodes(side.node("extra", zone="zone1", cpu="64", mem="64Gi"))
        out = side.complete(t1) + side.complete(t2)
        return [canon(r) for r in out]

    want = scenario(AppSide(PORT), False)
    got = scenario(AppSide(PORT), True)
    assert got == want
    jax = scenario(AppSide(JAX), True)
    assert got == jax


def test_marker_thread_concurrent_with_batcher_matches_serial():
    """The marker's packs on another thread, racing the batcher's window
    dispatches and fetches, change no decision: the served bodies equal a
    run without the racing thread."""
    rng = np.random.default_rng(11)
    names = [f"n{i}" for i in range(16)]
    pods = [
        k8s_spark_pod(f"r{i}", "driver", f"r{i}-driver",
                      executors=int(rng.integers(1, 6)),
                      created=f"2026-07-29T12:01:{i:02d}Z")
        for i in range(10)
    ]
    bodies = [{"Pod": p, "NodeNames": names} for p in pods]
    out = []
    for race in (False, True):
        s = Served(PORT)
        try:
            for i, n in enumerate(names):
                s.call("PUT", "/state/nodes", k8s_node(n, zone=f"zone{i % 2}"))
            for p in pods:
                s.call("PUT", "/state/pods", p)
            stop = threading.Event()
            marker = s.app.unschedulable_marker
            probe = s.backend.get("pods", "ns", "r9-driver")

            def hammer():
                while not stop.is_set():
                    marker.does_pod_exceed_cluster_capacity(copy.deepcopy(probe))

            t = threading.Thread(target=hammer) if race else None
            if t:
                t.start()
            try:
                got, sizes = _serve_pinned_windows(s, bodies)
            finally:
                stop.set()
                if t:
                    t.join(30)
            out.append((got, sizes))
        finally:
            s.stop()
    assert out[1] == out[0]
