"""The write-back ladder under an apiserver storm, in each package.

The twin of tests/test_chaos_soak.py's three tests. The full scheduler
runs against each package's fake apiserver with fault injection (409
conflict storms, dropped connections on writes and watch streams, a tiny
watch-history window forcing 410-Gone relists, a terminating namespace),
the port's app on `device="cpu"`. The storms are timed by the async
write-back workers, so the packages are not compared with each other:
each must meet the JAX test's assertions. No decision is lost, the
reservations converge in the apiserver once the storm passes, the
watch-synced state recovers, and a terminating namespace's create is
dropped once with no retry.
"""

from __future__ import annotations

import http.client
import importlib
import json
import threading
import time

import pytest

from tests.test_torch_kube import ROOTS, pkg, wait_until


@pytest.fixture(params=ROOTS)
def side(request):
    """One package's modules and its storm-ready apiserver (a tiny history
    window: the soak's write volume forces 410-Gone relists)."""
    m = pkg(request.param)
    m.reservations = importlib.import_module(
        f"{request.param}.models.reservations"
    )
    m.resources = importlib.import_module(f"{request.param}.models.resources")
    server = m.apiserver.FakeKubeAPIServer(history_limit=24)
    server.start()
    m.server = server
    yield m
    server.stop()


def _backend(m):
    backend = m.kbackend.KubeBackend(m.server.base_url, qps=10_000, burst=10_000)
    backend.start()
    assert backend.wait_synced(timeout=5.0)
    return backend


def _harness(m, backend, **kw):
    h = m.harness.Harness(backend=backend, **kw, **m.cpu)
    if m.cpu:
        assert h.app.solver.device.type == "cpu"
    return h


def test_chaos_soak_reservations_converge(side):
    m, server = side, side.server
    hm = m.harness
    backend = _backend(m)
    h = _harness(m, backend, binpack_algo="tightly-pack", fifo=True,
                 sync_writes=False, async_client_retry_count=25)
    h.app.start_background()
    names = [f"cn{i}" for i in range(16)]
    h.add_nodes(*(hm.new_node(n) for n in names))
    server.chaos_conflict_rate = 0.30
    server.chaos_drop_rate = 0.15
    try:
        for i in range(12):
            pods = hm.static_allocation_spark_pods(f"chaos-{i}", 2)
            result = h.schedule(pods[0], names)
            assert result.node_names, (i, result)
            for p in pods[1:]:
                assert h.schedule(p, names).node_names, (i, p.name)
    finally:
        # Keep the storm fed with no-op rewrites of converged reservations
        # until both fault kinds have fired (the fault RNG is seeded, so
        # whether a drop lands depends on the request interleaving).
        try:
            deadline = time.monotonic() + 10.0
            fed = 0
            while time.monotonic() < deadline:
                if (server.chaos_injected["conflicts"] >= 3
                        and server.chaos_injected["drops"] >= 1):
                    break
                rr = h.app.rr_cache.get("namespace", f"chaos-{fed % 12}")
                if rr is not None:
                    h.app.rr_cache.update(rr.copy())
                fed += 1
                time.sleep(0.05)
        finally:
            server.chaos_conflict_rate = 0.0
            server.chaos_drop_rate = 0.0
    assert server.chaos_injected["conflicts"] >= 3, server.chaos_injected
    assert server.chaos_injected["drops"] >= 1, server.chaos_injected
    h.app.rr_cache.flush()

    def converged():
        stored = server.collections["resourcereservations"].objects
        if len(stored) != 12:
            return False
        for i in range(12):
            wire = stored.get(("namespace", f"chaos-{i}"))
            if wire is None or len(wire["spec"]["reservations"]) != 3:
                return False
            if wire["status"]["pods"].get("driver") != f"chaos-{i}-driver":
                return False
        return True

    assert wait_until(converged, timeout=10.0), {
        "stored": sorted(server.collections["resourcereservations"].objects),
        "metrics": vars(h.app.rr_cache.client.metrics),
    }
    metrics = h.app.rr_cache.client.metrics
    assert metrics.retries > 0, vars(metrics)
    assert metrics.dropped == 0, vars(metrics)
    assert wait_until(lambda: len(backend.list_nodes()) == 16, timeout=10.0)
    h.app.stop()
    backend.stop()


def test_chaos_storm_under_concurrent_windowed_serving(side):
    m, server = side, side.server
    hm = m.harness
    backend = _backend(m)
    h = _harness(m, backend, binpack_algo="tightly-pack", fifo=True,
                 sync_writes=False, async_client_retry_count=25)
    names = [f"wn{i}" for i in range(24)]
    h.add_nodes(*(hm.new_node(n) for n in names))
    http_server = m.http.SchedulerHTTPServer(h.app, host="127.0.0.1", port=0)
    http_server.start()
    server.chaos_conflict_rate = 0.25
    server.chaos_drop_rate = 0.10
    n_clients = 10
    errors: list = []

    def client(i):
        try:
            pods = hm.static_allocation_spark_pods(f"storm-{i}", 2)
            backend.add_pod(pods[0])
            conn = http.client.HTTPConnection(
                "127.0.0.1", http_server.port, timeout=120
            )
            body = json.dumps(
                {"Pod": m.kube_io.pod_to_k8s(pods[0]), "NodeNames": names}
            ).encode()
            conn.request("POST", "/predicates", body=body)
            resp = json.loads(conn.getresponse().read())
            conn.close()
            assert resp.get("NodeNames"), (i, resp)
            backend.bind_pod(pods[0], resp["NodeNames"][0])
        except Exception as exc:  # surfaced after join
            errors.append(exc)

    try:
        threads = [
            threading.Thread(target=client, args=(i,)) for i in range(n_clients)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
    finally:
        server.chaos_conflict_rate = 0.0
        server.chaos_drop_rate = 0.0
    h.app.rr_cache.flush()
    assert wait_until(
        lambda: all(
            ("namespace", f"storm-{i}")
            in server.collections["resourcereservations"].objects
            for i in range(n_clients)
        ),
        timeout=10.0,
    )
    assert http_server.batcher.stats()["requests_served"] == n_clients
    metrics = h.app.rr_cache.client.metrics
    assert metrics.dropped == 0, vars(metrics)
    http_server.stop()
    backend.stop()


def test_namespace_terminating_create_dropped_without_retry_storm(side):
    m, server = side, side.server
    rmod, res = m.reservations, m.resources
    backend = _backend(m)
    h = _harness(m, backend, sync_writes=False)
    h.app.start_background()
    server.terminating_namespaces.add("doomed")
    rr = rmod.ResourceReservation(
        name="doomed-app",
        namespace="doomed",
        spec=rmod.ReservationSpec(
            reservations={
                "driver": rmod.Reservation(
                    node="n0",
                    resources=res.Resources.from_quantities("1", "1Gi"),
                )
            }
        ),
        status=rmod.ReservationStatus(pods={"driver": "doomed-app-driver"}),
    )
    h.app.rr_cache.create(rr)
    h.app.rr_cache.flush()
    metrics = h.app.rr_cache.client.metrics
    assert wait_until(lambda: metrics.dropped == 1, timeout=5.0), vars(metrics)
    assert metrics.retries == 0, vars(metrics)
    assert server.chaos_injected["ns_terminating"] == 1
    assert ("doomed", "doomed-app") not in server.collections[
        "resourcereservations"
    ].objects
    h.app.stop()
    backend.stop()

