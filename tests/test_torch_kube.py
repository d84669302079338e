"""Apiserver watch ingestion and the apiserver backend: the port's kube/
against the JAX package's.

The scenarios of tests/test_kube_watch.py and tests/test_kube_backend.py run
once per package. Each package gets its own `FakeKubeAPIServer`, and the
same k8s JSON (node sizes, zones and gang shapes drawn with numpy from a
seed) goes into both. After every scenario the backend's nodes, pods,
reservations and demands and the objects the apiserver holds must be
equal across the two packages; HTTP statuses, watch events and `/predicates`
bodies are compared as they are. The cross-feed tests point one package's
reflector and `KubeBackend` at the other package's apiserver. The port's
apps run on `device="cpu"`.

Tolerance: none.
"""

from __future__ import annotations

import copy
import http.client
import importlib
import itertools
import json
import subprocess
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from tests.test_torch_extender import canon
from tests.test_torch_native import load_jax_native

JAX = "spark_scheduler_tpu"
PORT = "spark_scheduler_tpu_torch"
ROOTS = (JAX, PORT)
IG_LABEL = "resource_channel"
GROUP = "batch-medium-priority"
CREATED = 1_000.0  # creationTimestamp of every pod (seconds)
CLOCK = 2_000.0  # the apps' fixed clock: informer delay = CLOCK - CREATED


def pkg(root):
    """One package's modules, and the keyword that puts its solver on the
    CPU (the JAX package has none)."""

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    if root == JAX:
        # The JAX app uses the JAX package's native runtime when it loads:
        # load it the same way in every worker.
        load_jax_native()
    m = types.SimpleNamespace(root=root)
    for attr, name in (
        ("apiserver", "kube.apiserver"),
        ("reflector", "kube.reflector"),
        ("kbackend", "kube.backend"),
        ("backend", "store.backend"),
        ("kube_io", "server.kube_io"),
        ("registry", "metrics.registry"),
        ("harness", "testing.harness"),
        ("app", "server.app"),
        ("config", "server.config"),
        ("http", "server.http"),
        ("extender", "core.extender"),
    ):
        setattr(m, attr, mod(name))
    m.cpu = {"device": "cpu"} if root == PORT else {}
    # The harness stamps pods and the pod model numbers uids from module
    # counters: restart both so both packages make the same pods.
    m.harness._ts = itertools.count(1)
    mod("models.kube")._uid_counter = itertools.count(1)
    return m


def run_both(scenario, *args):
    """Run `scenario(m, *args)` for each package; returns (jax, port)."""
    return tuple(scenario(pkg(root), *args) for root in ROOTS)


def assert_same(scenario, *args):
    jax_out, port_out = run_both(scenario, *args)
    assert port_out == jax_out
    return port_out


def wait_until(cond, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


# ------------------------------------------------------------- k8s objects


def k8s_node(name, cpu="8", memory="8Gi", gpu="1", zone="zone1"):
    return {
        "kind": "Node",
        "apiVersion": "v1",
        "metadata": {
            "name": name,
            "creationTimestamp": CREATED,
            "labels": {
                "failure-domain.beta.kubernetes.io/zone": zone,
                IG_LABEL: GROUP,
            },
        },
        "status": {
            "allocatable": {"cpu": cpu, "memory": memory, "nvidia.com/gpu": gpu},
            "conditions": [{"type": "Ready", "status": "True"}],
        },
    }


def k8s_spark_pod(name, app_id, role, executors=2, namespace="ns"):
    annotations = {}
    if role == "driver":
        annotations = {
            "spark-driver-cpu": "1",
            "spark-driver-mem": "1Gi",
            "spark-executor-cpu": "1",
            "spark-executor-mem": "1Gi",
            "spark-executor-count": str(executors),
        }
    return {
        "kind": "Pod",
        "apiVersion": "v1",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "uid": f"uid-{name}",
            "labels": {"spark-role": role, "spark-app-id": app_id},
            "annotations": annotations,
            "creationTimestamp": CREATED,
        },
        "spec": {
            "schedulerName": "spark-scheduler",
            "nodeSelector": {IG_LABEL: GROUP},
            "containers": [
                {"name": "main", "resources": {"requests": {"cpu": "1", "memory": "1Gi"}}}
            ],
        },
        "status": {"phase": "Pending"},
    }


def seeded_nodes(seed, n, prefix="n"):
    """n nodes of seeded sizes over 3 zones."""
    rng = np.random.default_rng(seed)
    return [
        k8s_node(
            f"{prefix}{i}",
            cpu=str(int(rng.integers(4, 17))),
            memory=f"{int(rng.integers(4, 33))}Gi",
            gpu=str(int(rng.integers(0, 3))),
            zone=f"zone{int(rng.integers(1, 4))}",
        )
        for i in range(n)
    ]


def bound(raw, node):
    out = copy.deepcopy(raw)
    out["spec"]["nodeName"] = node
    out["status"]["phase"] = "Running"
    return out


# --------------------------------------------------------------- snapshots


def backend_state(backend):
    """Nodes, pods, reservations and demands of a backend, canonical."""

    def kind(k):
        return sorted(
            (canon(o) for o in backend.list(k)),
            key=lambda c: (c[1].get("namespace", ""), c[1]["name"]),
        )

    return {k: kind(k) for k in ("nodes", "pods", "resourcereservations", "demands")}


def api_state(api):
    """Every object every collection of an apiserver holds."""
    return {
        res: [obj for _, obj in sorted(col.objects.items())]
        for res, col in api.collections.items()
    }


def histogram_counts(registry):
    return {
        name: [(e["tags"], e["count"]) for e in entries]
        for name, entries in registry.snapshot().items()
        if name.endswith("informer.delay")
    }


@pytest.fixture
def openssl_cert(tmp_path):
    cert, key = str(tmp_path / "api.crt"), str(tmp_path / "api.key")
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", key, "-out", cert, "-days", "1",
            "-subj", "/CN=127.0.0.1",
            "-addext", "subjectAltName=IP:127.0.0.1",
        ],
        check=True,
        capture_output=True,
    )
    return cert, key


def started(m, **kw):
    api = m.apiserver.FakeKubeAPIServer(**kw)
    api.start()
    return api


# ------------------------------------------------- tests/test_kube_watch.py


def sc_mutations_propagate(m, seed):
    api = started(m)
    try:
        nodes = seeded_nodes(seed, 6)
        api.create("nodes", nodes[0])
        backend = m.backend.InMemoryBackend()
        registry = m.registry.MetricRegistry()
        ingestion = m.reflector.KubeIngestion(
            backend, api.base_url, metrics=registry, watch_timeout_s=5.0,
            clock=lambda: CLOCK,
        )
        ingestion.start()
        try:
            assert ingestion.wait_synced(timeout=5.0)
            for node in nodes[1:]:
                api.create("nodes", node)
            assert wait_until(lambda: len(backend.list_nodes()) == len(nodes))
            driver = k8s_spark_pod("app-driver", "app", "driver")
            api.create("pods", driver)
            assert wait_until(lambda: backend.get("pods", "ns", "app-driver") is not None)
            api.update("pods", bound(api.collections["pods"].objects[("ns", "app-driver")], "n1"))
            assert wait_until(
                lambda: backend.get("pods", "ns", "app-driver").node_name == "n1"
            )
            api.delete("nodes", "", "n2")
            assert wait_until(lambda: backend.get_node("n2") is None)
            mid = backend_state(backend)
            api.delete("pods", "ns", "app-driver")
            assert wait_until(lambda: backend.get("pods", "ns", "app-driver") is None)
            return mid, backend_state(backend), api_state(api), histogram_counts(registry)
        finally:
            ingestion.stop()
    finally:
        api.stop()


@pytest.mark.parametrize("seed", [0, 1])
def test_mutations_propagate_match_jax(seed):
    mid, end, objects, hist = assert_same(sc_mutations_propagate, seed)
    assert len(mid["nodes"]) == 5 and len(mid["pods"]) == 1
    assert end["pods"] == [] and objects["nodes"]
    assert hist and hist["foundry.spark.scheduler.informer.delay"][0][1] == 1


def sc_rest_write_paths(m):
    api = started(m)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", api.port, timeout=5)

        def call(method, path, payload=None):
            conn.request(
                method, path, body=json.dumps(payload).encode() if payload else None
            )
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read() or b"{}")

        out = [call("POST", "/api/v1/nodes", k8s_node("n1"))]
        out.append(call("POST", "/api/v1/nodes", k8s_node("n1")))
        stale = k8s_node("n1")
        stale["metadata"]["resourceVersion"] = "999"
        out.append(call("PUT", "/api/v1/nodes/n1", stale))
        out.append(call("POST", "/api/v1/namespaces/ns/pods",
                        k8s_spark_pod("p1", "app", "executor")))
        out.append(call("GET", "/api/v1/namespaces/ns/pods/p1"))
        out.append(call("GET", "/api/v1/pods"))
        out.append(call("DELETE", "/api/v1/namespaces/ns/pods/p1"))
        out.append(call("DELETE", "/api/v1/namespaces/ns/pods/p1"))
        out.append(call("GET", "/api/v1/nosuch"))
        conn.close()
        history = [(rv, res, etype, obj) for rv, res, etype, obj in api._history]
        return out, history, api_state(api)
    finally:
        api.stop()


def test_rest_write_paths_match_jax():
    out, history, _ = assert_same(sc_rest_write_paths)
    assert [s for s, _ in out] == [201, 409, 409, 201, 200, 200, 200, 404, 404]
    assert [(r, e) for _, r, e, _ in history if r == "pods"] == [
        ("pods", "ADDED"), ("pods", "DELETED")
    ]


def node_reflector(m, base_url, backend, **kw):
    return m.reflector.Reflector(
        base_url, "/api/v1/nodes", m.kube_io.node_from_k8s,
        m.reflector.BackendSyncTarget(backend, "nodes"), **kw,
    )


def sc_rearm_without_relist(m):
    api = started(m)
    try:
        api.create("nodes", k8s_node("n1"))
        backend = m.backend.InMemoryBackend()
        reflector = node_reflector(m, api.base_url, backend, watch_timeout_s=0.3)
        reflector.start()
        try:
            assert reflector.wait_synced(timeout=5.0)
            time.sleep(1.0)  # at least 2 watch windows elapse
            api.create("nodes", k8s_node("n2"))
            assert wait_until(lambda: backend.get_node("n2") is not None)
            rv_seen = reflector.last_resource_version == api.current_rv()
            return reflector.relist_count, rv_seen, backend_state(backend)
        finally:
            reflector.stop()
    finally:
        api.stop()


def test_watch_window_rearm_does_not_relist_matches_jax():
    relists, rv_seen, _ = assert_same(sc_rearm_without_relist)
    assert relists == 1 and rv_seen


def sc_expired_history(m):
    api = started(m, history_limit=3)
    try:
        for node in seeded_nodes(3, 10):
            api.create("nodes", node)
        conn = http.client.HTTPConnection("127.0.0.1", api.port, timeout=5)
        conn.request("GET", "/api/v1/nodes?watch=true&resourceVersion=1&timeoutSeconds=2")
        resp = conn.getresponse()
        event = json.loads(resp.readline())
        conn.close()
        return resp.status, event
    finally:
        api.stop()


def test_expired_history_emits_410_matches_jax():
    status, event = assert_same(sc_expired_history)
    assert status == 200 and event["type"] == "ERROR"
    assert event["object"]["code"] == 410


def sc_mid_stream_pruning(m, seed):
    api = started(m, history_limit=3)
    try:
        api.create("nodes", k8s_node("seed"))
        backend = m.backend.InMemoryBackend()
        reflector = node_reflector(m, api.base_url, backend, watch_timeout_s=5.0)
        reflector.start()
        try:
            assert reflector.wait_synced(timeout=5.0)
            # One atomic burst larger than the history window.
            api.create_many("nodes", seeded_nodes(seed, 6, prefix="burst"))
            assert wait_until(lambda: len(backend.list_nodes()) == 7)
            return reflector.relist_count >= 2, backend_state(backend), api_state(api)
        finally:
            reflector.stop()
    finally:
        api.stop()


@pytest.mark.parametrize("seed", [4, 5])
def test_mid_stream_pruning_forces_relist_matches_jax(seed):
    relisted, state, _ = assert_same(sc_mid_stream_pruning, seed)
    assert relisted and len(state["nodes"]) == 7


def sc_gone_relist(m, seed):
    api = started(m, history_limit=3)
    try:
        for node in seeded_nodes(seed, 3, prefix="seed"):
            api.create("nodes", node)
        backend = m.backend.InMemoryBackend()
        reflector = node_reflector(m, api.base_url, backend, watch_timeout_s=5.0)
        rv = reflector._list()
        reflector.last_resource_version = rv
        for node in seeded_nodes(seed + 100, 6, prefix="burst"):
            api.create("nodes", node)
        with pytest.raises(m.reflector.GoneError):
            reflector._watch_once()
        reflector.start()
        try:
            assert wait_until(lambda: len(backend.list_nodes()) == 9)
            return reflector.relist_count >= 2, backend_state(backend)
        finally:
            reflector.stop()
    finally:
        api.stop()


@pytest.mark.parametrize("seed", [6, 7])
def test_gone_triggers_relist_and_converges_matches_jax(seed):
    relisted, state = assert_same(sc_gone_relist, seed)
    assert relisted and len(state["nodes"]) == 9


def sc_tls_bearer(m, cert, key, token_path):
    api = started(m, cert_file=cert, key_file=key, required_token="sa-token-1")
    try:
        api.create("nodes", k8s_node("n1"))
        backend = m.backend.InMemoryBackend()
        ingestion = m.reflector.KubeIngestion(
            backend, api.base_url, watch_timeout_s=5.0, ca_file=cert,
            token_file=token_path,
        )
        ingestion.start()
        try:
            assert ingestion.wait_synced(timeout=5.0)
            api.create("nodes", k8s_node("n2"))
            assert wait_until(lambda: backend.get_node("n2") is not None)
        finally:
            ingestion.stop()
        bad = node_reflector(m, api.base_url, m.backend.InMemoryBackend(), ca_file=cert)
        with pytest.raises(http.client.HTTPException) as err:
            bad._list()
        return api.base_url.split(":")[0], str(err.value).split(":")[-1], backend_state(backend)
    finally:
        api.stop()


def test_reflector_over_tls_with_bearer_token_matches_jax(openssl_cert, tmp_path):
    token = tmp_path / "token"
    token.write_text("sa-token-1\n")
    scheme, refusal, state = assert_same(sc_tls_bearer, *openssl_cert, str(token))
    assert scheme == "https" and refusal.strip() == "401"
    assert len(state["nodes"]) == 2


def sc_served_from_watch_stream(m, seed):
    """Cluster state arrives only through the watch stream; the gang is
    served over HTTP; the executor lands on its reserved node."""
    api = started(m)
    server = None
    try:
        nodes = seeded_nodes(seed, 3)
        for node in nodes:
            api.create("nodes", node)
        names = [n["metadata"]["name"] for n in nodes]
        backend = m.backend.InMemoryBackend()
        app = m.app.build_scheduler_app(
            backend,
            m.config.InstallConfig(sync_writes=True, kube_api_url=api.base_url),
            clock=lambda: CLOCK,
            **m.cpu,
        )
        server = m.http.SchedulerHTTPServer(app, host="127.0.0.1", port=0)
        server.start()
        assert wait_until(lambda: server.ready.is_set())
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)

        def post(pod):
            conn.request("POST", "/predicates",
                         body=json.dumps({"Pod": pod, "NodeNames": names}).encode())
            resp = conn.getresponse()
            return resp.status, resp.read()

        bodies = []
        driver = k8s_spark_pod("app1-driver", "app1", "driver", executors=2)
        api.create("pods", driver)
        assert wait_until(lambda: backend.get("pods", "ns", "app1-driver") is not None)
        bodies.append(post(driver))
        driver_node = json.loads(bodies[-1][1])["NodeNames"][0]
        api.update("pods", bound(driver, driver_node))
        assert wait_until(
            lambda: backend.get("pods", "ns", "app1-driver").node_name == driver_node
        )
        for k in (1, 2):
            executor = k8s_spark_pod(f"app1-exec-{k}", "app1", "executor")
            api.create("pods", executor)
            assert wait_until(
                lambda: backend.get("pods", "ns", f"app1-exec-{k}") is not None
            )
            bodies.append(post(executor))
        conn.close()
        return bodies, backend_state(backend)
    finally:
        if server is not None:
            server.stop()
        api.stop()


@pytest.mark.parametrize("seed", [8, 9])
def test_scheduler_served_from_watch_stream_matches_jax(seed):
    bodies, state = assert_same(sc_served_from_watch_stream, seed)
    assert all(status == 200 and json.loads(b)["NodeNames"] for status, b in bodies)
    assert len(state["resourcereservations"]) == 1


def sc_harness_from_watch_stream(m, seed):
    """The same loop through the package's `testing.Harness`: the app's
    own ingestion (kube-api-url) feeds the backend, the extender serves."""
    api = started(m)
    h = None
    try:
        nodes = seeded_nodes(seed, 3)
        for node in nodes:
            api.create("nodes", node)
        names = [n["metadata"]["name"] for n in nodes]
        h = m.harness.Harness(kube_api_url=api.base_url, clock=lambda: CLOCK,
                              **m.cpu)
        h.app.ingestion.start()
        assert h.app.ingestion.wait_synced(timeout=5.0)
        out = []
        for name, role in (("app1-driver", "driver"), ("app1-exec-1", "executor"),
                           ("app1-exec-2", "executor")):
            raw = k8s_spark_pod(name, "app1", role, executors=2)
            api.create("pods", raw)
            assert wait_until(lambda: h.backend.get("pods", "ns", name) is not None)
            res = h.extender.predicate(m.extender.ExtenderArgs(
                pod=h.backend.get("pods", "ns", name), node_names=list(names)))
            out.append(canon(res))
            if res.ok:
                api.update("pods", bound(raw, res.node_names[0]))
                assert wait_until(
                    lambda: h.backend.get("pods", "ns", name).node_name
                    == res.node_names[0]
                )
        return out, backend_state(h.backend)
    finally:
        if h is not None:
            h.app.stop()
        api.stop()


@pytest.mark.parametrize("seed", [8, 9])
def test_harness_served_from_watch_stream_matches_jax(seed):
    results, state = assert_same(sc_harness_from_watch_stream, seed)
    assert all(r[1][0] for r in results) and len(state["resourcereservations"]) == 1


def sc_readiness_waits_for_sync(m):
    """Readiness answers 503 while the apiserver cannot be listed, and 200
    once ingestion has synced."""
    api = m.apiserver.FakeKubeAPIServer()  # bound, not serving yet
    server = None
    try:
        api.create("nodes", k8s_node("n1"))
        backend = m.backend.InMemoryBackend()
        app = m.app.build_scheduler_app(
            backend,
            m.config.InstallConfig(sync_writes=True, kube_api_url=api.base_url),
            clock=lambda: CLOCK,
            **m.cpu,
        )
        server = m.http.SchedulerHTTPServer(app, host="127.0.0.1", port=0)
        server.start()

        def readiness():
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
            conn.request("GET", "/status/readiness")
            resp = conn.getresponse()
            out = (resp.status, resp.read())
            conn.close()
            return out

        before = readiness()
        api.start()
        assert wait_until(lambda: server.ready.is_set(), timeout=20.0)
        return before, readiness()
    finally:
        if server is not None:
            server.stop()
        api.stop()


def test_readiness_waits_for_ingestion_sync_matches_jax():
    before, after = assert_same(sc_readiness_waits_for_sync)
    assert before[0] == 503 and after == (200, b'{"ready": true}')


# ----------------------------------------------- tests/test_kube_backend.py


def test_token_bucket_matches_jax():
    out = []
    for root in ROOTS:
        now, waits = [0.0], []
        # qps 4: every wait and clock reading is exact in binary.
        bucket = pkg(root).kbackend.TokenBucket(
            qps=4, burst=3, clock=lambda: now[0],
            sleep=lambda s: (waits.append(s), now.__setitem__(0, now[0] + s)),
        )
        for _ in range(4):
            bucket.acquire()
        now[0] += 1.0
        for _ in range(5):
            bucket.acquire()
        out.append((waits, now[0]))
    assert out[1] == out[0]
    assert out[1] == ([0.25, 0.25, 0.25], 1.75)


def kube_harness(m, api, n_nodes=4, **kw):
    backend = m.kbackend.KubeBackend(api.base_url, qps=1000, burst=1000)
    backend.start()
    assert backend.wait_synced(timeout=5.0)
    h = m.harness.Harness(backend=backend, clock=lambda: CLOCK, **m.cpu, **kw)
    names = [f"n{i}" for i in range(n_nodes)]
    h.add_nodes(*(m.harness.new_node(n) for n in names))
    return h, backend, names


def result_form(r):
    return canon(r)


def sc_gang_reservation(m, executors):
    api = started(m)
    try:
        h, backend, names = kube_harness(m, api)
        pods = m.harness.static_allocation_spark_pods("kb-app", executors)
        results = [result_form(h.schedule(p, names)) for p in pods]
        state = backend_state(backend)
        crds = sorted(api._crds)
        h.app.stop()
        backend.stop()
        return results, state, api_state(api), crds
    finally:
        api.stop()


@pytest.mark.parametrize("executors", [1, 2, 3])
def test_gang_reservation_lands_in_apiserver_matches_jax(executors):
    results, state, objects, crds = assert_same(sc_gang_reservation, executors)
    (wire,) = objects["resourcereservations"]
    assert len(wire["spec"]["reservations"]) == executors + 1
    assert "resourcereservations" in crds
    assert state["resourcereservations"]


def sc_demand(m):
    api = started(m)
    try:
        h, backend, names = kube_harness(m, api, n_nodes=1)
        backend.register_crd(m.backend.DEMAND_CRD)
        h.app.demand_crd_watcher.check_now()
        big = m.harness.static_allocation_spark_pods("kb-big", 50)
        result = result_form(h.schedule(big[0], names))
        state = backend_state(backend)
        h.app.stop()
        backend.stop()
        return result, state, api_state(api)
    finally:
        api.stop()


def test_demand_lands_in_apiserver_matches_jax():
    _, state, objects = assert_same(sc_demand)
    (wire,) = objects["demands"]
    assert wire["spec"]["instance-group"] and state["demands"]


def sc_conflict(m):
    api = started(m)
    try:
        h, backend, names = kube_harness(m, api)
        pods = m.harness.static_allocation_spark_pods("kb-conf", 1)
        assert h.schedule(pods[0], names).node_names
        rr = backend.get("resourcereservations", "namespace", "kb-conf")
        raw = api.collections["resourcereservations"].objects[("namespace", "kb-conf")]
        api.update("resourcereservations", copy.deepcopy(raw))
        with pytest.raises(m.backend.ConflictError) as err:
            backend.update("resourcereservations", rr.copy())
        h.app.stop()
        backend.stop()
        return str(err.value), api_state(api)
    finally:
        api.stop()


def test_conflict_maps_to_conflict_error_matches_jax():
    message, _ = assert_same(sc_conflict)
    assert "conflict" in message


def sc_external_modify(m):
    api = started(m)
    try:
        h, backend, names = kube_harness(m, api)
        pods = m.harness.static_allocation_spark_pods("kb-rv", 1)
        assert h.schedule(pods[0], names).node_names
        (local_before,) = backend.list("resourcereservations")
        raw = copy.deepcopy(
            api.collections["resourcereservations"].objects[("namespace", "kb-rv")]
        )
        raw["status"]["pods"] = {}  # an external mutation the owner ignores
        api.update("resourcereservations", raw)
        new_rv = int(raw["metadata"]["resourceVersion"])
        assert wait_until(
            lambda: backend.list("resourcereservations")[0].resource_version == new_rv
        )
        (local_after,) = backend.list("resourcereservations")
        same_object = local_after is local_before
        state = backend_state(backend)
        h.app.stop()
        backend.stop()
        return same_object, state
    finally:
        api.stop()


def test_external_modify_only_bumps_rv_matches_jax():
    same_object, state = assert_same(sc_external_modify)
    assert same_object
    assert state["resourcereservations"][0][1]["status"][1]["pods"]


def sc_absent_collection(m):
    hits = [0]

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            hits[0] += 1
            body = b'{"reason": "NotFound", "code": 404}'
            self.send_response(404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        backend = m.backend.InMemoryBackend()
        reflector = m.reflector.Reflector(
            f"http://127.0.0.1:{srv.server_address[1]}",
            "/apis/scaler.palantir.com/v1alpha2/demands",
            m.kube_io.node_from_k8s,
            m.reflector.BackendSyncTarget(backend, "demands"),
            tolerate_absent=True,
            absent_poll_s=60.0,
        )
        reflector.start()
        try:
            synced = reflector.wait_synced(timeout=5.0)
            time.sleep(0.5)
            return synced, hits[0] <= 3, reflector.relist_count, backend_state(backend)
        finally:
            reflector.stop()
    finally:
        srv.shutdown()
        srv.server_close()


def test_missing_collection_syncs_empty_and_polls_matches_jax():
    synced, slow, relists, _ = assert_same(sc_absent_collection)
    assert synced and slow and relists == 1


def sc_new_leader_restores(m, executors):
    api = started(m)
    try:
        h, backend, names = kube_harness(m, api)
        pods = m.harness.static_allocation_spark_pods("kb-fo", executors)
        driver, execs = pods[0], pods[1:]
        results = [result_form(h.schedule(driver, names))]
        results.append(result_form(h.schedule(execs[0], names)))
        h.app.stop()
        backend.stop()

        backend2 = m.kbackend.KubeBackend(api.base_url, qps=1000, burst=1000)
        backend2.start()
        assert backend2.wait_synced(timeout=5.0)
        h2 = m.harness.Harness(backend=backend2, clock=lambda: CLOCK, **m.cpu)
        h2.add_nodes(*(m.harness.new_node(n) for n in names))
        for p in pods:
            h2.add_pods(h.backend.get("pods", p.namespace, p.name) or p)
        restored = backend_state(backend2)
        summary = h2.app.reconciler.sync_resource_reservations_and_demands()
        for e in execs[1:]:
            results.append(result_form(h2.schedule(e, names)))
        state = backend_state(backend2)
        h2.app.stop()
        backend2.stop()
        return results, restored, canon(summary), state, api_state(api)
    finally:
        api.stop()


@pytest.mark.parametrize("executors", [2, 3])
def test_new_leader_restores_from_apiserver_matches_jax(executors):
    results, restored, _, state, _ = assert_same(sc_new_leader_restores, executors)
    assert len(restored["resourcereservations"]) == 1
    (rr,) = state["resourcereservations"]
    reserved = {
        r[1]["node"] for slot, r in rr[1]["spec"][1]["reservations"].items()
        if slot != "driver"
    }
    for res in results[2:]:
        assert res[1][0][0] in reserved  # (node_names, failed_nodes, outcome)


def sc_compaction(m):
    api = started(m)
    try:
        h, backend, names = kube_harness(m, api)
        pods = m.harness.dynamic_allocation_spark_pods("kb-dyn", 1, 3)
        driver, execs = pods[0], pods[1:]
        results = [result_form(h.schedule(p, names)) for p in pods]
        h.backend.delete_pod(execs[0])
        h.app.reservation_manager.compact_dynamic_allocation_applications()
        state = backend_state(backend)
        h.app.stop()
        backend.stop()
        return results, state, api_state(api)
    finally:
        api.stop()


def test_compaction_updates_apiserver_matches_jax():
    _, _, objects = assert_same(sc_compaction)
    (wire,) = objects["resourcereservations"]
    assert "kb-dyn-exec-1" not in set(wire["status"]["pods"].values())
    assert len(set(wire["status"]["pods"].values())) == 2


# -------------------------------------------------------------- cross-feed


def cross_ingestion(server_root, client_root, seed):
    """`client_root`'s KubeIngestion against `server_root`'s apiserver."""
    s, c = pkg(server_root), pkg(client_root)
    api = started(s)
    try:
        nodes = seeded_nodes(seed, 8)
        api.create_many("nodes", nodes[:5])
        backend = c.backend.InMemoryBackend()
        ingestion = c.reflector.KubeIngestion(backend, api.base_url, watch_timeout_s=5.0)
        ingestion.start()
        try:
            assert ingestion.wait_synced(timeout=5.0)
            for node in nodes[5:]:
                api.create("nodes", node)
            driver = k8s_spark_pod("x-driver", "x", "driver")
            api.create("pods", driver)
            api.update("pods", bound(driver, "n3"))
            api.delete("nodes", "", "n0")
            # The nodes and the pods arrive on two watches: wait for the
            # exact node set (a count of 7 is also passed on the way up,
            # with one create still to come) and the bound driver.
            want_nodes = {f"n{i}" for i in range(1, 8)}
            assert wait_until(
                lambda: {n.name for n in backend.list_nodes()} == want_nodes
                and getattr(backend.get("pods", "ns", "x-driver"), "node_name", "") == "n3"
            )
            return backend_state(backend)
        finally:
            ingestion.stop()
    finally:
        api.stop()


@pytest.mark.parametrize("seed", [10, 11])
def test_cross_fed_ingestion_gives_equal_objects(seed):
    """Each package's reflectors against the other's apiserver give the
    objects they give against their own."""
    got = {
        (srv, cli): cross_ingestion(srv, cli, seed)
        for srv in ROOTS for cli in ROOTS
    }
    want = got[(JAX, JAX)]
    assert got[(JAX, PORT)] == want
    assert got[(PORT, JAX)] == want
    assert got[(PORT, PORT)] == want


def cross_kube_backend(server_root, client_root):
    """`client_root`'s KubeBackend and harness against `server_root`'s
    apiserver: the CRs that land and the state a new leader restores."""
    s, c = pkg(server_root), pkg(client_root)
    api = started(s)
    try:
        h, backend, names = kube_harness(c, api)
        pods = c.harness.static_allocation_spark_pods("xb-app", 2)
        results = [result_form(h.schedule(p, names)) for p in pods[:2]]
        h.app.stop()
        backend.stop()
        backend2 = c.kbackend.KubeBackend(api.base_url, qps=1000, burst=1000)
        backend2.start()
        assert backend2.wait_synced(timeout=5.0)
        restored = backend_state(backend2)
        backend2.stop()
        return results, restored, api_state(api)
    finally:
        api.stop()


def test_cross_fed_kube_backend_gives_equal_objects():
    got = {
        (srv, cli): cross_kube_backend(srv, cli)
        for srv in ROOTS for cli in ROOTS
    }
    want = got[(JAX, JAX)]
    for key, value in got.items():
        assert value == want, key
    assert want[2]["resourcereservations"]


# ------------------------------------------------- relist under a window


def sc_relist_mid_window(m, seed):
    """A relist after 410 Gone (`replace`) swaps the node set between a
    window's dispatch and its fetch: the in-flight window's decisions, the
    next window's (whose build must not reuse the stale base) and the
    reservations must be the JAX package's."""
    api = started(m)
    try:
        rng = np.random.default_rng(seed)
        nodes = seeded_nodes(seed, 12)
        api.create_many("nodes", nodes)
        backend = m.backend.InMemoryBackend()
        backend.register_crd(m.backend.DEMAND_CRD)
        reflector = node_reflector(m, api.base_url, backend)
        reflector._list()
        app = m.app.build_scheduler_app(
            backend,
            m.config.InstallConfig(
                fifo=True, binpack_algo="tightly-pack",
                instance_group_label=IG_LABEL, sync_writes=True,
            ),
            clock=lambda: CLOCK,
            **m.cpu,
        )
        ext = app.extender
        ext._last_request = float("inf")
        names = [n["metadata"]["name"] for n in nodes]

        def drivers(tag, k):
            out = []
            for i in range(k):
                raw = k8s_spark_pod(f"{tag}{i}-driver", f"{tag}{i}", "driver",
                                    executors=int(rng.integers(1, 4)))
                pod = m.kube_io.pod_from_k8s(raw)
                backend.add_pod(pod)
                out.append(m.extender.ExtenderArgs(pod=pod, node_names=list(names)))
            return out

        first = drivers("a", 4)
        t1 = ext.predicate_window_dispatch(first)
        # The relist: two nodes gone, one resized, two new, seen only by a
        # LIST (no watch events) — the informer's replace.
        api.delete("nodes", "", "n0")
        api.delete("nodes", "", "n5")
        resized = copy.deepcopy(api.collections["nodes"].objects[("", "n3")])
        resized["status"]["allocatable"]["cpu"] = "2"
        api.update("nodes", resized)
        for node in seeded_nodes(seed + 50, 2, prefix="fresh"):
            api.create("nodes", node)
        reflector._list()
        r1 = ext.predicate_window_complete(t1)
        for r, a in zip(r1, first):
            if r.ok:
                backend.bind_pod(a.pod, r.node_names[0])
        names[:] = [n.name for n in backend.list_nodes()]
        second = drivers("b", 4)
        t2 = ext.predicate_window_dispatch(second)
        r2 = ext.predicate_window_complete(t2)
        state = backend_state(backend)
        app.stop()
        return [canon(r) for r in r1 + r2], state, reflector.relist_count
    finally:
        api.stop()


@pytest.mark.parametrize("seed", [12, 13, 14])
def test_relist_between_dispatch_and_fetch_matches_jax(seed):
    results, state, relists = assert_same(sc_relist_mid_window, seed)
    assert relists == 2
    assert any(r[1][0] for r in results)  # some request admitted
    assert len(state["nodes"]) == 12


# --------------------------------------------------------------------- CLI


def cli_main(root):
    return importlib.import_module(f"{root}.__main__").main


def test_cli_refuses_ha_replica_with_kube_api_url_like_jax():
    """`--ha-replica` with `--kube-api-url` is refused as in the JAX
    package: the apiserver backend keeps no lease kind, so every replica
    would elect itself."""
    messages = []
    for root in ROOTS:
        api = started(pkg(root))
        try:
            with pytest.raises(SystemExit) as err:
                cli_main(root)(["server", "--port", "0", "--kube-api-url",
                                api.base_url, "--ha-replica", "r0"])
        finally:
            api.stop()
        messages.append(str(err.value))
    assert messages[1] == messages[0] and "split-brain" in messages[1]


def test_cli_refuses_fleet_with_durable_store_like_jax(tmp_path):
    cfg = tmp_path / "install.yml"
    cfg.write_text("fleet:\n  enabled: true\n  clusters: 2\n")
    messages = []
    for root in ROOTS:
        with pytest.raises(SystemExit) as err:
            cli_main(root)(["server", "--port", "0", "--config", str(cfg),
                            "--durable-store", str(tmp_path / f"{root}.jsonl")])
        messages.append(str(err.value))
    assert messages[1] == messages[0] and "fleet.enabled" in messages[1]


def test_in_cluster_without_serviceaccount_raises(monkeypatch, tmp_path):
    """`kube-api-url: in-cluster` outside a pod: the port raises naming the
    missing serviceaccount file, in the config helper and in the CLI, where
    the JAX package hands back the paths and retries forever."""
    m = pkg(PORT)
    monkeypatch.setattr(m.reflector, "SERVICEACCOUNT_DIR", str(tmp_path / "sa"))
    with pytest.raises(FileNotFoundError, match="ca.crt"):
        m.reflector.in_cluster_config()
    with pytest.raises(FileNotFoundError, match="serviceaccount"):
        cli_main(PORT)(["server", "--port", "0", "--kube-api-url", "in-cluster"])
    (tmp_path / "sa").mkdir()
    (tmp_path / "sa" / "ca.crt").write_text("x")
    with pytest.raises(FileNotFoundError, match="token"):
        m.reflector.in_cluster_config()
    (tmp_path / "sa" / "token").write_text("t")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    base, ca, token = m.reflector.in_cluster_config()
    assert base == "https://10.0.0.1:6443" and ca.endswith("ca.crt")
    jax_reflector = pkg(JAX).reflector
    monkeypatch.setattr(jax_reflector, "SERVICEACCOUNT_DIR", str(tmp_path / "sa"))
    assert jax_reflector.in_cluster_config() == (base, ca, token)
