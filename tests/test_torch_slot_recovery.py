"""Device-slot failure recovery and degraded-mode serving of the port,
held to the JAX package on the CPU.

The six scenarios of tests/test_slot_recovery.py, each run on both
packages with the same seeded nodes, windows and fault plans:

  - a two-slot pool, one slot killed mid-burst: the part re-dispatches on
    the survivor, decisions equal the single-device solve's, the slot is
    quarantined and a forced probe reinstates it;
  - every slot killed under "greedy": the host greedy serves decisions
    equal to the single-device solve's, then a probe reinstates both slots
    and clears degraded mode;
  - every slot killed under "shed": DegradedUnavailableError carries
    Retry-After;
  - the server: "greedy" keeps answering with readiness 200-but-degraded
    and a `faults` block in /debug/state; "shed" flips readiness 503 (also
    under HA) and answers /predicates 503 with Retry-After.

The JAX package's pool runs on the conftest's 8 virtual CPU devices; the
port's on two slots of the one CPU device (`pool_devices=["cpu"] * 2`).
Decisions, degraded snapshots (without their wall-clock `since`) and
response bodies must be equal across the packages. Tolerance: none.
"""

from __future__ import annotations

import http.client
import importlib
import json

import numpy as np
import pytest

from tests.test_torch_extender import JAX, PORT, canon
from tests.test_torch_native import load_jax_native

PKGS = (JAX, PORT)


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def solver(pkg, pool=0, **kw):
    sm = mod(pkg, "core.solver")
    if pkg == PORT:
        if pool:
            kw["pool_devices"] = ["cpu"] * pool
        return sm.PlacementSolver(device="cpu", **kw)
    if pool:
        kw["device_pool"] = pool
    return sm.PlacementSolver(use_native=False, **kw)


def world(pkg, seed, n_batches, k=1, per=4):
    """16 nodes over two zones; K windows a batch of `per` requests, their
    domains (the two halves of the nodes) cycled so that every window
    partitions over the pool."""
    kube = mod(pkg, "models.kube")
    res = mod(pkg, "models.resources").Resources
    sm = mod(pkg, "core.solver")
    one = res.from_quantities("1", "1Gi")
    two = res.from_quantities("2", "2Gi")
    nodes = [
        kube.Node(
            name=f"n{i:03d}",
            allocatable=res.from_quantities("8", "8Gi", "1", round_up=False),
            labels={kube.ZONE_LABEL: f"z{i % 2}"},
        )
        for i in range(16)
    ]
    halves = [n.name for n in nodes[:8]], [n.name for n in nodes[8:]]
    rng = np.random.default_rng(seed)

    def batch():
        out = []
        r = 0
        for _ in range(k):
            reqs = []
            for _ in range(per):
                size = two if rng.random() < 0.3 else one
                dom = halves[r % 2]
                reqs.append(sm.WindowRequest(
                    rows=[(size, one, int(rng.integers(1, 4)), False)],
                    driver_candidate_names=dom, domain_node_names=dom,
                ))
                r += 1
            out.append(reqs)
        return out

    return nodes, [batch() for _ in range(n_batches)]


def run(s, nodes, batches, strategy="tightly-pack"):
    out = []
    for wins in batches:
        handles = []
        for w in wins:
            t = s.build_tensors_pipelined(nodes, {}, {})
            handles.append(s.pack_window_dispatch(strategy, t, w))
        for h in handles:
            out.extend(s.pack_window_fetch(h))
    return out


def snap(controller):
    out = controller.snapshot()
    out.pop("since")
    return out


def plan(pkg, **spec):
    f = mod(pkg, "faults")
    return f.FaultPlan(seed=0, name="test", specs=[f.FaultSpec(**spec)])


def test_slot_kill_mid_burst_redispatches_on_the_survivor():
    def scenario(pkg):
        nodes, batches = world(pkg, 11, 3)
        baseline = run(solver(pkg), nodes, batches)
        pooled = solver(pkg, pool=2)
        assert pooled.pool_size == 2
        # The third part solve dies (window 2's first part, classified
        # slot-fatal).
        with mod(pkg, "faults").FaultInjector(
            plan(pkg, surface="device.dispatch", mode="error", at=[2], limit=1)
        ) as inj:
            inj.install_device()
            faulted = run(pooled, nodes, batches)
        assert canon(faulted) == canon(baseline), pkg
        health = pooled.device_health()
        quarantined = (health["healthy"], len(health["quarantined"]))
        redispatched = pooled.redispatch_count
        reinstated = pooled.probe_quarantined(force=True)
        _, more = world(pkg, 99, 1)
        again = run(pooled, nodes, more)
        assert canon(again) == canon(run(solver(pkg), nodes, more)), pkg
        return (faulted, quarantined, redispatched, reinstated,
                pooled.device_health()["healthy"], again)

    port = scenario(PORT)
    jax = scenario(JAX)
    assert canon(port) == canon(jax)
    assert port[1] == (1, 1) and port[2] >= 1 and port[3] == 1 and port[4] == 2


def test_all_slots_killed_greedy_serves_then_recovers():
    def scenario(pkg):
        f = mod(pkg, "faults")
        nodes, batches = world(pkg, 23, 4)
        baseline = run(solver(pkg), nodes, batches)
        pooled = solver(pkg, pool=2)
        pooled.degraded = f.DegradedModeController(policy="greedy")
        # Window 1's two part solves succeed; every one after fails:
        # window 2 quarantines both slots and serves on the host greedy,
        # windows 3-4 fall back at the dispatch gate.
        with f.FaultInjector(
            plan(pkg, surface="device.dispatch", mode="partition", start=2)
        ) as inj:
            inj.install_device()
            faulted = run(pooled, nodes, batches)
        assert canon(faulted) == canon(baseline), pkg
        health = pooled.device_health()
        during = (health["healthy"], len(health["quarantined"]),
                  snap(pooled.degraded))
        reinstated = pooled.probe_quarantined(force=True)
        cleared = not pooled.degraded.active
        _, more = world(pkg, 7, 1)
        again = run(pooled, nodes, more)
        assert canon(again) == canon(run(solver(pkg), nodes, more)), pkg
        return faulted, during, reinstated, cleared, again

    port = scenario(PORT)
    jax = scenario(JAX)
    assert canon(port) == canon(jax)
    _, (healthy, quarantined, snapshot), reinstated, cleared, _ = port
    assert healthy == 0 and quarantined == 2
    assert snapshot["active"] and snapshot["fallback_decisions"] == 12
    assert snapshot["engagements"] == 1
    assert reinstated == 2 and cleared


def test_all_slots_killed_shed_raises_retry_after():
    def scenario(pkg):
        f = mod(pkg, "faults")
        nodes, batches = world(pkg, 31, 1)
        pooled = solver(pkg, pool=2)
        pooled.degraded = f.DegradedModeController(
            policy="shed", retry_after_s=7.0
        )
        with f.FaultInjector(
            plan(pkg, surface="device.dispatch", mode="partition", start=0)
        ) as inj:
            inj.install_device()
            with pytest.raises(f.DegradedUnavailableError) as ei:
                run(pooled, nodes, batches)
        return ei.value.retry_after_s, snap(pooled.degraded)

    port = scenario(PORT)
    assert canon(port) == canon(scenario(JAX))
    assert port[0] == 7.0
    assert port[1]["active"] and port[1]["shed_requests"] >= 1


# ------------------------------------------------------------ server level


class _ServingHA:
    role = "leader"

    def is_serving(self):
        return True

    def state(self):
        return {"role": self.role}

    def start(self):
        pass

    def stop(self):
        pass


class Boot:
    """One package's app behind its HTTP server, with six nodes."""

    def __init__(self, pkg, degraded_mode, *, ha=False, n=6):
        self.pkg = pkg
        harness = mod(pkg, "testing.harness")
        metrics = mod(pkg, "metrics")
        if pkg == JAX:
            load_jax_native()
        self.backend = mod(pkg, "store.backend").InMemoryBackend()
        for i in range(n):
            self.backend.add_node(
                harness.new_node(f"srv-n{i}", zone=f"zone{i % 2}")
            )
        registry = metrics.MetricRegistry()
        self.app = mod(pkg, "server.app").build_scheduler_app(
            self.backend,
            mod(pkg, "server.config").InstallConfig(
                fifo=True, sync_writes=True,
                instance_group_label=harness.INSTANCE_GROUP_LABEL,
                degraded_mode=degraded_mode, degraded_retry_after_s=9.0,
                debug_routes=True,
            ),
            metrics=metrics.SchedulerMetrics(
                registry, harness.INSTANCE_GROUP_LABEL
            ),
            clock=lambda: 1_000_000.0,
            **({"device": "cpu"} if pkg == PORT else {}),
        )
        self.server = mod(pkg, "server.http").SchedulerHTTPServer(
            self.app, registry, host="127.0.0.1", port=0, debug_routes=True,
            request_timeout_s=60.0, **({"ha": _ServingHA()} if ha else {}),
        )
        self.server.start()

    def get(self, path):
        conn = http.client.HTTPConnection("127.0.0.1", self.server.port, timeout=30)
        conn.request("GET", path)
        r = conn.getresponse()
        body = r.read()
        conn.close()
        return r.status, dict(r.getheaders()), body

    def predicate(self, app_id):
        kube_io = mod(self.pkg, "server.kube_io")
        harness = mod(self.pkg, "testing.harness")
        pod = harness.static_allocation_spark_pods(app_id, 1)[0]
        self.backend.add_pod(pod)
        payload = json.dumps({
            "Pod": kube_io.pod_to_k8s(pod),
            "NodeNames": [n.name for n in self.backend.list_nodes()],
        })
        conn = http.client.HTTPConnection("127.0.0.1", self.server.port, timeout=60)
        conn.request("POST", "/predicates", body=payload,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        body = r.read()
        conn.close()
        return r.status, dict(r.getheaders()), body

    def faults(self):
        status, _, body = self.get("/debug/state")
        assert status == 200
        out = json.loads(body)["faults"]
        out["degraded"].pop("since")
        return out

    def stop(self):
        self.server.stop()


def _body(b: bytes) -> bytes:
    return b.replace(PORT.encode(), JAX.encode())


def _h2d_down(pkg):
    return plan(pkg, surface="device.h2d", mode="partition", start=0)


def test_server_greedy_keeps_serving_and_reports():
    def scenario(pkg):
        s = Boot(pkg, "greedy")
        try:
            with mod(pkg, "faults").FaultInjector(_h2d_down(pkg)) as inj:
                inj.install_device()
                status, _, body = s.predicate("deg-app")
                assert status == 200 and json.loads(body).get("NodeNames")
                r_status, _, ready = s.get("/status/readiness")
                faults = s.faults()
            assert r_status == 200 and json.loads(ready)["degraded"]
            assert faults["degraded"]["active"]
            # Fault plan gone: the next served window clears degraded.
            status2, _, body2 = s.predicate("deg-app-2")
            r2, _, ready2 = s.get("/status/readiness")
            assert "degraded" not in json.loads(ready2)
            return (status, _body(body), r_status, json.loads(ready), faults,
                    status2, _body(body2), r2, s.faults())
        finally:
            s.stop()

    assert canon(scenario(PORT)) == canon(scenario(JAX))


def test_server_shed_readiness_flips_503_under_ha():
    def scenario(pkg):
        s = Boot(pkg, "shed", ha=True, n=4)
        try:
            healthy = s.get("/status/readiness")
            with mod(pkg, "faults").FaultInjector(_h2d_down(pkg)) as inj:
                inj.install_device()
                status, _, body = s.predicate("ha-shed-app")
                r_status, _, ready = s.get("/status/readiness")
            out = json.loads(ready)
            assert status == 503 and r_status == 503
            assert out["degraded"] and out["policy"] == "shed"
            assert out["role"] == "leader"
            return (healthy[0], json.loads(healthy[2]), status, _body(body),
                    r_status, out)
        finally:
            s.stop()

    port = scenario(PORT)
    assert canon(port) == canon(scenario(JAX))
    assert port[0] == 200 and port[1]["ready"]


def test_server_shed_503_retry_after_and_readiness():
    def scenario(pkg):
        s = Boot(pkg, "shed")
        try:
            with mod(pkg, "faults").FaultInjector(_h2d_down(pkg)) as inj:
                inj.install_device()
                status, headers, body = s.predicate("shed-app")
                r_status, _, ready = s.get("/status/readiness")
                faults = s.faults()
            assert status == 503 and headers.get("Retry-After") == "9"
            assert json.loads(body)["degraded"] is True
            assert r_status == 503 and json.loads(ready)["degraded"] is True
            return (status, headers.get("Retry-After"), _body(body), r_status,
                    json.loads(ready), faults)
        finally:
            s.stop()

    assert canon(scenario(PORT)) == canon(scenario(JAX))
