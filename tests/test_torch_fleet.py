"""The multi-cluster fleet of the port (fleet/, `fleet.*`), against the JAX
package, on the CPU.

Every scenario of tests/test_fleet.py runs through both packages'
FleetFacade (`device="cpu"` for the port) with the same pods (explicit
uids and creation times), keeps that suite's own assertions on the port,
and holds across the packages: each decision (ok, nodes, outcome, home
cluster, spillover source and attempts, unavailability), every cluster's
durable reservation specs, `verify_cluster_equivalence`'s report and the
facade's `state()` — the body of GET /debug/fleet — must be equal.
Tolerance: none.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import json
import urllib.request

import numpy as np
import pytest

from tests.test_torch_extender import JAX, PORT
from tests.test_torch_native import load_jax_native


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    load_jax_native()


class Pkg:
    """One package's fleet surface, with a pod factory whose creation
    times and uids are local to the run."""

    def __init__(self, root):
        self.root = root
        self._ts = itertools.count(1)

    def mod(self, name):
        return importlib.import_module(f"{self.root}.{name}")

    @property
    def hm(self):
        return self.mod("testing.harness")

    def config(self, **kw):
        return self.mod("server.config").InstallConfig(
            fifo=True, sync_writes=True,
            instance_group_label=self.hm.INSTANCE_GROUP_LABEL, **kw,
        )

    def facade(self, n, cfg_kw=None, **kw):
        if self.root == PORT:
            kw["device"] = "cpu"
        return self.mod("fleet").FleetFacade(
            n, self.config(**(cfg_kw or {})), **kw
        )

    def stack(self, **kw):
        if self.root == PORT:
            kw["device"] = "cpu"
        return self.mod("fleet").ClusterStack(0, self.config(), **kw)

    def node(self, name, group):
        return self.hm.new_node(name, instance_group=group)

    def pods(self, app, n, group):
        ts = float(next(self._ts))
        return [
            dataclasses.replace(p, uid=f"uid-{p.name}", creation_timestamp=ts)
            for p in self.hm.static_allocation_spark_pods(
                app, n, instance_group=group
            )
        ]

    def verify(self, f):
        return self.mod("fleet").verify_cluster_equivalence(f)


def dec(d):
    return (
        d.ok, tuple(d.result.node_names), d.result.outcome, d.cluster,
        d.spilled_from, d.spillover_attempts, d.unavailable,
    )


def state(f):
    s = f.state()
    s["stacking"].pop("gather_wait_ms", None)
    return s


def specs(f):
    return [s.reservation_specs() for s in f.stacks]


def both(scenario):
    """Run `scenario(pkg)` on each package; its observations must match."""
    out = {root: scenario(Pkg(root)) for root in (JAX, PORT)}
    assert out[PORT] == out[JAX]
    return out[PORT]


# ------------------------------------------------------ membership core


def test_stable_membership_matches_jax():
    keys = [f"app-{i}" for i in range(64)]
    seen = {}
    for root in (JAX, PORT):
        m = importlib.import_module(f"{root}.core.membership").StableMembership(4)
        before = {k: m.owner(k) for k in keys}
        m.remove(2)
        after = {k: m.owner(k) for k in keys}
        for k in keys:
            if before[k] != 2:
                assert after[k] == before[k], k
            else:
                assert after[k] != 2 and m.is_live(after[k])
        m.rejoin(2)
        assert {k: m.owner(k) for k in keys} == before
        shards = [m.owned_by(i, keys) for i in range(4)]
        assert sorted(k for s in shards for k in s) == sorted(keys)
        two = importlib.import_module(f"{root}.core.membership").StableMembership(2)
        two.remove(0)
        with pytest.raises(ValueError):
            two.remove(1)
        seen[root] = (before, after, shards, m.describe(keys))
    assert seen[PORT] == seen[JAX]


# ------------------------------------------- two-level routing + facade


def _routed(pkg, n=3):
    f = pkg.facade(n, record_ops=True)
    for c in range(n):
        for i in range(2):
            f.add_node(c, pkg.node(f"c{c}-n{i}", f"ig-{c}"))
    return f


def test_hosting_pick_routes_to_group_host():
    def run(pkg):
        f = _routed(pkg)
        try:
            pods = pkg.pods("app-host", 2, "ig-1")
            ds = [dec(f.schedule(p)) for p in pods]
            assert ds[0][0] and ds[0][3] == 1
            assert all(d[0] and d[3] == 1 for d in ds[1:])
            assert f.router.picks["hosting"] == 1
            assert f.router.picks["affinity"] == 2
            return ds, state(f), specs(f), pkg.verify(f)
        finally:
            f.stop()

    both(run)


def test_headroom_pick_prefers_emptier_host():
    def run(pkg):
        f = pkg.facade(2, record_ops=True)
        try:
            f.add_node(0, pkg.node("c0-n0", "ig-s"))
            for i in range(2):
                f.add_node(1, pkg.node(f"c1-n{i}", "ig-s"))
            d = dec(f.schedule(pkg.pods("app-hr", 1, "ig-s")[0]))
            assert d[0] and d[3] == 1
            assert f.router.picks["headroom"] == 1
            return d, state(f)
        finally:
            f.stop()

    both(run)


def test_hash_pick_for_unhosted_group_is_stable():
    def run(pkg):
        f = _routed(pkg)
        try:
            home, reason = f.router.route("ghost-app", "ig-nowhere")
            assert reason == "hash"
            f.router.unbind("ghost-app")
            again, _ = f.router.route("ghost-app", "ig-nowhere")
            assert again == home
            return home, f.router.describe()
        finally:
            f.stop()

    both(run)


def test_wrong_cluster_call_is_forwarded_and_identical():
    def run(pkg):
        f = _routed(pkg)
        try:
            pod = pkg.pods("app-fwd", 1, "ig-0")[0]
            d = f.schedule(pod, via=2)
            assert d.ok and d.cluster == 0 and f.forwarded == 1
            assert d.result.node_names[0].startswith("c0-")
            return dec(d), state(f), pkg.verify(f)
        finally:
            f.stop()

    both(run)


# ------------------------------------------------------------ spillover


def _two_homes(pkg, max_hops=1):
    f = pkg.facade(2, record_ops=True, max_spillover_hops=max_hops)
    f.add_node(0, pkg.node("c0-n0", "ig-s"))
    f.add_node(1, pkg.node("c1-n0", "ig-s"))
    return f


def _fill(pkg, f, cluster, app_id, executors=6):
    pods = pkg.pods(app_id, executors, "ig-s")
    f.router.bind(app_id, cluster)
    out = [dec(f.schedule(p)) for p in pods]
    assert all(d[0] for d in out)
    return out


def test_denied_driver_spills_to_sibling_and_executors_follow():
    def run(pkg):
        f = _two_homes(pkg)
        try:
            out = _fill(pkg, f, 0, "filler")
            pods = pkg.pods("spill-app", 2, "ig-s")
            f.router.bind("spill-app", 0)
            d = f.schedule(pods[0])
            assert d.ok and d.cluster == 1 and d.spilled_from == 0
            assert f.spillover.spilled == 1
            out.append(dec(d))
            for p in pods[1:]:
                dd = f.schedule(p)
                assert dd.ok and dd.cluster == 1 and dd.spilled_from is None
                out.append(dec(dd))
            home = f.stacks[0]
            assert home.backend.get("pods", "ns", pods[0].name) is None
            assert not [
                dm for dm in home.backend.list("demands")
                if "spill-app" in dm.name
            ]
            recs = home.app.recorder.query(app="spill-app")
            assert recs and recs[0]["verdict"] == "spillover"
            assert "sibling cluster 1" in recs[0]["message"]
            return (out, recs[0]["message"], state(f), specs(f),
                    pkg.verify(f))
        finally:
            f.stop()

    both(run)


def test_spillover_denied_everywhere_leaves_home_demand():
    def run(pkg):
        f = _two_homes(pkg)
        try:
            out = _fill(pkg, f, 0, "filler-a") + _fill(pkg, f, 1, "filler-b")
            pods = pkg.pods("doomed-app", 2, "ig-s")
            f.router.bind("doomed-app", 0)
            d = f.schedule(pods[0])
            assert not d.ok and d.cluster == 0
            assert d.spillover_attempts == 1 and f.spillover.denied == 1
            demands = sorted(
                dm.name for dm in f.stacks[0].backend.list("demands")
                if "doomed-app" in dm.name
            )
            assert demands
            assert f.stacks[1].backend.get("pods", "ns", pods[0].name) is None
            return out + [dec(d)], demands, state(f), pkg.verify(f)
        finally:
            f.stop()

    both(run)


def test_zero_hops_disables_spillover():
    def run(pkg):
        f = _two_homes(pkg, max_hops=0)
        try:
            _fill(pkg, f, 0, "filler")
            pod = pkg.pods("capped-app", 2, "ig-s")[0]
            f.router.bind("capped-app", 0)
            d = f.schedule(pod)
            assert not d.ok and d.spillover_attempts == 0
            assert f.spillover.spilled == 0
            return dec(d), state(f)
        finally:
            f.stop()

    both(run)


# ------------------------------------------------------- kill / rejoin


def test_placed_app_denies_while_home_down_and_never_double_places():
    def run(pkg):
        f = pkg.facade(2, record_ops=True)
        try:
            for c in range(2):
                f.add_node(c, pkg.node(f"c{c}-n0", "ig-kr"))
            pods = pkg.pods("placed-app", 2, "ig-kr")
            out = [dec(f.schedule(p)) for p in pods[:2]]
            assert all(d[0] for d in out)
            home = f.router.affinity_of("placed-app")
            out.append(f.kill_cluster(home))
            d = f.schedule(pods[2])
            assert not d.ok and d.unavailable
            assert f.unavailable_denials == 1
            out.append(dec(d))
            holders = [
                s.index for s in f.stacks
                if any(rr.name == "placed-app"
                       for rr in s.backend.list("resourcereservations"))
            ]
            assert holders == [home]
            out.append(state(f))
            f.rejoin_cluster(home)
            d = f.schedule(pods[2])
            assert d.ok and d.cluster == home
            return out + [dec(d), state(f), specs(f), pkg.verify(f)]
        finally:
            f.stop()

    both(run)


def test_pending_orphan_reroutes_to_survivor():
    def run(pkg):
        f = pkg.facade(2, record_ops=True)
        try:
            f.add_node(0, pkg.node("c0-n0", "ig-or"))
            f.add_node(1, pkg.node("c1-n0", "ig-or"))
            out = []
            for fid, cluster in (("filler-a", 0), ("filler-b", 1)):
                f.router.bind(fid, cluster)
                for p in pkg.pods(fid, 6, "ig-or"):
                    d = f.schedule(p)
                    assert d.ok
                    out.append(dec(d))
            gang = pkg.pods("orphan-app", 2, "ig-or")
            f.router.bind("orphan-app", 0)
            d = f.schedule(gang[0])
            assert not d.ok and d.cluster == 0
            out.append(dec(d))
            assert f.kill_cluster(0) == 1
            assert f.router.affinity_of("orphan-app") is None
            f.add_node(1, pkg.node("c1-n1", "ig-or"))
            for p in gang:
                d = f.schedule(p)
                assert d.ok and d.cluster == 1
                out.append(dec(d))
            assert f.router.rerouted_orphans == 1
            return out, state(f), specs(f), pkg.verify(f)
        finally:
            f.stop()

    both(run)


# ---------------------------- byte-identity under churn x solver configs


CHURN_CONFIGS = [
    pytest.param({}, id="default"),
    pytest.param({"solver_prune_top_k": 4}, id="pruned"),
    pytest.param({"solver_device_pool": 2}, id="pooled"),
]


@pytest.mark.parametrize("cfg_kw", CHURN_CONFIGS)
def test_randomized_churn_matches_jax_and_replays(cfg_kw):
    def run(pkg):
        rng = np.random.default_rng(11)
        f = pkg.facade(3, cfg_kw, record_ops=True)
        try:
            for c in range(3):
                for g in (c, (c + 1) % 3):
                    f.add_node(c, pkg.node(f"c{c}-g{g}-n0", f"ig-{g}"))
            live, out = {}, []
            for step in range(25):
                roll = rng.random()
                if roll < 0.6 or not live:
                    app = f"churn-{step}"
                    group = f"ig-{int(rng.integers(0, 3))}"
                    pods = pkg.pods(app, int(rng.integers(1, 3)), group)
                    ds = [f.schedule(p) for p in pods]
                    out += [dec(d) for d in ds]
                    if ds[0].ok:
                        live[app] = (ds[0].cluster, pods)
                elif roll < 0.8 and live:
                    app = sorted(live)[int(rng.integers(0, len(live)))]
                    cluster, pods = live.pop(app)
                    for p in pods:
                        f.stacks[cluster].terminate_pod(p)
                else:
                    app = sorted(live)[int(rng.integers(0, len(live)))]
                    cluster, pods = live.pop(app)
                    for p in pods:
                        f.stacks[cluster].delete_pod(p)
                    f.router.unbind(app)
            report = pkg.verify(f)
            assert set(report) == {0, 1, 2}
            assert all(r["identical"] for r in report.values())
            for s in f.stacks:
                assert s.aggregates.oracle_equals(), f"cluster {s.index}"
            return out, specs(f), report, state(f)["router"]
        finally:
            f.stop()

    both(run)


def test_aggregates_equal_walk_oracle_and_jax():
    def run(pkg):
        stack = pkg.stack(threaded=False)
        try:
            for i in range(4):
                stack.add_node(pkg.node(f"n{i}", "ig-a"))
            for k in range(3):
                for p in pkg.pods(f"agg-{k}", 2, "ig-a"):
                    stack.schedule(p)
            agg = stack.aggregates
            assert agg.hosts_group("ig-a") and not agg.hosts_group("ig-x")
            assert agg.oracle_equals()
            first = agg.stats()
            stack.backend.delete("nodes", "", "n3")
            assert agg.oracle_equals()
            free = agg.free_total()
            assert free[0] > 0 and agg.top_node_free()[0] > 0
            return first, agg.stats(), stack.reservation_specs()
        finally:
            stack.stop()

    both(run)


def test_replay_standalone_on_the_cpu_equals_the_fleet():
    """The oracle itself: a cluster's oplog re-served standalone on the
    port gives the decisions the port fleet recorded."""
    pkg = Pkg(PORT)
    f = _routed(pkg, n=2)
    try:
        for k in range(3):
            for p in pkg.pods(f"sa-{k}", 1, "ig-1"):
                f.schedule(p)
        oplog = f.stacks[1].oplog
        stack, results = pkg.mod("fleet").replay_standalone(
            oplog, f.stacks[1].config, device="cpu"
        )
        try:
            want = [e[3] for e in oplog if e[0] == "schedule"]
            assert [(r.ok, r.node_names, r.outcome) for r in results] == [
                (r.ok, r.node_names, r.outcome) for r in want
            ]
            assert stack.reservation_specs() == f.stacks[1].reservation_specs()
        finally:
            stack.stop()
    finally:
        f.stop()


# -------------------------------------------------- config + HTTP surface


def test_fleet_block_parses_and_builds_on_the_port():
    InstallConfig = importlib.import_module(f"{PORT}.server.config").InstallConfig
    cfg = InstallConfig.from_dict({})
    assert not cfg.fleet_enabled
    assert cfg.fleet_clusters == 2 and cfg.fleet_max_spillover_hops == 1
    cfg = InstallConfig.from_dict(
        {"fleet": {"enabled": True, "clusters": 3, "max-spillover-hops": 2,
                   "stack-window-ms": 5}}
    )
    assert cfg.fleet_enabled and cfg.fleet_clusters == 3
    assert cfg.fleet_max_spillover_hops == 2
    assert cfg.fleet_stack_window_ms == 5.0
    # build_scheduler_app accepts the fleet keys (one app per cluster).
    app_mod = importlib.import_module(f"{PORT}.server.app")
    backend = importlib.import_module(f"{PORT}.store.backend").InMemoryBackend()
    app = app_mod.build_scheduler_app(backend, cfg, device="cpu")
    app.stop()
    f = importlib.import_module(f"{PORT}.fleet").FleetFacade(
        cfg.fleet_clusters, cfg, device="cpu",
        max_spillover_hops=cfg.fleet_max_spillover_hops,
    )
    try:
        assert len(f.stacks) == 3 and f.spillover.max_hops == 2
        assert f.dispatch is not None
        assert f.dispatch.describe()["window_ms"] == 5.0
    finally:
        f.stop()


POD = {
    "metadata": {
        "name": "fleet-http-driver", "namespace": "ns", "uid": "uid-fh",
        "labels": {"spark-role": "driver", "spark-app-id": "fleet-http"},
        "annotations": {
            "spark-driver-cpu": "1", "spark-driver-mem": "1Gi",
            "spark-executor-cpu": "1", "spark-executor-mem": "1Gi",
            "spark-executor-count": "1",
        },
        "creationTimestamp": "2026-08-07T12:00:00Z",
    },
    "spec": {
        "schedulerName": "spark-scheduler",
        "nodeSelector": {"resource_channel": "ig-1"},
        "containers": [{"name": "main", "resources": {
            "requests": {"cpu": "1", "memory": "1Gi"}}}],
    },
    "status": {"phase": "Pending"},
}


def test_debug_fleet_and_cluster_tagged_predicate_match_jax():
    def run(pkg):
        http = pkg.mod("server.http")
        registry = pkg.mod("metrics.registry").MetricRegistry()
        f = pkg.facade(2, record_ops=True, registry=registry)
        for c in range(2):
            f.add_node(c, pkg.node(f"c{c}-n0", f"ig-{c}"))
        server = http.SchedulerHTTPServer(
            f.stacks[0].app, registry, host="127.0.0.1", port=0, fleet=f
        )
        server.start()
        try:
            def req(method, path, payload=None):
                r = urllib.request.Request(
                    f"http://127.0.0.1:{server.port}{path}",
                    data=(json.dumps(payload).encode()
                          if payload is not None else None),
                    method=method,
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(r) as resp:
                    return resp.status, resp.read()

            status, body = req("GET", "/debug/fleet")
            first = json.loads(body)
            assert status == 200
            assert [c["live"] for c in first["clusters"]] == [True, True]
            status, result = req(
                "POST", "/predicates?cluster=0", {"Pod": POD, "NodeNames": []}
            )
            assert status == 200
            assert json.loads(result)["NodeNames"] == ["c1-n0"]
            status, body = req("GET", "/debug/fleet")
            after = json.loads(body)
            assert after["forwarded"] == 1
            assert after["router"]["picks"]["hosting"] == 1
            series = sorted(
                k for k in registry.snapshot()
                if "scheduler.fleet." in k
            )
            assert series
            for d in (first, after):
                d["stacking"].pop("gather_wait_ms", None)
            return first, result, after, series
        finally:
            server.stop()
            f.stop()

    both(run)
