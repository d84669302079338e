"""The elastic autoscaler of the port (`autoscaler.enabled`) and its
census: the provisioner's packing math and zone policy, the controller's
phase decisions under the max-cluster-size cap, the two-phase drainer
(TTL, never a reserved node, uncordon on a race, re-adoption after a
restart, never the static fleet), the runtime reload of its knobs and the
end-to-end scenario (demand, provision, place, drain), each run on the
JAX package and on the port (`device="cpu"`) with the same inputs; and
`ClusterCensus` against its own `rebuild()` and the JAX census after
seeded random node, pod and reservation events.

The cases are those of tests/test_autoscaler.py (13), with their own
assertions kept; besides, every run's summaries, demand phases, node
fleet (names, zones, labels, cordons), drained nodes and autoscaler
metric counts must be equal across the two packages. Pods are stamped
from a counter local to each run. Tolerance: none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from tests.test_torch_policy import both


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _res(pkg, cpu, mem, gpu="0"):
    return pkg.mod("models.resources").Resources.from_quantities(
        cpu, mem, gpu, round_up=False)


def elastic_harness(pkg, clock=None, **kw):
    kw.setdefault("autoscaler_idle_ttl_s", 60.0)
    kw.setdefault("autoscaler_max_cluster_size", 100)
    return pkg.harness(autoscaler_enabled=True, clock=clock or FakeClock(), **kw)


def fleet(h):
    """The node fleet: name, zone, labels and cordon of every node."""
    return sorted(
        (n.name, n.zone, sorted(n.labels.items()), n.unschedulable)
        for n in h.backend.list_nodes()
    )


def demand_phases(h):
    return sorted(
        (d.name, d.status.phase, d.status.fulfilled_zone)
        for d in h.backend.list("demands")
    )


def nodes_needed_first_fit(pkg):
    unit = pkg.mod("models.demands").DemandUnit
    needed = pkg.mod("autoscaler.provisioner").nodes_needed
    template = _res(pkg, "8", "8Gi", "1")
    units = [unit(resources=_res(pkg, "1", "1Gi"), count=1),
             unit(resources=_res(pkg, "1", "1Gi"), count=15)]
    assert needed(units, template) == 2
    assert needed([unit(_res(pkg, "1", "4Gi"), 3)], template) == 2
    rng = np.random.default_rng(11)
    out = []
    for _ in range(24):
        us = [unit(_res(pkg, str(int(c)), f"{int(m)}Gi"), int(k))
              for c, m, k in zip(rng.integers(1, 9, 3), rng.integers(1, 9, 3),
                                 rng.integers(1, 12, 3))]
        out.append(needed(us, template))
    return out


def nodes_needed_impossible(pkg):
    unit = pkg.mod("models.demands").DemandUnit
    needed = pkg.mod("autoscaler.provisioner").nodes_needed
    template = _res(pkg, "8", "8Gi", "1")
    assert needed([unit(_res(pkg, "16", "1Gi"), 1)], template) is None
    return [needed([unit(_res(pkg, c, m, g), 1)], template)
            for c, m, g in (("16", "1Gi", "0"), ("1", "9Gi", "0"),
                            ("1", "1Gi", "2"), ("8", "8Gi", "1"))]


def provisioner_zone_pin(pkg):
    asc = pkg.mod("autoscaler")
    label = pkg.hm.INSTANCE_GROUP_LABEL
    backend = pkg.mod("store.backend").InMemoryBackend()
    prov = asc.NodeProvisioner(backend, label, _res(pkg, "8", "8Gi", "1"),
                               zones=["za", "zb"], clock=lambda: 5.0)
    pinned = prov.provision(3, "group-x", "zb")
    assert all(n.zone == "zb" for n in pinned)
    assert all(n.labels[asc.PROVISIONED_BY_LABEL] == asc.PROVISIONER_NAME
               and n.labels[label] == "group-x" for n in pinned)
    spread = prov.provision(4, "group-x", None)
    assert {n.zone for n in spread} == {"za", "zb"}
    assert len(backend.list_nodes()) == 7
    return [(n.name, n.zone, sorted(n.labels.items()), n.creation_timestamp)
            for n in backend.list_nodes()]


def demand_zone(pkg):
    asc = pkg.mod("autoscaler")
    dm = pkg.mod("models.demands")
    h = elastic_harness(pkg, autoscaler_zones=["zone1", "zone2", "zone3"])
    driver = pkg.static("app-z", 2)[0]
    h.add_pods(driver)
    demand = h.app.demand_manager.create_demand_for_executor(
        driver, _res(pkg, "1", "1Gi"), zone="zone2")
    assert demand is not None
    summary = h.autoscaler.run_once()
    d = h.backend.get("demands", demand.namespace, demand.name)
    assert d.status.phase == dm.PHASE_FULFILLED
    assert d.status.fulfilled_zone == "zone2"
    added = [n for n in h.backend.list_nodes()
             if n.labels.get(asc.PROVISIONED_BY_LABEL) == asc.PROVISIONER_NAME]
    zone_label = pkg.mod("models.kube").ZONE_LABEL
    assert added and all(n.labels[zone_label] == "zone2" for n in added)
    return [summary, demand_phases(h), fleet(h)]


def cap_cannot_fulfill(pkg):
    dm = pkg.mod("models.demands")
    h = elastic_harness(pkg, autoscaler_max_cluster_size=2)
    h.add_nodes(pkg.node("n0"), pkg.node("n1"))
    pods = pkg.static("app-cap", 30)
    r = h.schedule(pods[0], ["n0", "n1"])
    assert not r.ok
    summary = h.autoscaler.run_once()
    assert summary["unfulfillable"] == 1 and summary["nodes_added"] == 0
    d = h.backend.list("demands")[0]
    assert d.status.phase == dm.PHASE_CANNOT_FULFILL
    counts = h.autoscaler.metrics.counts()
    assert counts["demands_unfulfillable"] == 1
    return [summary, demand_phases(h), counts]


def oldest_first_under_cap(pkg):
    dm = pkg.mod("models.demands")
    clock = FakeClock()
    h = elastic_harness(pkg, clock=clock, autoscaler_max_cluster_size=3)
    h.add_nodes(pkg.node("n0"))
    old_driver = pkg.static("app-old", 10)[0]
    h.add_pods(old_driver)
    assert not h.schedule(old_driver, ["n0"]).ok
    clock.advance(5.0)
    new_driver = pkg.static("app-new", 10)[0]
    h.add_pods(new_driver)
    assert not h.schedule(new_driver, ["n0"]).ok
    summary = h.autoscaler.run_once()
    phases = {d.name: d.status.phase for d in h.backend.list("demands")}
    assert phases["demand-app-old-driver"] == dm.PHASE_FULFILLED
    assert phases["demand-app-new-driver"] == dm.PHASE_CANNOT_FULFILL
    return [summary, demand_phases(h), fleet(h)]


def _drainer_rig(pkg, clock, ttl=60.0):
    h = elastic_harness(pkg, clock=clock, autoscaler_idle_ttl_s=ttl)
    nodes = h.autoscaler.provisioner.provision(2, "batch-medium-priority", None)
    return h, nodes


def drainer_two_phase(pkg):
    clock = FakeClock()
    h, nodes = _drainer_rig(pkg, clock)
    drainer = h.autoscaler.drainer
    out = [drainer.run_once()]
    assert out[-1] == []
    clock.advance(59.0)
    out.append(drainer.run_once())
    assert out[-1] == []
    assert not any(n.unschedulable for n in h.backend.list_nodes())
    clock.advance(2.0)
    out.append(drainer.run_once())
    assert out[-1] == []
    assert all(n.unschedulable for n in h.backend.list_nodes())
    out.append(fleet(h))
    out.append(drainer.run_once())
    assert sorted(out[-1]) == sorted(n.name for n in nodes)
    assert h.backend.list_nodes() == []
    return out


def drainer_never_reserved(pkg):
    clock = FakeClock()
    h, nodes = _drainer_rig(pkg, clock)
    hard, soft = nodes
    rmod = pkg.mod("models.reservations")
    h.app.rr_cache.create(rmod.ResourceReservation(
        name="app-hard", namespace="namespace",
        spec=rmod.ReservationSpec(reservations={
            "driver": rmod.Reservation(hard.name, _res(pkg, "1", "1Gi"))}),
    ))
    h.app.soft_store.create_soft_reservation_if_not_exists("app-soft")
    h.app.soft_store.add_reservation_for_pod(
        "app-soft", "exec-1", rmod.Reservation(soft.name, _res(pkg, "1", "1Gi")))
    clock.advance(1e6)
    out = []
    for _ in range(3):
        out.append(h.autoscaler.drainer.run_once())
        assert out[-1] == []
    live = {n.name: n for n in h.backend.list_nodes()}
    assert set(live) == {hard.name, soft.name}
    assert not any(n.unschedulable for n in live.values())
    return out + [fleet(h), sorted(h.autoscaler.drainer.reserved_node_names())]


def drainer_uncordons(pkg):
    clock = FakeClock()
    h, nodes = _drainer_rig(pkg, clock)
    rmod = pkg.mod("models.reservations")
    drainer = h.autoscaler.drainer
    drainer.run_once()
    clock.advance(61.0)
    drainer.run_once()
    target = nodes[0].name
    h.app.soft_store.create_soft_reservation_if_not_exists("app-race")
    h.app.soft_store.add_reservation_for_pod(
        "app-race", "exec-1", rmod.Reservation(target, _res(pkg, "1", "1Gi")))
    drained = drainer.run_once()
    assert drained == [n.name for n in nodes if n.name != target]
    survivor = h.backend.get_node(target)
    assert survivor is not None and not survivor.unschedulable
    return [drained, fleet(h)]


def drainer_readopts(pkg):
    asc = pkg.mod("autoscaler")
    clock = FakeClock()
    h, nodes = _drainer_rig(pkg, clock)
    drainer = h.autoscaler.drainer
    drainer.run_once()
    clock.advance(61.0)
    drainer.run_once()
    assert all(n.unschedulable for n in h.backend.list_nodes())
    fresh = asc.ScaleDownDrainer(h.backend, h.app.rr_cache, h.app.soft_store,
                                 idle_ttl_s=60.0, clock=clock)
    out = [fresh.run_once()]
    assert out[-1] == []
    clock.advance(59.0)
    out.append(fresh.run_once())
    assert out[-1] == []
    clock.advance(2.0)
    out.append(fresh.run_once())
    assert out[-1] == []
    out.append(fresh.run_once())
    assert sorted(out[-1]) == sorted(n.name for n in nodes)
    assert h.backend.list_nodes() == []
    return out


def drainer_static_fleet(pkg):
    clock = FakeClock()
    h = elastic_harness(pkg, clock=clock, autoscaler_idle_ttl_s=10.0)
    h.add_nodes(pkg.node("static-0"))
    clock.advance(1e6)
    out = []
    for _ in range(3):
        out.append(h.autoscaler.drainer.run_once())
        assert out[-1] == []
    assert h.backend.get_node("static-0") is not None
    return out + [fleet(h)]


def runtime_reload(pkg, tmp_path):
    h = elastic_harness(pkg)
    path = tmp_path / f"runtime-{pkg.root}.yml"
    path.write_text("autoscaler:\n  idle-ttl: 5m\n  max-cluster-size: 7\n")
    mgr = pkg.mod("server.runtime").RuntimeConfigManager(h.app, str(path))
    assert mgr.check_now()
    assert h.autoscaler.drainer.idle_ttl_s == 300.0
    assert h.autoscaler.max_cluster_size == 7
    return [h.autoscaler.drainer.idle_ttl_s, h.autoscaler.max_cluster_size]


def end_to_end(pkg, binpack):
    clock = FakeClock()
    h = pkg.harness(binpack_algo=binpack, autoscaler_enabled=True,
                    autoscaler_idle_ttl_s=60.0, autoscaler_max_cluster_size=50,
                    autoscaler_zones=["zone1", "zone2"], clock=clock)
    h.add_nodes(pkg.node("n0"))
    pods = pkg.static("app-e2e", 20)
    out = []
    r = h.schedule(pods[0], ["n0"])
    out.append((r.outcome, list(r.node_names)))
    assert not r.ok
    summary = h.autoscaler.run_once()
    out += [summary, demand_phases(h), fleet(h)]
    assert summary["fulfilled"] == 1 and summary["nodes_added"] >= 2
    names = [n.name for n in h.backend.list_nodes()]
    for p in pods:
        r = h.schedule(p, names)
        out.append((p.name, r.outcome, list(r.node_names)))
        assert r.ok, p.name
    assert h.demands() == []
    clock.advance(1e5)
    for _ in range(3):
        out.append(h.autoscaler.run_once())
    reserved = h.autoscaler.drainer.reserved_node_names()
    assert reserved and reserved <= {n.name for n in h.backend.list_nodes()}
    out.append(sorted(reserved))
    for p in pods:
        cur = h.backend.get("pods", p.namespace, p.name)
        if cur is not None:
            h.backend.delete_pod(cur)
    rr = h.get_reservation("namespace", "app-e2e")
    h.app.rr_cache.delete(rr.namespace, rr.name)
    out.append(h.autoscaler.run_once())
    clock.advance(61.0)
    out.append(h.autoscaler.run_once())
    last = h.autoscaler.run_once()
    out.append(last)
    drained = last["drained"]
    assert drained
    assert h.backend.get_node("n0") is not None
    counts = h.autoscaler.metrics.counts()
    assert counts["demands_fulfilled"] == 1
    assert counts["nodes_drained"] == len(drained)
    samples = h.autoscaler.metrics.scaleup_latency_samples()
    assert samples
    census = h.autoscaler._census
    stats = census.stats()
    census.rebuild()
    rebuilt = census.stats()
    assert {k: v for k, v in stats.items() if k not in ("rebuilds", "events_applied")} \
        == {k: v for k, v in rebuilt.items() if k not in ("rebuilds", "events_applied")}
    return out + [counts, samples, fleet(h), stats]


AUTOSCALER_CASES = {
    "nodes_needed_first_fit": (nodes_needed_first_fit, ()),
    "nodes_needed_impossible": (nodes_needed_impossible, ()),
    "provisioner_zone_pin": (provisioner_zone_pin, ()),
    "demand_zone": (demand_zone, ()),
    "cap_cannot_fulfill": (cap_cannot_fulfill, ()),
    "oldest_first_under_cap": (oldest_first_under_cap, ()),
    "drainer_two_phase": (drainer_two_phase, ()),
    "drainer_never_reserved": (drainer_never_reserved, ()),
    "drainer_uncordons": (drainer_uncordons, ()),
    "drainer_readopts": (drainer_readopts, ()),
    "drainer_static_fleet": (drainer_static_fleet, ()),
    "runtime_reload": (runtime_reload, ("tmp_path",)),
    "end_to_end[tightly-pack]": (end_to_end, ("tightly-pack",)),
    "end_to_end[single-az-tightly-pack]": (end_to_end, ("single-az-tightly-pack",)),
}


@pytest.mark.parametrize("name", sorted(AUTOSCALER_CASES))
def test_autoscaler_case_matches_jax(name, tmp_path):
    fn, args = AUTOSCALER_CASES[name]
    both(fn, *[tmp_path if a == "tmp_path" else a for a in args])


# ------------------------------------------------------------------ census


def census_events(pkg, seed, steps=300):
    """A census over an in-memory backend, a reservation cache and a soft
    store, fed seeded random node (add, cordon, relabel, delete), pod (add
    bound or pending, bind, terminate, delete) and reservation (hard
    create / update / delete, soft add / remove) events. After every
    20th event its stats must equal its rebuild()'s. Returns the stats
    trace and the final mirrors."""
    backend = pkg.mod("store.backend").InMemoryBackend()
    rr_cache = pkg.mod("store.cache").ResourceReservationCache(
        backend, sync_writes=True)
    soft = pkg.mod("core.soft_reservations").SoftReservationStore(backend)
    asc = pkg.mod("autoscaler")
    census = pkg.mod("core.census").ClusterCensus(
        backend, rr_cache, soft,
        eligible_label=(asc.PROVISIONED_BY_LABEL, asc.PROVISIONER_NAME))
    kube = pkg.mod("models.kube")
    rmod = pkg.mod("models.reservations")
    res = _res(pkg, "1", "1Gi")
    rng = np.random.default_rng(seed)
    nodes, pods, rrs, softs = {}, {}, {}, {}
    trace = []

    def node_names():
        return sorted(nodes)

    for step in range(steps):
        op = int(rng.integers(0, 10))
        if op == 0 or not nodes:
            name = f"n{step}"
            labels = {kube.ZONE_LABEL: f"z{int(rng.integers(0, 3))}"}
            if rng.random() < 0.5:
                labels[asc.PROVISIONED_BY_LABEL] = asc.PROVISIONER_NAME
            node = kube.Node(name=name, allocatable=_res(pkg, "8", "8Gi"),
                             labels=labels)
            backend.add_node(node)
            nodes[name] = node
        elif op == 1:
            name = node_names()[int(rng.integers(0, len(nodes)))]
            cur = backend.get_node(name)
            labels = dict(cur.labels)
            if rng.random() < 0.5:
                labels.pop(asc.PROVISIONED_BY_LABEL, None)
            else:
                labels[asc.PROVISIONED_BY_LABEL] = asc.PROVISIONER_NAME
            new = dataclasses.replace(cur, labels=labels,
                                      unschedulable=bool(rng.random() < 0.5))
            backend.update("nodes", new)
            nodes[name] = new
        elif op == 2 and len(nodes) > 2:
            name = node_names()[int(rng.integers(0, len(nodes)))]
            backend.delete("nodes", "", name)
            del nodes[name]
        elif op in (3, 4):
            name = f"p{step}"
            bound = node_names()[int(rng.integers(0, len(nodes)))] \
                if rng.random() < 0.7 else None
            pod = kube.Pod(name=name, namespace="ns", uid=f"u{step}",
                           node_name=bound, phase="Running" if bound else "Pending",
                           containers=[kube.Container(requests=res)])
            backend.add_pod(pod)
            pods[name] = pod
        elif op == 5 and pods:
            name = sorted(pods)[int(rng.integers(0, len(pods)))]
            cur = backend.get("pods", "ns", name)
            if rng.random() < 0.5:
                new = dataclasses.replace(
                    cur, node_name=node_names()[int(rng.integers(0, len(nodes)))])
            else:
                new = dataclasses.replace(cur, phase="Succeeded")
            backend.update_pod(new)
        elif op == 6 and pods:
            name = sorted(pods)[int(rng.integers(0, len(pods)))]
            backend.delete_pod(backend.get("pods", "ns", name))
            del pods[name]
        elif op == 7:
            app = f"app{int(rng.integers(0, 12))}"
            slots = {
                f"s{k}": rmod.Reservation(
                    node_names()[int(rng.integers(0, len(nodes)))], res)
                for k in range(int(rng.integers(1, 4)))
            }
            rr = rmod.ResourceReservation(
                name=app, namespace="ns",
                spec=rmod.ReservationSpec(reservations=slots))
            if rr_cache.get("ns", app) is None:
                rr_cache.create(rr)
            else:
                cur = rr_cache.get("ns", app)
                rr_cache.update(dataclasses.replace(cur, spec=rr.spec))
            rrs[app] = True
        elif op == 8 and rrs:
            app = sorted(rrs)[int(rng.integers(0, len(rrs)))]
            if rr_cache.get("ns", app) is not None:
                rr_cache.delete("ns", app)
            del rrs[app]
        else:
            app = f"soft{int(rng.integers(0, 6))}"
            soft.create_soft_reservation_if_not_exists(app)
            if rng.random() < 0.7 or not softs.get(app):
                pod = f"e{step}"
                soft.add_reservation_for_pod(app, pod, rmod.Reservation(
                    node_names()[int(rng.integers(0, len(nodes)))], res))
                softs.setdefault(app, []).append(pod)
            else:
                soft.remove_executor_reservation(app, softs[app].pop(0))
        if step % 20 == 19:
            live = census.stats()
            live_views = (sorted(census.nodes_view()), sorted(census.eligible_view()),
                          sorted(census.reserved_node_names()))
            census.rebuild()
            oracle = census.stats()
            oracle_views = (sorted(census.nodes_view()), sorted(census.eligible_view()),
                            sorted(census.reserved_node_names()))
            keep = ("nodes", "eligible", "busy_nodes", "reserved_nodes")
            assert {k: live[k] for k in keep} == {k: oracle[k] for k in keep}, step
            assert live_views == oracle_views, step
            busy = sorted(n for n in nodes if census.is_busy(n))
            trace.append(({k: live[k] for k in keep}, live_views, busy,
                          census.node_count()))
    return trace


@pytest.mark.parametrize("seed", [0, 1])
def test_census_matches_its_rebuild_and_jax(seed):
    trace = both(census_events, seed)
    assert len(trace) == 15
    assert any(t[0]["eligible"] for t in trace)
    assert any(t[0]["reserved_nodes"] for t in trace)
    assert any(t[0]["busy_nodes"] for t in trace)
