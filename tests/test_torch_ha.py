"""Lease-elected HA replicas: the port's ha/ against the JAX package's.

The cases of tests/test_ha.py run once per package on the same fixtures
and a fake clock: the lease's CAS outcomes and epochs, fencing, warm
standbys, promotion that reconciles before serving, racing replicas,
instance-group sharding, the HTTP role surfaces and the leader killed over
a shared WAL. Every outcome, decision, stored object and HTTP body must be
equal across the packages; of the `/debug/ha` body, the promotion and
reconcile wall times are measurements, not state, and are compared for
presence only. On top: the reconcile summary of a replica promoted on a
copy of one WAL, and a leader deposed with a window in flight, then
promoted again. The port's replicas run on `device="cpu"`.

Tolerance: none.
"""

from __future__ import annotations

import copy
import http.client
import importlib
import json
import shutil

import numpy as np
import pytest

from tests.test_torch_extender import canon
from tests.test_torch_kube import JAX, PORT, ROOTS, backend_state
from tests.test_torch_kube import pkg as kube_pkg


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def pkg(root):
    m = kube_pkg(root)
    for attr, name in (
        ("ha", "ha"),
        ("lease", "ha.lease"),
        ("replica", "ha.replica"),
        ("durable", "store.durable"),
        ("demands", "models.demands"),
        ("sparkpods", "core.sparkpods"),
    ):
        setattr(m, attr, importlib.import_module(f"{root}.{name}"))
    return m


def both(scenario, *args):
    out = [scenario(pkg(root), *args) for root in ROOTS]
    assert out[1] == out[0]
    return out[1]


def both_in(tmp_path, scenario, *args):
    out = []
    for root in ROOTS:
        d = tmp_path / root
        d.mkdir()
        out.append(scenario(pkg(root), d, *args))
    assert out[1] == out[0]
    return out[1]


def config(m, ttl=3.0, **kw):
    kw.setdefault("fifo", True)
    kw.setdefault("binpack_algo", "tightly-pack")
    return m.config.InstallConfig(
        instance_group_label=m.harness.INSTANCE_GROUP_LABEL,
        sync_writes=True,
        ha_enabled=True,
        ha_lease_ttl_s=ttl,
        **kw,
    )


def replica(m, backend, rid, clock, cfg=None, **kw):
    return m.replica.build_replica(
        backend, rid, config=cfg or config(m), clock=clock, **kw, **m.cpu
    )


def shared_backend(m):
    backend = m.backend.InMemoryBackend()
    backend.register_crd(m.backend.DEMAND_CRD)
    return backend


def args(m, pod, names):
    return m.extender.ExtenderArgs(pod=pod, node_names=list(names))


def lease_view(mgr):
    """A LeaseManager's state without the fence-reject count's identity."""
    return canon(mgr.state())


def rr_state(app):
    return sorted(
        (canon(rr) for rr in app.rr_cache.list()), key=lambda c: c[1]["name"]
    )


def reserved(app):
    return canon(app.reservation_manager.get_reserved_resources())


def demand(m, name, group="g"):
    D = m.demands
    return D.Demand(
        name=name, namespace="ns",
        spec=D.DemandSpec(units=[], instance_group=group),
        status=D.DemandStatus(phase="pending"),
    )


# ------------------------------------------------------------------- lease


def sc_lease_epochs(m):
    backend = m.backend.InMemoryBackend()
    clock = FakeClock()
    a = m.lease.LeaseManager(m.lease.BackendLeaseStore(backend), "a", 3.0, clock)
    b = m.lease.LeaseManager(m.lease.BackendLeaseStore(backend), "b", 3.0, clock)
    out = [a.try_acquire(), a.acquired_epoch, a.is_held()]
    out += [b.try_acquire(), b.acquired_epoch]
    clock.advance(2.0)
    out += [a.renew(), a.acquired_epoch]
    clock.advance(4.0)
    out += [a.is_held(), b.try_acquire(), b.acquired_epoch, a.renew()]
    with pytest.raises(m.lease.FencingError) as err:
        a.check_fence()
    b.check_fence()
    out += [str(err.value), lease_view(a), lease_view(b)]
    a.release()
    b.release()
    out.append(canon(backend.get("leases", "", m.lease.LEASE_NAME)))
    return out


def test_acquire_renew_takeover_epochs_match_jax():
    out = both(sc_lease_epochs)
    assert out[:11] == [True, 1, True, False, 0, True, 1, False, True, 2, False]


def sc_release_takeover(m):
    backend = m.backend.InMemoryBackend()
    clock = FakeClock()
    a = m.lease.LeaseManager(m.lease.BackendLeaseStore(backend), "a", 3.0, clock)
    b = m.lease.LeaseManager(m.lease.BackendLeaseStore(backend), "b", 3.0, clock)
    out = [a.try_acquire()]
    a.release()
    out += [b.try_acquire(), b.acquired_epoch, lease_view(b)]
    return out


def test_release_enables_immediate_takeover_matches_jax():
    assert both(sc_release_takeover)[:3] == [True, True, 2]


def sc_file_lease(m, d):
    path = str(d / "wal.lease")
    clock = FakeClock()
    a = m.lease.LeaseManager(m.lease.FileLeaseStore(path), "a", ttl_s=3.0, clock=clock)
    b = m.lease.LeaseManager(m.lease.FileLeaseStore(path), "b", ttl_s=3.0, clock=clock)
    out = [a.try_acquire(), a.acquired_epoch, b.try_acquire()]
    with open(path, "rb") as f:
        out.append(f.read())
    clock.advance(10.0)
    out += [b.try_acquire(), b.acquired_epoch]
    with pytest.raises(m.lease.FencingError) as err:
        a.check_fence()
    with open(path, "rb") as f:
        out += [str(err.value), f.read()]
    return out


def test_file_lease_store_cas_matches_jax(tmp_path):
    out = both_in(tmp_path, sc_file_lease)
    assert out[:3] == [True, 1, False] and out[4:6] == [True, 2]


def sc_file_interleaved(m, d):
    path = str(d / "wal.lease")
    clock = FakeClock()
    a = m.lease.LeaseManager(m.lease.FileLeaseStore(path), "a", ttl_s=3.0, clock=clock)
    b = m.lease.LeaseManager(m.lease.FileLeaseStore(path), "b", ttl_s=3.0, clock=clock)
    out = [a.try_acquire()]
    clock.advance(3.5)
    stale = b._store.read()
    out += [stale.expired(clock()), a.renew()]
    out.append(b._store.compare_and_swap(
        stale, m.lease.LeaseRecord("b", stale.epoch + 1, clock(), 3.0)
    ))
    out += [b.try_acquire(), a.is_held()]
    return out


def test_file_takeover_cas_loses_to_interleaved_renewal_matches_jax(tmp_path):
    assert both_in(tmp_path, sc_file_interleaved) == [True, True, True, False, False, True]


# ----------------------------------------------------------------- fencing


def sc_fencing(m):
    backend = m.backend.InMemoryBackend()
    clock = FakeClock()
    a = m.lease.LeaseManager(m.lease.BackendLeaseStore(backend), "a", 3.0, clock)
    b = m.lease.LeaseManager(m.lease.BackendLeaseStore(backend), "b", 3.0, clock)
    rejects = []
    fenced = m.ha.FencedBackend(backend, a.check_fence, on_reject=rejects.append)
    out = [a.try_acquire()]
    fenced.add_node(m.harness.new_node("n0"))
    fenced.create("demands", demand(m, "d1"))
    clock.advance(10.0)
    out.append(b.try_acquire())
    with pytest.raises(m.lease.FencingError) as err:
        fenced.create("demands", demand(m, "d2"))
    fenced.add_node(m.harness.new_node("n1"))
    out += [str(err.value), rejects, fenced.inner is backend, backend_state(backend)]
    return out


def test_fenced_backend_rejects_deposed_writer_matches_jax():
    out = both(sc_fencing)
    assert out[3] == ["demands"] and len(out[5]["nodes"]) == 2
    assert [d[1]["name"] for d in out[5]["demands"]] == ["d1"]


# ----------------------------------------------------- standby warm state


def leader_and_standby(m, clock):
    backend = shared_backend(m)
    leader = replica(m, backend, "r0", clock)
    standby = replica(m, backend, "r1", clock)
    assert leader.lease.try_acquire()
    leader.promote()
    names = [f"n{i}" for i in range(4)]
    for n in names:
        backend.add_node(m.harness.new_node(n))
    return backend, leader, standby, names


def sc_standby_hot(m):
    clock = FakeClock()
    backend, leader, standby, names = leader_and_standby(m, clock)
    pods = m.harness.static_allocation_spark_pods("hot-app", 2)
    backend.add_pod(pods[0])
    res = leader.app.extender.predicate(args(m, pods[0], names))
    out = [canon(res), rr_state(standby.app) == rr_state(leader.app),
           reserved(standby.app), reserved(leader.app),
           standby.tailer.stats(), leader.tailer.stats()]
    leader.app.rr_cache.delete("namespace", "hot-app")
    out += [standby.app.rr_cache.get("namespace", "hot-app") is None,
            standby.tailer.stats()]
    return out


def test_standby_caches_and_usage_stay_hot_match_jax():
    out = both(sc_standby_hot)
    assert out[1] and out[2] == out[3] and out[4]["applied"] > 0
    assert out[5]["applied"] == 0 and out[5]["skipped_own"] > 0 and out[6]


def sc_standby_updates(m):
    clock = FakeClock()
    backend, leader, standby, names = leader_and_standby(m, clock)
    pods = m.harness.static_allocation_spark_pods("upd-app", 2)
    results = []
    for p in pods:
        backend.add_pod(p)
        results.append(canon(leader.app.extender.predicate(args(m, p, names))))
    return (results, rr_state(standby.app), rr_state(leader.app),
            reserved(standby.app), reserved(leader.app))


def test_standby_absorbs_updates_of_existing_objects_matches_jax():
    _, srr, lrr, sres, lres = both(sc_standby_updates)
    assert srr == lrr and sres == lres


def sc_warm_promotion(m):
    clock = FakeClock()
    backend, leader, standby, names = leader_and_standby(m, clock)
    pods = m.harness.static_allocation_spark_pods("surv", 2)
    backend.add_pod(pods[0])
    res = leader.app.extender.predicate(args(m, pods[0], names))
    backend.bind_pod(pods[0], res.node_names[0])
    leader.kill()
    clock.advance(5.0)
    roles = [standby.run_election_once(), standby.is_serving(), leader.is_serving()]
    backend.add_pod(pods[1])
    res1 = standby.app.extender.predicate(args(m, pods[1], names))
    return canon(res), roles, canon(res1), rr_state(standby.app)


def test_warm_promotion_serves_executor_on_restored_reservation_matches_jax():
    _, roles, res1, rrs = both(sc_warm_promotion)
    assert roles == ["leader", True, False]
    slots = rrs[0][1]["spec"][1]["reservations"]
    assert res1[1][0][0] in {r[1]["node"] for k, r in slots.items() if k != "driver"}


# ------------------------------------------------------ deposed recovery


def sc_transient_read(m):
    backend = shared_backend(m)
    clock = FakeClock()
    runtime = replica(m, backend, "r0", clock)
    runtime.lease.try_acquire()
    runtime.promote()
    store = runtime.lease._store
    real_read = store.read
    store.read = lambda: None
    roles = [runtime.run_election_once(), runtime.is_serving()]
    store.read = real_read
    roles += [runtime.run_election_once(), runtime.is_serving()]
    runtime.app.stop()
    return roles


def test_transient_lease_read_failure_is_not_terminal_matches_jax():
    assert both(sc_transient_read) == ["deposed", False, "leader", True]


# ------------------------------------------------ reconciler idempotency


def sc_second_pass(m):
    h = m.harness.Harness(binpack_algo="tightly-pack", fifo=True, **m.cpu)
    names = [f"n{i}" for i in range(6)]
    h.add_nodes(*(m.harness.new_node(n) for n in names))
    for i in range(2):
        for p in m.harness.static_allocation_spark_pods(f"stale-{i}", 2):
            assert h.schedule(p, names).ok
    for i in range(2):
        h.app.rr_cache.delete("namespace", f"stale-{i}")
    first = h.app.reconciler.sync_resource_reservations_and_demands()
    after_first = rr_state(h.app)
    second = h.app.reconciler.sync_resource_reservations_and_demands()
    return canon(first), canon(second), after_first == rr_state(h.app), after_first


def test_second_reconcile_pass_is_a_no_op_matches_jax():
    first, second, unchanged, _ = both(sc_second_pass)
    assert first["created"] == 2 and unchanged
    assert second["created"] == second["patched"] == second["stale_apps"] == 0


def sc_racing(m):
    backend = shared_backend(m)
    clock = FakeClock()
    a = replica(m, backend, "ra", clock)
    b = replica(m, backend, "rb", clock)
    a.lease.try_acquire()
    a.promote()
    names = [f"n{i}" for i in range(6)]
    for n in names:
        backend.add_node(m.harness.new_node(n))
    pods = m.harness.static_allocation_spark_pods("race", 2)
    backend.add_pod(pods[0])
    res = a.app.extender.predicate(args(m, pods[0], names))
    backend.bind_pod(pods[0], res.node_names[0])
    a.app.rr_cache.delete("namespace", "race")
    s1 = a.app.reconciler.sync_resource_reservations_and_demands()
    s2 = b.app.reconciler.sync_resource_reservations_and_demands()
    return canon(s1), canon(s2), backend_state(backend)["resourcereservations"]


def test_racing_replicas_produce_no_duplicates_matches_jax():
    s1, s2, rrs = both(sc_racing)
    assert s1["created"] == 1 and s2["created"] == 0 and len(rrs) == 1


# -------------------------------------------------------- resync heuristic


def counting_harness(m, **kw):
    h = m.harness.Harness(binpack_algo="tightly-pack", fifo=False, **m.cpu, **kw)
    h.add_nodes(m.harness.new_node("n0"))
    calls = []
    real = h.app.reconciler.sync_resource_reservations_and_demands
    h.app.reconciler.sync_resource_reservations_and_demands = (
        lambda: (calls.append(1), real())[1]
    )
    return h, calls


def sc_resync_gap(m, gap):
    h, calls = counting_harness(m, resync_gap_seconds=gap)
    ext = h.app.extender
    pods = m.harness.static_allocation_spark_pods("gap", 1)
    out = [ext._config.resync_gap_seconds]
    ext._last_request = ext._clock() - 30.0
    out.append(canon(h.schedule(pods[0], ["n0"])))
    out.append(len(calls))
    ext._last_request = ext._clock() - 50.0
    out.append(canon(h.schedule(pods[1], ["n0"])))
    out.append(len(calls))
    return out


@pytest.mark.parametrize("gap", [15.0, 40.0])
def test_resync_gap_is_configurable_matches_jax(gap):
    out = both(sc_resync_gap, gap)
    assert out[0] == gap
    assert (out[2], out[4]) == ((1, 2) if gap == 15.0 else (0, 1))


def test_yaml_key_extender_resync_gap_matches_jax():
    got = [
        (
            pkg(r).config.InstallConfig.from_dict(
                {"extender": {"resync-gap-seconds": "2m"},
                 "ha": {"enabled": True, "replica-id": "r7", "lease-ttl": "2s",
                        "heartbeat-interval": "500ms"}}
            ),
            pkg(r).config.InstallConfig.from_dict({}).resync_gap_seconds,
        )
        for r in ROOTS
    ]
    assert canon(got[1][0])[1] == canon(got[0][0])[1] and got[1][1] == got[0][1]
    cfg = got[1][0]
    assert (cfg.resync_gap_seconds, cfg.ha_replica_id, cfg.ha_lease_ttl_s,
            cfg.ha_heartbeat_s) == (120.0, "r7", 2.0, 0.5)


def sc_heuristic_lease_held(m):
    h, calls = counting_harness(m)
    ext = h.app.extender
    clock = FakeClock()
    lease = m.lease.LeaseManager(
        m.lease.BackendLeaseStore(m.backend.InMemoryBackend()), "me", 3.0, clock
    )
    lease.try_acquire()
    ext.ha_lease = lease
    pods = m.harness.static_allocation_spark_pods("held", 1)
    ext._last_request = ext._clock() - 1e6
    out = [canon(h.schedule(pods[0], ["n0"])), len(calls)]
    clock.advance(10.0)
    ext._last_request = ext._clock() - 1e6
    out += [canon(h.schedule(pods[1], ["n0"])), len(calls)]
    return out


def test_heuristic_skipped_while_lease_held_matches_jax():
    out = both(sc_heuristic_lease_held)
    assert (out[1], out[3]) == (0, 1)


# ---------------------------------------------------------------- sharding


def test_shard_map_stable_and_equal_to_jax():
    groups = [f"g{i}" for i in range(64)]
    for n in (1, 2, 3, 5):
        owners = [[pkg(r).ha.ShardMap(n).owner(g) for g in groups] for r in ROOTS]
        assert owners[1] == owners[0]
        assert set(owners[1]) == set(range(n))
    m = pkg(PORT).ha.ShardMap(3)
    j = pkg(JAX).ha.ShardMap(3)
    m.remove(1)
    j.remove(1)
    assert m.describe(groups) == j.describe(groups)


def two_group_workload(m, ga, gb):
    h = m.harness
    nodes = [h.new_node(f"a{i}", instance_group=ga) for i in range(4)] + [
        h.new_node(f"b{i}", instance_group=gb) for i in range(4)
    ]
    apps = []
    for i in range(3):
        apps.append(h.static_allocation_spark_pods(f"app-a{i}", 2, instance_group=ga))
        apps.append(h.static_allocation_spark_pods(f"app-b{i}", 2, instance_group=gb))
    return nodes, apps


def sc_sharded(m, n_replicas, via):
    smap = m.ha.ShardMap(2)
    groups = iter(f"group-{i}" for i in range(64))
    ga = next(g for g in groups if smap.owner(g) == 0)
    gb = next(g for g in groups if smap.owner(g) == 1)
    nodes, apps = two_group_workload(m, ga, gb)
    names = [n.name for n in nodes]
    backend = shared_backend(m)
    group = m.replica.ShardedServingGroup(
        backend, n_replicas, config_factory=lambda i: config(m),
        clock=FakeClock(), **m.cpu,
    )
    group.start()
    for n in nodes:
        backend.add_node(copy.deepcopy(n))
    results = []
    for pods in apps:
        for p in pods:
            p = copy.deepcopy(p)
            backend.add_pod(p)
            res = group.predicate(args(m, p, names), via=via)
            results.append((p.name, canon(res)))
            if res.ok:
                backend.bind_pod(p, res.node_names[0])
    state = group.state()
    for r in state["replicas"]:
        for k in ("promotion_ms", "reconcile_ms"):
            r[k] = r[k] is not None
    out = results, backend_state(backend)["resourcereservations"], group.forwarded, state
    group.stop()
    return out


@pytest.mark.parametrize("n_replicas,via", [(2, 0), (2, 1), (3, 0)])
def test_sharded_decisions_match_jax_and_an_unsharded_replica(n_replicas, via):
    results, rrs, forwarded, _ = both(sc_sharded, n_replicas, via)
    assert forwarded > 0
    # One unsharded JAX replica serving the interleaved sequence gives the
    # same decisions and reservations, group by group.
    m = pkg(JAX)
    smap = m.ha.ShardMap(2)
    groups = iter(f"group-{i}" for i in range(64))
    ga = next(g for g in groups if smap.owner(g) == 0)
    gb = next(g for g in groups if smap.owner(g) == 1)
    nodes, apps = two_group_workload(m, ga, gb)
    control = m.harness.Harness(binpack_algo="tightly-pack", fifo=True)
    control.add_nodes(*(copy.deepcopy(n) for n in nodes))
    names = [n.name for n in nodes]
    want = [
        (p.name, canon(control.schedule(copy.deepcopy(p), names)))
        for pods in apps for p in pods
    ]
    assert results == want
    assert [(r[1]["name"], r[1]["spec"]) for r in rrs] == sorted(
        (r.name, canon(r.spec)) for r in control.backend.list("resourcereservations")
    )


def sc_remove_member(m):
    backend = shared_backend(m)
    group = m.replica.ShardedServingGroup(
        backend, 3, config_factory=lambda i: config(m), clock=FakeClock(), **m.cpu
    )
    group.start()
    groups = [f"group-{i}" for i in range(32)]
    owned = [g for g in groups if group.shard_map.owner(g) == 2]
    with pytest.raises(ValueError) as err0:
        group.remove_member(0)
    before = {g: group.shard_map.owner(g) for g in groups}
    group.remove_member(2)
    after = {g: group.shard_map.owner(g) for g in groups}
    removed = group.replicas[2]
    with pytest.raises(m.lease.FencingError) as err:
        removed.app.backend.create("demands", demand(m, "late", owned[0]))
    for i in range(2):
        backend.add_node(m.harness.new_node(f"rm{i}", instance_group=owned[0]))
    pod = m.harness.static_allocation_spark_pods("app-rm", 1, instance_group=owned[0])[0]
    backend.add_pod(pod)
    res = group.predicate(args(m, pod, ["rm0", "rm1"]), via=0)
    out = (str(err0.value), before, after, removed.is_serving(), str(err.value),
           canon(res), backend_state(backend))
    group.stop()
    return out


def test_remove_member_remaps_and_fences_matches_jax():
    _, before, after, serving, _, res, state = both(sc_remove_member)
    assert all(after[g] == before[g] for g in before if before[g] != 2)
    assert 2 not in after.values() and not serving and res[1][0]
    assert not state["demands"]


# ------------------------------------------------------------ HTTP surface


def http_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = resp.status, resp.read()
    conn.close()
    return out


def timings_present(body):
    """A /debug/ha body with the wall-clock measurements reduced to whether
    they were taken."""
    out = json.loads(body)
    for k in ("promotion_ms", "reconcile_ms"):
        out[k] = out[k] is not None
    return out


def sc_role_surfaces(m):
    backend = shared_backend(m)
    clock = FakeClock()
    cfg = config(m)
    cfg.ha_heartbeat_s = 3600.0  # no tick of its own during the test
    runtime = replica(m, backend, "web-r0", clock, cfg)
    backend.add_node(m.harness.new_node("n0"))
    server = m.http.SchedulerHTTPServer(runtime.app, host="127.0.0.1", port=0, ha=runtime)
    server.start()
    try:
        out = [http_get(server.port, "/status/readiness")]
        status, body = http_get(server.port, "/debug/ha")
        out.append((status, timings_present(body)))
        out.append(runtime.run_election_once())
        out.append(http_get(server.port, "/status/readiness"))
        status, body = http_get(server.port, "/debug/ha")
        out.append((status, timings_present(body)))
        return out
    finally:
        server.stop()


def test_readiness_reflects_role_and_debug_ha_match_jax():
    out = both(sc_role_surfaces)
    assert out[0] == (503, b'{"ready": false, "role": "standby"}')
    assert out[2] == "leader"
    assert out[3] == (200, b'{"ready": true, "role": "leader"}')
    assert out[4][1]["lease"]["lease_epoch"] == 1 and out[4][1]["promotion_ms"]


def sc_tailed_readiness(m):
    backend = shared_backend(m)
    clock = FakeClock()
    cfg = config(m)
    cfg.ha_heartbeat_s = 3600.0
    runtime = replica(m, backend, "web-r1", clock, cfg)
    server = m.http.SchedulerHTTPServer(runtime.app, host="127.0.0.1", port=0, ha=runtime)
    server.start()
    try:
        out = [runtime.run_election_once(), http_get(server.port, "/status/readiness")]
        backend.add_node(m.harness.new_node("n0"))
        out.append(http_get(server.port, "/status/readiness"))
        return out
    finally:
        server.stop()


def test_tailed_cluster_state_flips_readiness_matches_jax():
    out = both(sc_tailed_readiness)
    assert out[1][0] == 503 and out[2] == (200, b'{"ready": true, "role": "leader"}')


# ------------------------------------------------------- the WAL HA pair


def wal_pair(m, d, ttl, clock):
    path = str(d / "state.jsonl")
    leader_b = m.durable.DurableBackend(path)
    leader_b.register_crd(m.backend.DEMAND_CRD)
    lease_a = m.lease.LeaseManager(
        m.lease.FileLeaseStore(path + ".lease"), "r0", ttl_s=ttl, clock=clock
    )
    leader = replica(m, leader_b, "r0", clock, config(m, ttl), lease=lease_a)
    return path, leader_b, leader


def sc_wal_failover(m, d, n_exec):
    ttl = 2.0
    clock = FakeClock()
    path, leader_b, leader = wal_pair(m, d, ttl, clock)
    roles = [leader.run_election_once()]
    names = [f"n{i}" for i in range(4)]
    for n in names:
        leader_b.add_node(m.harness.new_node(n))
    pods = m.harness.static_allocation_spark_pods("walapp", n_exec)
    leader_b.add_pod(pods[0])
    results = [canon(leader.app.extender.predicate(args(m, pods[0], names)))]
    leader_b.bind_pod(pods[0], results[0][1][0][0])

    standby_b = m.durable.DurableBackend(path, follow=True)
    lease_b = m.lease.LeaseManager(
        m.lease.FileLeaseStore(path + ".lease"), "r1", ttl_s=ttl, clock=clock
    )
    standby = replica(m, standby_b, "r1", clock, config(m, ttl), lease=lease_b)
    roles.append(standby.run_election_once())
    warm = [standby.app.rr_cache.get("namespace", "walapp") is not None,
            len(standby_b.list_nodes())]
    leader.kill()
    leader_b.close()
    clock.advance(ttl * 1.5)
    roles.append(standby.run_election_once())
    within_ttl = standby.last_promotion_ms < ttl * 1000.0
    for p in pods[1:]:
        standby_b.add_pod(p)
        results.append(canon(standby.app.extender.predicate(args(m, p, names))))
    pods2 = m.harness.static_allocation_spark_pods("walapp2", 1)
    standby_b.add_pod(pods2[0])
    results.append(canon(standby.app.extender.predicate(args(m, pods2[0], names))))
    standby_b.close()
    third = m.durable.DurableBackend(path, compact_on_load=False)
    out = (roles, warm, within_ttl, results, backend_state(third),
           standby.state()["lease"])
    third.close()
    return out


@pytest.mark.parametrize("n_exec", [2, 3])
def test_leader_kill_standby_promotes_within_ttl_and_serves_matches_jax(tmp_path, n_exec):
    roles, warm, within_ttl, results, state, lease = both_in(
        tmp_path, sc_wal_failover, n_exec
    )
    assert roles == ["leader", "standby", "leader"] and warm == [True, 4]
    assert within_ttl and all(r[1][0] for r in results)
    assert len(state["resourcereservations"]) == 2 and lease["lease_epoch"] == 2


def test_promoted_replica_reconciles_a_copied_wal_like_jax(tmp_path):
    """A JAX leader writes a WAL and dies with a bound driver whose
    reservation was lost; a replica of either package promoted on a copy
    of that WAL reconciles to the same summary and state."""
    m = pkg(JAX)
    clock = FakeClock()
    path, leader_b, leader = wal_pair(m, tmp_path, 2.0, clock)
    leader.run_election_once()
    names = [f"n{i}" for i in range(6)]
    for n in names:
        leader_b.add_node(m.harness.new_node(n))
    for i in range(3):
        pods = m.harness.static_allocation_spark_pods(f"app{i}", 2)
        leader_b.add_pod(pods[0])
        res = leader.app.extender.predicate(args(m, pods[0], names))
        leader_b.bind_pod(pods[0], res.node_names[0])
        leader_b.add_pod(pods[1])
        res = leader.app.extender.predicate(args(m, pods[1], names))
        leader_b.bind_pod(pods[1], res.node_names[0])
    leader.app.rr_cache.delete("namespace", "app1")  # a lost reservation
    leader.kill()
    leader_b.close()
    out = []
    for root in ROOTS:
        r = pkg(root)
        copy_path = str(tmp_path / f"copy-{root}.jsonl")
        shutil.copy(path, copy_path)
        b = r.durable.DurableBackend(copy_path, follow=True)
        lease = r.lease.LeaseManager(
            r.lease.FileLeaseStore(copy_path + ".lease"), "r1", ttl_s=2.0,
            clock=FakeClock(),
        )
        rep = replica(r, b, "r1", FakeClock(), config(r, 2.0), lease=lease)
        assert rep.lease.try_acquire()
        summary = rep.promote()
        out.append((canon(summary), backend_state(b), rr_state(rep.app)))
        b.close()
    assert out[1] == out[0]
    assert out[1][0]["created"] == 1


# ----------------------------------------- a leader deposed mid-window


def sc_deposed_mid_window(m, seed):
    """r0 leads and dispatches a window; r1 takes the lease before the
    window completes (the completion's reservation writes are fenced);
    later r1 dies and r0 is promoted again over state the other term
    changed. Every answer, the stored reservations and both replicas'
    caches are compared; r0's solver must not solve the second term on
    the first term's device base."""
    rng = np.random.default_rng(seed)
    ttl = 3.0
    clock = FakeClock()
    backend = shared_backend(m)
    r0 = replica(m, backend, "r0", clock)
    r1 = replica(m, backend, "r1", clock)
    assert r0.lease.try_acquire()
    r0.promote()
    names = [f"n{i}" for i in range(8)]
    for n in names:
        backend.add_node(m.harness.new_node(n, zone=f"zone{int(rng.integers(1, 3))}"))
    counter = iter(range(1000))

    def drivers(k):
        out = []
        for _ in range(k):
            pods = m.harness.static_allocation_spark_pods(
                f"app{next(counter)}", int(rng.integers(1, 4))
            )
            backend.add_pod(pods[0])
            out.append((pods, args(m, pods[0], names)))
        return out

    def serve(rep, batch, bind=True):
        res = rep.app.extender.predicate_batch([a for _, a in batch])
        if bind:
            for (pods, a), r in zip(batch, res):
                if r.ok:
                    backend.bind_pod(a.pod, r.node_names[0])
        return [canon(r) for r in res]

    log = [serve(r0, drivers(3))]
    inflight = drivers(3)
    ticket = r0.app.extender.predicate_window_dispatch([a for _, a in inflight])
    clock.advance(ttl * 2)
    log.append(r1.run_election_once())
    # The deposed leader's window completes after the takeover.
    late = r0.app.extender.predicate_window_complete(ticket)
    log.append([canon(r) for r in late])
    log.append([r0.lease.fenced_rejects, r0.run_election_once(), r0.run_election_once()])
    log.append(serve(r1, drivers(3)))
    log.append(rr_state(r1.app))
    # r1 dies; r0, a warm standby again, is promoted over r1's term.
    r1.kill()
    clock.advance(ttl * 2)
    log.append(r0.run_election_once())
    log.append(serve(r0, drivers(4)))
    for pods, a in inflight:
        for p in pods[1:]:
            backend.add_pod(p)
            log.append(canon(r0.app.extender.predicate(args(m, p, names))))
    log.append(rr_state(r0.app))
    log.append(reserved(r0.app))
    log.append(backend_state(backend)["resourcereservations"])
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deposed_mid_window_then_repromoted_matches_jax(seed):
    log = both(sc_deposed_mid_window, seed)
    assert log[1] == "leader"
    assert log[3][1:] == ["deposed", "standby"] and log[3][0] > 0
    assert log[6] == "leader"
