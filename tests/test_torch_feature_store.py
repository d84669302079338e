"""The port's host feature store and overhead aggregates against the JAX
package's.

The twin of tests/test_feature_store.py: its 13 tests run once per
package (the port's apps on `device="cpu"`), each with the JAX test's
assertions: the 10,000-node O(changed) budget counters, zero-copy
snapshots, the snapshot against the legacy per-window rebuild, the LRU
domain caches, frozen overhead views, the deleted node's masked overhead
row, the statics epoch, the delete patch, the recycled registry row, the
rank head-walk and the re-added node's row. Then one scenario (seeded
node and pod churn: reservations, foreign pods, deletes, re-adds) goes
through both packages, and every snapshot's usage and overhead arrays,
roster and registry rows must be equal, with no tolerance.
"""

from __future__ import annotations

import functools
import importlib
import types

import numpy as np
import pytest

from tests.test_torch_native import load_jax_native

JAX = "spark_scheduler_tpu"
PORT = "spark_scheduler_tpu_torch"
ROOTS = (JAX, PORT)


def package(root):
    """The names the suite uses, from one package; the port's app and
    harness solve on the CPU."""
    if root == JAX:
        load_jax_native()

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    hm = mod("testing.harness")
    cpu = {"device": "cpu"} if root == PORT else {}
    return types.SimpleNamespace(
        root=root,
        LRUCache=mod("core.lru").LRUCache,
        RankIndex=mod("core.feature_store").RankIndex,
        ExtenderArgs=mod("core.extender").ExtenderArgs,
        Pod=mod("models.kube").Pod,
        Container=mod("models.kube").Container,
        Resources=mod("models.resources").Resources,
        FrozenResources=mod("models.resources").FrozenResources,
        new_resource_reservation=mod(
            "models.reservations"
        ).new_resource_reservation,
        build_scheduler_app=functools.partial(
            mod("server.app").build_scheduler_app, **cpu
        ),
        InstallConfig=mod("server.config").InstallConfig,
        InMemoryBackend=mod("store.backend").InMemoryBackend,
        INSTANCE_GROUP_LABEL=hm.INSTANCE_GROUP_LABEL,
        Harness=functools.partial(hm.Harness, **cpu),
        new_node=hm.new_node,
        static_allocation_spark_pods=hm.static_allocation_spark_pods,
    )


@pytest.fixture(params=ROOTS)
def p(request):
    return package(request.param)


NS = "namespace"


def _app_with_nodes(p, n_nodes):
    backend = p.InMemoryBackend()
    names = []
    for i in range(n_nodes):
        node = p.new_node(f"fs-n{i}", zone=f"zone{i % 4}")
        backend.add_node(node)
        names.append(node.name)
    app = p.build_scheduler_app(
        backend,
        p.InstallConfig(
            sync_writes=True, instance_group_label=p.INSTANCE_GROUP_LABEL
        ),
    )
    return backend, app, names


def _reservation(p, names, j, execs=2):
    driver = p.static_allocation_spark_pods(f"fs-app-{j}", execs)[0]
    return p.new_resource_reservation(
        names[j % len(names)],
        [names[(j + k + 1) % len(names)] for k in range(execs)],
        driver,
        p.Resources.from_quantities("1", "1Gi"),
        p.Resources.from_quantities("1", "1Gi"),
    )


# ----------------------------------------------------------- budget (tier-1)


def test_budget_10k_nodes_steady_state_featurize_is_o_changed(p):
    """THE regression guard for the optimisation: build a 10k-node store,
    apply 50 incremental events (reservation commits), and assert the
    steady-state snapshots did NO O(nodes) work — the roster-rebuild
    counter (the store's only O(nodes) Python walk) must not move, and
    the refresh counters must track exactly the events applied."""
    backend, app, names = _app_with_nodes(p, 10_000)
    store = app.extender.features

    cold = store.snapshot()
    assert store.roster_rebuilds == 1  # the one cold build
    assert len(cold.nodes) == 10_000

    rebuilds_before = store.roster_rebuilds
    usage_refreshes_before = store.usage_refreshes
    for j in range(50):
        assert app.rr_cache.create(_reservation(p, names, j))
        snap = store.snapshot()
        # The roster was untouched: same tuple/dict objects, zero walks.
        assert snap.nodes is cold.nodes
        assert snap.by_name is cold.by_name
        assert snap.statics_epoch == cold.statics_epoch
    assert store.roster_rebuilds == rebuilds_before, (
        "steady-state featurize paid an O(nodes) roster re-walk"
    )
    # Usage refreshed once per dirty window as an O(changed) row PATCH
    # into the resident master — zero full [cap,3] copies.
    assert store.usage_patches == 50
    assert store.usage_refreshes == usage_refreshes_before, (
        "steady-state usage refresh paid a full-array copy"
    )

    # The snapshots carried the commits: reserved rows are non-zero.
    assert snap.usage.any()

    # A node ADD rides the append patch: the roster grows
    # without an O(nodes) re-list/re-intern — the rebuild counter stays
    # flat and the add-patch counter moves instead.
    backend.add_node(p.new_node("fs-late", zone="zone0"))
    snap2 = store.snapshot()
    assert store.roster_rebuilds == rebuilds_before
    assert store.roster_add_patches == 1
    assert len(snap2.nodes) == 10_001
    assert snap2.by_name["fs-late"] is not None
    # A node DELETE rides the tombstone patch: swap-remove +
    # live-mask clear, no O(nodes) re-list — the rebuild counter stays
    # flat and the delete-patch counter moves instead.
    backend.delete("nodes", "", "fs-late")
    snap3 = store.snapshot()
    assert store.roster_rebuilds == rebuilds_before
    assert store.roster_delete_patches == 1
    assert len(snap3.nodes) == 10_000
    assert "fs-late" not in snap3.by_name
    # Bumps at least once for the roster walk (the re-masked overhead copy
    # may bump it again) — what matters is that the solver's epoch skip is
    # invalidated.
    assert snap2.statics_epoch > cold.statics_epoch
    app.stop()


def test_snapshot_is_zero_copy_when_clean(p):
    backend, app, names = _app_with_nodes(p, 8)
    store = app.extender.features
    s1 = store.snapshot()
    s2 = store.snapshot()
    assert s2.nodes is s1.nodes
    assert s2.by_name is s1.by_name
    assert s2.usage is s1.usage
    assert s2.overhead is s1.overhead
    assert s2.epoch == s1.epoch
    # Frozen: the shared arrays cannot be scribbled on by a consumer.
    with pytest.raises(ValueError):
        s1.usage[0, 0] = 1
    with pytest.raises(ValueError):
        s1.overhead[0, 0] = 1
    app.stop()


def test_snapshot_matches_legacy_rebuild(p):
    """The snapshot's arrays must equal what the legacy per-window rebuild
    derived: usage == reserved_usage(), overhead rows == get_overhead
    map — through build_tensors the two views are byte-identical."""
    backend, app, names = _app_with_nodes(p, 16)
    store, solver = app.extender.features, app.solver
    # Overhead: an unreserved non-spark pod bound to a node.
    backend.add_pod(
        p.Pod(
            name="ov-pod",
            namespace="kube-system",
            node_name=names[3],
            scheduler_name="default-scheduler",
            phase="Running",
            containers=[
                p.Container(requests=p.Resources.from_quantities("500m", "256Mi"))
            ],
        )
    )
    assert app.rr_cache.create(_reservation(p, names, 0))
    snap = store.snapshot()

    legacy_nodes = backend.list_nodes()
    legacy_usage = app.reservation_manager.reserved_usage()
    legacy_overhead = app.overhead_computer.get_overhead(legacy_nodes)

    rows = min(snap.usage.shape[0], legacy_usage.shape[0])
    assert np.array_equal(snap.usage[:rows], legacy_usage[:rows])

    t_snap = solver.build_tensors(
        snap.nodes, snap.usage, snap.overhead, full_node_list=True
    )
    t_legacy = solver.build_tensors(
        legacy_nodes, legacy_usage, legacy_overhead, full_node_list=True
    )
    for field in ("available", "schedulable", "zone_id", "valid"):
        assert np.array_equal(
            np.asarray(getattr(t_snap, field)),
            np.asarray(getattr(t_legacy, field)),
        ), field
    app.stop()


# ------------------------------------------------------------- LRU satellite


def test_lru_cache_65th_signature_keeps_the_64_hottest(p):
    """The domain-cache satellite: overflow evicts the LRU entry only —
    a 65th signature must keep the 64 hottest resident (the old
    `.clear()` wiped all of them)."""
    cache = p.LRUCache(64)
    for i in range(64):
        cache.put(("sig", i), i)
    # Touch 1..63 so ("sig", 0) is the coldest.
    for i in range(1, 64):
        assert cache.get(("sig", i)) == i
    cache.put(("sig", 64), 64)
    assert len(cache) == 64
    assert ("sig", 0) not in cache  # only the LRU entry fell out
    for i in range(1, 65):
        assert ("sig", i) in cache


def test_domain_cache_lru_in_extender(p):
    """Integration pin: the extender's affinity-domain memo survives an
    overflow — filling it past capacity does not clear the hot entries."""
    h = p.Harness(binpack_algo="tightly-pack", fifo=False)
    h.add_nodes(*[p.new_node(f"n{i}", zone=f"zone{i % 2}") for i in range(4)])
    ext = h.extender
    topo = h.backend.nodes_version
    for i in range(70):
        ext._domain_cache.put((("ig", f"group-{i}"),), (topo, [f"n{i % 4}"]))
    assert len(ext._domain_cache) == 64
    # The most recent 64 signatures survived.
    assert ((("ig", "group-69"),)) in ext._domain_cache
    assert ((("ig", "group-6"),)) in ext._domain_cache
    assert ((("ig", "group-5"),)) not in ext._domain_cache


# --------------------------------------------------------- frozen overheads


def test_get_overhead_returns_frozen_views(p):
    backend, app, names = _app_with_nodes(p, 4)
    backend.add_pod(
        p.Pod(
            name="ov-pod",
            namespace="kube-system",
            node_name=names[0],
            scheduler_name="default-scheduler",
            phase="Running",
            containers=[
                p.Container(requests=p.Resources.from_quantities("1", "1Gi"))
            ],
        )
    )
    oc = app.overhead_computer
    overhead = oc.get_overhead(backend.list_nodes())
    assert names[0] in overhead
    view = overhead[names[0]]
    assert isinstance(view, p.FrozenResources)
    # Value-equal with plain p.Resources, both directions.
    expected = p.Resources.from_quantities("1", "1Gi")
    assert view == expected and expected == view
    with pytest.raises(TypeError):
        view.add(p.Resources.from_quantities("1", "1Gi"))
    with pytest.raises(TypeError):
        view.sub(expected)
    # copy() is the mutable escape hatch, and mutating it does not touch
    # the aggregate.
    mutable = view.copy()
    mutable.add(p.Resources.from_quantities("1", "0"))
    again = oc.get_overhead(backend.list_nodes())[names[0]]
    assert again == expected
    # Memoized: repeated queries reuse the same view object until the
    # aggregate changes.
    assert again is view
    oracle = oc.compute_node_overhead_oracle(names[0])[0]
    assert view == oracle
    app.stop()


def test_frozen_view_invalidated_on_aggregate_change(p):
    backend, app, names = _app_with_nodes(p, 4)
    oc = app.overhead_computer

    def add_ov(name, node):
        backend.add_pod(
            p.Pod(
                name=name,
                namespace="kube-system",
                node_name=node,
                scheduler_name="default-scheduler",
                phase="Running",
                containers=[
                    p.Container(requests=p.Resources.from_quantities("1", "1Gi"))
                ],
            )
        )

    add_ov("ov-1", names[0])
    v1 = oc.get_overhead(backend.list_nodes())[names[0]]
    add_ov("ov-2", names[0])
    v2 = oc.get_overhead(backend.list_nodes())[names[0]]
    assert v2 is not v1
    assert v2 == p.Resources.from_quantities("2", "2Gi")
    # Dense mirror tracked the same deltas.
    version, dense = oc.overhead_snapshot(None)
    idx = app.solver.registry.index_of(names[0])
    assert p.Resources.from_array(dense[idx]) == v2
    app.stop()


def test_overhead_of_deleted_node_is_masked_like_the_legacy_dict(p):
    """A deleted node whose pods still exist keeps rows in the dense
    overhead aggregate; the legacy get_overhead(all_nodes) dict never
    surfaced them. The snapshot must match the dict exactly — non-live
    rows zeroed — or the soak's drained-mirror invariant (which rebuilds
    from the dict) would diverge from the serving path."""
    backend, app, names = _app_with_nodes(p, 4)
    store = app.extender.features
    backend.add_pod(
        p.Pod(
            name="ghost-ov",
            namespace="kube-system",
            node_name=names[1],
            scheduler_name="default-scheduler",
            phase="Running",
            containers=[
                p.Container(requests=p.Resources.from_quantities("1", "1Gi"))
            ],
        )
    )
    idx = app.solver.registry.index_of(names[1])
    snap = store.snapshot()
    assert snap.overhead[idx].any()

    backend.delete("nodes", "", names[1])  # pod survives the node
    snap2 = store.snapshot()
    assert not snap2.overhead[idx].any(), (
        "dense overhead leaked a deleted node's row past the roster mask"
    )
    # And the raw aggregate still remembers it: re-adding the node
    # resurfaces the overhead, exactly like the dict would.
    backend.add_node(p.new_node(names[1], zone="zone1"))
    snap3 = store.snapshot()
    assert snap3.overhead[idx].any()
    app.stop()


def test_overhead_change_invalidates_statics_epoch(p):
    """Regression pin: `schedulable = allocatable -
    overhead` is a STATIC field of the cluster tensors, and overhead can
    change with NO node event (pod churn). The statics epoch must bump on
    overhead refreshes, or the solver's epoch skip would leave a stale
    schedulable tensor on device and window decisions could diverge from
    the reference path."""
    backend, app, names = _app_with_nodes(p, 4)
    store, solver = app.extender.features, app.solver
    s1 = store.snapshot()
    t1 = solver.build_tensors_pipelined(
        s1.nodes, s1.usage, s1.overhead,
        topo_version=s1.nodes_version, statics_version=s1.statics_epoch,
    )
    # Overhead-only event: an unreserved pod binds to a node.
    backend.add_pod(
        p.Pod(
            name="stale-ov",
            namespace="kube-system",
            node_name=names[0],
            scheduler_name="default-scheduler",
            phase="Running",
            containers=[
                p.Container(requests=p.Resources.from_quantities("500m", "512Mi"))
            ],
        )
    )
    s2 = store.snapshot()
    assert s2.statics_epoch != s1.statics_epoch
    t2 = solver.build_tensors_pipelined(
        s2.nodes, s2.usage, s2.overhead,
        topo_version=s2.nodes_version, statics_version=s2.statics_epoch,
    )
    # The device-resident schedulable tensor followed host truth.
    idx = solver.registry.index_of(names[0])
    host_sched = np.asarray(getattr(t2, "host", t2).schedulable)
    dev_sched = np.asarray(t2.schedulable)
    assert np.array_equal(dev_sched[idx], host_sched[idx])
    assert dev_sched[idx][0] == 8000 - 500  # allocatable - overhead
    app.stop()


# ------------------------------------------------------- node DELETE patch


def test_delete_patch_matches_fresh_rebuild(p):
    """A node DELETE swap-removes through the patch path: the patched
    roster must equal a from-scratch rebuild as a SET (swap-remove
    permutes positions), the live-row mask must drop the deleted row,
    and the dirty hint must carry the deleted name for the solver's
    tombstone path."""
    backend, app, names = _app_with_nodes(p, 12)
    store = app.extender.features
    store.snapshot()
    rebuilds = store.roster_rebuilds

    backend.delete("nodes", "", names[3])
    snap = store.snapshot()
    assert store.roster_rebuilds == rebuilds
    assert store.roster_delete_patches == 1
    assert {n.name for n in snap.nodes} == set(names) - {names[3]}
    assert names[3] not in snap.by_name
    assert len(snap.roster_rows) == len(snap.nodes)
    # roster_rows still names each node's registry row.
    reg = app.solver.registry
    for node, row in zip(snap.nodes, snap.roster_rows):
        assert reg.index_of(node.name) == row
    # The deleted row left the live mask (the overhead re-mask input).
    deleted_row = reg.index_of(names[3])
    assert not store._roster_mask[deleted_row]
    # Dirty hint carries the delete.
    assert snap.dirty_hint is not None and names[3] in snap.dirty_hint[2]
    app.stop()


def test_delete_then_serve_recycles_registry_row(p):
    """End-to-end delete satellite: serving across a DELETE takes the
    patch path on both layers (no roster rebuild, no arena re-walk), the
    tombstoned registry row recycles once nothing references it, and a
    later ADD reuses the freed index — the registry capacity does not
    grow past the high-water mark."""

    backend, app, names = _app_with_nodes(p, 16)
    ext = app.extender
    ext._last_request = float("inf")
    store = ext.features

    def serve(tag):
        d = p.static_allocation_spark_pods(f"del-{tag}", 1)[0]
        backend.add_pod(d)
        tok = ext.predicate_window_dispatch(
            [p.ExtenderArgs(pod=d, node_names=list(names))]
        )
        return ext.predicate_window_complete(tok)

    serve("warm")
    rebuilds = store.roster_rebuilds
    # Delete an idle node (no reservations landed on it yet).
    victim = names[-1]
    backend.delete("nodes", "", victim)
    serve("after-del")
    assert store.roster_rebuilds == rebuilds
    assert store.roster_delete_patches == 1
    serve("drain")  # tombstone released once no window is in flight
    assert app.solver.tombstones_recycled >= 1
    assert app.solver.registry.index_of(victim) is None
    cap_before = app.solver.registry.capacity
    # A new node reuses the freed registry row: capacity stays flat.
    backend.add_node(p.new_node("del-reborn", zone="zone0"))
    serve("after-add")
    assert app.solver.registry.capacity == cap_before
    assert store.roster_rebuilds == rebuilds
    app.stop()


# ----------------------------------------------- per-zone head-walk property


def test_rank_headwalk_topk_matches_full_sort_under_churn(p):
    """Property test: the planner's head-walk top-K — the first K valid
    fitting rows of a zone's resident order — must equal the top-K of a
    from-scratch full sort, per zone, under randomized add/update/delete
    churn. Keys are drawn from a tiny value set so tie GROUPS straddle
    the K boundary (the order's row-index tiebreak must keep the
    incremental and rebuilt orders identical)."""

    rng = np.random.default_rng(77)
    n, zb, k = 400, 4, 6
    avail = (rng.integers(0, 4, size=(n, 3)) * 8).astype(np.int32)
    name_rank = rng.permutation(n).astype(np.int32)
    zone_id = rng.integers(0, 3, size=n).astype(np.int32)
    valid = rng.random(n) < 0.9
    min_req = np.asarray([8, 8, 0], np.int32)

    idx = p.RankIndex()
    idx.rebuild(avail, name_rank, zone_id, zb)
    for step in range(40):
        op = int(rng.integers(0, 3))
        rows = rng.choice(n, size=int(rng.integers(1, 10)), replace=False)
        if op == 0:  # availability churn
            avail[rows] = (rng.integers(0, 4, size=(len(rows), 3)) * 8)
        elif op == 1:  # delete
            valid[rows] = False
        else:  # add / revive
            valid[rows] = True
            avail[rows] = (rng.integers(0, 4, size=(len(rows), 3)) * 8)
        idx.update_rows(avail, name_rank, rows)
        for z in range(zb):
            zo = idx.zone_order(z)
            zrows = zo[valid[zo]]
            fit = (avail[zrows] >= min_req).all(axis=1)
            head = zrows[fit][:k]
            cand = np.flatnonzero(
                valid
                & (zone_id == z)
                & (avail >= min_req).all(axis=1)
            )
            full = cand[np.lexsort((
                cand,
                name_rank[cand].astype(np.int64),
                avail[cand, 0].astype(np.int64),
                avail[cand, 1].astype(np.int64),
            ))]
            assert np.array_equal(head, full[:k]), (step, z)


def test_delete_then_readd_does_not_release_live_row(p):
    """Regression: a node deleted while a window was in flight
    (release deferred) and then RE-ADDED must cancel its parked
    tombstone — releasing the row later would unmap a live node and
    hand its registry index to the free list."""

    backend, app, names = _app_with_nodes(p, 12)
    ext = app.extender
    ext._last_request = float("inf")

    def serve(tag):
        d = p.static_allocation_spark_pods(f"readd-{tag}", 1)[0]
        backend.add_pod(d)
        tok = ext.predicate_window_dispatch(
            [p.ExtenderArgs(pod=d, node_names=list(names))]
        )
        return ext.predicate_window_complete(tok)

    serve("warm")
    victim = names[-1]
    row = app.solver.registry.index_of(victim)
    # Delete + serve (the window in flight at build time defers release),
    # then re-add the SAME name and keep serving.
    backend.delete("nodes", "", victim)
    serve("deleted")
    backend.add_node(p.new_node(victim, zone="zone0"))
    serve("readded")
    serve("drain")
    assert app.solver.registry.index_of(victim) == row, (
        "live re-added node lost its registry row to a stale tombstone"
    )
    assert victim not in app.solver._pending_tombstones
    res = serve("place")
    assert res[0].node_names
    app.stop()


# ------------------------------------------------- the port against JAX


def _churned_snapshots(root):
    """Seeded churn through one package's feature store; the snapshot
    after every event, in comparable form."""
    p = package(root)
    backend, app, names = _app_with_nodes(p, 24)
    store = app.extender.features
    reg = app.solver.registry
    rng = np.random.default_rng(1607)
    live, gone, out = list(names), [], []
    for step in range(40):
        op = rng.random()
        if op < 0.3:
            assert app.rr_cache.create(_reservation(p, live, step))
        elif op < 0.5:
            node = live[int(rng.integers(0, len(live)))]
            backend.add_pod(p.Pod(
                name=f"ov-{step}", namespace="kube-system", node_name=node,
                scheduler_name="default-scheduler", phase="Running",
                containers=[p.Container(
                    requests=p.Resources.from_quantities("500m", "256Mi")
                )],
            ))
        elif op < 0.7 and len(live) > 12:
            node = live.pop(int(rng.integers(0, len(live))))
            backend.delete("nodes", "", node)
            gone.append(node)
        elif gone:
            node = gone.pop(0)
            backend.add_node(p.new_node(node, zone="zone1"))
            live.append(node)
        snap = store.snapshot()
        out.append((
            sorted(n.name for n in snap.nodes),
            {n.name: reg.index_of(n.name) for n in snap.nodes},
            snap.usage.tolist(),
            snap.overhead.tolist(),
            [int(r) for r in snap.roster_rows],
        ))
    app.stop()
    return out


def test_snapshots_under_churn_match_jax():
    jax_snaps, port_snaps = (_churned_snapshots(root) for root in ROOTS)
    assert len(port_snaps) == len(jax_snaps)
    for step, (a, b) in enumerate(zip(jax_snaps, port_snaps)):
        assert b == a, step
