"""The port's O(K + changed) host tensor build against the JAX package's.

The same seeded node churn and driver windows go through three apps on the
CPU: the JAX package's (its native arena, loaded with
tests/test_torch_native.py `load_jax_native`), the port's (its native
arena's resident build) and the port's dense twin (`use_native=False`, the
Python build that names no changed row). The two arena sides run with
`solver.build-oracle` armed, so a dirty-set mirror sync that misses a
changed row raises inside the build. Tolerance: none. Decisions must be
equal across the three; the nine host fields of the port's pipelined build
must equal the JAX arena build's bit for bit (the dense twin's name ranks
are dense over the live nodes, so its fields are not compared).

The scenarios are those of tests/test_build_dirty_set.py (churn x prune x
pool, zero dense sweeps in steady state, an in-flight escalation
reconstructed from the undo journal, a warm restart, an add burst, a delete
between dispatch and complete, a journal gap, pooled partitions, a slot
failure, a partition's escalation under churn, a slot mirror's catch-up,
a boundary add), of tests/test_device_state.py and of
the arena cases of tests/test_native_runtime.py, plus the port's own: the
unschedulable marker's thread building while windows are served, a
failing compiler, and the copies that keep device tensors from aliasing
the resident host buffers.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from tests.test_torch_native import load_jax_native

JAX = "spark_scheduler_tpu"
PORT = "spark_scheduler_tpu_torch"
FIELDS = (
    "available", "schedulable", "zone_id", "name_rank", "label_rank_driver",
    "label_rank_executor", "unschedulable", "ready", "valid",
)


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _harness(side, pool=1, prune=0, *, grouped=False, n0=48, **kw):
    """One side's Harness with `n0` nodes over two zones (and two instance
    groups when `grouped`). `side`: "jax", "port" or "dense"."""
    pkg = JAX if side == "jax" else PORT
    hm = mod(pkg, "testing.harness")
    kw.setdefault("binpack_algo", "tightly-pack")
    kw.setdefault("fifo", False)
    if pool > 1:
        kw["solver_device_pool"] = pool
    if prune:
        kw["solver_prune_top_k"] = prune
        kw["solver_prune_slack"] = 0.75
    if side == "jax":
        load_jax_native()
        h = hm.Harness(**kw)
    else:
        build = hm.build_scheduler_app
        if pool > 1:
            build = functools.partial(build, pool_devices=["cpu"] * pool)
        with mock.patch.object(hm, "build_scheduler_app", build):
            h = hm.Harness(device="cpu", use_native=side != "dense", **kw)
    h.add_nodes(*[
        hm.new_node(
            f"n{i:03d}", zone=f"zone{i % 2}",
            **({"instance_group": f"ig{i % 2}"} if grouped else {}),
        )
        for i in range(n0)
    ])
    if side != "dense":
        assert h.app.solver.uses_native_arena
        h.app.solver.build_oracle = True
    else:
        assert not h.app.solver.uses_native_arena
    h.mod = hm
    h.ext_mod = mod(pkg, "core.extender")
    return h


def _serve(h, live, ids, groups=None):
    """One window of drivers (one per id), optionally pinned to instance
    groups; returns each request's node names."""
    drivers = []
    for k, i in enumerate(ids):
        kw = {"instance_group": groups[k]} if groups else {}
        d = h.mod.static_allocation_spark_pods(f"tb-{i}", 2, **kw)[0]
        h.add_pods(d)
        drivers.append(d)
    t = h.extender.predicate_window_dispatch(
        [h.ext_mod.ExtenderArgs(pod=d, node_names=list(live)) for d in drivers]
    )
    return [tuple(r.node_names) for r in h.extender.predicate_window_complete(t)]


def _churn(h, rng, live, spare, deleted):
    """One seeded node event: an add (a recycled name half the time), a
    cordon flip, or a delete."""
    op = rng.random()
    if op < 0.3 and (spare or deleted):
        name = deleted.pop() if deleted and rng.random() < 0.5 else (
            spare.pop() if spare else deleted.pop()
        )
        h.add_nodes(h.mod.new_node(name, zone=f"zone{len(live) % 2}"))
        live.append(name)
        return ("add", name)
    if op < 0.75 and live:
        name = live[int(rng.integers(0, len(live)))]
        cur = h.backend.get_node(name)
        h.backend.update(
            "nodes", dataclasses.replace(cur, unschedulable=not cur.unschedulable)
        )
        return ("update", name)
    if len(live) > 8:
        name = live.pop(int(rng.integers(0, len(live))))
        h.backend.delete("nodes", "", name)
        deleted.append(name)
        return ("delete", name)
    return ("noop", None)


def _host_fields_equal(h_jax, h_port, where=""):
    a, b = h_jax.app.solver._pipe["host"], h_port.app.solver._pipe["host"]
    for f in FIELDS:
        fa, fb = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert fa.dtype == fb.dtype and np.array_equal(fa, fb), (where, f)


def _stop(*hs):
    for h in hs:
        h.app.stop()


@pytest.mark.parametrize("pool,prune", [(1, 0), (1, 4), (2, 0), (2, 4)])
def test_resident_build_matches_jax_and_dense_twin_under_churn(pool, prune):
    sides = [_harness(s, pool, prune) for s in ("jax", "port", "dense")]
    state = [
        ([f"n{i:03d}" for i in range(48)], [f"x{j:02d}" for j in range(20, 0, -1)],
         [], np.random.default_rng(20813))
        for _ in sides
    ]
    for step in range(18):
        evs = [_churn(h, rng, live, spare, dl)
               for h, (live, spare, dl, rng) in zip(sides, state)]
        assert evs[0] == evs[1] == evs[2]
        outs = [_serve(h, st[0], (2 * step, 2 * step + 1))
                for h, st in zip(sides, state)]
        assert outs[0] == outs[1] == outs[2], (step, evs[0], outs)
        _host_fields_equal(sides[0], sides[1], (step, evs[0]))
    bs = sides[1].app.solver.build_stats
    assert bs["mirror_dense_syncs"] == 0, bs
    assert bs["oracle_checks"] > 0 and bs["incremental_builds"] > 0, bs
    assert sides[0].app.solver.build_stats["mirror_dense_syncs"] == 0
    assert sides[2].app.solver.build_stats["dirty_rows"] == 0
    assert (
        sides[1].app.solver.tombstones_recycled
        == sides[0].app.solver.tombstones_recycled
    )
    _stop(*sides)


def test_deleted_rows_recycle_once_drained():
    """A deleted node holding no reservation frees its registry row at the
    next serving build (its tombstone); the next added node takes the row,
    its statics ship as a static row delta, and decisions and host fields
    stay equal across the three sides."""
    sides = [_harness(s, 1, 0, n0=16) for s in ("jax", "port", "dense")]
    live = [f"n{i:03d}" for i in range(16)]
    for h in sides:
        assert _serve(h, live, (0,))[0]
    victim = "n015"  # tightly-pack fills the first rows: n015 is empty
    row = sides[1].app.solver.registry.index_of(victim)
    for h in sides:
        h.backend.delete("nodes", "", victim)
    outs = [_serve(h, live[:-1], (1,)) for h in sides]
    assert outs[0] == outs[1] == outs[2]
    assert sides[1].app.solver.tombstones_recycled == 1
    assert sides[0].app.solver.tombstones_recycled == 1
    for h in sides:
        h.add_nodes(h.mod.new_node("fresh", zone="zone0"))
    live = live[:-1] + ["fresh"]
    outs = [_serve(h, live, (2, 3)) for h in sides]
    assert outs[0] == outs[1] == outs[2]
    assert sides[1].app.solver.registry.index_of("fresh") == row
    _host_fields_equal(sides[0], sides[1])
    assert sides[1].app.solver.device_state_stats["static_delta_uploads"] >= 1
    _stop(*sides)


def test_steady_state_runs_zero_dense_mirror_sweeps():
    h = _harness("port", 1, 4, n0=64)
    live = [f"n{i:03d}" for i in range(64)]
    _serve(h, live, (0, 1))  # the cold build and full upload
    bs = h.app.solver.build_stats
    compared0, dense0 = bs["mirror_rows_compared"], bs["mirror_dense_syncs"]
    for i in range(8):
        assert all(_serve(h, live, (2 + 2 * i, 3 + 2 * i)))
    assert bs["mirror_rows_compared"] == compared0, bs
    assert bs["mirror_dense_syncs"] == dense0, bs
    assert bs["incremental_builds"] >= 8 and bs["full_snapshots"] == 1, bs
    _stop(h)


def _inflight_escalation(side):
    h = _harness(side, 1, 0, n0=32, solver_prune_top_k=1,
                 solver_prune_slack=0.01)
    res_mod = mod(h.mod.__name__.split(".")[0], "models.reservations")
    resources = mod(h.mod.__name__.split(".")[0], "models.resources").Resources
    live = [f"n{i:03d}" for i in range(32)]
    _serve(h, live, (0,))
    ext = h.extender
    d1 = h.mod.static_allocation_spark_pods(f"if-{side}-1", 2)[0]
    h.add_pods(d1)
    t1 = ext.predicate_window_dispatch(
        [h.ext_mod.ExtenderArgs(pod=d1, node_names=live)]
    )
    # A reservation created outside the window path between t1's dispatch
    # and its fetch: the next build patches the resident availability in
    # place, and t1's re-solve must see its dispatch-time view.
    blocker = h.mod.static_allocation_spark_pods(f"if-{side}-blk", 1)[0]
    h.backend.add_pod(blocker)
    h.app.rr_cache.create(res_mod.new_resource_reservation(
        "n005", ["n005"], blocker,
        resources.from_quantities("2", "2Gi"),
        resources.from_quantities("1", "1Gi"),
    ))
    d2 = h.mod.static_allocation_spark_pods(f"if-{side}-2", 2)[0]
    h.add_pods(d2)
    t2 = ext.predicate_window_dispatch(
        [h.ext_mod.ExtenderArgs(pod=d2, node_names=live)]
    )
    r1 = [tuple(r.node_names) for r in ext.predicate_window_complete(t1)]
    r2 = [tuple(r.node_names) for r in ext.predicate_window_complete(t2)]
    st = h.app.solver.prune_stats["escalations"]
    _stop(h)
    return (r1, r2), st


def test_inflight_churn_escalation_reconstructs_dispatch_time_view():
    (jax_out, _), (port_out, esc), (dense_out, _) = (
        _inflight_escalation(s) for s in ("jax", "port", "dense")
    )
    assert esc > 0  # the starved K escalated: the reconstruction ran
    assert port_out == jax_out == dense_out


def _warm_restart(lazy):
    h = _harness("port", 1, 4, n0=64, solver_lazy_warm_start=lazy)
    live = [f"n{i:03d}" for i in range(64)]
    for i in range(3):
        _serve(h, live, (2 * i, 2 * i + 1))
    planner = h.app.solver._planner
    rebuilds = planner.index.rebuilds
    h.app.solver.discard_pipeline()
    out = _serve(h, live, (6, 7))
    _stop(h)
    return out, planner.index.rebuilds - rebuilds


def test_warm_restart_persists_planner():
    out, rebuilt = _warm_restart(True)
    assert all(out) and rebuilt == 0
    dense = _harness("dense", 1, 4, n0=64)
    live = [f"n{i:03d}" for i in range(64)]
    want = [_serve(dense, live, (2 * i, 2 * i + 1)) for i in range(3)]
    dense.app.solver.discard_pipeline()
    assert _serve(dense, live, (6, 7)) == out and all(want)
    _stop(dense)
    # With lazy warm start off the full upload invalidates the planner.
    out_off, rebuilt_off = _warm_restart(False)
    assert out_off == out and rebuilt_off == 1


def test_add_burst_reallocates_nothing_and_rebuilds_no_roster():
    h = _harness("port", 1, 0, n0=40)
    live = [f"n{i:03d}" for i in range(40)]
    _serve(h, live, (0, 1))
    store = h.app.extender.features
    grows0, rebuilds0 = store.array_grows, store.stats()["roster_rebuilds"]
    space = h.app.solver._rank_space
    renumbers0 = space.renumbers
    for j in range(20):  # 40 -> 60 nodes: inside the 64 bucket
        name = f"zadd{j:02d}"
        h.add_nodes(h.mod.new_node(name, zone=f"zone{j % 2}"))
        live.append(name)
        assert all(_serve(h, live, (2 + j,)))
    st = store.stats()
    assert store.array_grows == grows0, st
    assert st["roster_rebuilds"] == rebuilds0 and st["roster_add_patches"] >= 20
    assert space.renumbers == renumbers0  # gapped inserts, no renumber
    assert h.app.solver.build_stats["mirror_dense_syncs"] == 0
    _stop(h)


def test_delete_between_dispatch_and_complete_keeps_old_roster_view():
    outs = []
    for side in ("jax", "port", "dense"):
        h = _harness(side, 1, 4, n0=32)
        live = [f"n{i:03d}" for i in range(32)]
        _serve(h, live, (0,))
        ext = h.extender
        d1 = h.mod.static_allocation_spark_pods("dl-1", 2)[0]
        h.add_pods(d1)
        t1 = ext.predicate_window_dispatch(
            [h.ext_mod.ExtenderArgs(pod=d1, node_names=list(live))]
        )
        h.backend.delete("nodes", "", "n030")
        d2 = h.mod.static_allocation_spark_pods("dl-2", 2)[0]
        h.add_pods(d2)
        t2 = ext.predicate_window_dispatch([h.ext_mod.ExtenderArgs(
            pod=d2, node_names=[n for n in live if n != "n030"]
        )])
        r1 = [tuple(r.node_names) for r in ext.predicate_window_complete(t1)]
        r2 = [tuple(r.node_names) for r in ext.predicate_window_complete(t2)]
        assert all(r1) and all(r2)
        assert ext.features.stats()["roster_delete_patches"] >= 1
        outs.append((r1, r2))
        _stop(h)
    assert outs[0] == outs[1] == outs[2]


def test_journal_gap_takes_the_dense_path_exactly():
    """A journal break (the feature store withholding its journal) sends
    those builds to the full snapshot and the dense mirror compare, once
    per build, and back; decisions stay equal to the dense twin's."""
    h, dense = _harness("port", 1, 4), _harness("dense", 1, 4)
    live = [f"n{i:03d}" for i in range(48)]
    bs = h.app.solver.build_stats
    for step in range(9):
        if step == 3:
            h.app.extender.features.journal_enabled = False
            snaps0, dense0 = bs["full_snapshots"], bs["mirror_dense_syncs"]
        if step == 6:
            h.app.extender.features.journal_enabled = True
            assert bs["full_snapshots"] - snaps0 == 3, bs
            assert bs["mirror_dense_syncs"] - dense0 == 3, bs
        ids = (2 * step, 2 * step + 1)
        assert _serve(h, live, ids) == _serve(dense, live, ids), step
    assert bs["mirror_dense_syncs"] - dense0 == 4, bs  # the rejoin's build
    _stop(h, dense)


@pytest.mark.parametrize("prune", [0, 4])
def test_pooled_partitions_debit_sparsely_with_zero_dense_syncs(prune):
    sides = [_harness(s, 2, prune, grouped=True) for s in ("jax", "port", "dense")]
    live = [f"n{i:03d}" for i in range(48)]
    rngs = [np.random.default_rng(4051) for _ in sides]
    k = 0
    for step in range(10):
        if step >= 2:
            for h, rng in zip(sides, rngs):
                name = live[int(rng.integers(0, len(live)))]
                cur = h.backend.get_node(name)
                h.backend.update("nodes", dataclasses.replace(
                    cur, unschedulable=not cur.unschedulable
                ))
        outs = [_serve(h, live, (k, k + 1), groups=("ig0", "ig1")) for h in sides]
        k += 2
        assert outs[0] == outs[1] == outs[2], (step, outs)
        _host_fields_equal(sides[0], sides[1], step)
    solver = sides[1].app.solver
    bs = solver.build_stats
    assert bs["mirror_dense_syncs"] == 0 and bs["pooled_debit_rows"] > 0, bs
    assert solver.window_path_counts.get("pool", 0) > 0
    if prune:
        st = solver.prune_stats
        assert st["windows"] > 0 and st["plan_reuse"] > 0 and st["escalations"] == 0
    _stop(*sides)


def test_pooled_slot_failure_redispatch_keeps_sparse_debits():
    """A slot dying mid-burst re-dispatches its partition on the survivor,
    decisions equal to an unfaulted dense twin's, and the recovery never
    sends the mirror sync to a dense sweep."""
    from spark_scheduler_tpu_torch.faults import (
        FaultInjector,
        FaultPlan,
        FaultSpec,
    )

    h = _harness("port", 2, 4, grouped=True, n0=32)
    twin = _harness("dense", 2, 4, grouped=True, n0=32)
    live = [f"n{i:03d}" for i in range(32)]
    groups = ("ig0", "ig1")
    outs = [_serve(h, live, (0, 1), groups), _serve(h, live, (2, 3), groups)]
    plan = FaultPlan(seed=0, name="pool-slot-kill", specs=[
        FaultSpec(surface="device.dispatch", mode="error", at=[1], limit=1)
    ])
    with FaultInjector(plan) as inj:
        inj.install_device()
        for k in (4, 6):
            outs.append(_serve(h, live, (k, k + 1), groups))
    outs.append(_serve(h, live, (8, 9), groups))
    want = [_serve(twin, live, (k, k + 1), groups) for k in range(0, 10, 2)]
    assert outs == want
    assert h.app.solver.redispatch_count >= 1
    assert h.app.solver.build_stats["mirror_dense_syncs"] == 0
    _stop(h, twin)


@pytest.mark.parametrize("blocker_node", ["n004", "n005"])
def test_pooled_partition_escalation_interleaving_matches_dense(blocker_node):
    """In-flight churn between a partitioned pooled window's dispatch and
    its fetch starves a partition's certificate: it escalates, and the
    decisions still equal the JAX package's pooled solve and the port's
    unpruned single-device dense twin, with no dense mirror sweep. Both
    instance groups carry the blocker in turn, so both part orders run."""
    outs, esc = {}, 0
    for side in ("jax", "port", "dense"):
        kw = {} if side == "dense" else dict(
            solver_prune_top_k=1, solver_prune_slack=0.01)
        h = _harness(side, 1 if side == "dense" else 2, grouped=True,
                     n0=32, **kw)
        res_mod = mod(h.mod.__name__.split(".")[0], "models.reservations")
        resources = mod(h.mod.__name__.split(".")[0], "models.resources").Resources
        live = [f"n{i:03d}" for i in range(32)]
        groups = ("ig0", "ig1")
        _serve(h, live, (0, 1), groups)
        ext = h.extender
        drivers = []
        for g in groups:
            d = h.mod.static_allocation_spark_pods(f"pe-{g}", 2, instance_group=g)[0]
            h.add_pods(d)
            drivers.append(d)
        t1 = ext.predicate_window_dispatch(
            [h.ext_mod.ExtenderArgs(pod=d, node_names=live) for d in drivers])
        blocker = h.mod.static_allocation_spark_pods("pe-blk", 1)[0]
        h.backend.add_pod(blocker)
        h.app.rr_cache.create(res_mod.new_resource_reservation(
            blocker_node, [blocker_node], blocker,
            resources.from_quantities("2", "2Gi"),
            resources.from_quantities("1", "1Gi"),
        ))
        r1 = [tuple(r.node_names) for r in ext.predicate_window_complete(t1)]
        outs[side] = (r1, _serve(h, live, (2, 3), groups))
        if side == "port":
            esc = h.app.solver.prune_stats["escalations"]
            assert h.app.solver.build_stats["mirror_dense_syncs"] == 0
        _stop(h)
    assert esc > 0
    assert outs["port"] == outs["jax"] == outs["dense"], outs


def test_pool_slot_mirror_catches_up_by_row_scatter():
    """A slot on another device than the solver's base keeps an
    availability replica: a whole-window dispatch landing there scatters
    the journaled rows it missed instead of copying the whole base, and a
    fetch patches an unknowable epoch with its commit rows so later
    catch-ups cross it. `cpu:0` is a second device name for the host, so
    the replica path runs on the CPU."""
    solver_mod = mod(PORT, "core.solver")
    kube = mod(PORT, "models.kube")
    res = mod(PORT, "models.resources").Resources
    one = res.from_quantities("1", "1Gi")
    nodes = [
        kube.Node(
            name=f"m{i:03d}",
            allocatable=res.from_quantities("8", "8Gi", "1", round_up=False),
            labels={kube.ZONE_LABEL: f"z{i % 2}"},
        )
        for i in range(32)
    ]
    names = [n.name for n in nodes]
    rng = np.random.default_rng(3)
    wins = [
        [
            solver_mod.WindowRequest(
                rows=[(one, one, int(rng.integers(1, 3)), False)],
                driver_candidate_names=names,
            )
            for _ in range(3)
        ]
        for _ in range(8)
    ]

    def run(solver):
        out, usage = [], {}
        for w in wins:
            t = solver.build_tensors_pipelined(nodes, usage, {})
            out.extend(solver.pack_window_fetch(
                solver.pack_window_dispatch("tightly-pack", t, w)
            ))
        return out

    base = run(solver_mod.PlacementSolver(device="cpu", use_native=False))
    pooled = solver_mod.PlacementSolver(
        device="cpu", pool_devices=[torch.device("cpu"), torch.device("cpu", 0)]
    )
    assert run(pooled) == base
    mirrors = {k: v["mirror"] for k, v in pooled.device_pool_stats().items()}
    other = mirrors["cpu:0"]
    assert other["catchup"] >= 1 and other["delta_rows"] >= 1, mirrors
    assert other["dense"] <= 1, mirrors  # only the slot's first touch
    assert mirrors["cpu"]["catchup"] == mirrors["cpu"]["dense"] == 0


def test_boundary_add_inserts_into_kept_set_without_rescan():
    """A node add whose key beats a zone's kept boundary inserts into the
    kept order in O(K) (the planner, core/prune.py, fed by the resident
    build's static rows), and the plan equals a cold build's and the JAX
    planner's."""
    plans = {}
    for pkg in (JAX, PORT):
        PrunePlanner = mod(pkg, "core.prune").PrunePlanner
        ClusterTensors = mod(pkg, "models.cluster").ClusterTensors
        n, zb = 24, 2
        avail = np.full((n, 3), 32, np.int32)
        zone_id = (np.arange(n) % 2).astype(np.int32)
        name_rank = (np.arange(n) + 10).astype(np.int32)
        valid = np.ones(n, bool)
        j = n - 1
        valid[j] = False

        def mk_host():
            return ClusterTensors(
                available=avail, schedulable=avail.copy(), zone_id=zone_id,
                name_rank=name_rank.copy(),
                label_rank_driver=np.zeros(n, np.int32),
                label_rank_executor=np.zeros(n, np.int32),
                unschedulable=np.zeros(n, bool), ready=np.ones(n, bool),
                valid=valid.copy(),
            )

        kw = dict(
            cand_per_req=[np.ones(n, bool)],
            drv_arr=np.asarray([[2, 4, 0]], np.int32),
            exc_arr=np.asarray([[1, 2, 0]], np.int32),
            counts=np.asarray([2], np.int32), num_zones=zb, top_k=4, slack=0.3,
        )
        planner = PrunePlanner()
        host = mk_host()
        planner.sync(host, zb)
        assert planner.plan_full_domain(host, **kw) is not None
        rescans0 = planner.stats["planner_zone_rescans"]
        valid[j] = True
        name_rank[j] = 0
        planner.note_static(np.asarray([j]))
        host2 = mk_host()
        planner.sync(host2, zb)
        plan2 = planner.plan_full_domain(host2, **kw)
        assert planner.stats["planner_boundary_inserts"] >= 1
        assert planner.stats["planner_zone_rescans"] == rescans0
        fresh = PrunePlanner()
        fresh.sync(host2, zb)
        planf = fresh.plan_full_domain(host2, **kw)
        keep2 = plan2.keep[: plan2.k_real]
        assert j in keep2
        assert np.array_equal(keep2, planf.keep[: planf.k_real])
        for a, b in zip(plan2.zone_base, planf.zone_base):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        plans[pkg] = (keep2, [np.asarray(a) for a in plan2.zone_base])
    assert np.array_equal(plans[JAX][0], plans[PORT][0])
    for a, b in zip(plans[JAX][1], plans[PORT][1]):
        assert np.array_equal(a, b)


# ----------------------------------------------- tests/test_device_state.py


def _dev_node(kube, res, i, ready=True):
    return kube.Node(
        name=f"dev-n{i}",
        allocatable=res.from_quantities("8", "8Gi", "1", round_up=False),
        labels={kube.ZONE_LABEL: f"z{i % 3}"},
        ready=ready,
    )


def test_cached_device_state_matches_a_fresh_build_and_jax():
    """build_tensors_cached's device copy, updated by row deltas, stays
    equal to a fresh build through a random mutate-and-serve soak, and
    its host view equals the JAX package's cached build."""
    load_jax_native()
    states = {}
    for pkg in (JAX, PORT):
        kube, res = mod(pkg, "models.kube"), mod(pkg, "models.resources").Resources
        solver_cls = mod(pkg, "core.solver").PlacementSolver
        solver = solver_cls(device="cpu") if pkg == PORT else solver_cls()
        rng = np.random.default_rng(7)
        nodes = [_dev_node(kube, res, i) for i in range(24)]
        usage, overhead, hosts = {}, {}, []
        for step in range(60):
            r = rng.random()
            if r < 0.6:
                name = f"dev-n{int(rng.integers(0, len(nodes)))}"
                cur = usage.get(name, res.zero()).copy()
                cur.add(res.from_quantities("1", "1Gi"))
                usage[name] = cur
            elif r < 0.75:
                name = f"dev-n{int(rng.integers(0, len(nodes)))}"
                overhead[name] = res.from_quantities(
                    str(int(rng.integers(0, 3))), "512Mi"
                )
            elif r < 0.9 and step > 5:
                nodes.append(_dev_node(kube, res, len(nodes)))
            else:
                i = int(rng.integers(0, len(nodes)))
                nodes[i] = _dev_node(kube, res, i, ready=bool(rng.random() < 0.8))
            cached = solver.build_tensors_cached(nodes, dict(usage), dict(overhead))
            fresh = solver.build_tensors(nodes, dict(usage), dict(overhead))
            if pkg == PORT:
                for f in FIELDS:
                    assert torch.equal(getattr(cached, f), getattr(fresh, f)), (step, f)
            hosts.append([np.array(getattr(cached.host, f)) for f in FIELDS])
        states[pkg] = (hosts, dict(solver.device_state_stats))
    for step, (a, b) in enumerate(zip(states[JAX][0], states[PORT][0])):
        for f, fa, fb in zip(FIELDS, a, b):
            assert np.array_equal(fa, fb), (step, f)
    stats = states[PORT][1]
    assert stats["delta_uploads"] > 10 and stats["full_uploads"] < 30, stats
    for k in ("full_uploads", "delta_uploads", "reuse_hits", "delta_rows"):
        assert stats[k] == states[JAX][1][k], (k, stats, states[JAX][1])


def test_serving_path_uses_delta_updates():
    h = _harness("port", 1, 0, n0=16, fifo=True)
    names = [f"n{i:03d}" for i in range(16)]
    for i in range(6):
        assert h.schedule(
            h.mod.static_allocation_spark_pods(f"dev-soak-{i}", 2)[0], names
        ).ok
    stats = h.app.solver.device_state_stats
    assert stats["full_uploads"] <= 2, stats
    assert stats["delta_uploads"] + stats["reuse_hits"] >= 4, stats
    _stop(h)


# -------------------------------------- tests/test_native_runtime.py (arena)


def _node(kube, res, name, cpu="8", mem="8Gi", gpu="0", zone="z1", ready=True,
          unschedulable=False, labels=None):
    return kube.Node(
        name=name,
        allocatable=res.from_quantities(cpu, mem, gpu),
        labels={kube.ZONE_LABEL: zone, **(labels or {})},
        ready=ready,
        unschedulable=unschedulable,
    )


def _rand_cluster(kube, res, rng, n):
    return [
        _node(
            kube, res, f"n{i:04d}", cpu=str(int(rng.integers(1, 64))),
            mem=f"{int(rng.integers(1, 64))}Gi", gpu=str(int(rng.integers(0, 2))),
            zone=f"z{int(rng.integers(0, 4))}", ready=bool(rng.random() > 0.1),
            unschedulable=bool(rng.random() < 0.1),
        )
        for i in range(n)
    ]


def _equal_on_valid(a, b):
    """Every field on valid slots; name ranks by ORDER (the arena's are
    global and gapped, the Python build's dense)."""
    assert np.array_equal(a.valid, b.valid)
    v = np.asarray(a.valid)
    for f in FIELDS[:3] + FIELDS[4:8]:
        assert np.array_equal(np.asarray(getattr(a, f))[v],
                              np.asarray(getattr(b, f))[v]), f
    ra, rb = np.asarray(a.name_rank)[v], np.asarray(b.name_rank)[v]
    assert np.array_equal(np.argsort(ra, stable=True), np.argsort(rb, stable=True))


def test_arena_build_matches_python_build_and_jax_arena():
    load_jax_native()
    hosts = {}
    for pkg in (JAX, PORT):
        kube, res = mod(pkg, "models.kube"), mod(pkg, "models.resources").Resources
        solver_cls = mod(pkg, "core.solver").PlacementSolver
        dev = {"device": "cpu"} if pkg == PORT else {}
        s_native = solver_cls(use_native=True, **dev)
        s_python = solver_cls(use_native=False, **dev)
        assert s_native.uses_native_arena and not s_python.uses_native_arena
        rng = np.random.default_rng(0)
        nodes = _rand_cluster(kube, res, rng, 50)
        usage = {"n0003": res.from_quantities("2", "2Gi"),
                 "n0017": res.from_quantities("1", "512Mi")}
        overhead = {"n0005": res.from_quantities("1", "1Gi")}
        out = []
        t_n = s_native.build_tensors(nodes, usage, overhead)
        hn = t_n.host if pkg == PORT else t_n
        _equal_on_valid(hn, s_python.build_tensors(nodes, usage, overhead).host
                        if pkg == PORT else s_python.build_tensors(nodes, usage, overhead))
        out.append(hn)
        nodes[7] = _node(kube, res, "n0007", cpu="2", mem="1Gi", unschedulable=True)
        subset = nodes[:30] + [_node(kube, res, "extra-1", cpu="4", mem="4Gi", zone="z9")]
        t_n2 = s_native.build_tensors(subset, {}, overhead)
        t_p2 = s_python.build_tensors(subset, {}, overhead)
        hn2 = t_n2.host if pkg == PORT else t_n2
        _equal_on_valid(hn2, t_p2.host if pkg == PORT else t_p2)
        out.append(hn2)
        hosts[pkg] = out
    for a, b in zip(hosts[JAX], hosts[PORT]):
        for f in FIELDS:
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))), f


@pytest.mark.parametrize(
    "strategy", ["tightly-pack", "distribute-evenly", "minimal-fragmentation"]
)
def test_arena_build_places_as_the_python_build_with_label_priorities(strategy):
    solver_mod = mod(PORT, "core.solver")
    kube, res = mod(PORT, "models.kube"), mod(PORT, "models.resources").Resources
    nodes = [
        _node(kube, res, f"m{i}", labels={"tier": ["gold", "silver", "bronze"][i % 3]})
        for i in range(12)
    ]
    prio = ("tier", ["gold", "silver"])
    names = [n.name for n in nodes]
    d, e = res.from_quantities("1", "1Gi"), res.from_quantities("2", "2Gi")
    got = []
    for use_native in (True, False):
        s = solver_mod.PlacementSolver(
            driver_label_priority=prio, device="cpu", use_native=use_native
        )
        got.append(s.pack(strategy, s.build_tensors(nodes, {}, {}), d, e, 5, names))
    assert got[0] == got[1]


# ------------------------------------------------------- the port's own


def test_marker_thread_building_while_windows_serve_changes_no_decision():
    """The unschedulable-pod marker builds tensors from its own thread
    (core/unschedulable.py: a filtered node list, no usage) while the
    batcher serves windows: the build lock serializes the two on the
    arena, and the served decisions equal a run with no marker."""
    runs = []
    for with_marker in (False, True):
        h = _harness("port", 1, 4, n0=48)
        live = [f"n{i:03d}" for i in range(48)]
        stop = threading.Event()
        errors: list = []
        builds = [0]

        def marker(h=h, stop=stop):
            solver, backend = h.app.solver, h.backend
            try:
                while not stop.is_set():
                    nodes = [n for n in backend.list_nodes() if n.name < "n030"]
                    solver.build_tensors(nodes, {}, {})
                    builds[0] += 1
            except Exception as exc:  # surfaced below
                errors.append(exc)

        t = threading.Thread(target=marker, daemon=True) if with_marker else None
        if t is not None:
            t.start()
        rng = np.random.default_rng(99)
        outs = []
        for step in range(10):
            name = live[int(rng.integers(0, len(live)))]
            cur = h.backend.get_node(name)
            h.backend.update("nodes", dataclasses.replace(cur, ready=not cur.ready))
            outs.append(_serve(h, live, (2 * step, 2 * step + 1)))
        stop.set()
        if t is not None:
            t.join(10)
            assert not errors, errors
            assert builds[0] > 0
        runs.append(outs)
        _stop(h)
    assert runs[0] == runs[1]


def test_a_failing_compiler_raises_under_use_native(tmp_path, monkeypatch):
    native = mod(PORT, "native")
    solver_mod = mod(PORT, "core.solver")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native runtime build failed"):
        solver_mod.PlacementSolver(device="cpu")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="compiler not found"):
        solver_mod.PlacementSolver(device="cpu", use_native=True)
    assert not list(tmp_path.glob("*.so"))
    # The dense build needs no compiler.
    assert not solver_mod.PlacementSolver(
        device="cpu", use_native=False
    ).uses_native_arena


def test_cpu_tensors_never_alias_the_resident_host_buffers():
    """The resident build patches its host buffers in place, so every
    upload copies, on the CPU too: a build's tensors, a pipelined full
    upload and a handle's dispatch-time view keep their values while later
    builds patch the buffers."""
    h = _harness("port", 1, 4, n0=32)
    live = [f"n{i:03d}" for i in range(32)]
    _serve(h, live, (0,))
    solver = h.app.solver
    snap = h.app.extender.features.snapshot()
    hints = dict(
        full_node_list=True, topo_version=snap.nodes_version,
        roster_rows=snap.roster_rows, avail_epoch=snap.avail_epoch,
        avail_journal=snap.avail_journal,
    )
    t = solver.build_tensors(snap.nodes, snap.usage, snap.overhead, **hints)
    piped = solver._pipe["tensors"]
    for src, dst in ((t.host.available, t.available),
                     (solver._pipe["host"].available, piped.available)):
        assert src is solver._snap_res["fields"]["available"]
        assert not np.shares_memory(src, dst.numpy())
    before_t, before_p = t.available.clone(), piped.available.clone()
    for i in range(4):  # later windows patch the resident buffer in place
        _serve(h, live, (10 + i,))
    assert torch.equal(t.available, before_t)
    assert torch.equal(piped.available, before_p)
    _stop(h)
