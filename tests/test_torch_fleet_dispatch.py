"""Fleet-fused dispatch of the port (fleet/dispatch.py,
`fleet.stack-window-ms`) on the CPU, against the JAX package.

The scenarios of tests/test_fleet_dispatch.py, on the port with its own
assertions kept: concurrent per-cluster windows stack into one solve and
every cluster stays byte-identical to its unstacked standalone replay;
a lone cluster's windows time out into per-cluster fallbacks; clusters of
different node buckets never share a stack; a cluster killed mid-gather
is expelled (forced resolve) while the survivors still stack; deferred
windows pad app rows at the lane's quantum 8 while every window that does
not defer keeps the serving layout (the solver's quantum stays 32); and
stacking defaults off. Across the packages, each cluster's decisions and
reservation specs equal the JAX fleet's (each cluster's traffic is one
thread's, so its order is deterministic even when the interleaving of
clusters is not), and so do the stacking counters where they are
deterministic.

The port defers only on a CPU solver: on the card the row walk serves
every window (tests/test_torch_cuda.py holds that side). Tolerance: none.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest

from tests.test_torch_extender import JAX, PORT
from tests.test_torch_fleet import Pkg, dec
from tests.test_torch_native import load_jax_native


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    load_jax_native()


def _fleet(pkg, n, stack_ms, nodes_per_cluster=2, **cfg_kw):
    f = pkg.facade(n, cfg_kw, record_ops=True, stack_window_ms=stack_ms)
    for c in range(n):
        for i in range(nodes_per_cluster):
            f.add_node(c, pkg.node(f"c{c}-n{i}", f"ig-{c}"))
    return f


def _concurrent_churn(pkg, f, n, rounds=3, seed=7):
    """One worker thread per cluster, each with its own seeded RNG: the
    traffic of each cluster is deterministic, the interleaving is not."""
    stamps = {c: 100.0 * (c + 1) for c in range(n)}

    def pods(c, app, k):
        stamps[c] += 1.0
        return [
            dataclasses.replace(p, creation_timestamp=stamps[c],
                                uid=f"uid-{p.name}")
            for p in pkg.hm.static_allocation_spark_pods(
                app, k, instance_group=f"ig-{c}"
            )
        ]

    def worker(c):
        rng = np.random.default_rng(seed + c)
        live = []
        for k in range(rounds):
            ps = pods(c, f"stk-c{c}-{k}", int(rng.integers(1, 3)))
            d = f.schedule(ps[0])
            for p in ps[1:]:
                f.schedule(p)
            if d.ok:
                live.append((d.cluster, ps))
            if live and rng.random() < 0.4:
                cluster, old = live.pop(0)
                for p in old:
                    f.stacks[cluster].delete_pod(p)

    ts = [threading.Thread(target=worker, args=(c,)) for c in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def _cluster_decisions(f):
    return [
        [(e[3].ok, tuple(e[3].node_names), e[3].outcome)
         for e in s.oplog if e[0] == "schedule"]
        for s in f.stacks
    ]


def _sequential(pkg, f, apps, group):
    out = []
    for k in range(apps):
        for p in pkg.pods(f"seq-{group}-{k}", 1, group):
            out.append(dec(f.schedule(p)))
    return out


DISPATCH_CONFIGS = [
    pytest.param({}, id="default"),
    pytest.param({"solver_prune_top_k": 4}, id="pruned"),
    pytest.param({"solver_device_pool": 2}, id="pooled"),
]


@pytest.mark.parametrize("cfg_kw", DISPATCH_CONFIGS)
@pytest.mark.parametrize("n", [2, 4])
def test_concurrent_churn_stacks_and_matches_jax(n, cfg_kw):
    got = {}
    for root in (JAX, PORT):
        pkg = Pkg(root)
        f = _fleet(pkg, n, 150.0, **cfg_kw)
        try:
            _concurrent_churn(pkg, f, n)
            st = f.state()["stacking"]
            if not cfg_kw:
                assert st["stacked_dispatches"] > 0, (root, st)
            elif "solver_device_pool" in cfg_kw and root == JAX:
                # The JAX package's 8 virtual CPU devices make a pool,
                # whose windows never defer; the port's one CPU device
                # makes none, so its windows defer like the default's.
                assert st["deferred"] == 0, st
            assert st["forced_resolves"] == 0, (root, st)
            report = pkg.verify(f)
            assert set(report) == set(range(n))
            assert all(r["identical"] for r in report.values())
            for s in f.stacks:
                assert s.aggregates.oracle_equals(), f"cluster {s.index}"
            got[root] = (
                _cluster_decisions(f),
                [s.reservation_specs() for s in f.stacks],
            )
        finally:
            f.stop()
    assert got[PORT] == got[JAX]


def test_lone_cluster_times_out_and_matches_unstacked():
    got = {}
    for root in (JAX, PORT):
        pkg = Pkg(root)
        on = _fleet(pkg, 3, 60.0)
        off = _fleet(Pkg(root), 3, 0.0)
        try:
            a = _sequential(pkg, on, 3, "ig-0")
            b = _sequential(Pkg(root), off, 3, "ig-0")
            assert a == b
            st = on.state()["stacking"]
            assert st["stacked_dispatches"] == 0, st
            assert st["fallbacks"] >= 3, st
            assert st["forced_resolves"] == 0, st
            assert all(r["identical"]
                       for r in pkg.verify(on).values())
            got[root] = (a, st["fallbacks"], st["deferred"])
        finally:
            on.stop()
            off.stop()
    assert got[PORT] == got[JAX]


def test_different_node_buckets_never_share_a_stack():
    got = {}
    for root in (JAX, PORT):
        pkg = Pkg(root)
        f = pkg.facade(2, record_ops=True, stack_window_ms=300.0)
        try:
            for i in range(2):
                f.add_node(0, pkg.node(f"c0-n{i}", "ig-0"))
            for i in range(12):
                f.add_node(1, pkg.node(f"c1-n{i}", "ig-1"))
            pods = {c: pkg.pods(f"mix-{c}", 1, f"ig-{c}") for c in range(2)}

            def pump(c):
                for p in pods[c]:
                    f.schedule(p)

            ts = [threading.Thread(target=pump, args=(c,)) for c in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            st = f.state()["stacking"]
            assert st["deferred"] >= 2, st
            assert st["stacked_dispatches"] == 0, st
            assert st["fallbacks"] >= 2, st
            assert all(r["identical"] for r in pkg.verify(f).values())
            got[root] = _cluster_decisions(f)
        finally:
            f.stop()
    assert got[PORT] == got[JAX]


def test_victim_forced_and_survivors_stack():
    pkg = Pkg(PORT)
    f = _fleet(pkg, 3, 3000.0)
    try:
        done = threading.Event()
        victim = pkg.pods("kill-victim", 1, "ig-0")[0]

        def victim_pump():
            f.schedule(victim)
            done.set()

        t = threading.Thread(target=victim_pump)
        t.start()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if f.dispatch.describe()["pending"] >= 1:
                break
            time.sleep(0.005)
        else:
            pytest.fail("victim window never deferred")
        f.kill_cluster(0)
        assert done.wait(5.0), "victim window never resolved after kill"
        t.join()
        st = f.state()["stacking"]
        assert st["forced_resolves"] == 1, st
        assert st["expected"] == 2, st
        pods = {c: pkg.pods(f"surv-{c}", 1, f"ig-{c}") for c in (1, 2)}

        def pump(c):
            for p in pods[c]:
                f.schedule(p)

        ts = [threading.Thread(target=pump, args=(c,)) for c in (1, 2)]
        for s in ts:
            s.start()
        for s in ts:
            s.join()
        assert f.state()["stacking"]["stacked_dispatches"] >= 1
        assert all(r["identical"] for r in pkg.verify(f).values())
    finally:
        f.stop()


def test_deferred_windows_use_quantum_8_serving_keeps_its_layout():
    """Deferred windows pad app rows at the lane quantum (8); a window
    that does not defer (stacking off, or one live cluster) takes the
    serving path: the row walk's plain version, its own layout, and the
    solver's quantum stays 32 — with decisions equal to stack-off."""
    FleetDispatchCoordinator = Pkg(PORT).mod("fleet").FleetDispatchCoordinator
    assert FleetDispatchCoordinator.row_bucket_quantum == 8
    pkg_on, pkg_off = Pkg(PORT), Pkg(PORT)
    on, off = _fleet(pkg_on, 2, 200.0), _fleet(pkg_off, 2, 0.0)
    try:
        for g in (on, off):
            for s in g.stacks:
                assert s.app.solver._row_bucket_quantum == 32
        pods = {c: pkg_on.pods(f"rbq-{c}", 1, f"ig-{c}") for c in range(2)}

        def pump(g, c, ps):
            for p in ps:
                g.schedule(p)

        ts = [threading.Thread(target=pump, args=(on, c, pods[c]))
              for c in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert on.state()["stacking"]["stacked_dispatches"] > 0
        for c in range(2):
            pump(off, c, pkg_off.pods(f"rbq-{c}", 1, f"ig-{c}"))
        for s in on.stacks:
            info = s.app.solver.last_solve_info
            assert info["path"] == "deferred" and info["row_bucket"] == 8
        for s in off.stacks:
            info = s.app.solver.last_solve_info
            assert info["path"] == "reference", info
        on.kill_cluster(1)
        off.kill_cluster(1)
        got = _sequential(pkg_on, on, 2, "ig-0")
        want = _sequential(pkg_off, off, 2, "ig-0")
        assert got == want
        assert on.stacks[0].app.solver.last_solve_info["path"] == "reference"
        assert on.state()["stacking"]["deferred"] == 2
        assert all(r["identical"] for r in pkg_on.verify(on).values())
    finally:
        on.stop()
        off.stop()


def test_stack_window_defaults_off_and_facade_honors_config():
    pkg = Pkg(PORT)
    assert pkg.config().fleet_stack_window_ms == 0.0
    f = _fleet(pkg, 3, 0.0)
    try:
        assert f.dispatch is None
        for s in f.stacks:
            assert s.app.solver._dispatch_lane is None
        assert f.state()["stacking"] == {"enabled": False}
        _sequential(pkg, f, 2, "ig-0")
        assert all(r["identical"] for r in pkg.verify(f).values())
    finally:
        f.stop()
    g = pkg.facade(2, {"fleet_stack_window_ms": 120.0}, record_ops=True)
    try:
        assert g.dispatch is not None
        assert g.dispatch.describe()["window_ms"] == 120.0
        for s in g.stacks:
            assert s.app.solver._dispatch_lane is g.dispatch
    finally:
        g.stop()
