"""Pipelined serving in the port: window k+1 dispatched before window k is
fetched, with the availability threaded on the device
(`PlacementSolver.build_tensors_pipelined` -> `pack_window_dispatch` ->
`pack_window_fetch`), against the JAX package on the CPU.

Two levels:
  - the solver: the port's pipelined windows against the JAX package's
    (decisions and efficiencies), against the port's own serialized
    windows, and the device-state contract (the upload kinds, the mirror,
    in-flight handles and earlier tensors left as they were);
  - the extender: the non-HTTP, single-device scenarios of
    tests/test_pipelined_serving.py, each run on a JAX and a port extender
    (tests/test_torch_extender.py `Side`), whose results, reservations and
    demands must be equal after every request.

Tolerance: none.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from tests.test_torch_extender import JAX, PORT, NS, Side, run_both

# ----------------------------------------------------------------- solver


def _solver_env(root, n_nodes, rng_seed):
    """(solver, make_node, Resources, WindowRequest) of one package, and the
    seeded node specs both packages build from."""
    solver_mod = importlib.import_module(f"{root}.core.solver")
    kube = importlib.import_module(f"{root}.models.kube")
    res = importlib.import_module(f"{root}.models.resources").Resources
    if root == JAX:
        solver = solver_mod.PlacementSolver(use_native=False)
    else:
        solver = solver_mod.PlacementSolver(device="cpu")
    rng = np.random.default_rng(rng_seed)
    specs = [
        (f"node-{i:02d}", int(rng.integers(4, 17)), int(rng.integers(4, 17)),
         f"zone{i % 3}")
        for i in range(n_nodes)
    ]

    def node(spec):
        name, cpu, mem, zone = spec
        return kube.Node(
            name=name,
            allocatable=res.from_quantities(str(cpu), f"{mem}Gi", "1"),
            labels={kube.ZONE_LABEL: zone},
        )

    return solver, [node(s) for s in specs], res, solver_mod


def _windows(res, request_cls, names, seed, n_windows=4, per_window=5):
    """Seeded windows of driver requests, some with earlier FIFO rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_windows):
        reqs = []
        for _ in range(per_window):
            rows = []
            for _ in range(int(rng.integers(0, 3))):
                rows.append((
                    res.from_quantities(str(int(rng.integers(1, 3))), "1Gi"),
                    res.from_quantities("1", f"{int(rng.integers(1, 3))}Gi"),
                    int(rng.integers(1, 5)),
                    bool(rng.random() < 0.5),
                ))
            rows.append((
                res.from_quantities("1", "1Gi"),
                res.from_quantities(str(int(rng.integers(1, 3))), "2Gi"),
                int(rng.integers(1, 7)),
                False,
            ))
            reqs.append(request_cls(rows=rows, driver_candidate_names=names))
        out.append(reqs)
    return out


def _decisions(ds):
    return [
        (d.admitted, d.earlier_blocked, tuple(d.packing))
        for d in ds
    ]


def _commit_usage(usage, res, window, decisions):
    """Add each admitted request's placement to the {node: Resources} usage
    map, as the extender's reservations would."""
    for req, d in zip(window, decisions):
        if not d.admitted:
            continue
        drv, exc = req.rows[-1][0], req.rows[-1][1]
        usage.setdefault(d.packing.driver_node, res.zero()).add(drv)
        for n in d.packing.executor_nodes:
            usage.setdefault(n, res.zero()).add(exc)


def _run_solver(root, strategy, depth):
    """Windows served with `depth` of them in flight (1 = serialized): each
    window's placements reach the host usage only when it is fetched."""
    solver, nodes, res, solver_mod = _solver_env(root, 12, 0)
    names = [n.name for n in nodes]
    windows = _windows(res, solver_mod.WindowRequest, names, 1)
    usage: dict = {}
    inflight, out, uploads = [], [], []
    for w in windows:
        tensors = solver.build_tensors_pipelined(nodes, usage, {})
        uploads.append(solver.last_state_upload)
        inflight.append((w, solver.pack_window_dispatch(strategy, tensors, w)))
        if len(inflight) == depth:
            win, h = inflight.pop(0)
            d = solver.pack_window_fetch(h)
            _commit_usage(usage, res, win, d)
            out.append(_decisions(d))
    for win, h in inflight:
        d = solver.pack_window_fetch(h)
        _commit_usage(usage, res, win, d)
        out.append(_decisions(d))
    solver.build_tensors_pipelined(nodes, usage, {})
    uploads.append(solver.last_state_upload)
    return out, uploads, solver


@pytest.mark.parametrize(
    "strategy", ["tightly-pack", "distribute-evenly", "single-az-tightly-pack"]
)
def test_pipelined_windows_match_jax_and_serialized(strategy):
    """Four windows in flight at once: the later windows' fetch-side
    efficiencies must subtract the placements of every earlier in-flight
    window (the handle's priors). Equal to the JAX package at the same
    depth, and to the port's serialized run."""
    got, got_uploads, port = _run_solver(PORT, strategy, depth=4)
    want, want_uploads, _ = _run_solver(JAX, strategy, depth=4)
    serial, serial_uploads, _ = _run_solver(PORT, strategy, depth=1)
    assert got == want
    assert got == serial
    admitted = sum(d[0] for w in got for d in w)
    assert 0 < admitted < sum(len(w) for w in got)
    assert got_uploads == want_uploads
    # Full upload first; the in-flight windows then ride the device base
    # (nothing fetched yet: no host change to ship); once every window's
    # placements are in the host usage, the mirror equals the host view.
    assert got_uploads == ["full", "reuse", "reuse", "reuse", "reuse"]
    assert serial_uploads[0] == "full"
    assert set(serial_uploads[1:]) <= {"reuse", "delta"}
    assert port._pipe["unfetched"] == []


def test_pipelined_build_leaves_earlier_tensors_and_handles_unchanged():
    """Neither a delta build nor a static delta writes a tensor that an
    earlier build returned, and a dispatched handle keeps its
    dispatch-time host view."""
    solver, nodes, res, solver_mod = _solver_env(PORT, 6, 2)
    names = [n.name for n in nodes]
    t1 = solver.build_tensors_pipelined(nodes, {}, {})
    a1 = t1.available.clone()
    s1 = t1.valid.clone()
    w = [solver_mod.WindowRequest(
        rows=[(res.from_quantities("1", "1Gi"), res.from_quantities("1", "1Gi"),
               3, False)],
        driver_candidate_names=names,
    )]
    h = solver.pack_window_dispatch("tightly-pack", t1, w)
    host_at_dispatch = h.host_avail.copy()
    # An external usage change (availability delta) and a node going
    # unschedulable (static delta) while the window is in flight.
    nodes[0].unschedulable = True
    usage = {names[1]: res.from_quantities("2", "2Gi")}
    t2 = solver.build_tensors_pipelined(nodes, usage, {})
    assert solver.last_state_upload == "delta"
    assert solver.device_state_stats["static_delta_uploads"] == 1
    assert torch.equal(t1.available, a1) and torch.equal(t1.valid, s1)
    assert not torch.equal(t2.available, a1)
    np.testing.assert_array_equal(h.host_avail, host_at_dispatch)
    # t2's base = the row walk's base after window 1, plus the usage delta.
    d = solver.pack_window_fetch(h)[0]
    assert d.admitted
    expect = np.array(t2.host.available, np.int64)
    drv, exc = w[0].rows[0][0].as_array(), w[0].rows[0][1].as_array()
    idx = solver.registry.index_of
    expect[idx(d.packing.driver_node)] -= drv
    for n in d.packing.executor_nodes:
        expect[idx(n)] -= exc
    np.testing.assert_array_equal(t2.available.numpy(), expect)


def test_int32_delta_overflow_drains_only_while_in_flight():
    """A host swing that no int32 delta row can carry (here a node's
    availability from +INT32_MAX to -INT32_MAX) needs a full upload: with a
    window in flight the build raises, after the fetch it uploads."""
    solver, nodes, res, solver_mod = _solver_env(PORT, 4, 3)
    names = [n.name for n in nodes]
    big = res(2**31 - 1, 2**31 - 1, 0)
    nodes[0].allocatable = big
    t = solver.build_tensors_pipelined(nodes, {}, {})
    w = [solver_mod.WindowRequest(
        rows=[(res.from_quantities("1", "1Gi"), res.from_quantities("1", "1Gi"),
               1, False)],
        driver_candidate_names=names[1:],
    )]
    h = solver.pack_window_dispatch("tightly-pack", t, w)
    usage, overhead = {names[0]: big}, {names[0]: big}
    with pytest.raises(solver_mod.PipelineDrainRequired, match="int32"):
        solver.build_tensors_pipelined(nodes, usage, overhead)
    solver.pack_window_fetch(h)
    solver.build_tensors_pipelined(nodes, usage, overhead)
    assert solver.last_state_upload == "full"


def _solo_across_topology_change(change, order, count=None):
    """Window W dispatched on the pipelined build of 16 nodes, then a
    topology change (`change`: a node added past the padding bucket, or,
    with static row deltas off, a node added or one cordoned), then a solo
    pack of a 1-CPU driver and `count` 1-CPU executors over every
    schedulable node. `order` "solo-first" runs the solo pack while W is in
    flight, built as the extender builds a solo solve (the pipelined
    build, and build_tensors_solo when that raises
    PipelineDrainRequired); "fetch-first" fetches W and commits its gangs
    first. Returns (W's decisions and the solo packing, the nodes
    over-committed, the CPUs the host view shows free at the solo pack, the
    solver)."""
    import dataclasses

    solver_mod = importlib.import_module(f"{PORT}.core.solver")
    kube = importlib.import_module(f"{PORT}.models.kube")
    res = importlib.import_module(f"{PORT}.models.resources").Resources
    solver = solver_mod.PlacementSolver(
        device="cpu", delta_statics=change == "add-past-bucket")
    nodes = [
        kube.Node(name=f"node-{i:02d}",
                  allocatable=res.from_quantities("8", "8Gi", "1"),
                  labels={kube.ZONE_LABEL: f"zone{i % 2}"})
        for i in range(16)
    ]
    names = [n.name for n in nodes]
    one = res.from_quantities("1", "1Gi")
    window = [
        solver_mod.WindowRequest(rows=[(one, one, k, False)],
                                 driver_candidate_names=names)
        for k in (5, 9, 3)
    ]
    usage: dict = {}

    def commit(name, amount):
        usage[name] = usage.get(name, res.zero()).add(amount)

    def fetch(h):
        got = solver.pack_window_fetch(h)
        for d in got:
            if d.admitted:
                commit(d.packing.driver_node, one)
                for name in d.packing.executor_nodes:
                    commit(name, one)
        return [tuple(d) for d in got]

    h = solver.pack_window_dispatch(
        "tightly-pack", solver.build_tensors_pipelined(nodes, usage, {}), window)
    after = list(nodes)
    if change == "cordon":
        after[3] = dataclasses.replace(after[3], unschedulable=True)
    else:
        after.append(kube.Node(name="node-16",
                               allocatable=res.from_quantities("8", "8Gi", "1"),
                               labels={kube.ZONE_LABEL: "zone0"}))
    out = fetch(h) if order == "fetch-first" else []
    try:
        t = solver.build_tensors_pipelined(after, usage, {})
        assert order == "fetch-first"
    except solver_mod.PipelineDrainRequired:
        assert order == "solo-first"
        t = solver.build_tensors_solo(after, usage, {})
    live = [n for n in after if not n.unschedulable]
    free = sum(n.allocatable.cpu_milli - usage.get(n.name, res.zero()).cpu_milli
               for n in live) // 1000
    if count is None:
        count = free - 1
    solo = solver.pack("tightly-pack", t, one, one, count,
                       [n.name for n in live])
    if solo.has_capacity:
        commit(solo.driver_node, one)
        for name in solo.executor_nodes:
            commit(name, one)
    out.append((solo.has_capacity, solo.driver_node, tuple(solo.executor_nodes)))
    if order == "solo-first":
        out = fetch(h) + out
    over = [n.name for n in after
            if usage.get(n.name, res.zero()).cpu_milli > n.allocatable.cpu_milli]
    return out, over, free, solver


@pytest.mark.parametrize("change", ["add-past-bucket", "add", "cordon"])
def test_solo_pack_across_a_topology_change_sees_the_inflight_window(change):
    """A solo solve while a window is in flight across a topology change
    (ROADMAP §C.6): the pipelined build is refused, and the solo build
    debits the in-flight window's gangs, read from its decision blob and
    keyed by node name, so the solo pack asking for every CPU left (the
    fetch-first run's count) decides as it does after the window's fetch,
    and nothing is over-committed. The window's fetch still returns its
    own decisions. Without the debit the host view lacks the window's
    gangs, and the same pack over-commits."""
    want, want_over, free_after, _ = _solo_across_topology_change(
        change, "fetch-first")
    count = free_after - 1
    want, want_over, _, _ = _solo_across_topology_change(
        change, "fetch-first", count)
    got, over, free_before, solver = _solo_across_topology_change(
        change, "solo-first", count)
    assert free_before > free_after  # the host view lacked W's gangs
    assert want[-1][0]  # the count fills exactly what is left
    assert want_over == [] and over == []
    assert got == want
    assert solver.solo_inflight_debits == 1


# --------------------------------------------------------------- extender


def _harness_nodes(h, n_nodes):
    names = [f"n{i}" for i in range(n_nodes)]
    h.add_nodes(*(h.node(n, zone=f"zone{i % 2}") for i, n in enumerate(names)))
    return names


def _driver_args(h, app_id, execs, names):
    driver = h.spark_pods(app_id, execs)[0]
    h.add_pods(driver)
    return driver, h.args(driver, names)


def _drain_error(h):
    return importlib.import_module(f"{h.root}.core.solver").PipelineDrainRequired


def pipelined_vs_serial(h, mode):
    names = _harness_nodes(h, 12)
    w1 = [_driver_args(h, f"app-a{i}", 3, names)[1] for i in range(3)]
    w2 = [_driver_args(h, f"app-b{i}", 3, names)[1] for i in range(3)]
    w3 = [_driver_args(h, f"app-c{i}", 3, names)[1] for i in range(3)]
    if mode == "pipelined":
        tickets = [h.dispatch(w) for w in (w1, w2, w3)]
        for t in tickets:
            h.complete(t)
    else:
        for w in (w1, w2, w3):
            h.complete(h.dispatch(w))


@pytest.mark.parametrize("mode", ["pipelined", "serial"])
def test_pipelined_windows_match_serialized_and_jax(mode):
    jax_side, port_side = run_both(
        lambda h: pipelined_vs_serial(h, mode), binpack="tightly-pack"
    )
    if mode == "pipelined":
        serial = Side(PORT, binpack="tightly-pack")
        pipelined_vs_serial(serial, "serial")
        assert [r for r, _ in port_side.log] == [r for r, _ in serial.log]
        assert all(r[1][0] for res, _ in port_side.log for r in res)


def capacity_threaded(h):
    names = _harness_nodes(h, 2)
    w1 = [_driver_args(h, f"fit-{i}", 7, names)[1] for i in range(2)]
    w2 = [_driver_args(h, f"over-{i}", 7, names)[1] for i in range(2)]
    t1, t2 = h.dispatch(w1), h.dispatch(w2)
    r1, r2 = h.complete(t1), h.complete(t2)
    assert all(r.node_names for r in r1)
    assert not any(r.node_names for r in r2)


def inflight_app_defers(h):
    names = _harness_nodes(h, 12)
    driver, args = _driver_args(h, "dup-app", 3, names)
    o1 = _driver_args(h, "other-1", 3, names)[1]
    o2 = _driver_args(h, "other-2", 3, names)[1]
    t1 = h.dispatch([args, o1])
    t2 = h.dispatch([h.args(driver, names), o2])
    assert (NS, "dup-app") in h.extender._inflight_apps
    r1 = h.complete(t1)
    r2 = h.complete(t2)
    assert r1[0].node_names and r1[0].node_names == r2[0].node_names


def reservation_failure_restores_capacity(h):
    names = _harness_nodes(h, 1)
    rrm = h.rrm
    orig = rrm.create_reservations

    def flaky(pod, res, driver_node, exec_nodes):
        if pod.labels["spark-app-id"].startswith("fail"):
            raise h.reservation_error("injected write failure")
        return orig(pod, res, driver_node, exec_nodes)

    rrm.create_reservations = flaky
    wf = [_driver_args(h, f"fail-{i}", 7, names)[1] for i in range(2)]
    assert not any(r.node_names for r in h.complete(h.dispatch(wf)))
    ok = [_driver_args(h, f"recover{s}", 7, names)[1] for s in ("", "-b")]
    r2 = h.complete(h.dispatch(ok))
    assert r2[0].node_names and not r2[1].node_names


def node_add_rides_static_delta(h):
    names = _harness_nodes(h, 4)
    w1 = [_driver_args(h, f"dr-{i}", 2, names)[1] for i in range(2)]
    t1 = h.dispatch(w1)
    h.add_nodes(h.node("late-node", zone="zone0"))
    w2 = [_driver_args(h, f"dr2-{i}", 2, names + ["late-node"])[1]
          for i in range(2)]
    before = h.solver.device_state_stats["static_delta_uploads"]
    t2 = h.dispatch(w2)
    assert h.solver.device_state_stats["static_delta_uploads"] > before
    assert all(r.node_names for r in h.complete(t1))
    assert all(r.node_names for r in h.complete(t2))
    late = _driver_args(h, "on-late", 7, ["late-node"])[1]
    assert h.complete(h.dispatch([late]))[0].node_names == ["late-node"]


def topology_change_drains(h):
    """Crossing the pad bucket changes every resident shape: no delta can
    express it, so a dispatch with a window in flight must drain."""
    names = _harness_nodes(h, 4)
    t1 = h.dispatch([_driver_args(h, f"dr-{i}", 2, names)[1] for i in range(2)])
    late = [h.node(f"late-{j}", zone="zone0") for j in range(5)]
    h.add_nodes(*late)
    names2 = names + [n.name for n in late]
    w2 = [_driver_args(h, f"dr2-{i}", 2, names2)[1] for i in range(2)]
    with pytest.raises(_drain_error(h)):
        h.dispatch(w2)
    assert all(r.node_names for r in h.complete(t1))
    assert all(r.node_names for r in h.complete(h.dispatch(w2)))


def statics_change_drains_with_delta_off(h):
    names = _harness_nodes(h, 4)
    t1 = h.dispatch([_driver_args(h, f"dr-{i}", 2, names)[1] for i in range(2)])
    h.add_nodes(h.node("late-node", zone="zone0"))
    w2 = [_driver_args(h, f"dr2-{i}", 2, names + ["late-node"])[1]
          for i in range(2)]
    with pytest.raises(_drain_error(h)):
        h.dispatch(w2)
    assert all(r.node_names for r in h.complete(t1))
    assert all(r.node_names for r in h.complete(h.dispatch(w2)))


def solo_sees_inflight_gangs(h):
    names = _harness_nodes(h, 1)
    t1 = h.dispatch([_driver_args(h, f"w-{i}", 7, names)[1] for i in range(2)])
    assert not h.predicate(_driver_args(h, "solo-late", 3, names)[1]).node_names
    assert h.complete(t1)[0].node_names


def capacity_epoch_resolves_stale_window(h):
    names = _harness_nodes(h, 1)
    solver = h.solver
    t1 = h.dispatch([_driver_args(h, f"stale-{i}", 7, names)[1] for i in range(2)])
    orig = solver.build_tensors_pipelined

    def blind_build(nodes, usage, overhead, topo_version=None, **_kw):
        return solver.build_tensors(nodes, usage, overhead)

    solver.build_tensors_pipelined = blind_build
    try:
        assert h.predicate(_driver_args(h, "solo-blind", 7, names)[1]).node_names
    finally:
        solver.build_tensors_pipelined = orig
    assert not any(r.node_names for r in h.complete(t1))


def epoch_mismatch_invalidates_later_windows(h):
    names = _harness_nodes(h, 2)
    t_b = h.dispatch([_driver_args(h, f"b-{i}", 1, names)[1] for i in range(2)])
    assert h.predicate(_driver_args(h, "solo-mid", 5, names)[1]).node_names
    epoch = h.extender._capacity_epoch
    t_c = h.dispatch([_driver_args(h, "c-0", 3, names)[1],
                      _driver_args(h, "c-1", 1, names)[1]])
    r_b = h.complete(t_b)
    assert h.extender._capacity_epoch > epoch
    r_c = h.complete(t_c)
    assert all(r.node_names for r in list(r_b) + list(r_c))


SCENARIOS = {
    f.__name__: (f, kw)
    for f, kw in (
        (capacity_threaded, dict(fifo=False)),
        (inflight_app_defers, {}),
        (reservation_failure_restores_capacity, dict(fifo=False)),
        (node_add_rides_static_delta, {}),
        (topology_change_drains, {}),
        (statics_change_drains_with_delta_off, dict(delta_statics=False)),
        (solo_sees_inflight_gangs, dict(fifo=False)),
        (capacity_epoch_resolves_stale_window, dict(fifo=False)),
        (epoch_mismatch_invalidates_later_windows, dict(fifo=False)),
    )
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pipelined_scenario_matches_jax(name):
    fn, kw = SCENARIOS[name]
    run_both(fn, binpack="tightly-pack", **kw)
