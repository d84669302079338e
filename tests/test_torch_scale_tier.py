"""The port's scale tier (`solver.scale-tier`) and the multi-device surface
around it, against the JAX package on the CPU.

  - The twin of tests/test_scale_tier.py
    `test_scale_tier_escalation_matches_host_resolve`: a tight top-K forces
    certificate escalations; with the tier on, the escalated windows
    re-solve node-sharded (the port's 8 `cpu` shards, the JAX package's 8
    virtual devices) and equal the re-solve without the tier, the full
    unpruned solve and the JAX package's decisions, every field of every
    WindowDecision.
  - The recorded deviation: only a classified device fault in the sharded
    re-solve reaches the degraded policy (the host greedy, counted in
    `fallbacks`; a shed; or the fault itself with no controller); a plain
    RuntimeError raises. The fault injector faults the tier's thread only.
  - A classified fault in the mesh slot's own part solve while another
    window's escalation runs: exact decisions, the slot quarantined and
    reinstated, the run driven as the batcher drives it (a build that
    raises PipelineDrainRequired fetches the windows in flight first).
  - `/debug/state` carries the JAX package's `device_pool` (mesh slot
    labels) and `scale_tier` blocks for the same run.
  - The CLI: `--mesh 1x4 --scale-tier` parses to the JAX CLI's
    InstallConfig fields, and `--mesh 2` returns 2.

Tolerance: none.
"""

from __future__ import annotations

import importlib
import itertools
import threading

import numpy as np
import pytest

from tests.test_torch_extender import JAX, PORT, canon
from tests.test_torch_native import load_jax_native


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def esc_nodes(pkg, n, zones=3):
    kube = mod(pkg, "models.kube")
    res = mod(pkg, "models.resources").Resources
    return [
        kube.Node(
            name=f"n{i:03d}",
            allocatable=res.from_quantities("8", "8Gi", "1", round_up=False),
            labels={kube.ZONE_LABEL: f"z{i % zones}"},
        )
        for i in range(n)
    ]


def esc_world(seed, n_nodes=128, n_batches=3, k=2, per=4):
    """tests/test_scale_tier.py `_esc_windows`, as plain data: per batch, k
    windows of `per` requests, each ((rows), candidates = every node)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        wins = []
        for _ in range(k):
            reqs = []
            for _ in range(per):
                rows = [("1", int(rng.integers(1, 3)), bool(rng.random() < 0.5))
                        for _ in range(int(rng.integers(0, 3)))]
                size = "2" if rng.random() < 0.3 else "1"
                rows.append((size, int(rng.integers(1, 4)), False))
                reqs.append(rows)
            wins.append(reqs)
        out.append(wins)
    return out


def materialize(pkg, world, nodes):
    sm = mod(pkg, "core.solver")
    res = mod(pkg, "models.resources").Resources
    one = res.from_quantities("1", "1Gi")
    names = [n.name for n in nodes]
    return [
        [
            [
                sm.WindowRequest(
                    rows=[(res.from_quantities(c, f"{c}Gi"), one, n, s)
                          for c, n, s in rows],
                    driver_candidate_names=names,
                )
                for rows in w
            ]
            for w in wins
        ]
        for wins in world
    ]


def esc_run(solver, nodes, batches, strategy="tightly-pack"):
    out = []
    for wins in batches:
        handles = []
        for w in wins:
            t = solver.build_tensors_pipelined(nodes, {}, {})
            handles.append(solver.pack_window_dispatch(strategy, t, w))
        for hd in handles:
            out.extend(solver.pack_window_fetch(hd))
    return out


def port_solver(pooled=False, **kw):
    """A CPU solver: pooled, one 8-shard mesh slot on `cpu` (the scale
    tier shards over the slot's devices); pool-less, the tier finds the
    one local `cpu` device and re-solves on the row walk."""
    sm = mod(PORT, "core.solver")
    if pooled:
        return sm.PlacementSolver(device="cpu", use_native=False, mesh=(1, 8),
                                  pool_devices=["cpu"] * 8, **kw)
    return sm.PlacementSolver(device="cpu", use_native=False, **kw)


TIGHT = dict(prune_top_k=1, prune_slack=0.01)


@pytest.mark.parametrize("pooled", [False, True], ids=["pool-less", "pooled"])
def test_scale_tier_escalation_matches_host_resolve(pooled):
    world = esc_world(9)
    jax_nodes = esc_nodes(JAX, 128)
    jsm = mod(JAX, "core.solver")
    jax_batches = materialize(JAX, world, jax_nodes)
    jax_host = esc_run(jsm.PlacementSolver(use_native=False, **TIGHT),
                       jax_nodes, jax_batches)
    jax_tier = jsm.PlacementSolver(use_native=False, scale_tier=True, **TIGHT)
    assert canon(esc_run(jax_tier, jax_nodes, jax_batches)) == canon(jax_host)
    assert jax_tier.scale_tier_stats["sharded"] > 0

    nodes = esc_nodes(PORT, 128)
    batches = materialize(PORT, world, nodes)
    off = port_solver(pooled, **TIGHT)
    a = esc_run(off, nodes, batches)
    tier = port_solver(pooled, scale_tier=True, **TIGHT)
    b = esc_run(tier, nodes, batches)
    assert off.prune_stats["escalations"] > 0
    assert tier.prune_stats["escalations"] > 0
    assert a == b
    assert off.scale_tier_stats == {"resolves": 0, "sharded": 0, "fallbacks": 0}
    st = tier.scale_tier_stats
    # Pooled: every re-solve on the mesh slot's 8 shards; pool-less: one
    # local device, so the row walk.
    assert st["resolves"] > 0, st
    assert st["sharded"] == (st["resolves"] if pooled else 0), st
    assert st["fallbacks"] == 0, st
    full = esc_run(port_solver(pooled), nodes, batches)
    assert full == a
    assert canon(a) == canon(jax_host)


def _fault_in_the_tier(monkeypatch, exc):
    """The node-sharded engine raises `exc`, only inside the scale tier's
    re-solve (the mesh slot's own window solves run it too, on the solve
    pool's workers: the flag is the tier's thread's own)."""
    sm = mod(PORT, "core.solver")
    real_tier = sm.PlacementSolver._scale_tier_decisions
    real_engine = sm.node_sharded_fifo_pack
    inside = threading.local()

    def tier(self, *a, **k):
        inside.on = True
        try:
            return real_tier(self, *a, **k)
        finally:
            inside.on = False

    def engine(*a, **k):
        if getattr(inside, "on", False):
            raise exc
        return real_engine(*a, **k)

    monkeypatch.setattr(sm.PlacementSolver, "_scale_tier_decisions", tier)
    monkeypatch.setattr(sm, "node_sharded_fifo_pack", engine)


def _ecc():
    from spark_scheduler_tpu_torch.faults.errors import CudaDeviceFault

    return CudaDeviceFault(
        214, "node-sharded re-solve: uncorrectable ECC error encountered"
    )


def test_device_fault_in_the_sharded_resolve_serves_the_host_greedy(monkeypatch):
    """A classified device fault in the node-sharded re-solve, under the
    greedy degraded policy, answers from the host greedy (the same
    decisions), engages the controller and counts `fallbacks`; a plain
    RuntimeError raises (the JAX tier would fall back on it too: the
    port's recorded deviation)."""
    from spark_scheduler_tpu_torch.faults.degraded import DegradedModeController

    world = esc_world(9)
    nodes = esc_nodes(PORT, 128)
    batches = materialize(PORT, world, nodes)
    want = esc_run(port_solver(), nodes, batches)

    _fault_in_the_tier(monkeypatch, _ecc())
    tier = port_solver(True, scale_tier=True, **TIGHT)
    tier.degraded = DegradedModeController(policy="greedy")
    assert esc_run(tier, nodes, batches) == want
    st = tier.scale_tier_stats
    # Every escalated window, and every window dispatched on its dropped
    # carry, re-solved on the greedy.
    assert st["fallbacks"] >= tier.prune_stats["escalations"] > 0
    assert st["resolves"] == 0 and st["sharded"] == 0
    assert tier.degraded.engagements > 0
    assert tier.degraded.fallback_decisions > 0

    _fault_in_the_tier(monkeypatch, RuntimeError("a bug in the engine"))
    tier = port_solver(True, scale_tier=True, **TIGHT)
    tier.degraded = DegradedModeController(policy="greedy")
    with pytest.raises(RuntimeError, match="a bug in the engine"):
        esc_run(tier, nodes, batches)
    assert tier.scale_tier_stats["fallbacks"] == 0


@pytest.mark.parametrize("policy", [None, "shed"], ids=["no-controller", "shed"])
def test_device_fault_in_the_sharded_resolve_follows_the_degraded_policy(
    monkeypatch, policy
):
    """Like every device fault of the port, the tier's goes to the
    degraded policy: with no controller the fault itself propagates, and
    under shed the window answers DegradedUnavailableError. Neither serves
    the greedy, so `fallbacks` stays 0."""
    from spark_scheduler_tpu_torch.faults.degraded import DegradedModeController
    from spark_scheduler_tpu_torch.faults.errors import (
        CudaDeviceFault,
        DegradedUnavailableError,
    )

    nodes = esc_nodes(PORT, 128)
    batches = materialize(PORT, esc_world(9), nodes)
    _fault_in_the_tier(monkeypatch, _ecc())
    tier = port_solver(True, scale_tier=True, **TIGHT)
    if policy is not None:
        tier.degraded = DegradedModeController(policy=policy)
    want = CudaDeviceFault if policy is None else DegradedUnavailableError
    with pytest.raises(want):
        esc_run(tier, nodes, batches)
    assert tier.scale_tier_stats["fallbacks"] == 0
    if policy is not None:
        assert tier.degraded.active and tier.degraded.shed_requests > 0


def esc_run_draining(solver, nodes, batches, strategy="tightly-pack"):
    """esc_run as the server's batcher drives it (server/http.py): a build
    that raises PipelineDrainRequired fetches the windows in flight first,
    then builds again."""
    drain_required = mod(PORT, "core.solver").PipelineDrainRequired
    out = []
    for wins in batches:
        handles = []
        for w in wins:
            try:
                t = solver.build_tensors_pipelined(nodes, {}, {})
            except drain_required:
                for hd in handles:
                    out.extend(solver.pack_window_fetch(hd))
                handles = []
                t = solver.build_tensors_pipelined(nodes, {}, {})
            handles.append(solver.pack_window_dispatch(strategy, t, w))
        for hd in handles:
            out.extend(solver.pack_window_fetch(hd))
    return out


def test_device_fault_in_a_mesh_slot_part_solve_while_an_escalation_is_pending(
    monkeypatch,
):
    """A classified device fault in the mesh slot's own part solve (on a
    worker of the solve pool) while another window's escalation runs in
    the scale tier: the part's window re-solves exactly, the slot is
    quarantined and comes back at its probe, and the decisions equal the
    fault-free run's. The second part solve of the run waits until the
    tier has started, then faults."""
    from spark_scheduler_tpu_torch.core.device_pool import on_solve_worker
    from spark_scheduler_tpu_torch.faults.degraded import DegradedModeController

    world = esc_world(9)
    nodes = esc_nodes(PORT, 128)
    batches = materialize(PORT, world, nodes)
    want = esc_run(port_solver(), nodes, batches)

    sm = mod(PORT, "core.solver")
    real_tier = sm.PlacementSolver._scale_tier_decisions
    real_engine = sm.node_sharded_fifo_pack
    tier_started = threading.Event()
    part_solves = []

    def tier(self, *a, **k):
        tier_started.set()
        return real_tier(self, *a, **k)

    def engine(*a, **k):
        if on_solve_worker():
            part_solves.append(1)
            if len(part_solves) == 2:
                assert tier_started.wait(60), "no escalation ran"
                raise _ecc()
        return real_engine(*a, **k)

    monkeypatch.setattr(sm.PlacementSolver, "_scale_tier_decisions", tier)
    monkeypatch.setattr(sm, "node_sharded_fifo_pack", engine)
    solver = port_solver(True, scale_tier=True, **TIGHT)
    solver.degraded = DegradedModeController(policy="greedy")
    solver.quarantine_probe_s = 0.0
    assert esc_run_draining(solver, nodes, batches) == want
    (slot,) = solver._pool.slots
    assert slot.failure_count == 1 and not slot.quarantined
    st = solver.scale_tier_stats
    assert st["resolves"] > 0 and st["fallbacks"] == 0, st
    solver.close()
    assert not solver._inflight_futures and slot.inflight == 0


def _state_run(pkg):
    """A 1 x 4 mesh app with a tight top-K and the scale tier, driven at
    the solver level; returns its /debug/state snapshot."""
    h_mod = mod(pkg, "testing.harness")
    h_mod._ts = itertools.count(1)
    kw = dict(solver_mesh_groups=1, solver_mesh_node_shards=4,
              solver_scale_tier=True, solver_prune_top_k=1,
              solver_prune_slack=0.01, binpack_algo="tightly-pack")
    if pkg == JAX:
        load_jax_native()
        h = h_mod.Harness(**kw)
    else:
        import functools
        from unittest import mock

        build = functools.partial(h_mod.build_scheduler_app,
                                  pool_devices=["cpu"] * 4)
        with mock.patch.object(h_mod, "build_scheduler_app", build):
            h = h_mod.Harness(device="cpu", **kw)
    nodes = esc_nodes(pkg, 128)
    h.add_nodes(*nodes)
    nodes = h.backend.list_nodes()
    out = esc_run(h.app.solver, nodes, materialize(pkg, esc_world(9), nodes))
    state = mod(pkg, "observability.state").debug_state_snapshot(h.app)
    h.app.stop()
    return out, state


def test_debug_state_carries_the_jax_scale_tier_and_mesh_slot_blocks():
    (jax_out, js), (port_out, ps) = _state_run(JAX), _state_run(PORT)
    assert canon(port_out) == canon(jax_out)
    blocks = {"device_pool", "scale_tier"}
    assert blocks <= set(js) and blocks <= set(ps)
    assert ps["scale_tier"] == js["scale_tier"]
    assert ps["scale_tier"]["sharded"] > 0
    assert list(ps["device_pool"]) == ["cpu:0-0"]
    assert len(js["device_pool"]) == 1
    assert list(js["device_pool"])[0].endswith("0-3")
    assert set(ps["device_pool"]["cpu:0-0"]) >= {"full", "reuse", "inflight"}


def test_cli_mesh_and_scale_tier_flags_parse_like_jax(monkeypatch, capsys):
    captured = {}

    class Built(Exception):
        pass

    def capture(pkg):
        def build(backend, config, **kw):
            captured[pkg] = config
            raise Built

        return build

    for pkg in (JAX, PORT):
        monkeypatch.setattr(mod(pkg, "server.app"), "build_scheduler_app",
                            capture(pkg))
        with pytest.raises(Built):
            mod(pkg, "__main__").main(
                ["server", "--port", "0", "--mesh", "1x4", "--scale-tier"]
            )
    fields = ("solver_mesh_groups", "solver_mesh_node_shards",
              "solver_scale_tier", "solver_device_pool")
    got = {f: getattr(captured[PORT], f) for f in fields}
    assert got == {f: getattr(captured[JAX], f) for f in fields}
    assert got["solver_mesh_node_shards"] == 4 and got["solver_scale_tier"]
    for pkg in (JAX, PORT):
        assert mod(pkg, "__main__").main(["server", "--mesh", "2"]) == 2
    assert "GROUPSxSHARDS" in capsys.readouterr().err
