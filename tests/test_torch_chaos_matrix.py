"""The port's chaos matrix against the JAX package's.

The twin of tests/test_chaos_matrix.py. `ChaosMatrixSoak` runs the
randomized soak under one seeded `FaultPlan` per surface family (backend,
kube, wal, device, lease) through faults/injector.py; the engine asserts
its invariants, that no write-back work was dropped, the per-step latency
budget, and each surface's recovery (the WAL replays to live truth, the
device path recovers after its greedy window, store blips never depose a
lease holder).

For every surface the same seed runs in both packages (the port on
`device="cpu"`, each on its own WAL file) and the verdicts must be equal
field for field: the plan, the op counts, the apps submitted, the faults
fired, the full fault schedule, the write-back retries and drops, and the
surface's own block. Two JAX runs of one seed agree on every field of the
verdict (tests/test_chaos_matrix.py's replay case), so no field is left
out. The port's own replay-determinism and different-seed cases follow.
The matrix legs run 120 steps, as the JAX suite's; the replay legs 60
(the JAX suite's 80).
"""

from __future__ import annotations

import importlib
import itertools

import pytest

from tests.test_torch_native import load_jax_native

JAX = "spark_scheduler_tpu"
PORT = "spark_scheduler_tpu_torch"
SURFACES = ("backend", "kube", "wal", "device", "lease")


def soak_mod(root):
    if root == JAX:
        load_jax_native()
    importlib.import_module(f"{root}.testing.harness")._ts = itertools.count(1)
    importlib.import_module(f"{root}.models.kube")._uid_counter = (
        itertools.count(1)
    )
    return importlib.import_module(f"{root}.testing.soak")


def run_leg(root, surface, seed, steps, wal_path, **kw):
    if root == PORT:
        kw["device"] = "cpu"
    soak = soak_mod(root).ChaosMatrixSoak(
        surface, seed=seed, n_nodes=12, wal_path=wal_path, **kw
    )
    try:
        return soak, soak.run(steps)
    finally:
        soak.soak.h.app.stop()


@pytest.mark.parametrize("surface", SURFACES)
def test_chaos_matrix_verdict_matches_jax(surface, tmp_path):
    _, jax_v = run_leg(JAX, surface, 9, 120, str(tmp_path / "jax.wal"))
    soak, port_v = run_leg(PORT, surface, 9, 120, str(tmp_path / "port.wal"))
    assert port_v["fired"], (surface, soak.injector.stats())
    assert port_v["write_back"]["dropped"] == 0
    assert port_v["apps"] > 0
    assert set(port_v) == set(jax_v)
    for field in jax_v:
        assert port_v[field] == jax_v[field], field
    solver = soak.soak.h.app.solver
    if surface == "device":
        # One window took the host greedy; the plain row walk served the
        # rest, and no slot stayed quarantined.
        paths = solver.window_path_counts
        assert paths.get("greedy-fallback") == 1, paths
        assert paths.get("reference", 0) > 0, paths
        assert not solver.device_health()["quarantined"]


@pytest.mark.parametrize("surface", ("backend", "kube", "wal", "device"))
def test_port_chaos_matrix_replay_deterministic(surface, tmp_path):
    """Same seed => same fault schedule => same verdict, on the port."""
    runs = [
        run_leg(PORT, surface, 1234, 60, str(tmp_path / f"wal{i}.log"))[1]
        for i in range(2)
    ]
    assert runs[0]["schedule"] == runs[1]["schedule"]
    assert runs[0] == runs[1]


def test_port_chaos_matrix_different_seed_different_schedule(tmp_path):
    v1 = run_leg(PORT, "backend", 1, 60, str(tmp_path / "a.wal"))[1]
    v2 = run_leg(PORT, "backend", 2, 60, str(tmp_path / "b.wal"))[1]
    assert v1["schedule"] != v2["schedule"]
