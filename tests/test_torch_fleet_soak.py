"""The port's fleet chaos soak against the JAX package's.

The twin of tests/test_fleet_soak.py: seeded gangs across 3 clusters with
multi-homed instance groups, one cluster killed mid-run and rejoined. Each
scenario runs in both packages (the port's stacks on `device="cpu"`) and
each must meet the counts the JAX test asserts: no double placement, no
over-commit, aggregates equal to the walk oracle, every orphan re-routed
off the dead cluster, and every cluster byte-identical to a standalone
replay of its op stream. The two packages' verdicts are also equal, field
for field (the equivalence report included: each package replays its own
clusters).

The port's CPU fleet builds the stacking coordinator (`stack_window_ms` >
0); its stacking case checks that the concurrent bursts keep every
invariant.
"""

from __future__ import annotations

import importlib

import pytest

from tests.test_torch_native import load_jax_native

JAX = "spark_scheduler_tpu"
PORT = "spark_scheduler_tpu_torch"
ROOTS = (JAX, PORT)


def fleet_soak(root, **kw):
    if root == JAX:
        load_jax_native()
    else:
        kw["device"] = "cpu"
    return importlib.import_module(f"{root}.testing.soak").FleetSoak(
        n_clusters=3, nodes_per_cluster=2, seed=1, **kw
    )


def verdict_of(root, steps, kill_at, rejoin_at, **kw):
    soak = fleet_soak(root, **kw)
    try:
        return soak.run(steps=steps, kill_at=kill_at,
                        rejoin_at=rejoin_at).verdict()
    finally:
        soak.stop()


def assert_invariants(v):
    assert v["double_placements"] == [], v["double_placements"]
    assert v["overcommit"] == [], v["overcommit"]
    assert v["oracle_mismatches"] == [], v["oracle_mismatches"]
    assert v["orphans_unrouted"] == [], v["orphans_unrouted"]
    assert all(r["identical"] for r in v["equivalence"].values())


@pytest.mark.parametrize(
    "steps,kill_at,rejoin_at", [(40, 25, 32), (45, 25, 36)],
    ids=["chaos", "orphans"],
)
def test_fleet_soak_matches_jax(steps, kill_at, rejoin_at):
    """tests/test_fleet_soak.py's two scenarios: the kill and rejoin of
    test_fleet_chaos_soak (traffic placed, gangs spilled) and the seed
    whose kill catches a pending backlog (orphans re-routed)."""
    jax_v, port_v = (verdict_of(root, steps, kill_at, rejoin_at)
                     for root in ROOTS)
    for v in (jax_v, port_v):
        assert_invariants(v)
        assert v["placed"] > 0
        if steps == 40:
            assert v["spillovers"] > 0, v
        else:
            assert v["orphans_at_kill"] > 0, v
    assert set(port_v) == set(jax_v)
    for field in jax_v:
        assert port_v[field] == jax_v[field], field


def test_port_fleet_soak_stacking_mode_keeps_the_invariants():
    v = verdict_of(PORT, 24, 12, 18, stack_window_ms=20.0)
    assert_invariants(v)
    assert v["stacking"]["enabled"] is True, v["stacking"]
    assert v["placed"] > 0
