"""The port's HA chaos soak against the JAX package's.

The twin of tests/test_ha_chaos_soak.py: two replicas over one shared
backend, the leader killed with a window in flight, a standby promoted
after the lease TTL, and the dead leader's commit fenced. Each scenario
runs in both packages (the port's replicas on `device="cpu"`) and each
must meet the counts the JAX test asserts. The engine itself asserts, per
cycle, no double placement, no over-commit and a bounded failover spike.
"""

from __future__ import annotations

import importlib

import pytest

from tests.test_torch_native import load_jax_native

JAX = "spark_scheduler_tpu"
PORT = "spark_scheduler_tpu_torch"
ROOTS = (JAX, PORT)


def mod(root, name):
    if root == JAX:
        load_jax_native()
    return importlib.import_module(f"{root}.{name}")


def ha_soak(root, **kw):
    if root == PORT:
        kw["device"] = "cpu"
    return mod(root, "testing.soak").HAChaosSoak(**kw)


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("strategy", ["tightly-pack", "distribute-evenly"])
def test_ha_chaos_leader_kill_soak(root, strategy):
    soak = ha_soak(root, strategy=strategy, n_nodes=16, ttl_s=2.0)
    stats = soak.run(cycles=3, burst=4)
    assert stats["promotions"] == 3
    assert stats["fenced_drops"] >= 3
    assert stats["apps_placed"] >= 18
    soak.check_invariants()


@pytest.mark.parametrize("root", ROOTS)
def test_ha_chaos_on_durable_backend(root, tmp_path):
    durable = mod(root, "store.durable")
    path = str(tmp_path / "chaos.jsonl")
    backend = durable.DurableBackend(path)
    soak = ha_soak(root, strategy="tightly-pack", n_nodes=12, backend=backend)
    soak.run(cycles=2, burst=3)
    backend.close()
    replayed = durable.DurableBackend(path)
    rrs = {rr.name: rr for rr in replayed.list("resourcereservations")}
    assert set(rrs) == set(soak.placed)
    for app_id, node in soak.placed.items():
        assert rrs[app_id].spec.reservations["driver"].node == node
    replayed.close()


@pytest.mark.parametrize("root", ROOTS)
def test_ha_chaos_kill_schedule_rides_fault_plan(root):
    faults = mod(root, "faults")
    plan = faults.FaultPlan(
        seed=7, name="ha-kill-alternate",
        specs=[
            faults.FaultSpec(surface="replica.kill", mode="error", every=2),
            faults.FaultSpec(surface="lease.read", mode="error", p=0.1,
                             limit=6),
        ],
    )
    soak = ha_soak(root, strategy="tightly-pack", n_nodes=16, ttl_s=2.0,
                   fault_plan=plan)
    stats = soak.run(cycles=4, burst=3)
    assert stats["kills"] == 2 and stats["spared_cycles"] == 2
    assert stats["promotions"] == 2
    assert stats["fault_stats"]["fired"].get("replica.kill") == 2
    soak.check_invariants()
